"""The fleet plane's end-to-end case on the port's own jobs.

``tests/test_fleet.py`` runs against the port through
``tests/test_torch_ref_obs.py``, all but its end-to-end case, whose job
driver imports the JAX package in a child interpreter. This is that case
with a driver that imports the port: two real jobs (each a ``Master`` of
the port with its metrics endpoint on an ephemeral port and two
``ProcessCommSlave`` threads) on this host; the port's ``FleetPoller``
folds both and names the shared host with per-job byte attribution; a
SIGKILL of one whole job walks its rows ``STALE -> GONE`` with no poller
exception while the survivor stays ``LIVE``; ``fleet_report`` rebuilds
the timeline, the death included, from the fleet segments.
"""

import json
import os
import subprocess
import sys
import time

from ytk_mp4j_tpu_torch.obs import fleet, telemetry
from ytk_mp4j_tpu_torch.obs.cli import main as scope_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JOB_DRIVER = """
import json, sys, threading, time
import numpy as np
from ytk_mp4j_tpu_torch.comm.master import Master
from ytk_mp4j_tpu_torch.comm.process_comm import ProcessCommSlave
from ytk_mp4j_tpu_torch.operands import Operands
from ytk_mp4j_tpu_torch.operators import Operators

n = int(sys.argv[1])
master = Master(n, timeout=120.0, metrics_port=0).serve_in_thread()

def worker():
    slave = ProcessCommSlave("127.0.0.1", master.port, timeout=120.0)
    arr = np.ones(8192)
    while True:
        slave.allreduce_array(arr, Operands.DOUBLE, Operators.SUM)
        time.sleep(0.02)

for _ in range(n):
    threading.Thread(target=worker, daemon=True).start()
print(json.dumps({"metrics_port": master.metrics_port,
                  "job_id": master.job_id,
                  "master": type(master).__module__}), flush=True)
threading.Event().wait()        # run until SIGKILLed by the test
"""


def _spawn_job(nranks=2):
    env = {**os.environ, "MP4J_HEARTBEAT_SECS": "0.1", "PYTHONPATH": REPO}
    proc = subprocess.Popen(
        [sys.executable, "-c", _JOB_DRIVER, str(nranks)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        cwd=REPO, env=env, text=True)
    line = proc.stdout.readline()
    if not line:
        proc.kill()
        raise AssertionError(
            f"job driver died at startup: {proc.stderr.read()[-2000:]}")
    head = json.loads(line)
    assert head["master"] == "ytk_mp4j_tpu_torch.comm.master", head
    return proc, f"http://127.0.0.1:{head['metrics_port']}", \
        head["job_id"]


def _poll_until(poller, done, secs=60.0):
    deadline = time.monotonic() + secs
    model = None
    while time.monotonic() < deadline:
        model = poller.poll_once()          # never raises, by contract
        if done(model):
            break
        time.sleep(0.1)
    return model


def test_fleet_two_port_jobs_shared_host_then_sigkill(tmp_path, capsys):
    nranks = 2
    procs = []
    sink_dir = str(tmp_path / "fleet")
    try:
        proc_a, url_a, jid_a = _spawn_job(nranks)
        procs.append(proc_a)
        proc_b, url_b, jid_b = _spawn_job(nranks)
        procs.append(proc_b)
        fs = fleet.FleetSink(sink_dir, budget_bytes=4 << 20)
        poller = fleet.FleetPoller([url_a, url_b], poll_secs=0.2,
                                   stale_secs=0.6, sink=fs)

        def both_live(model):
            ok = [j for j in model["jobs"].values()
                  if j["state"] == fleet.LIVE and j["summary"]
                  and j["summary"]["ranks_reporting"] == nranks
                  and j["summary"]["wire_bytes"] > 0]
            return len(ok) == 2 and model["shared_hosts"]

        model = _poll_until(poller, both_live)
        assert model is not None and model["shared_hosts"], \
            f"no shared host observed: {json.dumps(model, default=str)[:800]}"
        [fp] = model["shared_hosts"]
        row = model["hosts"][fp]["jobs"]
        assert set(row) == {jid_a, jid_b}
        for jid in (jid_a, jid_b):
            assert row[jid]["wire_bytes"] > 0
            assert sorted(row[jid]["ranks"]) == list(range(nranks))
        frame = telemetry.format_fleet(model)
        assert jid_a in frame and jid_b in frame
        assert f"shared host {fp}" in frame
        assert scope_main(["fleet", url_a, url_b, "--once"]) == 0
        out = capsys.readouterr().out
        assert jid_a in out and jid_b in out and "shared host" in out

        proc_b.kill()
        proc_b.wait(10.0)
        _poll_until(poller, lambda m: poller.states()[url_b] == fleet.GONE)
        states = poller.states()
        assert states[url_b] == fleet.GONE, states
        assert states[url_a] == fleet.LIVE, states
        surv = poller.model()["jobs"][url_a]["summary"]
        assert surv["job_id"] == jid_a
        assert surv["ranks_reporting"] == nranks
        kinds = [e["kind"] for e in poller.events()]
        assert "job_stale" in kinds and "job_gone" in kinds
        poller.stop()

        rep = fleet.fleet_report(sink_dir)
        assert rep["snapshots"] > 0 and rep["torn"] == 0
        by_kind = {}
        for ev in rep["events"]:
            by_kind.setdefault(ev["kind"], []).append(ev)
        assert {jid_a, jid_b} <= {e["job_id"] for e in by_kind["job_up"]}
        assert any(e["job_id"] == jid_b for e in by_kind["job_gone"])
        assert rep["jobs"][url_b]["state"] == fleet.GONE
        assert rep["jobs"][url_a]["state"] == fleet.LIVE
        assert scope_main(["fleet-report", sink_dir]) == 0
        out = capsys.readouterr().out
        assert "job_gone" in out and jid_b in out
    finally:
        for proc in procs:
            proc.kill()
            proc.wait(10.0)
