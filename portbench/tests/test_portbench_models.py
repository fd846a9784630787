"""The GBDT cell trains one model of ``n_trees`` rounds after another:
each model starts from zero margins, and a run over several models is
judged correct."""

import torch

from conftest import SEED, small_run

from portbench import harness


def _state(n_trees, kept):
    bench = harness.benchmark()
    cell = harness.find_cell(bench, "gbdt-higgs.dp4")
    spec = cell["spec"]
    ctx = harness.Context(
        "gbdt-higgs.dp4", SEED, 1.0, False, "cpu",
        {**cell["config_file"], "n_rows": 4000, "n_trees": n_trees},
        {**spec["traffic"], "checked_rounds": kept}, spec["limits"])
    driver = harness.load("drivers", spec["driver"])
    return driver, driver.setup(ctx)


def test_each_model_starts_from_zero_margins():
    driver, st = _state(n_trees=2, kept=4)
    for _ in range(4):           # set-up ran the first model's round 0
        driver.step(st)
    # the window's second and fourth rounds (items 1 and 3) begin models
    # 2 and 3; its first and third end models 1 and 2
    starts = [bool((r["preds_in"] == 0).all()) for r in st.sample.items]
    assert starts == [False, True, False, True]
    torch.testing.assert_close(st.sample.items[1]["preds_out"],
                               st.start["preds_out"], rtol=0, atol=0)


def test_a_run_over_several_models_is_correct():
    out = small_run("gbdt-higgs.dp4", config={"n_trees": 2})
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 2
