// Native socket data plane (a copy of ytk_mp4j_tpu/csrc/mp4j_transport.cpp
// for the PyTorch port).
//
// The reference's slaves move primitive-array segments over raw JVM
// socket streams (SURVEY.md section 2 "Serialization": raw
// DataOutputStream writes, no Kryo, for the primitive fast path). The
// Python framed path (transport/channel.py) pays per-frame pickle +
// per-call interpreter overhead and needs a helper thread to overlap
// the send and receive sides of a ring/halving exchange. This file is
// the native equivalent: a poll()-driven full-duplex raw exchange --
// both directions progress in one thread, no framing, no copies.
//
// ABI: plain C. Sizes are NOT sent on the wire -- both peers derive
// them from the collective's metadata (segment math), exactly like the
// reference's primitive fast path. Callers must keep the raw/framed
// decision a pure function of job-wide parameters so ranks never
// disagree about the wire format.
//
// Return codes: 0 ok, -1 syscall error, -2 peer closed early,
// -3 timeout. timeout_ms is an IDLE timeout, matching the framed
// path's per-recv socket timeout: the deadline resets whenever bytes
// move in either direction, so a slow-but-progressing transfer never
// times out — only a stalled peer does.

#include <cerrno>
#include <cstdint>
#include <ctime>

#include <fcntl.h>
#include <poll.h>
#include <unistd.h>

namespace {

constexpr int64_t kChunk = 1 << 20;  // per-syscall cap, keeps poll honest

int64_t now_ms() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1000 + ts.tv_nsec / 1000000;
}

class NonblockGuard {
 public:
  explicit NonblockGuard(int fd) : fd_(fd), flags_(fcntl(fd, F_GETFL, 0)) {
    if (flags_ >= 0) fcntl(fd_, F_SETFL, flags_ | O_NONBLOCK);
  }
  ~NonblockGuard() {
    if (flags_ >= 0) fcntl(fd_, F_SETFL, flags_);
  }
  bool ok() const { return flags_ >= 0; }

 private:
  int fd_;
  int flags_;
};

// One progress attempt on a ready direction; updates *done.
// Returns 0 on progress/EAGAIN, else a negative error code.
int try_send(int fd, const char* buf, int64_t nbytes, int64_t* done) {
  int64_t want = nbytes - *done;
  if (want > kChunk) want = kChunk;
  ssize_t w = write(fd, buf + *done, static_cast<size_t>(want));
  if (w >= 0) {
    *done += w;
    return 0;
  }
  return (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) ? 0 : -1;
}

int try_recv(int fd, char* buf, int64_t nbytes, int64_t* done) {
  int64_t want = nbytes - *done;
  if (want > kChunk) want = kChunk;
  ssize_t r = read(fd, buf + *done, static_cast<size_t>(want));
  if (r > 0) {
    *done += r;
    return 0;
  }
  if (r == 0) return -2;  // orderly shutdown with bytes still pending
  return (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) ? 0 : -1;
}

}  // namespace

extern "C" {

// Full-duplex raw exchange: send sbytes from sbuf on send_fd while
// receiving rbytes into rbuf from recv_fd. send_fd may equal recv_fd
// (partner exchange on one socket) or differ (ring step).
// timeout_ms < 0 means block forever (the reference's fail-stop mode).
int mp4j_sendrecv_raw(int send_fd, int recv_fd, const void* sbuf,
                      int64_t sbytes, void* rbuf, int64_t rbytes,
                      int64_t timeout_ms) {
  const char* sp = static_cast<const char*>(sbuf);
  char* rp = static_cast<char*>(rbuf);
  int64_t sdone = 0, rdone = 0;
  int64_t deadline = timeout_ms >= 0 ? now_ms() + timeout_ms : -1;

  NonblockGuard sg(send_fd);
  if (!sg.ok()) return -1;
  const bool same = send_fd == recv_fd;
  NonblockGuard rg(same ? -1 : recv_fd);  // fcntl(-1) fails harmlessly
  if (!same && !rg.ok()) return -1;

  while (sdone < sbytes || rdone < rbytes) {
    pollfd fds[2];
    int nfds = 0;
    if (same) {
      fds[0].fd = send_fd;
      fds[0].events = static_cast<short>(
          (sdone < sbytes ? POLLOUT : 0) | (rdone < rbytes ? POLLIN : 0));
      nfds = 1;
    } else {
      if (sdone < sbytes) {
        fds[nfds].fd = send_fd;
        fds[nfds].events = POLLOUT;
        ++nfds;
      }
      if (rdone < rbytes) {
        fds[nfds].fd = recv_fd;
        fds[nfds].events = POLLIN;
        ++nfds;
      }
    }
    int wait = -1;
    if (deadline >= 0) {
      int64_t left = deadline - now_ms();
      if (left <= 0) return -3;
      wait = left > 1000000000 ? 1000000000 : static_cast<int>(left);
    }
    int pr = poll(fds, static_cast<nfds_t>(nfds), wait);
    if (pr < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    if (pr == 0) return -3;
    const int64_t before = sdone + rdone;
    for (int i = 0; i < nfds; ++i) {
      short rev = fds[i].revents;
      if (rev == 0) continue;
      const bool is_send =
          fds[i].fd == send_fd && (fds[i].events & POLLOUT) != 0;
      const bool is_recv =
          fds[i].fd == recv_fd && (fds[i].events & POLLIN) != 0;
      if (is_recv && (rev & (POLLIN | POLLHUP | POLLERR)) &&
          rdone < rbytes) {
        int rc = try_recv(recv_fd, rp, rbytes, &rdone);
        if (rc < 0) return rc;
      }
      if (is_send && (rev & POLLOUT) && sdone < sbytes) {
        int rc = try_send(send_fd, sp, sbytes, &sdone);
        if (rc < 0) return rc;
      }
      // POLLERR/POLLHUP with nothing readable: surface as closed/error
      if ((rev & (POLLERR | POLLNVAL)) && !(rev & POLLIN)) return -1;
      if ((rev & POLLHUP) && !(rev & POLLIN) && is_recv &&
          rdone < rbytes) {
        return -2;
      }
    }
    if (deadline >= 0 && sdone + rdone > before) {
      deadline = now_ms() + timeout_ms;  // progress resets idle timer
    }
  }
  return 0;
}

// One-directional steps (fold/unfold) call mp4j_sendrecv_raw with a
// null buffer on the inactive side; no separate entry points needed.

// ---------------------------------------------------------------------
// Multi-leg progress driver: the nonblocking-collective
// scheduler's byte mover. The Python engine hands down the set of
// RUNNABLE legs — the head of each per-(peer, direction) FIFO queue,
// so at most one send and one recv leg per fd — and this drives them
// all through ONE poll loop, moving bytes on whichever fd is ready.
// Cross-collective burst coalescing falls out: when collective k's
// send leg to a peer completes, k+1's leg enters the set on the next
// call and its bytes stream back-to-back into the same socket buffer,
// so the peer drains large bursts instead of ping-ponging per
// exchange — the mechanism that makes k outstanding collectives
// cheaper per byte than k sequential ones on a CPU-bound host.
//
// Contract: sockets are ALREADY nonblocking (the Python engine owns
// the mode for the batch). dones[i] is in-out progress. Returns the
// number of legs that newly completed (>= 1), 0 when timeout_ms
// elapsed without a completion (the Python side's fence-poll tick),
// or a negative error (-1 syscall, -2 peer closed) with status[i] set
// on the failing leg.
// ---------------------------------------------------------------------
int mp4j_progress_multi(const int32_t* fds, const int32_t* dirs,
                        void** bufs, const int64_t* lens,
                        int64_t* dones, int8_t* status, int32_t nlegs,
                        int64_t timeout_ms) {
  const int64_t deadline = now_ms() + (timeout_ms < 0 ? 0 : timeout_ms);
  for (int i = 0; i < nlegs; ++i) status[i] = 0;
  constexpr int kMaxFds = 256;  // the Python side slices leg sets to
                                // this bound per pass (FIFO-fair), so
                                // the cap is never an error in practice
  while (true) {
    // poll set: unique fds of incomplete legs, events OR-combined
    pollfd pfds[kMaxFds];
    int leg_of_pfd_send[kMaxFds];
    int leg_of_pfd_recv[kMaxFds];
    int npfd = 0;
    int pending = 0;
    for (int i = 0; i < nlegs; ++i) {
      if (dones[i] >= lens[i]) continue;
      ++pending;
      int slot = -1;
      for (int j = 0; j < npfd; ++j) {
        if (pfds[j].fd == fds[i]) {
          slot = j;
          break;
        }
      }
      if (slot < 0) {
        if (npfd >= kMaxFds) {
          status[i] = -1;  // name the overflowing leg for diagnostics
          return -1;
        }
        slot = npfd++;
        pfds[slot].fd = fds[i];
        pfds[slot].events = 0;
        leg_of_pfd_send[slot] = -1;
        leg_of_pfd_recv[slot] = -1;
      }
      if (dirs[i] == 0) {
        pfds[slot].events = static_cast<short>(pfds[slot].events | POLLOUT);
        leg_of_pfd_send[slot] = i;
      } else {
        pfds[slot].events = static_cast<short>(pfds[slot].events | POLLIN);
        leg_of_pfd_recv[slot] = i;
      }
    }
    if (pending == 0) return 0;
    int64_t left = deadline - now_ms();
    if (left < 0) left = 0;
    int pr = poll(pfds, static_cast<nfds_t>(npfd),
                  left > 1000000000 ? 1000000000 : static_cast<int>(left));
    if (pr < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    if (pr == 0) return 0;  // tick: the Python side polls the fence
    int completed = 0;
    for (int j = 0; j < npfd; ++j) {
      short rev = pfds[j].revents;
      if (rev == 0) continue;
      int ri = leg_of_pfd_recv[j];
      if (ri >= 0 && (rev & (POLLIN | POLLHUP | POLLERR)) &&
          dones[ri] < lens[ri]) {
        int rc = try_recv(pfds[j].fd, static_cast<char*>(bufs[ri]),
                          lens[ri], &dones[ri]);
        if (rc < 0) {
          status[ri] = static_cast<int8_t>(rc);
          return rc;
        }
        if (dones[ri] >= lens[ri]) ++completed;
      }
      int si = leg_of_pfd_send[j];
      if (si >= 0 && (rev & POLLOUT) && dones[si] < lens[si]) {
        int rc = try_send(pfds[j].fd, static_cast<const char*>(bufs[si]),
                          lens[si], &dones[si]);
        if (rc < 0) {
          status[si] = static_cast<int8_t>(rc);
          return rc;
        }
        if (dones[si] >= lens[si]) ++completed;
      }
      if ((rev & (POLLERR | POLLNVAL)) && !(rev & POLLIN)) {
        int bad = si >= 0 ? si : ri;
        if (bad >= 0) status[bad] = -1;
        return -1;
      }
      if ((rev & POLLHUP) && !(rev & POLLIN) && ri >= 0 &&
          dones[ri] < lens[ri]) {
        status[ri] = -2;
        return -2;
      }
    }
    if (completed > 0) return completed;
  }
}

// ---------------------------------------------------------------------
// Batch leg-graph driver: runs a WHOLE engine batch — every
// leg of every outstanding collective, with its dependency gates and
// reduce-merges — inside one native call, so the Python scheduler pays
// one call per batch instead of one per leg completion. Gates encode
// both orderings the engine needs: the per-(peer, direction) FIFO (a
// leg's queue predecessor) and the per-collective op sequence (the
// previous op's legs); a leg joins the poll set only once every gate
// leg has completed. A recv leg with a merge spec reduces natively
// (mp4j_reduce) CHUNK-GRANULARLY as bytes arrive: mchunk[i] is the
// merge step in elements (the per-link tuner-adapted chunk schedule;
// 0 = whole buffer), melems[i] the in-out merge cursor — every fully
// received chunk merges in the same pass, so the tail chunk's merge
// is all that remains at leg completion and dependents still only
// unblock behind a fully merged accumulator. mp4j_reduce is
// element-wise, so any chunk partition is bit-identical to the
// whole-buffer merge.
//
// Returns: 1 = every leg complete; 0 = timeout tick (caller polls the
// epoch fence and re-enters); 2 = wake_fd readable (new submissions to
// admit — the byte(s) are drained here); negative = error with
// status[i] set on the failing leg. dones[] is in-out, so the call is
// re-entrant across ticks/wakes.
// ---------------------------------------------------------------------
extern "C" int mp4j_reduce(int32_t dtype, int32_t op, void* acc,
                           const void* src, int64_t n);

static void merge_avail(void** mdst, void** msrc, const int32_t* mdtype,
                        const int32_t* mopcode, const int64_t* mcount,
                        const int64_t* mchunk, int64_t* melems,
                        const int64_t* lens, const int64_t* dones,
                        int ri) {
  if (mdst[ri] == nullptr || melems[ri] >= mcount[ri]) return;
  const int64_t isz = mcount[ri] > 0 ? lens[ri] / mcount[ri] : 0;
  if (isz <= 0) return;
  const int64_t avail = dones[ri] / isz;
  const int64_t step = mchunk[ri] > 0 ? mchunk[ri] : mcount[ri];
  while (melems[ri] < mcount[ri]) {
    int64_t hi = melems[ri] + step;
    if (hi > mcount[ri]) hi = mcount[ri];
    if (avail < hi) break;
    mp4j_reduce(mdtype[ri], mopcode[ri],
                static_cast<char*>(mdst[ri]) + melems[ri] * isz,
                static_cast<const char*>(msrc[ri]) + melems[ri] * isz,
                hi - melems[ri]);
    melems[ri] = hi;
  }
}

extern "C" int mp4j_run_legs(const int32_t* fds, const int32_t* dirs,
                             void** bufs, const int64_t* lens,
                             int64_t* dones, const int32_t* gates,
                             void** mdst, void** msrc,
                             const int32_t* mdtype,
                             const int32_t* mopcode,
                             const int64_t* mcount,
                             const int64_t* mchunk, int64_t* melems,
                             int8_t* status, int32_t nlegs,
                             int32_t wake_fd, int64_t timeout_ms) {
  const int64_t deadline = now_ms() + (timeout_ms < 0 ? 0 : timeout_ms);
  constexpr int kMax = 256;
  if (nlegs > kMax) return -1;
  while (true) {
    pollfd pfds[kMax + 1];
    int leg_send[kMax];
    int leg_recv[kMax];
    int npfd = 0;
    int pending = 0;
    for (int i = 0; i < nlegs; ++i) {
      if (dones[i] >= lens[i]) continue;
      ++pending;
      bool gated = false;
      for (int g = 0; g < 3; ++g) {
        int32_t pre = gates[i * 3 + g];
        if (pre >= 0 && dones[pre] < lens[pre]) {
          gated = true;
          break;
        }
      }
      if (gated) continue;
      int slot = -1;
      for (int j = 0; j < npfd; ++j) {
        if (pfds[j].fd == fds[i]) {
          slot = j;
          break;
        }
      }
      if (slot < 0) {
        slot = npfd++;
        pfds[slot].fd = fds[i];
        pfds[slot].events = 0;
        leg_send[slot] = -1;
        leg_recv[slot] = -1;
      }
      if (dirs[i] == 0) {
        pfds[slot].events = static_cast<short>(pfds[slot].events | POLLOUT);
        leg_send[slot] = i;
      } else {
        pfds[slot].events = static_cast<short>(pfds[slot].events | POLLIN);
        leg_recv[slot] = i;
      }
    }
    if (pending == 0) return 1;
    if (wake_fd >= 0) {
      pfds[npfd].fd = wake_fd;
      pfds[npfd].events = POLLIN;
      ++npfd;
    }
    int64_t left = deadline - now_ms();
    if (left < 0) left = 0;
    int pr = poll(pfds, static_cast<nfds_t>(npfd),
                  left > 1000000000 ? 1000000000 : static_cast<int>(left));
    if (pr < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    if (pr == 0) return 0;  // tick: the caller polls the fence
    const int last = wake_fd >= 0 ? npfd - 1 : npfd;
    if (wake_fd >= 0 && (pfds[npfd - 1].revents & POLLIN)) {
      char sink[64];
      while (read(wake_fd, sink, sizeof(sink)) > 0) {
      }
      return 2;  // new submissions to admit
    }
    for (int j = 0; j < last; ++j) {
      short rev = pfds[j].revents;
      if (rev == 0) continue;
      int ri = leg_recv[j];
      if (ri >= 0 && (rev & (POLLIN | POLLHUP | POLLERR)) &&
          dones[ri] < lens[ri]) {
        int rc = try_recv(pfds[j].fd, static_cast<char*>(bufs[ri]),
                          lens[ri], &dones[ri]);
        if (rc < 0) {
          status[ri] = static_cast<int8_t>(rc);
          return rc;
        }
        merge_avail(mdst, msrc, mdtype, mopcode, mcount, mchunk,
                    melems, lens, dones, ri);
      }
      int si = leg_send[j];
      if (si >= 0 && (rev & POLLOUT) && dones[si] < lens[si]) {
        int rc = try_send(pfds[j].fd, static_cast<const char*>(bufs[si]),
                          lens[si], &dones[si]);
        if (rc < 0) {
          status[si] = static_cast<int8_t>(rc);
          return rc;
        }
      }
      if ((rev & (POLLERR | POLLNVAL)) && !(rev & POLLIN)) {
        int bad = si >= 0 ? si : ri;
        if (bad >= 0) status[bad] = -1;
        return -1;
      }
      if ((rev & POLLHUP) && !(rev & POLLIN) && ri >= 0 &&
          dones[ri] < lens[ri]) {
        status[ri] = -2;
        return -2;
      }
    }
  }
}

}  // extern "C"
