"""The ``seek`` traffic: a player scrubbing through the album.  Each
request is a ``seek`` and a ``read`` of ``read_seconds`` of audio.  The
client keeps one ``TrackReader`` open and opens a new one when the
request's track differs from the last one's.  A closed loop: the next
request goes out when the last one has returned.

Every seed gets the same work in another order.  The requests come in
passes over the traffic file's ``deck`` of request kinds, each pass in
a seed-drawn order: ``open`` goes to another track than the last
request's (a new reader), ``move`` stays on the track and goes to
another of its ``segment_seconds`` segments (the reader's decode
unit).  The seed draws the track, the segment and the frame in it;
every read lies inside one segment, so each request of a kind decodes
alike (every track holds the same restart units, see ``gen/disc.py``).

A request's latency runs from its first call into the program (the new
reader's construction where the track changed, else ``seek``) to the
return of its ``read``.  ``seek_ms_p75`` is the 75th percentile over
every request of the window (the highest with ten requests beyond it:
a request that opens a reader takes about 1.3 s, so some 40 fit the
window); every request's samples are compared with the reference.
The traffic file's keys: ``read_seconds``, ``segment_seconds``,
``deck`` and ``warmup_seconds`` (requests of another seed-drawn stream
before the window, at least one and until that many seconds are done:
the first requests of a process run slower).
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np

from .base import AlbumDriver

__all__ = ["Driver"]


def _requests(driver, stream: int, track, segment):
    """Endless (track, frame, segment) requests: passes over the deck,
    each in a seed-drawn order, going on from ``track`` and ``segment``
    (None before the first request)."""
    rng = np.random.default_rng([driver.ctx.seed, stream])
    frames = [t.pcm_frames for t in driver.album.tracks]
    seg, read = driver.segment_frames, driver.read_frames
    deck = driver.ctx.traffic["deck"]
    while True:
        for kind in rng.permutation(len(deck)):
            segments = -(-frames[track or 0] // seg)
            if track is None:
                track = int(rng.integers(len(frames)))
                segment = int(rng.integers(-(-frames[track] // seg)))
            elif deck[kind] == "open":
                track = (track + 1 + int(rng.integers(len(frames) - 1))) % len(
                    frames)
                segment = int(rng.integers(-(-frames[track] // seg)))
            elif segments > 1:   # "move"
                segment = (segment + 1 + int(rng.integers(segments - 1))) % (
                    segments)
            lo = segment * seg
            hi = max(lo, min(lo + seg, frames[track]) - read)
            yield track, lo + int(rng.integers(hi - lo + 1)), segment


class Driver(AlbumDriver):
    def setup(self) -> None:
        rate = self.cfg["sample_rate"]
        self.read_frames = int(round(self.ctx.traffic["read_seconds"] * rate))
        self.segment_frames = int(self.ctx.traffic["segment_seconds"] * rate)
        self._reader, self._track, self._segment = None, None, None
        t0, self.warmup_ms = time.perf_counter(), []
        for n, pos, segment in _requests(self, 2, None, None):
            if self.warmup_ms and (time.perf_counter() - t0
                                   >= self.ctx.traffic["warmup_seconds"]):
                break
            t1 = time.perf_counter()
            self._request(n, pos)
            self._segment = segment
            self.warmup_ms.append((time.perf_counter() - t1) * 1e3)

    def _request(self, n: int, pos: int):
        if n != self._track:
            if self._reader is not None:
                self._reader.close()
            self._reader, self._track = None, None
            with self.ctx.span("seek.open"):
                self._reader = self.open_reader(n)
            self._track = n
        with self.ctx.span("seek.seek"):
            self._reader.seek(pos)
        with self.ctx.span("seek.read"):
            return self._reader.read(self.read_frames)

    def window(self, seconds: float) -> None:
        self.answers, self.errors, self.kinds = [], [], []
        lat = self.ctx.latencies_ms
        t_begin = now = time.perf_counter()
        for n, pos, _ in _requests(self, 1, self._track, self._segment):
            if now - t_begin >= seconds:
                break
            opens = n != self._track
            t0 = time.perf_counter()
            try:
                out = self._request(n, pos)
            except Exception as exc:  # a failed request is counted
                self.errors.append(f"request {len(lat)} (track {n + 1}, "
                                   f"frame {pos}): {exc!r}")
                self._reader, self._track = None, None
                out = None
            now = time.perf_counter()
            lat.append((now - t0) * 1e3)
            self.answers.append((n, pos, out))
            self.kinds.append("o" if opens else "m")
        self.elapsed = now - t_begin

    def release(self) -> None:
        if self._reader is not None:
            self._reader.close()
        self._reader, self._track = None, None
        super().release()

    def end_to_end(self) -> dict:
        return {"seek_ms_p75": statistics.quantiles(
            self.ctx.latencies_ms, n=4, method="inclusive")[2]}

    def check(self):
        for e in self.errors[:5]:
            print(f"[seek] {e}", file=sys.stderr)
        ref = self.mlp_ref()
        wrong = bad = 0
        for n, pos, out in self.answers:
            if out is None:
                continue
            want = ref.track_samples(self.album.tracks[n].layout, pos,
                                     self.read_frames)
            if out.shape != want.shape or not np.array_equal(out, want):
                m = min(out.shape[0], want.shape[0])
                wrong += int(np.count_nonzero(out[:m] != want[:m])) + abs(
                    out.size - want.size)
                bad += 1
        print(f"[seek] {len(self.answers)} requests in "
              f"{self.elapsed:.3f} s, after {len(self.warmup_ms)} warm-up "
              "requests", file=sys.stderr)
        print("[seek] warm-up ms " + " ".join(
            f"{v:.0f}" for v in self.warmup_ms), file=sys.stderr)
        print("[seek] window ms " + " ".join(
            f"{k}{v:.0f}" for k, v in zip(self.kinds, self.ctx.latencies_ms)),
            file=sys.stderr)
        self.answers = []
        checks = {"samples_wrong": (wrong, 0),
                  "requests_failed": (len(self.errors), 0)}
        return len(self.ctx.latencies_ms), len(self.errors) + bad, checks
