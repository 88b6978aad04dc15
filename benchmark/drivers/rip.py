"""The ``rip`` traffic: one client converts the album to WAV payloads,
track after track in album order, again and again (a closed loop, as a
ripper is): each decode is ``read_all_packed()`` on a fresh
``TrackReader``.

The traffic file's keys: ``warmup_seconds`` (before the window, whole
decodes in album order until at least one pass over the album and that
many seconds are done: the first decodes of a process run slower, and
the window opens once they have settled) and ``compare_share`` (besides
the window's first pass over the album, the share of its later decodes,
drawn from the seed, whose bytes are kept and compared with the
reference).

``x_realtime`` is the audio seconds of every decode finished in the
window over the window's wall seconds; the window ends with the first
decode that finishes at or after ``--seconds``, so that it holds all the
work and all the time.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .base import AlbumDriver

__all__ = ["Driver"]


class Driver(AlbumDriver):
    def setup(self) -> None:
        t0, i = time.perf_counter(), 0
        while i < len(self.tracks) or (time.perf_counter() - t0
                                       < self.ctx.traffic["warmup_seconds"]):
            self._decode(i % len(self.tracks))
            i += 1
        self.warmup_decodes = i
        rng = np.random.default_rng([self.ctx.seed, 1])
        self._keep = rng.random(1 << 16) < self.ctx.traffic["compare_share"]
        self._keep[: len(self.tracks)] = True

    def _decode(self, n: int):
        with self.ctx.span("rip.open"):
            reader = self.open_reader(n)
        try:
            with self.ctx.span("rip.read_all_packed"):
                return reader.read_all_packed()
        finally:
            reader.close()

    def window(self, seconds: float) -> None:
        self.kept, self.done, self.errors, self.times = [], [], [], []
        t_begin = now = time.perf_counter()
        i = 0
        while now - t_begin < seconds:
            n = i % len(self.tracks)
            t0 = time.perf_counter()
            try:
                data = self._decode(n)
            except Exception as exc:  # a failed decode is counted, not fatal
                self.errors.append(f"decode {i} (track {n + 1}): {exc!r}")
                data = None
            now = time.perf_counter()
            self.times.append(now - t0)
            if data is not None:
                self.done.append(n)
                if self._keep[i % self._keep.size]:
                    self.kept.append((n, data))
            i += 1
        self.attempted = i
        self.elapsed = now - t_begin
        self.ctx.audio_s = sum(self.seconds[n] for n in self.done)

    def end_to_end(self) -> dict:
        return {"x_realtime": self.ctx.audio_s / self.elapsed}

    def check(self):
        for e in self.errors[:5]:
            print(f"[rip] {e}", file=sys.stderr)
        print("[rip] decode seconds: " + " ".join(
            f"{t:.4f}" for t in self.times), file=sys.stderr)
        wrong, bad = 0, 0
        self.kept.sort(key=lambda kd: kd[0])
        for n, data in self.kept:
            got = np.frombuffer(data, np.uint8)
            want = self.expected_wav(n)
            if got.size != want.size or not np.array_equal(got, want):
                m = min(got.size, want.size)
                wrong += int(np.count_nonzero(got[:m] != want[:m])) + abs(
                    got.size - want.size)
                bad += 1
        unchecked = len(set(range(len(self.tracks)))
                        - {n for n, _ in self.kept})
        print(f"[rip] {len(self.kept)} of {len(self.done)} decodes compared, "
              f"after {self.warmup_decodes} warm-up decodes", file=sys.stderr)
        self.kept = []
        self.ctx.work = self.window_work(self.done)
        checks = {"bytes_wrong": (wrong, 0),
                  "decodes_failed": (len(self.errors), 0),
                  "tracks_unchecked": (unchecked, 0)}
        return self.attempted, len(self.errors) + bad, checks
