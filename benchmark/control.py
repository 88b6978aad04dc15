"""The control of the comparison that decides ``correct``: the reference
put in the program's place, computed one precision below the one the
configuration states, must come out as not correct.

The configurations state lossless 24-bit output.  The control serves
every request from the reference at 16 bits (each 24-bit sample's low
byte zeroed: what a decode that kept only the int16 readback tier would
give) through the reader interface the drivers call, and the run's own
comparison judges it.  The benchmark's runs never run it; run it as

    python -m benchmark.control --workload <cell> --seeds <n> [<n> ...] \\
        --seconds <s>

which prints each seed's checks and exits 0 only where every seed's run
came out not correct.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np

__all__ = ["ControlReader", "control_readers", "main"]


class ControlReader:
    """A reader of track ``n`` that answers from the reference at 16 of
    its 24 bits."""

    def __init__(self, driver, n: int):
        self.driver, self.n = driver, n
        self._cursor = 0

    def read_all_packed(self) -> bytes:
        wav = self.driver.expected_wav(self.n).reshape(-1, 3).copy()
        wav[:, 0] = 0
        return wav.tobytes()

    def seek(self, frame: int) -> int:
        self._cursor = frame
        return frame

    def read(self, frames: int) -> np.ndarray:
        ref = self.driver.mlp_ref()
        out = ref.track_samples(self.driver.album.tracks[self.n].layout,
                                self._cursor, frames)
        self._cursor += out.shape[0]
        return out & ~np.int32(0xFF)

    def close(self) -> None:
        pass


@contextlib.contextmanager
def control_readers():
    """While active, every driver's ``open_reader`` gives a
    :class:`ControlReader` in place of the program's ``TrackReader``."""
    from .drivers.base import AlbumDriver

    saved = AlbumDriver.open_reader
    AlbumDriver.open_reader = lambda self, n: ControlReader(self, n)
    try:
        yield
    finally:
        AlbumDriver.open_reader = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    from .harness import run_cell

    all_failed = True
    for seed in args.seeds:
        with control_readers():
            result = run_cell(args.workload, seed, args.seconds, False,
                              time.perf_counter())
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "checks": result["checks"]}), flush=True)
        all_failed &= not result["correct"]
    return 0 if all_failed else 1


if __name__ == "__main__":
    sys.exit(main())
