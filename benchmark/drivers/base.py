"""What the traffic drivers share: the album on disk, the port's reader
objects over it, the CPPM hook with its span, the reference and the
logical work of each track.

The port is driven through its public reader API only: ``DVDA`` for the
disc's track table, then for each decode ``TrackReader(AOBReader(path,
1, decrypt=...), track, config)``, as ``dvda2wav`` does.
"""

from __future__ import annotations

import gc
import os

import numpy as np

from ..gen.disc import make_album
from ..reference.expected import mlp_reference, pcm_wav
from ..roofline import cppm_ops_per_sector

__all__ = ["AlbumDriver"]


class AlbumDriver:
    def __init__(self, ctx, cache_dir: str):
        self.ctx = ctx
        self.cfg = ctx.config
        self.cache_dir = cache_dir
        self._ref = None
        self._pcm_wav = {}

    # -- set-up -------------------------------------------------------------

    def prepare(self) -> None:
        """Write the album and open the disc's track table."""
        from dvda_tpu_torch.api import DVDA

        self.audio_ts = os.path.join(self.ctx.workdir, "AUDIO_TS")
        self.album = make_album(self.cfg, self.ctx.seed, self.audio_ts,
                                self.cache_dir)
        title = DVDA(self.audio_ts).open_titleset(1).open_title(1)
        self.tracks = [title.open_track(n + 1)
                       for n in range(title.track_count)]
        if len(self.tracks) != len(self.album.tracks):
            raise RuntimeError("the disc's track table disagrees with the "
                               "album")
        self.hook = None
        if self.cfg.get("encrypted"):
            from dvda_tpu_torch.cppm.decrypt import CppmDecryptor

            dec = CppmDecryptor(self.album.media_key, self.album.album_id,
                                config=self.ctx.decode_config)
            span = self.ctx.span

            def hook(sectors):
                with span("cppm.hook"):
                    return dec.decrypt_sectors(sectors)

            self.hook = hook
        self.seconds = self.album.audio_seconds

    def open_reader(self, n: int):
        from dvda_tpu_torch.api import TrackReader
        from dvda_tpu_torch.container.aob import AOBReader

        return TrackReader(AOBReader(self.audio_ts, 1, decrypt=self.hook),
                           self.tracks[n], self.ctx.decode_config)

    def release(self) -> None:
        gc.collect()
        import torch

        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- the reference ----------------------------------------------------

    def mlp_ref(self):
        if self._ref is None:
            self._ref = mlp_reference(self.album.pool, self.cfg)
        return self._ref

    def expected_wav(self, n: int) -> np.ndarray:
        """Track ``n``'s WAV payload as the reference makes it."""
        track = self.album.tracks[n]
        if self.cfg["codec"] == "mlp":
            return self.mlp_ref().track_wav(track.layout)
        if n not in self._pcm_wav:
            self._pcm_wav = {n: pcm_wav(track.chunks, self.cfg)}
        return self._pcm_wav[n]

    # -- logical work -----------------------------------------------------

    def track_work(self, n: int) -> dict:
        """Track ``n``'s logical work by layer (see ``roofline.py``): the
        codec's layer (``mlp`` or ``pcm``), and ``cppm`` where the album
        is encrypted."""
        cfg, track = self.cfg, self.album.tracks[n]
        if cfg["codec"] == "mlp":
            ref = self.mlp_ref()
            counts = np.bincount(track.layout, minlength=len(ref.macs))
            wav = track.pcm_frames * ref.samples.shape[2] * (
                cfg["bits_per_sample"] // 8)
            out = {"mlp": {"bytes": float(counts @ ref.stream_bytes + wav),
                           "ops": float(2 * (counts @ ref.macs))}}
        else:
            out = {"pcm": {"bytes": 2.0 * track.chunks.size, "ops": 0.0}}
        if cfg.get("encrypted"):
            span = self.tracks[n].span
            sectors = span.last_sector - span.first_sector + 1
            out["cppm"] = {"bytes": 2.0 * 2048 * sectors,
                           "ops": float(sectors * cppm_ops_per_sector())}
        return out

    def window_work(self, decoded: list) -> dict:
        """The logical work of the tracks ``decoded`` (indices), summed
        by layer; made once the window has closed (MLP needs the
        reference's counts)."""
        work = {}
        for n in decoded:
            for layer, w in self.track_work(n).items():
                acc = work.setdefault(layer, {"bytes": 0.0, "ops": 0.0})
                acc["bytes"] += w["bytes"]
                acc["ops"] += w["ops"]
        return work

