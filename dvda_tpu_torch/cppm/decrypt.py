"""CPPM sector decryption on the decode device.

Port of dvda_tpu/cppm/decrypt.py::CppmDecryptor (reference analog:
``cppm_decrypt_block``, cppm.c:531-566, the PES scrambling-control / CCI
helpers, :568-614, and key derivation in ``cppm_init``, :193-239).  Key
derivation (k_au from the media key and album ID), the MKB and drive
constructors, the vectorised content keys and the CCI walk are copied
from dvda_tpu; :meth:`CppmDecryptor.decrypt_sectors` sends every batch
through kernel K7 on ``DecodeConfig.device`` — no host C2.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DecodeConfig, default_config
from ..ops.c2_decrypt import SECTOR_SIZE, decrypt_sectors_device
from ..utils.profiling import global_timer
from .c2 import c2_g
from .mkb import load_mkb, process_mkb

__all__ = ["CppmDecryptor", "COPYRIGHT_CPPM"]

_M56 = 0x00FFFFFFFFFFFFFF
_M32 = 0xFFFFFFFF

COPYRIGHT_NONE = 0  # COPYRIGHT_PROTECTION_NONE (cppm.h:43)
COPYRIGHT_CPPM = 1  # COPYRIGHT_PROTECTION_CPPM (cppm.h:44)


def _be64(sectors: np.ndarray, offset: int) -> np.ndarray:
    """Per-sector big-endian uint64 at a byte offset."""
    b = sectors[:, offset : offset + 8].astype(np.uint64)
    out = np.zeros(sectors.shape[0], dtype=np.uint64)
    for i in range(8):
        out = (out << np.uint64(8)) | b[:, i]
    return out


def _c2_g_vec(code: np.ndarray, key: np.ndarray) -> np.ndarray:
    """Vectorised c2_g over uint64 arrays (cppm.c:481-484)."""
    from .c2 import SBOX, _F_vec

    L = (code >> np.uint64(32)).astype(np.uint32)
    R = (code & np.uint64(_M32)).astype(np.uint32)
    ka = ((key >> np.uint64(32)) & np.uint64(0x00FFFFFF)).astype(np.uint32)
    kb = (key & np.uint64(_M32)).astype(np.uint32)
    sk = []
    for rnd in range(10):
        ka &= np.uint32(0x00FFFFFF)
        sk.append(kb + (SBOX[(ka & np.uint32(0xFF)) ^ np.uint32(rnd)] << np.uint32(4)))
        kc = kb >> np.uint32(15)
        kd = ka >> np.uint32(7)
        ka = (ka << np.uint32(17)) | kc
        kb = (kb << np.uint32(17)) | kd
    for rnd in range(10):
        L = L + _F_vec(R, sk[rnd])
        L, R = R, L
    L, R = R, L
    enc = (L.astype(np.uint64) << np.uint64(32)) | R.astype(np.uint64)
    return enc ^ code


class CppmDecryptor:
    """Per-disc decryptor (media key + album ID) whose
    :meth:`decrypt_sectors` is the hook ``AOBReader(decrypt=...)`` calls
    once per sector batch."""

    def __init__(self, media_key: int, id_album_media: int,
                 preserve_cci: bool = False,
                 config: DecodeConfig | None = None):
        self.media_key = media_key
        self.id_album_media = id_album_media
        self.preserve_cci = preserve_cci
        # k_au is per-disc (cppm.c:540-541)
        self.k_au = c2_g(id_album_media, media_key) & _M56
        self.config = config
        self._host: torch.Tensor | None = None  # pinned staging buffer
        self._dev: torch.Tensor | None = None

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_mkb_file(cls, mkb_path: str, id_album_media: int,
                      **kw) -> "CppmDecryptor | None":
        """File-based path: derive the media key from DVDAUDIO.MKB; the
        album ID must come from drive auth or be supplied by the caller."""
        mkb = load_mkb(mkb_path)
        if mkb is None:
            return None
        media_key = process_mkb(mkb)
        if media_key is None:
            return None
        return cls(media_key, id_album_media, **kw)

    @classmethod
    def from_drive(cls, drive, mkb_path: str,
                   **kw) -> "CppmDecryptor | None":
        """Probe + derive from an open :class:`css.DriveBackend`
        (cppm_init, cppm.c:193-239): the copyright flag decides whether the
        disc is protected at all (``ioctl_ReadCopyright``, ioctl.c:142 —
        NOT inferred from MKB file presence), then the album ID is read
        over the authenticated handshake (ASF-verified, ``GetASF``
        dvd_css.c:344) and the MKB file yields the media key."""
        from .css import read_album_id

        try:
            if drive.read_copyright() != COPYRIGHT_CPPM:
                return None  # unprotected (or unsupported scheme)
            album = read_album_id(drive)
        except OSError:
            return None
        return cls.from_mkb_file(mkb_path, album, **kw)

    @classmethod
    def from_device(cls, device: str, mkb_path: str,
                    **kw) -> "CppmDecryptor | None":
        """Full reference path against a real drive node (Linux ioctls)."""
        from .css import LinuxDrive

        try:
            drive = LinuxDrive(device)
        except OSError:
            return None
        try:
            return cls.from_drive(drive, mkb_path, **kw)
        finally:
            drive.close()

    def _content_keys(self, sectors: np.ndarray) -> np.ndarray:
        """Per-sector content key chain (cppm.c:540-556)."""
        k = np.full(sectors.shape[0], np.uint64(self.k_au), dtype=np.uint64)
        for off in (24, 32, 40, 48):
            k = _c2_g_vec(_be64(sectors, off), k) & np.uint64(_M56)
        return _c2_g_vec(_be64(sectors, 84), k) & np.uint64(_M56)

    def _reset_cci(self, sectors: np.ndarray, is_pack: np.ndarray) -> None:
        """Zero the copy-control bytes (mpeg2_reset_cci, cppm.c:582-614)."""
        for n in np.nonzero(is_pack)[0]:
            sec = sectors[n]
            pos = 14 + int(sec[13] & 0x07)
            while pos + 9 <= SECTOR_SIZE:
                if not (sec[pos] == 0 and sec[pos + 1] == 0 and sec[pos + 2] == 1):
                    break
                pes_len = (int(sec[pos + 4]) << 8) | int(sec[pos + 5])
                if sec[pos + 3] == 0xBD:
                    p = pos + 9 + int(sec[pos + 8])
                    if p + 13 <= SECTOR_SIZE:
                        if sec[p] == 0xA0 and sec[p + 3] > 8:
                            sec[p + 12] = 0
                        elif sec[p] == 0xA1 and sec[p + 3] > 4:
                            sec[p + 8] = 0
                pos += 6 + pes_len

    # -- decryption ---------------------------------------------------------

    def _device(self) -> torch.device:
        cfg = self.config if self.config is not None else default_config()
        dev = cfg.resolved_device()
        if dev.type == "cuda" and dev.index is None:
            # the index the buffers carry, so that _buffers can compare
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev

    def _buffers(self, n: int, dev: torch.device):
        if self._dev is None or self._dev.shape[0] < n \
                or self._dev.device != dev:
            self._dev = torch.empty((n, SECTOR_SIZE), dtype=torch.uint8,
                                    device=dev)
            self._host = torch.empty((n, SECTOR_SIZE), dtype=torch.uint8,
                                     pin_memory=True)
        return self._host[:n], self._dev[:n]

    def decrypt_sectors(self, sectors: np.ndarray) -> np.ndarray:
        """Decrypt a ``[N, 2048] uint8`` batch; returns a new array
        (unencrypted sectors pass through, their CCI bytes aside).  On CUDA:
        pinned copy, h2d, K7, d2h, synchronise — the host demux reads the
        result at once."""
        with global_timer.stage("cppm/decrypt"):
            sectors = np.ascontiguousarray(sectors, dtype=np.uint8)
            dev = self._device()
            if sectors.shape[0] == 0:
                return sectors.copy()
            if dev.type != "cuda":
                with global_timer.stage("cppm/copy"):
                    out = torch.from_numpy(sectors.copy())
                decrypt_sectors_device(out, self.k_au, self.preserve_cci)
                return out.numpy()
            host, buf = self._buffers(sectors.shape[0], dev)
            with global_timer.stage("cppm/copy"):
                host.numpy()[...] = sectors
            with torch.cuda.device(dev):
                buf.copy_(host, non_blocking=True)
                decrypt_sectors_device(buf, self.k_au, self.preserve_cci)
                host.copy_(buf, non_blocking=True)
                torch.cuda.current_stream(dev).synchronize()
            with global_timer.stage("cppm/copy"):
                return host.numpy().copy()
