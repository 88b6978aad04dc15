"""CPPM sector decryption — kernel K7 and its plain version.

Per sector (reference: cppm_decrypt_block and mpeg2_reset_cci,
cppm.c:486-614; the host C2, host/src/c2.cc): the pack
check, the scrambling control, the content key by 5 chained ``c2_g`` over
the header fields, D-CBC over the 240 big-endian words of bytes 128..2047,
the control reset and, unless ``preserve_cci``, the CCI walk.

* :func:`decrypt_sectors_device` — uint8 ``[N, 2048]`` sectors in place:
  on a CUDA tensor it launches csrc/c2_decrypt.cu or raises (a batch at
  an address that is not 16-byte aligned raises: a fresh allocation always
  is), on a CPU tensor it runs :func:`decrypt_sectors_reference`.
* :func:`dcbc_dec_device` and :func:`content_keys_device` — the cipher
  alone with the signatures of dvda_tpu/ops/c2_decrypt.py, in plain
  PyTorch, so that tests can hold it against the JAX functions.

The plain versions compute in int64 with 32-bit masks (torch's uint32 has
few arithmetic ops); "uint32" below means uint32 values held in int64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cppm.c2 import SBOX, SBOX_F
from ..kernels.launch import check, current_stream, on_cuda, raise_on_error

__all__ = ["decrypt_sectors_device", "decrypt_sectors_reference",
           "dcbc_dec_device", "content_keys_device", "SECTOR_SIZE"]

SECTOR_SIZE = 2048
_ENC_OFFSET = 128
_ENC_WORDS = 240
_FIELD_OFFSETS = (24, 32, 40, 48, 84)
_M32 = 0xFFFFFFFF
_M24 = 0x00FFFFFF

_tables: dict = {}


def _sboxes(device: torch.device, dtype: torch.dtype):
    """(SBOX, SBOX_F) of the cipher module (cppm/c2.py) on ``device``, cached."""
    key = (str(device), dtype)
    if key not in _tables:
        _tables[key] = tuple(
            torch.from_numpy(np.asarray(t).astype(np.int64)).to(dtype)
            .to(device) for t in (SBOX, SBOX_F))
    return _tables[key]


def _u32(t) -> torch.Tensor:
    t = torch.as_tensor(t)
    return t.to(torch.int64) & _M32


def _F(code, key, sbox_f):
    work = (code + key) & _M32
    work = work ^ sbox_f[work & 0xFF]
    rol9 = ((work << 9) | (work >> 23)) & _M32
    rol22 = ((work << 22) | (work >> 10)) & _M32
    return work ^ rol9 ^ rol22


def _schedule(ka, kb, rounds: int, sbox):
    sk = []
    for rnd in range(rounds):
        ka = ka & _M24
        sk.append((kb + (sbox[(ka & 0xFF) ^ rnd] << 4)) & _M32)
        kc = kb >> 15
        kd = ka >> 7
        ka = ((ka << 17) | kc) & _M32
        kb = ((kb << 17) | kd) & _M32
    return sk


def _c2_g(hi, lo, key_hi, key_lo, sbox, sbox_f):
    """c2_g over uint32 halves; returns the (hi, lo) halves unmasked."""
    sk = _schedule(key_hi, key_lo, 10, sbox)
    L, R = hi, lo
    for rnd in range(10):
        L, R = R, (L + _F(R, sk[rnd], sbox_f)) & _M32
    return R ^ hi, L ^ lo  # final swap


def content_keys_device(fields, kau_hi, kau_lo):
    """Per-sector content keys (cppm.c:540-556).  ``fields``: uint32
    ``[N, 5, 2]`` (hi/lo of the 64-bit values at offsets 24/32/40/48/84);
    returns (hi24, lo32) uint32 ``[N]``."""
    fields = _u32(fields)
    sbox, sbox_f = _sboxes(fields.device, torch.int64)
    n = fields.shape[0]
    khi = torch.full((n,), int(kau_hi) & _M32, dtype=torch.int64,
                     device=fields.device)
    klo = torch.full((n,), int(kau_lo) & _M32, dtype=torch.int64,
                     device=fields.device)
    for i in range(5):
        ghi, glo = _c2_g(fields[:, i, 0], fields[:, i, 1], khi, klo, sbox,
                         sbox_f)
        khi, klo = ghi & _M24, glo
    return khi, klo


def dcbc_dec_device(words, fields, kau):
    """D-CBC decryption of a sector batch, the plain PyTorch form of
    dvda_tpu's ``dcbc_dec_device``.  ``words``: uint32 ``[N, 240, 2]``
    (hi/lo of each big-endian word); ``fields``: uint32 ``[N, 5, 2]``;
    ``kau``: uint32 ``[2]`` (hi24, lo).  Returns the decrypted words."""
    words = _u32(words)
    kau = _u32(kau)
    key_hi, key_lo = content_keys_device(fields, int(kau[0]), int(kau[1]))
    sbox, sbox_f = _sboxes(words.device, torch.int64)
    ka, kb = key_hi, key_lo
    out = []
    for w in range(words.shape[1]):
        rounds = 10 if w == 0 else 2
        sk = _schedule(ka, kb, rounds, sbox)
        L, R = words[:, w, 0], words[:, w, 1]
        for rnd in range(9, -1, -1):
            L, R = R, (L - _F(R, sk[rnd % rounds], sbox_f)) & _M32
            if rnd == 5:
                ka, kb = key_hi ^ (R & _M24), key_lo ^ L
        out.append(torch.stack([R, L], 1))  # final swap
    return torch.stack(out, 1)


def _be_words(t: torch.Tensor) -> torch.Tensor:
    """int64 ``[..., 4k]`` bytes → ``[..., k]`` big-endian uint32 words."""
    b = t.reshape(t.shape[:-1] + (-1, 4))
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]


def decrypt_sectors_reference(sectors: torch.Tensor, k_au: int,
                              preserve_cci: bool) -> torch.Tensor:
    """Plain PyTorch version of :func:`decrypt_sectors_device`; returns the
    decrypted batch and leaves ``sectors`` as it is.  Lanes are sectors;
    the CCI walk, data-dependent per sector, is the numpy
    ``CppmDecryptor._reset_cci``."""
    check(sectors, "sectors", torch.uint8, (sectors.shape[0], SECTOR_SIZE),
          sectors.device)
    s = sectors.to(torch.int64)
    is_pack = ((s[:, 0] == 0) & (s[:, 1] == 0) & (s[:, 2] == 1)
               & (s[:, 3] == 0xBA))
    idx = torch.nonzero(is_pack & (((s[:, 20] >> 4) & 3) != 0))[:, 0]
    if idx.numel():
        enc = s[idx]
        fields = torch.stack(
            [_be_words(enc[:, o : o + 8]) for o in _FIELD_OFFSETS], 1)
        words = _be_words(enc[:, _ENC_OFFSET:]).reshape(-1, _ENC_WORDS, 2)
        kau = torch.tensor([k_au >> 32, k_au & _M32], dtype=torch.int64)
        dec = dcbc_dec_device(words, fields, kau).reshape(idx.numel(), -1)
        enc[:, _ENC_OFFSET:] = torch.stack(
            [(dec >> sh) & 0xFF for sh in (24, 16, 8, 0)], 2).reshape(
                idx.numel(), -1)
        enc[:, 20] &= 0xCD
        s[idx] = enc
    out = s.to(torch.uint8)
    if not preserve_cci:
        from ..cppm.decrypt import CppmDecryptor

        host = out.cpu().numpy()
        CppmDecryptor._reset_cci(None, host, is_pack.cpu().numpy())
        out = torch.from_numpy(host).to(sectors.device)
    return out


def _launch(sectors, k_au, preserve_cci):
    from ..kernels.build import kernel_library

    dev = sectors.device
    n = sectors.shape[0]
    check(sectors, "sectors", torch.uint8, (n, SECTOR_SIZE), dev)
    if sectors.data_ptr() % 16:
        raise ValueError("sectors: the kernel stages the batch by bulk "
                         "copies and needs 16-byte alignment")
    if n == 0:
        return sectors  # a zero-size grid is a CUDA error
    sbox, sbox_f = _sboxes(dev, torch.int32)
    lib = kernel_library()
    with torch.cuda.device(dev):
        rc = lib.dvda_c2_decrypt(sectors.data_ptr(), n, k_au,
                                 1 if preserve_cci else 0, sbox.data_ptr(),
                                 sbox_f.data_ptr(), current_stream(dev))
        decrypt_sectors_device.launches += 1
    raise_on_error(rc, "c2_decrypt")
    return sectors


def decrypt_sectors_device(sectors: torch.Tensor, k_au: int,
                           preserve_cci: bool = False) -> torch.Tensor:
    """Decrypt a uint8 ``[N, 2048]`` sector batch in place and return it.
    ``k_au = c2_g(album, media_key) & 0x00FFFFFFFFFFFFFF`` (the disc's
    key, as ``CppmDecryptor.k_au`` holds it).  Sectors that are not
    scrambled packs pass through (their CCI bytes aside)."""
    if not 0 <= k_au < 1 << 56:
        raise ValueError(f"k_au {k_au:#x} is not a 56-bit key")
    if on_cuda(sectors):
        return _launch(sectors, k_au, preserve_cci)
    return sectors.copy_(decrypt_sectors_reference(sectors, k_au,
                                                   preserve_cci))


#: kernel launches since the last reset (the CPU path never counts)
decrypt_sectors_device.launches = 0
