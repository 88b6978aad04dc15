"""Decode configuration of the port — the fields of dvda_tpu's DecodeConfig
(dvda_tpu/config.py:89-285) that the port's decode path reads.

    =========================================  =================================
    env var                                    effect
    =========================================  =================================
    ``DVDA_TPU_TORCH_DEVICE=<device>``         torch device of the decode
                                               (default ``cuda``)
    ``DVDA_TPU_TORCH_CHUNK_CHAINS=N``          restart chains per device chunk
                                               at 6-channel output (default 256)
    ``DVDA_TPU_TORCH_DISABLE_NATIVE=1``        MLP through the Python engines
                                               (the batched engine on
                                               ``device``: planner, K1, K9;
                                               the spec decoder where it bails)
                                               instead of the native parser
    ``DVDA_TPU_TORCH_PARSE_THREADS=N``         native MLP parse worker threads
                                               (0 = auto: min(8, cpu_count))
    ``DVDA_TPU_TORCH_DEVICE_HUFFMAN=1``        device-Huffman mode: the parse
                                               skips residual values, kernel
                                               K5 decodes them on the device
    ``DVDA_TPU_TORCH_HUFFMAN_SPLIT=k``         device Huffman: one K5 lane per
                                               k samples (0 = one per block)
    ``DVDA_TPU_TORCH_NARROW_D2H=1|0``          24-bit MLP: read chunks back at
                                               the narrow tiers (12/16-bit,
                                               kernel K234n) and widen on the
                                               host; unset = on
    ``DVDA_TPU_TORCH_DISABLE_NATIVE_PACK=1``   MLP chunk arenas built in numpy
                                               instead of by ``mp_pack`` (the
                                               differential oracle of the
                                               native arena builder)
    ``DVDA_TPU_TORCH_MULTI_DEVICE=1``          MLP chunks round-robin over
                                               every visible CUDA device
    ``DVDA_TPU_TORCH_DISABLE_DRAIN_THREAD=1``  MLP chunk outputs stay on the
                                               card and are copied back at
                                               the end of the decode (the
                                               differential and diagnostic
                                               counterpart of the side-stream
                                               drain)
    ``DVDA_TPU_TORCH_LOG=<level>``             level of the ``dvda_tpu_torch``
                                               logger (utils/log.configure)
    ``DVDA_TPU_TORCH_DISABLE_NATIVE_DEMUX=1``  the Python packet walk instead
                                               of the native demux, for PCM
                                               (no packed fast path) and
                                               MLP stream assembly (the
                                               differential oracle, as
                                               ``DVDA_TPU_DISABLE_NATIVE_DEMUX``
                                               is dvda_tpu's)
    =========================================  =================================

``io_batch_sectors`` and ``preserve_cci`` have no env var, as in dvda_tpu:
set them on the config.

There is no link probe and no automatic executor choice: the decode runs
on ``device``, in the mode ``device_huffman`` names (no auto mode: the
JAX package's crossover was measured on a TPU).  With the default
``"cuda"`` and no CUDA device a decode raises; the CPU (the kernels'
plain versions) runs only when asked for with ``device="cpu"``.  That
includes PCM (kernel K8) and CPPM (kernel K7): a protected disc decrypts
on ``device``, never through the host C2.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

__all__ = ["DecodeConfig", "default_config"]


def _env_tristate(name: str) -> bool | None:
    """``1`` / ``0`` / unset (or empty) → True / False / None; any other
    value raises, as dvda_tpu's ``_env_tristate`` does."""
    raw = os.environ.get(name, "")
    if raw in ("1", ""):
        return True if raw == "1" else None
    if raw == "0":
        return False
    raise ValueError(f"{name}={raw!r}: expected '1', '0', or unset (auto)")


@dataclass
class DecodeConfig:
    #: torch device the chunk program runs on
    device: str = "cuda"
    #: MLP: the native C++ host parser and the chunk program; False
    #: selects the Python engines (codecs/mlp/engine.py: the planner, then
    #: K1 and K9 on ``device``), which also take every stream the native
    #: parser hands back
    use_native: bool = True
    #: restart chains per dispatched chunk **at 6-channel output**, scaled
    #: inversely with the stream's channel count (resolved_chunk_chains)
    chunk_chains: int = 256
    #: host parse threads (0 = auto: min(8, cpu_count))
    parse_threads: int = 0
    #: device-Huffman mode (dvda_tpu's ``device_huffman``; its auto mode
    #: is off on every backend but a TPU): the host parse walks the
    #: residual bits length-only and kernel K5 decodes the values on the
    #: device from the track's stream words
    device_huffman: bool = False
    #: device Huffman: samples per K5 lane (the parse records every k-th
    #: sample's bit offset); 0 = one lane per block
    huffman_split: int = 0
    #: use the native C++ packet demux for PCM tracks and MLP stream
    #: assembly (the Python packet walk otherwise, its executable
    #: specification; only the native PCM walk has the packed fast path)
    use_native_demux: bool = True
    #: sectors per host I/O batch of the Python PCM packet walk
    io_batch_sectors: int = 4096
    #: CPPM: decrypt when the disc has a DVDAUDIO.MKB and a drive node was
    #: given (``open_disc(path, device=...)``); False reads the sectors as
    #: they are
    decrypt: bool = True
    #: CPPM: keep the CCI copy-control bytes instead of zeroing them
    preserve_cci: bool = False
    #: narrow readback of 24-bit MLP chunks (dvda_tpu's ``narrow_d2h``):
    #: K234n returns each chunk at the track's tier (12-bit channel pairs
    #: or int16) with an on-device fits flag, chunks that overflow their
    #: tier are run again wider, and the host widens to 24-bit.  Lossless
    #: either way.  None = on, as in dvda_tpu
    narrow_d2h: bool | None = None
    #: build each MLP chunk's arenas with the native ``mp_pack``; False
    #: (or a parse without a live native handle) builds them in numpy, the
    #: differential oracle of ``mp_pack``: byte-identical arenas and spec
    native_pack: bool = True
    #: round-robin the MLP chain chunks over every visible CUDA device
    #: (chunk ``i`` on device ``i % n``; chunks are independent).  With
    #: one device, or on the CPU, it is the one-device decode
    multi_device: bool = False
    #: drain each MLP chunk's output to the host on a side stream as it is
    #: pushed (the port's counterpart of dvda_tpu's drain thread); False
    #: keeps the outputs on the card, reads the first narrow flag as it
    #: lands and copies everything back at the end, in push order.  The
    #: bytes are the same: a differential and diagnostic mode
    drain_thread: bool = True

    def resolved_narrow_d2h(self) -> bool:
        return True if self.narrow_d2h is None else self.narrow_d2h

    def resolved_parse_threads(self) -> int:
        if self.parse_threads > 0:
            return self.parse_threads
        return min(8, os.cpu_count() or 1)

    def resolved_huffman_split(self) -> int:
        """``huffman_split`` clamped to the parser's 0..255."""
        return min(255, max(0, self.huffman_split))

    def resolved_chunk_chains(self, out_ch: int = 6) -> int:
        """``chunk_chains`` clamped to >=1, scaled by ``6/out_ch`` (rounded):
        restart chains a chunk, whatever a chain's length, so a chunk of
        longer chains holds more samples (768 chains of 1,280 samples at
        2.0/192k: twice the 5.1/96k chunk's).  The output is byte-identical
        for any chunk size."""
        return max(1, round(max(1, self.chunk_chains) * 6 / max(1, out_ch)))

    def resolved_device(self) -> torch.device:
        """The decode device; raises when it is a CUDA device and CUDA is
        not available (no silent move to the CPU)."""
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"decode device {self.device!r} requested but CUDA is not "
                "available; pass DecodeConfig(device='cpu') to run the "
                "plain PyTorch versions on the CPU")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported decode device {self.device!r}")
        return dev

    @classmethod
    def from_env(cls) -> "DecodeConfig":
        return cls(
            device=os.environ.get("DVDA_TPU_TORCH_DEVICE", "cuda"),
            use_native=os.environ.get("DVDA_TPU_TORCH_DISABLE_NATIVE",
                                      "0") != "1",
            chunk_chains=int(os.environ.get("DVDA_TPU_TORCH_CHUNK_CHAINS",
                                            "256")),
            parse_threads=int(os.environ.get("DVDA_TPU_TORCH_PARSE_THREADS",
                                             "0")),
            device_huffman=os.environ.get("DVDA_TPU_TORCH_DEVICE_HUFFMAN",
                                          "0") == "1",
            huffman_split=int(os.environ.get("DVDA_TPU_TORCH_HUFFMAN_SPLIT",
                                             "0")),
            use_native_demux=os.environ.get(
                "DVDA_TPU_TORCH_DISABLE_NATIVE_DEMUX", "0") != "1",
            narrow_d2h=_env_tristate("DVDA_TPU_TORCH_NARROW_D2H"),
            native_pack=os.environ.get("DVDA_TPU_TORCH_DISABLE_NATIVE_PACK",
                                       "0") != "1",
            multi_device=os.environ.get("DVDA_TPU_TORCH_MULTI_DEVICE",
                                        "0") == "1",
            drain_thread=os.environ.get(
                "DVDA_TPU_TORCH_DISABLE_DRAIN_THREAD", "0") != "1",
        )


def default_config() -> DecodeConfig:
    """The environment-derived config, evaluated at call time."""
    return DecodeConfig.from_env()
