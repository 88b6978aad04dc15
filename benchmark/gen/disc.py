"""The benchmark's discs: an AUDIO_TS tree made from a configuration file
and ``--seed``.

The byte layout is that of the program's test disc builder
(``dvda_tpu_torch/testutil/synth.py``: pack header, one audio packet a
sector, a ``0xBE`` padding packet filling the sector; the IFO tables),
written here with whole-array numpy operations so that an album of
240-second tracks is laid out in about a second.

MLP tracks are laid out from a *pool* of restart units.  A unit is
``restart_every`` frames that begin with a major sync and a restart
header; with ``fir_across_restart`` false no filter state crosses a
restart, so a unit decodes alike wherever it stands.  The pool is
synthesised once per configuration (``pool_seed``) and cached; each track
is a seed-drawn order of the pool in which every unit appears equally
often, so that every seed gives the decoder the same work in another
order.  PCM tracks carry random sample bytes drawn from the seed.

A configuration with ``encrypted`` true, of either codec, CPPM-encrypts
every audio sector under a media key and album id drawn from the seed
before anything else the album draws; an album without it draws no keys,
so its bytes do not depend on the key draw.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass

import numpy as np

from ..fmt.bitstream import BitWriter
from ..fmt.params import (BPS_CODE, MLP_CODEC_ID, PCM_CODEC_ID,
                          PTS_PER_SECOND, RATE_CODE, unpack_channel_count)
from .mlp_synth import MlpSynthConfig, synth_mlp_stream

__all__ = ["Album", "Track", "make_album", "mlp_pool", "mlp_track_sectors",
           "pcm_chunk_size"]

SECTOR = 2048


@dataclass
class Track:
    """One track as the generator made it: ``layout`` (MLP: the pool
    unit of each restart unit, in order) or ``chunks`` (PCM: the plain
    ``[n, chunk]`` sample bytes), and its length in PCM frames."""

    pcm_frames: int
    layout: np.ndarray | None = None
    chunks: np.ndarray | None = None


@dataclass
class Album:
    audio_ts: str
    config: dict
    tracks: list
    pool: list | None = None       # MLP: the pool's unit streams
    media_key: int | None = None   # CPPM: the disc's keys
    album_id: int | None = None

    @property
    def audio_seconds(self) -> list:
        return [t.pcm_frames / self.config["sample_rate"] for t in self.tracks]


def _pack_header() -> bytes:
    """A valid MPEG-2 pack header, 14 bytes, no stuffing (packet.c:137-188)."""
    w = BitWriter()
    for bits, value in ((32, 0x000001BA), (2, 1), (3, 0), (1, 1), (15, 0),
                        (1, 1), (15, 0), (1, 1), (9, 0), (1, 1), (22, 0),
                        (2, 3), (5, 0x1F), (3, 0)):
        w.write(bits, value)
    return w.getvalue()


def _pcm_params(cfg: dict) -> bytes:
    """The 9-byte PCM stream-parameter block (pcm.c:79-96)."""
    return bytes([0x00, 0x01, 0x00,
                  (BPS_CODE[cfg["bits_per_sample"]] << 4) | 0xF,
                  (RATE_CODE[cfg["sample_rate"]] << 4) | 0xF,
                  0x00, cfg["channel_assignment"], 0x00, 0x00])


def _sectors(head: bytes, payload: np.ndarray, per_sector: list) -> np.ndarray:
    """Sectors of one packet each: the pack header, an audio packet of
    ``head`` (the 7-byte payload header and any pad-2 bytes) plus the
    next ``per_sector[i]`` payload bytes, and a padding packet filling the
    rest.  Runs of equal sizes are laid out as one array operation."""
    fixed = 14 + 6 + len(head)
    out = np.empty((len(per_sector), SECTOR), np.uint8)
    sizes = np.asarray(per_sector, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    # runs of equal size: all but (at most) the last two sectors
    bounds = np.flatnonzero(np.diff(sizes)) + 1
    for lo, hi in zip(np.r_[0, bounds], np.r_[bounds, len(sizes)]):
        n, size = int(hi - lo), int(sizes[lo])
        rem = SECTOR - fixed - size
        if 0 < rem < 6:
            raise ValueError(f"a sector would leave a gap of {rem} bytes")
        block = out[lo:hi]
        block[:, :14] = np.frombuffer(_pack_header(), np.uint8)
        length = len(head) + size
        block[:, 14:20] = (0, 0, 1, 0xBD, length >> 8, length & 0xFF)
        block[:, 20:fixed] = np.frombuffer(head, np.uint8)
        block[:, fixed:fixed + size] = payload[
            starts[lo]:starts[hi]].reshape(n, size)
        if rem:
            block[:, fixed + size:fixed + size + 6] = (
                0, 0, 1, 0xBE, (rem - 6) >> 8, (rem - 6) & 0xFF)
            block[:, fixed + size + 6:] = 0xFF
    return out


def _split(total: int, cap: int, unit: int = 1, fixed: int = 0) -> list:
    """Payload bytes per sector: full sectors of ``cap`` bytes (a whole
    number of ``unit``-byte chunks), then the rest; a last sector whose
    padding would be 1-5 bytes, which no padding packet fits, is split in
    two."""
    full, rest = divmod(total, cap)
    sizes = [cap] * full
    if rest:
        gap = SECTOR - fixed - rest
        if 0 < gap < 6:
            half = (rest // unit // 2) * unit
            sizes += [half, rest - half]
        else:
            sizes.append(rest)
    return sizes


def _mlp_sectors(stream: np.ndarray) -> np.ndarray:
    head = bytes([0x81, 0x80, 0x00, MLP_CODEC_ID, 0x00, 0x00, 0x00])
    fixed = 14 + 6 + len(head)
    return _sectors(head, stream, _split(stream.size, SECTOR - fixed,
                                         fixed=fixed))


def pcm_chunk_size(cfg: dict) -> int:
    """Bytes per 2-frame chunk (pcm.c:66-68)."""
    return (cfg["bits_per_sample"] // 8) * _channels(cfg) * 2


def _pcm_sectors(cfg: dict, chunks: np.ndarray) -> np.ndarray:
    params = _pcm_params(cfg)
    head = bytes([0x81, 0x80, 0x00, PCM_CODEC_ID, 0x00, 0x00,
                  len(params)]) + params
    fixed = 14 + 6 + len(head)
    csize = chunks.shape[1]
    per = (SECTOR - fixed) // csize
    while per > 1 and 0 < SECTOR - fixed - per * csize < 6:
        per -= 1
    return _sectors(head, chunks.reshape(-1),
                    _split(chunks.size, per * csize, csize, fixed))


def _channels(cfg: dict) -> int:
    return unpack_channel_count(cfg["channel_assignment"])


def _ats_ifo(spans: list) -> bytes:
    """ATS_01_0.IFO for one title of tracks given as (first sector, last
    sector, pts index, pts length) (dvd-audio.c:860-950)."""
    out = bytearray(SECTOR)
    out[0:12] = b"DVDAUDIO-ATS"
    n = len(spans)
    body = bytearray((1).to_bytes(2, "big") + b"\x00" * 6)
    body += bytes([1]) + b"\x00" * 3 + (16).to_bytes(4, "big")
    body += b"\x00\x00" + bytes([n, n])
    body += sum(s[3] for s in spans).to_bytes(4, "big") + b"\x00" * 4
    body += (16 + 20 * n).to_bytes(2, "big") + b"\x00\x00"
    for j, (_, _, pts_index, pts_length) in enumerate(spans):
        body += b"\x00" * 4 + bytes([j + 1, 0])
        body += pts_index.to_bytes(4, "big") + pts_length.to_bytes(4, "big")
        body += b"\x00" * 6
    for first, last, _, _ in spans:
        body += b"\x01\x00\x00\x00" + first.to_bytes(4, "big")
        body += last.to_bytes(4, "big")
    return bytes(out) + bytes(body)


def _write_disc(audio_ts: str, track_sectors: list, pts_lengths: list):
    os.makedirs(audio_ts, exist_ok=True)
    ifo = bytearray(SECTOR)
    ifo[0:12] = b"DVDAUDIO-AMG"
    ifo[63] = 1
    spans, first, pts = [], 0, 0
    for sectors, pts_length in zip(track_sectors, pts_lengths):
        spans.append((first, first + sectors.shape[0] - 1, pts, pts_length))
        first += sectors.shape[0]
        pts += pts_length
    with open(os.path.join(audio_ts, "AUDIO_TS.IFO"), "wb") as f:
        f.write(bytes(ifo))
    with open(os.path.join(audio_ts, "ATS_01_0.IFO"), "wb") as f:
        f.write(_ats_ifo(spans))
    with open(os.path.join(audio_ts, "ATS_01_1.AOB"), "wb") as f:
        for sectors in track_sectors:
            f.write(memoryview(sectors).cast("B"))
        # written back now, in the set-up, and not by the kernel's flusher
        # threads during the measured window
        f.flush()
        os.fsync(f.fileno())


# ------------------------------------------------------------- MLP pool

def _synth_config(cfg: dict, n_frames: int, seed: int) -> MlpSynthConfig:
    return MlpSynthConfig(
        channel_assignment=cfg["channel_assignment"],
        sample_rate=cfg["sample_rate"],
        bits_per_sample=cfg["bits_per_sample"],
        substream_count=cfg["substreams"], n_frames=n_frames,
        blocks_per_frame=cfg["blocks_per_frame"],
        block_size=cfg["block_size"],
        major_sync_every=cfg["restart_every"],
        restart_every=cfg["restart_every"], seed=seed,
        fir_across_restart=False,
        params_update_prob=cfg["params_update_prob"],
        out_shift_range=tuple(cfg["out_shift_range"]))


def _units(stream: bytes, frames_per_unit: int) -> list:
    """Cut a stream into units of ``frames_per_unit`` length-delimited
    frames (the frame header's 12-bit length in 2-byte words)."""
    ends, off = [], 0
    while off < len(stream):
        off += (((stream[off] & 0x0F) << 8) | stream[off + 1]) * 2
        ends.append(off)
    cuts = [0] + ends[frames_per_unit - 1::frames_per_unit]
    return [stream[a:b] for a, b in zip(cuts, cuts[1:])]


def mlp_pool(cfg: dict, cache_dir: str | None) -> list:
    """The configuration's pool of restart units (bytes each), made from
    ``pool_seed`` by the synthesiser, cached under ``cache_dir`` by a key
    of the configuration's stream keys and the synthesiser's source."""
    keys = ("channel_assignment", "sample_rate", "bits_per_sample",
            "substreams", "blocks_per_frame", "block_size", "restart_every",
            "params_update_prob", "out_shift_range", "pool_units",
            "pool_seed")
    with open(os.path.join(os.path.dirname(__file__), "mlp_synth.py"),
              "rb") as f:
        src = f.read()
    tag = hashlib.sha256(json.dumps([cfg[k] for k in keys]).encode()
                         + src).hexdigest()[:16]
    path = (os.path.join(cache_dir, f"pool-{cfg['name']}-{tag}.npz")
            if cache_dir else None)
    if path and os.path.exists(path):
        with np.load(path) as z:
            blob, ends = z["blob"].tobytes(), z["ends"]
        return [blob[a:b] for a, b in zip(np.r_[0, ends[:-1]], ends)]
    k, per = cfg["pool_units"], cfg["restart_every"]
    pool = _units(synth_mlp_stream(_synth_config(cfg, k * per,
                                                 cfg["pool_seed"])), per)
    if len(pool) != k:
        raise RuntimeError(f"pool of {len(pool)} units, expected {k}")
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.part"   # concurrent writers
        with open(tmp, "wb") as f:
            np.savez(f, blob=np.frombuffer(b"".join(pool), np.uint8),
                     ends=np.cumsum([len(u) for u in pool]))
        os.replace(tmp, path)
    return pool


def unit_frames(cfg: dict) -> int:
    """PCM frames in one restart unit."""
    return cfg["restart_every"] * cfg["blocks_per_frame"] * cfg["block_size"]


def _mlp_album(cfg: dict, rng: np.random.Generator, audio_ts: str,
               cache_dir: str | None) -> Album:
    pool = mlp_pool(cfg, cache_dir)
    k = len(pool)
    per_track = cfg["track_seconds"] * cfg["sample_rate"] // unit_frames(cfg)
    if per_track % k:
        raise ValueError(f"{per_track} units a track is no multiple of the "
                         f"pool's {k}")
    album = Album(audio_ts, cfg, [], pool=pool)
    _draw_keys(album, rng)
    sectors, pts = [], []
    for _ in range(cfg["tracks"]):
        layout = rng.permutation(np.repeat(np.arange(k), per_track // k))
        sectors.append(_encrypt(album, mlp_track_sectors(pool, layout)))
        frames = per_track * unit_frames(cfg)
        album.tracks.append(Track(frames, layout=layout))
        pts.append(int(round(frames * PTS_PER_SECOND / cfg["sample_rate"])))
    _write_disc(audio_ts, sectors, pts)
    return album


def mlp_track_sectors(pool: list, layout: np.ndarray) -> np.ndarray:
    """The plain sectors of an MLP track: the pool's units in ``layout``
    order, as one stream."""
    return _mlp_sectors(np.frombuffer(b"".join([pool[u] for u in layout]),
                                      np.uint8))


def _draw_keys(album: Album, rng: np.random.Generator) -> None:
    """Draw the disc's media key and album id where the configuration
    is encrypted (nothing otherwise)."""
    if album.config.get("encrypted"):
        album.media_key = int(rng.integers(0, 1 << 56, dtype=np.uint64))
        album.album_id = int(rng.integers(0, 1 << 63, dtype=np.uint64))


def _encrypt(album: Album, sec: np.ndarray) -> np.ndarray:
    """One track's sectors, CPPM-encrypted in place under the album's
    keys where the configuration is encrypted, on the card where there
    is one."""
    if not album.config.get("encrypted"):
        return sec
    import torch

    from .c2 import encrypt_sectors

    dev = "cuda" if torch.cuda.is_available() else "cpu"
    step = 1 << 15  # sectors a pass: about 0.5 GB of int64 words
    for lo in range(0, sec.shape[0], step):
        part = torch.from_numpy(sec[lo:lo + step]).to(dev)
        sec[lo:lo + step] = encrypt_sectors(
            part, album.media_key, album.album_id).cpu().numpy()
    return sec


def _pcm_album(cfg: dict, rng: np.random.Generator, audio_ts: str) -> Album:
    frames = cfg["track_seconds"] * cfg["sample_rate"]
    csize = pcm_chunk_size(cfg)
    album = Album(audio_ts, cfg, [])
    _draw_keys(album, rng)
    sectors, pts = [], []
    for _ in range(cfg["tracks"]):
        chunks = np.frombuffer(rng.bytes(frames // 2 * csize),
                               np.uint8).reshape(-1, csize)
        sectors.append(_encrypt(album, _pcm_sectors(cfg, chunks)))
        album.tracks.append(Track(frames, chunks=chunks))
        pts.append(frames * PTS_PER_SECOND // cfg["sample_rate"])
    _write_disc(audio_ts, sectors, pts)
    return album


def make_album(cfg: dict, seed: int, audio_ts: str,
               cache_dir: str | None = None) -> Album:
    """Write the configuration's album for ``seed`` under ``audio_ts``."""
    rng = np.random.default_rng(seed)
    if cfg["codec"] == "mlp":
        return _mlp_album(cfg, rng, audio_ts, cache_dir)
    if cfg["codec"] == "pcm":
        return _pcm_album(cfg, rng, audio_ts)
    raise ValueError(f"unknown codec {cfg['codec']!r}")
