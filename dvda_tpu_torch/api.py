"""Public reader API of the port: ``open_disc(path)`` down to
``TrackReader.read_all()`` / ``read_all_packed()``.

The dvd-audio.h object model of dvda_tpu/api.py (disc, titleset, title,
track, reader), copied into the port.  The reader's decode goes through
the port's device path: MLP through kernels K1/K234 (K5) on uniform
streams, K6a/K1/K6b on the general path and K1/K9 in the Python engines
(``DecodeConfig(use_native=False)``, or a stream the native parser hands
back; ``TrackReader.decode_info["path"]`` names the path), PCM through K8,
and a CPPM-protected disc's sectors through K7 (``cppm/decrypt.py``).  On an
MLP track the pull API, ``read_range``, ``manifest`` and ``iter_packed``
are segment-backed, as in dvda_tpu: they decode only the segments between
the track's resume points that they need (``codecs/mlp/track.py``).

Two devices, as in dvda_tpu: ``open_disc(path, device=...)`` names the
*optical drive node* that CPPM authenticates against; the torch device of
the decode is ``DecodeConfig.device``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from . import host
from .bitstream import BitReader, BitstreamError
from .codecs import pcm as pcm_codec
from .codecs.mlp.track import (decode_mlp_track, iter_mlp_packed_segments,
                               open_mlp_segment_reader, track_manifest)
from .codecs.params import MLP_CODEC_ID, PCM_CODEC_ID, PTS_PER_SECOND
from .config import DecodeConfig, default_config
from .container import ifo as ifo_mod
from .container.aob import AOBReader
from .container.audio_ts import find_audio_ts_file
from .container.packet import demux_audio_packets, read_audio_packet_header
from .ops.pcm_unpack import decode_chunks_device
from .utils.profiling import global_timer
from .utils.wav import pack_samples_le

__all__ = ["DVDA", "Titleset", "Title", "Track", "TrackReader", "open_disc"]

class DvdaError(RuntimeError):
    pass


def _make_decrypt(audio_ts_path: str, device: str | None,
                  cfg: DecodeConfig):
    """The CPPM sector hook (dvda_tpu/api.py:_make_decrypt; aob.c:127-142):
    the port's decryptor when the disc has an MKB and a drive node was
    given and reports CPPM, else None (the sectors are read as they
    are)."""
    mkb_path = find_audio_ts_file(audio_ts_path, "DVDAUDIO.MKB")
    if mkb_path is None or device is None:
        return None
    from .cppm.decrypt import CppmDecryptor

    try:
        dec = CppmDecryptor.from_device(device, mkb_path,
                                        preserve_cci=cfg.preserve_cci,
                                        config=cfg)
    except Exception:  # as dvda_tpu: an unreadable drive or MKB = no hook
        return None
    return dec.decrypt_sectors if dec is not None else None


class DVDA:
    """A DVD-Audio disc (reference: dvda_open, dvd-audio.c:324-353).
    ``device`` is the optical drive node for CPPM (None: no drive, so no
    decryption); the decode's torch device is ``config.device``."""

    def __init__(self, audio_ts_path: str | os.PathLike,
                 device: str | None = None,
                 config: DecodeConfig | None = None):
        audio_ts_path = os.fspath(audio_ts_path)
        ifo_path = find_audio_ts_file(audio_ts_path, "audio_ts.ifo")
        if ifo_path is None:
            raise DvdaError(f"AUDIO_TS.IFO not found under {audio_ts_path}")
        with open(ifo_path, "rb") as f:
            self._titleset_count = ifo_mod.parse_audio_ts_ifo(f.read())
        if self._titleset_count == 0:
            raise DvdaError("invalid AUDIO_TS.IFO")
        self.audio_ts_path = audio_ts_path
        self.device = device
        #: explicit config, or None = environment-derived at decode time
        self.config = config

    @property
    def titleset_count(self) -> int:
        return self._titleset_count

    def open_titleset(self, titleset: int) -> "Titleset":
        return Titleset(self, titleset)

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Titleset:
    """A titleset (reference: dvda_open_titleset, dvd-audio.c:369-413)."""

    def __init__(self, dvda: DVDA, titleset: int):
        name = f"ATS_{min(titleset, 99):02d}_0.IFO"
        path = find_audio_ts_file(dvda.audio_ts_path, name)
        if path is None:
            raise DvdaError(f"{name} not found")
        with open(path, "rb") as f:
            self._ifo = ifo_mod.parse_ats_ifo(f.read())
        self.dvda = dvda
        self.number = titleset

    @property
    def title_count(self) -> int:
        return self._ifo.title_count

    def open_title(self, title: int) -> "Title":
        return Title(self, ifo_mod.resolve_title_toc(self._ifo, title))

    def close(self) -> None:
        pass


class Title:
    """A title (reference: dvda_open_title, dvd-audio.c:437-502)."""

    def __init__(self, titleset: Titleset, toc: ifo_mod.TitleToc):
        self.titleset = titleset
        self._toc = toc
        self.number = toc.title_number

    @property
    def track_count(self) -> int:
        return len(self._toc.tracks)

    @property
    def pts_length(self) -> int:
        return self._toc.pts_length

    def open_track(self, track: int) -> "Track":
        if track < 1 or track > len(self._toc.tracks):
            raise DvdaError(f"track {track} out of range")
        return Track(self, track, self._toc.tracks[track - 1])

    def close(self) -> None:
        pass


@dataclass
class Track:
    """A track (reference: dvda_open_track, dvd-audio.c:530-557)."""

    title: Title
    number: int
    span: ifo_mod.TrackSpan

    @property
    def pts_index(self) -> int:
        return self.span.pts_index

    @property
    def pts_length(self) -> int:
        return self.span.pts_length

    @property
    def first_sector(self) -> int:
        return self.span.first_sector

    @property
    def last_sector(self) -> int:
        return self.span.last_sector

    def open_reader(self, config: DecodeConfig | None = None) -> "TrackReader":
        ts = self.title.titleset
        dvda = ts.dvda
        config = config if config is not None else dvda.config
        cfg = config if config is not None else default_config()
        decrypt = (_make_decrypt(dvda.audio_ts_path, dvda.device, cfg)
                   if cfg.decrypt else None)
        aob = AOBReader(dvda.audio_ts_path, ts.number, decrypt=decrypt)
        return TrackReader(aob, self, config=config)

    def close(self) -> None:
        pass


class TrackReader:
    """Decoded-track access (reference: dvda_open_track_reader/dvda_read,
    dvd-audio.c:597-795).  :meth:`read` serves interleaved
    RIFF-WAVE-ordered int32 frames with the semantics of ``dvda_read``
    (short final read, 0 at end of stream): on an MLP track of the native
    path from the manifest segments around the cursor, elsewhere from the
    whole-track decode, which the port's device path makes on first
    access."""

    def __init__(self, aob: AOBReader, track: Track,
                 config: DecodeConfig | None = None):
        self.aob = aob
        self.track = track
        self.config = config
        #: what the MLP decode reports (``path``: which driver ran)
        self.decode_info: dict = {}
        self._cursor = 0
        self._probe()

    def _cfg(self) -> DecodeConfig:
        return self.config if self.config is not None else default_config()

    # -- probing (dvda_open_track_reader, dvd-audio.c:597-657) -------------

    def _probe(self) -> None:
        span = self.track.span
        first_batch = self.aob.read_sectors(span.first_sector, 1)
        if first_batch.shape[0] == 0:
            raise DvdaError("track starts past end of AOB space")
        pkt = next(demux_audio_packets(first_batch, span.first_sector), None)
        if pkt is None:
            # scan forward for the first audio packet (degenerate discs)
            more = self.aob.read_sectors(span.first_sector, span.last_sector - span.first_sector + 1)
            for pkt in demux_audio_packets(more, span.first_sector):
                break
            if pkt is None:
                raise DvdaError("no audio packet found in track")
        r = BitReader(pkt.payload)
        codec_id, pad_2_size = read_audio_packet_header(r)
        if codec_id == PCM_CODEC_ID:
            self.codec = "PCM"
            params, _, _ = pcm_codec.parse_pcm_params(r)
            self.parameters = params
        elif codec_id == MLP_CODEC_ID:
            self.codec = "MLP"
            from .codecs.mlp import probe as mlp_probe

            self.parameters = mlp_probe.probe_parameters(self.aob, self.track.span)
        else:
            raise DvdaError(f"unknown codec id {codec_id:#x}")

    # -- stream attributes (dvd-audio.c:665-749) ----------------------------

    @property
    def bits_per_sample(self) -> int:
        return self.parameters.bits_per_sample

    @property
    def sample_rate(self) -> int:
        return self.parameters.sample_rate

    @property
    def channel_count(self) -> int:
        return self.parameters.channel_count

    @property
    def channel_mask(self) -> int:
        return self.parameters.channel_mask

    # -- batched decode ----------------------------------------------------

    def _decode(self, want_packed: bool) -> np.ndarray:
        return decode_mlp_track(self.aob, self.track.span, self.parameters,
                                want_packed=want_packed, config=self._cfg(),
                                info=self.decode_info)

    @cached_property
    def _decoded(self) -> np.ndarray:
        """Full-track decode: int32 [frames, channels] in RIFF WAVE order.
        PCM: the packet walk of :meth:`_decode_pcm` (the native demux, or
        the Python loop without ``use_native_demux``), then
        :meth:`_pcm_on_device`."""
        if self.codec == "PCM":
            return self._decode_pcm()
        return self._decode(want_packed=False)

    def _decode_pcm(self) -> np.ndarray:
        """Batch PCM decode.

        Mirrors decode_pcm_audio's termination (dvd-audio.c:1016-1082):
        packets are consumed while the PTS-derived frame countdown is
        positive and parameters/codec match; all frames of consumed packets
        are emitted.  The PCM path ignores the track's last sector — the
        countdown is the terminator — so packets are pulled sector-batch by
        sector-batch until satisfied.
        """
        span = self.track.span
        # total frames from PTS length (open_pcm_track_reader, :976-979)
        total = round(span.pts_length * self.parameters.sample_rate / PTS_PER_SECOND)
        bps = self.parameters.bits_per_sample
        ch = self.parameters.channel_count
        csize = pcm_codec.chunk_size(bps, ch)
        cfg = self._cfg()
        if cfg.use_native_demux:
            # native packet walk (host/src/demux.cc); the loop below is its
            # executable specification and differential-test oracle
            chunks = self._pcm_walk()
            if chunks is not None:
                return self._pcm_on_device(chunks, bps, ch, 0)
        chunk_arrays: list[np.ndarray] = []
        remaining = total
        sector = span.first_sector
        BATCH = cfg.io_batch_sectors  # sectors per host I/O batch
        done = False
        while not done:
            sectors = self.aob.read_sectors(sector, BATCH)
            if sectors.shape[0] == 0:
                break
            for pkt in demux_audio_packets(sectors, sector):
                if pkt is None:
                    done = True
                    break
                r = BitReader(pkt.payload)
                try:
                    codec_id, pad_2_size = read_audio_packet_header(r)
                    if codec_id != PCM_CODEC_ID:
                        done = True
                        break
                    params, _, _ = pcm_codec.parse_pcm_params(r)
                    if params != self.parameters:
                        done = True
                        break
                    r.skip_bytes(pad_2_size - 9)
                except BitstreamError:
                    done = True
                    break
                payload = r.read_bytes(r.size())
                chunks = pcm_codec.payload_to_chunks(payload, bps, ch)
                chunk_arrays.append(chunks)
                remaining -= min(chunks.shape[0] * 2, remaining)
                if remaining == 0:
                    done = True
                    break
            else:
                if sectors.shape[0] < BATCH:
                    break
            sector += sectors.shape[0]
        if not chunk_arrays:
            return np.zeros((0, ch), dtype=np.int32)
        return self._pcm_on_device(
            np.concatenate(chunk_arrays, axis=0), bps, ch, 0)

    def _pcm_on_device(self, chunks: torch.Tensor | np.ndarray, bps: int,
                       ch: int, nbytes: int) -> np.ndarray:
        """K8 over a host chunk batch on the decode device, then one d2h.
        A tensor is the native walk's own buffer (:meth:`_pcm_walk`,
        pinned on CUDA): the h2d reads it in place.  An array, the Python
        loop's, is staged: copied into pinned memory on CUDA, into a fresh
        tensor on the CPU.  On CUDA, packed output that fits its pinned
        source (:func:`_output_fits`) is read back over that source and
        returned as a view of it; int32 samples go to fresh memory."""
        dev = self._cfg().resolved_device()
        walks = TrackReader._pcm_on_device
        with global_timer.stage("pcm/unpack"):
            if isinstance(chunks, torch.Tensor):
                walks.pcm_walks_in_place += 1
                src = chunks
            elif dev.type == "cuda":
                walks.pcm_walks_staged += 1
                src = torch.empty(chunks.shape, dtype=torch.uint8,
                                  pin_memory=True)
                src.numpy()[...] = chunks
            else:
                walks.pcm_walks_staged += 1
                src = torch.from_numpy(np.array(chunks, np.uint8))
            out = decode_chunks_device(src.to(dev, non_blocking=True), bps,
                                       ch, nbytes)
            if dev.type != "cuda":
                return out.numpy()
            if src.is_pinned() and _output_fits(src, ch, nbytes):
                walks.pcm_readbacks_pinned += 1
                # the h2d, K8 and this d2h run in order on one stream, so
                # K8's output may overwrite the bytes it was read from
                src.view(-1).copy_(out.view(-1), non_blocking=True)
                torch.cuda.current_stream(dev).synchronize()
                return src.view(out.shape).numpy()
            walks.pcm_readbacks_pageable += 1
            return out.cpu().numpy()

    def _pcm_walk(self) -> torch.Tensor | None:
        """The native packet walk (host/src/demux.cc) over the track:
        uint8 ``[n, csize]``, every whole chunk of the consumed packets,
        each written once, at its final offset, into one buffer sized up
        front (``host.pcm_walk_capacity``).  The buffer is pinned when
        the decode device is CUDA, so K8's h2d uploads straight from it.
        None when the native library is unavailable."""
        span = self.track.span
        params = self.parameters
        csize = pcm_codec.chunk_size(params.bits_per_sample,
                                     params.channel_count)
        total = round(span.pts_length * params.sample_rate / PTS_PER_SECOND)
        pinned = self._cfg().resolved_device().type == "cuda"
        with global_timer.stage("pcm/assemble"):
            buf = torch.empty(
                host.pcm_walk_capacity(self.aob, span.first_sector, total,
                                       csize),
                dtype=torch.uint8, pin_memory=pinned)
            n = host.walk_pcm_chunks(self.aob, span.first_sector, params,
                                     total, csize, buf.numpy())
        if n is None:
            return None
        return buf[:n].view(n // csize, csize)

    def _pcm_chunks(self) -> torch.Tensor | None:
        """The PCM track's chunk batch of :meth:`_pcm_walk`, the native
        walk's own buffer.  None when the native walk is unavailable or
        gives no whole chunk."""
        chunks = self._pcm_walk()
        return chunks if chunks is not None and chunks.shape[0] else None

    def _pcm_packed(self) -> bytes | None:
        """PCM disc-to-WAV: the chunks of :meth:`_pcm_chunks`, with K8
        writing the WAV payload in place of ``host.pcm_repack``.  None when
        the native walk is off or gives no chunks."""
        if not self._cfg().use_native_demux:
            return None
        chunks = self._pcm_chunks()
        if chunks is None:
            return None
        bps = self.bits_per_sample
        out = self._pcm_on_device(chunks, bps, self.channel_count, bps // 8)
        self._cursor = self._packed_frames = 2 * chunks.shape[0]
        with global_timer.stage("reader/bytes"):
            return out.tobytes()

    # -- pull API (dvda_read, dvd-audio.c:751-795) --------------------------

    def read(self, pcm_frames: int) -> np.ndarray:
        """Return up to ``pcm_frames`` interleaved frames ([n, channels]).

        On MLP tracks of the native path the pull API is segment-backed:
        only the manifest segment(s) covering the cursor are decoded (one
        stays cached), so sequential pulls and seek + read through a
        multi-hour track run in bounded memory with no prefix replay — the
        reference must decode from the track start.  Once a whole-track
        decode has been made (``read_all``), reads serve from it."""
        if pcm_frames <= 0:
            return np.zeros((0, self.channel_count), dtype=np.int32)
        if "_decoded" not in self.__dict__:
            seg = self._segment_reader()
            if seg is not None:
                out = self._pull_segments(seg, self._cursor,
                                          self._cursor + pcm_frames)
                self._cursor += out.shape[0]
                return out
        data = self._decoded
        out = data[self._cursor : self._cursor + pcm_frames]
        self._cursor += out.shape[0]
        return out

    def _pull_segments(self, seg, pos: int, end: int) -> np.ndarray:
        """Frames [pos, end) via the segment reader (clamped to the
        track; truncates at a corrupt-short segment)."""
        parts = []
        end = min(seg.total_pcm, end)
        while pos < end:
            start, arr = seg.segment(seg.segment_index(pos))
            take = arr[pos - start : end - start]
            if take.shape[0] == 0:
                break  # corrupt-short segment: truncate here
            parts.append(take)
            pos += take.shape[0]
        if not parts:
            return np.zeros((0, self.channel_count), dtype=np.int32)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _segment_reader(self):
        """Cached MlpSegmentReader (None on a PCM track, with
        ``use_native`` off — the Python engines everywhere, as dvda_tpu's
        ``use_device=False`` — or where the track's parse bails)."""
        got = getattr(self, "_seg_reader", None)
        if got is None:
            got = False
            if self.codec == "MLP" and self._cfg().use_native:
                got = open_mlp_segment_reader(
                    self.aob, self.track.span, self.parameters,
                    30 * self.sample_rate, config=self._cfg()) or False
            self._seg_reader = got
        return got or None

    def read_all(self) -> np.ndarray:
        data = self._decoded
        out = data[self._cursor :]
        self._cursor = data.shape[0]
        return out

    def read_all_packed(self) -> bytes:
        """Whole track as little-endian WAV data bytes.  On 16/24-bit
        streams the card packs the bytes itself (K234 for MLP, K8 for
        PCM)."""
        if (self.bits_per_sample in (16, 24)
                and "_decoded" not in self.__dict__ and self._cursor == 0):
            if self.codec == "PCM":
                out = self._pcm_packed()
                if out is not None:
                    return out
            else:
                out = self._decode(want_packed=True)
                if out.dtype == np.uint8:
                    self._cursor = self._packed_frames = out.shape[0]
                    with global_timer.stage("reader/bytes"):
                        return out.tobytes()
                self.__dict__["_decoded"] = out  # general path, or empty
        return pack_samples_le(self.read_all(), self.bits_per_sample)

    def iter_packed(self, segment_pcm_frames: int | None = None):
        """Stream the track's WAV payload as an iterator of bytes-like
        chunks whose concatenation equals ``read_all_packed()``.

        MLP tracks decode segment by segment from manifest resume points
        (:func:`~dvda_tpu_torch.codecs.mlp.track.iter_mlp_packed_segments`):
        peak memory is the assembled MLP byte stream plus ONE segment's
        working set, instead of whole-track arenas — the way to convert a
        multi-hour track in bounded memory.  ``segment_pcm_frames``
        defaults to 30 seconds.  Tracks without mid-stream resume points,
        PCM tracks and ``use_native=False`` give a single chunk.  Does not
        move the pull cursor."""
        if segment_pcm_frames is None:
            segment_pcm_frames = 30 * self.sample_rate
        if self.codec == "MLP" and "_decoded" not in self.__dict__:
            it = iter_mlp_packed_segments(self.aob, self.track.span,
                                          self.parameters,
                                          int(segment_pcm_frames),
                                          config=self._cfg())
            if it is not None:
                return it

        def whole():
            cursor = self._cursor
            try:
                self._cursor = 0
                data = self.read_all_packed()
            finally:
                self._cursor = cursor
            yield data

        return whole()

    def read_range(self, start_frame: int, pcm_frames: int) -> np.ndarray:
        """Decode only ``[start_frame, start_frame + pcm_frames)``.

        On an MLP track of the native path this decodes only the manifest
        segment(s) covering the range (the segment reader behind
        :meth:`read`), clamped to the track: neither the prefix nor the
        suffix is decoded.  Everywhere else it slices the whole-track
        decode, where a negative start counts from the end.  Does not move
        the cursor."""
        seg = (None if "_decoded" in self.__dict__
               else self._segment_reader())
        if seg is not None:
            return self._pull_segments(seg, max(0, start_frame),
                                       start_frame + pcm_frames)
        return self._decoded[start_frame : start_frame + pcm_frames]

    @property
    def manifest(self):
        """Resume manifest of an MLP track (None for PCM, or where the
        track's parse bails): the frames where decode can start
        bit-exactly (major sync + clean restart), with byte and PCM
        offsets."""
        if self.codec != "MLP":
            return None
        return track_manifest(self.aob, self.track.span, self._cfg())

    # -- random access (beyond the reference API) ---------------------------

    def seek(self, pcm_frame: int) -> int:
        """Seek to an absolute PCM frame within the track; returns the
        actual (clamped) position.  On segment-backed MLP readers this
        clamps against the manifest total without decoding anything."""
        seg = (None if "_decoded" in self.__dict__
               else self._segment_reader())
        total = seg.total_pcm if seg else self._decoded.shape[0]
        self._cursor = min(max(0, pcm_frame), total)
        return self._cursor

    def tell(self) -> int:
        return self._cursor

    @property
    def total_pcm_frames(self) -> int:
        if "_decoded" not in self.__dict__:
            if getattr(self, "_packed_frames", None) is not None:
                return self._packed_frames  # known from read_all_packed
            seg = self._segment_reader()
            if seg is not None:  # the manifest total, no decode needed
                return seg.total_pcm
        return self._decoded.shape[0]

    def close(self) -> None:
        self.aob.close()


#: PCM decodes since the last reset whose chunks K8 read from the native
#: walk's own buffer, and those that went through a staging copy
TrackReader._pcm_on_device.pcm_walks_in_place = 0
TrackReader._pcm_on_device.pcm_walks_staged = 0
#: PCM decodes on CUDA since the last reset whose output was read back
#: into their pinned source, and those read back into fresh pageable memory
TrackReader._pcm_on_device.pcm_readbacks_pinned = 0
TrackReader._pcm_on_device.pcm_readbacks_pageable = 0


def _output_fits(chunks: torch.Tensor, ch: int, nbytes: int) -> bool:
    """Whether K8's packed output, uint8 ``[2n, ch * nbytes]``, has the
    bytes of its source ``chunks`` ``[n, chunk_size]``: so at 16 and 24
    bits, and never for int32 samples (``nbytes`` 0)."""
    n, csize = chunks.shape
    return nbytes > 0 and 2 * n * ch * nbytes == n * csize


def open_disc(audio_ts_path: str | os.PathLike, device: str | None = None,
              config: DecodeConfig | None = None) -> DVDA:
    """Open a disc.  ``device``: the optical drive node for CPPM, as in
    dvda_tpu; the torch device of the decode is ``config.device``."""
    return DVDA(audio_ts_path, device, config=config)
