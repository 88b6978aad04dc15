"""The benchmark's disc generator and reference, on the CPU."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from benchmark.fmt.params import StreamParameters
from benchmark.gen import disc
from benchmark.gen.c2 import encrypt_sectors
from benchmark.harness import ROOT
from benchmark.reference.expected import mlp_reference, pcm_wav
from benchmark.reference.mlp_spec import MlpDecoder
from benchmark.tests.small import SMALL


def _config(name: str, **over) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg.update(over)
    return cfg


def _aob(path: str) -> bytes:
    with open(os.path.join(path, "ATS_01_1.AOB"), "rb") as f:
        return f.read()


#: the configurations' albums, and the MLP configuration encrypted
ENCRYPTED = {"encrypted": True, "key_source": "seed"}
ALBUMS = [pytest.param("mlp51_96k24", "mlp", {}, id="mlp51_96k24"),
          pytest.param("pcm20_192k24_cppm", "pcm", {},
                       id="pcm20_192k24_cppm"),
          pytest.param("mlp51_96k24", "mlp", ENCRYPTED,
                       id="mlp51_96k24-encrypted")]


@pytest.mark.parametrize("name,kind,over", ALBUMS)
def test_album_is_a_function_of_the_seed(tmp_path, name, kind, over):
    cfg = _config(name, **SMALL[kind], **over)
    a = disc.make_album(cfg, 7, str(tmp_path / "a"), str(tmp_path / "c"))
    b = disc.make_album(cfg, 7, str(tmp_path / "b"), str(tmp_path / "c"))
    c = disc.make_album(cfg, 8, str(tmp_path / "d"), str(tmp_path / "c"))
    assert _aob(a.audio_ts) == _aob(b.audio_ts)
    assert _aob(a.audio_ts) != _aob(c.audio_ts)
    assert len(_aob(a.audio_ts)) % disc.SECTOR == 0
    keys = [(x.media_key, x.album_id) for x in (a, b, c)]
    if cfg["encrypted"]:
        assert keys[0] == keys[1] != keys[2]
    else:
        assert keys == [(None, None)] * 3


def test_every_seed_gets_the_same_mlp_work(tmp_path):
    cfg = _config("mlp51_96k24", **SMALL["mlp"])
    sizes = {len(_aob(disc.make_album(cfg, s, str(tmp_path / str(s)),
                                      None).audio_ts)) for s in (1, 2, 3)}
    assert len(sizes) == 1


def test_cached_pool_equals_a_fresh_one(tmp_path):
    cfg = _config("mlp51_96k24", **SMALL["mlp"])
    fresh = disc.mlp_pool(cfg, str(tmp_path))
    cached = disc.mlp_pool(cfg, str(tmp_path))
    assert fresh == cached and len(fresh) == cfg["pool_units"]


def test_pool_laid_track_decodes_as_one_stream(tmp_path):
    cfg = _config("mlp51_96k24", **SMALL["mlp"])
    album = disc.make_album(cfg, 5, str(tmp_path / "a"), None)
    layout = album.tracks[0].layout[:24]
    ref = mlp_reference(album.pool, cfg)
    dec = MlpDecoder(StreamParameters(2, 0xF, 1, 0xF,
                                      cfg["channel_assignment"]))
    dec.decode_bytes(b"".join(album.pool[u] for u in layout))
    whole = dec.take_frames()
    per = disc.unit_frames(cfg)
    assert whole.shape == (24 * per, 6)
    np.testing.assert_array_equal(whole, ref.samples[layout].reshape(-1, 6))
    np.testing.assert_array_equal(
        ref.track_samples(layout, per + 5, 700), whole[per + 5: per + 705])


def test_loud_content_overflows_int16(tmp_path):
    cfg = _config("mlp51_96k24", **SMALL["mlp"])
    ref = mlp_reference(disc.mlp_pool(cfg, None), cfg)
    assert np.abs(ref.samples).max() > 32767


@pytest.mark.parametrize("total,fixed", [(2021 * 3 + 2018, 27),
                                         (2021 * 2 + 100, 27),
                                         (2021 * 4, 27)])
def test_sector_split_leaves_no_unfillable_gap(total, fixed):
    sizes = disc._split(total, disc.SECTOR - fixed, fixed=fixed)
    assert sum(sizes) == total
    for s in sizes:
        gap = disc.SECTOR - fixed - s
        assert gap == 0 or gap >= 6


@pytest.mark.parametrize("name,kind,over",
                         [a for a in ALBUMS if a.id != "mlp51_96k24"])
def test_encryption_is_undone_by_the_port(tmp_path, name, kind, over):
    from dvda_tpu_torch.config import DecodeConfig
    from dvda_tpu_torch.cppm.decrypt import CppmDecryptor

    cfg = _config(name, **SMALL[kind], **over)
    album = disc.make_album(cfg, 9, str(tmp_path / "a"), None)
    sec = np.frombuffer(_aob(album.audio_ts), np.uint8).reshape(-1, 2048)
    # the plain album of the same samples or layouts: the configuration
    # unencrypted
    plain = np.concatenate([
        disc._pcm_sectors(cfg, t.chunks) if kind == "pcm"
        else disc.mlp_track_sectors(album.pool, t.layout)
        for t in album.tracks])
    assert sec.shape == plain.shape
    assert (sec[:, 20] & 0x10).all()
    assert not np.array_equal(sec[:, 128:], plain[:, 128:])
    dec = CppmDecryptor(album.media_key, album.album_id,
                        config=DecodeConfig(device="cpu"))
    np.testing.assert_array_equal(dec.decrypt_sectors(sec)[:, 128:],
                                  plain[:, 128:])


def test_encryption_of_one_sector_twice_is_stable():
    rng = np.random.default_rng(1)
    sec = rng.integers(0, 256, (3, 2048), dtype=np.uint8)
    a = encrypt_sectors(torch.from_numpy(sec.copy()), 5, 6).numpy()
    b = encrypt_sectors(torch.from_numpy(sec.copy()), 5, 6).numpy()
    np.testing.assert_array_equal(a, b)


def test_pcm_reference_agrees_with_pcm_c_tables():
    from dvda_tpu_torch.codecs.pcm import decode_chunks_numpy

    cfg = _config("pcm20_192k24_cppm")
    rng = np.random.default_rng(2)
    chunks = rng.integers(0, 256, (50, 12), dtype=np.uint8)
    samples = decode_chunks_numpy(chunks, 24, 2)
    want = samples.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]
    np.testing.assert_array_equal(pcm_wav(chunks, cfg), want.reshape(-1))


#: SHA-256 of each configuration's AOB at ``SMALL``'s size and seed
#: 2147483999, as the generator wrote it before encrypted MLP albums
#: existed: the albums that could be written then stay byte for byte
PLAIN_DIGESTS = {
    "mlp51_96k24":
        "2eac3df47a71a2c01f6a1264672b5e2c29f7d860a556117de07bb0b3b5fb083a",
    "pcm20_192k24_cppm":
        "c827870bdd0f22c7518722a14843bc04738182508a9b39139f3d8c4d3464a078",
}


@pytest.mark.parametrize("name,kind", [("mlp51_96k24", "mlp"),
                                       ("pcm20_192k24_cppm", "pcm")])
def test_existing_albums_are_unchanged(tmp_path, name, kind):
    cfg = _config(name, **SMALL[kind])
    album = disc.make_album(cfg, 2147483999, str(tmp_path / "a"), None)
    digest = hashlib.sha256(_aob(album.audio_ts)).hexdigest()
    assert digest == PLAIN_DIGESTS[name]


def test_track_work_of_an_encrypted_mlp_album(tmp_path):
    from benchmark.drivers.base import AlbumDriver
    from benchmark.harness import RunContext
    from dvda_tpu_torch.config import DecodeConfig

    work = {}
    for encrypted in (False, True):
        cfg = _config("mlp51_96k24", **SMALL["mlp"],
                      **dict(ENCRYPTED, encrypted=encrypted))
        ctx = RunContext("fake", cfg, {}, 3, False,
                         str(tmp_path / str(encrypted)),
                         decode_config=DecodeConfig(device="cpu"))
        d = AlbumDriver(ctx, None)
        d.prepare()
        work[encrypted] = [d.track_work(n) for n in range(len(d.tracks))]
        sectors = len(_aob(d.audio_ts)) // 2048
    plain, enc = work[False], work[True]
    assert all(set(w) == {"mlp"} for w in plain)
    assert all(set(w) == {"mlp", "cppm"} for w in enc)
    assert [w["mlp"] for w in enc] == [w["mlp"] for w in plain]
    # every sector of the disc read and written once, by the C2 count
    from benchmark.roofline import cppm_ops_per_sector

    assert sum(w["cppm"]["bytes"] for w in enc) == 2 * 2048 * sectors
    assert sum(w["cppm"]["ops"] for w in enc) == (
        sectors * cppm_ops_per_sector())
