"""The comparison that decides ``correct`` fails what it should (CPU,
small albums): the control (the reference at 16 of its 24 bits in the
program's place), and runs with the program's timed path broken
underneath it, each fault a cell can have: an answer altered where it is
produced, and half of the work left out."""

from __future__ import annotations

import pytest

from benchmark.control import control_readers
from benchmark.tests.small import run_small

CELLS = ["mlp51_96k24.rip", "pcm20_192k24_cppm.rip", "mlp51_96k24.seek"]


#: an encrypted MLP album (one track, so that a short window checks it
#: whole): the CPPM hook in front of the MLP path
ENCRYPTED_MLP = {"encrypted": True, "key_source": "seed", "tracks": 1}


@pytest.mark.parametrize("cell,config", [pytest.param(c, {}, id=c)
                                         for c in CELLS] + [
    pytest.param("mlp51_96k24.rip", ENCRYPTED_MLP,
                 id="mlp51_96k24.rip-encrypted")])
def test_sound_runs_are_correct(cell, config):
    r = run_small(cell, seconds=0.5 if config else 4.0, **config)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    with control_readers():
        r = run_small(cell)
    assert not r["correct"]
    wrong = r["checks"].get("bytes_wrong", r["checks"].get("samples_wrong"))
    assert wrong["value"] > wrong["limit"]


def _flip_packed(orig):
    def read_all_packed(self):
        data = bytearray(orig(self))
        data[len(data) // 3] ^= 0x01
        return bytes(data)
    return read_all_packed


def _half_packed(orig):
    def read_all_packed(self):
        data = orig(self)
        return data[: len(data) // 2]
    return read_all_packed


def _flip_read(orig):
    def read(self, n):
        out = orig(self, n).copy()
        out[out.shape[0] // 2, 0] ^= 1
        return out
    return read


def _half_read(orig):
    def read(self, n):
        out = orig(self, n)
        return out[: out.shape[0] // 2]
    return read


@pytest.mark.parametrize("cell,method,fault", [
    ("mlp51_96k24.rip", "read_all_packed", _flip_packed),
    ("mlp51_96k24.rip", "read_all_packed", _half_packed),
    ("pcm20_192k24_cppm.rip", "read_all_packed", _flip_packed),
    ("pcm20_192k24_cppm.rip", "read_all_packed", _half_packed),
    ("mlp51_96k24.seek", "read", _flip_read),
    ("mlp51_96k24.seek", "read", _half_read)])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, method, fault):
    from dvda_tpu_torch.api import TrackReader

    monkeypatch.setattr(TrackReader, method,
                        fault(getattr(TrackReader, method)))
    r = run_small(cell)
    assert not r["correct"]


def test_a_decode_that_raises_is_counted(monkeypatch):
    from dvda_tpu_torch.api import TrackReader

    orig = TrackReader.read_all_packed
    calls = []

    def boom(self):  # the warm-up's pass over the two tracks passes,
        calls.append(1)  # every later decode raises
        if len(calls) > 2:
            raise RuntimeError("injected")
        return orig(self)

    monkeypatch.setattr(TrackReader, "read_all_packed", boom)
    r = run_small("pcm20_192k24_cppm.rip", seconds=0.5)
    assert not r["correct"] and r["failed"] == r["attempted"] > 0


def test_an_encrypted_mlp_rip_with_a_sector_altered_is_not_correct(
        monkeypatch):
    from dvda_tpu_torch.cppm.decrypt import CppmDecryptor

    orig = CppmDecryptor.decrypt_sectors

    def altered(self, sectors):  # one payload byte of each batch
        out = orig(self, sectors)
        out[out.shape[0] // 2, 1024] ^= 0x40
        return out

    monkeypatch.setattr(CppmDecryptor, "decrypt_sectors", altered)
    r = run_small("mlp51_96k24.rip", seconds=0.5, **ENCRYPTED_MLP)
    assert not r["correct"]
