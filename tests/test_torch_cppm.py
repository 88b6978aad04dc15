"""The port's CPPM path on the CPU against dvda_tpu, bit-exact: the plain
C2 D-CBC and content keys against dvda_tpu/ops/c2_decrypt.py (jitted on
the CPU), kernel K7's plain version against dvda_tpu's host decryptor,
the vectorised test encryptor against the scalar one, and encrypted discs
through the port's reader, ``open_disc(path, device=<drive>)`` and
``decode_disc``; an encrypted MLP track through the native assembler in
short batches."""

import os

import numpy as np
import pytest
import torch

from dvda_tpu import host
from dvda_tpu.api import DVDA as JaxDVDA
from dvda_tpu.container.aob import AOBReader
from dvda_tpu.cppm.c2 import c2_enc
from dvda_tpu.cppm.decrypt import COPYRIGHT_CPPM
from dvda_tpu.cppm.decrypt import CppmDecryptor as JaxDecryptor
from dvda_tpu.cppm.decrypt import encrypt_sectors
from dvda_tpu.cppm.mkb import DEVICE_KEYS
from dvda_tpu.ops.c2_decrypt import content_keys_device as jax_keys
from dvda_tpu.ops.c2_decrypt import dcbc_dec_device as jax_dcbc
from dvda_tpu_torch import DecodeConfig, open_disc
from dvda_tpu_torch.api import TrackReader
from dvda_tpu_torch import host as torch_host
from dvda_tpu_torch.batch import decode_disc
from dvda_tpu_torch.codecs.mlp.native_engine import decode_native
from dvda_tpu_torch.container.aob import AOBReader as TorchAOBReader
from dvda_tpu_torch.cppm import css
from dvda_tpu_torch.cppm.decrypt import CppmDecryptor
from dvda_tpu_torch.ops.c2_decrypt import (content_keys_device,
                                           dcbc_dec_device,
                                           decrypt_sectors_device,
                                           decrypt_sectors_reference)
from dvda_tpu_torch.testutil import (MlpSynthConfig, MlpTrackSpec,
                                     PcmTrackSpec, build_disc,
                                     cppm_sector_mix, encrypt_sectors_batch,
                                     synth_mlp_stream)

torch.set_num_threads(1)

MEDIA_KEY, ALBUM = 0x00DEADBEEF001122, 0x0F0E0D0C0B0A0908
CPU = DecodeConfig(device="cpu")
native = pytest.mark.skipif(not host.available(),
                            reason="native host library unavailable")


def _disc(tmp_path, name="AUDIO_TS"):
    """PCM 5.1/96k/24 and a uniform MLP 5.1/96k/24 track in one title."""
    mlp = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         sample_rate=96000, n_frames=20, seed=6,
                         fir_across_restart=False, params_update_prob=0.0)
    return build_disc(str(tmp_path / name), [[
        PcmTrackSpec(pcm_frames=960, seed=8, sample_rate=96000,
                     bits_per_sample=24, channel_assignment=17),
        MlpTrackSpec(mlp_stream=synth_mlp_stream(mlp),
                     pcm_frames=mlp.total_pcm_frames, sample_rate=96000,
                     channel_assignment=17)]])


def _sectors(tmp_path):
    layout = _disc(tmp_path, "SRC")
    return AOBReader(layout.path, 1).read_sectors(0, 12).copy()


def test_encrypt_sectors_batch_matches_scalar(tmp_path):
    sectors = _sectors(tmp_path)[:8]
    sectors[3, :4] = (0x47, 0, 0, 0)  # one sector that is not a pack
    got = encrypt_sectors_batch(sectors, MEDIA_KEY, ALBUM)
    assert np.array_equal(got, encrypt_sectors(sectors, MEDIA_KEY, ALBUM))
    assert not np.array_equal(got, sectors)
    assert np.array_equal(got[3], sectors[3])


def _words_fields(enc):
    """dvda_tpu's ``_decrypt_device`` inputs: big-endian hi/lo words of the
    encrypted span and of the five key fields."""
    be = enc.view(">u4").astype(np.uint32)            # [N, 512]
    words = be[:, 32:].reshape(-1, 240, 2)
    fields = np.stack([be[:, o // 4 : o // 4 + 2] for o in
                       (24, 32, 40, 48)] + [np.stack(
                           [enc[:, 84:88].copy().view(">u4")[:, 0],
                            enc[:, 88:92].copy().view(">u4")[:, 0]], 1)
                           .astype(np.uint32)], 1)
    return words, fields


def test_cipher_matches_jax(tmp_path):
    """The plain C2 of the port against dvda_tpu/ops/c2_decrypt.py on the
    same words and fields (as tests/test_batch.py:47-61)."""
    enc = encrypt_sectors_batch(_sectors(tmp_path)[:4], 0x00A5A5A5A5A5A5A5,
                                ALBUM)
    words, fields = _words_fields(enc)
    k_au = JaxDecryptor(0x00A5A5A5A5A5A5A5, ALBUM).k_au
    kau = np.array([k_au >> 32, k_au & 0xFFFFFFFF], np.uint32)
    want_hi, want_lo = jax_keys(fields, kau[0], kau[1])
    got_hi, got_lo = content_keys_device(torch.from_numpy(fields),
                                         int(kau[0]), int(kau[1]))
    assert np.array_equal(got_hi.numpy(), np.asarray(want_hi))
    assert np.array_equal(got_lo.numpy(), np.asarray(want_lo))
    want = np.asarray(jax_dcbc(words, fields, kau))
    got = dcbc_dec_device(torch.from_numpy(words), torch.from_numpy(fields),
                          torch.from_numpy(kau))
    assert np.array_equal(got.numpy(), want)


@native
@pytest.mark.parametrize("preserve_cci", [False, True])
def test_decrypt_reference_matches_jax(tmp_path, preserve_cci):
    """Non-pack, clear and scrambled sectors, CCI walks to the sector's
    end: K7's plain version against dvda_tpu's host decryptor."""
    plain, enc = cppm_sector_mix(_sectors(tmp_path), MEDIA_KEY, ALBUM)
    want = JaxDecryptor(MEDIA_KEY, ALBUM, preserve_cci=preserve_cci,
                        use_device=False).decrypt_sectors(enc)
    k_au = JaxDecryptor(MEDIA_KEY, ALBUM).k_au
    got = decrypt_sectors_reference(torch.from_numpy(enc), k_au,
                                    preserve_cci)
    assert np.array_equal(got.numpy(), want)
    if preserve_cci:
        assert np.array_equal(want, plain)
    else:
        assert (want != plain).any()
    # the wrapper on a CPU tensor: the same, in place
    t = torch.from_numpy(enc.copy())
    assert decrypt_sectors_device(t, k_au, preserve_cci) is t
    assert np.array_equal(t.numpy(), want)
    assert decrypt_sectors_device.launches == 0


@native
def test_decrypt_wrong_key(tmp_path):
    plain, enc = cppm_sector_mix(_sectors(tmp_path), MEDIA_KEY, ALBUM)
    bad = JaxDecryptor(MEDIA_KEY ^ 1, ALBUM).k_au
    got = decrypt_sectors_reference(torch.from_numpy(enc), bad, True).numpy()
    want = JaxDecryptor(MEDIA_KEY ^ 1, ALBUM, preserve_cci=True,
                        use_device=False).decrypt_sectors(enc)
    assert np.array_equal(got, want) and not np.array_equal(got, plain)


def test_decryptor_port(tmp_path):
    """The port's decryptor: dvda_tpu's key derivation, the port's
    decrypt path, an empty batch, and no CUDA fallback."""
    plain, enc = cppm_sector_mix(_sectors(tmp_path), MEDIA_KEY, ALBUM)
    dec = CppmDecryptor(MEDIA_KEY, ALBUM, preserve_cci=True, config=CPU)
    assert dec.k_au == JaxDecryptor(MEDIA_KEY, ALBUM).k_au
    out = dec.decrypt_sectors(enc)
    assert np.array_equal(out, plain) and not np.array_equal(enc, plain)
    assert dec.decrypt_sectors(enc[:0]).shape == (0, 2048)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CppmDecryptor(MEDIA_KEY, ALBUM, config=DecodeConfig(
            device="cuda")).decrypt_sectors(enc)


def _encrypt_aob(layout):
    path = os.path.join(layout.path, "ATS_01_1.AOB")
    raw = np.fromfile(path, dtype=np.uint8).reshape(-1, 2048)
    encrypt_sectors_batch(raw, MEDIA_KEY, ALBUM).tofile(path)


@native
def test_encrypted_disc_decodes(tmp_path):
    """An encrypted PCM + MLP disc through ``AOBReader(decrypt=...)`` and
    the port's reader equals the plaintext decode (as
    tests/test_cppm.py:165-196, :265-296)."""
    layout = _disc(tmp_path)
    title = JaxDVDA(layout.path).open_titleset(1).open_title(1)
    plain = [title.open_track(n).open_reader(use_device=False).read_all()
             for n in (1, 2)]
    plain_packed = [title.open_track(n).open_reader(use_device=False)
                    .read_all_packed() for n in (1, 2)]
    _encrypt_aob(layout)
    track = open_disc(layout.path, config=CPU).open_titleset(1) \
        .open_title(1)
    dec = CppmDecryptor(MEDIA_KEY, ALBUM, config=CPU)
    for n in (1, 2):
        t = track.open_track(n)
        r = TrackReader(AOBReader(layout.path, 1, decrypt=dec.decrypt_sectors),
                        t, config=CPU)
        assert r.codec == ("PCM", "MLP")[n - 1]
        assert np.array_equal(r.read_all(), plain[n - 1])
        r = TrackReader(AOBReader(layout.path, 1, decrypt=dec.decrypt_sectors),
                        t, config=CPU)
        assert r.read_all_packed() == bytes(plain_packed[n - 1])


@native
def test_encrypted_mlp_assembly_in_batches(tmp_path):
    """An encrypted MLP track through ``host.assemble_mlp_stream`` in
    batches of 8 sectors (four whole and a short tail): the hook runs once
    for each batch the assembler reads, the stream, boundaries and probe
    length equal the plain disc's, and its decode equals dvda_tpu's plain
    one.  The benchmark's ``cppm_kernel_roofline`` on an encrypted MLP
    album counts this batching."""
    mlp = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         sample_rate=96000, n_frames=320, seed=6,
                         fir_across_restart=False, params_update_prob=0.0)
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [[MlpTrackSpec(
        mlp_stream=synth_mlp_stream(mlp), pcm_frames=mlp.total_pcm_frames,
        sample_rate=96000, channel_assignment=17)]])
    want = JaxDVDA(layout.path).open_titleset(1).open_title(1).open_track(
        1).open_reader(use_device=False).read_all_packed()
    track = open_disc(layout.path, config=CPU).open_titleset(1) \
        .open_title(1).open_track(1)
    first, last = track.span.first_sector, track.span.last_sector
    plain = torch_host.assemble_mlp_stream(
        TorchAOBReader(layout.path, 1), first, last, batch=8)
    _encrypt_aob(layout)
    dec = CppmDecryptor(MEDIA_KEY, ALBUM, config=CPU)
    hooked = []

    def hook(sectors):
        hooked.append(sectors.shape[0])
        return dec.decrypt_sectors(sectors)

    aob = TorchAOBReader(layout.path, 1, decrypt=hook)
    read, reads = aob.read_sectors, []

    def counted(first, count):
        out = read(first, count)
        reads.append(out.shape[0])
        return out

    aob.read_sectors = counted
    stream, bounds, probe_end = torch_host.assemble_mlp_stream(
        aob, first, last, batch=8)
    assert stream == plain[0] and probe_end == plain[2]
    assert np.array_equal(bounds, plain[1])
    assert hooked == [n for n in reads if n] == [8, 8, 8, 8, 2]
    params = TrackReader(TorchAOBReader(layout.path, 1,
                                        decrypt=dec.decrypt_sectors),
                         track, config=CPU).parameters
    out = decode_native(stream, bounds, probe_end, params, want_packed=True,
                        config=CPU)
    assert out.tobytes() == bytes(want)


class _Drive(css.MockDrive):
    def close(self):
        pass


def _write_mkb(path, media_key):
    """A minimal MKB for device key (col 0, row 0x0375) with a verify
    record (the construction of tests/test_cppm.py)."""
    dk = next(k for k in DEVICE_KEYS if k.col == 0 and k.row == 0x0375)
    verification = c2_enc(0xDEADBEEF00000000 | 0x12345678, media_key)

    def record(rtype, payload):
        return bytes([rtype]) + (4 + len(payload)).to_bytes(3, "big") \
            + payload

    f = (dk.col << 32) | dk.row
    entry = c2_enc((media_key ^ f) & 0x00FFFFFFFFFFFFFF, dk.key)
    table = bytearray((dk.row + 1) * 8)
    table[dk.row * 8 : dk.row * 8 + 8] = entry.to_bytes(8, "big")
    body = (record(0x81, verification.to_bytes(8, "big"))
            + record(0x01, bytes([0, 0, 0, 0, dk.col, 0, 0, 1])
                     + bytes(table))
            + record(0x02, b""))
    with open(path, "wb") as fh:
        fh.write(b"DVDAUDIO.MKB" + len(body).to_bytes(4, "big") + body)


@native
def test_open_disc_drive_installs_hook(tmp_path, monkeypatch):
    """``open_disc(path, device=<drive node>)``: the drive reports CPPM,
    the handshake gives the album ID and the MKB the media key, and the
    reader decrypts (dvda_tpu's rule; the drive is the port's copy of
    MockDrive behind its patched drive opener, as in
    tests/test_cppm.py:231-262).
    Without a drive, or with ``decrypt=False``, the sectors are read as
    they are, as in dvda_tpu."""
    layout = _disc(tmp_path)
    title = JaxDVDA(layout.path).open_titleset(1).open_title(1)
    plain = [title.open_track(n).open_reader(use_device=False)
             .read_all_packed() for n in (1, 2)]
    _encrypt_aob(layout)
    _write_mkb(os.path.join(layout.path, "DVDAUDIO.MKB"), MEDIA_KEY)
    block = bytearray(2048)
    block[80:88] = ALBUM.to_bytes(8, "big")
    opened = []

    def drive(node):
        opened.append(node)
        return _Drive(variant=9, disc_key_block=bytes(block),
                      copyright_protection=COPYRIGHT_CPPM)

    monkeypatch.setattr(css, "LinuxDrive", drive)
    disc = open_disc(layout.path, device="/dev/sr0", config=CPU)
    assert disc.device == "/dev/sr0"
    for n in (1, 2):
        r = disc.open_titleset(1).open_title(1).open_track(n).open_reader()
        assert r.aob._decrypt is not None
        assert r.read_all_packed() == bytes(plain[n - 1])
    assert opened == ["/dev/sr0", "/dev/sr0"]
    # the PCM track's ciphertext decodes to other bytes, as in dvda_tpu
    raw = open_disc(layout.path, config=CPU).open_titleset(1).open_title(1) \
        .open_track(1).open_reader()
    assert raw.aob._decrypt is None
    assert raw.read_all_packed() != bytes(plain[0])
    off = open_disc(layout.path, device="/dev/sr0",
                    config=DecodeConfig(device="cpu", decrypt=False))
    r = off.open_titleset(1).open_title(1).open_track(1).open_reader()
    assert r.aob._decrypt is None and len(opened) == 2


@native
def test_decode_disc_decrypts(tmp_path, monkeypatch):
    layout = _disc(tmp_path)
    want = [bytes(r.wav_data()) for r in decode_disc(
        layout.path, config=CPU, packed=True)]
    _encrypt_aob(layout)
    _write_mkb(os.path.join(layout.path, "DVDAUDIO.MKB"), MEDIA_KEY)
    block = bytearray(2048)
    block[80:88] = ALBUM.to_bytes(8, "big")
    monkeypatch.setattr(css, "LinuxDrive", lambda node: _Drive(
        variant=3, disc_key_block=bytes(block)))
    got = [r.wav_data() for r in decode_disc(layout.path, "/dev/sr0",
                                             config=CPU, packed=True)]
    assert got == want
