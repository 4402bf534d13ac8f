"""The port's ``fft``, ``signal`` and ``audio`` against the JAX package's on
the same seeded inputs: every ``fft`` name in the three norms with the
gradient of a real loss (complex inputs built from two real tensors,
complex outputs read through ``real`` / ``imag``), ``stft`` / ``istft``
in every mode, the window / mel / DCT helpers (bit-equal where both build
them in float64 numpy), the feature layers with input gradients, the
WAV backend and the synthetic datasets. Values and gradients within
chip_smoke's f32 gate (``assert_f32_gate``)."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp

from test_torch_parity_util import (arr, assert_f32_gate,  # noqa: F401
                                    cpu_place, run_both)

pytestmark = pytest.mark.usefixtures("cpu_place")

NORMS = ["backward", "ortho", "forward"]

# name -> (input shape, complex input, kwargs)
_FFT = {
    "fft": ((3, 8), True, dict(n=10, axis=-1)),
    "ifft": ((3, 8), True, dict(axis=0)),
    "rfft": ((3, 8), False, dict(n=6)),
    "irfft": ((3, 5), True, dict(n=8)),
    "hfft": ((3, 5), True, dict(n=8)),
    "ihfft": ((3, 8), False, {}),
    "fftn": ((2, 4, 6), True, dict(s=(4, 5), axes=(1, 2))),
    "ifftn": ((2, 4, 6), True, {}),
    "rfftn": ((2, 4, 6), False, dict(axes=(0, 2))),
    "irfftn": ((2, 4, 4), True, dict(s=(4, 6))),
    "fft2": ((2, 4, 6), True, {}),
    "ifft2": ((2, 4, 6), True, dict(s=(3, 6))),
    "rfft2": ((2, 4, 6), False, {}),
    "irfft2": ((2, 4, 4), True, {}),
    "hfftn": ((2, 4, 4), True, dict(s=(4, 6))),
    "hfft2": ((2, 4, 4), True, {}),
    "ihfftn": ((2, 4, 6), False, {}),
    "ihfft2": ((2, 4, 6), False, dict(s=(4, 6))),
}


def _split(pkg, out):
    if "complex" in out.dtype.name:
        return pkg.real(out), pkg.imag(out)
    return out


def _fft_fn(pkg, name, cplx, kw, norm):
    def f(*parts):
        x = pkg.complex(*parts) if cplx else parts[0]
        return _split(pkg, getattr(pkg.fft, name)(x, norm=norm, **kw))
    return f


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", sorted(_FFT))
def test_fft_names_match_jax_with_gradients(name, norm):
    shape, cplx, kw = _FFT[name]
    ins = [arr(*shape, seed=1)] + ([arr(*shape, seed=2)] if cplx else [])
    run_both(_fft_fn(jp, name, cplx, kw, norm),
             _fft_fn(tp, name, cplx, kw, norm), ins, gate=True)


@pytest.mark.parametrize("name,kw,cplx", [
    ("fft_c2c", dict(axes=(0, 1), forward=True), True),
    ("fft_c2c", dict(axes=(1,), forward=False, normalization="ortho"), True),
    ("fft_r2c", dict(axes=(0, 1), normalization="forward"), False),
    ("fft_c2r", dict(axes=(0, 1)), True),
    ("fft_c2r", dict(axes=(1,), last_dim_size=9), True)])
def test_kernel_level_fft_names(name, kw, cplx):
    ins = [arr(4, 5, seed=3)] + ([arr(4, 5, seed=4)] if cplx else [])

    def fn(pkg):
        def f(*parts):
            x = pkg.complex(*parts) if cplx else parts[0]
            return _split(pkg, getattr(pkg.fft, name)(x, **kw))
        return f
    run_both(fn(jp), fn(tp), ins, gate=True)


def test_complex_dtypes_and_the_rfft_irfft_round_trip():
    x = arr(2, 16, seed=5)
    for dt, cdt in (("float32", "complex64"), ("float64", "complex128")):
        t = tp.to_tensor(x.astype(dt), dtype=dt)
        s = tp.fft.rfft(t)
        assert s.dtype.name == cdt == jp.fft.rfft(jp.to_tensor(
            x.astype(dt), dtype=dt)).dtype.name
        assert s.numpy().dtype == np.dtype(cdt)
        back = tp.fft.irfft(s, n=16)
        np.testing.assert_allclose(back.numpy(), x, atol=1e-5)
        assert back.dtype.name == dt
    # a real loss through rfft -> irfft: gradient = jax.grad's
    run_both(lambda a: jp.fft.irfft(jp.fft.rfft(a) * 2.0, n=16),
             lambda a: tp.fft.irfft(tp.fft.rfft(a) * 2.0, n=16), [x],
             gate=True)


@pytest.mark.parametrize("name", ["fftfreq", "rfftfreq"])
def test_frequency_grids(name):
    for n, d in ((8, 1.0), (9, 0.25)):
        j = getattr(jp.fft, name)(n, d)
        t = getattr(tp.fft, name)(n, d)
        assert t.dtype.name == j.dtype.name
        np.testing.assert_allclose(t.numpy(), j.numpy(), rtol=1e-15)


@pytest.mark.parametrize("name", ["fftshift", "ifftshift"])
@pytest.mark.parametrize("axes", [None, (1,), (0, 2)])
def test_shifts(name, axes):
    run_both(lambda a: getattr(jp.fft, name)(a, axes=axes),
             lambda a: getattr(tp.fft, name)(a, axes=axes),
             [arr(3, 4, 5, seed=6)])


# -- stft / istft ---------------------------------------------------------------

_STFT = {
    "default": dict(n_fft=16),
    "hop_win": dict(n_fft=16, hop_length=5, win_length=10, window="hann"),
    "no_center": dict(n_fft=16, hop_length=4, center=False),
    "constant_pad": dict(n_fft=16, pad_mode="constant", window="hamming"),
    "normalized": dict(n_fft=16, hop_length=4, normalized=True,
                       window="hann"),
    "two_sided": dict(n_fft=16, hop_length=4, onesided=False,
                      window="hann"),
}


def _win(pkg, kw):
    kw = dict(kw)
    if "window" in kw:
        kw["window"] = pkg.audio.functional.get_window(
            kw["window"], kw.get("win_length") or kw["n_fft"])
    return kw


@pytest.mark.parametrize("mode", sorted(_STFT))
def test_stft_matches_jax(mode):
    x = arr(2, 96, seed=7)

    def fn(pkg):
        kw = _win(pkg, _STFT[mode])
        return lambda a: _split(pkg, pkg.signal.stft(a, **kw))
    run_both(fn(jp), fn(tp), [x], gate=True)


@pytest.mark.parametrize("mode", sorted(_STFT))
def test_istft_matches_jax(mode):
    x = arr(2, 96, seed=8)
    kw0 = dict(_STFT[mode])
    kw0.pop("pad_mode", None)

    def fn(pkg):
        kw = _win(pkg, kw0)

        def f(a):
            spec = pkg.signal.stft(a, **_win(pkg, _STFT[mode]))
            return pkg.signal.istft(spec, length=90, **kw)
        return f
    run_both(fn(jp), fn(tp), [x], gate=True)


def test_istft_inverts_stft_with_a_hann_window():
    x = arr(3, 400, seed=9)
    win = tp.audio.functional.get_window("hann", 64)
    spec = tp.signal.stft(tp.to_tensor(x), 64, 16, window=win)
    back = tp.signal.istft(spec, 64, 16, window=win, length=400).numpy()
    assert back.shape == (3, 400)
    np.testing.assert_allclose(back[:, 32:-32], x[:, 32:-32],
                               atol=1e-5 * np.abs(x).max())


def test_overlap_add_is_one_fold():
    frames = arr(2, 6, 50, seed=10)
    run_both(lambda a: jp.overlap_add(a, 3), lambda a: tp.overlap_add(a, 3),
             [frames], gate=True)
    run_both(lambda a: jp.overlap_add(a, 2, axis=0),
             lambda a: tp.overlap_add(a, 2, axis=0), [arr(6, 50, 2, seed=11)],
             gate=True)


# -- audio ---------------------------------------------------------------------

@pytest.mark.parametrize("window", ["hann", "hamming", "blackman",
                                    "bartlett", "rect"])
@pytest.mark.parametrize("fftbins", [True, False])
def test_windows_are_bit_equal(window, fftbins):
    for n in (1, 7, 16):
        j = jp.audio.functional.get_window(window, n, fftbins)
        t = tp.audio.functional.get_window(window, n, fftbins)
        assert t.dtype.name == j.dtype.name == "float32"
        np.testing.assert_array_equal(t.numpy(), j.numpy())
    with pytest.raises(ValueError):
        tp.audio.functional.get_window("kaiser", 8)


@pytest.mark.parametrize("htk", [False, True])
def test_mel_helpers(htk):
    F_j, F_t = jp.audio.functional, tp.audio.functional
    assert isinstance(F_t.hz_to_mel(440.0, htk), float)
    assert F_t.hz_to_mel(440.0, htk) == F_j.hz_to_mel(440.0, htk)
    assert F_t.mel_to_hz(20.0, htk) == F_j.mel_to_hz(20.0, htk)
    f = np.array([0.0, 300.0, 1000.0, 4000.0, 8000.0])
    jm, tm = F_j.hz_to_mel(jp.to_tensor(f, dtype="float64"), htk), \
        F_t.hz_to_mel(tp.to_tensor(f, dtype="float64"), htk)
    assert tm.dtype.name == jm.dtype.name == "float64"
    np.testing.assert_array_equal(tm.numpy(), jm.numpy())
    np.testing.assert_array_equal(F_t.mel_to_hz(tm, htk).numpy(),
                                  F_j.mel_to_hz(jm, htk).numpy())
    np.testing.assert_allclose(
        F_t.mel_frequencies(16, 20.0, 8000.0, htk).numpy(),
        F_j.mel_frequencies(16, 20.0, 8000.0, htk).numpy(), rtol=1e-6)
    np.testing.assert_array_equal(
        F_t.compute_fbank_matrix(16000, 64, 12, 20.0, None, htk).numpy(),
        F_j.compute_fbank_matrix(16000, 64, 12, 20.0, None, htk).numpy())


def test_fft_frequencies_and_dct():
    F_j, F_t = jp.audio.functional, tp.audio.functional
    np.testing.assert_allclose(F_t.fft_frequencies(16000, 400).numpy(),
                               F_j.fft_frequencies(16000, 400).numpy(),
                               rtol=1e-6)
    for norm in ("ortho", None):
        np.testing.assert_array_equal(F_t.create_dct(13, 40, norm).numpy(),
                                      F_j.create_dct(13, 40, norm).numpy())


@pytest.mark.parametrize("top_db", [None, 80.0, 10.0])
def test_power_to_db(top_db):
    x = arr(2, 8, 10, seed=12, lo=1e-6, hi=4.0)
    run_both(lambda a: jp.audio.functional.power_to_db(a, 2.0, 1e-10, top_db),
             lambda a: tp.audio.functional.power_to_db(a, 2.0, 1e-10, top_db),
             [x], gate=True)


_FEATS = {
    "Spectrogram": dict(n_fft=64, hop_length=16),
    "MelSpectrogram": dict(sr=16000, n_fft=64, hop_length=16, n_mels=16),
    "LogMelSpectrogram": dict(sr=16000, n_fft=64, hop_length=16, n_mels=16,
                              f_min=0.0, top_db=80.0),
    "MFCC": dict(sr=16000, n_mfcc=13, n_mels=16, n_fft=64, hop_length=16),
}


@pytest.mark.parametrize("name", sorted(_FEATS))
def test_feature_layers_match_jax(name):
    x = arr(2, 400, seed=13)
    jl = getattr(jp.audio.features, name)(**_FEATS[name])
    tl = getattr(tp.audio.features, name)(**_FEATS[name])
    run_both(jl, tl, [x], gate=True)
    assert {n for n, _ in tl.named_buffers()} == \
        {n for n, _ in jl.named_buffers()}


def test_wave_backend_round_trip(tmp_path):
    x = arr(2, 300, seed=14, lo=-0.9, hi=0.9)
    path = tmp_path / "t.wav"
    tp.audio.save(str(path), tp.to_tensor(x), 16000)
    info = tp.audio.info(str(path))
    assert (info.sample_rate, info.num_samples, info.num_channels,
            info.bits_per_sample) == (16000, 300, 2, 16)
    got, sr = tp.audio.load(str(path))
    ref, jsr = jp.audio.load(str(path))
    assert sr == jsr == 16000 and got.dtype.name == "float32"
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    np.testing.assert_allclose(got.numpy(), x, atol=1.0 / 32768 + 1e-7)
    part, _ = tp.audio.load(str(path), frame_offset=10, num_frames=20,
                            channels_first=False)
    assert part.shape == [20, 2]
    assert tp.audio.backends.list_available_backends() == ["wave_backend"]
    with pytest.raises(NotImplementedError):
        tp.audio.backends.set_backend("soundfile")


@pytest.mark.parametrize("cls", ["TESS", "ESC50"])
def test_audio_datasets(cls):
    jd = getattr(jp.audio.datasets, cls)(num_samples=3)
    td = getattr(tp.audio.datasets, cls)(num_samples=3)
    for i in range(3):
        (jw, jl), (tw, tl) = jd[i], td[i]
        np.testing.assert_array_equal(tw, jw)
        assert int(tl) == int(jl)
    kw = dict(n_fft=256, hop_length=128, n_mels=20)
    for feat in ("mfcc", "melspectrogram", "logmelspectrogram"):
        jf = getattr(jp.audio.datasets, cls)(num_samples=1, feat_type=feat,
                                             **kw)[0][0]
        tf = getattr(tp.audio.datasets, cls)(num_samples=1, feat_type=feat,
                                             **kw)[0][0]
        assert tf.shape == jf.shape
        assert_f32_gate(tf, jf)
    jf = getattr(jp.audio.datasets, cls)(
        num_samples=1, feat_type="spectrogram", n_fft=256)[0][0]
    tf = getattr(tp.audio.datasets, cls)(
        num_samples=1, feat_type="spectrogram", n_fft=256)[0][0]
    assert_f32_gate(tf, jf)


def test_nd_transforms_over_a_leading_axis_on_the_cpu():
    """torch's CPU ``fftn`` over dims (0, 1) of a [2, 512, 201] complex64
    tensor corrupts the heap; the port's n-d transforms run axis by axis
    on the CPU and equal numpy's."""
    rng = np.random.default_rng(15)
    c = (rng.standard_normal((2, 512, 201))
         + 1j * rng.standard_normal((2, 512, 201))).astype(np.complex64)
    t = tp.to_tensor(c)
    np.testing.assert_allclose(tp.fft.fftn(t, axes=(0, 1)).numpy(),
                               np.fft.fftn(c, axes=(0, 1)), rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_allclose(tp.fft.irfftn(t).numpy(), np.fft.irfftn(c),
                               rtol=1e-3, atol=1e-5)
    r = rng.standard_normal((2, 512, 400)).astype(np.float32)
    np.testing.assert_allclose(tp.fft.rfftn(tp.to_tensor(r)).numpy(),
                               np.fft.rfftn(r), rtol=1e-3, atol=1e-2)
