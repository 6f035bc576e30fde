"""Post-processing, denoiser, TAA, and Pallas-kernel equivalence tests."""

import dataclasses

import jax.numpy as jnp
import numpy as np

from drts_tpu.ops import denoise, post, taa


def test_tonemap_operators():
    x = jnp.array([[0.0, 0.18, 1.0], [4.0, 16.0, 1e4]])
    for name in post.TONEMAP_OPERATORS:
        y = post.tonemap(x[..., None].repeat(3, -1), name)
        y = np.asarray(y)
        assert y.min() >= 0.0 and y.max() <= 1.0
        assert (np.diff(y[..., 0].reshape(-1)) >= -1e-6).all()  # monotone


def test_bloom_spreads_and_conserves():
    img = jnp.zeros((64, 64, 3)).at[32, 32].set(100.0)
    out = np.asarray(post.bloom(img, strength=0.1))
    assert out[30, 30].sum() > 0.0          # energy spread to neighbors
    assert out[32, 32].sum() < 300.0        # peak reduced
    flat = jnp.full((64, 64, 3), 0.5)
    out2 = np.asarray(post.bloom(flat, strength=0.1))
    np.testing.assert_allclose(out2[16:48, 16:48], 0.5, atol=0.02)


def test_resize_bilinear_identity_and_mean():
    rng = np.random.RandomState(0)
    img = jnp.asarray(rng.rand(16, 16, 3), jnp.float32)
    same = post.resize_bilinear(img, 16, 16)
    np.testing.assert_allclose(np.asarray(same), np.asarray(img), atol=1e-6)
    up = post.resize_bilinear(img, 32, 32)
    np.testing.assert_allclose(float(up.mean()), float(img.mean()), atol=0.01)


def test_generate_mips():
    img = jnp.asarray(np.arange(64, dtype=np.float32).reshape(8, 8))
    mips = post.generate_mips(img, 3)
    assert [tuple(x.shape) for x in mips] == [(8, 8), (4, 4), (2, 2), (1, 1)]
    np.testing.assert_allclose(float(mips[-1][0, 0]), img.mean(), atol=1e-4)


def test_sharpen_enhances_edges():
    img = jnp.zeros((16, 16, 3)).at[:, 8:].set(1.0)
    out = np.asarray(post.sharpen(img, 1.0))
    assert out[8, 8].sum() > 3.0 - 1e-6  # overshoot on the bright side


def test_chromatic_aberration():
    """Lateral CA (README post chain): strength 0 is the identity; at
    strength > 0 an off-center impulse's red channel magnifies outward,
    blue inward, green stays put (a magnification scales integrals by the
    Jacobian, so only the green channel is exactly preserved)."""
    h = w = 65
    img = np.zeros((h, w, 3), np.float32)
    img[32, 48] = 1.0  # 16 px right of center
    x = jnp.asarray(img)

    assert post.chromatic_aberration(x, 0.0) is x

    out = np.asarray(post.chromatic_aberration(x, 0.03))
    assert np.isfinite(out).all()

    def centroid_x(ch):
        wsum = ch.sum()
        return (ch * np.arange(w)[None, :]).sum() / wsum, wsum

    rx, re = centroid_x(out[..., 0])
    gx, _ = centroid_x(out[..., 1])
    bx, be = centroid_x(out[..., 2])
    assert rx > 48.2, rx          # red pushed outward (right of center)
    assert abs(gx - 48.0) < 1e-4  # green untouched
    assert bx < 47.8, bx          # blue pulled inward
    # Jacobian bounds the per-channel integral drift.
    assert 0.9 < re < 1.12 and 0.9 < be < 1.12, (re, be)
    np.testing.assert_array_equal(out[..., 1], img[..., 1])


def test_denoiser_accumulates_static_scene():
    h = w = 32
    state = denoise.init_state(h, w)
    rng = np.random.RandomState(0)
    normal = jnp.tile(jnp.array([0.0, 0.0, -1.0]), (h, w, 1))
    depth = jnp.full((h, w), 5.0)
    valid = jnp.ones((h, w), bool)
    rough = jnp.full((h, w), 0.5)
    motion = jnp.zeros((h, w, 2))
    clean = 1.0
    outs = []
    for f in range(16):
        noisy = jnp.asarray(clean + rng.randn(h, w, 4) * 0.5, jnp.float32)
        noisy = jnp.maximum(noisy, 0.0)
        state, fd, fs = denoise.denoise(state, noisy, noisy, motion, normal,
                                        depth, valid, rough,
                                        jnp.asarray(False))
        outs.append(np.asarray(fd[..., :3]))
    # Raw per-frame noise is E|N(0, 0.5)| ~ 0.4; the denoiser must land far
    # below it both early (spatial filtering dominates) and late (temporal
    # accumulation dominates — spatial filtering fades out by design as
    # history converges, so late error tracks sigma/sqrt(N), not zero).
    early_err = np.abs(outs[0] - clean).mean()
    late_err = np.abs(outs[-1] - clean).mean()
    assert early_err < 0.15
    assert late_err < 0.12


def test_denoiser_disocclusion_resets_history():
    h = w = 16
    state = denoise.init_state(h, w)
    normal = jnp.tile(jnp.array([0.0, 0.0, -1.0]), (h, w, 1))
    depth = jnp.full((h, w), 5.0)
    valid = jnp.ones((h, w), bool)
    rough = jnp.full((h, w), 0.5)
    motion = jnp.zeros((h, w, 2))
    sig = jnp.ones((h, w, 4))
    for _ in range(8):
        state, _, _ = denoise.denoise(state, sig, sig, motion, normal, depth,
                                      valid, rough, jnp.asarray(False))
    assert float(state.history_length.mean()) > 7.0
    # Depth jump -> history invalid -> length resets to 1.
    state, _, _ = denoise.denoise(state, sig, sig, motion, normal,
                                  jnp.full((h, w), 50.0), valid, rough,
                                  jnp.asarray(False))
    assert float(state.history_length.mean()) <= 1.0 + 1e-6


def test_taa_upscale_converges_static():
    rh = rw = 16
    oh = ow = 32
    state = taa.init_state(oh, ow)
    img = jnp.tile(jnp.array([0.25, 0.5, 0.75]), (rh, rw, 1))
    motion = jnp.zeros((rh, rw, 2))
    for f in range(10):
        state, out = taa.upscale(state, img, motion, jnp.zeros(2), oh, ow,
                                 jnp.asarray(f == 0))
    np.testing.assert_allclose(np.asarray(out).mean(axis=(0, 1)),
                               [0.25, 0.5, 0.75], atol=0.01)
    assert out.shape == (oh, ow, 3)


def test_relax_denoiser_converges_and_differs():
    """ReLAX mode: converges on a static noisy signal, is a genuinely
    distinct path from ReBLUR (App.cpp:456 ships both), and suppresses
    fireflies."""
    h = w = 32
    rng = np.random.RandomState(3)
    normal = jnp.tile(jnp.array([0.0, 0.0, -1.0]), (h, w, 1))
    depth = jnp.full((h, w), 5.0)
    valid = jnp.ones((h, w), bool)
    rough = jnp.full((h, w), 0.5)
    motion = jnp.zeros((h, w, 2))
    clean = 1.0
    s_relax = denoise.init_state(h, w)
    s_reblur = denoise.init_state(h, w)
    for f in range(12):
        noisy = jnp.asarray(clean + rng.randn(h, w, 4) * 0.5, jnp.float32)
        noisy = jnp.maximum(noisy, 0.0)
        s_relax, rd, _ = denoise.denoise_relax(
            s_relax, noisy, noisy, motion, normal, depth, valid, rough,
            jnp.asarray(False))
        s_reblur, bd, _ = denoise.denoise(
            s_reblur, noisy, noisy, motion, normal, depth, valid, rough,
            jnp.asarray(False))
    relax_err = np.abs(np.asarray(rd[..., :3]) - clean).mean()
    assert relax_err < 0.12
    # Distinct outputs (different algorithms, same inputs).
    assert np.abs(np.asarray(rd) - np.asarray(bd)).max() > 1e-4
    # Variance moments were actually accumulated.
    assert float(s_relax.moments[..., 1].mean()) > 0.0
    assert float(s_reblur.moments.sum()) == 0.0


def test_relax_firefly_suppression():
    h = w = 16
    sig = jnp.ones((h, w, 4)) * 0.1
    sig = sig.at[8, 8, :3].set(500.0)  # firefly
    out = denoise._firefly_suppress(sig, factor=8.0)
    assert float(out[8, 8, :3].max()) < 10.0
    np.testing.assert_allclose(np.asarray(out[2, 2]), np.asarray(sig[2, 2]),
                               rtol=1e-6)


def test_taa_jitter_aware_unjitters():
    """With jitter-aware reconstruction at native res, a static scene
    sampled with alternating jitter must converge to the unjittered signal
    (the jitter is compensated, not averaged into blur)."""
    rh = rw = 32
    state = taa.init_state(rh, rw)
    # A sharp vertical edge; jittering the sample grid shifts what each
    # pixel sees. ramp(x) so a +0.5 jitter shifts values by 0.5.
    x = jnp.arange(rw, dtype=jnp.float32)[None, :].repeat(rh, 0)
    base = jnp.stack([x, x, x], axis=-1) / rw
    motion = jnp.zeros((rh, rw, 2))
    jitters = [jnp.array([0.25, 0.0]), jnp.array([-0.25, 0.0])]
    for f in range(12):
        j = jitters[f % 2]
        # Render of a ramp scene with jittered sampling: value = ramp(x+jx).
        img = jnp.stack([(x + j[0])] * 3, axis=-1) / rw
        state, out = taa.upscale(state, img, motion, j, rh, rw,
                                 jnp.asarray(f == 0))
    # Interior pixels must match the unjittered ramp, not a shifted copy.
    err = np.abs(np.asarray(out[:, 2:-2]) - np.asarray(base[:, 2:-2])).mean()
    assert err < 0.01


def test_catmull_history_identity_and_shift():
    """Catmull-Rom history resample must be the IDENTITY at integer pixel
    coordinates (callers use index convention: py + motion) and reproduce
    a linear ramp under fractional shifts — the round-4 orbit A/B caught
    the half-texel-convention bug that blurred even static history."""
    import jax.numpy as jnp
    from drts_tpu.ops import taa

    rng = np.random.RandomState(3)
    img = jnp.asarray(rng.rand(16, 20, 3), np.float32)
    y = jnp.arange(16, dtype=jnp.float32)[:, None] * jnp.ones((1, 20))
    x = jnp.arange(20, dtype=jnp.float32)[None, :] * jnp.ones((16, 1))
    out = taa._catmull_rom_sample(img, y, x)
    np.testing.assert_allclose(np.asarray(out), np.asarray(img), atol=1e-6)

    ramp = (jnp.arange(20, dtype=jnp.float32)[None, :, None]
            * jnp.ones((16, 1, 1))).repeat(3, -1)
    out3 = taa._catmull_rom_sample(ramp, y, x + 0.3)
    np.testing.assert_allclose(np.asarray(out3)[2:-2, 2:-2],
                               np.asarray(ramp)[2:-2, 2:-2] + 0.3,
                               atol=1e-4)
