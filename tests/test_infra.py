"""Infrastructure: the pytree dataclass helper, cache locations, npz
checkpoints, and the entry points' refusal to run without a GPU."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drts_tpu.utils import cache, checkpoint, device, struct

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@struct.dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray = None
    n: int = struct.field(pytree_node=False, default=3)


def test_struct_flatten_round_trip():
    p = _Pair(a=jnp.arange(3.0), b=jnp.ones(2), n=5)
    leaves, tree = jax.tree.flatten(p)
    assert len(leaves) == 2
    q = jax.tree.unflatten(tree, leaves)
    assert q.n == 5
    np.testing.assert_array_equal(q.a, p.a)


def test_struct_static_field_is_treedef_metadata():
    p1, p2 = _Pair(a=jnp.zeros(2), n=1), _Pair(a=jnp.zeros(2), n=2)
    assert jax.tree.structure(p1) != jax.tree.structure(p2)
    assert len(jax.tree.leaves(p1)) == 1      # b is None, n is static


def test_struct_replace_and_frozen():
    p = _Pair(a=jnp.zeros(2))
    q = p.replace(a=jnp.ones(2), n=7)
    assert q.n == 7 and p.n == 3
    np.testing.assert_array_equal(q.a, [1.0, 1.0])
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.ones(2)


def test_struct_under_jit_keeps_static_field_static():
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.n)          # a Python int at trace time
        return p.replace(a=p.a * p.n)

    out = f(_Pair(a=jnp.ones(2), n=4))
    np.testing.assert_array_equal(out.a, [4.0, 4.0])
    assert out.n == 4 and traces == [4]
    f(_Pair(a=jnp.zeros(2), n=4))   # same static value: no retrace
    assert traces == [4]


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_is_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.compile_cache_dir()
    assert path == os.path.join(ROOT, ".cache", "jax")
    assert os.path.join(ROOT, ".cache", "jax") == os.path.join(
        cache.CHECKOUT, ".cache", "jax")


def test_npz_checkpoint_round_trip(tmp_path):
    state = {"x": jnp.arange(6, dtype=jnp.int32).reshape(2, 3),
             "p": _Pair(a=jnp.linspace(0.0, 1.0, 4, dtype=jnp.float32),
                        b=jnp.zeros((), jnp.float16))}
    path = str(tmp_path / "ckpt")
    assert checkpoint.restore(state, path) is None
    checkpoint.save(state, path)
    got = checkpoint.restore(jax.tree.map(jnp.zeros_like, state), path)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(got)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_device_describe_names_the_backend():
    info = device.describe()
    assert info["platform"] == jax.devices()[0].platform
    assert info["count"] == len(jax.devices())
    if info["platform"] != "gpu":
        with pytest.raises(RuntimeError):
            device.require_gpu()


def _run(cmd, cwd, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_chip_smoke_fails_without_gpu():
    out = _run([sys.executable, "chip_smoke.py"], ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run([sys.executable, "chip_smoke.py"], str(tmp_path))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_bench_fails_without_gpu():
    out = _run([sys.executable, "bench.py"], ROOT)
    assert out.returncode != 0
    record = json.loads(out.stdout.strip().splitlines()[-1])
    assert record["device"]["platform"] == "cpu"
    assert any("no GPU" in e for e in record["errors"])


def _encode_png(path, img, filter_kind):
    """Minimal PNG encoder applying one filter type to every row (the
    reader must invert each of the five)."""
    import struct as st
    import zlib
    h, w, c = img.shape
    a = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        up = a[y - 1] if y else np.zeros(w * c, np.int32)
        left = np.concatenate([np.zeros(c, np.int32), a[y, :-c]])
        ul = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        pa, pb, pc = np.abs(up - ul), np.abs(left - ul), np.abs(left + up
                                                                - 2 * ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        pred = [0, left, up, (left + up) >> 1, paeth][filter_kind]
        rows.append(bytes([filter_kind])
                    + ((a[y] - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return (st.pack(">I", len(data)) + tag + data
                + st.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    color = {1: 0, 3: 2, 4: 6}[c]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", st.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                         0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("filter_kind,channels", [
    (0, 3), (1, 3), (2, 3), (3, 3), (4, 3), (4, 4), (3, 1)])
def test_read_png_inverts_every_filter(tmp_path, filter_kind, channels):
    from drts_tpu.utils import image
    img = np.random.RandomState(filter_kind).randint(
        0, 256, (9, 13, channels)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    _encode_png(path, img, filter_kind)
    np.testing.assert_array_equal(image.read_png(path), img)


def test_write_png_load_image_round_trip(tmp_path):
    from drts_tpu.utils import image
    img = np.random.RandomState(0).rand(7, 5, 3).astype(np.float32)
    path = str(tmp_path / "y.png")
    image.write_png(path, img)
    got = image.load_image(path)
    assert got.shape == (7, 5, 4)
    np.testing.assert_allclose(got[..., :3], img, atol=0.5 / 255 + 1e-6)
    np.testing.assert_array_equal(got[..., 3], 1.0)
