"""The three compaction src-table builders (PathTraceConfig.compact_impl)
must be interchangeable: identical src tables, window membership, and
overflow counts for any live pattern, capacity, and spill wave
(ops/pathtrace._src_table_blocked vs the scatter form)."""

import jax.numpy as jnp
import numpy as np
import pytest

from drts_tpu.ops import pathtrace as pt


def _scatter_reference(act, order_ids, cap, wave):
    ns = act.shape[0]
    live_count = jnp.cumsum(act.astype(jnp.int32))
    pos = live_count - 1 - wave * cap
    keep = act & (pos >= 0) & (pos < cap)
    overflow = jnp.sum((act & (pos >= cap)).astype(jnp.int32))
    slot_of_src = jnp.where(keep, pos, cap)
    src = jnp.full((cap,), ns, jnp.int32).at[slot_of_src].set(
        order_ids, mode="drop", unique_indices=True)
    return src, keep, pos, overflow


@pytest.mark.parametrize("impl", ["blocked_sort", "two_level"])
@pytest.mark.parametrize("ns,cap,wave,density", [
    (4096, 256, 0, 0.05),
    (4096, 256, 1, 0.2),     # spill wave
    (10000, 1024, 0, 0.5),   # non-multiple of the block size
    (3000, 512, 0, 0.9),
    (512, 64, 0, 0.0),       # all dead
    (2048, 2048, 0, 1.0),    # all live, cap == ns block
])
def test_src_table_builders_match_scatter(impl, ns, cap, wave, density):
    rs = np.random.RandomState(ns + cap + wave)
    act = jnp.asarray(rs.rand(ns) < density)
    order_ids = jnp.asarray(rs.permutation(ns).astype(np.int32))

    ref = _scatter_reference(act, order_ids, cap, wave)
    got = pt._src_table_blocked(act, order_ids, cap, wave, impl)

    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]),
                                  err_msg="src")
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]),
                                  err_msg="keep")
    # pos only meaningful where keep (dead lanes carry arbitrary ranks in
    # both forms — the callers gate every use on keep/act).
    keep = np.asarray(ref[1])
    np.testing.assert_array_equal(np.asarray(got[2])[keep],
                                  np.asarray(ref[2])[keep], err_msg="pos")
    assert int(got[3]) == int(ref[3]), "overflow"


@pytest.mark.parametrize("impl", ["blocked_sort", "two_level"])
def test_trace_image_equal_across_impls(impl):
    """End-to-end: a small traced frame is identical under every
    compact_impl (the builder only changes HOW slots are assembled)."""
    import jax

    from drts_tpu.models import myscene
    from drts_tpu.ops import camera as camera_mod

    host = myscene.build(oscillator_grid=3)
    cam = camera_mod.make_camera(host.camera_position, host.camera_forward,
                                 horizontal_fov_deg=90.0, aspect=4 / 3)

    def run(which):
        cfg = pt.PathTraceConfig(width=64, height=48, bounces=3,
                                 samples_per_pixel=1, block_size=4096,
                                 compact_from=1, compact_impl=which)
        out = jax.jit(lambda s, c: pt.trace_image(s, c, cfg, 5))(
            host.scene, cam)
        return out.radiance

    np.testing.assert_array_equal(np.asarray(run("scatter")),
                                  np.asarray(run(impl)))
