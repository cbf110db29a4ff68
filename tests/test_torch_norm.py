"""Port parity of ops/norm.py: instance norm (B3's plain version and its
autograd Function, and B3 over height blocks: per-block triples merged in
block order), batch norm and apply_norm against
gan_class_transfer2_tpu.ops.norm on the same numpy inputs, on the CPU.

Tolerances, each with its reason:
  * plain vs ``_instance_norm_ref``: 1e-5 absolute in float32 (the same
    two-pass float32 statistics; summation order only); in bfloat16 one
    output rounding, 2^-8 of max|y| ≈ 1.6e-2 at |y| ≤ 4;
  * plain vs ``_instance_norm_pallas(interpret=True)``: 1e-4 absolute (the
    TPU kernel's one-pass E[x²] − m² cancels on inputs of mean 2 and std 3);
  * gradients against ``jax.vjp`` and the double backward against
    ``jax.grad``: 1e-5 of the largest value (float32 reductions in other
    orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gan_class_transfer2_tpu.ops import norm as jnorm  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import _build  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import norm  # noqa: E402

torch.set_num_threads(1)


def _inputs(c, b=2, hw=8, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(2.0, 3.0, (b, hw, hw, c)).astype(np.float32)
    g = r.normal(1.0, 0.2, (c,)).astype(np.float32)
    bt = r.normal(0.0, 0.2, (c,)).astype(np.float32)
    return x, g, bt


def T(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_the_jax_reference(c, dtype):
    x, g, b = _inputs(c)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    # the JAX reference takes γ/β in float32; the port rounds them to x's
    # dtype first (the Pallas wrapper's rule), so hand JAX the rounded ones
    g_r = np.asarray(jnp.asarray(g).astype(jd).astype(jnp.float32))
    b_r = np.asarray(jnp.asarray(b).astype(jd).astype(jnp.float32))
    want = np.asarray(jnorm._instance_norm_ref(jnp.asarray(x).astype(jd), g_r, b_r),
                      np.float32)
    got = norm.instance_norm_plain(T(x).to(td), T(g), T(b))
    assert got.dtype == td
    atol = 1e-5 if dtype == "float32" else 2 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol)


@pytest.mark.parametrize("c", [64, 128])
def test_plain_matches_the_pallas_kernel_in_interpret_mode(c):
    x, g, b = _inputs(c, seed=1)
    want = np.asarray(jnorm._instance_norm_pallas(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                                                  interpret=True))
    got = norm.instance_norm_fused(T(x), T(g), T(b))  # CPU tensor: the plain version
    assert norm.instance_norm_fused.launches == 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_function_gradients_match_jax_vjp():
    x, g, b = _inputs(8, b=2, hw=4, seed=5)
    dy = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    y, vjp = jax.vjp(jnorm.instance_norm, jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    want = vjp(jnp.asarray(dy))
    leaves = [T(a).requires_grad_() for a in (x, g, b)]
    out = norm.instance_norm(*leaves)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), atol=1e-5)
    got = torch.autograd.grad(out, leaves, T(dy))
    for name, a, w in zip(("dx", "dgamma", "dbeta"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_double_backward_matches_jax():
    """The gradient of ‖∂L/∂x‖², L = Σ w·instance_norm(x, γ, β), with
    respect to γ and to x: the Function's backward must itself be
    differentiable and carry ∂(m, r)/∂x (R1 through a normalised D needs
    it; statistics saved from the no-grad forward would drop those terms)."""
    x, g, b = _inputs(8, b=2, hw=4, seed=7)
    w = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)

    def jax_penalty(gamma, x_in):
        dx = jax.grad(lambda x_: jnp.sum(jnp.asarray(w) * jnorm.instance_norm(
            x_, gamma, jnp.asarray(b))))(x_in)
        return jnp.sum(dx ** 2)

    want_val, want = jax.value_and_grad(jax_penalty, argnums=(0, 1))(jnp.asarray(g),
                                                                     jnp.asarray(x))
    xt, gt = T(x).requires_grad_(), T(g).requires_grad_()
    (dx,) = torch.autograd.grad(torch.sum(T(w) * norm.instance_norm(xt, gt, T(b))), xt,
                                create_graph=True)
    pen = torch.sum(dx ** 2)
    got = torch.autograd.grad(pen, (gt, xt))
    np.testing.assert_allclose(float(pen.detach()), float(want_val), rtol=1e-5)
    for name, a, wt in zip(("dgamma", "dx"), got, want):
        wt = np.asarray(wt)
        np.testing.assert_allclose(a.numpy(), wt, atol=1e-5 * np.abs(wt).max(), err_msg=name)


def test_batch_norm_and_apply_norm_match_jax():
    x, g, b = _inputs(16, b=3, hw=4, seed=9)
    layer = norm.init_norm(16)
    with torch.no_grad():
        layer.gamma.copy_(T(g))
        layer.beta.copy_(T(b))
    params = {"gamma": jnp.asarray(g), "beta": jnp.asarray(b)}
    for kind in ("none", "instance", "batch"):
        want = np.asarray(jnorm.apply_norm(kind, jnp.asarray(x), params))
        got = norm.apply_norm(kind, T(x), layer).detach().numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=kind)
    np.testing.assert_allclose(norm.batch_norm(T(x), T(g), T(b)).numpy(),
                               np.asarray(jnorm.batch_norm(jnp.asarray(x), g, b)), atol=1e-5)
    with pytest.raises(ValueError, match="unknown norm"):
        norm.apply_norm("layer", T(x), layer)


def test_init_norm_is_ones_and_zeros():
    layer = norm.init_norm(5)
    want = jnorm.init_norm(5)
    np.testing.assert_array_equal(layer.gamma.detach().numpy(), np.asarray(want["gamma"]))
    np.testing.assert_array_equal(layer.beta.detach().numpy(), np.asarray(want["beta"]))


def test_wrapper_refuses_devices_without_a_kernel():
    x = torch.empty((1, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        norm.instance_norm_fused(x, torch.ones(8, device="meta"), torch.zeros(8, device="meta"))


def test_backward_wrapper_refuses_devices_without_a_kernel():
    x = torch.empty((1, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        norm.instance_norm_bwd_fused(x, torch.ones(8, device="meta"), torch.empty_like(x))


@pytest.mark.parametrize("need_affine", [True, False])
def test_backward_wrapper_on_the_cpu_is_the_plain_version(need_affine):
    """A CPU tensor takes ``_in_bwd`` itself (no launch); without
    ``need_affine`` dγ and dβ come back as None."""
    x, g, _ = _inputs(40, b=3, hw=5, seed=4)
    dy = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    before = norm.instance_norm_bwd_fused.launches
    got = norm.instance_norm_bwd_fused(T(x), T(g), T(dy), need_affine)
    want = norm._in_bwd(T(x), T(g), T(dy))
    assert norm.instance_norm_bwd_fused.launches == before
    assert torch.equal(got[0], want[0])
    for a, w in zip(got[1:], want[1:]):
        assert torch.equal(a, w) if need_affine else a is None


@pytest.mark.parametrize("create_graph", [False, True])
def test_cpu_backward_takes_the_torch_ops_without_counting(create_graph, monkeypatch):
    """On the CPU ``InstanceNorm.backward`` is ``_in_bwd`` in either grad
    mode: no kernel launch, and ``graph_backwards`` (the CUDA fallback's
    count) does not move."""
    calls = []
    plain = norm._in_bwd
    monkeypatch.setattr(norm, "_in_bwd", lambda *a: calls.append(1) or plain(*a))
    x, g, b = _inputs(8, b=2, hw=4, seed=6)
    xt, gt = T(x).requires_grad_(), T(g).requires_grad_()
    launches, graphs = norm.instance_norm_bwd_fused.launches, norm.InstanceNorm.graph_backwards
    torch.autograd.grad(norm.instance_norm(xt, gt, T(b)).sum(), (xt, gt),
                        create_graph=create_graph)
    assert calls == [1]
    assert norm.instance_norm_bwd_fused.launches == launches
    assert norm.InstanceNorm.graph_backwards == graphs


# the seven (H=W, C) maps of the cycle-GAN step's instance norms at the
# default width
_GAN_MAPS = ((256, 64), (128, 128), (64, 256), (32, 512), (16, 512), (8, 512), (4, 512))


@pytest.mark.parametrize("batch", [1, 4, 16])
@pytest.mark.parametrize("shape", _GAN_MAPS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_instance_norm_plan_splits_hw_exactly(shape, batch):
    """B3's plan: the cluster's chunks cover H·W exactly (the last may be
    short, or empty where H·W is below the cluster), the cluster stays
    within the portable limit, and every map at batch 16 puts at least 7/8
    of a wave on the card (128 blocks at the two big maps, 256 at the
    others)."""
    hw, c = shape
    p = norm.plan(batch, hw, hw, c)
    assert 1 <= p.cluster <= norm.CLUSTER_MAX and p.cluster & (p.cluster - 1) == 0
    chunks = [min(hw * hw, (r + 1) * p.chunk) - min(hw * hw, r * p.chunk)
              for r in range(p.cluster)]
    assert p.chunk == -(-hw * hw // p.cluster) and sum(chunks) == hw * hw
    assert p.blocks == -(-c // norm.CHANNELS) * batch * p.cluster
    # the smallest such cluster
    assert p.cluster == 1 or p.blocks // 2 < norm.FILL_TARGET
    if batch == 16:
        assert p.blocks >= norm.FILL_TARGET >= 7 * _build.SM_COUNT // 8
        assert p.blocks >= _build.SM_COUNT or p.blocks == 128


def test_instance_norm_plan_below_the_cluster():
    """H·W below the cluster (2×2 pixels, 8 blocks): one pixel a block, the
    last four blocks empty; C = 96 gives three channel groups."""
    p = norm.plan(1, 2, 2, 96)
    assert (p.cluster, p.chunk, p.blocks) == (8, 1, 24)


# ------------------------------------------------- B3 over height blocks


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_height_blocks_merged_match_the_jax_reference(shards, dtype):
    """B3 over height blocks in one process, its plain version: each block's
    (count, mean, M2), the triples merged by Chan's rule in block order,
    each block normalised from the merged statistics; the blocks side by
    side equal JAX's ``_instance_norm_ref`` on the whole image (its
    bounds: 1e-5 absolute in float32, 1.6e-2 in bfloat16)."""
    x, g, b = _inputs(40, b=3, hw=16, seed=4)
    tdt = getattr(torch, dtype)
    xt = T(x).to(tdt)
    blocks = xt.chunk(shards, 1)
    parts = torch.stack([norm.block_stats_plain(blk) for blk in blocks])
    assert parts.shape == (shards, 3, 40, 3)
    assert torch.equal(parts[..., 0], torch.full((shards, 3, 40), 16.0 * 16 / shards))
    mean, rstd = norm.merge_block_stats(parts)
    got = torch.cat([norm.block_apply_plain(blk, mean, rstd, T(g), T(b)) for blk in blocks], 1)
    assert got.dtype == tdt
    want = np.asarray(jnp.asarray(jnorm._instance_norm_ref(
        jnp.asarray(x).astype(getattr(jnp, dtype)), jnp.asarray(g), jnp.asarray(b)),
        jnp.float32))
    tol = 1e-5 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol * max(1.0, np.abs(want).max()))
    # one block is the whole image: the single-launch route's function
    whole = norm.block_apply_plain(xt, *norm.merge_block_stats(norm.block_stats_plain(xt)[None]),
                                   T(g), T(b))
    np.testing.assert_allclose(whole.float().numpy(),
                               norm.instance_norm_plain(xt, T(g), T(b)).float().numpy(),
                               atol=tol * max(1.0, np.abs(want).max()))
    # the merge-and-apply launch's plain version: the same (mean, r) as the
    # merge, each block's y the same function; the stats launch's slot of the
    # gather's buffer filled in place
    buf = torch.zeros((shards * 3, 40, 3))
    for i, blk in enumerate(blocks):
        assert norm.block_stats(blk, out=buf[i * 3:(i + 1) * 3]).data_ptr() == buf[i * 3].data_ptr()
    assert torch.equal(buf.view(shards, 3, 40, 3), parts)
    outs = [norm.block_merge_apply_plain(blk, parts, T(g), T(b)) for blk in blocks]
    for _, m, r in outs:
        assert torch.equal(m, mean) and torch.equal(r, rstd)
    merged = torch.cat([y for y, _, _ in outs], 1)
    assert merged.dtype == tdt and torch.equal(merged, got)
    np.testing.assert_allclose(merged.float().numpy(), want, atol=tol * max(1.0, np.abs(want).max()))


def test_block_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty((1, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        norm.block_stats(x)
    with pytest.raises(ValueError, match="no kernel"):
        norm.block_merge_apply(x, torch.zeros(2, 1, 8, 3, device="meta"),
                               torch.ones(8, device="meta"), torch.zeros(8, device="meta"))


# the 12 norm blocks of a spatial rank (the default model on 2 height shards
# at batch 16: each octave's down norm, then its up norm) and a ragged one
_BLOCKS = ((16, 64, 128, 128), (16, 128, 256, 64), (16, 32, 64, 256), (16, 64, 128, 128),
           (16, 16, 32, 512), (16, 32, 64, 256), (16, 8, 16, 512), (16, 16, 32, 512),
           (16, 4, 8, 512), (16, 8, 16, 512), (16, 2, 4, 512), (16, 4, 8, 512), (3, 9, 17, 40))


def _walk(p, b, hw, c, dtype):
    """csrc/instance_norm.cu's ``Place`` over every thread of a height-block
    launch: {group q: its merge lanes' owners}, {(q, channel): pixel
    ranges}."""
    vec = 16 // dtype.itemsize
    tx_n = norm.CHANNELS // vec
    ly_n = 32 // tx_n
    ng = -(-c // norm.CHANNELS)
    per_block = p.wpb // p.wpg
    owners, pixels = {}, {}
    for blk in range(p.blocks):
        rank = blk % p.cluster
        p_begin = min(rank * p.chunk, hw)
        p_end = min(p_begin + p.chunk, hw)
        for warp in range(p.wpb):
            gi, wl = divmod(warp, p.wpg)
            q = blk // p.cluster * per_block + gi
            if q >= b * ng:
                continue
            if wl == 0 and rank == 0:
                owners[q] = owners.get(q, 0) + 1
            for lane in range(32):
                tx, ly = lane % tx_n, lane // tx_n
                pl = wl * ly_n + ly
                for v in range(vec):
                    ch = q % ng * norm.CHANNELS + tx * vec + v
                    pixels.setdefault((q, ch), []).append((p_begin + pl, p_end, p.wpg * ly_n))
    return owners, pixels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _BLOCKS, ids=lambda s: "x".join(map(str, s)))
def test_block_plan_covers_every_group_and_pixel_once(shape, dtype):
    """The height-block kernels' plan at every norm block of a spatial rank
    and a ragged one: a grid CUDA launches (blocks ≤ 2³¹ − 1, ≤ 256
    threads, a cluster of 1–8 that divides the grid and only where a group
    takes the whole block), and its index map gives every (b, c) one
    merging warp and every pixel of a group's channel to exactly one thread."""
    b, h, w, c = shape
    dt = getattr(torch, dtype)
    p = norm.block_plan(b, h, w, c, dt)
    assert norm.block_plan(b, h, w, c, dt) is p  # cached
    assert 1 <= p.blocks <= 2**31 - 1 and 1 <= p.wpg <= p.wpb <= norm.WARPS
    assert p.wpb % p.wpg == 0 and p.wpb * 32 <= 1024
    assert 1 <= p.cluster <= norm.CLUSTER_MAX and p.blocks % p.cluster == 0
    assert p.cluster == 1 or p.wpg == p.wpb == norm.WARPS
    assert p.chunk == -(-h * w // p.cluster)
    owners, pixels = _walk(p, b, h * w, c, dt)
    ng = -(-c // norm.CHANNELS)
    assert owners == {q: 1 for q in range(b * ng)}
    for q in range(b * ng):
        for ch in range(q % ng * norm.CHANNELS, min(c, (q % ng + 1) * norm.CHANNELS)):
            got = np.concatenate([np.arange(*r) for r in pixels[(q, ch)]])
            assert np.array_equal(np.sort(got), np.arange(h * w)), (q, ch)
    if h * w <= 128:  # the small maps: no cluster, a group smaller than a block
        assert p.cluster == 1 and p.wpg < norm.WARPS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _GAN_MAPS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_backward_plan_covers_every_sample_group_and_pixel_once(shape, dtype):
    """B3's backward cuts a whole image as ``block_plan`` cuts a height
    block: at the cycle GAN's maps at batch 16 its index map gives every
    (sample, group) one summing warp and every pixel of a channel to exactly
    one thread, clusters only where a group takes a block, and at least 7/8
    of a wave of blocks on the card."""
    hw, c = shape
    dt = getattr(torch, dtype)
    p = norm.block_plan(16, hw, hw, c, dt)
    assert 1 <= p.wpg <= p.wpb <= norm.WARPS and p.wpb % p.wpg == 0
    assert 1 <= p.cluster <= norm.CLUSTER_MAX and p.blocks % p.cluster == 0
    assert p.cluster == 1 or p.wpg == p.wpb == norm.WARPS
    assert p.blocks >= norm.FILL_TARGET
    owners, pixels = _walk(p, 16, hw * hw, c, dt)
    ng = -(-c // norm.CHANNELS)
    assert owners == {q: 1 for q in range(16 * ng)}
    for q in range(16 * ng):
        for ch in range(q % ng * norm.CHANNELS, (q % ng + 1) * norm.CHANNELS):
            got = np.concatenate([np.arange(*r) for r in pixels[(q, ch)]])
            assert np.array_equal(np.sort(got), np.arange(hw * hw)), (q, ch)


def test_stats_over_ranks_of_one_is_plain_batch_norm_and_ends_with_its_block():
    """Outside a process group every registered axis spans one rank, so
    batch norm under ``stats_over`` is the plain one; the context is the
    block's and this thread's."""
    x, g, b = _inputs(8, b=3, hw=4, seed=2)
    want = norm.batch_norm(T(x), T(g), T(b))
    with norm.stats_over("batch", "spatial"):
        assert norm.stats_names() == ("batch", "spatial")
        assert norm.rank_axes() == []
        got = norm.batch_norm(T(x), T(g), T(b))
        with norm.stats_over():
            assert norm.rank_axes() == []
    assert torch.equal(got, want)
    assert norm._RANKS.names == ()



def test_batch_norm_over_replica_threads_matches_jax_on_the_whole_batch():
    """Two threads, each with its rows of a batch, in one ``ReplicaGroup``:
    each normalises its rows with the whole batch's statistics, the same
    bits on both (JAX's ``batch_norm`` of the whole batch, 1e-5), and one
    ``autograd.grad`` from this thread over both threads' outputs gives
    the whole batch's gradients (JAX's ``jax.vjp`` of ``batch_norm``, 1e-5
    for x and 1e-4 for γ, a sum over the batch): the sum's adjoint is a
    graph edge, with no wait in the backward. A thread that raises breaks
    the other's wait, and the context ends with its block."""
    import threading

    x, g, b = _inputs(8, b=4, hw=4, seed=5)
    dy = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    group = norm.ReplicaGroup(2, timeout=60)
    xs = [T(x[2 * r:2 * r + 2]).requires_grad_() for r in range(2)]
    gs = [T(g).requires_grad_() for _ in range(2)]
    ys = [None, None]

    def run(r):
        with norm.over_replicas(group, r):
            ys[r] = norm.batch_norm(xs[r], gs[r], T(b))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert group.sums == 2 and norm._RANKS.__dict__.get("replica") is None
    want = np.asarray(jnorm.batch_norm(jnp.asarray(x), g, b))
    np.testing.assert_allclose(torch.cat(ys).detach().numpy(), want, atol=1e-5)
    grads = torch.autograd.grad(ys, xs + gs, [T(dy[:2]), T(dy[2:])])
    _, vjp = jax.vjp(lambda xx, gg: jnorm.batch_norm(xx, gg, jnp.asarray(b)),
                     jnp.asarray(x), jnp.asarray(g))
    ref = [np.asarray(a) for a in vjp(jnp.asarray(dy))]
    np.testing.assert_allclose(torch.cat(grads[:2]).numpy(), ref[0], atol=1e-5)
    np.testing.assert_allclose((grads[2] + grads[3]).numpy(), ref[1], atol=1e-4)

    group.clear()
    errors = [None, None]

    def failing(r):
        try:
            with norm.over_replicas(group, r):
                if r == 1:
                    group.abort()
                    raise RuntimeError("replica 1")
                norm.batch_norm(xs[r], gs[r], T(b))
        except Exception as e:  # noqa: BLE001
            errors[r] = e

    threads = [threading.Thread(target=failing, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert isinstance(errors[0], threading.BrokenBarrierError)
