"""PyTorch port: the binned traversal's select and setup kernels in their
lane-group forms (csrc/binned.cu `select_group`, `setup_group`; kernels 6
and 5 of the JAX package's binned traversal, `_select_kernel` and
`_setup_kernel`).

select_group gives a ray a group of G lanes and keeps its w slots in
registers, slot j in lane j % G, register j / G. Each step takes every
lane's least key at or above a bound, then the group's minimum (a xor
butterfly), and raises the bound past it: the k - 1 least distinct keys of
a refilling ray, then the k pops; every key at or below the last pop is
cleared, and live / mink are a group sum and minimum. setup_group gives a
ray G lanes: lane l slab-tests supers l, l + G, ...; the eligible keys are
compacted by ballot and popcount into the ray's row, and each lands at its
rank (the keys of the row below it) in an (s_out, rays) tile. `_select_model` and `_setup_model`
replay that logic in torch, and the tests hold them:

- bitwise to `select_plain` / `setup_rank_plain` on inputs built to hit
  every trap: duplicate keys (every copy of a minimum goes), refilling rays
  with k or more live keys, negative keys and best_t (signed compares),
  INT_MIN, k = 1 and k = w, n = 0, the traversal's three shapes (w 67, 143,
  287: none a multiple of G), and for setup rays that enter no super or
  every super, zero direction components, origins inside boxes (entry t
  below 0: key t 0), cap 1, 32 and the padded count, super counts that G
  does not divide;
- bitwise to the JAX package's `_run_select` and `_setup_rank` (the Pallas
  kernels in interpret mode) on the traversal's shapes.

The CUDA kernels are held bitwise to the plain versions on the same kinds
of inputs at the traversal's shapes on the card:

    python -m pytest --noconftest tests/test_torch_select_setup.py -k cuda
"""

import numpy as np
import pytest
import torch

from echorenderer_tpu_torch.ops import binned_trace as bt
from echorenderer_tpu_torch.ops import pallas_intersect as tpi

torch.set_num_threads(1)

INF = bt._INT_INF
INT_MIN = -(2**31)
# (w, k) of the traversal's three phases: full width, mid stage, final stage
SHAPES = ((bt.KSUP * bt.SUP + bt.K - 1, bt.K), (bt.MID_KSUP * bt.SUP + bt.MID_K - 1, bt.MID_K),
          (bt.TAIL_KSUP * bt.SUP + bt.K_STRAGGLER - 1, bt.K_STRAGGLER))
GROUPS = (1, 4, 8, 16, 32)
# csrc/binned.cu kSelectForms: (largest w, lanes a ray) of select's register forms
SELECT_FORMS = ((72, 4), (160, 4), (320, 8), (512, 16))


def _group_min(m, g):
    """The xor butterfly of a group of g lanes: m (N, g) -> (N,)."""
    lane = torch.arange(g)
    off = g // 2
    while off:
        m = torch.minimum(m, m[:, lane ^ off])
        off //= 2
    return m[:, 0]


def _group_sum(x, g):
    lane = torch.arange(g)
    off = g // 2
    while off:
        x = x + x[:, lane ^ off]
        off //= 2
    return x[:, 0]


def _least_from(v, lo, g):
    """The group's least key >= lo (N,): each lane's least, then the
    butterfly. v (N, g, R)."""
    lane_min = torch.where(v >= lo[:, None, None], v, INF).amin(2)
    return _group_min(lane_min, g)


def _take_least(v, most, active, g):
    """select_group's take_least for each ray: (keep (N, most), count (N,),
    the bound just past the last key taken)."""
    n = v.shape[0]
    keep = torch.full((n, max(most, 1)), INF, dtype=torch.int64)
    got = torch.zeros(n, dtype=torch.int64)
    lo = torch.full((n,), INT_MIN, dtype=torch.int64)
    going = active.clone()
    for _ in range(most):
        m = _least_from(v, lo, g)
        going = going & (m != INF)
        keep[going, got[going]] = m[going]
        lo = torch.where(going, m + 1, lo)
        got = got + going.long()
    return keep, got, lo


def _select_model(cand, new_keys, best_t, do_refill, k, cbits, g, max_w=None):
    """select_group<g, ceil(max_w / g)> replayed: (cand', pop, live, mink),
    cand' (w, N), pop (k, N), all int32."""
    w, n = cand.shape
    r_keys = -(-(max_w or w) // g)
    slots = torch.arange(g * r_keys).view(r_keys, g).T  # [lane, register] -> slot
    c = cand.long().T  # (N, w)
    pad = torch.cat([c, torch.full((n, g * r_keys - w), INF, dtype=torch.int64)], 1)
    v = pad[:, slots]  # (N, g, R)
    best_bits = bt._bits(best_t).long()
    tmask = -(1 << cbits)
    v = torch.where(((v & tmask) < best_bits[:, None, None]) & (slots < w), v, INF)
    refill = do_refill.clone()
    keep, got, _ = _take_least(v, k - 1, refill, g)
    nk = torch.cat([torch.full((n, k - 1), INF, dtype=torch.int64), new_keys.long().T,
                    torch.full((n, g * r_keys - w), INF, dtype=torch.int64)], 1)
    j = slots[None]
    from_keep = keep.gather(1, torch.clamp(slots.reshape(1, -1), max=max(k - 2, 0)).expand(n, -1))
    from_keep = from_keep.view(n, g, r_keys)
    new_v = torch.where(j < got[:, None, None], from_keep,
                        torch.where((j < k - 1) | (j >= w), INF, nk[:, slots]))
    v = torch.where(refill[:, None, None], new_v, v)
    pops, got, lo = _take_least(v, k, torch.ones(n, dtype=torch.bool), g)
    pop = torch.where(torch.arange(k)[None] < got[:, None], pops[:, :k], INF)
    v = torch.where(v >= lo[:, None, None], v, INF)
    live = _group_sum((v != INF).sum(2), g)
    mink = _group_min(v.amin(2), g)
    out = torch.empty((n, g * r_keys), dtype=torch.int64)
    out[:, slots.reshape(-1)] = v.reshape(n, g * r_keys)
    return (out[:, :w].T.int().contiguous(), pop.T.int().contiguous(), live.int(), mink.int())


def _slab(rays, sup_cb):
    """echo::slab of every ray against every super, in the kernel's op order:
    (tn, tf) (N, S)."""
    o = rays[0:3].T
    inv = tpi._safe_inv(rays[3:6].T)
    tn = tf = None
    for a in range(3):
        t0 = (sup_cb[None, :, a] - o[:, a:a + 1]) * inv[:, a:a + 1]
        t1 = (sup_cb[None, :, 3 + a] - o[:, a:a + 1]) * inv[:, a:a + 1]
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = lo if tn is None else torch.maximum(tn, lo)
        tf = hi if tf is None else torch.minimum(tf, hi)
    return tn, tf


def _setup_model(rays, sup_cb, sbits, cap, g):
    """setup_group<g, .> replayed: (s_out, N) int32."""
    s_count = sup_cb.shape[0]
    s_pad = bt._super_pad(s_count)
    s_out = s_pad if cap is None else min(s_pad, cap)
    n = rays.shape[1]
    tn, tf = _slab(rays, sup_cb)
    ok = (tn <= tf) & (tf > 0.0) & (tn < rays[6][:, None])
    ids = torch.arange(s_count, dtype=torch.int32)
    key = (bt._bits(torch.where(tn > 0.0, tn, 0.0)) & -(1 << sbits)) | ids[None]
    width = s_count + 4
    row = torch.full((n, width), INF, dtype=torch.int64)
    length = torch.zeros(n, dtype=torch.int64)
    for s0 in range(0, s_count, g):  # a ballot a pass: lane order within it
        bal = ok[:, s0:s0 + g]
        pos = length[:, None] + torch.cumsum(bal.long(), 1) - bal.long()
        rr, ll = torch.nonzero(bal, as_tuple=True)
        row[rr, pos[rr, ll]] = key[rr, s0 + ll].long()
        length = length + bal.sum(1)
    col = torch.full((n, s_out), INF, dtype=torch.int64)
    live = torch.arange(width)[None] < length[:, None]
    ranks = (row[:, None, :] < row[:, :, None]).sum(2)  # keys below each key in the row
    rr, pp = torch.nonzero(live & (ranks < s_out), as_tuple=True)
    col[rr, ranks[rr, pp]] = row[rr, pp]
    return col.T.int().contiguous()


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _select_inputs(w, k, n, seed, *, dup=False, dense=False, negative=False):
    """cand (w, N), new keys, best_t, refill flags: some rays hold fewer than
    k keys, some more (dense); dup draws keys from a small range (copies of
    one key in a buffer and across the new keys); negative draws any int32
    and signed best_t bits."""
    rs = np.random.RandomState(seed)
    density = rs.uniform(0.3 if dense else 0.0, 0.9 if dense else 0.15, n)
    hi = 2**31 - 1
    if dup:
        draw = lambda shape: rs.randint(0, 40, shape) * 4096 + rs.randint(0, 3, shape)
    elif negative:
        draw = lambda shape: rs.randint(-2**31, hi, shape, dtype=np.int64)
    else:
        draw = lambda shape: rs.randint(0, hi, shape)
    cand = np.where(rs.uniform(size=(w, n)) < density, draw((w, n)), INF).astype(np.int32)
    nk = np.where(rs.uniform(size=(w - k + 1, n)) < density, draw((w - k + 1, n)),
                  INF).astype(np.int32)
    if negative:
        cand[0, :: 7] = INT_MIN
        best_t = rs.uniform(-1e30, 1e30, n).astype(np.float32)
    else:
        best_t = np.where(rs.uniform(size=n) < 0.3, np.float32(bt._INF),
                          rs.uniform(0, 1e30, n)).astype(np.float32)
    if dup:
        best_t[:] = np.float32(bt._INF)
    refill = rs.uniform(size=n) < 0.5
    return cand, nk, best_t, refill


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _check_select(w, k, n, seed, groups, cbits=12, **kind):
    cand, nk, best_t, refill = _torch(*_select_inputs(w, k, n, seed, **kind))
    want_c = cand.clone()
    want = bt.select_plain(want_c, nk, best_t, refill, k, cbits)
    for g in groups:
        got_c, *got = _select_model(cand, nk, best_t, refill, k, cbits, g)
        assert torch.equal(got_c, want_c), g
        for a, b in zip(got, want):
            assert torch.equal(a, b), g
    return want_c, want, refill


@pytest.mark.parametrize("w,k", SHAPES)
def test_select_model_matches_plain_traversal_shapes(w, k):
    c, (pop, live, mink), refill = _check_select(w, k, 300, seed=w, groups=GROUPS)
    assert 0 < (pop != INF).float().mean() < 1 and bool((live > 0).any())


@pytest.mark.parametrize("kind", ["dup", "dense", "negative"])
def test_select_model_traps(kind):
    """Copies of a minimum (all go), refilling rays with k or more live keys
    (they keep only their k - 1 least), signed compares of keys and best_t."""
    w, k = SHAPES[1]
    c, (pop, live, mink), refill = _check_select(w, k, 200, seed=11, groups=GROUPS,
                                                 **{kind: True})
    if kind == "dense":
        held = (torch.as_tensor(_select_inputs(w, k, 200, 11, dense=True)[0]) != INF).sum(0)
        assert bool((refill & (held >= k)).any())


@pytest.mark.parametrize("w,k", [(5, 1), (5, 5), (67, 67), (1, 1), (33, 2)])
def test_select_model_edge_widths(w, k):
    """k = 1 (no extract steps), k = w (one new-key row), w below and just
    above a group of 32."""
    _check_select(w, k, 64, seed=3, groups=GROUPS, dup=True)
    _check_select(w, k, 64, seed=4, groups=GROUPS)


def test_select_model_form_wider_than_w():
    """Each register form of csrc/binned.cu covers up to max_w slots; a
    narrower buffer pads."""
    w, k = SHAPES[0]
    cand, nk, best_t, refill = _torch(*_select_inputs(w, k, 100, 5, dup=True))
    want_c = cand.clone()
    want = bt.select_plain(want_c, nk, best_t, refill, k, 12)
    for max_w, g in SELECT_FORMS:
        got_c, *got = _select_model(cand, nk, best_t, refill, k, 12, g, max_w=max_w)
        assert torch.equal(got_c, want_c) and all(torch.equal(a, b) for a, b in zip(got, want))


def test_select_zero_rays():
    w, k = SHAPES[2]
    cand = torch.empty((w, 0), dtype=torch.int32)
    pop, live, mink = bt.select(cand, torch.empty((w - k + 1, 0), dtype=torch.int32),
                                torch.empty(0), torch.empty(0, dtype=torch.bool), k, 12)
    assert pop.shape == (k, 0) and live.shape == (0,) and mink.shape == (0,)
    got = _select_model(cand, torch.empty((w - k + 1, 0), dtype=torch.int32), torch.empty(0),
                        torch.empty(0, dtype=torch.bool), k, 12, 32)
    assert got[1].shape == (k, 0)


def _setup_inputs(n, s_count, seed):
    """Rays (7, N) against s_count super boxes that all hold the origin:
    random rays (each enters its own subset), rays with zero direction
    components, rays from the origin (inside every box: L = S, every entry
    t below 0, so keys 0 | super), rays that miss everything (L = 0), some
    with a near limit. Returns (rays, supers, which rays start at the
    origin, which miss)."""
    rs = np.random.RandomState(seed)
    sup = np.concatenate([-rs.uniform(0.1, 10, (s_count, 3)), rs.uniform(0.1, 10, (s_count, 3))],
                         1).astype(np.float32)
    o = rs.uniform(-12, 12, (n, 3))
    d = rs.normal(size=(n, 3))
    d[::5, 0] = 0.0
    d[1::7] = [[-1.0, 0.0, 0.0]]  # two zero components
    away = np.arange(n) % 11 == 3
    inside = (np.arange(n) % 9 == 2) & ~away
    o[inside] = 0.0
    o[away] = [100, 100, 100]
    d[away] = [1, 1, 1]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    limit = np.where(rs.uniform(size=n) < 0.2, rs.uniform(0.5, 5, n), bt._INF)
    rays = tpi.ray_columns(torch.as_tensor(o, dtype=torch.float32),
                           torch.as_tensor(d, dtype=torch.float32),
                           torch.as_tensor(limit, dtype=torch.float32))
    return rays, torch.as_tensor(sup), torch.as_tensor(inside), torch.as_tensor(away)


@pytest.mark.parametrize("s_count,cap", [(245, None), (245, 32), (245, 1), (5, None), (100, 3),
                                         (512, None), (1, None)])
def test_setup_model_matches_plain(s_count, cap):
    rays, sup, inside, away = _setup_inputs(180, s_count, seed=s_count)
    sbits = max(1, (s_count - 1).bit_length())
    want = bt.setup_rank_plain(rays, sup, sbits, cap)
    for g in GROUPS[1:]:
        assert torch.equal(_setup_model(rays, sup, sbits, cap, g), want), g
    assert bool((want[:, away] == INF).all())  # L = 0
    # from inside every box: entry t 0, the keys in super order
    ids = torch.arange(want.shape[0], dtype=torch.int32)[:, None]
    ids = torch.where(ids < s_count, ids, INF)  # rows past the supers: none
    assert torch.equal(want[:, inside], ids.expand(-1, int(inside.sum())))
    if cap is None:
        assert int((want != INF).sum(0).max()) == s_count  # L = S


def test_setup_zero_rays():
    rays, sup, _, _ = _setup_inputs(4, 245, seed=1)
    out = bt.setup_rank(rays[:, :0].contiguous(), sup, 8)
    assert out.shape == (256, 0)
    assert _setup_model(rays[:, :0], sup, 8, None, 32).shape == (256, 0)


# ---------------------------------------------------------------------------
# against the JAX package (the Pallas kernels in interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w,k", SHAPES)
def test_select_model_matches_jax(w, k):
    import jax.numpy as jnp

    from echorenderer_tpu.ops import binned_trace as jbt

    n = 1024
    cand, nk, best_t, refill = _select_inputs(w, k, n, seed=k, dup=True)
    jcand = jnp.asarray(cand.reshape(w, n // 1024, 8, 128).transpose(1, 0, 2, 3))
    j_new, j_pop, j_live, j_mink = jbt._run_select(jcand, jnp.asarray(nk), jnp.asarray(best_t),
                                                   jnp.asarray(refill), k, 12)
    max_w, g = next(f for f in SELECT_FORMS if w <= f[0])  # the form the C entry takes
    got_c, pop, live, mink = _select_model(*_torch(cand, nk, best_t, refill), k, 12, g,
                                           max_w=max_w)
    np.testing.assert_array_equal(got_c.numpy(),
                                  np.asarray(j_new).transpose(1, 0, 2, 3).reshape(w, n))
    np.testing.assert_array_equal(pop.numpy(), np.asarray(j_pop))
    np.testing.assert_array_equal(live.numpy(), np.asarray(j_live))
    np.testing.assert_array_equal(mink.numpy(), np.asarray(j_mink))


@pytest.mark.parametrize("cap", [None, 32])
def test_setup_model_matches_jax(cap):
    import jax.numpy as jnp

    from echorenderer_tpu.ops import binned_trace as jbt

    n, s_count = 1024, 37
    rays, sup, _, _ = _setup_inputs(n, s_count, seed=8)
    sbits = max(1, (s_count - 1).bit_length())
    r = rays.numpy()
    want = np.asarray(jbt._setup_rank(jnp.asarray(r[0:3].T), jnp.asarray(r[3:6].T),
                                      jnp.asarray(sup.numpy()), jnp.asarray(r[6]), sbits,
                                      cap=cap))
    for g in (16, 4):
        np.testing.assert_array_equal(_setup_model(rays, sup, sbits, cap, g).numpy(), want)


# ---------------------------------------------------------------------------
# the CUDA kernels (skip without a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the binned CUDA kernels need an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("w,k,n", [SHAPES[0] + (2_073_600,), SHAPES[1] + (259_200,),
                                   SHAPES[2] + (16_384,), SHAPES[2] + (1000,), (600, 8, 777),
                                   (5, 1, 70), (67, 67, 33), (1, 1, 5), (512, 32, 300),
                                   (513, 4, 300), (200, 200, 64)])
def test_cuda_select_matches_plain(cuda, w, k, n):
    """The traversal's three shapes at their ray counts, ray counts off the
    block, the shared-memory form (w above 512), k = 1 and k = w; each on
    plain, duplicate, dense and signed inputs."""
    for seed, kind in enumerate(({}, dict(dup=True), dict(dense=True), dict(negative=True))):
        cand, nk, best_t, refill = (torch.as_tensor(a, device=cuda)
                                    for a in _select_inputs(w, k, n, seed, **kind))
        c2 = cand.clone()
        got = bt.select(cand, nk, best_t, refill, k, 12)
        want = bt.select_plain(c2, nk, best_t, refill, k, 12)
        assert torch.equal(cand, c2), kind
        for a, b in zip(got, want):
            assert torch.equal(a, b), kind
    occ = bt.select_occupancy(w, k)
    assert occ["blocks"] > 0 and (occ["group"] == 0) == (w > 512)


@pytest.mark.cuda
@pytest.mark.parametrize("n,s_count,cap", [(2_073_600 // 4, 245, 32), (259_200, 245, None),
                                           (16_384, 245, None), (1000, 245, None), (333, 512, None),
                                           (333, 5, None), (70, 245, 1), (70, 100, 3), (1, 1, None),
                                           (0, 245, None)])
def test_cuda_setup_matches_plain(cuda, n, s_count, cap):
    rays, sup, _, _ = _setup_inputs(max(n, 1), s_count, seed=n % 97)
    rays, sup = rays[:, :n].contiguous().to(cuda), sup.to(cuda)
    sbits = max(1, (s_count - 1).bit_length())
    got = bt.setup_rank(rays, sup, sbits, cap)
    assert torch.equal(got, bt.setup_rank_plain(rays, sup, sbits, cap))
    occ = bt.setup_occupancy(s_count, got.shape[0])
    assert occ["blocks"] > 0
