"""PyTorch port: the Plücker micro-benchmark (kernels 8 and 9) against the
JAX package's script, benchmarks/plucker_micro.py.

That script cannot be imported by a test: it calls `main()` at import,
which runs 2^20 rays, and sets a process-wide compile-cache dir first. So
`_jax_script` compiles its AST without the top-level call statements
(`sys.path.insert`, the two `jax.config.update`, `main()`); its functions
then run here as the script defines them, its Pallas kernels in interpret
mode. The inputs are the script's own draws (`micro_scene`, 8,192 rays
against the 256-triangle soup), handed to both as numpy arrays, and both
frames use one center.

- `keys_mt_plain` against `kern_mt` and `keys_plk_plain(..., "highest")`
  against `make_kern_plk(HIGHEST)`, in the scene frame and the chunk-local
  frame: the same prim wherever both hit and no hit/miss flip; keys differ
  only in their band bits (bits(t) & ~0xFF), where XLA's fused
  multiply-adds move t across a band edge that the port's op-by-op
  rounding does not (measured at 8,192 rays: MT 10 keys of 1,512 hits,
  Plücker 32 scene-frame and 13 chunk-local; bounded below at about twice
  that).
- `build_plk` against the script's `build_plk` to atol 1e-6 (measured 0).
- `keys_plk_plain(..., "default")`, the TPU's one bf16 pass, has no JAX
  counterpart on the CPU: JAX's CPU backend computes DEFAULT at full
  precision. It is held to the highest form: the same prim (or the same
  miss) on at least 95% of rays (measured 96.35% scene-frame, 98.17%
  chunk-local).
- `keys_plk_plain` without the JAX kernel's products against two literal
  zeros (rows 6:8 of the edge groups) gives the keys of the old 8-term
  sums, kept here as `_keys_plk_plain_8term`, at both precisions.
- `default_within_contract`, the DEFAULT kernel's contract with its plain
  version: it holds for keys whose sums are exactly rounded (float64,
  rounded once: another order of the same bf16 products, as a tensor
  core's), and fails on one prim flip per 1,000 rays, on hit/miss flips
  and on a key two t bands off; its max_abs measures t gaps only, not
  flips.
- `inside_pairs` (the pairs the bound charges the plane and the division)
  against the sign test of the old 8-term sums.
- The module's `main()` at `--device cpu`, and its refusal without a card.
- The CUDA kernels are held to their plain versions on the card, MT and
  HIGHEST bitwise, DEFAULT by `default_within_contract`:

    python -m pytest --noconftest tests/test_torch_plucker.py -k cuda
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from echorenderer_tpu_torch.benchmarks import plucker_micro as pm
from echorenderer_tpu_torch.utils import diagnostics

torch.set_num_threads(1)

N = 8192
SCRIPT = Path(__file__).resolve().parents[1] / "benchmarks" / "plucker_micro.py"
# the most keys allowed to differ from the JAX script's, in band bits only
BAND_DIFF_MAX = {"mt": 24, "scene-frame": 64, "chunk-local": 32}
DEFAULT_SAME_PRIM = 0.95


def _jax_script():
    """The JAX script's functions, its top-level call statements left out."""
    tree = ast.parse(SCRIPT.read_text())
    tree.body = [s for s in tree.body
                 if not (isinstance(s, ast.Expr) and isinstance(s.value, ast.Call))]
    ns = {"__name__": "jax_plucker_micro"}
    exec(compile(tree, str(SCRIPT), "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def micro():
    """The inputs in both packages, and the JAX script's keys: MT in the
    scene frame, Plücker HIGHEST in both frames."""
    import jax
    import jax.numpy as jnp

    js = _jax_script()
    prims, cols = pm.micro_scene(N)
    center = prims[0:3].mean(1)
    local, _ = pm.local_frame(prims, cols, center)
    g = N // 1024
    jcols = lambda c: tuple(jnp.asarray(x.numpy().reshape(g, 8, 128)) for x in c)
    pj = jnp.asarray(prims.numpy())
    hi = js["make_kern_plk"](jax.lax.Precision.HIGHEST)
    frames = {"scene-frame": (None, cols), "chunk-local": (center, local)}
    ref = {"mt": np.asarray(js["run"](js["kern_mt"], pj, jcols(cols), g, True)).ravel()}
    tables = {}
    for frame, (c, cc) in frames.items():
        jplk = js["build_plk"](pj, None if c is None else jnp.asarray(c.numpy()))
        tables[frame] = np.asarray(jplk)
        ref[frame] = np.asarray(js["run"](hi, jplk, jcols(cc), g, True)).ravel()
    return dict(prims=prims, cols=cols, frames=frames, ref=ref, tables=tables)


def _keys_plk_plain_8term(plk, cols, prec):
    """`keys_plk_plain` as it was: the edge volumes as 8-term sums over rows
    0:8 of groups 0..2 against [d, m, 0, 0], left to right."""
    rnd = pm._bf16 if prec == "default" else (lambda x: x)
    lhs = rnd(plk)
    H = pm.H
    edge, den_l, num_l = lhs[0:8, 0:3 * H], lhs[0:3, 3 * H:4 * H], lhs[6:10, 4 * H:5 * H]
    ox, oy, oz, dx, dy, dz, tm, ig = cols
    zero = torch.zeros_like(ox)
    ra = [rnd(x) for x in (dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz,
                           ox * dy - oy * dx)] + [zero, zero]
    rc = [rnd(ox), rnd(oy), rnd(oz), torch.ones_like(ox)]
    return _keys_from(pm._dot(edge, ra), pm._dot(num_l, rc) / pm._dot(den_l, ra[:3]), tm, ig)


def _keys_from(w, t, tm, ig):
    """The plain version's keys from the (3H, N) edge volumes and (H, N) t."""
    H = pm.H
    w0, w1, w2 = w[0:H], w[H:2 * H], w[2 * H:3 * H]
    inside = ((torch.minimum(torch.minimum(w0, w1), w2) >= 0.0)
              | (torch.maximum(torch.maximum(w0, w1), w2) <= 0.0))
    pid = torch.arange(H, dtype=torch.int32)[:, None]
    valid = inside & (t > pm._EPS) & (t < tm[None]) & (pid != ig.to(torch.int32)[None])
    return torch.where(valid, (pm._bits(t) & -(1 << pm._PBITS)) | pid, pm._INT_INF).amin(0)


def _keys_default_exact(plk, cols):
    """DEFAULT keys with every sum of the bf16 products exactly rounded:
    summed in float64 (the products are exact there) and rounded to f32
    once; t = num / den in f32."""
    H = pm.H
    lhs = pm._bf16(plk).double()
    ox, oy, oz, dx, dy, dz, tm, ig = cols
    ra = [pm._bf16(x).double() for x in (dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz,
                                         ox * dy - oy * dx)]
    rc = [pm._bf16(x).double() for x in (ox, oy, oz)] + [torch.ones_like(ox).double()]
    dot = lambda rows, r: sum(rows[k][:, None] * r[k][None] for k in range(len(r))).float()
    w = dot(lhs[0:6, 0:3 * H], ra)
    t = dot(lhs[6:10, 4 * H:5 * H], rc) / dot(lhs[0:3, 3 * H:4 * H], ra[:3])
    return _keys_from(w, t, tm, ig)


def _assert_band_only(got, want, most):
    """Keys equal but for band bits; the same hits and prims."""
    hit = want != pm._INT_INF
    np.testing.assert_array_equal(got != pm._INT_INF, hit)
    np.testing.assert_array_equal(got[hit] & 0xFF, want[hit] & 0xFF)
    differ = got != want
    assert differ.sum() <= most, f"{differ.sum()} keys differ (at most {most})"
    assert hit.sum() > 1000
    return int(differ.sum())


def test_mt_plain_matches_jax(micro):
    got = pm.keys_mt_plain(micro["prims"], micro["cols"]).numpy()
    _assert_band_only(got, micro["ref"]["mt"], BAND_DIFF_MAX["mt"])


@pytest.mark.parametrize("frame", pm.FRAMES)
def test_plk_plain_matches_jax(micro, frame):
    center, cols = micro["frames"][frame]
    plk = pm.build_plk(micro["prims"], center)
    np.testing.assert_allclose(plk.numpy(), micro["tables"][frame], rtol=0, atol=1e-6)
    got = pm.keys_plk_plain(plk, cols, "highest").numpy()
    _assert_band_only(got, micro["ref"][frame], BAND_DIFF_MAX[frame])


@pytest.mark.parametrize("frame", pm.FRAMES)
def test_default_precision_near_highest(micro, frame):
    """The bf16 form against the f32 form: the same prim or the same miss
    on at least DEFAULT_SAME_PRIM of the rays, and it differs somewhere (so
    the operands really were rounded)."""
    center, cols = micro["frames"][frame]
    plk = pm.build_plk(micro["prims"], center)
    hi = pm.keys_plk_plain(plk, cols, "highest").numpy()
    lo = pm.keys_plk_plain(plk, cols, "default").numpy()
    prim = lambda k: np.where(k != pm._INT_INF, k & 0xFF, -1)
    same = prim(lo) == prim(hi)
    assert same.mean() >= DEFAULT_SAME_PRIM and (lo != hi).any()


@pytest.mark.parametrize("prec", pm.PRECISIONS)
@pytest.mark.parametrize("frame", pm.FRAMES)
def test_plain_without_zero_operands_matches_8term(micro, frame, prec):
    """Dropping the products against the literal zeros leaves every key."""
    center, cols = micro["frames"][frame]
    plk = pm.build_plk(micro["prims"], center)
    got = pm.keys_plk_plain(plk, cols, prec)
    assert torch.equal(got, _keys_plk_plain_8term(plk, cols, prec))
    assert int((got != pm._INT_INF).sum()) > 1000


@pytest.mark.parametrize("frame", pm.FRAMES)
def test_default_contract_holds_on_exactly_rounded_sums(micro, frame):
    """The contract admits the same bf16 products summed in another order."""
    center, cols = micro["frames"][frame]
    plk = pm.build_plk(micro["prims"], center)
    plain = pm.keys_plk_plain(plk, cols, "default")
    ok, counts = pm.default_within_contract(_keys_default_exact(plk, cols), plain)
    assert ok, counts
    assert counts["rays"] == N and counts["prim_flips"] == counts["hit_flips"] == 0
    assert pm.default_within_contract(plain, plain) == (True, dict(
        rays=N, differ=0, prim_flips=0, hit_flips=0, off_band=0, max_abs=0))


@pytest.mark.parametrize("fault", ["prim flips", "hit/miss flips", "two bands off"])
def test_default_contract_rejects(micro, fault):
    """One prim flip or hit/miss flip per 1,000 rays, or a single key two t
    bands off, breaks the contract."""
    plk = pm.build_plk(micro["prims"])
    plain = pm.keys_plk_plain(plk, micro["cols"], "default")
    bad = plain.clone()
    hits = torch.nonzero(plain != pm._INT_INF).flatten()
    some = hits[:: len(hits) // (N // 1000)][: N // 1000]
    if fault == "prim flips":
        bad[some] = (plain[some] & ~0xFF) | ((plain[some] + 1) & 0xFF)
        key = "prim_flips"
    elif fault == "hit/miss flips":
        bad[some] = pm._INT_INF
        key = "hit_flips"
    else:
        some = some[:1]
        bad[some] = plain[some] + 2 * pm.BAND
        key = "off_band"
    ok, counts = pm.default_within_contract(bad, plain)
    assert not ok and counts[key] == len(some) == counts["differ"], counts
    # max_abs is a t gap: flips are counted apart, not measured
    assert counts["max_abs"] == (2 * pm.BAND if key == "off_band" else 0), counts
    # one band off on as many rays passes
    near = plain.clone()
    near[some] = plain[some] + pm.BAND
    assert pm.default_within_contract(near, plain)[0]


@pytest.mark.parametrize("prec", pm.PRECISIONS)
@pytest.mark.parametrize("frame", pm.FRAMES)
def test_inside_pairs_counts_the_sign_test(micro, frame, prec):
    """inside_pairs (the pairs the bound charges the plane and the division)
    counts the pairs whose edge volumes, as the old 8-term sums give them,
    pass the sign test."""
    center, cols = micro["frames"][frame]
    plk = pm.build_plk(micro["prims"], center)
    rnd = pm._bf16 if prec == "default" else (lambda x: x)
    H = pm.H
    ox, oy, oz, dx, dy, dz = cols[0:6]
    zero = torch.zeros_like(ox)
    ra = [rnd(x) for x in (dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz,
                           ox * dy - oy * dx)] + [zero, zero]
    w = pm._dot(rnd(plk)[0:8, 0:3 * H], ra)
    w0, w1, w2 = w[0:H], w[H:2 * H], w[2 * H:3 * H]
    want = int(((torch.minimum(torch.minimum(w0, w1), w2) >= 0.0)
                | (torch.maximum(torch.maximum(w0, w1), w2) <= 0.0)).sum())
    got = pm.inside_pairs(plk, cols, prec)
    assert got == want and 0 < got < N * H // 100


def test_run_keys_and_agreement():
    """run_keys launches nothing on the CPU and gives each frame's keys;
    agreement counts like the JAX script."""
    prims, cols = pm.micro_scene(2048)
    diagnostics.reset_counts()
    keys, inputs = pm.run_keys(prims, cols)
    assert set(keys) == {"mt"} | {f"{f} {p}" for f in pm.FRAMES for p in pm.PRECISIONS}
    assert not any(k.startswith("launches.plucker_") for k in diagnostics.counts())
    local, center = pm.local_frame(prims, cols)
    assert torch.equal(inputs["chunk-local"][1], local)
    assert torch.equal(keys["chunk-local highest"],
                       pm.keys_plk_plain(pm.build_plk(prims, center), local, "highest"))
    a = pm.agreement(keys["mt"], keys["mt"])
    assert a["key_agree"] == 1.0 and a["prim_flips"] == a["hit_flips"] == a["t_rel_max"] == 0.0
    b = pm.agreement(np.array([5, pm._INT_INF], np.int32), np.array([6, 7], np.int32))
    assert b["prim_flips"] == 0.5 and b["hit_flips"] == 0.5 and b["key_agree"] == 0.0


def test_main_runs_on_cpu_and_refuses_without_a_card(capsys, monkeypatch):
    assert pm.main(["--n-log2", "12", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for frame in pm.FRAMES:
        assert f"{frame} HIGHEST: key agree" in out and f"{frame} DEFAULT: key agree" in out
    assert "prim flips 0.00e+00  hit/miss flips 0.00e+00" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pm.main(["--n-log2", "10"]) != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_wrappers_reject_bad_inputs():
    prims, cols = pm.micro_scene(64)
    plk = pm.build_plk(prims)
    with pytest.raises(ValueError, match="prec"):
        pm.keys_plk(plk, cols, "high")
    with pytest.raises(ValueError, match=r"\(10, 256\)"):
        pm.keys_mt(prims[:9], cols)
    with pytest.raises(ValueError, match=r"\(16, 1280\)"):
        pm.keys_plk(prims, cols, "highest")
    with pytest.raises(ValueError, match=r"\(8, N\)"):
        pm.keys_mt(prims, cols[:7])
    with pytest.raises(ValueError, match="contiguous"):
        pm.keys_mt(prims, cols.T.contiguous().T)
    with pytest.raises(ValueError, match="one device"):
        pm.keys_mt(prims, cols.to("meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pm.keys_mt(prims.to("meta"), cols.to("meta"))
    with pytest.raises(ValueError, match=r"two \(N,\) key arrays"):
        pm.default_within_contract(torch.zeros(4, dtype=torch.int32),
                                   torch.zeros(5, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the CUDA kernels (skip without a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the Plücker micro-benchmark's CUDA kernels need an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda):
    """MT and HIGHEST bitwise, DEFAULT (the tensor-core form) by its
    contract, over 100,000 rays (not a multiple of any tile) in both
    frames."""
    prims, cols = pm.micro_scene(100_000, device=cuda)
    diagnostics.reset_counts()
    keys, inputs = pm.run_keys(prims, cols)
    assert {k: v for k, v in diagnostics.counts().items() if k.startswith("launches.plucker_")} \
        == {"launches.plucker_mt": 1, "launches.plucker_plk_highest": 2,
            "launches.plucker_plk_default": 2}
    assert torch.equal(keys["mt"], pm.keys_mt_plain(prims, cols))
    assert int((keys["mt"] != pm._INT_INF).sum()) > 10_000
    for frame, (plk, cc) in inputs.items():
        assert torch.equal(keys[f"{frame} highest"], pm.keys_plk_plain(plk, cc, "highest")), frame
        ok, counts = pm.default_within_contract(keys[f"{frame} default"],
                                                pm.keys_plk_plain(plk, cc, "default"))
        assert ok, (frame, counts)
