"""Binned traversal for large scenes (counterpart of
echorenderer_tpu/ops/binned_trace.py).

Each ray culls on its own, and the intersection work is what gets batched:

1. Setup (`setup_rank`): per ray, slab-test every superchunk box (SUP
   consecutive chunks of the hier pack, in BVH-leaf order) and keep the
   ray's supers sorted by entry t, as packed i32 keys (entry t's f32 bits
   with the low `sbits` replaced by the super id).
2. Rounds. A ray low on candidates examines its next KSUP supers (the
   refill: slab-test their chunks, packed (entry t, chunk) keys);
   `select` purges the candidates the best t has passed, merges the new
   keys, and pops the k nearest. The (ray, chunk) pairs are sorted
   chunk-major and each pair tests every prim of its chunk (`seg_keys`):
   one packed i32 per pair, the f32 bits of its least t with the low
   _PBITS replaced by the prim-in-chunk index. A ray keeps the least key.
3. The straggler cascade: after FULL_ROUNDS full-width rounds the rays
   still pending restart in narrower sub-problems with wider pops and
   refills (a bounded mid stage from CASCADE_MIN rays on, then a final
   stage that runs until nothing pends).
4. Exact recovery: the winning key names the prim; it is tested once more
   with `pallas_intersect._chunk_hits`, so t, u and v are those the hier
   walk and the dense kernels report for that prim.

TLAS-instanced scenes traverse the scene unrolled into global chunks
(`HierSoA.binned_g2c` / `binned_g2i` / `binned_wcb`: each instance's pack
chunks, padded to SUP, with world boxes): setup, refill and select run on
the world boxes and global chunk ids, and the pairs sort by global chunk.
`seg_keys` maps each pair's global chunk to its pack chunk and instance,
moves the pair's world ray into that instance's space (the affine of
`pallas_hier.to_instance`; t stays the world parameter, spheres take the
full quadratic) and skips the ray's ignored prim only inside the ray's
own instance (`ign_inst`). Recovery does the same for the winner and
returns its instance.

Keys truncate t, which rounds it down, and every cap fed back is the
truncation band's upper bound, so no chunk that could hold a closer hit is
skipped. Two hits whose t fall in one band (2^-15 relative) resolve by key:
the lower prim-in-chunk index, the lowest chunk within a round, and the
earlier round across rounds. That may pick another prim than the hier
walk's least (t, sorted slot); the t of both lie in one band.

On a CUDA tensor each of the three kernel wrappers launches its
hand-written kernel in csrc/binned.cu (built with nvcc on first use,
ops/cuda_build.py); on a CPU tensor it runs the plain PyTorch version
beside it. They replace the TPU's `_setup_kernel`, `_select_kernel` and
`_seg_kernel` (keyed and exact, both forms) of
echorenderer_tpu/ops/binned_trace.py (:552, :402, :117). The exact form,
`seg_hits` (one (t, prim, u, v) per pair, as `_pack_and_intersect(...,
keyed=False)`), is reached through `_Walk.pairs(..., keyed=False)`; as in
the JAX package, the traversal itself never calls it. The refill, the pair
sort and the record gather stay PyTorch ops, as they are XLA ops in the
JAX package. The engine is the JAX
package's fused one (a ray's refill decision is the previous round's) at
any ray count. Each round reads one flag back to the host. The host
counters are `utils.diagnostics`' registry: `binned.calls`,
`binned.rounds`, the reads `reads.binned_any` and `reads.binned_compact`,
and the wrappers' kernel launches, `launches.binned_setup`,
`launches.binned_select`, `launches.binned_seg` and
`launches.binned_seg_exact` (`_instanced` on the pairs of an instanced
scene). Each refill, round and compaction is an `echo.binned.*` span.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import diagnostics
from . import cuda_build
from .intersect import INF, FlatGeometry, Hit
from .pallas_hier import HCHUNK, HierSoA, _ignore_inst, _sorted_ignore, to_instance
from .pallas_intersect import _chunk_hits, _safe_inv, ray_columns

_INF = 3.4e38
_INT_INF = 2**31 - 1  # key-space sentinel: empty candidate / consumed super
_PBITS = 8  # prim-in-chunk bits in a result key (HCHUNK == 256)
# pairs a block of the seg kernel: csrc/binned.cu's kSegPairs (2 warps, each
# taking a tile of 32 consecutive pairs run by run); the launch refuses another
ROW = 64
SUP = 16  # chunks per superchunk (two-level selection)
KSUP = 4  # superchunks examined per ray per refill (full-width phase)
TAIL_KSUP = 16  # ... final straggler phase
FULL_ROUNDS = 2  # full-width rounds before straggler compaction
COMPACT_FRACTION = 16  # below CASCADE_MIN rays: one final stage of width n / this
CASCADE_MIN = 2**18  # from here: a bounded mid stage, then the final stage
MID_FRACTION = 8
MID_K = 16
MID_KSUP = 8
MID_ROUNDS = 1
FINAL_FRACTION = 128
ORD_CAP = 32  # nearest supers stored per ray in the full-width phase
K = 4  # chunks popped per ray per round (full-width phase)
K_STRAGGLER = 32  # ... final straggler phase
MAX_ROUNDS = 4096  # safety cap on the rounds of a phase that runs to its end
SETUP_MAX_PAD = 512  # padded super count the setup kernel takes; above, a torch row sort
PLAIN_SLICE = 2**16  # rays (setup) or pairs (seg) per pass of the plain versions

# the rays whose winning prim missed on re-evaluation, a correctness tally
# (a device tensor: reading it syncs, so callers read it when they want it)
STATS = dict(misses=0)


# ----------------------------------------------------------------------------
# key packing
# ----------------------------------------------------------------------------


def _bits(x):
    return x.contiguous().view(torch.int32)


def _floats(x):
    return x.contiguous().view(torch.float32)


def _enc(t, ids, bits):
    """Monotone (t, id) key: t clamped at 0 (t > 0 ? t : 0, so -0.0 packs as
    0) with its low `bits` cleared (rounds t down) and the id in them;
    _INT_INF where t >= _INF."""
    tb = _bits(torch.where(t > 0.0, t, 0.0))
    key = (tb & -(1 << bits)) | ids
    return torch.where(t < _INF, key, _INT_INF)


def _dec_t(key, bits):
    f = _floats(key & -(1 << bits))
    return torch.where(key == _INT_INF, _INF, f)


def _key_ub(key):
    """Upper bound of a packed result key's truncation band: the least f32
    provably >= the exact t it was packed from."""
    f = _floats((key & -(1 << _PBITS)) + (1 << _PBITS))
    return torch.where(key == _INT_INF, _INF, f)


def _bf16_round(x, *, up: bool):
    """Directed f32 -> bf16 rounding (values returned as f32): toward +inf
    with `up`, else toward -inf, saturating at the largest finite bf16."""
    bits = _bits(x.to(torch.float32))
    trunc = bits & -0x10000  # toward zero (sign-magnitude)
    neg = bits < 0
    grow = ((bits & 0xFFFF) != 0) & (~neg if up else neg)
    out = torch.where(grow, trunc + 0x10000, trunc)
    capped = torch.where((out & 0x7FFFFFFF) > 0x7F7F0000,
                         (out & -0x80000000) | 0x7F7F0000, out)
    return _floats(capped)


def _slab_all(o, d, cb, limit):
    """(N, C) box entry t of every box of `cb` (C, 6); _INF where the ray
    misses it or enters at or beyond `limit` (N,). The raw entry t, which
    is negative for an origin inside the box."""
    inv = _safe_inv(d)
    tn = tf = None
    for a in range(3):
        t0 = (cb[None, :, a] - o[:, a:a + 1]) * inv[:, a:a + 1]
        t1 = (cb[None, :, 3 + a] - o[:, a:a + 1]) * inv[:, a:a + 1]
        tn_a, tf_a = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = tn_a if tn is None else torch.maximum(tn, tn_a)
        tf = tf_a if tf is None else torch.minimum(tf, tf_a)
    ok = (tn <= tf) & (tf > 0.0) & (tn < limit[:, None])
    return torch.where(ok, tn, _INF)


def _super_pad(s_count: int) -> int:
    return max(8, 1 << (s_count - 1).bit_length())


# ----------------------------------------------------------------------------
# plain PyTorch versions of the three kernels (the CPU path, and the card's
# reference)
# ----------------------------------------------------------------------------


def setup_rank_plain(rays, sup_cb, sbits, cap=None):
    """Plain PyTorch super order: (s_out, N) int32, per ray its super keys
    ascending, _INT_INF past its eligible supers."""
    s_count = sup_cb.shape[0]
    s_pad = _super_pad(s_count)
    s_out = s_pad if cap is None else min(s_pad, cap)
    ids = torch.arange(s_count, dtype=torch.int32, device=rays.device)
    outs = []
    for s in range(0, max(rays.shape[1], 1), PLAIN_SLICE):
        r = rays[:, s: s + PLAIN_SLICE]
        keys = _enc(_slab_all(r[0:3].T, r[3:6].T, sup_cb, r[6]), ids[None], sbits)
        srt = torch.sort(keys, dim=1).values[:, :s_out]
        fill = srt.new_full((srt.shape[0], s_out - srt.shape[1]), _INT_INF)
        outs.append(torch.cat([srt, fill], dim=1).T)
    return torch.cat(outs, dim=1).contiguous()


def _select_merge(cand, new_keys, best_t, do_refill, k, cbits):
    """select's buffer (w, N) after its purge and, for a refilling ray, the
    merge [its k-1 least distinct keys | new_keys]: what the pops take from.
    `cand` is left as it was."""
    tmask = -(1 << cbits)
    c = torch.where((cand & tmask) < _bits(best_t)[None], cand, _INT_INF)
    refill = do_refill[None]
    ext = []
    for _ in range(k - 1):  # a refilling ray holds < k live keys: all of them
        mn = c.amin(0)
        ext.append(mn)
        c = torch.where(refill & (c == mn[None]), _INT_INF, c)
    head = [torch.where(refill, torch.stack(ext), c[:k - 1])] if ext else []
    return torch.cat(head + [torch.where(refill, new_keys, c[k - 1:])])


def select_plain(cand, new_keys, best_t, do_refill, k, cbits):
    """Plain PyTorch candidate maintenance: updates `cand` (w, N) in place,
    returns (pop (k, N), live (N,), mink (N,)), all int32."""
    c = _select_merge(cand, new_keys, best_t, do_refill, k, cbits)
    pops = []
    for _ in range(k):
        mn = c.amin(0)
        pops.append(mn)
        c = torch.where(c == mn[None], _INT_INF, c)
    cand.copy_(c)
    return torch.stack(pops), (c != _INT_INF).sum(0, dtype=torch.int32), c.amin(0)


def _pair_hits(rec, chunk, prim_chunks, has_tri, has_sph, inst):
    """The plain seg kernels' shared part: per slice of the live pairs (t_max
    > 0, a valid chunk), (pair indices, pack chunks (M,), t, u, v (M,
    HCHUNK), valid: a hit below t_max). With `inst` = (g2c, g2i, inst_f32)
    the chunks are global: each pair tests its pack chunk in its instance's
    space, and rec's column 8 is the ignore's instance."""
    n_chunks = prim_chunks.shape[0] if inst is None else inst[0].shape[0]
    ok_pair = (rec[:, 6] > 0.0) & (chunk >= 0) & (chunk < n_chunks)
    live = torch.nonzero(ok_pair).squeeze(1)
    for s in range(0, live.numel(), PLAIN_SLICE):
        idx = live[s: s + PLAIN_SLICE]
        c = chunk[idx].long()
        r = rec[idx].T
        ray, ign = r, r[7]
        if inst is not None:
            g2c, g2i, inst_f32 = inst
            ii = g2i[c]
            c = g2c[c].long()
            ray = torch.cat(to_instance(inst_f32, ii, r[0:3], r[3:6]))
            ign = torch.where(r[8] == ii.to(torch.float32), ign, -1.0)
        rows = prim_chunks[c, :10, :].permute(1, 0, 2)  # (10, M, HCHUNK)
        t, u, v, ok = _chunk_hits(rows, c * HCHUNK, ray, ign.to(torch.int32), has_tri, has_sph,
                                  unit_dir=inst is None)
        yield idx, c, t, u, v, ok & (t < r[6][:, None]) & (t < _INF)


def seg_keys_plain(rec, chunk, prim_chunks, has_tri, has_sph, inst=None):
    """Plain PyTorch pair keys: for each pair (ray record, chunk) with
    t_max > 0, the least (bits(t) & ~0xFF) | prim-in-chunk over the
    chunk's hits with t < t_max; _INT_INF otherwise. With `inst` = (g2c,
    g2i, inst_f32) the chunks are global: each pair tests its pack chunk in
    its instance's space, and rec's column 8 is the ignore's instance."""
    out = torch.full((rec.shape[0],), _INT_INF, dtype=torch.int32, device=rec.device)
    local = torch.arange(HCHUNK, dtype=torch.int32, device=rec.device)[None]
    for idx, _, t, _, _, valid in _pair_hits(rec, chunk, prim_chunks, has_tri, has_sph, inst):
        key = torch.where(valid, (_bits(t) & -(1 << _PBITS)) | local, _INT_INF)
        out[idx] = key.amin(1)
    return out


def seg_hits_plain(rec, chunk, prim_chunks, has_tri, has_sph, inst=None):
    """Plain PyTorch exact pair results, the inputs of `seg_keys_plain`:
    (t, prim, u, v), each (M,) float32. For each pair the least t below
    t_max over its chunk's hits, ties to the least sorted slot; prim is that
    slot (of the pack chunk on an instanced pack) as a float. A pair without
    a hit, a dead one included, keeps (t_max, -1, 0, 0)."""
    m = rec.shape[0]
    out = torch.zeros((4, m), dtype=torch.float32, device=rec.device)
    out[0] = rec[:, 6]
    out[1] = -1.0
    local = torch.arange(HCHUNK, device=rec.device)[None]
    for idx, c, t, u, v, valid in _pair_hits(rec, chunk, prim_chunks, has_tri, has_sph, inst):
        tm = torch.where(valid, t, _INF).amin(1, keepdim=True)
        j = torch.where(valid & (t == tm), local, HCHUNK).amin(1, keepdim=True)
        found = j[:, 0] < HCHUNK
        jj = torch.clamp(j, max=HCHUNK - 1)
        out[:, idx] = torch.where(found[None], torch.stack([
            tm[:, 0], (c * HCHUNK + jj[:, 0]).to(torch.float32),
            u.gather(1, jj)[:, 0], v.gather(1, jj)[:, 0]]), out[:, idx])
    return tuple(out)


# ----------------------------------------------------------------------------
# the CUDA kernels: build, bind, launch
# ----------------------------------------------------------------------------

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load("binned")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.binned_setup.argtypes = [ptr, i32, ptr, i32, i32, i32, ptr, ptr]
        lib.binned_select.argtypes = [ptr, i32, i32, ptr, ptr, ptr, i32, i32, ptr, ptr, ptr, ptr]
        # rec, chunk, m, prim_chunks, valid chunk ids, has_tri, has_sph,
        # pairs a block (ROW), g2c, g2i, inst_f32 (null for a flat scene),
        # out, stream
        seg = [ptr, ptr, i32, ptr, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr]
        lib.binned_seg.argtypes = lib.binned_seg_exact.argtypes = seg
        lib.binned_seg_occupancy.argtypes = [i32, i32, i32, i32, ptr]
        # (s_count, s_out) and (w, k), out[6]
        lib.binned_setup_occupancy.argtypes = lib.binned_select_occupancy.argtypes = [i32, i32, ptr]
        for fn in (lib.binned_setup, lib.binned_select, lib.binned_seg, lib.binned_seg_exact,
                   lib.binned_seg_occupancy, lib.binned_setup_occupancy,
                   lib.binned_select_occupancy):
            fn.restype = i32
        _lib = lib
    return _lib


def _route(name, lead, tensors):
    """'plain' for CPU tensors, 'cuda' for CUDA tensors; raises on mixed
    devices, other devices or non-contiguous inputs."""
    if any(x.device != lead.device for x in tensors):
        raise ValueError(f"{name}: every input must lie on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if lead.device.type == "cpu":
        return "plain"
    if lead.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {lead.device}")
    return "cuda"


def _raise_on(name, err):
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def setup_rank(rays, sup_cb, sbits, cap=None):
    """Per-ray super order of rays (7, N) [o xyz, d xyz, limit] against the
    super boxes sup_cb (S, 6) [lo xyz, hi xyz]: (s_out, N) int32, each
    column ascending, with s_out = the padded super count (a power of two,
    at least 8, at most SETUP_MAX_PAD), or `cap` if smaller. CUDA tensors
    launch the kernel; CPU tensors take the plain version."""
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 7:
        raise ValueError(f"rays must be (7, N) float32, got {tuple(rays.shape)} {rays.dtype}")
    if sup_cb.dtype != torch.float32 or sup_cb.dim() != 2 or sup_cb.shape[1] != 6:
        raise ValueError("sup_cb must be (S, 6) float32")
    s_count = sup_cb.shape[0]
    s_pad = _super_pad(s_count)
    if s_pad > SETUP_MAX_PAD:
        raise ValueError(f"{s_count} supers: the setup kernel takes at most {SETUP_MAX_PAD}")
    if not 1 <= sbits <= 20 or s_count > 1 << sbits:
        raise ValueError(f"sbits {sbits} cannot hold {s_count} super ids")
    if cap is not None and cap < 1:
        raise ValueError("cap must be at least 1")
    if _route("setup_rank", rays, (rays, sup_cb)) == "plain":
        return setup_rank_plain(rays, sup_cb, sbits, cap)
    s_out = s_pad if cap is None else min(s_pad, cap)
    n = rays.shape[1]
    out = torch.empty((s_out, n), dtype=torch.int32, device=rays.device)
    if n:
        err = _load().binned_setup(rays.data_ptr(), n, sup_cb.data_ptr(), s_count, sbits, s_out,
                                   out.data_ptr(), _stream(rays))
        _raise_on("setup_rank", err)
        diagnostics.count("launches.binned_setup")
    return out


def select(cand, new_keys, best_t, do_refill, k, cbits):
    """One round's candidate maintenance, per ray: purge the keys of cand
    (w, N) int32 at or beyond best_t (N,) f32; for rays with do_refill (N,)
    bool, replace the buffer by its k-1 smallest keys and new_keys
    (w-k+1, N) int32; pop the k nearest. cand is updated in place. Returns
    (pop (k, N) ascending, live count (N,), least remaining key (N,)), all
    int32. CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    if cand.dtype != torch.int32 or new_keys.dtype != torch.int32 or cand.dim() != 2:
        raise ValueError("cand and new_keys must be int32 (w, N) and (w-k+1, N)")
    w, n = cand.shape
    if not 1 <= k <= w or new_keys.shape != (w - k + 1, n):
        raise ValueError(f"new_keys must be ({w - k + 1}, {n}) for a buffer of {w} and k {k}")
    if best_t.dtype != torch.float32 or best_t.shape != (n,):
        raise ValueError(f"best_t must be ({n},) float32")
    if do_refill.dtype != torch.bool or do_refill.shape != (n,):
        raise ValueError(f"do_refill must be ({n},) bool")
    if not 1 <= cbits <= 30:
        raise ValueError(f"cbits {cbits} out of range")
    if _route("select", cand, (cand, new_keys, best_t, do_refill)) == "plain":
        return select_plain(cand, new_keys, best_t, do_refill, k, cbits)
    pop = torch.empty((k, n), dtype=torch.int32, device=cand.device)
    live = torch.empty(n, dtype=torch.int32, device=cand.device)
    mink = torch.empty_like(live)
    if n:
        err = _load().binned_select(cand.data_ptr(), w, n, new_keys.data_ptr(), best_t.data_ptr(),
                                    do_refill.data_ptr(), k, cbits, pop.data_ptr(),
                                    live.data_ptr(), mink.data_ptr(), _stream(cand))
        _raise_on("select", err)
        diagnostics.count("launches.binned_select")
    return pop, live, mink


def _seg_route(name, rec, chunk, prim_chunks, inst):
    """The input checks of seg_keys and seg_hits; returns `_route`'s
    answer."""
    width = 8 if inst is None else 9
    if rec.dtype != torch.float32 or rec.dim() != 2 or rec.shape[1] != width:
        raise ValueError(f"rec must be (M, {width}) float32, got {tuple(rec.shape)} {rec.dtype}")
    if chunk.dtype != torch.int32 or chunk.shape != (rec.shape[0],):
        raise ValueError(f"chunk must be ({rec.shape[0]},) int32")
    if prim_chunks.dtype != torch.float32 or prim_chunks.shape[1:] != (16, HCHUNK):
        raise ValueError(f"prim_chunks must be (C, 16, {HCHUNK}) float32")
    if rec.shape[0] >= 2**31:
        raise ValueError("too many pairs for int32 indexing")
    tensors = (rec, chunk, prim_chunks)
    if inst is not None:
        g2c, g2i, inst_f32 = inst
        if g2c.dtype != torch.int32 or g2i.dtype != torch.int32 or g2c.shape != g2i.shape:
            raise ValueError("g2c and g2i must be int32 of one length")
        if inst_f32.dtype != torch.float32 or inst_f32.numel() % 12:
            raise ValueError("inst_f32 must hold 12 floats per instance")
        tensors += (g2c, g2i, inst_f32)
    route = _route(name, rec, tensors)
    if route == "cuda" and inst is None and rec.data_ptr() % 16:
        raise ValueError(f"{name} reads each record as two float4: rec must be 16-byte aligned")
    if route == "cuda" and prim_chunks.data_ptr() % 16:
        raise ValueError(f"{name} copies each run's chunk by a bulk asynchronous copy: "
                         "prim_chunks must be 16-byte aligned")
    return route


def seg_occupancy(keyed: bool, instanced: bool, has_tri: bool, has_sph: bool) -> dict:
    """One seg kernel form's resident blocks per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), its block size,
    dynamic shared memory per block and resident warps per SM."""
    out = (ctypes.c_int * 3)()
    err = _load().binned_seg_occupancy(int(keyed), int(instanced), int(has_tri), int(has_sph),
                                       out)
    _raise_on("binned_seg_occupancy", err)
    return dict(blocks=out[0], block=out[1], smem=out[2], warps=out[0] * out[1] // 32)


def _form_occupancy(query, a, b) -> dict:
    out = (ctypes.c_int * 6)()
    _raise_on(query, getattr(_load(), query)(a, b, out))
    return dict(blocks=out[0], block=out[1], smem=out[2], group=out[3], keys=out[4], sms=out[5],
                warps=out[0] * out[1] // 32)


def setup_occupancy(s_count: int, s_out: int) -> dict:
    """The setup form a launch of `s_count` supers and `s_out` keys a ray
    takes (csrc/binned.cu kSetupForms): its resident blocks per SM, block
    size, dynamic shared memory per block, lanes a ray (1: setup_kernel, a
    thread a ray), resident warps per SM and the card's SMs."""
    return _form_occupancy("binned_setup_occupancy", s_count, s_out)


def select_occupancy(w: int, k: int) -> dict:
    """The select form a launch on a buffer of `w` slots popping `k` takes
    (csrc/binned.cu kSelectForms): as `setup_occupancy`, with lanes a ray 0
    for select_kernel (the shared-memory column) and `keys`, the keys a lane
    of a register form."""
    return _form_occupancy("binned_select_occupancy", w, k)


def _launch_seg(name, rec, chunk, prim_chunks, has_tri, has_sph, inst, out):
    """Launch seg_keys' (name "seg") or seg_hits' ("seg_exact") kernel into
    `out` and count it."""
    if rec.shape[0]:
        fn = getattr(_load(), f"binned_{name}")
        n_chunks, ptrs = (prim_chunks.shape[0], (None, None, None)) if inst is None else (
            inst[0].shape[0], tuple(x.data_ptr() for x in inst))
        err = fn(rec.data_ptr(), chunk.data_ptr(), rec.shape[0], prim_chunks.data_ptr(),
                 n_chunks, int(has_tri), int(has_sph), ROW, *ptrs, out.data_ptr(), _stream(rec))
        _raise_on(name, err)
        diagnostics.count(f"launches.binned_{name}" if inst is None
                          else f"launches.binned_{name}_instanced")
    return out


def seg_keys(rec, chunk, prim_chunks, has_tri, has_sph, inst=None):
    """Packed closest-hit key of every (ray, chunk) pair: rec (M, 8) f32
    [o xyz, d xyz, t_max, sorted-slot ignore], chunk (M,) int32 (pairs
    sorted by chunk share its prim rows), prim_chunks (C, 16, HCHUNK) f32.
    Instanced scenes pass `inst` = (g2c (G,) int32, g2i (G,) int32,
    inst_f32 (I*12,) f32): the chunks are global chunks, and rec (M, 9)
    holds the ignore's instance in column 8. Returns (M,) int32. CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    if _seg_route("seg_keys", rec, chunk, prim_chunks, inst) == "plain":
        return seg_keys_plain(rec, chunk, prim_chunks, has_tri, has_sph, inst)
    out = torch.empty(rec.shape[0], dtype=torch.int32, device=rec.device)
    return _launch_seg("seg", rec, chunk, prim_chunks, has_tri, has_sph, inst, out)


def seg_hits(rec, chunk, prim_chunks, has_tri, has_sph, inst=None):
    """Exact closest hit of every (ray, chunk) pair, the inputs of
    `seg_keys`: (t, prim, u, v), each (M,) float32 (`seg_hits_plain` says
    what they hold). CUDA tensors launch the kernel's exact form; CPU
    tensors take the plain version."""
    if _seg_route("seg_hits", rec, chunk, prim_chunks, inst) == "plain":
        return seg_hits_plain(rec, chunk, prim_chunks, has_tri, has_sph, inst)
    out = torch.empty((4, rec.shape[0]), dtype=torch.float32, device=rec.device)
    return tuple(_launch_seg("seg_exact", rec, chunk, prim_chunks, has_tri, has_sph, inst, out))


# ----------------------------------------------------------------------------
# the traversal: tables, refill, pairs, rounds, cascade, recovery
# ----------------------------------------------------------------------------


class _Tables:
    """Per-call super tables of one chunk-bounds table (C, 6)."""

    def __init__(self, cb):
        dev = cb.device
        c = cb.shape[0]
        self.s_count = s_count = -(-c // SUP)
        c_pad = s_count * SUP
        self.cbits = max(1, (c_pad - 1).bit_length())  # chunk id bits in a candidate key
        self.sbits = max(1, (s_count - 1).bit_length())
        if self.cbits > 20:
            raise ValueError("the chunk-key id field would leave < 3 mantissa bits")
        inf3 = [_INF] * 3
        box_pad = torch.tensor([inf3 + [-_INF] * 3], dtype=torch.float32, device=dev)
        cb_box = torch.cat([cb, box_pad.expand(c_pad - c, 6)])  # neutral for min/max
        self.sup_cb = torch.cat([cb_box[:, 0:3].reshape(s_count, SUP, 3).amin(1),
                                 cb_box[:, 3:6].reshape(s_count, SUP, 3).amax(1)], 1).contiguous()
        # lookup pads: a degenerate box at infinity that no ray enters
        cb_look = torch.cat([cb, torch.full((c_pad - c, 6), _INF, device=dev)])
        base = torch.cat([cb_look[:, a].reshape(s_count, SUP) for a in range(6)], 1)
        # the JAX package's conservative bf16 table: lo rounded down, hi up
        # (its one-hot bf16 matmul fetch is exact; here an index gather)
        self.base = torch.cat([_bf16_round(base[:, :3 * SUP], up=False),
                               _bf16_round(base[:, 3 * SUP:], up=True)], 1).contiguous()
        self.ids = torch.arange(s_count, dtype=torch.int32, device=dev)
        self.in_sup = torch.arange(SUP, dtype=torch.int32, device=dev)[:, None]


def _any(x) -> bool:
    with diagnostics.host_read("binned_any"):
        return bool(x.any())


class _Walk:
    """One traversal call: rays (7, N) contiguous with t_max clamped at
    _INF (`ray_columns`), sorted ignores (N,), the hier pack; instanced
    packs also take each ignore's instance `ign_inst` (N,) (-1: none)."""

    def __init__(self, rays, ign, soa: HierSoA, occlude, ign_inst=None):
        _check_soa(soa, ign_inst)
        diagnostics.count("binned.calls")
        self.rays, self.soa, self.occlude = rays, soa, occlude
        self.ign_f = ign.to(torch.float32)
        # the chunks are global chunks with world boxes on an instanced pack
        cb = soa.binned_wcb if soa.instanced else soa.chunk_bounds
        self.inst = (soa.binned_g2c, soa.binned_g2i, soa.inst_f32) if soa.instanced else None
        self.ii_f = ign_inst.to(torch.float32) if soa.instanced else None
        self.tb = _Tables(cb)
        self.c = cb.shape[0]
        self.kinds = soa.num_tris > 0, soa.num_prims > soa.num_tris

    def order(self, rays_lim, cap):
        """Super order (w_ord, N) of rays whose row 6 is the limit."""
        tb = self.tb
        if _super_pad(tb.s_count) > SETUP_MAX_PAD:  # the JAX package's row sort, uncapped
            keys = _enc(_slab_all(rays_lim[0:3].T, rays_lim[3:6].T, tb.sup_cb, rays_lim[6]),
                        tb.ids[None], tb.sbits)
            return torch.sort(keys, dim=1).values.T.contiguous()
        return setup_rank(rays_lim, tb.sup_cb, tb.sbits, cap)

    def start(self, rays, best_t, best_key, best_chunk, sup_ord, ksup, k):
        first = sup_ord[0]
        pend = _dec_t(first, self.tb.sbits) < best_t
        n = best_t.shape[0]
        return dict(rays=rays, best_t=best_t, best_key=best_key, best_chunk=best_chunk,
                    cursor=torch.zeros(n, dtype=torch.int32, device=best_t.device),
                    next_sup=first, sup_ord=sup_ord, do_refill=pend, pend=pend,
                    cand=torch.full((ksup * SUP + k - 1, n), _INT_INF, dtype=torch.int32,
                                    device=best_t.device))

    def refill(self, st, ksup):
        """Each refilling ray's next `ksup` supers: candidate keys of their
        eligible chunks (ksup*SUP, N), slot-major; the advanced cursor; the
        next unexamined super's key."""
        tb, rays, sup_ord = self.tb, st["rays"], st["sup_ord"]
        cursor, best_t, do_refill = st["cursor"], st["best_t"], st["do_refill"]
        inv = [_safe_inv(rays[3 + a]) for a in range(3)]
        w_ord = sup_ord.shape[0]
        capped = w_ord < tb.s_count
        last = sup_ord[w_ord - 1]

        def extract(j):
            """Key at position cursor + j of each ray's order, and whether it
            lies past a capped order (then the last stored key, a lower
            bound for every unexamined super)."""
            pj = cursor + j
            kj = sup_ord.gather(0, torch.clamp(pj, max=w_ord - 1).long()[None])[0]
            ovf = pj >= w_ord
            if capped:
                return torch.where(ovf, last, kj), ovf
            return torch.where(ovf, _INT_INF, kj), torch.zeros_like(ovf)

        keys = []
        for j in range(ksup):
            sup_key, ovf = extract(j)
            sup_ok = (do_refill & ~ovf & (sup_key != _INT_INF)
                      & (_dec_t(sup_key, tb.sbits) < best_t))
            sup_sel = torch.where(sup_ok, sup_key & ((1 << tb.sbits) - 1), 0)
            g = tb.base[sup_sel.long()].T  # (6*SUP, N): [lo_x | lo_y | lo_z | hi_x | hi_y | hi_z]
            tn = tf = None
            for a in range(3):
                t0 = (g[a * SUP:(a + 1) * SUP] - rays[a][None]) * inv[a][None]
                t1 = (g[(3 + a) * SUP:(4 + a) * SUP] - rays[a][None]) * inv[a][None]
                tn_a, tf_a = torch.minimum(t0, t1), torch.maximum(t0, t1)
                tn = tn_a if tn is None else torch.maximum(tn, tn_a)
                tf = tf_a if tf is None else torch.minimum(tf, tf_a)
            ok = (tn <= tf) & (tf > 0.0) & (tn < best_t[None]) & sup_ok[None]
            keys.append(_enc(torch.where(ok, tn, _INF), sup_sel[None] * SUP + tb.in_sup, tb.cbits))
        new_cursor = cursor + torch.where(do_refill, ksup, 0).to(torch.int32)
        if capped:  # the cursor parks at the cap
            new_cursor = torch.clamp(new_cursor, max=w_ord)
        next_sup = torch.where(do_refill, extract(ksup)[0], st["next_sup"])
        return torch.cat(keys).contiguous(), new_cursor, next_sup

    def pairs(self, sel_c, rays, best_t, ign_f, ii_f=None, keyed=True):
        """Keys (k, N) of this round's (ray, chunk) pairs (chunk -1: none):
        the pairs sorted chunk-major, their ray records gathered (with the
        ignore's instance on an instanced pack), one seg_keys launch, and
        the results put back in pair order. keyed=False launches seg_hits
        instead and returns its (t, prim, u, v), each (k, N)."""
        kk, n = sel_c.shape
        pc = sel_c.reshape(-1)
        key_s, q_s = torch.sort(torch.where(pc >= 0, pc, self.c), stable=True)
        cols = [rays[0], rays[1], rays[2], rays[3], rays[4], rays[5], best_t, ign_f]
        rec = torch.stack(cols + ([] if ii_f is None else [ii_f]), dim=1)
        g = rec[q_s % n]  # (k*N, 8 or 9) row gather
        live = key_s < self.c
        g[:, 6] = torch.where(live, g[:, 6], 0.0)  # dead pairs: t_max 0
        for col in range(7, g.shape[1]):  # and ignores that match nothing
            g[:, col] = torch.where(live, g[:, col], -2.0)
        args = (g, key_s.contiguous(), self.soa.prim_chunks, *self.kinds)
        if keyed:
            res = seg_keys(*args, inst=self.inst)
            out = torch.empty_like(res)
            out[q_s] = res
            return out.view(kk, n)
        res = torch.stack(seg_hits(*args, inst=self.inst))
        out = torch.empty_like(res)
        out[:, q_s] = res
        return tuple(out.view(4, kk, n))

    def round(self, st, k, ksup):
        """One fused-engine round: refill (last round's decision), select,
        intersect, merge; pend and the next refill from the live count and
        the least remaining key under the new best t."""
        tb = self.tb
        best_t = st["best_t"]
        with diagnostics.span("echo.binned.refill"):
            new_keys, cursor, next_sup = self.refill(st, ksup)
        pop, live, mink = select(st["cand"], new_keys, best_t, st["do_refill"], k, tb.cbits)
        sel_c = torch.where(pop != _INT_INF, pop & ((1 << tb.cbits) - 1), -1)
        pk = self.pairs(sel_c, st["rays"], best_t, st["ign_f"], st["ii_f"])
        out = dict(st, cursor=cursor, next_sup=next_sup)
        if self.occlude:
            new_t = torch.where((pk != _INT_INF).any(0), 0.0, best_t)
        else:
            kmin = pk.amin(0)
            cwin = torch.where(pk == kmin[None], sel_c, 2**30).amin(0)
            better = kmin < st["best_key"]
            out["best_key"] = torch.where(better, kmin, st["best_key"])
            out["best_chunk"] = torch.where(better, cwin, st["best_chunk"])
            new_t = torch.minimum(torch.where(better, _key_ub(kmin), best_t), best_t)
        next_t = _dec_t(next_sup, tb.sbits)
        out["best_t"] = new_t
        out["do_refill"] = (live < k) & (next_t < new_t)
        out["pend"] = (_dec_t(mink, tb.cbits) < new_t) | (next_t < new_t)
        diagnostics.count("binned.rounds")
        return out

    def run(self, st, k, ksup, cap):
        rounds = 0
        while rounds < cap and _any(st["pend"]):
            with diagnostics.span("echo.binned.round"):
                st = self.round(st, k, ksup)
            rounds += 1
        return st

    def compact(self, stf, width, ks, ksup, bounded):
        """Restart the first `width` pending rays (not yet retired) as a
        sub-problem under their current best t, run it (at most `bounded`
        rounds, else to the end), and scatter its results back; a ray
        retires where the sub-run finished it."""
        with diagnostics.host_read("binned_compact"):
            idx = torch.nonzero(stf["pend"] & ~stf["retired"]).squeeze(1)
        take = min(idx.numel(), width)
        dev = idx.device
        idxs = torch.zeros(width, dtype=torch.int64, device=dev)
        idxs[:take] = idx[:take]
        live = torch.arange(width, device=dev) < take  # the rest: copies of ray 0, dead
        rays = self.rays[:, idxs]
        best = torch.where(live, stf["best_t"][idxs], 0.0)
        rays_lim = torch.cat([rays[:6], best[None]]).contiguous()
        sub = self.start(rays, best, stf["best_key"][idxs], stf["best_chunk"][idxs],
                         self.order(rays_lim, None), ksup, ks)
        sub["ign_f"] = self.ign_f[idxs]
        sub["ii_f"] = None if self.ii_f is None else self.ii_f[idxs]
        done = self.run(sub, ks, ksup, MAX_ROUNDS if bounded is None else bounded)
        out = dict(stf)
        tgt = idxs[:take]
        for f in ("best_t", "best_key", "best_chunk"):
            out[f] = stf[f].index_put((tgt,), done[f][:take])
        finished = live & ~done["pend"]
        out["retired"] = stf["retired"].index_put((idxs[finished],),
                                                  torch.ones((), dtype=torch.bool, device=dev))
        return out

    def traverse(self):
        rays = self.rays
        n = rays.shape[1]
        best_t0 = rays[6]  # the setup's limit too
        nc = min(n, max(1024, -(-(n // COMPACT_FRACTION) // 1024) * 1024))
        st = self.start(rays, best_t0, torch.full((n,), _INT_INF, dtype=torch.int32,
                                                  device=rays.device),
                        torch.full((n,), -1, dtype=torch.int32, device=rays.device),
                        self.order(rays, ORD_CAP if nc < n else None), KSUP, K)
        st["ign_f"], st["ii_f"] = self.ign_f, self.ii_f
        st = self.run(st, K, KSUP, FULL_ROUNDS if nc < n else MAX_ROUNDS)
        if nc < n:
            st["retired"] = torch.zeros(n, dtype=torch.bool, device=rays.device)
            if n >= CASCADE_MIN:
                if _any(st["pend"] & ~st["retired"]):
                    mid_w = -(-(n // MID_FRACTION) // 1024) * 1024
                    with diagnostics.span("echo.binned.compact"):
                        st = self.compact(st, mid_w, MID_K, MID_KSUP, MID_ROUNDS)
                final_w = max(1024, -(-(n // FINAL_FRACTION) // 1024) * 1024)
            else:
                final_w = nc
            outer, outer_cap = 0, (n // final_w + 2) * 4
            while outer < outer_cap and _any(st["pend"] & ~st["retired"]):
                with diagnostics.span("echo.binned.compact"):
                    st = self.compact(st, final_w, K_STRAGGLER, TAIL_KSUP, None)
                outer += 1
        if self.occlude:
            return (best_t0 > 0.0) & (st["best_t"] <= 0.0)
        return self.recover(st)

    def recover(self, st):
        """Exact (t, sorted slot, u, v) of each ray's winning prim, tested
        again with `_chunk_hits` (on an instanced pack in the winner's
        instance space, and its instance as a fifth output); a winner whose
        test now misses keeps the hit at its key's band lower bound (counted
        in STATS["misses"])."""
        bk = st["best_key"]
        found = bk != _INT_INF
        win = torch.where(found, st["best_chunk"], 0).long()
        j = torch.where(found, bk & ((1 << _PBITS) - 1), 0).long()
        ray, ign = self.rays, self.ign_f
        if self.inst is not None:
            g2c, g2i, inst_f32 = self.inst
            win_i = g2i[win]
            win = g2c[win].long()
            ray = torch.cat(to_instance(inst_f32, win_i, ray[0:3], ray[3:6]))
            ign = torch.where(self.ii_f == win_i.to(torch.float32), ign, -1.0)
        slot = (win * HCHUNK + j).to(torch.int32)
        rows = self.soa.prim_chunks[win, :10, j].T[:, :, None]  # (10, N, 1)
        t, u, v, ok = (x[:, 0] for x in _chunk_hits(rows, slot, ray, ign.to(torch.int32),
                                                    *self.kinds, unit_dir=self.inst is None))
        band_lb = _floats(bk & -(1 << _PBITS))
        STATS["misses"] = STATS["misses"] + (found & ~ok).sum()
        hit = found & ok
        out = (torch.where(found, torch.where(ok, t, band_lb), _INF),
               torch.where(found, slot, -1), torch.where(hit, u, 0.0), torch.where(hit, v, 0.0))
        if self.inst is not None:
            out += (torch.where(found, win_i, 0),)
        return out


def _check_soa(soa: HierSoA, ign_inst):
    if soa.instanced and soa.binned_g2c.numel() == 0:
        raise ValueError("this instanced pack has no binned tables (more than 2**20 global "
                         "chunks): trace it with the walk")
    if soa.instanced != (ign_inst is not None):
        raise ValueError("ign_inst goes with instanced packs, and only with them")


def trace_binned(geom: FlatGeometry, soa: HierSoA, o, d, t_max, ignore, ignore_inst=None) -> Hit:
    """Closest hit through the binned traversal; the contract of
    `pallas_hier.intersect_hier` (original prim ids, findFar, t = INF and
    prim = -1 on a miss; `Hit.inst` the hit's instance, zeros without
    instancing; an instanced pack honours per-instance ignores)."""
    ignore = torch.as_tensor(ignore, device=o.device)
    out = _Walk(ray_columns(o, d, t_max), _sorted_ignore(soa, ignore), soa, False,
                _ignore_inst(soa, ignore, ignore_inst, missing=0)).traverse()
    t, p, u, v = out[:4]
    prim = torch.where(p >= 0, soa.order[torch.clamp(p, min=0)], -1).to(torch.int32)
    found = prim >= 0
    inst = torch.where(found, out[4], 0) if soa.instanced else torch.zeros_like(prim)
    return Hit(t=torch.where(found, t, INF), prim=prim, uv=torch.stack([u, v], dim=-1),
               inst=inst)


def occlude_binned(geom: FlatGeometry, soa: HierSoA, o, d, t_max, ignore,
                   ignore_inst=None) -> torch.Tensor:
    """Any hit in (EPS, t_max) through the binned traversal; the contract of
    `pallas_hier.occlude_hier`."""
    ignore = torch.as_tensor(ignore, device=o.device)
    return _Walk(ray_columns(o, d, t_max), _sorted_ignore(soa, ignore), soa, True,
                 _ignore_inst(soa, ignore, ignore_inst, missing=0)).traverse()
