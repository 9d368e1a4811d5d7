"""PyTorch port: the wavefront's float math keeps one fixed order.

The megakernel (csrc/megakernel.cu, built with -fmad=false) rounds every
op on its own and sums a vector's components left to right. The wavefront,
its plain version, gives the same bits on the card only while it does the
same. The rule lives in utils/vec.py (`component_sum`, `dot`, `cross`,
`rotate`): a per-lane float reduction over three or more terms, a cross or
matrix product, or a norm lets the card choose the order of the terms or
fuse multiply-adds. These tests run the wavefront on the CPU under a torch
function mode that records every such call, and fail on any; so do the
other evaluators (albedo, normal_depth, naive) and one adaptive epoch.
"""

import pytest
import torch
from torch.overrides import TorchFunctionMode

from echorenderer_tpu_torch.evaluation.wavefront import run_wavefront
from echorenderer_tpu_torch.models import scenes
from echorenderer_tpu_torch.processes import render
from echorenderer_tpu_torch.scene.prepare import prepare_scene
from echorenderer_tpu_torch.utils import diagnostics, vec

torch.set_num_threads(1)

# contractions and norms: the card's kernels pick their own order or fuse
FORBIDDEN = {
    "cross", "linalg_cross", "matmul", "__matmul__", "__rmatmul__", "mm", "bmm", "mv",
    "dot", "vdot", "inner", "tensordot", "einsum", "linear", "addmm", "addmv", "baddbmm",
    "norm", "linalg_norm", "linalg_vector_norm",
}
# reductions whose float result depends on the order of the terms
REDUCTIONS = {"sum", "mean", "prod", "nansum", "nanmean", "cumsum", "cumprod", "logsumexp"}


def _per_lane(args, kwargs) -> bool:
    """A float reduction of a tensor with a lane axis (2+ dims) over an
    axis of three or more terms. A sum of two terms is exact in any order,
    and a total over a 1-D scene table is one value both paths share."""
    x = args[0] if args else None
    if not isinstance(x, torch.Tensor) or not x.is_floating_point() or x.dim() < 2:
        return False
    dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
    if not isinstance(dim, (int, tuple, list)):
        return x.numel() > 2  # the whole tensor
    dims = dim if isinstance(dim, (tuple, list)) else (dim,)
    return any(x.shape[d] > 2 for d in dims)


class OrderWatch(TorchFunctionMode):
    """Records the calls whose rounding the card may order differently."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in FORBIDDEN:
            self.calls.append(name)
        elif name in REDUCTIONS and _per_lane(args, kwargs):
            self.calls.append(f"{name} of {tuple(args[0].shape)}")
        return func(*args, **kwargs)


def _thin_lens():
    scene = scenes.sphere_field(12)
    cam = next(c for c in scene.children if hasattr(c, "lens_radius"))
    cam.lens_radius, cam.focal_distance = 0.4, 20.0
    return scene


def _showcase():
    import test_torch_textures

    return test_torch_textures.showcase("torch")


def _rough_normal():
    import test_torch_textures

    return test_torch_textures.rough_normal("torch")


SCENES = {
    "cornell": scenes.cornell_box,  # dense chunk intersector
    "material_ball": scenes.material_ball,  # linear intersector, every rough lobe
    "many_lights(96)": lambda: scenes.many_lights(96),  # light tree
    "thin lens": _thin_lens,
    "showcase": _showcase,  # the atlas: albedo textures, sphere uv
    "rough_normal": _rough_normal,  # normal map, roughness texture
    "hdr_environment": lambda: scenes.hdr_environment(resolution=(32, 16)),  # an env map
}


@pytest.mark.parametrize("name", list(SCENES))
def test_wavefront_keeps_fixed_op_order(name):
    scene = prepare_scene(SCENES[name](), device="cpu")
    res = (16, 16)
    pid = torch.arange(res[0] * res[1])
    pxy = torch.stack([pid % res[0], pid // res[0]], dim=-1).to(torch.int32)
    watch = OrderWatch()
    with watch:
        s_sum, _ = run_wavefront(scene, pid, pxy, res, 5, 0, 2, bounce_limit=4)
    assert float(s_sum.sum()) > 0.0
    assert watch.calls == [], f"order-dependent float ops on the path: {sorted(set(watch.calls))}"


OFFENDERS = {
    "torch.sum(dim=-1)": lambda x, m: torch.sum(x, dim=-1),
    "Tensor.sum(-1)": lambda x, m: x.sum(-1),
    "linalg.cross": lambda x, m: torch.linalg.cross(x, x),
    "@": lambda x, m: x @ m,
    "einsum": lambda x, m: torch.einsum("ij,ij->i", x, x),
    "Tensor.norm": lambda x, m: x.norm(dim=-1),
}


@pytest.mark.parametrize("op", list(OFFENDERS))
def test_watch_sees_offenders(op):
    watch = OrderWatch()
    with watch:
        OFFENDERS[op](torch.rand(8, 3), torch.rand(3, 3))
    assert watch.calls


def test_watch_passes_vec():
    x, y, m = torch.rand(8, 3), torch.rand(8, 3), torch.rand(3, 3)
    watch = OrderWatch()
    with watch:
        vec.dot(x, y), vec.cross(x, y), vec.rotate(x, m), vec.normalize(x)
        torch.rand(8, 2).sum(-1)  # two terms: exact in any order
    assert watch.calls == []
    torch.testing.assert_close(vec.rotate(x, m), x @ m.T, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(vec.cross(x, y), torch.linalg.cross(x, y), rtol=1e-6, atol=1e-6)


def test_binned_wavefront_keeps_fixed_op_order(monkeypatch):
    """A large scene's wavefront: the first wave on the chunk-tree walk,
    the rest through the binned traversal (the threshold lowered so a
    17,000-triangle scene takes it)."""
    from echorenderer_tpu_torch.evaluation import scene_ops

    scene = prepare_scene(scenes.sphere_grid(17_000), device="cpu")
    monkeypatch.setattr(scene_ops, "HIER_TRACE_MIN", 0)
    assert scene_ops.dispatch_summary(scene)["accelerator"] == "binned"
    res = (8, 8)
    pid = torch.arange(res[0] * res[1])
    pxy = torch.stack([pid % res[0], pid // res[0]], dim=-1).to(torch.int32)
    diagnostics.reset_counts()
    watch = OrderWatch()
    with watch:
        s_sum, _ = run_wavefront(scene, pid, pxy, res, 5, 0, 2, bounce_limit=4)
    assert float(s_sum.sum()) > 0.0 and diagnostics.counts()["binned.calls"] > 0
    assert watch.calls == [], f"order-dependent float ops on the path: {sorted(set(watch.calls))}"


@pytest.mark.parametrize("evaluator", ["albedo", "normal_depth", "naive"])
@pytest.mark.parametrize("name", ["cornell", "showcase", "hdr_environment"])
def test_evaluators_keep_fixed_op_order(name, evaluator):
    scene = prepare_scene(SCENES[name](), device="cpu")
    watch = OrderWatch()
    with watch:
        s_sum, _ = render._sample_frame(scene, evaluator, (16, 16), 5, 0, 2, 4, 2.5)
    assert float(s_sum.abs().sum()) > 0.0
    assert watch.calls == [], (f"order-dependent float ops in {evaluator}: "
                               f"{sorted(set(watch.calls))}")


def test_adaptive_step_keeps_fixed_op_order():
    from echorenderer_tpu_torch.processes.tiles import lane_order
    from echorenderer_tpu_torch.utils import accumulator as acc_mod

    scene = prepare_scene(scenes.cornell_box(), device="cpu")
    res = (16, 16)
    s, q = render._sample_frame(scene, "path", res, 5, 0, 4, 4, 2.5)
    acc = acc_mod.add_many(acc_mod.create((256,)), s, q, 4.0)
    perm = torch.as_tensor(lane_order(res)[0].astype("int64"))
    drawn = torch.full((256,), 4, dtype=torch.int64)
    thr = torch.tensor(0.05)
    watch = OrderWatch()
    with watch:
        m = int(render._active_stats(acc, thr)[0])
        new_acc, new_drawn = render._adaptive_step(scene, acc, drawn, perm, thr, res, 4, 4, 2.5,
                                                   5, m)
    assert 0 < m and int((new_drawn == 8).sum()) == m
    assert watch.calls == [], f"order-dependent float ops: {sorted(set(watch.calls))}"
