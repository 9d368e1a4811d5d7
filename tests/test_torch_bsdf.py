"""PyTorch port: BSDF sample / evaluate / pdf against the JAX package for
every material model on the same wo, u and material rows.

evaluate and pdf at given directions agree to rtol 1e-5, atol 1e-6, as do
the samples of every model without a GGX lobe. A GGX sample (rough
dielectric, rough conductor) is ill-conditioned: near the peak of D the
relative change of D is 2/alpha^2 (about 4000 at alpha = 0.0225) times the
relative change of cos^2 of the half vector, so a one-ulp difference
between the two math libraries' sqrt/sin/cos becomes ~1e-4 in value and
pdf. For GGX models the sampled direction is held to atol 1e-4, the
sampled value/pdf to rtol 2e-3 and evaluate/pdf at given directions to
rtol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echorenderer_tpu.evaluation import bsdf as jbsdf
from echorenderer_tpu.scene import materials as M
from echorenderer_tpu_torch.evaluation import bsdf as tbsdf

torch.set_num_threads(1)

N = 2048
# (type, params [roughness, p1, p2, p3], extra): one row per material model
MODELS = {
    "lambert": (M.DIFFUSE, [0.0, 0, 0, 0], [0, 0, 0]),
    "oren_nayar": (M.DIFFUSE, [0.6, 0, 0, 0], [0, 0, 0]),
    "diffuse_transmission": (M.DIFFUSE, [0.0, 1, 0, 0], [0, 0, 0]),
    "dielectric_smooth": (M.DIELECTRIC, [0.0, 1.5, 0, 0], [0, 0, 0]),
    "dielectric_rough": (M.DIELECTRIC, [0.3, 1.5, 0, 0], [0, 0, 0]),
    "conductor_rough": (M.CONDUCTOR, [0.2, 1, 0, 0], [1.0, 0.9, 0.8]),
    "conductor_smooth": (M.CONDUCTOR, [0.0, 1, 0, 0], [1.0, 1.0, 1.0]),
    "conductor_physical": (M.CONDUCTOR, [0.3, 0, 0, 0], [3.0, 2.5, 2.0]),
    "emissive": (M.EMISSIVE, [0.0, 0, 0, 0], [0, 0, 0]),
    "coated_diffuse": (M.COATED_DIFFUSE, [0.0, 1.5, 0, 0], [0, 0, 0]),
    "invisible": (M.INVISIBLE, [0.0, 0, 0, 0], [0, 0, 0]),
}


def _unit(rs, n):
    v = rs.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _inputs(types, params, extra, seed):
    rs = np.random.RandomState(seed)
    n = len(types)
    albedo = rs.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    return dict(
        type=np.asarray(types, np.int32), albedo=albedo,
        params=np.asarray(params, np.float32), extra=np.asarray(extra, np.float32),
        wo=_unit(rs, n), wi=_unit(rs, n),
        u2=rs.uniform(0, 1, (n, 2)).astype(np.float32),
        u_lobe=rs.uniform(0, 1, n).astype(np.float32),
    )


def _materials(x, present):
    jm = jbsdf.GatheredMaterial(
        type=jnp.asarray(x["type"]), albedo=jnp.asarray(x["albedo"]),
        params=jnp.asarray(x["params"]), extra=jnp.asarray(x["extra"]), present=present,
    )
    tm = tbsdf.GatheredMaterial(
        type=torch.as_tensor(x["type"]), albedo=torch.as_tensor(x["albedo"]),
        params=torch.as_tensor(x["params"]), extra=torch.as_tensor(x["extra"]), present=present,
    )
    return jm, tm


def _case(models, seed):
    rows = [MODELS[m] for m in models]
    pick = np.random.RandomState(seed).randint(0, len(rows), N)
    x = _inputs([rows[i][0] for i in pick], [rows[i][1] for i in pick],
                [rows[i][2] for i in pick], seed)
    present = tuple(sorted({r[0] for r in rows}))
    return x, present


GGX_MODELS = {"dielectric_rough", "conductor_rough", "conductor_physical"}


def _check(x, present, ggx):
    jm, tm = _materials(x, present)
    jwo, two = jnp.asarray(x["wo"]), torch.as_tensor(x["wo"])
    jwi, twi = jnp.asarray(x["wi"]), torch.as_tensor(x["wi"])
    js = jbsdf.sample(jm, jwo, jnp.asarray(x["u2"]), jnp.asarray(x["u_lobe"]))
    ts = tbsdf.sample(tm, two, torch.as_tensor(x["u2"]), torch.as_tensor(x["u_lobe"]))
    tol = dict(incident=(1e-5, 1e-4 if ggx else 1e-6),
               value=(2e-3 if ggx else 1e-5, 1e-6), pdf=(2e-3 if ggx else 1e-5, 1e-6))
    rtol_eval = 1e-4 if ggx else 1e-5
    for name, (rtol, atol) in tol.items():
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=rtol, atol=atol, err_msg=name)
    np.testing.assert_array_equal(ts.specular.numpy(), np.asarray(js.specular))
    np.testing.assert_allclose(tbsdf.evaluate(tm, two, twi).numpy(),
                               np.asarray(jbsdf.evaluate(jm, jwo, jwi)), rtol=rtol_eval, atol=1e-6)
    np.testing.assert_allclose(tbsdf.pdf(tm, two, twi).numpy(),
                               np.asarray(jbsdf.pdf(jm, jwo, jwi)), rtol=rtol_eval, atol=1e-6)


@pytest.mark.parametrize("model", list(MODELS))
def test_model_matches_jax(model):
    _check(*_case([model], seed=len(model)), ggx=model in GGX_MODELS)


def test_all_models_in_one_scene_match_jax():
    """Every type present at once: the branchless select over candidates."""
    _check(*_case(list(MODELS), seed=99), ggx=True)
