"""Local-frame BSDF evaluation/sampling with branchless material dispatch
(counterpart of echorenderer_tpu/evaluation/bsdf.py).

z-up local shading frame; `wo` points away from the surface toward the
viewer; values exclude the cosine term; delta lobes fold 1/|cos| into
their value so weight = f*cos/pdf works uniformly. Every model present in
the scene is evaluated for every lane and the result selected by type.
Models: DIFFUSE (Lambert / Oren-Nayar / diffuse transmission), DIELECTRIC
(smooth Fresnel specular, rough GGX pair), CONDUCTOR (GGX with complex
Fresnel, smooth mirror), EMISSIVE (black), COATED_DIFFUSE, INVISIBLE.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..scene.materials import (
    COATED_DIFFUSE,
    CONDUCTOR,
    DIELECTRIC,
    DIFFUSE,
    EMISSIVE,
    INVISIBLE,
)
from ..utils import rng as rng_mod

INV_PI = 1.0 / math.pi
INV_TAU = 0.5 / math.pi
ALPHA_THRESHOLD = 1e-4  # below this GGX degenerates to a delta


class GatheredMaterial(NamedTuple):
    """Per-lane material parameters; `present` is the scene's material
    type ids (only those models are evaluated)."""

    type: torch.Tensor  # (N,) int32
    albedo: torch.Tensor  # (N, 3)
    params: torch.Tensor  # (N, 4)
    extra: torch.Tensor  # (N, 3)
    present: tuple = (DIFFUSE, DIELECTRIC, CONDUCTOR, EMISSIVE, COATED_DIFFUSE, INVISIBLE)


class BSDFSample(NamedTuple):
    incident: torch.Tensor  # (N, 3) local sampled direction
    value: torch.Tensor  # (N, 3)
    pdf: torch.Tensor  # (N,)
    specular: torch.Tensor  # (N,) bool — a Dirac delta lobe was sampled


def _sq_norm(x):
    return torch.sqrt(torch.clamp(torch.sum(x * x, dim=-1, keepdim=True), min=1e-20))


def roughness_to_alpha(roughness):
    """Artistic roughness -> GGX alpha."""
    r = torch.clamp(roughness * 0.75, 0.0, 1.0)
    return torch.clamp(r * r, min=ALPHA_THRESHOLD)


def _cos(w):
    return w[..., 2]


def _abs_cos(w):
    return torch.abs(w[..., 2])


def _negate_z(w):
    return w * torch.tensor([1.0, 1.0, -1.0], dtype=w.dtype, device=w.device)


def _same_hemisphere(a, b):
    return _cos(a) * _cos(b) > 0.0


def _zeros(like):
    return torch.zeros(like.shape[:-1], dtype=torch.float32, device=like.device)


# --- Fresnel ---


def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Exact unpolarized dielectric Fresnel reflectance; eta_i/eta_t are
    the incident-side indices already resolved by the caller."""
    cos_i = torch.clamp(torch.abs(cos_i), 0.0, 1.0)
    sin2_t = (eta_i / eta_t) ** 2 * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_par = (eta_t * cos_i - eta_i * cos_t) / torch.clamp(eta_t * cos_i + eta_i * cos_t, min=1e-20)
    r_per = (eta_i * cos_i - eta_t * cos_t) / torch.clamp(eta_i * cos_i + eta_t * cos_t, min=1e-20)
    f = 0.5 * (r_par * r_par + r_per * r_per)
    return torch.where(tir, 1.0, f), cos_t, tir


def fresnel_conductor(cos_i, eta, k):
    """Per-channel complex-IOR Fresnel. cos_i (N,), eta/k (N, 3)."""
    c = torch.clamp(torch.abs(cos_i), 0.0, 1.0)[..., None]
    c2 = c * c
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * e2 * k2, min=0.0))
    t1 = a2b2 + c2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * c
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-20)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-20)
    return 0.5 * (rs + rp)


def artistic_to_physical(main, edge):
    """Artist Friendly Metallic Fresnel [Gulbrandsen 2014]: main/edge
    colors -> (eta, k) per channel."""
    r = torch.clamp(main, 0.0, 1.0 - 1e-4)
    sqrt_r = torch.sqrt(r)
    eta = (1.0 + sqrt_r) / (1.0 - sqrt_r) * (1.0 - edge) + (1.0 - r) / (1.0 + r) * edge
    k2 = (r * (eta + 1.0) ** 2 - (eta - 1.0) ** 2) / torch.clamp(1.0 - r, min=1e-4)
    return torch.clamp(eta, min=1e-4), torch.sqrt(torch.clamp(k2, min=0.0))


# --- GGX microfacet (isotropic Trowbridge-Reitz, Heitz VNDF sampling) ---


def ggx_d(m, alpha):
    c2 = _cos(m) ** 2
    t = c2 * (alpha * alpha - 1.0) + 1.0
    return alpha * alpha / torch.clamp(math.pi * t * t, min=1e-20)


def ggx_lambda(w, alpha):
    c2 = _cos(w) ** 2
    s2 = torch.clamp(1.0 - c2, min=0.0)
    tan2 = s2 / torch.clamp(c2, min=1e-12)
    return 0.5 * (torch.sqrt(1.0 + alpha * alpha * tan2) - 1.0)


def ggx_g1(w, alpha):
    return 1.0 / (1.0 + ggx_lambda(w, alpha))


def ggx_g2(wo, wi, alpha):
    """Separable Smith visibility 1/(1 + L(o) + L(i))."""
    return 1.0 / (1.0 + ggx_lambda(wo, alpha) + ggx_lambda(wi, alpha))


def ggx_sample_vndf(wo, alpha, u):
    """Sample a visible normal (Heitz 2018); the returned m is in +z."""
    sign = torch.sign(torch.where(_cos(wo) == 0.0, 1.0, _cos(wo)))[..., None]
    v = wo * sign
    vh = torch.stack([alpha * v[..., 0], alpha * v[..., 1], v[..., 2]], dim=-1)
    vh = vh / torch.clamp(torch.sqrt(torch.sum(vh * vh, dim=-1, keepdim=True)), min=1e-20)
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = torch.rsqrt(torch.clamp(lensq, min=1e-20))
    t1 = torch.where(
        (lensq > 1e-12)[..., None],
        torch.stack([-vh[..., 1] * inv_len, vh[..., 0] * inv_len, torch.zeros_like(inv_len)], dim=-1),
        torch.tensor([1.0, 0.0, 0.0], dtype=vh.dtype, device=vh.device).expand(vh.shape),
    )
    t2 = torch.linalg.cross(vh, t1, dim=-1)
    r = torch.sqrt(u[..., 0])
    phi = (2.0 * math.pi) * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    m = torch.stack(
        [alpha * nh[..., 0], alpha * nh[..., 1], torch.clamp(nh[..., 2], min=1e-6)], dim=-1
    )
    return m / torch.clamp(torch.sqrt(torch.sum(m * m, dim=-1, keepdim=True)), min=1e-20)


def ggx_pdf_reflect(wo, m, alpha):
    """pdf of a VNDF-sampled reflection: G1(wo) D(m) / (4 |cos wo|)."""
    return ggx_g1(wo, alpha) * ggx_d(m, alpha) / torch.clamp(4.0 * _abs_cos(wo), min=1e-8)


# --- per-material evaluate / pdf / sample ---


def _oren_nayar_value(wo, wi, roughness):
    """Fujii's improved Oren-Nayar: a + b*s, a = 1/((pi/2 - 2/3)*r + pi)."""
    a = 1.0 / ((math.pi / 2.0 - 2.0 / 3.0) * roughness + math.pi)
    b = a * roughness
    cos_o = _abs_cos(wo)
    cos_i = _abs_cos(wi)
    s = torch.sum(wo * wi, dim=-1) - cos_o * cos_i
    s = torch.where(s > 0.0, s / torch.clamp(torch.maximum(cos_o, cos_i), min=1e-8), s)
    return a + b * s


def _diffuse_eval(mat, wo, wi):
    roughness = mat.params[..., 0]
    transmissive = mat.params[..., 1] > 0.5
    same = _same_hemisphere(wo, wi)
    lambert = torch.where(roughness < 1e-6, INV_PI, _oren_nayar_value(wo, wi, roughness))
    refl = torch.where(same, lambert, 0.0)
    value = torch.where(transmissive, INV_TAU, refl)
    return mat.albedo * value[..., None]


def _diffuse_pdf(mat, wo, wi):
    transmissive = mat.params[..., 1] > 0.5
    same = _same_hemisphere(wo, wi)
    refl = torch.where(same, _abs_cos(wi) * INV_PI, 0.0)
    trans = _abs_cos(wi) * INV_TAU
    return torch.where(transmissive, trans, refl)


def _diffuse_sample(mat, wo, u, u_lobe):
    transmissive = mat.params[..., 1] > 0.5
    wi = rng_mod.cosine_hemisphere(u)
    refl_wi = torch.where(_cos(wo)[..., None] < 0.0, _negate_z(wi), wi)
    trans_flip = (u_lobe > 0.5) ^ (_cos(wo) > 0.0)
    trans_wi = torch.where(trans_flip[..., None], _negate_z(wi), wi)
    wi = torch.where(transmissive[..., None], trans_wi, refl_wi)
    return BSDFSample(
        incident=wi,
        value=_diffuse_eval(mat, wo, wi),
        pdf=_diffuse_pdf(mat, wo, wi),
        specular=torch.zeros(wo.shape[:-1], dtype=torch.bool, device=wo.device),
    )


def _dielectric_setup(mat, wo):
    ior = torch.clamp(mat.params[..., 1], min=1.0 + 1e-4)
    entering = _cos(wo) > 0.0
    eta_i = torch.where(entering, 1.0, ior)
    eta_t = torch.where(entering, ior, 1.0)
    return ior, eta_i, eta_t


def _refract(wo, m, eta_i, eta_t):
    """Refract wo about microfacet/normal m (m on wo's side): (wi, ok)."""
    cos_i = torch.sum(wo * m, dim=-1)
    eta = eta_i / eta_t
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    ok = sin2_t < 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wi = -wo * eta[..., None] + (eta * cos_i - cos_t)[..., None] * m
    return wi / _sq_norm(wi), ok


def _dielectric_smooth_sample(mat, wo, u_lobe):
    """Fresnel specular: choose reflect/refract by Fresnel."""
    ior, eta_i, eta_t = _dielectric_setup(mat, wo)
    f, cos_t, tir = fresnel_dielectric(_cos(wo), eta_i, eta_t)
    reflect = (u_lobe < f) | tir
    wi_r = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)
    z = torch.tensor([0.0, 0.0, 1.0], dtype=wo.dtype, device=wo.device)
    n = (torch.where(_cos(wo)[..., None] > 0.0, 1.0, -1.0) * z).expand(wo.shape)
    wi_t, _ = _refract(wo, n, eta_i, eta_t)
    wi = torch.where(reflect[..., None], wi_r, wi_t)
    scale = torch.where(reflect, f, (1.0 - f) * (eta_i / eta_t) ** 2)
    pdf = torch.where(reflect, f, 1.0 - f)
    pdf = torch.where(tir, 1.0, pdf)
    scale = torch.where(tir, 1.0, scale)
    value = mat.albedo * (scale / torch.clamp(_abs_cos(wi), min=1e-8))[..., None]
    return BSDFSample(
        incident=wi, value=value, pdf=pdf,
        specular=torch.ones(wo.shape[:-1], dtype=torch.bool, device=wo.device),
    )


def _dielectric_rough_eval_pdf(mat, wo, wi):
    """GGX reflection + transmission pair."""
    alpha = roughness_to_alpha(mat.params[..., 0])
    ior, eta_i, eta_t = _dielectric_setup(mat, wo)
    same = _same_hemisphere(wo, wi)

    # reflection lobe
    m_r = wo + wi
    m_r = m_r / _sq_norm(m_r)
    m_r = m_r * torch.sign(_cos(m_r))[..., None]  # canonical +z
    f_r, _, _ = fresnel_dielectric(torch.sum(wo * m_r, dim=-1), eta_i, eta_t)
    d_r = ggx_d(m_r, alpha)
    g_r = ggx_g2(wo, wi, alpha)
    denom = torch.clamp(4.0 * _abs_cos(wo) * _abs_cos(wi), min=1e-8)
    refl_val = torch.where(same, d_r * g_r * f_r / denom, 0.0)
    pdf_r = torch.where(same, ggx_pdf_reflect(wo, m_r, alpha), 0.0)

    # transmission lobe
    eta = eta_t / eta_i
    m_t = wo + wi * eta[..., None]
    m_t = m_t / torch.clamp(torch.sqrt(torch.sum(m_t * m_t, dim=-1, keepdim=True)), min=1e-20)
    m_t = m_t * torch.sign(_cos(m_t))[..., None]
    wo_m = torch.sum(wo * m_t, dim=-1)
    wi_m = torch.sum(wi * m_t, dim=-1)
    valid_t = (~same) & (wo_m * wi_m < 0.0)
    f_t, _, _ = fresnel_dielectric(wo_m, eta_i, eta_t)
    d_t = ggx_d(m_t, alpha)
    g_t = ggx_g2(wo, wi, alpha)
    sqrt_denom = wo_m + eta * wi_m
    denom_t = torch.clamp(sqrt_denom * sqrt_denom, min=1e-10)
    dwh_dwi = eta * eta * torch.abs(wi_m) / denom_t
    trans_val = torch.where(
        valid_t,
        (1.0 - f_t) * d_t * g_t * torch.abs(wo_m) * torch.abs(wi_m)
        / torch.clamp(_abs_cos(wo) * _abs_cos(wi) * denom_t, min=1e-10),
        0.0,
    )
    pdf_m_t = ggx_g1(wo, alpha) * d_t * torch.abs(wo_m) / torch.clamp(_abs_cos(wo), min=1e-8)
    pdf_t = torch.where(valid_t, pdf_m_t * dwh_dwi, 0.0)

    value = mat.albedo * (refl_val + trans_val)[..., None]
    # Fresnel-weighted lobe selection, as _dielectric_rough_sample picks
    pdf = pdf_r * f_r + pdf_t * (1.0 - f_t)
    return value, pdf


def _dielectric_rough_sample(mat, wo, u, u_lobe):
    alpha = roughness_to_alpha(mat.params[..., 0])
    ior, eta_i, eta_t = _dielectric_setup(mat, wo)
    m = ggx_sample_vndf(wo, alpha, u)
    m_signed = m * torch.sign(_cos(wo))[..., None]  # microfacet on wo's side
    wi_r = 2.0 * torch.sum(wo * m_signed, dim=-1, keepdim=True) * m_signed - wo
    wi_t, ok_t = _refract(wo, m_signed, eta_i, eta_t)
    f, _, _ = fresnel_dielectric(torch.sum(wo * m_signed, dim=-1), eta_i, eta_t)
    pick_reflect = (u_lobe < f) | ~ok_t
    wi = torch.where(pick_reflect[..., None], wi_r, wi_t)
    value, pdf = _dielectric_rough_eval_pdf(mat, wo, wi)
    return BSDFSample(
        incident=wi, value=value, pdf=pdf,
        specular=torch.zeros(wo.shape[:-1], dtype=torch.bool, device=wo.device),
    )


def _conductor_fresnel(mat, wo_m):
    artistic = mat.params[..., 1] > 0.5
    eta_a, k_a = artistic_to_physical(mat.albedo, mat.extra)
    eta = torch.where(artistic[..., None], eta_a, torch.clamp(mat.albedo, min=1e-4))
    k = torch.where(artistic[..., None], k_a, mat.extra)
    return fresnel_conductor(wo_m, eta, k)


def _conductor_eval_pdf(mat, wo, wi):
    alpha = roughness_to_alpha(mat.params[..., 0])
    same = _same_hemisphere(wo, wi)
    m = wo + wi
    m = m / torch.clamp(torch.sqrt(torch.sum(m * m, dim=-1, keepdim=True)), min=1e-20)
    m = m * torch.sign(_cos(m))[..., None]
    f = _conductor_fresnel(mat, torch.sum(wo * m, dim=-1))
    d = ggx_d(m, alpha)
    g = ggx_g2(wo, wi, alpha)
    denom = torch.clamp(4.0 * _abs_cos(wo) * _abs_cos(wi), min=1e-8)
    value = torch.where(same[..., None], f * (d * g / denom)[..., None], 0.0)
    pdf = torch.where(same, ggx_pdf_reflect(wo, m, alpha), 0.0)
    return value, pdf


def _conductor_sample(mat, wo, u):
    roughness = mat.params[..., 0]
    alpha = roughness_to_alpha(roughness)
    is_specular = torch.clamp(roughness * 0.75, 0.0, 1.0) ** 2 < ALPHA_THRESHOLD

    m = ggx_sample_vndf(wo, alpha, u)
    m_signed = m * torch.sign(_cos(wo))[..., None]
    wi_g = 2.0 * torch.sum(wo * m_signed, dim=-1, keepdim=True) * m_signed - wo
    value_g, pdf_g = _conductor_eval_pdf(mat, wo, wi_g)

    wi_s = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)
    f_s = _conductor_fresnel(mat, _cos(wo))
    value_s = f_s / torch.clamp(_abs_cos(wi_s), min=1e-8)[..., None]

    wi = torch.where(is_specular[..., None], wi_s, wi_g)
    value = torch.where(is_specular[..., None], value_s, value_g)
    pdf = torch.where(is_specular, 1.0, pdf_g)
    return BSDFSample(incident=wi, value=value, pdf=pdf, specular=is_specular)


def _coated_eval_pdf(mat, wo, wi):
    """Lambert base under a dielectric coat."""
    ior = torch.clamp(mat.params[..., 1], min=1.0 + 1e-4)
    same = _same_hemisphere(wo, wi)
    f_o, _, _ = fresnel_dielectric(_cos(wo), torch.ones_like(ior), ior)
    f_i, _, _ = fresnel_dielectric(_cos(wi), torch.ones_like(ior), ior)
    f_avg = (ior - 1.0) / (4.08567 + 1.00071 * ior)  # Egan approximation
    comp = 1.0 - f_avg[..., None] * mat.albedo
    base = mat.albedo * INV_PI * ((1.0 - f_o) * (1.0 - f_i))[..., None] / torch.clamp(comp, min=1e-3)
    value = torch.where(same[..., None], base, 0.0)
    pdf = torch.where(same, _abs_cos(wi) * INV_PI, 0.0) * 0.5  # two lobes, coat is delta
    return value, pdf


def _coated_sample(mat, wo, u, u_lobe):
    ior = torch.clamp(mat.params[..., 1], min=1.0 + 1e-4)
    f_o, _, _ = fresnel_dielectric(_cos(wo), torch.ones_like(ior), ior)
    pick_coat = u_lobe < 0.5
    wi_c = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)
    wi_b = rng_mod.cosine_hemisphere(u)
    wi_b = torch.where(_cos(wo)[..., None] < 0.0, _negate_z(wi_b), wi_b)
    wi = torch.where(pick_coat[..., None], wi_c, wi_b)
    value_b, pdf_b = _coated_eval_pdf(mat, wo, wi)
    value_c = (f_o / torch.clamp(_abs_cos(wi_c), min=1e-8))[..., None] * torch.ones_like(mat.albedo)
    value = torch.where(pick_coat[..., None], value_c, value_b)
    pdf = torch.where(pick_coat, 0.5, pdf_b)
    return BSDFSample(incident=wi, value=value, pdf=pdf, specular=pick_coat)


def _invisible_sample(mat, wo):
    wi = -wo
    value = 1.0 / torch.clamp(_abs_cos(wi), min=1e-8)
    return BSDFSample(
        incident=wi,
        value=value[..., None].expand(wo.shape),
        pdf=torch.ones(wo.shape[:-1], dtype=torch.float32, device=wo.device),
        specular=torch.ones(wo.shape[:-1], dtype=torch.bool, device=wo.device),
    )


# --- public dispatch ---


def _expand(mask, like):
    """Broadcast a (N,) mask against a (N,) or (N, k) candidate."""
    return mask[..., None] if like.dim() > mask.dim() else mask


def sample(mat: GatheredMaterial, wo, u2, u_lobe) -> BSDFSample:
    """Sample an incident direction for every lane; the models present in
    the scene are evaluated and the result selected by type."""
    t = mat.type
    present = set(mat.present)
    smooth_dielectric = roughness_to_alpha(mat.params[..., 0]) <= ALPHA_THRESHOLD

    candidates = []
    if DIFFUSE in present:
        candidates.append((DIFFUSE, _diffuse_sample(mat, wo, u2, u_lobe)))
    if DIELECTRIC in present:
        s_s = _dielectric_smooth_sample(mat, wo, u_lobe)
        s_r = _dielectric_rough_sample(mat, wo, u2, u_lobe)
        diel = BSDFSample(*(
            torch.where(_expand(smooth_dielectric, a), a, b) for a, b in zip(s_s, s_r)
        ))
        candidates.append((DIELECTRIC, diel))
    if CONDUCTOR in present:
        candidates.append((CONDUCTOR, _conductor_sample(mat, wo, u2)))
    if COATED_DIFFUSE in present:
        candidates.append((COATED_DIFFUSE, _coated_sample(mat, wo, u2, u_lobe)))
    if INVISIBLE in present:
        candidates.append((INVISIBLE, _invisible_sample(mat, wo)))

    if len(candidates) == 1 and EMISSIVE not in present:
        return candidates[0][1]
    zero = BSDFSample(
        incident=torch.zeros_like(wo),
        value=torch.zeros_like(wo),
        pdf=_zeros(wo),
        specular=torch.zeros(wo.shape[:-1], dtype=torch.bool, device=wo.device),
    )

    def pick(field):
        out = getattr(zero, field)
        for tid, cand in candidates:
            c = getattr(cand, field)
            out = torch.where(_expand(t == tid, c), c, out)
        return out

    return BSDFSample(*(pick(f) for f in BSDFSample._fields))


def _eval_pdf_candidates(mat, wo, wi):
    """(type, value, pdf) rows for the non-delta models present."""
    present = set(mat.present)
    smooth_dielectric = roughness_to_alpha(mat.params[..., 0]) <= ALPHA_THRESHOLD
    rows = []
    if DIFFUSE in present:
        rows.append((DIFFUSE, _diffuse_eval(mat, wo, wi), _diffuse_pdf(mat, wo, wi)))
    if DIELECTRIC in present:
        v, p = _dielectric_rough_eval_pdf(mat, wo, wi)
        v = torch.where(smooth_dielectric[..., None], 0.0, v)
        p = torch.where(smooth_dielectric, 0.0, p)
        rows.append((DIELECTRIC, v, p))
    if CONDUCTOR in present:
        v, p = _conductor_eval_pdf(mat, wo, wi)
        spec = torch.clamp(mat.params[..., 0] * 0.75, 0.0, 1.0) ** 2 < ALPHA_THRESHOLD
        rows.append((CONDUCTOR, torch.where(spec[..., None], 0.0, v), torch.where(spec, 0.0, p)))
    if COATED_DIFFUSE in present:
        v, p = _coated_eval_pdf(mat, wo, wi)
        rows.append((COATED_DIFFUSE, v, p))
    return rows


def evaluate(mat: GatheredMaterial, wo, wi) -> torch.Tensor:
    """BSDF value excluding delta lobes (for NEE light sampling)."""
    out = torch.zeros_like(wo)
    for tid, v, _ in _eval_pdf_candidates(mat, wo, wi):
        out = torch.where((mat.type == tid)[..., None], v, out)
    return out


def pdf(mat: GatheredMaterial, wo, wi) -> torch.Tensor:
    """pdf of `sample` producing wi, excluding delta lobes (for MIS)."""
    out = _zeros(wo)
    for tid, _, p in _eval_pdf_candidates(mat, wo, wi):
        out = torch.where(mat.type == tid, p, out)
    return out
