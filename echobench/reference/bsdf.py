"""Vector math and the BSDFs of the reference: a frozen copy of the parts
of echorenderer_tpu_torch/utils/vec.py and evaluation/bsdf.py that the
benchmark's materials reach (Lambert and Oren-Nayar diffuse, smooth and
GGX dielectric, GGX and mirror conductor with the artistic Fresnel,
emissive as black), op for op, in any float dtype.

Local shading frame z-up; `wo` points away from the surface; values
exclude the cosine; delta lobes fold 1/|cos| into their value."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import rng
from .flat import CONDUCTOR, DIELECTRIC, DIFFUSE

INV_PI = 1.0 / math.pi
INV_TAU = 0.5 / math.pi
ALPHA_THRESHOLD = 1e-4


# --- vectors (sums left to right, products unfused) ---

def vsum(a):
    return a[..., 0] + a[..., 1] + a[..., 2]


def dot(a, b):
    return vsum(a * b)


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def rotate(v, rot):
    return torch.stack([dot(v, rot[k]) for k in range(3)], dim=-1)


def normalize(a):
    sq = dot(a, a)[..., None]
    inv = torch.where(sq > 0.0, torch.rsqrt(torch.clamp(sq, min=1e-38)), 0.0)
    return a * inv


def frame(n):
    """Right-handed (tangent, bitangent) around a unit normal (Duff et al.)."""
    sign = torch.where(n[..., 2:3] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[..., 2:3])
    b = n[..., 0:1] * n[..., 1:2] * a
    t = torch.cat([1.0 + sign * n[..., 0:1] ** 2 * a, sign * b, -sign * n[..., 0:1]], dim=-1)
    bt = torch.cat([b, sign + n[..., 1:2] ** 2 * a, -n[..., 1:2]], dim=-1)
    return t, bt


def to_local(v, t, b, n):
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def to_world(v, t, b, n):
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def luminance(rgb):
    w = torch.tensor((0.212671, 0.715160, 0.072169), dtype=torch.float32).to(rgb.device, rgb.dtype)
    return dot(rgb, w)


# --- BSDFs ---

class Material(NamedTuple):
    type: torch.Tensor  # (N,) int32
    albedo: torch.Tensor  # (N, 3)
    params: torch.Tensor  # (N, 4)
    extra: torch.Tensor  # (N, 3)


class Sample(NamedTuple):
    incident: torch.Tensor
    value: torch.Tensor
    pdf: torch.Tensor
    specular: torch.Tensor


def _sq_norm(x):
    return torch.sqrt(torch.clamp(dot(x, x), min=1e-20))[..., None]


def _unit(x):
    return x / torch.clamp(torch.sqrt(dot(x, x)), min=1e-20)[..., None]


def _alpha(roughness):
    r = torch.clamp(roughness * 0.75, 0.0, 1.0)
    return torch.clamp(r * r, min=ALPHA_THRESHOLD)


def _cos(w):
    return w[..., 2]


def _abs_cos(w):
    return torch.abs(w[..., 2])


def _negate_z(w):
    return w * torch.tensor([1.0, 1.0, -1.0], dtype=w.dtype, device=w.device)


def _same(a, b):
    return _cos(a) * _cos(b) > 0.0


def _bool(like):
    return torch.zeros(like.shape[:-1], dtype=torch.bool, device=like.device)


def fresnel_dielectric(cos_i, eta_i, eta_t):
    cos_i = torch.clamp(torch.abs(cos_i), 0.0, 1.0)
    sin2_t = (eta_i / eta_t) ** 2 * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_par = (eta_t * cos_i - eta_i * cos_t) / torch.clamp(eta_t * cos_i + eta_i * cos_t, min=1e-20)
    r_per = (eta_i * cos_i - eta_t * cos_t) / torch.clamp(eta_i * cos_i + eta_t * cos_t, min=1e-20)
    f = 0.5 * (r_par * r_par + r_per * r_per)
    return torch.where(tir, 1.0, f), tir


def fresnel_conductor(cos_i, eta, k):
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
    r = torch.clamp(main, 0.0, 1.0 - 1e-4)
    sqrt_r = torch.sqrt(r)
    eta = (1.0 + sqrt_r) / (1.0 - sqrt_r) * (1.0 - edge) + (1.0 - r) / (1.0 + r) * edge
    k2 = (r * (eta + 1.0) ** 2 - (eta - 1.0) ** 2) / torch.clamp(1.0 - r, min=1e-4)
    return torch.clamp(eta, min=1e-4), torch.sqrt(torch.clamp(k2, min=0.0))


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
    return 1.0 / (1.0 + ggx_lambda(wo, alpha) + ggx_lambda(wi, alpha))


def ggx_sample_vndf(wo, alpha, u):
    """A visible normal (Heitz 2018), in +z."""
    sign = torch.sign(torch.where(_cos(wo) == 0.0, 1.0, _cos(wo)))[..., None]
    v = wo * sign
    vh = _unit(torch.stack([alpha * v[..., 0], alpha * v[..., 1], v[..., 2]], dim=-1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = torch.rsqrt(torch.clamp(lensq, min=1e-20))
    t1 = torch.where(
        (lensq > 1e-12)[..., None],
        torch.stack([-vh[..., 1] * inv_len, vh[..., 0] * inv_len, torch.zeros_like(inv_len)], -1),
        torch.tensor([1.0, 0.0, 0.0], dtype=vh.dtype, device=vh.device).expand(vh.shape),
    )
    t2 = cross(vh, t1)
    r = torch.sqrt(u[..., 0])
    phi = (2.0 * math.pi) * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    m = torch.stack([alpha * nh[..., 0], alpha * nh[..., 1], torch.clamp(nh[..., 2], min=1e-6)],
                    dim=-1)
    return _unit(m)


def ggx_pdf_reflect(wo, m, alpha):
    return ggx_g1(wo, alpha) * ggx_d(m, alpha) / torch.clamp(4.0 * _abs_cos(wo), min=1e-8)


def _oren_nayar(wo, wi, roughness):
    a = 1.0 / ((math.pi / 2.0 - 2.0 / 3.0) * roughness + math.pi)
    b = a * roughness
    cos_o = _abs_cos(wo)
    cos_i = _abs_cos(wi)
    s = dot(wo, wi) - cos_o * cos_i
    s = torch.where(s > 0.0, s / torch.clamp(torch.maximum(cos_o, cos_i), min=1e-8), s)
    return a + b * s


def _diffuse_eval(mat, wo, wi):
    roughness = mat.params[..., 0]
    transmissive = mat.params[..., 1] > 0.5
    lambert = torch.where(roughness < 1e-6, INV_PI, _oren_nayar(wo, wi, roughness))
    refl = torch.where(_same(wo, wi), lambert, 0.0)
    value = torch.where(transmissive, INV_TAU, refl)
    return mat.albedo * value[..., None]


def _diffuse_pdf(mat, wo, wi):
    transmissive = mat.params[..., 1] > 0.5
    refl = torch.where(_same(wo, wi), _abs_cos(wi) * INV_PI, 0.0)
    return torch.where(transmissive, _abs_cos(wi) * INV_TAU, refl)


def _diffuse_sample(mat, wo, u, u_lobe):
    transmissive = mat.params[..., 1] > 0.5
    wi = rng.cosine_hemisphere(u)
    refl_wi = torch.where(_cos(wo)[..., None] < 0.0, _negate_z(wi), wi)
    trans_flip = (u_lobe > 0.5) ^ (_cos(wo) > 0.0)
    trans_wi = torch.where(trans_flip[..., None], _negate_z(wi), wi)
    wi = torch.where(transmissive[..., None], trans_wi, refl_wi)
    return Sample(wi, _diffuse_eval(mat, wo, wi), _diffuse_pdf(mat, wo, wi), _bool(wo))


def _dielectric_setup(mat, wo):
    ior = torch.clamp(mat.params[..., 1], min=1.0 + 1e-4)
    entering = _cos(wo) > 0.0
    return torch.where(entering, 1.0, ior), torch.where(entering, ior, 1.0)


def _refract(wo, m, eta_i, eta_t):
    cos_i = dot(wo, m)
    eta = eta_i / eta_t
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    ok = sin2_t < 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wi = -wo * eta[..., None] + (eta * cos_i - cos_t)[..., None] * m
    return wi / _sq_norm(wi), ok


def _dielectric_smooth_sample(mat, wo, u_lobe):
    eta_i, eta_t = _dielectric_setup(mat, wo)
    f, tir = fresnel_dielectric(_cos(wo), eta_i, eta_t)
    reflect = (u_lobe < f) | tir
    wi_r = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)
    z = torch.tensor([0.0, 0.0, 1.0], dtype=wo.dtype, device=wo.device)
    n = (torch.where(_cos(wo)[..., None] > 0.0, 1.0, -1.0).to(wo.dtype) * z).expand(wo.shape)
    wi_t, _ = _refract(wo, n, eta_i, eta_t)
    wi = torch.where(reflect[..., None], wi_r, wi_t)
    scale = torch.where(reflect, f, (1.0 - f) * (eta_i / eta_t) ** 2)
    pdf = torch.where(tir, 1.0, torch.where(reflect, f, 1.0 - f))
    scale = torch.where(tir, 1.0, scale)
    value = mat.albedo * (scale / torch.clamp(_abs_cos(wi), min=1e-8))[..., None]
    return Sample(wi, value, pdf, ~_bool(wo))


def _dielectric_rough_eval_pdf(mat, wo, wi):
    alpha = _alpha(mat.params[..., 0])
    eta_i, eta_t = _dielectric_setup(mat, wo)
    same = _same(wo, wi)
    m_r = wo + wi
    m_r = m_r / _sq_norm(m_r)
    m_r = m_r * torch.sign(_cos(m_r))[..., None]
    f_r, _ = fresnel_dielectric(dot(wo, m_r), eta_i, eta_t)
    d_r = ggx_d(m_r, alpha)
    g_r = ggx_g2(wo, wi, alpha)
    denom = torch.clamp(4.0 * _abs_cos(wo) * _abs_cos(wi), min=1e-8)
    refl_val = torch.where(same, d_r * g_r * f_r / denom, 0.0)
    pdf_r = torch.where(same, ggx_pdf_reflect(wo, m_r, alpha), 0.0)

    eta = eta_t / eta_i
    m_t = _unit(wo + wi * eta[..., None])
    m_t = m_t * torch.sign(_cos(m_t))[..., None]
    wo_m = dot(wo, m_t)
    wi_m = dot(wi, m_t)
    valid_t = (~same) & (wo_m * wi_m < 0.0)
    f_t, _ = fresnel_dielectric(wo_m, eta_i, eta_t)
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
    return value, pdf_r * f_r + pdf_t * (1.0 - f_t)


def _dielectric_rough_sample(mat, wo, u, u_lobe):
    alpha = _alpha(mat.params[..., 0])
    eta_i, eta_t = _dielectric_setup(mat, wo)
    m = ggx_sample_vndf(wo, alpha, u)
    m_signed = m * torch.sign(_cos(wo))[..., None]
    wi_r = 2.0 * dot(wo, m_signed)[..., None] * m_signed - wo
    wi_t, ok_t = _refract(wo, m_signed, eta_i, eta_t)
    f, _ = fresnel_dielectric(dot(wo, m_signed), eta_i, eta_t)
    wi = torch.where(((u_lobe < f) | ~ok_t)[..., None], wi_r, wi_t)
    value, pdf = _dielectric_rough_eval_pdf(mat, wo, wi)
    return Sample(wi, value, pdf, _bool(wo))


def _conductor_fresnel(mat, wo_m):
    artistic = mat.params[..., 1] > 0.5
    eta_a, k_a = artistic_to_physical(mat.albedo, mat.extra)
    eta = torch.where(artistic[..., None], eta_a, torch.clamp(mat.albedo, min=1e-4))
    k = torch.where(artistic[..., None], k_a, mat.extra)
    return fresnel_conductor(wo_m, eta, k)


def _conductor_eval_pdf(mat, wo, wi):
    alpha = _alpha(mat.params[..., 0])
    same = _same(wo, wi)
    m = _unit(wo + wi)
    m = m * torch.sign(_cos(m))[..., None]
    f = _conductor_fresnel(mat, dot(wo, m))
    d = ggx_d(m, alpha)
    g = ggx_g2(wo, wi, alpha)
    denom = torch.clamp(4.0 * _abs_cos(wo) * _abs_cos(wi), min=1e-8)
    value = torch.where(same[..., None], f * (d * g / denom)[..., None], 0.0)
    return value, torch.where(same, ggx_pdf_reflect(wo, m, alpha), 0.0)


def _conductor_specular(mat):
    return torch.clamp(mat.params[..., 0] * 0.75, 0.0, 1.0) ** 2 < ALPHA_THRESHOLD


def _conductor_sample(mat, wo, u):
    alpha = _alpha(mat.params[..., 0])
    is_specular = _conductor_specular(mat)
    m = ggx_sample_vndf(wo, alpha, u)
    m_signed = m * torch.sign(_cos(wo))[..., None]
    wi_g = 2.0 * dot(wo, m_signed)[..., None] * m_signed - wo
    value_g, pdf_g = _conductor_eval_pdf(mat, wo, wi_g)
    wi_s = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)
    value_s = _conductor_fresnel(mat, _cos(wo)) / torch.clamp(_abs_cos(wi_s), min=1e-8)[..., None]
    wi = torch.where(is_specular[..., None], wi_s, wi_g)
    value = torch.where(is_specular[..., None], value_s, value_g)
    return Sample(wi, value, torch.where(is_specular, 1.0, pdf_g), is_specular)


def _pick(mat, rows, zero):
    """Each lane's row of its material type; `zero` for other types."""
    out = zero
    for tid, row in rows:
        out = Sample(*(torch.where((mat.type == tid)[..., None] if c.dim() > mat.type.dim()
                                   else mat.type == tid, c, o) for c, o in zip(row, out)))
    return out


def sample(mat: Material, wo, u2, u_lobe) -> Sample:
    """An incident direction for every lane, by its material type."""
    smooth = _alpha(mat.params[..., 0]) <= ALPHA_THRESHOLD
    s_s = _dielectric_smooth_sample(mat, wo, u_lobe)
    s_r = _dielectric_rough_sample(mat, wo, u2, u_lobe)
    diel = Sample(*(torch.where(smooth[..., None] if a.dim() > smooth.dim() else smooth, a, b)
                    for a, b in zip(s_s, s_r)))
    zero = Sample(torch.zeros_like(wo), torch.zeros_like(wo),
                  torch.zeros(wo.shape[:-1], dtype=wo.dtype, device=wo.device), _bool(wo))
    return _pick(mat, [(DIFFUSE, _diffuse_sample(mat, wo, u2, u_lobe)), (DIELECTRIC, diel),
                       (CONDUCTOR, _conductor_sample(mat, wo, u2))], zero)


def evaluate_pdf(mat: Material, wo, wi):
    """(value, pdf) of the non-delta lobes, for light sampling and MIS."""
    smooth = _alpha(mat.params[..., 0]) <= ALPHA_THRESHOLD
    v_d, p_d = _dielectric_rough_eval_pdf(mat, wo, wi)
    v_c, p_c = _conductor_eval_pdf(mat, wo, wi)
    spec = _conductor_specular(mat)
    rows = [
        (DIFFUSE, (_diffuse_eval(mat, wo, wi), _diffuse_pdf(mat, wo, wi))),
        (DIELECTRIC, (torch.where(smooth[..., None], 0.0, v_d), torch.where(smooth, 0.0, p_d))),
        (CONDUCTOR, (torch.where(spec[..., None], 0.0, v_c), torch.where(spec, 0.0, p_c))),
    ]
    value = torch.zeros_like(wo)
    pdf = torch.zeros(wo.shape[:-1], dtype=wo.dtype, device=wo.device)
    for tid, (v, p) in rows:
        value = torch.where((mat.type == tid)[..., None], v, value)
        pdf = torch.where(mat.type == tid, p, pdf)
    return value, pdf
