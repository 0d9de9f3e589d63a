"""Shared model building blocks: port of ``repro/models/modules.py``.

Plain functions on dicts of tensors.  Inits take a ``torch.Generator``
and a ``device``; they draw from the generator (on its device) and put
the result on ``device``.  There are no sharding specs: the port runs on
one card.

Under ``cfg.gse_serve`` a linear weight is a dict of GSE-SEM segments
(``head``/``tail1`` u16, the (k,) int32 ``table``, and ``tail2`` u32 at
tag 3), packed from f32 values by ``gse.pack32_jnp``.  The reference
multiplies ``jnp.dot(xc, take_weight(w))``; the port calls :func:`linear`,
which casts x to the compute dtype and runs kernel E on the segments, so
the decoded weight never exists in memory.  A dense weight is cast and
multiplied with ``torch.matmul``, as the reference leaves that product to
XLA.  :func:`take_weight` decodes segments with kernel D.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core import gse as G
from repro_torch.core.precision_table import TAG_BITS_USED
from repro_torch.kernels.gse_decode import gse_decode_dense
from repro_torch.kernels.gse_matmul import gse_matmul_dense
from repro_torch.kernels.ref import make_scales

Params = Dict[str, Any]

__all__ = ["linear_weight_init", "pack_linear_weight", "take_weight",
           "linear", "rmsnorm_init", "rmsnorm", "embed_init", "embed",
           "unembed_init", "unembed", "rope", "sinusoidal", "mlp_init", "mlp",
           "is_segments", "segment_read", "table_scales"]


def _normal(gen: torch.Generator, shape, scale: float, dtype, device):
    vals = torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)
    return vals.mul_(scale).to(dtype).to(device)  # in place: one copy held


def is_segments(w) -> bool:
    return isinstance(w, dict) and "head" in w


def pack_linear_weight(vals: torch.Tensor, cfg) -> dict:
    """The ``gse_serve`` segments of f32 ``vals`` (one shared-exponent
    table per tensor), on their device: ``linear_weight_init``'s pack."""
    vals = vals.to(torch.float32)
    table = G.extract_shared_exponents_jnp(vals, cfg.gse_k)
    head, tail1 = G.pack32_jnp(vals, table, cfg.gse_k)
    w = {"head": head, "tail1": tail1, "table": table}
    if cfg.gse_tag >= 3:
        w["tail2"] = torch.zeros(vals.shape, dtype=torch.uint32,
                                 device=vals.device)
    return w


def linear_weight_init(gen, shape, scale, cfg, device):
    """Dense weight in ``cfg.param_dtype`` -- or GSE-SEM segments when
    ``cfg.gse_serve``: one stored copy whose serving tag picks how many
    segment streams the matmul reads (2/4/8 bytes per weight)."""
    if not getattr(cfg, "gse_serve", False):
        return _normal(gen, shape, scale, cfg.param_dtype, device)
    return pack_linear_weight(_normal(gen, shape, scale, torch.float32,
                                      device), cfg)


# Bias-127 scale tables of stored shared-exponent tables, by the tensor
# that owns the table's memory (a layer's table is a view of the stacked
# (L, k) leaf) and bits used.  A table is read on every linear and changes
# only when written in place, which its version counter shows.
_SCALES = WeakIdKeyDictionary()


def table_scales(table: torch.Tensor, bits_used: int) -> torch.Tensor:
    """``make_scales(table, bits_used, bias=127)``, built once per stored
    table (all of a stacked leaf's layers at once) and sliced for views."""
    base = table if table._base is None else table._base
    if not (base.is_contiguous() and table.is_contiguous()
            and base.dtype == table.dtype):
        return make_scales(table, bits_used, bias=127)
    memo = _SCALES.get(base)
    if memo is None or memo[0] != base._version:
        memo = _SCALES[base] = (base._version, {})
    full = memo[1].get(bits_used)
    if full is None:
        full = memo[1][bits_used] = make_scales(base, bits_used,
                                                bias=127).reshape(-1)
    off = table.storage_offset() - base.storage_offset()
    return full[off:off + table.numel()].view(table.shape)


def segment_read(w, cfg):
    """(tag, ei_bit, bias-127 scales) the serving tag reads from ``w``: tag
    3 only where a tail2 is stored, as the reference's ``take_weight``."""
    ei = G._ei_bit(cfg.gse_k)
    tag = 1 if cfg.gse_tag < 2 else (3 if cfg.gse_tag >= 3 and "tail2" in w
                                     else 2)
    return tag, ei, table_scales(w["table"], TAG_BITS_USED[tag] - ei)


def take_weight(w, cfg, dtype) -> torch.Tensor:
    """Materialize a weight for compute: decode GSE-SEM segments with
    kernel D (written in ``dtype``, rounded to nearest even when bf16) or
    cast a dense weight."""
    if is_segments(w):
        tag, ei, scales = segment_read(w, cfg)
        out_dtype = dtype if dtype in (torch.float32, torch.bfloat16) \
            else torch.float32
        out = gse_decode_dense(w["head"], w.get("tail1"), w.get("tail2"),
                               scales, ei_bit=ei, tag=tag, out_dtype=out_dtype,
                               device=w["head"].device)
        return out.to(dtype)
    return w.to(dtype)


def linear(x, w, cfg, dtype, out_dtype=None) -> torch.Tensor:
    """``x @ W`` in the compute ``dtype``: x is cast first; GSE-SEM
    segments run kernel E (f32 sums, the result cast to ``out_dtype``),
    a dense W is cast and multiplied.  ``out_dtype`` (default ``dtype``)
    float32 is the reference's ``preferred_element_type=f32``."""
    out_dtype = out_dtype or dtype
    xc = x.to(dtype)
    if is_segments(w):
        tag, ei, scales = segment_read(w, cfg)
        lead, kk = xc.shape[:-1], xc.shape[-1]
        y = gse_matmul_dense(xc.reshape(-1, kk).contiguous(), w["head"],
                             w.get("tail1"), w.get("tail2"), scales,
                             ei_bit=ei, tag=tag, device=xc.device)
        return y.to(out_dtype).reshape(*lead, y.shape[-1])
    wc = w.to(dtype)
    if out_dtype != dtype:
        return torch.matmul(xc.to(out_dtype), wc.to(out_dtype))
    return torch.matmul(xc, wc)


class _Plain:
    """Stand-in config of the reference's dense fallbacks."""
    gse_serve = False
    cast_before_gather = False
    gse_k = 8
    gse_tag = 2

    def __init__(self, param_dtype=torch.float32):
        self.param_dtype = param_dtype


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device) -> Params:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# Embeddings / unembedding
# ---------------------------------------------------------------------------

def embed_init(gen, vocab: int, d: int, dtype, device) -> Params:
    return {"table": _normal(gen, (vocab, d), 1.0 / math.sqrt(d), dtype,
                             device)}


def embed(p: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # Gather, then cast: the reference casts the table first; the values
    # are the same and only the gathered rows are cast.
    return p["table"][tokens].to(dtype)


def unembed_init(gen, vocab: int, d: int, dtype, cfg=None,
                 device="cuda") -> Params:
    return {"w": linear_weight_init(gen, (d, vocab), 1.0 / math.sqrt(d),
                                    cfg or _Plain(dtype), device)}


def unembed(p: Params, x: torch.Tensor, dtype, cfg=None) -> torch.Tensor:
    """Logits in f32: the vocab product feeds softmax-xent directly."""
    return linear(x, p["w"], cfg or _Plain(), dtype, out_dtype=torch.float32)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, hd) rotated pairwise; positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _fma(a, b, c):
    """f32 ``a * b + c`` rounded once (the product of two f32 is exact in
    f64)."""
    return (a.double() * b.double() + c.double()).float()


# Cephes' exp: log2(e), ln(2) split in two, the polynomial's coefficients.
_CEPHES_EXP = (1.44269504088896341, 0.693359375, -2.12194440e-4,
               (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1))


def _exp_xla(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of f32 ``x`` as XLA's CPU build evaluates it: Cephes'
    range reduction and polynomial with fused multiply-adds (bitwise the
    jitted ``jnp.exp`` on 400,000 seeded values in [-80, 80];
    ``torch.exp`` differs by an ulp in 1 of 32 frequencies at d 64 and 51
    of 512 at d 1024, which the positions multiply)."""
    log2e, c1, c2, poly = _CEPHES_EXP
    one = lambda v: torch.full_like(x, v)  # noqa: E731
    x = torch.clamp(x, -88.3762626647949, 88.3762626647950)
    fx = torch.floor(_fma(x, one(log2e), one(0.5)))
    r = _fma(fx, one(-c1), x)
    r = _fma(fx, one(-c2), r)
    y = one(poly[0])
    for c in poly[1:]:
        y = _fma(y, r, one(c))
    y = _fma(y, r * r, r) + 1.0
    return y * torch.exp2(fx)


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal position table ``(..., d)`` in f32: ``sin`` of the angles
    ``positions * exp(-log(10000) * i / (d/2))``, then their ``cos``.  The
    frequencies are XLA's bit for bit (:func:`_exp_xla`); ``sin`` and
    ``cos`` are torch's, within an ulp of XLA's."""
    half = d // 2
    freqs = _exp_xla(-math.log(10000.0) * torch.arange(
        0, half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU-2mat)
# ---------------------------------------------------------------------------

def mlp_init(gen, d: int, ff: int, act: str, dtype, cfg=None,
             device="cuda") -> Params:
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(ff)
    c = cfg or _Plain(dtype)
    p = {}
    if act == "swiglu":
        p["w_gate"] = linear_weight_init(gen, (d, ff), s_in, c, device)
    p["w_up"] = linear_weight_init(gen, (d, ff), s_in, c, device)
    p["w_down"] = linear_weight_init(gen, (ff, d), s_out, c, device)
    return p


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA evaluates it: ``x * 1 / (1 + exp(-x))``, each
    operation rounded to x's dtype (in bf16, ``torch.nn.functional.silu``
    rounds once and gives other bits)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (approximate) as XLA evaluates it: the tanh form
    ``x * (0.5 * (1 + tanh(c1 * (x + c2 * x^3))))`` with every operation
    and both constants rounded to x's dtype (bf16: 0.796875 and
    0.044677734375), ``x^3`` as ``(x * x) * x``
    (``torch.nn.functional.gelu(approximate="tanh")`` rounds once and gives
    other bits in bf16)."""
    c1 = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype)
    c2 = torch.tensor(0.044715, dtype=x.dtype)
    inner = (x + c2.to(x.device) * ((x * x) * x)) * c1.to(x.device)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def mlp(p: Params, x: torch.Tensor, act: str, dtype, cfg=None):
    xc = x.to(dtype)
    c = cfg or _Plain()
    if act == "swiglu":
        g = linear(xc, p["w_gate"], c, dtype)
        u = linear(xc, p["w_up"], c, dtype)
        h = _silu(g) * u
    else:
        h = _gelu(linear(xc, p["w_up"], c, dtype))
    return linear(h, p["w_down"], c, dtype)
