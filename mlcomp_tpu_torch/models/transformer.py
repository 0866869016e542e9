"""Decoder-only Transformer LM — port of ``mlcomp_tpu/models/transformer.py``.

The dense, unsharded LM as ``nn.Module``s, with the JAX package's
numerics:

- activations run in ``dtype`` (bf16 by default) from f32 params: every
  projection casts its input and weight to ``dtype`` (flax
  ``DenseGeneral``), the lm_head to ``head_dtype or dtype``;
- RMSNorm is flax's ``nn.RMSNorm``: epsilon 1e-6, statistics in f32,
  output cast to ``dtype``;
- attention goes through ``ops.fused_attention(impl=cfg.attn_impl)``,
  the hand-written CUDA flash kernels for CUDA tensors (forward, and the
  backward kernels when autograd needs a gradient);
- the embedding lookup reproduces ``jnp.take`` on the CPU: a negative id
  wraps once, an id out of range gives a NaN row — without indexing out
  of range, which on CUDA would be a device-side assert that poisons the
  process's CUDA context.

``forward(tokens, train=True, generator=...)`` is the training mode:
dropout (flax ``nn.Dropout``: keep with probability 1 - rate, kept values
divided by it) after the attention output projection and after ``wo``,
its masks drawn from a ``torch.Generator`` (a CPU generator that seeds
one device generator per layer, so a recomputed layer draws the same
masks), and with ``remat`` each ``DecoderLayer`` under
``torch.utils.checkpoint`` (non-reentrant), whose recompute launches the
attention forward again. At eval both have no effect, as in JAX.

``n_experts > 0`` makes every ``moe_every``-th layer (layer ``i`` with
``i % moe_every == moe_every - 1``) a ``MoeMlpBlock``: Switch top-1
routing with a static capacity, as the JAX package's. Its load-balance
loss is not kept on the module: ``forward(..., return_aux=True)``
returns it with the logits, summed over the MoE layers, and the train
step adds it (``train/loop.py``).

``matmul_precision: int8`` builds ``models/quant.py``'s
``Int8DenseGeneral`` for ``qkv``, ``out``, ``wi_gate``, ``wi_up`` and
``wo`` (the same ``weight`` parameter as ``Dense``; its product is the
dynamic int8 training matmul), and keeps ``lm_head`` a ``Dense``, as the
JAX package does.

Weights are stored the PyTorch way (a projection's ``weight`` is
``[out, in]``); ``convert.py`` maps them to and from the JAX trees in
both ``scan_layers`` layouts (``lm_kernel_shapes`` there names the JAX
kernel's shape of each projection; an MoE stack has the per-layer
layout only). A mesh (sharding, experts over ``ep``) is not ported yet
and raises.
"""

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from mlcomp_tpu_torch.models.base import register_model
from mlcomp_tpu_torch.models.quant import Int8DenseGeneral
from mlcomp_tpu_torch.ops.flash_attention import (
    fused_attention, resolve_impl,
)

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
           'float16': torch.float16, 'float64': torch.float64}


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(
            f'dtype must be one of {sorted(_DTYPES)}, got {name!r}') from None


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Every field of the JAX ``TransformerConfig``, same defaults."""
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    d_ff: int = 2048
    max_seq_len: int = 2048
    dropout: float = 0.0
    dtype: str = 'bfloat16'
    remat: bool = False
    # 'auto' = the CUDA flash kernel for CUDA tensors, the plain version
    # on the CPU; 'cuda' / 'dense' force one; a JAX export's 'pallas' /
    # 'interpret' read as 'cuda' / 'auto'
    attn_impl: str = 'auto'
    head_dtype: Optional[str] = None
    causal: bool = True
    n_experts: int = 0
    moe_every: int = 2
    capacity_factor: float = 1.25
    # the parameter LAYOUT of the JAX export ('auto' = stacked 'layers'
    # when homogeneous); the port's module is the same either way
    scan_layers: Any = 'auto'
    matmul_precision: str = 'bf16'
    param_dtype: str = 'float32'

    @property
    def head_dim(self):
        return self.d_model // self.n_heads


def check_config(cfg: TransformerConfig):
    """Fail loudly on what the port does not implement."""
    if cfg.matmul_precision not in ('bf16', 'int8'):
        raise ValueError(
            f"matmul_precision must be 'bf16' or 'int8', "
            f'got {cfg.matmul_precision!r}')
    if cfg.n_experts and scan_layers(cfg):
        raise ValueError(
            'scan_layers=True needs a homogeneous stack — the MoE '
            'interleave (n_experts>0) makes every moe_every-th layer a '
            "different program; use scan_layers=False or leave it 'auto'")
    resolve_impl(cfg.attn_impl)
    if cfg.d_model % cfg.n_heads:
        raise ValueError(
            f'd_model {cfg.d_model} is not divisible by n_heads '
            f'{cfg.n_heads}')


def scan_layers(cfg: TransformerConfig) -> bool:
    """Does the JAX package stack this config's layers (``nn.scan``)?
    ``auto`` does unless the stack has MoE layers."""
    if cfg.scan_layers == 'auto':
        return not cfg.n_experts
    return bool(cfg.scan_layers)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, tokens, axis=0)`` as JAX computes it on the CPU:
    ids in [-V, 0) wrap, every other id outside [0, V) gives a row of
    NaN. The gather reads only in-range rows."""
    v = table.shape[0]
    tokens = tokens.long()
    idx = torch.where(tokens < 0, tokens + v, tokens)
    valid = (idx >= 0) & (idx < v)
    rows = table[torch.where(valid, idx, torch.zeros_like(idx))]
    return rows.masked_fill(~valid.unsqueeze(-1), float('nan'))


class Dense(nn.Module):
    """flax ``DenseGeneral(use_bias=False)``: input and weight cast to
    ``dtype``, product in ``dtype``. ``weight`` is ``[out, in]``."""

    def __init__(self, d_in: int, d_out: int, dtype, param_dtype,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(d_out, d_in, dtype=param_dtype, device=device))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


def projection(cfg: 'TransformerConfig', d_in: int, d_out: int, device=None):
    """A bias-free projection of the layers: ``Dense``, or at
    ``matmul_precision: int8`` ``Int8DenseGeneral`` (the JAX ``_dense``'s
    choice; the same parameter either way)."""
    cls = Int8DenseGeneral if cfg.matmul_precision == 'int8' else Dense
    return cls(d_in, d_out, torch_dtype(cfg.dtype),
               torch_dtype(cfg.param_dtype), device)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: ``x * (rsqrt(mean(x²) + eps) * scale)`` in
    f32, cast to ``dtype``."""

    def __init__(self, dim: int, dtype, param_dtype, eps: float = 1e-6,
                 device=None):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=param_dtype, device=device))

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        return (xf * mul).to(self.dtype)


def dropout(x, rate: float, generator: Optional[torch.Generator]):
    """flax ``nn.Dropout`` in training: keep each value with probability
    ``1 - rate`` (mask from ``generator``) and divide the kept ones by
    it; ``rate`` 0 (or no generator: eval) is the identity."""
    if not rate or generator is None:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.empty(x.shape, device=x.device).bernoulli_(
        keep, generator=generator).bool()
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, d = cfg.n_heads, cfg.head_dim
        self.qkv = projection(cfg, cfg.d_model, 3 * h * d, device)
        self.out = projection(cfg, h * d, cfg.d_model, device)

    def forward(self, x, generator=None):
        cfg = self.cfg
        b, t, _ = x.shape
        qkv = self.qkv(x).view(b, t, 3, cfg.n_heads, cfg.head_dim)
        # strided views into qkv: the kernels read them in place
        q, k, v = qkv.unbind(dim=2)
        out = fused_attention(q, k, v, causal=cfg.causal,
                              impl=cfg.attn_impl)
        out = self.out(out.reshape(b, t, cfg.n_heads * cfg.head_dim))
        return dropout(out, cfg.dropout, generator)


class MlpBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.wi_gate = projection(cfg, cfg.d_model, cfg.d_ff, device)
        self.wi_up = projection(cfg, cfg.d_model, cfg.d_ff, device)
        self.wo = projection(cfg, cfg.d_ff, cfg.d_model, device)

    def forward(self, x, generator=None):
        y = self.wo(F.silu(self.wi_gate(x)) * self.wi_up(x))
        return dropout(y, self.cfg.dropout, generator)


class MoeMlpBlock(nn.Module):
    """Switch-style top-1 mixture-of-experts MLP, the JAX package's
    dense-dispatch formulation: an f32 router (bias-free, its own f32
    parameter), softmax, the top expert's probability as the gate (the
    first index on ties, as ``jnp.argmax``), a static capacity of
    ``max(1, int(capacity_factor * T / X))`` tokens an expert filled in
    token order, and overflow tokens left to the residual path. Dispatch
    and combine are [B, T, X, C] one-hots cast to ``dtype`` before the
    einsums; the expert MLP is ``silu`` of one input projection.
    ``w_in`` [X, M, F] and ``w_out`` [X, F, M] are stored as the JAX
    tree holds them, in ``param_dtype``.

    ``forward`` returns (y, aux): aux is the Switch load-balance loss
    ``X · Σ_x density_x · mean prob_x`` (f32), which JAX sows."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        x, m, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        pdtype = torch_dtype(cfg.param_dtype)
        self.router = Dense(m, x, torch.float32, torch.float32, device)
        self.w_in = nn.Parameter(
            torch.empty(x, m, f, dtype=pdtype, device=device))
        self.w_out = nn.Parameter(
            torch.empty(x, f, m, dtype=pdtype, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """normal(0.02) router; lecun-normal experts over flax's fan-in
        of a 3-D kernel (the expert axis counts as receptive field)."""
        x, m, f = self.w_in.shape
        self.router.weight.normal_(0.0, 0.02, generator=generator)
        self.w_in.normal_(0.0, (x * m) ** -0.5, generator=generator)
        self.w_out.normal_(0.0, (x * f) ** -0.5, generator=generator)

    def forward(self, x, generator=None):
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        n_x = cfg.n_experts
        _, t, _ = x.shape
        capacity = max(1, int(cfg.capacity_factor * t / n_x))

        probs = torch.softmax(self.router(x.float()), dim=-1)   # [B,T,X]
        gate = probs.amax(dim=-1)                               # [B,T]
        one_hot = F.one_hot(probs.argmax(dim=-1), n_x)          # [B,T,X]
        aux = n_x * (one_hot.float().mean(dim=(0, 1))
                     * probs.mean(dim=(0, 1))).sum()

        # each token's slot in its expert's buffer (-1 where not routed;
        # slots past the capacity match no column: the token overflows).
        # The running count goes along the last dim: a scan over T as
        # dim 1 of [B, T, X] runs B·X threads serially on the card. pos
        # is made contiguous again, or the [B, T, X, C] compare below
        # takes the slow strided path
        count = one_hot.transpose(1, 2).cumsum(dim=-1).transpose(1, 2)
        pos = (count * one_hot - 1).contiguous()                 # [B,T,X]
        slots = torch.arange(capacity, device=x.device)
        # built in dtype: its values are 0 and 1, so this is JAX's f32
        # dispatch cast to dtype, and combine (one gate a token) is its
        # f32 dispatch * gate cast to dtype, bit for bit
        dispatch = (pos.unsqueeze(-1) == slots).to(dtype)       # [B,T,X,C]
        combine = dispatch * gate.to(dtype)[..., None, None]

        expert_in = torch.einsum('btxc,btm->xbcm', dispatch, x.to(dtype))
        h = F.silu(torch.einsum('xbcm,xmf->xbcf', expert_in,
                                self.w_in.to(dtype)))
        out = torch.einsum('xbcf,xfm->xbcm', h, self.w_out.to(dtype))
        y = torch.einsum('btxc,xbcm->btm', combine, out)
        return dropout(y, cfg.dropout, generator), aux


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None,
                 use_moe: bool = False):
        super().__init__()
        dtype, pdtype = torch_dtype(cfg.dtype), torch_dtype(cfg.param_dtype)
        self.norm_attn = RMSNorm(cfg.d_model, dtype, pdtype, device=device)
        self.attn = Attention(cfg, device)
        self.norm_mlp = RMSNorm(cfg.d_model, dtype, pdtype, device=device)
        if use_moe:
            self.moe = MoeMlpBlock(cfg, device)
        else:
            self.mlp = MlpBlock(cfg, device)

    def forward(self, x, seed: Optional[int] = None):
        """(x, aux): aux is the MoE block's load-balance loss, None for a
        dense layer. ``seed`` (training with dropout): this layer's
        dropout masks come from a device generator seeded with it, so a
        recompute under ``checkpoint`` draws the same ones."""
        gen = None
        if seed is not None:
            gen = torch.Generator(x.device).manual_seed(seed)
        x = x + self.attn(self.norm_attn(x), gen)
        if hasattr(self, 'moe'):
            y, aux = self.moe(self.norm_mlp(x), gen)
            return x + y, aux
        return x + self.mlp(self.norm_mlp(x), gen), None


def run_layers(layers, cfg: TransformerConfig, x, train: bool,
               generator: Optional[torch.Generator]):
    """(x, aux) through the decoder ``layers``: aux sums the MoE layers'
    load-balance losses (None without any). ``train``: dropout with
    masks from ``generator`` (a CPU ``torch.Generator``; required when
    ``dropout`` > 0) and ``remat`` checkpointing take effect."""
    seeds = [None] * len(layers)
    if train and cfg.dropout:
        if generator is None:
            raise ValueError(
                'train=True with dropout > 0 needs a generator for the '
                'dropout masks')
        seeds = torch.randint(0, 2 ** 62, (len(layers),),
                              generator=generator).tolist()
    total = None
    for layer, seed in zip(layers, seeds):
        if train and cfg.remat and torch.is_grad_enabled():
            x, aux = torch.utils.checkpoint.checkpoint(
                layer, x, seed, use_reentrant=False)
        else:
            x, aux = layer(x, seed)
        if aux is not None:
            total = aux if total is None else total + aux
    return x, total


class TransformerLM(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        pdtype = torch_dtype(cfg.param_dtype)
        self.embed = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.d_model, dtype=pdtype, device=device))
        self.pos_embed = nn.Parameter(torch.empty(
            cfg.max_seq_len, cfg.d_model, dtype=pdtype, device=device))
        # every moe_every-th layer is MoE (the Switch interleave)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device, use_moe=bool(cfg.n_experts) and (
                i % cfg.moe_every == cfg.moe_every - 1))
            for i in range(cfg.n_layers))
        self.norm_final = RMSNorm(cfg.d_model, self.dtype, pdtype,
                                  device=device)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size,
                             torch_dtype(cfg.head_dtype or cfg.dtype),
                             pdtype, device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX initialisers' distributions (normal(0.02) embeddings,
        lecun-normal projections, unit norm scales); the numbers differ
        from JAX's, so tests hand both packages the same weights."""
        if generator is None:
            generator = torch.Generator(self.embed.device).manual_seed(0)
        self.embed.normal_(0.0, 0.02, generator=generator)
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        for module in self.modules():
            if isinstance(module, (Dense, Int8DenseGeneral)):
                fan_in = module.weight.shape[1]
                module.weight.normal_(0.0, fan_in ** -0.5,
                                      generator=generator)
            elif isinstance(module, RMSNorm):
                module.scale.fill_(1.0)
        for module in self.modules():
            if isinstance(module, MoeMlpBlock):
                module.reset_parameters(generator)

    @property
    def has_moe(self) -> bool:
        return bool(self.cfg.n_experts)

    def forward(self, tokens, train: bool = False,
                generator: Optional[torch.Generator] = None,
                return_aux: bool = False):
        """Logits [B, T, V], or with ``return_aux`` (logits, aux): aux is
        the MoE layers' summed load-balance loss (f32), None for a dense
        stack. ``train``: dropout and ``remat`` take effect
        (``run_layers``)."""
        x = embed_lookup(self.embed, tokens).to(self.dtype)
        x = x + self.pos_embed[:tokens.shape[1]].to(self.dtype)
        x, aux = run_layers(self.layers, self.cfg, x, train, generator)
        logits = self.lm_head(self.norm_final(x))
        return (logits, aux) if return_aux else logits


@register_model('transformer_lm')
def _transformer(mesh=None, device=None, generator=None, **kwargs):
    if mesh is not None:
        raise NotImplementedError(
            'a device mesh (a sharded transformer, MoE experts over ep) is '
            'not ported yet (ROADMAP.md, queue A: A4 parallel and '
            'distributed)')
    fields = {f.name for f in dataclasses.fields(TransformerConfig)}
    cfg = TransformerConfig(
        **{k: v for k, v in kwargs.items() if k in fields})
    return TransformerLM(cfg, device=device, generator=generator)


__all__ = ['TransformerConfig', 'TransformerLM', 'DecoderLayer',
           'Attention', 'MlpBlock', 'MoeMlpBlock', 'RMSNorm', 'run_layers',
           'scan_layers', 'check_config', 'Dense', 'Int8DenseGeneral',
           'projection', 'dropout',
           'embed_lookup', 'torch_dtype']
