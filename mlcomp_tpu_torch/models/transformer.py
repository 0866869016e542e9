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

``matmul_precision: int8`` builds ``models/quant.py``'s
``Int8DenseGeneral`` for ``qkv``, ``out``, ``wi_gate``, ``wi_up`` and
``wo`` (the same ``weight`` parameter as ``Dense``; its product is the
dynamic int8 training matmul), and keeps ``lm_head`` a ``Dense``, as the
JAX package does.

Weights are stored the PyTorch way (a projection's ``weight`` is
``[out, in]``); ``convert.py`` maps them to and from the JAX trees in
both ``scan_layers`` layouts (``lm_kernel_shapes`` there names the JAX
kernel's shape of each projection). Knobs this port does not implement
yet raise: ``n_experts > 0`` (MoE) and a mesh.
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
    if cfg.n_experts:
        raise NotImplementedError(
            'n_experts > 0 (MoE) is not ported yet (ROADMAP.md, queue A: '
            'parallel and distributed)')
    resolve_impl(cfg.attn_impl)
    if cfg.d_model % cfg.n_heads:
        raise ValueError(
            f'd_model {cfg.d_model} is not divisible by n_heads '
            f'{cfg.n_heads}')


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


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        dtype, pdtype = torch_dtype(cfg.dtype), torch_dtype(cfg.param_dtype)
        self.norm_attn = RMSNorm(cfg.d_model, dtype, pdtype, device=device)
        self.attn = Attention(cfg, device)
        self.norm_mlp = RMSNorm(cfg.d_model, dtype, pdtype, device=device)
        self.mlp = MlpBlock(cfg, device)

    def forward(self, x, seed: Optional[int] = None):
        """``seed`` (training with dropout): this layer's dropout masks
        come from a device generator seeded with it, so a recompute under
        ``checkpoint`` draws the same ones."""
        gen = None
        if seed is not None:
            gen = torch.Generator(x.device).manual_seed(seed)
        x = x + self.attn(self.norm_attn(x), gen)
        return x + self.mlp(self.norm_mlp(x), gen)


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
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device) for _ in range(cfg.n_layers))
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

    def forward(self, tokens, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Logits [B, T, V]. ``train``: dropout with masks from
        ``generator`` (a CPU ``torch.Generator``; required when
        ``dropout`` > 0) and ``remat`` checkpointing take effect."""
        cfg = self.cfg
        seeds = [None] * cfg.n_layers
        if train and cfg.dropout:
            if generator is None:
                raise ValueError(
                    'train=True with dropout > 0 needs a generator for the '
                    'dropout masks')
            seeds = torch.randint(0, 2 ** 62, (cfg.n_layers,),
                                  generator=generator).tolist()
        x = embed_lookup(self.embed, tokens).to(self.dtype)
        x = x + self.pos_embed[:tokens.shape[1]].to(self.dtype)
        for layer, seed in zip(self.layers, seeds):
            if train and cfg.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(
                    layer, x, seed, use_reentrant=False)
            else:
                x = layer(x, seed)
        return self.lm_head(self.norm_final(x))


@register_model('transformer_lm')
def _transformer(mesh=None, device=None, generator=None, **kwargs):
    if mesh is not None:
        raise NotImplementedError(
            'a device mesh (sharded transformer) is not ported yet '
            '(ROADMAP.md, queue A: parallel and distributed)')
    fields = {f.name for f in dataclasses.fields(TransformerConfig)}
    cfg = TransformerConfig(
        **{k: v for k, v in kwargs.items() if k in fields})
    return TransformerLM(cfg, device=device, generator=generator)


__all__ = ['TransformerConfig', 'TransformerLM', 'DecoderLayer',
           'Attention', 'MlpBlock', 'RMSNorm', 'Dense', 'Int8DenseGeneral',
           'projection', 'dropout',
           'embed_lookup', 'torch_dtype']
