"""Vision Transformer classifier — port of ``mlcomp_tpu/models/vit.py``.

The transformer's ``DecoderLayer`` with ``causal=False`` over the
patches of an NHWC image, with the JAX package's numerics:

- patchify as one reshape (``[B, H/p, p, W/p, p, C]`` → ``[B, n,
  p·p·C]``, the JAX order) and a bias-free ``patch_embed`` projection in
  ``dtype``;
- a learned ``pos_embed`` [n, d] (n = ``max_seq_len``, the declared
  resolution's patch count), the pre-LN encoder stack, a final RMSNorm;
- a mean over the patches and a bias-free f32 ``head``.

Attention is ``ops.fused_attention`` non-causal: on the card the CUDA
flash kernels' non-causal branch, forward and (training) backward.
The three ``ValueError``s are JAX's: an image side not divisible by the
patch, a patch count other than the declared one (both when called),
and ``scan_layers=True`` (when built: ViT keeps the per-layer layout).
Parameters other than the layers' are f32, as JAX's ViT declares them.
"""

from typing import Optional

import torch
from torch import nn

from mlcomp_tpu_torch.models.base import register_model
from mlcomp_tpu_torch.models.transformer import (
    Dense, DecoderLayer, RMSNorm, TransformerConfig, check_config,
    run_layers, torch_dtype,
)


class ViT(nn.Module):
    def __init__(self, cfg: TransformerConfig, num_classes: int,
                 patch_size: int = 4, channels: int = 3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.scan_layers is True:
            raise ValueError(
                "ViT does not implement scan_layers=True yet — leave it "
                "'auto' (transformer_lm has the scanned stack)")
        check_config(cfg)
        self.cfg, self.patch_size = cfg, patch_size
        self.dtype = torch_dtype(cfg.dtype)
        f32 = torch.float32
        self.patch_embed = Dense(patch_size * patch_size * channels,
                                 cfg.d_model, self.dtype, f32, device)
        self.pos_embed = nn.Parameter(torch.empty(
            cfg.max_seq_len, cfg.d_model, dtype=f32, device=device))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device) for _ in range(cfg.n_layers))
        self.norm_final = RMSNorm(cfg.d_model, self.dtype, f32,
                                  device=device)
        self.head = Dense(cfg.d_model, num_classes, f32, f32, device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX initialisers' distributions (normal(0.02) position
        table, lecun-normal projections, unit norm scales)."""
        if generator is None:
            generator = torch.Generator(self.pos_embed.device).manual_seed(0)
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        for module in self.modules():
            if isinstance(module, Dense):
                module.weight.normal_(0.0, module.weight.shape[1] ** -0.5,
                                      generator=generator)
            elif isinstance(module, RMSNorm):
                module.scale.fill_(1.0)

    def forward(self, images, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Logits [B, num_classes] f32 of NHWC ``images``. ``train``:
        dropout and ``remat`` take effect (``run_layers``)."""
        cfg, p = self.cfg, self.patch_size
        b, h, w, c = images.shape
        if h % p or w % p:
            raise ValueError(
                f'image {h}x{w} not divisible by patch_size={p}')
        n = (h // p) * (w // p)
        if n != cfg.max_seq_len:
            raise ValueError(
                f'{h}x{w}/p{p} gives {n} patches but the model was '
                f'declared for {cfg.max_seq_len} '
                f'(image_size/patch_size mismatch)')
        x = images.to(self.dtype).reshape(b, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, n, p * p * c)
        x = self.patch_embed(x) + self.pos_embed.to(self.dtype)
        x, _ = run_layers(self.layers, cfg, x, train, generator)
        return self.head(self.norm_final(x).mean(dim=1))


@register_model('vit')
def _vit(num_classes: int, image_size: int = 32, patch_size: int = 4,
         d_model: int = 192, n_layers: int = 6, n_heads: int = 3,
         d_ff: int = 768, dropout: float = 0.0, dtype: str = 'bfloat16',
         remat: bool = False, attn_impl: str = 'auto', mesh=None,
         input_shape=None, device=None, generator=None, **kwargs):
    """``model: {name: vit, num_classes: 10, patch_size: 4}`` with the
    JAX package's defaults (a ViT-Ti-ish encoder for 32x32 inputs).
    ``input_shape`` (H, W, C) gives the channels, 3 without it."""
    if mesh is not None:
        raise NotImplementedError(
            'a device mesh (sharded ViT) is not ported yet (ROADMAP.md, '
            'queue A: A4 parallel and distributed)')
    cfg = TransformerConfig(
        vocab_size=1, d_model=d_model, n_layers=n_layers, n_heads=n_heads,
        d_ff=d_ff, max_seq_len=(image_size // patch_size) ** 2,
        dropout=dropout, dtype=dtype, remat=remat, attn_impl=attn_impl,
        causal=False, scan_layers=kwargs.get('scan_layers', 'auto'))
    channels = int(input_shape[-1]) if input_shape else 3
    return ViT(cfg, num_classes=num_classes, patch_size=patch_size,
               channels=channels, device=device, generator=generator)


__all__ = ['ViT']
