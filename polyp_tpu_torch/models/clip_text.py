"""CLIP text encoder: the twin of polyp_tpu/models/clip_text.py.

State-dict keys are transformers' `CLIPTextModel` keys
(`text_model.embeddings.*`, `text_model.encoder.layers.{i}.*`,
`text_model.final_layer_norm.*`; tests/fixtures/manifests/
sd14_text_encoder.json). Causal attention, quick-GELU MLPs, learned
position embeddings, final LayerNorm (eps 1e-5). The causal attention takes
the plain version, as the reference keeps it on XLA.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from polyp_tpu_torch.models.unet_blocks import LayerNorm
from polyp_tpu_torch.ops import dot_product_attention


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    max_length: int = 77
    mlp_ratio: int = 4


SD14_TEXT_CONFIG = CLIPTextConfig()  # ViT-L/14 text tower
# clip-vit-base-patch32's text tower (the scratch CLI's conditioning)
VIT_B32_TEXT_CONFIG = CLIPTextConfig(width=512, heads=8)
TINY_TEXT_CONFIG = CLIPTextConfig(vocab_size=512, width=32, layers=2, heads=2,
                                  max_length=16)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):

    def __init__(self, width: int, heads: int, dtype, device):
        super().__init__()
        self.heads = heads
        kw = dict(dtype=dtype, device=device)
        self.q_proj = nn.Linear(width, width, **kw)
        self.k_proj = nn.Linear(width, width, **kw)
        self.v_proj = nn.Linear(width, width, **kw)
        self.out_proj = nn.Linear(width, width, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, c = x.shape
        shape = (n, t, self.heads, c // self.heads)
        out = dot_product_attention(self.q_proj(x).view(shape),
                                    self.k_proj(x).view(shape),
                                    self.v_proj(x).view(shape),
                                    is_causal=True)
        return self.out_proj(out.reshape(n, t, c))


class CLIPMLP(nn.Module):

    def __init__(self, width: int, hidden: int, dtype, device):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden, dtype=dtype, device=device)
        self.fc2 = nn.Linear(hidden, width, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):

    def __init__(self, cfg: CLIPTextConfig, dtype, device):
        super().__init__()
        self.self_attn = CLIPAttention(cfg.width, cfg.heads, dtype, device)
        self.layer_norm1 = LayerNorm(cfg.width, device=device)
        self.mlp = CLIPMLP(cfg.width, cfg.width * cfg.mlp_ratio, dtype, device)
        self.layer_norm2 = LayerNorm(cfg.width, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):

    def __init__(self, cfg: CLIPTextConfig, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width, **kw)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.width, **kw)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        t = input_ids.shape[1]
        return (self.token_embedding(input_ids)
                + self.position_embedding.weight[:t])


class CLIPEncoder(nn.Module):

    def __init__(self, cfg: CLIPTextConfig, dtype, device):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg, dtype, device)
                                     for _ in range(cfg.layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class CLIPTextTransformer(nn.Module):

    def __init__(self, cfg: CLIPTextConfig, dtype, device):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg, dtype, device)
        self.encoder = CLIPEncoder(cfg, dtype, device)
        self.final_layer_norm = LayerNorm(cfg.width, device=device)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.final_layer_norm(self.encoder(self.embeddings(input_ids)))


class CLIPTextModel(nn.Module):
    """input_ids [N, T] → last hidden state [N, T, width] in `dtype`."""

    def __init__(self, config: CLIPTextConfig = SD14_TEXT_CONFIG,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config, dtype, device)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_model(input_ids)
