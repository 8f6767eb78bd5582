"""CLIP text encoder: the twin of polyp_tpu/models/clip_text.py.

State-dict keys are transformers' `CLIPTextModel` keys
(`text_model.embeddings.*`, `text_model.encoder.layers.{i}.*`,
`text_model.final_layer_norm.*`; tests/fixtures/manifests/
sd14_text_encoder.json). Causal attention, quick-GELU MLPs, learned
position embeddings, final LayerNorm (eps 1e-5). The causal attention takes
the plain version, as the reference keeps it on XLA.

`check_token_ids` refuses, on the host, token ids past the model's token
table (a token added to a shared tokenizer for another model, such as a
DreamBooth class's): on the card an embedding lookup past its table is a
device-side assert that ends the process, where the reference's lookup
clamps the id silently.

Tensor parallelism (parallel/sharding.py) splits `CLIPAttention` (q/k/v_proj
column-parallel, out_proj row-parallel) and `CLIPMLP` (fc1 column, fc2 row)
as the UNet's blocks are split (models/unet_blocks.py): f at the block's
input, g after the row-parallel product, the bias after g. The LoRA
trainer shards CLIP; the sampler keeps it whole, as the reference does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from polyp_tpu_torch.models.unet_blocks import LayerNorm, row_parallel
from polyp_tpu_torch.ops import dot_product_attention
from polyp_tpu_torch.parallel.mesh import copy_to_model


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

    tp = None  # the mesh, when shard_params split this block

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
        d = c // self.heads
        heads = self.q_proj.weight.shape[0] // d  # this rank's
        x = copy_to_model(x, self.tp)
        shape = (n, t, heads, d)
        out = dot_product_attention(self.q_proj(x).view(shape),
                                    self.k_proj(x).view(shape),
                                    self.v_proj(x).view(shape),
                                    is_causal=True)
        return row_parallel(self.out_proj, out.reshape(n, t, heads * d),
                            self.tp)


class CLIPMLP(nn.Module):

    tp = None  # the mesh, when shard_params split this block

    def __init__(self, width: int, hidden: int, dtype, device):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden, dtype=dtype, device=device)
        self.fc2 = nn.Linear(hidden, width, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_model(x, self.tp)
        return row_parallel(self.fc2, quick_gelu(self.fc1(x)), self.tp)


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

    @property
    def token_rows(self) -> int:
        """Rows of the token table: the ids the model can look up."""
        return self.text_model.embeddings.token_embedding.num_embeddings

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_model(input_ids)


def check_token_ids(ids, rows: int, tokenizer=None) -> None:
    """Raise ValueError when a token id of `ids` (host ints) lies outside
    a token table of `rows` rows, naming the token (from the tokenizer's
    added tokens, where it is one) and the table size."""
    ids = np.asarray(ids)
    bad = ids[(ids < 0) | (ids >= rows)]
    if bad.size == 0:
        return
    first = int(bad.flat[0])
    names = {v: k for k, v in getattr(tokenizer, "added_tokens", {}).items()}
    raise ValueError(
        f"prompt token {names.get(first, f'#{first}')!r} has id {first}, "
        f"past the text model's token table of {rows} rows (a token added "
        "for another model); this model cannot encode it")
