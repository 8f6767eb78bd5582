"""DreamBooth token machinery: the twin of polyp_tpu/train/dreambooth.py.

A class's special token (sks / zbt / mjt) gets a new row of the token
embedding table, initialised as w_class·mean(class-phrase embeddings) +
w_polyp·embedding("polyp"). That row is a trainable tensor of its own,
scattered into the frozen table inside the step
(`embed_with_special_rows`), so only it receives gradients: no hooks, no
in-place change of the text encoder.
"""

from __future__ import annotations

import torch

# the class-token map of the reference CLI
SPECIAL_TOKENS = {"AD": "sks", "HP": "zbt", "ASS": "mjt", "REST": "zbt"}
CLASS_PHRASES = {
    "AD": "adenomatous",
    "HP": "hyperplastic",
    "ASS": "sessile serrated",
    "REST": "hyperplastic and sessile serrated",
}


def resize_token_embeddings(table: torch.Tensor, new_vocab_size: int,
                            generator: torch.Generator) -> torch.Tensor:
    """The table grown to `new_vocab_size` rows, new rows N(0, 0.02) in the
    table's dtype (a new tensor; `table` is unchanged)."""
    old, width = table.shape
    if new_vocab_size <= old:
        return table
    extra = torch.randn(new_vocab_size - old, width, generator=generator,
                        device=generator.device) * 0.02
    return torch.cat([table, extra.to(table.device, table.dtype)])


def dreambooth_token_init(table: torch.Tensor, tokenizer, cls: str,
                          weight_token_class: float = 0.5,
                          weight_token_polyp: float = 0.5,
                          class_condition: bool = False) -> torch.Tensor:
    """The special token's first embedding (fp32 [width]):
    w_class·mean(embeddings of the class phrase's tokens) +
    w_polyp·embedding("polyp")."""
    table = table.float()
    polyp_emb = table[tokenizer.convert_tokens_to_ids("polyp")]
    phrase = cls if class_condition else CLASS_PHRASES[cls]
    ids = torch.as_tensor(tokenizer.convert_tokens_to_ids(
        tokenizer.tokenize(phrase)), device=table.device)
    return (weight_token_class * table[ids].mean(dim=0)
            + weight_token_polyp * polyp_emb)


def embed_with_special_rows(table: torch.Tensor, special_rows: torch.Tensor,
                            special_ids: torch.Tensor) -> torch.Tensor:
    """The frozen `table` with `special_rows` at `special_ids`: a new
    tensor whose gradient flows into `special_rows` only."""
    return torch.index_put(table.detach(), (special_ids.to(table.device),),
                           special_rows.to(table.dtype))


def dreambooth_prompt(cls: str, unconditional: bool, class_condition: bool,
                      dreambooth: bool) -> str:
    """The prompt-selection matrix of the reference CLI."""
    if unconditional:
        return ""
    special = SPECIAL_TOKENS[cls]
    phrase = CLASS_PHRASES[cls]
    if class_condition:
        # the reference overwrites the DreamBooth variant with the bare class
        return f"{cls}"
    if dreambooth:
        return f"a high-resolution endoscopic image of {special} {phrase} polyp"
    return f"a high-resolution endoscopic image of {phrase} polyp"


def resume_prompt(cls: str, unconditional: bool) -> str:
    """The prompt of the reference CLI's resume / top-up branch."""
    if unconditional:
        return ""
    special = SPECIAL_TOKENS[cls]
    phrase = CLASS_PHRASES[cls]
    return (f"a realistic high-resolution medical endoscopy image of "
            f"{special} {phrase} polyp")
