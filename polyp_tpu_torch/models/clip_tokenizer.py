"""CLIP tokenizer: full byte-level BPE (loads vocab.json + merges.txt) with a
deterministic hash fallback for vocab-file-free environments.

Replaces `CLIPTokenizer.from_pretrained(...)` (train_with_lora_per_class.py:305)
including the DreamBooth surface: `add_tokens` (special tokens sks/zbt/mjt),
`tokenize`, `convert_tokens_to_ids`, and fixed-length (77) padded encoding
(max_length padding parity with train_with_lora_per_class.py:127-132).

The BPE algorithm follows the public CLIP spec: lowercase + whitespace
cleanup, regex pre-tokenization, bytes→unicode mapping, merges ranked by the
merges file, `</w>` end-of-word markers, BOS/EOS = <|startoftext|>/<|endoftext|>.

A copy of polyp_tpu/models/clip_tokenizer.py: the module is pure Python, but
importing it from `polyp_tpu.models` would import flax, so the port carries
its own. tests/test_torch_port_models.py holds the two copies to the same
token ids.
"""

from __future__ import annotations

import functools
import hashlib
import html
import json
import re
from pathlib import Path

import numpy as np

try:  # the `regex` module supports \p{L}/\p{N} — CLIP's real pattern
    import regex as _re

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE)
except ImportError:  # ASCII-only approximation (unicode words degrade)
    _PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
        re.IGNORECASE)

# The official CLIP vocabulary contract (known constants of the published
# assets; used to validate user-supplied vocab/merges files).
CLIP_VOCAB_SIZE = 49408
CLIP_BOS_ID = 49406
CLIP_EOS_ID = 49407


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _basic_clean(text: str) -> str:
    """CLIP's basic_clean minus ftfy (absent here): double HTML unescape.
    ftfy.fix_text only changes mojibake'd input — a no-op for well-formed
    prompts like the reference's."""
    return html.unescape(html.unescape(text)).strip()


def validate_clip_assets(vocab: dict[str, int],
                         bpe_ranks: dict[tuple, int]) -> list[str]:
    """Structural checks that supplied files ARE the official CLIP assets:
    vocab size 49,408, <|startoftext|>=49406, <|endoftext|>=49407, 48,894
    merges, byte-level base symbols present. Returns problems (empty=ok)."""
    problems = []
    if len(vocab) != CLIP_VOCAB_SIZE:
        problems.append(f"vocab size {len(vocab)} != {CLIP_VOCAB_SIZE}")
    if vocab.get("<|startoftext|>") != CLIP_BOS_ID:
        problems.append("<|startoftext|> id != 49406")
    if vocab.get("<|endoftext|>") != CLIP_EOS_ID:
        problems.append("<|endoftext|> id != 49407")
    if len(bpe_ranks) != CLIP_VOCAB_SIZE - 256 * 2 - 2:
        problems.append(f"{len(bpe_ranks)} merges != 48894")
    for sym in bytes_to_unicode().values():
        if sym not in vocab or sym + "</w>" not in vocab:
            problems.append(f"byte symbol {sym!r} missing")
            break
    return problems


class CLIPBPETokenizer:
    """Byte-level BPE tokenizer (needs vocab.json + merges.txt on disk)."""

    def __init__(self, vocab_file: str | Path, merges_file: str | Path,
                 max_length: int = 77, strict: bool = False):
        """`strict=True` requires the files to be the official CLIP assets
        (validate_clip_assets) — use for the pretrained SD path, where a
        wrong vocabulary silently destroys prompt conditioning."""
        self.encoder: dict[str, int] = json.loads(
            Path(vocab_file).read_text(encoding="utf-8"))
        merges = Path(merges_file).read_text(encoding="utf-8").splitlines()
        if merges and merges[0].startswith("#"):
            merges = merges[1:]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges) if m}
        if strict:
            problems = validate_clip_assets(self.encoder, self.bpe_ranks)
            if problems:
                raise ValueError("not the official CLIP assets: "
                                 + "; ".join(problems))
        self.byte_encoder = bytes_to_unicode()
        self.max_length = max_length
        self.bos = "<|startoftext|>"
        self.eos = "<|endoftext|>"
        self.added_tokens: dict[str, int] = {}
        self._cache: dict[str, list[str]] = {}

    # -- vocab surface ----------------------------------------------------
    def __len__(self) -> int:
        return len(self.encoder) + len(self.added_tokens)

    def add_tokens(self, tokens: list[str]) -> int:
        added = 0
        for tok in tokens:
            if tok not in self.encoder and tok not in self.added_tokens:
                self.added_tokens[tok] = len(self)
                added += 1
        return added

    def convert_tokens_to_ids(self, tokens: str | list[str]):
        if isinstance(tokens, str):
            return self._token_id(tokens)
        return [self._token_id(t) for t in tokens]

    def _token_id(self, token: str) -> int:
        if token in self.added_tokens:
            return self.added_tokens[token]
        if token in self.encoder:
            return self.encoder[token]
        # bare words are stored with the end-of-word marker
        return self.encoder.get(token + "</w>", self.encoder[self.eos])

    # -- BPE --------------------------------------------------------------
    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: list[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = list(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> list[str]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        tokens: list[str] = []
        for piece in _PAT.findall(text):
            if piece in self.added_tokens:
                tokens.append(piece)
                continue
            mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            tokens.extend(self._bpe(mapped))
        return tokens

    def _encode_one(self, text: str) -> list[int]:
        ids = [self.encoder[self.bos]]
        for tok in self.tokenize(text):
            if tok in self.added_tokens:
                ids.append(self.added_tokens[tok])
            else:
                ids.append(self.encoder.get(tok, self.encoder[self.eos]))
        ids = ids[: self.max_length - 1]
        ids.append(self.encoder[self.eos])
        # CLIP pads with EOS up to max_length
        ids += [self.encoder[self.eos]] * (self.max_length - len(ids))
        return ids

    def __call__(self, texts: str | list[str]) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        return np.asarray([self._encode_one(t) for t in texts], dtype=np.int32)


class HashTokenizer:
    """Deterministic stand-in tokenizer for environments without CLIP vocab
    files (e.g. hermetic tests): words map to stable hashed ids. NOT
    vocabulary-compatible with CLIP — use only with scratch-trained text
    encoders."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos_id = 0
        self.eos_id = 1
        self.added_tokens: dict[str, int] = {}
        self._extra = 0

    def __len__(self) -> int:
        return self.vocab_size + self._extra

    def add_tokens(self, tokens: list[str]) -> int:
        added = 0
        for tok in tokens:
            if tok not in self.added_tokens:
                self.added_tokens[tok] = self.vocab_size + self._extra
                self._extra += 1
                added += 1
        return added

    def _word_id(self, word: str) -> int:
        if word in self.added_tokens:
            return self.added_tokens[word]
        digest = hashlib.sha256(word.encode()).digest()
        return 2 + int.from_bytes(digest[:4], "little") % (self.vocab_size - 2)

    def tokenize(self, text: str) -> list[str]:
        return _whitespace_clean(text).lower().split()

    def convert_tokens_to_ids(self, tokens: str | list[str]):
        if isinstance(tokens, str):
            return self._word_id(tokens)
        return [self._word_id(t) for t in tokens]

    def __call__(self, texts: str | list[str]) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.max_length), self.eos_id, np.int32)
        for i, text in enumerate(texts):
            ids = [self.bos_id] + [self._word_id(w) for w in self.tokenize(text)]
            ids = ids[: self.max_length - 1] + [self.eos_id]
            out[i, : len(ids)] = ids
        return out


def load_tokenizer(vocab_dir: str | Path | None = None,
                   max_length: int = 77):
    """CLIP BPE if vocab files are available (vocab.json + merges.txt in
    `vocab_dir`), else the hash fallback."""
    if vocab_dir is not None:
        vocab = Path(vocab_dir) / "vocab.json"
        merges = Path(vocab_dir) / "merges.txt"
        if vocab.exists() and merges.exists():
            tok = CLIPBPETokenizer(vocab, merges, max_length)
            problems = validate_clip_assets(tok.encoder, tok.bpe_ranks)
            if problems:
                print("[polyp-tpu] WARNING: tokenizer assets are not the "
                      "official CLIP files: " + "; ".join(problems[:3]))
            return tok
    return HashTokenizer(max_length=max_length)
