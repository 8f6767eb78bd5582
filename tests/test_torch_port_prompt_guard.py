"""A prompt token past the text model's table is refused on the host.

A DreamBooth bundle attached to the shared stack registers its class
token in the shared tokenizer (cli/sd_common.py::attach_bundle), so a
prompt holding that token, sent to a model whose token table lacks the
row, would index past `nn.Embedding`: on the card a device-side assert
that ends the process. The sampler checks the ids first
(models/clip_text.py::check_token_ids) and raises ValueError naming the
token and the table size; the service answers that request with it (HTTP
400) and goes on serving. Valid prompts encode exactly as before.
"""

from __future__ import annotations

import argparse

import pytest
import torch

from polyp_tpu_torch import serve as tserve
from polyp_tpu_torch.cli import common as tcommon
from polyp_tpu_torch.models.clip_text import check_token_ids
from polyp_tpu_torch.models.clip_tokenizer import HashTokenizer
from polyp_tpu_torch.train.dreambooth import SPECIAL_TOKENS

TOKEN = SPECIAL_TOKENS["AD"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file (and its spawned ranks, which
    split this process's threads): the tiny models' many small CPU ops
    each open an OpenMP region, which waits for cores when the suite's
    parallel workers each run a thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def stack():
    stack = tcommon.load_sd_stack(tiny=True, dtype=torch.float32,
                                  device="cpu")
    # what attaching a DreamBooth bundle does to the shared tokenizer
    stack.tokenizer.add_tokens([TOKEN])
    return stack


def test_check_token_ids_names_the_token_and_the_table():
    tok = HashTokenizer(vocab_size=100, max_length=8)
    tok.add_tokens(["sks"])
    check_token_ids(tok(["a colon polyp"]), 100, tok)
    with pytest.raises(ValueError, match=r"'sks' has id 100, past the text "
                                         r"model's token table of 100 rows"):
        check_token_ids(tok(["a sks polyp"]), 100, tok)
    with pytest.raises(ValueError, match=r"'#-1'"):
        check_token_ids([[0, -1]], 100)


def test_valid_prompts_encode_as_before(stack, monkeypatch):
    monkeypatch.setattr(tcommon, "load_sd_stack",
                        lambda *args, **kwargs: stack)
    sampler = tserve.sampler_from_args(_args())
    ids = torch.as_tensor(stack.tokenizer(["a colon polyp"]))
    with torch.no_grad():
        want = stack.text(ids)
    sampler.check_prompt("a colon polyp")
    assert torch.equal(sampler.encode_prompt("a colon polyp"), want)
    with pytest.raises(ValueError, match=TOKEN):
        sampler.encode_prompt(f"a {TOKEN} polyp")


def _args() -> argparse.Namespace:
    return argparse.Namespace(
        distilled_dir=None, pretrained_dir=None, tiny=True, device="cpu",
        image_size=16, steps=2, quantize=None, quant_fp_head=0,
        quant_fp_tail=0, vae_decoder="full", tiny_decoder_dir=None,
        max_batch=2, batch_window_ms=1.0, pipeline_depth=1, max_pending=8,
        request_timeout_s=None)


def test_the_service_refuses_the_prompt_and_keeps_serving(stack,
                                                         monkeypatch):
    monkeypatch.setattr(tcommon, "load_sd_stack",
                        lambda *args, **kwargs: stack)
    service = tserve.service_from_args(_args())
    try:
        with pytest.raises(ValueError, match=rf"'{TOKEN}'.*"
                                             rf"{stack.text.token_rows} rows"):
            service.generate(f"a {TOKEN} polyp", 1, seed=0)
        reply = service.generate("a colon polyp", 2, seed=3)
        assert len(reply["images"]) == 2
        assert service.snapshot()["requests"] >= 2  # the warm-up and this
    finally:
        service.close()
