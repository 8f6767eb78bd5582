"""Generation server: the twin of polyp_tpu/serve.py, an HTTP front end over
a diffusion sampler with cross-request micro-batching.

  POST /generate   {"prompt": str, "num_images": int <= max_batch,
                    "seed": int, "model": str?, "timeout_s": float?}
                   → {"images": [base64 PNG, ...], "latency_s": float,
                      "prompt": str, "seed": int, "model": str,
                      "batched_samples": int}
  GET  /healthz    → {"status": "ok", "model": ..., "models": [...],
                      "warm": bool, "max_pending": int | null,
                      "stats": {requests, launches, coalesced_samples, shed,
                                expired, launches_by_model}}

Status codes: 400 for a bad request (num_images out of range, an unknown
model, a prompt token the model's text table lacks), 429 with `Retry-After: 1` when `max_pending` requests already wait,
503 when a request's queue-wait deadline passed before its launch, 500 for
a sampler error, 404 for any other route.

Design, as the reference's:

* One dispatcher thread owns the card. It takes the oldest request, waits
  up to `batch_window_s` for more requests of the same model, and
  coalesces them into one launch of up to `max_batch` samples, each with
  its own prompt and its own (seed, index) pair
  (StableDiffusionSampler.generate_batch). Models are served in arrival
  order, so one model's burst cannot starve another's queued request.
* Launches are padded to `max_batch` (`pad_to`), so every launch has one
  shape.
* Determinism: sample j of a request is a function of (prompt, seed, j)
  alone (utils/rng.request_generator), so a response is the same whether
  its request ran alone or coalesced, for the deterministic samplers (ddim
  η = 0, dpmpp_2m, unipc: the serving default) and the bf16 and w8a8_static
  UNets. The ancestral ddpm sampler, ddim with η > 0 and dynamic w8a8
  (per-tensor activation scales over the whole launch) do not make this
  guarantee.
* Admission: at most `max_pending` requests wait for a launch; the next is
  refused at the door with ServiceOverloaded (429). A request's
  `timeout_s` bounds its queue wait: past it, it is answered with
  DeadlineExceeded (503); launched work always completes.
* `pipeline_depth` launches in flight (default 1): with 2 the dispatcher
  queues launch N+1 while the completion thread waits for launch N's
  images. The port's sampling loop is host-bound, so the completion
  thread's work contends with the dispatcher for the interpreter; the
  default stays 1, as the reference measured.
* One lock guards the pending count and every stats counter; `/healthz`
  reports a copy taken under it (`snapshot`). The reference changes
  `shed` under another lock than the other counters (its serve.py:206).

`main` (polyp-serve-torch) serves the base stack, or with
`--distilled-dir` the students polyp-distill-sd-torch wrote (one model a
student, `--distilled-class` picks them) behind one card.

Threads and torch: grad mode is thread-local, so the dispatcher runs the
sampler under `torch.no_grad()` (the inference-only kernels refuse
otherwise). The dispatcher queues each launch's uint8 conversion and copy
to the host right after its kernels, with an event after them
(pipeline.fetch_uint8); the completion thread waits on that event.
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from polyp_tpu_torch.data.native import encode_png
from polyp_tpu_torch.pipeline import fetch_uint8

# fn(prompts, sample_ids) -> float images in [-1, 1], NCHW, len(prompts)
# rows; sample_ids holds one (seed, index) pair a prompt. An optional
# `fn.check(prompt)` raises ValueError for a prompt the model cannot take.
# StableDiffusionSampler.generate_batch with pad_to=max_batch is the
# product implementation.
MultiPromptSampler = Callable[[Sequence[str], Sequence[tuple[int, int]]],
                              torch.Tensor]


class ServiceOverloaded(RuntimeError):
    """Admission refused: `max_pending` requests already queued. Clients
    should back off and retry (HTTP 429)."""


class DeadlineExceeded(TimeoutError):
    """The request's `timeout_s` elapsed while it waited in the queue: it
    was never launched (HTTP 503). Launched work always completes."""


@dataclass
class _Request:
    prompt: str
    num_images: int
    seed: int
    model: str = ""                           # routing key
    deadline: float | None = None             # monotonic; queue-wait bound
    done: threading.Event = field(default_factory=threading.Event)
    images: np.ndarray | None = None          # uint8 [n, H, W, C]
    batched_samples: int = 0                  # the launch size it rode in
    error: BaseException | None = None


class GenerationService:
    """Request-coalescing front end over one or several
    MultiPromptSamplers (a dict {model: sampler} hosts several models
    behind one card; requests name theirs, the first is the default).
    `generate` is safe to call from any number of threads."""

    def __init__(self, batch_sampler: MultiPromptSampler
                 | dict[str, MultiPromptSampler], max_batch: int = 8,
                 model_name: str = "polyp-sd", warm_prompt: str | None = None,
                 batch_window_s: float = 0.05, pipeline_depth: int = 1,
                 max_pending: int | None = 64,
                 default_timeout_s: float | None = None):
        if not isinstance(batch_sampler, dict):
            batch_sampler = {model_name: batch_sampler}
        if not batch_sampler:
            raise ValueError("need at least one sampler")
        self._samplers = dict(batch_sampler)
        self.default_model = next(iter(self._samplers))
        self.max_batch = max_batch
        self.model_name = model_name
        self.batch_window_s = batch_window_s
        self.max_pending = max_pending
        self.default_timeout_s = default_timeout_s
        self.pipeline_depth = max(1, int(pipeline_depth))
        # guards _pending_count and every counter of `stats`
        self._lock = threading.Lock()
        self._pending_count = 0
        self.stats = {"requests": 0, "launches": 0, "coalesced_samples": 0,
                      "shed": 0, "expired": 0,
                      "launches_by_model": {k: 0 for k in self._samplers}}
        self._queue: queue.Queue[_Request | None] = queue.Queue()
        self._warm = False
        self._closed = False
        self._inflight = threading.Semaphore(self.pipeline_depth)
        self._completions: queue.Queue[tuple | None] = queue.Queue()
        self._completer = threading.Thread(target=self._complete_loop,
                                           daemon=True)
        self._completer.start()
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._dispatcher.start()
        if warm_prompt is not None:
            self.generate(warm_prompt, 1, seed=0)

    @property
    def models(self) -> list[str]:
        return list(self._samplers)

    @property
    def warm(self) -> bool:
        return self._warm

    def snapshot(self) -> dict:
        """A copy of `stats` taken under the lock."""
        with self._lock:
            return {**self.stats, "launches_by_model": dict(
                self.stats["launches_by_model"])}

    # -- client side ------------------------------------------------------

    def generate(self, prompt: str, num_images: int, seed: int = 0,
                 model: str | None = None,
                 timeout_s: float | None = None) -> dict:
        if not 1 <= num_images <= self.max_batch:
            raise ValueError(f"num_images must be in [1, {self.max_batch}]")
        model = model or self.default_model
        if model not in self._samplers:
            raise ValueError(f"unknown model {model!r} "
                             f"(serving: {sorted(self._samplers)})")
        if self._closed:
            raise RuntimeError("service is closed")
        # a prompt the model cannot encode is refused here, before it can
        # share (and fail) a launch with other requests
        check = getattr(self._samplers[model], "check", None)
        if check is not None:
            check(prompt)
        with self._lock:
            if (self.max_pending is not None
                    and self._pending_count >= self.max_pending):
                self.stats["shed"] += 1
                raise ServiceOverloaded(
                    f"{self._pending_count} requests pending "
                    f"(max_pending={self.max_pending}); retry later")
            self._pending_count += 1
        t0 = time.perf_counter()
        timeout_s = self.default_timeout_s if timeout_s is None else timeout_s
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        req = _Request(prompt, int(num_images), int(seed), model,
                       deadline=deadline)
        self._queue.put(req)
        req.done.wait()
        if req.error is not None:
            raise req.error
        latency = time.perf_counter() - t0
        # zlib level 1, the native encoder where it is built: the payload
        # is transient, so encode speed wins over size
        payload = [base64.b64encode(encode_png(img)).decode()
                   for img in req.images]
        return {"images": payload, "latency_s": round(latency, 3),
                "prompt": prompt, "seed": seed, "model": model,
                "batched_samples": req.batched_samples}

    def close(self) -> None:
        """Stop taking requests and answer every pending one."""
        self._closed = True
        self._queue.put(None)
        self._dispatcher.join(timeout=5)
        if not self._dispatcher.is_alive():
            # the dispatcher queued every launched batch's completion
            # before it returned, so they all drain ahead of this sentinel
            self._completions.put(None)
            self._completer.join(timeout=5)
        # else a launch is still running past the join: leave the completer
        # running so its clients are answered; both threads are daemons

    # -- dispatcher side ---------------------------------------------------

    def _unpend(self, n: int) -> None:
        with self._lock:
            self._pending_count -= n

    def _expire(self, req: _Request) -> bool:
        """True (and the request is answered with DeadlineExceeded) when its
        queue-wait deadline passed before a launch slot opened."""
        if req.deadline is None or time.monotonic() < req.deadline:
            return False
        with self._lock:
            self.stats["expired"] += 1
            self._pending_count -= 1
        req.error = DeadlineExceeded(
            "request timed out in queue before reaching a launch slot")
        req.done.set()
        return True

    def _dispatch_loop(self) -> None:
        pending: deque[_Request] = deque()
        closing = False
        while True:
            if not pending:
                if closing:
                    return
                req = self._queue.get()
                if req is None:
                    return
                pending.append(req)
            head = pending.popleft()
            if self._expire(head):
                continue
            batch = [head]
            total = head.num_images
            deadline = time.monotonic() + self.batch_window_s
            while total < self.max_batch:
                # scoop the pending same-model requests that fit, FIFO;
                # expired ones are answered and dropped as they surface
                i = 0
                while i < len(pending) and total < self.max_batch:
                    r = pending[i]
                    if self._expire(r):
                        del pending[i]
                    elif (r.model == head.model
                            and total + r.num_images <= self.max_batch):
                        del pending[i]
                        batch.append(r)
                        total += r.num_images
                    else:
                        i += 1
                if total >= self.max_batch or closing:
                    break
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:          # close() while coalescing:
                    closing = True       # flush this and every pending batch
                    continue
                pending.append(nxt)
            self._launch_batch(batch, total)

    def _launch_batch(self, batch: list[_Request], total: int) -> None:
        """Queue one launch and its copy to the host without waiting for
        them; `_complete_loop` waits and answers the requests."""
        prompts: list[str] = []
        sample_ids: list[tuple[int, int]] = []
        for r in batch:
            for j in range(r.num_images):
                prompts.append(r.prompt)
                sample_ids.append((r.seed, j))
        self._inflight.acquire()  # bound the launches in flight
        # launched: these requests no longer hold admission slots
        self._unpend(len(batch))
        try:
            with torch.no_grad():
                fetch = fetch_uint8(
                    self._samplers[batch[0].model](prompts, sample_ids))
        except Exception as e:  # answer every request of the launch
            self._inflight.release()
            for r in batch:
                r.error = e
                r.done.set()
            return
        self._completions.put((batch, total, fetch))

    def _complete_loop(self) -> None:
        while True:
            item = self._completions.get()
            if item is None:
                return
            batch, total, fetch = item
            try:
                # waits for this launch's copy; a failure on the card
                # surfaces here
                images = fetch()
                self._warm = True
                with self._lock:
                    self.stats["requests"] += len(batch)
                    self.stats["launches"] += 1
                    self.stats["launches_by_model"][batch[0].model] += 1
                    if len(batch) > 1:
                        self.stats["coalesced_samples"] += total
                off = 0
                for r in batch:
                    r.images = images[off:off + r.num_images]
                    r.batched_samples = total
                    off += r.num_images
            except Exception as e:  # propagate to every waiting request
                for r in batch:
                    r.error = e
            finally:
                self._inflight.release()
                for r in batch:
                    r.done.set()


def make_handler(service: GenerationService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj: dict,
                  headers: dict[str, str] | None = None) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for key, value in (headers or {}).items():
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "model": service.model_name,
                                 "models": service.models,
                                 "warm": service.warm,
                                 "max_pending": service.max_pending,
                                 "stats": service.snapshot()})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                timeout = req.get("timeout_s")
                result = service.generate(
                    req.get("prompt", ""), int(req.get("num_images", 1)),
                    int(req.get("seed", 0)), req.get("model"),
                    timeout_s=float(timeout) if timeout is not None else None)
                self._send(200, result)
            except ServiceOverloaded as e:
                self._send(429, {"error": str(e)}, {"Retry-After": "1"})
            except DeadlineExceeded as e:
                self._send(503, {"error": str(e)})
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # report it and keep serving
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def serve(service: GenerationService, host: str = "127.0.0.1",
          port: int = 8787) -> ThreadingHTTPServer:
    """Start the HTTP server on a daemon thread; `port=0` takes a free
    port (`server.server_address[1]`). Stop it with `server.shutdown()`."""
    server = ThreadingHTTPServer((host, port), make_handler(service))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _decoder_from_args(args):
    """The tiny decoder `--vae-decoder tiny` asks for, else None: from
    `--tiny-decoder-dir`, else `<distilled-dir>/models/tiny_decoder` where
    there is one, else the committed weights."""
    from polyp_tpu_torch.models.tiny_decoder import (
        DEFAULT_DIR, load_tiny_decoder)

    if args.vae_decoder != "tiny":
        return None
    tiny_dir = args.tiny_decoder_dir
    distilled = getattr(args, "distilled_dir", None)
    if tiny_dir is None and distilled is not None:
        candidate = Path(distilled) / "models" / "tiny_decoder"
        tiny_dir = candidate if candidate.exists() else None
    tiny_dir = tiny_dir or DEFAULT_DIR
    decoder, meta = load_tiny_decoder(tiny_dir, device=args.device)
    print(f"tiny decoder from {tiny_dir} (trained rel_l2 vs the full "
          f"decode: {meta.get('rel_l2')})")
    return decoder


def sampler_from_args(args):
    """The base stack's StableDiffusionSampler from `main`'s arguments
    (pretrained_dir, device, tiny, image_size, steps, quantize,
    quant_fp_head / _tail, vae_decoder, tiny_decoder_dir): the weights of
    a local diffusers checkpoint, or random weights from seed 0."""
    from polyp_tpu_torch.cli.common import load_sd_stack
    from polyp_tpu_torch.cli.sd_common import make_sampler
    from polyp_tpu_torch.configs import DiffusionConfig

    # the config first: `--quantize promoted` resolves (or exits) before
    # any stack is built
    config = DiffusionConfig(image_size=args.image_size,
                             num_inference_steps=args.steps,
                             quantize=args.quantize,
                             quant_fp_head=args.quant_fp_head,
                             quant_fp_tail=args.quant_fp_tail)
    stack = load_sd_stack(args.pretrained_dir, tiny=args.tiny,
                          device=args.device)
    return make_sampler(stack, config, decoder=_decoder_from_args(args))


def student_samplers_from_args(args) -> tuple[dict, dict]:
    """The distilled students under `args.distilled_dir` (a
    polyp-distill-sd-torch output) that `--distilled-class` names ("all":
    every `models/distilled_*`), each through load_student_sampler over
    one base stack: ({cls: sampler}, {cls: its meta's prompt})."""
    from polyp_tpu_torch.cli.common import load_sd_stack
    from polyp_tpu_torch.cli.distill_sd import load_student_sampler

    models = Path(args.distilled_dir) / "models"
    if args.distilled_class == "all":
        classes = sorted(p.name.split("distilled_", 1)[1]
                         for p in models.glob("distilled_*")
                         if p.is_file() and not p.suffix)
    else:
        classes = [args.distilled_class]
    if not classes:
        raise FileNotFoundError(f"no distilled_* under {models}")
    stack = load_sd_stack(args.pretrained_dir, tiny=args.tiny,
                          device=args.device)
    decoder = _decoder_from_args(args)
    samplers, prompts = {}, {}
    for cls in classes:
        samplers[cls] = load_student_sampler(
            stack, args.distilled_dir, cls, image_size=args.image_size,
            quantize=args.quantize, quant_fp_head=args.quant_fp_head,
            quant_fp_tail=args.quant_fp_tail, decoder=decoder)
        prompts[cls] = json.loads((models / f"distilled_{cls}_meta.json")
                                  .read_text())["prompt"]
    return samplers, prompts


def service_from_args(args) -> GenerationService:
    """`main`'s service, warm: the base stack's sampler, or with
    `--distilled-dir` one model per student, each warmed with its own
    prompt (the embedding it was trained on)."""
    def launcher(sampler):
        # pad_to=max_batch: every launch has the same shapes
        def launch(prompts, ids):
            return sampler.generate_batch(prompts, ids, pad_to=args.max_batch)
        launch.check = sampler.check_prompt
        return launch

    common = dict(batch_window_s=args.batch_window_ms / 1e3,
                  pipeline_depth=args.pipeline_depth,
                  max_pending=args.max_pending or None,
                  default_timeout_s=args.request_timeout_s)
    if args.distilled_dir is None:
        return GenerationService(launcher(sampler_from_args(args)),
                                 args.max_batch, model_name="polyp-sd",
                                 warm_prompt="a colon polyp", **common)
    samplers, prompts = student_samplers_from_args(args)
    service = GenerationService(
        {cls: launcher(s) for cls, s in samplers.items()}, args.max_batch,
        model_name=f"polyp-sd-distilled[{','.join(samplers)}]", **common)
    for cls, prompt in prompts.items():
        service.generate(prompt, 1, seed=0, model=cls)
    return service


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="Serve SD-v1-4 text-to-image over HTTP on the card "
                    "(a local diffusers checkpoint, or random weights)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8787)
    parser.add_argument("--device", default="cuda",
                        help="where the stack runs (default: the card)")
    parser.add_argument("--pretrained-dir", default=None,
                        help="a local diffusers SD-v1-4 directory (unet/, "
                             "vae/, text_encoder/, tokenizer/); default: "
                             "random weights")
    parser.add_argument("--tiny", action="store_true",
                        help="the miniature stack (smoke runs)")
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--steps", type=int, default=25)
    parser.add_argument("--max_batch", type=int, default=8)
    parser.add_argument("--batch_window_ms", type=float, default=50.0,
                        help="how long the dispatcher waits to coalesce "
                             "concurrent requests into one launch")
    parser.add_argument("--pipeline_depth", type=int, default=1,
                        help="launches in flight; 2 queues launch N+1 "
                             "while launch N's images are fetched")
    parser.add_argument("--max_pending", type=int, default=64,
                        help="requests queued past this are shed with "
                             "HTTP 429 (0 = unbounded)")
    parser.add_argument("--request_timeout_s", type=float, default=None,
                        help="default queue-wait deadline; a request not "
                             "launched within it gets HTTP 503")
    parser.add_argument("--quantize", default=None,
                        choices=["w8a8", "w8a8_static", "promoted"],
                        help="int8 UNet (ops/quant.py); w8a8_static "
                             "calibrates its scales on first use. "
                             "'promoted' expands to the gate-passing config "
                             "of the port's own verdict "
                             "(polyp_tpu_torch/ops/quant_gate.json; the "
                             "distilled entry with --distilled-dir)")
    parser.add_argument("--quant-fp-head", type=int, default=0,
                        help="with --quantize: the first N steps in full "
                             "precision")
    parser.add_argument("--quant-fp-tail", type=int, default=0,
                        help="with --quantize: the final N steps in full "
                             "precision")
    parser.add_argument("--distilled-dir", default=None,
                        help="serve polyp-distill-sd-torch's students "
                             "instead of the base stack: few-step trailing "
                             "DDIM, guidance folded (cond-only UNet at 1x "
                             "batch)")
    parser.add_argument("--distilled-class", default="all",
                        help="which distilled_{cls} student(s) to serve: a "
                             "class name, or 'all' for every distilled_* "
                             "(a request names its model)")
    parser.add_argument("--vae-decoder", default="full",
                        choices=["full", "tiny"],
                        help="'tiny': decode with the tiny decoder "
                             "(polyp_tpu_torch/weights/tiny_decoder) "
                             "instead of the VAE")
    parser.add_argument("--tiny-decoder-dir", default=None,
                        help="a tiny decoder (params.npz + meta.json); "
                             "default: <distilled-dir>/models/tiny_decoder "
                             "where there is one, else the committed one")
    args = parser.parse_args(argv)
    # expand --quantize promoted before any stack is built (reference
    # :514-517): the distilled verdict for students
    from polyp_tpu_torch.ops.quant import resolve_quantize_arg
    args.quantize, args.quant_fp_head, args.quant_fp_tail = \
        resolve_quantize_arg(args.quantize, args.quant_fp_head,
                             args.quant_fp_tail,
                             distilled=args.distilled_dir is not None)

    service = service_from_args(args)
    server = serve(service, args.host, args.port)
    print(f"serving {service.models} on http://{args.host}:"
          f"{server.server_address[1]} (warm)", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        service.close()


if __name__ == "__main__":
    main()
