"""Serving load generator: closed-loop concurrent clients against the
port's GenerationService (polyp_tpu_torch/serve.py); the twin of the JAX
package's tools/bench_serve.py (:71-255).

    python -m polyp_tpu_torch.tools.bench_serve --clients 8 --duration 10
    python -m polyp_tpu_torch.tools.bench_serve --overload --arrival_rate 16
    # a CPU smoke of the harness (tiny stack, seconds):
    python -m polyp_tpu_torch.tools.bench_serve --device cpu --tiny \
        --image_size 64 --steps 2 --clients 4 --duration 4

Closed loop: `--clients` threads each issue a 1-image request, wait for
the response and issue the next, for `--duration` seconds, against the
in-process service (the dispatcher, the padding and the sampler are the
production path; `--http` adds the socket layer). Each request has its
own seed and cycles through the prompts. Coalesced (`max_batch`) and solo
(`max_batch` 1) services are measured in turn. Open loop (`--overload`):
requests arrive at `--arrival_rate` a second whatever the service's pace,
against a bounded (`--max_pending`) and an unbounded queue, with an
optional queue-wait deadline (`--timeout_s`); shed and expired requests
are counted and latency is taken from each request's scheduled arrival.

One JSON line per configuration. Times come from the host clock; a run on
the CPU measures the CPU, not the card.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from typing import Callable

from polyp_tpu_torch.serve import (
    REFUSED,
    DeadlineExceeded,
    GenerationService,
    ServiceOverloaded,
    sampler_from_args,
    serve,
)

PROMPTS = [
    "a realistic photo of colon polyp",
    "a realistic photo of adenomatous colon polyp",
    "a realistic photo of hyperplastic colon polyp",
    "a realistic photo of sessile serrated colon polyp",
]


def percentile(sorted_vals: list[float], q: float) -> float:
    """The nearest-rank `q` quantile of ascending values (nan if none)."""
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def _closed_loop(duration: float,
                 clients: list[tuple[str, Callable[[int, int], None]]]
                 ) -> tuple[float, dict[str, list[float]]]:
    """One thread per (key, issue) pair, each calling `issue(cid, n)`
    back to back for `duration` seconds. Returns (elapsed seconds,
    {key: ascending latencies})."""
    buckets: dict[str, list[float]] = {key: [] for key, _ in clients}
    lock = threading.Lock()
    stop = time.monotonic() + duration

    def run(cid: int, key: str, issue) -> None:
        n = 0
        while time.monotonic() < stop:
            t0 = time.perf_counter()
            issue(cid, n)
            dt = time.perf_counter() - t0
            n += 1
            with lock:
                buckets[key].append(dt)

    t_start = time.perf_counter()
    threads = [threading.Thread(target=run, args=(c, k, f))
               for c, (k, f) in enumerate(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t_start
    for lats in buckets.values():
        lats.sort()
    return elapsed, buckets


def _latency_stats(lats: list[float], elapsed: float) -> dict:
    return {"requests": len(lats),
            "throughput_samples_per_s": len(lats) / elapsed,
            "p50_s": percentile(lats, 0.50), "p95_s": percentile(lats, 0.95),
            "p99_s": percentile(lats, 0.99)}


def run_load(service: GenerationService, clients: int, duration: float,
             http_port: int | None = None,
             prompts: list[str] = PROMPTS) -> dict:
    """Closed-loop load of 1-image requests; throughput, latency
    percentiles, and the launches and mean occupancy (requests a launch)
    of the timed window alone."""
    launches_before = service.snapshot()["launches"]
    if http_port is not None:
        import http.client

        def issue(prompt: str, seed: int) -> None:
            conn = http.client.HTTPConnection("127.0.0.1", http_port)
            try:
                conn.request("POST", "/generate",
                             json.dumps({"prompt": prompt, "num_images": 1,
                                         "seed": seed}),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                payload = json.loads(resp.read())
            finally:
                conn.close()
            if resp.status != 200:
                raise RuntimeError(payload.get("error", "request failed"))
    else:
        def issue(prompt: str, seed: int) -> None:
            service.generate(prompt, 1, seed=seed)

    spec = [("all", lambda cid, n: issue(prompts[(cid + n) % len(prompts)],
                                         seed=cid * 100003 + n))] * clients
    elapsed, buckets = _closed_loop(duration, spec)
    lats = buckets["all"]
    launches = max(1, service.snapshot()["launches"] - launches_before)
    return {"clients": clients, "duration_s": elapsed,
            **_latency_stats(lats, elapsed), "launches": launches,
            "mean_batch_occupancy": len(lats) / launches}


def run_multimodel_load(service: GenerationService, duration: float,
                        assignments: list[tuple[str, str]]) -> dict:
    """Closed-loop load with one client for each (model, prompt) pair:
    throughput, latency percentiles and launches for each model under the
    mix the assignments give (a burst on one model, say, beside single
    clients on the others)."""
    before = service.snapshot()["launches_by_model"]
    clients = [(m, lambda cid, n, m=m, p=p: service.generate(
                    p, 1, seed=cid * 100003 + n, model=m))
               for m, p in assignments]
    elapsed, per_model = _closed_loop(duration, clients)
    after = service.snapshot()["launches_by_model"]
    out: dict = {"duration_s": elapsed, "clients_by_model": {},
                 "per_model": {}}
    for m, _ in assignments:
        out["clients_by_model"][m] = out["clients_by_model"].get(m, 0) + 1
    for m, lats in per_model.items():
        out["per_model"][m] = {**_latency_stats(lats, elapsed),
                               "launches": after[m] - before.get(m, 0)}
    out["throughput_samples_per_s"] = sum(
        len(lats) for lats in per_model.values()) / elapsed
    return out


def run_overload(service: GenerationService, arrival_rate: float,
                 duration: float, timeout_s: float | None = None,
                 prompts: list[str] = PROMPTS) -> dict:
    """Open-loop arrivals at `arrival_rate` a second for `duration`
    seconds: requests are issued on schedule whatever the service's pace,
    so an unbounded queue grows without limit past capacity while a
    bounded one sheds. Counts accepted, shed (429) and expired (503)
    requests; latency percentiles of the accepted ones are taken from
    each request's scheduled arrival."""
    n_requests = int(arrival_rate * duration)
    lats: list[float] = []
    counts = {"shed": 0, "expired": 0}
    lock = threading.Lock()
    t0 = time.perf_counter() + 0.5

    def worker(i: int) -> None:
        sched = t0 + i / arrival_rate
        delay = sched - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        try:
            service.generate(prompts[i % len(prompts)], 1, seed=i,
                             timeout_s=timeout_s)
        except ServiceOverloaded:
            outcome = "shed"
        except DeadlineExceeded:
            outcome = "expired"
        else:
            outcome = time.perf_counter() - sched
        with lock:
            if isinstance(outcome, str):
                counts[outcome] += 1
            else:
                lats.append(outcome)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=duration + 600)
    lats.sort()
    return {"scenario": "overload_open_loop",
            "max_pending": service.max_pending,
            "timeout_s": timeout_s, "arrival_rate_per_s": arrival_rate,
            "duration_s": duration, "offered": n_requests,
            "accepted": len(lats), **counts,
            "goodput_samples_per_s": len(lats) / duration,
            "p50_s": percentile(lats, 0.50), "p95_s": percentile(lats, 0.95),
            "p99_s": percentile(lats, 0.99),
            "max_s": lats[-1] if lats else None}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--steps", type=int, default=25)
    parser.add_argument("--max_batch", type=int, default=8)
    parser.add_argument("--clients", type=int, default=8)
    parser.add_argument("--duration", type=float, default=60.0)
    parser.add_argument("--batch_window_ms", type=float, default=50.0)
    parser.add_argument("--pipeline_depth", type=int, default=1)
    parser.add_argument("--quantize", default=None,
                        choices=["w8a8", "w8a8_static", "promoted"])
    parser.add_argument("--quant-fp-head", type=int, default=0)
    parser.add_argument("--quant-fp-tail", type=int, default=0)
    parser.add_argument("--vae-decoder", default="full",
                        choices=["full", "tiny"], dest="vae_decoder")
    parser.add_argument("--tiny-decoder-dir", default=None)
    parser.add_argument("--http", action="store_true",
                        help="route requests through the HTTP layer too")
    parser.add_argument("--skip_solo", action="store_true",
                        help="skip the max_batch=1 service")
    parser.add_argument("--overload", action="store_true",
                        help="open-loop arrivals at --arrival_rate, bounded "
                             "(--max_pending) vs unbounded queue")
    parser.add_argument("--arrival_rate", type=float, default=16.0)
    parser.add_argument("--max_pending", type=int, default=16)
    parser.add_argument("--timeout_s", type=float, default=None,
                        help="--overload: each request's queue-wait "
                             "deadline")
    args = parser.parse_args(argv)
    if args.quantize == "promoted":
        parser.error(REFUSED["promoted"])

    window = args.batch_window_ms / 1e3
    sampler = sampler_from_args(args)

    def launched(max_batch: int):
        return lambda prompts, ids: sampler.generate_batch(
            prompts, ids, pad_to=max_batch)

    if args.overload:
        for bound in (args.max_pending, None):
            service = GenerationService(
                launched(args.max_batch), max_batch=args.max_batch,
                warm_prompt=PROMPTS[0], batch_window_s=window,
                pipeline_depth=args.pipeline_depth, max_pending=bound)
            try:
                print(json.dumps(run_overload(service, args.arrival_rate,
                                              args.duration, args.timeout_s)))
            finally:
                service.close()
        return

    results = []
    modes = [("coalesced", args.max_batch)]
    if not args.skip_solo:
        modes.append(("solo", 1))
    for mode, max_batch in modes:
        service = GenerationService(
            launched(max_batch), max_batch=max_batch,
            warm_prompt=PROMPTS[0], batch_window_s=window,
            pipeline_depth=args.pipeline_depth)
        server = serve(service, port=0) if args.http else None
        try:
            for p in PROMPTS:  # encode each prompt outside the timed window
                service.generate(p, 1, seed=0)
            stats = run_load(service, args.clients, args.duration,
                             http_port=(server.server_address[1]
                                        if server else None))
        finally:
            if server is not None:
                server.shutdown()
            service.close()
        stats.update(mode=mode, max_batch=max_batch, device=args.device,
                     image_size=args.image_size, steps=args.steps,
                     pipeline_depth=args.pipeline_depth,
                     quantize=args.quantize)
        results.append(stats)
        print(json.dumps(stats))
    if len(results) == 2:
        print(json.dumps({"coalescing_speedup": (
            results[0]["throughput_samples_per_s"]
            / max(results[1]["throughput_samples_per_s"], 1e-9))}))


if __name__ == "__main__":
    main()
