"""polyp-verify-assets-torch — the asset-arrival runbook on the port: the
twin of polyp_tpu/cli/verify_assets.py, with the same seven checks, row
names, debts (BASELINE.md "Parity debts") and exit code.

  polyp-verify-assets-torch [--pretrained-dir SD_DIR] [--data-root DATA]
      [--fid-weights efficientnet_b0.pth] [--fixtures-dir DIR]
      [--image_size 256] [--steps 25] [--gate_batch 4] [--apply-gate]
      [--tiny] [--device cuda]

Checks:
  1. checkpoint-leaves   (debt 2) — load_sd_stack imports every tensor with
     strict shapes; then every parameter finite, and no matrix or conv
     kernel all zero. A directory that is not there is a fail row.
  2. tokenizer-assets    (debt 4) — models/clip_tokenizer.py's
     validate_clip_assets on tokenizer/vocab.json and merges.txt.
  3. text-golden         (debt 2) — the port's CLIP forward against
     transformers' on the same weights; a skip row where transformers is
     not installed.
  4. sampler-fixtures    (debt 3) — fixed-seed sampler outputs (torch
     generators from seeds 0, 1, 2) as .npy + sha256 under
     --fixtures-dir. The hashes are the port's own, not comparable with
     the reference's (Philox, not threefry).
  5. quant-gate          — re-measures both entries of the port's gate file
     (ops/quant.py::GATE_PATH) on this checkpoint: the full-trajectory one
     (the config's default sampler at --steps, CFG, batch --gate_batch)
     and the distilled one (trailing DDIM, folded guidance, the stack's
     UNet standing in for a student, 8 steps at --gate_batch and 4 at
     twice it), each rel-L2 against bf16 from the same seed and each
     samples/s beside bf16's (tools/quant_sensitivity.py::median_rates),
     and re-judges them by both halves of the gate (ops/quant.py::
     gate_passes). The verdict goes to quant_gate_remeasured.json beside
     the fixtures; --apply-gate also overwrites the port's gate file,
     never the reference's.
  6. fid-calibration     (debt 3) — with --fid-weights and --data-root:
     eval/fid.py::efficientnet_extractor, calibrated, and FID(train half
     A, half B) well below FID(train, noise).
  7. downstream-f1       (debt 1) — not run here; the row prints the
     two-command loop (polyp-lora-per-class-torch, then
     polyp-eval-augmentation-torch) against the reference's 0.6069.

Exit code: 0 when no check failed (skips allowed), 1 otherwise.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

PROMPT = "a realistic photo of colon polyp"


def _row(report: list, check: str, debt: str, status: str, detail: str):
    report.append({"check": check, "debt": debt, "status": status,
                   "detail": detail})
    print(f"[{status.upper():5s}] {check:18s} ({debt}) {detail}")


def suspicious_leaves(stack) -> tuple[int, list[str]]:
    """(parameter count, problems) over the stack's UNet, VAE and text
    encoder: a non-finite parameter, or an all-zero one of two or more
    dimensions and more than 64 values (1-D biases and scales are zero in
    real checkpoints)."""
    bad, n = [], 0
    for part in ("unet", "vae", "text"):
        for name, p in getattr(stack, part).named_parameters():
            n += 1
            arr = p.detach()
            if not torch.isfinite(arr).all():
                bad.append(f"{part}: non-finite leaf {name} "
                           f"{tuple(arr.shape)}")
            elif arr.ndim >= 2 and arr.numel() > 64 and not arr.any():
                bad.append(f"{part}: all-zero kernel {name} "
                           f"{tuple(arr.shape)}")
    return n, bad


def check_checkpoint(args, report):
    from polyp_tpu_torch.cli.common import load_sd_stack

    try:
        stack = load_sd_stack(args.pretrained_dir, tiny=args.tiny,
                              device=args.device)
    except Exception as e:
        _row(report, "checkpoint-leaves", "debt 2", "fail",
             f"import failed: {type(e).__name__}: {e}")
        return None
    if stack.pretrained_dir is None:
        _row(report, "checkpoint-leaves", "debt 2", "fail",
             "no --pretrained-dir: random weights from seed 0, not a "
             "pretrained checkpoint")
        return stack
    n_leaves, bad = suspicious_leaves(stack)
    if bad:
        _row(report, "checkpoint-leaves", "debt 2", "fail",
             f"{len(bad)} suspicious leaves: {bad[:3]}")
    else:
        _row(report, "checkpoint-leaves", "debt 2", "pass",
             f"every tensor imported with its shape; {n_leaves} leaves "
             "finite and non-degenerate")
    return stack


def check_tokenizer(args, report) -> None:
    tok_dir = Path(args.pretrained_dir or ".") / "tokenizer"
    if args.tiny or not (tok_dir / "vocab.json").exists():
        _row(report, "tokenizer-assets", "debt 4", "skip",
             f"no tokenizer files at {tok_dir}")
        return
    try:
        from polyp_tpu_torch.models.clip_tokenizer import CLIPBPETokenizer
        # strict: validate_clip_assets, which raises on any problem
        CLIPBPETokenizer(tok_dir / "vocab.json", tok_dir / "merges.txt",
                         strict=True)
        _row(report, "tokenizer-assets", "debt 4", "pass",
             "official CLIP assets (vocab 49408, 48894 merges, special ids)")
    except Exception as e:
        _row(report, "tokenizer-assets", "debt 4", "fail", str(e))


def check_text_golden(args, stack, report) -> None:
    """The port's CLIP forward against transformers' on the same weights."""
    if args.tiny or stack is None or stack.pretrained_dir is None:
        _row(report, "text-golden", "debt 2", "skip",
             "needs a real checkpoint")
        return
    try:
        from transformers import CLIPTextModel as HFText
    except Exception:
        _row(report, "text-golden", "debt 2", "skip",
             "transformers not installed")
        return
    try:
        hf = HFText.from_pretrained(
            Path(args.pretrained_dir) / "text_encoder").eval()
        ids = torch.as_tensor(stack.tokenizer([PROMPT]), dtype=torch.long)
        with torch.no_grad():
            want = hf(ids).last_hidden_state.float().numpy()
            device = next(stack.text.parameters()).device
            got = stack.text(ids.to(device)).float().cpu().numpy()
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        status = "pass" if rel < 2e-3 else "fail"
        _row(report, "text-golden", "debt 2", status,
             f"CLIP forward rel L2 vs transformers = {rel:.2e} "
             "(threshold 2e-3)")
    except Exception as e:
        _row(report, "text-golden", "debt 2", "fail",
             f"{type(e).__name__}: {e}")


def capture_fixtures(args, stack, report) -> None:
    from polyp_tpu_torch.cli.sd_common import make_sampler
    from polyp_tpu_torch.configs import DiffusionConfig

    try:
        out = Path(args.fixtures_dir)
        out.mkdir(parents=True, exist_ok=True)
        cfg = DiffusionConfig(image_size=args.image_size,
                              num_inference_steps=args.steps)
        fn = make_sampler(stack, cfg).for_prompt(PROMPT)
        hashes = {}
        for seed in (0, 1, 2):
            imgs = fn(2, seed).float().cpu().numpy().astype(np.float16)
            np.save(out / f"sampler_seed{seed}.npy", imgs)
            hashes[f"seed{seed}"] = hashlib.sha256(
                imgs.tobytes()).hexdigest()[:16]
        (out / "sampler_fixtures.json").write_text(json.dumps({
            "prompt": PROMPT, "sampler": cfg.sampler,
            "steps": args.steps, "image_size": args.image_size,
            "guidance_scale": cfg.guidance_scale,
            "schedule": "scaled_linear(0.00085, 0.012, T=1000)",
            "layout": "NCHW float16, torch generators seeded 0, 1, 2",
            "pretrained": stack.pretrained_dir is not None,
            "sha256_16": hashes}, indent=2))
        _row(report, "sampler-fixtures", "debt 3", "pass",
             f"3 fixed-seed fixtures captured to {out} "
             f"(pretrained={stack.pretrained_dir is not None})")
    except Exception as e:
        _row(report, "sampler-fixtures", "debt 3", "fail",
             f"{type(e).__name__}: {e}")


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-12))


def remeasure_quant_gate(args, stack, report) -> dict | None:
    """Re-judge both entries of the port's gate file on this stack's
    weights; returns the re-measured file's content (None when there is no
    file). The vendored verdicts were measured on random weights (the
    pessimistic bound); on a real checkpoint this confirms or demotes
    them."""
    from polyp_tpu_torch.cli.distill_sd import make_student_sampler
    from polyp_tpu_torch.cli.sd_common import make_sampler
    from polyp_tpu_torch.configs import DiffusionConfig
    from polyp_tpu_torch.ops import quant
    from polyp_tpu_torch.tools.quant_sensitivity import (
        card_line, median_rates)

    gate_path = quant.GATE_PATH
    try:
        gate = json.loads(gate_path.read_text())
    except FileNotFoundError:
        _row(report, "quant-gate", "gate", "skip",
             f"no gate file to re-judge at {gate_path}")
        return None
    except json.JSONDecodeError as e:
        _row(report, "quant-gate", "gate", "fail",
             f"{gate_path} does not parse: {e}")
        return None
    threshold = float(gate.get("gate_rel_l2", 0.05))
    b = args.gate_batch
    try:
        # the full-trajectory entry, at the config's default sampler
        promo = gate.get("promoted", {})
        cfg_q = DiffusionConfig(
            image_size=args.image_size, num_inference_steps=args.steps,
            quantize=promo.get("mode", "w8a8_static"),
            quant_fp_head=int(promo.get("quant_fp_head", 0)),
            quant_fp_tail=int(promo.get("quant_fp_tail", 0)))
        cfg_b = DiffusionConfig(image_size=args.image_size,
                                num_inference_steps=args.steps)
        fb = make_sampler(stack, cfg_b).for_prompt(PROMPT)
        fq = make_sampler(stack, cfg_q).for_prompt(PROMPT)
        out, rates = median_rates({"bf16": lambda: fb(b, 0),
                                   "q": lambda: fq(b, 0)}, b)
        full_rel = _rel_l2(out["q"], out["bf16"])
        full = dict(promo, rel_l2_real=full_rel,
                    samples_per_sec_real=rates["q"],
                    bf16_samples_per_sec_real=rates["bf16"],
                    real_sampler=cfg_b.sampler, real_steps=args.steps,
                    real_batch=b)
        full["gate_pass"] = quant.gate_passes(full, threshold)

        # the distilled entry: folded guidance, trailing DDIM, no head
        pd = gate.get("promoted_distilled", {})
        distilled = {"mode": "w8a8_static", "quant_fp_head": 0,
                     "quant_fp_tail": 0, **pd}
        for steps, batch in ((8, b), (4, 2 * b)):
            sb, sq = (make_student_sampler(
                stack, stack.unet, num_steps=steps,
                image_size=args.image_size, quantize=qmode,
                quant_fp_head=int(distilled["quant_fp_head"]),
                quant_fp_tail=int(distilled["quant_fp_tail"])
            ).for_prompt(PROMPT) for qmode in (None, distilled["mode"]))
            out, rates = median_rates({"bf16": lambda: sb(batch, 0),
                                       "q": lambda: sq(batch, 0)}, batch)
            tag = f"{steps}step_batch{batch}"
            distilled[f"rel_l2_{steps}step_real"] = _rel_l2(out["q"],
                                                            out["bf16"])
            distilled[f"samples_per_sec_{tag}"] = rates["q"]
            distilled[f"bf16_samples_per_sec_{tag}"] = rates["bf16"]
        distilled["gate_pass"] = quant.gate_passes(distilled, threshold)

        pending = (None if stack.pretrained_dir is not None
                   else "still random weights")
        stamp = time.strftime("%Y-%m-%d")
        gate["promoted"] = dict(full, pending=pending, remeasured=stamp)
        gate["promoted_distilled"] = dict(distilled, pending=pending,
                                          remeasured=stamp)
        gate["measured_on"] = dict(gate.get("measured_on", {}),
                                   card=card_line() or str(
                                       next(stack.unet.parameters()).device))
        text = json.dumps(gate, indent=2) + "\n"
        out_path = Path(args.fixtures_dir) / "quant_gate_remeasured.json"
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(text)
        applied = ""
        if args.apply_gate:
            gate_path.write_text(text)
            applied = f"; APPLIED to {gate_path}"
        full_pass, pd_pass = full["gate_pass"], distilled["gate_pass"]
        _row(report, "quant-gate", "gate",
             "pass" if full_pass and pd_pass else "fail",
             f"full-trajectory rel_l2 {full_rel:.4f}, "
             f"{full['samples_per_sec_real']:.3f} samples/s vs bf16 "
             f"{full['bf16_samples_per_sec_real']:.3f} "
             f"({'pass' if full_pass else 'DEMOTED'}), distilled 8/4-step "
             f"{distilled['rel_l2_8step_real']:.4f}/"
             f"{distilled['rel_l2_4step_real']:.4f} "
             f"({'pass' if pd_pass else 'DEMOTED'}) vs gate {threshold}; "
             f"verdict written to {out_path}{applied}")
        return gate
    except Exception as e:
        _row(report, "quant-gate", "gate", "fail",
             f"{type(e).__name__}: {e}")
        return None


def calibrate_fid(args, report) -> None:
    if not args.fid_weights or not args.data_root:
        _row(report, "fid-calibration", "debt 3", "skip",
             "needs --fid-weights and --data-root")
        return
    try:
        from polyp_tpu_torch.cli.common import DataLayout
        from polyp_tpu_torch.data.cache import ArrayDataset
        from polyp_tpu_torch.data.tables import ClassificationTable
        from polyp_tpu_torch.eval import fid as fid_mod

        layout = DataLayout(Path(args.data_root))
        table = ClassificationTable.from_csv(layout.train_images,
                                             layout.train_csv)
        size = min(args.image_size, 224)
        data = ArrayDataset.from_table(table, size, args.cache_dir)
        ex = fid_mod.efficientnet_extractor(size,
                                            torch_weights=args.fid_weights,
                                            device=args.device)
        if not ex.calibrated:
            _row(report, "fid-calibration", "debt 3", "fail",
                 f"weights at {args.fid_weights} did not load")
            return
        half = len(data.images) // 2
        same = fid_mod.frechet_from_arrays(data.images[:half],
                                           data.images[half:], ex)
        noise = np.random.default_rng(0).integers(
            0, 255, data.images[:half].shape, dtype=np.uint8)
        far = fid_mod.frechet_from_arrays(data.images[:half], noise, ex)
        status = "pass" if far > 4 * max(same, 1e-6) else "fail"
        _row(report, "fid-calibration", "debt 3", status,
             f"calibrated extractor '{ex.name}': FID(half,half)="
             f"{same:.2f} << FID(train,noise)={far:.2f}")
    except Exception as e:
        _row(report, "fid-calibration", "debt 3", "fail",
             f"{type(e).__name__}: {e}")


def downstream_command(args, report) -> None:
    ready = bool(args.data_root) and bool(args.pretrained_dir)
    detail = ("READY — run: polyp-lora-per-class-torch --data-root "
              f"{args.data_root} --pretrained-dir {args.pretrained_dir} "
              "--folder RUN --classes_to_train AD HP ASS "
              "--num_imgs_to_generate 465 619 628 && "
              f"polyp-eval-augmentation-torch --data-root {args.data_root} "
              "--path_model RUN  # compare weighted F1 vs 0.6069 "
              "(reference parameters_register.csv:26)"
              if ready else
              "needs --data-root (real corpus) and --pretrained-dir; then "
              "polyp-lora-per-class-torch -> polyp-eval-augmentation-torch")
    _row(report, "downstream-f1", "debt 1", "skip", detail)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--pretrained-dir", type=str, default=None)
    parser.add_argument("--data-root", type=str, default=None)
    parser.add_argument("--cache-dir", type=str, default=None)
    parser.add_argument("--fid-weights", type=str, default=None,
                        help="torchvision efficientnet_b0 state-dict file "
                             "(ImageNet) — calibrates eval/fid.py")
    parser.add_argument("--fixtures-dir", type=str,
                        default="./verify_assets_out")
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--steps", type=int, default=25)
    parser.add_argument("--gate_batch", type=int, default=4)
    parser.add_argument("--apply-gate", action="store_true",
                        help="overwrite polyp_tpu_torch/ops/quant_gate.json "
                             "with the re-measured verdict (demotion then "
                             "reaches every --quantize promoted surface)")
    parser.add_argument("--tiny", action="store_true",
                        help="miniature stack (CI / fabricated assets)")
    parser.add_argument("--skip-quant-gate", action="store_true",
                        help="skip the sampling-heavy gate re-measurement")
    parser.add_argument("--skip-fixtures", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; the runbook runs on the card "
                             "unless given a CPU")
    args = parser.parse_args(argv)

    report: list[dict] = []
    stack = check_checkpoint(args, report)
    check_tokenizer(args, report)
    check_text_golden(args, stack, report)
    if stack is not None and not args.skip_fixtures:
        capture_fixtures(args, stack, report)
    if stack is not None and not args.skip_quant_gate:
        remeasure_quant_gate(args, stack, report)
    calibrate_fid(args, report)
    downstream_command(args, report)

    out = Path(args.fixtures_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "report.json").write_text(json.dumps(report, indent=2))
    fails = [r for r in report if r["status"] == "fail"]
    print(f"\nverify-assets: {len(report)} checks, "
          f"{sum(r['status'] == 'pass' for r in report)} passed, "
          f"{len(fails)} failed, "
          f"{sum(r['status'] == 'skip' for r in report)} skipped "
          f"-> {out / 'report.json'}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
