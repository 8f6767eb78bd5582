"""Distil the tiny VAE decoder: the twin of polyp_tpu/cli/distill_vae.py on
one card (`polyp-distill-vae-torch`).

Trains models/tiny_decoder.TinyDecoder to match the stack's full
AutoencoderKL decode (train/distill_vae.py) and saves it
(`save_tiny_decoder`: params.npz + meta.json) where
`polyp-serve-torch --vae-decoder tiny` and `load_tiny_decoder` read it:

  polyp-distill-vae-torch [--pretrained-dir SD_DIR | --tiny]
      [--data-root ./data] [--steps 2000] [--batch 8] [--image_size 256]
      [--output-dir ./models/tiny_decoder]

Latent diet: with a `--data-root` that exists, each batch is, with
probability 1 − `--synthetic_frac`, VAE-encoded corpus images (flipped at
random, as the fine-tune encodes them) and otherwise synthetic spatially
correlated latents; without one, all synthetic. The holdout is one
synthetic batch, plus the first `--batch` corpus images encoded where
there is a corpus. Unlike the reference (its :105-110), those images are
normalised to [-1, 1] before the encode, as every other encode is.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from polyp_tpu_torch.cli.common import (
    DataLayout, add_common_flags, get_tracker_from, init_weights_,
    load_sd_stack, print_banner)
from polyp_tpu_torch.utils.rng import stream_generator


def main(argv=None):
    """Returns the VAEDistillResult."""
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    parser.add_argument("--pretrained-dir", type=str, default=None)
    parser.add_argument("--tiny", action="store_true",
                        help="miniature SD stack (smoke/CI)")
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--base_channels", type=int, default=64)
    parser.add_argument("--learning_rate", type=float, default=3e-4)
    parser.add_argument("--synthetic_frac", type=float, default=0.5,
                        help="fraction of batches drawn from the synthetic "
                             "latent generator when --data-root also "
                             "supplies real-image latents")
    parser.add_argument("--output-dir", type=str,
                        default="./models/tiny_decoder")
    args = parser.parse_args(argv)

    from polyp_tpu_torch.data.transforms import augment_diffusion_batch
    from polyp_tpu_torch.models.tiny_decoder import (
        save_tiny_decoder, tiny_decoder_for_vae)
    from polyp_tpu_torch.models.vae import SD_VAE_SCALING, DiagonalGaussian
    from polyp_tpu_torch.train.distill_vae import (
        distill_vae_decoder, synthetic_latents)

    device = torch.device(args.device)
    stack = load_sd_stack(args.pretrained_dir, tiny=args.tiny, device=device)
    channels = stack.vae.latent_channels
    latent_size = args.image_size // 8
    decoder = tiny_decoder_for_vae(stack.vae,
                                   base_channels=args.base_channels,
                                   device=device)
    init_weights_(decoder, stream_generator(0, "distill-vae", "init",
                                            device=device))

    real_images = None
    if args.data_root and Path(args.data_root).exists():
        from polyp_tpu_torch.data.cache import ArrayDataset
        from polyp_tpu_torch.data.tables import DiffusionTable

        layout = DataLayout(Path(args.data_root))
        table = DiffusionTable.from_dirs(
            [layout.train_images, layout.val_images],
            [layout.train_csv, layout.val_csv])
        real_images = ArrayDataset.from_table(table, args.image_size,
                                              args.cache_dir).images
    source = "mixed" if real_images is not None else "synthetic"

    @torch.no_grad()
    def encode(images_u8: np.ndarray, generator: torch.Generator,
               flip: torch.Tensor | None) -> torch.Tensor:
        x = augment_diffusion_batch(torch.from_numpy(images_u8).to(device),
                                    flip)
        posterior = DiagonalGaussian(stack.vae.encode_moments(x))
        noise = torch.randn(posterior.mean.shape, generator=generator,
                            device=device)
        return posterior.sample(noise) * SD_VAE_SCALING

    def batches():
        rng = np.random.default_rng(0)
        for i in range(args.steps):
            gen = stream_generator(0, "distill-vae", i, device=device)
            if real_images is not None and rng.random() >= args.synthetic_frac:
                idx = rng.integers(0, len(real_images), args.batch)
                flip = torch.rand(args.batch, generator=gen,
                                  device=device) < 0.5
                yield encode(real_images[idx], gen, flip)
            else:
                yield synthetic_latents(gen, args.batch, latent_size,
                                        channels)

    holdout = synthetic_latents(
        stream_generator(0, "distill-vae-holdout", device=device),
        args.batch, latent_size, channels)
    if real_images is not None:
        holdout = torch.cat([holdout, encode(
            real_images[:args.batch],
            stream_generator(0, "distill-vae-holdout", 1, device=device),
            None)])

    tracker = get_tracker_from(args)
    tracker.set_experiment(args.experiment_name or "tiny_vae_decoder")
    print_banner(f"Distilling tiny decoder: {args.steps} steps, "
                 f"C={args.base_channels}, {args.image_size}px")
    with tracker.start_run(run_name="tiny-decoder"):
        tracker.log_params({"steps": args.steps, "batch": args.batch,
                            "base_channels": args.base_channels,
                            "image_size": args.image_size,
                            "learning_rate": args.learning_rate,
                            "latent_source": source})
        result = distill_vae_decoder(
            stack.vae, decoder, batches(),
            learning_rate=args.learning_rate, holdout=holdout,
            log=lambda k, v, s: tracker.log_metric(k, v, s))
        meta = dict(result.meta, image_size=args.image_size,
                    latent_source=source)
        out = save_tiny_decoder(args.output_dir, result.params, meta)
        tracker.log_metric("rel_l2", round(result.rel_l2, 6))
        tracker.log_artifact(str(out), "tiny_decoder")
    print(f"tiny decoder saved to {out} "
          f"(holdout rel_l2 vs full decoder: {result.rel_l2:.4f})")
    return result


if __name__ == "__main__":
    main()
