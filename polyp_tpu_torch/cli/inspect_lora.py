"""LoRA adapter introspection CLI: the twin of
polyp_tpu/cli/inspect_lora.py (the reference's get_lorarized_layers.py).
Lists the modules carrying lora_A / lora_B factors in an adapter the port
saved (lora/surgery.py::save_lora: an adapter, or a whole trainable
bundle whose `unet_lora` is read), with their ranks and parameter count.
JAX-written orbax directories are the JAX package's to read.

Usage: polyp-inspect-lora-torch <adapter file>
"""

from __future__ import annotations

import argparse

from polyp_tpu_torch.lora.surgery import (
    count_lora_params, load_lora, lorarized_layers)


def main(argv=None) -> dict:
    """Prints the report; returns {"modules", "ranks", "params",
    "extras"}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("path", type=str,
                        help="adapter file written by save_lora")
    args = parser.parse_args(argv)

    bundle = load_lora(args.path)
    adapter = bundle.get("unet_lora", bundle)
    modules = lorarized_layers(adapter)
    print("Recovered LoRA target modules:")
    for module in modules:
        print(f"- {module}")
    # lora_A is [in, r]
    ranks = sorted({int(adapter[m]["lora_A"].shape[-1]) for m in modules})
    params = count_lora_params(adapter)
    print(f"\n{len(modules)} adapted modules, rank(s) {ranks}, "
          f"{params:,} adapter params")
    extras = [k for k in bundle if k != "unet_lora"] \
        if "unet_lora" in bundle else []
    if extras:
        print(f"bundle extras: {extras}")
    return {"modules": modules, "ranks": ranks, "params": params,
            "extras": extras}


if __name__ == "__main__":
    main()
