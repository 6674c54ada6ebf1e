"""Convert a reference PyTorch checkpoint, or a JAX msgpack checkpoint, to
the port's format (counterpart of fal_net_tpu/cli/convert.py).

    python -m fal_net_torch.cli.convert --input model_best.pth.tar --output ckpt_dir/
    python -m fal_net_torch.cli.convert --input jax_run/model_best.msgpack --output ckpt_dir/

The reference publishes pretrained ``.pth.tar`` weights; this writes
``checkpoint.pt`` (``{"m_model", "state_dict"}``, the ``module.`` prefix of
DataParallel training stripped, loadable by every CLI's ``--pretrained``)
and ``checkpoint.json`` (``{model_name, num_levels}``) under ``--output``.
The variant is detected from the state_dict (models/checkpoint.py) and the
plane count from the logits conv.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> str:
    """Returns the path of the written checkpoint."""
    p = argparse.ArgumentParser(description="reference checkpoint -> fal_net_torch .pt")
    p.add_argument("--input", required=True,
                   help="reference .pth/.pth.tar file, or a JAX .msgpack checkpoint or run directory")
    p.add_argument("--output", required=True, help="output directory")
    args = p.parse_args(argv)

    import torch

    from fal_net_torch.models.checkpoint import TORCH_SUFFIXES, detect_variant, read_checkpoint, strip_data_parallel
    from fal_net_torch.models.falnet import resolve_variant

    if args.input.endswith(TORCH_SUFFIXES):
        data = torch.load(args.input, map_location="cpu", weights_only=False)
        state_dict = strip_data_parallel(data["state_dict"] if "state_dict" in data else data)
        spec = detect_variant(state_dict)
        name = data.get("m_model", spec.torch_name) if isinstance(data, dict) else spec.torch_name
    else:
        state_dict, jax_name, _ = read_checkpoint(args.input)
        spec = resolve_variant(jax_name) if jax_name else detect_variant(state_dict)
        name = spec.torch_name
    num_levels = int(state_dict["conv0.weight"].shape[0])
    os.makedirs(args.output, exist_ok=True)
    path = os.path.join(args.output, "checkpoint.pt")
    torch.save({"m_model": name, "state_dict": state_dict}, path)
    with open(os.path.join(args.output, "checkpoint.json"), "w") as f:
        json.dump({"model_name": name, "num_levels": num_levels}, f, indent=2)
    print(f"=> {name} ({spec.name}, N={num_levels}) -> {path}")
    return path


if __name__ == "__main__":
    main()
