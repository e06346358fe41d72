"""Stage-1 offline tool: explode an AWQ checkpoint into per-tensor raw
`.bin` dumps, the input of pack_weights' dump mode.

The port's copy of tools/convert_awq_to_bin.py, with its command line
(and so that of the reference converter, convert_awq_to_bin.py:17-31):
safetensors (a file, or a model directory, sharded or not) read through
io/awq.py without torch, a `.pt` state dict through torch.load. A bf16
tensor of a `.pt` file is dumped as its raw bits, as safetensors' BF16
is read.

Usage: python -m llama_cu_awq_torch.tools.convert_awq_to_bin <ckpt.pt | ckpt.safetensors | model_dir> <out_dir>
"""

from __future__ import annotations

import os
import sys


def load_tensors(src: str):
    """name -> NumPy array of every tensor in src."""
    from llama_cu_awq_torch.io.awq import (read_safetensors,
                                           read_safetensors_dir)

    if os.path.isdir(src):
        return read_safetensors_dir(src)
    if src.endswith(".safetensors"):
        return read_safetensors(src)
    import numpy as np
    import torch

    data = torch.load(src, map_location="cpu", weights_only=True)
    if not isinstance(data, dict):
        raise TypeError(f"expected a state dict in {src}, got {type(data)}")
    out = {}
    for k, v in data.items():
        if not isinstance(v, torch.Tensor):
            continue
        if v.dtype == torch.bfloat16:  # NumPy has no bf16: its bits
            out[k] = v.view(torch.int16).numpy().view(np.uint16)
        else:
            out[k] = v.numpy()
    return out


def main() -> int:
    args = sys.argv[1:]
    if len(args) != 2:
        print(__doc__.strip(), file=sys.stderr)
        return 1
    src, out_dir = args
    os.makedirs(out_dir, exist_ok=True)
    for name, value in load_tensors(src).items():
        print(name, value.dtype, tuple(value.shape))
        with open(os.path.join(out_dir, name + ".bin"), "wb") as f:
            f.write(value.tobytes())
    return 0


if __name__ == "__main__":
    sys.exit(main())
