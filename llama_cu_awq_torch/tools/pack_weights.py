"""Stage-2 offline tool: pack AWQ tensors into the engine's flat `.bin`.

The port's copy of tools/pack_weights.py, with its command line (and so
that of the reference's native packer, weight_packer.cpp:235, and of
native/weight_packer.cpp): it reads through io/awq.py and writes through
io/checkpoint.save_checkpoint.

Usage:
  python -m llama_cu_awq_torch.tools.pack_weights <config.json> <dump_dir> <out.bin> <old_format 0|1>
  python -m llama_cu_awq_torch.tools.pack_weights --model-dir <hf_awq_dir> <out.bin>
"""

from __future__ import annotations

import sys


def main() -> int:
    from llama_cu_awq_torch.io.awq import (checkpoint_from_dump_dir,
                                           load_awq_model_dir)
    from llama_cu_awq_torch.io.checkpoint import save_checkpoint

    args = sys.argv[1:]
    if len(args) == 3 and args[0] == "--model-dir":
        ckpt, out = load_awq_model_dir(args[1]), args[2]
    elif len(args) == 4:
        config_json, dump_dir, out, old = args
        ckpt = checkpoint_from_dump_dir(dump_dir, config_json,
                                        old_format=bool(int(old)))
    else:
        print(__doc__.strip(), file=sys.stderr)
        return 1
    save_checkpoint(out, ckpt)
    cfg = ckpt.config
    print(f"packed {cfg.n_layers}-layer model (dim {cfg.dim}, vocab "
          f"{cfg.vocab_size}) -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
