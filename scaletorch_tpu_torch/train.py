"""Training entry point of the PyTorch port (counterpart of train.py).

    python -m scaletorch_tpu_torch.train --model_type qwen3 \
        --hidden_size 1024 --intermediate_size 3072 --num_hidden_layers 28 \
        --num_attention_heads 16 --num_key_value_heads 8 --head_dim 128 \
        --vocab_size 151936 --tie_word_embeddings true --rope_theta 1e6 \
        --sequence_length 8192 --gradient_checkpointing true \
        --synthetic_data true --total_train_steps 20

runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path on the
CPU instead.
"""

from __future__ import annotations

import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    from scaletorch_tpu_torch.config import parse_args
    from scaletorch_tpu_torch.trainer.trainer import Trainer
    from scaletorch_tpu_torch.utils.logger import get_logger

    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    cfg = parse_args(argv)
    trainer = Trainer(cfg, device=device)
    last = trainer.train()
    get_logger().info(f"done: {last}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
