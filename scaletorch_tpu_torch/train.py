"""Training entry point of the PyTorch port (counterpart of train.py).

    python -m scaletorch_tpu_torch.train --model_type qwen3 \
        --hidden_size 1024 --intermediate_size 3072 --num_hidden_layers 28 \
        --num_attention_heads 16 --num_key_value_heads 8 --head_dim 128 \
        --vocab_size 151936 --tie_word_embeddings true --rope_theta 1e6 \
        --sequence_length 8192 --gradient_checkpointing true \
        --synthetic_data true --total_train_steps 20

runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path on the
CPU instead. Every config field is a flag (``scaletorch_tpu_torch/
config.py``). Over a device mesh, one process a card (NCCL; gloo with
``--device cpu``), tp varying fastest:

    torchrun --nproc-per-node 4 -m scaletorch_tpu_torch.train \
        --model_type qwen3 ... --tensor_parallel_size 2 \
        --sequence_parallel true --data_parallel_size 2

``--context_parallel_size`` takes ``--attention_backend ring`` (with
``--cp_layout zigzag`` or ``contiguous``), ``ulysses`` or ``auto``.
``--pipeline_parallel_size`` takes ``--pp_engine afab``,
``memory_chunked`` or ``interleaved`` (with ``--pp_virtual_stages``, 0 for
auto), the microbatches being ``--gradient_accumulation_steps``; a
Qwen3-MoE takes ``--expert_parallel_size`` (the batch rows shard over dp
x ep); ``--grad_allreduce_dtype int8`` sends the gradient mean over
``--grad_allreduce_axis`` in int8:

    torchrun --nproc-per-node 4 -m scaletorch_tpu_torch.train \
        --model_type qwen3_moe ... --pipeline_parallel_size 2 \
        --expert_parallel_size 2 --gradient_accumulation_steps 4

A run on a local corpus with a held-out set, evaluated every
100 steps and checkpointed every 500, that resumes from its newest
checkpoint when restarted (``--resume must`` fails instead of starting
from step 0):

    python -m scaletorch_tpu_torch.train --model_type qwen3 \
        --model_name_or_path /data/Qwen3-0.6B \
        --load_pretrained_weights true \
        --dataset_name /data/train.jsonl --eval_dataset_name /data/val.jsonl \
        --eval_frequency 100 --eval_steps 8 \
        --checkpoint_dir /data/ckpt --save_frequency 500 \
        --keep_n_checkpoints 3 --resume auto \
        --sequence_length 4096 --gradient_checkpointing true \
        --total_train_steps 10000 --performance_log_dir /data/logs

``--model_name_or_path`` is a local HF checkpoint directory: its
``config.json`` gives the architecture and, with
``--load_pretrained_weights``, its safetensors the weights;
``--export_hf_dir DIR`` writes the trained weights there as a bf16 HF
checkpoint (safetensors and ``config.json``). The tokenizer
is the one ``--tokenizer_name_or_path`` (default: the model directory)
holds, built with ``transformers``; a Python caller can hand
``Trainer(cfg, tokenizer=...)`` any tokenizer object instead.

The exit code is the reference's contract: 0 when the run finished or
was preempted (SIGTERM or SIGINT asks for an emergency checkpoint at the
next step boundary; the log says whether it is on disk, and a restart
with ``--resume auto`` continues from it), 42 when the divergence
sentinel aborted (a crash report is under ``--crash_report_dir``), 43
when the hang watchdog fired (``--ft_hang_timeout``; it exits from its
own thread) or the elastic layer could not continue in place
(``--elastic``: a fleet restart resumes the run), 130 on a
KeyboardInterrupt. ``--telemetry_dir D`` writes a
Chrome trace, the JSONL event stream and profiler windows under D, and
``kill -USR1 <pid>`` dumps a live snapshot there.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    from scaletorch_tpu_torch.config import parse_args
    from scaletorch_tpu_torch.dist import shutdown_distributed

    argv = list(sys.argv[1:] if argv is None else argv)
    # options of this entry point, not of the config
    extra = {"--device": None, "--export_hf_dir": None}
    for flag in extra:
        if flag in argv:
            i = argv.index(flag)
            extra[flag] = argv[i + 1]
            del argv[i:i + 2]
    cfg = parse_args(argv)
    try:
        return _run(cfg, extra)
    finally:
        shutdown_distributed()


def _run(cfg, extra) -> int:
    from scaletorch_tpu_torch.resilience import TrainingDivergedError
    from scaletorch_tpu_torch.resilience_distributed import (
        DIVERGED_EXIT_CODE,
        WATCHDOG_EXIT_CODE,
        ElasticRemeshError,
    )
    from scaletorch_tpu_torch.trainer.trainer import Trainer
    from scaletorch_tpu_torch.utils.logger import get_logger

    log = get_logger()
    # with --resume auto|must the Trainer restores the newest checkpoint
    try:
        trainer = Trainer(cfg, device=extra["--device"])
    except ElasticRemeshError as exc:  # a parked rank never admitted
        log.error(f"elastic continuation impossible: {exc}")
        return WATCHDOG_EXIT_CODE
    if trainer.telemetry.enabled:
        log.info(f"telemetry enabled -> {trainer.telemetry.directory} "
                 "(Chrome trace + JSONL event stream; kill -USR1 "
                 f"{os.getpid()} dumps a live snapshot)")
    try:
        last = trainer.train()
        if trainer.preempted:
            # a clean exit either way, with the truth about what survived
            if trainer.emergency_checkpoint_saved:
                log.warning(
                    f"preempted at step {trainer.global_step}; emergency "
                    "checkpoint saved — restart with --resume auto to "
                    "continue")
            else:
                log.error(
                    f"preempted at step {trainer.global_step} and NO "
                    "emergency checkpoint could be written — a restart "
                    "resumes from the last periodic save (or step 0)")
            return 0
        if (cfg.checkpoint_dir and cfg.save_frequency
                and trainer.checkpoint_manager.latest_step()
                != trainer.global_step):
            trainer.save_checkpoint()
        if extra["--export_hf_dir"]:
            trainer.export_hf(extra["--export_hf_dir"])
    except TrainingDivergedError as exc:
        # the trainer wrote its crash report; the code tells a launcher
        # "diverged, needs a human" from "preempted, just restart"
        log.error(f"training aborted: {exc}")
        return DIVERGED_EXIT_CODE
    except ElasticRemeshError as exc:
        # the elastic layer cannot continue in place (membership below
        # its floor, an unshrinkable mesh, a group that cannot be
        # re-formed): the restartable code, for the launcher's fleet
        # restart from the newest checkpoint. The process group may hold
        # the lost peer, and a teardown (an NCCL destroy) would wait on
        # it: the process ends here, without one
        log.error(f"elastic continuation impossible: {exc}")
        trainer.close()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(WATCHDOG_EXIT_CODE)
    except KeyboardInterrupt:
        log.warning("interrupted; exiting")
        return 130
    finally:
        trainer.close()
    log.info(f"done: {last}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
