#!/usr/bin/env python3
"""Build and drive the PyTorch port on one CUDA card; fail on any fault.

Run from the root of a checkout, with one visible card:

    python3 chip_smoke.py

It takes no arguments (``--parallel-worker DIR`` is the rank side of
the ``parallel`` phase, ``--fleet-worker DIR SCENARIO`` of the
multi-process runtime's, each started by it). One phase alone, e.g. the grouped-MLP kernels in
bf16 (copied into a checkout of another commit and run there, this times
that commit's kernels by the same yardstick):

    python -c "import torch, chip_smoke as c; c.phase_device(); \
c.phase_build(); c.phase_kernel_grouped_mlp(dtypes=(torch.bfloat16,))"

Phases, each printing one JSON line (any failure raises and the exit code
is non-zero; no phase catches an exception):

  1. device   — the card's name and power limit (nvidia-smi) and
                torch.cuda.get_device_name(0); no card, no run.
  2. build    — nvcc builds every kernel source in
                scaletorch_tpu_torch/csrc/ (paged_decode, flash_fwd,
                flash_bwd, grouped_mlp_fwd, grouped_mlp_bwd) into
                build/kernels/, all compiles started together; prints
                each kernel's registers, stack frame and spill bytes from
                ptxas's report in build/kernels/<source>.log and fails if
                a tensor-core (mma.sync) kernel uses local memory.
  3. kernel_paged_decode — the paged-decode kernel (K4) against its plain
                PyTorch version at the serving shapes of Qwen3-0.6B
                (Hq 16, Hkv 8, D 128, 8 slots, page 16, 128 pages per
                slot), fp32 and bf16: max abs and the worst slot's
                relative error against stated limits, beside a control
                (the plain version with one page of the longest slot
                dropped, which must fail them); two calls equal bit for
                bit; its time, the plain version's, a library
                yardstick's (gather + scaled_dot_product_attention, which
                the port never calls), the memory bound and the share of
                it reached; beside the kernel's time, its time with the
                host's enqueue kept out of the span (`time_ms`'s
                ``spin``) and the wrapper's host µs per call; the same
                at Qwen3-30B-A3B's heads (Hq 32, Hkv 4, n_rep 8), at one
                tp4 rank of qwen3-32b (Hq 16, Hkv 2, n_rep 8), at one
                slot of 32768 keys and at GPT-MoE's heads (Hq 4, Hkv 4,
                D 32, 8 slots of up to 256 keys) and at one rank's of it
                over tp2 (Hq 2, Hkv 2) and tp4 (Hq 1, Hkv 1); then at
                qwen3-14b's heads (n_rep 5, D 128) and dense-tiny's
                (n_rep 2, D 32).
  4. kernel_flash — the flash kernels K1 (forward), K2 (dQ) and K3 (dK,
                dV) against their plain versions at the training shape of
                Qwen3-0.6B (B 1, Hq 16, Hkv 8, S 8192, D 128, causal),
                fp32 and bf16: max abs, whole-tensor and per-tile
                relative errors against stated limits, beside the readings
                of two controls (kernels that skip one tile, which must
                fail the checks, and a lower-precision plain version); each
                kernel's time, its plain version's, the library yardstick
                (scaled_dot_product_attention forward, and its autograd
                backward for K2 + K3 together), the bound, the share of
                the bound reached and the TFLOP/s. K2 and K3 run twice and
                must agree bit for bit; bf16 K2 and K3 run again at
                Qwen3-30B-A3B's training shape (Hq 32, Hkv 4, S 4096),
                checked against their plain versions and timed; K1-K3
                also at qwen3-14b's heads (Hq 40, Hkv 8, D 128) and
                dense-tiny's (Hq 8, Hkv 4, D 32), S 2048, against their
                plain versions under the same limits; and at the
                long-context example's head_dim 16 (B 1, S 2048: its 4
                heads, and one Ulysses cp4 rank's 1) with every check of
                the first row (controls, bit for bit, bound, SDPA).
 4b. kernel_ring_blocks — K1 and K2/K3 at the full (non-causal) blocks
                the cp ring runs on the headline row over cp 4 (Hq 16, Hkv
                8, D 128): the contiguous layout's 2048 x 2048
                off-diagonal block and the zigzag layout's 2048 x 1024 and
                1024 x 2048 blocks, and the long-context example's
                zigzag blocks at its heads (Hq 4, Hkv 4, D 16; seq 2048
                over cp 4: 512 x 256 and 256 x 512), fp32 and bf16,
                against their plain versions under kernel_flash's limits,
                beside the
                one-tile-skipped control that must fail them; each
                kernel's time, its plain version's, its bound and the
                SDPA time on the same block.
  5. decode_parity — Qwen3-0.6B at full width, fp32, random weights from
                a seeded generator: teacher-forced paged decode of
                2 x 64 tokens through the kernel and through the gather
                path; max |logit difference| <= 1e-3.
  6. serve    — the paged engine at Qwen3-0.6B width in bf16 serves 16
                greedy requests (half behind a shared 256-token prefix)
                with the kernel counted: every outcome ok, prefix hits,
                page conservation, pools updated in place; the engine
                captured its prefill and decode steps once each as CUDA
                graphs and replayed them once a step, with 28 kernel
                launches per decode replay (launch counts = the capture
                warm-ups' plus each capture's once per replay); TPOT p50,
                decode tokens/s, replays and peak memory. The same
                traffic through the gather path (a second graphed engine,
                built after the first is freed) gives the greedy
                agreement (printed, not asserted: bf16 can diverge late
                in a sequence).
  7. profile  — torch.profiler over 16 steady decode ticks (16 replays)
                of the same engine: wall and device time per step, the
                device's busy share, K4's device time, kernel launches
                per step as the trace counts them inside the graph (K4
                once a layer, checked where the trace shows them), and
                the kernels that take the device time. The trace drops
                the records of its first kernels, so one tick before
                the window is traced and left out; a replay recorded
                whole stands in for one that lost records, K4's count is
                checked on the whole replays (at least half), and a
                window that lost the record of a launch outside a graph
                is profiled again (at most 3; the phase fails if every
                one lost some).
 7b. decode_graph — the one-capture contract at the same width: every
                prefill and 16 decode replays of three engines (paged
                through K4, paged through the gather path, dense) equal
                to the eager step function on the same buffers bit for
                bit; paged (gather) == dense greedy tokens; sampled
                tokens (temperature 0.8, top-p 0.9, 12 requests on 8
                slots) the same per request in two submission orders;
                one capture of each step through a prefix hit, a cancel,
                a deadline and a quarantine forced inside the graph
                (NaN logits on a poison token), every static buffer in
                place.
 7c. runtime_serve — the engine's runtime at the same width, graphed:
                the serve traffic without and with a SpanTracer and a
                TelemetryExporter, in 3 blocks of (without, with, with,
                without): equal tokens, one decode span a decode step, K4
                28 a replay; TPOT p50 and decode tokens/s of each, the
                medians' change beside each side's range, and the host
                µs of one span); a NaN poison (ServingFaultInjector) quarantines
                exactly one request and the other 15 keep the clean run's
                tokens; a submit storm into a bounded queue sheds
                oldest-first and a deadline storm times the rest out; a
                stalled decode step fires make_serving_watchdog (a
                recording exit with 44, a crash report with the engine's
                counters, span tail and the main thread in the stall); a
                real SIGTERM mid-run makes run() drain (8 ok, 8
                aborted); a donor engine's prefix pages imported into a
                fresh engine give prefix hits and the donor's greedy
                tokens. In every engine: one capture of each step,
                launches = warm-ups + per capture x replays, every static
                buffer where it was, one terminal outcome per request,
                page conservation.
 7d. gateway  — the serving front door at the same width, fp32, 8 slots,
                paged: the serve traffic through an in-process
                ServingGateway over SSE (its worker thread replays the
                graphs the main thread captured; the worker is held until
                every request is offered, so the engine admits as a
                direct run does), tokens bit for bit the same engine's
                driven directly, one capture of each step, K4 28 a
                replay; tokens/s, TTFT mean and TPOT p50 beside the
                direct run's, the gateway's added host µs a token; then
                ``python -m scaletorch_tpu_torch.serve`` as a process:
                one request equal to the direct engine's, one capture on
                its /metrics, SIGTERM's drain exits 0.
 7e. gateway_fleet — the serve entry with two replica processes
                (``python -m scaletorch_tpu_torch.replica``, unix sockets)
                on the one card: the replica serving the first stream is
                SIGKILLed (``--ft_gw_replica_crash_at 1``), the stream
                ends ``aborted``, the supervisor restarts it, a follow-up
                streams the direct engine's tokens; the other replica is
                SIGKILLed mid-stream while the survivor streams the
                shared prompt (its tokens the direct engine's prefix-hit
                pass) and rejoins WARM (the donor's frozen prefix
                pages pulled over the wire), its first shared-prefix
                request a prefix hit with the tokens of the direct
                engine's prefix-hit pass; per replica process one capture
                of each step, K4 28 a decode replay (its /metrics); the
                gateway's ledger; SIGTERM drains the fleet to exit 0;
                spawn-to-READY and crash-to-READY s, warm pages and
                transfer s.
 7f. disagg_serve — DisaggregatedEngine split "1:1" with both slices on
                the card (two page pools, the weights shared) behind the
                gateway: the serve traffic's tokens bit for bit the
                colocated engine's without a prefix cache, one capture of
                each step, K4 28 a decode replay on the decode pool and
                none in the prefill step, both allocators conserved;
                TTFT, TPOT, tokens/s, handoff p50 s, pages and bytes, the
                two slices' busy fractions; then the serve entry with
                ``--disagg 1:1`` as a process: one request, the /healthz
                disagg block, SIGTERM's drain exits 0.
  8. geometry_serve — the presets' other head geometries through K4: a
                paged engine at dense-tiny (head_dim 32), fp32, whose
                greedy tokens must equal the dense engine's, K4 launched
                once a layer a decode replay; and a 2-layer cut of
                qwen3-14b's width (n_rep 5), fp32, teacher-forced paged
                decode of 2 x 64 tokens through K4 and through the gather
                path, max |logit difference| <= 1e-3.
  9. train_parity — Qwen3-0.6B at full width and depth, fp32, random
                weights from a seeded generator, 2 x 1024 tokens, gradient
                checkpointing: the loss and every gradient through the
                flash backend (K1-K3) and through sdpa.
 10. train    — the port's benchmark entry (benchmark_config) on the
                bench headline row (qwen3-0.6b, seq 8192, micro-batch 1,
                gradient checkpointing, bf16 compute, fp32 masters, AdamW):
                its Trainer takes 2 warm-up and 5 timed steps on synthetic
                data with the kernels counted: finite losses, no skipped
                update, and 56 / 28 / 28 launches of K1 / K2 / K3 per step;
                tokens/s, MFU and peak memory as the entry reports them.
 11. train_profile — torch.profiler over 2 steady steps of the same
                trainer.
 11a. data_train — the headline row cut to DRILL_LAYERS (8) layers, as
                every data, checkpoint and runtime drill is, trained
                through ``Trainer`` from a
                ``.jsonl`` of seeded documents written under build/ (a
                byte tokenizer defined here), evaluated every 2 steps on
                2 batches of a second file, checkpointed every 2 steps
                (asynchronously, keep 1). Run A: 4 steps straight, twice
                (the spread of the two is the limit: 0 when they agree bit
                for bit); run B: 2 steps and the step-2 checkpoint; run C:
                a fresh ``Trainer`` with ``resume="must"`` to step 4. C
                must restore step 2, loader position 2 and AdamW's count,
                keep A's learning rates exactly and its losses and val
                losses within the limit; every train step launches K1 /
                K2 / K3 16 / 8 / 8 times, every eval batch K1 8 times
                and no K2 / K3; the cached eval set scores the same again.
                Prints the seconds and tokens of reading and tokenizing
                a 32 MiB corpus (one process), the free disk, the
                checkpoint bytes, each save's blocking and total seconds,
                the restore seconds, eval seconds a batch and the
                data-fed tokens/s beside the ``train`` phase's synthetic
                ones; deletes its files.
 11b. hf_roundtrip — seeded 0.6B parameters exported with
                ``save_hf_params`` in bf16 as >= 2 shards plus the
                config.json of ``hf_config_dict``; every tensor ``load_hf_params`` reads back
                equals the source rounded to bf16 bit for bit; a
                ``Trainer`` with ``model_name_or_path`` and
                ``load_pretrained_weights`` gives the first loss, on a
                fixed batch, of one handed the rounded parameters; paged,
                graphed engines from the loaded and from the rounded
                parameters serve 8 greedy requests with equal tokens.
                Prints write and read GB/s.
 11c. train_table — every distinct row of the reference's single-chip
                table (``benchmark.SINGLE_CHIP_ROWS``: 0.6B at seq 2048
                bs 2, at seq 8192 and 16384 with GC, at seq 16384 with
                bf16 masters and ``save_attn``, at seq 2048 bs 4 with 2
                accumulated microbatches; 1.7B at seq 2048 and at seq
                8192 with GC, bf16 masters; 4B at seq 2048 with GC, bf16
                masters and Adafactor) at full width and depth through
                ``benchmark_config``: 2 warm-up and 3 timed steps, finite
                losses, no skipped update, parameters and optimizer state
                in the row's master dtype, and K1 / K2 / K3 launches per
                step of 2L / L / L under GC ``nothing_saveable`` (and the
                dots policies), L / L / L without GC and under
                ``save_attn``, each times the accumulation. Prints each
                row's tokens/s, MFU, step seconds and peak memory.
 11d. remat_parity — one set of seeded weights at the headline row (bf16
                compute), a forward and backward under each of the four
                remat policies, twice: loss and every gradient equal to
                ``nothing_saveable``'s bit for bit, K1 56 times (28 under
                ``save_attn``), K2 and K3 28; prints each policy's
                seconds and peak memory above the weights.
     The Qwen3-0.6B models are freed here; the Qwen3-30B-A3B phases follow
     (full width, random weights from a seeded generator, the grouped-MLP
     kernels switched on through the config or the environment):
 11e. runtime_preempt — the headline row (DRILL_LAYERS) fed from a
                seeded .jsonl
                (free disk printed first; checkpoints under
                build/runtime/, each drill's directory deleted after it):
                two straight 6-step runs (the first checkpointed every 2
                steps, asynchronous, keep 1); the same run with a real
                SIGTERM after step 3 (ft_sigterm_at_step) returns
                preempted with the emergency checkpoint of step 3 on
                disk, and prints sigterm_to_readable_s and its parts (the
                drain of the step-2 save in flight, the snapshot, the
                write) against a 30 s grace period; a resume="must" run's
                losses and learning rates of steps 4-6 equal the straight
                run's within the spread of the two straight runs; the
                drill again with no save in flight; then
                ``python -m scaletorch_tpu_torch.train`` with the drill,
                cut to 2 layers, exits 0 and logs that its checkpoint is
                on disk. K1/K2/K3 16/8/8 in every step.
 11f. runtime_rollback — one run (DRILL_LAYERS): a corrupt read at
                stream position 3
                (skipped, counted), one failed save (retried), a NaN
                after step 5 under divergence_policy="rollback": one
                rollback, every parameter and optimizer state tensor in
                its storage, 6 steps logged with finite losses, the
                loader past the bad batch; the restore's seconds.
 11g. runtime_telemetry — 8 steps with telemetry_dir: one step_boundary /
                data_fetch / step_dispatch span a step in the Chrome
                trace, one train_step JSONL record a step, a manual
                (profile_steps) and a slow-step (ft_slow_step_at_step)
                torch.profiler window with K1/K2/K3 56/28/28 records and
                none lost, a SIGUSR1 snapshot; then tokens/s of 2 + 5
                steps without and with telemetry, in 3 blocks of
                (without, with, with, without): the medians' change
                beside each side's range.
 11h. runtime_watchdog — the trainer's HangWatchdog (1 s) on an injected
                3 s hang, then on a 3 s stall of the card
                (torch.cuda._sleep) while the main thread waits in
                torch.cuda.synchronize() and in .item(): each fires (a
                recording exit with 43) while the main thread is still
                blocked, within the timeout and a poll, and writes a
                crash report with the main thread's stack in the wait,
                the config fingerprint, the monitor records and the span
                tail.
 12. kernel_grouped_mlp — K5 (forward), K6 (dx) and K7 (dW) against their
                plain versions in fp32 and bf16 at three shapes: train (E
                128, G 1, C 320, H 2048, I 768, counts from a real routing
                of seeded tokens plus one expert at 0 and one at C; K5-K7),
                prefill (G 8, C 512, dropless; K5) and decode (G 8, C 1;
                K5), and the moe example's (E 8, top-2, G 1, C 128, H 64,
                I 64; K5-K7). Max abs, whole-tensor and worst-tile (worst-expert for
                dW) relative errors against stated limits (s, dG and dU of
                the backward's grads pass too), beside two controls that
                must fail them (one filled slot tile skipped; K7 with dO
                unmasked past the count); two runs of the backward must
                agree bit for bit; each launch's time (the grads pass, K6
                and K7 each alone, and the whole backward as
                _GroupedSwiGLU.backward runs it), its plain version's, the
                library's (cuBLAS bmm of the launch's own products for K6
                and K7; the einsum path for K5 and the whole backward;
                several calls, not one) and the bound of its own work.
                Then K5 on the decode's and the prefill's slabs of rank 0
                of a serving mesh (no exchange: its E/ep experts with the
                rows routed to them, its I/tp): decode ep4 [32, 8, 1,
                2048] I 768, tp2 x ep2 [64, ...] I 384, tp4 [128, ...] I
                192; prefill ep4 [32, 8, 512, 2048] I 768 and tp2 x ep2
                [64, ...] I 384; each with the skipped-tile control.
 12b. kernel_ep_blocks — K5, the grads pass, K6 and K7 on the slabs the
                ep exchange hands one rank at the train cell under ep 4:
                [E/ep, ep·G, C, H] = [32, 4, 320, 2048], fill counts per
                (expert, source rank) from a seeded routing of four ranks'
                tokens (uneven across the ranks), fp32 and bf16, checked
                and timed as phase 12 checks and times the train shape
                (its limits, both controls, the backward twice for equal
                bits; each launch's time, bound and the einsum path's
                time on the same slabs).
 13. moe_decode_parity — 4 layers, fp32, dropless: teacher-forced paged
                decode of 2 x 64 tokens through K4 + K5 and through the
                gather path + einsum path; max |logit difference| <= 1e-3.
 14. moe_serve — the engine at full width and depth (48 layers), bf16,
                dropless, the traffic of phase 6, graphed as there: every
                outcome ok, page conservation, one capture of each step,
                48 K4 and 48 K5 launches per decode replay and 48 K5 per
                prefill replay, peak memory; the same traffic through the
                gather path + einsum path gives the greedy agreement
                (printed); then torch.profiler over 16 steady decode
                ticks, as phase 7 (K5 48 a replay in the trace too).
 15. moe_train_parity — 2 layers, fp32, 2 x 1024 tokens, GC: the loss (CE
                + aux) and every gradient with the kernels on (K5-K7 and
                K1-K3) against the einsum path (K1-K3).
 16. moe_train — benchmark_config on make_bench_args("qwen3-30b-a3b",
                seq=4096, gc=True) cut to 4 layers, kernels on: 2 warm-up
                and 5 timed steps, finite losses, no skipped update, and
                8 / 4 / 4 / 8 / 4 / 4 launches of K1 / K2 / K3 / K5 / K6 /
                K7 per step, and 4 grads passes; tokens/s, MFU over the
                active parameters, peak memory, the routing statistics and
                the rows routed per layer.
 17. moe_train_profile — torch.profiler over 2 steady steps of it.
 17b. moe_train_save_attn — the moe_train row under ``save_attn``: 1
                warm-up and 3 timed steps, K1 4 a step (8 under
                ``nothing_saveable``), K2 / K3 / K6 / K7 and the grads
                pass 4, K5 8.
 17c. gpt_moe_serve — GPT-MoE at GPTMoEConfig's defaults (the minGPT
                width: block 256, vocab 65, 4 layers, 4 heads of 32,
                n_embd 128, 8 experts top-2, capacity 1.25), fp32,
                seeded weights with every matrix scaled by 10: the
                teacher-forced paged decode through K4 against the gather
                path (max |Δlogit| <= 1e-3, K4 once a layer a decode step);
                the paged engine (8 slots, page 16) serves 16 greedy
                requests of 16-160 prompt tokens, 64 new each: every
                outcome ok, one capture of each step, K4 4 launches a
                decode replay and none in the prefill, counted from a
                zeroed count; decode tokens/s, TTFT, TPOT; at capacity 4.0
                (dropless) the paged engine on the gather path and the
                dense engine, prefix cache off, token for token.
      model_zoo — on the card: MLA (embed 1024, 16 heads, q / kv ranks
                512 / 256) prefill + 128 decode steps against its full
                forward; ``sorted_moe_forward`` at world 1 against a
                float64 per-token loop; LeNet against its CPU run (each
                <= 1e-4).
      mingpt_train — the port's minGPT example on the card, dense then
                ``--use_moe true``, 120 steps at block 64: the eval NLL
                falls (dense below 2.4, the JAX example test's bound);
                tokens/s and ms a step.
      mnist_train — the port's MNIST example, synthetic digits, 2
                epochs: last loss below 1.6; test accuracy, steps/s.
      resnet_train — the port's ImageNet example (``run``) with resnet18
                and resnet34 at 224², 1000 classes, fp32, on its synthetic
                data: 3 epochs of 4 steps of 64 images, an eval of 128
                images after each; every loss finite, the last epoch's
                mean below the first's, top-1 / top-5 computed; images/s
                and ms a step after the first epoch, peak memory.
      examples — the examples over the mesh (ROADMAP 9c) at the mesh one
                card allows (``run_examples(1)``), 40 steps each: fsdp
                saved, then 2 steps resumed; moe (ep 1, the grouped-MLP
                kernels on: K1-K3 at D 16 and K5-K7 at H 64 / I 64
                launched); pipeline (pp 1) under afab, interleaved and
                memory_chunked; longctx (cp 1, seq 2048) ring and Ulysses
                (K1-K3 at D 16). Every loss finite and falling (the mean of
                the last quarter below the first's; not the 2 resumed
                steps), the kernels each run must launch counted from
                zero; seconds, losses and launches a run. The device-mesh
                demos need 4 ranks (the four-card ``examples`` group).
 18. parallel — ``torch.distributed.run`` of this script (``--parallel-
                worker``) with one rank a visible card, NCCL, under a
                wall-clock limit; a failed rank fails the phase. One card:
                the distributed ``Trainer`` (an NCCL group of one) at the
                headline row, full width and depth, and at Qwen3-30B-A3B's
                train row (4 layers, K5-K7 on), 2 + 3 steps each equal to
                the single-device ``Trainer``'s bit for bit (losses, grad
                norms, routing statistics, final parameters), K1/K2/K3
                56/28/28 a step (and K1-K7 8/4/4/8/4/4, 4 grads passes, on
                the MoE row). Four cards: the headline row under tp4 with
                SP, cp4 ring zigzag, cp4 Ulysses, dp2 x tp2 and dp2 x cp2
                ring contiguous: each layout's fp32 loss and gradients
                against the one-card step on the same weights and global
                batch (TRAIN_PARITY), then its bf16 ``Trainer`` 2 + 10
                steps: tokens/s and MFU a card, peak memory a card,
                K1/K2/K3 launches a step on every rank as the schedule
                reckons them; qwen3-8b at seq 4096 under tp4 + SP (2 + 10
                steps, finite losses, no skipped update); the headline row
                with M = 4 microbatches under pp4 afab, pp2 x dp2
                memory_chunked and pp2 x tp2 + SP interleaved (vpp 2);
                Qwen3-30B-A3B's width cut to 2 layers under ep4 and pp2 x
                ep2 (the routing statistics against one card's too, K5-K7
                counted); dp4 with the fp32 and with the int8 gradient
                wire (the int8 gradients' cosine >= 0.999 against the
                fp32 wire's, leaf by leaf and whole, no skipped update,
                the wire bytes each reckons); Qwen3-30B-A3B at full width
                under ep4 (bf16 masters, Adafactor, seq 4096 a rank, GC,
                MOE_FULL_LAYERS layers): finite losses, no skipped update,
                routing statistics, K1-K7 launches. Then (PR 14), one
                card: the engine on a mesh of one against the plain
                engine (paged and dense: tokens and every step's logits
                bit for bit, one capture of each step), ``setup_fsdp``'s
                step and the mesh step with Adafactor given its shard
                layout, each against the one-card step bit for bit (3
                steps, losses and parameters). Four cards: a captured NCCL
                all-reduce replayed (the tp steps are built on it);
                qwen3-32b at full width and depth, bf16, paged, 8 slots,
                served on one card and then over tp4 (16/16 ok, the same
                tokens on every rank, one capture of each step, K4 once a
                layer per decode replay; decode tokens/s, TTFT, TPOT and
                peak memory a card beside one card's); its width cut to
                2 layers in fp32 over tp4 against one card (teacher-forced
                logits <= 1e-3, greedy tokens equal); Qwen3-0.6B fp32
                dense over tp2 x dp2 with the slots over dp (tokens equal
                to one card's); FSDP over 4 of qwen3-8b at seq 4096 (fp32
                parity at 2 layers, then bf16 at full depth: step s,
                tokens/s, MFU and peak memory a card, parameters and AdamW
                state 1/4 a rank); Adafactor's update over tp4 + SP
                (headline row) and pp2 x ep2 (30B-A3B width, 2 layers)
                against one card's, and the full-width ep4 Adafactor row
                again; cp4 ring zigzag and cp4 Ulysses under each remat
                policy (fp32 gradients bit for bit against
                ``nothing_saveable``, K1-K3 launches as the policy reckons
                them, bf16 step s). Then, four cards: the
                Qwen3-MoE engine over ep4 and over tp2 x ep2 — Qwen3-30B-A3B's
                width cut to 4 layers, fp32, dropless, against one card
                (teacher-forced paged logits <= 1e-3, 4 greedy requests'
                tokens equal), and at full width and depth, bf16, the
                serve cell's 16 requests on one card and over each mesh
                (16/16 ok, one capture of each step, K4 = K5 = 48 a decode
                replay and K5 = 48 a prefill replay on every rank, the same
                tokens on every rank; decode tokens/s, TTFT, TPOT, replay
                ms and peak memory a card beside one card's). Then, four
                cards: ``examples`` (``run_examples(4)``: minGPT
                and MNIST data parallel, MNIST --fsdp, fsdp over 4 saved
                and resumed, moe ep2 x dp2, pipeline pp2 x dp2 under each
                engine, longctx cp4 ring and Ulysses, the device-mesh
                demos; each loss falling, K1-K3 and K5-K7 counted) and
                ``serve_gpt_moe_tp`` (GPT-MoE at the minGPT example's
                width, fp32, gpt_moe_serve's traffic on one card, then
                over tp2 x dp2 and tp4: 16/16 ok, one capture a step, K4
                = 4 a decode replay and none in a prefill replay on every
                rank, greedy tokens equal to one card's; TPOT, replay ms
                beside one card's). The line names the world and the
                checks run and not run.
 18b. runtime_multiproc — the multi-process checkpoint on one card: the
                headline row (DRILL_LAYERS; fp32 masters, AdamW) in a
                world-1 NCCL
                group takes 2 steps and saves through the process-group
                path (global tensors, DCP over the checkpoint's gloo
                group); a new ``Trainer`` restores it bit for bit; 2 CPU
                gloo ranks at tp2 (``scaletorch_tpu_torch.launch``)
                restore it, each holding its slices of the card's tensors
                bit for bit, and export it sharded, byte-equal to the
                card's one-card export. Prints the save's blocking and
                total s, restore s, bytes a rank, the ranks' restore and
                export s. Four cards only, alone (``phase_runtime_fleet``):
                ``nccl_abort`` (does an all-reduce with a SIGKILLed peer
                raise, and does a group re-form in place), ``elastic_kill``
                and ``elastic_hang`` (the headline row at dp4 under
                ``launch.py --elastic``: in place, shrink and regrow;
                where NCCL cannot re-form, exit 43 and a fleet restart;
                identical final parameters either way; detection,
                recovery and step s), ``sigterm_one_rank`` (tp2 x dp2,
                fp32: one emergency step on every rank, a dp4 resume bit
                for bit and its next loss within TRAIN_PARITY) and
                ``coordination_cost`` (dp4 steps with and without the
                coordinated decisions in alternated windows).
 19. kernels  — every Pallas kernel of the JAX package, ported or not.

Then the seconds each phase took, the per-kernel contract line (K1-K7,
and the grads pass that K6 and K7 share), the nvidia-smi line, and last:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from scaletorch_tpu_torch.benchmark import (
    HEADLINE,
    SINGLE_CHIP_ROWS,
    bench_row_args,
    benchmark_config,
    make_bench_args,
)
from scaletorch_tpu_torch.inference import (
    SERVING_STALL_EXIT_CODE,
    InferenceEngine,
    SamplingParams,
    ServingFaultInjector,
    StaticStep,
    make_serving_watchdog,
    teacher_forced_decode,
    teacher_forced_decode_paged,
)
from scaletorch_tpu_torch.examples.imagenet import dist_train
from scaletorch_tpu_torch.examples.mingpt import train_mingpt
from scaletorch_tpu_torch.examples.mnist import train_mnist
from scaletorch_tpu_torch.launch import ELASTIC_NCCL_ENV
from scaletorch_tpu_torch.models import (
    GPTMoEConfig,
    GPTMoEForCausalLM,
    LlamaForCausalLM,
    Qwen3MoEForCausalLM,
    init_params,
    model_config,
)
from scaletorch_tpu_torch.models import gpt_moe, lenet, qwen3_moe
from scaletorch_tpu_torch.models.attention import (
    AttentionConfig,
    MultiHeadLatentAttention,
)
from scaletorch_tpu_torch.models.llama import REMAT_POLICIES
from scaletorch_tpu_torch.models.presets import preset
from scaletorch_tpu_torch.ops import _build
from scaletorch_tpu_torch.ops import flash as tf
from scaletorch_tpu_torch.ops import grouped_mlp as gm
from scaletorch_tpu_torch.parallel.expert_parallel import (
    expert_capacity,
    moe_mlp,
    slot_fill_counts_indexed,
    sorted_moe_forward,
    top_k_routing_indexed,
)
from scaletorch_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_ref,
    paged_gather_kv,
)
from scaletorch_tpu_torch.data.dataloader import SyntheticDataLoader
from scaletorch_tpu_torch.data.dataset import (
    DatasetProcessor,
    chunks_to_array,
)
from scaletorch_tpu_torch.models.convert import flatten_params
from scaletorch_tpu_torch.resilience import PreemptionHandler
from scaletorch_tpu_torch.resilience_distributed import (
    WATCHDOG_EXIT_CODE,
    HangWatchdog,
)
from scaletorch_tpu_torch.telemetry import (
    SpanTracer,
    TelemetryExporter,
    load_trace,
    read_jsonl,
)
from scaletorch_tpu_torch.trainer.optimizer import tree_leaves
from scaletorch_tpu_torch.trainer.train_step import make_loss_fn
from scaletorch_tpu_torch.trainer.trainer import Trainer, build_model_config
from scaletorch_tpu_torch.utils import hf_interop
from scaletorch_tpu_torch.utils.device import card_name_and_power_limit

MODEL = "qwen3-0.6b"
# the presets' other head geometries: n_rep 5 at D 128, D 32 at n_rep 2
GEOMETRY_MODELS = ("qwen3-14b", "dense-tiny")
GEOMETRY_SEQ = 2048  # K1-K3 at those heads
# the long-context example's attention (Hq, Hkv, D) and sequence; K1-K3
# causal at one device's heads and at one Ulysses cp4 rank's
LONGCTX_HEADS, LONGCTX_SEQ = (4, 4, 16), 2048
LONGCTX_FLASH_ROWS = (("longctx_heads", 4), ("longctx_ulysses_rank", 1))
GEOMETRY_PARITY_LAYERS = 2  # the qwen3-14b decode-parity cut
# the analyzer's inference audit entries (a Llama of hidden 64, 4 query
# over 2 KV heads of D 16): b 2, s_max 32, pages of 8; the positions put
# one slot across a page boundary and the other on its last key
AUDIT_HEADS, AUDIT_SLOTS, AUDIT_MAX_SEQ, AUDIT_PAGE = (4, 2, 16), 2, 32, 8
AUDIT_POSITIONS = [13, 31]
# H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 / fp32 flop/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# serving shapes of the paged engine at Qwen3-0.6B width
SLOTS, PAGE_SIZE, MAX_SEQ, PREFILL_LEN = 8, 16, 2048, 512
PAGES_PER_SLOT = MAX_SEQ // PAGE_SIZE
DECODE_GRAPH_STEPS = 16  # decode replays held to the eager step each
TOLERANCE = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# K4 vs its plain version: the worst slot's relative L2 error, which sits
# below the reading of the one-page-dropped control (bf16's max abs limit
# cannot see a dropped page among 2048 keys; phase 3 prints both). At
# 32768 keys a dropped page moves a slot by ~2%, so that row's bf16 limit
# is tighter.
DECODE_SLOT_REL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
LONG_CONTEXT = 32768  # keys of the one-slot K4 row
LONG_CONTEXT_SLOT_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# time_ms's spin: ~2 ms at the H100's ~1.98 GHz, longer than the host
# takes to enqueue any call timed here
SPIN_CYCLES = 4_000_000
PARITY_TOLERANCE = 1e-3
# the heads (Hq, Hkv, D) of one rank of qwen3-32b over tp 4
TP_MODEL = "qwen3-32b"
TP4_RANK_HEADS = (16, 2, 128)
# the heads (Hq, Hkv, D) of one rank of Qwen3-30B-A3B served over tp 4;
# over tp 2 (serve_moe_ep4's tp 2 x ep 2) a rank's are TP4_RANK_HEADS
MOE_TP4_RANK_HEADS = (8, 1, 128)
# the bench headline row: qwen3-0.6b, seq 8192, micro-batch 1, GC
TRAIN_SEQ = 8192
TRAIN_WARMUP, TRAIN_STEPS, PROFILE_STEPS = 2, 5, 2
# train_table: each row of the single-chip table, 2 warm-up + 3 timed
TABLE_WARMUP, TABLE_STEPS = 2, 3
# data_train: documents of DOC_BYTES bytes (a byte a token): 32 sequences
# of 8193 tokens to train on, 4 held out; runs of DATA_STEPS steps
DATA_DOCS, EVAL_DOCS, DOC_BYTES, DATA_STEPS = 64, 8, 4096, 4
# the depth of the headline row in the data, checkpoint and runtime drills
# (data_train, runtime_preempt, runtime_rollback, runtime_multiproc): the
# drills hold runs to each other, so depth changes no assert; 28 -> 8
# layers cuts their steps and their checkpoints (7.15 -> ~3.3 GB)
DRILL_LAYERS = 8
# and a 32 MiB corpus tokenized alone, for the preprocessing rate
PREP_DOCS = 8192
# hf_roundtrip: the bf16 export (1.19 GB at 0.6B) cut into >= 2 shards
HF_SHARD_BYTES = 512 * 1024 ** 2
# kernel vs plain version, on each of out, lse, dQ, dK, dV: max abs, the
# relative L2 error of the whole tensor ("rel"), and the largest relative
# L2 error of one TILE-row tile of one head ("tile_rel": a fault confined
# to one tile, which the whole tensor's norm dilutes, shows there). Each
# limit sits above the sound kernels' reading and below the reading of a
# kernel that skips one tile (phase 4 prints both, and a lower-precision
# control beside them).
TILE = 64
FLASH_TOLERANCE = {
    torch.float32: {"out_max_abs": 2e-5, "lse_max_abs": 1e-4,
                    "out_rel": 1e-5, "grad_rel": 1e-5,
                    "out_tile_rel": 1e-4, "grad_tile_rel": 1e-4},
    torch.bfloat16: {"out_max_abs": 2e-2, "lse_max_abs": 1e-4,
                     "out_rel": 3e-3, "grad_rel": 1e-3,
                     "out_tile_rel": 1e-2, "grad_tile_rel": 1.5e-3},
}
# flash vs sdpa through the whole fp32 model: two attention algorithms,
# the same function; fp32 rounding across 28 layers
TRAIN_PARITY = {"loss_abs": 1e-4, "grad_rel": 1e-3}

TPU_KERNELS = [
    ("K1", "_fwd_kernel", "scaletorch_tpu/ops/pallas/flash.py:76"),
    ("K2", "_dq_kernel", "scaletorch_tpu/ops/pallas/flash.py:181"),
    ("K3", "_dkv_kernel", "scaletorch_tpu/ops/pallas/flash.py:223"),
    ("K4", "_paged_decode_kernel",
     "scaletorch_tpu/ops/pallas/paged_attention.py:131"),
    ("K5", "_kernel", "scaletorch_tpu/ops/pallas/grouped_mlp.py:72"),
    ("K6", "_dx_kernel", "scaletorch_tpu/ops/pallas/grouped_mlp.py:132"),
    ("K7", "_dw_kernel", "scaletorch_tpu/ops/pallas/grouped_mlp.py:162"),
]
PORTED = {
    "K1": {"name": tf.K1_NAME, "route": "cuda",
           "source": "scaletorch_tpu_torch/csrc/flash_fwd.cu"},
    "K2": {"name": tf.K2_NAME, "route": "cuda",
           "source": "scaletorch_tpu_torch/csrc/flash_bwd.cu"},
    "K3": {"name": tf.K3_NAME, "route": "cuda",
           "source": "scaletorch_tpu_torch/csrc/flash_bwd.cu"},
    "K4": {"name": "paged_decode", "route": "cuda",
           "source": "scaletorch_tpu_torch/csrc/paged_decode.cu"},
    "K5": {"name": gm.K5_NAME, "route": "cuda",
           "source": "scaletorch_tpu_torch/csrc/grouped_mlp_fwd.cu"},
    "K6": {"name": gm.K6_NAME, "route": "cuda",
           "source": "scaletorch_tpu_torch/csrc/grouped_mlp_bwd.cu"},
    "K7": {"name": gm.K7_NAME, "route": "cuda",
           "source": "scaletorch_tpu_torch/csrc/grouped_mlp_bwd.cu"},
}
# the pass that computes _block_grads once for K6 and K7 (the TPU kernels
# each recompute it): a launch of its own on the main path
GRADS_PASS = {"name": gm.GRADS_NAME, "route": "cuda",
              "source": "scaletorch_tpu_torch/csrc/grouped_mlp_bwd.cu",
              "replaces": "scaletorch_tpu/ops/pallas/grouped_mlp.py:110"}

# ---- Qwen3-30B-A3B ---------------------------------------------------------------
MOE_MODEL = "qwen3-30b-a3b"
DROPLESS_CF = 16.0  # E / k: every (token, choice) keeps its slot
MOE_TRAIN_SEQ, MOE_TRAIN_LAYERS = 4096, 4
MOE_DECODE_PARITY_LAYERS, MOE_TRAIN_PARITY_LAYERS = 4, 2
# K5-K7 vs plain versions: the relative L2 error of the whole tensor
# ("rel"), of its worst 64-row slot tile of one (expert, group) for out
# and dx or of its worst expert for dW ("tile_rel"), and the max abs
# error over the tensor's largest magnitude ("max_abs_rel", coarse).
# Each limit sits above the sound kernels' reading and below the readings
# of the controls (phase 11 prints all three).
GMLP_TOLERANCE = {
    torch.float32: {"max_abs_rel": 1e-5, "rel": 1e-5, "tile_rel": 1e-4},
    torch.bfloat16: {"max_abs_rel": 1e-2, "rel": 3e-3, "tile_rel": 1e-2},
}
GMLP_SHAPES = {  # name: (groups, tokens per group, capacity factor, bwd)
    "train": (1, MOE_TRAIN_SEQ, 1.25, True),
    "prefill": (8, PREFILL_LEN, DROPLESS_CF, False),
    "decode": (8, 1, DROPLESS_CF, False),
    # the moe example (examples/moe) at its defaults on one card: seq 256,
    # capacity factor 2.0
    "moe_example": (1, 256, 2.0, True),
}
# (experts, top-k, H, I) of a shape that is not Qwen3-30B-A3B's
GMLP_SHAPE_DIMS = {"moe_example": (8, 2, 64, 64)}
# the exchanged slabs of the train cell under ep 4: rank 0's 32 experts
# over (source rank, group), [E/ep, ep·G, C, H] = [32, 4, 320, 2048]
EP_SLAB_RANKS = 4
EP_SHAPE = "ep4_train"
# the decode's and the prefill's slabs on rank 0 of a serving mesh, name:
# (GMLP_SHAPES step, ep, tp): its E/ep experts with the counts of the rows
# routed to them (no exchange: every rank holds every row) and its I/tp
# slice of each
GMLP_SERVE_SLABS = {"decode_ep4": ("decode", 4, 1),
                    "decode_tp2_ep2": ("decode", 2, 2),
                    "decode_tp4": ("decode", 1, 4),
                    "prefill_ep4": ("prefill", 4, 1),
                    "prefill_tp2_ep2": ("prefill", 2, 2)}
# kernels on vs the einsum path through the whole fp32 model (the
# limits of the flash vs sdpa training parity)
MOE_TRAIN_PARITY = {"loss_abs": 1e-4, "grad_rel": 1e-3}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, flush: torch.Tensor, reps: int = 20,
            spin: bool = False) -> float:
    """Median time of one call, each call timed alone with CUDA events
    after a write of ``flush`` (larger than the 50 MB L2), so every call
    finds its inputs cold, as a decode step's layer does. The span holds
    whatever part of the host's enqueue of the call outlasts the flush.
    With ``spin`` the card spins (``torch.cuda._sleep``) after the
    flush, so the call is enqueued before the start event and the span
    is the card's work alone."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def host_us(fn, calls: int = 100, reps: int = 5) -> float:
    """Median host µs per call over ``reps`` runs of ``calls`` calls back
    to back: the card queues them, nothing waits for it."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return statistics.median(runs)


# ---- 1. device --------------------------------------------------------------
def phase_device() -> dict:
    smi = card_name_and_power_limit()
    check(smi is not None, "nvidia-smi is missing")
    info = {"nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit("device", **info)
    return info


# ---- 2. build ---------------------------------------------------------------
def phase_build() -> None:
    t0 = time.monotonic()
    seconds = _build.build()
    resources = _build.build_resources()
    emit("build", sources=list(_build.KERNEL_SOURCES),
         compile_s=seconds, seconds=time.monotonic() - t0,
         build_dir=str(_build.BUILD_DIR), resources=resources)
    # the mma.sync kernels keep their accumulators in registers: no spill
    # and no stack frame (an array indexed at run time lands there)
    local = [f"{src}: {kernel} {res}" for src, kernels in resources.items()
             for kernel, res in kernels.items()
             if "mma" in kernel and any(res.get(key, 0) for key in (
                 "stack_frame", "spill_stores", "spill_loads"))]
    check(not local, f"tensor-core kernels use local memory: {local}")


# ---- 3. the paged-decode kernel against its plain version --------------------
def decode_inputs(dtype: torch.dtype, seed: int, model: str = MODEL,
                  slots: int = SLOTS, max_seq: int = MAX_SEQ,
                  positions=None, heads=None, page_size: int = PAGE_SIZE):
    """Serving-shaped inputs at ``model``'s heads (``heads``: (Hq, Hkv,
    D) instead, e.g. one tensor-parallel rank's): shuffled physical
    pages of ``page_size``, ``max_seq // page_size`` per slot; positions
    that include 0, both sides of a page boundary and the last position
    (``positions`` replaces them)."""
    cfg = model_config(model)
    b, hq, hkv = slots, cfg.num_attention_heads, cfg.num_key_value_heads
    d = cfg.actual_head_dim
    if heads is not None:
        hq, hkv, d = heads
    pages = max_seq // page_size
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n_pages = b * pages + 1
    pool_k = torch.randn(n_pages, hkv, page_size, d, generator=gen,
                         device=dev).to(dtype)
    pool_v = torch.randn(n_pages, hkv, page_size, d, generator=gen,
                         device=dev).to(dtype)
    q = torch.randn(b, hq, d, generator=gen, device=dev).to(dtype)
    tables = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1)
    tables = tables.to(torch.int32).view(b, pages).contiguous()
    if positions is None:
        rest = torch.randint(1, max_seq, (b - 4,), generator=gen, device=dev)
        positions = torch.cat([
            torch.tensor([0, page_size - 1, page_size, max_seq - 1],
                         device=dev), rest])
    positions = torch.as_tensor(positions, device=dev).to(torch.int32)
    return q, pool_k, pool_v, tables, positions


def decode_bound_ms(q, pool_k, positions) -> float:
    """The least time for the function on these inputs: the larger of its
    bytes (q, the visible K and V rows, their table entries, positions,
    the output) over HBM bandwidth and its flops over the dtype's peak."""
    b, hq, d = q.shape
    hkv, page_size = pool_k.shape[1], pool_k.shape[2]
    keys = int((positions.long() + 1).sum())
    elem = q.element_size()
    kv_bytes = 2 * keys * hkv * d * elem
    table_bytes = 4 * int(((positions.long() // page_size) + 1).sum())
    nbytes = 2 * q.numel() * elem + kv_bytes + table_bytes + 4 * b
    flops = 4 * hq * d * keys  # q.k and p.v
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[q.dtype])


def library_attention(q, pool_k, pool_v, tables, positions):
    """Yardstick only, never called by the port: gather the pages and run
    PyTorch's fused scaled_dot_product_attention with GQA."""
    k = paged_gather_kv(pool_k, tables)
    v = paged_gather_kv(pool_v, tables)
    visible = (torch.arange(k.shape[2], device=q.device)[None, :]
               <= positions[:, None].long())
    out = F.scaled_dot_product_attention(
        q[:, :, None, :], k, v, attn_mask=visible[:, None, None, :],
        enable_gqa=True)
    return out[:, :, 0, :]


def slot_rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest relative L2 error of one slot's output [Hq, D]: a fault
    confined to one slot, which the batch's max abs can miss, shows here."""
    diff = (a.float() - b.float()).flatten(1).norm(dim=1)
    return float((diff / b.float().flatten(1).norm(dim=1)).max())


def drop_one_page(tables, positions, page_size: int = PAGE_SIZE):
    """The control's inputs: the longest slot without its middle live page
    (its later pages move up one, its position falls by a page), so the
    plain version on them attends every key but that page's."""
    slot = int(positions.argmax())
    pos = int(positions[slot])
    drop = (pos // page_size + 1) // 2
    tables, positions = tables.clone(), positions.clone()
    row = tables[slot]
    row[drop:-1] = row[drop + 1:].clone()
    positions[slot] = pos - page_size
    return tables, positions


def decode_row(inputs, flush, slot_rel_limits=DECODE_SLOT_REL) -> dict:
    """K4 against its plain version on ``inputs``: max abs and worst-slot
    relative error, beside the one-page-dropped control's readings; two
    calls bit for bit; the kernel's time (also with the host's enqueue
    kept out of the span), the wrapper's host µs per call, the plain
    version's and the library's time, and the bound."""
    q, pool_k, pool_v, tables, positions = inputs
    dtype = q.dtype
    out = paged_decode_attention(*inputs)
    again = paged_decode_attention(*inputs)
    ref = paged_decode_attention_ref(*inputs)
    dropped = paged_decode_attention_ref(
        q, pool_k, pool_v, *drop_one_page(tables, positions,
                                          pool_k.shape[2]))
    lib = library_attention(*inputs)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"{dtype}: non-finite output")
    check(torch.equal(out, again), f"{dtype}: two calls differ")

    def kernel():
        return paged_decode_attention(*inputs)

    row = {
        "dtype": str(dtype).replace("torch.", ""),
        "shape": {"q": list(q.shape), "pool": list(pool_k.shape),
                  "page_tables": list(tables.shape)},
        "n_rep": q.shape[1] // pool_k.shape[1],
        "max_abs_err": max_abs(out, ref), "tolerance": TOLERANCE[dtype],
        "slot_rel_err": slot_rel_max(out, ref),
        "slot_rel_tolerance": slot_rel_limits[dtype],
        "control_one_page_dropped": {
            "max_abs_err": max_abs(out, dropped),
            "slot_rel_err": slot_rel_max(out, dropped)},
        "library_max_abs_err": max_abs(lib, ref),
        "two_calls_equal": True,
        "kernel_ms": time_ms(kernel, flush),
        "kernel_ms_spin": time_ms(kernel, flush, spin=True),
        "host_us": host_us(kernel),
        "plain_ms": time_ms(lambda: paged_decode_attention_ref(*inputs),
                            flush),
        "library_ms": time_ms(lambda: library_attention(*inputs), flush),
        "bound_ms": decode_bound_ms(q, pool_k, positions),
        "bound_by": "bytes",
    }
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    row["bound_share_spin"] = row["bound_ms"] / row["kernel_ms_spin"]
    return row


def check_decode_row(row: dict, what: str) -> None:
    check(row["max_abs_err"] <= row["tolerance"],
          f"{what}: kernel vs plain max abs {row['max_abs_err']} > "
          f"{row['tolerance']}")
    check(row["slot_rel_err"] <= row["slot_rel_tolerance"],
          f"{what}: kernel vs plain worst slot rel {row['slot_rel_err']} > "
          f"{row['slot_rel_tolerance']}")
    control = row["control_one_page_dropped"]
    check(control["max_abs_err"] > row["tolerance"]
          or control["slot_rel_err"] > row["slot_rel_tolerance"],
          f"{what}: the one-page-dropped control passes the checks "
          f"{control}")


def phase_kernel() -> dict:
    """The serving shape of Qwen3-0.6B, then Qwen3-30B-A3B's heads (n_rep
    8), one tp4 rank of qwen3-32b (Hq 16, Hkv 2, n_rep 8), one slot at
    32768 keys, GPT-MoE's heads (Hq 4, Hkv 4, D 32, up to 256 keys), one
    rank of Qwen3-30B-A3B over tp 4 (Hq 8, Hkv 1; over tp 2 its rank's
    heads are the tp4 rank of qwen3-32b's), one rank of GPT-MoE over tp 2
    (Hq 2, Hkv 2) and tp 4 (Hq 1, Hkv 1), qwen3-14b's heads (n_rep 5)
    and dense-tiny's (D 32). On each of the first eight, a control: the
    plain version with one page of the longest slot dropped must fail the
    checks (both readings are printed)."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        inputs = decode_inputs(dtype, seed=1234)
        row = decode_row(inputs, flush)
        row["positions"] = inputs[4].tolist()
        check_decode_row(row, str(dtype))
        row["rows"] = {
            "qwen3_30b_a3b_heads": decode_row(
                decode_inputs(dtype, seed=1236, model=MOE_MODEL), flush),
            # one rank of qwen3-32b served over tp4 (serve_tp4)
            "qwen3_32b_tp4_rank_heads": decode_row(
                decode_inputs(dtype, seed=1238, heads=TP4_RANK_HEADS),
                flush),
            "b1_32768_keys": decode_row(
                decode_inputs(dtype, seed=1237, slots=1,
                              max_seq=LONG_CONTEXT,
                              positions=[LONG_CONTEXT - 1]), flush,
                LONG_CONTEXT_SLOT_REL),
            # GPT-MoE's decode (gpt_moe_serve): n_rep 1, D 32, 256 keys
            "gpt_moe_heads": decode_row(
                decode_inputs(dtype, seed=1239, heads=GPT_HEADS,
                              max_seq=GPT_MAX_SEQ), flush),
            # one rank of Qwen3-30B-A3B served over tp 4 (over tp 2 its
            # heads are qwen3-32b's tp4 rank's)
            "qwen3_30b_a3b_tp4_rank_heads": decode_row(
                decode_inputs(dtype, seed=1244, heads=MOE_TP4_RANK_HEADS),
                flush),
            # one rank of GPT-MoE served over tp 2 and tp 4
            # (serve_gpt_moe_tp): n_rep 1, D 32, 256 keys
            **{f"gpt_moe_tp{tp}_rank_heads": decode_row(
                decode_inputs(dtype, seed=1245 + tp, heads=heads,
                              max_seq=GPT_MAX_SEQ), flush)
               for tp, heads in GPT_TP_RANK_HEADS.items()},
            # the analyzer's inference audit entries (D 16, pages of 8):
            # their geometry, then 8 slots of 4096 keys at the same heads
            "audit_d16": decode_row(
                decode_inputs(dtype, seed=1250, heads=AUDIT_HEADS,
                              slots=AUDIT_SLOTS, max_seq=AUDIT_MAX_SEQ,
                              positions=AUDIT_POSITIONS,
                              page_size=AUDIT_PAGE), flush),
            "d16_8x4096": decode_row(
                decode_inputs(dtype, seed=1251, heads=AUDIT_HEADS,
                              max_seq=4096, page_size=AUDIT_PAGE), flush),
        }
        row["geometries"] = {m: paged_geometry(m, dtype, flush)
                             for m in GEOMETRY_MODELS}
        results[row["dtype"]] = row
        emit("kernel_paged_decode", **row)
        for name, r in row["rows"].items():
            check_decode_row(r, f"{dtype} {name}")
        for m, g in row["geometries"].items():
            check(g["max_abs_err"] <= TOLERANCE[dtype],
                  f"{dtype} {m}: kernel vs plain max abs "
                  f"{g['max_abs_err']} > {TOLERANCE[dtype]}")
    return results


def paged_geometry(model: str, dtype: torch.dtype, flush) -> dict:
    """K4 against its plain version at another preset's heads."""
    inputs = decode_inputs(dtype, seed=1235, model=model)
    q, pool_k, _, _, positions = inputs
    out = paged_decode_attention(*inputs)
    ref = paged_decode_attention_ref(*inputs)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"{dtype} {model}: non-finite")
    kernel_ms = time_ms(lambda: paged_decode_attention(*inputs), flush)
    bound = decode_bound_ms(q, pool_k, positions)
    return {"q": list(q.shape), "pool": list(pool_k.shape),
            "n_rep": q.shape[1] // pool_k.shape[1],
            "max_abs_err": max_abs(out, ref), "kernel_ms": kernel_ms,
            "kernel_ms_spin": time_ms(
                lambda: paged_decode_attention(*inputs), flush, spin=True),
            "bound_ms": bound, "bound_share": bound / kernel_ms}


# ---- the analyzer: its AST tiers over the port, its deep and memory tiers -----
ANALYSIS_DIR = os.path.join("build", "analysis")
ANALYSIS_TIMEOUT_S = 600
# kernel launches of one call of each audit entry: K4 once a layer in the
# paged decode steps (2 layers); K1-K3 once a layer a microbatch in the
# train entries (2 layers x 2 microbatches, no checkpointing; rank 0 of
# the spmd entry's contiguous cp2 ring computes one block a layer); the
# dense and prefill steps run no kernel (the gather path and SDPA)
AUDIT_K4 = {"paged_decode": 2}
AUDIT_TRAIN = {tf.K1_NAME: 4, tf.K2_NAME: 4, tf.K3_NAME: 4}
AUDIT_LAUNCHES = {
    "spmd_train_step": AUDIT_TRAIN, "declarative_train_step": AUDIT_TRAIN,
    "prefill_step": {}, "decode_step": {}, "paged_decode_step": AUDIT_K4,
    "disagg_prefill_slice": {}, "disagg_decode_slice": AUDIT_K4,
}


def analyzer(*args: str) -> subprocess.Popen:
    """``python -m scaletorch_tpu_torch.analysis ARGS``, its output to
    build/analysis/<tier>.log."""
    name = args[args.index("--tier") + 1] if "--tier" in args else "ast"
    log = open(os.path.join(ANALYSIS_DIR, f"{name}.log"), "w")
    return subprocess.Popen(
        [sys.executable, "-m", "scaletorch_tpu_torch.analysis", *args],
        stdout=log, stderr=subprocess.STDOUT)


def phase_analysis() -> dict:
    """The port's analyzer, three processes started together: the AST
    tier and the ownership tier over the whole port (exit 0 against its
    baseline), and the deep and memory tiers on the card over the seven
    audit entries (the mesh entries under the fake process group),
    exit 0 against the checked-in comm and memory budgets. Each entry's
    peak MB (the card's allocator) and kernel launches are printed and
    held to AUDIT_LAUNCHES; then plan_slice_split from the card's slice
    rows (the two slice programs at the served width)."""
    from scaletorch_tpu_torch.inference.disagg import (
        DEFAULT_HBM_BUDGET,
        plan_slice_split,
    )

    os.makedirs(ANALYSIS_DIR, exist_ok=True)
    report = os.path.join(ANALYSIS_DIR, "report.json")
    t0 = time.monotonic()
    procs = {"ast": analyzer("scaletorch_tpu_torch"),
             "ownership": analyzer("scaletorch_tpu_torch", "--tier",
                                   "ownership"),
             "deep_memory": analyzer("scaletorch_tpu_torch", "--tier",
                                     "deep,memory", "--report", report)}
    rcs, seconds = {}, {}
    for name, proc in procs.items():
        try:
            rcs[name] = proc.wait(timeout=ANALYSIS_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            rcs[name] = proc.wait()
        seconds[name] = time.monotonic() - t0
    logs = {name: open(os.path.join(
        ANALYSIS_DIR, f"{'deep,memory' if name == 'deep_memory' else name}"
        ".log")).read()[-2000:] for name in procs}
    for name, rc in rcs.items():
        check(rc == 0, f"analysis {name}: exit {rc}\n{logs[name]}")
    with open(report) as f:
        entries = json.load(f)
    rows = {name: {"peak_mb": e["memory"]["peak_mb"],
                   "temp_mb": e["memory"]["temp_mb"],
                   "source": e["memory"]["source"],
                   "launches": e["launches"], "seconds": e["seconds"],
                   "collectives": e["collectives"]}
            for name, e in entries.items()}
    for name, want in AUDIT_LAUNCHES.items():
        check(name in rows, f"analysis: no report of entry {name}")
        check(rows[name]["source"] == "cuda",
              f"analysis {name}: memory from {rows[name]['source']}")
        check(rows[name]["launches"] == want,
              f"analysis {name}: launches {rows[name]['launches']} != "
              f"{want}")
    # the rows plan_slice_split reads: the two slice programs at the
    # served width, measured on the card when the budget was written
    with open(DEFAULT_HBM_BUDGET) as f:
        slices = json.load(f).get("slices", {})
    check(sorted(slices) == ["disagg_decode_slice", "disagg_prefill_slice"]
          and all(r["source"] == "cuda" for r in slices.values()),
          f"analysis: the budget's slice rows are not the card's: {slices}")
    split = {n: list(plan_slice_split(n)) for n in (2, 8)}
    out = {"rcs": rcs, "seconds": seconds, "entries": rows,
           "slices": {name: {k: r[k] for k in (
               "peak_mb", "argument_mb", "temp_mb", "model", "max_slots",
               "max_seq", "prefill_len", "page_size")}
               for name, r in slices.items()},
           "plan_slice_split": split, "summary": {
               name: logs[name].strip().splitlines()[-1]
               for name in procs},
           "nvidia_smi": card_name_and_power_limit()}
    emit("analysis", **out)
    return out


# ---- 4. the flash kernels against their plain versions -----------------------
def flash_inputs(dtype: torch.dtype, seed: int, model: str = MODEL,
                 seq: int = TRAIN_SEQ):
    """q, k, v, dO at the training shape of ``model``'s cell."""
    cfg = model_config(model)
    hq, hkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.actual_head_dim)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rnd(heads):
        return torch.randn(1, heads, seq, d, generator=gen,
                           device="cuda").to(dtype)

    return rnd(hq), rnd(hkv), rnd(hkv), rnd(hq)


def flash_work(kernel: str, q, k, causal: bool = True):
    """(flops, bytes) of one call: 2 flops per multiply-add of its
    products over the visible (query, key) pairs (causal: Sq == Skv, the
    lower triangle; full: every pair); each input read once, each output
    written once."""
    b, hq, s, d = q.shape
    skv = k.shape[2]
    elem = q.element_size()
    q_bytes = b * hq * s * d * elem
    kv_bytes = b * k.shape[1] * skv * d * elem
    row_bytes = 4 * b * hq * s  # one fp32 per query row: lse or delta
    pairs = (b * hq * s * (s + 1) // 2 if causal else b * hq * s * skv)
    return {
        # O, LSE from Q, K, V: Q K^T and P V
        "K1": (4 * d * pairs, 2 * q_bytes + 2 * kv_bytes + row_bytes),
        # dQ from Q, K, V, dO, LSE, delta: Q K^T, dO V^T, dS K
        "K2": (6 * d * pairs, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes),
        # dK, dV from the same: Q K^T, dO V^T, P^T dO, dS^T Q
        "K3": (8 * d * pairs, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),
    }[kernel]


def flash_timing(kid: str, q, k, kernel_ms: float,
                 causal: bool = True) -> dict:
    """One call's time beside its bound (the larger of its bytes over HBM
    bandwidth and its flops over the dtype's peak), what bounds it, the
    share of the bound the kernel reaches and its TFLOP/s."""
    flops, nbytes = flash_work(kid, q, k, causal)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    bound_ms = 1e3 * max(t_bytes, t_ops)
    return {"kernel_ms": kernel_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_share": bound_ms / kernel_ms,
            "tflops": flops / kernel_ms / 1e9}


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def tile_rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest relative L2 error of one TILE-row tile of one head of
    [B, H, S, D] tensors (a ragged last tile is padded with zeros)."""
    batch, heads, seq, _ = b.shape

    def per_tile(x):
        rows = x.float().square().sum(-1)
        rows = F.pad(rows, (0, (-seq) % TILE))
        return rows.view(batch, heads, -1, TILE).sum(-1)

    return float((per_tile(a.float() - b.float()) / per_tile(b)).sqrt().max())


def flash_plain(q, k, v, dout, lse, delta, causal: bool = True):
    """(out, lse, dQ, dK, dV) of the plain versions."""
    out, out_lse = tf.flash_forward_ref(q, k, v, causal=causal)
    dq = tf.flash_dq_ref(q, k, v, dout, lse, delta, causal=causal)
    dk, dv = tf.flash_dkv_ref(q, k, v, dout, lse, delta, causal=causal)
    return out, out_lse, dq, dk, dv


def flash_errors(got, ref) -> dict:
    """Every reading of (out, lse, dQ, dK, dV) ``got`` against ``ref``."""
    errs = {"lse_max_abs": max_abs(got[1], ref[1])}
    for name, a, b in zip(("out", "dq", "dk", "dv"), got[:1] + got[2:],
                          ref[:1] + ref[2:]):
        errs[f"{name}_max_abs"] = max_abs(a, b)
        errs[f"{name}_rel"] = rel_err(a, b)
        errs[f"{name}_tile_rel"] = tile_rel_max(a, b)
    return errs


def flash_violations(errs: dict, tol: dict) -> list:
    """The readings over their limits, as text (empty when all hold)."""
    limits = {"out_max_abs": tol["out_max_abs"],
              "lse_max_abs": tol["lse_max_abs"], "out_rel": tol["out_rel"]}
    limits["out_tile_rel"] = tol["out_tile_rel"]
    for name in ("dq", "dk", "dv"):
        limits[f"{name}_rel"] = tol["grad_rel"]
        limits[f"{name}_tile_rel"] = tol["grad_tile_rel"]
    return [f"{key} {errs[key]} > {limit}" for key, limit in limits.items()
            if not errs[key] <= limit]


def skip_one_tile(got, q, k, v, dout, lse, delta, scale: float):
    """``got`` (out, lse, dQ, dK, dV) as kernels that skip one tile would
    give it: q head 0's last query tile against key tile 0, where a skip is
    hardest to see (64 of those rows' 8192 keys, 64 of those keys' 8192
    queries), is left out of out (renormalised), dQ, dK and dV."""
    out, out_lse, dq, dk, dv = (t.clone() for t in got)
    seq = q.shape[2]
    rows, cols = slice(seq - TILE, seq), slice(0, TILE)
    qb, dob = q[0, 0, rows].float(), dout[0, 0, rows].float()
    kb, vb = k[0, 0, cols].float(), v[0, 0, cols].float()
    p = torch.exp(qb @ kb.T * scale - lse[0, 0, rows, None])
    ds = p * (dob @ vb.T - delta[0, 0, rows, None]) * scale
    kept = out[0, 0, rows].float() - p @ vb
    out[0, 0, rows] = (kept / (1 - p.sum(-1, keepdim=True))).to(out.dtype)
    dq[0, 0, rows] = (dq[0, 0, rows].float() - ds @ kb).to(dq.dtype)
    dk[0, 0, cols] = (dk[0, 0, cols].float() - ds.T @ qb).to(dk.dtype)
    dv[0, 0, cols] = (dv[0, 0, cols].float() - p.T @ dob).to(dv.dtype)
    return out, out_lse, dq, dk, dv


def lower_precision(q, k, v, dout, lse, delta):
    """The plain versions one step less precise than the kernels: fp32
    with its products in TF32; bf16 with p and dS left unrounded (fp32
    throughout, outputs rounded to bf16)."""
    if q.dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return flash_plain(q, k, v, dout, lse, delta)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    wide = [t.float() for t in (q, k, v, dout)]
    out, out_lse, dq, dk, dv = flash_plain(*wide, lse, delta)
    return (out.to(q.dtype), out_lse, dq.to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def phase_kernel_flash() -> dict:
    """K1-K3 against their plain versions at the headline's training
    shape (``flash_case``; bf16 also at the MoE shape), at other presets'
    heads, and at the long-context example's heads of 16
    (``LONGCTX_HEADS``: [1, 4, 2048, 16], one device's, and [1, 1, 2048,
    16], one rank's under Ulysses cp4), fp32 and bf16."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        row = flash_case(*flash_inputs(dtype, seed=4321), flush,
                         f"{dtype}")
        if dtype == torch.bfloat16:
            row["moe_shape"] = flash_moe_shape(flush, 5)
        row["geometries"] = {m: flash_geometry(m, dtype)
                             for m in GEOMETRY_MODELS}
        row["longctx_d16"] = {
            name: flash_case(*longctx_inputs(dtype, hq, seed=4331 + hq),
                             flush, f"{dtype} {name}")
            for name, hq in LONGCTX_FLASH_ROWS}
        results[row["dtype"]] = row
        emit("kernel_flash", **row)
        if "moe_shape" in row:
            check(not row["moe_shape"]["over_limit"],
                  f"{dtype}: K1-K3 vs plain at the MoE shape: "
                  f"{row['moe_shape']['over_limit']}")
        for m, g in row["geometries"].items():
            check(not g["over_limit"],
                  f"{dtype}: K1-K3 vs plain at {m}'s heads: "
                  f"{g['over_limit']}")
    return results


def longctx_inputs(dtype: torch.dtype, hq: int, seed: int,
                   seq: int = LONGCTX_SEQ):
    """q, k, v, dO of the long-context example's attention: ``hq`` heads
    (and as many KV heads) of LONGCTX_HEADS' D, B 1."""
    d = LONGCTX_HEADS[2]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rnd():
        return torch.randn(1, hq, seq, d, generator=gen,
                           device="cuda").to(dtype)

    return rnd(), rnd(), rnd(), rnd()


def flash_case(q, k, v, dout, flush, what: str, reps: int = 5) -> dict:
    """Causal K1, K2 and K3 on (q, k, v, dO) against their plain versions
    under FLASH_TOLERANCE, with the skipped-tile control that must fail
    the tile checks and the lower-precision control; each kernel's time
    beside its bound, its plain version's and SDPA's (forward; backward
    for K2 and K3); two runs of K2/K3 bit for bit. Checked here."""
    dtype = q.dtype
    tol = FLASH_TOLERANCE[dtype]
    scale = 1.0 / q.shape[-1] ** 0.5
    out, lse = tf.flash_forward(q, k, v, causal=True)
    ref_out, ref_lse = tf.flash_forward_ref(q, k, v, causal=True)
    delta = tf.attention_delta(ref_out, dout)
    bwd_args = (q, k, v, dout, ref_lse, delta)
    ref = flash_plain(*bwd_args)
    dq = tf.flash_dq(*bwd_args, causal=True)
    dk, dv = tf.flash_dkv(*bwd_args, causal=True)
    got = (out, lse, dq, dk, dv)
    lib_in = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                             enable_gqa=True)
    torch.cuda.synchronize()
    for t in got:
        check(bool(torch.isfinite(t).all()), f"{what}: non-finite")
    errs = flash_errors(got, ref)
    errs["library_out_max_abs"] = max_abs(lib_out.detach(), ref[0])
    controls = {}
    for name, faulty in (
            ("skip_one_tile",
             skip_one_tile(got, q, k, v, dout, ref[1], delta, scale)),
            ("lower_precision", lower_precision(*bwd_args))):
        c_errs = flash_errors(faulty, ref)
        controls[name] = {**c_errs,
                          "over_limit": flash_violations(c_errs, tol)}

    def lib_bwd():
        return torch.autograd.grad(lib_out, lib_in, dout, retain_graph=True)

    lib_bwd_ms = time_ms(lib_bwd, flush, reps)  # dQ, dK and dV in one call
    times = {
        "K1": (lambda: tf.flash_forward(q, k, v, causal=True),
               lambda: tf.flash_forward_ref(q, k, v, causal=True),
               time_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True, enable_gqa=True), flush, reps)),
        "K2": (lambda: tf.flash_dq(*bwd_args, causal=True),
               lambda: tf.flash_dq_ref(*bwd_args, causal=True), lib_bwd_ms),
        "K3": (lambda: tf.flash_dkv(*bwd_args, causal=True),
               lambda: tf.flash_dkv_ref(*bwd_args, causal=True),
               lib_bwd_ms),
    }
    # kernel_ms_spin: the card's work alone (time_ms's spin), which at the
    # narrow heads is a fraction of the span the wrapper's host enqueue
    # fills
    row = {"dtype": str(dtype).replace("torch.", ""),
           "shape": {"q": list(q.shape), "kv": list(k.shape)},
           "causal": True, "tolerance": tol, **errs,
           "controls": controls, "kernels": {
               kid: {**flash_timing(kid, q, k, time_ms(fn, flush, reps)),
                     "kernel_ms_spin": time_ms(fn, flush, reps, spin=True),
                     "plain_ms": time_ms(plain, flush, reps),
                     "library_ms": lib_ms}
               for kid, (fn, plain, lib_ms) in times.items()}}
    # no atomics: a second run of K2 and K3 gives the same bits
    again = (tf.flash_dq(*bwd_args, causal=True),
             *tf.flash_dkv(*bwd_args, causal=True))
    row["bitwise_deterministic"] = all(
        bool(torch.equal(a, b)) for a, b in zip(again, (dq, dk, dv)))
    del again, lib_out, lib_in
    violations = flash_violations(errs, tol)
    check(not violations, f"{what}: kernels vs plain: {violations}")
    seen = {v.split()[0] for v in controls["skip_one_tile"]["over_limit"]}
    want = {"out_tile_rel", "dq_tile_rel", "dk_tile_rel", "dv_tile_rel"}
    check(want <= seen, f"{what}: a skipped tile passes the checks of "
                        f"{sorted(want - seen)}")
    check(row["bitwise_deterministic"], f"{what}: two runs of K2 and K3 "
                                        f"differ")
    return row


def flash_geometry(model: str, dtype: torch.dtype) -> dict:
    """K1, K2 and K3 against their plain versions at another preset's
    heads (B 1, S GEOMETRY_SEQ, causal), under FLASH_TOLERANCE."""
    q, k, v, dout = flash_inputs(dtype, seed=4323, model=model,
                                 seq=GEOMETRY_SEQ)
    out, lse = tf.flash_forward(q, k, v, causal=True)
    ref_out, ref_lse = tf.flash_forward_ref(q, k, v, causal=True)
    bwd_args = (q, k, v, dout, ref_lse, tf.attention_delta(ref_out, dout))
    got = (out, lse, tf.flash_dq(*bwd_args, causal=True),
           *tf.flash_dkv(*bwd_args, causal=True))
    ref = flash_plain(*bwd_args)
    torch.cuda.synchronize()
    for t in got:
        check(bool(torch.isfinite(t).all()), f"{dtype} {model}: non-finite")
    errs = flash_errors(got, ref)
    return {"q": list(q.shape), "kv": list(k.shape), **errs,
            "over_limit": flash_violations(errs, FLASH_TOLERANCE[dtype])}


def flash_moe_shape(flush, reps: int) -> dict:
    """bf16 K1, K2 and K3 at Qwen3-30B-A3B's training shape (B 1, Hq 32,
    Hkv 4, S 4096, D 128, causal) against their plain versions, with their
    times beside the plain versions' and the SDPA forward's (K1) and
    backward's (K2, K3)."""
    tol = FLASH_TOLERANCE[torch.bfloat16]
    q, k, v, dout = flash_inputs(torch.bfloat16, seed=4322, model=MOE_MODEL,
                                 seq=MOE_TRAIN_SEQ)
    ref_out, ref_lse = tf.flash_forward_ref(q, k, v, causal=True)
    bwd_args = (q, k, v, dout, ref_lse, tf.attention_delta(ref_out, dout))
    out, lse = tf.flash_forward(q, k, v, causal=True)
    got = (tf.flash_dq(*bwd_args, causal=True),
           *tf.flash_dkv(*bwd_args, causal=True))
    ref = (tf.flash_dq_ref(*bwd_args, causal=True),
           *tf.flash_dkv_ref(*bwd_args, causal=True))
    torch.cuda.synchronize()
    row = {"shape": {"q": list(q.shape), "kv": list(k.shape)},
           "causal": True}
    check(bool(torch.isfinite(out).all() and torch.isfinite(lse).all()),
          "MoE shape: non-finite out or lse")
    row["lse_max_abs"] = max_abs(lse, ref_lse)
    row["out_max_abs"] = max_abs(out, ref_out)
    row["out_rel"] = rel_err(out, ref_out)
    row["out_tile_rel"] = tile_rel_max(out, ref_out)
    limits = {key: tol[key] for key in ("lse_max_abs", "out_max_abs",
                                        "out_rel", "out_tile_rel")}
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        check(bool(torch.isfinite(a).all()), f"MoE shape: non-finite {name}")
        row[f"{name}_max_abs"] = max_abs(a, b)
        row[f"{name}_rel"] = rel_err(a, b)
        row[f"{name}_tile_rel"] = tile_rel_max(a, b)
        limits[f"{name}_rel"] = tol["grad_rel"]
        limits[f"{name}_tile_rel"] = tol["grad_tile_rel"]
    row["over_limit"] = [f"{key} {row[key]} > {limit}"
                         for key, limit in limits.items()
                         if not row[key] <= limit]
    del out, lse, got, ref
    lib_in = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                             enable_gqa=True)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(lib_out, lib_in, dout,
                                                     retain_graph=True),
                         flush, reps)
    lib_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), flush, reps)
    calls = {
        "K1": (lambda: tf.flash_forward(q, k, v, causal=True),
               lambda: tf.flash_forward_ref(q, k, v, causal=True),
               lib_fwd_ms),
        "K2": (lambda: tf.flash_dq(*bwd_args, causal=True),
               lambda: tf.flash_dq_ref(*bwd_args, causal=True), lib_bwd_ms),
        "K3": (lambda: tf.flash_dkv(*bwd_args, causal=True),
               lambda: tf.flash_dkv_ref(*bwd_args, causal=True), lib_bwd_ms),
    }
    row["kernels"] = {
        kid: {**flash_timing(kid, q, k, time_ms(kernel, flush, reps)),
              "plain_ms": time_ms(plain, flush, reps), "library_ms": lib_ms}
        for kid, (kernel, plain, lib_ms) in calls.items()}
    return row


# ---- 4b. K1-K3 at the blocks of the cp ring -----------------------------------
# (name, Sq, Skv) of the ring's full (non-causal) blocks at the headline's
# S 8192 over cp 4: the contiguous layout's off-diagonal block, and the
# zigzag layout's older (the shard against a low stripe) and newer (the
# high stripe against a shard) blocks
RING_CP = 4
RING_BLOCKS = (("contiguous_offdiag", TRAIN_SEQ // RING_CP,
                TRAIN_SEQ // RING_CP),
               ("zigzag_older", TRAIN_SEQ // RING_CP,
                TRAIN_SEQ // (2 * RING_CP)),
               ("zigzag_newer", TRAIN_SEQ // (2 * RING_CP),
                TRAIN_SEQ // RING_CP))
# the long-context example (examples/longctx) at its defaults: seq 2048
# over cp 4, 4 heads and 4 KV heads of 16; its zigzag blocks
LONGCTX_RING_BLOCKS = (
    ("longctx_zigzag_older", LONGCTX_SEQ // RING_CP,
     LONGCTX_SEQ // (2 * RING_CP)),
    ("longctx_zigzag_newer", LONGCTX_SEQ // (2 * RING_CP),
     LONGCTX_SEQ // RING_CP))


def ring_block(name: str, sq: int, skv: int, dtype: torch.dtype, flush,
               reps: int = 5, heads=None) -> dict:
    """K1 and K2/K3 on one full block of Qwen3-0.6B's heads (``heads``:
    (Hq, Hkv, D) instead) against their plain versions under
    FLASH_TOLERANCE, beside the one-tile-skipped control that must fail
    them; each kernel's time, its plain version's, its bound and the SDPA
    yardstick on the same block."""
    tol = FLASH_TOLERANCE[dtype]
    cfg = model_config(MODEL)
    hq, hkv, d = heads or (cfg.num_attention_heads, cfg.num_key_value_heads,
                           cfg.actual_head_dim)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4325 + sq + 3 * skv)

    def rnd(heads, seq):
        return torch.randn(1, heads, seq, d, generator=gen,
                           device="cuda").to(dtype)

    q, k, v, dout = rnd(hq, sq), rnd(hkv, skv), rnd(hkv, skv), rnd(hq, sq)
    scale = 1.0 / d ** 0.5
    out, lse = tf.flash_forward(q, k, v, causal=False)
    ref_out, ref_lse = tf.flash_forward_ref(q, k, v, causal=False)
    delta = tf.attention_delta(ref_out, dout)
    bwd_args = (q, k, v, dout, ref_lse, delta)
    ref = flash_plain(*bwd_args, causal=False)
    got = (out, lse, tf.flash_dq(*bwd_args, causal=False),
           *tf.flash_dkv(*bwd_args, causal=False))
    torch.cuda.synchronize()
    for t in got:
        check(bool(torch.isfinite(t).all()), f"{name} {dtype}: non-finite")
    errs = flash_errors(got, ref)
    c_errs = flash_errors(
        skip_one_tile(got, q, k, v, dout, ref[1], delta, scale), ref)
    lib_in = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, enable_gqa=True)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, lib_in, dout, retain_graph=True), flush, reps)
    times = {
        "K1": (lambda: tf.flash_forward(q, k, v, causal=False),
               lambda: tf.flash_forward_ref(q, k, v, causal=False),
               time_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, enable_gqa=True), flush, reps)),
        "K2": (lambda: tf.flash_dq(*bwd_args, causal=False),
               lambda: tf.flash_dq_ref(*bwd_args, causal=False), lib_bwd_ms),
        "K3": (lambda: tf.flash_dkv(*bwd_args, causal=False),
               lambda: tf.flash_dkv_ref(*bwd_args, causal=False),
               lib_bwd_ms),
    }
    kernels = {kid: {**flash_timing(kid, q, k, time_ms(fn, flush, reps),
                                    causal=False),
                     "kernel_ms_spin": time_ms(fn, flush, reps, spin=True),
                     "plain_ms": time_ms(plain, flush, reps),
                     "library_ms": lib_ms}
               for kid, (fn, plain, lib_ms) in times.items()}
    return {"block": name, "dtype": str(dtype).replace("torch.", ""),
            "q": list(q.shape), "kv": list(k.shape), "causal": False,
            **errs, "over_limit": flash_violations(errs, tol),
            "control_skip_one_tile": {
                **c_errs, "over_limit": flash_violations(c_errs, tol)},
            "kernels": kernels}


def phase_kernel_ring_blocks() -> dict:
    """The headline's ring blocks (RING_BLOCKS, Qwen3-0.6B's heads) and
    the long-context example's zigzag blocks at its heads of 16
    (LONGCTX_RING_BLOCKS), fp32 and bf16."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    rows = {}
    blocks = ([(name, sq, skv, None) for name, sq, skv in RING_BLOCKS]
              + [(name, sq, skv, LONGCTX_HEADS)
                 for name, sq, skv in LONGCTX_RING_BLOCKS])
    for dtype in (torch.float32, torch.bfloat16):
        for name, sq, skv, heads in blocks:
            row = ring_block(name, sq, skv, dtype, flush, heads=heads)
            rows[(name, row["dtype"])] = row
            emit("kernel_ring_blocks", **row)
            check(not row["over_limit"],
                  f"{name} {dtype}: kernels vs plain: {row['over_limit']}")
            seen = {v.split()[0]
                    for v in row["control_skip_one_tile"]["over_limit"]}
            want = {"out_tile_rel", "dq_tile_rel", "dk_tile_rel",
                    "dv_tile_rel"}
            check(want <= seen, f"{name} {dtype}: a skipped tile passes the "
                                f"checks of {sorted(want - seen)}")
    return rows


# ---- 5. full-width decode parity, kernel vs gather path ----------------------
def phase_decode_parity() -> LlamaForCausalLM:
    cfg = model_config(MODEL, dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    model = LlamaForCausalLM.from_params(init_params(cfg, gen, "cuda"), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                           device="cuda")
    with torch.inference_mode():
        t0 = time.monotonic()
        via_kernel = teacher_forced_decode_paged(
            model, cfg, tokens, page_size=PAGE_SIZE)
        torch.cuda.synchronize()
        kernel_s = time.monotonic() - t0
        via_gather = teacher_forced_decode_paged(
            model, cfg, tokens, page_size=PAGE_SIZE, kernel=False)
        dense = teacher_forced_decode(model, cfg, tokens)
    err = float((via_kernel - via_gather).abs().max())
    check(bool(torch.isfinite(via_kernel).all()), "non-finite logits")
    check(err <= PARITY_TOLERANCE,
          f"kernel vs gather max |dlogit| {err} > {PARITY_TOLERANCE}")
    emit("decode_parity", model=MODEL, layers=cfg.num_hidden_layers,
         dtype="float32", tokens=list(tokens.shape),
         max_abs_logit_diff=err, tolerance=PARITY_TOLERANCE,
         gather_equals_dense=bool(torch.equal(via_gather, dense)),
         kernel_run_s=kernel_s)
    return model


# ---- 6. serving ---------------------------------------------------------------
def traffic(vocab: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 256).tolist()
    prompts = []
    for i in range(16):
        if i % 2 == 0:
            tail = int(rng.integers(1, 400 - 256 + 1))
            prompts.append(prefix + rng.integers(0, vocab, tail).tolist())
        else:
            n = int(rng.integers(100, 401))
            prompts.append(rng.integers(0, vocab, n).tolist())
    return prompts


def serving_engine(model, cfg, **kw) -> InferenceEngine:
    """The serve cell's engine: 8 slots, paged, prefix cache on, greedy
    unless ``kw`` says otherwise; its steps are captured here."""
    base = dict(max_slots=SLOTS, max_seq=MAX_SEQ, prefill_len=PREFILL_LEN,
                sampling=SamplingParams(temperature=0.0),
                cache_layout="paged", page_size=PAGE_SIZE,
                prefix_cache=True)
    return InferenceEngine(model, cfg, **{**base, **kw})


def check_one_capture(eng: InferenceEngine, what: str) -> dict:
    """The one-capture contract after a run: each step captured once and
    replayed once per engine step, and ``launch_counts`` (reset before the
    engine was built) equal to the capture warm-ups' launches plus each
    capture's launches once per replay, so the counts keep meaning
    launches on the card. Returns the replay counts and the launches of
    one replay of each step."""
    dec, pre = eng._decode, eng._prefill
    check(eng.decode_compile_count == 1 and eng.prefill_compile_count == 1,
          f"{what}: captured decode {eng.decode_compile_count} and prefill "
          f"{eng.prefill_compile_count} times, want 1 each")
    check(dec.replays == eng.metrics.decode_steps
          and pre.replays == eng.metrics.prefill_calls,
          f"{what}: {dec.replays} decode / {pre.replays} prefill replays "
          f"for {eng.metrics.decode_steps} / {eng.metrics.prefill_calls} "
          "steps")
    for name in set(dec.captured_launches) | set(pre.captured_launches):
        want = sum(st.warmup_launches[name]
                   + st.captured_launches[name] * st.replays
                   for st in (dec, pre))
        check(_build.launch_counts[name] == want,
              f"{what}: {name} counted {_build.launch_counts[name]} "
              f"launches, want {want} (warm-ups + per capture x replays)")
    return {"decode_compile_count": eng.decode_compile_count,
            "prefill_compile_count": eng.prefill_compile_count,
            "decode_replays": dec.replays, "prefill_replays": pre.replays,
            "decode_launches_per_replay": dict(dec.captured_launches),
            "prefill_launches_per_replay": dict(pre.captured_launches)}


def serve(model, cfg, prompts, paged_kernel, **kw):
    """The serve cell's traffic through a new engine (``kw``: more engine
    arguments): 64 new tokens a request. Returns the engine, the results
    in submission order, the pools' pointers before the run and the run's
    numbers."""
    eng = serving_engine(model, cfg, paged_kernel=paged_kernel, **kw)
    ptrs = (eng.cache.k.data_ptr(), eng.cache.v.data_ptr())
    ids = [eng.submit(p, max_new_tokens=64) for p in prompts]
    decode_tokens, decode_s = 0, 0.0
    t0 = time.monotonic()
    while eng.pending:
        prefills, emitted = eng.metrics.prefill_calls, \
            eng.metrics.tokens_generated
        ts = time.monotonic()
        eng.step()  # ends in the host copy of the sampled tokens
        if eng.metrics.prefill_calls == prefills:
            decode_s += time.monotonic() - ts
            decode_tokens += eng.metrics.tokens_generated - emitted
    wall = time.monotonic() - t0
    results = [eng.result(i) for i in ids]
    stats = {
        "wall_s": wall,
        "tokens_generated": eng.metrics.tokens_generated,
        "decode_steps": eng.metrics.decode_steps,
        "tokens_per_s": eng.metrics.tokens_generated / wall,
        "decode_tokens_per_s": decode_tokens / decode_s if decode_s else None,
        "mean_ttft_s": eng.metrics.snapshot()["mean_ttft_s"],
        "tpot_p50_s": eng.metrics.hist["tpot"].quantile(0.5),
        "prefix_hits": eng.metrics.prefix_hits,
        "prefill_tokens_saved": eng.metrics.prefill_tokens_saved,
    }
    return eng, results, ptrs, stats


def check_served(eng, results, ptrs, stats, what: str) -> list:
    outcomes = [r.outcome for r in results]
    check(all(o == "ok" for o in outcomes), f"{what}: outcomes {outcomes}")
    check(stats["prefix_hits"] > 0, f"{what}: no prefix hit")
    eng.allocator.check_conservation()
    check((eng.cache.k.data_ptr(), eng.cache.v.data_ptr()) == ptrs,
          f"{what}: the page pools moved")
    return outcomes


def agreement(tokens, ref_tokens) -> dict:
    """Greedy agreement of two runs' token lists, request by request."""
    same_req = sum(a == b for a, b in zip(tokens, ref_tokens))
    same_tok = sum(x == y for a, b in zip(tokens, ref_tokens)
                   for x, y in zip(a, b))
    return {"requests": f"{same_req}/{len(tokens)}",
            "tokens": same_tok / sum(len(t) for t in tokens)}


def free_engine() -> None:
    """Return a deleted engine's graph pools and buffers to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve(model32) -> int:
    cfg = model_config(MODEL, dtype=torch.bfloat16)
    model = LlamaForCausalLM.from_params(dict(model32.named_parameters()),
                                         cfg)
    prompts = traffic(cfg.vocab_size)
    with torch.inference_mode():
        free_engine()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        eng, results, ptrs, stats = serve(model, cfg, prompts, None)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = _build.launch_counts["paged_decode"]
        outcomes = check_served(eng, results, ptrs, stats, "serve")
        graphs = check_one_capture(eng, "serve")
        per_step = graphs["decode_launches_per_replay"].get("paged_decode")
        check(per_step == cfg.num_hidden_layers,
              f"paged_decode launched {per_step} times a decode replay, "
              f"want {cfg.num_hidden_layers}")
        del eng
        free_engine()
        _, ref_results, _, ref_stats = serve(model, cfg, prompts, False)
    emit("serve", model=MODEL, dtype="bfloat16", slots=SLOTS,
         max_seq=MAX_SEQ, prefill_len=PREFILL_LEN, page_size=PAGE_SIZE,
         requests=len(prompts), prompt_lens=[len(p) for p in prompts],
         outcomes=sorted(set(outcomes)), kernel_launches=launches,
         launches_per_decode_step=per_step, peak_memory_gb=peak_gb,
         **stats, **graphs,
         gather_path={k: ref_stats[k] for k in
                      ("wall_s", "tokens_per_s", "decode_tokens_per_s",
                       "mean_ttft_s", "tpot_p50_s", "decode_steps")},
         greedy_agreement=agreement([r.tokens for r in results],
                                    [r.tokens for r in ref_results]))
    return launches


# kernel-launch calls of the runtime and driver APIs: each leaves one
# kernel record carrying its correlation id
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx")
PROFILE_WINDOWS = 3
# calls traced after the window and left out: the trace can drop the
# records of the last kernels it sees (on an H100, part of the last decode
# replay and the two kernels launched after it)
TRAIL_STEPS = 4
WINDOW_SPAN = "chip_smoke.window"


def profiled(step, steps: int) -> dict:
    """torch.profiler over ``steps`` calls of ``step()`` (the window,
    ending in a synchronise), after one call that is traced and left out
    (the trace drops the records of the first kernels it sees: ~10
    kernels late in this script) and before TRAIL_STEPS calls that are
    traced and left out (it can drop those of the last ones): wall and
    device ms per step, the
    device's busy share (the kernels' summed device time over the
    window's wall time; one stream, so no overlap), kernel launches per
    step (inside a replayed graph too), K4's and K5's among them, and
    the top kernels. A trace that lost kernel records would read the
    device time low: the numbers come from ``trace_records``, where a
    replay recorded whole stands in for one that lost records. A window
    that lost the record of a kernel launched outside a graph (nothing
    stands in for it) is profiled again, up to PROFILE_WINDOWS windows
    (``windows`` says how many ran), and the phase fails if every one
    lost some."""
    from torch.profiler import ProfilerActivity, profile, record_function

    lost = []
    while len(lost) < PROFILE_WINDOWS and (not lost or lost[-1]):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
            with record_function(WINDOW_SPAN):
                t0 = time.monotonic()
                for _ in range(steps):
                    step()
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
            for _ in range(TRAIL_STEPS):
                step()
            torch.cuda.synchronize()
        trace = trace_records(prof.profiler.kineto_results.events())
        lost.append(trace["launches_lost"])
    check(not lost[-1], f"each of {len(lost)} traces lost the records of "
          f"kernels launched outside a graph ({lost}): their device time "
          "would read low")
    window = trace.pop("window")
    return dict(
        windows=len(lost), launches_lost_by_window=lost, trace=trace,
        wall_ms_per_step=1e3 * wall / steps,
        device_ms_per_step=1e-3 * window["us"] / steps,
        device_busy_share=1e-6 * window["us"] / wall,
        kernel_launches_per_step=window["kernels"] / steps,
        graph_launches_per_step=trace["replays"] / steps,
        k4_device_ms_per_step=1e-3 * window["k4_us"] / steps,
        k4_kernel_launches_per_step=window["k4"] / steps,
        k5_kernel_launches_per_step=window["k5"] / steps,
        top_kernels=[{"name": name[:80], "calls_per_step": n / steps,
                      "ms_per_step": 1e-6 * ns / steps}
                     for name, (n, ns) in sorted(
                         window["by_name"].items(),
                         key=lambda kv: -kv[1][1])[:8]])


def trace_records(events) -> dict:
    """The device records of the calls made inside the WINDOW_SPAN span
    of a trace, grouped by the call that launched them (a record carries
    its launch's correlation id). A ``LAUNCH_APIS`` call leaves one
    record, and every replay of one graph (``cudaGraphLaunch``) the same
    number: a launch with no record, or a replay with fewer than the
    fullest, lost records. ``window`` sums device µs, kernels, K4's µs
    and K4 and K5 launches over the window (each replay that lost
    records counted as the mean of the whole ones) and, by kernel name,
    the records and ns (as recorded). ``trail_launches_lost`` counts the
    launches after the span that have no record: the trace's tail, which
    is left out."""
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type() != cuda]
    span = [e for e in host if e.name() == WINDOW_SPAN]
    lo, hi = (span[0].start_ns(), span[0].end_ns()) if span else (0, -1)
    # the runtime's and driver's calls (an operator's id is another count)
    calls = [e for e in host if lo <= e.start_ns() <= hi
             and e.name().startswith("cu")]
    made = {e.correlation_id() for e in calls}
    launches = {e.correlation_id() for e in calls if e.name() in LAUNCH_APIS}
    trail = {e.correlation_id() for e in host if e.start_ns() > hi
             and e.name() in LAUNCH_APIS}
    replays = {e.correlation_id(): [] for e in calls
               if e.name() == "cudaGraphLaunch"}
    outside, recorded, by_name = [], set(), {}
    for e in events:
        if (e.device_type() == cuda and not e.is_user_annotation()
                and e.correlation_id() in made):
            recorded.add(e.correlation_id())
            replays.get(e.correlation_id(), outside).append(e)
            n, ns = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (n + 1, ns + e.duration_ns())

    def sums(records) -> dict:
        k4 = [e for e in records if "paged_decode" in e.name()]
        return {"us": 1e-3 * sum(e.duration_ns() for e in records),
                "kernels": len(records), "k4_us":
                1e-3 * sum(e.duration_ns() for e in k4), "k4": len(k4),
                "k5": sum("gmlp_up" in e.name() for e in records)}

    full = max(map(len, replays.values()), default=0)
    whole = [sums(v) for v in replays.values() if len(v) == full]
    partial = [sums(v) for v in replays.values() if len(v) < full]
    window = sums(outside)
    for key in window:
        window[key] += sum(r[key] for r in whole)
        if partial:
            window[key] += len(partial) * sum(r[key] for r in whole) / len(
                whole)
    window["by_name"] = by_name
    return {"launches": len(launches),
            "launches_lost": len(launches - recorded),
            "trail_launches_lost": len(trail - {
                e.correlation_id() for e in events
                if e.device_type() == cuda}),
            "replays": len(replays), "whole": len(whole),
            "kernels_per_replay": full,
            "replay_kernels_lost": sum(full - r["kernels"] for r in partial),
            "k4_per_whole_replay": sorted({r["k4"] for r in whole}),
            "k5_per_whole_replay": sorted({r["k5"] for r in whole}),
            "k4_per_partial_replay_max": max((r["k4"] for r in partial),
                                             default=0),
            "k5_per_partial_replay_max": max((r["k5"] for r in partial),
                                             default=0),
            "window": window}


def phase_profile(model32) -> None:
    cfg = model_config(MODEL, dtype=torch.bfloat16)
    model = LlamaForCausalLM.from_params(dict(model32.named_parameters()),
                                         cfg)
    profile_decode(model, cfg, "profile")


def profile_decode(model, cfg, phase: str, k5_per_step: int = 0) -> None:
    """Where a decode step's time goes: torch.profiler over a steady
    window of decode ticks of the serving engine (8 active slots, no
    admission inside the window, so every tick is one decode replay).
    Device busy share = the kernels' summed device time over the
    window's wall time (one stream: no overlap). Where the trace shows
    the kernels inside the replayed graph, every replay must appear, at
    least half of them recorded whole; each whole one must hold K4 once
    a layer and K5 ``k5_per_step`` times, and no replay more."""
    window = 16
    with torch.inference_mode():
        free_engine()
        eng = serving_engine(model, cfg)
        for p in traffic(cfg.vocab_size)[:SLOTS]:
            eng.submit(p, max_new_tokens=96)
        for _ in range(4):  # admission and warm decode ticks
            eng.step()
        torch.cuda.synchronize()
        replays = eng._decode.replays
        stats = profiled(eng.step, window)
        replays = eng._decode.replays - replays
    check(eng.metrics.prefill_calls == 1, "admission inside the window")
    check(replays == (window + 1 + TRAIL_STEPS) * stats["windows"]
          and eng.decode_compile_count == 1,
          f"{replays} decode replays in {stats['windows']} windows of "
          f"{window} ticks, a lead tick and {TRAIL_STEPS} trailing ones, "
          f"{eng.decode_compile_count} captures")
    seen = stats["kernel_launches_per_step"] > 0
    if seen:
        layers, rep = cfg.num_hidden_layers, stats["trace"]
        check(rep["replays"] == window and 2 * rep["whole"] >= window,
              f"{phase}: the trace shows {rep['replays']} replays, "
              f"{rep['whole']} of them whole")
        check(rep["k4_per_whole_replay"] == [layers]
              and rep["k5_per_whole_replay"] == [k5_per_step]
              and rep["k4_per_partial_replay_max"] <= layers
              and rep["k5_per_partial_replay_max"] <= k5_per_step,
              f"{phase}: the trace counts K4 {rep['k4_per_whole_replay']} "
              f"and K5 {rep['k5_per_whole_replay']} a whole replay "
              f"(at most {rep['k4_per_partial_replay_max']} and "
              f"{rep['k5_per_partial_replay_max']} in one that lost "
              f"records), want {layers} and {k5_per_step}")
    emit(phase, window_decode_steps=window, decode_replays=replays,
         trace_shows_graph_kernels=seen, **stats)
    del eng
    free_engine()


# ---- 7b. the engine's one-capture contract at the serve cell -----------------
def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def replay_vs_eager(eng: InferenceEngine, prompts, new_tokens: int) -> dict:
    """Serve ``prompts`` greedily; before every replay, run the step
    function itself eagerly on the same static buffers, and hold the
    replay's outputs (token, logits, finite) to it bit for bit in the
    rows the step serves (the others read the TRASH page, which the
    eager run has just written). The eager run writes the K/V the replay
    then writes again: every layer writes its position before it reads
    it, so both see the same cache. Returns the tokens and the
    comparisons made."""
    compared = {"_prefill": "write_mask", "_decode": "active"}
    for name, mask in list(compared.items()):
        step = getattr(eng, name)
        compared[name] = 0

        def replay(step=step, name=name, mask=mask):
            rows = step.inputs[mask].clone()
            eager = [bits(t[rows]) for t in step.run_eager()]
            out = StaticStep.replay(step)
            same = all(torch.equal(a, bits(b[rows]))
                       for a, b in zip(eager, out))
            check(same, f"{name} replay {compared[name]} differs from the "
                        "eager step function")
            compared[name] += 1
            return out

        step.replay = replay
    ids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    results = eng.run()
    check(all(results[i].outcome == "ok" for i in ids), "outcomes")
    check(eng.decode_compile_count == 1 == eng.prefill_compile_count,
          "captures")
    return {"tokens": [results[i].tokens for i in ids],
            "prefill_replays_checked": compared["_prefill"],
            "decode_replays_checked": compared["_decode"]}


def poisoning(poison: int):
    """A cached forward whose logits go NaN on every row fed the token
    ``poison``: the engine's quarantine path, driven inside the graph."""
    from scaletorch_tpu_torch.models import llama

    def forward(model, tokens, cfg, cache, **kw):
        logits, cache = llama.forward_cached(model, tokens, cfg, cache, **kw)
        bad = (tokens == poison).any(dim=1)
        return logits.masked_fill(bad[:, None, None], float("nan")), cache

    return forward


def static_pointers(eng: InferenceEngine) -> dict:
    ptrs = {f"{step}.{name}": buf.data_ptr()
            for step in ("_prefill", "_decode")
            for name, buf in getattr(eng, step).inputs.items()}
    ptrs.update(cache_k=eng.cache.k.data_ptr(), cache_v=eng.cache.v.data_ptr())
    if eng.cache_layout == "paged":
        ptrs["tables"] = eng._tables_dev.data_ptr()
    return ptrs


def phase_decode_graph(model32) -> dict:
    """The engine's one-capture contract on Qwen3-0.6B, bf16, 8 slots:
    replays equal to the eager step functions bit for bit (paged through
    K4, paged through the gather path, dense; 16 decode steps each);
    paged (gather) and dense greedy tokens equal; sampled tokens
    (temperature 0.8, top-p 0.9) the same per request in two submission
    orders; one capture of each step through a prefix hit, a cancel, a
    deadline and a forced quarantine, every static buffer in place."""
    cfg = model_config(MODEL, dtype=torch.bfloat16)
    model = LlamaForCausalLM.from_params(dict(model32.named_parameters()),
                                         cfg)
    prompts = traffic(cfg.vocab_size)
    row = {}
    with torch.inference_mode():
        runs = {}
        for name, kw in (("paged_k4", {}), ("paged_gather",
                                            {"paged_kernel": False}),
                         ("dense", {"cache_layout": "dense"})):
            eng = serving_engine(model, cfg, **kw)
            runs[name] = replay_vs_eager(eng, prompts[:SLOTS],
                                         new_tokens=DECODE_GRAPH_STEPS + 1)
            del eng
            free_engine()
            check(runs[name]["decode_replays_checked"] == DECODE_GRAPH_STEPS,
                  f"{name}: {runs[name]['decode_replays_checked']} decode "
                  f"replays checked, want {DECODE_GRAPH_STEPS}")
        check(runs["paged_gather"]["tokens"] == runs["dense"]["tokens"],
              "paged (gather path) and dense greedy tokens differ")
        row["replay_equals_eager"] = {
            name: {k: v for k, v in run.items() if k != "tokens"}
            for name, run in runs.items()}
        row["paged_gather_equals_dense"] = True
        row["paged_k4_vs_dense"] = agreement(runs["paged_k4"]["tokens"],
                                             runs["dense"]["tokens"])

        sampled = SamplingParams(temperature=0.8, top_p=0.9)
        orders = {}
        for order in ("forward", "reversed"):
            eng = serving_engine(model, cfg, sampling=sampled)
            reqs = list(enumerate(prompts[:12]))
            if order == "reversed":
                reqs.reverse()
            ids = {seed: eng.submit(p, max_new_tokens=16, seed=seed)
                   for seed, p in reqs}
            results = eng.run()
            orders[order] = {seed: results[i].tokens
                             for seed, i in ids.items()}
            check(eng.decode_compile_count == 1 == eng.prefill_compile_count,
                  "sampled run: captures")
            del eng
            free_engine()
        check(orders["forward"] == orders["reversed"],
              "sampled tokens depend on the submission order")
        row["sampled_order_independent"] = {"requests": 12,
                                            "temperature": 0.8, "top_p": 0.9}

        poison = cfg.vocab_size - 1
        _build.reset_launch_counts()
        eng = serving_engine(model, cfg, forward_fn=poisoning(poison))
        before = static_pointers(eng)
        shared = [t for t in prompts[0][:256] if t != poison]
        a = eng.submit(shared + [1, 2, 3], max_new_tokens=8)
        eng.step()  # registers the shared pages
        b = eng.submit(shared + [4, 5], max_new_tokens=8)
        c = eng.submit([7, poison, 9], max_new_tokens=8)
        d = eng.submit(prompts[1], max_new_tokens=64)
        late = eng.submit([11, 12], max_new_tokens=8, ttl_s=1e-9)
        eng.step()
        eng.cancel(d)
        results = eng.run()
        outcomes = {k: results[i].outcome for k, i in
                    (("a", a), ("b", b), ("c", c), ("d", d), ("late", late))}
        check(outcomes == {"a": "ok", "b": "ok", "c": "quarantined",
                           "d": "aborted", "late": "timeout"},
              f"drill outcomes {outcomes}")
        check(results[b].prefix_hit, "no prefix hit")
        check(static_pointers(eng) == before, "a static buffer moved")
        eng.allocator.check_conservation()
        row["drill"] = {"outcomes": outcomes, "prefix_hit": True,
                        "static_buffers_in_place": len(before),
                        **check_one_capture(eng, "drill")}
        del eng
        free_engine()
    emit("decode_graph", model=MODEL, dtype="bfloat16", slots=SLOTS,
         decode_steps_compared=DECODE_GRAPH_STEPS, **row)
    return row


# ---- 8. the presets' other head geometries through K4 --------------------------
def phase_geometry_serve() -> dict:
    """dense-tiny (head_dim 32): the paged engine through K4 against the
    dense engine, greedy tokens equal. qwen3-14b's width cut to 2 layers
    (n_rep 5): teacher-forced paged decode through K4 against the gather
    path. Both fp32, random weights from a seeded generator."""
    cfg = model_config("dense-tiny", dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    model = LlamaForCausalLM.from_params(init_params(cfg, gen, "cuda"), cfg)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(3, 120, 12)]
    runs = {}
    with torch.inference_mode():
        for layout in ("paged", "dense"):
            _build.reset_launch_counts()
            eng = InferenceEngine(
                model, cfg, max_slots=4, max_seq=256, prefill_len=128,
                sampling=SamplingParams(temperature=0.0),
                cache_layout=layout, page_size=PAGE_SIZE)
            ids = [eng.submit(p, max_new_tokens=32) for p in prompts]
            results = eng.run()
            graphs = check_one_capture(eng, f"dense-tiny {layout}")
            runs[layout] = ([results[i] for i in ids],
                            graphs["decode_launches_per_replay"].get(
                                "paged_decode", 0),
                            eng.metrics.decode_steps)
            if layout == "paged":
                eng.allocator.check_conservation()
            del eng
            free_engine()
    (paged, k4, steps), (dense, k4_dense, _) = runs["paged"], runs["dense"]
    outcomes = [r.outcome for r in paged + dense]
    check(all(o == "ok" for o in outcomes), f"outcomes {outcomes}")
    same = [a.tokens == b.tokens for a, b in zip(paged, dense)]
    check(all(same), f"dense-tiny: paged (K4) vs dense greedy tokens differ "
                     f"in {same.count(False)} of {len(same)} requests")
    layers = cfg.num_hidden_layers
    check(k4 == layers and k4_dense == 0,
          f"dense-tiny: K4 launched {k4} times a decode replay (dense: "
          f"{k4_dense}), want {layers}")
    row = {"dense_tiny": {
        "heads": [cfg.num_attention_heads, cfg.num_key_value_heads],
        "head_dim": cfg.actual_head_dim, "layers": layers,
        "dtype": "float32", "requests": len(prompts),
        "paged_equals_dense": True, "decode_steps": steps,
        "k4_launches_per_decode_replay": k4}}
    del model

    cfg = model_config("qwen3-14b", dtype=torch.float32,
                       num_hidden_layers=GEOMETRY_PARITY_LAYERS)
    gen.manual_seed(0)
    model = LlamaForCausalLM.from_params(init_params(cfg, gen, "cuda"), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                           device="cuda")
    with torch.inference_mode():
        _build.reset_launch_counts()
        via_kernel = teacher_forced_decode_paged(model, cfg, tokens,
                                                 page_size=PAGE_SIZE)
        torch.cuda.synchronize()
        k4 = _build.launch_counts["paged_decode"]
        via_gather = teacher_forced_decode_paged(
            model, cfg, tokens, page_size=PAGE_SIZE, kernel=False)
    err = float((via_kernel - via_gather).abs().max())
    check(bool(torch.isfinite(via_kernel).all()), "qwen3-14b: non-finite")
    # prefill_len 1: each of the 64 calls is one token a slot, through K4
    check(k4 == cfg.num_hidden_layers * tokens.shape[1],
          f"qwen3-14b: K4 launched {k4} times")
    check(err <= PARITY_TOLERANCE,
          f"qwen3-14b: K4 vs gather max |dlogit| {err} > {PARITY_TOLERANCE}")
    row["qwen3_14b"] = {
        "heads": [cfg.num_attention_heads, cfg.num_key_value_heads],
        "head_dim": cfg.actual_head_dim, "hidden": cfg.hidden_size,
        "layers": cfg.num_hidden_layers, "dtype": "float32",
        "tokens": list(tokens.shape), "max_abs_logit_diff": err,
        "tolerance": PARITY_TOLERANCE, "k4_launches": k4}
    del model
    emit("geometry_serve", **row)
    return row


# ---- 9. full-width training parity, flash kernels vs sdpa --------------------
def phase_train_parity() -> None:
    cfg = model_config(MODEL, dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen, "cuda", requires_grad=True)
    b, s = 2, 1024
    tokens = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                           device="cuda")
    mb = {"input_ids": tokens[:, :-1], "target_ids": tokens[:, 1:],
          "position_ids": torch.arange(s, device="cuda")}
    leaves = tree_leaves(params)
    runs = {}
    for backend in ("flash", "sdpa"):
        loss_fn = make_loss_fn(cfg, attention_backend=backend,
                               gradient_checkpointing=True)
        _build.reset_launch_counts()
        t0 = time.monotonic()
        loss, _ = loss_fn(params, mb)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        runs[backend] = (float(loss.detach()), grads, dict(_build.launch_counts),
                         time.monotonic() - t0)
    (loss_f, g_f, launches_f, s_f), (loss_s, g_s, launches_s, s_s) = (
        runs["flash"], runs["sdpa"])
    norm_f = float(torch.sqrt(sum((g.float() ** 2).sum() for g in g_f)))
    norm_s = float(torch.sqrt(sum((g.float() ** 2).sum() for g in g_s)))
    diff = float(torch.sqrt(sum(((a - c).float() ** 2).sum()
                                for a, c in zip(g_f, g_s))))
    per_leaf = max(rel_err(a, c) for a, c in zip(g_f, g_s))
    d_loss = abs(loss_f - loss_s)
    check(all(bool(torch.isfinite(g).all()) for g in g_f), "non-finite grad")
    layers = cfg.num_hidden_layers
    want = {tf.K1_NAME: 2 * layers, tf.K2_NAME: layers, tf.K3_NAME: layers}
    check(launches_f == want, f"flash launches {launches_f}, want {want}")
    check(not launches_s, f"sdpa launched kernels {launches_s}")
    check(d_loss <= TRAIN_PARITY["loss_abs"],
          f"|dloss| {d_loss} > {TRAIN_PARITY['loss_abs']}")
    check(abs(norm_f - norm_s) / norm_s <= TRAIN_PARITY["grad_rel"],
          f"grad norms {norm_f} vs {norm_s}")
    check(diff / norm_s <= TRAIN_PARITY["grad_rel"],
          f"|g_flash - g_sdpa| / |g_sdpa| {diff / norm_s}")
    emit("train_parity", model=MODEL, layers=layers, dtype="float32",
         tokens=[b, s], gradient_checkpointing=True,
         loss_flash=loss_f, loss_sdpa=loss_s, loss_abs_diff=d_loss,
         grad_norm_flash=norm_f, grad_norm_sdpa=norm_s,
         grad_norm_rel_diff=abs(norm_f - norm_s) / norm_s,
         grad_rel_l2_diff=diff / norm_s, worst_leaf_rel_diff=per_leaf,
         tolerance=TRAIN_PARITY, flash_launches=launches_f,
         flash_s=s_f, sdpa_s=s_s)


# ---- 10. training on the headline row ------------------------------------------
def phase_train():
    cfg = make_bench_args(MODEL, seq=TRAIN_SEQ, gc=True)
    res = benchmark_config(cfg, warmup=TRAIN_WARMUP, steps=TRAIN_STEPS,
                           before_window=_build.reset_launch_counts)
    launches = dict(_build.launch_counts)
    trainer = res.pop("trainer")
    check(trainer.attention_backend == "flash",
          f"attention backend {trainer.attention_backend}")
    losses = res["warmup_losses"] + res["losses"]
    check(all(np.isfinite(losses)), f"losses {losses}")
    check(not any(res["update_skipped"]),
          f"update_skipped {res['update_skipped']}")
    layers = trainer.model_cfg.num_hidden_layers
    per_step = {name: launches.get(name, 0) / TRAIN_STEPS
                for name in (tf.K1_NAME, tf.K2_NAME, tf.K3_NAME)}
    want = {tf.K1_NAME: 2 * layers, tf.K2_NAME: layers, tf.K3_NAME: layers}
    check(per_step == want, f"launches per step {per_step}, want {want}")
    emit("train", model=MODEL, sequence_length=cfg.sequence_length,
         micro_batch_size=cfg.micro_batch_size,
         gradient_checkpointing=cfg.gradient_checkpointing,
         dtype=cfg.dtype, attention_backend=trainer.attention_backend,
         warmup_steps=TRAIN_WARMUP, timed_steps=TRAIN_STEPS,
         peak_flops=trainer.peak_flops(), launches=launches,
         launches_per_step=per_step, **res)
    return trainer, launches, res["tokens_per_second"]


def phase_train_profile(trainer, phase: str = "train_profile") -> None:
    emit(phase, window_train_steps=PROFILE_STEPS,
         **profiled(trainer.step, PROFILE_STEPS))


# ---- 11a. training from a dataset on disk: eval, checkpoint, resume ---------
class ByteTokenizer:
    """UTF-8 bytes shifted past the eos id: ids 2..257, below every
    preset's vocab; eos 1."""

    eos_token_id = 1

    def __call__(self, text, add_special_tokens=False):
        return {"input_ids": [b + 2 for b in text.encode()]}


def write_docs(path: str, docs: int, seed: int) -> str:
    """``docs`` seeded documents of DOC_BYTES bytes of lowercase words, one
    JSON object a line."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(docs):
            letters = rng.integers(97, 123, DOC_BYTES, dtype=np.uint8)
            letters[rng.random(DOC_BYTES) < 0.15] = 32  # spaces
            f.write(json.dumps({"text": letters.tobytes().decode()}) + "\n")
    return path


def data_train_cfg(root: str, checkpoint_dir, **kw):
    """The headline row cut to DRILL_LAYERS, fed from the files under
    ``root``, evaluated every 2 steps on 2 held-out batches, checkpointed
    every 2 steps."""
    cfg = make_bench_args(MODEL, seq=TRAIN_SEQ, gc=True)
    return dataclasses.replace(
        cfg, synthetic_data=False, num_hidden_layers=DRILL_LAYERS,
        dataset_name=os.path.join(root, "train.jsonl"),
        eval_dataset_name=os.path.join(root, "val.jsonl"),
        eval_frequency=2, eval_steps=2, checkpoint_dir=checkpoint_dir,
        save_frequency=2, keep_n_checkpoints=1, async_checkpointing=True,
        total_train_steps=DATA_STEPS, log_frequency=1, **kw)


def launch_log(trainer) -> dict:
    """Wrap the trainer's train and eval step functions to record the
    kernel launches of each call (counted by the wrappers on the host,
    at launch)."""
    log = {"train": [], "eval": []}

    def wrap(fn, key):
        def counted(*args):
            before = dict(_build.launch_counts)
            out = fn(*args)
            log[key].append({k: v - before.get(k, 0)
                             for k, v in _build.launch_counts.items()
                             if v - before.get(k, 0)})
            return out
        return counted

    trainer.step_fn = wrap(trainer.step_fn, "train")
    trainer._eval_fn = wrap(trainer._eval_fn, "eval")
    return log


def readings(trainer, steps) -> dict:
    by_step = {r["step"]: r for r in trainer.history}
    return {"loss": [by_step[s]["loss"] for s in steps],
            "lr": [by_step[s]["lr"] for s in steps],
            "val_loss": [by_step[s]["val_loss"] for s in steps
                         if "val_loss" in by_step[s]]}


def preprocess(path: str) -> dict:
    """Read and tokenize ``path`` as ``Trainer`` does (one process): the
    seconds, the tokens kept and the host bytes of the token array."""
    t0 = time.perf_counter()
    tokens = chunks_to_array(DatasetProcessor(
        ByteTokenizer(), TRAIN_SEQ).process(path))
    seconds = time.perf_counter() - t0
    row = {"file_bytes": os.path.getsize(path), "tokens": tokens.size,
           "array_bytes": tokens.nbytes, "seconds": seconds,
           "tokens_per_s": tokens.size / seconds}
    os.remove(path)
    return row


def phase_data_train(synthetic_tokens_per_s: float) -> dict:
    import shutil

    root = os.path.join(_build.BUILD_DIR.parent, "data_train")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    free_gb = shutil.disk_usage(root).free / 1e9
    emit("data_train_disk", free_gb=free_gb, checkpoint_gb_expected=3.4)
    write_docs(os.path.join(root, "train.jsonl"), DATA_DOCS, seed=11)
    write_docs(os.path.join(root, "val.jsonl"), EVAL_DOCS, seed=12)
    prep = preprocess(write_docs(os.path.join(root, "prep.jsonl"),
                                 PREP_DOCS, seed=13))
    layers = DRILL_LAYERS
    want_train = {tf.K1_NAME: 2 * layers, tf.K2_NAME: layers,
                  tf.K3_NAME: layers}
    want_eval = {tf.K1_NAME: layers}
    steps = list(range(1, DATA_STEPS + 1))

    # run A twice: straight 4-step runs (the first checkpointed, async)
    straight, saves = [], None
    for i in range(2):
        ckpt = os.path.join(root, "ckpt_a") if i == 0 else None
        _build.reset_launch_counts()
        t = Trainer(data_train_cfg(root, ckpt), tokenizer=ByteTokenizer())
        log = launch_log(t)
        t.train()
        check(all(d == want_train for d in log["train"]),
              f"run A launches per train step {log['train']}, want "
              f"{want_train}")
        check(len(log["eval"]) == 2 * 2
              and all(d == want_eval for d in log["eval"]),
              f"run A launches per eval batch {log['eval']}, want "
              f"{want_eval}")
        straight.append(readings(t, steps))
        if i == 0:
            mgr = t.checkpoint_manager
            check(mgr.all_steps() == [DATA_STEPS],
                  f"run A kept steps {mgr.all_steps()}")
            ckpt_bytes = mgr.step_bytes(DATA_STEPS)
            saves = [dict(x) for x in mgr.saves]
            tok_s = {r["step"]: r.get("tokens_per_second")
                     for r in t.history}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            val = t.evaluate()  # the cached set: the step-4 reading again
            eval_s = (time.perf_counter() - t0) / t.cfg.eval_steps
            check(val == straight[0]["val_loss"][-1],
                  f"the eval set moved: {val} vs "
                  f"{straight[0]['val_loss'][-1]}")
        t.close()
        del t
        free_engine()
        shutil.rmtree(os.path.join(root, "ckpt_a"), ignore_errors=True)
    a1, a2 = straight
    check(a1["lr"] == a2["lr"], f"learning rates differ: {a1['lr']} "
          f"{a2['lr']}")
    spread = max(abs(x - y) for key in ("loss", "val_loss")
                 for x, y in zip(a1[key], a2[key]))

    # run B: 2 steps and the step-2 checkpoint; run C resumes from it
    ckpt_b = os.path.join(root, "ckpt_b")
    t = Trainer(data_train_cfg(root, ckpt_b), tokenizer=ByteTokenizer())
    t.train(num_steps=2)
    check(t.checkpoint_manager.all_steps() == [2],
          f"run B kept {t.checkpoint_manager.all_steps()}")
    t.close()
    del t
    free_engine()
    _build.reset_launch_counts()
    t = Trainer(data_train_cfg(root, ckpt_b, resume="must"),
                tokenizer=ByteTokenizer())
    restore_s = t.checkpoint_manager.last_restore["seconds"]
    check(t.global_step == 2 and t.loader.position == 2
          and int(t.opt_state["count"]) == 2,
          f"run C restored step {t.global_step}, loader position "
          f"{t.loader.position}, count {int(t.opt_state['count'])}")
    log = launch_log(t)
    t.train()
    check(int(t.opt_state["count"]) == DATA_STEPS,
          f"AdamW count {int(t.opt_state['count'])}")
    c = readings(t, steps[2:])
    check(all(d == want_train for d in log["train"])
          and all(d == want_eval for d in log["eval"])
          and len(log["eval"]) == 2,
          f"run C launches {log}")
    t.close()
    del t
    free_engine()
    shutil.rmtree(root, ignore_errors=True)
    check(c["lr"] == a1["lr"][2:], f"resumed learning rates {c['lr']} vs "
          f"{a1['lr'][2:]}")
    resumed_diff = max(abs(x - y) for x, y in
                       zip(c["loss"] + c["val_loss"],
                           a1["loss"][2:] + a1["val_loss"][1:]))
    check(resumed_diff <= spread,
          f"resumed run differs by {resumed_diff} > {spread}, the spread "
          "of two straight runs")
    row = {"model": MODEL, "layers": DRILL_LAYERS,
           "sequence_length": TRAIN_SEQ,
           "train_docs": DATA_DOCS, "eval_docs": EVAL_DOCS,
           "doc_bytes": DOC_BYTES, "straight": a1, "straight_again": a2,
           "straight_bit_equal": spread == 0.0, "limit": spread,
           "resumed": c, "resumed_max_abs_diff": resumed_diff,
           "launches_per_train_step": want_train,
           "launches_per_eval_batch": want_eval,
           "checkpoint_bytes": ckpt_bytes, "saves": saves,
           "restore_s": restore_s, "eval_s_per_batch": eval_s,
           "preprocess": prep,
           "tokens_per_second_by_step": tok_s,
           "synthetic_tokens_per_second": synthetic_tokens_per_s,
           "nvidia_smi": card_name_and_power_limit()}
    emit("data_train", **row)
    return row


# ---- 11b. Hugging Face safetensors both ways --------------------------------
def phase_hf_roundtrip() -> None:
    import shutil

    root = os.path.join(_build.BUILD_DIR.parent, "hf_roundtrip")
    shutil.rmtree(root, ignore_errors=True)
    cfg = model_config(MODEL, dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    params = init_params(cfg, gen, "cuda")
    rounded = {k: ({kk: vv.to(torch.bfloat16).float()
                    for kk, vv in v.items()} if isinstance(v, dict)
                   else v.to(torch.bfloat16).float())
               for k, v in params.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = hf_interop.save_hf_params(root, params, cfg, dtype="bfloat16",
                                      max_shard_bytes=HF_SHARD_BYTES)
    write_s = time.perf_counter() - t0
    files = sorted(f for f in os.listdir(root) if f.endswith(".safetensors"))
    nbytes = sum(os.path.getsize(os.path.join(root, f)) for f in files)
    check(index.endswith("index.json") and len(files) >= 2,
          f"export wrote {files}")
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(hf_interop.hf_config_dict(cfg), f)
    del params
    t0 = time.perf_counter()
    loaded = hf_interop.load_hf_params(root, cfg, device="cuda")
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    flat_l, flat_r = flatten_params(loaded), flatten_params(rounded)
    check(sorted(flat_l) == sorted(flat_r), "loaded keys differ")
    unequal = [k for k in flat_l if not torch.equal(flat_l[k], flat_r[k])]
    check(not unequal, f"loaded tensors differ from the rounded source: "
          f"{unequal}")

    # the first loss of a Trainer that loads the export, and of one
    # handed the rounded parameters directly, on one fixed batch
    bench = make_bench_args(MODEL, seq=TRAIN_SEQ, gc=True)
    batch = next(iter(SyntheticDataLoader(cfg.vocab_size, TRAIN_SEQ, 1, 1,
                                          seed=5)))
    losses = []
    for source in ("loaded", "handed"):
        if source == "loaded":
            t = Trainer(dataclasses.replace(
                bench, model_name_or_path=root, load_pretrained_weights=True))
        else:
            t = Trainer(bench)
            with torch.no_grad():
                for dst, src in zip(tree_leaves(t.params),
                                    tree_leaves(rounded)):
                    dst.copy_(src)
        losses.append(float(t.step(batch)["loss"]))
        del t
        free_engine()
    check(losses[0] == losses[1], f"first losses {losses}")

    # greedy serving from the loaded and from the rounded parameters
    scfg = model_config(MODEL, dtype=torch.bfloat16)
    prompts = traffic(scfg.vocab_size, seed=23)[:8]
    tokens = []
    with torch.inference_mode():
        for tree in (loaded, rounded):
            model = LlamaForCausalLM.from_params(tree, scfg)
            free_engine()
            eng = serving_engine(model, scfg)
            ids = [eng.submit(p, max_new_tokens=32) for p in prompts]
            eng.run()
            results = [eng.result(i) for i in ids]
            check(all(r.outcome == "ok" for r in results),
                  f"outcomes {[r.outcome for r in results]}")
            check(eng.decode_compile_count == 1,
                  f"decode captured {eng.decode_compile_count} times")
            tokens.append([r.tokens for r in results])
            del eng, model
            free_engine()
    check(tokens[0] == tokens[1], "the loaded engine's greedy tokens differ")
    shutil.rmtree(root, ignore_errors=True)
    emit("hf_roundtrip", model=MODEL, dtype="bfloat16", shards=len(files),
         bytes=nbytes, write_s=write_s, read_s=read_s,
         write_gb_per_s=nbytes / write_s / 1e9,
         read_gb_per_s=nbytes / read_s / 1e9, tensors=len(flat_l),
         first_losses=losses, requests=len(prompts),
         greedy_tokens_equal=True, nvidia_smi=card_name_and_power_limit())


# ---- 11c. the rest of the reference's single-chip table --------------------
def table_rows() -> list:
    """The distinct rows of ``SINGLE_CHIP_ROWS`` in table order (the sweep
    row is the seq-16384 GC row again and runs once)."""
    seen = {}
    for label, (model, shape) in SINGLE_CHIP_ROWS.items():
        seen.setdefault(json.dumps([model, shape], sort_keys=True), label)
    return list(seen.values())


def flash_launches_per_step(cfg, layers: int) -> dict:
    """K1 / K2 / K3 a step: K1 twice a layer under whole-layer recompute
    (``nothing_saveable``), once without GC or under ``save_attn`` (and
    the dots policies recompute it too); each times the accumulation."""
    accum = cfg.gradient_accumulation_steps
    k1 = 2 if (cfg.gradient_checkpointing
               and cfg.remat_policy != "save_attn") else 1
    return {tf.K1_NAME: k1 * layers * accum, tf.K2_NAME: layers * accum,
            tf.K3_NAME: layers * accum}


def phase_train_table(rows=None) -> dict:
    """Each row of the table through ``benchmark_config`` at full width and
    depth: 2 warm-up and 3 timed steps."""
    out = {}
    for label in rows or table_rows():
        cfg = bench_row_args(label)
        t0 = time.monotonic()
        res = benchmark_config(cfg, warmup=TABLE_WARMUP, steps=TABLE_STEPS,
                               before_window=_build.reset_launch_counts)
        launches = dict(_build.launch_counts)
        trainer = res.pop("trainer")
        check(trainer.attention_backend == "flash",
              f"{label}: attention backend {trainer.attention_backend}")
        losses = res["warmup_losses"] + res["losses"]
        check(all(np.isfinite(losses)), f"{label}: losses {losses}")
        check(not any(res["update_skipped"]),
              f"{label}: update_skipped {res['update_skipped']}")
        master = {"float32": torch.float32,
                  "bfloat16": torch.bfloat16}[cfg.param_dtype]
        # no name may keep a row's tensors alive into the next row
        check(all(t.dtype == master for t in tree_leaves(
            {"params": trainer.params, **trainer.opt_state})
            if t.is_floating_point()),
            f"{label}: parameters or state not in {master}")
        layers = trainer.model_cfg.num_hidden_layers
        names = (tf.K1_NAME, tf.K2_NAME, tf.K3_NAME)
        per_step = {n: launches.get(n, 0) / TABLE_STEPS for n in names}
        want = flash_launches_per_step(cfg, layers)
        check(per_step == want,
              f"{label}: launches per step {per_step}, want {want}")
        summary = {k: res[k] for k in ("tokens_per_second", "mfu",
                                       "step_time_s", "memory_gb")}
        emit("train_table", row=label, model=SINGLE_CHIP_ROWS[label][0],
             layers=layers, sequence_length=cfg.sequence_length,
             micro_batch_size=cfg.micro_batch_size,
             gradient_accumulation_steps=cfg.gradient_accumulation_steps,
             gradient_checkpointing=cfg.gradient_checkpointing,
             remat_policy=cfg.remat_policy, param_dtype=cfg.param_dtype,
             optimizer=cfg.optimizer_name, dtype=cfg.dtype,
             warmup_steps=TABLE_WARMUP, timed_steps=TABLE_STEPS,
             peak_flops=trainer.peak_flops(), launches_per_step=per_step,
             row_s=time.monotonic() - t0, **res)
        out[label] = {**summary, "launches_per_step": per_step}
        trainer.close()
        del trainer, res
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_remat_parity() -> dict:
    """One set of seeded weights at the headline row (0.6B, seq 8192,
    bf16 compute), a forward and backward under each policy, twice: loss
    and every gradient bit for bit equal to ``nothing_saveable``'s (K2
    and K3 are deterministic, and a policy only keeps what the recompute
    would compute again); the launches, the seconds of both runs and the
    peak memory above the weights (and the base gradients) of each."""
    cfg = bench_row_args(HEADLINE)
    mcfg = build_model_config(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(mcfg, gen, "cuda", requires_grad=True)
    s = cfg.sequence_length
    tokens = torch.randint(0, mcfg.vocab_size, (1, s + 1), generator=gen,
                           device="cuda")
    mb = {"input_ids": tokens[:, :-1], "target_ids": tokens[:, 1:],
          "position_ids": torch.arange(s, device="cuda")}
    leaves = tree_leaves(params)
    layers = mcfg.num_hidden_layers
    base = None
    rows = {}
    for policy in REMAT_POLICIES:
        loss_fn = make_loss_fn(mcfg, attention_backend="flash",
                               gradient_checkpointing=True,
                               remat_policy=policy)
        want = flash_launches_per_step(
            dataclasses.replace(cfg, remat_policy=policy), layers)
        seconds = []
        for _ in range(2):  # the first run also grows the allocator
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            _build.reset_launch_counts()
            t0 = time.monotonic()
            loss, _ = loss_fn(params, mb)
            grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            seconds.append(time.monotonic() - t0)
            launches = dict(_build.launch_counts)
            peak = torch.cuda.max_memory_allocated() - before
            loss = loss.detach()
            if base is None:
                base = (loss, grads)
            differ = [i for i, (g, b) in enumerate(zip(grads, base[1]))
                      if not torch.equal(g, b)]
            check(launches == want,
                  f"{policy}: launches {launches}, want {want}")
            check(torch.equal(loss, base[0]) and not differ,
                  f"{policy}: the loss or gradients {differ} differ from "
                  "nothing_saveable's")
            del grads
        rows[policy] = {"loss": float(loss), "launches": launches,
                        "seconds": seconds,
                        "peak_gb_above_weights": peak / 1e9,
                        "bit_equal_to_nothing_saveable": True}
        del loss
    emit("remat_parity", row=HEADLINE, layers=layers, dtype=cfg.dtype,
         param_dtype=cfg.param_dtype, policies=rows)
    del params, base
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# ---- 12. the grouped-MLP kernels against their plain versions -----------------
def gmlp_shape(shape: str) -> tuple:
    """(groups, tokens per group, capacity factor, bwd, ep ranks)."""
    if shape == EP_SHAPE:
        return (*GMLP_SHAPES["train"], EP_SLAB_RANKS)
    if shape in GMLP_SERVE_SLABS:
        return (*GMLP_SHAPES[GMLP_SERVE_SLABS[shape][0]], 1)
    return (*GMLP_SHAPES[shape], 1)


def gmlp_inputs(shape: str, dtype: torch.dtype, seed: int):
    """(x, counts, wg, wu, wd, dO) at one of GMLP_SHAPES, at EP_SHAPE or
    at one of GMLP_SERVE_SLABS. Counts come from routing seeded hidden
    states through a seeded router, as a layer routes them; the train
    shape also gets one expert at 0 and one at C. EP_SHAPE routes four
    ranks' tokens and keeps rank 0's experts: the counts per (expert,
    source rank) that ``exchange_slot_counts`` gives it, uneven across
    the ranks. A serving slab keeps rank 0's E/ep experts of the decode's
    or the prefill's routing and I/tp. x and dO are random in every row, past the counts
    too, so the kernels' masks are what keeps those rows out."""
    cfg = model_config(MOE_MODEL)
    e, k, h, i = GMLP_SHAPE_DIMS.get(shape, (
        cfg.num_experts, cfg.num_experts_per_tok, cfg.hidden_size,
        cfg.moe_intermediate_size))
    groups, tokens, cf, _, ep = gmlp_shape(shape)
    cap = expert_capacity(tokens, e, k, cf)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device="cuda") * scale).to(
            dtype)

    hidden = torch.randn(ep * groups, tokens, h, generator=gen,
                         device="cuda")
    router = torch.randn(h, e, generator=gen, device="cuda") * 0.02
    routing, _ = top_k_routing_indexed(hidden @ router, k, cap)
    counts = slot_fill_counts_indexed(routing, e, cap)
    if shape == "train":
        counts[0], counts[1] = 0, cap
    _, serve_ep, serve_tp = GMLP_SERVE_SLABS.get(shape, (None, 1, 1))
    e, i = e // (ep * serve_ep), i // serve_tp
    counts = counts[:e]  # [E/ep, ep·G]: (source rank, group) per expert
    x = rnd(e, ep * groups, cap, h)
    wg, wu = rnd(e, h, i, scale=h ** -0.5), rnd(e, h, i, scale=h ** -0.5)
    wd = rnd(e, i, h, scale=i ** -0.5)
    return x, counts.contiguous(), wg, wu, wd, rnd(e, ep * groups, cap, h)


def slot_tile_rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest relative L2 error of one TILE-row slot tile of one
    (expert, group) of [E, G, C, H] tensors (all-zero tiles skipped)."""
    e, g, c, _ = b.shape
    pad = (-c) % TILE

    def per_tile(x):
        rows = F.pad(x.float().square().sum(-1), (0, pad))
        return rows.view(e, g, -1, TILE).sum(-1)

    return worst_ratio(per_tile(a.float() - b.float()), per_tile(b))


def expert_rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest relative L2 error of one expert's weight gradient."""
    return worst_ratio((a.float() - b.float()).square().flatten(1).sum(-1),
                       b.float().square().flatten(1).sum(-1))


def worst_ratio(num: torch.Tensor, den: torch.Tensor) -> float:
    ratios = (num[den > 0] / den[den > 0]).sqrt()
    return float(ratios.max()) if ratios.numel() else 0.0


def gmlp_errors(got: dict, ref: dict) -> dict:
    """Every reading of the tensors ``got`` against ``ref`` (same keys)."""
    errs = {}
    for name, want in ref.items():
        a = got[name]
        errs[f"{name}_max_abs"] = max_abs(a, want)
        errs[f"{name}_max_abs_rel"] = max_abs(a, want) / max(
            float(want.float().abs().max()), 1e-30)
        errs[f"{name}_rel"] = rel_err(a, want)
        errs[f"{name}_tile_rel"] = (expert_rel_max(a, want)
                                    if name.startswith("dw")
                                    else slot_tile_rel_max(a, want))
    return errs


def gmlp_violations(errs: dict, tol: dict) -> list:
    return [f"{key} {v} > {tol[key.split('_', 1)[1]]}"
            for key, v in errs.items()
            if not key.endswith("_max_abs") and not v <= tol[
                key.split("_", 1)[1]]]


def gmlp_work(kid: str, x, counts, wg) -> tuple:
    """(flops, bytes) of one launch's own work (2 flops per multiply-add;
    each input read once: the counted rows of x, dO, s, dG, dU, the
    weights of the experts that have rows; each output written once):
      K5:    x Wg, x Wu, h Wd (6 H I a row); out over every slot;
      grads: x Wg, x Wu, dO Wd^T (6 H I a row); s, dG, dU over the rows;
      K6:    dG Wg^T, dU Wu^T (4 H I a row) from dG, dU and two weights;
             dx over every slot;
      K7:    x^T dG, x^T dU, s^T dO (6 H I a row) from x, dO, s, dG, dU;
             the three gradients of every expert;
      backward: grads + K6 + K7, what _GroupedSwiGLU.backward launches."""
    if kid == "backward":
        parts = [gmlp_work(k, x, counts, wg) for k in ("grads", "K6", "K7")]
        return tuple(sum(p[n] for p in parts) for n in range(2))
    e, g, c, h = x.shape
    i = wg.shape[-1]
    elem = x.element_size()
    rows = int(counts.sum())
    weight = h * i * elem * int((counts.sum(1) > 0).sum())
    x_rows = rows * h * elem
    i_rows = rows * i * elem
    full = e * g * c * h * elem
    flops, nbytes = {
        "K5": (6 * h * i * rows, 3 * weight + x_rows + full),
        "grads": (6 * h * i * rows, 3 * weight + 2 * x_rows + 3 * i_rows),
        "K6": (4 * h * i * rows, 2 * weight + 2 * i_rows + full),
        "K7": (6 * h * i * rows,
               2 * x_rows + 3 * i_rows + 3 * e * h * i * elem),
    }[kid]
    return flops, nbytes + 4 * e * g  # counts


def gmlp_bound(kid: str, x, counts, wg) -> tuple:
    """(bound ms, what bounds it): the larger of the launch's bytes over
    HBM bandwidth and its flops over the dtype's peak (gmlp_work)."""
    flops, nbytes = gmlp_work(kid, x, counts, wg)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[x.dtype]
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def skip_one_slot_tile(got: dict, args, counts) -> dict:
    """``got`` as kernels that skip one filled slot tile would give it:
    the last (partial) tile of the (expert, group) with the most rows,
    where the skip is least visible in the weight gradients, is left out
    of out and dx (zero rows) and of dWg, dWu, dWd."""
    x, _, wg, wu, wd, dout = args
    flat = int(torch.argmax(counts.flatten()))
    e, g = divmod(flat, counts.shape[1])
    n = int(counts[e, g])
    t0 = (n - 1) // TILE * TILE
    out = {k: v.clone() for k, v in got.items()}
    for name in ("out", "dx"):
        if name in out:
            out[name][e, g, t0:n] = 0
    if "dwg" in out:
        cut = counts.clone()
        cut[e, g] = t0
        full = gm.grouped_mlp_dw_ref(x, counts, wg, wu, wd, dout)
        part = gm.grouped_mlp_dw_ref(x, cut, wg, wu, wd, dout)
        for name, a, b in zip(("dwg", "dwu", "dwd"), full, part):
            out[name] = (out[name].float() - (a.float() - b.float())).to(
                a.dtype)
    return out


def gmlp_backward(args):
    """What _GroupedSwiGLU.backward launches: the grads pass, K6, K7."""
    grads = gm.grouped_mlp_block_grads(*args)
    return (*grads, gm.grouped_mlp_dx(*args, grads),
            *gm.grouped_mlp_dw(*args, grads))


def gmlp_case(shape: str, dtype: torch.dtype, flush,
              phase: str = "kernel_grouped_mlp") -> dict:
    args = gmlp_inputs(shape, dtype, seed=2024)
    x, counts, wg, wu, wd, dout = args
    fwd_args = args[:5]
    bwd = gmlp_shape(shape)[3]
    tol = GMLP_TOLERANCE[dtype]
    past = (torch.arange(x.shape[2], device="cuda")[None, None]
            >= counts[..., None])
    got = {"out": gm.grouped_mlp_forward(*fwd_args)}
    ref = {"out": gm.masked_grouped_mlp(*fwd_args)}
    deterministic = None
    if bwd:
        backward = gmlp_backward(args)
        grads = backward[:3]
        ref_grads = gm.grouped_mlp_block_grads_ref(*args)
        # the workspace rows of slot tiles past a count are never written
        # (K6 and K7 never read them): both sides compare as zeros there
        for name, a, b in zip(("s", "dg", "du"), grads, ref_grads):
            got[name] = a.masked_fill(past[..., None], 0)
            ref[name] = b.masked_fill(past[..., None], 0)
        got["dx"] = backward[3]
        got["dwg"], got["dwu"], got["dwd"] = backward[4:]
        ref["dx"] = gm.grouped_mlp_dx_ref(*args, ref_grads)
        ref["dwg"], ref["dwu"], ref["dwd"] = gm.grouped_mlp_dw_ref(
            *args, ref_grads)
        # no atomics: a second backward gives the same bits
        again = gmlp_backward(args)
        deterministic = all(
            bool(torch.equal(a, b)) for a, b in zip(
                [got[n] for n in ("dx", "dwg", "dwu", "dwd")], again[3:]))
        deterministic &= all(
            bool(torch.equal(a.masked_fill(past[..., None], 0), got[n]))
            for a, n in zip(again[:3], ("s", "dg", "du")))
        del backward, again, ref_grads
    torch.cuda.synchronize()
    for name, t in got.items():
        check(bool(torch.isfinite(t).all()), f"{shape} {dtype}: {name}")
    zeros = all(bool((got[n][past] == 0).all()) for n in ("out", "dx")
                if n in got)
    errs = gmlp_errors(got, ref)
    controls = {}
    faulty = {"skip_one_tile": skip_one_slot_tile(got, args, counts)}
    if bwd:
        # a K7 that forgets the dO mask sums the covering tiles' rows
        tiles = torch.clamp((counts + TILE - 1) // TILE * TILE,
                            max=x.shape[2]).to(torch.int32)
        unmasked = dict(got)
        unmasked["dwg"], unmasked["dwu"], unmasked["dwd"] = (
            gm.grouped_mlp_dw_ref(x, tiles, wg, wu, wd, dout))
        faulty["dw_unmasked_dout"] = unmasked
    for name, f in faulty.items():
        c_errs = gmlp_errors(f, ref)
        controls[name] = {**c_errs, "over_limit": gmlp_violations(c_errs,
                                                                  tol)}
    reps = 5
    row = {"shape": shape, "dtype": str(dtype).replace("torch.", ""),
           "x": list(x.shape), "hidden_intermediate": list(wg.shape[1:]),
           "rows": int(counts.sum()), "filled_experts": int(
               (counts.sum(1) > 0).sum()),
           "structural_zeros": zeros, "bitwise_deterministic": deterministic,
           "tolerance": tol, **errs, "controls": controls, "kernels": {}}
    e, g, c, h = x.shape
    lib_in = [t.detach().clone().requires_grad_() for t in
              (x.view(e, g * c, h), wg, wu, wd)]
    lib_out = moe_mlp(*lib_in)

    def lib_bwd():
        return torch.autograd.grad(lib_out, lib_in, dout.view(e, g * c, h),
                                   retain_graph=True)

    timed = {"K5": (lambda: gm.grouped_mlp_forward(*fwd_args),
                    lambda: gm.masked_grouped_mlp(*fwd_args),
                    lambda: moe_mlp(x.view(e, g * c, h), wg, wu, wd))}
    if bwd:
        # each launch alone, from the grads pass's (s, dG, dU); then the
        # three together, as the autograd backward runs them. Each launch's
        # library yardstick is the cuBLAS batched products of its own
        # function over every slot; the einsum path's one autograd backward
        # (dx and dW) is the yardstick of the whole backward.
        gc = g * c
        s_, dg_, du_ = (got[n].view(e, gc, -1) for n in ("s", "dg", "du"))
        x_, do_ = x.view(e, gc, h), dout.view(e, gc, h)

        def lib_dx():
            return torch.baddbmm(torch.bmm(dg_, wg.mT), du_, wu.mT)

        def lib_dw():
            return (torch.bmm(x_.mT, dg_), torch.bmm(x_.mT, du_),
                    torch.bmm(s_.mT, do_))

        timed["grads"] = (lambda: gm.grouped_mlp_block_grads(*args),
                          lambda: gm.grouped_mlp_block_grads_ref(*args),
                          None)
        timed["K6"] = (lambda: gm.grouped_mlp_dx(*args, grads),
                       lambda: gm.grouped_mlp_dx_ref(*args, grads), lib_dx)
        timed["K7"] = (lambda: gm.grouped_mlp_dw(*args, grads),
                       lambda: gm.grouped_mlp_dw_ref(*args, grads), lib_dw)
        timed["backward"] = (lambda: gmlp_backward(args),
                             lambda: (gm.grouped_mlp_dx_ref(*args),
                                      gm.grouped_mlp_dw_ref(*args)),
                             lib_bwd)
    lib_ms = {}
    for kid, (kernel_fn, plain_fn, lib_fn) in timed.items():
        bound_ms, bound_by = gmlp_bound(kid, x, counts, wg)
        if lib_fn is not None and lib_fn not in lib_ms:
            lib_ms[lib_fn] = time_ms(lib_fn, flush, reps)
        row["kernels"][kid] = {
            "kernel_ms": time_ms(kernel_fn, flush, reps),
            "plain_ms": time_ms(plain_fn, flush, reps),
            "library_ms": lib_ms.get(lib_fn), "bound_ms": bound_ms,
            "bound_by": bound_by}
        row["kernels"][kid]["bound_share"] = (
            bound_ms / row["kernels"][kid]["kernel_ms"])
    if bwd:
        k = row["kernels"]
        row["grads_pass_ms"] = k["grads"]["kernel_ms"]
        row["grads_pass_bound_ms"] = k["grads"]["bound_ms"]
        row["backward_ms"] = k["backward"]["kernel_ms"]
        row["backward_bound_ms"] = k["backward"]["bound_ms"]
    row["library"] = ("K5: the einsum path (three cuBLAS bmm calls and "
                      "the swiglu kernels); K6: bmm + baddbmm (dG Wg^T + "
                      "dU Wu^T); K7: three bmm (x^T dG, x^T dU, s^T dO); "
                      "backward: the einsum path's autograd; every slot, "
                      "several calls, not one")
    if gmlp_shape(shape)[4] > 1:
        per_source = counts.sum(0)
        row["rows_per_source_rank"] = per_source.tolist()
        row["rows_per_expert_min_max"] = [int(counts.sum(1).min()),
                                          int(counts.sum(1).max())]
        check(int(per_source.max()) > int(per_source.min()),
              f"{shape}: the source ranks' counts are even")
    del lib_out, lib_in
    emit(phase, **row)
    violations = gmlp_violations(errs, tol)
    check(zeros, f"{shape} {dtype}: rows past the counts are not zero")
    check(not violations, f"{shape} {dtype}: kernels vs plain: {violations}")
    check(deterministic is not False,
          f"{shape} {dtype}: two runs of the backward differ")
    for name, c in controls.items():
        check(bool(c["over_limit"]),
              f"{shape} {dtype}: the {name} control passes every check")
    if bwd:
        check(any(v.startswith("dw") for v in
                  controls["dw_unmasked_dout"]["over_limit"]),
              f"{shape} {dtype}: unmasked dO passes the dW checks")
    return row


def phase_kernel_grouped_mlp(dtypes=(torch.float32, torch.bfloat16),
                             shapes=(*GMLP_SHAPES, *GMLP_SERVE_SLABS)) -> dict:
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    results = {}
    for shape in shapes:
        for dtype in dtypes:
            row = gmlp_case(shape, dtype, flush)
            results[(shape, row["dtype"])] = row
            torch.cuda.empty_cache()
    return results


def phase_kernel_ep_blocks(dtypes=(torch.float32, torch.bfloat16)) -> dict:
    """K5, the grads pass, K6 and K7 on the slabs the ep exchange hands a
    rank at the train cell under ep 4 (EP_SHAPE), as gmlp_case checks and
    times them at the train shape."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    results = {}
    for dtype in dtypes:
        row = gmlp_case(EP_SHAPE, dtype, flush, phase="kernel_ep_blocks")
        results[row["dtype"]] = row
        torch.cuda.empty_cache()
    return results


# ---- 13. Qwen3-30B-A3B decode parity, K4 + K5 vs gather + einsum -------------------
def moe_model(dtype: torch.dtype, layers=None, **overrides):
    """(config, model) of Qwen3-30B-A3B with random weights drawn in place
    from a seeded generator, the grouped-MLP kernels on."""
    cfg = model_config(MOE_MODEL, dtype=dtype, use_grouped_mlp_kernel=True,
                       **({"num_hidden_layers": layers} if layers else {}),
                       **overrides)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return cfg, Qwen3MoEForCausalLM(cfg, "cuda").init_weights_(gen)


def phase_moe_decode_parity() -> None:
    cfg, model = moe_model(torch.float32, MOE_DECODE_PARITY_LAYERS,
                           capacity_factor=DROPLESS_CF)
    off = dataclasses.replace(cfg, use_grouped_mlp_kernel=False)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                           device="cuda")
    with torch.inference_mode():
        _build.reset_launch_counts()
        via_kernels = teacher_forced_decode_paged(model, cfg, tokens,
                                                  page_size=PAGE_SIZE)
        torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
        via_plain = teacher_forced_decode_paged(
            model, off, tokens, page_size=PAGE_SIZE, kernel=False)
    err = float((via_kernels - via_plain).abs().max())
    layers = cfg.num_hidden_layers
    # prefill_len 1: every one of the 64 calls is one token a slot, so K4
    # serves the prefill too
    want = {"paged_decode": layers * 64, gm.K5_NAME: layers * 64}
    check(bool(torch.isfinite(via_kernels).all()), "non-finite logits")
    check(launches == want, f"launches {launches}, want {want}")
    check(err <= PARITY_TOLERANCE,
          f"K4 + K5 vs gather + einsum max |dlogit| {err} > "
          f"{PARITY_TOLERANCE}")
    emit("moe_decode_parity", model=MOE_MODEL, layers=layers,
         dtype="float32", capacity_factor=cfg.capacity_factor,
         tokens=list(tokens.shape), max_abs_logit_diff=err,
         tolerance=PARITY_TOLERANCE, launches=launches)


# ---- 14. serving Qwen3-30B-A3B at full depth -------------------------------------
def phase_moe_serve() -> dict:
    cfg, model = moe_model(torch.bfloat16, capacity_factor=DROPLESS_CF)
    off = dataclasses.replace(cfg, use_grouped_mlp_kernel=False)
    prompts = traffic(cfg.vocab_size)
    layers = cfg.num_hidden_layers
    with torch.inference_mode():
        free_engine()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        eng, results, ptrs, stats = serve(model, cfg, prompts, None)
        launches = dict(_build.launch_counts)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        prefills = eng.metrics.prefill_calls
        outcomes = check_served(eng, results, ptrs, stats, "moe_serve")
        graphs = check_one_capture(eng, "moe_serve")
        per_decode = graphs["decode_launches_per_replay"]
        per_prefill = graphs["prefill_launches_per_replay"]
        want = {"paged_decode": layers, gm.K5_NAME: layers}
        check(per_decode == want and per_prefill == {gm.K5_NAME: layers},
              f"launches a decode replay {per_decode}, a prefill replay "
              f"{per_prefill}: want {want} and K5 {layers}")
        del eng
        free_engine()
        _, ref_results, _, ref_stats = serve(model, off, prompts, False)
        free_engine()
    profile_decode(model, cfg, "moe_serve_profile", k5_per_step=layers)
    emit("moe_serve", model=MOE_MODEL, layers=layers, dtype="bfloat16",
         capacity_factor=cfg.capacity_factor, slots=SLOTS, max_seq=MAX_SEQ,
         prefill_len=PREFILL_LEN, page_size=PAGE_SIZE,
         requests=len(prompts), outcomes=sorted(set(outcomes)),
         launches=launches, prefill_calls=prefills,
         k4_per_decode_step=per_decode["paged_decode"],
         k5_per_decode_step=per_decode[gm.K5_NAME],
         peak_memory_gb=peak_gb, **stats, **graphs,
         gather_einsum_path={k: ref_stats[k] for k in
                             ("wall_s", "tokens_per_s", "decode_tokens_per_s",
                              "mean_ttft_s", "tpot_p50_s", "decode_steps")},
         greedy_agreement=agreement([r.tokens for r in results],
                                    [r.tokens for r in ref_results]))
    return launches


# ---- 15. training parity, kernels on vs the einsum path ---------------------------
def phase_moe_train_parity() -> None:
    cfg = model_config(MOE_MODEL, dtype=torch.float32,
                       num_hidden_layers=MOE_TRAIN_PARITY_LAYERS,
                       use_grouped_mlp_kernel=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = qwen3_moe.init_params(cfg, gen, "cuda", requires_grad=True)
    b, s = 2, 1024
    tokens = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                           device="cuda")
    mb = {"input_ids": tokens[:, :-1], "target_ids": tokens[:, 1:],
          "position_ids": torch.arange(s, device="cuda")}
    leaves = tree_leaves(params)
    runs = {}
    for kernel in (True, False):
        loss_fn = make_loss_fn(
            dataclasses.replace(cfg, use_grouped_mlp_kernel=kernel),
            attention_backend="flash", gradient_checkpointing=True)
        _build.reset_launch_counts()
        loss, stats = loss_fn(params, mb)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        runs[kernel] = (float(loss.detach()), grads,
                        dict(_build.launch_counts),
                        {k: float(v) for k, v in stats.items()})
    (loss_k, g_k, launches_k, stats_k), (loss_e, g_e, launches_e, _) = (
        runs[True], runs[False])
    norm_k = float(torch.sqrt(sum((g.float() ** 2).sum() for g in g_k)))
    norm_e = float(torch.sqrt(sum((g.float() ** 2).sum() for g in g_e)))
    diff = float(torch.sqrt(sum(((a - c).float() ** 2).sum()
                                for a, c in zip(g_k, g_e))))
    worst = max(rel_err(a, c) for a, c in zip(g_k, g_e))
    layers = cfg.num_hidden_layers
    flash = {tf.K1_NAME: 2 * layers, tf.K2_NAME: layers, tf.K3_NAME: layers}
    want = {**flash, gm.K5_NAME: 2 * layers, gm.GRADS_NAME: layers,
            gm.K6_NAME: layers, gm.K7_NAME: layers}
    check(all(bool(torch.isfinite(g).all()) for g in g_k), "non-finite grad")
    check(launches_k == want, f"kernel launches {launches_k}, want {want}")
    check(launches_e == flash, f"einsum-path launches {launches_e}")
    d_loss = abs(loss_k - loss_e)
    check(d_loss <= MOE_TRAIN_PARITY["loss_abs"],
          f"|dloss| {d_loss} > {MOE_TRAIN_PARITY['loss_abs']}")
    check(diff / norm_e <= MOE_TRAIN_PARITY["grad_rel"],
          f"|g_kernel - g_einsum| / |g_einsum| {diff / norm_e}")
    emit("moe_train_parity", model=MOE_MODEL, layers=layers,
         dtype="float32", tokens=[b, s], gradient_checkpointing=True,
         loss_kernels=loss_k, loss_einsum=loss_e, loss_abs_diff=d_loss,
         grad_norm_kernels=norm_k, grad_norm_einsum=norm_e,
         grad_rel_l2_diff=diff / norm_e, worst_leaf_rel_diff=worst,
         routing=stats_k, tolerance=MOE_TRAIN_PARITY,
         kernel_launches=launches_k)


# ---- 16. training Qwen3-30B-A3B cut to 4 layers ------------------------------------
def phase_moe_train():
    cfg = make_bench_args(MOE_MODEL, seq=MOE_TRAIN_SEQ, gc=True,
                          extra={"num_hidden_layers": MOE_TRAIN_LAYERS})
    before = os.environ.get(qwen3_moe.GROUPED_MLP_ENV)
    os.environ[qwen3_moe.GROUPED_MLP_ENV] = "1"  # read once, by the config
    try:
        res = benchmark_config(cfg, warmup=TRAIN_WARMUP, steps=TRAIN_STEPS,
                               before_window=_build.reset_launch_counts)
    finally:
        if before is None:
            del os.environ[qwen3_moe.GROUPED_MLP_ENV]
        else:
            os.environ[qwen3_moe.GROUPED_MLP_ENV] = before
    launches = dict(_build.launch_counts)
    trainer = res.pop("trainer")
    check(trainer.model_cfg.use_grouped_mlp_kernel, "the kernel is off")
    losses = res["warmup_losses"] + res["losses"]
    check(all(np.isfinite(losses)), f"losses {losses}")
    check(not any(res["update_skipped"]),
          f"update_skipped {res['update_skipped']}")
    layers = trainer.model_cfg.num_hidden_layers
    names = (tf.K1_NAME, tf.K2_NAME, tf.K3_NAME, gm.K5_NAME, gm.K6_NAME,
             gm.K7_NAME, gm.GRADS_NAME)
    per_step = {n: launches.get(n, 0) / TRAIN_STEPS for n in names}
    want = dict(zip(names, (2 * layers, layers, layers, 2 * layers, layers,
                            layers, layers)))
    check(per_step == want, f"launches per step {per_step}, want {want}")
    # the counts' sum of a layer: every kept (token, choice), averaged over
    # the layers and the timed steps (the kernel cell routes 32593 rows)
    mcfg = trainer.model_cfg
    routed = [cfg.sequence_length * cfg.micro_batch_size
              * mcfg.num_experts_per_tok * (1.0 - d)
              for d in res["moe_dropped_fraction"]]
    emit("moe_train", model=MOE_MODEL, layers=layers,
         sequence_length=cfg.sequence_length,
         micro_batch_size=cfg.micro_batch_size,
         gradient_checkpointing=cfg.gradient_checkpointing, dtype=cfg.dtype,
         capacity_factor=trainer.model_cfg.capacity_factor,
         attention_backend=trainer.attention_backend,
         warmup_steps=TRAIN_WARMUP, timed_steps=TRAIN_STEPS,
         active_params=trainer.mfu_params, peak_flops=trainer.peak_flops(),
         launches=launches, launches_per_step=per_step,
         rows_routed_per_layer=statistics.mean(routed), **res)
    return trainer, launches


def phase_moe_train_save_attn() -> dict:
    """The moe_train row under ``save_attn``: K1 once a layer a step (4,
    not 8), K2 / K3 / K6 / K7 and the grads pass once a layer, K5 twice
    (the grouped MLP is recomputed; it is not a dot)."""
    cfg = make_bench_args(MOE_MODEL, seq=MOE_TRAIN_SEQ, gc=True,
                          remat_policy="save_attn",
                          extra={"num_hidden_layers": MOE_TRAIN_LAYERS})
    before = os.environ.get(qwen3_moe.GROUPED_MLP_ENV)
    os.environ[qwen3_moe.GROUPED_MLP_ENV] = "1"
    try:
        res = benchmark_config(cfg, warmup=1, steps=TABLE_STEPS,
                               before_window=_build.reset_launch_counts)
    finally:
        if before is None:
            del os.environ[qwen3_moe.GROUPED_MLP_ENV]
        else:
            os.environ[qwen3_moe.GROUPED_MLP_ENV] = before
    launches = dict(_build.launch_counts)
    trainer = res.pop("trainer")
    losses = res["warmup_losses"] + res["losses"]
    check(all(np.isfinite(losses)), f"losses {losses}")
    check(not any(res["update_skipped"]),
          f"update_skipped {res['update_skipped']}")
    layers = trainer.model_cfg.num_hidden_layers
    names = (tf.K1_NAME, tf.K2_NAME, tf.K3_NAME, gm.K5_NAME, gm.K6_NAME,
             gm.K7_NAME, gm.GRADS_NAME)
    per_step = {n: launches.get(n, 0) / TABLE_STEPS for n in names}
    want = dict(zip(names, (layers, layers, layers, 2 * layers, layers,
                            layers, layers)))
    check(per_step == want, f"launches per step {per_step}, want {want}")
    emit("moe_train_save_attn", model=MOE_MODEL, layers=layers,
         sequence_length=cfg.sequence_length, remat_policy=cfg.remat_policy,
         timed_steps=TABLE_STEPS, launches_per_step=per_step, **res)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return per_step


# ---- 17c. the model zoo: GPT-MoE served, MLA, sorted dispatch, the examples ---
# GPT-MoE at GPTMoEConfig's defaults (the minGPT width: block 256, vocab 65,
# 4 layers, 4 heads of 32, n_embd 128, 8 experts top-2, capacity 1.25), fp32
GPT_SLOTS, GPT_PAGE, GPT_MAX_SEQ, GPT_PREFILL = 8, 16, 256, 160
GPT_NEW_TOKENS = 64
GPT_WEIGHT_SCALE = 10.0  # on every matrix: at the init's 0.02 the tied head
# answers every prompt with its last token, and the tokens would not move
GPT_PARITY = dict(batch=4, prefill=64)  # teacher-forced K4 vs gather
GPT_DROPLESS_CF = 4.0  # capacity == the row: paged (gather) == dense
# the heads K4 serves GPT-MoE with: Hq 4, Hkv 4 (n_rep 1), D 32, <= 256 keys
GPT_HEADS = (4, 4, 32)
# and one rank's over tp (serve_gpt_moe_tp)
GPT_TP_RANK_HEADS = {2: (2, 2, 32), 4: (1, 1, 32)}
ZOO_TOLERANCE = 1e-4  # fp32 on the card: MLA cache vs full, sorted MoE
MINGPT_ARGS = ("--block_size", "64", "--batch_size", "32", "--steps", "120",
               "--eval_interval", "60", "--sample_tokens", "32")
MINGPT_DENSE_NLL = 2.4  # the JAX example test's bound
MNIST_ARGS = ("--epochs", "2", "--batch_size", "128", "--log_interval",
              "1000")
MNIST_LOSS = 1.6  # the JAX example test's bound
MNIST_REPEATS = 2  # card runs a setting: their spread is the noise
# card (fp32, deterministic) vs CPU test accuracy from one init: 0.16
# points measured on an H100, where TF32 convolutions moved it 0.83
MNIST_CPU_GAP = 0.01


def gpt_moe_model(cfg: GPTMoEConfig) -> GPTMoEForCausalLM:
    """Seeded weights (``init_params`` on the card by default), every
    matrix scaled by GPT_WEIGHT_SCALE."""
    params = gpt_moe.init_params(torch.Generator(device="cuda").manual_seed(0),
                                 cfg)
    check(params["wte"].is_cuda, "gpt_moe.init_params did not default to "
          "the card")
    return GPTMoEForCausalLM.from_params(
        gpt_moe.scale_matrices(params, GPT_WEIGHT_SCALE), cfg, "cuda")


def gpt_traffic(vocab: int, seed: int = 11) -> list:
    """16 prompts of 16-160 tokens; every other one opens with a shared
    32-token (two-page) prefix."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 2 * GPT_PAGE).tolist()
    prompts = []
    for i in range(16):
        if i % 2 == 0:
            tail = int(rng.integers(1, GPT_PREFILL - len(prefix) + 1))
            prompts.append(prefix + rng.integers(0, vocab, tail).tolist())
        else:
            n = int(rng.integers(16, GPT_PREFILL + 1))
            prompts.append(rng.integers(0, vocab, n).tolist())
    return prompts


def phase_gpt_moe_serve() -> dict:
    """GPT-MoE served through the paged engine, its decode on K4: the
    teacher-forced paged decode through K4 against the gather path
    (max |Δlogit|); 16 greedy requests on 8 slots (every outcome ok, one
    capture of each step, K4 once a layer a decode replay, counted from
    a zeroed count; decode tokens/s, TTFT, TPOT); at the dropless
    capacity factor, the paged engine on the gather path against the
    dense engine, token for token (prefix cache off, so both prefill the
    same rows)."""
    cfg = GPTMoEConfig()
    check(cfg.head_dim == GPT_HEADS[2] and cfg.n_head == GPT_HEADS[0],
          f"GPT-MoE's heads moved: {cfg}")
    model = gpt_moe_model(cfg)
    cfg4 = dataclasses.replace(cfg, capacity_factor=GPT_DROPLESS_CF)
    model4 = GPTMoEForCausalLM.from_params(model.tree(), cfg4, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size,
                           (GPT_PARITY["batch"], cfg.block_size),
                           generator=gen, device="cuda")
    with torch.inference_mode():
        tf = {}
        for name, kernel in (("k4", None), ("gather", False)):
            _build.reset_launch_counts()
            tf[name] = teacher_forced_decode_paged(
                model, cfg, tokens, page_size=GPT_PAGE,
                max_seq=cfg.block_size, prefill_len=GPT_PARITY["prefill"],
                kernel=kernel)
            tf[name + "_launches"] = _build.launch_counts["paged_decode"]
        torch.cuda.synchronize()
        parity = max_abs(tf["k4"], tf["gather"])
        decode_steps = cfg.block_size - GPT_PARITY["prefill"]
        check(parity <= PARITY_TOLERANCE,
              f"gpt_moe: K4 vs gather max |dlogit| {parity} > "
              f"{PARITY_TOLERANCE}")
        check(tf["k4_launches"] == cfg.n_layer * decode_steps
              and tf["gather_launches"] == 0,
              f"gpt_moe teacher-forced: K4 launched {tf['k4_launches']} / "
              f"{tf['gather_launches']} times, want "
              f"{cfg.n_layer * decode_steps} / 0")
        prompts = gpt_traffic(cfg.vocab_size)
        kw = dict(max_slots=GPT_SLOTS, max_seq=GPT_MAX_SEQ,
                  prefill_len=GPT_PREFILL, page_size=GPT_PAGE)
        free_engine()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        eng, results, ptrs, stats = serve(model, cfg, prompts, None, **kw)
        launches = _build.launch_counts["paged_decode"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        outcomes = check_served(eng, results, ptrs, stats, "gpt_moe_serve")
        graphs = check_one_capture(eng, "gpt_moe_serve")
        per_step = graphs["decode_launches_per_replay"].get("paged_decode")
        check(per_step == cfg.n_layer,
              f"gpt_moe_serve: paged_decode launched {per_step} times a "
              f"decode replay, want {cfg.n_layer}")
        check(not graphs["prefill_launches_per_replay"].get("paged_decode"),
              "gpt_moe_serve: the prefill step launched K4")
        del eng
        free_engine()
        runs = {}
        for layout, kernel in (("paged_gather", False), ("dense", None)):
            eng, res, _, _ = serve(model4, cfg4, prompts, kernel,
                                   cache_layout=layout.split("_")[0],
                                   prefix_cache=False, **kw)
            check(all(r.outcome == "ok" for r in res),
                  f"gpt_moe {layout}: outcomes {[r.outcome for r in res]}")
            check_one_capture(eng, f"gpt_moe {layout}")
            runs[layout] = [r.tokens for r in res]
            del eng
            free_engine()
        check(runs["paged_gather"] == runs["dense"],
              f"gpt_moe at capacity {GPT_DROPLESS_CF}: paged (gather) "
              f"tokens differ from dense: "
              f"{agreement(runs['paged_gather'], runs['dense'])}")
    moving = sum(len(set(r.tokens)) > 1 for r in results)
    out = dict(
        config={"block_size": cfg.block_size, "vocab": cfg.vocab_size,
                "n_layer": cfg.n_layer, "n_head": cfg.n_head,
                "n_embd": cfg.n_embd, "experts": cfg.num_experts,
                "top_k": cfg.top_k, "capacity_factor": cfg.capacity_factor},
        dtype="float32", weight_scale=GPT_WEIGHT_SCALE,
        teacher_forced_max_abs=parity, tolerance=PARITY_TOLERANCE,
        teacher_forced_k4_launches=tf["k4_launches"], slots=GPT_SLOTS,
        max_seq=GPT_MAX_SEQ, prefill_len=GPT_PREFILL, page_size=GPT_PAGE,
        requests=len(prompts), prompt_lens=[len(p) for p in prompts],
        outcomes=sorted(set(outcomes)), requests_with_moving_tokens=moving,
        kernel_launches=launches, launches_per_decode_step=per_step,
        peak_memory_gb=peak_gb, **stats, **graphs,
        dropless_paged_gather_equals_dense=True)
    emit("gpt_moe_serve", **out)
    return out


def phase_model_zoo() -> dict:
    """On the card: MLA's latent-cache prefill + decode against its full
    forward; ``sorted_moe_forward`` at world 1 against its dense per-token
    loop (float64); LeNet's forward against its CPU run."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    acfg = AttentionConfig(embed_dim=1024, num_heads=16, q_lora_rank=512,
                           kv_lora_rank=256)
    mla = MultiHeadLatentAttention(acfg)
    params = mla.init(gen)
    b, s, p = 4, 256, 128
    x = torch.randn(b, s, acfg.embed_dim, generator=gen, device=dev)
    with torch.inference_mode():
        full = mla(params, x)
        cache = mla.init_cache(b, s)
        check(cache.is_cuda, "MLA init_cache did not default to the card")
        out, cache = mla.prefill(params, x[:, :p], cache)
        outs = [out]
        for t in range(p, s):
            o, cache = mla.decode(params, x[:, t:t + 1], cache,
                                  torch.full((b,), t, device=dev))
            outs.append(o)
        mla_err = max_abs(torch.cat(outs, dim=1), full)
    check(mla_err <= ZOO_TOLERANCE,
          f"MLA cache vs full forward max abs {mla_err} > {ZOO_TOLERANCE}")

    n, h, i, e, k = 512, 1024, 1024, 4, 2
    xs = torch.randn(n, h, generator=gen, device=dev)
    ws = [torch.randn(shape, generator=gen, device=dev) * h ** -0.5
          for shape in ((e, h, i), (e, h, i), (e, i, h))]
    gate_idx = torch.randint(0, e, (n, k), generator=gen, device=dev)
    gate_w = torch.rand(n, k, generator=gen, device=dev)
    with torch.inference_mode():
        got = sorted_moe_forward(xs, gate_idx, gate_w, *ws, axis=None,
                                 num_experts=e)
        want = torch.zeros(n, h, dtype=torch.float64, device=dev)
        g, u, d = (w.double() for w in ws)
        for j in range(k):
            sel = gate_idx[:, j]
            hid = F.silu(torch.einsum("nh,nhi->ni", xs.double(), g[sel])) \
                * torch.einsum("nh,nhi->ni", xs.double(), u[sel])
            want += gate_w[:, j, None].double() * torch.einsum(
                "ni,nih->nh", hid, d[sel])
        sorted_err = max_abs(got, want)
    check(sorted_err <= ZOO_TOLERANCE,
          f"sorted_moe_forward vs dense max abs {sorted_err} > "
          f"{ZOO_TOLERANCE}")

    lparams = lenet.init_params(torch.Generator().manual_seed(0),
                                device="cpu")
    card_params = lenet.init_params(torch.Generator().manual_seed(0))
    check(all(v.is_cuda for v in card_params.values()),
          "lenet.init_params did not default to the card")
    images = torch.rand(256, 1, 28, 28, generator=torch.Generator()
                        .manual_seed(1))
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, allow_tf32=False):
        cpu = lenet.forward(lparams, images)
        card = lenet.forward(card_params, images.to(dev)).cpu()
    lenet_err = max_abs(card, cpu)
    check(lenet_err <= ZOO_TOLERANCE,
          f"LeNet card vs CPU max abs {lenet_err} > {ZOO_TOLERANCE}")
    out = {"mla": {"embed_dim": acfg.embed_dim, "heads": acfg.num_heads,
                   "q_lora_rank": acfg.q_lora_rank,
                   "kv_lora_rank": acfg.kv_lora_rank, "batch": b,
                   "prefill": p, "decode_steps": s - p,
                   "cache_shape": list(cache.shape),
                   "max_abs_vs_full": mla_err},
           "sorted_moe_world1": {"tokens": n, "hidden": h, "experts": e,
                                 "top_k": k, "max_abs_vs_dense": sorted_err},
           "lenet": {"batch": 256, "max_abs_vs_cpu": lenet_err},
           "tolerance": ZOO_TOLERANCE}
    emit("model_zoo", **out)
    return out


def phase_mingpt_train() -> dict:
    """The port's minGPT example on the card: dense, then ``--use_moe
    true``, 120 steps each at block 64; the eval NLL falls (dense below
    the JAX example test's bound); tokens/s and ms a step."""
    out = {}
    for name, extra in (("dense", ()), ("moe", ("--use_moe", "true"))):
        r = train_mingpt.run(list(MINGPT_ARGS + extra))
        check(r["device"].startswith("cuda"), f"mingpt {name} ran on "
              f"{r['device']}")
        check(len(r["evals"]) == 2 and r["evals"][1] < r["evals"][0],
              f"mingpt {name}: the eval NLL did not fall {r['evals']}")
        out[name] = {k: r[k] for k in ("evals", "train_nll", "tokens_per_s",
                                       "step_ms", "sample")}
    check(out["dense"]["evals"][-1] < MINGPT_DENSE_NLL,
          f"mingpt dense: eval NLL {out['dense']['evals'][-1]} >= "
          f"{MINGPT_DENSE_NLL}")
    emit("mingpt_train", args=list(MINGPT_ARGS), **out)
    return out


def mnist_runs(tf32: bool) -> list:
    """MNIST_REPEATS card runs of the MNIST example, cuDNN and matmuls in
    TF32 with cuDNN's default algorithm choice (PyTorch's defaults for
    cuDNN) or in fp32 with deterministic algorithms."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=not tf32,
                                        allow_tf32=tf32):
            return [train_mnist.run(list(MNIST_ARGS))
                    for _ in range(MNIST_REPEATS)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def phase_mnist_train() -> dict:
    """The port's MNIST example on the card, synthetic digits, 2 epochs:
    the last loss below the JAX example test's bound; test accuracy and
    steps/s. The example draws its init from a CPU generator, so the card
    and the CPU start from the same weights: the card runs it in TF32 and
    in deterministic fp32, MNIST_REPEATS times each, and the host's CPU
    once. The fp32 runs equal each other and come within MNIST_CPU_GAP of
    the CPU's accuracy."""
    runs = {"tf32": mnist_runs(True), "fp32_deterministic": mnist_runs(False)}
    for name, rs in runs.items():
        for r in rs:
            check(r["device"].startswith("cuda"),
                  f"mnist {name} ran on {r['device']}")
            check(r["last_loss"] < MNIST_LOSS,
                  f"mnist {name}: last loss {r['last_loss']} >= {MNIST_LOSS}")
    fp32 = runs["fp32_deterministic"]
    check(len({(r["last_loss"], r["test_acc"]) for r in fp32}) == 1,
          f"mnist: deterministic fp32 runs differ {fp32}")
    cpu = train_mnist.run(list(MNIST_ARGS) + ["--device", "cpu"])
    gap = abs(fp32[0]["test_acc"] - cpu["test_acc"])
    check(gap <= MNIST_CPU_GAP, f"mnist: card fp32 accuracy "
          f"{fp32[0]['test_acc']} vs the CPU's {cpu['test_acc']}")
    out = {**fp32[0], "runs": {name: [{k: x[k] for k in (
        "last_loss", "test_acc", "steps_per_s")} for x in rs]
        for name, rs in runs.items()},
        "cpu": {k: cpu[k] for k in ("last_loss", "test_acc")},
        "card_cpu_accuracy_gap": gap}
    emit("mnist_train", args=list(MNIST_ARGS), **out)
    return out


# ---- 11d. the ResNet family through the ImageNet example --------------------
# the example's own entry at ImageNet's shape (224², 1000 classes) on its
# synthetic data, fp32 (TF32 off in main): 3 epochs of 4 steps, one eval
# of 128 images after each
RESNET_ARCHS = ("resnet18", "resnet34")
RESNET_ARGS = ("--image-size", "224", "--num-classes", "1000", "--epochs",
               "3", "--train-samples", "256", "--val-samples", "128", "-b",
               "64", "--print-freq", "100")


def phase_resnet_train() -> dict:
    """resnet18 and resnet34 through ``examples.imagenet.dist_train.run``
    on the card: every loss finite, the last epoch's mean loss below the
    first's, each eval's top-1 and top-5 over its 128 images; images/s
    and ms a step over the epochs after the first (cuDNN's first calls
    left out), peak memory."""
    out = {}
    for arch in RESNET_ARCHS:
        torch.cuda.reset_peak_memory_stats()
        run = dist_train.run(["--arch", arch, *RESNET_ARGS])
        steps = run["steps_per_epoch"]
        later = sum(run["epoch_seconds"][1:])
        row = {"epoch_losses": run["epoch_losses"], "val": run["val"],
               "images_per_s": (len(run["epoch_seconds"]) - 1) * steps * 64
               / later, "ms_per_step": 1e3 * later / (
                   (len(run["epoch_seconds"]) - 1) * steps),
               "first_epoch_s": run["epoch_seconds"][0],
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        check(all(np.isfinite(run["losses"])), f"{arch}: a loss is not finite")
        check(run["epoch_losses"][-1] < run["epoch_losses"][0],
              f"{arch}: the loss did not fall {run['epoch_losses']}")
        check(all(v["samples"] == 128 and 0 <= v["acc5"] <= 100
                  and v["acc1"] <= v["acc5"] for v in run["val"]),
              f"{arch}: eval {run['val']}")
        out[arch] = row
        del run
        free_engine()
    emit("resnet_train", args=list(RESNET_ARGS), dtype="float32", **out)
    return out


# ---- 11d. the examples over the mesh (ROADMAP 9c) ---------------------------
# the training examples at 40 steps: at their 8-10 the loss on the
# synthetic stream (uniform tokens) is flat within its noise; the fsdp
# example then resumes for 2
EXAMPLE_STEPS, EXAMPLE_RESUME_STEPS = 40, 2


def example_runs(world: int, root: str) -> list:
    """(name, module under scaletorch_tpu_torch.examples, argv, the
    kernels its run must launch) of the examples over ``world`` cards:
    on one card each new example at the mesh one card allows (ep, pp and
    cp at 1; the device-mesh demos need 4 ranks), on four the reference
    examples' defaults (minGPT and MNIST data parallel, MNIST --fsdp, the
    demos), the training examples at EXAMPLE_STEPS. Their K1-K3 run at
    head_dim 16."""
    flash = (tf.K1_NAME, tf.K2_NAME, tf.K3_NAME)
    experts = (gm.K5_NAME, gm.K6_NAME, gm.K7_NAME)
    ckpt = os.path.join(root, "fsdp_ckpt")
    one = world == 1
    steps = ["--steps", str(EXAMPLE_STEPS)]
    runs = [
        ("fsdp", "fsdp.train_fsdp", steps + ["--checkpoint-dir", ckpt,
                                             "--log_interval", "10"], ()),
        ("fsdp_resumed", "fsdp.train_fsdp",
         ["--steps", str(EXAMPLE_RESUME_STEPS), "--checkpoint-dir", ckpt],
         ()),
        ("moe", "moe.train_moe", steps + ["--ep", "1" if one else "2"],
         flash + experts),
        *((f"pipeline_{e}", "pipeline.train_pp",
           steps + ["--engine", e, "--pp", "1" if one else "2"], flash)
          for e in ("afab", "interleaved", "memory_chunked")),
        *((f"longctx_{st}", "longctx.train_longctx",
           steps + ["--cp", "1" if one else "4", "--strategy", st], flash)
          for st in ("ring", "ulysses")),
    ]
    if not one:
        runs = [("mingpt_dp", "mingpt.train_mingpt", [], ()),
                ("mnist_dp", "mnist.train_mnist", [], ()),
                ("mnist_fsdp", "mnist.train_mnist", ["--fsdp"], ()),
                *runs,
                ("device_mesh", "device_mesh.mesh_demos", [], ())]
    return runs


def falling(losses) -> bool:
    """The mean of the last quarter of the losses below the first's."""
    n = max(len(losses) // 4, 1)
    return float(np.mean(losses[-n:])) < float(np.mean(losses[:n]))


def run_examples(world: int, dev) -> dict:
    """Every run of ``example_runs(world)`` on this rank, its launches
    counted from zero: its seconds, losses (first, last, falling), the
    launches of the kernels it must launch (each nonzero) and the K1-K3
    and K5-K7 launches of the run; the moe example with the grouped-MLP
    kernels on. Asserted on every rank: finite losses that fall (the
    resumed fsdp run and the demos aside)."""
    import importlib

    from scaletorch_tpu_torch import dist as stdist

    root = os.path.abspath(os.path.join(_build.BUILD_DIR.parent,
                                        "examples"))
    if stdist.process_index() == 0:
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
    if world > 1:
        stdist.barrier()
    out = {}
    for name, module, argv, kernels in example_runs(world, root):
        mod = importlib.import_module(
            f"scaletorch_tpu_torch.examples.{module}")
        before = os.environ.get(qwen3_moe.GROUPED_MLP_ENV)
        if module == "moe.train_moe":
            os.environ[qwen3_moe.GROUPED_MLP_ENV] = "1"
        _build.reset_launch_counts()
        t0 = time.monotonic()
        try:
            res = mod.run(argv)
            torch.cuda.synchronize(dev)
        finally:
            if before is None:
                os.environ.pop(qwen3_moe.GROUPED_MLP_ENV, None)
            else:
                os.environ[qwen3_moe.GROUPED_MLP_ENV] = before
        launches = {k: _build.launch_counts.get(k, 0) for k in (
            tf.K1_NAME, tf.K2_NAME, tf.K3_NAME, gm.K5_NAME, gm.K6_NAME,
            gm.K7_NAME)}
        row = {"argv": argv, "seconds": time.monotonic() - t0,
               "launches": {k: v for k, v in launches.items() if v}}
        losses = res.get("losses") if isinstance(res, dict) else None
        if losses:
            row.update(first_loss=losses[0], last_loss=losses[-1],
                       steps=len(losses), loss_falling=falling(losses))
            check(all(np.isfinite(losses)),
                  f"examples {name}: losses {losses}")
            check(name == "fsdp_resumed" or row["loss_falling"],
                  f"examples {name}: the loss does not fall: {losses}")
        if name == "fsdp_resumed":
            check(res["start_step"] == EXAMPLE_STEPS,
                  f"examples {name}: resumed at {res['start_step']}")
        missing = [k for k in kernels if not launches[k]]
        check(not missing, f"examples {name}: no launch of {missing}")
        out[name] = row
        gc.collect()
        torch.cuda.empty_cache()
    if world > 1:
        stdist.barrier()
    if stdist.process_index() == 0:
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase_examples() -> dict:
    """The examples over the mesh on one card (``run_examples(1)``)."""
    out = run_examples(1, torch.device("cuda"))
    emit("examples", world=1, runs=out,
         not_run={"device_mesh": "needs an even world of 4 or more ranks "
                                 "(the four-card group runs it)"})
    return out


# ---- 11e. the runtime on one card -------------------------------------------
RUNTIME_STEPS = 6            # the preemption and rollback runs
SIGTERM_AT, NAN_AT, BAD_READ_AT = 3, 5, 3
GRACE_S = 30.0               # a common preemption grace period
HANG_TIMEOUT_S, HANG_S, WATCHDOG_POLL_S = 1.0, 3.0, 0.1
STALL_FACTOR = 3             # the device stall lasts ~3x the watchdog timeout
TELEMETRY_STEPS, PROFILE_WINDOW = 8, "3:4"
SLOW_AT, SLOW_S = 6, 3.0
OVERHEAD_WARMUP, OVERHEAD_STEPS = 2, 5
# telemetry overhead: runs without and with, in blocks of (without, with,
# with, without), so that a drift over the phase falls on both sides
OVERHEAD_BLOCKS = 3
CLI_LAYERS = 2               # the command-line drill's depth cut
POISON_AT, POISON_SLOT = 80, 3   # a decode step of the second wave
STORM_AT, STORM_COUNT, DEADLINE_AT = 5, 12, 20
STORM_CAPACITY = SLOTS  # the first wave queues whole, the storm overflows
# kernel names of K1-K3 (bf16) in a torch.profiler trace
FLASH_TRACE_NAMES = {tf.K1_NAME: "flash_fwd_mma", tf.K2_NAME: "flash_dq_mma",
                     tf.K3_NAME: "flash_dkv_mma"}


def runtime_root(name: str) -> str:
    """An empty directory build/runtime/<name>."""
    root = os.path.join(_build.BUILD_DIR.parent, "runtime", name)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    return root


def runtime_cfg(root: str, checkpoint_dir=None, **kw):
    """The headline row cut to DRILL_LAYERS, fed from
    ``root``/train.jsonl, a record every step, asynchronous checkpoints
    keeping the newest."""
    cfg = make_bench_args(MODEL, seq=TRAIN_SEQ, gc=True)
    return dataclasses.replace(
        cfg, synthetic_data=False, num_hidden_layers=DRILL_LAYERS,
        dataset_name=os.path.join(root, "train.jsonl"),
        checkpoint_dir=checkpoint_dir, keep_n_checkpoints=1,
        async_checkpointing=True, total_train_steps=RUNTIME_STEPS,
        log_frequency=1, checkpoint_retry_base_delay=0.05,
        data_retry_base_delay=0.01,
        crash_report_dir=os.path.join(root, "crash"), **kw)


def train_launches_per_step(layers=None) -> dict:
    """K1-K3 launches of a GC step of the headline row (``layers`` of
    it; default all)."""
    layers = layers or model_config(MODEL).num_hidden_layers
    return {tf.K1_NAME: 2 * layers, tf.K2_NAME: layers, tf.K3_NAME: layers}


def storages(trainer) -> list:
    return [t.data_ptr() for t in
            tree_leaves(trainer.params) + tree_leaves(trainer.opt_state)]


def close_trainer(trainer) -> None:
    trainer.close()
    del trainer
    free_engine()


def check_train_launches(log: dict, what: str, steps: int,
                         layers=DRILL_LAYERS) -> None:
    want = train_launches_per_step(layers)
    check(len(log["train"]) == steps and all(d == want for d in log["train"]),
          f"{what}: launches per train step {log['train']}, want {steps} "
          f"x {want}")


def sigterm_run(root: str, ckpt: str, save_frequency: int) -> dict:
    """A run with the SIGTERM drill after step SIGTERM_AT: train() must
    return preempted with the emergency checkpoint at that step on disk.
    The seconds from the signal to train()'s return (the checkpoint is
    written and readable then) and their parts."""
    t = Trainer(runtime_cfg(root, ckpt, save_frequency=save_frequency,
                            ft_sigterm_at_step=SIGTERM_AT,
                            handle_preemption=True),
                tokenizer=ByteTokenizer())
    sent = []

    def deliver(signum):  # the real signal, timed
        sent.append(time.perf_counter())
        os.kill(os.getpid(), signum)

    t.resilience.injector.deliver_signal = deliver
    log = launch_log(t)
    before = signal.getsignal(signal.SIGTERM)
    t.train()
    returned = time.perf_counter()
    mgr = t.checkpoint_manager
    check(t.preempted and t.emergency_checkpoint_saved
          and t.global_step == SIGTERM_AT
          and mgr.latest_step() == SIGTERM_AT,
          f"SIGTERM drill: preempted {t.preempted}, saved "
          f"{t.emergency_checkpoint_saved}, step {t.global_step}, latest "
          f"{mgr.latest_step()}")
    check(signal.getsignal(signal.SIGTERM) is before,
          "the preemption handler outlived train()")
    check_train_launches(log, "SIGTERM drill", SIGTERM_AT)
    row = {"save_frequency": save_frequency,
           "sigterm_to_readable_s": returned - sent[0],
           "within_grace": returned - sent[0] <= GRACE_S,
           **t.emergency_timing,
           "checkpoint_bytes": mgr.step_bytes(SIGTERM_AT)}
    close_trainer(t)
    return row


def cli_sigterm(root: str) -> dict:
    """``python -m scaletorch_tpu_torch.train`` with the SIGTERM drill, the
    0.6B width cut to CLI_LAYERS layers: exit code 0, the logged line, the
    step on disk."""
    ckpt = os.path.join(root, "cli")
    args = [sys.executable, "-m", "scaletorch_tpu_torch.train"]
    for key, value in preset(MODEL).items():
        if key != "num_hidden_layers":
            args += [f"--{key}", str(value)]
    args += ["--num_hidden_layers", str(CLI_LAYERS),
             "--sequence_length", str(TRAIN_SEQ),
             "--gradient_checkpointing", "true", "--synthetic_data", "true",
             "--total_train_steps", "4", "--log_frequency", "1",
             "--checkpoint_dir", ckpt, "--ft_sigterm_at_step", "2"]
    t0 = time.monotonic()
    proc = subprocess.run(args, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    out = proc.stdout + proc.stderr
    line = next((s for s in out.splitlines()
                 if "emergency checkpoint saved" in s), None)
    check(proc.returncode == 0 and line is not None
          and os.listdir(ckpt) == ["2"],
          f"CLI SIGTERM drill: exit {proc.returncode}, line {line!r}, "
          f"checkpoints {os.listdir(ckpt) if os.path.isdir(ckpt) else None}"
          f"; output tail {out[-2000:]!r}")
    return {"exit_code": proc.returncode, "logged": line.split("] ", 1)[-1],
            "layers": CLI_LAYERS, "seconds": time.monotonic() - t0}


def phase_runtime_preempt() -> dict:
    """SIGTERM against a straight run: the emergency checkpoint, its
    seconds, a bit-for-bit resume, and the command line's exit code."""
    root = runtime_root("preempt")
    emit("runtime_disk", free_gb=shutil.disk_usage(root).free / 1e9,
         checkpoint_gb_expected=3.4)
    write_docs(os.path.join(root, "train.jsonl"), DATA_DOCS, seed=11)
    steps = list(range(1, RUNTIME_STEPS + 1))
    ckpt = os.path.join(root, "ckpt")

    # two straight runs, the first checkpointed every 2 steps
    straight = []
    for save_frequency in (2, 0):
        t = Trainer(runtime_cfg(root, ckpt if save_frequency else None,
                                save_frequency=save_frequency),
                    tokenizer=ByteTokenizer())
        log = launch_log(t)
        t.train()
        check_train_launches(log, "straight run", RUNTIME_STEPS)
        straight.append(readings(t, steps))
        close_trainer(t)
        shutil.rmtree(ckpt, ignore_errors=True)
    a1, a2 = straight
    check(a1["lr"] == a2["lr"], f"learning rates differ: {a1['lr']} "
          f"{a2['lr']}")
    spread = max(abs(x - y) for x, y in zip(a1["loss"], a2["loss"]))

    in_flight = sigterm_run(root, ckpt, save_frequency=2)
    t = Trainer(runtime_cfg(root, ckpt, save_frequency=2, resume="must"),
                tokenizer=ByteTokenizer())
    restore_s = t.checkpoint_manager.last_restore["seconds"]
    check(t.global_step == SIGTERM_AT and t.loader.position == SIGTERM_AT,
          f"resumed at step {t.global_step}, loader {t.loader.position}")
    log = launch_log(t)
    t.train()
    check_train_launches(log, "resumed run", RUNTIME_STEPS - SIGTERM_AT)
    resumed = readings(t, steps[SIGTERM_AT:])
    close_trainer(t)
    shutil.rmtree(ckpt)
    check(resumed["lr"] == a1["lr"][SIGTERM_AT:],
          f"resumed learning rates {resumed['lr']}")
    diff = max(abs(x - y) for x, y in zip(resumed["loss"],
                                          a1["loss"][SIGTERM_AT:]))
    check(diff <= spread, f"resumed run differs by {diff} > {spread}, the "
          "spread of two straight runs")
    idle = sigterm_run(root, ckpt, save_frequency=0)
    shutil.rmtree(ckpt)
    cli = cli_sigterm(root)
    shutil.rmtree(root)
    row = {"model": MODEL, "layers": DRILL_LAYERS,
           "sequence_length": TRAIN_SEQ,
           "steps": RUNTIME_STEPS, "sigterm_after_step": SIGTERM_AT,
           "grace_s": GRACE_S, "with_save_in_flight": in_flight,
           "without_save_in_flight": idle, "restore_s": restore_s,
           "straight": a1, "straight_again": a2, "limit": spread,
           "resumed": resumed, "resumed_max_abs_diff": diff,
           "resumed_bit_equal": diff == 0.0, "cli": cli,
           "launches_per_train_step": train_launches_per_step(DRILL_LAYERS),
           "nvidia_smi": card_name_and_power_limit()}
    emit("runtime_preempt", **row)
    return row


def phase_runtime_rollback() -> dict:
    """A NaN after step NAN_AT under the rollback policy, a corrupt read
    at stream position BAD_READ_AT and one failed save, in one run."""
    root = runtime_root("rollback")
    write_docs(os.path.join(root, "train.jsonl"), DATA_DOCS, seed=11)
    t = Trainer(runtime_cfg(root, os.path.join(root, "ckpt"),
                            save_frequency=2, ft_nan_at_step=NAN_AT,
                            divergence_policy="rollback",
                            ft_bad_batch_at_step=BAD_READ_AT,
                            ft_fail_saves=1),
                tokenizer=ByteTokenizer())
    before = storages(t)
    log = launch_log(t)
    t0 = time.perf_counter()
    t.train()
    seconds = time.perf_counter() - t0
    counters = t.resilience.counters()
    losses = [r["loss"] for r in t.history]
    mgr = t.checkpoint_manager
    check(t.global_step == RUNTIME_STEPS
          and [r["step"] for r in t.history] == list(
              range(1, RUNTIME_STEPS + 1)),
          f"rollback run ended at {t.global_step}, records "
          f"{[r['step'] for r in t.history]}")
    check(all(np.isfinite(losses)), f"losses {losses}")
    check(counters["rollbacks"] == 1 and counters["nonfinite_losses"] == 1,
          f"counters {counters}")
    check(storages(t) == before,
          "a parameter or optimizer state tensor moved in the rollback")
    check(t.loader.skipped_positions == [BAD_READ_AT],
          f"skipped {t.loader.skipped_positions}")
    # 7 step batches read (step NAN_AT twice) + the one skipped region
    check(t.loader.position == RUNTIME_STEPS + 2 and t._loader_skew == 2,
          f"loader at {t.loader.position}, skew {t._loader_skew}")
    check(t.resilience.injector.fail_saves == 0
          and mgr.latest_step() == RUNTIME_STEPS,
          f"failed saves left {t.resilience.injector.fail_saves}, latest "
          f"{mgr.latest_step()}")
    check_train_launches(log, "rollback run", RUNTIME_STEPS + 1)
    row = {"model": MODEL, "nan_after_step": NAN_AT,
           "bad_read_at": BAD_READ_AT, "counters": counters,
           "losses": losses, "restore_s": mgr.last_restore["seconds"],
           "restored_step": mgr.last_restore["step"],
           "skipped_positions": t.loader.skipped_positions,
           "loader_position": t.loader.position,
           "saves": [dict(x) for x in mgr.saves], "train_s": seconds,
           "storages_kept": True,
           "nvidia_smi": card_name_and_power_limit()}
    close_trainer(t)
    shutil.rmtree(root)
    emit("runtime_rollback", **row)
    return row


def tokens_per_second(cfg) -> dict:
    """train() over OVERHEAD_WARMUP, then OVERHEAD_STEPS timed steps."""
    t = Trainer(cfg)
    t.train(num_steps=OVERHEAD_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.train(num_steps=OVERHEAD_STEPS)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / OVERHEAD_STEPS
    tok_s = t.loader.tokens_per_step / step_s
    close_trainer(t)
    return {"tokens_per_second": tok_s, "step_s": step_s}


def alternated() -> list:
    """The order of the overhead runs: OVERHEAD_BLOCKS blocks of
    (without, with, with, without)."""
    return ["without", "with", "with", "without"] * OVERHEAD_BLOCKS


def overhead(off: list, on: list) -> dict:
    """One metric's runs without and with telemetry: the medians' change
    and each side's range, both relative to the median without; the
    change is ``separated`` from the run-to-run spread only when the two
    sides' ranges do not overlap."""
    base = statistics.median(off)
    return {"median_change": statistics.median(on) / base - 1,
            "range_without": (max(off) - min(off)) / base,
            "range_with": (max(on) - min(on)) / base,
            "separated": max(off) < min(on) or max(on) < min(off)}


def window_launches(capture: dict) -> dict:
    by = capture.get("by_name", {})
    return {k: sum(n for name, n in by.items() if sub in name)
            for k, sub in FLASH_TRACE_NAMES.items()}


def phase_runtime_telemetry() -> dict:
    """Training with telemetry on: the trace's phases, the JSONL records,
    a manual and a slow-step profiler window (K1/K2/K3 counted in the
    trace, no record lost), a SIGUSR1 snapshot; then tokens/s without
    and with telemetry."""
    root = runtime_root("telemetry")
    tel = os.path.join(root, "tel")
    base = dataclasses.replace(make_bench_args(MODEL, seq=TRAIN_SEQ, gc=True),
                               log_frequency=1)
    t = Trainer(dataclasses.replace(
        base, total_train_steps=TELEMETRY_STEPS, telemetry_dir=tel,
        profile_steps=PROFILE_WINDOW, profile_on_slow_step=2.0,
        profile_window_steps=1, profile_max_captures=1,
        ft_slow_step_at_step=SLOW_AT, ft_slow_step_seconds=SLOW_S))
    log = launch_log(t)
    inner, calls = t.step_fn, []

    def poke(*args):  # a real SIGUSR1 during step 2
        calls.append(1)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGUSR1)
        return inner(*args)

    t.step_fn = poke
    t.train()
    check_train_launches(log, "telemetry run", TELEMETRY_STEPS,
                         layers=None)
    captures = list(t.telemetry.profiler.captures)
    close_trainer(t)
    trace = load_trace(os.path.join(tel, "trace_proc0.trace.json"))
    for phase in ("step_boundary", "data_fetch", "step_dispatch"):
        seen = [e["args"]["step"] for e in trace if e["name"] == phase]
        check(seen == list(range(TELEMETRY_STEPS)),
              f"trace phase {phase} at steps {seen}")
    records = [r for r in read_jsonl(os.path.join(tel, "events_proc0.jsonl"))
               if r["kind"] == "train_step"]
    check([r["step"] for r in records] == list(
        range(1, TELEMETRY_STEPS + 1)),
          f"JSONL train_step records {[r['step'] for r in records]}")
    start, stop = (int(x) for x in PROFILE_WINDOW.split(":"))
    check([(c["trigger"], c["start_step"], c["stop_step"])
           for c in captures] == [("manual", start, stop),
                                  ("slow_step", SLOW_AT + 1, SLOW_AT + 2)],
          f"profiler windows {captures}")
    want = train_launches_per_step()
    for c in captures:
        got = window_launches(c)
        check(c["launches_lost"] == 0 and got == want,
              f"{c['trigger']} window: K1/K2/K3 records {got}, want {want}; "
              f"{c['launches_lost']} of {c['launches']} launches lost")
    with open(os.path.join(tel, "live_snapshot_1.json")) as f:
        snap = json.load(f)
    check(snap["step"] == 1 and snap["span_tail"]
          and [r["step"] for r in snap["monitor_records"]] == [1],
          f"SIGUSR1 snapshot at step {snap['step']}, "
          f"{len(snap['span_tail'])} spans, records "
          f"{[r['step'] for r in snap['monitor_records']]}")
    # without and with telemetry, in turns
    runs = {"without": [], "with": []}
    for i, name in enumerate(alternated()):
        cfg = base if name == "without" else dataclasses.replace(
            base, telemetry_dir=os.path.join(root, f"tel_overhead{i}"))
        runs[name].append(tokens_per_second(cfg))
    off = {k: [r[k] for r in runs["without"]] for k in runs["without"][0]}
    on = {k: [r[k] for r in runs["with"]] for k in runs["with"][0]}
    shutil.rmtree(root)
    row = {"model": MODEL, "steps": TELEMETRY_STEPS,
           "windows": [{k: c[k] for k in ("trigger", "start_step",
                                          "stop_step", "kernels",
                                          "device_us", "launches",
                                          "launches_lost", "start_s",
                                          "stop_s")}
                       | {"flash_launches": window_launches(c)}
                       for c in captures],
           "trace_events": len(trace), "jsonl_records": len(records),
           "snapshot_spans": len(snap["span_tail"]),
           "without_telemetry": off, "with_telemetry": on,
           "overhead_per_step_ms": 1e3 * (statistics.median(on["step_s"])
                                          - statistics.median(off["step_s"])),
           "step_s_overhead": overhead(off["step_s"], on["step_s"]),
           "nvidia_smi": card_name_and_power_limit()}
    emit("runtime_telemetry", **row)
    return row


def calibrated_sleep_cycles(seconds: float) -> int:
    """``torch.cuda._sleep`` cycles that spin the card about ``seconds``."""
    cycles = 100_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return int(cycles * seconds / (start.elapsed_time(end) / 1e3))


def phase_runtime_watchdog() -> dict:
    """The trainer's hang watchdog on an injected hang, then on a stall
    of the card while the main thread waits in torch.cuda.synchronize()
    and in .item(): each must fire (a recording exit with 43) while the
    main thread is still blocked, within the timeout and a poll, and
    write a crash report holding the thread stacks, the config
    fingerprint, the monitor records and the span tail."""
    root = runtime_root("watchdog")
    crash = os.path.join(root, "crash")
    cfg = dataclasses.replace(
        make_bench_args(MODEL, seq=TRAIN_SEQ, gc=True), log_frequency=1,
        total_train_steps=3, ft_hang_at_step=2, ft_hang_seconds=HANG_S,
        crash_report_dir=crash, telemetry_dir=os.path.join(root, "tel"))
    t = Trainer(cfg)
    exits, infos, hang = [], [], []
    t._watchdog_exit = lambda code: exits.append((code, time.monotonic()))
    report = t._watchdog_crash_report

    def recording_report(info):
        infos.append(info)
        return report(info)

    t._watchdog_crash_report = recording_report
    maybe_hang = t.resilience.injector.maybe_hang

    def timed_hang(step):
        t0 = time.monotonic()
        maybe_hang(step)
        if step == cfg.ft_hang_at_step:
            hang.extend((t0, time.monotonic()))

    t.resilience.injector.maybe_hang = timed_hang
    t.train(num_steps=1)  # warm, before the watchdog is armed
    os.environ["SCALETORCH_TPU_FT_HANG_TIMEOUT"] = str(HANG_TIMEOUT_S)
    try:
        t.train(num_steps=2)
    finally:
        del os.environ["SCALETORCH_TPU_FT_HANG_TIMEOUT"]

    def read_report(what: str, inside: str) -> dict:
        names = os.listdir(crash)
        check(len(names) == 1, f"{what}: crash reports {names}")
        path = os.path.join(crash, names[0])
        with open(path) as f:
            rep = json.load(f)
        os.remove(path)
        main = rep["thread_stacks"].get("MainThread", "")
        check(inside in main and rep["config_fingerprint"]
              and rep["monitor_records"] and rep["span_timeline_tail"],
              f"{what}: crash report lacks the main thread in {inside!r}, "
              f"the fingerprint, the monitor records or the span tail: "
              f"{main[-600:]!r}")
        return {"main_thread_tail": main.strip().splitlines()[-1],
                "monitor_records": len(rep["monitor_records"]),
                "spans": len(rep["span_timeline_tail"])}

    limit = HANG_TIMEOUT_S + max(0.05, min(HANG_TIMEOUT_S / 4, 5.0)) + 0.5
    check(len(exits) == 1 and exits[0][0] == WATCHDOG_EXIT_CODE
          and hang[0] < exits[0][1] < hang[1]
          and infos[0]["stalled_seconds"] <= limit,
          f"injected hang: exits {exits}, hang {hang}, stalled "
          f"{infos and infos[0]['stalled_seconds']}")
    rows = {"injected_hang": {
        "stalled_s_at_fire": infos[0]["stalled_seconds"],
        "fired_after_hang_began_s": exits[0][1] - hang[0],
        **read_report("injected hang", "maybe_hang")}}
    cycles = calibrated_sleep_cycles(STALL_FACTOR * HANG_TIMEOUT_S)
    probe = torch.zeros(1, device="cuda")
    for name, wait, inside in (
            ("synchronize", torch.cuda.synchronize, "synchronize"),
            ("item", lambda: probe.add(1).item(), ".item()")):
        exits.clear()
        infos.clear()
        wd = HangWatchdog(HANG_TIMEOUT_S, poll_interval=WATCHDOG_POLL_S,
                          crash_report=recording_report,
                          exit_fn=t._watchdog_exit)
        with wd:
            wd.beat(step=t.global_step, phase=f"device_stall_{name}")
            t0 = time.monotonic()
            torch.cuda._sleep(cycles)
            wait()
            t1 = time.monotonic()
        fired = exits[0][1] if exits else None
        check(len(exits) == 1 and exits[0][0] == WATCHDOG_EXIT_CODE
              and fired < t1
              and fired - t0 <= HANG_TIMEOUT_S + WATCHDOG_POLL_S + 0.5,
              f"device stall in {name}: exits {exits} (stall began "
              f"{t0:.3f}, the wait returned {t1:.3f}): the watchdog must "
              "fire while the main thread is blocked")
        rows[f"device_stall_{name}"] = {
            "stall_s": t1 - t0, "fired_after_s": fired - t0,
            "fired_before_wait_returned_s": t1 - fired,
            **read_report(f"device stall in {name}", inside)}
    close_trainer(t)
    shutil.rmtree(root)
    row = {"timeout_s": HANG_TIMEOUT_S, "poll_s": WATCHDOG_POLL_S,
           "exit_code": WATCHDOG_EXIT_CODE, **rows,
           "nvidia_smi": card_name_and_power_limit()}
    emit("runtime_watchdog", **row)
    return row


def host_us_per_span(n: int = 20000) -> float:
    """Host µs of one span opened and closed on a memory-only tracer."""
    tracer = SpanTracer(None, role="serve")
    t0 = time.perf_counter()
    for _ in range(n):
        with tracer.span("decode", active=SLOTS):
            pass
    return 1e6 * (time.perf_counter() - t0) / n


def serve_drill(what: str, model, cfg, prompts, new_tokens: int = 64,
                around=None, **kw):
    """A new graphed engine (launch counts reset first) runs ``prompts``
    through ``run()``, inside the context ``around(eng)`` when given:
    then one capture of each step, every static buffer where it was, one
    terminal outcome per request and page conservation."""
    free_engine()
    _build.reset_launch_counts()
    eng = serving_engine(model, cfg, **kw)
    ptrs = static_pointers(eng)
    ids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    if around is None:
        results = eng.run()
    else:
        with around(eng):
            results = eng.run()
    finish_drill(eng, ptrs, what)
    return eng, [results[i] for i in ids]


def finish_drill(eng, ptrs: dict, what: str) -> dict:
    graphs = check_one_capture(eng, what)
    check(static_pointers(eng) == ptrs, f"{what}: a static buffer moved")
    m = eng.metrics
    check(m.requests_submitted == sum(m.outcomes.values())
          == len(eng._results) and eng.pending == 0,
          f"{what}: {m.requests_submitted} submitted, outcomes "
          f"{m.outcomes}")
    eng.allocator.check_conservation()
    return graphs


def phase_runtime_serve(model32) -> dict:
    """The engine's runtime at Qwen3-0.6B width, bf16, 8 slots, graphed:
    telemetry on the serve traffic, a NaN poison, submit and deadline
    storms, the serving watchdog, a SIGTERM drain and the warm prefix
    import; one capture of each step and no static buffer moved in
    every engine."""
    cfg = model_config(MODEL, dtype=torch.bfloat16)
    model = LlamaForCausalLM.from_params(dict(model32.named_parameters()),
                                         cfg)
    prompts = traffic(cfg.vocab_size)
    root = runtime_root("serve")
    layers = cfg.num_hidden_layers
    row = {}
    with torch.inference_mode():
        # the serve traffic without and with tracer + exporter, in turns
        runs = {"without": [], "with": []}
        for i, name in enumerate(alternated()):
            kw = {}
            if name == "with":
                kw = dict(tracer=SpanTracer(
                    os.path.join(root, f"serve{i}.trace.json"),
                    role="serve"),
                    exporter=TelemetryExporter(
                        os.path.join(root, f"serve{i}.jsonl")))
            free_engine()
            _build.reset_launch_counts()
            eng, results, _, stats = serve(model, cfg, prompts, None, **kw)
            graphs = check_one_capture(eng, f"serve {name} telemetry")
            check(graphs["decode_launches_per_replay"].get("paged_decode")
                  == layers, f"K4 launches a replay {graphs}")
            runs[name].append(([r.tokens for r in results], stats))
            if name == "with":
                eng.tracer.close()
                eng.exporter.close()
                trace = load_trace(os.path.join(root, f"serve{i}.trace.json"))
                decode_spans = sum(e["name"] == "decode" for e in trace)
                check(decode_spans == stats["decode_steps"],
                      f"{decode_spans} decode spans for "
                      f"{stats['decode_steps']} decode steps")
                records = read_jsonl(os.path.join(root, f"serve{i}.jsonl"))
            del eng
        clean = runs["without"][0][0]
        check(all(tokens == clean for name in runs
                  for tokens, _ in runs[name]),
              "telemetry changed the greedy tokens")
        keys = ("tpot_p50_s", "decode_tokens_per_s", "tokens_per_s")
        row["telemetry"] = {
            name: {k: [stats[k] for _, stats in runs[name]] for k in keys}
            for name in runs}
        for k in keys:
            row["telemetry"][f"{k}_overhead"] = overhead(
                row["telemetry"]["without"][k], row["telemetry"]["with"][k])
        row["telemetry"].update(spans=len(trace), jsonl_records=len(records),
                                host_us_per_span=host_us_per_span())
        runs.clear()

        # a NaN poison in slot POISON_SLOT before decode step POISON_AT
        eng, results = serve_drill(
            "poison", model, cfg, prompts,
            injector=ServingFaultInjector(nan_logits_at_step=POISON_AT,
                                          nan_logits_slot=POISON_SLOT))
        bad = [i for i, r in enumerate(results) if r.outcome == "quarantined"]
        check(len(bad) == 1, f"poison: quarantined requests {bad}")
        others = [i for i in range(len(results)) if i not in bad]
        check(all(results[i].outcome == "ok" and results[i].tokens == clean[i]
                  for i in others),
              "poison: another request lost its clean run's tokens")
        row["poison"] = {"quarantined_request": bad[0],
                         "tokens_before": len(results[bad[0]].tokens),
                         "others_token_equal": len(others)}
        del eng

        # a submit storm into a bounded queue, then a deadline storm
        eng, results = serve_drill(
            "storms", model, cfg, prompts[:SLOTS],
            queue_capacity=STORM_CAPACITY,
            injector=ServingFaultInjector(
                submit_storm_at_step=STORM_AT,
                submit_storm_count=STORM_COUNT,
                deadline_storm_at_step=DEADLINE_AT))
        outcomes = {k: v for k, v in eng.metrics.outcomes.items() if v}
        want = {"shed": STORM_COUNT - STORM_CAPACITY,
                "timeout": SLOTS + STORM_CAPACITY}
        check(outcomes == want and eng.metrics.requests_submitted
              == SLOTS + STORM_COUNT,
              f"storms: outcomes {outcomes}, want {want}")
        row["storms"] = {"outcomes": outcomes,
                         "submitted": eng.metrics.requests_submitted}
        del eng

        # the serving watchdog on a stalled decode step
        exits = []
        tracer = SpanTracer(None, role="serve")

        def watched(eng):
            return make_serving_watchdog(
                eng, HANG_TIMEOUT_S, crash_report_dir=root,
                exit_fn=exits.append)

        eng, results = serve_drill(
            "serving watchdog", model, cfg, prompts[:SLOTS], new_tokens=16,
            around=watched, tracer=tracer,
            injector=ServingFaultInjector(slow_decode_at_step=5,
                                          slow_decode_seconds=HANG_S))
        reports = [f for f in os.listdir(root)
                   if f.startswith("crash_report")]
        check(exits == [SERVING_STALL_EXIT_CODE] and len(reports) == 1,
              f"serving watchdog: exits {exits}, reports {reports}")
        with open(os.path.join(root, reports[0])) as f:
            rep = json.load(f)
        check(rep["serving"] and rep["counters"]["requests_submitted"]
              == SLOTS and rep["span_timeline_tail"]
              and "sleep" in rep["thread_stacks"].get("MainThread", ""),
              "serving watchdog: the report lacks the counters, the span "
              "tail or the main thread in the stall")
        row["serving_watchdog"] = {"exit_code": exits[0],
                                   "spans": len(rep["span_timeline_tail"]),
                                   "outcomes": sorted({r.outcome
                                                       for r in results})}
        del eng

        # a real SIGTERM once 4 tokens a slot are out: run() drains
        handler = PreemptionHandler().install()
        emitted = []

        def on_tokens(slot, rid, toks):
            emitted.extend(toks)
            if len(emitted) == 4 * SLOTS:
                os.kill(os.getpid(), signal.SIGTERM)

        try:
            eng, results = serve_drill(
                "preemption", model, cfg, prompts, new_tokens=16,
                preemption=handler, on_tokens=on_tokens)
        finally:
            handler.uninstall()
        outcomes = {k: v for k, v in eng.metrics.outcomes.items() if v}
        check(handler.requested and eng.draining
              and outcomes == {"ok": SLOTS, "aborted": len(prompts) - SLOTS},
              f"preemption: outcomes {outcomes}, draining {eng.draining}")
        row["preemption"] = {"outcomes": outcomes}
        del eng

        # warm prefix import: A serves the shared-prefix half twice, B
        # imports A's pages and serves it once
        shared = prompts[::2]
        free_engine()
        _build.reset_launch_counts()
        a = serving_engine(model, cfg)
        a_ptrs = static_pointers(a)
        first = [a.submit(p, max_new_tokens=64) for p in shared]
        a.run()
        ids = [a.submit(p, max_new_tokens=64) for p in shared]
        a_res = a.run()
        finish_drill(a, a_ptrs, "warm donor")
        a_tokens = [a_res[i].tokens for i in ids]
        t0 = time.perf_counter()
        pmap = a.export_prefix_map()
        pages = [p for c in pmap["chains"] for p in c["pages"]]
        _meta, contents = a.export_prefix_pages(pages)
        export_s = time.perf_counter() - t0
        _build.reset_launch_counts()
        b = serving_engine(model, cfg)
        b_ptrs = static_pointers(b)
        t0 = time.perf_counter()
        imported = b.import_prefix_pages(
            [(c["tokens"], c["pages"]) for c in pmap["chains"]], contents,
            dtype=pmap["dtype"], page_shape=pmap["page_shape"],
            page_size=pmap["page_size"])
        import_s = time.perf_counter() - t0
        b.allocator.check_conservation()
        ids = [b.submit(p, max_new_tokens=64) for p in shared]
        b_res = b.run()
        finish_drill(b, b_ptrs, "warm recipient")
        b_tokens = [b_res[i].tokens for i in ids]
        check(b.metrics.prefix_hits == len(shared)
              and imported["pages"] == len(set(pages)),
              f"warm import: {b.metrics.prefix_hits} prefix hits, "
              f"{imported['pages']} of {len(set(pages))} pages")
        check(b_tokens == a_tokens, "warm import: the recipient's greedy "
              "tokens differ from the donor's")
        row["warm_import"] = {
            "chains": len(pmap["chains"]), "pages": imported["pages"],
            "bytes": sum(len(k) + len(v) for k, v in contents.values()),
            "export_s": export_s, "import_s": import_s,
            "prefix_hits": b.metrics.prefix_hits,
            "prefill_tokens_saved": b.metrics.prefill_tokens_saved,
            "donor_first_pass_agreement": agreement(
                [a_res[i].tokens for i in first], a_tokens)}
        del a, b
        free_engine()
    shutil.rmtree(root)
    row["nvidia_smi"] = card_name_and_power_limit()
    emit("runtime_serve", model=MODEL, dtype="bfloat16", slots=SLOTS,
         requests=len(prompts), **row)
    return row


# ---- 11f. the serving front door: gateway, replica processes, disagg ------------
FRONT_DIR = os.path.join("build", "front_door")
# a serve or replica process on the card builds the 0.6B model and
# captures its graphs before READY
READY_CEILING_S = 300.0
FRONT_NEW_TOKENS = 64
# the serve entry's flags for the serve cell's engine at fp32 (its seed-0
# draw is decode_parity's model32, weight for weight)
FRONT_ARGS = ("--preset", MODEL, "--dtype", "float32", "--param_seed", "0",
              "--max_slots", str(SLOTS), "--max_seq", str(MAX_SEQ),
              "--prefill_len", str(PREFILL_LEN), "--page_size",
              str(PAGE_SIZE))


def sse_generate(port: int, prompt, n: int, on_token=None):
    """One streamed ``POST /v1/generate``: (token ids, the done events,
    each token's arrival on the host clock); ``on_token()`` after each
    token event."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=READY_CEILING_S)
    try:
        conn.request("POST", "/v1/generate", body=json.dumps(
            {"prompt": prompt, "max_new_tokens": n}).encode())
        resp = conn.getresponse()
        check(resp.status == 200, f"generate answered {resp.status}")
        tokens, dones, times, event = [], [], [], None
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.decode().rstrip("\r\n")
            if line.startswith("event:"):
                event = line[6:].strip()
            elif line.startswith("data:"):
                data = json.loads(line[5:])
                if event == "token":
                    tokens += data["token_ids"]
                    times.append(time.monotonic())
                    if on_token is not None:
                        on_token()
                elif event == "done":
                    dones.append(data)
        return tokens, dones, times
    finally:
        conn.close()


def http_get(port: int, path: str, uds: str = None) -> str:
    """The body of a GET on the gateway's port or a replica's socket."""
    import http.client

    if uds is None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    else:
        from scaletorch_tpu_torch.serving.remote import _UDSHTTPConnection

        conn = _UDSHTTPConnection(uds, timeout=60)
    try:
        conn.request("GET", path)
        return conn.getresponse().read().decode()
    finally:
        conn.close()


def get_json(port: int, path: str, uds: str = None) -> dict:
    return json.loads(http_get(port, path, uds))


def wait_for(predicate, what: str, ceiling_s: float = READY_CEILING_S):
    deadline = time.monotonic() + ceiling_s
    while True:
        got = predicate()
        if got:
            return got
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.1)


def gated_gateway(eng, prompts, new_tokens: int) -> dict:
    """``prompts`` through a ``ServingGateway`` over ``eng``, streamed
    over HTTP, one client thread each. The worker is held on a gate
    until every request has been offered, in order, and dispatched (or
    queued in the gateway), so the engine admits them as a direct run
    that submits them all at once does: the tokens can be held to it
    bit for bit. Times are from the gate's release."""
    import threading

    from scaletorch_tpu_torch.serving.gateway import ServingGateway

    gw = ServingGateway(eng, port=0, max_backlog=4 * len(prompts))
    gw.start_in_thread()
    worker = gw.workers["r0"]
    gate = threading.Event()
    held = threading.Thread(target=worker.call_engine,
                            args=(lambda _e: gate.wait(READY_CEILING_S),),
                            kwargs={"timeout_s": READY_CEILING_S})
    held.start()
    out = [None] * len(prompts)

    def client(i):
        out[i] = sse_generate(gw.port, prompts[i], new_tokens)

    threads = []
    try:
        for i in range(len(prompts)):
            threads.append(threading.Thread(target=client, args=(i,)))
            threads[-1].start()
            wait_for(lambda: gw.metrics.http_requests_received == i + 1,
                     "the request's arrival", 60)
        wait_for(lambda: gw._dispatch_count + len(gw.admission.queue)
                 == len(prompts), "every request dispatched or queued", 60)
        if hasattr(eng.metrics, "busy_fractions"):
            eng.metrics.reset_window()
        t0 = time.monotonic()
        gate.set()
        for t in threads:
            t.join(READY_CEILING_S)
        wall = time.monotonic() - t0
        check(all(not t.is_alive() for t in threads), "a client hung")
    finally:
        gate.set()
        held.join(60)
        gw.stop_sync()
    gw.metrics.check_conservation()
    dones = [o[1] for o in out]
    check(all(len(d) == 1 and d[0]["outcome"] == "ok" for d in dones),
          f"want one ok done event per request: {dones}")
    tokens = [o[0] for o in out]
    check(all(t == d[0]["token_ids"] for t, d in zip(tokens, dones)),
          "the streamed tokens differ from the done events'")
    gaps = [b - a for o in out for a, b in zip(o[2], o[2][1:])]
    n = sum(len(t) for t in tokens)
    return {"tokens": tokens, "wall_s": wall, "tokens_generated": n,
            "tokens_per_s": n / wall,
            "client_ttft_mean_s": statistics.mean(o[2][0] - t0 for o in out),
            "client_tpot_p50_s": statistics.median(gaps),
            "engine_mean_ttft_s": eng.metrics.snapshot()["mean_ttft_s"],
            "engine_tpot_p50_s": eng.metrics.hist["tpot"].quantile(0.5),
            "http_outcomes": {k: v for k, v in gw.metrics.outcomes.items()
                              if v}}


def k4_per_replay(eng, cfg, what: str) -> int:
    per = eng._decode.captured_launches.get("paged_decode")
    check(per == cfg.num_hidden_layers,
          f"{what}: paged_decode launched {per} times a decode replay, "
          f"want {cfg.num_hidden_layers}")
    return per


class ServeProcess:
    """``python -m scaletorch_tpu_torch.serve`` as a child of this
    script, in a session of its own: its stdout pumped into a queue,
    READY awaited, SIGTERM's drain and exit code read; the session (the
    serve process and any replica process it started) killed at the
    end, whatever happened."""

    def __init__(self, *args: str):
        import queue
        import threading

        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "scaletorch_tpu_torch.serve", *args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)
        self.lines: "queue.Queue" = queue.Queue()
        self.log = []
        threading.Thread(target=self._pump, daemon=True).start()
        self.port = None
        deadline = time.monotonic() + READY_CEILING_S
        try:
            while self.port is None:
                check(time.monotonic() < deadline,
                      "serve never printed READY")
                try:
                    line = self.lines.get(timeout=1.0)
                except queue.Empty:
                    check(self.proc.poll() is None,
                          f"serve exited {self.proc.returncode} before "
                          "READY: " + "".join(self.log[-40:]))
                    continue
                if line.startswith("READY port="):
                    self.port = int(line.strip().split("=")[1])
        except BaseException:
            self.close()
            raise
        self.ready_s = time.monotonic() - self.t0

    def _pump(self):
        for line in self.proc.stdout:
            self.log.append(line)
            self.lines.put(line)

    def drain(self) -> int:
        self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=READY_CEILING_S)
        finally:
            self.close()

    def close(self):
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass  # the drain ended every process of the session
        self.proc.wait(timeout=60)


def prom_values(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def phase_gateway(model32) -> dict:
    """The HTTP gateway over the serve cell's engine at fp32 (8 slots,
    paged, K4), the serve traffic streamed over SSE, against the same
    engine driven directly: tokens bit for bit, one capture each step
    (replays from the gateway's worker thread), K4 = L launches a decode
    replay; then the serve entry as a process, one request, SIGTERM's
    drain exits 0."""
    cfg = model_config(MODEL, dtype=torch.float32)
    prompts = traffic(cfg.vocab_size)
    free_engine()
    with torch.inference_mode():
        eng, direct, _, direct_stats = serve(model32, cfg, prompts, None)
    direct_tokens = [r.tokens for r in direct]
    del eng
    free_engine()
    _build.reset_launch_counts()
    eng = serving_engine(model32, cfg)
    ptrs = static_pointers(eng)
    run = gated_gateway(eng, prompts, FRONT_NEW_TOKENS)
    check(run["tokens"] == direct_tokens,
          "gateway: streamed tokens differ from the direct engine's: "
          + json.dumps(agreement(run["tokens"], direct_tokens)))
    graphs = check_one_capture(eng, "gateway")
    check(static_pointers(eng) == ptrs, "gateway: a static buffer moved")
    m = eng.metrics
    check(m.requests_submitted == sum(m.outcomes.values()) == len(prompts)
          and eng.pending == 0, f"gateway: outcomes {m.outcomes}")
    eng.allocator.check_conservation()
    per = k4_per_replay(eng, cfg, "gateway")
    launches = _build.launch_counts["paged_decode"]
    del eng
    free_engine()
    added_us = (1e6 * (run["wall_s"] - direct_stats["wall_s"])
                / run["tokens_generated"])
    proc = ServeProcess(*FRONT_ARGS, "--serve_port", "0")
    try:
        tokens, dones, _ = sse_generate(proc.port, prompts[0],
                                        FRONT_NEW_TOKENS)
        prom = prom_values(http_get(proc.port, "/metrics"))
    finally:
        rc = proc.drain()
    check(len(dones) == 1 and dones[0]["outcome"] == "ok"
          and tokens == direct_tokens[0],
          "the serve process's stream differs from the direct engine's")
    check(prom.get('scaletorch_engine_decode_compile_count{replica="r0"}')
          == 1.0, "the serve process captured its decode step again")
    check(rc == 0, f"serve drained with exit code {rc}, want 0")
    del run["tokens"]
    row = {"requests": f"{len(prompts)}/{len(prompts)}", **run,
           "direct": {k: direct_stats[k] for k in (
               "wall_s", "tokens_per_s", "decode_tokens_per_s",
               "mean_ttft_s", "tpot_p50_s")},
           "gateway_added_host_us_per_token": added_us,
           "k4_launches": launches, "k4_per_decode_replay": per, **graphs,
           "serve_process": {"ready_s": proc.ready_s, "drain_exit_code": rc,
                             "tokens_equal_direct": True},
           "nvidia_smi": card_name_and_power_limit()}
    emit("gateway", model=MODEL, dtype="float32", slots=SLOTS,
         new_tokens=FRONT_NEW_TOKENS, **row)
    return row


def phase_gateway_fleet(model32) -> dict:
    """Two replica processes of the serve cell's engine (fp32) behind the
    serve entry's supervisor on the one card: the replica serving the
    first stream is SIGKILLed mid-stream (``--ft_gw_replica_crash_at
    1``) and that stream ends ``aborted``; the supervisor restarts it; a
    follow-up streams the direct engine's tokens; the other replica is
    SIGKILLed while it decodes a stream of its own and the survivor
    streams the shared prompt (which must end as the direct engine's),
    rejoins WARM (the donor's frozen prefix pages pulled over the wire)
    and its first shared-prefix request is a prefix hit with the direct
    engine's tokens. Each replica captures each step once and runs
    K4 L times a decode replay; SIGTERM drains the fleet to exit 0."""
    import threading

    from scaletorch_tpu_torch.serving.router import (
        _rendezvous,
        page_chunk_hashes,
    )

    cfg = model_config(MODEL, dtype=torch.float32)
    prompt = traffic(cfg.vocab_size)[0]  # the shared 256-token prefix
    free_engine()
    with torch.inference_mode():
        oracle = serving_engine(model32, cfg)
        first = oracle.submit(prompt, max_new_tokens=FRONT_NEW_TOKENS)
        cold = oracle.run()[first].tokens
        again = oracle.submit(prompt, max_new_tokens=FRONT_NEW_TOKENS)
        warm = oracle.run()[again]
        check(warm.prefix_hit, "the oracle's second pass missed its prefix")
        warm = warm.tokens
    del oracle
    free_engine()
    root = os.path.abspath(FRONT_DIR)
    shutil.rmtree(root, ignore_errors=True)
    sock_dir = os.path.join(root, "sock")
    proc = ServeProcess(
        *FRONT_ARGS, "--serve_port", "0", "--serve_replica_procs", "2",
        "--ft_gw_replica_crash_at", "1", "--supervisor_backoff_base_s",
        "0.2", "--supervisor_backoff_max_s", "1.0", "--telemetry_dir",
        root, "--serve_replica_uds", sock_dir)
    try:
        port = proc.port
        health = get_json(port, "/healthz")
        pids = {rid: r["pid"] for rid, r in health["replicas"].items()}
        check(len(pids) == 2, f"want 2 replicas: {health}")
        tokens, dones, _ = sse_generate(port, prompt, FRONT_NEW_TOKENS)
        check(len(dones) == 1 and dones[0]["outcome"] == "aborted",
              f"the killed replica's stream: {dones}")
        crash_t = time.monotonic()

        def restarted():
            h = get_json(port, "/healthz")["replicas"]
            return next((rid for rid, r in h.items()
                         if r.get("restarts_total", 0) >= 1
                         and r.get("state") == "up"), None)

        victim = wait_for(restarted, "the supervisor's restart")
        restart_wall_s = time.monotonic() - crash_t
        tokens, dones, _ = sse_generate(port, prompt, FRONT_NEW_TOKENS)
        check(len(dones) == 1 and dones[0]["outcome"] == "ok"
              and tokens == cold,
              "the healed fleet's stream differs from the direct engine's")

        def donor():
            h = get_json(port, "/healthz")["replicas"]
            return next((rid for rid, r in h.items()
                         if (r.get("prefix_pages") or 0) > 0), None)

        donor_id = wait_for(donor, "a replica holding prefix pages")
        victim2 = next(rid for rid in sorted(pids) if rid != donor_id)
        # the second kill lands mid-replay: the victim decodes a cold
        # prompt (routed to it by the router's rendezvous on its first
        # page chunk) while the donor streams the shared prompt, whose
        # tokens must be the direct engine's prefix-hit pass
        rng = np.random.default_rng(11)
        cold = next(q for q in (rng.integers(0, cfg.vocab_size,
                                             PREFILL_LEN // 2).tolist()
                                for _ in range(64))
                    if _rendezvous(page_chunk_hashes(q, PAGE_SIZE)[0],
                                   sorted(pids)) == victim2)
        first = {"cold": threading.Event(), "shared": threading.Event()}
        both = {}

        def stream(name, q, n):
            try:
                both[name] = sse_generate(port, q, n,
                                          on_token=first[name].set)
            finally:
                first[name].set()  # a stream that ends before a token

        streams = [threading.Thread(target=stream, args=a) for a in (
            ("cold", cold, 8 * FRONT_NEW_TOKENS),
            ("shared", prompt, FRONT_NEW_TOKENS))]
        for t in streams:
            t.start()
        check(all(e.wait(READY_CEILING_S) for e in first.values()),
              "the two streams' first tokens")
        before = get_json(port, "/healthz")["replicas"][victim2]
        os.kill(before["pid"], signal.SIGKILL)
        for t in streams:
            t.join(READY_CEILING_S)
        check([d["outcome"] for d in both["cold"][1]] == ["aborted"],
              f"the stream on the killed replica: {both['cold'][1]}")
        check([d["outcome"] for d in both["shared"][1]] == ["ok"]
              and both["shared"][0] == warm,
              "the survivor's stream was disturbed by the kill")

        def warmed():
            r = get_json(port, "/healthz")["replicas"][victim2]
            return r if (r.get("state") == "up"
                         and r["restarts_total"] > before["restarts_total"]
                         and (r.get("warm_pages") or 0) > 0) else None

        rejoined = wait_for(warmed, "the warm rejoin")
        tokens, dones, _ = sse_generate(port, prompt, FRONT_NEW_TOKENS)
        check(len(dones) == 1 and dones[0]["outcome"] == "ok"
              and tokens == warm,
              "the warmed replica's stream differs from the direct "
              "engine's prefix-hit pass")
        replicas = {}
        for rid in sorted(pids):
            m = get_json(None, "/metrics",
                         uds=os.path.join(sock_dir, f"{rid}.sock"))
            per = m["decode_launches_per_replay"].get("paged_decode")
            k4 = m["kernel_launches"].get("paged_decode", 0)
            check(m["decode_compile_count"] == m["prefill_compile_count"]
                  == 1, f"{rid}: captured {m['decode_compile_count']} / "
                  f"{m['prefill_compile_count']} times, want 1 each")
            check(per == cfg.num_hidden_layers,
                  f"{rid}: {per} K4 launches a decode replay")
            # the capture's one warm-up run plus one set per replay
            check(k4 == per * (m["decode_replays"] + 1) and k4 > 0,
                  f"{rid}: {k4} K4 launches for {m['decode_replays']} "
                  "replays")
            replicas[rid] = {"pid": m["pid"], "k4_launches": k4,
                             "k4_per_decode_replay": per,
                             "decode_replays": m["decode_replays"]}
        prom = prom_values(http_get(port, "/metrics"))
        compiles = [v for k, v in prom.items() if k.startswith(
            "scaletorch_engine_decode_compile_count")]
        check(compiles == [1.0, 1.0], f"decode captures {compiles}")
        check(prom["scaletorch_http_requests_received"] == 5
              and prom["scaletorch_http_aborted"] == 2
              and prom["scaletorch_http_ok"] == 3,
              "the gateway's ledger through the crashes")
    except BaseException:
        proc.close()
        print("".join(proc.log[-60:]), file=sys.stderr, flush=True)
        raise
    rc = proc.drain()
    check(rc == 0, f"the fleet drained with exit code {rc}, want 0")
    records = read_jsonl(os.path.join(root, "gateway_events.jsonl"))
    sup = [r for r in records if r.get("kind") == "supervisor"]
    restarts = []
    for rid in (victim, victim2):
        crashes = [r["time"] for r in sup
                   if r["replica"] == rid and r["event"] == "crash"]
        readies = [r["time"] for r in sup
                   if r["replica"] == rid and r["event"] == "ready"]
        for c in crashes:
            after = [t for t in readies if t > c]
            check(bool(after), f"{rid}: no READY after its crash")
            restarts.append(min(after) - c)
    # each spawn's seconds to READY: the first boots, then the restarts
    spawn_to_ready = {}
    for rid in sorted(pids):
        spawns = [r["time"] for r in sup
                  if r["replica"] == rid and r["event"] == "spawn"]
        readies = [r["time"] for r in sup
                   if r["replica"] == rid and r["event"] == "ready"]
        spawn_to_ready[rid] = [b - a for a, b in zip(spawns, readies)]
    warmups = [r for r in records if r.get("kind") == "warmup"
               and r["replica"] == victim2 and r["status"] == "warmed"]
    check(bool(warmups), f"no warmed record for {victim2}")
    access = [r for r in records if r.get("kind") == "access"]
    check(any(r["replica"] == victim2 and r["prefix_hit"]
              and r["outcome"] == "ok" for r in access),
          "the warmed replica's first request was no prefix hit")
    row = {"requests": "5/5 answered (2 aborted by the kills, 3 ok)",
           "survivor_stream_equal_direct": True,
           "fleet_ready_s": proc.ready_s,
           "spawn_to_ready_s": spawn_to_ready,
           "crash_to_ready_s": restarts,
           "restart_seen_up_s": restart_wall_s,
           "killed": [victim, victim2], "donor": donor_id,
           "warm_pages": rejoined.get("warm_pages"),
           "warm_transfer_s": warmups[0].get("seconds"),
           "warm_chunks_dropped": warmups[0].get("chunks_dropped"),
           "replicas": replicas, "drain_exit_code": rc,
           "nvidia_smi": card_name_and_power_limit()}
    shutil.rmtree(root, ignore_errors=True)
    emit("gateway_fleet", model=MODEL, dtype="float32", slots=SLOTS, **row)
    return row


def phase_disagg_serve(model32) -> dict:
    """``DisaggregatedEngine`` at the serve cell's shape (fp32), split
    ``"1:1"`` with both slices on the one card (two page pools, the
    weights shared), behind the gateway: the serve traffic's tokens
    equal the colocated engine's without a prefix cache (every prompt
    prefilled whole, as the prefill slice does) bit for bit; each step
    captured once; K4 L times a decode replay on the decode pool; both
    allocators conserved; then the serve entry with ``--disagg 1:1`` as
    a process, one request, SIGTERM's drain exits 0."""
    from scaletorch_tpu_torch.inference import DisaggregatedEngine

    cfg = model_config(MODEL, dtype=torch.float32)
    prompts = traffic(cfg.vocab_size)
    free_engine()
    with torch.inference_mode():
        eng, whole, _, colo_stats = serve(model32, cfg, prompts, None,
                                          prefix_cache=False)
        del eng
        free_engine()
        eng, hit, _, _ = serve(model32, cfg, prompts, None)
        del eng
    whole = [r.tokens for r in whole]
    hit = [r.tokens for r in hit]
    free_engine()
    _build.reset_launch_counts()
    eng = DisaggregatedEngine(
        model32, cfg, devices=["cuda:0", "cuda:0"], disagg_split="1:1",
        max_slots=SLOTS, max_seq=MAX_SEQ, prefill_len=PREFILL_LEN,
        sampling=SamplingParams(temperature=0.0), page_size=PAGE_SIZE)
    check(eng.prefill_model is eng.model, "the slices copied the weights")
    run = gated_gateway(eng, prompts, FRONT_NEW_TOKENS)
    busy_p, busy_d = eng.metrics.busy_fractions()
    check(run["tokens"] == whole,
          "disagg: tokens differ from the colocated engine's: "
          + json.dumps(agreement(run["tokens"], whole)))
    graphs = check_one_capture(eng, "disagg_serve")
    per = k4_per_replay(eng, cfg, "disagg_serve")
    check(eng._prefill.captured_launches.get("paged_decode", 0) == 0,
          "the prefill slice ran K4")
    eng.check_conservation()
    m = eng.metrics
    check(m.handoffs == len(prompts) and m.handoff_failures == 0,
          f"{m.handoffs} handoffs, {m.handoff_failures} failed")
    row = {"requests": f"{len(prompts)}/{len(prompts)}",
           **{k: v for k, v in run.items() if k != "tokens"},
           "colocated_no_prefix_cache": {k: colo_stats[k] for k in (
               "wall_s", "tokens_per_s", "mean_ttft_s", "tpot_p50_s")},
           "agreement_with_prefix_cache_colocated": agreement(
               run["tokens"], hit),
           "handoff_p50_s": m.hist["handoff"].quantile(0.5),
           "handoff_pages": m.pages_handed_off,
           "handoff_bytes": m.handoff_bytes,
           "prefix_hits_decode_side": m.prefix_hits,
           "prefill_busy_fraction": busy_p, "decode_busy_fraction": busy_d,
           "k4_launches": _build.launch_counts["paged_decode"],
           "k4_per_decode_replay": per, **graphs}
    del eng
    free_engine()
    proc = ServeProcess(*FRONT_ARGS, "--serve_port", "0", "--disagg", "1:1")
    try:
        tokens, dones, _ = sse_generate(proc.port, prompts[1],
                                        FRONT_NEW_TOKENS)
        health = get_json(proc.port, "/healthz")
    finally:
        rc = proc.drain()
    check(len(dones) == 1 and dones[0]["outcome"] == "ok"
          and tokens == whole[1],
          "the disagg serve process's stream differs from the colocated "
          "engine's")
    block = health["replicas"]["r0"].get("disagg")
    check(block is not None and block["handoffs"] == 1,
          f"no disagg block on /healthz: {health}")
    check(rc == 0, f"serve --disagg drained with exit code {rc}, want 0")
    row["serve_process"] = {"ready_s": proc.ready_s, "drain_exit_code": rc,
                            "tokens_equal_colocated": True}
    row["nvidia_smi"] = card_name_and_power_limit()
    emit("disagg_serve", model=MODEL, dtype="float32", slots=SLOTS,
         split="1:1", devices=["cuda:0", "cuda:0"],
         new_tokens=FRONT_NEW_TOKENS, **row)
    return row


# ---- 19. training over the device mesh, one rank a card ------------------------
PARALLEL_DIR = os.path.join("build", "parallel")
# the torch.distributed.run of every check: world 1, and four cards
PARALLEL_TIMEOUT_S = {1: 720, 4: 1800}
PARALLEL_WARMUP, PARALLEL_STEPS = 2, 3
# what the four-card run does: the training layouts, the tp serving
# checks, FSDP, Adafactor and remat, then the Qwen3-MoE engine over tp x ep
PARALLEL_GROUPS = ("layouts", "nccl_capture", "serve_tp4", "tp_parity",
                   "serve_tp2_dp2_dense", "fsdp4", "adafactor", "remat_cp",
                   "cp_timing", "moe_mesh_parity", "serve_moe_ep4",
                   "examples", "serve_gpt_moe_tp")
# the timed window of each four-card layout: three steps spread by
# 30-45% between two calls, so the layouts are compared over ten
LAYOUT_STEPS = 10
# (name, parallel sizes and options) of the four-card layouts, headline row
PARALLEL_LAYOUTS = (
    ("tp4_sp", dict(tensor_parallel_size=4, sequence_parallel=True)),
    ("cp4_ring_zigzag", dict(context_parallel_size=4,
                             attention_backend="ring", cp_layout="zigzag")),
    ("cp4_ulysses", dict(context_parallel_size=4,
                         attention_backend="ulysses")),
    ("dp2_tp2", dict(data_parallel_size=2, tensor_parallel_size=2)),
    ("dp2_cp2_ring_contiguous", dict(data_parallel_size=2,
                                     context_parallel_size=2,
                                     attention_backend="ring",
                                     cp_layout="contiguous")),
)
BIG_MODEL, BIG_SEQ = "qwen3-8b", 4096  # tp4 + SP: too big for one card
# the pipeline layouts of the headline row: M = 4 microbatches a step
PP_MICROBATCHES = 4
PIPELINE_LAYOUTS = (
    ("pp4_afab", dict(pipeline_parallel_size=4,
                      gradient_accumulation_steps=PP_MICROBATCHES)),
    ("pp2_dp2_memory_chunked", dict(
        pipeline_parallel_size=2, data_parallel_size=2,
        pp_engine="memory_chunked",
        gradient_accumulation_steps=PP_MICROBATCHES)),
    ("pp2_tp2_sp_interleaved", dict(
        pipeline_parallel_size=2, tensor_parallel_size=2,
        sequence_parallel=True, pp_engine="interleaved",
        pp_virtual_stages=2, gradient_accumulation_steps=PP_MICROBATCHES)),
)
# Qwen3-30B-A3B's width cut to 2 layers, seq MOE_TRAIN_SEQ a row
MOE_LAYOUT_LAYERS = 2
MOE_LAYOUTS = (
    ("ep4", dict(expert_parallel_size=4)),
    ("pp2_ep2", dict(pipeline_parallel_size=2, expert_parallel_size=2,
                     gradient_accumulation_steps=2)),
)
# routing statistics of a layout vs one card (fp32; a near-tie of the
# top-k may flip one choice between two summation orders)
MOE_STATS_ABS = 1e-3
# the int8 gradient wire beside the fp32 one, dp 4, headline row
INT8_LAYOUTS = (("dp4", dict(data_parallel_size=4)),
                ("dp4_int8", dict(data_parallel_size=4,
                                  grad_allreduce_dtype="int8")))
INT8_COSINE = 0.999  # the reference's bound (quantized_collectives.py)
# Qwen3-30B-A3B at full width under ep 4: bf16 masters, Adafactor, seq
# 4096 a row (one a rank), GC; the depth reckoned to fit 80 GB (PERF.md
# §6): Adafactor's update of the stacked expert leaf keeps ~7 fp32 copies
# of it (6.4 GB a copy at 32 layers), so 28 of the 48 layers
MOE_FULL_LAYERS = 28
MOE_FULL = dict(expert_parallel_size=4, param_dtype="bfloat16",
                optimizer_name="adafactor",
                num_hidden_layers=MOE_FULL_LAYERS)


def layout_launches(opts: dict, cp_rank: int, layers: int,
                    moe: bool = False) -> dict:
    """K1/K2/K3 (and, for a MoE, K5, the grads pass, K6 and K7) launches a
    GC step on a rank with cp coordinate ``cp_rank``, from the reference's
    schedule: one block a layer for flash and ulysses; the contiguous
    ring's rank r computes r + 1 blocks, the zigzag ring's every rank
    3 + (cp - 1) half blocks; a pipeline stage runs its L/pp layers for
    each of the M microbatches (interleaved: in vpp chunks, the same
    count); GC runs the forward twice, but once under ``save_attn``,
    which keeps the attention op's output (K1's, the ring's, Ulysses')."""
    cp = opts.get("context_parallel_size", 1)
    blocks = 1
    if opts.get("attention_backend") == "ring":
        blocks = (3 + cp - 1 if opts["cp_layout"] == "zigzag"
                  else cp_rank + 1)
    per = (layers // opts.get("pipeline_parallel_size", 1)
           * opts.get("gradient_accumulation_steps", 1))
    fwd = 1 if opts.get("remat_policy") == "save_attn" else 2
    out = {tf.K1_NAME: fwd * per * blocks, tf.K2_NAME: per * blocks,
           tf.K3_NAME: per * blocks}
    if moe:
        out.update({gm.K5_NAME: 2 * per, gm.GRADS_NAME: per,
                    gm.K6_NAME: per, gm.K7_NAME: per})
    return out


LAUNCH_NAMES = (tf.K1_NAME, tf.K2_NAME, tf.K3_NAME)
MOE_LAUNCH_NAMES = LAUNCH_NAMES + (gm.K5_NAME, gm.GRADS_NAME, gm.K6_NAME,
                                   gm.K7_NAME)


def parallel_cfg(opts: dict, model: str = MODEL, seq: int = TRAIN_SEQ):
    """The bench row of ``model`` (GC, one row a dp rank) under the layout
    ``opts``, its process group from the launcher's environment."""
    return make_bench_args(model, seq=seq, gc=True,
                           extra={**opts, "distributed_launcher": "env"})


def moe_parallel_cfg(opts: dict):
    """Qwen3-30B-A3B's train row (seq MOE_TRAIN_SEQ, GC) cut to
    MOE_LAYOUT_LAYERS layers under the layout ``opts``."""
    return parallel_cfg({"num_hidden_layers": MOE_LAYOUT_LAYERS, **opts},
                        model=MOE_MODEL, seq=MOE_TRAIN_SEQ)


def shard_diff(mm, cfg, params, grads, ref_grads) -> dict:
    """The whole model's |g - ref| / |ref| and |g| / |ref| - 1 from this
    rank's shards (each leaf's sums summed over the tp, pp and ep axes it
    is split over, the others counted once), and the worst leaf's
    relative difference here."""
    from scaletorch_tpu_torch.parallel.spmd import MODEL_AXES, leaf_shard_axes

    axes = leaf_shard_axes(params, cfg, mm)
    sigs = sorted(set(axes))
    sums = torch.zeros(len(sigs), 3, dtype=torch.float64, device="cuda")
    worst = 0.0
    for g, r, a in zip(grads, ref_grads, axes):
        g, r = g.double(), r.double()
        row = torch.stack([(g - r).square().sum(), r.square().sum(),
                           g.square().sum()])
        sums[sigs.index(a)] += row
        worst = max(worst, float(row[0].sqrt() / row[1].sqrt()))
    for axis in MODEL_AXES:
        rows = [i for i, sig in enumerate(sigs) if axis in sig]
        if rows:
            part = sums[rows].contiguous()
            torch.distributed.all_reduce(part, group=mm.group(axis))
            sums[rows] = part
    d2, r2, g2 = (float(x) for x in sums.sum(0))
    return {"grad_rel_l2_diff": (d2 / r2) ** 0.5,
            "grad_norm_rel_diff": abs((g2 / r2) ** 0.5 - 1.0),
            "worst_leaf_rel_diff": worst}


def parallel_worker(out_dir: str, groups=PARALLEL_GROUPS) -> int:
    """One rank of ``phase_parallel`` (started by torch.distributed.run):
    the world-1 checks on one card, the four-card ``groups`` (of
    PARALLEL_GROUPS) on four."""
    from scaletorch_tpu_torch import dist as stdist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the MoE configs read the kernel toggle once, when they are built
    os.environ[qwen3_moe.GROUPED_MLP_ENV] = "1"
    world = int(os.environ["WORLD_SIZE"])
    result = (parallel_world1() if world == 1
              else parallel_layouts(world, groups))
    if stdist.process_index() == 0:
        with open(os.path.join(out_dir, "result.json"), "w") as f:
            json.dump(result, f)
    stdist.shutdown_distributed()
    return 0


def trainer_steps(trainer, steps: int) -> list:
    """``steps`` steps' (loss, grad_norm, update_skipped[, routing stats])
    as floats."""
    out = []
    for _ in range(steps):
        m = trainer.step()
        out.append([float(m["loss"]), float(m["grad_norm"]),
                    float(m["update_skipped"])]
                   + [float(m[k]) for k in sorted(m) if k.startswith("moe_")])
    return out


def world1_reference(cfg) -> tuple:
    """The single-device Trainer's steps and final parameters (on the
    host), before any process group exists."""
    single = Trainer(dataclasses.replace(cfg, distributed_launcher="none"))
    check(not torch.distributed.is_initialized(), "the single run joined a "
          "process group")
    steps = trainer_steps(single, PARALLEL_WARMUP + PARALLEL_STEPS)
    params = [t.detach().cpu() for t in tree_leaves(single.params)]
    del single
    gc.collect()
    torch.cuda.empty_cache()
    return steps, params


def world1_case(name: str, cfg, ref: tuple, moe: bool) -> dict:
    """The distributed Trainer (an NCCL group of one) against ``ref``: 2 +
    3 steps and the final parameters equal bit for bit, the kernels'
    launches a step as reckoned."""
    ref_steps, ref_params = ref
    trainer = Trainer(cfg)
    check(torch.distributed.is_initialized()
          and torch.distributed.get_backend() == "nccl"
          and trainer.world == 1, "the distributed Trainer has no NCCL group")
    got = trainer_steps(trainer, PARALLEL_WARMUP)
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got += trainer_steps(trainer, PARALLEL_STEPS)
    elapsed = time.perf_counter() - t0
    names = MOE_LAUNCH_NAMES if moe else LAUNCH_NAMES
    launches = {n: _build.launch_counts.get(n, 0) / PARALLEL_STEPS
                for n in names}
    want = layout_launches({}, 0, trainer.model_cfg.num_hidden_layers, moe)
    check(launches == want, f"world 1 {name}: launches a step {launches}, "
                            f"want {want}")
    check(got == ref_steps, f"world 1 {name}: steps {got} != single-device "
                            f"{ref_steps}")
    same = all(bool(torch.equal(a.cpu(), b)) for a, b in
               zip(tree_leaves(trainer.params), ref_params))
    check(same, f"world 1 {name}: parameters differ from the single-device "
                "run")
    tok_s, mfu = trainer.metrics.throughput(PARALLEL_STEPS, elapsed)
    row = {"steps": got, "bitwise_equal": True, "launches_per_step": launches,
           "tokens_per_s": tok_s, "mfu_per_card": mfu,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return row


def parallel_world1() -> dict:
    """The distributed Trainer (an NCCL group of one) against the
    single-device Trainer on the same seeded weights and batches: 2 + 3
    steps equal bit for bit, losses, norms (and routing statistics) and
    final parameters; the headline row, then Qwen3-30B-A3B's train row
    (4 layers, the grouped-MLP kernels on, K5-K7 counted)."""
    dense_cfg = parallel_cfg({})
    moe_cfg = parallel_cfg({"num_hidden_layers": MOE_TRAIN_LAYERS},
                           model=MOE_MODEL, seq=MOE_TRAIN_SEQ)
    refs = {"dense": world1_reference(dense_cfg),
            "moe": world1_reference(moe_cfg)}
    dense = world1_case("dense", dense_cfg, refs["dense"], moe=False)
    moe = world1_case(f"{MOE_MODEL}_{MOE_TRAIN_LAYERS}l", moe_cfg,
                      refs["moe"], moe=True)
    dev = torch.device("cuda", 0)
    t0 = time.monotonic()
    engine = world1_engine(dev)
    fsdp = world1_fsdp(dev)
    adafactor = world1_adafactor(dev)
    not_run = ([n for n, _ in PARALLEL_LAYOUTS] + [f"{BIG_MODEL}_tp4_sp"]
               + [n for n, _ in PIPELINE_LAYOUTS + MOE_LAYOUTS + INT8_LAYOUTS]
               + [f"{MOE_MODEL}_ep4_full_width"]
               + [g for g in PARALLEL_GROUPS if g != "layouts"])
    return {"world": 1, "layouts_run": [
        "world1_vs_single_device", "world1_moe_vs_single_device",
        "world1_engine", "world1_fsdp", "world1_adafactor"],
            "layouts_not_run": not_run, **dense,
            "moe": {"model": MOE_MODEL, "layers": MOE_TRAIN_LAYERS, **moe},
            "engine": {"model": MODEL, "layers": WORLD1_SERVE_LAYERS,
                       **engine},
            "fsdp": fsdp, "adafactor": adafactor,
            "new_checks_s": time.monotonic() - t0}


def one_card_reference(cfg32, batch, dev, blocks: int = 1) -> tuple:
    """(loss, stats, {name: fp32 gradient on the host}) of the one-card
    step on ``batch`` (its microbatches accumulated), from the seeded
    weights every layout draws. The routing statistics are the mean of
    those of the ``blocks`` row blocks the data ranks hold (the
    reference's definition: the mean over the data ranks of each rank's
    statistics; ``moe_load_cv`` is not linear in the rows)."""
    from scaletorch_tpu_torch.data.dataloader import device_batch
    from scaletorch_tpu_torch.trainer.train_step import (
        make_grad_fn,
        make_loss_fn,
    )

    model = qwen3_moe if hasattr(cfg32, "num_experts") else None
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = (model.init_params(cfg32, gen, dev, requires_grad=True)
              if model else init_params(cfg32, gen, dev, requires_grad=True))
    grads_fn = make_grad_fn(cfg32, attention_backend="flash",
                            gradient_checkpointing=True)
    loss, stats, grads = grads_fn(params, device_batch(batch, dev))
    if stats and blocks > 1:
        loss_fn = make_loss_fn(cfg32, attention_backend="flash",
                               gradient_checkpointing=False)
        rows = batch["input_ids"].shape[1] // blocks
        acc = {k: 0.0 for k in stats}
        with torch.no_grad():
            for b in range(blocks):
                for m in range(batch["input_ids"].shape[0]):
                    part = {k: (v[m, b * rows:(b + 1) * rows] if v.ndim == 3
                                else v[m]) for k, v in batch.items()}
                    _, st = loss_fn(params, device_batch(part, dev))
                    for k, v in st.items():
                        acc[k] += float(v)
        n = blocks * batch["input_ids"].shape[0]
        stats = {k: v / n for k, v in acc.items()}
    names = list(flatten_params(params))
    # on the host: held through every layout, they would count in each
    # layout's peak memory on the card
    out = (float(loss), {k: float(v) for k, v in stats.items()},
           {n: g.cpu() for n, g in zip(names, grads)})
    del params, grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def layout_parity(name: str, opts: dict, cfg32, batch, ref, dev) -> dict:
    """The layout's fp32 loss, gradients (and routing statistics) against
    the one-card step ``ref`` on the same weights and global batch."""
    from scaletorch_tpu_torch.data.dataloader import device_batch
    from scaletorch_tpu_torch.models.convert import local_shard_fn
    from scaletorch_tpu_torch.parallel.mesh import MeshManager
    from scaletorch_tpu_torch.parallel.pipeline_parallel import (
        stage_layer_layout,
    )
    from scaletorch_tpu_torch.parallel.spmd import (
        local_batch,
        make_spmd_grad_fn,
    )

    mm = MeshManager(dp=opts.get("data_parallel_size", 1),
                     pp=opts.get("pipeline_parallel_size", 1),
                     cp=opts.get("context_parallel_size", 1),
                     ep=opts.get("expert_parallel_size", 1),
                     tp=opts.get("tensor_parallel_size", 1),
                     device_type="cuda")
    engine = opts.get("pp_engine", "afab")
    vpp = opts.get("pp_virtual_stages", 1)
    backend = opts.get("attention_backend", "flash")
    layout = opts.get("cp_layout", "zigzag")
    slicer = local_shard_fn(cfg32, mm, mm.rank, layout=stage_layer_layout(
        cfg32.num_hidden_layers, mm.pp, engine, vpp))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = qwen3_moe if hasattr(cfg32, "num_experts") else None
    kw = dict(requires_grad=True, local_slice=slicer)
    params = (model.init_params(cfg32, gen, dev, **kw) if model
              else init_params(cfg32, gen, dev, **kw))
    grads_fn = make_spmd_grad_fn(
        mm, cfg32, attention_backend=backend, gradient_checkpointing=True,
        sequence_parallel=opts.get("sequence_parallel", False),
        cp_layout=layout, pp_engine=engine, pp_vpp=vpp)
    lb = local_batch(batch, mm, zigzag=backend == "ring"
                     and layout == "zigzag")
    loss, grads = grads_fn(params, device_batch(lb, dev))
    ref_loss, ref_stats, ref_grads = ref
    names = list(flatten_params(params))
    parity = shard_diff(mm, cfg32, params, grads,
                        [slicer(n, ref_grads[n]).to(dev) for n in names])
    # a layout's communicators and their buffers go with it: the layouts
    # after it would run out of card memory outside PyTorch's allocator
    mm.destroy()
    parity.update(loss=float(loss), loss_one_card=ref_loss,
                  loss_abs_diff=abs(float(loss) - ref_loss))
    if ref_stats:
        got = {k: float(v) for k, v in grads_fn.stats.items()}
        parity.update(stats=got, stats_one_card=ref_stats,
                      stats_abs_diff=max(abs(got[k] - v)
                                         for k, v in ref_stats.items()))
    del params, grads
    gc.collect()
    torch.cuda.empty_cache()
    return parity


def timed_layout(name: str, cfg, opts: dict, world: int, moe: bool,
                 parity: dict, t0: float, steps: int = LAYOUT_STEPS) -> dict:
    """The layout's bf16 Trainer, 2 + ``steps`` steps: tokens/s, MFU and
    peak memory a card, launches a step on every rank against the
    schedule's reckoning; emitted and checked."""
    from scaletorch_tpu_torch import dist as stdist

    res = benchmark_config(cfg, warmup=PARALLEL_WARMUP, steps=steps,
                           before_window=_build.reset_launch_counts)
    trainer = res.pop("trainer")
    names = MOE_LAUNCH_NAMES if moe else LAUNCH_NAMES
    launches = {n: _build.launch_counts.get(n, 0) / steps for n in names}
    want = layout_launches(opts, trainer.mm.axis_rank("cp"),
                           trainer.model_cfg.num_hidden_layers, moe)
    losses = res["warmup_losses"] + res["losses"]
    mine = {"rank": trainer.mm.rank, "launches": launches, "want": want,
            "peak_memory_gb": res["memory_gb"], "parity": parity,
            "finite": bool(np.isfinite(losses).all()),
            "skipped": sum(res["update_skipped"])}
    num_params = trainer.num_params
    trainer.mm.destroy()
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    ranks = stdist.all_gather_object(mine)
    row = {"options": opts, "num_params": num_params,
           "sequence_length": cfg.sequence_length,
           "tokens_per_step": (cfg.sequence_length * cfg.micro_batch_size
                               * cfg.gradient_accumulation_steps
                               * cfg.data_parallel_size
                               * cfg.expert_parallel_size),
           "parity": ranks[0]["parity"],
           "parity_per_rank": [r["parity"] for r in ranks],
           "tokens_per_s": res["tokens_per_second"],
           "tokens_per_s_per_card": res["tokens_per_second"] / world,
           "mfu_per_card": res["mfu"], "step_s": res["step_time_s"],
           "losses": losses, "update_skipped": res["update_skipped"],
           **{k: v for k, v in res.items() if k.startswith("moe_")},
           "peak_memory_gb_per_card": [r["peak_memory_gb"] for r in ranks],
           "launches_per_step": [r["launches"] for r in ranks],
           "expected_launches": [r["want"] for r in ranks],
           "seconds": time.monotonic() - t0}
    if stdist.process_index() == 0:
        emit("parallel_layout", name=name, **row)
    for r in ranks:
        p = r["parity"]
        if p is not None:
            check(p["loss_abs_diff"] <= TRAIN_PARITY["loss_abs"],
                  f"{name} rank {r['rank']}: |dloss| {p['loss_abs_diff']}")
            check(p["grad_rel_l2_diff"] <= TRAIN_PARITY["grad_rel"]
                  and p["grad_norm_rel_diff"] <= TRAIN_PARITY["grad_rel"],
                  f"{name} rank {r['rank']}: gradients {p}")
            if "stats_abs_diff" in p:
                check(p["stats_abs_diff"] <= MOE_STATS_ABS,
                      f"{name} rank {r['rank']}: routing stats {p}")
        check(r["launches"] == r["want"],
              f"{name} rank {r['rank']}: launches {r['launches']}, want "
              f"{r['want']}")
        check(r["finite"] and not r["skipped"],
              f"{name} rank {r['rank']}: losses {losses}")
    return row


def int8_wire(world: int, dev) -> dict:
    """The headline row's bf16 gradients over dp 4 with the fp32 and the
    int8 wire on one set of weights and one global batch: the int8 step's
    loss (reduced in fp32) equal, every leaf's gradient and the whole
    gradient with cosine >= INT8_COSINE against the fp32 wire's; the wire
    bytes a step each reckons (``wire_bytes``)."""
    from scaletorch_tpu_torch.data.dataloader import device_batch
    from scaletorch_tpu_torch.ops.quantized_collectives import wire_bytes
    from scaletorch_tpu_torch.parallel.mesh import MeshManager
    from scaletorch_tpu_torch.parallel.spmd import (
        local_batch,
        make_spmd_grad_fn,
    )

    cfg = model_config(MODEL)  # bf16 compute, fp32 masters
    mm = MeshManager(dp=world, device_type="cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen, dev, requires_grad=True)
    batch = next(iter(SyntheticDataLoader(
        vocab_size=cfg.vocab_size, sequence_length=TRAIN_SEQ,
        micro_batch_size=world, gradient_accumulation_steps=1, seed=11)))
    lb = device_batch(local_batch(batch, mm), dev)
    out = {}
    for wire in ("fp32", "int8"):
        fn = make_spmd_grad_fn(mm, cfg, attention_backend="flash",
                               gradient_checkpointing=True,
                               grad_allreduce_dtype=wire)
        loss, grads = fn(params, lb)
        out[wire] = (float(loss), [g.detach().cpu() for g in grads])
        del grads
    (l32, g32), (l8, g8) = out["fp32"], out["int8"]

    def cosine(a, b):
        a, b = a.double().flatten(), b.double().flatten()
        return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))

    per_leaf = [cosine(a, b) for a, b in zip(g32, g8) if a.abs().max() > 0]
    whole = cosine(torch.cat([g.flatten() for g in g32]),
                   torch.cat([g.flatten() for g in g8]))
    n = sum(g.numel() for g in g32)
    row = {"loss_fp32_wire": l32, "loss_int8_wire": l8,
           "cosine_min_leaf": min(per_leaf), "cosine_whole": whole,
           "wire_bytes_per_step": {w: wire_bytes(n, world, w)
                                   for w in ("fp32", "int8")},
           "gradient_elements": n}
    check(l8 == l32, f"int8 wire: loss {l8} != fp32 wire's {l32}")
    check(min(per_leaf) >= INT8_COSINE and whole >= INT8_COSINE,
          f"int8 wire: cosine {row}")
    mm.destroy()
    del params, out, g32, g8
    gc.collect()
    torch.cuda.empty_cache()
    return row


def parallel_layouts(world: int, groups=PARALLEL_GROUPS) -> dict:
    """Four ranks. PR 12's layouts of the headline row (each layout's fp32
    loss and gradients against the one-card step on the same weights and
    global batch under TRAIN_PARITY, then its bf16 Trainer 2 + 10 steps:
    tokens/s, MFU and peak memory per card, K1/K2/K3 launches a step
    against the reference's schedule) and qwen3-8b under tp4 + SP; then
    the pipeline layouts of the headline row (M = 4), Qwen3-30B-A3B's
    width cut to 2 layers under ep4 and pp2 x ep2 (routing statistics
    against one card too, K5-K7 counted), dp4 with the fp32 and the int8
    gradient wire, and Qwen3-30B-A3B at full width under ep4 (bf16
    masters, Adafactor). Then (PR 14) a captured NCCL all-reduce,
    qwen3-32b served over tp 4 and its tp parity, tp 2 x dp 2 dense
    serving, FSDP over 4, Adafactor over sharded leaves and selective
    remat under cp. ``groups`` picks among PARALLEL_GROUPS ("layouts":
    the layouts above)."""
    from scaletorch_tpu_torch import dist as stdist

    check(world == 4, f"the layouts need 4 cards, found {world}")
    unknown = set(groups) - set(PARALLEL_GROUPS)
    check(not unknown, f"unknown parallel groups {sorted(unknown)}")
    stdist.init_distributed("env")
    dev = torch.device("cuda", stdist.local_rank())
    out = {"world": world, "groups": list(groups), "layouts_run": [],
           "layouts_not_run": [], "layouts": {}}
    # the captured collective first: the tp serving steps are built on it
    for group, fn in (("nccl_capture", nccl_capture_probe),
                      ("serve_tp4", serve_tp4), ("tp_parity", tp_parity),
                      ("serve_tp2_dp2_dense", serve_tp2_dp2_dense),
                      ("fsdp4", fsdp4), ("adafactor", adafactor_layouts),
                      ("remat_cp", remat_cp), ("cp_timing", cp_timing),
                      ("moe_mesh_parity", moe_mesh_parity),
                      ("serve_moe_ep4", serve_moe_ep4),
                      ("examples", examples_group),
                      ("serve_gpt_moe_tp", serve_gpt_moe_tp)):
        if group in groups:
            t0 = time.monotonic()
            out[group] = fn(world, dev)
            out[group + "_s"] = time.monotonic() - t0
            out["layouts_run"].append(group)
            gc.collect()
            torch.cuda.empty_cache()
        else:
            out["layouts_not_run"].append(group)
    if "layouts" not in groups:
        return out
    cfg32 = model_config(MODEL, dtype=torch.float32)
    moe32 = model_config(MOE_MODEL, dtype=torch.float32,
                         num_hidden_layers=MOE_LAYOUT_LAYERS,
                         use_grouped_mlp_kernel=True)

    def global_batch(cfg, rows: int, seq: int, accum: int = 1):
        loader = SyntheticDataLoader(
            vocab_size=cfg.vocab_size, sequence_length=seq,
            micro_batch_size=rows, gradient_accumulation_steps=accum,
            seed=11)
        return next(iter(loader))

    def batch_of(cfg, opts, seq):
        rows = (opts.get("data_parallel_size", 1)
                * opts.get("expert_parallel_size", 1))
        return global_batch(cfg, rows, seq,
                            opts.get("gradient_accumulation_steps", 1))

    refs = {}

    def run(name, opts, cfg32_, seq, cfg, moe=False):
        t0 = time.monotonic()
        batch = batch_of(cfg32_, opts, seq)
        blocks = (opts.get("data_parallel_size", 1)
                  * opts.get("expert_parallel_size", 1))
        key = (cfg32_.num_hidden_layers, moe, blocks) + tuple(
            batch["input_ids"].shape)
        if key not in refs:
            refs[key] = one_card_reference(cfg32_, batch, dev, blocks)
        parity = layout_parity(name, opts, cfg32_, batch, refs[key], dev)
        row = timed_layout(name, cfg, opts, world, moe, parity, t0)
        out["layouts"][name] = row
        out["layouts_run"].append(name)

    for name, opts in PARALLEL_LAYOUTS:
        run(name, opts, cfg32, TRAIN_SEQ, parallel_cfg(opts))
    refs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    big = dict(tensor_parallel_size=4, sequence_parallel=True)
    row = timed_layout(f"{BIG_MODEL}_tp4_sp",
                       parallel_cfg(big, model=BIG_MODEL, seq=BIG_SEQ), big,
                       world, False, None, t0)
    out["layouts"][f"{BIG_MODEL}_tp4_sp"] = row
    out["layouts_run"].append(f"{BIG_MODEL}_tp4_sp")
    for name, opts in PIPELINE_LAYOUTS:
        run(name, opts, cfg32, TRAIN_SEQ, parallel_cfg(opts))
    refs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    for name, opts in MOE_LAYOUTS:
        run(name, opts, moe32, MOE_TRAIN_SEQ, moe_parallel_cfg(opts),
            moe=True)
    refs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    wire = int8_wire(world, dev)
    for name, opts in INT8_LAYOUTS:
        row = timed_layout(name, parallel_cfg(opts), opts, world, False,
                           None, t0)
        if name == "dp4_int8":
            row["wire"] = wire
        out["layouts"][name] = row
        out["layouts_run"].append(name)
        t0 = time.monotonic()
    if stdist.process_index() == 0:
        emit("parallel_int8_wire", **wire)
    full = f"{MOE_MODEL}_ep4_full_width"
    row = timed_layout(full, make_bench_args(
        MOE_MODEL, seq=MOE_TRAIN_SEQ, gc=True,
        extra={**MOE_FULL, "distributed_launcher": "env"}), MOE_FULL, world,
        True, None, time.monotonic())
    out["layouts"][full] = row
    out["layouts_run"].append(full)
    return out


# ---- 20. serving over a mesh, FSDP, sharded Adafactor, remat under cp --------
# world 1: the engine on a mesh of one (0.6B cut to 4 layers, 8 requests
# of 16 new tokens), setup_fsdp's and the mesh Adafactor's steps (0.6B cut
# to 2 layers, seq 2048, 3 steps), each bit for bit against one card
WORLD1_SERVE_LAYERS, WORLD1_SERVE_TOKENS = 4, 16
WORLD1_TRAIN_LAYERS, WORLD1_TRAIN_SEQ, WORLD1_TRAIN_STEPS = 2, 2048, 3
# four cards: qwen3-32b at full width and depth over tp 4 (and on one
# card before it), its width cut to 2 layers for fp32 parity
TP_PARITY_LAYERS, TP_PARITY_TOKENS = 2, 64
# FSDP over 4: qwen3-8b, seq 4096 a rank, GC, AdamW, fp32 masters
FSDP_MODEL, FSDP_SEQ, FSDP_PARITY_LAYERS = "qwen3-8b", 4096, 2
FSDP_WARMUP, FSDP_STEPS = 2, 3
ADAFACTOR_STEPS = 2
ADAFACTOR_LAYOUTS = (
    ("tp4_sp", dict(tensor_parallel_size=4, sequence_parallel=True), False),
    ("pp2_ep2", dict(pipeline_parallel_size=2, expert_parallel_size=2,
                     gradient_accumulation_steps=2), True),
)
# PR 13's full-width ep4 Adafactor row (ledger: losses 12.20 -> 12.12)
REMAT_LAYOUTS = PARALLEL_LAYOUTS[1:3]  # cp4_ring_zigzag, cp4_ulysses
REMAT_STEPS = 3


def recorded_serve(eng, prompts, new_tokens: int) -> tuple:
    """Serve ``prompts`` tick by tick: (tokens per request, the logits of
    every prefill and decode replay, in order, as the steps returned
    them)."""
    ids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    logits = []
    while eng.pending:
        pre, dec = eng.metrics.prefill_calls, eng.metrics.decode_steps
        eng.step()
        if eng.metrics.prefill_calls != pre:
            logits.append(eng._prefill.outputs[1].clone())
        if eng.metrics.decode_steps != dec:
            logits.append(eng._decode.outputs[1].clone())
    results = [eng.result(i) for i in ids]
    check(all(r.outcome == "ok" for r in results),
          f"outcomes {[r.outcome for r in results]}")
    return [r.tokens for r in results], logits


def world1_engine(dev) -> dict:
    """The engine on a mesh of one (an NCCL group of one) against the
    plain engine on one set of weights, paged and dense: the tokens and
    every step's logits bit for bit, one capture of each step."""
    from scaletorch_tpu_torch.parallel.mesh import MeshManager

    cfg = model_config(MODEL, dtype=torch.bfloat16,
                       num_hidden_layers=WORLD1_SERVE_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = LlamaForCausalLM(cfg, dev).init_weights_(gen)
    prompts = traffic(cfg.vocab_size)[:SLOTS]
    mm = MeshManager(tp=1, device_type="cuda")
    row = {}
    for layout in ("paged", "dense"):
        runs = []
        for mesh in (None, mm):
            _build.reset_launch_counts()
            eng = serving_engine(model, cfg, cache_layout=layout,
                                 device=dev, mesh=mesh)
            runs.append(recorded_serve(eng, prompts, WORLD1_SERVE_TOKENS))
            cap = check_one_capture(eng, f"world 1 engine {layout}")
            del eng
            free_engine()
        (t0, l0), (t1, l1) = runs
        check(t0 == t1, f"world 1 engine {layout}: tokens differ")
        check(len(l0) == len(l1) and all(torch.equal(a, b)
                                         for a, b in zip(l0, l1)),
              f"world 1 engine {layout}: a step's logits differ")
        row[layout] = {"steps": len(l0), "bitwise_equal": True, **cap}
    mm.destroy()
    del model
    free_engine()
    return row


def train_pair(dev, build) -> dict:
    """``build(cfg, params, one_card) -> (optimizer, step or None, state or
    None, params)`` (None: ``make_train_step``'s step, ``init``'s state)
    on the mesh against one card, on the same seeded weights and
    batches: losses and final parameters bit for bit over
    WORLD1_TRAIN_STEPS steps."""
    from scaletorch_tpu_torch.data.dataloader import device_batch
    from scaletorch_tpu_torch.trainer.train_step import make_train_step

    cfg = model_config(MODEL, num_hidden_layers=WORLD1_TRAIN_LAYERS)
    batches = [device_batch(b, dev) for b, _ in zip(SyntheticDataLoader(
        vocab_size=cfg.vocab_size, sequence_length=WORLD1_TRAIN_SEQ,
        micro_batch_size=1, gradient_accumulation_steps=1, seed=11),
        range(WORLD1_TRAIN_STEPS))]
    out = []
    for which in ("one_card", "mesh"):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = init_params(cfg, gen, dev, requires_grad=True)
        opt, step, state, params = build(cfg, params,
                                         one_card=which == "one_card")
        if step is None:
            step = make_train_step(cfg, opt, attention_backend="flash",
                                   gradient_checkpointing=True,
                                   max_grad_norm=1.0)
        if state is None:
            state = opt.init(params)
        losses = []
        for b in batches:
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
        out.append((losses, [t.detach().clone() for t in
                             tree_leaves(params)]))
        del params, state
        free_engine()
    (l0, p0), (l1, p1) = out
    check(l0 == l1, f"losses {l1} != one card's {l0}")
    check(all(torch.equal(a, b) for a, b in zip(p0, p1)),
          "parameters differ from the one-card step's")
    return {"losses": l1, "bitwise_equal": True}


def world1_fsdp(dev) -> dict:
    """``setup_fsdp``'s step at N = 1 against the one-card step."""
    from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
    from scaletorch_tpu_torch.parallel.fsdp import setup_fsdp
    from scaletorch_tpu_torch.trainer.optimizer import create_optimizer

    def build(cfg, params, one_card):
        opt, _ = create_optimizer(ScaleTorchTPUArguments(
            learning_rate=1e-3, total_train_steps=10, warmup_steps=1))
        if one_card:
            return opt, None, None, params
        step, shards, state, _ = setup_fsdp(
            cfg, params, opt, device=dev, attention_backend="flash",
            gradient_checkpointing=True, max_grad_norm=1.0)
        return opt, step, state, shards

    return train_pair(dev, build)


def world1_adafactor(dev) -> dict:
    """The mesh step with Adafactor given the shard layout (a mesh of
    one) against the one-card Adafactor step."""
    from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
    from scaletorch_tpu_torch.parallel.mesh import MeshManager
    from scaletorch_tpu_torch.parallel.spmd import make_spmd_train_step
    from scaletorch_tpu_torch.parallel.tensor_parallel import shard_dims
    from scaletorch_tpu_torch.trainer.optimizer import create_optimizer

    args = ScaleTorchTPUArguments(optimizer_name="adafactor",
                                  learning_rate=1e-3, total_train_steps=10,
                                  warmup_steps=1)
    mm = MeshManager(tp=1, device_type="cuda")

    def build(cfg, params, one_card):
        if one_card:
            return create_optimizer(args)[0], None, None, params
        opt, _ = create_optimizer(args, shard_dims=shard_dims(cfg), mesh=mm)
        return opt, make_spmd_train_step(
            mm, cfg, opt, attention_backend="flash",
            gradient_checkpointing=True, max_grad_norm=1.0), None, params

    row = train_pair(dev, build)
    mm.destroy()
    return row


def nccl_capture_probe(world: int, dev) -> dict:
    """A CUDA graph holding one NCCL all-reduce, captured after a warm-up
    on the capture stream, replayed twice on new inputs: the sums must be
    right (the tp serving steps are built on this)."""
    from scaletorch_tpu_torch.parallel.mesh import MeshManager

    mm = MeshManager(tp=world, device_type="cuda")
    group = mm.group("tp")
    rank = mm.axis_rank("tp")
    x = torch.full((4096,), float(rank + 1), device=dev)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        torch.distributed.all_reduce(x, group=group)
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        torch.distributed.all_reduce(x, group=group)
    sums = []
    for scale in (1.0, 3.0):
        x.fill_(scale * (rank + 1))
        graph.replay()
        torch.cuda.synchronize(dev)
        sums.append(float(x[0]))
    want = [s * world * (world + 1) / 2 for s in (1.0, 3.0)]
    check(sums == want and bool((x == x[0]).all()),
          f"captured all-reduce gave {sums}, want {want}")
    del graph
    mm.destroy()
    return {"replayed_sums": sums, "want": want}


def engine_numbers(eng, stats: dict, dev) -> dict:
    return {**stats, "peak_memory_gb": torch.cuda.max_memory_allocated(dev)
            / 1e9, "decode_compile_count": eng.decode_compile_count,
            "prefill_compile_count": eng.prefill_compile_count}


def replay_ms(graph, dev, reps: int = 20) -> float:
    """A captured graph's device ms a replay (CUDA events around
    ``reps`` replays after one)."""
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def decode_breakdown(eng, mm, cfg, dev, calls: int = 100,
                     groups=(("tp", 2),)) -> dict:
    """Where a decode tick over a mesh goes (after the run; the replays
    rewrite the last step's cache lines): the captured decode step's
    device ms, a graph of its all-reduces of [slots, hidden] alone (for
    each (mesh axes, per layer) of ``groups``: tp's 2 a layer, or the
    MoE's one over tp and one over ``EXPERT_AXES``), and the host ms of
    the tick's rank-0 broadcast (``_agree``)."""
    x = torch.zeros(eng.max_slots, cfg.hidden_size, dtype=cfg.dtype,
                    device=dev)
    layers = cfg.num_hidden_layers
    plan = [(mm.group(axes), per) for axes, per in groups]
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        for group, _ in plan:
            torch.distributed.all_reduce(x, group=group)
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(layers):
            for group, per in plan:
                for _ in range(per):
                    torch.distributed.all_reduce(x, group=group)
    out = {"decode_replay_ms": replay_ms(eng._decode.graph, dev),
           "allreduces_graph_ms": replay_ms(graph, dev),
           "allreduces_per_step": layers * sum(per for _, per in groups)}
    del graph
    t0 = time.perf_counter()
    for _ in range(calls):
        eng._agree(([], False))
    out["host_agree_ms"] = 1e3 * (time.perf_counter() - t0) / calls
    return out


def mesh_model(model_cls, cfg, dev, mm):
    """``cfg``'s model drawn from seed 0 as one card draws it, this rank's
    slices over ``mm`` (None: the whole model)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return model_cls(cfg, dev, mesh=mm).init_weights_(gen)


def serve_over_meshes(what: str, head: dict, model_cls, cfg, meshes, dev,
                      want_decode: dict, want_prefill: dict, breakdown,
                      **serve_kw) -> dict:
    """The serve cell's 16 requests of 64 new tokens through a graphed
    paged engine: first on one card (rank 0, the others waiting), then
    over each (name, mesh sizes) of ``meshes``. Asserted on every rank:
    16/16 ok, one capture of each step, the launches of a decode replay
    ``want_decode`` and of a prefill replay ``want_prefill``, the same
    tokens on every rank. Emitted as ``what`` after ``head``, beside one
    card's: each mesh's decode tokens/s, TTFT mean, TPOT p50, the decode
    replay's ms, ``decode_breakdown``'s readings over ``breakdown(mm)``,
    peak memory a card and the greedy agreement."""
    from scaletorch_tpu_torch import dist as stdist
    from scaletorch_tpu_torch.parallel.mesh import MeshManager

    prompts = traffic(cfg.vocab_size)

    def run(where, mm):
        model = mesh_model(model_cls, cfg, dev, mm)
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launch_counts()
        eng, results, ptrs, stats = serve(model, cfg, prompts, None,
                                          device=dev, mesh=mm, **serve_kw)
        check_served(eng, results, ptrs, stats, where)
        cap = check_one_capture(eng, where)
        per_decode = cap["decode_launches_per_replay"]
        per_prefill = cap["prefill_launches_per_replay"]
        check(per_decode == want_decode and per_prefill == want_prefill,
              f"{where}: launches a decode replay {per_decode}, a prefill "
              f"replay {per_prefill}: want {want_decode} and "
              f"{want_prefill}")
        row = {"tokens": [r.tokens for r in results],
               **engine_numbers(eng, stats, dev), **cap,
               **({"decode_replay_ms": replay_ms(eng._decode.graph, dev)}
                  if mm is None else
                  decode_breakdown(eng, mm, cfg, dev, groups=breakdown(mm)))}
        del eng, model
        free_engine()
        return row

    rank = stdist.process_index()
    one = run(f"{what} one card", None) if rank == 0 else None
    stdist.barrier()
    row = {**head, "slots": SLOTS, "requests": len(prompts),
           "one_card": ({k: v for k, v in one.items() if k != "tokens"}
                        if one else None), "layouts": {}}
    for name, sizes in meshes:
        mm = MeshManager(**sizes, device_type="cuda")
        mine = run(f"{what} {name}", mm)
        mm.destroy()
        ranks = stdist.all_gather_object(mine)
        check(all(r["tokens"] == ranks[0]["tokens"] for r in ranks),
              f"{what} {name}: the ranks' tokens differ")
        row["layouts"][name] = {
            "mesh": sizes, **{k: v for k, v in ranks[0].items()
                              if k != "tokens"},
            "peak_memory_gb_per_card": [r["peak_memory_gb"] for r in ranks],
            "vs_one_card_greedy": (agreement(ranks[0]["tokens"],
                                             one["tokens"])
                                   if one else None)}
    if rank == 0:
        emit(what, **row)
    return row


def parity_over_meshes(what: str, head: dict, model_cls, cfg, meshes, dev,
                       positions: int, dense: bool) -> dict:
    """``cfg`` on one card and over each (name, mesh sizes) of
    ``meshes``, every rank computing each. Asserted on every rank: the
    teacher-forced logits of ``positions`` positions of 2 rows (paged
    through K4, and dense when ``dense``) within PARITY_TOLERANCE of one
    card's, and 4 greedy requests' tokens equal."""
    from scaletorch_tpu_torch import dist as stdist
    from scaletorch_tpu_torch.inference.kv_cache import (
        kv_cache_shardings,
        paged_kv_cache_shardings,
    )
    from scaletorch_tpu_torch.parallel.mesh import (
        MeshManager,
        using_mesh_manager,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (2, positions), generator=gen,
                           device=dev)
    prompts = traffic(cfg.vocab_size)[:4]
    out = {}
    for name, sizes in (("one_card", None),) + tuple(meshes):
        mm = None if sizes is None else MeshManager(**sizes,
                                                    device_type="cuda")
        model = mesh_model(model_cls, cfg, dev, mm)

        def shard(shardings):
            return {} if mm is None else {"sharding": shardings(mm)}

        got = {}
        with using_mesh_manager(mm), torch.inference_mode():
            if dense:
                got["dense"] = teacher_forced_decode(
                    model, cfg, tokens, **shard(kv_cache_shardings))
            got["paged"] = teacher_forced_decode_paged(
                model, cfg, tokens, page_size=PAGE_SIZE,
                **shard(paged_kv_cache_shardings))
        eng = serving_engine(model, cfg, device=dev, mesh=mm)
        got["served"], _ = recorded_serve(eng, prompts, 16)
        out[name] = got
        del eng, model
        free_engine()
        if mm is not None:
            mm.destroy()
    one = out.pop("one_card")
    layouts = {name: {**{f"{k}_max_abs": max_abs(got[k], one[k])
                         for k in ("dense", "paged") if k in got},
                      "greedy_tokens_equal": got["served"] == one["served"]}
               for name, got in out.items()}
    row = {**head, "tolerance": PARITY_TOLERANCE, "layouts": layouts}
    ranks = stdist.all_gather_object(layouts)
    if stdist.process_index() == 0:
        emit(what, **row, per_rank=ranks)
    for r in ranks:
        for name, got in r.items():
            check(all(v <= PARITY_TOLERANCE for k, v in got.items()
                      if k.endswith("_max_abs")),
                  f"{what} {name}: logits {got}")
            check(got["greedy_tokens_equal"],
                  f"{what} {name}: greedy tokens {got}")
    return row


def serve_tp4(world: int, dev) -> dict:
    """qwen3-32b at full width and depth, bf16, paged, 8 slots of
    PREFILL_LEN positions (65.5 GB of weights leave one card a small
    cache), on one card and over tp 4 (``serve_over_meshes``): K4 once a
    layer a decode replay, no kernel in a prefill replay."""
    cfg = model_config(TP_MODEL, dtype=torch.bfloat16)
    return serve_over_meshes(
        "serve_tp4", {"model": TP_MODEL, "dtype": "bfloat16"},
        LlamaForCausalLM, cfg, ((f"tp{world}", dict(tp=world)),), dev,
        {"paged_decode": cfg.num_hidden_layers}, {},
        lambda mm: (("tp", 2),), max_seq=PREFILL_LEN)


def tp_parity(world: int, dev) -> dict:
    """qwen3-32b's width cut to TP_PARITY_LAYERS layers, fp32, over tp 4
    against one card (``parity_over_meshes``, dense and paged)."""
    cfg = model_config(TP_MODEL, dtype=torch.float32,
                       num_hidden_layers=TP_PARITY_LAYERS)
    return parity_over_meshes(
        "tp_parity", {"model": TP_MODEL, "layers": TP_PARITY_LAYERS,
                      "dtype": "float32"},
        LlamaForCausalLM, cfg, ((f"tp{world}", dict(tp=world)),), dev,
        TP_PARITY_TOKENS, dense=True)


def serve_tp2_dp2_dense(world: int, dev) -> dict:
    """Qwen3-0.6B, fp32, dense, tp 2 x dp 2 with ``batch_axis="dp"``:
    each dp rank's slots, the tokens gathered; equal to the one-card dense
    engine's on every rank, one capture of each step."""
    from scaletorch_tpu_torch import dist as stdist
    from scaletorch_tpu_torch.parallel.mesh import MeshManager

    cfg = model_config(MODEL, dtype=torch.float32)
    prompts = traffic(cfg.vocab_size)
    runs = {}
    for which in ("one_card", "tp2_dp2"):
        mm = (MeshManager(tp=2, dp=world // 2, device_type="cuda")
              if which != "one_card" else None)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        model = LlamaForCausalLM(cfg, dev, mesh=mm).init_weights_(gen)
        _build.reset_launch_counts()
        eng = serving_engine(model, cfg, cache_layout="dense", device=dev,
                             mesh=mm, batch_axis="dp" if mm else None)
        tokens, _ = recorded_serve(eng, prompts, 32)
        runs[which] = (tokens, check_one_capture(eng, which),
                       tuple(eng.cache.k.shape))
        del eng, model
        free_engine()
        if mm is not None:
            mm.destroy()
    same = runs["one_card"][0] == runs["tp2_dp2"][0]
    ranks = stdist.all_gather_object({"same": same,
                                      "cache_shape": runs["tp2_dp2"][2]})
    row = {"model": MODEL, "dtype": "float32", "layout": "dense",
           "mesh": {"tp": 2, "dp": world // 2}, "batch_axis": "dp",
           "requests": len(prompts), "tokens_equal_one_card": same,
           "cache_shape_per_rank": [r["cache_shape"] for r in ranks],
           **runs["tp2_dp2"][1]}
    if stdist.process_index() == 0:
        emit("serve_tp2_dp2_dense", **row)
    check(all(r["same"] for r in ranks),
          "serve_tp2_dp2_dense: tokens differ from one card's")
    return row


def fsdp4(world: int, dev) -> dict:
    """FSDP over the four cards, qwen3-8b, seq FSDP_SEQ a rank, GC, flash:
    the fp32 loss and gradients at FSDP_PARITY_LAYERS layers against one
    card (TRAIN_PARITY); then bf16 compute over fp32 masters at full
    depth with AdamW, FSDP_WARMUP + FSDP_STEPS steps: step s, tokens/s,
    MFU and peak memory a card, K1/K2/K3 launches a step (2L/L/L, GC),
    and each rank's parameter and AdamW elements 1/N of the model's
    (both asserted)."""
    from scaletorch_tpu_torch import dist as stdist
    from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
    from scaletorch_tpu_torch.data.dataloader import device_batch
    from scaletorch_tpu_torch.models import llama
    from scaletorch_tpu_torch.parallel import fsdp as tfsdp
    from scaletorch_tpu_torch.parallel.spmd import local_batch
    from scaletorch_tpu_torch.trainer.optimizer import create_optimizer
    from scaletorch_tpu_torch.trainer.train_step import (
        make_grad_fn,
        make_train_step,
    )
    from scaletorch_tpu_torch.utils.device import get_theoretical_flops
    from scaletorch_tpu_torch.utils.misc import get_mfu

    mm = tfsdp.make_fsdp_mesh(world, device_type="cuda")
    t0 = time.monotonic()
    cfg32 = model_config(FSDP_MODEL, dtype=torch.float32,
                         num_hidden_layers=FSDP_PARITY_LAYERS)
    batch = next(iter(SyntheticDataLoader(
        vocab_size=cfg32.vocab_size, sequence_length=FSDP_SEQ,
        micro_batch_size=world, gradient_accumulation_steps=1, seed=11)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    full = init_params(cfg32, gen, dev, requires_grad=True)
    ref_loss, _, ref_grads = make_grad_fn(
        cfg32, attention_backend="flash", gradient_checkpointing=True)(
        full, device_batch(batch, dev))
    specs = tfsdp.fsdp_param_specs(full, world)
    shards = tfsdp.shard_params_fsdp(mm, full, specs)
    names = list(flatten_params(full))
    flat_specs = flatten_params(specs)
    ref = [tfsdp._slice(g, flat_specs[n], world, mm.axis_rank("dp"))
           for n, g in zip(names, ref_grads)]
    del full, ref_grads
    free_engine()
    loss, _, grads = make_grad_fn(
        cfg32, attention_backend="flash", gradient_checkpointing=True,
        mesh=tfsdp.FsdpReductions(mm, specs))(
        shards, device_batch(local_batch(batch, mm), dev))
    d2 = sum(float((g.double() - r.double()).square().sum())
             for g, r in zip(grads, ref))
    r2 = sum(float(r.double().square().sum()) for r in ref)
    sums = torch.tensor([d2, r2], dtype=torch.float64, device=dev)
    torch.distributed.all_reduce(sums, group=mm.group("dp"))
    parity = {"loss": float(loss), "loss_one_card": float(ref_loss),
              "loss_abs_diff": abs(float(loss) - float(ref_loss)),
              "grad_rel_l2_diff": float((sums[0] / sums[1]).sqrt())}
    check(parity["loss_abs_diff"] <= TRAIN_PARITY["loss_abs"]
          and parity["grad_rel_l2_diff"] <= TRAIN_PARITY["grad_rel"],
          f"fsdp4 parity {parity}")
    del shards, grads, ref
    free_engine()
    # bf16 compute over fp32 masters, full depth
    cfg = model_config(FSDP_MODEL)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    shapes = {n: torch.empty(s, device="meta")
              for n, (s, _) in llama._param_shapes(cfg).items()}
    specs = tfsdp.fsdp_param_specs(
        {"layers": {n[7:]: t for n, t in shapes.items()
                    if n.startswith("layers.")},
         **{n: t for n, t in shapes.items() if not n.startswith("layers.")}},
        world)
    params = init_params(cfg, gen, dev, requires_grad=True,
                         local_slice=tfsdp.fsdp_local_slice(specs, mm))
    opt, _ = create_optimizer(ScaleTorchTPUArguments(
        learning_rate=1e-4, total_train_steps=100, warmup_steps=1))
    state = opt.init(params)
    step = tfsdp.make_fsdp_train_step(cfg, opt, mm, specs=specs,
                                      attention_backend="flash",
                                      gradient_checkpointing=True,
                                      max_grad_norm=1.0)
    local = tfsdp.local_numel(params)
    state_local = sum(tfsdp.local_numel(state[k]) for k in ("mu", "nu"))
    check(local * world == cfg.num_params() and state_local == 2 * local,
          f"fsdp4: a rank holds {local} of {cfg.num_params()} elements, "
          f"{state_local} of AdamW state")
    loader = iter(SyntheticDataLoader(
        vocab_size=cfg.vocab_size, sequence_length=FSDP_SEQ,
        micro_batch_size=world, gradient_accumulation_steps=1, seed=12))
    losses = []
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(FSDP_WARMUP + FSDP_STEPS):
        if i == FSDP_WARMUP:
            torch.cuda.synchronize(dev)
            _build.reset_launch_counts()
            tw = time.perf_counter()
        b = device_batch(local_batch(next(loader), mm), dev)
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        check(float(m["update_skipped"]) == 0.0, "fsdp4: a skipped update")
    step_s = (time.perf_counter() - tw) / FSDP_STEPS
    launches = {n: _build.launch_counts.get(n, 0) / FSDP_STEPS
                for n in LAUNCH_NAMES}
    want = layout_launches({}, 0, cfg.num_hidden_layers)
    check(launches == want, f"fsdp4: launches a step {launches}, want "
                            f"{want}")
    tok_s = world * FSDP_SEQ / step_s
    peak = world * get_theoretical_flops(torch.cuda.get_device_name(dev))
    mfu = get_mfu(tok_s, cfg.num_params(), cfg.num_hidden_layers,
                  cfg.num_attention_heads, cfg.actual_head_dim, FSDP_SEQ,
                  peak_flops=peak)
    mine = {"peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "param_elements": local, "adamw_elements": state_local}
    del params, state, step
    free_engine()
    mm.destroy()
    ranks = stdist.all_gather_object(mine)
    row = {"model": FSDP_MODEL, "sequence_length": FSDP_SEQ, "world": world,
           "parity_fp32": {"layers": FSDP_PARITY_LAYERS, **parity},
           "num_params": cfg.num_params(), "losses": losses,
           "step_s": step_s, "tokens_per_s": tok_s,
           "tokens_per_s_per_card": tok_s / world, "mfu_per_card": mfu,
           "launches_per_step": launches,
           "peak_memory_gb_per_card": [r["peak_memory_gb"] for r in ranks],
           "param_elements_per_card": [r["param_elements"] for r in ranks],
           "adamw_elements_per_card": [r["adamw_elements"] for r in ranks],
           "seconds": time.monotonic() - t0}
    check(all(np.isfinite(losses)), f"fsdp4: losses {losses}")
    if stdist.process_index() == 0:
        emit("fsdp4", **row)
    return row


def adafactor_parity(name: str, opts: dict, cfg32, batch, dev) -> dict:
    """ADAFACTOR_STEPS Adafactor steps of the layout (the shard layout
    given to the optimizer) against the one-card Adafactor steps on the
    same weights and global batch: the loss and the parameters' change,
    as the whole model's relative L2 difference (``shard_diff``)."""
    from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
    from scaletorch_tpu_torch.data.dataloader import device_batch
    from scaletorch_tpu_torch.models.convert import local_shard_fn
    from scaletorch_tpu_torch.parallel.mesh import MeshManager
    from scaletorch_tpu_torch.parallel.pipeline_parallel import (
        stage_layer_layout,
    )
    from scaletorch_tpu_torch.parallel.spmd import (
        local_batch,
        make_spmd_train_step,
    )
    from scaletorch_tpu_torch.parallel.tensor_parallel import shard_dims
    from scaletorch_tpu_torch.trainer.optimizer import create_optimizer
    from scaletorch_tpu_torch.trainer.train_step import make_train_step

    args = ScaleTorchTPUArguments(optimizer_name="adafactor",
                                  learning_rate=1e-3, total_train_steps=10,
                                  warmup_steps=1)
    model = qwen3_moe if hasattr(cfg32, "num_experts") else None

    def draw(local_slice=None):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        kw = dict(requires_grad=True, local_slice=local_slice)
        return (model.init_params(cfg32, gen, dev, **kw) if model
                else init_params(cfg32, gen, dev, **kw))

    params = draw()
    before = {n: t.detach().to("cpu", copy=True)
              for n, t in flatten_params(params).items()}
    opt = create_optimizer(args)[0]
    state = opt.init(params)
    step = make_train_step(cfg32, opt, attention_backend="flash",
                           gradient_checkpointing=True, max_grad_norm=1.0)
    for _ in range(ADAFACTOR_STEPS):
        params, state, m = step(params, state, device_batch(batch, dev))
    ref_loss = float(m["loss"])
    ref = {n: t.detach().to("cpu", copy=True) - before[n]
           for n, t in flatten_params(params).items()}
    del params, state, step, before
    free_engine()
    mm = MeshManager(dp=opts.get("data_parallel_size", 1),
                     pp=opts.get("pipeline_parallel_size", 1),
                     ep=opts.get("expert_parallel_size", 1),
                     tp=opts.get("tensor_parallel_size", 1),
                     device_type="cuda")
    slicer = local_shard_fn(cfg32, mm, mm.rank, layout=stage_layer_layout(
        cfg32.num_hidden_layers, mm.pp, "afab", 1))
    params = draw(slicer)
    before = [t.detach().clone() for t in tree_leaves(params)]
    opt, _ = create_optimizer(args, shard_dims=shard_dims(cfg32), mesh=mm)
    state = opt.init(params)
    step = make_spmd_train_step(
        mm, cfg32, opt, attention_backend="flash",
        gradient_checkpointing=True, max_grad_norm=1.0,
        sequence_parallel=opts.get("sequence_parallel", False))
    lb = device_batch(local_batch(batch, mm), dev)
    for _ in range(ADAFACTOR_STEPS):
        params, state, m = step(params, state, lb)
    names = list(flatten_params(params))
    deltas = [t.detach() - b for t, b in zip(tree_leaves(params), before)]
    parity = shard_diff(mm, cfg32, params, deltas,
                        [slicer(n, ref[n]).to(dev) for n in names])
    parity.update(loss=float(m["loss"]), loss_one_card=ref_loss,
                  loss_abs_diff=abs(float(m["loss"]) - ref_loss))
    mm.destroy()
    del params, state, step, deltas, ref
    free_engine()
    return parity


def adafactor_layouts(world: int, dev) -> dict:
    """The headline row (fp32, full depth) under tp4_sp and Qwen3-30B-A3B's
    width cut to 2 layers under pp2_ep2: Adafactor's update against one
    card's (TRAIN_PARITY); then PR 13's full-width ep4 Adafactor row again
    (``MOE_FULL``), its losses to read beside PR 13's."""
    from scaletorch_tpu_torch import dist as stdist

    out = {}
    for name, opts, moe in ADAFACTOR_LAYOUTS:
        cfg32 = (model_config(MOE_MODEL, dtype=torch.float32,
                              num_hidden_layers=MOE_LAYOUT_LAYERS,
                              use_grouped_mlp_kernel=True) if moe
                 else model_config(MODEL, dtype=torch.float32))
        seq = MOE_TRAIN_SEQ if moe else TRAIN_SEQ
        rows = (opts.get("data_parallel_size", 1)
                * opts.get("expert_parallel_size", 1))
        batch = next(iter(SyntheticDataLoader(
            vocab_size=cfg32.vocab_size, sequence_length=seq,
            micro_batch_size=rows,
            gradient_accumulation_steps=opts.get(
                "gradient_accumulation_steps", 1), seed=11)))
        parity = adafactor_parity(name, opts, cfg32, batch, dev)
        ranks = stdist.all_gather_object(parity)
        for r in ranks:
            check(r["loss_abs_diff"] <= TRAIN_PARITY["loss_abs"]
                  and r["grad_rel_l2_diff"] <= TRAIN_PARITY["grad_rel"],
                  f"adafactor {name}: {r}")
        out[name] = {"options": opts, "steps": ADAFACTOR_STEPS,
                     "parity": ranks[0], "parity_per_rank": ranks}
        if stdist.process_index() == 0:
            emit("adafactor_layout", name=name, **out[name])
    full = f"{MOE_MODEL}_ep4_full_width_adafactor"
    out[full] = timed_layout(full, make_bench_args(
        MOE_MODEL, seq=MOE_TRAIN_SEQ, gc=True,
        extra={**MOE_FULL, "distributed_launcher": "env"}), MOE_FULL, world,
        True, None, time.monotonic())
    return out


def cp_timing(world: int, dev) -> dict:
    """The bf16 step of cp4_ring_zigzag and cp4_ulysses under
    ``nothing_saveable`` alone (2 + LAYOUT_STEPS steps): run from a
    checkout of another commit with this script copied in, it times that
    commit's cp backends by the same yardstick."""
    return {name: timed_layout(f"{name}_timing", parallel_cfg(opts), opts,
                               world, False, None, time.monotonic())
            for name, opts in REMAT_LAYOUTS}


def remat_cp(world: int, dev) -> dict:
    """The headline row under cp4_ring_zigzag and cp4_ulysses with each
    remat policy: the fp32 loss and gradients bit for bit against the
    same layout's ``nothing_saveable`` (one set of weights and one global
    batch), K1/K2/K3 launches a rank as the policy reckons them
    (``save_attn`` keeps the backend's op: one forward), then the bf16
    Trainer's step s, 2 + REMAT_STEPS steps."""
    from scaletorch_tpu_torch import dist as stdist
    from scaletorch_tpu_torch.data.dataloader import device_batch
    from scaletorch_tpu_torch.models.convert import local_shard_fn
    from scaletorch_tpu_torch.parallel.mesh import MeshManager
    from scaletorch_tpu_torch.parallel.spmd import (
        local_batch,
        make_spmd_grad_fn,
    )

    cfg32 = model_config(MODEL, dtype=torch.float32)
    batch = next(iter(SyntheticDataLoader(
        vocab_size=cfg32.vocab_size, sequence_length=TRAIN_SEQ,
        micro_batch_size=1, gradient_accumulation_steps=1, seed=11)))
    out = {}
    for name, opts in REMAT_LAYOUTS:
        mm = MeshManager(cp=world, device_type="cuda")
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = init_params(cfg32, gen, dev, requires_grad=True,
                             local_slice=local_shard_fn(cfg32, mm, mm.rank))
        layout = opts.get("cp_layout", "zigzag")
        lb = device_batch(local_batch(
            batch, mm, zigzag=opts["attention_backend"] == "ring"
            and layout == "zigzag"), dev)
        base = None
        rows = {}
        for policy in REMAT_POLICIES:
            fn = make_spmd_grad_fn(mm, cfg32,
                                   attention_backend=opts["attention_backend"],
                                   gradient_checkpointing=True,
                                   remat_policy=policy, cp_layout=layout)
            _build.reset_launch_counts()
            loss, grads = fn(params, lb)
            launches = {n: _build.launch_counts.get(n, 0)
                        for n in LAUNCH_NAMES}
            want = layout_launches({**opts, "remat_policy": policy},
                                   mm.axis_rank("cp"),
                                   cfg32.num_hidden_layers)
            grads = [g.detach().cpu() for g in grads]
            if base is None:
                base = (float(loss), grads)
            same = (float(loss) == base[0]
                    and all(torch.equal(a, b) for a, b in zip(grads, base[1])))
            rows[policy] = {"loss": float(loss), "bitwise_equal": same,
                            "launches": launches, "want": want}
            del grads
        mm.destroy()
        del params, base
        free_engine()
        ranks = stdist.all_gather_object(rows)
        for r, per in enumerate(ranks):
            for policy, res in per.items():
                check(res["bitwise_equal"],
                      f"{name} {policy} rank {r}: not bit for bit "
                      "nothing_saveable's")
                check(res["launches"] == res["want"],
                      f"{name} {policy} rank {r}: launches "
                      f"{res['launches']}, want {res['want']}")
        steps = {}
        for policy in REMAT_POLICIES:
            popts = {**opts, "remat_policy": policy}
            cfg = make_bench_args(MODEL, seq=TRAIN_SEQ, gc=True,
                                  remat_policy=policy,
                                  extra={**opts,
                                         "distributed_launcher": "env"})
            steps[policy] = timed_layout(f"{name}_{policy}", cfg, popts,
                                         world, False, None,
                                         time.monotonic(),
                                         steps=REMAT_STEPS)
        out[name] = {"fp32": ranks, "bf16": {
            p: {"step_s": r["step_s"], "peak_memory_gb_per_card":
                r["peak_memory_gb_per_card"],
                "launches_per_step": r["launches_per_step"]}
            for p, r in steps.items()}}
        if stdist.process_index() == 0:
            emit("remat_cp", name=name, **out[name])
    return out


# ---- 20b. the Qwen3-MoE engine over tp x ep ------------------------------------
# the serving meshes of Qwen3-30B-A3B on four cards: its experts over ep 4,
# and over ep 2 with their intermediate dim and the heads over tp 2
MOE_MESH_LAYOUTS = (("ep4", dict(ep=4)), ("tp2_ep2", dict(tp=2, ep=2)))
MOE_MESH_TOKENS = 64  # teacher-forced decode positions of moe_mesh_parity


def moe_mesh_parity(world: int, dev) -> dict:
    """Qwen3-30B-A3B's width cut to MOE_DECODE_PARITY_LAYERS layers,
    fp32, dropless, K4 + K5, over each of MOE_MESH_LAYOUTS against one
    card (``parity_over_meshes``, paged)."""
    cfg = model_config(MOE_MODEL, dtype=torch.float32,
                       num_hidden_layers=MOE_DECODE_PARITY_LAYERS,
                       capacity_factor=DROPLESS_CF,
                       use_grouped_mlp_kernel=True)
    return parity_over_meshes(
        "moe_mesh_parity", {"model": MOE_MODEL,
                            "layers": cfg.num_hidden_layers,
                            "dtype": "float32",
                            "capacity_factor": cfg.capacity_factor},
        Qwen3MoEForCausalLM, cfg, MOE_MESH_LAYOUTS, dev, MOE_MESH_TOKENS,
        dense=False)


def serve_moe_ep4(world: int, dev) -> dict:
    """Qwen3-30B-A3B at full width and depth, bf16, dropless, paged, on
    one card and over each of MOE_MESH_LAYOUTS (``serve_over_meshes``):
    K4 = K5 = 48 a decode replay and K5 = 48 a prefill replay; the
    breakdown times attention's all-reduce over tp (at tp > 1) and the
    experts' over ``EXPERT_AXES``."""
    from scaletorch_tpu_torch.parallel.mesh import EXPERT_AXES

    cfg = model_config(MOE_MODEL, dtype=torch.bfloat16,
                       capacity_factor=DROPLESS_CF,
                       use_grouped_mlp_kernel=True)
    layers = cfg.num_hidden_layers
    return serve_over_meshes(
        "serve_moe_ep4", {"model": MOE_MODEL, "layers": layers,
                          "dtype": "bfloat16",
                          "capacity_factor": cfg.capacity_factor},
        Qwen3MoEForCausalLM, cfg, MOE_MESH_LAYOUTS, dev,
        {"paged_decode": layers, gm.K5_NAME: layers}, {gm.K5_NAME: layers},
        lambda mm: ((("tp", 1),) if mm.tp > 1 else ()) + ((EXPERT_AXES, 1),))


def examples_group(world: int, dev) -> dict:
    """The examples at the reference's defaults over four cards
    (``run_examples``), emitted by rank 0."""
    from scaletorch_tpu_torch import dist as stdist

    out = run_examples(world, dev)
    if stdist.process_index() == 0:
        emit("examples", world=world, runs=out)
    return out


# GPT-MoE over tp: the minGPT example's width (GPTMoEConfig's defaults)
GPT_TP_MESHES = (("tp2_dp2", {"tp": 2, "dp": 2}), ("tp4", {"tp": 4}))


def serve_gpt_moe_tp(world: int, dev) -> dict:
    """GPT-MoE at the minGPT example's width (n_embd 128, 4 heads, 4
    layers, 8 experts, top-2), fp32, GPT_WEIGHT_SCALE, at the dropless
    GPT_DROPLESS_CF (at 1.25 a row's capacity turns a last-bit difference
    of the tp sums into another expert's output), gpt_moe_serve's 16
    requests through the graphed paged engine: on one card (rank 0, the
    others waiting), then over each of GPT_TP_MESHES (each rank its heads
    and expert slices, dp replicas whole). Asserted on every rank: every
    outcome ok, one capture of each step, K4 once a layer a decode replay
    and never in a prefill replay, the greedy tokens of one card (every
    rank's agreement emitted first). TPOT and the decode replay's ms
    beside one card's."""
    from scaletorch_tpu_torch import dist as stdist
    from scaletorch_tpu_torch.parallel.mesh import MeshManager

    cfg = GPTMoEConfig(capacity_factor=GPT_DROPLESS_CF)
    params = gpt_moe.scale_matrices(gpt_moe.init_params(
        torch.Generator(device=dev).manual_seed(0), cfg, device=dev),
        GPT_WEIGHT_SCALE)
    prompts = gpt_traffic(cfg.vocab_size)
    kw = dict(max_slots=GPT_SLOTS, max_seq=GPT_MAX_SEQ,
              prefill_len=GPT_PREFILL, page_size=GPT_PAGE)

    def run(where, mm):
        model = GPTMoEForCausalLM.from_params(params, cfg, dev, mesh=mm)
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launch_counts()
        eng, results, ptrs, stats = serve(model, cfg, prompts, None,
                                          device=dev, mesh=mm, **kw)
        check_served(eng, results, ptrs, stats, where)
        cap = check_one_capture(eng, where)
        per_decode = cap["decode_launches_per_replay"].get("paged_decode")
        check(per_decode == cfg.n_layer
              and not cap["prefill_launches_per_replay"].get("paged_decode"),
              f"{where}: K4 {per_decode} a decode replay (want "
              f"{cfg.n_layer}), {cap['prefill_launches_per_replay']} a "
              "prefill replay (want none)")
        row = {"tokens": [r.tokens for r in results],
               "attn_qkv_shape": list(model.layers["attn_qkv"].shape),
               "expert_fc_shape": list(model.layers["expert_fc"].shape),
               **engine_numbers(eng, stats, dev), **cap,
               "decode_replay_ms": replay_ms(eng._decode.graph, dev)}
        del eng, model
        free_engine()
        return row

    rank = stdist.process_index()
    one = run("serve_gpt_moe_tp one card", None) if rank == 0 else None
    one_tokens = stdist.broadcast_object_list(
        [one["tokens"] if one else None])[0]
    row = {"config": {"n_embd": cfg.n_embd, "n_head": cfg.n_head,
                      "n_layer": cfg.n_layer, "experts": cfg.num_experts,
                      "top_k": cfg.top_k, "block_size": cfg.block_size,
                      "capacity_factor": cfg.capacity_factor},
           "dtype": "float32", "weight_scale": GPT_WEIGHT_SCALE,
           "slots": GPT_SLOTS, "requests": len(prompts),
           "one_card": ({k: v for k, v in one.items() if k != "tokens"}
                        if one else None), "layouts": {}}
    for name, sizes in GPT_TP_MESHES:
        mm = MeshManager(**sizes, device_type="cuda")
        mine = run(f"serve_gpt_moe_tp {name}", mm)
        mm.destroy()
        mine["vs_one_card_greedy"] = agreement(mine.pop("tokens"),
                                               one_tokens)
        ranks = stdist.all_gather_object(mine)
        row["layouts"][name] = {
            "mesh": sizes, **ranks[0],
            "per_rank_vs_one_card": [r["vs_one_card_greedy"] for r in ranks],
            "per_rank_tpot_p50_s": [r["tpot_p50_s"] for r in ranks]}
    if rank == 0:
        emit("serve_gpt_moe_tp", **row)
    for name, got in row["layouts"].items():
        check(all(a["tokens"] == 1.0
                  and a["requests"] == f"{len(prompts)}/{len(prompts)}"
                  for a in got["per_rank_vs_one_card"]),
              f"serve_gpt_moe_tp {name}: greedy tokens differ from one "
              f"card's: {got['per_rank_vs_one_card']}")
    return row


def phase_parallel(groups=PARALLEL_GROUPS, timeout=None) -> dict:
    """``torch.distributed.run`` of ``parallel_worker`` with one rank a
    visible card, under ``timeout`` s (PARALLEL_TIMEOUT_S of the world
    by default); any failed rank fails it. ``groups``: the four-card
    groups to run (PARALLEL_GROUPS)."""
    world = torch.cuda.device_count()
    check(world in (1, 4), f"parallel: runs on 1 or 4 cards, found {world}")
    limit = PARALLEL_TIMEOUT_S[world] if timeout is None else timeout
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    os.makedirs(PARALLEL_DIR)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={world}", os.path.abspath(__file__),
           "--parallel-worker", os.path.abspath(PARALLEL_DIR),
           ",".join(groups)]
    t0 = time.monotonic()
    # the ranks' output goes to stderr: stdout ends with the contract lines;
    # segments that grow keep the large layouts' memory unfragmented
    env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    proc = subprocess.Popen(cmd, stdout=sys.stderr, stderr=sys.stderr,
                            start_new_session=True, env=env)
    try:
        rc = proc.wait(timeout=limit)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        try:  # every process the launcher started
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    check(rc is not None,
          f"parallel: no end within {limit} s")
    check(rc == 0, f"parallel: torch.distributed.run exited {rc}")
    with open(os.path.join(PARALLEL_DIR, "result.json")) as f:
        result = json.load(f)
    emit("parallel", seconds=time.monotonic() - t0, **{
        k: v for k, v in result.items() if k != "layouts"})
    return result


# ---- 18b. the multi-process runtime ----------------------------------------------
# one card: the process-group checkpoint path, a restore, and 2 CPU ranks
# at tp2 restoring and exporting the card's checkpoint; four cards
# (``phase_runtime_fleet``): the NCCL abort probe and the fleet drills
MULTIPROC_STEPS = 2
MULTIPROC_TP = 2
FLEET_DIR = os.path.join("build", "fleet")
FLEET_TIMEOUT_S = 900
FLEET_STEPS = 6
# the elastic deadline on the cards: the groups' timeout (NCCL's watchdog
# ends a rank blocked on a lost peer there), the suspect round twice that
# (the trainer's rule); a 7.15 GB save and a rank's set-up at full width
# stay well inside it
ELASTIC_DEADLINE_S = 10.0
# a survivor's end after the kill: the watchdog's deadline, then the
# process's teardown. With NCCL's debug dump on, its 60 s wait came
# first (the survivors ended 70.7-73.0 s after the kill on four H100s);
# the elastic launch turns it off (launch.ELASTIC_NCCL_ENV), and they
# ended 10.95-12.78 s after the kill
ELASTIC_DETECT_LIMIT_S = ELASTIC_DEADLINE_S + 10.0
# the wedged rank's stall: past the survivors' deadline
ELASTIC_HANG_S = 2 * ELASTIC_DEADLINE_S + 10.0
COORD_WINDOWS, COORD_WINDOW_STEPS = 3, 10
NCCL_PROBE_TIMEOUT_S = 20.0


def leaf_digests(tree, prefix: str = "") -> dict:
    """sha256 of each leaf's bytes, by dotted name (a bit-for-bit check
    across processes without moving the tensors)."""
    import hashlib

    out = {}
    for name, t in flatten_params(tree).items():
        a = t.detach().to("cpu").contiguous()
        out[prefix + name] = hashlib.sha256(
            a.reshape(-1).view(torch.uint8).numpy().tobytes()).hexdigest()
    return out


def state_digests(state, shard=None) -> dict:
    """``leaf_digests`` of an optimizer state (its parameter-shaped trees
    cut by ``shard(name, leaf)`` when given)."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            if shard is not None:
                v = {n: shard(n, t) for n, t in flatten_params(v).items()}
            out.update(leaf_digests(v, f"{k}."))
        else:
            out.update(leaf_digests({k: v}))
    return out


def shard_digests(trainer, mm) -> list:
    """Per rank of ``mm``: the digests of the slices that rank holds of
    ``trainer``'s (whole) parameters and optimizer state."""
    from scaletorch_tpu_torch.models.convert import local_shard_fn

    out = []
    for rank in range(mm.world_size):
        cut = local_shard_fn(trainer.model_cfg, mm, rank)

        def shard(name, t, cut=cut):
            return cut(name, t.detach().to("cpu"))

        params = {n: shard(n, t)
                  for n, t in flatten_params(trainer.params).items()}
        out.append({**leaf_digests(params, "params."),
                    **state_digests(trainer.opt_state, shard)})
    return out


def trainer_digests(trainer) -> dict:
    return {**leaf_digests(trainer.params, "params."),
            **state_digests(trainer.opt_state)}


def same_files(a: str, b: str) -> bool:
    names = sorted(os.listdir(a))
    if names != sorted(os.listdir(b)):
        return False
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            while True:
                x, y = fa.read(1 << 24), fb.read(1 << 24)
                if x != y:
                    return False
                if not x:
                    break
    return True


def launch_ranks(nproc: int, worker: list, directory: str, *,
                 elastic: bool = False, max_restarts: int = 0,
                 membership: str = None, env: dict = None,
                 timeout: float = FLEET_TIMEOUT_S) -> int:
    """``scaletorch_tpu_torch.launch`` of ``nproc`` ranks of this script's
    ``worker`` (``--fleet-worker ...``), output to stderr, every process
    stopped by the end; its exit code."""
    cmd = [sys.executable, "-m", "scaletorch_tpu_torch.launch",
           "--nproc", str(nproc), "--rdzv-dir",
           os.path.join(directory, "rdzv"), "--timeout", str(timeout),
           "--events", os.path.join(directory, "events.jsonl"),
           "--max-restarts", str(max_restarts)]
    if elastic:
        cmd += ["--elastic"]
    if membership:
        cmd += ["--membership-dir", membership]
    cmd += ["--", sys.executable, os.path.abspath(__file__)] + worker
    proc = subprocess.Popen(cmd, stdout=sys.stderr, stderr=sys.stderr,
                            start_new_session=True,
                            env={**os.environ, **(env or {})},
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        rc = proc.wait(timeout=timeout + 60)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    check(rc is not None, f"{worker}: no end within {timeout} s")
    return rc


def rank_results(directory: str, every: bool = False):
    """The ``result_r<rank>_a<attempt>_p<pid>.json`` of a launch: by
    (rank, attempt), the newest of each (a fleet restart starts the
    attempts again); with ``every``, all of them, oldest first."""
    every_r = []
    for name in os.listdir(directory):
        if name.startswith("result_r") and name.endswith(".json"):
            with open(os.path.join(directory, name)) as f:
                every_r.append(json.load(f))
    every_r.sort(key=lambda r: r["start"])
    if every:
        return every_r
    return {(r["rank"], r["attempt"]): r for r in every_r}


def launch_events(directory: str) -> list:
    with open(os.path.join(directory, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def write_rank_result(directory: str, result: dict) -> None:
    from scaletorch_tpu_torch import dist as stdist

    path = os.path.join(directory, f"result_r{result['rank']}_a"
                        f"{stdist.restart_count()}_p{os.getpid()}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(result, f)
    os.replace(path + ".tmp", path)


def multiproc_cfg(ckpt: str, **kw):
    """The headline row cut to DRILL_LAYERS (fp32 masters, AdamW)
    checkpointed to ``ckpt``."""
    cfg = make_bench_args(MODEL, seq=TRAIN_SEQ, gc=True)
    return dataclasses.replace(cfg, num_hidden_layers=DRILL_LAYERS,
                               checkpoint_dir=ckpt, keep_n_checkpoints=1,
                               async_checkpointing=True, log_frequency=1,
                               total_train_steps=MULTIPROC_STEPS, **kw)


def phase_runtime_multiproc() -> dict:
    """The checkpoint's process-group path on one card (a world-1 NCCL
    group): MULTIPROC_STEPS steps, a save (global tensors through DCP
    over the checkpoint's gloo group), a restore in a new Trainer bit for
    bit; then MULTIPROC_TP CPU gloo ranks at tp2 restore that checkpoint
    (each holds its slices of the card's tensors bit for bit) and export
    it sharded, byte-equal to the card's one-card export."""
    import torch.distributed as dist

    from scaletorch_tpu_torch.parallel.mesh import MeshManager

    root = os.path.abspath(runtime_root("multiproc"))
    ckpt = os.path.join(root, "ckpt")
    emit("runtime_multiproc_disk", free_gb=shutil.disk_usage(root).free / 1e9)
    dist.init_process_group(
        "nccl", init_method=f"file://{root}/store", world_size=1, rank=0,
        device_id=torch.device("cuda", 0))
    try:
        t = Trainer(multiproc_cfg(ckpt))
        mgr = t.checkpoint_manager
        check(mgr._global and t.mm.mesh is not None,
              "runtime_multiproc: the trainer is not on the process-group "
              "checkpoint path")
        losses = [float(t.step()["loss"]) for _ in range(MULTIPROC_STEPS)]
        check(all(np.isfinite(losses)), f"runtime_multiproc: losses {losses}")
        check(t.save_checkpoint() and mgr.wait(),
              "runtime_multiproc: the save failed")
        save = mgr.saves[-1]
        step = t.global_step
        row = {"losses": losses, "step": step,
               "save_blocking_s": save["blocking_s"],
               "save_total_s": save["total_s"],
               "checkpoint_bytes": mgr.step_bytes(step),
               "bytes_per_rank": [mgr.rank_bytes(step, 0)]}
        t0 = time.perf_counter()
        t.export_hf(os.path.join(root, "hf_one"), dtype="bfloat16",
                    max_shard_bytes=HF_SHARD_BYTES)
        row["export_s"] = time.perf_counter() - t0
        want = shard_digests(t, MeshManager(tp=MULTIPROC_TP))
        r = Trainer(multiproc_cfg(ckpt, resume="must"))
        check(r.global_step == step, f"runtime_multiproc: restored step "
              f"{r.global_step}, saved {step}")
        diff = [n for (n, a), b in zip(
            flatten_params({"p": t.params, "s": t.opt_state}).items(),
            flatten_params({"p": r.params, "s": r.opt_state}).values())
            if not torch.equal(a, b)]
        check(not diff, f"runtime_multiproc: restored leaves differ: "
              f"{diff[:5]}")
        row["restore_s"] = r.checkpoint_manager.last_restore["seconds"]
        close_trainer(r)
        close_trainer(t)
    finally:
        dist.destroy_process_group()
    # the CPU ranks see no card
    t0 = time.monotonic()
    rc = launch_ranks(MULTIPROC_TP, ["--fleet-worker", root, "tp_restore"],
                      root, env={"CUDA_VISIBLE_DEVICES": "",
                                 "OMP_NUM_THREADS": "4"})
    check(rc == 0, f"runtime_multiproc: the tp{MULTIPROC_TP} ranks exited "
          f"{rc}")
    got = rank_results(root)
    for rank in range(MULTIPROC_TP):
        res = got[(rank, 0)]
        bad = sorted(n for n in want[rank]
                     if want[rank][n] != res["digests"].get(n))
        check(not bad and res["step"] == step,
              f"runtime_multiproc: tp rank {rank} at step {res['step']}, "
              f"leaves unlike the card's slices: {bad[:5]}")
    check(same_files(os.path.join(root, "hf_one"),
                     os.path.join(root, "hf_tp")),
          "runtime_multiproc: the tp2 export differs from the one-card "
          "export")
    row.update(tp_ranks_s=time.monotonic() - t0,
               tp_restore_s=[got[(r, 0)]["restore_s"]
                             for r in range(MULTIPROC_TP)],
               tp_export_s=got[(0, 0)]["export_s"],
               tp_bit_for_bit=True, export_byte_equal=True)
    shutil.rmtree(root)
    row["nvidia_smi"] = card_name_and_power_limit()
    emit("runtime_multiproc", model=MODEL, **row)
    return row


# -- the four-card drills (the rank side is ``fleet_worker``) ------------------------
def fleet_cfg(ckpt: str, **kw):
    """The headline row (GC, bf16 compute, fp32 masters), synthetic
    data, a save every 2 steps."""
    return make_bench_args(MODEL, seq=TRAIN_SEQ, gc=True, extra={
        "checkpoint_dir": ckpt, "save_frequency": 2,
        "keep_n_checkpoints": 3, "total_train_steps": FLEET_STEPS,
        "log_frequency": 1, "checkpoint_retry_base_delay": 0.05,
        "distributed_launcher": "env", **kw})


def timed_steps(trainer) -> list:
    """Wrap ``trainer.step`` to record (step, start, end) wall times."""
    marks = []
    step = trainer.step

    def recorded(*a, **kw):
        t0 = time.time()
        m = step(*a, **kw)
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        marks.append((trainer.global_step, t0, time.time()))
        return m

    trainer.step = recorded
    return marks


def fleet_worker(directory: str, scenario: str) -> int:
    """One rank of a fleet drill (started by ``launch_ranks``):
    ``scenario`` and ``directory/drill.json`` say what it runs; the result
    goes to ``result_r<rank>_a<attempt>.json``."""
    from scaletorch_tpu_torch import dist as stdist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["RANK"])
    drill = {}
    if os.path.exists(os.path.join(directory, "drill.json")):
        with open(os.path.join(directory, "drill.json")) as f:
            drill = json.load(f)
    result = {"rank": rank, "attempt": stdist.restart_count(),
              "start": time.time()}
    if scenario in ("nccl_abort", "elastic"):
        if scenario == "nccl_abort":
            result.update(nccl_abort_rank(directory, rank))
            code = 0 if result["returned"] else None
        else:
            code = elastic_rank(directory, drill, result)
        write_rank_result(directory, result)
        if code != 0:
            # the group may hold a lost peer: no teardown may wait on it
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(code or 0)
        stdist.shutdown_distributed()
        return 0
    elif scenario == "tp_restore":
        result.update(tp_restore_rank(directory))
    elif scenario == "sigterm":
        result.update(sigterm_rank(directory, drill))
    elif scenario == "coordination":
        result.update(coordination_rank(drill))
    else:
        raise ValueError(f"unknown fleet scenario {scenario!r}")
    write_rank_result(directory, result)
    stdist.shutdown_distributed()
    return 0


def tp_restore_rank(root: str) -> dict:
    """A CPU rank at tp2: restore the card's checkpoint, export sharded."""
    t = Trainer(multiproc_cfg(os.path.join(root, "ckpt"), resume="must",
                              tensor_parallel_size=MULTIPROC_TP),
                device="cpu")
    out = {"step": t.global_step, "digests": trainer_digests(t),
           "restore_s": t.checkpoint_manager.last_restore["seconds"]}
    t0 = time.perf_counter()
    t.export_hf(os.path.join(root, "hf_tp"), dtype="bfloat16",
                max_shard_bytes=HF_SHARD_BYTES)
    out["export_s"] = time.perf_counter() - t0
    t.close()
    return out


def nccl_abort_rank(directory: str, rank: int) -> dict:
    """The probe: two ranks all-reduce over NCCL (timeout
    NCCL_PROBE_TIMEOUT_S; error handling that aborts the communicator
    and raises in the waiting call, ``CleanUpOnly``, with blocking
    waits); rank 1 is SIGKILLed; whether rank 0's next all-reduce raises
    within the timeout (waited for NCCL_PROBE_TIMEOUT_S + 10 s on a
    thread), and, if it does, whether rank 0 then aborts the group,
    forms a new one alone and all-reduces again. What
    ``dist.can_reform_in_process`` rests on."""
    import threading

    import torch.distributed as dist

    from scaletorch_tpu_torch import dist as stdist

    os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "2"
    os.environ["TORCH_NCCL_BLOCKING_WAIT"] = "1"
    os.environ.update(ELASTIC_NCCL_ENV)  # no debug dump, no wait for one
    stdist.init_distributed("env", timeout_s=NCCL_PROBE_TIMEOUT_S)
    dev = torch.device("cuda", rank)
    x = torch.ones(1024, device=dev)
    dist.all_reduce(x)
    torch.cuda.synchronize(dev)
    ok = float(x[0]) == 2.0
    dist.barrier()
    if rank == 1:
        os.kill(os.getpid(), signal.SIGKILL)
    time.sleep(1.0)  # rank 1 is gone before the next collective
    got = {}

    def reduce():
        try:
            dist.all_reduce(x)
            torch.cuda.synchronize(dev)
            got["returned"] = "without an error"
        except Exception as exc:  # the peer is gone: this should raise
            got["error"] = f"{type(exc).__name__}: {str(exc)[:300]}"

    t0 = time.time()
    th = threading.Thread(target=reduce, daemon=True)
    th.start()
    th.join(NCCL_PROBE_TIMEOUT_S + 10.0)
    out = {"first_all_reduce": ok, "raised": "error" in got,
           "error": got.get("error"), "returned": not th.is_alive(),
           "detect_s": time.time() - t0, "reformed_all_reduce": None,
           "torch": torch.__version__}
    if not out["raised"]:
        return out  # the caller ends the process without a teardown
    dist.distributed_c10d._abort_process_group()
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(directory, "probe_e1"),
        world_size=1, rank=0, device_id=dev,
        timeout=datetime.timedelta(seconds=NCCL_PROBE_TIMEOUT_S))
    y = torch.full((1024,), 3.0, device=dev)
    dist.all_reduce(y)
    torch.cuda.synchronize(dev)
    out["reformed_all_reduce"] = float(y[0]) == 3.0
    return out


def elastic_rank(directory: str, drill: dict, result: dict) -> int:
    """One rank of the kill or hang drill: the Trainer of the drill's
    config (elastic, dp over the fleet, NCCL), step times recorded. The
    kill drill's rank is SIGKILLed inside the backward of the step after
    ``kill_after`` (a hook on a parameter's gradient), after a timestamp
    file; the hang drill stalls its rank through the injector. Either
    fault fires in the first process of its rank only (the restarted
    fleet resumes before the fault's step)."""
    from scaletorch_tpu_torch.resilience_distributed import (
        WATCHDOG_EXIT_CODE,
        ElasticRemeshError,
    )

    try:
        t = Trainer(fleet_cfg(**drill["cfg"]))
    except ElasticRemeshError as exc:  # parked (NCCL: gives up at once)
        result.update(remesh_error=str(exc), end=time.time())
        return WATCHDOG_EXIT_CODE
    result["resumed"] = t.global_step
    marker = os.path.join(directory, "armed")
    if os.path.exists(marker):
        t.resilience.injector.host_hang_elastic = 0
    elif drill["rank"] == int(os.environ["RANK"]):
        open(marker, "w").close()
        if "kill_after" in drill:
            def kill(grad):
                if t.global_step == drill["kill_after"]:
                    with open(os.path.join(directory, "killed_at.json"),
                              "w") as f:
                        json.dump({"time": time.time(),
                                   "step": t.global_step}, f)
                    os.kill(os.getpid(), signal.SIGKILL)
                return grad

            tree_leaves(t.params)[0].register_hook(kill)
    marks = timed_steps(t)
    code = 0
    try:
        t.train()
    except ElasticRemeshError as exc:
        result["remesh_error"] = str(exc)
        code = WATCHDOG_EXIT_CODE
    result.update(step=t.global_step, view=[t.elastic.view.epoch,
                                            list(t.elastic.view.members)],
                  counters=t.elastic.counters(), timeline=t.elastic_timeline,
                  marks=marks, end=time.time())
    if code == 0:
        result["digests"] = trainer_digests(t)
        t.close()
    return code


def sigterm_rank(directory: str, drill: dict) -> dict:
    """tp2 x dp2 with a SIGTERM to rank 2 after step 3 (``resume``: off),
    or a resume at the drill's layout and one more step."""
    from scaletorch_tpu_torch.parallel.mesh import MeshManager

    t = Trainer(fleet_cfg(**drill["cfg"]))
    out = {"layout": list(t.mm.shape)}
    if drill.get("resume"):
        out["step0"] = t.global_step
        if drill.get("cut"):  # the slices the saved layout's ranks held
            out["cut_digests"] = shard_digests(t, MeshManager(
                **drill["cut"]))
        m = t.step()
        out.update(loss=float(m["loss"]), step=t.global_step)
    else:
        t.train()
        out.update(preempted=t.preempted, step=t.global_step,
                   saved=t.emergency_checkpoint_saved,
                   latest=t.checkpoint_manager.latest_step(),
                   digests=trainer_digests(t))
    t.close()
    return out


def coordination_rank(drill: dict) -> dict:
    """dp4 steps in COORD_WINDOW_STEPS-step windows, coordinated and not
    in turns (on, off, off, on, ...): each window's seconds."""
    t = Trainer(fleet_cfg(**drill["cfg"]))
    t.train(num_steps=2)  # warm-up
    windows = {"on": [], "off": []}
    order = ["on", "off", "off", "on"] * COORD_WINDOWS
    for mode in order[:2 * COORD_WINDOWS]:
        t.coordinator.enabled = mode == "on"
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        t.train(num_steps=COORD_WINDOW_STEPS)
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        windows[mode].append((time.perf_counter() - t0)
                             / COORD_WINDOW_STEPS)
    t.close()
    return {"step_s": windows}


def drill_dir(name: str, drill: dict = None) -> str:
    d = os.path.abspath(os.path.join(FLEET_DIR, name))
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    if drill is not None:
        with open(os.path.join(d, "drill.json"), "w") as f:
            json.dump(drill, f)
    return d


def fleet_nccl_abort() -> dict:
    """The probe's outcome on this torch (``nccl_abort_rank``), beside
    what ``dist.can_reform_in_process`` assumes for NCCL; the probe must
    end within its bounds either way."""
    from scaletorch_tpu_torch import dist as stdist

    d = drill_dir("nccl_abort")
    # elastic supervision: rank 1's SIGKILL must not end rank 0
    rc = launch_ranks(2, ["--fleet-worker", d, "nccl_abort"], d,
                      elastic=True, timeout=300)
    res = rank_results(d)
    check((0, 0) in res, f"nccl_abort: rank 0 wrote nothing (launch {rc})")
    r = res[(0, 0)]
    check(r["first_all_reduce"], f"nccl_abort: {r}")
    return {**{k: r[k] for k in ("raised", "returned", "error", "detect_s",
                                 "reformed_all_reduce", "torch")},
            "in_place_assumed": stdist.can_reform_in_process("nccl")}


def elastic_drill(name: str, cfg: dict, **drill):
    """Launch an elastic drill of ``cfg`` on 4 ranks (one fleet restart
    allowed); (the launch's exit code, every rank result, the launch's
    events, the kill's record or None)."""
    d = drill_dir(name)
    ckpt = os.path.join(d, "ckpt")
    with open(os.path.join(d, "drill.json"), "w") as f:
        json.dump({"cfg": dict(
            ckpt=ckpt, data_parallel_size=4, elastic=True, resume="auto",
            elastic_deadline_seconds=ELASTIC_DEADLINE_S,
            elastic_heartbeat_seconds=1.0, **cfg), "rank": 2, **drill}, f)
    rc = launch_ranks(4, ["--fleet-worker", d, "elastic"], d, elastic=True,
                      max_restarts=1,
                      membership=os.path.join(ckpt, "membership"))
    killed = None
    if os.path.exists(os.path.join(d, "killed_at.json")):
        with open(os.path.join(d, "killed_at.json")) as f:
            killed = json.load(f)
    return rc, rank_results(d, every=True), launch_events(d), killed


def fleet_finish(every: list, events: list, what: str) -> list:
    """The 4 ranks the restarted fleet ran: resumed from step 2, at
    FLEET_STEPS with equal parameters; one fleet restart."""
    fin = [r for r in every if r.get("digests")]
    check(len(fin) == 4 and sorted(r["rank"] for r in fin) == [0, 1, 2, 3]
          and all(r["step"] == FLEET_STEPS for r in fin)
          and all(r["digests"] == fin[0]["digests"] for r in fin),
          f"{what}: the finishing ranks {[(r['rank'], r['step']) for r in fin]}"
          " do not end alike at the last step")
    check(all(r["resumed"] == 2 for r in fin),
          f"{what}: the restarted fleet resumed {[r['resumed'] for r in fin]}"
          ", not step 2")
    restarts = [e for e in events if e["event"] == "fleet_restart"]
    check(len(restarts) == 1, f"{what}: {len(restarts)} fleet restarts")
    return fin


def first_exits(events: list) -> dict:
    """rank -> (exit code, time) of each rank's first process."""
    out = {}
    for e in events:
        if e["event"] == "exit" and e["rank"] not in out:
            out[e["rank"]] = (e["code"], e["time"])
    return out


def step_times(marks, lo: float, hi: float) -> list:
    return [end - start for _, start, end in marks if lo <= start < hi]


def fleet_elastic_kill() -> dict:
    """Rank 2 SIGKILLed inside the backward of step 4 (after step 3) of
    the headline row at dp4: the survivors, blocked in the step's NCCL
    gradient all-reduce, are ended by NCCL's watchdog at the groups'
    timeout (the elastic deadline) — an NCCL group is not re-formed in
    place (``dist.can_reform_in_process``) — their relaunches give up at
    once (43), and the launcher restarts the fleet, which resumes from
    step 2 and ends alike at FLEET_STEPS."""
    rc, every, events, killed = elastic_drill("elastic_kill", {},
                                              kill_after=3)
    check(rc == 0, f"elastic_kill: launch exited {rc}")
    check(killed is not None and killed["step"] == 3,
          f"elastic_kill: killed at {killed}")
    fin = fleet_finish(every, events, "elastic_kill")
    ends = first_exits(events)
    ended = {r: t - killed["time"] for r, (_, t) in ends.items() if r != 2}
    check(sorted(ended) == [0, 1, 3]
          and max(ended.values()) <= ELASTIC_DETECT_LIMIT_S,
          f"elastic_kill: the survivors ended {ended} s after the kill "
          f"(limit {ELASTIC_DETECT_LIMIT_S} s)")
    restart = next(e["time"] for e in events
                   if e["event"] == "fleet_restart")
    first = min(fin, key=lambda r: r["rank"])
    marks = first["marks"]
    return {"survivor_exit_codes": {r: ends[r][0] for r in (0, 1, 3)},
            "detection_s": sorted(ended.values()),
            "fleet_restart_s": restart - killed["time"],
            "recovery_s": min(end for _, start, end in marks
                              if start > restart) - killed["time"],
            "step_s_after_restart": step_times(marks, restart,
                                               float("inf"))}


def fleet_elastic_hang() -> dict:
    """``ft_host_hang_elastic`` on rank 2 for ELASTIC_HANG_S after step
    3: the survivors' bounded collective (the decision bus's gather, or
    NCCL's watchdog) ends their wait at the deadline and they give up
    (an NCCL group is not re-formed in place); the wedged rank, awake,
    finds its peers gone and exits 43 (``ElasticRemeshError``); the
    fleet restarts (the wedged rank with it) and finishes from step 2."""
    rc, every, events, _ = elastic_drill(
        "elastic_hang", dict(ft_host_hang_elastic=3, ft_kill_host=2,
                             ft_host_hang_seconds=ELASTIC_HANG_S))
    check(rc == 0, f"elastic_hang: launch exited {rc}")
    fleet_finish(every, events, "elastic_hang")
    ends = first_exits(events)
    w = min((r for r in every if r["rank"] == 2), key=lambda r: r["start"])
    check(ends[2][0] == 43 and w.get("remesh_error"),
          f"elastic_hang: the wedged rank exited {ends[2][0]}: "
          f"{w.get('remesh_error')}")
    # the stall starts at step 3's boundary
    hang = next(end for step, _, end in w["marks"] if step == 3)
    ended = {r: ends[r][1] - hang for r in (0, 1, 3)}
    check(max(ended.values()) <= ELASTIC_DETECT_LIMIT_S
          + 2 * ELASTIC_DEADLINE_S,
          f"elastic_hang: the survivors ended {ended} s into the stall")
    return {"survivor_exit_codes": {r: ends[r][0] for r in (0, 1, 3)},
            "survivors_end_s": ended,
            "wedged_end_s": ends[2][1] - hang,
            "wedged_counters": w["counters"]}


def fleet_sigterm() -> dict:
    """SIGTERM to rank 2 of tp2 x dp2 after step 3 (fp32, so the resumed
    step is held to TRAIN_PARITY): every rank saves the same emergency
    step and exits 0; a dp4 resume holds the saved tensors bit for bit
    and its next loss matches the tp2 x dp2 run's next loss."""
    ckpt = os.path.abspath(os.path.join(FLEET_DIR, "sigterm_ckpt"))
    shutil.rmtree(ckpt, ignore_errors=True)
    base = dict(ckpt=ckpt, dtype="float32", save_frequency=0)
    tp = dict(tensor_parallel_size=2, data_parallel_size=2)
    # 4 rows a step in both layouts: the resumed runs draw the same batch
    d = drill_dir("sigterm", {"cfg": dict(base, **tp, micro_batch_size=2,
                                          ft_sigterm_at_step=3,
                                          ft_sigterm_host=2)})
    rc = launch_ranks(4, ["--fleet-worker", d, "sigterm"], d)
    res = rank_results(d)
    check(rc == 0 and len(res) == 4, f"sigterm: launch {rc}, {sorted(res)}")
    got = [(res[(r, 0)]["preempted"], res[(r, 0)]["step"],
            res[(r, 0)]["saved"], res[(r, 0)]["latest"]) for r in range(4)]
    check(got == [(True, 3, True, 3)] * 4, f"sigterm: {got}")
    saved = [res[(r, 0)]["digests"] for r in range(4)]
    d2 = drill_dir("sigterm_straight", {"cfg": dict(base, **tp,
                                                    micro_batch_size=2,
                                                    resume="must"),
                                        "resume": True})
    check(launch_ranks(4, ["--fleet-worker", d2, "sigterm"], d2) == 0,
          "sigterm: the tp2 x dp2 resume failed")
    straight = rank_results(d2)
    d3 = drill_dir("sigterm_dp4", {"cfg": dict(base, data_parallel_size=4,
                                               resume="must"),
                                   "resume": True,
                                   "cut": {"tp": 2, "dp": 2}})
    check(launch_ranks(4, ["--fleet-worker", d3, "sigterm"], d3) == 0,
          "sigterm: the dp4 resume failed")
    dp4 = rank_results(d3)
    for r in range(4):
        cut = dp4[(r, 0)]["cut_digests"]
        check(dp4[(r, 0)]["step0"] == 3 and cut == saved,
              f"sigterm: dp4 rank {r} does not hold the saved tensors")
    loss_tp = straight[(0, 0)]["loss"]
    losses = [dp4[(r, 0)]["loss"] for r in range(4)]
    check(len(set(losses)) == 1, f"sigterm: dp4 losses differ {losses}")
    check(abs(losses[0] - loss_tp) <= TRAIN_PARITY["loss_abs"],
          f"sigterm: dp4 step-4 loss {losses[0]} vs tp2 x dp2 {loss_tp}")
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"step4_loss_dp4": losses[0], "step4_loss_tp2_dp2": loss_tp,
            "abs_diff": abs(losses[0] - loss_tp)}


def fleet_coordination() -> dict:
    d = drill_dir("coordination", {"cfg": dict(
        ckpt=None, data_parallel_size=4, save_frequency=0)})
    check(launch_ranks(4, ["--fleet-worker", d, "coordination"], d) == 0,
          "coordination_cost: launch failed")
    w = rank_results(d)[(0, 0)]["step_s"]
    on, off = statistics.median(w["on"]), statistics.median(w["off"])
    return {"step_s_on": w["on"], "step_s_off": w["off"],
            "median_on": on, "median_off": off,
            "change": on / off - 1.0,
            "separated": min(w["on"]) > max(w["off"])
            or max(w["on"]) < min(w["off"])}


FLEET_DRILLS = {"nccl_abort": fleet_nccl_abort,
                "elastic_kill": fleet_elastic_kill,
                "elastic_hang": fleet_elastic_hang,
                "sigterm_one_rank": fleet_sigterm,
                "coordination_cost": fleet_coordination}


def phase_runtime_fleet(drills=tuple(FLEET_DRILLS)) -> dict:
    """The four-card drills of the multi-process runtime, each under
    ``scaletorch_tpu_torch.launch`` (one process a card)."""
    world = torch.cuda.device_count()
    check(world >= 4, f"runtime_fleet: needs 4 cards, found {world}")
    out = {}
    for name in drills:
        t0 = time.monotonic()
        out[name] = FLEET_DRILLS[name]()
        out[name]["seconds"] = time.monotonic() - t0
        emit(f"runtime_fleet_{name}", **out[name])
    out["nvidia_smi"] = card_name_and_power_limit()
    emit("runtime_fleet", nvidia_smi=out["nvidia_smi"],
         drills=list(drills))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        seconds[name] = time.monotonic() - t0
        return out

    info = timed("device", phase_device)
    timed("build", phase_build)
    kernel = timed("kernel_paged_decode", phase_kernel)
    flash = timed("kernel_flash", phase_kernel_flash)
    timed("kernel_ring_blocks", phase_kernel_ring_blocks)
    timed("analysis", phase_analysis)
    model32 = timed("decode_parity", phase_decode_parity)
    launches = timed("serve", phase_serve, model32)
    timed("profile", phase_profile, model32)
    timed("decode_graph", phase_decode_graph, model32)
    timed("runtime_serve", phase_runtime_serve, model32)
    timed("gateway", phase_gateway, model32)
    timed("gateway_fleet", phase_gateway_fleet, model32)
    timed("disagg_serve", phase_disagg_serve, model32)
    del model32
    torch.cuda.empty_cache()
    timed("geometry_serve", phase_geometry_serve)
    torch.cuda.empty_cache()
    timed("train_parity", phase_train_parity)
    torch.cuda.empty_cache()
    trainer, train_launches, train_tok_s = timed("train", phase_train)
    timed("train_profile", phase_train_profile, trainer)
    del trainer
    torch.cuda.empty_cache()
    timed("data_train", phase_data_train, train_tok_s)
    torch.cuda.empty_cache()
    timed("hf_roundtrip", phase_hf_roundtrip)
    torch.cuda.empty_cache()
    timed("train_table", phase_train_table)
    timed("remat_parity", phase_remat_parity)
    torch.cuda.empty_cache()
    timed("runtime_preempt", phase_runtime_preempt)
    timed("runtime_rollback", phase_runtime_rollback)
    timed("runtime_telemetry", phase_runtime_telemetry)
    timed("runtime_watchdog", phase_runtime_watchdog)
    torch.cuda.empty_cache()
    gmlp = timed("kernel_grouped_mlp", phase_kernel_grouped_mlp)
    torch.cuda.empty_cache()
    timed("kernel_ep_blocks", phase_kernel_ep_blocks)
    torch.cuda.empty_cache()
    timed("moe_decode_parity", phase_moe_decode_parity)
    torch.cuda.empty_cache()
    timed("moe_serve", phase_moe_serve)
    torch.cuda.empty_cache()
    timed("moe_train_parity", phase_moe_train_parity)
    torch.cuda.empty_cache()
    moe_trainer, moe_launches = timed("moe_train", phase_moe_train)
    timed("moe_train_profile", phase_train_profile, moe_trainer,
          "moe_train_profile")
    del moe_trainer
    gc.collect()
    torch.cuda.empty_cache()
    timed("moe_train_save_attn", phase_moe_train_save_attn)
    gc.collect()
    torch.cuda.empty_cache()
    gpt = timed("gpt_moe_serve", phase_gpt_moe_serve)
    torch.cuda.empty_cache()
    timed("model_zoo", phase_model_zoo)
    timed("mingpt_train", phase_mingpt_train)
    timed("mnist_train", phase_mnist_train)
    gc.collect()
    torch.cuda.empty_cache()
    timed("resnet_train", phase_resnet_train)
    gc.collect()
    torch.cuda.empty_cache()
    timed("examples", phase_examples)
    gc.collect()
    torch.cuda.empty_cache()
    timed("runtime_multiproc", phase_runtime_multiproc)
    gc.collect()
    torch.cuda.empty_cache()
    timed("parallel", phase_parallel)
    emit("timing", seconds=seconds, total_s=sum(seconds.values()))
    emit("kernels", kernels=[
        {"id": kid, "function": fn, "at": at,
         "status": "ported" if kid in PORTED else "not_ported"}
        for kid, fn, at in TPU_KERNELS])
    at = {kid: where for kid, _, where in TPU_KERNELS}
    bf16 = kernel["bfloat16"]
    flash16 = flash["bfloat16"]
    flash_err = {"K1": flash16["out_max_abs"], "K2": flash16["dq_max_abs"],
                 "K3": max(flash16["dk_max_abs"], flash16["dv_max_abs"])}
    rows = []
    for kid in ("K1", "K2", "K3"):
        t = flash16["kernels"][kid]
        rows.append({
            **PORTED[kid], "replaces": at[kid],
            "launches": train_launches.get(PORTED[kid]["name"], 0),
            "max_abs_err": flash_err[kid], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    rows.append({
        **PORTED["K4"], "replaces": at["K4"],
        "launches": launches + gpt["kernel_launches"],
        "launches_by_path": {"serve": launches,
                             "gpt_moe_serve": gpt["kernel_launches"]},
        "max_abs_err": bf16["max_abs_err"],
        "ms": bf16["kernel_ms"],
        "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"],
        "bound_by": bf16["bound_by"],
        "library_ms": bf16["library_ms"],
    })
    # K5-K7 and the grads pass at the train shape in bf16 (K6 and K7 each
    # alone), launches from the moe_train window
    train16 = gmlp[("train", "bfloat16")]
    gmlp_err = {"K5": train16["out_max_abs"], "K6": train16["dx_max_abs"],
                "K7": max(train16[f"{n}_max_abs"]
                          for n in ("dwg", "dwu", "dwd"))}
    gmlp_err["grads"] = max(train16[f"{n}_max_abs"] for n in ("s", "dg", "du"))
    for kid, entry in (("K5", {**PORTED["K5"], "replaces": at["K5"]}),
                       ("grads", GRADS_PASS),
                       ("K6", {**PORTED["K6"], "replaces": at["K6"]}),
                       ("K7", {**PORTED["K7"], "replaces": at["K7"]})):
        t = train16["kernels"][kid]
        rows.append({
            **entry, "launches": moe_launches.get(entry["name"], 0),
            "max_abs_err": gmlp_err[kid], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:  # a rank of phase_parallel
        sys.exit(parallel_worker(sys.argv[2], sys.argv[3].split(",")))
    if sys.argv[1:2] == ["--fleet-worker"]:  # a rank of a fleet drill
        sys.exit(fleet_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
