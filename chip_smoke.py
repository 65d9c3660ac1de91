"""Drive paddle_tpu_torch's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Needs a CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and the repo
checkout around this file; it builds the CUDA kernels itself. Each phase
prints one JSON line; any failure raises and the exit code is non-zero.

1. build     — nvcc builds every kernel of paddle_tpu_torch/csrc for sm_90a
               (one nvcc per source, in parallel); the card's name and
               power limit from nvidia-smi; ptxas's register and spill
               lines per source; the number of HGMMA (wgmma) instructions
               in the SASS (cuobjdump -sass) of the two flash libraries,
               the conv and the int8 GEMM, which must not be 0: they run
               on the tensor cores; and the int8 GEMM's I2F instructions,
               which must be 0 (it converts its weight by byte permutes).
2. kernels   — each kernel against its plain PyTorch version on the card at
               the serving path's shapes: max abs/rel error, kernel ms
               (CUDA events over back-to-back calls), plain ms, the
               one-call PyTorch yardstick where there is one
               (library_ms), and the least time the card could take
               (bound_ms, from bytes at 3.35 TB/s and flops at 67
               TFLOP/s for fp32 inputs, 989 TFLOP/s, the dense bf16
               tensor-core peak, for bf16 inputs and for the int8 GEMM's
               2MKN, and 165 TFLOP/s for the fp32 flash kernels, which
               run in split TF32: three products at the 495 TFLOP/s
               dense TF32 rate for each fp32 one; their CUDA-core bound
               beside it as bound_ms_cuda_cores). Every timed row also
               gets device_ms (and library_device_ms): the same calls
               captured in a CUDA graph and replayed, the device alone
               (the SDPA backward from torch.profiler: it does not
               capture). The layer-norm rows give both times twice. The
               int8 GEMM at M = 8, 64, 512 and 2048 (decode and the
               prefill buckets) and its three weight shapes, each row
               with the instance its M picks (prefill, M > 16; decode,
               M <= 16), and beside its bound the design's floor at three
               bf16 products a fp32 one (bound_ms_three_pieces) and the
               CUDA-core bound.
               The training kernels at ERNIE-large's shapes: flash forward
               with dropout and flash backward (their keep masks read back
               bit for bit in bf16 and fp32), compared and timed at the
               step's own B = 40, S = 512 and compared at S = 128 and 200;
               AdamW; each in bf16 and fp32. A bf16 kernel is held against
               the plain version run in fp32 on the same values and rounded
               to bf16; beside it, how many elements of the plain version
               run on the bf16 values (rounding p and ds where the
               reference does) fall outside that tolerance.
3. serve_fp32, serve_int8 — the decoder LM at the README's full width
               (vocab 32000, d_model 1024, 12 layers, 16 heads, d_inner
               4096, max_seq_len 2048), random weights from seed 0, through
               DecodeEngine, whose warm-up runs each (phase, bucket)
               program once and captures it as a CUDA graph that every
               later run replays: 9 concurrent requests, prompts of 5..1500
               tokens (both prefill lengths regimes), 32 new tokens, greedy
               plus one sampled at temperature 0.8. Continuous batching
               must equal one-at-a-time decode bit for bit, and every
               kernel of the phase must have launched. The launch counts
               are set to 0 just before the concurrent requests go in and
               read as soon as the last of them is answered, before the
               one-at-a-time rerun. Every int8 launch is counted by
               instance (serve_int8: the 8-token bucket and the decode
               steps on decode, the other prefills on prefill).
4. cpu_parity — one request at full width, prefill + 8 steps, on the card
               and on the CPU (plain versions): logits within rtol = atol
               = 1e-4 (12 layers of fp32 summed in different orders) and
               the same 5 top ids, in order, at every step. cpu_parity_int8
               does the same with int8 weights: the int8 GEMM's prefill
               instance (M = 128) and decode instance (M = 1) against the
               CPU's fp32 matmul, 72 and 576 launches.
5. train_parity — ERNIE at full width (hidden 1024, 16 heads, FFN 4096,
               vocab 18000, seq 512), batch 2, the same steps on the card
               and on the CPU from one scope_from_numpy state and on one
               batch: the same dropout masks bit for bit and the losses
               within rtol = atol = 1e-4 for fp32 at 2 layers (3 steps) and
               at 4 layers (2 steps: its CPU leg is the slowest of the
               script; 24 layers, then 12, then 6, before later phases
               needed the time), within 1e-2 for bf16 at 2 layers
               (2 steps; 6, then 3, before). Every flash launch of the fp32 legs runs the
               split-TF32 instance, of the bf16 leg the bf16 one.
6. train_ernie — ERNIE-large as the reference's benchmark trains it (24
               layers, bf16 params, packed flash attention with probs
               dropout 0.1, hidden dropout 0.1, 80 masked predictions, NSP,
               AdamW lr 1e-4 / decay 0.01) through build_pretraining_program
               and Executor: startup on the card, one warm-up step, 8 timed
               steps op by op and 8 compiled on one synthetic batch (batch
               40, or the largest of 32, 24, 16, 8 that fits), each mode's
               leg from the warm-up's state. In each leg finite losses,
               the last below the leg's first two (without a learning-rate
               warm-up AdamW's first steps overshoot at this depth: the
               deep train_parity leg shows the same rise on the CPU);
               the flash and AdamW kernels found by name in its traced
               step as often as its launch counters say; exactly
               24 flash forward, 24 flash backward and 398 AdamW launches
               a step in either mode, every flash launch on the bf16
               tensor-core instance; no NaN in any parameter. Its ms/step
               and tokens/s are smoke figures of one synthetic batch.
               Then layer_norm_variance_cost: 12 more steps alternating
               the layer_norm lowering as it is and without its Variance
               op (Variance recovered from rstd), the step ms of each.
The long-context and [B,H,S,D] slice adds, in the order they run:
   kernels  — check_flash_long: both flash kernels at the long step's
               shapes (packed, bias, dropout 0.1): bf16 B=4 S=2048 and B=2
               S=4096, fp32 B=4 S=2048, compared and timed. check_flash_bnsd:
               both in the [B,H,S,D] layout at the six bnsd TPU kernels'
               shapes (B=40 at S=512, 256, 128; Sq=512 Sk=256; causal; B=4
               S=2048; fp32), compared, the first four timed, and bit for
               bit equal to the packed layout on the same values.
7. train_parity_long — train_parity at seq 2048, batch 1, 1 layer (2
               before to_static_bert_base came), fp32, 2 steps (position
               table widened to the sequence).
8. bnsd_ops  — a program with a 4-D layers.flash_attention ([40,16,512,64]
               bf16 q/k/v parameters, [B,1,1,S] key bias, dropout 0.1),
               append_backward, 3 Executor.run steps: one bnsd flash forward
               and one bnsd backward launch a step, both on the bf16
               tensor-core instance, finite gradients.
9. train_long_s2048, train_long_s4096 — train_ernie at the long-context
               benchmark rows (tools/bench_models.py bench_long_context):
               max_position_embeddings = seq, s2048 batch 4 with 307 masked
               predictions and s4096 batch 2 with 614, 1 warm-up + 5 timed
               steps in each mode; in each leg finite losses, the last
               below the leg's first, 24 / 24 / 398 launches a step.
The compiled-step slice (every Executor.run defaults to use_compiled:
the first run of a key op by op, the second captures a CUDA graph, later
runs replay it) adds, in the order they run:
   kernels  — the dropout masks read back with the seed as an int and as
               a device int64 (the kernels read it through a pointer);
               check_flash_bert_base: both flash kernels at BERT-base's
               s128 shape (B=384 S=128, 12 heads of 64, bf16, bias,
               dropout), compared and timed beside SDPA.
   compiled_parity — ERNIE-large at full width, 4 layers, s512 b40, bf16,
               4 steps op by op twice and compiled once from one state:
               masks bit for bit and fresh each step; losses and every
               state tensor bit for bit in all three runs (the embedding
               gradients sum in a fixed order; any tensor that differs is
               printed with the ops that read it); launches a step equal.
   train_ernie, train_long_s2048, train_long_s4096, train_resnet50 and the
               two rows below print both modes (profile_train.timed_modes,
               each leg from one state and step counter): step ms p50 on
               the host clock, one traced step's device busy ms and idle
               share, peak memory allocated (compiled: from the capture
               on) and memory reserved; the launches a step of both modes
               are gated, and so is each leg's own falling loss and its
               traced step's flash and AdamW kernels, counted by name,
               against its counters (a replay's counts are its capture's);
               at s512 the compiled peak stays within 1.10 of the
               op-by-op one.
   train_bert_base — BERT-base as bench_bert_base trains it (12 layers,
               hidden 768, s128, b384, 20 predictions, bf16, flash,
               dropout 0.1, AdamW): 12 / 12 flash launches a step on the
               bf16 packed instance, one AdamW launch an adamw op, a
               falling loss; card against CPU at 2 layers, batch 2: masks
               bit for bit, losses within 1e-2.
   train_lenet — LeNet as bench_mnist builds it (b512, Adam at lr 1e-3):
               a falling loss, no hand-written kernel; card against CPU at
               batch 16, fp32: losses within 1e-4.
The fleet slice adds, right after train_ernie:
   train_ernie_fleet — ERNIE-large at full width (12 layers since
               to_static_bert_base came, 24 before; fp32
               parameters, flash attention) built with
               build_pretraining_program(with_optimizer=False) and trained
               through fleet.distributed_optimizer: LambOptimizer (lr
               1e-3, lamb_weight_decay 0.01, ClipGradByGlobalNorm(1.0)),
               strategy.amp (the bf16 rewrite, dynamic loss scaling from
               32768), strategy.recompute (one checkpoint per encoder
               layer: 12 block_call segments) and strategy.lamb; b40 (or
               the first of 32, 24, 16 that fits), one warm-up step, 4
               timed steps a mode. Gates: 24 flash forward launches a step
               (each segment's forward and its recompute) and 12 backward
               (through FlashAttentionFunction), all bf16_wgmma, no AdamW,
               one lamb op a parameter; each leg's loss falling, every parameter
               finite; FlashAttentionFunction's dq, dk, dv at the step's
               shapes bit for bit a direct backward call; the program
               without recompute one step from the same state (at b40, or
               the largest batch it fits, its out-of-memory errors
               printed): its peak memory higher, gradients within 1e-3 of
               each tensor's largest magnitude and parameters within 1e-5;
               a loss-scaling overflow in a compiled step (the 12-layer
               program at 2 of the batch's rows, the scale set to inf for
               two steps, then 32768): (scale, good, bad) after every
               step bit for bit the CPU's run of the 2-layer program on
               the same rows; layer 0's attention keep mask read back from
               the kernel for the forward's seed and the recompute's, op
               by op and in the compiled step (one seed-table slot): equal
               to each other and to the plain mask.
The ResNet-50 slice adds, in the order they run:
   kernels  — check_layer_norm: the layer_norm kernel at ERNIE-large's LN
               rows [20480, 1024] bf16 and fp32 and the decoder LM's [1500,
               1024] fp32, timed with F.layer_norm as the library.
               check_conv: the conv_bn_relu kernel at the conv tool's shape
               (N=256, 14x14, 256 -> 256, NHWC bf16).
10. exp_conv — paddle_tpu_torch/tools/exp_conv.py: the conv kernel, the
               cuDNN route and the plain version, timed (the kernel and
               cuDNN also on the device alone).
11. fused_ln_ops — a program with fused_layer_norm at [40, 512, 1024] bf16,
               append_backward, 3 steps: two layer_norm launches a step
               (the op and its grad op's recomputed forward); Y and the
               gradients equal those of the same program with layer_norm.
12. resnet_parity — a tiny ResNet-50 (one bottleneck a stage, 32x32, 10
               classes), batch 4, 3 Momentum steps, card against CPU from
               one state: losses within 1e-4 (fp32) and 1e-2 (bf16 AMP);
               parameters and running statistics after each step, the
               card starting it from the CPU's state, within the same
               times max(1, the tensor's largest magnitude).
13. train_resnet50 — ResNet-50 as tools/bench_models.py bench_resnet50
               trains it (224x224, batch 256, bf16 AMP, Momentum lr 0.1,
               fuse_bn_act_pass), not cut: 1 warm-up + 5 timed steps a
               mode on one synthetic batch; in each leg finite losses, the
               last below the leg's first; 616 ops of 17 types. No hand-written kernel runs
               on this path (its convs are cuDNN's, as the reference's are
               XLA's): its launch counts are all 0.
14. check_conv_real_layer — the conv kernel on the input, filter and
               folded BN running statistics of res4b_c2 from that step,
               against the port's conv2d -> batch_norm(is_test) -> relu;
               the kernel's and cuDNN's device-only times at that layer.
The Transformer-big slice adds, in the order they run:
   kernels  — check_flash_transformer_big: both flash kernels at
               Transformer-big's attention shape (B=48 S=256, 16 heads of
               64, bf16, dropout 0.1) in the decoder's causal form with
               no bias and the cross-attention form (q distinct from k and
               v) under the source key bias ((mask - 1) * 1e9, 128 to 256
               live keys a row), compared, their keep masks read back bit
               for bit where a key is seen, timed beside SDPA.
15. train_transformer_big — Transformer-big as bench_transformer_big
               trains it (WMT14 En-De, d_model 1024, 16 heads, d_inner
               4096, 6+6 layers, vocab 32000 shared, label smoothing 0.1,
               dropout 0.1, b48 s256, bf16 AMP, Adam under noam decay)
               with noam's warm-up at 200 steps (WMT_WARMUP says why):
               startup, one warm-up step, 5 timed steps a mode; in each
               leg a falling loss; 18 flash forward and 18 backward
               launches a step (6 encoder with the key bias, 6 decoder
               causal, 6 cross with the key bias) on the bf16 packed
               instance, no AdamW launch; one compiled step built; the
               fetched rate equal to the noam formula at every run, after
               every replay. Then compiled_parity at 2+2 layers (b48, 3
               steps) and card against CPU at 2+2 layers, batch 2, 4
               steps: masks bit for bit, losses within 1e-2, equal rates.
The prefix-sharing and HTTP slices add, right after serve_int8:
   serve_prefix_fp32, serve_prefix_int8 — one 1024-token system prompt,
               nine suffixes, the prefix cache (serve_prefix says what
               they hold).
   serve_http_fp32, serve_http_int8 — the model written once as a
               servable dir (save_decoder_lm, under build/torch_serving/,
               removed at the end) and served by serve_decode over HTTP:
               the serve phases' requests at once, ids bit for bit the
               in-process ones, the health states, /metrics, a 429, the
               request wall over HTTP beside the engine's times
               (serve_http).
   serve_cluster_decode2, serve_cluster_tiers — ClusterControllers of
               replica processes on the card: prefix affinity, dedup, a
               SIGKILLed replica's session resumed bit for bit and the
               slot respawned; a prefill tier feeding a decode tier
               through the router; a dead prefill URL's fallbacks
               (serve_cluster). Their launch counts are the replicas'
               /v1/stats counters read just before and just after the
               traffic.
The micro-batching inference slice adds:
   kernels  — check_flash_bert_infer: the flash forward as the inference
               path runs it (BERT-base's bnsd heads, 12 of 64, S = 128,
               fp32 split TF32, a ragged key bias, no dropout) at B = 8
               and 32, against its plain version, timed beside SDPA.
   then, right after the serve_cluster phases, BERT-base
               (bert.bert_base(): vocab 30522, hidden 768, 12 layers, 12
               heads of 64, FFN 3072, fp32) built by the port's startup
               program on the card from seeds 0 and 1 and saved twice
               with io.save_inference_model, pruned to its NSP logits at
               s128 (under build/torch_serving/, removed at the end):
   infer_bert_base — create_predictor (the seven passes: one bnsd
               flash_attention a layer; every bucket one CUDA graph) under
               a ServingEngine (max_batch_size 32, buckets 1..32, all
               warmed at start()), 64 requests of 1-4 rows (real lengths
               16-128 tokens) from 16 threads through LocalClient: each
               response bit for bit the predictor's run of its rows padded
               to a bucket and within 1e-5 of its unbatched run with the
               same argmax (_served_check says why not bit for bit that
               run); a CPU predictor within 1e-4 on 8 of them; 12 flash
               forward launches a batch, bnsd, fp32, and nothing else; a
               traced bucket-32 batch; the predictor's ms a bucket; where
               the fc GEMM's bits change with M.
   infer_http_bert_base — serve(dir) and the same 64 requests POSTed at
               once to /v1/infer: the same gates, and against
               infer_bert_base's logits within 1e-5 and the same ids.
   infer_cluster_swap — a models root behind two replica processes and
               the router; model-000002 published under closed-loop
               traffic and rolled one replica at a time: no request
               fails, every answer is its version's predictor output,
               both replicas end on version 2.
The sixteenth slice (queue C's C12-C13 and the rest of A6) adds:
   queue_c_card — right after cpu_parity_int8: the cast of a float to
               every integer type and take_along_axis with negative and
               out-of-range indices, each on the card bit for bit its CPU
               result (queue_c_card).
   flash_general_bias — the flash op's reference_general route (a
               [B,H,Sq,Sk] or [B,1,Sq,Sk] bias: plain attention, no
               kernel) at BERT-base's shape, fp32 and bf16, forward and
               grad op against the CPU, the keep mask bit for bit, no
               launch and one route count a call; a key bias on the same
               op launches the kernel.
   run_steps_ernie — right after train_ernie_fleet: Executor.run_steps
               over 4 stacked batches of ERNIE-large s512 b40 (12 of its
               24 layers, RUN_STEPS_LAYERS) equals 4 run() calls bit for
               bit from one state, with 4 times a step's flash and AdamW
               launches; both ms a step printed.
   train_word2vec_sparse — right after train_lenet: word2vec at its
               published widths, 100 000 words, b1024, through SGD,
               Momentum and lazy Adam on SelectedRows gradients
               (train_word2vec_sparse says what each leg holds).
   train_transformer_big_unfused — right after train_transformer_big: the
               same row with use_flash_attention=False (no flash launch),
               its compiled parity, card against CPU in fp32 and the
               unfused program against the fused one at dropout 0.
   dropout_2p32 — last: one dropout op over a bf16 [65536, 65536] tensor
               takes the threefry branch; its kept share, and 2^20
               positions against the CPU's bits.
The seventeenth slice (the observability plane) adds:
   observe_serve_int8 — right after serve_cluster_tiers: one replica
               process of the decoder LM in weight-only int8 with
               --telemetry-log, every root span sampled and the SLO
               watchdog armed with a decode.queue_depth rule; the serve
               phases' requests over HTTP, then its run log after SIGTERM
               (observe_serve_int8 says what it holds).
   observe_train_ernie — right after run_steps_ernie: ERNIE-large s512
               b40 (12 of its 24 layers, OBSERVE_LAYERS) compiled with
               the run-log sink off and on (cost capture
               full, every span, a goodput window), the capture's flops
               against a fresh meta count, the report tools over the log,
               an OOM, and device_profile's attribution against the launch
               counters (observe_train_ernie says what each gate holds).
The eighteenth slice (the math and tensor op glue, the RNN, sequence
and beam-search ops, the recurrent book models and VGG16) adds, last:
   ops_glue_card — every op type the slice registers, each case of
               paddle_tpu_torch/tools/glue_cases.py (the reference sweep's
               shapes and ranges, NaN, +-0, +-inf, integer division by
               zero, out-of-range and negative indices, ties) run through
               the port on the card and on the CPU: integer and bool
               outputs bit for bit, floats within glue_cases.CARD_TOL
               of their family, the worst error of each family printed; randint in
               range on the card.
   linalg_extra_card — right after ops_glue_card: the linalg_ops and
               extra_ops slice's programs (tools/linalg_extra_cases.py)
               at the widths of the port's models, each op by op and as
               one compiled step, bit for bit, captured with no
               uncaptured run (but inverse): BERT-base's masked-LM loss by logsumexp + nll_loss
               over [8192, 30522] logits and its gradient against
               softmax_with_cross_entropy's (1e-5); cos_sim of two
               [4096, 256] towers and auc streamed over 16 batches, the
               stat vars the CPU's bit for bit, the AUC within 1e-6 of
               the CPU's and of metric.Auc; scatter_nd of 8192 ids with
               repeats and out-of-range ones into ERNIE-large's [18000,
               1024] embedding, equal over three runs and within fp32
               rounding of a float64 sum, and shard_index for 4 shards;
               kthvalue, median and mode over [8192, 768] activations with
               ties against the CPU; cholesky of [256, 64, 64] with one
               member not positive definite (NaN fill on the device);
               inverse of the same, whose step runs uncaptured (inv_ex
               cannot be captured), counted. No port kernel on this path.
   train_seq2seq — seq2seq at Seq2SeqConfig's width (vocabularies 10000,
               embed 256, hidden 512, fp32, Adam lr 1e-3), batch 64,
               lengths 32, from synthetic_translation_batch seed 0:
               timed_modes op by op and compiled over 20 timed steps on
               one batch (step ms p50, peak GB, a falling loss in each
               leg); card against CPU at batch 4, 3 steps from one state,
               losses within 1e-4.
   decode_seq2seq — 64 rows decoded from train_seq2seq's trained state,
               greedy and beam (K = 4, max_len 32): ms a decode and rows/s;
               beam at K = 1 without length penalty equal to greedy bit for
               bit; card against CPU on 8 rows: equal ids, or the first
               step where the choices part at a CPU margin within 1e-4.
   train_sentiment — both nets at build_sentiment_program's widths, batch
               128: timed_modes (5 timed steps, one batch), and card
               against CPU over 5 steps, each from the CPU's state before
               it, losses within 1e-5; the CPU's loss falls.
   train_vgg16 — build_vgg_program's 10 classes and 3x32x32 at batch 128
               and the reference test's lr 3e-4 (at build_vgg_program's 0.01
               random images drive the loss up, on the CPU as well):
               timed_modes (12 timed steps, one batch), finite losses, the
               mean of a leg's last three below that of its first three;
               card against CPU at batch 4, 2 steps each from the CPU's
               state, within 1e-4.
The CRF, fused-RNN and control-flow slice adds, after them (no kernel
               of the port runs on these paths; ops_glue_card above also
               holds the CRF, fused-RNN and tensor-array cases):
   train_srl — label_semantic_roles at the book's widths (words 44068 x
               32, predicates 3162 x 32, marks 2 x 5, fc and two LSTMs of
               512, 59 tags, linear_chain_crf), b64 sentences of 8-64
               tokens, Adam lr 1e-3 (the book test's 0.01 makes the loss
               jump at the second step on the CPU too): timed_modes (3
               timed steps), the loss falling in each leg; card against
               CPU at batch 4 over 3 steps, each from the CPU's state,
               within 1e-5.
   decode_srl — crf_decoding of 64 sentences with the trained
               transition through the forward-only program, compiled:
               ms and rows/s; the paths equal the CPU's wherever a row's
               Viterbi margin exceeds 1e-5, the smallest margins printed.
   train_srl_gradient_merge — the same model through fleet's gradient
               merge (k_steps 4, avg) on the 4 micro-batches of 16 of a
               b64 batch, compiled: the step runs uncaptured (design (b):
               conditional_block reads its predicate on the host), counted
               and named; the three non-firing steps leave every
               parameter and moment bit for bit; after the fourth the
               parameters are within 1e-5 of one Adam step on the whole
               batch (elements whose whole-batch gradient is below 1e-6,
               where Adam's step amplifies the sums' rounding, within lr,
               printed).
   control_flow_card — the DynamicRNN tanh cell at b128, 64 steps,
               hidden 64: op by op and compiled from one state bit for
               bit, the compiled step captured into a CUDA graph (step ms
               of each); cond with a gradient, a dynamic and a bounded
               while_loop, static_loop, IfElse and the rank-table layers,
               card against CPU.
   dygraph_bert_base — the imperative mode's main path: the 2.0 nn
               network of tools/dygraph_bert.py at BERT-base's widths
               (12 post-LN encoder layers of 768, 12 heads, ffn 3072,
               dropout 0.1; 30522 words, 512 positions; a 2-class head)
               trained eagerly at s128 b64 through hapi.Model.fit (AdamW
               1e-4 under LinearWarmup over 100 steps, Accuracy; the
               key-padding mask an additive [B,1,1,128] bias), then
               evaluate and predict on 64 rows; then, counted apart as
               the path dygraph_bert_base_amp, 4 more steps under
               amp.auto_cast: step ms, one traced step's busy ms and idle
               share, peak GB, the sink's hapi.step_ms, and every timed
               step's launches (12 bnsd flash forward, 12 bnsd backward
               under autograd, one AdamW a parameter tensor: 196), each
               path's totals; each leg's loss falls (the fit of the one
               batch it repeats).
   to_static_bert_base — the same network's forward under @to_static
               (one run_program op: a forward and a backward CUDA graph
               replayed), from the weights dygraph_bert_base left, on its
               batch: 2 untimed steps (trace, then warm-up and capture)
               and 10 timed ones (step ms, one traced step's busy ms and
               idle share, peak GB, 12 / 12 / 196 launches of the bnsd
               flash forward, backward and AdamW every timed step, no
               uncaptured run, the loss falls); the replay against the
               block run op by op on the card (logits and gradients bit
               for bit); 3 AdamW steps eager against @to_static at
               dropout 0 (losses within 1e-6, parameters within 2e-5);
               under auto_cast a fresh trace records bf16 matmuls and its
               replays return the fp32 program's logits bit for bit, as
               the reference's replay runs no cast. The kernels line has
               both flash kernels at this path's shape (B=64, 12 heads of
               64, S=128, fp32, key bias, no dropout) against their plain
               versions and SDPA (check_flash_to_static).
   dygraph_parity — the eager MultiHeadAttention at the main path's
               shape (b64, 12 heads of 64, S=128, fp32, key-padding bias)
               on the card and the CPU: output and input and parameter
               gradients within 2e-5 of the tensor's scale, one bnsd
               forward and one bnsd backward launch (not counted in the
               path). Then the same network at 2 layers, b4: 3 eager AdamW
               steps on the card and the CPU (losses and parameters
               within 1e-4, dropout masks bit for bit), eager against
               static on the card (the Layers built under program_guard,
               dropout 0; within 1e-5), save_dygraph on the card and
               load_dygraph on the CPU bit for bit.
   fit_vision_zoo — mobilenet_v2() on FakeData 3x224x224 through
               Model.fit at b64 (5 steps, Momentum under
               CosineAnnealingDecay) and evaluate, resnet50() through
               Model.predict on 64 rows: step ms, peak GB, no port kernel.
Every phase line ends with at_s, the seconds since the script started.
Then one line with every ported kernel: ``launches_by_path`` gives each
phase's own count (set to 0 just before the phase, read just after),
``launches_by_layout`` and ``launches_by_dtype`` the flash kernels'
split by layout and by dtype instance, ``launches_by_instance`` the int8
GEMM's by instance in each serving phase, and
``launches`` is serve_int8's for the serving kernels, train_ernie's
for the training kernels, fused_ln_ops's for layer_norm and exp_conv's
for conv_bn_relu; ``variants`` are the flash kernels' and the int8
GEMM's other timed
shapes. Then the card's name and power limit, and last
{"ok": true, "device": {...}}.

TF32 is switched off for matmuls and cuDNN convs: the fp32 projections
stay torch.matmul in full fp32, as the JAX package left them to XLA.
"""

from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, CUDA cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, dense tensor cores
# fp32 work in split TF32: three TF32 products for each fp32 one, at the
# 495 TFLOP/s dense TF32 rate (H100 SXM data sheet)
TF32X3_FLOPS_PER_S = 495e12 / 3

FULL = dict(vocab_size=32000, d_model=1024, n_head=16, n_layers=12,
            d_inner=4096, max_seq_len=2048)
REPLACES = {
    "flash_attention_fwd": "paddle_tpu/ops/pallas/flash_attention.py:948 "
                           "(_packed_fwd_kernel) + :311 (_fwd_kernel) + :377 "
                           "(_fused_fwd_kernel) + :822 (_fused_fwd_kernel_g)",
    "paged_attention": "paddle_tpu/ops/pallas/paged_attention.py:74",
    "int8_gemm": "paddle_tpu/ops/pallas/int8_gemm.py:82",
    "flash_attention_bwd": "paddle_tpu/ops/pallas/flash_attention.py:984 "
                           "(_packed_bwd_kernel) + :748 (_fused_bwd_kernel) "
                           "+ :860 (_fused_bwd_kernel_g) + :634 (_dkv_kernel) "
                           "+ :701 (_dq_kernel)",
    "fused_adamw": "paddle_tpu/ops/pallas/fused_adam.py:22",
    "layer_norm": "paddle_tpu/ops/pallas/layer_norm.py:21",
    "conv_bn_relu": "tools/exp_pallas_conv.py:31",
}
ERNIE = dict(vocab_size=18000, hidden_size=1024, num_attention_heads=16,
             intermediate_size=4096)
SEQ, MAX_PREDS = 512, 80
# tools/bench_models.py bench_bert_base and bench_mnist
BERT_BASE_BATCH, BERT_BASE_SEQ, BERT_BASE_PREDS = 384, 128, 20
LENET_BATCH = 512
# tools/bench_models.py bench_transformer_big: b48 s256, 16 heads of 64.
# The phase trains under noam with a warm-up of 200 steps, not the
# published 4000: at 4000 the rate is 2.5e-7 at step 1 and no loss can be
# seen to fall in the phase's few steps; at 200 it climbs from 4.4e-5 at
# step 1 to 2e-4 at step 8, the scale of the ERNIE and BERT rows' 1e-4.
# The schedule is one op's attrs: the step does the same work.
WMT_BATCH, WMT_SEQ, WMT_HEADS, WMT_WARMUP = 48, 256, 16, 200
WMT_COUNTER = "@LR_DECAY_COUNTER@"
# the long-context rows of tools/bench_models.py bench_long_context:
# (seq, batch), max(80, seq * 15 // 100) masked predictions
LONG = ((2048, 4), (4096, 2))
# check_flash_bnsd: (B, Sq, Sk, causal, dtype, timed) at the shapes the six
# bnsd TPU kernels take; bnsd_ops: the [B,H,S,D] of its program
BNSD_CASES = ((40, 512, 512, False, torch.bfloat16, True),
              (40, 256, 256, False, torch.bfloat16, True),
              (40, 128, 128, False, torch.bfloat16, True),
              (40, 512, 256, False, torch.bfloat16, True),
              (40, 512, 512, True, torch.bfloat16, False),
              (4, 2048, 2048, False, torch.bfloat16, False),
              (40, 512, 512, False, torch.float32, False))
BNSD_OPS = (40, 16, 512, 64)
SOURCES = {n: f"paddle_tpu_torch/csrc/{n}.cu" for n in REPLACES}
# the servable dir the HTTP phases write and remove (listed in .gitignore)
SERVING_DIR = Path(__file__).resolve().parent / "build" / "torch_serving"


# the script's start: each phase line carries the seconds since it
# (at_s), so a run shows where its time limit goes
T0 = time.perf_counter()


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw,
                      "at_s": round(time.perf_counter() - T0, 1)}),
          flush=True)


def bound_ms(nbytes, flops, peak=FP32_FLOPS_PER_S):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def cur_stream():
    """The current stream's handle, looked up at each launch, so a raw
    launch lands in a CUDA-graph capture (device_ms) as well."""
    return torch.cuda.current_stream().cuda_stream


def profiled_device_ms(fn, reps):
    """ms per call of fn on the device alone from torch.profiler: the
    device time of every kernel over reps calls. For a call a CUDA graph
    does not capture: autograd's backward runs on the forward's stream."""
    from paddle_tpu_torch.tools.profile_flash import kernel_ms

    return sum(kernel_ms(fn, reps).values())


def with_device_ms(row, kernel, library=None, reps=30, library_graph=True):
    """Add device_ms (and library_device_ms) to a timed row: reps calls
    captured once in a CUDA graph and replayed between events, so the
    host's dispatch, which events_ms reads where it exceeds the device
    time, drops out. library_graph=False times the library call with the
    profiler."""
    from paddle_tpu_torch.tools.profile_layer_norm import graph_ms

    if row["ms"] is not None:
        row["device_ms"] = graph_ms(kernel, reps)
        if library is not None:
            row["library_device_ms"] = graph_ms(library, reps) \
                if library_graph else profiled_device_ms(library, reps)
    return row


def events_ms(fn, reps):
    """Device ms per call of fn over reps back-to-back calls."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def errors(got, ref):
    diff = (got.double() - ref.double()).abs()
    return float(diff.max()), float((diff / ref.double().abs().clamp_min(
        1e-6)).max())


def sass_count(lib, opcode):
    """How many instructions of ``opcode`` the SASS of a built library
    holds (cuobjdump -sass, from the toolkit that built it)."""
    from paddle_tpu_torch.kernels import _build

    tool = str(Path(_build.nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return sum(opcode in ln for ln in sass.splitlines())


def outside_tol(got, ref, tol):
    """How many elements of got lie outside allclose(ref, **tol)."""
    got, ref = got.double(), ref.double()
    return int(((got - ref).abs() > tol["atol"] + tol["rtol"] * ref.abs())
               .sum())


def ptxas_by_kernel(log, markers):
    """{kernel<head_dim,dropout>: its ptxas register and spill lines} for
    the entry functions of a ptxas -v log whose name holds one of
    ``markers``."""
    import re

    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"\d([a-z][a-z_0-9]*)ILi(\d+)ELb(\d)", ln)
            name = (f"{m.group(1)}<{m.group(2)},{m.group(3)}>"
                    if m and any(k in m.group(1) for k in markers) else None)
        elif name and ("spill" in ln or "registers" in ln):
            out.setdefault(name, []).append(ln.strip())
    return out


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flash(dev, results):
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    n, hd = FULL["n_head"], FULL["d_model"] // FULL["n_head"]
    scale = hd ** -0.5
    lib = fa._lib()
    for s in (128, 512, 2048):
        g = torch.Generator(device=dev).manual_seed(s)
        q, k, v = (torch.randn(1, s, n * hd, device=dev, generator=g)
                   for _ in range(3))
        out, lse = fa.packed_flash_fwd(q, k, v, n, scale, True)
        ref_out, ref_lse = fa.plain_packed_flash_fwd(q, k, v, n, scale, True)
        torch.cuda.synchronize()
        e_out, r_out = errors(out, ref_out)
        e_lse, _ = errors(lse, ref_lse)
        if not (torch.allclose(out, ref_out, rtol=1e-4, atol=1e-5)
                and torch.allclose(lse, ref_lse, rtol=1e-5, atol=1e-4)):
            raise AssertionError(f"flash forward S={s}: out err {e_out}, "
                                 f"lse err {e_lse}")
        o2, l2 = torch.empty_like(q), torch.empty_like(lse)
        strides = fa._stride_array("flash forward", hd, "packed", (
            ("q", q), ("k", k), ("v", v), ("out", o2)))

        def kernel(i):   # fp32 (dtype 0), no dropout (threshold 0)
            return lib.pt_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                o2.data_ptr(), l2.data_ptr(), strides, 1, s, s, n, hd, scale,
                1, 0, 0, 0, 1.0, cur_stream())

        ms = events_ms(kernel, 20)
        plain = events_ms(lambda i: fa.plain_packed_flash_fwd(
            q, k, v, n, scale, True), 10)
        q4, k4, v4 = (t.reshape(1, s, n, hd).transpose(1, 2).contiguous()
                      for t in (q, k, v))

        def sdpa(i):
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                  scale=scale)

        library = events_ms(sdpa, 10)
        pairs = s * (s + 1) // 2
        nbytes, flops = 4 * (4 * s * n * hd) + 4 * n * s, n * pairs * 4 * hd
        bms, by = bound_ms(nbytes, flops, TF32X3_FLOPS_PER_S)
        results.append(with_device_ms(dict(
            name="flash_attention_fwd", shape=f"B=1 S={s} n=16 hd=64 causal",
            max_abs_err=max(e_out, e_lse), max_rel_err=r_out, ms=ms,
            plain_ms=plain, library_ms=library, bound_ms=bms, bound_by=by,
            bound_ms_cuda_cores=bound_ms(nbytes, flops)[0]), kernel, sdpa))


def check_paged(dev, results):
    from paddle_tpu_torch.kernels import paged_attention as pa

    n, hd = FULL["n_head"], FULL["d_model"] // FULL["n_head"]
    b, page, mp = 8, 16, 128
    kvdim = n * hd
    pos_list = [0, 5, 100, 517, 1023, 1500, 2047, 300]
    num_pages = 1 + sum(p // page + 1 for p in pos_list)
    g = torch.Generator(device=dev).manual_seed(1)
    # several pool copies, > 50 MB L2 in all, so timing reads cold pools
    copies = []
    for c in range(3):
        pk = torch.randn(num_pages, page, kvdim, device=dev, generator=g)
        pv = torch.randn(num_pages, page, kvdim, device=dev, generator=g)
        copies.append((pk, pv))
    table = torch.zeros(b, mp, dtype=torch.int32)
    nxt = 1
    for i, p in enumerate(pos_list):
        need = p // page + 1
        table[i, :need] = torch.arange(nxt, nxt + need, dtype=torch.int32)
        nxt += need
        for pk, pv in copies:   # stale tail of the last page: poison
            last = int(table[i, p // page])
            pk[last, p % page + 1:] = 3e4
            pv[last, p % page + 1:] = 1e6
    table = table.to(dev)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    q = torch.randn(b, kvdim, device=dev, generator=g)
    pk, pv = copies[0]
    scale = hd ** -0.5
    out = pa.paged_decode_attention(q, pk, pv, table, pos, n, hd, scale)
    ref = pa.plain_paged_attention(q, pk, pv, table, pos, n, hd, scale)
    torch.cuda.synchronize()
    e_abs, e_rel = errors(out, ref)
    if not torch.allclose(out, ref, rtol=1e-4, atol=1e-5) \
            or float(out.abs().max()) > 100.0:
        raise AssertionError(f"paged attention: err {e_abs}, "
                             f"max |out| {float(out.abs().max())}")
    # the plan of a row depends on its own pos: each row launched alone
    # gives the bits of its row in the batch of 8
    for i in range(b):
        alone = pa.paged_decode_attention(q[i:i + 1], pk, pv, table[i:i + 1],
                                          pos[i:i + 1], n, hd, scale)
        if not torch.equal(alone[0], out[i]):
            raise AssertionError(f"paged attention: row {i} (pos "
                                 f"{pos_list[i]}) alone differs from the "
                                 f"row in the batch")
    lib = pa._lib()
    o2 = torch.empty_like(out)
    chunks = -(-mp * page // pa.CHUNK_TOKENS)
    part = torch.empty(b * n * chunks * (hd + 2), device=dev)
    tickets = torch.zeros(b * n, dtype=torch.int32, device=dev)

    def kernel(i):
        return lib.pt_paged_attention(
            q.data_ptr(), copies[i % 3][0].data_ptr(),
            copies[i % 3][1].data_ptr(), table.data_ptr(), pos.data_ptr(),
            o2.data_ptr(), part.data_ptr(), tickets.data_ptr(), b, n, hd,
            page, mp, kvdim, scale, cur_stream())

    ms = events_ms(kernel, 30)
    plain = events_ms(lambda i: pa.plain_paged_attention(
        q, copies[i % 3][0], copies[i % 3][1], table, pos, n, hd, scale), 10)
    ctx = sum(p + 1 for p in pos_list)
    bms, by = bound_ms(2 * ctx * kvdim * 4 + 2 * b * kvdim * 4
                       + table.numel() * 4 + b * 4, 4 * ctx * kvdim)
    results.append(with_device_ms(dict(
        name="paged_attention",
        shape=f"B=8 P=16 MP=128 n=16 hd=64 pos={pos_list}",
        max_abs_err=e_abs, max_rel_err=e_rel, ms=ms, plain_ms=plain,
        library_ms=None, bound_ms=bms, bound_by=by,
        chunk_tokens=pa.CHUNK_TOKENS, rows_alone_equal_batch_bitwise=True),
        kernel))


# check_int8: the serving ladder's M (decode: 8 slots, and 16, a prefix
# chunk of one page and the decode instance's largest M; prefill buckets
# 64, 512, 2048) at the decoder LM's three weight shapes (K, N)
INT8_M = (8, 16, 64, 512, 2048)
INT8_KN = ((1024, 1024), (1024, 4096), (4096, 1024))


def check_int8(dev, results):
    """The int8 GEMM against its plain version at INT8_M x INT8_KN, with
    and without bias + relu, within rtol 1e-4 / atol 1e-5 max|ref| +
    1e-5; the bias + relu rows timed: events and device ms (a CUDA-graph
    replay) of the kernel and of the dequantise-and-matmul library call,
    with the instance its M picks and its plan. The bound is the
    function's: its bytes, and 2MKN operations at the dense bf16 rate.
    Beside it, this design's floor at three bf16 products a fp32 one
    (bound_ms_three_pieces) and the fp32 CUDA-core bound."""
    from paddle_tpu_torch.kernels import int8_gemm as ig

    for m in INT8_M:
        for k, n in INT8_KN:
            g = torch.Generator(device=dev).manual_seed(m + k + n)
            # weight copies rotated through, > 50 MB L2 in all: a decode
            # step reads its 72 weights cold
            reps = max(1, (64 << 20) // (k * n))
            w8s = [torch.randint(-127, 128, (k, n), device=dev,
                                 dtype=torch.int8, generator=g)
                   for _ in range(reps)]
            x = torch.randn(m, k, device=dev, generator=g)
            sc = (torch.rand(n, device=dev, generator=g) + 0.5) / 127.0
            bias = torch.randn(n, device=dev, generator=g)
            err = (0.0, 0.0)
            for bb, act in ((None, None), (bias, "relu")):
                out = ig.int8_weight_only_gemm(x, w8s[0], sc, bb, act)
                ref = ig.plain_int8_gemm(x, w8s[0], sc, bb, act)
                torch.cuda.synchronize()
                e = errors(out, ref)
                err = (max(err[0], e[0]), max(err[1], e[1]))
                tol = 1e-5 * float(ref.abs().max()) + 1e-5
                if not torch.allclose(out, ref, rtol=1e-4, atol=tol):
                    raise AssertionError(f"int8 GEMM {m}x{k}x{n} act={act}: "
                                         f"err {e}")

            def kernel(i):
                return ig.int8_weight_only_gemm(x, w8s[i % reps], sc, bias,
                                                "relu")

            def matmul(i):
                return x @ (w8s[i % reps].float() * sc) + bias

            ms = events_ms(kernel, 30)
            plain = events_ms(lambda i: ig.plain_int8_gemm(
                x, w8s[i % reps], sc, bias, "relu"), 10)
            library = events_ms(matmul, 10)
            nbytes = m * k * 4 + k * n + n * 4 * 2 + m * n * 4
            flops = 2 * m * k * n
            bms, by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
            instance, tile, ksplit, kc = ig.plan(m, n, k)
            results.append(with_device_ms(dict(
                name="int8_gemm", instance=instance, tile=tile,
                ksplit=ksplit, kc=kc,
                shape=f"M={m} K={k} N={n} bias=True act=relu",
                max_abs_err=err[0], max_rel_err=err[1], ms=ms,
                plain_ms=plain, library_ms=library, bound_ms=bms,
                bound_by=by, bound_ms_three_pieces=bound_ms(
                    nbytes, 3 * flops, BF16_FLOPS_PER_S)[0],
                bound_ms_cuda_cores=bound_ms(nbytes, flops)[0]),
                kernel, matmul))
            del w8s


def _train_attn_inputs(dev, b, s, dtype, seed,
                       n=ERNIE["num_attention_heads"]):
    hd = 64
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, n * hd, device=dev, generator=g)
                   .to(dtype) for _ in range(4))
    bias = torch.where(torch.rand(b, s, device=dev, generator=g) < 0.1,
                       -1e4, 0.0)
    return q, k, v, do, bias


# fp32: the kernels sum in another order than the plain versions. bf16: the
# tensor-core kernels multiply bf16 inputs with fp32 accumulation and carry
# p, p * mask and ds * scale as bf16 hi + lo pairs (16 significant bits), so
# they are held against the plain versions run in fp32 on the same values
# and rounded to bf16 once: one bf16 ulp (2^-7 relative) plus 1e-3, about
# 2 % of a typical |out| or |dq| at S = 512 with N(0, 1) inputs. The plain
# versions on the bf16 values round those three to bf16 once, as the
# reference does; how many of their elements fall outside this tolerance
# is counted beside (reference_rounding_outside_tol). dbias is fp32 in
# both, |dbias| ~ 1.
TRAIN_TOL = {torch.float32: dict(rtol=1e-4, atol=2e-5),
             torch.bfloat16: dict(rtol=2 ** -7, atol=1e-3)}
DBIAS_TOL = dict(rtol=1e-3, atol=1e-3)
RATE, ATTN_SEED = 0.1, 20261016


def _compare_flash(fa, what, q, k, v, do, bias, n, scale, causal=False,
                   layout="packed"):
    """The forward with dropout and the backward against the plain
    versions computed in fp32 from the same values; returns the kernel's
    (out, lse) and the largest absolute error of each output."""
    dtype = q.dtype
    instance = fa.DTYPES[dtype][1]
    before = (fa.launches_by_dtype[instance],
              fa.bwd_launches_by_dtype[instance])
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    out, lse = fa.flash_fwd(q, k, v, n, scale, causal, bias, RATE, ATTN_SEED,
                            layout)
    r_out, r_lse = fa.plain_flash_fwd(q32, k32, v32, n, scale, causal, bias,
                                      RATE, ATTN_SEED, layout)
    r_out = r_out.to(dtype)
    torch.cuda.synchronize()
    if not (torch.allclose(out.float(), r_out.float(), **TRAIN_TOL[dtype])
            and torch.allclose(lse, r_lse, rtol=1e-5, atol=1e-4)):
        raise AssertionError(f"flash forward+dropout {what}: "
                             f"{errors(out, r_out)} {errors(lse, r_lse)}")
    err = {"out": errors(out, r_out)[0], "lse": errors(lse, r_lse)[0]}
    tol = TRAIN_TOL[dtype]
    outside = {"out": outside_tol(
        fa.plain_flash_fwd(q, k, v, n, scale, causal, bias, RATE, ATTN_SEED,
                           layout)[0], r_out, tol)}
    # both backwards start from the same saved (out, lse)
    got = fa.flash_bwd(q, k, v, r_out, r_lse, do, n, scale, causal, bias,
                       RATE, ATTN_SEED, layout)
    ref = fa.plain_flash_bwd(q32, k32, v32, r_out.float(), r_lse, do32, n,
                             scale, causal, bias, RATE, ATTN_SEED, layout)
    ref_rounded = fa.plain_flash_bwd(q, k, v, r_out, r_lse, do, n, scale,
                                     causal, bias, RATE, ATTN_SEED, layout)
    torch.cuda.synchronize()
    for name, a, r, rr in zip(("dq", "dk", "dv", "dbias"), got, ref,
                              ref_rounded):
        if r is None:
            continue
        if name == "dbias":
            tol = DBIAS_TOL
        else:
            tol, r = TRAIN_TOL[dtype], r.to(dtype)
            outside[name] = outside_tol(rr, r, tol)
        err[name] = errors(a, r)[0]
        if not torch.allclose(a.float(), r.float(), **tol):
            raise AssertionError(f"flash backward {what} {name}: "
                                 f"{errors(a, r)}")
    err["reference_rounding_outside_tol"] = outside
    # both calls ran the dtype's instance (fp32: split TF32)
    if (fa.launches_by_dtype[instance], fa.bwd_launches_by_dtype[instance]) \
            != (before[0] + 1, before[1] + 1):
        raise AssertionError(f"flash {what}: not on the {instance} instance")
    err["instance"] = instance
    return out, lse, err


def _time_flash(fa, q, k, v, do, bias, n, scale, out, lse, layout,
                plain_reps=3, causal=False):
    """(forward, backward) timings: kernel ms, plain ms, SDPA ms (its
    forward; its backward through autograd) and the bound, for the
    dropout call of the training step: with the key bias, or causal with
    none. The bound's peak is the dense bf16 rate for bf16 and the
    split-TF32 rate for fp32 (beside it, for fp32, the CUDA-core bound),
    and the device-only times. A causal call's products count only the
    query-key pairs on or below the diagonal (Sq = Sk: S (S + 1) / 2 of
    them)."""
    import torch.nn.functional as F

    esz = q.element_size()
    nq, nk = q.numel(), k.numel()
    b = q.shape[0]
    sq = lse.shape[-1]
    sk = k.shape[2] if layout == "bnsd" else k.shape[1]
    heads, hd = b * n, q.shape[-1] if layout == "bnsd" else q.shape[-1] // n
    q4, k4, v4, do4 = (fa._heads(t, n, layout).contiguous()
                       for t in (q, k, v, do))
    m4 = None if bias is None else \
        bias.to(q.dtype).reshape(b, 1, 1, sk).expand(b, 1, sq, sk)
    bias_bytes = 0 if bias is None else bias.numel() * 4
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    f32 = q.dtype == torch.float32
    peak = TF32X3_FLOPS_PER_S if f32 else BF16_FLOPS_PER_S

    def kfwd(i):
        return fa.flash_fwd(q, k, v, n, scale, causal, bias, RATE,
                            ATTN_SEED, layout)

    def sdpa(i):
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4,
                                              dropout_p=RATE, scale=scale,
                                              is_causal=causal)

    fwd = dict(
        ms=events_ms(kfwd, 10),
        plain_ms=events_ms(lambda i: fa.plain_flash_fwd(
            q, k, v, n, scale, causal, bias, RATE, ATTN_SEED, layout),
            plain_reps),
        library_ms=events_ms(sdpa, 10))
    io, flops = ((2 * nq + 2 * nk) * esz + bias_bytes + lse.numel() * 4,
                 heads * 2 * 2 * pairs * hd)
    fwd["bound_ms"], fwd["bound_by"] = bound_ms(io, flops, peak)
    if f32:
        fwd["bound_ms_cuda_cores"] = bound_ms(io, flops)[0]
    with_device_ms(fwd, kfwd, sdpa)

    def kbwd(i):
        return fa.flash_bwd(q, k, v, out, lse, do, n, scale, causal, bias,
                            RATE, ATTN_SEED, layout)

    bwd = dict(
        ms=events_ms(kbwd, 10),
        plain_ms=events_ms(lambda i: fa.plain_flash_bwd(
            q, k, v, out, lse, do, n, scale, causal, bias, RATE, ATTN_SEED,
            layout), plain_reps))
    q4, k4, v4 = (t.requires_grad_(True) for t in (q4, k4, v4))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4,
                                        dropout_p=RATE, scale=scale,
                                        is_causal=causal)

    def sdpa_bwd(i):
        return torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)

    bwd["library_ms"] = events_ms(sdpa_bwd, 10)
    io, flops = ((4 * nq + 4 * nk) * esz + lse.numel() * 4 +
                 2 * bias_bytes, heads * 5 * 2 * pairs * hd)
    bwd["bound_ms"], bwd["bound_by"] = bound_ms(io, flops, peak)
    if f32:
        bwd["bound_ms_cuda_cores"] = bound_ms(io, flops)[0]
    with_device_ms(bwd, kbwd, lambda: sdpa_bwd(0), library_graph=False)
    return fwd, bwd


def _flash_rows(results, shape, err, timing):
    """Append and return one result row per flash kernel; err from
    _compare_flash, timing from _time_flash (or None: compared only)."""
    rows = []
    for i, (name, keys) in enumerate((
            ("flash_attention_fwd", ("out", "lse")),
            ("flash_attention_bwd", ("dq", "dk", "dv", "dbias")))):
        row = dict(name=name, shape=shape, max_rel_err=None,
                   instance=err["instance"],
                   max_abs_err=max(err[k_] for k_ in keys if k_ != "dbias"),
                   errors={k_: err[k_] for k_ in keys if k_ in err},
                   reference_rounding_outside_tol={
                       k_: n_ for k_, n_ in
                       err["reference_rounding_outside_tol"].items()
                       if k_ in keys})
        row.update(timing[i] if timing else dict(
            ms=None, plain_ms=None, library_ms=None, bound_ms=None,
            bound_by=None))
        rows.append(row)
    results.extend(rows)
    return rows


def check_flash_train(dev, results):
    """Flash forward with dropout and flash backward, compared and timed at
    the training step's attention shape (B = 40, S = 512, 16 heads of 64,
    key bias, rate 0.1), and compared at S = 128 and at S = 200 (not a
    multiple of the 64-row tile) with B = 4."""
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.kernels import flash_attention as fa

    n, hd = ERNIE["num_attention_heads"], 64
    scale = hd ** -0.5
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        small = {}
        for s in (128, 200):
            q, k, v, do, bias = _train_attn_inputs(dev, 4, s, dtype, s)
            small[f"S={s}"] = _compare_flash(
                fa, f"{name} B=4 S={s}", q, k, v, do, bias, n, scale)[2]
        b, s = 40, SEQ
        q, k, v, do, bias = _train_attn_inputs(dev, b, s, dtype, 1)
        out, lse, err = _compare_flash(fa, f"{name} B={b} S={s}", q, k, v,
                                       do, bias, n, scale)
        timing = _time_flash(fa, q, k, v, do, bias, n, scale, out, lse,
                             "packed")
        fwd, bwd = _flash_rows(
            results, f"B={b} S={s} n=16 hd=64 bias dropout={RATE} {name}",
            err, timing)
        fwd["max_abs_err_at_b4"] = {k_: e["out"] for k_, e in small.items()}
        bwd["max_abs_err_at_b4"] = {k_: max(e["dq"], e["dk"], e["dv"])
                                    for k_, e in small.items()}
        del out, lse

    # the kernels' keep masks, read back exactly, in both dtypes
    checked = {"bf16" if dtype == torch.bfloat16 else "fp32":
               _mask_readback(fa, dev, dtype, 2, SEQ, n)
               for dtype in (torch.bfloat16, torch.float32)}
    want = rng.attn_keep(ATTN_SEED, RATE, 2, n, SEQ, SEQ, dev)
    return dict(mask_bits_checked=checked,
                keep_fraction=float(want.float().mean()))


def _mask_readback(fa, dev, dtype, b, s, n, causal=False, bias=None):
    """Both flash kernels' dropout keep masks, read back exactly and held
    bit for bit against the plain mask where a key is seen (on or below
    the diagonal if causal, where the key bias is 0). Forward: q = k = 0
    makes every seen probability positive, and v one-hot over a 64-key
    chunk makes out[q, d] nonzero exactly where keep(q, chunk + d).
    Backward: q = k = v = 0 and out = 0 make ds = 0, and do one-hot over a
    64-row chunk makes dv[k, d] nonzero exactly where keep(chunk + d, k).
    The kernels read the seed through a pointer: each mask is read with
    the seed as a Python int and as a device int64 (what the compiled
    step's seed table holds). Returns the mask bits checked."""
    from paddle_tpu_torch.core import rng

    hd = 64
    seen = torch.ones(s, s, dtype=torch.bool, device=dev)
    if causal:
        seen = torch.tril(seen)
    seen = seen[None, None]
    if bias is not None:
        seen = seen & (bias == 0)[:, None, None, :]
    want = rng.attn_keep(ATTN_SEED, RATE, b, n, s, s, dev) & seen
    eye = torch.eye(hd, device=dev)[None, :, None]
    seed_t = torch.full((), ATTN_SEED, dtype=torch.int64, device=dev)
    name = "bf16" if dtype == torch.bfloat16 else "fp32"
    zero = torch.zeros(b, s, n * hd, device=dev, dtype=dtype)
    lse = torch.full((b, n, s), float(np.log(s)), device=dev)
    for c in range(s // hd):
        chunk = torch.zeros(b, s, n, hd, device=dev, dtype=dtype)
        chunk[:, c * hd:(c + 1) * hd] = eye
        chunk = chunk.reshape(b, s, n * hd)
        for seed in (ATTN_SEED, seed_t):
            out, _ = fa.packed_flash_fwd(zero, zero, chunk, n, 1.0, causal,
                                         bias, RATE, seed)
            got = out.reshape(b, s, n, hd).permute(0, 2, 1, 3) != 0
            if not torch.equal(got, want[..., c * hd:(c + 1) * hd]):
                raise AssertionError(
                    f"flash forward {name}: the kernel's dropout keep "
                    f"mask differs from the plain mask (seed "
                    f"{type(seed).__name__}, causal {causal}, bias "
                    f"{bias is not None})")
            dv = fa.packed_flash_bwd(zero, zero, zero, zero, lse, chunk, n,
                                     1.0, causal, bias, RATE, seed)[2]
            got = dv.reshape(b, s, n, hd).permute(0, 2, 3, 1) != 0
            if not torch.equal(got, want[:, :, c * hd:(c + 1) * hd]):
                raise AssertionError(
                    f"flash backward {name}: the kernel's dropout keep "
                    f"mask differs from the plain mask (seed "
                    f"{type(seed).__name__}, causal {causal}, bias "
                    f"{bias is not None})")
    return {"forward": int(want.numel()), "backward": int(want.numel()),
            "seeds": ["int", "device int64"]}


def check_flash_bert_base(dev, results):
    """Both flash kernels at BERT-base's attention shape in its s128 step
    (B = 384, S = 128, 12 heads of 64, bf16, key bias, dropout 0.1):
    compared with the plain version run in fp32, timed beside SDPA."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    b, s, n = BERT_BASE_BATCH, BERT_BASE_SEQ, 12
    q, k, v, do, bias = _train_attn_inputs(dev, b, s, torch.bfloat16, 3, n)
    out, lse, err = _compare_flash(fa, f"bf16 B={b} S={s}", q, k, v, do,
                                   bias, n, 64 ** -0.5)
    timing = _time_flash(fa, q, k, v, do, bias, n, 64 ** -0.5, out, lse,
                         "packed")
    _flash_rows(results, f"B={b} S={s} n={n} hd=64 bias dropout={RATE} "
                f"bf16", err, timing)


def _wmt_attn_inputs(dev, cross):
    """q, k, v, dout [48, 256, 16*64] bf16 at Transformer-big's attention
    shape, and for cross-attention the source key-padding bias (mask - 1)
    * 1e9 with 128 to 256 live keys a row, as
    models.transformer.synthetic_batch makes the source mask."""
    b, s, n = WMT_BATCH, WMT_SEQ, WMT_HEADS
    g = torch.Generator(device=dev).manual_seed(10 + cross)
    q, k, v, do = (torch.randn(b, s, n * 64, device=dev, generator=g)
                   .bfloat16() for _ in range(4))
    bias = None
    if cross:
        lens = torch.randint(s // 2, s + 1, (b,), device=dev, generator=g)
        live = torch.arange(s, device=dev)[None, :] < lens[:, None]
        bias = (live.float() - 1.0) * 1e9
    return q, k, v, do, bias


def check_flash_transformer_big(dev, results):
    """Both flash kernels at Transformer-big's attention shape (B = 48,
    S = 256, 16 heads of 64, bf16, dropout 0.1) in the step's two new
    forms: the decoder's causal self-attention with no bias, and
    cross-attention (q distinct from k and v) under the source key bias.
    Each compared with the plain version run in fp32 (one bf16 ulp +
    1e-3), its keep masks read back bit for bit, timed beside SDPA."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    b, s, n = WMT_BATCH, WMT_SEQ, WMT_HEADS
    masks = {}
    for form in ("causal", "cross"):
        causal, cross = form == "causal", form == "cross"
        q, k, v, do, bias = _wmt_attn_inputs(dev, cross)
        out, lse, err = _compare_flash(fa, f"bf16 B={b} S={s} {form}", q, k,
                                       v, do, bias, n, 64 ** -0.5, causal)
        timing = _time_flash(fa, q, k, v, do, bias, n, 64 ** -0.5, out, lse,
                             "packed", causal=causal)
        what = "causal" if causal else "cross key-bias"
        _flash_rows(results, f"B={b} S={s} n={n} hd=64 {what} "
                    f"dropout={RATE} bf16", err, timing)
        masks[form] = _mask_readback(fa, dev, torch.bfloat16, b, s, n,
                                     causal, bias)
        del q, k, v, do, out, lse
    return masks


def check_flash_long(dev, results):
    """Both flash kernels at the long-context step's own attention shapes
    (packed [B,S,16*64] projections read in place, key bias, dropout 0.1):
    bf16 at B = 4, S = 2048 and B = 2, S = 4096, fp32 at B = 4, S = 2048.
    Compared with the plain version run in fp32 on the same values (its
    [B,16,S,S] temporaries, 2 GiB each at S = 4096, fit the card) and
    timed."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    n, hd = ERNIE["num_attention_heads"], 64
    for (s, b), dtype in ((LONG[0], torch.bfloat16),
                          (LONG[1], torch.bfloat16),
                          (LONG[0], torch.float32)):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        q, k, v, do, bias = _train_attn_inputs(dev, b, s, dtype, s + b)
        out, lse, err = _compare_flash(fa, f"long {name} B={b} S={s}", q, k,
                                       v, do, bias, n, hd ** -0.5)
        torch.cuda.empty_cache()
        timing = _time_flash(fa, q, k, v, do, bias, n, hd ** -0.5, out, lse,
                             "packed", plain_reps=2)
        _flash_rows(results, f"B={b} S={s} n=16 hd=64 bias dropout={RATE} "
                             f"{name} long", err, timing)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()


def check_flash_empty_rows(dev, results):
    """Causal flash attention with Sq > Sk (Sq = 256, Sk = 128, packed
    [B,S,16*64], bottom-right aligned): the first 128 query rows see no
    key. As in the reference (mask value -1e30), each is the uniform
    softmax over all Sk keys: out the mean of the dropout-masked v, lse
    -1e30; the backward gives those rows dq 0, nothing to dk, and
    (1 / Sk) mask do to dv. Both kernels, bf16 and fp32, with dropout,
    with and without the key bias, against the plain versions in fp32
    (_compare_flash, every row); then the rows without a key apart: out
    not 0 and within the tolerance of the plain mean, lse -1e30, dq 0.
    No model path reaches this case."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    n, hd, sq, sk = 16, 64, 256, 128
    empty = sq - sk
    scale = hd ** -0.5
    checked = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        for with_bias in (False, True):
            g = torch.Generator(device=dev).manual_seed(sq + with_bias)
            q, do = (torch.randn(1, sq, n * hd, device=dev, generator=g)
                     .to(dtype) for _ in range(2))
            k, v = (torch.randn(1, sk, n * hd, device=dev, generator=g)
                    .to(dtype) for _ in range(2))
            bias = torch.where(torch.rand(1, sk, device=dev, generator=g)
                               < 0.25, -1e4, 0.0) if with_bias else None
            what = f"empty rows {name} Sq={sq} Sk={sk}" + \
                (" bias" if with_bias else "")
            out, lse, err = _compare_flash(fa, what, q, k, v, do, bias, n,
                                           scale, causal=True)
            ref_out, _ = fa.plain_flash_fwd(q.float(), k.float(), v.float(),
                                            n, scale, True, bias, RATE,
                                            ATTN_SEED)
            grads = fa.flash_bwd(q, k, v, out, lse, do, n, scale, True,
                                 bias, RATE, ATTN_SEED)
            torch.cuda.synchronize()
            rows_out = out[:, :empty].float()
            ok = (bool(rows_out.abs().max() > 0)
                  and torch.allclose(rows_out,
                                     ref_out[:, :empty].to(dtype).float(),
                                     **TRAIN_TOL[dtype])
                  and bool((lse[..., :empty] == fa.NEG_INF).all())
                  and not bool(grads[0][:, :empty].float().any())
                  and bool(grads[2].float().abs().max() > 0))
            if not ok:
                raise AssertionError(f"flash {what}: the rows that see no "
                                     f"key disagree with the reference's "
                                     f"uniform softmax")
            checked[what] = dict(
                out_rows_max_abs_err=errors(rows_out,
                                            ref_out[:, :empty])[0],
                out_rows_max_abs=float(rows_out.abs().max()))
            _flash_rows(results, f"B=1 Sq={sq} Sk={sk} n=16 hd=64 causal "
                                 f"dropout={RATE} {name}"
                                 + (" bias" if with_bias else "")
                                 + " (rows 0-127 see no key)", err, None)
    return checked


def _bnsd_inputs(dev, b, sq, sk, dtype, seed):
    n, hd = ERNIE["num_attention_heads"], 64
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, n, sq, hd, device=dev, generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, n, sk, hd, device=dev, generator=g).to(dtype)
            for _ in range(2))
    bias = torch.where(torch.rand(b, sk, device=dev, generator=g) < 0.1,
                       -1e4, 0.0)
    return q, k, v, do, bias


def check_flash_bnsd(dev, results):
    """Both flash kernels in the [B,H,S,D] layout at the shapes the six
    bnsd TPU kernels take, 16 heads of 64, key bias and dropout 0.1, bf16:
    B = 40 at S = 512 and 256 (rows 5, 6, 9) and 128 (rows 6, 7), timed;
    cross-attention Sq = 512, Sk = 256; causal at S = 512; B = 4 at S =
    2048 (rows 10, 11, 2); fp32 at S = 512. Each against its plain version,
    and against the packed layout on the same values, bit for bit: the
    same arithmetic through other strides."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    n, hd = ERNIE["num_attention_heads"], 64
    scale = hd ** -0.5
    same_bits = 0
    for b, sq, sk, causal, dtype, timed in BNSD_CASES:
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        shape = (f"B={b} Sq={sq} Sk={sk} n=16 hd=64 bias dropout={RATE}"
                 f"{' causal' if causal else ''} {name} bnsd")
        q, k, v, do, bias = _bnsd_inputs(dev, b, sq, sk, dtype, sq + sk + b)
        out, lse, err = _compare_flash(fa, shape, q, k, v, do, bias, n,
                                       scale, causal, "bnsd")
        # the same values through the packed layout: the same bits
        runs = {}
        for layout in ("bnsd", "packed"):
            args = [t if layout == "bnsd" else
                    t.transpose(1, 2).reshape(b, t.shape[2], n * hd)
                    .contiguous() for t in (q, k, v, do)]
            o, l_ = fa.flash_fwd(*args[:3], n, scale, causal, bias, RATE,
                                 ATTN_SEED, layout)
            g = fa.flash_bwd(*args[:3], o, l_, args[3], n, scale, causal,
                             bias, RATE, ATTN_SEED, layout)
            runs[layout] = [fa._heads(t, n, layout) for t in (o, *g[:3])] + \
                [l_, g[3]]
        torch.cuda.synchronize()
        for what, x, y in zip(("out", "dq", "dk", "dv", "lse", "dbias"),
                              runs["bnsd"], runs["packed"]):
            if not torch.equal(x, y):
                raise AssertionError(f"flash {shape}: {what} differs between "
                                     f"the bnsd and packed layouts")
        same_bits += sum(t.numel() for t in runs["bnsd"])
        del runs
        timing = None
        if timed:
            timing = _time_flash(fa, q, k, v, do, bias, n, scale, out, lse,
                                 "bnsd")
        _flash_rows(results, shape, err, timing)
        del q, k, v, do, out, lse
    torch.cuda.empty_cache()
    return dict(bnsd_equals_packed_bitwise=True, elements_compared=same_bits)


def check_adamw(dev, results):
    from paddle_tpu_torch.kernels import fused_adam as fad

    lr = torch.tensor([1e-4], device=dev)
    b1p, b2p = (torch.tensor([x], device=dev) for x in (0.9 ** 3, 0.999 ** 3))
    hyper = (0.9, 0.999, 1e-8, 0.01)
    for shape in ((1024, 4096), (18000, 1024)):
        for dtype in (torch.bfloat16, torch.float32):
            name = "bf16" if dtype == torch.bfloat16 else "fp32"
            g = torch.Generator(device=dev).manual_seed(shape[0])
            # several copies, > 50 MB L2 in all: a step reads each
            # parameter cold
            reps = 4
            ps = [(torch.randn(shape, device=dev, generator=g) * 0.02)
                  .to(dtype) for _ in range(reps)]
            gr = (torch.randn(shape, device=dev, generator=g) * 1e-2) \
                .to(dtype)
            ms_ = [torch.randn(shape, device=dev, generator=g) * 1e-3
                   for _ in range(reps)]
            vs = [torch.rand(shape, device=dev, generator=g) * 1e-5
                  for _ in range(reps)]
            want = fad.plain_fused_adamw(ps[0], gr, ms_[0], vs[0], lr, *hyper,
                                         b1p, b2p)
            p0, m0, v0 = ps[0].clone(), ms_[0].clone(), vs[0].clone()
            pows = [b1p.clone(), b2p.clone()]
            fad.fused_adamw_(p0, gr, m0, v0, lr, *hyper, *pows)
            torch.cuda.synchronize()
            ptol = _adamw_tols(dtype)
            if not (torch.allclose(p0.float(), want[0].float(), **ptol)
                    and torch.allclose(m0, want[1], rtol=1e-6, atol=1e-9)
                    and torch.allclose(v0, want[2], rtol=1e-6, atol=1e-12)
                    and _pows_advanced(pows, (b1p, b2p), hyper)):
                raise AssertionError(f"AdamW {shape} {name}: "
                                     f"{errors(p0, want[0])}, powers "
                                     f"{pows}")
            e_abs = max(errors(p0, want[0])[0], errors(m0, want[1])[0],
                        errors(v0, want[2])[0])
            # the launch the adamw op makes (the powers advanced, on the
            # stream's ticket), without the wrapper, so a CUDA graph
            # captures the kernel alone
            kernel = _adamw_raw(fad, ps, gr, ms_, vs, lr, hyper, pows)

            ms = events_ms(kernel, 20)
            plain = events_ms(lambda i: fad.plain_fused_adamw(
                ps[i % reps], gr, ms_[i % reps], vs[i % reps], lr, *hyper,
                b1p, b2p), 5)
            library = lib_call = None
            steps = [torch.tensor(3.0, device=dev) for _ in range(reps)]

            def lib_call(i):
                return torch._fused_adamw_(
                    [ps[i % reps]], [gr], [ms_[i % reps]],
                    [vs[i % reps]], [], [steps[i % reps]], lr=1e-4,
                    beta1=0.9, beta2=0.999, weight_decay=0.01, eps=1e-8,
                    amsgrad=False, maximize=False)

            # the library's fused update is the fp32 rows' yardstick; for
            # bf16 params with fp32 moments only if it takes them and
            # computes this update
            verdict = "fp32" if dtype == torch.float32 else \
                _fused_adamw_takes_bf16(dev, lr, hyper, b1p, b2p)
            if verdict in ("fp32", "accepts"):
                library = events_ms(lib_call, 20)
            else:
                lib_call = None
            esz = ps[0].element_size()
            numel = ps[0].numel()
            bms, by = bound_ms(numel * (3 * esz + 16), numel * 12,
                               FP32_FLOPS_PER_S)
            results.append(with_device_ms(dict(
                name="fused_adamw", shape=f"{list(shape)} {name}",
                max_abs_err=e_abs, max_rel_err=None, ms=ms, plain_ms=plain,
                library_ms=library, library_verdict=verdict, bound_ms=bms,
                bound_by=by), kernel, lib_call))
    return dict(ragged_views=_adamw_ragged_views(dev, lr, hyper, b1p, b2p),
                beta_powers=_adamw_beta_powers(dev, lr, hyper),
                kernels_per_adamw_op=_adamw_op_kernels(dev))


def _adamw_raw(fad, ps, gr, ms_, vs, lr, hyper, pows):
    """fn(i): the AdamW kernel on state i % len(ps), launched as the
    wrapper launches it, beta powers advanced on a ticket of its own."""
    lib = fad._lib()
    ticket = torch.zeros(1, dtype=torch.int32, device=gr.device)
    b1, b2, eps, wd = hyper

    def kernel(i):
        k = i % len(ps)
        head, nvec = fad.split(gr.numel(), gr.element_size(),
                               fad.VEC[gr.dtype], ps[k].data_ptr(),
                               gr.data_ptr(), ms_[k].data_ptr(),
                               vs[k].data_ptr())
        return lib.pt_fused_adamw(
            ps[k].data_ptr(), gr.data_ptr(), ms_[k].data_ptr(),
            vs[k].data_ptr(), lr.data_ptr(), pows[0].data_ptr(),
            pows[1].data_ptr(), ticket.data_ptr(), gr.numel(), head, nvec,
            b1, 1.0 - b1, b2, 1.0 - b2, eps, wd, fad.DTYPES[gr.dtype],
            cur_stream())

    return kernel


def _pows_advanced(got, before, hyper):
    """Whether the powers got equal before * (b1, b2) as the plain
    route computes them on the CPU (one fp32 multiply each), bit for
    bit."""
    return all(torch.equal(g.cpu(), b.cpu() * f)
               for g, b, f in zip(got, before, hyper[:2]))


def _adamw_tols(dtype):
    # fp32: nvcc contracts a * b + c into one fma where the plain version
    # rounds twice; bf16 params: one bf16 ulp (2^-8)
    return dict(rtol=1e-6, atol=1e-7) if dtype == torch.float32 \
        else dict(rtol=8e-3, atol=1e-7)


def _fused_adamw_takes_bf16(dev, lr, hyper, b1p, b2p):
    """Whether torch._fused_adamw_ takes a bf16 param and grad with fp32
    moments and computes this update at [1024, 4096], or what it says."""
    g = torch.Generator(device=dev).manual_seed(1024)
    shape = (1024, 4096)
    p = (torch.randn(shape, device=dev, generator=g) * 0.02).bfloat16()
    gr = (torch.randn(shape, device=dev, generator=g) * 1e-2).bfloat16()
    m = torch.randn(shape, device=dev, generator=g) * 1e-3
    v = torch.rand(shape, device=dev, generator=g) * 1e-5
    from paddle_tpu_torch.kernels import fused_adam as fad

    ref = fad.plain_fused_adamw(p, gr, m, v, lr, *hyper, b1p, b2p)
    try:
        torch._fused_adamw_([p], [gr], [m], [v], [],
                            [torch.tensor(3.0, device=dev)], lr=1e-4,
                            beta1=0.9, beta2=0.999, weight_decay=0.01,
                            eps=1e-8, amsgrad=False, maximize=False)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError) as e:
        return f"refuses: {str(e).splitlines()[0][:160]}"
    # the library puts eps elsewhere (eps * sqrt(1 - b2^t)) and lerps the
    # moments: a bf16 ulp on the param, 1e-5 on the first moment
    same = torch.allclose(p.float(), ref[0].float(), rtol=2e-2, atol=1e-6) \
        and torch.allclose(m, ref[1], rtol=1e-5, atol=1e-9)
    return "accepts" if same else "accepts the call, computes another " \
                                   "update"


def _adamw_ragged_views(dev, lr, hyper, b1p, b2p):
    """Views offset by one element of a length that is no whole number
    of 16-byte vectors: the kernel's scalar head and tail."""
    from paddle_tpu_torch.kernels import fused_adam as fad

    numel = 1000 * 33 + 5
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device=dev).manual_seed(numel)
        bases = [(torch.randn(numel + 1, device=dev, generator=g) * 0.02)
                 .to(dtype),
                 (torch.randn(numel + 1, device=dev, generator=g) * 1e-2)
                 .to(dtype),
                 torch.randn(numel + 1, device=dev, generator=g) * 1e-3,
                 torch.rand(numel + 1, device=dev, generator=g) * 1e-5]
        views = [t[1:] for t in bases]
        heads = [t[:1].clone() for t in bases]
        want = fad.plain_fused_adamw(*views, lr, *hyper, b1p, b2p)
        pows = [b1p.clone(), b2p.clone()]
        fad.fused_adamw_(*views, lr, *hyper, *pows)
        torch.cuda.synchronize()
        if not (torch.allclose(views[0].float(), want[0].float(),
                               **_adamw_tols(dtype))
                and torch.allclose(views[2], want[1], rtol=1e-6, atol=1e-9)
                and torch.allclose(views[3], want[2], rtol=1e-6,
                                   atol=1e-12)
                and _pows_advanced(pows, (b1p, b2p), hyper)
                and all(torch.equal(t[:1], h) for t, h in zip(bases,
                                                              heads))):
            raise AssertionError(f"AdamW on a view offset by one, "
                                 f"{numel} elements, {dtype}: "
                                 f"{errors(views[0], want[0])}")
        errs[str(dtype)] = errors(views[0], want[0])[0]
    return dict(numel=numel, offset_elements=1, max_abs_err=errs)


def _adamw_beta_powers(dev, lr, hyper):
    """Three launches that also advance b1^t and b2^t, at [1024, 4096]
    (many blocks), beside the plain route on the CPU: the powers bit for
    bit after each."""
    from paddle_tpu_torch.kernels import fused_adam as fad

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device=dev).manual_seed(3)
        card = [(torch.randn(1024, 4096, device=dev, generator=g) * 0.02)
                .to(dtype),
                (torch.randn(1024, 4096, device=dev, generator=g) * 1e-2)
                .to(dtype),
                torch.randn(1024, 4096, device=dev, generator=g) * 1e-3,
                torch.rand(1024, 4096, device=dev, generator=g) * 1e-5]
        cpu = [t.cpu() for t in card]
        pows = [torch.tensor([b], device=dev) for b in hyper[:2]]
        cpu_pows = [t.cpu() for t in pows]
        for step in range(3):
            fad.fused_adamw_(*card, lr, *hyper, *pows)
            fad.fused_adamw_(*cpu, lr.cpu(), *hyper, *cpu_pows)
            torch.cuda.synchronize()
            if any(a.cpu().numpy().tobytes() != b.numpy().tobytes()
                   for a, b in zip(pows, cpu_pows)):
                raise AssertionError(f"AdamW beta powers after launch "
                                     f"{step + 1}: {pows} vs {cpu_pows}")
            if not torch.allclose(card[0].cpu().float(), cpu[0].float(),
                                  **_adamw_tols(dtype)):
                raise AssertionError(f"AdamW with the powers advanced, "
                                     f"launch {step + 1}: param differs")
            for c, t in zip(card, cpu):   # one update compared at a time
                c.copy_(t)
        out[str(dtype)] = [float(t) for t in pows]
    return dict(launches=3, bitwise=True, powers=out)


def _adamw_op_kernels(dev):
    """A tiny program (fc, mean, AdamW) on the card: torch.profiler's
    count of CUDA kernels over one run of each adamw op, as the executor
    runs it, after a warm-up step. Each must be one, the AdamW kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import layers, optimizer
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.executor import Executor, run_op
    from paddle_tpu_torch.core.ir import Program, program_guard
    from paddle_tpu_torch.core.scope import Scope

    main_prog, startup = Program(), Program()
    with unique_name.guard(), program_guard(main_prog, startup):
        x = layers.static_data("x", [-1, 64])
        h = layers.fc(x, 128, act="relu")
        loss = layers.mean(layers.fc(h, 16))
        optimizer.AdamWOptimizer(1e-3).minimize(loss)
    scope, exe = Scope(), Executor(device=dev)
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(0).randn(8, 64).astype(np.float32)}
    exe.run(main_prog, feed=feed, scope=scope, fetch_list=[loss])
    env = dict(scope.items())
    counts, empty_traces = [], 0
    for op in (o for o in main_prog.global_block().ops if o.type == "adamw"):
        param = env[op.inputs["Param"][0]]
        env[op.inputs["Grad"][0]] = torch.full_like(param, 1e-3)
        names = []
        # a trace that recorded no device activity at all is the
        # profiler's failure, not the op's (the op always launches): one
        # more trace of the same call, counted in the output
        for _ in range(2):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run_op(op, env)
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
            if names:
                break
            empty_traces += 1
        if len(names) != 1 or "adamw" not in names[0]:
            raise AssertionError(f"an adamw op launched {names}, not the "
                                 f"AdamW kernel alone")
        counts.append(len(names))
    if not counts:
        raise AssertionError("the AdamW program has no adamw op")
    return dict(adamw_ops=len(counts), kernels_each=sorted(set(counts)),
                empty_traces=empty_traces)


# ---------------------------------------------------------------------------
# 3. serving at full width
# ---------------------------------------------------------------------------

# the serve phases' engine and traffic: 9 prompts of 5..1500 tokens, 32 new
# tokens each, the last sampled at temperature 0.8 with seed 7
SERVE_CONF = dict(max_slots=8, page_size=16, kv_pages=1024,
                  max_new_tokens=32)
SERVE_LENGTHS = [5, 37, 100, 250, 480, 700, 1100, 1500]


def _serve_requests(cfg):
    rng = np.random.RandomState(3)
    reqs = [dict(prompt=rng.randint(3, cfg.vocab_size, n).astype(np.int32),
                 max_new_tokens=32, stop_at_eos=False)
            for n in SERVE_LENGTHS]
    reqs.append(dict(prompt=rng.randint(3, cfg.vocab_size, 300)
                     .astype(np.int32), max_new_tokens=32, temperature=0.8,
                     seed=7, stop_at_eos=False))
    return reqs


def serve(phase, cfg, params, quant, dev):
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    eng = DecodeEngine(cfg, params, DecodeConfig(weight_quant=quant,
                                                 **SERVE_CONF), device=dev)
    t0 = time.perf_counter()
    built = eng.warmup()      # runs each (phase, bucket) once, captures it
    warm_s = time.perf_counter() - t0
    graphs = len(eng._graphs)
    reqs = _serve_requests(cfg)
    lengths = SERVE_LENGTHS
    kernels.reset_launch_counts()
    telemetry.reset()
    eng.start()
    try:
        t0 = time.perf_counter()
        handles = [eng.submit(**r) for r in reqs]
        together = [np.asarray(h.result(timeout=600)) for h in handles]
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        layouts = kernels.layout_counts()
        int8_instances = kernels.int8_instance_counts()
        stats = eng.stats()
        alone = [np.asarray(eng.generate(timeout=600, **r)) for r in reqs]
    finally:
        eng.close(drain=True, timeout=60)
    if not all(np.array_equal(a, b) for a, b in zip(together, alone)):
        raise AssertionError(f"{phase}: continuous != sequential")
    if any(len(t) != 32 for t in together):
        raise AssertionError(f"{phase}: short generation")
    if graphs != built or len(eng._graphs) != built:
        raise AssertionError(f"{phase}: {built} programs, {graphs} graphs "
                             f"after the warm-up, {len(eng._graphs)} after")
    need = ["flash_attention_fwd", "paged_attention"] + \
        (["int8_gemm"] if quant == "int8" else [])
    if any(launches[n] == 0 for n in need):
        raise AssertionError(f"{phase}: a kernel never launched: {launches}")
    # every int8 launch on the instance its M picks: prefill buckets of 64
    # tokens or more on "prefill", decode steps (M = 8 slots) and the
    # 8-token bucket on "decode"
    if sum(int8_instances.values()) != launches["int8_gemm"] or (
            quant == "int8" and not all(int8_instances.values())):
        raise AssertionError(f"{phase}: int8 launches by instance "
                             f"{int8_instances}, {launches['int8_gemm']} "
                             f"in all")
    tokens = sum(len(t) for t in together)
    emit(phase, requests=len(reqs), prompt_lengths=lengths + [300],
         tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
         prefill_ms_p50=stats["prefill_ms"]["p50"],
         step_ms_p50=stats["step_ms"]["p50"],
         steps=stats.get("steps"), programs_built=built, warmup_s=warm_s,
         graphs_captured=graphs,
         continuous_equals_sequential=True, launches=launches,
         int8_launches_by_instance=int8_instances,
         flash_launches_by_layout=layouts,
         kv_high_water_pages=stats["kv_cache"]["high_water_pages"])
    return dict(launches=launches, layouts=layouts,
                int8_instances=int8_instances,
                ids=[t.tolist() for t in together])


# the prefix phases' traffic: one shared system prompt of 64 pages, nine
# user suffixes (the last sampled), 32 new tokens each
PREFIX_SYSTEM = 1024
PREFIX_SUFFIXES = (5, 17, 40, 64, 100, 150, 220, 300, 120)


def _prefix_requests(cfg):
    rng = np.random.RandomState(5)
    system = rng.randint(3, cfg.vocab_size, PREFIX_SYSTEM)
    reqs = []
    for i, n in enumerate(PREFIX_SUFFIXES):
        r = dict(prompt=np.concatenate(
            [system, rng.randint(3, cfg.vocab_size, n)]).astype(np.int32),
            max_new_tokens=32, stop_at_eos=False)
        if i == len(PREFIX_SUFFIXES) - 1:
            r.update(temperature=0.8, seed=7, request_id="sampled-120")
        reqs.append(r)
    return reqs


def _first_divergence(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def serve_prefix(phase, cfg, params, quant, dev):
    """The prefix-sharing path at full width: DecodeConfig(prefix_cache=
    True, max_slots=8, page_size=16, kv_pages=1024, max_new_tokens=32).
    One 1024-token system prompt, nine suffixes (PREFIX_SUFFIXES; the
    last sampled at temperature 0.8, seed 7, journaled), 32 new tokens
    each; the first request alone (cold), the other eight together (each
    a hit on the 64 shared pages). Gates: kv.prefix_hits >= 8; the
    prefill tokens are the nine prompts' less 8 * 1024; no flash forward,
    paged attention launched, and in int8 every int8 GEMM on the decode
    instance (chunks of 16 tokens and steps of 8 slots); warm-up builds
    one graph more than the classic engine (the chunk program) and none
    is captured after it. Then each request alone after evicting every
    idle chain (cold again): its ids are the concurrent run's bit for bit
    and the pool's audit is clean. The sampled request resumed from its
    journal record at 16 tokens gives the same 32 ids. A classic engine
    (prefix cache off) gives the greedy ids, and ships the 300-token
    prompt's prefill: the shipment round-trips, a flipped byte is
    rejected, the pool's free pages come back, the shipped logits' argmax
    is that prompt's first greedy id."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.serving import (DecodeConfig, DecodeEngine,
                                          ShipmentCRCError, resume_args,
                                          unpack_shipment)

    t_phase = time.perf_counter()
    conf = dict(max_slots=8, page_size=16, kv_pages=1024, weight_quant=quant,
                max_new_tokens=32)
    eng = DecodeEngine(cfg, params, DecodeConfig(prefix_cache=True, **conf),
                       device=dev)
    t0 = time.perf_counter()
    built = eng.warmup()
    warm_s = time.perf_counter() - t0
    graphs = len(eng._graphs)
    classic_programs = len(eng.config.buckets) + \
        len(eng.config.prefill_buckets)
    reqs = _prefix_requests(cfg)
    journal = []
    eng.journal_sink = journal.extend
    kernels.reset_launch_counts()
    telemetry.reset()
    eng.start()
    try:
        t0 = time.perf_counter()
        first = eng.submit(**reqs[0])
        first.result(timeout=600)
        handles = [first] + [eng.submit(**r) for r in reqs[1:]]
        together = [np.asarray(h.result(timeout=600)) for h in handles]
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        layouts = kernels.layout_counts()
        int8_instances = kernels.int8_instance_counts()
        counters = telemetry.snapshot()["counters"]
        stats = eng.stats()
        hit_ms = [h.prefill_ms for h in handles[1:]]
        graphs_after = len(eng._graphs)
        eng.journal_sink = None
        # each request alone and cold: every idle chain evicted first
        alone, cold_ms = [], []
        for r in reqs:
            eng.prefix_store.reclaim(eng.config.kv_pages)
            h = eng.submit(**{k_: v_ for k_, v_ in r.items()
                              if k_ != "request_id"})
            alone.append(np.asarray(h.result(timeout=600)))
            cold_ms.append(h.prefill_ms)
        audit = eng.pool.audit(owned=eng.prefix_store.owned_pages())
        # the sampled session, resumed from its record at 16 tokens
        record = next(rec for rec in journal
                      if rec["request_id"] == "sampled-120"
                      and len(rec["accepted"]) == 16)
        args = resume_args(record)
        tail = np.asarray(eng.submit(args.pop("prompt_ids"), **args)
                          .result(timeout=600))
        resumed = np.concatenate([np.asarray(record["accepted"]), tail])
    finally:
        eng.close(drain=True, timeout=60)
    store_stats = eng.prefix_store.stats()
    del eng
    _release()

    lens = [int(r["prompt"].size) for r in reqs]
    problems = []
    if any(len(t) != 32 for t in together):
        problems.append("short generation")
    if counters.get("kv.prefix_hits", 0) < 8:
        problems.append(f"prefix hits {counters.get('kv.prefix_hits')}")
    want_tokens = sum(lens) - 8 * PREFIX_SYSTEM
    if counters.get("decode.prefill_tokens") != want_tokens:
        problems.append(f"prefill tokens "
                        f"{counters.get('decode.prefill_tokens')} != "
                        f"{want_tokens}")
    if launches["flash_attention_fwd"] != 0 or \
            launches["paged_attention"] == 0:
        problems.append(f"launches {launches}")
    if quant == "int8" and not (
            int8_instances["decode"] > 0
            and int8_instances["decode"] == launches["int8_gemm"]):
        problems.append(f"int8 launches by instance {int8_instances}")
    if built != classic_programs + 1 or graphs != built or \
            graphs_after != built:
        problems.append(f"{built} programs built ({classic_programs} "
                        f"classic), {graphs} graphs after the warm-up, "
                        f"{graphs_after} after the traffic")
    hit_eq_cold = [bool(np.array_equal(a, b))
                   for a, b in zip(together, alone)]
    if not all(hit_eq_cold):
        problems.append(f"hit != cold: {hit_eq_cold}")
    if audit:
        problems.append(f"pool audit: {audit}")
    session_ok = bool(np.array_equal(resumed, together[-1]))
    if not session_ok:
        problems.append("resumed session != uninterrupted")

    # the classic engine: greedy ids, prefill times and the shipment
    classic = DecodeEngine(cfg, params, DecodeConfig(**conf), device=dev)
    classic.warmup()
    classic.start()
    try:
        greedy = [dict(r) for r in reqs[:-1]]
        hs = [classic.submit(**r) for r in greedy]
        classic_ids = [np.asarray(h.result(timeout=600)) for h in hs]
        classic_ms = [h.prefill_ms for h in hs]
        free = classic.pool.free_pages()
        ship_prompt = reqs[7]["prompt"]                  # the 300 suffix
        blob = bytes(classic.submit_prefill(ship_prompt).result(timeout=600))
        free_after = classic.pool.free_pages()
        ship = unpack_shipment(blob)
        bad = bytearray(blob)
        bad[len(bad) // 2] ^= 0xFF
        try:
            unpack_shipment(bytes(bad))
            rejected = False
        except ShipmentCRCError:
            rejected = True
        divergences = {}
        for i, (a, b) in enumerate(zip(together[:-1], classic_ids)):
            step = _first_divergence(a, b)
            if step is None:
                continue
            # the classic engine's top-2 logit gap where they part
            seq = np.concatenate([reqs[i]["prompt"], b[:step]])
            lg = unpack_shipment(bytes(classic.submit_prefill(seq).result(
                timeout=600)))["logits"]
            top = np.sort(lg.astype(np.float64))[-2:]
            divergences[lens[i]] = dict(step=step,
                                        top2_gap=float(top[1] - top[0]))
    finally:
        classic.close(drain=True, timeout=60)
    del classic
    _release()
    if divergences:
        problems.append(f"chunked != classic: {divergences}")
    ship_ok = (rejected and free_after == free
               and ship["tokens"] == [int(t) for t in ship_prompt]
               and int(np.argmax(ship["logits"])) == int(together[7][0]))
    if not ship_ok:
        problems.append(f"shipment: rejected={rejected} free {free} -> "
                        f"{free_after}, argmax "
                        f"{int(np.argmax(ship['logits']))} vs "
                        f"{int(together[7][0])}")

    chunks = counters.get("decode.prefill_chunks", 0)
    tokens = sum(len(t) for t in together)
    cold_chunks = [-(-n // 16) for n in lens]
    emit(phase, requests=len(reqs), system_prompt=PREFIX_SYSTEM,
         suffixes=list(PREFIX_SUFFIXES), prompt_lengths=lens,
         tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
         prefill_ms_hit_p50=float(np.median(hit_ms)),
         prefill_ms_cold_first=handles[0].prefill_ms,
         prefill_ms_cold_p50=float(np.median(cold_ms)),
         prefill_ms_classic_p50=float(np.median(classic_ms)),
         prefill_ms_hit=hit_ms, prefill_ms_cold=cold_ms,
         prefill_ms_classic=classic_ms,
         chunk_ms_cold=[ms / c for ms, c in zip(cold_ms, cold_chunks)],
         chunks_per_prefill=chunks / len(reqs),
         prefill_tokens=counters.get("decode.prefill_tokens"),
         prefill_tokens_saved=sum(lens) - counters.get(
             "decode.prefill_tokens", 0),
         prefix_hits=counters.get("kv.prefix_hits"),
         kv_bytes_saved=counters.get("kv.bytes_saved"),
         step_ms_p50=stats["step_ms"]["p50"], steps=stats.get("steps"),
         programs_built=built, graphs_captured=graphs, warmup_s=warm_s,
         launches=launches, int8_launches_by_instance=int8_instances,
         hit_equals_cold=hit_eq_cold, chunked_equals_classic=not divergences,
         divergences=divergences, session_resume_equal=session_ok,
         shipment=dict(bytes=len(blob), n_pages=ship["n_pages"],
                       crc_rejected=rejected, free_pages=[free, free_after]),
         prefix_store=store_stats, pool_audit=audit,
         kv_high_water_pages=stats["kv_cache"]["high_water_pages"],
         seconds=time.perf_counter() - t_phase)
    if problems:
        raise AssertionError(f"{phase}: {problems}")
    return dict(launches=launches, layouts=layouts,
                int8_instances=int8_instances,
                ids=[t.tolist() for t in together])


# ---------------------------------------------------------------------------
# the HTTP serving plane: serve_decode, the router, the cluster controller
# ---------------------------------------------------------------------------

def _http(method, url, path, body=None, headers=None, timeout=600):
    """One HTTP exchange: (status, JSON doc or text); ``body`` a JSON
    document or its encoded bytes. Raises OSError when nothing answers."""
    import http.client
    import urllib.parse

    u = urllib.parse.urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    try:
        if body is not None and not isinstance(body, bytes):
            body = json.dumps(body).encode()
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        raw = resp.read()
    finally:
        conn.close()
    try:
        return resp.status, json.loads(raw)
    except ValueError:
        return resp.status, raw.decode("utf-8", "replace")


def _wire_body(r, **extra):
    """A request dict of the serve phases -> a /v1/generate body."""
    body = {"prompt_ids": [int(t) for t in r["prompt"]],
            "max_new_tokens": r["max_new_tokens"],
            "stop_at_eos": r["stop_at_eos"]}
    if r.get("temperature"):
        body.update(temperature=r["temperature"], seed=r["seed"])
    body.update(extra)
    return body


def _post_all(url, bodies, headers=None):
    """POST every body to /v1/generate at once, one thread each: the
    (status, doc) of each and each request's wall ms."""
    out = [None] * len(bodies)

    def one(i):
        t0 = time.perf_counter()
        code, doc = _http("POST", url, "/v1/generate", bodies[i],
                          headers=(headers or [None] * len(bodies))[i])
        out[i] = (code, doc, (time.perf_counter() - t0) * 1e3)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if any(t.is_alive() for t in threads) or None in out:
        raise AssertionError("an HTTP request never returned")
    return out


def _pct(values, q):
    s = sorted(values)
    return s[min(len(s) - 1, int(q * (len(s) - 1) + 0.5))]


def serve_http(phase, cfg, quant, dev, model_dir, want_ids):
    """serve_decode(model_dir, port=0) with the serve phases' DecodeConfig
    on the card; the serve phases' 9 requests POSTed at once to
    /v1/generate. Gates: every response's tokens are that serve phase's
    in-process ids bit for bit; /healthz 200 once serve_decode returns,
    503 (draining or stopped) once the engine is closed while the socket
    still answers; /metrics carries the decode counters; /v1/stats shows
    flash forward and paged attention launched (and in int8 the int8 GEMM,
    each launch on the instance its M picks); after shutdown a request is
    refused. A second server over the same dir with a pool of 64 pages
    (63 usable: 1008 tokens; warm-up off, so it runs no program) answers a
    1500-token prompt with 429 KVCacheExhaustedError. The request wall ms
    over HTTP sit beside the engine's prefill_ms and step_ms."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.serving import DecodeConfig, serve_decode

    t_phase = time.perf_counter()
    reqs = _serve_requests(cfg)
    problems = []
    t0 = time.perf_counter()
    srv = serve_decode(model_dir, port=0, device=dev, config=DecodeConfig(
        weight_quant=quant, **SERVE_CONF))
    up_s = time.perf_counter() - t0
    try:
        health_up = _http("GET", srv.url, "/healthz")
        if health_up[0] != 200 or health_up[1].get("status") != "ok":
            problems.append(f"/healthz after serve_decode: {health_up}")
        kernels.reset_launch_counts()
        telemetry.reset()
        t0 = time.perf_counter()
        answers = _post_all(srv.url, [_wire_body(r) for r in reqs])
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        layouts = kernels.layout_counts()
        int8_instances = kernels.int8_instance_counts()
        code, stats = _http("GET", srv.url, "/v1/stats")
        stats = stats["decode"]
        code_m, metrics = _http("GET", srv.url, "/metrics")
        srv.decode_engine.close(drain=True, timeout=60)
        health_closed = _http("GET", srv.url, "/healthz")
    finally:
        srv.decode_engine.close(drain=False, timeout=60)
        srv.shutdown()
    try:
        _http("POST", srv.url, "/v1/generate", _wire_body(reqs[0]),
              timeout=10)
        refused = False
    except OSError:
        refused = True
    small = serve_decode(model_dir, port=0, device=dev, warmup=False,
                         config=DecodeConfig(
                             weight_quant=quant, max_slots=8, page_size=16,
                             kv_pages=64, max_new_tokens=32))
    try:
        never_fits = _http("POST", small.url, "/v1/generate",
                           _wire_body(reqs[SERVE_LENGTHS.index(1500)]))
    finally:
        small.decode_engine.close(drain=False, timeout=60)
        small.shutdown()
    del srv, small
    _release()

    codes = [a[0] for a in answers]
    got = [a[1].get("tokens") if a[0] == 200 else None for a in answers]
    if codes != [200] * len(reqs) or got != want_ids:
        problems.append(f"ids over HTTP != in-process: codes {codes}, "
                        f"equal {[g == w for g, w in zip(got, want_ids)]}")
    if not (health_closed[0] == 503 and health_closed[1].get("status")
            in ("draining", "stopped")):
        problems.append(f"/healthz after close: {health_closed}")
    need_metrics = ("pt_decode_requests_total", "pt_decode_prefills_total",
                    "pt_decode_steps_total", "pt_decode_tokens_total")
    if code_m != 200 or not all(m in metrics for m in need_metrics):
        problems.append(f"/metrics lacks the decode counters ({code_m})")
    if not (never_fits[0] == 429 and never_fits[1].get("error_type")
            == "KVCacheExhaustedError"):
        problems.append(f"a request that never fits: {never_fits}")
    if not refused:
        problems.append("a request after shutdown was answered")
    need = ["flash_attention_fwd", "paged_attention"] + \
        (["int8_gemm"] if quant == "int8" else [])
    if stats["kernels"] != launches or any(launches[n] == 0 for n in need):
        problems.append(f"/v1/stats kernels {stats['kernels']}, counters "
                        f"{launches}")
    if sum(int8_instances.values()) != launches["int8_gemm"] or (
            quant == "int8" and not all(int8_instances.values())) or \
            stats["int8_instances"] != int8_instances:
        problems.append(f"int8 launches by instance {int8_instances} "
                        f"(/v1/stats {stats['int8_instances']})")
    ms = [a[2] for a in answers]
    emit(phase, requests=len(reqs), codes=codes, ids_equal_in_process=
         got == want_ids, wall_s=wall, serve_decode_s=up_s,
         request_ms_p50=_pct(ms, 0.5), request_ms_p99=_pct(ms, 0.99),
         request_ms=ms, prefill_ms_p50=stats["prefill_ms"]["p50"],
         step_ms_p50=stats["step_ms"]["p50"],
         request_ms_engine_p50=stats["request_ms"]["p50"],
         healthz=[health_up[0], health_closed[0],
                  health_closed[1].get("status")],
         never_fits=[never_fits[0], never_fits[1].get("error_type")],
         refused_after_shutdown=refused, launches=launches,
         int8_launches_by_instance=int8_instances,
         flash_launches_by_layout=layouts,
         seconds=time.perf_counter() - t_phase)
    if problems:
        raise AssertionError(f"{phase}: {problems}")
    return dict(launches=launches, layouts=layouts,
                int8_instances=int8_instances)


def _replica_counts(cluster):
    """Each replica's launch counters from its /v1/stats: {name: (kernels,
    flash layouts)}."""
    out = {}
    for r in cluster.replicas:
        code, doc = _http("GET", r.url, "/v1/stats", timeout=60)
        if code != 200:
            raise AssertionError(f"/v1/stats of {r.name}: {code} {doc}")
        d = doc["decode"]
        out[r.name] = d
    return out


def _count_delta(before, after):
    """Launches between two /v1/stats reads of each replica, summed:
    (kernels, flash layouts)."""
    from paddle_tpu_torch import kernels as _k

    launches = {n: 0 for n in _k.MODULES}
    layouts = {"flash_attention_fwd": {"packed": 0, "bnsd": 0},
               "flash_attention_bwd": {"packed": 0, "bnsd": 0}}
    for name, a in after.items():
        b = before[name]
        for n in launches:
            launches[n] += a["kernels"][n] - b["kernels"][n]
        for n, split in layouts.items():
            for k in split:
                split[k] += (a["kernel_layouts"][n].get(k, 0)
                             - b["kernel_layouts"][n].get(k, 0))
    return launches, layouts


def _replica_env(**flags):
    import os

    env = dict(os.environ)
    env.update({f"FLAGS_{k}": str(v) for k, v in flags.items()})
    return env


def serve_cluster(cfg, dev, model_dir, prefix_ids, serve_ids):
    """Two ClusterControllers of process replicas (python -m
    paddle_tpu_torch.serving.replica --device cuda), fp32, the serve
    phases' DecodeConfig through FLAGS_decode_*.

    decode2: {"decode": 2}, prefix cache on, 30 ms before each decode
    step. serve_prefix's traffic through the router (the first request
    alone, the other eight at once, then one more prompt: the system
    prompt and 9 tokens): ids = serve_prefix_fp32's bit for bit. Affinity
    is the reference's: the router hashes the chain of ALL of a prompt's
    full pages, so the requests whose full pages are the system prompt's
    alone (suffixes of 5 and 9 tokens) land on one replica, and the
    others wherever their own chain hashes; every request lands where
    pick_generate says, and on each replica every request after its
    first hits the shared system pages (prefix hits >= requests - 1).
    Dedup: the first request's X-Request-Id again replays (deduped,
    router.dedup_hits + 1, no new prefill on either replica). Failover:
    the sampled request under a new id, its replica SIGKILLed once the
    journal holds 3 accepted tokens: the merged ids = the uninterrupted
    ones, failed_over, session.failovers >= 1; the monitor respawns the
    slot as a decode replica.

    tiers: {"prefill": 1, "decode": 1}, the serve phases' 9 requests at
    once: ids = serve_fp32's; router.prefill_forwards >= 9; between
    /v1/stats reads before and after the traffic the decode replica
    launches no flash forward and the prefill replica 12 a request. Then
    an in-process decode-role engine whose prefill URL is dead: every
    request falls back to a local prefill (disagg.fallback_prefills = 9),
    ids = serve_fp32's."""
    import signal

    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.serving import (ClusterController, DecodeConfig,
                                          decode_engine_from_dir,
                                          prefix_chain_hash)

    runs, problems = {}, {}
    flags = dict(decode_max_slots=SERVE_CONF["max_slots"],
                 decode_page_size=SERVE_CONF["page_size"],
                 decode_kv_pages=SERVE_CONF["kv_pages"],
                 decode_max_new_tokens=SERVE_CONF["max_new_tokens"],
                 decode_weight_quant="none")

    # -- leg 1: two decode replicas, prefix cache, failover --------------
    t_leg = time.perf_counter()
    problems["serve_cluster_decode2"] = bad = []
    preqs = _prefix_requests(cfg)
    extra = dict(preqs[0], prompt=np.concatenate(
        [preqs[0]["prompt"][:PREFIX_SYSTEM],
         np.random.RandomState(6).randint(3, cfg.vocab_size, 9)]).astype(
             np.int32))
    telemetry.reset()
    t0 = time.perf_counter()
    cluster = ClusterController(
        "", decode_model_dir=model_dir, role_counts={"decode": 2},
        prefix_cache=True, device=dev.type, replica_ready_timeout_s=600,
        replica_env=_replica_env(decode_step_delay_ms=30, **flags)).start(
            ready_timeout_s=600)
    up_s = time.perf_counter() - t0
    try:
        before = _replica_counts(cluster)
        bodies = [_wire_body(r) for r in preqs]
        rids = [f"prefix-{i}" for i in range(len(preqs))]
        t0 = time.perf_counter()
        first = _post_all(cluster.url, bodies[:1], [{"X-Request-Id":
                                                     rids[0]}])
        rest = _post_all(cluster.url, bodies[1:],
                         [{"X-Request-Id": r} for r in rids[1:]])
        wall = time.perf_counter() - t0
        answers = first + rest + _post_all(cluster.url, [_wire_body(extra)])
        after = _replica_counts(cluster)
        launches, layouts = _count_delta(before, after)
        replicas = [a[1].get("replica") for a in answers]
        got = [a[1].get("tokens") for a in answers]
        if got[:-1] != prefix_ids or len(got[-1] or ()) != 32:
            bad.append(f"ids through the router != serve_prefix: "
                       f"{[g == w for g, w in zip(got, prefix_ids)]}")
        hits = {n: d.get("prefix_store", {}).get("prefix_hits", 0)
                - before[n].get("prefix_store", {}).get("prefix_hits", 0)
                for n, d in after.items()}
        chains = [prefix_chain_hash(r["prompt"], SERVE_CONF["page_size"])
                  for r in preqs + [extra]]
        predicted = [cluster.router.pick_generate(r["prompt"]).name
                     for r in preqs + [extra]]
        system_only = {replicas[i] for i, c in enumerate(chains)
                       if c == chains[-1]}
        affinity_ok = (replicas == predicted and len(system_only) == 1
                       and chains[0] == chains[-1]
                       and all(hits.get(n, 0) >= replicas.count(n) - 1
                               for n in set(replicas)))
        if not affinity_ok:
            bad.append(f"affinity: replicas {replicas}, predicted "
                       f"{predicted}, hits {hits}")
        # dedup: the first request's id again
        dedup0 = telemetry.counter_get("router.dedup_hits")
        prefills0 = sum(d.get("prefills", 0) for d in after.values())
        code, again = _http("POST", cluster.url, "/v1/generate", bodies[0],
                            headers={"X-Request-Id": rids[0]})
        prefills1 = sum(d.get("prefills", 0) for d in
                        _replica_counts(cluster).values())
        dedup_ok = (code == 200 and again.get("deduped") is True
                    and again.get("tokens") == got[0]
                    and telemetry.counter_get("router.dedup_hits")
                    - dedup0 == 1 and prefills1 == prefills0)
        if not dedup_ok:
            bad.append(f"dedup: {code}, prefills {prefills0} -> "
                            f"{prefills1}")
        # failover: the sampled request, its replica killed mid-generation
        failovers0 = telemetry.counter_get("session.failovers")
        result = {}
        sampled = dict(bodies[-1], request_id="failover-1")
        client = threading.Thread(target=lambda: result.update(
            _http("POST", cluster.url, "/v1/generate", sampled)[1]))
        client.start()
        victim = None
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and client.is_alive():
            rec = cluster.router.sessions.get("failover-1")
            if rec and len(rec["accepted"]) >= 3:
                handle = cluster.router.pick_generate(sampled["prompt_ids"])
                victim = cluster.replica_named(handle.name)
                killed_at = len(rec["accepted"])
                victim.kill(signal.SIGKILL)
                break
            time.sleep(0.005)
        client.join(timeout=600)
        failover_ok = (victim is not None and not client.is_alive()
                       and result.get("tokens") == prefix_ids[-1]
                       and result.get("failed_over") is True
                       and telemetry.counter_get("session.failovers")
                       - failovers0 >= 1)
        if not failover_ok:
            bad.append(f"failover: victim {victim and victim.name}, "
                            f"result {str(result)[:300]}")
        t0 = time.perf_counter()
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            members = cluster.tier_members("decode")
            if victim not in members and all(r.alive() for r in members) \
                    and all(h.ready for h in cluster.router.handles()):
                break
            time.sleep(0.1)
            for h in cluster.router.handles():
                cluster.router.probe(h)
        respawn_s = time.perf_counter() - t0
        members = cluster.tier_members("decode")
        respawned = (victim not in members and len(members) == 2
                     and {r.role for r in members} == {"decode"}
                     and all(h.ready for h in cluster.router.handles()))
        if not respawned:
            bad.append(f"respawn: {[(r.name, r.role, r.alive())
                                         for r in members]}")
        rstats = cluster.router.stats()
    finally:
        cluster.close()
    if launches["paged_attention"] == 0 or \
            launches["flash_attention_fwd"] != 0:
        bad.append(f"launches {launches}")
    ms = [a[2] for a in answers]
    emit("serve_cluster_decode2", replicas=2, start_s=up_s, wall_s=wall,
         request_ms_p50=_pct(ms, 0.5), request_ms_p99=_pct(ms, 0.99),
         request_ms=ms, ids_equal_serve_prefix=got[:-1] == prefix_ids,
         replicas_used=replicas, replicas_predicted=predicted,
         affinity=affinity_ok, prefix_hits=hits, dedup=dedup_ok,
         failover=failover_ok, killed_at_tokens=victim and killed_at,
         respawn_s=respawn_s, respawned=respawned,
         router={k: rstats.get(k) for k in (
             "requests", "retries", "dispatch_errors", "dedup_hits",
             "replica_deaths", "replica_restarts", "affinity_remaps")},
         session_failovers=telemetry.counter_get("session.failovers"),
         launches=launches, flash_launches_by_layout=layouts,
         seconds=time.perf_counter() - t_leg)
    runs["serve_cluster_decode2"] = dict(launches=launches, layouts=layouts)
    _release()

    # -- leg 2: a prefill tier and a decode tier --------------------------
    t_leg = time.perf_counter()
    problems["serve_cluster_tiers"] = bad = []
    sreqs = _serve_requests(cfg)
    telemetry.reset()
    t0 = time.perf_counter()
    cluster = ClusterController(
        "", decode_model_dir=model_dir,
        role_counts={"prefill": 1, "decode": 1}, device=dev.type,
        replica_ready_timeout_s=600,
        replica_env=_replica_env(**flags)).start(ready_timeout_s=600)
    up_s = time.perf_counter() - t0
    try:
        roles = {r.name: r.role for r in cluster.replicas}
        before = _replica_counts(cluster)
        t0 = time.perf_counter()
        answers = _post_all(cluster.url, [_wire_body(r) for r in sreqs])
        wall = time.perf_counter() - t0
        after = _replica_counts(cluster)
        forwards = telemetry.counter_get("router.prefill_forwards")
    finally:
        cluster.close()
    launches, layouts = _count_delta(before, after)
    flash = {roles[n]: after[n]["kernels"]["flash_attention_fwd"]
             - before[n]["kernels"]["flash_attention_fwd"] for n in after}
    installs = {roles[n]: after[n].get("disagg", {}).get("installs", 0)
                - before[n].get("disagg", {}).get("installs", 0)
                for n in after}
    got = [a[1].get("tokens") for a in answers]
    if got != serve_ids:
        bad.append(f"ids behind a prefill tier != serve_fp32: "
                        f"{[g == w for g, w in zip(got, serve_ids)]}")
    if forwards < len(sreqs) or installs["decode"] != len(sreqs):
        bad.append(f"prefill forwards {forwards}, installs {installs}")
    if flash != {"decode": 0, "prefill": cfg.n_layers * len(sreqs)}:
        bad.append(f"flash forward launches by tier {flash}")
    if launches["paged_attention"] == 0:
        bad.append(f"launches {launches}")
    ms = [a[2] for a in answers]
    tiers = dict(start_s=up_s, wall_s=wall, request_ms_p50=_pct(ms, 0.5),
                 request_ms_p99=_pct(ms, 0.99), request_ms=ms,
                 ids_equal_serve=got == serve_ids, prefill_forwards=forwards,
                 installs=installs, flash_launches_by_tier=flash,
                 decode_tier_prefill_ms_p50=next(
                     after[n].get("prefill_ms", {}).get("p50")
                     for n in after if roles[n] == "decode"),
                 prefill_tier_prefill_ms_p50=next(
                     after[n].get("prefill_ms", {}).get("p50")
                     for n in after if roles[n] == "prefill"),
                 launches=launches, flash_launches_by_layout=layouts)
    runs["serve_cluster_tiers"] = dict(launches=launches, layouts=layouts)
    _release()

    # a dead prefill URL: every request falls back to a local prefill
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        dead = f"http://127.0.0.1:{sock.getsockname()[1]}"
    eng = decode_engine_from_dir(model_dir, device=dev, config=DecodeConfig(
        role="decode", prefill_urls=dead, **SERVE_CONF))
    eng.start(warmup=True)
    try:
        fallbacks0 = telemetry.counter_get("disagg.fallback_prefills")
        hs = [eng.submit(**r) for r in sreqs]
        dead_ids = [h.result(timeout=600).tolist() for h in hs]
        fallbacks = telemetry.counter_get("disagg.fallback_prefills") - \
            fallbacks0
    finally:
        eng.close(drain=True, timeout=60)
    del eng
    _release()
    if fallbacks != len(sreqs) or dead_ids != serve_ids:
        bad.append(f"dead prefill URL: {fallbacks} fallbacks, ids "
                        f"equal {dead_ids == serve_ids}")
    emit("serve_cluster_tiers", **tiers, dead_url_fallbacks=fallbacks,
         dead_url_ids_equal=dead_ids == serve_ids,
         seconds=time.perf_counter() - t_leg)
    if any(problems.values()):
        raise AssertionError(f"serve_cluster: {problems}")
    return runs


# ---------------------------------------------------------------------------
# 4. card vs CPU at full width
# ---------------------------------------------------------------------------

def cpu_parity(cfg, params, dev, quant="none"):
    """One request at full width, prefill (bucket 128) + 8 steps, on the
    card and on the CPU: logits within rtol = atol = 1e-4 and the same
    top-5 ids at every step. quant="int8" quantizes the weights first (the
    int8 GEMM's two instances on the card: prefill at M = 128, decode at
    M = 1), the leg that shows the three bf16 pieces keep fp32 accuracy."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.executor import run_block
    from paddle_tpu_torch.models.decoder_lm import (build_prefill_program,
                                                    build_step_program,
                                                    params_from_numpy,
                                                    quantize_decoder_lm_params)

    if quant == "int8":
        params = quantize_decoder_lm_params(params, cfg)
    pages, page = 16, 16
    mp = cfg.max_seq_len // page
    prompt = np.random.RandomState(4).randint(3, cfg.vocab_size, 100)
    bucket = 128
    prefill = build_prefill_program(cfg, 1, bucket, pages, page,
                                    weight_quant=quant)[0]
    step = build_step_program(cfg, 1, pages, page, weight_quant=quant)[0]
    table = np.zeros((1, mp), np.int32)
    table[0, :8] = np.arange(1, 9)
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :100] = prompt
    oh = np.zeros((1, bucket), np.float32)
    oh[0, 99] = 1.0
    runs = {}
    for device in (dev, torch.device("cpu")):
        p = params_from_numpy(params, device)
        pools = {f"kv_{kv}_{i}": torch.zeros(pages, page, cfg.d_model,
                                             device=device)
                 for i in range(cfg.n_layers) for kv in "kv"}

        def run(block, feed):
            env = dict(p, **pools)
            env.update({n: torch.from_numpy(v).to(device)
                        for n, v in feed.items()})
            run_block(block, env)
            pools.update({n: env[n + "_out"] for n in list(pools)})
            return env["logits"].cpu()

        kernels.reset_launch_counts()
        logits = [run(prefill.global_block(),
                      {"tokens": tokens, "lengths": np.array([100], np.int32),
                       "last_onehot": oh, "page_table": table})]
        for i in range(8):
            logits.append(run(step.global_block(), {
                "tokens": np.array([int(logits[-1].argmax())], np.int32),
                "positions": np.array([100 + i], np.int32),
                "page_table": table}))
        lg = torch.stack(logits).reshape(9, -1)
        runs[device.type] = (lg, lg.topk(5).indices.tolist(),
                             kernels.int8_instance_counts())
    (lg, top_gpu, inst), (lc, top_cpu, _) = runs["cuda"], runs["cpu"]
    err = float((lg - lc).abs().max())
    ok = torch.allclose(lg, lc, rtol=1e-4, atol=1e-4) and top_gpu == top_cpu
    if quant == "int8":   # 72 GEMMs a pass: 1 prefill, 8 steps
        ok = ok and inst == {"prefill": 72, "decode": 8 * 72}
    phase = "cpu_parity" if quant == "none" else f"cpu_parity_{quant}"
    emit(phase, prompt_len=100, steps=8, max_abs_err=err,
         max_abs_logit=float(lc.abs().max()), tolerance="rtol=atol=1e-4",
         top5_ids_gpu=top_gpu, top5_ids_cpu=top_cpu,
         int8_launches_by_instance=inst, ok=ok)
    if not ok:
        raise AssertionError(f"{phase}: card and CPU disagree at full "
                             f"width")


# ---------------------------------------------------------------------------
# 5, 6. training at full width
# ---------------------------------------------------------------------------

def _preds(seq):
    return MAX_PREDS if seq == SEQ else max(80, seq * 15 // 100)


def _ernie_programs(layers, dtype, seq=SEQ):
    """ERNIE at full width; above 512 with the position table widened to
    the sequence, as the long-context benchmark configures it."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig(num_hidden_layers=layers, dtype=dtype,
                          use_flash_attention=True,
                          max_position_embeddings=max(512, seq), **ERNIE)
    with unique_name.guard():
        main_prog, startup, _, fetches = bert.build_pretraining_program(
            cfg, seq_len=seq, optimizer_name="adamw",
            max_predictions_per_seq=_preds(seq))
    return cfg, main_prog, startup, fetches


def _state_arrays(scope):
    """A scope's state as scope_from_numpy takes it (bf16 as uint16 bits)."""
    out = {}
    for name, val in scope.items():
        if isinstance(val, torch.Tensor) and val.dtype == torch.bfloat16:
            val = (val.view(torch.int16).numpy().view(np.uint16), "bfloat16")
        elif isinstance(val, torch.Tensor):
            val = val.numpy()
        out[name] = val
    return out


def train_parity(dev, layers, dtype, steps, tol, seq=SEQ, batch_size=2):
    """``steps`` steps of ERNIE at full width, ``layers`` deep, on the card
    and on the CPU from one state and on one batch: the same dropout masks
    bit for bit, losses within rtol = atol = ``tol``."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import bert

    cfg, main_prog, startup, fetches = _ernie_programs(layers, dtype, seq)
    scope = Scope()
    Executor(device="cpu").run(startup, scope=scope)
    state = _state_arrays(scope)
    batch = bert.synthetic_pretraining_batch(
        cfg, batch_size, seq, seed=2, max_predictions_per_seq=_preds(seq))
    ops = main_prog.global_block().ops
    masks = [o.outputs["Mask"][0] for o in ops if o.type == "dropout"]
    runs, counts, layouts, dtypes, seconds = {}, {}, {}, {}, {}
    for device in (dev, torch.device("cpu")):
        sc = bert.scope_from_numpy(state, device)
        exe = Executor(device=device)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        runs[device.type] = [exe.run(main_prog, feed=batch, scope=sc,
                                     fetch_list=[fetches["loss"]] + masks)
                             for _ in range(steps)]
        seconds[device.type] = time.perf_counter() - t0
        counts[device.type] = kernels.launch_counts()
        layouts[device.type] = kernels.layout_counts()
        dtypes[device.type] = kernels.dtype_counts()
    loss_gpu = [float(r[0].reshape(-1)[0]) for r in runs["cuda"]]
    loss_cpu = [float(r[0].reshape(-1)[0]) for r in runs["cpu"]]
    masks_equal = all(np.array_equal(x, y)
                      for a, b in zip(runs["cuda"], runs["cpu"])
                      for x, y in zip(a[1:], b[1:]))
    ok = masks_equal and np.allclose(loss_gpu, loss_cpu, rtol=tol, atol=tol)
    per_step = {k: v / steps for k, v in counts["cuda"].items() if v}
    emit("train_parity", layers=layers, batch=batch_size, seq=seq,
         dtype=dtype,
         steps=steps, loss_gpu=loss_gpu, loss_cpu=loss_cpu,
         dropout_masks=len(masks), masks_bitwise_equal=masks_equal,
         tolerance=f"rtol=atol={tol}", launches_per_step=per_step,
         flash_launches_by_dtype=dtypes["cuda"], seconds=seconds,
         ok=bool(ok))
    if not ok:
        raise AssertionError("training: card and CPU disagree")
    if any(counts["cpu"].values()):
        raise AssertionError("a CPU run launched a kernel")
    n_adamw = sum(o.type == "adamw" for o in ops)
    if per_step != {"flash_attention_fwd": layers,
                    "flash_attention_bwd": layers, "fused_adamw": n_adamw}:
        raise AssertionError(f"train_parity: launches per step {per_step}")
    # every flash launch ran the dtype's instance (fp32: split TF32)
    instance = "bf16_wgmma" if dtype == "bfloat16" else "fp32_tf32x3"
    for name, split in dtypes["cuda"].items():
        if split[instance] != counts["cuda"][name]:
            raise AssertionError(f"train_parity: {name} by instance {split}")
    return dict(launches=counts["cuda"], layouts=layouts["cuda"],
                dtypes=dtypes["cuda"])


def _ln_variance_cost(exe, main_prog, batch, scope, fetches, steps=6):
    """Step ms of the ERNIE-large step with the layer_norm lowering as it
    is (Variance as one torch.var over the normalised axes, the mean of
    squared deviations the reference computes) and with Variance recovered
    from native_layer_norm's rstd as 1 / rstd^2 - eps, one op fewer a
    layer norm (about 100 a step, with the forwards __vjp_grad__ re-runs).
    The steps alternate with, without, without, with, ... in one process
    on one batch, op by op (a graph replay would not see the swap);
    medians of each."""
    from paddle_tpu_torch.core import registry

    od = registry.get("layer_norm")
    with_var = od.forward

    def without_var(ins, attrs):
        x = ins["X"][0]
        eps = attrs.get("epsilon", 1e-5)
        axis = int(attrs.get("begin_norm_axis", 1))
        norm_shape, lead = tuple(x.shape[axis:]), tuple(x.shape[:axis])
        scale = ins["Scale"][0] if ins.get("Scale") else None
        bias = ins["Bias"][0] if ins.get("Bias") else None
        y, mean, rstd = torch.native_layer_norm(
            x.float(), norm_shape,
            None if scale is None else scale.reshape(norm_shape).float(),
            None if bias is None else bias.reshape(norm_shape).float(), eps)
        return {"Y": y.to(x.dtype), "Mean": mean.reshape(lead),
                "Variance": (1.0 / (rstd * rstd) - eps).reshape(lead)}

    ms = {"with_var": [], "without_var": []}
    try:
        for i in range(2 * steps):
            key = "with_var" if i % 4 in (0, 3) else "without_var"
            od.forward = with_var if key == "with_var" else without_var
            t0 = time.perf_counter()
            exe.run(main_prog, feed=batch, scope=scope,
                    fetch_list=[fetches["loss"]], use_compiled=False)
            torch.cuda.synchronize()
            ms[key].append((time.perf_counter() - t0) * 1e3)
    finally:
        od.forward = with_var
    return {k: dict(step_ms=v, step_ms_p50=float(np.median(v)))
            for k, v in ms.items()}


def _loss(out):
    return float(np.asarray(out[0], np.float32).reshape(-1)[0])


def _check_legs(phase, modes, first=1):
    """Each leg of ``profile_train.timed_modes`` held to its own start
    (both start from one state): finite losses, the last below the lowest
    of the leg's first ``first``; and the port's flash and AdamW kernels
    found by name in the leg's traced step as often as its launch
    counters give for a step. A replay adds the counts its capture
    recorded, so only the trace shows that a graph ran the kernels."""
    for m, r in modes.items():
        losses = r["losses"]
        if not all(np.isfinite(losses)) or \
                not losses[-1] < min(losses[:first]):
            raise AssertionError(f"{phase} ({m}): loss did not fall: "
                                 f"{losses}")
        want = {k: r["launches_per_step"].get(k, 0)
                for k in r["traced_launches"]}
        if r["traced_launches"] != want:
            raise AssertionError(f"{phase} ({m}): kernels in the traced "
                                 f"step {r['traced_launches']}, launch "
                                 f"counters {want}")


def _per_mode(modes):
    return {m: {k: v for k, v in r.items()
                if k not in ("launches", "layouts", "dtypes")}
            for m, r in modes.items()}


def train_ernie(dev, smi, phase="train_ernie", seq=SEQ,
                batches=(40, 32, 24, 16, 8), timed=8):
    """ERNIE-large, 24 layers, bf16: startup, one warm-up step, then
    profile_train.timed_modes (``timed`` timed steps op by op and
    ``timed`` compiled, each leg from the warm-up's state) on one batch,
    at the first batch size of ``batches`` that fits."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.tools.profile_train import timed_modes

    layers = 24
    cfg, main_prog, startup, fetches = _ernie_programs(layers, "bfloat16",
                                                       seq)
    ops = main_prog.global_block().ops
    n_adamw = sum(o.type == "adamw" for o in ops)
    exe = Executor(device=dev)
    tried = []
    for batch_size in batches:
        scope = Scope()
        t0 = time.perf_counter()
        exe.run(startup, scope=scope)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        batch = bert.synthetic_pretraining_batch(
            cfg, batch_size, seq, seed=0,
            max_predictions_per_seq=_preds(seq))
        try:
            warm = exe.run(main_prog, feed=batch, scope=scope,
                           fetch_list=[fetches["loss"]], use_compiled=False)
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError as e:
            # the one failure this phase answers: take the next batch size
            tried.append(dict(batch=batch_size, why=str(e).split(".")[0]))
            del scope
            torch.cuda.empty_cache()
    else:
        raise AssertionError(f"{phase}: no batch size fits: {tried}")
    modes = timed_modes(exe, main_prog, batch, scope, [fetches["loss"]],
                        timed)
    comp = modes["compiled"]
    counts, layouts, dtypes = comp["launches"], comp["layouts"], \
        comp["dtypes"]
    params = [scope.find_var(p.name) for p in main_prog.all_parameters()]
    finite = all(bool(torch.isfinite(p.float()).all()) for p in params)
    want = {"flash_attention_fwd": layers, "flash_attention_bwd": layers,
            "fused_adamw": n_adamw}
    peak_ratio = comp["max_memory_allocated"] / \
        modes["eager"]["max_memory_allocated"]
    emit(phase, model="ernie_large", layers=layers, dtype="bfloat16",
         seq=seq, max_predictions=_preds(seq), batch=batch_size,
         batches_that_did_not_fit=tried, ops=len(ops),
         op_types=len({o.type for o in ops}), parameters=len(params),
         parameter_elements=int(sum(p.numel() for p in params)),
         startup_s=startup_s, warmup_loss=_loss(warm),
         modes=_per_mode(modes), step_ms_p50=comp["step_ms_p50"],
         tokens_per_s=batch_size * seq / (comp["step_ms_p50"] / 1e3),
         compiled_over_eager_peak_memory=peak_ratio,
         flash_launches_by_layout=layouts, flash_launches_by_dtype=dtypes,
         params_finite=finite, nvidia_smi=smi,
         note="step ms on the host clock, one synthetic batch; smoke "
              "figures, not a benchmark")
    # one batch every step, each leg from the warm-up's state: its last
    # loss lies below its first's, which no update of the leg preceded,
    # and at S = 512 below its second's too
    _check_legs(phase, modes, first=2 if seq == SEQ else 1)
    for m, r in modes.items():
        if r["launches_per_step"] != want or n_adamw != 398:
            raise AssertionError(f"{phase} ({m}): launches per step "
                                 f"{r['launches_per_step']}, {n_adamw} "
                                 f"adamw ops")
    # every flash launch of the step ran the bf16 tensor-core instance
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        if dtypes[name] != {"fp32_tf32x3": 0, "bf16_wgmma": counts[name]}:
            raise AssertionError(f"{phase}: {name} launches by instance "
                                 f"{dtypes[name]}")
    if not finite:
        raise AssertionError(f"{phase}: a parameter is not finite")
    if seq == SEQ and peak_ratio > 1.10:
        raise AssertionError(f"{phase}: the compiled step's peak memory is "
                             f"{peak_ratio:.3f} of the op-by-op step's")
    if seq == SEQ:
        emit("layer_norm_variance_cost", model="ernie_large", seq=seq,
             batch=batch_size, layer_norm_ops=sum(
                 o.type == "layer_norm" for o in ops),
             **_ln_variance_cost(exe, main_prog, batch, scope, fetches),
             nvidia_smi=smi,
             note="host-clock step times; the host differs step to step")
    exe.close()
    return dict(launches=counts, layouts=layouts, dtypes=dtypes)


# train_ernie_fleet: LAMB's rate (the trust ratio makes it each layer's
# relative step), the loss scale the AMP strategy starts from, and the
# tolerances of recompute against no recompute: gradients relative to a
# tensor's largest magnitude, parameters after the step absolute. Autograd
# may sum a var's gradient contributions in another order than the
# program's sum ops, so the gate is not bit for bit (the first card run
# read 0.0 for both)
FLEET_LR, FLEET_SCALE = 1e-3, 32768.0
# the depth of the phase's program: 24, ERNIE-large's, until the script's
# later phases needed the time (a slow host ended the whole run at 1177 s
# of its 1200)
FLEET_LAYERS = 12
FLEET_GRAD_TOL, FLEET_PARAM_TOL = 1e-3, 1e-5
# the overflow schedule: the loss scale written before each step (None:
# as the last step left it); inf makes every gradient non-finite
FLEET_OVERFLOW = (None, None, float("inf"), None, FLEET_SCALE, None)
FLEET_SCALING = ("loss_scaling_0", "good_steps_0", "bad_steps_0")


def _ernie_fleet_programs(layers, recompute=True, seq=SEQ):
    """ERNIE at full width, ``layers`` deep, fp32 with flash attention,
    built without its optimizer (``with_optimizer=False``) and trained
    through ``fleet.distributed_optimizer``: LambOptimizer (FLEET_LR,
    lamb_weight_decay 0.01, ClipGradByGlobalNorm(1.0)), AMP (the bf16
    rewrite, dynamic loss scaling from FLEET_SCALE), recompute with one
    checkpoint per encoder layer (its output; with ``recompute``) and the
    LAMB strategy."""
    from paddle_tpu_torch.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.ir import program_guard
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.optimizer import LambOptimizer

    cfg = bert.BertConfig(num_hidden_layers=layers, dtype="float32",
                          use_flash_attention=True, **ERNIE)
    with unique_name.guard():
        main_prog, startup, _, fetches = bert.build_pretraining_program(
            cfg, seq_len=seq, with_optimizer=False,
            max_predictions_per_seq=_preds(seq))
        with program_guard(main_prog, startup):
            strategy = fleet.DistributedStrategy()
            strategy.amp = True
            strategy.amp_configs = dict(
                strategy.amp_configs, init_loss_scaling=FLEET_SCALE,
                use_dynamic_loss_scaling=True)
            strategy.recompute = recompute
            strategy.recompute_configs = {
                "checkpoints": bert.encoder_checkpoints(main_prog)}
            strategy.lamb = True
            opt = LambOptimizer(FLEET_LR, lamb_weight_decay=0.01,
                                grad_clip=ClipGradByGlobalNorm(1.0))
            fleet.distributed_optimizer(opt, strategy).minimize(
                fetches["loss"])
    return cfg, main_prog, startup, fetches


class _AttnSeeds:
    """Within the block, every seed a flash_attention op draws its
    attention dropout with: (build-time seed attr, whether autograd
    records, the seed: an int op by op, a seed-table slot in a compiled
    step). Autograd records in a block_call's recompute, not in its
    forward."""

    def __enter__(self):
        from paddle_tpu_torch.ops import attention_ops

        self.mod, self.orig, self.calls = attention_ops, \
            attention_ops._attn_dropout, []

        def record(attrs):
            rate, seed = self.orig(attrs)
            self.calls.append((attrs.get("seed"), torch.is_grad_enabled(),
                               seed))
            return rate, seed

        attention_ops._attn_dropout = record
        return self

    def __exit__(self, *exc):
        self.mod._attn_dropout = self.orig

    def of(self, build_seed):
        """(the forward's seed, the recompute's) of one op."""
        fwd = [s for b, g, s in self.calls if b == build_seed and not g]
        rec = [s for b, g, s in self.calls if b == build_seed and g]
        if len(fwd) != 1 or len(rec) != 1:
            raise AssertionError(f"train_ernie_fleet: op seed {build_seed} "
                                 f"drew {len(fwd)} forward and {len(rec)} "
                                 f"recompute seeds")
        return fwd[0], rec[0]


def _keep_mask(fa, dev, seed, b, s, n, hd=64):
    """The flash forward kernel's attention-dropout keep mask [b, n, s, s]
    at rate RATE for ``seed`` (an int or a device int64), read back
    exactly as _mask_readback reads it: q = k = 0 gives every key a
    positive probability, and v one-hot over a 64-key chunk makes
    out[q, d] nonzero exactly where keep(q, chunk + d)."""
    zero = torch.zeros(b, s, n * hd, device=dev, dtype=torch.bfloat16)
    eye = torch.eye(hd, device=dev, dtype=torch.bfloat16)[None, :, None]
    cols = []
    for c in range(s // hd):
        chunk = torch.zeros(b, s, n, hd, device=dev, dtype=torch.bfloat16)
        chunk[:, c * hd:(c + 1) * hd] = eye
        out, _ = fa.packed_flash_fwd(zero, zero, chunk.reshape(b, s, n * hd),
                                     n, 1.0, False, None, RATE, seed)
        cols.append(out.reshape(b, s, n, hd).permute(0, 2, 1, 3) != 0)
    return torch.cat(cols, -1)


def _masks_agree(fa, dev, fwd, rec, b, s, n):
    """The forward's and the recompute's keep masks read back from the
    kernel for their seeds: equal to each other and to the plain mask."""
    from paddle_tpu_torch.core import rng

    value = int(fwd) if not isinstance(fwd, torch.Tensor) else \
        int(fwd.item())
    m_fwd, m_rec = (_keep_mask(fa, dev, x, b, s, n) for x in (fwd, rec))
    plain = rng.attn_keep(value, RATE, b, n, s, s, dev)
    return dict(seed=value, bits=int(m_fwd.numel()),
                forward_equals_recompute=bool(torch.equal(m_fwd, m_rec)),
                equals_plain_mask=bool(torch.equal(m_fwd, plain)),
                kept=float(m_fwd.float().mean()))


def _flash_autograd_vs_direct(fa, dev, b, s, n, hd=64):
    """At the step's shapes (bf16, key bias, dropout RATE, the seed a
    device int64 as a compiled step binds it): FlashAttentionFunction's
    dq, dk, dv against a direct packed_flash_bwd on the same saved Out
    and Lse, bit for bit."""
    q, k, v, do, bias = _train_attn_inputs(dev, b, s, torch.bfloat16, 11)
    seed = torch.full((), ATTN_SEED, dtype=torch.int64, device=dev)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = fa.flash_attention(leaves[0], leaves[1], leaves[2], n,
                                  hd ** -0.5, False, bias, RATE, seed)
    out.backward(do)
    want = fa.packed_flash_bwd(q, k, v, out.detach(), lse, do, n, hd ** -0.5,
                               False, bias, RATE, seed)
    equal = [bool(torch.equal(x.grad, w)) for x, w in zip(leaves, want)]
    return dict(shape=f"B={b} S={s} n={n} hd={hd} bf16 bias dropout={RATE}",
                dq_dk_dv_bitwise=equal,
                nonzero=[bool(x.grad.abs().sum() > 0) for x in leaves])


def _state_copy(scope):
    from paddle_tpu_torch.core.scope import Scope

    out = Scope()
    for n, v in scope.items():
        out.set(n, v.clone() if isinstance(v, torch.Tensor) else v)
    return out


def _rows(batch, b):
    return {k: v[:b] for k, v in batch.items()}


def _one_step(exe, prog, feed, scope, fetch):
    """One op-by-op step: (loss, the fetched gradients on the device, the
    peak memory allocated in GB)."""
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = exe.run(prog, feed=feed, scope=scope, fetch_list=fetch,
                  use_compiled=False, return_numpy=False)
    torch.cuda.synchronize()
    return float(out[0].float().reshape(-1)[0]), out[1:], \
        torch.cuda.max_memory_allocated() / 2 ** 30


def _recompute_against_plain(dev, main_prog, loss, state, batch, b_main):
    """The program without recompute, one op-by-op step from ``state``, at
    the phase's batch or, where it runs out of memory, the first of the
    smaller batches that fits; the recompute program one step from the
    same state at that batch. Gradients within FLEET_GRAD_TOL of their
    tensor's largest magnitude, parameters within FLEET_PARAM_TOL."""
    from paddle_tpu_torch.core.executor import Executor

    _, plain, _, _ = _ernie_fleet_programs(FLEET_LAYERS, recompute=False)
    params = [p.name for p in main_prog.all_parameters()]

    def fetch(prog):
        return [loss] + [prog.grad_var_map[p] for p in params]

    oom = []
    for b in [b_main] + [x for x in (32, 24, 16, 8) if x < b_main]:
        exe, sc = Executor(device=dev), _state_copy(state)
        try:
            p_loss, p_grads, p_peak = _one_step(exe, plain, _rows(batch, b),
                                                sc, fetch(plain))
            break
        except torch.cuda.OutOfMemoryError as e:
            oom.append(dict(batch=b, why=str(e).split(".")[0]))
            del exe, sc
            gc.collect()
            torch.cuda.empty_cache()
    else:
        raise AssertionError(f"train_ernie_fleet: the program without "
                             f"recompute fits no batch: {oom}")
    p_params = {n: sc.find_var(n) for n in params}
    del exe
    exe2, sc2 = Executor(device=dev), _state_copy(state)
    r_loss, r_grads, r_peak = _one_step(exe2, main_prog, _rows(batch, b),
                                        sc2, fetch(main_prog))
    grad_err = max(float((g.float() - w.float()).abs().max()
                         / w.float().abs().max().clamp_min(1e-30))
                   for g, w in zip(r_grads, p_grads))
    param_err = max(float((sc2.find_var(n) - p_params[n]).abs().max())
                    for n in params)
    return dict(batch=b, plain_out_of_memory=oom, loss=r_loss,
                loss_without_recompute=p_loss, peak_gb=r_peak,
                peak_gb_without_recompute=p_peak,
                grad_max_rel_err=grad_err, param_max_abs_err=param_err,
                tolerance=f"gradients {FLEET_GRAD_TOL} of each tensor's "
                          f"largest magnitude, parameters "
                          f"{FLEET_PARAM_TOL} absolute")


def _overflow_sequence(exe, prog, feed, scope, loss, use_compiled):
    """FLEET_OVERFLOW's steps from a fresh loss-scaling state (scale
    FLEET_SCALE, counters 0), each scale written in place before its step
    (a compiled step reads the tensor it was built on): (scale, good, bad)
    and the loss after every step."""
    for n, v in zip(FLEET_SCALING, (FLEET_SCALE, 0, 0)):
        scope.find_var(n).fill_(v)
    seq, losses = [], []
    for scale in FLEET_OVERFLOW:
        if scale is not None:
            scope.find_var(FLEET_SCALING[0]).fill_(scale)
        out = exe.run(prog, feed=feed, scope=scope, fetch_list=[loss],
                      use_compiled=use_compiled)
        losses.append(_loss(out))
        seq.append([scope.find_var(n).item() for n in FLEET_SCALING])
    return seq, losses


def train_ernie_fleet(dev, smi, batches=(40, 32, 24, 16), timed=4):
    """ERNIE-large at FLEET_LAYERS of its 24 layers (fp32 parameters,
    flash attention) trained
    through fleet's strategy chain (_ernie_fleet_programs) on one
    synthetic batch: b40, or the first of ``batches`` that fits. Startup
    on the card and one warm-up step op by op (its attention seeds
    recorded), then profile_train.timed_modes (``timed`` timed steps a
    mode). Gates, per compiled step and op by op: 2 * FLEET_LAYERS flash
    forward launches (one in each segment's forward, one in its
    recompute) and FLEET_LAYERS backward (through FlashAttentionFunction),
    all on the bf16 tensor-core
    instance, no AdamW launch, one lamb op a parameter; each leg's loss
    falling and every parameter finite. Then: FlashAttentionFunction at
    the step's shapes bit for bit the direct backward; the program
    without recompute one step from the same state (_recompute_against_
    plain): its peak memory higher, gradients and parameters within the
    stated tolerances; the loss-scaling overflow in a compiled step of
    the program at 2 of the batch's rows against the CPU's op by
    op run of the same program at 2 layers on those rows
    (_overflow_sequence: the same (scale, good, bad) bit for bit after
    every step, finite losses); and layer 0's attention keep mask, read
    back from the kernel for the forward's seed and the recompute's, op
    by op (ints) and in the compiled step (its seed-table slot): equal
    to each other and to the plain mask."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.tools.profile_train import timed_modes

    phase, layers, n = "train_ernie_fleet", FLEET_LAYERS, \
        ERNIE["num_attention_heads"]
    t_build = time.perf_counter()
    cfg, main_prog, startup, fetches = _ernie_fleet_programs(layers)
    build_s = time.perf_counter() - t_build
    ops = main_prog.global_block().ops
    n_params = len(main_prog.all_parameters())
    n_lamb = sum(o.type == "lamb" for o in ops)
    calls = [o for o in ops if o.type == "block_call"]
    seed0 = next(o.attrs["seed"] for blk in main_prog.blocks[1:]
                 for o in blk.ops if o.type == "flash_attention")
    loss = fetches["loss"].name
    exe = Executor(device=dev)
    tried = []
    for batch_size in batches:
        scope = Scope()
        exe.run(startup, scope=scope)
        batch = bert.synthetic_pretraining_batch(
            cfg, batch_size, SEQ, seed=0, max_predictions_per_seq=MAX_PREDS)
        try:
            with _AttnSeeds() as eager_seeds:
                warm = exe.run(main_prog, feed=batch, scope=scope,
                               fetch_list=[loss], use_compiled=False)
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError as e:
            tried.append(dict(batch=batch_size, why=str(e).split(".")[0]))
            del scope
            gc.collect()
            torch.cuda.empty_cache()
    else:
        raise AssertionError(f"{phase}: no batch size fits: {tried}")
    modes = timed_modes(exe, main_prog, batch, scope, [loss], timed)
    comp = modes["compiled"]
    params = [scope.find_var(p.name) for p in main_prog.all_parameters()]
    finite = all(bool(torch.isfinite(p).all()) for p in params)
    exe.close()
    del exe
    _release()
    autograd_check = _flash_autograd_vs_direct(fa, dev, batch_size, SEQ, n)
    state = _state_copy(scope)
    del scope, params
    _release()
    versus = _recompute_against_plain(dev, main_prog, loss, state, batch,
                                      batch_size)
    _release()
    # the overflow: the compiled step at 2 rows on the card, the 2-layer
    # program op by op on the CPU, on the same rows
    rows = _rows(batch, 2)
    exe = Executor(device=dev)
    with _AttnSeeds() as comp_seeds:
        card_seq, card_losses = _overflow_sequence(exe, main_prog, rows,
                                                   state, loss, True)
    builds = exe.compiled_builds
    exe.close()
    del exe
    _, cpu_prog, cpu_start, cpu_fetch = _ernie_fleet_programs(2)
    cpu_scope = Scope()
    cpu_exe = Executor(device="cpu")
    cpu_exe.run(cpu_start, scope=cpu_scope)
    cpu_seq, cpu_losses = _overflow_sequence(
        cpu_exe, cpu_prog, rows, cpu_scope, cpu_fetch["loss"].name, False)
    del cpu_scope, state
    _release()
    # layer 0's keep mask: op by op the seeds are ints; in the compiled
    # step (recorded at its capture) the forward and the recompute bind
    # one seed-table slot, which holds the last step's value
    fwd_i, rec_i = eager_seeds.of(seed0)
    slots = [s for b, _, s in comp_seeds.calls
             if b == seed0 and isinstance(s, torch.Tensor)]
    same_slot = len(slots) >= 2 and all(t is slots[0] for t in slots)
    masks = dict(op_by_op=_masks_agree(fa, dev, fwd_i, rec_i, batch_size,
                                       SEQ, n),
                 compiled=_masks_agree(fa, dev, slots[0], slots[-1], 2, SEQ,
                                       n),
                 compiled_same_slot=same_slot)
    want = {"flash_attention_fwd": 2 * layers, "flash_attention_bwd": layers}
    emit(phase, model="ernie_large", layers=layers, dtype="float32",
         amp="bf16, dynamic loss scaling", optimizer="lamb",
         lr=FLEET_LR, grad_clip="global norm 1.0",
         recompute_checkpoints=len(calls), seq=SEQ,
         max_predictions=MAX_PREDS, batch=batch_size,
         batches_that_did_not_fit=tried, build_s=build_s, ops=len(ops),
         op_types=len({o.type for o in ops}), lamb_ops=n_lamb,
         parameters=n_params, warmup_loss=_loss(warm),
         modes=_per_mode(modes), step_ms_p50=comp["step_ms_p50"],
         tokens_per_s=batch_size * SEQ / (comp["step_ms_p50"] / 1e3),
         peak_gb={m: r["max_memory_allocated"] / 2 ** 30
                  for m, r in modes.items()},
         flash_launches_by_layout=comp["layouts"],
         flash_launches_by_dtype=comp["dtypes"], params_finite=finite,
         flash_autograd_vs_direct=autograd_check,
         recompute_vs_plain=versus,
         overflow=dict(schedule=[None if x is None else str(x)
                                 for x in FLEET_OVERFLOW],
                       card_rows=2, card_layers=layers, cpu_layers=2,
                       card=card_seq, cpu=cpu_seq, card_losses=card_losses,
                       cpu_losses=cpu_losses, compiled_builds=builds),
         keep_masks=masks, nvidia_smi=smi,
         note="step ms on the host clock, one synthetic batch; smoke "
              "figures, not a benchmark")
    _check_legs(phase, modes, first=2)
    for m, r in modes.items():
        if r["launches_per_step"] != want or n_lamb != n_params \
                or len(calls) != layers:
            raise AssertionError(f"{phase} ({m}): launches per step "
                                 f"{r['launches_per_step']}, {n_lamb} lamb "
                                 f"ops for {n_params} parameters, "
                                 f"{len(calls)} segments")
    for name in want:
        if comp["dtypes"][name] != {"fp32_tf32x3": 0,
                                    "bf16_wgmma": comp["launches"][name]}:
            raise AssertionError(f"{phase}: {name} launches by instance "
                                 f"{comp['dtypes'][name]}")
    if not finite:
        raise AssertionError(f"{phase}: a parameter is not finite")
    if not (all(autograd_check["dq_dk_dv_bitwise"])
            and all(autograd_check["nonzero"])):
        raise AssertionError(f"{phase}: FlashAttentionFunction against the "
                             f"direct backward: {autograd_check}")
    if not (versus["peak_gb_without_recompute"] > versus["peak_gb"]
            and versus["grad_max_rel_err"] <= FLEET_GRAD_TOL
            and versus["param_max_abs_err"] <= FLEET_PARAM_TOL):
        raise AssertionError(f"{phase}: recompute against no recompute: "
                             f"{versus}")
    bad_good = [(b, g) for _, g, b in card_seq]
    if card_seq != cpu_seq or builds != 1 \
            or bad_good != [(0, 1), (0, 2), (1, 0), (0, 0), (0, 1), (0, 2)] \
            or not all(np.isfinite(card_losses + cpu_losses)):
        raise AssertionError(f"{phase}: overflow sequence card {card_seq} "
                             f"(losses {card_losses}, {builds} builds), CPU "
                             f"{cpu_seq} (losses {cpu_losses})")
    for where in ("op_by_op", "compiled"):
        m = masks[where]
        if not (m["forward_equals_recompute"] and m["equals_plain_mask"]):
            raise AssertionError(f"{phase}: keep masks {where}: {m}")
    if not same_slot:
        raise AssertionError(f"{phase}: the compiled step bound layer 0's "
                             f"forward and recompute to {slots}")
    return dict(launches=comp["launches"], layouts=comp["layouts"],
                dtypes=comp["dtypes"])


def compiled_parity(dev, smi, layers=4, steps=4, batch_size=40):
    """ERNIE-large at full width (hidden 1024, 16 heads, FFN 4096, vocab
    18000, bf16, dropout, AdamW), s512 b40, ``layers`` deep, ``steps``
    steps op by op twice and compiled once, each step from the same state
    (tools/step_parity.compiled_parity). Gates: the losses and every
    dropout mask bit for bit (the seed table's slots give op_seed's bits
    to every random op, the flash kernels included), the masks new each
    step; every state tensor after each step bit for bit in all three
    runs (lookup_table_v2's gradient sums each row in the ids' order), the
    tensors that differ and the forward ops that read them printed; the
    launches a step equal, by kernel, layout and instance."""
    from paddle_tpu_torch.tools.step_parity import compiled_parity as run

    rec = run(dev, layers, SEQ, steps, batch_size)
    last = rec.pop("last")
    emit("compiled_parity", **rec, nvidia_smi=smi)
    if not (rec["losses_and_masks_bitwise_equal"]
            and rec["masks_new_each_step"]
            and rec["state_bitwise_equal_in_all_runs"]
            and rec["launch_counts_equal"]):
        raise AssertionError(
            "compiled_parity: losses and masks "
            f"{rec['losses_and_masks_bitwise_equal']}, masks new each step "
            f"{rec['masks_new_each_step']}, state differs in "
            f"{rec['runs_differ_in']}, counts "
            f"{rec['launch_counts_equal']}")
    return last


def train_lenet(dev, smi, batch_size=LENET_BATCH, timed=20, lr=1e-3):
    """LeNet/MNIST as tools/bench_models.py bench_mnist builds it (b512,
    two conv + pool stages, fc, softmax, cross entropy, Adam) at lr 1e-3:
    at build_lenet_program's default 0.01 random normal images drive the
    softmax to saturation and the loss rises, on the CPU as well. Startup, one
    warm-up step, then profile_train.timed_modes on one batch; a falling
    loss in each leg (_check_legs). No
    hand-written kernel is on this path (its convs are cuDNN's). Then
    card against CPU at batch 16, fp32, 4 steps from the initialised
    state: losses within 1e-4."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import lenet
    from paddle_tpu_torch.tools.profile_train import timed_modes

    with unique_name.guard():
        main_prog, startup, _, fetches = lenet.build_lenet_program(
            batch_size, lr=lr)
    r = np.random.RandomState(0)

    def batch(b):
        return {"img": r.randn(b, 1, 28, 28).astype(np.float32),
                "label": r.randint(0, 10, (b, 1)).astype(np.int64)}

    exe, scope = Executor(device=dev), Scope()
    exe.run(startup, scope=scope)
    # the parity legs start from the initialised state: after the timed
    # steps the loss sits on a plateau (random labels), where Adam scales
    # gradient noise up to full steps and any two devices part at once
    state = {n: v.cpu() if isinstance(v, torch.Tensor) else v
             for n, v in scope.items()}
    feed = {k: torch.from_numpy(v).to(dev) for k, v in
            batch(batch_size).items()}
    fetch = [fetches["loss"]]
    warm = _loss(exe.run(main_prog, feed=feed, scope=scope,
                         fetch_list=fetch, use_compiled=False))
    modes = timed_modes(exe, main_prog, feed, scope, fetch, timed)
    exe.close()
    small = batch(16)
    parity = {}
    for device in (dev, torch.device("cpu")):
        sc = Scope()
        for n, v in state.items():
            sc.set(n, v.to(device) if isinstance(v, torch.Tensor) else v)
        ex = Executor(device=device)
        parity[device.type] = [_loss(ex.run(main_prog, feed=small, scope=sc,
                                            fetch_list=fetch))
                               for _ in range(4)]
    ok = np.allclose(parity["cuda"], parity["cpu"], rtol=1e-4, atol=1e-4)
    comp = modes["compiled"]
    emit("train_lenet", model="lenet", batch=batch_size, lr=lr,
         ops=len(main_prog.global_block().ops), warmup_loss=warm,
         modes=_per_mode(modes), images_per_s=batch_size / (comp["step_ms_p50"] / 1e3),
         parity_batch=16, parity_loss_gpu=parity["cuda"],
         parity_loss_cpu=parity["cpu"], parity_tolerance="rtol=atol=1e-4",
         nvidia_smi=smi)
    _check_legs("train_lenet", modes)
    if not ok:
        raise AssertionError("train_lenet: card and CPU disagree")
    return dict(launches=comp["launches"], layouts=comp["layouts"],
                dtypes=comp["dtypes"])


def _bert_base_programs(layers, batch_size):
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.models import bert

    cfg = bert.bert_base()
    cfg.num_hidden_layers = layers
    cfg.dtype, cfg.use_flash_attention = "bfloat16", True
    with unique_name.guard():
        main_prog, startup, _, fetches = bert.build_pretraining_program(
            cfg, seq_len=BERT_BASE_SEQ, optimizer_name="adamw",
            max_predictions_per_seq=BERT_BASE_PREDS)
    batch = bert.synthetic_pretraining_batch(
        cfg, batch_size, BERT_BASE_SEQ, seed=0,
        max_predictions_per_seq=BERT_BASE_PREDS)
    return main_prog, startup, fetches, batch


def train_bert_base(dev, smi, timed=8):
    """BERT-base as tools/bench_models.py bench_bert_base trains it (12
    layers, hidden 768, 12 heads of 64, vocab 30522, s128, b384, 20 masked
    predictions, bf16, packed flash attention, dropout 0.1, AdamW):
    startup, one warm-up step, profile_train.timed_modes on one batch; a
    falling loss in each leg (_check_legs); 12 flash forward and 12 backward launches a step on the bf16
    instance, packed, and one AdamW launch an adamw op. Then card against
    CPU at 2 layers and batch 2, 4 steps from one state: the dropout masks
    bit for bit, losses within 1e-2 (bf16)."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.tools.profile_train import timed_modes

    main_prog, startup, fetches, batch = _bert_base_programs(
        12, BERT_BASE_BATCH)
    ops = main_prog.global_block().ops
    n_adamw = sum(o.type == "adamw" for o in ops)
    exe, scope = Executor(device=dev), Scope()
    exe.run(startup, scope=scope)
    fetch = [fetches["loss"]]
    warm = _loss(exe.run(main_prog, feed=batch, scope=scope,
                         fetch_list=fetch, use_compiled=False))
    modes = timed_modes(exe, main_prog, batch, scope, fetch, timed)
    exe.close()
    del scope
    comp = modes["compiled"]
    want = {"flash_attention_fwd": 12, "flash_attention_bwd": 12,
            "fused_adamw": n_adamw}

    pmain, pstart, pfetch, pbatch = _bert_base_programs(2, 2)
    sc = Scope()
    Executor(device="cpu").run(pstart, scope=sc)
    state = _state_arrays(sc)
    masks = [o.outputs["Mask"][0] for o in pmain.global_block().ops
             if o.type == "dropout"]
    parity = {}
    for device in (dev, torch.device("cpu")):
        s2 = bert.scope_from_numpy(state, device)
        ex = Executor(device=device)
        parity[device.type] = [ex.run(pmain, feed=pbatch, scope=s2,
                                      fetch_list=[pfetch["loss"]] + masks)
                               for _ in range(4)]
    loss_gpu = [_loss(o) for o in parity["cuda"]]
    loss_cpu = [_loss(o) for o in parity["cpu"]]
    masks_equal = all(np.array_equal(x, y) for a, b in zip(
        parity["cuda"], parity["cpu"]) for x, y in zip(a[1:], b[1:]))
    ok = masks_equal and np.allclose(loss_gpu, loss_cpu, rtol=1e-2,
                                     atol=1e-2)
    emit("train_bert_base", model="bert_base", layers=12, seq=BERT_BASE_SEQ,
         batch=BERT_BASE_BATCH, max_predictions=BERT_BASE_PREDS,
         dtype="bfloat16", ops=len(ops), adamw_ops=n_adamw,
         warmup_loss=warm, modes=_per_mode(modes),
         tokens_per_s=BERT_BASE_BATCH * BERT_BASE_SEQ
         / (comp["step_ms_p50"] / 1e3),
         flash_launches_by_layout=comp["layouts"],
         flash_launches_by_dtype=comp["dtypes"],
         parity_layers=2, parity_batch=2, parity_loss_gpu=loss_gpu,
         parity_loss_cpu=loss_cpu, parity_masks_bitwise_equal=masks_equal,
         parity_tolerance="rtol=atol=1e-2", nvidia_smi=smi)
    _check_legs("train_bert_base", modes)
    for m, x in modes.items():
        if x["launches_per_step"] != want:
            raise AssertionError(f"train_bert_base ({m}): launches per step "
                                 f"{x['launches_per_step']}")
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        n = comp["launches"][name]
        if comp["dtypes"][name] != {"fp32_tf32x3": 0, "bf16_wgmma": n} or \
                comp["layouts"][name] != {"packed": n, "bnsd": 0}:
            raise AssertionError(f"train_bert_base: {name} by instance "
                                 f"{comp['dtypes'][name]}, by layout "
                                 f"{comp['layouts'][name]}")
    if not ok:
        raise AssertionError("train_bert_base: card and CPU disagree")
    return dict(launches=comp["launches"], layouts=comp["layouts"],
                dtypes=comp["dtypes"])


def _noam(step, d_model=1024, warmup=WMT_WARMUP, scale=2.0):
    """The noam rate at ``step`` in float32, as the lr_schedule op forms
    it: scale * d^-0.5 * min(s^-0.5, s * warmup^-1.5), s = step + 1."""
    s = np.float32(step + 1)
    return float(np.float32(scale * d_model ** -0.5) * min(
        s ** np.float32(-0.5), s * np.float32(warmup ** -1.5)))


def train_transformer_big(dev, smi, timed=5, parity_steps=2):
    """Transformer-big as tools/bench_models.py bench_transformer_big
    trains it (WMT14 En-De, d_model 1024, 16 heads, d_inner 4096, 6+6
    layers, vocab 32000 shared, label smoothing 0.1, dropout 0.1, b48
    s256, bf16 AMP, Adam with beta2 0.997 and epsilon 1e-9 under noam
    decay at lr scale 2), with noam's warm-up at WMT_WARMUP steps (why:
    beside the constant): startup, one warm-up step, then
    profile_train.timed_modes on one batch. Gates: a falling loss in each
    leg and the traced step's kernels, by name, as its counters
    (_check_legs); 18 flash forward and 18 backward launches a step (6
    encoder self-attention with the key bias, 6 decoder causal, 6 cross
    with the key bias), all packed on the bf16 instance, and no AdamW
    launch (the reference's adam op reaches no kernel); one compiled
    step built for both legs; the rate fetched at each run the noam
    formula at the counter's step, op by op and after every replay. Then
    compiled_parity at 2+2 layers (b48, 3 steps, op by op twice and
    compiled from one state: losses, masks and every state tensor bit
    for bit), and card
    against CPU at full width, 2+2 layers, batch 2, ``parity_steps``
    steps from one state: masks bit for bit, losses within 1e-2 (bf16
    AMP), the same rates."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, scope_from_numpy
    from paddle_tpu_torch.models.transformer import transformer_big
    from paddle_tpu_torch.tools.profile_train import (
        _transformer_big, add_rates, timed_modes, transformer_big_flops)
    from paddle_tpu_torch.tools.step_parity import compiled_parity

    main_prog, startup, make_batch, fetch, info, tokens = _transformer_big(
        warmup_steps=WMT_WARMUP)
    flops = transformer_big_flops(transformer_big(), WMT_BATCH, WMT_SEQ)
    ops = main_prog.global_block().ops
    exe, scope = Executor(device=dev), Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    params = [scope.find_var(p.name) for p in main_prog.all_parameters()]
    feed = {k: torch.from_numpy(v).to(dev)
            for k, v in make_batch(WMT_BATCH).items()}
    warm = exe.run(main_prog, feed=feed, scope=scope, fetch_list=fetch,
                   use_compiled=False)
    step0 = float(scope.find_var(WMT_COUNTER)[0])
    builds = exe.compiled_builds
    modes = timed_modes(exe, main_prog, feed, scope, fetch, timed)
    builds = exe.compiled_builds - builds
    exe.close()
    del exe, scope, feed
    comp = modes["compiled"]
    rates = {m: [f[0] for f in r["fetched"]] for m, r in modes.items()}
    want_rates = [_noam(step0 + j) for j in range(1, len(rates["eager"])
                                                  + 1)]
    rates_ok = all(np.allclose(r, want_rates, rtol=1e-6, atol=0)
                   for r in rates.values())
    _release()

    rec = compiled_parity(dev, 2, WMT_SEQ, 3, WMT_BATCH,
                          model="transformer_big", warmup_steps=WMT_WARMUP)
    rec.pop("last")
    _release()

    pmain, pstart, pbatch, pfetch, _, _ = _transformer_big(
        2, warmup_steps=WMT_WARMUP)
    sc = Scope()
    Executor(device="cpu").run(pstart, scope=sc)
    state = _state_arrays(sc)
    masks = [o.outputs["Mask"][0] for o in pmain.global_block().ops
             if o.type == "dropout"]
    small = pbatch(2, seed=3)
    parity, seconds = {}, {}
    for device in (dev, torch.device("cpu")):
        s2 = scope_from_numpy(state, device)
        ex = Executor(device=device)
        t0 = time.perf_counter()
        parity[device.type] = [ex.run(pmain, feed=small, scope=s2,
                                      fetch_list=pfetch + masks)
                               for _ in range(parity_steps)]
        seconds[device.type] = time.perf_counter() - t0
    loss_gpu = [_loss(o) for o in parity["cuda"]]
    loss_cpu = [_loss(o) for o in parity["cpu"]]
    rate_gpu = [float(o[1][0]) for o in parity["cuda"]]
    rate_cpu = [float(o[1][0]) for o in parity["cpu"]]
    masks_equal = all(np.array_equal(x, y) for a, b in zip(
        parity["cuda"], parity["cpu"]) for x, y in zip(a[2:], b[2:]))
    parity_ok = masks_equal and np.allclose(
        loss_gpu, loss_cpu, rtol=1e-2, atol=1e-2) and np.allclose(
        rate_gpu, rate_cpu, rtol=1e-6, atol=0)
    add_rates(modes, tokens, "tokens_per_s", flops)
    emit("train_transformer_big", **info, model_flops=flops, ops=len(ops),
         op_types=len({o.type for o in ops}),
         parameters=len(params),
         parameter_elements=int(sum(p.numel() for p in params)),
         startup_s=startup_s, warmup_loss=_loss(warm),
         modes=_per_mode(modes), step_ms_p50=comp["step_ms_p50"],
         compiled_steps_built=builds, rates_match_noam=bool(rates_ok),
         flash_launches_by_layout=comp["layouts"],
         flash_launches_by_dtype=comp["dtypes"],
         compiled_parity_2_layers=rec,
         parity_layers=2, parity_batch=2, parity_loss_gpu=loss_gpu,
         parity_loss_cpu=loss_cpu, parity_rates_gpu=rate_gpu,
         parity_rates_cpu=rate_cpu, parity_masks=len(masks),
         parity_masks_bitwise_equal=masks_equal,
         parity_tolerance="rtol=atol=1e-2", parity_seconds=seconds,
         nvidia_smi=smi,
         note="step ms on the host clock, one synthetic batch; smoke "
              "figures, not a benchmark")
    _check_legs("train_transformer_big", modes)
    want = {"flash_attention_fwd": 18, "flash_attention_bwd": 18}
    for m, r in modes.items():
        if r["launches_per_step"] != want:
            raise AssertionError(f"train_transformer_big ({m}): launches "
                                 f"per step {r['launches_per_step']}")
    for name in want:
        n = comp["launches"][name]
        if comp["dtypes"][name] != {"fp32_tf32x3": 0, "bf16_wgmma": n} or \
                comp["layouts"][name] != {"packed": n, "bnsd": 0}:
            raise AssertionError(f"train_transformer_big: {name} by "
                                 f"instance {comp['dtypes'][name]}, by "
                                 f"layout {comp['layouts'][name]}")
    if builds != 1 or not rates_ok:
        raise AssertionError(f"train_transformer_big: {builds} compiled "
                             f"steps built; rates {rates} against noam "
                             f"{want_rates}")
    if not (rec["losses_and_masks_bitwise_equal"]
            and rec["masks_new_each_step"]
            and rec["state_bitwise_equal_in_all_runs"]
            and rec["launch_counts_equal"]):
        raise AssertionError(f"train_transformer_big: compiled parity "
                             f"{rec}")
    if not parity_ok:
        raise AssertionError("train_transformer_big: card and CPU disagree")
    return dict(launches=comp["launches"], layouts=comp["layouts"],
                dtypes=comp["dtypes"], step_ms_p50=comp["step_ms_p50"])


def bnsd_ops(dev):
    """The 4-D branch of the flash_attention op through the program path: a
    program built with layers.flash_attention on [40,16,512,64] bf16 q/k/v
    parameters with a [B,1,1,S] key bias from a fed mask and attention
    dropout 0.1, append_backward, and 3 Executor.run steps on the card
    fetching the loss and the three gradients. Each step must launch one
    flash forward and one flash backward, both in the bnsd layout."""
    from paddle_tpu_torch import kernels, layers
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.backward import append_backward
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.ir import Program, program_guard
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.initializer import TruncatedNormal

    (b, n, s, hd), steps = BNSD_OPS, 3
    main_prog, startup = Program(), Program()
    with unique_name.guard(), program_guard(main_prog, startup):
        q, k, v = (layers.create_parameter(
            [b, n, s, hd], "bfloat16", name=f"attn_{c}",
            default_initializer=TruncatedNormal(0.0, 1.0)) for c in "qkv")
        mask = layers.static_data("mask", [b, s], "float32")
        bias = layers.unsqueeze(layers.scale(
            mask, scale=10000.0, bias=-1.0, bias_after_scale=False), [1, 2])
        bias.stop_gradient = True
        out = layers.flash_attention(q, k, v, bias=bias, dropout_rate=RATE)
        loss = layers.mean(layers.elementwise_mul(out, out))
        append_backward(loss)
    exe = Executor(device=dev)
    scope = Scope()
    exe.run(startup, scope=scope)
    feed = {"mask": (np.random.RandomState(5).rand(b, s) > 0.1)
            .astype(np.float32)}
    fetch = [loss.name] + [f"attn_{c}@GRAD" for c in "qkv"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    runs = [exe.run(main_prog, feed=feed, fetch_list=fetch, scope=scope)
            for _ in range(steps)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, layouts = kernels.launch_counts(), kernels.layout_counts()
    dtypes = kernels.dtype_counts()
    losses = [float(r[0].reshape(-1)[0]) for r in runs]
    grads_ok = all(g.shape == (b, n, s, hd) and np.isfinite(
        g.astype(np.float32)).all() and np.abs(g.astype(np.float32)).max()
        > 0 for r in runs for g in r[1:])
    want = {"flash_attention_fwd": {"packed": 0, "bnsd": steps},
            "flash_attention_bwd": {"packed": 0, "bnsd": steps}}
    want_dtypes = {k_: {"fp32_tf32x3": 0, "bf16_wgmma": steps}
                   for k_ in want}
    emit("bnsd_ops", shape=[b, n, s, hd], dtype="bfloat16", steps=steps,
         losses=losses, grads_finite_nonzero=grads_ok, seconds=seconds,
         launches=counts, launches_by_layout=layouts,
         launches_by_dtype=dtypes,
         ops=[o.type for o in main_prog.global_block().ops])
    if layouts != want or dtypes != want_dtypes or not grads_ok \
            or not np.isfinite(losses).all():
        raise AssertionError(f"bnsd_ops: launches {layouts} {dtypes}, "
                             f"losses {losses}, grads finite {grads_ok}")
    return dict(launches=counts, layouts=layouts, dtypes=dtypes)


# ---------------------------------------------------------------------------
# the ResNet-50 slice: the last two TPU kernels and the ResNet-50 step
# ---------------------------------------------------------------------------

# check_layer_norm: (rows, h, dtype) -- ERNIE-large's [40*512, 1024] rows in
# bf16 and fp32, and the decoder LM's 1500-token prefill in fp32
LN_CASES = ((SEQ * 40, 1024, torch.bfloat16),
            (SEQ * 40, 1024, torch.float32), (1500, 1024, torch.float32))
LN_OPS = (40, SEQ, 1024)          # fused_ln_ops: X [B, S, H] bf16
# a bf16 kernel against its plain version run in fp32 on the same values
# and rounded once: one bf16 ulp (2^-7 relative) + 1e-3
BF16_TOL = dict(rtol=2 ** -7, atol=1e-3)
RESNET_BATCH = 256                # tools/bench_models.py bench_resnet50
RES4_CONV = "res4b_c2"            # a 3x3 stride-1 256 -> 256 conv at 14x14


def check_layer_norm(dev, results):
    """The layer_norm kernel against its plain version at ERNIE-large's
    LN rows ([20480, 1024], bf16 and fp32) and the decoder LM's prefill
    ([1500, 1024] fp32), with scale and bias; timed with F.layer_norm as
    the library. Inputs are rotated through more than the 50 MB L2."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import layer_norm as ln

    for rows, h, dtype in LN_CASES:
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        g = torch.Generator(device=dev).manual_seed(rows + h)
        esz = torch.finfo(dtype).bits // 8
        reps = max(1, -(-(64 << 20) // (rows * h * esz)))
        xs = [(torch.randn(rows, h, device=dev, generator=g) * 2 + 0.5)
              .to(dtype) for _ in range(reps)]
        sc = torch.rand(h, device=dev, generator=g) + 0.5
        bi = torch.randn(h, device=dev, generator=g)
        y, mean, rstd = ln.layer_norm_fwd(xs[0], sc, bi, 1e-5)
        ry, rmean, rrstd = ln.plain_layer_norm(xs[0].float(), sc, bi, 1e-5)
        ry = ry.to(dtype)
        torch.cuda.synchronize()
        tol = BF16_TOL if dtype == torch.bfloat16 \
            else dict(rtol=1e-5, atol=1e-5)
        if not (torch.allclose(y.float(), ry.float(), **tol)
                and torch.allclose(mean, rmean, rtol=1e-5, atol=1e-5)
                and torch.allclose(rstd, rrstd, rtol=1e-5, atol=1e-5)):
            raise AssertionError(f"layer norm [{rows}, {h}] {name}: "
                                 f"{errors(y, ry)} {errors(rstd, rrstd)}")
        err = max(errors(y, ry)[0], errors(mean, rmean)[0],
                  errors(rstd, rrstd)[0])
        sc_t, bi_t = sc.to(dtype), bi.to(dtype)

        def kernel(i):
            return ln.layer_norm_fwd(xs[i % reps], sc, bi, 1e-5)

        def library(i):
            return F.layer_norm(xs[i % reps], (h,), sc_t, bi_t, 1e-5)

        # events around 30 calls as Python issues them, and the same 30
        # calls replayed from a CUDA graph (the device alone), twice
        rounds = [with_device_ms(dict(ms=events_ms(kernel, 30),
                                      library_ms=events_ms(library, 30)),
                                 kernel, library) for _ in range(2)]
        plain = events_ms(lambda i: ln.plain_layer_norm(xs[i % reps], sc, bi,
                                                        1e-5), 10)
        bms, by = bound_ms(2 * rows * h * esz + 2 * h * 4 + 2 * rows * 4,
                           8 * rows * h, FP32_FLOPS_PER_S)
        results.append(dict(name="layer_norm", shape=f"[{rows}, {h}] {name}",
                            max_abs_err=err, max_rel_err=None,
                            **rounds[0], second_round=rounds[1],
                            plain_ms=plain, bound_ms=bms, bound_by=by))
        del xs
    torch.cuda.empty_cache()


def check_conv(dev, results):
    """The conv_bn_relu kernel against its plain version (the 9 products
    of the bf16 values summed in fp32, the epilogue in fp32, rounded
    once) at the tool's shape: N = 256, 14x14, 256 -> 256, NHWC bf16.
    Timed in the exp_conv phase."""
    from paddle_tpu_torch.kernels import conv_bn_relu as cbr
    from paddle_tpu_torch.tools import exp_conv

    _, xp, w, scale, shift = exp_conv.make_inputs(256, dev, seed=0)
    out = cbr.conv_bn_relu(xp, w, scale, shift)
    ref = cbr.plain_conv_bn_relu(xp, w, scale, shift)
    torch.cuda.synchronize()
    if not torch.allclose(out.float(), ref.float(), **BF16_TOL):
        raise AssertionError(f"conv_bn_relu N=256: {errors(out, ref)}")
    flops = 2.0 * 256 * 14 * 14 * 256 * 9 * 256
    bms, by = bound_ms(xp.numel() * 2 + w.numel() * 2 + out.numel() * 2
                       + 2 * 256 * 4, flops, BF16_FLOPS_PER_S)
    results.append(dict(name="conv_bn_relu",
                        shape="N=256 H=W=14 C=256 Co=256 3x3 NHWC bf16",
                        max_abs_err=errors(out, ref)[0],
                        max_rel_err=errors(out, ref)[1], ms=None,
                        plain_ms=None, library_ms=None, bound_ms=bms,
                        bound_by=by, relu_kept_share=float(
                            (ref.float() > 0).float().mean())))


def exp_conv_phase(dev, results):
    """tools/exp_conv.py's three timings at its shape: the kernel, the
    cuDNN route and the plain version; their times go into the
    conv_bn_relu row of the kernels line. Launch counts: this phase's."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.tools import exp_conv

    kernels.reset_launch_counts()
    out = exp_conv.run(dev, batch=256, reps=20)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    emit("exp_conv", launches=counts["conv_bn_relu"], **out)
    row = next(r for r in results if r["name"] == "conv_bn_relu")
    row.update(ms=out["kernel_ms"], plain_ms=out["plain_ms"],
               library_ms=out["library_ms"],
               device_ms=out["kernel_device_ms"],
               library_device_ms=out["library_device_ms"])
    if counts["conv_bn_relu"] == 0:
        raise AssertionError("exp_conv: the conv kernel never launched")
    return dict(launches=counts, layouts=kernels.layout_counts())


def _ln_program(op_type):
    """[40, 512, 1024] bf16 X (a parameter), fp32 Scale and Bias, the
    normalisation over the last axis by ``op_type`` (fused_layer_norm, or
    layer_norm at begin_norm_axis 2), loss = sum(y * c) with c a fed bf16
    tensor, append_backward. The loss's cotangent on Y is c itself, the
    same in both programs whatever Y's rounding."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.backward import append_backward
    from paddle_tpu_torch.core.ir import Program, program_guard
    from paddle_tpu_torch.initializer import Normal, TruncatedNormal
    from paddle_tpu_torch.layer_helper import LayerHelper
    from paddle_tpu_torch.param_attr import ParamAttr

    b, s, h = LN_OPS
    main_prog, startup = Program(), Program()
    with unique_name.guard(), program_guard(main_prog, startup):
        x = layers.create_parameter([b, s, h], "bfloat16", name="ln_x",
                                    default_initializer=TruncatedNormal(
                                        0.5, 2.0))
        sattr = ParamAttr(name="ln_scale", initializer=Normal(1.0, 0.2))
        battr = ParamAttr(name="ln_bias", initializer=Normal(0.0, 0.2))
        if op_type == "layer_norm":
            y = layers.layer_norm(x, begin_norm_axis=2, param_attr=sattr,
                                  bias_attr=battr)
        else:
            helper = LayerHelper("fused_layer_norm")
            sc = helper.create_parameter(sattr, [h], "float32")
            bi = helper.create_parameter(battr, [h], "float32", is_bias=True)
            y = helper.create_variable_for_type_inference("bfloat16")
            mean = helper.create_variable_for_type_inference("float32", True)
            var = helper.create_variable_for_type_inference("float32", True)
            helper.append_op("fused_layer_norm",
                             {"X": [x], "Scale": [sc], "Bias": [bi]},
                             {"Y": [y], "Mean": [mean], "Variance": [var]},
                             {"epsilon": 1e-5})
        c = layers.static_data("ln_c", [b, s, h], "bfloat16")
        loss = layers.reduce_sum(layers.elementwise_mul(y, c))
        append_backward(loss)
    return main_prog, startup, [loss.name, y.name, "ln_x@GRAD",
                                "ln_scale@GRAD", "ln_bias@GRAD"]


def fused_ln_ops(dev):
    """The fused_layer_norm op through the program path: [40, 512, 1024]
    bf16, append_backward, 3 Executor.run steps on the card. Two layer_norm
    kernel launches a step: the op's, and the one in its grad op, whose
    ``__vjp_grad__`` re-runs the forward lowering (as the reference's
    default grad maker does) to get mean and rstd. Y and the gradients of
    X, Scale and Bias equal
    those of the same program with layer_norm (begin_norm_axis 2, torch's
    own layer norm) from one state: Y and dX within the bf16 tolerance,
    dScale and dBias (fp32 sums over 20480 rows of bf16 cotangents) within
    2^-7 relative + 1e-3 of their largest magnitude."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope

    steps = 3
    fused, startup, fetch = _ln_program("fused_layer_norm")
    plain, _, pfetch = _ln_program("layer_norm")
    exe = Executor(device=dev)
    scope = Scope()
    exe.run(startup, scope=scope)
    twin = Scope()
    for n, v in scope.items():
        twin.set(n, v.clone() if isinstance(v, torch.Tensor) else v)
    g = torch.Generator(device=dev).manual_seed(6)
    feed = {"ln_c": torch.randn(LN_OPS, device=dev, generator=g)
            .to(torch.bfloat16)}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = [exe.run(fused, feed=feed, fetch_list=fetch, scope=scope,
                   return_numpy=False) for _ in range(steps)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = [exe.run(plain, feed=feed, fetch_list=pfetch, scope=twin,
                    return_numpy=False) for _ in range(steps)]
    torch.cuda.synchronize()
    err, ok = {}, True
    for g_run, w_run in zip(got, want):
        for name, g, w in zip(("Y", "dX", "dScale", "dBias"), g_run[1:],
                              w_run[1:]):
            g, w = g.float(), w.float()
            if name in ("Y", "dX"):
                close = torch.allclose(g, w, **BF16_TOL)
            else:
                close = float((g - w).abs().max()) <= \
                    2 ** -7 * float(w.abs().max()) + 1e-3
            ok = ok and close and bool(torch.isfinite(g).all())
            err[name] = max(err.get(name, 0.0), float((g - w).abs().max()))
    emit("fused_ln_ops", shape=list(LN_OPS), dtype="bfloat16", steps=steps,
         seconds=seconds, launches=counts, max_abs_err_vs_layer_norm=err,
         losses=[float(r[0].float().reshape(-1)[0]) for r in got],
         ops=[o.type for o in fused.global_block().ops], ok=ok)
    if counts["layer_norm"] != 2 * steps or not ok:
        raise AssertionError(f"fused_ln_ops: launches {counts}, errors {err}")
    return dict(launches=counts, layouts=kernels.layout_counts())


def _resnet_programs(cfg, batch_size, amp, lr=0.1):
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.models import resnet

    with unique_name.guard():
        return resnet.build_classifier_program(cfg, batch_size=batch_size,
                                               amp=amp, lr=lr)


def resnet_parity(dev, amp, tol, steps=3):
    """A tiny ResNet-50 (every stage's bottleneck once, 32x32 images, 10
    classes), batch 4, Momentum lr 0.01: ``steps`` steps on the card and
    on the CPU from one state and one batch, losses within rtol = atol =
    ``tol``. Then every parameter and running statistic after each step,
    the card starting that step from the CPU's state: batch norm over 4
    images amplifies the order of fp32 sums (cuDNN's against the CPU's),
    so two free runs drift apart over steps however right each step is.
    Each tensor within tol * max(1, max |CPU's|). The velocities, each
    step's raw gradient, are not held here: near a loss of 1e-2 the
    gradient through batch norm over 4 values cancels to a few 1e-4 of
    the velocity's scale on the card as on the CPU (tests/test_torch_resnet
    holds them against the reference from one state)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, scope_from_numpy
    from paddle_tpu_torch.models import resnet

    t0 = time.perf_counter()
    cfg = resnet.ResNetConfig(50, 10, (3, 32, 32), stages=[1, 1, 1, 1])
    main_prog, startup, _, fetches = _resnet_programs(cfg, 4, amp, lr=0.01)
    scope = Scope()
    Executor(device="cpu").run(startup, scope=scope)
    state = _state_arrays(scope)
    batch = resnet.synthetic_batch(cfg, 4, seed=1)
    fetch = [fetches["loss"], fetches["acc1"]]
    names = [v.name for v in main_prog.global_block().vars.values()
             if v.persistable and not v.name.endswith("_velocity_0")]
    card, cpu = Executor(device=dev), Executor(device="cpu")
    free_card, free_cpu = (scope_from_numpy(state, d) for d in (dev, "cpu"))
    kernels.reset_launch_counts()
    losses, worst, bad = [], {}, []
    for step in range(steps):
        # a copy: the optimizer ops update the CPU tensors in place
        before = scope_from_numpy(_state_arrays(free_cpu), "cpu")
        want = cpu.run(main_prog, feed=batch, scope=free_cpu,
                       fetch_list=fetch)
        got = card.run(main_prog, feed=batch, scope=free_card,
                       fetch_list=fetch)
        losses.append((float(got[0].reshape(-1)[0]),
                       float(want[0].reshape(-1)[0])))
        synced = scope_from_numpy(_state_arrays(before), dev)
        card.run(main_prog, feed=batch, scope=synced, fetch_list=fetch)
        for n in names:
            ref = free_cpu.find_var(n).float()
            err = float((synced.find_var(n).float().cpu() - ref).abs().max())
            worst[n] = max(worst.get(n, 0.0), err)
            if err > tol * max(1.0, float(ref.abs().max())):
                bad.append(f"step {step} {n}: {err}")
    counts = kernels.launch_counts()
    loss_gpu, loss_cpu = ([p[i] for p in losses] for i in (0, 1))
    ok = np.allclose(loss_gpu, loss_cpu, rtol=tol, atol=tol) and not bad
    top = sorted(worst, key=lambda n: -worst[n])[:3]
    emit("resnet_parity", amp=amp, batch=4, steps=steps,
         seconds=time.perf_counter() - t0, loss_gpu=loss_gpu,
         loss_cpu=loss_cpu, state_vars=len(names),
         largest_state_errors={n: worst[n] for n in top},
         outside_tolerance=bad[:10], tolerance=f"{tol}", launches=counts,
         ok=bool(ok))
    if not ok:
        raise AssertionError("resnet: card and CPU disagree")


def train_resnet50(dev, smi, timed=5):
    """ResNet-50 as the reference's benchmark trains it: 224x224, batch
    256, bf16 AMP, Momentum lr 0.1, fuse_bn_act_pass; not cut. Startup on
    the card, one warm-up step and profile_train.timed_modes (``timed``
    steps op by op, ``timed`` compiled, each leg from the warm-up's state)
    on one synthetic batch; then one more step, op by op, fetching the
    input of RES4_CONV for the real-layer conv check. In each leg finite
    losses, the last below the leg's first (_check_legs). No hand-written
    kernel is on this path: the reference runs its convs through XLA, the
    port through cuDNN."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.tools.profile_train import timed_modes

    cfg = resnet.resnet50()
    t0 = time.perf_counter()
    main_prog, startup, _, fetches = _resnet_programs(cfg, RESNET_BATCH,
                                                      amp=True)
    build_s = time.perf_counter() - t0
    ops = main_prog.global_block().ops
    exe = Executor(device=dev)
    scope = Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    batch = resnet.synthetic_batch(cfg, RESNET_BATCH, seed=0)
    feed = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    fetch = [fetches["loss"]]
    t0 = time.perf_counter()
    warm = exe.run(main_prog, feed=feed, scope=scope, fetch_list=fetch,
                   use_compiled=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    modes = timed_modes(exe, main_prog, feed, scope, fetch, timed)
    counts = modes["compiled"]["launches"]
    conv_op = next(o for o in ops if o.type == "conv2d" and
                   o.inputs["Filter"][0].startswith(RES4_CONV + "_w"))
    layer_in = exe.run(main_prog, feed=feed, scope=scope,
                       fetch_list=[conv_op.inputs["Input"][0]],
                       return_numpy=False, use_compiled=False)[0]
    exe.close()
    params = [scope.find_var(p.name) for p in main_prog.all_parameters()]
    finite = all(bool(torch.isfinite(p.float()).all()) for p in params)
    p50 = modes["compiled"]["step_ms_p50"]
    types = {}
    for o in ops:
        types[o.type] = types.get(o.type, 0) + 1
    emit("train_resnet50", model="resnet50", image=list(cfg.image_shape),
         batch=RESNET_BATCH, amp="bf16", optimizer="momentum lr 0.1 mu 0.9",
         fuse_bn_act=True, ops=len(ops), op_types=len(types),
         op_counts=types, startup_ops=len(startup.global_block().ops),
         parameters=len(params),
         parameter_elements=int(sum(p.numel() for p in params)),
         build_s=build_s, startup_s=startup_s, warmup_s=warm_s,
         warmup_loss=_loss(warm), modes=_per_mode(modes), step_ms_p50=p50, images_per_s=RESNET_BATCH / (p50 / 1e3),
         launches=counts, params_finite=finite, nvidia_smi=smi,
         note="step ms on the host clock, one synthetic batch; smoke "
              "figures, not a benchmark")
    _check_legs("train_resnet50", modes)
    if not finite:
        raise AssertionError("train_resnet50: a parameter is not finite")
    if len(ops) != 616 or len(types) != 17:
        raise AssertionError(f"train_resnet50: {len(ops)} ops of "
                             f"{len(types)} types")
    return dict(launches=counts, layouts=modes["compiled"]["layouts"]), \
        scope, layer_in


def check_conv_real_layer(dev, scope, layer_in):
    """The conv kernel at the shape and on the values of a real layer:
    the input of RES4_CONV from the ResNet-50 step (bf16 NCHW [256, 256,
    14, 14]), its filter in bf16, its BN running statistics folded into
    scale = bn_scale / sqrt(var + eps) and shift = bn_bias - mean *
    scale. Held against the port's own conv2d -> batch_norm(is_test) ->
    relu lowerings on the same values, (a) run in fp32 and rounded once:
    the bf16 tolerance; (b) run as the AMP program runs them, in bf16:
    within the sum of their roundings, 2^-6 (|a| (|conv| + |mean|) +
    |bias|) + 2^-7 |out| + 1e-3 elementwise, a = bn_scale / sqrt(var +
    eps) (four roundings of at most 2^-9 relative each, doubled)."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.kernels import conv_bn_relu as cbr
    from paddle_tpu_torch.tools import exp_conv
    from paddle_tpu_torch.tools.profile_layer_norm import graph_ms

    name = RES4_CONV
    w = scope.find_var(name + "_w")
    gamma, beta = scope.find_var(name + "_bn_scale"), \
        scope.find_var(name + "_bn_bias")
    mean, var = scope.find_var(name + "_bn_mean"), \
        scope.find_var(name + "_bn_var")
    x = layer_in.to(torch.bfloat16)
    wb = w.to(torch.bfloat16)
    a = gamma / torch.sqrt(var + 1e-5)
    shift = beta - mean * a
    xp = torch.nn.functional.pad(x.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1)) \
        .contiguous()
    w_hwio = wb.permute(2, 3, 1, 0).contiguous()
    a, shift = a.contiguous(), shift.contiguous()
    got = cbr.conv_bn_relu(xp, w_hwio, a, shift)
    got = got.permute(0, 3, 1, 2)
    # the device alone (CUDA-graph replays): the kernel, and cuDNN's conv
    # on the channels-last input with the same epilogue
    x_nhwc = x.permute(0, 2, 3, 1).contiguous()
    device_ms = graph_ms(lambda i: cbr.conv_bn_relu(xp, w_hwio, a, shift),
                         20)
    library_device_ms = graph_ms(lambda i: exp_conv.library_conv_bn_relu(
        x_nhwc, w_hwio, a, shift), 20)

    def chain(xx, ww):
        conv = registry.get("conv2d").forward(
            {"Input": [xx], "Filter": [ww]},
            {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
             "groups": 1})["Output"]
        bn = registry.get("batch_norm").forward(
            {"X": [conv], "Scale": [gamma], "Bias": [beta], "Mean": [mean],
             "Variance": [var]}, {"is_test": True, "epsilon": 1e-5})["Y"]
        return conv, registry.get("relu").forward({"X": [bn]}, {})["Out"]

    with torch.no_grad():
        conv32, ref32 = chain(x.float(), wb.float())
        _, ref16 = chain(x, wb)
    torch.cuda.synchronize()
    ok32 = torch.allclose(got.float(), ref32.to(torch.bfloat16).float(),
                          **BF16_TOL)
    bshape = (1, -1, 1, 1)
    bound = 2 ** -6 * (a.abs().reshape(bshape) * (
        conv32.abs() + mean.abs().reshape(bshape))
        + beta.abs().reshape(bshape)) + 2 ** -7 * ref32.abs() + 1e-3
    diff16 = (got.float() - ref16.float()).abs()
    ok16 = bool((diff16 <= bound).all())
    emit("check_conv_real_layer", layer=name, input_shape=list(x.shape),
         max_abs_err_vs_fp32_ops=errors(got, ref32.to(torch.bfloat16))[0],
         max_abs_err_vs_bf16_ops=float(diff16.max()),
         worst_share_of_bf16_bound=float((diff16 / bound).max()),
         relu_kept_share=float((ref32 > 0).float().mean()),
         device_ms=device_ms, library_device_ms=library_device_ms,
         ok=bool(ok32 and ok16))
    if not (ok32 and ok16):
        raise AssertionError(f"conv kernel on {name}: fp32 ops {ok32}, "
                             f"bf16 ops {ok16}")


# ---------------------------------------------------------------------------
# the micro-batching inference plane: BERT-base behind the predictor
# ---------------------------------------------------------------------------

# BERT-base (models/bert.py bert_base(): vocab 30522, hidden 768, 12
# layers, 12 heads of 64, FFN 3072, 512 positions, fp32) served as a
# sentence classifier: its inference program pruned to the NSP logits, at
# s128. The engine pads batches to BERT_INFER_BUCKETS rows.
BERT_INFER_SEQ = 128
BERT_INFER_BUCKETS = (1, 2, 4, 8, 16, 32)
BERT_INFER_FEEDS = ("src_ids", "sent_ids", "pos_ids", "input_mask")
BERT_INFER_FETCH = "fc_0.tmp_1"
# 64 requests of 1-4 rows from 16 client threads; 8 of them also on the
# CPU predictor; the cluster's closed loop runs 8 clients
BERT_INFER_REQUESTS, BERT_INFER_CLIENTS, BERT_INFER_CPU = 64, 16, 8
BERT_INFER_LOOP_CLIENTS = 8
# after the burst the 16 clients send the requests round and round for
# this long (closed loop): the engine's steady rate
BERT_INFER_STEADY_S = 4.0
# the reference's promise is each response bit for bit the unbatched run
# of its rows; where the library's GEMMs differ by M it cannot hold, and
# the gate is the run of the rows padded to the served bucket bit for bit
# and the unbatched run within this, with the same argmax
BATCH_INVARIANCE_TOL = 1e-5


def _bert_infer_dir(dev, seed, path):
    """BERT-base's inference dir, built by the port under a fresh name
    generator: the startup program
    on the card with the op seeds it would hold had it been built with
    random_seed = seed (each is drawn at build time as random_seed *
    1000003 + a counter), saved with io.save_inference_model. Returns
    (config, seconds)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import io
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.models import bert

    t0 = time.perf_counter()
    cfg = bert.bert_base()
    # a fresh name generator: the NSP logits are fc_0.tmp_1 in every dir
    old = unique_name.switch()
    try:
        main, startup, _, _ = bert.build_pretraining_program(
            cfg, seq_len=BERT_INFER_SEQ, with_optimizer=False, is_test=True)
    finally:
        unique_name.switch(old)
    for op in startup.global_block().ops:
        if op.attrs.get("seed"):
            op.attrs["seed"] = int(op.attrs["seed"]) + seed * 1000003
    scope = ptt.Scope()
    ptt.Executor(dev).run(startup, scope=scope, use_compiled=False)
    io.save_inference_model(path, list(BERT_INFER_FEEDS), [BERT_INFER_FETCH],
                            main_program=main, scope=scope)
    del scope
    _release()
    return cfg, time.perf_counter() - t0


def _bert_infer_requests(cfg):
    """64 requests of 1-4 rows; each row's real length 16-128 tokens
    (input_mask 1 there, ids and segments 0 past it), from seed 0."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(BERT_INFER_REQUESTS):
        n = int(rng.randint(1, 5))
        mask = np.arange(BERT_INFER_SEQ)[None, :] < \
            rng.randint(16, BERT_INFER_SEQ + 1, n)[:, None]
        out.append({
            "src_ids": (rng.randint(1, cfg.vocab_size, (n, BERT_INFER_SEQ))
                        * mask).astype(np.int64),
            "sent_ids": (rng.randint(0, 2, (n, BERT_INFER_SEQ)) * mask)
            .astype(np.int64),
            "pos_ids": np.tile(np.arange(BERT_INFER_SEQ), (n, 1))
            .astype(np.int64),
            "input_mask": mask.astype(np.float32)})
    return out


def _padded(feed, bucket):
    rows = len(feed["input_mask"])
    return {k: np.concatenate([v, np.zeros((bucket - rows,) + v.shape[1:],
                                           v.dtype)]) for k, v in feed.items()}


def _served_check(pred, feed, got, memo=None):
    """Hold one response to the predictor: the smallest bucket whose run
    of the request's rows padded with zero rows it equals bit for bit
    (None: none does), whether it equals the unbatched run bit for bit,
    its largest difference from that run and whether the argmax (the
    predicted class) agrees. ``memo`` keeps the predictor's outputs for
    a request sent many times ((predictor, request) -> {rows: output})."""
    rows = len(feed["input_mask"])
    runs = {} if memo is None else memo.setdefault((id(pred), id(feed)), {})

    def run(b):
        if b not in runs:
            runs[b] = pred.run(feed if b == rows else _padded(feed, b))[0][
                :rows]
        return runs[b]

    alone = run(rows)
    bucket = next((b for b in BERT_INFER_BUCKETS if b >= rows and
                   got.tobytes() == run(b).tobytes()), None)
    return dict(bucket=bucket, bitwise_alone=got.tobytes() == alone.tobytes(),
                max_abs_alone=float(np.abs(got - alone).max()),
                argmax_same=bool((got.argmax(1) == alone.argmax(1)).all()))


def _gate_served(phase, checks):
    """Each response bit for bit a padded-bucket run of its rows, within
    BATCH_INVARIANCE_TOL of the unbatched run with the same argmax; and
    the counts that say whether the reference's stricter promise held."""
    bad = [i for i, c in enumerate(checks) if c["bucket"] is None
           or c["max_abs_alone"] > BATCH_INVARIANCE_TOL
           or not c["argmax_same"]]
    if bad:
        raise AssertionError(f"{phase}: responses {bad} fail the batch "
                             f"gate: {[checks[i] for i in bad[:4]]}")
    return dict(responses=len(checks),
                bitwise_equal_unbatched=sum(c["bitwise_alone"]
                                            for c in checks),
                max_abs_vs_unbatched=max(c["max_abs_alone"] for c in checks))


def _batch_invariance_probe(pred):
    """Where the engine's batch breaks the bit-for-bit promise: the fc
    lowering with the first layer's Q projection ([768, 768] + bias) on
    the same 128 rows at M = 128 * b (b a bucket), and the pooler's fc
    (M = b), each against its own M = the one-row case; the largest
    difference at each M."""
    from paddle_tpu_torch.core import registry

    fc = registry.get("fc").forward
    out = {}
    g = torch.Generator(device=pred.device).manual_seed(7)
    for w, b, m1 in (("layer_0_attn_q_w", "layer_0_attn_q_b",
                      BERT_INFER_SEQ), ("pooler_w", "pooler_b", 1)):
        w_, b_ = pred._params[w], pred._params[b]
        x = torch.randn(BERT_INFER_BUCKETS[-1] * m1, w_.shape[0],
                        device=pred.device, generator=g)
        one = fc({"Input": [x[:m1]], "W": [w_], "Bias": [b_]},
                 {"in_num_col_dims": 1})["Out"]
        out[w] = {}
        for bk in BERT_INFER_BUCKETS:
            many = fc({"Input": [x[:bk * m1]], "W": [w_], "Bias": [b_]},
                      {"in_num_col_dims": 1})["Out"][:m1]
            out[w][f"M={bk * m1}"] = float((many - one).abs().max())
    return out


def check_flash_bert_infer(dev, results):
    """The flash forward as the inference path runs it: BERT-base's bnsd
    heads (12 of 64, S = 128), fp32 (split TF32), the [B,S] key bias of
    ragged lengths, no dropout; at B = 8 and 32 (the engine's buckets),
    against its plain version, timed beside SDPA. The timed calls rotate
    through copies of q, k, v and the bias, more than the 50 MB L2 in
    all, so each call reads its inputs from HBM."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    n, hd, s = 12, 64, BERT_INFER_SEQ
    scale = hd ** -0.5
    for b in (8, 32):
        g = torch.Generator(device=dev).manual_seed(b)
        reps = max(2, -(-(64 << 20) // (3 * b * n * s * hd * 4)))
        sets = []
        for _ in range(reps):
            q, k, v = (torch.randn(b, n, s, hd, device=dev, generator=g)
                       for _ in range(3))
            lens = torch.randint(16, s + 1, (b, 1), device=dev, generator=g)
            bias = torch.where(torch.arange(s, device=dev)[None, :] < lens,
                               0.0, -1e4)
            sets.append((q, k, v, bias, bias[:, None, None, :]))
        q, k, v, bias, _ = sets[0]
        out, lse = fa.flash_fwd(q, k, v, n, scale, False, bias, 0.0, 0,
                                "bnsd")
        ref_out, ref_lse = fa.plain_flash_fwd(q, k, v, n, scale, False, bias,
                                              0.0, 0, "bnsd")
        torch.cuda.synchronize()
        e_out, r_out = errors(out, ref_out)
        e_lse, _ = errors(lse, ref_lse)
        if not (torch.allclose(out, ref_out, rtol=1e-4, atol=1e-5)
                and torch.allclose(lse, ref_lse, rtol=1e-5, atol=1e-4)):
            raise AssertionError(f"flash forward BERT-base B={b}: out err "
                                 f"{e_out}, lse err {e_lse}")

        def kernel(i):
            q_, k_, v_, bias_, _ = sets[i % reps]
            return fa.flash_fwd(q_, k_, v_, n, scale, False, bias_, 0.0, 0,
                                "bnsd")

        def sdpa(i):
            q_, k_, v_, _, mask_ = sets[i % reps]
            return F.scaled_dot_product_attention(q_, k_, v_,
                                                  attn_mask=mask_,
                                                  scale=scale)

        def plain(i):
            q_, k_, v_, bias_, _ = sets[i % reps]
            return fa.plain_flash_fwd(q_, k_, v_, n, scale, False, bias_,
                                      0.0, 0, "bnsd")

        nbytes = 4 * (4 * q.numel() + bias.numel() + lse.numel())
        flops = b * n * 2 * 2 * s * s * hd
        bms, by = bound_ms(nbytes, flops, TF32X3_FLOPS_PER_S)
        results.append(with_device_ms(dict(
            name="flash_attention_fwd",
            shape=f"B={b} S={s} n={n} hd=64 bias fp32 bnsd (BERT-base "
                  f"inference)", instance="fp32_tf32x3",
            max_abs_err=max(e_out, e_lse), max_rel_err=r_out,
            ms=events_ms(kernel, 20), plain_ms=events_ms(plain, 5),
            library_ms=events_ms(sdpa, 20), bound_ms=bms, bound_by=by,
            bound_ms_cuda_cores=bound_ms(nbytes, flops)[0],
            input_copies=reps), kernel, sdpa))
        del sets
    torch.cuda.empty_cache()


def check_flash_to_static(dev, results):
    """Both flash kernels as the @to_static BERT-base step runs them:
    bnsd, 12 heads of 64, S = 128, B = 64, fp32 (split TF32), the [B,S]
    key bias of ragged lengths, no dropout (the 2.0 network drops the
    attention's output): against their plain versions, timed beside
    SDPA's forward and backward, with their bounds."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    b, n, hd, s = DY_BATCH, 12, 64, DY_SEQ
    g = torch.Generator(device=dev).manual_seed(64)
    q, k, v, do = (torch.randn(b, n, s, hd, device=dev, generator=g)
                   for _ in range(4))
    lens = torch.randint(s // 2, s + 1, (b, 1), device=dev, generator=g)
    bias = torch.where(torch.arange(s, device=dev)[None, :] < lens, 0.0,
                       -1e4)
    scale = hd ** -0.5
    out, lse = fa.flash_fwd(q, k, v, n, scale, False, bias, 0.0, 0, "bnsd")
    r_out, r_lse = fa.plain_flash_fwd(q, k, v, n, scale, False, bias, 0.0,
                                      0, "bnsd")
    got = fa.flash_bwd(q, k, v, r_out, r_lse, do, n, scale, False, bias,
                       0.0, 0, "bnsd")
    ref = fa.plain_flash_bwd(q, k, v, r_out, r_lse, do, n, scale, False,
                             bias, 0.0, 0, "bnsd")
    torch.cuda.synchronize()
    tol = TRAIN_TOL[torch.float32]
    err = {"out": errors(out, r_out)[0], "lse": errors(lse, r_lse)[0]}
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        err[name] = errors(a, r)[0]
        if not torch.allclose(a, r, **tol):
            raise AssertionError(f"flash backward @to_static {name}: "
                                 f"{errors(a, r)}")
    if not (torch.allclose(out, r_out, **tol)
            and torch.allclose(lse, r_lse, rtol=1e-5, atol=1e-4)):
        raise AssertionError(f"flash forward @to_static: {err}")
    fwd, bwd = _time_flash_nodrop(fa, q, k, v, do, bias, n, scale, r_out,
                                  r_lse)
    shape = (f"B={b} S={s} n={n} hd={hd} bias fp32 bnsd (@to_static "
             f"BERT-base)")
    for name, keys, timing in (
            ("flash_attention_fwd", ("out", "lse"), fwd),
            ("flash_attention_bwd", ("dq", "dk", "dv"), bwd)):
        results.append(dict(name=name, shape=shape, instance="fp32_tf32x3",
                            max_abs_err=max(err[k_] for k_ in keys),
                            max_rel_err=None,
                            errors={k_: err[k_] for k_ in keys}, **timing))


def _time_flash_nodrop(fa, q, k, v, do, bias, n, scale, out, lse):
    """(forward, backward) timings of the bnsd fp32 kernels without
    dropout under a [B,S] key bias: kernel ms, plain ms, SDPA's ms (its
    backward through autograd, its device time from torch.profiler: it
    does not capture), the bound at the split-TF32 rate (the CUDA-core
    bound beside it) and the device-only times."""
    import torch.nn.functional as F

    b, _, s, hd = q.shape
    mask = bias[:, None, None, :]
    q4, k4, v4 = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                        scale=scale)

    def kfwd(i):
        return fa.flash_fwd(q, k, v, n, scale, False, bias, 0.0, 0, "bnsd")

    def kbwd(i):
        return fa.flash_bwd(q, k, v, out, lse, do, n, scale, False, bias,
                            0.0, 0, "bnsd")

    def sdpa(i):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              scale=scale)

    def sdpa_bwd(i):
        return torch.autograd.grad(o4, (q4, k4, v4), do, retain_graph=True)

    nb, pairs, heads = q.numel() * 4, s * s, b * n
    rows = []
    for kern, plain, lib, io, flops, graph in (
            (kfwd, lambda i: fa.plain_flash_fwd(q, k, v, n, scale, False,
                                                bias, 0.0, 0, "bnsd"),
             sdpa, 4 * nb + bias.numel() * 4 + lse.numel() * 4,
             heads * 2 * 2 * pairs * hd, True),
            (kbwd, lambda i: fa.plain_flash_bwd(q, k, v, out, lse, do, n,
                                                scale, False, bias, 0.0, 0,
                                                "bnsd"),
             sdpa_bwd, 8 * nb + lse.numel() * 4 + bias.numel() * 4,
             heads * 5 * 2 * pairs * hd, False)):
        row = dict(ms=events_ms(kern, 20), plain_ms=events_ms(plain, 3),
                   library_ms=events_ms(lib, 20))
        row["bound_ms"], row["bound_by"] = bound_ms(io, flops,
                                                    TF32X3_FLOPS_PER_S)
        row["bound_ms_cuda_cores"] = bound_ms(io, flops)[0]
        with_device_ms(row, kern, (lambda: lib(0)) if not graph else lib,
                       library_graph=graph)
        rows.append(row)
    return rows


def _infer_counts():
    """The launch counters a phase reports: every kernel, the flash
    kernels by layout and by dtype instance."""
    from paddle_tpu_torch import kernels

    return dict(launches=kernels.launch_counts(),
                layouts=kernels.layout_counts(),
                dtypes=kernels.dtype_counts())


def _gate_flash_per_batch(phase, counts, batches, layers):
    """layers flash forward launches a batch, every one bnsd on the fp32
    split-TF32 instance, and no other kernel."""
    want = layers * batches
    fwd = counts["launches"]["flash_attention_fwd"]
    others = {k: n for k, n in counts["launches"].items()
              if k != "flash_attention_fwd" and n}
    if not batches or fwd != want or others or \
            counts["layouts"]["flash_attention_fwd"]["bnsd"] != want or \
            counts["dtypes"]["flash_attention_fwd"]["fp32_tf32x3"] != want:
        raise AssertionError(f"{phase}: {batches} batches want {want} bnsd "
                             f"fp32 flash forward launches, got {counts}")


def infer_bert_base(dev, model_dir, cfg, reqs):
    """create_predictor over BERT-base's dir on the card (the seven
    passes: one bnsd flash_attention a layer), a ServingEngine with
    max_batch_size 32 and every bucket warmed (captured) at start(), and
    the 64 requests from 16 client threads through LocalClient. Gates:
    each response bit for bit the predictor's run of its rows padded to a
    bucket, within 1e-5 of its unbatched run with the same argmax; a CPU
    predictor over the same dir within 1e-4 with the same argmax on 8 of
    them; 12 flash forward launches a batch, bnsd, fp32, nothing else,
    and a traced bucket-32 batch's flash kernels as many as its counters
    add; every parameter on the card."""
    import collections

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
    from paddle_tpu_torch.serving import (LocalClient, ServingConfig,
                                          ServingEngine)
    from paddle_tpu_torch.tools.profile_train import traced

    phase = "infer_bert_base"
    t_phase = time.perf_counter()
    layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    pred = create_predictor(AnalysisConfig(model_dir), device=dev)
    load_s = time.perf_counter() - t0
    ops = collections.Counter(o.type for o in pred.program.global_block().ops)
    if ops["flash_attention"] != layers or ops["dropout"] or ops["softmax"]:
        raise AssertionError(f"{phase}: passes left {dict(ops)}")
    on_card = all(v.device == dev for v in pred._params.values()
                  if isinstance(v, torch.Tensor))
    engine = ServingEngine(pred, ServingConfig(
        max_batch_size=BERT_INFER_BUCKETS[-1], buckets=BERT_INFER_BUCKETS))
    t0 = time.perf_counter()
    engine.start()
    warmup_s = time.perf_counter() - t0
    client = LocalClient(engine)
    fetch = engine.fetch_names[0]
    kernels.reset_launch_counts()
    telemetry.reset()
    outs, ms = [None] * len(reqs), [None] * len(reqs)

    def worker(w):
        for i in range(w, len(reqs), BERT_INFER_CLIENTS):
            t = time.perf_counter()
            outs[i] = client.infer(reqs[i], timeout=600)[fetch]
            ms[i] = (time.perf_counter() - t) * 1e3

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(BERT_INFER_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    counts = _infer_counts()
    stats = engine.stats()
    fill = telemetry.snapshot()["hists"]["serving.batch_fill"]
    steady = _steady_loop(engine, client, reqs, outs)
    engine.close(drain=True, timeout=60)
    if any(o is None for o in outs):
        raise AssertionError(f"{phase}: a request never returned")
    batches = stats["batches"]
    _gate_flash_per_batch(phase, counts, batches, layers)
    checks = [_served_check(pred, r, o) for r, o in zip(reqs, outs)]
    served = _gate_served(phase, checks)
    # a replayed bucket-32 batch under torch.profiler
    full = _padded(reqs[0], BERT_INFER_BUCKETS[-1])
    kernels.reset_launch_counts()
    trace = traced(lambda: pred.run(full), 1)
    if trace["traced_launches"]["flash_attention_fwd"] != layers or \
            kernels.launch_counts()["flash_attention_fwd"] != layers:
        raise AssertionError(f"{phase}: traced batch ran "
                             f"{trace['traced_launches']}, counters "
                             f"{kernels.launch_counts()}")
    # the predictor a bucket: host ms of run(), the graph's replay alone
    per_bucket = {}
    for b in BERT_INFER_BUCKETS:
        feed = _padded(reqs[0], b)
        times = []
        for _ in range(10):
            t = time.perf_counter()
            pred.run(feed)
            times.append((time.perf_counter() - t) * 1e3)
        graph = next(e for s_, e in pred._cache.items()
                     if s_[0][1][0] == b).graph.graph
        per_bucket[b] = {"run_ms_p50": _pct(times, 0.5),
                         "replay_ms": events_ms(lambda i: graph.replay(), 10)}
    probe = _batch_invariance_probe(pred)
    # the CPU predictor over the same dir
    cpu = create_predictor(AnalysisConfig(model_dir), device="cpu")
    cpu_err, cpu_argmax = 0.0, True
    for r, o in list(zip(reqs, outs))[:BERT_INFER_CPU]:
        c, = cpu.run(r)
        cpu_err = max(cpu_err, float(np.abs(c - o).max()))
        cpu_argmax = cpu_argmax and bool((c.argmax(1) == o.argmax(1)).all())
    del cpu
    rows = sum(len(r["input_mask"]) for r in reqs)
    emit(phase, requests=len(reqs), rows=rows, clients=BERT_INFER_CLIENTS,
         load_s=load_s, warmup_s=warmup_s, wall_s=wall,
         burst_rows_per_s=rows / wall, steady=steady,
         request_ms_p50=_pct(ms, 0.5), request_ms_p99=_pct(ms, 0.99),
         engine_request_ms=stats.get("request_ms"),
         batch_ms=stats.get("batch_ms"), batches=batches,
         batch_fill_avg=fill["avg"], padded_rows=stats.get("padded_rows", 0),
         predictor_by_bucket=per_bucket, served=served,
         batch_invariance_fc=probe, cpu_max_abs=cpu_err,
         cpu_argmax_same=cpu_argmax, params_on_card=on_card,
         pass_op_counts=dict(ops), traced_bucket32={
             k: trace[k] for k in ("traced_wall_ms", "device_busy_ms",
                                   "device_idle_share", "traced_launches",
                                   "device_ms_by_kernel_class")},
         traced_bucket32_top_kernels=trace["top_kernels"][:6],
         launches=counts["launches"],
         flash_launches_by_layout=counts["layouts"],
         seconds=time.perf_counter() - t_phase)
    if not on_card or cpu_err > 1e-4 or not cpu_argmax:
        raise AssertionError(f"{phase}: params on the card {on_card}, CPU "
                             f"predictor max abs {cpu_err}, argmax same "
                             f"{cpu_argmax}")
    del engine, pred
    _release()
    return dict(counts, outs=outs)


def _steady_loop(engine, client, reqs, want):
    """BERT_INFER_CLIENTS clients send reqs round and round through
    LocalClient for BERT_INFER_STEADY_S (closed loop). Each answer must be
    within BATCH_INVARIANCE_TOL of the burst's answer to the same request
    (want) with the same argmax. Returns the rows/s over the window, from
    the first send to the last answer, and its request ms."""
    fetch = engine.fetch_names[0]
    batches0 = engine.stats()["batches"]
    done, answers, bad = threading.Event(), [], []

    def worker(w):
        i = w
        while not done.is_set():
            t = time.perf_counter()
            try:
                got = client.infer(reqs[i], timeout=600)[fetch]
            except Exception as e:  # noqa: BLE001 - the gate reports it
                bad.append((i, repr(e)))
                return
            answers.append((i, t, time.perf_counter()))
            if float(np.abs(got - want[i]).max()) > BATCH_INVARIANCE_TOL \
                    or not (got.argmax(1) == want[i].argmax(1)).all():
                bad.append(i)
            i = (i + BERT_INFER_CLIENTS) % len(reqs)

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(BERT_INFER_CLIENTS)]
    for t in threads:
        t.start()
    time.sleep(BERT_INFER_STEADY_S)
    done.set()
    for t in threads:
        t.join(timeout=300)
    if bad or any(t.is_alive() for t in threads):
        raise AssertionError(f"steady loop: {len(bad)} answers off the "
                             f"burst's, requests {bad[:5]}")
    window = max(a[2] for a in answers) - min(a[1] for a in answers)
    rows = sum(len(reqs[i]["input_mask"]) for i, _, _ in answers)
    ms = [(t1 - t) * 1e3 for _, t, t1 in answers]
    return dict(seconds=window, requests=len(answers), rows=rows,
                rows_per_s=rows / window,
                batches=engine.stats()["batches"] - batches0,
                request_ms_p50=_pct(ms, 0.5), request_ms_p99=_pct(ms, 0.99))


def infer_http_bert_base(dev, model_dir, cfg, reqs, want):
    """serve(model_dir) on the card; the same 64 requests POSTed to
    /v1/infer at once. Gates: every answer 200 with model_version 0; its
    logits bit for bit the predictor's run of its rows padded to a
    bucket, within 1e-5 of infer_bert_base's with the same argmax (the
    count bit for bit equal to infer_bert_base's is printed); 12 flash
    forward launches a batch. Prints the request wall over HTTP beside the
    engine's serving.request_ms and serve()'s start."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.serving import ServingConfig, serve

    phase = "infer_http_bert_base"
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    srv = serve(model_dir, device=dev, config=ServingConfig(
        max_batch_size=BERT_INFER_BUCKETS[-1], buckets=BERT_INFER_BUCKETS))
    start_s = time.perf_counter() - t0
    answers = [None] * len(reqs)
    try:
        kernels.reset_launch_counts()
        telemetry.reset()

        def one(i):
            t = time.perf_counter()
            body = {"inputs": {k: v.tolist() for k, v in reqs[i].items()}}
            code, doc = _http("POST", srv.url, "/v1/infer", body)
            answers[i] = (code, doc, (time.perf_counter() - t) * 1e3)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        counts = _infer_counts()
        stats = srv.engine.stats()
        pred = srv.engine.predictor
    finally:
        srv.shutdown()
        srv.engine.close(drain=True, timeout=60)
    if any(a is None for a in answers) or any(a[0] != 200 or a[1].get("model_version") != 0
                              for a in answers):
        raise AssertionError(f"{phase}: answers {[a and a[0] for a in answers]}")
    fetch = srv.engine.fetch_names[0]
    got = [np.asarray(a[1]["outputs"][fetch], np.float32) for a in answers]
    checks = [_served_check(pred, r, g) for r, g in zip(reqs, got)]
    served = _gate_served(phase, checks)
    vs_inproc = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    same_ids = all((g.argmax(1) == w.argmax(1)).all()
                   for g, w in zip(got, want))
    _gate_flash_per_batch(phase, counts, stats["batches"],
                          cfg.num_hidden_layers)
    ms = [a[2] for a in answers]
    emit(phase, requests=len(reqs), start_s=start_s, wall_s=wall,
         request_ms_p50=_pct(ms, 0.5), request_ms_p99=_pct(ms, 0.99),
         engine_request_ms=stats.get("request_ms"), batches=stats["batches"],
         served=served, bitwise_equal_in_process=sum(
             g.tobytes() == w.tobytes() for g, w in zip(got, want)),
         max_abs_vs_in_process=vs_inproc, ids_equal_in_process=same_ids,
         launches=counts["launches"], seconds=time.perf_counter() - t_phase)
    if vs_inproc > BATCH_INVARIANCE_TOL or not same_ids:
        raise AssertionError(f"{phase}: logits {vs_inproc} from "
                             f"infer_bert_base's, ids equal {same_ids}")
    del srv, pred
    _release()
    return counts


def _replica_stats(cluster):
    """{replica: its /v1/stats} of a predictor fleet."""
    out = {}
    for r in cluster.replicas:
        code, doc = _http("GET", r.url, "/v1/stats", timeout=60)
        if code != 200:
            raise AssertionError(f"/v1/stats of {r.name}: {code} {doc}")
        out[r.name] = doc
    return out


def _stats_delta(before, after):
    """The launches between two /v1/stats reads of each replica, summed
    over the replicas: {launches, layouts, dtypes}."""
    name0 = next(iter(after))
    out = {k: {n: {} if isinstance(c, dict) else 0
               for n, c in after[name0][k].items()}
           for k in ("kernels", "kernel_layouts", "kernel_dtypes")}
    for name, a in after.items():
        for k, split in out.items():
            for n in split:
                if isinstance(a[k][n], dict):
                    for key, c in a[k][n].items():
                        split[n][key] = split[n].get(key, 0) + c - \
                            before[name][k][n].get(key, 0)
                else:
                    split[n] += a[k][n] - before[name][k][n]
    return dict(launches=out["kernels"], layouts=out["kernel_layouts"],
                dtypes=out["kernel_dtypes"])


def infer_cluster_swap(dev, cfg, dirs, reqs):
    """A models root with model-000001 (dirs[1]) behind two replica
    processes (python -m paddle_tpu_torch.serving.replica --model-root
    ROOT --device cuda) and the router; 8 clients send the 64 requests
    round and round through the router (closed loop); after 2 s
    model-000002 (dirs[2], another seed) is published and the watcher
    rolls it onto the fleet; the clients go on 2 s past the roll. Gates:
    no request fails; every answer names a version and is bit for bit a
    padded-bucket run of that version's predictor (in this process), within
    1e-5 of its unbatched run with the same argmax; both versions
    answered; at most one replica not ready at any probe; both replicas
    report version 2 afterwards; the replicas' flash forward launches
    (their /v1/stats just before and after the traffic) are 12 a batch
    plus 12 for each bucket each swap warmed."""
    import collections
    import shutil
    import tempfile

    from paddle_tpu_torch import checkpoint
    from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
    from paddle_tpu_torch.serving import ClusterController, ServingConfig

    phase = "infer_cluster_swap"
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="models_", dir=SERVING_DIR)
    refs = {v: create_predictor(AnalysisConfig(d), device=dev)
            for v, d in dirs.items()}
    checkpoint.publish_model(root, dirs[1])
    cluster = ClusterController(
        root, replicas=2, device=str(dev), model_poll_s=0.5,
        serving_config=ServingConfig(max_batch_size=BERT_INFER_BUCKETS[-1]),
        replica_env=_replica_env(serving_buckets=",".join(
            map(str, BERT_INFER_BUCKETS))),
        replica_ready_timeout_s=300)
    t0 = time.perf_counter()
    cluster.start(ready_timeout_s=300)
    up_s = time.perf_counter() - t0
    answers, not_ready, done = [], [], threading.Event()
    t_pub = t_rolled = None
    try:
        before = _replica_stats(cluster)

        def client(c):
            i = c
            while not done.is_set():
                t = time.perf_counter()
                body = {"inputs": {k: v.tolist()
                                   for k, v in reqs[i].items()}}
                try:
                    code, doc = _http("POST", cluster.url, "/v1/infer", body,
                                      timeout=120)
                except OSError as e:
                    code, doc = -1, {"error": repr(e)}
                answers.append((i, code, doc, t, time.perf_counter()))
                i = (i + BERT_INFER_LOOP_CLIENTS) % len(reqs)

        def health():
            while not done.is_set():
                codes = []
                for r in cluster.replicas:
                    try:
                        codes.append(_http("GET", r.url, "/healthz",
                                           timeout=10)[0])
                    except OSError:
                        codes.append(-1)
                not_ready.append(sum(c != 200 for c in codes))
                time.sleep(0.05)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(BERT_INFER_LOOP_CLIENTS)]
        threads.append(threading.Thread(target=health))
        for t in threads:
            t.start()
        time.sleep(2.0)
        t_pub = time.perf_counter()
        checkpoint.publish_model(root, dirs[2])
        publish_s = time.perf_counter() - t_pub
        deadline = time.monotonic() + 300
        while cluster.current_version != 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        t_rolled = time.perf_counter()
        time.sleep(2.0)
        done.set()
        for t in threads:
            t.join(timeout=300)
        after = _replica_stats(cluster)
    finally:
        done.set()
        cluster.close()
        shutil.rmtree(root, ignore_errors=True)
    failed = [(a[1], a[2]) for a in answers if a[1] != 200]
    if failed or cluster.current_version != 2:
        raise AssertionError(f"{phase}: {len(failed)} failed requests "
                             f"{failed[:3]}, fleet at version "
                             f"{cluster.current_version}")
    fetch = refs[1].fetch_names[0]
    checks, versions, memo = [], collections.Counter(), {}
    for i, _, doc, _, _ in answers:
        v = doc.get("model_version")
        versions[v] += 1
        if v not in refs:
            raise AssertionError(f"{phase}: an answer names version {v}")
        checks.append(_served_check(refs[v], reqs[i], np.asarray(
            doc["outputs"][fetch], np.float32), memo))
    served = _gate_served(phase, checks)
    # the replicas' launches between the two reads, summed
    counts = _stats_delta(before, after)
    batches = sum(a["batches"] - before[n].get("batches", 0)
                  for n, a in after.items())
    swaps = sum(a.get("swaps", 0) - before[n].get("swaps", 0)
                for n, a in after.items())
    during = [(t1 - t) * 1e3 for _, _, _, t, t1 in answers
              if t1 >= t_pub and t <= t_rolled]
    all_ms = [(t1 - t) * 1e3 for _, _, _, t, t1 in answers]
    # the closed loop's rate through the router, first send to last answer
    loop_s = max(a[4] for a in answers) - min(a[3] for a in answers)
    loop_rows = sum(len(reqs[a[0]]["input_mask"]) for a in answers)
    final_versions = sorted(d["model_version"] for d in after.values())
    emit(phase, replicas=len(after), up_s=up_s, publish_s=publish_s,
         roll_s=t_rolled - t_pub, requests=len(answers),
         loop_s=loop_s, rows=loop_rows, rows_per_s=loop_rows / loop_s,
         answers_by_version=dict(versions), served=served,
         max_not_ready=max(not_ready), health_probes=len(not_ready),
         request_ms_p50=_pct(all_ms, 0.5), request_ms_p99=_pct(all_ms, 0.99),
         roll_request_ms_p50=_pct(during, 0.5) if during else None,
         roll_request_ms_p99=_pct(during, 0.99) if during else None,
         requests_during_roll=len(during), batches=batches, swaps=swaps,
         launches=counts["launches"],
         flash_launches_by_layout=counts["layouts"],
         replica_versions=final_versions,
         seconds=time.perf_counter() - t_phase)
    if set(versions) != {1, 2} or max(not_ready) > 1 or \
            final_versions != [2, 2] or swaps != 2:
        for r in cluster.replicas:
            print(f"--- {r.name} output tail:\n" + "\n".join(
                list(r.log_tail)[-30:]), file=sys.stderr)
        raise AssertionError(f"{phase}: swap errors {cluster.swap_errors}, "
                             f"versions {dict(versions)}, most "
                             f"replicas not ready at once {max(not_ready)}, "
                             f"replicas at {final_versions}, swaps {swaps}")
    # 12 a batch, and 12 for each bucket each swap warmed (its first,
    # op-by-op run; the capture adds none)
    _gate_flash_per_batch(phase, counts, batches + swaps * len(
        BERT_INFER_BUCKETS), cfg.num_hidden_layers)
    del refs
    _release()
    return counts


# ---------------------------------------------------------------------------
# the int8 serving path: PTQ, both int8_matmul modes, elastic scaling and
# the autotuner's online trial (BERT-base, full width)
# ---------------------------------------------------------------------------

# BERT-base's int8 GEMMs at the int8 phases' buckets (M = B * 128): the
# three projection shapes; then the pooler (M = B, 768 -> 768) and the
# 2-wide NSP classifier
INT8_INFER_BUCKETS = (8, 32)
INT8_BERT_SHAPES = tuple((b * BERT_INFER_SEQ, k, n)
                         for b in INT8_INFER_BUCKETS
                         for k, n in ((768, 768), (768, 3072), (3072, 768))) \
    + tuple((b, 768, n) for b in INT8_INFER_BUCKETS for n in (768, 2))
INT8_TOPS = 1979e12            # H100 SXM data sheet, dense int8 tensor cores
# PTQ calibration: INT8_CALIB_BATCHES seeded batches of 8 rows
INT8_CALIB_BATCHES = 4
# weight-only logits against the same program with plain_int8_gemm in
# place of the kernel: the kernel carries fp32 activations as three bf16
# pieces (error ~2^-24 of each product, as the fp32 one) and sums K in
# another order; over 12 layers that stays far below 1e-3
INT8_PLAIN_TOL = 1e-3
# static logits, card against the CPU's exact path. Every static op is
# held to the CPU's op on the card's own input bit for bit
# (_static_vs_cpu); a control without activation quantisation fails that
# gate (0 of 74 ops). The whole model cannot tell them apart: the fp32
# ops between the int8 products (attention, layer norm, gelu) differ
# from the CPU's in the last bits, an activation on a rounding boundary
# moves one int8 step, and the steps compound over 12 layers (a fifth of
# the codes differ by the last layer) to the size of the quantisation
# error itself. H100 readings (seeded, the same in every run): the flash
# path 0.0128, plain attention in its place 0.0172, the control 0.0141.
# So this bound only holds both sound paths to that size, with room
INT8_STATIC_CPU_TOL = 0.025
# int8 against the fp32 served logits: |int8 - fp32| <= this share of
# max |fp32|; weight-only quantises the weights (per channel, 127 steps),
# static the activations too (per tensor, calibrated abs-max)
INT8_VS_FP32_SHARE = {"weight_only": 0.05, "static": 0.1}
# the cluster phase: the replicas' admission bound and max batch (one
# bucket). Each request is a full bucket (SCALE_MAX_BATCH rows, one engine
# batch of ~4 ms on the card), its JSON body encoded once; the busy
# closed loop holds as many requests as the bound, so no submit meets a
# full queue (two more, a 429 retried past the router's retries fails a
# request), the quiet one two. Unpaced, 26 such clients filled one
# replica's queue on one H100 host (peak 1.0) and not on another (0.21:
# the requests waited in this process's router and the replica's HTTP
# front end, not in its queue), so the phase writes the policy's signal
# as the reference's TestClusterAutoscale does
# (tests/test_elastic_resize.py:975-1000) and prints the measured one
SCALE_QUEUE_BOUND, SCALE_MAX_BATCH, SCALE_REQUESTS = 24, 8, 32
SCALE_CLIENTS, SCALE_QUIET_CLIENTS = SCALE_QUEUE_BOUND, 2
SCALE_BUSY_FRAC, SCALE_QUIET_FRAC = 0.95, 0.02


def check_int8_bert_base(dev, results):
    """The int8 GEMM at BERT-base's inference shapes (INT8_BERT_SHAPES,
    bias in the epilogue as a converted fc) against plain_int8_gemm at
    the card gate; events and device ms of the kernel, of the plain
    version and of the dequantise-and-matmul library call. Beside each,
    the static-quant int8_matmul (quantise, torch._int_mm, epilogue) as
    the op runs it, its torch._int_mm alone, and its bit-for-bit
    agreement with the CPU's exact path. Bounds: the weight-only GEMM's
    bytes (int8 weight, fp32 x, bias, scale, fp32 out) or 2MKN at the
    bf16 rate; the static op's bytes (fp32 x, int8 weight, fp32 out) or
    2MKN at the int8 rate. The static op and the product alone are timed
    with the weight column-major, as the predictor lays it out, and the
    product also row-major, as it is stored. Returns the _int_mm rows."""
    from paddle_tpu_torch.kernels import int8_gemm as ig
    from paddle_tpu_torch.ops import quant_ops as qo

    static_rows = []
    for m, k, n in INT8_BERT_SHAPES:
        g = torch.Generator(device=dev).manual_seed(m * 3 + k + n)
        reps = max(1, (64 << 20) // (k * n))
        w8s = [torch.randint(-127, 128, (k, n), device=dev, dtype=torch.int8,
                             generator=g) for _ in range(reps)]
        x = torch.randn(m, k, device=dev, generator=g)
        sc = (torch.rand(n, device=dev, generator=g) + 0.5) / 127.0
        bias = torch.randn(n, device=dev, generator=g)
        out = ig.int8_weight_only_gemm(x, w8s[0], sc, bias)
        ref = ig.plain_int8_gemm(x, w8s[0], sc, bias)
        torch.cuda.synchronize()
        err = errors(out, ref)
        if not torch.allclose(out, ref, rtol=1e-4,
                              atol=1e-5 * float(ref.abs().max()) + 1e-5):
            raise AssertionError(f"int8 GEMM {m}x{k}x{n}: err {err}")

        def kernel(i):
            return ig.int8_weight_only_gemm(x, w8s[i % reps], sc, bias)

        def matmul(i):
            return x @ (w8s[i % reps].float() * sc) + bias

        nbytes = m * k * 4 + k * n + n * 4 * 2 + m * n * 4
        flops = 2 * m * k * n
        bms, by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
        instance, tile, ksplit, kc = ig.plan(m, n, k)
        results.append(with_device_ms(dict(
            name="int8_gemm", instance=instance, tile=tile, ksplit=ksplit,
            kc=kc, shape=f"BERT-base M={m} K={k} N={n} bias=True",
            max_abs_err=err[0], max_rel_err=err[1],
            ms=events_ms(kernel, 30),
            plain_ms=events_ms(lambda i: ig.plain_int8_gemm(
                x, w8s[i % reps], sc, bias), 10),
            library_ms=events_ms(matmul, 10), bound_ms=bms, bound_by=by,
            bound_ms_three_pieces=bound_ms(nbytes, 3 * flops,
                                           BF16_FLOPS_PER_S)[0],
            bound_ms_cuda_cores=bound_ms(nbytes, flops)[0]),
            kernel, matmul))
        # the static mode at the same shape: act_scale the input's abs-max
        attrs = {"act_scale": float(x.abs().max())}

        cols = [qo.column_major(w) for w in w8s]

        def static(i):
            return qo.int8_matmul({"X": [x], "Y": [cols[i % reps]],
                                   "YScale": [sc]}, attrs)["Out"]

        xq = torch.clamp(torch.round(x / (attrs["act_scale"] / 127.0)),
                         -127, 127).to(torch.int8)

        def int_mm(i):
            return qo.int_mm_padded(xq, cols[i % reps])

        # the same product with the weight row-major, as it is stored: the
        # layout _int_mm is not given
        kp, np_ = [-(-v // qo.INT_MM_MULTIPLE) * qo.INT_MM_MULTIPLE
                   for v in (k, n)]
        xqp = torch.nn.functional.pad(
            xq, (0, kp - k, 0, max(m, qo.INT_MM_MIN_M) - m))
        rows_major = [torch.nn.functional.pad(w, (0, np_ - n, 0, kp - k))
                      for w in w8s]

        def int_mm_row_major(i):
            return torch._int_mm(xqp, rows_major[i % reps])

        got = static(0)
        cpu = qo.int8_matmul({"X": [x.cpu()], "Y": [w8s[0].cpu()],
                              "YScale": [sc.cpu()]}, attrs)["Out"]
        sbytes = m * k * 4 + k * n + n * 4 + m * n * 4
        sms, sby = bound_ms(sbytes, flops, INT8_TOPS)
        row = dict(name="torch._int_mm (static int8_matmul)",
                   shape=f"BERT-base M={m} K={k} N={n}",
                   bitwise_equal_cpu=bool(torch.equal(got.cpu(), cpu)),
                   max_abs_err_vs_cpu=float((got.cpu() - cpu).abs().max()),
                   ms=events_ms(static, 30), int_mm_ms=events_ms(int_mm, 30),
                   bound_ms=sms, bound_by=sby,
                   int_mm_bound_ms=bound_ms(m * k + k * n + m * n * 4, flops,
                                            INT8_TOPS)[0])
        row["device_ms"] = with_device_ms(dict(ms=row["ms"]), static)[
            "device_ms"]
        row["int_mm_device_ms"] = with_device_ms(dict(ms=row["ms"]),
                                                 int_mm)["device_ms"]
        row["int_mm_row_major_device_ms"] = with_device_ms(
            dict(ms=row["ms"]), int_mm_row_major)["device_ms"]
        del rows_major, cols
        static_rows.append(row)
        if not row["bitwise_equal_cpu"]:
            raise AssertionError(f"static int8_matmul {m}x{k}x{n}: card "
                                 f"differs from the CPU's exact path by "
                                 f"{row['max_abs_err_vs_cpu']}")
        del w8s
    return static_rows


def _int8_feeds(cfg, seed, batches, rows):
    """``batches`` seeded feeds of ``rows`` rows (real lengths 16-128)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(batches):
        mask = np.arange(BERT_INFER_SEQ)[None, :] < \
            rng.randint(16, BERT_INFER_SEQ + 1, rows)[:, None]
        out.append({
            "src_ids": (rng.randint(1, cfg.vocab_size,
                                    (rows, BERT_INFER_SEQ)) * mask)
            .astype(np.int64),
            "sent_ids": (rng.randint(0, 2, (rows, BERT_INFER_SEQ)) * mask)
            .astype(np.int64),
            "pos_ids": np.tile(np.arange(BERT_INFER_SEQ), (rows, 1))
            .astype(np.int64),
            "input_mask": mask.astype(np.float32)})
    return out


def _int8_dirs(dev, cfg, model_dir, base):
    """PTQ-calibrate BERT-base's fp32 program on the card, then the two
    converts (weight-only: act_scales None; static: the calibrated
    scales), each saved under ``base``. Gate: both scopes' int8 arrays
    and scales equal quantize_weights_int8 of the same weights on the
    CPU, bit for bit. Returns ({mode: dir}, {mode: (ops without
    act_scale, ops with it)}, figures)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import io
    from paddle_tpu_torch.contrib import slim

    t0 = time.perf_counter()
    exe = ptt.Executor(dev)
    fp32 = ptt.Scope()
    prog, feeds, fetch = io.load_inference_model(model_dir, executor=exe,
                                                 scope=fp32)
    calib = _int8_feeds(cfg, 1, INT8_CALIB_BATCHES, 8)
    ptq = slim.PostTrainingQuantization(exe, prog.clone(for_test=True),
                                        feeds, fp32, calib)
    ptq.quantize()
    calib_s = time.perf_counter() - t0
    cpu = ptt.Scope()
    io.load_inference_model(model_dir, scope=cpu)
    want = slim.quantize_weights_int8(prog, cpu)
    dirs, ops, mismatched = {}, {}, []
    for mode, scales in (("weight_only", None),
                         ("static", ptq.calibrated_scales)):
        scope = ptt.Scope()
        for n, v in fp32.items():
            scope.set(n, v)   # the convert replaces what it quantises
        t = time.perf_counter()
        q = slim.convert_to_int8_program(prog.clone(for_test=True), scope,
                                         scales)
        convert_s = time.perf_counter() - t
        for name, pack in want.items():
            got8 = scope.find_var(name).cpu().numpy()
            gots = scope.find_var(name + "@int8_scale").cpu().numpy()
            if got8.dtype != np.int8 or \
                    got8.tobytes() != pack["int8"].tobytes() or \
                    gots.tobytes() != np.asarray(
                        pack["scale"], np.float32).reshape(-1).tobytes():
                mismatched.append((mode, name))
        mm = [o for o in q.global_block().ops if o.type == "int8_matmul"]
        ops[mode] = (sum(not o.attrs.get("act_scale") for o in mm),
                     sum(bool(o.attrs.get("act_scale")) for o in mm))
        dirs[mode] = str(Path(base) / f"int8_{mode}")
        t = time.perf_counter()
        io.save_inference_model(dirs[mode], feeds, fetch, main_program=q,
                                scope=scope)
        ops[mode] += (convert_s, time.perf_counter() - t)
        del scope
    # six projections a layer, the pooler and the NSP classifier
    n_weights = 6 * cfg.num_hidden_layers + 2
    if mismatched or len(want) != n_weights:
        raise AssertionError(f"int8 convert: {len(want)} weights quantised "
                             f"(want {n_weights}), CPU mismatches "
                             f"{mismatched[:4]}")
    figures = dict(calibrate_s=calib_s, calibrated_activations=len(
        ptq.calibrated_scales), quantised_weights=len(want))
    del fp32, cpu
    _release()
    return dirs, ops, figures


def _serve_bucketed(pred, reqs):
    """A ServingEngine over ``pred`` with buckets INT8_INFER_BUCKETS, every
    bucket warmed at start(); the requests from BERT_INFER_CLIENTS
    threads through LocalClient. Returns (outputs, request ms, engine
    stats, launch counts of the traffic and its batches by bucket)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.serving import (LocalClient, ServingConfig,
                                          ServingEngine)

    engine = ServingEngine(pred, ServingConfig(
        max_batch_size=INT8_INFER_BUCKETS[-1], buckets=INT8_INFER_BUCKETS))
    engine.start()
    # the bucket of each batch the engine serves (start() warmed them all)
    served_buckets = []
    real_run = pred.run

    def run(feed=None):
        served_buckets.append(len(next(iter(feed.values()))))
        return real_run(feed)

    pred.run = run
    client = LocalClient(engine)
    fetch = engine.fetch_names[0]
    kernels.reset_launch_counts()
    telemetry.reset()   # the engine's counters: this traffic's alone
    outs, ms = [None] * len(reqs), [None] * len(reqs)

    def worker(w):
        for i in range(w, len(reqs), BERT_INFER_CLIENTS):
            t = time.perf_counter()
            outs[i] = client.infer(reqs[i], timeout=600)[fetch]
            ms[i] = (time.perf_counter() - t) * 1e3

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(BERT_INFER_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    counts = dict(_infer_counts(), int8_instances=dict(
        kernels.int8_instance_counts()))
    stats = engine.stats()
    engine.close(drain=True, timeout=60)
    del pred.run
    if any(o is None for o in outs):
        raise AssertionError("a request never returned")
    if len(served_buckets) != stats["batches"]:
        raise AssertionError(f"{len(served_buckets)} predictor runs for "
                             f"{stats['batches']} engine batches")
    counts["served_buckets"] = {b: served_buckets.count(b)
                                for b in INT8_INFER_BUCKETS}
    return outs, ms, stats, counts


def _padded_checks(pred, reqs, outs, buckets):
    """Each response against ``pred.run`` of its rows padded to the
    smallest of ``buckets`` it equals bit for bit (None: none)."""
    out = []
    for r, o in zip(reqs, outs):
        rows = len(r["input_mask"])
        out.append(next((b for b in buckets if b >= rows and o.tobytes()
                         == pred.run(_padded(r, b))[0][:rows].tobytes()),
                        None))
    return out


def _static_records(pred, feed):
    """``feed`` through ``pred`` with every static int8_matmul call
    recorded as (x, w, sy, act_scale, out) on the CPU; calls made while a
    CUDA graph is captured are left out, so a signature ``pred`` has not
    seen is recorded once, from its op-by-op first run."""
    from paddle_tpu_torch.ops import quant_ops as qo

    real, recs = qo.static_int8_matmul, []

    def record(x, w, sy, act_scale):
        out = real(x, w, sy, act_scale)
        if not (x.is_cuda and torch.cuda.is_current_stream_capturing()):
            recs.append((x.cpu(), w.cpu(), sy.cpu(), act_scale, out.cpu()))
        return out

    qo.static_int8_matmul = record
    try:
        pred.run(feed)
    finally:
        qo.static_int8_matmul = real
    return recs


def _ops_exact(recs):
    """How many recorded ops equal the CPU's static op on the same input,
    weight and scales, bit for bit."""
    from paddle_tpu_torch.ops import quant_ops as qo

    return sum(qo.static_int8_matmul(x, w, sy, a).numpy().tobytes()
               == out.numpy().tobytes() for x, w, sy, a, out in recs)


def _code_drift(card, cpu):
    """The int8 activation codes of the same ops in two runs of one
    request: the share that differ (in all, and op by op in program
    order: a BERT layer's six projections, then the pooler and the
    classifier), the largest difference, the first op where any
    differs."""
    from paddle_tpu_torch.ops import quant_ops as qo

    differ = total = biggest = 0
    first, per_op = None, []
    for i, (a, b) in enumerate(zip(card, cpu)):
        d = (qo.quantize_activation(a[0], a[3]).int()
             - qo.quantize_activation(b[0], b[3]).int()).abs()
        n = int((d > 0).sum())
        differ, total = differ + n, total + d.numel()
        per_op.append(n / d.numel())
        biggest = max(biggest, int(d.max()))
        if n and first is None:
            first = i
    return dict(share=differ / max(total, 1), codes=total,
                max_step=biggest, first_op=first, share_by_op=per_op)


def _vs_cpu(pred, reqs, cpu_outs):
    """A card predictor's logits against the CPU's, request by request."""
    err, same, agree = 0.0, 0, 0
    for r, c in zip(reqs, cpu_outs):
        card, = pred.run(r)
        err = max(err, float(np.abs(c - card).max()))
        same += int(c.tobytes() == card.tobytes())
        agree += int((c.argmax(1) == card.argmax(1)).all())
    return dict(max_abs=err, bitwise_equal=same,
                argmax_agree=agree / len(reqs))


def _static_vs_cpu(dev, path, pred, reqs, n_static):
    """The static leg (``pred``, served from ``path``) against a CPU
    predictor over the same dir. Op by op, on the request with the
    fewest rows: every static int8_matmul of the card's first run equals
    the CPU's op on the card's own input, bit for bit (the gate that
    holds the card's quantise, product and epilogue); the codes of the
    CPU's own run beside the card's (the witness of drift from upstream
    fp32 ops). Whole model, over ``reqs``: the card's logits (the flash
    kernel), those of a card predictor with plain attention in the flash
    kernel's place (the second witness) and those of a control without
    activation quantisation, each against the CPU. Gates: the op-level
    one; the control fails it; both sound paths within
    INT8_STATIC_CPU_TOL (which the control does not exceed: see there).
    Returns (figures, problems)."""
    from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.ops import attention_ops as ao
    from paddle_tpu_torch.ops import quant_ops as qo

    probe = min(reqs, key=lambda r: len(r["input_mask"]))
    cpu = create_predictor(AnalysisConfig(path), device="cpu")
    card_recs = _static_records(pred, probe)
    cpu_recs = _static_records(cpu, probe)
    cpu_outs = [cpu.run(r)[0] for r in reqs]
    fig = dict(static_ops_recorded=len(card_recs),
               static_ops_exact=_ops_exact(card_recs),
               code_drift_vs_cpu=_code_drift(card_recs, cpu_recs),
               vs_cpu=_vs_cpu(pred, reqs, cpu_outs))
    del card_recs, cpu_recs, cpu
    real_fa = ao.flash_fwd
    ao.flash_fwd = fa.plain_flash_fwd
    try:
        fig["plain_attention_vs_cpu"] = _vs_cpu(
            create_predictor(AnalysisConfig(path), device=dev), reqs,
            cpu_outs)
    finally:
        ao.flash_fwd = real_fa
    _release()
    real_static = qo.static_int8_matmul

    def no_act_quant(x, w, sy, act_scale):
        return (x.to(torch.float32) @ w.to(torch.float32)) * sy

    qo.static_int8_matmul = no_act_quant
    try:
        ctl = create_predictor(AnalysisConfig(path), device=dev)
        ctl_recs = _static_records(ctl, probe)
        fig["control_without_act_quant"] = dict(
            _vs_cpu(ctl, reqs, cpu_outs), ops_exact=None)
    finally:
        qo.static_int8_matmul = real_static
    fig["control_without_act_quant"]["ops_exact"] = _ops_exact(ctl_recs)
    del ctl, ctl_recs
    _release()
    problems = []
    if not fig["static_ops_recorded"] == fig["static_ops_exact"] == n_static:
        problems.append(f"static ops: {fig['static_ops_exact']} of "
                        f"{fig['static_ops_recorded']} recorded equal the "
                        f"CPU's op (want {n_static})")
    control = fig["control_without_act_quant"]
    if control["ops_exact"] == n_static:
        problems.append("the op-level gate passes a control without "
                        "activation quantisation")
    for key in ("vs_cpu", "plain_attention_vs_cpu"):
        if fig[key]["max_abs"] > INT8_STATIC_CPU_TOL:
            problems.append(f"static {key} {fig[key]['max_abs']} > "
                            f"{INT8_STATIC_CPU_TOL}")
    return fig, problems


def _gemm_split(trace):
    """(GEMM device ms, the rest) of a traced batch: kernels whose name
    holds 'gemm' or 'xmma' (cuBLAS, CUTLASS, the int8 GEMM kernel)."""
    gemm = sum(r["ms"] for r in trace["top_kernels"]
               if "gemm" in r["kernel"].lower()
               or "xmma" in r["kernel"].lower())
    return gemm, trace["device_busy_ms"] - gemm


def infer_int8_bert_base(dev, cfg, model_dir, reqs, base):
    """BERT-base (model_dir, fp32) calibrated on the card, converted to int8
    twice (weight-only: the int8 GEMM kernel; static: torch._int_mm),
    saved, loaded by create_predictor (one CUDA graph a signature) and
    served with the fp32 dir at buckets 8 and 32 through ServingEngine
    (64 requests, 16 clients). Gates: the int8 arrays and scales equal the
    CPU's quantize_weights_int8 bit for bit; each response equals its
    predictor's run of its rows padded to a bucket bit for bit (C10's
    gate); the int8 GEMM launches equal (ops without act_scale) x batches,
    the 72 projections on the prefill instance, the pooler and classifier
    on decode at bucket 8, and none in fp32 and static; weight-only
    logits within INT8_PLAIN_TOL of the same predictor with
    plain_int8_gemm in the kernel's place; static: each op equal to the
    CPU's on its input bit for bit, the logits within INT8_STATIC_CPU_TOL
    of a CPU predictor over the same dir, with two witnesses and a
    control (_static_vs_cpu); both within INT8_VS_FP32_SHARE of the fp32
    logits (argmax agreement printed).
    Prints per-batch p50 (predictor.run) at B = 8 and 32, a traced
    bucket-32 replay's device ms split into GEMMs and the rest, and the
    weight bytes."""
    from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
    from paddle_tpu_torch.kernels import int8_gemm as ig
    from paddle_tpu_torch.ops import quant_ops as qo
    from paddle_tpu_torch.tools.profile_train import traced

    phase = "infer_int8_bert_base"
    t_phase = time.perf_counter()
    dirs, ops, figures = _int8_dirs(dev, cfg, model_dir, base)
    dirs = {"fp32": model_dir, **dirs}
    served, per_batch, split, weight_bytes, runs = {}, {}, {}, {}, {}
    outs_by, problems = {}, []
    for mode, path in dirs.items():
        pred = create_predictor(AnalysisConfig(path), device=dev)
        weight_bytes[mode] = sum(
            t.numel() * t.element_size() for t in pred._params.values()
            if isinstance(t, torch.Tensor) and t.dim() >= 1)
        calls = qo.static_int8_calls
        outs, ms, stats, counts = _serve_bucketed(pred, reqs)
        batches = stats["batches"]
        buckets = _padded_checks(pred, reqs, outs, INT8_INFER_BUCKETS)
        n_int8 = ops.get(mode, (0, 0))[0]
        served[mode] = dict(batches=batches, padded_bucket_equal=sum(
            b is not None for b in buckets), request_ms_p50=_pct(ms, 0.5),
            request_ms_p99=_pct(ms, 0.99), int8_gemm=counts["launches"][
                "int8_gemm"], int8_instances=counts["int8_instances"],
            int_mm_calls_first_runs=qo.static_int8_calls - calls)
        if None in buckets:
            problems.append(f"{mode}: responses {buckets.count(None)} "
                            f"match no padded bucket run")
        # a batch at bucket B runs the 72 projections at M = 128 B on the
        # prefill instance and the pooler and classifier at M = B, on
        # decode at B = 8 (M <= 16) and on prefill at B = 32: decode takes
        # 2 launches for each bucket-8 batch, prefill the rest
        inst = counts["int8_instances"]
        decode = 2 * counts["served_buckets"][8] if n_int8 else 0
        served[mode]["batches_by_bucket"] = counts["served_buckets"]
        if counts["launches"]["int8_gemm"] != n_int8 * batches or \
                inst.get("decode", 0) != decode or \
                inst.get("prefill", 0) != n_int8 * batches - decode:
            problems.append(f"{mode}: {counts['served_buckets']} batches "
                            f"by bucket want {n_int8 * batches - decode} "
                            f"prefill and {decode} decode int8 launches, "
                            f"got {inst}")
        _gate_flash_per_batch(phase, dict(counts, launches={
            k: v for k, v in counts["launches"].items() if k != "int8_gemm"}),
            batches, cfg.num_hidden_layers)
        runs[mode] = counts
        per_batch[mode] = {}
        for b in INT8_INFER_BUCKETS:
            feed = _padded(reqs[0], b)
            times = []
            for _ in range(10):
                t = time.perf_counter()
                pred.run(feed)
                times.append((time.perf_counter() - t) * 1e3)
            per_batch[mode][b] = _pct(times, 0.5)
        full = _padded(reqs[0], INT8_INFER_BUCKETS[-1])
        trace = traced(lambda: pred.run(full), 1, top_n=400)
        gemm, rest = _gemm_split(trace)
        split[mode] = dict(gemm_ms=gemm, rest_ms=rest,
                           busy_ms=trace["device_busy_ms"],
                           idle_share=trace["device_idle_share"],
                           top_kernels=trace["top_kernels"][:4])
        outs_by[mode] = outs
        if mode == "weight_only":
            # the same predictor with plain_int8_gemm in the kernel's place
            # (its first run is op by op; the capture is of the plain op)
            plain = create_predictor(AnalysisConfig(path), device=dev)
            real = qo.int8_weight_only_gemm

            def plain_gemm(x, w8, scale, bias=None, act=None):
                lead = tuple(x.shape[:-1])
                return ig.plain_int8_gemm(
                    x.reshape(-1, x.shape[-1]), w8, scale.reshape(-1),
                    bias, act).reshape(lead + (w8.shape[-1],))

            qo.int8_weight_only_gemm = plain_gemm
            try:
                err = max(float(np.abs(plain.run(_padded(r, 8))[0][
                    :len(r["input_mask"])] - pred.run(_padded(r, 8))[0][
                        :len(r["input_mask"])]).max()) for r in reqs[:8])
            finally:
                qo.int8_weight_only_gemm = real
            served[mode]["max_abs_vs_plain_int8_gemm"] = err
            if err > INT8_PLAIN_TOL:
                problems.append(f"weight-only vs plain GEMM {err}")
            del plain
        if mode == "static":
            fig, bad = _static_vs_cpu(dev, path, pred, reqs[:BERT_INFER_CPU],
                                      ops[mode][1])
            served[mode].update(fig)
            problems += bad
        del pred
        _release()
    ref = np.concatenate(outs_by["fp32"])
    for mode in ("weight_only", "static"):
        got = np.concatenate(outs_by[mode])
        err = float(np.abs(got - ref).max())
        served[mode].update(
            max_abs_vs_fp32=err, fp32_max_abs=float(np.abs(ref).max()),
            argmax_agree_fp32=float((got.argmax(1) == ref.argmax(1)).mean()))
        if err > INT8_VS_FP32_SHARE[mode] * float(np.abs(ref).max()):
            problems.append(f"{mode} vs fp32 logits {err}")
    emit(phase, **figures, ops_without_and_with_act_scale={
        m: o[:2] for m, o in ops.items()},
         convert_s={m: o[2] for m, o in ops.items()},
         save_s={m: o[3] for m, o in ops.items()}, served=served,
         per_batch_ms_p50=per_batch, device_ms_bucket32=split,
         weight_bytes=weight_bytes, launches={m: c["launches"]
                                             for m, c in runs.items()},
         seconds=time.perf_counter() - t_phase)
    if problems:
        raise AssertionError(f"{phase}: {problems}")
    total = {k: sum(c["launches"][k] for c in runs.values())
             for k in runs["fp32"]["launches"]}
    layouts = {k: {s: sum(c["layouts"][k][s] for c in runs.values())
                   for s in runs["fp32"]["layouts"][k]}
               for k in runs["fp32"]["layouts"]}
    dtypes = {k: {s: sum(c["dtypes"][k].get(s, 0) for c in runs.values())
                  for s in runs["fp32"]["dtypes"][k]}
              for k in runs["fp32"]["dtypes"]}
    return dict(launches=total, layouts=layouts, dtypes=dtypes,
                int8_instances=runs["weight_only"]["int8_instances"],
                dir=dirs["weight_only"], n_int8=ops["weight_only"][0])


def _queue_frac(cluster, seconds, bound):
    """The fleet's queue saturation as the fleet observatory (ROADMAP A10)
    would read it: every replica's /v1/stats queue_depth sampled every 50
    ms for ``seconds``; the peak fleet average over the admission
    bound."""
    peak, samples = 0.0, 0
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        depths = [_http("GET", r.url, "/v1/stats", timeout=30)[1][
            "queue_depth"] for r in list(cluster.replicas)]
        peak = max(peak, sum(depths) / len(depths) / bound)
        samples += 1
        time.sleep(0.05)
    return peak, samples


def infer_int8_cluster_scale(dev, cfg, int8_dir, n_int8):
    """The weight-only int8 BERT-base published behind one replica process
    (the backend of infer_cluster_swap; FLAGS_serving_max_queue_depth
    SCALE_QUEUE_BOUND, max batch SCALE_MAX_BATCH) with ScalerPolicy(1, 2)
    attached. SCALE_CLIENTS clients in a closed loop through the router,
    each request SCALE_MAX_BATCH seeded rows (SCALE_REQUESTS bodies,
    encoded once), with no pacing of any kind: the phase measures the
    queue fraction (_queue_frac, printed), writes fleet.queue_frac =
    SCALE_BUSY_FRAC and autoscale_tick scales 1 -> 2. With two replicas,
    an OnlineTrial of one serving config at fraction 0.25 runs to its
    verdict, then one with an armed incidents.Rule tripped. Then the
    loop drops to SCALE_QUIET_CLIENTS, the fraction is measured again,
    fleet.queue_frac = SCALE_QUIET_FRAC is written and autoscale_tick
    scales 2 -> 1. Gates: exactly one scale-up and one
    scale-down (scaler, router and incident counters); no failed request
    throughout; the retired replica not respawned (no death, no restart
    counted); each replica's int8 GEMM launches between two /v1/stats
    reads equal n_int8 x its batches; the trials: the flag snapshot
    restored after a rollback (a promotion keeps the candidate, every
    replica on it), the fleet's version unchanged, the tripped trial
    rolled back for slo_trip in one evaluation tick."""
    import shutil
    import tempfile

    from paddle_tpu_torch import checkpoint
    from paddle_tpu_torch.core import flags, incidents, telemetry, tuner
    from paddle_tpu_torch.distributed.scaler import ScalerPolicy
    from paddle_tpu_torch.serving import ClusterController, ServingConfig

    phase = "infer_int8_cluster_scale"
    t_phase = time.perf_counter()
    fleet_flags = dict(serving_max_queue_depth=SCALE_QUEUE_BOUND,
                       serving_max_batch_size=SCALE_MAX_BATCH,
                       serving_buckets=str(SCALE_MAX_BATCH),
                       serving_batch_timeout_ms=2.0)
    root = tempfile.mkdtemp(prefix="models_int8_", dir=SERVING_DIR)
    t0 = time.perf_counter()
    checkpoint.publish_model(root, int8_dir)
    publish_s = time.perf_counter() - t0
    prior = flags.apply(fleet_flags)
    telemetry.reset()
    incidents.reset()
    cluster = ClusterController(
        root, replicas=1, device=str(dev), auto_swap=False,
        serving_config=ServingConfig(max_batch_size=SCALE_MAX_BATCH,
                                     batch_timeout_ms=2.0),
        replica_env=_replica_env(**fleet_flags), replica_ready_timeout_s=300)
    cluster.attach_scaler(ScalerPolicy(min_world=1, max_world=2,
                                       cooldown_s=0.0, source="serving"))
    bodies = [json.dumps({"inputs": {k: v.tolist() for k, v in r.items()}})
              .encode() for r in _int8_feeds(cfg, 2, SCALE_REQUESTS,
                                             SCALE_MAX_BATCH)]
    answers, clients = [], []
    stop, quiet = threading.Event(), threading.Event()
    marks, fig = {}, {}
    problems = []

    def client(c):
        i = c
        while not stop.is_set() and (c < SCALE_QUIET_CLIENTS
                                     or not quiet.is_set()):
            t = time.perf_counter()
            try:
                code, doc = _http("POST", cluster.url, "/v1/infer",
                                  bodies[i], timeout=120)
            except OSError as e:
                code, doc = -1, {"error": repr(e)}
            answers.append((code, doc.get("replica") if isinstance(doc, dict)
                            else None, t, time.perf_counter()))
            i = (i + SCALE_CLIENTS) % len(bodies)

    try:
        t0 = time.perf_counter()
        cluster.start(ready_timeout_s=300)
        fig["up_s"] = time.perf_counter() - t0
        before = dict(telemetry.counters())
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(SCALE_CLIENTS)]
        for t in clients:
            t.start()
        t0 = time.perf_counter()
        qf, n = _queue_frac(cluster, 1.5, SCALE_QUEUE_BOUND)
        fig["busy_requests_per_s"] = sum(
            t0 <= a[3] for a in list(answers)) / (time.perf_counter() - t0)
        telemetry.gauge_set("fleet.queue_frac", SCALE_BUSY_FRAC)
        t0 = time.perf_counter()
        up = cluster.autoscale_tick()
        fig.update(busy_queue_frac_measured=qf, busy_samples=n,
                   scale_up_s=time.perf_counter() - t0,
                   scale_up=up and dict(reason=up.reason, target=up.target))
        s1 = _replica_stats(cluster)
        time.sleep(2.0)
        s2 = _replica_stats(cluster)
        window = _stats_delta(s1, s2)
        fig["replica_int8"] = {}
        for name in s2:
            la = s2[name]["kernels"]["int8_gemm"] - \
                s1[name]["kernels"]["int8_gemm"]
            nb = s2[name].get("batches", 0) - s1[name].get("batches", 0)
            fig["replica_int8"][name] = dict(launches=la, batches=nb)
            # a batch's launches and the batch itself are counted at two
            # moments of its run: a read may fall between them, at each end
            if la <= 0 or la % n_int8 or abs(la // n_int8 - nb) > 1:
                problems.append(f"{name}: {la} int8 launches over {nb} "
                                f"batches (want {n_int8} a batch)")
        # the online trial on live traffic, two replicas
        snap, version = flags.snapshot(), cluster.current_version
        candidate = {"serving_buckets": f"4,{SCALE_MAX_BATCH}",
                     "serving_batch_timeout_ms": 1.0}
        t0 = time.perf_counter()
        trial = tuner.OnlineTrial(cluster, candidate, fraction=0.25,
                                  eval_interval_s=0.5, min_requests=8,
                                  max_evals=10, label="chip_smoke")
        verdict = trial.run()
        fig["trial"] = dict(verdict.as_dict(), seconds=time.perf_counter()
                            - t0, replica=trial.trial_replica)
        configs = {n: s["serving_config"]["buckets"]
                   for n, s in _replica_stats(cluster).items()}
        fig["trial"]["replica_buckets_after"] = configs
        if verdict.status == "promoted":
            want = dict(snap, **{k: flags.all_flags()[k] for k in candidate})
            if flags.snapshot() != want or any(
                    b != [4, SCALE_MAX_BATCH] for b in configs.values()):
                problems.append(f"promoted trial: flags or replicas off the "
                                f"candidate {configs}")
            flags.apply(snap)   # back to the incumbent for what follows
            for r in list(cluster.replicas):
                cluster.retune_replica(r.name)
        elif flags.snapshot() != snap or any(
                b != [SCALE_MAX_BATCH] for b in configs.values()):
            problems.append(f"rolled-back trial left flags or replicas off "
                            f"the incumbent {configs}")
        # an SLO rule tripped mid-trial aborts it in one tick
        wd = incidents.arm([incidents.Rule(
            "chip_smoke_probe", "chip_smoke.slo_probe", kind="gauge",
            threshold=5, direction="above", cooldown_s=0.0)])
        trial2 = tuner.OnlineTrial(cluster, candidate, fraction=0.25,
                                   min_requests=10 ** 6, max_evals=50,
                                   label="chip_smoke_slo")
        trial2.start()
        telemetry.gauge_set("chip_smoke.slo_probe", 99)
        wd.evaluate()
        aborted = trial2.evaluate_once()
        fig["slo_trial"] = aborted.as_dict()
        if (aborted.status, aborted.reason, aborted.evals) != \
                ("rolled_back", "slo_trip", 1) or flags.snapshot() != snap:
            problems.append(f"SLO trial {aborted.as_dict()}")
        if cluster.current_version != version or any(
                s["model_version"] != version
                for s in _replica_stats(cluster).values()):
            problems.append("a trial moved the fleet's version")
        # quiet: two clients go on; the rest stop after their request
        quiet.set()
        for t in clients[SCALE_QUIET_CLIENTS:]:
            t.join(timeout=300)
        qf, n = _queue_frac(cluster, 1.0, SCALE_QUEUE_BOUND)
        telemetry.gauge_set("fleet.queue_frac", SCALE_QUIET_FRAC)
        victim = cluster.replicas[-1]
        t0 = time.perf_counter()
        down = cluster.autoscale_tick()
        fig.update(quiet_queue_frac_measured=qf, quiet_samples=n,
                   scale_down_s=time.perf_counter() - t0,
                   scale_down=down and dict(reason=down.reason,
                                            target=down.target))
        time.sleep(1.5)   # six monitor passes
        marks["after"] = dict(telemetry.counters())
        fig["victim_alive"] = victim.alive()
    finally:
        stop.set()
        for t in clients:
            t.join(timeout=300)
        cluster.close()
        flags.apply(prior)
        incidents.reset()
        shutil.rmtree(root, ignore_errors=True)
    after = marks.get("after", {})

    def delta(name):
        return int(after.get(name, 0)) - int(before.get(name, 0))

    counts = {k: delta(k) for k in (
        "scaler.scale_up", "scaler.scale_down", "router.scale_events",
        "incidents.scale_events", "router.replica_deaths",
        "router.replica_restarts", "tuner.trials", "tuner.rollbacks",
        "tuner.promotions", "tuner.slo_aborts")}
    failed = [a[:2] for a in answers if a[0] != 200]
    by_replica = {}
    for a in answers:
        by_replica[a[1]] = by_replica.get(a[1], 0) + 1
    ms = [(a[3] - a[2]) * 1e3 for a in answers]
    emit(phase, publish_s=publish_s, **fig, counters=counts,
         requests=len(answers), failed=len(failed),
         answers_by_replica=by_replica, request_ms_p50=_pct(ms, 0.5),
         request_ms_p99=_pct(ms, 0.99), seconds=time.perf_counter() - t_phase)
    if failed or counts["scaler.scale_up"] != 1 or \
            counts["scaler.scale_down"] != 1 or \
            counts["router.scale_events"] != 2 or \
            counts["incidents.scale_events"] != 2 or \
            counts["router.replica_deaths"] or \
            counts["router.replica_restarts"] or fig.get("victim_alive") \
            or len(by_replica) < 2 or problems:
        raise AssertionError(f"{phase}: failed {failed[:3]}, counters "
                             f"{counts}, answers {by_replica}, {problems}")
    return window


# ---------------------------------------------------------------------------
# The sixteenth slice: queue C's casts and gathers on the card, SelectedRows
# gradients (word2vec), Transformer-big's unfused attention, the flash op's
# general-bias route, Executor.run_steps and dropout past 2^32
# ---------------------------------------------------------------------------

# word2vec at its published widths (models/word2vec.py: EMBED 32, HIDDEN
# 256, 4 context words) over a 100 000-word dictionary, batch 1024; the
# card-against-CPU legs at 5 000 words
W2V_DICT, W2V_BATCH, W2V_CPU_DICT = 100000, 1024, 5000
W2V_LEGS = ("sgd", "momentum", "adam_lazy")
# Transformer-big's unfused branch against the fused one at dropout 0,
# fp32, 2+2 layers, batch 2: both in fp32 (the fused step's flash kernel in
# split TF32, about 2^-21 a product), so the losses agree to this
UNFUSED_VS_FUSED_TOL = 1e-4
# run_steps_ernie's k
RUN_STEPS_K = 4
# run_steps_ernie's depth: 12 of ERNIE-large's 24 layers (24 before the
# linalg_extra_card phase took its seconds)
RUN_STEPS_LAYERS = 12
# dropout_2p32: one bf16 [65536, 65536] tensor (2^32 elements), its rate,
# and the positions read back against the CPU's bits
DROPOUT_BIG, DROPOUT_BIG_RATE, DROPOUT_SAMPLE = (65536, 65536), 0.1, 1 << 20


def _phase_counts():
    from paddle_tpu_torch import kernels

    return dict(launches=kernels.launch_counts(),
                layouts=kernels.layout_counts(),
                dtypes=kernels.dtype_counts())


def _tensors_equal(a, b):
    return all(torch.equal(a.find_var(n), v) for n, v in b.items()
               if isinstance(v, torch.Tensor))


def queue_c_card(dev):
    """Queue C's C12 and C13 on the card: the cast of a float to every
    integer type (NaN to 0, saturating at the type's range) and
    take_along_axis with negative and out-of-range indices (wrapped, and
    filled with NaN or the integer minimum), each op's card result bit
    for bit its CPU result, dtype included, and the named values."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core import registry

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    nan = float("nan")
    casts = [([nan, 3e9, -3e9], "int32"), ([300.0, -1.0], "uint8"),
             ([300.0], "int8"), ([nan, 1e5, -1e5, 7.9, -7.9], "int16"),
             ([nan, 1e10, -1e10, float("inf"), -float("inf"), 2.7, -2.7],
              "int64"), ([-0.5, 255.9, 256.0, nan], "uint8")]
    takes = [([[1, 2, 3]], [[-1, 5]], 1), ([[1, 2, 3]], [[-3, 2, 3, -4]], 1),
             ([[1, 2, 3], [4, 5, 6]], [[0], [-2], [2]], 0)]
    cases, bad = [], []

    def run(op, ins, attrs, slot, device):
        out = registry.get(op).forward(
            {k: [v.to(device)] for k, v in ins.items()}, dict(attrs))[slot]
        return out.cpu()

    for x, dt in casts:
        for src in (torch.float32, torch.bfloat16):
            ins = {"X": torch.tensor(x, dtype=src)}
            attrs = {"out_dtype": dt}
            got, want = (run("cast", ins, attrs, "Out", d)
                         for d in (dev, "cpu"))
            cases.append(dict(op="cast", x=x, src=str(src), dtype=dt,
                              card=got.tolist()))
            if got.dtype != want.dtype or not torch.equal(got, want):
                bad.append(cases[-1])
    for x, idx, axis in takes:
        for dtype in (torch.float32, torch.int32):
            ins = {"Input": torch.tensor(x, dtype=dtype),
                   "Index": torch.tensor(idx, dtype=torch.int32)}
            got, want = (run("take_along_axis", ins, {"Axis": axis},
                             "Result", d) for d in (dev, "cpu"))
            cases.append(dict(op="take_along_axis", x=x, index=idx,
                              axis=axis, dtype=str(dtype),
                              card=got.tolist()))
            if got.dtype != want.dtype or not torch.equal(
                    torch.nan_to_num(got.float(), 12345.0),
                    torch.nan_to_num(want.float(), 12345.0)):
                bad.append(cases[-1])

    def cast(x, dt):
        return run("cast", {"X": torch.tensor(x)}, {"out_dtype": dt}, "Out",
                   dev).tolist()

    named = {"[nan, 3e9, -3e9] -> int32": cast([nan, 3e9, -3e9], "int32"),
             "[300, -1] -> uint8": cast([300.0, -1.0], "uint8"),
             "300 -> int8": cast([300.0], "int8")}
    named_ok = named == {"[nan, 3e9, -3e9] -> int32":
                         [0, 2147483647, -2147483648],
                         "[300, -1] -> uint8": [255, 0],
                         "300 -> int8": [127]}
    emit("queue_c_card", cases=len(cases), card_equals_cpu=not bad,
         named=named, named_values_ok=named_ok,
         seconds=time.perf_counter() - t0)
    if bad or not named_ok:
        raise AssertionError(f"queue_c_card: card differs from the CPU on "
                             f"{bad}, named {named}")
    return _phase_counts()


def _w2v_program(dict_size, batch, leg, sparse=True):
    """word2vec built with_optimizer=False and the leg's optimizer
    appended: the model's own SGD (lr 0.5), Momentum (lr 0.1, 0.9) or
    Adam with lazy_mode (lr 1e-3). ``sparse=False`` clears the lookups'
    is_sparse first (the dense-gradient program)."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.ir import program_guard
    from paddle_tpu_torch.models import word2vec

    with unique_name.guard():
        main_prog, startup, _, fetches = word2vec.build_word2vec_program(
            dict_size, batch, with_optimizer=False)
        if not sparse:
            for op in main_prog.global_block().ops:
                if op.type == "lookup_table_v2":
                    op.attrs["is_sparse"] = False
        with program_guard(main_prog, startup):
            opt = {"sgd": lambda: optimizer.SGDOptimizer(0.5),
                   "momentum": lambda: optimizer.MomentumOptimizer(
                       0.1, momentum=0.9),
                   "adam_lazy": lambda: optimizer.AdamOptimizer(
                       1e-3, lazy_mode=True)}[leg]()
            opt.minimize(fetches["loss"])
    return main_prog, startup, fetches["loss"]


def _no_dense_table_gradient(exe, main_prog, feed, scope, fetch, shape):
    """One op-by-op step with every op's outputs inspected: the
    non-persistable tensors of the table's shape that the step makes (a
    dense gradient would be one). Returns their names and the fetches."""
    from paddle_tpu_torch.core import executor as ex

    persist = {v.name for v in main_prog.global_block().vars.values()
               if v.persistable}
    seen, inner = [], ex.run_op

    def watch(op, env, **kw):
        out = inner(op, env, **kw)
        for n in op.output_names():
            v = env.get(n)
            if isinstance(v, torch.Tensor) and tuple(v.shape) == shape \
                    and n not in persist:
                seen.append(n)
        return out

    ex.run_op = watch
    try:
        out = exe.run(main_prog, feed=feed, scope=scope, fetch_list=fetch,
                      use_compiled=False)
    finally:
        ex.run_op = inner
    return seen, out


def _scope_clone(scope, device=None):
    from paddle_tpu_torch.core.scope import Scope

    sc = Scope()
    for n, v in scope.items():
        sc.set(n, v.to(device or v.device, copy=True)
               if isinstance(v, torch.Tensor) else v)
    return sc


def train_word2vec_sparse(dev, smi, steps=6):
    """word2vec (models/word2vec.py, the reference's book model) at its
    published widths over a 100 000-word dictionary, batch 1024: one
    with_optimizer=False program, three legs (SGD as the model builds it,
    Momentum, Adam with lazy_mode), each from one startup state on one
    batch, ``steps`` steps op by op and ``steps`` compiled. Gates in each
    leg: the loss falls; the compiled run equals the op-by-op one bit for
    bit (losses and every state tensor); shared_w's gradient is a
    SelectedRows of 4 * 1024 rows and no non-persistable [100000, 32]
    tensor exists in a step; the rows no id touched are bit for bit
    unchanged in the parameter and every slot; the dense-gradient program
    (is_sparse cleared) agrees within 1e-6 after the same steps (measured
    figure printed). Then card against CPU at a 5 000-word dictionary,
    3 steps a leg from one state: losses and shared_w within 1e-4."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, scope_from_numpy
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    from paddle_tpu_torch.models import word2vec

    t_phase = time.perf_counter()
    batch = word2vec.synthetic_batch(W2V_DICT, W2V_BATCH, seed=0)
    touched = np.unique(np.concatenate([batch[n].reshape(-1)
                                        for n in word2vec.WORDS]))
    untouched = torch.from_numpy(np.setdiff1d(np.arange(W2V_DICT),
                                              touched)).to(dev)
    feed = {n: torch.from_numpy(v).to(dev) for n, v in batch.items()}
    legs, counts = {}, None
    kernels.reset_launch_counts()
    for leg in W2V_LEGS:
        main_prog, startup, loss = _w2v_program(W2V_DICT, W2V_BATCH, leg)
        dense_prog, _, dense_loss = _w2v_program(W2V_DICT, W2V_BATCH, leg,
                                                 sparse=False)
        base = Scope()
        Executor(device=dev).run(startup, scope=base)
        table = ["shared_w"] + [n for n, v in base.items()
                                if isinstance(v, torch.Tensor) and
                                tuple(v.shape) == (W2V_DICT, 32) and
                                n != "shared_w"]
        rec = {"slots": table}
        runs = {}
        for mode, prog, fl in (("eager", main_prog, loss),
                               ("compiled", main_prog, loss),
                               ("dense", dense_prog, dense_loss)):
            exe, sc = Executor(device=dev), _scope_clone(base)
            losses, ms = [], []
            for i in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = exe.run(prog, feed=feed, scope=sc, fetch_list=[fl],
                              use_compiled=mode != "eager")
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(_loss(out))
            runs[mode] = (sc, losses)
            rec[f"{mode}_losses"] = losses
            rec[f"{mode}_step_ms_p50"] = float(np.median(ms[2:]))
            exe.close()
        eager, comp, dense = (runs[m][0] for m in ("eager", "compiled",
                                                   "dense"))
        rec["compiled_parity_bitwise"] = (
            runs["eager"][1] == runs["compiled"][1]
            and _tensors_equal(eager, dict(comp.items())))
        rec["untouched_rows_unchanged"] = all(
            torch.equal(comp.find_var(n).index_select(0, untouched),
                        base.find_var(n).index_select(0, untouched))
            for n in table)
        rec["sparse_vs_dense_max_abs"] = max(
            float((comp.find_var(n).float() - dense.find_var(n).float())
                  .abs().max()) for n, v in dense.items()
            if isinstance(v, torch.Tensor) and n in dict(comp.items()))
        sc = _scope_clone(base)
        seen, out = _no_dense_table_gradient(
            Executor(device=dev), main_prog, feed, sc,
            [loss.name, "shared_w@GRAD"], (W2V_DICT, 32))
        g = out[1]
        rec["grad_is_selected_rows"] = isinstance(g, SelectedRows) and \
            g.rows.shape == (4 * W2V_BATCH,) and g.height == W2V_DICT
        rec["dense_table_tensors"] = seen
        legs[leg] = rec
        del base, runs, eager, comp, dense, sc
        _release()
    counts = _phase_counts()
    # card against CPU at a 5 000-word dictionary
    cpu_batch = word2vec.synthetic_batch(W2V_CPU_DICT, W2V_BATCH, seed=1)
    for leg in W2V_LEGS:
        main_prog, startup, loss = _w2v_program(W2V_CPU_DICT, W2V_BATCH,
                                                leg)
        sc = Scope()
        Executor(device="cpu").run(startup, scope=sc)
        state = _state_arrays(sc)
        got = {}
        for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
            s2 = scope_from_numpy(state, device)
            exe = Executor(device=device)
            got[side] = ([_loss(exe.run(main_prog, feed=cpu_batch, scope=s2,
                                        fetch_list=[loss]))
                          for _ in range(3)],
                         s2.find_var("shared_w").cpu())
        lg, lc = got["card"][0], got["cpu"][0]
        legs[leg]["card_vs_cpu_losses"] = [lg, lc]
        legs[leg]["card_vs_cpu_shared_w_max_abs"] = float(
            (got["card"][1] - got["cpu"][1]).abs().max())
        legs[leg]["card_vs_cpu_ok"] = bool(
            np.allclose(lg, lc, rtol=1e-4, atol=1e-4)
            and legs[leg]["card_vs_cpu_shared_w_max_abs"] <= 1e-4)
    emit("train_word2vec_sparse", dict_size=W2V_DICT, batch=W2V_BATCH,
         embed=32, hidden=256, steps=steps, legs=legs,
         launches=counts["launches"], nvidia_smi=smi,
         seconds=time.perf_counter() - t_phase,
         note="no hand-written kernel runs on this path; step ms on the "
              "host clock, one synthetic batch")
    for leg, r in legs.items():
        ok = (r["compiled_parity_bitwise"] and r["untouched_rows_unchanged"]
              and r["grad_is_selected_rows"] and not r["dense_table_tensors"]
              and r["sparse_vs_dense_max_abs"] <= 1e-6
              and r["card_vs_cpu_ok"]
              and all(x[-1] < x[0] for x in (r["eager_losses"],
                                             r["compiled_losses"])))
        if not ok:
            raise AssertionError(f"train_word2vec_sparse ({leg}): {r}")
    return counts


def train_transformer_big_unfused(dev, smi, flash_step_ms, timed=3):
    """Transformer-big (the train_transformer_big row: WMT14 En-De, 6+6
    layers at full width, b48 s256, bf16 AMP, noam) built with
    use_flash_attention=False: attention is the unfused chain (heads
    split, matmul, the shared causal table, softmax, dropout, matmul).
    Startup, one warm-up step, ``timed`` timed steps a mode
    (profile_train.timed_modes). Gates: each leg's loss falls; no flash
    launch; one compiled step built; compiled_parity at 2+2 layers (b48,
    3 steps, op by op twice and compiled from one state, bit for bit);
    card against CPU at 2+2 layers, fp32, batch 2, 3 steps from one
    state: masks bit for bit, losses within 1e-4; the unfused program
    against the fused one at dropout 0, fp32, 2+2 layers, batch 2,
    3 steps from one state on the card: losses within
    UNFUSED_VS_FUSED_TOL. Prints the step ms beside
    train_transformer_big's."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, scope_from_numpy
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.tools.profile_train import (
        _transformer_big, timed_modes)
    from paddle_tpu_torch.tools.step_parity import compiled_parity

    t_phase = time.perf_counter()
    main_prog, startup, make_batch, fetch, info, _ = _transformer_big(
        warmup_steps=WMT_WARMUP, flash=False)
    ops = main_prog.global_block().ops
    exe, scope = Executor(device=dev), Scope()
    exe.run(startup, scope=scope)
    feed = {k: torch.from_numpy(v).to(dev)
            for k, v in make_batch(WMT_BATCH).items()}
    warm = exe.run(main_prog, feed=feed, scope=scope, fetch_list=fetch,
                   use_compiled=False)
    builds = exe.compiled_builds
    modes = timed_modes(exe, main_prog, feed, scope, fetch, timed)
    builds = exe.compiled_builds - builds
    exe.close()
    del exe, scope, feed
    comp = modes["compiled"]
    _release()
    rec = compiled_parity(dev, 2, WMT_SEQ, 3, WMT_BATCH,
                          model="transformer_big", warmup_steps=WMT_WARMUP,
                          flash=False)
    rec.pop("last")
    _release()

    def small(flash, dropout):
        cfg = transformer.transformer_big()
        cfg.n_encoder_layers = cfg.n_decoder_layers = 2
        cfg.use_flash_attention, cfg.dropout = flash, dropout
        with unique_name.guard():
            m, s, _, f = transformer.build_wmt_program(
                cfg, seq_len=WMT_SEQ, warmup_steps=WMT_WARMUP)
        return cfg, m, s, f

    cfg, pmain, pstart, pf = small(False, 0.1)
    sc = Scope()
    Executor(device="cpu").run(pstart, scope=sc)
    state = _state_arrays(sc)
    masks = [o.outputs["Mask"][0] for o in pmain.global_block().ops
             if o.type == "dropout"]
    batch = transformer.synthetic_batch(cfg, 2, WMT_SEQ, seed=3)
    parity = {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        s2 = scope_from_numpy(state, device)
        ex = Executor(device=device)
        parity[side] = [ex.run(pmain, feed=batch, scope=s2,
                               fetch_list=[pf["loss"]] + masks)
                        for _ in range(3)]
    loss_gpu = [_loss(o) for o in parity["card"]]
    loss_cpu = [_loss(o) for o in parity["cpu"]]
    masks_equal = all(np.array_equal(x, y) for a, b in zip(
        parity["card"], parity["cpu"]) for x, y in zip(a[1:], b[1:]))
    parity_ok = masks_equal and np.allclose(loss_gpu, loss_cpu, rtol=1e-4,
                                            atol=1e-4)
    vs_fused = {}
    for flash in (False, True):
        _, m, s, f = small(flash, 0.0)
        s2 = scope_from_numpy(state, dev)
        ex = Executor(device=dev)
        vs_fused["fused" if flash else "unfused"] = [
            _loss(ex.run(m, feed=batch, scope=s2, fetch_list=[f["loss"]]))
            for _ in range(3)]
    fused_ok = np.allclose(vs_fused["unfused"], vs_fused["fused"],
                           rtol=UNFUSED_VS_FUSED_TOL,
                           atol=UNFUSED_VS_FUSED_TOL)
    emit("train_transformer_big_unfused", **info, ops=len(ops),
         softmax_ops=sum(o.type == "softmax" for o in ops),
         warmup_loss=_loss(warm), modes=_per_mode(modes),
         step_ms_p50=comp["step_ms_p50"],
         flash_train_transformer_big_step_ms_p50=flash_step_ms,
         compiled_steps_built=builds, compiled_parity_2_layers=rec,
         parity_loss_gpu=loss_gpu, parity_loss_cpu=loss_cpu,
         parity_masks=len(masks), parity_masks_bitwise_equal=masks_equal,
         parity_tolerance="rtol=atol=1e-4 (fp32)",
         unfused_vs_fused_losses=vs_fused,
         unfused_vs_fused_tolerance=UNFUSED_VS_FUSED_TOL,
         nvidia_smi=smi, seconds=time.perf_counter() - t_phase,
         note="step ms on the host clock, one synthetic batch")
    _check_legs("train_transformer_big_unfused", modes)
    for m, r in modes.items():
        if r["launches_per_step"]:
            raise AssertionError(f"train_transformer_big_unfused ({m}): "
                                 f"launches {r['launches_per_step']}")
    if builds != 1 or not (rec["losses_and_masks_bitwise_equal"]
                           and rec["masks_new_each_step"]
                           and rec["state_bitwise_equal_in_all_runs"]
                           and rec["launch_counts_equal"]):
        raise AssertionError(f"train_transformer_big_unfused: {builds} "
                             f"builds, compiled parity {rec}")
    if not parity_ok or not fused_ok:
        raise AssertionError(
            f"train_transformer_big_unfused: card {loss_gpu} against CPU "
            f"{loss_cpu} (masks {masks_equal}); unfused against fused "
            f"{vs_fused}")
    return dict(launches=comp["launches"], layouts=comp["layouts"],
                dtypes=comp["dtypes"])


def flash_general_bias(dev, batch=32, rate=0.1):
    """The flash_attention op's reference_general route on the card at
    BERT-base's attention shape (12 heads of 64, S = 128, ``batch``
    rows, packed q/k/v) with a full [B,H,Sq,Sk] and a [B,1,Sq,Sk] bias,
    fp32 and bf16, probs dropout ``rate``: Out and Lse (forward op) and
    the Q, K, V and Bias gradients (grad op) against the same ops on the
    CPU (plain PyTorch there too) within rtol = atol = 1e-4 (fp32) and
    1e-2 (bf16: both sides compute in fp32 and round once, so they may
    differ by one bf16 ulp, 2^-8 of the value);
    the route's keep mask (rng.attn_keep) bit for bit the CPU's; each
    call no kernel launch and one general-route count; then a key bias
    [B,1,1,Sk] through the same op launches the flash forward kernel
    once and counts no general call."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core import registry, rng

    t0 = time.perf_counter()
    h, hd, s = 12, 64, 128
    attrs = {"num_heads": h, "scale": hd ** -0.5, "dropout_prob": rate,
             "is_test": False, "seed": 77, "__step__": 5, "causal": False}
    fwd = registry.get("flash_attention").forward
    bwd = registry.get("flash_attention_grad").forward
    gen = torch.Generator().manual_seed(16)
    rows, ok = [], True
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        for heads in (h, 1):
            q, k, v, do = (torch.randn(batch, s, h * hd, generator=gen)
                           .to(dtype) for _ in range(4))
            bias = torch.randn(batch, heads, s, s, generator=gen)
            res = {}
            for d in (dev, "cpu"):
                kernels.reset_launch_counts()
                ins = {"Q": [q.to(d)], "K": [k.to(d)], "V": [v.to(d)],
                       "Bias": [bias.to(d)]}
                f = fwd(ins, dict(attrs))
                g = bwd(dict(ins, Out=[f["Out"]], Lse=[f["Lse"]],
                             OutGrad=[do.to(d)]), dict(attrs))
                res[str(d)] = (f, g, kernels.general_route_calls(),
                               sum(kernels.launch_counts().values()))
            (fc, gc_, calls, launched), (fr, gr, _, _) = res[str(dev)], \
                res["cpu"]
            pairs = {"Out": (fc["Out"], fr["Out"]),
                     "Lse": (fc["Lse"], fr["Lse"])}
            pairs.update({n: (gc_[n], gr[n]) for n in
                          ("QGrad", "KGrad", "VGrad", "BiasGrad")})
            err = {n: errors(a.cpu(), b)[0] for n, (a, b) in pairs.items()}
            outside = {n: outside_tol(a.cpu(), b, dict(rtol=tol, atol=tol))
                       for n, (a, b) in pairs.items()}
            shapes_ok = tuple(gc_["BiasGrad"].shape) == tuple(bias.shape)
            row_ok = not any(outside.values()) and calls == 2 and \
                not launched and shapes_ok
            ok &= row_ok
            rows.append(dict(dtype=str(dtype), bias=list(bias.shape),
                             max_abs_err=err, tol=f"rtol=atol={tol}",
                             outside_tol=outside, general_calls=calls,
                             kernel_launches=launched, ok=row_ok))
    seed = rng.op_seed(attrs)
    mask_equal = torch.equal(rng.attn_keep(seed, rate, batch, h, s, s,
                                           dev).cpu(),
                             rng.attn_keep(seed, rate, batch, h, s, s,
                                           "cpu"))
    kernels.reset_launch_counts()
    key = torch.randn(batch, 1, 1, s, generator=gen).to(dev)
    fwd({"Q": [q.to(dev)], "K": [k.to(dev)], "V": [v.to(dev)],
         "Bias": [key]}, dict(attrs))
    torch.cuda.synchronize()
    key_counts = _phase_counts()
    key_ok = key_counts["launches"]["flash_attention_fwd"] == 1 and \
        kernels.general_route_calls() == 0
    emit("flash_general_bias", batch=batch, heads=h, head_dim=hd, seq=s,
         dropout=rate, rows=rows, keep_mask_bitwise_equal=mask_equal,
         key_bias_launches=key_counts["launches"],
         key_bias_general_calls=kernels.general_route_calls(),
         seconds=time.perf_counter() - t0)
    if not (ok and mask_equal and key_ok):
        raise AssertionError(f"flash_general_bias: rows {rows}, mask "
                             f"{mask_equal}, key bias {key_counts}")
    return key_counts


def run_steps_ernie(dev, smi, k=RUN_STEPS_K, batch_size=40):
    """Executor.run_steps on ERNIE-large as train_ernie trains it (bf16,
    s512, b40, dropout, AdamW; RUN_STEPS_LAYERS of its 24 layers), k =
    ``k``: the step's key
    warmed (its first run op by op, its second captured), the state put
    back, then from that one state ``k`` run() calls (k batches), the
    state put back again, and one run_steps over the same k batches
    stacked. Gates: the losses and one dropout mask a step, every
    parameter and moment, and the step counter, bit for bit; the flash
    forward, flash backward and AdamW launches of run_steps equal those
    of the k run() calls, k times a step's (one a layer each, and 14 +
    16 a layer AdamW). Prints the ms a step of each (host clock, each
    ending in a synchronise)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.core.executor import STEP_COUNTER, Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import bert

    t_phase = time.perf_counter()
    layers = RUN_STEPS_LAYERS
    cfg, main_prog, startup, fetches = _ernie_programs(layers, "bfloat16")
    n_adamw = sum(o.type == "adamw" for o in main_prog.global_block().ops)
    mask = next(o.outputs["Mask"][0] for o in main_prog.global_block().ops
                if o.type == "dropout")
    fetch = [fetches["loss"].name, mask]
    exe, scope = Executor(device=dev), Scope()
    exe.run(startup, scope=scope)
    batches = [bert.synthetic_pretraining_batch(
        cfg, batch_size, SEQ, seed=i, max_predictions_per_seq=MAX_PREDS)
        for i in range(k)]
    start = {n: v.clone() for n, v in scope.items()
             if isinstance(v, torch.Tensor)}
    step0 = int(scope.find_var(STEP_COUNTER))

    def restore():
        for n, v in start.items():
            scope.find_var(n).copy_(v)
        scope.set(STEP_COUNTER, np.int32(step0))

    for b in batches[:2]:       # the key's first run and its capture
        exe.run(main_prog, feed=b, scope=scope, fetch_list=fetch)
    restore()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    want = [exe.run(main_prog, feed=b, scope=scope, fetch_list=fetch)
            for b in batches]
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    run_counts = kernels.launch_counts()
    after_run = {n: scope.find_var(n).clone() for n in start}
    step_run = int(scope.find_var(STEP_COUNTER))
    restore()
    stacked = {n: np.stack([b[n] for b in batches]) for n in batches[0]}
    hist0 = telemetry.snapshot()["hists"].get("executor.run_steps_ms",
                                              {}).get("count", 0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = exe.run_steps(main_prog, feed=stacked, fetch_list=fetch, k=k,
                        scope=scope)
    torch.cuda.synchronize()
    steps_ms = (time.perf_counter() - t0) * 1e3
    counts = _phase_counts()
    timer = telemetry.snapshot()["hists"]["executor.run_steps_ms"]
    fetch_equal = all(np.array_equal(got[j][i], want[i][j])
                      for i in range(k) for j in range(len(fetch)))
    state_equal = all(torch.equal(scope.find_var(n), v)
                      for n, v in after_run.items())
    counter_equal = int(scope.find_var(STEP_COUNTER)) == step_run == \
        step0 + k
    per_step = {"flash_attention_fwd": layers,
                "flash_attention_bwd": layers, "fused_adamw": n_adamw}
    launches_ok = all(counts["launches"][n] == run_counts[n] == k * c
                      for n, c in per_step.items())
    emit("run_steps_ernie", model="ernie_large", layers=layers, seq=SEQ,
         batch=batch_size, k=k, losses_run=[_loss(w) for w in want],
         losses_run_steps=np.asarray(got[0], np.float32).reshape(
             -1).tolist(),
         fetches_bitwise_equal=fetch_equal, state_bitwise_equal=state_equal,
         state_tensors=len(after_run), step_counter_equal=counter_equal,
         launches_run_steps=counts["launches"], launches_runs=run_counts,
         run_ms_per_step=run_ms / k, run_steps_ms_per_step=steps_ms / k,
         run_steps_timer_samples=timer["count"] - hist0, nvidia_smi=smi,
         seconds=time.perf_counter() - t_phase,
         note="host clock; run() reads its fetches back each step, "
              "run_steps once")
    exe.close()
    if not (fetch_equal and state_equal and counter_equal and launches_ok
            and n_adamw == 14 + 16 * layers
            and timer["count"] == hist0 + 1):
        raise AssertionError(
            f"run_steps_ernie: fetches {fetch_equal}, state {state_equal}, "
            f"counter {counter_equal}, launches {counts['launches']} "
            f"against {run_counts}")
    return counts


def dropout_2p32(dev, smi):
    """One dropout op (upscale_in_train, rate DROPOUT_BIG_RATE) over a
    bf16 [65536, 65536] tensor, 2^32 elements: the threefry branch
    (rng.threefry_masks counts it), the kept share within 1e-4 of
    1 - rate, and DROPOUT_SAMPLE positions spread over the whole index
    range, the first and the last included, whose mask equals the CPU's
    threefry bits at the same positions and whose output equals x / (1 -
    rate) where kept and 0 elsewhere, bit for bit. Prints the op's time
    and its peak memory beyond x."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core import registry, rng

    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    x = torch.randn(DROPOUT_BIG, dtype=torch.bfloat16, device=dev)
    n = x.numel()
    attrs = {"dropout_prob": DROPOUT_BIG_RATE, "seed": 4242,
             "__step__": 3, "dropout_implementation": "upscale_in_train"}
    before = rng.threefry_masks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = registry.get("dropout").forward({"X": [x]}, dict(attrs))
    torch.cuda.synchronize()
    op_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    took = rng.threefry_masks == before + 1
    mask, y = out["Mask"].reshape(-1), out["Out"].reshape(-1)
    share = float(mask.sum(dtype=torch.int64)) / n
    pick = np.unique(np.concatenate([
        [0, n - 1], np.random.RandomState(0).randint(
            0, n, DROPOUT_SAMPLE - 2, dtype=np.int64)]))
    idx = torch.from_numpy(pick)
    cpu_keep = (rng.threefry_bits_at(rng.op_key(attrs), idx) >> 9) < \
        rng.keep_below(DROPOUT_BIG_RATE)
    card_keep = mask[idx.to(dev)].cpu().bool()
    xs = x.reshape(-1)[idx.to(dev)]
    want_y = torch.where(cpu_keep.to(dev), xs / (1.0 - DROPOUT_BIG_RATE),
                         torch.zeros_like(xs))
    sample_equal = torch.equal(card_keep, cpu_keep) and torch.equal(
        y[idx.to(dev)], want_y)
    emit("dropout_2p32", shape=list(DROPOUT_BIG), elements=n,
         dtype="bfloat16", rate=DROPOUT_BIG_RATE, threefry_branch=took,
         kept_share=share, sample_positions=int(len(pick)),
         sample_bitwise_equal=sample_equal, op_seconds=op_s,
         peak_bytes_beyond_x=int(peak), x_bytes=x.numel() * 2,
         chunk=rng.THREEFRY_CHUNK, nvidia_smi=smi,
         seconds=time.perf_counter() - t_phase)
    del x, out, mask, y
    if not (took and abs(share - (1 - DROPOUT_BIG_RATE)) <= 1e-4
            and sample_equal):
        raise AssertionError(f"dropout_2p32: branch {took}, kept share "
                             f"{share}, sample equal {sample_equal}")
    return _phase_counts()


# the observability slice: where its run logs go (removed at the end), the
# timed steps of each leg of observe_train_ernie, and the decode queue rule
# of observe_serve_int8 (one waiting request trips it: 9 requests on 8
# slots queue one, and the admission bound of 256 rejects none)
OBSERVE_DIR = Path(__file__).resolve().parent / "build" / "torch_observe"
OBSERVE_TIMED = 6
# observe_train_ernie's depth: 12 of ERNIE-large's 24 layers (24 before
# the linalg_extra_card phase took its seconds)
OBSERVE_LAYERS = 12
OBSERVE_OVERHEAD = 1.03
OBSERVE_RULE = [{"name": "decode_queue", "metric": "decode.queue_depth",
                 "kind": "gauge", "threshold": 0.5, "direction": "above",
                 "cooldown_s": 600.0}]


def _ernie_hand_flops(cfg, batch, seq, preds):
    """Model flops of one ERNIE training step by hand: each layer's six
    projections (2TH^2 each of QKV and the output, 2 * 2TH*4H the FFN)
    and attention's two products (4 B S^2 H), the masked-LM head's
    transform and decoder on its predictions, all three times (the
    forward and twice that backward)."""
    t, h, f = batch * seq, cfg.hidden_size, cfg.intermediate_size
    layer = 2 * t * h * h * 4 + 2 * 2 * t * h * f + 4 * batch * seq * seq * h
    head = 2 * batch * preds * (h * h + h * cfg.vocab_size)
    return 3.0 * (cfg.num_hidden_layers * layer + head)


def _tool(name, *args):
    """A report tool of the repo's tools/ as a subprocess: (rc, stdout,
    stderr)."""
    root = Path(__file__).resolve().parent
    r = subprocess.run([sys.executable, str(root / "tools" / name), *args],
                       capture_output=True, text=True, timeout=300)
    return r.returncode, r.stdout, r.stderr


def _read_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def observe_train_ernie(dev, smi, batch_size=40, timed=OBSERVE_TIMED):
    """The observability plane over ERNIE-large s512 b40 (OBSERVE_LAYERS of
    its 24 layers,
    bf16, flash, dropout 0.1, AdamW), compiled. From one state: leg A,
    ``timed`` replays with the sink off; leg B, on a fresh Executor with
    the run-log sink on, cost capture ``full``, every root span sampled
    and a goodput window: its first run op by op, its capture, ``timed``
    replays. Gates: B's step ms p50 within OBSERVE_OVERHEAD of A's; the
    capture's flops equal a fresh meta count of the same program built
    anew, dispatch_flops (capture + replays) times them exactly; the live
    MFU in (0, 1]; the capture's peak bytes within 1 % of an op-by-op
    step's max_memory_allocated; goodput's phases adding up to its wall
    within 1 %; perf_report --json and mem_report on the log with rc 0,
    one compile, cache hits = compiled runs - 1, the memcost, goodput
    and tracing sections; a fill_constant of 2^40 floats raising
    costmodel.OutOfMemoryError with one oom record, the next ERNIE step
    finite; device_profile over 3 op-by-op steps attributing one flash
    forward and one flash backward a layer and every AdamW kernel (14 +
    16 a layer) a step to their op
    types, equal to the launch counters; costmodel.unavailable 0."""
    from paddle_tpu_torch import kernels, layers, profiler
    from paddle_tpu_torch.core import costmodel, flags, goodput, telemetry
    from paddle_tpu_torch.core.executor import Executor, program_cost
    from paddle_tpu_torch.core.ir import Program, program_guard
    from paddle_tpu_torch.core.scope import STEP_COUNTER, Scope
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.tools.profile_train import MARKERS

    t_phase = time.perf_counter()
    OBSERVE_DIR.mkdir(parents=True, exist_ok=True)
    log = OBSERVE_DIR / "observe_train_ernie.jsonl"
    log.unlink(missing_ok=True)
    cfg, main_prog, startup, fetches = _ernie_programs(OBSERVE_LAYERS,
                                                       "bfloat16")
    fetch = [fetches["loss"].name]
    n_adamw = sum(o.type == "adamw" for o in main_prog.global_block().ops)
    scope = Scope()
    exe = Executor(device=dev)
    exe.run(startup, scope=scope)
    batch = bert.synthetic_pretraining_batch(
        cfg, batch_size, SEQ, seed=0, max_predictions_per_seq=MAX_PREDS)
    start = {n: v.clone() for n, v in scope.items()
             if isinstance(v, torch.Tensor)}
    step0 = int(scope.find_var(STEP_COUNTER) or 0)

    def restore():
        for n, v in start.items():
            scope.find_var(n).copy_(v)
        scope.set(STEP_COUNTER, np.int32(step0))

    def timed_steps(executor, n):
        ms, losses = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            out = executor.run(main_prog, feed=batch, scope=scope,
                               fetch_list=fetch)
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(_loss(out))
        return ms, losses

    # leg A: the sink off
    for _ in range(2):          # the key's first run and its capture
        exe.run(main_prog, feed=batch, scope=scope, fetch_list=fetch)
    restore()
    a_ms, a_losses = timed_steps(exe, timed)
    exe.close()
    del exe
    _release()
    # leg B: the sink on, a fresh executor from the same state
    restore()
    prior = flags.apply({"cost_capture": "full", "trace_sample_rate": 1.0})
    telemetry.reset()
    costmodel.reset()
    telemetry.configure(str(log))
    problems = []
    try:
        exe = Executor(device=dev)
        goodput.start_run()
        exe.run(main_prog, feed=batch, scope=scope, fetch_list=fetch)
        t0 = time.perf_counter()
        exe.run(main_prog, feed=batch, scope=scope, fetch_list=fetch)
        capture_s = time.perf_counter() - t0
        t_timed = time.perf_counter()
        b_ms, b_losses = timed_steps(exe, timed)
        timed_s = time.perf_counter() - t_timed
        breakdown = goodput.breakdown()
        goodput.publish()
        (rec,) = costmodel.programs()
        dispatch_flops = telemetry.counter_get("cost.dispatch_flops")
        mfu = costmodel.live_mfu(window_s=max(1.0, float(np.ceil(
            timed_s))))
        mfu_gauge = telemetry.gauges().get("cost.live_mfu")
        exe.close()
        del exe
        _release()
        # one fill_constant of 2^40 floats (4 TiB) on a fresh executor
        oom_prog = Program()
        with program_guard(oom_prog, Program()):
            huge = layers.fill_constant([1 << 40], "float32", 0.0)
        exe = Executor(device=dev)
        try:
            exe.run(oom_prog, fetch_list=[huge])
            oom_raised = None
        except costmodel.OutOfMemoryError as e:
            oom_raised = str(e)[:160]
        # the program runs on: one op-by-op step, its peak beside the
        # capture's
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        after_oom = _loss(exe.run(main_prog, feed=batch, scope=scope,
                                  fetch_list=fetch, use_compiled=False))
        torch.cuda.synchronize()
        step_peak = torch.cuda.max_memory_allocated()
        telemetry.flush()
    finally:
        telemetry.configure(None)
        flags.apply(prior)
    unavailable = telemetry.counter_get("costmodel.unavailable")
    # a fresh meta count of the same program, built anew
    _, fresh_prog, _, fresh_fetches = _ernie_programs(OBSERVE_LAYERS,
                                                  "bfloat16")
    t0 = time.perf_counter()
    fresh = program_cost(fresh_prog, batch, [fresh_fetches["loss"].name],
                         scope)
    count_s = time.perf_counter() - t0
    hand = _ernie_hand_flops(cfg, batch_size, SEQ, MAX_PREDS)
    # the report tools over the log
    rc_perf, perf_out, perf_err = _tool("perf_report.py", str(log), "--json")
    perf = json.loads(perf_out) if rc_perf == 0 else {}
    rc_mem, mem_out, mem_err = _tool("mem_report.py", str(log))
    recs = _read_log(log)
    ooms = [r for r in recs if r["kind"] == "oom"]
    # device_profile: 3 op-by-op steps, kernels by their op's range
    profiler.device_profile(lambda: None, steps=1)    # warm the tracer
    kernels.reset_launch_counts()
    prof = profiler.device_profile(
        lambda: exe.run(main_prog, feed=batch, scope=scope,
                        fetch_list=fetch, use_compiled=False), steps=3)
    launched = kernels.launch_counts()
    exe.close()

    def traced(src, counter):
        return sum(c for k, c in prof["kernels"].get(src, {}).items()
                   if any(m in k for m in MARKERS[counter]))

    def anywhere(counter):
        return sum(c for by in prof["kernels"].values()
                   for k, c in by.items()
                   if any(m in k for m in MARKERS[counter]))

    attributed = {"flash_attention_fwd": traced("flash_attention",
                                                "flash_attention_fwd"),
                  "flash_attention_bwd": traced("flash_attention_grad",
                                                "flash_attention_bwd"),
                  "fused_adamw": traced("adamw", "fused_adamw")}
    per_step = {"flash_attention_fwd": OBSERVE_LAYERS,
                "flash_attention_bwd": OBSERVE_LAYERS, "fused_adamw": n_adamw}
    a_p50, b_p50 = _pct(a_ms, 0.5), _pct(b_ms, 0.5)
    phases_sum = breakdown["productive_ms"] + sum(
        breakdown["phases"].values())
    compiled_runs = 1 + timed
    emit("observe_train_ernie", model="ernie_large", layers=OBSERVE_LAYERS,
         seq=SEQ,
         batch=batch_size, timed_steps=timed,
         leg_a_step_ms_p50=a_p50, leg_b_step_ms_p50=b_p50,
         leg_a_step_ms=a_ms, leg_b_step_ms=b_ms,
         overhead=b_p50 / a_p50, losses_a=a_losses, losses_b=b_losses,
         capture_s=capture_s, flops=rec.flops, fresh_meta_flops=fresh[0],
         meta_count_s=count_s, hand_model_flops=hand,
         counted_over_hand=rec.flops / hand, bytes_accessed=rec.bytes_accessed,
         gemm_dtype=rec.gemm_dtype, roofline=rec.roofline(),
         intensity=rec.intensity(), dispatch_flops=dispatch_flops,
         compiled_runs=compiled_runs, live_mfu=mfu,
         live_mfu_gauge=mfu_gauge, peak_flops=rec.peak_flops(),
         capture_peak_bytes=rec.peak_bytes, capture_arg_bytes=rec.arg_bytes,
         capture_temp_bytes=rec.temp_bytes, step_peak_bytes=step_peak,
         goodput=breakdown, goodput_phases_sum_ms=phases_sum,
         oom=oom_raised, oom_records=len(ooms), loss_after_oom=after_oom,
         perf_report_rc=rc_perf, mem_report_rc=rc_mem,
         perf_report_compiles=len(perf.get("compiles", [])),
         perf_report_cache_hits=perf.get("counters", {}).get(
             "executor.cache_hits", {}).get("last"),
         perf_report_sections={k: perf.get(k) is not None for k in
                               ("memcost", "goodput", "tracing")},
         log_records=len(recs), costmodel_unavailable=unavailable,
         device_profile_ms_per_step=prof["ms_per_step"],
         device_profile_rows=prof["rows"][:12],
         device_profile_attributed=attributed,
         device_profile_op_spans=prof["op_spans"],
         device_profile_unattributed=sorted(
             prof["kernels"].get("other", {}).items(),
             key=lambda kv: -kv[1])[:6],
         device_profile_records=prof["kernel_records"],
         device_profile_anywhere={c: anywhere(c) for c in per_step},
         device_profile_launches=launched, nvidia_smi=smi,
         seconds=time.perf_counter() - t_phase,
         note="step ms on the host clock; live_mfu over the timed "
              "replays' window")
    if not b_p50 <= OBSERVE_OVERHEAD * a_p50:
        problems.append(f"leg B p50 {b_p50:.2f} ms over {OBSERVE_OVERHEAD} "
                        f"x leg A's {a_p50:.2f}")
    if not (rec.flops == fresh[0] and rec.flops > 0):
        problems.append(f"flops {rec.flops} != fresh count {fresh[0]}")
    if dispatch_flops != compiled_runs * int(rec.flops_per_dispatch()):
        problems.append(f"dispatch_flops {dispatch_flops} != "
                        f"{compiled_runs} x {rec.flops_per_dispatch()}")
    if not 0.0 < mfu <= 1.0:
        problems.append(f"live MFU {mfu}")
    if not abs(rec.peak_bytes - step_peak) <= 0.01 * step_peak:
        problems.append(f"capture peak {rec.peak_bytes} vs step peak "
                        f"{step_peak}")
    if not abs(phases_sum - breakdown["wall_ms"]) <= \
            0.01 * breakdown["wall_ms"]:
        problems.append(f"goodput phases {phases_sum} vs wall "
                        f"{breakdown['wall_ms']}")
    if rc_perf or rc_mem:
        problems.append(f"perf_report rc {rc_perf} ({perf_err[-300:]}), "
                        f"mem_report rc {rc_mem} ({mem_err[-300:]})")
    elif not (len(perf["compiles"]) == 1 and perf["counters"][
            "executor.cache_hits"]["last"] == compiled_runs - 1 and all(
                perf[k] for k in ("memcost", "goodput", "tracing"))):
        problems.append(f"perf_report: compiles {len(perf['compiles'])}, "
                        f"cache hits {perf['counters'].get('executor.cache_hits')}")
    if oom_raised is None or len(ooms) != 1 or not np.isfinite(after_oom):
        problems.append(f"OOM: raised {oom_raised}, {len(ooms)} records, "
                        f"loss after {after_oom}")
    for c, n in per_step.items():
        if not (attributed[c] == anywhere(c) == launched[c] == 3 * n):
            problems.append(f"device_profile {c}: attributed "
                            f"{attributed[c]}, traced {anywhere(c)}, "
                            f"launched {launched[c]}, want {3 * n}")
    if unavailable:
        problems.append(f"costmodel.unavailable {unavailable}")
    if problems:
        raise AssertionError(f"observe_train_ernie: {problems}")
    return dict(launches=launched, layouts=kernels.layout_counts(),
                dtypes=kernels.dtype_counts())


def _spawn_replica(model_dir, log, env):
    """One decode replica process (python -m
    paddle_tpu_torch.serving.replica) on the card with its run log at
    ``log``: (the process, its URL), once it announced itself; its
    output is drained into a list."""
    cmd = [sys.executable, "-m", "paddle_tpu_torch.serving.replica",
           "--decode-model-dir", model_dir, "--device", "cuda",
           "--port", "0", "--telemetry-log", str(log)]
    root = str(Path(__file__).resolve().parent)
    env = dict(env, PYTHONPATH=root + ":" + env.get("PYTHONPATH", ""))
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, bufsize=1)
    lines, ready = [], {}

    def drain():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith("PT_REPLICA_READY ") and not ready:
                ready.update(json.loads(line[len("PT_REPLICA_READY "):]))

    threading.Thread(target=drain, daemon=True).start()
    deadline = time.time() + 300
    while not ready and proc.poll() is None and time.time() < deadline:
        time.sleep(0.1)
    if not ready:
        proc.kill()
        raise AssertionError(f"replica never announced: {lines[-20:]}")
    while time.time() < deadline:   # warmed: /healthz 200
        try:
            if _http("GET", ready["url"], "/healthz", timeout=10)[0] == 200:
                return proc, ready["url"], lines
        except OSError:
            pass
        time.sleep(0.2)
    proc.kill()
    raise AssertionError(f"replica never became ready: {lines[-20:]}")


def observe_serve_int8(dev, cfg, model_dir, want_ids, want_launches):
    """One decode replica process of the README's decoder LM in
    weight-only int8 (8 slots), started with --telemetry-log, every root
    span sampled, and the SLO watchdog armed with OBSERVE_RULE
    (decode.queue_depth above 0.5, through rules_from_spec). One request
    alone first (its span ends before the queue builds), then the serve
    phases' 9 requests at once, each with an X-Request-Id. Gates: the 9
    answers are serve_http_int8's ids bit for bit, and their flash
    forward, paged attention and int8 GEMM launches (the replica's
    /v1/stats before and after) serve_http_int8's; after SIGTERM (exit 0)
    the log holds a span of each request's trace id, perf_report's
    Decode section with KV pages allocated = freed (no LEAKED), the
    mem.serving.kv_* gauges, and exactly one incident whose flight
    recorder ring is not empty and whose trace ids include a request's;
    incident_report renders it with rc 0."""
    import signal

    t_phase = time.perf_counter()
    OBSERVE_DIR.mkdir(parents=True, exist_ok=True)
    log = OBSERVE_DIR / "observe_serve_int8.jsonl"
    log.unlink(missing_ok=True)
    env = _replica_env(
        decode_weight_quant="int8", decode_max_slots=SERVE_CONF["max_slots"],
        decode_page_size=SERVE_CONF["page_size"],
        decode_kv_pages=SERVE_CONF["kv_pages"],
        decode_max_new_tokens=SERVE_CONF["max_new_tokens"],
        trace_sample_rate=1.0, slo_watchdog="on", slo_eval_s=0.0,
        slo_rules=json.dumps(OBSERVE_RULE))
    reqs = _serve_requests(cfg)
    t0 = time.perf_counter()
    proc, url, out_lines = _spawn_replica(model_dir, log, env)
    up_s = time.perf_counter() - t0
    try:
        probe = _http("POST", url, "/v1/generate", _wire_body(reqs[0]),
                      headers={"X-Request-Id": "observe-probe"})
        before = _http("GET", url, "/v1/stats")[1]["decode"]
        t0 = time.perf_counter()
        answers = _post_all(url, [_wire_body(r) for r in reqs],
                            headers=[{"X-Request-Id": f"observe-{i}"}
                                     for i in range(len(reqs))])
        wall = time.perf_counter() - t0
        after = _http("GET", url, "/v1/stats")[1]["decode"]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait(timeout=30)
    launches, layouts = _count_delta({"r": before}, {"r": after})
    int8_instances = {k: after["int8_instances"][k] -
                      before["int8_instances"].get(k, 0)
                      for k in after["int8_instances"]}
    got = [a[1].get("tokens") if a[0] == 200 else None for a in answers]
    recs = _read_log(log)
    ids = [f"observe-{i}" for i in range(len(reqs))]
    span_traces = {r["attrs"].get("trace") for r in recs
                   if r["kind"] == "span"}
    incidents = [r for r in recs if r["kind"] == "incident"]
    gauges = {r["name"] for r in recs if r["kind"] == "gauge"}
    kv_gauges = {g for g in gauges if g.startswith("mem.serving.kv_")}
    rc_perf, perf_out, perf_err = _tool("perf_report.py", str(log), "--json")
    decode = json.loads(perf_out)["decode"] if rc_perf == 0 else {}
    rc_text, text_out, _ = _tool("perf_report.py", str(log))
    rc_inc, inc_out, inc_err = _tool("incident_report.py", str(log))
    inc = incidents[0]["attrs"] if incidents else {}
    problems = []
    if probe[0] != 200 or got != want_ids:
        problems.append(f"ids != serve_http_int8's: probe {probe[0]}, "
                        f"equal {[g == w for g, w in zip(got, want_ids)]}")
    rows = ("flash_attention_fwd", "paged_attention", "int8_gemm")
    if any(launches[n] != want_launches[n] for n in rows):
        problems.append(f"launches {launches} vs serve_http_int8's "
                        f"{want_launches}")
    if rc != 0:
        problems.append(f"replica exit code {rc}: {out_lines[-10:]}")
    if not set(ids) <= span_traces:
        problems.append(f"spans lack trace ids "
                        f"{sorted(set(ids) - span_traces)}")
    if rc_perf or rc_text or "LEAKED" in text_out or not decode or \
            decode.get("kv_pages_allocated") != \
            decode.get("kv_pages_freed"):
        problems.append(f"perf_report rc {rc_perf}/{rc_text}, decode "
                        f"{decode}: {perf_err[-300:]}")
    if kv_gauges != {"mem.serving.kv_pool_bytes",
                     "mem.serving.kv_used_bytes",
                     "mem.serving.kv_high_water_bytes"}:
        problems.append(f"kv gauges {sorted(kv_gauges)}")
    if len(incidents) != 1 or not inc.get("ring") or not \
            set(inc.get("traces", [])) & (set(ids) | {"observe-probe"}):
        problems.append(f"{len(incidents)} incidents, ring "
                        f"{len(inc.get('ring') or [])}, traces "
                        f"{inc.get('traces')}")
    if rc_inc:
        problems.append(f"incident_report rc {rc_inc}: {inc_err[-300:]}")
    emit("observe_serve_int8", requests=len(reqs), replica_up_s=up_s,
         wall_s=wall, ids_equal_serve_http_int8=got == want_ids,
         launches=launches, int8_launches_by_instance=int8_instances,
         want_launches={n: want_launches[n] for n in rows},
         replica_exit=rc, log_records=len(recs),
         spans=sum(r["kind"] == "span" for r in recs),
         request_traces_with_spans=len(set(ids) & span_traces),
         decode_section={k: decode.get(k) for k in (
             "requests", "prefills", "steps", "tokens",
             "kv_pages_allocated", "kv_pages_freed", "kv_pool_bytes",
             "kv_high_water_bytes")},
         kv_gauges=sorted(kv_gauges), incidents=len(incidents),
         incident_name=incidents[0]["name"] if incidents else None,
         incident_ring=len(inc.get("ring") or []),
         incident_traces=inc.get("traces"),
         incident_report_rc=rc_inc, perf_report_rc=rc_perf,
         seconds=time.perf_counter() - t_phase)
    if problems:
        raise AssertionError(f"observe_serve_int8: {problems}")
    return dict(launches=launches, layouts=layouts,
                int8_instances=int8_instances)


def _glue_tensor(v):
    """A case's input as the op gets it (``glue_cases.as_tensor``): int64
    as int32, float64 as float32, a ``BF16`` input as bfloat16."""
    from paddle_tpu_torch.tools import glue_cases

    return glue_cases.as_tensor(v)


def _glue_diff(got, want, tol):
    """(agrees, worst finite abs error) of a card output against the
    CPU's: shape and dtype equal; integers and bools bit for bit; floats
    with NaN and the infinities where the CPU has them, the rest within
    rtol = atol = tol."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False, float("inf")
    if not want.is_floating_point():
        return bool(torch.equal(got, want)), 0.0
    g, w = got.double(), want.double()
    fin = torch.isfinite(w)
    same_special = torch.equal(torch.isnan(g), torch.isnan(w)) and \
        torch.equal(torch.where(fin, 0.0, g.nan_to_num(0.0)),
                    torch.where(fin, 0.0, w.nan_to_num(0.0)))
    err = float((g - w)[fin].abs().max()) if bool(fin.any()) else 0.0
    ok = same_special and bool(torch.allclose(g[fin], w[fin], rtol=tol,
                                              atol=tol))
    return ok, err


# the op types of the glue cases: the math, tensor, RNN, sequence and
# beam-search ops (104, randint among them), the CRF ops (4), the fused
# RNN ops (5), the tensor-array, rank-table and split/merge ops (8), the
# 2.0 API's (36), and linalg_ops' and extra_ops' (64)
GLUE_OP_TYPES = 104 + 4 + 5 + 8 + 36 + 64


def ops_glue_card(dev):
    """Every op type of the glue cases (the math, tensor, RNN, sequence,
    beam-search, CRF, fused-RNN and tensor-array ops) on the card against
    the CPU:
    each case of ``tools/glue_cases.py`` through the port's lowering on
    the card and on the CPU from the same inputs (a case the CPU refuses
    must raise the same exception type on the card); randint's draw in
    [low, high) and int32. Prints the cases, ops and the worst error of
    each family; any disagreement raises."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.tools import glue_cases

    t0 = time.perf_counter()
    kernels.reset_launch_counts()

    def run(op, ins, attrs, device):
        t = {k: [None if v is None else _glue_tensor(v).to(device)
                 for v in vs] for k, vs in ins.items()}
        out = registry.normalize_outputs(registry.get(op).forward(
            t, dict(attrs)))
        return {k: [v.cpu() for v in vs] for k, vs in out.items()}

    worst, bad, raised, ops = {}, [], 0, set()
    for case in sorted(glue_cases.CASES):
        op = case.split("[")[0]
        ops.add(op)
        fam = glue_cases.family(op)
        ins, attrs = glue_cases.CASES[case](glue_cases.rng(case))
        try:
            want = run(op, ins, attrs, "cpu")
        except Exception as e:                      # noqa: BLE001
            try:
                run(op, ins, attrs, dev)
                bad.append(dict(case=case, why="card ran where the CPU "
                                f"raised {type(e).__name__}"))
            except type(e):
                raised += 1
            except Exception as e2:                 # noqa: BLE001
                bad.append(dict(case=case, why=f"{type(e2).__name__} on "
                                f"the card, {type(e).__name__} on the CPU"))
            continue
        got = run(op, ins, attrs, dev)
        for slot, vals in want.items():
            for i, w in enumerate(vals):
                ok, err = _glue_diff(got[slot][i], w,
                                     glue_cases.CARD_TOL[fam])
                worst[fam] = max(worst.get(fam, 0.0), err)
                if not ok:
                    bad.append(dict(case=case, slot=f"{slot}[{i}]",
                                    err=err))
    ri = run("randint", {}, {"shape": [4096], "low": -3, "high": 7,
                             "seed": 8}, dev)["Out"][0]
    ops.add("randint")
    randint_ok = ri.dtype == torch.int32 and int(ri.min()) == -3 and \
        int(ri.max()) == 6
    emit("ops_glue_card", cases=len(glue_cases.CASES), ops=len(ops),
         cpu_refusals_matched=raised, worst_abs_err_by_family=worst,
         tolerance_by_family=glue_cases.CARD_TOL, randint_ok=randint_ok,
         disagreements=bad[:20], seconds=time.perf_counter() - t0)
    if bad or not randint_ok or len(ops) != GLUE_OP_TYPES:
        raise AssertionError(f"ops_glue_card: {len(bad)} disagreements "
                             f"{bad[:5]}, randint_ok {randint_ok}, "
                             f"{len(ops)} op types")
    return _phase_counts()


def _compiled_leg(dev, prog, fetch, feed, scope, timed=0,
                  return_numpy=True):
    """``prog`` run as its compiled step on a fresh executor: the key's
    first run goes op by op, its second builds the step (captured and
    replayed, or run uncaptured where an op decides on the host), then
    ``timed`` more runs (host ms each, synchronised). Returns (first
    outputs, second outputs, captured, uncaptured runs, ms)."""
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.core.executor import Executor

    exe = Executor(device=dev)
    u0 = telemetry.counter_get("executor.uncaptured_steps")

    def run():
        return exe.run(prog, feed=feed, fetch_list=fetch, scope=scope,
                       use_compiled=True, return_numpy=return_numpy)

    first, second = run(), run()
    ms = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    built = [c for by in exe._compiled[prog].values() for c in by.values()
             if hasattr(c, "graph")]
    captured = bool(built) and built[0].graph.graph is not None
    uncaptured = telemetry.counter_get("executor.uncaptured_steps") - u0
    exe.close()
    return first, second, captured, uncaptured, ms


def _same(a, b):
    """Outputs equal bit for bit (shape, dtype, NaN where NaN), numpy or
    torch."""
    def one(x, y):
        if isinstance(x, torch.Tensor):
            if x.shape != y.shape or x.dtype != y.dtype:
                return False
            if x.is_floating_point():
                return bool(((x == y) | (torch.isnan(x) & torch.isnan(y)))
                            .all())
            return bool(torch.equal(x, y))
        x, y = np.asarray(x), np.asarray(y)
        return x.shape == y.shape and x.dtype == y.dtype and \
            np.array_equal(x, y, equal_nan=np.issubdtype(y.dtype,
                                                         np.floating))
    return len(a) == len(b) and all(one(x, y) for x, y in zip(a, b))


def _rel_to_max(got, want):
    """max |got - want| over max |want|, ignoring NaN."""
    if isinstance(got, torch.Tensor):
        d = (got - want).abs().nan_to_num(0.0)
        return float(d.max() / want.abs().nan_to_num(0.0).max()
                     .clamp(min=1e-30))
    got, want = np.asarray(got), np.asarray(want)
    return float(np.nanmax(np.abs(got - want))
                 / max(float(np.nanmax(np.abs(want))), 1e-30))


def linalg_extra_card(dev, vocab=30522, mlm_rows=64 * 128,
                      towers=(4096, 256), auc_batches=16,
                      table=(18000, 1024), n_ids=8192, act=(8192, 768),
                      mats=(256, 64), nshards=4):
    """The linalg_ops / extra_ops slice on the card at the widths of the
    port's models (``tools/linalg_extra_cases.py``). Each leg runs op by
    op and as one compiled step on a fresh executor, the two bit for
    bit, the step captured into a CUDA graph with no uncaptured run (but
    the inverse leg, below):
    - mlm: BERT-base's masked-LM loss by logsumexp + nll_loss over
      [b64 x s128, 30522] logits (about 1 GB, drawn on the card) and its
      gradient, against softmax_with_cross_entropy's program on the same
      logits (loss within 1e-5 relative, gradient within 1e-5 of its
      largest magnitude); 5 runs of the captured step timed with only the
      loss fetched;
    - ctr: cos_sim of two [4096, 256] towers and auc (4095 thresholds)
      streamed over 16 batches compiled, over the same batches op by op
      and on the CPU: the stat vars bit for bit, the AUC within 1e-6 of
      the CPU's and of metric.Auc in numpy;
    - embedding: scatter_nd of 8192 ids (repeats, ids past the table,
      negative ones) into ERNIE-large's [18000, 1024] table, equal over
      three runs and within fp32 rounding of a float64 CPU sum (2^-20 of
      each row's absolute sum), and shard_index for 4 shards bit for bit
      the CPU's;
    - order statistics: kthvalue, median and mode along the last axis of
      [8192, 768] activations with ties, bit for bit the CPU's;
    - cholesky of [256, 64, 64], member 1 not positive definite: its
      factor NaN on and below the diagonal and 0 above, filled on the
      device inside the captured step; within 1e-4 of the CPU's
      (relative to the largest magnitude);
    - inverse of the same: within 1e-4 of the CPU's; ``inv_ex`` cannot
      be captured on CUDA, so the op decides on the host and its compiled
      step runs uncaptured, counted once a run.
    Prints each leg's errors, flags and seconds and the peak memory; no
    port kernel runs here (launch counts 0)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.metric import Auc
    from paddle_tpu_torch.tools import control_flow_cases as cfc
    from paddle_tpu_torch.tools import linalg_extra_cases as lec

    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    P = cfc.port()
    legs, problems = {}, []

    def names(f):
        return [v.name for v in f]

    def op_by_op(prog, fetch, feed, device=dev, return_numpy=True):
        return Executor(device=device).run(
            prog, feed=feed, fetch_list=fetch, scope=Scope(),
            use_compiled=False, return_numpy=return_numpy)

    def gate(leg, ok, what):
        if not ok:
            problems.append(f"{leg}: {what}")

    def compiled(leg, prog, fetch, feed, want, uncaptured=0, **kw):
        first, second, captured, unc, _ = _compiled_leg(
            dev, prog, fetch, feed, Scope(), **kw)
        equal = _same(first, want) and _same(second, want)
        legs[leg].update(captured=captured, uncaptured_runs=unc,
                         compiled_equals_op_by_op=equal)
        gate(leg, captured == (uncaptured == 0) and unc == uncaptured
             and equal, f"captured {captured}, uncaptured {unc}, equal "
             f"{equal}")

    # -- mlm: BERT-base's masked-LM loss -----------------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    feed = {"logits": torch.randn(mlm_rows, vocab, device=dev,
                                  generator=gen) * 2.0,
            "label": torch.randint(0, vocab, (mlm_rows, 1), device=dev,
                                   generator=gen)}
    prog, _, fetch = cfc.build(P, lambda P: lec.mlm_nll(P, mlm_rows, vocab))
    want = op_by_op(prog, names(fetch), feed, return_numpy=False)
    ce_prog, _, ce_fetch = cfc.build(
        P, lambda P: lec.mlm_softmax_ce(P, mlm_rows, vocab))
    ce = op_by_op(ce_prog, names(ce_fetch), feed, return_numpy=False)
    loss_rel = abs(float(want[0]) - float(ce[0])) / abs(float(ce[0]))
    grad_rel = _rel_to_max(want[1], ce[1])
    legs["mlm"] = dict(rows=mlm_rows, vocab=vocab, loss=float(want[0]),
                       loss_softmax_ce=float(ce[0]), loss_rel_err=loss_rel,
                       grad_err_rel_to_max=grad_rel)
    gate("mlm", loss_rel <= 1e-5 and grad_rel <= 1e-5,
         "against softmax_with_cross_entropy")
    del ce
    compiled("mlm", prog, names(fetch), feed, want, return_numpy=False)
    # the step timed with only the loss fetched
    ms = _compiled_leg(dev, prog, names(fetch)[:1], feed, Scope(),
                       timed=5)[-1]
    legs["mlm"].update(step_ms=ms, step_ms_p50=float(np.median(ms)),
                       seconds=time.perf_counter() - t0)
    del feed, want

    # -- ctr: cos_sim towers and a streamed auc -----------------------------
    t0 = time.perf_counter()
    n, d = towers
    feeds = lec.ctr_feeds(n, d, auc_batches)
    prog, startup, fetch = cfc.build(P, lambda P: lec.ctr_auc(P, n, d))
    runs = {}
    for mode in ("cpu", "op_by_op", "compiled"):
        device = "cpu" if mode == "cpu" else dev
        exe, scope = Executor(device=device), Scope()
        exe.run(startup, scope=scope)
        u0 = telemetry.counter_get("executor.uncaptured_steps")
        out = [exe.run(prog, feed=f, fetch_list=names(fetch), scope=scope,
                       use_compiled=mode == "compiled") for f in feeds]
        if mode == "compiled":
            built = [c for by in exe._compiled[prog].values()
                     for c in by.values() if hasattr(c, "graph")]
            captured = bool(built) and built[0].graph.graph is not None
            unc = telemetry.counter_get("executor.uncaptured_steps") - u0
        exe.close()
        runs[mode] = out
    metric = Auc(num_thresholds=4095)
    for f in feeds:
        q, t = f["query"].astype(np.float64), f["item"].astype(np.float64)
        cos = (q * t).sum(1) / np.maximum(
            np.linalg.norm(q, axis=1) * np.linalg.norm(t, axis=1), 1e-12)
        p = (cos * 0.5 + 0.5).astype(np.float32)
        metric.update(np.stack([1 - p, p], 1), f["click"])
    last = {m: r[-1] for m, r in runs.items()}
    stats_equal = _same(last["compiled"][1:], last["cpu"][1:]) and \
        _same(last["op_by_op"][1:], last["cpu"][1:])
    equal = all(_same(a, b) for a, b in zip(runs["compiled"],
                                            runs["op_by_op"]))
    auc_card = float(last["compiled"][0])
    auc_err_cpu = abs(auc_card - float(last["cpu"][0]))
    auc_err_metric = abs(auc_card - metric.accumulate())
    legs["ctr"] = dict(rows=n, width=d, batches=auc_batches,
                       auc=auc_card, auc_metric=metric.accumulate(),
                       auc_err_cpu=auc_err_cpu,
                       auc_err_metric=auc_err_metric,
                       stats_equal_cpu_bitwise=stats_equal,
                       counted=float(last["compiled"][1].sum()
                                     + last["compiled"][2].sum()),
                       captured=captured, uncaptured_runs=unc,
                       compiled_equals_op_by_op=equal,
                       seconds=time.perf_counter() - t0)
    gate("ctr", stats_equal and auc_err_cpu <= 1e-6 and
         auc_err_metric <= 1e-6 and captured and unc == 0 and equal,
         "stat vars, AUC or capture")
    del feeds, runs

    # -- embedding: scatter_nd and shard_index at ERNIE-large's table -------
    t0 = time.perf_counter()
    rows, width = table
    feed = lec.embedding_feed(n_ids, rows, width)
    prog, _, fetch = cfc.build(P, lambda P: lec.embedding_scatter(
        P, n_ids, rows, width, nshards))
    feed_dev = _feed_on(feed, dev)
    want = op_by_op(prog, names(fetch), feed_dev)
    again = op_by_op(prog, names(fetch), feed_dev)
    cpu = op_by_op(prog, names(fetch), feed, device="cpu")
    ref64 = lec.scatter_nd_float64(feed["ids"], feed["rows"], rows)
    abs64 = lec.scatter_nd_float64(feed["ids"], np.abs(feed["rows"]), rows)
    err = np.abs(want[0].astype(np.float64) - ref64)
    within = bool((err <= abs64 * 2.0 ** -20).all())
    legs["embedding"] = dict(table=[rows, width], ids=n_ids,
                             repeated_rows=int(n_ids - np.unique(
                                 feed["ids"]).size),
                             dropped=int(((feed["ids"] >= rows) |
                                          (feed["ids"] < -rows)).sum()),
                             max_abs_err_float64=float(err.max()),
                             within_fp32_rounding=within,
                             repeat_runs_bitwise=_same(again, want),
                             shards_equal_cpu=_same(want[1:], cpu[1:]))
    gate("embedding", within and _same(again, want) and
         _same(want[1:], cpu[1:]), "scatter_nd or shard_index")
    compiled("embedding", prog, names(fetch), feed_dev, want)
    legs["embedding"]["seconds"] = time.perf_counter() - t0
    del feed, feed_dev, want, again, cpu, ref64, abs64, err

    # -- order statistics over BERT-base activations with ties --------------
    t0 = time.perf_counter()
    feed = lec.order_stats_feed(*act)
    prog, _, fetch = cfc.build(P, lambda P: lec.order_stats(P, *act))
    want = op_by_op(prog, names(fetch), _feed_on(feed, dev))
    cpu = op_by_op(prog, names(fetch), feed, device="cpu")
    legs["order_stats"] = dict(shape=list(act),
                               equal_cpu_bitwise=_same(want, cpu))
    gate("order_stats", _same(want, cpu), "card against CPU")
    compiled("order_stats", prog, names(fetch), _feed_on(feed, dev), want)
    legs["order_stats"]["seconds"] = time.perf_counter() - t0

    # -- cholesky and inverse ------------------------------------------------
    b, m = mats
    feed = lec.linalg_feed(b, m, bad=1)
    for op in ("cholesky", "inverse"):
        t0 = time.perf_counter()
        prog, _, fetch = cfc.build(P, lambda P: lec.linalg(P, b, m, op))
        want = op_by_op(prog, names(fetch), _feed_on(feed, dev))
        cpu = op_by_op(prog, names(fetch), feed, device="cpu")
        err = _rel_to_max(want[0], cpu[0])
        legs[op] = dict(shape=[b, m, m], not_pd_member=1,
                        err_rel_to_max_cpu=err)
        ok = err <= 1e-4
        if op == "cholesky":
            low = np.tril(np.ones((m, m), bool))
            fill = bool(np.isnan(want[0][1][low]).all() and
                        (want[0][1][~low] == 0).all() and
                        np.isfinite(np.delete(want[0], 1, axis=0)).all())
            legs[op]["nan_fill"] = fill
            ok = ok and fill
        gate(op, ok, f"error {err} or NaN fill")
        # a step holding inverse runs uncaptured: its second run
        compiled(op, prog, names(fetch), _feed_on(feed, dev), want,
                 uncaptured=int(op == "inverse"))
        legs[op]["seconds"] = time.perf_counter() - t0

    counts = _phase_counts()
    launched = {k: v for k, v in counts["launches"].items() if v}
    emit("linalg_extra_card", legs=legs, port_kernel_launches=launched,
         peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
         seconds=time.perf_counter() - t_phase)
    if problems or launched:
        raise AssertionError(f"linalg_extra_card: {problems}; port kernel "
                             f"launches {launched}")
    return counts


def _feed_on(batch, device):
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _host_state(scope):
    return {n: v.to("cpu", copy=True) if isinstance(v, torch.Tensor) else v
            for n, v in scope.items()}


def _scope_on(state, device):
    from paddle_tpu_torch.core.scope import Scope

    sc = Scope()
    for n, v in state.items():
        sc.set(n, v.to(device, copy=True) if isinstance(v, torch.Tensor)
               else v)
    return sc


def _losses_from(prog, state, device, feeds, fetch, chained=True,
                 ref_states=None):
    """Losses of ``prog`` over ``feeds`` on ``device`` from ``state``;
    with ``chained`` False each step starts from ``ref_states[i]``. Also
    the host state before each step."""
    from paddle_tpu_torch.core.executor import Executor

    exe = Executor(device=device)
    sc = _scope_on(state, device)
    losses, states = [], []
    for i, feed in enumerate(feeds):
        if not chained:
            sc = _scope_on(ref_states[i], device)
        states.append(_host_state(sc))
        losses.append(_loss(exe.run(prog, feed=feed, scope=sc,
                                    fetch_list=fetch)))
    exe.close()
    return losses, states, sc


def _card_vs_cpu(prog, state, dev, feeds, fetch, chained):
    """(CPU losses, card losses, the card's last scope): the CPU first,
    then the card from the same state (chained), or each card step from
    the CPU's state before it."""
    cpu, states, _ = _losses_from(prog, state, torch.device("cpu"), feeds,
                                  fetch)
    card, _, sc = _losses_from(prog, state, dev, feeds, fetch, chained,
                               states)
    return cpu, card, sc


def train_seq2seq(dev, smi, batch_size=64, seq=32, timed=20):
    """seq2seq at Seq2SeqConfig's full width: startup on the card, one
    warm-up step, timed_modes (``timed`` steps op by op and compiled on
    one batch, each leg from the warm-up's state: a falling loss, step
    ms, peak memory); card against CPU at batch 4, 3 steps from the
    startup state, losses within 1e-4. Returns the launch counts and the
    compiled leg's scope (the trained state) for decode_seq2seq."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import seq2seq
    from paddle_tpu_torch.tools.profile_train import timed_modes

    t_phase = time.perf_counter()
    cfg = seq2seq.Seq2SeqConfig()
    with unique_name.guard():
        main_prog, startup, _, fetches = seq2seq.build_seq2seq_program(
            cfg, seq, seq, batch_size=batch_size, lr=1e-3)
    with unique_name.guard():
        small, _, _, _ = seq2seq.build_seq2seq_program(cfg, seq, seq,
                                                       batch_size=4,
                                                       lr=1e-3)
    exe, scope = Executor(device=dev), Scope()
    exe.run(startup, scope=scope)
    state = _host_state(scope)
    batch = seq2seq.synthetic_translation_batch(cfg, batch_size, seq, seq,
                                                seed=0)
    feed = _feed_on(batch, dev)
    fetch = [fetches["loss"]]
    warm = _loss(exe.run(main_prog, feed=feed, scope=scope,
                         fetch_list=fetch, use_compiled=False))
    modes = timed_modes(exe, main_prog, feed, scope, fetch, timed)
    exe.close()
    small_feeds = [seq2seq.synthetic_translation_batch(cfg, 4, seq, seq,
                                                       seed=s)
                   for s in range(3)]
    cpu, card, _ = _card_vs_cpu(small, state, dev, small_feeds,
                                [fetches["loss"].name], chained=True)
    ok = np.allclose(card, cpu, rtol=1e-4, atol=1e-4)
    tokens = int(batch["tgt_mask"].sum())
    emit("train_seq2seq", model="seq2seq", batch=batch_size, src_len=seq,
         tgt_len=seq, vocab=cfg.tgt_vocab_size, hidden=cfg.hidden_size,
         embed=cfg.embed_dim, ops=len(main_prog.global_block().ops),
         warmup_loss=warm, modes=_per_mode(modes),
         step_ms_p50={m: r["step_ms_p50"] for m, r in modes.items()},
         peak_gb={m: r["max_memory_allocated"] / 1e9
                  for m, r in modes.items()},
         target_tokens_per_s={m: tokens / (r["step_ms_p50"] / 1e3)
                              for m, r in modes.items()},
         parity_batch=4, parity_loss_gpu=card, parity_loss_cpu=cpu,
         parity_tolerance="rtol=atol=1e-4", nvidia_smi=smi,
         seconds=time.perf_counter() - t_phase)
    _check_legs("train_seq2seq", modes)
    if not ok:
        raise AssertionError(f"train_seq2seq: card {card} and CPU {cpu} "
                             f"disagree")
    comp = modes["compiled"]
    return dict(launches=comp["launches"], layouts=comp["layouts"],
                dtypes=comp["dtypes"]), cfg, scope


def _first_parting(card, cpu):
    """The first step at which the card's and the CPU's choices differ,
    the rows that differ there and the CPU's margins on them; None if
    they never part."""
    for t, ((cc, _), (pc, margin)) in enumerate(zip(card, cpu)):
        rows = (cc != pc).reshape(cc.shape[0], -1).any(dim=1)
        if bool(rows.any()):
            return dict(step=t, rows=rows.nonzero().reshape(-1).tolist(),
                        cpu_margin=float(margin[rows].max()))
    return None


def decode_seq2seq(dev, cfg, scope, rows=64, beam=4, max_len=32, reps=3):
    """Greedy and beam decoding of ``rows`` sources from the trained
    state on the card: ms a decode and rows/s; beam at K = 1 with no
    length penalty equals greedy bit for bit; on 8 rows card against
    CPU, the ids equal or the first step where the choices part at a
    CPU margin (top two logits, or neighbouring candidates among the
    K + 1 best) within 1e-4."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import seq2seq

    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    src = seq2seq.synthetic_translation_batch(cfg, rows, max_len, max_len,
                                              seed=1)
    ids, mask = src["src_ids"], src["src_mask"]
    timing, outs = {}, {}
    for name, fn in (("greedy", lambda: seq2seq.greedy_decode(
            cfg, scope, ids, mask, max_len=max_len)),
                     ("beam", lambda: seq2seq.beam_search_decode(
                         cfg, scope, ids, mask, beam_size=beam,
                         max_len=max_len))):
        outs[name] = fn()                           # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        timing[name] = dict(ms=ms, rows_per_s=rows / (ms / 1e3))
    k1 = seq2seq.beam_search_decode(cfg, scope, ids, mask, beam_size=1,
                                    max_len=max_len, length_penalty=0.0)
    k1_equal = bool(np.array_equal(k1, outs["greedy"]))
    cpu_scope = _scope_on(_host_state(scope), "cpu")
    parity = {}
    for name, kw in (("greedy", {}), ("beam", {"beam_size": beam})):
        fn = seq2seq.greedy_decode if name == "greedy" else \
            seq2seq.beam_search_decode
        tr_card, tr_cpu = [], []
        got = fn(cfg, scope, ids[:8], mask[:8], max_len=max_len,
                 trace=tr_card, **kw)
        want = fn(cfg, cpu_scope, ids[:8], mask[:8], max_len=max_len,
                  trace=tr_cpu, **kw)
        part = _first_parting(tr_card, tr_cpu)
        parity[name] = dict(ids_equal=bool(np.array_equal(got, want)),
                            parting=part)
        parity[name]["ok"] = parity[name]["ids_equal"] if part is None \
            else part["cpu_margin"] <= 1e-4
    emit("decode_seq2seq", rows=rows, beam=beam, max_len=max_len,
         timing=timing, beam1_equals_greedy=k1_equal, cpu_parity_rows=8,
         cpu_parity=parity, eos_rows_greedy=int(
             (outs["greedy"] == 2).any(axis=1).sum()),
         seconds=time.perf_counter() - t_phase)
    if not k1_equal or not all(p["ok"] for p in parity.values()):
        raise AssertionError(f"decode_seq2seq: beam K=1 equals greedy "
                             f"{k1_equal}, card against CPU {parity}")
    return _phase_counts()


def train_sentiment(dev, smi, batch_size=128, timed=5, steps=5):
    """Both understand_sentiment nets at build_sentiment_program's widths
    (vocabulary 500, 16 steps, embed 32, the stacked LSTM's hidden 64 in
    three layers, the conv net's 32 filters of window 3), Adam lr 0.02:
    timed_modes over one batch; card against CPU over ``steps`` steps on
    one batch, each from the CPU's state before it, losses within 1e-5,
    and the CPU's loss falling."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import sentiment
    from paddle_tpu_torch.tools.profile_train import timed_modes

    from paddle_tpu_torch import kernels

    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    nets, problems = {}, []
    for net in ("stacked_lstm", "conv"):
        with unique_name.guard():
            main_prog, startup, _, fetches = \
                sentiment.build_sentiment_program(net=net,
                                                  batch_size=batch_size)
        exe, scope = Executor(device=dev), Scope()
        exe.run(startup, scope=scope)
        state = _host_state(scope)
        batch = sentiment.synthetic_batch(batch_size, seed=0)
        fetch = [fetches["loss"]]
        modes = timed_modes(exe, main_prog, _feed_on(batch, dev), scope,
                            fetch, timed)
        exe.close()
        cpu, card, _ = _card_vs_cpu(main_prog, state, dev,
                                    [batch] * steps, [fetches["loss"].name],
                                    chained=False)
        ok = np.allclose(card, cpu, rtol=1e-5, atol=1e-5)
        falls = cpu[-1] < cpu[0]
        nets[net] = dict(ops=len(main_prog.global_block().ops),
                         modes=_per_mode(modes),
                         step_ms_p50={m: r["step_ms_p50"]
                                      for m, r in modes.items()},
                         peak_gb={m: r["max_memory_allocated"] / 1e9
                                  for m, r in modes.items()},
                         parity_loss_gpu=card, parity_loss_cpu=cpu,
                         parity_max_abs=float(np.max(np.abs(
                             np.subtract(card, cpu)))),
                         cpu_loss_falls=bool(falls))
        _check_legs(f"train_sentiment[{net}]", modes)
        if not ok or not falls:
            problems.append(net)
    emit("train_sentiment", batch=batch_size, nets=nets,
         parity_tolerance="rtol=atol=1e-5, each step from the CPU's state",
         nvidia_smi=smi, seconds=time.perf_counter() - t_phase)
    if problems:
        raise AssertionError(f"train_sentiment: card and CPU disagree or "
                             f"the loss does not fall: {problems}")
    return _phase_counts()


def train_vgg16(dev, smi, batch_size=128, timed=12, lr=3e-4):
    """VGG16 (build_vgg_program's 10 classes, 3x32x32) at ``batch_size``,
    Adam at the reference test's ``lr``: startup, timed_modes over one
    batch (step ms, peak memory), finite losses with the mean of each
    leg's last three below its first three (dropout makes single steps
    noisy, as the reference's test_vgg16_trains says); card against CPU
    at batch 4, 2 steps each from the CPU's state, within 1e-4."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import vision_extra
    from paddle_tpu_torch.tools.profile_train import timed_modes

    t_phase = time.perf_counter()
    with unique_name.guard():
        main_prog, startup, _, fetches = vision_extra.build_vgg_program(
            batch_size=batch_size, lr=lr)
    with unique_name.guard():
        small, _, _, _ = vision_extra.build_vgg_program(batch_size=4, lr=lr)
    exe, scope = Executor(device=dev), Scope()
    exe.run(startup, scope=scope)
    state = _host_state(scope)
    batch = vision_extra.synthetic_batch(batch_size, seed=0)
    fetch = [fetches["loss"]]
    modes = timed_modes(exe, main_prog, _feed_on(batch, dev), scope, fetch,
                        timed)
    exe.close()
    trend = {m: (float(np.mean(r["losses"][:3])),
                 float(np.mean(r["losses"][-3:]))) for m, r in modes.items()}
    finite = all(np.all(np.isfinite(r["losses"])) for r in modes.values())
    cpu, card, _ = _card_vs_cpu(
        small, state, dev, [vision_extra.synthetic_batch(4, seed=s)
                            for s in range(2)],
        [fetches["loss"].name], chained=False)
    ok = np.allclose(card, cpu, rtol=1e-4, atol=1e-4)
    emit("train_vgg16", model="vgg16", batch=batch_size, lr=lr,
         ops=len(main_prog.global_block().ops), modes=_per_mode(modes),
         step_ms_p50={m: r["step_ms_p50"] for m, r in modes.items()},
         peak_gb={m: r["max_memory_allocated"] / 1e9
                  for m, r in modes.items()},
         images_per_s={m: batch_size / (r["step_ms_p50"] / 1e3)
                       for m, r in modes.items()},
         loss_mean_first3_last3=trend, parity_batch=4,
         parity_loss_gpu=card, parity_loss_cpu=cpu,
         parity_tolerance="rtol=atol=1e-4, each step from the CPU's state",
         nvidia_smi=smi, seconds=time.perf_counter() - t_phase)
    if not finite or not all(b < a for a, b in trend.values()) or not ok:
        raise AssertionError(f"train_vgg16: finite {finite}, loss trend "
                             f"{trend}, card {card} against CPU {cpu}")
    comp = modes["compiled"]
    return dict(launches=comp["launches"], layouts=comp["layouts"],
                dtypes=comp["dtypes"])


# -- label_semantic_roles, gradient merge and control flow ------------------

SRL_LR = 1e-3
# 100 x Adam's epsilon: below it a first Adam step amplifies the gradient's
# rounding (train_srl_gradient_merge)
ADAM_EPS_GUARD = 1e-6


def _srl_programs(batch_size=-1, seq=64, lr=SRL_LR, merge=0):
    """label_semantic_roles at the book's widths (``SRLConfig()``): the
    training program (Adam at ``lr``; with ``merge`` = k through fleet's
    gradient merge of k steps, avg) and the forward-only one."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import srl
    from paddle_tpu_torch.optimizer import AdamOptimizer

    cfg = srl.SRLConfig()
    with unique_name.guard():
        if not merge:
            main_prog, startup, _, fetches = srl.build_srl_program(
                cfg, seq_len=seq, batch_size=batch_size, lr=lr)
        else:
            from paddle_tpu_torch.core.ir import program_guard

            main_prog, startup, _, fetches = srl.build_srl_program(
                cfg, seq_len=seq, batch_size=batch_size,
                with_optimizer=False)
            with program_guard(main_prog, startup):
                s = fleet.DistributedStrategy()
                s.gradient_merge = True
                s.gradient_merge_configs = {"k_steps": merge, "avg": True}
                fleet.distributed_optimizer(AdamOptimizer(lr), s).minimize(
                    fetches["loss"])
    with unique_name.guard():
        infer, _, _, infer_fetches = srl.build_srl_program(
            cfg, seq_len=seq, batch_size=batch_size, with_optimizer=False)
    return cfg, main_prog, startup, fetches, infer, infer_fetches


def train_srl(dev, smi, batch_size=64, seq=64, timed=3):
    """label_semantic_roles at the book's widths (words 44068 x 32,
    predicates 3162 x 32, marks 2 x 5, fc and two LSTMs of 512, 59 tags)
    on b64 sentences of 8-64 tokens, Adam lr 1e-3 (at the book test's
    0.01 the loss jumps at the second step on the CPU too): timed_modes
    op by op and compiled (step ms, busy and idle share, peak), the loss
    falling in each leg; card against CPU at b4 over 3 steps, each from
    the CPU's state, losses within 1e-5. Returns the launch counts, the
    startup state and the compiled leg's scope."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import srl
    from paddle_tpu_torch.tools.profile_train import timed_modes

    from paddle_tpu_torch import kernels

    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    cfg, main_prog, startup, fetches, _, _ = _srl_programs()
    exe, scope = Executor(device=dev), Scope()
    exe.run(startup, scope=scope)
    state = _host_state(scope)
    batch = srl.synthetic_batch(cfg, batch_size, seq, seed=0)
    fetch = [fetches["loss"]]
    modes = timed_modes(exe, main_prog, _feed_on(batch, dev), scope, fetch,
                        timed)
    exe.close()
    small = [srl.synthetic_batch(cfg, 4, seq, seed=s) for s in range(3)]
    cpu, card, _ = _card_vs_cpu(main_prog, state, dev, small,
                                [fetches["loss"].name], chained=False)
    ok = np.allclose(card, cpu, rtol=1e-5, atol=1e-5)
    tokens = int(batch["length"].sum())
    emit("train_srl", model="label_semantic_roles", batch=batch_size,
         seq=seq, tokens=tokens, lr=SRL_LR,
         ops=len(main_prog.global_block().ops), modes=_per_mode(modes),
         step_ms_p50={m: r["step_ms_p50"] for m, r in modes.items()},
         device_idle_share={m: r["device_idle_share"]
                            for m, r in modes.items()},
         device_busy_ms={m: r["device_busy_ms"] for m, r in modes.items()},
         peak_gb={m: r["max_memory_allocated"] / 1e9
                  for m, r in modes.items()},
         tokens_per_s={m: tokens / (r["step_ms_p50"] / 1e3)
                       for m, r in modes.items()},
         parity_batch=4, parity_loss_gpu=card, parity_loss_cpu=cpu,
         parity_tolerance="rtol=atol=1e-5, each step from the CPU's state",
         nvidia_smi=smi, seconds=time.perf_counter() - t_phase)
    _check_legs("train_srl", modes)
    if not ok:
        raise AssertionError(f"train_srl: card {card} and CPU {cpu} "
                             f"disagree")
    return _phase_counts(), cfg, state, scope


def _viterbi_margins(em, trans, length, path):
    """Each row's Viterbi margin along its decoded ``path``: the smallest
    gap between the best and the second-best score of a choice the path
    made (a back-pointer at each position after the first, the last
    tag), from the emissions [B, S, T] and transition [T + 2, T] in
    float64 on the host. A row whose margin is tiny may part on another
    device at a near tie."""
    em, w = em.double(), trans.double()
    start, stop, tr = w[0], w[1], w[2:]
    b, s, _ = em.shape
    alpha = start[None] + em[:, 0]
    margins = torch.full((b,), float("inf"), dtype=torch.float64)

    def gap(x):
        top = torch.topk(x, 2, dim=-1).values
        return top[..., 0] - top[..., 1]

    for t in range(1, s):
        cand = alpha[:, :, None] + tr[None]
        live = t < length
        tag = path[:, t].long()
        choice = gap(cand.gather(2, tag[:, None, None].expand(
            -1, cand.shape[1], 1))[..., 0])
        margins = torch.where(live, torch.minimum(margins, choice), margins)
        alpha = torch.where(live[:, None], cand.amax(1) + em[:, t], alpha)
    last = gap(alpha + stop[None])
    return torch.where(length > 0, torch.minimum(margins, last),
                       torch.full_like(margins, float("inf")))


def decode_srl(dev, cfg, scope, rows=64, seq=64, reps=3):
    """crf_decoding of ``rows`` sentences with the trained transition, on
    the card through the forward-only program (compiled: ms a decode and
    rows/s) and on the CPU from the same state: the paths bit for bit
    wherever a row's Viterbi margin (``_viterbi_margins``) exceeds 1e-5,
    0 past each length. Prints the smallest margins."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.models import srl

    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    _, _, _, _, infer, f = _srl_programs()
    batch = srl.synthetic_batch(cfg, rows, seq, seed=7)
    emission = [op for op in infer.global_block().ops
                if op.type == "crf_decoding"][0].inputs["Emission"][0]
    fetch = [f["decode"].name, emission]
    exe = Executor(device=dev)
    feed = _feed_on(batch, dev)
    for _ in range(2):                   # op by op, then the capture
        exe.run(infer, feed=feed, fetch_list=fetch, scope=scope)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        card_path, _ = exe.run(infer, feed=feed, fetch_list=fetch,
                               scope=scope)
    ms = (time.perf_counter() - t0) * 1e3 / reps
    exe.close()
    cpu_scope = _scope_on(_host_state(scope), "cpu")
    cpu_path, em = Executor(device="cpu").run(infer, feed=batch,
                                              fetch_list=fetch,
                                              scope=cpu_scope)
    margins = _viterbi_margins(torch.from_numpy(em),
                               cpu_scope.find_var("srl_crf_trans"),
                               torch.from_numpy(batch["length"]),
                               torch.from_numpy(cpu_path))
    parted = [int(i) for i in np.nonzero((card_path != cpu_path).any(1))[0]]
    valid = np.arange(seq)[None, :] < batch["length"][:, None]
    ok = all(float(margins[i]) <= 1e-5 for i in parted) and \
        not card_path[~valid].any()
    order = torch.argsort(margins)[:5].tolist()
    emit("decode_srl", rows=rows, seq=seq, ms=ms,
         rows_per_s=rows / (ms / 1e3), rows_parted=parted,
         margins_of_parted=[float(margins[i]) for i in parted],
         smallest_margins={int(i): float(margins[i]) for i in order},
         margin_tolerance=1e-5, paths_equal=not parted,
         seconds=time.perf_counter() - t_phase)
    if not ok:
        raise AssertionError(f"decode_srl: rows {parted} part from the CPU "
                             f"at margins {[float(margins[i]) for i in parted]}")
    return _phase_counts()


def train_srl_gradient_merge(dev, smi, state, batch_size=64, seq=64, k=4):
    """The same model through fleet with gradient merge (k_steps 4, avg)
    on the 4 micro-batches of 16 of one b64 batch, compiled (the
    conditional_block decides on the host, so the step runs uncaptured:
    design (b), counted by executor.uncaptured_steps and named in its
    compile record), from the startup state: the three steps that do not
    fire leave every parameter, moment and beta power bit for bit; after
    the fourth, every parameter is within 1e-5 of one plain Adam step on
    the whole b64 batch, except elements whose whole-batch gradient is
    below 1e-6 (Adam's step lr g / (|g| + 1e-8) amplifies the rounding of
    the gradient's sums there: one element at |g| 4.0e-8 lands 1.2e-5
    off), which are printed and held within lr."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.models import srl

    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    cfg, plain, _, pf, _, _ = _srl_programs()
    _, merged, startup, mf, _, _ = _srl_programs(merge=k)
    batch = srl.synthetic_batch(cfg, batch_size, seq, seed=3)
    micro = [{n: v[i * (batch_size // k):(i + 1) * (batch_size // k)]
              for n, v in batch.items()} for i in range(k)]
    # the merge program's own state (accumulators, counter) beside the
    # model's startup state
    sc0 = _scope_on({}, dev)
    Executor(device=dev).run(startup, scope=sc0)
    start = dict(_host_state(sc0), **state)
    exe, sc = Executor(device=dev), _scope_on(start, dev)
    before_uncaptured = telemetry.counter_get("executor.uncaptured_steps") \
        or 0
    trained = [n for n in state if isinstance(state[n], torch.Tensor)]
    unchanged, step_ms = [], []
    for i, mb in enumerate(micro):
        prev = _host_state(sc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe.run(merged, feed=_feed_on(mb, dev), fetch_list=[mf["loss"]],
                scope=sc)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i < k - 1:
            now = _host_state(sc)
            unchanged.append(all(torch.equal(now[n], prev[n])
                                 for n in trained))
    steps = [c for by in exe._compiled[merged].values()
             for c in by.values() if hasattr(c, "host_op")]
    design = "b: uncaptured" if steps and steps[0].host_op and \
        steps[0].graph.graph is None else "captured"
    got = _host_state(sc)
    ref = _scope_on(state, dev)
    params = [p.name for p in plain.all_parameters()]
    grads = Executor(device=dev).run(
        plain, feed=_feed_on(batch, dev),
        fetch_list=[pf["loss"]] + [f"{n}@GRAD" for n in params], scope=ref,
        use_compiled=False, return_numpy=False)[1:]
    want = _host_state(ref)
    errs = {n: float((got[n] - want[n]).abs().max()) for n in params}
    worst = max(errs.values())
    # Adam's first step is lr g / (|g| + eps): where the whole-batch |g|
    # is within 100 eps the step turns the last bits of the gradient's
    # sums (four micro-batch products against one) into up to lr, so
    # those elements are counted and held within lr, the rest to 1e-5
    over, bad = {}, []
    for n, g in zip(params, grads):
        d = (got[n] - want[n]).abs()
        g = g.cpu().abs()
        hit = d > 1e-5
        if bool(hit.any()):
            over[n] = dict(count=int(hit.sum()),
                           grad_abs=sorted(float(x) for x in g[hit][:8]),
                           param_err=sorted(float(x) for x in d[hit][:8]))
            if bool((hit & (g >= ADAM_EPS_GUARD)).any()) or \
                    float(d.max()) > SRL_LR:
                bad.append(n)
    uncaptured = (telemetry.counter_get("executor.uncaptured_steps") or 0) \
        - before_uncaptured
    emit("train_srl_gradient_merge", k_steps=k, avg=True,
         micro_batch=batch_size // k, design=design,
         host_op=steps[0].host_op if steps else None,
         uncaptured_steps=uncaptured, step_ms=step_ms,
         non_firing_steps_bit_equal=unchanged,
         firing_step_max_abs_err=worst, tolerance=1e-5,
         tolerance_where_grad_below=[ADAM_EPS_GUARD, SRL_LR],
         elements_over_tolerance=over,
         worst_param=max(errs, key=errs.get), nvidia_smi=smi,
         seconds=time.perf_counter() - t_phase)
    if not all(unchanged) or bad or design == "captured":
        raise AssertionError(f"train_srl_gradient_merge: unchanged "
                             f"{unchanged}, firing step off by {worst} "
                             f"({over}), {design}")
    return _phase_counts()


def control_flow_card(dev, batch_size=128, seq=64, hidden=64, dim=32,
                      steps=3):
    """The DynamicRNN tanh cell of tests/test_dynamic_rnn.py at the
    sentiment model's widths (b128, 64 steps, hidden 64, inputs 32),
    SGD: ``steps`` steps op by op and compiled from one state, losses,
    outputs and parameters bit for bit, the compiled step captured into
    a CUDA graph (step ms of each); then cond with a gradient, a dynamic
    while_loop, a bounded while_loop with a gradient, static_loop and
    IfElse (``tools/control_flow_cases.py``), each card against CPU:
    integers bit for bit, floats within 1e-5."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.tools import control_flow_cases as cfc

    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    P = cfc.port()
    main_prog, startup, fetch = cfc.build(
        P, lambda P: cfc.dynamic_rnn(P, S=seq, D=dim, H=hidden))
    sc = Scope()
    Executor(device="cpu").run(startup, scope=sc)
    state = _host_state(sc)
    r = np.random.RandomState(0)
    feed = {"x": r.randn(batch_size, seq, dim).astype(np.float32),
            "len": r.randint(1, seq + 1, (batch_size,)).astype(np.int64),
            "label": r.randn(batch_size, hidden).astype(np.float32)}
    names = [v.name for v in fetch]
    legs, ms = {}, {}
    for mode in (False, True):
        exe, scope = Executor(device=dev), _scope_on(state, dev)
        outs, times = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(exe.run(main_prog, feed=_feed_on(feed, dev),
                                fetch_list=names, scope=scope,
                                use_compiled=mode))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        legs[mode] = (outs, _host_state(scope))
        ms[mode] = times
        if mode:
            built = [c for by in exe._compiled[main_prog].values()
                     for c in by.values() if hasattr(c, "graph")]
            captured = bool(built) and built[0].graph.graph is not None
        exe.close()
    drnn_equal = all(np.array_equal(a, b)
                     for oa, ob in zip(legs[False][0], legs[True][0])
                     for a, b in zip(oa, ob)) and all(
        torch.equal(legs[False][1][n], legs[True][1][n])
        for n in legs[False][1] if isinstance(legs[False][1][n],
                                              torch.Tensor))
    losses = [float(o[2].reshape(-1)[0]) for o in legs[False][0]]
    cases = {}
    for case in ("cond_grad[true]", "cond_grad[false]", "while_dynamic[3]",
                 "while_bounded[ran]", "static_loop_grad", "if_else",
                 "cond_nan_branch[negative]", "rank_table"):
        builder, cfeed = cfc.FEEDS[case]
        prog, st, f = cfc.build(P, builder)
        csc = Scope()
        Executor(device="cpu").run(st, scope=csc)
        cstate = _host_state(csc)
        fn = [v.name for v in f]
        want = Executor(device="cpu").run(prog, feed=cfeed, fetch_list=fn,
                                          scope=_scope_on(cstate, "cpu"))
        got = Executor(device=dev).run(prog, feed=cfeed, fetch_list=fn,
                                       scope=_scope_on(cstate, dev),
                                       use_compiled=False)
        agree = all(a.shape == b.shape and a.dtype == b.dtype and (
            np.allclose(a, b, rtol=1e-5, atol=1e-5) if
            np.issubdtype(b.dtype, np.floating) else np.array_equal(a, b))
            for a, b in zip(got, want))
        cases[case] = agree
    emit("control_flow_card", drnn=dict(
        batch=batch_size, steps_per_seq=seq, hidden=hidden, inputs=dim,
        ops=len(main_prog.global_block().ops), losses=losses,
        compiled_equals_op_by_op=drnn_equal, graph_captured=captured,
        step_ms_op_by_op=ms[False], step_ms_compiled=ms[True]),
        cases_card_equals_cpu=cases, tolerance="rtol=atol=1e-5, "
        "integers bit for bit", seconds=time.perf_counter() - t_phase)
    if not drnn_equal or not captured or not all(cases.values()) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"control_flow_card: DynamicRNN compiled = op "
                             f"by op {drnn_equal}, captured {captured}, "
                             f"losses {losses}; cases {cases}")
    return _phase_counts()


# -- the imperative mode (dygraph) and the 2.0 API ---------------------------

DY_SEQ, DY_BATCH = 128, 64
# the rate climbs from 0 to 1e-4 over 100 steps, of which the phase runs
# its first 14 fit steps (BERT's own recipe warms up over 10 000): Adam's
# first steps move every weight by about the rate, and a warm-up over 2
# or 10 steps (a first step at 5e-5 or 1e-5) made the fresh post-LN
# network's loss jump after that step on the card
DY_LR_WARMUP = 100
# the eager MultiHeadAttention's output and gradients, card against CPU:
# max |card - CPU| <= DY_MHA_TOL * max(1, max |CPU|) for each tensor, a
# bias gradient's max taken with its weight's (the parameter gradients
# sum 8192 tokens, so the bound scales with them; k_proj's bias gradient
# is 0 up to rounding, since a key bias shifts a query's scores alike)
DY_MHA_TOL = 2e-5
DYGRAPH_DIR = Path(__file__).resolve().parent / "build" / "torch_dygraph"


def _dy_dataset(reader, rows, idx):
    return reader.TensorDataset([a[idx] for a in rows])


def _dy_clock(kernels, sched=None):
    """A hapi callback timing each train step on the host clock between
    two synchronizes, the launch counts it added, its loss; it steps the
    LR scheduler after each batch."""
    from paddle_tpu_torch.hapi import Callback

    class Clock(Callback):
        def __init__(self):
            super().__init__()
            self.ms, self.launches, self.losses = [], [], []

        def on_train_batch_begin(self, step, logs=None):
            torch.cuda.synchronize()
            self._c0 = kernels.launch_counts()
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - self._t0) * 1e3)
            c1 = kernels.launch_counts()
            self.launches.append({k: c1[k] - self._c0[k] for k in c1})
            self.losses.append(float(logs["loss"]))
            if sched is not None:
                sched.step()

    return Clock()


def _dy_model(dev):
    """The full-width network on ``dev`` behind hapi.Model, prepared with
    AdamW at 1e-4 after a LinearWarmup over DY_LR_WARMUP steps from 0,
    CrossEntropyLoss and Accuracy: (model, scheduler, parameter
    tensors)."""
    from paddle_tpu_torch import metric, nn, optimizer
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.tools.dygraph_bert import bert_classifier

    np.random.seed(0)
    net = bert_classifier(nn)
    sched = optimizer.lr.LinearWarmup(1e-4, DY_LR_WARMUP, 0.0, 1e-4)
    opt = optimizer.AdamW(learning_rate=sched, parameters=net.parameters(),
                          weight_decay=0.01)
    model = Model(net, inputs=["ids", "pos", "bias"], device=dev)
    model.prepare(opt, nn.CrossEntropyLoss(), metric.Accuracy())
    return model, sched, len(net.parameters())


def _dy_leg(model, sched, n_params, rows, warmup, timed, amp_leg):
    """One eager training leg through hapi.Model.fit on one batch taken
    every step (its loss falls within the leg), under ``auto_cast`` if
    ``amp_leg``; then one traced train_batch. The leg's figures."""
    from paddle_tpu_torch import amp, kernels, reader
    from paddle_tpu_torch.tools.profile_train import traced

    steps = warmup + timed
    idx = np.tile(np.arange(DY_BATCH), steps)
    clock = _dy_clock(kernels, sched)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with amp.auto_cast() if amp_leg else contextlib.nullcontext():
        model.fit(_dy_dataset(reader, rows, idx), batch_size=DY_BATCH,
                  epochs=1, shuffle=False, verbose=0, callbacks=[clock])
        batch = [a[:DY_BATCH] for a in rows]
        trace = traced(lambda: model.train_batch(batch[:3], batch[3:]), 1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {"flash_attention_fwd": 12, "flash_attention_bwd": 12,
            "fused_adamw": n_params}
    per_step = clock.launches[warmup:]
    leg = dict(steps=steps, warmup_steps=warmup,
               step_ms_p50=float(np.median(clock.ms[warmup:])),
               step_ms_range=[min(clock.ms[warmup:]),
                              max(clock.ms[warmup:])],
               losses=clock.losses, peak_gb=peak,
               device_busy_ms=trace["device_busy_ms"],
               traced_wall_ms=trace["traced_wall_ms"],
               device_idle_share=trace["device_idle_share"],
               traced_launches=trace["traced_launches"],
               top_kernels=trace["top_kernels"][:6],
               launches_per_step=per_step[-1], parameter_tensors=n_params)
    bad = [s for s in per_step if any(s[k] != v for k, v in want.items())]
    if bad:
        raise AssertionError(f"dygraph_bert_base: launches per step {bad[0]}"
                             f", want {want}")
    head, tail = clock.losses[:2], clock.losses[-2:]
    if not np.mean(tail) < np.mean(head) or \
            not np.all(np.isfinite(clock.losses)):
        raise AssertionError(f"dygraph_bert_base: loss does not fall "
                             f"{clock.losses}")
    return leg


def dygraph_bert_base(dev, smi, warmup=2, timed=8, amp_steps=4):
    """The imperative mode's main path at full width: the 2.0 nn network
    of tools/dygraph_bert.py (30522 words + 512 positions, 12 post-LN
    TransformerEncoderLayers of d_model 768, 12 heads, ffn 3072, gelu,
    dropout 0.1, a 2-class head on token 0) trained eagerly at s128 b64
    through hapi.Model.fit with AdamW (1e-4 under LinearWarmup) and
    Accuracy, on one batch of seeded synthetic rows (taken every step, so
    the loss falls within the leg) whose key-padding mask reaches
    src_mask as an additive [B,1,1,128] bias (the flash kernels' key-bias
    route). Then evaluate and predict on 64 rows: with the fp32 leg, the
    path dygraph_bert_base. Then 4 more steps under amp.auto_cast (bf16
    matmuls), counted apart as the path dygraph_bert_base_amp. Each leg:
    step ms (p50, range), one traced step's busy ms and idle share, peak
    GB, its launches a step (12 bnsd flash forward, 12 bnsd backward, one
    AdamW launch per parameter tensor, every timed step) and a falling
    loss: the fit of the one batch the leg repeats. Each path's launch
    counts: its steps' (fit and traced), evaluate's and predict's 12
    forwards each, all bnsd. The sink's hapi.step_ms. Returns both
    paths' counts and the network's state after them (to_static_bert_base
    starts from it)."""
    from paddle_tpu_torch import dygraph, kernels, reader
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.tools.dygraph_bert import synthetic_rows

    t0 = time.perf_counter()
    DYGRAPH_DIR.mkdir(parents=True, exist_ok=True)
    log = DYGRAPH_DIR / "dygraph_bert_base.jsonl"
    log.unlink(missing_ok=True)
    telemetry.configure(str(log))
    telemetry.reset()
    rows = synthetic_rows(DY_BATCH, DY_SEQ, seed=0)
    kernels.reset_launch_counts()
    try:
        with dygraph.guard(dev):
            model, sched, n_params = _dy_model(dev)
            fp32 = _dy_leg(model, sched, n_params, rows, warmup, timed,
                           False)
            hapi_ms = telemetry.snapshot()["hists"]["hapi.step_ms"]
            ev_rows = _dy_dataset(reader, rows, np.arange(DY_BATCH))
            ev = model.evaluate(ev_rows, batch_size=DY_BATCH, verbose=0)
            pred = model.predict(ev_rows, batch_size=DY_BATCH,
                                 stack_outputs=True)[0]
            torch.cuda.synchronize()
            counts = _phase_counts()
            kernels.reset_launch_counts()
            bf16 = _dy_leg(model, sched, n_params, rows, 0, amp_steps,
                           True)
            torch.cuda.synchronize()
            amp_counts = _phase_counts()
            state = {k: v._tensor.detach().clone()
                     for k, v in model.network.state_dict().items()}
            del model
    finally:
        telemetry.flush()
        telemetry.configure(None)
    # a leg's steps: its fit steps and the traced train_batch
    want = {"dygraph_bert_base": (counts, warmup + timed + 1, 2),
            "dygraph_bert_base_amp": (amp_counts, amp_steps + 1, 0)}
    totals = {p: {"flash_attention_fwd": 12 * (steps + extra),
                  "flash_attention_bwd": 12 * steps,
                  "fused_adamw": n_params * steps}
              for p, (_, steps, extra) in want.items()}
    emit("dygraph_bert_base", model="bert_base_2.0_nn", layers=12,
         seq=DY_SEQ, batch=DY_BATCH, lr_warmup_steps=DY_LR_WARMUP,
         fp32=fp32, amp_bf16=bf16,
         hapi_step_ms={k: hapi_ms[k] for k in ("count", "p50", "min",
                                               "max")},
         evaluate=ev, predict_shape=list(pred.shape),
         launches={p: c["launches"] for p, (c, _, _) in want.items()},
         launches_want=totals,
         flash_launches_by_layout={p: c["layouts"]
                                   for p, (c, _, _) in want.items()},
         flash_launches_by_dtype={p: c["dtypes"]
                                  for p, (c, _, _) in want.items()},
         seconds=time.perf_counter() - t0, nvidia_smi=smi)
    for p, (c, _, _) in want.items():
        got = {k: c["launches"][k] for k in totals[p]}
        if got != totals[p] or any(c["layouts"][k]["packed"] for k in (
                "flash_attention_fwd", "flash_attention_bwd")):
            raise AssertionError(f"{p}: launches {got}, want {totals[p]}; "
                                 f"flash by layout {c['layouts']}")
    if pred.shape != (DY_BATCH, 2) or not np.all(np.isfinite(pred)) or \
            not np.isfinite(ev["eval_loss"]):
        raise AssertionError(f"dygraph_bert_base: evaluate {ev}, predict "
                             f"{pred.shape}")
    return counts, amp_counts, state


def _dy_train(device, state, rows, steps, dropout, layers=2):
    """The network at ``layers`` layers on ``device`` from ``state``,
    trained ``steps`` AdamW steps (lr 1e-4) eagerly, numpy's global RNG
    seeded alike before each step: (losses, state after, the dropout
    layers' keep masks of every step)."""
    from paddle_tpu_torch import dygraph, nn, optimizer
    from paddle_tpu_torch.tools.dygraph_bert import bert_classifier

    masks = []

    def record(layer, ins, out):
        if layer.training:
            masks.append((out.numpy() != 0) | (ins[0].numpy() == 0))

    with dygraph.guard(device):
        net = bert_classifier(nn, layers=layers, dropout=dropout)
        net.set_state_dict(state)
        for _, sub in net.named_sublayers():
            if isinstance(sub, nn.Dropout):
                sub.register_forward_post_hook(record)
        opt = optimizer.AdamW(learning_rate=1e-4,
                              parameters=net.parameters())
        loss_fn, losses = nn.CrossEntropyLoss(), []
        b = len(rows[0]) // steps
        for i in range(steps):
            np.random.seed(100 + i)
            ids, pos, bias, lbl = (dygraph.to_variable(a[i * b:(i + 1) * b])
                                   for a in rows)
            loss = loss_fn(net(ids, pos, bias), lbl)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        after = {k: v.numpy() for k, v in net.state_dict().items()}
    return losses, after, masks, net


def _dy_static(dev, state, rows, steps, layers=2):
    """The same network built under program_guard (static Parameters) and
    trained ``steps`` AdamW steps by the Executor on ``dev`` from
    ``state``, dropout 0: the losses."""
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch import nn, optimizer, program_guard
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.ir import Program
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.tools.dygraph_bert import bert_classifier

    b = len(rows[0]) // steps
    main_prog, startup = Program(), Program()
    with unique_name.guard(), program_guard(main_prog, startup):
        ids = L.data("ids", [b, DY_SEQ], dtype="int64",
                     append_batch_size=False)
        pos = L.data("pos", [b, DY_SEQ], dtype="int64",
                     append_batch_size=False)
        bias = L.data("bias", [b, 1, 1, DY_SEQ], append_batch_size=False)
        lbl = L.data("lbl", [b, 1], dtype="int64", append_batch_size=False)
        net = bert_classifier(nn, layers=layers, dropout=0.0)
        loss = nn.CrossEntropyLoss()(net(ids, pos, bias), lbl)
        optimizer.AdamW(learning_rate=1e-4).minimize(loss)
    exe, scope = Executor(device=dev), Scope()
    exe.run(startup, scope=scope, use_compiled=False)
    for k, p in net.state_dict().items():
        scope.set(p.name, torch.from_numpy(state[k].copy()).to(dev))
    losses = []
    for i in range(steps):
        feed = dict(zip(("ids", "pos", "bias", "lbl"),
                        (a[i * b:(i + 1) * b] for a in rows)))
        losses.append(_loss(exe.run(main_prog, feed=feed, scope=scope,
                                    fetch_list=[loss])))
    exe.close()
    return losses


def _dy_mha(device, state=None, d=768, heads=12):
    """One eager MultiHeadAttention (d_model 768, 12 heads of 64) forward
    and backward on ``device`` at the main path's shape (b64, S=128,
    fp32) under its key-padding bias [B,1,1,S], a seeded cotangent on the
    output: (state, {output, input and parameter gradients})."""
    from paddle_tpu_torch import dygraph, nn
    from paddle_tpu_torch.tools.dygraph_bert import synthetic_rows

    r = np.random.RandomState(4)
    x = r.randn(DY_BATCH, DY_SEQ, d).astype(np.float32)
    cot = r.randn(DY_BATCH, DY_SEQ, d).astype(np.float32)
    bias = synthetic_rows(DY_BATCH, DY_SEQ, seed=4)[2]
    with dygraph.guard(device):
        np.random.seed(4)
        mha = nn.MultiHeadAttention(d, heads)
        if state is not None:
            mha.set_state_dict(state)
        start = {k: v.numpy() for k, v in mha.state_dict().items()}
        xv = dygraph.VarBase(x, stop_gradient=False)
        out = mha(xv, attn_mask=dygraph.VarBase(bias))
        (out * dygraph.VarBase(cot)).sum().backward()
        got = {"out": out.numpy(), "x_grad": xv.gradient()}
        got.update({f"{n}_grad": p.gradient()
                    for n, p in mha.named_parameters()})
    return start, got


def dygraph_parity(dev, layers=2, batch=4, steps=3):
    """First the eager MultiHeadAttention at the main path's shape (b64,
    12 heads of 64, S=128, fp32, the key-padding bias) forward and
    backward on the card and on the CPU from one state: its output and
    its input, q/k/v and output-projection gradients within DY_MHA_TOL of
    the CPU's (the plain versions), its card run one bnsd flash forward
    and one bnsd backward launch (a comparison: not counted in the path).
    Then the path: the network at 2 layers, b4, trained 3 AdamW steps
    eagerly on the card and on the CPU from one state (fp32, TF32 off),
    losses and every parameter within 1e-4, the dropout masks bit for bit
    (each eager dropout seeded from numpy's global RNG, seeded alike);
    eager against static on the card (the same Layers built under
    program_guard, the same weights, dropout 0), losses within 1e-5;
    save_dygraph on the card and load_dygraph on the CPU give the
    parameters bit for bit."""
    from paddle_tpu_torch import dygraph, kernels, nn
    from paddle_tpu_torch.tools.dygraph_bert import (bert_classifier,
                                                      synthetic_rows)

    t0 = time.perf_counter()
    mha_start, mha_cpu = _dy_mha("cpu")
    kernels.reset_launch_counts()
    mha_card = _dy_mha(dev, mha_start)[1]
    torch.cuda.synchronize()
    mha_layouts = kernels.layout_counts()
    mha_err = {k: float(np.max(np.abs(mha_card[k] - v)))
               for k, v in mha_cpu.items()}
    mha_bound = {k: DY_MHA_TOL * max(1.0, *(
        float(np.max(np.abs(mha_cpu[n])))
        for n in {k, k.replace(".bias_", ".weight_")}))
        for k in mha_cpu}
    mha_ok = all(mha_err[k] <= mha_bound[k] for k in mha_cpu) and all(
        mha_layouts[k] == {"packed": 0, "bnsd": 1}
        for k in ("flash_attention_fwd", "flash_attention_bwd"))
    rows = synthetic_rows(batch * steps, DY_SEQ, seed=1)
    with dygraph.guard("cpu"):
        np.random.seed(1)
        state = {k: v.numpy() for k, v in
                 bert_classifier(nn, layers=layers).state_dict().items()}
    kernels.reset_launch_counts()
    card = _dy_train(dev, state, rows, steps, 0.1, layers)
    cpu = _dy_train("cpu", state, rows, steps, 0.1, layers)
    loss_err = float(np.max(np.abs(np.subtract(card[0], cpu[0]))))
    param_err = max(float(np.max(np.abs(card[1][k] - cpu[1][k])))
                    for k in state)
    masks_equal = len(card[2]) == len(cpu[2]) > 0 and all(
        np.array_equal(a, b) for a, b in zip(card[2], cpu[2]))
    eager = _dy_train(dev, state, rows, steps, 0.0, layers)[0]
    static = _dy_static(dev, state, rows, steps, layers)
    static_err = float(np.max(np.abs(np.subtract(eager, static))))
    DYGRAPH_DIR.mkdir(parents=True, exist_ok=True)
    path = str(DYGRAPH_DIR / "parity")
    dygraph.save_dygraph(card[3].state_dict(), path)
    loaded, _ = dygraph.load_dygraph(path)
    with dygraph.guard("cpu"):
        cpu_net = bert_classifier(nn, layers=layers)
        cpu_net.set_state_dict(loaded)
        reload_equal = all(np.array_equal(v.numpy(), card[1][k])
                           for k, v in cpu_net.state_dict().items())
    torch.cuda.synchronize()
    counts = _phase_counts()
    emit("dygraph_parity", mha_shape=[DY_BATCH, 12, DY_SEQ, 64],
         mha_max_abs_err=mha_err, mha_bound=mha_bound,
         mha_launches_by_layout=mha_layouts,
         mha_tolerance=f"max|card-CPU| <= {DY_MHA_TOL} * max(1, max|CPU|)"
                       ", a bias gradient's with its weight's",
         layers=layers, batch=batch, steps=steps,
         loss_card=card[0], loss_cpu=cpu[0], loss_abs_err=loss_err,
         param_abs_err=param_err, dropout_masks=len(card[2]),
         masks_bitwise_equal=masks_equal, eager_losses=eager,
         static_losses=static, eager_static_abs_err=static_err,
         save_card_load_cpu_bitwise=reload_equal,
         tolerance={"card_cpu": 1e-4, "eager_static": 1e-5},
         launches=counts["launches"], seconds=time.perf_counter() - t0)
    if not mha_ok:
        raise AssertionError(f"dygraph_parity: eager MultiHeadAttention "
                             f"card against CPU {mha_err} (bounds "
                             f"{mha_bound}), flash by layout {mha_layouts}")
    if not (loss_err <= 1e-4 and param_err <= 1e-4 and masks_equal
            and static_err <= 1e-5 and reload_equal):
        raise AssertionError("dygraph_parity: card, CPU and static disagree")
    return counts


# -- @to_static: the 2.0 BERT-base's forward as one program --------------------

TS_TIMED, TS_UNTIMED = 10, 2
# replay against the block run op by op on the card: the same lowerings
# and kernels on the same inputs, the same seeds (the replay's seed
# table holds what the op-by-op run computes at step 0)
TS_REPLAY_TOL = 0.0
# eager against @to_static, 3 AdamW steps at dropout 0 from one state:
# the same lowerings (eager ops through trace_op, the replay through
# run_op) on the card; PR 20's card-vs-CPU spread (9.5e-7 in the losses,
# 1.5e-5 in the parameters) is the scale
TS_EAGER_TOL = {"loss": 1e-6, "param": 2e-5}


def _ts_net(nn, state, dropout):
    """The full-width network with ``dropout``, its weights ``state``."""
    from paddle_tpu_torch.tools.dygraph_bert import BERT_BASE, bert_classifier

    np.random.seed(0)
    net = bert_classifier(nn, **dict(BERT_BASE, dropout=dropout))
    net.set_state_dict(state)
    return net


def _ts_opt(optimizer, net):
    """AdamW (weight decay 0.01) at dygraph_bert_base's rate: 1e-4 after a
    LinearWarmup over DY_LR_WARMUP steps from 0 (a new optimizer's first
    steps at a fixed 1e-5 made the post-LN network's loss jump from 0.2
    to 3.9 in a probe run, eager and @to_static alike)."""
    sched = optimizer.lr.LinearWarmup(1e-4, DY_LR_WARMUP, 0.0, 1e-4)
    return optimizer.AdamW(learning_rate=sched, parameters=net.parameters(),
                           weight_decay=0.01), sched


def _ts_step(net, opt, sched, loss_fn, batch):
    """One training step of the 2.0 loop: forward, loss, backward, AdamW,
    clear, the rate's step; the loss tensor."""
    loss = loss_fn(net(*batch[:3]), batch[3])
    loss.backward()
    opt.step()
    opt.clear_grad()
    sched.step()
    return loss


def _ts_timed(dev, state, batch):
    """The timed leg: the network (dropout 0.1) with its forward under
    @to_static, AdamW (_ts_opt), TS_UNTIMED untimed steps (the first
    traces and captures), then TS_TIMED timed ones between synchronizes,
    their launches each, then one step traced by torch.profiler."""
    from paddle_tpu_torch import dygraph, kernels, nn, optimizer
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.tools.profile_train import traced

    net = _ts_net(nn, state, 0.1)
    net.forward = dygraph.to_static(net.forward)
    opt, sched = _ts_opt(optimizer, net)
    loss_fn = nn.CrossEntropyLoss()
    uncaptured = telemetry.counter_get("executor.uncaptured_steps") or 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    untimed_ms, ms, launches, losses = [], [], [], []
    for i in range(TS_UNTIMED + TS_TIMED):
        torch.cuda.synchronize()
        c0 = kernels.launch_counts()
        t0 = time.perf_counter()
        loss = _ts_step(net, opt, sched, loss_fn, batch)
        torch.cuda.synchronize()
        (untimed_ms if i < TS_UNTIMED else ms).append(
            (time.perf_counter() - t0) * 1e3)
        c1 = kernels.launch_counts()
        launches.append({k: c1[k] - c0[k] for k in c1})
        losses.append(float(loss.numpy()))
    trace = traced(lambda: _ts_step(net, opt, sched, loss_fn, batch), 1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    uncaptured = (telemetry.counter_get("executor.uncaptured_steps") or 0) \
        - uncaptured
    n_params = len(net.parameters())
    return net, dict(
        untimed_ms=untimed_ms, step_ms_p50=float(np.median(ms)),
        step_ms_range=[min(ms), max(ms)], losses=losses, peak_gb=peak,
        device_busy_ms=trace["device_busy_ms"],
        traced_wall_ms=trace["traced_wall_ms"],
        device_idle_share=trace["device_idle_share"],
        traced_launches=trace["traced_launches"],
        top_kernels=trace["top_kernels"][:6],
        launches_per_step=launches[TS_UNTIMED:],
        parameter_tensors=n_params, uncaptured_steps=uncaptured,
        traces=len(net.forward._cache))


def _ts_replay_vs_uncaptured(net, batch):
    """One forward and backward of the timed leg's network through the
    graph replay and through the block run op by op on the card, from the
    same parameters: the largest |difference| of the logits and of every
    parameter gradient."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.ops.control_flow_ops import run_program_graphs

    loss_fn, got = nn.CrossEntropyLoss(), []
    for graphs in (True, False):
        with run_program_graphs(graphs):
            logits = net(*batch[:3])
            loss_fn(logits, batch[3]).backward()
        got.append((logits._tensor.detach().clone(),
                    {n: p._tensor.grad.clone()
                     for n, p in net.named_parameters()}))
        net.clear_gradients()
    (l1, g1), (l2, g2) = got
    return {"logits": float((l1 - l2).abs().max()),
            "grads": max(float((g1[k] - g2[k]).abs().max()) for k in g1)}


def _ts_eager_vs_static(dev, state, batch, steps=3):
    """3 AdamW steps (_ts_opt, dropout 0) of the eager network and of its
    @to_static twin from one state on the card: both losses, the largest
    |difference| of the parameters after them, and the twin."""
    from paddle_tpu_torch import dygraph, nn, optimizer

    runs = []
    for static in (False, True):
        net = _ts_net(nn, state, 0.0)
        if static:
            net.forward = dygraph.to_static(net.forward)
        opt, sched = _ts_opt(optimizer, net)
        loss_fn = nn.CrossEntropyLoss()
        losses = [float(_ts_step(net, opt, sched, loss_fn, batch).numpy())
                  for _ in range(steps)]
        runs.append((losses, net))
    (le, eager), (ls, static) = runs
    se = dict(eager.named_parameters())
    param_err = max(float((p._tensor - se[n]._tensor).detach().abs().max())
                    for n, p in static.named_parameters())
    del eager
    return le, ls, param_err, static


def _ts_amp(net, batch):
    """The @to_static twin (dropout 0, eval) without grads: its replay
    without auto_cast, a fresh @to_static of the same forward traced and
    called twice under auto_cast, and the eager forward under auto_cast.
    The reference applies AMP only in trace_op, so the trace's matmuls are
    bf16 while every replay is the fp32 program."""
    from paddle_tpu_torch import amp, dygraph
    from paddle_tpu_torch.dygraph import jit

    net.eval()
    with dygraph.no_grad():
        fp32 = net(*batch[:3])._tensor.clone()
        fresh = dygraph.to_static(net.forward._fn_original)
        with amp.auto_cast():
            calls = [fresh(*batch[:3])._tensor.clone() for _ in range(2)]
            jit.ProgramTranslator.get_instance().enable(False)
            try:
                eager = net(*batch[:3])._tensor.clone()
            finally:
                jit.ProgramTranslator.get_instance().enable(True)
    blk = fresh.main_program.global_block()
    mm = [blk.var(op.output("Out")[0]).dtype for op in blk.ops
          if op.type == "matmul_v2"]
    return dict(
        replay_dtypes=[str(c.dtype) for c in calls],
        traced_matmul_dtypes=sorted({str(d) for d in mm}),
        matmuls=len(mm),
        replay_equals_fp32=all(torch.equal(c, fp32) for c in calls),
        eager_amp_vs_fp32=float((eager.float() - fp32).abs().max()))


def to_static_bert_base(dev, smi, state):
    """The 2.0 BERT-base's forward under @to_static on the card, at full
    width (12 layers, d_model 768, 12 heads, ffn 3072, s128, b64, fp32,
    dropout 0.1, AdamW as dygraph_bert_base's: _ts_opt), from the weights
    dygraph_bert_base left (its
    state_dict), on its batch of seeded rows. The forward is one
    run_program op replaying a forward CUDA graph, and its backward a
    backward graph. Four legs:
    1. timed: TS_UNTIMED untimed steps (the first traces the forward
       eagerly, then warms up and captures both graphs), TS_TIMED timed
       ones: step ms p50 and range, one traced step's busy ms and idle
       share, peak GB, the capture step's ms, losses (the fit of the one
       batch, falling), every timed step's launches (12 bnsd flash
       forward and 12 bnsd backward from the replays, 196 AdamW from the
       optimizer's captured micro-program), no uncaptured run;
    2. replay against the block run op by op on the card: logits and
       every parameter gradient, TS_REPLAY_TOL;
    3. eager against @to_static at dropout 0: 3 AdamW steps from one
       state, losses and parameters within TS_EAGER_TOL;
    4. AMP: under auto_cast a fresh trace records bf16 matmuls, and both
       calls return the fp32 program's logits bit for bit (the reference's
       replay runs no cast), where the eager auto_cast forward differs.
    The path's launch counts are the timed leg's (its untimed and traced
    steps included)."""
    from paddle_tpu_torch import dygraph, kernels
    from paddle_tpu_torch.tools.dygraph_bert import synthetic_rows

    t0 = time.perf_counter()
    rows = synthetic_rows(DY_BATCH, DY_SEQ, seed=0)
    with dygraph.guard(dev):
        batch = [dygraph.VarBase(a) for a in rows]
        kernels.reset_launch_counts()
        net, timed = _ts_timed(dev, state, batch)
        torch.cuda.synchronize()
        counts = _phase_counts()
        kernels.reset_launch_counts()
        replay_err = _ts_replay_vs_uncaptured(net, batch)
        del net
        _release()
        le, ls, param_err, twin = _ts_eager_vs_static(dev, state, batch)
        amp_leg = _ts_amp(twin, batch)
        del twin
    want = {"flash_attention_fwd": 12, "flash_attention_bwd": 12,
            "fused_adamw": timed["parameter_tensors"]}
    steps = TS_UNTIMED + TS_TIMED + 1
    # the trace's eager forward, one forward replay a step, one backward
    # replay a step, one AdamW launch a parameter a step
    totals = {"flash_attention_fwd": 12 * (steps + 1),
              "flash_attention_bwd": 12 * steps,
              "fused_adamw": timed["parameter_tensors"] * steps}
    loss_err = float(np.max(np.abs(np.subtract(le, ls))))
    emit("to_static_bert_base", model="bert_base_2.0_nn_to_static",
         layers=12, seq=DY_SEQ, batch=DY_BATCH,
         lr=f"1e-4 after LinearWarmup over {DY_LR_WARMUP} steps from 0",
         timed=timed,
         replay_vs_uncaptured=replay_err, replay_tolerance=TS_REPLAY_TOL,
         eager_losses=le, static_losses=ls, eager_static_loss_err=loss_err,
         eager_static_param_err=param_err, eager_tolerance=TS_EAGER_TOL,
         amp=amp_leg, launches=counts["launches"], launches_want=totals,
         flash_launches_by_layout=counts["layouts"],
         flash_launches_by_dtype=counts["dtypes"],
         seconds=time.perf_counter() - t0, nvidia_smi=smi)
    bad = [s for s in timed["launches_per_step"]
           if any(s[k] != v for k, v in want.items())]
    got = {k: counts["launches"][k] for k in totals}
    if bad or got != totals or timed["uncaptured_steps"] or \
            timed["traces"] != 1:
        raise AssertionError(f"to_static_bert_base: launches a step "
                             f"{bad[:1]}, want {want}; path {got}, want "
                             f"{totals}; uncaptured "
                             f"{timed['uncaptured_steps']}")
    head, tail = timed["losses"][:2], timed["losses"][-2:]
    if not np.mean(tail) < np.mean(head) or \
            not np.all(np.isfinite(timed["losses"])):
        raise AssertionError(f"to_static_bert_base: loss does not fall "
                             f"{timed['losses']}")
    if max(replay_err.values()) > TS_REPLAY_TOL:
        raise AssertionError(f"to_static_bert_base: replay against the "
                             f"uncaptured block {replay_err}")
    if loss_err > TS_EAGER_TOL["loss"] or param_err > TS_EAGER_TOL["param"]:
        raise AssertionError(f"to_static_bert_base: eager {le} against "
                             f"static {ls}, parameters {param_err}")
    if not (amp_leg["replay_equals_fp32"]
            and amp_leg["replay_dtypes"] == ["torch.float32"] * 2
            and amp_leg["traced_matmul_dtypes"] == ["bfloat16"]
            and amp_leg["eager_amp_vs_fp32"] > 1e-4):
        raise AssertionError(f"to_static_bert_base: AMP replay {amp_leg}")
    return counts


def fit_vision_zoo(dev, smi, batch=64, steps=5):
    """The 2.0 zoo through hapi.Model: mobilenet_v2() (scale 1.0, 1000
    classes) on FakeData 3x224x224 (ToTensor + Normalize) at b64, 5 fit
    steps with Momentum under CosineAnnealingDecay, then evaluate; then
    resnet50() through Model.predict on 64 rows. Step ms and peak GB; no
    port kernel runs here (cuDNN convs): its launch counts are 0."""
    from paddle_tpu_torch import (dygraph, kernels, metric, nn, optimizer,
                                  vision)
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.vision import datasets, transforms

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    tr = transforms.Compose([transforms.ToTensor(), transforms.Normalize(
        [0.485, 0.456, 0.406], [0.229, 0.224, 0.225])])
    ds = datasets.FakeData(num_samples=batch * steps,
                           image_shape=(3, 224, 224), num_classes=1000,
                           transform=tr, seed=0)
    with dygraph.guard(dev):
        np.random.seed(0)
        net = vision.models.mobilenet_v2()
        sched = optimizer.lr.CosineAnnealingDecay(0.05, T_max=steps)
        opt = optimizer.Momentum(learning_rate=sched, momentum=0.9,
                                 parameters=net.parameters())
        model = Model(net, inputs=["image"], device=dev)
        model.prepare(opt, nn.CrossEntropyLoss(),
                      metric.Accuracy(topk=(1, 5)))
        clock = _dy_clock(kernels, sched)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model.fit(ds, batch_size=batch, epochs=1, shuffle=False, verbose=0,
                  callbacks=[clock])
        peak_fit = torch.cuda.max_memory_allocated() / 1e9
        head = vision.datasets.FakeData(num_samples=batch,
                                        image_shape=(3, 224, 224),
                                        num_classes=1000, transform=tr,
                                        seed=1)
        ev = model.evaluate(head, batch_size=batch, verbose=0)
        del model, net, opt
        _release()
        torch.cuda.reset_peak_memory_stats()
        r50 = Model(vision.models.resnet50(), inputs=["image"], device=dev)
        torch.cuda.synchronize()
        tp = time.perf_counter()
        out = r50.predict(head, batch_size=batch, stack_outputs=True)[0]
        torch.cuda.synchronize()
        predict_ms = (time.perf_counter() - tp) * 1e3
        peak_predict = torch.cuda.max_memory_allocated() / 1e9
    counts = _phase_counts()
    emit("fit_vision_zoo", model="mobilenet_v2", batch=batch, steps=steps,
         step_ms=clock.ms, step_ms_p50=float(np.median(clock.ms[1:])),
         losses=clock.losses, peak_gb_fit=peak_fit, evaluate=ev,
         resnet50_predict_ms=predict_ms, resnet50_predict_shape=list(
             out.shape), peak_gb_predict=peak_predict,
         launches=counts["launches"], seconds=time.perf_counter() - t0,
         nvidia_smi=smi)
    if out.shape != (batch, 1000) or not np.all(np.isfinite(out)) or \
            not np.all(np.isfinite(clock.losses)) or \
            any(counts["launches"].values()):
        raise AssertionError(f"fit_vision_zoo: predict {out.shape}, losses "
                             f"{clock.losses}, launches "
                             f"{counts['launches']}")
    return counts


def infer_phases(dev):
    """The inference plane's phases over two BERT-base dirs written under
    SERVING_DIR (removed at the end): infer_bert_base,
    infer_http_bert_base, infer_cluster_swap, then the int8 serving path
    over the first dir: infer_int8_bert_base (PTQ, both converts, their
    dirs) and infer_int8_cluster_scale (the weight-only dir published,
    scaled 1 -> 2 -> 1, two online trials)."""
    import shutil
    import tempfile

    SERVING_DIR.mkdir(parents=True, exist_ok=True)
    base = tempfile.mkdtemp(prefix="bert_base_", dir=SERVING_DIR)
    runs = {}
    try:
        dirs = {v: str(Path(base) / f"v{v}") for v in (1, 2)}
        cfg, s1 = _bert_infer_dir(dev, 0, dirs[1])
        _, s2 = _bert_infer_dir(dev, 1, dirs[2])
        emit("bert_base_dirs", seconds=[s1, s2], bytes=sum(
            p.stat().st_size for p in Path(dirs[1]).iterdir()))
        reqs = _bert_infer_requests(cfg)
        runs["infer_bert_base"] = infer_bert_base(dev, dirs[1], cfg, reqs)
        runs["infer_http_bert_base"] = infer_http_bert_base(
            dev, dirs[1], cfg, reqs, runs["infer_bert_base"].pop("outs"))
        runs["infer_cluster_swap"] = infer_cluster_swap(dev, cfg, dirs, reqs)
        int8 = infer_int8_bert_base(dev, cfg, dirs[1], reqs, base)
        runs["infer_int8_bert_base"] = int8
        runs["infer_int8_cluster_scale"] = infer_int8_cluster_scale(
            dev, cfg, int8.pop("dir"), int8.pop("n_int8"))
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return runs


def _release():
    """Free what the last phase left: its graphs' pools go with their
    executors, and cyclic garbage only with a collection."""
    gc.collect()
    torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs "
              "an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models.decoder_lm import (DecoderLMConfig,
                                                    decoder_lm_params,
                                                    save_decoder_lm)

    dev = torch.device("cuda:0")
    smi = nvidia_smi()
    t0 = time.perf_counter()
    per_source = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in (_build.BUILD_DIR /
                                       f"{n}.ptxas.txt").read_text()
                 .splitlines() if "registers" in ln or "spill" in ln]
             for n in _build.SOURCES
             if (_build.BUILD_DIR / f"{n}.ptxas.txt").exists()}
    flash = ("flash_attention_fwd", "flash_attention_bwd")
    tensor_core = flash + ("conv_bn_relu", "int8_gemm")
    hgmma = {n: sass_count(_build.lib_path(n), "HGMMA") for n in tensor_core}
    # the int8 GEMM converts its weight by byte permutes and a subtract,
    # with no int-to-float conversion instruction
    i2f = sass_count(_build.lib_path("int8_gemm"), "I2F")
    tc_ptxas = {n: ptxas_by_kernel((_build.BUILD_DIR / f"{n}.ptxas.txt")
                                   .read_text(), ("_tc", "_tf32"))
                for n in flash}
    emit("build", seconds=build_s, per_source_s=per_source, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), ptxas=ptxas,
         hgmma_instructions=hgmma, int8_gemm_i2f_instructions=i2f,
         tensor_core_kernels_ptxas=tc_ptxas)
    if not all(hgmma.values()) or i2f:
        raise AssertionError(f"build: a tensor-core library has no HGMMA "
                             f"instruction ({hgmma}) or the int8 GEMM "
                             f"converts with I2F ({i2f})")

    results = []
    check_flash(dev, results)
    check_paged(dev, results)
    check_int8(dev, results)
    mask_check = check_flash_train(dev, results)
    check_flash_bert_base(dev, results)
    wmt_masks = check_flash_transformer_big(dev, results)
    check_flash_long(dev, results)
    empty_rows = check_flash_empty_rows(dev, results)
    bnsd_check = check_flash_bnsd(dev, results)
    adamw_check = check_adamw(dev, results)
    check_layer_norm(dev, results)
    check_conv(dev, results)
    check_flash_bert_infer(dev, results)
    check_flash_to_static(dev, results)
    static_int_mm = check_int8_bert_base(dev, results)
    emit("kernels", results=results, dropout_mask=mask_check,
         int8_static_int_mm=static_int_mm,
         dropout_mask_transformer_big=wmt_masks, bnsd_layout=bnsd_check,
         adamw=adamw_check, flash_rows_without_a_key=empty_rows)

    cfg = DecoderLMConfig(**FULL)
    t0 = time.perf_counter()
    params = decoder_lm_params(cfg, seed=0)
    emit("params", seconds=time.perf_counter() - t0,
         tensors=len(params), elements=int(sum(v.size
                                               for v in params.values())))
    # each path's own launch counts, and the flash kernels' by layout
    runs = {phase: serve(phase, cfg, params, quant, dev)
            for phase, quant in (("serve_fp32", "none"),
                                 ("serve_int8", "int8"))}
    for phase, quant in (("serve_prefix_fp32", "none"),
                         ("serve_prefix_int8", "int8")):
        runs[phase] = serve_prefix(phase, cfg, params, quant, dev)
    # the HTTP plane serves the same weights from a servable dir
    import shutil
    import tempfile

    SERVING_DIR.mkdir(parents=True, exist_ok=True)
    model_dir = tempfile.mkdtemp(prefix="decoder_lm_full_",
                                 dir=SERVING_DIR)
    try:
        t0 = time.perf_counter()
        save_decoder_lm(model_dir, cfg, params)
        emit("model_dir", seconds=time.perf_counter() - t0,
             bytes=sum(p.stat().st_size for p in Path(model_dir).iterdir()))
        for phase, quant, ref in (("serve_http_fp32", "none", "serve_fp32"),
                                  ("serve_http_int8", "int8", "serve_int8")):
            runs[phase] = serve_http(phase, cfg, quant, dev, model_dir,
                                     runs[ref]["ids"])
        runs.update(serve_cluster(cfg, dev, model_dir,
                                  runs["serve_prefix_fp32"]["ids"],
                                  runs["serve_fp32"]["ids"]))
        runs["observe_serve_int8"] = observe_serve_int8(
            dev, cfg, model_dir, runs["serve_int8"]["ids"],
            runs["serve_http_int8"]["launches"])
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    _release()
    runs.update(infer_phases(dev))
    cpu_parity(cfg, params, dev)
    cpu_parity(cfg, params, dev, "int8")
    del params
    runs["queue_c_card"] = queue_c_card(dev)
    runs["flash_general_bias"] = flash_general_bias(dev)
    runs["train_parity"] = train_parity(dev, 2, "float32", 3, 1e-4)
    # the CPU halves of the parity legs are the slowest of the script on a
    # slow host (a run whose host built the sources in 35 s, not 22, ended
    # at 1248 s, and one in PR 21 at 1177 s), and the whole must end
    # within its time limit: the bf16 leg at 2 steps (6, then 3), the deep
    # and seq-2048 legs at 2 steps, the deep one at 4 layers (24, then 12,
    # then 6), the seq-2048 one at 1 layer (2 before to_static_bert_base)
    runs["train_parity_bf16"] = train_parity(dev, 2, "bfloat16", 2, 1e-2)
    runs["train_parity_4"] = train_parity(dev, 4, "float32", 2, 1e-4)
    runs["train_parity_long"] = train_parity(dev, 1, "float32", 2, 1e-4,
                                             seq=LONG[0][0], batch_size=1)
    runs["compiled_parity"] = compiled_parity(dev, smi)
    _release()
    runs["train_ernie"] = train_ernie(dev, smi)
    _release()
    runs["train_ernie_fleet"] = train_ernie_fleet(dev, smi)
    _release()
    runs["run_steps_ernie"] = run_steps_ernie(dev, smi)
    _release()
    runs["observe_train_ernie"] = observe_train_ernie(dev, smi)
    _release()
    runs["bnsd_ops"] = bnsd_ops(dev)
    for seq, batch_size in LONG:
        _release()
        runs[f"train_long_s{seq}"] = train_ernie(
            dev, smi, f"train_long_s{seq}", seq, (batch_size,), timed=5)
    _release()
    runs["train_bert_base"] = train_bert_base(dev, smi)
    _release()
    runs["train_lenet"] = train_lenet(dev, smi)
    _release()
    runs["train_word2vec_sparse"] = train_word2vec_sparse(dev, smi)
    _release()
    runs["train_transformer_big"] = train_transformer_big(dev, smi)
    _release()
    runs["train_transformer_big_unfused"] = train_transformer_big_unfused(
        dev, smi, runs["train_transformer_big"].pop("step_ms_p50"))
    _release()
    runs["exp_conv"] = exp_conv_phase(dev, results)
    runs["fused_ln_ops"] = fused_ln_ops(dev)
    resnet_parity(dev, False, 1e-4)
    resnet_parity(dev, True, 1e-2)
    _release()
    runs["train_resnet50"], scope, layer_in = train_resnet50(dev, smi)
    check_conv_real_layer(dev, scope, layer_in)
    del scope, layer_in
    _release()
    runs["dropout_2p32"] = dropout_2p32(dev, smi)
    _release()
    runs["ops_glue_card"] = ops_glue_card(dev)
    _release()
    runs["linalg_extra_card"] = linalg_extra_card(dev)
    _release()
    runs["train_seq2seq"], s2s_cfg, s2s_scope = train_seq2seq(dev, smi)
    runs["decode_seq2seq"] = decode_seq2seq(dev, s2s_cfg, s2s_scope)
    del s2s_scope
    _release()
    runs["train_sentiment"] = train_sentiment(dev, smi)
    _release()
    runs["train_vgg16"] = train_vgg16(dev, smi)
    _release()
    runs["train_srl"], srl_cfg, srl_state, srl_scope = train_srl(dev, smi)
    runs["decode_srl"] = decode_srl(dev, srl_cfg, srl_scope)
    del srl_scope
    _release()
    runs["train_srl_gradient_merge"] = train_srl_gradient_merge(
        dev, smi, srl_state)
    _release()
    runs["control_flow_card"] = control_flow_card(dev)
    _release()
    runs["dygraph_bert_base"], runs["dygraph_bert_base_amp"], dy_state = \
        dygraph_bert_base(dev, smi)
    _release()
    runs["to_static_bert_base"] = to_static_bert_base(dev, smi, dy_state)
    del dy_state
    _release()
    runs["dygraph_parity"] = dygraph_parity(dev)
    _release()
    runs["fit_vision_zoo"] = fit_vision_zoo(dev, smi)
    _release()

    rep = {"flash_attention_fwd": "B=1 S=2048 n=16 hd=64 causal",
           "int8_gemm": "M=8 K=1024 N=4096 bias=True act=relu",
           "flash_attention_bwd": f"B=40 S={SEQ} n=16 hd=64 bias "
                                  f"dropout={RATE} bf16",
           "fused_adamw": "[1024, 4096] bf16",
           "layer_norm": "[20480, 1024] bf16"}
    main_path = {"flash_attention_bwd": "train_ernie",
                 "fused_adamw": "train_ernie", "layer_norm": "fused_ln_ops",
                 "conv_bn_relu": "exp_conv"}
    timing = ("shape", "ms", "device_ms", "plain_ms", "library_ms",
              "library_device_ms", "bound_ms", "bound_ms_three_pieces",
              "bound_ms_cuda_cores", "bound_by", "max_abs_err", "instance")
    line = []
    for name in kernels.MODULES:
        rows = [r for r in results if r["name"] == name]
        main_row = next((r for r in rows if r["shape"] == rep.get(name)),
                        rows[0])
        path = main_path.get(name, "serve_int8")
        line.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], path=path,
            launches=runs[path]["launches"][name],
            launches_by_path={p: c["launches"][name]
                              for p, c in runs.items()},
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"], shape=main_row["shape"],
            **{k_: main_row[k_] for k_ in (
                "device_ms", "library_device_ms", "bound_ms_three_pieces",
                "bound_ms_cuda_cores", "second_round", "chunk_tokens",
                "library_verdict") if k_ in main_row}))
        if name.startswith("flash") or name == "int8_gemm":
            # the same kernel at every timed shape (training, long context,
            # the bnsd rows; the int8 GEMM's M ladder)
            line[-1]["variants"] = [{k_: r[k_] for k_ in timing if k_ in r}
                                    for r in rows if r["ms"] is not None
                                    and r is not main_row]
        if name.startswith("flash"):
            # each path's launches by layout and by dtype instance
            line[-1]["launches_by_layout"] = {p: c["layouts"][name]
                                              for p, c in runs.items()}
            line[-1]["launches_by_dtype"] = {
                p: c["dtypes"][name] for p, c in runs.items()
                if name in c.get("dtypes", {})}
        if name == "int8_gemm":
            # the static-quant int8_matmul at BERT-base's shapes: a library
            # call (torch._int_mm), not a kernel of the port
            line[-1]["static_int_mm"] = static_int_mm
            line[-1]["instance"] = main_row["instance"]
            line[-1]["launches_by_instance"] = {
                p: c["int8_instances"] for p, c in runs.items()
                if "int8_instances" in c}
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
