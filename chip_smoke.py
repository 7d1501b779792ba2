#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) end to end on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit, no result line):
  1. build  — compile every CUDA kernel of the port from the sources in
              this checkout (one nvcc per source, in parallel);
  2. kernel checks — call each kernel at its main path's shapes and hold
              it against its plain PyTorch version on the same inputs
              (fp32, TF32 off; |kernel - plain| <= ATOL + RTOL * |plain|),
              and time kernel, plain version and a one-call PyTorch
              yardstick with CUDA events, L2 flushed before every call:
              K1-K3 at the serving shapes (K1 also at one long row, and
              in bf16 also at 8 rows of 4000, within one bf16 unit of an
              fp32 evaluation of the same inputs),
              K4-K7 at the BERT training
              shapes, K8/K9 at ResNet-50's batch-norm shapes for B=32
              (K9's split mode, sums then chain, bit for bit its one
              launch at one fp32 row and every bf16 "cl" row);
              fp32 K2 and K4 (both of K4's routes: its head kernel and
              its query/key pair, timed side by side at the training
              shape) also at S 1..512 and dh 8..128 across the edges of
              their tiles, causal and not, with a kv_len 0 row; K5 again
              on the same inputs, which must give the same bits; the
              registers, spills and shared memory of every kernel, from
              nvcc's -Xptxas -v report; K1 and K9's chain mode must repeat
              bit for bit too, and K9's chain time is split into its sums,
              fold and dx phases by the kernel's own clock;
  3. serving — ServingEngine(DecoderConfig()) (BERT-base width, 12 layers,
              random weights from seed 0, the engine's default: prefix cache
              on) serves 6 requests with prompts of 5..400 tokens, twice
              (the second pass hits the prefix cache); every request must
              finish with zero leaked pages, the serving kernels' launch
              counts must have moved, and the greedy tokens must equal the
              port's own dense full-forward oracle on the same scope
              (teacher-forced: each token the oracle's argmax over the
              engine's own prefix) and the two passes each other;
              speculative decoding (draft_k 4) on the same weights and
              requests, with the engine's n-gram drafts and with the known
              greedy continuation as the draft (every draft accepted), the
              tokens bit for bit the plain engine's; the prefix cache: 8
              requests sharing a 256-token system prompt, then the prompt
              alone twice (full hits, copy-on-write), against the dense
              oracle and a prefix_cache=False engine bit for bit, prefill
              tokens computed = prompt tokens - prefix hits, no leaked page
              before or after the cache's flush; bf16 serving
              (DecoderConfig(dtype="bfloat16")) of the same requests with
              the prefix cache on, plain decode (K1 bf16) and draft_k 4,
              each generated token's dense bf16 oracle logit within
              BF16_DELTA_ULPS bf16 units of the oracle's max, K1-K3
              launched in bf16; that gate at BERT-base width must refuse
              two planted faults, K1 reading the page table one page on
              and a copy-on-write that leaves the new page zero, at the
              random weights or, for a fault that passes there, with the
              attention peaked (q/k/v x4, out x2), where the unfaulted
              engine must pass; the rest of serving on the same weights
              and requests, each finished request's tokens the fault-free
              run's and the dense oracle's (the first position off and
              the oracle's top-2 gap printed where either misses), no
              leaked page, K1-K3 launched: the engine's resilience drills
              (a retried step fault, retry exhaustion into a recovery
              pass, the three pool corruptions caught by the audit, a
              deadline mid-decode, shedding and an AdmissionRejected, the
              degradation ladder to rung 4 and back), EngineConfig and the
              learned controller (shadow: nothing staged; apply: staged
              while busy, adopted idle, warmup_decode again, no cold
              decode signature and no library loaded after it), a fleet
              of replicas (affinity, a kill and a hang found by the
              heartbeat, drain-and-retire, the failover budget, the
              threaded pump) and a disaggregated prefill/decode pair over
              KV leases (weights bit for bit, commits, a dropped handoff
              reaped and replayed, a replica added on live KV, a prefill
              kill before commit, a decode kill holding adopted pages;
              the shared pool's audit clean, every lease reclaimed once);
  4. training — bert_pretrain(BERT-base, seq 128) + Adam(1e-4) through
              Program/Executor, B=32, fp32, random weights from seed 0:
              step 1's loss, every parameter gradient and the updated
              parameters must agree with a plain-torch autograd oracle on
              the same weights and batch, each training kernel must launch
              its expected count in the step, and the loss must fall over
              5 more steps (timed: steps/s, tokens/s, model FLOP/s);
  5. ResNet-50 training — models.resnet.resnet50 (s2d stem, NHWC,
              224x224, 1000 classes) + Momentum(0.1, 0.9) through
              Program/Executor, B=32, fp32, random weights from seed 0:
              step 1's loss, every parameter gradient, the momentum update
              and the running statistics must agree with a plain-torch
              autograd oracle on the same weights and batch, K8 must launch
              once per batch-norm op of the program (53), K9 once (its
              chain mode: the sums, their fold and dx in one launch) and
              K6/K7 once; then, from the same initial state at lr 0.01, the
              loss must fall over 5 more steps (timed: images/s, step
              ms, peak device memory);
  6. bf16 kernel checks — K2-K9 in bf16 against their plain versions in
              bf16 at the AMP steps' shapes (BERT-base and ResNet-50 at
              B=128; K9 also in its chain mode, timed against training
              batch norm's backward, its one pass against inference batch
              norm's; K2/K4 also at B=64, S=512
              and at one case of each of their other routes: causal, kv_lens
              with a kv_len 0 row, dh 40 and 128), and #15, the fused bf16
              bottleneck block, at the tool's shape: its path (one block,
              then a chain of 10) with launches counted (all on its wgmma
              kernel), against its plain version at the tool's inputs and
              at a unit-variance set where the convolutions, not the
              residual, set the output (there also against the library
              chain), two calls bit for bit, and the tool's A/B against
              the library chain;
              K3/K5 in fp32 and bf16 across their buckets (K 256 | 257,
              1024 | 1025, 2048, 100; R 1, 37 and 3000) and on a view at an
              odd storage offset; K7 in fp32 and bf16, both modes, at V =
              1000, 50257 and 128256 (clusters of 4 or 8 blocks a row), at the
              first width that streams, and at V = 1001 from every element
              phase of 16 bytes (rows at every phase), each repeated bit for
              bit;
  7. AMP training — bert_pretrain(BERT-base) + decorate(Adam(1e-4)) and
              resnet50 (s2d stem, NHWC) + decorate(Momentum(0.1, 0.9)) at
              B=128, bf16: step 1 against bf16 autograd oracles of the same
              cast scheme (ResNet-50's reads the port's input to each
              layer), each gradient, the loss and the running statistics
              within twice the bf16 oracle's own distance from an fp32
              oracle plus a floor, under a cap that a planted zeroed or
              negated gradient must fail, the fp32 master weights' update
              exact, launches by dtype as the program's var dtypes say;
              then 5 timed steps whose loss must fall; the BERT AMP step
              again under decorate(Lamb(linear_lr_warmup(polynomial_decay(
              ...)))), BERT's LAMB recipe: 5 runs across warmup into decay,
              the learning rate fetched each run against its closed form,
              step 1's fp32 master weights against the LAMB formula in
              float64 (1e-2 of each parameter's own step lr x trust), the
              beta powers beta^6 in fp32, the loss finite, launches by
              dtype; the twelve optimizers and three wrappers (apply and
              restore) on a tiny program, 3 steps each under one of three
              schedules, and nine schedules alone, on the card against
              the CPU (1e-7 + 1e-5 relative), every update and schedule op
              dispatched under the sync debug mode "error"; dgc on
              BERT-base's word embedding gradient (23.4 M elements)
              against a float64 sort-based quantile;
              bench.py:137's BERT-base AMP step (B=64, S=512, Adam) with
              the autotuner on, its DB under SMOKE_DATA: two run_async
              steps in explore mode resolve the attention key
              analytically (K2/K4), record it and probe both routes on
              the card (forward + backward, both arms' median, the band,
              the verdict and the DB entry printed); then consult mode
              after invalidate_cache(): one held and 3 timed steps, the
              provenance, every attention launch on the verdict's pair
              (K2/K4 or K10/K11, 12 each a step in bf16) and none on the
              other; each route forced by FLAGS_attention_force_backend
              for one step from the consult step's start, the two held
              against each other within the AMP bands' floors (loss 5e-3
              relative, each gradient 2e-2 in relative L2) and the
              consult step against its verdict's arm, 3 timed steps and
              the device's busy share of one traced step each; K2/K4 and
              K10/K11 bf16 are also timed alone at its [64, 12, 512, 64];
              transformer_wmt at bench.py:355 bench_wmt's widths
              (Transformer-base, dropout 0, src = tgt = 128, label
              smoothing 0.1) + decorate(Adam(1e-4)) at B=128, held as the
              BERT AMP step (K2/K4 bf16 three times a layer pair: the
              encoder's and the decoder's self-attention and the
              cross-attention; K3/K5 bf16 five times; the soft-label cross
              entropy on no kernel), 5 timed steps (steps/s, src + tgt
              tokens/s, bench.py:411's model TFLOP/s); then wmt_base() as
              published (dropout 0.1, attention unfused) at B=32: every
              dropout mask of step 1 fetched, its keep rate within 5
              binomial sigmas of 0.9, its values 0 and 1 / 0.9, its op's
              Out = X * Mask bit for bit, the oracles applying those
              masks, the masks repeated bit for bit by the same run
              counter and changed by a new one;
     book models — models/seq2seq.py's attention seq2seq at its own widths
              (word_dim 128, hidden_dim 256) over the WMT'14 dictionary of
              the book's machine-translation chapter (30000 words), B=64
              pairs padded to 50 (lengths 5-50), Adam(1e-3), fp32: step 1's
              loss, every gradient and the Adam update against a plain-torch
              oracle (the GRU and the attention step written out as loops),
              K6/K7 once each a step (and against their plain versions at
              its N=3200, V=30000), the loss falling over 5 timed steps;
              then infer_model's beam search (16 sources, beam 4, 50 While
              iterations): every step's beams the oracle's best, recomputed
              from the port's own previous beams, the sentences a numpy
              backtrack of the port's buffers, the loop's host syncs one an
              iteration (and one to leave) and its body free of any other
              (sync debug mode "error"), beam_search with finished rows
              against the frozen-beam rule; MNIST (BASELINE.json's first
              configuration): mnist_mlp and mnist_conv + Adam(1e-3) at
              B=128, step 1 against plain-torch oracles, K6/K7 once each;
     flash and probe checks — K10/K11 (flash attention, S > 512) in fp32
              and bf16 against their plain versions at the long-context
              steps' shapes, causal and not, at a ragged S = 1000 with
              dh = 128, beside scaled_dot_product_attention; K12 and K13
              through their tools' tables (launches counted), each variant,
              layout and block size against its plain version (K12's seven
              also at S = 200: two passes over a ragged last key tile);
  8. long-context training — tools/_sweep.py's `8 2048 1`: bert_pretrain
              (BERT-base, S=2048, max_position 2048, use_flash_attention) +
              decorate(Adam(1e-4)), B=8, through K10/K11 in bf16, held as
              the AMP step of phase 7 (oracles with each layer's attention
              checkpointed, peak memory printed); the same step from the
              same start under RecomputeOptimizer (tools/_sweep.py's
              SWEEP_RECOMPUTE arm: checkpoints transformer
              .last_layer_outputs): its loss bit for bit the plain step's,
              every gradient within 2e-2 relative L2 of the plain step's,
              K10 twice a layer (the forward and the replay), K11 once,
              K3/K5 bf16 inside the replays, its peak memory above its
              start below the plain step's; then an fp32 step at B=4,
              S=1024 (K10/K11 in fp32) held as phase 4;
  9. io, inference, recompute and the rest of the book — ResNet-50
              (bench.py:278's configuration) trained 3 fp32 steps at B=128,
              its running statistics set from one training-mode pass, its
              clone(for_test=True) saved by io.save_inference_model and
              served by create_paddle_predictor: the fp32 logits bit for
              bit a direct run of the clone and within 1e-4 relative L2 of
              a plain-torch oracle on the saved files, 53 K8 launches in
              inference mode and no K9, K6 or K7; the bf16 predictor
              (AnalysisConfig(enable_bf16=True), 53 bf16 K8 launches)
              within twice the bf16 oracle's distance from the fp32 oracle
              plus INFER_BF16_FLOOR, a gate that must refuse K8 reading
              the variance one channel on; BERT-base (S=128, B=128) as
              feature extraction the same way (12 K2 and 25 K3 launches in
              each dtype; the bf16 gate must refuse K2 reading the keys one
              position on); images/s and tokens/s, peak memory and device
              busy of each predictor; the ResNet-50 AMP step under
              RecomputeOptimizer (checkpoints at the 16 bottleneck outputs
              and the loss) against the plain AMP step from the same
              start: the loss and the running statistics bit for bit,
              every gradient within 2e-2 relative L2, K8 twice and K9 once
              a batch norm, K6 twice and K7 once (the replays through
              `_BatchNormFn` and `_XentFn`), peak memory and ms a step of
              both; word2vec (the book's defaults, B=100) and dense DeepFM
              (bench.py:436's widths, B=2048) under SGD(1e-3): step 1
              against plain-torch oracles, the loss falling over 5 timed
              steps (examples/s);
 10. the data pipeline, sparse gradients and the sequence/RNN tail —
              DeepFM (bench.py:423 bench_deepfm's TPU arm: 26 fields, 13
              dense, vocab 100000, embed 16, hidden 400x3, is_sparse=True,
              SGD(1e-3)) trained from 8 MultiSlot files of 16384 lines
              (written from seed 0 in bench.py's format, the label planted:
              1 where the first dense value exceeds the second) through
              Executor.train_from_dataset and a QueueDataset at batch 2048:
              the native parser equal bit for bit to the plain parser on
              every file, a malformed line raising in both; one sparse step
              against the dense program's and a plain-torch oracle (the
              loss bit for bit, fm_w1 and fm_emb within SPARSE_L2, their
              untouched rows bit for bit, sgd under the sync debug mode
              "error"); one Adam step's lazy update against a plain-torch
              lazy Adam (untouched rows of the parameter and both moments
              bit for bit, touched rows within LAZY_ADAM_L2); a one-thread
              pass against a plain Executor.run loop over the same batches
              (TRAINER_L2); 64 batches a 4-thread pass (stage counters);
              DeviceLoader feeds bit for bit the host arrays, copied on a
              side stream; examples/s end to end (5 passes after a warm
              one) and on one resident batch, their ratio, the device's
              busy share and the host split; a held-out batch's loss
              falling and its AUC rising; word2vec with
              is_sparse=True
              at B=100 held as DeepFM's step, its shared table's grad four
              concatenated SelectedRows; the 12 new sequence and RNN ops at
              the sizes users run (cudnn_lstm 2 layers bidirectional H=512,
              lstmp 4x512 / 256, DeepSpeech2's row_conv, sequence_conv 128
              filters, the rest at B=64, T=100, D=128), forward and every
              grad on the card against the same program on the CPU within
              SEQ_L2, ms a run each; tiered giant embeddings (ctr_giant):
              bench.py:557's parity (a 512 x 8 table behind a 256-slot
              cache, 12 SGD steps, within EMB_PARITY_ATOL of the dense
              program, every eviction written back), then bench.py:639
              bench_deepfm_giant's TPU arm (DeepFM at vocab 10,000,000:
              fm_emb, 640 MB, tiered at FLAGS_emb_hbm_budget_mb=64 into
              1,048,576 slots, fm_w1 dense) from 4 zipf-1.5 MultiSlot
              files through train_from_dataset on 4 threads (examples/s of
              5 passes after a warm one beside the same program with no
              budget, the hit rate against EMB_HIT_RATE_FLOOR, device busy,
              the stage counters), an evicting arm at 8,192 slots (a
              one-thread pass against the no-budget program within
              EMB_PARITY_ATOL, write-backs = evictions, 2 steps with every
              op's compute under the sync debug mode "error"), the host
              tier's delta checkpoints through CheckpointManager (restored
              bit for bit, the cache cold) and two stall drills
              (emb_host_stall, pipeline_stall) raising StallError;
 11. the dataset readers, the numeric guard and the checkpointed runner
              — book_readers: mnist.train() feeds the MNIST convnet,
              cifar.train10() resnet_cifar10 and imikolov's 5-grams (from a
              PTB-format simple-examples.tgz of PTB's size written under a
              temporary DATA_HOME) word2vec, through pt.batch and
              DataFeeder, READER_STEPS steps each under Adam: the reader's
              samples/s, the loss at step 1 and the last, which must fall,
              launches as the programs say; guard_resnet_amp: the ResNet-50
              AMP step (B=128, dynamic loss scaling) under
              FLAGS_guard_numerics and a StepGuard over a CheckpointManager,
              through run_async: a step dispatched under the sync debug
              mode "error", a FaultPlan's NaN and 1e4x-input steps (health
              marks the bad one, and the 1e4x one as the spike rule says;
              each skipped step's parameters and velocities bit for bit
              Momentum's update on zero gradients; the loss scale halved),
              NaN batches past the budget (the rewind restores every var of
              the checkpoint bit for bit and backs the LR off; replay_blame
              names an op and a var and leaves the live scope bit for bit),
              GuardError after FLAGS_guard_max_rewinds; steps/s guard on and
              off (P C C P) and the sentinel's launches and device time;
              DeepFM under the guard (a NaN step leaves every parameter bit
              for bit; train_from_dataset skips a NaN and a spike step and
              trains on: a held-out batch's loss falls, its AUC rises);
              runner_resnet_amp: a CheckpointedRunner over the same AMP step
              under executor.compile, collective.step and ckpt.write faults
              (every site fired, retries bounded, the latest step, the loss
              trajectory against two undisturbed runs by the determinism
              rule, cuDNN deterministic for the phase), and a persistent
              fault raising StepFailure after max_retries + 1 attempts;
 12. the op and layer long tail, MobileNetV3, the recommender —
              check_bn_mobilenet: K8 and K9 (chain mode) at MobileNetV3's
              NCHW "cr" rows, one a map size (BN_MBV3), against their plain
              versions, timed beside inference F.batch_norm (identity
              rows), training F.batch_norm and its backward, each K8 row's
              share of its bound and launches a step, and K8's time of a
              step as the rows predict it; longtail_ops:
              each of the 79 new ops as a one-op program at a public
              model's size (`_longtail_cases`), forward and every grad on
              the card against the CPU within LT_L2 (integers bit for bit),
              every non-host op under the sync debug mode "error"; the
              random ops by their laws, nce and the sampled softmax (its
              cross entropy on K6/K7) on their saved draws; the host ops;
              train_mobilenet_v3: MobileNetV3-Large x1.0 at 224x224, step 1
              at B=16 against the CPU (loss, every gradient, the running
              statistics; elements at a kink take the card's side in the
              CPU run), K8/K9 once a batch norm, then B=128 steps whose
              loss falls, images/s, peak memory and a profiled step with
              K8's device time beside check_bn_mobilenet's prediction;
              book_recommender: the Fluid book's recommender on
              dataset.movielens (step 1 against the CPU, 2 passes, the
              train and the test loss falling, samples/s with and without
              the reader);
 13. the vision and detection ops, YOLOv3 — check_bn_yolov3: K8 and K9
              (chain mode) at YOLOv3's NCHW "cr" rows (BN_YOLO, 608 x 608
              down to 19 x 19 at B=8), as check_bn_mobilenet; train_yolov3:
              YOLOv3 (DarkNet-53, 608 x 608, 80 classes, PaddleCV/yolov3's
              config: anchors and masks, ignore_thresh 0.7, label smoothing,
              50 gt rows, Momentum(0.001, 0.9), L2 decay 5e-4) on seeded
              synthetic images and boxes, step 1 at B=2 against the CPU (the
              loss, every gradient, the running statistics; leaky_relu
              inputs near 0 and ignore decisions near ignore_thresh take the
              card's side in the CPU run), K8/K9 72 times a step, a B=8 step
              under the sync debug mode "error", then B=8 steps whose loss
              falls, images/s, peak memory, a profiled step (busy, K8's and
              K9's device time beside BN_YOLO's prediction); serve_yolov3:
              the eval clone (three yolo_box, concat, transpose,
              multiclass_nms) saved by io.save_inference_model and served by
              create_paddle_predictor at B=8, its boxes and scores against
              the CPU predictor's, its NMS rows bit for bit the CPU op's on
              the card's own boxes and scores, a detection found, 72 K8
              launches, images/s; vision_ops: each of the 40 new ops as a
              one-op program at a public model's size (`_vision_cases`),
              forward and every grad on the card against the CPU within
              LT_L2 (integers bit for bit) under the sync debug mode
              "error", the random ops by their laws;
 14. the crf, ctc and quant ops, the book's SRL, CRNN-CTC — check_bn_crnn:
              K8 and K9 (chain mode) at CRNN's NCHW "cr" rows (BN_CRNN,
              48 x 512 down to 6 x 64 at B=32, relu folded), as
              check_bn_mobilenet; crf_ctc_ops: each of the 10 new ops as a
              one-op program at the SRL's or CRNN's size (`_crf_ctc_cases`),
              forward and every grad on the card against the CPU within
              LT_L2 (integers bit for bit), all but chunk_eval under the
              sync debug mode "error", warpctc also against F.ctc_loss;
              train_srl: the book's db_lstm (depth 8, hidden 512) with
              linear_chain_crf on conll05's synthetic reader, step 1 at B=10
              against the CPU (loss, every gradient), a step under the sync
              debug mode "error", 20 steps over batches of their own length
              (steps/s, sentences/s, busy, peak memory), then the decode
              clone with the ChunkEvaluator over 8 batches (precision,
              recall, F1; chunk_eval's host syncs counted); train_crnn_ctc:
              CRNN-CTC (PaddleCV/ocr_recognition, 48 x 512, 95 classes),
              step 1 at B=32 against the CPU (loss, every gradient, the
              running statistics; relu inputs near 0 take the card's side),
              K8/K9 8 times a step, a step under the sync debug mode
              "error", then steps whose loss falls (images/s, peak memory,
              a profiled step with K8's and K9's time beside BN_CRNN's
              prediction), the eval clone with the EditDistance evaluator
              (K8 8 times a run), and the QAT arm: QuantizationTransformPass
              on a fresh CRNN, steps under "error", QuantizationFreezePass
              and ConvertToInt8Pass on its eval clone (the int8 clone within
              LT_L2 of the frozen one);
 15. data parallelism — bench.py:112 bench_bert's shape (BERT-base AMP,
              S=128, global B=128, Adam(1e-4), dropout 0) over
              torch.distributed. dp_nccl1: one rank over NCCL, the
              fleet-transpiled step (fleet.distributed_optimizer ->
              GradAllReduce -> CompiledProgram.with_collective) for 3 steps
              against the untranspiled program: every parameter bit for bit
              but the word and position embeddings (lookup_table_grad's
              atomic index_add_; within DP_GRAD_L2, then copied across),
              the buckets, their bytes and the NCCL calls a step;
              dp_gloo2: two ranks sharing the card over gloo (CUDA tensors
              staged through pinned host memory), started by
              `python -m paddle_tpu_torch.distributed.launch --backend gloo`
              with this script as their worker (`--dp-worker`; the ranks
              load the kernels phase 1 built, and write their results to
              files); rank 0 first computes the one-process references on
              the card. Arms: (a) bucketed GradAllReduce — step 1's reduced
              gradients bit for bit the mean of the two B=64 gradients, the
              ranks' mean loss and the updates of 3 steps against the B=128
              run; (b) FLAGS_allreduce_bucket_mb=0 and (c) FLAGS_zero1, in
              lockstep with (a), every parameter bit for bit (a)'s after
              each step (the embeddings as above), (c) holding half of the
              eligible Adam moments' bytes; (d) LocalSGD k_steps=2, the
              ranks' parameter checksums apart after step 1 and equal
              after step 2; (e) with_data_parallel with the halves masking
              different counts: step 1 against the one-process B=128 step
              (the loss within DP_LOSS_RTOL, gradients within DP_GRAD_L2),
              the fleet arm on the same feed farther than DP_GRAD_L2; (f)
              ResNet-50 AMP (bench.py:282's network, B=128, 64 a rank, the
              last rank's images x3 +1) under with_data_parallel with the
              batch statistics synced (K8 on the global statistics, K9's
              split mode: the sums launch, their allreduce, the chain
              launch): each update and running statistic within its AMP
              band of the one-process step's, and the local-statistics
              variant beyond them; (g) wmt_base() AMP with dropout 0.1
              (B=32, 16 a rank): every dropout mask bit for bit the
              one-process run's, the gradients within the AMP band, a
              per-rank draw refused. Each arm's ms a step, ms in
              collectives (and in (f) the statistics' allreduces apart),
              collective calls, peak memory and launches by kernel and
              dtype a rank, the launches as the program says;
 16. pipeline parallelism — pipeline_bert: bench.py:112's BERT-base AMP
              (B=128, S=128) through PipelineOptimizer, 4 microbatches over
              two stages cut at encoder layer 6, GPipe and 1F1B in
              lockstep for 2 steps: the same bits but the embeddings, 1F1B's
              step 1 against the unpipelined step, last_peak_stash (<= S +
              1; M) and last_bubble beside (S-1)/(M+S-1), ms a step, peak
              memory and launches (K2 and K3 twice a microbatch and stage:
              the forward and the backward's replay);
 17. output — the `kernels` JSON line (fp32 and bf16 entries, #15, K12
              and K13, each with its dtype), the card line (nvidia-smi name
              and power limit), and last the `ok` JSON line. Each phase
              prints its wall seconds (`phase <name> <s> s [card]`).
Needs one CUDA device; exits non-zero without one.

    python3 chip_smoke.py --profile

also traces one more serving pass of each serving phase (the default
engine, speculative decoding, the prefix cache, bf16) and one more
training step of each configuration (the long-context fp32 one included)
with torch.profiler (in the BERT AMP steps under Adam and LAMB, the update
ops' kernels in a profiler range)
and prints where the device time went (per kernel, and the device's busy
share of the wall time; in the fp32 BERT step, K2's and K4's time and
launches; in the BERT and WMT steps, K3's and K5's; in the ResNet-50 AMP
step, the kernels launched inside the batch-norm grad ops, K9's and
torch's; in the WMT step, K2's and K4's and the kernels of its soft-label
chain: one_hot, label_smooth, the label's cast and the cross entropy, and
the cross entropy's grad; one seq2seq training step and one decode; the
long-context step under RecomputeOptimizer beside the plain one; the
ResNet-50 AMP step under RecomputeOptimizer). The predictors of phase 9
are traced in every run, for their device busy share.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

RTOL, ATOL = 1e-4, 1e-5
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, fp32 outside tensor cores
SEED = 0
SERVE_KERNELS = ("paged_decode_attention", "causal_prefill_attention",
                 "layer_norm_act")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


class _Timer:
    """Median device time of one call, each call timed alone with CUDA
    events after a write that evicts the 50 MB L2 (the serving path finds
    every layer's weights and KV pool cold). A spin of about a millisecond
    on the device before the start event lets the host enqueue the whole
    call first, so the time is the device's, not the Python wrapper's."""

    def __init__(self, device):
        self.flush = torch.empty(96 * 2**20 // 4, dtype=torch.float32,
                                 device=device)

    def __call__(self, fn, reps: int = 15) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def _agree(name: str, out: torch.Tensor, ref: torch.Tensor,
           atol: float = ATOL) -> float:
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise RuntimeError(f"{name}: shape {tuple(out.shape)} vs "
                           f"{tuple(ref.shape)} or non-finite output")
    err = (out - ref).abs()
    if not bool((err <= atol + RTOL * ref.abs()).all()):
        raise RuntimeError(f"{name}: kernel disagrees with its plain version "
                           f"(max abs err {err.max().item():.3e})")
    return float(err.max().item())


def _row(name, shape, ms, plain_ms, lib_ms, bound_ms, bound_by, err, card):
    lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
    print(f"{name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {lib} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"max_abs_err {err:.3e} [{card}]")


def _paged_inputs(K, dev, g, lens, P, pages, dtype, nh=12):
    B, dh, ps = len(lens), 64, 16
    perm = torch.randperm(pages, generator=g)
    table = torch.zeros((B, P), dtype=torch.int32)
    used = 0
    for b in range(B):
        n = -(-int(lens[b]) // ps)
        table[b, :n] = perm[used:used + n]
        used += n
    q = torch.randn((B, nh, dh), generator=g).to(dev, dtype)
    kp = torch.randn((pages, ps, nh, dh), generator=g).to(dev, dtype)
    vp = torch.randn((pages, ps, nh, dh), generator=g).to(dev, dtype)
    return (q, kp, vp, table.to(dev),
            torch.tensor(lens, dtype=torch.int32).to(dev))


def _ulp16(x):
    """One unit in the last place of bf16 at |x| (fp32 in, fp32 out): 2^-7
    of the power of two at or below |x|, and of 2^-126 below that."""
    _, e = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), e - 8)


def _paged_case(K, dev, timer, card, g, lens, P, pages=512,
                dtype=torch.float32, nh=12):
    """K1 at B = len(lens) rows of nh=12 (or `nh`: a tp rank's 6), dh=64,
    ps=16 (the serving model's widths) over a table P pages wide, against
    its plain version;
    returns (max_abs_err, ms, plain_ms, bound_ms). bf16: under `_agree16`
    against the plain version (which rounds the probabilities to bf16), and
    within one bf16 unit of the output's last place (plus 2^-20 of the
    row's max-abs for fp32 sums taken in another order) of the plain
    version run in fp32 on the same bf16 inputs."""
    args = _paged_inputs(K, dev, g, lens, P, pages, dtype, nh)
    q, table, lens_d = args[0], args[3], args[4]
    B, nh, dh = q.shape
    ps = args[1].shape[1]
    scale = dh ** -0.5
    out = K.paged_decode_attention(*args, scale)
    ref = K.paged_decode_attention_plain(*args, scale)
    live = lens_d > 0
    name = "paged_decode_attention" + (" bf16" if dtype != torch.float32
                                       else "")
    if dtype == torch.float32:
        err = _agree(name, out[live], ref[live])
    else:
        err = _agree16(name, out[live], ref[live])
        r32 = K.paged_decode_attention_plain(
            *(t.float() for t in args[:3]), table, lens_d, scale)[live]
        o = out[live].float()
        tol = _ulp16(r32) + 2.0 ** -20 * r32.abs().amax(dim=-1, keepdim=True)
        if not bool(((o - r32).abs() <= tol).all()):
            raise RuntimeError(
                f"{name}: more than one bf16 unit from the fp32 plain "
                f"version on the same inputs (max abs err "
                f"{(o - r32).abs().max().item():.3e})")
    if not bool((out[~live] == 0).all()):
        raise RuntimeError(f"{name}: kv_len 0 row not zero")
    _repeats(name, [out], [K.paged_decode_attention(*args, scale)])
    ms = timer(lambda: K.paged_decode_attention(*args, scale))
    plain_ms = timer(lambda: K.paged_decode_attention_plain(*args, scale))
    # the live slots' K and V (what this data needs), q, out, table, lens
    esize = q.element_size()
    nbytes = (2 * int(lens_d.sum()) * nh * dh * esize + 2 * q.numel() * esize
              + table.numel() * 4 + B * 4)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    sfx = "f32" if dtype == torch.float32 else "bf16"
    chunk, span, grid, smem, hg, occ = K._plan(B, nh, dh, ps, P, sfx)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if grid > occ * sms:
        raise RuntimeError(f"{name}: cooperative grid {grid} exceeds the "
                           f"resident blocks {occ} x {sms} SMs")
    _row(f"K1 {name}", f"B={B} nh={nh} dh={dh} ps={ps} P={P} "
         f"lens={list(lens)} (spans of {span} slots, chunks of {chunk}, {grid} blocks, "
         f"{smem} B of shared memory, {occ} blocks an SM)", ms,
         plain_ms, None, bound, "bytes", err, card)
    return err, ms, plain_ms, bound


def check_paged_decode(dev, timer, card):
    from paddle_tpu_torch.ops.cuda_kernels import paged_attention as K

    g = torch.Generator(device="cpu").manual_seed(SEED)
    err, ms, plain_ms, bound = _paged_case(
        K, dev, timer, card, g, [1, 16, 17, 500, 0, 33, 257, 64], 32)
    # one long row alone: its spans spread over the card
    _paged_case(K, dev, timer, card, g, [500], 32)
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "paddle_tpu_torch/ops/cuda_kernels/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels/paged_attention.py:164",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None}


def check_paged_decode16(dev, timer, card):
    """K1's bf16 entry at the fp32 rows' shapes: the serving batch, one row
    of 500 slots and 8 rows of 4000 (tables 256 pages wide, the engine's
    power-of-two width, as flash_ab.py times fp32 K1 there; a pool of 2048
    pages). No single torch call pages, so no library yardstick."""
    from paddle_tpu_torch.ops.cuda_kernels import paged_attention as K

    g = torch.Generator(device="cpu").manual_seed(SEED + 20)
    bf = torch.bfloat16
    err, ms, plain_ms, bound = _paged_case(
        K, dev, timer, card, g, [1, 16, 17, 500, 0, 33, 257, 64], 32,
        dtype=bf)
    _paged_case(K, dev, timer, card, g, [500], 32, dtype=bf)
    _paged_case(K, dev, timer, card, g, [4000] * 8, 256, pages=2048, dtype=bf)
    return _bf16_entry("paged_decode_attention", "paged_attention.cu",
                       "paddle_tpu/ops/pallas_kernels/paged_attention.py:164",
                       err, ms, plain_ms, bound, "bytes", None)


def _bound(flops, nbytes, flops_per_s=FP32_FLOPS_PER_S):
    """The larger of bytes over the HBM rate and operations over the peak
    rate of their type (fp32 outside the tensor cores unless given)."""
    t_ops, t_bytes = flops / flops_per_s, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _attn_bound(B, nh, S, dh, causal, lens=None, products=2, tensors=4):
    """The (query, key) pairs this data leaves live, 2 flops a pair and dim
    for each of `products` products; `tensors` [B, nh, S, dh] tensors moved
    once (forward: 2 products, q, k, v, out; backward: 5 products, q, k, v,
    dO, dq, dk, dv)."""
    pairs = 0
    for b in range(B):
        L = S if lens is None else int(lens[b])
        pairs += sum(min(i + 1, L) if causal else L for i in range(S))
    return _bound(2 * products * pairs * dh * nh, tensors * B * nh * S * dh * 4)


# fp32 K2/K4 cases at the edges of the 64-row tiles and of K4's head kernel
# (S <= 128, dh <= 64), at head widths the kernels zero-fill (dh 8 and 40
# run on D = 64, dh 100 on D = 128), causal and not, dense and with kv_lens
# [S, min(5, S), 0] (a kv_len 0 row); B = 3, nh = 2
EDGE_S = (1, 63, 64, 65, 127, 128, 129, 512)
EDGE_DH = (8, 40, 64, 100, 128)


def _edge_cases(g, dev, tensors):
    for S in EDGE_S:
        for dh in EDGE_DH:
            xs = [torch.randn((3, 2, S, dh), generator=g).to(dev)
                  for _ in range(tensors)]
            lens = torch.tensor([S, min(5, S), 0], dtype=torch.int32).to(dev)
            for causal in (False, True):
                for kl in (None, lens):
                    yield f"S={S} dh={dh} causal={causal} " + (
                        "dense" if kl is None else "kv_lens"), xs, causal, \
                        dh ** -0.5, kl


def check_prefill(dev, timer, card):
    from paddle_tpu_torch.ops.cuda_kernels import prefill_attention as K
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    nh, dh = 12, 64
    scale = dh ** -0.5
    entry = None
    # the serving prefill buckets (causal), a ragged batch, and the
    # training step's shape (B=32, S=128, not causal)
    cases = [(1, S, None, True) for S in (8, 100, 128, 256, 512)]
    cases.append((2, 128, torch.tensor([100, 0], dtype=torch.int32), True))
    cases.append((32, 128, None, False))
    for B, S, lens, causal in cases:
        q, k, v = (torch.randn((B, nh, S, dh), generator=g).to(dev)
                   for _ in range(3))
        kl = None if lens is None else lens.to(dev)
        out = K.causal_prefill_attention(q, k, v, causal, scale, kl)
        ref = K.causal_prefill_attention_plain(q, k, v, causal, scale, kl)
        err = _agree(f"causal_prefill_attention B={B} S={S}", out, ref)
        ms = timer(lambda: K.causal_prefill_attention(q, k, v, causal, scale, kl))
        plain_ms = timer(lambda: K.causal_prefill_attention_plain(
            q, k, v, causal, scale, kl))
        lib_ms = None
        if kl is None:
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=scale))
        bound, by = _attn_bound(B, nh, S, dh, causal,
                                None if lens is None else lens.tolist())
        _row("K2 causal_prefill_attention",
             f"B={B} nh={nh} S={S} dh={dh} causal={causal}"
             + ("" if lens is None else f" kv_lens={lens.tolist()}"),
             ms, plain_ms, lib_ms, bound, by, err, card)
        if S == 512:
            entry = {"name": "causal_prefill_attention", "route": "cuda",
                     "source": "paddle_tpu_torch/ops/cuda_kernels/csrc/prefill_attention.cu",
                     "replaces": "paddle_tpu/ops/pallas_kernels/short_attention.py:248 "
                                 "+ paddle_tpu/ops/pallas_kernels/attention.py:211",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
    n, worst = 0, 0.0
    for what, (q, k, v), causal, sc, kl in _edge_cases(g, dev, 3):
        out = K.causal_prefill_attention(q, k, v, causal, sc, kl)
        ref = K.causal_prefill_attention_plain(q, k, v, causal, sc, kl)
        worst = max(worst, _agree(f"causal_prefill_attention {what}", out, ref))
        if kl is not None and not bool((out[2] == 0).all()):
            raise RuntimeError(f"causal_prefill_attention {what}: the kv_len 0 "
                               f"row is not zero")
        n += 1
    print(f"K2 causal_prefill_attention fp32 edges: {n} cases agree (S in "
          f"{EDGE_S}, dh in {EDGE_DH}), max_abs_err {worst:.3e} [{card}]")
    return entry


def check_layer_norm(dev, timer, card):
    from paddle_tpu_torch.ops.cuda_kernels import layer_norm as K
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    K_ = 768
    entry = None
    # decode rows, a prefill bucket, and the training step's 4096 rows
    for R, act in ((1, "identity"), (8, "identity"), (8, "relu"),
                   (512, "identity"), (4096, "identity")):
        x = torch.randn((R, K_), generator=g).to(dev)
        s = (1 + 0.1 * torch.randn((K_,), generator=g)).to(dev)
        b = (0.1 * torch.randn((K_,), generator=g)).to(dev)
        out = K.layer_norm_act(x, s, b, 1e-5, act)
        ref = K.layer_norm_act_plain(x, s, b, 1e-5, act)
        err = max(_agree(f"layer_norm_act R={R} {act} {part}", o, r)
                  for part, o, r in zip(("y", "mean", "var"), out, ref))
        ms = timer(lambda: K.layer_norm_act(x, s, b, 1e-5, act))
        plain_ms = timer(lambda: K.layer_norm_act_plain(x, s, b, 1e-5, act))
        lib_ms = None
        if act == "identity":
            lib_ms = timer(lambda: F.layer_norm(x, (K_,), s, b, 1e-5))
        nbytes = (2 * R * K_ + 2 * K_ + 2 * R) * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        _row("K3 layer_norm_act", f"R={R} K={K_} act={act}", ms, plain_ms,
             lib_ms, bound, "bytes", err, card)
        if R == 512:
            entry = {"name": "layer_norm_act", "route": "cuda",
                     "source": "paddle_tpu_torch/ops/cuda_kernels/csrc/layer_norm.cu",
                     "replaces": "paddle_tpu/ops/pallas_kernels/epilogue.py:421",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": "bytes",
                     "library_ms": lib_ms}
    return entry


def _autograd_lib(fn, inputs, cot):
    """A one-call PyTorch yardstick for a backward: fn's graph built once,
    the timed call is torch.autograd.grad of it."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True)


def check_attention_backward(dev, timer, card):
    from paddle_tpu_torch.ops.cuda_kernels import attention_bwd as K
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(SEED + 3)
    nh, dh = 12, 64
    scale = dh ** -0.5
    entry = None
    # the training shape, #5's domain at S=512, and #3's ragged causal case
    for B, S, causal, lens in ((32, 128, False, None), (4, 512, False, None),
                               (2, 128, True, torch.tensor([100, 0],
                                                          dtype=torch.int32))):
        q, k, v, do = (torch.randn((B, nh, S, dh), generator=g).to(dev)
                       for _ in range(4))
        kl = None if lens is None else lens.to(dev)
        got = K.attention_backward(q, k, v, do, causal, scale, kl)
        ref = K.attention_backward_plain(q, k, v, do, causal, scale, kl)
        err = max(_agree(f"attention_backward S={S} d{n}", o, r)
                  for n, o, r in zip("qkv", got, ref))
        ms = timer(lambda: K.attention_backward(q, k, v, do, causal, scale, kl))
        plain_ms = timer(lambda: K.attention_backward_plain(
            q, k, v, do, causal, scale, kl))
        if kl is None:
            lib = lambda q, k, v: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=causal, scale=scale)
        else:
            # kv_lens and the causal bound as one boolean mask: the same
            # function in one call (its kv_len 0 row comes out NaN where
            # the kernel gives zeros; the yardstick is its time)
            key = torch.arange(S, device=dev)
            mask = key[None, None, None, :] < kl[:, None, None, None]
            if causal:
                mask = mask & (key[None, None, None, :]
                               <= key[None, None, :, None])
            lib = lambda q, k, v: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask, scale=scale)
        lib_ms = timer(_autograd_lib(lib, (q, k, v), do))
        bound, by = _attn_bound(B, nh, S, dh, causal,
                                None if lens is None else lens.tolist(),
                                products=5, tensors=7)
        _row("K4 attention_backward",
             f"B={B} nh={nh} S={S} dh={dh} causal={causal}"
             + ("" if lens is None else f" kv_lens={lens.tolist()}"),
             ms, plain_ms, lib_ms, bound, by, err, card)
        if entry is None:     # the head kernel's shape: its rival route too
            pair_ms = timer(lambda: K.attention_backward_pair(
                q, k, v, do, causal, scale, kl))
            print(f"K4 attention_backward B={B} nh={nh} S={S} dh={dh}: head "
                  f"kernel {ms:.4f} ms, query/key pair {pair_ms:.4f} ms "
                  f"[{card}]")
            entry = {"name": "attention_backward", "route": "cuda",
                     "source": "paddle_tpu_torch/ops/cuda_kernels/csrc/attention_backward.cu",
                     "replaces": "paddle_tpu/ops/pallas_kernels/short_attention.py:164 "
                                 "+ paddle_tpu/ops/pallas_kernels/attention.py:154",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
    n, worst = 0, 0.0
    for what, (q, k, v, do), causal, sc, kl in _edge_cases(g, dev, 4):
        ref = K.attention_backward_plain(q, k, v, do, causal, sc, kl)
        for fn in (K.attention_backward, K.attention_backward_pair):
            got = fn(q, k, v, do, causal, sc, kl)
            worst = max([worst] + [_agree(f"{fn.__name__} {what} d{c}", o, r)
                                   for c, o, r in zip("qkv", got, ref)])
            if kl is not None and not all(bool((o[2] == 0).all()) for o in got):
                raise RuntimeError(f"{fn.__name__} {what}: the kv_len 0 row's "
                                   f"gradients are not zero")
            n += 1
    print(f"K4 attention_backward fp32 edges: {n} cases agree on the head "
          f"kernel's and the pair's routes (S in {EDGE_S}, dh in {EDGE_DH}), "
          f"max_abs_err {worst:.3e} [{card}]")
    return entry


def check_layer_norm_backward(dev, timer, card):
    from paddle_tpu_torch.ops.cuda_kernels import layer_norm_bwd as K
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(SEED + 4)
    R, K_ = 4096, 768
    x, dy = (torch.randn((R, K_), generator=g).to(dev) for _ in range(2))
    s = (1 + 0.1 * torch.randn((K_,), generator=g)).to(dev)
    b = (0.1 * torch.randn((K_,), generator=g)).to(dev)
    got = K.layer_norm_act_backward(x, s, b, dy, 1e-5, "identity")
    ref = K.layer_norm_act_backward_plain(x, s, b, dy, 1e-5, "identity")
    # dscale/dbias sum 4096 rows: an absolute floor of 1e-4 for that order
    err = max(_agree(f"layer_norm_act_backward {n}", o, r, atol=1e-4)
              for n, o, r in zip(("dx", "dscale", "dbias"), got, ref))
    _repeats("layer_norm_act_backward fp32", got,
             K.layer_norm_act_backward(x, s, b, dy, 1e-5, "identity"))
    ms = timer(lambda: K.layer_norm_act_backward(x, s, b, dy, 1e-5, "identity"))
    plain_ms = timer(lambda: K.layer_norm_act_backward_plain(
        x, s, b, dy, 1e-5, "identity"))
    lib_ms = timer(_autograd_lib(lambda x, s, b: F.layer_norm(
        x, (K_,), s, b, 1e-5), (x, s, b), dy))
    bound, by = _bound(0, (3 * R * K_ + 4 * K_) * 4)
    _row("K5 layer_norm_act_backward", f"R={R} K={K_} act=identity", ms,
         plain_ms, lib_ms, bound, by, err, card)
    return {"name": "layer_norm_act_backward", "route": "cuda",
            "source": "paddle_tpu_torch/ops/cuda_kernels/csrc/layer_norm_backward.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels/epilogue.py:373",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}


def _repeats(name, first, again):
    """A kernel without atomics (K1, K5, K9): a second launch on the same
    inputs gives the same bits, output for output (None for none)."""
    torch.cuda.synchronize()
    if not all(u is v or torch.equal(u, v) for u, v in zip(first, again)):
        raise RuntimeError(f"{name}: a second launch gave other bits")


# K7 past the main path's width: ResNet's head (V = 1000, one block a row),
# GPT-2's vocabulary (50257), Llama-3's (128256: a cluster of 4 (bf16) or
# 8 (fp32) blocks a row) and 262144 (8 blocks of 128 KB (fp32) or 64 KB);
# the widest staged rows (a cluster of 8 blocks of 224 KB, rows starting
# off the 16-byte grid) and the first widths that stream past them; and
# V = 1001 (rows at every element phase of 16 bytes) from every phase of
# the buffer's start
XENT_EDGE_V = (1000, 50257, 128256, 262144)
XENT_LAST_STAGED = {torch.float32: 458748, torch.bfloat16: 917496}
XENT_STREAMED = {torch.float32: 458749, torch.bfloat16: 917497}


def check_xent_edges(dev, card):
    from paddle_tpu_torch.ops.cuda_kernels import xent_bwd as K7

    g = torch.Generator(device="cpu").manual_seed(SEED + 12)
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        esz = torch.empty((), dtype=dt).element_size()
        cases = [(16, V, 0) for V in XENT_EDGE_V]
        cases += [(4, XENT_LAST_STAGED[dt], 1), (2, XENT_STREAMED[dt], 1)]
        cases += [(16, 1001, off) for off in range(16 // esz)]
        for N, V, off in cases:
            buf = (3 * torch.randn((N * V + off,), generator=g)).to(dev, dt)
            x = buf[off:].view(N, V)
            lab = torch.randint(-1, V + 1, (N,), generator=g,
                                dtype=torch.int32).to(dev)
            gl = torch.randn((N,), generator=g).to(dev)
            m = x.float().amax(-1)
            lse = torch.logsumexp(x.float() - m[:, None], -1)
            for stats in ((), (m, lse)):
                name = (f"softmax_xent_bwd {str(dt)[6:]} N={N} V={V} offset "
                        f"{off} {'saved' if stats else 'recomputed'} stats")
                got = K7.softmax_xent_bwd(x, lab, gl, *stats)
                ref = K7.softmax_xent_bwd_plain(x, lab, gl, *stats)
                err = _agree_xent(name, got, ref)
                _repeats(name, [got], [K7.softmax_xent_bwd(x, lab, gl, *stats)])
                worst[dt] = max(worst.get(dt, 0.0), err)
            del buf, x
    print(f"K7 softmax_xent_bwd edges (V {XENT_EDGE_V}, widest staged "
          f"{list(XENT_LAST_STAGED.values())}, streamed "
          f"{list(XENT_STREAMED.values())}, V=1001 at every phase; both modes, "
          f"labels outside [0, V), repeated bit for bit): max_abs_err fp32 "
          f"{worst[torch.float32]:.3e}, bf16 {worst[torch.bfloat16]:.3e} [{card}]")


# K3/K5 across their buckets (layer_norm_rows.cuh): both sides of K = 256
# and 1024, K = 2048 (a row over two or four warps), K = 100 (the scalar
# path); one row, R not a multiple of a block's rows, and R past what the
# resident warps hold at once (grid-stride turns, with their barriers past
# K = 1024); then a bf16 view at an odd storage offset (the scalar path)
LN_EDGE_K = (256, 257, 1024, 1025, 2048, 100)
LN_EDGE_R = ((1, "identity"), (37, "relu"), (3000, "identity"))


def check_layer_norm_edges(dev, card):
    from paddle_tpu_torch.ops.cuda_kernels import layer_norm as K3
    from paddle_tpu_torch.ops.cuda_kernels import layer_norm_bwd as K5

    g = torch.Generator(device="cpu").manual_seed(SEED + 5)
    n, worst = 0, 0.0

    def hold(what, x, s, b, dy, act, ref_x):
        bf = x.dtype == torch.bfloat16
        out = K3.layer_norm_act(x, s, b, 1e-5, act)
        ref = K3.layer_norm_act_plain(ref_x, s, b, 1e-5, act)
        errs = [(_agree16 if bf else _agree)(f"layer_norm_act {what} y",
                                              out[0], ref[0])]
        errs += [_agree(f"layer_norm_act {what} {p}", o, r)
                 for p, o, r in zip(("mean", "var"), out[1:], ref[1:])]
        got = K5.layer_norm_act_backward(x, s, b, dy, 1e-5, act)
        ref = K5.layer_norm_act_backward_plain(ref_x, s, b, dy, 1e-5, act)
        errs.append(_agree16(f"layer_norm_act_backward {what} dx", got[0],
                             ref[0]) if bf else
                    _agree(f"layer_norm_act_backward {what} dx", got[0],
                           ref[0], atol=1e-4))
        # dscale/dbias sum R rows in another order: an absolute floor 1e-4
        errs += [_agree(f"layer_norm_act_backward {what} {p}", o, r, atol=1e-4)
                 for p, o, r in zip(("dscale", "dbias"), got[1:], ref[1:])]
        return max(errs)

    for dt in (torch.float32, torch.bfloat16):
        for Kd in LN_EDGE_K:
            for R, act in LN_EDGE_R:
                x, dy = (torch.randn((R, Kd), generator=g).to(dev, dt)
                         for _ in range(2))
                s = (1 + 0.1 * torch.randn((Kd,), generator=g)).to(dev)
                b = (0.1 * torch.randn((Kd,), generator=g)).to(dev)
                worst = max(worst, hold(f"{dt} R={R} K={Kd} {act}", x, s, b,
                                        dy, act, x))
                n += 1
        R, Kd = 37, 768
        x, dy = (torch.randn((R, Kd), generator=g).to(dev, dt) for _ in range(2))
        xo = torch.empty(R * Kd + 1, dtype=dt, device=dev)[1:].view(R, Kd)
        xo.copy_(x)
        if not xo.data_ptr() % 16:
            raise RuntimeError("layer norm edges: the offset view is aligned")
        worst = max(worst, hold(f"{dt} R={R} K={Kd} unaligned view", xo,
                                torch.ones(Kd, device=dev),
                                torch.zeros(Kd, device=dev), dy, "identity", x))
        n += 1
    print(f"K3/K5 layer_norm_act edges: {n} cases agree (fp32 and bf16, K in "
          f"{LN_EDGE_K}, R and act in {LN_EDGE_R}, an unaligned bf16/fp32 "
          f"view), max_abs_err {worst:.3e} [{card}]")


def check_softmax_xent(dev, timer, card, N=4096, V=30522):
    """K6 and K7 at the BERT-base lm head (B=32, S=128), or at [N, V]."""
    from paddle_tpu_torch.ops.cuda_kernels import xent_bwd as KB
    from paddle_tpu_torch.ops.cuda_kernels import xent_fwd as KF
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(SEED + 5)
    x = (3 * torch.randn((N, V), generator=g)).to(dev)
    lab = torch.randint(0, V, (N,), generator=g, dtype=torch.int32).to(dev)
    gl = torch.randn((N,), generator=g).to(dev)
    lab64 = lab.long()

    fwd = KF.softmax_xent_fwd(x, lab)
    err = max(_agree(f"softmax_xent_fwd {n}", o, r) for n, o, r in zip(
        ("loss", "m", "lse"), fwd, KF.softmax_xent_fwd_plain(x, lab)))
    ms = timer(lambda: KF.softmax_xent_fwd(x, lab))
    plain_ms = timer(lambda: KF.softmax_xent_fwd_plain(x, lab))
    lib_ms = timer(lambda: F.cross_entropy(x, lab64, reduction="none"))
    bound, by = _bound(0, N * V * 4 + 4 * N * 4)
    _row("K6 softmax_xent_fwd", f"N={N} V={V}", ms, plain_ms, lib_ms, bound,
         by, err, card)
    k6 = {"name": "softmax_xent_fwd", "route": "cuda",
          "source": "paddle_tpu_torch/ops/cuda_kernels/csrc/softmax_xent_fwd.cu",
          "replaces": "paddle_tpu/ops/pallas_kernels/xent.py:221",
          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}

    lib_bwd = timer(_autograd_lib(lambda x: F.cross_entropy(
        x, lab64, reduction="none"), (x,), gl))
    k7 = None
    for mode, stats in (("recomputed stats (program path, #12)", ()),
                        ("saved stats (#11)", fwd[1:])):
        got = KB.softmax_xent_bwd(x, lab, gl, *stats)
        e = _agree_xent(f"softmax_xent_bwd {mode}", got,
                        KB.softmax_xent_bwd_plain(x, lab, gl, *stats))
        ms = timer(lambda: KB.softmax_xent_bwd(x, lab, gl, *stats))
        plain_ms = timer(lambda: KB.softmax_xent_bwd_plain(x, lab, gl, *stats))
        bound, by = _bound(0, 2 * N * V * 4 + (2 + len(stats)) * N * 4)
        _row("K7 softmax_xent_bwd", f"N={N} V={V} {mode}", ms, plain_ms,
             lib_bwd, bound, by, e, card)
        if k7 is None:
            k7 = {"name": "softmax_xent_bwd", "route": "cuda",
                  "source": "paddle_tpu_torch/ops/cuda_kernels/csrc/softmax_xent_bwd.cu",
                  "replaces": "paddle_tpu/ops/pallas_kernels/xent.py:228 "
                              "+ paddle_tpu/ops/pallas_kernels/xent.py:139",
                  "max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound, "bound_by": by, "library_ms": lib_bwd}
    return [k6, k7]


# ResNet-50's batch-norm applies at B=32 (NHWC main path: "cl"; the NCHW
# layout's "cr" at the first and last bottleneck widths), and a ragged one
BN_B = 32
BN_SHAPES = (  # (mode, R, row, C, act, residual, on the main path)
    ("cl", BN_B * 56 * 56, 256, 256, "identity", False, True),
    ("cl", BN_B * 112 * 112, 64, 64, "relu", False, True),
    ("cl", BN_B * 56 * 56, 256, 256, "relu", True, True),
    ("cl", BN_B * 7 * 7, 2048, 2048, "relu", True, True),
    ("cr", BN_B * 256, 3136, 256, "relu", True, False),
    ("cr", BN_B * 2048, 49, 2048, "relu", True, False),
    ("cl", 1009, 37, 37, "relu", True, False),
)


def _sums_agree(name, out, ref):
    """K9's per-channel sums: within 1e-4 of the sum's max-abs (hundreds of
    thousands of rows added in another order)."""
    torch.cuda.synchronize()
    err = float((out - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
    if out.shape != ref.shape or not err <= 1e-4:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version "
                           f"({err:.3e} of the max-abs)")
    return err


def _k9_reference(name, got, x, p, dy, act, res, mode, count=None):
    """K9's plain version's outputs with each relu decided as K9 decided it.
    K9 forms the pre-activation z = (x - mean) * (inv * scale) + bias in one
    fused multiply-add, the plain version as a product and a sum, each
    rounded: where the two put z on opposite sides of zero, dx moves by all
    of dy * inv * scale and the sums by that element's share. There, and
    only there, K9 may take either side: the side nearer to its dx (`got`)
    is the one held, and the plain version runs again with those decisions
    (identity act over dy masked by them), so every element and every sum
    is then held strictly. Returns (the reference outputs, the elements
    where the two roundings disagree, those where K9 took the fused one's
    side); prints z both ways where they disagree."""
    from paddle_tpu_torch.ops.cuda_kernels import bn_apply as K8
    from paddle_tpu_torch.ops.cuda_kernels import bn_apply_bwd as KB

    ref = KB.bn_apply_act_backward_plain(x, *p, dy, act, res, mode, count)
    if act != "relu":
        return ref, 0, 0
    sv, bv, mv, iv = (K8.param_view(t, x, mode) for t in p)
    xc = x.float() - mv
    g = iv * sv
    two = xc * g + bv
    # xc * g is exact in float64 and the sum's cancellation near zero too,
    # so this is the fused multiply-add's single rounding
    fused = (xc.double() * g.double() + bv.double()).float()
    if res is not None:
        two, fused = two + res.float(), fused + res.float()
    split = (two > 0) != (fused > 0)
    n_split = int(split.sum())
    if not n_split:
        return ref, 0, 0
    on_fused = KB.bn_apply_act_backward_plain(
        x, *p, dy * (fused > 0), "identity", res, mode, count)
    took = split & ((got[0].float() - on_fused[0].float()).abs()
                    < (got[0].float() - ref[0].float()).abs())
    n_fused = int(took.sum())
    decided = torch.where(took, fused > 0, two > 0)
    idx = split.nonzero()[:3].tolist()
    print(f"{name}: {n_split} relu decisions where the product-then-sum and "
          f"the fused multiply-add round z to opposite sides of 0, {n_fused} "
          f"taken on the fused side; " + "; ".join(
              f"z{tuple(i)} = {two[tuple(i)].item():.3e} two-step, "
              f"{fused[tuple(i)].item():.3e} fused" for i in idx))
    ref = KB.bn_apply_act_backward_plain(x, *p, dy * decided, "identity", res,
                                         mode, count)
    return ref, n_split, n_fused


def _bn_train_backward(x4, dy4, scale, mean, inv):
    """The yardstick of K9's chain mode: training batch norm's backward in
    one library call, with K9's own saved mean and inverse deviation (dx
    through the statistics, dscale, dbias)."""
    return lambda: torch.ops.aten.native_batch_norm_backward(
        dy4, x4, scale, None, None, mean, inv, True, 1e-5, [True, True, True])


def _ms(t):
    return "n/a" if t is None else f"{t:.4f}"


def _k9_phases(KB, args, ms):
    """Pass 1 (the sums), the fold and pass 2 (dx) of one chain-mode K9
    call, in ms: the kernel's own clock readings in block 0 (at its start,
    after the sums, after the fold, at its end) as shares of `ms`."""
    stamps = torch.zeros(4, dtype=torch.int64, device=args[0].device)
    KB.bn_apply_act_backward(*args, stamps=stamps)
    c = stamps.tolist()
    total = max(c[3] - c[0], 1)
    return [ms * (c[i + 1] - c[i]) / total for i in range(3)]


def _k9_bound(x, R, row, C, n_t, bound):
    """K9's chain mode's bound, from what the function itself must move:
    n_t R row elements of x's dtype (x and dy read, dx written, and the
    residual read and dres written with one), the four fp32 [C]
    parameters read and the [6, C] fp32 outputs written; the kernel's own
    partials are its scratch, not the function's."""
    return bound(8 * R * row, n_t * R * row * x.element_size() + 10 * C * 4)


def _bn_nchw(t, mode, R, row, C, B):
    """t [R, row] as the [N, C, H, W] tensor it is in `mode` ("cl": B images
    of square maps, channels-last in memory; "cr": R / C images of row
    pixels, H the square root of row where it is one)."""
    if mode == "cl":
        hw = int(round((R // B) ** 0.5))
        return t.reshape(B, hw, hw, C).permute(0, 3, 1, 2)
    h = int(round(row ** 0.5))
    h = h if h * h == row else 1
    return t.reshape(R // C, C, h, row // h)


def _bn_infer_lib(x4, mean, inv):
    """The one library call that computes K8's identity function without a
    residual: inference-mode F.batch_norm over the same statistics (var =
    1/inv^2 - eps), as a function of (x4, scale, bias)."""
    import torch.nn.functional as F

    var = 1.0 / (inv * inv) - 1e-5
    return lambda x4, s, b: F.batch_norm(x4, mean, var, s, b, training=False,
                                         eps=1e-5)


def _k9_split(KB, timer, card, name, args, one, M, err, lib_chain, bound,
              timed=True):
    """K9's split mode (a sync batch norm's backward) at one shape: the sums
    launch, then the chain from those sums with M (a world of one rank),
    must give the one launch's chain `one` (dx, dres, P1, P2, dscale,
    dbias) bit for bit; both launches timed, each beside its plain version
    and the library's training backward (`lib_chain`, both launches' work
    in one call), and bounded by what each must move: the sums read x and
    dy (and the residual), the chain reads them again and writes dx (and
    dres). Returns the two entries' numbers (err: the one launch's hold
    against the plain version at this shape), or None untimed."""
    x, p, dy, act, res, mode = args
    R, row = x.shape
    C = p[0].shape[0]
    sums = KB.bn_apply_act_backward_sums(x, *p, dy, act, res, mode)
    split = KB.bn_apply_act_backward_chain(x, *p, dy, sums[:2].contiguous(),
                                           M, act, res, mode)
    torch.cuda.synchronize()
    for what, a, b in zip(("dx", "dres", "P1", "P2", "dscale", "dbias"),
                          split, one):
        if (a is None) != (b is None) or (a is not None and
                                          not torch.equal(a, b)):
            raise RuntimeError(f"{name}: split mode's {what} differs from the "
                               f"one launch's")
    if not (torch.equal(sums[0], one[2]) and torch.equal(sums[1], one[3])):
        raise RuntimeError(f"{name}: the sums launch's P1, P2 differ from the "
                           f"one launch's")
    if not timed:
        print(f"K9 sync {name}: sums then chain bit for bit the one launch "
              f"[{card}]")
        return None
    part = sums[:2].contiguous()
    ms_sums = timer(lambda: KB.bn_apply_act_backward_sums(x, *p, dy, act, res,
                                                          mode))
    ms_chain = timer(lambda: KB.bn_apply_act_backward_chain(
        x, *p, dy, part, M, act, res, mode))
    plain_sums = timer(lambda: KB.bn_apply_act_backward_sums_plain(
        x, *p, dy, act, res, mode))
    plain_chain = timer(lambda: KB.bn_apply_act_backward_chain_plain(
        x, *p, dy, part, M, act, res, mode))
    n_in = 3 if res is not None else 2
    e = x.element_size()
    b_sums, by_sums = bound(6 * R * row, n_in * R * row * e + 10 * C * 4)
    b_chain, by_chain = bound(4 * R * row, (2 * n_in - 1) * R * row * e
                              + 8 * C * 4)
    _row("K9 sync sums", name, ms_sums, plain_sums, lib_chain, b_sums,
         by_sums, err, card)
    _row("K9 sync chain", name + " (dx, dres, dscale, dbias bit for bit the "
         "one launch's)", ms_chain, plain_chain, lib_chain, b_chain,
         by_chain, err, card)
    return [dict(ms=ms_sums, plain_ms=plain_sums, bound_ms=b_sums,
                 bound_by=by_sums),
            dict(ms=ms_chain, plain_ms=plain_chain, bound_ms=b_chain,
                 bound_by=by_chain)]


def check_bn_apply(dev, timer, card):
    from paddle_tpu_torch.ops.cuda_kernels import bn_apply as KF
    from paddle_tpu_torch.ops.cuda_kernels import bn_apply_bwd as KB

    g = torch.Generator(device="cpu").manual_seed(SEED + 6)
    src = "paddle_tpu_torch/ops/cuda_kernels/csrc/"
    k8 = k9 = None
    for mode, R, row, C, act, has_res, main_path in BN_SHAPES:
        x = (1.5 * torch.randn((R, row), generator=g) + 0.3).to(dev)
        dy = torch.randn((R, row), generator=g).to(dev)
        res = torch.randn((R, row), generator=g).to(dev) if has_res else None
        scale = (1 + 0.2 * torch.randn((C,), generator=g)).to(dev)
        bias = (0.2 * torch.randn((C,), generator=g)).to(dev)
        mean = (0.3 + 0.1 * torch.randn((C,), generator=g)).to(dev)
        inv = torch.rsqrt(2.25 + torch.rand((C,), generator=g)).to(dev)
        p = (scale, bias, mean, inv)
        shape = (f"{mode} [{R}, {row}] C={C} act={act} "
                 f"residual={'yes' if has_res else 'no'}")

        y = KF.bn_apply_act(x, *p, act, res, mode)
        err = _agree(f"bn_apply_act {shape}", y,
                     KF.bn_apply_act_plain(x, *p, act, res, mode))
        ms = timer(lambda: KF.bn_apply_act(x, *p, act, res, mode))
        plain_ms = timer(lambda: KF.bn_apply_act_plain(x, *p, act, res, mode))
        # one library call computes the unfused case only, in either
        # layout: inference batch norm over the same statistics; a residual
        # or an act would be further calls
        lib_ms = lib_bwd = lib_chain = None
        if act == "identity" and not has_res:
            x4 = _bn_nchw(x, mode, R, row, C, BN_B)
            dy4 = _bn_nchw(dy, mode, R, row, C, BN_B)
            lib = _bn_infer_lib(x4, mean, inv)
            lib_ms = timer(lambda: lib(x4, scale, bias))
            lib_bwd = timer(_autograd_lib(lib, (x4, scale, bias), dy4))
            lib_chain = timer(_bn_train_backward(x4, dy4, scale, mean, inv))
        n_t = 3 if has_res else 2
        bound, by = _bound(4 * R * row, (n_t * R * row + 4 * C) * 4)
        _row("K8 bn_apply_act", shape, ms, plain_ms, lib_ms, bound, by, err, card)
        if k8 is None:
            k8 = {"name": "bn_apply_act", "route": "cuda",
                  "source": src + "bn_apply.cu",
                  "replaces": "paddle_tpu/ops/pallas_kernels/epilogue.py:151",
                  "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}

        got = KB.bn_apply_act_backward(x, *p, dy, act, res, mode)
        ref = KB.bn_apply_act_backward_plain(x, *p, dy, act, res, mode)
        err = _agree(f"bn_apply_act_backward dx {shape}", got[0], ref[0])
        if has_res:
            err = max(err, _agree(f"bn_apply_act_backward dres {shape}",
                                  got[1], ref[1]))
        elif got[1] is not None:
            raise RuntimeError("bn_apply_act_backward: dres without a residual")
        sum_err = max(_sums_agree(f"bn_apply_act_backward {n} {shape}", o, r)
                      for n, o, r in zip(("P1", "P2", "dscale", "dbias"),
                                         got[2:], ref[2:]))
        one_ms = timer(lambda: KB.bn_apply_act_backward(x, *p, dy, act, res,
                                                        mode))

        # the main path's call: the chain mode (the sums, the fold and dx in
        # one launch, as the training step runs it)
        M = R * row // C
        got = KB.bn_apply_act_backward(x, *p, dy, act, res, mode, M)
        ref = KB.bn_apply_act_backward_plain(x, *p, dy, act, res, mode, M)
        err = max(err, _agree(f"bn_apply_act_backward chain dx {shape}",
                              got[0], ref[0]))
        _repeats(f"bn_apply_act_backward chain {shape}", got,
                 KB.bn_apply_act_backward(x, *p, dy, act, res, mode, M))
        sum_err = max([sum_err] + [
            _sums_agree(f"bn_apply_act_backward chain {n} {shape}", o, r)
            for n, o, r in zip(("dscale", "dbias"), got[4:], ref[4:])])
        ms = timer(lambda: KB.bn_apply_act_backward(x, *p, dy, act, res, mode,
                                                    M))
        plain_ms = timer(lambda: KB.bn_apply_act_backward_plain(
            x, *p, dy, act, res, mode, M))
        phases = _k9_phases(KB, (x, *p, dy, act, res, mode, M), ms)
        bound, by = _k9_bound(x, R, row, C, 5 if has_res else 3, _bound)
        if k9 is None:
            # the split mode at one fp32 row; its launches on the main path
            # are bf16 (dp_gloo2's ResNet-50 AMP arm), so it has no fp32
            # entry
            _k9_split(KB, timer, card, shape, (x, p, dy, act, res, mode),
                      got, M, err, lib_chain, _bound)
        _row("K9 bn_apply_act_backward", shape + f" with the statistics chain "
             f"(pass 1 / fold / pass 2 by the kernel's clock: "
             f"{' / '.join(f'{t:.4f}' for t in phases)} ms; one pass without "
             f"it: {one_ms:.4f} ms, against the inference batch norm's "
             f"backward: {_ms(lib_bwd)} ms; sums within {sum_err:.1e} of "
             f"their max-abs)", ms, plain_ms, lib_chain, bound, by, err, card)
        if k9 is None:
            k9 = {"name": "bn_apply_act_backward", "route": "cuda",
                  "source": src + "bn_apply_backward.cu",
                  "replaces": "paddle_tpu/ops/pallas_kernels/epilogue.py:182",
                  "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound, "bound_by": by, "library_ms": lib_chain}

        if main_path:
            # what the forward op does in torch beside the kernel at this
            # shape: the batch statistics (mean and E[x^2], with the square
            # materialized)
            stats_ms = timer(lambda: (x.mean(dim=0), (x * x).mean(dim=0)))
            print(f"   beside the kernels at {mode} [{R}, {row}]: forward "
                  f"batch statistics {stats_ms:.4f} ms [{card}]")
    return [k8, k9]


# the serving phases: DecoderConfig() as published (BERT-base width, 12
# layers, vocab 30522, max_position 512), page size 16 (the flag's default)
SERVE_CFG: dict = {}
SERVE_LENS, SERVE_NEW = (5, 17, 64, 130, 257, 400), 16
# the prefix-cache phase: a 256-token system prompt (16 pages) shared by 8
# requests with distinct suffixes, then resubmitted alone twice (full hits)
PREFIX_SYS, PREFIX_SUFFIX = 256, (5, 13, 21, 29, 37, 45, 53, 64)
SPEC_K = 4
# the bf16 serving gate: at each generated position the dense bf16
# oracle's logit for the engine's token must be within this many bf16
# units of the last place (at the oracle's max |logit| of that position)
# of the oracle's max; argmax near-ties make bit equality between two bf16
# paths meaningless
BF16_DELTA_ULPS = 16


def _serve_cfg(dtype="float32"):
    from paddle_tpu_torch.serving import DecoderConfig

    return DecoderConfig(**dict(SERVE_CFG, dtype=dtype))


def _serve_prompts(cfg, seed, lens, prefix=()):
    rng = np.random.default_rng(seed)
    return [list(prefix) + [int(t) for t in rng.integers(1, cfg.vocab_size, n)]
            for n in lens]


def _copy_weights(src, dst):
    with torch.no_grad():
        for n in src.parameter_names():
            dst._scope.find_var(n).copy_(src._scope.find_var(n))


def _dense_rows(eng, prompt, out):
    """The dense full-forward oracle on the engine's scope, teacher-forced
    over prompt + out: one causal pass gives, for each generated token, the
    logits [len(out), V] of the position that predicts it."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.framework import Program, program_guard
    from paddle_tpu_torch.serving import build_full_forward_program
    from paddle_tpu_torch.serving import model as sv_model

    if getattr(eng, "_oracle", None) is None:
        full = Program()
        with program_guard(full, Program()), unique_name.guard():
            eng._oracle = (full, build_full_forward_program(eng.cfg))
    full, io = eng._oracle
    seq = list(prompt) + list(out)[:-1]
    (lg,) = eng._exe.run(
        full, scope=eng._scope, fetch_list=[io["logits"]], return_numpy=False,
        feed={sv_model.TOK_FEED: np.asarray(seq, np.int32)[None, :],
              sv_model.POS_FEED: np.arange(len(seq), dtype=np.int32)[None, :]})
    if tuple(lg.shape) != (1, len(seq), eng.cfg.vocab_size) \
            or not bool(torch.isfinite(lg.float()).all()):
        raise RuntimeError("dense oracle logits malformed")
    return lg[0, len(prompt) - 1:].float()


def _hold_exact(what, eng, prompts, outs):
    """fp32: every generated token is the dense oracle's argmax over the
    engine's own prefix, which makes the sequence the oracle's greedy
    replay."""
    for i, (p, out) in enumerate(zip(prompts, outs)):
        want = _dense_rows(eng, p, out).argmax(dim=-1).tolist()
        if want != list(out):
            raise RuntimeError(f"{what}: request {i} (prompt {len(p)}) "
                               f"diverged from the dense oracle: {list(out)} "
                               f"vs {want}")


def _hold_delta(what, eng, prompts, outs):
    """bf16: at every generated position the oracle's logit for the
    engine's token is within BF16_DELTA_ULPS bf16 units (at the oracle's
    max |logit| there) of the oracle's max. Returns (positions, positions
    off the oracle's argmax, the largest gap in units)."""
    n = differ = 0
    worst = 0.0
    for i, (p, out) in enumerate(zip(prompts, outs)):
        rows = _dense_rows(eng, p, out)
        mx = rows.max(dim=-1).values
        got = rows.gather(1, torch.tensor(list(out), device=rows.device)
                          [:, None])[:, 0]
        units = (mx - got) / _ulp16(rows.abs().max(dim=-1).values)
        worst = max(worst, float(units.max()))
        if bool((units > BF16_DELTA_ULPS).any()):
            j = int((units > BF16_DELTA_ULPS).nonzero()[0])
            raise RuntimeError(
                f"{what}: request {i} (prompt {len(p)}) token {j} "
                f"({out[j]}) is {float(units[j]):.1f} bf16 units below the "
                f"dense oracle's max ({float(mx[j]):.4f}), past "
                f"{BF16_DELTA_ULPS}")
        n += len(out)
        differ += int((rows.argmax(dim=-1).cpu()
                       != torch.tensor(list(out))).sum())
    return n, differ, worst


def _launched(counts):
    """The wrappers of a launch_counts{,_by_dtype}() that launched."""
    return {k: v for k, v in counts.items() if v}


def _check_serving_launches(what, counts, want):
    """`want`: {wrapper: dtype}; each must have launched in `counts`
    (launch_counts_by_dtype of the run)."""
    missing = [f"{k} ({d})" for k, d in want.items()
               if not counts.get(k, {}).get(d)]
    if missing:
        raise RuntimeError(f"{what}: never launched {missing}: {counts}")


def _drive(eng, prompts, new=None):
    """Submit `prompts` together and drain; returns (rids, wall seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=new or SERVE_NEW) for p in prompts]
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for rid in rids:
        if eng.requests[rid].state != "finished":
            raise RuntimeError(f"request {rid} ended {eng.requests[rid].state}")
    return rids, wall


def _report(what, eng, rids, wall, card):
    ttft = [eng.requests[r].t_first_token - eng.requests[r].arrival_t
            for r in rids]
    n_tok = sum(len(eng.result(r)) for r in rids)
    lens = [eng.requests[r].prompt_len for r in rids]
    print(f"{what}: {len(rids)} requests (prompts {lens}, "
          f"{len(eng.result(rids[0]))} new tokens each) in {wall:.3f} s: "
          f"{n_tok / wall:.1f} tokens/s, p50 TTFT "
          f"{statistics.median(ttft) * 1e3:.1f} ms [{card}]")
    return n_tok / wall, statistics.median(ttft)


def _no_leaks(what, eng, flush=True):
    if eng.leaked_pages():
        raise RuntimeError(f"{what}: {eng.leaked_pages()} leaked pages")
    if flush:
        eng.flush_prefix_cache()
        if eng.leaked_pages() or eng.pool.free_count != eng.pool.num_pages:
            raise RuntimeError(
                f"{what}: after the prefix-cache flush {eng.leaked_pages()} "
                f"leaked, {eng.pool.num_pages - eng.pool.free_count} pages "
                f"still in use")


def serve(dev, card):
    """The engine's default (prefix cache on, no speculation) at BERT-base
    width: 6 requests of 5..400 prompt tokens, the greedy tokens held
    against the dense oracle, zero leaked pages, K1-K3 launched."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import ServingEngine

    cfg = _serve_cfg()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    names = eng.parameter_names()
    n_elems = sum(eng._scope.find_var(n).numel() for n in names)
    print(f"engine built in {time.perf_counter() - t0:.2f} s ({len(names)} "
          f"parameters, {n_elems} elements; ops a run: prefill "
          f"{len(eng._prefill_prog.global_block.ops)}, decode "
          f"{len(eng._decode_prog.global_block.ops)}, window "
          f"{len(eng._window_prog.global_block.ops)}; pool "
          f"{eng.pool_pages}x{eng.page_size}; prefix cache "
          f"{'on' if eng.prefix_cache else 'off'}, draft_k {eng.draft_k}) "
          f"[{card}]")
    # one short request first: CUDA context, cuBLAS handles, allocator
    eng.submit([1, 2, 3, 4, 5, 6, 7, 8], max_new_tokens=2)
    eng.run_until_drained()

    prompts = _serve_prompts(cfg, SEED, SERVE_LENS)
    steps0 = eng.stats["decode_steps"]
    ck.reset_launch_counts()
    rids, wall = _drive(eng, prompts)
    counts = ck.launch_counts()
    _check_serving_launches("serving", ck.launch_counts_by_dtype(),
                            {k: "float32" for k in SERVE_KERNELS})
    _no_leaks("serving", eng, flush=False)
    eng.first_pass = _report("served (first pass, every bucket's GEMM "
                             "shapes new)", eng, rids, wall, card)
    print(f"  {eng.stats['decode_steps'] - steps0} decode steps, prefill buckets "
          f"{sorted(eng.stats['prefill_signatures'], key=str)}, launches "
          f"{_launched(counts)}")
    again, wall = _drive(eng, prompts)
    _report("served (second pass, same requests: prefix-cache hits)", eng,
            again, wall, card)
    outs = [eng.result(r) for r in rids]
    if [eng.result(r) for r in again] != outs:
        raise RuntimeError("the second pass (prefix-cache hits) gave other "
                           "tokens than the first")
    _hold_exact("serving", eng, prompts, outs)
    print("greedy tokens equal the dense full-forward oracle for every request")
    _no_leaks("serving", eng)
    return eng, prompts, outs, counts


def serve_prefix(dev, card, profile=False):
    """The prefix cache in fp32: 8 requests sharing a PREFIX_SYS-token
    system prompt (the cold pass: the first prefills it, the others map its
    pages and prefill their suffixes through the window program), then the
    system prompt alone twice (the warm pass: full hits, whose first decode
    step copies the last shared page). Held against the dense oracle, a
    prefix_cache=False engine on the same weights (tokens bit for bit) and
    the engine's own accounting."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import ServingEngine

    cfg = _serve_cfg()
    eng = ServingEngine(cfg, device=dev, seed=SEED, prefix_cache=True)
    sysp = _serve_prompts(cfg, SEED + 1, (PREFIX_SYS,))[0]
    prompts = _serve_prompts(cfg, SEED + 2, PREFIX_SUFFIX, prefix=sysp)
    ck.reset_launch_counts()
    cold, cold_wall = _drive(eng, prompts)
    warm, warm_wall = _drive(eng, [sysp, sysp])
    counts = ck.launch_counts_by_dtype()
    _check_serving_launches("prefix cache", counts,
                            {k: "float32" for k in SERVE_KERNELS})
    _report(f"prefix cache, cold pass (one system prompt prefilled, "
            f"{len(cold) - 1} suffixes through the window program)", eng,
            cold, cold_wall, card)
    _report("prefix cache, warm pass (the system prompt alone twice: full "
            "hits)", eng, warm, warm_wall, card)
    st = eng.stats
    all_prompts = prompts + [sysp, sysp]
    outs = [eng.result(r) for r in cold + warm]
    total = sum(len(p) for p in all_prompts)
    print(f"  prefix_hit_tokens {st['prefix_hit_tokens']} of {total} prompt "
          f"tokens, prefill_tokens_computed {st['prefill_tokens_computed']}, "
          f"lookups {st['prefix_lookups']}, full hits "
          f"{st['prefix_full_hits']}, cow_copies {st['cow_copies']}, "
          f"preemptions {st['preemptions']}, launches {_launched(counts)}")
    if not (st["prefix_hit_tokens"] > 0 and st["prefix_full_hits"] >= 1
            and st["cow_copies"] >= 1):
        raise RuntimeError(f"prefix cache: no hit, full hit or copy-on-write "
                           f"({st})")
    if st["preemptions"] or st["prefill_tokens_computed"] != \
            total - st["prefix_hit_tokens"]:
        raise RuntimeError(
            f"prefix cache: {st['prefill_tokens_computed']} prefill tokens "
            f"computed, not the {total} prompt tokens less the "
            f"{st['prefix_hit_tokens']} hit ({st['preemptions']} "
            f"preemptions)")
    _no_leaks("prefix cache", eng, flush=False)
    _hold_exact("prefix cache", eng, all_prompts, outs)
    if profile:
        _profile(lambda: _drive(eng, all_prompts), card,
                 f"prefix-cache serving pass (the {len(all_prompts)} "
                 f"requests again: every prompt a hit)",
                 ("K1", ("paged_decode",)))
    plain = ServingEngine(cfg, device=dev, seed=SEED, prefix_cache=False)
    _copy_weights(eng, plain)
    got, _ = _drive(plain, prompts)
    got2, _ = _drive(plain, [sysp, sysp])
    if [plain.result(r) for r in got + got2] != outs:
        raise RuntimeError("prefix cache: tokens differ from the "
                           "prefix_cache=False engine's")
    _no_leaks("prefix cache", eng)
    print("prefix cache: greedy tokens equal the dense oracle and the "
          "prefix_cache=False engine's for every request; no page leaked "
          "before or after the flush")
    return counts


def serve_spec(dev, card, base, prompts, want, profile=False):
    """Speculative decoding in fp32 (draft_k = SPEC_K) on `base`'s weights,
    the 6 serving requests twice: (a) with the engine's own `ngram_draft`,
    (b) with the known greedy continuation as the draft (every draft must be
    accepted: the multi-token acceptance path). Tokens bit for bit `base`'s
    (draft_k = 0)."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving import engine as sv_engine

    eng = ServingEngine(base.cfg, device=dev, seed=SEED, draft_k=SPEC_K)
    _copy_weights(base, eng)
    ck.reset_launch_counts()
    rids, wall = _drive(eng, prompts)
    counts = ck.launch_counts_by_dtype()
    _check_serving_launches("speculative decoding", counts,
                            {"causal_prefill_attention": "float32",
                             "layer_norm_act": "float32"})
    st = dict(eng.stats)
    _report(f"speculative decoding (draft_k {SPEC_K}, ngram_draft)", eng,
            rids, wall, card)
    if [eng.result(r) for r in rids] != want:
        raise RuntimeError("speculative decoding: tokens differ from the "
                           "draft_k=0 engine's")
    if not st["spec_steps"]:
        raise RuntimeError("speculative decoding: no speculative step")
    print(f"  {st['spec_steps']} speculative steps, acceptance "
          f"{st['spec_accepted']}/{st['spec_proposed']} = "
          f"{st['spec_accepted'] / max(1, st['spec_proposed']):.4f} "
          f"(reported, not gated), launches {_launched(counts)}")

    known = [list(p) + list(w) for p, w in zip(prompts, want)]

    def oracle_draft(tokens, k, window=128):
        tokens = [int(t) for t in tokens]
        for seq in known:
            if seq[:len(tokens)] == tokens:
                cont = seq[len(tokens):len(tokens) + k]
                return cont + [tokens[-1]] * (k - len(cont))
        raise RuntimeError("oracle draft: an unknown sequence")

    own = sv_engine.ngram_draft
    sv_engine.ngram_draft = oracle_draft
    try:
        rids, wall = _drive(eng, prompts)
    finally:
        sv_engine.ngram_draft = own
    prop = eng.stats["spec_proposed"] - st["spec_proposed"]
    acc = eng.stats["spec_accepted"] - st["spec_accepted"]
    steps = eng.stats["spec_steps"] - st["spec_steps"]
    _report(f"speculative decoding (draft_k {SPEC_K}, the known greedy "
            f"continuation as the draft)", eng, rids, wall, card)
    if [eng.result(r) for r in rids] != want:
        raise RuntimeError("speculative decoding with oracle drafts: tokens "
                           "differ from the draft_k=0 engine's")
    if not prop or acc != prop:
        raise RuntimeError(f"speculative decoding with oracle drafts: "
                           f"{acc} of {prop} drafts accepted")
    print(f"  oracle drafts: {acc}/{prop} accepted in {steps} speculative "
          f"steps ({sum(len(w) for w in want)} tokens)")
    if profile:
        _profile(lambda: _drive(eng, prompts), card, f"speculative serving "
                 f"pass (draft_k {SPEC_K}, ngram_draft, prompts hit the "
                 f"prefix cache)")
    _no_leaks("speculative decoding", eng)
    return counts


def serve_bf16(dev, card, profile=False):
    """bf16 serving, DecoderConfig(dtype="bfloat16"): the requests of the
    prefix-cache phase and the 6 serving requests, on a prefix-cache engine
    with plain decode (K1 bf16) and one with draft_k = SPEC_K on the same
    weights, each held to the dense bf16 oracle teacher-forced within
    BF16_DELTA_ULPS, with zero leaked pages."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import ServingEngine

    cfg = _serve_cfg("bfloat16")
    sysp = _serve_prompts(cfg, SEED + 1, (PREFIX_SYS,))[0]
    shared = _serve_prompts(cfg, SEED + 2, PREFIX_SUFFIX, prefix=sysp)
    plain = _serve_prompts(cfg, SEED, SERVE_LENS)
    print(f"bf16 serving gate: the dense bf16 oracle's logit for each "
          f"generated token within {BF16_DELTA_ULPS} bf16 units of its max")
    base = None
    counts = {}
    for k in (0, SPEC_K):
        eng = ServingEngine(cfg, device=dev, seed=SEED, prefix_cache=True,
                            draft_k=k)
        if base is None:
            base = eng
        else:
            _copy_weights(base, eng)
        ck.reset_launch_counts()
        rids, wall = _drive(eng, shared)
        rids2, _ = _drive(eng, [sysp, sysp])
        rids3, wall3 = _drive(eng, plain)
        run = ck.launch_counts_by_dtype()
        want = {"causal_prefill_attention": "bfloat16",
                "layer_norm_act": "bfloat16"}
        if not k:
            want["paged_decode_attention"] = "bfloat16"
        _check_serving_launches(f"bf16 serving (draft_k {k})", run, want)
        for name, by in run.items():
            for d, c in by.items():
                counts.setdefault(name, {})[d] = \
                    counts.get(name, {}).get(d, 0) + c
        st = eng.stats
        if not (st["prefix_full_hits"] >= 1 and st["cow_copies"] >= 1
                and (not k or st["spec_steps"])):
            raise RuntimeError(f"bf16 serving (draft_k {k}): no full hit, "
                               f"copy-on-write or speculative step ({st})")
        _report(f"bf16 serving (draft_k {k}), shared-prefix requests", eng,
                rids, wall, card)
        _report(f"bf16 serving (draft_k {k}), the 6 serving requests", eng,
                rids3, wall3, card)
        _no_leaks(f"bf16 serving (draft_k {k})", eng, flush=False)
        n, differ, worst = _hold_delta(
            f"bf16 serving (draft_k {k})", eng, shared + [sysp, sysp] + plain,
            [eng.result(r) for r in rids + rids2 + rids3])
        print(f"  draft_k {k}: {n} generated positions within "
              f"{BF16_DELTA_ULPS} bf16 units of the dense oracle's max (the "
              f"largest gap {worst:.2f} units); {differ} off the oracle's "
              f"argmax; prefix hits {st['prefix_hit_tokens']} tokens, "
              f"{st['prefix_full_hits']} full, cow_copies "
              f"{st['cow_copies']}, speculative steps {st['spec_steps']} "
              f"(accepted {st['spec_accepted']}/{st['spec_proposed']}); "
              f"launches {_launched(run)}")
        if profile and not k:
            _profile(lambda: _drive(eng, plain), card, "bf16 serving pass "
                     "(the 6 serving requests again: prefix-cache hits)",
                     ("K1 bf16", ("paged_decode",)))
        _no_leaks(f"bf16 serving (draft_k {k})", eng)
    return counts


# the bf16 gate's planted faults (tests/test_torch_smoke_oracle.py plants
# the same two in the plain versions on the CPU): K1 reading each row's page
# table one page on, and copy-on-write leaving the new page zero
SERVE_FAULTS = ("k1_shifted_table", "cow_without_copy")
# peaked attention, as that test scales decoder_tiny's: the q/k/v
# projections times 4 and the attention output projection times 2
QKV_SCALE, OUT_SCALE = 4.0, 2.0


@contextlib.contextmanager
def _planted(fault):
    """`fault` planted on the card's path: the K1 wrapper called with the
    page table rolled by one ordinal, or the copy-on-write's page copy
    replaced by zeroing the new page."""
    from paddle_tpu_torch.ops import attention_ops as ao

    if fault == "k1_shifted_table":
        name, real = "paged_decode_attention", ao.paged_decode_attention

        def faulty(q, k_pool, v_pool, page_table, *args, **kw):
            return real(q, k_pool, v_pool, page_table.roll(-1, dims=1),
                        *args, **kw)
    else:
        name, real = "kv_cache_copy_page_", ao.kv_cache_copy_page_

        def faulty(k_pool, v_pool, src, dst):
            for pool in (k_pool, v_pool):
                pool[dst.long().reshape(-1)[:1]] = 0
            return k_pool, v_pool
    setattr(ao, name, faulty)
    try:
        yield
    finally:
        setattr(ao, name, real)


def _peak_attention(eng):
    with torch.no_grad():
        for n in eng.parameter_names():
            if n.endswith(".mha.qkv.w"):
                eng._scope.find_var(n).mul_(QKV_SCALE)
            elif n.endswith(".mha.out.w"):
                eng._scope.find_var(n).mul_(OUT_SCALE)


def _bf16_gate_run(dev, fault, peaked):
    """serve_bf16's requests on a prefix-cache engine with plain decode,
    `fault` planted (or none), the attention peaked or not; returns the
    gate's verdict: None if it passed, else its message."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import ServingEngine

    cfg = _serve_cfg("bfloat16")
    sysp = _serve_prompts(cfg, SEED + 1, (PREFIX_SYS,))[0]
    prompts = (_serve_prompts(cfg, SEED + 2, PREFIX_SUFFIX, prefix=sysp)
               + [sysp, sysp] + _serve_prompts(cfg, SEED, SERVE_LENS))
    eng = ServingEngine(cfg, device=dev, seed=SEED, prefix_cache=True,
                        draft_k=0)
    if peaked:
        _peak_attention(eng)
    ck.reset_launch_counts()
    with contextlib.ExitStack() as stack:
        if fault:
            stack.enter_context(_planted(fault))
        rids, _ = _drive(eng, prompts[:len(PREFIX_SUFFIX)])
        rids2, _ = _drive(eng, prompts[len(PREFIX_SUFFIX):])
    _check_serving_launches(f"bf16 gate run ({fault})",
                            ck.launch_counts_by_dtype(),
                            {"paged_decode_attention": "bfloat16"})
    if not eng.stats["cow_copies"]:
        raise RuntimeError(f"bf16 gate run ({fault}): no copy-on-write")
    try:
        _hold_delta(f"bf16 serving with {fault}", eng, prompts,
                    [eng.result(r) for r in rids + rids2])
    except RuntimeError as e:
        return str(e)
    return None


def serve_bf16_faults(dev, card):
    """The bf16 serving gate at BERT-base width must refuse each of
    SERVE_FAULTS, BF16_DELTA_ULPS unchanged: first at the random weights as
    they are; a fault that passes there is planted again with the attention
    peaked (QKV_SCALE, OUT_SCALE), where the gate must refuse it and pass
    the unfaulted engine. Fails if a fault passes both."""
    width = f"hidden width {_serve_cfg().hidden_size}"
    peaked_needed = False
    for fault in SERVE_FAULTS:
        for peaked in (False, True):
            verdict = _bf16_gate_run(dev, fault, peaked)
            how = "peaked attention" if peaked else "the random weights"
            if verdict is not None:
                print(f"bf16 serving gate refused {fault} at {width} with "
                      f"{how}: {verdict[:160]} [{card}]")
                peaked_needed |= peaked
                break
            print(f"bf16 serving gate passed {fault} at {width} with {how} "
                  f"[{card}]")
        else:
            raise RuntimeError(f"the bf16 serving gate passed {fault} with "
                               f"the random and the peaked weights")
    if peaked_needed:
        verdict = _bf16_gate_run(dev, None, True)
        if verdict is not None:
            raise RuntimeError(f"the bf16 gate refused the unfaulted engine "
                               f"with peaked attention: {verdict}")
        print(f"bf16 serving gate passed the unfaulted engine with peaked "
              f"attention [{card}]")


# the rest of serving (resilience, EngineConfig and its controller, the
# fleet, disaggregation), every phase at DecoderConfig() on `serve`'s
# weights, held to the dense oracle on its own scope and to `serve`'s
# fault-free tokens
FLEET_HEARTBEAT_S = 1.0    # inline pump: a step of two replicas is ~0.1 s
FLEET_POOL_PAGES = 128     # a pass of SERVE_LENS maps at most 64 pages
# the resilience engine's pool: room for a pass of SERVE_LENS, small enough
# that the ladder drill's 2% occupancy floor (2 pages) trips as soon as two
# requests run
RESIL_POOL_PAGES = 96
DISAGG_TTL_S = 1.0
# the control phase ticks its controller after every engine step on a clock
# that advances one epoch a step (an epoch a step, whatever the step's wall
# time): the regime's arrival rate is then the requests of a step over one
# epoch
CONTROL_EPOCH_S = 0.05
# the control phase's store: ARM_WIDE serves 2x the goodput of ARM_NARROW at
# every regime (the rows seeded, not measured), so a trained model proposes
# it wherever its gate lets a proposal stand
ARM_WIDE = {"mi": 8, "dk": 0, "pc": 0, "sp": 0, "sq": 16, "so": 95,
            "da": 2, "pd": 0}
ARM_NARROW = {"mi": 2, "dk": 0, "pc": 0, "sp": 1, "sq": 4, "so": 90,
              "da": 4, "pd": 0}
# eight regimes whose span covers what a pass of SERVE_LENS spells (rates,
# prompt percentiles 8..1024, budgets 4..64, any occupancy and queue)
CONTROL_REGIMES = [
    dict(rate=1, p50=8, p95=16, out=4, hit=0.0, occ=0.0, q=0, hr=1.0),
    dict(rate=4, p50=16, p95=64, out=8, hit=0.2, occ=0.1, q=1, hr=1.0),
    dict(rate=16, p50=32, p95=128, out=16, hit=0.4, occ=0.2, q=2, hr=0.5),
    dict(rate=64, p50=64, p95=256, out=32, hit=0.6, occ=0.4, q=4, hr=1.0),
    dict(rate=256, p50=128, p95=512, out=64, hit=0.8, occ=0.6, q=8,
         hr=0.0),
    dict(rate=1024, p50=256, p95=1024, out=4, hit=0.9, occ=0.8, q=16,
         hr=0.5),
    dict(rate=4096, p50=512, p95=1024, out=16, hit=0.5, occ=0.9, q=32,
         hr=1.0),
    dict(rate=16384, p50=1024, p95=1024, out=64, hit=0.0, occ=1.0, q=64,
         hr=1.0),
]


def _hold_replay(what, eng, prompts, got, want, partial=()):
    """A drill's tokens: each request's equal the fault-free run's (`want`)
    and are the dense oracle's greedy replay on `eng`'s scope; requests in
    `partial` (ended early: expired, quarantined) hold a prefix of both.
    Where a request misses either, prints the first position off and the
    oracle's top-2 gap there, then fails."""
    for i, (p, out) in enumerate(zip(prompts, got)):
        out = list(out)
        ref = list(want[i])[:len(out)] if i in partial else list(want[i])
        if not out and i in partial:
            continue
        rows = _dense_rows(eng, p, out)
        oracle = rows.argmax(dim=-1).tolist()
        if out == ref and out == oracle:
            continue
        j = next((k for k in range(min(len(out), len(ref)))
                  if out[k] != ref[k] or out[k] != oracle[k]),
                 min(len(out), len(ref)))
        j = min(j, len(out) - 1)
        top = rows[j].topk(2).values
        print(f"{what}: request {i} (prompt {len(p)}) position {j}: token "
              f"{out[j]}, fault-free {ref[j] if j < len(ref) else None}, "
              f"oracle {oracle[j]}; the oracle's top-2 gap there "
              f"{float(top[0] - top[1]):.3e}")
        raise RuntimeError(f"{what}: request {i} differs from the "
                           f"{'fault-free run' if out != ref else 'oracle'}")


def _clean_engine(what, eng):
    """No leaked page and a clean audit; an idle engine without a prefix
    cache holds no page."""
    problems, _ = eng.audit_pool()
    if eng.leaked_pages() or problems:
        raise RuntimeError(f"{what}: {eng.leaked_pages()} leaked pages, "
                           f"audit {problems[:4]}")
    held = getattr(eng.pool, "owned_pages_in_use", eng.pool.pages_in_use)
    if eng.prefix_cache is None and held and not eng.has_work():
        raise RuntimeError(f"{what}: {held} pages still held")


def _run_drill(eng, prompts, plan=None, **submit_kw):
    """Submit `prompts` together and drain, under `plan` when given;
    returns (rids, outputs, states, wall seconds, faults fired)."""
    from paddle_tpu_torch.resilience.faults import fault_scope

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=SERVE_NEW, **submit_kw)
            for p in prompts]
    fired = []
    if plan is None:
        eng.run_until_drained()
    else:
        with fault_scope(plan) as fp:
            eng.run_until_drained()
            fired = fp.stats()["fired"]
        if not fired:
            raise RuntimeError(f"fault plan {plan} never fired")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (rids, [eng.result(r) for r in rids],
            [eng.requests[r].state for r in rids], wall, fired)


def _counted(eng, *keys):
    return {k: eng.stats[k] for k in keys}


def _delta(eng, before):
    return {k: eng.stats[k] - v for k, v in before.items()}


def serve_resilience(dev, card, base, prompts, want):
    """The engine's resilience at BERT-base width on `base`'s weights, one
    engine (RESIL_POOL_PAGES pages, prefix cache off, the audit every step,
    3 attempts a dispatch),
    each drill over `prompts`: a transient `serving_step_fail` absorbed by
    the retry; retry exhaustion into a recovery pass; the 3
    `serving_pool_corrupt` kinds caught by the audit (kind 2 quarantines
    the poisoned request); a `serving_deadline` expiry mid-decode keeping
    its partial tokens; shedding by priority and an AdmissionRejected with
    a retry-after (max_inflight 1 and a queue floor of 2 staged through
    propose_config); the ladder to rung 4 and back under an occupancy
    floor. Tokens held to `want` and the dense oracle, no leaked page and a
    clean audit after each drill, K1-K3 launched."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import AdmissionRejected, ServingEngine

    t_phase = time.perf_counter()
    eng = ServingEngine(base.cfg, device=dev, seed=SEED, prefix_cache=False,
                        pool_pages=RESIL_POOL_PAGES, audit_every=1,
                        step_retries=3)
    _copy_weights(base, eng)
    passes = []
    recover = eng._recover

    def timed_recover(*args, **kw):
        t0 = time.perf_counter()
        recover(*args, **kw)
        passes.append((t0, time.perf_counter() - t0))

    eng._recover = timed_recover
    ck.reset_launch_counts()
    rids, outs, _, wall, _ = _run_drill(eng, prompts)
    _hold_replay("resilience, fault-free pass", eng, prompts, outs, want)
    _clean_engine("resilience, fault-free pass", eng)
    rate, ttft = _report("resilience engine, fault-free pass (prefix cache "
                         "off, audit every step)", eng, rids, wall, card)
    print(f"  beside the plain serve phase's first pass: "
          f"{base.first_pass[0]:.1f} tokens/s, p50 TTFT "
          f"{base.first_pass[1] * 1e3:.1f} ms [{card}]")

    keys = ("step_retries", "recovery.passes", "recovery.replayed",
            "recovery.quarantined", "deadline_exceeded")
    st = _counted(eng, *keys)
    _, outs, states, _, fired = _run_drill(eng, prompts,
                                           "serving_step_fail:3")
    d = _delta(eng, st)
    _hold_replay("transient step fault", eng, prompts, outs, want)
    if d["step_retries"] != 1 or d["recovery.passes"]:
        raise RuntimeError(f"transient step fault: {d}")
    _clean_engine("transient step fault", eng)
    print(f"serving_step_fail once (fired {fired}): absorbed by 1 retry, no "
          f"recovery, tokens the fault-free run's [{card}]")

    st = _counted(eng, *keys)
    rids, outs, states, _, fired = _run_drill(eng, prompts,
                                              "serving_step_fail:5,6,7")
    d = _delta(eng, st)
    _hold_replay("retry exhaustion", eng, prompts, outs, want)
    if d["recovery.passes"] != 1 or not d["recovery.replayed"]:
        raise RuntimeError(f"retry exhaustion: {d}")
    _clean_engine("retry exhaustion", eng)
    t_rec, rec_s = passes[-1]
    last = max(eng.requests[r].t_done for r in rids)
    print(f"serving_step_fail x3 (fired {fired}): retries exhausted, a "
          f"recovery pass of {rec_s:.4f} s replayed {d['recovery.replayed']}"
          f" requests from their prompts; {last - t_rec:.3f} s from the "
          f"failure to the last replayed token; tokens the fault-free run's "
          f"[{card}]")

    for hit, kind in ((3, "a phantom refcount holder"),
                      (4, "a live page on the free list"),
                      (2, "a duplicate ordinal in the newest table")):
        st = _counted(eng, *keys)
        rids, outs, states, _, fired = _run_drill(
            eng, prompts, f"serving_pool_corrupt:{hit}")
        d = _delta(eng, st)
        poisoned = [i for i, s in enumerate(states) if s == "aborted"]
        if d["recovery.passes"] != 1 \
                or len(poisoned) != d["recovery.quarantined"] \
                or (hit % 3 == 2) != bool(poisoned) \
                or any(s not in ("finished", "aborted") for s in states):
            raise RuntimeError(f"pool corruption kind {hit % 3}: {d}, "
                               f"states {states}")
        _hold_replay(f"pool corruption kind {hit % 3}", eng, prompts, outs,
                     want, partial=poisoned)
        _clean_engine(f"pool corruption kind {hit % 3}", eng)
        print(f"serving_pool_corrupt kind {hit % 3} ({kind}): caught by the "
              f"audit, recovery pass {passes[-1][1]:.4f} s, "
              f"{d['recovery.replayed']} replayed, quarantined "
              f"{poisoned} [{card}]")

    st = _counted(eng, *keys)
    rids, outs, states, _, fired = _run_drill(eng, prompts,
                                              "serving_deadline:3")
    expired = [i for i, s in enumerate(states) if s == "deadline_exceeded"]
    if len(expired) != 1 or not outs[expired[0]] \
            or len(outs[expired[0]]) >= SERVE_NEW:
        raise RuntimeError(f"deadline: states {states}, outputs {outs}")
    _hold_replay("deadline", eng, prompts, outs, want, partial=expired)
    _clean_engine("deadline", eng)
    print(f"serving_deadline at step 3: request {expired[0]} expired "
          f"mid-decode with {len(outs[expired[0]])} of {SERVE_NEW} tokens "
          f"kept, every page returned [{card}]")

    mi = eng.max_inflight
    eng.propose_config({"mi": 1, "sq": 2}, source="chip_smoke")
    a = eng.submit(prompts[0], SERVE_NEW, priority=0)
    b = eng.submit(prompts[1], SERVE_NEW, priority=0)
    try:
        eng.submit(prompts[2], SERVE_NEW, priority=0)
        raise RuntimeError("shedding: a third same-class submit was queued")
    except AdmissionRejected as e:
        rejected = e
    hi = eng.submit(prompts[3], SERVE_NEW, priority=5)
    eng.run_until_drained()
    if (eng.requests[b].state != "shed" or rejected.retry_after_s <= 0
            or "queue_depth" not in rejected.signals):
        raise RuntimeError(f"shedding: b {eng.requests[b].state}, "
                           f"rejection {rejected!r}")
    _hold_replay("shedding", eng, [prompts[0], prompts[3]],
                 [eng.result(a), eng.result(hi)], [want[0], want[3]])
    _clean_engine("shedding", eng)
    print(f"shedding: a same-class submit refused ({rejected}); a priority-5 "
          f"submit shed the youngest priority-0 waiter; the others' tokens "
          f"the fault-free run's [{card}]")

    eng.propose_config({"mi": 2, "sq": 0, "so": 2, "da": 1},
                       source="chip_smoke")
    rungs = {k: eng.stats[k] for k in eng.stats if k.startswith("ladder.")}
    rids, outs, states, _, _ = _run_drill(eng, prompts)
    climbed = {k: eng.stats[k] - v for k, v in rungs.items()}
    shed = [i for i, s in enumerate(states) if s == "shed"]
    if not all(climbed.values()) or not shed \
            or set(states) != {"finished", "shed"}:
        raise RuntimeError(f"ladder: climbs {climbed}, states {states}")
    top = eng._ladder_rung
    calm = 0
    while eng._ladder_rung and calm < 16:
        eng.step()
        calm += 1
    if eng._ladder_rung:
        raise RuntimeError("ladder: never descended")
    _hold_replay("ladder", eng, prompts, outs, want, partial=shed)
    _clean_engine("ladder", eng)
    print(f"ladder under an occupancy floor of 2%: climbs {climbed}, rung "
          f"{top} at the drain, requests {shed} shed; back to rung 0 after "
          f"{calm} calm steps [{card}]")
    eng.propose_config({"mi": mi, "so": 0, "da": 4}, source="chip_smoke")
    eng.maybe_adopt_config()

    counts = ck.launch_counts_by_dtype()
    _check_serving_launches("serve_resilience", counts,
                            {k: "float32" for k in SERVE_KERNELS})
    print(f"serve_resilience: {time.perf_counter() - t_phase:.1f} s, "
          f"launches {_launched(counts)} [{card}]")
    return counts


def _seed_control_model(card):
    """The control phase's model: the store of CONTROL_REGIMES x (ARM_WIDE,
    ARM_NARROW) written through `record_row` and trained as the tuner's
    cost model is; returns its path."""
    import os

    from paddle_tpu_torch import flags
    from paddle_tpu_torch.serving import control as sv_control
    from paddle_tpu_torch.tuning import learned

    d = _smoke_dir("control")
    store = os.path.join(d, "control.jsonl")
    path = os.path.join(d, "control.model.json")
    flags.set_flags({"tuning_record": "on"})
    for sig in CONTROL_REGIMES:
        for arm, mult in ((ARM_WIDE, 2.0), (ARM_NARROW, 1.0)):
            if not sv_control.record_row(sig, arm, mult * (10 + sig["rate"]),
                                         source="sweep", tool=True,
                                         path=store):
                raise RuntimeError("control store: a row did not land")
    model = learned.train_model(list(learned.iter_records(store)), seed=0)
    learned.save_model(model, path)
    group = model["groups"].get(f"{sv_control.CONTROL_OP}|"
                                f"{sv_control.policy.device_kind()}")
    if not group or group["holdout"]["rank_acc"] < 0.6:
        raise RuntimeError(f"control model: no confident group ({group})")
    return path


def serve_control(dev, card, base, prompts, want):
    """EngineConfig and the learned controller at BERT-base width: an
    engine (max_inflight 4, prefix cache off) warms every decode signature
    up to the longest request, then serves `prompts` under a Controller
    ticked after every step (an epoch a step) with a model trained on a
    seeded store.
    Shadow mode: proposals made, none staged, the config unchanged. Apply
    mode: the proposal (ARM_WIDE: max_inflight 8) is staged while work is
    in flight and adopted only at the idle boundary, warmup_decode runs
    again (the batch geometry moved), and the pass after it runs no decode
    signature the warmup did not and loads no kernel library. Tokens held
    to `want` and the dense oracle."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.ops.cuda_kernels import _build
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.control import controller as sv_controller

    t_phase = time.perf_counter()
    saved = {k: flags.get_flag(k) for k in (
        "serve_control_mode", "serve_control_model", "tuning_record")}
    try:
        model = _seed_control_model(card)
        flags.set_flags({"tuning_record": "off",
                         "serve_control_model": model,
                         "serve_control_mode": "shadow"})
        eng = ServingEngine(base.cfg, device=dev, seed=SEED,
                            prefix_cache=False, max_inflight=4)
        _copy_weights(base, eng)
        ctx = max(len(p) for p in prompts) + SERVE_NEW
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_sig = eng.warmup_decode(ctx)
        torch.cuda.synchronize()
        print(f"warmup_decode({ctx}): {n_sig} decode signatures in "
              f"{time.perf_counter() - t0:.3f} s [{card}]")
        ck.reset_launch_counts()
        cfg0 = eng.engine_config
        # the engine's own hook off: the phase's controller ticks instead
        eng._ctrl = sv_controller.Controller(epoch_s=0)
        ctrl = sv_controller.Controller(epoch_s=CONTROL_EPOCH_S)
        clock = [0.0]

        def controlled(prompts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rids = [eng.submit(p, max_new_tokens=SERVE_NEW) for p in prompts]
            while eng.has_work():
                eng.step()
                clock[0] += CONTROL_EPOCH_S
                ctrl.tick(eng, now=clock[0])
            torch.cuda.synchronize()
            return (rids, [eng.result(r) for r in rids],
                    time.perf_counter() - t0)

        rids, outs, wall = controlled(prompts)
        info = ctrl.last_info.get(id(eng), {})
        if info.get("tier") != "learned" or eng._pending_ecfg is not None \
                or eng.engine_config != cfg0 \
                or eng.stats["control.applies"]:
            raise RuntimeError(f"shadow mode: proposal {info}, pending "
                               f"{eng._pending_ecfg}")
        _hold_replay("control, shadow", eng, prompts, outs, want)
        _report("controller in shadow mode (proposes, never applies)", eng,
                rids, wall, card)
        print(f"  shadow proposal {info.get('arm')} at regime "
              f"{info.get('regime')}, not staged [{card}]")

        flags.set_flags({"serve_control_mode": "apply"})
        busy_stages, idle_adopts = [], []
        propose, adopt = eng.propose_config, eng.maybe_adopt_config

        def watched_propose(knobs, source="controller"):
            staged = propose(knobs, source)
            busy_stages.append(staged and eng.has_work())
            return staged

        def watched_adopt():
            busy = eng.has_work()
            adopted = adopt()
            if adopted:
                idle_adopts.append(not busy)
            return adopted

        eng.propose_config, eng.maybe_adopt_config = (watched_propose,
                                                      watched_adopt)
        rids, outs, _ = controlled(prompts)
        _hold_replay("control, apply (before adoption)", eng, prompts, outs,
                     want)
        if not any(busy_stages) or idle_adopts:
            raise RuntimeError(f"apply mode: staged while busy "
                               f"{busy_stages}, adopted {idle_adopts}")
        libs = len(_build._libs)
        flags.set_flags({"serve_control_mode": "shadow"})
        rids, outs, wall = controlled(prompts)
        if idle_adopts != [True] or eng.max_inflight != ARM_WIDE["mi"] \
                or eng.stats["control.rewarmups"] != 1:
            raise RuntimeError(f"apply mode: adoptions {idle_adopts}, "
                               f"max_inflight {eng.max_inflight}, rewarmups "
                               f"{eng.stats['control.rewarmups']}")
        cold = eng.stats["cold_decode_signatures"]
        if cold or len(_build._libs) != libs:
            raise RuntimeError(f"after the re-warmup: cold decode signatures "
                               f"{sorted(cold)}, libraries {libs} -> "
                               f"{len(_build._libs)}")
        _hold_replay("control, apply (adopted)", eng, prompts, outs, want)
        _report(f"controller in apply mode, ARM_WIDE adopted at the idle "
                f"boundary (max_inflight {eng.max_inflight})", eng, rids,
                wall, card)
        print(f"  staged while busy, adopted idle, warmup run again; "
              f"decode signatures {sorted(eng.stats['decode_signatures'])}, "
              f"none cold [{card}]")
    finally:
        flags.set_flags(saved)
    counts = ck.launch_counts_by_dtype()
    _check_serving_launches("serve_control", counts,
                            {k: "float32" for k in SERVE_KERNELS})
    _clean_engine("serve_control", eng)
    print(f"serve_control: {time.perf_counter() - t_phase:.1f} s, launches "
          f"{_launched(counts)} [{card}]")
    return counts


def _replica_factory(base, dev, **kw):
    """Engines on `base`'s weights for a FleetRouter (the router passes a
    role to the factories of role-split fleets only)."""
    from paddle_tpu_torch.serving import ServingEngine

    def make():
        eng = ServingEngine(base.cfg, device=dev, seed=SEED,
                            pool_pages=FLEET_POOL_PAGES, **kw)
        _copy_weights(base, eng)
        return eng
    return make


def _watch_deaths(fr, log):
    """Record (rid, reason, time of the replica's last heartbeat, time the
    router found the death), on the perf_counter clock, for every death the
    router handles."""
    on_dead = fr._on_dead

    def watched(rep, reason):
        now, mono = time.perf_counter(), time.monotonic()
        age = fr.monitor.age(rep.name, now=mono) \
            if rep.name in fr.monitor._last else 0.0
        log.append((rep.rid, reason, now - age, now))
        on_dead(rep, reason)

    fr._on_dead = watched


def _fleet_pass(what, fr, eng_for_oracle, prompts, want, plan=None):
    """Submit `prompts` to the router and run it idle (under `plan`); every
    request must finish with `want`'s tokens and the oracle's."""
    from paddle_tpu_torch.resilience.faults import fault_scope

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fids = [fr.submit(p, SERVE_NEW) for p in prompts]
    if plan is None:
        fr.run_until_idle()
    else:
        with fault_scope(plan) as fp:
            fr.run_until_idle()
            if not fp.stats()["fired"]:
                raise RuntimeError(f"{what}: {plan} never fired")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    states = [fr.state(f) for f in fids]
    if set(states) != {"finished"}:
        raise RuntimeError(f"{what}: states {states}")
    _hold_replay(what, eng_for_oracle, prompts, [fr.result(f) for f in fids],
                 want)
    if fr.stats["replay_divergence"]:
        raise RuntimeError(f"{what}: replay divergence")
    return fids, wall


def _fleet_report(what, fr, fids, wall, card):
    reqs = [fr.requests[f] for f in fids]
    n_tok = sum(len(q.delivered) for q in reqs)
    ttft = statistics.median(q.t_first - q.t_submit for q in reqs)
    print(f"{what}: {len(reqs)} requests in {wall:.3f} s: "
          f"{n_tok / wall:.1f} tokens/s, p50 TTFT {ttft * 1e3:.1f} ms "
          f"[{card}]")


def _fleet_clean(what, fr):
    for rep in fr.replicas:
        if rep.alive or rep.state == "retired":
            _clean_engine(f"{what}, replica {rep.rid}", rep.engine)


def _last_replay(fr, fids):
    """The time the last request that failed over finished (perf_counter)."""
    moved = [fr.requests[f].t_done for f in fids
             if fr.requests[f].failovers]
    return max(moved) if moved else None


def serve_fleet(dev, card, base, prompts, want):
    """FleetRouter over engine replicas at BERT-base width on `base`'s
    weights (each its own pool of FLEET_POOL_PAGES pages): inline, over 2
    replicas, a fault-free pass and its resubmission (affinity: the same
    homes), a `fleet_replica_kill` mid-stream, a `fleet_replica_hang` found
    by the heartbeat, drain-and-retire with nothing shed or failed, and the
    failover budget (1) exhausted by a second death, which fails exactly
    its request; a dead or retired replica is replaced by `add_replica`.
    Then pump="threads" over 2 fresh replicas: a pass, an administrative
    kill, a request served by the survivor. Every finished request's tokens
    are `want`'s and the dense oracle's; no replica leaks a page; K1-K3
    launched."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import FleetRouter

    t_phase = time.perf_counter()
    ck.reset_launch_counts()
    deaths = []
    fr = FleetRouter(_replica_factory(base, dev), 2,
                     heartbeat_s=FLEET_HEARTBEAT_S, failover_budget=1)
    _watch_deaths(fr, deaths)
    try:
        fids, wall = _fleet_pass("fleet, fault-free", fr, base, prompts,
                                 want)
        _fleet_report("fleet of 2 replicas, inline pump, fault-free", fr,
                      fids, wall, card)
        homes = [fr.requests[f].replica for f in fids]
        fids, _ = _fleet_pass("fleet, resubmitted", fr, base, prompts, want)
        if [fr.requests[f].replica for f in fids] != homes:
            raise RuntimeError("fleet: resubmitted prompts changed homes")
        print(f"  affinity: homes {homes} again on resubmission "
              f"({fr.stats['affinity_hits']} hits) [{card}]")

        for plan, what in (("fleet_replica_kill:6", "kill"),
                           ("fleet_replica_hang:6", "hang")):
            n, st = len(deaths), dict(fr.stats)
            fids, wall = _fleet_pass(f"fleet, {what}", fr, base, prompts,
                                     want, plan)
            if len(deaths) != n + 1:
                raise RuntimeError(f"fleet {what}: deaths {deaths[n:]}")
            rid, reason, beat, found = deaths[-1]
            last = _last_replay(fr, fids)
            print(f"fleet_replica_{what} on replica {rid}: found by "
                  f"{reason} {found - beat:.3f} s after its last beat; "
                  f"{fr.stats['failovers'] - st['failovers']} failovers, "
                  f"{fr.stats['dedup_tokens'] - st['dedup_tokens']} tokens "
                  f"deduplicated; "
                  f"{(last - beat) if last else 0:.3f} s from the last beat "
                  f"to the last replayed token; pass {wall:.3f} s [{card}]")
            _fleet_clean(f"fleet {what}", fr)
            fr.add_replica()

        fids = [fr.submit(p, SERVE_NEW) for p in prompts]
        for _ in range(2):
            fr.step()
        drained = next(r.rid for r in fr.replicas if r.alive)
        fr.drain(drained)
        fr.run_until_idle()
        if (fr.replicas[drained].state != "retired" or fr.stats["sheds"]
                or fr.stats["failed"] or fr.stats["retires"] != 1):
            raise RuntimeError(f"drain: {fr.replicas[drained].state}, "
                               f"{fr.stats}")
        _hold_replay("fleet, drain", base, prompts,
                     [fr.result(f) for f in fids], want)
        _fleet_clean("fleet drain", fr)
        print(f"drain: replica {drained} retired, {fr.stats['handoffs']} "
              f"waiting requests handed off, 0 shed, 0 failed [{card}]")

        fr.add_replica()
        fr.add_replica()
        fid = fr.submit(prompts[-1], SERVE_NEW)
        fr.step()
        first = fr.requests[fid].replica
        fr.kill(first)
        fr.step()
        second = fr.requests[fid].replica
        fr.kill(second)
        other = fr.submit(prompts[0], SERVE_NEW)
        fr.run_until_idle()
        failed = [f for f, q in fr.requests.items() if q.state == "failed"]
        if failed != [fid] or fr.state(other) != "finished":
            raise RuntimeError(f"failover budget: failed {failed}, the "
                               f"other request {fr.state(other)}")
        _hold_replay("fleet, budget", base, [prompts[0]],
                     [fr.result(other)], [want[0]])
        _fleet_clean("fleet budget", fr)
        print(f"failover budget 1: request {fid} failed after its replicas "
              f"{first} and {second} died; request {other} finished "
              f"[{card}]")
    finally:
        fr.shutdown()
    del fr

    fr = FleetRouter(_replica_factory(base, dev), 2, heartbeat_s=30.0,
                     affinity=False, pump="threads")
    try:
        t0 = time.perf_counter()
        fids = [fr.submit(p, SERVE_NEW) for p in prompts]
        _poll_until(fr, fids)
        wall = time.perf_counter() - t0
        _hold_replay("fleet, threads", base, prompts,
                     [fr.result(f) for f in fids], want)
        _fleet_report("fleet of 2 replicas, pump=\"threads\"", fr, fids, wall,
                      card)
        fr.kill(0)
        fid = fr.submit(prompts[2], SERVE_NEW)
        _poll_until(fr, [fid])
        if fr.requests[fid].replica != 1:
            raise RuntimeError("threads: the request left the survivor")
        _hold_replay("fleet, threads after a kill", base, [prompts[2]],
                     [fr.result(fid)], [want[2]])
    finally:
        fr.shutdown()
    for rep in fr.replicas:
        if rep._thread is not None and rep._thread.is_alive():
            raise RuntimeError(f"threads: replica {rep.rid}'s worker lives on")
    _fleet_clean("fleet threads", fr)
    counts = ck.launch_counts_by_dtype()
    _check_serving_launches("serve_fleet", counts,
                            {k: "float32" for k in SERVE_KERNELS})
    print(f"serve_fleet: {time.perf_counter() - t_phase:.1f} s, launches "
          f"{_launched(counts)} [{card}]")
    return counts


def _poll_until(fr, fids, limit_s=120.0):
    deadline = time.monotonic() + limit_s
    while any(fr.state(f) not in ("finished", "failed") for f in fids):
        if time.monotonic() > deadline:
            raise RuntimeError(f"threads: requests {fids} unfinished after "
                               f"{limit_s} s")
        fr.poll()
        time.sleep(0.002)
    torch.cuda.synchronize()


def _disagg_clean(what, fr):
    """The shared pool audits clean, no lease is left, every lease was
    reclaimed exactly once (granted = committed + reaped), and no live
    replica leaks a page."""
    hm = fr.handoff
    problems = hm.pool.check_consistency(None)
    g, c, r = (hm.stats[k] for k in ("granted", "committed", "reaped"))
    if problems or hm.active() or hm.pool.leased_page_count or g != c + r:
        raise RuntimeError(f"{what}: audit {problems[:4]}, active "
                           f"{hm.active()}, leases {hm.stats}")
    for rep in fr.replicas:
        if rep.alive:
            _clean_engine(f"{what}, replica {rep.rid}", rep.engine)


def serve_disagg(dev, card, base, prompts, want):
    """Disaggregated prefill/decode at BERT-base width: disagg_fleet_factory
    (one shared pool of 512 pages, one shared scope), 1 prefill and 1
    decode replica, inline. The shared scope's weights are `base`'s bit for
    bit (each engine's startup ran on it again with the same seed). Drills:
    the happy path's commits; `disagg_handoff_drop` (the lease reaped at its
    TTL, the prompt replayed); a standby prefill replica added while the
    decode replica holds live KV (no pool made again, no token moved), then
    `disagg_prefill_kill` before commit; a standby decode replica, then a
    kill of the decode replica holding adopted pages (its pins forfeited).
    Gates: tokens `want`'s and the dense oracle's, the shared pool's audit
    clean, every lease reclaimed exactly once, K1-K3 launched."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import FleetRouter, disagg_fleet_factory
    from paddle_tpu_torch.serving.kv_cache import pool_var_names

    t_phase = time.perf_counter()
    ck.reset_launch_counts()
    fac = disagg_fleet_factory(base.cfg, device=dev, seed=SEED)
    fr = FleetRouter(fac, 2, roles=["prefill", "decode"],
                     heartbeat_s=FLEET_HEARTBEAT_S, affinity=False,
                     lease_ttl_s=DISAGG_TTL_S)
    deaths, commits = [], []
    _watch_deaths(fr, deaths)
    commit = fr.handoff.commit

    def timed_commit(lid):
        lease = commit(lid)
        commits.append(time.perf_counter() - lease.t_prepare)
        return lease

    fr.handoff.commit = timed_commit
    scope = fac.shared_scope
    differ = [n for n in base.parameter_names()
              if not torch.equal(scope.find_var(n), base._scope.find_var(n))]
    if differ:
        raise RuntimeError(f"disagg: the shared scope's weights differ from "
                           f"the seed-{SEED} engine's: {differ[:4]}")
    oracle = fr.replicas[0].engine
    pools = {n: scope.find_var(n) for kv in pool_var_names(base.cfg.num_layers)
             for n in kv}
    try:
        fids, wall = _fleet_pass("disagg, happy path", fr, oracle, prompts,
                                 want)
        _disagg_clean("disagg, happy path", fr)
        _fleet_report("disaggregated, 1 prefill + 1 decode replica", fr,
                      fids, wall, card)
        print(f"  {fr.handoff.stats['committed']} handoffs committed, "
              f"prepare -> commit median "
              f"{statistics.median(commits) * 1e3:.2f} ms, max "
              f"{max(commits) * 1e3:.2f} ms; weights bit for bit the "
              f"seed-{SEED} engine's [{card}]")

        st = dict(fr.handoff.stats)
        fids, wall = _fleet_pass("disagg, dropped handoff", fr, oracle,
                                 prompts, want, "disagg_handoff_drop:1")
        if not fr.stats["handoff.dropped"] \
                or fr.handoff.stats["reaped"] == st["reaped"] \
                or not fr.stats["handoff.replays"]:
            raise RuntimeError(f"dropped handoff: {fr.stats}, "
                               f"{fr.handoff.stats}")
        _disagg_clean("disagg, dropped handoff", fr)
        print(f"disagg_handoff_drop: the lease reaped at its {DISAGG_TTL_S}"
              f" s TTL and the prompt replayed; pass {wall:.3f} s [{card}]")

        fids = [fr.submit(p, SERVE_NEW) for p in prompts]
        dec = fr.replicas[1].engine
        while not dec.stats["adopts"] or not dec._running:
            fr.step()
        live = {n: t.clone() for n, t in pools.items()}
        fr.add_replica("prefill")
        moved = [n for n, t in pools.items()
                 if scope.find_var(n) is not t
                 or not torch.equal(scope.find_var(n), live[n])]
        if moved:
            raise RuntimeError(f"disagg: adding a replica touched the live "
                               f"pools {moved[:4]}")
        fr.run_until_idle()
        _hold_replay("disagg, a replica added mid-pass", oracle, prompts,
                     [fr.result(f) for f in fids], want)
        _disagg_clean("disagg, replica added", fr)

        n = len(deaths)
        fids, wall = _fleet_pass("disagg, prefill kill", fr, oracle, prompts,
                                 want, "disagg_prefill_kill:2")
        if len(deaths) != n + 1 or fr.replicas[deaths[-1][0]].role \
                != "prefill":
            raise RuntimeError(f"prefill kill: deaths {deaths[n:]}")
        _disagg_clean("disagg, prefill kill", fr)
        rid, _, beat, found = deaths[-1]
        last = _last_replay(fr, fids)
        print(f"disagg_prefill_kill before commit on replica {rid} (a "
              f"standby prefill replica added while the decode replica held "
              f"live KV): found {found - beat:.3f} s after its last beat; "
              f"{(last - beat) if last else 0:.3f} s from the last beat to "
              f"the last replayed token [{card}]")

        fr.add_replica("decode")
        dedup = fr.stats["dedup_tokens"]
        fids = [fr.submit(p, SERVE_NEW) for p in prompts]
        victim = None
        while victim is None:
            fr.step()
            victim = next((r for r in fr.replicas
                           if r.alive and r.role == "decode"
                           and r.engine.stats["adopts"] and r.engine._running),
                          None)
        held = victim.engine.pool.owned_pages_in_use
        t_kill = time.perf_counter()
        fr.kill(victim.rid)
        if victim.engine.pool.owned_pages_in_use:
            raise RuntimeError("decode kill: the dead replica's pins were "
                               "not forfeited")
        fr.run_until_idle()
        if any(fr.state(f) != "finished" for f in fids):
            raise RuntimeError("decode kill: a request did not finish")
        _hold_replay("disagg, decode kill", oracle, prompts,
                     [fr.result(f) for f in fids], want)
        _disagg_clean("disagg, decode kill", fr)
        last = _last_replay(fr, fids)
        print(f"decode replica {victim.rid} killed holding {held} adopted "
              f"pages: forfeited, {fr.stats['dedup_tokens'] - dedup} tokens "
              f"deduplicated, "
              f"{(last - t_kill) if last else 0:.3f} s from the kill to the "
              f"last replayed token [{card}]")
    finally:
        fr.shutdown()
    counts = ck.launch_counts_by_dtype()
    _check_serving_launches("serve_disagg", counts,
                            {k: "float32" for k in SERVE_KERNELS})
    print(f"serve_disagg: {time.perf_counter() - t_phase:.1f} s, leases "
          f"{fr.handoff.stats}, launches {_launched(counts)} [{card}]")
    return counts


# bench.py:107 BERT_BASE: the published BERT-base widths, dropout off
BERT_BASE = dict(vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, ffn_size=3072, max_position=512,
                 dropout=0.0, use_tp=False)
TRAIN_B, TRAIN_S, TRAIN_LR, TRAIN_STEPS = 32, 128, 1e-4, 5
# tools/_sweep.py's long-context run (`_sweep.py 8 2048 1`: BERT-base,
# max_position = S, use_flash_attention, decorate(Adam(1e-4))), and the fp32
# step at the fp32 phase's 4096 tokens that drives K10/K11 in fp32
LONG_B, LONG_S = 8, 2048
LONG_FP32_B, LONG_FP32_S = 4, 1024


def _bert_cfg(S, flash=False):
    """BERT-base's widths for seq S: max_position max(512, S) as
    tools/_sweep.py sets it, and the flash flag."""
    from paddle_tpu_torch.models import transformer

    return transformer.TransformerConfig(
        **dict(BERT_BASE, max_position=max(512, S), use_flash_attention=flash))


def _train_launches(S, L):
    """Per-step launches of each wrapper in an fp32 BERT step of L layers:
    one attention forward and backward a layer (K2 and K4, or K10 and K11
    past S = 512), layer norm after the embeddings and twice a layer, one
    cross entropy over the lm head."""
    from paddle_tpu_torch.ops import cuda_kernels as ck

    want = dict.fromkeys(ck.launch_counts(), 0)
    fwd, bwd = (("flash_attention_fwd", "flash_attention_backward") if S > 512
                else ("causal_prefill_attention", "attention_backward"))
    want.update({fwd: L, bwd: L, "layer_norm_act": 2 * L + 1,
                 "layer_norm_act_backward": 2 * L + 1, "softmax_xent_fwd": 1,
                 "softmax_xent_bwd": 1})
    return want


GRAD_RTOL = 1e-3   # of each gradient's max-abs: fp32 sums reordered, 12 layers


def _bert_feed(cfg, B, S):
    """One seeded batch in __graft_entry__._example_feed's form."""
    rng = np.random.default_rng(SEED)
    return {"src_ids": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "pos_ids": np.tile(np.arange(S, dtype=np.int32), (B, 1)),
            "lm_label": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "lm_weight": np.ones((B, S), np.float32)}


def _bert_step_flops(cfg, B, S):
    """bench.py:130-133: 6 N T over the matmul parameters plus attention."""
    H, L, F_, V = cfg.hidden_size, cfg.num_layers, cfg.ffn_size, cfg.vocab_size
    tokens = B * S
    return (6 * (L * (4 * H * H + 2 * H * F_) + H * V) * tokens
            + 12 * L * H * S * tokens)


def _checkpointed(attention, q, k, v):
    """attention(q, k, v) under torch.utils.checkpoint: its backward
    recomputes the [B, nh, S, S] scores, so that one layer's live at a time
    (at S = 2048, B = 8 one fp32 score tensor is 1.6 GB); the arithmetic is
    attention's own."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(attention, q, k, v, use_reentrant=False)


def _bert_oracle(P, feed, cfg, ln_names):
    """The BERT pretrain loss in plain torch (F.linear, the plain
    attention, F.layer_norm, log_softmax) over the parameter tensors P,
    each layer's attention checkpointed."""
    import torch.nn.functional as F

    H, nh = cfg.hidden_size, cfg.num_heads
    dh = H // nh
    lns = iter(ln_names)

    def fc(x, pre):
        return F.linear(x, P[pre + ".w"].t(), P[pre + ".b"])

    def ln(x):
        sn, bn = next(lns)
        return F.layer_norm(x, (H,), P[sn], P[bn], 1e-5)

    ids, pos = feed["src_ids"].long(), feed["pos_ids"].long()
    x = ln(P["encoder.word_emb"][ids] + P["encoder.pos_emb"][pos])
    B, S = ids.shape
    for i in range(cfg.num_layers):
        pre = f"encoder.layer{i}"
        qkv = fc(x, pre + ".mha.qkv").reshape(B, S, 3, nh, dh)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        a = _checkpointed(lambda q, k, v: torch.softmax(
            q @ k.transpose(-1, -2) * dh ** -0.5, dim=-1) @ v, q, k, v)
        x = ln(x + fc(a.transpose(1, 2).reshape(B, S, H), pre + ".mha.out"))
        f = fc(F.gelu(fc(x, pre + ".ffn.in")), pre + ".ffn.out")
        x = ln(x + f)
    logp = torch.log_softmax(fc(x, "lm_head"), dim=-1)
    tok = -logp.gather(-1, feed["lm_label"].long()[..., None])[..., 0]
    w = feed["lm_weight"]
    return (tok * w).sum() / (w.sum() + 1e-6)


def _hold_step1(what, scope, names, p0, grads, ref_grads, lr):
    """An fp32 step 1 of Adam(lr) against its oracle: every gradient within
    GRAD_RTOL of the oracle's max-abs, and the updated parameters by the
    JAX package's Adam formula (first step, moments from zero). The first
    step moves a weight by about lr whatever its gradient, so both limits
    are a hundredth of a step: the port's update against the formula on its
    own gradients (every element), and against the formula on the oracle's
    (elements whose sign the gradient check makes sure of, above the
    epsilon's reach). Returns (worst gradient error, the two update errors,
    the elements of sure sign)."""
    lr_t = lr * (1 - 0.999) ** 0.5 / (1 - 0.9)

    def adam_step1(g):
        return lr_t * (0.1 * g / (torch.sqrt(0.001 * g * g) + 1e-8))

    worst = own_err = ref_err = 0.0
    n_sure = 0
    for n, rg in zip(names, ref_grads):
        scale = float(rg.abs().max())
        e = float((grads[n] - rg).abs().max()) / max(scale, 1e-30)
        if not e <= GRAD_RTOL:
            raise RuntimeError(f"{what}: {n}@GRAD differs from the oracle by "
                               f"{e:.3e} of its max-abs {scale:.3e}")
        worst = max(worst, e)
        p1 = scope.find_var(n)
        own_err = max(own_err, float((p1 - (p0[n] - adam_step1(grads[n])))
                                     .abs().max()))
        sure = rg.abs() > max(2 * GRAD_RTOL * scale, 1e-5)
        n_sure += int(sure.sum())
        if bool(sure.any()):
            d = (p1 - (p0[n] - adam_step1(rg)))[sure]
            ref_err = max(ref_err, float(d.abs().max()))
    if not max(own_err, ref_err) <= 1e-2 * lr:
        raise RuntimeError(f"{what}: step-1 parameters differ from the JAX "
                           f"Adam step by {own_err:.3e} on the port's "
                           f"gradients and {ref_err:.3e} on the oracle's "
                           f"(limit 1e-2 lr)")
    return worst, own_err, ref_err, n_sure


def train(dev, card, B=TRAIN_B, S=TRAIN_S, flash=False):
    """The BERT-base pretrain step through the port's entry points: step 1
    held against the plain-torch autograd oracle (loss, every gradient, the
    updated parameters by the JAX package's Adam formula), launches per
    step counted, then TRAIN_STEPS timed steps on the same batch. `flash`
    sets use_flash_attention (the JAX package's long-context flag)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import cuda_kernels as ck

    cfg = _bert_cfg(S, flash)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        avg_loss, _ = transformer.bert_pretrain(cfg, seq_len=S)
        pt.optimizer.Adam(learning_rate=TRAIN_LR).minimize(avg_loss)
    startup.random_seed = SEED
    exe, scope = pt.Executor(), pt.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    names = [p.name for p in main.all_parameters()]
    n_elems = sum(scope.find_var(n).numel() for n in names)
    print(f"trainer built in {time.perf_counter() - t0:.2f} s: BERT-base "
          f"B={B} S={S} fp32 (use_flash_attention={flash}), {len(names)} "
          f"parameters, {n_elems} elements, {len(main.global_block.ops)} ops "
          f"a step [{card}]")
    feed = _bert_feed(cfg, B, S)
    p0 = {n: scope.find_var(n).clone() for n in names}

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                  fetch_list=[avg_loss] + [n + "@GRAD" for n in names])
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = ck.launch_counts()
    if counts != _train_launches(S, cfg.num_layers):
        raise RuntimeError(f"launches in one step {counts}, expected "
                           f"{_train_launches(S, cfg.num_layers)}")
    loss1, grads = out[0], dict(zip(names, out[1:]))

    ln_names = [(op.inputs["Scale"][0], op.inputs["Bias"][0])
                for op in main.global_block.ops if op.type == "layer_norm"]
    P = {n: t.clone().requires_grad_() for n, t in p0.items()}
    fd = {k: torch.from_numpy(v).to(dev) for k, v in feed.items()}
    ref_loss = _bert_oracle(P, fd, cfg, ln_names)
    ref_grads = torch.autograd.grad(ref_loss, [P[n] for n in names])
    ref_loss = ref_loss.detach()
    if not abs(float(loss1) - float(ref_loss)) <= 1e-4 * abs(float(ref_loss)):
        raise RuntimeError(f"step-1 loss {float(loss1)} vs oracle "
                           f"{float(ref_loss)}")
    worst, own_err, ref_err, n_sure = _hold_step1(
        "BERT-base", scope, names, p0, grads, ref_grads, TRAIN_LR)
    print(f"step 1 ({first:.3f} s, first use of every GEMM shape): loss "
          f"{float(loss1):.6f}, oracle {float(ref_loss):.6f}; worst gradient "
          f"error {worst:.3e} of its max-abs (limit {GRAD_RTOL}); updated "
          f"parameters within {own_err:.3e} of the JAX Adam step on the "
          f"port's gradients and {ref_err:.3e} on the oracle's ({n_sure} of "
          f"{n_elems} elements of sure sign; limit 1e-2 lr = "
          f"{1e-2 * TRAIN_LR:.1e}); launches {counts}")
    del P, ref_grads, ref_loss, grads, out

    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        (lv,) = exe.run(main, feed=feed, scope=scope, fetch_list=[avg_loss],
                        return_numpy=False)
        losses.append(lv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(lv) for lv in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < float(loss1):
        raise RuntimeError(f"the loss did not fall: step 1 {float(loss1)}, "
                           f"then {losses}")
    tokens = B * S
    step_flops = _bert_step_flops(cfg, B, S)
    print(f"trained {TRAIN_STEPS} steps in {wall:.3f} s: "
          f"{TRAIN_STEPS / wall:.3f} steps/s, {TRAIN_STEPS * tokens / wall:.1f} "
          f"tokens/s, {TRAIN_STEPS * step_flops / wall / 1e12:.2f} model "
          f"TFLOP/s ({step_flops / 1e12:.3f} TFLOP a step); losses "
          f"{[round(x, 5) for x in losses]} [{card}]")
    return exe, main, scope, feed, avg_loss, counts


# bench.py:278 _resnet_arm's on-chip configuration (ResNet-50, 1000 classes,
# 224x224, space-to-depth stem, NHWC, Momentum(0.1, 0.9)), cut to fp32 and
# batch 32
RN_B, RN_HW, RN_CLASSES, RN_LR, RN_MU, RN_STEPS = 32, 224, 1000, 0.1, 0.9, 5
# One batch of 32 repeated at lr 0.1 climbs (7.47, then 15.8, 31.6, 41.0,
# 53.8, 57.3 on the H100; the last layer alone moves each logit by about
# lr |features|^2 / B a step), so after step 1 has been held to the oracle
# at lr 0.1 the timed steps restart from the same initial state with the
# learning-rate variable set to this, and the loss must fall
RN_FALL_LR = 0.01
RN_STAGES = (3, 4, 6, 3)


RELU_NEAR = 2e-4    # of the largest input of that relu


def _tally(dev):
    t = {k: torch.zeros((), dtype=torch.int64, device=dev)
         for k in ("near", "taken", "far", "elems")}
    for k in ("fwd", "fwd_max", "fwd_l2"):
        t[k] = torch.zeros((), device=dev)
    return t


class _PortForward(torch.autograd.Function):
    """The port's tensor in the forward pass, the gradient of the oracle's
    own tensor in the backward."""

    @staticmethod
    def forward(ctx, own, port):
        return port.to(own.dtype, copy=True)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _resnet50_oracle(P, img, label, stats, port_relu, tally,
                     low=torch.float32, relu_near=RELU_NEAR, forced=False):
    """The NHWC space-to-depth ResNet-50 loss in plain torch (F.conv2d,
    explicit batch statistics by the model's formula var = E[x^2] -
    E[x]^2, F.max_pool2d, F.cross_entropy) over the parameter tensors P;
    leaves every batch norm's (mean, biased var) in `stats` by name.

    `low` is the dtype of the activations and products: float32, or
    bfloat16 for the AMP program's cast scheme (every conv and the fc on
    bf16 views of the fp32 weights, each batch norm's statistics and apply
    in fp32 on the bf16 conv output with its scale and bias rounded to
    bf16, the result rounded to bf16; the loss averaged in fp32).

    relu'(z) at a z within rounding of zero is on in one evaluation and
    off in another, and one such element moves some entries of a weight
    gradient by about 1/sqrt(N) of their size (N the samples per channel,
    1568 at the last stage at B=32), far beyond the limit the gradients
    are held to. The two forward passes differ by rounding, so the band is
    relative: for |z| <= relu_near max|z| of that relu the oracle takes
    the port's decision (`port_relu`: the port's output after each relu,
    by batch-norm name) and everywhere else its own; `tally` counts the
    elements near zero, those of them where the two differed, and the
    disagreements elsewhere, and keeps the largest difference between the
    two forward passes after a relu, in max-abs (`fwd`), in max-abs of
    that relu's largest output (`fwd_max`) and in relative L2 (`fwd_l2`).
    With port_relu None the oracle takes its own decisions
    everywhere (an independent reference).

    With `forced`, the forward pass goes on from each relu with the port's
    output (the oracle's own output keeps the gradient): every layer of
    the oracle reads the port's input to that layer, so the tally holds
    each layer's forward pass on its own, and rounding does not compound
    over depth. In bf16 it would: one unit of a conv output's last place,
    where two cuDNN algorithms sum apart, grows over 50 layers of batch
    norm until the outputs after a relu differ by up to 2.4 and the last
    stage's gradients by 0.30 in relative L2 (B=128 on the H100)."""
    import torch.nn.functional as F

    c = lambda t: t.to(low)  # noqa: E731  (no copy in fp32)

    def relu(z, name):
        if port_relu is None:
            return torch.relu(z).to(low)
        port_y = port_relu[name].permute(0, 3, 1, 2)
        own, port = z > 0, port_y > 0
        near = z.detach().abs() <= relu_near * z.detach().abs().max()
        differ = own != port
        tally["near"] += near.sum()
        tally["taken"] += (differ & near).sum()
        tally["far"] += (differ & ~near).sum()
        tally["elems"] += z.numel()
        y = (z * torch.where(near, port, own)).to(low)
        d = y.detach().float() - port_y.float()
        tally["fwd"] = torch.maximum(tally["fwd"], d.abs().max())
        tally["fwd_max"] = torch.maximum(tally["fwd_max"], d.abs().max()
                                         / torch.clamp(port_y.abs().max(), min=1e-30))
        tally["fwd_l2"] = torch.maximum(tally["fwd_l2"], d.norm() / torch.clamp(
            port_y.float().norm(), min=1e-30))
        return _PortForward.apply(y, port_y) if forced else y

    def conv(x, name, stride=1, pad=0):
        return F.conv2d(x, c(P[name + ".w_0"]).permute(3, 2, 0, 1), None,
                        stride, pad)

    def bn(x, name):
        x = x.float()
        mean = x.mean(dim=(0, 2, 3))
        var = (x * x).mean(dim=(0, 2, 3)) - mean * mean
        stats[name] = (mean.detach(), var.detach())
        v = lambda t: t[None, :, None, None]  # noqa: E731
        return ((x - v(mean)) * v(torch.rsqrt(var + 1e-5))
                * v(c(P[name + ".w_0"]).float()) + v(c(P[name + ".b_0"]).float()))

    n, h, w, ch = img.shape
    x = c(img).reshape(n, h // 2, 2, w // 2, 2, ch).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(n, h // 2, w // 2, 4 * ch).permute(0, 3, 1, 2)
    x = relu(bn(conv(F.pad(x, (2, 1, 2, 1)), "stem"), "stem.bn"), "stem.bn")
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, blocks in enumerate(RN_STAGES):
        width = 64 * 2 ** stage
        for i in range(blocks):
            stride = 2 if (i == 0 and stage > 0) else 1
            pre = f"res{stage}.{i}"
            y = relu(bn(conv(x, pre + ".c1"), pre + ".c1.bn"), pre + ".c1.bn")
            y = relu(bn(conv(y, pre + ".c2", stride, 1), pre + ".c2.bn"),
                     pre + ".c2.bn")
            y = bn(conv(y, pre + ".c3"), pre + ".c3.bn")
            if x.shape[1] != width * 4 or stride != 1:
                x = c(bn(conv(x, pre + ".sc", stride), pre + ".sc.bn"))
            x = relu(y + x.float(), pre + ".c3.bn")
    logits = c(c(x.float().mean(dim=(2, 3))) @ c(P["fc_0.w_0"])) + c(P["fc_0.b_0"])
    return F.cross_entropy(logits.float(), label,
                           reduction="none").to(low).float().mean()


def train_resnet(dev, card):
    """The ResNet-50 training step through the port's entry points: step 1
    held against the plain-torch autograd oracle (loss, every gradient, the
    momentum update, the running statistics), launches per step counted,
    then RN_STEPS timed steps on the same batch."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops import cuda_kernels as ck

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        img = L.data(name="img", shape=[RN_HW, RN_HW, 3], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        loss, acc, _ = resnet.resnet50(img, label, num_classes=RN_CLASSES,
                                       s2d_stem=True, data_format="NHWC")
        pt.optimizer.Momentum(RN_LR, RN_MU).minimize(loss)
    startup.random_seed = SEED
    ops = [op.type for op in main.global_block.ops]
    n_bn = ops.count("batch_norm") + ops.count("conv2d_bn")
    if n_bn != 53 or ops.count("batch_norm_grad") + ops.count("conv2d_bn_grad") != 53:
        raise RuntimeError(f"ResNet-50 has 53 batch norms, the program {n_bn}")
    expected = dict.fromkeys(ck.launch_counts(), 0)
    # K9 in its chain mode: one launch a batch norm
    expected.update(bn_apply_act=n_bn, bn_apply_act_backward=n_bn,
                    softmax_xent_fwd=1, softmax_xent_bwd=1)

    exe, scope = pt.Executor(), pt.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    names = [p.name for p in main.all_parameters()]
    n_elems = sum(scope.find_var(n).numel() for n in names)
    print(f"trainer built in {time.perf_counter() - t0:.2f} s: ResNet-50 "
          f"B={RN_B} {RN_HW}x{RN_HW} NHWC s2d stem fp32, {len(names)} "
          f"parameters, {n_elems} elements, {len(ops)} ops a step "
          f"({ops.count('conv2d_bn')} conv2d_bn, {ops.count('batch_norm')} "
          f"batch_norm) [{card}]")
    rng = np.random.default_rng(SEED)
    feed = {"img": rng.standard_normal((RN_B, RN_HW, RN_HW, 3)).astype(np.float32),
            "label": rng.integers(0, RN_CLASSES, (RN_B, 1)).astype(np.int64)}
    feed = {k: torch.from_numpy(v).to(dev) for k, v in feed.items()}
    feed["label"] = feed["label"].to(torch.int32)
    p0 = {n: scope.find_var(n).clone() for n in names}
    bn_names = sorted(n[:-len(".mean")] for n in main.global_block.vars
                      if n.endswith(".bn.mean"))
    # the port's output after each relu, all folded into the norm ops
    relu_vars = {op.inputs["Scale"][0][:-len(".w_0")]: op.outputs["Y"][0]
                 for op in main.global_block.ops
                 if op.type in ("conv2d_bn", "batch_norm")
                 and op.attr("act", "") == "relu"}
    if len(relu_vars) != 49 or "relu" in ops:
        raise RuntimeError(f"ResNet-50 has 49 relus folded into its norm ops, "
                           f"the program {len(relu_vars)}")

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                  fetch_list=[loss] + [n + "@GRAD" for n in names]
                  + list(relu_vars.values()))
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = ck.launch_counts()
    if counts != expected:
        raise RuntimeError(f"launches in one step {counts}, expected {expected}")
    loss1, grads = out[0], dict(zip(names, out[1:]))
    port_relu = dict(zip(relu_vars, out[1 + len(names):]))

    P = {n: t.clone().requires_grad_() for n, t in p0.items()}
    stats = {}
    tally = _tally(dev)
    ref_loss = _resnet50_oracle(P, feed["img"], feed["label"].long()[:, 0],
                                stats, port_relu, tally)
    ref_grads = torch.autograd.grad(ref_loss, [P[n] for n in names])
    ref_loss = ref_loss.detach()
    tally = {k: v.item() for k, v in tally.items()}
    if tally["far"]:
        raise RuntimeError(f"{tally['far']} relu decisions differ from the "
                           f"oracle's beyond {RELU_NEAR} of the relu's "
                           f"largest input off zero (the two "
                           f"forward passes differ by up to {tally['fwd']:.3e})")
    if not abs(float(loss1) - float(ref_loss)) <= 1e-4 * abs(float(ref_loss)):
        raise RuntimeError(f"step-1 loss {float(loss1)} vs oracle "
                           f"{float(ref_loss)}")
    # First momentum step from zero velocity: v = g, p = p0 - lr g. The
    # port's update against the formula on its own gradients, and against
    # the formula on the oracle's (the gradient limit times lr); both allow
    # the parameter's own fp32 spacing, 2.4e-7 of its max-abs.
    worst = own_err = ref_err = vel_err = 0.0
    for n, rg in zip(names, ref_grads):
        scale = float(rg.abs().max())
        e = float((grads[n] - rg).abs().max()) / max(scale, 1e-30)
        if not e <= GRAD_RTOL:
            raise RuntimeError(f"{n}@GRAD differs from the oracle by {e:.3e} "
                               f"of its max-abs {scale:.3e}")
        worst = max(worst, e)
        p1 = scope.find_var(n)
        vel_err = max(vel_err, float(
            (scope.find_var(f"{n}_velocity_0") - grads[n]).abs().max()))
        spacing = 2.4e-7 * float(p0[n].abs().max())
        step = max(RN_LR * scale, 1e-30)
        own = float((p1 - (p0[n] - RN_LR * grads[n])).abs().max())
        ref = float((p1 - (p0[n] - RN_LR * rg)).abs().max())
        own_err = max(own_err, max(own - spacing, 0.0) / step)
        ref_err = max(ref_err, max(ref - spacing, 0.0) / step)
    if vel_err != 0.0 or not own_err <= 1e-6 or not ref_err <= GRAD_RTOL:
        raise RuntimeError(
            f"momentum step 1: velocity differs from the gradient by "
            f"{vel_err:.3e}; beyond fp32 spacing the parameters differ from "
            f"p0 - lr g by {own_err:.3e} of lr max|g| on the port's gradients "
            f"(limit 1e-6) and by {ref_err:.3e} on the oracle's (limit "
            f"{GRAD_RTOL})")
    stat_err = 0.0
    if sorted(stats) != bn_names:
        raise RuntimeError("the oracle's batch norms are not the program's")
    for n, (m, v) in stats.items():
        for got, want in ((scope.find_var(n + ".mean"), (1 - 0.9) * m),
                          (scope.find_var(n + ".var"), 0.9 + (1 - 0.9) * v)):
            err = (got - want).abs()
            if not bool((err <= 1e-5 + 1e-4 * want.abs()).all()):
                raise RuntimeError(f"running statistics of {n} differ from the "
                                   f"oracle's by {float(err.max()):.3e}")
            stat_err = max(stat_err, float(err.max()))
    peak1 = torch.cuda.max_memory_allocated()
    print(f"step 1 ({first:.3f} s, first use of every conv shape): loss "
          f"{float(loss1):.6f}, oracle {float(ref_loss):.6f}; worst gradient "
          f"error {worst:.3e} of its max-abs (limit {GRAD_RTOL}); velocity "
          f"equals the gradient; momentum update within {own_err:.3e} of lr "
          f"max|g| of p0 - lr g on the port's gradients and {ref_err:.3e} on "
          f"the oracle's; {len(stats)} "
          f"running mean/var pairs within {stat_err:.3e} of the oracle's; "
          f"of {tally['near']} relu inputs within {RELU_NEAR} of their "
          f"relu's largest off zero the "
          f"oracle's own decision differed from the port's at "
          f"{tally['taken']}, and at none farther off (the two forward "
          f"passes differ by up to {tally['fwd']:.3e} after a relu); "
          f"launches {counts}")
    del P, ref_grads, ref_loss, grads, out, stats, port_relu

    # back to the initial state (parameters, zero velocities, running
    # statistics at 0 / 1), the learning rate at RN_FALL_LR
    lr_name = next(op.inputs["LearningRate"][0] for op in main.global_block.ops
                   if op.type == "momentum")
    scope.find_var(lr_name).fill_(RN_FALL_LR)
    for n in names:
        scope.find_var(n).copy_(p0[n])
        scope.find_var(f"{n}_velocity_0").zero_()
    for n in bn_names:
        scope.find_var(n + ".mean").zero_()
        scope.find_var(n + ".var").fill_(1.0)

    def step():
        return exe.run(main, feed=feed, scope=scope, fetch_list=[loss],
                       return_numpy=False)[0]

    first_loss = float(step())   # cuDNN has now picked every algorithm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step() for _ in range(RN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [float(lv) for lv in losses]
    if abs(first_loss - float(loss1)) > 1e-5 * float(loss1):
        raise RuntimeError(f"the restored state gives loss {first_loss}, the "
                           f"initial state gave {float(loss1)}")
    if not all(np.isfinite(losses)) or not losses[-1] < first_loss:
        raise RuntimeError(f"the loss did not fall at lr {RN_FALL_LR}: "
                           f"{first_loss}, then {losses}")
    print(f"trained {RN_STEPS} steps (lr {RN_FALL_LR} from the initial state, "
          f"after one untimed step) in {wall:.3f} s: "
          f"{1e3 * wall / RN_STEPS:.2f} ms a step, "
          f"{RN_STEPS * RN_B / wall:.1f} images/s, peak device memory "
          f"{peak / 2**30:.3f} GiB in a step ({peak1 / 2**30:.3f} GiB in step "
          f"1 with every gradient fetched and the oracle beside it); losses "
          f"{[round(x, 5) for x in losses]} [{card}]")
    return (lambda: step()), counts


# ---------------------------------------------------------------------------
# bf16: the kernels at the AMP training steps' shapes, #15, and the two AMP
# training steps at bench.py's batch 128
# ---------------------------------------------------------------------------

BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, dense bf16 tensor cores
# a bf16 output rounded once on each side of a comparison: two units of
# its last place (2^-8 each) plus a floor of a hundredth of the max-abs
BF16_RTOL, BF16_FLOOR = 2.0 ** -7, 1e-2
AMP_B, AMP_S = 128, 128        # bench.py:120 (BERT) and :282 (ResNet-50)
TUNED_B, TUNED_S = 64, 512     # bench.py:137 bench_bert_long (the tuned phase)
CSRC = "paddle_tpu_torch/ops/cuda_kernels/csrc/"


def _bound16(flops, nbytes):
    return _bound(flops, nbytes, BF16_FLOPS_PER_S)


def _agree16(name, out, ref, floor=BF16_FLOOR):
    """A bf16 kernel output against its plain version's: |out - ref| <=
    BF16_RTOL |ref| + floor max|ref|. Returns the max abs err."""
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype \
            or not torch.isfinite(out.float()).all():
        raise RuntimeError(f"{name}: {tuple(out.shape)} {out.dtype} vs "
                           f"{tuple(ref.shape)} {ref.dtype}, or non-finite")
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    if not bool((err <= BF16_RTOL * r.abs() + floor * r.abs().max()).all()):
        raise RuntimeError(f"{name}: kernel disagrees with its plain version "
                           f"(max abs err {err.max().item():.3e}, max-abs "
                           f"{r.abs().max().item():.3e})")
    return float(err.max().item())


# K7's dx = g (p - onehot): its typical element is g / V or less, a
# thousandth of the one-hot entry that sets its max-abs, so a floor tied to
# the max-abs would pass a kernel that drops most of the softmax. dx is held
# element by element: fp32 to 1e-4 relative (ex2.approx and the row sums in
# another order move p by a few 1e-6), bf16 to one unit of its last place
# (2^-7 |ref|: one fp32 value rounded either side of a rounding boundary),
# both with a floor of a thousandth of the median |ref| (taken over a
# strided sample of about 2^20 elements).
XENT_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
XENT_FLOOR = 1e-3


def _agree_xent(name, out, ref):
    """K7's dx against its plain version's, element by element; returns
    the max abs err."""
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype \
            or not torch.isfinite(out.float()).all():
        raise RuntimeError(f"{name}: {tuple(out.shape)} {out.dtype} vs "
                           f"{tuple(ref.shape)} {ref.dtype}, or non-finite")
    if not ref.numel():
        return 0.0
    r = ref.float()
    a = r.abs()
    typical = float(a.flatten()[::max(1, a.numel() >> 20)].median())
    err = (out.float() - r).abs()
    bad = err > XENT_RTOL[ref.dtype] * a + XENT_FLOOR * typical
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        raise RuntimeError(
            f"{name}: kernel disagrees with its plain version at "
            f"{int(bad.sum())} elements, the first flat index {i}: "
            f"{out.flatten()[i].item():.6e} vs {ref.flatten()[i].item():.6e} "
            f"(median |ref| {typical:.3e})")
    return float(err.max().item())


def _bf16_entry(name, source, replaces, err, ms, plain_ms, bound, by, lib_ms):
    return {"name": name, "dtype": "bfloat16", "route": "cuda",
            "source": CSRC + source, "replaces": replaces,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}


# ResNet-50's batch-norm applies at B=128 (bench.py:282), NHWC "cl" on the
# main path, the NCHW layout's "cr" at the first and last bottleneck widths
BN_SHAPES_AMP = (  # (mode, R, row, C, act, residual)
    ("cl", AMP_B * 56 * 56, 64, 64, "relu", False),
    ("cl", AMP_B * 56 * 56, 256, 256, "identity", False),
    ("cl", AMP_B * 56 * 56, 256, 256, "relu", True),
    ("cl", AMP_B * 7 * 7, 2048, 2048, "identity", False),
    ("cl", AMP_B * 7 * 7, 2048, 2048, "relu", True),
    ("cr", AMP_B * 256, 3136, 256, "relu", True),
    ("cr", AMP_B * 2048, 49, 2048, "relu", True),
)


# bf16 K2 / K4, one case for each route of the kernels: BERT-base
# attention at the AMP shape (one block a head; timed, the entries'
# numbers), bench.py:137's long BERT shape B=64, S=512 (streamed key tiles;
# timed), causal at a ragged S, kv_lens with a kv_len 0 row on both routes,
# a head width padded to 48 (40) and dh = 128, and the WMT step's 8 heads
# (its self-attentions and cross-attention, K and V separate buffers from Q
# as in every case here)
ATTN16_CASES = (  # (B, nh, S, dh, causal, kv_lens, timed)
    (AMP_B, 12, AMP_S, 64, False, None, True),
    (TUNED_B, 12, TUNED_S, 64, False, None, True),
    (4, 12, 100, 64, True, None, False),
    (3, 12, 128, 64, True, (100, 0, 128), False),
    (3, 12, 384, 64, False, (300, 0, 384), False),
    (4, 12, 128, 40, False, None, False),
    (4, 12, 200, 40, True, None, False),
    (4, 12, 128, 128, False, None, False),
    (4, 12, 512, 128, True, None, False),
    (AMP_B, 8, 128, 64, False, None, False),    # the WMT step's (bench.py:355)
    (AMP_B, 8, 128, 64, True, None, False),
)


def _check_attention16(dev, timer, card, g):
    """bf16 K2 and K4 against their plain versions at ATTN16_CASES, the
    timed ones beside SDPA (forward, and backward through autograd) and
    their bounds; a kv_len 0 row must give zeros. Returns the two entries
    of each timed shape: the AMP shape's, then bench.py:137's S = 512 (with
    its shape)."""
    from paddle_tpu_torch.ops.cuda_kernels import attention_bwd as K4
    from paddle_tpu_torch.ops.cuda_kernels import prefill_attention as K2
    import torch.nn.functional as F

    entries = []
    for B, nh, S, dh, causal, lens, timed in ATTN16_CASES:
        q, k, v, do = (torch.randn((B, nh, S, dh), generator=g).to(
            dev, torch.bfloat16) for _ in range(4))
        kl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                    device=dev)
        sc = dh ** -0.5
        shape = (f"B={B} nh={nh} S={S} dh={dh} causal={causal}"
                 + ("" if lens is None else f" kv_lens={list(lens)}") + " bf16")
        o = K2.causal_prefill_attention(q, k, v, causal, sc, kl)
        err2 = _agree16(f"causal_prefill_attention {shape}", o,
                        K2.causal_prefill_attention_plain(q, k, v, causal, sc,
                                                          kl))
        got = K4.attention_backward(q, k, v, do, causal, sc, kl)
        ref = K4.attention_backward_plain(q, k, v, do, causal, sc, kl)
        # dQ, dK, dV sum S terms of dS and P rounded to bf16 on both sides
        err4 = max(_agree16(f"attention_backward {shape} d{n}", a, r,
                            floor=2e-2) for n, a, r in zip("qkv", got, ref))
        if lens is not None and 0 in lens:
            b = lens.index(0)
            if o[b].any() or any(t[b].any() for t in got):
                raise RuntimeError(f"K2/K4 {shape}: the kv_len 0 row is not "
                                   f"all zeros")
        if not timed:
            print(f"K2/K4 bf16 {shape}: max_abs_err {err2:.3e} / {err4:.3e} "
                  f"[{card}]")
            continue
        ms = timer(lambda: K2.causal_prefill_attention(q, k, v, causal, sc))
        plain_ms = timer(lambda: K2.causal_prefill_attention_plain(
            q, k, v, causal, sc))
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=sc))
        bound, by = _bound16(2 * 2 * B * nh * S * S * dh,
                             4 * B * nh * S * dh * 2)
        _row("K2 causal_prefill_attention", shape, ms, plain_ms, lib_ms, bound,
             by, err2, card)
        fwd = _bf16_entry(
            "causal_prefill_attention", "prefill_attention.cu",
            "paddle_tpu/ops/pallas_kernels/short_attention.py:248 "
            "+ paddle_tpu/ops/pallas_kernels/attention.py:211",
            err2, ms, plain_ms, bound, by, lib_ms)
        ms = timer(lambda: K4.attention_backward(q, k, v, do, causal, sc))
        plain_ms = timer(lambda: K4.attention_backward_plain(
            q, k, v, do, causal, sc))
        lib_ms = timer(_autograd_lib(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=sc), (q, k, v), do))
        bound, by = _bound16(5 * 2 * B * nh * S * S * dh,
                             7 * B * nh * S * dh * 2)
        _row("K4 attention_backward", shape, ms, plain_ms, lib_ms, bound, by,
             err4, card)
        pair = [fwd, _bf16_entry(
            "attention_backward", "attention_backward.cu",
            "paddle_tpu/ops/pallas_kernels/short_attention.py:164 "
            "+ paddle_tpu/ops/pallas_kernels/attention.py:154",
            err4, ms, plain_ms, bound, by, lib_ms)]
        if entries:   # the S = 512 shape, whose launches the tuned phase counts
            for e in pair:
                e["shape"] = [B, nh, S, dh]
        entries += pair
        del q, k, v, do, o, got, ref
        torch.cuda.empty_cache()
    return entries


def check_bf16_kernels(dev, timer, card):
    """K2-K9 in bf16 against their plain versions in bf16, at the AMP
    steps' shapes: BERT-base at B=128, S=128 (attention [128, 12, 128, 64],
    with K2/K4's other routes in ATTN16_CASES, layer norm [16384, 768],
    cross entropy [16384, 30522]) and ResNet-50's batch-norm applies at
    B=128; bounds at 2 bytes an element or bf16 operations, the library
    yardstick in bf16 where one call computes the same function."""
    from paddle_tpu_torch.ops.cuda_kernels import bn_apply as K8
    from paddle_tpu_torch.ops.cuda_kernels import bn_apply_bwd as K9
    from paddle_tpu_torch.ops.cuda_kernels import layer_norm as K3
    from paddle_tpu_torch.ops.cuda_kernels import layer_norm_bwd as K5
    from paddle_tpu_torch.ops.cuda_kernels import xent_bwd as K7
    from paddle_tpu_torch.ops.cuda_kernels import xent_fwd as K6
    import torch.nn.functional as F

    bf = torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(SEED + 10)

    def rnd(*shape, scale=1.0, shift=0.0, dtype=bf):
        return (scale * torch.randn(shape, generator=g) + shift).to(dev, dtype)

    out = _check_attention16(dev, timer, card, g)

    # K3 / K5: BERT-base layer norm, 16384 rows of 768
    R, Kd = AMP_B * AMP_S, 768
    x, dy = rnd(R, Kd), rnd(R, Kd)
    s_, b_ = rnd(Kd, scale=0.1, shift=1.0, dtype=torch.float32), \
        rnd(Kd, scale=0.1, dtype=torch.float32)
    shape = f"R={R} K={Kd} act=identity bf16"
    y = K3.layer_norm_act(x, s_, b_, 1e-5, "identity")
    ref = K3.layer_norm_act_plain(x, s_, b_, 1e-5, "identity")
    err = max(_agree16("layer_norm_act bf16 y", y[0], ref[0]),
              *(_agree(f"layer_norm_act bf16 {n}", o, r)
                for n, o, r in zip(("mean", "var"), y[1:], ref[1:])))
    ms = timer(lambda: K3.layer_norm_act(x, s_, b_, 1e-5, "identity"))
    plain_ms = timer(lambda: K3.layer_norm_act_plain(x, s_, b_, 1e-5, "identity"))
    sb, bb = s_.to(bf), b_.to(bf)
    lib_ms = timer(lambda: F.layer_norm(x, (Kd,), sb, bb, 1e-5))
    bound, by = _bound16(0, 2 * R * Kd * 2 + 2 * Kd * 4 + 2 * R * 4)
    _row("K3 layer_norm_act", shape, ms, plain_ms, lib_ms, bound, by, err, card)
    out.append(_bf16_entry("layer_norm_act", "layer_norm.cu",
                           "paddle_tpu/ops/pallas_kernels/epilogue.py:421",
                           err, ms, plain_ms, bound, by, lib_ms))
    got = K5.layer_norm_act_backward(x, s_, b_, dy, 1e-5, "identity")
    ref = K5.layer_norm_act_backward_plain(x, s_, b_, dy, 1e-5, "identity")
    err = max(_agree16("layer_norm_act_backward bf16 dx", got[0], ref[0]),
              *(_sums_agree(f"layer_norm_act_backward bf16 {n}", o, r)
                for n, o, r in zip(("dscale", "dbias"), got[1:], ref[1:])))
    _repeats("layer_norm_act_backward bf16", got,
             K5.layer_norm_act_backward(x, s_, b_, dy, 1e-5, "identity"))
    ms = timer(lambda: K5.layer_norm_act_backward(x, s_, b_, dy, 1e-5, "identity"))
    plain_ms = timer(lambda: K5.layer_norm_act_backward_plain(
        x, s_, b_, dy, 1e-5, "identity"))
    lib_ms = timer(_autograd_lib(lambda x, s, b: F.layer_norm(
        x, (Kd,), s, b, 1e-5), (x, sb, bb), dy))
    bound, by = _bound16(0, 3 * R * Kd * 2 + 4 * Kd * 4)
    _row("K5 layer_norm_act_backward", shape, ms, plain_ms, lib_ms, bound, by,
         err, card)
    out.append(_bf16_entry("layer_norm_act_backward", "layer_norm_backward.cu",
                           "paddle_tpu/ops/pallas_kernels/epilogue.py:373",
                           err, ms, plain_ms, bound, by, lib_ms))
    del x, dy, y, got, ref

    # K3 / K5 at the WMT step's rows (bench.py:355: 16384 rows of 512)
    Kw = WMT_BASE["hidden_size"]
    x, dy = rnd(R, Kw), rnd(R, Kw)
    s_, b_ = rnd(Kw, scale=0.1, shift=1.0, dtype=torch.float32), \
        rnd(Kw, scale=0.1, dtype=torch.float32)
    err3 = _agree16(f"layer_norm_act bf16 K={Kw} y",
                    K3.layer_norm_act(x, s_, b_, 1e-5, "identity")[0],
                    K3.layer_norm_act_plain(x, s_, b_, 1e-5, "identity")[0])
    got = K5.layer_norm_act_backward(x, s_, b_, dy, 1e-5, "identity")
    ref = K5.layer_norm_act_backward_plain(x, s_, b_, dy, 1e-5, "identity")
    err5 = max(_agree16(f"layer_norm_act_backward bf16 K={Kw} dx", got[0],
                        ref[0]),
               *(_sums_agree(f"layer_norm_act_backward bf16 K={Kw} {n}", o, r)
                 for n, o, r in zip(("dscale", "dbias"), got[1:], ref[1:])))
    print(f"K3/K5 bf16 R={R} K={Kw} (the WMT step's rows): max_abs_err "
          f"{err3:.3e} / {err5:.3e} [{card}]")
    del x, dy, got, ref

    # K6 / K7: the BERT-base lm head at B=128, S=128
    N, V = AMP_B * AMP_S, 30522
    x = rnd(N, V, scale=3.0)
    lab = torch.randint(0, V, (N,), generator=g, dtype=torch.int32).to(dev)
    gl = rnd(N, dtype=torch.float32)
    lab64 = lab.long()
    shape = f"N={N} V={V} bf16 logits"
    err = max(_agree(f"softmax_xent_fwd bf16 {n}", o, r) for n, o, r in zip(
        ("loss", "m", "lse"), K6.softmax_xent_fwd(x, lab),
        K6.softmax_xent_fwd_plain(x, lab)))
    ms = timer(lambda: K6.softmax_xent_fwd(x, lab))
    plain_ms = timer(lambda: K6.softmax_xent_fwd_plain(x, lab))
    lib_ms = timer(lambda: F.cross_entropy(x, lab64, reduction="none"))
    bound, by = _bound16(0, N * V * 2 + 4 * N * 4)
    _row("K6 softmax_xent_fwd", shape, ms, plain_ms, lib_ms, bound, by, err, card)
    out.append(_bf16_entry("softmax_xent_fwd", "softmax_xent_fwd.cu",
                           "paddle_tpu/ops/pallas_kernels/xent.py:221",
                           err, ms, plain_ms, bound, by, lib_ms))
    lib_ms = timer(_autograd_lib(lambda x: F.cross_entropy(
        x, lab64, reduction="none"), (x,), gl.to(bf)))
    saved = K6.softmax_xent_fwd_plain(x, lab)[1:]
    for mode, stats in (("recomputed stats (program path, #12)", ()),
                        ("saved stats (#11)", saved)):
        err = _agree_xent(f"softmax_xent_bwd bf16 {mode}",
                          K7.softmax_xent_bwd(x, lab, gl, *stats),
                          K7.softmax_xent_bwd_plain(x, lab, gl, *stats))
        ms = timer(lambda: K7.softmax_xent_bwd(x, lab, gl, *stats))
        plain_ms = timer(lambda: K7.softmax_xent_bwd_plain(x, lab, gl, *stats))
        bound, by = _bound16(0, 2 * N * V * 2 + (2 + len(stats)) * N * 4)
        _row("K7 softmax_xent_bwd", f"{shape} {mode}", ms, plain_ms, lib_ms,
             bound, by, err, card)
        if not stats:
            out.append(_bf16_entry(
                "softmax_xent_bwd", "softmax_xent_bwd.cu",
                "paddle_tpu/ops/pallas_kernels/xent.py:228 "
                "+ paddle_tpu/ops/pallas_kernels/xent.py:139",
                err, ms, plain_ms, bound, by, lib_ms))
    del x, saved

    # K8 / K9: ResNet-50's batch-norm applies at B=128
    k8 = k9 = split_entries = None
    for mode, R, row, C, act, has_res in BN_SHAPES_AMP:
        x = rnd(R, row, scale=1.5, shift=0.3)
        dy = rnd(R, row)
        res = rnd(R, row) if has_res else None
        p = (rnd(C, scale=0.2, shift=1.0, dtype=torch.float32),
             rnd(C, scale=0.2, dtype=torch.float32),
             rnd(C, scale=0.1, shift=0.3, dtype=torch.float32),
             torch.rsqrt(2.25 + torch.rand((C,), generator=g)).to(dev))
        shape = (f"{mode} [{R}, {row}] C={C} act={act} residual="
                 f"{'yes' if has_res else 'no'} bf16")
        err = _agree16(f"bn_apply_act {shape}",
                       K8.bn_apply_act(x, *p, act, res, mode),
                       K8.bn_apply_act_plain(x, *p, act, res, mode))
        ms = timer(lambda: K8.bn_apply_act(x, *p, act, res, mode))
        plain_ms = timer(lambda: K8.bn_apply_act_plain(x, *p, act, res, mode))
        lib_ms = lib_bwd = lib_chain = None
        if act == "identity" and not has_res:
            x4 = _bn_nchw(x, mode, R, row, C, AMP_B)
            dy4 = _bn_nchw(dy, mode, R, row, C, AMP_B)
            lib = _bn_infer_lib(x4, p[2], p[3])
            lib_ms = timer(lambda: lib(x4, p[0], p[1]))
            lib_bwd = timer(_autograd_lib(lib, (x4, p[0], p[1]), dy4))
            lib_chain = timer(_bn_train_backward(x4, dy4, p[0], p[2], p[3]))
        n_t = 3 if has_res else 2
        bound, by = _bound16(4 * R * row, n_t * R * row * 2 + 4 * C * 4)
        _row("K8 bn_apply_act", shape, ms, plain_ms, lib_ms, bound, by, err, card)
        if k8 is None:
            k8 = _bf16_entry("bn_apply_act", "bn_apply.cu",
                             "paddle_tpu/ops/pallas_kernels/epilogue.py:151",
                             err, ms, plain_ms, bound, by, lib_ms)
        got = K9.bn_apply_act_backward(x, *p, dy, act, res, mode)
        # bf16 operands make a pre-activation within fp32 rounding of zero
        # common (`_k9_reference`)
        ref, n_split, n_fused = _k9_reference(
            f"bn_apply_act_backward {shape}", got, x, p, dy, act, res, mode)
        err = _agree16(f"bn_apply_act_backward dx {shape}", got[0], ref[0])
        if has_res:
            err = max(err, _agree16(f"bn_apply_act_backward dres {shape}",
                                    got[1], ref[1]))
        sum_err = max(_sums_agree(f"bn_apply_act_backward {n} {shape}", o, r)
                      for n, o, r in zip(("P1", "P2", "dscale", "dbias"),
                                         got[2:], ref[2:]))
        one_ms = timer(lambda: K9.bn_apply_act_backward(x, *p, dy, act, res,
                                                        mode))

        # the main path's call: the chain mode (the sums, the fold and dx in
        # one launch, as the AMP step runs it)
        M = R * row // C
        got = K9.bn_apply_act_backward(x, *p, dy, act, res, mode, M)
        ref, n_split, n_fused = _k9_reference(
            f"bn_apply_act_backward chain {shape}", got, x, p, dy, act, res,
            mode, M)
        err = max(err, _agree16(f"bn_apply_act_backward chain dx {shape}",
                                got[0], ref[0]))
        if has_res:
            err = max(err, _agree16(f"bn_apply_act_backward chain dres {shape}",
                                    got[1], ref[1]))
        sum_err = max([sum_err] + [
            _sums_agree(f"bn_apply_act_backward chain {n} {shape}", o, r)
            for n, o, r in zip(("dscale", "dbias"), got[4:], ref[4:])])
        _repeats(f"bn_apply_act_backward chain {shape}", got,
                 K9.bn_apply_act_backward(x, *p, dy, act, res, mode, M))
        ms = timer(lambda: K9.bn_apply_act_backward(x, *p, dy, act, res, mode,
                                                    M))
        plain_ms = timer(lambda: K9.bn_apply_act_backward_plain(
            x, *p, dy, act, res, mode, M))
        phases = _k9_phases(K9, (x, *p, dy, act, res, mode, M), ms)
        bound, by = _k9_bound(x, R, row, C, 5 if has_res else 3, _bound16)
        if mode == "cl":
            # the split mode at every "cl" row (a sync batch norm's
            # backward on the ResNet-50 AMP arm of dp_gloo2), timed at the
            # rows with a library yardstick; the first gives its entries'
            # numbers
            nums = _k9_split(K9, timer, card, shape,
                             (x, p, dy, act, res, mode), got, M, err,
                             lib_chain, _bound16, timed=lib_chain is not None)
            if split_entries is None and lib_chain is not None:
                split_entries = [
                    _bf16_entry(f"bn_apply_act_backward_{part}",
                                "bn_apply_backward.cu",
                                "paddle_tpu/ops/pallas_kernels/epilogue.py:182",
                                err, n["ms"], n["plain_ms"], n["bound_ms"],
                                n["bound_by"], lib_chain)
                    for part, n in zip(("sums", "chain"), nums)]
        _row("K9 bn_apply_act_backward", shape + f" with the statistics "
             f"chain (pass 1 / fold / pass 2 by the kernel's clock: "
             f"{' / '.join(f'{t:.4f}' for t in phases)} ms; one pass without "
             f"it: {one_ms:.4f} ms, against the "
             f"inference batch norm's backward: {_ms(lib_bwd)} ms; sums within "
             f"{sum_err:.1e} of their max-abs; {n_split} relu decisions split "
             f"by the fused multiply-add's rounding, {n_fused} taken on its "
             f"side)", ms,
             plain_ms, lib_chain, bound, by, err, card)
        if k9 is None:
            k9 = _bf16_entry("bn_apply_act_backward", "bn_apply_backward.cu",
                             "paddle_tpu/ops/pallas_kernels/epilogue.py:182",
                             err, ms, plain_ms, bound, by, lib_chain)
        del x, dy, res, got, ref
    torch.cuda.empty_cache()
    return out + [k8, k9] + split_entries


def check_bottleneck(dev, timer, card):
    """#15 at the tool's shape (B=128, 56x56, C=256, M=64): the tool's entry
    point as a path (one block, then a chain of K_CHAIN, its launches
    counted from 0, every one on the wgmma kernel), the kernel against
    bottleneck_block_plain at the tool's inputs and at the unit set (x ~
    N(0, 1), weights scaled to keep unit variance: there the chain, not the
    residual, sets the output, and this comparison refuses a dropped halo,
    a zeroed centre tap and y3 off by 2%, tests/test_torch_smoke_oracle.py),
    against the library chain at the unit set, two calls bit for bit, its
    time, bound and the library chain's, then the tool's A/B."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.ops.cuda_kernels import bottleneck as BB

    x, w1, w2, w3 = BB.inputs(dev, SEED)
    ck.reset_launch_counts()
    y = BB.bottleneck_block(x, w1, w2, w3)
    c = x
    for _ in range(BB.K_CHAIN):
        c = BB.bottleneck_block(c, w1, w2, w3)
    torch.cuda.synchronize()
    launches = ck.launch_counts_by_dtype()["bottleneck_block"]
    routes = dict(BB.bottleneck_block.launches_by_route)
    if launches != {"bfloat16": 1 + BB.K_CHAIN} \
            or routes != {"wgmma": 1 + BB.K_CHAIN} \
            or not torch.isfinite(c.float()).all():
        raise RuntimeError(f"bottleneck_block path: launches {launches} by "
                           f"kernel {routes}, or a non-finite chained output")
    err = _agree16("bottleneck_block", y, BB.bottleneck_block_plain(x, w1, w2, w3))
    if not torch.equal(y, BB.bottleneck_block(x, w1, w2, w3)):
        raise RuntimeError("bottleneck_block: two calls on the same inputs "
                           "differ")
    unit = BB.inputs(dev, SEED, scale="unit")
    yu = BB.bottleneck_block(*unit)
    err_u = _agree16("bottleneck_block (unit inputs)", yu,
                     BB.bottleneck_block_plain(*unit))
    err_l = _agree16("bottleneck_block (unit inputs) vs the library chain", yu,
                     BB.library_chain(*unit).contiguous())
    print(f"#15 at the unit input set: max_abs_err {err_u:.3e} against the "
          f"plain version, {err_l:.3e} against the library chain (max-abs "
          f"{yu.float().abs().max().item():.3e}) [{card}]")
    del unit, yu
    ms = timer(lambda: BB.bottleneck_block(x, w1, w2, w3))
    plain_ms = timer(lambda: BB.bottleneck_block_plain(x, w1, w2, w3))
    lib_ms = timer(lambda: BB.library_chain(x, w1, w2, w3))
    w_bytes = (w1.numel() + w2.numel() + w3.numel()) * 2
    bound, by = _bound16(BB.flops(x, w1), 2 * x.numel() * 2 + w_bytes)
    _row("#15 bottleneck_block", f"B={BB.B} {BB.H}x{BB.W} C={BB.C} M={BB.M} "
         f"bf16", ms, plain_ms, lib_ms, bound, by, err, card)
    ab = BB.ab(dev)
    print(f"#15 A/B (the tool's protocol, L2 warm): max rel err kernel vs "
          f"library chain {ab['max_rel_err']:.4f}; single-shot kernel "
          f"{ab['kernel_ms']:.4f} ms ({ab['kernel_tflops']:.1f} TF/s), library "
          f"chain {ab['library_ms']:.4f} ms ({ab['library_tflops']:.1f} TF/s); "
          f"chained x{BB.K_CHAIN}: kernel {ab['chain_kernel_ms']:.4f} ms/block, "
          f"library chain {ab['chain_library_ms']:.4f} ms/block [{card}]")
    if not ab["max_rel_err"] <= 2e-2:
        raise RuntimeError(f"bottleneck_block vs the library chain: max rel "
                           f"err {ab['max_rel_err']:.4f}")
    e = _bf16_entry("bottleneck_block", "bottleneck_block.cu",
                    "tools/_rn_pallas_block.py:64", max(err, err_u), ms,
                    plain_ms, bound, by, lib_ms)
    e["launches"] = launches["bfloat16"]
    return e


def _flash_bound(B, nh, S, dh, causal, products, tensors, bf16):
    """The least time of a flash-attention call: `products` products of 2
    flops a live (query, key) pair and dim, at the fp32 or bf16 peak; bytes:
    `tensors` [B, nh, S, dh] tensors of the dtype and one fp32 [B, nh, S]
    statistic, each moved once (K10: q, k, v, out and lse written; K11: q,
    k, v, o, dO, dq, dk, dv and lse read)."""
    pairs = B * nh * (S * (S + 1) // 2 if causal else S * S)
    return _bound(2 * products * pairs * dh,
                  tensors * B * nh * S * dh * (2 if bf16 else 4) + B * nh * S * 4,
                  BF16_FLOPS_PER_S if bf16 else FP32_FLOPS_PER_S)


# the TPU kernels K10 and K11 replace: jax's bundled flash attention behind
# the JAX package's flash_bundled arm
FLASH_REPLACES = ("paddle_tpu/ops/attention_ops.py:147 -> "
                  "jax/experimental/pallas/ops/tpu/flash_attention.py:")


def _device_kernels(fn):
    """The names of the device kernels one call of `fn` launches, read from
    torch.profiler (after a first call that warms it up)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})


def check_flash(dev, timer, card):
    """K10 and K11 against their plain versions, fp32 and bf16, causal and
    not: at the long-context steps' shapes (B=8, S=2048 bf16 and B=4,
    S=1024 fp32, BERT-base's 12 heads of 64, not causal), causal at S=2048
    and 1024, at a ragged S = 1000 with dh = 128, and in bf16 at bench.py:137's
    [64, 12, 512, 64], the tuned phase's attention. K11 is handed the
    plain forward's output and lse on both sides. Library yardsticks:
    scaled_dot_product_attention forward, and its autograd backward; at the
    fp32 main-path shape the script prints which device kernels they run."""
    from paddle_tpu_torch.ops.cuda_kernels import _build
    from paddle_tpu_torch.ops.cuda_kernels import flash_attention as K10
    from paddle_tpu_torch.ops.cuda_kernels import flash_attention_bwd as K11
    import torch.nn.functional as F

    # the wgmma kernels' registers at launch (K10, K11 and K12; the consumer
    # warpgroups take more by setmaxnreg), spills and shared memory
    for src, kernel, regs, rest in _resources(_build):
        if "_wg_kernel" in kernel:
            print(f"wgmma {src}: {kernel}: {regs} registers at launch, "
                  f"{rest} [{card}]")
    g = torch.Generator(device="cpu").manual_seed(SEED + 20)
    bf, f32 = torch.bfloat16, torch.float32
    entries = {}
    # (B, nh, S, dh, causal, dtype); the first two are the main paths' shapes
    cases = ((LONG_B, 12, LONG_S, 64, False, bf),
             (LONG_FP32_B, 12, LONG_FP32_S, 64, False, f32),
             (2, 12, 2048, 64, True, bf), (2, 12, 1024, 64, True, f32),
             (2, 4, 1000, 128, False, bf), (2, 4, 1000, 128, True, f32),
             (TUNED_B, 12, TUNED_S, 64, False, bf))
    for i, (B, nh, S, dh, causal, dt) in enumerate(cases):
        low = dt == bf
        sc = dh ** -0.5
        q, k, v, do = (torch.randn((B, nh, S, dh), generator=g).to(dev, dt)
                       for _ in range(4))
        shape = (f"B={B} nh={nh} S={S} dh={dh} causal={causal} "
                 f"{'bf16' if low else 'fp32'}")
        out, lse = K10.flash_attention_fwd(q, k, v, causal, sc)
        ref, ref_lse = K10.flash_attention_fwd_plain(q, k, v, causal, sc)
        err = max((_agree16 if low else _agree)("flash_attention_fwd out", out,
                                                ref),
                  _agree("flash_attention_fwd lse", lse, ref_lse))
        ms = timer(lambda: K10.flash_attention_fwd(q, k, v, causal, sc))
        plain_ms = timer(lambda: K10.flash_attention_fwd_plain(q, k, v, causal,
                                                               sc))
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=sc))
        bound, by = _flash_bound(B, nh, S, dh, causal, 2, 4, low)
        _row("K10 flash_attention_fwd", shape, ms, plain_ms, lib_ms, bound, by,
             err, card)
        fwd = {"name": "flash_attention_fwd", "route": "cuda",
               "dtype": str(dt).replace("torch.", ""),
               "source": CSRC + "flash_attention.cu",
               "replaces": FLASH_REPLACES + "589",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
        del out, lse
        got = K11.flash_attention_backward(q, k, v, ref, ref_lse, do, causal, sc)
        want = K11.flash_attention_backward_plain(q, k, v, ref, ref_lse, do,
                                                  causal, sc)
        # dQ, dK, dV sum S terms of dS and P rounded to bf16 on both sides
        err = max(_agree16(f"flash_attention_backward d{n}", o, r, floor=2e-2)
                  if low else _agree(f"flash_attention_backward d{n}", o, r)
                  for n, o, r in zip("qkv", got, want))
        del got, want
        ms = timer(lambda: K11.flash_attention_backward(
            q, k, v, ref, ref_lse, do, causal, sc))
        plain_ms = timer(lambda: K11.flash_attention_backward_plain(
            q, k, v, ref, ref_lse, do, causal, sc))
        lib_bwd = _autograd_lib(
            lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=sc), (q, k, v), do)
        lib_ms = timer(lib_bwd)
        if i < 2:
            fwd_names = _device_kernels(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=sc))
            print(f"library yardstick at {shape}: SDPA forward runs "
                  f"{fwd_names}; its backward runs "
                  f"{_device_kernels(lib_bwd)} [{card}]")
        del lib_bwd
        bound, by = _flash_bound(B, nh, S, dh, causal, 5, 8, low)
        _row("K11 flash_attention_backward", shape, ms, plain_ms, lib_ms,
             bound, by, err, card)
        pair = [fwd, dict(
            fwd, name="flash_attention_backward",
            source=CSRC + "flash_attention_backward.cu",
            replaces=FLASH_REPLACES + "941 + :1287",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=lib_ms)]
        if i < 2:
            entries[dt] = pair
        elif (B, S) == (TUNED_B, TUNED_S):
            # bench.py:137's shape, whose launches the tuned phase counts
            entries[dt] += [dict(e, shape=[B, nh, S, dh]) for e in pair]
        del q, k, v, do, ref, ref_lse
        torch.cuda.empty_cache()
    return entries[f32], entries[bf]


PROBE_ITERS = 100      # the tools' default (tools/_attn_probe.py:17)


def check_attn_probe(dev, timer, card):
    """K12 through its tool entry point (`attn_probe.table`, the tool's
    seven rows, its launches counted from 0), then each variant at the
    tool's shape against its plain version, timed beside its bound and the
    library yardstick (scaled_dot_product_attention for the full variants,
    q + v for copy)."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.ops.cuda_kernels import attn_probe as K12
    import torch.nn.functional as F

    ck.reset_launch_counts()
    rows = K12.table(dev, PROBE_ITERS)
    torch.cuda.synchronize()
    launches = ck.launch_counts_by_dtype()["attention_probe"]
    if launches != {"bfloat16": len(K12.VARIANTS) * (PROBE_ITERS + 1)}:
        raise RuntimeError(f"attention_probe table: launches {launches}")
    print(f"K12 the tool's table (B={K12.B} nh={K12.NH} S={K12.S} "
          f"dh={K12.DH} bf16, {PROBE_ITERS} calls a row, L2 warm) [{card}]:")
    for name, ms in rows:
        print(f"  {name:16s} {ms:8.4f} ms   {ms / K12.B * 1e3:6.3f} us/step")
    q, k, v = K12.inputs(dev)
    sm = K12.DH ** -0.5
    B, nh, S, dh = q.shape
    flops = {"copy": B * nh * S * dh, "qk": 2 * B * nh * S * dh * dh,
             "qk_max": 2 * B * nh * S * S * dh,
             "softmax": 2 * B * nh * S * S * dh}
    entry = None
    for variant in K12.VARIANTS:
        got = K12.attention_probe(variant, q, k, v, sm)
        ref = K12.attention_probe_plain(variant, q, k, v, sm)
        if variant == "copy":
            if not torch.equal(got, ref):
                raise RuntimeError("attention_probe copy differs from q + v")
            err = 0.0
        else:
            err = _agree16(f"attention_probe {variant}", got, ref)
        ms = timer(lambda: K12.attention_probe(variant, q, k, v, sm))
        plain_ms = timer(lambda: K12.attention_probe_plain(variant, q, k, v, sm))
        lib_ms = None
        if variant.startswith("full") and variant != "full_bf16sm":
            lib_ms = timer(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                  scale=sm))
        elif variant == "copy":
            lib_ms = timer(lambda: q + v)
        # bytes: q, k, v and out each once (copy: q, v, out); qk reads
        # only the first dh keys of a head
        nbytes = (4 if variant.startswith("full") else 3) * q.numel() * 2
        if variant == "qk":
            nbytes = (2 * q.numel() + B * nh * min(S, dh) * dh) * 2
        bound, by = _bound16(flops.get(variant, 4 * B * nh * S * S * dh),
                             nbytes)
        _row(f"K12 attention_probe {variant}", f"B={B} nh={nh} S={S} dh={dh} "
             f"bf16", ms, plain_ms, lib_ms, bound, by, err, card)
        if variant == "full":
            entry = _bf16_entry("attention_probe", "attn_probe.cu",
                                "tools/_attn_probe.py:29", err, ms, plain_ms,
                                bound, by, lib_ms)
    q, k, v = (torch.randn((8, nh, 200, dh), generator=torch.Generator(
        device="cpu").manual_seed(SEED + 13)).to(dev, torch.bfloat16)
        for _ in range(3))
    worst = 0.0
    for variant in K12.VARIANTS:
        got = K12.attention_probe(variant, q, k, v, sm)
        ref = K12.attention_probe_plain(variant, q, k, v, sm)
        if variant == "copy":
            if not torch.equal(got, ref):
                raise RuntimeError("attention_probe copy differs from q + v "
                                   "at S=200")
        else:
            worst = max(worst, _agree16(f"attention_probe {variant} S=200",
                                        got, ref))
    print(f"K12 attention_probe, all seven variants at B=8 nh={nh} S=200 "
          f"dh={dh}: max_abs_err {worst:.3e} [{card}]")
    entry["launches"] = launches["bfloat16"]
    return entry


def check_dma_probe(dev, timer, card):
    """K13 through its tool entry point (`dma_probe.table`, the tool's seven
    rows, launches counted from 0), then both layouts at every bb exactly
    equal to their plain version (2 x is exact in bf16), timed beside the
    bound (bytes) and the library's x * 2.0."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.ops.cuda_kernels import dma_probe as K13

    ck.reset_launch_counts()
    rows = K13.table(dev, PROBE_ITERS)
    torch.cuda.synchronize()
    launches = ck.launch_counts_by_dtype()["dma_copy"]
    n_rows = 2 * len(K13.BLOCKS)
    if launches != {"bfloat16": n_rows * (PROBE_ITERS + 1)}:
        raise RuntimeError(f"dma_copy table: launches {launches}")
    print(f"K13 the tool's table ({PROBE_ITERS} calls a row, L2 warm) [{card}]:")
    for name, ms, gbs in rows:
        print(f"  {name:28s} {ms:8.4f} ms   {gbs:7.1f} GB/s")
    entry = None
    for x in K13.inputs(dev):
        bound, by = _bound16(x.numel(), 2 * x.numel() * 2)
        lib_ms = timer(lambda: x * 2.0)
        for bb in K13.BLOCKS:
            got = K13.dma_copy(x, bb)
            if not torch.equal(got, K13.dma_copy_plain(x)):
                raise RuntimeError(f"dma_copy {tuple(x.shape)} bb={bb} "
                                   f"differs from 2 x")
            ms = timer(lambda: K13.dma_copy(x, bb))
            plain_ms = timer(lambda: K13.dma_copy_plain(x))
            _row(f"K13 dma_copy bb={bb}", f"{list(x.shape)} bf16", ms,
                 plain_ms, lib_ms, bound, by, 0.0, card)
            if entry is None:
                entry = _bf16_entry("dma_copy", "dma_probe.cu",
                                    "tools/_attn_dma.py:34 + :47", 0.0, ms,
                                    plain_ms, bound, by, lib_ms)
    entry["launches"] = launches["bfloat16"]
    return entry


_LAUNCH_RULES = {  # op type: (wrapper, the slot whose var's dtype it runs)
    "fused_attention": ("causal_prefill_attention", "Q"),
    "fused_attention_grad": ("attention_backward", "Q"),
    "layer_norm": ("layer_norm_act", "X"),
    "layer_norm_grad": ("layer_norm_act_backward", "X"),
    "softmax_with_cross_entropy": ("softmax_xent_fwd", "Logits"),
    "softmax_with_cross_entropy_grad": ("softmax_xent_bwd", "Logits"),
    "batch_norm": ("bn_apply_act", "Y"),
    "conv2d_bn": ("bn_apply_act", "Y"),
    "batch_norm_grad": ("bn_apply_act_backward", "Y"),
    "conv2d_bn_grad": ("bn_apply_act_backward", "Y")}
_FLASH = {"fused_attention": "flash_attention_fwd",
          "fused_attention_grad": "flash_attention_backward"}


def _launch_of(op_type, op, block):
    """(wrapper, dtype) that `op` (read as an op of `op_type`: its own
    type, or its grad's, on the forward op's slots) launches, or None."""
    if op_type not in _LAUNCH_RULES or _composed(op, block):
        return None
    wrapper, slot = _LAUNCH_RULES[op_type]
    if op_type in _FLASH and block.var(op.inputs["Q"][0]).shape[2] > 512:
        wrapper = _FLASH[op_type]         # past S = 512: K10 and K11
    if slot != "Y":
        name = op.inputs[slot][0]
    elif "Y" in op.outputs:
        name = op.outputs["Y"][0]
    else:     # a norm's grad op: the dtype of the forward's Y
        name = op.inputs["Y@GRAD"][0][:-len("@GRAD")]
    return wrapper, block.var(name).dtype.value


def _expected_launches(program):
    """{wrapper: {dtype: launches}} one run of `program` makes, from its
    ops and the dtypes of their vars. An op of a recompute segment runs in
    the forward and again in the replay of `recompute_grad`, where its
    autograd.Function's backward launches its grad's kernel once. A batch
    norm's grad op that the data- or sequence-parallel rewrite synced
    (`dp_sync`, `sp_sync`) runs K9's split mode: one sums and one chain
    launch."""
    block = program.global_block
    want: dict = {}

    def add(hit, times=1):
        if hit is not None:
            wrapper, dt = hit
            want.setdefault(wrapper, {})
            want[wrapper][dt] = want[wrapper].get(dt, 0) + times

    for op in block.ops:
        if op.type == "recompute":
            sub = program.blocks[op.attr("sub_block")]
            for sop in sub.ops:
                add(_launch_of(sop.type, sop, sub), 2)
                add(_launch_of(sop.type + "_grad", sop, sub))
        elif (getattr(op, "dp_sync", None) is not None or
              getattr(op, "sp_sync", None) is not None) and \
                op.type.endswith("_grad"):
            _, dt = _launch_of(op.type, op, block)
            add(("bn_apply_act_backward_sums", dt))
            add(("bn_apply_act_backward_chain", dt))
        else:
            add(_launch_of(op.type, op, block))
    return want


def _composed(op, block):
    """True for the ops that take the JAX package's XLA arm, composed in
    torch, and launch no kernel: a cross entropy with soft labels or
    ignore_index, an attention with a Bias or Sq != Sk."""
    if op.type.startswith("softmax_with_cross_entropy"):
        return op.attr("soft_label", False) or op.attr("ignore_index", -100) >= 0
    if op.type.startswith("fused_attention"):
        return ("Bias" in op.inputs or block.var(op.inputs["Q"][0]).shape[2]
                != block.var(op.inputs["K"][0]).shape[2])
    return False


def _check_launches(program, what):
    from paddle_tpu_torch.ops import cuda_kernels as ck

    got = {k: v for k, v in ck.launch_counts_by_dtype().items() if v}
    want = _expected_launches(program)
    if got != want:
        raise RuntimeError(f"{what}: launches by dtype {got}, the program's "
                           f"ops say {want}")
    return got


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm()) / max(float(b.float().norm()),
                                                       1e-30)


# Each bf16 gradient is held against the oracle of the same cast scheme in
# relative L2 (the elementwise spread of two bf16 computations is that of
# their rounding, not of the algorithm): within twice the distance bf16
# itself puts between that oracle and the fp32 oracle of the same weights
# and relu decisions, plus 2e-2 (the two round the backward at different
# places: the kernels' P and dS, K9's dx), and never beyond AMP_GRAD_CAP,
# so that a gradient zeroed (1 from the oracle's) or negated (2) is refused
AMP_GRAD_BAND = (2.0, 2e-2)
AMP_GRAD_CAP = 0.25
# the loss likewise: within twice the bf16 oracle's distance from the fp32
# oracle's plus 5e-3 of it (bf16 per-token or per-image losses averaged in
# fp32)
AMP_LOSS_RTOL = 5e-3


def _hold_amp_loss(what, loss, bf_loss, fp_loss):
    lim = 2 * abs(bf_loss - fp_loss) + AMP_LOSS_RTOL * abs(bf_loss)
    if not abs(loss - bf_loss) <= lim:
        raise RuntimeError(f"{what} step-1 loss {loss} vs the bf16 oracle's "
                           f"{bf_loss} (fp32 oracle {fp_loss}; limit {lim:.3e})")
    return lim


def _amp_grads_beyond(grads, bf_grads, limits):
    """[(distance, limit, name)] of the gradients beyond their limits."""
    rows = ((_rel_l2(grads[n], bf_grads[n]), lim, n) for n, lim in limits.items())
    return sorted(r for r in rows if not r[0] <= r[1])


def _hold_amp_grads(names, grads, bf_grads, fp_grads):
    """Every gradient within its limit (AMP_GRAD_BAND, AMP_GRAD_CAP); then
    the planted controls: the gradient with the largest limit, zeroed and
    negated, must each be refused. Returns (worst distance, its limit, the
    largest limit)."""
    k, c = AMP_GRAD_BAND
    bf, fp = dict(zip(names, bf_grads)), dict(zip(names, fp_grads))
    d_ref = {n: _rel_l2(bf[n], fp[n]) for n in names}
    limits = {n: min(k * d_ref[n] + c, AMP_GRAD_CAP) for n in names}
    rows = sorted((_rel_l2(grads[n], bf[n]), n) for n in names)
    print("  farthest gradients (relative L2 from the bf16 oracle, the bf16 "
          "oracle's from the fp32 one): " + "; ".join(
              f"{n} {d:.3e} ({d_ref[n]:.3e})" for d, n in rows[-5:]))
    bad = _amp_grads_beyond(grads, bf, limits)
    if bad:
        d, lim, n = bad[-1]
        raise RuntimeError(f"{len(bad)} gradients beyond their limits, e.g. "
                           f"{n}@GRAD: {d:.3e} from the bf16 oracle in "
                           f"relative L2, limit {lim:.3e} (the bf16 oracle "
                           f"is {d_ref[n]:.3e} from the fp32 one)")
    top = max(limits, key=limits.get)
    for plant, g in (("zeroed", torch.zeros_like(grads[top])),
                     ("negated", -grads[top])):
        if not _amp_grads_beyond({top: g}, bf, {top: limits[top]}):
            raise RuntimeError(f"the gradient gate passed {top}@GRAD {plant}")
    worst, n = rows[-1]
    return worst, limits[n], limits[top]


# Adam's epsilon as step 1 sees it: 1e-8 / sqrt(1 - beta2); where |g| is
# past 30 of it, the first update is lr sign(g) to 3%
ADAM_EPS_HAT = 1e-8 / (1 - 0.999) ** 0.5


def _hold_adam_step1(scope, names, p0, grads, ref_grads):
    """The port's fp32 master weights after one Adam(TRAIN_LR) step against
    the formula on its own fp32 gradient (every element), and on the
    oracle's where the oracle's gradient is at least a fifth of its
    max-abs (its sign is then sure) and past 30 ADAM_EPS_HAT (the update
    is then lr sign(g): nearer Adam's epsilon it moves with the gradient's
    bf16 spread), within 1e-2 lr. Returns (the error on the port's
    gradients, on the oracle's, the elements of sure sign, a note on the
    elements that ADAM_EPS_HAT left out)."""
    lr_t = TRAIN_LR * (1 - 0.999) ** 0.5 / (1 - 0.9)

    def adam_step1(g):
        return lr_t * (0.1 * g / (torch.sqrt(0.001 * g * g) + 1e-8))

    own_err = ref_err = 0.0
    n_sure, n_near, worst, least = 0, 0, "", (float("inf"), "")
    for n, rg in zip(names, ref_grads):
        p1 = scope.find_var(n)
        if p1.dtype != torch.float32 or grads[n].dtype != torch.float32:
            raise RuntimeError(f"{n}: master weight {p1.dtype}, gradient "
                               f"{grads[n].dtype}: both must be fp32")
        own_err = max(own_err, float((p1 - (p0[n] - adam_step1(grads[n])))
                                     .abs().max()))
        a = rg.abs()
        least = min(least, (float(a.max()), n))
        sure = (a > 0.2 * a.max()) & (a > 30 * ADAM_EPS_HAT)
        n_sure += int(sure.sum())
        n_near += int((a > 0.2 * a.max()).sum()) - int(sure.sum())
        if bool(sure.any()):
            d = (p1 - (p0[n] - adam_step1(rg)))[sure].abs()
            if float(d.max()) > ref_err:
                i = int(d.argmax())
                ref_err = float(d.max())
                worst = (f"{n}, where the oracle's gradient is "
                         f"{float(rg[sure][i]):.3e} and the port's "
                         f"{float(grads[n][sure][i]):.3e} (max-abs "
                         f"{float(a.max()):.3e})")
    if not max(own_err, ref_err) <= 1e-2 * TRAIN_LR:
        raise RuntimeError(f"AMP step-1 parameters differ from the Adam step "
                           f"by {own_err:.3e} on the port's gradients and "
                           f"{ref_err:.3e} on the oracle's, at {worst} "
                           f"(limit 1e-2 lr)")
    note = (f"{n_near} elements within 30 of Adam's epsilon left out, the "
            f"smallest gradient max-abs {least[0]:.3e} ({least[1]})")
    return own_err, ref_err, n_sure, note


def _bert_amp_oracle(P, feed, cfg, ln_names, low):
    """The BERT pretrain loss in plain torch under the AMP program's cast
    scheme (low = bfloat16): every product on bf16 views of the fp32
    weights, the bias adds, the residual stream and gelu in bf16, the layer
    norms with fp32 statistics (the first one, on the fp32 embedding sum,
    in fp32), fp32 attention scores and softmax with the unnormalized
    weights rounded to bf16 before they multiply V, the per-token loss from
    an fp32 log-softmax rounded to bf16, weighted in bf16 and averaged in
    fp32; each layer's attention checkpointed. low = float32 is the same
    model in fp32."""
    import torch.nn.functional as F

    H, nh = cfg.hidden_size, cfg.num_heads
    dh = H // nh
    lns = iter(ln_names)
    c = lambda t: t.to(low)  # noqa: E731

    def fc(x, pre):
        return x @ c(P[pre + ".w"]) + c(P[pre + ".b"])

    def ln(x):
        sn, bn = next(lns)
        return F.layer_norm(x.float(), (H,), c(P[sn]).float(),
                            c(P[bn]).float(), 1e-5).to(low)

    def attention(q, k, v):
        s = (q.float() @ k.float().transpose(-1, -2)) * dh ** -0.5
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        return ((c(e).float() @ v.float()) / e.sum(dim=-1, keepdim=True)).to(low)

    ids, pos = feed["src_ids"].long(), feed["pos_ids"].long()
    sn, bn = next(lns)
    x = c(F.layer_norm(P["encoder.word_emb"][ids] + P["encoder.pos_emb"][pos],
                       (H,), P[sn], P[bn], 1e-5))
    B, S = ids.shape
    for i in range(cfg.num_layers):
        pre = f"encoder.layer{i}"
        qkv = fc(x, pre + ".mha.qkv").reshape(B, S, 3, nh, dh)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        a = _checkpointed(attention, q, k, v)
        x = ln(x + fc(a.transpose(1, 2).reshape(B, S, H), pre + ".mha.out"))
        f = fc(F.gelu(fc(x, pre + ".ffn.in")), pre + ".ffn.out")
        x = ln(x + f)
    logp = torch.log_softmax(fc(x, "lm_head").float(), dim=-1)
    tok = c(-logp.gather(-1, feed["lm_label"].long()[..., None])[..., 0])
    w = feed["lm_weight"]
    return (tok * c(w)).float().sum() / (w.sum() + 1e-6)


def _bert_amp_program(cfg, S, make_optimizer):
    """(main, startup, avg_loss): bert_pretrain(cfg, seq S) +
    decorate(make_optimizer()).minimize through the port's entry points,
    the optimizer (and its schedule) built inside the programs' guard."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.contrib import mixed_precision as amp
    from paddle_tpu_torch.models import transformer

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        avg_loss, _ = transformer.bert_pretrain(cfg, seq_len=S)
        amp.decorate(make_optimizer()).minimize(avg_loss)
    startup.random_seed = SEED
    return main, startup, avg_loss


def train_bert_amp(dev, card, B=AMP_B, S=AMP_S, flash=False, keep=False):
    """bench.py:75-81's configuration: bert_pretrain(BERT-base, seq 128) +
    decorate(Adam(1e-4)), B=128, one seeded batch, through the port's entry
    points; with B, S and flash = True, tools/_sweep.py's long-context run.
    Step 1 against the bf16 oracle of the same cast scheme (loss, every
    gradient in relative L2, the Adam update), launches by dtype from the
    program's vars, then 5 timed steps whose loss must fall. keep = True
    also returns step 1's start and results for the recompute phase:
    {"p0", "feed", "loss1", "grads", "mem"} (mem: the device memory
    allocated before the step and its peak during it)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda_kernels as ck

    what = f"BERT-base AMP B={B} S={S}"
    cfg = _bert_cfg(S, flash)
    main, startup, avg_loss = _bert_amp_program(
        cfg, S, lambda: pt.optimizer.Adam(learning_rate=TRAIN_LR))
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    names = [p.name for p in main.all_parameters()]
    ops = [op.type for op in main.global_block.ops]
    print(f"AMP trainer: {what} bf16 (decorate(Adam({TRAIN_LR})), "
          f"use_flash_attention={flash}, max_position={cfg.max_position}), "
          f"{len(ops)} ops a step, {ops.count('cast')} casts [{card}]")
    feed = _bert_feed(cfg, B, S)
    p0 = {n: scope.find_var(n).clone() for n in names}

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    mem = _step_memory()
    t0 = time.perf_counter()
    out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                  fetch_list=[avg_loss] + [n + "@GRAD" for n in names])
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    mem = mem()
    counts = _check_launches(main, what)
    loss1, grads = out[0], dict(zip(names, out[1:]))
    del out

    ln_names = [(op.inputs["Scale"][0].split("@")[0],
                 op.inputs["Bias"][0].split("@")[0])
                for op in main.global_block.ops if op.type == "layer_norm"]
    fd = {k: torch.from_numpy(v).to(dev) for k, v in feed.items()}
    ref = {}
    torch.cuda.reset_peak_memory_stats()
    for low in (torch.bfloat16, torch.float32):
        P = {n: t.clone().requires_grad_() for n, t in p0.items()}
        lv = _bert_amp_oracle(P, fd, cfg, ln_names, low)
        ref[low] = (float(lv.detach()),
                    torch.autograd.grad(lv, [P[n] for n in names]))
        del P, lv
    peak = torch.cuda.max_memory_allocated() / 2**30
    ref_loss, ref_grads = ref[torch.bfloat16]
    loss_lim = _hold_amp_loss(what, float(loss1), ref_loss,
                              ref[torch.float32][0])
    worst, lim, top = _hold_amp_grads(names, grads, ref_grads,
                                      ref[torch.float32][1])
    own_err, ref_err, n_sure, note = _hold_adam_step1(scope, names, p0,
                                                      grads, ref_grads)
    print(f"{what} step 1 ({first:.3f} s): loss {float(loss1):.6f}, bf16 oracle "
          f"{ref_loss:.6f}, fp32 oracle {ref[torch.float32][0]:.6f} (limit "
          f"{loss_lim:.3e}); worst gradient {worst:.3e} from the "
          f"bf16 oracle in relative L2 (its limit {lim:.3e}; the largest "
          f"limit {top:.3e}, where a planted zeroed and negated gradient "
          f"were refused); fp32 master weights "
          f"within {own_err:.3e} of the Adam step on the port's gradients and "
          f"{ref_err:.3e} on the oracle's ({n_sure} elements of sure sign, "
          f"{note}; limit 1e-2 lr); launches by dtype {counts}; peak device "
          f"memory with the oracles {peak:.2f} GiB; the step's own: "
          f"{mem[0] / 2**30:.3f} GiB allocated before it, peak "
          f"{mem[1] / 2**30:.3f} GiB")
    kept = (dict(p0=p0, feed=feed, loss1=loss1, grads=grads, mem=mem)
            if keep else None)
    del ref, ref_grads, grads

    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        (lv,) = exe.run(main, feed=feed, scope=scope, fetch_list=[avg_loss],
                        return_numpy=False)
        losses.append(lv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(lv) for lv in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < float(loss1):
        raise RuntimeError(f"the AMP loss did not fall: step 1 "
                           f"{float(loss1)}, then {losses}")
    tokens = B * S
    step_flops = _bert_step_flops(cfg, B, S)
    print(f"{what} trained {TRAIN_STEPS} steps in {wall:.3f} s: "
          f"{TRAIN_STEPS / wall:.3f} steps/s, {TRAIN_STEPS * tokens / wall:.1f} "
          f"tokens/s, {TRAIN_STEPS * step_flops / wall / 1e12:.2f} model "
          f"TFLOP/s ({step_flops / 1e12:.3f} TFLOP a step); losses "
          f"{[round(x, 5) for x in losses]} [{card}]")
    step = lambda: exe.run(main, feed=feed, scope=scope,  # noqa: E731
                           fetch_list=[avg_loss], return_numpy=False)
    if keep:
        return step, counts, kept
    return step, counts


# The tuned long-context phase: bench.py:137 bench_bert_long's shape,
# BERT-base masked-LM pretraining at S = 512, B = 64, bf16 AMP with Adam,
# whose attention (bf16 [64, 12, 512, 64]) both of the port's routes run:
# K2/K4 ("pallas_short", the analytic prior at S <= 512) and K10/K11
# ("flash_bundled"). The tuner probes the key in explore mode and the
# consult steps run on its verdict.
TUNED_EXPLORE = 2          # explore-mode steps; the probe runs after the last
TUNED_STEPS = 3            # timed steps of each route
TUNED_PAIRS = {"pallas_short": ("causal_prefill_attention",
                                "attention_backward"),
               "flash_bundled": ("flash_attention_fwd",
                                 "flash_attention_backward")}
TUNED_FLAGS = ("tuning_mode", "tuning_db", "tuning_explore_every",
               "attention_force_backend")


def _tuner_reset():
    from paddle_tpu_torch import tuning

    tuning.invalidate_db_cache()
    tuning.reset_provenance()
    tuning.policy._seen_candidates.clear()
    tuning.learned.invalidate_model_cache()
    tuning.learned.explore.reset_state()


def _tuned_launches(program, route, steps):
    """{wrapper: {dtype: launches}} of `steps` runs of `program` with its
    attention on `route`'s pair (`_expected_launches` gives K2/K4 at
    S <= 512)."""
    want = {}
    for w, by in _expected_launches(program).items():
        if route == "flash_bundled" and w in TUNED_PAIRS["pallas_short"]:
            w = TUNED_PAIRS[route][TUNED_PAIRS["pallas_short"].index(w)]
        want[w] = {d: n * steps for d, n in by.items()}
    return want


def _probe_launches():
    """{wrapper: {"bfloat16": launches}} of one explore probe of the bf16
    attention key: each arm's pair runs its warm-up call and
    EXPLORE_PASSES windows of EXPLORE_ITERS calls."""
    from paddle_tpu_torch.tuning.learned import explore

    n = 1 + explore.EXPLORE_PASSES * explore.EXPLORE_ITERS
    return {w: {"bfloat16": n} for pair in TUNED_PAIRS.values() for w in pair}


def _check_tuned_launches(what, counts, want):
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        raise RuntimeError(f"{what}: launches by dtype {got}, the program's "
                           f"ops on the verdict's route say {want}")


def _grad_writers(program, names):
    """{name: the op types of `program` that write a var of name's
    gradient (name@GRAD, or a renamed part of it that a sum adds)}."""
    ops = program.global_block.ops
    return {n: sorted({op.type for op in ops for v in op.output_names
                       if v.startswith(n + "@GRAD")}) for n in names}


def _scope_tensors(scope):
    return {n: scope.find_var(n).clone() for n in scope.var_names()
            if isinstance(scope.find_var(n), torch.Tensor)}


def _hold_routes(what, a, b):
    """Two steps from one state, (loss, {param: grad}) each, within the AMP
    bands' floors: the losses within AMP_LOSS_RTOL of each other, every
    gradient within AMP_GRAD_BAND's 2e-2 in relative L2 (the part of the
    band that covers two kernels rounding P and dS at different places).
    Returns (loss distance, worst gradient distance, its name, the names of
    the gradients that differ in any bit, and "loss" first if the losses
    do)."""
    (la, ga), (lb, gb) = a, b
    dl = abs(la - lb)
    if not dl <= AMP_LOSS_RTOL * abs(lb):
        raise RuntimeError(f"{what}: losses {la} and {lb} differ by {dl:.3e} "
                           f"(limit {AMP_LOSS_RTOL * abs(lb):.3e})")
    worst = max((_rel_l2(ga[n], gb[n]), n) for n in gb)
    if not worst[0] <= AMP_GRAD_BAND[1]:
        raise RuntimeError(f"{what}: gradient {worst[1]} {worst[0]:.3e} apart "
                           f"in relative L2 (limit {AMP_GRAD_BAND[1]})")
    differ = ([] if la == lb else ["loss"]) + sorted(
        n for n in gb if not _same_bits(ga[n], gb[n]))
    return dl, worst[0], worst[1], differ


def tuned_bert_long(dev, card):
    """bench.py:137's BERT-base AMP step (B = 64, S = 512, Adam) through
    the port's entry points with the tuner on, its DB under SMOKE_DATA:
    (1) TUNED_EXPLORE `run_async` steps in explore mode: the first run
    resolves the attention key analytically (K2/K4) and records it as a
    candidate, and the last step's window drain probes it on the card
    (both routes, forward + backward); (2) `invalidate_cache()`, consult
    mode: one held step, then TUNED_STEPS timed, every launch on the
    verdict's pair (a tie keeps K2/K4) and none on the other; (3) each
    route forced by FLAGS_attention_force_backend for one step from the
    consult step's start, the two held against each other and the consult
    step against its verdict's arm (`_hold_routes`), then TUNED_STEPS timed
    and one traced. Prints the phase's wall time. Returns the launches by
    wrapper and dtype of its training steps, and those of the probe."""
    import os

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import flags, tuning
    from paddle_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    B, S = TUNED_B, TUNED_S
    what = f"tuned BERT-base AMP B={B} S={S}"
    cfg = _bert_cfg(S)
    main, startup, avg_loss = _bert_amp_program(
        cfg, S, lambda: pt.optimizer.Adam(learning_rate=TRAIN_LR))
    exe, scope = pt.Executor(place=dev), pt.Scope()
    exe.run(startup, scope=scope)
    names = [p.name for p in main.all_parameters()]
    fetch = [avg_loss] + [n + "@GRAD" for n in names]
    feed = _bert_feed(cfg, B, S)
    db_path = os.path.join(_smoke_dir("tuning"), "db.json")
    saved = {k: flags.get_flag(k) for k in TUNED_FLAGS}
    acc, probe = {}, _probe_launches()

    def run_steps(n):
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            exe.run_async(main, feed=feed, fetch_list=[avg_loss], scope=scope)
        exe.wait()
        _sync(dev)
        return (time.perf_counter() - t0) / n

    def held_step():
        out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                      fetch_list=fetch)
        return float(out[0]), dict(zip(names, out[1:]))

    flags.set_flags({"tuning_mode": "explore", "tuning_db": db_path,
                     "tuning_explore_every": TUNED_EXPLORE,
                     "attention_force_backend": ""})
    _tuner_reset()
    try:
        ck.reset_launch_counts()
        run_steps(TUNED_EXPLORE)
        counts = ck.launch_counts_by_dtype()
        # the explore steps run the prior's pair (K2/K4) and the last one's
        # window drain the probe: the steps' launches are the rest
        want = _tuned_launches(main, "pallas_short", TUNED_EXPLORE)
        _add_counts(want, probe)
        _check_tuned_launches(f"{what} explore", counts, want)
        _add_counts(acc, {w: {d: n - probe.get(w, {}).get(d, 0)
                              for d, n in by.items()}
                          for w, by in counts.items()})
        explored = tuning.provenance_snapshot()["per_op"]
        db = tuning.TuningDB(db_path)
        keys = [k for k in db.entries if k.startswith("attention|")]
        if len(keys) != 1 or "measured" not in db.entries[keys[0]]:
            raise RuntimeError(f"{what}: explore mode left {db.entries}; "
                               f"want one probed attention entry")
        key, entry = keys[0], db.entries[keys[0]]
        arms = entry["measured"]
        band = max([tuning.learned.explore.EXPLORE_BAND]
                   + [m.get("band", 0.0) for m in arms.values()])
        swept = entry["source"] == "swept"
        verdict = (re.search(r"verdict=(\w+)", entry["note"]).group(1)
                   if swept else "tie")
        route = entry["decision"]["backend"] if swept else "pallas_short"
        if set(arms) != set(TUNED_PAIRS) or route not in TUNED_PAIRS:
            raise RuntimeError(f"{what}: the probe of {key} gave {entry}")
        print(f"{what}: explore steps resolved {explored} and probed {key}: "
              + ", ".join(f"{a} {1e3 * m['median_s']:.4f} ms (band "
                          f"{m.get('band', 0.0)})" for a, m in sorted(
                              arms.items()))
              + f" a forward + backward (the median of "
              f"{tuning.learned.explore.EXPLORE_PASSES} windows of "
              f"{tuning.learned.explore.EXPLORE_ITERS} calls); interference "
              f"band {band}; verdict {verdict}: the DB entry is "
              f"{json.dumps(entry, sort_keys=True)} [{card}]")

        flags.set_flags({"tuning_mode": "consult"})
        exe.invalidate_cache()
        tuning.reset_provenance()
        start = _scope_tensors(scope)
        ck.reset_launch_counts()
        mem = _step_memory() if dev.type == "cuda" else None
        consult = held_step()
        peak = mem()[1] / 2**30 if mem else float("nan")
        consult_ms = 1e3 * run_steps(TUNED_STEPS)
        counts = ck.launch_counts_by_dtype()
        _add_counts(acc, counts)
        prov = tuning.provenance_snapshot()
        want_tier = "db" if swept else "analytic"
        if prov["per_op"].get("attention", {}).get(want_tier) != 1 \
                or prov["decisions"] != 1:
            raise RuntimeError(f"{what}: consult provenance {prov}, want one "
                               f"attention decision from the {want_tier} tier")
        _check_tuned_launches(f"{what} consult", counts,
                              _tuned_launches(main, route, 1 + TUNED_STEPS))
        print(f"{what}: consult on {route} ({verdict}): provenance {prov}; "
              f"{consult_ms:.1f} ms a step over {TUNED_STEPS} steps; step 1 "
              f"loss {consult[0]:.6f}, peak device memory {peak:.2f} GiB; "
              f"launches by dtype {_launched(counts)} [{card}]")

        held, timing = {}, {}
        for r in TUNED_PAIRS:
            flags.set_flags({"attention_force_backend": r})
            exe.invalidate_cache()
            for n, t in start.items():
                scope.set_var(n, t.clone())
            ck.reset_launch_counts()
            held[r] = held_step()
            step_ms = 1e3 * run_steps(TUNED_STEPS)
            busy = (_profile(lambda: run_steps(1), card,
                             f"{what}, attention forced to {r}")
                    if dev.type == "cuda" else None)
            counts = ck.launch_counts_by_dtype()
            _add_counts(acc, counts)
            steps = 2 + TUNED_STEPS if busy is not None else 1 + TUNED_STEPS
            _check_tuned_launches(f"{what} forced {r}", counts,
                                  _tuned_launches(main, r, steps))
            timing[r] = (step_ms, busy)
        flags.set_flags({"attention_force_backend": ""})
        dl, dg, gname, _ = _hold_routes(f"{what}: K2/K4 vs K10/K11",
                                        held["pallas_short"],
                                        held["flash_bundled"])
        # the consult step and the forced step of its verdict's route run
        # the same kernels from the same state: what differs between them
        # is what does not repeat on the card
        cl, cg, _, differ = _hold_routes(f"{what}: consult vs {route}",
                                         consult, held[route])
        for r, (ms, busy) in timing.items():
            share = "not measured" if busy is None else f"{100 * busy:.1f}%"
            print(f"{what}: forced {r}: {ms:.1f} ms a step over "
                  f"{TUNED_STEPS} steps ({B * S * 1e3 / ms:.0f} tokens/s), "
                  f"device busy {share} of a traced step [{card}]")
        print(f"{what}: K2/K4 and K10/K11 from one state: losses "
              f"{held['pallas_short'][0]:.6f} / {held['flash_bundled'][0]:.6f} "
              f"({dl:.3e} apart, limit {AMP_LOSS_RTOL} of the loss), worst "
              f"gradient {gname} {dg:.3e} in relative L2 (limit "
              f"{AMP_GRAD_BAND[1]}); the consult step against forced {route}: "
              f"loss {cl:.3e}, worst gradient {cg:.3e} apart; what differs "
              f"in any bit between these two runs of one route, with the "
              f"ops that write it: {_grad_writers(main, differ)}; no gain "
              f"is claimed [{card}]")
        print(f"{what}: the phase took {time.perf_counter() - t_phase:.1f} s "
              f"of wall time [{card}]")
    finally:
        flags.set_flags(saved)
        _tuner_reset()
    return acc, probe


def _step_memory():
    """Start a measurement of one step's device memory; the returned
    function ends it: (bytes allocated at the start, the peak since)."""
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    return lambda: (base, torch.cuda.max_memory_allocated())


# The LAMB phase: BERT's LAMB recipe (You et al., "Large Batch Optimization
# for Deep Learning: Training BERT in 76 Minutes", 2019) on the BERT AMP
# step: linear warmup from LAMB_START_LR to LAMB_LR over LAMB_WARMUP runs,
# then polynomial (power 1) decay to 0 at run LAMB_DECAY, weight decay
# LAMB_WD; LAMB_STEPS runs cross from warmup into decay. LAMB_START_LR is
# not 0: at 0 the first step would move no weight, and the step-1 hold
# would see nothing.
LAMB_LR, LAMB_START_LR, LAMB_WARMUP, LAMB_DECAY = 1e-4, 2e-5, 2, 6
LAMB_WD, LAMB_EPS, LAMB_STEPS = 0.01, 1e-6, 5


def _lamb_lr(step):
    """The schedule's closed form at run `step` (from 0)."""
    if step < LAMB_WARMUP:
        return LAMB_START_LR + (LAMB_LR - LAMB_START_LR) * step / LAMB_WARMUP
    return LAMB_LR * (1 - min(step, LAMB_DECAY) / LAMB_DECAY)


def _hold_lamb_step1(scope, names, p0, grads, lr0):
    """After step 1 each fp32 master weight against the LAMB formula on
    the port's own fp32 gradient, in float64, on every element: p0 - lr0
    trust r, r = m^ / (sqrt(v^) + eps) + wd p0 (the moments from zero, the
    beta powers at their fp32 initial values), trust = |p0| / |r| or 1
    where either norm is 0 (the zero biases), within 1e-2 of that
    parameter's own step lr0 trust: a weight matrix's trust is about 0.02,
    so a limit in units of lr would see nothing. Returns (the worst error
    in units of its step, its parameter, (least trust, its parameter),
    (largest trust, its parameter))."""
    b1p, b2p = float(np.float32(0.9)), float(np.float32(0.999))
    worst, at, trusts = 0.0, "", []
    for n in names:
        p1 = scope.find_var(n)
        if p1.dtype != torch.float32 or grads[n].dtype != torch.float32:
            raise RuntimeError(f"{n}: master weight {p1.dtype}, gradient "
                               f"{grads[n].dtype}: both must be fp32")
        p, g = p0[n].double(), grads[n].double()
        r = ((1 - 0.9) * g / (1 - b1p)) / (torch.sqrt(
            (1 - 0.999) * g * g / (1 - b2p)) + LAMB_EPS) + LAMB_WD * p
        pn, rn = float(p.norm()), float(r.norm())
        trust = pn / rn if pn > 0 and rn > 0 else 1.0
        step = lr0 * trust
        err = float((p1.double() - (p - step * r)).abs().max()) / step
        trusts.append((trust, n))
        if err > worst:
            worst, at = err, n
        del p, g, r
    if not worst <= 1e-2:
        raise RuntimeError(f"LAMB step-1 weights differ from the formula by "
                           f"{worst:.3e} of the step at {at} (limit 1e-2)")
    return worst, at, min(trusts), max(trusts)


def _range_ops(types, name):
    """Wrap the computes of the ops `types` in the profiler range `name`;
    returns the function that unwraps them."""
    from paddle_tpu_torch.ops.registry import get_op_def

    saved = {t: get_op_def(t).compute for t in types}
    for t, plain in saved.items():
        get_op_def(t).compute = ranged(plain, name)

    def undo():
        for t, c in saved.items():
            get_op_def(t).compute = c
    return undo


def train_bert_lamb(dev, card):
    """train_bert_amp's configuration (bench.py:75-81: BERT-base, bf16 AMP,
    B=128, S=128, one seeded batch) through the port's entry points, the
    optimizer decorate(Lamb(linear_lr_warmup(polynomial_decay(...)))):
    LAMB_STEPS runs, the learning rate fetched each run against its closed
    form (1e-6 relative), step 1's fp32 master weights against the LAMB
    formula (_hold_lamb_step1), every beta power after the last run equal
    to beta^(LAMB_STEPS + 1) as fp32 computes it, the loss finite at every
    run, and step 1's launches by dtype from the program's vars. Returns
    (a step callable, the launches)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.ops import cuda_kernels as ck

    what = f"BERT-base AMP LAMB B={AMP_B} S={AMP_S}"
    cfg = _bert_cfg(AMP_S)

    def lamb():
        lr = L.linear_lr_warmup(
            L.polynomial_decay(LAMB_LR, decay_steps=LAMB_DECAY,
                               end_learning_rate=0.0, power=1.0),
            warmup_steps=LAMB_WARMUP, start_lr=LAMB_START_LR, end_lr=LAMB_LR)
        return pt.optimizer.Lamb(learning_rate=lr, lamb_weight_decay=LAMB_WD,
                                 epsilon=LAMB_EPS)

    main, startup, avg_loss = _bert_amp_program(cfg, AMP_S, lamb)
    updates = [op for op in main.global_block.ops if op.type == "lamb"]
    lr_name = updates[0].inputs["LearningRate"][0]
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    names = [p.name for p in main.all_parameters()]
    n_elems = sum(scope.find_var(n).numel() for n in names)
    n_ops = len(main.global_block.ops)
    adam_ops = len(_bert_amp_program(cfg, AMP_S, lambda: pt.optimizer.Adam(
        learning_rate=TRAIN_LR))[0].global_block.ops)
    print(f"LAMB trainer: {what} bf16 (decorate(Lamb(linear_lr_warmup("
          f"polynomial_decay({LAMB_LR}, {LAMB_DECAY}, 0, 1), {LAMB_WARMUP}, "
          f"{LAMB_START_LR}, {LAMB_LR}), weight decay {LAMB_WD}))): "
          f"{n_ops} ops a step against the Adam step's {adam_ops} "
          f"({len(updates)} lamb ops), {len(names)} parameters of "
          f"{n_elems} elements [{card}]")
    feed = _bert_feed(cfg, AMP_B, AMP_S)
    p0 = {n: scope.find_var(n).clone() for n in names}

    ck.reset_launch_counts()
    out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                  fetch_list=[avg_loss, lr_name] + [n + "@GRAD" for n in names])
    counts = _check_launches(main, what)
    fetched = [(out[0], out[1])]
    worst, at, least, most = _hold_lamb_step1(
        scope, names, p0, dict(zip(names, out[2:])), _lamb_lr(0))
    del out, p0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LAMB_STEPS - 1):
        fetched.append(exe.run(main, feed=feed, scope=scope,
                               fetch_list=[avg_loss, lr_name],
                               return_numpy=False))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(lv) for lv, _ in fetched]
    lrs = [float(lr[0]) for _, lr in fetched]
    want = [_lamb_lr(i) for i in range(LAMB_STEPS)]
    if not all(abs(a - b) <= 1e-6 * b for a, b in zip(lrs, want)):
        raise RuntimeError(f"{what}: learning rates {lrs}, the schedule's "
                           f"closed form {want}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{what}: a loss is not finite: {losses}")
    b1, b2 = torch.tensor([0.9]), torch.tensor([0.999])
    for _ in range(LAMB_STEPS):
        b1, b2 = b1 * 0.9, b2 * 0.999
    for op in updates:
        for slot, want_pow in (("Beta1Pow", b1), ("Beta2Pow", b2)):
            got = scope.find_var(op.inputs[slot][0]).cpu()
            if not torch.equal(got, want_pow):
                raise RuntimeError(f"{what}: {op.inputs[slot][0]} is "
                                   f"{got.tolist()}, beta^{LAMB_STEPS + 1} in "
                                   f"fp32 is {want_pow.tolist()}")
    print(f"{what}: learning rates {lrs} equal the closed form to 1e-6; "
          f"step-1 fp32 master weights within {worst:.3e} of their own step "
          f"of the LAMB formula (at {at}; limit 1e-2; trust from "
          f"{least[0]:.4e} ({least[1]}) to {most[0]:.4e} ({most[1]})); every "
          f"beta power beta^{LAMB_STEPS + 1} in fp32; launches by dtype "
          f"{counts}")
    print(f"{what} trained {LAMB_STEPS - 1} steps after step 1 in "
          f"{wall:.3f} s: {(LAMB_STEPS - 1) / wall:.3f} steps/s, "
          f"{(LAMB_STEPS - 1) * AMP_B * AMP_S / wall:.1f} tokens/s; "
          f"losses {[round(x, 5) for x in losses]} [{card}]")
    step = lambda: exe.run(main, feed=feed, scope=scope,  # noqa: E731
                           fetch_list=[avg_loss], return_numpy=False)
    return step, counts


# the optimizer check: the twelve optimizers and three wrappers on a tiny
# program, each under one schedule in turn; the ops that must dispatch with
# no host sync (the update ops and the schedules' ops)
OPT_CASES = ("sgd", "momentum", "adam", "dgc", "lars", "adagrad", "adamax",
             "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "lamb",
             "model_average", "lookahead", "ema")
OPT_SCHEDULES = ("noam", "cosine", "piecewise")
LR_SCHEDULES = ("noam", "exponential", "natural_exp", "inverse_time",
                "polynomial", "polynomial_cycle", "piecewise", "cosine",
                "warmup")
SYNC_FREE_OPS = ("sgd", "momentum", "adam", "adamax", "adagrad",
                 "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "lamb",
                 "lars_momentum", "dgc", "model_average_accum", "lookahead",
                 "increment", "floor", "ceil", "cos", "pow", "elementwise_pow",
                 "elementwise_min", "less_than", "piecewise_decay")
OPT_TOL = dict(rtol=1e-5, atol=1e-7)
DGC_SHAPE, DGC_SPARSITY = (30522, 768), 0.999   # BERT-base's word embedding


def _schedule(L, which):
    return {
        "noam": lambda: L.noam_decay(4096, 2),
        "exponential": lambda: L.exponential_decay(1e-2, 2, 0.5, True),
        "natural_exp": lambda: L.natural_exp_decay(1e-2, 2, 0.5),
        "inverse_time": lambda: L.inverse_time_decay(1e-2, 2, 0.5),
        "polynomial": lambda: L.polynomial_decay(1e-2, 5, 1e-4, power=2.0),
        "polynomial_cycle": lambda: L.polynomial_decay(1e-2, 3, 1e-4,
                                                       cycle=True),
        "piecewise": lambda: L.piecewise_decay([1, 2], [1e-2, 5e-3, 2e-3]),
        "cosine": lambda: L.cosine_decay(1e-2, 2, 4),
        "warmup": lambda: L.linear_lr_warmup(
            L.polynomial_decay(1e-2, 6, 0.0), 2, 2e-3, 1e-2),
    }[which]()


def _optimizer_program(case, schedule):
    """fc(8 -> 16, relu) -> fc(1) -> square error, B=16, under `case`;
    returns (main, startup, loss, the ModelAverage or EMA wrapper)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch import unique_name

    main, startup = pt.Program(), pt.Program()
    wrapper = None
    with pt.program_guard(main, startup), unique_name.guard():
        x = L.data(name="x", shape=[8], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        h = L.fc(x, size=16, act="relu")
        loss = L.mean(L.square_error_cost(L.fc(h, size=1), y))
        lr = _schedule(L, schedule)
        o = pt.optimizer
        {"sgd": lambda: o.SGD(lr), "momentum": lambda: o.Momentum(lr, 0.9),
         "adam": lambda: o.Adam(lr),
         "dgc": lambda: o.DGCMomentumOptimizer(
             lr, 0.9, rampup_begin_step=1, rampup_step=2, sparsity=[0.5, 0.9]),
         "lars": lambda: o.LarsMomentum(lr, 0.9),
         "adagrad": lambda: o.Adagrad(lr), "adamax": lambda: o.Adamax(lr),
         "decayed_adagrad": lambda: o.DecayedAdagrad(lr),
         "adadelta": lambda: o.Adadelta(lr),
         "rmsprop": lambda: o.RMSProp(lr, momentum=0.9),
         "ftrl": lambda: o.Ftrl(lr, l1=1e-3, l2=1e-3),
         "lamb": lambda: o.Lamb(lr),
         "model_average": lambda: o.Momentum(lr, 0.9),
         "lookahead": lambda: o.LookaheadOptimizer(o.Adam(lr), alpha=0.5,
                                                   k=2),
         "ema": lambda: o.SGD(lr)}[case]().minimize(loss)
        if case == "model_average":
            wrapper = o.ModelAverage(0.15, min_average_window=3,
                                     max_average_window=4)
        elif case == "ema":
            wrapper = o.ExponentialMovingAverage(0.9)
            wrapper.update()
    startup.random_seed = SEED
    return main, startup, loss, wrapper


def _sync_free(types, seen, mode="error"):
    """Run the computes of the ops `types` on CUDA under
    torch.cuda.set_sync_debug_mode(mode), counting the dispatches in
    `seen`: under "error" a host sync inside one raises, under "warn" each
    one is counted in `seen` under "<op> syncs". The mode is scoped to the
    op, since the executor's own copy of each host feed is a sync. Returns
    the function that unwraps them."""
    import warnings

    from paddle_tpu_torch.ops.registry import get_op_def

    saved = {t: get_op_def(t).compute for t in types}

    def wrap(t, plain):
        def compute(ctx):
            if ctx.device.type != "cuda":
                return plain(ctx)
            seen[t] = seen.get(t, 0) + 1
            if mode == "error":
                torch.cuda.set_sync_debug_mode(mode)
                try:
                    return plain(ctx)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode(mode)
                try:
                    return plain(ctx)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                    seen[f"{t} syncs"] = seen.get(f"{t} syncs", 0) + sum(
                        "synchroniz" in str(w.message) for w in caught)
        return compute

    for t, plain in saved.items():
        get_op_def(t).compute = wrap(t, plain)

    def undo():
        for t, c in saved.items():
            get_op_def(t).compute = c
    return undo


def _state_close(what, main, cuda_scope, cpu_scope):
    """Every persistable var of `main` on the card within OPT_TOL of the
    CPU's; returns the largest |card - CPU| in units of its limit, atol +
    rtol |CPU|."""
    worst = 0.0
    for v in main.global_block.vars.values():
        if not v.persistable:
            continue
        a = cuda_scope.find_var(v.name).cpu().double()
        b = cpu_scope.find_var(v.name).double()
        d = float(((a - b).abs() / (OPT_TOL["atol"] + OPT_TOL["rtol"]
                                    * b.abs())).max())
        if not d <= 1.0:
            raise RuntimeError(f"{what}: {v.name} on the card {a.flatten()[:4]} "
                               f"vs the CPU {b.flatten()[:4]}")
        worst = max(worst, d)
    return worst


def _check_dgc_bert(dev, card):
    """dgc once on a DGC_SHAPE fp32 gradient at DGC_SPARSITY, U and V
    random: the released entries exactly those at or past a float64
    sort-based quantile of |v| (jnp.quantile's linear interpolation,
    computed here), UOut and VOut their complements; and the op's time."""
    from paddle_tpu_torch.ops.registry import ExecContext, get_op_def

    gen = torch.Generator(device=dev).manual_seed(SEED)
    g, u, v = (torch.randn(DGC_SHAPE, generator=gen, device=dev) * s
               for s in (1.0, 0.1, 0.1))

    class Op:
        type, inputs, outputs = "dgc", {"Grad": ["g"], "U": ["u"],
                                        "V": ["v"]}, {}
        attrs = {"momentum": 0.9, "sparsity": DGC_SPARSITY}

    def run():
        return get_op_def("dgc").compute(
            ExecContext(Op, {"g": g, "u": u, "v": v}, dev))

    out = run()
    u1 = 0.9 * u + g
    v1 = v + u1
    a = torch.sort(v1.abs().reshape(-1).double()).values
    n = a.numel()
    pos = float(np.float32(DGC_SPARSITY)) * (n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    thr = float(np.float32(float(a[lo]) * (1 - (pos - lo))
                           + float(a[hi]) * (pos - lo)))
    keep = v1.abs() >= thr
    released = int((out["GradOut"] != 0).sum())
    if not (torch.equal(out["GradOut"], torch.where(keep, v1, 0))
            and torch.equal(out["VOut"], torch.where(keep, 0, v1))
            and torch.equal(out["UOut"], torch.where(keep, 0, u1))
            and released == int(keep.sum())):
        raise RuntimeError(f"dgc at {DGC_SHAPE}: released {released}, the "
                           f"float64 quantile's threshold {thr} releases "
                           f"{int(keep.sum())}")
    ms = _Timer(dev)(run, reps=5)
    print(f"dgc on a {list(DGC_SHAPE)} fp32 gradient ({n} elements, past "
          f"torch.quantile's 2^24) at sparsity {DGC_SPARSITY}: threshold "
          f"{thr:.6e} and {released} released entries equal the float64 "
          f"sort-based quantile's; {ms:.4f} ms a call [{card}]")


def check_optimizers(dev, card):
    """The optimizers and schedules on the card against the CPU in one
    process: each of OPT_CASES under one of OPT_SCHEDULES in turn, 3 steps
    from the same startup values (B=16), every persistable var within
    OPT_TOL, the wrappers' apply (the averages swapped in) and restore;
    each of LR_SCHEDULES alone over 8 runs, the learning rates within
    OPT_TOL; every op of SYNC_FREE_OPS dispatched under the sync debug mode
    "error" (no .item(), no bool() of a device tensor, no host quantile
    check); then _check_dgc_bert."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.weights import load_params, load_state

    seen: dict = {}
    undo = _sync_free(SYNC_FREE_OPS, seen)
    try:
        cpu, gpu = pt.Executor(place="cpu"), pt.Executor(place=dev)
        worst = 0.0
        for i, case in enumerate(OPT_CASES):
            sched = OPT_SCHEDULES[i % len(OPT_SCHEDULES)]
            what = f"{case} under {sched}"
            main, startup, loss, wrapper = _optimizer_program(case, sched)
            cs, gs = pt.Scope(), pt.Scope()
            cpu.run(startup, scope=cs)
            gpu.run(startup, scope=gs)
            block = main.global_block
            arrays = {v.name: cs.find_var(v.name).numpy()
                      for v in block.vars.values() if v.persistable}
            params = {p.name for p in main.all_parameters()}
            load_params(gs, main, {n: a for n, a in arrays.items()
                                   if n in params})
            load_state(gs, main, {n: a for n, a in arrays.items()
                                  if n not in params})
            rng = np.random.default_rng(SEED)
            for _ in range(3):
                feed = {"x": rng.standard_normal((16, 8)).astype(np.float32),
                        "y": rng.standard_normal((16, 1)).astype(np.float32)}
                (lc,) = cpu.run(main, feed=feed, fetch_list=[loss], scope=cs)
                (lg,) = gpu.run(main, feed=feed, fetch_list=[loss], scope=gs)
                if not np.allclose(lg, lc, rtol=1e-5):
                    raise RuntimeError(f"{what}: loss {lg} on the card, {lc} "
                                       f"on the CPU")
            worst = max(worst, _state_close(what, main, gs, cs))
            if wrapper is None:
                continue
            before = {n: gs.find_var(n).clone() for n in params}
            with wrapper.apply(gpu, scope=gs):
                on_card = {n: gs.find_var(n).cpu() for n in params}
            with wrapper.apply(cpu, scope=cs):
                for n in params:
                    if not torch.allclose(on_card[n], cs.find_var(n),
                                          **OPT_TOL) or torch.equal(
                                              on_card[n], before[n].cpu()):
                        raise RuntimeError(f"{what}: apply swapped in "
                                           f"{on_card[n].flatten()[:4]}, the "
                                           f"CPU {cs.find_var(n).flatten()[:4]}")
            if not all(torch.equal(gs.find_var(n), before[n]) for n in params):
                raise RuntimeError(f"{what}: restore did not bring the "
                                   f"parameters back")
        for sched in LR_SCHEDULES:
            main, startup = pt.Program(), pt.Program()
            with pt.program_guard(main, startup), unique_name.guard():
                lr = _schedule(L, sched)
            got = {}
            for exe in (cpu, gpu):
                scope = pt.Scope()
                exe.run(startup, scope=scope)
                got[exe] = [exe.run(main, fetch_list=[lr], scope=scope)[0][0]
                            for _ in range(8)]
            if not np.allclose(got[gpu], got[cpu], **OPT_TOL):
                raise RuntimeError(f"{sched}: learning rates {got[gpu]} on "
                                   f"the card, {got[cpu]} on the CPU")
        missing = [t for t in SYNC_FREE_OPS if not seen.get(t)]
        if missing:
            raise RuntimeError(f"never dispatched on the card: {missing}")
        print(f"optimizers: {len(OPT_CASES)} (12 optimizers and 3 wrappers, "
              f"apply and restore) x 3 steps and {len(LR_SCHEDULES)} "
              f"schedules x 8 runs agree with the CPU (the largest difference "
              f"{worst:.3f} of its limit, 1e-7 + 1e-5 |CPU|); "
              f"{sum(seen.values())} dispatches of {len(SYNC_FREE_OPS)} op "
              f"types under the sync debug mode \"error\" [{card}]")
        _check_dgc_bert(dev, card)
    finally:
        undo()


# bench.py:355 bench_wmt's TPU arm: Transformer-base (WMT en-de) widths,
# dropout off, src and tgt 128 at B=128, label smoothing 0.1,
# decorate(Adam(1e-4)); the dropout phase runs wmt_base() as published
# (dropout 0.1) at a batch cut to WMT_DROP_B
WMT_BASE = dict(vocab_size=37000, hidden_size=512, num_layers=6, num_heads=8,
                ffn_size=2048, max_position=256, dropout=0.0, use_tp=False)
WMT_B, WMT_S, WMT_EPS, WMT_DROP_B = 128, 128, 0.1, 32
# each dropout mask's keep rate within this many binomial sigmas of 1 - p
DROP_SIGMAS = 5.0


def _wmt_feed(cfg, B, S):
    """bench.py:381-388's feed (src = tgt = S), seeded."""
    rng = np.random.default_rng(SEED)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    return {"src_ids": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "src_pos": pos,
            "tgt_ids": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "tgt_pos": pos.copy(),
            "tgt_label": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "tgt_weight": np.ones((B, S), np.float32)}


def _wmt_step_flops(cfg, B, S):
    """bench.py:411-418 (src = tgt = S): 6 N T over the encoder's, the
    decoder's and the projection's matmul parameters plus attention."""
    H, L, F_, V = cfg.hidden_size, cfg.num_layers, cfg.ffn_size, cfg.vocab_size
    t = B * S
    enc, dec = L * (4 * H * H + 2 * H * F_), L * (8 * H * H + 2 * H * F_)
    return 6 * enc * t + 6 * (dec + H * V) * t + 12 * L * H * 3 * S * t


def _wmt_amp_oracle(P, feed, cfg, ln_names, low, masks=None):
    """The WMT loss in plain torch under the AMP program's cast scheme
    (low = bfloat16): the embedding streams (sqrt(H) word + position) in
    fp32, cast to bf16 where the first layer reads them; every product on
    bf16 views of the fp32 weights; the bias adds, residual stream and
    gelu in bf16; the layer norms with fp32 statistics; attention as K2
    computes it (fp32 scores and softmax, the unnormalized weights rounded
    to bf16 before they multiply V; each layer's checkpointed); the soft
    label (the one-hot smoothed by WMT_EPS in fp32) rounded to bf16, each
    token's loss from an fp32 log-softmax rounded to bf16, weighted in bf16
    and averaged in fp32. With `masks`, the port's dropout masks in program
    order, dropout where the program puts it and attention as the program
    builds it then: scores and their scale in bf16, softmax in bf16 (the
    causal one with -1e9 above the diagonal), the probabilities times the
    mask, then V. low = float32 is the same model in fp32."""
    import torch.nn.functional as F

    H, nh = cfg.hidden_size, cfg.num_heads
    dh = H // nh
    lns, drops = iter(ln_names), iter(masks or ())
    c = lambda t: t.to(low)  # noqa: E731

    def fc(x, pre):
        return x @ c(P[pre + ".w"]) + c(P[pre + ".b"])

    def ln(x):
        sn, bn = next(lns)
        return F.layer_norm(x.float(), (H,), c(P[sn]).float(),
                            c(P[bn]).float(), 1e-5).to(low)

    def drop(x):
        return x if masks is None else x * next(drops).to(x.dtype)

    def fused(q, k, v, causal):
        s = (q.float() @ k.float().transpose(-1, -2)) * dh ** -0.5
        if causal:
            s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool,
                                         device=s.device).triu(1), -1e30)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        return ((c(e).float() @ v.float()) / e.sum(dim=-1, keepdim=True)).to(low)

    def attention(q, k, v, causal):
        if masks is None:
            return _checkpointed(lambda q, k, v: fused(q, k, v, causal),
                                 q, k, v)
        s = (q @ k.transpose(-1, -2)) * dh ** -0.5
        if causal:
            s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool,
                                         device=s.device).triu(1), -1e9)
        return drop(torch.softmax(s, dim=-1)) @ v

    def heads(t, S, n):       # [B, S, n H] -> n x [B, nh, S, dh]
        return t.reshape(t.shape[0], S, n, nh, dh).permute(2, 0, 3, 1, 4)

    def merged(a):            # [B, nh, S, dh] -> [B, S, H]
        return a.transpose(1, 2).reshape(a.shape[0], a.shape[2], H)

    def ffn(x, pre):
        return fc(drop(F.gelu(fc(x, pre + ".in"))), pre + ".out")

    def embed(ids, pos, name):
        return drop(P["word_emb"][ids.long()] * H ** 0.5
                    + P[name + ".pos_emb"][pos.long()])

    S = feed["src_ids"].shape[1]
    x = embed(feed["src_ids"], feed["src_pos"], "enc")
    for i in range(cfg.num_layers):
        pre, x = f"enc.layer{i}", c(x)
        q, k, v = heads(fc(x, pre + ".mha.qkv"), S, 3)
        a = fc(merged(attention(q, k, v, False)), pre + ".mha.out")
        x = ln(x + drop(a))
        x = ln(x + drop(ffn(x, pre + ".ffn")))
    mem = x
    x = embed(feed["tgt_ids"], feed["tgt_pos"], "dec")
    for i in range(cfg.num_layers):
        pre, x = f"dec.layer{i}", c(x)
        q, k, v = heads(fc(x, pre + ".self.qkv"), S, 3)
        a = fc(merged(attention(q, k, v, True)), pre + ".self.out")
        x = ln(x + drop(a))
        (q,), (k, v) = heads(fc(x, pre + ".cross.q"), S, 1), \
            heads(fc(mem, pre + ".cross.kv"), S, 2)
        a = fc(merged(attention(q, k, v, False)), pre + ".cross.out")
        x = ln(x + drop(a))
        x = ln(x + drop(ffn(x, pre + ".ffn")))
    logp = torch.log_softmax(fc(x, "proj").float(), dim=-1)
    V = logp.shape[-1]
    onehot = F.one_hot(feed["tgt_label"].long(), V).float()
    soft = c((1 - WMT_EPS) * onehot + WMT_EPS / V)
    tok = c(-(soft.float() * logp).sum(dim=-1))
    w = feed["tgt_weight"]
    return (tok * c(w)).float().sum() / (w.sum() + 1e-6)


def _wmt_program(cfg, S):
    """transformer_wmt(cfg, S, S, WMT_EPS) + decorate(Adam(TRAIN_LR))
    through the port's entry points: (main, startup, avg_loss)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.contrib import mixed_precision as amp
    from paddle_tpu_torch.models import transformer

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        avg_loss, _ = transformer.transformer_wmt(
            cfg, src_len=S, tgt_len=S, label_smooth_eps=WMT_EPS)
        amp.decorate(pt.optimizer.Adam(learning_rate=TRAIN_LR)).minimize(avg_loss)
    startup.random_seed = main.random_seed = SEED
    return main, startup, avg_loss


def _hold_wmt_step1(what, cfg, main, scope, names, p0, feed, loss1, grads,
                    masks=None):
    """Step 1 against the bf16 and fp32 oracles on the same weights (and
    masks): the loss, every gradient, the Adam update. Returns the line to
    print."""
    ln_names = [(op.inputs["Scale"][0].split("@")[0],
                 op.inputs["Bias"][0].split("@")[0])
                for op in main.global_block.ops if op.type == "layer_norm"]
    dev = p0[names[0]].device
    fd = {k: torch.from_numpy(v).to(dev) for k, v in feed.items()}
    ref = {}
    torch.cuda.reset_peak_memory_stats()
    for low in (torch.bfloat16, torch.float32):
        P = {n: t.clone().requires_grad_() for n, t in p0.items()}
        lv = _wmt_amp_oracle(P, fd, cfg, ln_names, low, masks)
        ref[low] = (float(lv.detach()),
                    torch.autograd.grad(lv, [P[n] for n in names]))
        del P, lv
    peak = torch.cuda.max_memory_allocated() / 2**30
    ref_loss, ref_grads = ref[torch.bfloat16]
    fp_loss, fp_grads = ref.pop(torch.float32)
    loss_lim = _hold_amp_loss(what, float(loss1), ref_loss, fp_loss)
    worst, lim, top = _hold_amp_grads(names, grads, ref_grads, fp_grads)
    own_err, ref_err, n_sure, note = _hold_adam_step1(scope, names, p0,
                                                      grads, ref_grads)
    return (f"loss {float(loss1):.6f}, bf16 oracle {ref_loss:.6f}, fp32 "
            f"oracle {fp_loss:.6f} (limit {loss_lim:.3e}); worst gradient "
            f"{worst:.3e} from the bf16 oracle in relative L2 (its limit "
            f"{lim:.3e}; the largest limit {top:.3e}, where a planted zeroed "
            f"and negated gradient were refused); fp32 master weights within "
            f"{own_err:.3e} of the Adam step on the port's gradients and "
            f"{ref_err:.3e} on the oracle's ({n_sure} elements of sure sign, "
            f"{note}; limit 1e-2 lr); peak device memory with the oracles "
            f"{peak:.2f} GiB")


def train_wmt_amp(dev, card):
    """bench.py:355 bench_wmt's TPU arm: transformer_wmt(Transformer-base,
    dropout 0, src = tgt = WMT_S, label smoothing WMT_EPS) +
    decorate(Adam(1e-4)), B = WMT_B, one seeded batch, through the port's
    entry points. Step 1 against the bf16 oracle of the same cast scheme
    (loss, every gradient in relative L2, the Adam update), launches by
    dtype from the program's vars (the encoder's and the decoder's self-
    attention and the cross-attention on K2/K4, every layer norm on K3/K5;
    the soft-label cross entropy on no kernel), then TRAIN_STEPS timed
    steps whose loss must fall."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import cuda_kernels as ck

    cfg = transformer.TransformerConfig(**WMT_BASE)
    B, S = WMT_B, WMT_S
    what = f"WMT Transformer-base AMP B={B} src=tgt={S}"
    main, startup, avg_loss = _wmt_program(cfg, S)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    names = [p.name for p in main.all_parameters()]
    ops = [op.type for op in main.global_block.ops]
    print(f"AMP trainer: {what} bf16 (decorate(Adam({TRAIN_LR})), label "
          f"smoothing {WMT_EPS}), {len(ops)} ops a step, {ops.count('cast')} "
          f"casts [{card}]")
    feed = _wmt_feed(cfg, B, S)
    p0 = {n: scope.find_var(n).clone() for n in names}

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                  fetch_list=[avg_loss] + [n + "@GRAD" for n in names])
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = _check_launches(main, what)
    L = cfg.num_layers
    by_kernel = {n: sum(c.values()) for n, c in counts.items()}
    if by_kernel != {"causal_prefill_attention": 3 * L,
                     "attention_backward": 3 * L,
                     "layer_norm_act": 5 * L, "layer_norm_act_backward": 5 * L}:
        raise RuntimeError(f"{what} launches {counts}: 3 attentions and 5 "
                           f"layer norms a layer pair, no cross entropy "
                           f"kernel, were expected")
    loss1, grads = out[0], dict(zip(names, out[1:]))
    del out
    held = _hold_wmt_step1(what, cfg, main, scope, names, p0, feed, loss1,
                           grads)
    print(f"{what} step 1 ({first:.3f} s): {held}; launches by dtype {counts}")
    del grads

    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        (lv,) = exe.run(main, feed=feed, scope=scope, fetch_list=[avg_loss],
                        return_numpy=False)
        losses.append(lv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(lv) for lv in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < float(loss1):
        raise RuntimeError(f"the WMT AMP loss did not fall: step 1 "
                           f"{float(loss1)}, then {losses}")
    tokens = 2 * B * S                  # src + tgt (bench.py:420)
    step_flops = _wmt_step_flops(cfg, B, S)
    print(f"{what} trained {TRAIN_STEPS} steps in {wall:.3f} s: "
          f"{TRAIN_STEPS / wall:.3f} steps/s, {TRAIN_STEPS * tokens / wall:.1f} "
          f"tokens/s (src + tgt), {TRAIN_STEPS * step_flops / wall / 1e12:.2f} "
          f"model TFLOP/s ({step_flops / 1e12:.3f} TFLOP a step, bench.py:411); "
          f"losses {[round(x, 5) for x in losses]} [{card}]")
    step = lambda: exe.run(main, feed=feed, scope=scope,  # noqa: E731
                           fetch_list=[avg_loss], return_numpy=False)
    return step, counts


def _dropout_sites(main):
    """(X, Out, Mask) var names of every dropout op, in program order."""
    return [(op.inputs["X"][0], op.outputs["Out"][0], op.outputs["Mask"][0])
            for op in main.global_block.ops if op.type == "dropout"]


def _hold_masks(sites, got, p):
    """Each dropout's Mask keeps within DROP_SIGMAS binomial sigmas of
    1 - p, holds only 0 and 1 / (1 - p) as its dtype rounds it, and is the
    mask the op applied: its Out equals X * Mask bit for bit. Returns the
    keep rates' extremes and the elements."""
    rates, total = [], 0
    for (xn, on, mn), (x, o, m) in zip(sites, got):
        n, kept = m.numel(), int((m != 0).sum())
        sigma = (n * p * (1 - p)) ** 0.5
        if abs(kept - (1 - p) * n) > DROP_SIGMAS * sigma:
            raise RuntimeError(f"dropout mask {mn}: {kept} of {n} kept, "
                               f"{abs(kept - (1 - p) * n) / sigma:.1f} binomial "
                               f"sigmas from {1 - p} (limit {DROP_SIGMAS})")
        one = torch.ones((), dtype=m.dtype)
        keep_val = float(one / torch.tensor(1 - p, dtype=m.dtype))
        vals = torch.unique(m).float().cpu().tolist()
        if not set(vals) <= {0.0, keep_val}:
            raise RuntimeError(f"dropout mask {mn} holds {vals[:6]}, not "
                               f"only 0 and {keep_val}")
        bad = int((o != x * m).sum())
        if bad:
            raise RuntimeError(f"dropout mask {mn}: the op's Out differs from "
                               f"X * Mask at {bad} elements")
        rates.append(kept / n)
        total += n
    return min(rates), max(rates), total


def train_wmt_dropout(dev, card):
    """wmt_base() as published (dropout 0.1) under AMP, B = WMT_DROP_B (a
    batch cut), src = tgt = WMT_S, through the port's entry points: the
    attention takes the unfused ops (matmul, softmax, dropout) as in the
    JAX package. Step 1's dropout masks, fetched from the run, each keep
    within DROP_SIGMAS binomial sigmas of 0.9, hold {0, 1 / 0.9} in their
    dtype and are the masks their ops applied; step 1 against the bf16 and
    fp32 oracles, which apply those masks; a run with the same counter
    repeats every mask bit for bit, one with a new counter changes each."""
    import dataclasses

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import cuda_kernels as ck

    cfg = dataclasses.replace(transformer.wmt_base(), **{
        k: v for k, v in WMT_BASE.items() if k != "dropout"})
    B, S, p = WMT_DROP_B, WMT_S, cfg.dropout
    what = f"WMT wmt_base() (dropout {p}) AMP B={B} src=tgt={S}"
    main, startup, avg_loss = _wmt_program(cfg, S)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    names = [p_.name for p_ in main.all_parameters()]
    sites = _dropout_sites(main)
    ops = [op.type for op in main.global_block.ops]
    print(f"AMP trainer: {what} bf16, {len(ops)} ops a step, {len(sites)} "
          f"dropouts, {ops.count('matmul')} matmuls [{card}]")
    feed = _wmt_feed(cfg, B, S)
    p0 = {n: scope.find_var(n).clone() for n in names}
    trip = [n for site in sites for n in site]

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                  fetch_list=[avg_loss] + [n + "@GRAD" for n in names] + trip,
                  rng_counter=1)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = _check_launches(main, what)
    loss1, grads = out[0], dict(zip(names, out[1:1 + len(names)]))
    got = [tuple(out[1 + len(names) + 3 * i:4 + len(names) + 3 * i])
           for i in range(len(sites))]
    del out
    lo, hi, n_el = _hold_masks(sites, got, p)
    masks = [m for _, _, m in got]
    del got
    held = _hold_wmt_step1(what, cfg, main, scope, names, p0, feed, loss1,
                           grads, masks)
    del grads
    mask_names = [m for _, _, m in sites]
    again = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                    fetch_list=mask_names, rng_counter=1)
    for n, a, m in zip(mask_names, again, masks):
        if not torch.equal(a, m):
            raise RuntimeError(f"dropout mask {n}: the same (seed, counter) "
                               f"drew another mask")
    other = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                    fetch_list=mask_names, rng_counter=2)
    moved = [float((a != m).float().mean()) for a, m in zip(other, masks)]
    if not min(moved) > 0.05:
        n = mask_names[moved.index(min(moved))]
        raise RuntimeError(f"dropout mask {n}: a new counter changed only "
                           f"{min(moved):.3e} of it")
    print(f"{what} step 1 ({first:.3f} s): {len(sites)} masks, {n_el} "
          f"elements, keep rates {lo:.5f}..{hi:.5f} (each within "
          f"{DROP_SIGMAS} binomial sigmas of {1 - p}), each the mask its op "
          f"applied; the same counter repeated every mask bit for bit, a new "
          f"one changed {min(moved):.4f}..{max(moved):.4f} of each; {held}; "
          f"launches by dtype {counts} [{card}]")
    return counts


RN50_FWD_FLOPS_PER_IMG = 2 * 4.089e9     # bench.py:32
# bf16: each layer of the two oracles reads the port's input to that layer
# (`forced`); there the relu inputs of the oracle and the port differ by
# one layer's rounding, the oracle takes the port's decision within
# RELU_NEAR_BF16 of the relu's largest input off zero and its own beyond;
# at most RELU_FAR_SHARE of the relu inputs may fall on different sides of
# zero beyond that band, and no relu's output may differ from the port's
# by more than AMP_FWD_L2 in relative L2 or, anywhere, by more than
# RELU_NEAR_BF16 of its largest output. AMP_FWD_L2 was 1e-2 and passed a
# K8 whose output is 0.4% too large in every layer 512 wide
# (tests/test_torch_smoke_oracle.py); one layer's rounding puts the two
# 4.35e-5 apart on the H100 (B=128), so 1e-3 keeps 23x of room and
# refuses that fault
RELU_NEAR_BF16 = 3e-2
RELU_FAR_SHARE = 1e-5
AMP_FWD_L2 = 1e-3
# each running mean and variance within twice the distance between the
# bf16 and the fp32 oracles' plus 2e-3, of its max-abs, and never beyond
# AMP_STAT_CAP
AMP_STAT_CAP = 2e-2


def train_resnet_amp(dev, card):
    """bench.py:282-306's configuration: resnet50(img, label, s2d_stem=True,
    data_format="NHWC") + decorate(Momentum(0.1, 0.9)), B=128, 224x224, one
    seeded batch. Step 1 against the bf16 oracle, each of whose layers reads
    the port's input to it (each relu's output and decisions, loss,
    gradients in relative L2, momentum, running statistics), launches by
    dtype, then from the initial state at lr RN_FALL_LR 5 timed steps whose
    loss must fall."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.contrib import mixed_precision as amp
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops import cuda_kernels as ck

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        img = L.data(name="img", shape=[RN_HW, RN_HW, 3], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        loss, acc, _ = resnet.resnet50(img, label, num_classes=RN_CLASSES,
                                       s2d_stem=True, data_format="NHWC")
        amp.decorate(pt.optimizer.Momentum(RN_LR, RN_MU)).minimize(loss)
    startup.random_seed = SEED
    ops = [op.type for op in main.global_block.ops]
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    names = [p.name for p in main.all_parameters()]
    print(f"AMP trainer: ResNet-50 B={AMP_B} {RN_HW}x{RN_HW} NHWC s2d stem "
          f"bf16 (decorate(Momentum({RN_LR}, {RN_MU}))), {len(ops)} ops a "
          f"step, {ops.count('cast')} casts, {ops.count('conv2d_bn')} "
          f"conv2d_bn [{card}]")
    rng = np.random.default_rng(SEED)
    feed = {"img": torch.from_numpy(rng.standard_normal(
                (AMP_B, RN_HW, RN_HW, 3)).astype(np.float32)).to(dev),
            "label": torch.from_numpy(rng.integers(
                0, RN_CLASSES, (AMP_B, 1)).astype(np.int32)).to(dev)}
    p0 = {n: scope.find_var(n).clone() for n in names}
    bn_names = sorted(n[:-len(".mean")] for n in main.global_block.vars
                      if n.endswith(".bn.mean"))
    relu_vars = {op.inputs["Scale"][0].split("@")[0][:-len(".w_0")]:
                 op.outputs["Y"][0] for op in main.global_block.ops
                 if op.type in ("conv2d_bn", "batch_norm")
                 and op.attr("act", "") == "relu"}

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                  fetch_list=[loss] + [n + "@GRAD" for n in names]
                  + list(relu_vars.values()))
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = _check_launches(main, "ResNet-50 AMP step")
    if counts != {"bn_apply_act": {"bfloat16": 53},
                  "bn_apply_act_backward": {"bfloat16": 53},
                  "softmax_xent_fwd": {"bfloat16": 1},
                  "softmax_xent_bwd": {"bfloat16": 1}}:
        raise RuntimeError(f"ResNet-50 AMP step launches {counts}")
    loss1, grads = out[0], dict(zip(names, out[1:]))
    port_relu = dict(zip(relu_vars, out[1 + len(names):]))
    del out

    lab = feed["label"].long()[:, 0]
    ref = {}
    for low in (torch.bfloat16, torch.float32):
        stats, tally = {}, _tally(dev)
        P = {n: t.clone().requires_grad_() for n, t in p0.items()}
        lv = _resnet50_oracle(P, feed["img"], lab, stats, port_relu, tally,
                              low, RELU_NEAR_BF16, forced=True)
        ref[low] = (float(lv.detach()),
                    torch.autograd.grad(lv, [P[n] for n in names]), stats,
                    {k: v.item() for k, v in tally.items()})
        del P, lv
    del port_relu
    ref_loss, ref_grads, stats, tally = ref[torch.bfloat16]
    fp_loss, fp_grads, fp_stats, fp_tally = ref.pop(torch.float32)
    del ref
    print(f"  each oracle layer on the port's input: of {tally['elems']} relu "
          f"inputs {tally['near']} within {RELU_NEAR_BF16} of their relu's "
          f"largest off zero, the bf16 oracle's own decision differed from "
          f"the port's at {tally['taken']} of them and at {tally['far']} "
          f"farther off (the fp32 oracle's at {fp_tally['taken']} and "
          f"{fp_tally['far']}); the outputs after a relu within "
          f"{tally['fwd_l2']:.3e} in relative L2, {tally['fwd']:.3e} in "
          f"max-abs and {tally['fwd_max']:.3e} of the relu's largest output "
          f"of the port's (fp32 oracle {fp_tally['fwd_l2']:.3e}, "
          f"{fp_tally['fwd']:.3e}, {fp_tally['fwd_max']:.3e}); loss {float(loss1):.6f}, bf16 oracle "
          f"{ref_loss:.6f}, fp32 oracle {fp_loss:.6f}")
    loss_lim = _hold_amp_loss("ResNet-50 AMP", float(loss1), ref_loss, fp_loss)
    worst, lim, top = _hold_amp_grads(names, grads, ref_grads, fp_grads)
    # the fp32 oracle's outputs are unrounded: only its decisions are held
    for what, t, l2, mx in (("bf16", tally, tally["fwd_l2"], tally["fwd_max"]),
                            ("fp32", fp_tally, 0.0, 0.0)):
        if (t["far"] > RELU_FAR_SHARE * t["elems"] or not l2 <= AMP_FWD_L2
                or not mx <= RELU_NEAR_BF16):
            raise RuntimeError(
                f"the port's relu outputs against the {what} oracle's on the "
                f"same inputs: {t['far']} of {t['elems']} decisions differ "
                f"beyond {RELU_NEAR_BF16} of the relu's largest input (limit "
                f"{RELU_FAR_SHARE} of all), outputs up to {l2:.3e} apart in "
                f"relative L2 (limit {AMP_FWD_L2}) and {mx:.3e} of the "
                f"largest output (limit {RELU_NEAR_BF16})")
    vel_err = own_err = 0.0
    for n in names:
        g, p1 = grads[n], scope.find_var(n)
        if p1.dtype != torch.float32 or g.dtype != torch.float32:
            raise RuntimeError(f"{n}: master weight {p1.dtype}, gradient "
                               f"{g.dtype}: both must be fp32")
        vel_err = max(vel_err, float(
            (scope.find_var(f"{n}_velocity_0") - g).abs().max()))
        spacing = 2.4e-7 * float(p0[n].abs().max())
        own = float((p1 - (p0[n] - RN_LR * g)).abs().max())
        own_err = max(own_err, max(own - spacing, 0.0)
                      / max(RN_LR * float(g.abs().max()), 1e-30))
    if vel_err != 0.0 or not own_err <= 1e-6:
        raise RuntimeError(f"AMP momentum step 1: velocity differs from the "
                           f"gradient by {vel_err:.3e}, the parameters from "
                           f"p0 - lr g by {own_err:.3e} of lr max|g|")
    if sorted(stats) != bn_names or sorted(fp_stats) != bn_names:
        raise RuntimeError("the oracle's batch norms are not the program's")
    # the statistics are forward quantities of one layer each (the oracle
    # reads the port's input to it); a running mean zeroed is refused
    stat_err = stat_top = 0.0
    for n in bn_names:
        for i, (got, run) in enumerate(((scope.find_var(n + ".mean"), 0.0),
                                        (scope.find_var(n + ".var"), 0.9))):
            if got.dtype != torch.float32:
                raise RuntimeError(f"running statistics of {n}: {got.dtype}")
            want = run + (1 - 0.9) * stats[n][i]
            scale = max(float(want.abs().max()), 1e-30)
            ref_err = float((run + (1 - 0.9) * fp_stats[n][i] - want).abs().max())
            stat_lim = min(2 * ref_err / scale + 2e-3, AMP_STAT_CAP)
            err = float((got - want).abs().max()) / scale
            if not err <= stat_lim:
                raise RuntimeError(
                    f"running statistics of {n} differ from the bf16 oracle's "
                    f"by {err:.3e} of their max-abs, limit {stat_lim:.3e} "
                    f"(the fp32 oracle's differ by {ref_err / scale:.3e})")
            if i == 0 and not float(want.abs().max()) / scale > stat_lim:
                raise RuntimeError(f"the statistics gate passed {n}.mean zeroed")
            stat_err, stat_top = max(stat_err, err), max(stat_top, stat_lim)
    peak1 = torch.cuda.max_memory_allocated()
    print(f"AMP step 1 ({first:.3f} s): loss {float(loss1):.6f}, bf16 oracle "
          f"{ref_loss:.6f}, fp32 oracle {fp_loss:.6f} (limit {loss_lim:.3e}); "
          f"worst gradient {worst:.3e} from the bf16 oracle in relative L2 "
          f"(its limit {lim:.3e}; the largest limit {top:.3e}, where a "
          f"planted zeroed and negated gradient were refused); velocity "
          f"equals the gradient, fp32 master weights within {own_err:.3e} of "
          f"lr max|g| of p0 - lr g; {len(stats)} running mean/var pairs "
          f"within {stat_err:.3e} of their max-abs (largest limit "
          f"{stat_top:.3e}); relu decisions beyond the band differ at "
          f"{tally['far']} (limit {RELU_FAR_SHARE} of {tally['elems']}), "
          f"outputs after a relu within {tally['fwd_l2']:.3e} in relative L2 "
          f"(limit {AMP_FWD_L2}) and {tally['fwd_max']:.3e} of the largest "
          f"(limit {RELU_NEAR_BF16}); launches by dtype {counts}")
    del ref_grads, fp_grads, grads, stats, fp_stats

    lr_name = next(op.inputs["LearningRate"][0] for op in main.global_block.ops
                   if op.type == "momentum")
    scope.find_var(lr_name).fill_(RN_FALL_LR)
    for n in names:
        scope.find_var(n).copy_(p0[n])
        scope.find_var(f"{n}_velocity_0").zero_()
    for n in bn_names:
        scope.find_var(n + ".mean").zero_()
        scope.find_var(n + ".var").fill_(1.0)

    def step():
        return exe.run(main, feed=feed, scope=scope, fetch_list=[loss],
                       return_numpy=False)[0]

    first_loss = float(step())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step() for _ in range(RN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [float(lv) for lv in losses]
    if abs(first_loss - float(loss1)) > 1e-2 * float(loss1):
        raise RuntimeError(f"the restored state gives loss {first_loss}, the "
                           f"initial state gave {float(loss1)}")
    if not all(np.isfinite(losses)) or not losses[-1] < first_loss:
        raise RuntimeError(f"the AMP loss did not fall at lr {RN_FALL_LR}: "
                           f"{first_loss}, then {losses}")
    ms = 1e3 * wall / RN_STEPS
    print(f"AMP trained {RN_STEPS} steps (lr {RN_FALL_LR} from the initial "
          f"state, after one untimed step) in {wall:.3f} s: {ms:.2f} ms a step, "
          f"{RN_STEPS * AMP_B / wall:.1f} images/s, "
          f"{3 * RN50_FWD_FLOPS_PER_IMG * AMP_B / (ms / 1e3) / 1e12:.2f} model "
          f"TFLOP/s (3 x bench.py's forward FLOPs an image), peak device "
          f"memory {peak / 2**30:.3f} GiB in a step ({peak1 / 2**30:.3f} GiB "
          f"in step 1 with every gradient and relu output fetched); losses "
          f"{[round(x, 5) for x in losses]} [{card}]")
    return step, counts


# ---------------------------------------------------------------------------
# The book models: the attention seq2seq of the Fluid book's machine
# translation chapter (train and beam-search decode) and recognize_digits'
# MNIST models; then the long-context BERT AMP step under RecomputeOptimizer.
# ---------------------------------------------------------------------------

# models/seq2seq.py at its own widths (word_dim 128, hidden_dim 256) over the
# WMT'14 dictionary of the book's machine-translation chapter (30000 words):
# B=64 sentence pairs, source and target padded to 50 tokens, lengths 5-50
S2S_DICT, S2S_WORD, S2S_HIDDEN = 30000, 128, 256
S2S_B, S2S_T, S2S_MIN_LEN, S2S_LR, S2S_STEPS = 64, 50, 5, 1e-3, 5
S2S_BOS, S2S_EOS = 0, 1
# the decode: 16 sources, beam 4, 50 steps; scores held to 1e-5 relative
S2S_DEC_B, S2S_BEAM, S2S_MAX_LEN, S2S_SCORE_RTOL = 16, 4, 50, 1e-5
S2S_PARAMS = ("enc.emb", "enc.proj.w", "enc.proj.b", "enc.gru.w",
              "enc.gru.b", "dec.emb", "dec.in.w", "dec.in.b", "dec.gru.w",
              "dec.gru.b", "dec.out.w", "dec.out.b")


def _s2s_batch(B, seed):
    """B random sentence pairs of lengths S2S_MIN_LEN..S2S_T, ids 2.. in
    the dictionary, each padded with EOS; the decoder reads BOS + the target
    shifted by one."""
    rng = np.random.default_rng(seed)

    def sentences():
        lens = rng.integers(S2S_MIN_LEN, S2S_T + 1, B)
        ids = rng.integers(2, S2S_DICT, (B, S2S_T))
        ids[np.arange(S2S_T)[None, :] >= lens[:, None]] = S2S_EOS
        return ids.astype(np.int64), lens.astype(np.int64)

    src, slen = sentences()
    tout, tlen = sentences()
    tin = np.roll(tout, 1, axis=1)
    tin[:, 0] = S2S_BOS
    return {"src": src, "slen": slen, "tin": tin, "tout": tout, "tlen": tlen}


def _s2s_programs():
    """(train main, startup, loss, infer program, sentence ids, sentence
    scores): seq2seq.train_model + Adam(S2S_LR), and infer_model over
    S2S_DEC_B sources, which reads the training program's parameters."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import seq2seq

    widths = dict(word_dim=S2S_WORD, hidden_dim=S2S_HIDDEN)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        d = {n: L.data(name=n, shape=[S2S_T] if n in ("src", "tin", "tout")
                       else [], dtype="int64")
             for n in ("src", "slen", "tin", "tout", "tlen")}
        loss = seq2seq.train_model(d["src"], d["slen"], d["tin"], d["tout"],
                                   d["tlen"], S2S_DICT, **widths)
        pt.optimizer.Adam(learning_rate=S2S_LR).minimize(loss)
    startup.random_seed = SEED
    infer = pt.Program()
    with pt.program_guard(infer, pt.Program()), unique_name.guard():
        src = L.data(name="src", shape=[S2S_T], dtype="int64")
        src.shape = (S2S_DEC_B, S2S_T)
        slen = L.data(name="slen", shape=[], dtype="int64")
        sent, scores = seq2seq.infer_model(
            src, slen, S2S_DICT, beam_size=S2S_BEAM, max_len=S2S_MAX_LEN,
            bos_id=S2S_BOS, eos_id=S2S_EOS, **widths)
    return main, startup, loss, infer, sent, scores


def _gru_cell(x, h, w, b):
    """gru_unit_op.h's step written out: gates (u, r, c) from x + b, the
    update and reset gates on h @ w[:, :2H], the candidate on
    (r h) @ w[:, 2H:], h' = u (c - h) + h."""
    H = h.shape[1]
    xu, xr, xc = (x + b.reshape(1, -1)).split(H, dim=1)
    u = torch.sigmoid(xu + h @ w[:, :H])
    r = torch.sigmoid(xr + h @ w[:, H:2 * H])
    c = torch.tanh(xc + (r * h) @ w[:, 2 * H:])
    return u * (c - h) + h


def _s2s_encode(P, src, slen):
    """The encoder in plain torch: embedding, projection, a GRU over the
    padded time axis, the tail zeroed; (states, each row's last valid
    state, the [B, S] source mask)."""
    proj = P["s2s.enc.emb"][src] @ P["s2s.enc.proj.w"] + P["s2s.enc.proj.b"]
    B, S = src.shape
    h = torch.zeros((B, S2S_HIDDEN), dtype=proj.dtype, device=proj.device)
    hs = []
    for t in range(S):
        h = _gru_cell(proj[:, t], h, P["s2s.enc.gru.w"], P["s2s.enc.gru.b"])
        hs.append(h)
    mask = (torch.arange(S, device=src.device)[None, :]
            < slen[:, None]).to(proj.dtype)
    states = torch.stack(hs, dim=1) * mask[..., None]
    last = states[torch.arange(B, device=src.device), (slen - 1).clamp(min=0)]
    return states, last, mask


def _s2s_dec_step(P, word_ids, h, enc, mask):
    """One decoder step: dot attention of h over the masked source states,
    [word, context] through the input projection and the GRU cell, the
    output projection. Returns (h', logits)."""
    scores = (enc * h[:, None, :]).sum(-1)
    w = torch.softmax(scores.masked_fill(mask == 0, -1e9), dim=1) * mask
    ctx = (enc * w[:, :, None]).sum(1)
    x = (torch.cat([P["s2s.dec.emb"][word_ids], ctx], dim=1)
         @ P["s2s.dec.in.w"] + P["s2s.dec.in.b"])
    h = _gru_cell(x, h, P["s2s.dec.gru.w"], P["s2s.dec.gru.b"])
    return h, h @ P["s2s.dec.out.w"] + P["s2s.dec.out.b"]


def _s2s_loss(P, fd):
    """train_model's loss in plain torch: teacher-forced decoder, per-token
    cross entropy averaged over the valid target tokens."""
    import torch.nn.functional as F

    enc, h, mask = _s2s_encode(P, fd["src"], fd["slen"])
    B, T = fd["tin"].shape
    logits = []
    for t in range(T):
        h, lg = _s2s_dec_step(P, fd["tin"][:, t], h, enc, mask)
        logits.append(lg)
    logits = torch.stack(logits, dim=1)
    tok = F.cross_entropy(logits.reshape(B * T, -1), fd["tout"].reshape(-1),
                          reduction="none").reshape(B, T)
    m = (torch.arange(T, device=tok.device)[None, :]
         < fd["tlen"][:, None]).to(tok.dtype)
    return (tok * m).sum() / m.sum()


def _op_computes(program, iterations=0):
    """Op computes one run of `program` makes: its ops, plus a static_rnn's
    body once a step of its time axis (and again in its replayed grad),
    a while body once an iteration."""
    block = program.global_block
    n = len(block.ops)
    for op in block.ops:
        if op.type in ("static_rnn", "static_rnn_grad"):
            T = block.var(op.inputs["StepInputs"][0]).shape[0]
            n += T * len(program.blocks[op.attr("sub_block")].ops)
        elif op.type == "while":
            n += iterations * len(program.blocks[op.attr("sub_block")].ops)
    return n


def train_seq2seq(dev, card, profile=False):
    """seq2seq.train_model at S2S_* through the port's entry points, fp32:
    step 1's loss, every parameter gradient and the Adam update against the
    plain-torch oracle of the same model and batch (the GRU and the
    attention step written out as loops), K6 and K7 once each a step, then
    S2S_STEPS timed steps whose loss must fall; then the beam-search decode
    (`decode_seq2seq`) on the trained weights. Returns the launches of the
    training step and of the decode."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda_kernels as ck

    what = f"seq2seq B={S2S_B} T={S2S_T} V={S2S_DICT}"
    main, startup, loss, infer, sent, sent_scores = _s2s_programs()
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    names = [p.name for p in main.all_parameters()]
    if sorted(names) != sorted("s2s." + n for n in S2S_PARAMS):
        raise RuntimeError(f"{what}: parameters {names}")
    feed = _s2s_batch(S2S_B, SEED)
    computes = _op_computes(main)
    print(f"seq2seq trainer: {what} fp32 (Adam({S2S_LR}), word_dim "
          f"{S2S_WORD}, hidden_dim {S2S_HIDDEN}), "
          f"{sum(scope.find_var(n).numel() for n in names)} parameter "
          f"elements, {len(main.global_block.ops)} ops a step, {computes} op "
          f"computes a step (the StaticRNN body's ops each target step, in "
          f"the forward and in its replayed grad) [{card}]")
    p0 = {n: scope.find_var(n).clone() for n in names}

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                  fetch_list=[loss] + [n + "@GRAD" for n in names])
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = _check_launches(main, what)
    loss1, grads = out[0], dict(zip(names, out[1:]))
    del out
    P = {n: t.clone().requires_grad_() for n, t in p0.items()}
    fd = {k: torch.from_numpy(v).to(dev) for k, v in feed.items()}
    ref_loss = _s2s_loss(P, fd)
    ref_grads = torch.autograd.grad(ref_loss, [P[n] for n in names])
    ref_loss = float(ref_loss.detach())
    if not abs(float(loss1) - ref_loss) <= 1e-4 * abs(ref_loss):
        raise RuntimeError(f"{what}: step-1 loss {float(loss1)} vs oracle "
                           f"{ref_loss}")
    worst, own_err, ref_err, n_sure = _hold_step1(
        what, scope, names, p0, grads, ref_grads, S2S_LR)
    print(f"{what} step 1 ({first:.3f} s): loss {float(loss1):.6f}, oracle "
          f"{ref_loss:.6f}; worst gradient error {worst:.3e} of its max-abs "
          f"(limit {GRAD_RTOL}); updated parameters within {own_err:.3e} of "
          f"the Adam step on the port's gradients and {ref_err:.3e} on the "
          f"oracle's ({n_sure} elements of sure sign; limit 1e-2 lr); "
          f"launches {counts}")
    del P, ref_grads, grads, p0

    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(S2S_STEPS):
        (lv,) = exe.run(main, feed=feed, scope=scope, fetch_list=[loss],
                        return_numpy=False)
        losses.append(lv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(lv) for lv in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < float(loss1):
        raise RuntimeError(f"{what}: the loss did not fall: step 1 "
                           f"{float(loss1)}, then {losses}")
    tgt = int(feed["tlen"].sum())
    print(f"{what} trained {S2S_STEPS} steps in {wall:.3f} s: "
          f"{S2S_STEPS / wall:.3f} steps/s, {S2S_STEPS * tgt / wall:.1f} "
          f"target tokens/s ({tgt} valid of {S2S_B * S2S_T} a step), "
          f"{S2S_STEPS * computes / wall:.0f} op computes/s; losses "
          f"{[round(x, 5) for x in losses]} [{card}]")
    if profile:
        _profile(lambda: exe.run(main, feed=feed, scope=scope,
                                 fetch_list=[loss], return_numpy=False),
                 card, f"seq2seq training step ({computes} op computes)",
                 ("K6/K7", ("softmax_xent",)))
    dec_counts = decode_seq2seq(dev, card, exe, scope, infer, sent,
                                sent_scores, profile)
    return counts, dec_counts


@contextlib.contextmanager
def _sync_free_while(dev):
    """On the card, every op a `while` runs in its body under the sync
    debug mode "error": a host sync there raises. The loop's own read of
    its condition, its one sync an iteration, is let through."""
    if dev.type != "cuda":
        yield
        return
    from paddle_tpu_torch.ops import control_flow_ops as cf
    from paddle_tpu_torch.ops.registry import get_op_def

    opdef, read = get_op_def("while"), cf._read_cond
    compute = opdef.compute

    def guarded(ctx):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return compute(ctx)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def read_cond(t):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return read(t)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    opdef.compute, cf._read_cond = guarded, read_cond
    try:
        yield
    finally:
        opdef.compute, cf._read_cond = compute, read


def _hold_beams(dev, P, feed, ids, parents, scores):
    """Each decode step's selections (ids, parents, scores [T, BW]) against
    the oracle's best S2S_BEAM candidates of that step, the oracle's
    log-softmax recomputed from the port's own previous beams (teacher-
    forced along them): a live row's candidates are pre_score + logp over
    the dictionary, a finished row's (pre_id == EOS) only EOS at pre_score.
    Each selection must be a candidate whose oracle score is within
    S2S_SCORE_RTOL of the port's and no further below the oracle's
    beam-th best; each batch row's selections distinct; the sorted scores
    the oracle's. Ties closer than that may go either way. Returns (the
    worst score difference relative to its limit, the selections that
    continued a finished beam)."""
    beam = S2S_BEAM
    with torch.no_grad():
        src, slen = (torch.from_numpy(feed[k]).to(dev) for k in ("src", "slen"))
        enc, h, mask = _s2s_encode(P, src, slen)
        enc, h, mask = (t.repeat_interleave(beam, 0) for t in (enc, h, mask))
        BW = enc.shape[0]
        B = BW // beam
        pre_ids = torch.full((BW,), S2S_BOS, dtype=torch.long, device=dev)
        pre_scores = torch.zeros((B, beam), device=dev)
        pre_scores[:, 1:] = -1e9
        pre_scores = pre_scores.reshape(BW)
        row0 = torch.arange(B, device=dev).repeat_interleave(beam) * beam
        worst, frozen = 0.0, 0
        for t in range(ids.shape[0]):
            h_new, logits = _s2s_dec_step(P, pre_ids, h, enc, mask)
            cand = pre_scores[:, None] + torch.log_softmax(logits, dim=-1)
            done = pre_ids == S2S_EOS
            cand[done] = -float("inf")
            cand[done, S2S_EOS] = pre_scores[done]
            V = cand.shape[1]
            flat = cand.reshape(B, beam * V)
            top = flat.topk(beam, dim=1).values
            p_ids = ids[t].to(dev).long()
            p_par = parents[t].to(dev).long()
            p_sc = scores[t].to(dev).float()
            local = p_par - row0
            if not bool(((local >= 0) & (local < beam)).all()):
                raise RuntimeError(f"decode step {t}: parent {p_par.tolist()} "
                                   f"outside its batch row's beams")
            pos = (local * V + p_ids).reshape(B, beam)
            own = flat.gather(1, pos).reshape(BW)
            lim = S2S_SCORE_RTOL * top.abs().amax(dim=1).repeat_interleave(beam)
            d = torch.maximum((own - p_sc).abs(),
                              (top[:, -1].repeat_interleave(beam) - own).clamp(min=0))
            d_sorted = (p_sc.reshape(B, beam).sort(dim=1, descending=True)
                        .values - top).abs().reshape(BW)
            rel = float((torch.maximum(d, d_sorted) / lim).max())
            distinct = all(len(set(r)) == beam for r in pos.tolist())
            if not rel <= 1.0 or not distinct:
                raise RuntimeError(
                    f"decode step {t}: the port's beams (ids {p_ids.tolist()}, "
                    f"parents {p_par.tolist()}, scores {p_sc.tolist()}) are "
                    f"not the oracle's best {beam} (its scores of them "
                    f"{own.tolist()}, its best {top.tolist()}; worst "
                    f"{rel:.3f} of the limit)")
            worst = max(worst, rel)
            frozen += int(done[p_par].sum())
            pre_ids, pre_scores, h = p_ids, p_sc, h_new[p_par]
    return worst, frozen


def _backtrack(ids, parents):
    """The sentences beam_search_decode must give, backtracked in numpy
    from the step buffers [T, BW]."""
    T, BW = ids.shape
    out = np.zeros((BW, T), np.int64)
    ptr = np.arange(BW)
    for t in range(T - 1, -1, -1):
        out[:, t] = ids[t, ptr]
        ptr = parents[t, ptr]
    return out


def _check_frozen_beams(dev):
    """The beam_search op at the decode's shapes with every other row
    finished (random candidates, no ties): its selections against the rule
    written out per batch row (a finished row's one candidate is EOS at
    its pre_score, a live row's its K candidates). The decode of random
    weights may never finish a beam. Returns the selections that continued
    a finished row."""
    from paddle_tpu_torch.ops.registry import ExecContext, get_op_def

    g = torch.Generator().manual_seed(SEED + 7)
    beam = S2S_BEAM
    BW = S2S_DEC_B * beam
    pre_ids = torch.randint(2, S2S_DICT, (BW, 1), generator=g)
    pre_ids[::2] = S2S_EOS
    pre_scores = -10 * torch.rand((BW, 1), generator=g)
    ids = torch.randint(2, S2S_DICT, (BW, beam), generator=g)
    scores = -3 * torch.rand((BW, beam), generator=g)

    class Op:
        type = "beam_search"
        inputs = {s: [s] for s in ("pre_ids", "pre_scores", "ids", "scores")}
        outputs = {}
        attrs = {"beam_size": beam, "end_id": S2S_EOS}

    env = {"pre_ids": pre_ids.to(dev), "pre_scores": pre_scores.to(dev),
           "ids": ids.to(dev), "scores": scores.to(dev)}
    out = get_op_def("beam_search").compute(ExecContext(Op, env, dev))
    got_ids, got_sc, got_par = (out[k].reshape(-1).cpu() for k in (
        "selected_ids", "selected_scores", "parent_idx"))
    frozen = 0
    for b in range(S2S_DEC_B):
        cand = []
        for r in range(b * beam, (b + 1) * beam):
            if int(pre_ids[r]) == S2S_EOS:
                cand.append((float(pre_scores[r]), r, S2S_EOS))
            else:
                cand += [(float(pre_scores[r] + scores[r, k]), r, int(ids[r, k]))
                         for k in range(beam)]
        want = sorted(cand, reverse=True)[:beam]
        rows = slice(b * beam, (b + 1) * beam)
        got = list(zip(got_sc[rows].tolist(), got_par[rows].tolist(),
                       got_ids[rows].tolist()))
        if [(p, i) for _, p, i in got] != [(p, i) for _, p, i in want] or \
                max(abs(a[0] - w[0]) for a, w in zip(got, want)) > 1e-6:
            raise RuntimeError(f"beam_search with finished rows: batch row "
                               f"{b} selected {got}, the rule gives {want}")
        frozen += sum(int(pre_ids[p]) == S2S_EOS for _, p, _ in got)
    if not frozen:
        raise RuntimeError("beam_search with finished rows: none continued")
    return frozen


def decode_seq2seq(dev, card, exe, scope, infer, sent, sent_scores,
                   profile=False):
    """infer_model's beam search over S2S_DEC_B sources (beam S2S_BEAM,
    S2S_MAX_LEN steps through the While) on the training scope's weights:
    every step's selections against the oracle (`_hold_beams`), the
    sentences against a numpy backtrack of the port's own buffers, the
    loop's host syncs one an iteration (and one to leave), its body free of
    any other (`_sync_free_while`)."""
    from paddle_tpu_torch.ops import control_flow_ops as cf
    from paddle_tpu_torch.ops import cuda_kernels as ck

    (dec_op,) = [op for op in infer.global_block.ops
                 if op.type == "beam_search_decode"]
    bufs = [dec_op.inputs[s][0] for s in ("Ids", "ParentIdx", "Scores")]
    batch = _s2s_batch(S2S_DEC_B, SEED + 1)
    feed = {"src": batch["src"], "slen": batch["slen"]}
    syncs, iters = cf.while_op.host_syncs, cf.while_op.iterations
    ck.reset_launch_counts()
    with _sync_free_while(dev):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exe.run(infer, feed=feed, scope=scope, return_numpy=False,
                      fetch_list=[sent, sent_scores] + bufs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {k: v for k, v in ck.launch_counts_by_dtype().items() if v}
    syncs = cf.while_op.host_syncs - syncs
    iters = cf.while_op.iterations - iters
    if iters != S2S_MAX_LEN or syncs != iters + 1:
        raise RuntimeError(f"decode: {iters} iterations and {syncs} host "
                           f"syncs of the loop, for {S2S_MAX_LEN} steps")
    sent_ids, sent_sc, ids, parents, scores = (t.cpu() for t in out)
    P = {n: scope.find_var(n) for n in ("s2s." + p for p in S2S_PARAMS)}
    worst, frozen = _hold_beams(dev, P, feed, ids, parents, scores)
    want = _backtrack(ids.numpy().astype(np.int64),
                      parents.numpy().astype(np.int64))
    if not np.array_equal(sent_ids.numpy(), want) or not torch.equal(
            sent_sc, scores[-1]):
        raise RuntimeError("decode: beam_search_decode's sentences are not "
                           "the backtrack of the port's own buffers")
    computes = _op_computes(infer, iters)
    frozen_op = _check_frozen_beams(dev)
    print(f"seq2seq decode: B={S2S_DEC_B} beam {S2S_BEAM}, {iters} While "
          f"iterations and {syncs} host syncs of the loop (its body "
          f"sync-free), {wall:.3f} s ({S2S_DEC_B * iters / wall:.1f} source "
          f"tokens decoded/s, {computes} op computes); every step's beams "
          f"the oracle's best (worst {worst:.3f} of the score limit "
          f"{S2S_SCORE_RTOL} relative), {frozen} selections continuing a "
          f"finished beam, the sentences the backtrack of the buffers; "
          f"launches {counts}; beam_search with every other row finished: "
          f"the rule's selections, {frozen_op} of them continuing a "
          f"finished row at its score [{card}]")
    if profile:
        _profile(lambda: exe.run(infer, feed=feed, scope=scope,
                                 fetch_list=[sent], return_numpy=False),
                 card, f"seq2seq beam-search decode ({computes} op computes)")
    return counts


# recognize_digits' models (BASELINE.json's first configuration) at B=128
MNIST_B, MNIST_LR, MNIST_STEPS = 128, 1e-3, 5


def _mnist_oracle(which, P, names, img, label):
    """mnist_mlp or mnist_conv in plain torch over the parameters in the
    program's order; (mean cross entropy, logits)."""
    import torch.nn.functional as F

    it = iter(names)
    h = img
    if which == "mnist_mlp":
        for _ in range(2):
            h = torch.relu(h @ P[next(it)] + P[next(it)])
    else:
        for _ in range(2):
            w, b = P[next(it)], P[next(it)]
            h = F.max_pool2d(torch.relu(F.conv2d(h, w) + b[None, :, None, None]),
                             2, 2)
        h = h.reshape(h.shape[0], -1)
    logits = h @ P[next(it)] + P[next(it)]
    return F.cross_entropy(logits, label.reshape(-1).long()), logits


def train_mnist(dev, card):
    """models/mlp.py's mnist_mlp and mnist_conv + Adam(MNIST_LR) at
    B=MNIST_B, fp32, through the port's entry points: step 1's loss,
    accuracy, every gradient and the Adam update against the plain-torch
    oracle, K6 and K7 once each a step, then MNIST_STEPS timed steps whose
    loss must fall. Returns each model's step-1 launches."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import mlp
    from paddle_tpu_torch.ops import cuda_kernels as ck

    runs = []
    for which in ("mnist_mlp", "mnist_conv"):
        what = f"{which} B={MNIST_B}"
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), unique_name.guard():
            loss, acc, _ = getattr(mlp, which)()
            pt.optimizer.Adam(learning_rate=MNIST_LR).minimize(loss)
        startup.random_seed = SEED
        exe, scope = pt.Executor(), pt.Scope()
        exe.run(startup, scope=scope)
        names = [p.name for p in main.all_parameters()]
        rng = np.random.default_rng(SEED)
        shape = (MNIST_B, 784) if which == "mnist_mlp" else (MNIST_B, 1, 28, 28)
        feed = {"img": rng.random(shape).astype(np.float32),
                "label": rng.integers(0, 10, (MNIST_B, 1)).astype(np.int64)}
        p0 = {n: scope.find_var(n).clone() for n in names}
        ck.reset_launch_counts()
        out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                      fetch_list=[loss, acc] + [n + "@GRAD" for n in names])
        counts = _check_launches(main, what)
        grads = dict(zip(names, out[2:]))
        P = {n: t.clone().requires_grad_() for n, t in p0.items()}
        ref_loss, logits = _mnist_oracle(
            which, P, names, torch.from_numpy(feed["img"]).to(dev),
            torch.from_numpy(feed["label"]).to(dev))
        ref_grads = torch.autograd.grad(ref_loss, [P[n] for n in names])
        ref_loss = ref_loss.detach()
        ref_acc = float((logits.argmax(-1).cpu().numpy()
                         == feed["label"][:, 0]).mean())
        if not abs(float(out[0]) - float(ref_loss)) <= 1e-4 * float(ref_loss) \
                or abs(float(out[1]) - ref_acc) > 1.5 / MNIST_B:
            raise RuntimeError(f"{what}: step-1 loss {float(out[0])} and "
                               f"accuracy {float(out[1])}, oracle "
                               f"{float(ref_loss)} and {ref_acc}")
        worst, own_err, ref_err, n_sure = _hold_step1(
            what, scope, names, p0, grads, ref_grads, MNIST_LR)
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MNIST_STEPS):
            (lv,) = exe.run(main, feed=feed, scope=scope, fetch_list=[loss],
                            return_numpy=False)
            losses.append(lv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [float(lv) for lv in losses]
        if not all(np.isfinite(losses)) or not losses[-1] < float(out[0]):
            raise RuntimeError(f"{what}: the loss did not fall: step 1 "
                               f"{float(out[0])}, then {losses}")
        print(f"{what} fp32 (Adam({MNIST_LR})): step 1 loss "
              f"{float(out[0]):.6f} (oracle {float(ref_loss):.6f}), accuracy "
              f"{float(out[1]):.4f} (oracle {ref_acc:.4f}); worst gradient "
              f"error {worst:.3e} of its max-abs, update within {own_err:.3e} "
              f"/ {ref_err:.3e} of the Adam step ({n_sure} elements of sure "
              f"sign); {len(main.global_block.ops)} ops a step; launches "
              f"{counts}; {MNIST_STEPS} steps in {wall:.3f} s: "
              f"{MNIST_STEPS * MNIST_B / wall:.1f} images/s; losses "
              f"{[round(x, 5) for x in losses]} [{card}]")
        runs.append(counts)
    return runs


def _grad_groups(names, grads, ref):
    """{name with its layer index taken out: (max relative difference,
    relative L2 distance)}, the worst over the layers, of grads from ref."""
    groups: dict = {}
    for n in names:
        g, r = grads[n].float(), ref[n].float()
        scale = max(float(r.abs().max()), 1e-30)
        row = (float((g - r).abs().max()) / scale, _rel_l2(g, r))
        key = re.sub(r"layer\d+", "layer*", n)
        old = groups.get(key, (0.0, 0.0))
        groups[key] = (max(old[0], row[0]), max(old[1], row[1]))
    return groups


def train_bert_recompute(dev, card, plain):
    """tools/_sweep.py's `8 2048 1` with SWEEP_RECOMPUTE: bert_pretrain
    (BERT-base, S=LONG_S, use_flash_attention) +
    RecomputeOptimizer(decorate(Adam(1e-4))) with transformer
    .last_layer_outputs as checkpoints, B=LONG_B, one step from the plain
    long-context AMP step's start (`plain`, train_bert_amp's keep): its loss
    bit for bit the plain step's, every gradient within the AMP gate's
    floor (AMP_GRAD_BAND's 2e-2 relative L2) of the plain step's, launches
    by dtype as the program says (K10 twice a layer: the forward and the
    replay; K11 once; K3/K5 in bf16 inside the replays) and, on the card,
    the step's peak device memory above its start below the plain step's;
    then TRAIN_STEPS timed steps whose loss must fall. Returns (a step,
    the launches of the first)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.contrib import mixed_precision as amp
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.weights import load_params

    what = f"recompute BERT-base AMP B={LONG_B} S={LONG_S}"
    cfg = _bert_cfg(LONG_S, True)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        avg_loss, _ = transformer.bert_pretrain(cfg, seq_len=LONG_S)
        opt = pt.optimizer.RecomputeOptimizer(
            amp.decorate(pt.optimizer.Adam(learning_rate=TRAIN_LR)))
        opt._set_checkpoints(list(transformer.last_layer_outputs))
        opt.minimize(avg_loss)
    startup.random_seed = SEED
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    names = [p.name for p in main.all_parameters()]
    load_params(scope, main, {n: plain["p0"][n].cpu().numpy() for n in names})
    n_seg = sum(op.type == "recompute" for op in main.global_block.ops)
    print(f"{what}: {n_seg} recompute segments, {len(main.global_block.ops)} "
          f"ops a step in the top block [{card}]")
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    mem = _step_memory()
    t0 = time.perf_counter()
    out = exe.run(main, feed=plain["feed"], scope=scope, return_numpy=False,
                  fetch_list=[avg_loss] + [n + "@GRAD" for n in names])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mem = mem()
    counts = _check_launches(main, what)
    L = cfg.num_layers
    if (counts.get("flash_attention_fwd") != {"bfloat16": 2 * L}
            or counts.get("flash_attention_backward") != {"bfloat16": L}
            or counts.get("layer_norm_act_backward", {}).get("bfloat16")
            != 2 * L):
        raise RuntimeError(f"{what}: launches {counts}")
    loss, grads = out[0], dict(zip(names, out[1:]))
    del out
    loss0 = plain["loss1"]
    if loss.cpu().numpy().tobytes() != loss0.cpu().numpy().tobytes():
        raise RuntimeError(f"{what}: loss {float(loss)!r}, the plain step's "
                           f"{float(loss0)!r}: not bit for bit")
    groups = _grad_groups(names, grads, plain["grads"])
    far = max(groups.items(), key=lambda kv: kv[1][1])
    if not far[1][1] <= AMP_GRAD_BAND[1]:
        raise RuntimeError(f"{what}: {far[0]}@GRAD is {far[1][1]:.3e} from "
                           f"the plain step's in relative L2 (limit "
                           f"{AMP_GRAD_BAND[1]})")
    print(f"{what} step ({wall:.3f} s): loss {float(loss)!r} bit for bit the "
          f"plain step's; each gradient's max relative difference (of the "
          f"plain step's max-abs) and relative L2 from the plain step's, "
          f"worst over the layers: " + "; ".join(
              f"{k} {a:.2e} {b:.2e}" for k, (a, b) in sorted(groups.items()))
          + f"; launches by dtype {counts} [{card}]")
    (b0, p_plain), (b1, p_rc) = plain["mem"], mem
    print(f"{what} peak device memory: plain step {p_plain / 2**30:.3f} GiB "
          f"({(p_plain - b0) / 2**30:.3f} GiB above its start), recompute "
          f"step {p_rc / 2**30:.3f} GiB ({(p_rc - b1) / 2**30:.3f} GiB above "
          f"its start) [{card}]")
    if dev.type == "cuda" and not p_rc - b1 < p_plain - b0:
        raise RuntimeError(f"{what}: the recompute step's peak above its "
                           f"start is not below the plain step's")
    del grads
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        (lv,) = exe.run(main, feed=plain["feed"], scope=scope,
                        fetch_list=[avg_loss], return_numpy=False)
        losses.append(lv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(lv) for lv in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < float(loss):
        raise RuntimeError(f"{what}: the loss did not fall: step 1 "
                           f"{float(loss)}, then {losses}")
    step_flops = _bert_step_flops(cfg, LONG_B, LONG_S)
    print(f"{what} trained {TRAIN_STEPS} steps in {wall:.3f} s: "
          f"{TRAIN_STEPS / wall:.3f} steps/s, "
          f"{TRAIN_STEPS * LONG_B * LONG_S / wall:.1f} tokens/s, "
          f"{TRAIN_STEPS * step_flops / wall / 1e12:.2f} model TFLOP/s (the "
          f"plain step's count, the replays not in it); losses "
          f"{[round(x, 5) for x in losses]} [{card}]")
    step = lambda: exe.run(main, feed=plain["feed"], scope=scope,  # noqa: E731
                           fetch_list=[avg_loss], return_numpy=False)
    return step, counts


# ---------------------------------------------------------------------------
# io and the inference Predictor: ResNet-50 and BERT-base saved from their
# for_test clones and served by create_paddle_predictor in fp32 and bf16;
# the ResNet-50 AMP step under RecomputeOptimizer; word2vec and dense DeepFM
# ---------------------------------------------------------------------------

IR_B, IB_B, IB_S = 128, 128, 128    # bench.py:282's and :120's batches
IR_TRAIN_STEPS = 3
# the bf16 predictor's output against the fp32 predictor's, in relative L2:
# within twice the distance between the plain-torch bf16 and fp32 oracles
# (the same casts) plus this floor (the predictor's and the oracle's bf16
# round at different places: cuDNN's and the kernels' sums)
INFER_BF16_FLOOR = 1e-2
INFER_FP32_L2 = 1e-4
# bench.py:35 _timed_windows' protocol: windows of async runs; 2 runs a
# window, 1 window after the warm run (5 and 3, then 3 and 3, then 2 and
# 2, before depth cuts that keep the script inside its time limit)
INFER_ITERS, INFER_PASSES = 2, 1


def _timed_windows(run_once, iters=INFER_ITERS, passes=INFER_PASSES):
    """bench.py:35's protocol: `passes` windows of `iters` async runs, each
    ended by a device drain; the seconds a run of every window."""
    windows = []
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            run_once()
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / iters)
    return windows


def _saved_arrays(dirname, program, dev):
    """Every parameter and persistable of a saved inference program, read
    back from its .npy files (not through the port's loader) onto `dev`."""
    from paddle_tpu_torch.io import _encode_name

    import os
    return {v.name: torch.from_numpy(np.load(os.path.join(
                dirname, _encode_name(v.name) + ".npy"))).to(dev)
            for v in program.list_vars() if v.persistable}


def _infer_counts(pred, feed, what):
    """One predictor run with the launch counts reset just before and read
    just after, held against what its program's ops say."""
    from paddle_tpu_torch.ops import cuda_kernels as ck

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    out = pred.run_dict(feed, return_numpy=False)[0]
    torch.cuda.synchronize()
    return out, _check_launches(pred._program, what)


def _serve_predictor(pred, feed, n, card, what, unit):
    """Warm windows of runs (n `unit`s a run), peak device memory above the
    start, and the device's busy share over three traced runs."""
    run = lambda: pred.run_dict(feed, return_numpy=False)  # noqa: E731
    run()
    torch.cuda.synchronize()
    mem = _step_memory()
    windows = _timed_windows(run)
    base, peak = mem()
    busy = _profile(lambda: [run() for _ in range(3)], card, what)
    busy_txt = "not measured" if busy is None else f"{100 * busy:.1f}%"
    print(f"{what}: {n / min(windows):.1f} {unit}/s (best of windows "
          f"{[round(1e3 * w, 3) for w in windows]} ms a run), peak device "
          f"memory {(peak - base) / 2**30:.3f} GiB above the start "
          f"({peak / 2**30:.3f} GiB), device busy {busy_txt} [{card}]")
    return n / min(windows)


def _hold_bf16_predictor(what, out16, out32, ref16, ref32):
    """The bf16 predictor's distance from the fp32 one within twice the bf16
    oracle's from the fp32 oracle plus INFER_BF16_FLOOR; returns (its
    distance, the limit)."""
    d, d_ref = _rel_l2(out16, out32), _rel_l2(ref16, ref32)
    lim = 2 * d_ref + INFER_BF16_FLOOR
    if not d <= lim:
        raise RuntimeError(f"{what}: bf16 predictor {d:.3e} from the fp32 "
                           f"one in relative L2, limit {lim:.3e} (the bf16 "
                           f"oracle {d_ref:.3e} from the fp32 oracle)")
    return d, lim, d_ref


@contextlib.contextmanager
def _swapped(module, name, fault):
    """`module.name` replaced by fault(original) inside the block."""
    real = getattr(module, name)
    setattr(module, name, fault(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _refuses(what, pred, feed, out32, lim, module, name, fault, fault_what):
    """The bf16 gate must refuse `fault` planted in module.name."""
    with _swapped(module, name, fault):
        bad = pred.run_dict(feed, return_numpy=False)[0]
    d = _rel_l2(bad, out32)
    if d <= lim:
        raise RuntimeError(f"{what}: the bf16 gate passed {fault_what} "
                           f"({d:.3e} <= {lim:.3e})")
    print(f"{what}: the bf16 gate refuses {fault_what}: {d:.3e} from the "
          f"fp32 predictor, limit {lim:.3e}")


def _resnet50_infer(P, img, low=torch.float32):
    """The NHWC space-to-depth ResNet-50's logits in inference mode in plain
    torch over the arrays P (parameters and running statistics by name):
    F.conv2d (TF32 off) and F.batch_norm(training=False). In bf16, the
    bf16 predictor's casts: every array and the image rounded to bf16, each
    conv, norm, residual add and the fc's product and bias add rounded
    once, each norm computed in fp32 from those bf16 inputs."""
    import torch.nn.functional as F

    c = lambda t: t.to(low)  # noqa: E731

    def conv(x, name, stride=1, pad=0):
        return F.conv2d(x, c(P[name + ".w_0"]).permute(3, 2, 0, 1), None,
                        stride, pad)

    def bn(x, name):
        return F.batch_norm(
            x.float(), c(P[name + ".mean"]).float(), c(P[name + ".var"]).float(),
            c(P[name + ".w_0"]).float(), c(P[name + ".b_0"]).float(), False,
            0.0, 1e-5).to(low)

    n, h, w, ch = img.shape
    x = c(img).reshape(n, h // 2, 2, w // 2, 2, ch).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(n, h // 2, w // 2, 4 * ch).permute(0, 3, 1, 2)
    x = torch.relu(bn(conv(F.pad(x, (2, 1, 2, 1)), "stem"), "stem.bn"))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, blocks in enumerate(RN_STAGES):
        width = 64 * 2 ** stage
        for i in range(blocks):
            stride = 2 if (i == 0 and stage > 0) else 1
            pre = f"res{stage}.{i}"
            y = torch.relu(bn(conv(x, pre + ".c1"), pre + ".c1.bn"))
            y = torch.relu(bn(conv(y, pre + ".c2", stride, 1), pre + ".c2.bn"))
            y = bn(conv(y, pre + ".c3"), pre + ".c3.bn")
            if x.shape[1] != width * 4 or stride != 1:
                x = bn(conv(x, pre + ".sc", stride), pre + ".sc.bn")
            x = torch.relu(y + x)
    pooled = x.float().mean(dim=(2, 3)).to(low)
    return (pooled @ c(P["fc_0.w_0"])) + c(P["fc_0.b_0"])


def infer_resnet(dev, card):
    """ResNet-50 in bench.py:278's configuration (s2d stem, NHWC, 224x224,
    1000 classes): its clone(for_test=True) taken before Momentum(0.01,
    0.9)'s minimize, IR_TRAIN_STEPS fp32 training steps at B=IR_B, then
    every batch norm's running mean and variance written (weights
    .load_state) from one training-mode pass over the batch (the oracle's
    batch statistics): three steps leave them near 0 and 1, and fifty
    layers normalized by those drift far. The clone is saved with
    save_inference_model and served by create_paddle_predictor. fp32: the
    predictor's logits equal a direct Executor.run of the clone on the
    training scope bit for bit, and lie within INFER_FP32_L2 relative L2 of
    the plain-torch oracle on the saved files; K8 launches 53 times in
    inference mode, K9, K6 and K7 never. bf16 (AnalysisConfig(enable_bf16
    =True)): 53 bf16 K8 launches, the bf16 gate (`_hold_bf16_predictor`),
    which must refuse K8 reading the variance one channel on. Each
    predictor's images/s, peak memory and device busy."""
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.inference import (AnalysisConfig, NativeConfig,
                                            create_paddle_predictor)
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.weights import load_state

    what = f"ResNet-50 predictor B={IR_B}"
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        img = L.data(name="img", shape=[RN_HW, RN_HW, 3], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        loss, _, predict = resnet.resnet50(img, label, num_classes=RN_CLASSES,
                                           s2d_stem=True, data_format="NHWC")
        test_prog = main.clone(for_test=True)
        pt.optimizer.Momentum(RN_FALL_LR, RN_MU).minimize(loss)
    startup.random_seed = SEED
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(SEED)
    feed = {"img": torch.from_numpy(rng.standard_normal(
                (IR_B, RN_HW, RN_HW, 3)).astype(np.float32)).to(dev),
            "label": torch.from_numpy(rng.integers(
                0, RN_CLASSES, (IR_B, 1)).astype(np.int32)).to(dev)}
    losses = [float(exe.run(main, feed=feed, scope=scope, fetch_list=[loss],
                            return_numpy=False)[0])
              for _ in range(IR_TRAIN_STEPS)]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{what}: training losses {losses}")
    names = [p.name for p in main.all_parameters()]
    stats = {}
    with torch.no_grad():
        _resnet50_oracle({n: scope.find_var(n) for n in names}, feed["img"],
                         feed["label"].long()[:, 0], stats, None, _tally(dev))
    state = {v.name: scope.find_var(v.name).cpu().numpy()
             for v in main.global_block.vars.values()
             if v.persistable and v.name not in names}
    for n, (m, v) in stats.items():
        state[n + ".mean"], state[n + ".var"] = m.cpu().numpy(), v.cpu().numpy()
    load_state(scope, main, state)
    (direct,) = exe.run(test_prog, feed=feed, scope=scope,
                        fetch_list=[predict], return_numpy=False)
    img_feed = {"img": feed["img"]}
    with tempfile.TemporaryDirectory() as d:
        pt.io.save_inference_model(d, ["img"], [predict], exe,
                                   main_program=test_prog, scope=scope)
        pred = create_paddle_predictor(NativeConfig(model_dir=d))
        P = _saved_arrays(d, pred._program, dev)
        pred16 = create_paddle_predictor(AnalysisConfig(model_dir=d,
                                                        enable_bf16=True))
    out32, c32 = _infer_counts(pred, img_feed, what + " fp32")
    out16, c16 = _infer_counts(pred16, img_feed, what + " bf16")
    for dt, got in (("float32", c32), ("bfloat16", c16)):
        if got != {"bn_apply_act": {dt: 53}}:
            raise RuntimeError(f"{what} {dt}: launches {got}, want 53 K8 "
                               f"(inference mode) and nothing else")
    if not torch.equal(out32, direct):
        raise RuntimeError(f"{what}: the fp32 predictor's logits are not "
                           f"the direct run's bit for bit (max "
                           f"{float((out32 - direct).abs().max()):.3e} apart)")
    with torch.no_grad():
        ref32 = _resnet50_infer(P, feed["img"])
        ref16 = _resnet50_infer(P, feed["img"], torch.bfloat16)
    d32 = _rel_l2(out32, ref32)
    if not d32 <= INFER_FP32_L2:
        raise RuntimeError(f"{what}: fp32 predictor {d32:.3e} from the "
                           f"oracle in relative L2, limit {INFER_FP32_L2}")
    d16, lim, d_ref = _hold_bf16_predictor(what, out16, out32, ref16, ref32)
    print(f"{what}: {len(pred._program.global_block.ops)} ops saved from the "
          f"for_test clone (training losses {[round(x, 4) for x in losses]}); "
          f"fp32 logits bit for bit the direct run's, {d32:.3e} from the "
          f"plain-torch oracle on the saved files in relative L2 (limit "
          f"{INFER_FP32_L2}); bf16 {d16:.3e} from fp32 (limit {lim:.3e}: the "
          f"bf16 oracle is {d_ref:.3e} from the fp32 oracle); launches "
          f"{c32} and {c16} [{card}]")
    _refuses(what, pred16, img_feed, out32, lim, nn_ops, "bn_apply_act",
             lambda real: lambda x2, s, b, m, inv, *a: real(
                 x2, s, b, m, torch.roll(inv, -1), *a),
             "K8 reading the variance one channel on")
    del P, ref32, ref16, direct, exe, scope, main
    rates = [_serve_predictor(p, img_feed, IR_B, card, f"{what} {dt}",
                              "images") for p, dt in ((pred, "fp32"),
                                                      (pred16, "bf16"))]
    return [{k: v for k, v in c.items()} for c in (c32, c16)], rates


def _bert_features(P, ids, pos, cfg, ln_names, low=torch.float32):
    """The last encoder layer's output of BERT in plain torch over the
    arrays P: F.layer_norm, the plain attention, F.gelu. In bf16, the bf16
    predictor's casts: every array rounded to bf16, each product, bias add,
    residual add and layer norm's output rounded once, the norms and the
    attention's softmax computed in fp32 and its probabilities rounded
    before they weigh V."""
    import torch.nn.functional as F

    H, nh = cfg.hidden_size, cfg.num_heads
    dh = H // nh
    lns = iter(ln_names)
    c = lambda t: t.to(low)  # noqa: E731

    def fc(x, pre):
        return (x @ c(P[pre + ".w"])) + c(P[pre + ".b"])

    def ln(x):
        sn, bn = next(lns)
        return F.layer_norm(x.float(), (H,), c(P[sn]).float(),
                            c(P[bn]).float(), 1e-5).to(low)

    x = ln(c(P["encoder.word_emb"])[ids] + c(P["encoder.pos_emb"])[pos])
    B, S = ids.shape
    for i in range(cfg.num_layers):
        pre = f"encoder.layer{i}"
        qkv = fc(x, pre + ".mha.qkv").reshape(B, S, 3, nh, dh)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        p = torch.softmax((q.float() @ k.float().transpose(-1, -2))
                          * dh ** -0.5, dim=-1).to(low)
        a = (p.float() @ v.float()).to(low)
        x = ln(x + fc(a.transpose(1, 2).reshape(B, S, H), pre + ".mha.out"))
        x = ln(x + fc(F.gelu(fc(x, pre + ".ffn.in")), pre + ".ffn.out"))
    return x


def infer_bert(dev, card):
    """BERT-base (bench.py:107 BERT_BASE, S=IB_S) as feature extraction:
    bert_pretrain's for_test clone saved with feeds src_ids and pos_ids and
    the last encoder layer's output as the target, served at B=IB_B by fp32
    and bf16 predictors, held as in infer_resnet: fp32 bit for bit the
    direct run of the clone and within INFER_FP32_L2 of the plain-torch
    oracle on the saved files, 12 K2 forward and 25 K3 launches in each
    dtype and no K4-K7; the bf16 gate, which must refuse K2 reading the
    keys one position on. tokens/s, peak memory and device busy."""
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.inference import (AnalysisConfig, NativeConfig,
                                            create_paddle_predictor)
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import attention_ops

    what = f"BERT-base predictor B={IB_B} S={IB_S}"
    cfg = _bert_cfg(IB_S)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        transformer.bert_pretrain(cfg, seq_len=IB_S)
        feat = transformer.last_layer_outputs[-1]
        test_prog = main.clone(for_test=True)
    startup.random_seed = SEED
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {k: torch.from_numpy(v).to(dev)
            for k, v in _bert_feed(cfg, IB_B, IB_S).items()}
    (direct,) = exe.run(test_prog, feed=feed, scope=scope, fetch_list=[feat],
                        return_numpy=False)
    ln_names = [(op.inputs["Scale"][0], op.inputs["Bias"][0])
                for op in test_prog.global_block.ops if op.type == "layer_norm"]
    in_feed = {k: feed[k] for k in ("src_ids", "pos_ids")}
    with tempfile.TemporaryDirectory() as d:
        pt.io.save_inference_model(d, list(in_feed), [feat], exe,
                                   main_program=test_prog, scope=scope)
        pred = create_paddle_predictor(NativeConfig(model_dir=d))
        P = _saved_arrays(d, pred._program, dev)
        pred16 = create_paddle_predictor(AnalysisConfig(model_dir=d,
                                                        enable_bf16=True))
    out32, c32 = _infer_counts(pred, in_feed, what + " fp32")
    out16, c16 = _infer_counts(pred16, in_feed, what + " bf16")
    L = cfg.num_layers
    for dt, got in (("float32", c32), ("bfloat16", c16)):
        if got != {"causal_prefill_attention": {dt: L},
                   "layer_norm_act": {dt: 2 * L + 1}}:
            raise RuntimeError(f"{what} {dt}: launches {got}, want {L} K2 "
                               f"and {2 * L + 1} K3 and nothing else")
    if not torch.equal(out32, direct):
        raise RuntimeError(f"{what}: the fp32 predictor's features are not "
                           f"the direct run's bit for bit")
    ids, pos = feed["src_ids"].long(), feed["pos_ids"].long()
    with torch.no_grad():
        ref32 = _bert_features(P, ids, pos, cfg, ln_names)
        ref16 = _bert_features(P, ids, pos, cfg, ln_names, torch.bfloat16)
    d32 = _rel_l2(out32, ref32)
    if not d32 <= INFER_FP32_L2:
        raise RuntimeError(f"{what}: fp32 predictor {d32:.3e} from the "
                           f"oracle in relative L2, limit {INFER_FP32_L2}")
    d16, lim, d_ref = _hold_bf16_predictor(what, out16, out32, ref16, ref32)
    print(f"{what}: {len(pred._program.global_block.ops)} ops saved from the "
          f"for_test clone; fp32 features bit for bit the direct run's, "
          f"{d32:.3e} from the plain-torch oracle on the saved files in "
          f"relative L2 (limit {INFER_FP32_L2}); bf16 {d16:.3e} from fp32 "
          f"(limit {lim:.3e}: the bf16 oracle is {d_ref:.3e} from the fp32 "
          f"oracle); launches {c32} and {c16} [{card}]")
    _refuses(what, pred16, in_feed, out32, lim, attention_ops,
             "causal_prefill_attention",
             lambda real: lambda q, k, v, **kw: real(
                 q, torch.roll(k, 1, dims=2), v, **kw),
             "K2 reading the keys one position on")
    del P, ref32, ref16, direct, exe, scope, main
    rates = [_serve_predictor(p, in_feed, IB_B * IB_S, card,
                              f"{what} {dt}", "tokens")
             for p, dt in ((pred, "fp32"), (pred16, "bf16"))]
    return [dict(c) for c in (c32, c16)], rates


def _resnet_amp_program(recompute):
    """bench.py:282-306's ResNet-50 AMP program (decorate(Momentum(0.1,
    0.9)), bn_fuse_stats on); with `recompute`, under RecomputeOptimizer
    with checkpoints at the 16 bottleneck outputs (each block's relu after
    its residual add) and the mean loss, so that the head (pool, fc, cross
    entropy, mean) is a segment too. Not the per-image loss: the AMP
    rewrite casts nothing across a segment's boundary, so the fp32 mean
    after it would read the bf16 loss, which the plain program casts to
    fp32 first. Returns (main, startup, loss)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.contrib import mixed_precision as amp
    from paddle_tpu_torch.models import resnet

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        img = L.data(name="img", shape=[RN_HW, RN_HW, 3], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        loss, _, _ = resnet.resnet50(img, label, num_classes=RN_CLASSES,
                                     s2d_stem=True, data_format="NHWC")
        opt = amp.decorate(pt.optimizer.Momentum(RN_LR, RN_MU))
        if recompute:
            ops = main.global_block.ops
            writer = {n: op for op in ops for n in op.output_names}
            checkpoints = [op.outputs["Out"][0] for op in ops
                           if op.type == "relu" and writer[
                               op.inputs["X"][0]].type == "elementwise_add"]
            if len(checkpoints) != 16:
                raise RuntimeError(f"ResNet-50 has 16 bottleneck outputs, "
                                   f"found {len(checkpoints)}")
            checkpoints.append(loss)
            opt = pt.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(checkpoints)
        opt.minimize(loss)
    startup.random_seed = SEED
    return main, startup, loss


def recompute_resnet(dev, card):
    """The ResNet-50 AMP step (bench.py:282-306, B=AMP_B) under
    RecomputeOptimizer (`_resnet_amp_program`) against the plain AMP step
    from the same start: the loss bit for bit the plain step's, every
    gradient within AMP_GRAD_BAND's 2e-2 relative L2 of the plain step's,
    the running statistics after the step the plain step's bit for bit
    (they moved once, not twice: the replays' are discarded), launches by
    dtype as the program says (K8 twice a batch norm, the forward and the
    replay, K9 once through `_BatchNormFn`; K6 twice and K7 once through
    `_XentFn`), the step's peak device memory above its start against the
    plain step's, and ms a step of both. Returns (the launches, a step
    under recompute)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.weights import load_params

    what = f"recompute ResNet-50 AMP B={AMP_B}"
    rng = np.random.default_rng(SEED)
    feed = {"img": torch.from_numpy(rng.standard_normal(
                (AMP_B, RN_HW, RN_HW, 3)).astype(np.float32)).to(dev),
            "label": torch.from_numpy(rng.integers(
                0, RN_CLASSES, (AMP_B, 1)).astype(np.int32)).to(dev)}
    runs = {}
    p0 = None
    for key in ("plain", "recompute"):
        main, startup, loss = _resnet_amp_program(key == "recompute")
        exe, scope = pt.Executor(), pt.Scope()
        exe.run(startup, scope=scope)
        names = [p.name for p in main.all_parameters()]
        if p0 is None:
            p0 = {n: scope.find_var(n).cpu().numpy() for n in names}
        load_params(scope, main, p0)
        stat_names = sorted(n for n in main.global_block.vars
                            if n.endswith(".bn.mean") or n.endswith(".bn.var"))
        from paddle_tpu_torch.ops import cuda_kernels as ck
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        mem = _step_memory()
        out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                      fetch_list=[loss] + [n + "@GRAD" for n in names])
        torch.cuda.synchronize()
        base, peak = mem()
        counts = _check_launches(main, f"{what} ({key})")
        step = lambda e=exe, m=main, s=scope, lv=loss: e.run(  # noqa: E731
            m, feed=feed, scope=s, fetch_list=[lv], return_numpy=False)
        runs[key] = dict(loss=out[0], grads=dict(zip(names, out[1:])),
                         stats={n: scope.find_var(n).clone()
                                for n in stat_names},
                         above=peak - base, peak=peak, counts=counts,
                         step=step, names=names,
                         segments=sum(op.type == "recompute"
                                      for op in main.global_block.ops))
        del out
    plain, rc = runs["plain"], runs["recompute"]
    want = {"bn_apply_act": {"bfloat16": 106},
            "bn_apply_act_backward": {"bfloat16": 53},
            "softmax_xent_fwd": {"bfloat16": 2},
            "softmax_xent_bwd": {"bfloat16": 1}}
    if rc["counts"] != want:
        raise RuntimeError(f"{what}: launches {rc['counts']}, want {want}")
    if not torch.equal(rc["loss"], plain["loss"]):
        raise RuntimeError(f"{what}: loss {float(rc['loss'])!r}, the plain "
                           f"step's {float(plain['loss'])!r}: not bit for bit")
    moved = 0
    for n, t in plain["stats"].items():
        if not torch.equal(rc["stats"][n], t):
            raise RuntimeError(f"{what}: running statistic {n} is "
                               f"{float((rc['stats'][n] - t).abs().max()):.3e}"
                               f" from the plain step's")
        moved += not torch.equal(t, torch.zeros_like(t) if n.endswith(".mean")
                                 else torch.ones_like(t))
    if moved != len(plain["stats"]):
        raise RuntimeError(f"{what}: {len(plain['stats']) - moved} running "
                           f"statistics did not move")
    groups = _grad_groups(rc["names"], rc["grads"], plain["grads"])
    far = max(groups.items(), key=lambda kv: kv[1][1])
    if not far[1][1] <= AMP_GRAD_BAND[1]:
        raise RuntimeError(f"{what}: {far[0]}@GRAD is {far[1][1]:.3e} from "
                           f"the plain step's in relative L2 (limit "
                           f"{AMP_GRAD_BAND[1]})")
    for r in (plain, rc):
        del r["grads"]
    ms = {}
    for key in ("plain", "recompute", "recompute", "plain"):
        r = runs[key]
        r["step"]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RN_STEPS):
            r["step"]()
        torch.cuda.synchronize()
        ms.setdefault(key, []).append(1e3 * (time.perf_counter() - t0)
                                      / RN_STEPS)
    print(f"{what}: {rc['segments']} recompute segments; loss "
          f"{float(rc['loss'])!r} bit for bit the plain step's; "
          f"{len(plain['stats'])} running statistics bit for bit the plain "
          f"step's (moved once); worst gradient {far[0]} {far[1][1]:.3e} from "
          f"the plain step's in relative L2 (limit {AMP_GRAD_BAND[1]}); "
          f"launches by dtype {rc['counts']} (plain step {plain['counts']}); "
          f"peak device memory above the step's start {rc['above'] / 2**30:.3f}"
          f" GiB, plain {plain['above'] / 2**30:.3f} GiB (absolute "
          f"{rc['peak'] / 2**30:.3f} and {plain['peak'] / 2**30:.3f}); ms a "
          f"step (P R R P, {RN_STEPS} steps each) recompute "
          f"{[round(x, 2) for x in ms['recompute']]}, plain "
          f"{[round(x, 2) for x in ms['plain']]} [{card}]")
    return rc["counts"], rc["step"]


# the book's word2vec at its defaults (dict 2000, embed 32, hidden 256,
# 4-gram) at B=100 and dense DeepFM at bench.py:436's on-chip widths (26
# fields, 13 dense, vocab 100,000, embed 16, hidden 400 x 3) at B=2048,
# each under SGD(1e-3) (the book's word2vec optimizer; bench_deepfm's)
W2V_B, DFM_B, BOOK_LR, BOOK_STEPS = 100, 2048, 1e-3, 5
DFM_CFG = dict(n_fields=26, n_dense=13, vocab_size=100_000, embed_dim=16,
               hidden_sizes=(400, 400, 400))


def _w2v_loss(P, fd, fc):
    """word2vec's mean loss in plain torch: the shared table, a sigmoid
    hidden layer, the softmax and -log(p[next] + 1e-12)."""
    emb = torch.cat([P["shared_w"][fd[f"w{i}"].long()[:, 0]]
                     for i in range(4)], dim=1)
    h = torch.sigmoid(emb @ P[fc[0][0]] + P[fc[0][1]])
    p = torch.softmax(h @ P[fc[1][0]] + P[fc[1][1]], dim=-1)
    return -torch.log(p.gather(1, fd["next_word"].long()) + 1e-12).mean()


def _dfm_loss(P, fd, out_b):
    """DeepFM's mean loss in plain torch: the first- and second-order FM
    terms, the relu tower and the stable sigmoid cross entropy."""
    ids, dense, z = fd["sparse_ids"].long(), fd["dense_x"], fd["label"]
    first = P["fm_w1"][ids].sum(dim=1) + dense @ P["fm_dense_w"]
    emb = P["fm_emb"][ids]
    sum_v = emb.sum(dim=1)
    second = 0.5 * (sum_v * sum_v - (emb * emb).sum(dim=1)).sum(
        dim=1, keepdim=True)
    deep = torch.cat([emb.reshape(ids.shape[0], -1), dense], dim=1)
    for i in range(len(DFM_CFG["hidden_sizes"])):
        deep = torch.relu(deep @ P[f"deep_w{i}"] + P[f"deep_b{i}"])
    x = first + second + deep @ P["deep_out_w"] + P[out_b]
    return (torch.clamp(x, min=0) - x * z
            + torch.log1p(torch.exp(-x.abs()))).mean()


def _dfm_out_bias(program):
    """The name of DeepFM's output bias, the one parameter models/deepfm.py
    leaves unnamed."""
    known = {"fm_w1", "fm_dense_w", "fm_emb", "deep_out_w"} | {
        f"deep_{k}{i}" for k in "wb"
        for i in range(len(DFM_CFG["hidden_sizes"]))}
    (out_b,) = [p.name for p in program.all_parameters()
                if p.name not in known]
    return out_b


def _train_book(dev, card, what, build, feed, oracle, n_examples):
    """One book model under SGD(BOOK_LR): step 1's loss and every gradient
    against the plain-torch oracle (GRAD_RTOL of each gradient's max-abs),
    the update p0 - lr g on the port's gradients within fp32 spacing,
    launches as the program says (none: no kernel-backed op), then
    BOOK_STEPS timed steps whose loss must fall. Returns the launches."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        loss, extra = build()
        pt.optimizer.SGD(BOOK_LR).minimize(loss)
    startup.random_seed = SEED
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    names = [p.name for p in main.all_parameters()]
    p0 = {n: scope.find_var(n).clone() for n in names}
    from paddle_tpu_torch.ops import cuda_kernels as ck
    ck.reset_launch_counts()
    out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                  fetch_list=[loss] + [n + "@GRAD" for n in names])
    torch.cuda.synchronize()
    counts = _check_launches(main, what)
    loss1, grads = out[0], dict(zip(names, out[1:]))
    P = {n: t.clone().requires_grad_() for n, t in p0.items()}
    ref = oracle(P, feed, extra)
    ref_grads = dict(zip(names, torch.autograd.grad(ref, [P[n] for n in names])))
    ref = float(ref.detach())
    if not abs(float(loss1) - ref) <= 1e-5 * abs(ref):
        raise RuntimeError(f"{what}: step-1 loss {float(loss1)} vs oracle "
                           f"{ref}")
    worst = upd = 0.0
    for n in names:
        scale = max(float(ref_grads[n].abs().max()), 1e-30)
        e = float((grads[n] - ref_grads[n]).abs().max()) / scale
        if not e <= GRAD_RTOL:
            raise RuntimeError(f"{what}: {n}@GRAD differs from the oracle by "
                               f"{e:.3e} of its max-abs {scale:.3e}")
        worst = max(worst, e)
        spacing = 2.4e-7 * max(float(p0[n].abs().max()), 1e-30)
        upd = max(upd, float((scope.find_var(n) - (p0[n] - BOOK_LR * grads[n]))
                             .abs().max()) / spacing)
    if not upd <= 1.0:
        raise RuntimeError(f"{what}: the SGD update is {upd:.2f} fp32 "
                           f"spacings from p0 - lr g")
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BOOK_STEPS):
        losses.append(exe.run(main, feed=feed, scope=scope, fetch_list=[loss],
                              return_numpy=False)[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(lv) for lv in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < float(loss1):
        raise RuntimeError(f"{what}: the loss did not fall: step 1 "
                           f"{float(loss1)}, then {losses}")
    print(f"{what} step 1: loss {float(loss1):.6f}, oracle {ref:.6f}; "
          f"worst gradient error {worst:.3e} of its max-abs (limit "
          f"{GRAD_RTOL}); SGD update within {upd:.2f} fp32 spacings of p0 - "
          f"lr g; {len(main.global_block.ops)} ops a step, launches {counts}; "
          f"{BOOK_STEPS} steps in {wall:.3f} s: {BOOK_STEPS * n_examples / wall:.1f}"
          f" examples/s; losses {[round(x, 6) for x in losses]} [{card}]")
    return counts


def book_rest(dev, card):
    """word2vec (models/word2vec.py at its defaults, B=W2V_B) and dense
    DeepFM (models/deepfm.py at DFM_CFG, is_sparse=False, B=DFM_B), each
    held by `_train_book`; the data from SEED with numpy."""
    from paddle_tpu_torch.models import deepfm, word2vec

    rng = np.random.default_rng(SEED)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    w2v_feed = {f"w{i}": t(rng.integers(0, 2000, (W2V_B, 1)).astype(np.int32))
                for i in range(4)}
    w2v_feed["next_word"] = t(rng.integers(0, 2000, (W2V_B, 1))
                              .astype(np.int32))

    def w2v():
        loss, _, _ = word2vec.word2vec()
        return loss, [(f"fc_{i}.w_0", f"fc_{i}.b_0") for i in range(2)]

    F_, V = DFM_CFG["n_fields"], DFM_CFG["vocab_size"]
    dfm_feed = {"sparse_ids": t(rng.integers(0, V, (DFM_B, F_)).astype(np.int32)),
                "dense_x": t(rng.random((DFM_B, DFM_CFG["n_dense"]))
                             .astype(np.float32)),
                "label": t(rng.integers(0, 2, (DFM_B, 1)).astype(np.float32))}

    def dfm():
        loss, _, _ = deepfm.deepfm(is_sparse=False, **DFM_CFG)
        from paddle_tpu_torch.framework import default_main_program
        return loss, _dfm_out_bias(default_main_program())

    return [_train_book(dev, card, f"word2vec B={W2V_B}", w2v, w2v_feed,
                        _w2v_loss, W2V_B),
            _train_book(dev, card, f"dense DeepFM B={DFM_B}", dfm, dfm_feed,
                        _dfm_loss, DFM_B)]


# -- DeepFM CTR through train_from_dataset, sparse word2vec, the last
#    sequence and RNN ops

# bench.py:423 bench_deepfm's TPU arm: 8 MultiSlot files of 16384 lines
# from seed 0, QueueDataset at batch 2048 on 4 threads, SGD(1e-3)
CTR_FILES, CTR_LINES, CTR_B, CTR_THREADS, CTR_LR = 8, 16384, 2048, 4, 1e-3
CTR_PASSES = 2                       # timed passes after a warm one (5,
                                     # then 3, before depth cuts)
CTR_DEVICE_ITERS, CTR_DEVICE_WINDOWS = 10, 2   # bench.py's device path (50,
                                               # then 25, then 15 x 3)
CTR_WIDTHS = (26, 13, 1)             # sparse_ids, dense_x, label slots
# a sparse step against the dense step and the oracle: the parameters in
# relative L2 (CUDA's index_add_ adds repeated ids in a varying order)
SPARSE_L2 = 1e-6
# one train_from_dataset pass against a plain loop of Executor.run over the
# same 64 batches: every parameter in relative L2
TRAINER_L2 = 1e-5
LAZY_ADAM_L2 = 1e-6       # touched rows against the oracle, steps 1 and 2
SMOKE_DATA = "_smoke_data"           # under the checkout; .gitignore lists it
W2V_SPARSE_B = 100
# the planted label is 1 where a sample's first dense value exceeds its
# second: a held-out batch's loss must fall and its AUC rise (its loss is
# printed beside ln 2, the loss of the best constant guess on balanced
# labels)
LN2 = float(np.log(2.0))


def _write_ctr_files(dirname, n_files=CTR_FILES, seed=SEED):
    """bench.py:436-451's files: one line a sample, `26 ids 13 dense 1
    label`, the ids and dense values drawn line by line from `seed` as
    bench.py draws them. The label is planted, so that a falling loss means
    the model learns: 1 where the first dense value exceeds the second
    (the label bench.py draws is still drawn, and dropped, so the ids and
    dense values stay bench.py's)."""
    import os

    V = DFM_CFG["vocab_size"]
    nf, nd = DFM_CFG["n_fields"], DFM_CFG["n_dense"]
    rng = np.random.default_rng(seed)
    files = []
    for fi in range(n_files):
        p = os.path.join(dirname, f"part-{fi}")
        with open(p, "w") as f:
            for _ in range(CTR_LINES):
                ids = rng.integers(0, V, nf)
                dense = rng.random(nd).round(4)
                rng.integers(0, 2)
                lbl = int(dense[0] > dense[1])
                f.write(f"{nf} {' '.join(map(str, ids))} "
                        f"{nd} {' '.join(map(str, dense))} 1 {lbl}\n")
        files.append(p)
    return files


def _held_out_ctr(dev, seed=SEED + 1000):
    """One batch of CTR_B samples the trainer never sees, drawn and
    labelled as `_write_ctr_files` draws and labels them."""
    V = DFM_CFG["vocab_size"]
    nf, nd = DFM_CFG["n_fields"], DFM_CFG["n_dense"]
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (CTR_B, nf))
    dense = rng.random((CTR_B, nd)).round(4)
    lbl = (dense[:, 0] > dense[:, 1])[:, None]
    return _on(dev, {"sparse_ids": ids.astype(np.int32),
                     "dense_x": dense.astype(np.float32),
                     "label": lbl.astype(np.float32)})


def _auc(prob, label):
    """The area under the ROC curve of `prob` against 0/1 `label` (Mann-
    Whitney; continuous scores, so no ties)."""
    p, y = prob.reshape(-1).double(), label.reshape(-1).double()
    ranks = torch.empty_like(p)
    ranks[p.argsort()] = torch.arange(1, p.numel() + 1, dtype=p.dtype,
                                      device=p.device)
    n1 = float(y.sum())
    n0 = y.numel() - n1
    return (float((ranks * y).sum()) - n1 * (n1 + 1) / 2) / (n1 * n0)


def _ctr_batches(flats):
    """The 64 batches of the files in file order, cast by numpy as the
    feed vars declare them (ids int32, dense and label float32)."""
    nf, nd = DFM_CFG["n_fields"], DFM_CFG["n_dense"]
    out = []
    for flat in flats:
        for i in range(0, len(flat), CTR_B):
            c = flat[i:i + CTR_B]
            out.append({"sparse_ids": c[:, :nf].astype(np.int32),
                        "dense_x": c[:, nf:nf + nd].astype(np.float32),
                        "label": c[:, nf + nd:].astype(np.float32)})
    return out


def _ctr_program(is_sparse, make_opt):
    """DeepFM at DFM_CFG under make_opt(); returns (main, startup, its
    for_test clone (the loss and the predicted click probability), loss,
    feed vars, the output bias, the probability)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import deepfm

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        loss, prob, feed_names = deepfm.deepfm(is_sparse=is_sparse,
                                               **DFM_CFG)
        test = main.clone(for_test=True)
        make_opt().minimize(loss)
    startup.random_seed = SEED
    return (main, startup, test, loss,
            [main.global_block.var(n) for n in feed_names],
            _dfm_out_bias(main), prob)


def _on(dev, feed):
    return {k: torch.from_numpy(v).to(dev) for k, v in feed.items()}


def _untouched(V, ids, dev):
    mask = torch.ones(V, dtype=torch.bool, device=dev)
    mask[ids.reshape(-1).long()] = False
    return mask


def _check_parse(files, card):
    """The C parser against the plain Python parser, bit for bit on every
    file; a malformed line raises ValueError in both. Returns the parsed
    files."""
    import os

    from paddle_tpu_torch.native import library_path, parse_multislot_file

    t0 = time.perf_counter()
    parse_multislot_file(files[0], list(CTR_WIDTHS))   # builds the library
    build_s = time.perf_counter() - t0
    flats, c_s, py_s = [], 0.0, 0.0
    for p in files:
        t0 = time.perf_counter()
        fast = parse_multislot_file(p, list(CTR_WIDTHS))
        t1 = time.perf_counter()
        plain = parse_multislot_file(p, list(CTR_WIDTHS), native=False)
        py_s += time.perf_counter() - t1
        c_s += t1 - t0
        if fast.shape != (CTR_LINES, sum(CTR_WIDTHS)) or not np.array_equal(
                fast.view(np.int64), plain.view(np.int64)):
            raise RuntimeError(f"parse: the C parser differs from the plain "
                               f"parser on {p}")
        flats.append(fast)
    bad = os.path.join(os.path.dirname(files[0]), "malformed")
    with open(bad, "w") as f:
        f.write("26 1 2 3\n")
    for native in (True, False):
        try:
            parse_multislot_file(bad, list(CTR_WIDTHS), native=native)
        except ValueError:
            continue
        raise RuntimeError(f"parse: a malformed line passed the "
                           f"{'C' if native else 'plain'} parser")
    print(f"ctr parse: {len(files)} files of {CTR_LINES} lines, the C parser "
          f"(built in {build_s:.3f} s into {os.path.relpath(library_path())}) "
          f"equal bit for bit to the plain parser; {1e3 * c_s / len(files):.1f}"
          f" ms a file (plain {1e3 * py_s / len(files):.1f} ms); a malformed "
          f"line raises in both (host CPU) [{card}]")
    return flats


def _sparse_vs_dense(dev, card, what, build, feed, oracle, tables, lr):
    """One SGD step of the sparse program (its tables' grads SelectedRows)
    and one of the dense program from the same startup on one batch: the
    losses bit for bit; each table in `tables` {name: ids tensor} after the
    step within SPARSE_L2 relative L2 of the dense step's and of p0 - lr g
    with the plain-torch oracle's g, its untouched rows bit for bit; the
    sgd ops dispatched under the sync debug mode "error". Returns the
    sparse step's launches and the fetched SelectedRows grads."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    from paddle_tpu_torch.ops import cuda_kernels as ck

    exe = pt.Executor()
    after, losses, counts, srs, p0s = {}, {}, None, None, {}
    for sparse in (True, False):
        main, startup, loss, extra = build(sparse)
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        names = [p.name for p in main.all_parameters()]
        p0 = p0s[sparse] = {n: scope.find_var(n).clone() for n in names}
        seen = {}
        undo = _sync_free(("sgd",), seen)
        try:
            ck.reset_launch_counts()
            out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                          fetch_list=[loss] + ([n + "@GRAD" for n in tables]
                                               if sparse else []))
            torch.cuda.synchronize()
            if sparse:
                counts = _check_launches(main, what)
        finally:
            undo()
        if dev.type == "cuda" and seen.get("sgd") != len(names):
            raise RuntimeError(f"{what}: {seen} sgd dispatches, {len(names)} "
                               f"parameters")
        losses[sparse] = float(out[0])
        after[sparse] = {n: scope.find_var(n) for n in tables}
        if sparse:
            srs = dict(zip(tables, out[1:]))
            for n, sr in srs.items():
                if not isinstance(sr, SelectedRows):
                    raise RuntimeError(f"{what}: {n}@GRAD is {type(sr)}, not "
                                       f"a SelectedRows")
    if losses[True] != losses[False] or not all(
            torch.equal(p0s[True][n], p0s[False][n]) for n in names):
        raise RuntimeError(f"{what}: sparse loss {losses[True]} vs dense "
                           f"{losses[False]} from the same startup")
    p0 = p0s[True]
    P = {n: t.clone().requires_grad_() for n, t in p0.items()}
    ref = oracle(P, feed, extra)
    ref_g = dict(zip(names, torch.autograd.grad(ref, [P[n] for n in names])))
    ref = ref.detach()
    if not abs(float(ref) - losses[True]) <= 1e-5 * abs(float(ref)):
        raise RuntimeError(f"{what}: loss {losses[True]} vs oracle "
                           f"{float(ref)}")
    notes = []
    for n, ids in tables.items():
        want = p0[n] - lr * ref_g[n]
        e_dense = _rel_l2(after[True][n], after[False][n])
        e_ref = _rel_l2(after[True][n], want)
        spacing = float((after[True][n] - want).abs().max()) / (
            2.4e-7 * max(float(p0[n].abs().max()), 1e-30))
        keep = _untouched(p0[n].shape[0], ids, dev)
        if not (e_dense <= SPARSE_L2 and e_ref <= SPARSE_L2):
            raise RuntimeError(f"{what}: {n} after the sparse step is "
                               f"{e_dense:.3e} (dense) / {e_ref:.3e} (oracle) "
                               f"relative L2 away (limit {SPARSE_L2})")
        if not torch.equal(after[True][n][keep], p0[n][keep]):
            raise RuntimeError(f"{what}: untouched rows of {n} moved")
        notes.append(f"{n}: {e_dense:.3e} from the dense step, {e_ref:.3e} "
                     f"from p0 - lr g (at most {spacing:.2f} fp32 spacings), "
                     f"{int(keep.sum())} untouched rows bit for bit")
    print(f"{what} sparse = dense: loss {losses[True]!r} both (oracle "
          f"{float(ref):.6f}); " + "; ".join(notes) + f"; sgd under the sync "
          f"debug mode 'error'; launches {counts} [{card}]")
    return counts, srs


def _adam_oracle(P, M, g, b1p, b2p, touched):
    """The adam op's formula in plain torch on fp32 state: lr_t = lr
    sqrt(1 - b2^t) / (1 - b1^t) from the program's fp32 beta powers
    (1 - fp32(0.999) is 1.3e-5 from 0.001, which moves lr_t by 6e-6 of
    itself); where `touched` is given (a table's rows) only those rows
    move. Returns (p, m1, m2)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    lr_t = (1e-3 * torch.sqrt(1 - b2p) / (1 - b1p)).reshape(())
    m1 = b1 * M[0] + (1 - b1) * g
    m2 = b2 * M[1] + (1 - b2) * g * g
    p = P - lr_t * m1 / (torch.sqrt(m2) + eps)
    if touched is None:
        return p, m1, m2
    t = touched.reshape((-1,) + (1,) * (P.dim() - 1))
    return (torch.where(t, p, P), torch.where(t, m1, M[0]),
            torch.where(t, m2, M[1]))


def _lazy_adam_gate(dev, card, feeds):
    """Two Adam(1e-3) steps of the sparse DeepFM (batches 0 and 1) against
    a plain-torch lazy Adam on the oracle's gradients: after each step,
    fm_w1's and fm_emb's rows the step's ids miss bit for bit what they
    were before it in the parameter and both moments (in step 2 rows that
    step 1 moved, with moments a dense Adam would decay and apply), the
    touched rows within LAZY_ADAM_L2 relative L2 of the oracle, the adam
    ops under the sync debug mode "error"."""
    import paddle_tpu_torch as pt

    main, startup, _, loss, _, out_b, _ = _ctr_program(
        True, lambda: pt.optimizer.Adam(1e-3))
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    names = [p.name for p in main.all_parameters()]
    adams = {op.inputs["Param"][0]: op for op in main.global_block.ops
             if op.type == "adam"}
    state = lambda: {n: tuple(scope.find_var(adams[n].inputs[s][0]).clone()  # noqa: E731
                              for s in ("Param", "Moment1", "Moment2"))
                     for n in names}
    ref = state()
    seen, notes = {}, []
    for step, feed in enumerate(feeds, 1):
        before = state()
        b1p, b2p = (scope.find_var(adams["fm_emb"].inputs[s][0]).clone()
                    for s in ("Beta1Pow", "Beta2Pow"))
        undo = _sync_free(("adam",), seen)
        try:
            exe.run(main, feed=feed, scope=scope, fetch_list=[loss],
                    return_numpy=False)
            torch.cuda.synchronize()
        finally:
            undo()
        after = state()
        P = {n: ref[n][0].clone().requires_grad_() for n in names}
        g = dict(zip(names, torch.autograd.grad(_dfm_loss(P, feed, out_b),
                                                [P[n] for n in names])))
        keep = _untouched(DFM_CFG["vocab_size"], feed["sparse_ids"], dev)
        ref = {n: _adam_oracle(ref[n][0], ref[n][1:], g[n], b1p, b2p,
                               ~keep if n in ("fm_w1", "fm_emb") else None)
               for n in names}
        for n in ("fm_w1", "fm_emb"):
            errs = {}
            for k, got, was, want in zip(("p", "m1", "m2"), after[n],
                                         before[n], ref[n]):
                if not torch.equal(got[keep], was[keep]):
                    raise RuntimeError(f"lazy Adam step {step}: untouched "
                                       f"rows of {n}'s {k} moved")
                errs[k] = _rel_l2(got[~keep], want[~keep])
                if not errs[k] <= LAZY_ADAM_L2:
                    raise RuntimeError(
                        f"lazy Adam step {step}: {n}'s {k} on the touched "
                        f"rows is {errs[k]:.3e} relative L2 from the oracle "
                        f"(limit {LAZY_ADAM_L2})")
            moved = int((before[n][1][keep] != 0).any(dim=-1).sum())
            notes.append(f"step {step} {n}: {int((~keep).sum())} touched rows "
                         f"within " + ", ".join(f"{k} {e:.3e}"
                                                for k, e in errs.items())
                         + f"; {int(keep.sum())} untouched rows bit for bit "
                           f"({moved} of them with nonzero moments)")
    if dev.type == "cuda" and seen.get("adam") != len(feeds) * len(names):
        raise RuntimeError(f"lazy Adam: {seen} adam dispatches")
    print(f"DeepFM lazy Adam: " + "; ".join(notes) + f"; "
          f"{seen.get('adam', 0)} adam ops under the sync debug mode 'error' "
          f"[{card}]")


def _check_loader(exe, main, batches, card):
    """DeviceLoader-staged feeds: copied on the placement's own side
    stream (not the consumer's), each tensor on the card and bit for bit
    the host array."""
    from paddle_tpu_torch.pipeline import DeviceLoader

    place = exe.feed_placer(main)
    staged = place(batches[0])
    if staged.stream is None or staged.event is None or \
            staged.stream == torch.cuda.current_stream():
        raise RuntimeError("loader: the batch was not copied on a side stream")
    side = staged.stream
    got = [staged.ready()] + list(DeviceLoader(
        lambda: iter(batches[1:8]), depth=2, placement=place))
    for feed, host in zip(got, batches[:8]):
        for k, a in host.items():
            t = feed[k]
            if not t.is_cuda or not torch.equal(t.cpu(), torch.from_numpy(a)):
                raise RuntimeError(f"loader: {k} differs from the host array")
    if len(got) != 8:
        raise RuntimeError(f"loader: {len(got)} batches of 8")
    print(f"ctr loader: 8 batches staged by DeviceLoader equal the host "
          f"arrays bit for bit, copied from pinned memory on the side stream "
          f"{side.cuda_stream:#x} (the consumer's is "
          f"{torch.cuda.current_stream().cuda_stream:#x}) [{card}]")


def ctr_deepfm(dev, card):
    """DeepFM CTR training through Executor.train_from_dataset at
    bench.py:423 bench_deepfm's widths, held by the gates of the parse,
    sparse = dense, the trainer loop, lazy Adam and the loader; then
    bench.py's report: examples/s end to end and on a resident batch,
    their ratio, the device's busy share and the host split."""
    import os
    import shutil

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import profiler as pprof

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        SMOKE_DATA, "ctr")
    shutil.rmtree(data, ignore_errors=True)
    os.makedirs(data)
    try:
        t0 = time.perf_counter()
        files = _write_ctr_files(data)
        print(f"ctr data: {CTR_FILES} files x {CTR_LINES} lines written in "
              f"{time.perf_counter() - t0:.2f} s (host)")
        flats = _check_parse(files, card)
        batches = _ctr_batches(flats)
        feed0 = _on(dev, batches[0])

        def build(sparse):
            main, startup, _, loss, _, out_b, _ = _ctr_program(
                sparse, lambda: pt.optimizer.SGD(CTR_LR))
            return main, startup, loss, out_b

        counts, srs = _sparse_vs_dense(
            dev, card, f"DeepFM B={CTR_B}", build, feed0, _dfm_loss,
            {"fm_w1": feed0["sparse_ids"], "fm_emb": feed0["sparse_ids"]},
            CTR_LR)
        K = CTR_B * DFM_CFG["n_fields"]
        for n, sr in srs.items():
            if sr.rows.shape != (K,) or sr.height != DFM_CFG["vocab_size"]:
                raise RuntimeError(f"DeepFM: {n}@GRAD has {sr.rows.shape} "
                                   f"rows of height {sr.height}")
        _lazy_adam_gate(dev, card, [feed0, _on(dev, batches[1])])

        main, startup, test, loss, use_vars, _, prob = _ctr_program(
            True, lambda: pt.optimizer.SGD(CTR_LR))
        exe = pt.Executor()
        held = _held_out_ctr(dev)

        def dataset(threads):
            ds = pt.DatasetFactory().create_dataset("QueueDataset")
            ds.set_batch_size(CTR_B)
            ds.set_thread(threads)
            ds.set_use_var(use_vars)
            ds.set_filelist(files)
            return ds

        # one thread: file order, against the plain loop
        scope, plain = pt.Scope(), pt.Scope()
        exe.run(startup, scope=scope)
        exe.run(startup, scope=plain)
        (loss0,) = exe.run(test, feed=feed0, fetch_list=[loss], scope=scope)
        held0, p0 = exe.run(test, feed=held, fetch_list=[loss, prob],
                            scope=scope, return_numpy=False)
        auc0 = _auc(p0, held["label"])
        held0 = float(held0)
        exe.train_from_dataset(main, dataset(1), scope=scope,
                               print_period=10**9)
        for b in batches:
            exe.run(main, feed=b, scope=plain)
        torch.cuda.synchronize()
        worst = max((_rel_l2(scope.find_var(p.name), plain.find_var(p.name)),
                     p.name) for p in main.all_parameters())
        if not worst[0] <= TRAINER_L2:
            raise RuntimeError(f"trainer: {worst[1]} after a one-thread pass is "
                               f"{worst[0]:.3e} relative L2 from the plain loop "
                               f"(limit {TRAINER_L2})")
        print(f"ctr trainer: one train_from_dataset pass on 1 thread over "
              f"{len(batches)} batches ends within {worst[0]:.3e} relative L2 "
              f"of a plain Executor.run loop (worst {worst[1]}; limit "
              f"{TRAINER_L2}) [{card}]")
        _check_loader(exe, main, batches, card)

        # four threads: the warm pass, then the timed passes
        pprof.stage_counters(reset=True)
        exe.train_from_dataset(main, dataset(CTR_THREADS), scope=scope,
                               print_period=10**9)
        snap = pprof.stage_counters(reset=True)
        n_b = snap["pipeline.host_ingest"]["events"]
        if n_b != len(batches) or snap["dataset.assemble"]["events"] != n_b:
            raise RuntimeError(f"trainer: a {CTR_THREADS}-thread pass consumed "
                               f"{snap}, not {len(batches)} batches")
        walls = []
        for _ in range(CTR_PASSES):
            pprof.stage_counters(reset=True)
            t0 = time.perf_counter()
            exe.train_from_dataset(main, dataset(CTR_THREADS), scope=scope,
                                   print_period=10**9)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            snap = pprof.stage_counters()
        n_ex = CTR_FILES * CTR_LINES
        e2e = [n_ex / w for w in walls]
        busy = _profile(lambda: exe.train_from_dataset(
            main, dataset(CTR_THREADS), scope=scope, print_period=10**9),
            card, "DeepFM train_from_dataset pass")
        dev_feed = {"sparse_ids": feed0["sparse_ids"],
                    "dense_x": feed0["dense_x"], "label": feed0["label"]}
        exe.run(main, feed=dev_feed, scope=scope)
        dev_windows = _timed_windows(lambda: exe.run(main, feed=dev_feed,
                                                     scope=scope),
                                     CTR_DEVICE_ITERS, CTR_DEVICE_WINDOWS)
        device = CTR_B / min(dev_windows)
        (loss1,) = exe.run(test, feed=feed0, fetch_list=[loss], scope=scope)
        if not (np.isfinite(loss1) and float(loss1) < float(loss0)):
            raise RuntimeError(f"DeepFM: batch 0's loss went from "
                               f"{float(loss0)} to {float(loss1)}")
        held1, p1 = exe.run(test, feed=held, fetch_list=[loss, prob],
                            scope=scope, return_numpy=False)
        auc1 = _auc(p1, held["label"])
        held1 = float(held1)
        if not (held1 < held0 and auc1 > auc0):
            raise RuntimeError(
                f"DeepFM did not learn the planted label: a held-out batch's "
                f"loss {held0:.6f} -> {held1:.6f}, AUC {auc0:.4f} -> "
                f"{auc1:.4f}")
        split = ", ".join(f"{k} {v['seconds']:.4f} s / {v['events']}"
                          for k, v in sorted(snap.items()))
        busy_txt = "not measured" if busy is None else f"{100 * busy:.1f}%"
        print(f"DeepFM train_from_dataset (B={CTR_B}, {CTR_THREADS} threads, "
              f"{n_ex} examples a pass): end to end {max(e2e):.1f} examples/s "
              f"(best of {CTR_PASSES} passes; passes {[round(x, 1) for x in e2e]}"
              f"), device path {device:.1f} examples/s (best of windows "
              f"{[round(1e3 * w, 3) for w in dev_windows]} ms a step), ratio "
              f"{max(e2e) / device:.3f}; device busy {busy_txt} of a pass; "
              f"host split of the last pass (thread-seconds / events): {split}"
              f"; batch 0's loss {float(loss0):.6f} -> {float(loss1):.6f}, a "
              f"held-out batch's (label planted: dense[0] > dense[1]) "
              f"{held0:.6f} -> {held1:.6f} (ln 2 = {LN2:.6f}), AUC "
              f"{auc0:.4f} -> {auc1:.4f} [{card}]")
        return counts
    finally:
        shutil.rmtree(data, ignore_errors=True)


# -- tiered giant embeddings: bench.py:639 bench_deepfm_giant's TPU arm

# bench.py:652-656: fm_emb 10M x 16 fp32 (640 MB) against a 64 MB budget, 4
# files of 16384 zipf-1.5 lines, QueueDataset at B=2048 on 4 threads
GIANT_VOCAB, GIANT_BUDGET_MB, GIANT_FILES = 10_000_000, 64.0, 4
GIANT_SLOTS = 1 << 20                 # 64 MB / 64-byte rows
GIANT_EVICT_SLOTS = 8192              # ~4x a batch's distinct ids
# tools/gate.py:123 EMB_PARITY_ATOL and :129 EMB_HIT_RATE_FLOOR
EMB_PARITY_ATOL, EMB_HIT_RATE_FLOOR = 1e-4, 0.5
STALL_S, STALL_LIMIT_S = 0.3, 10.0    # the chaos drills' window and limit
EMB_FLAGS = ("emb_hbm_budget_mb", "emb_cache_slots", "emb_ckpt_base_every",
             "watchdog_stall_s", "max_inflight_steps")


def _write_giant_files(dirname):
    """bench.py:684-697's files: one line a sample, `26 ids 13 dense 1
    label`, the ids zipf(1.5) - 1 mod the vocabulary, drawn line by line
    from seed 0 as bench.py draws them."""
    import os

    nf, nd = DFM_CFG["n_fields"], DFM_CFG["n_dense"]
    rng = np.random.default_rng(SEED)
    files = []
    for fi in range(GIANT_FILES):
        p = os.path.join(dirname, f"part-{fi}")
        with open(p, "w") as f:
            for _ in range(CTR_LINES):
                ids = (rng.zipf(1.5, nf) - 1) % GIANT_VOCAB
                dense = rng.random(nd).round(4)
                lbl = rng.integers(0, 2)
                f.write(f"{nf} {' '.join(map(str, ids))} "
                        f"{nd} {' '.join(map(str, dense))} 1 {lbl}\n")
        files.append(p)
    return files


def _giant_program(budget_mb, slots=0):
    """DeepFM at bench_deepfm_giant's widths under SGD(CTR_LR) with
    FLAGS_emb_hbm_budget_mb = budget_mb (and FLAGS_emb_cache_slots =
    slots); returns (main, startup, loss, feed vars)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import flags, unique_name
    from paddle_tpu_torch.models import deepfm

    flags.set_flags({"emb_hbm_budget_mb": budget_mb,
                     "emb_cache_slots": slots})
    cfg = dict(DFM_CFG, vocab_size=GIANT_VOCAB)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        loss, _, feed_names = deepfm.deepfm(**cfg)
        pt.optimizer.SGD(CTR_LR).minimize(loss)
    startup.random_seed = SEED
    return (main, startup, loss,
            [main.global_block.var(n) for n in feed_names])


def _tiered_parity_on_card(dev, card):
    """bench.py:557 _tiered_parity on the card: a 512 x 8 table behind a
    256-slot cache (6 fields, B=32) and the dense-lookup program, 12 SGD(0.1)
    steps from the same values over the same batches: every parameter
    within EMB_PARITY_ATOL, evictions, and as many write-backs as
    evictions. Returns the tiered (main, startup, loss) for the drills."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import flags, layers as L, unique_name
    from paddle_tpu_torch.param_attr import ParamAttr

    V, D, F, B = 512, 8, 6, 32

    def minimized(budget, slots):
        flags.set_flags({"emb_hbm_budget_mb": budget,
                         "emb_cache_slots": slots})
        m, st = pt.Program(), pt.Program()
        m.random_seed = st.random_seed = 7
        with pt.program_guard(m, st), unique_name.guard():
            ids = L.data(name="ids", shape=[F], dtype="int64")
            label = L.data(name="label", shape=[1], dtype="float32")
            emb = L.embedding(ids, size=[V, D], is_sparse=True,
                              param_attr=ParamAttr(name="ptbl"))
            logit = L.fc(L.reduce_sum(emb, dim=1), size=1,
                         param_attr=ParamAttr(name="pw"),
                         bias_attr=ParamAttr(name="pb"))
            loss = L.mean(L.sigmoid_cross_entropy_with_logits(logit, label))
            pt.optimizer.SGD(0.1).minimize(loss)
        return m, st, loss

    def feed(s):
        rng = np.random.default_rng(500 + s)
        return {"ids": rng.integers(0, V, (B, F)).astype(np.int64),
                "label": rng.integers(0, 2, (B, 1)).astype(np.float32)}

    exe = pt.Executor()
    dense, tiered = minimized(0.0, 0), minimized(0.001, 256)
    sd, st = pt.Scope(), pt.Scope()
    exe.run(dense[1], scope=sd)
    exe.run(tiered[1], scope=st)
    eng = tiered[0]._tiered_engine
    eng.tables["ptbl"].host.load_rows(np.arange(V),
                                      sd.find_var("ptbl").cpu().numpy())
    eng.tables["ptbl"].host.clear_dirty()
    for n in ("pw", "pb"):
        st.set_var(n, sd.find_var(n).clone())
    for s in range(12):
        exe.run(dense[0], feed=feed(s), fetch_list=[dense[2]], scope=sd)
        exe.run_async(tiered[0], feed=feed(s), fetch_list=[tiered[2]],
                      scope=st)
    exe.wait()
    eng.flush_all()
    stats = eng.stats("ptbl")
    drift = max(float(np.abs(eng.export_dense("ptbl", st)
                             - sd.find_var("ptbl").cpu().numpy()).max()),
                *(float((st.find_var(n) - sd.find_var(n)).abs().max())
                  for n in ("pw", "pb")))
    if not (drift <= EMB_PARITY_ATOL and stats["evictions"] > 0
            and stats["writebacks"] == stats["evictions"]):
        raise RuntimeError(f"tiered parity: drift {drift:.3e} (limit "
                           f"{EMB_PARITY_ATOL}), {stats}")
    print(f"tiered parity (bench.py:557 on the card): 12 SGD(0.1) steps of a "
          f"512 x 8 table behind a 256-slot cache end {drift:.3e} from the "
          f"dense-lookup program (limit {EMB_PARITY_ATOL}); "
          f"{stats['evictions']} evictions, {stats['writebacks']} write-backs, "
          f"hit rate {stats['hit_rate']} [{card}]")
    return tiered


def _giant_pass(exe, main, ds, scope):
    t0 = time.perf_counter()
    exe.train_from_dataset(main, ds, scope=scope, print_period=10**9)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _giant_arm(exe, main, startup, dataset):
    """A warm train_from_dataset pass and CTR_PASSES timed ones on 4
    threads: (examples/s of each timed pass, the scope, the last pass's
    stage counters)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import profiler as pprof

    scope = pt.Scope()
    exe.run(startup, scope=scope)
    _giant_pass(exe, main, dataset(CTR_THREADS), scope)
    rates = []
    for _ in range(CTR_PASSES):
        pprof.stage_counters(reset=True)
        rates.append(GIANT_FILES * CTR_LINES
                     / _giant_pass(exe, main, dataset(CTR_THREADS), scope))
    return rates, scope, pprof.stage_counters()


def _evicting_arm(dev, card, exe, files):
    """FLAGS_emb_cache_slots = GIANT_EVICT_SLOTS at full width: one
    one-thread pass (file order) of the tiered program, evicting every
    batch and writing back through the loader's async path, against the
    no-budget program over the same batches from the same values: fm_emb
    (export_dense) and every other parameter within EMB_PARITY_ATOL, as
    many write-backs as evictions; then two steps with every op's compute
    under the sync debug mode "error". Returns (the tiered program, its
    scope, the launches of the gated steps)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda_kernels as ck

    def dataset(prog_vars):
        ds = pt.DatasetFactory().create_dataset("QueueDataset")
        ds.set_batch_size(CTR_B)
        ds.set_thread(1)
        ds.set_use_var(prog_vars)
        ds.set_filelist(files)
        return ds

    tm, ts, tl, tvars = _giant_program(GIANT_BUDGET_MB, GIANT_EVICT_SLOTS)
    dm, ds_, dl, dvars = _giant_program(0.0)
    eng = tm._tiered_engine
    st, sd = pt.Scope(), pt.Scope()
    exe.run(ts, scope=st)
    exe.run(ds_, scope=sd)
    host = eng.tables["fm_emb"].host
    sd.set_var("fm_emb", torch.from_numpy(host.to_dense()).to(dev))
    names = [p.name for p in dm.all_parameters() if p.name != "fm_emb"]
    for n in names:
        st.set_var(n, sd.find_var(n).clone())
    t0 = time.perf_counter()
    exe.train_from_dataset(tm, dataset(tvars), scope=st, print_period=10**9)
    torch.cuda.synchronize()
    t_tiered = time.perf_counter() - t0
    exe.train_from_dataset(dm, dataset(dvars), scope=sd, print_period=10**9)
    torch.cuda.synchronize()
    eng.flush_all()
    stats = eng.stats("fm_emb")
    table = eng.export_dense("fm_emb", st)
    errs = {"fm_emb": float(np.abs(table - sd.find_var("fm_emb").cpu()
                                   .numpy()).max())}
    for n in names:
        errs[n] = float((st.find_var(n) - sd.find_var(n)).abs().max())
    worst = max(errs, key=errs.get)
    other = max((n for n in errs if n != "fm_emb"), key=errs.get)
    if not (errs[worst] <= EMB_PARITY_ATOL and stats["evictions"] > 0
            and stats["writebacks"] == stats["evictions"]):
        raise RuntimeError(f"evicting arm: {worst} {errs[worst]:.3e} from "
                           f"the dense program (limit {EMB_PARITY_ATOL}), "
                           f"{stats}")
    batches = _ctr_batches_of(files)
    types = sorted({op.type for op in tm.global_block.ops})
    seen = {}
    undo = _sync_free(types, seen)
    try:
        ck.reset_launch_counts()
        for b in batches[:2]:
            exe.run(tm, feed=b, fetch_list=[tl], scope=st,
                    return_numpy=False)
        torch.cuda.synchronize()
        counts = _check_launches(tm, "DeepFM giant, evicting")
    finally:
        undo()
    n_ops = sum(seen.values())
    if sorted(seen) != types or min(seen.values()) < 2:
        raise RuntimeError(f"evicting arm: op computes under the sync debug "
                           f"mode in 2 steps: {seen}")
    print(f"DeepFM giant, evicting arm (FLAGS_emb_cache_slots="
          f"{GIANT_EVICT_SLOTS}): a one-thread pass of {len(batches)} batches "
          f"in {t_tiered:.2f} s, {stats['evictions']} evictions, "
          f"{stats['writebacks']} write-backs landed off the step, hit rate "
          f"{stats['hit_rate']}, prefetch width {stats['prefetch_rows']} "
          f"({stats.get('prefetch_grows', 0)} grows); against the no-budget "
          f"program over the same batches: fm_emb (export_dense) "
          f"{errs['fm_emb']:.3e}, worst other {other} {errs[other]:.3e} "
          f"(limit {EMB_PARITY_ATOL}); 2 more steps with all {n_ops} op "
          f"computes ({len(types)} op types) under the sync debug mode "
          f"'error'; launches {counts} [{card}]")
    return tm, st, tl, batches, counts


def _ctr_batches_of(files):
    """The files' batches in file order, as the feed vars declare them."""
    from paddle_tpu_torch.native import parse_multislot_file

    return _ctr_batches([parse_multislot_file(p, list(CTR_WIDTHS))
                         for p in files])


def _delta_checkpoints(exe, card, main, scope, loss, batches, root):
    """CheckpointManager over the evicting arm's program with
    FLAGS_emb_ckpt_base_every=2: a save after each of 4 steps (full bases at
    the first and the third, deltas between), the host tier overwritten
    with zeros and restored: the table equal bit for bit to the snapshot
    after the 4th save, the cache cold, one more step's loss finite."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.resilience import CheckpointManager

    flags.set_flags({"emb_ckpt_base_every": 2})
    eng = main._tiered_engine
    host = eng.tables["fm_emb"].host
    mgr = CheckpointManager(root, main_program=main, scope=scope)
    secs, frags = [], []
    for step, b in enumerate(batches[2:6]):
        exe.run(main, feed=b, fetch_list=[loss], scope=scope)
        t0 = time.perf_counter()
        mgr.save(step, executor=exe)
        secs.append(time.perf_counter() - t0)
        frags.append(mgr.read_manifest(step)["extra"]["tiered_embedding"]
                     ["tables"]["fm_emb"])
    snap = eng.export_dense("fm_emb", scope)
    for sh in host.shards:
        sh[...] = 0
    t0 = time.perf_counter()
    got = mgr.restore(executor=exe)
    t_restore = time.perf_counter() - t0
    same = got == 3 and np.array_equal(host.to_dense(), snap)
    cold = not eng.tables["fm_emb"].row2slot
    (lv,) = exe.run(main, feed=batches[6], fetch_list=[loss], scope=scope)
    bases = [f["base_step"] for f in frags]
    if not (same and cold and np.isfinite(lv).all() and bases == [0, 0, 2, 2]):
        raise RuntimeError(f"delta checkpoints: restored step {got}, table "
                           f"equal {same}, cache cold {cold}, loss {lv}, "
                           f"bases {bases}")
    print(f"delta checkpoints (CheckpointManager, FLAGS_emb_ckpt_base_every="
          f"2): saves after 4 steps took {[round(s, 3) for s in secs]} s "
          f"(bases of {host.nbytes / 2**20:.0f} MiB at the 1st and 3rd, "
          f"deltas of {[f['delta_rows'] for f in frags]} rows); the zeroed "
          f"host tier restored in {t_restore:.3f} s, bit for bit the "
          f"snapshot, the cache cold; the next step's loss {float(lv):.6f} "
          f"[{card}]")


def _stall_drills(card, exe, small):
    """Chaos on the card, FLAGS_watchdog_stall_s = STALL_S: the
    emb_host_stall site parks the resolver on the DeviceLoader's thread,
    and pipeline_stall makes run_async's oldest step one that never
    completes; each must raise StallError (naming the DeviceLoader with its
    queue depth; naming the step with the steps in flight and the stage
    counters) within STALL_LIMIT_S."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.pipeline import DeviceLoader
    from paddle_tpu_torch.resilience import StallError, fault_scope

    main, startup, loss = small
    flags.set_flags({"watchdog_stall_s": STALL_S, "max_inflight_steps": 2})
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feeds = []
    for s in range(4):
        rng = np.random.default_rng(900 + s)
        feeds.append({"ids": rng.integers(0, 512, (32, 6)).astype(np.int64),
                      "label": rng.integers(0, 2, (32, 1)).astype(np.float32)})
    got = {}
    t0 = time.perf_counter()
    with fault_scope("emb_host_stall:2"):
        it = iter(DeviceLoader(lambda: iter(feeds), depth=1,
                               placement=exe.feed_placer(main)))
        exe.run_async(main, feed=next(it), fetch_list=[loss], scope=scope)
        try:
            for feed in it:
                exe.run_async(main, feed=feed, fetch_list=[loss], scope=scope)
        except StallError as e:
            got["emb_host_stall"] = (e, time.perf_counter() - t0)
        it.close()
    exe.wait()
    t0 = time.perf_counter()
    with fault_scope("pipeline_stall:1"):
        try:
            for feed in feeds[:3]:
                exe.run_async(main, feed=feed, fetch_list=[loss], scope=scope)
        except StallError as e:
            got["pipeline_stall"] = (e, time.perf_counter() - t0)
    exe.wait()
    ok = {
        "emb_host_stall": lambda e: "DeviceLoader" in e.what
        and "queue_depth" in e.state,
        "pipeline_stall": lambda e: "Executor async step" in e.what
        and len(e.state.get("inflight_step_ids", ())) == 3
        and "emb.resolved_batches" in e.state.get("profiler_stages", {})}
    for site, check in ok.items():
        if site not in got or not check(got[site][0]) or \
                got[site][1] > STALL_LIMIT_S:
            raise RuntimeError(f"stall drill {site}: {got.get(site)}")
    print(f"stall drills (FLAGS_watchdog_stall_s={STALL_S}): emb_host_stall "
          f"raised StallError in {got['emb_host_stall'][1]:.2f} s "
          f"({got['emb_host_stall'][0].what!r}, queue depth "
          f"{got['emb_host_stall'][0].state['queue_depth']}); pipeline_stall "
          f"in run_async's drain in {got['pipeline_stall'][1]:.2f} s "
          f"({got['pipeline_stall'][0].what!r}, in flight "
          f"{got['pipeline_stall'][0].state['inflight_step_ids']}) [{card}]")


def ctr_giant(dev, card):
    """DeepFM at bench.py:639 bench_deepfm_giant's TPU arm with its fm_emb
    (10M x 16 fp32, 640 MB) tiered behind a 64 MB device cache: bench.py:557's
    parity on the card, the full-width arm through train_from_dataset
    beside the same program with no budget, an evicting arm against the
    dense program, the host tier's delta checkpoints and the two stall
    drills. Returns the evicting arm's launches (none)."""
    import os
    import shutil

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import flags

    saved = {k: flags.get_flag(k) for k in EMB_FLAGS}
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        SMOKE_DATA, "giant")
    shutil.rmtree(data, ignore_errors=True)
    os.makedirs(data)
    try:
        small = _tiered_parity_on_card(dev, card)
        t0 = time.perf_counter()
        files = _write_giant_files(data)
        print(f"giant data: {GIANT_FILES} files x {CTR_LINES} zipf(1.5) lines "
              f"written in {time.perf_counter() - t0:.2f} s (host)")
        exe = pt.Executor()
        t0 = time.perf_counter()
        main, startup, loss, use_vars = _giant_program(GIANT_BUDGET_MB)
        t_build = time.perf_counter() - t0
        eng = getattr(main, "_tiered_engine", None)
        if eng is None or sorted(eng.tables) != ["fm_emb"] or \
                eng.tables["fm_emb"].slots != GIANT_SLOTS:
            raise RuntimeError(f"giant: the rewrite tiered "
                               f"{sorted(eng.tables) if eng else []}, not "
                               f"fm_emb at {GIANT_SLOTS} slots")

        def dataset(threads, vs=use_vars):
            ds = pt.DatasetFactory().create_dataset("QueueDataset")
            ds.set_batch_size(CTR_B)
            ds.set_thread(threads)
            ds.set_use_var(vs)
            ds.set_filelist(files)
            return ds

        rates, scope, snap = _giant_arm(exe, main, startup, dataset)
        busy = _profile(lambda: exe.train_from_dataset(
            main, dataset(CTR_THREADS), scope=scope, print_period=10**9),
            card, "DeepFM giant train_from_dataset pass")
        eng.flush_all()
        st = eng.stats("fm_emb")
        if not (st["hit_rate"] is not None
                and st["hit_rate"] >= EMB_HIT_RATE_FLOOR):
            raise RuntimeError(f"giant: hit rate {st['hit_rate']} below "
                               f"{EMB_HIT_RATE_FLOOR}: {st}")
        del main, startup, scope, eng
        dm, dst, _, dvars = _giant_program(0.0)
        drates, _, _ = _giant_arm(exe, dm, dst, lambda t: dataset(t, dvars))
        del dm, dst
        torch.cuda.empty_cache()
        split = ", ".join(f"{k} {v['seconds']:.4f} s / {v['events']}"
                          for k, v in sorted(snap.items()))
        busy_txt = "not measured" if busy is None else f"{100 * busy:.1f}%"
        print(f"DeepFM giant (bench.py:639, fm_emb {GIANT_VOCAB} x "
              f"{DFM_CFG['embed_dim']} fp32 tiered at FLAGS_emb_hbm_budget_mb="
              f"{GIANT_BUDGET_MB:g}: {st['slots']} slots, fm_w1 dense; host "
              f"tier {st['host_bytes'] / 2**20:.0f} MiB against the "
              f"{GIANT_BUDGET_MB:g} MiB budget; built in {t_build:.2f} s): "
              f"{max(rates):.1f} examples/s end to end (best of {CTR_PASSES} "
              f"passes on {CTR_THREADS} threads; passes "
              f"{[round(r, 1) for r in rates]}); the same program with no "
              f"budget (fm_emb dense on the card) {max(drates):.1f} (passes "
              f"{[round(r, 1) for r in drates]}), ratio "
              f"{max(rates) / max(drates):.3f}; hit rate {st['hit_rate']} "
              f"(floor {EMB_HIT_RATE_FLOOR}), {st['miss_ids']} missed and "
              f"{st['hit_ids']} hit id occurrences over {st['batches']} "
              f"batches, {st['resident_rows']} rows resident, prefetch width "
              f"{st['prefetch_rows']}, {st.get('evictions', 0)} evictions; "
              f"device busy {busy_txt} of a pass; stage counters of the last "
              f"timed pass (thread-seconds / events): {split} [{card}]")
        tm, ts, tl, batches, counts = _evicting_arm(dev, card, exe, files)
        _delta_checkpoints(exe, card, tm, ts, tl, batches,
                           os.path.join(data, "ckpt"))
        del tm, ts
        _stall_drills(card, exe, small)
        return counts
    finally:
        flags.set_flags(saved)
        shutil.rmtree(data, ignore_errors=True)


def sparse_word2vec(dev, card):
    """word2vec at the book's defaults with is_sparse=True at B =
    W2V_SPARSE_B: the sparse step against the dense step and the oracle as
    DeepFM's, and the shared table's grad the four lookups' SelectedRows
    concatenated (4 B rows of height 2000)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import word2vec

    rng = np.random.default_rng(SEED)
    feed = {f"w{i}": rng.integers(0, 2000, (W2V_SPARSE_B, 1)).astype(np.int32)
            for i in range(4)}
    feed["next_word"] = rng.integers(0, 2000, (W2V_SPARSE_B, 1)).astype(np.int32)
    feed = _on(dev, feed)
    ids = torch.cat([feed[f"w{i}"] for i in range(4)], dim=1)

    def build(sparse):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), unique_name.guard():
            loss, _, _ = word2vec.word2vec(is_sparse=sparse)
            pt.optimizer.SGD(BOOK_LR).minimize(loss)
        startup.random_seed = SEED
        return main, startup, loss, [(f"fc_{i}.w_0", f"fc_{i}.b_0")
                                     for i in range(2)]

    counts, srs = _sparse_vs_dense(dev, card, f"sparse word2vec "
                                   f"B={W2V_SPARSE_B}", build, feed,
                                   _w2v_loss, {"shared_w": ids}, BOOK_LR)
    sr = srs["shared_w"]
    if (sr.values.shape != (4 * W2V_SPARSE_B, 32) or sr.height != 2000
            or not torch.equal(torch.sort(sr.rows.long()).values,
                               torch.sort(ids.reshape(-1).long()).values)):
        raise RuntimeError(f"sparse word2vec: shared_w@GRAD is {sr}, not the "
                           f"four lookups' rows")
    print(f"sparse word2vec: shared_w@GRAD is one SelectedRows of "
          f"{sr.rows.shape[0]} rows (the four lookups' {W2V_SPARSE_B} each, "
          f"concatenated by backward's sums), height {sr.height} [{card}]")
    return counts


SEQ_B, SEQ_T, SEQ_D = 64, 100, 128
SEQ_RNN_B, SEQ_RNN_H, SEQ_PROJ = 32, 512, 256   # cudnn_lstm and lstmp, T=100
SEQ_ROW = (16, 200, 1024)            # row_conv's B, T, D (DeepSpeech2)
SEQ_L2 = 1e-5        # each output and grad on the card against the CPU


def _seq_cases():
    """(op, inputs {slot: {name: array}}, outputs, attrs, cotangent shapes
    {output: shape}) at the sizes users run: cudnn_lstm 2 layers
    bidirectional H=512 over D=512, B=32, T=100; lstmp size 4x512, proj
    256, B=32, T=100; row_conv DeepSpeech2's lookahead (D=1024, context 2,
    B=16, T=200); sequence_conv D=128, 128 filters, width 3; the rest at
    B=64, T=100, D=128 (match_matrix_tensor with 4 channels, its
    [64, 4, 100, 100] scores pooled by sequence_topk_avg_pooling)."""
    rng = np.random.default_rng(SEED)
    B, T, D = SEQ_B, SEQ_T, SEQ_D

    def f(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def lens(n, hi, lo=1):
        return rng.integers(lo, hi + 1, n).astype(np.int64)

    H, L, RB, P = SEQ_RNN_H, 2, SEQ_RNN_B, SEQ_PROJ
    nw = sum(2 * ((H if l == 0 else 2 * H) * 4 * H + H * 4 * H + 4 * H)
             for l in range(L))
    RWB, RWT, RWD = SEQ_ROW
    off = lens(B, T // 2, 0)
    return [
        ("sequence_slice", {"X": {"x": f(B, T, D)}, "Offset": {"off": off},
                            "Length": {"ln": np.minimum(lens(B, T // 2), T - off)}},
         {"Out": ["o"], "OutLength": ["ol"]}, {}, {"o": (B, T, D)}),
        ("sequence_erase", {"X": {"x": rng.integers(0, 20, (B, T)).astype(np.int64)},
                            "Length": {"ln": lens(B, T)}},
         {"Out": ["o"], "OutLength": ["ol"]}, {"tokens": [0, 3, 7]}, {}),
        ("sequence_expand_as", {"X": {"x": f(B, D)},
                                "Y": {"y": np.zeros((B * 4, D), np.float32)}},
         {"Out": ["o"]}, {}, {"o": (B * 4, D)}),
        ("sequence_scatter", {"X": {"x": f(B, T)},
                              "Ids": {"ids": rng.integers(0, T, (B, 10)).astype(np.int64)},
                              "Updates": {"upd": f(B, 10)},
                              "IdsLength": {"il": lens(B, 10)}},
         {"Out": ["o"]}, {}, {"o": (B, T)}),
        ("sequence_conv", {"X": {"x": f(B, T, D)},
                           "Filter": {"w": f(3 * D, D, scale=0.05)},
                           "Length": {"ln": lens(B, T)}},
         {"Out": ["o"]}, {"contextStart": -1, "contextLength": 3},
         {"o": (B, T, D)}),
        ("sequence_enumerate", {"X": {"x": rng.integers(0, 1000, (B, T)).astype(np.int64)},
                                "Length": {"ln": lens(B, T)}},
         {"Out": ["o"]}, {"win_size": 3, "pad_value": 0}, {}),
        ("sequence_reshape", {"X": {"x": f(B, T, D)}}, {"Out": ["o"]},
         {"new_dim": 2 * D}, {"o": (B, T // 2, 2 * D)}),
        ("match_matrix_tensor", {"X": {"x": f(B, T, D)}, "Y": {"y": f(B, T, D)},
                                 "W": {"w": f(D, 4, D, scale=0.05)},
                                 "XLength": {"xl": lens(B, T)},
                                 "YLength": {"yl": lens(B, T)}},
         {"Out": ["o"]}, {}, {"o": (B, 4, T, T)}),
        ("sequence_topk_avg_pooling", {"X": {"x": f(B, 4, T, T)},
                                       "RowLength": {"rl": lens(B, T)},
                                       "ColLength": {"cl": lens(B, T)}},
         {"Out": ["o"]}, {"topks": [1, 3, 5, 10], "channel_num": 4},
         {"o": (B, T, 16)}),
        ("lstmp", {"Input": {"x": f(RB, T, 4 * H, scale=0.5)},
                   "Weight": {"w": f(P, 4 * H, scale=0.05)},
                   "ProjWeight": {"pw": f(H, P, scale=0.05)},
                   "Bias": {"b": f(1, 4 * H, scale=0.1)}},
         {"Projection": ["p"], "Cell": ["c"]},
         {"proj_activation": "tanh"}, {"p": (RB, T, P), "c": (RB, T, H)}),
        ("cudnn_lstm", {"Input": {"x": f(RB, T, H)},
                        "W": {"w": f(nw, scale=0.04)},
                        "InitH": {"h0": f(2 * L, RB, H)},
                        "InitC": {"c0": f(2 * L, RB, H)}},
         {"Out": ["o"], "LastH": ["lh"], "LastC": ["lc"]},
         {"num_layers": L, "hidden_size": H, "is_bidirec": True,
          "dropout_prob": 0.0},
         {"o": (RB, T, 2 * H), "lh": (2 * L, RB, H), "lc": (2 * L, RB, H)}),
        ("row_conv", {"X": {"x": f(RWB, RWT, RWD)},
                      "Filter": {"w": f(3, RWD, scale=0.5)}},
         {"Out": ["o"]}, {}, {"o": (RWB, RWT, RWD)}),
    ]


def _seq_program(op, ins, outs, attrs, cots, nograd=()):
    """`op` over vars named as `ins`, and the grads of its outputs named in
    `cots` (fed cotangents) for its floating inputs that reach them, but
    those named in `nograd` (stop_gradient vars), by the port's
    `gradients`: (program, fetch names: the outputs, then the grads)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name

    main = pt.Program()
    with pt.program_guard(main, pt.Program()), unique_name.guard():
        block = main.global_block
        diff = []
        for d in ins.values():
            for n, a in d.items():
                grad = a.dtype.kind == "f" and n not in nograd
                v = block.create_var(name=n, shape=a.shape, dtype=str(a.dtype),
                                     stop_gradient=not grad)
                if grad:
                    diff.append(v)
        block.append_op(op, {s: list(d) for s, d in ins.items()}, outs, attrs)
        grads = []
        if cots:
            targets = [block.var(n) for n in cots]
            tgs = [block.create_var(name=n + "_cot", shape=s, dtype="float32")
                   for n, s in cots.items()]
            grads = [g.name for g in pt.gradients(targets, diff, tgs)
                     if g is not None]
    return main, [n for ns in outs.values() for n in ns] + grads


def seq_tail(dev, card):
    """The 12 new sequence and RNN ops on the card, forward and every grad,
    against the same program on the CPU (the port's own, which the CPU
    tests hold against the JAX package): fp32, TF32 off, each output and
    grad within SEQ_L2 relative L2 (integer outputs bit for bit); ms a run
    of each op's program (forward and grads) on the card."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda_kernels as ck

    gpu, cpu = pt.Executor(), pt.Executor(place="cpu")
    rng = np.random.default_rng(SEED + 1)
    rows = []
    for op, ins, outs, attrs, cot_shapes in _seq_cases():
        main, fetch = _seq_program(op, ins, outs, attrs, cot_shapes,
                                   ("y",) if op == "sequence_expand_as" else ())
        feed = {n: a for d in ins.values() for n, a in d.items()}
        feed.update({n + "_cot": rng.standard_normal(s).astype(np.float32)
                     for n, s in cot_shapes.items()})
        dfeed = _on(dev, feed)
        ck.reset_launch_counts()
        got = gpu.run(main, feed=dfeed, fetch_list=fetch, scope=pt.Scope(),
                      return_numpy=False)
        torch.cuda.synchronize()
        _check_launches(main, op)
        want = cpu.run(main, feed=feed, fetch_list=fetch, scope=pt.Scope(),
                       return_numpy=False)
        worst = 0.0
        for n, g, w in zip(fetch, got, want):
            if not w.is_floating_point():
                if not torch.equal(g.cpu(), w):
                    raise RuntimeError(f"{op}: {n} differs on the card")
                continue
            e = _rel_l2(g.cpu(), w)
            if not e <= SEQ_L2:
                raise RuntimeError(f"{op}: {n} on the card is {e:.3e} "
                                   f"relative L2 from the CPU (limit {SEQ_L2})")
            worst = max(worst, e)
        scope = pt.Scope()
        # 2 windows of 2 (3 of 5 before depth cuts)
        windows = _timed_windows(lambda: gpu.run(
            main, feed=dfeed, fetch_list=fetch, scope=scope,
            return_numpy=False), 2, 2)
        n_grads = len(fetch) - sum(len(v) for v in outs.values())
        rows.append(f"{op} {1e3 * min(windows):.3f} ms ({n_grads} grads, "
                    f"worst {worst:.2e})")
    print(f"seq tail on the card against the CPU (relative L2 <= {SEQ_L2}; "
          f"ms a run of forward and grads, best of 2 windows of 2): "
          + "; ".join(rows) + f" [{card}]")


# ---------------------------------------------------------------------------
# The dataset readers feeding the book models; the numeric guard and the
# checkpointed runner over the ResNet-50 AMP step.
# ---------------------------------------------------------------------------

READER_STEPS = 40          # training steps of each reader path
CIFAR_B = 128              # the book's image_classification batch
READER_LR = 1e-3           # Adam, recognize_digits' rate
W2V_N = 5                  # the book's 5-grams: 4 context words, 1 target
# the PTB-format corpus the word2vec path writes, at PTB's size: train,
# valid and test lines, a Zipf-like vocabulary of PTB's 10,000 words; each
# word follows its predecessor by a fixed rule with probability PTB_FOLLOW,
# so the context predicts the next word
PTB_LINES, PTB_VOCAB, PTB_LEN, PTB_FOLLOW = (42068, 3370, 3761), 10000, (5, 30), 0.3


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _smoke_dir(name):
    """A fresh directory `name` under SMOKE_DATA in the checkout."""
    import os
    import shutil

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), SMOKE_DATA,
                     name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def write_ptb(home, seed=SEED, lines=PTB_LINES):
    """PTB's simple-examples.tgz (ptb.train/valid/test.txt) under
    home/imikolov, the corpus drawn from `seed`."""
    import io
    import os
    import tarfile

    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, PTB_VOCAB + 1) ** 1.1
    zipf /= zipf.sum()

    def text(n):
        lens = rng.integers(*PTB_LEN, n)
        w = rng.choice(PTB_VOCAB, size=int(lens.sum()), p=zipf)
        follow = rng.random(w.size) < PTB_FOLLOW
        follow[np.cumsum(lens) - lens] = False       # a line's first word
        words = w.tolist()
        for i in np.flatnonzero(follow).tolist():
            words[i] = (words[i - 1] * 7 + 3) % 2000
        out, at = [], 0
        for k in lens.tolist():
            out.append(" ".join(f"w{x}" for x in words[at:at + k]))
            at += k
        return "\n".join(out).encode()

    os.makedirs(os.path.join(home, "imikolov"), exist_ok=True)
    path = os.path.join(home, "imikolov", "simple-examples.tgz")
    with tarfile.open(path, "w:gz") as tf:
        for split, n in zip(("train", "valid", "test"), lines):
            data = text(n)
            info = tarfile.TarInfo(f"./simple-examples/data/ptb.{split}.txt")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return path


def _train_from_reader(dev, card, what, build, reader, B, steps=READER_STEPS):
    """`build(pt)` -> (loss, feed vars) under Adam(READER_LR), trained
    `steps` steps from `reader` through pt.batch and DataFeeder (a new
    epoch when the reader runs out). Holds the launches (the program's
    kernels once each a step) and a falling loss: the mean of the last 5
    steps below step 1's. Returns the launches."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.ops import cuda_kernels as ck

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        loss, feed_vars = build(pt)
        pt.optimizer.Adam(READER_LR).minimize(loss)
    startup.random_seed = SEED
    exe, scope = pt.Executor(place=dev), pt.Scope()
    exe.run(startup, scope=scope)
    feeder = pt.DataFeeder(feed_vars)
    epoch = pt.batch(reader, B, drop_last=True)
    batches = epoch()
    ck.reset_launch_counts()
    losses, host, epochs = [], 0.0, 1
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        t = time.perf_counter()
        batch = next(batches, None)
        if batch is None:
            batches, epochs = epoch(), epochs + 1
            batch = next(batches)
        feed = feeder.feed(batch)
        host += time.perf_counter() - t
        losses.append(exe.run(main, feed=feed, scope=scope, fetch_list=[loss],
                              return_numpy=False)[0])
    _sync(dev)
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in ck.launch_counts_by_dtype().items() if v}
    want = {w: {d: n * steps for d, n in c.items()}
            for w, c in _expected_launches(main).items()}
    if dev.type == "cuda" and counts != want:
        raise RuntimeError(f"{what}: launches {counts}, the program's ops "
                           f"say {want}")
    losses = [float(lv) for lv in losses]
    tail = float(np.mean(losses[-5:]))
    if not all(np.isfinite(losses)) or not tail < losses[0]:
        raise RuntimeError(f"{what}: the loss did not fall: {losses}")
    print(f"{what}: {steps} steps of B={B} from the reader ({epochs} "
          f"epoch(s)): reader + DataFeeder {steps * B / host:.1f} samples/s "
          f"({host:.3f} s of host time), {steps * B / wall:.1f} samples/s "
          f"end to end; loss at step 1 {losses[0]:.6f}, at step {steps} "
          f"{losses[-1]:.6f} (mean of the last 5 {tail:.6f}); launches "
          f"{counts} [{card}]")
    return counts


def book_readers(dev, card, steps=READER_STEPS):
    """The dataset readers feed the book models at their book widths
    through pt.batch and DataFeeder: mnist.train() the MNIST convnet,
    cifar.train10() resnet_cifar10, and imikolov's 5-grams from a
    PTB-format simple-examples.tgz written under a temporary DATA_HOME
    word2vec (its defaults: embed 32, hidden 256). mnist and cifar find no
    archive there and yield their seeded, learnable synthetic samples.
    Returns each path's launches."""
    import os
    import shutil

    from paddle_tpu_torch.dataset import cifar, common, imikolov, mnist
    from paddle_tpu_torch.models import mlp, resnet, word2vec
    from paddle_tpu_torch.reader import map_readers

    home = _smoke_dir("dataset")
    saved = common.DATA_HOME, os.environ.get("PADDLE_TPU_DATA_HOME")
    common.DATA_HOME = os.environ["PADDLE_TPU_DATA_HOME"] = home
    try:
        t0 = time.perf_counter()
        write_ptb(home)
        word_idx = imikolov.build_dict()
        print(f"book readers: DATA_HOME {home}: PTB corpus written and its "
              f"dictionary built ({len(word_idx)} words of frequency > 50) "
              f"in {time.perf_counter() - t0:.2f} s; mnist synthetic "
              f"{mnist.is_synthetic()}, cifar synthetic "
              f"{cifar.is_synthetic()}, imikolov synthetic "
              f"{imikolov.is_synthetic()}")
        if imikolov.is_synthetic() or not (mnist.is_synthetic()
                                           and cifar.is_synthetic()):
            raise RuntimeError("book readers: the readers did not find what "
                               "the phase placed under DATA_HOME")

        def conv(pt):
            L = pt.layers
            img = L.data(name="img", shape=[1, 28, 28], dtype="float32")
            label = L.data(name="label", shape=[1], dtype="int64")
            return mlp.mnist_conv(img, label)[0], [img, label]

        def cifar_net(pt):
            L = pt.layers
            img = L.data(name="img", shape=[3, 32, 32], dtype="float32")
            label = L.data(name="label", shape=[1], dtype="int64")
            return resnet.resnet_cifar10(img, label)[0], [img, label]

        def w2v(pt):
            loss, _, feeds = word2vec.word2vec(dict_size=len(word_idx))
            block = pt.default_main_program().global_block
            return loss, [block.var(n) for n in feeds]

        shaped = lambda r, shape: map_readers(  # noqa: E731
            lambda s: (s[0].reshape(shape), s[1]), r)
        return [
            _train_from_reader(dev, card, "mnist.train() -> mnist_conv",
                               conv, shaped(mnist.train(), (1, 28, 28)),
                               MNIST_B, steps),
            _train_from_reader(dev, card, "cifar.train10() -> resnet_cifar10",
                               cifar_net, shaped(cifar.train10(), (3, 32, 32)),
                               CIFAR_B, steps),
            _train_from_reader(dev, card, f"imikolov.train(N={W2V_N}) -> "
                               f"word2vec", w2v,
                               imikolov.train(word_idx, W2V_N), W2V_B, steps)]
    finally:
        common.DATA_HOME = saved[0]
        if saved[1] is None:
            os.environ.pop("PADDLE_TPU_DATA_HOME", None)
        else:
            os.environ["PADDLE_TPU_DATA_HOME"] = saved[1]
        shutil.rmtree(home, ignore_errors=True)


# the guarded ResNet-50 AMP step: decorate(Momentum(RN_FALL_LR, RN_MU)) with
# dynamic loss scaling from 2^15, halved on every found inf
GUARD_SPIKE = 10.0             # FLAGS_guard_spike_factor of the program
GUARD_PLAN = "numeric_nan:2;numeric_spike:4"   # hits inside the fault scope
GUARD_BATCHES = 4              # seeded batches the steps cycle through
GUARD_TIMED = 2                # steps a P/C timing window (10, then 5,
                               # then 3, before depth cuts)
GUARD_RANGE = "guard sentinel"  # the profiler range of its op


def _rn50_amp(pt):
    """bench.py:282's network: ResNet-50, s2d stem, NHWC, 1000 classes."""
    from paddle_tpu_torch.models import resnet

    L = pt.layers
    img = L.data(name="img", shape=[RN_HW, RN_HW, 3], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    return resnet.resnet50(img, label, num_classes=RN_CLASSES, s2d_stem=True,
                           data_format="NHWC")[0]


def _amp_program(build, guard):
    """`build(pt)`'s loss under decorate(Momentum(RN_FALL_LR, RN_MU)) with
    dynamic loss scaling; the health sentinel appended when `guard`."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import flags, unique_name
    from paddle_tpu_torch.contrib import mixed_precision as amp

    names = ("guard_numerics", "guard_spike_factor")
    saved = {k: flags.get_flag(k) for k in names}
    flags.set_flags({"guard_numerics": guard,
                     "guard_spike_factor": GUARD_SPIKE})
    try:
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), unique_name.guard():
            loss = build(pt)
            amp.decorate(pt.optimizer.Momentum(RN_FALL_LR, RN_MU),
                         init_loss_scaling=2.0 ** 15,
                         use_dynamic_loss_scaling=True,
                         decr_every_n_nan_or_inf=1).minimize(loss)
    finally:
        flags.set_flags(saved)
    startup.random_seed = SEED
    return main, startup, loss


def _seeded_batches(dev, shape, B, classes, n=GUARD_BATCHES):
    rng = np.random.default_rng(SEED + 7)
    return [{"img": torch.from_numpy(rng.standard_normal(
                (B, *shape)).astype(np.float32)).to(dev),
             "label": torch.from_numpy(rng.integers(
                 0, classes, (B, 1)).astype(np.int32)).to(dev)}
            for _ in range(n)]


def _same_bits(a, b):
    """Bit for bit, NaN payloads included."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.contiguous().view(-1).view(torch.uint8),
                       b.contiguous().view(-1).view(torch.uint8))


def _add_counts(acc, counts):
    for w, by in counts.items():
        for d, n in by.items():
            if n:
                acc.setdefault(w, {})
                acc[w][d] = acc[w].get(d, 0) + n


def _hold_zero_grad_update(what, pre, post, lr, names):
    """Every parameter and velocity after a skipped step equals Momentum's
    update on zero gradients from the step's own pre-step state, bit for
    bit (v' = mu v + 0; p' = p - lr v'), not "unchanged"."""
    lr = lr.reshape(())
    moved = 0
    for n in names:
        v0, p0 = pre[f"{n}_velocity_0"], pre[n]
        v1 = RN_MU * v0 + torch.zeros_like(v0)
        p1 = (p0 - lr * v1).to(p0.dtype)
        if not (_same_bits(post[f"{n}_velocity_0"], v1)
                and _same_bits(post[n], p1)):
            raise RuntimeError(f"{what}: {n} after the skipped step is not "
                               f"Momentum's update on zero gradients")
        moved += int(not _same_bits(p1, p0))
    return moved


def guard_resnet_amp(dev, card, build=_rn50_amp, shape=(RN_HW, RN_HW, 3),
                     B=AMP_B, classes=RN_CLASSES):
    """The ResNet-50 AMP step (bench.py:278's widths, B=128) under
    FLAGS_guard_numerics, dynamic loss scaling and a StepGuard over a
    CheckpointManager, through run_async: a FaultPlan plants a NaN step
    and a 1e4x input step, then NaN batches run past the bad-step budget
    until the guard rewinds, and again until GuardError. Holds health, the
    skips as zero-gradient updates bit for bit, the loss scale, the
    rewinds' restore and LR backoff, the blame replay and its untouched
    live scope, a sync-free guarded dispatch; times the step with the
    guard on and off (P C C P) and counts the sentinel's launches. Then the
    DeepFM sub-check. Returns (main-path launches, blame-replay
    launches)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.resilience import (CheckpointManager, GuardError,
                                             GuardRewind, StepGuard,
                                             fault_scope, replay_blame)
    from paddle_tpu_torch.resilience.guardrails import (
        GUARD_HEALTH_NAME, GUARD_STATE_NAME, H_BAD, H_GNORM, H_LOSS,
        H_NONFINITE)

    root = _smoke_dir("guard")
    main, startup, loss = _amp_program(build, True)
    ops = [op.type for op in main.global_block.ops]
    if ops.count("health_sentinel") != 1:
        raise RuntimeError(f"guarded program: {ops.count('health_sentinel')} "
                           f"sentinels")
    sent = next(op for op in main.global_block.ops
                if op.type == "health_sentinel")
    if sent.inputs.get("FoundInfinite") != ["@FOUND_INF@"] or \
            sent.inputs["Loss"] != [loss.name]:
        raise RuntimeError(f"the sentinel reads {sent.inputs['Loss']} and "
                           f"{sent.inputs.get('FoundInfinite')}")
    exe, scope = pt.Executor(place=dev), pt.Scope()
    exe.run(startup, scope=scope)
    batches = _seeded_batches(dev, shape, B, classes)
    poisoned = dict(batches[0])
    poisoned["img"] = batches[0]["img"].clone()
    poisoned["img"].view(-1)[0] = float("nan")
    names = [p.name for p in main.all_parameters()]
    lr_name = main._guard_lr_name
    watch = names + [f"{n}_velocity_0" for n in names] + [
        "@LOSS_SCALING@", GUARD_STATE_NAME]
    mgr = CheckpointManager(root, keep_last_k=2, main_program=main,
                            scope=scope)
    guard = StepGuard(mgr, program=main, scope=scope)
    exe.set_step_guard(guard)
    main_counts, replay_counts = {}, {}
    ck.reset_launch_counts()
    n_steps = 0

    def dispatch(feed):
        nonlocal n_steps
        pre = {n: scope.find_var(n) for n in watch}
        exe.run_async(main, feed=feed, fetch_list=[], scope=scope)
        n_steps += 1
        return pre, {n: scope.find_var(n)
                     for n in watch + [GUARD_HEALTH_NAME]}

    # (a) steps that set the loss EMA; one more dispatched under the sync
    # debug mode "error" (the window is empty, so run_async does not wait)
    for i in range(3):
        dispatch(batches[i % GUARD_BATCHES])
    exe.wait()
    if dev.type == "cuda":
        torch.cuda.set_sync_debug_mode("error")
    try:
        dispatch(batches[3 % GUARD_BATCHES])
    finally:
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode(0)
    exe.wait()
    # (b) the planted faults: hit 2 poisons its batch with a NaN, hit 4
    # scales its images by 1e4
    steps = []
    with fault_scope(GUARD_PLAN) as plan:
        for i in range(6):
            steps.append(dispatch(batches[i % GUARD_BATCHES]))
        exe.wait()
    fired = plan.stats()["fired"]
    if fired != [("numeric_nan", 2), ("numeric_spike", 4)]:
        raise RuntimeError(f"guard: the plan fired {fired}")
    verdicts = []
    for i, (pre, post) in enumerate(steps):
        h = post[GUARD_HEALTH_NAME].cpu()
        ema, seen = (float(x) for x in pre[GUARD_STATE_NAME].cpu())
        loss_i = float(h[H_LOSS])
        spike = bool(seen > 0 and np.isfinite(loss_i)
                     and loss_i > GUARD_SPIKE * ema)
        bad = bool(h[H_BAD])
        want = i == 1 or spike
        if bad != want or bool(h[H_NONFINITE]) != (i == 1):
            raise RuntimeError(f"guard step {i + 1}: health {h.tolist()}, "
                               f"state before {[ema, seen]}; expected bad "
                               f"{want}")
        scale0 = float(pre["@LOSS_SCALING@"])
        scale1 = float(post["@LOSS_SCALING@"])
        if i == 1 and scale1 != scale0 * 0.5:
            raise RuntimeError(f"the loss scale went {scale0} -> {scale1} "
                               f"on the NaN step")
        moved = (_hold_zero_grad_update(f"guard step {i + 1}", pre, post,
                                        scope.find_var(lr_name), names)
                 if bad else None)
        verdicts.append((i + 1, h.tolist(), bad, moved))
    if guard.skips != sum(v[2] for v in verdicts) or guard.rewinds:
        raise RuntimeError(f"guard: {guard.skips} skips, {guard.rewinds} "
                           f"rewinds after {verdicts}")
    nan_stats = sum(int(torch.isnan(scope.find_var(n)).any())
                    for n in scope.var_names()
                    if n.endswith((".mean", ".var")))
    print(f"guard: ResNet-50 AMP B={B} guarded, {len(ops)} ops a step (one "
          f"health_sentinel over {len(sent.inputs['X'])} gradients, AMP's "
          f"@FOUND_INF@ ORed in, spike factor {GUARD_SPIKE}); a step "
          f"dispatched under the sync debug mode \"error\"; the plan "
          f"{GUARD_PLAN!r} fired {fired}; steps (step, [loss, gnorm, "
          f"nonfinite, bad], skipped, parameters a zero-gradient update "
          f"moved): {verdicts}; the loss scale halved on the NaN step; "
          f"{nan_stats} running mean/var vars hold a NaN afterwards (batch "
          f"norm's statistics are forward outputs: the skip does not gate "
          f"them) [{card}]")
    _add_counts(main_counts, ck.launch_counts_by_dtype())
    ck.reset_launch_counts()

    # (c) a checkpoint, then NaN batches past the budget until the guard
    # rewinds: restore, LR backoff, blame replay
    step_ckpt = n_steps
    mgr.save(step_ckpt, executor=exe)
    ckpt_vars = mgr.read_manifest(step_ckpt)["var_names"]
    snap = {n: scope.find_var(n).clone() for n in ckpt_vars}

    def nan_run():
        """NaN batches until GuardRewind; the guard's rewind's report."""
        err = None
        for _ in range(2 * (guard.budget + 1)):
            try:
                dispatch(poisoned)
            except GuardRewind as e:
                err = e
                break
        if err is None:
            try:
                exe.wait()
            except GuardRewind as e:
                err = e
        if err is None:
            raise RuntimeError("guard: NaN batches past the budget did not "
                               "trip the guard")
        _add_counts(main_counts, ck.launch_counts_by_dtype())
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            return guard.rewind(exe, err), time.perf_counter() - t0
        finally:
            _add_counts(replay_counts, ck.launch_counts_by_dtype())
            ck.reset_launch_counts()

    report, rewind_s = nan_run()
    lr_want = snap[lr_name] * flags.get_flag("guard_lr_backoff")
    if not _same_bits(scope.find_var(lr_name), lr_want):
        raise RuntimeError(f"rewind 1: LR {scope.find_var(lr_name)}, want "
                           f"{lr_want}")
    changed = [n for n in ckpt_vars if n != lr_name
               and not _same_bits(scope.find_var(n), snap[n])]
    if changed or guard.rewinds != 1 or not (report and report["op_type"]
                                             and report["var"]):
        raise RuntimeError(f"rewind 1: vars off the checkpoint {changed[:5]}"
                           f", rewinds {guard.rewinds}, blame {report}")
    live = {n: scope.find_var(n) for n in scope.var_names()}
    before = {n: v.clone() for n, v in live.items()}
    again = replay_blame(exe, main, poisoned, scope, step_id=-1)
    _add_counts(replay_counts, ck.launch_counts_by_dtype())
    ck.reset_launch_counts()
    moved = [n for n in live if scope.find_var(n) is not live[n]
             or not _same_bits(live[n], before[n])]
    if moved or (again["op_type"], again["var"]) != (report["op_type"],
                                                     report["var"]):
        raise RuntimeError(f"replay_blame moved {moved[:5]} of the live "
                           f"scope, or named {again} after {report}")
    del before, live
    print(f"guard: {guard.budget + 1} NaN batches in a row exhausted the "
          f"budget of {guard.budget}: rewind to the checkpoint of step "
          f"{step_ckpt} in {rewind_s:.3f} s ({len(ckpt_vars)} vars bit for "
          f"bit), LR x{flags.get_flag('guard_lr_backoff')}, blame: op "
          f"{report['op_type']!r} var {report['var']!r} ({report['detail']}); "
          f"a second replay named the same and left all "
          f"{len(scope.var_names())} live vars bit for bit [{card}]")
    # (d) healthy steps, then NaN runs until the ladder is spent
    for i in range(2):
        dispatch(batches[i])
    exe.wait()
    backoffs = []
    try:
        for _ in range(guard.max_rewinds + 1):
            nan_run()
            backoffs.append(float(scope.find_var(lr_name).reshape(-1)[0])
                            / float(snap[lr_name].reshape(-1)[0]))
        raise RuntimeError(f"guard: {guard.rewinds} rewinds and no "
                           f"GuardError")
    except GuardError as e:
        if guard.rewinds != guard.max_rewinds + 1:
            raise RuntimeError(f"GuardError after {guard.rewinds} rewinds: "
                               f"{e}") from e
        err = str(e).splitlines()[0][:120]
    exe.drain_quiet()
    _add_counts(main_counts, ck.launch_counts_by_dtype())
    ck.reset_launch_counts()
    want = [flags.get_flag("guard_lr_backoff") ** k
            for k in range(2, guard.max_rewinds + 1)]
    if not np.allclose(backoffs, want, rtol=1e-6):
        raise RuntimeError(f"LR backoffs {backoffs}, want {want}")
    print(f"guard: rewinds 2..{guard.max_rewinds} backed the LR off to "
          f"{[round(b, 6) for b in backoffs]} of the checkpoint's; rewind "
          f"{guard.rewinds} raised GuardError ({err}); {guard.skips} skips, "
          f"{len(mgr.guard_events())} guard events recorded [{card}]")

    # (e) steps/s with the guard on and off, paired in this process
    plain_main, plain_startup, _ = _amp_program(build, False)
    arms = {}
    for tag, prog, start in (("off", plain_main, plain_startup),
                             ("on", main, startup)):
        e, sc = pt.Executor(place=dev), pt.Scope()
        e.run(start, scope=sc)
        if tag == "on":
            e.set_step_guard(StepGuard(None, program=prog, scope=sc))
        arms[tag] = (e, prog, sc)

    def window(tag):
        e, prog, sc = arms[tag]
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(GUARD_TIMED):
            e.run_async(prog, feed=batches[i % GUARD_BATCHES], fetch_list=[],
                        scope=sc)
        e.wait()
        _sync(dev)
        return GUARD_TIMED / (time.perf_counter() - t0)

    for tag in ("off", "on"):
        window(tag)                               # warm
    rates = [(tag, window(tag)) for tag in ("off", "on", "on", "off")]
    off = [r for t, r in rates if t == "off"]
    on = [r for t, r in rates if t == "on"]
    prof_txt = "not measured (no CUDA)"
    if dev.type == "cuda":
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        undo = _range_ops(("health_sentinel",), GUARD_RANGE)
        try:
            seen = {}
            for tag in ("off", "on"):
                e, prog, sc = arms[tag]
                e.run(prog, feed=batches[0], scope=sc)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    e.run(prog, feed=batches[0], scope=sc)
                    torch.cuda.synchronize()
                kern = [ev for ev in prof.events()
                        if ev.device_type == DeviceType.CUDA
                        and ev.name != GUARD_RANGE]
                seen[tag] = (len(kern), sum(ev.time_range.end
                                            - ev.time_range.start
                                            for ev in kern) / 1e3, prof)
            calls, n_sent, ms_sent, _, kinds = kernels_in_ranges(
                seen["on"][2], GUARD_RANGE)
            prof_txt = (f"device activities a step: off {seen['off'][0]} "
                        f"({seen['off'][1]:.3f} ms), on {seen['on'][0]} "
                        f"({seen['on'][1]:.3f} ms); inside the sentinel's "
                        f"{calls} call: {n_sent} launches, {ms_sent:.3f} ms "
                        f"= {100 * ms_sent / seen['on'][1]:.2f}% of the "
                        f"step's device time ({kinds})")
        finally:
            undo()
    print(f"guard: steps/s P C C P (guard off, on, on, off; {GUARD_TIMED} "
          f"run_async steps a window): {[round(r, 3) for _, r in rates]}: "
          f"on/off {np.mean(on) / np.mean(off):.4f}; {prof_txt} [{card}]")
    del arms, plain_main
    exe.set_step_guard(None)
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    _guard_deepfm(dev, card)
    return main_counts, replay_counts


GUARD_DFM_FILES, GUARD_DFM_PASSES = 2, 6
GUARD_DFM_PLAN = "numeric_nan:5;numeric_spike:9"


def _guard_deepfm(dev, card):
    """DeepFM (CTR widths, is_sparse, SGD(CTR_LR)) under the guard: one NaN
    step by exe.run leaves every parameter bit for bit (the SelectedRows
    grads' values gated); then GUARD_DFM_PASSES train_from_dataset passes
    with a StepGuard over files with the planted label, the first under a
    plan with a NaN and a 1e4x dense step: both skipped, no rewind,
    training going on past them (a held-out batch's loss falls, its AUC
    rises)."""
    import os

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.resilience import (CheckpointManager, StepGuard,
                                             fault_scope)
    from paddle_tpu_torch.resilience.guardrails import (GUARD_HEALTH_NAME,
                                                        H_BAD)

    data = _smoke_dir("guard_ctr")
    saved = {k: flags.get_flag(k) for k in ("guard_numerics",
                                            "guard_spike_factor")}
    flags.set_flags({"guard_numerics": True,
                     "guard_spike_factor": GUARD_SPIKE})
    try:
        main, startup, test, loss, use_vars, _, prob = _ctr_program(
            True, lambda: pt.optimizer.SGD(CTR_LR))
    finally:
        flags.set_flags(saved)
    try:
        files = _write_ctr_files(data, GUARD_DFM_FILES, SEED + 1)
        exe, scope = pt.Executor(place=dev), pt.Scope()
        exe.run(startup, scope=scope)
        held = _held_out_ctr(dev)
        feed = _held_out_ctr(dev, SEED + 2)
        feed["dense_x"] = feed["dense_x"].clone()
        feed["dense_x"].view(-1)[0] = float("nan")
        names = [p.name for p in main.all_parameters()]
        before = {n: scope.find_var(n).clone() for n in names}
        exe.run(main, feed=feed, scope=scope)
        h = scope.find_var(GUARD_HEALTH_NAME).cpu()
        moved = [n for n in names
                 if not _same_bits(scope.find_var(n), before[n])]
        if not h[H_BAD] or moved:
            raise RuntimeError(f"DeepFM NaN step: health {h.tolist()}, "
                               f"parameters moved {moved}")
        l0, p0 = exe.run(test, feed=held, fetch_list=[loss, prob],
                         scope=scope, return_numpy=False)
        auc0 = _auc(p0, held["label"])
        guard = StepGuard(CheckpointManager(os.path.join(data, "ck"),
                                            main_program=main, scope=scope),
                          program=main, scope=scope)
        ds = pt.DatasetFactory().create_dataset("QueueDataset")
        ds.set_batch_size(CTR_B)
        ds.set_thread(1)
        ds.set_use_var(use_vars)
        ds.set_filelist(files)
        t0 = time.perf_counter()
        with fault_scope(GUARD_DFM_PLAN) as plan:
            exe.train_from_dataset(main, ds, scope=scope, guard=guard,
                                   print_period=10 ** 9)
        for _ in range(GUARD_DFM_PASSES - 1):
            exe.train_from_dataset(main, ds, scope=scope, guard=guard,
                                   print_period=10 ** 9)
        _sync(dev)
        wall = time.perf_counter() - t0
        l1, p1 = exe.run(test, feed=held, fetch_list=[loss, prob],
                         scope=scope, return_numpy=False)
        auc1 = _auc(p1, held["label"])
        reasons = [e["reason"] for e in guard.events]
        finite = all(bool(torch.isfinite(scope.find_var(n)).all())
                     for n in names)
        if (plan.stats()["fired"] != [("numeric_nan", 5),
                                      ("numeric_spike", 9)]
                or reasons != ["nonfinite", "loss_spike"] or guard.rewinds
                or not finite or not (float(l1) < float(l0) and auc1 > auc0)):
            raise RuntimeError(
                f"DeepFM under the guard: fired {plan.stats()['fired']}, "
                f"events {guard.events}, rewinds {guard.rewinds}, finite "
                f"{finite}, held-out loss {float(l0)} -> {float(l1)}, AUC "
                f"{auc0} -> {auc1}")
        n_b = GUARD_DFM_FILES * CTR_LINES // CTR_B
        print(f"guard DeepFM: a NaN step by exe.run left all {len(names)} "
              f"parameters bit for bit (fm_emb's and fm_w1's SelectedRows "
              f"values gated); {GUARD_DFM_PASSES} train_from_dataset passes "
              f"of {n_b} batches (B={CTR_B}, {wall:.2f} s) with the plan "
              f"{GUARD_DFM_PLAN!r}: skips {reasons}, no rewind; a held-out "
              f"batch's loss {float(l0):.6f} -> {float(l1):.6f}, AUC "
              f"{auc0:.4f} -> {auc1:.4f} [{card}]")
    finally:
        import shutil
        shutil.rmtree(data, ignore_errors=True)


RUNNER_STEPS, RUNNER_SAVE_EVERY, RUNNER_RETRIES = 6, 2, 5
RUNNER_PLAN = "executor.compile:1;collective.step:4;ckpt.write:2"


def runner_resnet_amp(dev, card, build=_rn50_amp, shape=(RN_HW, RN_HW, 3),
                      B=AMP_B, classes=RN_CLASSES):
    """A CheckpointedRunner over the ResNet-50 AMP step (dynamic loss
    scaling, no guard), RUNNER_STEPS steps saved every RUNNER_SAVE_EVERY,
    under RUNNER_PLAN: every site fires, the retries stay within bounds,
    latest_step() is the last step, and the loss trajectory matches the
    undisturbed one, run twice: where those two agree bit for bit the
    faulted one must too, else it must lie no farther from either than
    they lie from each other (cuDNN set deterministic for the phase). A
    persistent collective.step fault raises StepFailure after
    max_retries + 1 attempts. Returns the faulted run's launches."""
    import os
    import shutil

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.resilience import (CheckpointedRunner,
                                             CheckpointManager, StepFailure,
                                             fault_scope)

    root = _smoke_dir("runner")
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    main, startup, loss = _amp_program(build, False)
    batches = _seeded_batches(dev, shape, B, classes)

    def trajectory(tag, plan=None, max_retries=RUNNER_RETRIES):
        exe, scope = pt.Executor(place=dev), pt.Scope()
        exe.run(startup, scope=scope)
        mgr = CheckpointManager(os.path.join(root, tag), keep_last_k=3,
                                main_program=main, scope=scope)
        runner = CheckpointedRunner(exe, mgr, main_program=main, scope=scope,
                                    save_every=RUNNER_SAVE_EVERY,
                                    max_retries=max_retries)
        _sync(dev)
        t0 = time.perf_counter()
        with fault_scope(plan or "") as fp:
            res = runner.run(lambda s: batches[s % GUARD_BATCHES],
                             RUNNER_STEPS, fetch_list=[loss])
        _sync(dev)
        losses = [float(np.asarray(v[0]).reshape(-1)[0])
                  for _, v in sorted(res["results"].items())]
        return (losses, res["retries"], fp.stats(), mgr.latest_step(),
                time.perf_counter() - t0)

    try:
        a = trajectory("a")
        b = trajectory("b")
        ck.reset_launch_counts()
        f = trajectory("f", RUNNER_PLAN)
        counts = {k: v for k, v in ck.launch_counts_by_dtype().items() if v}
        sites = {s for s, _ in f[2]["fired"]}
        if sites != {"executor.compile", "collective.step", "ckpt.write"} \
                or not 0 < f[1] <= RUNNER_RETRIES * RUNNER_STEPS \
                or f[3] != RUNNER_STEPS - 1 or a[1] or b[1]:
            raise RuntimeError(f"runner: fired {f[2]['fired']}, retries "
                               f"{f[1]}, latest step {f[3]}")
        spread = max(abs(x - y) for x, y in zip(a[0], b[0]))
        off = max(max(abs(x - y) for x, y in zip(f[0], r[0])) for r in (a, b))
        if spread == 0.0:
            case = "the undisturbed runs agree bit for bit, so must the faulted"
            ok = f[0] == a[0]
        else:
            case = (f"the undisturbed runs differ by up to {spread:.3e}; the "
                    f"faulted one must lie no farther from either")
            ok = off <= spread
        if not ok:
            raise RuntimeError(f"runner: faulted losses {f[0]}, undisturbed "
                               f"{a[0]} and {b[0]} ({case})")
        try:
            trajectory("p", "collective.step:" + ",".join(
                map(str, range(1, 60))), max_retries=3)
            raise RuntimeError("runner: a persistent fault did not surface")
        except StepFailure as e:
            if e.attempts != 4 or e.step != 0:
                raise RuntimeError(f"runner: StepFailure after {e.attempts} "
                                   f"attempts at step {e.step}") from e
        print(f"runner: CheckpointedRunner over the ResNet-50 AMP step "
              f"(B={B}), {RUNNER_STEPS} steps saved every "
              f"{RUNNER_SAVE_EVERY}, plan {RUNNER_PLAN!r}: fired "
              f"{f[2]['fired']}, {f[1]} retries, latest step {f[3]}, "
              f"{f[4]:.2f} s (undisturbed {a[4]:.2f} / {b[4]:.2f} s); losses "
              f"{[round(x, 6) for x in f[0]]}: {case}: held; a persistent "
              f"collective.step fault raised StepFailure after 4 attempts "
              f"(max_retries 3); launches {counts} [{card}]")
        return counts
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
        shutil.rmtree(root, ignore_errors=True)


LN_FOCUS = ("K3/K5 (layer norm)", ("layer_norm",))
# the optimizer's update ops of a step, one profiler range each
UPDATE_OPS = "update ops"


BN_GRADS = "batch_norm grad"


# the WMT step's soft-label chain: one_hot -> label_smooth -> the cast of
# the label to bf16 -> the soft-label cross entropy, and its grad
SOFT_CHAIN = ("soft label chain", "soft label xent grad")


def _range_soft_chain():
    """Wrap the computes of the WMT step's soft-label chain in the
    profiler ranges SOFT_CHAIN; returns the function that unwraps them."""
    from paddle_tpu_torch.ops.registry import get_op_def

    saved = {}

    def wrap(op_type, name, pick=lambda op: True):
        d = get_op_def(op_type)
        plain = saved[op_type] = d.compute

        def compute(ctx):
            if not pick(ctx.op):
                return plain(ctx)
            with torch.profiler.record_function(name):
                return plain(ctx)
        d.compute = compute

    for t in ("one_hot", "label_smooth", "softmax_with_cross_entropy"):
        wrap(t, SOFT_CHAIN[0])
    wrap("cast", SOFT_CHAIN[0],
         lambda op: op.inputs["X"][0].startswith("label_smooth"))
    wrap("softmax_with_cross_entropy_grad", SOFT_CHAIN[1])

    def undo():
        for t, c in saved.items():
            get_op_def(t).compute = c
    return undo


def ranged(fn, name):
    """`fn` called inside a torch.profiler range `name` (name it after a
    word: the profiler demangles a name like "K5 call" as a C++ symbol)."""
    def call(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return call


def kernels_in_ranges(prof, name, own=""):
    """(calls, kernels, device ms of those kernels, kernels whose name
    holds `own`, {name: count} of the others) of the torch.profiler range
    `name` in a finished profile: the device activities (kernels, copies,
    fills) that lie inside the device-timeline span of one of its calls
    (one stream, so those are the ones its calls launched)."""
    from collections import Counter

    from torch.autograd import DeviceType

    spans, acts = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        tr = (e.time_range.start, e.time_range.end, e.name)
        (spans if e.name == name else acts).append(tr)
    spans.sort()
    inside = [(s, t, n) for s, t, n in acts
              if any(a <= s and t <= b for a, b, _ in spans)]
    others = Counter(n.replace("(anonymous namespace)::", "")[:60]
                     for _, _, n in inside if not (own and own in n))
    return (len(spans), len(inside), sum(t - s for s, t, _ in inside) / 1e3,
            len(inside) - sum(others.values()), dict(others))


def _profile(run, card, what, *focus, ranges=(), totals=None):
    """Trace `run` with torch.profiler: the device's busy share of its wall
    time (returned; None where the profiler saw no device time), and
    device time by kernel (single stream, so kernel times add up
    without overlap); each `focus` = (label, name patterns): those kernels'
    device time and launches on a line of their own (and in `totals`,
    label -> (ms, launches), where given); each of `ranges`, a
    (name, pattern, label) of a torch.profiler range: its calls and the
    kernels inside them (those whose name holds `pattern` counted apart as
    `label`'s)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key in {r[0] for r in ranges}:
            continue          # a range's device span is no kernel of its own
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if not busy:
        print(f"profile {what}: torch.profiler saw no device time (not "
              f"measured) [{card}]")
        return None
    print(f"profile {what}: wall {wall_us / 1e3:.1f} ms (traced), device busy "
          f"{busy / 1e3:.1f} ms = {100 * busy / wall_us:.1f}% [{card}]")
    for us, n, key in sorted(rows, reverse=True)[:12]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / busy:5.1f}%  x{n:<6d} {key[:90]}")
    groups = {"bn_apply kernels (K8/K9)": ("bn_apply",),
              "flash attention kernels (K10/K11)": ("flash_",),
              "other hand-written kernels": (
                  "layer_norm", "attention", "prefill_mma", "attn_bwd",
                  "softmax_xent", "paged_decode", "bottleneck"),
              "library convolutions and products": (
                  "conv", "xmma", "cudnn", "cutlass", "gemm", "gemv", "wgrad",
                  "dgrad", "nchwToNhwc", "nhwcToNchw", "sgemm", "nvjet")}
    sums = dict.fromkeys(list(groups) + ["torch elementwise, reductions, copies"], 0.0)
    for us, _, key in rows:
        low = key.lower()
        name = next((g for g, pats in groups.items()
                     if any(p.lower() in low for p in pats)),
                    "torch elementwise, reductions, copies")
        sums[name] += us
    for name, us in sums.items():
        print(f"  by group: {us / 1e3:9.3f} ms {100 * us / busy:5.1f}%  {name}")
    for label, pats in focus:
        hit = [(key.replace("(anonymous namespace)::", "").replace(
                    "void ", "").split("(")[0], n, us)
               for us, n, key in rows if any(p in key for p in pats)]
        total = sum(us for _, _, us in hit)
        if totals is not None:
            totals[label] = (total / 1e3, sum(n for _, n, _ in hit))
        print(f"  {label}: {total / 1e3:.3f} ms = {100 * total / busy:.1f}% of "
              f"busy, " + "; ".join(f"{k} x{n} {us / 1e3:.3f} ms"
                                    for k, n, us in hit) + f" [{card}]")
    for name, own, label in ranges:
        calls, n, ms, hand, others = kernels_in_ranges(prof, name, own)
        mine = f"{hand} of them {label}, {n - hand} torch's: " if own else ""
        print(f"  inside the {calls} {name!r} calls: {n} kernel launches, "
              f"{ms:.3f} ms ({mine}{others}) [{card}]")
    return busy / wall_us


def _kernel_name(mangled: str) -> str:
    """`name<template args>` of a kernel's mangled name (nested names; the
    integer, bool, float and bf16 template arguments the port's kernels
    have)."""
    i, name = 3, mangled                         # past "_ZN"
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    if mangled[i:i + 1] != "I":
        return name
    args, j = [], i + 1
    while j < len(mangled) and mangled[j] != "E":
        if mangled.startswith("Li", j):
            k = mangled.index("E", j)
            args.append(mangled[j + 2:k])
            j = k + 1
        elif mangled.startswith("Lb", j):
            args.append("true" if mangled[j + 2] == "1" else "false")
            j += 4
        elif mangled[j] == "f":
            args.append("float")
            j += 1
        elif mangled[j].isdigit():
            k = j
            while mangled[k].isdigit():
                k += 1
            t = mangled[k:k + int(mangled[j:k])]
            args.append("bf16" if t == "__nv_bfloat16" else t)
            j = k + int(mangled[j:k])
        else:
            break
    return name + "<" + ", ".join(args) + ">"


# dynamic shared memory (bytes) of the kernels that size it by their template
# arguments (ptxas reports static shared memory only): the fp32 K2/K4 kernels
# (D, RG), the layouts of csrc/attention_f32.cuh and attention_backward.cu
# (D + 4 floats a tile row, 8 RG rows a block, two stages of 64-row streamed
# tiles, score rows of 80 floats, 144 in the head kernel); the bf16 K10/K11
# wgmma kernels, csrc/flash_attention.cu and flash_attention_backward.cu
# (1024 bytes of alignment slack, resident tiles, ST stages of streamed
# tiles; a stage of the key pass is rounded up to 1024 bytes); K12's wgmma
# kernel, csrc/attn_probe.cu (1024 bytes of slack, 2 Q stages of 64 NWG
# rows, 10 or 5 K/V stages of 128 rows, 64 output rows a warpgroup); #15's
# wgmma kernel, csrc/bottleneck_block.cu (1024 bytes of slack, 8 KB atoms:
# 2 KC of w1 and w3, 9 of w2, 3 y1 tiles, 4 x and 4 residual atoms); K13,
# csrc/dma_probe.cu (6 stages of 32 KB)
DYN_SMEM = {
    "prefill_attention_f32_kernel":
        lambda D, RG: 4 * ((8 * RG + 256) * (D + 4) + 8 * RG * 80),
    "attn_bwd_head_f32_kernel": lambda: 4 * (4 * 128 * 68 + 128 * 144),
    "attn_bwd_q_f32_kernel":
        lambda D, RG: 4 * ((16 * RG + 256) * (D + 4) + 8 * RG * 80),
    "attn_bwd_kv_f32_kernel":
        lambda D, RG: 4 * ((16 * RG + 256) * (D + 4) + 256 + 8 * RG * 80),
    "flash_fwd_wg_kernel":
        lambda D, KN, ST, NWG: 1024 + 2 * (64 * NWG * D + 2 * ST * KN * D),
    "flash_bwd_dq_wg_kernel":
        lambda D, KN, ST: 1024 + 2 * (2 * 128 * D + 2 * ST * KN * D),
    "flash_bwd_dkv_wg_kernel":
        lambda D, QM, ST: 1024 + 4 * 128 * D
        + ST * -(-(4 * QM * D + 8 * QM) // 1024) * 1024,
    "attn_probe_wg_kernel":
        lambda VAR, NWG: 1024 + 128 * (128 * NWG + (10 if NWG == 2 else 5)
                                       * 128 + 64 * NWG),
    "bottleneck_wg_kernel": lambda KC: 1024 + 8192 * (2 * KC + 20),
    "dma_probe_kernel": lambda: 6 * 32768}


def _resources(build):
    """(source, kernel, registers, spills) of every kernel, from nvcc's
    -Xptxas -v report, with the dynamic shared memory of those in
    DYN_SMEM."""
    out = []
    for src in build.SOURCES:
        log = build.BUILD_DIR / f"{src}.log"
        if not log.exists():
            continue
        kernel, spill = "?", ""
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = _kernel_name(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                spill = f"spills {m.group(1)} / {m.group(2)} bytes"
            m = re.search(r"Used (\d+) registers", line)
            if m:
                base, smem = kernel.split("<")[0], ""
                st = re.search(r"(\d+) bytes smem", line)
                if st:
                    smem = f", {st.group(1)} bytes of static shared memory"
                if base in DYN_SMEM:
                    args = (int(a) for a in kernel[len(base) + 1:-1].split(", ")
                            if a)
                    smem += (f", {DYN_SMEM[base](*args)} bytes of dynamic "
                             f"shared memory")
                out.append((src, kernel, m.group(1), spill + smem))
    return out


def _print_resources(build):
    for src, kernel, regs, rest in _resources(build):
        print(f"  {src}: {kernel}: {regs} registers, {rest}")


# ---------------------------------------------------------------------------
# The op and layer long tail: every new op on the card at a public model's
# size, MobileNetV3-Large training and the book's recommender.
# ---------------------------------------------------------------------------

LT_L2 = 1e-5           # each output and grad on the card against the CPU
LT_SIGMAS = 6.0        # the random ops' moments and frequencies
# the sizes `_longtail_cases` names (its docstring gives their sources)
LT_DIMS = dict(act=(128, 16, 112, 112), red=(128, 960, 7, 7),
               bert=(32, 128, 768, 30522), mlm_rows=4096, ctr=(2048, 26),
               kl=(256, 1000), seg=(8, 512, 1024), gn=(32, 256, 56, 56),
               inorm=(1, 256, 64, 64), prelu=(128, 64, 56, 56),
               sn=(512, 512, 3, 3),
               tree=(64, 63, 128, 64), hs=(1024, 300, 100_000),
               face=(128, 512, 10_575), gnd=(64, 512),
               nce=(1024, 300, 100_000), sampled=(256, 100_000, 8192),
               draws=(4096, 768))


def _longtail_cases():
    """(op, inputs {slot: {name: array}}, outputs, attrs, cotangent shapes
    {output: shape}, inputs that take no grad) at the sizes users run each
    op: the activations on MobileNetV3's first map [128, 16, 112, 112];
    reductions on its last [128, 960, 7, 7]; BERT-base rows (B=32, S=128,
    H=768, vocab 30522) for dot, norm, log_softmax [4096, 30522] (the MLM
    rows), gather_nd / scatter_nd_add on [64, 512, 768], lookup_table_v2;
    DeepFM's batch (bench.py:639 bench_deepfm_giant: 2048 x 26 ids mod
    10,000,000) for hash, the integer ops, the CTR losses, cvm, data_norm;
    group_norm on [32, 256, 56, 56] with 32 groups (the GroupNorm paper's
    ResNet-50); instance_norm on [1, 256, 64, 64] (CycleGAN's residual
    blocks); hsigmoid at D = 300 over 100,000 classes, B = 1024;
    spectral_norm on a [512, 4608] conv weight (SN-GAN's 3x3x512);
    mean_iou on Cityscapes crops (19 classes, B=8 of 512 x 1024);
    center_loss on 512-wide face embeddings over CASIA-WebFace's 10,575
    classes, B=128; tree_conv at TBCNN's widths cut to 64 nodes."""
    rng = np.random.default_rng(SEED + 22)
    d = LT_DIMS

    def f(*shape, scale=1.0, shift=0.0):
        return (shift + scale * rng.standard_normal(shape)).astype(np.float32)

    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def ints(lo, hi, *shape):
        return rng.integers(lo, hi, shape).astype(np.int32)

    A, R = d["act"], d["red"]
    CB, NF = d["ctr"]
    ids = rng.integers(0, 10_000_000, (CB, NF)).astype(np.int64)
    acts = {"abs": {}, "logsigmoid": {}, "round": None, "sin": {},
            "softplus": {}, "softsign": {}, "square": {}, "relu6": {},
            "leaky_relu": {"alpha": 0.1}, "elu": {}, "hard_sigmoid": {},
            "swish": {}, "brelu": {}, "soft_relu": {},
            "thresholded_relu": {}, "hard_swish": {}, "stanh": {}, "selu": {}}
    x_act = f(*A, scale=3.0)
    cases = [(op, {"X": {"x": x_act}}, {"Out": ["o"]}, attrs or {},
              {} if attrs is None else {"o": A}, ())
             for op, attrs in acts.items()]
    cases.append(("rsqrt", {"X": {"x": u(0.1, 4.0, *A)}}, {"Out": ["o"]}, {},
                  {"o": A}, ()))
    num, den = ints(-10_000_000, 10_000_000, CB, NF), ints(1, 1000, CB, NF)
    den = den * np.where(rng.random((CB, NF)) < 0.5, -1, 1).astype(np.int32)
    B, S, H, V = d["bert"]
    MLM = d["mlm_rows"]
    TB, E, TF, TO = d["tree"]
    HB, HD, HC = d["hs"]
    FB, FD, FC = d["face"]
    GX, GY = d["gnd"]
    edges = np.zeros((TB, E, 2), np.int32)
    for b in range(TB):
        n = int(rng.integers(E // 2, E + 1))
        edges[b, :n, 0] = [1 + int(rng.integers(0, i + 1)) for i in range(n)]
        edges[b, :n, 1] = np.arange(2, n + 2)
    cases += [
        ("elementwise_floordiv", {"X": {"x": num}, "Y": {"y": den}},
         {"Out": ["o"]}, {}, {}, ()),
        ("elementwise_mod", {"X": {"x": num}, "Y": {"y": den}},
         {"Out": ["o"]}, {}, {}, ()),
        ("reduce_max", {"X": {"x": f(*R)}}, {"Out": ["o"]}, {"dim": [2, 3]},
         {"o": R[:2]}, ()),
        ("reduce_min", {"X": {"x": f(*R)}}, {"Out": ["o"]},
         {"dim": [2, 3], "keep_dim": True}, {"o": R[:2] + (1, 1)}, ()),
        ("reduce_prod", {"X": {"x": u(0.97, 1.03, *R)}}, {"Out": ["o"]},
         {"dim": [2, 3]}, {"o": R[:2]}, ()),
        ("reduce_all", {"X": {"x": f(*R) > -3.0}}, {"Out": ["o"]},
         {"dim": [2, 3]}, {}, ()),
        ("reduce_any", {"X": {"x": f(*R) > 3.0}}, {"Out": ["o"]},
         {"dim": [2, 3]}, {}, ()),
        ("dot", {"X": {"x": f(B * S, H)}, "Y": {"y": f(B * S, H)}},
         {"Out": ["o"]}, {}, {"o": (B * S, 1)}, ()),
        ("norm", {"X": {"x": f(B * S, H)}}, {"Out": ["o"], "Norm": ["n"]},
         {"axis": 1, "epsilon": 1e-10}, {"o": (B * S, H)}, ()),
        ("cos_sim", {"X": {"x": f(256, 200)}, "Y": {"y": f(256, 200)}},
         {"Out": ["o"], "XNorm": ["xn"], "YNorm": ["yn"]}, {},
         {"o": (256, 1)}, ()),
        ("isfinite", {"X": {"x": x_act}}, {"Out": ["o"]}, {}, {}, ()),
        ("mean_iou", {"Predictions": {"p": ints(0, 19, *d["seg"])},
                      "Labels": {"l": ints(0, 19, *d["seg"])}},
         {"OutMeanIou": ["m"], "OutWrong": ["w"], "OutCorrect": ["c"]},
         {"num_classes": 19}, {}, ()),
        ("log_loss", {"Predicted": {"p": u(0.01, 0.99, CB, 1)},
                      "Labels": {"l": (rng.random((CB, 1)) < 0.3)
                                 .astype(np.float32)}},
         {"Loss": ["o"]}, {}, {"o": (CB, 1)}, ()),
        ("huber_loss", {"X": {"x": f(CB, 1)}, "Y": {"y": f(CB, 1)}},
         {"Out": ["o"], "Residual": ["r"]}, {"delta": 1.0},
         {"o": (CB, 1)}, ()),
        ("kldiv_loss", {"X": {"x": np.log(u(1e-3, 1.0, *d["kl"]))},
                        "Target": {"t": u(1e-3, 1.0, *d["kl"])}},
         {"Loss": ["o"]}, {"reduction": "batchmean"}, {"o": ()}, ()),
        ("rank_loss", {"Label": {"l": (rng.random((CB, 1)) < 0.5)
                                 .astype(np.float32)},
                       "Left": {"a": f(CB, 1)}, "Right": {"b": f(CB, 1)}},
         {"Out": ["o"]}, {}, {"o": (CB, 1)}, ()),
        ("margin_rank_loss", {"Label": {"l": np.sign(f(CB, 1))},
                              "X1": {"a": f(CB, 1)}, "X2": {"b": f(CB, 1)}},
         {"Out": ["o"], "Activated": ["act"]}, {"margin": 0.1},
         {"o": (CB, 1)}, ()),
        ("bpr_loss", {"X": {"x": f(HB, 100)},
                      "Label": {"l": ints(0, 100, HB, 1)}},
         {"Y": ["o"]}, {}, {"o": (HB, 1)}, ()),
        ("center_loss", {"X": {"x": f(FB, FD)},
                         "Label": {"l": ints(0, FC, FB, 1)},
                         "Centers": {"c": f(FC, FD, scale=0.1)},
                         "CenterUpdateRate": {"a": np.array([0.5], np.float32)}},
         {"Loss": ["o"], "SampleCenterDiff": ["d"], "CentersOut": ["co"]},
         {"need_update": True}, {"o": (FB, 1)}, ("c", "a")),
        ("teacher_student_sigmoid_loss",
         {"X": {"x": f(CB, 1, scale=4.0)},
          "Label": {"l": rng.choice([-2.0, -1.0, 0.3, 1.6], (CB, 1))
                    .astype(np.float32)}},
         {"Y": ["o"]}, {}, {"o": (CB, 1)}, ("l",)),
        ("fill_zeros_like", {"X": {"x": f(B * S, H)}}, {"Out": ["o"]}, {}, {}, ()),
        ("shape", {"X": {"x": x_act}}, {"Out": ["o"]}, {}, {}, ()),
        ("flatten2", {"X": {"x": f(A[0], 1280, 1, 1)}}, {"Out": ["o"]},
         {"axis": 1}, {"o": (A[0], 1280)}, ()),
        ("strided_slice", {"Input": {"x": x_act}}, {"Out": ["o"]},
         {"axes": [2, 3], "starts": [0, A[3] - 1], "ends": [A[2], 0],
          "strides": [2, -2]}, {"o": (A[0], A[1], A[2] // 2, A[3] // 2)}, ()),
        ("stack", {"X": {f"h{i}": f(B, S, H) for i in range(4)}}, {"Y": ["o"]},
         {"axis": 0}, {"o": (4, B, S, H)}, ()),
        ("unstack", {"X": {"x": f(B, 12, S, 64)}},
         {"Y": [f"o{i}" for i in range(12)]}, {"axis": 1},
         {f"o{i}": (B, S, 64) for i in range(12)}, ()),
        ("expand", {"X": {"x": f(B, 1, S)}}, {"Out": ["o"]},
         {"expand_times": [1, S, 1]}, {"o": (B, S, S)}, ()),
        ("gather_nd", {"X": {"x": f(GX, GY, H)},
                       "Index": {"i": np.stack([ints(0, GX, B * S),
                                                ints(0, GY, B * S)], 1)}},
         {"Out": ["o"]}, {}, {"o": (B * S, H)}, ()),
        ("scatter_nd_add", {"X": {"x": f(GX, GY, H)},
                            "Index": {"i": np.stack([ints(0, GX, B * S),
                                                     ints(0, GY, B * S)], 1)},
                            "Updates": {"u": f(B * S, H)}},
         {"Out": ["o"]}, {}, {"o": (GX, GY, H)}, ()),
        ("scatter_nd", {"Index": {"i": ints(0, V, B * S, 1)},
                        "Updates": {"u": f(B * S, H)}},
         {"Out": ["o"]}, {"shape": [V, H]}, {}, ()),
        ("cum", {"X": {"x": f(B, 4 * S)}}, {"Out": ["o"]},
         {"axis": 1, "exclusive": True, "reverse": True}, {"o": (B, 4 * S)}, ()),
        ("arg_min", {"X": {"x": f(B * S, d["kl"][1])}}, {"Out": ["o"]},
         {"axis": 1}, {}, ()),
        ("pad2d", {"X": {"x": x_act}}, {"Out": ["o"]},
         {"paddings": [1, 1, 1, 1], "mode": "reflect"},
         {"o": A[:2] + (A[2] + 2, A[3] + 2)}, ()),
        ("pad", {"X": {"x": f(B, S, H)}}, {"Out": ["o"]},
         {"paddings": [0, 0, 0, 32, 0, 0], "pad_value": 0.0},
         {"o": (B, S + 32, H)}, ()),
        ("argsort", {"X": {"x": np.round(f(B * S, d["kl"][1]), 1)}},
         {"Out": ["o"], "Indices": ["i"]}, {"axis": 1}, {}, ()),
        ("linspace", {}, {"Out": ["o"]},
         {"start": -1.0, "stop": 1.0, "num": A[0] * A[1] * 512, "dtype": "float32"},
         {}, ()),
        ("assign_value", {}, {"Out": ["o"]},
         {"shape": [S, H], "dtype": "float32",
          "values": f(S * H).tolist()}, {}, ()),
        ("fill_constant_batch_size_like", {"Input": {"x": ids.astype(np.int32)}},
         {"Out": ["o"]}, {"shape": [-1, 200], "dtype": "float32",
                          "value": 0.5}, {}, ()),
        ("hash", {"X": {"x": ids.reshape(-1, 1)}}, {"Out": ["o"]},
         {"num_hash": 2, "mod_by": 10_000_000}, {}, ()),
        ("cvm", {"X": {"x": u(0.0, 50.0, CB, 2 + 64)},
                 "CVM": {"c": u(0.0, 50.0, CB, 2)}},
         {"Y": ["o"]}, {"use_cvm": True}, {"o": (CB, 66)}, ("c",)),
        ("log_softmax", {"X": {"x": f(MLM, V, scale=2.0)}}, {"Out": ["o"]},
         {}, {"o": (MLM, V)}, ()),
        ("smooth_l1_loss", {"X": {"x": f(8 * CB, 4)}, "Y": {"y": f(8 * CB, 4)},
                            "InsideWeight": {"iw": u(0, 1, 8 * CB, 4)},
                            "OutsideWeight": {"ow": u(0, 1, 8 * CB, 4)}},
         {"Out": ["o"], "Diff": ["d"]}, {"sigma": 3.0}, {"o": (8 * CB, 1)}, ()),
        ("group_norm", {"X": {"x": f(*d["gn"])}, "Scale": {"s": f(d["gn"][1])},
                        "Bias": {"b": f(d["gn"][1])}},
         {"Y": ["o"], "Mean": ["m"], "Variance": ["v"]},
         {"groups": 32, "epsilon": 1e-5}, {"o": d["gn"]}, ()),
        ("instance_norm", {"X": {"x": f(*d["inorm"])}, "Scale": {"s": f(d["inorm"][1])},
                           "Bias": {"b": f(d["inorm"][1])}},
         {"Y": ["o"]}, {"epsilon": 1e-5}, {"o": d["inorm"]}, ()),
        ("lookup_table_v2", {"W": {"w": f(V, H, scale=0.02)},
                             "Ids": {"i": ints(0, V, B, S)}},
         {"Out": ["o"]}, {}, {"o": (B, S, H)}, ()),
        ("prelu", {"X": {"x": f(*d["prelu"])},
                   "Alpha": {"a": u(0, 0.5, d["prelu"][1])}},
         {"Out": ["o"]}, {"mode": "channel"}, {"o": d["prelu"]}, ()),
        ("data_norm", {"X": {"x": f(CB, 64)},
                       "BatchSize": {"bs": u(1e4, 2e4, 64)},
                       "BatchSum": {"bm": f(64, scale=100.0)},
                       "BatchSquareSum": {"bq": u(1e4, 2e4, 64)}},
         {"Y": ["o"], "Means": ["m"], "Scales": ["s"]}, {"epsilon": 1e-4},
         {"o": (CB, 64)}, ()),
        ("spectral_norm", {"Weight": {"w": f(*d["sn"], scale=0.05)},
                           "U": {"u": f(d["sn"][0])},
                           "V": {"v": f(int(np.prod(d["sn"][1:])))}},
         {"Out": ["o"], "UOut": ["uo"], "VOut": ["vo"]},
         {"dim": 0, "power_iters": 1}, {"o": d["sn"]}, ("u", "v")),
        ("tree_conv", {"NodesVector": {"n": f(TB, E + 1, TF)},
                       "EdgeSet": {"e": edges},
                       "Filter": {"w": f(TF, 3, TO, 1, scale=0.1)}},
         {"Out": ["o"]}, {"max_depth": 2}, {"o": (TB, E + 1, TO, 1)}, ()),
        ("hierarchical_sigmoid", {"X": {"x": f(HB, HD, scale=0.3)},
                                  "W": {"w": f(HC - 1, HD, scale=0.05)},
                                  "Bias": {"b": f(HC - 1, scale=0.1)},
                                  "Label": {"l": ints(0, HC, HB, 1)}},
         {"Out": ["o"], "PreOut": ["p"]}, {"num_classes": HC},
         {"o": (HB, 1)}, ()),
    ]
    return cases


def _lt_launches(dev, program, what):
    """The launches of one run of `program`, held to what its ops say on
    the card (none on the CPU)."""
    from paddle_tpu_torch.ops import cuda_kernels as ck

    if dev.type == "cuda":
        return _check_launches(program, what)
    return {k: v for k, v in ck.launch_counts_by_dtype().items() if v}


def _lt_hold(what, names, got, want):
    """Card outputs against the CPU's: integers and bools bit for bit,
    floats within LT_L2 relative L2. Returns the worst relative L2."""
    worst = 0.0
    for n, g, w in zip(names, got, want):
        if not w.is_floating_point():
            if g.dtype != w.dtype or not torch.equal(g.cpu(), w):
                raise RuntimeError(f"{what}: {n} differs on the card")
            continue
        e = _rel_l2(g.cpu(), w)
        if not e <= LT_L2:
            raise RuntimeError(f"{what}: {n} on the card is {e:.3e} relative "
                               f"L2 from the CPU (limit {LT_L2})")
        worst = max(worst, e)
    return worst


def _lt_run(dev, main, fetch, feed, sync_free=True):
    """One run of `main` on the card (each op's compute under the sync
    debug mode "error" when `sync_free`) and on the CPU, from fresh
    scopes: (card fetches, CPU fetches, the dispatches gated)."""
    import paddle_tpu_torch as pt

    seen = {}
    undo = (_sync_free({o.type for o in main.global_block.ops}, seen)
            if sync_free else (lambda: None))
    try:
        got = pt.Executor(place=dev).run(main, feed=_on(dev, feed),
                                         fetch_list=fetch, scope=pt.Scope(),
                                         return_numpy=False)
        _sync(dev)
    finally:
        undo()
    want = pt.Executor(place="cpu").run(main, feed=feed, fetch_list=fetch,
                                        scope=pt.Scope(), return_numpy=False)
    return got, want, seen


def _lt_ms(dev, main, fetch, feed):
    import paddle_tpu_torch as pt

    if dev.type != "cuda":
        return float("nan")
    exe, scope, dfeed = pt.Executor(place=dev), pt.Scope(), _on(dev, feed)
    # the better of two single runs (windows of 3x3, then 2x2, before
    # depth cuts)
    return 1e3 * min(_timed_windows(lambda: exe.run(
        main, feed=dfeed, fetch_list=fetch, scope=scope,
        return_numpy=False), 1, 2))


def _lt_moments(what, t, mean, std, lo=None, hi=None):
    a = t.double()
    n = a.numel()
    m, v = float(a.mean()), float(a.var())
    if not (abs(m - mean) <= LT_SIGMAS * std / n ** 0.5
            and abs(v - std * std) <= LT_SIGMAS * std * std * (2.0 / n) ** 0.5):
        raise RuntimeError(f"{what}: mean {m:.6f}, var {v:.6f} against "
                           f"{mean}, {std * std:.6f} ({n} draws)")
    if lo is not None and not (float(a.min()) >= lo and float(a.max()) <= hi):
        raise RuntimeError(f"{what}: a draw outside [{lo}, {hi}]")
    return m, v ** 0.5


def _lt_random(dev, card, rows):
    """The three random creation ops on the card at BERT-base's [4096, 768]
    (an initializer's draw): range, mean and standard deviation within
    LT_SIGMAS sigmas; nce (log-uniform, 5 negatives, D = 300 over 100,000
    classes, B = 1024) and the sampled softmax (logits [256, 100000], 8,192
    samples, its cross entropy on K6/K7) by their saved draws: the id
    frequencies against the log-uniform law, the rest of the op and its
    grad against the port's CPU computation on the card's draws."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.ops import sampling_ops as so

    rng = np.random.default_rng(SEED + 23)
    DR, DC = LT_DIMS["draws"]
    like = {"Input": {"x": np.zeros((DR, 3), np.float32)}}
    sd = (1 - 2 * 2.0 * np.exp(-2.0) / (2 * np.pi) ** 0.5
          / float(torch.erf(torch.tensor(2.0 / 2 ** 0.5)))) ** 0.5
    for op, ins, attrs, mean, std, lo, hi in (
            ("truncated_gaussian_random", {},
             {"shape": [DR, DC], "mean": 0.0, "std": 0.02}, 0.0, 0.02 * sd,
             -0.04, 0.04),
            ("uniform_random_batch_size_like", like,
             {"shape": [-1, DC], "min": -0.1, "max": 0.1}, 0.0,
             0.2 / 12 ** 0.5, -0.1, 0.1),
            ("gaussian_random_batch_size_like", like,
             {"shape": [-1, DC], "mean": 1.0, "std": 0.5}, 1.0, 0.5,
             None, None)):
        main, fetch = _seq_program(op, ins, {"Out": ["o"]}, attrs, {})
        main.random_seed = SEED
        seen = {}
        undo = _sync_free({op}, seen)
        try:
            got = pt.Executor(place=dev).run(main, feed=_on(dev, {
                n: a for d in ins.values() for n, a in d.items()}),
                fetch_list=fetch, scope=pt.Scope(), return_numpy=False)[0]
            _sync(dev)
        finally:
            undo()
        m, s = _lt_moments(op, got, mean, std, lo, hi)
        ms = _lt_ms(dev, main, fetch, {n: a for d in ins.values()
                                       for n, a in d.items()})
        rows.append(f"{op} {ms:.3f} ms (mean {m:.5f}, std {s:.5f})")

    # nce: the saved draws replayed on the CPU
    (Bn, D, C), k = LT_DIMS["nce"], 5
    ins = {"Input": {"x": (0.3 * rng.standard_normal((Bn, D))).astype(np.float32)},
           "Label": {"l": rng.integers(0, C, (Bn, 1)).astype(np.int32)},
           "Weight": {"w": (0.05 * rng.standard_normal((C, D))).astype(np.float32)},
           "Bias": {"b": (0.1 * rng.standard_normal(C)).astype(np.float32)}}
    main, fetch = _seq_program(
        "nce", ins, {"Cost": ["o"], "SampleLabels": ["s"]},
        {"num_total_classes": C, "num_neg_samples": k, "sampler": 1},
        {"o": (Bn, 1)})
    feed = {n: a for d in ins.values() for n, a in d.items()}
    feed["o_cot"] = rng.standard_normal((Bn, 1)).astype(np.float32)
    seen = {}
    undo = _sync_free({o.type for o in main.global_block.ops}, seen)
    try:
        got = pt.Executor(place=dev).run(main, feed=_on(dev, feed),
                                         fetch_list=fetch, scope=pt.Scope(),
                                         return_numpy=False)
        _sync(dev)
    finally:
        undo()
    s = got[1].cpu()
    leaves = [torch.from_numpy(feed[n]).requires_grad_() for n in ("x", "w", "b")]
    cost = so._nce_loss(leaves[0], torch.from_numpy(feed["l"]), leaves[1],
                        leaves[2], s, C, k, 1)
    ref = torch.autograd.grad(cost, leaves, torch.from_numpy(feed["o_cot"]))
    worst = _lt_hold("nce on its saved draws", ["Cost"] + fetch[2:],
                     [got[0]] + got[2:], [cost.detach()] + list(ref))
    ids = s.reshape(-1).long()
    for c in range(3):
        p = np.log((c + 2) / (c + 1)) / np.log(C + 1)
        fr = float((ids == c).double().mean())
        if not abs(fr - p) <= LT_SIGMAS * (p * (1 - p) / ids.numel()) ** 0.5:
            raise RuntimeError(f"nce: id {c} drawn {fr:.5f} of the time, the "
                               f"log-uniform law says {p:.5f}")
    ms = _lt_ms(dev, main, fetch, feed)
    rows.append(f"nce {ms:.3f} ms (forward and nce_grad on the saved draws, "
                f"worst {worst:.2e}; id 0 drawn {float((ids == 0).double().mean()):.5f})")

    # the sampled softmax: sample_logits, then the cross entropy on K6/K7
    Bs, Vs, S = LT_DIMS["sampled"]
    logits = rng.standard_normal((Bs, Vs)).astype(np.float32)
    label = rng.integers(0, Vs, (Bs, 1)).astype(np.int32)
    smain, sstart = pt.Program(), pt.Program()
    with pt.program_guard(smain, sstart), unique_name.guard():
        L = pt.layers
        lg = L.data(name="logits", shape=[Vs], dtype="float32",
                    stop_gradient=False)
        lb = L.data(name="label", shape=[1], dtype="int64")
        loss = L.mean(L.sampled_softmax_with_cross_entropy(lg, lb, S))
        dlg = pt.gradients([loss], [lg])[0]
    smain.random_seed = SEED
    samples = [o for o in smain.global_block.ops
               if o.type == "sample_logits"][0].outputs["Samples"][0]
    fetch = [loss.name, dlg.name, samples]
    ck.reset_launch_counts()
    got = pt.Executor(place=dev).run(smain, feed=_on(dev, {
        "logits": logits, "label": label}), fetch_list=fetch,
        scope=pt.Scope(), return_numpy=False)
    _sync(dev)
    counts = _lt_launches(dev, smain, "sampled softmax")
    s = got[2].cpu().long()
    lt = torch.from_numpy(logits).requires_grad_()
    q = so._log_uniform_prob(s, Vs)
    adj = lt.gather(1, s) - torch.log(q + 1e-20)
    hit = torch.cat([torch.zeros(Bs, 1, dtype=torch.bool),
                     s[:, 1:] == torch.from_numpy(label).long()], 1)
    adj = torch.where(hit, adj - 1e20, adj)
    ref = torch.nn.functional.cross_entropy(adj, torch.zeros(Bs, dtype=torch.long))
    worst = _lt_hold("the sampled softmax on its saved draws",
                     ["loss", "dLogits"], got[:2],
                     [ref.detach().reshape(got[0].shape),
                      torch.autograd.grad(ref, lt)[0]])
    if not torch.equal(s[:, 0], torch.from_numpy(label).long()[:, 0]):
        raise RuntimeError("sample_logits: the true labels are not the first "
                           "samples")
    ms = _lt_ms(dev, smain, fetch, {"logits": logits, "label": label})
    rows.append(f"sample_logits + softmax_with_cross_entropy {ms:.3f} ms "
                f"(worst {worst:.2e}; launches {counts})")
    return counts


def _lt_host(dev, card, rows):
    """The host ops on the card (no sync gate: they read back by design)
    against the CPU: unique and unique_with_counts on DeepFM's 2048 x 26
    ids (encounter order, bit for bit), filter_by_instag on a CTR batch of
    2048 with 4 tags a row, print (its line and pass-through) and py_func
    (tanh and its grad on BERT-base rows)."""
    import io

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name

    rng = np.random.default_rng(SEED + 24)
    CB, NF = LT_DIMS["ctr"]
    ids = rng.integers(0, 10_000_000, (CB * NF,)).astype(np.int32)
    ids[::3] = ids[0]                     # repeats, in encounter order
    cases = [
        ("unique", {"X": {"x": ids}}, {"Out": ["o"], "Index": ["i"]},
         {"dtype": "int32"}),
        ("unique_with_counts", {"X": {"x": ids}},
         {"Out": ["o"], "Index": ["i"], "Count": ["c"]}, {"dtype": "int64"}),
        ("filter_by_instag",
         {"Ins": {"x": rng.standard_normal((CB, 64)).astype(np.float32)},
          "Ins_tag": {"t": rng.integers(-1, 100, (CB, 4)).astype(np.int64)},
          "Filter_tag": {"f": rng.integers(0, 100, 10).astype(np.int64)}},
         {"Out": ["o"], "LossWeight": ["w"], "IndexMap": ["m"]}, {}),
        ("print", {"In": {"x": rng.standard_normal((4, 8)).astype(np.float32)}},
         {"Out": ["o"]}, {"message": "longtail", "summarize": 5,
                          "first_n": 2, "print_phase": "forward"}),
    ]
    for op, ins, outs, attrs in cases:
        main, fetch = _seq_program(op, ins, outs, attrs, {})
        feed = {n: a for d in ins.values() for n, a in d.items()}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            got, want, _ = _lt_run(dev, main, fetch, feed, sync_free=False)
        _lt_hold(op, fetch, got, want)
        if op == "print":
            lines = buf.getvalue().splitlines()
            if len(lines) != 2 or lines[0] != lines[1] or not lines[0].startswith(
                    "longtail  shape=(4, 8) dtype=float32"):
                raise RuntimeError(f"print: lines {lines}")
            if not torch.equal(got[0].cpu(), torch.from_numpy(feed["x"])):
                raise RuntimeError("print: not a pass-through")
        if op.startswith("unique"):
            first = np.unique(ids, return_index=True)[1]
            if not np.array_equal(got[0].cpu().numpy(), ids[np.sort(first)]):
                raise RuntimeError(f"{op}: not in encounter order")
        ms = _lt_ms(dev, main, fetch, feed) if op != "print" else float("nan")
        rows.append(f"{op} {ms:.3f} ms (host op)")

    main, start = pt.Program(), pt.Program()
    with pt.program_guard(main, start), unique_name.guard():
        L = pt.layers
        x = L.data(name="x", shape=[LT_DIMS["draws"][1]], dtype="float32",
                   stop_gradient=False)
        y = main.current_block().create_var(name="y", shape=x.shape,
                                            dtype="float32")
        L.py_func(lambda a: np.tanh(a), x, y,
                  backward_func=lambda a, o, g: g * (1.0 - o * o))
        loss = L.reduce_sum(L.square(y))
        pt.gradients([loss], [x])
    feed = {"x": rng.standard_normal(LT_DIMS["draws"]).astype(np.float32)}
    fetch = [loss.name, "x@GRAD"]
    got, want, _ = _lt_run(dev, main, fetch, feed, sync_free=False)
    worst = _lt_hold("py_func", fetch, got, want)
    ms = _lt_ms(dev, main, fetch, feed)
    rows.append(f"py_func + py_func_grad {ms:.3f} ms (host op, worst {worst:.2e})")


def longtail_ops(dev, card):
    """Each of the 79 new ops as a one-op program, forward and every grad
    (the 7 new grad entries through their ops), on the card and again on
    the CPU (the port's own program, which the CPU tests hold against the
    JAX package): fp32, TF32 off, each output and grad within LT_L2
    relative L2, integers bit for bit; every op but the host ops under the
    sync debug mode "error"; the random ops by their laws and saved draws
    (`_lt_random`). Prints each case's ms a run (forward and grads).
    Returns the sampled softmax's K6/K7 launches."""
    rows = []
    gated = 0
    for op, ins, outs, attrs, cot_shapes, nograd in _longtail_cases():
        main, fetch = _seq_program(op, ins, outs, attrs, cot_shapes, nograd)
        rng = np.random.default_rng(SEED + len(rows))
        feed = {n: a for d in ins.values() for n, a in d.items()}
        feed.update({n + "_cot": np.asarray(rng.standard_normal(s), np.float32)
                     for n, s in cot_shapes.items()})
        got, want, seen = _lt_run(dev, main, fetch, feed)
        gated += sum(seen.values())
        worst = _lt_hold(op, fetch, got, want)
        ms = _lt_ms(dev, main, fetch, feed)
        n_grads = len(fetch) - sum(len(v) for v in outs.values())
        rows.append(f"{op} {ms:.3f} ms ({n_grads} grads, worst {worst:.2e})")
        del got, want
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    counts = _lt_random(dev, card, rows)
    _lt_host(dev, card, rows)
    print(f"longtail ops on the card against the CPU ({len(rows)} cases; "
          f"relative L2 <= {LT_L2}; {gated} op dispatches under the sync "
          f"debug mode 'error'; ms a run of forward and grads, the better "
          f"of two single runs): " + "; ".join(rows) + f" [{card}]")
    return counts


# MobileNetV3-Large x1.0 (Howard et al. 2019, Table 1; PaddleClas's
# MobileNetV3_large_x1_0): (kernel, expansion, out, squeeze-excite, act,
# stride) a bneck
MBV3_LARGE = ((3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
              (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
              (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
              (3, 240, 80, False, "hard_swish", 2),
              (3, 200, 80, False, "hard_swish", 1),
              (3, 184, 80, False, "hard_swish", 1),
              (3, 184, 80, False, "hard_swish", 1),
              (3, 480, 112, True, "hard_swish", 1),
              (3, 672, 112, True, "hard_swish", 1),
              (5, 672, 160, True, "hard_swish", 2),
              (5, 960, 160, True, "hard_swish", 1),
              (5, 960, 160, True, "hard_swish", 1))
MBV3_HOLD_B, MBV3_B, MBV3_LR, MBV3_STEPS = 16, 128, 0.01, 5
MBV3_HW, MBV3_SCALE, MBV3_BNECKS, MBV3_CLASSES = 224, 1.0, MBV3_LARGE, 1000
# step 1 on the card against the CPU: each gradient within MBV3_GRAD_RTOL of
# its max-abs, or of MBV3_GRAD_FLOOR times the largest gradient's max-abs,
# whichever is larger. The floor takes the cancellation residues: a batch
# norm whose output reaches the loss only through a later batch norm has
# a scale or bias gradient that is zero but for rounding. An element
# within MBV3_KINK_NEAR of a kink (relu's 0, hard_swish's -3 and 3, the SE
# gate's -2.5 and 2.5; of the largest input of that op) takes the card's
# side in the CPU run: at B=16 an H100 and the CPU put a dozen such
# elements on opposite sides (11 in one measured step), which moves
# gradients upstream of them by up to 1.6e-2 of their max-abs.
MBV3_GRAD_RTOL, MBV3_GRAD_FLOOR, MBV3_KINK_NEAR = 1e-3, 1e-5, RELU_NEAR


def _divisible(v, d=8):
    """PaddleClas's _make_divisible: v rounded to a multiple of d, never
    below 90% of v."""
    n = max(d, int(v + d / 2) // d * d)
    return n + d if n < 0.9 * v else n


def mobilenet_v3(pt, img, label, scale=1.0, bnecks=MBV3_LARGE, classes=1000):
    """MobileNetV3 in NCHW from `pt`'s layers (either package's): a 3x3
    stride-2 stem of 16 (hard_swish), the bnecks (1x1 expansion, kxk
    depthwise, squeeze-excite pooled to a quarter of the expansion with
    relu then hard_sigmoid(0.2, 0.5), 1x1 projection; a residual where
    the shape holds), a 1x1 conv to 6 x the last width (hard_swish),
    global pooling, a 1x1 conv to 1280 (hard_swish) and the classifier;
    batch norm after every conv but the last two; the mean softmax cross
    entropy. PaddleClas's dropout before the classifier is left out (the
    step is compared with the CPU's). Returns (loss, logits)."""
    L = pt.layers

    def conv_bn(x, c, k, s=1, groups=1, act=None):
        y = L.conv2d(x, c, k, stride=s, padding=(k - 1) // 2, groups=groups,
                     bias_attr=False)
        return L.batch_norm(y, act=act)

    x = conv_bn(img, _divisible(16 * scale), 3, 2, act="hard_swish")
    cin = _divisible(16 * scale)
    for k, exp, c, se, act, s in bnecks:
        exp, c = _divisible(scale * exp), _divisible(scale * c)
        h = conv_bn(x, exp, 1, act=act)
        h = conv_bn(h, exp, k, s, groups=exp, act=act)
        if se:
            p = L.pool2d(h, pool_type="avg", global_pooling=True)
            p = L.conv2d(p, _divisible(exp // 4), 1, act="relu")
            p = L.hard_sigmoid(L.conv2d(p, exp, 1), slope=0.2, offset=0.5)
            h = L.elementwise_mul(h, p)
        h = conv_bn(h, c, 1)
        x = L.elementwise_add(x, h) if cin == c and s == 1 else h
        cin = c
    x = conv_bn(x, _divisible(scale * bnecks[-1][1]), 1, act="hard_swish")
    x = L.pool2d(x, pool_type="avg", global_pooling=True)
    x = L.conv2d(x, 1280, 1, bias_attr=False, act="hard_swish")
    logits = L.fc(L.flatten(x, axis=1), classes)
    return L.mean(L.softmax_with_cross_entropy(logits, label)), logits


def _mbv3_program(pt):
    """MobileNetV3 at MBV3_HW, MBV3_SCALE, MBV3_BNECKS and MBV3_CLASSES under
    Momentum(MBV3_LR, 0.9): (main, startup, loss)."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        img = pt.layers.data(name="img", shape=[3, MBV3_HW, MBV3_HW],
                             dtype="float32")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        loss, _ = mobilenet_v3(pt, img, label, MBV3_SCALE, MBV3_BNECKS,
                               MBV3_CLASSES)
        pt.optimizer.Momentum(MBV3_LR, 0.9).minimize(loss)
    startup.random_seed = main.random_seed = SEED
    return main, startup, loss


def _bn_stats(main):
    """The running statistics of every batch norm (a batch_norm op, or a
    conv2d_bn the stats pass fused it into)."""
    return [n for o in main.global_block.ops
            if o.type in ("batch_norm", "conv2d_bn")
            for n in (o.inputs["Mean"][0], o.inputs["Variance"][0])]


def _kink_region(x, kinks, card_x, near):
    """Each element's side of the kinks (0 .. len(kinks)), the card's
    within `near` of the largest |x| of a kink; and how many took it."""
    own = sum((x > k).long() for k in kinks)
    theirs = sum((card_x > k).long() for k in kinks)
    close = torch.zeros_like(own, dtype=torch.bool)
    for k in kinks:
        close |= (x - k).abs() <= near * x.abs().max()
    region = torch.where(close, theirs, own)
    return region, int((region != own).sum())


@contextlib.contextmanager
def _card_kinks(main, card_vals, near, taken):
    """While the CPU runs `main`, the relu, hard_swish, hard_sigmoid and
    leaky_relu ops and the norm ops with a folded relu put each element
    within `near` of a kink on the card's side: `card_vals` holds the card's input of each
    such op (by the op's output var) and the output of each folded norm;
    `taken` counts the elements that moved. The gradients follow the
    chosen side (the grad ops replay these computes)."""
    from paddle_tpu_torch.ops import nn_ops, registry
    from paddle_tpu_torch.ops.cuda_kernels import bn_apply as KF
    from paddle_tpu_torch.ops.cuda_kernels import bn_apply_bwd as KB

    def out_name(op):
        return getattr(op, "forward_outputs", op.outputs)["Out"][0]

    def forced(kinds):
        def wrap(plain):
            def compute(ctx):
                name = out_name(ctx.op)
                if name not in card_vals:
                    return plain(ctx)
                x = ctx.input("X")
                kinks, pieces = kinds(ctx, x)
                region, n = _kink_region(x.detach(), kinks,
                                         card_vals[name].reshape(x.shape), near)
                taken[0] += n
                out = pieces[-1]
                for r in range(len(pieces) - 2, -1, -1):
                    out = torch.where(region == r, pieces[r], out)
                return {"Out": out}
            return compute
        return wrap

    def relu(ctx, x):
        return (0.0,), (torch.zeros_like(x), x)

    def hard_swish(ctx, x):
        t, sc, o = (ctx.attr(k, d) for k, d in (("threshold", 6.0),
                                                ("scale", 6.0), ("offset", 3.0)))
        return (-o, t - o), (torch.zeros_like(x), x * (x + o) / sc, x * t / sc)

    def leaky_relu(ctx, x):
        return (0.0,), (x * ctx.attr("alpha", 0.02), x)

    def hard_sigmoid(ctx, x):
        sl, o = ctx.attr("slope", 0.2), ctx.attr("offset", 0.5)
        return (-o / sl, (1 - o) / sl), (torch.zeros_like(x), x * sl + o,
                                         torch.ones_like(x))

    norm = {"y": None}

    def named(grad):
        def wrap(plain):
            def compute(ctx):
                norm["y"] = (ctx.op.inputs["Y@GRAD"][0][:-len("@GRAD")] if grad
                             else ctx.op.outputs["Y"][0])
                return plain(ctx)
            return compute
        return wrap

    def mask(x2, scale, bias, mean, inv, res2, mode):
        z = KF.bn_apply_act_plain(x2, scale, bias, mean, inv, "identity",
                                  res2, mode)
        region, n = _kink_region(z, (0.0,), card_vals[norm["y"]].reshape(
            z.shape), near)
        return z, region == 1, n

    plain_fwd, plain_bwd = nn_ops.bn_apply_act, nn_ops.bn_apply_act_backward

    def bn_fwd(x2, scale, bias, mean, inv, act, res2, mode):
        if act != "relu" or norm["y"] not in card_vals:
            return plain_fwd(x2, scale, bias, mean, inv, act, res2, mode)
        z, m, n = mask(x2, scale, bias, mean, inv, res2, mode)
        taken[0] += n
        return torch.where(m, z, torch.zeros_like(z))

    def bn_bwd(x2, scale, bias, mean, inv, dy2, act, res2, mode, count):
        if act != "relu" or norm["y"] not in card_vals:
            return plain_bwd(x2, scale, bias, mean, inv, dy2, act, res2,
                             mode, count)
        _, m, _ = mask(x2, scale, bias, mean, inv, res2, mode)
        return KB.bn_apply_act_backward_plain(
            x2, scale, bias, mean, inv, torch.where(m, dy2, 0.0), "identity",
            res2, mode, count)

    wraps = {"relu": forced(relu), "hard_swish": forced(hard_swish),
             "hard_sigmoid": forced(hard_sigmoid),
             "leaky_relu": forced(leaky_relu)}
    for t in ("batch_norm", "conv2d_bn"):
        wraps[t], wraps[t + "_grad"] = named(False), named(True)
    saved = {t: registry.get_op_def(t).compute for t in wraps}
    for t, w in wraps.items():
        registry.get_op_def(t).compute = w(saved[t])
    nn_ops.bn_apply_act, nn_ops.bn_apply_act_backward = bn_fwd, bn_bwd
    try:
        yield
    finally:
        for t, c in saved.items():
            registry.get_op_def(t).compute = c
        nn_ops.bn_apply_act, nn_ops.bn_apply_act_backward = plain_fwd, plain_bwd


def _kink_vars(main):
    """{var a `_card_kinks` key names: var whose card value decides}: each
    relu / hard_swish / hard_sigmoid / leaky_relu op's output -> its input, each norm op
    with a folded relu's output -> itself."""
    out = {}
    for op in main.global_block.ops:
        if op.type in ("relu", "hard_swish", "hard_sigmoid", "leaky_relu"):
            out[op.outputs["Out"][0]] = op.inputs["X"][0]
        elif op.type in ("batch_norm", "conv2d_bn") and op.attr("act", "") == "relu":
            out[op.outputs["Y"][0]] = op.outputs["Y"][0]
    return out


def _copy_to_card(dev, cscope, gscope, names):
    """The CPU run's startup values of `names` into the card's scope."""
    for n in names:
        gscope.find_var(n).copy_(cscope.find_var(n).to(dev))


def _hold_grads(what, names, got, want):
    """Step 1's parameter gradients on the card against the CPU's: each
    within MBV3_GRAD_RTOL of its max-abs (or MBV3_GRAD_FLOOR of the
    largest). Returns (the worst error in units of its limit, how many
    were held to the floor)."""
    top = max(float(w.abs().max()) for w in want)
    worst, floored = 0.0, 0
    for n, g, w in zip(names, got, want):
        e = float((g.cpu() - w).abs().max())
        m = float(w.abs().max())
        lim = max(MBV3_GRAD_RTOL * m, MBV3_GRAD_FLOOR * top)
        if not e <= lim:
            raise RuntimeError(
                f"{what}: {n}@GRAD {e:.3e} from the CPU's, beyond "
                f"{MBV3_GRAD_RTOL} of its max-abs {m:.3e} (and "
                f"{MBV3_GRAD_FLOOR} of the largest, {top:.3e})")
        floored += MBV3_GRAD_RTOL * m < MBV3_GRAD_FLOOR * top
        worst = max(worst, e / lim)
    return worst, floored


def _hold_loss(what, got, want):
    """Step 1's loss on the card within 1e-4 relative of the CPU's."""
    g, w = float(got), float(want)
    if not abs(g - w) <= 1e-4 * abs(w):
        raise RuntimeError(f"{what}: loss {g} on the card, {w} on the CPU")
    return g, w


def _hold_stats(what, stats, gscope, cscope):
    """The running statistics after step 1, each within 1e-4 of its max-abs
    or MBV3_GRAD_FLOOR of the largest one's (a running mean whose batch
    mean is zero by construction: a 1x1 conv of a batch norm's output).
    Returns the worst error in units of its limit."""
    top = max(float(cscope.find_var(n).abs().max()) for n in stats)
    st = 0.0
    for n in stats:
        w = cscope.find_var(n)
        e = float((gscope.find_var(n).cpu() - w).abs().max())
        lim = max(1e-4 * float(w.abs().max()), MBV3_GRAD_FLOOR * top)
        if not e <= lim:
            raise RuntimeError(f"{what}: running statistic {n} {e:.3e} from "
                               f"the CPU's (limit {lim:.3e})")
        st = max(st, e / lim)
    return st


def train_mobilenet_v3(dev, card, k8_predicted=None):
    """MobileNetV3-Large x1.0 at 224 x 224, 1000 classes, fp32 NCHW, under
    Momentum(0.9). Step 1 at B = MBV3_HOLD_B against the port's CPU run of
    the same program and weights: the loss within 1e-4 relative, each
    parameter gradient within 1e-3 of its max-abs, the running statistics
    within 1e-4 relative L2; K8 and K9 launched once a batch_norm op, K6
    and K7 once. Then at B = MBV3_B and lr MBV3_LR on one seeded batch the
    loss falls over MBV3_STEPS steps; images/s, step ms and peak device
    memory, and from one profiled step (on the card) the device busy share,
    the largest device ops and K8's device time in the step, beside
    `k8_predicted` (check_bn_mobilenet's launch- and byte-weighted ms)
    where given. Returns the launches of the held step and of the timed
    steps."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda_kernels as ck

    main, startup, loss = _mbv3_program(pt)
    names = [p.name for p in main.all_parameters()]
    stats = _bn_stats(main)
    n_bn = len(stats) // 2
    rng = np.random.default_rng(SEED + 30)
    shape = (3, MBV3_HW, MBV3_HW)
    feed = {"img": rng.standard_normal((MBV3_HOLD_B,) + shape).astype(np.float32),
            "label": rng.integers(0, MBV3_CLASSES, (MBV3_HOLD_B, 1))
            .astype(np.int32)}
    gpu, cpu = pt.Executor(place=dev), pt.Executor(place="cpu")
    gscope, cscope = pt.Scope(), pt.Scope()
    cpu.run(startup, scope=cscope)
    gpu.run(startup, scope=gscope)
    _copy_to_card(dev, cscope, gscope, names + stats)
    fetch = [loss.name] + [n + "@GRAD" for n in names]
    kinks = _kink_vars(main)
    deciding = sorted(set(kinks.values()))
    ck.reset_launch_counts()
    got = gpu.run(main, feed=_on(dev, feed), fetch_list=fetch + deciding,
                  scope=gscope, return_numpy=False)
    _sync(dev)
    counts = _lt_launches(dev, main, "MobileNetV3 step 1")
    card_at = dict(zip(deciding, (t.cpu() for t in got[len(fetch):])))
    got = got[:len(fetch)]
    if dev.type == "cuda" and (
            counts.get("bn_apply_act", {}).get("float32") != n_bn
            or counts.get("bn_apply_act_backward", {}).get("float32") != n_bn):
        raise RuntimeError(f"MobileNetV3: {n_bn} batch norms, launches {counts}")
    taken = [0]
    with _card_kinks(main, {o: card_at[i] for o, i in kinks.items()},
                     MBV3_KINK_NEAR, taken):
        want = cpu.run(main, feed=feed, fetch_list=fetch, scope=cscope,
                       return_numpy=False)
    l1, lc = _hold_loss("MobileNetV3 step 1", got[0], want[0])
    worst, floored = _hold_grads("MobileNetV3 step 1", names, got[1:], want[1:])
    st = _hold_stats("MobileNetV3 step 1", stats, gscope, cscope)
    print(f"MobileNetV3-Large x1.0 step 1 at B={MBV3_HOLD_B}, 224x224: loss "
          f"{l1:.6f} (CPU {lc:.6f}); worst gradient at {worst:.3f} of its "
          f"limit over {len(names)} parameters ({floored} held to the floor); "
          f"{taken[0]} elements within {MBV3_KINK_NEAR} of a kink took the "
          f"card's side in the CPU run ({len(kinks)} kink ops); running "
          f"statistics at {st:.3f} of their limit; "
          f"{n_bn} batch norms, launches {counts}; {len(main.global_block.ops)} "
          f"ops a step [{card}]")
    del got, want, card_at, gscope, cscope
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    scope = pt.Scope()
    gpu.run(startup, scope=scope)
    feed = _on(dev, {"img": rng.standard_normal((MBV3_B,) + shape)
                     .astype(np.float32),
                     "label": rng.integers(0, MBV3_CLASSES, (MBV3_B, 1))
                     .astype(np.int32)})

    def step():
        return gpu.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)[0]

    ck.reset_launch_counts()
    losses = [step()]
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(MBV3_STEPS):
        losses.append(step())
    _sync(dev)
    wall = (time.perf_counter() - t0) / MBV3_STEPS
    run_counts = {k: v for k, v in ck.launch_counts_by_dtype().items() if v}
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"MobileNetV3 at B={MBV3_B}: the loss did not fall: "
                           f"{losses}")
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if dev.type == "cuda" else float("nan"))
    print(f"MobileNetV3-Large x1.0 at B={MBV3_B}, lr {MBV3_LR}: {MBV3_B / wall:.1f} "
          f"images/s, {1e3 * wall:.2f} ms a step (mean of {MBV3_STEPS}), peak "
          f"device memory {peak:.2f} GiB; losses {[round(v, 5) for v in losses]}"
          f" [{card}]")
    if dev.type == "cuda":
        totals = {}
        _profile(step, card, f"MobileNetV3-Large training step (B={MBV3_B})",
                 ("K8", ("bn_apply_fwd",)), totals=totals)
        told = ("" if k8_predicted is None else
                f", against {k8_predicted[0]:.4f} ms launch-weighted and "
                f"{k8_predicted[1]:.4f} ms byte-weighted from BN_MBV3's rows")
        k8 = ("not measured (no device time in the trace)" if "K8" not in
              totals else f"{totals['K8'][0]:.4f} ms in {totals['K8'][1]} "
              f"launches")
        print(f"K8 in the traced MobileNetV3-Large step: {k8}{told} [{card}]")
    return counts, run_counts


# the book's test_recommender_system.py at B = 256 under SGD(0.2)
REC_B, REC_LR, REC_PASSES = 256, 0.2, 2


def recommender(pt, n_users, n_jobs, n_movies, n_cats, n_words):
    """The Fluid book's recommender: the user tower (id 32, gender 16, age
    16 and job 16 embeddings, each through its fc, into a 200-wide tanh
    fc), the movie tower (id 32 through its fc; the categories' 32-wide
    embeddings pooled by sum; the title's embeddings through a width-3
    sequence_conv of 32 tanh filters pooled by sum; into a 200-wide tanh
    fc), their cos_sim scaled by 5 against the rating by
    square_error_cost. The ragged categories and titles come as padded
    [B, T] ids with their lengths. Returns (mean cost, feed vars)."""
    L = pt.layers

    def emb_fc(name, size, width, fc):
        v = L.data(name=name, shape=[1], dtype="int64")
        e = L.embedding(v, size=[size, width], is_sparse=False)
        return v, L.fc(e, fc)

    uid, u_fc = emb_fc("user_id", n_users + 1, 32, 32)
    gid, g_fc = emb_fc("gender_id", 2, 16, 16)
    aid, a_fc = emb_fc("age_id", 7, 16, 16)
    jid, j_fc = emb_fc("job_id", n_jobs + 1, 16, 16)
    usr = L.fc(L.concat([u_fc, g_fc, a_fc, j_fc], axis=1), 200, act="tanh")
    mid, m_fc = emb_fc("movie_id", n_movies + 1, 32, 32)
    cat = L.data(name="category_id", shape=[-1], dtype="int64")
    cat_len = L.data(name="category_id_len", shape=[], dtype="int32")
    cats = L.sequence_pool(L.embedding(cat, size=[n_cats, 32]), "sum",
                           length=cat_len)
    title = L.data(name="movie_title", shape=[-1], dtype="int64")
    title_len = L.data(name="movie_title_len", shape=[], dtype="int32")
    conv = L.sequence_conv(L.embedding(title, size=[n_words, 32]), 32, 3,
                           act="tanh", length=title_len)
    titles = L.sequence_pool(conv, "sum", length=title_len)
    mov = L.fc(L.concat([m_fc, cats, titles], axis=1), 200, act="tanh")
    score = L.data(name="score", shape=[1], dtype="float32")
    cost = L.square_error_cost(L.scale(L.cos_sim(usr, mov), scale=5.0), score)
    return L.mean(cost), [uid, gid, aid, jid, mid, cat, title, score]


def _rec_feeder(pt, feeds):
    """DataFeeder over the recommender's feed vars, with the lengths of the
    ragged categories and titles (fields 5 and 6 of a sample) fed too."""
    feeder = pt.DataFeeder(feeds)

    def feed(batch):
        out = feeder.feed(batch)
        for i, name in ((5, "category_id_len"), (6, "movie_title_len")):
            out[name] = np.asarray([len(s[i]) for s in batch], np.int32)
        return out
    return feed


def _rec_program(pt, movielens, lr=REC_LR):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, feeds = recommender(
            pt, movielens.max_user_id(), movielens.max_job_id(),
            movielens.max_movie_id(), len(movielens.movie_categories()),
            len(movielens.get_movie_title_dict()))
        test = main.clone(for_test=True)
        pt.optimizer.SGD(lr).minimize(loss)
    startup.random_seed = main.random_seed = SEED
    return main, startup, test, loss, feeds


def book_recommender(dev, card):
    """The book recommender on dataset.movielens through pt.batch and
    DataFeeder (lengths emitted for the ragged slots): step 1 against the
    port's CPU run of the same program and weights (loss within 1e-5
    relative, gradients within 1e-4 of their max-abs); REC_PASSES passes
    over the train reader, the train loss falling; the test loss after
    them below the one before. Samples/s with the reader and DataFeeder
    and without. Returns the launches (none: no kernel-backed op)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.dataset import movielens
    from paddle_tpu_torch.ops import cuda_kernels as ck

    main, startup, test, loss, feeds = _rec_program(pt, movielens)
    feeder = _rec_feeder(pt, feeds)
    names = [p.name for p in main.all_parameters()]
    gpu, cpu = pt.Executor(place=dev), pt.Executor(place="cpu")
    scope, cscope = pt.Scope(), pt.Scope()
    cpu.run(startup, scope=cscope)
    gpu.run(startup, scope=scope)
    for n in names:
        scope.find_var(n).copy_(cscope.find_var(n).to(dev))
    train = pt.batch(movielens.train(), REC_B, drop_last=True)
    tests = [feeder(b) for b in pt.batch(movielens.test(), REC_B,
                                         drop_last=True)()]

    def test_loss():
        return float(np.mean([float(gpu.run(test, feed=f, fetch_list=[loss],
                                            scope=scope, return_numpy=False)[0])
                              for f in tests]))

    first = feeder(next(train()))
    fetch = [loss.name] + [n + "@GRAD" for n in names]
    before = test_loss()
    ck.reset_launch_counts()
    got = gpu.run(main, feed=first, fetch_list=fetch, scope=scope,
                  return_numpy=False)
    _sync(dev)
    counts = _lt_launches(dev, main, "recommender")
    want = cpu.run(main, feed=first, fetch_list=fetch, scope=cscope,
                   return_numpy=False)
    if not abs(float(got[0]) - float(want[0])) <= 1e-5 * abs(float(want[0])):
        raise RuntimeError(f"recommender step 1: loss {float(got[0])} on the "
                           f"card, {float(want[0])} on the CPU")
    worst = 0.0
    for n, g, w in zip(names, got[1:], want[1:]):
        e = float((g.cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        if not e <= 1e-4:
            raise RuntimeError(f"recommender step 1: {n}@GRAD {e:.3e} of its "
                               f"max-abs from the CPU's")
        worst = max(worst, e)
    losses, host, steps = [], 0.0, 0
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(REC_PASSES):
        pass_losses = []
        batches = train()
        while True:
            t = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            f = feeder(batch)
            host += time.perf_counter() - t
            pass_losses.append(gpu.run(main, feed=f, fetch_list=[loss],
                                       scope=scope, return_numpy=False)[0])
            steps += 1
        losses.append(float(torch.stack(pass_losses).mean()))
    _sync(dev)
    wall = time.perf_counter() - t0
    after = test_loss()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]
            and after < before):
        raise RuntimeError(f"recommender: train losses a pass {losses}, test "
                           f"loss {before} -> {after}")
    print(f"book recommender (movielens {'synthetic fallback: ' if movielens.is_synthetic() else ''}"
          f"{movielens.max_user_id()} users, {movielens.max_movie_id()} movies) "
          f"B={REC_B}, SGD({REC_LR}): step 1 loss {float(got[0]):.6f} (CPU "
          f"{float(want[0]):.6f}), worst gradient {worst:.2e} of its max-abs; "
          f"{REC_PASSES} passes of {steps // REC_PASSES} steps: mean train "
          f"loss a pass {[round(v, 5) for v in losses]}, test loss {before:.5f}"
          f" -> {after:.5f}; {steps * REC_B / wall:.1f} samples/s with the "
          f"reader and DataFeeder ({host:.3f} s of host time), "
          f"{steps * REC_B / (wall - host):.1f} without; launches {counts} "
          f"[{card}]")
    return counts


# MobileNetV3's batch norms in NCHW ("cr" rows of one (sample, channel)
# map) at B = MBV3_B: one row for each map size, at a channel count the
# network has there and with the act K8 runs there (a hard_swish is an op
# of its own after an identity K8)
BN_MBV3 = (("cr", MBV3_B * 16, 112 * 112, 16, "relu"),
           ("cr", MBV3_B * 72, 56 * 56, 72, "relu"),
           ("cr", MBV3_B * 120, 28 * 28, 120, "relu"),
           ("cr", MBV3_B * 672, 14 * 14, 672, "identity"),
           ("cr", MBV3_B * 960, 7 * 7, 960, "identity"))


def _mbv3_bn_maps(hw=MBV3_HW, scale=MBV3_SCALE, bnecks=MBV3_BNECKS):
    """{map side: the channels of each of mobilenet_v3's batch norms on
    maps of that side}: the stem's, three a bneck (the expansion at its
    input's side, the depthwise and the projection at its output's), the
    last 1x1 conv's."""
    side = (hw - 1) // 2 + 1                 # the stem: 3x3, stride 2
    maps = {side: [_divisible(16 * scale)]}
    for k, exp, c, _, _, s in bnecks:
        exp, c = _divisible(scale * exp), _divisible(scale * c)
        maps[side].append(exp)
        side = (side + 2 * ((k - 1) // 2) - k) // s + 1
        maps.setdefault(side, []).extend([exp, c])
    maps[side].append(_divisible(scale * bnecks[-1][1]))
    return maps


def _square_maps(maps):
    """{side: channels} as `_bn_cr_rows` takes it: {side * side: (the map's
    name, channels)}."""
    return {s * s: (f"{s}x{s}", c) for s, c in maps.items()}


def _bn_cr_rows(dev, timer, card, rows, maps, net, g):
    """K8 and K9 (chain mode) at the NCHW "cr" rows `rows` (mode, R, row,
    C, act) of `net`, held against their plain versions and timed beside
    F.batch_norm: in inference mode over the same statistics (K8's
    function at the identity rows, less the relu at the others: the
    library column), in training mode (its statistics included) at every
    row, and training F.batch_norm's autograd backward. `maps` {elements a
    map: (the map's name, the channels of each of the net's batch norms on
    such maps)} gives each row its launches a step.
    Returns K8's and K9's time of a step as the rows predict it (ms):
    launch-weighted (each map's launches at its row's time) and
    byte-weighted (the row's time scaled by the map's channels over the
    row's), K8's pair and K9's."""
    from paddle_tpu_torch.ops.cuda_kernels import bn_apply as KF
    from paddle_tpu_torch.ops.cuda_kernels import bn_apply_bwd as KB
    import torch.nn.functional as F

    k8 = [0.0, 0.0]
    k9 = [0.0, 0.0]
    for mode, R, row, C, act in rows:
        x = (1.5 * torch.randn((R, row), generator=g) + 0.3).to(dev)
        dy = torch.randn((R, row), generator=g).to(dev)
        scale = (1 + 0.2 * torch.randn((C,), generator=g)).to(dev)
        bias = (0.2 * torch.randn((C,), generator=g)).to(dev)
        mean = (0.3 + 0.1 * torch.randn((C,), generator=g)).to(dev)
        inv = torch.rsqrt(2.25 + torch.rand((C,), generator=g)).to(dev)
        p = (scale, bias, mean, inv)
        name, chans = maps[row]
        shape = f"{mode} [{R}, {row}] C={C} act={act} ({net} {name})"
        err = _agree(f"bn_apply_act {shape}", KF.bn_apply_act(x, *p, act, None, mode),
                     KF.bn_apply_act_plain(x, *p, act, None, mode))
        ms = timer(lambda: KF.bn_apply_act(x, *p, act, None, mode))
        plain_ms = timer(lambda: KF.bn_apply_act_plain(x, *p, act, None, mode))
        x4, dy4 = _bn_nchw(x, mode, R, row, C, None), _bn_nchw(dy, mode, R, row, C, None)
        infer = _bn_infer_lib(x4, mean, inv)
        lib_ms = timer(lambda: infer(x4, scale, bias))
        rm, rv = torch.zeros(C, device=dev), torch.ones(C, device=dev)
        lib = lambda x4, s, b: F.batch_norm(  # noqa: E731
            x4, rm.clone(), rv.clone(), s, b, training=True, eps=1e-5)
        train_ms = timer(lambda: lib(x4, scale, bias))
        bound, by = _bound(4 * R * row, (2 * R * row + 4 * C) * 4)
        k8[0] += len(chans) * ms
        k8[1] += ms * sum(chans) / C
        _row("K8 bn_apply_act", shape + f" ({100 * bound / ms:.1f}% of its "
             f"bound; {len(chans)} launches a step over {sum(chans)} "
             f"channels; training F.batch_norm, its statistics included: "
             f"{train_ms:.4f} ms; library: inference F.batch_norm"
             f"{'' if act == 'identity' else ', without the ' + act})", ms,
             plain_ms, lib_ms, bound, by, err, card)
        M = R * row // C
        got = KB.bn_apply_act_backward(x, *p, dy, act, None, mode, M)
        ref, n_split, n_fused = _k9_reference(
            f"bn_apply_act_backward chain {shape}", got, x, p, dy, act, None,
            mode, M)
        err = _agree(f"bn_apply_act_backward chain dx {shape}", got[0], ref[0])
        sum_err = max(_sums_agree(f"bn_apply_act_backward chain {n} {shape}",
                                  o, r)
                      for n, o, r in zip(("dscale", "dbias"), got[4:], ref[4:]))
        ms = timer(lambda: KB.bn_apply_act_backward(x, *p, dy, act, None, mode, M))
        plain_ms = timer(lambda: KB.bn_apply_act_backward_plain(
            x, *p, dy, act, None, mode, M))
        lib_bwd = timer(_autograd_lib(lib, (x4, scale, bias), dy4))
        lib_chain = timer(_bn_train_backward(x4, dy4, scale, mean, inv))
        bound, by = _k9_bound(x, R, row, C, 3, _bound)
        k9[0] += len(chans) * ms
        k9[1] += ms * sum(chans) / C
        _row("K9 bn_apply_act_backward", shape + f" chain mode ({100 * bound / ms:.1f}% "
             f"of its bound; {len(chans)} launches a step; "
             f"{'beats' if ms < lib_chain else 'loses to'} the library "
             f"{lib_chain:.4f} ms; sums within {sum_err:.1e}; {n_split} "
             f"relu decisions split by the fused multiply-add's rounding, "
             f"{n_fused} taken on its side; training "
             f"F.batch_norm forward + autograd backward: {lib_bwd:.4f} ms)",
             ms, plain_ms, lib_chain, bound, by, err, card)
        del x, dy, x4, dy4, got, ref
        torch.cuda.empty_cache()
    return k8, k9


def check_bn_mobilenet(dev, timer, card):
    """K8 and K9 (chain mode) at BN_MBV3 (`_bn_cr_rows`), then K8's time in
    a MobileNetV3-Large step as the rows predict it. Returns K8's
    launch- and byte-weighted ms."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 31)
    maps = _mbv3_bn_maps()
    k8, _ = _bn_cr_rows(dev, timer, card, BN_MBV3, _square_maps(maps),
                        "MobileNetV3", g)
    n = sum(len(c) for c in maps.values())
    print(f"K8 in a MobileNetV3-Large step (B={MBV3_B}) as BN_MBV3 predicts "
          f"it: {k8[0]:.4f} ms launch-weighted ({n} launches at their "
          f"map's row time), {k8[1]:.4f} ms byte-weighted [{card}]")
    return tuple(k8)


# YOLOv3 as PaddlePaddle/models PaddleCV/yolov3 (release 1.5) sets it:
# config.py (608 x 608, 80 classes, the anchors and masks, ignore_thresh
# 0.7, label smoothing, 50 gt boxes an image, Momentum 0.9 at lr 0.001 with
# L2 decay 5e-4; the predictor's valid_thresh 0.005, nms_thresh 0.45,
# nms_topk 400, nms_posk 100), models/darknet.py (DarkNet-53) and
# models/yolov3.py (the three detection blocks, the route convolutions and
# the 2x nearest upsamples)
YOLO_ANCHORS = (10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326)
YOLO_MASKS = ((6, 7, 8), (3, 4, 5), (0, 1, 2))
YOLO_STAGES = (1, 2, 8, 8, 4)           # DarkNet-53's residual blocks a stage
YOLO_HW, YOLO_WIDTH, YOLO_CLASSES, YOLO_GT = 608, 32, 80, 50
YOLO_LR, YOLO_MU, YOLO_DECAY, YOLO_IGNORE = 0.001, 0.9, 5e-4, 0.7
YOLO_CONF, YOLO_NMS, YOLO_NMS_TOP_K, YOLO_KEEP_TOP_K = 0.005, 0.45, 400, 100
YOLO_HOLD_B, YOLO_B, YOLO_STEPS, YOLO_BOXES = 2, 8, 5, 6
# step 1 on the card against the CPU, as MobileNetV3's (MBV3_GRAD_RTOL and
# its floor); a leaky_relu input within MBV3_KINK_NEAR of 0 takes the
# card's side in the CPU run, and so does yolov3_loss's ignore decision of
# a prediction whose best IoU is within YOLO_IOU_NEAR of ignore_thresh (a
# last-place difference in a sigmoid or an exp moves an IoU by ~1e-7)
YOLO_IOU_NEAR = 1e-5
# the predictor on the card against the CPU predictor: boxes and scores in
# relative L2
YOLO_SERVE_L2 = 1e-5


def yolov3(pt, img, width=YOLO_WIDTH, stages=YOLO_STAGES,
           classes=YOLO_CLASSES, masks=YOLO_MASKS):
    """YOLOv3 in NCHW from `pt`'s layers (either package's), as
    PaddleCV/yolov3's models: DarkNet-53 (a 3x3 conv of `width`, then a
    stride-2 3x3 conv doubling the channels before each stage of residual
    blocks, 1x1 to half then 3x3 back, `stages` of them), then three
    detection blocks from the deepest map up (1x1 / 3x3 twice, the 1x1
    route and the 3x3 tip, channel 16 x width halving a block), between
    them a 1x1 route conv halving again, a 2x resize_nearest (its
    align_corners=True default) and the concat with the next map, and an
    output 1x1 conv with a bias a block. Every conv but the outputs is
    conv2d(bias_attr=False) -> batch_norm -> leaky_relu(0.1), the weights
    and scales N(0, 0.02), the norms' parameters without weight decay.
    Returns the three outputs, deepest first."""
    L = pt.layers
    PA, Normal, Constant = pt.ParamAttr, pt.initializer.Normal, pt.initializer.Constant
    no_decay = pt.regularizer.L2Decay(0.0)

    def conv_bn(x, c, k, s, name):
        y = L.conv2d(x, c, k, stride=s, padding=(k - 1) // 2, bias_attr=False,
                     param_attr=PA(name=name + ".conv.weights",
                                   initializer=Normal(0.0, 0.02)))
        y = L.batch_norm(
            y, param_attr=PA(name=name + ".bn.scale", regularizer=no_decay,
                             initializer=Normal(0.0, 0.02)),
            bias_attr=PA(name=name + ".bn.offset", regularizer=no_decay,
                         initializer=Constant(0.0)),
            moving_mean_name=name + ".bn.mean",
            moving_variance_name=name + ".bn.var")
        return L.leaky_relu(y, alpha=0.1)

    x = conv_bn(img, width, 3, 1, "yolo_input")
    x = conv_bn(x, 2 * width, 3, 2, "yolo_input.downsample")
    blocks = []
    for i, n in enumerate(stages):
        c = width * 2 ** i
        for j in range(n):
            name = f"stage.{i}.{j}"
            h = conv_bn(x, c, 1, 1, name + ".0")
            x = L.elementwise_add(x, conv_bn(h, 2 * c, 3, 1, name + ".1"))
        blocks.append(x)
        if i < len(stages) - 1:
            x = conv_bn(x, 4 * c, 3, 2, f"stage.{i}.downsample")
    outs, route = [], None
    top = width * 2 ** (len(stages) - 1)
    for i, block in enumerate(blocks[::-1][:len(masks)]):
        if route is not None:
            block = L.concat([route, block], axis=1)
        c = top // 2 ** i
        name = f"yolo_block.{i}"
        for j in range(2):
            block = conv_bn(block, c, 1, 1, f"{name}.{j}.0")
            block = conv_bn(block, 2 * c, 3, 1, f"{name}.{j}.1")
        route = conv_bn(block, c, 1, 1, f"{name}.2")
        tip = conv_bn(route, 2 * c, 3, 1, f"{name}.tip")
        outs.append(L.conv2d(
            tip, len(masks[i]) * (5 + classes), 1,
            param_attr=PA(name=f"yolo_output.{i}.conv.weights",
                          initializer=Normal(0.0, 0.02)),
            bias_attr=PA(name=f"yolo_output.{i}.conv.bias", regularizer=no_decay,
                         initializer=Constant(0.0))))
        if i < len(masks) - 1:
            route = conv_bn(route, c // 2, 1, 1, f"yolo_transition.{i}")
            route = L.resize_nearest(route, scale=2)
    return outs


def _yolov3_program(pt, hw=None, width=None, stages=None, classes=None):
    """YOLOv3 (`yolov3`) at hw x hw (YOLO_HW, YOLO_WIDTH, YOLO_STAGES and
    YOLO_CLASSES where not given): the training program (a yolov3_loss a
    head on the gt feeds, the sum of their batch means, Momentum(YOLO_LR,
    YOLO_MU) with L2 decay YOLO_DECAY) and its eval clone, taken before
    the losses and minimize: a yolo_box a head (the head's masked anchors,
    YOLO_CONF), the boxes and the scores concatenated, the scores
    transposed to [N, C, M], then multiclass_nms (YOLO_NMS, YOLO_NMS_TOP_K,
    YOLO_KEEP_TOP_K, no background class). Returns (main, startup, test,
    loss, the losses' ops' ObjectnessMask names, nms)."""
    hw, width = hw or YOLO_HW, width or YOLO_WIDTH
    stages, classes = stages or YOLO_STAGES, classes or YOLO_CLASSES
    main, startup = pt.Program(), pt.Program()
    L = pt.layers
    with pt.program_guard(main, startup), pt.unique_name.guard():
        img = L.data(name="image", shape=[3, hw, hw], dtype="float32")
        outs = yolov3(pt, img, width, stages, classes)
        test = main.clone(for_test=True)
        with pt.program_guard(test, startup):
            im_shape = L.data(name="im_shape", shape=[2], dtype="int32")
            boxes, scores = [], []
            down = 32
            for out, mask in zip(outs, YOLO_MASKS):
                anchors = [a for m in mask for a in YOLO_ANCHORS[2 * m:2 * m + 2]]
                b, s = L.yolo_box(out, im_shape, anchors, classes, YOLO_CONF, down)
                boxes.append(b)
                scores.append(s)
                down //= 2
            nms = L.multiclass_nms(
                L.concat(boxes, axis=1),
                L.transpose(L.concat(scores, axis=1), perm=[0, 2, 1]),
                score_threshold=YOLO_CONF, nms_top_k=YOLO_NMS_TOP_K,
                keep_top_k=YOLO_KEEP_TOP_K, nms_threshold=YOLO_NMS,
                background_label=-1)
        gt_box = L.data(name="gt_box", shape=[YOLO_GT, 4], dtype="float32")
        gt_label = L.data(name="gt_label", shape=[YOLO_GT], dtype="int32")
        gt_score = L.data(name="gt_score", shape=[YOLO_GT], dtype="float32")
        losses, down = [], 32
        for out, mask in zip(outs, YOLO_MASKS):
            losses.append(L.reduce_mean(L.yolov3_loss(
                out, gt_box, gt_label, list(YOLO_ANCHORS), list(mask), classes,
                YOLO_IGNORE, down, gt_score=gt_score, use_label_smooth=True)))
            down //= 2
        loss = L.sum(losses)
        pt.optimizer.Momentum(
            YOLO_LR, YOLO_MU,
            regularization=pt.regularizer.L2Decay(YOLO_DECAY)).minimize(loss)
    startup.random_seed = main.random_seed = test.random_seed = SEED
    masks = [o.outputs["ObjectnessMask"][0] for o in main.global_block.ops
             if o.type == "yolov3_loss"]
    return main, startup, test, loss, masks, nms


def _yolo_feed(rng, B, hw=None, classes=None):
    """B images from N(0, 1) and 1..YOLO_BOXES gt boxes each (centres in
    [0.05, 0.95], sides in [0.02, 0.5] of the image, a random class, score
    1); the other rows of the YOLO_GT zero."""
    hw, classes = hw or YOLO_HW, classes or YOLO_CLASSES
    box = np.zeros((B, YOLO_GT, 4), np.float32)
    label = np.zeros((B, YOLO_GT), np.int32)
    score = np.zeros((B, YOLO_GT), np.float32)
    for b in range(B):
        n = int(rng.integers(1, YOLO_BOXES + 1))
        box[b, :n, :2] = rng.uniform(0.05, 0.95, (n, 2))
        box[b, :n, 2:] = rng.uniform(0.02, 0.5, (n, 2))
        label[b, :n] = rng.integers(0, classes, n)
        score[b, :n] = 1.0
    return {"image": rng.standard_normal((B, 3, hw, hw)).astype(np.float32),
            "gt_box": box, "gt_label": label, "gt_score": score}


@contextlib.contextmanager
def _card_ignore(card_masks, near, flips):
    """While the CPU runs the program, yolov3_loss's ignore decision of a
    prediction whose best IoU is within `near` of ignore_thresh takes the
    card's (its ObjectnessMask: -1 ignored; a positive cell's target is
    set either way), by the op's ObjectnessMask var; `flips` counts the
    elements that moved. The grad op's replay takes the same side."""
    from paddle_tpu_torch.ops import detection_ops as D
    from paddle_tpu_torch.ops import registry

    plain_ignore, opdef = D.yolo_ignore, registry.get_op_def("yolov3_loss")
    plain = opdef.compute
    current = {}

    def ignore(best_iou, thresh):
        own = plain_ignore(best_iou, thresh)
        card = current.get("mask")
        if card is None:
            return own
        card = card.reshape(own.shape)
        theirs = torch.where(card > 0, own, card < -0.5)
        took = torch.where((best_iou - thresh).abs() <= near, theirs, own)
        flips[0] += int((took != own).sum())
        return took

    def compute(ctx):
        outs = getattr(ctx.op, "forward_outputs", None) or ctx.op.outputs
        current["mask"] = card_masks.get(outs["ObjectnessMask"][0])
        try:
            return plain(ctx)
        finally:
            current["mask"] = None

    D.yolo_ignore, opdef.compute = ignore, compute
    try:
        yield
    finally:
        D.yolo_ignore, opdef.compute = plain_ignore, plain


def _yolo_launches(dev, main, n_bn, what, k9=True):
    """The launches of one run of `main`, which on the card must be K8
    n_bn times and, where `k9`, K9 as often, and nothing else."""
    counts = _lt_launches(dev, main, what)
    want = {"bn_apply_act": {"float32": n_bn}}
    if k9:
        want["bn_apply_act_backward"] = {"float32": n_bn}
    if dev.type == "cuda" and counts != want:
        raise RuntimeError(f"{what}: {n_bn} batch norms, launches {counts}, "
                           f"want {want}")
    return counts


def train_yolov3(dev, card, predicted=None):
    """YOLOv3 (`_yolov3_program`) at YOLO_HW, fp32 NCHW. Step 1 at B =
    YOLO_HOLD_B against the port's CPU run of the same program, weights
    and batch: the loss within 1e-4 relative, each parameter gradient
    within MBV3_GRAD_RTOL of its max-abs (or MBV3_GRAD_FLOOR of the
    largest), the running statistics within 1e-4 of their max-abs (the
    same floor), K8 and K9 launched once a batch norm (72); the CPU run
    puts leaky_relu inputs near 0 (MBV3_KINK_NEAR) and ignore decisions
    near ignore_thresh (YOLO_IOU_NEAR) on the card's side, counted. Then
    at B = YOLO_B on one seeded batch: a step with every op's compute
    under the sync debug mode "error", then YOLO_STEPS steps whose loss
    falls; images/s, peak memory, and one profiled step: the device busy
    share, K8's and K9's device time beside `predicted` (check_bn_yolov3's
    launch-weighted ms, K8's and K9's) where given. Returns the launches of
    the held step and of the timed steps."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda_kernels as ck

    main, startup, _, loss, mask_names, _ = _yolov3_program(pt)
    names = [p.name for p in main.all_parameters()]
    stats = _bn_stats(main)
    n_bn = len(stats) // 2
    rng = np.random.default_rng(SEED + 40)
    feed = _yolo_feed(rng, YOLO_HOLD_B)
    gpu, cpu = pt.Executor(place=dev), pt.Executor(place="cpu")
    gscope, cscope = pt.Scope(), pt.Scope()
    cpu.run(startup, scope=cscope)
    gpu.run(startup, scope=gscope)
    _copy_to_card(dev, cscope, gscope, names + stats)
    fetch = [loss.name] + [n + "@GRAD" for n in names]
    kinks = _kink_vars(main)
    deciding = sorted(set(kinks.values()))
    ck.reset_launch_counts()
    got = gpu.run(main, feed=_on(dev, feed), fetch_list=fetch + deciding + mask_names,
                  scope=gscope, return_numpy=False)
    _sync(dev)
    counts = _yolo_launches(dev, main, n_bn, "YOLOv3 step 1")
    card_at = dict(zip(deciding, (t.cpu() for t in got[len(fetch):len(fetch) + len(deciding)])))
    card_masks = dict(zip(mask_names, (t.cpu() for t in got[len(fetch) + len(deciding):])))
    got = got[:len(fetch)]
    taken, flips = [0], [0]
    with _card_kinks(main, {o: card_at[i] for o, i in kinks.items()},
                     MBV3_KINK_NEAR, taken), \
            _card_ignore(card_masks, YOLO_IOU_NEAR, flips):
        want = cpu.run(main, feed=feed, fetch_list=fetch, scope=cscope,
                       return_numpy=False)
    l1, lc = _hold_loss("YOLOv3 step 1", got[0], want[0])
    worst, floored = _hold_grads("YOLOv3 step 1", names, got[1:], want[1:])
    st = _hold_stats("YOLOv3 step 1", stats, gscope, cscope)
    print(f"YOLOv3 (DarkNet-53, {YOLO_HW}x{YOLO_HW}, {YOLO_CLASSES} classes) "
          f"step 1 at B={YOLO_HOLD_B}: loss {l1:.6f} (CPU {lc:.6f}); worst "
          f"gradient at {worst:.3f} of its limit over {len(names)} parameters "
          f"({floored} held to the floor); {taken[0]} leaky_relu inputs within "
          f"{MBV3_KINK_NEAR} of 0 and {flips[0]} ignore decisions within "
          f"{YOLO_IOU_NEAR} of ignore_thresh took the card's side in the CPU "
          f"run; running statistics at {st:.3f} of their limit; {n_bn} batch "
          f"norms, launches {counts}; {len(main.global_block.ops)} ops a step "
          f"[{card}]")
    del got, want, card_at, card_masks, gscope, cscope
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    scope = pt.Scope()
    gpu.run(startup, scope=scope)
    feed = _on(dev, _yolo_feed(rng, YOLO_B))

    def step():
        return gpu.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)[0]

    seen = {}
    undo = _sync_free({o.type for o in main.global_block.ops}, seen)
    ck.reset_launch_counts()
    try:
        losses = [step()]
        _sync(dev)
    finally:
        undo()
    run_counts = _yolo_launches(dev, main, n_bn, f"YOLOv3 at B={YOLO_B}")
    t0 = time.perf_counter()
    for _ in range(YOLO_STEPS):
        losses.append(step())
    _sync(dev)
    wall = (time.perf_counter() - t0) / YOLO_STEPS
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"YOLOv3 at B={YOLO_B}: the loss did not fall: "
                           f"{losses}")
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if dev.type == "cuda" else float("nan"))
    print(f"YOLOv3 at B={YOLO_B}, Momentum({YOLO_LR}, {YOLO_MU}), L2 decay "
          f"{YOLO_DECAY}: {YOLO_B / wall:.2f} images/s, {1e3 * wall:.1f} ms a "
          f"step (mean of {YOLO_STEPS}), peak device memory {peak:.2f} GiB; "
          f"the first step's {sum(seen.values())} op dispatches under the "
          f"sync debug mode 'error'; losses {[round(v, 4) for v in losses]} "
          f"[{card}]")
    if dev.type == "cuda":
        totals = {}
        _profile(step, card, f"YOLOv3 training step (B={YOLO_B}, {YOLO_HW}x"
                 f"{YOLO_HW})", ("K8", ("bn_apply_fwd",)),
                 ("K9", ("bn_apply_bwd",)), totals=totals)
        for k, i in (("K8", 0), ("K9", 1)):
            told = ("" if predicted is None else
                    f", against {predicted[i]:.4f} ms launch-weighted from "
                    f"BN_YOLO's rows")
            got_ms = ("not measured (no device time in the trace)" if k not in
                      totals else f"{totals[k][0]:.4f} ms in {totals[k][1]} "
                      f"launches")
            print(f"{k} in the traced YOLOv3 step: {got_ms}{told} [{card}]")
    return counts, run_counts


def serve_yolov3(dev, card):
    """YOLOv3's eval clone (`_yolov3_program`), saved by
    io.save_inference_model with its batch norms' running statistics
    written from one training-mode pass over the batch (the random start
    leaves them at 0 and 1, and 72 layers normalized by those collapse),
    served by create_paddle_predictor at B = YOLO_B on the card and on the
    CPU: the boxes and scores before the NMS within YOLO_SERVE_L2 relative
    L2; the card's NMS rows equal bit for bit the CPU multiclass_nms run on
    the card's own boxes and scores (copied to the host); a row with a
    label; K8 72 times (inference mode) and no other kernel. Images/s,
    peak memory and device busy. Returns the launches."""
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.inference import NativeConfig, create_paddle_predictor

    what = f"YOLOv3 predictor B={YOLO_B}"
    main, startup, test, loss, _, nms = _yolov3_program(pt)
    rng = np.random.default_rng(SEED + 41)
    feed = _yolo_feed(rng, YOLO_B)
    exe, scope = pt.Executor(place=dev), pt.Scope()
    exe.run(startup, scope=scope)
    _yolo_batch_stats(pt, dev, main, loss, scope, feed)
    n_bn = len(_bn_stats(main)) // 2
    ops = test.global_block.ops
    nms_op = next(o for o in ops if o.type == "multiclass_nms")
    inputs = [nms_op.inputs["BBoxes"][0], nms_op.inputs["Scores"][0]]
    im_shape = np.full((YOLO_B, 2), YOLO_HW, np.int32)
    img_feed = {"image": feed["image"], "im_shape": im_shape}
    with tempfile.TemporaryDirectory() as d:
        pt.io.save_inference_model(d, ["image", "im_shape"], [nms] + [
            test.global_block.var(n) for n in inputs], exe, main_program=test,
            scope=scope)
        pred = create_paddle_predictor(NativeConfig(model_dir=d, device=dev))
        cpred = create_paddle_predictor(NativeConfig(model_dir=d, device="cpu"))
    card_feed = _on(dev, img_feed)
    from paddle_tpu_torch.ops import cuda_kernels as ck

    ck.reset_launch_counts()
    _sync(dev)
    out = pred.run_dict(card_feed, return_numpy=False)
    _sync(dev)
    counts = _yolo_launches(dev, pred._program, n_bn, what, k9=False)
    ref = cpred.run_dict(img_feed, return_numpy=False)
    worst = 0.0
    for n, g, w in zip(("boxes", "scores"), out[1:], ref[1:]):
        e = _rel_l2(g.cpu(), w)
        if not e <= YOLO_SERVE_L2:
            raise RuntimeError(f"{what}: the {n} on the card are {e:.3e} "
                               f"relative L2 from the CPU predictor's (limit "
                               f"{YOLO_SERVE_L2})")
        worst = max(worst, e)
    rows = _nms_on_cpu(nms_op, out[1].cpu(), out[2].cpu())
    if not torch.equal(out[0].cpu(), rows):
        bad = int((out[0].cpu() != rows).any(dim=-1).sum())
        raise RuntimeError(f"{what}: {bad} NMS rows on the card differ from "
                           f"the CPU multiclass_nms on the card's boxes and "
                           f"scores")
    kept = out[0][..., 0] >= 0
    n_kept = int(kept.sum())
    if not n_kept:
        raise RuntimeError(f"{what}: no detection (every row's label is -1)")
    cpu_same = int((ref[0][..., 0] >= 0).sum())
    print(f"{what} ({YOLO_HW}x{YOLO_HW}, yolo_box conf {YOLO_CONF}, NMS "
          f"{YOLO_NMS} over the top {YOLO_NMS_TOP_K}, keep {YOLO_KEEP_TOP_K}): "
          f"{len(pred._program.global_block.ops)} ops saved; boxes and scores "
          f"{worst:.2e} relative L2 from the CPU predictor's; the NMS rows bit "
          f"for bit the CPU op's on the card's boxes and scores; {n_kept} "
          f"detections ({cpu_same} in the CPU predictor's rows); launches "
          f"{counts} [{card}]")
    del exe, scope, main, ref, cpred
    rate = (_serve_predictor(pred, card_feed, YOLO_B, card, what, "images")
            if dev.type == "cuda" else float("nan"))
    return counts, rate


def _yolo_batch_stats(pt, dev, main, loss, scope, feed):
    """Write each batch norm's running mean and variance in `scope` from
    one training-mode forward pass of `main` over `feed`: its forward ops
    (to the loss) with every norm's momentum 0, so the statistics written
    are the batch's, each layer normalized by them."""
    run = main.clone()
    ops = run.global_block.ops
    end = next(i for i, o in enumerate(ops)
               if loss.name in [n for ns in o.outputs.values() for n in ns])
    run.global_block.ops = ops[:end + 1]
    for o in run.global_block.ops:
        if o.type in ("batch_norm", "conv2d_bn"):
            o.attrs["momentum"] = 0.0
    pt.Executor(place=dev).run(run, feed=_on(dev, feed), fetch_list=[],
                               scope=scope, return_numpy=False)


def _nms_on_cpu(op, boxes, scores):
    """`op` (a multiclass_nms) run by the port on the CPU on these inputs."""
    from paddle_tpu_torch.ops.registry import ExecContext, get_op_def

    env = {op.inputs["BBoxes"][0]: boxes, op.inputs["Scores"][0]: scores}
    return get_op_def("multiclass_nms").compute(
        ExecContext(op, env, torch.device("cpu")))["Out"]


# YOLOv3's batch norms in NCHW ("cr" rows of one (sample, channel) map) at
# B = YOLO_B: one row a map size, at a channel count the network has there
# (each K8 runs identity: the leaky_relu is an op of its own)
BN_YOLO = (("cr", YOLO_B * 32, 608 * 608, 32, "identity"),
           ("cr", YOLO_B * 64, 304 * 304, 64, "identity"),
           ("cr", YOLO_B * 128, 152 * 152, 128, "identity"),
           ("cr", YOLO_B * 256, 76 * 76, 256, "identity"),
           ("cr", YOLO_B * 512, 38 * 38, 512, "identity"),
           ("cr", YOLO_B * 1024, 19 * 19, 1024, "identity"))


def _yolo_bn_maps(hw=YOLO_HW, width=YOLO_WIDTH, stages=YOLO_STAGES,
                  heads=len(YOLO_MASKS)):
    """{map side: the channels of each of yolov3's batch norms on maps of
    that side}: the stem's, the downsamples' (at their output's side), two
    a residual block, then six a detection block and the route conv after
    each block but the last."""
    side = hw
    maps = {side: [width]}
    side = (side - 1) // 2 + 1
    maps[side] = [2 * width]
    for i, n in enumerate(stages):
        c = width * 2 ** i
        maps[side] += [c, 2 * c] * n
        if i < len(stages) - 1:
            side = (side - 1) // 2 + 1
            maps[side] = [4 * c]
    top = width * 2 ** (len(stages) - 1)
    for i in range(heads):
        c = top // 2 ** i
        maps[side] += [c, 2 * c] * 3
        if i < heads - 1:
            maps[side].append(c // 2)
            side *= 2
    return maps


def check_bn_yolov3(dev, timer, card):
    """K8 and K9 (chain mode) at BN_YOLO (`_bn_cr_rows`), then their time in
    a YOLOv3 step as the rows predict it. Returns K8's and K9's
    launch-weighted ms."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 42)
    maps = _yolo_bn_maps()
    k8, k9 = _bn_cr_rows(dev, timer, card, BN_YOLO, _square_maps(maps),
                         "YOLOv3", g)
    n = sum(len(c) for c in maps.values())
    print(f"K8 and K9 in a YOLOv3 training step (B={YOLO_B}, {YOLO_HW}x"
          f"{YOLO_HW}) as BN_YOLO predicts them, {n} launches each: K8 "
          f"{k8[0]:.4f} ms launch-weighted, {k8[1]:.4f} ms byte-weighted; K9 "
          f"{k9[0]:.4f} ms launch-weighted, {k9[1]:.4f} ms byte-weighted "
          f"[{card}]")
    return k8[0], k9[0]


# the sizes `_vision_cases` names (its docstring gives their sources)
VI_DIMS = dict(bilinear=(8, 256, 33, 129), nearest=(8, 256, 19, 38),
               trilinear=(2, 64, 32, 64), pool3d=(4, 128, 16, 56),
               conv3d=(2, 128, 8, 28, 256), adaptive2d=(8, 2048, 33),
               pixel=(16, 256, 48, 2), shuffle=(128, 116, 28, 2),
               tsm=(64, 256, 56, 8), maxout=(128, 192, 32, 2),
               lrn=(128, 96, 55), affine=(2, 256, 200, 336),
               multiplex=(4, 4096, 768), crop=(1, 21, 568, 500),
               padlike=(8, 64, 128), unfold=(32, 64, 56), grid=(64, 3, 224),
               btp=(2048, 100, 4), shard=(8192, 85742, 8),
               im2seq=(64, 128, 6, 48), conv3dt=(2, 256, 16, 128),
               adaptive3d=(8, 2048, 4, 7), deform=(2, 512, 38, 50),
               ssd=(32, 21, 20), ssd_scale=1, roi_align=(2, 256, 200, 336, 512, 14),
               roi_pool=(2, 512, 38, 50, 128, 7), yolo=(8, 76, 80, 50),
               anchor=(1, 1024, 50, 84), density=(1, 128, 32, 1024),
               proposals=(1, 50, 84, 6000, 1000),
               psroi=(1, 21, 7, 38, 63, 300),
               sampling=(4096, 1000), random_crop=(64, 3, 256, 224))

# SSD300 (Liu et al. 2016; PaddleCV/ssd's 300 config): (map side, min size,
# max size, aspect ratios) a source map, 8732 priors in all
SSD300_MAPS = ((38, 30, 60, (2,)), (19, 60, 111, (2, 3)),
               (10, 111, 162, (2, 3)), (5, 162, 213, (2, 3)),
               (3, 213, 264, (2,)), (1, 264, 315, (2,)))


def _ssd300_priors(scale=1):
    """SSD300's priors [M, 4] (normalized corners, clipped), prior_box's
    rule on each source map; `scale` > 1 keeps every scale-th map row and
    column (a smaller set for rehearsals)."""
    out = []
    for side, mn, mx, ars in SSD300_MAPS:
        whs = [(mn, mn), (np.sqrt(mn * mx),) * 2]
        whs += [(mn * np.sqrt(a), mn / np.sqrt(a)) for a in ars]
        whs += [(mn / np.sqrt(a), mn * np.sqrt(a)) for a in ars]
        c = (np.arange(0, side, scale) + 0.5) * 300 / side
        cy, cx = np.meshgrid(c, c, indexing="ij")
        for w, h in whs:
            out.append(np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                                -1).reshape(-1, 4) / 300)
    return np.clip(np.concatenate(out), 0, 1).astype(np.float32)


def _np_iou(a, b):
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area = lambda t: (t[:, 2] - t[:, 0]) * (t[:, 3] - t[:, 1])  # noqa: E731
    return (inter / (area(a)[:, None] + area(b)[None, :] - inter)).astype(np.float32)


def _vision_cases():
    """(op, inputs, outputs, attrs, cotangent shapes, inputs that take no
    grad, the model whose size it is) of the 38 deterministic new ops:
    bilinear_interp on DeepLabV3+'s decoder (B=8, 256 channels, 33 -> 129,
    align_corners); nearest_interp as YOLOv3's first upsample; trilinear
    in 3D U-Net's decoder (2 x 64 x 32^3 -> 64^3); pool3d and conv3d at
    C3D's pool2 and conv3a; adaptive_pool2d as DeepLabV3's image pooling
    (B=8, 2048 x 33 x 33); pixel_shuffle in EDSR's x2 upsampler;
    shuffle_channel in ShuffleNetV2's stage 2; temporal_shift in TSM
    ResNet-50 ([64, 256, 56, 56], seg_num 8); maxout on Maxout's CIFAR-10
    convs; lrn after AlexNet's conv1; affine_channel as Detectron's frozen
    batch norm on res2; multiplex over four BERT-base row sets;
    crop as FCN-8s's final crop; pad_constant_like at a U-Net skip; unfold
    as a ResNet 3x3 conv's im2col at 56 x 56; grid_sampler and affine_grid
    in a spatial transformer on CUB (B=64, 224 x 224); the Neural Tensor
    Network's bilinear_tensor_product; shard_index over 8 shards of
    ArcFace's 85,742 MS1M classes; im2sequence in Fluid's OCR CTC model;
    conv3d_transpose in 3D U-Net; adaptive_pool3d as SlowFast's head; the
    deformable conv on Faster R-CNN DCNv2's res5 ([2, 512, 38, 50]);
    prior_box, box_coder, iou_similarity, multiclass_nms, bipartite_match
    and ssd_loss at SSD300's 8732 priors on VOC (B=32, 21 classes, 20 gts);
    roi_align at Mask R-CNN's 512 RoIs x 256 channels (14 x 14, FPN P2 of
    an 800 x 1344 batch of 2); roi_pool at Fast R-CNN's 128 RoIs on VGG16's
    conv5; yolo_box and yolov3_loss at YOLOv3's 76 x 76 head (B=8, 80
    classes, 50 gts); anchor_generator and generate_proposals at Faster
    R-CNN C4's RPN (50 x 84, 15 anchors, 6000 -> 1000); density_prior_box
    at FaceBoxes's 32 x 32 map of a 1024 image; psroi_pool at R-FCN's VOC
    head (300 RoIs, 7 x 7)."""
    rng = np.random.default_rng(SEED + 50)
    d = VI_DIMS

    def f(*shape, scale=1.0, shift=0.0):
        return (shift + scale * rng.standard_normal(shape)).astype(np.float32)

    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def boxes(n, lo, hi, min_wh):
        a, b = rng.uniform(lo, hi, (n, 2)), rng.uniform(lo, hi, (n, 2))
        p1, p2 = np.minimum(a, b), np.maximum(a, b) + min_wh
        return np.concatenate([p1, p2], 1).astype(np.float32)

    cases = []

    def add(model, op, ins, outs, attrs, cots=None, nograd=()):
        cases.append((op, ins, outs, attrs, cots or {}, nograd, model))

    B, C, h, H = d["bilinear"]
    add("DeepLabV3+ decoder", "bilinear_interp", {"X": {"x": f(B, C, h, h)}},
        {"Out": ["o"]}, {"out_h": H, "out_w": H, "align_corners": True},
        {"o": (B, C, H, H)})
    B, C, h, H = d["nearest"]
    add("YOLOv3 upsample", "nearest_interp", {"X": {"x": f(B, C, h, h)}},
        {"Out": ["o"]}, {"out_h": H, "out_w": H, "align_corners": True},
        {"o": (B, C, H, H)})
    B, C, h, H = d["trilinear"]
    add("3D U-Net decoder", "trilinear_interp", {"X": {"x": f(B, C, h, h, h)}},
        {"Out": ["o"]}, {"out_d": H, "out_h": H, "out_w": H,
                         "align_corners": True}, {"o": (B, C, H, H, H)})
    B, C, T, S = d["pool3d"]
    add("C3D pool2", "pool3d", {"X": {"x": f(B, C, T, S, S)}}, {"Out": ["o"]},
        {"ksize": [2, 2, 2], "strides": [2, 2, 2], "paddings": [0, 0, 0],
         "pooling_type": "max"}, {"o": (B, C, T // 2, S // 2, S // 2)})
    B, C, T, S, O = d["conv3d"]
    add("C3D conv3a", "conv3d", {"Input": {"x": f(B, C, T, S, S)},
                                 "Filter": {"w": f(O, C, 3, 3, 3, scale=0.03)}},
        {"Output": ["o"]}, {"strides": [1, 1, 1], "paddings": [1, 1, 1],
                            "dilations": [1, 1, 1], "groups": 1},
        {"o": (B, O, T, S, S)})
    B, C, S = d["adaptive2d"]
    add("DeepLabV3 image pooling", "adaptive_pool2d", {"X": {"x": f(B, C, S, S)}},
        {"Out": ["o"]}, {"pooled_size": [1, 1], "pooling_type": "avg"},
        {"o": (B, C, 1, 1)})
    B, C, S, r = d["pixel"]
    add("EDSR x2 upsampler", "pixel_shuffle", {"X": {"x": f(B, C, S, S)}},
        {"Out": ["o"]}, {"upscale_factor": r},
        {"o": (B, C // (r * r), S * r, S * r)})
    B, C, S, g = d["shuffle"]
    add("ShuffleNetV2 stage 2", "shuffle_channel", {"X": {"x": f(B, C, S, S)}},
        {"Out": ["o"]}, {"group": g}, {"o": (B, C, S, S)})
    B, C, S, T = d["tsm"]
    add("TSM ResNet-50", "temporal_shift", {"X": {"x": f(B, C, S, S)}},
        {"Out": ["o"]}, {"seg_num": T, "shift_ratio": 0.125}, {"o": (B, C, S, S)})
    B, C, S, g = d["maxout"]
    add("Maxout CIFAR-10", "maxout", {"X": {"x": f(B, C, S, S)}}, {"Out": ["o"]},
        {"groups": g}, {"o": (B, C // g, S, S)})
    B, C, S = d["lrn"]
    add("AlexNet conv1", "lrn", {"X": {"x": f(B, C, S, S, scale=4.0)}},
        {"Out": ["o"], "MidOut": ["m"]},
        {"n": 5, "k": 2.0, "alpha": 1e-4, "beta": 0.75}, {"o": (B, C, S, S)})
    B, C, Hh, Ww = d["affine"]
    add("Detectron frozen BN res2", "affine_channel",
        {"X": {"x": f(B, C, Hh, Ww)}, "Scale": {"s": u(0.5, 1.5, C)},
         "Bias": {"b": f(C, scale=0.1)}}, {"Out": ["o"]}, {},
        {"o": (B, C, Hh, Ww)})
    K, R, Hd = d["multiplex"]
    add("BERT-base rows", "multiplex",
        {"X": {f"x{i}": f(R, Hd) for i in range(K)},
         "Ids": {"i": rng.integers(0, K, (R, 1)).astype(np.int32)}},
        {"Out": ["o"]}, {}, {"o": (R, Hd)})
    B, C, S, T = d["crop"]
    off = (S - T) // 2
    add("FCN-8s crop", "crop", {"X": {"x": f(B, C, S, S)}}, {"Out": ["o"]},
        {"shape": [B, C, T, T], "offsets": [0, 0, off, off]}, {"o": (B, C, T, T)})
    B, C, S = d["padlike"]
    add("U-Net skip", "pad_constant_like",
        {"X": {"x": f(B, C, S + 1, S + 1)}, "Y": {"y": f(B, C, S, S)}},
        {"Out": ["o"]}, {"pad_value": 0.0}, {"o": (B, C, S + 1, S + 1)}, ("x",))
    B, C, S = d["unfold"]
    add("ResNet 3x3 im2col", "unfold", {"X": {"x": f(B, C, S, S)}}, {"Y": ["o"]},
        {"kernel_sizes": [3, 3], "strides": [1, 1], "paddings": [1, 1],
         "dilations": [1, 1]}, {"o": (B, C * 9, S * S)})
    B, C, S = d["grid"]
    add("STN on CUB", "grid_sampler",
        {"X": {"x": f(B, C, S, S)}, "Grid": {"g": u(-1.05, 1.05, B, S, S, 2)}},
        {"Output": ["o"]}, {}, {"o": (B, C, S, S)})
    add("STN on CUB", "affine_grid", {"Theta": {"t": f(B, 2, 3, scale=0.5)}},
        {"Output": ["o"]}, {"output_shape": [B, C, S, S]}, {"o": (B, S, S, 2)})
    N, D, K = d["btp"]
    add("Neural Tensor Network", "bilinear_tensor_product",
        {"X": {"x": f(N, D)}, "Y": {"y": f(N, D)},
         "Weight": {"w": f(K, D, D, scale=0.1)}, "Bias": {"b": f(1, K)}},
        {"Out": ["o"]}, {}, {"o": (N, K)})
    N, V, S = d["shard"]
    add("ArcFace MS1M shards", "shard_index",
        {"X": {"x": rng.integers(0, V, (N, 1)).astype(np.int32)}}, {"Out": ["o"]},
        {"index_num": V, "nshards": S, "shard_id": 3, "ignore_value": -1})
    B, C, Hh, Ww = d["im2seq"]
    add("OCR CTC", "im2sequence", {"X": {"x": f(B, C, Hh, Ww)}}, {"Out": ["o"]},
        {"kernels": [Hh, 1], "strides": [1, 1], "paddings": [0, 0, 0, 0]})
    B, C, S, O = d["conv3dt"]
    add("3D U-Net up-conv", "conv3d_transpose",
        {"Input": {"x": f(B, C, S, S, S)}, "Filter": {"w": f(C, O, 2, 2, 2, scale=0.05)}},
        {"Output": ["o"]}, {"strides": [2, 2, 2], "paddings": [0, 0, 0],
                            "dilations": [1, 1, 1]},
        {"o": (B, O, 2 * S, 2 * S, 2 * S)})
    B, C, T, S = d["adaptive3d"]
    add("SlowFast head", "adaptive_pool3d", {"X": {"x": f(B, C, T, S, S)}},
        {"Out": ["o"]}, {"pooled_size": [1, 1, 1], "pooling_type": "avg"},
        {"o": (B, C, 1, 1, 1)})
    B, C, Hh, Ww = d["deform"]
    add("DCNv2 res5", "deformable_conv",
        {"Input": {"x": f(B, C, Hh, Ww)}, "Offset": {"off": f(B, 18, Hh, Ww)},
         "Mask": {"m": u(0, 1, B, 9, Hh, Ww)},
         "Filter": {"w": f(C, C, 3, 3, scale=0.02)}},
        {"Output": ["o"]}, {"strides": [1, 1], "paddings": [1, 1],
                            "dilations": [1, 1], "groups": 1,
                            "deformable_groups": 1}, {"o": (B, C, Hh, Ww)})

    # -- detection ------------------------------------------------------------
    priors = _ssd300_priors(d["ssd_scale"])
    M = len(priors)
    B, NC, G = d["ssd"]
    pvar = np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32), (M, 1))
    add("SSD300 conv4_3", "prior_box",
        {"Input": {"f": np.zeros((B, 512, 38 // d["ssd_scale"], 38 // d["ssd_scale"]),
                                 np.float32)},
         "Image": {"i": np.zeros((B, 3, 300, 300), np.float32)}},
        {"Boxes": ["b"], "Variances": ["v"]},
        {"min_sizes": [30.0], "max_sizes": [60.0], "aspect_ratios": [2.0],
         "flip": True, "clip": True, "step_w": 8.0, "step_h": 8.0},
        nograd=("f", "i"))
    add("SSD300 decode", "box_coder",
        {"PriorBox": {"p": priors}, "PriorBoxVar": {"pv": pvar},
         "TargetBox": {"t": f(B, M, 4, scale=0.5)}}, {"OutputBox": ["o"]},
        {"code_type": "decode_center_size"}, nograd=("p", "pv", "t"))
    gts = boxes(B * G, 0.0, 0.8, 0.05)
    add("SSD300 matching", "iou_similarity", {"X": {"x": gts[:400]},
                                              "Y": {"y": priors}},
        {"Out": ["o"]}, {}, nograd=("x", "y"))
    logits = f(B, NC, M, scale=2.0)
    sm = np.exp(logits - logits.max(1, keepdims=True))
    sm = (sm / sm.sum(1, keepdims=True)).astype(np.float32)
    add("SSD300 VOC detection_output", "multiclass_nms",
        {"BBoxes": {"b": np.clip(np.tile(priors, (B, 1, 1)) + f(B, M, 4, scale=0.01),
                                 0, 1)},
         "Scores": {"s": sm}}, {"Out": ["o"]},
        {"score_threshold": 0.01, "nms_threshold": 0.45, "nms_top_k": 400,
         "keep_top_k": 200, "background_label": 0}, nograd=("b", "s"))
    dist = np.stack([_np_iou(gts[b * G:(b + 1) * G], priors) for b in range(B)])
    add("SSD300 matching", "bipartite_match", {"DistMat": {"d": dist}},
        {"ColToRowMatchIndices": ["i"], "ColToRowMatchDist": ["d_"]}, {},
        nograd=("d",))
    add("SSD300 VOC", "ssd_loss",
        {"Loc": {"l": f(B, M, 4, scale=0.5)}, "Conf": {"c": f(B, M, NC)},
         "GTBox": {"g": gts.reshape(B, G, 4)},
         "GTLabel": {"gl": rng.integers(1, NC, (B, G, 1)).astype(np.int32)},
         "GTCount": {"gc": rng.integers(1, G + 1, B).astype(np.int32)},
         "PriorBox": {"p": priors}, "PriorBoxVar": {"pv": pvar}},
        {"Loss": ["o"]}, {}, {"o": (B, 1)}, ("g", "p", "pv"))
    B, C, Hh, Ww, R, P = d["roi_align"]
    rois = boxes(R, 0.0, 4.0 * min(Hh, Ww) - 64, 16.0)
    add("Mask R-CNN mask head", "roi_align",
        {"X": {"x": f(B, C, Hh, Ww)}, "ROIs": {"r": rois},
         "RoisBatchId": {"b": np.repeat(np.arange(B), R // B).astype(np.int32)}},
        {"Out": ["o"]}, {"pooled_height": P, "pooled_width": P,
                         "spatial_scale": 0.25, "sampling_ratio": 2},
        {"o": (R, C, P, P)}, ("r",))
    B, C, Hh, Ww, R, P = d["roi_pool"]
    rois = boxes(R, 0.0, 16.0 * min(Hh, Ww) - 40, 24.0)
    add("Fast R-CNN VGG16", "roi_pool",
        {"X": {"x": f(B, C, Hh, Ww)}, "ROIs": {"r": rois},
         "RoisBatchId": {"b": np.repeat(np.arange(B), R // B).astype(np.int32)}},
        {"Out": ["o"]}, {"pooled_height": P, "pooled_width": P,
                         "spatial_scale": 1 / 16}, {"o": (R, C, P, P)}, ("r",))
    B, S, NC, G = d["yolo"]
    feed = _yolo_feed(rng, B, 8 * S, NC)
    add("YOLOv3 76x76 head", "yolo_box",
        {"X": {"x": f(B, 3 * (5 + NC), S, S)},
         "ImgSize": {"s": np.full((B, 2), 8 * S, np.int32)}},
        {"Boxes": ["b"], "Scores": ["s_"]},
        {"anchors": [10, 13, 16, 30, 33, 23], "class_num": NC,
         "conf_thresh": YOLO_CONF, "downsample_ratio": 8}, nograd=("x",))
    add("YOLOv3 76x76 head", "yolov3_loss",
        {"X": {"x": f(B, 3 * (5 + NC), S, S)}, "GTBox": {"g": feed["gt_box"]},
         "GTLabel": {"l": feed["gt_label"]}, "GTScore": {"gs": feed["gt_score"]}},
        {"Loss": ["o"], "ObjectnessMask": ["m"], "GTMatchMask": ["k"]},
        {"anchors": list(YOLO_ANCHORS), "anchor_mask": [0, 1, 2],
         "class_num": NC, "ignore_thresh": YOLO_IGNORE, "downsample_ratio": 8,
         "use_label_smooth": True}, {"o": (B,)}, ("g", "gs"))
    B, C, Hh, Ww = d["anchor"]
    add("Faster R-CNN C4 RPN", "anchor_generator",
        {"Input": {"f": np.zeros((B, C, Hh, Ww), np.float32)}},
        {"Anchors": ["a"], "Variances": ["v"]},
        {"anchor_sizes": [32.0, 64.0, 128.0, 256.0, 512.0],
         "aspect_ratios": [0.5, 1.0, 2.0], "stride": [16.0, 16.0]}, nograd=("f",))
    B, C, S, I = d["density"]
    add("FaceBoxes", "density_prior_box",
        {"Input": {"f": np.zeros((B, C, S, S), np.float32)},
         "Image": {"i": np.zeros((B, 3, I, I), np.float32)}},
        {"Boxes": ["b"], "Variances": ["v"]},
        {"densities": [4, 2, 1], "fixed_sizes": [32.0, 64.0, 128.0],
         "fixed_ratios": [1.0], "clip": True}, nograd=("f", "i"))
    B, Hh, Ww, pre, post = d["proposals"]
    A = 15
    base = []
    for r in (0.5, 1.0, 2.0):
        bw = round(np.sqrt(256 / r))
        bh = round(bw * r)
        for s in (32.0, 64.0, 128.0, 256.0, 512.0):
            w, h = s / 16 * bw, s / 16 * bh
            base.append((-0.5 * (w - 1), -0.5 * (h - 1), 0.5 * (w - 1), 0.5 * (h - 1)))
    cy, cx = np.meshgrid(16.0 * np.arange(Hh) + 7.5, 16.0 * np.arange(Ww) + 7.5,
                         indexing="ij")
    anchors = (np.stack([cx, cy, cx, cy], -1)[:, :, None]
               + np.asarray(base)[None, None]).astype(np.float32)
    add("Faster R-CNN C4 RPN", "generate_proposals",
        {"Scores": {"s": f(B, A, Hh, Ww)}, "BboxDeltas": {"dl": f(B, 4 * A, Hh, Ww, scale=0.3)},
         "ImInfo": {"n": np.tile(np.array([[16.0 * Hh, 16.0 * Ww, 1.0]], np.float32), (B, 1))},
         "Anchors": {"a": anchors},
         "Variances": {"v": np.ones_like(anchors)}},
        {"RpnRois": ["r"], "RpnRoiProbs": ["p"]},
        {"pre_nms_topN": pre, "post_nms_topN": post, "nms_thresh": 0.7,
         "min_size": 0.0}, nograd=("s", "dl", "n", "a", "v"))
    B, O, P, Hh, Ww, R = d["psroi"]
    rois = boxes(R, 0.0, 16.0 * min(Hh, Ww) - 40, 32.0)
    add("R-FCN VOC head", "psroi_pool",
        {"X": {"x": f(B, O * P * P, Hh, Ww)}, "ROIs": {"r": rois}},
        {"Out": ["o"]}, {"output_channels": O, "pooled_height": P,
                         "pooled_width": P, "spatial_scale": 1 / 16},
        {"o": (R, O, P, P)}, ("r",))
    return cases


def _vision_random(dev, card, rows):
    """sampling_id and random_crop on the card by their laws: sampling_id's
    category frequencies (VI_DIMS["sampling"] rows of one softmax) within
    LT_SIGMAS binomial sigmas of the probabilities, its output int32;
    random_crop (ImageNet's 224 crop of 256) each crop a window of its
    sample, the offsets' mean within LT_SIGMAS sigmas of uniform's."""
    import paddle_tpu_torch as pt

    rng = np.random.default_rng(SEED + 51)
    N, K = VI_DIMS["sampling"]
    z = rng.standard_normal(K)
    p = (np.exp(z) / np.exp(z).sum()).astype(np.float32)
    feed = {"p": np.tile(p, (N, 1))}
    main, fetch = _seq_program("sampling_id", {"X": {"p": feed["p"]}},
                               {"Out": ["o"]}, {}, {})
    main.random_seed = SEED
    got, _, _ = _lt_run(dev, main, fetch, feed)
    ids = got[0].cpu()
    if ids.dtype != torch.int32 or tuple(ids.shape) != (N,):
        raise RuntimeError(f"sampling_id: {ids.dtype} {tuple(ids.shape)}")
    for c in np.argsort(-p)[:4]:
        fr = float((ids == int(c)).double().mean())
        if not abs(fr - p[c]) <= LT_SIGMAS * (p[c] * (1 - p[c]) / N) ** 0.5:
            raise RuntimeError(f"sampling_id: category {c} drawn {fr:.5f} of "
                               f"the time, its probability {p[c]:.5f}")
    rows.append(f"sampling_id {_lt_ms(dev, main, fetch, feed):.3f} ms (a "
                f"policy's [{N}, {K}]; top categories at their probabilities)")

    B, C, S, T = VI_DIMS["random_crop"]
    x = rng.standard_normal((B, C, S, S)).astype(np.float32)
    main, fetch = _seq_program("random_crop", {"X": {"x": x}}, {"Out": ["o"]},
                               {"shape": [T, T]}, {})
    main.random_seed = SEED
    got, _, _ = _lt_run(dev, main, fetch, {"x": x})
    out = got[0].cpu().numpy()
    starts = []
    for b in range(B):
        hits = [(i, j) for i in range(S - T + 1) for j in range(S - T + 1)
                if out[b, 0, 0, 0] == x[b, 0, i, j] and out[b, 0, 0, 1] == x[b, 0, i, j + 1]]
        if not any(np.array_equal(out[b], x[b, :, i:i + T, j:j + T]) for i, j in hits):
            raise RuntimeError(f"random_crop: sample {b}'s crop is no window of it")
        starts.append(hits[0])
    st = np.asarray(starts, np.float64)
    n = S - T + 1
    sd = ((n * n - 1) / 12 / B) ** 0.5
    if not np.all(np.abs(st.mean(0) - (n - 1) / 2) <= LT_SIGMAS * sd):
        raise RuntimeError(f"random_crop: mean offsets {st.mean(0)} against "
                           f"{(n - 1) / 2} (sigma {sd:.3f})")
    rows.append(f"random_crop {_lt_ms(dev, main, fetch, {'x': x}):.3f} ms "
                f"(ImageNet's {T} of {S}, B={B}; each crop a window, offsets "
                f"uniform)")


def _op_sweep(dev, cases, rows, host=(), after=None):
    """Each case (op, inputs, outputs, attrs, cotangent shapes, inputs that
    take no grad, the model whose size it is) as a one-op program, forward
    and every grad on the card and again on the CPU (the port's own
    program, which the CPU tests hold against the JAX package): fp32, TF32
    off, each output and grad within LT_L2 relative L2, integers bit for
    bit; every op but the `host` ones under the sync debug mode "error".
    Appends each case's ms a run (forward and grads) to `rows`, and
    `after(case)`'s row where it gives one; returns the dispatches gated."""
    gated = 0
    for case in cases:
        op, ins, outs, attrs, cot_shapes, nograd, model = case
        main, fetch = _seq_program(op, ins, outs, attrs, cot_shapes, nograd)
        rng = np.random.default_rng(SEED + len(rows))
        feed = {n: a for dd in ins.values() for n, a in dd.items()}
        feed.update({n + "_cot": np.asarray(rng.standard_normal(s), np.float32)
                     for n, s in cot_shapes.items()})
        got, want, seen = _lt_run(dev, main, fetch, feed,
                                  sync_free=op not in host)
        gated += sum(seen.values())
        worst = _lt_hold(op, fetch, got, want)
        ms = _lt_ms(dev, main, fetch, feed)
        n_grads = len(fetch) - sum(len(v) for v in outs.values())
        rows.append(f"{op} ({model}) {ms:.3f} ms ({n_grads} grads, worst "
                    f"{worst:.2e})")
        extra = after(case) if after else None
        if extra:
            rows.append(extra)
        del got, want
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return gated


def vision_ops(dev, card):
    """Each of the 40 new vision and detection ops as a one-op program at
    the size a public model runs it (`_vision_cases`), held on the card
    against the CPU by `_op_sweep`, every op under the sync debug mode
    "error"; the random ops by their laws (`_vision_random`)."""
    rows = []
    gated = _op_sweep(dev, _vision_cases(), rows)
    _vision_random(dev, card, rows)
    print(f"vision and detection ops on the card against the CPU ({len(rows)} "
          f"cases; relative L2 <= {LT_L2}; {gated} op dispatches under the "
          f"sync debug mode 'error'; ms a run of forward and grads, the better "
          f"of two single runs): " + "; ".join(rows) + f" [{card}]")


# ---------------------------------------------------------------------------
# The crf and ctc ops, the evaluators and contrib/slim, driven by the book's
# semantic role labeller and CRNN-CTC text recognition (plain and under
# quantization-aware training).
# ---------------------------------------------------------------------------

# label_semantic_roles (the Paddle book, chapter 07, train.py): db_lstm at
# word_dim 32, mark_dim 5, hidden_dim 512, depth 8 (H = 128), the crf
# transition `crfw` at learning rate 1e-3, SGD at exponential_decay(0.01,
# 100000, 0.5, staircase), batch 10; conll05's synthetic reader (4,000
# words, 300 verbs, 59 labels) and get_embedding() table (no CoNLL-05 in
# the repo)
SRL_WORD_DIM, SRL_MARK_DIM, SRL_HIDDEN, SRL_DEPTH = 32, 5, 512, 8
# SRL_STEPS: 10 timed steps since a depth cut (20 before)
SRL_MIX_LR, SRL_B, SRL_STEPS, SRL_EVAL_BATCHES = 1e-3, 10, 10, 8
SRL_WORDS = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2")


def _srl_program(pt, depth=None, hidden=None):
    """The book's db_lstm through `pt` (either package) on the padded
    contract: the verb's and the mark's embeddings, then six word
    embeddings (the word and its five predicate-context windows) sharing
    the non-trainable table `emb`; an fc (tanh) on each, summed; depth
    dynamic_lstm layers (candidate relu, gate and cell sigmoid, each after
    the first reversed at an odd index) over the sum of two fcs (tanh) of
    the previous pair; the feature output (59 labels) into linear_chain_crf
    with the lengths, then mean. The decode clone is taken before
    minimize, its crf_decoding on the same `crfw` and a ChunkEvaluator
    (IOB, ceil(58 / 2) = 29 chunk types). The book's embeddings are
    sparse; these are dense. Returns (main, startup, test, loss, decode,
    the evaluator)."""
    depth, hidden = depth or SRL_DEPTH, hidden or SRL_HIDDEN
    word_dict, verb_dict, label_dict = pt.dataset.conll05.get_dict()
    n_labels = len(label_dict)
    main, startup = pt.Program(), pt.Program()
    L, PA = pt.layers, pt.ParamAttr
    with pt.program_guard(main, startup), pt.unique_name.guard():
        ins = {n: L.data(name=n, shape=[-1], dtype="int64")
               for n in (*SRL_WORDS, "verb", "mark", "target")}
        length = L.data(name="length", shape=[], dtype="int64")
        embs = [L.embedding(ins["verb"], [len(verb_dict), SRL_WORD_DIM],
                            param_attr="vemb"),
                L.embedding(ins["mark"], [2, SRL_MARK_DIM])]
        embs = [L.embedding(ins[n], [len(word_dict), SRL_WORD_DIM],
                            param_attr=PA(name="emb", trainable=False))
                for n in SRL_WORDS] + embs
        prev = L.sums([L.fc(e, hidden, num_flatten_dims=2, act="tanh")
                       for e in embs])
        pair = [prev, None]
        for i in range(depth):
            if i:
                prev = L.sums([L.fc(v, hidden, num_flatten_dims=2, act="tanh")
                               for v in pair])
            lstm, _ = L.dynamic_lstm(prev, hidden, candidate_activation="relu",
                                     gate_activation="sigmoid",
                                     cell_activation="sigmoid",
                                     is_reverse=i % 2 == 1)
            pair = [prev, lstm]
        feature = L.sums([L.fc(v, n_labels, num_flatten_dims=2, act="tanh")
                          for v in pair])
        cost = L.linear_chain_crf(feature, ins["target"], length=length,
                                  param_attr=PA(name="crfw",
                                                learning_rate=SRL_MIX_LR))
        loss = L.mean(cost)
        test = main.clone(for_test=True)
        with pt.program_guard(test, startup):
            decode = L.crf_decoding(feature, PA(name="crfw"), length=length)
            evaluator = pt.evaluator.ChunkEvaluator(
                decode, ins["target"], "IOB", math.ceil((n_labels - 1) / 2))
        pt.optimizer.SGD(learning_rate=L.exponential_decay(
            0.01, 100000, 0.5, staircase=True)).minimize(loss)
    startup.random_seed = main.random_seed = test.random_seed = SEED
    return main, startup, test, loss, decode, evaluator


def _srl_batches(pt, n, B=None):
    """`n` batches of B (SRL_B) conll05.test() sentences in order, each
    padded to its longest sentence (the reader draws 5-39 words): the
    eight id inputs and the target [B, T] int64 (ids padded with 0, the
    target with the last label, outside every IOB chunk), length [B]."""
    B = B or SRL_B
    samples = list(itertools.islice(pt.dataset.conll05.test()(), n * B))
    n_labels = len(pt.dataset.conll05.get_dict()[2])
    out = []
    for i in range(n):
        rows = samples[i * B:(i + 1) * B]
        lens = np.array([len(r[0]) for r in rows], np.int64)
        feed = {"length": lens}
        for k, name in enumerate((*SRL_WORDS, "verb", "mark", "target")):
            pad = n_labels - 1 if name == "target" else 0
            a = np.full((B, lens.max()), pad, np.int64)
            for b, r in enumerate(rows):
                a[b, :lens[b]] = r[k]
            feed[name] = a
        out.append(feed)
    return out


# CRNN-CTC as PaddlePaddle/models release 1.5 sets it
# (PaddleCV/ocr_recognition/crnn_ctc_model.py and its train.py): input
# [1, 48, 512], ocr_convs of four groups of two 3x3 conv + batch_norm(relu)
# at 16, 32, 64 and 128 channels, a 2x2 max pool after each of the first
# three; im2sequence over the map's height (T = 64, D = 768); two fc of 600,
# a forward and a reverse dynamic_gru(200, candidate relu), an fc of the
# pair to 95 classes + the blank; warpctc(blank=95, norm_by_times) and
# reduce_sum; Momentum 1e-3 / 0.9 with L2Decay 4e-4 on every parameter;
# batch 32; seeded images and labels of 4-16 ids (no OCR data in the repo)
CRNN_SHAPE, CRNN_CHANNELS, CRNN_HIDDEN, CRNN_CLASSES = (1, 48, 512), (16, 32, 64, 128), 200, 95
CRNN_LR, CRNN_MU, CRNN_L2 = 1e-3, 0.9, 4e-4
CRNN_B, CRNN_STEPS, CRNN_LABEL, CRNN_EVAL, CRNN_QAT_STEPS = 32, 10, (4, 16), 4, 3


def _crnn_ctc_program(pt, shape=None, channels=None, hidden=None,
                      qat=False):
    """CRNN-CTC (CRNN_* where not given) through `pt` (either package):
    every conv's weight N(0, 0.01) (the first N(0, 0.0005)) with a zero
    bias, every norm's scale N(0, 0.01) and offset 0, the fcs' and grus'
    weights N(0, 0.02), the grus' biases at learning rate 2.0; the greedy
    decode (ctc_greedy_decoder) and the EditDistance evaluator on the int64
    label, both on the padded sequences. With `qat`, contrib.slim's
    QuantizationTransformPass rewrites it before the eval clone and
    minimize. The model's pools are ceil_mode; neither package's pool2d
    has ceil_mode, and at 48 x 512 (and at every shape whose sides
    divide by 2 at each pool) each pool divides evenly, so floor and ceil
    agree. Returns (main, startup, test, loss, logits, the evaluator)."""
    shape, channels = shape or CRNN_SHAPE, channels or CRNN_CHANNELS
    hidden, classes = hidden or CRNN_HIDDEN, CRNN_CLASSES
    main, startup = pt.Program(), pt.Program()
    L, Normal = pt.layers, pt.initializer.Normal
    reg = pt.regularizer.L2Decay(CRNN_L2)

    def attr(std, lr=1.0):
        return pt.ParamAttr(regularizer=reg, initializer=Normal(0.0, std),
                            learning_rate=lr)

    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = L.data(name="pixel", shape=list(shape), dtype="float32")
        label = L.data(name="label", shape=[CRNN_LABEL[1]], dtype="int32")
        label_len = L.data(name="label_length", shape=[], dtype="int32")
        for g, c in enumerate(channels):
            for i in range(2):
                x = L.conv2d(x, c, 3, padding=1,
                             param_attr=attr(0.0005 if g == i == 0 else 0.01))
                x = L.batch_norm(x, act="relu", param_attr=attr(0.01),
                                 bias_attr=attr(0.0))
            if g < len(channels) - 1:
                x = L.pool2d(x, pool_size=2, pool_type="max", pool_stride=2)
        # im2sequence's [H, 1] window, [B, W, C * H]: the op has no grad in
        # either package (grad="none"), so the same values as a transpose
        # and a reshape, through which the conv tower trains
        _, c, h, w = x.shape
        seq = L.reshape(L.transpose(x, perm=[0, 3, 1, 2]), [-1, w, c * h])
        grus = [L.dynamic_gru(
            L.fc(seq, 3 * hidden, num_flatten_dims=2, param_attr=attr(0.02),
                 bias_attr=attr(0.02)),
            hidden, param_attr=attr(0.02), bias_attr=attr(0.02, 2.0),
            candidate_activation="relu", is_reverse=reverse)
            for reverse in (False, True)]
        # the fc of the pair as two products summed: one fc of both with
        # one ParamAttr would share its weight between them (in both
        # packages the layer names the attr at the first input)
        logits = L.sums([L.fc(g, classes + 1, num_flatten_dims=2,
                              param_attr=attr(0.02),
                              bias_attr=False if i else attr(0.0))
                         for i, g in enumerate(grus)])
        cost = L.warpctc(logits, label, blank=classes, norm_by_times=True,
                         label_length=label_len)
        loss = L.reduce_sum(cost)
        decoded = L.ctc_greedy_decoder(logits, blank=classes)
        evaluator = pt.evaluator.EditDistance(decoded, L.cast(label, "int64"))
        if qat:
            pt.contrib.slim.quantization.QuantizationTransformPass().apply(
                main, startup)
        test = main.clone(for_test=True)
        pt.optimizer.Momentum(CRNN_LR, CRNN_MU).minimize(loss)
    startup.random_seed = main.random_seed = test.random_seed = SEED
    return main, startup, test, loss, logits, evaluator


def _crnn_feed(rng, B, shape=None):
    """B images from N(0, 1) (CRNN_SHAPE where `shape` is not given) and
    their labels: 4-16 ids (CRNN_LABEL) in [0, CRNN_CLASSES), padded with
    -1, with their lengths."""
    lo, hi = CRNN_LABEL
    lens = rng.integers(lo, hi + 1, B).astype(np.int32)
    label = np.full((B, hi), -1, np.int32)
    for b, n in enumerate(lens):
        label[b, :n] = rng.integers(0, CRNN_CLASSES, n)
    return {"pixel": rng.standard_normal((B, *(shape or CRNN_SHAPE)))
            .astype(np.float32),
            "label": label, "label_length": lens}


def _crf_ctc_cases():
    """(op, inputs, outputs, attrs, cotangent shapes, inputs that take no
    grad, the model whose size it is) of the 10 new ops: the crf pair at
    the SRL's size (B=10, its longest sentence of 39, 59 labels), the ctc
    ops at CRNN's (B=32, T=64, 96 classes, labels of 4-16 ids), chunk_eval
    over SRL_B sentences of 29 IOB types, the fake quantizers on CRNN's
    last conv (its 128 x 128 x 3 x 3 weight, its [32, 128, 6, 64] input)
    and the dequantize on its first fc's int8 weight [768, 600]."""
    rng = np.random.default_rng(SEED + 60)

    def f(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    B, T, N = SRL_B, 39, 59
    lens = np.concatenate([[T], rng.integers(5, T, B - 1)]).astype(np.int64)
    tags = rng.integers(0, N, (B, T)).astype(np.int64)
    crf_in = {"Emission": {"em": f(B, T, N)}, "Transition": {"w": f(N + 2, N, scale=0.1)},
              "Length": {"ln": lens}}
    Bc, Tc, V = CRNN_B, 64, CRNN_CLASSES + 1
    feed = _crnn_feed(rng, Bc)
    ctc_in = {"Logits": {"lg": f(Bc, Tc, V)}, "Label": {"lab": feed["label"]},
              "LogitsLength": {"lgl": np.full(Bc, Tc, np.int32)},
              "LabelLength": {"lbl": feed["label_length"]}}
    tokens = rng.integers(0, V, (Bc, Tc)).astype(np.int64)
    tokens[:, 1::2] = np.where(rng.random((Bc, Tc // 2)) < 0.5, tokens[:, ::2],
                               CRNN_CLASSES)
    hl = rng.integers(0, Tc + 1, Bc).astype(np.int64)
    act = f(Bc, 128, 6, 64)
    cases = [
        ("linear_chain_crf", {**crf_in, "Label": {"lab": tags}},
         {"LogLikelihood": ["o"]}, {}, {"o": (B, 1)}, (), "SRL"),
        ("crf_decoding", crf_in, {"ViterbiPath": ["o"]}, {}, {}, (), "SRL"),
        ("crf_decoding", {**crf_in, "Label": {"lab": tags}},
         {"ViterbiPath": ["o"]}, {}, {}, (), "SRL, against the target"),
        ("warpctc", ctc_in, {"Loss": ["o"]},
         {"blank": CRNN_CLASSES, "norm_by_times": True}, {"o": (Bc, 1)}, (), "CRNN"),
        ("ctc_align", {"Input": {"x": tokens}, "InputLength": {"ln": hl}},
         {"Output": ["o"], "OutputLength": ["n"]}, {"blank": CRNN_CLASSES}, {},
         (), "CRNN"),
        ("edit_distance", {"Hyps": {"h": tokens}, "HypsLength": {"hl": hl},
                           "Refs": {"r": feed["label"].astype(np.int64)},
                           "RefsLength": {"rl": feed["label_length"].astype(np.int64)}},
         {"Out": ["o"], "SequenceNum": ["n"]}, {"normalized": True}, {}, (), "CRNN"),
        ("chunk_eval", {"Inference": {"i": tags}, "Label": {"l": np.where(
            rng.random((B, T)) < 0.7, tags, rng.integers(0, N, (B, T)))},
                        "SeqLength": {"ln": lens}},
         {"Precision": ["p"], "Recall": ["r"], "F1-Score": ["f"],
          "NumInferChunks": ["ni"], "NumLabelChunks": ["nl"],
          "NumCorrectChunks": ["nc"]},
         {"chunk_scheme": "IOB", "num_chunk_types": math.ceil((N - 1) / 2)}, {}, (),
         "SRL"),
        ("fake_quantize_dequantize_abs_max", {"X": {"x": f(128, 128, 3, 3, scale=0.01)}},
         {"Out": ["o"], "OutScale": ["s"]}, {"bit_length": 8},
         {"o": (128, 128, 3, 3)}, (), "CRNN conv weight"),
        ("fake_quantize_dequantize_moving_average_abs_max",
         {"X": {"x": act}, "InScale": {"ins": np.array([2.5], np.float32)}},
         {"Out": ["o"], "OutScale": ["s"]}, {"bit_length": 8, "moving_rate": 0.9},
         {"o": act.shape}, ("ins",), "CRNN conv input"),
        ("fake_quantize_dequantize_static", {"X": {"x": act}}, {"Out": ["o"]},
         {"scale": 3.7, "bit_length": 8}, {"o": act.shape}, (), "CRNN conv input"),
        ("dequantize_abs_max",
         {"X": {"x": rng.integers(-127, 128, (768, 600)).astype(np.int8)},
          "Scale": {"sc": np.array([0.021], np.float32)}}, {"Out": ["o"]},
         {"bit_length": 8}, {}, ("sc",), "CRNN fc weight, int8"),
    ]
    return cases


def _ctc_loss_oracle(dev, case):
    """warpctc without norm_by_times on the card against F.ctc_loss
    (reduction "none") on the same logits and labels, a check independent
    of both packages (every alignment possible: 64 frames, at most 16
    labels); both times printed."""
    import torch.nn.functional as F

    import paddle_tpu_torch as pt

    op, ins, outs, attrs, _, _, _ = case
    main, fetch = _seq_program(op, ins, outs, dict(attrs, norm_by_times=False), {})
    feed = {n: a for d in ins.values() for n, a in d.items()}
    exe, dfeed = pt.Executor(place=dev), _on(dev, feed)
    (loss,) = exe.run(main, feed=dfeed, fetch_list=fetch, scope=pt.Scope(),
                      return_numpy=False)
    lab = dfeed["lab"].long()
    logp = torch.log_softmax(dfeed["lg"], -1).transpose(0, 1)

    def lib():
        return F.ctc_loss(logp, lab.clamp(min=0), dfeed["lgl"].long(),
                          dfeed["lbl"].long(), blank=attrs["blank"],
                          reduction="none")

    ref = lib()
    e = _rel_l2(loss.reshape(-1), ref)
    if not e <= LT_L2:
        raise RuntimeError(f"warpctc on the card is {e:.3e} relative L2 from "
                           f"F.ctc_loss (limit {LT_L2})")
    ms = _lt_ms(dev, main, fetch, feed)
    lib_ms = (1e3 * min(_timed_windows(lib, 3, 3)) if dev.type == "cuda"
              else float("nan"))
    return (f"warpctc against F.ctc_loss {e:.2e} relative L2; warpctc forward "
            f"{ms:.3f} ms a run, F.ctc_loss on the same log-probabilities "
            f"{lib_ms:.3f} ms (a check only)")


def crf_ctc_ops(dev, card):
    """Each of the 10 new ops (`_crf_ctc_cases`) held on the card against
    the CPU by `_op_sweep`, every op but chunk_eval (a host op) under the
    sync debug mode "error"; warpctc also against F.ctc_loss
    (`_ctc_loss_oracle`)."""
    rows = []
    gated = _op_sweep(dev, _crf_ctc_cases(), rows, host=("chunk_eval",),
                      after=lambda c: (_ctc_loss_oracle(dev, c)
                                       if c[0] == "warpctc" else None))
    print(f"crf, ctc and quant ops on the card against the CPU ({len(rows) - 1} "
          f"cases; relative L2 <= {LT_L2}; {gated} op dispatches under the "
          f"sync debug mode 'error'; ms a run of forward and grads, the better "
          f"of two single runs): " + "; ".join(rows) + f" [{card}]")


def train_srl(dev, card):
    """The book's semantic role labeller (`_srl_program`) at its widths,
    fp32. Step 1 at B = SRL_B on conll05.test()'s first batch against the
    port's CPU run of the same program, weights (the `emb` table from
    get_embedding()) and feed: the loss within 1e-4 relative, each
    parameter gradient as `_hold_grads`, no hand kernel launched. Then
    SRL_STEPS steps over the next batches (each padded to its own longest
    sentence), the first with every op's compute under the sync debug mode
    "error": steps/s, sentences/s, peak memory, and a profiled step's device
    busy share. Then one pass of the decode clone with the ChunkEvaluator
    over SRL_EVAL_BATCHES batches (its first batch sync-free but for
    chunk_eval): precision, recall, F1, and chunk_eval's host syncs.
    Returns the launches of the held step (none)."""
    import paddle_tpu_torch as pt

    main, startup, test, loss, decode, evaluator = _srl_program(pt)
    names = [p.name for p in main.all_parameters() if p.trainable]
    batches = _srl_batches(pt, 1 + SRL_STEPS + SRL_EVAL_BATCHES)
    gpu, cpu = pt.Executor(place=dev), pt.Executor(place="cpu")
    gscope, cscope = pt.Scope(), pt.Scope()
    cpu.run(startup, scope=cscope)
    gpu.run(startup, scope=gscope)
    cscope.find_var("emb").copy_(torch.from_numpy(pt.dataset.conll05.get_embedding()))
    _copy_to_card(dev, cscope, gscope, [p.name for p in main.all_parameters()])
    fetch = [loss.name] + [n + "@GRAD" for n in names]
    from paddle_tpu_torch.ops import cuda_kernels as ck

    ck.reset_launch_counts()
    got = gpu.run(main, feed=_on(dev, batches[0]), fetch_list=fetch, scope=gscope,
                  return_numpy=False)
    _sync(dev)
    counts = _lt_launches(dev, main, "SRL step 1")
    want = cpu.run(main, feed=batches[0], fetch_list=fetch, scope=cscope,
                   return_numpy=False)
    l1, lc = _hold_loss("SRL step 1", got[0], want[0])
    worst, floored = _hold_grads("SRL step 1", names, got[1:], want[1:])
    T = batches[0]["word"].shape[1]
    print(f"SRL (db_lstm depth {SRL_DEPTH}, hidden {SRL_HIDDEN}, linear_chain_crf "
          f"over 59 labels) step 1 at B={SRL_B}, T={T}: loss {l1:.6f} (CPU "
          f"{lc:.6f}); worst gradient at {worst:.3f} of its limit over "
          f"{len(names)} parameters ({floored} held to the floor); launches "
          f"{counts}; {len(main.global_block.ops)} ops a step [{card}]")
    del got, want, cscope
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    feeds = [_on(dev, b) for b in batches[1:1 + SRL_STEPS]]

    def step(feed):
        return gpu.run(main, feed=feed, fetch_list=[loss], scope=gscope,
                       return_numpy=False)[0]

    seen = {}
    undo = _sync_free({o.type for o in main.global_block.ops}, seen)
    try:
        losses = [step(feeds[0])]
        _sync(dev)
    finally:
        undo()
    t0 = time.perf_counter()
    for feed in feeds[1:]:
        losses.append(step(feed))
    _sync(dev)
    wall = (time.perf_counter() - t0) / (len(feeds) - 1)
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"SRL: a loss is not finite: {losses}")
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if dev.type == "cuda" else float("nan"))
    busy = (_profile(lambda: step(feeds[0]), card, f"SRL training step "
                     f"(B={SRL_B}, T={feeds[0]['word'].shape[1]})")
            if dev.type == "cuda" else None)
    print(f"SRL at B={SRL_B}, SGD(exponential_decay(0.01)): {1 / wall:.2f} "
          f"steps/s, {SRL_B / wall:.1f} sentences/s ({1e3 * wall:.1f} ms a "
          f"step, mean of {len(feeds) - 1} batches of their own length), peak "
          f"device memory {peak:.2f} GiB, device busy "
          f"{'not measured' if busy is None else f'{100 * busy:.1f}%'} of a "
          f"traced step; the first step's {sum(seen.values())} op dispatches "
          f"under the sync debug mode 'error'; losses "
          f"{[round(v, 3) for v in losses[:5]]}... [{card}]")

    evaluator.reset(gpu, scope=gscope)
    evals = batches[1 + SRL_STEPS:]
    seen, chunk = {}, {}
    undo_chunk = _sync_free({"chunk_eval"}, chunk, mode="warn")
    try:
        undo = _sync_free({o.type for o in test.global_block.ops} - {"chunk_eval"},
                          seen)
        try:
            gpu.run(test, feed=_on(dev, evals[0]), fetch_list=evaluator.metrics,
                    scope=gscope, return_numpy=False)
            _sync(dev)
        finally:
            undo()
        t0 = time.perf_counter()
        for b in evals[1:]:
            gpu.run(test, feed=_on(dev, b), fetch_list=evaluator.metrics,
                    scope=gscope, return_numpy=False)
        _sync(dev)
        ms = 1e3 * (time.perf_counter() - t0) / (len(evals) - 1)
    finally:
        undo_chunk()
    p, r, f1 = (float(v[0]) for v in evaluator.eval(gpu, scope=gscope))
    if not all(0.0 <= v <= 1.0 for v in (p, r, f1)):
        raise RuntimeError(f"SRL decode: precision {p}, recall {r}, F1 {f1}")
    print(f"SRL decode clone (crf_decoding, ChunkEvaluator IOB over 29 types) "
          f"over {len(evals)} batches: precision {p:.4f}, recall {r:.4f}, F1 "
          f"{f1:.4f} (random weights; the evaluator scores the padded tail "
          f"too, as the JAX package's does); {ms:.1f} ms a batch; chunk_eval "
          f"ran {chunk.get('chunk_eval', 0)} times on the card with "
          f"{chunk.get('chunk_eval syncs', 0)} host syncs; the first batch's "
          f"{sum(seen.values())} other op dispatches under the sync debug mode "
          f"'error' [{card}]")
    return counts


# CRNN's batch norms in NCHW "cr" rows of one (sample, channel) map at B =
# CRNN_B, one row a group: two norms a group, K8 with the relu folded in
BN_CRNN = (("cr", CRNN_B * 16, 48 * 512, 16, "relu"),
           ("cr", CRNN_B * 32, 24 * 256, 32, "relu"),
           ("cr", CRNN_B * 64, 12 * 128, 64, "relu"),
           ("cr", CRNN_B * 128, 6 * 64, 128, "relu"))


def _crnn_bn_maps():
    """{elements a map: (its name, the channels of each of CRNN's batch
    norms on such maps)}: two a group, the map halving after each group
    but the last."""
    _, h, w = CRNN_SHAPE
    maps = {}
    for c in CRNN_CHANNELS:
        maps[h * w] = (f"{h}x{w}", [c, c])
        h, w = h // 2, w // 2
    return maps


def check_bn_crnn(dev, timer, card):
    """K8 and K9 (chain mode) at BN_CRNN (`_bn_cr_rows`), then their time in
    a CRNN-CTC step as the rows predict it. Returns K8's and K9's
    launch-weighted ms."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 61)
    maps = _crnn_bn_maps()
    k8, k9 = _bn_cr_rows(dev, timer, card, BN_CRNN, maps, "CRNN", g)
    n = sum(len(c) for _, c in maps.values())
    print(f"K8 and K9 in a CRNN-CTC training step (B={CRNN_B}, 48x512) as "
          f"BN_CRNN predicts them, {n} launches each: K8 {k8[0]:.4f} ms "
          f"launch-weighted; K9 {k9[0]:.4f} ms launch-weighted [{card}]")
    return k8[0], k9[0]


def train_crnn_ctc(dev, card, predicted=None):
    """CRNN-CTC (`_crnn_ctc_program`) at CRNN_SHAPE, fp32 NCHW. Step 1 at B
    = CRNN_B against the port's CPU run of the same program, weights and
    batch (the form of the YOLOv3 held step: the loss within 1e-4
    relative, `_hold_grads`, the running statistics within 1e-4 of their
    max-abs; relu inputs of the folded norms near 0 take the card's side,
    counted), K8 and K9 once a batch norm (8). Then a step under the sync
    debug mode "error" and CRNN_STEPS steps on the seeded batch whose loss
    falls: images/s, peak memory, a profiled step's busy share and K8/K9
    time beside `predicted`. The eval clone (K8 in inference mode, 8 a
    run) with the EditDistance evaluator over CRNN_EVAL batches. Then the
    QAT arm (`_crnn_qat`). Returns the launches of every run."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda_kernels as ck

    main, startup, test, loss, logits, evaluator = _crnn_ctc_program(pt)
    names = [p.name for p in main.all_parameters()]
    stats = _bn_stats(main)
    n_bn = len(stats) // 2
    rng = np.random.default_rng(SEED + 62)
    feed = _crnn_feed(rng, CRNN_B)
    gpu, cpu = pt.Executor(place=dev), pt.Executor(place="cpu")
    gscope, cscope = pt.Scope(), pt.Scope()
    cpu.run(startup, scope=cscope)
    gpu.run(startup, scope=gscope)
    _copy_to_card(dev, cscope, gscope, names + stats)
    fetch = [loss.name] + [n + "@GRAD" for n in names]
    kinks = _kink_vars(main)
    deciding = sorted(set(kinks.values()))
    ck.reset_launch_counts()
    got = gpu.run(main, feed=_on(dev, feed), fetch_list=fetch + deciding,
                  scope=gscope, return_numpy=False)
    _sync(dev)
    counts = _yolo_launches(dev, main, n_bn, "CRNN-CTC step 1")
    card_at = dict(zip(deciding, (t.cpu() for t in got[len(fetch):])))
    got = got[:len(fetch)]
    taken = [0]
    with _card_kinks(main, {o: card_at[i] for o, i in kinks.items()},
                     MBV3_KINK_NEAR, taken):
        want = cpu.run(main, feed=feed, fetch_list=fetch, scope=cscope,
                       return_numpy=False)
    l1, lc = _hold_loss("CRNN-CTC step 1", got[0], want[0])
    worst, floored = _hold_grads("CRNN-CTC step 1", names, got[1:], want[1:])
    st = _hold_stats("CRNN-CTC step 1", stats, gscope, cscope)
    print(f"CRNN-CTC ({'x'.join(map(str, CRNN_SHAPE))}, {CRNN_CLASSES} classes "
          f"+ blank) step 1 at B={CRNN_B}: loss {l1:.6f} (CPU {lc:.6f}); "
          f"worst gradient at {worst:.3f} of its limit over {len(names)} "
          f"parameters ({floored} held to the floor); {taken[0]} relu inputs "
          f"within {MBV3_KINK_NEAR} of 0 took the card's side in the CPU run; "
          f"running statistics at {st:.3f} of their limit; {n_bn} batch norms, "
          f"launches {counts}; {len(main.global_block.ops)} ops a step [{card}]")
    del got, want, card_at, cscope
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    scope = pt.Scope()
    gpu.run(startup, scope=scope)
    dfeed = _on(dev, feed)

    def step():
        return gpu.run(main, feed=dfeed, fetch_list=[loss], scope=scope,
                       return_numpy=False)[0]

    seen = {}
    undo = _sync_free({o.type for o in main.global_block.ops}, seen)
    ck.reset_launch_counts()
    try:
        losses = [step()]
        _sync(dev)
    finally:
        undo()
    run_counts = _yolo_launches(dev, main, n_bn, f"CRNN-CTC at B={CRNN_B}")
    t0 = time.perf_counter()
    for _ in range(CRNN_STEPS):
        losses.append(step())
    _sync(dev)
    wall = (time.perf_counter() - t0) / CRNN_STEPS
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"CRNN-CTC at B={CRNN_B}: the loss did not fall: "
                           f"{losses}")
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if dev.type == "cuda" else float("nan"))
    print(f"CRNN-CTC at B={CRNN_B}, Momentum({CRNN_LR}, {CRNN_MU}), L2 "
          f"{CRNN_L2}: {CRNN_B / wall:.1f} images/s, {1e3 * wall:.1f} ms a "
          f"step (mean of {CRNN_STEPS}), peak device memory {peak:.2f} GiB; "
          f"the first step's {sum(seen.values())} op dispatches under the "
          f"sync debug mode 'error'; losses {[round(v, 3) for v in losses]} "
          f"[{card}]")
    if dev.type == "cuda":
        totals = {}
        _profile(step, card, f"CRNN-CTC training step (B={CRNN_B})",
                 ("K8", ("bn_apply_fwd",)), ("K9", ("bn_apply_bwd",)),
                 totals=totals)
        for k, i in (("K8", 0), ("K9", 1)):
            told = ("" if predicted is None else
                    f", against {predicted[i]:.4f} ms launch-weighted from "
                    f"BN_CRNN's rows")
            got_ms = ("not measured (no device time in the trace)" if k not in
                      totals else f"{totals[k][0]:.4f} ms in {totals[k][1]} "
                      f"launches")
            print(f"{k} in the traced CRNN-CTC step: {got_ms}{told} [{card}]")

    evaluator.reset(gpu, scope=scope)
    eval_counts = []
    for _ in range(CRNN_EVAL):
        ck.reset_launch_counts()
        gpu.run(test, feed=_on(dev, _crnn_feed(rng, CRNN_B)),
                fetch_list=evaluator.metrics, scope=scope, return_numpy=False)
        _sync(dev)
        eval_counts.append(_yolo_launches(dev, test, n_bn, "CRNN-CTC eval clone",
                                          k9=False))
    dist, err = (float(v[0]) for v in evaluator.eval(gpu, scope=scope))
    if not (np.isfinite(dist) and 0.0 <= err <= 1.0):
        raise RuntimeError(f"CRNN-CTC eval: distance {dist}, error rate {err}")
    print(f"CRNN-CTC eval clone over {CRNN_EVAL} batches of {CRNN_B}: mean "
          f"normalized edit distance {dist:.3f}, sequence error rate {err:.3f} "
          f"(the padded sequences, as the JAX package's evaluator scores them); "
          f"launches a run {eval_counts[0]} [{card}]")
    del scope
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return [counts, run_counts, *eval_counts, *_crnn_qat(dev, card)]


def _crnn_qat(dev, card):
    """CRNN-CTC under quantization-aware training: QuantizationTransformPass
    on a fresh program (a fake quantizer on every conv and fc weight and
    input), CRNN_QAT_STEPS steps at B = CRNN_B (the first under the sync
    debug mode "error"), then QuantizationFreezePass and ConvertToInt8Pass
    on copies of its eval clone: the frozen clone's logits against the QAT
    clone's (printed), the int8 clone's against the frozen one's (within
    LT_L2: the dequantize restores the frozen weights). Returns the
    launches of the steps and the clones' runs."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib.slim import quantization as Q
    from paddle_tpu_torch.ops import cuda_kernels as ck

    main, startup, test, loss, logits, _ = _crnn_ctc_program(pt, qat=True)
    n_bn = len(_bn_stats(main)) // 2
    fakes = [o.type for o in main.global_block.ops
             if o.type.startswith("fake_") and not o.type.endswith("_grad")]
    exe, scope = pt.Executor(place=dev), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(SEED + 63)
    feed = _on(dev, _crnn_feed(rng, CRNN_B))
    counts, losses, seen = [], [], {}
    for i in range(CRNN_QAT_STEPS):
        undo = (_sync_free({o.type for o in main.global_block.ops}, seen)
                if i == 0 else (lambda: None))
        ck.reset_launch_counts()
        try:
            losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=scope, return_numpy=False)[0]))
            _sync(dev)
        finally:
            undo()
        counts.append(_yolo_launches(dev, main, n_bn, "CRNN-CTC QAT step"))
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"CRNN-CTC QAT: a loss is not finite: {losses}")
    per_step = sum(v for k, v in seen.items() if k.startswith("fake_"))
    probe = _on(dev, _crnn_feed(rng, CRNN_B))

    def run(program):
        ck.reset_launch_counts()
        (out,) = exe.run(program, feed=probe, fetch_list=[logits.name],
                         scope=scope, return_numpy=False)
        _sync(dev)
        counts.append(_yolo_launches(dev, program, n_bn, "CRNN-CTC QAT clone",
                                     k9=False))
        return out

    qat_out = run(test)
    frozen = test.clone()
    Q.QuantizationFreezePass(scope).apply(frozen)
    frozen_out = run(frozen)
    Q.ConvertToInt8Pass(scope).apply(frozen)
    int8_out = run(frozen)
    e8 = _rel_l2(int8_out, frozen_out)
    if not e8 <= LT_L2:
        raise RuntimeError(f"CRNN-CTC int8 clone {e8:.3e} relative L2 from the "
                           f"frozen clone (limit {LT_L2})")
    left = [o.type for o in frozen.global_block.ops if o.type.startswith("fake_")]
    n_deq = sum(o.type == "dequantize_abs_max" for o in frozen.global_block.ops)
    if left or not n_deq:
        raise RuntimeError(f"CRNN-CTC freeze left {left}, {n_deq} dequantize ops")
    print(f"CRNN-CTC QAT ({len(fakes)} fake quantizers: "
          f"{fakes.count('fake_quantize_dequantize_abs_max')} on weights, "
          f"{fakes.count('fake_quantize_dequantize_moving_average_abs_max')} on "
          f"inputs): {per_step} fake-quant dispatches a step (forward and "
          f"straight-through grads) under the sync debug mode 'error', losses "
          f"{[round(v, 3) for v in losses]}; the frozen clone's logits "
          f"{_rel_l2(frozen_out, qat_out):.3e} relative L2 from the QAT "
          f"clone's (its activations unclipped), the int8 clone ({n_deq} "
          f"int8 weights dequantized) {e8:.2e} from the frozen one [{card}]")
    return counts


# The data-parallel phases: bench.py:112 bench_bert's shape (BERT-base AMP,
# S = 128, global B = 128, Adam(TRAIN_LR), dropout 0) over torch.distributed.
# One card cannot host two NCCL ranks, so dp_nccl1 runs one rank over NCCL
# and dp_gloo2 two ranks sharing the card over gloo (host-staged).
DP_STEPS = 2     # lockstep steps of dp_nccl1 and dp_gloo2 (a)-(c); 3 before
                 # a depth cut
DP_RANKS = 2
# lookup_table_grad's atomic index_add_ makes these gradients differ in their
# last bits from run to run (ROADMAP Queue 3): held within DP_GRAD_L2, the
# AMP step-1 gradient hold's floor, and copied across arms after each step
# so that every other parameter can be held bit for bit
DP_NOT_REPEATABLE = ("encoder.word_emb", "encoder.pos_emb")
DP_GRAD_L2 = AMP_GRAD_BAND[1]
DP_LOSS_RTOL = AMP_LOSS_RTOL
DP_TIMEOUT_S = 600       # the launcher's limit on the two ranks
DP_LOCKSTEP = ("bucketed", "pergrad", "zero1")


def _dp_feed(cfg, uneven=False):
    """bench_bert's seeded batch; uneven: the first half's lm_weight zeroes
    three quarters of its positions, so the halves weigh apart."""
    feed = _bert_feed(cfg, AMP_B, AMP_S)
    if uneven:
        w = feed["lm_weight"].copy()
        w[: AMP_B // 2, : 3 * AMP_S // 4] = 0.0
        feed["lm_weight"] = w
    return feed


def _dp_program(cfg, mode, rank=0, world=1):
    """(main, startup, avg_loss): BERT-base + decorate(Adam(TRAIN_LR)),
    minimized plainly ("plain") or through the collective fleet ("fleet":
    GradAllReduce under FLAGS_allreduce_bucket_mb and FLAGS_zero1;
    "local_sgd": LocalSGD, k_steps 2)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.contrib import mixed_precision as amp
    from paddle_tpu_torch.incubate import fleet as fl
    from paddle_tpu_torch.models import transformer

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        avg_loss, _ = transformer.bert_pretrain(cfg, seq_len=AMP_S)
        opt = amp.decorate(pt.optimizer.Adam(learning_rate=TRAIN_LR))
        if mode == "plain":
            opt.minimize(avg_loss)
        else:
            strat = fl.DistributedStrategy()
            if mode == "local_sgd":
                strat.mode, strat.local_sgd_k = "local_sgd", 2
            fl.fleet.init(fl.UserDefinedRoleMaker(current_id=rank,
                                                  worker_num=world))
            fl.fleet.distributed_optimizer(opt, strat).minimize(avg_loss)
    startup.random_seed = SEED
    return main, startup, avg_loss


def _dp_buckets(main):
    """[(op type, gradients, bytes)] of the program's gradient reduces (the
    fp32 master gradients, of their parameters' shapes)."""
    block = main.global_block
    return [(op.type, len(op.input("X")),
             sum(4 * int(np.prod(block.var(n).shape)) for n in op.input("X")))
            for op in block.ops
            if op.type in ("c_allreduce_coalesced", "c_allreduce_sum")]


def _dp_moments(main, param):
    """The Adam moment vars of `param` (ZeRO-1's shard suffix stripped)."""
    for op in main.global_block.ops:
        if op.type == "adam" and op.input("Param")[0].split("@")[0] == param:
            return [op.input(s)[0].split("@ZERO1")[0]
                    for s in ("Moment1", "Moment2")]
    return []


def _dp_sync_not_repeatable(src, dst, index, world):
    """Copy the not-repeatable parameters and their moments from arm `src`
    to arm `dst` ({"main", "scope"}); a moment `dst` keeps as ZeRO-1's
    shard takes the rank's rows."""
    for p in DP_NOT_REPEATABLE:
        for n in [p] + _dp_moments(src["main"], p):
            a, b = src["scope"].find_var(n), dst["scope"].find_var(n)
            if b.shape[0] * world == a.shape[0] and world > 1:
                k = b.shape[0]
                a = a[index * k:(index + 1) * k]
            dst["scope"].set_var(n, a.clone())


def _dp_held(what, got, want, names, exact=True):
    """Every name in `names` of `got` bit for bit `want`'s (exact) or
    within DP_GRAD_L2 in relative L2; returns the worst distance."""
    worst = 0.0
    for n in names:
        a, b = got[n], want[n]
        if exact and n.split("@")[0] not in DP_NOT_REPEATABLE:
            if not torch.equal(a, b):
                raise RuntimeError(f"{what}: {n} differs from the reference "
                                   f"(max abs {float((a - b).abs().max()):.3e})")
            continue
        d = _rel_l2(a, b)
        worst = max(worst, d)
        if not d <= DP_GRAD_L2:
            raise RuntimeError(f"{what}: {n} {d:.3e} from the reference in "
                               f"relative L2 (limit {DP_GRAD_L2})")
    return worst


def _dp_step(exe, target, feed, scope, loss, fetch=()):
    """One step: (loss, fetches, ms, collective stats, launches, peak)."""
    from paddle_tpu_torch.ops import collective_ops as co
    from paddle_tpu_torch.ops import cuda_kernels as ck

    ck.reset_launch_counts()
    co.reset_comm_stats(timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = exe.run(target, feed=feed, scope=scope, return_numpy=False,
                  fetch_list=[loss] + list(fetch))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    stats = co.comm_stats()
    launches = {w: by for w, by in ck.launch_counts_by_dtype().items() if by}
    return (float(out[0]), out[1:], ms, stats, launches,
            torch.cuda.max_memory_allocated() / 2**30)


def _dp_record(rec, ms, stats, launches, peak):
    """comm_ms: the collectives' own time (the stream's span across each
    nccl call; on gloo the host's staging copies and the collective);
    wait_ms: on gloo, the syncs before the staging (the step's work queued
    ahead of each collective)."""
    rec.setdefault("ms", []).append(ms)
    rec.setdefault("comm_ms", []).append(
        stats["device_ms"] if stats["device_ms"] is not None
        else stats["host_s"] * 1e3)
    rec.setdefault("wait_ms", []).append(stats["wait_s"] * 1e3)
    rec.setdefault("comm_bytes", []).append(stats["bytes"])
    rec.setdefault("calls", []).append(stats["calls"])
    rec["peak_gib"] = max(rec.get("peak_gib", 0.0), peak)
    _add_counts(rec.setdefault("launches", {}), launches)


def dp_nccl1(dev, card, backend="nccl"):
    """One rank over NCCL (`backend`): the fleet-transpiled BERT-base AMP
    step against the untranspiled program on the same card and feed,
    DP_STEPS steps in lockstep (the not-repeatable parameters copied
    across after each)."""
    import torch.distributed as dist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    env = init_parallel_env(num_processes=1, process_id=0, backend=backend,
                            device=dev)
    try:
        cfg = _bert_cfg(AMP_S)
        feed = _dp_feed(cfg)
        arms = {}
        for mode in ("plain", "fleet"):
            main, startup, loss = _dp_program(cfg, mode, env.rank,
                                              env.world_size)
            exe, scope = pt.Executor(dev), pt.Scope()
            exe.run(startup, scope=scope)
            target = (main if mode == "plain" else pt.CompiledProgram(main)
                      .with_collective(mesh=make_mesh()))
            arms[mode] = dict(main=main, scope=scope, exe=exe, loss=loss,
                              target=target)
        names = [p.name for p in arms["plain"]["main"].all_parameters()]
        g = make_mesh().group("dp")
        if g.backend != backend or g.size != 1:
            raise RuntimeError(f"dp_nccl1: group {g}")
        worst, rec, plain = 0.0, {}, {}
        for step in range(DP_STEPS):
            res = {}
            for mode, a in arms.items():
                res[mode] = _dp_step(a["exe"], a["target"], feed, a["scope"],
                                     a["loss"])
            _dp_record(rec, *res["fleet"][2:])
            _dp_record(plain, *res["plain"][2:])
            got = {n: arms["fleet"]["scope"].find_var(n) for n in names}
            want = {n: arms["plain"]["scope"].find_var(n) for n in names}
            worst = max(worst, _dp_held(f"dp_nccl1 step {step + 1}", got,
                                        want, names))
            if res["fleet"][0] != res["plain"][0]:
                raise RuntimeError(f"dp_nccl1 step {step + 1}: loss "
                                   f"{res['fleet'][0]} vs {res['plain'][0]}")
            _dp_sync_not_repeatable(arms["plain"], arms["fleet"], 0, 1)
        want_launches = _expected_launches(arms["fleet"]["main"])
        per_step = {w: {d: n // DP_STEPS for d, n in by.items()}
                    for w, by in rec["launches"].items()}
        if per_step != want_launches:
            raise RuntimeError(f"dp_nccl1: launches a step {per_step}, the "
                               f"program says {want_launches}")
        buckets = _dp_buckets(arms["fleet"]["main"])
        print(f"dp_nccl1: BERT-base AMP B={AMP_B} S={AMP_S}, one rank over "
              f"NCCL ({g}), {DP_STEPS} steps of the fleet-transpiled program "
              f"(GradAllReduce, FLAGS_allreduce_bucket_mb="
              f"{pt.flags.get_flag('allreduce_bucket_mb')}): every parameter "
              f"bit for bit the untranspiled program's but "
              f"{', '.join(DP_NOT_REPEATABLE)} (worst {worst:.3e} in relative "
              f"L2, limit {DP_GRAD_L2}), losses equal; {len(buckets)} "
              f"buckets of {[b for _, _, b in buckets]} bytes "
              f"({sum(c for _, c, _ in buckets)} gradients), "
              f"{rec['calls'][-1]} NCCL calls a step; ms a step "
              f"{[round(x, 2) for x in rec['ms']]} (the untranspiled "
              f"program's {[round(x, 2) for x in plain['ms']]}), ms in "
              f"collectives (the "
              f"stream's span across each call, CUDA events) "
              f"{[round(x, 3) for x in rec['comm_ms']]}, peak "
              f"{rec['peak_gib']:.2f} GiB; launches {rec['launches']}; "
              f"phase {time.perf_counter() - t_phase:.1f} s [{card}]")
        return rec["launches"]
    finally:
        dist.destroy_process_group()


def _dp_flat(grads, names):
    return torch.cat([grads[n].reshape(-1) for n in names])


def _dp_gather_sum(t):
    """Every rank's float64 sum of `t`, gathered over the world."""
    import torch.distributed as dist

    s = torch.tensor([float(t.double().sum())])
    out = [torch.zeros(1, dtype=torch.float64) for _ in
           range(dist.get_world_size())]
    dist.all_gather(out, s.double())
    return [float(x) for x in out]


def _dp_references(cfg, dev, feed, uneven):
    """Rank 0's one-process references on the card: the mean of the two
    half-batch (B/2) step-1 gradients, the B=128 trajectory (losses, the
    start and the parameters after DP_STEPS steps), each gradient's band
    (AMP_GRAD_BAND over the distance between the halves' mean and the
    B=128 step-1 gradient: the bf16 rounding of two reductions against
    one; over all gradients at once too), the uneven feed's step-1
    gradients and loss, and the plain program, for (e)."""
    import paddle_tpu_torch as pt

    main, startup, loss = _dp_program(cfg, "plain")
    names = [p.name for p in main.all_parameters()]
    grads = [n + "@GRAD" for n in names]
    exe = pt.Executor(dev)

    def fresh():
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        return scope

    halves = []
    for i in range(DP_RANKS):
        rows = slice(i * AMP_B // DP_RANKS, (i + 1) * AMP_B // DP_RANKS)
        out = exe.run(main, feed={k: v[rows] for k, v in feed.items()},
                      fetch_list=grads, scope=fresh(), return_numpy=False)
        halves.append(out)
    mean = {n: (a + b) / 2 for n, a, b in zip(names, *halves)}
    del halves
    scope, losses = fresh(), []
    p0 = {n: scope.find_var(n).clone() for n in names}
    for step in range(DP_STEPS):
        out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                      fetch_list=[loss] + (grads if step == 0 else []))
        losses.append(float(out[0]))
        if step == 0:
            full = dict(zip(names, out[1:]))
    params = {n: scope.find_var(n) for n in names}
    # what bf16 puts between one batch's reduction and two halves' summed
    # in fp32, on the same weights: each gradient's band under (e)
    band = {n: min(AMP_GRAD_BAND[0] * _rel_l2(mean[n], full[n])
                   + AMP_GRAD_BAND[1], AMP_GRAD_CAP) for n in names}
    band_all = (AMP_GRAD_BAND[0] * _rel_l2(_dp_flat(mean, names),
                                           _dp_flat(full, names))
                + AMP_GRAD_BAND[1])
    del full
    out = exe.run(main, feed=uneven, fetch_list=[loss] + grads,
                  scope=fresh(), return_numpy=False)
    return dict(mean=mean, losses=losses, params=params, p0=p0, band=band,
                band_all=band_all,
                uneven_loss=float(out[0]),
                uneven=dict(zip(names, out[1:])),
                program=(main, startup, loss))


# (f): ResNet-50 AMP (bench.py:282's network, decorate(Momentum)) under
# with_data_parallel with synced batch statistics, the global batch
# DP_RN_B with rank 1's images scaled by 3 and shifted by 1. Each
# parameter's step-1 update and each running statistic is held to the
# one-process step's within its own AMP band: twice the distance in
# relative L2 between that step and the fp32 step from the same weights,
# plus DP_AMP_FLOOR (updates) or DP_STAT_L2 (statistics). A flat bound
# does not fit ResNet-50 at its initial weights: bf16 rounding alone put
# the synced step's statistics 2.65e-3 and its updates 0.93 (all at once)
# from the one-process step's, and the AMP step's updates 1.25 from the
# fp32 step's (measured on one H100)
DP_RN_B = AMP_B
DP_RN_SHIFT = (3.0, 1.0)
DP_STAT_L2 = 1e-3
DP_AMP_FLOOR = 1e-3
# the kernels each arm must launch in bf16
DP_ARM_KERNELS = {
    "bert": {"causal_prefill_attention", "attention_backward",
             "layer_norm_act", "layer_norm_act_backward", "softmax_xent_fwd",
             "softmax_xent_bwd"},
    "sync_bn": {"bn_apply_act", "bn_apply_act_backward_sums",
                "bn_apply_act_backward_chain", "softmax_xent_fwd",
                "softmax_xent_bwd"},
    "wmt_dropout": {"layer_norm_act", "layer_norm_act_backward"},
    "sp_resnet": {"bn_apply_act", "bn_apply_act_backward_sums",
                  "bn_apply_act_backward_chain", "softmax_xent_fwd",
                  "softmax_xent_bwd"}}


def _dp_rn_build(pt):
    """(f)'s network: `_rn50_amp`."""
    return _rn50_amp(pt)


def _dp_rn_feed(world):
    """(f)'s seeded global batch, NHWC; the last rank's rows scaled and
    shifted (DP_RN_SHIFT), so the shards differ in distribution."""
    rng = np.random.default_rng(SEED + 29)
    img = rng.standard_normal((DP_RN_B, RN_HW, RN_HW, 3)).astype(np.float32)
    k = DP_RN_B // world
    img[(world - 1) * k:] = img[(world - 1) * k:] * DP_RN_SHIFT[0] \
        + DP_RN_SHIFT[1]
    return {"img": img,
            "label": rng.integers(0, RN_CLASSES, (DP_RN_B, 1)).astype(np.int32)}


def _dp_rn_fp32_program():
    """(f)'s network under plain Momentum(RN_FALL_LR, RN_MU), fp32."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        loss = _dp_rn_build(pt)
        pt.optimizer.Momentum(RN_FALL_LR, RN_MU).minimize(loss)
    startup.random_seed = SEED
    return main, startup, loss


def _bn_running(main):
    return sorted({op.input(s_)[0] for op in main.global_block.ops
                   if op.type in ("batch_norm", "conv2d_bn")
                   for s_ in ("Mean", "Variance")})


def _flat_update(scope, p0, names):
    return torch.cat([(scope.find_var(n).float() - p0[n].float()).reshape(-1)
                      for n in names])


def _updates(scope, p0, names):
    return {n: scope.find_var(n).float() - p0[n].float() for n in names}


def _dp_rn_refs(dev, feed):
    """Rank 0's one-process references of (f) on the card: the B=DP_RN_B
    AMP step's parameter updates and running statistics, and each one's
    AMP band (twice its distance from the fp32 step's from the same
    weights, plus DP_AMP_FLOOR or DP_STAT_L2); both steps' losses."""
    import paddle_tpu_torch as pt

    main, startup, loss = _amp_program(_dp_rn_build, False)
    names = [p_.name for p_ in main.all_parameters()]
    stat_names = _bn_running(main)
    exe, scope = pt.Executor(dev), pt.Scope()
    exe.run(startup, scope=scope)
    p0 = {n: scope.find_var(n).clone() for n in names}
    (l1,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    return_numpy=False)
    upd = _updates(scope, p0, names)
    stats = {n: scope.find_var(n).clone() for n in stat_names}
    del exe, scope
    torch.cuda.empty_cache()
    main32, startup32, loss32 = _dp_rn_fp32_program()
    exe, scope = pt.Executor(dev), pt.Scope()
    exe.run(startup32, scope=scope)
    for n in names:
        scope.set_var(n, p0[n].clone())
    (l32,) = exe.run(main32, feed=feed, fetch_list=[loss32], scope=scope,
                     return_numpy=False)
    upd32 = _updates(scope, p0, names)
    band = {n: 2.0 * _rel_l2(upd[n], upd32[n]) + DP_AMP_FLOOR for n in names}
    band.update({n: 2.0 * _rel_l2(stats[n], scope.find_var(n)) + DP_STAT_L2
                 for n in stat_names})
    flat32 = _rel_l2(torch.cat([upd[n].reshape(-1) for n in names]),
                     torch.cat([upd32[n].reshape(-1) for n in names]))
    del exe, scope, upd32
    torch.cuda.empty_cache()
    return dict(p0=p0, upd=upd, stats=stats, loss=float(l1), band=band,
                flat32=flat32, loss32=float(l32))


def _dp_rn_misses(upd, stats, refs):
    """{name: distance / its band} of every update and statistic, and the
    updates' distance all at once."""
    ratio = {n: _rel_l2(u, refs["upd"][n]) / refs["band"][n]
             for n, u in upd.items()}
    ratio.update({n: _rel_l2(v, refs["stats"][n]) / refs["band"][n]
                  for n, v in stats.items()})
    flat = _rel_l2(torch.cat([upd[n].reshape(-1) for n in upd]),
                   torch.cat([refs["upd"][n].reshape(-1) for n in upd]))
    return ratio, flat


def _dp_sync_bn_arm(dev, mesh, rank, world, result, checks):
    """(f): the synced step on each rank's rows, held on rank 0 against the
    one-process step (each update and running statistic within its AMP
    band); the local-statistics variant (the sync's allreduces skipped:
    `nn_ops._sync_group` answers no group) from the same weights must fail
    both holds: some update and some statistic beyond their bands."""
    import torch.distributed as dist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import nn_ops

    feed = _dp_rn_feed(world)
    local = mesh.shard_feed(feed)
    refs = _dp_rn_refs(dev, feed) if rank == 0 else None
    dist.barrier()
    main, startup, loss = _amp_program(_dp_rn_build, False)
    names = [p_.name for p_ in main.all_parameters()]
    stat_names = _bn_running(main)
    target = pt.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=mesh)
    exe = pt.Executor(dev)
    out = {}
    for run in ("sync", "local"):
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        p0 = {n: scope.find_var(n).clone() for n in names}
        if refs is not None and any(not torch.equal(p0[n], refs["p0"][n])
                                    for n in names):
            raise RuntimeError("(f) the rank's startup differs from the "
                               "reference's")
        saved = nn_ops._sync_group
        if run == "local":
            nn_ops._sync_group = lambda ctx: None
        try:
            res = _dp_step(exe, target, local, scope, loss)
        finally:
            nn_ops._sync_group = saved
        if run == "sync":
            rec = result["arms"].setdefault("sync_bn", {})
            _dp_record(rec, *res[2:])
            rec.setdefault("loss", []).append(res[0])
            by = res[3]["by_what"]
            ms = {k: 1e3 * (v["host_s"] + v["wait_s"]) for k, v in by.items()}
            rec["stats_ms"] = ms.get("sync batch norm stats", 0.0) + ms.get(
                "sync batch norm sums", 0.0)
            rec["stats_calls"] = sum(by.get(k, {}).get("calls", 0) for k in (
                "sync batch norm stats", "sync batch norm sums"))
            rec["grad_ms"] = ms.get("c_allreduce_sum", 0.0)
            result["expected_launches"]["sync_bn"] = _expected_launches(
                exe._program_for(target))
            sums = _dp_gather_sum(torch.cat([scope.find_var(n).reshape(-1)
                                             for n in names]))
            if len(set(sums)) != 1:
                raise RuntimeError(f"(f) ranks hold different parameters "
                                   f"after the synced step: {sums}")
        if rank == 0:
            out[run] = _dp_rn_misses(
                _updates(scope, p0, names),
                {n: scope.find_var(n).clone() for n in stat_names}, refs) + (
                res[0],)
        del scope, p0
        torch.cuda.empty_cache()
    if rank != 0:
        return

    def worst(ratio, keys):
        return max((ratio[n], n) for n in keys)

    w = {run: (worst(r, names), worst(r, stat_names), flat, lv)
         for run, (r, flat, lv) in out.items()}
    (u, un), (st, sn), flat, lv = w["sync"]
    (lu, lun), (ls, lsn), lflat, llv = w["local"]
    said = (f"synced step: worst update {un} at {u:.3f} of its band, worst "
            f"statistic {sn} at {st:.3f} of its band, updates {flat:.3e} from "
            f"the one-process step's all at once (the AMP step's from the "
            f"fp32 step's {refs['flat32']:.3e}), loss {lv:.6f} vs "
            f"{refs['loss']:.6f}; the local-statistics variant: worst update "
            f"{lun} at {lu:.3f} of its band, worst statistic {lsn} at "
            f"{ls:.3f}, updates {lflat:.3e} all at once, loss {llv:.6f}")
    print(f"(f) {said}")
    if not (u <= 1 and st <= 1):
        raise RuntimeError(f"(f) {said}")
    if not min(lu, ls) > 1:
        raise RuntimeError(f"(f) the local-statistics variant passed a hold: "
                           f"{said}")
    result["sync_bn_margins"] = [lu, ls]
    checks.append(
        f"(f) ResNet-50 AMP B={DP_RN_B} (B={DP_RN_B // world} a rank, the "
        f"last rank's images x{DP_RN_SHIFT[0]} +{DP_RN_SHIFT[1]}) with synced "
        f"batch statistics, {len(names)} updates and {len(stat_names)} "
        f"running statistics each within its AMP band: {said}")


def _wmt_dropout_cfg():
    import dataclasses

    from paddle_tpu_torch.models import transformer

    return dataclasses.replace(transformer.wmt_base(), **{
        k: v for k, v in WMT_BASE.items() if k != "dropout"})


def _wmt_fp32_program(cfg, S):
    """`_wmt_program` without AMP: transformer_wmt + Adam(TRAIN_LR)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import transformer

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        avg_loss, _ = transformer.transformer_wmt(
            cfg, src_len=S, tgt_len=S, label_smooth_eps=WMT_EPS)
        pt.optimizer.Adam(learning_rate=TRAIN_LR).minimize(avg_loss)
    startup.random_seed = main.random_seed = SEED
    return main, startup, avg_loss


def _dp_wmt_refs(dev, cfg, feed):
    """Rank 0's one-process references of (g) at rng_counter 1: every
    dropout Mask, the step-1 gradients of the AMP program and the AMP band
    (twice their distance from the fp32 program's on the same weights and
    the same masks, plus DP_AMP_FLOOR)."""
    import paddle_tpu_torch as pt

    out = {}
    for kind in ("amp", "fp32"):
        main, startup, loss = (_wmt_program(cfg, WMT_S) if kind == "amp"
                               else _wmt_fp32_program(cfg, WMT_S))
        names = [p_.name for p_ in main.all_parameters()]
        masks = [m for _, _, m in _dropout_sites(main)]
        exe, scope = pt.Executor(dev), pt.Scope()
        exe.run(startup, scope=scope)
        if kind == "fp32":
            for n in names:
                scope.set_var(n, out["p0"][n].clone())
        else:
            out["p0"] = {n: scope.find_var(n).clone() for n in names}
        vals = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                       fetch_list=[loss] + [n + "@GRAD" for n in names]
                       + masks, rng_counter=1)
        out[kind] = dict(loss=float(vals[0]),
                         grads=torch.cat([v.float().reshape(-1) for v in
                                          vals[1:1 + len(names)]]),
                         masks=list(vals[1 + len(names):]))
        del exe, scope, vals
        torch.cuda.empty_cache()
    out["band"] = (2.0 * _rel_l2(out["amp"]["grads"], out["fp32"]["grads"])
                   + DP_AMP_FLOOR)
    return out


def _dp_wmt_dropout_arm(dev, mesh, rank, world, result, checks):
    """(g): wmt_base() with dropout 0.1 under AMP at WMT_DROP_B global,
    with_data_parallel at rng_counter 1: every dropout Mask, gathered over
    the ranks, is the one-process run's bit for bit, and the step-1
    gradients follow the one-process run's within the AMP band; a
    per-rank draw (the rule's mark ignored: each rank draws its own rows'
    numbers) must fail the mask hold."""
    import torch.distributed as dist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import collective_ops as co
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.ops import registry

    cfg = _wmt_dropout_cfg()
    feed = _wmt_feed(cfg, WMT_DROP_B, WMT_S)
    local = mesh.shard_feed(feed)
    refs = _dp_wmt_refs(dev, cfg, feed) if rank == 0 else None
    dist.barrier()
    main, startup, loss = _wmt_program(cfg, WMT_S)
    names = [p_.name for p_ in main.all_parameters()]
    masks = [m for _, _, m in _dropout_sites(main)]
    target = pt.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=mesh)
    exe = pt.Executor(dev)
    got = {}
    for run in ("global", "per_rank"):
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        saved = registry.ExecContext.draw
        if run == "per_rank":
            registry.ExecContext.draw = \
                lambda self, fn, shape: fn(tuple(shape))
        try:
            ck.reset_launch_counts()
            co.reset_comm_stats(timing=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            vals = exe.run(target, feed=local, scope=scope,
                           return_numpy=False, rng_counter=1,
                           fetch_list=[loss] + [n + "@GRAD" for n in names]
                           + masks)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            registry.ExecContext.draw = saved
        if run == "global":
            rec = result["arms"].setdefault("wmt_dropout", {})
            _dp_record(rec, ms, co.comm_stats(),
                       {w: by for w, by in ck.launch_counts_by_dtype().items()
                        if by}, torch.cuda.max_memory_allocated() / 2**30)
            rec.setdefault("loss", []).append(float(vals[0]))
            result["expected_launches"]["wmt_dropout"] = _expected_launches(
                exe._program_for(target))
            got["grads"] = torch.cat([v.float().reshape(-1)
                                      for v in vals[1:1 + len(names)]])
        got[run] = list(vals[1 + len(names):])
        del scope, vals
        torch.cuda.empty_cache()
    if rank != 0:
        return
    differ = [m for m, a, b in zip(masks, got["global"], refs["amp"]["masks"])
              if not torch.equal(a, b)]
    if differ:
        raise RuntimeError(f"(g) {len(differ)} of {len(masks)} dropout masks "
                           f"differ from the one-process run's, e.g. "
                           f"{differ[0]}")
    planted = sum(not torch.equal(a, b) for a, b in
                  zip(got["per_rank"], refs["amp"]["masks"]))
    if not planted:
        raise RuntimeError("(g) the per-rank draw passed the mask hold")
    d = _rel_l2(got["grads"], refs["amp"]["grads"])
    if not d <= refs["band"]:
        raise RuntimeError(f"(g) step-1 gradients {d:.3e} from the "
                           f"one-process run's in relative L2 (AMP band "
                           f"{refs['band']:.3e})")
    n_el = sum(m.numel() for m in refs["amp"]["masks"])
    checks.append(
        f"(g) WMT wmt_base() AMP dropout {cfg.dropout} B={WMT_DROP_B} "
        f"(B={WMT_DROP_B // world} a rank) src=tgt={WMT_S}: all {len(masks)} "
        f"dropout masks ({n_el} elements) bit for bit the one-process run's; "
        f"step-1 gradients {d:.3e} from its in relative L2 (AMP band "
        f"{refs['band']:.3e}); the per-rank draw refused ({planted} of "
        f"{len(masks)} masks differ)")


# -- tensor parallelism: dp_gloo2's arms (h)-(j), the shard shapes' kernels --

# (h): bench.py:112's BERT-base AMP (S = AMP_S, decorate(Adam(TRAIN_LR)),
# dropout 0, use_tp) Megatron-split over TP_RANKS = 2 under
# with_data_parallel at the global batch TP_B: each forward and backward
# moves ~48 allreduces of [TP_B S, 768] bf16 through gloo's host-staged ring,
# so the batch is 32, not 128
TP_B = 32
TP_RANKS = 2
# the fc biases drawn N(0, TP_BIAS_STD^2) from one seed on every rank and in
# the references: at their zero init a bias added on every rank before the
# row-parallel sum would not show
TP_BIAS_STD = 0.5
# the vocab-parallel loss (K6 on each rank's 15261 classes, the row
# statistics reduced over tp) against the one-process step's (K6 on all)
TP_LOSS_RTOL = 1e-3
TP_FAULTS = ("skip_row_sums", "bias_before_sum")
# (i): a generated token off the tp = 1 engine's must sit where the tp = 1
# top-2 logit gap is below this share of the row's max-abs logit; the
# teacher-forced logits agree within this share of the row's max-abs
TP_SERVE_RTOL = 1e-4
# (j): ring attention at B = 2, nh = 12, global S = RING_S split over the
# ranks, dh = 64, against K10/K11 on the whole sequence (fp32: relative L2)
RING_B, RING_NH, RING_S, RING_DH = 2, 12, 8192, 64
RING_L2 = 1e-4
RING_ID = 5


def _tp_cfg():
    import dataclasses

    return dataclasses.replace(_bert_cfg(AMP_S), use_tp=True)


def _tp_fp32_program(cfg):
    """`_dp_program(cfg, "plain")` without AMP: bert_pretrain + Adam."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import transformer

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        avg_loss, _ = transformer.bert_pretrain(cfg, seq_len=AMP_S)
        pt.optimizer.Adam(learning_rate=TRAIN_LR).minimize(avg_loss)
    startup.random_seed = SEED
    return main, startup, avg_loss


def _tp_biases(scope, main):
    """Every fc bias of `main` drawn from one seeded generator."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 30)
    for p in main.all_parameters():
        if p.name.endswith(".b"):
            t = scope.find_var(p.name)
            scope.set_var(p.name, (TP_BIAS_STD * torch.randn(
                tuple(t.shape), generator=g)).to(t.device, t.dtype))


def _plant_tp_fault(fault):
    """Plant `fault` in the Megatron rewrite of this process:
    "skip_row_sums" drops the sum over tp of every row-parallel `mul`'s
    partial output; "bias_before_sum" treats the bias add as linear in the
    partial, so each rank adds the replicated bias before the sum. Returns
    the function that takes it out."""
    from paddle_tpu_torch.parallel import tensor_parallel as tpr

    saved = (tpr._Rewrite.allreduce, tpr._Rewrite._keeps_partial)

    def undo():
        tpr._Rewrite.allreduce, tpr._Rewrite._keeps_partial = saved

    if fault == "skip_row_sums":
        def allreduce(self, name, red="sum", avg=False):
            prod = self.producer.get(name)
            if prod is not None and prod.type == "mul" and red == "sum":
                self.st[name] = None
                return
            saved[0](self, name, red, avg)
        tpr._Rewrite.allreduce = allreduce
    elif fault == "bias_before_sum":
        def keeps(self, op, partial):
            return op.type == "elementwise_add" or saved[1](self, op, partial)
        tpr._Rewrite._keeps_partial = keeps
    return undo


def _flat(d, names):
    return torch.cat([d[n].reshape(-1) for n in names])


def _tp_refs(dev, cfg, feed):
    """Rank 0's one-process references of (h) on the card, from the
    startup's weights with the biases drawn: the AMP step 1's loss and
    updates, and the AMP band of the updates (twice their distance in
    relative L2 from the fp32 step's on the same weights, plus
    DP_AMP_FLOOR)."""
    import paddle_tpu_torch as pt

    out = {}
    for kind in ("amp", "fp32"):
        main, startup, loss = (_dp_program(cfg, "plain") if kind == "amp"
                               else _tp_fp32_program(cfg))
        names = [p.name for p in main.all_parameters()]
        exe, scope = pt.Executor(dev), pt.Scope()
        exe.run(startup, scope=scope)
        if kind == "amp":
            _tp_biases(scope, main)
            p0 = {n: scope.find_var(n).clone() for n in names}
        else:
            for n in names:
                scope.set_var(n, p0[n].clone())
        (lv,) = exe.run(main, feed=feed, scope=scope, fetch_list=[loss],
                        return_numpy=False)
        out[kind] = dict(loss=float(lv), upd={
            n: scope.find_var(n).float() - p0[n].float() for n in names})
        del exe, scope
        torch.cuda.empty_cache()
    out["names"] = names
    out["band"] = (2.0 * _rel_l2(_flat(out["amp"]["upd"], names),
                                 _flat(out["fp32"]["upd"], names))
                   + DP_AMP_FLOOR)
    del out["fp32"]["upd"]
    return out


def _seen_shapes(shapes):
    """Wrap the kernels' entry points in the op modules so that each call
    records its first operand's shape and dtype in `shapes`; returns the
    undo."""
    from paddle_tpu_torch.ops import attention_ops, nn_ops

    saved = []
    for mod, name in ((attention_ops, "causal_prefill_attention"),
                      (attention_ops, "attention_backward"),
                      (nn_ops, "softmax_xent_fwd"),
                      (nn_ops, "softmax_xent_bwd"),
                      (attention_ops, "paged_decode_attention")):
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def rec(*a, _fn=fn, _name=name, **k):
            if a[0].device.type != "meta":   # not a shape inference run
                shapes.setdefault(_name, set()).add(
                    (tuple(a[0].shape), str(a[0].dtype).replace("torch.", "")))
            return _fn(*a, **k)
        setattr(mod, name, rec)

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return undo


def _tp_run(dev, cfg, feed, mesh, fault=None, timed=False, shapes=None,
            built=None):
    """A fresh run (a new executor and its own clone, a new scope) of (h)'s
    program, `built` where given, over `mesh` from the startup's weights
    (biases drawn), `fault` planted: step 1, and with `timed` a second,
    recorded step. Returns (loss, the global updates, the layouts, this
    rank's shards consistent with the gathered globals, step 1's and step
    2's _dp_step results, the clone)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel.tensor_parallel import (global_value,
                                                           shard_tensor)

    undo = _plant_tp_fault(fault)
    undo_shapes = _seen_shapes(shapes) if shapes is not None else None
    try:
        main, startup, loss = built or _dp_program(cfg, "plain")
        names = [p.name for p in main.all_parameters()]
        exe, scope = pt.Executor(dev), pt.Scope()
        exe.run(startup, scope=scope)
        _tp_biases(scope, main)
        p0 = {n: scope.find_var(n).clone() for n in names}
        target = pt.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, mesh=mesh)
        step1 = _dp_step(exe, target, feed, scope, loss)
    finally:
        if undo_shapes is not None:
            undo_shapes()
        undo()
    layouts = dict(getattr(scope, "tp_layouts", {}))
    upd = {}
    for n in names:
        t = scope.find_var(n)
        full = global_value(scope, n, t)
        lay = layouts.get(n)
        if lay is not None and not torch.equal(
                t, shard_tensor(full, lay.dim, lay.groups, lay.group.size,
                                lay.group.index)):
            raise RuntimeError(f"(h) {n}: this rank's shard is not its slice "
                               f"of the gathered parameter")
        upd[n] = full.float() - p0[n].float()
    del p0
    step2 = _dp_step(exe, target, feed, scope, loss) if timed else None
    clone = exe._program_for(target)
    del exe, scope
    torch.cuda.empty_cache()
    return step1[0], upd, layouts, step1, step2, clone


def _tp_distances(refs, loss, upd, layouts, world):
    """(the loss's relative distance from the one-process step's, the
    updates' in relative L2 all at once, each rank's shards' in the
    head-strided layout)."""
    from paddle_tpu_torch.parallel.tensor_parallel import shard_tensor

    names = refs["names"]
    want = refs["amp"]["upd"]
    d_loss = abs(loss - refs["amp"]["loss"]) / abs(refs["amp"]["loss"])
    d_upd = _rel_l2(_flat(upd, names), _flat(want, names))
    sharded = [n for n in names if n in layouts]
    per_rank = []
    for r in range(world):
        cut = lambda d: torch.cat([shard_tensor(  # noqa: E731
            d[n], layouts[n].dim, layouts[n].groups, world, r).reshape(-1)
            for n in sharded])
        per_rank.append(_rel_l2(cut(upd), cut(want)))
    return d_loss, d_upd, per_rank


def _tp_bert_arm(dev, rank, world, result, checks):
    """(h): BERT-base AMP under with_data_parallel over {"tp": 2}, the
    Megatron rewrite's clone on each rank (qkv head-strided, the lm head
    and its cross entropy vocab-parallel): step 1's loss and updates
    against the one-process step's on the card, each rank's shards against
    the reference's slices, both planted faults refused; a timed step 2
    with its gloo allreduces, peak memory and launches."""
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import make_mesh

    cfg = _tp_cfg()
    feed = _bert_feed(cfg, TP_B, AMP_S)
    mesh = make_mesh({"tp": world})
    refs = _tp_refs(dev, cfg, feed) if rank == 0 else None
    dist.barrier()
    shapes = {}
    built = _dp_program(cfg, "plain")
    loss, upd, layouts, step1, step2, clone = _tp_run(
        dev, cfg, feed, mesh, timed=True, shapes=shapes, built=built)
    want = _expected_launches(clone)
    rec = result["arms"].setdefault("tp_bert", {})
    for st in (step1, step2):
        _dp_record(rec, *st[2:])
        if {w: by for w, by in st[4].items()} != want:
            raise RuntimeError(f"(h) launches {st[4]}, the clone's ops say "
                               f"{want}")
        rec.setdefault("loss", []).append(st[0])
    result["expected_launches"]["tp_bert"] = want
    nh, H, V = cfg.num_heads, cfg.hidden_size, cfg.vocab_size
    local = (TP_B, nh // world, AMP_S, H // nh)
    seen = {k: sorted(v) for k, v in shapes.items()}
    if seen.get("causal_prefill_attention") != [(local, "bfloat16")] or \
            seen.get("attention_backward") != [(local, "bfloat16")] or \
            seen.get("softmax_xent_fwd") != [((TP_B * AMP_S, V // world),
                                              "bfloat16")] or \
            seen.get("softmax_xent_bwd") != seen.get("softmax_xent_fwd"):
        raise RuntimeError(f"(h) the kernels ran at {seen}, not the shard "
                           f"shapes {local} and [{TP_B * AMP_S}, "
                           f"{V // world}]")
    rec["shapes"] = {k: [list(s) for s, _ in v] for k, v in seen.items()}
    stats = step2[3]
    rec["tp_sums"] = stats["by_what"].get("c_allreduce_sum", {})
    faults = {}
    for fault in TP_FAULTS:
        f_loss, f_upd, _, _, _, _ = _tp_run(dev, cfg, feed, mesh, fault,
                                            built=built)
        if rank == 0:
            faults[fault] = _tp_distances(refs, f_loss, f_upd, layouts, world)
        del f_upd
    if rank != 0:
        return
    d_loss, d_upd, per_rank = _tp_distances(refs, loss, upd, layouts, world)
    band = refs["band"]
    if not (d_loss <= TP_LOSS_RTOL and d_upd <= band
            and max(per_rank) <= band):
        raise RuntimeError(f"(h) step 1: loss {d_loss:.3e} from the "
                           f"one-process step's (limit {TP_LOSS_RTOL}), "
                           f"updates {d_upd:.3e} and each rank's shards "
                           f"{per_rank} in relative L2 (AMP band {band:.3e})")
    margins = {}
    for fault, (fl, fu, fr) in faults.items():
        margins[fault] = max(fl / TP_LOSS_RTOL, fu / band, max(fr) / band)
        if not margins[fault] > 1.0:
            raise RuntimeError(f"(h) the planted fault {fault} passed the "
                               f"holds: loss {fl:.3e}, updates {fu:.3e}, "
                               f"shards {fr}")
    result["tp_fault_margins"] = margins
    n_sharded = sum(int(np.prod(layouts[n].shape)) for n in layouts)
    checks.append(
        f"(h) BERT-base AMP use_tp over tp={world}, B={TP_B} S={AMP_S} "
        f"(biases N(0, {TP_BIAS_STD}^2)): {len(layouts)} vars held sharded "
        f"({n_sharded} elements, qkv head-strided in 3 groups); step-1 loss "
        f"{loss:.6f} vs the one-process {refs['amp']['loss']:.6f} "
        f"({d_loss:.3e}, limit {TP_LOSS_RTOL}: the vocab-parallel K6 against "
        f"K6 over all {V} classes); updates {d_upd:.3e} in relative L2, each "
        f"rank's shards {[f'{x:.3e}' for x in per_rank]} (AMP band "
        f"{band:.3e}); planted faults refused at "
        f"{', '.join(f'{k} {v:.1f}x' for k, v in margins.items())} their "
        f"limits")


def _decode_timer(eng):
    """Time each decode step of `eng` (a device drain at each end):
    returns the list the step times land in."""
    times = []
    inner = eng._decode_once

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out
    eng._decode_once = timed
    return times


def _dense_rows_tp(eng, prompt, out):
    """`_dense_rows` under the engine's tp mesh: the dense full-forward
    program Megatron-split like the serving programs (every rank calls it,
    in one order)."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.compiler import CompiledProgram
    from paddle_tpu_torch.framework import Program, program_guard
    from paddle_tpu_torch.serving import build_full_forward_program
    from paddle_tpu_torch.serving import model as sv_model

    if getattr(eng, "_oracle", None) is None:
        full = Program()
        with program_guard(full, Program()), unique_name.guard():
            io = build_full_forward_program(eng.cfg)
        sv_model.apply_tp_annotations(full, eng.cfg, eng.tp)
        eng._oracle = (CompiledProgram(full).with_data_parallel(
            mesh=eng._mesh), io)
    target, io = eng._oracle
    seq = list(prompt) + list(out)[:-1]
    (lg,) = eng._exe.run(
        target, scope=eng._scope, fetch_list=[io["logits"]],
        return_numpy=False,
        feed={sv_model.TOK_FEED: np.asarray(seq, np.int32)[None, :],
              sv_model.POS_FEED: np.arange(len(seq), dtype=np.int32)[None, :]})
    return lg[0, len(prompt) - 1:].float()


def _tp_engine_drive(eng, prompts, new=None):
    """Rank 0 drives `prompts` and stops the followers, which follow:
    returns rank 0's (rids, wall seconds), None on the others."""
    if eng._ctl.is_leader:
        try:
            return _drive(eng, prompts, new)
        finally:
            eng.stop_followers()
    eng.follow()
    return None


def _swapped_qkv_shards():
    """The planted fault of (i): each rank cuts the fused qkv weights with
    the other rank's index (its heads' q, k, v are the other's, its pools
    and out-projection rows its own). Returns the undo."""
    from paddle_tpu_torch.parallel import tensor_parallel as tpr

    orig = tpr.shard_scope

    def swapped(scope, layouts):
        for name, lay in layouts.items():
            t = scope.find_var(name)
            if ".mha.qkv." in name and t is not None and \
                    tuple(t.shape) == lay.shape:
                scope.set_var(name, tpr.shard_tensor(
                    t, lay.dim, lay.groups, lay.group.size,
                    lay.group.size - 1 - lay.group.index))
        orig(scope, layouts)
    tpr.shard_scope = swapped

    def undo():
        tpr.shard_scope = orig
    return undo


def _tp_serve_arm(dev, rank, world, result, checks):
    """(i): the BERT-base-width decoder (DecoderConfig(), fp32) served with
    tp = 2, prefix cache on, SPMD over the ranks (rank 0 schedules and
    broadcasts each run's feed): rank 0's tokens are the tp = 1 engine's
    (or diverge only at a near-tie, the rest held teacher-forced), rank
    1's equal rank 0's, the dense oracle under tp teacher-forced within
    TP_SERVE_RTOL of the tp = 1 oracle's, the swapped head shards refused;
    ms a decode step against tp = 1, allreduces a step, launches."""
    import torch.distributed as dist

    from paddle_tpu_torch.ops import collective_ops as co
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import ServingEngine

    cfg = _serve_cfg()
    prompts = _serve_prompts(cfg, SEED, SERVE_LENS)
    box = [None, None]
    if rank == 0:
        ref = ServingEngine(cfg, device=dev, seed=SEED)
        _drive(ref, [[1, 2, 3, 4, 5, 6, 7, 8]], 2)
        times1 = _decode_timer(ref)
        rids, _ = _drive(ref, prompts)
        box = [[ref.result(r) for r in rids], statistics.median(times1)]
        rows1 = [_dense_rows(ref, p, o).cpu() for p, o in
                 zip(prompts, box[0])]
        del ref
        torch.cuda.empty_cache()
    dist.broadcast_object_list(box, src=0)
    want, ms1 = box[0], box[1] * 1e3
    eng = ServingEngine(cfg, device=dev, seed=SEED, tp=world)
    _tp_engine_drive(eng, [[1, 2, 3, 4, 5, 6, 7, 8]], 2)
    eng.tp_record = []
    times2 = _decode_timer(eng)
    shapes = {}
    undo = _seen_shapes(shapes)
    ck.reset_launch_counts()
    co.reset_comm_stats()
    try:
        ran = _tp_engine_drive(eng, prompts)
    finally:
        undo()
    launches = {w: by for w, by in ck.launch_counts_by_dtype().items() if by}
    stats = co.comm_stats()
    steps = [len(times2)]
    dist.broadcast_object_list(steps, src=0)
    recs = [None] * world
    dist.all_gather_object(recs, [[np.asarray(o).tolist() for o in r]
                                  for r in eng.tp_record])
    got = [eng.result(r) for r in ran[0]] if ran is not None else None
    rows2 = [_dense_rows_tp(eng, p, o).cpu() for p, o in zip(prompts, want)]
    eng.tp_record = None
    nh = cfg.num_heads // world
    on_card = dev.type == "cuda"   # the CPU rehearsal runs plain versions
    if on_card and (
            launches.get("paged_decode_attention", {}).get("float32")
            != cfg.num_layers * steps[0]
            or not launches.get("causal_prefill_attention", {}).get("float32")
            or not launches.get("layer_norm_act", {}).get("float32")) or \
            {s[0][1] for s in shapes.get("paged_decode_attention", ())} != \
            {nh} or {s[0][1] for s in
                     shapes.get("causal_prefill_attention", ())} != {nh}:
        raise RuntimeError(f"(i) rank {rank}: launches {launches} over "
                           f"{steps[0]} decode steps, shapes {shapes}: K1 "
                           f"{cfg.num_layers} a step and K2 at {nh} heads "
                           f"expected")
    result["tp_serve"] = {"launches": launches, "decode_steps": steps[0],
                          "sums": stats["by_what"].get("c_allreduce_sum", {}),
                          "calls": stats["calls"]}
    del eng
    torch.cuda.empty_cache()
    # the planted fault: the qkv shards swapped between the ranks
    undo = _swapped_qkv_shards()
    try:
        bad = ServingEngine(cfg, device=dev, seed=SEED, tp=world)
        ran_bad = _tp_engine_drive(bad, prompts[:2])
        bad_out = [bad.result(r) for r in ran_bad[0]] if ran_bad else None
    finally:
        undo()
    del bad
    torch.cuda.empty_cache()
    if rank != 0:
        return
    if any(r != recs[0] for r in recs[1:]):
        raise RuntimeError("(i) the ranks' program fetches differ")
    worst = 0.0
    for i, (a, b) in enumerate(zip(rows2, rows1)):
        scale = b.abs().amax(dim=-1, keepdim=True)
        d = float(((a - b).abs() / scale).max())
        worst = max(worst, d)
        if not d <= TP_SERVE_RTOL:
            raise RuntimeError(f"(i) request {i}: the teacher-forced logits "
                               f"under tp {d:.3e} of the row's max-abs from "
                               f"tp = 1's (limit {TP_SERVE_RTOL})")
    ties = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        j = next(k for k, (x, y) in enumerate(zip(g, w)) if x != y)
        top2 = rows1[i][j].topk(2).values
        gap = float(top2[0] - top2[1]) / float(rows1[i][j].abs().max())
        if not gap < TP_SERVE_RTOL:
            raise RuntimeError(f"(i) request {i} token {j}: {g[j]} vs tp = "
                               f"1's {w[j]}, where tp = 1's top-2 gap is "
                               f"{gap:.3e} of the max-abs logit")
        ties += 1
    off = sum(x != y for o, w in zip(bad_out, want[:2]) for x, y in zip(o, w))
    if not off:
        raise RuntimeError("(i) the swapped head shards passed: every token "
                           "equals tp = 1's")
    ms2 = statistics.median(times2) * 1e3
    sums = result["tp_serve"]["sums"]
    result["tp_serve"].update(ms=ms2, ms_tp1=ms1, swapped_off=off)
    checks.append(
        f"(i) DecoderConfig() fp32 served at tp={world} (prefix cache on, "
        f"{len(prompts)} prompts of {list(SERVE_LENS)} tokens, {SERVE_NEW} "
        f"new each): rank 0's tokens the tp = 1 engine's"
        + (f" but {ties} near-ties" if ties else "")
        + f"; rank 1's program fetches rank 0's; the teacher-forced logits "
        f"under tp within {worst:.3e} of the row's max-abs (limit "
        f"{TP_SERVE_RTOL}); {ms2:.2f} ms a decode step (median, {steps[0]} "
        f"steps) against tp = 1's {ms1:.2f}; "
        f"{sums.get('calls', 0) / max(steps[0], 1):.1f} allreduces a decode "
        f"step on average (prefills included); the swapped head shards "
        f"refused ({off} of {sum(len(w) for w in want[:2])} tokens off)")


def _ring_inputs(dev, dtype):
    g = torch.Generator(device="cpu").manual_seed(SEED + 40)
    return [torch.randn((RING_B, RING_NH, RING_S, RING_DH), generator=g)
            .to(dev, dtype) for _ in range(4)]


def _ring_program(dtype, causal):
    """q, k, v and the cotangent as feeds split on their seq dim over the
    ring, L.ring_attention on RING_ID, its grads by append_backward."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L

    main = pt.Program()
    with pt.program_guard(main, pt.Program()), pt.unique_name.guard():
        vs = []
        for n in ("q", "k", "v", "cot"):
            x = L.data(name=n, shape=[RING_NH, RING_S, RING_DH],
                       dtype=dtype)
            x.stop_gradient = n == "cot"
            x.sharding = (None, None, "sp", None)
            vs.append(x)
        out = L.ring_attention(*vs[:3], causal=causal, ring_id=RING_ID)
        pt.backward.append_backward(
            L.reduce_sum(L.elementwise_mul(out, vs[3])))
    return main, [out.name, "q@GRAD", "k@GRAD", "v@GRAD"]


def _ring_arm(dev, rank, world, result, checks):
    """(j): ring_attention over an `sp` ring of the ranks, forward and its
    hand-written backward through a program under with_collective, in fp32
    and bf16, causal and not: out, dQ, dK and dV gathered on rank 0 and
    held against K10/K11 on the whole sequence (fp32 within RING_L2 in
    relative L2; bf16 within K10/K11's own bf16 holds); the causal offset
    taken from the wrong rank refused; ms forward and backward."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import attention_ops as ao
    from paddle_tpu_torch.ops import collective_ops as co
    from paddle_tpu_torch.ops.cuda_kernels import flash_attention as K10
    from paddle_tpu_torch.ops.cuda_kernels import flash_attention_bwd as K11
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel.mesh import get_comm_context

    mesh = make_mesh({"sp": world})
    g = mesh.group("sp")
    sc = RING_DH ** -0.5
    get_comm_context().register_ring(RING_ID, "sp")
    rows, fault_l2 = [], None
    try:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                dname = str(dtype).replace("torch.", "")
                main, fetch = _ring_program(dname, causal)
                glob = _ring_inputs(dev, dtype)
                feed = mesh.shard_feed(dict(zip(("q", "k", "v", "cot"), glob)),
                                       axis="sp", program=main)
                target = pt.CompiledProgram(main).with_collective(mesh=mesh)
                exe = pt.Executor(dev)
                runs = [("held", None)]
                if dtype == torch.float32 and causal:
                    runs.append(("fault", ao._ring_scores))
                for what, orig in runs:
                    if orig is not None:
                        ao._ring_scores = (lambda q32, kb, r, src, s, c,
                                           _o=orig: _o(q32, kb, src, r, s, c))
                    try:
                        local = exe.run(target, feed=feed, fetch_list=fetch,
                                        scope=pt.Scope(), return_numpy=False)
                    finally:
                        if orig is not None:
                            ao._ring_scores = orig
                    parts = [torch.cat(co._all_gather(g, t.contiguous(),
                                                      "ring hold"), dim=2)
                             for t in local]
                    if what == "held":
                        lq, lk, lv, ld = (feed[n] for n in ("q", "k", "v",
                                                            "cot"))
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        o, m, l_ = ao.ring_attention_local(g, lq, lk, lv,
                                                           causal, sc)
                        torch.cuda.synchronize()
                        t1 = time.perf_counter()
                        ao.ring_attention_grad(g, lq, lk, lv, o, m, l_, ld,
                                               causal, sc)
                        torch.cuda.synchronize()
                        t2 = time.perf_counter()
                        del o, m, l_
                    if rank != 0:
                        continue
                    q, k, v, do = glob
                    ref, lse = K10.flash_attention_fwd(q, k, v, causal, sc)
                    refs = [ref, *K11.flash_attention_backward(
                        q, k, v, ref, lse, do, causal, sc)]
                    if what == "fault":
                        fault_l2 = max(_rel_l2(a, b) for a, b in
                                       zip(parts, refs))
                        if not fault_l2 > RING_L2:
                            raise RuntimeError(
                                f"(j) the causal offset from the wrong rank "
                                f"passed ({fault_l2:.3e})")
                        continue
                    if dtype == torch.float32:
                        errs = [_rel_l2(a, b) for a, b in zip(parts, refs)]
                        if not max(errs) <= RING_L2:
                            raise RuntimeError(
                                f"(j) fp32 causal={causal}: out, dQ, dK, dV "
                                f"{errs} from K10/K11 in relative L2 (limit "
                                f"{RING_L2})")
                    else:
                        errs = [_agree16("(j) ring out", parts[0], refs[0])] \
                            + [_agree16(f"(j) ring d{n}", a, b, floor=2e-2)
                               for n, a, b in zip("qkv", parts[1:], refs[1:])]
                    rows.append((dname, causal, errs, (t1 - t0) * 1e3,
                                 (t2 - t1) * 1e3))
                    del ref, lse, refs
                del glob, feed, local, parts, exe
                torch.cuda.empty_cache()
    finally:
        get_comm_context().unregister_ring(RING_ID)
    if rank != 0:
        return
    result["ring"] = {"rows": [[d, c, e, f, b] for d, c, e, f, b in rows],
                      "fault_l2": fault_l2}
    checks.append(
        f"(j) ring_attention over sp={world}, B={RING_B} nh={RING_NH} "
        f"S={RING_S} ({RING_S // world} a rank) dh={RING_DH}: out, dQ, dK, dV "
        f"against K10/K11 on the whole sequence, "
        + "; ".join(f"{d} causal={c}: {', '.join(f'{x:.2e}' for x in e)} "
                    f"({'relative L2' if d == 'float32' else 'max abs'}), "
                    f"{f:.1f} ms forward, {b:.1f} ms backward"
                    for d, c, e, f, b in rows)
        + f"; the causal offset from the wrong rank refused ({fault_l2:.3e} "
        f"in relative L2)")


# (k) and (l): sequence and spatial parallelism over {"sp": 2} on
# dp_gloo2's two ranks; the planted faults of each arm, each refused
SP_BERT_FAULTS = ("own_keys", "sp_average")
SP_RN_FAULTS = ("no_halo", "local_stats")


def _plant_sp_fault(fault):
    """Plant `fault` in this process's sequence-parallel path: "own_keys"
    attends over the rank's own keys only (no gather of Q, K, V);
    "sp_average" averages the parameter gradients over sp where they must
    be summed; "no_halo" pads each rank's own edges with zeros where its
    neighbours' halo rows belong; "local_stats" takes each batch norm's
    statistics over the rank's own rows. Returns the undo."""
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.parallel import spatial

    saved = (spatial._SPRewrite.rule_fused_attention,
             spatial._SPRewrite.allreduce, spatial._halo_gather,
             nn_ops._sp_sync)

    def undo():
        (spatial._SPRewrite.rule_fused_attention, spatial._SPRewrite.allreduce,
         spatial._halo_gather, nn_ops._sp_sync) = saved

    if fault == "own_keys":
        spatial._SPRewrite.rule_fused_attention = \
            lambda self, op, ins: ({}, {("Out", 0): ins[("Q", 0)]})
    elif fault == "sp_average":
        def allreduce(self, name, red="sum", avg=False):
            saved[1](self, name, red, avg or name.endswith("@GRAD"))
        spatial._SPRewrite.allreduce = allreduce
    elif fault == "no_halo":
        spatial._halo_gather = \
            lambda g, slab, what: [torch.zeros_like(slab)] * g.size
    elif fault == "local_stats":
        nn_ops._sp_sync = lambda ctx: None
    elif fault is not None:
        raise ValueError(fault)
    return undo


SP_BERT_B, SP_BERT_S = 16, 512   # (k): bench.py:137's shape at B = 16
SP_RN_B = 32                     # (l): ResNet-50 AMP at 224 x 224, B = 32
SP_RN_SHIFT = (3.0, 1.0)         # (l): the image rows of rank 1, scaled
SP_LOSS_RTOL = 1e-3


def _sp_cfg():
    import dataclasses

    return dataclasses.replace(_bert_cfg(SP_BERT_S), use_tp=False,
                               use_sp=True)


def _sp_bert_program(cfg, amp_=True):
    """(k)'s program: bert_pretrain(cfg) at S = SP_BERT_S under
    decorate(Adam(TRAIN_LR)), or plain Adam for the fp32 reference."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.contrib import mixed_precision as amp
    from paddle_tpu_torch.models import transformer

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        avg_loss, _ = transformer.bert_pretrain(cfg, seq_len=SP_BERT_S)
        opt = pt.optimizer.Adam(learning_rate=TRAIN_LR)
        (amp.decorate(opt) if amp_ else opt).minimize(avg_loss)
    startup.random_seed = SEED
    return main, startup, avg_loss


def _sp_rn_build(pt):
    """(l)'s network: (f)'s, its image's H annotated on `sp` (NHWC: dim
    1), its label on `dp`."""
    loss = _dp_rn_build(pt)
    blk = pt.default_main_program().global_block
    blk.var("img").sharding = ("dp", "sp", None, None)
    blk.var("label").sharding = ("dp", None)
    return loss


def _sp_rn_feed():
    """(l)'s seeded batch, NHWC; the image rows rank 1 holds scaled and
    shifted (SP_RN_SHIFT), so the two shards differ in distribution."""
    rng = np.random.default_rng(SEED + 41)
    img = rng.standard_normal((SP_RN_B, RN_HW, RN_HW, 3)).astype(np.float32)
    h = -(-RN_HW // 2)
    img[:, h:] = img[:, h:] * SP_RN_SHIFT[0] + SP_RN_SHIFT[1]
    return {"img": img, "label": rng.integers(
        0, RN_CLASSES, (SP_RN_B, 1)).astype(np.int32)}


def _sp_grads(main):
    """{parameter: the gradient its optimizer op reads} of `main`."""
    return {op.input("Param")[0]: op.input("Grad")[0]
            for op in main.global_block.ops
            if op.inputs.get("Param") and op.inputs.get("Grad")}


def _sp_run(dev, program, feed, mesh, fault=None, timed=False, shapes=None,
            p_ref=None, grads=False):
    """A fresh run (a new executor, so a new clone of the rewrites, and a
    new scope) of `program()` over `mesh` from its startup's weights
    (held equal to `p_ref` where given), `fault` planted: step 1 (with
    `grads`, fetching the gradients the optimizer reads), and with `timed`
    a second, recorded step. Returns (step 1's _dp_step results, the
    updates, the running statistics, step 2's, the clone)."""
    import paddle_tpu_torch as pt

    undo = _plant_sp_fault(fault)
    undo_shapes = _seen_shapes(shapes) if shapes is not None else None
    try:
        main, startup, loss = program()
        names = [p.name for p in main.all_parameters()]
        exe, scope = pt.Executor(dev), pt.Scope()
        exe.run(startup, scope=scope)
        p0 = {n: scope.find_var(n).clone() for n in names}
        if p_ref is not None and any(not torch.equal(p0[n], p_ref[n])
                                     for n in names):
            raise RuntimeError("the rank's startup differs from the "
                               "one-process reference's")
        target = pt.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, mesh=mesh)
        local = mesh.shard_feed(feed, program=main, strict=False)
        step1 = _dp_step(exe, target, local, scope, loss,
                         [_sp_grads(main)[n] for n in names] if grads
                         else ())
    finally:
        if undo_shapes is not None:
            undo_shapes()
        undo()
    upd = _updates(scope, p0, names)
    stats = {n: scope.find_var(n).clone() for n in _bn_running(main)}
    del p0
    step2 = _dp_step(exe, target, local, scope, loss) if timed else None
    clone = exe._program_for(target)
    del exe, scope
    torch.cuda.empty_cache()
    return step1, upd, stats, step2, clone


def _sp_bert_refs(dev, cfg, feed):
    """Rank 0's one-process references of (k) on the card: the AMP step's
    loss, gradients and updates from the startup's weights; PR 28's AMP
    band of the updates (twice their distance, all at once, in relative
    L2 from the fp32 step's from the same weights, plus DP_AMP_FLOOR),
    within which each parameter's update is held (a band of its own would
    refuse the sign flip of a near-zero gradient, which moves a layer
    norm's update by 2 lr in one element); and the gradients' band, all
    at once, AMP_GRAD_BAND's (twice their distance from the fp32 step's
    plus 2e-2: the split rounds each bf16 reduction over the tokens once
    a rank where the one process rounds it once, lm_head.w's GEMM among
    them). Adam's first update is the gradient's sign, blind to its scale,
    so the gradients are held too; not each in a band of its own: a bias
    gradient's partial sums cancel (1.25x its own AMP-to-fp32 distance at
    layer 11's ffn.out.b on the card)."""
    import paddle_tpu_torch as pt

    out = {}
    for kind in ("amp", "fp32"):
        main, startup, loss = _sp_bert_program(cfg, kind == "amp")
        names = [p.name for p in main.all_parameters()]
        exe, scope = pt.Executor(dev), pt.Scope()
        exe.run(startup, scope=scope)
        if kind == "amp":
            p0 = {n: scope.find_var(n).clone() for n in names}
        else:
            for n in names:
                scope.set_var(n, p0[n].clone())
        gn = _sp_grads(main)
        lv, *gs = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                          fetch_list=[loss] + [gn[n] for n in names])
        out[kind] = dict(loss=float(lv), upd=_updates(scope, p0, names),
                         grad=dict(zip(names, gs)))
        del exe, scope
        torch.cuda.empty_cache()
    out["p0"] = p0
    out["amp_fp32_grad"] = {n: float((out["amp"]["grad"][n].float()
                                      - out["fp32"]["grad"][n].float()).norm())
                            for n in names}
    out["upd_band"] = 2.0 * _rel_l2(_flat(out["amp"]["upd"], names),
                                    _flat(out["fp32"]["upd"], names)) \
        + DP_AMP_FLOOR
    out["grad_band"] = AMP_GRAD_BAND[0] * _rel_l2(
        _flat(out["amp"]["grad"], names), _flat(out["fp32"]["grad"], names)) \
        + AMP_GRAD_BAND[1]
    del out["fp32"]
    return out


def _sp_bert_misses(refs, loss, upd, grads):
    """(the loss's relative distance from the one-process step's over its
    limit, the worst distance over its band, its name): the gradients all
    at once, and the updates, each parameter's and all at once, on the
    elements of sure sign (the one-process gradient past a fifth of its
    max-abs and 30 ADAM_EPS_HAT, `_hold_adam_step1`'s: elsewhere Adam's
    first update, lr sign(g), flips with the sums' order: over every
    element the updates sat at 0.79 of the band on an H100 at BERT-base)."""
    ref_u, ref_g = refs["amp"]["upd"], refs["amp"]["grad"]
    names = list(upd)
    d_loss = abs(loss - refs["amp"]["loss"]) / abs(refs["amp"]["loss"])
    rows = [(_rel_l2(torch.cat([g.reshape(-1) for g in grads]),
                     _flat(ref_g, names)) / refs["grad_band"],
             "the gradients all at once")]
    got, want = [], []
    for n in names:
        a = ref_g[n].abs().float()
        sure = (a > 0.2 * a.max()) & (a > 30 * ADAM_EPS_HAT)
        if bool(sure.any()):
            got.append(upd[n][sure])
            want.append(ref_u[n][sure])
            rows.append((_rel_l2(got[-1], want[-1]) / refs["upd_band"],
                         f"{n} update"))
    rows.append((_rel_l2(torch.cat(got), torch.cat(want)) / refs["upd_band"],
                 "the updates all at once"))
    worst = max(rows)
    return d_loss / SP_LOSS_RTOL, worst[0], worst[1]


def _sp_same_loss(loss, what):
    """Every rank's fetched loss, which must be one value."""
    import torch.distributed as dist

    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, float(loss))
    if len(set(got)) != 1:
        raise RuntimeError(f"{what}: the ranks fetched different losses {got}")
    return got


def _sp_comm(stats, names):
    """(calls, MB, ms of host-staged gloo plus the stream waits) of the
    collectives `names` in a step's comm_stats."""
    by = stats["by_what"]
    return (sum(by.get(n, {}).get("calls", 0) for n in names),
            sum(by.get(n, {}).get("bytes", 0) for n in names) / 2**20,
            1e3 * sum(by.get(n, {}).get("host_s", 0.0)
                      + by.get(n, {}).get("wait_s", 0.0) for n in names))


def _sp_bert_arm(dev, rank, world, result, checks):
    """(k): BERT-base AMP with use_sp over {"sp": 2} at B = SP_BERT_B, S =
    SP_BERT_S: each rank holds S / 2 tokens of each sequence, gathers Q, K
    and V for the attention (K2/K4 at the full S) and sums its parameter
    gradients over sp. Step 1's loss and every update against the
    one-process step's on the card (rank 0), the ranks' fetched losses
    equal, both planted faults refused; a timed step 2."""
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    cfg = _sp_cfg()
    feed = _bert_feed(cfg, SP_BERT_B, SP_BERT_S)
    mesh = make_mesh({"sp": world})
    refs = _sp_bert_refs(dev, cfg, feed) if rank == 0 else None
    dist.barrier()
    shapes = {}
    built = _sp_bert_program(cfg)
    program = lambda: built   # noqa: E731  (each run makes its own clone)
    step1, upd, _, step2, clone = _sp_run(
        dev, program, feed, mesh, timed=True, shapes=shapes,
        p_ref=None if refs is None else refs["p0"], grads=True)
    losses = _sp_same_loss(step1[0], "(k)")
    want = _expected_launches(clone)
    rec = result["arms"].setdefault("sp_bert", {})
    for st in (step1, step2):
        _dp_record(rec, *st[2:])
        if st[4] != want:
            raise RuntimeError(f"(k) launches {st[4]}, the clone's ops say "
                               f"{want}")
        rec.setdefault("loss", []).append(st[0])
    result["expected_launches"]["sp_bert"] = want
    B, nh, S, H = SP_BERT_B, cfg.num_heads, SP_BERT_S, cfg.hidden_size
    full = (B, nh, S, H // nh)
    rows = B * (S // world)
    seen = {k: sorted(v) for k, v in shapes.items()}
    if seen.get("causal_prefill_attention") != [(full, "bfloat16")] or \
            seen.get("attention_backward") != [(full, "bfloat16")] or \
            seen.get("softmax_xent_fwd") != [((rows, cfg.vocab_size),
                                              "bfloat16")]:
        raise RuntimeError(f"(k) the kernels ran at {seen}, not the gathered "
                           f"attention {full} and the rank's {rows} rows")
    rec["shapes"] = {k: [list(s) for s, _ in v] for k, v in seen.items()}
    rec["sp_comm"] = {
        "gathers": _sp_comm(step2[3], ("sp_gather",)),
        "sums": _sp_comm(step2[3], ("c_allreduce_sum",))}
    faults = {}
    for fault in SP_BERT_FAULTS:
        f1, f_upd, _, _, _ = _sp_run(dev, program, feed, mesh, fault,
                                     grads=True)
        if rank == 0:
            faults[fault] = _sp_bert_misses(refs, f1[0], f_upd, f1[1])
        del f_upd, f1
    if rank != 0:
        return
    d_loss, d_upd, worst = _sp_bert_misses(refs, step1[0], upd, step1[1])
    # the parameters that carry most of the gradients' distance, beside
    # their AMP-to-fp32 distance (absolute L2)
    dist = sorted(((float((g.float() - refs["amp"]["grad"][n].float())
                          .norm()), n) for n, g in zip(upd, step1[1])),
                  reverse=True)[:3]
    largest = ", ".join(f"{n} {d:.3e} ({refs['amp_fp32_grad'][n]:.3e})"
                        for d, n in dist)
    if not (d_loss <= 1 and d_upd <= 1):
        raise RuntimeError(f"(k) step 1: loss {step1[0]:.6f} vs the one-"
                           f"process {refs['amp']['loss']:.6f} at "
                           f"{d_loss:.3f} of its limit {SP_LOSS_RTOL}; the "
                           f"worst {worst} at {d_upd:.3f} of its band")
    margins = {}
    for fault, (fl, fu, fw) in faults.items():
        margins[fault] = max(fl, fu)
        if not margins[fault] > 1.0:
            raise RuntimeError(f"(k) the planted fault {fault} passed the "
                               f"holds: loss at {fl:.3f} of its limit, "
                               f"worst {fw} at {fu:.3f} of its band")
    result["sp_bert_margins"] = margins
    checks.append(
        f"(k) BERT-base AMP use_sp over sp={world}, B={B} S={S} ({S // world} "
        f"tokens of each sequence a rank; attention on Q, K, V gathered to "
        f"{list(full)}): step-1 loss {step1[0]:.6f} on both ranks {losses} "
        f"vs the one-process {refs['amp']['loss']:.6f} ({d_loss:.3f} of the "
        f"limit {SP_LOSS_RTOL}); the worst of every gradient and update, "
        f"{worst}, at {d_upd:.3f} of its AMP band (updates "
        f"{refs['upd_band']:.3e}, gradients {refs['grad_band']:.3e}; the "
        f"gradients' largest distances in L2, beside the AMP step's from the "
        f"fp32 step's: {largest}); planted faults refused at "
        f"{', '.join(f'{k} {v:.1f}x' for k, v in margins.items())} their "
        f"limits; the arm {time.perf_counter() - t0:.1f} s")


def _sp_rn_arm(dev, rank, world, result, checks):
    """(l): ResNet-50 AMP (s2d stem, NHWC, 224 x 224) spatially partitioned
    over {"sp": 2} at B = SP_RN_B: each rank holds its ceil share of every
    feature map's rows (the last stage's 7 as 4 + 3), its convolutions and
    pools read their halo rows from the other rank, its batch norms take
    their statistics over both ranks (K8; K9's split mode). Step 1's loss,
    every update and running statistic each within its AMP band of the
    one-process step's (rank 0; the loss's floor SP_LOSS_RTOL), both
    planted faults refused; a timed step 2 with its halo exchanges and
    statistics allreduces."""
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    feed = _sp_rn_feed()
    mesh = make_mesh({"sp": world})
    refs = _dp_rn_refs(dev, feed) if rank == 0 else None
    dist.barrier()
    built = _amp_program(_sp_rn_build, False)
    program = lambda: built   # noqa: E731  (each run makes its own clone)
    step1, upd, stats, step2, clone = _sp_run(
        dev, program, feed, mesh, timed=True,
        p_ref=None if refs is None else refs["p0"])
    losses = _sp_same_loss(step1[0], "(l)")
    want = _expected_launches(clone)
    rec = result["arms"].setdefault("sp_resnet", {})
    for st in (step1, step2):
        _dp_record(rec, *st[2:])
        if st[4] != want:
            raise RuntimeError(f"(l) launches {st[4]}, the clone's ops say "
                               f"{want}")
        rec.setdefault("loss", []).append(st[0])
    result["expected_launches"]["sp_resnet"] = want
    from paddle_tpu_torch.parallel.mesh import ceil_range

    splits = sorted({m["extent_out"] for op in clone.global_block.ops
                     for m in [getattr(op, "sp_halo", None)]
                     if m and not m.get("global")}, reverse=True)
    splits = [f"{h} = " + " + ".join(
        str(b - a) for a, b in (ceil_range(h, world, r) for r in range(world)))
        for h in splits]
    rec["sp_comm"] = {
        "halo": _sp_comm(step2[3], ("sp halo", "sp halo grad")),
        "stats": _sp_comm(step2[3], ("sync batch norm stats",
                                     "sync batch norm sums")),
        "sums": _sp_comm(step2[3], ("c_allreduce_sum", "sp global pool"))}
    faults = {}
    for fault in SP_RN_FAULTS:
        f1, f_upd, f_stats, _, _ = _sp_run(dev, program, feed, mesh, fault)
        if rank == 0:
            faults[fault] = _dp_rn_misses(f_upd, f_stats, refs) + (f1[0],)
        del f_upd, f_stats
    if rank != 0:
        return
    ratio, flat = _dp_rn_misses(upd, stats, refs)
    d_loss = abs(step1[0] - refs["loss"]) / abs(refs["loss"])
    # the loss in its AMP band, as the updates: twice the AMP step's
    # distance from the fp32 step's, plus SP_LOSS_RTOL (bf16 ResNet-50 at
    # its initial weights moves the loss 2.0e-3 on the split alone)
    loss_band = 2.0 * abs(refs["loss"] - refs["loss32"]) / abs(
        refs["loss"]) + SP_LOSS_RTOL
    worst = max((v, n) for n, v in ratio.items())
    said = (f"loss {step1[0]:.6f} on both ranks {losses} vs the one-process "
            f"{refs['loss']:.6f} ({d_loss:.3e}; its AMP band {loss_band:.3e}"
            f", the fp32 step's {refs['loss32']:.6f}); worst "
            f"of {len(ratio)} updates and running statistics {worst[1]} at "
            f"{worst[0]:.3f} of its band; updates {flat:.3e} from the "
            f"one-process step's all at once (the AMP step's from the fp32 "
            f"step's {refs['flat32']:.3e})")
    print(f"(l) {said}")
    if not (d_loss <= loss_band and worst[0] <= 1):
        raise RuntimeError(f"(l) {said}")
    margins = {}
    for fault, (fr, _, fl) in faults.items():
        fw = max((v, n) for n, v in fr.items())
        margins[fault] = max(abs(fl - refs["loss"]) / abs(refs["loss"])
                             / loss_band, fw[0])
        if not margins[fault] > 1.0:
            raise RuntimeError(f"(l) the planted fault {fault} passed the "
                               f"holds: loss {fl:.6f}, worst {fw[1]} at "
                               f"{fw[0]:.3f} of its band")
    result["sp_rn_margins"] = margins
    checks.append(
        f"(l) ResNet-50 AMP s2d NHWC {RN_HW}x{RN_HW} spatially partitioned "
        f"over sp={world}, B={SP_RN_B} (rank 1's image rows x"
        f"{SP_RN_SHIFT[0]} +{SP_RN_SHIFT[1]}; the window ops' output rows "
        f"split {splits}): {said}; planted "
        f"faults refused at "
        f"{', '.join(f'{k} {v:.1f}x' for k, v in margins.items())} their "
        f"limits; the arm {time.perf_counter() - t0:.1f} s")


def check_sp_shards(dev, timer, card):
    """The kernels at (k)'s and (l)'s shard shapes that no earlier check
    times, against their plain versions, beside their bound and the
    library call: K2/K4 bf16 at the gathered [SP_BERT_B, 12, SP_BERT_S,
    64]; K3/K5 and K6/K7 bf16 at the rank's SP_BERT_B * SP_BERT_S / 2
    rows; K8 and K9's split mode bf16 at ResNet-50's last stage under the
    ceil split, SP_RN_B images of 4 (rank 0) and 3 (rank 1) of its 7 rows
    of 7, the bottleneck's last batch norm (2048 channels, relu, the
    residual)."""
    from paddle_tpu_torch.ops.cuda_kernels import attention_bwd as K4
    from paddle_tpu_torch.ops.cuda_kernels import bn_apply as K8
    from paddle_tpu_torch.ops.cuda_kernels import bn_apply_bwd as K9
    from paddle_tpu_torch.ops.cuda_kernels import layer_norm as K3
    from paddle_tpu_torch.ops.cuda_kernels import layer_norm_bwd as K5
    from paddle_tpu_torch.ops.cuda_kernels import prefill_attention as K2
    from paddle_tpu_torch.ops.cuda_kernels import xent_bwd as K7
    from paddle_tpu_torch.ops.cuda_kernels import xent_fwd as K6
    import torch.nn.functional as F

    bf = torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(SEED + 42)

    def rnd(*shape, scale=1.0, shift=0.0, dtype=bf):
        return (scale * torch.randn(shape, generator=g) + shift).to(dev, dtype)

    B, nh, S, dh = SP_BERT_B, 12, SP_BERT_S, 64
    q, k, v, do = (rnd(B, nh, S, dh) for _ in range(4))
    sc = dh ** -0.5
    shape = f"B={B} nh={nh} S={S} dh={dh} causal=False bf16 (sp: gathered)"
    err = _agree16(f"causal_prefill_attention {shape}",
                   K2.causal_prefill_attention(q, k, v, False, sc),
                   K2.causal_prefill_attention_plain(q, k, v, False, sc))
    bound, by = _bound16(2 * 2 * B * nh * S * S * dh, 4 * B * nh * S * dh * 2)
    _row("K2 causal_prefill_attention", shape, timer(
        lambda: K2.causal_prefill_attention(q, k, v, False, sc)), timer(
        lambda: K2.causal_prefill_attention_plain(q, k, v, False, sc)), timer(
        lambda: F.scaled_dot_product_attention(q, k, v, scale=sc)), bound, by,
        err, card)
    got = K4.attention_backward(q, k, v, do, False, sc)
    err = max(_agree16(f"attention_backward {shape} d{n}", a, r, floor=2e-2)
              for n, a, r in zip("qkv", got, K4.attention_backward_plain(
                  q, k, v, do, False, sc)))
    bound, by = _bound16(5 * 2 * B * nh * S * S * dh, 7 * B * nh * S * dh * 2)
    _row("K4 attention_backward", shape, timer(lambda: K4.attention_backward(
        q, k, v, do, False, sc)), timer(lambda: K4.attention_backward_plain(
            q, k, v, do, False, sc)), timer(_autograd_lib(
                lambda q, k, v: F.scaled_dot_product_attention(q, k, v,
                                                               scale=sc),
                (q, k, v), do)), bound, by, err, card)
    del q, k, v, do, got

    R, Kd = SP_BERT_B * SP_BERT_S // DP_RANKS, BERT_BASE["hidden_size"]
    x, dy = rnd(R, Kd), rnd(R, Kd)
    s_ = rnd(Kd, scale=0.1, shift=1.0, dtype=torch.float32)
    b_ = rnd(Kd, scale=0.1, dtype=torch.float32)
    shape = f"R={R} K={Kd} act=identity bf16 (sp: the rank's rows)"
    y, ref = (K3.layer_norm_act(x, s_, b_, 1e-5, "identity"),
              K3.layer_norm_act_plain(x, s_, b_, 1e-5, "identity"))
    err = max(_agree16("layer_norm_act sp y", y[0], ref[0]),
              *(_agree(f"layer_norm_act sp {n}", o, r)
                for n, o, r in zip(("mean", "var"), y[1:], ref[1:])))
    sb, bb = s_.to(bf), b_.to(bf)
    bound, by = _bound16(0, 2 * R * Kd * 2 + 2 * Kd * 4 + 2 * R * 4)
    _row("K3 layer_norm_act", shape, timer(lambda: K3.layer_norm_act(
        x, s_, b_, 1e-5, "identity")), timer(lambda: K3.layer_norm_act_plain(
            x, s_, b_, 1e-5, "identity")), timer(lambda: F.layer_norm(
                x, (Kd,), sb, bb, 1e-5)), bound, by, err, card)
    got = K5.layer_norm_act_backward(x, s_, b_, dy, 1e-5, "identity")
    ref = K5.layer_norm_act_backward_plain(x, s_, b_, dy, 1e-5, "identity")
    err = max(_agree16("layer_norm_act_backward sp dx", got[0], ref[0]),
              *(_sums_agree(f"layer_norm_act_backward sp {n}", o, r)
                for n, o, r in zip(("dscale", "dbias"), got[1:], ref[1:])))
    bound, by = _bound16(0, 3 * R * Kd * 2 + 4 * Kd * 4)
    _row("K5 layer_norm_act_backward", shape, timer(
        lambda: K5.layer_norm_act_backward(x, s_, b_, dy, 1e-5, "identity")),
        timer(lambda: K5.layer_norm_act_backward_plain(
            x, s_, b_, dy, 1e-5, "identity")), timer(_autograd_lib(
                lambda x, s, b: F.layer_norm(x, (Kd,), s, b, 1e-5),
                (x, sb, bb), dy)), bound, by, err, card)
    del x, dy, y, got, ref

    N, V = R, BERT_BASE["vocab_size"]
    x = rnd(N, V, scale=3.0)
    lab = torch.randint(0, V, (N,), generator=g, dtype=torch.int32).to(dev)
    gl = rnd(N, dtype=torch.float32)
    lab64 = lab.long()
    shape = f"N={N} V={V} bf16 logits (sp: the rank's rows)"
    err = max(_agree(f"softmax_xent_fwd sp {n}", o, r) for n, o, r in zip(
        ("loss", "m", "lse"), K6.softmax_xent_fwd(x, lab),
        K6.softmax_xent_fwd_plain(x, lab)))
    bound, by = _bound16(0, N * V * 2 + 4 * N * 4)
    _row("K6 softmax_xent_fwd", shape, timer(lambda: K6.softmax_xent_fwd(
        x, lab)), timer(lambda: K6.softmax_xent_fwd_plain(x, lab)), timer(
        lambda: F.cross_entropy(x, lab64, reduction="none")), bound, by, err,
        card)
    err = _agree_xent("softmax_xent_bwd sp", K7.softmax_xent_bwd(x, lab, gl),
                      K7.softmax_xent_bwd_plain(x, lab, gl))
    bound, by = _bound16(0, 2 * N * V * 2 + 2 * N * 4)
    _row("K7 softmax_xent_bwd", shape, timer(lambda: K7.softmax_xent_bwd(
        x, lab, gl)), timer(lambda: K7.softmax_xent_bwd_plain(x, lab, gl)),
        timer(_autograd_lib(lambda x: F.cross_entropy(
            x, lab64, reduction="none"), (x,), gl.to(bf))), bound, by, err,
        card)
    del x

    C, act, mode = 2048, "relu", "cl"
    for h in (4, 3):
        R, row = SP_RN_B * h * 7, C
        x, dy, res = rnd(R, row, scale=1.5, shift=0.3), rnd(R, row), \
            rnd(R, row)
        p = (rnd(C, scale=0.2, shift=1.0, dtype=torch.float32),
             rnd(C, scale=0.2, dtype=torch.float32),
             rnd(C, scale=0.1, shift=0.3, dtype=torch.float32),
             torch.rsqrt(2.25 + torch.rand((C,), generator=g)).to(dev))
        shape = (f"{mode} [{R}, {row}] C={C} act={act} residual=yes bf16 (sp: "
                 f"{SP_RN_B} images x {h} of 7 rows x 7)")
        err = _agree16(f"bn_apply_act {shape}",
                       K8.bn_apply_act(x, *p, act, res, mode),
                       K8.bn_apply_act_plain(x, *p, act, res, mode))
        bound, by = _bound16(4 * R * row, 3 * R * row * 2 + 4 * C * 4)
        _row("K8 bn_apply_act", shape, timer(lambda: K8.bn_apply_act(
            x, *p, act, res, mode)), timer(lambda: K8.bn_apply_act_plain(
                x, *p, act, res, mode)), None, bound, by, err, card)
        # the split mode: the sums launch, then the chain from them (this
        # rank's rows: a world of one), bit for bit the one launch, which is
        # held against the plain version with K9's relu decisions
        M = R * row // C
        one = K9.bn_apply_act_backward(x, *p, dy, act, res, mode, M)
        ref, _, _ = _k9_reference(f"bn_apply_act_backward chain {shape}", one,
                                  x, p, dy, act, res, mode, M)
        err = max(_agree16(f"bn_apply_act_backward chain dx {shape}", one[0],
                           ref[0]),
                  _agree16(f"bn_apply_act_backward chain dres {shape}",
                           one[1], ref[1]))
        _k9_split(K9, timer, card, shape, (x, p, dy, act, res, mode), one, M,
                  err, None, _bound16)
        del x, dy, res, one, ref


def check_tp_shards(dev, timer, card):
    """The kernels at (h)'s and (i)'s shard shapes against their plain
    versions, timed beside their bound and the library call: K6/K7 bf16 at
    [TP_B * AMP_S, V / 2] with a third of the labels outside [0, V / 2)
    (the vocab-parallel path's other ranks' classes: they pick 0 and
    subtract nothing), K7 in its saved-stats mode; K1 at 6 heads (fp32,
    the serving rows); K2/K4 bf16 at [TP_B, 6, AMP_S, 64]."""
    from paddle_tpu_torch.ops.cuda_kernels import attention_bwd as K4
    from paddle_tpu_torch.ops.cuda_kernels import paged_attention as K1
    from paddle_tpu_torch.ops.cuda_kernels import prefill_attention as K2
    from paddle_tpu_torch.ops.cuda_kernels import xent_bwd as KB
    from paddle_tpu_torch.ops.cuda_kernels import xent_fwd as KF
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(SEED + 31)
    N, V = TP_B * AMP_S, BERT_BASE["vocab_size"] // TP_RANKS
    x = (3 * torch.randn((N, V), generator=g)).to(dev, torch.bfloat16)
    lab = torch.randint(0, V, (N,), generator=g, dtype=torch.int32)
    lab[::3] = torch.randint(-V, 0, (len(lab[::3]),), generator=g,
                             dtype=torch.int32) + torch.where(
        torch.arange(len(lab[::3])) % 2 == 0, 0, 2 * V).to(torch.int32)
    lab = lab.to(dev)
    outside = int(((lab < 0) | (lab >= V)).sum())
    gl = torch.randn((N,), generator=g).to(dev)
    shape = f"N={N} V={V} bf16, {outside} labels outside [0, V)"
    fwd = KF.softmax_xent_fwd(x, lab)
    err = max(_agree(f"softmax_xent_fwd {n} at the vocab shard", o, r)
              for n, o, r in zip(("loss", "m", "lse"), fwd,
                                 KF.softmax_xent_fwd_plain(x, lab)))
    lib_lab = lab.clamp(0, V - 1).long()
    bound, by = _bound(0, N * V * 2 + 4 * N * 4)
    _row("K6 softmax_xent_fwd", shape, timer(lambda: KF.softmax_xent_fwd(
        x, lab)), timer(lambda: KF.softmax_xent_fwd_plain(x, lab)),
        timer(lambda: F.cross_entropy(x, lib_lab, reduction="none")), bound,
        by, err, card)
    got = KB.softmax_xent_bwd(x, lab, gl, *fwd[1:])
    err = _agree_xent("softmax_xent_bwd saved stats at the vocab shard", got,
                      KB.softmax_xent_bwd_plain(x, lab, gl, *fwd[1:]))
    bound, by = _bound(0, 2 * N * V * 2 + 4 * N * 4)
    _row("K7 softmax_xent_bwd", shape + " saved stats", timer(
        lambda: KB.softmax_xent_bwd(x, lab, gl, *fwd[1:])),
        timer(lambda: KB.softmax_xent_bwd_plain(x, lab, gl, *fwd[1:])),
        timer(_autograd_lib(lambda x: F.cross_entropy(
            x, lib_lab, reduction="none"), (x,), gl)), bound, by, err, card)
    del x, fwd, got
    _paged_case(K1, dev, timer, card, g, [1, 16, 17, 500, 0, 33, 257, 64],
                32, nh=12 // TP_RANKS)
    B, nh, S, dh = TP_B, 12 // TP_RANKS, AMP_S, 64
    q, k, v, do = (torch.randn((B, nh, S, dh), generator=g).to(
        dev, torch.bfloat16) for _ in range(4))
    sc = dh ** -0.5
    shape = f"B={B} nh={nh} S={S} dh={dh} causal=False bf16"
    err = _agree16(f"causal_prefill_attention {shape}",
                   K2.causal_prefill_attention(q, k, v, False, sc),
                   K2.causal_prefill_attention_plain(q, k, v, False, sc))
    bound, by = _bound16(2 * 2 * B * nh * S * S * dh, 4 * B * nh * S * dh * 2)
    _row("K2 causal_prefill_attention", shape, timer(
        lambda: K2.causal_prefill_attention(q, k, v, False, sc)), timer(
        lambda: K2.causal_prefill_attention_plain(q, k, v, False, sc)), timer(
        lambda: F.scaled_dot_product_attention(q, k, v, scale=sc)), bound, by,
        err, card)
    got = K4.attention_backward(q, k, v, do, False, sc)
    ref = K4.attention_backward_plain(q, k, v, do, False, sc)
    err = max(_agree16(f"attention_backward {shape} d{n}", a, r, floor=2e-2)
              for n, a, r in zip("qkv", got, ref))
    bound, by = _bound16(5 * 2 * B * nh * S * S * dh, 7 * B * nh * S * dh * 2)
    _row("K4 attention_backward", shape, timer(lambda: K4.attention_backward(
        q, k, v, do, False, sc)), timer(lambda: K4.attention_backward_plain(
            q, k, v, do, False, sc)), timer(_autograd_lib(
                lambda q, k, v: F.scaled_dot_product_attention(q, k, v,
                                                               scale=sc),
                (q, k, v), do)), bound, by, err, card)


def _dp_lockstep_arms(dev, mesh, rank, world, result, checks):
    """(a)-(e) of dp_gloo2's worker: BERT-base AMP through the collective
    fleet in lockstep (bucketed, per gradient, ZeRO-1), LocalSGD, and
    with_data_parallel on an uneven batch; frees their state on return."""
    import torch.distributed as dist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import flags

    g = mesh.group("dp")
    cfg = _bert_cfg(AMP_S)
    feed, uneven = _dp_feed(cfg), _dp_feed(cfg, uneven=True)
    local, local_uneven = mesh.shard_feed(feed), mesh.shard_feed(uneven)
    refs = _dp_references(cfg, dev, feed, uneven) if rank == 0 else None
    dist.barrier()

    # (a), (b), (c) in lockstep
    saved = {k: flags.get_flag(k) for k in ("allreduce_bucket_mb", "zero1")}
    arms = {}
    for arm in DP_LOCKSTEP:
        flags.set_flags({"allreduce_bucket_mb": 0.0 if arm == "pergrad"
                         else saved["allreduce_bucket_mb"],
                         "zero1": arm == "zero1"})
        main, startup, loss = _dp_program(cfg, "fleet", rank, world)
        exe, scope = pt.Executor(dev), pt.Scope()
        exe.run(startup, scope=scope)
        arms[arm] = dict(main=main, startup=startup, scope=scope, exe=exe,
                         loss=loss,
                         target=pt.CompiledProgram(main).with_collective(
                             mesh=mesh))
    flags.set_flags(saved)
    names = [p.name for p in arms["bucketed"]["main"].all_parameters()]
    grads = [n + "@GRAD" for n in names]
    for step in range(DP_STEPS):
        res = {}
        for arm, a in arms.items():
            res[arm] = _dp_step(a["exe"], a["target"], local, a["scope"],
                                a["loss"], grads if step == 0 else ())
            _dp_record(result["arms"].setdefault(arm, {}), *res[arm][2:])
            result["arms"][arm].setdefault("loss", []).append(res[arm][0])
        if step == 0:
            reduced = dict(zip(names, res["bucketed"][1]))
            sums = _dp_gather_sum(torch.cat([reduced[n].reshape(-1)
                                             for n in names
                                             if n not in DP_NOT_REPEATABLE]))
            if len(set(sums)) != 1:
                raise RuntimeError(f"ranks reduced to different gradients: "
                                   f"{sums}")
            if rank == 0:
                w = _dp_held("(a) step-1 reduced gradients vs the mean of the "
                             "half-batch gradients", reduced, refs["mean"],
                             names)
                checks.append(f"(a) step-1 reduced gradients bit for bit the "
                              f"mean of the two B={AMP_B // world} gradients "
                              f"but {', '.join(DP_NOT_REPEATABLE)} (worst "
                              f"{w:.3e})")
            del reduced
        for arm in ("pergrad", "zero1"):
            got = {n: arms[arm]["scope"].find_var(n) for n in names}
            want = {n: arms["bucketed"]["scope"].find_var(n) for n in names}
            _dp_held(f"({arm}) step {step + 1} vs (a)", got, want, names)
            _dp_sync_not_repeatable(arms["bucketed"], arms[arm], g.index,
                                    world)
    checks.append(f"(b) per-gradient and (c) ZeRO-1 parameters bit for bit "
                  f"(a)'s after each of {DP_STEPS} steps but "
                  f"{', '.join(DP_NOT_REPEATABLE)}")
    # ZeRO-1's memory: the eligible moments' bytes on this rank
    zmain, zscope = arms["zero1"]["main"], arms["zero1"]["scope"]
    held = full = 0
    for v in zmain.list_vars():
        if getattr(v, "is_opt_state", False) and \
                v.name + "@ZERO1_SHARD" in zmain.global_block.vars:
            t = zscope.find_var(v.name)
            held += t.numel() * t.element_size()
            f = arms["bucketed"]["scope"].find_var(v.name)
            full += f.numel() * f.element_size()
    if not held * world == full:
        raise RuntimeError(f"(c) ZeRO-1 holds {held} bytes of moments, the "
                           f"full ones are {full}")
    result["zero1_moment_bytes"] = [held, full]
    # (a) against the one-process B=128 trajectory: the ranks' mean loss
    # each step (equal halves of a mean) and the parameters' updates
    rank_losses = [_dp_gather_sum(torch.tensor([x]))
                   for x in result["arms"]["bucketed"]["loss"]]
    if rank == 0:
        d_loss = max(abs(sum(x) / world - y) / abs(y)
                     for x, y in zip(rank_losses, refs["losses"]))
        # over all parameters at once: a few small parameters' updates,
        # Adam's lr sign(g) where |g| is near bf16's rounding, flip alone
        d_upd = _rel_l2(
            torch.cat([(arms["bucketed"]["scope"].find_var(n)
                        - refs["p0"][n]).reshape(-1) for n in names]),
            torch.cat([(refs["params"][n] - refs["p0"][n]).reshape(-1)
                       for n in names]))
        if not (d_loss <= DP_LOSS_RTOL and d_upd <= AMP_GRAD_CAP):
            raise RuntimeError(f"(a) after {DP_STEPS} steps: mean loss "
                               f"{d_loss:.3e} from the one-process run's "
                               f"(limit {DP_LOSS_RTOL}), updates {d_upd:.3e} "
                               f"in relative L2 over all parameters (limit "
                               f"{AMP_GRAD_CAP})")
        checks.append(f"(a) steps 1-{DP_STEPS}: the ranks' mean loss within "
                      f"{d_loss:.3e} of the one-process B={AMP_B} run's, the "
                      f"parameters' updates within {d_upd:.3e} in relative L2 "
                      f"over all parameters")
    buckets = _dp_buckets(arms["bucketed"]["main"])
    result["buckets"] = [b for _, _, b in buckets]
    result["expected_launches"].update({
        arm: _expected_launches(a["main"]) for arm, a in arms.items()})
    fleet_program = tuple(arms["bucketed"][k]
                          for k in ("main", "startup", "loss"))
    del arms

    # (d) LocalSGD, k_steps = 2: apart after step 1, together after step 2
    main, startup, loss = _dp_program(cfg, "local_sgd", rank, world)
    exe, scope = pt.Executor(dev), pt.Scope()
    exe.run(startup, scope=scope)
    target = pt.CompiledProgram(main).with_collective(mesh=mesh)
    sums = []
    for step in range(2):
        res = _dp_step(exe, target, local, scope, loss)
        _dp_record(result["arms"].setdefault("local_sgd", {}), *res[2:])
        sums.append(_dp_gather_sum(torch.cat(
            [scope.find_var(n).reshape(-1) for n in names])))
    if len(set(sums[0])) == 1 or len(set(sums[1])) != 1:
        raise RuntimeError(f"(d) LocalSGD checksums after steps 1 and 2: "
                           f"{sums}")
    result["local_sgd_sums"] = sums
    result["expected_launches"]["local_sgd"] = _expected_launches(main)
    del exe, scope

    # (e) with_data_parallel on the uneven feed, and the fleet arm on it
    # (the programs built above, from fresh scopes)
    main, startup, loss = (refs["program"] if refs is not None
                           else _dp_program(cfg, "plain"))
    exe, scope = pt.Executor(dev), pt.Scope()
    exe.run(startup, scope=scope)
    target = pt.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=mesh)
    res = _dp_step(exe, target, local_uneven, scope, loss, grads)
    _dp_record(result["arms"].setdefault("global", {}), *res[2:])
    result["expected_launches"]["global"] = _expected_launches(main)
    glob = dict(zip(names, res[1]))
    fmain, fstartup, floss = fleet_program
    fexe, fscope = pt.Executor(dev), pt.Scope()
    fexe.run(fstartup, scope=fscope)
    fres = _dp_step(fexe, pt.CompiledProgram(fmain).with_collective(mesh=mesh),
                    local_uneven, fscope, floss, grads)
    fleet = dict(zip(names, fres[1]))
    if rank == 0:
        if not abs(res[0] - refs["uneven_loss"]) <= \
                DP_LOSS_RTOL * abs(refs["uneven_loss"]):
            raise RuntimeError(f"(e) with_data_parallel loss {res[0]} vs the "
                               f"one-process {refs['uneven_loss']}")
        want = refs["uneven"]
        beyond = [(n, _rel_l2(glob[n], want[n]), refs["band"][n])
                  for n in names]
        beyond = [b for b in beyond if not b[1] <= b[2]]
        if beyond:
            raise RuntimeError(f"(e) with_data_parallel step-1 gradients "
                               f"beyond their bands: {beyond[:4]}")
        d_all = _rel_l2(_dp_flat(glob, names), _dp_flat(want, names))
        apart = _rel_l2(_dp_flat(fleet, names), _dp_flat(want, names))
        if not d_all <= refs["band_all"] < apart:
            raise RuntimeError(f"(e) all gradients: with_data_parallel "
                               f"{d_all:.3e} and the fleet arm {apart:.3e} "
                               f"from the one-process step, band "
                               f"{refs['band_all']:.3e}: the check must pass "
                               f"the first and refuse the second")
        checks.append(f"(e) with_data_parallel on halves masking "
                      f"{int((uneven['lm_weight'][:AMP_B // 2] == 0).sum())} "
                      f"and 0 positions: loss {res[0]:.6f} vs one-process "
                      f"{refs['uneven_loss']:.6f}; every gradient within its "
                      f"band (AMP_GRAD_BAND over the halves-vs-one-batch "
                      f"distance, largest {max(refs['band'].values()):.3e}); "
                      f"all at once {d_all:.3e}, the fleet arm's {apart:.3e}, "
                      f"band {refs['band_all']:.3e}")
    # the later arms: free (a)-(e)'s state first (rank 0 holds both the
    # rank's program and the one-process references)
    del refs, glob, fleet, exe, scope, fexe, fscope, res, fres, fleet_program
    del main, startup, loss, target


# dp_gloo2's arms: (a)-(e) BERT-base AMP data-parallel, (f) ResNet-50 with
# synced batch statistics, (g) WMT with dropout, (h) BERT-base AMP
# tensor-parallel, (i) tensor-parallel serving, (j) ring attention
DP_ARMS = "abcdefghijkl"


def dp_worker(outdir, dev=None, arms=DP_ARMS):
    """One rank of dp_gloo2 (started by the launcher with chip_smoke as its
    script): the arms named in `arms` ((a)-(e) run together), each over the
    same seeded global batch; writes its results to `outdir`/rank<N>.json
    and raises on a failed hold."""
    import json
    import os

    import torch.distributed as dist

    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.ops.cuda_kernels import _build
    from paddle_tpu_torch.parallel import make_mesh

    dev = dev or torch.device("cuda", 0)
    missing = [n for n in _build.SOURCES if not _build.library_path(n).exists()]
    if missing and dev.type == "cuda":
        raise RuntimeError(f"dp worker: kernels {missing} are not built; the "
                           f"parent builds them before it starts the ranks")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a caller's live process group (a test's pool of ranks) stays up after
    # the arms: only a group this worker makes is destroyed at its end
    ours = not dist.is_initialized()
    env = init_parallel_env(device=dev)
    rank, world = env.rank, env.world_size
    mesh = make_mesh()
    g = mesh.group("dp")
    result = {"rank": rank, "group": repr(g), "arms": {},
              "expected_launches": {}}
    checks = []
    if set("abcde") & set(arms):
        _dp_lockstep_arms(dev, mesh, rank, world, result, checks)
    for arm, fn in (("f", _dp_sync_bn_arm), ("g", _dp_wmt_dropout_arm)):
        if arm in arms:
            torch.cuda.empty_cache()
            fn(dev, mesh, rank, world, result, checks)
    for arm, fn in (("h", _tp_bert_arm), ("i", _tp_serve_arm),
                    ("j", _ring_arm), ("k", _sp_bert_arm),
                    ("l", _sp_rn_arm)):
        if arm in arms:
            torch.cuda.empty_cache()
            fn(dev, rank, world, result, checks)
    result["checks"] = checks
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    if ours:
        dist.destroy_process_group()


def dp_gloo2(dev, card, arms=DP_ARMS):
    """Two ranks sharing the card over gloo, started through the port's
    launcher with chip_smoke as their script, running the worker's `arms`;
    a failed rank, or the launcher's timeout, fails the phase. Returns each
    rank's launches."""
    import json
    import os

    t0 = time.perf_counter()
    outdir = _smoke_dir("dp_gloo2")
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(DP_RANKS), "--backend", "gloo",
           "--log_dir", os.path.join(outdir, "log"),
           "--timeout", str(DP_TIMEOUT_S),
           os.path.join(here, "chip_smoke.py"), "--dp-worker", outdir,
           "--dp-arms", arms]
    try:
        rc = subprocess.run(cmd, cwd=here, timeout=DP_TIMEOUT_S + 60).returncode
    except subprocess.TimeoutExpired:
        rc = 124
    if rc != 0:
        tails = []
        for r in range(DP_RANKS):
            p = os.path.join(outdir, "log", f"workerlog.{r}")
            if os.path.exists(p):
                tails.append(f"--- rank {r}:\n" + open(p).read()[-4000:])
        raise RuntimeError(f"dp_gloo2: the launcher exited {rc}\n"
                           + "\n".join(tails))
    results = []
    for r in range(DP_RANKS):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    counts = []
    for res in results:
        for arm, rec in res["arms"].items():
            steps = len(rec["ms"])
            per_step = {w: {d: n // steps for d, n in by.items()}
                        for w, by in rec["launches"].items()}
            want = res["expected_launches"][arm]
            if per_step != want:
                raise RuntimeError(f"dp_gloo2 rank {res['rank']} arm {arm}: "
                                   f"launches a step {per_step}, the program "
                                   f"says {want}")
            bf16 = {w for w, by in rec["launches"].items() if by.get("bfloat16")}
            need = DP_ARM_KERNELS.get(arm, DP_ARM_KERNELS["bert"])
            if not need <= bf16:
                raise RuntimeError(f"dp_gloo2 rank {res['rank']} arm {arm}: "
                                   f"{sorted(need - bf16)} not launched in "
                                   f"bf16: {rec['launches']}")
            counts.append(rec["launches"])
            if "stats_ms" in rec:
                print(f"dp_gloo2 rank {res['rank']} arm {arm}: the step's "
                      f"gradient allreduces {rec['grad_ms']:.1f} ms, its "
                      f"{rec['stats_calls']} batch-statistics allreduces "
                      f"{rec['stats_ms']:.1f} ms (host-staged gloo, the "
                      f"stream waits included) [{card}]")
            print(f"dp_gloo2 rank {res['rank']} arm {arm}: ms a step "
                  f"{[round(x, 1) for x in rec['ms']]}, ms in collectives "
                  f"(host-staged gloo: staging copies and the collective) "
                  f"{[round(x, 1) for x in rec['comm_ms']]}, ms waiting for "
                  f"the stream before them {[round(x, 1) for x in rec['wait_ms']]}"
                  f", collective calls a step {rec['calls']} of "
                  f"{rec['comm_bytes'][-1]} bytes, GB/s "
                  f"{[round(b / m / 1e6, 3) if m else None for b, m in zip(rec['comm_bytes'], rec['comm_ms'])]}"
                  f", peak {rec['peak_gib']:.2f} GiB, launches "
                  f"{rec['launches']} [{card}]")
        if "sync_bn_margins" in res:
            print(f"dp_gloo2 rank {res['rank']}: (f)'s local-statistics "
                  f"variant refused: its worst update at "
                  f"{res['sync_bn_margins'][0]:.2f}x its band, its worst "
                  f"running statistic at {res['sync_bn_margins'][1]:.2f}x "
                  f"[{card}]")
        if "zero1_moment_bytes" in res:
            print(f"dp_gloo2 rank {res['rank']} ({res['group']}): ZeRO-1 "
                  f"holds {res['zero1_moment_bytes'][0]} of "
                  f"{res['zero1_moment_bytes'][1]} bytes of the eligible Adam "
                  f"moments; buckets {res['buckets']} bytes; LocalSGD "
                  f"checksums after steps 1 and 2 {res['local_sgd_sums']}")
        tpb = res["arms"].get("tp_bert")
        if tpb is not None:
            sums = tpb["tp_sums"]
            print(f"dp_gloo2 rank {res['rank']} (h): the timed step's "
                  f"{sums.get('calls', 0)} tp allreduces of "
                  f"{sums.get('bytes', 0) / 2**20:.1f} MB took "
                  f"{sums.get('host_s', 0.0) * 1e3:.1f} ms (host-staged gloo) "
                  f"+ {sums.get('wait_s', 0.0) * 1e3:.1f} ms waiting for the "
                  f"stream; kernels at {tpb['shapes']}"
                  + (f"; planted faults at {res['tp_fault_margins']} of their "
                     f"limits" if "tp_fault_margins" in res else "")
                  + f" [{card}]")
        tps = res.get("tp_serve")
        if tps is not None:
            counts.append(tps["launches"])
            print(f"dp_gloo2 rank {res['rank']} (i): {tps['decode_steps']} "
                  f"decode steps, {tps['sums'].get('calls', 0)} tp allreduces "
                  f"({tps['sums'].get('bytes', 0)} bytes, "
                  f"{tps['sums'].get('host_s', 0.0) * 1e3:.1f} ms), launches "
                  f"{tps['launches']}"
                  + (f", {tps['ms']:.2f} ms a decode step against tp = 1's "
                     f"{tps['ms_tp1']:.2f}" if "ms" in tps else "")
                  + f" [{card}]")
        for arm, what in (("sp_bert", "(k)"), ("sp_resnet", "(l)")):
            rec = res["arms"].get(arm)
            if rec is None:
                continue
            parts = "; ".join(
                f"{k} {c} calls of {mb:.1f} MB in {ms:.1f} ms"
                for k, (c, mb, ms) in rec["sp_comm"].items())
            margins = res.get(arm.replace("resnet", "rn") + "_margins")
            print(f"dp_gloo2 rank {res['rank']} {what}: the timed step's sp "
                  f"collectives (host-staged gloo, the stream waits "
                  f"included): {parts}"
                  + (f"; kernels at {rec['shapes']}" if "shapes" in rec
                     else "")
                  + (f"; planted faults at {margins} of their limits"
                     if margins else "") + f" [{card}]")
        for c in res["checks"]:
            print(f"dp_gloo2 rank {res['rank']}: {c}")
    print(f"dp_gloo2: {DP_RANKS} ranks over gloo on one card through "
          f"paddle_tpu_torch.distributed.launch --backend gloo, arms {arms}: "
          f"BERT-base AMP B={AMP_B} (B={AMP_B // DP_RANKS} a rank) S={AMP_S}, "
          f"ResNet-50 AMP B={DP_RN_B} with synced batch statistics, WMT AMP "
          f"dropout B={WMT_DROP_B}, BERT-base AMP over tp={TP_RANKS} at "
          f"B={TP_B}, DecoderConfig() served at tp={TP_RANKS}, ring attention "
          f"at S={RING_S}, BERT-base AMP use_sp over sp={DP_RANKS} at "
          f"B={SP_BERT_B} S={SP_BERT_S}, ResNet-50 AMP spatially partitioned "
          f"over sp={DP_RANKS} at B={SP_RN_B}; transport gloo (CUDA tensors staged through pinned "
          f"host memory), phase {time.perf_counter() - t0:.1f} s [{card}]")
    return counts


# pipeline_bert: bench.py:112's BERT-base AMP shape (B = AMP_B, S = AMP_S,
# Adam(TRAIN_LR), dropout 0) in PIPE_M microbatches over two stages, cut at
# the output of encoder layer PIPE_CUT, on one card (devices=None)
PIPE_M, PIPE_CUT, PIPE_STEPS = 4, 6, 2


def _pipe_program(cfg, schedule):
    """(main, startup, avg_loss): bert_pretrain + decorate(Adam(TRAIN_LR)),
    minimized plainly (schedule None) or by a PipelineOptimizer over it
    under `schedule`, cut at encoder layer PIPE_CUT's output (its second
    layer norm: the embeddings' layer norm comes first, then two a
    layer)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.contrib import mixed_precision as amp
    from paddle_tpu_torch.models import transformer

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        avg_loss, _ = transformer.bert_pretrain(cfg, seq_len=AMP_S)
        opt = amp.decorate(pt.optimizer.Adam(learning_rate=TRAIN_LR))
        if schedule is None:
            opt.minimize(avg_loss)
        else:
            norms = [op for op in main.global_block.ops
                     if op.type == "layer_norm"]
            cut = main.global_block.var(norms[2 * PIPE_CUT].output("Y")[0])
            pt.optimizer.PipelineOptimizer(
                opt, cut_list=[[cut]], num_microbatches=PIPE_M,
                schedule=schedule).minimize(avg_loss)
    startup.random_seed = SEED
    return main, startup, avg_loss


def _pipe_expected(plan):
    """{wrapper: {dtype: launches}} of one pipelined step: every
    microbatch runs each stage's forward and its backward (the forward
    replayed, then the grad ops), then each stage's update runs once."""
    want: dict = {}
    for stage in plan.stages:
        for prog, times in ((stage.fwd, plan.num_microbatches),
                            (stage.bwd, plan.num_microbatches),
                            (stage.update, 1)):
            if prog is None:
                continue
            for w, by in _expected_launches(prog).items():
                for d, n in by.items():
                    want.setdefault(w, {})
                    want[w][d] = want[w].get(d, 0) + n * times
    return want


def pipeline_bert(dev, card):
    """BERT-base AMP at B = AMP_B, S = AMP_S in PIPE_M microbatches over two
    stages (both on the card): GPipe and 1F1B, PIPE_STEPS steps in
    lockstep from the unpipelined program's starting weights, give the
    same parameters bit for bit but the not-repeatable embeddings
    (`index_add_` atomics: held within DP_GRAD_L2 and copied across after
    each step); 1F1B's step 1 follows the unpipelined B = AMP_B step (loss
    within DP_LOSS_RTOL, the parameters' updates within AMP_GRAD_CAP in
    relative L2 over all parameters, as dp_gloo2's (a)); 1F1B's stash peak
    is at most S + 1 microbatches and GPipe's M; the bubble accounts beside
    the analytic (S-1)/(M+S-1). Every microbatch's feed has the same count
    of masked positions (lm_weight all ones), so that the mean of the
    microbatch losses is the batch's. Returns each arm's launches."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.parallel import bubble_fraction

    cfg = _bert_cfg(AMP_S)
    feed = _bert_feed(cfg, AMP_B, AMP_S)
    arms = {}
    for arm in ("plain", "gpipe", "1f1b"):
        main, startup, loss = _pipe_program(cfg, None if arm == "plain"
                                            else arm)
        exe, scope = pt.Executor(dev), pt.Scope()
        exe.run(startup, scope=scope)
        arms[arm] = dict(main=main, loss=loss, exe=exe, scope=scope, rec={})
    names = [p_.name for p_ in arms["plain"]["main"].all_parameters()]
    p0 = {n: arms["plain"]["scope"].find_var(n).clone() for n in names}
    for arm in ("gpipe", "1f1b"):
        for n in names:
            arms[arm]["scope"].set_var(n, p0[n].clone())
    moments = [m for p_ in DP_NOT_REPEATABLE
               for m in _dp_moments(arms["plain"]["main"], p_)]
    worst, upd = 0.0, {}
    for step in range(PIPE_STEPS):
        for arm, a in arms.items():
            ck.reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            (lv,) = a["exe"].run(a["main"], feed=feed, scope=a["scope"],
                                 fetch_list=[a["loss"]], return_numpy=False)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rec = a["rec"]
            rec.setdefault("ms", []).append(ms)
            rec.setdefault("loss", []).append(float(lv))
            rec["peak_gib"] = max(rec.get("peak_gib", 0.0),
                                  torch.cuda.max_memory_allocated() / 2**30)
            _add_counts(rec.setdefault("launches", {}),
                        {w: by for w, by in ck.launch_counts_by_dtype().items()
                         if by})
            if step == 0 and arm != "gpipe":
                upd[arm] = _flat_update(a["scope"], p0, names)
        got = {n: arms["1f1b"]["scope"].find_var(n) for n in names}
        want = {n: arms["gpipe"]["scope"].find_var(n) for n in names}
        worst = max(worst, _dp_held(f"pipeline_bert step {step + 1} 1F1B vs "
                                    f"GPipe", got, want, names))
        if arms["1f1b"]["rec"]["loss"][-1] != arms["gpipe"]["rec"]["loss"][-1]:
            raise RuntimeError(f"pipeline_bert step {step + 1}: 1F1B's loss "
                               f"differs from GPipe's")
        for n in list(DP_NOT_REPEATABLE) + moments:
            arms["1f1b"]["scope"].set_var(
                n, arms["gpipe"]["scope"].find_var(n).clone())
    d_loss = abs(arms["1f1b"]["rec"]["loss"][0]
                 - arms["plain"]["rec"]["loss"][0]) / abs(
        arms["plain"]["rec"]["loss"][0])
    d_upd = _rel_l2(upd["1f1b"], upd["plain"])
    if not (d_loss <= DP_LOSS_RTOL and d_upd <= AMP_GRAD_CAP):
        raise RuntimeError(f"pipeline_bert: 1F1B's step 1 is {d_loss:.3e} "
                           f"from the unpipelined loss (limit {DP_LOSS_RTOL}) "
                           f"and its updates {d_upd:.3e} in relative L2 "
                           f"(limit {AMP_GRAD_CAP})")
    S = 2
    stats = {}
    for arm in ("gpipe", "1f1b"):
        plan = arms[arm]["main"]._pipeline
        if len(plan.stages) != S:
            raise RuntimeError(f"pipeline_bert: {len(plan.stages)} stages")
        stats[arm] = (plan.last_peak_stash, dict(plan.last_bubble))
        want = _pipe_expected(plan)
        per_step = {w: {d: n // PIPE_STEPS for d, n in by.items()}
                    for w, by in arms[arm]["rec"]["launches"].items()}
        if per_step != want:
            raise RuntimeError(f"pipeline_bert {arm}: launches a step "
                               f"{per_step}, the stage programs say {want}")
    if not (stats["1f1b"][0] <= S + 1 and stats["gpipe"][0] == PIPE_M):
        raise RuntimeError(f"pipeline_bert: stash peaks 1F1B "
                           f"{stats['1f1b'][0]} (limit {S + 1}), GPipe "
                           f"{stats['gpipe'][0]} (want {PIPE_M})")
    per_step = {w: {d: n // PIPE_STEPS for d, n in by.items()}
                for w, by in arms["plain"]["rec"]["launches"].items()}
    if per_step != _expected_launches(arms["plain"]["main"]):
        raise RuntimeError(f"pipeline_bert plain: launches a step {per_step}")
    for arm, a in arms.items():
        rec = a["rec"]
        print(f"pipeline_bert {arm}: BERT-base AMP B={AMP_B} S={AMP_S}"
              + ("" if arm == "plain" else f", {PIPE_M} microbatches over 2 "
                 f"stages cut at encoder layer {PIPE_CUT}") +
              f": ms a step {[round(x, 1) for x in rec['ms']]}, losses "
              f"{[round(x, 6) for x in rec['loss']]}, peak "
              f"{rec['peak_gib']:.2f} GiB, launches a step "
              f"{ {w: {d: n // PIPE_STEPS for d, n in by.items()} for w, by in rec['launches'].items()} } "
              f"[{card}]")
    print(f"pipeline_bert: GPipe and 1F1B bit for bit after each of "
          f"{PIPE_STEPS} steps but {', '.join(DP_NOT_REPEATABLE)} (worst "
          f"{worst:.3e} in relative L2, limit {DP_GRAD_L2}); 1F1B's step 1 "
          f"{d_loss:.3e} from the unpipelined loss, updates {d_upd:.3e} "
          f"(limit {AMP_GRAD_CAP}); last_peak_stash 1F1B {stats['1f1b'][0]} "
          f"(limit S + 1 = {S + 1}), GPipe {stats['gpipe'][0]} (M = "
          f"{PIPE_M}); last_bubble 1F1B {stats['1f1b'][1]}, GPipe "
          f"{stats['gpipe'][1]}, analytic {bubble_fraction(S, PIPE_M):.4f} "
          f"[{card}]")
    return [a["rec"]["launches"] for a in arms.values()]


def _phase(name, card, fn, *args, **kwargs):
    """Run one phase of the script, printing its wall seconds on a line of
    its own (`phase <name> <s> s [card]`)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"phase {name} {time.perf_counter() - t0:.1f} s [{card}]")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace a serving pass and a training step "
                         "with torch.profiler")
    ap.add_argument("--dp-worker", metavar="OUTDIR",
                    help="run as one rank of the dp_gloo2 phase (the "
                         "launcher passes it), writing to OUTDIR")
    ap.add_argument("--dp-arms", default=DP_ARMS,
                    help="the dp_gloo2 worker's arms (letters a-l)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.dp_worker:
        dp_worker(args.dp_worker, arms=args.dp_arms)
        return 0
    from paddle_tpu_torch.ops.cuda_kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = _card()
    secs = _phase("build", card, _build.build_all)
    print(f"built {len(_build.SOURCES)} kernels in {secs:.2f} s [{card}]")
    _print_resources(_build)

    timer = _Timer(dev)
    entries = [_phase("check_paged_decode", card, check_paged_decode, dev,
                      timer, card),
               _phase("check_prefill", card, check_prefill, dev, timer, card),
               _phase("check_layer_norm", card, check_layer_norm, dev, timer,
                      card),
               _phase("check_attention_backward", card,
                      check_attention_backward, dev, timer, card),
               _phase("check_layer_norm_backward", card,
                      check_layer_norm_backward, dev, timer, card),
               *_phase("check_softmax_xent", card, check_softmax_xent, dev,
                       timer, card),
               *_phase("check_bn_apply", card, check_bn_apply, dev, timer,
                       card)]
    for e in entries:
        e["dtype"] = "float32"
    bf16_entries = _phase("check_bf16_kernels", card, check_bf16_kernels, dev,
                          timer, card)
    bf16_entries.append(_phase("check_paged_decode16", card,
                               check_paged_decode16, dev, timer, card))
    _phase("check_layer_norm_edges", card, check_layer_norm_edges, dev, card)
    _phase("check_xent_edges", card, check_xent_edges, dev, card)
    tool_entry = _phase("check_bottleneck", card, check_bottleneck, dev, timer,
                        card)
    flash32, flash16 = _phase("check_flash", card, check_flash, dev, timer,
                              card)
    entries += flash32
    bf16_entries += flash16
    probe_entries = [_phase("check_attn_probe", card, check_attn_probe, dev,
                            timer, card),
                     _phase("check_dma_probe", card, check_dma_probe, dev,
                            timer, card)]
    _phase("check_softmax_xent#2", card, check_softmax_xent, dev, timer, card,
           N=S2S_B * S2S_T, V=S2S_DICT)
    _phase("check_tp_shards", card, check_tp_shards, dev, timer, card)
    _phase("check_sp_shards", card, check_sp_shards, dev, timer, card)
    k8_mbv3 = _phase(
        "check_bn_mobilenet", card, check_bn_mobilenet, dev, timer, card)
    bn_yolo = _phase("check_bn_yolov3", card, check_bn_yolov3, dev, timer,
                     card)
    bn_crnn = _phase("check_bn_crnn", card, check_bn_crnn, dev, timer, card)
    del timer
    torch.cuda.empty_cache()
    eng, prompts, outs, serve_counts = _phase("serve", card, serve, dev, card)
    if args.profile:
        def serve_pass():
            for p in prompts:
                eng.submit(p, max_new_tokens=SERVE_NEW)
            eng.run_until_drained()
        _profile(serve_pass, card, "serving pass")
    spec_counts = _phase("serve_spec", card, serve_spec, dev, card, eng,
                         prompts, outs, args.profile)
    resil_counts = _phase(
        "serve_resilience", card, serve_resilience, dev, card, eng, prompts,
        outs)
    torch.cuda.empty_cache()
    control_counts = _phase("serve_control", card, serve_control, dev, card,
                            eng, prompts, outs)
    torch.cuda.empty_cache()
    fleet_counts = _phase("serve_fleet", card, serve_fleet, dev, card, eng,
                          prompts, outs)
    torch.cuda.empty_cache()
    disagg_counts = _phase("serve_disagg", card, serve_disagg, dev, card, eng,
                           prompts, outs)
    del eng
    torch.cuda.empty_cache()
    prefix_counts = _phase("serve_prefix", card, serve_prefix, dev, card,
                           args.profile)
    torch.cuda.empty_cache()
    serve16_counts = _phase("serve_bf16", card, serve_bf16, dev, card,
                            args.profile)
    torch.cuda.empty_cache()
    _phase("serve_bf16_faults", card, serve_bf16_faults, dev, card)
    torch.cuda.empty_cache()
    exe, main_p, scope, feed, avg_loss, train_counts = _phase("train", card,
                                                              train, dev, card)
    if args.profile:
        _profile(lambda: exe.run(main_p, feed=feed, scope=scope,
                                 fetch_list=[avg_loss], return_numpy=False),
                 card, "BERT-base training step",
                 ("fp32 K2/K4", ("prefill_attention", "attn_bwd")), LN_FOCUS)
    del exe, main_p, scope, feed
    torch.cuda.empty_cache()
    rn_step, rn_counts = _phase("train_resnet", card, train_resnet, dev, card)
    if args.profile:
        _profile(rn_step, card, "ResNet-50 training step")
    del rn_step
    torch.cuda.empty_cache()
    bert_amp_step, bert_amp_counts = _phase("train_bert_amp", card,
                                            train_bert_amp, dev, card)
    if args.profile:
        undo = _range_ops(("adam",), UPDATE_OPS)
        _profile(bert_amp_step, card, "BERT-base AMP training step (B=128)",
                 LN_FOCUS, ranges=((UPDATE_OPS, "", ""),))
        undo()
    del bert_amp_step
    torch.cuda.empty_cache()
    tuned_counts, tuned_probe = _phase(
        "tuned_bert_long", card, tuned_bert_long, dev, card)
    torch.cuda.empty_cache()
    lamb_step, lamb_counts = _phase("train_bert_lamb", card, train_bert_lamb,
                                    dev, card)
    if args.profile:
        undo = _range_ops(("lamb",), UPDATE_OPS)
        _profile(lamb_step, card, "BERT-base AMP training step under LAMB "
                 "(B=128)", LN_FOCUS, ranges=((UPDATE_OPS, "", ""),))
        undo()
    del lamb_step
    torch.cuda.empty_cache()
    _phase("check_optimizers", card, check_optimizers, dev, card)
    torch.cuda.empty_cache()
    rn_amp_step, rn_amp_counts = _phase("train_resnet_amp", card,
                                        train_resnet_amp, dev, card)
    if args.profile:
        from paddle_tpu_torch.ops import nn_ops
        bn_backward = nn_ops._bn_backward
        nn_ops._bn_backward = ranged(bn_backward, BN_GRADS)
        _profile(rn_amp_step, card, "ResNet-50 AMP training step (B=128)",
                 ranges=((BN_GRADS, "bn_apply", "K9's"),))
        nn_ops._bn_backward = bn_backward
    del rn_amp_step
    torch.cuda.empty_cache()
    wmt_step, wmt_counts = _phase("train_wmt_amp", card, train_wmt_amp, dev,
                                  card)
    if args.profile:
        undo = _range_soft_chain()
        _profile(wmt_step, card, f"WMT Transformer-base AMP training step "
                 f"(B={WMT_B}, src=tgt={WMT_S})", LN_FOCUS,
                 ("bf16 K2/K4", ("prefill_mma", "attn_bwd")),
                 ranges=tuple((n, "", "") for n in SOFT_CHAIN))
        undo()
    del wmt_step
    torch.cuda.empty_cache()
    wmt_drop_counts = _phase("train_wmt_dropout", card, train_wmt_dropout, dev,
                             card)
    torch.cuda.empty_cache()
    s2s_counts, dec_counts = _phase("train_seq2seq", card, train_seq2seq, dev,
                                    card, args.profile)
    torch.cuda.empty_cache()
    mnist_counts = _phase("train_mnist", card, train_mnist, dev, card)
    torch.cuda.empty_cache()
    long_step, long_counts, plain = _phase(
        "train_bert_amp#2", card, train_bert_amp, dev, card, LONG_B, LONG_S,
        flash=True, keep=True)
    if args.profile:
        _profile(long_step, card, f"long-context BERT-base AMP training step "
                 f"(B={LONG_B}, S={LONG_S})", LN_FOCUS)
    del long_step
    torch.cuda.empty_cache()
    rc_step, rc_counts = _phase("train_bert_recompute", card,
                                train_bert_recompute, dev, card, plain)
    if args.profile:
        _profile(rc_step, card, f"long-context BERT-base AMP training step "
                 f"under RecomputeOptimizer (B={LONG_B}, S={LONG_S})",
                 LN_FOCUS, ("K10/K11", ("flash_",)))
    del plain, rc_step
    torch.cuda.empty_cache()
    infer_rn_counts, _ = _phase("infer_resnet", card, infer_resnet, dev, card)
    torch.cuda.empty_cache()
    infer_bert_counts, _ = _phase("infer_bert", card, infer_bert, dev, card)
    torch.cuda.empty_cache()
    rc_rn_counts, rc_rn_step = _phase("recompute_resnet", card,
                                      recompute_resnet, dev, card)
    if args.profile:
        _profile(rc_rn_step, card, f"ResNet-50 AMP training step under "
                 f"RecomputeOptimizer (B={AMP_B})")
    del rc_rn_step
    torch.cuda.empty_cache()
    book_counts = _phase("book_rest", card, book_rest, dev, card)
    torch.cuda.empty_cache()
    ctr_counts = _phase("ctr_deepfm", card, ctr_deepfm, dev, card)
    torch.cuda.empty_cache()
    giant_counts = _phase("ctr_giant", card, ctr_giant, dev, card)
    torch.cuda.empty_cache()
    w2v_sparse_counts = _phase("sparse_word2vec", card, sparse_word2vec, dev,
                               card)
    torch.cuda.empty_cache()
    _phase("seq_tail", card, seq_tail, dev, card)
    torch.cuda.empty_cache()
    exe, main_p, scope, feed, avg_loss, long32_counts = _phase(
        "train#2", card, train, dev, card, LONG_FP32_B, LONG_FP32_S,
        flash=True)
    if args.profile:
        _profile(lambda: exe.run(main_p, feed=feed, scope=scope,
                                 fetch_list=[avg_loss], return_numpy=False),
                 card, f"long-context BERT-base fp32 training step "
                 f"(B={LONG_FP32_B}, S={LONG_FP32_S})")
    del exe, main_p, scope, feed
    torch.cuda.empty_cache()
    reader_counts = _phase("book_readers", card, book_readers, dev, card)
    torch.cuda.empty_cache()
    guard_counts, replay_counts = _phase("guard_resnet_amp", card,
                                         guard_resnet_amp, dev, card)
    print(f"guard: the blame replays launched {replay_counts} (the step run "
          f"again to the first non-finite op; not counted in the kernels "
          f"line) [{card}]")
    torch.cuda.empty_cache()
    runner_counts = _phase("runner_resnet_amp", card, runner_resnet_amp, dev,
                           card)
    torch.cuda.empty_cache()
    longtail_counts = _phase("longtail_ops", card, longtail_ops, dev, card)
    torch.cuda.empty_cache()
    mbv3_counts = _phase("train_mobilenet_v3", card, train_mobilenet_v3, dev,
                         card, k8_mbv3)
    torch.cuda.empty_cache()
    rec_counts = _phase("book_recommender", card, book_recommender, dev, card)
    torch.cuda.empty_cache()
    yolo_counts = _phase("train_yolov3", card, train_yolov3, dev, card,
                         bn_yolo)
    torch.cuda.empty_cache()
    yolo_serve_counts, _ = _phase("serve_yolov3", card, serve_yolov3, dev,
                                  card)
    torch.cuda.empty_cache()
    _phase("vision_ops", card, vision_ops, dev, card)
    torch.cuda.empty_cache()
    _phase("crf_ctc_ops", card, crf_ctc_ops, dev, card)
    torch.cuda.empty_cache()
    srl_counts = _phase("train_srl", card, train_srl, dev, card)
    torch.cuda.empty_cache()
    crnn_counts = _phase("train_crnn_ctc", card, train_crnn_ctc, dev, card,
                         bn_crnn)
    torch.cuda.empty_cache()
    dp_nccl_counts = _phase("dp_nccl1", card, dp_nccl1, dev, card)
    torch.cuda.empty_cache()
    dp_gloo_counts = _phase("dp_gloo2", card, dp_gloo2, dev, card)
    torch.cuda.empty_cache()
    pipe_counts = _phase("pipeline_bert", card, pipeline_bert, dev, card)
    # launches on the main paths, each counted from 0 just before its run:
    # serving (K1-K3) and the fp32 BERT (K2-K7) and ResNet-50 (K6-K9) steps,
    # all fp32; the prefix-cache (K1-K3) and speculative (K2, K3) serving
    # phases in fp32, the resilience drills, the controller's passes, the
    # fleet (inline and threaded) and the disaggregated fleet (K1-K3 fp32,
    # the replays after recovery and failover included) and the bf16
    # serving phase (K1-K3 bf16); the AMP BERT (K2-K7: bf16, and K3/K5 fp32 for the embedding
    # layer norm) and ResNet-50 (K6-K9 bf16) steps, the AMP BERT step under
    # LAMB (as under Adam); the long-context AMP
    # step (K10/K11 bf16, K3/K5-K7 as at S=128) and fp32 step (K3, K5-K7,
    # K10/K11 fp32); the WMT AMP step (K2-K5 bf16) and its dropout step
    # (K3/K5 bf16); the seq2seq step and the MNIST steps (K6/K7 fp32), the
    # seq2seq decode (none), the recompute step (K10 twice a layer, K11,
    # K3/K5 bf16 in the replays, K6/K7 bf16); the ResNet-50 and BERT-base
    # predictors (K8 in inference mode; K2 and K3), fp32 and bf16; the
    # ResNet-50 AMP step under recompute (K8 twice a batch norm, K9 in the
    # replays, K6 twice, K7 in its replay); word2vec and DeepFM, dense
    # and sparse, and the sequence/RNN tail (none); the book models fed by
    # their readers (K6/K7 fp32; K8/K9 fp32 in resnet_cifar10), the guarded
    # ResNet-50 AMP steps (K6-K9 bf16) and the runner's (the same); the
    # long tail's sampled softmax (K6/K7 fp32), MobileNetV3-Large's held
    # step and its timed steps (K8/K9 once a batch norm, K6/K7, fp32) and
    # the recommender (none); YOLOv3's held step and its timed steps (K8/K9
    # once a batch norm, fp32) and its predictor (K8 in inference mode);
    # the SRL step (none); CRNN-CTC's held step, its gated step and the QAT
    # steps (K8/K9 once a batch norm, fp32), its eval clone and the QAT,
    # frozen and int8 clones (K8 in inference mode); the tuned S = 512 BERT
    # AMP phase's steps (K3/K5, K6/K7 bf16; its attention, K2/K4 and
    # K10/K11 bf16 at [64, 12, 512, 64], counts only in the entries of that
    # shape: the explore steps, the consult steps on the verdict's pair,
    # both forced routes; its probe's calls are their `probe_launches`);
    # #15's, K12's and K13's own paths (their launches set by their checks);
    # the data-parallel phases: dp_nccl1's fleet steps and every arm of each
    # dp_gloo2 rank (K2-K7 bf16, K3/K5 fp32 for the embedding layer norm),
    # the workers' counts read from their result files (ResNet-50 AMP with
    # synced batch statistics: K8, K9's split mode, K6/K7 bf16; WMT with
    # dropout: K3/K5 bf16); the pipelined BERT-base AMP steps, GPipe and
    # 1F1B, and their unpipelined step (K2-K7 bf16, K2 and K3 twice a
    # microbatch and stage: the forward and the backward's replay)
    runs = [{n: {"float32": c} for n, c in counts.items() if c}
            for counts in (serve_counts, train_counts, rn_counts,
                           long32_counts)]
    runs += [prefix_counts, spec_counts, resil_counts, control_counts,
             fleet_counts, disagg_counts, serve16_counts, bert_amp_counts,
             lamb_counts, rn_amp_counts, wmt_counts, wmt_drop_counts,
             long_counts, s2s_counts, dec_counts, *mnist_counts, rc_counts,
             *infer_rn_counts, *infer_bert_counts, rc_rn_counts, *book_counts,
             ctr_counts, giant_counts, w2v_sparse_counts, *reader_counts,
             guard_counts, runner_counts, longtail_counts, *mbv3_counts,
             rec_counts, *yolo_counts, yolo_serve_counts, srl_counts,
             *crnn_counts, dp_nccl_counts, *dp_gloo_counts, *pipe_counts,
             {w: by for w, by in tuned_counts.items() if w not in tuned_probe}]
    for e in entries + bf16_entries:
        if "shape" in e:   # bench.py:137's attention: the tuned phase's
            e["launches"] = tuned_counts.get(e["name"], {}).get(e["dtype"], 0)
            e["probe_launches"] = tuned_probe[e["name"]][e["dtype"]]
        else:
            e["launches"] = sum(r.get(e["name"], {}).get(e["dtype"], 0)
                                for r in runs)
        if not e["launches"]:
            raise RuntimeError(f"{e['name']} ({e['dtype']}) was launched on no "
                               f"main path")
    keys = ("name", "dtype", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys + (
                                       "shape", "probe_launches") if k in e}
                                  for e in
                                  entries + bf16_entries + [tool_entry]
                                  + probe_entries]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
