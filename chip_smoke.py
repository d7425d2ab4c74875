"""GPU smoke test of the PyTorch port (glsdet_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in the order they run, each printing one line:
  1. the card (nvidia-smi name and power limit); fails without CUDA;
  2. build the CUDA kernels from glsdet_tpu_torch/csrc (seconds taken);
  3. NMS kernel vs nms_sorted_plain: B=8, K in {500, 512, 700, 800, 2000,
     2400, 4096} (4096 the kernel's limit),
     offsets 0/1, thresholds 0.6/0.65, class-shifted detection-like
     boxes; keep masks must be equal; the kernel's time, each of its two
     passes alone, and the plain version's; then the candidate ladder's
     two budgets (the NMS and ranking of multiclass_nms_batched at 512
     and at 2000 candidates, on 16 images whose 512 candidates fit the
     smaller): outputs equal, both times;
  4. GN kernel (GroupNorm -> ReLU -> int8 requant), both entries (the
     accumulator entry the int8 towers call, and the bf16 entry) vs their
     plain versions at B=16, C=256, G=32 and every level of both buckets,
     with per-channel offsets and one constant group: codes within +-1, at
     most 1e-3 of them differing, the constant group equal; and equal
     codes where the inputs make every f32 sum exact.  Per level of
     the 1152 bucket (the one the path runs): the regime the kernel takes
     (resident in a cluster, one launch; or streaming, two) and its
     cluster; the accumulator entry, the bf16 entry, and the route the
     accumulator entry replaces (dequantize, cast to bf16, bf16 entry),
     timed in the same call, each with its bound and share of it, and the
     accumulator entry's time split by kernel (torch.profiler); and all
     summed over the 40 launches of a stage-2 group (8 per level), where
     the accumulator entry must beat the route it replaces;
  5. fused-bottleneck kernel vs fused_bottleneck_plain at batch 16 and the
     four ResNet-50 stage shapes of the 1152 bucket (288/144/72/36 pixels,
     4C = 256/512/1024/2048), with the folded weights of the seeded
     MP-Det's identity blocks, and at edge shapes (a single-row image, odd
     H, W off the 16-pixel tile, 4C = 64): max |kernel - plain| <=
     5e-3 * max |plain|; per stage shape the kernel's (with the packed
     weights FusedBottleneck holds), the plain version's and the stock
     Bottleneck's (bf16, channels-last: the cuDNN chain the kernel
     replaces) times beside the bound, the share of the bound, the
     achieved TFLOP/s and the weight bytes that leave L2 per launch,
     counted from the tile plan;
  6. the int8 convolution's torch._int_mm route vs its exact float64
     version at the path's shapes: int32 results equal; the route's time,
     its im2col and its GEMM alone, beside cuDNN's bf16 convolution at the
     head-tower shape;
  7. the coarse resize of the 16 frames as the port runs it (float32,
     one rounding to bf16) against F.interpolate on bf16 frames: share
     of values differing, largest difference in ulps, both times; then
     the two-stage pipeline at full width (YOLOX-s at 640x640, MPDet
     ResNet-50, buckets 1024/1152, bucket-fit packing, coarse threshold
     1e-4, seeded random weights with the JAX package's initializers) on
     16 RandomState(0) 765x1360 frames: the models in bfloat16 on the
     card against float32 on the CPU;
  8. the painter on region rows the port's packer made from the bench
     frames: the canvas entry vs assemble_mosaic_plain_batch at paint
     sizes 1024 and 1280, float32 bit-exact and bfloat16 equal; the path
     entry (MP-Det's normalized bf16 input, painted at the bucket) at
     1024 and 1152, equal to mosaic_inputs_plain and to the route it
     replaces (the canvas entry at paint_hw_for(hw) = 1024 / 1280, the
     crop, the bf16 normalize); each timed eagerly and replayed, with
     its plain version's time, its bound and share of the bound;
  9. the bf16 pipeline: warmup, run_device_batch and run_batch; the NMS
     kernel and the painter must have launched, every painter launch the
     path entry; img/s and peak memory; one more run_device_batch with
     every coarse_packed and stage2_packed call under
     torch.cuda.set_sync_debug_mode("error") (no op inside a stage may
     wait for the card; this check runs in phases 11 and 12 too);
     then the NMS kernel where the path runs it: the inputs of every
     launch in one run_device_batch, captured, with the wrapper's shape
     log; per launch keep masks equal to the plain version, the kernel's
     time, each pass alone, the plain version's and the bound, and their
     sums over the batch;
 10. where the time of one run_device_batch goes: stage times, the
     models alone, torch.profiler's device busy time, largest ops and
     largest kernels;
 11. static int8: calibrate_int8 on 4 bench frames with the bf16
     pipeline, the scales through save_scales/load_scales, a
     quant8="static" pipeline with the same weights; its int8 models vs
     the bf16 models on a captured input (relative max error < 0.3, the
     JAX package's bound in tests/test_quant_static.py); then as phases 9
     and 10: warmup, run_device_batch and run_batch, the GN kernel launched
     40 times per stage-2 group, int8 img/s beside bf16 img/s, peak
     memory, the NMS kernel at the batch's shapes, the ops of one int8
     head tower (its GEMMs and one float multiply: no dequantize pass
     between a GEMM and the GN kernel), and the stage breakdown of one
     int8 run_device_batch;
 12. the fused pipeline: the same seeded weights with MP-Det wrapped by
     wrap_model_fused; the fused MP-Det vs the unfused bf16 one on a
     captured mosaic (relative max error < 0.15, the JAX package's bound in
     tests/test_pallas_bottleneck.py); then as phases 9 and 10, with the
     bottleneck kernel launched 12 times per stage-2 group; fused img/s and
     peak memory beside bf16's;
 13. dynamic int8 (quant8=True): one run_device_batch, results well formed;
 14. the serving facade: the seeded models as state-dict files, then
     apis.TwoStageDetector("coarse_det", ..., "mp_det_res50", ...) with its
     defaults (global-local fusion, square packing, the config's bucket
     ladder 768-2688, max_batch 8) but the coarse threshold at 1e-4;
     warmup, then one detect_batch of the 16 frames through the streaming
     protocol: stage 2 on every frame, the buckets square packing chose,
     B1 once and B2 four times per stage-2 group (one coarse launch per
     chunk of 8, three per group: the chips' decode, the unmapped chips,
     the fusion); every fusion equal to _fuse_packed on the CPU and each
     fused row a row of its frame's coarse or local set; the stages
     without a host sync (fusion included); B1 at every bucket used equal
     to mosaic_inputs_plain and timed, B2 at the fusion's launches
     (K = 700, 0.65, offset 0) equal to its plain version and timed; the
     stage breakdown of one chunk of 8 (phase 10's, with the fusion timed
     alone); a captured group's local sets fused with an overlapping
     coarse set (their own rows, jittered): rows suppressed, B2's keep
     mask equal to the plain version's, the output equal to the CPU's.
     Then make_server with an AsyncDetector (max_batch 8, pipeline depth
     2), the clients in a process of their own (its own interpreter, so
     no lock shared with the server), 8 threads, JSON raw-array bodies,
     each request's id in its pixel (0, 0): a burst of 16 requests (smoke
     readings only), then one sustained window of 256 requests cycling
     the 16 frames (requests/s and latency p50/p90/p99 per window, the
     batches the batcher formed); every answer 200 and well formed;
     /ping, /models, /metrics (528 requests, 0 errors); every batch the
     batcher formed run again through detect_batch with the same requests
     in the same order, each answer equal to its slot's direct result;
     the host time to decode one request body; img/s of detect_batch
     with fusion on and off, peak memory.  Then the facade with its
     ladder cut to (768, 2688), so that square packing takes other
     buckets than 1152: the same checks of one detect_batch, B1 at those
     buckets equal to mosaic_inputs_plain and timed, img/s;
 15. the facade in static int8 with a scales path that does not exist:
     the first batch calibrates and saves, a second facade loads the file
     and detects the same; the GN kernel 40 times per stage-2 group, and
     against its plain version at the levels of the buckets used; int8
     img/s; then on the same scales with the ladder cut to (768, 2688):
     the GN kernel 40 times per group, and on the inputs the path gave it
     (the first launch at each level, captured) within +-1 code of its
     plain version, timed;
 15b. replicas: serving across cards.  The bench fixture's bf16 and
     static-int8 pipelines (phase 11's scales) with devices=["cuda:0",
     "cuda:1"] (["cuda:0", "cuda:0"] on a one-card machine, which it
     says: "cards": 1, "device_guard_checked": false): warmup on each
     card, then 4 batches of the 16 frames submitted in turn and
     collected, served on cuda:0, cuda:1, cuda:0, cuda:1, each batch's
     detections equal to the one-card pipeline's (the same counts and
     labels, boxes within 1e-2 px + 1e-4 relative, scores within 1e-3),
     every B1, B2 and B3 launch counted by card where its wrapper
     launches (launches_by_device; the cards' sums equal the wrappers'
     totals) and each on the second card held against its plain version
     on that card (B1 and B2 equal, B3 within +-1 code; the count held
     equals the card's); on two cards each kernel's wrapper (B4's too,
     on a small bottleneck) called on cuda:1 tensors while cuda:0 is
     current, against its plain version, and B2 refusing inputs on two
     cards.  TwoStageDetector(devices=) answering two detect_batch calls
     of the 16 frames (one turn each) as the one-card facade does.
     scan_width: the bf16 models on 32 frames as one chunk, flat and in
     groups of 16 (the peak memory predicted from the one-card run and
     printed first, then measured; img/s); each stage's groups
     torch.equal to the groups run alone (the coarse stage, and a
     stage-2 group of 32 mosaics), and the grouped run against the flat
     one as two bf16 runs of other batch sizes (the top 10 detections
     of each frame matched both ways at 0.95; cuDNN picks its algorithms
     per shape, so the two do not sum alike).  cost_analysis
     at 765x1360 of the bf16, int8 and fused pipelines on the card, the
     flops equal across the three and the coarse stage's equal to the
     bf16 models' in float32 on the CPU (batch 1); per image at the
     ladder's first bucket and at 1152, and the one-card bf16 run's
     img/s times them as achieved TFLOP/s.  Printed as one
     {"replicas": ...} line; each kernel's
     entry of the kernel line adds its launches per card
     (replicas_launches_per_card).  Its training part runs in phase 21;
 16. apis.Detector("coarse_det", score_thr=1e-4) on 4 frames: B2
     launched, detections well formed, img/s;
 17. MP-Det training (train/steps.py; no kernel of its own: none of the
     JAX package's Pallas kernels is on its path).  A small MP-Det (depth
     18, 128x128, batch 2, feat_channels 64, 16 words) from one seeded
     state, one step on the card and on the CPU, in float32 and float64:
     the six losses within 1e-4 relative, parameters, BN statistics, EMA
     and dictionary within 1e-5 of each leaf's max, the momentum buffers
     too in float64 (reported in float32, where this fixture's backbone
     gradients are ill-conditioned).  Then mp_det_res50 at full width
     (1024x1024, batch 4, max_gt 300, bf16 autocast, remat on, seeded
     weights, scripts/bench_train.py _mk_batch's recipe, beta on before
     step 0): 2 warm-up and 10 timed steps (ms/step, img/s, peak memory,
     the six losses of the first and last step), update_ot once after
     step 5, timed alone: finite losses, the dictionary's pointers moved,
     each class's marginals summing to 1, the EMA equal to the
     ema_momentum formula on one leaf; one profiled step (device busy
     time, idle share, launches, top ops) and the ATSS targets alone; one
     step under torch.cuda.set_sync_debug_mode("error"); one step each
     with remat on and off from one state (losses within 1e-3 relative,
     BN statistics within 1e-3 of each leaf's max, both peak memories),
     and in float32 (the total loss within 5e-2 relative of bf16's).
     Printed as one {"train": ...} line.
 18. the coarse detector's trainer (make_yolox_train_step: SimOTA, the
     YOLOX loss; no kernel of its own) at coarse_det's full width: YOLOX-s,
     10 classes, 640x640, batch 8, max_gt 300, bf16 autocast, yolox_sgd
     with its warm-cos schedule, seeded weights, VisDrone-like batches
     (5-60 boxes of 4-64 px).  First a small YOLOX-nano (128x128, batch
     2) from one seeded state, one float64 step on the card and on the
     CPU: metrics within 1e-5 relative, parameters, BN statistics, EMA
     and momentum within 1e-5 of each leaf's max.  Then 2 warm-up and 10
     timed steps (ms/step, img/s, peak memory), one profiled step (device
     busy time, idle share, launches, top ops), one step under
     set_sync_debug_mode("error"), one use_l1 step and one resize_from
     step each way (640 -> 608, 640 -> 672): every loss finite and
     num_fg > 0.  Printed as one {"train_yolox": ...} line;
 19. the GFL trainer (make_gfl_train_step) at gfl_res50's full width:
     ResNet-50 + FPN + GFLHead, 1024x1024, batch 4, bf16 autocast, remat
     as configured, mp_sgd, _mk_batch's batches: the same card-vs-CPU
     check on a GFLDet-18 at 64 channels, 128x128; then timed steps, a
     profiled step and a step under the sync debug mode.  Printed as one
     {"train_gfl": ...} line;
 20. gfl_int8: apis.Detector("gfl_res50") on 4 frames from a state-dict
     file, in bf16 and in static int8 (the first batch calibrates and
     saves the scales): the int8 model within 0.3 relative of bf16 on one
     input, B3 launched 40 times per int8 batch (8 per level) and, on the
     accumulators this path gives it, within +-1 code of its plain
     version (timed per level, with its bound), B2 launched in each run
     and, on the NMS inputs each run gives it ((4, 400): budget 4 *
     max_dets), its keep mask equal to nms_sorted_plain's (the int8
     run's launches timed, with their bound), the top 10 bf16 detections
     of each frame matched by int8 ones (same label, IoU > 0.5, score
     within 0.3) at least half the time, img/s of both;
 21. train_loop: train() (train/loop.py) from PNG files on disk.  A
     synthetic VisDrone-like split (48 frames at 765x1360, 16 at
     1080x1920: smooth fields with 5-60 drawn boxes of 4-64 px, ignore
     and "others" rows) written with the port's PNG writer and converted
     by visdrone_to_coco (bytes on disk, decode ms per frame); then
     train(coarse_det) at full width (YOLOX-s, 640x640, batch 8, mosaic,
     mixup, HSV and mixup rendered on the card, flip, yolox_sgd with
     warm-cos, 4 loader workers): 3 epochs of 8 steps with a checkpoint
     each, the last without mosaic/mixup and with L1 (loss_l1 0 before,
     > 0 after); steps 4-7 under torch.profiler (idle share, launches per
     step); the host ms between batches (their mean after the first, and
     the last epoch's, once the prefetched batches are spent) against
     phase 18's bare step; tools/train.py's eval_fn (run_eval over the
     EMA weights, 16 val frames, float32) after each epoch, its AP
     printed; the epoch-2 checkpoint restored into a fresh state equal bit for bit to
     the state the loop had then, a resumed run taking only epoch 3's
     steps, and apis.init_detector serving the epoch-3 EMA.  Then six
     steps with multiscale_sizes (608, 640, 672) (the logged sizes equal
     multiscale_size's: 608, then 672), four steps one at a time and in
     groups of two (train.steps_per_call = 2; phase 15b's training
     part), both on the same 4 batches made before the first step: the
     loop's record of its groups (at steps 0 and 2; none for K = 1), the
     log at steps 2 and 4, each run's host ms a step), five steps with
     device_geom (the
     mosaic and affine warp on the card), and train(mp_det_res50) at 1024x1024,
     batch 4, remat on, on 16 frames for 3 epochs: update_ot at exactly
     the JAX cadence's steps (every 3 while the epoch is below 2), beta
     switched at epoch 1, the dictionary pointers moved.  Card against
     CPU: the colour and geometric stages on one real device_geom batch
     within +-1 code (share differing printed), warp_affine_u8 and
     resize_linear_u8 equal, and two float64 steps of train() for
     YOLOX-nano at 128x128 on both devices (the loader in the calling
     thread), losses and every leaf within 1e-5 (relative; of a leaf's
     max).  Last, the loader alone at
     os.cpu_count() workers, the decode cache on, samples/s.  Printed as
     one {"train_loop": ...} line;
 22. eval, over phase 21's 64 PNG frames as a val split (their own
     synthetic annotations): YOLOX-s with its norm statistics and biases
     jittered from the seed (at the initializers' constants every score
     ties at the prior), MP-Det-R50 as seeded.  run_eval for coarse_det
     (640², batch 8) and mp_det_res50 (1024², batch 4, max_dets 500) in
     bf16, and run_eval_tta on 16 frames (scales 1.0 and 1.25, flip),
     each after a one-frame warm pass: img/s, the host's share, COCO
     stats, B2 launched and every launch's keep mask equal to
     nms_sorted_plain's, each launch timed with its plain version and
     bound.  float32 run_eval of the jittered YOLOX-s (TF32 off) on 8
     frames on the CPU and on the card, against GTs made from the CPU's
     own detections: COCO stats within 1e-3.  Then
     glsdet_tpu_torch.tools.ufpmp_det_eval.main from state-dict files,
     --fuse-global, coarse threshold 1e-4, in bf16 and --int8-static
     (calibrating on 4 frames): B2's keep masks equal to plain, B1 at
     every stage-2 group equal to mosaic_inputs_plain (timed per bucket
     and batch), B3 launched 40 times per int8 group and, on the inputs
     the path gave it, within +-1 code of its plain version, timed.
     Printed as one {"eval": ...} line;
 23. inputs, what users bring, at full width: encode_jpeg and
     decode_jpeg of three fixed frames against the two sha256 digests
     OpenCV gave on the CPU test machine (this machine has no OpenCV);
     phase 21's 64 frames written as quality-95 JPEGs (encode_jpeg, 8
     threads) and, per size, JPEG decode and encode ms a frame beside PNG
     decode; reference-named checkpoints of the seeded coarse_det
     (yolox-drone naming) and mp_det_res50 (mmdet naming in an mmcv
     wrapper, with the BoIW buffers and integral.project) converted by
     tools/import_torch_weights.py: main, equal to the originals, and
     TwoStageDetectors from both files giving equal detections on 8
     decoded 765x1360 frames (B1 and B2 held against plain); one
     sustained window of 64 raw JPEG bodies (each frame tagged with its
     request id in grey blocks, encoded before the clock) from 8 clients
     to make_server, every answer equal to its batch's detect_batch
     replay on the frames the service decoded, every B2 keep mask and
     B1 group equal to plain, beside phase 14's JSON-array windows;
     run_eval coarse_det (bf16) and ufpmp_det_eval (bf16, --fuse-global)
     over 16 JPEG val frames (8 of each size) and over PNGs of the pixels
     decoded from them: equal detections and stats, B2 and B1 checked as
     in phase 22; 4 steps of train(coarse_det) reading the
     JPEGs; collect_env().  Printed as
     one {"inputs": ...} line;
 24. variants, the zoo of models/variants (no kernel of its own; B2 runs
     in their postprocess).  yolox_ffa at full width (FFAYoloBody, phi s,
     640x640, 10 classes, four levels at strides 4-32, 34,000 anchors),
     seeded weights with jitter_: the float32 forward of 2 frames on the
     card against the CPU's (TF32 off; every output within 1e-4 of its
     max), then the card's bf16 forward against its float32 one (within
     0.1); run_eval (family "ffa", bf16, batch 8) over phase 21's 64 val
     frames as phase 22 runs it (img/s, host share, COCO stats, B2 at
     FFA's shapes, every keep mask equal to nms_sorted_plain's and timed);
     3 make_yolox_train_step steps with the adam_step recipe after a
     warm-up (bf16 autocast, batch 8, max_gt 300, VisDrone-like boxes:
     ms/step, img/s, peak memory, GTs per image, one profiled step's
     launches and idle share); two train(yolox_ffa) steps from phase 21's
     PNG files.  Then each of the six coarse_det variants (lsk, evc, se,
     mscam, nonlocal, fg_fpn; YOLOX-s at 640x640, seeded and jittered),
     and the plain coarse_det beside them:
     its float32 forward on the card against the CPU's (within 1e-4),
     apis.Detector from a state-dict file on the 16 frames (B2's launches
     captured, keep masks equal to plain and timed, detections well
     formed, img/s); lsk also under quant8=True, where LSK's three 7x7
     dilation-3 depthwise convs must be int8 (the dilated int8 route),
     with the share of its bf16 detections it matches.  Last, DyHead (2
     stages, 256 channels at 80/40/20) and BatchFormer (dim 256, batch 8,
     training, dropout 0) on the card against the CPU (DyHead within
     1e-3: its gather taps sit on floor boundaries), DyHead's time, and
     BatchFormer's dropout drawn from a card generator.  Printed as one
     {"variants": ...} line; B2's entry of the kernel line adds its
     launches, shapes and times (variants_*).
 25. orbax: the JAX package's orbax checkpoints read without JAX.  The
     zstd decoder (glsdet_tpu_torch/native/zstd.cpp) built with this
     machine's host compiler (seconds taken); the committed fixture
     tests/torch_fixtures/orbax/trainstate (a small TrainState written by
     the JAX package's save_checkpoint: OCDBT, zarr v2, zstd; float32,
     bfloat16, int32 and uint32 leaves, lists, None) read by
     utils/orbax_read.py: read_orbax, the sha256 of every leaf's bytes and
     of the tree's key/dtype/shape list equal to the constants below
     (tests/test_torch_orbax.py recomputes them from the JAX package's
     restore_raw); every float leaf moved to the card and back unchanged
     (bfloat16 stays bfloat16); the checkpoint loaded by train/loop.py:
     restore_checkpoint into a port TrainState on the card (a model with
     the fixture's parameter names, yolox_sgd, a BoIW dictionary), every
     tensor equal to the conversion on the CPU.  Then the committed JAX
     two-stage archive tests/torch_fixtures/orbax/two_stage.gtar
     (serve.archive_model of the JAX ckpt_tool's stripped coarse_det and
     mp_det_res50 at full width, weights of low entropy but for one noise
     kernel) unpacked by serve.load_archive, both trees held to their
     digests; apis.init_detector of each tree in float32 on the card
     against the CPU (coarse_det at 640, mp_det_res50 at 256; each output
     within 1e-3 of its max); load_weights of the coarse_det tree into
     coarse_det's TrainState on the card, every tensor equal to the CPU's
     conversion; apis.Detector("coarse_det", tree) in float32 on the card,
     through B2, matching the CPU's answers on two frames; the archive
     registered with serve.DetectionService on the card (TwoStageDetector
     in its default bfloat16) answering 4 requests, through B1 and B2.
     Last, the decoder's throughput on this machine's host (MB of
     decompressed data a second, each timing at least 0.5 s) over the
     weight-like chunks (the archive's noise kernel and the small
     fixture's noise leaves) and, apart, over the 3 largest low-entropy
     chunks.  Printed as one {"orbax": ...} line.
 26. workflow: the GLSDet cycle through the port's commands
     (glsdet_tpu_torch/tools), each through its main(argv) in this
     process so that the kernels' launches are counted.  16 train and 8
     val frames (765x1360, VisDrone layout, quality-95 JPEGs with ignore
     and "others" rows) written by the phase; visdrone_e2e with the named
     configs at full width (coarse_det: YOLOX-s, 640x640, batch 8;
     mp_det_res50: ResNet-50 + FPN + MPHead, 1024x1024, batch 4) cut to
     one epoch each and the coarse threshold at 1e-5 (GLSDET_E2E_*_OPTS:
     after its few steps the coarse model's scores sit about the prior,
     1e-4): convert both splits, train coarse_det, build the UFP dataset
     (B2 once per frame), train mp_det_res50 on the mosaics, the two-stage
     eval (B1, B2); then tools.test mp_det_res50 --int8-static on 8
     mosaics (B3), tools.predict dir_predict (two-stage) over 4 val
     frames, tools.serve archive / serve (a thread, a free port) /
     client, tools.test coarse_det --out and merge_results with the eval's
     detections, and get_map and eval_metric on the eval's output (the
     commands in interpreters of their own, `python -m`, are phase
     28's dist_launch train and test).  Each command's launch counts
     (the cycle's counted once, from its start; the build's share read
     as the difference
     around it) equal to the calls captured; every B2 keep mask of every
     command equal to nms_sorted_plain's (timed), B1 at every stage-2
     group equal to mosaic_inputs_plain, B3's captured inputs within +-1
     code.  Printed
     as one {"workflow": ...} line: stage seconds, the build's frames a
     second, mosaics and annotations written, each train() stage's
     ms/step, the eval's COCO stats (parity only), the launches.
 27. analysis: the analysis and robustness commands on the card through
     their main(argv), on phase 26's outputs (its 8 val JPEG frames,
     val.json, the two-stage eval's detections, train()'s log of
     coarse_det, the coarse checkpoint): benchmark of coarse_det
     (YOLOX-s, 640x640, batch 8) and mp_det_res50 (1024x1024, batch 4),
     coarse_det --train (batch 8), one --trace-dir run whose Chrome trace
     holds the card's kernels; get_flops and summary of both, each
     parameter count equal to the CPU model's; export coarse_det
     --with-nms --check (a torch.export program, reloaded: every output
     torch.equal to the eager one, B2 launched by the reloaded program);
     draw_cam on one frame; test_robustness coarse_det over the 8 frames,
     all nine corruptions at severity 5 (10 evaluations, the
     OpenCV twins on the CPU); then optimize_anchors, analyze_dataset,
     analyze_logs (both tasks), coco_error_analysis, confusion_matrix,
     draw_bbox, browse_dataset and analyze_results.  Every B2 launch
     captured (the exported program's too), counted, its keep mask equal
     to nms_sorted_plain's and timed.  Printed as one {"analysis": ...}
     line; B2's entry of the kernel line adds its launches and times
     (analysis_*).
 28. dist: data parallelism across processes (parallel/mesh.py) at the
     full widths of coarse_det (YOLOX-s, 640x640, global batch 8) and
     mp_det_res50 (1024x1024, global batch 4, remat), seeded states with
     their BN statistics jittered, written from the CPU.  One process
     steps each family once in float32 on the card (the reference) and
     times 3 bf16 steps after 1.  Then a one-rank NCCL group joined by
     the smoke's own process, and a launch of two ranks of this script's
     dist_rank_main, each on its card through the JAX-style GLSDET_*
     environment (NCCL on two cards where the machine has them, else
     gloo, both on cuda:0).
     Each rank takes its rows of the global batch: its float32 step's
     losses within 1e-4 relative of the one-process step's, parameters,
     BN statistics and EMA within 1e-5 of each leaf's max, the
     dictionary (raw head features) within 1e-4, the momentum buffers
     (the step's gradient) within 0.2 of each leaf's max and 2e-2 in L2
     over them all, every leaf equal to rank 0's; its bf16 ms a step,
     peak memory, the gradient bytes one step all-reduces and one more
     step under torch.profiler in the 1-rank group and in one process
     (device busy time, the top device and host ops, the collectives'
     calls); and
     run_eval(mesh=data_mesh()) of the jittered YOLOX-s (float32) on 16
     of phase 21's frames against ground truth made from its own
     detections: the stats within 1e-3 of one process's, equal on every
     rank, every B2 launch's keep mask equal to nms_sorted_plain's and
     timed.  Then tools/train.py's main coarse_det in the same two
     ranks, after their steps, in a group of its own (its --dist-* flags;
     one epoch of 2 steps on 16 frames, mosaic and mixup off, the loader
     in the calling thread: one checkpoint and one log, both rank 0's),
     and tools/dist_launch.py test with that checkpoint (2 processes;
     float32, coarse threshold 1e-5), its --out equal to one process's
     tools.test --out.  Printed as one {"dist": ...} line; B2's entry of
     the kernel line adds the run_eval(mesh=) launches (dist_*).
 29. data_forms: the rest of the data layer.  (a) random_crop,
     photometric_distortion, the shear, rotate and translate warps,
     color, brightness, contrast, equalize and auto_augment over each of
     its five sub-policies (every op applied) on a seeded 765x1360 frame
     and a 61x45 one: the outputs' sha256 equal to AUGMENT_SHA256, which
     the JAX package computes on the CPU test machine
     (tests/test_torch_autoaugment.py), and each augmentation's host ms
     per 765x1360 frame; rgb_to_gray_u8, equalize_hist_u8 and the three
     warps on card tensors torch.equal to the CPU's.  (b) The committed
     JPEG fixtures of tests/torch_fixtures/jpeg_forms (progressive from
     cv2 and PIL, optimized tables, CMYK, a progressive file cut short)
     decoded to the digests of OpenCV's pixels (JPEG_FORMS, recomputed
     by tests/test_torch_jpeg.py); the 765x1360 progressive frame's
     decode ms beside the baseline decode of the same pixels.  (c) The
     765x1360 progressive and CMYK frames as raw bodies to make_server
     over a TwoStageDetector (seeded full-width weights): each answer 200
     and equal to the answer for the same pixels sent as a JSON array;
     every B1 group and B2 launch of those requests held against its
     plain version.  Printed as one {"data_forms": ...} line; B1's and
     B2's entries of the kernel line add its launches (data_forms_*).
 30. video: tools.predict video, the port's MPEG-4 Part 2 codec on the
     host around the two-stage detector on the card.  A seeded 24-frame
     765x1360 clip scrolling a few pixels a frame (video_clip, numpy
     only) written by data/video.py's VideoWriter as .mp4 and .avi and
     read back by its VideoReader: the sha256 of the clip, of both files'
     bytes and of the decoded frames equal to VIDEO_SHA256, which the CPU
     test machine computes (tests/test_torch_video.py, where OpenCV
     decodes the same files to the same frames); host encode and decode
     ms a frame.  Then predict.main(["video", clip.mp4, "--output", ...])
     over seeded full-width weights (the coarse threshold 1e-4, so that
     stage 2 fires): every B1 group and B2 launch of the run held against
     its plain version (checked_path; the first launch of each B2 shape
     and of each B1 bucket timed), detect ms a frame and the mode's
     frames/s, and the output read back as 24 frames of 1360x764 at
     25 fps.  Printed as one {"video": ...} line; B1's and B2's entries of
     the kernel line add its launches (video_*).
 31. h264: tools.predict video of H.264 clips, read by the port's H.264
     decoder (native/h264.cpp) on the host.  tests/h264_stream.py's
     writer (numpy only, loaded from the checkout) makes two seeded
     3-frame 1360x764 clips (coded as 1360x768, cropped): High profile
     CABAC with 8x8 transforms (IPP) in .mp4 and Baseline CAVLC in .avi;
     the sha256 of each file and of its decoded RGB frames equal to
     H264_SHA256, which the CPU test machine computes and where OpenCV
     decodes the same files to the same frames (tests/test_torch_h264.py);
     host decode ms a frame, the writer's seconds and the decoder's g++
     build (at first use, timed apart).  Then
     predict.main(["video", clip, "--output", ...]) of each clip as in
     phase 30 (every B1 group and B2 launch held against its plain
     version), detect ms a frame and the mode's frames/s.  Printed as one
     {"h264": ...} line; B1's and B2's entries of the kernel line add its
     launches (h264_*).
Then one JSON line of per-kernel results (each with its bound: the bytes
it must move at 3.35 TB/s or its operations at the card's peak for their
type, whichever is longer) and, last, the device line.  A kernel's ``ms``
is the mean of eager calls between two CUDA events, host gaps included;
``graph_ms`` beside it is the same calls replayed from a CUDA graph.
Any failure raises, and the script exits non-zero without the last line.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

DEVICE = "cuda"
N_FRAMES = 16
FRAME_HW = (765, 1360)
COARSE_HW = (640, 640)
BUCKETS = (1024, 1152)
PAINT_HW = (1024, 1280)      # paint canvases of the two buckets
PHI, DEPTH = "s", 50
NMS_K = (500, 512, 700, 800, 2000, 2400, 4096)
# MP-Det head levels (strides 8..128) of the two buckets
LEVELS = {1024: (128, 64, 32, 16, 8), 1152: (144, 72, 36, 18, 9)}
GN_C, GN_GROUPS, GN_S_OUT = 256, 32, 0.03
GN_PER_LEVEL = 8             # int8 GN launches per head level (2 x 4)
# ResNet-50 stages at the 1152 bucket: (pixels, C, identity blocks)
STAGES = {"layer1": (288, 64, 2), "layer2": (144, 128, 3),
          "layer3": (72, 256, 5), "layer4": (36, 512, 2)}
# NVIDIA H100 SXM, dense: HBM bytes/s, bf16 tensor-core and f32 FLOP/s
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12


# the JPEG digests the card machine's build must give: sha256 of the
# bytes encode_jpeg writes for digest_frames() at quality 95, and of the
# pixels (RGB) that cv2.imdecode reads from them on the CPU test machine
# (tests/test_torch_jpeg.py recomputes both there)
JPEG_DIGEST_HW = ((77, 131), (96, 160), (8, 8))
JPEG_BYTES_SHA256 = ("e2f635ac773bb948cdce45a4623df8da"
                     "9ec34b96b3e9df82ee7629eecd48429a")
JPEG_PIXELS_SHA256 = ("ee849ebfb40e29f77b4e902adbdafae7"
                      "2a416977404b8f6b9a51e2d0b4726d23")


def digest_frames() -> list:
    """Fixed seeded frames for the JPEG digests: blocky colour fields
    with noise, at sizes off the 16-pixel MCU."""
    rs = np.random.RandomState(12)
    frames = []
    for h, w in JPEG_DIGEST_HW:
        coarse = rs.randint(30, 226, (h // 8 + 2, w // 8 + 2, 3))
        img = np.kron(coarse, np.ones((8, 8, 1), np.int64))[:h, :w]
        img = img + rs.randint(-20, 21, (h, w, 3))
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def sha256(chunks) -> str:
    import hashlib

    h = hashlib.sha256()
    for c in chunks:
        h.update(c if isinstance(c, bytes) else
                 np.ascontiguousarray(c).tobytes())
    return h.hexdigest()


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, after one warm run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` runs captured in one CUDA
    graph and replayed: the kernels' own time, without the host's gaps
    between eager launches (which set an eager time of a few microseconds
    of work).  ``fn`` runs once eagerly first, so that what it caches
    (built libraries, plans) is made outside the capture."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, peak_ops: float) -> dict:
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate, whichever is longer (ms)."""
    t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES, 1e3 * ops / peak_ops
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("card", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count())
    return smi


def phase_build() -> None:
    from glsdet_tpu_torch.native import kernels

    t0 = time.perf_counter()
    kernels.load_kernels()
    log("build", seconds=time.perf_counter() - t0,
        sources=[s.split("glsdet_tpu_torch/")[-1] for s in kernels.SOURCES])


def det_boxes(rs, b, k, n_classes=10, extent=1024.0):
    """Detection-like boxes (clusters of jittered copies), scores and the
    class shift the path applies (label * 8192)."""
    centres = rs.uniform(0, extent, (b, max(k // 8, 1), 2))
    pick = rs.randint(0, centres.shape[1], (b, k))
    c = np.take_along_axis(centres, pick[..., None], 1) \
        + rs.normal(0, 8, (b, k, 2))
    wh = rs.uniform(6, 120, (b, k, 2)) * rs.uniform(0.9, 1.1, (b, k, 1))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    labels = rs.randint(0, n_classes, (b, k))
    boxes = boxes + labels[..., None] * 8192.0
    valid = rs.rand(b, k) > 0.15
    return boxes.astype(np.float32), valid


def nms_bound(bx, vd, keep) -> dict:
    """Greedy NMS needs the IoU of every kept box with each later valid
    box (~17 f32 operations with the threshold test); it reads the boxes
    and valid flags and writes the keep flags."""
    later = vd.flip(1).cumsum(1).flip(1) - vd.int()
    pairs = float((later * keep).sum())
    return bound(bx.numel() * 4 + 2 * vd.numel(), 17 * pairs, PEAK_F32)


def nms_times(bx, vd, thr, offset) -> dict:
    """The kernel's time (eager, and replayed from a graph), each of its
    passes alone (replayed), the plain version's."""
    from glsdet_tpu_torch.ops.nms import nms_sorted_plain
    from glsdet_tpu_torch.ops.nms_kernel import nms_passes, nms_sorted_cuda

    mask_pass, reduce_pass, _ = nms_passes(bx, vd, thr, offset)
    mask_pass()
    run = lambda: nms_sorted_cuda(bx, vd, thr, offset)  # noqa: E731
    return {"ms": cuda_ms(run), "graph_ms": graph_ms(run),
            "pass1_graph_ms": graph_ms(mask_pass),
            "pass2_graph_ms": graph_ms(reduce_pass),
            "plain_ms": cuda_ms(
                lambda: nms_sorted_plain(bx, vd, thr, offset), 3)}


def check_nms(bx, vd, thr, offset, what) -> torch.Tensor:
    from glsdet_tpu_torch.ops.nms import nms_sorted_plain
    from glsdet_tpu_torch.ops.nms_kernel import nms_sorted_cuda

    got = nms_sorted_cuda(bx, vd, thr, offset)
    want = nms_sorted_plain(bx, vd, thr, offset)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"NMS {what}: {int((got != want).sum())} keep "
                             f"flags differ")
    return got


def phase_nms() -> None:
    """Keep masks at synthetic detection-like shapes (module docstring,
    phase 3); the path's own shapes are timed by phase_nms_path."""
    rs = np.random.RandomState(0)
    for k in NMS_K:
        boxes, valid = det_boxes(rs, 8, k)
        bx = torch.from_numpy(boxes).to(DEVICE)
        vd = torch.from_numpy(valid).to(DEVICE)
        for offset in (0.0, 1.0):
            for thr in (0.6, 0.65):
                keep = check_nms(bx, vd, thr, offset,
                                 f"K={k} offset={offset} thr={thr}")
        log("nms", batch=8, k=k, **nms_times(bx, vd, 0.6, 0.0),
            kept=int(keep.sum()), masks_equal=True)


def phase_nms_ladder() -> None:
    """What the candidate ladder of multiclass_nms_batched chose between
    (ROADMAP §C, item C1): its NMS and ranking over the full 2000 budget
    against the 512 tier, on a batch of 16 whose candidates all fit the
    tier (rows past 512 score NEG_INF); running both and picking with
    torch.where costs their sum.  The outputs must be equal."""
    from glsdet_tpu_torch.ops.nms import NEG_INF, batched_nms, topk_stable

    rs = np.random.RandomState(5)
    boxes, _ = det_boxes(rs, N_FRAMES, 2000, n_classes=1)
    scores = np.full((N_FRAMES, 2000), NEG_INF, np.float32)
    scores[:, :512] = -np.sort(-rs.uniform(0.05, 1.0, (N_FRAMES, 512)))
    bx = torch.from_numpy(boxes).to(DEVICE)
    sc = torch.from_numpy(scores).to(DEVICE)
    lb = torch.from_numpy(rs.randint(0, 10, (N_FRAMES, 2000))).to(DEVICE)

    def run(k):
        keep, _ = batched_nms(bx[:, :k], sc[:, :k], lb[:, :k], 0.6)
        return topk_stable(torch.where(keep, sc[:, :k], NEG_INF), 500)

    for a, b in zip(run(512), run(2000)):
        if not torch.equal(a, b):
            raise AssertionError("NMS ladder: the 512 tier and the full "
                                 "budget disagree")
    t = {f"{name}_{key}": timer(fn)
         for name, fn in (("tier_512", lambda: run(512)),
                          ("full_2000", lambda: run(2000)))
         for key, timer in (("ms", cuda_ms), ("graph_ms", graph_ms))}
    log("nms_ladder", batch=N_FRAMES, candidates=512, **t,
        both_ms=t["tier_512_ms"] + t["full_2000_ms"], outputs_equal=True)


def phase_coarse_resize(dev_frames) -> None:
    """The coarse resize as the port runs it (float32, then one rounding
    to bf16) against F.interpolate on the bf16 frames, which the JAX
    package's bf16 chain would call for (ROADMAP §C, item C2): the share
    of values that differ, the largest difference in bf16 ulps of the
    resized value, and both times."""
    x = dev_frames.permute(0, 3, 1, 2)
    resize = lambda t: torch.nn.functional.interpolate(  # noqa: E731
        t, size=COARSE_HW, mode="bilinear", antialias=True,
        align_corners=False)
    port = resize(x.float()).to(torch.bfloat16)
    try:
        in_bf16 = resize(x.to(torch.bfloat16))
    except (RuntimeError, NotImplementedError) as e:
        log("coarse_resize_bf16", supported=False, error=str(e)[:200])
        return
    a, b = port.float(), in_bf16.float()
    ulp = torch.exp2(torch.floor(torch.log2(
        torch.maximum(a.abs(), b.abs()).clamp(min=1.0))) - 7)
    log("coarse_resize_bf16", supported=True,
        share_differing=float((a != b).float().mean()),
        max_ulps=float(((a - b).abs() / ulp).max()),
        f32_then_cast_ms=cuda_ms(lambda: resize(x.float()).to(
            torch.bfloat16)),
        bf16_ms=cuda_ms(lambda: resize(x.to(torch.bfloat16))))


def phase_nms_path(pipe, dev_frames, name="nms_path") -> dict:
    """The NMS kernel at the inputs the path gives it: one
    run_device_batch with every launch's inputs captured (and the
    wrapper's shape log beside them), then each launch checked and timed
    alone; sums over the batch."""
    from glsdet_tpu_torch.ops import nms as nms_mod
    from glsdet_tpu_torch.ops import nms_kernel

    captured, inner = [], nms_mod.nms_sorted_cuda

    def capture(bx, vd, thr, offset=0.0):
        captured.append((bx.clone(), vd.clone(), float(thr), float(offset)))
        return inner(bx, vd, thr, offset)

    nms_kernel.shapes.clear()
    nms_mod.nms_sorted_cuda = capture
    try:
        pipe.run_device_batch(dev_frames)
        torch.cuda.synchronize()
    finally:
        nms_mod.nms_sorted_cuda = inner
    logged = list(nms_kernel.shapes)
    shapes = [(bx.shape[0], bx.shape[1], off, thr)
              for bx, _, thr, off in captured]
    if not captured or logged != shapes:
        raise AssertionError(f"NMS shape log {logged} != launches {shapes}")
    # for glsdet_tpu_torch/tools/kernel_ab.py, which times another tree's
    # kernel on the same inputs
    from glsdet_tpu_torch.native.build import BUILD_DIR

    torch.save([(bx.cpu(), vd.cpu(), thr, off)
                for bx, vd, thr, off in captured],
               os.path.join(BUILD_DIR, f"{name}_inputs.pt"))
    launches = []
    total = dict.fromkeys(("ms", "graph_ms", "pass1_graph_ms",
                           "pass2_graph_ms", "plain_ms", "bound_ms"), 0.0)
    share = {"bytes": 0.0, "operations": 0.0}
    for bx, vd, thr, off in captured:
        keep = check_nms(bx, vd, thr, off, f"{tuple(bx.shape)} at the path")
        t = nms_times(bx, vd, thr, off)
        b = nms_bound(bx, vd, keep)
        launches.append({"batch": bx.shape[0], "k": bx.shape[1],
                         "offset": off, "threshold": thr,
                         "valid": int(vd.sum()), "kept": int(keep.sum()),
                         **t, **b, "share_of_bound": b["bound_ms"] / t["ms"]})
        for key in total:
            total[key] += launches[-1][key]
        share[b["bound_by"]] += b["bound_ms"]
    log(name, launches=launches, per_batch=total, masks_equal=True)
    return {"max_abs_err": 0.0, **total, "bound_by": max(share, key=share.get),
            "library_ms": None}


def seeded_models():
    """YOLOX-s and MPDet-R50 in float32 on the CPU, random weights from
    ``torch.Generator().manual_seed(0)``: every call gives the same."""
    from glsdet_tpu_torch.models import MPDet, YOLOXDetector

    g = torch.Generator().manual_seed(0)
    return YOLOXDetector(10, PHI, generator=g), MPDet(10, DEPTH, generator=g)


def make_pipeline(models, **kw):
    from glsdet_tpu_torch.eval.two_stage import TwoStagePipeline

    kw = {"max_batch": N_FRAMES, "device": DEVICE, **kw}
    return TwoStagePipeline(*models, COARSE_HW, mosaic_buckets=BUCKETS,
                            coarse_score_thr=1e-4, pack_mode="bucket-fit",
                            **kw)


def build_pipeline():
    t0 = time.perf_counter()
    cpu_refs = seeded_models()
    pipe = make_pipeline(seeded_models())
    log("init", seconds=time.perf_counter() - t0)
    return pipe, cpu_refs


def phase_models(pipe, cpu_refs) -> None:
    """bfloat16 models on the card vs the float32 models on the CPU, same
    weights and one input each: relative max error of every output."""
    rs = np.random.RandomState(1)
    checks = []
    for name, gpu, cpu, hw in (("yolox", pipe.coarse, cpu_refs[0],
                                COARSE_HW[0]),
                               ("mpdet", pipe.mp, cpu_refs[1], 256)):
        x = torch.from_numpy(rs.randn(1, 3, hw, hw).astype(np.float32))
        with torch.inference_mode():
            ref = cpu.eval()(x)
            got = gpu(x.to(DEVICE).to(pipe.dtype))
        errs = []
        for g_maps, r_maps in zip(got, ref):
            for g, r in zip(g_maps, r_maps):
                g = g.float().cpu()
                if g.shape != r.shape or not torch.isfinite(g).all():
                    raise AssertionError(f"{name}: bad output {g.shape}")
                errs.append(float((g - r).abs().max() / r.abs().max()))
        if max(errs) > 0.1:
            raise AssertionError(f"{name}: bf16 vs f32 rel err {errs}")
        checks.append({"model": name, "max_rel_err": max(errs)})
    log("models_bf16_vs_cpu_f32", checks=checks, bound=0.1)


def paint_rows(pipe, dev_frames):
    """Region rows the port's packer makes from the bench frames' coarse
    detections, one slot per frame: (rows, idx, regions per frame)."""
    from glsdet_tpu_torch.native import unified_foreground_packing_rows_fit

    coarse = pipe.coarse_packed(dev_frames).cpu().numpy()
    sx, sy = FRAME_HW[1] / COARSE_HW[1], FRAME_HW[0] / COARSE_HW[0]
    rows, n_regions = [], []
    for det in coarse:
        boxes = (det[:, :4] * np.array([sx, sy, sx, sy], np.float32))[
            det[:, 6] > 0.5]
        r, n, _, _, _ = unified_foreground_packing_rows_fit(
            boxes, 1.5, (FRAME_HW[1], FRAME_HW[0]), 32, BUCKETS)
        rows.append(r)
        n_regions.append(n)
    if min(n_regions) == 0:
        raise AssertionError(f"frames without regions: {n_regions}")
    return (torch.from_numpy(np.stack(rows)).to(DEVICE),
            torch.arange(N_FRAMES, dtype=torch.int64).to(DEVICE), n_regions)


def paint_bound(out, regs, painted, normalized=0) -> dict:
    """The painter's least time: ``out`` written once, the rows read, and
    the source pixels under the crops read once; ~11 f32 operations per
    painted channel, 2 more per ``normalized`` channel."""
    r = regs.to(torch.int64)
    src = float((r[..., 2].clamp(0, FRAME_HW[1])
                 * r[..., 3].clamp(0, FRAME_HW[0])).sum() * 3)
    return bound(out.numel() * out.element_size() + regs.numel() * 4 + src,
                 11 * painted + 2 * normalized, PEAK_F32)


def phase_paint(pipe, dev_frames) -> dict:
    """The painter on the packer's rows (module docstring, phase 8)."""
    from glsdet_tpu_torch.eval.preprocess import (mosaic_inputs_plain,
                                                  norm_constants,
                                                  paint_hw_for)
    from glsdet_tpu_torch.native.build import BUILD_DIR
    from glsdet_tpu_torch.ufp.paint_kernel import (
        assemble_mosaic_cuda_batch, assemble_mosaic_plain_batch,
        paint_mosaic_inputs_cuda)

    regs, idx, n_regions = paint_rows(pipe, dev_frames)
    # for glsdet_tpu_torch/tools/kernel_ab.py (the frames it makes anew)
    torch.save(regs.cpu(), os.path.join(BUILD_DIR, "paint_rows.pt"))
    canvas, worst = {}, 0.0
    for ph in PAINT_HW:                  # the canvas entry
        for dt in (torch.float32, torch.bfloat16):
            got = assemble_mosaic_cuda_batch(dev_frames, idx, regs, ph, ph,
                                             dt)
            want = assemble_mosaic_plain_batch(dev_frames, idx, regs, ph,
                                               ph, dt)
            err = float((got.float() - want.float()).abs().max())
            if err != 0.0 or not torch.equal(got, want):
                n = int((got != want).sum())
                raise AssertionError(f"paint {ph} {dt}: {n} values differ, "
                                     f"max abs err {err}")
            worst = max(worst, err)
        run = lambda: assemble_mosaic_cuda_batch(  # noqa: E731
            dev_frames, idx, regs, ph, ph)
        painted = float((got.float().abs().sum(-1) > 0).sum() * 3)
        t = {"ms": cuda_ms(run), "graph_ms": graph_ms(run),
             "plain_ms": cuda_ms(lambda: assemble_mosaic_plain_batch(
                 dev_frames, idx, regs, ph, ph), 3),
             **paint_bound(got, regs, painted)}
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        t["graph_share_of_bound"] = t["bound_ms"] / t["graph_ms"]
        canvas[ph] = t
        log("paint", entry="canvas", batch=N_FRAMES, paint_hw=ph, **t,
            regions_per_frame=n_regions, f32_bit_exact=True,
            bf16_equal=True, covered_share=painted / got.numel())
    mean, inv_std = norm_constants(torch.bfloat16, DEVICE)
    inputs = {}
    for hw in BUCKETS:                   # the path entry
        ph = paint_hw_for(hw)
        run = lambda: paint_mosaic_inputs_cuda(  # noqa: E731
            dev_frames, idx, regs, hw, mean, inv_std)
        # what it replaces: the canvas entry at paint_hw_for(hw), the
        # crop and the bf16 normalize
        route = lambda: ((assemble_mosaic_cuda_batch(  # noqa: E731
            dev_frames, idx, regs, ph, ph)[:, :hw, :hw] - mean) * inv_std)
        got = run()
        for name, want in (
                ("plain", mosaic_inputs_plain(dev_frames, idx, regs, hw,
                                              torch.bfloat16)),
                ("replaced route", route())):
            if not torch.equal(got, want):
                raise AssertionError(
                    f"paint inputs {hw}: {int((got != want).sum())} values "
                    f"differ from the {name}")
        painted = float((assemble_mosaic_cuda_batch(
            dev_frames, idx, regs, hw, hw).float().abs().sum(-1) > 0).sum()
            * 3)
        t = {"ms": cuda_ms(run), "graph_ms": graph_ms(run),
             "replaced_route_ms": cuda_ms(route),
             "replaced_route_graph_ms": graph_ms(route),
             "plain_ms": cuda_ms(lambda: mosaic_inputs_plain(
                 dev_frames, idx, regs, hw, torch.bfloat16), 3),
             **paint_bound(got, regs, painted, got.numel())}
        for key in ("ms", "graph_ms", "replaced_route_ms",
                    "replaced_route_graph_ms"):
            t[key.replace("ms", "share_of_bound")] = t["bound_ms"] / t[key]
        inputs[hw] = t
        log("paint", entry="inputs", batch=N_FRAMES, hw=hw, **t,
            equal_to_plain=True, equal_to_replaced_route=True)
    # the path's bucket: 1152, whose canvas entry painted at 1280
    hw = BUCKETS[1]
    t, c = inputs[hw], canvas[paint_hw_for(hw)]
    return {"max_abs_err": worst, "hw": hw, "ms": t["ms"],
            "graph_ms": t["graph_ms"], "plain_ms": t["plain_ms"],
            "library_ms": None, "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "share_of_bound": t["share_of_bound"],
            "canvas_entry_ms": c["ms"], "canvas_entry_graph_ms": c["graph_ms"],
            "canvas_entry_bound_ms": c["bound_ms"],
            "replaced_route_ms": t["replaced_route_ms"],
            "replaced_route_graph_ms": t["replaced_route_graph_ms"]}


def check_results(results, n_frames, in_frame=True) -> int:
    """Per-frame detections are well formed; returns how many there are.
    Raises (not ``assert``: the checks must survive ``python -O``).
    ``in_frame=False`` drops the position check (phase 23's frames)."""
    if len(results) != n_frames:
        raise AssertionError(f"{len(results)} results for {n_frames} frames")
    total = 0
    for i, r in enumerate(results):
        b, s, lab = r["boxes"], r["scores"], r["labels"]
        # a box passed the IoF > 0.9 gate of a chip, so it overlaps the
        # chip's crop and hence the frame (it may overhang both)
        checks = {
            "shapes": b.shape == (len(s), 4) and lab.shape == s.shape,
            "finite": np.isfinite(b).all() and np.isfinite(s).all(),
            "scores in (0, 1]": ((s > 0) & (s <= 1)).all(),
            "labels in [0, 10)": ((lab >= 0) & (lab < 10)).all(),
            "x2 >= x1, y2 >= y1": ((b[:, 2] >= b[:, 0])
                                   & (b[:, 3] >= b[:, 1])).all(),
            "overlaps the frame": not in_frame or (
                (b[:, 0] < FRAME_HW[1]) & (b[:, 2] > 0)
                & (b[:, 1] < FRAME_HW[0]) & (b[:, 3] > 0)).all(),
        }
        failed = [name for name, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"frame {i}: detections fail {failed}")
        total += len(s)
    return total


def phase_pipeline(pipe, frames, dev_frames, name="pipeline",
                   kernels=("nms", "paint")) -> dict:
    """warmup, then 3x (run_device_batch, run_batch), with every kernel's
    launch count set to 0 just before and read just after; each kernel of
    ``kernels`` must have launched."""
    from glsdet_tpu_torch.ops import bottleneck_kernel, gn_kernel, nms_kernel
    from glsdet_tpu_torch.ufp import paint_kernel

    t0 = time.perf_counter()
    pipe.warmup(FRAME_HW)
    warm_s = time.perf_counter() - t0
    coarse = pipe.coarse_packed(dev_frames).cpu().numpy()
    n_coarse = int((coarse[..., 6] > 0.5).sum())
    if n_coarse < 4:
        raise AssertionError(f"only {n_coarse} coarse detections")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nms_kernel.launches = 0
    paint_kernel.launches = 0
    paint_kernel.inputs_launches = 0
    gn_kernel.launches = 0
    bottleneck_kernel.launches = 0
    times_dev, times_host = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        res_dev = pipe.run_device_batch(dev_frames)
        torch.cuda.synchronize()
        times_dev.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        res_host = pipe.run_batch(frames)
        torch.cuda.synchronize()
        times_host.append(time.perf_counter() - t0)
    launches = {"nms": nms_kernel.launches, "paint": paint_kernel.launches,
                "gn": gn_kernel.launches,
                "bottleneck": bottleneck_kernel.launches}
    peak = torch.cuda.max_memory_allocated()
    if min(launches[k] for k in kernels) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    if paint_kernel.inputs_launches != launches["paint"]:
        raise AssertionError(
            f"{launches['paint']} painter launches, of them "
            f"{paint_kernel.inputs_launches} the path entry")
    n_dev = check_results(res_dev, N_FRAMES)
    n_host = check_results(res_host, N_FRAMES)
    if n_dev == 0 or n_host == 0:
        raise AssertionError("stage 2 produced no detections")
    out = {"launches": launches, "peak_mem_bytes": peak,
           "img_per_s_device": N_FRAMES / float(np.median(times_dev)),
           "img_per_s_host": N_FRAMES / float(np.median(times_host)),
           "no_sync_calls": check_no_sync(pipe, dev_frames)}
    log(name, frames=N_FRAMES, frame_hw=FRAME_HW, warmup_s=warm_s,
        coarse_dets=n_coarse, stage2_dets_device=n_dev,
        stage2_dets_host=n_host,
        device_batch_s=times_dev, host_batch_s=times_host, **out)
    return out


def check_no_sync(pipe, dev_frames) -> dict:
    """One run_device_batch with every call of coarse_packed and
    stage2_packed under torch.cuda.set_sync_debug_mode("error"): an op
    inside a stage that waits for the card raises.  The transfers between
    the stages (the coarse read-back, the upload of idx and the rows, the
    results' read-back) sync by design and stay outside.  Returns the
    number of calls checked."""
    calls = {"coarse_packed": 0, "stage2_packed": 0}

    def strict(name, fn):
        def call(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            calls[name] += 1
            return out
        return call

    for name in calls:
        setattr(pipe, name, strict(name, getattr(pipe, name)))
    try:
        check_results(pipe.run_device_batch(dev_frames), N_FRAMES)
        torch.cuda.synchronize()
    finally:
        for name in calls:
            delattr(pipe, name)
    if min(calls.values()) < 1:
        raise AssertionError(f"no-sync check saw no stage call: {calls}")
    return calls


def phase_profile(pipe, dev_frames, name="profile") -> None:
    """Where the time of one ``run_device_batch`` goes: each stage called
    as the pipeline calls it, timed alone (ms); the models alone on inputs
    of the shapes and memory format the pipeline gives them (channels-last
    strides, from the NHWC frames and canvases); and torch.profiler's
    device busy time and the ops that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from glsdet_tpu_torch.eval.two_stage import (_fuse_packed, _scale_packed,
                                                 unpack_detections)

    b = dev_frames.shape[0]
    stages = {"coarse_stage": cuda_ms(
        lambda: pipe.coarse_packed(dev_frames), 3)}
    x = torch.randn(b, *COARSE_HW, 3, device=DEVICE).to(pipe.dtype)
    with torch.inference_mode():
        stages["coarse_model"] = cuda_ms(
            lambda: pipe.coarse_net(x.permute(0, 3, 1, 2)), 3)
    packed = pipe.coarse_packed(dev_frames).cpu().numpy()
    dets = unpack_detections(packed)
    t0 = time.perf_counter()
    jobs = pipe._pack_chunk([tuple(FRAME_HW)] * b, list(range(b)), dets)
    stages["host_pack"] = 1e3 * (time.perf_counter() - t0)
    for bucket, job_list in jobs.items():
        rows = [j[1] for j in job_list]
        idx = torch.tensor(rows).to(DEVICE)
        regs = torch.from_numpy(np.stack([j[2] for j in job_list])).to(DEVICE)
        gdets = None
        if pipe.fuse_global:
            gdets = torch.from_numpy(_scale_packed(
                packed[rows], FRAME_HW[1] / COARSE_HW[1],
                FRAME_HW[0] / COARSE_HW[0])).to(DEVICE)
            # the group's unfused result is the fusion's local set
            loc = pipe.stage2_packed(dev_frames, idx, regs, bucket)
            local = (loc[..., :4].contiguous(), loc[..., 4].contiguous(),
                     loc[..., 5].long(), loc[..., 6] > 0.5)
            stages[f"fusion_{bucket}x{len(job_list)}"] = cuda_ms(
                lambda: _fuse_packed(gdets, *local,
                                     iou_thr=pipe.fusion_nms_thr,
                                     max_out=pipe.max_chip))
        stages[f"stage2_{bucket}x{len(job_list)}"] = cuda_ms(
            lambda: pipe.stage2_packed(dev_frames, idx, regs, bucket, gdets),
            3)
        m = torch.randn(len(job_list), bucket, bucket, 3,
                        device=DEVICE).to(pipe.dtype)
        with torch.inference_mode():
            stages[f"mp_model_{bucket}x{len(job_list)}"] = cuda_ms(
                lambda: pipe.mp_net(m.permute(0, 3, 1, 2)), 3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.run_device_batch(dev_frames)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # kernel rows sum the busy time; op rows carry their kernels' time
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    # device rows: the port's own kernels (launched through ctypes, under
    # no aten op) show only here
    kerns = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                   key=lambda e: -e.self_device_time_total)
    # the elementwise passes an int8 tower step used to run between the
    # GEMM and the GN kernel (a multiply and a cast per step)
    op_calls = {e.key: e.count for e in events
                if e.device_type == DeviceType.CPU
                and e.key in ("aten::mul", "aten::_to_copy", "aten::copy_")}
    log(name, stage_ms=stages, profiled_wall_ms=wall_ms,
        device_busy_ms=device_ms,
        device_idle_share=max(0.0, 1.0 - device_ms / wall_ms),
        top_ops_ms=[(e.key, e.self_device_time_total / 1e3, e.count)
                    for e in ops[:12]],
        top_kernels_ms=[(e.key[:80], e.self_device_time_total / 1e3, e.count)
                        for e in kerns[:8]],
        op_calls=op_calls)


def gn_affine():
    """The GroupNorm affine of the timed GN calls, and the RandomState
    that made it."""
    rs = np.random.RandomState(2)
    gamma = torch.from_numpy(rs.uniform(0.5, 1.5, GN_C).astype(np.float32)
                             ).to(DEVICE)
    beta = torch.from_numpy((rs.randn(GN_C) * 0.3).astype(np.float32)
                            ).to(DEVICE)
    return rs, gamma, beta


def gn_acc_inputs(b, hw, seed):
    """int32 accumulators of a head-tower convolution's magnitude, with
    per-channel offsets, and QConv-like per-channel scales deq."""
    g = torch.Generator(DEVICE).manual_seed(seed)
    acc = (torch.randn(b, hw, hw, GN_C, device=DEVICE, generator=g) * 3000
           + torch.randn(GN_C, device=DEVICE, generator=g) * 800
           ).round().to(torch.int32)
    deq = (torch.rand(GN_C, device=DEVICE, generator=g) + 0.5) * (0.03 / 127)
    return acc, deq


def kernel_times(fn, iters: int = 5) -> dict:
    """Device time per call of each kernel ``fn`` launches, by name
    (torch.profiler): how a GN call splits into its passes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = re.search(r"::(\w+)[<(]", e.key)
            out[name.group(1) if name else e.key[:60]] = (
                e.self_device_time_total / 1e3 / iters)
    return out


def check_codes(got, want, what) -> dict:
    """+-1 code and at most 1e-3 of the codes differing (the f32 order of
    the group statistics); returns the error and the differing share."""
    torch.cuda.synchronize()
    d = (got.int() - want.int()).abs()
    err, share = float(d.max()), float((d > 0).float().mean())
    if err > 1 or share > 1e-3:
        raise AssertionError(f"GN {what}: max |dq| {err}, {share:.2e} of "
                             f"the codes differ")
    return {"max_abs_err": err, "share_differing": share}


def phase_gn() -> dict:
    """Both GN entries vs their plain versions at every head level of both
    buckets, then timed at the 1152 bucket's levels (module docstring,
    phase 4)."""
    from glsdet_tpu_torch.ops import gn_kernel
    from glsdet_tpu_torch.ops.gn_kernel import (
        gn_relu_quant, gn_relu_quant_acc, gn_relu_quant_acc_plain,
        gn_relu_quant_plain)

    rs, gamma, beta = gn_affine()
    s_out, worst, levels = GN_S_OUT, 0.0, []
    for bucket, sizes in LEVELS.items():
        for hw in sizes:
            off = torch.from_numpy(rs.randn(GN_C).astype(np.float32) * 0.5)
            y = (torch.randn(N_FRAMES, hw, hw, GN_C, device=DEVICE,
                             generator=torch.Generator(DEVICE).manual_seed(hw))
                 * 1.5 + off.to(DEVICE))
            y[..., 8:16] = 0.75                   # one constant group
            y = y.to(torch.bfloat16)
            acc, deq = gn_acc_inputs(N_FRAMES, hw, hw + 1)
            acc[..., 8:16] = 3072
            deq[8:16] = 2.0 ** -12                # y = 0.75 exactly
            row = {"bucket": bucket, "hw": hw}
            for name, got, want in (
                    ("acc", gn_relu_quant_acc(acc, deq, gamma, beta, s_out),
                     gn_relu_quant_acc_plain(acc, deq, gamma, beta, s_out)),
                    ("bf16", gn_relu_quant(y, gamma, beta, s_out),
                     gn_relu_quant_plain(y, gamma, beta, s_out))):
                c = check_codes(got, want, f"{name} {bucket}/{hw}")
                if not torch.equal(got[..., 8:16], want[..., 8:16]):
                    raise AssertionError(f"GN {name} {bucket}/{hw}: "
                                         f"constant group")
                worst = max(worst, c["max_abs_err"])
                row[name] = c
            # accumulators in [-8, 8] at deq = 1/8: every f32 partial sum
            # is exact in any order, so the codes must equal the plain
            # version's (the requant's division included)
            small = torch.randint(-8, 9, acc.shape, dtype=torch.int32,
                                  device=DEVICE,
                                  generator=torch.Generator(DEVICE)
                                  .manual_seed(hw))
            eighth = torch.full_like(deq, 0.125)
            if not torch.equal(
                    gn_relu_quant_acc(small, eighth, gamma, beta, s_out),
                    gn_relu_quant_acc_plain(small, eighth, gamma, beta,
                                            s_out)):
                raise AssertionError(f"GN acc {bucket}/{hw}: codes differ "
                                     f"where the sums are exact")
            row["exact_sums_equal"] = True
            levels.append(row)
            del y, acc, small
    # times at the levels the path runs: all 16 mosaics land in the 1152
    # bucket, whose int8 towers launch the kernel 8 times per level (2
    # towers x 4 GroupNorms), 40 per stage-2 group
    keys = ("acc_ms", "acc_graph_ms", "acc_plain_ms", "acc_bound_ms",
            "bf16_ms", "bf16_graph_ms", "bf16_plain_ms", "bf16_bound_ms",
            "replaced_route_ms", "replaced_route_graph_ms",
            "group_norm_only_ms")
    timed, total = [], dict.fromkeys(keys, 0.0)
    share = {"bytes": 0.0, "operations": 0.0}
    for hw in LEVELS[1152]:
        acc, deq = gn_acc_inputs(N_FRAMES, hw, hw)
        y = (acc.float() * deq).to(torch.bfloat16)
        y_cl = y.permute(0, 3, 1, 2)
        runs = {
            "acc": lambda: gn_relu_quant_acc(acc, deq, gamma, beta, s_out),
            "bf16": lambda: gn_relu_quant(y, gamma, beta, s_out),
            # what the towers ran before: QConv's f32 dequantize, the cast
            # to bf16, then the bf16 entry
            "replaced_route": lambda: gn_relu_quant(
                (acc.float() * deq).to(torch.bfloat16), gamma, beta, s_out)}
        t = {**{f"{k}_ms": cuda_ms(fn) for k, fn in runs.items()},
             **{f"{k}_graph_ms": graph_ms(fn) for k, fn in runs.items()},
             "acc_plain_ms": cuda_ms(lambda: gn_relu_quant_acc_plain(
                 acc, deq, gamma, beta, s_out), 3),
             "bf16_plain_ms": cuda_ms(
                 lambda: gn_relu_quant_plain(y, gamma, beta, s_out), 3),
             # no one PyTorch call computes GN -> ReLU -> int8; group_norm
             # alone (NCHW channels-last, bf16 out) is a partial yardstick
             "group_norm_only_ms": cuda_ms(
                 lambda: torch.nn.functional.group_norm(
                     y_cl, GN_GROUPS, gamma.to(y.dtype), beta.to(y.dtype)))}
        # the accumulator entry reads int32 and writes int8 once (5 bytes an
        # element), the bf16 entry reads bf16 (3); ~12 f32 operations each
        n = acc.numel()
        b_acc = bound(5 * n, 12 * n, PEAK_F32)
        b_bf16 = bound(3 * n, 12 * n, PEAK_F32)
        t["acc_bound_ms"], t["bf16_bound_ms"] = (b_acc["bound_ms"],
                                                 b_bf16["bound_ms"])
        plans = {"acc": gn_kernel.plan(torch.int32, N_FRAMES, hw, hw, GN_C),
                 "bf16": gn_kernel.plan(torch.bfloat16, N_FRAMES, hw, hw,
                                        GN_C)}
        kernel_ms = kernel_times(runs["acc"])
        timed.append({"hw": hw, **t, "bound_by": b_acc["bound_by"],
                      "acc_share_of_bound": t["acc_bound_ms"] / t["acc_ms"],
                      "bf16_share_of_bound": t["bf16_bound_ms"]
                      / t["bf16_ms"],
                      "replaced_route_share_of_bound": t["acc_bound_ms"]
                      / t["replaced_route_ms"],
                      "plan": plans, "acc_kernels_ms": kernel_ms})
        for key in keys:
            total[key] += GN_PER_LEVEL * t[key]
        share[b_acc["bound_by"]] += b_acc["bound_ms"]
        del acc, y, y_cl
    log("gn", levels=levels, batch=N_FRAMES, channels=GN_C, timed=timed,
        launches_per_level=GN_PER_LEVEL, per_stage2_group=total)
    for how in ("", "_graph"):
        if total[f"acc{how}_ms"] >= total[f"replaced_route{how}_ms"]:
            raise AssertionError(
                f"GN: the accumulator entry's 40 launches take "
                f"{total[f'acc{how}_ms']:.3f} ms, the route it replaces "
                f"{total[f'replaced_route{how}_ms']:.3f} ms ({how or 'eager'})")
    return {"max_abs_err": worst, "ms": total["acc_ms"],
            "graph_ms": total["acc_graph_ms"],
            "plain_ms": total["acc_plain_ms"], "library_ms": None,
            "bound_ms": total["acc_bound_ms"],
            "bound_by": max(share, key=share.get),
            "replaced_route_ms": total["replaced_route_ms"],
            "bf16_entry_ms": total["bf16_ms"],
            "group_norm_only_ms": total["group_norm_only_ms"]}


def phase_int8_conv() -> None:
    """The int8 convolution's torch._int_mm route vs its float64 version
    (exact: |acc| < 2**53) at the path's shapes; int32 results equal."""
    from glsdet_tpu_torch.ops.int8_conv import Int8Conv2d, im2col

    g = torch.Generator(device=DEVICE).manual_seed(3)
    out = []
    # (B, H, W, Cin, Cout, k, stride): head tower, ResNet stride-2 3x3,
    # a 1x1 1024 -> 256 FPN lateral, the batch-1 P7 level
    for b, h, w, cin, cout, k, st in ((16, 128, 128, 256, 256, 3, 1),
                                      (16, 128, 128, 64, 64, 3, 2),
                                      (16, 72, 72, 1024, 256, 1, 1),
                                      (1, 9, 9, 256, 256, 3, 1)):
        x = torch.randint(-127, 128, (b, h, w, cin), dtype=torch.int8,
                          device=DEVICE, generator=g)
        q_w = torch.randint(-127, 128, (cout, cin, k, k), dtype=torch.int8,
                            device=DEVICE, generator=g)
        conv = Int8Conv2d(q_w, st, k // 2)
        got, want = conv(x), conv(x, plain=True)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"int8 conv {(b, h, w, cin, cout, k, st)}:"
                                 f" {int((got != want).sum())} differ")
        out.append({"shape": [b, h, w, cin, cout, k, st], "equal": True})
    b, h, w, c = 16, 128, 128, 256
    x = torch.randint(-127, 128, (b, h, w, c), dtype=torch.int8,
                      device=DEVICE, generator=g)
    conv = Int8Conv2d(torch.randint(-127, 128, (c, c, 3, 3), device=DEVICE,
                                    dtype=torch.int8, generator=g), 1, 1)
    xb = torch.randn(b, c, h, w, device=DEVICE, dtype=torch.bfloat16
                     ).contiguous(memory_format=torch.channels_last)
    wb = torch.randn(c, c, 3, 3, device=DEVICE, dtype=torch.bfloat16)
    cols, _, _ = im2col(x, 3, 3, (1, 1), (1, 1))
    w_t = conv.weight.t()
    log("int8_conv", checks=out, head_shape=[b, h, w, c, c, 3],
        int_mm_route_ms=cuda_ms(lambda: conv(x)),
        of_which_im2col_ms=cuda_ms(lambda: im2col(x, 3, 3, (1, 1), (1, 1))),
        of_which_int_mm_ms=cuda_ms(lambda: torch._int_mm(cols, w_t)),
        cudnn_bf16_ms=cuda_ms(lambda: torch.nn.functional.conv2d(
            xb, wb, padding=1)))


def rel_errors(got, ref):
    errs = []
    for g, r in zip(got, ref):
        for gm, rm in zip(g, r):
            gm, rm = gm.float(), rm.float()
            if gm.shape != rm.shape or not torch.isfinite(gm).all():
                raise AssertionError(f"bad output {tuple(gm.shape)}")
            errs.append(float((gm - rm).abs().max() / rm.abs().max()))
    return errs


def phase_int8(pipe, frames, dev_frames, bf16) -> dict:
    """Static int8 end to end (see the module docstring, phase 11)."""
    from glsdet_tpu_torch.native.build import BUILD_DIR
    from glsdet_tpu_torch.ops.quant_static import load_scales, save_scales

    t0 = time.perf_counter()
    scales = pipe.calibrate_int8(frames[:4])
    calib_s = time.perf_counter() - t0
    path = save_scales(os.path.join(BUILD_DIR, "int8_scales.json"), scales)
    if load_scales(path) != scales:
        raise AssertionError("scales changed through save/load")
    t0 = time.perf_counter()
    pipe8 = make_pipeline(seeded_models(), quant8="static",
                          act_scales=load_scales(path))
    build_s = time.perf_counter() - t0
    try:
        coarse_in, mosaic_in = pipe.capture_inputs(frames[:1])
        with torch.inference_mode():
            checks = {
                "yolox": rel_errors(pipe8.coarse_net(coarse_in[0]),
                                    pipe.coarse(coarse_in[0])),
                "mpdet": rel_errors(pipe8.mp_net(mosaic_in[0]),
                                    pipe.mp(mosaic_in[0]))}
        worst = {k: max(v) for k, v in checks.items()}
        if max(worst.values()) >= 0.3:
            raise AssertionError(f"int8 vs bf16 rel err {checks}")
        log("models_int8_vs_bf16", max_rel_err=worst, bound=0.3,
            coarse_input=list(coarse_in[0].shape),
            mosaic_input=list(mosaic_in[0].shape),
            scales=[len(s) for s in scales], calibrate_s=calib_s,
            build_s=build_s)
        res = phase_pipeline(pipe8, frames, dev_frames, "pipeline_int8",
                             ("nms", "paint", "gn"))
        n = res["launches"]
        if n["gn"] != 40 * n["paint"]:
            raise AssertionError(f"GN kernel launched {n['gn']} times for "
                                 f"{n['paint']} stage-2 groups, not 40 each")
        log("int8_vs_bf16", int8_img_per_s_device=res["img_per_s_device"],
            bf16_img_per_s_device=bf16["img_per_s_device"],
            int8_img_per_s_host=res["img_per_s_host"],
            bf16_img_per_s_host=bf16["img_per_s_host"],
            int8_peak_mem_bytes=res["peak_mem_bytes"],
            bf16_peak_mem_bytes=bf16["peak_mem_bytes"])
        phase_nms_path(pipe8, dev_frames, "nms_path_int8")
        phase_tower_ops(pipe8)
        phase_profile(pipe8, dev_frames, "profile_int8")
    finally:
        pipe8.close()
    return res


def phase_tower_ops(pipe8) -> None:
    """The ops of one int8 head tower (4 int8 convolutions, each followed
    by the GN kernel) on a 36x36 level of 16 mosaics: its four _int_mm
    GEMMs and a single float multiply, the tower output's dequantization.
    A float dequantize pass between a GEMM and the GN kernel would add a
    multiply per convolution."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from glsdet_tpu_torch.ops.quant_static import _Int8Tower

    tower = next(m for m in pipe8.mp_net.modules()
                 if isinstance(m, _Int8Tower))
    x = torch.randn(N_FRAMES, GN_C, 36, 36, device=DEVICE
                    ).to(pipe8.dtype)
    with torch.inference_mode():
        tower(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tower(x)
            torch.cuda.synchronize()
    calls = {e.key: e.count for e in prof.key_averages()
             if e.device_type == DeviceType.CPU and e.key.startswith("aten::")}
    n_conv = len(tower.convs)
    if (calls.get("aten::_int_mm") != n_conv
            or calls.get("aten::mul", 0) != 1):
        raise AssertionError(f"int8 tower ops: {calls}")
    log("tower_ops", convs=n_conv, int_mm=calls["aten::_int_mm"],
        mul=calls["aten::mul"], to_copy=calls.get("aten::_to_copy", 0),
        calls=calls)


def bottleneck_bound(b, h, w, c) -> dict:
    """x read and y written once in bf16, the folded weights and biases
    read once; 34 C^2 FLOP per pixel on bf16 tensor cores."""
    nbytes = 2 * 2 * b * h * w * 4 * c + 2 * 17 * c * c + 4 * 6 * c
    return bound(nbytes, 34 * c * c * b * h * w, PEAK_BF16)


def l2_weight_bytes(b, h, w, c) -> dict:
    """Weight bytes that leave L2 in one launch, counted from the tile
    plan: all 17 C^2 bf16 weights once per cluster of CL tiles of TH x 16
    pixels (``PLAN``); beside them the first design's (every TH x 16 tile
    its own, TH = 8, 4, 2 at C <= 128, 256, 512)."""
    from glsdet_tpu_torch.ops.bottleneck_kernel import PLAN

    th, cl = PLAN[c][:2]
    tiles = b * -(-h // th) * -(-w // 16)
    th0 = 8 if c <= 128 else (4 if c == 256 else 2)
    return {"l2_weight_bytes": -(-tiles // cl) * 34 * c * c,
            "l2_weight_bytes_first_design":
                b * -(-h // th0) * -(-w // 16) * 34 * c * c}


def check_bottleneck(x, ops, packed=None) -> dict:
    """Kernel vs plain version on one input; raises beyond 5e-3 of the
    plain version's maximum."""
    from glsdet_tpu_torch.ops import bottleneck_kernel as bk

    got = bk.fused_bottleneck(x, *ops, packed=packed)
    want = bk.fused_bottleneck_plain(x, *ops)
    torch.cuda.synchronize()
    if got.shape != x.shape or not torch.isfinite(got.float()).all():
        raise AssertionError(f"bottleneck {tuple(x.shape)}: bad output")
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if err > 5e-3 * scale:
        raise AssertionError(f"bottleneck {tuple(x.shape)}: max abs err "
                             f"{err} against max |plain| {scale}")
    return {"shape": list(x.shape), "max_abs_err": err,
            "max_rel_err": err / scale,
            "share_differing": float((got != want).float().mean())}


def phase_bottleneck() -> dict:
    """The fused-bottleneck kernel at the path's shapes and at edge shapes
    (module docstring, phase 5)."""
    from glsdet_tpu_torch.models import MPDet
    from glsdet_tpu_torch.ops import bottleneck_kernel as bk
    from glsdet_tpu_torch.ops.fused_infer import FusedBottleneck

    mp = MPDet(10, DEPTH, generator=torch.Generator().manual_seed(0))
    g = torch.Generator(DEVICE).manual_seed(4)
    stages, total = [], {"ms": 0.0, "graph_ms": 0.0, "plain_ms": 0.0,
                         "bound_ms": 0.0, "cudnn_chain_ms": 0.0}
    bound_share = {"bytes": 0.0, "operations": 0.0}
    worst, worst_rel = 0.0, 0.0
    for name, (hw, c, n_blocks) in STAGES.items():
        fused = FusedBottleneck(getattr(mp.backbone, f"{name}_1")).eval().to(
            DEVICE, torch.bfloat16)
        ops = (fused.w1, fused.b1, fused.w2, fused.b2, fused.w3, fused.b3)
        packed = (fused.w1p, fused.w2p, fused.w3p)
        x = torch.relu(torch.randn(N_FRAMES, hw, hw, 4 * c, device=DEVICE,
                                   generator=g)).to(torch.bfloat16)
        check = check_bottleneck(x, ops, packed)
        x_nchw = x.permute(0, 3, 1, 2)          # channels-last strides
        with torch.inference_mode():
            times = {
                "kernel_ms": cuda_ms(
                    lambda: bk.fused_bottleneck(x, *ops, packed=packed)),
                "kernel_graph_ms": graph_ms(
                    lambda: bk.fused_bottleneck(x, *ops, packed=packed)),
                "plain_ms": cuda_ms(
                    lambda: bk.fused_bottleneck_plain(x, *ops), 3),
                "cudnn_chain_ms": cuda_ms(lambda: fused.block(x_nchw)),
            }
            stock = fused.block(x_nchw).permute(0, 2, 3, 1).float()
        ref = bk.fused_bottleneck(x, *ops, packed=packed).float()
        b = bottleneck_bound(N_FRAMES, hw, hw, c)
        stages.append({"stage": name, **check, **times, **b,
                       "share_of_bound": b["bound_ms"] / times["kernel_ms"],
                       "tflops": 34 * c * c * N_FRAMES * hw * hw
                       / times["kernel_ms"] / 1e9,
                       "vs_cudnn_chain": times["kernel_ms"]
                       / times["cudnn_chain_ms"],
                       **l2_weight_bytes(N_FRAMES, hw, hw, c),
                       "blocks_per_mpdet": n_blocks,
                       "kernel_vs_stock_rel_err": float(
                           (ref - stock).abs().max() / stock.abs().max())})
        log("bottleneck", **stages[-1])
        worst, worst_rel = (max(worst, check["max_abs_err"]),
                            max(worst_rel, check["max_rel_err"]))
        for key, t in (("ms", times["kernel_ms"]),
                       ("graph_ms", times["kernel_graph_ms"]),
                       ("plain_ms", times["plain_ms"]),
                       ("bound_ms", b["bound_ms"]),
                       ("cudnn_chain_ms", times["cudnn_chain_ms"])):
            total[key] += n_blocks * t
        bound_share[b["bound_by"]] += n_blocks * b["bound_ms"]
        del x, x_nchw, stock, ref
    # single-row image, odd H, W off the 16-pixel tile, 4C = 64
    edges = []
    for b, h, w, cin in ((1, 1, 40, 256), (2, 9, 20, 512),
                         (2, 12, 27, 1024), (3, 16, 16, 64)):
        c = cin // 4

        def rnd(*shape, scale):
            return torch.randn(*shape, device=DEVICE, generator=g) * scale

        x = torch.relu(rnd(b, h, w, cin, scale=1.0)).to(torch.bfloat16)
        ops = (rnd(cin, c, scale=cin ** -0.5).to(torch.bfloat16),
               rnd(c, scale=0.1),
               rnd(9 * c, c, scale=(9 * c) ** -0.5).to(torch.bfloat16),
               rnd(c, scale=0.1),
               rnd(c, cin, scale=c ** -0.5).to(torch.bfloat16),
               rnd(cin, scale=0.1))
        edges.append(check_bottleneck(x, ops))
        worst = max(worst, edges[-1]["max_abs_err"])
        worst_rel = max(worst_rel, edges[-1]["max_rel_err"])
    log("bottleneck_edges", checks=edges, bound=5e-3)
    # one MP-Det forward's 12 launches at the 1152 bucket
    log("bottleneck_per_mpdet", **total,
        vs_cudnn_chain=total["ms"] / total["cudnn_chain_ms"])
    return {"max_abs_err": worst, "max_rel_err": worst_rel,
            "ms": total["ms"], "graph_ms": total["graph_ms"],
            "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": max(bound_share, key=bound_share.get),
            "library_ms": None, "cudnn_chain_ms": total["cudnn_chain_ms"]}


def phase_fused(pipe, frames, dev_frames, bf16) -> dict:
    """The fused pipeline (module docstring, phase 12)."""
    from glsdet_tpu_torch.ops.fused_infer import wrap_model_fused

    coarse, mp = seeded_models()
    pipe_f = make_pipeline((coarse, wrap_model_fused(mp)))
    try:
        _, mosaic_in = pipe.capture_inputs(frames[:1])
        with torch.inference_mode():
            errs = rel_errors(pipe_f.mp(mosaic_in[0]), pipe.mp(mosaic_in[0]))
        if max(errs) >= 0.15:
            raise AssertionError(f"fused vs bf16 MP-Det rel err {errs}")
        log("mpdet_fused_vs_bf16", max_rel_err=max(errs), bound=0.15,
            mosaic_input=list(mosaic_in[0].shape))
        res = phase_pipeline(pipe_f, frames, dev_frames, "pipeline_fused",
                             ("nms", "paint", "bottleneck"))
        n = res["launches"]
        if n["bottleneck"] != 12 * n["paint"]:
            raise AssertionError(
                f"bottleneck kernel launched {n['bottleneck']} times for "
                f"{n['paint']} stage-2 groups, not 12 each")
        log("fused_vs_bf16", fused_img_per_s_device=res["img_per_s_device"],
            bf16_img_per_s_device=bf16["img_per_s_device"],
            fused_img_per_s_host=res["img_per_s_host"],
            bf16_img_per_s_host=bf16["img_per_s_host"],
            fused_peak_mem_bytes=res["peak_mem_bytes"],
            bf16_peak_mem_bytes=bf16["peak_mem_bytes"])
        phase_profile(pipe_f, dev_frames, "profile_fused")
    finally:
        pipe_f.close()
    return res


def phase_dynamic(dev_frames) -> None:
    pipe = make_pipeline(seeded_models(), quant8=True)
    try:
        t0 = time.perf_counter()
        res = pipe.run_device_batch(dev_frames)
        torch.cuda.synchronize()
        n = check_results(res, N_FRAMES)
        if n == 0:
            raise AssertionError("dynamic int8: no detections")
        log("dynamic_int8", seconds=time.perf_counter() - t0, detections=n)
    finally:
        pipe.close()


# -- the serving facades (phases 14-16) ------------------------------------

SERVE_MAX_BATCH = 8          # TwoStageDetector's default
FUSION_K = 700               # the fusion's NMS rows: 200 coarse + 500 local
# a ladder cut so that square packing takes other buckets than 1152
LADDER = (768, 2688)


def write_seeded_models(root: str):
    """seeded_models() as the state-dict files the facades load."""
    paths = (os.path.join(root, "coarse_det.pt"),
             os.path.join(root, "mp_det_res50.pt"))
    for model, path in zip(seeded_models(), paths):
        torch.save(model.state_dict(), path)
    return paths


def make_facade(paths, buckets=None, **kw):
    """TwoStageDetector with its defaults (fusion on, square packing, the
    config's bucket ladder, max_batch 8) on the seeded weights; only the
    coarse threshold is lowered, so that stage 2 fires on random weights
    as in the bench fixture, and ``buckets`` replaces the ladder."""
    from glsdet_tpu_torch.apis import TwoStageDetector

    opts = {"eval.coarse_score_thr": 1e-4}
    if buckets:
        opts["eval.mosaic_buckets"] = tuple(buckets)
    return TwoStageDetector("coarse_det", paths[0], "mp_det_res50",
                            paths[1], coarse_options=opts, device=DEVICE,
                            **kw)


def reset_launches() -> None:
    from glsdet_tpu_torch.ops import bottleneck_kernel, gn_kernel, nms_kernel
    from glsdet_tpu_torch.ufp import paint_kernel

    nms_kernel.launches = paint_kernel.launches = 0
    paint_kernel.inputs_launches = gn_kernel.launches = 0
    bottleneck_kernel.launches = 0
    for m in (nms_kernel, paint_kernel, gn_kernel, bottleneck_kernel):
        m.launches_by_device.clear()


def read_launches() -> dict:
    from glsdet_tpu_torch.ops import bottleneck_kernel, gn_kernel, nms_kernel
    from glsdet_tpu_torch.ufp import paint_kernel

    return {"nms": nms_kernel.launches, "paint": paint_kernel.launches,
            "paint_inputs": paint_kernel.inputs_launches,
            "gn": gn_kernel.launches,
            "bottleneck": bottleneck_kernel.launches}


def read_launches_by_card() -> dict:
    """Each wrapper's launches since the last reset_launches, per card,
    as the wrappers count them where they launch."""
    from glsdet_tpu_torch.ops import bottleneck_kernel, gn_kernel, nms_kernel
    from glsdet_tpu_torch.ufp import paint_kernel

    return {name: {f"cuda:{i}": n for i, n in
                   sorted(m.launches_by_device.items())}
            for name, m in (("nms", nms_kernel), ("paint", paint_kernel),
                            ("gn", gn_kernel),
                            ("bottleneck", bottleneck_kernel))}


def capture_serving(facade, frames):
    """One detect_batch of the facade with the inputs of every stage-2
    group, every NMS launch and every fusion captured (clones on the
    card), and the kernels' launch counts of that run alone.  Also checks
    that stage 2 ran for every frame (no coarse fallback)."""
    from glsdet_tpu_torch.eval import two_stage
    from glsdet_tpu_torch.ops import nms as nms_mod

    pipe = facade.pipeline
    groups, nms_calls, fusions = [], [], []
    inner = (pipe.stage2_packed, nms_mod.nms_sorted_cuda,
             two_stage._fuse_packed)

    def stage2(imgs, idx, regs, hw, gdets=None):
        groups.append((imgs, idx.clone(), regs.clone(), hw))
        return inner[0](imgs, idx, regs, hw, gdets)

    def nms(bx, vd, thr, offset=0.0):
        nms_calls.append((bx.clone(), vd.clone(), float(thr), float(offset)))
        return inner[1](bx, vd, thr, offset)

    def fuse(gdets, *local, **kw):
        out = inner[2](gdets, *local, **kw)
        fusions.append((gdets.clone(), [t.clone() for t in local],
                        [t.clone() for t in out], kw))
        return out

    pipe.stage2_packed = stage2
    nms_mod.nms_sorted_cuda = nms
    two_stage._fuse_packed = fuse
    try:
        torch.cuda.synchronize()
        reset_launches()
        h = facade.submit_batch(frames)
        facade.advance_batch(h)
        res = facade.collect_batch(h)
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        del pipe.stage2_packed
        nms_mod.nms_sorted_cuda, two_stage._fuse_packed = inner[1:]
    if len(h.pending) != len(frames) or h.fallbacks:
        raise AssertionError(f"stage 2 ran for {len(h.pending)} of "
                             f"{len(frames)} frames")
    return res, launches, len(h.chunks), groups, nms_calls, fusions


def check_served(results, n_frames, score_thr, in_frame=True) -> int:
    """check_results, and every score at least the facade's threshold."""
    n = check_results(results, n_frames, in_frame)
    low = [i for i, r in enumerate(results)
           if len(r["scores"]) and r["scores"].min() < score_thr]
    if low:
        raise AssertionError(f"frames {low}: scores below {score_thr}")
    return n


def check_fusions(fusions) -> dict:
    """Each captured fusion: the card's output equals _fuse_packed on the
    CPU on the same sets, and every valid output row (box, score, label)
    is a valid row of the frame's coarse set or of its local set."""
    from glsdet_tpu_torch.eval.two_stage import _fuse_packed

    rows = 0
    for gdets, local, out, kw in fusions:
        want = _fuse_packed(gdets.cpu(), *(t.cpu() for t in local), **kw)
        for name, a, b in zip(("boxes", "scores", "labels", "valid"), out,
                              want):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"fusion {name}: the card's differs "
                                     f"from the CPU's")
        lb, ls, ll, lv = (t.cpu() for t in local)
        cand = torch.cat([
            gdets[..., :6].cpu(),
            torch.cat([lb, ls[..., None], ll[..., None].float()], -1)], 1)
        cand_valid = torch.cat([gdets[..., 6].cpu() > 0.5, lv], 1)
        ob, os_, ol, ov = (t.cpu() for t in out)
        got = torch.cat([ob, os_[..., None], ol[..., None].float()], -1)
        hit = ((got[:, :, None] == cand[:, None]).all(-1)
               & cand_valid[:, None]).any(-1)
        if not bool(hit[ov].all()):
            raise AssertionError(f"{int((~hit & ov).sum())} fused rows are "
                                 f"in neither input set")
        rows += int(ov.sum())
    return {"fusions": len(fusions), "fused_rows_checked": rows}


def phase_serve_kernels(groups, nms_calls) -> dict:
    """B1 at every bucket the facade's run used, torch.equal to
    mosaic_inputs_plain and timed (check_paint_groups); B2 at the
    fusion's launches (K = 700, offset 0, 0.65), keep masks equal to the
    plain version, timed."""
    paints = check_paint_groups(groups)
    fusion = [c for c in nms_calls if c[0].shape[1] == FUSION_K]
    if len(fusion) != len(groups):
        raise AssertionError(f"{len(fusion)} fusion NMS launches for "
                             f"{len(groups)} stage-2 groups")
    nms = []
    for bx, vd, thr, off in fusion:
        if (thr, off) != (0.65, 0.0):
            raise AssertionError(f"fusion NMS at thr {thr}, offset {off}")
        keep = check_nms(bx, vd, thr, off, f"fusion {tuple(bx.shape)}")
        t = nms_times(bx, vd, thr, off)
        b = nms_bound(bx, vd, keep)
        nms.append({"batch": bx.shape[0], "k": bx.shape[1],
                    "valid": int(vd.sum()), "kept": int(keep.sum()), **t,
                    **b, "share_of_bound": b["bound_ms"] / t["ms"]})
    return {"paint": paints, "fusion_nms": nms}


# the HTTP clients, run in a process of their own so that they share no
# interpreter lock with the server: argv = url, frames .npy, threads, first
# request id, requests.  Request r sends frame r % len(frames) with r in
# its pixel (0, 0) (3 bytes, big-endian), so that the server side can tell
# every request apart; base64 codes 3 bytes at a time, so the id's
# characters are prepended to the frame's precomputed code.
HTTP_CLIENT = r"""
import base64, json, sys, time, urllib.error, urllib.request
from concurrent.futures import ThreadPoolExecutor
import numpy as np

url, path = sys.argv[1], sys.argv[2]
clients, first, n = (int(a) for a in sys.argv[3:6])
if path.endswith(".npy"):      # JSON raw arrays, the id in pixel (0, 0)
    frames = np.load(path)
    codes = [base64.b64encode(f.tobytes()[3:]) for f in frames]
    tail = ('", "shape": %s, "dtype": "uint8"}'
            % json.dumps(list(frames.shape[1:]))).encode()
else:                          # raw bodies, one per request, end offsets
    with open(path, "rb") as f:
        blob = f.read()
    ends = np.load(path + ".ends.npy")


def body_of(rid):
    if path.endswith(".npy"):
        return (b'{"image": "' + base64.b64encode(rid.to_bytes(3, "big"))
                + codes[rid % len(frames)] + tail)
    k = rid - first
    return blob[(ends[k - 1] if k else 0):ends[k]]


def post(rid):
    req = urllib.request.Request(url, data=body_of(rid), method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            status, text = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, text = e.code, e.read()
    return rid, status, json.loads(text), time.perf_counter() - t0


t0 = time.perf_counter()
with ThreadPoolExecutor(clients) as pool:
    out = list(pool.map(post, range(first, first + n)))
wall = time.perf_counter() - t0
print(json.dumps({"answers": [[r, s, a] for r, s, a, _ in out],
                  "latency_s": [t for *_, t in out], "wall_s": wall}))
"""
HTTP_CLIENTS = 8
HTTP_WINDOW = 256            # requests per sustained window
HTTP_WINDOWS = 1


def request_id(image) -> int:
    """The id a client wrote into a request's pixel (0, 0)."""
    return int.from_bytes(np.ascontiguousarray(image[0, 0]).tobytes(), "big")


def tagged(frames, rid: int) -> np.ndarray:
    """The image request ``rid`` sends."""
    im = frames[rid % len(frames)].copy()
    im[0, 0] = np.frombuffer(rid.to_bytes(3, "big"), np.uint8)
    return im


def http_runs(service, name, frames, tmp, runs, path=None):
    """make_server on 127.0.0.1 (a free port) in a thread; for each
    (first id, requests) of ``runs`` one client process posting that many
    concurrent POST /predictions/<name> with JSON raw-array bodies of
    ``frames`` or, given ``path`` (raw bodies, one per request from the
    run's first id, and their end offsets in ``path + ".ends.npy"``), those
    bodies, from HTTP_CLIENTS threads (bodies made before the clock); then
    /ping, /models and /metrics.  Returns each run's output (``answers``
    as [id, status, answer], ``latency_s``, ``wall_s``) and the metrics
    text; the server is shut down before it returns."""
    import threading
    import urllib.request

    from glsdet_tpu_torch.serve import make_server

    if path is None:
        path = os.path.join(tmp, "http_frames.npy")
        np.save(path, np.stack(frames))
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def get(route):
        with urllib.request.urlopen(base + route, timeout=60) as r:
            return r.status, r.read().decode()

    outs = []
    try:
        for first, n in runs:
            proc = subprocess.run(
                [sys.executable, "-c", HTTP_CLIENT,
                 base + f"/predictions/{name}", path, str(HTTP_CLIENTS),
                 str(first), str(n)], capture_output=True, text=True,
                timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"HTTP clients failed: "
                                     f"{proc.stderr[-2000:]}")
            outs.append(json.loads(proc.stdout.splitlines()[-1]))
        ping, models, metrics = get("/ping"), get("/models"), get("/metrics")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("the HTTP server did not stop")
    if (ping[0] != 200 or json.loads(ping[1]) != {"status": "Healthy"}
            or models[0] != 200 or name not in json.loads(models[1])
            ["models"] or metrics[0] != 200):
        raise AssertionError(f"GET answers: {ping} {models} {metrics[0]}")
    return outs, metrics[1]


def served_dets(items) -> dict:
    return {"boxes": np.array([d["bbox"] for d in items],
                              np.float32).reshape(-1, 4),
            "scores": np.array([d["score"] for d in items], np.float32),
            "labels": np.array([d["class_label"] for d in items], np.int64)}


def same_as_served(served, direct) -> bool:
    """A response equals the direct result up to the JSON's rounding
    (boxes to 2 decimals, scores to 6): the same detections in the same
    order."""
    return (len(served["scores"]) == len(direct["scores"])
            and np.array_equal(served["labels"], direct["labels"])
            and np.allclose(served["boxes"], direct["boxes"], rtol=0,
                            atol=0.0051)
            and np.allclose(served["scores"], direct["scores"], rtol=0,
                            atol=6e-7))


def check_answers(out, first, n, score_thr, in_frame=True) -> dict:
    """One client run: ids first..first+n-1 each answered 200, well
    formed (check_served); returns id -> detections and the run's
    requests/s and latency quantiles (ms)."""
    ids = [a[0] for a in out["answers"]]
    if sorted(ids) != list(range(first, first + n)):
        raise AssertionError(f"answers for ids {ids[:8]}...")
    bad = [(r, code) for r, code, _ in out["answers"] if code != 200]
    if bad:
        raise AssertionError(f"requests answered otherwise than 200: {bad}")
    served = {r: served_dets(items) for r, _, items in out["answers"]}
    check_served(list(served.values()), n, score_thr, in_frame)
    lat_ms = np.sort(1e3 * np.asarray(out["latency_s"]))
    q = lambda p: float(lat_ms[min(int(p * len(lat_ms)),  # noqa: E731
                                   len(lat_ms) - 1)])
    return served, {"requests": n, "wall_s": out["wall_s"],
                    "requests_per_s": n / out["wall_s"],
                    "latency_ms_p50": q(0.5), "latency_ms_p90": q(0.9),
                    "latency_ms_p99": q(0.99)}


def replay_batches(facade, frames, batches, served) -> dict:
    """Every batch the batcher formed, run again through detect_batch with
    the same requests in the same order: each HTTP answer must equal its
    slot's direct result, so no answer went to another request."""
    ids = sorted(r for b in batches for r in b)
    if ids != sorted(served):
        raise AssertionError(f"the batches held {len(ids)} requests, "
                             f"{len(served)} were answered")
    for batch in batches:
        direct = facade.detect_batch([tagged(frames, r) for r in batch])
        for r, d in zip(batch, direct):
            if not same_as_served(served[r], d):
                raise AssertionError(f"request {r}: its answer differs from "
                                     f"its batch's direct result")
    return {"batches_replayed": len(batches), "requests_replayed": len(ids)}


def phase_http(facade, frames, tmp) -> dict:
    """The HTTP path (module docstring, phase 14): a burst of N_FRAMES
    requests, then HTTP_WINDOWS sustained windows of HTTP_WINDOW."""
    from glsdet_tpu_torch.serve import AsyncDetector, DetectionService

    service = DetectionService()
    adet = AsyncDetector(facade, max_batch=SERVE_MAX_BATCH, pipeline_depth=2)
    service.register("glsdet", adet)
    # the requests of each batch the batcher forms, by id
    batches = []
    submit = facade.submit_batch
    facade.submit_batch = lambda images: (
        batches.append([request_id(im) for im in images]), submit(images))[1]
    runs = [(0, N_FRAMES)] + [(N_FRAMES + w * HTTP_WINDOW, HTTP_WINDOW)
                              for w in range(HTTP_WINDOWS)]
    try:
        outs, metrics = http_runs(service, "glsdet", frames,
                                     tmp, runs)
    finally:
        adet.close()
        del facade.submit_batch
    total = sum(n for _, n in runs)
    for want in (f'glsdet_requests_total{{model="glsdet"}} {total}',
                 'glsdet_errors_total{model="glsdet"} 0'):
        if want not in metrics:
            raise AssertionError(f"/metrics lacks {want!r}")
    served, windows = {}, []
    for (first, n), out in zip(runs, outs):
        got, stats = check_answers(out, first, n, facade.score_thr)
        served.update(got)
        in_run = [len(b) for b in batches if first <= b[0] < first + n]
        stats.update(batches=len(in_run),
                     mean_batch=float(np.mean(in_run)) if in_run else 0.0)
        windows.append(stats)
    replay = replay_batches(facade, frames, batches, served)
    # the burst beside one detect_batch of its 16 requests, for information
    # (batches of another composition may differ in bf16's last bit)
    burst = facade.detect_batch([tagged(frames, r) for r in range(N_FRAMES)])
    equal = sum(same_as_served(served[r], d) for r, d in enumerate(burst))
    # what the service spends on one request body before the batcher
    # sees it (JSON parse, base64, copy), under the interpreter lock
    import base64

    from glsdet_tpu_torch.serve import _decode_image

    body = json.dumps({"image": base64.b64encode(
        frames[0].tobytes()).decode(), "shape": list(frames[0].shape),
        "dtype": "uint8"}).encode()
    t0 = time.perf_counter()
    for _ in range(5):
        _decode_image(body)
    decode_ms = 1e3 * (time.perf_counter() - t0) / 5
    first = windows[0]
    return {"http_requests": total, "http_errors": 0,
            # smoke readings of the 16-request burst: not metrics
            "burst_requests_per_s": first["requests_per_s"],
            "burst_batch_sizes": [len(b) for b in batches
                                  if b[0] < N_FRAMES],
            "burst_equal_to_detect_batch": equal / N_FRAMES,
            # the metrics: HTTP_WINDOWS sustained windows
            "windows": windows[1:], **replay,
            "request_bytes": len(body), "decode_ms_per_request": decode_ms}


def batch_img_per_s(facade, frames, reps=3) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        facade.detect_batch(frames)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return len(frames) / float(np.median(times))


def serve_run(facade, frames):
    """One captured detect_batch of the facade (capture_serving), checked:
    well formed, B1 once and B2 four times per stage-2 group (one coarse
    launch per chunk; the chips' decode, the unmapped chips and the
    fusion per group), every fusion equal to the CPU's and made of input
    rows.  Returns its summary and the captured groups, NMS launches and
    fusions."""
    res, launches, chunks, groups, nms_calls, fusions = capture_serving(
        facade, frames)
    n_dets = check_served(res, len(frames), facade.score_thr)
    buckets = {}
    for _, idx, _, hw in groups:
        buckets[hw] = buckets.get(hw, 0) + int(idx.shape[0])
    n_groups = len(groups)
    if launches["paint"] != n_groups or launches["paint_inputs"] != n_groups:
        raise AssertionError(f"{launches} for {n_groups} stage-2 groups")
    if launches["nms"] != chunks + 3 * n_groups:
        raise AssertionError(f"{launches['nms']} NMS launches for "
                             f"{chunks} chunks, {n_groups} groups")
    out = {"launches": launches, "chunks": chunks, "groups": n_groups,
           "buckets": {str(k): v for k, v in sorted(buckets.items())},
           "detections": n_dets, **check_fusions(fusions)}
    return out, groups, nms_calls, fusions


def check_fusion_suppresses(fusions) -> dict:
    """The served sets overlap little, so their fusion keeps every valid
    row.  Here a captured group's local sets are fused on the card with a
    coarse set that overlaps them: their first rows, each coordinate moved
    by at most a quarter of a pixel, the same labels, 0.9 of the scores.  The fusion's
    one B2 launch must suppress rows, its keep mask equal the plain
    version's, and the output equal _fuse_packed on the CPU."""
    from glsdet_tpu_torch.eval.two_stage import _fuse_packed
    from glsdet_tpu_torch.ops import nms as nms_mod

    gdets, local, _, kw = fusions[0]
    lb, ls, ll, lv = local
    k = gdets.shape[1]
    g = torch.Generator(DEVICE).manual_seed(7)
    jitter = (torch.rand(lb[:, :k].shape, device=DEVICE, generator=g)
              - 0.5) * 0.5
    over = torch.cat([lb[:, :k] + jitter, 0.9 * ls[:, :k, None],
                      ll[:, :k, None].to(gdets.dtype),
                      lv[:, :k, None].to(gdets.dtype)], -1).to(gdets.dtype)
    calls, inner = [], nms_mod.nms_sorted_cuda

    def nms(bx, vd, thr, offset=0.0):
        keep = inner(bx, vd, thr, offset)
        calls.append((bx.clone(), vd.clone(), float(thr), float(offset),
                      keep.clone()))
        return keep

    nms_mod.nms_sorted_cuda = nms
    try:
        torch.cuda.synchronize()
        reset_launches()
        out = _fuse_packed(over, *local, **kw)
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        nms_mod.nms_sorted_cuda = inner
    if launches["nms"] != 1 or len(calls) != 1:
        raise AssertionError(f"the fusion launched B2 {launches['nms']} "
                             f"times")
    bx, vd, thr, off, keep = calls[0]
    if not torch.equal(keep, check_nms(bx, vd, thr, off, "overlapped "
                                       "fusion")):
        raise AssertionError("overlapped fusion: the path's keep mask "
                             "differs from the plain version's")
    want = _fuse_packed(over.cpu(), *(t.cpu() for t in local), **kw)
    for name, a, b in zip(("boxes", "scores", "labels", "valid"), out, want):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"overlapped fusion {name}: the card's "
                                 f"differs from the CPU's")
    per_frame = (vd & ~keep).sum(1)
    if not bool((per_frame[lv.any(1)] > 0).all()):
        raise AssertionError(f"overlapped fusion: suppressed per frame "
                             f"{per_frame.tolist()}")
    return {"valid": int(vd.sum()), "kept": int(keep.sum()),
            "suppressed": int(per_frame.sum()),
            "fused_rows": int(out[3].sum())}


def phase_serve(frames, dev_frames, paths) -> dict:
    """TwoStageDetector with its defaults, behind the HTTP service
    (module docstring, phase 14)."""
    t0 = time.perf_counter()
    facade = make_facade(paths)
    build_s = time.perf_counter() - t0
    try:
        pipe = facade.pipeline
        if not (pipe.fuse_global and pipe.pack_mode == "square"
                and pipe.max_batch == SERVE_MAX_BATCH):
            raise AssertionError("the facade's defaults changed")
        t0 = time.perf_counter()
        facade.warmup(FRAME_HW)
        warm_s = time.perf_counter() - t0
        run, groups, nms_calls, fusions = serve_run(facade, frames)
        no_sync = check_no_sync(pipe, dev_frames)
        kern = phase_serve_kernels(groups, nms_calls)
        log("serve_kernels", **kern)
        phase_profile(pipe, dev_frames[:SERVE_MAX_BATCH], "profile_serve")
        overlap = check_fusion_suppresses(fusions)
        del groups, nms_calls, fusions
        # HTTP: the async batcher in front of the facade
        http = phase_http(facade, frames, os.path.dirname(paths[0]))
        # throughput of detect_batch, fusion on and off, and memory
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_ips = batch_img_per_s(facade, frames)
        peak = torch.cuda.max_memory_allocated()
    finally:
        facade.close()
    plain = make_facade(paths, fuse_global=False)
    try:
        plain.warmup(FRAME_HW)
        plain_ips = batch_img_per_s(plain, frames)
    finally:
        plain.close()
    out = {**run, "fusion_overlap": overlap, "no_sync_calls": no_sync,
           "build_s": build_s, "warmup_s": warm_s, **http,
           "img_per_s_fuse_global": fused_ips,
           "img_per_s_no_fusion": plain_ips, "peak_mem_bytes": peak}
    log("serve", frames=N_FRAMES, frame_hw=FRAME_HW, **out)
    out["kernels"] = kern
    return out


def phase_serve_ladder(frames, paths) -> dict:
    """The facade with its ladder cut to LADDER, so that its own path
    paints and (phase 15) normalizes at other buckets than the default
    ladder's 1152 (module docstring, phase 14)."""
    facade = make_facade(paths, buckets=LADDER)
    try:
        run, groups, nms_calls, _ = serve_run(facade, frames)
        if not set(int(k) for k in run["buckets"]) <= set(LADDER):
            raise AssertionError(f"buckets {run['buckets']} outside {LADDER}")
        kern = phase_serve_kernels(groups, nms_calls)
        del groups, nms_calls
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ips = batch_img_per_s(facade, frames)
        peak = torch.cuda.max_memory_allocated()
    finally:
        facade.close()
    out = {**run, "ladder": LADDER, "img_per_s": ips, "peak_mem_bytes": peak}
    log("serve_ladder", **out, **kern)
    out["kernels"] = kern
    return out


def phase_serve_int8(frames, paths, bf16) -> dict:
    """TwoStageDetector(quant8="static") calibrating lazily (module
    docstring, phase 15)."""
    from glsdet_tpu_torch.native.build import BUILD_DIR
    from glsdet_tpu_torch.ops.gn_kernel import (gn_relu_quant_acc,
                                                gn_relu_quant_acc_plain)
    from glsdet_tpu_torch.ops.quant_static import load_scales

    path = os.path.join(BUILD_DIR, "serve_int8_scales.json")
    if os.path.exists(path):
        os.remove(path)
    kw = dict(quant8="static", int8_scales=path)
    first = make_facade(paths, **kw)
    try:
        t0 = time.perf_counter()
        got = first.detect_batch(frames)
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
        if not os.path.exists(path) or first._needs_calibration:
            raise AssertionError("the first batch did not calibrate")
        saved = load_scales(path)
    finally:
        first.close()
    second = make_facade(paths, **kw)
    try:
        if second._needs_calibration or second.pipeline.quant8 != "static":
            raise AssertionError("the second facade did not load the scales")
        second.warmup(FRAME_HW)
        res, launches, chunks, groups, _, _ = capture_serving(second,
                                                              frames)
        check_served(res, N_FRAMES, second.score_thr)
        same = all(np.array_equal(a[k], b[k]) for a, b in zip(res, got)
                   for k in ("boxes", "scores", "labels"))
        if not same:
            raise AssertionError("the facade that loaded the scales "
                                 "detects otherwise than the one that "
                                 "saved them")
        if launches["gn"] != 40 * len(groups):
            raise AssertionError(f"GN kernel launched {launches['gn']} "
                                 f"times for {len(groups)} groups")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ips = batch_img_per_s(second, frames)
        peak = torch.cuda.max_memory_allocated()
    finally:
        second.close()
    # B3 at the head levels (strides 8..128) of the buckets used, at the
    # group's batch
    _, gamma, beta = gn_affine()
    levels = []
    for hw, b in sorted({(g[3], int(g[1].shape[0])) for g in groups}):
        for lv in (hw // 8, hw // 16, hw // 32, hw // 64, hw // 128):
            acc, deq = gn_acc_inputs(b, lv, lv + 3)
            c = check_codes(gn_relu_quant_acc(acc, deq, gamma, beta,
                                              GN_S_OUT),
                            gn_relu_quant_acc_plain(acc, deq, gamma, beta,
                                                    GN_S_OUT),
                            f"serve level {lv} of {hw}")
            levels.append({"bucket": hw, "batch": b, "hw": lv, **c})
            del acc
    ladder = serve_int8_ladder(frames, paths, path)
    out = {"launches": launches, "groups": len(groups),
           "buckets": sorted({g[3] for g in groups}),
           "scales": [len(s) for s in saved], "calibrate_batch_s": calib_s,
           "same_detections_after_reload": same, "gn_levels": levels,
           "img_per_s_int8": ips,
           "img_per_s_bf16_fuse_global": bf16["img_per_s_fuse_global"],
           "peak_mem_bytes": peak, "ladder": ladder}
    log("serve_int8", **out)
    return out


def serve_int8_ladder(frames, paths, scales) -> dict:
    """The static-int8 facade on the saved scales with its ladder cut to
    LADDER: serve_run's checks, B3 launched 40 times per stage-2 group,
    and B3 on the inputs the path gave it (the first launch at each
    level, captured) within +-1 code of its plain version, timed with
    phase 4's bound (the int32 read and the int8 write)."""
    from glsdet_tpu_torch.ops import quant_static

    facade = make_facade(paths, buckets=LADDER, quant8="static",
                         int8_scales=scales)
    captured, inner = {}, quant_static.gn_relu_quant_acc

    def gn(acc, deq, gamma, beta, s_out, **kw):
        if tuple(acc.shape) not in captured:
            captured[tuple(acc.shape)] = (acc.clone(), deq, gamma, beta,
                                          s_out, kw)
        return inner(acc, deq, gamma, beta, s_out, **kw)

    quant_static.gn_relu_quant_acc = gn
    try:
        if facade._needs_calibration:
            raise AssertionError("the ladder facade did not load the scales")
        run, groups, _, _ = serve_run(facade, frames)
    finally:
        quant_static.gn_relu_quant_acc = inner
        facade.close()
    if run["launches"]["gn"] != 40 * run["groups"]:
        raise AssertionError(f"GN kernel launched {run['launches']['gn']} "
                             f"times for {run['groups']} groups")
    del groups
    levels = check_gn_captured(captured)
    del captured
    return {**run, "ladder": LADDER, "gn_path_inputs": levels}


def phase_detector(frames, paths) -> None:
    """Detector("coarse_det") on 4 frames: B2 launches, detections well
    formed (module docstring, phase 16)."""
    from glsdet_tpu_torch.apis import Detector

    det = Detector("coarse_det", paths[0], score_thr=1e-4, device=DEVICE)
    det.detect_batch(frames[:4])
    torch.cuda.synchronize()
    reset_launches()
    res = det.detect_batch(frames[:4])
    torch.cuda.synchronize()
    launches = read_launches()
    if launches["nms"] < 1:
        raise AssertionError(f"Detector: no NMS launch: {launches}")
    n = check_served(res, 4, det.score_thr)
    if n == 0:
        raise AssertionError("Detector: no detections")
    log("detector", frames=4, launches=launches, detections=n,
        img_per_s=batch_img_per_s(det, frames[:4]))


# ---------------------------------------------------------------------------
# 15b. replicas: serving on several cards in turn, scan_width groups and
# cost_analysis

REPLICA_BATCHES = 4          # batches of N_FRAMES served in turn
SCAN_FRAMES, SCAN_WIDTH = 32, 16
REPLICA_BOX_TOL = (1e-2, 1e-4)   # px, and relative: one card against one
REPLICA_SCORE_TOL = 1e-3
SCAN_MATCHED = 0.95          # grouped vs flat, bf16 (replica_scan)


def same_detections(want, got, what, box_tol, score_tol) -> dict:
    """Per frame: the same number of detections and labels, boxes within
    ``box_tol`` (atol, rtol) and scores within ``score_tol``; the largest
    differences and whether all were equal."""
    exact, box_err, score_err = True, 0.0, 0.0
    for i, (w, g) in enumerate(zip(want, got)):
        if len(w["boxes"]) != len(g["boxes"]) or not np.array_equal(
                w["labels"], g["labels"]):
            raise AssertionError(f"{what} frame {i}: {len(g['boxes'])} "
                                 f"detections against {len(w['boxes'])}")
        db = np.abs(g["boxes"] - w["boxes"])
        ds = np.abs(g["scores"] - w["scores"])
        exact &= not db.any() and not ds.any()
        if len(db):
            if (db > box_tol[0] + box_tol[1] * np.abs(w["boxes"])).any() \
                    or (ds > score_tol).any():
                raise AssertionError(f"{what} frame {i}: boxes off by "
                                     f"{db.max()}, scores by {ds.max()}")
            box_err = max(box_err, float(db.max()))
            score_err = max(score_err, float(ds.max()))
    return {"equal": bool(exact), "box_max_abs_err": box_err,
            "score_max_abs_err": score_err}


@contextlib.contextmanager
def card_checks(device):
    """While the block runs, each call of B1 (the path entry), B2 and B3
    that launched its kernel on ``device`` (the wrapper's own count on that
    card went up) is held against its plain version on the same inputs on
    that card right after it (B1 and B2 equal, B3 within +-1 code) and
    counted in ``checked``; the first inputs of each are kept (on
    ``device``) for the device guard's check."""
    from glsdet_tpu_torch.eval import two_stage
    from glsdet_tpu_torch.eval.preprocess import mosaic_inputs_plain
    from glsdet_tpu_torch.ops import nms as nms_mod
    from glsdet_tpu_torch.ops import gn_kernel, nms_kernel, quant_static
    from glsdet_tpu_torch.ops.gn_kernel import gn_relu_quant_acc_plain
    from glsdet_tpu_torch.ops.nms import nms_sorted_plain
    from glsdet_tpu_torch.ufp import paint_kernel

    cap = {"checked": {"nms": 0, "paint": 0, "gn": 0},
           "gn_max_abs_err": 0.0, "first": {}}
    real = (nms_mod.nms_sorted_cuda, two_stage.paint_mosaic_inputs_cuda,
            quant_static.gn_relu_quant_acc)
    counts = {"nms": nms_kernel.launches_by_device,
              "paint": paint_kernel.launches_by_device,
              "gn": gn_kernel.launches_by_device}

    def launch(kernel, fn, t, *args, **kw):
        """The real wrapper's result, and whether it launched on
        ``device``."""
        before = counts[kernel][device.index]
        out = fn(t, *args, **kw)
        if t.device != device or counts[kernel][device.index] == before:
            return out, False
        cap["checked"][kernel] += 1
        return out, True

    def nms(bx, vd, thr, offset=0.0):
        keep, mine = launch("nms", real[0], bx, vd, thr, offset)
        if mine:
            if not torch.equal(keep, nms_sorted_plain(bx, vd, thr, offset)):
                raise AssertionError(f"B2 on {device} {tuple(bx.shape)}: "
                                     "keep mask differs from plain")
            cap["first"].setdefault("nms", (bx.clone(), vd.clone(), thr,
                                            offset))
        return keep

    def paint(imgs, idx, regs, hw, mean, inv_std):
        got, mine = launch("paint", real[1], imgs, idx, regs, hw, mean,
                           inv_std)
        if mine:
            if not torch.equal(got, mosaic_inputs_plain(
                    imgs, idx, regs, hw, mean.dtype, mean, inv_std)):
                raise AssertionError(f"B1 on {device} at {hw}: differs "
                                     "from mosaic_inputs_plain")
            cap["first"].setdefault("paint", (imgs, idx.clone(),
                                              regs.clone(), hw, mean,
                                              inv_std))
        return got

    def gn(acc, deq, gamma, beta, s_out, **kw):
        got, mine = launch("gn", real[2], acc, deq, gamma, beta, s_out,
                           **kw)
        if mine:
            c = check_codes(got, gn_relu_quant_acc_plain(
                acc, deq, gamma, beta, s_out, kw["groups"], kw["eps"],
                kw["dtype"]), f"on {device} {tuple(acc.shape)}")
            cap["gn_max_abs_err"] = max(cap["gn_max_abs_err"],
                                        c["max_abs_err"])
            if "gn" not in cap["first"] and acc.shape[1] <= 36:
                cap["first"]["gn"] = (acc.clone(), deq, gamma, beta, s_out,
                                      kw)
        return got

    nms_mod.nms_sorted_cuda = nms_kernel.nms_sorted_cuda = nms
    two_stage.paint_mosaic_inputs_cuda = paint
    quant_static.gn_relu_quant_acc = gn
    try:
        yield cap
    finally:
        nms_mod.nms_sorted_cuda = nms_kernel.nms_sorted_cuda = real[0]
        two_stage.paint_mosaic_inputs_cuda = real[1]
        quant_static.gn_relu_quant_acc = real[2]


def check_device_guard(first, device) -> dict:
    """Each kernel's wrapper called on ``device``'s tensors while cuda:0
    is the current card: B1, B2, B3 (on inputs the path gave them there)
    and B4 (a small bottleneck) against their plain versions on
    ``device``; and inputs on two cards raise ValueError."""
    from glsdet_tpu_torch.eval.preprocess import mosaic_inputs_plain
    from glsdet_tpu_torch.ops.bottleneck_kernel import (
        fused_bottleneck, fused_bottleneck_plain)
    from glsdet_tpu_torch.ops.gn_kernel import (gn_relu_quant_acc,
                                                gn_relu_quant_acc_plain)
    from glsdet_tpu_torch.ops.nms import nms_sorted_plain
    from glsdet_tpu_torch.ops.nms_kernel import nms_sorted_cuda
    from glsdet_tpu_torch.ufp.paint_kernel import paint_mosaic_inputs_cuda

    out = {}
    with torch.cuda.device(0):
        bx, vd, thr, off = first["nms"]
        keep = nms_sorted_cuda(bx, vd, thr, off)
        out["nms_equal"] = bool(torch.equal(
            keep, nms_sorted_plain(bx, vd, thr, off)))
        imgs, idx, regs, hw, mean, inv_std = first["paint"]
        got = paint_mosaic_inputs_cuda(imgs, idx, regs, hw, mean, inv_std)
        out["paint_equal"] = bool(torch.equal(got, mosaic_inputs_plain(
            imgs, idx, regs, hw, mean.dtype, mean, inv_std)))
        acc, deq, gamma, beta, s_out, kw = first["gn"]
        out["gn"] = check_codes(
            gn_relu_quant_acc(acc, deq, gamma, beta, s_out, **kw),
            gn_relu_quant_acc_plain(acc, deq, gamma, beta, s_out,
                                    kw["groups"], kw["eps"], kw["dtype"]),
            f"guard on {device}")
        g = torch.Generator(device).manual_seed(3)
        c = 64
        x = torch.randn(2, 16, 16, 4 * c, device=device, generator=g)
        ops = [torch.randn(*s, device=device, generator=g) * 0.05
               for s in ((4 * c, c), (c,), (9 * c, c), (c,), (c, 4 * c),
                         (4 * c,))]
        y = fused_bottleneck(x.bfloat16(), *ops).float()
        ref = fused_bottleneck_plain(x.bfloat16(), *ops).float()
        out["bottleneck_max_abs_err"] = float((y - ref).abs().max())
        if out["bottleneck_max_abs_err"] > 5e-3 * float(ref.abs().max()):
            raise AssertionError(f"B4 on {device}: {out}")
        if not (out["nms_equal"] and out["paint_equal"]):
            raise AssertionError(f"kernels on {device}: {out}")
        try:
            nms_sorted_cuda(bx, vd.to("cuda:0"), thr, off)
        except ValueError:
            out["mixed_cards_raise"] = True
        else:
            raise AssertionError("B2 took inputs on two cards")
        torch.cuda.synchronize(device)
    return out


def replica_run(single, multi, frames, second) -> dict:
    """The one-card pipeline once, then REPLICA_BATCHES batches of the
    frames through ``multi`` (all submitted, then collected: the cards'
    turns interleave), each equal to the one-card result, every kernel
    launch on ``second`` held to plain (card_checks)."""
    for p in (single, multi):
        p.warmup(FRAME_HW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    want = single.run_batch(frames)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    reset_launches()
    with card_checks(second) as cap:
        handles = [multi.submit_batch(frames)
                   for _ in range(REPLICA_BATCHES)]
        got = [multi.collect_batch(h) for h in handles]
        for d in {torch.device(x) for x in multi.devices}:
            torch.cuda.synchronize(d)
    launches, per_card = read_launches(), read_launches_by_card()
    for kernel, cards in per_card.items():
        if sum(cards.values()) != launches[kernel]:
            raise AssertionError(f"{kernel}: launches per card {cards}, "
                                 f"{launches[kernel]} in all")
        if kernel in cap["checked"] and cap["checked"][kernel] != cards.get(
                str(second), 0):
            raise AssertionError(f"{kernel}: {cap['checked'][kernel]} "
                                 f"launches on {second} held to plain, "
                                 f"{cards.get(str(second), 0)} counted")
    served_on = [str(h.chunks[0][1].device) for h in handles]
    if served_on != [str(multi.devices[k % 2])
                     for k in range(REPLICA_BATCHES)]:
        raise AssertionError(f"batches served on {served_on}")
    errs = [same_detections(want, g, f"replica batch {k}", REPLICA_BOX_TOL,
                            REPLICA_SCORE_TOL) for k, g in enumerate(got)]
    check_results(want, len(frames))
    if min(cap["checked"].values() if single.quant8 else
           (cap["checked"]["nms"], cap["checked"]["paint"])) < 1:
        raise AssertionError(f"kernels on {second}: {cap['checked']}")
    return {"served_on": served_on, "launches": launches,
            "launches_per_card": per_card,
            "checked_on_second": cap["checked"],
            "gn_max_abs_err": cap["gn_max_abs_err"],
            "batches": errs, "one_card_s": one_s,
            "one_card_img_per_s": len(frames) / one_s,
            "one_card_peak_mem_bytes": peak}, cap["first"]


def replica_facades(frames, paths, devs) -> dict:
    """TwoStageDetector(devices=) against the one-card facade: two
    detect_batch calls of the frames (the first card's turn, then the
    second's), each equal to the one-card answers."""
    one = make_facade(paths)
    try:
        want = one.detect_batch(frames)
    finally:
        one.close()
    multi = make_facade(paths, devices=devs)
    try:
        if [str(d) for d in multi.pipeline.devices] != devs:
            raise AssertionError(f"facade devices {multi.pipeline.devices}")
        got = [multi.detect_batch(frames) for _ in devs]
    finally:
        multi.close()
    check_served(want, len(frames), multi.score_thr)
    return {"turns": [same_detections(want, g, f"facade turn {k}",
                                      REPLICA_BOX_TOL, REPLICA_SCORE_TOL)
                      for k, g in enumerate(got)]}


def scan_groups_exact(single, scan, dev) -> dict:
    """Each stage of ``scan`` (SCAN_WIDTH groups) on SCAN_FRAMES frames,
    and on a stage-2 group of SCAN_FRAMES mosaics made from that chunk's
    packed jobs (its largest bucket's, repeated), torch.equal to
    ``single`` (the same models) called on each group alone."""
    from glsdet_tpu_torch.eval.two_stage import unpack_detections

    w = SCAN_WIDTH
    got = scan.coarse_packed(dev)
    want = torch.cat([single.coarse_packed(dev[s:s + w])
                      for s in range(0, SCAN_FRAMES, w)])
    jobs = scan._pack_chunk([FRAME_HW] * SCAN_FRAMES,
                            list(range(SCAN_FRAMES)),
                            unpack_detections(got.cpu().numpy()))
    bucket, job_list = max(jobs.items(), key=lambda kv: len(kv[1]))
    job_list = (job_list * SCAN_FRAMES)[:SCAN_FRAMES]
    idx = torch.tensor([j[1] for j in job_list]).to(dev.device)
    regs = torch.from_numpy(np.stack([j[2] for j in job_list])).to(
        dev.device)
    got2 = scan.stage2_packed(dev, idx, regs, bucket)
    want2 = torch.cat([single.stage2_packed(dev, idx[s:s + w],
                                            regs[s:s + w], bucket)
                       for s in range(0, SCAN_FRAMES, w)])
    out = {"coarse_equal": bool(torch.equal(got, want)),
           "stage2_equal": bool(torch.equal(got2, want2)),
           "stage2_bucket": bucket}
    if not (out["coarse_equal"] and out["stage2_equal"]):
        raise AssertionError(f"scan_width groups differ from the groups "
                             f"run alone: {out}")
    return out


def replica_scan(single, frames, peak16) -> dict:
    """SCAN_FRAMES frames as one chunk, flat and in SCAN_WIDTH groups, on
    the bf16 models of ``single`` (max_batch N_FRAMES = SCAN_WIDTH): the
    peak memory predicted from the one-card run of N_FRAMES (``peak16``;
    printed before the runs) and measured, img/s; each stage's groups
    equal to the groups run alone (scan_groups_exact); the grouped run
    against the flat one, which sums its convolutions at another batch
    size (cuDNN's algorithms are chosen per shape, and bf16 rounds the
    difference into other detections), as two bf16 runs are compared:
    the top 10 detections of each frame matched both ways (matched_share:
    same label, IoU > 0.5, score within 0.3) at SCAN_MATCHED at least."""
    if single.max_batch != SCAN_WIDTH:
        raise AssertionError("the groups' reference must run SCAN_WIDTH")
    frames = (frames * (SCAN_FRAMES // len(frames) + 1))[:SCAN_FRAMES]
    frame_bytes = int(np.prod(FRAME_HW)) * 3
    # a group holds what one chunk of N_FRAMES held, beside the extra
    # frames; the flat chunk twice the activations
    log("replicas_scan_prediction", one_card_peak_bytes=peak16,
        scan_peak_bytes=peak16 + (SCAN_FRAMES - N_FRAMES) * frame_bytes,
        flat_peak_bytes=2 * (peak16 - N_FRAMES * frame_bytes)
        + SCAN_FRAMES * frame_bytes)
    flat = make_pipeline((single.coarse, single.mp), max_batch=SCAN_FRAMES)
    scan = make_pipeline((single.coarse, single.mp), max_batch=SCAN_FRAMES,
                         scan_width=SCAN_WIDTH)
    out = {}
    try:
        for name, p in (("flat", flat), ("scan", scan)):
            p.warmup(FRAME_HW)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(2):
                t0 = time.perf_counter()
                res = p.run_batch(frames)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            out[name] = {"peak_mem_bytes": torch.cuda.max_memory_allocated(),
                         "img_per_s": SCAN_FRAMES / min(times),
                         "detections": sum(len(r["boxes"]) for r in res),
                         "results": res}
        out["groups"] = scan_groups_exact(
            single, scan, torch.from_numpy(np.stack(frames)).to(DEVICE))
    finally:
        flat.close()
        scan.close()
    want, got = out["flat"].pop("results"), out["scan"].pop("results")
    check_results(got, SCAN_FRAMES)
    out["matched"] = [matched_share(want, got), matched_share(got, want)]
    if min(out["matched"]) < SCAN_MATCHED:
        raise AssertionError(f"scan_width: {out}")
    return {"frames": SCAN_FRAMES, "scan_width": SCAN_WIDTH,
            "frame_bytes": frame_bytes, **out}


def replica_costs(single, single8, bf16_ips) -> dict:
    """cost_analysis at the bench frames' size for the bf16, static-int8
    and fused pipelines on the card, the flops equal across the three;
    the coarse stage's flops also counted on the CPU in float32 (batch 1;
    the CPU's stage 2 at full width would take tens of seconds, and
    tests/test_torch_cost.py holds both stages' CPU count to the card's at
    test widths); per stage at the first bucket, and at 1152; the
    achieved TFLOP/s of the one-card bf16 run."""
    from glsdet_tpu_torch.eval.two_stage import TwoStagePipeline
    from glsdet_tpu_torch.ops.cost import count_cost
    from glsdet_tpu_torch.ops.fused_infer import wrap_model_fused

    coarse, mp = seeded_models()
    cpu = TwoStagePipeline(copy.deepcopy(coarse), copy.deepcopy(mp),
                           COARSE_HW, mosaic_buckets=BUCKETS,
                           coarse_score_thr=1e-4, pack_mode="bucket-fit",
                           max_batch=1, device="cpu")
    fused = make_pipeline((coarse, wrap_model_fused(mp)))
    try:
        t0 = time.perf_counter()
        costs = {"bf16": single.cost_analysis(FRAME_HW),
                 "int8": single8.cost_analysis(FRAME_HW),
                 "fused": fused.cost_analysis(FRAME_HW)}
        at_1152 = single.cost_analysis(FRAME_HW, bucket=1152)
        with count_cost() as counter:
            cpu.coarse_packed(torch.zeros((1, *FRAME_HW, 3),
                                          dtype=torch.uint8))
        seconds = time.perf_counter() - t0
    finally:
        cpu.close()
        fused.close()
    for stage in ("coarse", "stage2"):
        flops = {k: c[stage]["flops"] for k, c in costs.items()}
        if stage == "coarse":
            flops["cpu_float32"] = counter.flops
        if len(set(flops.values())) != 1:
            raise AssertionError(f"cost_analysis {stage} flops differ: "
                                 f"{flops}")
    per_image = {bk: c["coarse"]["flops"] + c["stage2"]["flops"]
                 for bk, c in ((costs["bf16"]["bucket"], costs["bf16"]),
                               (1152, at_1152))}
    return {**costs, "cpu_float32_coarse": counter.as_dict(),
            "bf16_1152": at_1152, "seconds": seconds,
            "gflop_per_image": {str(k): v / 1e9
                                for k, v in per_image.items()},
            "achieved_tflops": {str(k): bf16_ips * v / 1e12
                                for k, v in per_image.items()},
            "share_of_bf16_peak": {str(k): bf16_ips * v / PEAK_BF16
                                   for k, v in per_image.items()}}


def replica_devices():
    """The card count, and the two devices the phase serves on in turn:
    two cards where there are two, else the one card twice."""
    cards = torch.cuda.device_count()
    return cards, (["cuda:0", "cuda:1"] if cards >= 2
                   else ["cuda:0", "cuda:0"])


def replica_launches(rep, kernel) -> dict:
    """A kernel's launches in the replicas phase's two-card runs, per
    mode and card, as its wrapper counted them."""
    return {mode: rep[mode]["launches_per_card"][kernel]
            for mode in ("bf16", "int8")}


def phase_replicas(frames, paths) -> dict:
    """Serving on two cards in turn, scan_width groups, cost_analysis
    (module docstring, phase 15b)."""
    from glsdet_tpu_torch.native.build import BUILD_DIR
    from glsdet_tpu_torch.ops.quant_static import load_scales

    t0 = time.perf_counter()
    cards, devs = replica_devices()
    second = torch.device(devs[1])
    out = {"cards": min(cards, 2), "devices": devs,
           "device_guard_checked": cards >= 2}
    scales = load_scales(os.path.join(BUILD_DIR, "int8_scales.json"))
    single = make_pipeline(seeded_models())
    models8 = seeded_models()
    single8 = make_pipeline(copy.deepcopy(models8), quant8="static",
                            act_scales=scales)
    try:
        multi = make_pipeline((single.coarse, single.mp), devices=devs)
        try:
            out["bf16"], first = replica_run(single, multi, frames, second)
        finally:
            multi.close()
        multi8 = make_pipeline(models8, quant8="static", act_scales=scales,
                               devices=devs)
        try:
            out["int8"], first8 = replica_run(single8, multi8, frames,
                                              second)
        finally:
            multi8.close()
        if cards >= 2:
            out["device_guard"] = check_device_guard({**first, **first8},
                                                     second)
        del first, first8
        out["facade"] = replica_facades(frames, paths, devs)
        out["scan"] = replica_scan(single, frames,
                                   out["bf16"]["one_card_peak_mem_bytes"])
        out["cost"] = replica_costs(single, single8,
                                    out["bf16"]["one_card_img_per_s"])
    finally:
        single.close()
        single8.close()
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"replicas": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# 17. MP-Det training


TRAIN_PROXIES = (2, 3, 2, 5, 4, 8, 8, 4, 3, 3)
TRAIN_HW, TRAIN_B, TRAIN_MAX_GT = (1024, 1024), 4, 300
TRAIN_SPE = 1000             # steps per epoch of the 1x schedule
LOSS_NAMES = ("loss", "loss_cls", "loss_bbox", "loss_dfl", "loss_emb",
              "loss_op")


BOX_RECIPES = ("bench", "visdrone")


def train_batch(rs, b, hw, max_gt, device, boxes="bench"):
    """uint8 frames and their GTs (labels 0-9), padded to ``max_gt``, by
    the box recipe ``boxes``: "bench", scripts/bench_train.py _mk_batch's
    (5-19 boxes of 8-64 px per image, drawn as for 20 slots), or
    "visdrone", a VisDrone-like one (5-60 boxes of 4-64 px per image,
    inside the frame)."""
    if boxes not in BOX_RECIPES:
        raise ValueError(f"box recipe {boxes!r}: one of {BOX_RECIPES}")
    visdrone = boxes == "visdrone"
    h, w = hw
    images = rs.randint(0, 255, (b, h, w, 3)).astype(np.uint8)
    gt = np.zeros((b, max_gt, 4), np.float32)
    labels = np.zeros((b, max_gt), np.int64)
    valid = np.zeros((b, max_gt), bool)
    if not visdrone:
        n = rs.randint(5, 20, b)
        labels[:, :20] = rs.randint(0, 10, (b, 20))
    for i in range(b):
        if visdrone:
            n_i = rs.randint(5, 61)
            bw, bh = rs.uniform(4, 64, n_i), rs.uniform(4, 64, n_i)
            x1, y1 = rs.uniform(0, w - bw), rs.uniform(0, h - bh)
            labels[i, :n_i] = rs.randint(0, 10, n_i)
        else:
            n_i = n[i]
            x1, y1 = rs.uniform(0, w - 80, 20), rs.uniform(0, h - 80, 20)
            bw, bh = rs.uniform(8, 64, 20), rs.uniform(8, 64, 20)
        gt[i, :len(x1)] = np.stack([x1, y1, x1 + bw, y1 + bh], 1)
        valid[i, :n_i] = True
    batch = {"images": images, "gt_boxes": gt, "gt_labels": labels,
             "gt_valid": valid}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train_state(cfg, device, seed=0):
    """A seeded train state of ``cfg`` on ``device``: the model built on
    the CPU from ``seed`` (the JAX package's initializers), the config's
    optimizer and schedule.  An mpdet state carries the BoIW dictionary,
    drawn on the CPU so that every device starts from the same state,
    with beta switched on as at emd_start_epoch; yolox and gfl have
    none."""
    from glsdet_tpu_torch.models.build import build_model
    from glsdet_tpu_torch.train.boiw import BoIWState, enable_emd_training
    from glsdet_tpu_torch.train.loop import (build_optimizer,
                                             make_state_template)

    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(seed))
    opt = build_optimizer(cfg, TRAIN_SPE, model)
    state = make_state_template(cfg, model, opt,
                                torch.Generator().manual_seed(seed))
    if cfg.model.family == "mpdet":
        state.boiw = BoIWState(*(t.to(device) for t in
                                 enable_emd_training(state.boiw)))
    state.generator = torch.Generator(device=device).manual_seed(seed)
    return state


def train_step_fn(cfg, state, dtype):
    from glsdet_tpu_torch.train.steps import make_mpdet_train_step

    return make_mpdet_train_step(state.model, cfg.data.img_hw,
                                 cfg.model.num_classes,
                                 cfg.model.proxies_list, normalize=True,
                                 dtype=dtype)


def train_cfg(**over):
    from glsdet_tpu_torch.config import apply_overrides, get_config

    return apply_overrides(get_config("mp_det_res50"), over)


def state_leaves(state) -> dict:
    """Every float leaf of a train state, by kind (the dictionary where
    the state has one)."""
    named = dict(state.model.named_parameters())
    sd = state.model.state_dict()
    out = {
        "params": {n: sd[n] for n in named},
        "bn_stats": {n: v for n, v in sd.items() if "running" in n},
        "momentum": {n: state.optimizer.state[p]["momentum_buffer"]
                     for n, p in named.items()},
        "ema": state.ema_params,
    }
    if state.boiw is not None:
        out["boiw"] = {"embedding": state.boiw.embedding}
    return out


def leaf_errors(got, want) -> dict:
    """Per kind, the largest |got - want| over a leaf's max |want|."""
    out = {}
    for kind, leaves in want.items():
        worst, name = 0.0, None
        for n, w in leaves.items():
            w, g = w.detach().double().cpu(), got[kind][n].detach().double().cpu()
            e = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            if e >= worst:
                worst, name = e, n
        out[kind] = {"max_rel": worst, "leaf": name}
    return out


def rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def jitter_bn(model, seed=1) -> None:
    """Biases, BN scales and BN statistics off their constant inits (the
    same numbers on every device), so that no leaf's max is the step's
    own update."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            bias = getattr(m, "bias", None)
            if isinstance(bias, torch.nn.Parameter):
                bias.copy_(torch.from_numpy(0.1 * rs.randn(*bias.shape)))
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                for t, v in ((m.weight, 1.0 + 0.1 * rs.randn(c)),
                             (m.running_mean, 0.1 * rs.randn(c)),
                             (m.running_var, 0.5 + rs.rand(c))):
                    t.copy_(torch.from_numpy(v))


def train_parity() -> dict:
    """One step of a small MP-Det on the card and on the CPU from one
    seeded state (biases and BN statistics jittered off their inits; TF32
    off, as main sets it), in float32 and in float64: the six losses
    within 1e-4 relative; parameters, BN statistics, EMA and the
    dictionary within 1e-5 of each leaf's max.  The momentum buffers (the
    step's gradients) are held to 1e-5 in float64 and reported in
    float32: there the backbone's BN gradients of this fixture are the
    remainder of a cancellation and carry percent-level rounding on any
    device (tests/test_torch_train_step.py)."""
    small = {"model.depth": 18, "model.feat_channels": 64,
             "model.num_words": 16, "data.img_hw": (128, 128)}
    cfg = train_cfg(**small)
    out = {}
    for dtype in (torch.float32, torch.float64):
        runs = []
        for dev in ("cpu", DEVICE):
            state = train_state(cfg, dev, seed=1)
            jitter_bn(state.model)
            state.model.to(dtype)
            state.ema_params = {n: p.detach().clone() for n, p in
                                state.model.named_parameters()}
            step = train_step_fn(cfg, state, torch.float32)
            batch = train_batch(np.random.RandomState(0), 2, (128, 128),
                                20, dev)
            noise = torch.rand(11, 2 * 341,
                               generator=torch.Generator().manual_seed(2))
            state, m = step(state, batch, noise=noise.to(dev))
            runs.append(({k: float(v) for k, v in m.items()},
                         state_leaves(state)))
        (cm, cl), (gm, gl) = runs
        name = "float32" if dtype == torch.float32 else "float64"
        out[name] = {"loss_rel": max(rel(gm[k], cm[k]) for k in cm),
                     "leaves": leaf_errors(gl, cl), "losses_card": gm}
    log("train_parity", **out)
    for name, res in out.items():
        assert res["loss_rel"] <= 1e-4, (name, res)
        for kind, err in res["leaves"].items():
            if kind != "momentum" or name == "float64":
                assert err["max_rel"] <= 1e-5, (name, kind, err)
    return out


def timed_train(state, step, batches, ot_after=5):
    """2 warm-up steps, then 10 timed ones (CUDA events around each step,
    the last loss read back once), ``update_ot`` after step ``ot_after``
    timed on its own."""
    from glsdet_tpu_torch.train.boiw import update_ot

    for i in range(2):
        state, _ = step(state, batches[i % len(batches)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ptr0 = state.boiw.ptr.clone()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(24)]
    first = last = None
    ema_check = None
    for i in range(10):
        if i == 9:
            name = "head.gfl_reg.weight"
            ema_check = (name, state.ema_params[name].clone(), state.step)
        ev[2 * i].record()
        state, m = step(state, batches[i % len(batches)])
        ev[2 * i + 1].record()
        if i == 0:
            first = m
        last = m
        if i == ot_after:
            ev[20].record()
            state.boiw = update_ot(state.boiw, state.generator,
                                   TRAIN_PROXIES)
            ev[21].record()
    loss_last = float(last["loss"])             # the one readback
    torch.cuda.synchronize()
    step_ms = [ev[2 * i].elapsed_time(ev[2 * i + 1]) for i in range(10)]
    name, e_prev, s_prev = ema_check
    from glsdet_tpu_torch.train.schedules import ema_momentum

    m = ema_momentum(s_prev)
    p_new = dict(state.model.named_parameters())[name].detach()
    want = e_prev * (1 - m) + p_new * m
    ema_err = float((state.ema_params[name] - want).abs().max()
                    / want.abs().max())
    return state, {
        "ms_per_step": sum(step_ms) / 10, "step_ms": step_ms,
        "img_per_s": TRAIN_B * 1e3 / (sum(step_ms) / 10),
        "update_ot_ms": ev[20].elapsed_time(ev[21]),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "first": {k: float(v) for k, v in first.items()},
        "last": {k: float(v) for k, v in last.items()},
        "loss_last_readback": loss_last,
        "ptr_advanced": int((state.boiw.ptr != ptr0).sum()),
        "ema_rel_err": ema_err}


def train_profile(state, step, batch):
    """Where one full-width step's time goes (profile_step), and the ATSS
    targets timed alone."""
    from glsdet_tpu_torch.ops.priors import grid_anchors
    from glsdet_tpu_torch.train.gfl_loss import gfl_targets
    from glsdet_tpu_torch.train.steps import GFL_STRIDES

    anchors_np, counts = grid_anchors(TRAIN_HW, GFL_STRIDES)
    anchors = torch.from_numpy(anchors_np).to(DEVICE)
    targets_ms = cuda_ms(lambda: gfl_targets(
        anchors, counts, batch["gt_boxes"], batch["gt_labels"],
        batch["gt_valid"], 10), 5)
    prof = profile_step(lambda: step(state, batch))
    return state, {**prof, "atss_targets_ms": targets_ms}


def one_step(cfg, dtype, batch, noise, seed=3):
    """One step from a seeded full-width state: losses, BN statistics and
    the step's peak memory."""
    state = train_state(cfg, DEVICE, seed=seed)
    step = train_step_fn(cfg, state, dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, m = step(state, batch, noise=noise)
    torch.cuda.synchronize()
    bn = {k: v.clone() for k, v in state.model.state_dict().items()
          if "running" in k}
    out = ({k: float(v) for k, v in m.items()}, bn,
           torch.cuda.max_memory_allocated() / 2 ** 30)
    del state, step
    torch.cuda.empty_cache()
    return out


def phase_train(smi: str) -> dict:
    """MP-Det training: card-vs-CPU parity at a small size, then
    mp_det_res50 at full width (1024x1024, batch 4, bf16 autocast, remat
    on): timed steps with the OT hook, a profiled step, one step under
    the sync debug mode, remat on vs off, bf16 vs float32."""
    t0 = time.perf_counter()
    out = {"card": smi, "parity": train_parity()}
    cfg = train_cfg()
    assert cfg.model.remat and cfg.data.img_hw == TRAIN_HW
    rs = np.random.RandomState(0)
    batches = [train_batch(rs, TRAIN_B, TRAIN_HW, TRAIN_MAX_GT, DEVICE)
               for _ in range(2)]
    state = train_state(cfg, DEVICE)
    step = train_step_fn(cfg, state, torch.bfloat16)
    state, timed = timed_train(state, step, batches)
    out["full_width"] = timed
    for k in LOSS_NAMES:
        assert np.isfinite(timed["first"][k]) and np.isfinite(
            timed["last"][k]), timed
    assert timed["ptr_advanced"] > 0, timed
    probs = torch.split(state.boiw.proxies_prob.cpu(), TRAIN_PROXIES)
    out["proxies_prob_sums"] = [float(p.sum()) for p in probs]
    assert all(abs(s - 1.0) < 1e-5 for s in out["proxies_prob_sums"])
    assert timed["ema_rel_err"] < 1e-5, timed
    state, out["profile"] = train_profile(state, step, batches[0])

    # no host sync inside one full-width step
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = step(state, batches[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out["no_sync_step"] = True
    del state, step
    torch.cuda.empty_cache()

    # remat on vs off, bf16 vs float32: one step each from one state
    noise = torch.rand(11, TRAIN_B * 21824, device=DEVICE,
                       generator=torch.Generator(DEVICE).manual_seed(4))
    on = one_step(cfg, torch.bfloat16, batches[0], noise)
    off = one_step(train_cfg(**{"model.remat": False}), torch.bfloat16,
                   batches[0], noise)
    bn_err = max(float((off[1][k] - on[1][k]).abs().max())
                 / max(float(on[1][k].abs().max()), 1e-30) for k in on[1])
    loss_err = max(rel(off[0][k], on[0][k]) for k in on[0])
    out["remat"] = {"loss_rel": loss_err, "bn_rel": bn_err,
                    "peak_mem_gib_on": on[2], "peak_mem_gib_off": off[2]}
    assert loss_err <= 1e-3 and bn_err <= 1e-3, out["remat"]
    f32 = one_step(cfg, torch.float32, batches[0], noise)
    out["bf16_vs_f32"] = {
        "rel": {k: rel(on[0][k], f32[0][k]) for k in on[0]},
        "peak_mem_gib_f32": f32[2]}
    assert out["bf16_vs_f32"]["rel"]["loss"] <= 5e-2, out["bf16_vs_f32"]
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"train": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# 18-20. the coarse YOLOX trainer, the GFL trainer, GFL in static int8


YOLOX_B, YOLOX_MAX_GT = 8, 300           # coarse_det's batch, max_gt
GFL_B = 4                                # gfl_res50's batch
YOLOX_NAMES = ("loss", "loss_cls", "loss_bbox", "loss_obj", "loss_l1",
               "num_fg")


def floats(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def time_steps(state, step, batches, b):
    """2 warm-up steps, then 10 timed ones (CUDA events around each, the
    metrics read back once at the end)."""
    for i in range(2):
        state, _ = step(state, batches[i % len(batches)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(20)]
    ms = []
    for i in range(10):
        ev[2 * i].record()
        state, m = step(state, batches[i % len(batches)])
        ev[2 * i + 1].record()
        ms.append(m)
    torch.cuda.synchronize()
    step_ms = [ev[2 * i].elapsed_time(ev[2 * i + 1]) for i in range(10)]
    mean = sum(step_ms) / 10
    return state, {"ms_per_step": mean, "step_ms": step_ms,
                   "img_per_s": b * 1e3 / mean,
                   "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "first": floats(ms[0]), "last": floats(ms[-1])}


def profile_summary(prof, wall_ms: float, steps: int = 1) -> dict:
    """Device busy time, idle share, launches and the ops that take most
    of the device, from a torch.profiler run of ``wall_ms``."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    launches = sum(e.count for e in kernels)
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": device_ms,
            "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "kernel_launches": launches,
            "launches_per_step": launches / steps,
            "top_ops_ms": [(e.key, e.self_device_time_total / 1e3, e.count)
                           for e in ops[:12]]}


def profile_step(run) -> dict:
    """torch.profiler over one ``run()`` (one train step): wall time,
    device busy time, idle share, kernel launches, the ops that take most
    of the device."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return profile_summary(prof, wall_ms)


def no_sync_step(state, step, batch):
    """One step under torch.cuda.set_sync_debug_mode("error"): any op that
    waits for the card raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return state, floats(m)


def check_finite(what, metrics, positive=()) -> None:
    bad = [k for k, v in metrics.items() if not np.isfinite(v)]
    bad += [k for k in positive if not metrics[k] > 0]
    if bad:
        raise AssertionError(f"{what}: {bad} not finite / not positive: "
                             f"{metrics}")


def family_parity(family) -> dict:
    """One float64 step of a small model of ``family`` from one seeded
    state (biases and BN statistics jittered, the schedule past its first
    steps) on the CPU and on the card (TF32 off, as main sets it): the
    metrics within 1e-5 relative; parameters, BN statistics, EMA and
    momentum within 1e-5 of each leaf's max."""
    from glsdet_tpu_torch.config import apply_overrides, get_config
    from glsdet_tpu_torch.train.steps import (make_gfl_train_step,
                                              make_yolox_train_step)

    if family == "yolox":
        cfg = apply_overrides(get_config("coarse_det"),
                              {"model.phi": "nano",
                               "data.img_hw": (128, 128)})
    else:
        cfg = apply_overrides(get_config("gfl_res50"),
                              {"model.depth": 18, "model.feat_channels": 64,
                               "data.img_hw": (128, 128)})
    runs = []
    for dev in ("cpu", DEVICE):
        state = train_state(cfg, dev, seed=1)
        jitter_bn(state.model)
        state.model.to(torch.float64)
        state.ema_params = {n: p.detach().clone() for n, p in
                            state.model.named_parameters()}
        state.optimizer.count = 500
        if family == "yolox":
            step = make_yolox_train_step(state.model, (128, 128),
                                         normalize=True)
            batch = train_batch(np.random.RandomState(0), 2, (128, 128),
                                60, dev, boxes="visdrone")
        else:
            step = make_gfl_train_step(state.model, (128, 128), 10,
                                       normalize=True)
            batch = train_batch(np.random.RandomState(0), 2, (128, 128),
                                20, dev)
        state, m = step(state, batch)
        named = dict(state.model.named_parameters())
        sd = state.model.state_dict()
        leaves = {"params": {n: sd[n] for n in named},
                  "bn_stats": {n: v for n, v in sd.items() if "running" in n},
                  "momentum": {n: state.optimizer.state[p]["momentum_buffer"]
                               for n, p in named.items()},
                  "ema": state.ema_params}
        runs.append((floats(m), leaves))
    (cm, cl), (gm, gl) = runs
    out = {"loss_rel": max(rel(gm[k], cm[k]) for k in cm),
           "leaves": leaf_errors(gl, cl), "metrics_card": gm}
    if out["loss_rel"] > 1e-5 or any(e["max_rel"] > 1e-5
                                     for e in out["leaves"].values()):
        raise AssertionError(f"{family} card vs CPU: {out}")
    return out


def phase_train_yolox(smi: str) -> dict:
    """coarse_det's trainer at full width (YOLOX-s, 10 classes, 640x640,
    batch 8, max_gt 300, bf16 autocast, yolox_sgd with its warm-cos
    schedule, seeded weights, VisDrone-like batches): card-vs-CPU parity
    at a small size, 10 timed steps, a profiled step, a step under the
    sync debug mode, a use_l1 step and one resize_from step each way
    (640 -> 608 and 640 -> 672)."""
    from glsdet_tpu_torch.config import get_config
    from glsdet_tpu_torch.train.loop import family_strides
    from glsdet_tpu_torch.train.steps import make_yolox_train_step

    t0 = time.perf_counter()
    out = {"card": smi, "parity": family_parity("yolox")}
    cfg = get_config("coarse_det")
    hw = tuple(cfg.data.img_hw)
    assert (hw, cfg.data.batch_size, cfg.data.max_gt) == (
        COARSE_HW, YOLOX_B, YOLOX_MAX_GT), cfg
    rs = np.random.RandomState(0)
    batches = [train_batch(rs, YOLOX_B, hw, YOLOX_MAX_GT, DEVICE,
                           boxes="visdrone") for _ in range(2)]
    out["gts_per_image"] = [int(v) for b in batches
                            for v in b["gt_valid"].sum(1).cpu()]
    state = train_state(cfg, DEVICE)

    def make(**kw):
        return make_yolox_train_step(
            state.model, kw.pop("img_hw", hw),
            strides=family_strides(cfg.model.family), normalize=True,
            dtype=torch.bfloat16, **kw)

    step = make()
    state, out["timed"] = time_steps(state, step, batches, YOLOX_B)
    for k in ("first", "last"):
        check_finite("train_yolox", out["timed"][k], ("num_fg",))
    out["profile"] = profile_step(lambda: step(state, batches[0]))
    state, out["no_sync_step"] = no_sync_step(state, step, batches[0])
    check_finite("no-sync step", out["no_sync_step"], ("num_fg",))
    state, m = make(use_l1=True)(state, batches[1])
    out["use_l1"] = floats(m)
    check_finite("use_l1 step", out["use_l1"], ("num_fg", "loss_l1"))
    out["resize_from"] = {}
    for side in (608, 672):
        rstep = make(img_hw=(side, side), resize_from=hw)
        state, m = rstep(state, batches[0])             # warm
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = rstep(state, batches[1])
        m = floats(m)
        torch.cuda.synchronize()
        check_finite(f"resize_from {hw} -> {side}", m, ("num_fg",))
        out["resize_from"][f"640->{side}"] = {
            **m, "step_ms_host": 1e3 * (time.perf_counter() - t1)}
    out["seconds"] = time.perf_counter() - t0
    del state, step
    torch.cuda.empty_cache()
    print(json.dumps({"train_yolox": out}), flush=True)
    return out


def phase_train_gfl(smi: str) -> dict:
    """gfl_res50's trainer at full width (ResNet-50 + FPN + GFLHead,
    1024x1024, batch 4, bf16 autocast, remat as configured, mp_sgd,
    seeded weights, _mk_batch's recipe): card-vs-CPU parity at a small
    size, 10 timed steps, a profiled step, a step under the sync debug
    mode."""
    from glsdet_tpu_torch.config import get_config
    from glsdet_tpu_torch.train.steps import make_gfl_train_step

    t0 = time.perf_counter()
    out = {"card": smi, "parity": family_parity("gfl")}
    cfg = get_config("gfl_res50")
    hw = tuple(cfg.data.img_hw)
    assert (hw, cfg.data.batch_size) == (TRAIN_HW, GFL_B), cfg
    out["remat"] = cfg.model.remat
    rs = np.random.RandomState(0)
    batches = [train_batch(rs, GFL_B, hw, TRAIN_MAX_GT, DEVICE)
               for _ in range(2)]
    state = train_state(cfg, DEVICE)
    step = make_gfl_train_step(state.model, hw, cfg.model.num_classes,
                               normalize=True, dtype=torch.bfloat16)
    state, out["timed"] = time_steps(state, step, batches, GFL_B)
    for k in ("first", "last"):
        check_finite("train_gfl", out["timed"][k], ("loss_bbox",))
    out["profile"] = profile_step(lambda: step(state, batches[0]))
    state, out["no_sync_step"] = no_sync_step(state, step, batches[0])
    check_finite("no-sync step", out["no_sync_step"])
    out["seconds"] = time.perf_counter() - t0
    del state, step
    torch.cuda.empty_cache()
    print(json.dumps({"train_gfl": out}), flush=True)
    return out


def matched_share(ref, got, top=10) -> float:
    """Share of each frame's ``top`` highest-scoring ``ref`` detections
    with a ``got`` detection of the same label, IoU > 0.5 and a score
    within 0.3."""
    hits = n = 0
    for r, g in zip(ref, got):
        order = np.argsort(-r["scores"])[:top]
        for i in order:
            box = r["boxes"][i]
            cand = ((g["labels"] == r["labels"][i])
                    & (np.abs(g["scores"] - r["scores"][i]) < 0.3))
            o = g["boxes"][cand]
            lt = np.maximum(o[:, :2], box[:2])
            rb = np.minimum(o[:, 2:], box[2:])
            inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
            area = lambda x: np.prod(x[..., 2:] - x[..., :2], axis=-1)  # noqa
            iou = inter / np.maximum(area(o) + area(box) - inter, 1e-9)
            hits += int((iou > 0.5).any())
            n += 1
    return hits / max(n, 1)


def gfl_nms(nms_calls) -> dict:
    """B2 at the inputs the GFL Detector gave it in each run: the keep
    mask the path got equal to nms_sorted_plain's on the same sorted
    boxes, valid flags, threshold and offset; each launch of the int8 run
    timed with its plain version and bound, summed per batch."""
    from glsdet_tpu_torch.ops.nms import nms_sorted_plain

    for run, captured in nms_calls.items():
        for bx, vd, thr, off, keep in captured:
            if not torch.equal(keep, nms_sorted_plain(bx, vd, thr, off)):
                raise AssertionError(
                    f"gfl {run} NMS {tuple(bx.shape)}: keep mask differs "
                    "from nms_sorted_plain")
    launches = []
    total = dict.fromkeys(("ms", "graph_ms", "plain_ms", "bound_ms"), 0.0)
    share = {"bytes": 0.0, "operations": 0.0}
    for bx, vd, thr, off, keep in nms_calls["int8"]:
        t, b = nms_times(bx, vd, thr, off), nms_bound(bx, vd, keep)
        launches.append({"batch": bx.shape[0], "k": bx.shape[1],
                         "offset": off, "threshold": thr,
                         "valid": int(vd.sum()), "kept": int(keep.sum()),
                         **t, **b})
        for key in total:
            total[key] += t[key] if key in t else b[key]
        share[b["bound_by"]] += b["bound_ms"]
    return {"launches": launches, "per_batch": total,
            "bound_by": max(share, key=share.get),
            "bf16_launches": len(nms_calls["bf16"]), "masks_equal": True,
            "max_abs_err": 0.0}


def phase_gfl_int8(frames) -> dict:
    """Detector("gfl_res50") on the card from a state-dict file, in bf16
    and in static int8 (lazy calibration on the first batch, the scales
    saved): the int8 model vs bf16 on one input (relative max error <
    0.3), B3 launched 40 times per int8 batch (5 levels x 8) and, on the
    accumulators this path gives it, within +-1 code of
    gn_relu_quant_acc_plain, timed; B2 (gfl_postprocess's NMS) on the
    inputs each run gives it, its keep mask equal to nms_sorted_plain's,
    timed beside its bound; the int8 detections vs bf16's (the top 10 per
    frame matched at IoU > 0.5, scores within 0.3); img/s."""
    from glsdet_tpu_torch.apis import Detector
    from glsdet_tpu_torch.config import get_config
    from glsdet_tpu_torch.models.build import build_model
    from glsdet_tpu_torch.ops import gn_kernel
    from glsdet_tpu_torch.ops import nms as nms_mod
    from glsdet_tpu_torch.ops import quant_static as tq

    t0 = time.perf_counter()
    imgs = frames[:4]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gfl_res50.pt")
        torch.save(build_model(get_config("gfl_res50"), "cpu").state_dict(),
                   path)
        scales_path = os.path.join(tmp, "gfl_int8_scales.json")
        bf = Detector("gfl_res50", path, device=DEVICE)
        q8 = Detector("gfl_res50", path, quant8="static",
                      int8_scales=scales_path, device=DEVICE)
        bf.detect_batch(imgs)
        q8.detect_batch(imgs)                   # calibrates, saves
        saved = os.path.exists(scales_path)
    if not saved or type(q8._net.head) is not tq.Int8GFLHead:
        raise AssertionError("gfl int8: scales not saved or head not int8")
    x = bf._inputs(imgs)
    with torch.inference_mode():
        errs = rel_errors(q8._net(x), bf._net(x))
    if max(errs) >= 0.3:
        raise AssertionError(f"gfl int8 vs bf16 rel err {errs}")
    calls, nms_calls = [], {"int8": [], "bf16": []}
    real, real_nms = tq.gn_relu_quant_acc, nms_mod.nms_sorted_cuda

    def spy(acc, deq, gamma, beta, s_out, **kw):
        out = real(acc, deq, gamma, beta, s_out, **kw)
        calls.append((acc, deq, gamma, beta, s_out, kw, out))
        return out

    def nms_spy(run):
        def nms(bx, vd, thr, offset=0.0):
            keep = real_nms(bx, vd, thr, offset)
            nms_calls[run].append((bx.clone(), vd.clone(), float(thr),
                                   float(offset), keep.clone()))
            return keep
        return nms

    torch.cuda.synchronize()
    reset_launches()
    tq.gn_relu_quant_acc, nms_mod.nms_sorted_cuda = spy, nms_spy("int8")
    try:
        res8 = q8.detect_batch(imgs)
        torch.cuda.synchronize()
    finally:
        tq.gn_relu_quant_acc, nms_mod.nms_sorted_cuda = real, real_nms
    launches = read_launches()
    nms_mod.nms_sorted_cuda = nms_spy("bf16")
    try:
        res16 = bf.detect_batch(imgs)
        torch.cuda.synchronize()
    finally:
        nms_mod.nms_sorted_cuda = real_nms
    if launches["gn"] != 40 or len(calls) != 40 or launches["nms"] < 1 \
            or len(nms_calls["int8"]) != launches["nms"] \
            or not nms_calls["bf16"]:
        n_nms = {run: len(v) for run, v in nms_calls.items()}
        raise AssertionError(f"gfl int8 launches {launches}, {len(calls)} "
                             f"tower calls, NMS calls {n_nms} (want 40 GN, "
                             ">= 1 NMS in each run)")
    nms = gfl_nms(nms_calls)
    n8, n16 = check_results(res8, 4), check_results(res16, 4)
    share = matched_share(res16, res8)
    if n16 == 0 or share < 0.5:
        raise AssertionError(f"gfl int8 detections vs bf16: {n8} / {n16}, "
                             f"matched {share}")
    # B3 on this path's own accumulators, against its plain version
    worst, share_diff = 0.0, 0.0
    ms = plain_ms = bound_ms = 0.0
    levels = []
    for acc, deq, gamma, beta, s_out, kw, got in calls:
        want = gn_kernel.gn_relu_quant_acc_plain(
            acc, deq, gamma, beta, s_out, kw["groups"], kw["eps"],
            kw["dtype"])
        c = check_codes(got, want, f"gfl int8 {tuple(acc.shape)}")
        worst = max(worst, c["max_abs_err"])
        share_diff = max(share_diff, c["share_differing"])
    seen = set()
    for acc, deq, gamma, beta, s_out, kw, _ in calls:
        shape = tuple(acc.shape)
        if shape in seen:
            continue
        seen.add(shape)
        k = cuda_ms(lambda: real(acc, deq, gamma, beta, s_out, **kw))
        p = cuda_ms(lambda: gn_kernel.gn_relu_quant_acc_plain(
            acc, deq, gamma, beta, s_out, kw["groups"], kw["eps"],
            kw["dtype"]))
        bd = bound(acc.numel() * 5, 0.0, PEAK_F32)   # int32 in, int8 out
        n = sum(1 for c in calls if tuple(c[0].shape) == shape)
        levels.append({"shape": list(shape), "calls": n, "ms": k,
                       "plain_ms": p, **bd,
                       "plan": gn_kernel.plan(torch.int32, *shape)})
        ms += n * k
        plain_ms += n * p
        bound_ms += n * bd["bound_ms"]
    out = {"launches": launches, "max_rel_err_vs_bf16": max(errs),
           "gn_max_abs_err": worst, "gn_share_differing": share_diff,
           "levels": levels, "gn_ms_40": ms, "gn_plain_ms_40": plain_ms,
           "gn_bound_ms_40": bound_ms, "nms": nms, "detections_int8": n8,
           "detections_bf16": n16, "top10_matched_share": share,
           "img_per_s_bf16": batch_img_per_s(bf, imgs),
           "img_per_s_int8": batch_img_per_s(q8, imgs),
           "seconds": time.perf_counter() - t0}
    log("gfl_int8", **out)
    del bf, q8
    torch.cuda.empty_cache()
    return out

# ---------------------------------------------------------------------------
# 21. train(): the data pipeline and the loop, from PNG files on disk


LOOP_FRAMES = (((765, 1360), 48), ((1080, 1920), 16))
LOOP_WORKERS = 8             # threads writing the synthetic frames


def synth_visdrone_pixels(seed, hw):
    """A smooth field (a coarse random grid resized up) with boxes drawn
    in flat colours and +-2 codes of noise, uint8; and its VisDrone
    annotation lines: 5-60 boxes of 4-64 px, 0-3 ignore rows (category
    0) and 0-2 "others" rows (category 11)."""
    from glsdet_tpu_torch.ops.image import resize_linear_u8

    rs = np.random.RandomState(seed)
    h, w = hw
    coarse = rs.randint(40, 216, (h // 96 + 2, w // 96 + 2, 3), np.uint8)
    img = resize_linear_u8(torch.from_numpy(coarse), hw).numpy().astype(
        np.int16)
    lines = []
    for cat, n in ((None, rs.randint(5, 61)), (0, rs.randint(0, 4)),
                   (11, rs.randint(0, 3))):
        for _ in range(n):
            bw, bh = rs.randint(4, 65), rs.randint(4, 65)
            x, y = rs.randint(0, w - bw), rs.randint(0, h - bh)
            c = int(rs.randint(1, 11)) if cat is None else cat
            img[y:y + bh, x:x + bw] = rs.randint(0, 256, 3)
            lines.append(f"{x},{y},{bw},{bh},{int(cat is None)},{c},0,0")
    img += rs.randint(-2, 3, img.shape).astype(np.int16)
    return np.clip(img, 0, 255).astype(np.uint8), lines


def synth_visdrone_frame(seed, hw):
    """:func:`synth_visdrone_pixels` as PNG bytes, and its lines."""
    from glsdet_tpu_torch.data.image_io import encode_png

    img, lines = synth_visdrone_pixels(seed, hw)
    return encode_png(img), lines


def write_loop_dataset(root) -> dict:
    """The synthetic VisDrone split (LOOP_FRAMES), converted with the
    port's visdrone_to_coco: bytes on disk and decode time per frame."""
    from concurrent.futures import ThreadPoolExecutor

    from glsdet_tpu_torch.data.image_io import read_image
    from glsdet_tpu_torch.data.visdrone import visdrone_to_coco

    t0 = time.perf_counter()
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "annotations"))
    jobs = list(enumerate(hw for hw, n in LOOP_FRAMES for _ in range(n)))

    def write(job):
        k, hw = job
        data, lines = synth_visdrone_frame(1000 + k, hw)
        with open(os.path.join(root, "images", f"{k:05d}.png"), "wb") as f:
            f.write(data)
        with open(os.path.join(root, "annotations", f"{k:05d}.txt"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")
        return len(data)

    with ThreadPoolExecutor(LOOP_WORKERS) as pool:
        sizes = list(pool.map(write, jobs))
    ann = os.path.join(root, "ann.json")
    coco = visdrone_to_coco(root, ann)
    decode = {}
    read_image(os.path.join(root, "images", "00000.png"))  # builds png.cpp
    for hw, _ in LOOP_FRAMES:
        names = [f"{k:05d}.png" for k, f_hw in jobs if f_hw == hw][:4]
        t1 = time.perf_counter()
        for name in names:
            img = read_image(os.path.join(root, "images", name))
            assert img.shape == (*hw, 3), img.shape
        decode[f"{hw[0]}x{hw[1]}"] = 1e3 * (time.perf_counter() - t1) / 4
    by_hw = {}
    for (k, hw), n in zip(jobs, sizes):
        by_hw.setdefault(f"{hw[0]}x{hw[1]}", []).append(n)
    return {"ann_file": ann, "img_root": os.path.join(root, "images"),
            "frames": len(jobs), "annotations": len(coco["annotations"]),
            "ignore_regions": len(coco["ignore_regions"]),
            "bytes_on_disk": int(sum(sizes)),
            "mean_bytes": {k: sum(v) / len(v) for k, v in by_hw.items()},
            "decode_ms_per_frame": decode,
            "seconds": time.perf_counter() - t0}


class LoopProbe:
    """Stands in for train/loop.py's train_loader: the real loader, with
    the host time of each batch taken and, optionally, torch.profiler
    over the steps of batches [start, stop) (the loader's waits
    included)."""

    def __init__(self, real, start=None, stop=None):
        self.real, self.start, self.stop = real, start, stop
        self.times, self.keys, self.profile = [], [], None

    def __call__(self, *args, **kw):
        from torch.profiler import ProfilerActivity, profile

        inner = self.real(*args, **kw)
        prof = None
        try:
            for i, batch in enumerate(inner):
                self.times.append(time.perf_counter())
                self.keys.append(sorted(batch))
                if i == self.stop and prof is not None:
                    torch.cuda.synchronize()
                    wall = 1e3 * (time.perf_counter() - t0)
                    prof.__exit__(None, None, None)
                    self.profile = profile_summary(prof, wall,
                                                   self.stop - self.start)
                    prof = None
                if i == self.start:
                    torch.cuda.synchronize()
                    prof = profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA])
                    prof.__enter__()
                    t0 = time.perf_counter()
                yield batch
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
            inner.close()


class LogRecords:
    """Collects the glsdet_tpu_torch logger's messages during a run."""

    def __enter__(self):
        import logging

        self.lines = []
        self.logger = logging.getLogger("glsdet_tpu_torch")
        self.level = self.logger.level
        self.handler = logging.Handler(logging.DEBUG)
        self.handler.emit = lambda r: self.lines.append(r.getMessage())
        self.logger.addHandler(self.handler)
        self.logger.setLevel(logging.DEBUG)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)

    def ints(self, pattern):
        return [tuple(int(g) for g in m.groups()) for m in
                (re.fullmatch(pattern, line) for line in self.lines) if m]


def loop_cfg(name, ds, work, **over):
    from glsdet_tpu_torch.config import apply_overrides, get_config

    return apply_overrides(get_config(name), {
        "data.ann_file": ds["ann_file"], "data.img_root": ds["img_root"],
        "train.work_dir": work, "train.log_interval": 1, **over})


def read_log(work) -> list:
    with open(os.path.join(work, "train.log.json")) as f:
        return [json.loads(line) for line in f]


def run_train(cfg, probe=None, **kw):
    """train(cfg) on the card through ``probe`` (a LoopProbe, or a plain
    one): its state, log entries, the host ms between batches, peak
    memory and wall seconds."""
    from glsdet_tpu_torch.train import loop

    probe = probe or LoopProbe(loop.train_loader)
    real = loop.train_loader
    loop.train_loader = probe
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        state = loop.train(cfg, device=DEVICE, **kw)
    finally:
        loop.train_loader = real
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    logs = read_log(cfg.train.work_dir)
    for e in logs:
        check_finite(f"train {cfg.name} step {e['step']}",
                     {k: v for k, v in e.items()
                      if k not in ("mode", "epoch", "iter", "step")})
    gaps = [1e3 * (b - a) for a, b in zip(probe.times, probe.times[1:])]
    return state, logs, gaps, {
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "first_batch_s": probe.times[0] - t0, "seconds": wall}


def cpu_state(state) -> dict:
    from glsdet_tpu_torch.train.state import state_dict

    sd = state_dict(state)
    sd["generator"] = sd["generator"].clone()
    return sd


def same_state(a, b) -> bool:
    """Two state_dict snapshots equal bit for bit."""
    def eq(x, y):
        if torch.is_tensor(x):
            return torch.is_tensor(y) and x.shape == y.shape and bool(
                torch.equal(x, y))
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(eq(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(eq(u, v) for u, v in zip(x, y))
        return x == y

    return eq(a, b)


def loop_coarse(ds, tmp, bare_ms) -> dict:
    """train(coarse_det) at full width: 3 epochs of 8 steps, a checkpoint
    after each, the last epoch with L1 (its batches were drawn before the
    switch, so they still carry mosaic: the loader's 4 x 2 in flight);
    steps 4-7 profiled, the host clock between batches; then the epoch-2
    checkpoint restored and resumed, and init_detector serving the
    epoch-3 EMA."""
    from glsdet_tpu_torch import apis
    from glsdet_tpu_torch.train import loop

    work = os.path.join(tmp, "coarse")
    cfg = loop_cfg("coarse_det", ds, work, **{
        "train.epochs": 3, "train.warmup_epochs": 1,
        "train.num_last_epochs": 1, "train.ckpt_interval": 1})
    assert (tuple(cfg.data.img_hw), cfg.data.batch_size, cfg.model.phi,
            cfg.data.device_color, cfg.data.mosaic, cfg.data.mixup) == (
        COARSE_HW, YOLOX_B, PHI, True, True, True), cfg
    seen, aps, evals = {}, [], []
    run_ap = train_eval_fn(cfg, eval_split(ds, tmp, "val_train",
                                           LOOP_EVAL_FRAMES), aps)

    def eval_fn(st, ep):
        seen[ep] = cpu_state(st)
        t0 = time.perf_counter()
        run_ap(st, ep)
        evals.append((t0, time.perf_counter()))

    probe = LoopProbe(loop.train_loader, start=3, stop=7)
    state, logs, gaps_with_eval, run = run_train(cfg, probe,
                                                 eval_fn=eval_fn)
    # the gaps net of the epoch evals they span, as PR 10's loop measured
    # them without one (the loader prefetches on during an eval)
    gaps = [g - 1e3 * sum(max(0.0, min(b, e1) - max(a, e0))
                          for e0, e1 in evals)
            for g, a, b in zip(gaps_with_eval, probe.times,
                               probe.times[1:])]
    if [a["epoch"] for a in aps] != [1, 2, 3]:
        raise AssertionError(f"eval_fn ran after epochs {aps}")
    spe = 64 // YOLOX_B
    assert state.step == 3 * spe and len(logs) == 3 * spe, (state.step,
                                                            len(logs))
    l1 = [e["loss_l1"] for e in logs]
    assert all(v == 0.0 for v in l1[:2 * spe]) and all(
        v > 0.0 for v in l1[2 * spe:]), l1
    ckpts = sorted(f for f in os.listdir(work) if f.endswith(".pt"))
    assert ckpts == ["epoch_1.pt", "epoch_2.pt", "epoch_3.pt"], ckpts
    # restore the epoch-2 checkpoint into a fresh state: bit for bit
    model = loop.build_model(cfg, DEVICE,
                             generator=torch.Generator().manual_seed(9))
    fresh = loop.make_state_template(
        cfg, model, loop.build_optimizer(cfg, spe, model),
        torch.Generator(device=DEVICE).manual_seed(9))
    restored = loop.restore_checkpoint(os.path.join(work, "epoch_2.pt"),
                                       fresh)
    restore_equal = same_state(cpu_state(restored), seen[2])
    assert restore_equal, "checkpoint restore differs"
    del restored, fresh, model
    # resume: only epoch 3's steps, in the no-aug + L1 mode
    rcfg = loop_cfg("coarse_det", ds, os.path.join(tmp, "resume"), **{
        "train.epochs": 3, "train.warmup_epochs": 1,
        "train.num_last_epochs": 1, "train.ckpt_interval": 1,
        "train.resume": os.path.join(work, "epoch_2.pt")})
    rprobe = LoopProbe(loop.train_loader)
    rstate, rlogs, _, _ = run_train(rcfg, rprobe)
    assert [e["step"] for e in rlogs] == list(range(2 * spe + 1,
                                                    3 * spe + 1)), rlogs
    assert all(e["loss_l1"] > 0 for e in rlogs)
    # drawn after the switch: the plain pipeline (no mix_images)
    assert all("mix_images" not in k for k in rprobe.keys), rprobe.keys
    assert all("mix_images" in k for k in probe.keys[:2 * spe])
    del rstate
    # init_detector serves the EMA of the last checkpoint
    _, served, _ = apis.init_detector(
        "coarse_det", os.path.join(work, "epoch_3.pt"), device=DEVICE)
    ema = seen[3]["ema_params"]
    ema_served = all(torch.equal(p.detach().cpu(), ema[n])
                     for n, p in served.named_parameters())
    assert ema_served, "init_detector does not serve the EMA"
    del served, state
    torch.cuda.empty_cache()
    # host ms between batches: the loader's 4 x 2 prefetched batches and
    # those built during the checkpoint stalls run at the card's pace,
    # the rest at the loader's
    steady = sum(gaps) / len(gaps)
    return {"steps": len(logs), "losses_first_last": [logs[0]["loss"],
                                                      logs[-1]["loss"]],
            "l1_switch_at_step": 2 * spe + 1, "checkpoints": ckpts,
            "restore_bit_equal": restore_equal,
            "resume_steps": [rlogs[0]["step"], rlogs[-1]["step"]],
            "init_detector_serves_ema": ema_served, "epoch_eval": aps,
            "first_batch_s": run["first_batch_s"],
            "ms_per_step_after_first": steady, "step_gaps_ms": gaps,
            "step_gaps_with_eval_ms": gaps_with_eval,
            "eval_s_in_gaps": (sum(gaps_with_eval) - sum(gaps)) / 1e3,
            "img_per_s_after_first": YOLOX_B * 1e3 / steady,
            "ms_per_step_last_epoch": sum(gaps[-spe:]) / spe,
            "bare_step_ms": bare_ms,
            "loader_bound_x": sum(gaps[-spe:]) / spe / bare_ms,
            "profile_steps_4_7": probe.profile, **run}


def loop_multiscale(ds, tmp) -> dict:
    from glsdet_tpu_torch.train.loop import multiscale_size

    sizes = (608, 640, 672)
    cfg = loop_cfg("coarse_det", ds, os.path.join(tmp, "ms"), **{
        "train.epochs": 1, "train.warmup_epochs": 1,
        "train.num_last_epochs": 0, "train.ckpt_interval": 10,
        "train.multiscale_sizes": sizes, "train.multiscale_interval": 2})
    with LogRecords() as rec:
        # 6 steps: the schedule's first two sizes (608 x 4, then 672)
        state, logs, gaps, run = run_train(cfg, max_steps=6)
    got = rec.ints(r"step (\d+): multiscale size (\d+)")
    want = [(i, multiscale_size(i, sizes, 2)) for i in range(len(logs))]
    assert got == want and len({s for _, s in got}) > 1, (got, want)
    del state
    torch.cuda.empty_cache()
    return {"sizes": [s for _, s in got], "steps": len(logs),
            "ms_per_step": sum(gaps[1:]) / max(len(gaps) - 1, 1), **run}


class PrefetchProbe(LoopProbe):
    """A LoopProbe that hands out ``n`` batches made before the first is
    handed out: the host time between them is the steps' alone.  The
    first call draws them from the real loader; later calls hand out the
    same batches again."""

    def __init__(self, real, n):
        super().__init__(real)
        self.n, self.batches = n, None

    def __call__(self, *args, **kw):
        if self.batches is None:
            inner = self.real(*args, **kw)
            try:
                self.batches = [next(inner) for _ in range(self.n)]
            finally:
                inner.close()
        for batch in self.batches:
            self.times.append(time.perf_counter())
            self.keys.append(sorted(batch))
            yield batch


def loop_groups(ds, tmp) -> dict:
    """train(coarse_det) of 4 steps one at a time and in groups of two
    (train.steps_per_call; phase 15b's training part), both on the same
    4 batches, made (by 4 loader workers) before the first step: the
    loop's record of its groups (steps 0 and 2 for K = 2, none for
    K = 1), the log at steps 2 and 4, finite losses, and each run's host
    ms a step after the first."""
    from glsdet_tpu_torch.train import loop

    out = {}
    for k in (1, 2):
        cfg = loop_cfg("coarse_det", ds, os.path.join(tmp, f"groups{k}"), **{
            "train.epochs": 1, "train.warmup_epochs": 1,
            "train.num_last_epochs": 0, "train.ckpt_interval": 10,
            "train.steps_per_call": k, "train.log_interval": 2})
        if k == 1:
            probe = PrefetchProbe(loop.train_loader, 4)
        probe.times, probe.keys = [], []
        with LogRecords() as rec:
            state, logs, gaps, run = run_train(cfg, probe, max_steps=4)
        groups = rec.ints(r"step (\d+): group of (\d+) steps")
        steps = [e["step"] for e in logs]
        want = [(0, 2), (2, 2)] if k == 2 else []
        if state.step != 4 or steps != [2, 4] or groups != want:
            raise AssertionError(f"steps_per_call={k}: step {state.step}, "
                                 f"log at {steps}, groups {groups}")
        del state
        torch.cuda.empty_cache()
        out[f"k{k}"] = {"groups": groups, "logged_steps": steps,
                        "loss": [e["loss"] for e in logs],
                        "ms_per_step": sum(gaps[1:]) / (len(gaps) - 1),
                        **run}
    return {"steps": 4, **out}


def loop_geom(ds, tmp) -> dict:
    cfg = loop_cfg("coarse_det", ds, os.path.join(tmp, "geom"), **{
        "train.epochs": 1, "train.warmup_epochs": 1,
        "train.num_last_epochs": 0, "train.ckpt_interval": 10})
    state, logs, gaps, run = run_train(cfg, device_geom=True, max_steps=5)
    assert len(logs) == 5
    del state
    torch.cuda.empty_cache()
    return {"steps": len(logs),
            "ms_per_step": sum(gaps[1:]) / max(len(gaps) - 1, 1),
            "losses_first_last": [logs[0]["loss"], logs[-1]["loss"]], **run}


def loop_mpdet(ds, tmp) -> dict:
    """train(mp_det_res50) at 1024², batch 4, remat on, on 16 frames (4
    steps an epoch), 3 epochs: update_ot every 3 steps while the epoch is
    below 2, beta switched at epoch 1, read from the loop's log."""
    from glsdet_tpu_torch.data.coco import CocoDataset

    cfg = loop_cfg("mp_det_res50", ds, os.path.join(tmp, "mp"), **{
        "train.epochs": 3, "train.ot_interval": 3,
        "train.emd_start_epoch": 1, "train.ot_stop_epoch": 2,
        "train.ckpt_interval": 3})
    assert (tuple(cfg.data.img_hw), cfg.data.batch_size,
            cfg.model.remat) == (TRAIN_HW, TRAIN_B, True), cfg
    sub = CocoDataset(ds["ann_file"], ds["img_root"], filter_empty=True)
    sub.records = sub.records[:16]
    spe = 16 // TRAIN_B
    with LogRecords() as rec:
        state, logs, gaps, run = run_train(cfg, dataset=sub)
    ot = [s for (s,) in rec.ints(r"step (\d+): ran update_ot")]
    want_ot = [s for s in range(1, 3 * spe + 1)
               if (s - 1) // spe < 2 and s % 3 == 0]
    beta = [e for (e,) in rec.ints(r"epoch (\d+): enabled emd training "
                                   r"\(beta=1\)")]
    ptr_moved = int((state.boiw.ptr != 0).sum())
    beta_now = float(state.boiw.beta)
    assert ot == want_ot and beta == [1] and beta_now == 1.0, (ot, beta)
    assert ptr_moved > 0
    del state
    torch.cuda.empty_cache()
    return {"steps": len(logs), "update_ot_at": ot, "jax_cadence": want_ot,
            "beta_switched_at_epoch": beta, "ptr_moved_classes": ptr_moved,
            "ms_per_step": sum(gaps[1:]) / max(len(gaps) - 1, 1),
            "losses_first_last": [logs[0]["loss"], logs[-1]["loss"]], **run}


def loop_card_vs_cpu(ds, tmp) -> dict:
    """The device stages and image ops on the card against the CPU on one
    real batch, and two float64 steps of train() for YOLOX-nano at 128²
    on both devices from the same files and seed (the loader in the
    calling thread)."""
    from glsdet_tpu_torch.data.augment import random_affine_params
    from glsdet_tpu_torch.data.coco import CocoDataset
    from glsdet_tpu_torch.data.device_color import apply_batch_color
    from glsdet_tpu_torch.data.image_io import read_image
    from glsdet_tpu_torch.data.loader import TrainPipeline, collate
    from glsdet_tpu_torch.ops.image import resize_linear_u8, warp_affine_u8

    out = {}
    data = CocoDataset(ds["ann_file"], ds["img_root"], filter_empty=True)
    pipe = TrainPipeline(data, COARSE_HW, YOLOX_MAX_GT, raw_uint8=True,
                         device_color=True, device_geom=True,
                         geom_src_hw=(1080, 1920))
    batch = collate([pipe(i, np.random.RandomState(i))
                     for i in range(YOLOX_B)])
    cpu = apply_batch_color(batch, COARSE_HW)
    card = apply_batch_color({k: v.to(DEVICE) for k, v in batch.items()},
                             COARSE_HW).cpu()
    diff = (card - cpu).abs()
    out["color_geom"] = {"max_code_diff": float(diff.max()),
                         "share_differing": float((diff > 0).float().mean())}
    assert out["color_geom"]["max_code_diff"] <= 1, out
    frame = torch.from_numpy(read_image(os.path.join(
        ds["img_root"], data.records[0].file_name)))
    canvas = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (1280, 1280, 3), np.uint8))
    mat = random_affine_params(np.random.RandomState(2), (1280, 1280),
                               COARSE_HW)[:2]
    out["warp_affine_equal"] = bool(torch.equal(
        warp_affine_u8(canvas.to(DEVICE), mat, COARSE_HW).cpu(),
        warp_affine_u8(canvas, mat, COARSE_HW)))
    out["resize_equal"] = bool(torch.equal(
        resize_linear_u8(frame.to(DEVICE), (360, 640)).cpu(),
        resize_linear_u8(frame, (360, 640))))
    assert out["warp_affine_equal"] and out["resize_equal"], out

    from glsdet_tpu_torch.train import loop

    runs = []
    for dev in ("cpu", DEVICE):
        cfg = loop_cfg("coarse_det", ds, os.path.join(tmp, f"f64_{dev}"), **{
            "model.phi": "nano", "model.dtype": "float32",
            "data.img_hw": (128, 128), "data.batch_size": 4,
            "data.num_workers": 0, "train.ckpt_interval": 100})
        state = loop.train(cfg, max_steps=2, device=dev,
                           param_dtype=torch.float64)
        named = dict(state.model.named_parameters())
        sd = state.model.state_dict()
        leaves = {"params": {n: sd[n] for n in named},
                  "bn_stats": {n: v for n, v in sd.items() if "running" in n},
                  "momentum": {n: state.optimizer.state[p]["momentum_buffer"]
                               for n, p in named.items()},
                  "ema": state.ema_params}
        runs.append(([{k: v for k, v in e.items() if k.startswith("loss")
                       or k == "num_fg"}
                      for e in read_log(cfg.train.work_dir)], leaves))
    (cl, cleaves), (gl, gleaves) = runs
    loss_rel = max(rel(g[k], c[k]) for c, g in zip(cl, gl) for k in c
                   if c[k] != 0)
    out["f64_train_2_steps"] = {"loss_rel": loss_rel,
                                "leaves": leaf_errors(gleaves, cleaves),
                                "losses_card": gl}
    if loss_rel > 1e-5 or any(e["max_rel"] > 1e-5 for e in
                              out["f64_train_2_steps"]["leaves"].values()):
        raise AssertionError(f"train() card vs CPU: {out}")
    return out


def loader_rates(ds, reps=6) -> dict:
    """The loader alone at coarse_det's recipe (mosaic, mixup, device
    colour keys, batch 8, pinned): samples/s over ``reps`` batches after
    two, at os.cpu_count() workers (the rate ROADMAP item 17 reads), with
    the decode cache on, which drives ``CocoDataset``'s cache and its drop
    on pickling into the workers; every ``train()`` run drives the cache
    off."""
    from glsdet_tpu_torch.data.coco import CocoDataset
    from glsdet_tpu_torch.data.loader import TrainPipeline, train_loader

    workers = os.cpu_count()
    data = CocoDataset(ds["ann_file"], ds["img_root"], filter_empty=True,
                       cache_images=True)
    pipe = TrainPipeline(data, COARSE_HW, YOLOX_MAX_GT, raw_uint8=True,
                         device_color=True)
    loader = train_loader(pipe, YOLOX_B, seed=0, num_workers=workers,
                          pin_memory=True)
    try:
        t_start = time.perf_counter()
        for _ in range(2):
            next(loader)
        first = time.perf_counter() - t_start
        t0 = time.perf_counter()
        for _ in range(reps):
            next(loader)
        dt = time.perf_counter() - t0
    finally:
        loader.close()
    return {f"workers_{workers}_cache_on": {
        "samples_per_s": reps * YOLOX_B / dt, "first_two_batches_s": first}}


def phase_train_loop(smi: str, yolox: dict, tmp: str):
    """train() from PNG files at full width, written under ``tmp``:
    coarse_det (with a checkpoint, a resume, the mode switch,
    init_detector, and tools/train.py's eval_fn each epoch), multiscale,
    device_geom and mp_det_res50 (the OT cadence); then the card against
    the CPU and the loader alone.  Returns (its line, the dataset)."""
    t0 = time.perf_counter()
    out = {"card": smi}
    ds = write_loop_dataset(os.path.join(tmp, "visdrone"))
    out["dataset"] = {k: v for k, v in ds.items()
                      if k not in ("ann_file", "img_root")}
    out["coarse_det"] = loop_coarse(ds, tmp, yolox["timed"]["ms_per_step"])
    out["multiscale"] = loop_multiscale(ds, tmp)
    out["groups"] = loop_groups(ds, tmp)
    out["device_geom"] = loop_geom(ds, tmp)
    out["mp_det_res50"] = loop_mpdet(ds, tmp)
    out["card_vs_cpu"] = loop_card_vs_cpu(ds, tmp)
    out["loader"] = loader_rates(ds)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"train_loop": out}), flush=True)
    return out, ds


# ---------------------------------------------------------------------------
# 22. eval: run_eval, run_eval_tta and the two-stage ufpmp_det_eval


LOOP_EVAL_FRAMES = 16        # train()'s per-epoch eval set
EVAL_TTA_FRAMES = 16
EVAL_TTA_SCALES = (1.0, 1.25)
EVAL_CPU_FRAMES = 8
EVAL_STATS_TOL = 1e-3       # card vs CPU float32 COCO stats


def eval_split(ds, root, name, n=None, anns=None):
    """A val split of the loop dataset: its first ``n`` frames (all by
    default) with their own annotations, or ``anns`` (COCO dicts)."""
    from glsdet_tpu_torch.data.coco import CocoDataset

    with open(ds["ann_file"]) as f:
        coco = json.load(f)
    images = coco["images"][:n] if n else coco["images"]
    ids = {im["id"] for im in images}
    rows = coco["annotations"] if anns is None else anns
    out = dict(coco, images=images,
               annotations=[a for a in rows if a["image_id"] in ids])
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(out, f)
    return CocoDataset(path, ds["img_root"])


def train_eval_fn(cfg, val, aps):
    """tools/train.py's eval_fn over the port's run_eval: the EMA
    parameters and the model's BN statistics, the model in eval mode for
    the pass, each epoch's AP appended to ``aps`` and printed."""
    from glsdet_tpu_torch.eval.runner import run_eval

    fam = cfg.model.family if cfg.model.family in ("yolox", "ffa") \
        else "gfl"

    def eval_fn(state, epoch):
        model = state.model
        was_training = model.training
        model.eval()
        try:
            t0 = time.perf_counter()
            res, stats = run_eval(
                val, lambda v, x: torch.func.functional_call(model, v,
                                                             (x,)),
                fam, tuple(cfg.data.img_hw), cfg.model.num_classes,
                batch_size=cfg.data.batch_size,
                score_thr=cfg.eval.score_thr, nms_iou=cfg.eval.nms_iou,
                max_dets=cfg.eval.max_dets,
                variables={**model.state_dict(), **state.ema_params},
                dtype=torch.float32, device=DEVICE, verbose=False)
        finally:
            model.train(was_training)
        print(f"epoch {epoch}: AP={res.ap:.4f} AP50={res.ap50:.4f}",
              flush=True)
        aps.append({"epoch": epoch, "ap": res.ap, "ap50": res.ap50,
                    "images": stats["images"],
                    "seconds": time.perf_counter() - t0})

    return eval_fn


def jitter_(model, seed):
    """Replace the constant initial values of a seeded model's norm
    statistics, norm scales and biases by random ones, as the parity
    tests' flax_vars does: at the initializers' constants every coarse
    score sits at the prior (1e-4) to within 1e-11, so all detections tie
    and a ranking, a threshold or a max_dets cut is arbitrary.  The
    running variances are drawn from [0.7, 1.7), not flax_vars' [0.5,
    1.5): on some of phase 21's frames YOLOX-s's activations then grow
    through the CSP blocks until its box regression reaches 700 and the
    decode's exp overflows (the seeded model itself reaches 168); from
    0.7 on, the largest regression output over the 64 frames is 0.34
    (float32 on the CPU)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in [*model.named_parameters(), *model.named_buffers()]:
            leaf = name.rsplit(".", 1)[-1]
            if not t.is_floating_point():
                continue
            if leaf == "running_var":
                t.copy_(0.7 + torch.rand(t.shape, generator=g))
            elif leaf in ("running_mean", "bias"):
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
            elif leaf == "scale" or (leaf == "weight" and t.dim() == 1):
                t.copy_(1.0 + 0.1 * torch.randn(t.shape, generator=g))
    return model


def eval_models(root):
    """The eval phase's weights: YOLOX-s jittered, MP-Det as seeded, as
    the state-dict files ufpmp_det_eval loads, and the float32 YOLOX."""
    coarse, mp = seeded_models()
    jitter_(coarse, 7)
    paths = (os.path.join(root, "eval_coarse.pt"),
             os.path.join(root, "eval_mp.pt"))
    torch.save(coarse.state_dict(), paths[0])
    torch.save(mp.state_dict(), paths[1])
    return coarse, mp, paths


@contextlib.contextmanager
def capture_path(stage2_quant=None):
    """Captures, while the block runs: every B2 launch's inputs and keep
    mask (clones), the stage-2 groups of TwoStagePipeline objects whose
    ``quant8`` is ``stage2_quant`` (frames, rows, bucket), the count of
    stage-2 groups of any pipeline (each launches B1's path entry once),
    and B3's calls (their count, the first call at each shape cloned);
    and the kernels' launch counts, set to 0 first and read at the end."""
    from glsdet_tpu_torch.eval import two_stage
    from glsdet_tpu_torch.ops import nms as nms_mod
    from glsdet_tpu_torch.ops import nms_kernel, quant_static

    cap = {"nms": [], "groups": [], "stage2_calls": 0, "gn": {},
           "gn_calls": 0, "launches": None}
    real = (nms_mod.nms_sorted_cuda, two_stage.TwoStagePipeline.stage2_packed,
            quant_static.gn_relu_quant_acc)

    def nms(bx, vd, thr, offset=0.0):
        keep = real[0](bx, vd, thr, offset)
        cap["nms"].append((bx.clone(), vd.clone(), float(thr),
                           float(offset), keep.clone()))
        return keep

    def stage2(self, imgs, idx, regs, hw, gdets=None):
        cap["stage2_calls"] += int(idx.shape[0] > 0 and hw > 0)
        if self.quant8 == stage2_quant:
            cap["groups"].append((imgs, idx.clone(), regs.clone(), hw))
        return real[1](self, imgs, idx, regs, hw, gdets)

    def gn(acc, deq, gamma, beta, s_out, **kw):
        cap["gn_calls"] += 1
        if tuple(acc.shape) not in cap["gn"]:
            cap["gn"][tuple(acc.shape)] = (acc.clone(), deq, gamma, beta,
                                           s_out, kw)
        return real[2](acc, deq, gamma, beta, s_out, **kw)

    # an exported program's NMS operator calls the wrapper in nms_kernel
    nms_mod.nms_sorted_cuda = nms_kernel.nms_sorted_cuda = nms
    two_stage.TwoStagePipeline.stage2_packed = stage2
    quant_static.gn_relu_quant_acc = gn
    torch.cuda.synchronize()
    reset_launches()
    try:
        yield cap
        torch.cuda.synchronize()
        cap["launches"] = read_launches()
    finally:
        nms_mod.nms_sorted_cuda = nms_kernel.nms_sorted_cuda = real[0]
        two_stage.TwoStagePipeline.stage2_packed = real[1]
        quant_static.gn_relu_quant_acc = real[2]


def check_nms_calls(calls, what) -> dict:
    """Every captured B2 launch: its keep mask equal to nms_sorted_plain's
    on the same inputs, and timed on those inputs (eager, replayed, each
    pass, the plain version) beside its bound.  ``shapes`` sums the
    launches of each (B, K, threshold, offset); ``per_run`` sums them
    all."""
    from glsdet_tpu_torch.ops.nms import nms_sorted_plain

    keys = ("ms", "graph_ms", "pass1_graph_ms", "pass2_graph_ms",
            "plain_ms", "bound_ms")
    by_shape, total = {}, dict.fromkeys(keys, 0.0)
    share = {"bytes": 0.0, "operations": 0.0}
    for bx, vd, thr, off, keep in calls:
        if not torch.equal(keep, nms_sorted_plain(bx, vd, thr, off)):
            raise AssertionError(f"{what} NMS {tuple(bx.shape)}: keep mask "
                                 "differs from nms_sorted_plain")
        t = {**nms_times(bx, vd, thr, off), **nms_bound(bx, vd, keep)}
        row = by_shape.setdefault(
            (*bx.shape[:2], thr, off),
            {"batch": bx.shape[0], "k": bx.shape[1], "threshold": thr,
             "offset": off, "launches": 0, "valid": 0, "kept": 0,
             **dict.fromkeys(keys, 0.0)})
        row["launches"] += 1
        row["valid"] += int(vd.sum())
        row["kept"] += int(keep.sum())
        for key in keys:
            row[key] += t[key]
            total[key] += t[key]
        share[t["bound_by"]] += t["bound_ms"]
    return {"launches_checked": len(calls), "launches_timed": len(calls),
            "masks_equal": True, "max_abs_err": 0.0,
            "shapes": list(by_shape.values()), "per_run": total,
            "bound_by": max(share, key=share.get)}


def check_paint_groups(groups) -> list:
    """B1 at every captured stage-2 group: the path entry torch.equal to
    mosaic_inputs_plain; the first group of each (bucket, batch) timed
    beside its plain version and bound."""
    from glsdet_tpu_torch.eval.preprocess import (mosaic_inputs_plain,
                                                  norm_constants)
    from glsdet_tpu_torch.ufp.paint_kernel import (assemble_mosaic_cuda_batch,
                                                   paint_mosaic_inputs_cuda)

    mean, inv_std = norm_constants(torch.bfloat16, DEVICE)
    timed, rows = set(), []
    for imgs, idx, regs, hw in groups:
        run = lambda: paint_mosaic_inputs_cuda(  # noqa: E731
            imgs, idx, regs, hw, mean, inv_std)
        got = run()
        if not torch.equal(got, mosaic_inputs_plain(imgs, idx, regs, hw,
                                                    torch.bfloat16)):
            raise AssertionError(f"eval paint inputs at {hw}: differs "
                                 "from mosaic_inputs_plain")
        key = (hw, int(idx.shape[0]))
        if key in timed:
            continue
        timed.add(key)
        painted = float((assemble_mosaic_cuda_batch(
            imgs, idx, regs, hw, hw).float().abs().sum(-1) > 0).sum() * 3)
        t = {"hw": hw, "batch": key[1], "ms": cuda_ms(run),
             "graph_ms": graph_ms(run),
             "plain_ms": cuda_ms(lambda: mosaic_inputs_plain(
                 imgs, idx, regs, hw, torch.bfloat16), 3),
             **paint_bound(got, regs, painted, got.numel())}
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        t["groups"] = sum(1 for g in groups
                          if (g[3], int(g[1].shape[0])) == key)
        rows.append(t)
    return rows


def check_gn_captured(captured) -> list:
    """B3 on the inputs the path gave it (the first call at each shape)
    within +-1 code of its plain version, timed with its bound."""
    from glsdet_tpu_torch.ops.gn_kernel import (gn_relu_quant_acc,
                                                gn_relu_quant_acc_plain)

    rows = []
    for shape, (acc, deq, gamma, beta, s_out, kw) in sorted(
            captured.items()):
        args = (acc, deq, gamma, beta, s_out)
        c = check_codes(gn_relu_quant_acc(*args, **kw),
                        gn_relu_quant_acc_plain(*args, kw["groups"],
                                                kw["eps"], kw["dtype"]),
                        f"path input {shape}")
        t = {"shape": list(shape), **c,
             "ms": cuda_ms(lambda: gn_relu_quant_acc(*args, **kw)),
             "plain_ms": cuda_ms(lambda: gn_relu_quant_acc_plain(
                 *args, kw["groups"], kw["eps"], kw["dtype"]), 3),
             **bound(5 * acc.numel(), 12 * acc.numel(), PEAK_F32)}
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        rows.append(t)
    return rows


def check_stats(res, what) -> list:
    stats = [float(v) for v in res.stats]
    if not all(np.isfinite(v) and -1.0 <= v <= 1.0 for v in stats):
        raise AssertionError(f"{what}: COCO stats {stats}")
    return stats


def eval_single(name, val, model, family, cfg, batch, tta=False,
                out_json=None) -> dict:
    """run_eval (or run_eval_tta) of ``model`` over ``val`` on the card:
    a warm pass over one batch, then the timed pass with B2's launches
    captured and checked."""
    from glsdet_tpu_torch.eval.runner import run_eval, run_eval_tta

    kw = dict(score_thr=cfg.eval.score_thr, nms_iou=cfg.eval.nms_iou,
              max_dets=cfg.eval.max_dets, device=DEVICE, verbose=False)
    if tta:
        fn = run_eval_tta
        kw.update(tta_scales=EVAL_TTA_SCALES, tta_flip=True,
                  max_images=EVAL_TTA_FRAMES)
    else:
        fn = run_eval
        kw.update(batch_size=batch)
    hw = tuple(cfg.data.img_hw)
    n_cls = cfg.model.num_classes
    fn(val, model, family, hw, n_cls, **{**kw, "max_images": 1},
       format_only=True)
    torch.cuda.reset_peak_memory_stats()
    with capture_path() as cap:
        t0 = time.perf_counter()
        res, stats = fn(val, model, family, hw, n_cls, out_json=out_json,
                        **kw)
        seconds = time.perf_counter() - t0
    launches = cap["launches"]
    if launches["nms"] < 1 or launches["nms"] != len(cap["nms"]):
        raise AssertionError(f"eval {name}: B2 launches {launches}, "
                             f"{len(cap['nms'])} captured")
    return {"images": stats["images"], "seconds": seconds,
            "img_per_s": stats["images"] / seconds,
            "host_s": stats["host_s"], "host_share": stats["host_s"]
            / seconds, "stats": check_stats(res, name), "ap": res.ap,
            "launches": launches,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "nms": check_nms_calls(cap["nms"], f"eval {name}")}


def self_gt(dump, n_per_image=30, seed=0):
    """GT annotations from detections (a COCO results list): each image's
    top ``n_per_image`` by score of those at least 2 px wide and high
    (anchors over the letterbox padding give boxes clipped to nothing),
    every third dropped, the rest jittered by up to 5% of their sides, so
    that AP is well above 0."""
    rs = np.random.RandomState(seed)
    by_img = {}
    for d in sorted(dump, key=lambda d: -d["score"]):
        if min(d["bbox"][2:]) >= 2:
            by_img.setdefault(d["image_id"], []).append(d)
    anns = []
    for img_id, dets in by_img.items():
        for j, d in enumerate(dets[:n_per_image]):
            if j % 3 == 2:
                continue
            box = np.asarray(d["bbox"], np.float64)
            x, y, w, h = box + rs.uniform(-0.05, 0.05, 4) * box[[2, 3, 2, 3]]
            anns.append({"id": len(anns) + 1, "image_id": img_id,
                         "category_id": d["category_id"], "iscrowd": 0,
                         "bbox": [float(max(x, 0)), float(max(y, 0)),
                                  float(max(w, 1)), float(max(h, 1))],
                         "area": float(max(w, 1) * max(h, 1))})
    return anns


def eval_card_vs_cpu(ds, root, coarse) -> dict:
    """float32 run_eval of the jittered YOLOX-s (TF32 off) on the first
    EVAL_CPU_FRAMES frames, on the CPU and on the card, against GTs made
    from the CPU's own detections: the COCO stats within EVAL_STATS_TOL."""
    from glsdet_tpu_torch.config import get_config
    from glsdet_tpu_torch.eval.runner import run_eval

    cfg = get_config("coarse_det")
    kw = dict(batch_size=EVAL_CPU_FRAMES, score_thr=cfg.eval.score_thr,
              nms_iou=cfg.eval.nms_iou, max_dets=cfg.eval.max_dets,
              dtype=torch.float32, verbose=False)
    hw = tuple(cfg.data.img_hw)
    cpu_model = copy.deepcopy(coarse).float().eval()
    card_model = copy.deepcopy(coarse).float().eval().to(DEVICE)
    base = eval_split(ds, root, "val_cpu", EVAL_CPU_FRAMES)
    dump_path = os.path.join(root, "val_cpu_dets.json")
    run_eval(base, cpu_model, "yolox", hw, 10, device="cpu",
             out_json=dump_path, format_only=True, **kw)
    with open(dump_path) as f:
        anns = self_gt(json.load(f))
    val = eval_split(ds, root, "val_cpu_gt", EVAL_CPU_FRAMES, anns)
    t0 = time.perf_counter()
    cpu, cstats = run_eval(val, cpu_model, "yolox", hw, 10, device="cpu",
                           **kw)
    cpu_s = time.perf_counter() - t0
    card, gstats = run_eval(val, card_model, "yolox", hw, 10,
                            device=DEVICE, **kw)
    diff = float(np.abs(card.stats - cpu.stats).max())
    out = {"frames": EVAL_CPU_FRAMES, "gt_boxes": len(anns),
           "stats_cpu": check_stats(cpu, "cpu f32"),
           "stats_card": check_stats(card, "card f32"),
           "max_stat_diff": diff, "tolerance": EVAL_STATS_TOL,
           "cpu_seconds": cpu_s}
    if diff > EVAL_STATS_TOL or cpu.ap < 0.2:
        raise AssertionError(f"eval card vs CPU: {out}")
    return out


def eval_two_stage(ds, val_ann, paths, int8) -> dict:
    """glsdet_tpu_torch.tools.ufpmp_det_eval.main on the val split, with
    --fuse-global and the coarse threshold at 1e-4 (so that stage 2
    fires on these weights, as in the serving phases), in bf16 or with
    --int8-static (calibrating on the first 4 frames): B2's launches
    checked against its plain version, B1 at every stage-2 group equal to
    mosaic_inputs_plain, and in int8 B3 launched 40 times per group and
    within +-1 code of its plain version on the path's inputs."""
    from glsdet_tpu_torch.tools import ufpmp_det_eval

    name = "int8" if int8 else "bf16"
    out_json = os.path.join(os.path.dirname(val_ann), f"ufpmp_{name}.json")
    argv = ["coarse_det", paths[0], "mp_det_res50", paths[1], val_ann,
            ds["img_root"], "--fuse-global", "--out-json", out_json,
            "--first-options", "eval.coarse_score_thr=0.0001",
            "--device", DEVICE] + (["--int8-static"] if int8 else [])
    torch.cuda.reset_peak_memory_stats()
    with capture_path("static" if int8 else False) as cap:
        t0 = time.perf_counter()
        res, stats = ufpmp_det_eval.main(argv)
        seconds = time.perf_counter() - t0
    launches, groups = cap["launches"], cap["groups"]
    with open(out_json) as f:
        dump = json.load(f)
    boxes = np.asarray([d["bbox"] for d in dump], np.float64).reshape(-1, 4)
    ok = (len(dump) > 0 and np.isfinite(boxes).all()
          and (boxes[:, 2:] >= 0).all()
          and all(0 < d["score"] <= 1 for d in dump))
    want_gn = 40 * len(groups) if int8 else 0
    if not ok or not groups or launches["nms"] < 1 \
            or launches["paint_inputs"] < len(groups) \
            or launches["gn"] != want_gn or cap["gn_calls"] != want_gn:
        raise AssertionError(f"ufpmp_det_eval {name}: {len(dump)} "
                             f"detections, {len(groups)} groups, launches "
                             f"{launches}, {cap['gn_calls']} GN calls")
    return {"images": stats["images"], "seconds": seconds,
            "img_per_s": stats["images_per_sec"],
            "frame_read_s": stats["frame_read_s"],
            "detections": len(dump), "stats": check_stats(res, name),
            "groups": len(groups),
            "buckets": sorted({g[3] for g in groups}),
            "launches": launches,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "nms": check_nms_calls(cap["nms"], f"ufpmp {name}"),
            "paint": check_paint_groups(groups),
            "gn": check_gn_captured(cap["gn"]) if int8 else []}


def phase_eval(smi: str, ds, tmp: str) -> dict:
    """The eval entry points on the card over the loop dataset's val
    split (module docstring, phase 22)."""
    from glsdet_tpu_torch.config import get_config

    t0 = time.perf_counter()
    out = {"card": smi}
    root = os.path.join(tmp, "eval")
    os.makedirs(root)
    val = eval_split(ds, root, "val")
    coarse, mp, paths = eval_models(root)
    c_cfg, m_cfg = get_config("coarse_det"), get_config("mp_det_res50")
    y16 = copy.deepcopy(coarse).to(DEVICE, torch.bfloat16).eval()
    m16 = mp.to(DEVICE, torch.bfloat16).eval()
    runs = {
        "coarse_det": lambda: eval_single("coarse_det", val, y16, "yolox",
                                          c_cfg, c_cfg.data.batch_size),
        "mp_det_res50": lambda: eval_single("mp_det_res50", val, m16, "gfl",
                                            m_cfg, m_cfg.data.batch_size),
        "tta": lambda: eval_single("tta", val, y16, "yolox", c_cfg, 1,
                                   tta=True),
        "card_vs_cpu": lambda: eval_card_vs_cpu(ds, root, coarse),
        "ufpmp_bf16": lambda: eval_two_stage(ds, val_ann, paths, False),
        "ufpmp_int8": lambda: eval_two_stage(ds, val_ann, paths, True),
    }
    val_ann = os.path.join(root, "val.json")
    for key, run in runs.items():
        out[key] = run()
        log(f"eval_{key}", since_phase_start_s=time.perf_counter() - t0,
            **{k: v for k, v in out[key].items()
               if k not in ("nms", "paint", "gn")})
        if key == "card_vs_cpu":       # the single-model runs are done
            del y16, m16, mp
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"eval": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# 23. inputs: JPEG frames, reference .pth weights, raw JPEG request bodies

JPEG_QUALITY = 95
INPUT_VAL = 8                # val frames of each size in the JPEG split
TAG_BITS, TAG_BLOCK = 24, 16  # a raw body's request id: 24 grey blocks

# the reference repos' key naming: the inverse of the JAX package's
# rewrites (glsdet_tpu/utils/torch_import.py), as tests/torch_port_util.py
# has it (tests/test_torch_weights_import.py holds it to them)
_PAFPN = {"reduce5": "lateral_conv0", "reduce4": "reduce_conv1",
          "td_csp4": "C3_p4", "td_csp3": "C3_p3", "bu_down3": "bu_conv2",
          "bu_csp4": "C3_n3", "bu_down4": "bu_conv1", "bu_csp5": "C3_n4"}


def _undw(rest):
    return re.sub(r"^pw\.", "pconv.", re.sub(r"^dw\.", "dconv.", rest))


def _uncsp(rest):
    for port, ref in (("main_conv.", "conv1."), ("short_conv.", "conv2."),
                      ("final_conv.", "conv3.")):
        if rest.startswith(port):
            return ref + rest[len(port):]
    rest = re.sub(r"^block(\d+)\.conv2_dw\.dw\.", r"m.\1.conv2.dconv.", rest)
    rest = re.sub(r"^block(\d+)\.conv2_dw\.pw\.", r"m.\1.conv2.pconv.", rest)
    return re.sub(r"^block(\d+)\.", r"m.\1.", rest)


def yolox_drone_key(key):
    """A port YOLOX key -> the yolox-drone ``YoloBody`` key."""
    m = re.match(r"^backbone\.stem\.conv\.(.*)$", key)
    if m:
        return f"backbone.backbone.stem.conv.{m[1]}"
    m = re.match(r"^backbone\.dark(\d)_down\.(.*)$", key)
    if m:
        return f"backbone.backbone.dark{m[1]}.0.{_undw(m[2])}"
    m = re.match(r"^backbone\.spp\.(.*)$", key)
    if m:
        return f"backbone.backbone.dark5.1.{m[1]}"
    m = re.match(r"^backbone\.dark(\d)_csp\.(.*)$", key)
    if m:
        return (f"backbone.backbone.dark{m[1]}."
                f"{2 if m[1] == '5' else 1}.{_uncsp(m[2])}")
    m = re.match(r"^neck\.([A-Za-z0-9_]+)\.(.*)$", key)
    if m:
        rest = _uncsp(m[2]) if "csp" in m[1] else _undw(m[2])
        return f"backbone.{_PAFPN[m[1]]}.{rest}"
    m = re.match(r"^head\.stem(\d+)\.(.*)$", key)
    if m:
        return f"head.stems.{m[1]}.{m[2]}"
    m = re.match(r"^head\.(cls|reg)(\d+)_(\d+)\.(.*)$", key)
    if m:
        return f"head.{m[1]}_convs.{m[2]}.{m[3]}.{_undw(m[4])}"
    m = re.match(r"^head\.(cls|reg|obj)_pred(\d+)\.(.*)$", key)
    if m:
        return f"head.{m[1]}_preds.{m[2]}.{m[3]}"
    raise KeyError(key)


_MMDET = (
    (r"^backbone\.stem\.conv\.", "backbone.conv1."),
    (r"^backbone\.stem\.bn\.", "backbone.bn1."),
    (r"^backbone\.layer(\d)_(\d+)\.conv(\d)\.conv\.",
     r"backbone.layer\1.\2.conv\3."),
    (r"^backbone\.layer(\d)_(\d+)\.conv(\d)\.bn\.",
     r"backbone.layer\1.\2.bn\3."),
    (r"^backbone\.layer(\d)_(\d+)\.down\.conv\.",
     r"backbone.layer\1.\2.downsample.0."),
    (r"^backbone\.layer(\d)_(\d+)\.down\.bn\.",
     r"backbone.layer\1.\2.downsample.1."),
    (r"^neck\.lateral(\d+)\.", r"neck.lateral_convs.\1.conv."),
    (r"^neck\.fpn_conv(\d+)\.", r"neck.fpn_convs.\1.conv."),
    (r"^head\.(cls|reg)_conv(\d+)\.", r"bbox_head.\1_convs.\2."),
    (r"^head\.scale(\d+)\.scale$", r"bbox_head.scales.\1.scale"),
    (r"^head\.", "bbox_head."),
)


def mmdet_key(key):
    """A port MP-Det/GFL key -> the mmdet key (FPN extra convs follow
    the three per-level ones in ``fpn_convs``)."""
    m = re.match(r"^neck\.extra_conv(\d+)\.(.*)$", key)
    if m:
        return f"neck.fpn_convs.{int(m[1]) + 3}.conv.{m[2]}"
    for pat, rep in _MMDET:
        if re.match(pat, key):
            return re.sub(pat, rep, key)
    raise KeyError(key)


def reference_checkpoint(state_dict, family, boiw=None, reg_max=16):
    """What a reference repo saves for a port model: yolox-drone naming
    as a bare state dict (``family="yolox"``), or mmdet naming wrapped as
    mmcv ``{"meta", "state_dict"}`` with ``integral.project`` and, given
    ``boiw`` (a ``BoIWState``), MPHead's dictionary buffers
    (``family="mpdet"``)."""
    name = yolox_drone_key if family == "yolox" else mmdet_key
    ref = {name(k): v.detach().clone() for k, v in state_dict.items()}
    if family == "yolox":
        return ref
    ref["bbox_head.integral.project"] = torch.linspace(0, reg_max,
                                                       reg_max + 1)
    if boiw is not None:
        ref["bbox_head._embedding"] = boiw.embedding.detach().clone()
        ref["bbox_head._pos_embedding_ptr"] = boiw.ptr.detach().clone()
        ref["bbox_head._proxies_prob"] = boiw.proxies_prob.detach().clone()
    return {"meta": {"epoch": 12, "mmdet_version": "2.x"},
            "state_dict": ref}


def check_digests() -> dict:
    """The card machine's build of encode_jpeg / decode_jpeg against the
    digests the CPU test machine's OpenCV gave (JPEG_*_SHA256)."""
    from glsdet_tpu_torch.data.image_io import decode_jpeg, encode_jpeg

    data = [encode_jpeg(f, JPEG_QUALITY) for f in digest_frames()]
    got = (sha256(data), sha256([decode_jpeg(d) for d in data]))
    if got != (JPEG_BYTES_SHA256, JPEG_PIXELS_SHA256):
        raise AssertionError(f"JPEG digests {got} differ from OpenCV's "
                             f"({JPEG_BYTES_SHA256}, {JPEG_PIXELS_SHA256})")
    return {"frames": len(data), "bytes_sha256": got[0],
            "pixels_sha256": got[1], "equal_to_cpu_opencv": True}


def write_jpeg_split(ds, root) -> dict:
    """The loop dataset's 64 frames as quality-95 JPEGs (encode_jpeg),
    its json pointing at them; INPUT_VAL frames of each size as val
    splits twice, the JPEGs and PNGs of the pixels the port decoded from
    them; encode and decode ms per frame at both sizes (4 frames each,
    one thread), PNG decode beside."""
    from concurrent.futures import ThreadPoolExecutor

    from glsdet_tpu_torch.data.coco import CocoDataset
    from glsdet_tpu_torch.data.image_io import (encode_jpeg, read_image,
                                                write_png)

    with open(ds["ann_file"]) as f:
        coco = json.load(f)
    jdir, pdir = os.path.join(root, "jpeg"), os.path.join(root, "png")
    os.makedirs(jdir)
    os.makedirs(pdir)

    def jpg(name):
        return os.path.splitext(name)[0] + ".jpg"

    def encode(im):
        img = read_image(os.path.join(ds["img_root"], im["file_name"]))
        data = encode_jpeg(img, JPEG_QUALITY)
        with open(os.path.join(jdir, jpg(im["file_name"])), "wb") as f:
            f.write(data)
        return len(data)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(LOOP_WORKERS) as pool:
        sizes = list(pool.map(encode, coco["images"]))
    encode_s = time.perf_counter() - t0
    by_hw = {}
    for im in coco["images"]:
        by_hw.setdefault((im["height"], im["width"]), []).append(im)
    val = [im for ims in by_hw.values() for im in ims[:INPUT_VAL]]

    def to_png(im):
        img = read_image(os.path.join(jdir, jpg(im["file_name"])))
        write_png(os.path.join(pdir, im["file_name"]), img)

    with ThreadPoolExecutor(LOOP_WORKERS) as pool:
        list(pool.map(to_png, val))
    timing = {}
    for (h, w), ims in by_hw.items():
        names = [im["file_name"] for im in ims[:4]]
        row = {}
        for what, fn in (
                ("jpeg_decode_ms", lambda n: read_image(
                    os.path.join(jdir, jpg(n)))),
                ("png_decode_ms", lambda n: read_image(
                    os.path.join(ds["img_root"], n))),
                ("jpeg_encode_ms", lambda n: encode_jpeg(read_image(
                    os.path.join(ds["img_root"], n)), JPEG_QUALITY))):
            t1 = time.perf_counter()
            for n in names:
                fn(n)
            row[what] = 1e3 * (time.perf_counter() - t1) / len(names)
        row["jpeg_encode_ms"] -= row["png_decode_ms"]   # net of the read
        timing[f"{h}x{w}"] = row
    ids = {im["id"] for im in val}
    splits = {}
    for name, img_root, rename in (("jpeg", jdir, jpg),
                                   ("png", pdir, lambda n: n)):
        d = os.path.join(root, f"{name}_val")
        os.makedirs(d)
        ann = os.path.join(d, "val.json")
        with open(ann, "w") as f:
            json.dump(dict(coco, images=[
                dict(im, file_name=rename(im["file_name"])) for im in val],
                annotations=[a for a in coco["annotations"]
                             if a["image_id"] in ids]), f)
        splits[name] = {"ann": ann, "img_root": img_root,
                        "data": CocoDataset(ann, img_root)}
    full = os.path.join(root, "jpeg.json")
    with open(full, "w") as f:
        json.dump(dict(coco, images=[dict(im, file_name=jpg(
            im["file_name"])) for im in coco["images"]]), f)
    return {"train": {"ann_file": full, "img_root": jdir}, "val": splits,
            "val_frames": [im["file_name"] for im in val],
            "line": {"frames": len(sizes), "val_frames": len(val),
                     "quality": JPEG_QUALITY, "bytes_on_disk": sum(sizes),
                     "encode_s_8_threads": encode_s, "per_frame": timing}}


def same_dump(a_path, b_path, what) -> int:
    with open(a_path) as f:
        a = json.load(f)
    with open(b_path) as f:
        b = json.load(f)
    key = lambda d: (d["image_id"], d["category_id"], -d["score"],  # noqa
                     d["bbox"])
    if sorted(a, key=key) != sorted(b, key=key):
        raise AssertionError(f"{what}: the JPEG split's detections differ "
                             "from the PNG split's")
    return len(a)


def inputs_eval(split, root) -> dict:
    """run_eval coarse_det and ufpmp_det_eval (bf16) over the JPEG val
    split and over the PNG split of its decoded pixels: equal detections
    and stats; B2 (and B1 in the two-stage runs) held against their
    plain versions by eval_single / eval_two_stage."""
    from glsdet_tpu_torch.config import get_config

    coarse, mp, paths = eval_models(root)
    del mp
    c_cfg = get_config("coarse_det")
    y16 = coarse.to(DEVICE, torch.bfloat16).eval()
    out = {}
    for name in ("jpeg", "png"):
        sp = split["val"][name]
        d = os.path.dirname(sp["ann"])
        out[f"coarse_{name}"] = eval_single(
            f"coarse_det {name}", sp["data"], y16, "yolox", c_cfg,
            c_cfg.data.batch_size,
            out_json=os.path.join(d, "coarse.json"))
        out[f"ufpmp_{name}"] = eval_two_stage(
            {"img_root": sp["img_root"]}, sp["ann"], paths, False)
    dirs = {n: os.path.dirname(split["val"][n]["ann"])
            for n in ("jpeg", "png")}
    for run, file in (("coarse", "coarse.json"), ("ufpmp", "ufpmp_bf16.json")):
        n = same_dump(os.path.join(dirs["jpeg"], file),
                      os.path.join(dirs["png"], file), run)
        if out[f"{run}_jpeg"]["stats"] != out[f"{run}_png"]["stats"]:
            raise AssertionError(f"{run}: stats differ between the splits")
        out[f"{run}_detections_equal"] = n
    del y16
    torch.cuda.empty_cache()
    return out


def inputs_weights(root, frames) -> tuple:
    """Reference-named checkpoints of the seeded models (yolox-drone for
    coarse_det; mmdet in an mmcv wrapper, with the BoIW buffers and
    integral.project, for mp_det_res50), converted by
    tools/import_torch_weights.py: main; the converted state dicts equal
    to the originals, and TwoStageDetectors from both files giving equal
    detections on ``frames`` (B1 and B2 held against plain).  Returns
    (its line, the converted paths)."""
    from glsdet_tpu_torch.config import get_config
    from glsdet_tpu_torch.tools import import_torch_weights
    from glsdet_tpu_torch.train.boiw import init_boiw

    own = write_seeded_models(root)
    cfg = get_config("mp_det_res50").model
    boiw = init_boiw(torch.Generator().manual_seed(5), cfg.num_classes,
                     cfg.num_words, cfg.feat_channels, cfg.proxies_list,
                     device="cpu")
    out, converted = {}, []
    for path, family, name in ((own[0], "yolox", "coarse_det"),
                               (own[1], "mpdet", "mp_det_res50")):
        sd = torch.load(path, weights_only=True)
        src = os.path.join(root, f"reference_{name}.pth")
        dst = os.path.join(root, f"imported_{name}.pt")
        torch.save(reference_checkpoint(sd, family, boiw=boiw
                                        if family == "mpdet" else None), src)
        t0 = time.perf_counter()
        written, report = import_torch_weights.main(
            [src, dst, "--arch", family, "--config", name])
        seconds = time.perf_counter() - t0
        got = written["model"] if "boiw" in written else written
        if set(got) != set(sd) or not all(torch.equal(got[k], sd[k])
                                          for k in sd):
            raise AssertionError(f"{name}: the imported state dict differs "
                                 "from the original")
        if family == "mpdet" and not all(torch.equal(
                written["boiw"][f], getattr(boiw, f))
                for f in ("embedding", "ptr", "proxies_prob")):
            raise AssertionError("the imported BoIW buffers differ")
        out[name] = {"report": report.summary(), "tensors": len(got),
                     "cli_s": seconds, "equal": True,
                     "boiw": family == "mpdet"}
        converted.append(dst)
    dets, facades = [], []
    with capture_path(False) as cap:
        for paths in (own, converted):
            facade = make_facade(paths)
            facades.append(facade)
            dets.append(facade.detect_batch(frames))
    facades[0].close()
    for a, b in zip(*dets):
        if not all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
                   for k in ("boxes", "scores", "labels")):
            raise AssertionError("the imported weights' detections differ")
    all_captured(cap, "imported facade")
    out["facade"] = {"frames": len(frames), "detections_equal": True,
                     "launches": cap["launches"],
                     "nms": check_nms_calls(cap["nms"], "imported facade"),
                     "paint": check_paint_groups(cap["groups"])}
    return out, facades[1]


def all_captured(cap, what) -> None:
    """Every B2 launch and every B1 group of a captured run is held
    against its plain version: as many captured as launched."""
    n = cap["launches"]
    if (len(cap["nms"]) != n["nms"] or len(cap["groups"]) != n["paint_inputs"]
            or n["nms"] < 1 or n["paint_inputs"] < 1):
        raise AssertionError(f"{what}: launches {n}, captured "
                             f"{len(cap['nms'])} B2 and "
                             f"{len(cap['groups'])} B1")


def check_nms_masks(calls, what) -> dict:
    """Every captured B2 launch's keep mask equal to nms_sorted_plain's;
    the first launch of each shape timed beside its plain version."""
    from glsdet_tpu_torch.ops.nms import nms_sorted_plain

    shapes = {}
    for bx, vd, thr, off, keep in calls:
        if not torch.equal(keep, nms_sorted_plain(bx, vd, thr, off)):
            raise AssertionError(f"{what} NMS {tuple(bx.shape)}: keep mask "
                                 "differs from nms_sorted_plain")
        key = f"{bx.shape[0]}x{bx.shape[1]}"
        if key not in shapes:
            shapes[key] = {"launches": 0, **nms_times(bx, vd, thr, off),
                           **nms_bound(bx, vd, keep)}
        shapes[key]["launches"] += 1
    return {"launches_checked": len(calls), "masks_equal": True,
            "max_abs_err": 0.0, "shapes": shapes}


def outside_frame(served) -> dict:
    """Served boxes that do not overlap the frame, and how many have zero
    area: on the smooth VisDrone-like frames the seeded weights serve
    zero-area chip boxes in regions that overhang the frame, so phase 23
    counts them instead of failing on them."""
    h, w = FRAME_HW
    out = zero = total = 0
    for d in served.values():
        b = d["boxes"]
        off = ~((b[:, 0] < w) & (b[:, 2] > 0) & (b[:, 1] < h) & (b[:, 3] > 0))
        out += int(off.sum())
        zero += int((off & ((b[:, 2] <= b[:, 0]) | (b[:, 3] <= b[:, 1])))
                    .sum())
        total += len(b)
    return {"boxes": total, "outside_frame": out,
            "outside_frame_zero_area": zero}


def served_error(served, direct) -> dict:
    """How far an HTTP answer lies from the direct result: the box
    difference beyond what the JSON's two decimals and the float32 of
    the comparison allow (0.005 plus one float32 step at the coordinate:
    a box corner past 65536 px has steps of 0.0078), and the score
    difference beyond the six decimals' 5e-7."""
    db = np.asarray(direct["boxes"], np.float32)
    ds, dl = np.asarray(direct["scores"]), np.asarray(direct["labels"])
    if len(served["scores"]) != len(ds) or not np.array_equal(
            served["labels"], dl):
        return {"count_or_labels": True}
    slack = 0.0051 + np.spacing(np.abs(db))
    over = np.abs(served["boxes"] - db) - slack
    return {"box_over": float(over.max(initial=-1.0)),
            "largest_coordinate": float(np.abs(db).max(initial=0.0)),
            "score_over": float((np.abs(served["scores"] - ds) - 6e-7)
                                .max(initial=-1.0))}


def jpeg_tagged(frame, rid: int) -> np.ndarray:
    """``frame`` with request id ``rid`` in its top row of TAG_BITS
    grey TAG_BLOCK-pixel blocks (black 0, white 1), which survive JPEG."""
    im = frame.copy()
    for b in range(TAG_BITS):
        im[:TAG_BLOCK, b * TAG_BLOCK:(b + 1) * TAG_BLOCK] = \
            255 if (rid >> b) & 1 else 0
    return im


def jpeg_request_id(image) -> int:
    centre = np.asarray(image[TAG_BLOCK // 2, TAG_BLOCK // 2::TAG_BLOCK]
                        [:TAG_BITS], np.int32).mean(-1)
    return sum(1 << b for b in range(TAG_BITS) if centre[b] > 127)


INPUT_HTTP_REQUESTS = 64    # the raw-JPEG window's requests


def inputs_http(facade, frames, root, json_windows) -> dict:
    """One sustained window of INPUT_HTTP_REQUESTS requests from HTTP_CLIENTS
    clients with raw JPEG bodies (``frames`` tagged with each request's id
    and encoded before the clock starts) to make_server: every answer 200
    and equal to its batch's detect_batch replay on the frames the
    service decoded; B1 and B2 held against plain at every launch."""
    from concurrent.futures import ThreadPoolExecutor

    from glsdet_tpu_torch.data.image_io import encode_jpeg
    from glsdet_tpu_torch.serve import (AsyncDetector, DetectionService,
                                        _decode_image)

    first, n = 1, INPUT_HTTP_REQUESTS
    with ThreadPoolExecutor(LOOP_WORKERS) as pool:
        bodies = list(pool.map(lambda r: encode_jpeg(jpeg_tagged(
            frames[r % len(frames)], r), JPEG_QUALITY),
            range(first, first + n)))
    path = os.path.join(root, "http_bodies.bin")
    with open(path, "wb") as f:
        f.write(b"".join(bodies))
    np.save(path + ".ends.npy", np.cumsum([len(b) for b in bodies]))
    service = DetectionService()
    adet = AsyncDetector(facade, max_batch=SERVE_MAX_BATCH, pipeline_depth=2)
    service.register("glsdet", adet)
    batches = []
    submit = facade.submit_batch
    facade.submit_batch = lambda images: (batches.append(
        [(jpeg_request_id(im), im) for im in images]), submit(images))[1]
    try:
        with capture_path(False) as cap:
            outs, metrics = http_runs(service, "glsdet", None, root,
                                      [(first, n)], path=path)
    finally:
        adet.close()
        del facade.submit_batch
    all_captured(cap, "raw HTTP")
    if 'glsdet_errors_total{model="glsdet"} 0' not in metrics:
        raise AssertionError("/metrics counts errors")
    served, stats = check_answers(outs[0], first, n, facade.score_thr,
                                  in_frame=False)
    ids = sorted(r for b in batches for r, _ in b)
    if ids != sorted(served):
        raise AssertionError(f"the batches held ids {ids[:8]}..., "
                             f"{len(served)} requests were answered")
    large = 0
    for batch in batches:
        direct = facade.detect_batch([im for _, im in batch])
        for (r, _), d in zip(batch, direct):
            if same_as_served(served[r], d):
                continue
            err = served_error(served[r], d)
            if err.get("count_or_labels") or err["box_over"] > 0 \
                    or err["score_over"] > 0:
                raise AssertionError(f"raw request {r}: its answer differs "
                                     f"from its batch's replay: {err}")
            large += 1
    t0 = time.perf_counter()
    for _ in range(5):
        _decode_image(bodies[0])
    decode_ms = 1e3 * (time.perf_counter() - t0) / 5
    sizes = [len(b) for b in batches]
    return {"window": {**stats, "batches": len(batches),
                       "mean_batch": float(np.mean(sizes))},
            "served": outside_frame(served),
            "json_array_windows": json_windows,
            "requests_replayed": len(ids), "batches_replayed": len(batches),
            "answers_with_corners_past_65536": large,
            "request_bytes_mean": float(np.mean([len(b) for b in bodies])),
            "decode_ms_per_request": decode_ms,
            "launches": cap["launches"],
            "nms": check_nms_masks(cap["nms"], "raw HTTP"),
            "paint": check_paint_groups(cap["groups"])}


INPUT_TRAIN_STEPS = 4      # of the JPEG epoch's 8


def inputs_train(split, tmp) -> dict:
    """INPUT_TRAIN_STEPS steps of train(coarse_det) at full width reading
    the JPEG frames."""
    work = os.path.join(tmp, "inputs_train")
    cfg = loop_cfg("coarse_det", split, work, **{
        "train.epochs": 1, "train.warmup_epochs": 1,
        "train.num_last_epochs": 0})
    state, logs, gaps, run = run_train(cfg, max_steps=INPUT_TRAIN_STEPS)
    if state.step != INPUT_TRAIN_STEPS or len(logs) != state.step:
        raise AssertionError(f"train from JPEG: {state.step} steps, "
                             f"{len(logs)} log entries")
    return {"steps": state.step, "host_ms_per_step": float(np.mean(gaps)),
            "loss_last": logs[-1]["loss"], **run}


def phase_inputs(smi: str, ds, tmp: str, json_windows) -> dict:
    """What users bring, at full width (module docstring, phase 23)."""
    from glsdet_tpu_torch.data.image_io import read_image
    from glsdet_tpu_torch.utils.observe import collect_env

    t0 = time.perf_counter()
    root = os.path.join(tmp, "inputs")
    os.makedirs(root)
    out = {"card": smi, "digests": check_digests()}
    split = write_jpeg_split(ds, root)
    out["frames"] = split["line"]
    jdir = split["train"]["img_root"]
    http_frames = [read_image(os.path.join(jdir, os.path.splitext(n)[0]
                                           + ".jpg"))
                   for n in split["val_frames"][:INPUT_VAL]]
    out["weights"], facade = inputs_weights(root, http_frames)
    try:
        out["http_raw_jpeg"] = inputs_http(facade, http_frames, root,
                                           json_windows)
    finally:
        facade.close()
    out["eval"] = inputs_eval(split, root)
    out["train"] = inputs_train(split["train"], tmp)
    out["env"] = collect_env()
    runs = {"facade": out["weights"]["facade"]["launches"],
            "http": out["http_raw_jpeg"]["launches"],
            **{k: v["launches"] for k, v in out["eval"].items()
               if isinstance(v, dict)}}
    out["launches"] = {k: {"nms": v["nms"], "paint_inputs":
                           v["paint_inputs"]} for k, v in runs.items()}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"inputs": out}), flush=True)
    return out


def inputs_checked(inp, kernel) -> int:
    """B2 launches (``kernel="nms"``) or B1 groups (``"paint"``) of the
    inputs phase held against their plain versions."""
    runs = [inp["weights"]["facade"], inp["http_raw_jpeg"],
            *(v for v in inp["eval"].values() if isinstance(v, dict))]
    if kernel == "nms":
        return sum(r["nms"]["launches_checked"] for r in runs)
    return sum(t["groups"] for r in runs for t in r.get("paint", []))


# ---------------------------------------------------------------------------
# 24. variants: the FFA 4-level model and the YOLOX variant zoo

VARIANTS = ("lsk", "evc", "se", "mscam", "nonlocal", "fg_fpn")
F32_TOL = 1e-4       # card vs CPU float32 forward, of each output's max
DYHEAD_TOL = 1e-3    # ... DyHead: its gather taps sit on floor boundaries
BF16_TOL = 0.1       # bf16 vs float32 forward on the card (phase 7's)
FFA_TRAIN_STEPS = 3


def seeded_model(cfg, seed=0):
    """build_model(cfg) on the CPU from ``seed``, float32, its constant
    leaves jittered (jitter_)."""
    from glsdet_tpu_torch.models.build import build_model

    return jitter_(build_model(cfg, device="cpu", generator=torch.Generator(
        ).manual_seed(seed)), seed + 1).eval()


def card_vs_cpu(model, inputs, tol, what, bf16=False) -> dict:
    """``model`` (float32, on the CPU) applied to ``inputs`` on the CPU
    and on the card (TF32 off, as main sets it): the largest error of an
    output over that output's max, within ``tol``; with ``bf16`` also the
    card's bf16 forward against its float32 one, within BF16_TOL."""
    def flat(out):
        if isinstance(out, torch.Tensor):
            return [out]
        return [t for o in out for t in flat(o)]

    def errs(got, ref):
        out = []
        for g, r in zip(flat(got), flat(ref)):
            g, r = g.float().cpu(), r.float().cpu()
            if g.shape != r.shape or not torch.isfinite(g).all():
                raise AssertionError(f"{what}: bad output {tuple(g.shape)}")
            out.append(float((g - r).abs().max() / r.abs().max()))
        return out

    with torch.inference_mode():
        ref = model(*inputs)
        card = copy.deepcopy(model).to(DEVICE)
        dev_in = [t.to(DEVICE) if isinstance(t, torch.Tensor)
                  else [u.to(DEVICE) for u in t] for t in inputs]
        got = card(*dev_in)
        out = {"max_rel_err": max(errs(got, ref)), "tol": tol}
        if out["max_rel_err"] > tol:
            raise AssertionError(f"{what} card vs CPU: {out}")
        if bf16:
            half = card.to(torch.bfloat16)(*[t.to(torch.bfloat16)
                                             for t in dev_in])
            out["bf16_max_rel_err"] = max(errs(half, got))
            out["bf16_tol"] = BF16_TOL
            if out["bf16_max_rel_err"] > BF16_TOL:
                raise AssertionError(f"{what} bf16 vs f32: {out}")
    return out


def ffa_train_steps(cfg) -> dict:
    """FFA_TRAIN_STEPS make_yolox_train_step steps at yolox_ffa's full
    width (strides 4-32, the adam_step recipe, bf16 autocast, VisDrone-like
    batches at max_gt 300) after one warm-up: ms/step, peak memory, then
    one profiled step (launches, busy share)."""
    from glsdet_tpu_torch.train.loop import family_strides
    from glsdet_tpu_torch.train.schedules import ScheduledAdam
    from glsdet_tpu_torch.train.steps import make_yolox_train_step

    hw, b = tuple(cfg.data.img_hw), cfg.data.batch_size
    rs = np.random.RandomState(0)
    batches = [train_batch(rs, b, hw, cfg.data.max_gt, DEVICE,
                           boxes="visdrone") for _ in range(2)]
    state = train_state(cfg, DEVICE)
    if not isinstance(state.optimizer, ScheduledAdam):
        raise AssertionError(f"yolox_ffa optimizer {state.optimizer}")
    step = make_yolox_train_step(state.model, hw,
                                 strides=family_strides("ffa"),
                                 normalize=True, dtype=torch.bfloat16)
    state, _ = step(state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(2 * FFA_TRAIN_STEPS)]
    ms = []
    for i in range(FFA_TRAIN_STEPS):
        ev[2 * i].record()
        state, m = step(state, batches[i % 2])
        ev[2 * i + 1].record()
        ms.append(m)
    torch.cuda.synchronize()
    step_ms = [ev[2 * i].elapsed_time(ev[2 * i + 1])
               for i in range(FFA_TRAIN_STEPS)]
    out = {"steps": FFA_TRAIN_STEPS, "step_ms": step_ms,
           "ms_per_step": sum(step_ms) / FFA_TRAIN_STEPS,
           "img_per_s": b * 1e3 * FFA_TRAIN_STEPS / sum(step_ms),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "gts_per_image": [int(v) for bt in batches
                             for v in bt["gt_valid"].sum(1).cpu()],
           "first": floats(ms[0]), "last": floats(ms[-1])}
    for k in ("first", "last"):
        check_finite("yolox_ffa step", out[k], ("num_fg",))
    out["profile"] = profile_step(lambda: step(state, batches[1]))
    del state, step
    torch.cuda.empty_cache()
    return out


def detector_run(name, path, frames, quant8=False) -> dict:
    """apis.Detector("coarse_det", variant ``name``; "plain": none) from
    the state-dict
    file ``path``, coarse threshold 1e-4: one warm detect_batch of the
    frames, one with B2's launches captured (each keep mask equal to
    nms_sorted_plain's, timed), well formed, then img/s.  Returns that
    summary, the Detector and the captured batch's detections."""
    from glsdet_tpu_torch.apis import Detector

    variant = "" if name == "plain" else name
    det = Detector("coarse_det", path, score_thr=1e-4, quant8=quant8,
                   options={"model.variant": variant}, device=DEVICE)
    det.detect_batch(frames)
    with capture_path() as cap:
        res = det.detect_batch(frames)
    launches = cap["launches"]
    if launches["nms"] < 1 or launches["nms"] != len(cap["nms"]):
        raise AssertionError(f"Detector {name}: B2 launches {launches}, "
                             f"{len(cap['nms'])} captured")
    out = {"detections": check_served(res, len(frames), det.score_thr),
           "launches": launches,
           "nms": check_nms_calls(cap["nms"], f"Detector {name}"),
           "img_per_s": batch_img_per_s(det, frames)}
    return out, det, res


def zoo_modules() -> dict:
    """DyHead (2 stages, 256 channels over levels of 80, 40, 20) and
    BatchFormer (dim 256, batch 8, training mode, dropout 0) on the card
    against the CPU, and BatchFormer's dropout drawn from a card
    generator (the batch doubled, its first half the input)."""
    from glsdet_tpu_torch.models.layers import flax_init_
    from glsdet_tpu_torch.models.variants import BatchFormer, DyHead

    g = torch.Generator().manual_seed(0)
    dy = flax_init_(DyHead(256), g).eval()
    feats = [torch.randn(2, 256, s, s, generator=g) for s in (80, 40, 20)]
    out = {"dyhead": card_vs_cpu(dy, [feats], DYHEAD_TOL, "DyHead")}
    dev = copy.deepcopy(dy).to(DEVICE)
    dev_feats = [f.to(DEVICE) for f in feats]
    with torch.inference_mode():
        out["dyhead"]["ms"] = cuda_ms(lambda: dev(dev_feats))
    bf = flax_init_(BatchFormer(256, dropout=0.0), g).train()
    x = torch.randn(8, 256, generator=g)
    out["batchformer"] = card_vs_cpu(bf, [x], F32_TOL, "BatchFormer")
    drop = flax_init_(BatchFormer(256), g).train().to(DEVICE)
    with torch.inference_mode():
        y = drop(x.to(DEVICE), torch.Generator(DEVICE).manual_seed(0))
    if y.shape != (16, 256) or not torch.equal(y[:8].cpu(), x):
        raise AssertionError(f"BatchFormer dropout: {tuple(y.shape)}")
    return out


def phase_variants(smi: str, ds, tmp: str, frames) -> dict:
    """The variant zoo on the card (module docstring, phase 24)."""
    from glsdet_tpu_torch.config import apply_overrides, get_config
    from glsdet_tpu_torch.ops.quant import DynamicQuantConv2d

    t0 = time.perf_counter()
    out = {"card": smi}
    root = os.path.join(tmp, "variants")
    os.makedirs(root)
    cfg = get_config("yolox_ffa")
    assert (tuple(cfg.data.img_hw), cfg.model.phi, cfg.data.batch_size) == (
        COARSE_HW, PHI, YOLOX_B), cfg
    ffa = seeded_model(cfg)
    x = torch.from_numpy(np.random.RandomState(1).randn(
        2, 3, *COARSE_HW).astype(np.float32))
    out["ffa_forward"] = card_vs_cpu(ffa, [x], F32_TOL, "yolox_ffa",
                                     bf16=True)
    log("variants_ffa_forward", **out["ffa_forward"])
    f16 = copy.deepcopy(ffa).to(DEVICE, torch.bfloat16).eval()
    out["ffa_eval"] = eval_single("yolox_ffa", eval_split(ds, root, "val"),
                                  f16, "ffa", cfg, cfg.data.batch_size)
    del f16
    log("variants_ffa_eval", **{k: v for k, v in out["ffa_eval"].items()
                                if k != "nms"})
    out["ffa_train_step"] = ffa_train_steps(cfg)
    log("variants_ffa_train_step", **out["ffa_train_step"])
    work = os.path.join(root, "train")
    state, logs, gaps, info = run_train(
        loop_cfg("yolox_ffa", ds, work, **{"train.epochs": 1,
                                           "data.num_workers": 0}),
        max_steps=2)
    if state.step != 2 or len(logs) != 2:
        raise AssertionError(f"train(yolox_ffa): {state.step}, {logs}")
    out["ffa_train_loop"] = {"steps": state.step, "logs": logs,
                             "host_gap_ms": gaps, **info}
    del state
    torch.cuda.empty_cache()
    log("variants_ffa_train_loop", **out["ffa_train_loop"])

    out["variants"] = {}
    for i, name in enumerate(("plain",) + VARIANTS):
        vcfg = apply_overrides(get_config("coarse_det"), {
            "model.variant": "" if name == "plain" else name})
        model = seeded_model(vcfg, seed=10 + i)
        path = os.path.join(root, f"{name}.pt")
        torch.save(model.state_dict(), path)
        row = {"forward": card_vs_cpu(model, [x[:1]], F32_TOL, name)}
        summary, det, ref = detector_run(name, path, frames)
        row.update(summary)
        del det
        if name == "lsk":
            q, det, res = detector_run(name, path, frames, quant8=True)
            dilated = sorted(n for n, m in det._net.named_modules()
                             if isinstance(m, DynamicQuantConv2d)
                             and n.endswith("conv_spatial"))
            if dilated != [f"lsk{j}.lsk.conv_spatial" for j in range(3)]:
                raise AssertionError(f"lsk int8: dilated convs {dilated}")
            row["quant8"] = {**q, "dilated_int8": dilated,
                             "matched_share_vs_bf16": matched_share(ref,
                                                                    res)}
            del det
        out["variants"][name] = row
        log(f"variants_{name}", **{k: v for k, v in row.items()
                                   if k not in ("nms", "quant8")},
            nms_per_run=row["nms"]["per_run"])
        del model
        torch.cuda.empty_cache()
    out["modules"] = zoo_modules()
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"variants": out}), flush=True)
    return out


def variants_nms(var) -> dict:
    """B2 in phase 24: launches, shapes and per-run times (eager, plain,
    bound) of yolox_ffa's run_eval and of each variant's Detector."""
    runs = {"yolox_ffa_eval": var["ffa_eval"],
            **{f"{n}_detector": r for n, r in var["variants"].items()},
            "lsk_int8_detector": var["variants"]["lsk"]["quant8"]}
    return {
        "variants_launches": {k: r["launches"]["nms"]
                              for k, r in runs.items()},
        "variants_shapes": {k: [[t["batch"], t["k"]] for t in r["nms"][
            "shapes"]] for k, r in runs.items()},
        "variants_ms": {k: r["nms"]["per_run"]["ms"] for k, r in runs.items()},
        "variants_plain_ms": {k: r["nms"]["per_run"]["plain_ms"]
                              for k, r in runs.items()},
        "variants_bound_ms": {k: r["nms"]["per_run"]["bound_ms"]
                              for k, r in runs.items()},
        "variants_max_abs_err": 0.0}


# ---------------------------------------------------------------------------
# 25. reading the JAX package's orbax checkpoints

ORBAX_FIXTURE = os.path.join("tests", "torch_fixtures", "orbax", "trainstate")
ORBAX_ARCHIVE = os.path.join("tests", "torch_fixtures", "orbax",
                             "two_stage.gtar")
ORBAX_DECODE_S = 0.5         # each of the decoder's timings runs this long
ORBAX_DECODE_CHUNKS = 3      # the largest low-entropy chunks it decodes
ORBAX_WEIGHT_LIKE = 0.5      # compressed / decoded of a weight-like chunk
ORBAX_F32 = {"model.dtype": "float32"}
ORBAX_THR = 1e-4             # the archive's score_thr, and the Detector's
ORBAX_FORWARD_TOL = 1e-3     # float32 on the card vs the CPU, of each max
ORBAX_DETECTOR_SHARE = 0.9   # matched_share of the card's Detector answers
ORBAX_SERVE_FRAMES = 4
# tests/torch_fixtures/make_orbax_fixture.py prints these; the tier-1
# tests/test_torch_orbax.py recomputes them from the JAX restore_raw
ORBAX_FIXTURE_TREE = "00f75f4f00199120bbaa734768a58dd3d541b82e90e0acd1f9c432a90457df8e"
ORBAX_FIXTURE_LEAVES = {
    "/batch_stats/body/bn/mean": "5341e6b2646979a70e57653007a1f310169421ec9bdd9f1a5648f75ade005af1",
    "/batch_stats/body/bn/var": "2f20cd03c9cd392a406c56232b0ff93a15f6d6d7da79086bfa14f55d4a4031b0",
    "/batch_stats/stem/bn/mean": "f5a5fd42d16a20302798ef6ed309979b43003d2320d9f0e8ea9831a92759fb4b",
    "/batch_stats/stem/bn/var": "9628e545ed3ac074e5a6cbf542a642b62482fbfca9b4cb3ea4743a1874256e37",
    "/boiw/beta": "df3f619804a92fdb4057192dc43dd748ea778adc52bc498ce80524c014b81119",
    "/boiw/embedding": "0c5cc90b079d0d9c1ded1376357d23a9782a704a83e01731f50ccd162e246492",
    "/boiw/proxies_prob": "80b8fd6d60fa85fd14a38b5295cb92abd80dfec5ca406c9f969609a79d36809d",
    "/boiw/ptr": "15ec7bf0b50732b49f8228e07d24365338f9e3ab994b00af08e5a3bffe55fd8b",
    "/ema_params/body/bn/bias": "5341e6b2646979a70e57653007a1f310169421ec9bdd9f1a5648f75ade005af1",
    "/ema_params/body/bn/scale": "cd01c78eb615e7d0cabe7b908ebee598832de4309858c312a2c2003219dfe676",
    "/ema_params/body/conv/kernel": "e33b04416ff9d48a08ecb5ac3070be030cf35e117988272a5b9f0910488da300",
    "/ema_params/head/bias": "2c34ce1df23b838c5abf2a7f6437cca3d3067ed509ff25f11df6b11b582b51eb",
    "/ema_params/head/kernel": "294c2cb80abb814c49c3428bf0839767d32cdf9c2bfda3402fc167c4a805e252",
    "/ema_params/scale": "f08458f60ba2c5bb53f087190980a16385970934485c7ba907a9894ad6ae7bcb",
    "/ema_params/stem/bn/bias": "f5a5fd42d16a20302798ef6ed309979b43003d2320d9f0e8ea9831a92759fb4b",
    "/ema_params/stem/bn/scale": "2e54067ff23ae425ce1efe5734b9c3df708356f49a5baa53edca7212fde33dbc",
    "/ema_params/stem/conv/kernel": "f49e6dc1c9c43daad80122930963ce518757d9325e53a52dbd9f6fd351c40400",
    "/opt_state/1/0/trace/body/bn/bias": "5341e6b2646979a70e57653007a1f310169421ec9bdd9f1a5648f75ade005af1",
    "/opt_state/1/0/trace/body/bn/scale": "202780c431c3fcae529f757dfb1d4385428c038892fd6b5c84491e2a9dae6de3",
    "/opt_state/1/0/trace/body/conv/kernel": "b5deb24f54690091737426114b6446f4b553b6b3e31c41444b167f7063325c29",
    "/opt_state/1/0/trace/head/bias": "de47c9b27eb8d300dbb5f2c353e632c393262cf06340c4fa7f1b40c4cbd36f90",
    "/opt_state/1/0/trace/head/kernel": "74bb3d123fc281a7de88ff28e84f0b54e2e66dac702cbcd03a3915ecdadcad7a",
    "/opt_state/1/0/trace/scale": "8a6576d1f83777dafdb4a9c02c9bd9d0efae92234b8fff7516017d6e7d1eec0b",
    "/opt_state/1/0/trace/stem/bn/bias": "f5a5fd42d16a20302798ef6ed309979b43003d2320d9f0e8ea9831a92759fb4b",
    "/opt_state/1/0/trace/stem/bn/scale": "a609376944326008ac63326484985afc703527c28b236aa0500aaf806d5ae35c",
    "/opt_state/1/0/trace/stem/conv/kernel": "955bb1ff6c998f1ad4192928e953c63b4896bac768efd0c2c384e1948c3afefa",
    "/opt_state/1/1/count": "26b25d457597a7b0463f9620f666dd10aa2c4373a505967c7c8d70922a2d6ece",
    "/params/body/bn/bias": "5341e6b2646979a70e57653007a1f310169421ec9bdd9f1a5648f75ade005af1",
    "/params/body/bn/scale": "a66b5da424df7ecb58a69b8976cddc933fb74c3271f6988930eb9e5acbd67e2b",
    "/params/body/conv/kernel": "0287dcb65f7031bb3ed2b9796e63d91551e058c9fd365262625673816a954f08",
    "/params/head/bias": "de47c9b27eb8d300dbb5f2c353e632c393262cf06340c4fa7f1b40c4cbd36f90",
    "/params/head/kernel": "79490d204e6de6ab2e21f887b089f8cf20dede7f4238b6fa891e9890626dd890",
    "/params/scale": "cc7353c4c0021b4527ca0d72caa735570f6b0b070ab821910a290aa7199bae64",
    "/params/stem/bn/bias": "f5a5fd42d16a20302798ef6ed309979b43003d2320d9f0e8ea9831a92759fb4b",
    "/params/stem/bn/scale": "14b629fa43098642bc516b8f52a461336e59e89f51b0317c4f4d8ed261132fb9",
    "/params/stem/conv/kernel": "b807236724d70eba248fa3372ce02014dc6e716f92e2861fa746e07ad978e4e2",
    "/rng": "af5570f5a1810b7af78caf4bc70a660f0df51e42baf91d4de5b2328de0e83dfc",
    "/step": "26b25d457597a7b0463f9620f666dd10aa2c4373a505967c7c8d70922a2d6ece",
}


# make_orbax_fixture.py: archive_digests; [the key/dtype/shape list's
# sha256, the sha256 of the "<path> <leaf sha256>" lines], per stage
ORBAX_ARCHIVE_DIGESTS = {
    "coarse": ["ea98386655ab532895deed1f01c591e33d4c7dca6c918c89dfd994934dd8c669", "932d665d9ec23eeb3ae0308f923372e1fa67c89b10f1246a7e41441fbdc06803"],
    "mp": ["a5bc40051b29b30e16c5fbaa2f928c40165dbf6544a9d1eb58af188eeea24ee4", "0fbcb99f0450470ad3559cd30322de89f5a94998e4107369c263e033344efccb"],
}


def orbax_digests(tree) -> tuple:
    """(sha256 of the tree's key/dtype/shape list, {key path: sha256 of
    the leaf's bytes}) of a ``read_orbax`` tree, bfloat16 leaves by their
    16-bit patterns."""
    lines, leaves = [], {}

    def walk(node, path):
        if isinstance(node, dict):
            lines.append(f"{path} dict")
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
        elif isinstance(node, list):
            lines.append(f"{path} list")
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        elif node is None:
            lines.append(f"{path} None")
        else:
            if torch.is_tensor(node):
                dtype = str(node.dtype).replace("torch.", "")
                data = node.contiguous().view(torch.int16).numpy()
            else:
                dtype, data = node.dtype.name, node
            lines.append(f"{path} {dtype} {tuple(node.shape)}")
            leaves[path] = sha256([data])

    walk(tree, "")
    return sha256(["\n".join(lines).encode()]), leaves


def orbax_tree_digests(tree) -> list:
    """A ``read_orbax`` tree's entry of ORBAX_ARCHIVE_DIGESTS."""
    digest, leaves = orbax_digests(tree)
    lines = "\n".join(f"{k} {v}" for k, v in sorted(leaves.items()))
    return [digest, sha256([lines.encode()])]


class OrbaxFixtureNet(torch.nn.Module):
    """The port's module of the fixture's parameters (flax names: stem and
    body ``conv`` + ``bn``, the Dense ``head``, a 0-d ``scale``)."""

    def __init__(self):
        super().__init__()
        for name, cin, c in (("stem", 3, 16), ("body", 64, 64)):
            block = torch.nn.Module()
            block.conv = torch.nn.Conv2d(cin, c, 3, bias=False)
            block.bn = torch.nn.BatchNorm2d(c)
            setattr(self, name, block)
        self.head = torch.nn.Linear(64, 10)
        self.scale = torch.nn.Parameter(torch.ones(()))


def orbax_leaves(tree, path=""):
    """(key path, leaf) of every array leaf of a ``read_orbax`` tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from orbax_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from orbax_leaves(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


def check_same(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    if got.dtype != want.dtype or not torch.equal(got.cpu(), want):
        raise AssertionError(f"orbax: {what} differs from the CPU's "
                             f"conversion")


def orbax_decode_rate(roots) -> dict:
    """MB of decompressed data a second of the native zstd decoder on
    this machine's host, over the chunks of the OCDBT stores ``roots``:
    the weight-like ones (noise weights: compressed to at least
    ORBAX_WEIGHT_LIKE of their size, 1 KiB or more decoded), and apart
    the ORBAX_DECODE_CHUNKS largest low-entropy ones."""
    from glsdet_tpu_torch.native import zstd_decompress, zstd_decompress_into
    from glsdet_tpu_torch.utils.orbax_read import OcdbtStore

    chunks = []
    for root in roots:
        with OcdbtStore(root) as store:
            chunks += [(len(zstd_decompress(f)), f) for f in (
                store.get(k.decode()) for k in store.keys()
                if not k.endswith(b".zarray"))]
    weights = [(n, f) for n, f in chunks
               if n >= 1024 and len(f) >= ORBAX_WEIGHT_LIKE * n]
    low = sorted((c for c in chunks if c not in weights),
                 key=lambda t: -t[0])[:ORBAX_DECODE_CHUNKS]
    out = {}
    for name, group in (("weights", weights), ("low_entropy", low)):
        if not group:
            raise AssertionError(f"orbax: no {name} chunk to time")
        bufs = [np.empty(n, np.uint8) for n, _ in group]
        reps, total, t0 = 0, 0, time.perf_counter()
        while time.perf_counter() - t0 < ORBAX_DECODE_S:
            for (n, f), buf in zip(group, bufs):
                total += zstd_decompress_into(f, buf)
            reps += 1
        seconds = time.perf_counter() - t0
        out[f"decode_{name}_mb_per_s"] = total / seconds / 1e6
        out[f"decode_{name}_chunk_bytes"] = sum(n for n, _ in group)
        out[f"decode_{name}_compressed_bytes"] = sum(len(f) for _, f in group)
        out[f"decode_{name}_chunks"] = len(group)
        out[f"decode_{name}_reps"] = reps
    return out


def orbax_forward(name: str, ckpt: str, hw: int) -> float:
    """``apis.init_detector(name, checkpoint=ckpt)`` in float32 on the
    card and on the CPU, one input: the largest error of an output map
    over that map's max, within ORBAX_FORWARD_TOL."""
    from glsdet_tpu_torch.apis import init_detector

    x = torch.from_numpy(np.random.RandomState(1).randn(
        1, 3, hw, hw).astype(np.float32))
    outs = []
    for device in (DEVICE, "cpu"):
        _, model, _ = init_detector(name, checkpoint=ckpt, options=ORBAX_F32,
                                    device=device)
        with torch.inference_mode():
            outs.append([t.float().cpu() for maps in model(x.to(device))
                         for t in maps])
        del model
    errs = []
    for g, r in zip(*outs):
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"orbax: {name} bad output {g.shape}")
        errs.append(float((g - r).abs().max() / r.abs().max()))
    if not errs or max(errs) > ORBAX_FORWARD_TOL:
        raise AssertionError(f"orbax: {name} card vs CPU rel err {errs}")
    return max(errs)


def orbax_train_state(ckpt: str) -> int:
    """``train/loop.py: load_weights`` of the stripped ``coarse_det`` into
    its TrainState on the card: every model tensor and the EMA (seeded
    from the parameters: the artifact has none) equal to the conversion
    on the CPU, nothing skipped.  Returns the tensors loaded."""
    from glsdet_tpu_torch.config import get_config
    from glsdet_tpu_torch.models.build import build_model
    from glsdet_tpu_torch.train.loop import (build_optimizer, load_weights,
                                             make_state_template)
    from glsdet_tpu_torch.utils.flax_import import checkpoint_from_flax
    from glsdet_tpu_torch.utils.orbax_read import read_orbax

    cfg = get_config("coarse_det")
    model = build_model(cfg, DEVICE)
    state = make_state_template(cfg, model, build_optimizer(cfg, 1000, model),
                                torch.Generator(device=DEVICE))
    state, n_loaded, skipped = load_weights(ckpt, state)
    want = checkpoint_from_flax(read_orbax(ckpt))["model"]
    sd = model.state_dict()
    if skipped or sorted(sd) != sorted(want):
        raise AssertionError(f"orbax: coarse_det TrainState skipped "
                             f"{skipped[:5]}")
    for k, v in sd.items():
        check_same(v, want[k], f"coarse_det model {k}")
    for k, v in state.ema_params.items():
        check_same(v, want[k], f"coarse_det ema {k}")
    if n_loaded != len(sd) + len(state.ema_params):
        raise AssertionError(f"orbax: {n_loaded} tensors loaded")
    del state, model
    return n_loaded


def orbax_detector(ckpt: str, frames) -> dict:
    """``apis.Detector("coarse_det", ckpt)`` in float32 on the card
    against the same on the CPU, two frames: the card's answers well
    formed, through B2, and matching the CPU's (matched_share >=
    ORBAX_DETECTOR_SHARE)."""
    from glsdet_tpu_torch.apis import Detector

    kw = {"score_thr": ORBAX_THR, "options": ORBAX_F32}
    card = Detector("coarse_det", ckpt, device=DEVICE, **kw)
    card.detect_batch(frames[:2])
    torch.cuda.synchronize()
    reset_launches()
    got = card.detect_batch(frames[:2])
    torch.cuda.synchronize()
    launches = read_launches()
    want = Detector("coarse_det", ckpt, device="cpu", **kw).detect_batch(
        frames[:2])
    n = check_served(got, 2, ORBAX_THR)
    share = matched_share(want, got)
    if launches["nms"] < 1 or n == 0 or share < ORBAX_DETECTOR_SHARE:
        raise AssertionError(f"orbax: Detector launches {launches}, "
                             f"{n} detections, matched {share}")
    return {"launches": launches, "detections": n, "matched_share": share}


def orbax_serve(path: str, frames) -> dict:
    """The JAX two-stage archive registered with the port's
    ``DetectionService`` on the card (``serve.load_archive``, then
    ``TwoStageDetector`` on its two orbax trees) and asked for
    ORBAX_SERVE_FRAMES frames: answers well formed, through B1 and B2."""
    import base64

    from glsdet_tpu_torch.serve import DetectionService

    svc = DetectionService()
    t0 = time.perf_counter()
    name = svc.register_archive(path, device=DEVICE)
    build_s = time.perf_counter() - t0
    det, manifest = svc.models[name]
    try:
        bodies = [json.dumps({"image": base64.b64encode(f.tobytes()).decode(),
                              "shape": list(f.shape), "dtype": "uint8"}
                             ).encode() for f in frames[:ORBAX_SERVE_FRAMES]]
        svc.predict(name, bodies[0])
        torch.cuda.synchronize()
        reset_launches()
        answers = [svc.predict(name, b) for b in bodies]
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        det.close()
    results = [{"boxes": np.array([a["bbox"] for a in ans],
                                  np.float32).reshape(-1, 4),
                "scores": np.array([a["score"] for a in ans], np.float32),
                "labels": np.array([a["class_label"] for a in ans], np.int64)}
               for ans in answers]
    n = check_served(results, len(bodies), manifest["score_thr"])
    if launches["nms"] < 1 or launches["paint"] < 1 or n == 0:
        raise AssertionError(f"orbax: served launches {launches}, {n} "
                             f"detections")
    return {"detector": type(det).__name__, "build_s": build_s,
            "requests": len(bodies), "detections": n, "launches": launches}


def phase_orbax(smi: str, frames) -> dict:
    """The committed JAX checkpoints read, digested, and run on the card
    through the port's entry points (module docstring, phase 25)."""
    from glsdet_tpu_torch import native
    from glsdet_tpu_torch.serve import load_archive
    from glsdet_tpu_torch.train.boiw import BoIWState
    from glsdet_tpu_torch.train.loop import restore_checkpoint
    from glsdet_tpu_torch.train.schedules import yolox_sgd, yolox_warm_cos
    from glsdet_tpu_torch.train.state import TrainState
    from glsdet_tpu_torch.utils.flax_import import checkpoint_from_flax
    from glsdet_tpu_torch.utils.orbax_read import read_orbax

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, ORBAX_FIXTURE)
    t0 = time.perf_counter()
    native.zstd_lib()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree = read_orbax(root)
    read_ms = 1e3 * (time.perf_counter() - t0)
    digest, leaves = orbax_digests(tree)
    if digest != ORBAX_FIXTURE_TREE:
        raise AssertionError(f"orbax: tree digest {digest}")
    bad = sorted(k for k in set(leaves) | set(ORBAX_FIXTURE_LEAVES)
                 if leaves.get(k) != ORBAX_FIXTURE_LEAVES.get(k))
    if bad:
        raise AssertionError(f"orbax: leaves differ from the digests: {bad}")
    # every float leaf to the card and back, bf16 staying bf16
    on_card, bf16 = 0, 0
    for path, leaf in orbax_leaves(tree):
        t = leaf if torch.is_tensor(leaf) else torch.from_numpy(leaf)
        if not t.is_floating_point():
            continue
        dev = t.to(DEVICE)
        if dev.dtype != t.dtype or not torch.equal(dev.cpu(), t):
            raise AssertionError(f"orbax: {path} changed on the card")
        on_card += 1
        bf16 += t.dtype == torch.bfloat16
    if bf16 == 0:
        raise AssertionError("orbax: the fixture has no bfloat16 leaf")
    # the checkpoint into a port TrainState on the card
    want = checkpoint_from_flax(tree)
    model = OrbaxFixtureNet().to(DEVICE)
    opt = yolox_sgd(model.parameters(), yolox_warm_cos(0.01, 10, 100, 10))
    boiw = BoIWState(**{k: torch.zeros_like(v, device=DEVICE)
                        for k, v in want["boiw"].items()})
    state = TrainState.create(model, opt, torch.Generator(
        device=DEVICE).manual_seed(0), boiw=boiw)
    t0 = time.perf_counter()
    state = restore_checkpoint(root, state)
    torch.cuda.synchronize()
    restore_ms = 1e3 * (time.perf_counter() - t0)
    if state.step != want["step"] or opt.count != \
            want["optimizer"]["count"]:
        raise AssertionError(f"orbax: step {state.step}, count {opt.count}")
    for k, v in model.state_dict().items():
        check_same(v, want["model"][k], f"model {k}")
    named = dict(model.named_parameters())
    for k, v in want["ema_params"].items():
        check_same(state.ema_params[k], v, f"ema {k}")
        check_same(opt.state[named[k]]["momentum_buffer"],
                   want["optimizer"]["momentum"][k], f"momentum {k}")
    for k, v in want["boiw"].items():
        check_same(getattr(state.boiw, k), v, f"boiw {k}")
    fixture = {"fixture": ORBAX_FIXTURE, "leaves": len(leaves),
               "float_leaves_on_card": on_card, "bf16_leaves": bf16,
               "read_ms": read_ms, "restore_ms": restore_ms,
               "tensors_loaded": len(want["model"])
               + 2 * len(want["ema_params"]) + len(want["boiw"])}
    del state, model, opt
    # the JAX two-stage archive at full width, through the entry points
    archive = os.path.join(here, ORBAX_ARCHIVE)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _, dirs = load_archive(archive, tmp)
        unpack_ms = 1e3 * (time.perf_counter() - t0)
        stages, reads = {}, {}
        for stage, name, hw in (("coarse", "coarse_det", COARSE_HW[0]),
                                ("mp", "mp_det_res50", 256)):
            t0 = time.perf_counter()
            got = orbax_tree_digests(read_orbax(dirs[stage]))
            reads[stage] = 1e3 * (time.perf_counter() - t0)
            if got != ORBAX_ARCHIVE_DIGESTS[stage]:
                raise AssertionError(f"orbax: archive {stage} digests {got}")
            stages[name] = {"read_ms": reads[stage],
                            "max_rel_err": orbax_forward(name, dirs[stage],
                                                         hw),
                            "input_hw": hw, "tol": ORBAX_FORWARD_TOL}
        stages["coarse_det"]["train_state_tensors"] = orbax_train_state(
            dirs["coarse"])
        detector = orbax_detector(dirs["coarse"], frames)
        rate = orbax_decode_rate([root, dirs["coarse"], dirs["mp"]])
    served = orbax_serve(archive, frames)
    out = {"nvidia_smi": smi,
           "fixture_bytes": sum(os.path.getsize(os.path.join(d, f))
                                for d, _, fs in os.walk(os.path.dirname(root))
                                for f in fs),
           "zstd_build_s": build_s, **fixture, "archive": ORBAX_ARCHIVE,
           "archive_unpack_ms": unpack_ms, "archive_models": stages,
           "detector": detector, "served": served, **rate,
           "seconds": time.perf_counter() - t_phase}
    log("orbax", **out)
    return out

# ---------------------------------------------------------------------------
# 26. workflow: the GLSDet cycle through the port's commands

WORKFLOW_FRAMES = (16, 8)    # train and val frames of the VisDrone layout
WORKFLOW_THR = "1e-05"       # eval.coarse_score_thr of the cycle
WORKFLOW_TEST_IMAGES = 8     # mosaics of tools.test mp_det_res50 --int8-static
WORKFLOW_PREDICT = 4         # val frames of tools.predict dir_predict


def write_visdrone_jpegs(root, n, seed0) -> int:
    """``n`` synthetic VisDrone frames (765x1360, with ignore and "others"
    rows) as quality-95 JPEGs in the stock layout, written on
    LOOP_WORKERS threads; returns the bytes written."""
    from concurrent.futures import ThreadPoolExecutor

    from glsdet_tpu_torch.data.image_io import write_jpeg

    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "annotations"))

    def write(k):
        img, lines = synth_visdrone_pixels(seed0 + k, FRAME_HW)
        with open(os.path.join(root, "annotations", f"{k:05d}.txt"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")
        return write_jpeg(os.path.join(root, "images", f"{k:05d}.jpg"), img)

    with ThreadPoolExecutor(LOOP_WORKERS) as pool:
        return int(sum(pool.map(write, range(n))))


def step_ms(work_dir) -> dict:
    """train()'s logged seconds a step (log_interval 1: host time between
    steps, the loader's waits included), after the first step."""
    times = [r["time"] for r in read_log(work_dir)]
    rest = times[1:] or times
    return {"steps": len(times), "first_step_ms": 1e3 * times[0],
            "median_ms": 1e3 * float(np.median(rest)),
            "mean_ms": 1e3 * float(np.mean(rest))}


def checked_path(cap, what, groups=True, gn=False, nms=None) -> dict:
    """The kernels a captured command launched: their counts, each equal
    to the calls captured (B2's launches, stage-2 groups for B1's path
    entry, B3's calls); every B2 keep mask of ``nms`` (default: all the
    captured calls) against nms_sorted_plain (timed), B1 at every stage-2
    group against mosaic_inputs_plain, B3's captured inputs within +-1
    code."""
    launches = cap["launches"]
    captured = {"nms": len(cap["nms"]), "paint_inputs": cap["stage2_calls"],
                "gn": cap["gn_calls"]}
    if any(launches[k] != n for k, n in captured.items()):
        raise AssertionError(f"{what}: launches {launches}, calls "
                             f"captured {captured}")
    out = {"launches": launches}
    calls = cap["nms"] if nms is None else nms
    if calls:
        out["nms"] = check_nms_calls(calls, what)
    if groups and cap["groups"]:
        out["paint"] = check_paint_groups(cap["groups"])
    if gn:
        out["gn"] = check_gn_captured(cap["gn"])
    return out


def workflow_serve(paths, frame_path, root) -> dict:
    """tools.serve archive (two-stage, the cycle's checkpoints), serve on
    a free port in a thread, client POSTs one val JPEG; the server shut
    down after."""
    import threading

    from glsdet_tpu_torch.tools import serve

    store = os.path.join(root, "store")
    serve.main(["archive", "--config", "coarse_det", "--checkpoint",
                paths[0], "--mp-config", "mp_det_res50", "--mp-checkpoint",
                paths[1], "--output", os.path.join(store, "ufpmp"),
                "--score-thr", "0.0", "--cfg-options",
                f"eval.coarse_score_thr={WORKFLOW_THR}"])
    servers, real = [], serve.make_server

    def capture(service, host, port):
        servers.append(real(service, host, port))
        return servers[-1]

    serve.make_server = capture
    try:
        thread = threading.Thread(target=serve.main, args=([
            "serve", "--model-store", store, "--port", "0", "--device",
            DEVICE],), daemon=True)
        thread.start()
        for _ in range(1200):
            if servers or not thread.is_alive():
                break
            time.sleep(0.1)
    finally:
        serve.make_server = real
    if not servers:
        raise AssertionError("tools.serve did not start")
    try:
        t0 = time.perf_counter()
        dets = serve.main(["client", frame_path, "--url",
                           f"http://127.0.0.1:{servers[0].server_address[1]}",
                           "--repeat", "2"])
        seconds = time.perf_counter() - t0
    finally:
        servers[0].shutdown()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("tools.serve did not stop")
    boxes = np.asarray([d["bbox"] for d in dets], np.float64).reshape(-1, 4)
    if not dets or not np.isfinite(boxes).all():
        raise AssertionError(f"tools.serve client: {len(dets)} answers")
    return {"detections": len(dets), "client_s": seconds}


def coco_to_txt(coco_json, dets_json, root, names) -> tuple:
    """The val ground truth and a COCO results file as get_map's txt
    directories (class name, [score,] x1 y1 x2 y2)."""
    with open(coco_json) as f:
        coco = json.load(f)
    with open(dets_json) as f:
        dets = json.load(f)
    cats = {c["id"]: names[i] for i, c in enumerate(
        sorted(coco["categories"], key=lambda c: c["id"]))}
    gt_dir, det_dir = os.path.join(root, "gt"), os.path.join(root, "det")
    os.makedirs(gt_dir)
    os.makedirs(det_dir)
    stem = {im["id"]: os.path.splitext(im["file_name"])[0]
            for im in coco["images"]}
    rows = {k: [] for k in stem}
    for a in coco["annotations"]:
        x, y, w, h = a["bbox"]
        rows[a["image_id"]].append(f"{cats[a['category_id']]} {x} {y} "
                                   f"{x + w} {y + h}")
    for k, r in rows.items():
        with open(os.path.join(gt_dir, stem[k] + ".txt"), "w") as f:
            f.write("\n".join(r) + "\n")
    drows = {k: [] for k in stem}
    for d in dets:
        x, y, w, h = d["bbox"]
        drows[d["image_id"]].append(f"{cats[d['category_id']]} "
                                    f"{d['score']} {x} {y} {x + w} {y + h}")
    for k, r in drows.items():
        with open(os.path.join(det_dir, stem[k] + ".txt"), "w") as f:
            f.write("\n".join(r) + "\n")
    return gt_dir, det_dir


def phase_workflow(smi: str, tmp: str) -> dict:
    """The GLSDet cycle through the port's commands on the card (module
    docstring, phase 26)."""
    import shutil

    from glsdet_tpu_torch.tools import (build_ufp_dataset, eval_metric,
                                        get_map, merge_results, predict,
                                        test as test_tool, visdrone_e2e)

    t0 = time.perf_counter()
    root = os.path.join(tmp, "workflow")
    train_root, val_root = (os.path.join(root, "train"),
                            os.path.join(root, "val"))
    written = {"train_bytes": write_visdrone_jpegs(train_root,
                                                   WORKFLOW_FRAMES[0], 3000),
               "val_bytes": write_visdrone_jpegs(val_root,
                                                 WORKFLOW_FRAMES[1], 4000),
               "write_s": time.perf_counter() - t0}
    wd = os.path.join(root, "e2e")
    env = {"GLSDET_E2E_COARSE_OPTS":
           f"train.epochs=1 train.log_interval=1 "
           f"eval.coarse_score_thr={WORKFLOW_THR}",
           "GLSDET_E2E_MP_OPTS": "train.epochs=1 train.log_interval=1",
           "GLSDET_E2E_EVAL_OPTS": f"eval.coarse_score_thr={WORKFLOW_THR}"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    build = {}
    real_main = build_ufp_dataset.main

    def build_main(argv):   # the build's share of the cycle's launches
        torch.cuda.synchronize()
        before, first = read_launches(), len(cap["nms"])
        result = real_main(argv)
        torch.cuda.synchronize()
        build["launches"] = {k: n - before[k]
                             for k, n in read_launches().items()}
        build["nms"] = (first, len(cap["nms"]))
        return result

    build_ufp_dataset.main = build_main
    try:
        with capture_path(False) as cap:
            cycle = visdrone_e2e.main([train_root, val_root, wd,
                                       "--device", DEVICE])
    finally:
        build_ufp_dataset.main = real_main
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    ufp = cycle["build_ufp"]["result"]
    res, stats = cycle["eval"]["result"]
    out = {"card": smi, **written,
           "stages_s": {k: cycle[k]["seconds"] for k in
                        ("convert", "train_coarse", "build_ufp", "train_mp",
                         "eval")},
           "cycle_s": cycle["seconds"],
           "frames": cycle["convert"]["result"],
           "ufp": {k: ufp[k] for k in ("frames", "mosaics", "annotations",
                                       "seconds", "frames_per_s")},
           "train_coarse": step_ms(os.path.join(wd, "coarse")),
           "train_mp": step_ms(os.path.join(wd, "mpdet")),
           "eval": {"images": stats["images"],
                    "img_per_s": stats["images_per_sec"],
                    "stats": check_stats(res, "workflow eval")},
           "cycle_kernels": checked_path(
               cap, "workflow cycle", nms=cap["nms"][:build["nms"][0]]
               + cap["nms"][build["nms"][1]:]),
           "build_kernels": {"launches": build["launches"]}}
    # the build's B2 calls are checked and timed apart from the rest
    build_nms = cap["nms"][slice(*build["nms"])]
    if ufp["mosaics"] < 1 or not len(build_nms) \
            == build["launches"]["nms"] == ufp["frames"]:
        raise AssertionError(f"workflow build: {ufp}, {build['launches']}, "
                             f"{len(build_nms)} B2 calls captured")
    out["build_kernels"]["nms"] = check_nms_calls(build_nms,
                                                  "workflow build")
    log("workflow_cycle", since_phase_start_s=time.perf_counter() - t0,
        **{k: out[k] for k in ("stages_s", "ufp", "train_coarse",
                               "train_mp", "eval")})
    paths = (cycle["coarse_ckpt"], cycle["mp_ckpt"])
    thr = ["--cfg-options", f"eval.coarse_score_thr={WORKFLOW_THR}"]

    # the other commands on the cycle's outputs
    with capture_path("static") as cap:
        t1 = time.perf_counter()
        res8, st8 = test_tool.main([
            "mp_det_res50", "--ckpt", paths[1], "--ann",
            os.path.join(wd, "ufp", "ufp_train.json"), "--img-root",
            os.path.join(wd, "ufp", "images"), "--use-ema",
            "--int8-static", "--max-images", str(WORKFLOW_TEST_IMAGES),
            "--device", DEVICE])
        int8_s = time.perf_counter() - t1
    out["test_int8"] = {"seconds": int8_s, "images": st8["images"],
                        "stats": check_stats(res8, "tools.test int8"),
                        **checked_path(cap, "tools.test int8",
                                       groups=False, gn=True)}
    if out["test_int8"]["launches"]["gn"] < 40:
        raise AssertionError(f"tools.test int8: {out['test_int8']}")
    pdir = os.path.join(root, "predict_in")
    os.makedirs(pdir)
    for name in sorted(os.listdir(os.path.join(val_root, "images")))[
            :WORKFLOW_PREDICT]:
        shutil.copy(os.path.join(val_root, "images", name), pdir)
    with capture_path(False) as cap:
        pred = predict.main([
            "dir_predict", pdir, "--output", os.path.join(root, "pred"),
            "--checkpoint", paths[0], "--mp-config", "mp_det_res50",
            "--mp-checkpoint", paths[1], "--draw-thr", "0.0", *thr,
            "--device", DEVICE])
    out["predict"] = {**pred, **checked_path(cap, "tools.predict")}
    if out["predict"]["launches"]["paint_inputs"] < 1:
        raise AssertionError(f"tools.predict: {out['predict']}")
    with capture_path(False) as cap:
        served = workflow_serve(paths, os.path.join(
            pdir, sorted(os.listdir(pdir))[0]), root)
    out["serve"] = {**served, **checked_path(cap, "tools.serve")}
    gjson = os.path.join(root, "global.json")
    with capture_path(False) as cap:
        test_tool.main(["coarse_det", "--ckpt", paths[0], "--use-ema",
                        "--ann", os.path.join(wd, "val.json"),
                        "--img-root", os.path.join(val_root, "images"),
                        "--out", gjson, "--format-only", "--device",
                        DEVICE])
        fused = merge_results.main([gjson, os.path.join(wd, "val_dets.json"),
                                    os.path.join(root, "fused.json"),
                                    "--device", DEVICE])
    out["merge"] = {"detections": len(fused),
                    **checked_path(cap, "tools.merge_results")}
    if not fused:
        raise AssertionError("tools.merge_results: no detections")
    from glsdet_tpu_torch.data.visdrone import VISDRONE_CLASSES

    gt_dir, det_dir = coco_to_txt(os.path.join(wd, "val.json"),
                                  os.path.join(wd, "val_dets.json"),
                                  os.path.join(root, "map"),
                                  VISDRONE_CLASSES)
    voc, coco = get_map.main([gt_dir, det_dir, "--coco"])
    again = eval_metric.main([os.path.join(wd, "val_dets.json"), "--ann",
                              os.path.join(wd, "val.json")])
    out["get_map"] = {"map": voc["map"], "coco_ap": coco.ap,
                      "eval_metric_ap": again.ap}
    out["seconds"] = time.perf_counter() - t0
    out["checkpoints"] = {"coarse": paths[0], "mp": paths[1]}
    out["launches"] = {
        k: sum(v[k] for v in (out["cycle_kernels"]["launches"],
                              out["test_int8"]["launches"],
                              out["predict"]["launches"],
                              out["serve"]["launches"],
                              out["merge"]["launches"]))
        for k in ("nms", "paint_inputs", "gn")}
    print(json.dumps({"workflow": out}), flush=True)
    return out



# ---------------------------------------------------------------------------
# 27. analysis: the analysis and robustness commands


ANALYSIS_ITERS = 10          # timed passes of each benchmark, after 2
ANALYSIS_SEVERITIES = ("5",)
ANALYSIS_SHOW = 3            # images of each drawing command


def command(fn, argv):
    """``fn(argv)`` with its printed lines kept; returns (what it
    returned, its lines, seconds)."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ret = fn([str(a) for a in argv])
    return ret, buf.getvalue().splitlines(), time.perf_counter() - t0


def finite(x):
    """A float for the JSON line: NaN (rPC at a clean AP of 0) as None."""
    return None if x is None or not np.isfinite(x) else float(x)


def cpu_params(name) -> int:
    from glsdet_tpu_torch.config import get_config
    from glsdet_tpu_torch.models.build import build_model

    model = build_model(get_config(name), "cpu")
    return sum(p.numel() for p in model.parameters())


def same_tree(a, b) -> bool:
    if torch.is_tensor(a):
        return torch.is_tensor(b) and torch.equal(a, b)
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(same_tree(a[k], b[k])
                                              for k in a)
    return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))


def analysis_models(root, wf) -> dict:
    """benchmark, get_flops, summary, export and draw_cam (phase 27)."""
    from glsdet_tpu_torch.tools import (benchmark, draw_cam, export,
                                        get_flops, summary)

    out, calls = {}, []
    dev = ["--device", DEVICE]
    runs = {"coarse_det": ["coarse_det", "--batch-size", "8"],
            "mp_det_res50": ["mp_det_res50", "--batch-size", "4"],
            "coarse_det_train": ["coarse_det", "--batch-size", "8",
                                 "--train"]}
    for run, argv in runs.items():
        with capture_path() as cap:
            ret, lines, sec = command(benchmark.main, [
                *argv, "--iters", ANALYSIS_ITERS, "--warmup", 2, *dev])
        want = 0 if run.endswith("train") else ANALYSIS_ITERS + 2
        if cap["launches"]["nms"] != want or len(cap["nms"]) != want:
            raise AssertionError(f"benchmark {run}: {cap['launches']}")
        calls += cap["nms"]
        out[f"benchmark_{run}"] = {**ret, "line": lines[-1], "seconds": sec,
                                   "launches": cap["launches"]["nms"]}
    trace = os.path.join(root, "trace")
    with capture_path() as cap:
        ret, lines, sec = command(benchmark.main, [
            "coarse_det", "--batch-size", "8", "--iters", 3, "--warmup", 1,
            "--trace-dir", trace, *dev])
    with open(os.path.join(trace, "coarse_det.trace.json")) as f:
        events = json.load(f)["traceEvents"]
    # the card's kernels (a CPU rehearsal, DEVICE "cpu", sees host ops)
    kernels = sum(e.get("cat") == ("kernel" if DEVICE == "cuda"
                                   else "cpu_op") for e in events)
    if kernels == 0 or cap["launches"]["nms"] != 4:
        raise AssertionError(f"benchmark --trace-dir: {kernels} kernel "
                             f"events, {cap['launches']}")
    calls += cap["nms"]
    out["benchmark_trace"] = {**ret, "seconds": sec, "launches": 4,
                              "kernel_events": kernels,
                              "bytes": os.path.getsize(os.path.join(
                                  trace, "coarse_det.trace.json"))}
    for name in ("coarse_det", "mp_det_res50"):
        (n, flops), lines, sec = command(get_flops.main, [name, *dev])
        (_, n2, nbytes), slines, ssec = command(summary.main, [name, *dev])
        want = cpu_params(name)
        if not n == n2 == want:
            raise AssertionError(f"{name}: get_flops {n}, summary {n2}, "
                                 f"the CPU model {want} parameters")
        out[f"get_flops_{name}"] = {"params": n, "gflops": flops / 1e9,
                                    "lines": lines, "seconds": sec}
        out[f"summary_{name}"] = {"rows": len(slines) - 3,
                                  "total": slines[-1], "seconds": ssec}
    path = os.path.join(root, "coarse_det.pt2")
    with capture_path() as cap:
        (eager, again), lines, sec = command(export.main, [
            "coarse_det", path, "--with-nms", "--check", *dev])
    if not same_tree(eager, again) or cap["launches"]["nms"] != 2 \
            or len(cap["nms"]) != 2:
        raise AssertionError(f"export: equal {same_tree(eager, again)}, "
                             f"{cap['launches']}, {len(cap['nms'])} captured")
    calls += cap["nms"]
    out["export"] = {"lines": lines, "seconds": sec, "bytes":
                     os.path.getsize(path), "reloaded_equal": True,
                     "launches": 2, "valid": int(eager["valid"].sum())}
    frame_path = os.path.join(root, "val", "images", sorted(os.listdir(
        os.path.join(root, "val", "images")))[0])
    (layer, cam, overlay), lines, sec = command(draw_cam.main, [
        "--config", "coarse_det", "--checkpoint", wf["checkpoints"]["coarse"],
        "--image", frame_path, "--out", os.path.join(root, "cam.jpg"), *dev])
    if not (np.isfinite(cam).all() and overlay.shape[:2] == FRAME_HW):
        raise AssertionError(f"draw_cam: {lines}")
    out["draw_cam"] = {"layer": layer, "cam_hw": list(cam.shape),
                       "seconds": sec}
    return out, calls


def analysis_host(root, wd, val_img) -> dict:
    """The eight host commands on phase 26's outputs (phase 27)."""
    from glsdet_tpu_torch.tools import (analyze_dataset, analyze_logs,
                                        analyze_results, browse_dataset,
                                        coco_error_analysis,
                                        confusion_matrix, draw_bbox,
                                        optimize_anchors)

    ann, dets = os.path.join(wd, "val.json"), os.path.join(wd,
                                                           "val_dets.json")
    log_json = os.path.join(wd, "coarse", "train.log.json")
    a = os.path.join(root, "analysis")
    runs = {
        "optimize_anchors": (optimize_anchors.main, [ann]),
        "analyze_dataset": (analyze_dataset.main, [ann]),
        "analyze_logs_time": (analyze_logs.main, ["cal_train_time",
                                                  log_json]),
        "analyze_logs_plot": (analyze_logs.main, [
            "plot_curve", log_json, "--keys", "loss", "loss_cls", "--out",
            os.path.join(a, "curve.png")]),
        "coco_error_analysis": (coco_error_analysis.main, [
            ann, dets, "--out-dir", os.path.join(a, "errors")]),
        "confusion_matrix": (confusion_matrix.main, [
            ann, dets, "--out", os.path.join(a, "confusion.png")]),
        "draw_bbox": (draw_bbox.main, [
            "--coco", ann, "--img-root", val_img, "--out",
            os.path.join(a, "bbox"), "--max-images", ANALYSIS_SHOW]),
        "browse_dataset": (browse_dataset.main, [
            ann, val_img, os.path.join(a, "browse"), "--num",
            ANALYSIS_SHOW]),
        "analyze_results": (analyze_results.main, [
            dets, "--ann", ann, "--img-root", val_img, "--out-dir",
            os.path.join(a, "results"), "--topk", ANALYSIS_SHOW]),
    }
    os.makedirs(a)
    out = {}
    for name, (fn, argv) in runs.items():
        _, lines, sec = command(fn, argv)
        out[name] = {"last_line": lines[-1] if lines else "",
                     "seconds": sec}
    written = {d: len(os.listdir(os.path.join(a, d)))
               for d in ("errors", "bbox", "browse")}
    if written["bbox"] != ANALYSIS_SHOW or written["browse"] \
            != ANALYSIS_SHOW or not written["errors"] \
            or not os.path.exists(os.path.join(a, "confusion.png")):
        raise AssertionError(f"host commands wrote {written}")
    out["written"] = written
    return out


def phase_analysis(smi: str, tmp: str, wf: dict) -> dict:
    """The analysis and robustness commands on the card (module
    docstring, phase 27), on phase 26's outputs under ``tmp``."""
    from glsdet_tpu_torch.config import get_config
    from glsdet_tpu_torch.data.corruptions import BENCHMARK_CORRUPTIONS
    from glsdet_tpu_torch.tools import test_robustness

    t0 = time.perf_counter()
    root = os.path.join(tmp, "workflow")
    wd, val_img = os.path.join(root, "e2e"), os.path.join(root, "val",
                                                          "images")
    out = {"card": smi}
    models, calls = analysis_models(root, wf)
    out.update(models)
    with capture_path() as cap:
        rob, lines, sec = command(test_robustness.main, [
            "coarse_det", "--ckpt", wf["checkpoints"]["coarse"], "--use-ema",
            "--ann", os.path.join(wd, "val.json"), "--img-root", val_img,
            "--severities", *ANALYSIS_SEVERITIES, "--out",
            os.path.join(root, "robustness.json"), "--device", DEVICE])
    evals = 1 + len(BENCHMARK_CORRUPTIONS) * len(ANALYSIS_SEVERITIES)
    batches = -(-WORKFLOW_FRAMES[1]
                // get_config("coarse_det").data.batch_size)
    cells = [v for row in rob["grid"].values() for v in row]
    if not cap["launches"]["nms"] == evals * batches == len(cap["nms"]) \
            or len(cells) != evals - 1 \
            or not all(0.0 <= v <= 1.0 for v in cells):
        raise AssertionError(f"test_robustness: {cap['launches']}, "
                             f"{len(cap['nms'])} captured, {rob}")
    calls += cap["nms"]
    out["test_robustness"] = {
        "seconds": sec, "evaluations": evals, "launches": evals * batches,
        "clean_ap": rob["clean_ap"], "mPC": finite(rob["mPC"]),
        "rPC": finite(rob["rPC"]), "lines": len(lines)}
    log("analysis_models", since_phase_start_s=time.perf_counter() - t0)
    out["host"] = analysis_host(root, wd, val_img)
    out["nms"] = check_nms_calls(calls, "analysis")
    out["launches"] = {"nms": len(calls)}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"analysis": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# 28. dist: the global-batch step across processes, run_eval(mesh=) and
# the train / test commands across processes


DIST_FAMILIES = {"coarse_det": (YOLOX_B, "visdrone"),    # global batch
                 "mp_det_res50": (TRAIN_B, "bench")}
DIST_SEED = 5
DIST_TIMED = 3               # bf16 steps timed after 1
DIST_LOSS_TOL, DIST_LEAF_TOL = 1e-4, 1e-5
# the dictionary holds raw head features, the float32 activations of ~60
# layers at full width: a 1-rank group against one process (the group
# BatchNorm's summation order the only difference) measured 1.7e-5
DIST_DICT_TOL = 1e-4
# the momentum buffers hold the step's gradient, the only leaves that do
# at step 0 (coarse_det's warmup gives lr 0, MP-Det's 1e-5).  In float32
# a leaf's worst element is the remainder of a cancellation (MP-Det's
# backbone measured 6.9e-2 of its leaf's max, coarse_det's 4.7e-4); a
# gradient off by a factor of 2 (averaged, not summed) reads 0.5 on
# every leaf, so the worst leaf is held to 0.2 and the whole buffer's
# relative L2 distance (measured 5.8e-5 / 4.5e-3) to 2e-2
DIST_MOMENTUM_TOL, DIST_MOMENTUM_NORM_TOL = 0.2, 2e-2
DIST_TRAIN_FRAMES = 16       # dist_launch train: one epoch of 2 steps
DIST_EVAL_FRAMES = 16
DIST_RANK_TIMEOUT_S = 300    # a launch of ranks, all of its work


def dist_step_fn(cfg, model, dtype):
    from glsdet_tpu_torch.train.steps import (make_mpdet_train_step,
                                              make_yolox_train_step)

    if cfg.model.family == "mpdet":
        return make_mpdet_train_step(model, cfg.data.img_hw,
                                     cfg.model.num_classes,
                                     cfg.model.proxies_list, normalize=True,
                                     dtype=dtype)
    return make_yolox_train_step(model, cfg.data.img_hw, normalize=True,
                                 bbox_loss_mode=cfg.train.bbox_loss_mode,
                                 dtype=dtype)


def dist_state(name, root, device):
    """The fixture's train state of ``name`` on ``device``."""
    from glsdet_tpu_torch.config import get_config
    from glsdet_tpu_torch.train.state import load_state_dict

    cfg = get_config(name)
    state = train_state(cfg, device, seed=DIST_SEED)
    load_state_dict(state, torch.load(os.path.join(root, f"{name}_state.pt"),
                                      weights_only=True))
    return cfg, state


def dist_inputs(name, root, device, mesh=None):
    """The fixture's global batch (this rank's rows under ``mesh``) and,
    for MP-Det, the dictionary noise over the global batch."""
    from glsdet_tpu_torch.parallel import shard_batch

    batch = torch.load(os.path.join(root, f"{name}_batch.pt"),
                       weights_only=True)
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    kw = {}
    if name == "mp_det_res50":
        kw["noise"] = torch.load(os.path.join(root, "noise.pt"),
                                 weights_only=True).to(device)
    return {k: v.to(device) for k, v in batch.items()}, kw


def dist_timed(name, root, device, mesh=None) -> dict:
    """bf16 steps of the fixture: 1, then DIST_TIMED between two
    synchronisations (ms a step), peak memory, and the gradient bytes one
    step all-reduces (float32 gradients of every trained parameter)."""
    cfg, state = dist_state(name, root, device)
    step = dist_step_fn(cfg, state.model, torch.bfloat16)
    batch, kw = dist_inputs(name, root, device, mesh)
    state, m = step(state, batch, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(DIST_TIMED):
        state, m = step(state, batch, **kw)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / DIST_TIMED
    m = floats(m)
    check_finite(f"{name} bf16 step", m)
    nbytes = sum(p.numel() * p.element_size() for p in state.model.parameters()
                 if p.requires_grad)
    return {"ms_per_step": ms, "loss": m["loss"],
            "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30,
            "allreduce_bytes_per_step": nbytes,
            # the smoke's own process: one process and the 1-rank group
            "profile": (dist_profile(lambda: step(state, batch, **kw))
                        if mesh is None or mesh.world_size == 1 else None)}


def dist_profile(run) -> dict:
    """profile_step over one more bf16 step, with the host's side too:
    the ops of most self CPU time, and the collectives' calls and host
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    out = profile_summary(prof, wall_ms)
    host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    out["host_self_ms"] = sum(e.self_cpu_time_total for e in host) / 1e3
    out["top_host_ops_ms"] = [
        (e.key, e.self_cpu_time_total / 1e3, e.count) for e in
        sorted(host, key=lambda e: -e.self_cpu_time_total)[:12]]
    coll = [e for e in host if any(w in e.key for w in (
        "all_reduce", "allreduce", "broadcast", "nccl", "gloo"))]
    out["collectives"] = [(e.key, e.cpu_time_total / 1e3, e.count)
                          for e in coll]
    return out


def dist_fixture(root) -> dict:
    """Seeded full-width states (written from the CPU, so that every
    process starts from the same numbers), a global batch of each family
    and MP-Det's dictionary noise; then the one-process float32 step on
    the card from them (the reference the ranks are held to, its leaves
    written for them) and the one-process bf16 timing."""
    from glsdet_tpu_torch.config import get_config
    from glsdet_tpu_torch.train.state import state_dict

    out = {}
    for i, (name, (b, boxes)) in enumerate(DIST_FAMILIES.items()):
        cfg = get_config(name)
        state = train_state(cfg, "cpu", seed=DIST_SEED)
        jitter_bn(state.model, seed=DIST_SEED)
        state.ema_params = {n: p.detach().clone() for n, p in
                            state.model.named_parameters()}
        sd = state_dict(state)
        sd["generator"] = None              # each device draws its own
        torch.save(sd, os.path.join(root, f"{name}_state.pt"))
        hw = tuple(cfg.data.img_hw)
        torch.save(train_batch(np.random.RandomState(10 + i), b, hw,
                               TRAIN_MAX_GT, "cpu", boxes=boxes),
                   os.path.join(root, f"{name}_batch.pt"))
        if name == "mp_det_res50":
            n = sum(-(-hw[0] // s) * -(-hw[1] // s)
                    for s in (8, 16, 32, 64, 128))          # anchors
            torch.save(torch.rand(cfg.model.num_classes + 1, b * n,
                                  generator=torch.Generator().manual_seed(4)),
                       os.path.join(root, "noise.pt"))
        cfg, state = dist_state(name, root, DEVICE)
        step = dist_step_fn(cfg, state.model, torch.float32)
        batch, kw = dist_inputs(name, root, DEVICE)
        state, m = step(state, batch, **kw)
        m = floats(m)
        check_finite(f"{name} float32 step", m)
        torch.save({"metrics": m, "leaves": {
            k: {n: t.detach().cpu() for n, t in v.items()}
            for k, v in state_leaves(state).items()}},
            os.path.join(root, f"{name}_ref.pt"))
        del state, step, batch
        torch.cuda.empty_cache()
        out[name] = {"metrics": m,
                     "one_process_bf16": dist_timed(name, root, DEVICE)}
    return out


def dist_rank_family(name, root, mesh) -> dict:
    """On one rank: the float32 step on its rows against the one-process
    step (check_ranks holds the errors), every leaf against rank 0's
    (broadcast), then the bf16 timing."""
    from glsdet_tpu_torch.parallel import mesh as pmesh

    cfg, state = dist_state(name, root, mesh.device)
    step = dist_step_fn(cfg, state.model, torch.float32)
    batch, kw = dist_inputs(name, root, mesh.device, mesh)
    state, m = step(state, batch, **kw)
    m = floats(m)
    ref = torch.load(os.path.join(root, f"{name}_ref.pt"),
                     weights_only=True)
    leaves = state_leaves(state)
    flat = [t for v in leaves.values() for _, t in sorted(v.items())]
    rank0 = [t.detach().clone() for t in flat]
    pmesh.broadcast_(rank0)
    got = [leaves["momentum"][n].double().cpu() for n in
           sorted(ref["leaves"]["momentum"])]
    want = [ref["leaves"]["momentum"][n].double() for n in
            sorted(ref["leaves"]["momentum"])]
    out = {"metrics": m,
           "loss_rel": max(rel(m[k], ref["metrics"][k]) for k in m),
           "leaves": leaf_errors(leaves, ref["leaves"]),
           "momentum_norm_rel": float(
               sum(((g - w) ** 2).sum() for g, w in zip(got, want)).sqrt()
               / sum((w ** 2).sum() for w in want).sqrt()),
           "max_abs_diff_to_rank0": max(float((a - b).abs().max())
                                        for a, b in zip(flat, rank0))}
    del state, step, batch, leaves, flat, rank0
    torch.cuda.empty_cache()
    out["bf16"] = dist_timed(name, root, mesh.device, mesh)
    return out


def dist_rank_eval(job, mesh) -> dict:
    """run_eval(mesh=) of the jittered YOLOX-s (float32) over the eval
    frames at coarse_det's batch, every B2 launch captured: the stats and
    detections, and each keep mask against nms_sorted_plain."""
    from glsdet_tpu_torch.data.coco import CocoDataset
    from glsdet_tpu_torch.eval.runner import run_eval

    model = dist_eval_model(job["root"], mesh.device)
    ds = CocoDataset(*job["eval_set"])
    with capture_path() as cap:
        res, stats = run_eval(ds, model, "yolox", COARSE_HW, 10,
                              batch_size=YOLOX_B, score_thr=1e-3,
                              mesh=mesh, verbose=False)
    return {"stats": list(map(float, res.stats)),
            "images": stats["images"], "launches": cap["launches"]["nms"],
            "nms": check_nms_calls(cap["nms"], "dist run_eval")}


def dist_eval_model(root, device):
    """The eval phase's jittered YOLOX-s (float32), from its file."""
    from glsdet_tpu_torch.models import YOLOXDetector

    model = YOLOXDetector(10, PHI, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(torch.load(os.path.join(root, "eval_coarse.pt"),
                                     weights_only=True))
    return model.to(device).eval()


def dist_eval_seeded():
    """seeded_models' YOLOX-s (drawn first from its generator, so alone it
    is the same) jittered as the eval phase's."""
    from glsdet_tpu_torch.models import YOLOXDetector

    return jitter_(YOLOXDetector(
        10, PHI, generator=torch.Generator().manual_seed(0)), 7)


def dist_rank(job) -> dict:
    """One rank's work in a joined group: the steps and run_eval(mesh=);
    the group is left at the end."""
    from glsdet_tpu_torch import parallel
    import torch.distributed as dist

    try:
        mesh = parallel.data_mesh()
        return {"rank": mesh.rank, "world_size": mesh.world_size,
                "backend": dist.get_backend(), "device": str(mesh.device),
                **{name: dist_rank_family(name, job["root"], mesh)
                   for name in DIST_FAMILIES},
                "eval": dist_rank_eval(job, mesh)}
    finally:
        parallel.shutdown()


def dist_rank_main() -> None:
    """One rank of a dist phase launch (``GLSDET_*`` set by
    dist_launch_ranks, the job in GLSDET_SMOKE_DIST_JOB): join the group
    on this rank's card, run dist_rank, write its results."""
    from glsdet_tpu_torch import parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.environ["GLSDET_SMOKE_DIST_JOB"]) as f:
        job = json.load(f)
    if not parallel.maybe_init_distributed(device="cuda"):
        raise RuntimeError("no process group configured")
    out = dist_rank(job)
    if "train_argv" in job:
        # the train command in these ranks, in a group of its own
        from glsdet_tpu_torch.tools import train as train_tool

        t0 = time.perf_counter()
        train_tool.main([*job["train_argv"], "--dist-coordinator",
                         f"127.0.0.1:{job['train_port']}",
                         "--dist-num-processes", str(out["world_size"]),
                         "--dist-process-id", str(out["rank"])])
        out["train_command_s"] = time.perf_counter() - t0
    with open(os.path.join(job["root"],
                           f"{job['tag']}_r{out['rank']}.json"), "w") as f:
        json.dump(out, f)


def dist_launch_ranks(job, nproc, backend) -> list:
    """``nproc`` ranks of dist_rank_main (each ``python -c`` importing
    this script), as tools/dist_launch.py starts its commands; any
    rank's failure (or DIST_RANK_TIMEOUT_S passing) raises with its
    output, and no rank outlives the call."""
    from glsdet_tpu_torch.tools.dist_launch import free_port

    path = os.path.join(job["root"], f"{job['tag']}.json")
    with open(path, "w") as f:
        json.dump(job, f)
    env = dict(os.environ, GLSDET_COORDINATOR=f"127.0.0.1:{free_port()}",
               GLSDET_NUM_PROCESSES=str(nproc), GLSDET_DIST_BACKEND=backend,
               GLSDET_SMOKE_DIST_JOB=path,
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(os.path.abspath(__file__)),
                    os.environ.get("PYTHONPATH", "")]))
    procs = []
    try:
        for r in range(nproc):
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "import chip_smoke as cs; cs.dist_rank_main()"],
                env=dict(env, GLSDET_PROCESS_ID=str(r)),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        deadline = time.monotonic() + DIST_RANK_TIMEOUT_S
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                [0] for p in procs]
    finally:
        for p in procs:                 # a rank left behind by a failure
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError(f"dist ranks ({job['tag']}) exited "
                             f"{[p.returncode for p in procs]}:\n" +
                             "\n".join(log[-3000:] for log in logs))
    out = []
    for r in range(nproc):
        with open(os.path.join(job["root"], f"{job['tag']}_r{r}.json")) as f:
            out.append(json.load(f))
    return out


def check_ranks(ranks, one) -> dict:
    """Each rank's float32 steps against the one-process step: losses
    within DIST_LOSS_TOL relative, leaves within DIST_LEAF_TOL of each
    leaf's max (the dictionary DIST_DICT_TOL, the momentum buffers
    DIST_MOMENTUM_TOL and over them all DIST_MOMENTUM_NORM_TOL in L2),
    every leaf equal on every rank; run_eval(mesh=)'s stats within
    EVAL_STATS_TOL of one process's and equal on every rank."""
    for r in ranks:
        for name in DIST_FAMILIES:
            f = r[name]
            tol = {"boiw": DIST_DICT_TOL, "momentum": DIST_MOMENTUM_TOL}
            bad = [k for k, e in f["leaves"].items()
                   if e["max_rel"] > tol.get(k, DIST_LEAF_TOL)]
            if (f["loss_rel"] > DIST_LOSS_TOL or bad
                    or f["momentum_norm_rel"] > DIST_MOMENTUM_NORM_TOL):
                raise AssertionError(f"dist {name} rank {r['rank']} of "
                                     f"{r['world_size']}: {f}")
            if f["max_abs_diff_to_rank0"] != 0.0:
                raise AssertionError(f"dist {name}: rank {r['rank']}'s "
                                     f"state differs from rank 0's: {f}")
        ev = r["eval"]
        if (ev["images"] != DIST_EVAL_FRAMES or max(abs(a - b) for a, b in
                zip(ev["stats"], one["stats"])) > EVAL_STATS_TOL
                or ev["stats"] != ranks[0]["eval"]["stats"]):
            raise AssertionError(f"dist run_eval(mesh=) rank {r['rank']}: "
                                 f"{ev['stats']} against {one['stats']}")
    return {"ranks": ranks}


def dist_train_argv(ds, root) -> list:
    """The train command's arguments for one epoch of 2 steps of
    coarse_det on DIST_TRAIN_FRAMES of the loop frames, which the
    two-rank launch runs after its steps (dist_rank_main)."""
    eval_split(ds, root, "dist_train", DIST_TRAIN_FRAMES)
    return ["coarse_det", "--ann", os.path.join(root, "dist_train.json"),
            "--img-root", ds["img_root"], "--work-dir",
            os.path.join(root, "dist_work"), "--cfg-options",
            "train.epochs=1", "train.num_last_epochs=0",
            "train.log_interval=1", "data.num_workers=0",
            "data.mosaic=False", "data.mixup=False"]


def dist_commands(ds, root, nproc, backend, ranks) -> dict:
    """The two-rank launch's train command (one epoch of 2 steps: rank 0
    alone writes the checkpoint and the log), then tools/dist_launch.py
    test with that checkpoint on the eval frames: its --out, written by
    rank 0, equal to one process's tools.test --out."""
    from glsdet_tpu_torch.tools import dist_launch
    from glsdet_tpu_torch.tools import test as test_tool

    work = os.path.join(root, "dist_work")
    launcher = [] if backend == "nccl" else ["--backend", backend]
    train_s = max(r["train_command_s"] for r in ranks)
    logs = read_log(work)
    if sorted(os.listdir(work)) != ["epoch_1.pt", "train.log.json"] \
            or [e["step"] for e in logs] != [1, 2]:
        raise AssertionError(f"train across {nproc} ranks: "
                             f"{os.listdir(work)}, log {logs}")
    for e in logs:
        check_finite("dist_launch train", {k: v for k, v in e.items()
                                          if k.startswith("loss")})
    ckpt = os.path.join(work, "epoch_1.pt")
    argv = ["coarse_det", "--ckpt", ckpt, "--ann", ds["eval_ann"],
            "--img-root", ds["img_root"], "--cfg-options",
            "model.dtype=float32", "eval.score_thr=0.00001"]
    out = os.path.join(root, "dist_test.json")
    t0 = time.perf_counter()
    rc = dist_launch.main([*launcher, "test", "coarse_det", str(nproc),
                           *argv[1:], "--out", out])
    test_s = time.perf_counter() - t0
    one = os.path.join(root, "one_test.json")
    test_tool.main([*argv, "--out", one])
    with open(out) as f, open(one) as g:
        dets, want = json.load(f), json.load(g)
    if rc != 0 or dets != want or not dets:
        raise AssertionError(f"dist_launch test: rc {rc}, {len(dets)} "
                             f"detections against one process's "
                             f"{len(want)}")
    return {"train_s": train_s, "train_loss": [e["loss"] for e in logs],
            "test_s": test_s, "test_detections": len(dets)}


def phase_dist(smi: str, ds, tmp: str) -> dict:
    """Data parallelism on the card (module docstring, phase 28)."""
    import torch.distributed as dist

    from glsdet_tpu_torch.eval.runner import run_eval

    t0 = time.perf_counter()
    root = os.path.join(tmp, "dist")
    os.makedirs(root)
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    out = {"card": smi, "cards": cards, "two_rank_backend": backend,
           "nccl_available": dist.is_nccl_available()}
    out["one_process"] = dist_fixture(root)
    coarse = dist_eval_seeded()
    torch.save(coarse.state_dict(), os.path.join(root, "eval_coarse.pt"))
    coarse = coarse.to(DEVICE).eval()
    # ground truth from the model's own detections, so that AP is above 0
    dump = os.path.join(root, "dist_self.json")
    run_eval(eval_split(ds, root, "dist_val", DIST_EVAL_FRAMES), coarse,
             "yolox", COARSE_HW, 10, batch_size=YOLOX_B, score_thr=1e-3,
             out_json=dump, format_only=True, verbose=False, device=DEVICE)
    with open(dump) as f:
        val = eval_split(ds, root, "dist_val", DIST_EVAL_FRAMES,
                         anns=self_gt(json.load(f)))
    ds = dict(ds, eval_ann=os.path.join(root, "dist_val.json"))
    one, _ = run_eval(val, coarse, "yolox", COARSE_HW, 10,
                      batch_size=YOLOX_B, score_thr=1e-3, verbose=False,
                      device=DEVICE)
    out["one_process_eval_ap"] = one.ap
    if not one.ap > 0.05:
        raise AssertionError(f"dist eval set: one process's AP {one.ap}")
    job = {"root": root, "eval_set": [ds["eval_ann"], ds["img_root"]]}
    one = {"stats": list(map(float, one.stats))}
    # a group of one over NCCL, joined by this process
    from glsdet_tpu_torch.parallel import init_distributed
    from glsdet_tpu_torch.tools.dist_launch import free_port

    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=DEVICE,
                     backend="nccl")
    out["nccl_1"] = check_ranks([dist_rank(job)], one)
    out["two_ranks"] = check_ranks(dist_launch_ranks(
        dict(job, tag="two", train_argv=dist_train_argv(ds, root),
             train_port=free_port()), 2, backend), one)
    out["commands"] = dist_commands(ds, root, 2, backend,
                                    out["two_ranks"]["ranks"])
    out["launches"] = {"nms": {
        tag: sum(r["eval"]["launches"] for r in out[tag]["ranks"])
        for tag in ("nccl_1", "two_ranks")}}
    for r in (*out["nccl_1"]["ranks"], *out["two_ranks"]["ranks"]):
        ev = r["eval"]
        if ev["launches"] < 1 or ev["launches"] != \
                ev["nms"]["launches_checked"]:
            raise AssertionError(f"dist run_eval rank {r['rank']}: B2 "
                                 f"launched {ev['launches']} times, "
                                 f"{ev['nms']['launches_checked']} checked")
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"dist": out}), flush=True)
    return out


def dist_nms(d) -> dict:
    """B2's dist_* fields of the kernel line: the launches of each
    run_eval(mesh=) run, their eager, plain and bound ms summed over the
    ranks, every keep mask equal to plain's."""
    runs = {tag: [r["eval"]["nms"] for r in d[tag]["ranks"]]
            for tag in ("nccl_1", "two_ranks")}
    return {"dist_launches": d["launches"]["nms"],
            **{f"dist_{k}": {tag: sum(n["per_run"][k] for n in ns)
                             for tag, ns in runs.items()}
               for k in ("ms", "plain_ms", "bound_ms")},
            "dist_max_abs_err": max(n["max_abs_err"] for ns in runs.values()
                                    for n in ns)}


# ---------------------------------------------------------------------------
# 29. data_forms: the augmentations of the data layer's second half, the
#     JPEG forms it reads (progressive, CMYK), and both served at full width
# ---------------------------------------------------------------------------

AUGMENT_HW = (FRAME_HW, (61, 45))
AUGMENT_REPS = 2             # timed runs of each case after its digest run
# sha256 of every augment_cases output on augment_inputs(), as the JAX
# package computes them on the CPU test machine
# (tests/test_torch_autoaugment.py recomputes it)
AUGMENT_SHA256 = ("058d6afb4ccfae14755bd9a714720ea0"
                  "ec403292f14ebde14742e9d2eefcb30c")
JPEG_FORMS_DIR = os.path.join("tests", "torch_fixtures", "jpeg_forms")
# name -> (sha256 of the file, sha256 of the RGB pixels OpenCV reads from
# it: cv2.imread for the file cut short, cv2.imdecode for the others);
# tests/torch_fixtures/make_jpeg_forms.py writes the files and prints
# these, tests/test_torch_jpeg.py recomputes them
JPEG_FORMS = {
    "cmyk_765x1360.jpg": (
        "f2a64e2338281b2d11b514bb5cd81af0be44ef18fd62c323a1eb54cb161fc627",
        "e4972c1714842af82ca06f4b6b46f7fffc07704e1362289d27c70782a26bf08c"),
    "cut_progressive.jpg": (
        "01b2c324dff50f24d60f8cfb1615a5908e815e4713e356d783de79b58c43545a",
        "9116d4c890f45f28cf349af7fc73370f4b203eed1d2a81837b30c20f4165812c"),
    "pil_cmyk_progressive.jpg": (
        "ff5e77b4dfbac1bc14ee3632a447af7c7f2ebf3ac97a748f7d99b410c15f01f5",
        "a2a1c27bfec7b8d69747161de143c6ffa9a5754b9f21943408903feae1e916c7"),
    "pil_optimized.jpg": (
        "15bec2b898253b1a1590a05a14aebcb6c31f44388e6efa09f4f1c8b670bf4764",
        "bbd6f1e90724c499e304fd355000224f86355f98a06c3b5896f35e6a317339d7"),
    "pil_progressive.jpg": (
        "8c2c8f02994145f61faafd331a6748f1e000f65b26ccbbe57c480bb380c847ea",
        "ea639e84f065134b4fec4257c5d8e7a640556cb314f823484515dc8868a59d17"),
    "progressive_444_rst.jpg": (
        "347815e7c55d2990265dcf0d494078ba66ee3d31c2b95a504842c80eb6cfb8ee",
        "bf3e34c4e18054c6bba168faec330c099878a2d84ce603cfa0d00b67f1e4595a"),
    "progressive_765x1360.jpg": (
        "e92fa18b247c0eb86fda06f5b339802e1cb3588ac0509f67f5f1768351ca0239",
        "86c547c54dfde6c1a5efd6422b604857326512bad77a1c62db248c8a4c6b3c36"),
    "progressive_grey.jpg": (
        "b7b1e6d49b1eb838d601b61b9a155b6ef7d33e8637e3ae7c8e43dbc8d9bc4972",
        "30813529b56fd18481e151189ef214a5fa89a5830bc224b2a404793b2b535959"),
}
FORMS_SERVED = ("progressive_765x1360.jpg", "cmyk_765x1360.jpg")
FORMS_PROGRESSIVE_QUALITY = 80   # the full-width progressive fixture's
FORMS_DECODE_REPS = 5


def augment_cases(aug) -> list:
    """(name, fn(img, boxes, labels, rng) -> tuple of arrays) of each
    augmentation of ``aug`` (the port's ``data/augment.py``, or the JAX
    package's where the CPU test recomputes the digest): every op
    applied (``prob=1.0``), ``auto_augment`` once per sub-policy of
    AUTOAUG_POLICIES_V0 with each of its ops applied."""
    def forced(policy):
        return (tuple((n, {**kw, "prob": 1.0}) for n, kw in policy),)

    def crop(im, b, lb, r):
        return aug.random_crop(im, b, lb, r, (im.shape[0] * 3 // 4,
                                              im.shape[1] * 3 // 4))

    cases = [
        ("random_crop", crop),
        ("photometric_distortion",
         lambda im, b, lb, r: (aug.photometric_distortion(im, r),)),
        ("shear_horizontal", lambda im, b, lb, r: aug.shear_aug(
            im, b, lb, r, 6, "horizontal", prob=1.0)),
        ("shear_vertical", lambda im, b, lb, r: aug.shear_aug(
            im, b, lb, r, 6, "vertical", prob=1.0)),
        ("rotate", lambda im, b, lb, r: aug.rotate_aug(
            im, b, lb, r, 8, prob=1.0)),
        ("translate_horizontal", lambda im, b, lb, r: aug.translate_aug(
            im, b, lb, r, 8, "horizontal", prob=1.0)),
        ("translate_vertical", lambda im, b, lb, r: aug.translate_aug(
            im, b, lb, r, 8, "vertical", prob=1.0)),
        ("color", lambda im, b, lb, r: (aug.color_aug(im, r, 6, prob=1.0),)),
        ("brightness",
         lambda im, b, lb, r: (aug.brightness_aug(im, r, 6, prob=1.0),)),
        ("contrast",
         lambda im, b, lb, r: (aug.contrast_aug(im, r, 6, prob=1.0),)),
        ("equalize",
         lambda im, b, lb, r: (aug.equalize_aug(im, r, prob=1.0),)),
    ]
    cases += [(f"auto_augment_{i}", lambda im, b, lb, r, p=p:
               aug.auto_augment(im, b, lb, r, policies=forced(p)))
              for i, p in enumerate(aug.AUTOAUG_POLICIES_V0)]
    return cases


def augment_inputs() -> list:
    """(frame, boxes, labels) at each of AUGMENT_HW, seeded."""
    rs = np.random.RandomState(19)
    out = []
    for h, w in AUGMENT_HW:
        img = rs.randint(0, 256, (h, w, 3), np.uint8)
        x1, y1 = rs.uniform(0, w - 8, 12), rs.uniform(0, h - 8, 12)
        boxes = np.stack([x1, y1, x1 + rs.uniform(2, w / 3, 12),
                          y1 + rs.uniform(2, h / 3, 12)], 1)
        out.append((img, boxes.astype(np.float32),
                    rs.randint(0, 10, 12).astype(np.int32)))
    return out


def augment_digest(aug, times=None) -> str:
    """sha256 of every augment_cases output (dtype, shape and bytes) on
    augment_inputs(), case i drawing from RandomState(i); with ``times``
    (a dict) also each case's host ms on the full frame, the mean of
    AUGMENT_REPS more runs."""
    chunks = []
    for img, boxes, labels in augment_inputs():
        for i, (name, fn) in enumerate(augment_cases(aug)):
            for out in fn(img, boxes, labels, np.random.RandomState(i)):
                out = np.ascontiguousarray(out)
                chunks += [f"{out.dtype}{out.shape}".encode(), out]
            if times is not None and img.shape[:2] == FRAME_HW:
                t0 = time.perf_counter()
                for _ in range(AUGMENT_REPS):
                    fn(img, boxes, labels, np.random.RandomState(i))
                times[name] = 1e3 * (time.perf_counter() - t0) / AUGMENT_REPS
    return sha256(chunks)


def forms_twins() -> dict:
    """rgb_to_gray_u8, equalize_hist_u8 and warp_affine_u8 (the shear,
    rotate and translate matrices, border 128) on card tensors
    torch.equal to the CPU's on the full frame."""
    from glsdet_tpu_torch.ops.image import (equalize_hist_u8, rgb_to_gray_u8,
                                            rotation_matrix_2d,
                                            warp_affine_u8)

    img = torch.from_numpy(augment_inputs()[0][0])
    dev = img.to(DEVICE)
    h, w = FRAME_HW
    checks = {
        "rgb_to_gray_u8": (rgb_to_gray_u8, (), {}),
        "equalize_hist_u8": (lambda x: torch.stack(
            [equalize_hist_u8(x[..., c].contiguous()) for c in range(3)],
            -1), (), {}),
        "warp_shear": (warp_affine_u8, (np.array([[1, 0.18, 0], [0, 1, 0]]),
                                        FRAME_HW), {"border_value": 128}),
        "warp_rotate": (warp_affine_u8, (rotation_matrix_2d(
            (w / 2, h / 2), -24.0, 1.0), FRAME_HW), {"border_value": 128}),
        "warp_translate": (warp_affine_u8, (np.array([[1, 0, 0],
                                                      [0, 1, -200.0]]),
                                            FRAME_HW), {"border_value": 128}),
    }
    out = {}
    for name, (fn, args, kw) in checks.items():
        want = fn(img, *args, **kw)
        got = fn(dev, *args, **kw)
        torch.cuda.synchronize()
        if got.device.type != "cuda" or not torch.equal(got.cpu(), want):
            raise AssertionError(f"{name}: the card's output differs from "
                                 "the CPU's")
        out[name] = {"equal": True, "shape": list(want.shape)}
    return out


def forms_decode() -> dict:
    """The committed fixtures decoded to OpenCV's pixels (JPEG_FORMS); the
    full-width progressive frame's and CMYK frame's decode ms beside the
    baseline decode of the same pixels (the port's encoder, 4:2:0, the
    progressive file's quality).  Returns the decoded frames too."""
    from glsdet_tpu_torch.data.image_io import (decode_jpeg, encode_jpeg,
                                                read_image)

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        JPEG_FORMS_DIR)
    if sorted(os.listdir(root)) != sorted(JPEG_FORMS):
        raise AssertionError(f"{root}: {sorted(os.listdir(root))}")
    files, pixels = {}, {}
    for name, (want_bytes, want_pixels) in JPEG_FORMS.items():
        path = os.path.join(root, name)
        with open(path, "rb") as f:
            data = f.read()
        img = (read_image(path) if name.startswith("cut_")
               else decode_jpeg(data))
        if sha256([data]) != want_bytes or sha256([img]) != want_pixels:
            raise AssertionError(f"{name}: decoded pixels differ from "
                                 "OpenCV's")
        files[name] = data
        pixels[name] = img

    def ms(data):
        t0 = time.perf_counter()
        for _ in range(FORMS_DECODE_REPS):
            decode_jpeg(data)
        return 1e3 * (time.perf_counter() - t0) / FORMS_DECODE_REPS

    prog, cmyk = FORMS_SERVED
    baseline = encode_jpeg(pixels[prog], FORMS_PROGRESSIVE_QUALITY)
    timing = {"progressive_ms": ms(files[prog]),
              "baseline_same_pixels_ms": ms(baseline),
              "cmyk_ms": ms(files[cmyk]),
              "progressive_bytes": len(files[prog]),
              "baseline_bytes": len(baseline),
              "cmyk_bytes": len(files[cmyk])}
    return {"fixtures": len(files), "equal": True, "full_width": timing,
            "bytes_total": sum(len(d) for d in files.values())}, files, \
        pixels


def post_body(base, body):
    import urllib.request

    req = urllib.request.Request(base + "/predictions/glsdet", data=body,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def forms_serve(paths, files, pixels) -> dict:
    """The full-width progressive and CMYK frames as raw bodies to
    make_server over a TwoStageDetector, and the same pixels as JSON
    arrays: answers 200 and equal; every B1 group and B2 launch of the
    requests held against its plain version, the launches counted."""
    import base64
    import threading

    from glsdet_tpu_torch.serve import DetectionService, make_server

    facade = make_facade(paths)
    service = DetectionService()
    service.register("glsdet", facade)
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    out = {}
    try:
        facade.detect_batch([pixels[n] for n in FORMS_SERVED])  # warm
        with capture_path(False) as cap:
            for name in FORMS_SERVED:
                img = pixels[name]
                array = json.dumps({"image": base64.b64encode(
                    img.tobytes()).decode(), "shape": list(img.shape),
                    "dtype": "uint8"}).encode()
                t0 = time.perf_counter()
                raw = post_body(base, files[name])
                raw_ms = 1e3 * (time.perf_counter() - t0)
                arr = post_body(base, array)
                if raw[0] != 200 or arr[0] != 200 or raw[1] != arr[1]:
                    raise AssertionError(f"{name}: the raw body's answer "
                                         "differs from the JSON array's")
                if not raw[1]:
                    raise AssertionError(f"{name}: no detections served")
                out[name] = {"detections": len(raw[1]), "equal": True,
                             "raw_request_ms": raw_ms,
                             "raw_bytes": len(files[name]),
                             "array_bytes": len(array)}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        facade.close()
    all_captured(cap, "data_forms HTTP")
    return {"frames": out, "launches": cap["launches"],
            "nms": check_nms_masks(cap["nms"], "data_forms HTTP"),
            "paint": check_paint_groups(cap["groups"])}


def phase_data_forms(smi: str) -> dict:
    """The rest of the data layer on the card machine (module docstring,
    phase 29)."""
    from glsdet_tpu_torch.data import augment

    t0 = time.perf_counter()
    times = {}
    digest = augment_digest(augment, times)
    if digest != AUGMENT_SHA256:
        raise AssertionError(f"augmentations: sha256 {digest}, the JAX "
                             f"package's {AUGMENT_SHA256}")
    out = {"card": smi, "augment": {"sha256_equal": True,
                                    "host_ms_per_frame": times,
                                    "frame_hw": list(FRAME_HW)},
           "twins": forms_twins()}
    out["decode"], files, pixels = forms_decode()
    with tempfile.TemporaryDirectory() as tmp:
        out["serve"] = forms_serve(write_seeded_models(tmp), files, pixels)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"data_forms": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# 30. video: tools.predict video of a VisDrone-size clip, read and written
#     by the port's MPEG-4 Part 2 codec on the host
# ---------------------------------------------------------------------------

VIDEO_FRAMES = 24
VIDEO_FPS = 25.0
VIDEO_SEED = 30
# sha256 of video_clip(), of the .mp4 and .avi the port's VideoWriter makes
# of it, and of the RGB frames its VideoReader decodes from each (equal):
# as the CPU test machine computes them (tests/test_torch_video.py
# recomputes them, and holds OpenCV's decode of the same files to the
# same frames)
VIDEO_SHA256 = {
    "clip": "658b7dcbe714aab88dfcb9c49494dff7"
            "12d07bc86749dc1fb433ed975921c28b",
    "mp4": "e5c2b6c98d41beedb0ca1631e35ede7d"
           "d74c5d97144a135e79ae8d5796e95673",
    "avi": "17c6a44469a27eeaf029fd615a90630b"
           "5787c49dd19cef598b174a670243cea6",
    "decoded": "ad6cd57eb8e32545b2f732f819249c38"
               "5f56826b86e46ab3046b29fde040a886",
}


def video_clip(h, w, n, seed):
    """tests/torch_tools_util.py: scrolling_clip: a smooth seeded field
    scrolling 2 px right and 1.5 px down a frame under a flat band, a red
    block moving down it (numpy only, the same bytes on every machine)."""
    rs = np.random.RandomState(seed)
    fh, fw = h + 2 * n + 16, w + 2 * n + 16
    coarse = rs.randint(30, 226, (fh // 8 + 2, fw // 8 + 2, 3))
    field = np.kron(coarse, np.ones((8, 8, 1))).astype(np.float64)
    c = np.pad(field, ((1, 0), (1, 0), (0, 0))).cumsum(0).cumsum(1)
    k = 9
    field = (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / k ** 2
    out = []
    for t in range(n):
        f = field[3 * t // 2:3 * t // 2 + h, 2 * t:2 * t + w].copy()
        f[:h // 4] = (150, 170, 200)
        f[8 + t:24 + t, 12:40] = (240, 30, 40)
        out.append(np.clip(f + 0.5, 0, 255).astype(np.uint8))
    return out


def video_host(root) -> dict:
    """The clip written as .mp4 and .avi by VideoWriter and decoded by
    VideoReader: the sha256 of each, the files' paths and sizes, host
    encode and decode ms a frame.  Runs on the host only."""
    from glsdet_tpu_torch.data.video import VideoReader, VideoWriter

    frames = video_clip(*FRAME_HW, VIDEO_FRAMES, VIDEO_SEED)
    out = {"sha256": {"clip": sha256(frames)}, "paths": {}, "bytes": {},
           "encode_ms": {}, "decode_ms": {}}
    decoded = {}
    for ext in ("mp4", "avi"):
        path = os.path.join(root, f"clip.{ext}")
        with VideoWriter(path, VIDEO_FPS, FRAME_HW[::-1]) as w:
            for f in frames:
                w.write(f)
        with VideoReader(path) as r:
            got = list(r)
            meta = (r.frame_count, r.width, r.height, r.fps)
        if meta != (VIDEO_FRAMES, FRAME_HW[1], FRAME_HW[0] & ~1, VIDEO_FPS):
            raise AssertionError(f"video {ext}: read back as {meta}")
        with open(path, "rb") as f:
            out["sha256"][ext] = sha256([f.read()])
        decoded[ext] = sha256(got)
        out["paths"][ext] = path
        out["bytes"][ext] = os.path.getsize(path)
        out["encode_ms"][ext] = 1000 * w.seconds / VIDEO_FRAMES
        out["decode_ms"][ext] = 1000 * r.seconds / len(got)
    if decoded["mp4"] != decoded["avi"]:
        raise AssertionError("video: the .mp4 and .avi decode differently")
    out["sha256"]["decoded"] = decoded["mp4"]
    return out


def predict_video(src, dst, paths, want, what) -> dict:
    """predict.main(["video", src, "--output", dst]) on the card over the
    seeded weights at ``paths``: every B2 keep mask against
    nms_sorted_plain (the first launch of each shape also timed), every
    B1 group against mosaic_inputs_plain, one detect a frame; the output
    read back as ``want`` (frame count, width, height, fps).  Returns
    predict's result, detect's seconds a frame and checked_path's."""
    from glsdet_tpu_torch.apis import TwoStageDetector
    from glsdet_tpu_torch.data.video import VideoReader
    from glsdet_tpu_torch.ops.nms import nms_sorted_plain
    from glsdet_tpu_torch.tools import predict

    detect_s = []
    real = TwoStageDetector.detect

    def timed(self, image):
        t = time.perf_counter()
        res = real(self, image)
        detect_s.append(time.perf_counter() - t)
        return res

    TwoStageDetector.detect = timed
    try:
        with capture_path(False) as cap:
            got = predict.main([
                "video", src, "--output", dst, "--checkpoint", paths[0],
                "--mp-config", "mp_det_res50", "--mp-checkpoint", paths[1],
                "--draw-thr", "0.0", "--cfg-options",
                "eval.coarse_score_thr=1e-4", "--device", DEVICE])
    finally:
        TwoStageDetector.detect = real
    # every B2 keep mask against nms_sorted_plain, the first launch of
    # each shape also timed (timing all of them costs ~10 s in phase 30)
    first, per_shape = {}, {}
    for call in cap["nms"]:
        key = (*call[0].shape[:2], call[2], call[3])
        first.setdefault(key, call)
        per_shape[key] = per_shape.get(key, 0) + 1
        if not torch.equal(call[4], nms_sorted_plain(*call[:4])):
            raise AssertionError(f"{what}: a B2 keep mask differs from "
                                 f"nms_sorted_plain")
    checked = checked_path(cap, what, nms=list(first.values()))
    for row in checked["nms"]["shapes"]:
        row["launches"] = per_shape[(row["batch"], row["k"],
                                     row["threshold"], row["offset"])]
    checked["nms"]["launches_checked"] = len(cap["nms"])
    launches = checked["launches"]
    n = want[0]
    if (got["frames"] != n or len(detect_s) != n or launches["nms"] < n
            or launches["paint_inputs"] < 1):
        raise AssertionError(f"{what}: {got}, {launches}")
    with VideoReader(dst) as r:
        back = list(r)
        meta = (r.frame_count, r.width, r.height, r.fps)
    if meta != want or len(back) != n:
        raise AssertionError(f"{what}: output {meta}, want {want}")
    if not all(np.isfinite(b).all() and b.shape == (want[2], want[1], 3)
               for b in back):
        raise AssertionError(f"{what}: bad output frames")
    return {"got": got, "detect_s": detect_s, "checked": checked}


def phase_video(smi: str) -> dict:
    """tools.predict video on the card (module docstring, phase 30)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        host = video_host(tmp)
        if host["sha256"] != VIDEO_SHA256:
            raise AssertionError(f"video: sha256 {host['sha256']}, the CPU "
                                 f"test machine's {VIDEO_SHA256}")
        paths = write_seeded_models(tmp)
        run = predict_video(
            host["paths"]["mp4"], os.path.join(tmp, "out.mp4"), paths,
            (VIDEO_FRAMES, FRAME_HW[1], FRAME_HW[0] & ~1, VIDEO_FPS),
            "tools.predict video")
    got, detect_s, checked = run["got"], run["detect_s"], run["checked"]
    out = {"card": smi, "frames": VIDEO_FRAMES,
           "frame_hw": [FRAME_HW[0] & ~1, FRAME_HW[1]],
           "sha256_equal": True, "bytes": host["bytes"],
           "host_decode_ms_per_frame": host["decode_ms"],
           "host_encode_ms_per_frame": host["encode_ms"],
           "detect_ms_per_frame": 1000 * float(np.mean(detect_s)),
           "detect_ms_per_frame_after_first": 1000 * float(
               np.mean(detect_s[1:])),
           "frames_per_s": got["fps"], **checked,
           "seconds": time.perf_counter() - t0}
    print(json.dumps({"video": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# 31. h264: tools.predict video of H.264 clips written by
#     tests/h264_stream.py, read by the port's H.264 decoder on the host
# ---------------------------------------------------------------------------

H264_FRAMES = 3
H264_HW = (764, 1360)   # coded as 1360x768 and cropped, as cameras write it
H264_FPS = 25.0
# the writer's Spec fields of each clip
H264_CLIPS = {
    "high_cabac.mp4": dict(profile=100, entropy="cabac", t8=True, refs=2,
                           pcm=0.002, skip=0.6, coded=0.5, seed=31),
    "baseline_cavlc.avi": dict(profile=66, entropy="cavlc", refs=2,
                               pcm=0.002, skip=0.6, coded=0.5, seed=32),
}
# sha256 of each file and of the RGB frames VideoReader decodes from it,
# as the CPU test machine computes them (tests/test_torch_h264.py
# recomputes them and holds OpenCV's decode of the same files to the
# same frames)
H264_SHA256 = {
    "high_cabac.mp4": {
        "file": "627b6b5640ea51cd12097e8619776d28"
                "6831997e2320e60382afc040b305fe34",
        "decoded": "4e863f79fc64bd243847a5dbb6e1f9d9"
                   "920846e8aa149058cba1d8f073cba62d"},
    "baseline_cavlc.avi": {
        "file": "781b95529df52fe03df2cf479955a67e"
                "fd784038491b102e534f581be164d4a6",
        "decoded": "4d22eb08f84e80c16d80dcb1f67ed2a6"
                   "05d4f743773719412f5f9e94c60d24a5"},
}


def h264_writer():
    """tests/h264_stream.py of this checkout (numpy only)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "h264_stream.py")
    mod = sys.modules.get("h264_stream")
    if mod is None or os.path.abspath(mod.__file__) != path:
        spec = importlib.util.spec_from_file_location("h264_stream", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["h264_stream"] = mod  # dataclasses look it up
        spec.loader.exec_module(mod)
    return mod


def h264_host(root) -> dict:
    """Each clip of H264_CLIPS written into ``root`` and decoded by
    VideoReader: the sha256 of each file and of its RGB frames, paths and
    sizes, the writer's seconds and host decode ms a frame (the headers'
    pass at open included; the decoder's g++ build at first use is timed
    apart).  Runs on the host only."""
    from glsdet_tpu_torch.data.video import VideoReader, _get_h264

    hs = h264_writer()
    t = time.perf_counter()
    _get_h264()
    out = {"sha256": {}, "paths": {}, "bytes": {}, "writer_s": {},
           "decode_ms": {}, "build_s": time.perf_counter() - t}
    for name, fields in H264_CLIPS.items():
        path = os.path.join(root, name)
        t = time.perf_counter()
        hs.write_clip(path, hs.Spec(width=H264_HW[1], height=H264_HW[0],
                                    frames=H264_FRAMES, fps=H264_FPS,
                                    **fields))
        out["writer_s"][name] = time.perf_counter() - t
        t = time.perf_counter()
        with VideoReader(path) as r:
            got = list(r)
            meta = (r.frame_count, r.width, r.height, r.fps)
        out["decode_ms"][name] = 1000 * (time.perf_counter() - t) / len(got)
        if meta != (H264_FRAMES, H264_HW[1], H264_HW[0], H264_FPS):
            raise AssertionError(f"h264 {name}: read back as {meta}")
        with open(path, "rb") as f:
            out["sha256"][name] = {"file": sha256([f.read()]),
                                   "decoded": sha256(got)}
        out["paths"][name] = path
        out["bytes"][name] = os.path.getsize(path)
    return out


def phase_h264(smi: str) -> dict:
    """tools.predict video of H.264 clips on the card (module docstring,
    phase 31)."""
    t0 = time.perf_counter()
    clips = {}
    launches = {"nms": 0, "paint_inputs": 0}
    nms_rows, paint_rows = [], []
    with tempfile.TemporaryDirectory() as tmp:
        host = h264_host(tmp)
        if host["sha256"] != H264_SHA256:
            raise AssertionError(f"h264: sha256 {host['sha256']}, the CPU "
                                 f"test machine's {H264_SHA256}")
        paths = write_seeded_models(tmp)
        for name in H264_CLIPS:
            run = predict_video(
                host["paths"][name], os.path.join(tmp, f"out_{name}.mp4"),
                paths, (H264_FRAMES, H264_HW[1], H264_HW[0], H264_FPS),
                f"tools.predict video {name}")
            checked, detect_s = run["checked"], run["detect_s"]
            for k in launches:
                launches[k] += checked["launches"][k]
            nms_rows += checked["nms"]["shapes"]
            paint_rows += checked.get("paint", [])
            clips[name] = {
                "bytes": host["bytes"][name],
                "writer_s": host["writer_s"][name],
                "host_decode_ms_per_frame": host["decode_ms"][name],
                "detect_ms_per_frame": 1000 * float(np.mean(detect_s)),
                "detect_ms_per_frame_after_first": 1000 * float(
                    np.mean(detect_s[1:])),
                "frames_per_s": run["got"]["fps"],
                "launches": checked["launches"]}
    out = {"card": smi, "frames": H264_FRAMES, "frame_hw": list(H264_HW),
           "sha256_equal": True, "decoder_build_s": host["build_s"],
           "clips": clips, "launches": launches,
           "nms": {"shapes": nms_rows}, "paint": paint_rows,
           "seconds": time.perf_counter() - t0}
    print(json.dumps({"h264": out}), flush=True)
    return out


def main() -> None:
    # float32 products of the plain versions stay float32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card()
    phase_build()
    phase_nms()
    phase_nms_ladder()
    gn = phase_gn()
    bottleneck = phase_bottleneck()
    phase_int8_conv()
    rs = np.random.RandomState(0)
    frames = [rs.randint(0, 255, (*FRAME_HW, 3), np.uint8)
              for _ in range(N_FRAMES)]
    dev_frames = torch.from_numpy(np.stack(frames)).to(DEVICE)
    phase_coarse_resize(dev_frames)
    pipe, cpu_refs = build_pipeline()
    try:
        phase_models(pipe, cpu_refs)
        paint = phase_paint(pipe, dev_frames)
        bf16 = phase_pipeline(pipe, frames, dev_frames)
        nms = phase_nms_path(pipe, dev_frames)
        phase_profile(pipe, dev_frames)
        int8 = phase_int8(pipe, frames, dev_frames, bf16)
        fused = phase_fused(pipe, frames, dev_frames, bf16)
    finally:
        pipe.close()
    phase_dynamic(dev_frames)
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_seeded_models(tmp)
        serve = phase_serve(frames, dev_frames, paths)
        ladder = phase_serve_ladder(frames, paths)
        serve8 = phase_serve_int8(frames, paths, serve)
        rep = phase_replicas(frames, paths)
        phase_detector(frames, paths)
    phase_train(smi)
    yolox = phase_train_yolox(smi)
    phase_train_gfl(smi)
    gfl8 = phase_gfl_int8(frames)
    with tempfile.TemporaryDirectory() as tmp:
        _, loop_ds = phase_train_loop(smi, yolox, tmp)
        ev = phase_eval(smi, loop_ds, tmp)
        inp = phase_inputs(smi, loop_ds, tmp, serve["windows"])
        var = phase_variants(smi, loop_ds, tmp, frames)
        dist = phase_dist(smi, loop_ds, tmp)
    phase_orbax(smi, frames)
    with tempfile.TemporaryDirectory() as tmp:
        wf = phase_workflow(smi, tmp)
        an = phase_analysis(smi, tmp, wf)
    forms = phase_data_forms(smi)
    vid = phase_video(smi)
    h264 = phase_h264(smi)
    launches = bf16["launches"]
    eval_nms = {run: ev[run]["nms"] for run in
                ("coarse_det", "mp_det_res50", "tta", "ufpmp_bf16",
                 "ufpmp_int8")}
    sk = serve["kernels"]
    print(json.dumps({"kernels": [
        {"name": "nms_sorted", "route": "cuda",
         "source": "glsdet_tpu_torch/csrc/nms.cu",
         "replaces": "glsdet_tpu/ops/pallas_nms.py:91",
         "launches": launches["nms"], **nms,
         "serve_launches": serve["launches"]["nms"],
         "serve_fusion_ms": sum(t["ms"] for t in sk["fusion_nms"]),
         "serve_fusion_bound_ms": sum(t["bound_ms"]
                                      for t in sk["fusion_nms"]),
         "gfl_int8_launches": gfl8["launches"]["nms"],
         "gfl_int8_shapes": [[t["batch"], t["k"]]
                             for t in gfl8["nms"]["launches"]],
         "gfl_int8_ms": gfl8["nms"]["per_batch"]["ms"],
         "gfl_int8_plain_ms": gfl8["nms"]["per_batch"]["plain_ms"],
         "gfl_int8_bound_ms": gfl8["nms"]["per_batch"]["bound_ms"],
         "gfl_int8_bound_by": gfl8["nms"]["bound_by"],
         "gfl_int8_max_abs_err": gfl8["nms"]["max_abs_err"],
         "eval_launches": {run: ev[run]["launches"]["nms"]
                           for run in eval_nms},
         "eval_shapes": {run: [[t["batch"], t["k"]] for t in r["shapes"]]
                         for run, r in eval_nms.items()},
         "eval_ms": {run: r["per_run"]["ms"] for run, r in eval_nms.items()},
         "eval_graph_ms": {run: r["per_run"]["graph_ms"]
                           for run, r in eval_nms.items()},
         "eval_plain_ms": {run: r["per_run"]["plain_ms"]
                           for run, r in eval_nms.items()},
         "eval_bound_ms": {run: r["per_run"]["bound_ms"]
                           for run, r in eval_nms.items()},
         "eval_max_abs_err": max(r["max_abs_err"]
                                 for r in eval_nms.values()),
         "inputs_launches": {run: n["nms"]
                             for run, n in inp["launches"].items()},
         "inputs_checked": inputs_checked(inp, "nms"),
         "inputs_max_abs_err": 0.0,
         **variants_nms(var),
         "workflow_launches": wf["launches"]["nms"],
         "workflow_build_launches": wf["build_kernels"]["launches"]["nms"],
         "workflow_build_ms": wf["build_kernels"]["nms"]["per_run"]["ms"],
         "workflow_build_plain_ms":
             wf["build_kernels"]["nms"]["per_run"]["plain_ms"],
         "workflow_build_bound_ms":
             wf["build_kernels"]["nms"]["per_run"]["bound_ms"],
         "workflow_max_abs_err": 0.0,
         "analysis_launches": {
             k: v["launches"] for k, v in an.items()
             if isinstance(v, dict) and "launches" in v and k != "nms"},
         "analysis_shapes": [[t["batch"], t["k"]]
                             for t in an["nms"]["shapes"]],
         "analysis_ms": an["nms"]["per_run"]["ms"],
         "analysis_graph_ms": an["nms"]["per_run"]["graph_ms"],
         "analysis_plain_ms": an["nms"]["per_run"]["plain_ms"],
         "analysis_bound_ms": an["nms"]["per_run"]["bound_ms"],
         "analysis_max_abs_err": an["nms"]["max_abs_err"],
         **dist_nms(dist),
         "data_forms_launches": forms["serve"]["launches"]["nms"],
         "data_forms_shapes": forms["serve"]["nms"]["shapes"],
         "data_forms_max_abs_err": 0.0,
         "video_launches": vid["launches"]["nms"],
         "video_shapes": [[t["batch"], t["k"], t["launches"]]
                          for t in vid["nms"]["shapes"]],
         "video_ms": {f"{t['batch']}x{t['k']}": t["ms"]
                      for t in vid["nms"]["shapes"]},
         "video_plain_ms": {f"{t['batch']}x{t['k']}": t["plain_ms"]
                            for t in vid["nms"]["shapes"]},
         "video_bound_ms": {f"{t['batch']}x{t['k']}": t["bound_ms"]
                            for t in vid["nms"]["shapes"]},
         "video_max_abs_err": 0.0,
         "h264_launches": h264["launches"]["nms"],
         "h264_shapes": [[t["batch"], t["k"], t["launches"]]
                         for t in h264["nms"]["shapes"]],
         "h264_ms": [t["ms"] for t in h264["nms"]["shapes"]],
         "h264_plain_ms": [t["plain_ms"] for t in h264["nms"]["shapes"]],
         "h264_bound_ms": [t["bound_ms"] for t in h264["nms"]["shapes"]],
         "h264_max_abs_err": 0.0,
         "replicas_launches_per_card": replica_launches(rep, "nms")},
        {"name": "paint_mosaic", "route": "cuda",
         "source": "glsdet_tpu_torch/csrc/paint.cu",
         "replaces": "glsdet_tpu/ufp/pallas_paint.py:368",
         "launches": launches["paint"], **paint,
         "serve_launches": serve["launches"]["paint"],
         "serve_ms": {f"{t['hw']}x{t['batch']}": t["ms"]
                      for t in sk["paint"] + ladder["kernels"]["paint"]},
         "ufpmp_eval_launches": {
             run: ev[run]["launches"]["paint_inputs"]
             for run in ("ufpmp_bf16", "ufpmp_int8")},
         "ufpmp_eval_ms": {f"{t['hw']}x{t['batch']}": t["ms"]
                           for t in ev["ufpmp_bf16"]["paint"]},
         "ufpmp_eval_plain_ms": {f"{t['hw']}x{t['batch']}": t["plain_ms"]
                                 for t in ev["ufpmp_bf16"]["paint"]},
         "ufpmp_eval_bound_ms": {f"{t['hw']}x{t['batch']}": t["bound_ms"]
                                 for t in ev["ufpmp_bf16"]["paint"]},
         "inputs_launches": {run: n["paint_inputs"]
                             for run, n in inp["launches"].items()},
         "inputs_groups_checked": inputs_checked(inp, "paint"),
         "inputs_max_abs_err": 0.0,
         "workflow_launches": wf["launches"]["paint_inputs"],
         "workflow_eval_ms": {f"{t['hw']}x{t['batch']}": t["ms"]
                              for t in wf["cycle_kernels"]["paint"]},
         "workflow_max_abs_err": 0.0,
         "data_forms_launches": forms["serve"]["launches"]["paint_inputs"],
         "data_forms_ms": {f"{t['hw']}x{t['batch']}": t["ms"]
                           for t in forms["serve"]["paint"]},
         "data_forms_max_abs_err": 0.0,
         "video_launches": vid["launches"]["paint_inputs"],
         "video_ms": {f"{t['hw']}x{t['batch']}": t["ms"]
                      for t in vid.get("paint", [])},
         "video_plain_ms": {f"{t['hw']}x{t['batch']}": t["plain_ms"]
                            for t in vid.get("paint", [])},
         "video_bound_ms": {f"{t['hw']}x{t['batch']}": t["bound_ms"]
                            for t in vid.get("paint", [])},
         "video_max_abs_err": 0.0,
         "h264_launches": h264["launches"]["paint_inputs"],
         "h264_ms": [[t["hw"], t["batch"], t["ms"]] for t in h264["paint"]],
         "h264_plain_ms": [[t["hw"], t["batch"], t["plain_ms"]]
                           for t in h264["paint"]],
         "h264_bound_ms": [[t["hw"], t["batch"], t["bound_ms"]]
                           for t in h264["paint"]],
         "h264_max_abs_err": 0.0,
         "replicas_launches_per_card": replica_launches(rep, "paint")},
        {"name": "gn_relu_quant", "route": "cuda",
         "source": "glsdet_tpu_torch/csrc/gn_quant.cu",
         "replaces": "glsdet_tpu/ops/pallas_gn.py:173",
         "launches": int8["launches"]["gn"], **gn,
         "serve_int8_launches": serve8["launches"]["gn"],
         "serve_int8_ladder_launches": serve8["ladder"]["launches"]["gn"],
         "gfl_int8_launches": gfl8["launches"]["gn"],
         "gfl_int8_ms_40": gfl8["gn_ms_40"],
         "gfl_int8_plain_ms_40": gfl8["gn_plain_ms_40"],
         "gfl_int8_bound_ms_40": gfl8["gn_bound_ms_40"],
         "gfl_int8_max_abs_err": gfl8["gn_max_abs_err"],
         "ufpmp_eval_int8_launches": ev["ufpmp_int8"]["launches"]["gn"],
         "ufpmp_eval_int8_levels": [
             {k: t[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                "max_abs_err")}
             for t in ev["ufpmp_int8"]["gn"]],
         "workflow_launches": wf["launches"]["gn"],
         "workflow_test_int8_levels": [
             {k: t[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                "max_abs_err")}
             for t in wf["test_int8"]["gn"]],
         "replicas_launches_per_card": replica_launches(rep, "gn"),
         "replicas_max_abs_err": rep["int8"]["gn_max_abs_err"]},
        {"name": "fused_bottleneck", "route": "cuda",
         "source": "glsdet_tpu_torch/csrc/bottleneck.cu",
         "replaces": "glsdet_tpu/ops/pallas_bottleneck.py:212",
         "launches": fused["launches"]["bottleneck"], **bottleneck},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
