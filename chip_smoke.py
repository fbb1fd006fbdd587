#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: the page-serving
path with each region-extraction path, the training of the config-#1
recognizer, the training and batched decode of the config-#2 2D-CTC
recognizer, the training and detection evaluation of the config-#4
detector, the training and decodes of the config-#3 attention recognizer,
serving with beam decodes, the CTC prefix beam search, bf16 serving of
the trained detector with mixed-precision training of all four configs,
the entry points (train, eval, page pipeline) on the repo's YAML files,
training configs #1 and #4 from PNG files on disk, config #1 with the
transformer and the other encoder variants, chain (curved-text) serving,
bucketed serving of pages of any size, int8 serving and data-parallel
training and serving over a process group, the deformable (DCN) detector,
the text spotters, JPEG files, an LMDB of crops, resuming a JAX train state,
DB's deformable ResNet-50, the tools and the detector head's formulations.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. setup: print the card's name and power limit, build every CUDA kernel in
   ``megreader_tpu_torch/csrc`` with nvcc (one process per source, in
   parallel), turn TF32 off for the comparisons.
2. ccl: the CUDA connected-components kernel against its plain PyTorch
   version on the card, labels and per-page sweep counts bit-exact, at the
   sweep caps 1, 2, 3, 24 and 64, on: the serving shape 8x640x640 (text-like
   rectangles, a serpentine that hits the cap 24, an empty page); a
   transposed serpentine and 1-px columns joined at alternate ends; unaligned
   641x637 pages; an empty/full pair; batch 1 and batch 32 at 640x640; 2
   pages at 1280x1280; serpentines 2000 px wide and 4200 px tall (rows and
   columns longer than one of the kernel's tiles). Prints each launch's
   grid, blocks per SM and strip width; times the kernel (CUDA events and
   kernel-busy) and the plain version, and computes the kernel's bound for
   this run's masks. Then the multigrid solve (``multigrid_solve``: a launch
   on the 2x2-min-pooled masks, then a launch started from its seeds) on the
   same masks and caps, labels and both levels' sweep counts bit-exact
   against the plain multigrid, and flat against multigrid timed in turns.
3. extract: the three CUDA extraction kernels (candidates, moments, extents)
   against their plain versions on the card at the serving shape (8x640x640
   labels of the CCL kernel with cap 24, K 32, K2 256; text-like rectangles,
   a component rooted at pixel 0, 20% noise with more components than K2,
   rotated bars, an empty page), again at K 20 (K2 rounded to 256 where the
   XLA candidate phase keeps 160), on unaligned 641x637 pages and on two
   2048x2048 pages with page-sized components (one all foreground):
   candidates and selected roots bit-exact; moments' count, first and
   second moments bit-exact to the plain version and across two launches,
   their score sums within rtol 1e-6; extents bit-exact to the plain
   version and across two launches; moments and extents again at K 1024,
   candidates at K2 8192 (bit-exact, two launches equal); then, but for
   the 2048x2048 pages, ``extract_regions`` with ``impl='pallas'`` and
   ``'pallas_full'`` on the card against the same call on the CPU (valid and
   area exact, centre and extents 1e-3 px and angle 1e-5 rad on elongated
   regions). Times each kernel (CUDA events, kernel-busy and the host time
   of a wrapper call), its plain version and the three impls, and computes
   each kernel's bound for these labels.
4. ctc: the CUDA CTC kernels (alpha forward, beta backward) against the plain
   PyTorch version on the card at config #1's training shape (B 64, T 25,
   C 37, labels padded to 32): varied logit lengths, repeated labels, an
   empty label and rows without an alignment (loss and every alpha plane
   rtol 1e-4, gradients rtol 1e-3 against autograd through the plain forward
   and against the plain beta, ``ctc_beta_reference``); two beta launches
   bitwise equal; a label outside [0, C) (NaN on its row only); then long
   labels at T 120 / L 50, T 240 / L 100 and T 1000 / L 500 (up to 32
   columns of states) and 5,000 classes at T 25 (each kernel's instance
   with its emissions, and beta's planes, in shared memory and the one in
   device memory). Times the kernels (CUDA events, kernel-busy time and
   the host time of a wrapper call), the plain version and
   ``torch.nn.functional.ctc_loss``, and computes the kernels' bounds for
   this run's lengths.
5. ctc2d: the CUDA 2D-CTC kernels (alpha forward; beta backward with the
   emission, transition and initial-height gradients) against the plain
   PyTorch version on the card at config #2's shape (B 64, T 25, H 4, C 37,
   labels padded to 32) and the curved A/B shape (T 40, H 6), with the label
   cases of phase 4 (loss rtol 1e-4, gradients rtol 1e-3 against autograd
   through the plain forward and against the plain beta,
   ``ctc2d_beta_reference``); two beta launches bitwise equal; the XLA scan's
   gradient on rows without an alignment. Times the kernels (CUDA events,
   kernel-busy time and the host time of a wrapper call) and the plain
   version, and computes the kernels' bounds for this run's lengths.
6. e2e: the full-width serving path (ResNet-18 det + FPN 256 + head 64;
   ResNet-18 rec + 2x BiLSTM 256, 37 classes) on seeded random weights, 8
   numpy-made pages of 640x640, through ``E2EPipeline.predict``. Checks finite
   outputs and shapes, that the CCL kernel ran once per batch, times each
   stage with CUDA events and its kernel-busy time with ``torch.profiler``
   (and the whole batch's device idle share), and holds every stage of the
   card's path against the same stage on the CPU (plain versions), on two
   128x128 crops and on one full 640x640 page with K = 32 slots. Then one
   batch each with ``extract_impl='pallas'`` and ``'pallas_full'``: one
   launch of each extraction kernel the impl runs, valid slots equal to the
   'xla' batch's and quads within 1e-2 px of them; the extract stage's
   times and pages/s for the three impls.
7. train: config #1 at full width (ResNet-18 rec + 2x BiLSTM 256, 37
   classes, batch 64, Adam at lr 1e-3 with 200 warm-up steps of a 20 000-step
   cosine) through ``Experiment``/``Trainer`` on a numpy-made dataset of 4
   batches for 24 steps: finite, falling losses, one launch of each CTC
   kernel per step, a checkpoint that resumes at its step. Then one step's
   loss and gradients through the kernels against the plain loss, and the
   time of a step split into prepare, forward, CTC forward, backward and
   optimizer (CUDA events), with the device idle share (``torch.profiler``).
8. train2d: config #2 with Markov heights at full width (ResNet-18 rec2d,
   37 classes, batch 64 of 32x100 crops, the optimizer of phase 7) through
   ``Experiment``/``Trainer`` for 24 steps: finite, falling losses, one
   launch of each 2D-CTC kernel per step and none of the 1-D ones, one
   validation through ``evaluate_recognition``, a checkpoint that resumes.
   Then 4 steps with independent heights, which launch the 1-D CTC kernels
   once per step; one Markov step's loss and gradients through the kernels
   against the plain loss; the step split into prepare, forward, loss,
   backward and optimizer, and the device idle share.
9. decode2d: config #2's batched decode of 64 crops through
   ``RecognizerPredictor``, greedy (independent heights) and Viterbi (Markov
   heights), with ids equal to the same weights' on the CPU; then one
   ``E2EPipeline`` batch of 8 pages with the Markov recognizer.
10. traindet: config #4 at full width (ResNet-18 det + FPN 256 + heads 64,
    k 50, batch 8 of 640x640, SGD lr 0.007 momentum 0.9 decay 1e-4, ``poly``
    over 20 000 steps, GT maps rasterized on the card, polygon buffers of 16)
    through ``Experiment``/``Trainer`` on numpy-made pages with exact quads
    for 24 steps: finite, falling losses, one validation through
    ``evaluate_detection`` on 16 pages (finite P/R/H), a checkpoint that
    resumes. Then ``make_detection_gt`` on the card against the CPU, and the
    step split into prepare (GT maps), forward, loss, backward and
    optimizer, with the device idle share.

11. attention: config #3 at full width (ResNet-18 rec2d of width 64, dim
    256, max_len 32, 39 classes, batch 64 of 32x100 crops, the optimizer of
    phase 7) through ``Experiment``/``Trainer`` for 24 steps: finite,
    falling losses, one validation, a checkpoint that resumes. Then one
    train-mode loss and the teacher-forced logits on the card against the
    CPU (rtol 1e-4 of the logits' largest magnitude, atol 1e-5); the step
    split (prepare, encode, decoder loop, loss, backward, optimizer) and the
    device idle share. On fresh seeded weights shaped so that the decodes
    depend on the crop: beam W 1 equal to greedy bit for bit, the greedy
    and beam (W 5) ids of 64 crops equal to the CPU's on every row that the
    CPU decides by a margin over 1e-3 (the other rows are counted), and the
    decodes' crops/s.
12. serving: one batch of 8 640x640 pages with the config-#1 recognizer
    under ``rec_mode='beam'``, then with the config-#3 recognizer greedy and
    beam, each held to the CPU on one page (``cross_check``: a CTC beam on
    the CPU's logits gives equal ids on both devices; the attention ids
    equal on the clear-margin crops), with its per-stage ms and pages/s.
13. beam: ``ctc_beam_decode`` at ``scripts/bench_beam.py``'s shape and
    logits (B 256, T 50, C 37, W 8) with ``blank_collapse`` 1.0 and 0.999:
    ids and lengths equal to the CPU's on every row; its times.
14. bf16: the trained detector read from ``assets/bench_det_fp16.msgpack``
    by the port's own msgpack decoder (step, leaves, decode time), served
    with the config-#1 recognizer (seeded) on 8 ``TextPages`` of 640x640
    (seed 5): one float32 batch (``extract_impl='xla'``) and two
    ``bf16=True`` batches (``'xla'``, ``'pallas_full'``), each with its
    kernel launches, valid regions per page against the words drawn (at
    least one each), CCL sweeps per page, busy ms per stage and pages/s by
    events; the float32 and the bf16 pipelines held to the CPU on 1 page
    (``serving_cross_check``). Then configs #1, #2 (Markov heights), #3 and
    #4 with ``compute_dtype='bfloat16'`` through ``Experiment``/``Trainer``
    for 12 steps each (config #4 with ``bench.py``'s Adam 3e-4, the recipe
    that trained the asset): the first batch's loss within rtol 0.05 of the float32
    model's on the same weights, finite falling losses, float32 parameters
    and optimizer state, the CTC and 2D-CTC kernels launched once a step;
    ms a step, busy and idle share. Every kernel must launch on these bf16
    paths (``launches_bf16`` in the kernels line).

15. cli: the entry points on the repo's YAML files at full width, the
    numpy datasets (``WordCrops``, ``TextPages``, registered in the port's
    registry) put in through dotted overrides, each entry point's kernel
    launches counted from 0: ``cli.train`` of
    ``experiments/ctc_resnet18_synth.yaml`` for 8 steps and 4 more after a
    resume (one CTC alpha and beta launch a step; the first step's loss
    equal to the same run's built in Python, and both runs' host seconds a
    step), of ``ctc2d_resnet18_synth.yaml`` with Markov heights for 4 steps
    (the 2D-CTC kernels only); ``cli.eval`` greedy and beam of both
    workspaces (one JSON line each); the trained detector of the asset in a
    port checkpoint, ``cli.eval`` of ``seg_detector_synth.yaml`` on 8
    ``TextPages`` (recall above 0); ``cli.pipeline`` on 8 pages written as
    PNG with ``--rectify`` perspective, deskew and box and with
    ``--extract-impl pallas_full``: the polygons identical across the
    rectify modes (within 1e-2 px under ``'pallas_full'``), equal to a
    direct ``E2EPipeline.predict`` (strings equal, polygons within 1e-3 px),
    and on 1 page to the same entry point on the CPU. Then the trained
    detector's masks: multigrid labels equal to flat, CCL flat against
    multigrid, serving pages/s with flat and multigrid CCL, deskew and box in
    turns, and ``rotate_crops`` of 256 smooth crops on the card against
    float64 on the CPU, within twice the CPU's own float32 distance from
    float64 (at least 1e-3 on 0-255 values; float32 alone lies about 1.2e-3
    from float64 there). Every kernel must launch through the entry points
    (``launches_cli`` in the kernels line).

16. data: training from files on disk, as the disk YAML files read them.
    256 ``WordCrops`` crops in a list file and 32 + 8 ``TextPages`` pages of
    640x640 in an ICDAR dir pair (one ``###`` line a page), written as PNG
    (Sub rows), and 8 pages more with Paeth rows. The PNG decode of a page
    (Sub against Paeth) and the loaders alone on the host (config #1's
    train loader, the Sub, Paeth and augmented pages; processes against
    threads: seconds to the first batch, which pays the process pool's
    start, and items/s), their batches equal bit for bit across the two
    kinds of workers. ``cli.train experiments/ctc_listfile_disk.yaml``
    (config #1 at full width: batch 64, bf16 mixed precision, device
    augmentation) for 8 steps with process workers and 4 more after a
    resume, and 8 with threads: one CTC alpha and beta launch a step, the
    first step's loss equal across the two runs. ms a step by CUDA events and
    on the host clock with augment on and off, threads and processes; 4
    mini-steps with ``accumulate_steps`` 2 (constant rate): the weights
    still at mini-steps 1 and 3 and moved at 2 and 4, the BatchNorm
    statistics moved at each. ``augment_resize_apply`` and
    ``augment_images_apply`` on a batch on the card against the CPU from one
    set of draws, within twice the CPU's float32 distance from float64 (at
    least 1e-3). ``cli.train experiments/seg_detector_icdar_disk.yaml`` with
    host augmentation and process workers for 4 steps of 8 pages, then
    ``cli.eval`` of it on the 8 eval pages (the CCL kernel; random weights,
    so its P/R/H has no bar). Every number with the card's name and power
    limit; the CTC and CCL kernels must launch (``launches_data`` in the
    kernels line).

17. encoders: config #1 with ``encoder='transformer'`` at full width
    (hidden 256: width 512, 2 layers, 8 heads, MLP 2048, T 25; batch 64 of
    32x100 ``WordCrops``, the optimizer of phase 7) through
    ``Experiment``/``Trainer`` for 24 steps in float32 and 24 in mixed
    precision (its step-0 loss within rtol 0.05 of float32's, float32
    parameters), then ``encoder='none'`` and ``height_collapse='reshape'``
    for 4 steps each: finite losses (falling over the 24-step runs), one
    launch of each CTC kernel a step. The first step's loss and gradients
    in float64 on 8 crops against the CPU (loss rtol 1e-4, each leaf within
    1e-3 of its scale plus 1e-5 of the largest leaf's); each variant's
    greedy decode of 64 crops against the CPU (logits within 1e-4 of their
    scale, ids equal on every crop of clear-margin frames) and its crops/s;
    ms a step, kernel-busy and the idle share of each variant beside the
    BiLSTM's.
18. chains: 8 pages of 640x640 numpy sine-band masks (20 curved bands a
    page): the CCL kernel's labels equal to the plain ones, then
    ``extract_regions`` under each ``extract_impl``, ``extract_chains``,
    band quads and polygons on the card against the CPU (valid, areas,
    roots and live bands equal; ``CHAIN_TOL``). Then
    ``E2EPipeline(rectify='chain', n_bands=8)`` with the trained detector of
    ``assets/bench_det_fp16.msgpack`` and the config-#1 recognizer on 8
    ``TextPages`` in float32 ('xla', 'pallas_full') and bf16: each batch's
    launches, valid regions against the words drawn, the float32 and bf16
    pipelines held to the CPU on 1 page (``serving_cross_check``, polygons
    by ``POLYGON_TOL``); the chain stage's ms beside perspective's on the
    same batch; ``detect_polygons_device`` on the prob maps against the CPU.
19. buckets: ``BucketedE2E`` (batch 4) over 12 ``TextPages`` of
    ``BUCKET_PAGES``' sizes, three a default bucket (one downscaled past
    1152, pages padded at their own scale): one CCL launch a bucket batch;
    detections per page, polygons in the pages' own pixels and texts on
    clear-margin crops against the same on the CPU; each bucket batch's CCL
    labels bit-exact to the plain CCL on the card (launch shapes 640x1152,
    1152x640, 1152x1152); pages/s by bucket.
20. int8: the int32 accumulators of the trained detector's stem and of a
    3x3x512 conv (layer 4) on a page, on the card against an exact float64
    conv of the same int8 operands on the CPU (bit-equal); the trained
    detector at 8x640x640 and a seeded config-#1 recognizer (64 crops of
    32x100) in float32, bf16 and int8 (``int8_context``): forward ms, greedy
    crops/s, the maps' and ids' agreement with float32; ``cli.eval --int8``
    of ``seg_detector_synth.yaml`` with the asset on 8 ``TextPages`` beside
    float32's H-mean. The CCL kernel must launch (``launches_int8``).
21. parallel: a world-size-1 NCCL process group (``file://`` rendezvous):
    config #1 at full width through ``Experiment``/``Trainer`` with
    ``use_mesh=True`` for 4 steps of 64, its losses and parameters bit-equal
    to ``use_mesh=False``'s from the same weights (deterministic cuDNN in
    both); one batch of 8 ``TextPages`` through ``E2EPipeline.build(mesh)``
    against ``run`` (ids, lengths and valid equal, floats within 1e-3).
    The CTC and CCL kernels must launch (``launches_parallel``); the group
    is destroyed.

22. dcn: ``seg_detector_dcn_synth.yaml``'s detector (ResNet-18 with
    deformable stages 3 and 4, FPN 256, heads 64) on seeded weights whose
    offsets are fractional and partly beyond +-2 (``seed_dcn_offsets``,
    ``dcn_offset_saturation`` printed): 8 pages of 640x640 on the card
    against the CPU (prob map within 1e-3, no mask pixel flipped); one
    deformable conv and its parts (offset conv, sampling, contraction), the
    3x3 conv it replaces, the DCN and the plain detector by CUDA events;
    4 mixed-precision steps of the YAML through ``Experiment.from_yaml`` and
    ``Trainer`` (finite losses, float32 parameters); one ``E2EPipeline``
    batch with the config-#1 recognizer, the CCL kernel's labels equal to
    the plain CCL's (``launches_dcn``).
23. spotter: ``shared_spotter_synth.yaml``'s ``SharedTrunkSpotter`` at full
    width (ResNet-18, FPN 256, heads 64, bins (4, 32), BiLSTM 256, offset
    head 128, ``trans_fc2`` non-zero) through ``SpotterE2EPipeline`` (K 32)
    on 8 pages of 640x640, the prob head calibrated: float32 stage by stage
    against the CPU (fused map 1e-4 of its largest, prob 1e-3, labels and
    valid slots equal, quads 1e-3 px; the logits from a float64 reference
    within 4x the CPU's float32 distance from it, since float32 RoI
    coordinates at page scale move the pooled features by about 1e-4 of
    their scale; classes equal on every frame clear by twice that) and whole
    runs equal in valid slots and clear-margin ids; bf16 on 2 pages against
    the CPU's bf16 (the prob map, the share of mask pixels flipped and the
    valid regions per page within twice the CPU's own bf16-vs-float32
    distance); one
    ``'pallas_full'`` batch (one launch of each extraction kernel, valid
    slots equal to ``'xla'``'s, quads within 1e-2 px, statistics equal to
    the CPU's); stage ms, the RoI pooling's ms and pages/s in float32 and
    bf16 beside ``E2EPipeline``'s on the same pages; 4 mixed-precision
    steps each of ``shared_spotter_synth.yaml`` and ``roi_spotter_synth.yaml``
    (``SpotterPages``: ``TextPages`` with host GT maps), the CTC pair once a
    step and held against the plain CTC on the step's rows (invalid slots'
    dummy blank targets included: nll rtol 1e-4, gradient 1e-3) and through
    one step of a float64 twin on 2 pages (loss rtol 1e-4, each gradient
    leaf within 1e-3 of its largest plus 1e-5 of the largest leaf),
    ``evaluate_spotting`` on 16 pages
    (``launches_spotter``).

24. jpeg: every committed JPEG of ``assets/jpeg/`` (8 pages of 1280x720,
    256 word crops, small files in every sampling, grey, restart intervals,
    optimized tables, an EXIF orientation; ``scripts/make_port_jpeg_assets.py``
    writes them where cv2 is installed) decoded on the host by the port's
    ``decode_image``, the RGB digest of each equal to cv2's (the manifest);
    ms a page beside the PNG decode of the same page. Then every file of
    ``assets/images/`` (PNG of every bit depth, colour type and interlace,
    with ``eXIf``; RGB-coded, CMYK, YCCK and multi-scan JPEG, markers after
    the scan, files without EOI; JPEGs cut inside their scans or headers
    and progressive files left unrefined (libjpeg's grey rest and block
    smoothing); BMP and RLE; PNM; GIF; TIFF of every compression the port
    reads, JPEG among them; WebP lossless, lossy, with ALPH and EXIF,
    animated, cut; eleven 640x640 pages; ``scripts/make_port_image_assets.py``) read
    by ``read_image`` and ``decode_image``, each equal to cv2's ``imread``
    and ``imdecode`` digests in the manifest (a file cv2 refuses refused),
    and ms a file by format.
25. lmdb: the 256 JPEG crops in an LMDB written by the port's
    ``write_fixture_lmdb`` (overflow values, leaves under a branch), read
    back record for record and by ``LMDBRecognitionDataset`` (items equal to
    the list-file dataset's on the same files); items/s through the
    ``Loader`` with process and thread workers; config #1 at full width for
    4 steps from it through ``Experiment.from_yaml`` (finite losses, one
    launch of each CTC kernel a step: ``launches_lmdb``).
26. resume: config #1 at full width (AdamW, clip, warm-up cosine,
    ``accumulate_steps`` 2) for 3 steps, its state written in JAX's layout
    (``export_jax_state`` + ``msgpack_serialize``: one mini-step pending),
    resumed by ``Trainer.train(resume=True)`` in a fresh workspace: steps 4
    and 5 equal bit for bit to the run that never stopped (parameters,
    buffers, Adam's moments, the accumulator, count, rate;
    ``launches_resume``).
27. r50: DB's deformable ResNet-50 (``resnet50``, ``dcn_stages=(2, 3, 4)``,
    FPN 256, heads 64; seeded, each block's last BatchNorm damped, offsets
    fractional) in ``E2EPipeline`` with the config-#1 recognizer on 8 pages of
    640x640: the prob map on 1 page against a float64 CPU reference
    (phase dcn's bound), one CCL launch with labels equal to the CPU's on
    the same mask, one ``'pallas_full'`` batch (one launch of each
    extraction kernel, valid equal, quads within 1e-2 px); ms a batch,
    pages/s, busy ms and the split by stage in float32 and bf16 beside the
    ResNet-18 detector's, in turns; then 4 mixed-precision steps of
    ``seg_detector_icdar_disk.yaml`` with the deformable ResNet-50 on the
    committed JPEG pages (process workers) and one ``evaluate_detection``
    on them through CCL (``launches_r50``).
28. tools: ``cli.pipeline --out-dir`` with the asset detector and the
    config-#1 recognizer on 8 pages of 640x640, with ``'auto'`` and with
    ``--extract-impl pallas_full`` (one CCL launch each, one of each
    extraction kernel with ``pallas_full``), every overlay read back and
    pixel-equal to the CPU route's drawing (``draw_polygons``) of the
    card's detections; ``cli.demo`` on one page; ``profiling.trace`` around
    one serving batch (the trace names the CCL kernel and the ``annotate``
    region); ``native`` built by g++ on the card's host, the dispatchers
    ``offset_polygon`` and ``polygon_iou`` held to the numpy routes on 1,000
    random quads; the stem at 8x640x640 against the CPU and its ms by CUDA
    events, and the ``stem_s2d`` / ``stem_s2d4`` flags' stem against it;
    ``resize_bilinear`` and ``rectify_quads`` against the CPU; a
    torchvision-layout ResNet-50 state dict loaded into a trunk, card
    against CPU. Both runs also take the eleven 640x640 pages of
    ``assets/images/pages/`` (a CMYK JPEG, a palette PNG, a 16-bit Adam7
    PNG, an RLE8 BMP, a baseline JPEG cut at 60% of its bytes, a progressive
    JPEG cut inside its first AC scan, a GIF, an LZW TIFF with Predictor 2,
    a lossless and a lossy WebP, a JPEG-compressed TIFF) and a PNG twin of
    each written from its decode: each page's quads and texts equal its
    twin's. Every progressive JPEG of ``assets/jpeg/progressive/``
    equal to its digest, and ms for the 1280x720 page beside its baseline
    twin (``launches_tools``).
29. head: the detector head's formulations (``MapHead``'s flag
    ``fused_upsample``: False the plain chain; the default runs the packed
    tail in eval mode and the fused tail in train mode) with the asset's
    prob-head weights on its FPN feature of 8 TextPages of 640x640, (8, 256,
    160, 160): each eval formulation in float32 and under the bf16 serving
    cast held against the CPU on a corner crop of page 0 and against the
    card's plain formulation on every page, within 4 times the CPU's own
    distance from float64, and the default's float32 train-mode map against
    the plain one's within the same bound; the ms by CUDA events and
    kernel-busy ms (null where the trace lost kernels or holds more than the
    events) of each formulation, eval forward in both dtypes, train forward
    and backward in float32 and mixed bf16; ``E2EPipeline`` with the asset
    under the default head against ``fused_upsample=False`` (valid regions
    equal, prob maps within the same bound, one CCL launch a batch, one of
    each extraction kernel under ``'pallas_full'``) and their pages/s in
    turns; ``cli.eval`` of the asset under both heads (the YAML key
    ``fused_upsample``), H-mean 0.9677 each (``launches_head``).
30. synth: the plain synthetic tier as its experiment files name it, drawn
    on the card's host without cv2 (``data/text_render.py``,
    ``data/raster.py``): the first 16 items of
    ``SyntheticRecognitionDataset(seed=0)``, ``SyntheticDetectionDataset()``
    and ``SyntheticDetectionDataset(max_rotate=15, max_persp=0.05)`` (host GT
    maps) equal to the JAX package's digests (``assets/synth/manifest.json``)
    with ms an item; then ``cli.train`` on ``ctc_resnet18_synth.yaml``
    (4 steps at its batch of 64), ``seg_detector_synth.yaml`` (2 steps) and
    ``shared_spotter_synth.yaml`` (2 steps; host maps and warped words drawn
    by process workers) with no dataset override (only the workspace, the
    sets' sizes, the epochs and one log line a step), finite losses, a
    ``cli.eval`` of each, and ``cli.pipeline --extract-impl pallas_full`` on
    8 PNG pages of the detector's eval set with the two trained
    workspaces; the CTC pair, CCL and the three extraction kernels must
    launch (``launches_synth``), and neither cv2 nor PIL is imported.

Prints each phase's seconds on the host clock, a JSON line of per-kernel
numbers (all eight kernels, with their launches in each phase that drives a
path), then, as the last line,
``{"ok": true, "device": {...}}``. Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

if __name__ != "__mp_main__":
    # the data loader's process workers start from a forkserver, which runs
    # this file's top level again in each worker (as __mp_main__); they read
    # files with numpy and never need torch
    import torch

# H100 SXM peaks at the 700 W limit. HBM3 bandwidth: NVIDIA data sheet. The
# kernel's compares, mins and selects are INT32 instructions: 132 SMs x 64
# INT32 lanes (16 per SM sub-partition, NVIDIA Hopper architecture white
# paper) x 1.98 GHz boost clock, one instruction per lane per cycle
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# float32 outside the tensor cores (the guide's table), for the CTC kernels'
# logsumexp arithmetic
FP32_OPS_PER_S = 67e12
# float64 outside the tensor cores (NVIDIA H100 SXM data sheet), for the
# extraction kernels' float64 sums and projections
FP64_OPS_PER_S = 34e12
SEED = 0
#: the card's name and power limit as nvidia-smi gives them (set by phase setup)
CARD = "not read"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_busy_ms(fn, reps: int = 3, events_ms: float = None):
    """Milliseconds of kernel time per ``fn()`` on the card (sum over the
    device events of a ``torch.profiler`` trace), or None if the trace holds
    no device time; with ``events_ms`` (``fn``'s time by events) also None
    where it holds more than that or fewer kernel records than kernel-launch
    calls (the trace lost kernels)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ms = sum(e.self_device_time_total for e in device) / 1e3 / reps
    if events_ms is not None:
        kernels = sum(e.count for e in device if not e.key.startswith(("Memcpy", "Memset")))
        launches = sum(e.count for e in events
                       if e.device_type == torch.autograd.DeviceType.CPU
                       and e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
        if ms > events_ms or kernels < launches:
            return None
    return ms if ms > 0 else None


def text_masks(rng, B: int, H: int, W: int, n: int = 30) -> np.ndarray:
    """Word-like rotated rectangles, ``n`` per page."""
    out = np.zeros((B, H, W), bool)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for b in range(B):
        for _ in range(n):
            cx, cy = rng.uniform(0, W), rng.uniform(0, H)
            hw, hh = rng.uniform(15, 100), rng.uniform(4, 14)
            th = rng.uniform(-0.6, 0.6) if rng.random() < 0.5 else 0.0
            c, s = np.cos(th), np.sin(th)
            u = (xx - cx) * c + (yy - cy) * s
            v = -(xx - cx) * s + (yy - cy) * c
            out[b] |= (np.abs(u) <= hw) & (np.abs(v) <= hh)
    return out


def serpentine(H: int, W: int) -> np.ndarray:
    """One snake of 4-px rows joined at alternate ends: ~H/8 bends."""
    m = np.zeros((H, W), bool)
    for k, r in enumerate(range(4, H - 8, 8)):
        m[r:r + 4, 4:W - 4] = True
        c = slice(W - 8, W - 4) if k % 2 == 0 else slice(4, 8)
        m[r + 4:r + 8, c] = True
    return m


def phase_setup():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    global CARD
    CARD = smi
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    from megreader_tpu_torch import kernels

    t0 = time.perf_counter()
    built = kernels.build_all()
    log(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def column_snake(H: int, W: int) -> np.ndarray:
    """1-px vertical stripes joined at alternate ends: one component that
    runs W/2 times down and up the page's columns."""
    m = np.zeros((H, W), bool)
    m[1:H - 1, 0:W - 1:2] = True
    for k, x in enumerate(range(1, W - 2, 2)):
        m[1 if k % 2 else H - 2, x] = True
    return m


def ccl_cases(rng):
    """The phase-ccl batches: the serving masks first (text-like rectangles, a
    serpentine that hits the cap, an empty page), then masks whose runs cross
    every chunk, strip and segment edge of the kernel, at the shapes that
    change its launch (strip width, grid larger than what co-resides)."""
    B, H, W = 8, 640, 640
    main = text_masks(rng, B, H, W)
    main[6] = serpentine(H, W)
    main[7] = False
    unaligned = text_masks(rng, 2, 641, 637)
    unaligned[1] = rng.random((641, 637)) < 0.45
    big = text_masks(rng, 2, 1280, 1280, n=120)
    big[1] = serpentine(1280, 1280)
    b32 = text_masks(rng, 32, H, W)
    b32[31] = serpentine(H, W).T
    return {
        "serving 8x640x640": main,
        "transposed serpentine, joined 1-px columns": np.stack(
            [serpentine(H, W).T, column_snake(H, W)]),
        "unaligned 641x637": unaligned,
        "empty/full": np.stack([np.zeros((H, W), bool), np.ones((H, W), bool)]),
        "batch 1 640x640": text_masks(rng, 1, H, W),
        "batch 32 640x640": b32,
        "2x1280x1280": big,
        # a row of 4 tiles and a column of 2 tiles (their carries between tiles)
        "wide 1x64x2000": serpentine(64, 2000)[None],
        "tall 1x4200x96": np.ascontiguousarray(serpentine(96, 4200).T)[None],
    }


def phase_ccl():
    from megreader_tpu_torch.ops.ccl import (
        connected_components,
        connected_components_cuda,
        connected_components_cuda_config,
        connected_components_reference,
        multigrid_solve,
    )

    rng = np.random.default_rng(SEED)
    cases = ccl_cases(rng)
    main = cases["serving 8x640x640"]
    B, H, W = main.shape
    cap = 24

    max_err = 0
    sweeps = None
    for name, m in cases.items():
        mask = torch.from_numpy(m).cuda()
        log(f"ccl {name}: launch {connected_components_cuda_config(*m.shape)}")
        for c in (1, 2, 3, 24, 64):
            got, got_sw = connected_components_cuda(mask, c, return_sweeps=True)
            ref, sw = connected_components_reference(mask, c, return_sweeps=True)
            torch.cuda.synchronize()
            err = int((got.long() - ref.long()).abs().max())
            log(f"ccl {name} cap {c}: max |kernel - plain| = {err}, sweeps per page "
                f"{sw.tolist()}")
            if not torch.equal(got, ref):
                raise AssertionError(f"ccl kernel disagrees with the plain version on "
                                     f"{name} at cap {c}")
            if not torch.equal(got_sw, sw):
                raise AssertionError(f"ccl kernel ran sweeps {got_sw.tolist()} on {name} at "
                                     f"cap {c}, the plain version {sw.tolist()}")
            max_err = max(max_err, err)
            if sweeps is None and c == cap:
                sweeps = sw
    if int(sweeps[6]) != cap:
        raise AssertionError(f"the serpentine page ran {int(sweeps[6])} sweeps, not the cap {cap}")

    mask = torch.from_numpy(main).cuda()
    ms = cuda_ms(lambda: connected_components_cuda(mask, cap), reps=50)
    busy = device_busy_ms(lambda: connected_components_cuda(mask, cap), reps=10)
    plain_ms = cuda_ms(lambda: connected_components_reference(mask, cap), reps=20)
    one_sweep_ms = cuda_ms(lambda: connected_components_cuda(mask, 1), reps=50)
    one_sweep_busy = device_busy_ms(lambda: connected_components_cuda(mask, 1), reps=10)
    n = B * H * W
    bytes_moved = n * (1 + 4)  # mask read once, labels written once
    ops = int(sweeps.sum()) * H * W * 4 * 2  # 4 passes, compare + select per pixel
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    sweep_bytes = (n * 8, n * 16)  # per sweep and phase: labels read once, written at most once
    log(f"ccl launch at the serving shape: {connected_components_cuda_config(B, H, W)}")
    log(f"ccl time: kernel {ms} ms by CUDA events, {busy} ms kernel-busy; plain {plain_ms} ms; "
        f"kernel capped at one sweep {one_sweep_ms} ms by events, {one_sweep_busy} ms busy")
    log(f"ccl bound: bytes {bytes_moved} -> {bytes_ms:.5f} ms, ops {ops} -> {ops_ms:.5f} ms; "
        f"sweeps {sweeps.tolist()} (sum {int(sweeps.sum())}); L2 traffic of the design "
        f"{sweep_bytes[0]}-{sweep_bytes[1]} B per sweep")

    # multigrid: a launch on the 2x2-min-pooled masks, then a launch seeded by
    # its labels, against the plain multigrid (labels and both levels' sweeps)
    for name, m in cases.items():
        mask = torch.from_numpy(m).cuda()
        for c in (1, 2, 3, 24, 64):
            got, got_sw = multigrid_solve(connected_components_cuda, mask, c, return_sweeps=True)
            ref, sw = multigrid_solve(connected_components_reference, mask, c,
                                      return_sweeps=True)
            torch.cuda.synchronize()
            err = int((got.long() - ref.long()).abs().max()) if got.numel() else 0
            log(f"ccl multigrid {name} cap {c}: max |kernel - plain| = {err}, sweeps per page "
                f"coarse {sw[0].tolist()} full {sw[1].tolist()}")
            if not torch.equal(got, ref) or not torch.equal(got_sw, sw):
                raise AssertionError(f"seeded ccl launch disagrees with the plain multigrid on "
                                     f"{name} at cap {c}: sweeps {got_sw.tolist()} against "
                                     f"{sw.tolist()}")
            max_err = max(max_err, err)
    mask = torch.from_numpy(main).cuda()
    _, mg_sweeps = multigrid_solve(connected_components_cuda, mask, cap, return_sweeps=True)
    mg = lambda: connected_components(mask, cap, multigrid=True)  # noqa: E731
    flat = lambda: connected_components(mask, cap)  # noqa: E731
    turns = {"flat": [], "multigrid": []}
    for which in ("flat", "multigrid", "multigrid", "flat"):
        turns[which].append(cuda_ms(flat if which == "flat" else mg, reps=50))
    log(f"ccl flat against multigrid at the serving masks (cap {cap}; ms by CUDA events, "
        f"median of 50, in turns): {json.dumps(turns)}; kernel-busy flat "
        f"{device_busy_ms(flat, reps=10)} ms, multigrid {device_busy_ms(mg, reps=10)} ms "
        f"(two launches and the pooling and seeding ops); sweeps flat {int(sweeps.sum())}, "
        f"multigrid coarse {int(mg_sweeps[0].sum())} + full {int(mg_sweeps[1].sum())} "
        f"(per page {mg_sweeps.tolist()})")
    return {
        "name": "ccl",
        "route": "cuda",
        "source": "megreader_tpu_torch/csrc/ccl.cu",
        "replaces": "megreader_tpu/ops/pallas_ccl.py:70",
        "launches": 0,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def bars(H: int, W: int) -> np.ndarray:
    """Long thin bars at eight angles from 0 to 7 pi / 8, plus a blob."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    m = np.zeros((H, W), bool)
    for k in range(8):
        th = k * np.pi / 8
        cx, cy = W * (0.2 + 0.2 * (k % 4)), H * (0.25 + 0.5 * (k // 4))
        u = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
        v = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
        m |= (np.abs(u) <= 0.08 * W) & (np.abs(v) <= 3 + k)
    m |= (xx - 0.5 * W) ** 2 + (yy - 0.5 * H) ** 2 < 400
    return m


def extract_masks(rng, B: int, H: int, W: int) -> np.ndarray:
    """The extract phase's pages: text-like rectangles with a component
    rooted at pixel 0, 20% noise (more components than K2 slots), rotated
    bars, text-like rectangles again, and, from 5 pages on, a serpentine
    whose labels stay capped (labels that name no root) and an empty last
    page."""
    m = text_masks(rng, B, H, W)
    m[0, :8, :60] = True
    if B > 1:
        m[1] = rng.random((H, W)) < 0.2
    if B > 2:
        m[2] = bars(H, W)
    if B > 4:
        m[B - 2] = serpentine(H, W)
        m[B - 1] = False
    return m


def large_masks(rng, H: int = 2048, W: int = 2048) -> np.ndarray:
    """Two pages with page-sized components: one all foreground (a single
    component of H*W pixels, its sum of x^2 about 5.9e12 at 2048), and a
    96-px frame around a disc of radius 0.4 W, with text-like rectangles."""
    m = np.zeros((2, H, W), bool)
    m[0] = True
    yy, xx = np.mgrid[0:H, 0:W]
    m[1] = (yy < 96) | (yy >= H - 96) | (xx < 96) | (xx >= W - 96)
    m[1] |= (xx - W / 2) ** 2 + (yy - H / 2) ** 2 < (0.4 * W) ** 2
    m[1] |= text_masks(rng, 1, H, W)[0]
    return m


def extract_bounds(labels_np: np.ndarray, K: int, K2: int):
    """Least times (ms) of the three extraction functions on these labels, and
    what bounds each: every input read once and every output written once at
    the HBM rate (moments: the labels and the scores), against the work these
    labels need (candidates: a root test and a count per pixel, INT32;
    moments: 12 operations per member pixel, counted at the float64 rate;
    extents: 12 float64 operations per member pixel) at the H100's rates."""
    B = labels_np.shape[0]
    n = labels_np.size
    fg = int((labels_np >= 0).sum())
    rows = {
        "candidates": (n * 4 + B * K2 * 8, 3 * n / INT32_OPS_PER_S),
        "moments": (2 * n * 4 + B * K * 4 + B * K * 8 * 4, 12 * fg / FP64_OPS_PER_S),
        "extents": (n * 4 + B * K * 4 + 2 * B * K * 4 * 4, 12 * fg / FP64_OPS_PER_S),
    }
    out = {}
    for name, (nbytes, op_s) in rows.items():
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, op_s * 1e3
        out[name] = (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
                     nbytes)
    return out


def phase_extract(B: int = 8, H: int = 640, W: int = 640, large_hw: int = 2048):
    """The three extraction kernels against their plain versions on the card
    at the serving shape (K 32, and K 20 for the K2 rounding; then unaligned
    pages, then two 2048x2048 pages with page-sized components), and the
    whole Pallas-path extraction on the card against the plain versions on
    the CPU (not at 2048x2048, where the CPU's plain path is slow); times,
    host time a call and bounds at the serving shape."""
    from megreader_tpu_torch.ops import ccl
    from megreader_tpu_torch.ops import extract as ex

    rng = np.random.default_rng(SEED + 17)
    K, cap = 32, 24
    serving = (f"serving {B}x{H}x{W}", extract_masks(rng, B, H, W))
    unaligned = (f"unaligned 2x{H + 1}x{W - 3}", extract_masks(rng, 2, H + 1, W - 3))
    large = (f"large 2x{large_hw}x{large_hw}", large_masks(rng, large_hw, large_hw))
    errs = {"candidates": 0.0, "moments": 0.0, "extents": 0.0}
    timed = None
    for (name, m), k in ((serving, K), (serving, 20), (unaligned, K), (large, K)):
        whole_path = ("pallas", "pallas_full") if name != large[0] else ()
        labels = ccl.connected_components_cuda(torch.from_numpy(m).cuda(), cap)
        scores = torch.from_numpy(rng.random(m.shape, dtype=np.float32)).cuda()
        K2 = ex.pallas_k2(k)
        what = f"extract {name}, K {k} (K2 {K2})"

        # candidates: roots and areas bit-exact, and across two launches
        cand = ex.candidates_cuda(labels, K2)
        cand2 = ex.candidates_cuda(labels, K2)
        cand_ref = ex.candidates_reference(labels, K2)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(cand, cand_ref)):
            raise AssertionError(f"{what}: the candidates kernel disagrees with the plain one")
        if not all(torch.equal(a, b) for a, b in zip(cand, cand2)):
            raise AssertionError(f"{what}: two candidates launches differ")
        top_area, roots, valid = ccl._top_k_slots(*cand_ref, k)
        roots = roots.to(torch.int32).contiguous()
        if not torch.equal(ccl._top_k_slots(*cand, k)[1].to(torch.int32), roots):
            raise AssertionError(f"{what}: the selected roots differ")

        # moments: count, first and second moments (columns 0, 2-6) and the
        # zero column 7 bit-exact to the plain version and across two
        # launches (exact int64 sums, the same finishing arithmetic); the
        # score (column 1), a float64 sum in atomic order, rtol 1e-6
        M = ex.moments_cuda(labels, scores, roots)
        M2 = ex.moments_cuda(labels, scores, roots)
        M_ref = ex.moments_reference(labels, scores, roots)
        torch.cuda.synchronize()
        exact = [0, 2, 3, 4, 5, 6, 7]
        m_err = float(((M - M_ref).abs() / M_ref.abs().clamp(min=1.0)).max())
        if not torch.equal(M[..., exact], M_ref[..., exact]):
            bad = int((M[..., exact] != M_ref[..., exact]).sum())
            raise AssertionError(f"{what}: the moments kernel's integer columns differ from "
                                 f"the plain version's in {bad} values ({m_err:.3g})")
        if not torch.equal(M[..., exact], M2[..., exact]):
            raise AssertionError(f"{what}: two moments launches differ in columns 0, 2-7")
        if not torch.allclose(M[..., 1], M_ref[..., 1], rtol=1e-6, atol=0.0):
            raise AssertionError(f"{what}: the moments kernel's scores disagree ({m_err:.3g})")
        m_abs = float((M - M_ref).abs().max())

        # extents on the same parameters: float64 rounded once per operation
        # on both sides, min and max order-free, so bit-exact to the plain
        # version and across two launches
        a = top_area.clamp(min=1.0)
        theta = 0.5 * torch.atan2(2.0 * M_ref[..., 6] / a, (M_ref[..., 4] - M_ref[..., 5]) / a)
        params = torch.stack([M_ref[..., 2] / a, M_ref[..., 3] / a, theta.cos(), theta.sin()],
                             2).contiguous()
        ext = ex.extents_cuda(labels, roots, params)
        ext2 = ex.extents_cuda(labels, roots, params)
        ext_ref = ex.extents_reference(labels, roots, params)
        torch.cuda.synchronize()
        e_err = float((ext - ext_ref).abs().max())
        if not torch.equal(ext, ext_ref):
            bad = int((ext != ext_ref).sum())
            raise AssertionError(f"{what}: the extents kernel differs from the plain version in "
                                 f"{bad} values (max |err| {e_err})")
        if not torch.equal(ext, ext2):
            raise AssertionError(f"{what}: two extents launches differ")
        errs["moments"] = max(errs["moments"], m_abs)
        errs["extents"] = max(errs["extents"], e_err)
        log(f"{what}: candidates bit-exact ({int((cand_ref[1] > 0).sum())} live slots), "
            f"moments columns 0, 2-7 bit-exact and repeatable, score max rel err "
            f"{m_err:.3g}, max abs err {m_abs:.3g} (bitwise: {torch.equal(M, M_ref)}, "
            f"repeat bitwise: {torch.equal(M, M2)}), "
            f"extents bit-exact and repeatable; "
            f"{int(valid.sum())} valid slots")

        # the whole Pallas-path extraction on the card against the plain
        # versions on the CPU: valid and area exact; centre and extents atol
        # 1e-3 px, angle 1e-5 rad, on elongated regions (principal extent
        # over 1.5 times the other; elsewhere the angle is ill-conditioned);
        # score atol 1e-5
        for impl in whole_path:
            got = ccl.extract_regions(labels, scores, k, impl=impl)
            ref = ccl.extract_regions(labels.cpu(), scores.cpu(), k, impl=impl)
            got = {key: v.cpu() for key, v in got.items()}
            if not (torch.equal(got["valid"], ref["valid"]) and torch.equal(got["area"],
                                                                            ref["area"])):
                raise AssertionError(f"{what} {impl}: valid or area differ from the CPU's")
            length = ref["extent_u"][..., 1] - ref["extent_u"][..., 0] + 1.0
            aniso = length > 1.5 * (ref["extent_v"][..., 1] - ref["extent_v"][..., 0] + 1.0)
            diffs = {key: float((got[key] - ref[key]).abs()[aniso].max()) if aniso.any() else 0.0
                     for key in ("center", "theta", "extent_u", "extent_v")}
            diffs["score"] = float((got["score"] - ref["score"]).abs().max())
            diffs["all_slots_theta"] = float((got["theta"] - ref["theta"]).abs().max())
            log(f"{what} {impl} on the card vs the CPU ({int(aniso.sum())} elongated slots of "
                f"{aniso.numel()}): max |diff| " + json.dumps(diffs))
            limits = {"center": 1e-3, "theta": 1e-5, "extent_u": 1e-3, "extent_v": 1e-3,
                      "score": 1e-5}
            for key, lim in limits.items():
                if not diffs[key] <= lim:
                    raise AssertionError(f"{what} {impl}: {key} differs by {diffs[key]} > {lim}")
        if timed is None:
            timed = (labels, scores, roots, params, K2)

    labels, scores, roots, params, K2 = timed
    # candidates at the most slots they take (K2 8192: a table past 48 KB of
    # shared memory), bit-exact and repeatable
    cand_ref = ex.candidates_reference(labels, 8 * ex.MAX_REGIONS)
    cand = ex.candidates_cuda(labels, 8 * ex.MAX_REGIONS)
    cand2 = ex.candidates_cuda(labels, 8 * ex.MAX_REGIONS)
    if not all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(cand, cand_ref, cand2)):
        raise AssertionError(f"extract K2 {8 * ex.MAX_REGIONS}: the candidates kernels disagree")
    log(f"extract candidates at K2 {8 * ex.MAX_REGIONS}: bit-exact and repeatable "
        f"({int((cand_ref[1] > 0).sum())} live slots)")
    # moments at the most slots the kernels take (shared memory past 48 KB)
    many = cand_ref[0][:, :ex.MAX_REGIONS].contiguous()
    M, M_ref = ex.moments_cuda(labels, scores, many), ex.moments_reference(labels, scores, many)
    if not (torch.equal(M[..., exact], M_ref[..., exact])
            and torch.allclose(M[..., 1], M_ref[..., 1], rtol=1e-6, atol=0.0)):
        raise AssertionError(f"extract K {ex.MAX_REGIONS}: the moments kernels disagree")
    log(f"extract moments at K {ex.MAX_REGIONS}: columns 0, 2-7 bit-exact, score rtol 1e-6")
    # extents at the most slots, on parameters that vary by slot (the dead
    # slots' root 0 a chain of about a thousand slots on the first page)
    a = cand_ref[1][:, :ex.MAX_REGIONS].clamp(min=1.0)
    theta = 0.5 * torch.atan2(2.0 * M_ref[..., 6] / a, (M_ref[..., 4] - M_ref[..., 5]) / a)
    params_many = torch.stack([M_ref[..., 2] / a, M_ref[..., 3] / a, theta.cos(), theta.sin()],
                              2).contiguous()
    ext = ex.extents_cuda(labels, many, params_many)
    if not (torch.equal(ext, ex.extents_reference(labels, many, params_many))
            and torch.equal(ext, ex.extents_cuda(labels, many, params_many))):
        raise AssertionError(f"extract K {ex.MAX_REGIONS}: the extents kernel disagrees")
    log(f"extract extents at K {ex.MAX_REGIONS}: bit-exact and repeatable")
    # extents of slots that repeat a live root with other parameters (chains
    # of several links), each slot on its own axes
    prng = np.random.default_rng(SEED + 23)
    dup = roots[:, torch.tensor([0, 1, 0, 2, 1, 0, 3, 2] * (roots.shape[1] // 8))].contiguous()
    theta = prng.uniform(-np.pi, np.pi, dup.shape)
    params_dup = torch.from_numpy(np.stack([
        prng.uniform(0, labels.shape[2], dup.shape), prng.uniform(0, labels.shape[1], dup.shape),
        np.cos(theta), np.sin(theta)], -1).astype(np.float32)).cuda()
    ext = ex.extents_cuda(labels, dup, params_dup)
    if not (torch.equal(ext, ex.extents_reference(labels, dup, params_dup))
            and torch.equal(ext, ex.extents_cuda(labels, dup, params_dup))):
        raise AssertionError("extract: the extents kernel disagrees on repeated roots")
    log("extract extents with repeated roots on other parameters: bit-exact and repeatable")
    fns = {
        "candidates": (lambda: ex.candidates_cuda(labels, K2),
                       lambda: ex.candidates_reference(labels, K2)),
        "moments": (lambda: ex.moments_cuda(labels, scores, roots),
                    lambda: ex.moments_reference(labels, scores, roots)),
        "extents": (lambda: ex.extents_cuda(labels, roots, params),
                    lambda: ex.extents_reference(labels, roots, params)),
    }
    with torch.no_grad():
        times = {name: (cuda_ms(f, reps=100), device_busy_ms(f, reps=20), cuda_ms(p, reps=10))
                 for name, (f, p) in fns.items()}
        whole = {}
        for impl in ("xla", "pallas", "pallas_full"):
            def run(impl=impl):
                return ccl.extract_regions(labels, scores, K, impl=impl)

            whole[impl] = (cuda_ms(run, reps=20), device_busy_ms(run))
        host_us = {}
        for name, (f, _) in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                f()
            host_us[name] = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
    bounds = extract_bounds(labels.cpu().numpy(), K, K2)
    log(f"extract kernel ms at {B}x{H}x{W}, K 32 (kernel by CUDA events, median of 100; "
        "kernel-busy by torch.profiler; plain by CUDA events, median of 10; host us a wrapper "
        "call from the card idle, perf_counter over 200 calls): " + json.dumps(
            {n: {"ms": t[0], "busy_ms": t[1], "plain_ms": t[2], "host_us": host_us[n],
                 "bound_ms": bounds[n][0], "bound_by": bounds[n][1], "bound_bytes": bounds[n][2]}
             for n, t in times.items()}))
    log("extract_regions ms by impl (CUDA events, median of 20; kernel-busy): "
        + json.dumps({k: {"ms": v[0], "busy_ms": v[1]} for k, v in whole.items()})
        + "; library: none (no single PyTorch call)")
    replaces = {"candidates": 66, "moments": 120, "extents": 168}
    return [{
        "name": f"extract_{name}", "route": "cuda",
        "source": "megreader_tpu_torch/csrc/extract.cu",
        "replaces": f"megreader_tpu/ops/pallas_extract.py:{replaces[name]}",
        "launches": 0, "max_abs_err": errs[name], "ms": times[name][0],
        "plain_ms": times[name][2], "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        "library_ms": None,
    } for name in ("candidates", "moments", "extents")]


def ctc_inputs(rng, B: int = 64, T: int = 25, C: int = 37, L: int = 32):
    """Config #1's training shape with every case the kernels must cover:
    word-like label lengths 1-12, varied logit lengths, repeated labels, an
    empty label, and rows without an alignment (a label of 32, and 14 copies
    of one class, which need 27 steps). Returns numpy (logits, logit_lengths,
    labels, label_lengths) and the rows that have an alignment."""
    logits = (2.0 * rng.standard_normal((B, T, C))).astype(np.float32)
    logit_lengths = np.full(B, T, np.int32)
    logit_lengths[::5] = rng.integers(13, T, size=len(logit_lengths[::5]))
    label_lengths = rng.integers(1, 13, size=B).astype(np.int32)
    labels = np.zeros((B, L), np.int32)
    for b in range(B):
        labels[b, :label_lengths[b]] = rng.integers(1, C, size=label_lengths[b])
    labels[1, :6] = [5, 5, 5, 7, 7, 5]  # repeats: no skip between equal labels
    label_lengths[1] = 6
    labels[2], label_lengths[2] = 0, 0  # empty label: all blanks
    labels[3] = rng.integers(1, C, size=L)  # 32 labels in 25 steps
    label_lengths[3] = L
    labels[4] = 0
    labels[4, :14] = 9  # 14 repeats need 27 steps
    label_lengths[4] = 14
    logit_lengths[1:5] = T
    # a row has an alignment iff its labels and the blanks forced between
    # equal neighbours fit in its steps
    words = [labels[b, :label_lengths[b]] for b in range(B)]
    repeats = np.array([int((w[1:] == w[:-1]).sum()) for w in words])
    possible = label_lengths + repeats <= logit_lengths
    assert not possible[3] and not possible[4] and possible.sum() > B // 2
    return logits, logit_lengths, labels, label_lengths, possible


def ctc_bounds(logit_lengths, label_lengths, T: int, C: int, L: int):
    """(forward, backward) least times in ms and what bounds each: every input
    read once and every output written once at the HBM rate, against the
    logsumexp arithmetic of the states this run's lengths make live at the
    float32 rate (about 10 operations a state and step forward, 15 backward:
    three exps, a log, maxes, sums; the gradient's exp and add)."""
    B = len(logit_lengths)
    S = 2 * L + 1
    lens = np.clip(logit_lengths, 1, T).astype(np.int64)
    states = (2 * label_lengths.astype(np.int64) + 1)
    inputs = B * T * C * 4 + B * L * 4 + 2 * B * 4
    fwd_bytes = inputs + B * T * S * 4 + B * 4  # + alpha and nll written
    bwd_bytes = inputs + B * T * S * 4 + 2 * B * 4 + B * T * C * 4  # alpha, nll, grad_nll in; grad out
    fwd_ops = 10 * int(((lens - 1) * states).sum())
    bwd_ops = 15 * int((lens * states).sum())
    out = []
    for nbytes, ops in ((fwd_bytes, fwd_ops), (bwd_bytes, bwd_ops)):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        out.append((max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
                    nbytes, ops))
    return out


def ctc_long_inputs(rng, B: int, T: int, C: int = 37, L: int = 100):
    """Long labels (L/2 to L of them) over T steps: a row of L labels in
    equal pairs (a blank forced between each pair), an empty label, a row of
    L labels in L - 1 steps (no alignment), the rest random, logit lengths
    from 3T/4 to T. Returns numpy (logits, logit_lengths, labels,
    label_lengths) and the rows that have an alignment."""
    logits = (2.0 * rng.standard_normal((B, T, C))).astype(np.float32)
    logit_lengths = rng.integers(3 * T // 4, T + 1, size=B).astype(np.int32)
    label_lengths = rng.integers(L // 2, L + 1, size=B).astype(np.int32)
    labels = np.zeros((B, L), np.int32)
    for b in range(B):
        labels[b, :label_lengths[b]] = rng.integers(1, C, size=label_lengths[b])
    labels[0], label_lengths[0], logit_lengths[0] = np.repeat(rng.integers(1, C, L // 2), 2), L, T
    labels[1], label_lengths[1] = 0, 0
    label_lengths[2], logit_lengths[2] = L, L - 1
    labels[2] = rng.integers(1, C, size=L)
    words = [labels[b, :label_lengths[b]] for b in range(B)]
    repeats = np.array([int((w[1:] == w[:-1]).sum()) for w in words])
    possible = label_lengths + repeats <= logit_lengths
    assert possible[0] and possible[1] and not possible[2] and possible.sum() > B // 2
    return logits, logit_lengths, labels, label_lengths, possible


def check_ctc_kernels(name, lp, ll, lb, lbl, possible, gw, float64=False):
    """Both CTC kernels against the plain versions on the card at one shape:
    the loss (rtol 1e-4 / atol 1e-4: a log-space DP summed in another order)
    and every alpha plane (the same); the gradient of the weighted losses
    (rtol 1e-3 / atol 1e-4) against autograd through the plain forward
    (with ``float64``, run in float64: over hundreds of steps float32
    autograd's own error reaches that tolerance) and against the plain beta
    (``ctc_beta_reference``); two beta launches bitwise equal; rows without
    an alignment finite at about 1e30, with the XLA scan's gradient. Returns
    the largest (forward, backward) errors on the rows with an alignment."""
    from megreader_tpu_torch.ops.ctc import (
        _plan,
        ctc_alpha_cuda,
        ctc_alpha_reference,
        ctc_beta_cuda,
        ctc_beta_reference,
        ctc_nll_reference,
    )

    B, T, C = lp.shape
    L = lb.shape[1]
    ok = torch.from_numpy(possible).cuda()
    ll_np, lb_np, lbl_np = (t.cpu().numpy() for t in (ll, lb, lbl))
    nll, alpha = ctc_alpha_cuda(lp, ll, lb, lbl)
    ref, ref_alpha = ctc_alpha_reference(lp, ll, lb, lbl)
    torch.cuda.synchronize()
    fwd_err = float((nll - ref)[ok].abs().max())
    plane_err = float((alpha - ref_alpha)[ok].abs().max())
    log(f"ctc {name} (B {B}, T {T}, C {C}, L {L}; emissions in "
        f"{['device', 'shared'][_plan(T, L, C)[0]]} memory) forward: max |kernel - plain| on "
        f"rows with an alignment {fwd_err:.3g}, of the alpha planes {plane_err:.3g}; rows "
        f"without one: kernel {nll[~ok].tolist()}, plain {ref[~ok].tolist()}")
    if not (torch.allclose(nll, ref, rtol=1e-4, atol=1e-4)
            and torch.allclose(alpha, ref_alpha, rtol=1e-4, atol=1e-4)):
        raise AssertionError(f"ctc alpha kernel disagrees with the plain version ({name})")
    if not (torch.isfinite(nll).all() and bool((nll[~ok] > 1e29).all())):
        raise AssertionError("ctc: a row without an alignment must give a finite ~1e30 loss")

    grad = ctc_beta_cuda(lp, ll, lb, lbl, alpha, nll, gw)
    again = ctc_beta_cuda(lp, ll, lb, lbl, alpha, nll, gw)
    dtype = torch.float64 if float64 else torch.float32
    lp_ref = lp.detach().to(dtype).requires_grad_()
    (ctc_nll_reference(lp_ref, ll, lb, lbl) * gw.to(dtype)).sum().backward()
    auto = lp_ref.grad.float()
    plain = ctc_beta_reference(lp, ll, lb, lbl, alpha, nll, gw)
    torch.cuda.synchronize()
    bwd_err = float((grad - auto).abs().max())
    log(f"ctc {name} backward (emissions and planes in "
        f"{['device', 'shared'][_plan(T, L, C)[1]]} memory): "
        f"max |kernel - plain| of d nll / d log_probs {bwd_err:.3g} (autograd in {dtype}), "
        f"{float((grad - plain).abs().max()):.3g} (plain beta, ctc_beta_reference)")
    if not torch.allclose(grad, auto, rtol=1e-3, atol=1e-4):
        raise AssertionError(f"ctc beta kernel disagrees with the plain version ({name})")
    if not torch.allclose(grad, plain, rtol=1e-3, atol=1e-4):
        raise AssertionError(f"ctc beta kernel disagrees with the plain beta ({name})")
    if not torch.equal(grad, again):
        raise AssertionError(f"ctc beta kernel: two launches differ ({name})")
    # rows with no alignment: -1/2 at the two terminal states' classes at the
    # row's last step
    expect = torch.zeros_like(lp)
    for b in np.flatnonzero(~possible):
        t_last = min(max(int(ll_np[b]), 1), T) - 1
        if t_last > 0:
            expect[b, t_last, 0] -= 0.5 * gw[b]
            expect[b, t_last, int(lb_np[b, lbl_np[b] - 1])] -= 0.5 * gw[b]
    if not torch.allclose(grad[~ok], expect[~ok], rtol=0, atol=1e-6):
        raise AssertionError(f"ctc beta kernel: rows without an alignment ({name})")
    log(f"ctc {name} backward: two launches bitwise equal; rows without an alignment carry "
        f"the XLA scan's pattern")
    return fwd_err, bwd_err


def phase_ctc():
    """Both CTC kernels against the plain version on the card at config #1's
    shape, with a bad label, at three long-label shapes and with 5,000
    classes (each instance of each kernel); times, host time per call and
    bounds at config #1's shape."""
    import torch.nn.functional as F

    from megreader_tpu_torch.ops.ctc import (
        ctc_alpha_cuda,
        ctc_beta_cuda,
        ctc_beta_reference,
        ctc_loss,
        ctc_loss_reference,
        ctc_nll_reference,
    )

    rng = np.random.default_rng(SEED + 4)
    B, T, C, L = 64, 25, 37, 32
    logits_np, ll_np, lb_np, lbl_np, possible = ctc_inputs(rng, B, T, C, L)
    logits = torch.from_numpy(logits_np).cuda()
    ll, lb, lbl = (torch.from_numpy(a).cuda() for a in (ll_np, lb_np, lbl_np))
    lp = F.log_softmax(logits, -1).contiguous()
    ones = torch.ones(B, device="cuda")
    gw = torch.from_numpy(rng.uniform(0.5, 2.0, B).astype(np.float32)).cuda()
    fwd_err, bwd_err = check_ctc_kernels("config #1", lp, ll, lb, lbl, possible, ones)
    check_ctc_kernels("config #1, weighted rows", lp, ll, lb, lbl, possible, gw)
    nll, alpha = ctc_alpha_cuda(lp, ll, lb, lbl)

    # a label outside [0, C): NaN loss and a NaN gradient on that row's live
    # steps, the other rows as before
    bad = 5  # a row with frozen steps
    lb_bad = lb.clone()
    lb_bad[bad, 0] = C + 62
    nll_bad, alpha_bad = ctc_alpha_cuda(lp, ll, lb_bad, lbl)
    grad_bad = ctc_beta_cuda(lp, ll, lb_bad, lbl, alpha_bad, nll_bad, gw)
    plain_nll = nll.clone()
    plain_nll[bad] = float("nan")
    plain_bad = ctc_beta_reference(lp, ll, lb_bad, lbl, alpha_bad, plain_nll, gw)
    grad_ok = ctc_beta_cuda(lp, ll, lb, lbl, alpha, nll, gw)
    others = torch.arange(B, device="cuda") != bad
    live = int(ll_np[bad])
    if not (bool(torch.isnan(nll_bad[bad])) and torch.equal(nll_bad[others], nll[others])
            and bool(torch.isnan(grad_bad[bad, :live]).all())
            and bool((grad_bad[bad, live:] == 0).all())
            and torch.equal(grad_bad[others], grad_ok[others])
            and torch.equal(torch.isnan(grad_bad), torch.isnan(plain_bad))):
        raise AssertionError("ctc kernels: a bad label must give a NaN loss and gradient on "
                             "its row only")
    log(f"ctc bad label (row {bad}): NaN loss and NaN gradient on its {live} live steps, as the "
        f"plain beta; the other rows unchanged")

    # long labels, more than one column of states (beta's planes in shared
    # memory at T 120 / L 50, in device memory at T 240 / L 100 and at
    # S 1001), and a large charset (5,000 classes: the emissions of both
    # kernels in device memory)
    for name, (Bl, Tl, Ll, Cl) in (("long, T 120, L 50", (32, 120, 50, C)),
                                   ("long, T 240, L 100", (64, 240, 100, C)),
                                   ("widest, T 1000, L 500", (8, 1000, 500, C)),
                                   ("large charset, C 5000", (16, 25, 16, 5000))):
        lrng = np.random.default_rng(SEED + 40 + Tl + Ll)
        lg_np, lll_np, llb_np, llbl_np, lpossible = ctc_long_inputs(lrng, Bl, Tl, Cl, Ll)
        llp = F.log_softmax(torch.from_numpy(lg_np).cuda(), -1).contiguous()
        lw = torch.from_numpy(lrng.uniform(0.5, 2.0, Bl).astype(np.float32)).cuda()
        errs = check_ctc_kernels(name, llp, *(torch.from_numpy(a).cuda()
                                               for a in (lll_np, llb_np, llbl_np)), lpossible, lw,
                                 float64=True)
        fwd_err, bwd_err = max(fwd_err, errs[0]), max(bwd_err, errs[1])

    # the whole loss from logits, kernels under autograd, mean reduction
    x = logits.clone().requires_grad_()
    loss = ctc_loss(x, ll, lb, lbl)
    loss.backward()
    x_ref = logits.clone().requires_grad_()
    loss_ref = ctc_loss_reference(x_ref, ll, lb, lbl)
    loss_ref.backward()
    log(f"ctc_loss (mean): kernels {loss.item()}, plain {loss_ref.item()}; d/d logits max "
        f"|diff| {float((x.grad - x_ref.grad).abs().max()):.3g}")
    if not (torch.allclose(loss, loss_ref, rtol=1e-4, atol=1e-4)
            and torch.allclose(x.grad, x_ref.grad, rtol=1e-3, atol=1e-4)):
        raise AssertionError("ctc_loss through the kernels disagrees with the plain version")

    # times, CUDA events, median of 100 (plain: 20)
    ms_fwd = cuda_ms(lambda: ctc_alpha_cuda(lp, ll, lb, lbl), reps=100)
    ms_bwd = cuda_ms(lambda: ctc_beta_cuda(lp, ll, lb, lbl, alpha, nll, ones), reps=100)
    def kernels_both():
        n, a = ctc_alpha_cuda(lp, ll, lb, lbl)
        ctc_beta_cuda(lp, ll, lb, lbl, a, n, ones)

    ms_both = cuda_ms(kernels_both, reps=100)
    lp_ref = lp.detach().clone().requires_grad_()
    with torch.no_grad():
        plain_fwd = cuda_ms(lambda: ctc_nll_reference(lp, ll, lb, lbl), reps=20)
    out_ref = ctc_nll_reference(lp_ref, ll, lb, lbl).sum()
    plain_bwd = cuda_ms(lambda: torch.autograd.grad(out_ref, lp_ref, retain_graph=True), reps=20)

    def plain_both():
        torch.autograd.grad(ctc_nll_reference(lp_ref, ll, lb, lbl).sum(), lp_ref)

    plain_ms_both = cuda_ms(plain_both, reps=20)
    # torch.nn.functional.ctc_loss: (T, B, C) log-probs, padded targets;
    # rows without an alignment give inf there (zeroed, with their gradient)
    lp_lib = lp.detach().transpose(0, 1).requires_grad_()
    tl, il = lbl.long(), ll.long()

    def lib_loss():
        return F.ctc_loss(lp_lib, lb.long(), il, tl, blank=0, reduction="sum", zero_infinity=True)

    with torch.no_grad():
        lib_fwd = cuda_ms(lib_loss, reps=100)
    out_lib = lib_loss()
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(out_lib, lp_lib, retain_graph=True), reps=100)
    lib_both = cuda_ms(lambda: torch.autograd.grad(lib_loss(), lp_lib), reps=100)
    lib_nll = F.ctc_loss(lp_lib.detach(), lb.long(), il, tl, blank=0, reduction="none")
    ok = torch.from_numpy(possible).cuda()
    log(f"F.ctc_loss on the rows with an alignment: max |kernel - F.ctc_loss| "
        f"{float((nll - lib_nll)[ok].abs().max()):.3g}")

    # the kernels' own device time, without the wrapper's host time that
    # the events above also see when the card waits for the launch
    busy_fwd = device_busy_ms(lambda: ctc_alpha_cuda(lp, ll, lb, lbl), reps=20)
    busy_bwd = device_busy_ms(lambda: ctc_beta_cuda(lp, ll, lb, lbl, alpha, nll, ones), reps=20)
    log(f"ctc kernel-busy ms per launch (torch.profiler device time): forward {busy_fwd}, "
        f"backward {busy_bwd}")
    host_us = {}
    for what, fn in (("forward", lambda: ctc_alpha_cuda(lp, ll, lb, lbl)),
                     ("backward", lambda: ctc_beta_cuda(lp, ll, lb, lbl, alpha, nll, ones))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        host_us[what] = (time.perf_counter() - t0) / 1000 * 1e6
        torch.cuda.synchronize()
    log(f"ctc host time per wrapper call with the card idle (perf_counter over 1000 calls, "
        f"then one synchronise): forward {host_us['forward']:.2f} us, backward "
        f"{host_us['backward']:.2f} us")
    (fwd_bound, fwd_by, fwd_bytes, fwd_ops), (bwd_bound, bwd_by, bwd_bytes, bwd_ops) = ctc_bounds(
        ll_np, lbl_np, T, C, L)
    log(f"ctc time (ms, median, CUDA events): kernels forward {ms_fwd}, backward {ms_bwd}, "
        f"forward+backward {ms_both}; plain forward {plain_fwd}, backward {plain_bwd}, "
        f"forward+backward {plain_ms_both}; F.ctc_loss forward {lib_fwd}, backward {lib_bwd}, "
        f"forward+backward {lib_both}")
    log(f"ctc bound: forward {fwd_bytes} B, {fwd_ops} ops -> {fwd_bound:.6f} ms by {fwd_by}; "
        f"backward {bwd_bytes} B, {bwd_ops} ops -> {bwd_bound:.6f} ms by {bwd_by}; "
        f"dependent steps per launch: {int(ll_np.max()) - 1} forward, {int(ll_np.max())} backward")
    common = {"route": "cuda", "source": "megreader_tpu_torch/csrc/ctc.cu", "launches": 0}
    return [
        {"name": "ctc_alpha", **common, "replaces": "megreader_tpu/ops/pallas_ctc.py:69",
         "max_abs_err": fwd_err, "ms": ms_fwd, "plain_ms": plain_fwd, "bound_ms": fwd_bound,
         "bound_by": fwd_by, "library_ms": lib_fwd},
        {"name": "ctc_beta", **common, "replaces": "megreader_tpu/ops/pallas_ctc.py:95",
         "max_abs_err": bwd_err, "ms": ms_bwd, "plain_ms": plain_bwd, "bound_ms": bwd_bound,
         "bound_by": bwd_by, "library_ms": lib_bwd},
    ]


def ctc2d_inputs(rng, B: int, T: int, H: int, C: int = 37, L: int = 32):
    """Log-softmaxed emissions (B, T, H, C), transitions (B, T, H, H) and
    initial heights (B, H) with the label cases of ``ctc_inputs``: word-like
    label lengths, varied logit lengths, repeats, an empty label and rows
    without an alignment (32 labels in fewer steps; a run of one class that
    needs more than T steps). Returns numpy arrays and the aligned rows."""
    def log_softmax(x):
        x = x - x.max(-1, keepdims=True)
        return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)

    emit = log_softmax(2.0 * rng.standard_normal((B, T, H, C)))
    trans = log_softmax(rng.standard_normal((B, T, H, H)))
    init = log_softmax(rng.standard_normal((B, H)))
    logit_lengths = np.full(B, T, np.int32)
    logit_lengths[::5] = rng.integers(13, T, size=len(logit_lengths[::5]))
    label_lengths = rng.integers(1, 13, size=B).astype(np.int32)
    labels = np.zeros((B, L), np.int32)
    for b in range(B):
        labels[b, :label_lengths[b]] = rng.integers(1, C, size=label_lengths[b])
    labels[1, :6] = [5, 5, 5, 7, 7, 5]
    label_lengths[1] = 6
    labels[2], label_lengths[2] = 0, 0
    labels[3] = rng.integers(1, C, size=L)  # 32 labels in 24 steps
    label_lengths[3], logit_lengths[3] = L, 24
    run = (T + 1) // 2 + 1  # one class repeated: needs 2 * run - 1 > T steps
    labels[4] = 0
    labels[4, :run] = 9
    label_lengths[4], logit_lengths[4] = run, T
    logit_lengths[1:3] = T
    words = [labels[b, :label_lengths[b]] for b in range(B)]
    repeats = np.array([int((w[1:] == w[:-1]).sum()) for w in words])
    possible = label_lengths + repeats <= logit_lengths
    assert not possible[3] and not possible[4] and possible.sum() > B // 2
    return emit, trans, init, logit_lengths, labels, label_lengths, possible


def ctc2d_bounds(logit_lengths, label_lengths, T: int, H: int, C: int, L: int):
    """(forward, backward) least times in ms and what bounds each: every input
    read once and every output written once at the HBM rate, against the
    arithmetic of the (h, s) cells this run's lengths make live at the
    float32 rate. Per live cell and step, forward: the label move (about 10
    operations: three exps, a log, maxes, sums) and the contraction over H
    previous heights (about 4 H: adds, maxes, exps, sums) and the emission;
    backward: the backward label move and contraction, the alpha label move
    the transition gradient needs, the emission gradient's exp and add, and
    H transition terms (about 27 + 7 H)."""
    B = len(logit_lengths)
    S = 2 * L + 1
    lens = np.clip(logit_lengths, 1, T).astype(np.int64)
    states = 2 * label_lengths.astype(np.int64) + 1
    emit_b, trans_b, alpha_b = B * T * H * C * 4, B * T * H * H * 4, B * T * H * S * 4
    ints = B * L * 4 + 2 * B * 4
    fwd_bytes = emit_b + trans_b + B * H * 4 + ints + alpha_b + B * 4
    bwd_bytes = emit_b + trans_b + ints + alpha_b + 2 * B * 4 + emit_b + trans_b
    fwd_ops = (12 + 4 * H) * H * int(((lens - 1) * states).sum())
    bwd_ops = (27 + 7 * H) * H * int((lens * states).sum())
    out = []
    for nbytes, ops in ((fwd_bytes, fwd_ops), (bwd_bytes, bwd_ops)):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        out.append((max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
                    nbytes, ops))
    return out


def phase_ctc2d():
    """Both 2D-CTC kernels against the plain version on the card, at config
    #2's shape (H 4, T 25) and the curved A/B shape (H 6, T 40); times and
    bounds at config #2's shape."""
    from megreader_tpu_torch.ops.ctc2d import (
        _shared_bytes,
        ctc2d_alpha_cuda,
        ctc2d_beta_cuda,
        ctc2d_beta_reference,
        ctc2d_loss_markov,
        ctc2d_nll_markov_reference,
    )
    from megreader_tpu_torch.ops.ctc import _reduce

    B, C, L = 64, 37, 32
    errs = {}
    timed = None
    for name, T, H in (("config #2", 25, 4), ("curved", 40, 6)):
        rng = np.random.default_rng(SEED + 8 + T)
        *floats, ll_np, lb_np, lbl_np, possible = ctc2d_inputs(rng, B, T, H, C, L)
        emit, trans, init = (torch.from_numpy(a).cuda() for a in floats)
        ll, lb, lbl = (torch.from_numpy(a).cuda() for a in (ll_np, lb_np, lbl_np))
        ok = torch.from_numpy(possible).cuda()

        # forward: loss rtol 1e-4 / atol 1e-4 (a log-space DP summed in
        # another order)
        nll, alpha = ctc2d_alpha_cuda(emit, trans, init, ll, lb, lbl)
        ref = ctc2d_nll_markov_reference(emit, trans, init, ll, lb, lbl)
        torch.cuda.synchronize()
        fwd_err = float((nll - ref)[ok].abs().max())
        log(f"ctc2d {name} (B {B}, T {T}, H {H}, C {C}, L {L}) forward: max |kernel - plain| "
            f"on rows with an alignment {fwd_err:.3g}; rows without one: kernel "
            f"{nll[~ok].tolist()}, plain {ref[~ok].tolist()}")
        if not torch.allclose(nll, ref, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"ctc2d alpha kernel disagrees with the plain version ({name})")
        if not (torch.isfinite(nll).all() and bool((nll[~ok] > 1e29).all())):
            raise AssertionError("ctc2d: a row without an alignment must give a finite ~1e30 loss")

        # backward: emission, transition and initial-height gradients against
        # autograd through the plain DP, rtol 1e-3 / atol 1e-4, for a
        # weighted sum of the rows' losses
        gw = torch.from_numpy(rng.uniform(0.5, 2.0, B).astype(np.float32)).cuda()
        grads = ctc2d_beta_cuda(emit, trans, ll, lb, lbl, alpha, nll, gw)
        leaves = [t.detach().clone().requires_grad_() for t in (emit, trans, init)]
        (ctc2d_nll_markov_reference(*leaves, ll, lb, lbl) * gw).sum().backward()
        plain_beta = ctc2d_beta_reference(emit, trans, ll, lb, lbl, alpha, nll, gw)
        again = ctc2d_beta_cuda(emit, trans, ll, lb, lbl, alpha, nll, gw)
        torch.cuda.synchronize()
        bwd_err = 0.0
        for what, got, leaf, plain in zip(("emit", "trans", "init"), grads, leaves, plain_beta):
            err = float((got - leaf.grad).abs().max())
            err_plain = float((got - plain).abs().max())
            bwd_err = max(bwd_err, err)
            log(f"ctc2d {name} backward: max |kernel - plain| of d nll / d {what} {err:.3g} "
                f"(autograd), {err_plain:.3g} (plain beta, ctc2d_beta_reference)")
            if not torch.allclose(got, leaf.grad, rtol=1e-3, atol=1e-4):
                raise AssertionError(f"ctc2d beta kernel: {what} gradient disagrees ({name})")
            if not torch.allclose(got, plain, rtol=1e-3, atol=1e-4):
                raise AssertionError(f"ctc2d beta kernel: {what} gradient disagrees with the "
                                     f"plain beta ({name})")
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"ctc2d beta kernel: two launches differ ({name})")
        # rows with no alignment: the XLA scan's pattern, -1/(2H) on the two
        # terminal states' classes at the last step, -1/H^2 on its transitions
        expect_e = torch.zeros_like(emit)
        expect_t = torch.zeros_like(trans)
        for b in np.flatnonzero(~possible):
            t_last = int(ll_np[b]) - 1
            expect_e[b, t_last, :, 0] -= 0.5 / H * gw[b]
            expect_e[b, t_last, :, int(lb_np[b, lbl_np[b] - 1])] -= 0.5 / H * gw[b]
            expect_t[b, t_last] = -1.0 / H**2 * gw[b]
        if not (torch.allclose(grads[0][~ok], expect_e[~ok], rtol=0, atol=1e-6)
                and torch.allclose(grads[1][~ok], expect_t[~ok], rtol=0, atol=1e-6)
                and bool((grads[2][~ok] == 0).all())):
            raise AssertionError(f"ctc2d beta kernel: rows without an alignment ({name})")
        log(f"ctc2d {name} backward: two launches bitwise equal; rows without an alignment "
            f"carry the XLA scan's pattern; shared memory (alpha, beta) "
            f"{_shared_bytes(T, H, L, C)} B")

        # the loss through the autograd Function, mean reduction
        x = [t.clone().requires_grad_() for t in (emit, trans, init)]
        loss = ctc2d_loss_markov(*x, ll, lb, lbl)
        loss.backward()
        x_ref = [t.clone().requires_grad_() for t in (emit, trans, init)]
        loss_ref = _reduce(ctc2d_nll_markov_reference(*x_ref, ll, lb, lbl), lbl, "mean")
        loss_ref.backward()
        diff = max(float((a.grad - r.grad).abs().max()) for a, r in zip(x, x_ref))
        log(f"ctc2d {name} loss (mean): kernels {loss.item()}, plain {loss_ref.item()}; "
            f"gradient max |diff| {diff:.3g}")
        if not (torch.allclose(loss, loss_ref, rtol=1e-4, atol=1e-4) and all(
                torch.allclose(a.grad, r.grad, rtol=1e-3, atol=1e-4) for a, r in zip(x, x_ref))):
            raise AssertionError(f"ctc2d loss through the kernels disagrees ({name})")
        errs[name] = (fwd_err, bwd_err)
        if timed is None:
            timed = (emit, trans, init, ll, lb, lbl, alpha, nll, leaves, T, H, ll_np, lbl_np)

    emit, trans, init, ll, lb, lbl, alpha, nll, leaves, T, H, ll_np, lbl_np = timed
    ones = torch.ones(B, device="cuda")
    ms_fwd = cuda_ms(lambda: ctc2d_alpha_cuda(emit, trans, init, ll, lb, lbl), reps=100)
    ms_bwd = cuda_ms(lambda: ctc2d_beta_cuda(emit, trans, ll, lb, lbl, alpha, nll, ones),
                     reps=100)
    with torch.no_grad():
        plain_fwd = cuda_ms(lambda: ctc2d_nll_markov_reference(emit, trans, init, ll, lb, lbl),
                            reps=20)
    out_ref = ctc2d_nll_markov_reference(*leaves, ll, lb, lbl).sum()
    plain_bwd = cuda_ms(lambda: torch.autograd.grad(out_ref, leaves, retain_graph=True), reps=20)
    busy_fwd = device_busy_ms(lambda: ctc2d_alpha_cuda(emit, trans, init, ll, lb, lbl), reps=20)
    busy_bwd = device_busy_ms(
        lambda: ctc2d_beta_cuda(emit, trans, ll, lb, lbl, alpha, nll, ones), reps=20)
    host_us = {}
    for what, fn in (("forward", lambda: ctc2d_alpha_cuda(emit, trans, init, ll, lb, lbl)),
                     ("backward", lambda: ctc2d_beta_cuda(emit, trans, ll, lb, lbl, alpha, nll,
                                                          ones))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        host_us[what] = (time.perf_counter() - t0) / 1000 * 1e6
        torch.cuda.synchronize()
    log(f"ctc2d host time per wrapper call with the card idle (perf_counter over 1000 calls, "
        f"then one synchronise): forward {host_us['forward']:.2f} us, backward "
        f"{host_us['backward']:.2f} us")
    (fwd_bound, fwd_by, fwd_bytes, fwd_ops), (bwd_bound, bwd_by, bwd_bytes, bwd_ops) = \
        ctc2d_bounds(ll_np, lbl_np, T, H, C, L)
    log(f"ctc2d time at config #2's shape (ms, median, CUDA events): kernels forward {ms_fwd}, "
        f"backward {ms_bwd}; plain forward {plain_fwd}, backward {plain_bwd}; kernel-busy "
        f"(torch.profiler device time) forward {busy_fwd}, backward {busy_bwd}")
    log(f"ctc2d bound: forward {fwd_bytes} B, {fwd_ops} ops -> {fwd_bound:.6f} ms by {fwd_by}; "
        f"backward {bwd_bytes} B, {bwd_ops} ops -> {bwd_bound:.6f} ms by {bwd_by}; "
        f"dependent steps per launch: {int(ll_np.max()) - 1} forward, {int(ll_np.max())} "
        f"backward; library: none (no single PyTorch call computes the Markov 2D-CTC)")
    common = {"route": "cuda", "source": "megreader_tpu_torch/csrc/ctc2d.cu", "launches": 0,
              "library_ms": None}
    return [
        {"name": "ctc2d_alpha", **common, "replaces": "megreader_tpu/ops/pallas_ctc2d.py:58",
         "max_abs_err": max(e[0] for e in errs.values()), "ms": ms_fwd, "plain_ms": plain_fwd,
         "bound_ms": fwd_bound, "bound_by": fwd_by},
        {"name": "ctc2d_beta", **common, "replaces": "megreader_tpu/ops/pallas_ctc2d.py:94",
         "max_abs_err": max(e[1] for e in errs.values()), "ms": ms_bwd, "plain_ms": plain_bwd,
         "bound_ms": bwd_bound, "bound_by": bwd_by},
    ]


def seeded_weights(module: torch.nn.Module, seed: int) -> None:
    """Fill every parameter and BN statistic from a numpy generator."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith("running_var"):
                a = rng.uniform(0.5, 1.5, t.shape)
            elif name.endswith("running_mean"):
                a = 0.05 * rng.standard_normal(t.shape)
            elif t.dim() == 1:
                base = 1.0 if name.endswith("weight") else 0.0  # BN scale
                a = base + 0.05 * rng.standard_normal(t.shape)
            else:
                fan_in = int(np.prod(t.shape[1:]))
                a = rng.standard_normal(t.shape) * np.sqrt(2.0 / fan_in)
            t.copy_(torch.from_numpy(a.astype(np.float32)))


def make_pages(rng, B: int, H: int, W: int) -> np.ndarray:
    """Light pages with dark word-like rectangles and a little noise."""
    words = text_masks(rng, B, H, W, n=25)
    pages = 220.0 + 20.0 * rng.standard_normal((B, H, W, 3))
    pages[words] = 40.0 + 20.0 * rng.standard_normal((int(words.sum()), 3))
    return np.clip(pages, 0, 255).astype(np.float32)


def calibrate_prob_head(pipe, det_net, pages) -> None:
    """Random weights give saturated prob maps. Rescale the head's last conv so
    that its logits on these pages have std 2 and 20% of the pixels lie above
    ``bin_thresh``: blobs for the CCL, margins for the comparisons."""
    up2 = det_net.prob_head.up2
    seen = []
    hook = up2.register_forward_hook(lambda mod, inp, out: seen.append(out))
    with torch.no_grad():
        pipe.detect(det_net, pages)
        hook.remove()
        z = seen[0][:, 0, ::4, ::4].reshape(-1)
        a = 2.0 / z.std()
        c = torch.logit(torch.tensor(pipe.bin_thresh)).item() - a * torch.quantile(z, 0.8)
        up2.weight.mul_(a)
        up2.bias.mul_(a).add_(c)
        frac = float((pipe.detect(det_net, pages) > pipe.bin_thresh).float().mean())
    log(f"prob head calibrated: logit scale {float(a):.4g}, foreground {frac:.3f}")


def cross_check(pipe, det_net, rec_net, pages_np, device="cuda") -> None:
    """Each stage of the path on ``device`` against the same stage on the CPU
    (plain versions), both fed the CPU's output of the stage before. Float
    tolerances are relative to the reference's magnitude (f32 sums in
    another order, TF32 off)."""
    det_cpu = copy.deepcopy(det_net).cpu()
    rec_cpu = copy.deepcopy(rec_net).cpu()
    pg = torch.from_numpy(pages_np)
    diffs = {}

    def compare(what, got, ref, tol):
        d = float((got.cpu() - ref).abs().max()) if ref.numel() else 0.0
        scale = max(1.0, float(ref.abs().max())) if ref.numel() else 1.0
        diffs[what] = d
        if not d <= tol * scale:
            raise AssertionError(f"e2e cross-check: {what} differs by {d} > {tol} x {scale}")

    with torch.no_grad():
        prob = pipe.detect(det_cpu, pg)
        compare("prob", pipe.detect(det_net, pg.to(device)), prob, 1e-3)
        labels = pipe.label(prob)
        if not torch.equal(pipe.label(prob.to(device)).cpu(), labels):
            raise AssertionError("e2e cross-check: labels differ")
        reg = pipe.regions(labels, prob)
        reg_d = pipe.regions(labels.to(device), prob.to(device))
        if not torch.equal(reg_d["valid"].cpu(), reg["valid"]):
            raise AssertionError("e2e cross-check: valid slots differ")
        found = reg["stats"]["valid"]
        if not found.any():
            raise AssertionError("e2e cross-check: no region in the input")
        compare("quads_px", reg_d["quads"][found.to(device)], reg["quads"][found], 1e-5)
        crops = pipe.crops(pg, reg)
        crops_d = pipe.crops(pg.to(device), {k: reg[k].to(device) for k in ("quads", "boxes")})
        keep = found.reshape(-1)
        compare("crops", crops_d[keep.to(device)], crops[keep], 1e-4)
        decoded = check_recognizer(pipe, rec_net, rec_cpu, crops[keep], compare, device)
    log(f"e2e cross-check ({device} vs CPU, pages {tuple(pg.shape)}, {int(found.sum())} "
        f"regions, {int(reg['valid'].sum())} valid, rec_mode {pipe.rec_mode}): max abs diff "
        + json.dumps(diffs) + decoded)


def check_recognizer(pipe, rec_net, rec_cpu, x, compare, device) -> str:
    """The recognizer stage of ``cross_check`` on crops ``x`` (on the CPU):
    its float outputs on ``device`` against the CPU's, then the ids of the
    pipeline's decode. A CTC beam decodes the CPU's logits on both devices
    (ids equal on every crop); the attention family's teacher-forced logits
    follow the CPU's greedy ids, and its ids must equal the CPU's on every
    crop that the CPU decides by a clear margin (``attention_margins``).
    Returns a note for the log line."""
    from megreader_tpu_torch.models.attention import AttentionRecognizer
    from megreader_tpu_torch.ops.ctc import ctc_beam_decode

    rec = pipe.recognizer
    rec_net.eval()
    rec_cpu.eval()
    if not isinstance(rec, AttentionRecognizer):
        logits = rec_cpu(x)
        compare("logits", rec_net(x.to(device)), logits, 1e-4)
        if pipe.rec_mode != "beam":
            return ""
        lengths = torch.full((len(x),), logits.shape[1], dtype=torch.int32)
        ref = ctc_beam_decode(logits, lengths, beam_width=pipe.beam_width)
        got = ctc_beam_decode(logits.to(device), lengths.to(device), beam_width=pipe.beam_width)
        if not all(torch.equal(g.cpu(), r) for g, r in zip(got, ref)):
            raise AssertionError("e2e cross-check: the CTC beam's ids differ from the CPU's")
        return f"; CTC beam (W {pipe.beam_width}) ids on the CPU's logits equal on {len(x)} crops"
    ids_cpu, lengths_cpu, clear = attention_margins(rec, rec_cpu, x, pipe.rec_mode,
                                                    pipe.beam_width)
    go = torch.full((len(x), 1), 1, dtype=torch.int64)  # AttentionCharset.GO
    targets_in = torch.cat([go, ids_cpu[:, :-1].long()], 1)
    compare("logits", rec_net(x.to(device), targets_in.to(device)), rec_cpu(x, targets_in), 1e-4)
    ids, lengths = pipe.recognize(rec_net, x.to(device))
    same = (ids.cpu() == ids_cpu).all(1) & (lengths.cpu() == lengths_cpu)
    if not bool(same[clear].all()):
        raise AssertionError(f"e2e cross-check: attention {pipe.rec_mode} ids differ from the "
                             f"CPU's on {int((~same & clear).sum())} clear-margin crops")
    return (f"; attention {pipe.rec_mode} ids equal on {int(same.sum())} of {len(x)} crops, "
            f"{int(clear.sum())} of them clear-margin (all equal)")


def phase_e2e():
    from megreader_tpu_torch.models.detector import SegDetector
    from megreader_tpu_torch.models.recognizer import CTCRecognizer
    from megreader_tpu_torch.ops.ccl import (
        connected_components_cuda,
        connected_components_reference,
    )
    from megreader_tpu_torch.pipelines.e2e import E2EPipeline

    rng = np.random.default_rng(SEED + 1)
    det = SegDetector(device="cuda")
    rec = CTCRecognizer(num_classes=37, device="cuda")
    seeded_weights(det.net, SEED + 2)
    seeded_weights(rec.net, SEED + 3)
    B, H, W = 8, 640, 640
    pages_np = make_pages(rng, B, H, W)
    pages = torch.from_numpy(pages_np).cuda()
    pipe = E2EPipeline(det, rec, max_regions=32, rectify="perspective", ccl_iters=24,
                       box_thresh=0.3, device="cuda")

    calibrate_prob_head(pipe, det.net, pages)
    cross_check(pipe, det.net, rec.net, pages_np[:2, :128, :128])
    cross_check(pipe, det.net, rec.net, pages_np[:1])  # one page at the timed size

    pipe.predict(None, None, pages)  # warm-up
    torch.cuda.synchronize()
    reps = 5
    connected_components_cuda.launches = 0
    t0 = time.perf_counter()
    for _ in range(reps):
        results = pipe.predict(None, None, pages)
    wall = time.perf_counter() - t0
    launches = connected_components_cuda.launches
    log(f"e2e: {reps} batches of {B} pages, ccl kernel launches {launches}, "
        f"{B * reps / wall:.2f} pages/s (host clock, predict incl. host decode)")
    if launches != reps:
        raise AssertionError(f"ccl kernel launched {launches} times for {reps} batches")

    out = pipe.run(None, None, pages)
    K = pipe.max_regions
    shapes = {"ids": (B, K, 25), "lengths": (B, K), "quads": (B, K, 4, 2),
              "boxes": (B, K, 4), "scores": (B, K), "valid": (B, K)}
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"e2e {key} shape {tuple(out[key].shape)} != {shape}")
    valid = out["valid"]
    for key in ("quads", "boxes", "scores"):
        if not torch.isfinite(out[key][valid]).all():
            raise AssertionError(f"e2e {key} not finite on valid slots")
    n_valid = int(valid.sum())
    if n_valid == 0:
        raise AssertionError("e2e found no valid region on any page")
    log(f"e2e: {n_valid} valid regions, first page texts {[r['text'] for r in results[0]][:8]}")

    # per-stage device time, CUDA events, stages fed the previous stage's output
    with torch.no_grad():
        prob = pipe.detect(det.net, pages)
        labels = pipe.label(prob)
        reg = pipe.regions(labels, prob)
        crops = pipe.crops(pages, reg)
        stages = {
            "detector": lambda: pipe.detect(det.net, pages),
            "ccl": lambda: pipe.label(prob),
            "extract": lambda: pipe.regions(labels, prob),
            "rectify": lambda: pipe.crops(pages, reg),
            "recognizer": lambda: pipe.recognize(rec.net, crops),
        }
        stage_ms = {k: cuda_ms(f, reps=10) for k, f in stages.items()}
        busy_ms = {k: device_busy_ms(f) for k, f in stages.items()}
        run_ms = cuda_ms(lambda: pipe.run(None, None, pages), reps=5)
        run_busy = device_busy_ms(lambda: pipe.run(None, None, pages))
        _, sweeps = connected_components_reference(prob > pipe.bin_thresh, pipe.ccl_iters,
                                                   return_sweeps=True)
    log(f"e2e ccl stage: {stage_ms['ccl']} ms by CUDA events, {busy_ms['ccl']} ms kernel-busy; "
        f"sweeps per page {sweeps.tolist()}")
    total = sum(stage_ms.values())
    log("e2e stage ms (median, CUDA events): " + json.dumps(stage_ms)
        + f", sum {total:.3f} ms = {B / total * 1e3:.2f} pages/s")
    log("e2e stage kernel-busy ms (torch.profiler device time, None = no device "
        "time in the trace): " + json.dumps(busy_ms))
    idle = "not measured" if run_busy is None else f"{1.0 - run_busy / run_ms:.4f}"
    log(f"e2e run: {run_ms} ms per batch of {B} (CUDA events) = {B / run_ms * 1e3:.2f} "
        f"pages/s; kernel-busy {run_busy} ms; device idle share {idle}")
    extract_launches = e2e_extract_impls(pipe, det, rec, pages, out, labels, prob,
                                         (stage_ms["extract"], busy_ms["extract"], run_ms))
    return launches, extract_launches


def e2e_extract_impls(pipe, det, rec, pages, ref, labels, prob, xla_times):
    """One serving batch with each Pallas-path extraction (the CUDA extraction
    kernels): one launch of each kernel the impl runs, the CCL once; valid
    slots equal to the 'xla' batch's on the same pages and quads within 1e-2
    px of them; the extract stage's and the batch's times. Returns each
    extraction kernel's launches in those two batches."""
    from megreader_tpu_torch.ops import extract as ex
    from megreader_tpu_torch.ops.ccl import connected_components_cuda
    from megreader_tpu_torch.pipelines.e2e import E2EPipeline

    kernels = {"ccl": connected_components_cuda, "candidates": ex.candidates_cuda,
               "moments": ex.moments_cuda, "extents": ex.extents_cuda}
    totals = dict.fromkeys(("candidates", "moments", "extents"), 0)
    times = {"xla": xla_times}
    for impl in ("pallas", "pallas_full"):
        p2 = E2EPipeline(det, rec, max_regions=pipe.max_regions, rectify="perspective",
                         ccl_iters=pipe.ccl_iters, box_thresh=pipe.box_thresh, device="cuda",
                         extract_impl=impl)
        for k in kernels.values():
            k.launches = 0
        out = p2.run(None, None, pages)
        torch.cuda.synchronize()
        got = {name: k.launches for name, k in kernels.items()}
        want = {"ccl": 1, "candidates": int(impl == "pallas_full"), "moments": 1, "extents": 1}
        valid = ref["valid"]
        qdiff = float((out["quads"][valid] - ref["quads"][valid]).abs().max())
        log(f"e2e extract_impl={impl}: launches {got}; valid slots equal to the xla batch's: "
            f"{torch.equal(out['valid'], valid)} ({int(valid.sum())}); quads max |diff| "
            f"{qdiff:.3g} px")
        if got != want:
            raise AssertionError(f"e2e {impl}: kernel launches {got}, expected {want}")
        if not torch.equal(out["valid"], valid) or not qdiff <= 1e-2:
            raise AssertionError(f"e2e {impl}: regions differ from the xla batch's")
        for name in totals:
            totals[name] += got[name]
        with torch.no_grad():
            times[impl] = (cuda_ms(lambda: p2.regions(labels, prob), reps=10),
                           device_busy_ms(lambda: p2.regions(labels, prob)),
                           cuda_ms(lambda: p2.run(None, None, pages), reps=5))
    B = pages.shape[0]
    log("e2e by extract_impl (extract stage ms by CUDA events, its kernel-busy ms, batch ms by "
        "CUDA events, pages/s): " + json.dumps(
            {k: {"extract_ms": t[0], "extract_busy_ms": t[1], "run_ms": t[2],
                 "pages_per_s": B / t[2] * 1e3} for k, t in times.items()}))
    return totals


class WordCrops:
    """Numpy-made word crops with the item contract of the port's
    ``SyntheticRecognitionDataset``: {"image": (64, 256, 3) uint8 canvas with
    the crop at its top left, "size": (h, w) int32, "text": 3-10 characters}.
    Each character is a fixed random 20x10 glyph, bright on dark noise."""

    ALPHABET = "0123456789abcdefghijklmnopqrstuvwxyz"

    def __init__(self, n: int, seed: int, canvas_hw=(64, 256)):
        self.n = n
        self.seed = seed
        self.canvas_hw = canvas_hw
        self.glyphs = np.random.default_rng(seed).random((len(self.ALPHABET), 20, 10)) < 0.45

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        rng = np.random.default_rng(self.seed * 1_000_003 + i)
        ids = rng.integers(0, len(self.ALPHABET), int(rng.integers(3, 11)))
        left, top, right, bottom = (int(v) for v in rng.integers(0, 6, 4))
        h, w = 20 + top + bottom, 10 * len(ids) + left + right
        crop = rng.integers(0, 50, (h, w, 3), dtype=np.uint8)
        for j, c in enumerate(ids):
            crop[top:top + 20, left + 10 * j:left + 10 * j + 10][self.glyphs[c]] = 235
        canvas = np.zeros((*self.canvas_hw, 3), np.uint8)
        canvas[:h, :w] = crop
        return {"image": canvas, "size": np.array([h, w], np.int32),
                "text": "".join(self.ALPHABET[c] for c in ids)}


def adam_warmup_cosine():
    """The optimizer of configs #1 and #2: Adam at lr 1e-3, 200 warm-up steps
    of a 20 000-step cosine."""
    from megreader_tpu_torch.train.train_step import OptimizerConfig

    return OptimizerConfig(name="adam", lr=1e-3, schedule="warmup_cosine", warmup_steps=200,
                           total_steps=20_000)


def phase_train():
    from megreader_tpu_torch.experiment import Experiment
    from megreader_tpu_torch.models.recognizer import CTCRecognizer
    from megreader_tpu_torch.ops.ctc import (
        ctc_alpha_cuda,
        ctc_beta_cuda,
        ctc_loss,
        ctc_loss_reference,
    )
    from megreader_tpu_torch.train.checkpoint import CheckpointManager
    from megreader_tpu_torch.train.train_step import create_train_state, make_train_step

    B, per_epoch, epochs = 64, 4, 6
    steps = per_epoch * epochs
    opt = adam_warmup_cosine()
    data = WordCrops(B * per_epoch, SEED + 5)
    rec = CTCRecognizer(num_classes=37, device="cuda")
    seeded_weights(rec.net, SEED + 6)

    with tempfile.TemporaryDirectory() as ws:
        def experiment(model, n_epochs):
            return Experiment(model, data, optimizer=opt, workspace=ws, batch_size=B,
                              epochs=n_epochs, log_every=1)

        exp = experiment(rec, epochs)
        ctc_alpha_cuda.launches = 0
        ctc_beta_cuda.launches = 0
        t0 = time.perf_counter()
        state = exp.make_trainer().train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (ctc_alpha_cuda.launches, ctc_beta_cuda.launches)
        with open(os.path.join(ws, "train_metrics.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f]
        first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        log(f"train: {state.step} steps of {B} crops in {wall:.2f} s (host clock, loader, "
            f"logging and checkpoint included); CTC kernel launches {launches}; loss mean "
            f"of the first 5 steps {first:.4f}, of the last 5 {last:.4f}; losses {losses}")
        if state.step != steps or len(losses) != steps:
            raise AssertionError(f"train ran {state.step} steps and logged {len(losses)}, not {steps}")
        if not all(np.isfinite(losses)) or not last < first:
            raise AssertionError("train: losses must be finite and fall")
        if launches != (steps, steps):
            raise AssertionError(f"CTC kernels launched {launches} times in {steps} steps")

        # a fresh model restores the checkpoint at the last step and trains on
        rec2 = CTCRecognizer(num_classes=37, device="cuda")
        seeded_weights(rec2.net, SEED + 7)
        restored = CheckpointManager(ws).restore(create_train_state(rec2, opt))
        same = all(torch.equal(a, b) for a, b in zip(rec.net.state_dict().values(),
                                                    rec2.net.state_dict().values()))
        if restored.step != steps or restored.optimizer.count != steps or not same:
            raise AssertionError("train: the checkpoint did not restore the trained state")
        resumed = experiment(rec2, epochs + 1).make_trainer().train(resume=True)
        if resumed.step != steps + per_epoch or ctc_alpha_cuda.launches != launches[0] + per_epoch:
            raise AssertionError(f"train: resume ended at step {resumed.step}")
        log(f"train: restored step {restored.step} into a fresh model, resumed to {resumed.step}")

    raw = exp.collate([data[i] for i in range(B)])
    batch = exp.prepare(raw)

    # one step's loss and gradients through the kernels against the plain loss,
    # the same weights and batch, TF32 off, deterministic cuDNN
    torch.backends.cudnn.deterministic = True
    net = rec.net

    def loss_and_grads(loss_fn):
        net.zero_grad(set_to_none=True)
        net.train()
        logits = net(batch["image"])
        lengths = torch.full((B,), logits.shape[1], dtype=torch.int32, device="cuda")
        loss = loss_fn(logits, lengths, batch["label"], batch["label_length"])
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in net.named_parameters()}

    loss_k, grads_k = loss_and_grads(ctc_loss)
    loss_r, grads_r = loss_and_grads(ctc_loss_reference)
    torch.backends.cudnn.deterministic = False
    rel = max(float((grads_k[n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
              for n, g in grads_r.items())
    log(f"train one-step parity: loss kernels {loss_k}, plain {loss_r}; worst gradient leaf "
        f"max |diff| / max |plain| {rel:.3g} over {len(grads_r)} leaves")
    if abs(loss_k - loss_r) > 1e-4:
        raise AssertionError("train: the kernel loss disagrees with the plain loss")
    for n, g in grads_r.items():
        if not torch.allclose(grads_k[n], g, rtol=1e-3, atol=1e-6):
            raise AssertionError(f"train: gradient of {n} disagrees with the plain loss's")

    # time of a step and its parts (CUDA events, median of 10 after 3 warm-up)
    state = create_train_state(rec, opt)

    def loss_fn(logits, b):
        lengths = torch.full((B,), logits.shape[1], dtype=torch.int32, device="cuda")
        return ctc_loss(logits, lengths, b["label"], b["label_length"])

    split = step_split(exp, raw, net, loss_fn, state.optimizer,
                       ("prepare", "forward", "ctc_forward", "backward", "optimizer"))
    step_fn = make_train_step(rec, prepare=exp.prepare)
    busy = device_busy_ms(lambda: step_fn(state, raw))
    step_ms = cuda_ms(lambda: step_fn(state, raw), reps=10)
    idle = "not measured" if busy is None else f"{1.0 - busy / step_ms:.4f}"
    log("train step split (ms, median of 10, CUDA events): " + json.dumps(split)
        + f"; {B / split['step'] * 1e3:.1f} crops/s")
    log(f"train step (make_train_step, CUDA events, median of 10): {step_ms} ms = "
        f"{B / step_ms * 1e3:.1f} crops/s; kernel-busy {busy} ms; device idle share {idle}")
    return launches


def step_split(exp, raw, net, loss_fn, optimizer, parts):
    """Median ms of each part of a train step (CUDA events, 10 after 3
    warm-up): prepare, forward, loss, backward, optimizer; plus the step."""
    times = {k: [] for k in parts + ("step",)}
    for rep in range(13):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        b = exp.prepare(raw)
        ev[1].record()
        net.train()
        out = net(b["image"])
        ev[2].record()
        loss = loss_fn(out, b)
        ev[3].record()
        loss.backward()
        ev[4].record()
        optimizer.step()
        optimizer.zero_grad()
        ev[5].record()
        ev[5].synchronize()
        if rep >= 3:
            for k, (a, e) in zip(parts, zip(ev[:-1], ev[1:])):
                times[k].append(a.elapsed_time(e))
            times["step"].append(ev[0].elapsed_time(ev[5]))
    return {k: statistics.median(v) for k, v in times.items()}


def phase_train2d():
    """Config #2 with Markov heights at full width through Experiment/Trainer,
    then independent heights for a few steps; returns the 2D kernels'
    launches in the Markov run."""
    from megreader_tpu_torch.experiment import Experiment
    from megreader_tpu_torch.models.recognizer2d import Ctc2dRecognizer
    from megreader_tpu_torch.ops import ctc, ctc2d
    from megreader_tpu_torch.train.checkpoint import CheckpointManager
    from megreader_tpu_torch.train.train_step import create_train_state, make_train_step

    B, per_epoch, epochs = 64, 4, 6
    steps = per_epoch * epochs
    opt = adam_warmup_cosine()
    data = WordCrops(B * per_epoch, SEED + 9)
    eval_data = WordCrops(B, SEED + 10)
    rec = Ctc2dRecognizer(num_classes=37, transition="markov", device="cuda")
    seeded_weights(rec.net, SEED + 11)
    kernels_1d = (ctc.ctc_alpha_cuda, ctc.ctc_beta_cuda)
    kernels_2d = (ctc2d.ctc2d_alpha_cuda, ctc2d.ctc2d_beta_cuda)

    def zero_counts():
        for k in kernels_1d + kernels_2d:
            k.launches = 0

    def counts(ks):
        return tuple(k.launches for k in ks)

    with tempfile.TemporaryDirectory() as ws:
        def experiment(model, n_epochs, **kw):
            return Experiment(model, data, optimizer=opt, workspace=ws, batch_size=B,
                              epochs=n_epochs, log_every=1, **kw)

        exp = experiment(rec, epochs, eval_dataset=eval_data, validate_every_steps=steps)
        zero_counts()
        t0 = time.perf_counter()
        state = exp.make_trainer().train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, launches_1d = counts(kernels_2d), counts(kernels_1d)
        with open(os.path.join(ws, "train_metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        losses = [r["loss"] for r in lines if "loss" in r]
        evals = [r for r in lines if "eval/accuracy" in r]
        first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        log(f"train2d (config #2, Markov heights): {state.step} steps of {B} crops in {wall:.2f} s "
            f"(host clock, loader, logging, checkpoint and one validation included); 2D-CTC "
            f"kernel launches {launches}, 1-D CTC kernel launches {launches_1d}; loss mean of "
            f"the first 5 steps {first:.4f}, of the last 5 {last:.4f}; losses {losses}")
        if state.step != steps or len(losses) != steps:
            raise AssertionError(f"train2d ran {state.step} steps and logged {len(losses)}")
        if not all(np.isfinite(losses)) or not last < first:
            raise AssertionError("train2d: losses must be finite and fall")
        if launches != (steps, steps) or launches_1d != (0, 0):
            raise AssertionError(f"train2d: 2D kernels launched {launches}, 1-D {launches_1d} "
                                 f"times in {steps} steps")
        if len(evals) != 1 or evals[0]["step"] != steps or evals[0]["eval/n"] != B:
            raise AssertionError(f"train2d: expected one validation at step {steps}: {evals}")
        log(f"train2d validation (evaluate_recognition, Viterbi decode, {B} crops) at step "
            f"{steps}: accuracy {evals[0]['eval/accuracy']}, ned {evals[0]['eval/ned']}")

        rec2 = Ctc2dRecognizer(num_classes=37, transition="markov", device="cuda")
        seeded_weights(rec2.net, SEED + 12)
        restored = CheckpointManager(ws).restore(create_train_state(rec2, opt))
        same = all(torch.equal(a, b) for a, b in zip(rec.net.state_dict().values(),
                                                    rec2.net.state_dict().values()))
        if restored.step != steps or restored.optimizer.count != steps or not same:
            raise AssertionError("train2d: the checkpoint did not restore the trained state")
        resumed = experiment(rec2, epochs + 1).make_trainer().train(resume=True)
        if resumed.step != steps + per_epoch or kernels_2d[0].launches != steps + per_epoch:
            raise AssertionError(f"train2d: resume ended at step {resumed.step}")
        log(f"train2d: restored step {restored.step} into a fresh model, resumed to "
            f"{resumed.step}")

    with tempfile.TemporaryDirectory() as ws:
        ind = Ctc2dRecognizer(num_classes=37, transition="independent", device="cuda")
        seeded_weights(ind.net, SEED + 13)
        zero_counts()
        st = Experiment(ind, data, optimizer=opt, workspace=ws, batch_size=B, epochs=1,
                        log_every=1).make_trainer().train()
        got = (counts(kernels_1d), counts(kernels_2d))
        log(f"train2d (independent heights): {st.step} steps; 1-D CTC kernel launches "
            f"{got[0]}, 2D-CTC {got[1]}")
        if st.step != per_epoch or got != ((per_epoch, per_epoch), (0, 0)):
            raise AssertionError("train2d: independent heights must launch the 1-D CTC kernels "
                                 "once per step and no 2D kernel")

    raw = exp.collate([data[i] for i in range(B)])
    batch = exp.prepare(raw)
    net = rec.net

    # one step's loss and gradients through the kernels against the plain
    # loss, the same weights and batch, TF32 off, deterministic cuDNN: the
    # gradient with respect to the heads element by element (rtol 1e-3 /
    # atol 1e-6), then each leaf on its own scale (max |diff| <= 1e-3 max
    # |plain| + 1e-6). The plain path's backward is not deterministic on the
    # card (its gathers add with atomics): two plain runs differ by up to
    # 1.1e-5 of a leaf's largest entry in the first convs, more than an
    # element-wise rtol allows on their small entries; the kernel path
    # repeats bit for bit.
    torch.backends.cudnn.deterministic = True

    def loss_and_grads(nll_fn):
        net.zero_grad(set_to_none=True)
        net.train()
        heads = net(batch["image"])
        leaves = [h.detach().requires_grad_() for h in heads]
        lengths = torch.full((B,), heads[0].shape[1], dtype=torch.int32, device="cuda")
        nll = nll_fn(*leaves, lengths, batch["label"], batch["label_length"])
        loss = ctc._reduce(nll, batch["label_length"], "mean")
        head_grads = torch.autograd.grad(loss, leaves)
        torch.autograd.backward(heads, head_grads)
        return (loss.item(), head_grads,
                {n: p.grad.clone() for n, p in net.named_parameters()})

    loss_k, heads_k, grads_k = loss_and_grads(ctc2d.ctc2d_nll_markov)
    loss_r, heads_r, grads_r = loss_and_grads(ctc2d.ctc2d_nll_markov_reference)
    torch.backends.cudnn.deterministic = False
    head_diff = max(float((a - b).abs().max()) for a, b in zip(heads_k, heads_r))
    leaf = {n: (float((grads_k[n] - g).abs().max()), float(g.abs().max()))
            for n, g in grads_r.items()}
    worst = max(leaf, key=lambda n: leaf[n][0] / (1e-3 * leaf[n][1] + 1e-6))
    log(f"train2d one-step parity: loss kernels {loss_k}, plain {loss_r}; d loss / d heads "
        f"max |diff| {head_diff:.3g}; worst leaf {worst}: max |diff| {leaf[worst][0]:.3g}, "
        f"max |plain| {leaf[worst][1]:.3g} ({len(leaf)} leaves)")
    if abs(loss_k - loss_r) > 1e-4:
        raise AssertionError("train2d: the kernel loss disagrees with the plain loss")
    for what, a, b in zip(("emit", "trans", "init"), heads_k, heads_r):
        if not torch.allclose(a, b, rtol=1e-3, atol=1e-6):
            raise AssertionError(f"train2d: d loss / d {what} disagrees with the plain loss's")
    for n, (diff, scale) in leaf.items():
        if diff > 1e-3 * scale + 1e-6:
            raise AssertionError(f"train2d: gradient of {n} disagrees with the plain loss's")

    state = create_train_state(rec, opt)

    def markov_loss(heads, b):
        lengths = torch.full((B,), heads[0].shape[1], dtype=torch.int32, device="cuda")
        return ctc2d.ctc2d_loss_markov(*heads, lengths, b["label"], b["label_length"])

    split = step_split(exp, raw, net, markov_loss, state.optimizer,
                       ("prepare", "forward", "loss", "backward", "optimizer"))
    step_fn = make_train_step(rec, prepare=exp.prepare)
    busy = device_busy_ms(lambda: step_fn(state, raw))
    step_ms = cuda_ms(lambda: step_fn(state, raw), reps=10)
    idle = "not measured" if busy is None else f"{1.0 - busy / step_ms:.4f}"
    log("train2d step split (ms, median of 10, CUDA events): " + json.dumps(split)
        + f"; {B / split['step'] * 1e3:.1f} crops/s")
    log(f"train2d step (make_train_step, CUDA events, median of 10): {step_ms} ms = "
        f"{B / step_ms * 1e3:.1f} crops/s; kernel-busy {busy} ms; device idle share {idle}")
    return launches


class TextPages:
    """Numpy-made pages with the item contract of the port's
    ``SyntheticDetectionDataset``: {"image": (H, W, 3) uint8, "polygons":
    exact quads (4, 2) float32, "ignore", "texts", "scale", "filename"}. Each
    page holds 3-8 words, half of them rotated by up to 0.5 rad, as bright
    strokes (columns of a random glyph pattern) on dark noise (uniform below
    ``noise``); one word in eight is a don't-care ('###') region."""

    def __init__(self, n: int, seed: int, hw=(640, 640), noise: int = 50):
        self.n = n
        self.seed = seed
        self.hw = hw
        self.noise = noise

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        from megreader_tpu_torch.data.datasets import _overlaps

        rng = np.random.default_rng(self.seed * 999_983 + i)
        H, W = self.hw
        img = rng.integers(0, self.noise, (H, W, 3), dtype=np.uint8)
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        polys, ignore, texts = [], [], []
        for _ in range(int(rng.integers(3, 9))):
            w, h = rng.uniform(40, min(200, 0.45 * W)), rng.uniform(12, 40)
            th = rng.uniform(-0.5, 0.5) if rng.random() < 0.5 else 0.0
            c = np.array([rng.uniform(0.1 * W, 0.9 * W), rng.uniform(0.1 * H, 0.9 * H)])
            R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
            quad = (np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2 @ R.T + c)
            quad = quad.astype(np.float32)
            if quad.min() < 2 or quad[:, 0].max() > W - 3 or quad[:, 1].max() > H - 3 or any(
                    _overlaps(quad, q) for q in polys):
                continue
            u = (xx - c[0]) * np.cos(th) + (yy - c[1]) * np.sin(th)
            v = -(xx - c[0]) * np.sin(th) + (yy - c[1]) * np.cos(th)
            inside = (np.abs(u) <= w / 2) & (np.abs(v) <= h / 2)
            strokes = (np.floor(u / 3) % 3 != 0) & (np.abs(v) <= 0.4 * h)
            img[inside & strokes] = 235
            polys.append(quad)
            ignore.append(bool(rng.random() < 0.125))
            texts.append("###" if ignore[-1] else "word")
        return {"image": img, "polygons": polys, "ignore": ignore, "texts": texts,
                "scale": np.array([1.0, 1.0], np.float32), "filename": f"pages_{i}"}


def phase_traindet(B: int = 8, hw=(640, 640)):
    """Config #4 (the DB detector) at full width through Experiment/Trainer on
    GT maps rasterized on the card: 24 steps, one validation through
    evaluate_detection, a checkpoint that resumes; the GT maps on the card
    against the CPU; the step split and the device idle share."""
    from megreader_tpu_torch.experiment import Experiment
    from megreader_tpu_torch.models.detector import SegDetector
    from megreader_tpu_torch.ops.ccl import connected_components_cuda
    from megreader_tpu_torch.ops.gt_maps import make_detection_gt
    from megreader_tpu_torch.train.checkpoint import CheckpointManager
    from megreader_tpu_torch.train.train_step import (
        OptimizerConfig,
        create_train_state,
        make_train_step,
    )

    per_epoch, epochs = 4, 6
    steps = per_epoch * epochs
    # experiments/seg_detector_synth.yaml: SGD lr 0.007, momentum 0.9, decay
    # 1e-4, poly over 20 000 steps
    opt = OptimizerConfig(name="sgd", lr=0.007, momentum=0.9, weight_decay=1e-4,
                          schedule="poly", total_steps=20_000)
    data = TextPages(B * per_epoch, SEED + 20, hw)
    eval_data = TextPages(2 * B, SEED + 21, hw)
    det = SegDetector(backbone="resnet18", fpn_dim=256, head_dim=64, k=50.0, device="cuda")
    seeded_weights(det.net, SEED + 22)

    with tempfile.TemporaryDirectory() as ws:
        def experiment(model, n_epochs, **kw):
            return Experiment(model, data, optimizer=opt, workspace=ws, batch_size=B,
                              epochs=n_epochs, log_every=1, max_polys=16, **kw)

        exp = experiment(det, epochs, eval_dataset=eval_data, validate_every_steps=steps)
        connected_components_cuda.launches = 0
        t0 = time.perf_counter()
        state = exp.make_trainer().train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(ws, "train_metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        losses = [r["loss"] for r in lines if "loss" in r]
        evals = [r for r in lines if "eval/hmean" in r]
        first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        log(f"traindet (config #4): {state.step} steps of {B} pages of {hw} in {wall:.2f} s "
            f"(host clock, loader, device GT maps, logging, checkpoint and one validation "
            f"included); loss mean of the first 5 steps {first:.4f}, of the last 5 {last:.4f}; "
            f"losses {losses}; parts at the last step "
            + json.dumps({k: [r for r in lines if "bce" in r][-1][k]
                          for k in ("bce", "dice", "thresh_l1")}))
        if state.step != steps or len(losses) != steps:
            raise AssertionError(f"traindet ran {state.step} steps and logged {len(losses)}")
        if not all(np.isfinite(losses)) or not last < first:
            raise AssertionError("traindet: losses must be finite and fall")
        if len(evals) != 1 or evals[0]["step"] != steps:
            raise AssertionError(f"traindet: expected one validation at step {steps}: {evals}")
        metrics = {k: evals[0][f"eval/{k}"] for k in ("precision", "recall", "hmean")}
        if not all(np.isfinite(list(metrics.values()))):
            raise AssertionError(f"traindet: validation metrics not finite: {metrics}")
        log(f"traindet validation (evaluate_detection, ICDAR 2015 protocol, {2 * B} pages) at "
            f"step {steps}: {metrics}; CCL kernel launches {connected_components_cuda.launches}")

        det2 = SegDetector(backbone="resnet18", fpn_dim=256, head_dim=64, device="cuda")
        seeded_weights(det2.net, SEED + 23)
        restored = CheckpointManager(ws).restore(create_train_state(det2, opt))
        same = all(torch.equal(a, b) for a, b in zip(det.net.state_dict().values(),
                                                    det2.net.state_dict().values()))
        if restored.step != steps or restored.optimizer.count != steps or not same:
            raise AssertionError("traindet: the checkpoint did not restore the trained state")
        resumed = experiment(det2, epochs + 1).make_trainer().train(resume=True)
        if resumed.step != steps + per_epoch:
            raise AssertionError(f"traindet: resume ended at step {resumed.step}")
        log(f"traindet: restored step {restored.step} into a fresh model, resumed to "
            f"{resumed.step}")

    # the GT maps on the card against the same call on the CPU: masks equal,
    # the threshold map within 1e-5 (float32 arithmetic, the same operations)
    raw = exp.collate([data[i] for i in range(B)])
    polys = [torch.from_numpy(raw[k]) for k in ("polys", "poly_valid", "poly_ignore")]
    maps = make_detection_gt(*(t.cuda() for t in polys), hw=hw)
    maps_cpu = make_detection_gt(*polys, hw=hw)
    diffs = {k: (int((maps[k].cpu() != v).sum()), float((maps[k].cpu() - v).abs().max()))
             for k, v in maps_cpu.items()}
    log(f"traindet GT maps on the card vs the CPU ({int(raw['poly_valid'].sum())} polygons, "
        f"{int(raw['poly_ignore'].sum())} ignored): (pixels that differ, max |diff|) "
        + json.dumps(diffs))
    for k, (n, d) in diffs.items():
        if (k == "thresh_map" and d > 1e-5) or (k != "thresh_map" and n > 0):
            raise AssertionError(f"traindet: GT map {k} on the card differs from the CPU's")
    if not all(float(maps_cpu["gt"][b].sum()) > 0 for b in range(B)):
        raise AssertionError("traindet: a page has no text in its GT map")

    # the step split (CUDA events) and the device idle share (torch.profiler)
    state = create_train_state(det, opt)
    split = step_split(exp, raw, det.net, lambda maps, b: det.map_loss(maps, b)[0],
                       state.optimizer, ("prepare", "forward", "loss", "backward", "optimizer"))
    step_fn = make_train_step(det, prepare=exp.prepare)
    busy = device_busy_ms(lambda: step_fn(state, raw))
    step_ms = cuda_ms(lambda: step_fn(state, raw), reps=10)
    idle = "not measured" if busy is None else f"{1.0 - busy / step_ms:.4f}"
    log("traindet step split (ms, median of 10, CUDA events; prepare = pages to the card + GT "
        "maps, loss = the three losses with the OHEM sort): " + json.dumps(split)
        + f"; {B / split['step'] * 1e3:.1f} pages/s")
    log(f"traindet step (make_train_step, CUDA events, median of 10): {step_ms} ms = "
        f"{B / step_ms * 1e3:.1f} pages/s; kernel-busy {busy} ms; device idle share {idle}")


def phase_decode2d():
    """Config #2's batched decode on the card through RecognizerPredictor,
    greedy (independent heights) and Viterbi (Markov heights), against the
    same weights on the CPU; then one E2EPipeline batch with the Markov
    recognizer."""
    from megreader_tpu_torch.data.loader import recognition_collate
    from megreader_tpu_torch.core.charset import Charset
    from megreader_tpu_torch.models.detector import SegDetector
    from megreader_tpu_torch.models.recognizer2d import Ctc2dRecognizer
    from megreader_tpu_torch.pipelines.e2e import E2EPipeline
    from megreader_tpu_torch.pipelines.predictors import RecognizerPredictor

    B = 64
    words = WordCrops(B, SEED + 14)
    raw = recognition_collate([words[i] for i in range(B)], Charset())
    markov = None
    for transition, mode in (("independent", "greedy"), ("markov", "Viterbi")):
        rec = Ctc2dRecognizer(num_classes=37, transition=transition, device="cuda")
        seeded_weights(rec.net, SEED + 15)
        with torch.no_grad():  # class logits as sharp as a trained net's
            rec.net.class_head.weight.mul_(8.0)
        rec_cpu = copy.deepcopy(rec)
        rec_cpu.net.cpu()
        pred, pred_cpu = RecognizerPredictor(rec), RecognizerPredictor(rec_cpu)
        texts = pred.predict(None, raw["image"], raw["size"])
        texts_cpu = pred_cpu.predict(None, raw["image"], raw["size"])
        ids, lengths = rec.decode(pred.prepare(raw["image"], raw["size"]))
        ids_cpu, lengths_cpu = rec_cpu.decode(pred_cpu.prepare(raw["image"], raw["size"]))
        same = torch.equal(ids.cpu(), ids_cpu) and torch.equal(lengths.cpu(), lengths_cpu)
        ms = cuda_ms(lambda: pred.predict(None, raw["image"], raw["size"]), reps=10)
        log(f"decode2d {mode} ({transition} heights), {B} crops: ids equal to the CPU's: {same}; "
            f"strings equal: {texts == texts_cpu}; {ms} ms per batch by CUDA events around "
            f"RecognizerPredictor.predict = {B / ms * 1e3:.1f} crops/s; first strings "
            f"{texts[:6]}")
        if not same or texts != texts_cpu:
            raise AssertionError(f"decode2d: {mode} ids on the card differ from the CPU's")
        if tuple(ids.shape) != (B, 25) or not any(texts):
            raise AssertionError(f"decode2d: {mode} gave ids of shape {tuple(ids.shape)}")
        markov = rec

    rng = np.random.default_rng(SEED + 16)
    det = SegDetector(device="cuda")
    seeded_weights(det.net, SEED + 2)
    pages = torch.from_numpy(make_pages(rng, 8, 640, 640)).cuda()
    pipe = E2EPipeline(det, markov, max_regions=32, rectify="perspective", ccl_iters=24,
                       box_thresh=0.3, device="cuda")
    calibrate_prob_head(pipe, det.net, pages)
    results = pipe.predict(None, None, pages)
    out = pipe.run(None, None, pages)
    valid = out["valid"]
    if tuple(out["ids"].shape) != (8, 32, 25) or not bool(valid.any()):
        raise AssertionError(f"decode2d e2e: ids {tuple(out['ids'].shape)}, "
                             f"{int(valid.sum())} valid slots")
    if not torch.isfinite(out["quads"][valid]).all():
        raise AssertionError("decode2d e2e: quads not finite on valid slots")
    run_ms = cuda_ms(lambda: pipe.run(None, None, pages), reps=5)
    log(f"decode2d e2e (Markov 2D-CTC recognizer): {int(valid.sum())} valid regions on 8 "
        f"pages, first page texts {[r['text'] for r in results[0]][:8]}; {run_ms} ms per "
        f"batch of 8 (CUDA events) = {8 / run_ms * 1e3:.2f} pages/s")


def attention_model(seed: int, device="cuda", width: int = 64, dim: int = 256):
    """Config #3 (experiments/attention_resnet18_synth.yaml): resnet18 rec2d
    trunk of width 64, dim 256, max_len 32, 39 classes, on seeded weights."""
    from megreader_tpu_torch.models.attention import AttentionRecognizer

    rec = AttentionRecognizer(num_classes=39, backbone="resnet18", dim=dim, max_len=32,
                              width=width, device=device)
    seeded_weights(rec.net, seed)
    return rec


def shape_attention(net, images) -> None:
    """Random weights read every crop as the same string. Centre the memory
    projection on these crops' features and scale it to a spread of 3, and
    make the position table and the output layer larger, so that the decodes
    depend on the crop (and so that a comparison of ids means something)."""
    with torch.no_grad():
        net.eval()
        feat = net.trunk(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        feat = feat.reshape(-1, feat.shape[-1]).double()
        w = net.mem_proj.weight.double() * (3.0 / feat.std(0).mean())
        net.mem_proj.weight.copy_(w)
        net.mem_proj.bias.copy_(-(feat.mean(0) @ w.T))
        net.pos2d.mul_(5.0)
        net.out.weight.mul_(2.0)


def attention_margins(rec, net_cpu, x, mode: str, beam_width: int, margin: float = 1e-3):
    """The CPU's decode of crops ``x`` with ``net_cpu`` (``mode`` 'greedy' or
    'beam') -> (ids, lengths, clear): ``clear`` marks the crops it decides by
    more than ``margin``. Greedy: the chosen class beats the runner-up by
    more than ``margin`` at every step up to the row's EOS. Beam: the chosen
    hypothesis's score beats the runner-up's by more than ``margin`` at the
    end. The logits and the beam's final scores are read by wrapping
    ``decode_step`` and ``stable_top_k`` for the call."""
    from megreader_tpu_torch.models import attention

    seen = []
    if mode == "greedy":
        step = net_cpu.decode_step

        def recording_step(*args):
            out = step(*args)
            seen.append(out[1])
            return out

        net_cpu.decode_step = recording_step
        try:
            ids, lengths = rec.decode_greedy(x, net=net_cpu)
        finally:
            del net_cpu.decode_step
        top2 = torch.stack(seen, 1).topk(2, -1).values
        live = torch.arange(ids.shape[1]).view(1, -1) < lengths.view(-1, 1)
        return ids, lengths, ((top2[..., 0] - top2[..., 1] > margin) | ~live).all(1)
    top_k = attention.stable_top_k

    def recording_top_k(v, k):
        out = top_k(v, k)
        seen.append(out[0])
        return out

    attention.stable_top_k = recording_top_k
    try:
        ids, lengths = rec.decode_beam(x, beam_width, net=net_cpu)
    finally:
        attention.stable_top_k = top_k
    return ids, lengths, seen[-1][:, 0] - seen[-1][:, 1] > margin


def attention_step_split(exp, raw, net, optimizer):
    """Median ms of each part of an attention train step (CUDA events, 10
    after 3 warm-up): prepare, encode, the decoder loop (32 teacher-forced
    steps), the loss, backward, optimizer; plus the step."""
    parts = ("prepare", "encode", "decoder_loop", "loss", "backward", "optimizer")
    times = {k: [] for k in parts + ("step",)}
    for rep in range(13):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        b = exp.prepare(raw)
        labels = b["label"].long()
        B, T = labels.shape
        ev[1].record()
        net.train()
        mem, keys = net.encode(b["image"])
        ev[2].record()
        y_in = torch.cat([labels.new_full((B, 1), 1), labels[:, :T - 1]], 1)  # GO first
        state, logits = mem.new_zeros(B, net.dim), []
        for t in range(T):
            state, step_logits = net.decode_step(keys, mem, state, y_in[:, t])
            logits.append(step_logits)
        ev[3].record()
        logp = torch.log_softmax(torch.stack(logits, 1), -1)
        mask = (torch.arange(T, device=labels.device) < b["label_length"].view(B, 1)).float()
        tok = torch.gather(logp, 2, labels.unsqueeze(-1))[..., 0]
        loss = -(tok * mask).sum() / mask.sum().clamp(min=1.0)
        ev[4].record()
        loss.backward()
        ev[5].record()
        optimizer.step()
        optimizer.zero_grad()
        ev[6].record()
        ev[6].synchronize()
        if rep >= 3:
            for k, (a, e) in zip(parts, zip(ev[:-1], ev[1:])):
                times[k].append(a.elapsed_time(e))
            times["step"].append(ev[0].elapsed_time(ev[6]))
    return {k: statistics.median(v) for k, v in times.items()}


def phase_attention(B: int = 64, width: int = 64, dim: int = 256):
    """Config #3 (the attention recognizer) at full width through
    Experiment/Trainer: 24 steps, one validation, a checkpoint that resumes;
    one step's loss and the teacher-forced logits against the CPU; beam W 1
    equal to greedy on the card; greedy and beam (W 5) ids of 64 crops
    against the CPU's on clear-margin rows; the step split, the device idle
    share and the decodes' crops/s. Returns the decodes' model (fresh seeded
    weights shaped by ``shape_attention``) for the serving batches."""
    from megreader_tpu_torch.experiment import Experiment
    from megreader_tpu_torch.train.checkpoint import CheckpointManager
    from megreader_tpu_torch.train.train_step import create_train_state, make_train_step

    per_epoch, epochs = 4, 6
    steps = per_epoch * epochs
    opt = adam_warmup_cosine()  # config #3's optimizer is config #1's
    # WordCrops stands in for SyntheticRecognitionDataset, whose cv2
    # rendering the card's machine lacks; the same item contract
    data = WordCrops(B * per_epoch, SEED + 30)
    eval_data = WordCrops(B, SEED + 31)
    rec = attention_model(SEED + 32, width=width, dim=dim)

    with tempfile.TemporaryDirectory() as ws:
        def experiment(model, n_epochs, **kw):
            return Experiment(model, data, optimizer=opt, workspace=ws, batch_size=B,
                              epochs=n_epochs, log_every=1, **kw)

        exp = experiment(rec, epochs, eval_dataset=eval_data, validate_every_steps=steps)
        t0 = time.perf_counter()
        state = exp.make_trainer().train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(ws, "train_metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        losses = [r["loss"] for r in lines if "loss" in r]
        evals = [r for r in lines if "eval/accuracy" in r]
        first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        log(f"attention (config #3): {state.step} steps of {B} crops in {wall:.2f} s (host "
            f"clock, loader, logging, checkpoint and one validation included); loss mean of "
            f"the first 5 steps {first:.4f}, of the last 5 {last:.4f}; losses {losses}")
        if state.step != steps or len(losses) != steps:
            raise AssertionError(f"attention ran {state.step} steps and logged {len(losses)}")
        if not all(np.isfinite(losses)) or not last < first:
            raise AssertionError("attention: losses must be finite and fall")
        if len(evals) != 1 or evals[0]["step"] != steps or evals[0]["eval/n"] != B:
            raise AssertionError(f"attention: expected one validation at step {steps}: {evals}")
        log(f"attention validation (evaluate_recognition, greedy, {B} crops) at step {steps}: "
            f"accuracy {evals[0]['eval/accuracy']}, ned {evals[0]['eval/ned']}")

        rec2 = attention_model(SEED + 33, width=width, dim=dim)
        restored = CheckpointManager(ws).restore(create_train_state(rec2, opt))
        same = all(torch.equal(a, b) for a, b in zip(rec.net.state_dict().values(),
                                                    rec2.net.state_dict().values()))
        if restored.step != steps or restored.optimizer.count != steps or not same:
            raise AssertionError("attention: the checkpoint did not restore the trained state")
        resumed = experiment(rec2, epochs + 1).make_trainer().train(resume=True)
        if resumed.step != steps + per_epoch:
            raise AssertionError(f"attention: resume ended at step {resumed.step}")
        log(f"attention: restored step {restored.step} into a fresh model, resumed to "
            f"{resumed.step}")

    raw = exp.collate([data[i] for i in range(B)])
    batch = exp.prepare(raw)
    cpu = attention_model(SEED + 34, device="cpu", width=width, dim=dim)
    cpu.net.load_state_dict(rec.net.state_dict())
    batch_cpu = {k: v.cpu() for k, v in batch.items()}

    # one train-mode loss (on copies: BatchNorm's running statistics move)
    # and the teacher-forced logits (eval mode), the card against the CPU
    card_copy, cpu_copy = copy.deepcopy(rec), copy.deepcopy(cpu)
    loss_d = float(card_copy.loss(batch, train=True)[1]["loss"])
    loss_c = float(cpu_copy.loss(batch_cpu, train=True)[1]["loss"])
    labels = batch_cpu["label"].long()
    targets_in = torch.cat([torch.ones_like(labels[:, :1]), labels[:, :-1]], 1)  # GO first
    with torch.no_grad():
        tf_d = rec.net.eval()(batch["image"], targets_in.cuda()).cpu()
        tf_c = cpu.net.eval()(batch_cpu["image"], targets_in)
    # float32 sums in another order: the logits are held on their own scale
    # (rtol 1e-4 of their largest magnitude, atol 1e-5), as cross_check does
    tf_diff, tf_scale = float((tf_d - tf_c).abs().max()), float(tf_c.abs().max())
    log(f"attention card vs CPU: train-mode loss {loss_d} vs {loss_c}; teacher-forced logits "
        f"max |diff| {tf_diff:.3g} (max |CPU| {tf_scale:.3g})")
    if abs(loss_d - loss_c) > 1e-4 * max(1.0, abs(loss_c)):
        raise AssertionError("attention: the card's loss disagrees with the CPU's")
    if not tf_diff <= 1e-5 + 1e-4 * tf_scale:
        raise AssertionError("attention: the card's teacher-forced logits disagree with the CPU's")

    # time: the step (events), its split, kernel-busy and idle share
    state = create_train_state(rec, opt)
    split = attention_step_split(exp, raw, rec.net, state.optimizer)
    step_fn = make_train_step(rec, prepare=exp.prepare)
    busy = device_busy_ms(lambda: step_fn(state, raw))
    step_ms = cuda_ms(lambda: step_fn(state, raw), reps=10)
    idle = "not measured" if busy is None else f"{1.0 - busy / step_ms:.4f}"
    log("attention step split (ms, median of 10, CUDA events): " + json.dumps(split)
        + f"; {B / split['step'] * 1e3:.1f} crops/s")
    log(f"attention step (make_train_step, CUDA events, median of 10): {step_ms} ms = "
        f"{B / step_ms * 1e3:.1f} crops/s; kernel-busy {busy} ms; device idle share {idle}")

    # the decodes, on fresh seeded weights shaped so that they depend on the
    # crop (the trained net reads most crops as one string)
    x, x_cpu = batch["image"], batch_cpu["image"]
    dec = attention_model(SEED + 35, width=width, dim=dim)
    shape_attention(dec.net, x)
    cpu.net.load_state_dict(dec.net.state_dict())
    greedy = dec.decode_greedy(x)
    beam1 = dec.decode_beam(x, beam_width=1)
    if not all(torch.equal(a, b) for a, b in zip(greedy, beam1)):
        rows = int((~(greedy[0] == beam1[0]).all(1)).sum())
        raise AssertionError(f"attention: beam W 1 differs from greedy on {rows} rows")
    notes = {}
    for mode, got in (("greedy", greedy), ("beam", dec.decode_beam(x, beam_width=5))):
        ids_c, lengths_c, clear = attention_margins(cpu, cpu.net, x_cpu, mode, 5)
        same = (got[0].cpu() == ids_c).all(1) & (got[1].cpu() == lengths_c)
        notes[mode] = {"equal": int(same.sum()), "clear_margin": int(clear.sum()),
                       "other_rows": int((~clear).sum()),
                       "distinct_strings": len({tuple(r) for r in ids_c.tolist()})}
        if not bool(same[clear].all()):
            raise AssertionError(f"attention {mode}: ids differ from the CPU's on "
                                 f"{int((~same & clear).sum())} clear-margin rows")
    log(f"attention decodes of {B} crops: beam W 1 equal to greedy bit for bit; card vs CPU "
        f"(W 5 for the beam): " + json.dumps(notes))
    decodes = {"greedy": lambda: dec.decode_greedy(x),
               "beam_w5": lambda: dec.decode_beam(x, beam_width=5)}
    times = {}
    for name, fn in decodes.items():
        ms = cuda_ms(fn, reps=5)
        times[name] = {"ms": ms, "busy_ms": device_busy_ms(fn), "crops_per_s": B / ms * 1e3}
    log(f"attention decode of {B} crops (CUDA events, median of 5; kernel-busy): "
        + json.dumps(times))
    return dec


def beam_logits(rng, B: int = 256, T: int = 50, C: int = 37) -> np.ndarray:
    """``scripts/bench_beam.py``'s logits: N(0, 1), then per row runs of 3-8
    frames with blank at 12 (62%) or single frames with a symbol at 9."""
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    for b in range(B):
        t = 0
        while t < T:
            if rng.random() < 0.62:
                run = int(rng.integers(3, 9))
                logits[b, t:t + run, 0] = 12.0
                t += run
            else:
                logits[b, t, int(rng.integers(1, C))] = 9.0
                t += 1
    return logits


def phase_beam(B: int = 256):
    """``ctc_beam_decode`` on the card at ``scripts/bench_beam.py``'s shape and
    logits (B 256, T 50, C 37, W 8, seed 0) with ``blank_collapse`` 1.0 and
    0.999: ids and lengths equal to the CPU's on every row; times."""
    from megreader_tpu_torch.ops.ctc import ctc_beam_decode

    T, W = 50, 8
    logits_cpu = torch.from_numpy(beam_logits(np.random.default_rng(0), B, T))
    lengths_cpu = torch.full((B,), T, dtype=torch.int32)
    logits, lengths = logits_cpu.cuda(), lengths_cpu.cuda()
    out = {}
    for collapse in (1.0, 0.999):
        ids, lens = ctc_beam_decode(logits, lengths, beam_width=W, blank_collapse=collapse)
        ids_c, lens_c = ctc_beam_decode(logits_cpu, lengths_cpu, beam_width=W,
                                        blank_collapse=collapse)
        rows = int((~((ids.cpu() == ids_c).all(1) & (lens.cpu() == lens_c))).sum())
        if rows:
            raise AssertionError(f"beam (collapse {collapse}): {rows} rows differ from the CPU's")

        def fn():
            return ctc_beam_decode(logits, lengths, beam_width=W, blank_collapse=collapse)

        out[str(collapse)] = {"ms": cuda_ms(fn, reps=5), "busy_ms": device_busy_ms(fn),
                              "mean_length": float(lens_c.float().mean())}
    log(f"beam (ctc_beam_decode, B {B}, T {T}, C 37, W {W}): ids and lengths equal to the "
        f"CPU's on all {B} rows at both settings; by blank_collapse (CUDA events, median of "
        f"5; kernel-busy): " + json.dumps(out))


def serving_batch(name, pipe, det, rec, pages, pages_np):
    """One serving batch of ``pipe`` held to the CPU on one page
    (``cross_check``), with its pages/s and per-stage ms (CUDA events)."""
    from megreader_tpu_torch.ops.ccl import connected_components_cuda

    cross_check(pipe, det.net, rec.net, pages_np[:1])
    connected_components_cuda.launches = 0
    out = pipe.run(None, None, pages)
    torch.cuda.synchronize()
    B, K = out["valid"].shape
    if connected_components_cuda.launches != 1:
        raise AssertionError(f"{name}: the CCL kernel ran {connected_components_cuda.launches} "
                             "times in one batch")
    if tuple(out["ids"].shape[:2]) != (B, K) or not bool(out["valid"].any()):
        raise AssertionError(f"{name}: ids {tuple(out['ids'].shape)}, "
                             f"{int(out['valid'].sum())} valid slots")
    with torch.no_grad():
        prob = pipe.detect(det.net, pages)
        labels = pipe.label(prob)
        reg = pipe.regions(labels, prob)
        crops = pipe.crops(pages, reg)
        stages = {
            "detector": lambda: pipe.detect(det.net, pages),
            "ccl": lambda: pipe.label(prob),
            "extract": lambda: pipe.regions(labels, prob),
            "rectify": lambda: pipe.crops(pages, reg),
            "recognizer": lambda: pipe.recognize(rec.net, crops),
        }
        stage_ms = {k: cuda_ms(f, reps=5) for k, f in stages.items()}
        run_ms = cuda_ms(lambda: pipe.run(None, None, pages), reps=5)
    texts = [pipe.charset.decode(i[:n]) for i, n, v in zip(
        out["ids"][0].tolist(), out["lengths"][0].tolist(), out["valid"][0].tolist()) if v]
    log(f"{name}: {int(out['valid'].sum())} valid regions on {B} pages, first page texts "
        f"{texts[:6]}; stage ms (median of 5, CUDA events) " + json.dumps(stage_ms)
        + f"; batch {run_ms} ms = {B / run_ms * 1e3:.2f} pages/s")


def phase_serving(att, B: int = 8, hw: int = 640):
    """Serving batches of 8 640x640 pages: the config-#1 recognizer with
    ``rec_mode='beam'``, then the config-#3 recognizer ``att`` greedy and
    beam, each held to the CPU on one page."""
    from megreader_tpu_torch.models.detector import SegDetector
    from megreader_tpu_torch.models.recognizer import CTCRecognizer
    from megreader_tpu_torch.pipelines.e2e import E2EPipeline

    rng = np.random.default_rng(SEED + 1)
    det = SegDetector(device="cuda")
    rec = CTCRecognizer(num_classes=37, device="cuda")
    seeded_weights(det.net, SEED + 2)
    seeded_weights(rec.net, SEED + 3)
    pages_np = make_pages(rng, B, hw, hw)
    pages = torch.from_numpy(pages_np).cuda()
    kw = dict(max_regions=32, rectify="perspective", ccl_iters=24, box_thresh=0.3,
              device="cuda")
    pipe = E2EPipeline(det, rec, rec_mode="beam", **kw)
    calibrate_prob_head(pipe, det.net, pages)
    serving_batch("serving config #1, rec_mode='beam' (W 8)", pipe, det, rec, pages, pages_np)
    for mode in ("greedy", "beam"):
        pipe = E2EPipeline(det, att, rec_mode=mode, **kw)
        serving_batch(f"serving config #3 (attention), rec_mode={mode!r}"
                      + (" (W 8)" if mode == "beam" else ""), pipe, det, att, pages, pages_np)


ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                     "bench_det_fp16.msgpack")
#: the bf16 phase's tolerances against the CPU, by precision: the prob map on
#: its own scale, the share of mask pixels that may differ, matched quads in
#: px (bf16: the bounds of tests/test_torch_port_bf16.py, the port against
#: JAX on the CPU), the recognizer's logits on their own scale (bf16: None,
#: the CPU's own bf16 logits' distance from its float32 ones on the same
#: crops; the seeded full-width recognizer's bf16 noise is 0.11 of its scale
#: on the CPU). A frame whose top-2 logit margin exceeds twice the logits'
#: bound must take the same class on both devices
BF16_TOL = {False: {"prob": 1e-3, "mask": 1e-5, "quad": 1e-2, "logits": 1e-4},
            True: {"prob": 7.5e-2, "mask": 5e-4, "quad": 1.5, "logits": None}}
#: chain mode's matched polygons: in float32 their vertices within 2 px (an
#: ulp of a region's statistics can move a pixel on a band boundary to the
#: next band, ``CHAIN_TOL``); in bf16, whose prob map moves mask pixels and
#: the quads by up to 1.5 px, and the chains' extrapolated ends with them
#: (2.82 px in PR 15's call 2), their intersection over union at least 0.9
POLYGON_TOL = {False: 2.0, True: None}
POLYGON_MIN_IOU = 0.9


def serving_cross_check(pipe, det_net, rec_net, pages_np) -> dict:
    """``pipe`` on the card against the same pipeline on the CPU (plain
    versions, ``extract_impl='xla'``), both from the same pages, at the
    tolerances of ``BF16_TOL[pipe.bf16]``: prob maps, masks, valid regions per
    page, matched quads, then the recognizer's logits and greedy ids on the
    CPU's crops: the same class on every frame that the CPU decides by a
    margin over twice the logits' bound, the same ids on every crop all of
    whose frames are so decided. Returns the measured gaps."""
    from megreader_tpu_torch.ops.ctc import ctc_greedy_decode
    from megreader_tpu_torch.pipelines.e2e import E2EPipeline

    tol = BF16_TOL[pipe.bf16]
    cpu = E2EPipeline(pipe.detector, pipe.recognizer, max_regions=pipe.max_regions,
                      rectify=pipe.rectify, ccl_iters=pipe.ccl_iters, bf16=pipe.bf16,
                      device="cpu")
    det_cpu, rec_cpu = copy.deepcopy(det_net).cpu(), copy.deepcopy(rec_net).cpu()
    pg = torch.from_numpy(pages_np)
    with torch.no_grad():
        prob_c = cpu.detect(det_cpu, pg)
        prob_d = pipe.detect(det_net, pg.cuda()).cpu()
        out_c = cpu.run(det_cpu, rec_cpu, pg)
        out_d = {k: v.cpu() for k, v in pipe.run(det_net, rec_net, pg.cuda()).items()}
        reg = cpu.regions(cpu.label(prob_c), prob_c)
        crops = cpu.crops(pg, reg)[reg["valid"].reshape(-1)]
        logits_c = cpu.serving(rec_cpu).eval()(crops).float()
        logits_d = pipe.serving(rec_net).eval()(crops.cuda()).float().cpu()
        logits_32 = rec_cpu.eval()(crops.float())
    gaps = {"prob": float((prob_d - prob_c).abs().max()),
            "mask": float(((prob_d > pipe.bin_thresh) != (prob_c > pipe.bin_thresh))
                          .float().mean()),
            "logits": float((logits_d - logits_c).abs().max())}
    where = f"serving cross-check (bf16={pipe.bf16}, rectify={pipe.rectify})"
    if not gaps["prob"] <= tol["prob"] * max(1.0, float(prob_c.abs().max())):
        raise AssertionError(f"{where}: prob maps differ by {gaps['prob']}")
    if not gaps["mask"] <= tol["mask"]:
        raise AssertionError(f"{where}: masks differ on a share {gaps['mask']} of the pixels")
    n_c, n_d = out_c["valid"].sum(1), out_d["valid"].sum(1)
    if not torch.equal(n_c, n_d):
        raise AssertionError(f"{where}: valid regions per page {n_d.tolist()} on the card, "
                             f"{n_c.tolist()} on the CPU")
    quad = 0.0
    for b in range(len(n_c)):
        qc, qd = out_c["quads"][b][out_c["valid"][b]], out_d["quads"][b][out_d["valid"][b]]
        if len(qc):
            d = (qd[None] - qc[:, None]).abs().amax((2, 3))  # (cpu, card)
            quad = max(quad, float(d.amin(1).max()))
    gaps["quad_px"] = quad
    if not quad <= tol["quad"]:
        raise AssertionError(f"{where}: matched quads differ by {quad} px")
    if "polygons" in out_c:  # chain mode
        from megreader_tpu_torch.postproc.measurers import polygon_iou

        poly, iou = 0.0, 1.0
        for b in range(len(n_c)):
            pc = out_c["polygons"][b][out_c["valid"][b]]
            pd = out_d["polygons"][b][out_d["valid"][b]]
            if len(pc):
                d = (pd[None] - pc[:, None]).abs().amax((2, 3))  # (cpu, card)
                poly = max(poly, float(d.amin(1).max()))
                for i, j in enumerate(d.argmin(1).tolist()):
                    iou = min(iou, polygon_iou(pc[i].numpy(), pd[j].numpy()))
        gaps["polygon_px"], gaps["polygon_min_iou"] = poly, iou
        bound = POLYGON_TOL[pipe.bf16]
        if not (poly <= bound if bound is not None else iou >= POLYGON_MIN_IOU):
            raise AssertionError(f"{where}: matched polygons {poly} px apart, IoU {iou}")
    gaps["logits_cpu_vs_float32"] = float((logits_c - logits_32).abs().max())
    bound = (gaps["logits_cpu_vs_float32"] if tol["logits"] is None
             else tol["logits"] * max(1.0, float(logits_c.abs().max())))
    if not gaps["logits"] <= bound:
        raise AssertionError(f"{where}: the recognizer's logits differ by {gaps['logits']}")
    top2 = logits_c.topk(2, -1).values
    clear = top2[..., 0] - top2[..., 1] > 2 * bound  # (crops, frames)
    if not bool((logits_c.argmax(-1) == logits_d.argmax(-1))[clear].all()):
        raise AssertionError(f"{where}: a clear-margin frame takes another class")
    lengths = torch.full((len(crops),), logits_c.shape[1], dtype=torch.int32)
    ids_c, len_c = ctc_greedy_decode(logits_c, lengths)
    ids_d, len_d = ctc_greedy_decode(logits_d, lengths)
    same = (ids_c == ids_d).all(1) & (len_c == len_d)
    if not bool(same[clear.all(1)].all()):
        raise AssertionError(f"{where}: ids differ on a crop of clear-margin frames")
    log(f"{where}, pages {tuple(pg.shape)}: max |card - CPU| " + json.dumps(gaps)
        + f"; valid regions per page {n_c.tolist()} on both; {int(clear.sum())} of "
        f"{clear.numel()} frames clear by {2 * bound:.4g}, same class on all; greedy ids "
        f"equal on {int(same.sum())} of {len(crops)} crops, on all {int(clear.all(1).sum())} "
        "crops of clear frames")
    return gaps


def bf16_serving(det, rec, pages, pages_np, words):
    """One float32 batch ('xla') and two bf16 batches ('xla', 'pallas_full')
    of the trained detector: launches, valid regions against the words drawn,
    CCL sweeps, busy ms per stage, pages/s by events; each pipeline held to
    the CPU on 1 page. Returns the kernels' launches in the bf16 batches."""
    from megreader_tpu_torch.ops import extract as ex
    from megreader_tpu_torch.ops.ccl import (
        connected_components_cuda,
        connected_components_reference,
    )
    from megreader_tpu_torch.pipelines.e2e import E2EPipeline

    kernels = {"ccl": connected_components_cuda, "candidates": ex.candidates_cuda,
               "moments": ex.moments_cuda, "extents": ex.extents_cuda}
    bf16_launches = dict.fromkeys(kernels, 0)
    B = pages.shape[0]
    pipes = {}
    for bf16, impl in ((False, "xla"), (True, "xla"), (True, "pallas_full")):
        name = f"{'bf16' if bf16 else 'f32'} {impl}"
        pipe = pipes[name] = E2EPipeline(det, rec, max_regions=32, rectify="perspective",
                                         ccl_iters=24, bf16=bf16, extract_impl=impl,
                                         device="cuda")
        if impl == "xla":
            serving_cross_check(pipe, det.net, rec.net, pages_np[:1])
        pipe.run(None, None, pages)  # warm-up; makes the bf16 copies
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        out = pipe.run(None, None, pages)
        torch.cuda.synchronize()
        got = {n: k.launches for n, k in kernels.items()}
        want = {"ccl": 1, "candidates": int(impl == "pallas_full"),
                "moments": int(impl != "xla"), "extents": int(impl != "xla")}
        if got != want:
            raise AssertionError(f"bf16 phase, {name}: kernel launches {got}, expected {want}")
        if bf16:
            for n in got:
                bf16_launches[n] += got[n]
        valid = out["valid"].sum(1).tolist()
        if any(v < w for v, w in zip(valid, words)):
            raise AssertionError(f"bf16 phase, {name}: valid regions per page {valid}, "
                                 f"words drawn {words}")
        with torch.no_grad():
            prob = pipe.detect(det.net, pages)
            labels = pipe.label(prob)
            reg = pipe.regions(labels, prob)
            crops = pipe.crops(pages, reg)
            _, sweeps = connected_components_reference(prob > pipe.bin_thresh, pipe.ccl_iters,
                                                       return_sweeps=True)
            stages = {
                "detector": lambda: pipe.detect(det.net, pages),
                "ccl": lambda: pipe.label(prob),
                "extract": lambda: pipe.regions(labels, prob),
                "rectify": lambda: pipe.crops(pages, reg),
                "recognizer": lambda: pipe.recognize(rec.net, crops),
            }
            stage_ms = {k: cuda_ms(f, reps=5) for k, f in stages.items()}
            busy_ms = {k: device_busy_ms(f) for k, f in stages.items()}
            run_ms = cuda_ms(lambda: pipe.run(None, None, pages), reps=5)
            run_busy = device_busy_ms(lambda: pipe.run(None, None, pages))
        idle = "not measured" if run_busy is None else f"{1.0 - run_busy / run_ms:.4f}"
        log(f"bf16 phase, trained detector, {name}: launches {got}; valid regions per page "
            f"{valid}, words drawn {words}; CCL sweeps per page {sweeps.tolist()}; stage ms "
            f"(median of 5, CUDA events) " + json.dumps(stage_ms) + "; stage kernel-busy ms "
            + json.dumps(busy_ms) + f"; batch {run_ms} ms = {B / run_ms * 1e3:.2f} pages/s, "
            f"kernel-busy {run_busy} ms, device idle share {idle}")
    # the three pipelines in turns, there and back, so that a drift of the
    # host's speed weighs on each alike
    turns = {name: [] for name in pipes}
    for name in [*pipes, *reversed(pipes)]:
        turns[name].append(cuda_ms(lambda: pipes[name].run(None, None, pages), reps=10))
    log("bf16 phase, serving in turns (f32 xla, bf16 xla, bf16 pallas_full, then back; ms a "
        "batch of 8, median of 10 each, CUDA events): " + json.dumps(turns) + "; pages/s "
        + json.dumps({k: [B / t * 1e3 for t in v] for k, v in turns.items()}))
    return bf16_launches


def bf16_train(name, make, data, opt, B, per_epoch, epochs, seed, counted, **exp_kw):
    """``make(compute_dtype)`` -> a task on the card; trains its
    mixed-precision model through Experiment/Trainer for per_epoch x epochs
    steps: the eval-mode loss of the first batch within rtol 0.05 of the
    float32 model's on the same weights, finite falling losses, float32
    parameters and optimizer state; times a step. Returns ``counted``'s
    launches (kernel wrappers) in the run."""
    from megreader_tpu_torch.experiment import Experiment
    from megreader_tpu_torch.train.train_step import create_train_state, make_train_step

    steps = per_epoch * epochs
    model = make("bfloat16")
    seeded_weights(model.net, seed)
    model32 = make("float32")
    model32.net.load_state_dict(model.net.state_dict())
    with tempfile.TemporaryDirectory() as ws:
        exp = Experiment(model, data, optimizer=opt, workspace=ws, batch_size=B, epochs=epochs,
                         log_every=1, **exp_kw)
        raw = exp.collate([data[i] for i in range(B)])
        batch = exp.prepare(raw)
        with torch.no_grad():
            l16 = model.loss(batch, train=False)[0].item()
            l32 = model32.loss(batch, train=False)[0].item()
        del model32
        for k in counted:
            k.launches = 0
        t0 = time.perf_counter()
        state = exp.make_trainer().train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = tuple(k.launches for k in counted)
        with open(os.path.join(ws, "train_metrics.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f if '"loss"' in line]
    first, last = statistics.mean(losses[:4]), statistics.mean(losses[-4:])
    dtypes = {str(t.dtype) for t in (*model.net.parameters(), *model.net.buffers())
              if t.is_floating_point()}
    dtypes |= {str(v.dtype) for st in state.optimizer.inner.state.values() for v in st.values()
               if torch.is_tensor(v) and v.is_floating_point() and v.dim()}
    log(f"bf16 phase, {name} mixed precision: step-0 loss (eval mode) bf16 {l16:.6f}, float32 "
        f"{l32:.6f} (rel {abs(l16 - l32) / abs(l32):.3g}); {state.step} steps in {wall:.2f} s "
        f"(host clock); launches {launches}; loss mean of the first 4 steps {first:.4f}, of "
        f"the last 4 {last:.4f}; losses {losses}; parameter, buffer and optimizer dtypes "
        f"{sorted(dtypes)}")
    if not abs(l16 - l32) <= 0.05 * abs(l32):
        raise AssertionError(f"bf16 phase, {name}: step-0 loss {l16} vs float32 {l32}")
    if state.step != steps or len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"bf16 phase, {name}: {state.step} steps, losses {losses}")
    if not last < first:
        raise AssertionError(f"bf16 phase, {name}: the loss did not fall")
    if dtypes != {"torch.float32"}:
        raise AssertionError(f"bf16 phase, {name}: dtypes {dtypes} in the trained state")
    state = create_train_state(model, opt)
    step_fn = make_train_step(model, prepare=exp.prepare)
    busy = device_busy_ms(lambda: step_fn(state, raw))
    step_ms = cuda_ms(lambda: step_fn(state, raw), reps=10)
    idle = "not measured" if busy is None else f"{1.0 - busy / step_ms:.4f}"
    log(f"bf16 phase, {name} mixed-precision step (make_train_step, CUDA events, median of "
        f"10): {step_ms} ms = {B / step_ms * 1e3:.1f} items/s; kernel-busy {busy} ms; device "
        f"idle share {idle}")
    return launches


def phase_bf16(B: int = 8, hw: int = 640, rec_B: int = 64, per_epoch: int = 4, epochs: int = 3):
    """The trained detector read from the repo's asset and served in float32
    and bf16, then configs #1-#4 trained in mixed precision. Returns the
    launches of every kernel on the bf16 paths."""
    from megreader_tpu_torch.compat.msgpack import load_flax_msgpack
    from megreader_tpu_torch.compat.weights import load_flax_variables
    from megreader_tpu_torch.models.attention import AttentionRecognizer
    from megreader_tpu_torch.models.detector import SegDetector
    from megreader_tpu_torch.models.recognizer import CTCRecognizer
    from megreader_tpu_torch.models.recognizer2d import Ctc2dRecognizer
    from megreader_tpu_torch.ops import ctc, ctc2d
    from megreader_tpu_torch.train.train_step import OptimizerConfig

    t0 = time.perf_counter()
    variables, step = load_flax_msgpack(ASSET)
    decode_ms = (time.perf_counter() - t0) * 1e3
    leaves = []

    def walk(tree):
        for v in tree.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)

    walk(variables)
    log(f"bf16 phase: {os.path.relpath(ASSET)} read by the port's msgpack decoder in "
        f"{decode_ms:.1f} ms (host clock): step {step}, {len(leaves)} leaves, "
        f"{sum(a.size for a in leaves)} values, float16 widened to "
        f"{sorted({str(a.dtype) for a in leaves})}")
    det = SegDetector(device="cuda")
    load_flax_variables(det.net, variables)
    rec = CTCRecognizer(num_classes=37, device="cuda")
    seeded_weights(rec.net, SEED + 3)
    items = [TextPages(B, 5, (hw, hw))[i] for i in range(B)]
    pages_np = np.stack([it["image"] for it in items]).astype(np.float32)
    words = [len(it["polygons"]) for it in items]
    launches = bf16_serving(det, rec, torch.from_numpy(pages_np).cuda(), pages_np, words)
    del det, rec
    torch.cuda.empty_cache()

    opt = adam_warmup_cosine()
    launches["ctc_alpha"], launches["ctc_beta"] = bf16_train(
        "config #1", lambda dt: CTCRecognizer(num_classes=37, compute_dtype=dt, device="cuda"),
        WordCrops(rec_B * per_epoch, SEED + 40), opt, rec_B, per_epoch, epochs, SEED + 41,
        (ctc.ctc_alpha_cuda, ctc.ctc_beta_cuda))
    got = bf16_train(
        "config #2 (Markov heights)",
        lambda dt: Ctc2dRecognizer(37, transition="markov", compute_dtype=dt, device="cuda"),
        WordCrops(rec_B * per_epoch, SEED + 42), opt, rec_B, per_epoch, epochs, SEED + 43,
        (ctc2d.ctc2d_alpha_cuda, ctc2d.ctc2d_beta_cuda, ctc.ctc_alpha_cuda, ctc.ctc_beta_cuda))
    if got[2:] != (0, 0):
        raise AssertionError(f"bf16 phase, config #2: the 1-D CTC kernels ran {got[2:]}")
    launches["ctc2d_alpha"], launches["ctc2d_beta"] = got[:2]
    bf16_train(
        "config #3 (attention)",
        lambda dt: AttentionRecognizer(num_classes=39, compute_dtype=dt, device="cuda"),
        WordCrops(rec_B * per_epoch, SEED + 44), opt, rec_B, per_epoch, epochs, SEED + 45, ())
    # bench.py's recipe for this detector, the one that trained the asset:
    # experiments/seg_detector_synth.yaml's SGD (lr 0.007, momentum 0.9, no
    # warm-up) stalled the seeded bf16 detector from its 6th step on the card
    # (gradient norm 182 -> 1.3, PERF.md PR 12)
    bf16_train(
        "config #4 (detector)", lambda dt: SegDetector(compute_dtype=dt, device="cuda"),
        TextPages(B * per_epoch, SEED + 46, (hw, hw)),
        OptimizerConfig(name="adam", lr=3e-4, schedule="constant"),
        B, per_epoch, epochs, SEED + 47, (), max_polys=16)
    log("bf16 phase: kernel launches on the bf16 paths " + json.dumps(launches))
    if not all(launches.values()):
        raise AssertionError(f"bf16 phase: a kernel did not launch on a bf16 path: {launches}")
    return launches


ROOT = os.path.dirname(os.path.abspath(__file__))


def kernel_counters():
    """Each kernel's wrapper (its ``launches`` count) by the kernels line's
    name, extraction kernels without their prefix."""
    from megreader_tpu_torch.ops import ctc, ctc2d
    from megreader_tpu_torch.ops import extract as ex
    from megreader_tpu_torch.ops.ccl import connected_components_cuda

    return {"ccl": connected_components_cuda, "candidates": ex.candidates_cuda,
            "moments": ex.moments_cuda, "extents": ex.extents_cuda,
            "ctc_alpha": ctc.ctc_alpha_cuda, "ctc_beta": ctc.ctc_beta_cuda,
            "ctc2d_alpha": ctc2d.ctc2d_alpha_cuda, "ctc2d_beta": ctc2d.ctc2d_beta_cuda}


def run_cli(name, main, argv, total, phase: str = "cli"):
    """An entry point's ``main(argv)`` with every kernel's count set to 0 just
    before it; its launches are added to ``total``. Returns (its result, its
    launches, its seconds on the host clock, the JSON lines it printed); what
    it printed is logged with a prefix naming ``phase``."""
    import contextlib
    import io

    counters = kernel_counters()
    for k in counters.values():
        k.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {n: k.launches for n, k in counters.items()}
    for n, v in got.items():
        total[n] += v
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"{phase} phase, {name} | {line}")
    log(f"{phase} phase, {name}: {wall:.2f} s (host clock) [{CARD}], launches "
        + json.dumps({n: v for n, v in got.items() if v}))
    return out, got, wall, [json.loads(line) for line in lines if line.startswith("{")]


def node(cls: str, **kw) -> str:
    """A YAML flow mapping for a dotted override that replaces a config node."""
    return "{" + ", ".join([f"class: {cls}"] + [f"{k}: {v}" for k, v in kw.items()]) + "}"


def step_seconds(ws: str):
    """Host seconds between consecutive logged steps of a workspace's
    ``train_metrics.jsonl`` (one line a step), and its losses."""
    with open(os.path.join(ws, "train_metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if '"loss"' in line]
    t = [r["t"] for r in recs]
    return [b - a for a, b in zip(t, t[1:])], [r["loss"] for r in recs], [r["step"] for r in recs]


def smooth_crops(rng, n: int, hw=(32, 100)) -> np.ndarray:
    """Smooth 0-255 crops (sums of low-frequency waves), where the
    resamplers' one-ulp coordinate differences stay far below 1e-3 px."""
    H, W = hw
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    out = np.zeros((n, H, W, 3))
    for _ in range(4):
        f = rng.uniform(0.02, 0.1, (n, 1, 1, 3, 2))
        ph = rng.uniform(0, 2 * np.pi, (n, 1, 1, 3))
        out += np.sin(xx[None, ..., None] * f[..., 0] + yy[None, ..., None] * f[..., 1] + ph)
    return (127.5 + 127.5 * out / 4).astype(np.float32)


def phase_cli(B: int = 8, hw: int = 640, rec_B: int = 64, per_epoch: int = 4):
    """The port as its users start it: the entry points on the repo's YAML
    files at full width, the numpy datasets put in through dotted overrides.
    Returns every kernel's launches in the entry points' runs."""
    from megreader_tpu_torch.cli import eval as cli_eval
    from megreader_tpu_torch.cli import pipeline as cli_pipeline
    from megreader_tpu_torch.cli import train as cli_train
    from megreader_tpu_torch.compat.msgpack import load_flax_msgpack
    from megreader_tpu_torch.compat.weights import load_flax_variables
    from megreader_tpu_torch.core.registry import COMPONENTS
    from megreader_tpu_torch.data.imageio import write_png
    from megreader_tpu_torch.experiment import Experiment
    from megreader_tpu_torch.models.detector import SegDetector
    from megreader_tpu_torch.models.recognizer import CTCRecognizer
    from megreader_tpu_torch.ops.ccl import (
        connected_components,
        connected_components_cuda,
        multigrid_solve,
    )
    from megreader_tpu_torch.ops.image import rotate_crops
    from megreader_tpu_torch.pipelines.e2e import E2EPipeline
    from megreader_tpu_torch.train.checkpoint import CheckpointManager
    from megreader_tpu_torch.train.train_step import OptimizerConfig, create_train_state

    t_phase = time.perf_counter()
    for cls in (WordCrops, TextPages):
        COMPONENTS.register(cls)
    total = dict.fromkeys(kernel_counters(), 0)
    cfg = {k: os.path.join(ROOT, "experiments", f"{k}.yaml")
            for k in ("ctc_resnet18_synth", "ctc2d_resnet18_synth", "seg_detector_synth")}
    rec_data = ["--experiment.train_dataset", node("WordCrops", n=rec_B * per_epoch,
                                                   seed=SEED + 60),
                "--experiment.eval_dataset", node("WordCrops", n=rec_B, seed=SEED + 61),
                "--experiment.batch_size", str(rec_B), "--experiment.log_every", "1"]

    def expect(name, got, want):
        bad = {n: v for n, v in got.items() if v != want.get(n, 0)}
        if bad:
            raise AssertionError(f"cli phase, {name}: launches {got}, expected {want}")

    with tempfile.TemporaryDirectory() as tmp:
        # config #1: 2 epochs of 4 steps, then a resume to 3 epochs
        ws1 = os.path.join(tmp, "ctc")
        steps = 2 * per_epoch
        state, got, _, _ = run_cli("cli.train config #1", cli_train.main, [
            cfg["ctc_resnet18_synth"], "--no-resume", "--experiment.workspace", ws1,
            "--experiment.epochs", "2", *rec_data], total)
        expect("cli.train config #1", got, {"ctc_alpha": steps, "ctc_beta": steps})
        if state.step != steps:
            raise AssertionError(f"cli phase: config #1 stopped at step {state.step}")
        cli_dt, cli_losses, _ = step_seconds(ws1)
        state, got, _, _ = run_cli("cli.train config #1, resumed", cli_train.main, [
            cfg["ctc_resnet18_synth"], "--experiment.workspace", ws1, "--experiment.epochs",
            "3", *rec_data], total)
        expect("cli.train config #1, resumed", got,
               {"ctc_alpha": per_epoch, "ctc_beta": per_epoch})
        _, losses, logged = step_seconds(ws1)
        if state.step != steps + per_epoch or logged != list(range(1, state.step + 1)) or not (
                np.all(np.isfinite(losses))):
            raise AssertionError(f"cli phase: config #1 resumed to step {state.step}, logged "
                                 f"steps {logged}, losses {losses}")

        # the same run built in Python: the entry point adds nothing a step
        ws_py = os.path.join(tmp, "ctc_python")
        torch.manual_seed(0)  # from_yaml draws the weights under the YAML's seed, 0
        exp = Experiment(CTCRecognizer(num_classes=37, device="cuda"),
                         WordCrops(rec_B * per_epoch, SEED + 60),
                         eval_dataset=WordCrops(rec_B, SEED + 61),
                         optimizer=adam_warmup_cosine(), workspace=ws_py, batch_size=rec_B,
                         epochs=2, log_every=1)
        exp.make_trainer().train(resume=False)
        py_dt, py_losses, _ = step_seconds(ws_py)
        log(f"cli phase, config #1 step on the host clock (s between logged steps 2-{steps}, "
            f"median): cli.train {statistics.median(cli_dt[1:])} (all {cli_dt}), Experiment "
            f"built in Python {statistics.median(py_dt[1:])} (all {py_dt}); losses cli "
            f"{cli_losses}, Python {py_losses}")
        if abs(cli_losses[0] - py_losses[0]) > 1e-5 * abs(py_losses[0]):
            raise AssertionError(f"cli phase: the first step's loss {cli_losses[0]} through "
                                 f"cli.train, {py_losses[0]} through Experiment")
        del exp

        # config #2 with Markov heights: 4 steps, the 2D-CTC kernels only
        ws2 = os.path.join(tmp, "ctc2d")
        markov = ["--experiment.model.transition", "markov"]
        state, got, _, _ = run_cli("cli.train config #2 (Markov)", cli_train.main, [
            cfg["ctc2d_resnet18_synth"], "--no-resume", "--experiment.workspace", ws2,
            "--experiment.epochs", "1", *markov, *rec_data], total)
        expect("cli.train config #2", got, {"ctc2d_alpha": per_epoch, "ctc2d_beta": per_epoch})
        if state.step != per_epoch:
            raise AssertionError(f"cli phase: config #2 stopped at step {state.step}")

        # evaluation of both workspaces, greedy and beam (Viterbi for Markov)
        for label, name, ws, extra, step in (
                ("config #1", "ctc_resnet18_synth", ws1, [], steps + per_epoch),
                ("config #2", "ctc2d_resnet18_synth", ws2, markov, per_epoch)):
            for mode in ("greedy", "beam"):
                _, got, _, printed = run_cli(f"cli.eval {label} {mode}", cli_eval.main, [
                    cfg[name], "--experiment.workspace", ws, "--mode", mode, *extra,
                    *rec_data], total)
                expect(f"cli.eval {label}", got, {})
                if (len(printed) != 1 or printed[0]["step"] != step
                        or printed[0]["n"] != rec_B or not 0 <= printed[0]["ned"] <= 1):
                    raise AssertionError(f"cli phase: cli.eval {label} {mode} printed {printed}")

        # the trained detector (the repo's asset) in a port checkpoint
        ws3 = os.path.join(tmp, "det")
        variables, asset_step = load_flax_msgpack(ASSET)
        det = SegDetector(device="cuda")
        load_flax_variables(det.net, variables)
        CheckpointManager(ws3).save(create_train_state(det, OptimizerConfig()), asset_step,
                                    force=True)
        pages_data = ["--experiment.train_dataset", node("TextPages", n=B, seed=5),
                      "--experiment.eval_dataset", node("TextPages", n=B, seed=5),
                      "--experiment.batch_size", str(B)]
        _, got, _, printed = run_cli("cli.eval config #4 (trained detector)", cli_eval.main, [
            cfg["seg_detector_synth"], "--experiment.workspace", ws3, *pages_data], total)
        if not got["ccl"] or len(printed) != 1 or not printed[0]["recall"] > 0:
            raise AssertionError(f"cli phase: detector evaluation printed {printed}, "
                                 f"launches {got}")

        # the page pipeline on PNG files
        items = [TextPages(B, 5, (hw, hw))[i] for i in range(B)]
        pages_np = np.stack([it["image"] for it in items])
        paths = []
        for i, page in enumerate(pages_np):
            paths.append(os.path.join(tmp, f"page{i}.png"))
            write_png(paths[-1], page)
        base = ["--detector", cfg["seg_detector_synth"], "--det-workspace", ws3,
                "--recognizer", cfg["ctc_resnet18_synth"], "--rec-workspace", ws1,
                "--page-size", str(hw)]
        rec = CTCRecognizer(num_classes=37, device="cuda")
        CheckpointManager(ws1).restore_variables(rec.net)
        served = {}
        for rectify, impl in (("perspective", "auto"), ("deskew", "auto"), ("box", "auto"),
                              ("perspective", "pallas_full")):
            name = f"cli.pipeline --rectify {rectify} --extract-impl {impl}"
            out, got, wall, printed = run_cli(name, cli_pipeline.main, [
                *base, "--images", *paths, "--rectify", rectify, "--extract-impl", impl], total)
            full = impl == "pallas_full"
            expect(name, got, {"ccl": 1, "candidates": int(full), "moments": int(full),
                               "extents": int(full)})
            if printed != out or [p["image"] for p in out] != paths:
                raise AssertionError(f"cli phase: {name} printed {printed}")
            served[rectify, impl] = out
            pipe = E2EPipeline(det, rec, box_thresh=0.5, rectify=rectify, extract_impl=impl,
                               device="cuda")
            direct = pipe.predict(None, None, pages_np.astype(np.float32))
            err = 0.0
            for page, want in zip(out, direct):
                if [d["text"] for d in page["detections"]] != [d["text"] for d in want] or not (
                        page["detections"]):
                    raise AssertionError(f"cli phase: {name} read {page}, E2EPipeline.predict "
                                         f"{want}")
                for d, w in zip(page["detections"], want):
                    err = max(err, float(np.abs(np.array(d["polygon"]) - w["polygon"]).max()))
            if err > 1e-3:
                raise AssertionError(f"cli phase: {name} polygons {err} px from predict")
            log(f"cli phase, {name}: {[len(p['detections']) for p in out]} words a page "
                f"({[len(it['polygons']) for it in items]} drawn), polygons {err} px from "
                f"E2EPipeline.predict, {wall:.2f} s for {B} pages (host clock, the models' "
                f"build and the PNG decode included)")
        polys = {k: [[d["polygon"] for d in p["detections"]] for p in v] for k, v in
                 served.items()}
        if any(polys[r, "auto"] != polys["perspective", "auto"] for r in ("deskew", "box")):
            raise AssertionError("cli phase: the polygons differ across rectify modes")
        # the extraction kernels against the default 'xla' statistics: the
        # serving batch's gate of phase e2e (same regions, quads within 1e-2 px)
        full = [np.array(p, np.float64) for p in polys["perspective", "pallas_full"]]
        xla = [np.array(p, np.float64) for p in polys["perspective", "auto"]]
        if any(f.shape != x.shape or (f.size and np.abs(f - x).max() > 1e-2)
               for f, x in zip(full, xla)):
            raise AssertionError("cli phase: 'pallas_full' polygons differ from 'xla' ones")
        cpu, _, _, _ = run_cli("cli.pipeline on the CPU, 1 page", cli_pipeline.main, [
            *base, "--images", *paths[:1], "--experiment.model.device", "cpu"], total)
        err, same_text, n = 0.0, 0, 0
        for page, want in zip(cpu, served["perspective", "auto"]):
            if len(page["detections"]) != len(want["detections"]):
                raise AssertionError(f"cli phase: the CPU read {page}, the card {want}")
            for d, w in zip(page["detections"], want["detections"]):
                err = max(err, float(np.abs(np.array(d["polygon"]) - w["polygon"]).max()))
                same_text += d["text"] == w["text"]
                n += 1
        log(f"cli phase, cli.pipeline card against CPU on 1 page: polygons within {err} px, "
            f"{same_text} of {n} strings equal")
        if err > 1e-3:
            raise AssertionError(f"cli phase: card and CPU polygons {err} px apart")

    # serving: flat CCL against multigrid, and the three rectify modes
    pages = torch.from_numpy(pages_np.astype(np.float32)).cuda()
    pipes = {"flat": E2EPipeline(det, rec, box_thresh=0.5, device="cuda"),
             "multigrid": E2EPipeline(det, rec, box_thresh=0.5, ccl_multigrid=True,
                                      device="cuda")}
    for rectify in ("deskew", "box"):
        pipes[rectify] = E2EPipeline(det, rec, box_thresh=0.5, rectify=rectify, device="cuda")
    with torch.no_grad():
        prob = pipes["flat"].detect(det.net, pages)
        mask = prob > pipes["flat"].bin_thresh
        connected_components_cuda.launches = 0
        flat, mg = pipes["flat"].label(prob), pipes["multigrid"].label(prob)
        torch.cuda.synchronize()
        if connected_components_cuda.launches != 3 or not torch.equal(flat, mg):
            raise AssertionError("cli phase: multigrid labels differ from the flat ones on the "
                                 "trained detector's masks")
        _, fsw = connected_components_cuda(mask, 24, return_sweeps=True)
        _, msw = multigrid_solve(connected_components_cuda, mask, 24, return_sweeps=True)
        ccl_ms = {"flat": cuda_ms(lambda: connected_components(mask, 24), reps=50),
                  "multigrid": cuda_ms(lambda: connected_components(mask, 24, multigrid=True),
                                       reps=50)}
        ccl_busy = {"flat": device_busy_ms(lambda: connected_components(mask, 24), reps=10),
                    "multigrid": device_busy_ms(
                        lambda: connected_components(mask, 24, multigrid=True), reps=10)}
        log(f"cli phase, CCL on the trained detector's masks ({B} TextPages, cap 24; "
            f"{float(mask.float().mean()):.4f} foreground): ms by events {json.dumps(ccl_ms)}, "
            f"kernel-busy {json.dumps(ccl_busy)}; sweeps flat {fsw.tolist()}, multigrid coarse "
            f"{msw[0].tolist()} full {msw[1].tolist()}; labels equal")
        for p in pipes.values():
            p.run(None, None, pages)  # warm-up
        turns = {name: [] for name in pipes}
        for name in [*pipes, *reversed(pipes)]:
            turns[name].append(cuda_ms(lambda: pipes[name].run(None, None, pages), reps=10))
        log("cli phase, serving the trained detector in turns (perspective with flat and "
            "multigrid CCL, deskew, box; there and back; ms a batch of 8, median of 10, CUDA "
            "events): " + json.dumps(turns) + "; pages/s "
            + json.dumps({k: [B / t * 1e3 for t in v] for k, v in turns.items()}))
        reg = pipes["box"].regions(flat, prob)
        K = pipes["box"].max_regions
        crops_raw = torch.from_numpy(smooth_crops(np.random.default_rng(SEED + 62), B * K))
        th = torch.from_numpy(np.random.default_rng(SEED + 63).uniform(-0.6, 0.6, B * K)
                              .astype(np.float32))
        got = rotate_crops(crops_raw.cuda(), th.cuda()).cpu().double()
        ref = rotate_crops(crops_raw, th).double()
        exact = rotate_crops(crops_raw.double(), th.double())
        err = float((got - ref).abs().max())
        # float32 itself: the CPU's float32 result lies cpu_err from float64
        # (a one-ulp change of an angle moves a value by about that much)
        cpu_err = float((ref - exact).abs().max())
        card_err = float((got - exact).abs().max())
        rot_ms = cuda_ms(lambda: rotate_crops(crops_raw.cuda(), th.cuda()), reps=20)
        stage = {r: cuda_ms(lambda: pipes[r].crops(pages, reg), reps=10)
                 for r in ("flat", "deskew", "box")}
    log(f"cli phase, rotate_crops on {B * K} smooth 32x100 crops at angles in +-0.6 rad: "
        f"card against CPU float32 max |err| {err}; against float64 card {card_err}, CPU "
        f"float32 {cpu_err} (bound: twice the CPU's, and ATOL_PX 1e-3 at least); "
        f"{rot_ms} ms by events; rectify stage ms (events) perspective "
        f"{stage['flat']}, deskew {stage['deskew']}, box {stage['box']} (a batch of 8 pages)")
    if card_err > max(1e-3, 2 * cpu_err):
        raise AssertionError(f"cli phase: rotate_crops on the card {card_err} from float64, "
                             f"the CPU's float32 {cpu_err}")
    log(f"cli phase: {time.perf_counter() - t_phase:.1f} s (host clock); kernel launches in "
        "the entry points' runs " + json.dumps(total))
    for n in ("ccl", "candidates", "moments", "extents", "ctc_alpha", "ctc_beta", "ctc2d_alpha",
              "ctc2d_beta"):
        if not total[n]:
            raise AssertionError(f"cli phase: kernel {n} did not launch through the entry points")
    return total


def write_word_list(root: str, data, indices) -> str:
    """The tight crops of ``data``'s items ``indices`` as PNG files (Sub
    rows) under ``root/crops`` and their list file ``root/list.txt``
    (``path<TAB>text``); returns the list file's path."""
    from megreader_tpu_torch.data.imageio import write_png

    os.makedirs(os.path.join(root, "crops"), exist_ok=True)
    lines = []
    for i in indices:
        item = data[i]
        h, w = (int(v) for v in item["size"])
        rel = f"crops/word_{i:05d}.png"
        write_png(os.path.join(root, rel), item["image"][:h, :w])
        lines.append(f"{rel}\t{item['text']}")
    path = os.path.join(root, "list.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def write_icdar(root: str, pages, indices, filters=(1,)):
    """``pages``' items ``indices`` as an ICDAR dir pair under ``root``:
    ``images/page_XXXXX.png`` with the row filters ``filters``, and
    ``gts/gt_page_XXXXX.txt`` with one ``x1,y1,...,x4,y4,text`` line a word
    (corners rounded to pixels), the first word of a page written as a
    ``###`` region. Returns (image dir, GT dir)."""
    from megreader_tpu_torch.data.imageio import write_png

    img_dir, gt_dir = os.path.join(root, "images"), os.path.join(root, "gts")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    for i in indices:
        item = pages[i]
        name = f"page_{i:05d}"
        write_png(os.path.join(img_dir, name + ".png"), item["image"], filters=filters)
        lines = [",".join(str(int(round(v))) for v in np.asarray(poly).reshape(-1))
                 + f",{'###' if k == 0 or ign else text}"
                 for k, (poly, ign, text) in enumerate(zip(item["polygons"], item["ignore"],
                                                           item["texts"]))]
        with open(os.path.join(gt_dir, f"gt_{name}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return img_dir, gt_dir


def time_loader(loader, epochs: int = 2):
    """Iterate ``epochs`` epochs of ``loader`` on the host clock: seconds to
    the first batch, items a second over the batches after it (None when
    there is one batch) and over all of them, and the batches."""
    t0 = time.perf_counter()
    batches, first = [], None
    for _ in range(epochs):
        for b in loader:
            batches.append(b)
            if first is None:
                first = time.perf_counter() - t0
    wall = time.perf_counter() - t0
    n = [len(b["image"]) for b in batches]
    after = sum(n[1:]) / (wall - first) if len(n) > 1 else None
    return first, after, sum(n) / wall, batches


def batches_equal(a, b) -> bool:
    """Whether two loaders' batch lists are equal bit for bit (arrays by
    dtype and value, lists by value)."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x.keys() != y.keys():
            return False
        for k in x:
            if isinstance(x[k], np.ndarray):
                if x[k].dtype != y[k].dtype or not np.array_equal(x[k], y[k]):
                    return False
            elif k in ("polygons",):
                if [[p.tobytes() for p in q] for q in x[k]] != [[p.tobytes() for p in q]
                                                                for q in y[k]]:
                    return False
            elif x[k] != y[k]:
                return False
    return True


def hooked_train(exp, total, on_step=None):
    """``exp``'s trainer run from scratch with a hook after every step (its
    validation hook, every step): a CUDA event and the host clock at each
    step's end, and ``on_step(model, state)``. Returns (the state, ms a step
    by events and by the host clock, each the median over steps 2 on, the
    kernels' launches in the run, which are added to ``total``)."""
    counters = kernel_counters()
    for k in counters.values():
        k.launches = 0
    trainer = exp.make_trainer()
    stamps = []

    def hook(model, state):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        stamps.append((ev, time.perf_counter()))
        if on_step is not None:
            on_step(model, state)
        return {}

    trainer.validate_every_steps, trainer.validate_fn = 1, hook
    state = trainer.train(resume=False)
    torch.cuda.synchronize()
    exp.train_loader.close()
    got = {n: k.launches for n, k in counters.items()}
    for n, v in got.items():
        total[n] += v
    events = [a[0].elapsed_time(b[0]) for a, b in zip(stamps, stamps[1:])]
    host = [(b[1] - a[1]) * 1e3 for a, b in zip(stamps, stamps[1:])]
    return state, statistics.median(events), statistics.median(host), got


def phase_data(rec_n: int = 256, pages: int = 32, eval_pages: int = 8, paeth_pages: int = 8,
               hw: int = 640, workers: int = 4):
    """Training from files on disk, as the YAML disk configs read them: word
    crops in a list file and ICDAR page pairs written as PNG, configs #1 and
    #4 at full width through ``cli.train`` and ``cli.eval`` with host and
    device augmentation, process workers and gradient accumulation. Returns
    every kernel's launches in the phase's training and evaluation runs."""
    import gc

    from megreader_tpu_torch.cli import eval as cli_eval
    from megreader_tpu_torch.cli import train as cli_train
    from megreader_tpu_torch.data.datasets import DetectionICDARDataset
    from megreader_tpu_torch.data.imageio import read_image
    from megreader_tpu_torch.data.loader import Loader, detection_collate_polys
    from megreader_tpu_torch.experiment import Experiment
    from megreader_tpu_torch.ops import image as image_ops

    t_phase = time.perf_counter()
    total = dict.fromkeys(kernel_counters(), 0)
    cfg1 = os.path.join(ROOT, "experiments", "ctc_listfile_disk.yaml")
    cfg4 = os.path.join(ROOT, "experiments", "seg_detector_icdar_disk.yaml")
    card = f"[{CARD}]"

    def expect(name, got, want):
        bad = {n: v for n, v in got.items() if v != want.get(n, 0)}
        if bad:
            raise AssertionError(f"data phase, {name}: launches {got}, expected {want}")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        words = WordCrops(rec_n + 64, SEED + 70)
        train_list = write_word_list(os.path.join(tmp, "rec", "train"), words, range(rec_n))
        eval_list = write_word_list(os.path.join(tmp, "rec", "eval"), words,
                                    range(rec_n, rec_n + 64))
        tp = TextPages(pages + eval_pages + paeth_pages, SEED + 71, (hw, hw))
        det_train = write_icdar(os.path.join(tmp, "det", "train"), tp, range(pages))
        det_eval = write_icdar(os.path.join(tmp, "det", "eval"), tp,
                               range(pages, pages + eval_pages))
        det_paeth = write_icdar(os.path.join(tmp, "det", "paeth"), tp,
                                range(pages + eval_pages, pages + eval_pages + paeth_pages),
                                filters=(4,))
        log(f"data phase: wrote {rec_n} + 64 word crops and {pages} + {eval_pages} + "
            f"{paeth_pages} (Paeth rows) {hw}x{hw} pages as PNG in "
            f"{time.perf_counter() - t0:.2f} s (host clock)")

        # the loaders alone, on the host: processes first, so that the first
        # batch pays the forkserver's start
        decode = {}
        for label, img_dir in (("Sub", det_eval[0]), ("Paeth", det_paeth[0])):
            files = sorted(os.listdir(img_dir))
            t0 = time.perf_counter()
            for f in files:
                read_image(os.path.join(img_dir, f))
            decode[label] = (time.perf_counter() - t0) * 1e3 / len(files)
        log(f"data phase, PNG decode of a {hw}x{hw} RGB page on one host thread (ms, mean of "
            f"{eval_pages} / {paeth_pages} pages) {card}: Sub rows {decode['Sub']}, Paeth rows "
            f"{decode['Paeth']}")
        rates = {}
        base = {"experiment.train_dataset.list_path": train_list,
                "experiment.eval_dataset.list_path": eval_list, "experiment.epochs": 2,
                "experiment.log_every": 1, "experiment.workspace": tmp}

        def crops_loader(mode):  # config #1's own train loader, as cli.train builds it
            exp = Experiment.from_yaml(cfg1, {**base, "experiment.loader_worker_mode": mode,
                                              "experiment.loader_workers": workers})
            return exp.train_loader

        sets = [("crops (config #1's train loader)", crops_loader, 2)]
        for label, (img_dir, gt_dir), augment, epochs in (
                ("pages Sub", det_eval, False, 2), ("pages Paeth", det_paeth, False, 1),
                ("pages Sub augmented", det_train, True, 1)):
            ds = DetectionICDARDataset(img_dir, gt_dir, target_hw=(hw, hw), augment=augment,
                                       gt_maps=False)
            sets.append((label, lambda mode, ds=ds: Loader(
                ds, 8, detection_collate_polys, shuffle=True, drop_last=False,
                workers=workers, worker_mode=mode), epochs))
        for label, make_loader, epochs in sets:
            runs = {}
            for mode in ("process", "thread"):
                loader = make_loader(mode)
                first, after, overall, runs[mode] = time_loader(loader, epochs)
                loader.close()
                rates[f"{label}, {mode}"] = {"first_batch_s": first, "items_per_s": after,
                                             "items_per_s_all": overall}
            if not batches_equal(runs["process"], runs["thread"]):
                raise AssertionError(f"data phase: process and thread batches of {label} "
                                     "differ")
        log(f"data phase, loaders alone ({workers} workers, host clock; seconds to the first "
            f"batch, items/s after it and overall; batches equal bit for bit across the two "
            f"kinds of workers) {card}: " + json.dumps(rates))

        # config #1 through cli.train: processes 8 steps, 4 resumed, threads 8
        rec_data = ["--experiment.train_dataset.list_path", train_list,
                    "--experiment.eval_dataset.list_path", eval_list,
                    "--experiment.log_every", "1"]
        per_epoch = rec_n // 64
        runs = {}
        for mode in ("process", "thread"):
            ws = os.path.join(tmp, f"ctc_{mode}")
            name = f"cli.train ctc_listfile_disk.yaml ({mode} workers)"
            state, got, wall, _ = run_cli(name, cli_train.main, [
                cfg1, "--no-resume", "--experiment.workspace", ws, "--experiment.epochs", "2",
                "--experiment.loader_worker_mode", mode, *rec_data], total, phase="data")
            gc.collect()
            expect(name, got, {"ctc_alpha": 2 * per_epoch, "ctc_beta": 2 * per_epoch})
            if state.step != 2 * per_epoch:
                raise AssertionError(f"data phase: {name} stopped at step {state.step}")
            runs[mode] = step_seconds(ws)
            if mode == "process":
                state, got, _, _ = run_cli(f"{name}, resumed", cli_train.main, [
                    cfg1, "--experiment.workspace", ws, "--experiment.epochs", "3",
                    "--experiment.loader_worker_mode", mode, *rec_data], total, phase="data")
                gc.collect()
                expect(f"{name}, resumed", got, {"ctc_alpha": per_epoch, "ctc_beta": per_epoch})
                _, losses, logged = step_seconds(ws)
                if state.step != 3 * per_epoch or logged != list(range(1, state.step + 1)) or (
                        not np.all(np.isfinite(losses))):
                    raise AssertionError(f"data phase: resumed to step {state.step}, logged "
                                         f"{logged}, losses {losses}")
        (dt_p, loss_p, _), (dt_t, loss_t, _) = runs["process"], runs["thread"]
        log(f"data phase, config #1 from disk through cli.train (bf16, augment) {card}: "
            f"s between logged steps 2-{2 * per_epoch} (host clock, median) processes "
            f"{statistics.median(dt_p[1:])}, threads {statistics.median(dt_t[1:])}; first "
            f"losses {loss_p[0]} / {loss_t[0]}; losses processes {loss_p}, threads {loss_t}")
        if loss_p[0] != loss_t[0]:
            raise AssertionError(f"data phase: the first step's loss {loss_p[0]} with "
                                 f"processes, {loss_t[0]} with threads")

        # ms a step by events and on the host clock: augment on and off,
        # threads and processes
        step_ms = {}
        for augment in (True, False):
            for mode in ("thread", "process"):
                with tempfile.TemporaryDirectory() as ws:
                    exp = Experiment.from_yaml(cfg1, {
                        **base, "experiment.workspace": ws, "experiment.augment": augment,
                        "experiment.loader_worker_mode": mode})
                    _, ev_ms, host_ms, got = hooked_train(exp, total)
                    del exp
                    gc.collect()
                expect("config #1 timing run", got, {"ctc_alpha": 2 * per_epoch,
                                                     "ctc_beta": 2 * per_epoch})
                step_ms[f"augment {augment}, {mode}"] = {"events": ev_ms, "host": host_ms}
        log(f"data phase, config #1 ms a step (bf16, batch 64, Trainer with a hook at each "
            f"step's end; median of steps 2-{2 * per_epoch}; the logged loss synchronises each "
            f"step) {card}: " + json.dumps(step_ms))

        # gradient accumulation: 4 mini-steps, 2 an update (constant rate,
        # so that the first update moves the weights)
        with tempfile.TemporaryDirectory() as ws:
            exp = Experiment.from_yaml(cfg1, {
                **base, "experiment.workspace": ws, "experiment.epochs": 1,
                "experiment.optimizer.accumulate_steps": 2,
                "experiment.optimizer.schedule": "constant",
                "experiment.optimizer.warmup_steps": 0})
            net = exp.model.net
            snap = lambda: ([p.detach().clone() for p in net.parameters()],  # noqa: E731
                            [b.detach().clone() for n, b in net.named_buffers()
                             if n.endswith("running_mean")])
            snaps = [snap()]
            state, _, _, got = hooked_train(exp, total, lambda m, s: snaps.append(snap()))
            del exp
            gc.collect()
        expect("accumulation run", got, {"ctc_alpha": per_epoch, "ctc_beta": per_epoch})

        def same(a, b):
            return all(torch.equal(x, y) for x, y in zip(a, b))

        moved = [not same(a[0], b[0]) for a, b in zip(snaps, snaps[1:])]
        stats = [not same(a[1], b[1]) for a, b in zip(snaps, snaps[1:])]
        log(f"data phase, accumulate_steps 2 over {per_epoch} mini-steps: weights moved "
            f"{moved}, BatchNorm statistics moved {stats}, updates {state.optimizer.count}, "
            f"launches {json.dumps(got)}")
        if moved != [i % 2 == 1 for i in range(per_epoch)] or not all(stats) or (
                state.optimizer.count != per_epoch // 2):
            raise AssertionError(f"data phase: accumulation moved the weights {moved}, the "
                                 f"statistics {stats}")

        # device augmentation on the card against the CPU, from one set of
        # draws (drawn on the CPU)
        exp = Experiment.from_yaml(cfg1, {**base, "experiment.workspace": tmp,
                                          "experiment.loader_workers": 1})
        raw = next(iter(exp.train_loader))
        del exp
        images = torch.from_numpy(np.asarray(raw["image"])).float()
        sizes = torch.from_numpy(np.asarray(raw["size"]))
        gen = torch.Generator().manual_seed(SEED + 72)
        draws = image_ops.resize_draws(gen, len(images))
        crops64, _ = image_ops.resize_with_aspect_pad(images.double(), sizes, (32, 100))
        idraws = image_ops.images_draws(gen, len(images))
        errs = {}
        for name, fn, args in (
                ("augment_resize_apply", lambda x, d: image_ops.augment_resize_apply(
                    x, sizes.to(x.device), (32, 100), d)[0], images),
                ("augment_images_apply", lambda x, d: image_ops.augment_images_apply(x, d),
                 crops64.float())):
            d = draws if name == "augment_resize_apply" else idraws
            card_out = fn(args.cuda(), {k: v.cuda() for k, v in d.items()}).cpu().double()
            cpu = fn(args, d).double()
            exact = fn(args.double(), {k: v.double() for k, v in d.items()})
            errs[name] = {"card_vs_cpu": float((card_out - cpu).abs().max()),
                          "card_vs_float64": float((card_out - exact).abs().max()),
                          "cpu_vs_float64": float((cpu - exact).abs().max())}
        log(f"data phase, device augmentation of {len(images)} crops on the card against the "
            f"CPU from one set of draws (max |err| on 0-255 values; bound: twice the CPU's "
            f"float32 distance from float64, at least 1e-3) {card}: " + json.dumps(errs))
        for name, e in errs.items():
            if not e["card_vs_float64"] <= max(1e-3, 2 * e["cpu_vs_float64"]):
                raise AssertionError(f"data phase: {name} on the card {e['card_vs_float64']} "
                                     f"from float64, the CPU's float32 {e['cpu_vs_float64']}")

        # config #4 from disk: host augmentation, processes, 4 steps of 8
        # pages, then cli.eval on the eval pages (CCL on the card)
        ws4 = os.path.join(tmp, "det")
        det_data = ["--experiment.train_dataset.image_dir", det_train[0],
                    "--experiment.train_dataset.gt_dir", det_train[1],
                    "--experiment.eval_dataset.image_dir", det_eval[0],
                    "--experiment.eval_dataset.gt_dir", det_eval[1]]
        name = "cli.train seg_detector_icdar_disk.yaml (augment, processes)"
        state, got, wall, _ = run_cli(name, cli_train.main, [
            cfg4, "--no-resume", "--experiment.workspace", ws4, "--experiment.epochs", "1",
            "--experiment.log_every", "1", "--experiment.train_dataset.augment", "true",
            "--experiment.loader_worker_mode", "process", *det_data], total, phase="data")
        gc.collect()
        expect(name, got, {})
        dt4, loss4, _ = step_seconds(ws4)
        if state.step != pages // 8 or not np.all(np.isfinite(loss4)):
            raise AssertionError(f"data phase: config #4 stopped at {state.step}, losses {loss4}")
        _, got, wall_eval, printed = run_cli("cli.eval seg_detector_icdar_disk.yaml",
                                             cli_eval.main, [cfg4, "--experiment.workspace",
                                                             ws4, *det_data], total,
                                             phase="data")
        if not got["ccl"] or len(printed) != 1 or printed[0]["step"] != pages // 8:
            raise AssertionError(f"data phase: cli.eval printed {printed}, launches {got}")
        log(f"data phase, config #4 from disk (bf16, batch 8 of {hw}x{hw}, host augmentation, "
            f"{workers} process workers) {card}: s between logged steps 2-{pages // 8} (host "
            f"clock) {dt4} (median {statistics.median(dt4[1:] or dt4)}); losses {loss4}; cli.eval "
            f"P/R/H {printed[0]} in {wall_eval:.2f} s (random weights: no bar)")

    log(f"data phase: {time.perf_counter() - t_phase:.1f} s (host clock) [{CARD}]; kernel "
        "launches in its training and evaluation runs " + json.dumps(total))
    for n in ("ccl", "ctc_alpha", "ctc_beta"):
        if not total[n]:
            raise AssertionError(f"data phase: kernel {n} did not launch")
    return total


# --- ROADMAP Queue 1 items 3b and 11: the encoder variants, chains, buckets ----


def zeroed_counters():
    """Every kernel's wrapper with its count set to 0."""
    counters = kernel_counters()
    for k in counters.values():
        k.launches = 0
    return counters


def add_counts(total, counters) -> dict:
    """Adds the counters' launches to ``total``; returns them."""
    got = {n: k.launches for n, k in counters.items()}
    for n, v in got.items():
        total[n] += v
    return got


def encoder_train(name, model, data, opt, B, steps, total, falls=True):
    """``model`` (on the card) through Experiment/Trainer for ``steps`` steps of
    ``B``: finite losses (falling ones where ``falls``), one launch of each CTC
    kernel a step (the counts set to 0 just before and read just after, added
    to ``total``). Returns (the experiment, the losses)."""
    from megreader_tpu_torch.experiment import Experiment

    with tempfile.TemporaryDirectory() as ws:
        exp = Experiment(model, data, optimizer=opt, workspace=ws, batch_size=B,
                         epochs=steps * B // len(data), log_every=1)
        counters = zeroed_counters()
        t0 = time.perf_counter()
        state = exp.make_trainer().train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = add_counts(total, counters)
        with open(os.path.join(ws, "train_metrics.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f if '"loss"' in line]
    k = min(4, steps // 2)
    first, last = statistics.mean(losses[:k]), statistics.mean(losses[-k:])
    log(f"encoders phase, {name}: {state.step} steps of {B} crops in {wall:.2f} s (host "
        f"clock, loader and logging included) [{CARD}]; launches "
        + json.dumps({n: v for n, v in got.items() if v}) + f"; loss mean of the first {k} "
        f"steps {first:.4f}, of the last {k} {last:.4f}; losses {losses}")
    if state.step != steps or len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"encoders phase, {name}: {state.step} steps, losses {losses}")
    if falls and not last < first:
        raise AssertionError(f"encoders phase, {name}: the loss did not fall")
    if (got["ctc_alpha"], got["ctc_beta"]) != (steps, steps) or any(
            v for n, v in got.items() if not n.startswith("ctc_")):
        raise AssertionError(f"encoders phase, {name}: launches {got} in {steps} steps")
    return exp, losses


def encoder_step_time(name, model, exp, raw, opt):
    """ms a train step (make_train_step, CUDA events, median of 10), kernel-busy
    ms and the device idle share; logged and returned."""
    from megreader_tpu_torch.train.train_step import create_train_state, make_train_step

    state = create_train_state(model, opt)
    step_fn = make_train_step(model, prepare=exp.prepare)
    busy = device_busy_ms(lambda: step_fn(state, raw))
    step_ms = cuda_ms(lambda: step_fn(state, raw), reps=10)
    idle = None if busy is None else 1.0 - busy / step_ms
    log(f"encoders phase, {name} step (make_train_step, CUDA events, median of 10) [{CARD}]: "
        f"{step_ms} ms = {len(raw['text']) / step_ms * 1e3:.1f} crops/s; kernel-busy {busy} "
        f"ms; device idle share {'not measured' if idle is None else f'{idle:.4f}'}")
    return {"ms": step_ms, "busy_ms": busy, "idle": idle}


def encoder_parity(name, model, batch, n: int = 8):
    """One train-mode loss and its gradients on the card against the CPU, in
    float64 (the nets; both CTC losses take float32 logits: the CUDA kernels
    on the card, the plain version on the CPU) on the first ``n`` crops of
    ``batch``: loss rtol 1e-4, every gradient leaf within 1e-3 of its largest
    magnitude plus 1e-5 of the largest over all leaves (the float32 loss's
    noise: a leaf whose gradient is zero in exact arithmetic, as the
    attention keys' bias, holds only that noise)."""
    from megreader_tpu_torch.ops.ctc import ctc_loss

    res = {}
    for dev in ("cuda", "cpu"):
        net = copy.deepcopy(model.net).to(dev).double().train()
        logits = net(batch["image"][:n].to(dev).double())
        lengths = torch.full((n,), logits.shape[1], dtype=torch.int32, device=dev)
        loss = ctc_loss(logits, lengths, batch["label"][:n].to(dev),
                        batch["label_length"][:n].to(dev))
        loss.backward()
        res[dev] = (loss.item(), {k: p.grad.cpu() for k, p in net.named_parameters()})
    (loss_d, g_d), (loss_c, g_c) = res["cuda"], res["cpu"]
    top = max(float(g.abs().max()) for g in g_c.values())
    ratio = {k: float((g_d[k] - g).abs().max()) / (1e-3 * float(g.abs().max()) + 1e-5 * top)
             for k, g in g_c.items()}
    worst = max(ratio, key=ratio.get)
    log(f"encoders phase, {name} first step on the card against the CPU (float64 nets, "
        f"{n} crops): loss {loss_d} / {loss_c}; largest gradient {top:.4g}; worst leaf "
        f"{worst}: max |diff| {float((g_d[worst] - g_c[worst]).abs().max()):.3g}, its max "
        f"|CPU| {float(g_c[worst].abs().max()):.3g} ({ratio[worst]:.3g} of the bound) over "
        f"{len(g_c)} leaves")
    if not abs(loss_d - loss_c) <= 1e-4 * abs(loss_c):
        raise AssertionError(f"encoders phase, {name}: loss {loss_d} on the card, {loss_c} on "
                             "the CPU")
    if not ratio[worst] <= 1.0:
        raise AssertionError(f"encoders phase, {name}: gradient {worst} differs from the CPU's")


def encoder_decode(name, model, crops):
    """Greedy decode of ``crops`` (on the CPU, normalized) on the card against
    the same weights on the CPU: logits within 1e-4 of their largest
    magnitude, the same class on every frame the CPU decides by more than
    twice that, the same ids on every crop all of whose frames are so
    decided; the decode's crops/s."""
    net_cpu = copy.deepcopy(model.net).cpu().eval()
    with torch.no_grad():
        logits_c = net_cpu(crops)
        logits_d = model.net.eval()(crops.cuda()).cpu()
        ids_d, len_d = model.decode(crops.cuda())
    bound = 1e-4 * max(1.0, float(logits_c.abs().max()))
    diff = float((logits_d - logits_c).abs().max())
    top2 = logits_c.topk(2, -1).values
    clear = top2[..., 0] - top2[..., 1] > 2 * bound
    from megreader_tpu_torch.ops.ctc import ctc_greedy_decode

    lengths = torch.full((len(crops),), logits_c.shape[1], dtype=torch.int32)
    ids_c, len_c = ctc_greedy_decode(logits_c, lengths)
    same = (ids_d.cpu() == ids_c).all(1) & (len_d.cpu() == len_c)
    ms = cuda_ms(lambda: model.decode(crops.cuda()), reps=10)
    log(f"encoders phase, {name} greedy decode of {len(crops)} crops [{CARD}]: logits max "
        f"|card - CPU| {diff:.3g} (bound {bound:.3g}); {int(clear.sum())} of {clear.numel()} "
        f"frames clear; ids equal on {int(same.sum())} crops, on all "
        f"{int(clear.all(1).sum())} crops of clear frames; {ms} ms = "
        f"{len(crops) / ms * 1e3:.1f} crops/s (CUDA events, median of 10)")
    if not diff <= bound:
        raise AssertionError(f"encoders phase, {name}: logits differ by {diff}")
    if not bool((logits_c.argmax(-1) == logits_d.argmax(-1))[clear].all()) or not bool(
            same[clear.all(1)].all()):
        raise AssertionError(f"encoders phase, {name}: ids differ on clear-margin crops")


def phase_encoders(B: int = 64, steps: int = 24, short: int = 4):
    """Config #1 with the transformer encoder (hidden 256: width 512, 2 layers,
    8 heads, MLP 2048, T 25) at full width through Experiment/Trainer, in
    float32 and in mixed precision; then ``encoder='none'`` and
    ``height_collapse='reshape'`` for a few steps each; each variant's
    decode against the CPU; the steps' times beside the BiLSTM's. Returns
    every kernel's launches in the phase's training runs."""
    from megreader_tpu_torch.models.recognizer import CTCRecognizer
    from megreader_tpu_torch.models.sequence import TransformerEncoder

    t_phase = time.perf_counter()
    total = dict.fromkeys(kernel_counters(), 0)
    opt = adam_warmup_cosine()
    data = WordCrops(B * steps // 6, SEED + 60)

    def make(seed, **kw):
        m = CTCRecognizer(num_classes=37, device="cuda", **kw)
        seeded_weights(m.net, seed)
        return m

    rec = make(SEED + 61, encoder="transformer")
    enc = rec.net.encoder
    if not isinstance(enc, TransformerEncoder) or enc.seq_len != 25 or enc.pos_embed.shape[-1] != 512:
        raise AssertionError(f"encoders phase: the encoder is {enc}")
    exp, _ = encoder_train("transformer, float32", rec, data, opt, B, steps, total)
    raw = exp.collate([data[i] for i in range(B)])
    batch = exp.prepare(raw)
    crops = batch["image"].cpu()
    fresh = make(SEED + 61, encoder="transformer")
    encoder_parity("transformer", fresh, exp.prepare(raw))
    encoder_decode("transformer", rec, crops)
    times = {"transformer": encoder_step_time("transformer, float32", rec, exp, raw, opt)}

    mixed = make(SEED + 62, encoder="transformer", compute_dtype="bfloat16")
    ref32 = make(SEED + 62, encoder="transformer")
    with torch.no_grad():
        l16 = mixed.loss(batch, train=False)[0].item()
        l32 = ref32.loss(batch, train=False)[0].item()
    log(f"encoders phase, transformer mixed precision: step-0 loss (eval mode) bf16 {l16:.6f}, "
        f"float32 {l32:.6f}")
    if not abs(l16 - l32) <= 0.05 * abs(l32):
        raise AssertionError(f"encoders phase: mixed-precision loss {l16} vs float32 {l32}")
    del ref32
    exp16, _ = encoder_train("transformer, mixed precision", mixed, data, opt, B, steps, total)
    if {p.dtype for p in mixed.net.parameters()} != {torch.float32}:
        raise AssertionError("encoders phase: mixed precision changed the parameters' dtype")
    times["transformer, mixed"] = encoder_step_time("transformer, mixed precision", mixed,
                                                    exp16, raw, opt)
    del mixed, exp16

    for name, kw in (("encoder='none'", {"encoder": "none"}),
                     ("height_collapse='reshape'", {"height_collapse": "reshape"})):
        m = make(SEED + 63, **kw)
        e, _ = encoder_train(name, m, data, opt, B, short, total, falls=False)
        encoder_decode(name, m, crops)
        times[name] = encoder_step_time(name, m, e, raw, opt)
        del m, e
    bilstm = make(SEED + 64)
    times["bilstm"] = encoder_step_time("BiLSTM (config #1 as it is)", bilstm, exp, raw, opt)
    del bilstm, rec
    torch.cuda.empty_cache()
    log(f"encoders phase: steps of batch {B} [{CARD}] " + json.dumps(times)
        + f"; {time.perf_counter() - t_phase:.1f} s (host clock); kernel launches in its "
        "training runs " + json.dumps(total))
    return total


def sine_band_masks(rng, B: int, H: int, W: int, n: int = 20) -> np.ndarray:
    """Curved word masks: ``n`` constant-thickness bands a page along half a
    sine period (``tests/test_chains.py``'s shape), of random lengths,
    arcs, thicknesses and heights."""
    out = np.zeros((B, H, W), bool)
    for b in range(B):
        for _ in range(n):
            x0 = int(rng.integers(0, W - 80))
            x1 = min(W, x0 + int(rng.integers(60, 260)))
            amp, half_h = float(rng.uniform(-25, 25)), int(rng.integers(3, 11))
            cy = int(rng.integers(30, H - 30))
            xs = np.arange(x0, x1)
            centres = cy + amp * np.sin((xs - x0) / (x1 - x0) * np.pi)
            for x, c in zip(xs, centres):
                lo, hi = int(round(c - half_h)), int(round(c + half_h))
                out[b, max(lo, 0):max(hi + 1, 0), x] = True
    return out


#: chains on the card against the CPU: on slots whose every band holds the
#: same pixel count on both, points and half-heights within 1e-3 px (float32
#: in another order); a slot where an ulp of u moved a boundary pixel to the
#: next band within 1 px (a band's v range moves by at most about a pixel),
#: its polygon within 2 px
CHAIN_TOL = {"same": 1e-3, "flip": 1.0, "flip_polygon": 2.0}


def chains_cross_check(labels_d, labels_c, scores_d, scores_c, K: int, impl: str) -> dict:
    """``extract_regions`` (``impl``), ``extract_chains``, band quads and
    polygons on the card against the CPU from the same labels: valid, area
    and the slots' roots bit-equal, then ``CHAIN_TOL``."""
    from megreader_tpu_torch.ops import chains
    from megreader_tpu_torch.ops.ccl import extract_regions, unclip_distance_inverse

    out = {}
    for dev, labels, scores in (("cuda", labels_d, scores_d), ("cpu", labels_c, scores_c)):
        stats = extract_regions(labels, scores, max_regions=K, impl=impl)
        roots = chains.chain_roots(labels, K, impl)
        ch = chains.extract_chains(labels, stats, n_bands=8, extract_impl=impl)
        count = chains._band_stats(labels, stats, roots, 8)[0]
        d = unclip_distance_inverse(stats)
        out[dev] = {"valid": stats["valid"], "area": stats["area"], "roots": roots,
                    "count": count, "polygons": chains.chains_to_polygons(ch, d),
                    "band_quads": chains.chains_to_band_quads(ch, d + 2.0), **ch}
        out[dev] = {k: v.cpu() for k, v in out[dev].items()}
    g, c = out["cuda"], out["cpu"]
    for k in ("valid", "area", "roots", "band_alive"):
        if not torch.equal(g[k], c[k]):
            raise AssertionError(f"chains phase, {impl}: {k} differs between the card and the CPU")
    same = (g["count"] == c["count"]).all(-1)  # (B, K)
    gaps = {"slots": int(c["valid"].sum()), "slots_with_a_moved_pixel": int((~same).sum())}
    for k in ("points", "half_h", "polygons", "band_quads"):
        diff = (g[k] - c[k]).abs().flatten(2).amax(-1)  # (B, K)
        gaps[k] = float(diff[same].max()) if same.any() else 0.0
        gaps[k + "_moved"] = float(diff[~same].max()) if (~same).any() else 0.0
        flip = CHAIN_TOL["flip" if k in ("points", "half_h") else "flip_polygon"]
        if not (gaps[k] <= CHAIN_TOL["same"] * (1.0 if k != "band_quads" else 2.0)
                and gaps[k + "_moved"] <= flip):
            raise AssertionError(f"chains phase, {impl}: {k} differ by {gaps}")
    return gaps


def phase_chains(det, rec, B: int = 8, hw: int = 640, K: int = 32):
    """Curved serving: the chain functions on numpy sine-band masks, card
    against CPU, under each ``extract_impl``; ``E2EPipeline(rectify='chain')``
    with the trained detector on ``TextPages`` in float32 ('xla' and
    'pallas_full') and bf16, held to the CPU, its chain stage's ms beside
    perspective's; ``detect_polygons_device`` on the prob maps. Returns every
    kernel's launches on the chain paths."""
    from megreader_tpu_torch.ops.ccl import (
        connected_components_cuda,
        connected_components_reference,
    )
    from megreader_tpu_torch.pipelines.e2e import E2EPipeline
    from megreader_tpu_torch.postproc.detection import detect_polygons_device

    t_phase = time.perf_counter()
    total = dict.fromkeys(kernel_counters(), 0)
    rng = np.random.default_rng(SEED + 70)
    masks = sine_band_masks(rng, B, hw, hw)
    m_d = torch.from_numpy(masks).cuda()
    labels_d = connected_components_cuda(m_d, 64)
    labels_c = connected_components_reference(torch.from_numpy(masks), 64)
    if not torch.equal(labels_d.cpu(), labels_c):
        raise AssertionError("chains phase: the CCL kernel's labels differ from the plain ones")
    scores_c = torch.from_numpy(np.where(masks, 0.9, 0.1).astype(np.float32))
    for impl in ("xla", "pallas", "pallas_full"):
        gaps = chains_cross_check(labels_d, labels_c, scores_c.cuda(), scores_c, K, impl)
        log(f"chains phase, sine bands ({B}x{hw}x{hw}, 20 a page, K {K}), {impl}: valid, "
            f"areas, roots and live bands equal on the card and the CPU; max |card - CPU| "
            + json.dumps(gaps))

    items = [TextPages(B, 7, (hw, hw))[i] for i in range(B)]
    pages_np = np.stack([it["image"] for it in items]).astype(np.float32)
    words = [len(it["polygons"]) for it in items]
    pages = torch.from_numpy(pages_np).cuda()
    pipes = {}
    outs = {}
    for bf16, impl in ((False, "xla"), (False, "pallas_full"), (True, "xla")):
        name = f"{'bf16' if bf16 else 'f32'} {impl}"
        pipe = pipes[name] = E2EPipeline(det, rec, max_regions=K, rectify="chain", n_bands=8,
                                         bf16=bf16, extract_impl=impl, device="cuda")
        pipe.run(None, None, pages)  # warm-up; makes the bf16 copies
        torch.cuda.synchronize()
        counters = zeroed_counters()
        out = outs[name] = pipe.run(None, None, pages)
        torch.cuda.synchronize()
        got = add_counts(total, counters)
        want = {"ccl": 1, "candidates": int(impl == "pallas_full"),
                "moments": int(impl != "xla"), "extents": int(impl != "xla")}
        if {n: got[n] for n in want} != want or any(got[n] for n in got if n not in want):
            raise AssertionError(f"chains phase, {name}: launches {got}, expected {want}")
        valid = out["valid"].sum(1).tolist()
        if tuple(out["polygons"].shape) != (B, K, 18, 2) or any(
                v < w for v, w in zip(valid, words)):
            raise AssertionError(f"chains phase, {name}: polygons "
                                 f"{tuple(out['polygons'].shape)}, valid per page {valid}, "
                                 f"words drawn {words}")
        if not torch.isfinite(out["polygons"][out["valid"]]).all():
            raise AssertionError(f"chains phase, {name}: polygons not finite")
        log(f"chains phase, chain serving {name}: launches "
            + json.dumps({n: v for n, v in got.items() if v}) + f"; valid regions per page "
            f"{valid}, words drawn {words}")
        if impl == "xla":
            serving_cross_check(pipe, det.net, rec.net, pages_np[:1])
    a, b = outs["f32 xla"], outs["f32 pallas_full"]
    poly = float((a["polygons"] - b["polygons"])[a["valid"]].abs().max())
    log(f"chains phase: 'pallas_full' against 'xla' chain serving: valid equal "
        f"{torch.equal(a['valid'], b['valid'])}, polygons within {poly} px")
    if not torch.equal(a["valid"], b["valid"]) or not poly <= CHAIN_TOL["flip_polygon"]:
        raise AssertionError(f"chains phase: 'pallas_full' polygons {poly} px from 'xla'")

    # the chain stage beside perspective's, in the same batch
    persp = E2EPipeline(det, rec, max_regions=K, rectify="perspective", device="cuda")
    chain = pipes["f32 xla"]
    with torch.no_grad():
        prob = chain.detect(det.net, pages)
        labels = chain.label(prob)
        stage = {}
        for name, pipe in (("chain", chain), ("perspective", persp)):
            reg = pipe.regions(labels, prob)
            stage[name] = {
                "regions_ms": cuda_ms(lambda: pipe.regions(labels, prob), reps=5),
                "crops_ms": cuda_ms(lambda: pipe.crops(pages, reg), reps=5),
                "regions_busy_ms": device_busy_ms(lambda: pipe.regions(labels, prob)),
                "crops_busy_ms": device_busy_ms(lambda: pipe.crops(pages, reg)),
                "batch_ms": cuda_ms(lambda: pipe.run(None, None, pages), reps=5),
            }
            stage[name]["pages_per_s"] = B / stage[name]["batch_ms"] * 1e3
    log(f"chains phase, stage times on one batch of {B} {hw}x{hw} pages (CUDA events, median "
        f"of 5; busy by torch.profiler) [{CARD}]: " + json.dumps(stage))

    counters = zeroed_counters()
    polys_d = detect_polygons_device(prob, box_thresh=0.5, max_regions=K)
    torch.cuda.synchronize()
    got = add_counts(total, counters)
    polys_c = detect_polygons_device(prob.cpu(), box_thresh=0.5, max_regions=K)
    v = polys_c["valid"]
    err = float((polys_d["polygons"].cpu() - polys_c["polygons"])[v].abs().max())
    log(f"chains phase, detect_polygons_device on the prob maps: launches "
        + json.dumps({n: c for n, c in got.items() if c}) + f"; {int(v.sum())} polygons, "
        f"valid equal {torch.equal(polys_d['valid'].cpu(), v)}, within {err} px of the CPU's")
    if got["ccl"] != 1 or not torch.equal(polys_d["valid"].cpu(), v) or not (
            err <= CHAIN_TOL["flip_polygon"]) or not bool(v.any()):
        raise AssertionError(f"chains phase: detect_polygons_device gave {err} px, {got}")
    log(f"chains phase: {time.perf_counter() - t_phase:.1f} s (host clock) [{CARD}]; kernel "
        "launches on the chain paths " + json.dumps(total))
    return total


#: (h, w) of the bucket phase's pages: three for each default bucket, two of
#: them smaller than it (one below 640 x 640: padded at its own scale), one
#: past 1152 (downscaled)
BUCKET_PAGES = ((500, 560), (300, 420), (640, 640), (600, 1100), (520, 900), (610, 1000),
                (1100, 600), (900, 500), (1000, 610), (800, 800), (1152, 1152), (1500, 1400))


def bucket_cross_check(pipe, rec_net, chunks) -> dict:
    """Each bucket batch's CCL labels bit-exact against the plain CCL on the
    card (new launch shapes: 640 x 1152, 1152 x 640, 1152 x 1152), then
    which of the card's detections the CPU's recognizer decides by a clear
    margin (logits on the card's crops within 1e-4 of their scale, every
    frame's top-2 margin over 1e-3 of it). Returns {page index: clear flag
    per kept detection} and the bucket batches' times."""
    from megreader_tpu_torch.ops.ccl import (
        connected_components_cuda,
        connected_components_reference,
    )

    rec_cpu = copy.deepcopy(rec_net).cpu().eval()
    clear, times = {}, {}
    for bucket, (idxs, canvases, fitted) in chunks.items():
        x = torch.from_numpy(canvases).cuda()
        with torch.no_grad():
            prob = pipe.detect(pipe.detector.net, x)
            mask = (prob > pipe.bin_thresh).contiguous()
            if not torch.equal(connected_components_cuda(mask, pipe.ccl_iters),
                               connected_components_reference(mask, pipe.ccl_iters)):
                raise AssertionError(f"buckets phase: CCL labels differ at {tuple(mask.shape)}")
            reg = pipe.regions(pipe.label(prob), prob)
            crops = pipe.crops(x, reg)
            logits_d = rec_net.eval()(crops).float().cpu()
            logits_c = rec_cpu(crops.cpu()).float()
        scale = max(1.0, float(logits_c.abs().max()))
        if not float((logits_d - logits_c).abs().max()) <= 1e-4 * scale:
            raise AssertionError(f"buckets phase: logits differ at {bucket}")
        top2 = logits_c.topk(2, -1).values
        sure = (top2[..., 0] - top2[..., 1] > 1e-3 * scale).all(-1).reshape(len(idxs), -1)
        valid, quads = reg["valid"].cpu(), reg["quads"].cpu()
        for j, i in enumerate(idxs):
            nh, nw = fitted[j]["valid_hw"]
            keep = [k for k in range(valid.shape[1]) if valid[j, k]
                    and quads[j, k, :, 0].mean() < nw and quads[j, k, :, 1].mean() < nh]
            clear[i] = [bool(sure[j, k]) for k in keep]
        times[f"{bucket[0]}x{bucket[1]}"] = {
            "pages": len(idxs),
            "batch_ms": cuda_ms(lambda: pipe.run(None, None, x), reps=5)}
        times[f"{bucket[0]}x{bucket[1]}"]["pages_per_s"] = (
            len(idxs) / times[f"{bucket[0]}x{bucket[1]}"]["batch_ms"] * 1e3)
    return clear, times


def phase_buckets(det, rec, batch: int = 4):
    """Variable-size serving: ``BucketedE2E`` over 12 ``TextPages`` of mixed
    sizes (every default bucket; one page downscaled, pages padded) with the
    trained detector, against the same on the CPU: detections per page,
    polygons in the pages' own pixels, texts on the clear-margin crops; the
    CCL labels bit-exact at each bucket shape; pages/s by bucket. Returns
    every kernel's launches in the bucketed run."""
    from megreader_tpu_torch.data.bucketing import DEFAULT_BUCKETS, fit_to_bucket, pick_bucket
    from megreader_tpu_torch.pipelines.bucketed import BucketedE2E
    from megreader_tpu_torch.pipelines.e2e import E2EPipeline

    t_phase = time.perf_counter()
    total = dict.fromkeys(kernel_counters(), 0)
    pages = [TextPages(1, 80 + i, hw)[0]["image"] for i, hw in enumerate(BUCKET_PAGES)]
    pipe = E2EPipeline(det, rec, max_regions=32, device="cuda")
    bucketed = BucketedE2E(pipe, batch=batch)
    fitted = [fit_to_bucket(np.asarray(p, np.float32), pick_bucket(*p.shape[:2]))
              for p in pages]
    chunks = {}
    for i, f in enumerate(fitted):
        chunks.setdefault(f["image"].shape[:2], []).append(i)
    if sorted(chunks) != sorted(DEFAULT_BUCKETS) or any(len(v) > batch for v in chunks.values()):
        raise AssertionError(f"buckets phase: pages per bucket {chunks}")
    bucketed.predict(None, None, pages)  # warm-up
    torch.cuda.synchronize()
    counters = zeroed_counters()
    t0 = time.perf_counter()
    got_pages = bucketed.predict(None, None, pages)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = add_counts(total, counters)
    if got["ccl"] != len(chunks) or any(v for n, v in got.items() if n != "ccl"):
        raise AssertionError(f"buckets phase: launches {got} for {len(chunks)} bucket batches")

    det_cpu, rec_cpu = copy.deepcopy(det), copy.deepcopy(rec)
    det_cpu.net.cpu()
    rec_cpu.net.cpu()
    want_pages = BucketedE2E(E2EPipeline(det_cpu, rec_cpu, max_regions=32, device="cpu"),
                             batch=batch).predict(None, None, pages)
    clear, times = bucket_cross_check(pipe, rec.net, {
        b: (idxs, np.stack([fitted[i]["image"] for i in idxs]), [fitted[i] for i in idxs])
        for b, idxs in chunks.items()})
    err, same, n, n_clear = 0.0, 0, 0, 0
    for i, (page, want) in enumerate(zip(got_pages, want_pages)):
        if len(page) != len(want) or len(page) != len(clear[i]):
            raise AssertionError(f"buckets phase, page {i} {BUCKET_PAGES[i]}: {len(page)} "
                                 f"detections on the card, {len(want)} on the CPU")
        for d, w, sure in zip(page, want, clear[i]):
            err = max(err, float(np.abs(d["polygon"] - w["polygon"]).max()))
            same += d["text"] == w["text"]
            n += 1
            n_clear += sure
            if sure and d["text"] != w["text"]:
                raise AssertionError(f"buckets phase, page {i}: {d['text']!r} on the card, "
                                     f"{w['text']!r} on the CPU, on a clear-margin crop")
    scales = [float(f["scale"][0]) for f in fitted]
    log(f"buckets phase: {len(pages)} pages of {list(BUCKET_PAGES)} (scales to their buckets "
        f"{[round(1 / s, 4) for s in scales]}) in {len(chunks)} bucket batches of at most "
        f"{batch}: launches " + json.dumps({k: v for k, v in got.items() if v})
        + f"; {n} detections on both, polygons within {err} px of the CPU's (the pages' own "
        f"pixels); {same} of {n} strings equal, all {n_clear} of the clear-margin crops; CCL "
        f"labels bit-exact at every bucket shape; {wall * 1e3:.1f} ms for the {len(pages)} "
        f"pages (host clock, fit and map included)")
    if not err <= 1e-2 * max(scales) or n < len(pages):
        raise AssertionError(f"buckets phase: polygons {err} px from the CPU's, {n} detections")
    log(f"buckets phase, bucket batches (pipe.run on the canvases, CUDA events, median of 5) "
        f"[{CARD}]: " + json.dumps(times) + f"; {time.perf_counter() - t_phase:.1f} s (host "
        "clock)")
    return total


def phase_curved():
    """The trained detector and the config-#1 recognizer (seeded), then the
    chain and bucket phases. Returns their launches."""
    from megreader_tpu_torch.compat.msgpack import load_flax_msgpack
    from megreader_tpu_torch.compat.weights import load_flax_variables
    from megreader_tpu_torch.models.detector import SegDetector
    from megreader_tpu_torch.models.recognizer import CTCRecognizer

    det = SegDetector(device="cuda")
    load_flax_variables(det.net, load_flax_msgpack(ASSET)[0])
    rec = CTCRecognizer(num_classes=37, device="cuda")
    seeded_weights(rec.net, SEED + 3)
    chains = phase_chains(det, rec)
    buckets = phase_buckets(det, rec)
    del det, rec
    torch.cuda.empty_cache()
    return chains, buckets


# --- ROADMAP Queue 1 items 12 and 14: int8 serving, data parallelism ---------


def int8_accumulators(net, pages_norm):
    """The int32 accumulators of the detector's stem and of one 3x3x512 conv
    (layer 4's last conv2) on the first page, on the card against the CPU:
    an exact float64 conv of the same int8 operands, rounded. Returns
    {layer: (equal, max |acc|, shape)}."""
    import torch.nn.functional as F

    from megreader_tpu_torch.ops import quantize as q

    conv = net.backbone.layer4_block1.conv2
    seen = {}
    hook = conv.register_forward_hook(lambda m, i, o: seen.setdefault("x", i[0].detach()))
    with torch.no_grad():
        net.eval()(pages_norm[:1], heads=("prob",))
    hook.remove()
    out = {}
    for name, mod, x in (("stem 7x7/2 3->64", net.backbone.stem_conv,
                          pages_norm[:1].permute(0, 3, 1, 2)),
                         ("layer4 conv2 3x3 512->512", conv, seen["x"])):
        xq, _ = q.qtensor(x)
        wq, _ = q.qweight(mod.weight.detach())
        acc = q.conv_int8_acc(xq, wq, mod.stride, mod.padding).cpu()
        ref = torch.round(F.conv2d(xq.cpu().double(), wq.cpu().double(), stride=mod.stride,
                                   padding=mod.padding)).to(torch.int32)
        out[name] = (acc.dtype == torch.int32 and torch.equal(acc, ref),
                     int(ref.abs().max()), tuple(acc.shape))
    return out


def int8_dense_accumulators(rec_net, crops):
    """The int32 accumulators of ``int_mm`` (cuBLASLt ``_int_mm`` with its
    padding) on the card against the CPU's exact int64 product of the same
    int8 operands: config #1's classifier on its input from ``crops``, and
    the attention decoder's per-step shapes at 4 rows (``attn_v``'s one
    output, ``out``'s 512 -> 39) on seeded operands. Returns {case: (equal,
    max |acc|, shape)}."""
    from megreader_tpu_torch.ops import quantize as q

    seen = {}
    hook = rec_net.classifier.register_forward_hook(
        lambda m, i, o: seen.setdefault("x", i[0].detach()))
    with torch.no_grad():
        rec_net.eval()(crops)
    hook.remove()
    x = seen["x"]
    rng = np.random.default_rng(SEED + 81)
    draw = lambda *shape: torch.as_tensor(  # noqa: E731
        rng.integers(-127, 128, shape).astype(np.int8)).cuda()
    cases = {
        f"classifier {x.shape[-1]}->{rec_net.classifier.out_features} at M "
        f"{x.numel() // x.shape[-1]}": (q.qtensor(x)[0].reshape(-1, x.shape[-1]),
                                        q.qweight(rec_net.classifier.weight.detach())[0]),
        "attn_v 256->1 at M 4": (draw(4, 256), draw(1, 256)),
        "out 512->39 at M 4": (draw(4, 512), draw(39, 512)),
    }
    out = {}
    for name, (a, b) in cases.items():
        acc = q.int_mm(a, b).cpu()
        ref = (a.cpu().long() @ b.cpu().long().t()).to(torch.int32)
        out[name] = (acc.dtype == torch.int32 and torch.equal(acc, ref),
                     int(ref.abs().max()), tuple(acc.shape))
    return out


#: the card's int8 output lies within this factor of the CPU's int8 noise
#: (largest and mean |diff| from the CPU's float32 output). The card's
#: float32 activations differ from the CPU's by about 1e-6; where that moves
#: an int8 rounding, the change cascades through the next layers' roundings
#: and draws their int8 noise anew, so the card's int8 output is an int8
#: rendition of the net as the CPU's is, not a copy of it (PR 16, call 3:
#: 0.052 apart where each lies 0.063 from float32). Each int8 layer is held
#: bit-equal to the CPU's on the input it saw on the card.
INT8_NOISE_FACTOR = 2.0


def int8_card_against_cpu(what: str, net, x, fwd):
    """``fwd(net, x)`` in int8 on the card against a CPU copy of ``net``
    (same weights, same input): every int8 layer's output bit-equal to the
    CPU layer's on the input that layer saw on the card, and the card's
    int8 output as far from the CPU's float32 as the CPU's int8 is, within
    ``INT8_NOISE_FACTOR``. Returns the gaps {name: (max, mean)}."""
    from megreader_tpu_torch.ops import quantize as q

    cpu_net, xc = copy.deepcopy(net).cpu(), x.cpu()
    cpu_layers = dict(q.int8_layers(cpu_net))
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, i, o, name=name: seen.append((name, i[0].detach(), o.detach())))
        for name, m in q.int8_layers(net)]
    with torch.no_grad():
        with q.int8_context(net):
            card8 = fwd(net, x).float().cpu()
        for h in hooks:
            h.remove()
        card32 = fwd(net, x).float().cpu()
        unequal = []
        for name, xin, out in seen:
            mod = cpu_layers[name]
            fn = q.conv_int8 if isinstance(mod, q.Conv2d) else q.dense_int8
            ref = fn(mod, xin.cpu())
            got = out.cpu()
            if got.dtype != ref.dtype or not torch.equal(got, ref):
                unequal.append((name, float((got.float() - ref.float()).abs().max())))
        with q.int8_context(cpu_net):
            cpu8 = fwd(cpu_net, xc).float()
        cpu32 = fwd(cpu_net, xc).float()
    calls = len(seen)
    del cpu_net, seen

    def gap(a, b):
        d = (a - b).abs()
        return float(d.max()), float(d.mean())

    gaps = {"card int8 vs CPU float32": gap(card8, cpu32),
            "CPU int8 vs CPU float32": gap(cpu8, cpu32),
            "card int8 vs CPU int8": gap(card8, cpu8),
            "card float32 vs CPU float32": gap(card32, cpu32)}
    log(f"int8 phase, {what}: {calls - len(unequal)} of the {calls} int8 layer calls on the "
        f"card bit-equal to the CPU's on the same inputs"
        f"{'' if not unequal else ', differing: ' + json.dumps(unequal)}; "
        f"(max |diff|, mean |diff|) {json.dumps(gaps)}")
    (cmax, cmean), (nmax, nmean) = gaps["card int8 vs CPU float32"], gaps["CPU int8 vs CPU float32"]
    if unequal:
        raise AssertionError(f"int8 phase: {what}: int8 layers differ from the CPU's: {unequal}")
    if not (torch.isfinite(card8).all() and 0 < nmax and cmax <= INT8_NOISE_FACTOR * nmax
            and cmean <= INT8_NOISE_FACTOR * nmean):
        raise AssertionError(f"int8 phase: the card's int8 {what} lies more than "
                             f"{INT8_NOISE_FACTOR} x the CPU's int8 noise from float32: {gaps}")
    return gaps


#: the int8 H-mean of the asset lies within this of float32's
INT8_HMEAN_GAP = 0.02


def phase_int8(B: int = 8, hw: int = 640, rec_B: int = 64, reps: int = 5, cpu_pages: int = 1):
    """int8 serving (``ops/quantize.py``): the trained detector of the asset
    at the serving shape and a seeded config-#1 recognizer, each in float32,
    bf16 and int8; the int32 accumulators of convs and of ``int_mm`` against
    the CPU; the int8 prob map (on ``cpu_pages`` pages: the CPU's time) and
    recognizer logits against a CPU copy of each net; ``cli.eval --int8`` of
    the asset on 8 ``TextPages`` within ``INT8_HMEAN_GAP`` of float32.
    Returns every kernel's launches in the phase."""
    from megreader_tpu_torch.cli import eval as cli_eval
    from megreader_tpu_torch.compat.msgpack import load_flax_msgpack
    from megreader_tpu_torch.compat.weights import load_flax_variables
    from megreader_tpu_torch.core.registry import COMPONENTS
    from megreader_tpu_torch.models.detector import SegDetector
    from megreader_tpu_torch.models.recognizer import CTCRecognizer
    from megreader_tpu_torch.ops.image import normalize
    from megreader_tpu_torch.ops.precision import cast_floats
    from megreader_tpu_torch.ops.quantize import int8_context, int8_layers
    from megreader_tpu_torch.train.checkpoint import CheckpointManager
    from megreader_tpu_torch.train.train_step import OptimizerConfig, create_train_state

    t_phase = time.perf_counter()
    counters = zeroed_counters()
    total = dict.fromkeys(counters, 0)
    variables, asset_step = load_flax_msgpack(ASSET)
    det = SegDetector(device="cuda")
    load_flax_variables(det.net, variables)
    pages_np = np.stack([TextPages(B, 5, (hw, hw))[i]["image"] for i in range(B)])
    x = normalize(torch.as_tensor(pages_np).cuda().float())

    for name, (equal, peak, shape) in int8_accumulators(det.net, x).items():
        log(f"int8 phase, int32 accumulators of the {name} on page 0 {shape}: card "
            f"{'equal to' if equal else 'DIFFER from'} the CPU's (exact float64 conv of the "
            f"same int8 operands), largest |acc| {peak}")
        if not equal:
            raise AssertionError(f"int8 phase: the {name}'s int32 accumulators differ")

    times = {}
    net = det.net.eval()
    with torch.no_grad():
        probs = {}
        for mode in ("float32", "bf16", "int8"):
            m, xi = (cast_floats(net), x.bfloat16()) if mode == "bf16" else (net, x)
            with int8_context(net) if mode == "int8" else contextlib.nullcontext():
                fwd = lambda: m(xi, heads=("prob",))["prob"]  # noqa: E731
                probs[mode] = fwd().float()
                times[f"det_fwd_ms_{mode}"] = cuda_ms(fwd, reps)
        for mode in ("bf16", "int8"):
            gap = float((probs[mode] - probs["float32"]).abs().max())
            masks = float(((probs[mode] > 0.3) != (probs["float32"] > 0.3)).float().mean())
            log(f"int8 phase, detector prob map in {mode} against float32: max |diff| {gap}, "
                f"pixels on the other side of 0.3 {masks}")
            if not torch.isfinite(probs[mode]).all():
                raise AssertionError(f"int8 phase: the {mode} prob map is not finite")
        int8_card_against_cpu(f"detector prob map of {cpu_pages} pages", net, x[:cpu_pages],
                              lambda m, xi: m(xi, heads=("prob",))["prob"])

        rec = CTCRecognizer(num_classes=37, device="cuda")
        seeded_weights(rec.net, SEED + 3)
        crops = torch.as_tensor(np.random.default_rng(SEED + 80).standard_normal(
            (rec_B, 32, 100, 3)).astype(np.float32)).cuda()
        for name, (equal, peak, shape) in int8_dense_accumulators(rec.net, crops).items():
            log(f"int8 phase, int32 accumulators of int_mm, {name} {shape}: card "
                f"{'equal to' if equal else 'DIFFER from'} the CPU's (exact int64 product), "
                f"largest |acc| {peak}")
            if not equal:
                raise AssertionError(f"int8 phase: int_mm's accumulators differ ({name})")
        int8_card_against_cpu(f"config-#1 logits of {rec_B} crops", rec.net, crops,
                              lambda m, xi: m.eval()(xi))
        ids = {}
        for mode in ("float32", "bf16", "int8"):
            rnet, xi = ((cast_floats(rec.net), crops.bfloat16()) if mode == "bf16"
                        else (rec.net, crops))
            with int8_context(rec.net) if mode == "int8" else contextlib.nullcontext():
                dec = lambda: rec.decode(xi, net=rnet)  # noqa: E731
                ids[mode] = dec()[0].cpu()
                ms = cuda_ms(dec, reps)
            times[f"rec_decode_ms_{mode}"] = ms
            times[f"crops_per_sec_{mode}"] = rec_B / (ms / 1e3)
        agree = {m: float((ids[m] == ids["float32"]).all(1).float().mean())
                 for m in ("bf16", "int8")}
        log(f"int8 phase, config #1 greedy ids (seeded weights, {rec_B} crops) equal to "
            f"float32's on a share of the crops: {json.dumps(agree)}; "
            f"{len(list(int8_layers(rec.net)))} of the recognizer's layers and "
            f"{len(list(int8_layers(det.net)))} of the detector's run int8")
    log(f"int8 phase [{CARD}]: detector forward at {B}x{hw}x{hw} (prob head, CUDA events, "
        f"median of {reps}) and config-#1 greedy decode of {rec_B} 32x100 crops: "
        + json.dumps(times))
    add_counts(total, counters)  # run_cli counts its own runs from here on

    with tempfile.TemporaryDirectory() as tmp:
        COMPONENTS.register(TextPages)
        CheckpointManager(tmp).save(create_train_state(det, OptimizerConfig()), asset_step,
                                    force=True)
        argv = [os.path.join(ROOT, "experiments", "seg_detector_synth.yaml"),
                "--experiment.workspace", tmp,
                "--experiment.eval_dataset", node("TextPages", n=B, seed=5),
                "--experiment.batch_size", str(B)]
        hmean = {}
        for mode, extra in (("float32", []), ("int8", ["--int8"])):
            _, got, _, printed = run_cli(f"cli.eval {mode} (trained detector)", cli_eval.main,
                                         [*argv, *extra], total, phase="int8")
            if not got["ccl"] or len(printed) != 1:
                raise AssertionError(f"int8 phase: cli.eval {mode} printed {printed}, "
                                     f"launches {got}")
            hmean[mode] = printed[0]["hmean"]
    log(f"int8 phase [{CARD}]: the asset's H-mean on {B} TextPages, float32 "
        f"{hmean['float32']} (0.9677 in the cli phase of PR 13), int8 {hmean['int8']}")
    if not abs(hmean["int8"] - hmean["float32"]) <= INT8_HMEAN_GAP:
        raise AssertionError(f"int8 phase: the int8 H-mean {hmean['int8']} is not within "
                             f"{INT8_HMEAN_GAP} of float32's {hmean['float32']}")
    if not total["ccl"]:
        raise AssertionError(f"int8 phase: the CCL kernel did not launch: {total}")
    log(f"int8 phase: launches {json.dumps(total)}; {time.perf_counter() - t_phase:.1f} s "
        "(host clock)")
    del det, rec
    torch.cuda.empty_cache()
    return total


def phase_parallel(B: int = 64, steps: int = 4, pages: int = 8, hw: int = 640):
    """Data parallelism (``parallel/mesh.py``) at world size 1 over NCCL:
    config #1 through ``Experiment``/``Trainer`` with ``use_mesh=True``
    against ``use_mesh=False`` from the same weights and batches (losses and
    parameters bit-equal), then one serving batch through
    ``E2EPipeline.build(mesh)`` against ``run``. Returns every kernel's
    launches in the phase."""
    import torch.distributed as dist

    from megreader_tpu_torch.compat.msgpack import load_flax_msgpack
    from megreader_tpu_torch.compat.weights import load_flax_variables
    from megreader_tpu_torch.experiment import Experiment
    from megreader_tpu_torch.models.detector import SegDetector
    from megreader_tpu_torch.models.recognizer import CTCRecognizer
    from megreader_tpu_torch.parallel import init_mesh
    from megreader_tpu_torch.pipelines.e2e import E2EPipeline

    t_phase = time.perf_counter()
    total = dict.fromkeys(kernel_counters(), 0)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the two runs' convs alike
    with tempfile.TemporaryDirectory() as tmp:
        mesh = init_mesh(f"file://{os.path.join(tmp, 'rendezvous')}", 1, 0, device="cuda")
        try:
            log(f"parallel phase: process group {dist.get_backend()}, rank {mesh.rank} of "
                f"{mesh.world_size} on {mesh.device}")
            runs = {}
            for use_mesh in (False, True):
                rec = CTCRecognizer(num_classes=37, device="cuda")
                seeded_weights(rec.net, SEED + 70)
                ws = os.path.join(tmp, f"mesh_{use_mesh}")
                exp = Experiment(rec, WordCrops(B * steps, SEED + 71),
                                 optimizer=adam_warmup_cosine(), workspace=ws, batch_size=B,
                                 epochs=1, log_every=1, use_mesh=use_mesh)
                counters = zeroed_counters()
                t0 = time.perf_counter()
                state = exp.make_trainer().train(resume=False)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = add_counts(total, counters)
                if got["ctc_alpha"] != steps or got["ctc_beta"] != steps:
                    raise AssertionError(f"parallel phase: use_mesh={use_mesh} launched {got}")
                _, losses, _ = step_seconds(ws)
                runs[use_mesh] = (losses, {k: v.clone() for k, v in
                                           state.module.state_dict().items()})
                log(f"parallel phase, config #1 use_mesh={use_mesh}: {steps} steps of {B} in "
                    f"{wall:.2f} s (host clock, the loader's start included) [{CARD}], losses "
                    f"{losses}")
            (l0, p0), (l1, p1) = runs[False], runs[True]
            same = l0 == l1 and all(torch.equal(v, p1[k]) for k, v in p0.items())
            log(f"parallel phase: use_mesh=True losses and parameters "
                f"{'bit-equal to' if same else 'DIFFER from'} use_mesh=False's")
            if not same:
                raise AssertionError("parallel phase: the mesh step differs at world size 1")

            det = SegDetector(device="cuda")
            load_flax_variables(det.net, load_flax_msgpack(ASSET)[0])
            pipe = E2EPipeline(det, rec, device="cuda")
            pages_np = np.stack([TextPages(pages, 5, (hw, hw))[i]["image"]
                                 for i in range(pages)]).astype(np.float32)
            counters = zeroed_counters()
            want = pipe.run(None, None, pages_np)
            got_out = pipe.build(mesh)(None, None, pages_np)
            torch.cuda.synchronize()
            add_counts(total, counters)
            worst = {}
            for k, v in want.items():
                g = got_out[k]
                if g.shape != v.shape or g.dtype != v.dtype:
                    raise AssertionError(f"parallel phase: build(mesh) {k} {g.shape} {g.dtype}")
                if v.is_floating_point():
                    worst[k] = float((g - v).abs().max())
                elif not torch.equal(g, v):
                    raise AssertionError(f"parallel phase: build(mesh) {k} differs from run")
            log(f"parallel phase: build(mesh) on {pages} pages: ids, lengths and valid equal "
                f"to run's ({int(want['valid'].sum())} valid regions), float outputs' max "
                f"|diff| {json.dumps(worst)}")
            if max(worst.values()) > 1e-3:
                raise AssertionError(f"parallel phase: build(mesh) floats differ: {worst}")
        finally:
            dist.destroy_process_group()
            torch.backends.cudnn.deterministic = deterministic
    for n in ("ctc_alpha", "ctc_beta", "ccl"):
        if not total[n]:
            raise AssertionError(f"parallel phase: kernel {n} did not launch: {total}")
    log(f"parallel phase: launches {json.dumps(total)}; {time.perf_counter() - t_phase:.1f} s "
        "(host clock)")
    del det, rec, pipe
    torch.cuda.empty_cache()
    return total


def seed_dcn_offsets(net, x, seed: int, target: float = 1.5) -> list:
    """Seeded weights put a deformable conv's offsets near 0. Redraw each
    ``DeformableConv``'s kernel N(0, 2 / (K C)) and scale its offset rows so
    that its raw offsets on the normalized pages ``x`` have std ``target``:
    fractional, and about a sixth beyond +-2. Block by block in trunk order,
    each measured after the ones before it are set. Returns each block's
    ``dcn_offset_saturation`` on ``x``."""
    from megreader_tpu_torch.models.deform import DeformableConv, dcn_offset_saturation

    rng = np.random.default_rng(seed)
    blocks = [(n, m) for n, m in net.named_modules() if isinstance(m, DeformableConv)]
    sats = []
    for name, m in blocks:
        K = m.kernel_size ** 2
        seen = []
        hook = m.offset_conv.register_forward_hook(lambda mod, a, o: seen.append(o[:, :2 * K]))
        with torch.no_grad():
            net(x, heads=("prob",))
            hook.remove()
            k = m.kernel
            k.copy_(torch.from_numpy(rng.standard_normal(tuple(k.shape)).astype(np.float32)
                                     * np.sqrt(2.0 / k.shape[0])))
            a = target / float(seen[0].std())
            m.offset_conv.weight[:2 * K] *= a
            m.offset_conv.bias[:2 * K] *= a
    for name, m in blocks:
        seen = []
        hook = m.offset_conv.register_forward_hook(
            lambda mod, a, o, K=m.kernel_size ** 2: seen.append(o[:, :2 * K]))
        with torch.no_grad():
            net(x, heads=("prob",))
        hook.remove()
        sats.append((name, {k: float(v) for k, v in dcn_offset_saturation(seen[0]).items()}))
    return sats


def phase_dcn(B: int = 8, hw: int = 640, steps: int = 4):
    """``seg_detector_dcn_synth.yaml``'s detector (ResNet-18 with deformable
    stages 3 and 4, FPN 256, heads 64) at full width on seeded weights whose
    offsets are fractional and partly beyond +-2: B pages of hw x hw on the
    card against the CPU, ``dcn_offset_saturation``, one deformable conv
    (and its parts) and the whole detector by CUDA events beside the plain
    ones, ``steps`` mixed-precision steps through ``Experiment.from_yaml`` and
    ``Trainer``, and one ``E2EPipeline`` batch with the config-#1 recognizer
    (the CCL kernel's labels equal to the plain CCL's). Returns every
    kernel's launches in the phase."""
    from megreader_tpu_torch.core.registry import COMPONENTS
    from megreader_tpu_torch.experiment import Experiment
    from megreader_tpu_torch.models.deform import deform_sample
    from megreader_tpu_torch.models.detector import SegDetector
    from megreader_tpu_torch.models.recognizer import CTCRecognizer
    from megreader_tpu_torch.ops.ccl import connected_components_reference
    from megreader_tpu_torch.ops.image import normalize
    from megreader_tpu_torch.pipelines.e2e import E2EPipeline

    t_phase = time.perf_counter()
    total = dict.fromkeys(kernel_counters(), 0)
    rng = np.random.default_rng(SEED + 80)
    pages_np = make_pages(rng, B, hw, hw)
    pages = torch.from_numpy(pages_np).cuda()
    x = normalize(pages)
    det = SegDetector(backbone="resnet18", dcn_stages=(3, 4), fpn_dim=256, head_dim=64, k=50.0,
                      device="cuda")
    seeded_weights(det.net, SEED + 81)
    sats = seed_dcn_offsets(det.net, x, SEED + 82)
    log(f"dcn phase: dcn_offset_saturation on {B} pages of {hw}x{hw} (max_offset 2), by "
        "block: " + json.dumps(dict(sats)))
    if not all(0.0 < v["frac_clipped"] < 0.5 for _, v in sats):
        raise AssertionError("dcn phase: the seeded offsets must be partly beyond +-2")
    rec = CTCRecognizer(num_classes=37, device="cuda")
    seeded_weights(rec.net, SEED + 83)
    pipe = E2EPipeline(det, rec, max_regions=32, box_thresh=0.3, device="cuda")
    calibrate_prob_head(pipe, det.net, pages)

    # the card against the CPU on the same weights and pages
    det_cpu = copy.deepcopy(det.net).cpu()
    with torch.no_grad():
        prob = pipe.detect(det.net, pages).cpu()
        prob_c = pipe.detect(det_cpu, torch.from_numpy(pages_np))
    gap = float((prob - prob_c).abs().max())
    flips = float(((prob > pipe.bin_thresh) != (prob_c > pipe.bin_thresh)).float().mean())
    log(f"dcn phase: prob map at {B}x{hw}x{hw} on the card vs the CPU: max |diff| {gap:.3g} "
        f"(tolerance 1e-3), mask pixels that differ {flips:.3g} (tolerance 1e-5)")
    if not gap <= 1e-3 or not flips <= 1e-5:
        raise AssertionError(f"dcn phase: prob maps differ by {gap}, masks on {flips}")
    del det_cpu

    # one deformable conv (layer3_block0.conv2, on its input here) and its
    # parts, the 3x3 conv it replaces, the whole detector and the plain one
    dcn = det.net.backbone.layer3_block0.conv2
    seen = []
    hook = dcn.register_forward_hook(lambda m, a, o: seen.append(a[0]))
    with torch.no_grad():
        det.net(x, heads=("prob",))
    hook.remove()
    xin = seen[0]
    plain_conv = torch.nn.Conv2d(xin.shape[1], xin.shape[1], 3, 1, 1, bias=False).cuda()
    plain_det = SegDetector(backbone="resnet18", fpn_dim=256, head_dim=64, device="cuda")
    seeded_weights(plain_det.net, SEED + 81)
    nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
    with torch.no_grad():
        off, mod = dcn.offsets_and_modulation(xin)
        sampled = deform_sample(nhwc(xin), nhwc(off), nhwc(mod))
        flat = sampled.reshape(*sampled.shape[:3], -1)
        parts = {
            "deformable_conv": lambda: dcn(xin),
            "offset_conv": lambda: dcn.offsets_and_modulation(xin),
            "sampling": lambda: deform_sample(nhwc(xin), nhwc(off), nhwc(mod)),
            "contraction": lambda: flat @ dcn.kernel,
            "plain_3x3_conv": lambda: plain_conv(xin),
            "dcn_detector": lambda: det.net(x, heads=("prob",)),
            "plain_detector": lambda: plain_det.net(x, heads=("prob",)),
        }
        times = {k: cuda_ms(f, reps=10) for k, f in parts.items()}
        busy = {k: device_busy_ms(parts[k]) for k in ("deformable_conv", "sampling",
                                                      "dcn_detector", "plain_detector")}
    log(f"dcn phase [{CARD}]: ms by CUDA events (median of 10) at {tuple(xin.shape)} (the "
        f"block) and {B}x{hw}x{hw} (the detectors, prob head): " + json.dumps(times)
        + "; kernel-busy ms " + json.dumps(busy))
    del plain_det, plain_conv, sampled, flat

    # mixed precision through the YAML (compute_dtype bfloat16, Adam 3e-4)
    COMPONENTS.register(TextPages)
    cfg = os.path.join(ROOT, "experiments", "seg_detector_dcn_synth.yaml")
    with tempfile.TemporaryDirectory() as ws:
        exp = Experiment.from_yaml(cfg, {
            "experiment.model.device": "cuda", "experiment.workspace": ws,
            "experiment.train_dataset": {"class": "TextPages", "n": B * steps,
                                         "seed": SEED + 84, "hw": [hw, hw]},
            "experiment.eval_dataset": {"class": "TextPages", "n": B, "seed": SEED + 85,
                                        "hw": [hw, hw]},
            "experiment.batch_size": B, "experiment.epochs": 1, "experiment.log_every": 1})
        if exp.model.net.backbone.layer4_block1.conv2.__class__.__name__ != "DeformableConv":
            raise AssertionError("dcn phase: the YAML's detector has no deformable stage 4")
        t0 = time.perf_counter()
        state = exp.make_trainer().train(resume=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _, losses, _ = step_seconds(ws)
    dtypes = {str(t.dtype) for t in (*exp.model.net.parameters(), *exp.model.net.buffers())
              if t.is_floating_point()}
    log(f"dcn phase, seg_detector_dcn_synth.yaml (bf16 mixed precision): {state.step} steps of "
        f"{B} pages in {wall:.2f} s (host clock, loader and device GT maps included) [{CARD}]; "
        f"losses {losses}; parameter and buffer dtypes {sorted(dtypes)}")
    if state.step != steps or len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"dcn phase: {state.step} steps, losses {losses}")
    if dtypes != {"torch.float32"}:
        raise AssertionError(f"dcn phase: dtypes {dtypes} in the trained model")
    del exp, state

    # one serving batch: the CCL kernel launches, its labels equal the plain CCL's
    counters = zeroed_counters()
    with torch.no_grad():
        out = pipe.run(None, None, pages)
        prob = pipe.detect(det.net, pages)
        labels = pipe.label(prob)
    torch.cuda.synchronize()
    got = add_counts(total, counters)
    want, _ = connected_components_reference(prob > pipe.bin_thresh, pipe.ccl_iters,
                                             return_sweeps=True)
    run_ms = cuda_ms(lambda: pipe.run(None, None, pages), reps=5)
    log(f"dcn phase: E2EPipeline batch with the DCN detector: {int(out['valid'].sum())} valid "
        f"regions, launches {json.dumps({n: v for n, v in got.items() if v})}, CCL labels "
        f"{'equal to' if torch.equal(labels, want) else 'DIFFER from'} the plain CCL's; "
        f"{run_ms} ms a batch by CUDA events = {B / run_ms * 1e3:.2f} pages/s [{CARD}]")
    if got["ccl"] != 2 or not torch.equal(labels, want) or not bool(out["valid"].any()):
        raise AssertionError(f"dcn phase: serving launches {got}, labels equal "
                             f"{torch.equal(labels, want)}, valid {int(out['valid'].sum())}")
    log(f"dcn phase: launches {json.dumps(total)}; {time.perf_counter() - t_phase:.1f} s "
        "(host clock)")
    del det, rec, pipe
    torch.cuda.empty_cache()
    return total


class SpotterPages(TextPages):
    """``TextPages`` with the host GT maps the shared-trunk spotter trains its
    detection heads on (gt, mask, thresh_map, thresh_mask), rasterized by the
    port's ``make_detection_gt`` on the CPU (the card's machine has no cv2);
    ``gt_maps`` False (the RoI spotter's experiment sets it) leaves them out."""

    def __init__(self, n: int, seed: int, hw=(640, 640), gt_maps: bool = True):
        super().__init__(n, seed, hw)
        self.gt_maps = gt_maps

    def __getitem__(self, i: int):
        from megreader_tpu_torch.ops.gt_maps import make_detection_gt, pad_polygons

        item = super().__getitem__(i)
        if self.gt_maps:
            bufs = pad_polygons(item["polygons"], item["ignore"], max(1, len(item["polygons"])))
            maps = make_detection_gt(*(torch.from_numpy(a)[None] for a in bufs),
                                     hw=tuple(self.hw))
            item.update({k: v[0].numpy() for k, v in maps.items()})
        return item


def spotter_ctc_rows(model, batch):
    """The spotter's CTC pair held against the plain version on the rows a
    train step gives it (the invalid slots' dummy blank targets among them):
    nll rtol 1e-4 and d(sum nll)/d(log-probs) within 1e-3 of its largest
    magnitude. Returns (rows, invalid rows, nll gap, gradient gap)."""
    from megreader_tpu_torch.ops.ctc import ctc_nll_cuda, ctc_nll_reference

    with torch.no_grad():
        out = model.apply(batch["image"], batch["rois"], train=False)
    logits = out["logits"] if isinstance(out, dict) else out
    Bq, P, T, C = logits.shape
    lp = torch.log_softmax(logits.float().reshape(Bq * P, T, C), -1).contiguous()
    lab_len = batch["label_length"].to(torch.int32).reshape(-1)
    valid = batch["roi_valid"].reshape(-1) & (lab_len > 0)
    args = (torch.full((Bq * P,), T, dtype=torch.int32, device=lp.device),
            batch["label"].to(torch.int32).reshape(Bq * P, -1).contiguous(),
            torch.where(valid, lab_len, 1).contiguous())
    res = []
    for fn in (ctc_nll_cuda, ctc_nll_reference):
        x = lp.clone().requires_grad_()
        nll = fn(x, *args)
        nll.sum().backward()
        res.append((nll.detach(), x.grad))
    (n_k, g_k), (n_p, g_p) = res
    nll_gap = float(((n_k - n_p).abs() / n_p.abs().clamp(min=1e-6)).max())
    grad_gap = float((g_k - g_p).abs().max()) / float(g_p.abs().max())
    if not (torch.isfinite(n_k).all() and torch.isfinite(g_k).all()):
        raise AssertionError("spotter phase: the CTC kernels gave a non-finite row")
    if not nll_gap <= 1e-4 or not grad_gap <= 1e-3:
        raise AssertionError(f"spotter phase: CTC kernels vs plain: nll {nll_gap}, "
                             f"gradient {grad_gap}")
    return Bq * P, int((~valid).sum()), nll_gap, grad_gap


def float64_twin(net):
    """A float64 copy of ``net`` with every compute dtype cleared (mixed
    precision's bf16 convs and matmuls then promote to float64)."""
    twin = copy.deepcopy(net).double()
    for m in twin.modules():
        for attr in ("compute_dtype", "dtype"):
            if isinstance(getattr(m, attr, None), torch.dtype):
                setattr(m, attr, None)
    return twin


def spotter_step_parity(model, batch, n: int = 2):
    """One train-mode loss and its gradients through the CTC kernels against
    the same step with the plain CTC, on the first ``n`` pages of ``batch``
    with a float64 twin of the net (both CTC losses take float32 logits; in
    bf16 a gradient's rounding amplifies the two losses' float32 noise
    through the trunk): loss rtol 1e-4, every gradient leaf within 1e-3 of
    its largest magnitude plus 1e-5 of the largest over all leaves. Returns
    the two losses and the worst leaf's share of its bound."""
    from megreader_tpu_torch.models import spotter as spotter_module
    from megreader_tpu_torch.ops.ctc import ctc_loss_reference

    batch = {k: (v[:n].double() if v.is_floating_point() else v[:n]) for k, v in batch.items()}
    res = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for plain in (False, True):
            m = copy.copy(model)
            m.net = float64_twin(model.net)
            saved = spotter_module.ctc_loss
            if plain:
                spotter_module.ctc_loss = ctc_loss_reference
            try:
                loss, _ = m.loss(batch, train=True)
                loss.backward()
            finally:
                spotter_module.ctc_loss = saved
            res.append((loss.item(), {k: p.grad.float() for k, p in m.net.named_parameters()
                                      if p.grad is not None}))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (l_k, g_k), (l_p, g_p) = res
    top = max(float(g.abs().max()) for g in g_p.values())
    ratio = {k: float((g_k[k] - g).abs().max()) / (1e-3 * float(g.abs().max()) + 1e-5 * top)
             for k, g in g_p.items()}
    worst = max(ratio, key=ratio.get)
    if not abs(l_k - l_p) <= 1e-4 * abs(l_p) or not ratio[worst] <= 1.0:
        raise AssertionError(f"spotter phase: step through the kernels {l_k} vs plain {l_p}, "
                             f"worst leaf {worst} at {ratio[worst]:.3g} of its bound")
    return l_k, l_p, worst, ratio[worst]


def phase_spotter(B: int = 8, hw: int = 640, K: int = 32, steps: int = 4):
    """``shared_spotter_synth.yaml``'s ``SharedTrunkSpotter`` at full width
    (ResNet-18, FPN 256, heads 64, bins (4, 32), BiLSTM 256, offset head
    128, ``trans_fc2`` non-zero) through ``SpotterE2EPipeline`` (K slots) on
    B pages of hw x hw with the prob head calibrated: float32 and bf16
    against the CPU, one ``'pallas_full'`` batch against ``'xla'``, pages/s
    by events beside ``E2EPipeline``'s on the same pages, the RoI pooling's
    ms; then ``steps`` training steps of ``shared_spotter_synth.yaml`` and of
    ``roi_spotter_synth.yaml`` through ``Experiment.from_yaml``/``Trainer``
    (the CTC pair on every step, held against the plain CTC on the step's
    rows and through a step) and ``evaluate_spotting`` on two eval batches.
    Returns every kernel's launches in the phase."""
    import types

    from megreader_tpu_torch.core.registry import COMPONENTS
    from megreader_tpu_torch.evaluation import evaluate_spotting
    from megreader_tpu_torch.experiment import Experiment
    from megreader_tpu_torch.models.detector import SegDetector
    from megreader_tpu_torch.models.recognizer import CTCRecognizer
    from megreader_tpu_torch.models.spotter import SharedTrunkSpotter
    from megreader_tpu_torch.ops.ccl import extract_regions
    from megreader_tpu_torch.ops.ctc import ctc_greedy_decode
    from megreader_tpu_torch.pipelines.e2e import E2EPipeline
    from megreader_tpu_torch.pipelines.spotter_e2e import SpotterE2EPipeline

    t_phase = time.perf_counter()
    total = dict.fromkeys(kernel_counters(), 0)
    rng = np.random.default_rng(SEED + 90)
    pages_np = make_pages(rng, B, hw, hw)
    pages = torch.from_numpy(pages_np).cuda()
    spot = SharedTrunkSpotter(num_classes=37, backbone="resnet18", fpn_dim=256, head_dim=64,
                              pool_hw=(4, 32), hidden=256, device="cuda")
    seeded_weights(spot.net, SEED + 91)
    pipe = SpotterE2EPipeline(spot, max_regions=K, box_thresh=0.3, device="cuda")
    calibrate_prob_head(types.SimpleNamespace(
        detect=lambda net, p: pipe.detect(net, pipe.fused(net, p)), bin_thresh=pipe.bin_thresh),
        spot.net, pages)
    net_cpu = copy.deepcopy(spot.net).cpu()
    spot_cpu = copy.copy(spot)
    spot_cpu.net = net_cpu
    pg = torch.from_numpy(pages_np)
    gaps = {}

    # float32, stage by stage: each card stage fed the CPU's previous output
    cpu = SpotterE2EPipeline(spot_cpu, max_regions=K, box_thresh=0.3, device="cpu")
    counters = zeroed_counters()
    with torch.no_grad():
        fused_c = cpu.fused(net_cpu, pg)
        prob_c = cpu.detect(net_cpu, fused_c)
        labels_c = cpu.label(prob_c)
        reg_c = cpu.regions(labels_c, prob_c)
        logits_c = net_cpu.eval().recognize(fused_c, reg_c["boxes"])
        fused_d = pipe.fused(spot.net, pages)
        gaps["fused"] = float((fused_d.cpu() - fused_c).abs().max() / fused_c.abs().max())
        prob_d = pipe.detect(spot.net, fused_c.cuda()).cpu()
        gaps["prob"] = float((prob_d - prob_c).abs().max())
        labels_d = pipe.label(prob_c.cuda()).cpu()
        reg_d = pipe.regions(labels_c.cuda(), prob_c.cuda())
        found = reg_c["stats"]["valid"]
        gaps["quads_px"] = float((reg_d["quads"].cpu()[found] - reg_c["quads"][found]).abs().max())
        logits_d = spot.net.eval().recognize(fused_c.cuda(), reg_c["boxes"].cuda()).cpu()
        # float32 RoI sampling at page coordinates (an ulp of 6e-5 px at 640)
        # moves the pooled features by 1e-4 of their scale: the logits are
        # held to float64 on the CPU, the card within 4x the CPU's float32
        net64 = copy.deepcopy(net_cpu).double()
        seen = []
        hook = net64.classifier.register_forward_hook(lambda m, a, o: seen.append(o))
        net64.recognize(fused_c.double(), reg_c["boxes"].double())
        hook.remove()
        logits_64 = seen[0].reshape(logits_c.shape)
        del net64
        scale = float(logits_c.abs().max())
        gaps["logits"] = float((logits_d - logits_c).abs().max())
        gaps["logits_card_vs_f64"] = float((logits_d.double() - logits_64).abs().max())
        gaps["logits_cpu_vs_f64"] = float((logits_c.double() - logits_64).abs().max())
        out_c = cpu.run(None, pg)
        out_d = {k: v.cpu() for k, v in pipe.run(None, pages).items()}
    torch.cuda.synchronize()
    add_counts(total, counters)
    logit_bound = 4 * max(gaps["logits_cpu_vs_f64"], 1e-5 * max(1.0, scale))
    top2 = logits_c.topk(2, -1).values
    clear_frames = (top2[..., 0] - top2[..., 1]) > 2 * logit_bound  # (B, K, T)
    frames_same = (logits_c.argmax(-1) == logits_d.argmax(-1))[clear_frames]
    clear = clear_frames.all(-1)  # (B, K)
    lengths = torch.full((B * K,), logits_c.shape[2], dtype=torch.int32)
    ids_c, _ = ctc_greedy_decode(logits_c.reshape(B * K, *logits_c.shape[2:]), lengths)
    ids_d, _ = ctc_greedy_decode(logits_d.reshape(B * K, *logits_d.shape[2:]), lengths)
    same = (ids_c == ids_d).all(1).reshape(B, K)
    run_same = (out_c["ids"] == out_d["ids"]).all(-1) & (out_c["lengths"] == out_d["lengths"])
    log(f"spotter phase, float32 on the card vs the CPU ({B} pages of {hw}x{hw}, K {K}): "
        f"max |diff| {json.dumps(gaps)} (fused relative to its largest, tolerances: fused 1e-4, "
        f"prob 1e-3, quads 1e-3 px, the card's logits from float64 within 4x the CPU's "
        f"float32 distance, {logit_bound:.3g}; their largest {scale:.4g}); labels "
        f"{'equal' if torch.equal(labels_d, labels_c) else 'DIFFER'}; valid "
        f"{int(reg_c['valid'].sum())} of {B * K} slots; the same class on "
        f"{int(frames_same.sum())} of {int(clear_frames.sum())} frames clear by twice the "
        f"logits' bound (of {clear_frames.numel()}); greedy ids equal on {int(same.sum())} of "
        f"{B * K} slots, on all {int(clear.sum())} of clear-margin frames; whole runs: valid "
        f"{'equal' if torch.equal(out_c['valid'], out_d['valid']) else 'DIFFER'}, ids equal on "
        f"{int(run_same[out_c['valid'] & clear].sum())} of {int((out_c['valid'] & clear).sum())} "
        "valid clear-margin slots")
    if not (gaps["fused"] <= 1e-4 and gaps["prob"] <= 1e-3 and gaps["quads_px"] <= 1e-3
            and gaps["logits_card_vs_f64"] <= logit_bound):
        raise AssertionError(f"spotter phase: card vs CPU {gaps}")
    if not torch.equal(labels_d, labels_c) or not torch.equal(reg_d["valid"].cpu(),
                                                              reg_c["valid"]):
        raise AssertionError("spotter phase: labels or valid slots differ from the CPU's")
    if not bool(frames_same.all()) or not bool(same[clear].all()) or not int(
            reg_c["valid"].sum()):
        raise AssertionError("spotter phase: ids differ on clear-margin slots, or no region")
    if not torch.equal(out_c["valid"], out_d["valid"]) or not bool(
            run_same[out_c["valid"] & clear].all()):
        raise AssertionError("spotter phase: the whole run's valid slots or ids differ")
    del fused_c, fused_d

    # bf16 on 2 pages (the CPU's bf16 convs are slow): the card's against the
    # CPU's, within twice the CPU's own bf16-vs-float32 distance in the prob
    # map, in the share of mask pixels flipped and in valid regions per page
    # (at least 1): a calibrated random head puts many pixels near the
    # threshold, where bf16 flips them
    pipe16 = SpotterE2EPipeline(spot, max_regions=K, box_thresh=0.3, bf16=True, device="cuda")
    cpu16 = SpotterE2EPipeline(spot_cpu, max_regions=K, box_thresh=0.3, bf16=True, device="cpu")
    with torch.no_grad():
        prob16_c = cpu16.detect(net_cpu, cpu16.fused(net_cpu, pg[:2]))
        prob16_d = pipe16.detect(spot.net, pipe16.fused(spot.net, pages[:2])).cpu()
        out16_c = cpu16.run(None, pg[:2])
        out16_d = {k: v.cpu() for k, v in pipe16.run(None, pages[:2]).items()}
    thr = pipe.bin_thresh
    g16 = {"prob": float((prob16_d - prob16_c).abs().max()),
           "cpu_bf16_vs_f32": float((prob16_c - prob_c[:2]).abs().max()),
           "mask": float(((prob16_d > thr) != (prob16_c > thr)).float().mean()),
           "cpu_mask_bf16_vs_f32": float(((prob16_c > thr) != (prob_c[:2] > thr))
                                         .float().mean())}
    n16_c, n16_d = out16_c["valid"].sum(1), out16_d["valid"].sum(1)
    n32_c = out_c["valid"][:2].sum(1)
    n_tol = torch.clamp(2 * (n16_c - n32_c).abs(), min=1)
    log(f"spotter phase, bf16 on the card vs the CPU: {json.dumps(g16)} (tolerances: 2x the "
        f"CPU's own bf16-vs-float32 distance); valid per page {n16_d.tolist()} on the card, "
        f"{n16_c.tolist()} on the CPU in bf16, {n32_c.tolist()} in float32 (tolerance "
        f"{n_tol.tolist()})")
    if not (g16["prob"] <= 2 * max(g16["cpu_bf16_vs_f32"], 1e-3)
            and g16["mask"] <= 2 * max(g16["cpu_mask_bf16_vs_f32"], 1e-4)):
        raise AssertionError(f"spotter phase: bf16 card vs CPU {g16}")
    if not bool(((n16_c - n16_d).abs() <= n_tol).all()) or not bool(out16_d["valid"].any()):
        raise AssertionError("spotter phase: bf16 valid regions differ from the CPU's")
    del net_cpu, spot_cpu, cpu, cpu16

    # 'pallas_full': one launch of each extraction kernel, its statistics
    # equal to the same call on the CPU, valid slots equal to 'xla''s
    full = SpotterE2EPipeline(spot, max_regions=K, box_thresh=0.3,
                              extract_impl="pallas_full", device="cuda")
    counters = zeroed_counters()
    with torch.no_grad():
        out_f = full.run(None, pages)
    torch.cuda.synchronize()
    got_f = add_counts(total, counters)
    with torch.no_grad():
        st_d = extract_regions(labels_c.cuda(), prob_c.cuda(), max_regions=K,
                               impl="pallas_full")
        st_c = extract_regions(labels_c, prob_c, max_regions=K, impl="pallas_full")
    quad_f = float((out_f["quads"] - out_d["quads"].cuda())[out_d["valid"].cuda()].abs().max())
    log(f"spotter phase, extract_impl 'pallas_full': launches "
        f"{json.dumps({n: v for n, v in got_f.items() if v})}; valid "
        f"{'equal' if torch.equal(out_f['valid'].cpu(), out_d['valid']) else 'DIFFER'} to "
        f"'xla''s, quads within {quad_f:.3g} px (tolerance 1e-2); statistics on the card vs "
        f"the CPU: valid and area "
        f"{'equal' if torch.equal(st_d['valid'].cpu(), st_c['valid']) and torch.equal(st_d['area'].cpu(), st_c['area']) else 'DIFFER'}")
    if any(got_f[n] != 1 for n in ("candidates", "moments", "extents", "ccl")):
        raise AssertionError(f"spotter phase: 'pallas_full' launches {got_f}")
    if not (torch.equal(out_f["valid"].cpu(), out_d["valid"]) and quad_f <= 1e-2
            and torch.equal(st_d["valid"].cpu(), st_c["valid"])
            and torch.equal(st_d["area"].cpu(), st_c["area"])):
        raise AssertionError("spotter phase: 'pallas_full' differs from 'xla' or the CPU")

    # times: the spotter in float32 and bf16 beside E2EPipeline on the same pages
    det = SegDetector(backbone="resnet18", fpn_dim=256, head_dim=64, device="cuda")
    rec = CTCRecognizer(num_classes=37, device="cuda")
    seeded_weights(det.net, SEED + 92)
    seeded_weights(rec.net, SEED + 93)
    e2e = E2EPipeline(det, rec, max_regions=K, box_thresh=0.3, device="cuda")
    calibrate_prob_head(e2e, det.net, pages)
    e2e16 = E2EPipeline(det, rec, max_regions=K, box_thresh=0.3, bf16=True, device="cuda")
    with torch.no_grad():
        fused = pipe.fused(spot.net, pages)
        prob = pipe.detect(spot.net, fused)
        labels = pipe.label(prob)
        reg = pipe.regions(labels, prob)
        feats = fused.permute(0, 2, 3, 1).float()
        stage = {
            "fused_map": lambda: pipe.fused(spot.net, pages),
            "prob_head": lambda: pipe.detect(spot.net, fused),
            "ccl": lambda: pipe.label(prob),
            "extract": lambda: pipe.regions(labels, prob),
            "roi_pooling": lambda: spot.net.roi_pool(feats, reg["boxes"]),
            "recognize": lambda: pipe.recognize(spot.net, fused, reg["boxes"]),
        }
        stage_ms = {k: cuda_ms(f, reps=5) for k, f in stage.items()}
        roi_busy = device_busy_ms(stage["roi_pooling"])
        runs = {"spotter_f32": lambda: pipe.run(None, pages),
                "spotter_bf16": lambda: pipe16.run(None, pages),
                "e2e_f32": lambda: e2e.run(None, None, pages),
                "e2e_bf16": lambda: e2e16.run(None, None, pages)}
        run_ms = {k: cuda_ms(f, reps=5) for k, f in runs.items()}
        run_busy = {k: device_busy_ms(f) for k, f in runs.items()}
    log(f"spotter phase [{CARD}]: stage ms (CUDA events, median of 5; the RoI pooling of "
        f"{B * K} boxes, kernel-busy {roi_busy} ms): " + json.dumps(stage_ms))
    log(f"spotter phase [{CARD}]: ms a batch of {B} by CUDA events (median of 5) "
        + json.dumps(run_ms) + "; pages/s " + json.dumps(
            {k: B / v * 1e3 for k, v in run_ms.items()}) + "; kernel-busy ms "
        + json.dumps(run_busy))
    del det, rec, e2e, e2e16, fused, feats, pipe16, full

    # training: both spotter YAMLs in mixed precision, SpotterPages put in
    COMPONENTS.register(SpotterPages)
    data = {"class": "SpotterPages", "n": B * steps, "seed": SEED + 94, "hw": [hw, hw]}
    eval_data = {"class": "SpotterPages", "n": 2 * B, "seed": SEED + 95, "hw": [hw, hw]}
    for name in ("shared_spotter_synth", "roi_spotter_synth"):
        with tempfile.TemporaryDirectory() as ws:
            exp = Experiment.from_yaml(os.path.join(ROOT, "experiments", f"{name}.yaml"), {
                "experiment.model.device": "cuda", "experiment.workspace": ws,
                "experiment.train_dataset": data, "experiment.eval_dataset": eval_data,
                "experiment.batch_size": B, "experiment.epochs": 1,
                "experiment.log_every": 1, "experiment.loader_worker_mode": "thread"})
            counters = zeroed_counters()
            t0 = time.perf_counter()
            state = exp.make_trainer().train(resume=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = add_counts(total, counters)
            _, losses, _ = step_seconds(ws)
            raw = exp.collate([exp.train_loader.dataset[i] for i in range(B)])
            batch = exp.prepare(raw)
            rows = spotter_ctc_rows(exp.model, batch)
            parity = spotter_step_parity(exp.model, batch)
            metrics = evaluate_spotting(exp)
            dtypes = {str(t.dtype) for t in exp.model.net.parameters()}
        log(f"spotter phase, {name} ({type(exp.model).__name__}, bf16 mixed precision): "
            f"{state.step} steps of {B} pages in {wall:.2f} s (host clock) [{CARD}]; launches "
            f"{json.dumps({n: v for n, v in got.items() if v})}; losses {losses}; CTC kernels "
            f"vs plain on the step's {rows[0]} rows ({rows[1]} invalid, dummy blank targets): "
            f"nll {rows[2]:.3g}, gradient {rows[3]:.3g} of its largest; a step on 2 pages "
            f"(float64 twin) through the kernels {parity[0]} vs the plain CTC {parity[1]}, "
            f"worst leaf {parity[2]} at "
            f"{parity[3]:.3g} of its bound; evaluate_spotting on {2 * B} pages "
            f"{json.dumps(metrics)}; parameter dtypes {sorted(dtypes)}")
        if state.step != steps or len(losses) != steps or not all(np.isfinite(losses)):
            raise AssertionError(f"spotter phase, {name}: {state.step} steps, losses {losses}")
        if (got["ctc_alpha"], got["ctc_beta"]) != (steps, steps) or dtypes != {"torch.float32"}:
            raise AssertionError(f"spotter phase, {name}: launches {got}, dtypes {dtypes}")
        if not metrics["n"] > 0 or not all(np.isfinite(list(metrics.values()))):
            raise AssertionError(f"spotter phase, {name}: evaluate_spotting {metrics}")
        del exp, state, batch
    for n in ("ccl", "ctc_alpha", "ctc_beta", "candidates", "moments", "extents"):
        if not total[n]:
            raise AssertionError(f"spotter phase: kernel {n} did not launch: {total}")
    log(f"spotter phase: launches {json.dumps(total)}; {time.perf_counter() - t_phase:.1f} s "
        "(host clock)")
    del spot, pipe
    torch.cuda.empty_cache()
    return total


# --- ROADMAP Queue 1 item 15a: JPEG, LMDB, resuming a JAX state, ResNet-50 ---

JPEG_ASSETS = os.path.join(ROOT, "assets", "jpeg")
IMAGE_ASSETS = os.path.join(ROOT, "assets", "images")


def jpeg_files():
    """The committed JPEG files' manifest: relative path -> {"sha256" of
    cv2's RGB decode, "shape", "bytes"} (``scripts/make_port_jpeg_assets.py``)."""
    with open(os.path.join(JPEG_ASSETS, "manifest.json")) as f:
        return json.load(f)["files"]


def image_files():
    """``assets/images/manifest.json``'s files: relative path -> {"sha256" and
    "shape" of ``cv2.imread``'s RGB decode, "bytes", and "imdecode" (that of
    ``cv2.imdecode``, or None where it refuses) where the two differ}
    (``scripts/make_port_image_assets.py``)."""
    with open(os.path.join(IMAGE_ASSETS, "manifest.json")) as f:
        return json.load(f)["files"]


def rgb_sha(img: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def phase_jpeg():
    """Every committed JPEG decoded on the host by the port (``decode_image``),
    its RGB digest equal to cv2's from the manifest; ms a page for the
    1280x720 pages beside the PNG decode of the same page (``write_png``'s
    Sub rows). Then every file of ``assets/images/`` (PNG, BMP, PNM, JPEG
    variants, JPEGs cut short and progressive files left unrefined, GIF,
    TIFF, JPEG-compressed, CCITT and YCbCr TIFF, WebP, Radiance HDR, PFM,
    Sun raster and JPEG 2000) through ``read_image`` and
    ``decode_image`` against cv2's two routes, each refusing where cv2
    returns None; ms a file by format, each page on its own, and on lines
    of their own the formats CCITT fax TIFF, YCbCr TIFF, Radiance HDR, PFM
    and Sun raster and the 640x640 CCITT Group 4 page, then each JPEG 2000
    file (JP2 and raw codestreams, the 640x640 9/7 page among them), then
    the CIE L*a*b*, signed 16-bit and old-style LZW TIFFs."""
    from megreader_tpu_torch.data.imageio import decode_image, read_image, write_png

    t_phase = time.perf_counter()
    files = jpeg_files()
    bad, ms, page_ms, png_ms = [], {}, [], []
    with tempfile.TemporaryDirectory() as tmp:
        for rel, want in sorted(files.items()):
            with open(os.path.join(JPEG_ASSETS, rel), "rb") as f:
                data = f.read()
            t0 = time.perf_counter()
            img = decode_image(data, rel)
            dt = (time.perf_counter() - t0) * 1e3
            kind = rel.split("/")[0]
            ms.setdefault(kind, []).append(dt)
            if list(img.shape) != want["shape"] or rgb_sha(img) != want["sha256"]:
                bad.append(rel)
            if kind == "pages":
                page_ms.append(dt)
                png = os.path.join(tmp, "page.png")
                write_png(png, img)
                t0 = time.perf_counter()
                read_image(png)
                png_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"jpeg phase: {len(files) - len(bad)} of {len(files)} committed JPEG files decoded on "
        f"the host with cv2's digest (manifest); ms a file on one host thread by kind (mean, "
        f"max) " + json.dumps({k: [statistics.mean(v), max(v)] for k, v in ms.items()})
        + f"; a 1280x720 page: JPEG {page_ms} ms (mean {statistics.mean(page_ms)}), the same "
        f"page as PNG (Sub rows) {png_ms} ms (mean {statistics.mean(png_ms)}) [{CARD}]; "
        f"{time.perf_counter() - t_phase:.1f} s (host clock)")
    if bad:
        raise AssertionError(f"jpeg phase: the port's decode differs from cv2's on {bad}")

    t_formats = time.perf_counter()
    files = image_files()
    bad, ms, refused, jpeg2000_ms = [], {}, 0, {}
    for rel, want in sorted(files.items()):
        path = os.path.join(IMAGE_ASSETS, rel)
        t0 = time.perf_counter()
        try:
            img = read_image(path)
        except ValueError:
            img = None
        dt = (time.perf_counter() - t0) * 1e3
        if rel.endswith((".jp2", ".j2k")):
            jpeg2000_ms[rel] = dt
        name = rel.split("/")[1]
        key = (rel if rel.startswith("pages/") else
               "_".join(name.split("_")[:2]) if name.startswith(("jpeg_cut", "jpeg_unrefined"))
               else name.split("_")[0])
        ms.setdefault(key, []).append(dt)
        if want["sha256"] is None:  # cv2.imread refuses it
            refused += 1
            if img is not None:
                bad.append(f"{rel} (read_image: cv2.imread refuses it)")
        elif img is None or list(img.shape) != want["shape"] or rgb_sha(img) != want["sha256"]:
            bad.append(f"{rel} (read_image)")
        with open(path, "rb") as f:
            data = f.read()
        by_bytes = want.get("imdecode", want)
        try:
            img = decode_image(data, rel)
        except ValueError:
            img = None
        if by_bytes is None or by_bytes["sha256"] is None:
            refused += 1
            if img is not None:
                bad.append(f"{rel} (decode_image: cv2.imdecode refuses it)")
        elif img is None or rgb_sha(img) != by_bytes["sha256"]:
            bad.append(f"{rel} (decode_image)")
    log(f"jpeg phase: {len(files)} files of assets/images read by read_image and decode_image, "
        f"{len(files) - len(bad)} equal to cv2's imread and imdecode digests (manifest; "
        f"{refused} refusals by read_image or decode_image where cv2 returns None); "
        f"read_image ms a "
        f"file on one host thread by format (mean, max, files) "
        + json.dumps({k: [statistics.mean(v), max(v), len(v)] for k, v in ms.items()})
        + f" [{CARD}]; {time.perf_counter() - t_formats:.1f} s (host clock)")
    names = {"fax": "CCITT fax TIFF", "ycbcr": "YCbCr TIFF", "hdr": "Radiance HDR",
             "pfm": "PFM", "ras": "Sun raster", "pages/page_g4.tif": "640x640 CCITT G4 page"}
    log("jpeg phase, CCITT fax and YCbCr TIFF, Radiance HDR, PFM and Sun raster: read_image ms "
        "a file on one host thread (mean, max, files) " + json.dumps(
            {names[k]: [statistics.mean(ms[k]), max(ms[k]), len(ms[k])] for k in names})
        + f" [{CARD}]")
    log("jpeg phase, JPEG 2000: read_image ms a file on one host thread (a refusal's ms is "
        "that of raising ValueError) " + json.dumps(jpeg2000_ms) + f" [{CARD}]")
    variants = {"tifflab": "CIE L*a*b* TIFF", "tiffsigned": "signed 16-bit RGB TIFF",
                "tifflzwold": "old-style LZW TIFF"}
    log("jpeg phase, TIFF variants: read_image ms a file on one host thread (mean, max, files) "
        + json.dumps({variants[k]: [statistics.mean(ms[k]), max(ms[k]), len(ms[k])]
                      for k in variants}) + f" [{CARD}]")
    if bad:
        raise AssertionError(f"jpeg phase: the port's decode differs from cv2's on {bad}")


def lmdb_layout(path: str) -> dict:
    """Pages of an LMDB data file by kind: meta, branch, leaf, overflow runs
    and the pages those runs span (from each page header's flags)."""
    from megreader_tpu_torch.data import lmdb_lite as ll

    with open(os.path.join(path, "data.mdb"), "rb") as f:
        data = f.read()
    ps = 4096
    out = {"meta": 0, "branch": 0, "leaf": 0, "overflow_runs": 0, "overflow_pages": 0}
    pg = 0
    while pg * ps < len(data):
        flags = int.from_bytes(data[pg * ps + 10:pg * ps + 12], "little")
        step = 1
        if flags & ll.P_OVERFLOW:
            step = int.from_bytes(data[pg * ps + 12:pg * ps + 16], "little")
            out["overflow_runs"] += 1
            out["overflow_pages"] += step
        elif flags & ll.P_BRANCH:
            out["branch"] += 1
        elif flags & ll.P_LEAF:
            out["leaf"] += 1
        elif flags & ll.P_META:
            out["meta"] += 1
        pg += step
    return out


def phase_lmdb(B: int = 64, steps: int = 4, workers: int = 4):
    """The 256 committed JPEG crops in an LMDB written by the port's
    ``write_fixture_lmdb`` (overflow values, several leaves under a branch),
    read by ``LMDBRecognitionDataset`` (items equal to the list-file
    dataset's on the same files), its items/s through the ``Loader``, and
    config #1 at full width trained ``steps`` steps from it. Returns every
    kernel's launches in the training run."""
    import functools

    from megreader_tpu_torch.core.charset import Charset
    from megreader_tpu_torch.data.datasets import RecognitionListDataset
    from megreader_tpu_torch.data.lmdb_dataset import LMDBRecognitionDataset
    from megreader_tpu_torch.data.lmdb_lite import Reader, write_fixture_lmdb
    from megreader_tpu_torch.data.loader import Loader, recognition_collate
    from megreader_tpu_torch.experiment import Experiment

    t_phase = time.perf_counter()
    total = dict.fromkeys(kernel_counters(), 0)
    crops = os.path.join(JPEG_ASSETS, "crops")
    with open(os.path.join(crops, "list.txt")) as f:
        items = [line.rstrip("\n").split("\t", 1) for line in f if line.strip()]
    records = {b"num-samples": str(len(items)).encode()}
    for i, (rel, text) in enumerate(items):
        with open(os.path.join(crops, rel), "rb") as f:
            records[f"image-{i + 1:09d}".encode()] = f.read()
        records[f"label-{i + 1:09d}".encode()] = text.encode()
    with tempfile.TemporaryDirectory() as tmp:
        db = os.path.join(tmp, "crops_lmdb")
        t0 = time.perf_counter()
        write_fixture_lmdb(db, records)
        write_s = time.perf_counter() - t0
        layout = lmdb_layout(db)
        reader = Reader(db)
        read_back = dict(reader.items()) == records
        depth = reader.depth
        reader.close()
        ds = LMDBRecognitionDataset(db)
        ref = RecognitionListDataset(os.path.join(crops, "list.txt"))
        same = all(np.array_equal(ds[i]["image"], ref[i]["image"])
                   and ds[i]["text"] == ref[i]["text"] for i in range(0, len(ds), 15))
        log(f"lmdb phase: {len(ds)} JPEG crops ({sum(len(v) for v in records.values())} bytes) "
            f"in an LMDB by the port's writer in {write_s:.3f} s: depth {depth}, pages "
            f"{json.dumps(layout)}; every record read back {read_back}; items equal to the "
            f"list-file dataset's on the same files {same}")
        if not (read_back and same and depth >= 2 and layout["branch"] >= 1
                and layout["leaf"] >= 2 and layout["overflow_runs"] >= 1):
            raise AssertionError(f"lmdb phase: depth {depth}, layout {layout}, read back "
                                 f"{read_back}, items equal {same}")
        rates = {}
        for mode in ("process", "thread"):
            loader = Loader(LMDBRecognitionDataset(db), B,
                            functools.partial(recognition_collate, charset=Charset()),
                            shuffle=True, workers=workers, worker_mode=mode)
            first, after, overall, _ = time_loader(loader, epochs=2)
            loader.close()
            rates[mode] = {"first_batch_s": first, "items_per_s": after,
                           "items_per_s_all": overall}
        log(f"lmdb phase, LMDBRecognitionDataset through the Loader (batch {B}, {workers} "
            f"workers, 2 epochs, host clock; JPEG decode, canvas, collate) [{CARD}]: "
            + json.dumps(rates))
        node_ = {"class": "LMDBRecognitionDataset", "path": db}
        with tempfile.TemporaryDirectory() as ws:
            exp = Experiment.from_yaml(os.path.join(ROOT, "experiments", "ctc_resnet18_synth.yaml"), {
                "experiment.model.device": "cuda", "experiment.workspace": ws,
                "experiment.train_dataset": node_, "experiment.eval_dataset": node_,
                "experiment.batch_size": B, "experiment.epochs": steps * B // len(ds),
                "experiment.log_every": 1})
            counters = zeroed_counters()
            t0 = time.perf_counter()
            state = exp.make_trainer().train(resume=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = add_counts(total, counters)
            exp.train_loader.close()
            _, losses, _ = step_seconds(ws)
    log(f"lmdb phase, config #1 (ResNet-18 rec + 2x BiLSTM 256, batch {B} of 32x100) from the "
        f"LMDB: {state.step} steps in {wall:.2f} s (host clock, loader included) [{CARD}]; "
        f"losses {losses}; launches {json.dumps({n: v for n, v in got.items() if v})}; "
        f"{time.perf_counter() - t_phase:.1f} s (host clock)")
    if state.step != steps or len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"lmdb phase: {state.step} steps, losses {losses}")
    if got != {**dict.fromkeys(got, 0), "ctc_alpha": steps, "ctc_beta": steps}:
        raise AssertionError(f"lmdb phase: launches {got}")
    del exp, state
    return total


def optimizer_snapshot(state) -> dict:
    """A copy of everything a train step moves: the module's parameters and
    buffers, the optimizer's moments, the accumulator, counts and rate."""
    opt = state.optimizer
    params = list(state.module.parameters())
    return {"module": {k: v.detach().clone() for k, v in state.module.state_dict().items()},
            "moments": [{k: v.clone() for k, v in opt.inner.state.get(p, {}).items()
                         if torch.is_tensor(v)} for p in params],
            "acc": [a.clone() for a in opt.acc] if opt.acc is not None else None,
            "count": opt.count, "mini_step": opt.mini_step, "step": state.step,
            "lr": [g["lr"] for g in opt.inner.param_groups]}


def snapshots_equal(a: dict, b: dict) -> list:
    """What differs between two ``optimizer_snapshot``s (empty: equal bit for
    bit)."""
    bad = [k for k in ("count", "mini_step", "step", "lr") if a[k] != b[k]]
    bad += [f"module/{k}" for k in a["module"] if not torch.equal(a["module"][k], b["module"][k])]
    for i, (x, y) in enumerate(zip(a["moments"], b["moments"])):
        if x.keys() != y.keys() or not all(torch.equal(x[k].cpu(), y[k].cpu()) for k in x):
            bad.append(f"moments/{i}")
    if (a["acc"] is None) != (b["acc"] is None) or (
            a["acc"] is not None and not all(torch.equal(x, y)
                                             for x, y in zip(a["acc"], b["acc"]))):
        bad.append("acc")
    return bad


def phase_resume(B: int = 64, per_epoch: int = 3):
    """Config #1 at full width with AdamW, clip, warm-up cosine and
    ``accumulate_steps`` 2: a run of 2 epochs of ``per_epoch`` steps
    (unshuffled) writes its state in JAX's layout after the first epoch (an
    odd step: one mini-step pending), ``export_flax_variables`` +
    ``export_optax_state`` + ``msgpack_serialize``; ``Trainer.train(resume=True)``
    in a fresh workspace takes that file and draws the second epoch's
    batches: its next two steps equal the run that never stopped, bit for
    bit (parameters, buffers, moments, accumulator, count, rate). Returns
    every kernel's launches."""
    from megreader_tpu_torch.compat.msgpack import msgpack_restore, msgpack_serialize
    from megreader_tpu_torch.core.registry import COMPONENTS
    from megreader_tpu_torch.experiment import Experiment
    from megreader_tpu_torch.train.checkpoint import export_jax_state

    t_phase = time.perf_counter()
    total = dict.fromkeys(kernel_counters(), 0)
    COMPONENTS.register(WordCrops)
    cfg = os.path.join(ROOT, "experiments", "ctc_resnet18_synth.yaml")
    data = {"class": "WordCrops", "n": B * per_epoch, "seed": SEED + 100}
    k = per_epoch
    saved, snaps = {}, {"straight": {}, "resumed": {}}

    def run(label, ws):
        exp = Experiment.from_yaml(cfg, {
            "experiment.model.device": "cuda", "experiment.workspace": ws,
            "experiment.train_dataset": data, "experiment.eval_dataset": data,
            "experiment.batch_size": B, "experiment.epochs": 2, "experiment.log_every": 1,
            "experiment.loader_workers": 1, "experiment.optimizer.name": "adamw",
            "experiment.optimizer.weight_decay": 1e-4, "experiment.optimizer.grad_clip": 1.0,
            "experiment.optimizer.accumulate_steps": 2, "experiment.optimizer.warmup_steps": 2,
            "experiment.optimizer.total_steps": 100})
        trainer = exp.make_trainer()
        trainer.loader.shuffle = False  # each epoch draws the same batches

        def hook(model, state):
            snaps[label][state.step] = optimizer_snapshot(state)
            if label == "straight" and state.step == k:
                saved["bytes"] = msgpack_serialize(export_jax_state(state))
            return {}

        trainer.validate_every_steps, trainer.validate_fn = 1, hook
        counters = zeroed_counters()
        state = trainer.train(resume=True)
        torch.cuda.synchronize()
        exp.train_loader.close()
        return state, add_counts(total, counters)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the two runs' convs alike
    try:
        with tempfile.TemporaryDirectory() as ws_a, tempfile.TemporaryDirectory() as ws_b:
            straight, got_a = run("straight", ws_a)
            tree = msgpack_restore(saved["bytes"])
            os.makedirs(os.path.join(ws_b, "checkpoints"))
            with open(os.path.join(ws_b, "checkpoints", f"state_{k:08d}.msgpack"), "wb") as f:
                f.write(saved["bytes"])
            resumed, got_b = run("resumed", ws_b)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    pending = int(tree["opt_state"]["mini_step"])
    diffs = {s: snapshots_equal(snaps["straight"][s], snaps["resumed"][s])
             for s in (k + 1, k + 2) if s in snaps["resumed"]}
    log(f"resume phase, config #1 (AdamW, clip 1.0, warm-up cosine, accumulate_steps 2; batch "
        f"{B}): the state after step {k} in JAX's layout ({len(saved['bytes'])} bytes; "
        f"opt_state keys {sorted(tree['opt_state'])}, mini_step {pending}, count "
        f"{int(tree['opt_state']['gradient_step'])}); resumed by Trainer.train(resume=True) at "
        f"step {min(snaps['resumed']) - 1}; steps {k + 1}-{k + 2} against the run that never "
        f"stopped: {json.dumps({s: d[:5] or 'equal bit for bit' for s, d in diffs.items()})}; "
        f"lr {[snaps['resumed'][s]['lr'][0] for s in sorted(snaps['resumed'])]}, count "
        f"{[snaps['resumed'][s]['count'] for s in sorted(snaps['resumed'])]}; launches "
        f"{json.dumps(got_a)} / {json.dumps(got_b)}; {time.perf_counter() - t_phase:.1f} s "
        "(host clock)")
    if pending != 1 or sorted(diffs) != [k + 1, k + 2] or any(diffs.values()):
        raise AssertionError(f"resume phase: mini_step {pending}, differences {diffs}")
    if straight.step != 2 * k or resumed.step != 2 * k or got_b["ctc_alpha"] != k or (
            got_a["ctc_alpha"] != 2 * k or got_a["ctc_beta"] != 2 * k or got_b["ctc_beta"] != k):
        raise AssertionError(f"resume phase: steps {straight.step} / {resumed.step}, "
                             f"launches {got_a} / {got_b}")
    return total


def damp_residuals(net, scale: float = 0.2) -> None:
    """Scale each Bottleneck's last BatchNorm by ``scale``: seeded at 1, the
    16 residual branches of a ResNet-50 add up to activations of std 3.6e5
    at stage 4 (0.2: about 9), where a trained net keeps them small."""
    from megreader_tpu_torch.models.resnet import Bottleneck

    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, Bottleneck):
                m.bn3.weight.mul_(scale)


def phase_r50(B: int = 8, hw: int = 640, steps: int = 4, cpu_pages: int = 1,
              train_hw: int = 640):
    """DB's deformable ResNet-50 (``resnet50``, ``dcn_stages=(2, 3, 4)``, FPN
    256, heads 64) in ``E2EPipeline`` with the config-#1 recognizer, seeded
    weights with fractional offsets: a batch of B pages of hw x hw in float32
    and bf16 (ms, pages/s, the split by stage) beside the ResNet-18
    detector's, in turns; the CCL kernel's labels equal to the CPU's on the
    same mask; one ``'pallas_full'`` batch; the prob map on ``cpu_pages``
    pages against a float64 CPU reference (phase dcn's bound). Then
    ``steps`` mixed-precision steps of ``seg_detector_icdar_disk.yaml`` with
    the deformable ResNet-50 on the committed 1280x720 JPEG pages (resized to
    ``train_hw``, the YAML's 640) and one ``evaluate_detection`` on them.
    Returns every kernel's launches."""
    from megreader_tpu_torch.evaluation import evaluate_detection
    from megreader_tpu_torch.experiment import Experiment
    from megreader_tpu_torch.models.detector import SegDetector
    from megreader_tpu_torch.models.recognizer import CTCRecognizer
    from megreader_tpu_torch.ops.ccl import connected_components_reference
    from megreader_tpu_torch.ops.image import normalize
    from megreader_tpu_torch.pipelines.e2e import E2EPipeline
    from megreader_tpu_torch.train.train_step import make_train_step

    t_phase = time.perf_counter()
    total = dict.fromkeys(kernel_counters(), 0)
    rng = np.random.default_rng(SEED + 110)
    pages_np = make_pages(rng, B, hw, hw)
    pages = torch.from_numpy(pages_np).cuda()
    x = normalize(pages)
    det = SegDetector(backbone="resnet50", dcn_stages=(2, 3, 4), fpn_dim=256, head_dim=64,
                      k=50.0, device="cuda")
    seeded_weights(det.net, SEED + 111)
    damp_residuals(det.net)
    sats = seed_dcn_offsets(det.net, x, SEED + 112)
    n_dcn = len(sats)
    if n_dcn != 13 or not all(0.0 < v["frac_clipped"] < 0.5 for _, v in sats):
        raise AssertionError(f"r50 phase: {n_dcn} deformable convs, saturation {sats}")
    rec = CTCRecognizer(num_classes=37, device="cuda")
    seeded_weights(rec.net, SEED + 113)
    pipe = E2EPipeline(det, rec, max_regions=32, box_thresh=0.3, device="cuda")
    calibrate_prob_head(pipe, det.net, pages)
    log(f"r50 phase: the deformable ResNet-50 DB detector ({sum(p.numel() for p in det.net.parameters())} "
        f"parameters, {n_dcn} deformable convs; offsets beyond +-2 by block "
        f"{[round(v['frac_clipped'], 3) for _, v in sats]})")

    # the prob map against float64 on the CPU
    det64 = copy.deepcopy(det.net).cpu().double().eval()
    with torch.no_grad():
        prob = pipe.detect(det.net, pages[:cpu_pages]).cpu().double()
        ref = det64(normalize(torch.from_numpy(pages_np[:cpu_pages]).double()),
                    heads=("prob",))["prob"]
    gap = float((prob - ref).abs().max())
    flips = float(((prob > pipe.bin_thresh) != (ref > pipe.bin_thresh)).double().mean())
    log(f"r50 phase: prob map of {cpu_pages} pages on the card (float32) against float64 on the "
        f"CPU: max |diff| {gap:.3g} (bound 1e-3), mask pixels that differ {flips:.3g} (bound "
        "1e-5)")
    if not gap <= 1e-3 or not flips <= 1e-5:
        raise AssertionError(f"r50 phase: prob maps differ by {gap}, masks on {flips}")
    del det64, ref

    # serving: CCL launches and labels against the CPU's, 'pallas_full'
    counters = zeroed_counters()
    with torch.no_grad():
        out = pipe.run(None, None, pages)
    torch.cuda.synchronize()
    got = add_counts(total, counters)
    with torch.no_grad():
        prob = pipe.detect(det.net, pages)
        mask = prob > pipe.bin_thresh
        counters = zeroed_counters()
        labels = pipe.label(prob)
        add_counts(total, counters)
    want = connected_components_reference(mask.cpu(), pipe.ccl_iters)
    labels_equal = torch.equal(labels.cpu(), want)
    full = E2EPipeline(det, rec, max_regions=32, box_thresh=0.3, extract_impl="pallas_full",
                       device="cuda")
    counters = zeroed_counters()
    with torch.no_grad():
        out_f = full.run(None, None, pages)
    torch.cuda.synchronize()
    got_f = add_counts(total, counters)
    quad_f = float((out_f["quads"] - out["quads"]).abs().amax(dim=(-1, -2))[out["valid"]].max())
    log(f"r50 phase: serving batch launches {json.dumps({n: v for n, v in got.items() if v})}, "
        f"{int(out['valid'].sum())} valid regions; CCL labels on the card "
        f"{'equal to' if labels_equal else 'DIFFER from'} the plain CCL's on the CPU (same "
        f"mask); 'pallas_full' launches {json.dumps({n: v for n, v in got_f.items() if v})}, "
        f"valid {'equal' if torch.equal(out_f['valid'], out['valid']) else 'DIFFER'}, quads "
        f"within {quad_f:.3g} px")
    if got["ccl"] != 1 or not labels_equal or not bool(out["valid"].any()):
        raise AssertionError(f"r50 phase: launches {got}, labels equal {labels_equal}")
    if any(got_f[n] != 1 for n in ("ccl", "candidates", "moments", "extents")) or not (
            torch.equal(out_f["valid"], out["valid"]) and quad_f <= 1e-2):
        raise AssertionError(f"r50 phase: 'pallas_full' launches {got_f}, quads {quad_f}")
    del full, out_f

    # times: the deformable ResNet-50 and the ResNet-18 detector, float32
    # and bf16, in turns; the split by stage
    r18 = SegDetector(backbone="resnet18", fpn_dim=256, head_dim=64, device="cuda")
    seeded_weights(r18.net, SEED + 114)
    pipe18 = E2EPipeline(r18, rec, max_regions=32, box_thresh=0.3, device="cuda")
    calibrate_prob_head(pipe18, r18.net, pages)
    pipes = {"r50_f32": pipe, "r18_f32": pipe18,
             "r50_bf16": E2EPipeline(det, rec, max_regions=32, box_thresh=0.3, bf16=True,
                                     device="cuda"),
             "r18_bf16": E2EPipeline(r18, rec, max_regions=32, box_thresh=0.3, bf16=True,
                                     device="cuda")}
    turns = {n: [] for n in pipes}
    split = {}
    with torch.no_grad():
        for name, p in pipes.items():
            net = p.detector.net
            prob = p.detect(net, pages)
            labels = p.label(prob)
            reg = p.regions(labels, prob)
            crops = p.crops(pages, reg)
            split[name] = {
                "detector": cuda_ms(lambda: p.detect(net, pages), reps=5),
                "ccl": cuda_ms(lambda: p.label(prob), reps=5),
                "extract": cuda_ms(lambda: p.regions(labels, prob), reps=5),
                "rectify": cuda_ms(lambda: p.crops(pages, reg), reps=5),
                "recognizer": cuda_ms(lambda: p.recognize(rec.net, crops), reps=5)}
        for _ in range(2):
            for name, p in pipes.items():
                turns[name].append(cuda_ms(lambda: p.run(None, None, pages), reps=5))
        busy = {n: device_busy_ms(lambda: p.run(None, None, pages)) for n, p in pipes.items()}
    log(f"r50 phase [{CARD}]: ms a batch of {B} pages of {hw}x{hw} by CUDA events (median of "
        f"5, two turns) " + json.dumps(turns) + "; pages/s " + json.dumps(
            {n: B / min(v) * 1e3 for n, v in turns.items()}) + "; kernel-busy ms "
        + json.dumps(busy) + "; stage ms (median of 5) " + json.dumps(split))
    del pipes, pipe18, r18

    # 4 mixed-precision steps of the disk YAML on the committed JPEG pages,
    # then evaluate_detection on them (CCL on the card)
    img_dir = os.path.join(JPEG_ASSETS, "pages", "images")
    gt_dir = os.path.join(JPEG_ASSETS, "pages", "gts")
    n_pages = len(os.listdir(img_dir))
    cfg = os.path.join(ROOT, "experiments", "seg_detector_icdar_disk.yaml")
    with tempfile.TemporaryDirectory() as ws:
        exp = Experiment.from_yaml(cfg, {
            "experiment.model.device": "cuda", "experiment.workspace": ws,
            "experiment.model.backbone": "resnet50", "experiment.model.dcn_stages": [2, 3, 4],
            "experiment.train_dataset.image_dir": img_dir,
            "experiment.train_dataset.gt_dir": gt_dir,
            "experiment.eval_dataset.image_dir": img_dir,
            "experiment.eval_dataset.gt_dir": gt_dir, "experiment.batch_size": B,
            "experiment.train_dataset.target_hw": [train_hw, train_hw],
            "experiment.eval_dataset.target_hw": [train_hw, train_hw],
            "experiment.epochs": steps * B // n_pages, "experiment.log_every": 1,
            "experiment.loader_worker_mode": "process"})
        state, ev_ms, host_ms, got = hooked_train(exp, total)
        trained = state.step
        _, losses, _ = step_seconds(ws)
        # the step alone on one decoded batch: the device's share of it
        raw = exp.collate([exp.train_loader.dataset[i] for i in range(B)])
        step_fn = make_train_step(exp.model, prepare=exp.prepare)
        counters = zeroed_counters()
        step_ms = cuda_ms(lambda: step_fn(state, raw), reps=3)
        step_busy = device_busy_ms(lambda: step_fn(state, raw), reps=2)
        add_counts(total, counters)
        counters = zeroed_counters()
        t0 = time.perf_counter()
        metrics = evaluate_detection(exp)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        got_e = add_counts(total, counters)
        exp.eval_loader.close()
        dtypes = {str(t.dtype) for t in exp.model.net.parameters()}
    log(f"r50 phase, seg_detector_icdar_disk.yaml with the deformable ResNet-50 (bf16 mixed "
        f"precision, batch {B} of the {n_pages} committed 1280x720 JPEG pages resized to "
        f"{train_hw}x{train_hw}, process workers) [{CARD}]: {trained} steps, ms a step by CUDA events "
        f"{ev_ms} and host clock {host_ms} (median of steps 2-{steps}), a step on one decoded "
        f"batch {step_ms} ms by CUDA events (median of 3; kernel-busy {step_busy} ms: the "
        f"rest is the loader's); losses {losses}; "
        f"launches {json.dumps({n: v for n, v in got.items() if v})}; evaluate_detection on the "
        f"{n_pages} pages {json.dumps(metrics)} in {eval_s:.2f} s, launches "
        f"{json.dumps({n: v for n, v in got_e.items() if v})} (random weights: no bar); "
        f"parameter dtypes {sorted(dtypes)}; {time.perf_counter() - t_phase:.1f} s (host clock)")
    if trained != steps or len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"r50 phase: {trained} steps, losses {losses}")
    if dtypes != {"torch.float32"} or not got_e["ccl"] or not all(
            np.isfinite(list(metrics.values()))):
        raise AssertionError(f"r50 phase: dtypes {dtypes}, eval launches {got_e}, {metrics}")
    del exp, state, det, rec, pipe
    torch.cuda.empty_cache()
    return total


def tools_overlays(name, out, paths, vis_dir) -> int:
    """Each page's overlay as written, read back, against ``draw_polygons``
    of the page and the printed detections on the host; returns the words."""
    from megreader_tpu_torch.data.imageio import read_image
    from megreader_tpu_torch.postproc.visualizer import draw_polygons

    words = 0
    for path, page in zip(paths, out):
        got = read_image(os.path.join(vis_dir, os.path.splitext(os.path.basename(path))[0]
                                      + ".png"))
        dets = page["detections"]
        want = draw_polygons(read_image(path), [np.array(d["polygon"]) for d in dets],
                             [d["text"] for d in dets])
        if not np.array_equal(got, want):
            raise AssertionError(f"tools phase, {name}: the overlay of {path} differs from "
                                 f"the host's drawing in {int((got != want).any(2).sum())} px")
        words += len(dets)
    return words


def format_pages(tmp: str):
    """The 640x640 pages of ``assets/images/pages/`` (a CMYK JPEG, a palette
    PNG, a 16-bit Adam7 PNG, an RLE8 BMP, a baseline JPEG cut at 60% of its
    bytes, a progressive JPEG cut inside its first AC scan, a GIF, an LZW
    TIFF with Predictor 2, a lossless and a lossy WebP, a JPEG-compressed
    TIFF, a CCITT Group 4 TIFF, a grey 9/7 JPEG 2000), each read by
    ``read_image`` with cv2's digest (the manifest), and
    a PNG twin of each written from that decode: (the pages' paths, the
    twins' paths)."""
    from megreader_tpu_torch.data.imageio import read_image, write_png

    files = image_files()
    pages, twins = [], []
    for rel in sorted(r for r in files if r.startswith("pages/")):
        pages.append(os.path.join(IMAGE_ASSETS, rel))
        img = read_image(pages[-1])
        if rgb_sha(img) != files[rel]["sha256"]:
            raise AssertionError(f"tools phase: read_image of {rel} differs from cv2's")
        stem = os.path.splitext(os.path.basename(rel))[0]
        twins.append(os.path.join(tmp, f"twin_{stem}.png"))
        write_png(twins[-1], img)
    return pages, twins


def twin_check(name: str, out: list, pages: list) -> None:
    """``out``: cli.pipeline's results for ``pages`` and then their PNG twins;
    each page's quads and texts must equal its twin's."""
    n = len(pages)
    words = 0
    for path, page, twin in zip(pages, out[:n], out[n:]):
        a = [(d["polygon"], d["text"]) for d in page["detections"]]
        b = [(d["polygon"], d["text"]) for d in twin["detections"]]
        if a != b:
            raise AssertionError(f"tools phase, {name}: {os.path.basename(path)} gave {a}, its "
                                 f"PNG twin {b}")
        words += len(a)
    log(f"tools phase, {name}: {n} pages in new formats "
        f"({', '.join(os.path.basename(p) for p in pages)}), {words} words, quads and texts "
        f"equal to their PNG twins' in the same run")
    if not words:
        raise AssertionError(f"tools phase, {name}: no word found on the new-format pages")


def tools_entry_points(B: int, hw: int, total: dict, tmp: str):
    """``cli.pipeline --out-dir`` ('auto' and 'pallas_full') and ``cli.demo``
    with the asset detector and a seeded config-#1 recognizer, every overlay
    read back against the host's drawing; returns the detector, the
    recognizer and the pages."""
    from megreader_tpu_torch.cli import demo as cli_demo
    from megreader_tpu_torch.cli import pipeline as cli_pipeline
    from megreader_tpu_torch.compat.msgpack import load_flax_msgpack
    from megreader_tpu_torch.compat.weights import load_flax_variables
    from megreader_tpu_torch.data.imageio import read_image, write_png
    from megreader_tpu_torch.models.detector import SegDetector
    from megreader_tpu_torch.models.recognizer import CTCRecognizer
    from megreader_tpu_torch.postproc.visualizer import draw_polygons
    from megreader_tpu_torch.train.checkpoint import CheckpointManager
    from megreader_tpu_torch.train.train_step import OptimizerConfig, create_train_state

    cfg_det = os.path.join(ROOT, "experiments", "seg_detector_synth.yaml")
    cfg_rec = os.path.join(ROOT, "experiments", "ctc_resnet18_synth.yaml")
    ws_det, ws_rec = os.path.join(tmp, "det"), os.path.join(tmp, "rec")
    variables, asset_step = load_flax_msgpack(ASSET)
    det = SegDetector(device="cuda")
    load_flax_variables(det.net, variables)
    CheckpointManager(ws_det).save(create_train_state(det, OptimizerConfig()), asset_step,
                                   force=True)
    torch.manual_seed(SEED + 121)
    rec = CTCRecognizer(num_classes=37, device="cuda")
    CheckpointManager(ws_rec).save(create_train_state(rec, OptimizerConfig()), 1, force=True)
    items = [TextPages(B, 5, (hw, hw))[i] for i in range(B)]
    paths = []
    for i, it in enumerate(items):
        paths.append(os.path.join(tmp, f"page{i}.png"))
        write_png(paths[-1], it["image"])
    formats, twins = format_pages(tmp)
    base = ["--detector", cfg_det, "--det-workspace", ws_det, "--recognizer", cfg_rec,
            "--rec-workspace", ws_rec, "--page-size", str(hw)]
    for impl in ("auto", "pallas_full"):
        name = f"cli.pipeline --out-dir --extract-impl {impl}"
        vis_dir = os.path.join(tmp, f"vis_{impl}")
        images = paths + formats + twins
        out, got, _, _ = run_cli(name, cli_pipeline.main, [
            *base, "--images", *images, "--extract-impl", impl, "--out-dir", vis_dir], total,
            phase="tools")
        full = int(impl == "pallas_full")
        want = {**dict.fromkeys(got, 0), "ccl": 1, "candidates": full, "moments": full,
                "extents": full}
        if got != want:
            raise AssertionError(f"tools phase, {name}: launches {got}, expected {want}")
        twin_check(name, out[len(paths):], formats)
        t0 = time.perf_counter()
        words = tools_overlays(name, out, images, vis_dir)
        log(f"tools phase, {name}: {words} words on {len(images)} pages, every overlay read back "
            f"pixel-equal to the host's drawing of the card's detections "
            f"({time.perf_counter() - t0:.2f} s to read and draw them again)")
        if not words:
            raise AssertionError(f"tools phase, {name}: no word found")

    demo_png = os.path.join(tmp, "demo.png")
    demo, got, _, _ = run_cli("cli.demo (detector)", cli_demo.main, [
        cfg_det, "--image", paths[0], "--out", demo_png, "--experiment.workspace", ws_det],
        total, phase="tools")
    same = np.array_equal(read_image(demo_png), draw_polygons(read_image(paths[0]),
                                                              demo["polygons"]))
    if not got["ccl"] or not len(demo["polygons"]) or not same:
        raise AssertionError(f"tools phase: cli.demo found {len(demo['polygons'])} regions, "
                             f"launches {got}, overlay equal to the host's drawing {same}")
    return det, rec, np.stack([it["image"] for it in items]).astype(np.float32)


def tools_trace(det, rec, pages, total: dict, tmp: str) -> None:
    """``profiling.trace`` around one serving batch: the trace names the CCL
    kernel and the ``annotate`` region."""
    from megreader_tpu_torch.pipelines.e2e import E2EPipeline
    from megreader_tpu_torch.utils import profiling

    pipe = E2EPipeline(det, rec, device="cuda")
    pipe.predict(None, None, pages)  # warm
    counters = zeroed_counters()
    with profiling.trace(os.path.join(tmp, "trace")) as prof:
        with profiling.annotate("tools_serving_batch"):
            pipe.predict(None, None, pages)
        torch.cuda.synchronize()
    traced = add_counts(total, counters)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    ccl_names = [n for n in kernels if "ccl" in n]
    log(f"tools phase: profiling.trace of one serving batch: {len(events)} events, "
        f"{len(kernels)} distinct device kernels (CCL: {ccl_names}), the annotate region "
        f"{'present' if 'tools_serving_batch' in names else 'MISSING'}, "
        f"{os.path.getsize(prof.trace_path)} bytes, launches {traced}")
    if "tools_serving_batch" not in names or not ccl_names or not traced["ccl"]:
        raise AssertionError("tools phase: the trace lacks the CCL kernel or the region")


def tools_native(rng, quads: int) -> None:
    """``native`` built by g++ on this host: the dispatchers the program
    calls (``processes.offset_polygon``, ``measurers.polygon_iou``), on
    their C++ route, held to the numpy routes."""
    from megreader_tpu_torch import native
    from megreader_tpu_torch.data import processes
    from megreader_tpu_torch.postproc import measurers

    t0 = time.perf_counter()
    if native.library() is None:
        raise AssertionError("tools phase: no g++ on the card's host")
    build_s = time.perf_counter() - t0
    # convex quads (4 points on a rotated ellipse) and shifted copies: the
    # pairs the dispatchers clip (a non-convex pair is rasterized instead)
    ang = np.sort(rng.uniform(0, 2 * np.pi, (quads, 4)), 1)
    ell = rng.uniform(6, 40, (quads, 1, 2)) * np.stack([np.cos(ang), np.sin(ang)], 2)
    th = rng.uniform(0, np.pi, (quads, 1))
    qs = rng.uniform(20, 620, (quads, 1, 2)) + np.stack(
        [ell[..., 0] * np.cos(th) - ell[..., 1] * np.sin(th),
         ell[..., 0] * np.sin(th) + ell[..., 1] * np.cos(th)], 2)
    others = qs + rng.uniform(-15, 15, (quads, 1, 2))
    if not all(measurers.is_convex(q) for q in qs):
        raise AssertionError("tools phase: a test quad is not convex")
    routes = {"native": (processes.offset_polygon, measurers.polygon_iou),
              "numpy": (processes.offset_polygon_numpy, measurers.polygon_iou_numpy)}
    got, ms = {}, {}
    for name, (offset, iou_of) in routes.items():
        t0 = time.perf_counter()
        got[name] = ([offset(q, -2.0) for q in qs], [iou_of(q, o) for q, o in zip(qs, others)])
        ms[name] = (time.perf_counter() - t0) * 1e3
    off = max(float(np.abs(a - b).max()) for a, b in zip(got["native"][0], got["numpy"][0]))
    iou = max(abs(a - b) for a, b in zip(got["native"][1], got["numpy"][1]))
    log(f"tools phase: native built in {build_s:.2f} s ({native.target().name}); on "
        f"{quads} random convex quads offset within {off:.3g} px of numpy (bound 1e-4), IoU within "
        f"{iou:.3g} (bound 1e-6); {quads} offsets and IoUs in {ms['native']:.1f} ms by the "
        f"C++ route, {ms['numpy']:.1f} ms by numpy (host)")
    if not off <= 1e-4 or not iou <= 1e-6:
        raise AssertionError(f"tools phase: native differs from numpy by {off}, {iou}")


def tools_stems_and_ops(rng, B: int, hw: int, cpu_pages: int):
    """The stem at B x hw x hw (the ``stem_s2d`` / ``stem_s2d4`` flags run
    it too) and ``resize_bilinear`` / ``rectify_quads``, card against CPU, ms
    by CUDA events; returns the normalized pages (NCHW) on the card and
    their first ``cpu_pages`` on the CPU."""
    from megreader_tpu_torch.models.resnet import resnet_variant
    from megreader_tpu_torch.ops.image import normalize, rectify_quads, resize_bilinear

    x_np = make_pages(rng, B, hw, hw)
    x = normalize(torch.from_numpy(x_np).cuda()).permute(0, 3, 1, 2).contiguous()
    x_cpu = x[:cpu_pages].cpu()
    trunk = resnet_variant("resnet18", "det")
    seeded_weights(trunk, SEED + 122)
    trunk.eval()
    with torch.no_grad():
        cpu = trunk.stem(x_cpu)
        card = trunk.cuda().stem(x)
        ms = cuda_ms(lambda: trunk.stem(x), reps=10)
        flagged = resnet_variant("resnet18", "det", stem_s2d=True, stem_s2d4=True).cuda()
        flagged.load_state_dict(trunk.state_dict())
        gap_flags = float((flagged.eval().stem(x) - card).abs().max())
    gap = float((card[:cpu_pages].cpu() - cpu).abs().max())
    scale = float(cpu.abs().max())
    log(f"tools phase: stem on {tuple(x.shape)}: card against CPU max |diff| {gap:.3g} on "
        f"{cpu_pages} pages (activations up to {scale:.3g}; bound 1e-5 x that), {ms:.3f} ms "
        f"by CUDA events [{CARD}]; the stem_s2d / stem_s2d4 flags' stem within {gap_flags:.3g} "
        f"of it on the card")
    if not gap <= 1e-5 * scale or not gap_flags <= 1e-5 * scale:
        raise AssertionError(f"tools phase: the stem differs by {gap}, the flags' by "
                             f"{gap_flags}")

    imgs = torch.from_numpy(x_np).cuda()
    K = 32  # rotated word boxes a page, some across the page's edge
    centre = rng.uniform(0, hw, (B, K, 1, 2))
    corner = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]]) * rng.uniform([10, 4], [100, 20],
                                                                           (B, K, 1, 2))
    th = rng.uniform(-0.6, 0.6, (B, K, 1))
    rot = np.stack([corner[..., 0] * np.cos(th) - corner[..., 1] * np.sin(th),
                    corner[..., 0] * np.sin(th) + corner[..., 1] * np.cos(th)], -1)
    quads = torch.from_numpy((centre + rot).astype(np.float32)).cuda()
    with torch.no_grad():
        for label, fn in (("resize_bilinear", lambda t, q: resize_bilinear(t, (320, 480))),
                          ("rectify_quads", lambda t, q: rectify_quads(t, q, (32, 100)))):
            card = fn(imgs, quads)
            gap = float((card.cpu() - fn(imgs.cpu(), quads.cpu())).abs().max())
            ms = cuda_ms(lambda: fn(imgs, quads), reps=10)
            log(f"tools phase: {label} {tuple(card.shape)} card against CPU max |diff| "
                f"{gap:.3g} (bound 1e-3 on 0-255 pixels), {ms:.3f} ms by CUDA events [{CARD}]")
            if not gap <= 1e-3:
                raise AssertionError(f"tools phase: {label} differs by {gap}")
    return x, x_cpu


def torchvision_keys(trunk) -> dict:
    """A port 'det' trunk's state dict under torchvision's ResNet names (conv1,
    bn1, layerI.J, downsample.0/1), as a torchvision checkpoint holds it."""
    import re

    out = {}
    for k, v in trunk.state_dict().items():
        k = k.replace("stem_conv.", "conv1.").replace("stem_bn.", "bn1.")
        k = re.sub(r"^layer(\d+)_block(\d+)\.", r"layer\1.\2.", k)
        out[k.replace(".downsample_conv.", ".downsample.0.")
             .replace(".downsample_bn.", ".downsample.1.")] = v
    return out


def tools_convert(x, x_cpu) -> None:
    """A torchvision-layout ResNet-50 state dict loaded into a trunk through
    ``compat/torch_convert.py``: C2-C5 on one page, card against CPU."""
    from megreader_tpu_torch.compat.torch_convert import (load_torch_state_dict,
                                                          torchvision_resnet_keys)
    from megreader_tpu_torch.models.resnet import resnet_variant

    source = resnet_variant("resnet50", "det")
    seeded_weights(source, SEED + 123)
    damp_residuals(source)
    sd = torchvision_keys(source)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    t0 = time.perf_counter()
    trunk = load_torch_state_dict(resnet_variant("resnet50", "det"),
                                  torchvision_resnet_keys(sd)).eval()
    load_s = time.perf_counter() - t0
    with torch.no_grad():
        cpu = trunk(x_cpu[:1])
        card = trunk.cuda()(x[:1])
    gaps = [float((c.cpu() - r).abs().max() / r.abs().max()) for c, r in zip(card, cpu)]
    log(f"tools phase: a torchvision-layout ResNet-50 state dict ({len(sd)} tensors) loaded "
        f"in {load_s:.2f} s; C2-C5 card against CPU, max |diff| over max |CPU| "
        f"{[float(f'{g:.3g}') for g in gaps]} (bound 1e-4)")
    if not max(gaps) <= 1e-4:
        raise AssertionError(f"tools phase: the converted ResNet-50 differs by {gaps}")


PROGRESSIVE_ASSETS = os.path.join(ROOT, "assets", "jpeg", "progressive")


def tools_progressive() -> None:
    """Every progressive JPEG of ``assets/jpeg/progressive/`` and its baseline
    twin decoded on the host with cv2's digest; ms for the 1280x720 page."""
    from megreader_tpu_torch.data.imageio import decode_image

    with open(os.path.join(PROGRESSIVE_ASSETS, "manifest.json")) as f:
        files = json.load(f)["files"]
    bad, ms = [], {}
    for rnd in range(3):
        for rel, want in sorted(files.items()):
            if rnd and not rel.startswith("page"):
                continue
            with open(os.path.join(PROGRESSIVE_ASSETS, rel), "rb") as f:
                data = f.read()
            t0 = time.perf_counter()
            img = decode_image(data, rel)
            ms.setdefault(rel, []).append((time.perf_counter() - t0) * 1e3)
            if rgb_sha(img) != want["sha256"]:
                bad.append(rel)
    prog, base = ms["page_1280x720.jpg"], ms["page_1280x720.base.jpg"]
    log(f"tools phase: {len(files) - len(set(bad))} of {len(files)} progressive JPEG files "
        f"and baseline twins decoded on the host with cv2's digest; the 1280x720 page "
        f"progressive {[round(v, 1) for v in prog]} ms (median {statistics.median(prog):.1f}), "
        f"its baseline twin {[round(v, 1) for v in base]} ms (median "
        f"{statistics.median(base):.1f}), one host thread")
    if bad:
        raise AssertionError(f"tools phase: the port's decode differs from cv2's on {bad}")


def phase_tools(B: int = 8, hw: int = 640, quads: int = 1000, cpu_pages: int = 8):
    """The tools of ROADMAP item 15b on the card (see the module docstring).
    Returns every kernel's launches in the entry points' runs and the traced
    batch."""
    t_phase = time.perf_counter()
    total = dict.fromkeys(kernel_counters(), 0)
    rng = np.random.default_rng(SEED + 120)
    with tempfile.TemporaryDirectory() as tmp:
        det, rec, pages = tools_entry_points(B, hw, total, tmp)
        tools_trace(det, rec, pages, total, tmp)
    del det, rec
    tools_native(rng, quads)
    x, x_cpu = tools_stems_and_ops(rng, B, hw, cpu_pages)
    tools_convert(x, x_cpu)
    tools_progressive()
    log(f"tools phase: {time.perf_counter() - t_phase:.1f} s (host clock)")
    return total


#: the detector head's formulations (``models/detector.py::MapHead`` flags)
HEAD_FORMS = {"plain": dict(fused_upsample=False), "default": {}}
#: the asset's cli.eval H-mean on 8 TextPages (seed 5)
ASSET_HMEAN = 0.9677


def head_check(what: str, card, card_plain, crop, cpu, ref64, cpu_gap: float) -> dict:
    """One formulation's map on the card against the CPU's on a crop
    (``crop``: the card's map of it) and against the card's plain
    formulation on every page, each bounded by 4 times the CPU's own
    distance from float64 on the crop (at least 1e-6)."""
    bound = 4 * max(cpu_gap, 1e-6)
    gaps = {"card_vs_cpu": float((crop.cpu().double() - cpu.double()).abs().max()),
            "card_vs_f64": float((crop.cpu().double() - ref64).abs().max()),
            "card_vs_card_plain": float((card.double() - card_plain.double()).abs().max())}
    if not all(g <= bound for g in gaps.values()):
        raise AssertionError(f"head phase, {what}: {gaps} beyond {bound}")
    return gaps


def head_formulations(x, state, dtype=None, cast: bool = False):
    """{name: MapHead on the card with the prob head's ``state``} for each
    formulation; ``dtype`` its compute dtype (mixed precision), ``cast``
    the bf16 serving cast."""
    from megreader_tpu_torch.models.detector import MapHead
    from megreader_tpu_torch.ops.precision import cast_floats

    heads = {}
    for name, flags in HEAD_FORMS.items():
        head = MapHead(x.shape[1], 64, dtype, **flags)
        head.load_state_dict(state)
        head = head.cuda().eval()
        heads[name] = cast_floats(head) if cast else head
    return heads


def head_timings(heads, x, train: bool, reps: int) -> dict:
    """{name: (ms by CUDA events, kernel-busy ms)} of each head's forward
    (eval), or forward and backward (train, on copies whose BatchNorm
    statistics move); busy None where the trace is not to be trusted
    (``device_busy_ms`` with ``events_ms``)."""
    out = {}
    for name, head in heads.items():
        if train:
            head = copy.deepcopy(head).train()
            fn = lambda h=head: h(x).sum().backward()  # noqa: E731
        else:
            fn = lambda h=head: h(x)  # noqa: E731
        with contextlib.nullcontext() if train else torch.no_grad():
            ms = cuda_ms(fn, reps=reps)
            out[name] = (ms, device_busy_ms(fn, events_ms=ms))
    return out


def phase_head(B: int = 8, hw: int = 640, reps: int = 10, crop=(64, 80)):
    """The detector head's formulations at the serving shape (see the module
    docstring). Returns every kernel's launches on the serving path."""
    from megreader_tpu_torch.cli import eval as cli_eval
    from megreader_tpu_torch.compat.msgpack import load_flax_msgpack
    from megreader_tpu_torch.compat.weights import load_flax_variables
    from megreader_tpu_torch.core.registry import COMPONENTS
    from megreader_tpu_torch.models.detector import SegDetector
    from megreader_tpu_torch.models.recognizer import CTCRecognizer
    from megreader_tpu_torch.ops.image import normalize
    from megreader_tpu_torch.pipelines.e2e import E2EPipeline
    from megreader_tpu_torch.train.checkpoint import CheckpointManager
    from megreader_tpu_torch.train.train_step import OptimizerConfig, create_train_state

    t_phase = time.perf_counter()
    variables, asset_step = load_flax_msgpack(ASSET)
    dets = {}
    for fused in (True, False):
        dets[fused] = SegDetector(fused_upsample=fused, device="cuda")
        load_flax_variables(dets[fused].net, variables)
    items = [TextPages(B, 5, (hw, hw))[i] for i in range(B)]
    pages_np = np.stack([it["image"] for it in items]).astype(np.float32)
    pages = torch.from_numpy(pages_np).cuda()
    net = dets[True].net
    with torch.no_grad():
        # the prob head's real input: the asset's FPN feature of the pages
        x = net.fpn(net.backbone(normalize(pages).permute(0, 3, 1, 2)))
    state = net.prob_head.state_dict()

    # every formulation on the card against the CPU (on a corner crop of page
    # 0, borders and all) and against the card's plain one (every page)
    xc = x[:1, :, :crop[0], :crop[1]]
    gaps, timing = {}, {}
    for mode in ("float32", "bf16"):
        heads = head_formulations(x, state, cast=mode == "bf16")
        xin, xcin = (x.to(torch.bfloat16), xc.to(torch.bfloat16)) if mode == "bf16" else (x, xc)
        with torch.no_grad():
            card = {n: h(xin) for n, h in heads.items()}
            card_crop = {n: h(xcin) for n, h in heads.items()}
            cpu_heads = {n: copy.deepcopy(h).cpu() for n, h in heads.items()}
            cpu = {n: h(xcin.cpu()) for n, h in cpu_heads.items()}
            ref64 = copy.deepcopy(cpu_heads["plain"]).double()(xc.cpu().double())
        cpu_gap = max(float((c.double() - ref64).abs().max()) for c in cpu.values())
        gaps[mode] = {"cpu_vs_f64": cpu_gap, **{
            n: head_check(f"{mode} {n}", card[n], card["plain"], card_crop[n], cpu[n], ref64,
                          cpu_gap)
            for n in heads}}
        timing[f"eval {mode}"] = head_timings(heads, xin, False, reps)
        del card, card_crop, cpu, cpu_heads
    for mode, dtype in (("float32", None), ("bf16 mixed", torch.bfloat16)):
        heads = head_formulations(x, state, dtype)
        if dtype is None:  # the fused tail's train-mode map against the plain chain's
            with torch.no_grad():
                train_maps = {n: copy.deepcopy(h).train()(x) for n, h in heads.items()}
            gaps["train float32"] = float((train_maps["default"].double()
                                           - train_maps["plain"].double()).abs().max())
            if not gaps["train float32"] <= 4 * max(gaps["float32"]["cpu_vs_f64"], 1e-6):
                raise AssertionError(f"head phase: the default train-mode map lies "
                                     f"{gaps['train float32']} from the plain one")
            del train_maps
        timing[f"train {mode}"] = head_timings(heads, x, True, reps)
    del heads
    torch.cuda.empty_cache()
    log(f"head phase [{CARD}]: prob head of the asset on its FPN feature {tuple(x.shape)}; "
        f"map gaps (card vs CPU and vs float64 on page 0's {crop[0]}x{crop[1]} corner, card "
        "vs the card's plain head on every page; the CPU's own float32/bf16 distance from "
        "float64) " + json.dumps(gaps))
    log(f"head phase [{CARD}]: head ms (CUDA events, median of {reps}; eval forward, train "
        "forward + backward) and kernel-busy ms (torch.profiler, mean of 3; null where "
        "the trace lost kernels) "
        + json.dumps({k: {n: {"ms": t[0], "busy_ms": t[1]} for n, t in v.items()}
                      for k, v in timing.items()}))

    # serving: the default head against fused_upsample=False, in turns
    rec = CTCRecognizer(num_classes=37, device="cuda")
    seeded_weights(rec.net, SEED + 3)
    total = dict.fromkeys(kernel_counters(), 0)
    pipes, outs = {}, {}
    for impl in ("xla", "pallas_full"):
        for fused in (True, False):
            name = f"{'default' if fused else 'plain'} {impl}"
            pipes[name] = E2EPipeline(dets[fused], rec, max_regions=32, rectify="perspective",
                                      ccl_iters=24, extract_impl=impl, device="cuda")
            pipes[name].run(None, None, pages)  # warm-up
            torch.cuda.synchronize()
            counters = zeroed_counters()
            outs[name] = pipes[name].run(None, None, pages)
            torch.cuda.synchronize()
            got = add_counts(total, counters)
            want = {"ccl": 1, **dict.fromkeys(("candidates", "moments", "extents"),
                                              int(impl == "pallas_full"))}
            if {k: got[k] for k in want} != want:
                raise AssertionError(f"head phase, {name}: kernel launches {got}")
        a, b = outs[f"default {impl}"], outs[f"plain {impl}"]
        if not torch.equal(a["valid"], b["valid"]) or not bool(a["valid"].any()):
            raise AssertionError(f"head phase, {impl}: valid regions differ between the "
                                 "default and the plain head")
    with torch.no_grad():
        prob = {f: dets[f].predict_maps(normalize(pages), heads=("prob",))["prob"]
                for f in (True, False)}
    flipped = int(((prob[True] > 0.3) != (prob[False] > 0.3)).sum())
    prob_gap = float((prob[True] - prob[False]).abs().max())
    if not prob_gap <= 4 * max(gaps["float32"]["cpu_vs_f64"], 1e-6) or flipped > 1e-4 * prob[
            True].numel():
        raise AssertionError(f"head phase: the default prob map lies {prob_gap} from the "
                             f"plain one, {flipped} mask pixels flipped")
    turns = {name: [] for name in pipes if name.endswith("xla")}
    for name in [*turns, *reversed(turns)]:
        turns[name].append(cuda_ms(lambda: pipes[name].run(None, None, pages), reps=reps))
    log(f"head phase [{CARD}]: the asset's prob maps, default against plain head, max |diff| "
        f"{prob_gap:.3g}, {flipped} of {prob[True].numel()} mask pixels flipped; serving in "
        f"turns (default, plain, plain, default; ms a batch of {B}, median of {reps}, CUDA "
        "events): " + json.dumps(turns) + "; pages/s "
        + json.dumps({k: [B / t * 1e3 for t in v] for k, v in turns.items()}))
    del pipes, outs, prob, rec

    # the asset's H-mean through cli.eval under both heads (the YAML key)
    with tempfile.TemporaryDirectory() as tmp:
        COMPONENTS.register(TextPages)
        CheckpointManager(tmp).save(create_train_state(dets[True], OptimizerConfig()),
                                    asset_step, force=True)
        argv = [os.path.join(ROOT, "experiments", "seg_detector_synth.yaml"),
                "--experiment.workspace", tmp,
                "--experiment.eval_dataset", node("TextPages", n=B, seed=5),
                "--experiment.batch_size", str(B)]
        hmean = {}
        for label, extra in (("default", []),
                             ("plain", ["--experiment.model.fused_upsample", "false"])):
            _, got, _, printed = run_cli(f"cli.eval {label} head (trained detector)",
                                         cli_eval.main, [*argv, *extra], total, phase="head")
            if not got["ccl"] or len(printed) != 1:
                raise AssertionError(f"head phase: cli.eval {label} printed {printed}")
            hmean[label] = printed[0]["hmean"]
    log(f"head phase [{CARD}]: the asset's H-mean on {B} TextPages " + json.dumps(hmean))
    if not all(abs(h - ASSET_HMEAN) < 5e-5 for h in hmean.values()):
        raise AssertionError(f"head phase: H-mean {hmean}, expected {ASSET_HMEAN}")
    log(f"head phase: {time.perf_counter() - t_phase:.1f} s (host clock)")
    return total


# --- the plain synthetic tier as its experiment files name it ---

SYNTH_MANIFEST = os.path.join(ROOT, "assets", "synth", "manifest.json")
HARD_MANIFEST = os.path.join(ROOT, "assets", "synth", "hard_manifest.json")


def item_digests(item: dict) -> dict:
    """sha256 of each of a synthetic item's arrays, as C-order bytes: a list
    of polygons stacked when all have one shape, else each polygon's int32
    vertex count and then its float32 vertices, one after another; texts
    joined by newlines in utf-8; a ``meta`` dict as JSON with sorted keys
    (the manifests' digests, which ``scripts/make_port_text_assets.py`` and
    ``scripts/make_port_hard_assets.py`` write with this function from the
    JAX package's items)."""
    import hashlib

    out = {}
    for k in sorted(item):
        v = item[k]
        if k == "polygons":
            shapes = {np.shape(p) for p in v}
            if len(shapes) <= 1:
                v = np.stack(v).astype(np.float32) if len(v) else np.zeros((0, 4, 2), np.float32)
            else:
                v = np.frombuffer(b"".join(
                    np.int32(len(p)).tobytes() + np.ascontiguousarray(p, np.float32).tobytes()
                    for p in v), np.uint8)
        elif k == "ignore":
            v = np.asarray(v, bool)
        elif k in ("texts", "text", "filename"):
            v = np.frombuffer("\n".join(v if k == "texts" else [v]).encode(), np.uint8)
        elif k == "meta":
            v = np.frombuffer(json.dumps(v, sort_keys=True).encode(), np.uint8)
        out[k] = hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
    return out


def synth_items(path: str, module, items: int, tier: str) -> dict:
    """Draw the first ``items`` items of each entry of a manifest on the host
    and hold them to its digests; log ms an item on one host thread
    (median, max) by entry and return them."""
    with open(path) as f:
        manifest = json.load(f)
    bad, item_ms = [], {}
    for name, entry in manifest["items"].items():
        ds = getattr(module, entry["class"])(**entry["kwargs"])
        times = []
        for i, want in enumerate(entry["digests"][:items]):
            t0 = time.perf_counter()
            item = ds[i]
            times.append((time.perf_counter() - t0) * 1e3)
            if item_digests(item) != want:
                bad.append((name, i))
        item_ms[name] = [statistics.median(times), max(times)]
    log(f"synth phase: {items} items of each {tier} entry {sorted(manifest['items'])} drawn on "
        f"the host without cv2 or PIL, {'all' if not bad else 'NOT all'} equal to the JAX "
        f"package's digests (cv2 {manifest['cv2']}); ms an item on one host thread (median, "
        "max) " + json.dumps(item_ms) + f" [{CARD}]")
    if bad:
        raise AssertionError(f"synth phase: {tier} items differ from the manifest: {bad}")
    return item_ms


def phase_synth(items: int = 16, rec_steps: int = 4, det_steps: int = 2, pages: int = 8,
                hard_items: int = 8):
    """Both synthetic tiers on the card's machine, which has no cv2, PIL or
    fonts: the first items drawn on the host equal to the JAX package's
    digests (the seven plain files' three entries, the eleven hard files'
    five), then the entry points as written on three plain files and on
    ctc_hard and seg_detector_hard. Returns every kernel's launches in the
    entry points' runs."""
    from megreader_tpu_torch.cli import eval as cli_eval
    from megreader_tpu_torch.cli import pipeline as cli_pipeline
    from megreader_tpu_torch.cli import train as cli_train
    from megreader_tpu_torch.data import datasets, hard_synth
    from megreader_tpu_torch.data.imageio import write_png

    t_phase = time.perf_counter()
    synth_items(SYNTH_MANIFEST, datasets, items, "plain")
    synth_items(HARD_MANIFEST, hard_synth, hard_items, "hard")
    total = dict.fromkeys(kernel_counters(), 0)
    cfg = {k: os.path.join(ROOT, "experiments", f"{k}.yaml")
           for k in ("ctc_resnet18_synth", "seg_detector_synth", "shared_spotter_synth",
                     "ctc_hard", "seg_detector_hard")}
    step_s = {}

    def train(label, name, ws, n_train, n_eval, steps, want):
        state, got, wall, _ = run_cli(f"cli.train {name}", cli_train.main, [
            cfg[name], "--no-resume", "--experiment.workspace", ws,
            "--experiment.train_dataset.n", str(n_train), "--experiment.eval_dataset.n",
            str(n_eval), "--experiment.epochs", "1", "--experiment.log_every", "1"],
            total, phase="synth")
        dt, losses, logged = step_seconds(ws)
        if (state.step != steps or logged != list(range(1, steps + 1))
                or not np.all(np.isfinite(losses))):
            raise AssertionError(f"synth phase: {label} stopped at step {state.step}, logged "
                                 f"{logged}, losses {losses}")
        missing = [k for k in want if got[k] != steps]
        if missing:
            raise AssertionError(f"synth phase: {label}: launches {got}, each of {want} "
                                 f"once a step expected")
        step_s[label] = {"steps": steps, "s": round(wall, 2),
                         "s_a_step_after_the_first": dt, "losses": losses}
        return state

    ctc = ("ctc_alpha", "ctc_beta")
    #: (label, file, workspace name, steps, batch, eval items, kernels launched once a step)
    runs = [("config #1", "ctc_resnet18_synth", "rec", rec_steps, 64, 64, ctc),
            ("config #4", "seg_detector_synth", "det", det_steps, 8, pages, ()),
            ("shared spotter", "shared_spotter_synth", "spot", det_steps, 8, pages, ctc),
            ("ctc_hard", "ctc_hard", "hard_rec", rec_steps, 64, 64, ctc),
            ("seg_detector_hard", "seg_detector_hard", "hard_det", det_steps, 8, pages, ())]
    evals, hard_total = {}, dict.fromkeys(total, 0)

    def serve(name, det, rec, ds, extra=(), want=("ccl",)):
        """``cli.pipeline`` over ``pages`` PNG pages of ``ds`` with two
        trained workspaces."""
        paths = []
        for i in range(pages):
            paths.append(os.path.join(tmp, f"{name}_page{i}.png"))
            write_png(paths[-1], ds[i]["image"])
        _, got, _, printed = run_cli(f"cli.pipeline {name}", cli_pipeline.main, [
            "--detector", cfg[det], "--det-workspace", os.path.join(tmp, ws_of[det]),
            "--recognizer", cfg[rec], "--rec-workspace", os.path.join(tmp, ws_of[rec]),
            "--images", *paths, *extra], total, phase="synth")
        if [p["image"] for p in printed] != paths or not all(got[k] for k in want):
            raise AssertionError(f"synth phase: cli.pipeline {name} launched {got}, printed "
                                 f"{[p.get('image') for p in printed]}")
        return got

    ws_of = {name: ws for _, name, ws, *_ in runs}
    with tempfile.TemporaryDirectory() as tmp:
        for label, name, ws, steps, batch, n_eval, want in runs:
            before = dict(total)
            train(label, name, os.path.join(tmp, ws), batch * steps, n_eval, steps, want)
            _, got, _, printed = run_cli(f"cli.eval {name}", cli_eval.main, [
                cfg[name], "--experiment.workspace", os.path.join(tmp, ws),
                "--experiment.eval_dataset.n", str(n_eval)], total, phase="synth")
            if len(printed) != 1 or not all(np.isfinite(v) for v in printed[0].values()
                                            if isinstance(v, float)):
                raise AssertionError(f"synth phase: cli.eval {name} printed {printed}")
            if name.startswith("seg_detector") and not got["ccl"]:
                raise AssertionError(f"synth phase: cli.eval {name} launched {got}")
            evals[label] = printed[0]
            if "hard" in name:
                for k in total:
                    hard_total[k] += total[k] - before[k]
        serve("plain", "seg_detector_synth", "ctc_resnet18_synth",
              datasets.SyntheticDetectionDataset(n=pages, hw=(640, 640), seed=1, gt_maps=False),
              ("--extract-impl", "pallas_full"), ("ccl", "candidates", "moments", "extents"))
        got = serve("hard", "seg_detector_hard", "ctc_hard",
                    hard_synth.HardSyntheticDetectionDataset(n=pages, seed=777, gt_maps=False))
        for k in total:
            hard_total[k] += got[k]
    log("synth phase: the hard files' runs launched " + json.dumps(hard_total) + f" [{CARD}]")
    leaked = [m for m in ("cv2", "PIL") if sys.modules.get(m) is not None]
    if leaked:
        raise AssertionError(f"synth phase: {leaked} imported")
    log("synth phase: cli.train steps (host clock; s a step from the metrics' timestamps) "
        + json.dumps(step_s) + "; cli.eval " + json.dumps(evals) + "; launches "
        + json.dumps(total) + f"; cv2 and PIL never imported [{CARD}]; "
        f"{time.perf_counter() - t_phase:.1f} s (host clock)")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    clocks = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        clocks[name] = round(time.perf_counter() - t0, 1)
        return out

    timed("setup", phase_setup)
    ccl_row = timed("ccl", phase_ccl)
    extract_rows = timed("extract", phase_extract)
    alpha_row, beta_row = timed("ctc", phase_ctc)
    alpha2d_row, beta2d_row = timed("ctc2d", phase_ctc2d)
    ccl_row["launches"], extract_launches = timed("e2e", phase_e2e)
    for row in extract_rows:
        row["launches"] = extract_launches[row["name"][len("extract_"):]]
    alpha_row["launches"], beta_row["launches"] = timed("train", phase_train)
    alpha2d_row["launches"], beta2d_row["launches"] = timed("train2d", phase_train2d)
    timed("decode2d", phase_decode2d)
    timed("traindet", phase_traindet)
    att = timed("attention", phase_attention)
    timed("serving", phase_serving, att)
    timed("beam", phase_beam)
    bf16 = timed("bf16", phase_bf16)
    cli = timed("cli", phase_cli)
    data = timed("data", phase_data)
    encoders = timed("encoders", phase_encoders)
    chains, buckets = timed("curved", phase_curved)
    int8 = timed("int8", phase_int8)
    parallel = timed("parallel", phase_parallel)
    dcn = timed("dcn", phase_dcn)
    spotter = timed("spotter", phase_spotter)
    timed("jpeg", phase_jpeg)
    lmdb = timed("lmdb", phase_lmdb)
    resume = timed("resume", phase_resume)
    r50 = timed("r50", phase_r50)
    tools = timed("tools", phase_tools)
    head = timed("head", phase_head)
    synth = timed("synth", phase_synth)
    for name, total, needed in (("encoders", encoders, ("ctc_alpha", "ctc_beta")),
                                ("chains", chains, ("ccl", "candidates", "moments", "extents")),
                                ("buckets", buckets, ("ccl",)), ("int8", int8, ("ccl",)),
                                ("parallel", parallel, ("ctc_alpha", "ctc_beta")),
                                ("dcn", dcn, ("ccl",)),
                                ("spotter", spotter, ("ccl", "ctc_alpha", "ctc_beta",
                                                      "candidates", "moments", "extents")),
                                ("lmdb", lmdb, ("ctc_alpha", "ctc_beta")),
                                ("resume", resume, ("ctc_alpha", "ctc_beta")),
                                ("r50", r50, ("ccl", "candidates", "moments", "extents")),
                                ("tools", tools, ("ccl", "candidates", "moments", "extents")),
                                ("head", head, ("ccl", "candidates", "moments", "extents")),
                                ("synth", synth, ("ccl", "candidates", "moments", "extents",
                                                  "ctc_alpha", "ctc_beta"))):
        if not all(total[n] for n in needed):
            raise AssertionError(f"{name} phase: a kernel of its path did not launch: {total}")
    rows = [ccl_row, *extract_rows, alpha_row, beta_row, alpha2d_row, beta2d_row]
    for row in rows:
        key = row["name"].removeprefix("extract_")
        row["launches_bf16"] = bf16[key]
        row["launches_cli"] = cli[key]
        row["launches_data"] = data[key]
        row["launches_encoders"] = encoders[key]
        row["launches_chains"] = chains[key]
        row["launches_buckets"] = buckets[key]
        row["launches_int8"] = int8[key]
        row["launches_parallel"] = parallel[key]
        row["launches_dcn"] = dcn[key]
        row["launches_spotter"] = spotter[key]
        row["launches_lmdb"] = lmdb[key]
        row["launches_resume"] = resume[key]
        row["launches_r50"] = r50[key]
        row["launches_tools"] = tools[key]
        row["launches_head"] = head[key]
        row["launches_synth"] = synth[key]
    log("phase seconds (host clock) " + json.dumps(clocks))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
