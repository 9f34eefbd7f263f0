#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and hold its kernels
against their plain versions.

    python3 chip_smoke.py             # the check: one card, exit 0 only if every phase passed
    python3 chip_smoke.py --profile DIR   # also write a kernel-time profile and per-case
                                          # details into DIR

Phases:
  1. device and build: the card's name and power limit, the kernels built
     from csrc/ with nvcc;
  2. kernels vs plain at the main path's shapes: K1 (fused attention, bf16 on
     the tensor cores and f32 on the CUDA cores, held to its plain version at
     the TPU kernel's rounding points and to the einsum path; and that it
     writes the row statistics for K2 only under grad), K2 (its
     backward, bf16 on the tensor cores, given K1's statistics) and K3 (fused
     1x1 Conv+IQBN+SiLU: bf16 on the tensor cores at all 21 site shapes, f32
     on the CUDA cores), errors against the stated tolerances, times of
     kernel, plain version, library yardstick, the unfused path and bound;
  3. predict: QUAN-YOLO11n-OBB (nc=15, random weights from a seed, bf16) at
     1024 on 8 uint8 frames through the port's Predictor, with K1 only and
     with K1+K3; the launch counters show the kernels ran (and that K1 wrote
     no statistics), the predictions agree with an all-plain run (bf16, and
     f32 with TF32 off, down to the detections);
  4. speed: img/s of each path in interleaved rounds, and the device's busy
     share of one forward + decode + NMS from torch.profiler;
  5. train: the port's Trainer (default TrainConfig at batch 8, so 8
     micro-steps an update) takes 16 micro-steps at 1024 in bf16 on a seeded
     synthetic batch of 128 padded rotated boxes an image (34 to 100 valid);
     every loss is finite, the parameters and the EMA change at micro-steps
     8 and 16 only, K1 (writing its statistics) and K2 ran once a micro-step;
     one f32 micro-step (TF32 off) gives the same loss and, under one
     cotangent on the head's outputs, the same gradients with fused and with
     plain attention;
  6. train speed: ms per micro-step with fused and with plain attention in
     interleaved rounds, and the device's busy share and the attention
     kernels' device time per micro-step from torch.profiler; the loss
     layer's device time at the batch's 128 padded boxes an image and at 16;
  7. data: a DOTA-layout set written with the port's PNG writer (16 images of
     four sizes, 2-40 filled rotated rectangles each, 8-corner labels over
     the 15 classes), every PNG and the committed baseline-JPEG fixtures
     decoded exactly by the port's readers, the decode of a 1024 x 1024 PNG
     and JPEG timed;
  8. augment: the native augmentation library (``data/native/augment.cpp``,
     built here) against the committed OpenCV outputs of
     ``tests/fixtures/augment`` (warps within one gray level on at most 0.1%
     of the values, the rest exact); the load time of an augmenting batch of
     8 at 1024 (mosaic, warp, photometric list, HSV, flips) and of a plain
     one, and the share of mosaic and warp on one loader thread;
  9. fit: ``Trainer.fit`` for 2 epochs on that set at 1024, bf16, batch 8
     (nbs 8, an update a micro-step), validating the EMA weights each epoch,
     with the DOTA recipe's augmentations in epoch 0 and close_mosaic = 1
     (epoch 1 plain, as the JAX facade's loader); finite losses, the EMA
     moved, epoch 0's batches hold labels and differ from the plain loader's,
     epoch 1's equal them, last/best checkpoints, results.json and
     results.csv written, ``latest()`` finds last.ckpt, a restored trainer
     runs a third epoch; K1 and K2 launched every micro-step; the fit feeds
     its steps through ``prefetch_to_device`` (the loader two batches ahead);
     then the steady state of a long epoch, augmented and plain: ms a batch
     loaded then stepped, and prefetched, with the loader's wait and the
     micro-step in each; the micro-step alone, beside the loader's threads
     (at the default switch interval and a short one) and beside native
     warps alone; the share of the time the loader holds the GIL, and the
     blocking upload of a batch;
 10. val: the Validator at 1024, conf 0.001, on the fitted EMA weights in
     bf16 with K1, with K1+K3 and plain, and f32 with K1 and plain, each
     run's launches counted from 0 (the kernels line's ``val`` is the bf16
     K1+K3 run's); metrics finite and in [0, 1], 15 Task1 files each; each
     kernel run against the plain run of its dtype: decoded predictions of
     every batch within the predict tolerance, every metric within 5e-3, and
     in f32 the same detection count on 15 of 16 images, or a count that NMS
     on the kernel's boxes keeps with the plain run's scores (in bf16 NMS's
     candidate pool is cut inside a block of tied scores: the ties, and what
     NMS keeps of f32 scores rounded to bf16, are printed); img/s and load,
     infer and match ms a batch;
 11. cli: the user's entry point, ``quan_ultralytics_tpu_torch.cli`` run in
     this process on that set: ``obb train`` from a facade checkpoint (``.pkl``)
     of the predict phases' seeded weights, 2 epochs at 1024, batch 8 (nbs 8,
     close_mosaic 1; bf16 train steps, f32 validation, as the JAX CLI's
     defaults give), ``obb val`` and ``obb predict`` (f32, save_txt) of its
     best.pkl; exit codes, files, epoch lines and the launches of K1 (tensor
     cores with statistics a micro-step, CUDA cores a val batch) and K2 checked;
     the label files that predict saved (save_conf) read back and held to the
     facade's boxes, and ``YOLO(..., dtype=bf16, fused_1x1=True).predict``
     launching K3 at its 37 sites;
 12. detect data: a COCO-layout set written with the port's PNG writer (16
     images, 4 each of 640 x 480, 480 x 640, 640 x 427 and 500 x 375, 2-40
     filled axis-aligned rectangles each over the 80 classes), decoded exactly;
 13. detect predict: QUAN-YOLO11n (nc=80, seeded bf16 weights) at 640 on 8 of
     those frames through the Predictor with K1, K1+K3 (K3 at every site
     `fused_1x1_sites` finds: 37) and
     plain; launches; decoded predictions against plain (PRED_TOL) and kept
     counts (or NMS's on the kernel's boxes with the plain scores); infer ms in
     interleaved rounds and device busy ms from torch.profiler;
 14. detect train: 16 micro-steps at 640 (bf16, K1 + K2 each) on the set's
     first batch, ms a micro-step, then one f32 micro-step against the plain
     attention as phase 5 holds the OBB one (gradients into qkv included);
     then Trainer.fit for 2 epochs of 2 micro-steps with the COCO recipe's
     augmentations (close_mosaic 1), validating the EMA weights;
 15. detect val: the Validator at 640, conf 0.001, rect off and on (N = 400,
     and the N of the rect batches, recorded), bf16 K1, K1+K3 and plain, f32
     K1 and plain, each kernel run held to the plain run of its dtype as in
     phase 10;
 16. detect cli: ``detect train`` (2 epochs), ``detect val rect=True`` and
     ``detect predict save_txt=True`` in this process, the saved label lines
     held to the facade's boxes, and the facade's bf16 fused_1x1 predict (K3);
 17-22. segment and pose at 640, first QUAN-YOLO11n-seg (nc=80), then
     QUAN-YOLO11n-pose (nc=1, 17 x 3 keypoints), each on a COCO-layout set of
     16 PNG images of phase 12's sizes (segment: 2-40 filled polygons over the
     80 classes, labelled as polygons; pose: 1-10 figures of 17 keypoints,
     mixed visibility): predict on the K1, K1+K3 and plain paths (masks and
     keypoints held to the plain run: bf16 outputs and prototypes within
     PRED_TOL, f32 Predictors' masks and keypoints of matched detections),
     16 train micro-steps (the batch's upload, uint8 masks; a device profile;
     one f32 micro-step's gradients held to the plain attention), a 2-epoch
     fit with the default augmentations through the prefetcher (segment:
     mosaic; pose: photometric list, HSV, flips), val in bf16 K1+K3 and
     plain and f32 K1 and plain (segment also f32 with ``mask_native``), and
     ``segment|pose train|val|predict`` in-process, saved labels held to the
     facade's predictions;
 23. cls data: a CIFAR-10 folder in the python-pickle format (data_batch_1..5 and
     test_batch, 256 images each, class-dependent colours and stripes) and an
     ImageNet-layout folder of PNG images (4 classes x 48 train and x 16 val at
     500 x 375, 375 x 500, 640 x 480 and 320 x 240, w x h), read back;
 24. cls cifar: Q-WRN-16-2 (BASELINE.json #1) through the classification CLI,
     2 epochs at batch 128 in bf16 from the pickle folder, then ``--resume
     last.pkl --epochs 3`` (epoch 2 alone); ms a step, img/s and the device's
     busy share; one f32 step on the card against the same step on the CPU;
 25. cls imagenet: Q-ResNet-34 (``qrn34_imagenet``, nc 1000, BASELINE.json #2)
     at 224 on the PNG folder through ClsTrainer and the folder loader, batch
     64, bf16, 3 updates under each of poincare, hamilton, raw_normalized and
     mean_brightness: finite losses, load and step ms, peak memory, top-1/5;
 26. cls yolo: QUAN-YOLO11n-cls (``yolo11n-cls-quan.yaml``, nc 1000) at 224,
     batch 8, K1 (N = 49), K1+K3 (19 sites, the Classify conv channel-tiled at
     Co = 320) and plain in bf16 and f32, launches counted and logits held to
     plain (PRED_TOL); K1 at G = 256, N = 49 and K3 at the Classify site timed
     alone; an f32 cross-entropy's gradients, K1 + K2 against plain attention;
 27. cls cli: ``classify train data=cifar10 data_dir=<the pickle folder>`` for
     one epoch in this process;
 28-34. a user's model YAML: ``yolo11n-hybrid-quan.yaml`` (yolo11-quan with
     QPSA at layer 10, C2f in the neck and the HybridDetect head; nc=80, 640)
     written to a file and reached only through ``YOLO(<its path>)``: predict
     on 8 of phase 12's frames with K1 (QPSA's attention: N = 400, dk = dv =
     4, G = 256), K1+K3 (28 fused sites) and plain, held to plain; 16 train
     micro-steps (K1 + K2) and one f32 micro-step's gradients against plain
     attention; ``YOLO.val`` with rect off, K1 against plain; ``detect
     train|val|predict model=<path>`` in-process (best.pkl names the path);
     ``Ensemble([QUAN-YOLO11n, the hybrid]).decode`` then NMS; and an f32
     ``Trainer.fit`` cut after epoch 0 and resumed from its ``last.ckpt``
     (the JAX trainer's pickle), whose next update equals the uninterrupted
     run's;
 35. the TPU-chosen defaults (ROADMAP Queue 3, "Defaults chosen on the
     H100"): the conv form (grouped, folded, auto at fold thresholds 16, 32,
     64, 128) by device busy ms of
     the OBB ``infer`` and micro-step at 1024 and a Q-WRN-16-2 step at batch
     128, one round (the defaults were chosen from two); the assigner's
     metric chain in f32 and bf16 is timed in phase 6 and ``fused_1x1`` in
     phases 4 and 13 (the ``defaults`` line);
 36. track: QUAN-YOLO11n (nc=80, seeded f32 weights, the facade's K1 + K3) follows
     a 16-frame clip written by the script (640 x 480 PNG, a textured background
     panned 2 px right and 1 px down a frame under 6 moving rectangles) through
     ``YOLO.track`` with ByteTrack and with BoT-SORT: launches a frame, ms a frame
     split into infer, the tracker's update and GMC, the tracks re-derived by a
     fresh tracker from the recorded detections, GMC's affine against the pan;
 37. benchmark: ``utils.benchmarks.benchmark`` of QUAN-YOLO11n-OBB at 1024 and
     QUAN-YOLO11n at 640, batch 8, bf16 and f32, 10 timed calls a row;
 38. export: ``YOLO.export(format="exported")`` of QUAN-YOLO11n-OBB at 1024, batch
     8, bf16: the .pt2's graph holds 1 K1 and 37 K3 operators and launches them,
     its output against the live model's (bf16 by predictions), both infers
     timed; then ``obb export`` (f32) and ``obb predict`` of that .pt2 through the
     CLI, the f32 artifact within PRED_TOL of the live f32 model;
 39. embed: ``YOLO.embed`` at 1024, batch 8, K1 + K3 against plain;
 40. tune: ``YOLO.tune`` on the detect set at 640, 2 iterations of 1 epoch, and
     ``detect tune`` of one iteration through the CLI (K1 and K2 a micro-step);
 41. autobatch's pick at 640 and 1024 from the card's memory, and ``detect track``
     and ``detect benchmark`` through the CLI;
 42. predict save: ``obb predict save=True visualize=<dir>`` through the CLI on
     the 8 frames at 1024 (f32): im{i}.jpg read back at each frame's size, 23
     feature grids an image; the bf16 facade's predict and predict(visualize=),
     and a 1024 frame's ``Results.plot`` split into drawing and JPEG encoding;
 43. segment and pose ``Results.plot`` (masks, keypoints) at 640, timed;
 44. ``Validator(save_dir=)`` on the detect set at 640: the six images (curves
     at 1800 x 1200, confusion matrices at 2400 x 1800), timed;
 45. ``--autoaugment``: one Q-WRN-16-2 epoch on the CIFAR folder with and
     without it (``curves.png`` written), AutoAugment of 128 images beside the
     step;
 46. reference weights: an OBB state dict in the reference's names and
     layouts, drawn with numpy, through ``port_state_dict``; its ``infer`` at
     1024 with K1 + K3 held to the plain path at PRED_TOL; a Q-WRN-16-2 dict
     through ``port_cls_state_dict``, every leaf exact;
 47. data parallelism over NCCL at world size 1: 8 bf16 micro-steps (one update)
     of the OBB train step at 1024 through ``Trainer(mesh=)``, whose IQBN
     moments, loss normalisers and gradients go through NCCL's collectives,
     against the same Trainer without a mesh (bf16: differences printed);
 48-50. two ranks on the one card over gloo (NCCL refuses two ranks on one
     card), started by ``parallel.distributed.launch`` under a deadline: one f32
     update of the OBB step at 1024 on ranks of batch 4 against one process of
     batch 8 (loss within 2e-5, parameters and IQBN statistics within
     tests/test_mesh.py's tolerances or twice the single process's own
     reorder noise; the ranks bitwise equal; K1 and K2 on each rank); the
     Validator and the Predictor sharded (f32, K1 + K3) against one process's;
     one Q-WRN-16-2 update at batch 128 against one process;
 51. int8 serving of the OBB model at 1024, batch 8 (``impl="int8"``,
     calibrated on the 8 frames): every int8 conv's accumulator on the card
     equal to its exact plain version (the widest also to the CPU's), device
     busy ms and host ms of ``infer`` with fused_1x1 on and off against bf16
     and f32 ``auto``, the share of bf16's kept boxes that int8 keeps, K1 and
     K3 launches;
 52. ``split_dota.split_image`` of a 4000 x 4000 scene with 200 objects into
     1024 windows (gap 200): windows, seconds, bytes;
 53. the stem's forms (``stem_s2d``, ``stem_deep`` 1-3, deep 1 with ``stem_l0="fine"``,
     and the plain stem) on the OBB predict path at 1024, bf16, K1+K3: launches
     (K3 at `fused_1x1_sites`), device busy ms and host ms of ``infer`` (medians
     of 3 interleaved rounds), the bf16 predictions and the f32 head outputs
     against the plain stem, and the default these numbers choose;
 54. a bf16 train micro-step under the plain stem, stem_s2d and deep 1 and 2,
     each without and with ``stem_remat``: ms, peak memory, K1 and K2; the f32
     loss and gradients of each against the plain stem;
 55. stem_deep=1 through a one-rank NCCL group: the packed IQBNs' statistics
     against one process's;
 56. the assigner at M = 128 on the OBB train batch: ``impl="sparse"`` against
     dense (targets bit for bit, the loss layer's device ms and peak memory),
     topk 32 (``chunk``) against topk 16 (``iter``); NMS's ``defer_argmax``
     against the default (the same detections, ``infer`` ms);
 57. the readers' newer formats (the committed progressive, EXIF-rotated and
     Adam7 fixtures) through the val loader, against their OpenCV digests,
     with their decode ms;
 58. video decode: the committed Motion-JPEG and MPEG-4 Simple Profile
     fixtures (tests/fixtures/video/, in ISO-BMFF, AVI and Matroska) through
     the port's demuxers and decoders (``data/native/video.cpp``, built in
     phase 1), each frame against the port's digest in video_fixtures.json
     (which also records OpenCV's and how far they agree), the decode ms a
     frame of the 640 x 480 MPEG-4 and Motion-JPEG clips (mean of several
     passes);
 59. ``detect track`` of the 640 x 480 MPEG-4 clip through ``cli.main``
     (ByteTrack, f32: K1 on the CUDA cores and K3 at every fused site, each
     frame), then ``YOLO.track(..., tracker="botsort")`` of the file streamed
     through ``load_source``: its tracks equal those of ``YOLO.track`` over
     the decoded frames held as arrays, ms a frame split into decode, infer
     and update;
 60. ``obb predict save=True`` of the same clip at 1024 through ``cli.main``
     (f32): an ``im{i}.jpg`` a frame, its lines those of the facade's
     predict of the decoded arrays; then the facade in bf16 (K1 + K3 on the
     tensor cores): ``predict(<clip>)`` gives the boxes of
     ``predict(<decoded arrays>)``, with its ms a frame;
 61. image formats, val: phase 7's set written again with the port's writers
     as BMP, TIFF (LZW with predictor 2; Deflate in 256 tiles) and lossless
     WebP, the Validator at 1024 (bf16, K1 + K3) on each: the PNG set's
     detections and metrics bit for bit, and the load ms a batch;
 62. image formats, fit: one ``Trainer.fit`` epoch at 1024, bf16, batch 8 on
     the BMP set and on the PNG set (K1 and K2): the loader's batches bit for
     bit the same, and the micro-steps' losses against each other;
 63. image sources: the committed BMP, TIFF and WebP fixtures through the val
     loader against their OpenCV digests (refusals by name), the decode ms of
     a 1024 x 1024 frame in each format, phase 52's scene as a tiled Deflate
     TIFF split into crops byte-equal to the PNG scene's, and ``obb predict``
     through the CLI on a folder of all seven suffixes, its labels those of
     the same pixels as PNG;
 64. video decode of this slice's codecs: the VP8 fixtures (cv2's WebM,
     libvpx's profiles 1 and 3 and error-resilient mode, golden-frame boosts)
     and the MPEG-4 Advanced Simple Profile ones (B-VOPs, quarter-pel, MPEG
     quantisation, Xvid's and DivX's user data, DivX's packed B-VOPs) against
     their digests, and the decode and RGB ms a frame of the 640 x 480 clip
     as VP8 WebM and as the Xvid ASP AVI (``vp8.h`` and ``video.cpp`` on the
     card's host);
 65. phase 59 on the VP8 WebM: ``detect track`` through ``cli.main`` and
     ``YOLO.track`` with BoT-SORT at 640 (K1 + K3), the streamed file's
     tracks equal to those of its decoded frames;
 66. phase 60 on the Xvid ASP AVI: ``obb predict save=True`` at 1024 through
     ``cli.main`` and the bf16 facade (K1 + K3), the file's boxes equal to
     those of its decoded frames;
 67. the newer TIFF and JPEG kinds on the card's host: the committed fixtures of
     JPEG-in-TIFF, raw YCbCr, CMYK, CIELab, CCITT, BigTIFF and CMYK JPEG
     through the val loader against their OpenCV digests, the kinds still
     refused failing by name, and the decode ms of a 1024 x 1024 frame in
     each new kind (made by the fixture maker's container writers: numpy,
     struct, zlib and the port's JPEG and LZW encoders);
 68. val on phase 7's set as GDAL's JPEG-YCbCr 4:2:0 tiled BigTIFF and as
     CMYK LZW TIFF, each against a PNG set of its own decoded pixels (the
     same detections and metrics, bit for bit; K1 + K3), and one
     ``Trainer.fit`` epoch on the JPEG-TIFF set and on its PNG twin (the same
     loader batches; K1 and K2);
 69. ``split_dota`` of phase 52's 4000 x 4000 scene as a tiled JPEG-YCbCr
     BigTIFF (crops byte-equal to those of the PNG scene of its decoded
     pixels) and ``obb predict`` through ``cli.main`` on a folder holding
     every new kind (labels equal to those of its pixels as PNG);
 70. VP9 on the card's host: the VP9 fixtures (cv2's ``VP90``/``vp09`` clips
     in WebM, Matroska, AVI and MP4; libvpx-vp9's tiles with backward
     adaptation, lossless and segmented full-range streams, its two passes
     with alternate references and compound prediction; superframes,
     hidden, intra-only, show_existing and bilinear-filtered frames) against
     their digests, the
     FFV1 AVI's refusal against its message, and the decode and RGB ms a
     frame of the 640 x 480 clip as VP9 WebM (``vp9.h``);
 71. phase 59 on the VP9 WebM: ``detect track`` through ``cli.main`` and
     ``YOLO.track`` with BoT-SORT at 640 (K1 + K3), the streamed file's
     tracks equal to those of its decoded frames;
 72. phase 60 on the VP9 clip's packets put into MP4 (``vp09``, by
     ``tests/fixtures/make_video_fixtures.py``'s ``write_mp4``): ``obb
     predict save=True`` at 1024 through ``cli.main`` and the bf16 facade
     (K1 + K3), the file's boxes equal to those of its decoded frames;
 73. the stills ``cv2.imread`` takes outside IMG_EXTS: every committed still
     fixture (PxM, PAM, PFM, Sun raster, Radiance HDR, GIF) against its
     OpenCV digest or its ValueError, the decode ms of a 512 x 512 file of
     each kind, ``obb predict`` at 1024 of one file of each kind through
     ``cli.main`` (K1 once and K3 at 37 sites a file) and the bf16 facade,
     the files' boxes equal to those of their decoded arrays;
 74. the H.263 family (H.263, H.263+, Sorenson H.263, MS-MPEG4 v2 and v3) and
     MPEG-4 data partitioning: their fixtures against their digests, and the
     decode and RGB ms a frame of the 640 x 480 clip as cv2's DIV3 AVI,
     beside the VP8 and VP9 clips';
 75. phases 59 and 60 on the DIV3 AVI;
 76. WMV1 and WMV2 (cv2's in AVI and Matroska; libavcodec's with inter-intra
     prediction, per-macroblock run-level tables, the loop filter with the
     top-left vector predictor, and a stream rewritten to mspel motion, skip
     maps, other CBP tables and ABT) and
     H.263+'s deblocking filter: their fixtures against their digests, and
     the decode and RGB ms a frame of the 640 x 480 clip as WMV2 (libavcodec's
     wmv2 at quantiser 22), beside the DIV3 clip's;
 77. phases 59 and 60 on the WMV2 AVI;
 78. the ``kernels`` line (launches by path: predict, train, fit, val, cli and
     the facade's fused_1x1 predict, detect_predict, detect_train,
     detect_fit, detect_val, detect_val_rect, detect_cli and
     detect_facade_fused_1x1, seg_predict, seg_train, seg_fit, seg_val,
     seg_val_native, seg_cli, pose_predict, pose_train, pose_fit, pose_val,
     pose_cli, cls_yolo, cls_yolo_fused, cls_yolo_grad, hybrid_predict,
     hybrid_predict_fused_1x1, hybrid_train, hybrid_val, hybrid_cli,
     hybrid_ensemble, hybrid_resume, track_bytetrack, track_botsort,
     benchmark, export (the facade predicting from the .pt2), embed, tune,
     cli_track, cli_benchmark, cli_tune and cli_export (``obb predict`` of
     the .pt2), cli_predict_save, predict_plot, predict_visualize, seg_plot,
     pose_plot, val_plots, reference_weights, dp_nccl_train,
     dp_gloo_{train,val,predict}_rank{0,1}, int8_fused_1x1, int8,
     stem_<form>_predict, stem_<form>[_remat]_train,
     stem_deep1_dp_nccl_train, video_cli_track, video_track_botsort,
     video_cli_predict, video_predict, video_vp8_cli_track,
     video_vp8_track_botsort, video_asp_cli_predict, video_asp_predict,
     video_vp9_cli_track, video_vp9_track_botsort, video_vp9_cli_predict,
     video_vp9_predict, image_val_{png,bmp,tiff_lzw_pred2,
     tiff_tiled_deflate,webp_lossless}, image_fit_{bmp,png},
     image_cli_predict_{mixed,png}, image_val_{jpeg_ycbcr_bigtiff,cmyk_lzw}
     and their _png twins, image_fit_jpeg_ycbcr_bigtiff{,_png},
     image_cli_predict_kinds{,_png}, still_cli_predict, still_predict,
     video_div3_cli_track, video_div3_track_botsort, video_div3_cli_predict,
     video_div3_predict, video_wmv2_cli_track, video_wmv2_track_botsort,
     video_wmv2_cli_predict and video_wmv2_predict; each
     kernel launched on each path that runs it; K1 and K2
     also timed at N = 400, 640's layer 10, at QPSA's N = 400, dk = dv = 4
     (``qpsa_n400``), and K1 at N = 49 and K3 at the Classify site; K1's and
     K3's operators counted in the exported graph), the script's seconds,
     then the result line.

Without a card, or when any phase fails, it exits non-zero and prints no
result line. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ast
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA's data sheet, dense, no sparsity), at 700 W
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
TENSOR_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # f32 products stay f32 (no TF32)
# exp2 runs on the special-function units: 16 lanes per SM (Hopper architecture
# white paper); their rate follows from the card's SM count and max SM clock
SFU_PER_SM = 16

DEVICE = "cuda"
IMGSZ, BATCH, NC = 1024, 8, 15
MODEL = "yolo11n-obb-quan.yaml"
# allclose-style tolerance |got - ref| <= rtol |ref| + atol max(1, max|ref|), per dtype.
# K1 is held to qattn.qattention_fwd_plain, which keeps the TPU kernel's rounding points, under
# qattn.FWD_TOL (elementwise and mean |err| / mean |ref|; the f32 forward of the bf16 inputs
# must miss the bf16 limits), and, under K1_TOL, to the einsum path run in f32 on the same bf16
# values: the kernel rounds scale*q and the softmax numerator to bf16 (2^-9 relative each),
# as the TPU kernel does, and that path does not.
# K3: qconv_fused.K3_TOL (bf16 keeps the plain version's rounding points, f32 inside and one
# cast at the end: at most a bf16 ulp or two apart).
K1_TOL = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (2e-2, 2e-2)}
# K2 vs the plain backward, which keeps the TPU kernel's rounding points in both dtypes:
# qattn.BWD_TOL, elementwise (rtol, atol) and a limit on mean |err| / mean |ref|; the f32
# gradients of the bf16 inputs must miss the bf16 limits
# K1's row statistics vs qattn.qattention_stats_plain: f32 summation order only
STATS_TOL = 1e-5
# decoded predictions of the kernel paths vs the all-plain path, max abs error over
# max |ref| per column group: f32 (TF32 off) differs by summation order only; bf16 by
# the rounding points of 37 fused convs through the rest of the graph
PRED_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
# the f32 Results of the kernel path vs the plain path: every kept row (xywhr in
# source pixels and radians, conf, cls) within this of a row of the other
RESULT_TOL = 1e-2
# f32 gradients of one micro-step's backward under one cotangent, fused vs plain attention
# (TF32 off): per leaf, max abs error <= GRAD_TOL * max|leaf| + GRAD_TOL * 1e-3 * max over
# leaves (summation order only)
GRAD_TOL = 1e-3
LOSS_TOL = 1e-5  # relative, the f32 loss of one micro-step, fused vs plain attention
# relative noise put on the attention's output for the gradients' noise floor: K1's f32
# deviation from the plain version, max abs error over max |ref| (2.7e-6 / 2.5 at N = 1024)
ATTN_NOISE = 1e-6
# ground-truth rows per image in the train batch: the JAX loader's padding (max_labels=128,
# quan_ultralytics_tpu/data/build.py:266); valid rows 34 to 100 an image, about DOTA-v1.0's
# mean of 67 objects an image (188,282 instances in 2,806 images, Xia et al., CVPR 2018)
TRAIN_M, TRAIN_VALID = 128, (34, 100)
TRAIN_STEPS = 16  # micro-steps driven: two optimizer updates at accumulate 8
# (N, dk) of the attention's cases held and timed alone, dv = 4, 8 heads: QC2PSA's
# heads (dk = 2) at 1024's N, 640's and 200; QPSA's (attn_ratio 1: dk = dv = 4) at 640
ATTN_CASES = ((1024, 2), (400, 2), (200, 2), (400, 4))


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3):
    """(device ms, host ms) per call of ``fn``.

    The device time comes from CUDA events around ``iters`` calls queued
    behind a spin kernel, so that the card runs them back to back and the
    host's cost of launching them drops out; the spin doubles until it
    outlasts the queuing (after five doublings the time is returned as it
    is, an upper bound). The host time is what queuing one call costs.
    """
    for _ in range(warmup):
        fn()
    cycles = 1 << 24
    for _ in range(6):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = 1e3 * (time.perf_counter() - t0)
        ev[2].record()
        ev[2].synchronize()
        if ev[0].elapsed_time(ev[1]) > host:
            break
        cycles *= 2
    return ev[1].elapsed_time(ev[2]) / iters, host / iters


def compare(got: torch.Tensor, ref: torch.Tensor, rtol: float, atol: float):
    """(max abs error, max |ref|, within tolerance) of ``got`` against ``ref``."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    scale = max(1.0, float(ref.abs().max()))
    ok = bool(torch.isfinite(got).all()) and bool((err <= rtol * ref.abs() + atol * scale).all())
    return float(err.max()), float(ref.abs().max()), ok


def bound_ms(nbytes: float, tensor_ops: float, f32_ops: float, dtype: torch.dtype):
    """Least time for the work: max(bytes / HBM rate, operations / peak rate of their type)."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = tensor_ops / TENSOR_FLOPS[dtype] + f32_ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _reset_counts():
    from quan_ultralytics_tpu_torch.ops.kernels import qattn, qconv_fused

    qattn.launches = qattn.launches_mma = qattn.launches_simt = 0
    qattn.launches_stats = qattn.launches_bwd = 0
    qconv_fused.launches = qconv_fused.launches_mma = qconv_fused.launches_simt = 0


def _counts():
    from quan_ultralytics_tpu_torch.ops.kernels import qattn, qconv_fused

    return {"qattn_fwd": qattn.launches, "qattn_fwd_with_stats": qattn.launches_stats,
            "qattn_bwd": qattn.launches_bwd, "qconv1x1_fused": qconv_fused.launches}


# ---------------------------------------------------------------- phase 1


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    card = smi.strip().splitlines()[0]
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60, check=True).stdout
    sfu_rate = (torch.cuda.get_device_properties(0).multi_processor_count * SFU_PER_SM
                * float(clock.strip().splitlines()[0]) * 1e6)  # exp2 per second
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from concurrent.futures import ThreadPoolExecutor

    from quan_ultralytics_tpu_torch.data.native import native, pixels, video
    from quan_ultralytics_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:  # the host libraries (g++) build beside the kernels (nvcc)
        host = [pool.submit(native.build), pool.submit(pixels.build), pool.submit(video.build)]
        _build.library()
        for f in host:
            f.result()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log.splitlines() if "registers" in ln or "spill" in ln]
    print(f"build: {secs:.1f} s (nvcc {_build.build_seconds if _build.build_seconds else 0:.1f} s)")
    return card, ptxas, sfu_rate


# ---------------------------------------------------------------- phase 2


def phase_k1(gen, details, sfu_rate):
    """K1 against the plain version at the TPU kernel's rounding points (qattn.FWD_TOL)
    and against the einsum path in f32 (K1_TOL), at N = 1024, 400, 200 (dk = 2, dv = 4:
    QC2PSA's heads) and at QPSA's N = 400, dk = dv = 4, in bf16 (tensor cores) and f32
    (CUDA cores); times at the main path's shape (G = 256, N = 1024, dk = 2, dv = 4,
    bf16), at 640's N = 400 (``timing["n400"]``) and at QPSA's (``timing["qpsa_n400"]``)."""
    from quan_ultralytics_tpu_torch.ops.kernels import qattn

    dv, heads = 4, 8
    worst, timing = 0.0, None
    for n, dk in ATTN_CASES:
        scale = dk ** -0.5
        for dtype in (torch.bfloat16, torch.float32):
            shp = (BATCH, 4, heads, n)
            q, k = (torch.randn(*shp, dk, generator=gen, device=DEVICE).to(dtype) for _ in range(2))
            v = torch.randn(*shp, dv, generator=gen, device=DEVICE).to(dtype)
            own = "launches_mma" if dtype == torch.bfloat16 else "launches_simt"
            before = getattr(qattn, own)
            got = qattn.qattention_fused(q, k, v, scale)
            torch.cuda.synchronize()
            check(getattr(qattn, own) == before + 1, f"K1 {dtype} did not launch {own}")
            ref = qattn.qattention_fwd_plain(q, k, v, scale)
            err, rel, ok = qattn.kernel_error(got, ref, dtype, qattn.FWD_TOL)
            row = {"kernel": "qattn_fwd", "N": n, "dk": dk, "dtype": str(dtype), "max_abs_err": err,
                   "mean_rel_err": rel, "max_abs_ref": float(ref.float().abs().max()),
                   "tol": qattn.FWD_TOL[dtype], "ok": ok}
            # the tolerance's own check: the f32 forward of these inputs must miss it in bf16
            if dtype == torch.bfloat16:
                f32 = qattn.qattention_fwd_plain(q.float(), k.float(), v.float(), scale)
                row["f32_max_abs_err"], row["f32_mean_rel_err"], f32_ok = qattn.kernel_error(
                    f32, ref, dtype, qattn.FWD_TOL)
                check(not f32_ok, f"the f32 forward meets K1's bf16 tolerance at N={n}")
            einsum = qattn.qattention_plain(q.float(), k.float(), v.float(), scale)
            row["einsum_max_abs_err"], _, einsum_ok = compare(got, einsum, *K1_TOL[dtype])
            row["einsum_tol"], row["einsum_ok"] = K1_TOL[dtype], einsum_ok
            details.append(row)
            print(f"K1 N={n} dk={dk} {dtype}: vs the plain version max_abs_err {err:.3e}, mean rel {rel:.3e}"
                  + (f" (the f32 forward: {row['f32_max_abs_err']:.3e}, mean rel "
                     f"{row['f32_mean_rel_err']:.3e})" if dtype == torch.bfloat16 else "")
                  + f"; vs the einsum path in f32 {row['einsum_max_abs_err']:.3e} "
                  f"(max|ref| {row['max_abs_ref']:.3f}) {'ok' if ok and einsum_ok else 'FAIL'}")
            check(ok, f"K1 disagrees with its plain version at N={n} dk={dk} {dtype}")
            check(einsum_ok, f"K1 disagrees with the einsum path at N={n} dk={dk} {dtype}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
            if n == 1024 or (n == 400 and dtype == torch.bfloat16):  # the main path's N; 640's
                G = BATCH * 4 * heads
                ms, host_ms = time_ms(lambda: qattn.qattention_fused(q, k, v, scale))
                if dtype == torch.float32:
                    timing["f32_ms"] = ms
                    continue
                isz = q.element_size()
                nbytes = G * n * (2 * dk + 2 * dv) * isz
                b, by = bound_ms(nbytes, G * n * n * (2 * dk + 2 * dv), G * n * n * 3, dtype)
                row = {
                    "bound_bytes_ms": 1e3 * nbytes / HBM_BYTES_S,
                    "ms": ms, "host_ms": host_ms,
                    "plain_ms": time_ms(lambda: qattn.qattention_fwd_plain(q, k, v, scale), iters=5)[0],
                    "einsum_ms": time_ms(lambda: qattn.qattention_plain(q, k, v, scale), iters=5)[0],
                    "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, scale=scale))[0],
                    "bound_ms": b, "bound_by": by,
                    # a tighter floor than the table's rates: one exp2 per score on the SFUs
                    "sfu_bound_ms": 1e3 * G * n * n / sfu_rate,
                }
                if n == 1024:
                    timing = row
                else:
                    timing["n400" if dk == 2 else "qpsa_n400"] = row
                    print(f"K1 G={G} N=400 dk={dk} dv={dv} bf16 (640{', QPSA' if dk == 4 else ''}): kernel "
                          f"{ms:.4f} ms, bound {b:.4f} ({by}), SFU floor {row['sfu_bound_ms']:.4f}, plain "
                          f"{row['plain_ms']:.4f}, SDPA {row['library_ms']:.4f}")
    print(f"K1 G={BATCH * 4 * heads} N=1024 bf16: kernel {timing['ms']:.4f} ms (host "
          f"{timing['host_ms']:.4f}), bound {timing['bound_ms']:.4f} ({timing['bound_by']}), SFU "
          f"floor {timing['sfu_bound_ms']:.4f}, plain {timing['plain_ms']:.4f}, einsum path "
          f"{timing['einsum_ms']:.4f}, SDPA {timing['library_ms']:.4f}; the f32 kernel "
          f"{timing['f32_ms']:.4f}")
    k1_stats_only_under_grad(gen, details)
    return worst, timing


def k1_stats_only_under_grad(gen, details):
    """K1 writes the row statistics only when a backward will follow: not under
    no_grad, and under grad they agree with the plain statistics."""
    from quan_ultralytics_tpu_torch.ops.kernels import qattn

    for dtype in (torch.bfloat16, torch.float32):
        q, k = (torch.randn(2, 4, 8, 400, 2, generator=gen, device=DEVICE).to(dtype) for _ in range(2))
        v = torch.randn(2, 4, 8, 400, 4, generator=gen, device=DEVICE).to(dtype)
        before = qattn.launches_stats
        with torch.no_grad():
            qattn.qattention_fused(q.requires_grad_(), k, v, 0.5)
        check(qattn.launches_stats == before, "K1 wrote row statistics under no_grad")
        with torch.enable_grad():
            out = qattn.qattention_fused(q, k, v, 0.5)
        check(qattn.launches_stats == before + 1, "K1 wrote no row statistics under grad")
        got = out.grad_fn.saved_tensors[3]
        ref = qattn.qattention_stats_plain(q.detach(), k, 0.5)
        # m relative to max(1, |m|), r relative to r
        err = max(float(((got[0] - ref[0]).abs() / ref[0].abs().clamp(min=1.0)).max()),
                  float(((got[1] - ref[1]).abs() / ref[1].abs()).max()))
        details.append({"kernel": "qattn_fwd stats", "dtype": str(dtype), "max_rel_err": err,
                        "tol": STATS_TOL, "ok": err <= STATS_TOL})
        print(f"K1 row statistics {dtype}: written only under grad; max err vs plain {err:.3e}")
        check(err <= STATS_TOL, f"K1's row statistics disagree with the plain ones: {err:.3e}")


def phase_k2(gen, details, sfu_rate):
    """K2, given the row statistics K1 writes, against the plain backward at K1's
    cases (`ATTN_CASES`) in bf16 and f32; times at the main path's shape (G = 256,
    N = 1024, dk = 2, dv = 4, bf16), at 640's N = 400 (``timing["n400"]``) and at
    QPSA's N = 400, dk = dv = 4 (``timing["qpsa_n400"]``)."""
    from quan_ultralytics_tpu_torch.ops.kernels import qattn

    dv, heads = 4, 8
    worst, timing = 0.0, None
    for n, dk in ATTN_CASES:
        scale = dk ** -0.5
        for dtype in (torch.bfloat16, torch.float32):
            shp = (BATCH, 4, heads, n)
            q, k = (torch.randn(*shp, dk, generator=gen, device=DEVICE).to(dtype) for _ in range(2))
            v, do = (torch.randn(*shp, dv, generator=gen, device=DEVICE).to(dtype) for _ in range(2))
            stats = qattn.new_stats(q)
            qattn.qattention_fwd(q, k, v, scale, stats)
            got = qattn.qattention_bwd(q, k, v, do, scale, stats)
            torch.cuda.synchronize()
            ref = qattn.qattention_bwd_plain(q, k, v, do, scale)
            # the tolerance's own check: the f32 gradients of these inputs must miss it in bf16
            f32 = (qattn.qattention_bwd_plain(q.float(), k.float(), v.float(), do.float(), scale)
                   if dtype == torch.bfloat16 else (None,) * 3)
            for name, a, r, a32 in zip(("dq", "dk", "dv"), got, ref, f32):
                err, rel, ok = qattn.kernel_error(a, r, dtype, qattn.BWD_TOL)
                row = {"kernel": "qattn_bwd", "N": n, "dk": dk, "dtype": str(dtype), "grad": name,
                       "max_abs_err": err, "mean_rel_err": rel, "max_abs_ref": float(r.float().abs().max()),
                       "tol": qattn.BWD_TOL[dtype], "ok": ok}
                if a32 is not None:
                    row["f32_max_abs_err"], row["f32_mean_rel_err"], f32_ok = qattn.kernel_error(
                        a32, r, dtype, qattn.BWD_TOL)
                    check(not f32_ok, f"the f32 {name} meets K2's bf16 tolerance at N={n}")
                details.append(row)
                print(f"K2 N={n} dk={dk} {dtype} {name}: max_abs_err {err:.3e}, mean rel {rel:.3e} "
                      f"(max|ref| {row['max_abs_ref']:.3f})"
                      + (f"; the f32 gradients: {row['f32_max_abs_err']:.3e}, mean rel "
                         f"{row['f32_mean_rel_err']:.3e}" if a32 is not None else "")
                      + f" {'ok' if ok else 'FAIL'}")
                check(ok, f"K2 {name} disagrees with the plain backward at N={n} dk={dk} {dtype}")
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
            del ref, f32
            if n in (1024, 400) and dtype == torch.bfloat16:  # the main path's N; 640's; QPSA's
                G, isz = BATCH * 4 * heads, q.element_size()
                # q, k, v, dO and the row statistics (m, r) read once; dq, dk, dv written once;
                # per score the products of recomputing S (2dk), dV (2dv), dP (2dv), dQ (2dk),
                # dK (2dk) and ~6 f32 operations
                nbytes = G * n * (4 * dk + 3 * dv) * isz + G * n * 2 * 4
                b, by = bound_ms(nbytes, G * n * n * (6 * dk + 4 * dv), G * n * n * 6, dtype)
                ms, host_ms = time_ms(lambda: qattn.qattention_bwd(q, k, v, do, scale, stats))
                plain_ms = time_ms(lambda: qattn.qattention_bwd_plain(q, k, v, do, scale), iters=5)[0]
                ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
                with torch.enable_grad():
                    out = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, scale=scale)
                    library_ms = time_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), do,
                                                                     retain_graph=True), iters=5)[0]
                    # what the plain-attention model's backward runs: autograd of the einsum path
                    out = qattn.qattention_plain(ql, kl, vl, scale)
                    autograd_ms = time_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), do,
                                                                      retain_graph=True), iters=5)[0]
                del out
                row = {"ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                       "plain_autograd_ms": autograd_ms, "bound_bytes_ms": 1e3 * nbytes / HBM_BYTES_S,
                       "library_ms": library_ms, "bound_ms": b, "bound_by": by,
                       # the floor on the special-function units: this design's 2 exp2 a
                       # score (the pre-pass for rse and the main pass)
                       "sfu_bound_ms": 1e3 * 2 * G * n * n / sfu_rate}
                if n == 1024:
                    timing = row
                else:
                    timing["n400" if dk == 2 else "qpsa_n400"] = row
                print(f"K2 G={G} N={n} dk={dk} dv={dv} bf16: kernel {ms:.4f} ms (host {host_ms:.4f}), bound {b:.4f} "
                      f"({by}), SFU floor {row['sfu_bound_ms']:.4f} (2 exp2), plain {plain_ms:.4f}, "
                      f"autograd of the plain forward {autograd_ms:.4f}, SDPA backward {library_ms:.4f}")
    return worst, timing


def phase_k3(gen, sites, details):
    from quan_ultralytics_tpu_torch.models.conv import Conv
    from quan_ultralytics_tpu_torch.ops.kernels import qconv_fused
    from quan_ultralytics_tpu_torch.ops.qconv import fold_dense_kernel

    counts = {s: sites.count(s) for s in sorted(set(sites))}
    worst = 0.0
    tot = {"ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0, "unfused_ms": 0.0, "unfused_host_ms": 0.0,
           "library_ms": 0.0, "bound_ms": 0.0, "f32_ms": 0.0}
    t_bytes = t_ops = 0.0
    for (ci, co, p), mult in counts.items():
        w = torch.randn(4, co, ci, 1, 1, generator=gen, device=DEVICE) / math.sqrt(4 * ci)
        scale = torch.rand(4, co, generator=gen, device=DEVICE) + 0.5
        shift = torch.randn(4, co, generator=gen, device=DEVICE) * 0.1
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(BATCH, p // BATCH, 1, 4, ci, generator=gen, device=DEVICE).to(dtype)
            for silu in (True, False):
                own = "launches_mma" if dtype == torch.bfloat16 else "launches_simt"
                before = getattr(qconv_fused, own)
                got = qconv_fused.qconv1x1_fused(x, w, scale, shift, apply_silu=silu)
                torch.cuda.synchronize()
                check(getattr(qconv_fused, own) == before + 1, f"K3 {dtype} did not launch {own}")
                ref = qconv_fused.qconv1x1_fused_plain(x, w, scale, shift, apply_silu=silu)
                tol = qconv_fused.K3_TOL[dtype]
                err, mag, ok = compare(got, ref, *tol)
                details.append({"kernel": "qconv1x1_fused", "Ci": ci, "Co": co, "P": p,
                                "dtype": str(dtype), "silu": silu, "max_abs_err": err,
                                "max_abs_ref": mag, "tol": tol, "ok": ok})
                check(ok, f"K3 disagrees with its plain version at Ci={ci} Co={co} P={p} "
                          f"{dtype} silu={silu}: max_abs_err {err:.3e}")
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
            if dtype != torch.bfloat16:
                f32_ms = time_ms(lambda: qconv_fused.qconv1x1_fused(x, w, scale, shift))[0]
                tot["f32_ms"] += mult * f32_ms
                details.append({"kernel": "qconv1x1_fused", "Ci": ci, "Co": co, "P": p, "sites": mult,
                                "dtype": str(dtype), "ms": f32_ms})
                continue
            # times at the main path's dtype, with SiLU (all but the ffn1 sites apply it)
            conv = Conv(4 * ci, 4 * co, 1, dtype=dtype, impl="auto").to(DEVICE).eval()
            with torch.no_grad():
                conv.conv.w.copy_(w)
            dense = fold_dense_kernel(w, conv.conv.mix).reshape(4 * co, 4 * ci).t().to(dtype).contiguous()
            x2 = x.reshape(p, 4 * ci)
            isz = x.element_size()
            nbytes = p * 4 * (ci + co) * isz + 4 * ci * co * isz + 2 * 4 * co * 4
            b, _ = bound_ms(nbytes, 2 * p * 4 * ci * co, p * 4 * co * 9, dtype)
            ms, host_ms = time_ms(lambda: qconv_fused.qconv1x1_fused(x, w, scale, shift))
            unfused_ms, unfused_host_ms = time_ms(lambda: conv(x))
            row = {
                "ms": ms, "host_ms": host_ms,
                "plain_ms": time_ms(lambda: qconv_fused.qconv1x1_fused_plain(x, w, scale, shift))[0],
                "unfused_ms": unfused_ms, "unfused_host_ms": unfused_host_ms,
                "library_ms": time_ms(lambda: torch.matmul(x2, dense))[0],
                "bound_ms": b,
            }
            details.append({"kernel": "qconv1x1_fused", "Ci": ci, "Co": co, "P": p, "sites": mult,
                            "dtype": str(dtype), **row})
            print(f"K3 Ci={ci:3d} Co={co:3d} P={p:6d} x{mult}: kernel {ms:.4f} ms "
                  f"(host {host_ms:.4f}), bound {b:.4f}, unfused {unfused_ms:.4f} "
                  f"(host {unfused_host_ms:.4f}), plain {row['plain_ms']:.4f}, "
                  f"matmul {row['library_ms']:.4f}")
            for key in row:
                tot[key] += mult * row[key]
            t_bytes += mult * nbytes / HBM_BYTES_S
            t_ops += mult * (2 * p * 4 * ci * co / TENSOR_FLOPS[dtype] + p * 4 * co * 9 / F32_FLOPS)
    tot["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    print(f"K3 all {len(sites)} sites, bf16: max_abs_err {worst:.3e}; per forward kernel "
          f"{tot['ms']:.3f} ms (host {tot['host_ms']:.3f}), bound {tot['bound_ms']:.3f}, "
          f"unfused {tot['unfused_ms']:.3f} (host {tot['unfused_host_ms']:.3f}), matmul "
          f"{tot['library_ms']:.3f}; the f32 kernel at the same sites {tot['f32_ms']:.3f}")
    return worst, tot


# ---------------------------------------------------------------- phase 3


def make_frames(seed: int):
    """8 uint8 RGB frames, some non-square, from a seeded generator: a smooth gradient
    with a few filled rectangles and noise."""
    rng = np.random.default_rng(seed)
    sizes = [(1024, 1024), (768, 1024), (1024, 640), (900, 1200),
             (512, 512), (1080, 1920), (1024, 1024), (700, 1000)]
    frames = []
    for h, w in sizes:
        yy, xx = np.mgrid[0:h, 0:w]
        im = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (h + w)], -1)
        for _ in range(6):
            y0, x0 = rng.integers(0, h - 64), rng.integers(0, w - 64)
            im[y0:y0 + rng.integers(16, 64), x0:x0 + rng.integers(16, 64)] = rng.integers(0, 256, 3)
        im = im + rng.integers(-8, 9, im.shape)
        frames.append(np.clip(im, 0, 255).astype(np.uint8))
    return frames


def seeded_model(dtype: torch.dtype, seed: int = 0, model: str = MODEL, nc: int = NC, **kw):
    """The n model with every weight, IQBN statistic and head bias drawn from ``seed``,
    without K3 unless ``kw`` has ``fused_1x1=True``.

    ``from_yaml`` draws the conv weights; the IQBN statistics and affines and
    the QER biases are drawn here too (gamma, var U(0.5, 1.5); beta, mean
    N(0, 0.1); QER biases N(0, 1)), so that the scores spread and NMS has
    distinct boxes to keep or suppress, as a trained model's would.
    """
    from quan_ultralytics_tpu_torch.models.tasks import DetectionModel

    kw = {"fused_1x1": False, **kw}  # the K1 path unless ``kw`` asks for K3
    return spread(DetectionModel.from_yaml(model, nc=nc, dtype=dtype, device=DEVICE, seed=seed, **kw), seed)


def spread(model, seed: int):
    """Draw ``model``'s IQBN statistics and affines and its QER biases from ``seed + 1``
    (see `seeded_model`), in place; returns it."""
    from quan_ultralytics_tpu_torch.models.conv import IQBN
    from quan_ultralytics_tpu_torch.models.head import QER

    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, IQBN):
                for t, lo in ((mod.gamma, 0.5), (mod.var, 0.5)):
                    t.copy_(torch.rand(t.shape, generator=gen) + lo)
                for t in (mod.beta, mod.mean):
                    t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
            elif isinstance(mod, QER):
                mod.proj.bias.copy_(torch.randn(mod.proj.bias.shape, generator=gen))
    return model


def build_models(model: str = MODEL, nc: int = NC):
    """The three paths over the same seeded bf16 weights."""
    paths = {"K1": dict(), "K1+K3": dict(fused_1x1=True), "plain": dict(fused_attn=False)}
    return {name: seeded_model(torch.bfloat16, model=model, nc=nc, **kw) for name, kw in paths.items()}


def phase_predict(models, frames, n_sites: int):
    from quan_ultralytics_tpu_torch.engine.predictor import Predictor
    from quan_ultralytics_tpu_torch.ops.kernels import qattn, qconv_fused

    out = {"launches": {}, "detections": {}}
    expect = {"K1": (1, 0), "K1+K3": (1, n_sites), "plain": (0, 0)}
    for name, model in models.items():
        pred = Predictor(model, imgsz=IMGSZ, conf=0.25)
        _reset_counts()
        res = pred(frames)  # the main path, driven once
        torch.cuda.synchronize()
        got = (qattn.launches_mma, qconv_fused.launches_mma)
        out["launches"][name] = {"qattn_fwd": got[0], "qattn_bwd": qattn.launches_bwd,
                                 "qconv1x1_fused": got[1]}
        print(f"predict [{name}]: launches K1 {got[0]}, K3 {got[1]} (bf16, tensor cores; expected "
              f"{expect[name]}), K2 {qattn.launches_bwd}, K1 with statistics {qattn.launches_stats}")
        check(got == expect[name] and qattn.launches_bwd == 0 and qattn.launches_stats == 0
              and qattn.launches == qattn.launches_mma
              and qconv_fused.launches == qconv_fused.launches_mma,
              f"{name}: kernel launches {got}, K2 {qattn.launches_bwd}, K1 with statistics "
              f"{qattn.launches_stats} != {expect[name]}, 0, 0")
        check(len(res) == len(frames) and all(np.isfinite(r.boxes).all() for r in res),
              f"{name}: bad Results")
        low = Predictor(model, imgsz=IMGSZ, conf=0.0)(frames)
        out["detections"][name] = {"conf_0.25": [len(r) for r in res],
                                   "conf_0": [len(r) for r in low]}
        print(f"predict [{name}]: detections per frame at conf 0.25 {[len(r) for r in res]}, "
              f"at conf 0 (the top 2048 anchors enter NMS) {[len(r) for r in low]}")
        for r in low:
            check(r.boxes.shape[1] == 7 and np.isfinite(r.boxes).all(), "bad low-conf Results")
            check(len(r) > 0, f"{name}: NMS kept nothing at conf 0")
    return out


def decoded(model, x_u8):
    with torch.inference_mode():
        return model.decode(model(x_u8.float() / 255.0)).float()


def kept_counts(pred: torch.Tensor, nc: int = NC, rotated: bool = True, conf: float = None,
                iou: float = 0.7):
    """Detections NMS keeps an image, by default at validation's settings (conf VAL_CONF, IoU 0.7)."""
    from quan_ultralytics_tpu_torch.ops.boxes import non_max_suppression

    return non_max_suppression(pred, conf_thres=VAL_CONF if conf is None else conf, iou_thres=iou,
                               max_det=300, nc=nc, rotated=rotated)[1].sum(1).tolist()


def compare_preds(a: torch.Tensor, ref: torch.Tensor, nc: int, tail: str = "angle"):
    """max abs error over max |ref| for the box and score columns and the rest, named
    ``tail`` (the OBB angle, the segment task's mask coefficients ``mc``, the pose
    task's decoded keypoints ``kpts``)."""
    groups = {"xywh": slice(0, 4), "scores": slice(4, 4 + nc)}
    if ref.shape[-1] > 4 + nc:
        groups[tail] = slice(4 + nc, None)
    out = {}
    for g, sl in groups.items():
        err = float((a[..., sl] - ref[..., sl]).abs().max())
        out[g] = err / max(float(ref[..., sl].abs().max()), 1e-6)
    return out


def phase_agree(models, frames):
    """Decoded predictions of the kernel paths vs the all-plain path, bf16 and
    f32, and the f32 detections of the whole Predictor."""
    from quan_ultralytics_tpu_torch.data.augment import letterbox
    from quan_ultralytics_tpu_torch.engine.predictor import Predictor

    x = torch.stack([letterbox(torch.from_numpy(f).to(DEVICE), IMGSZ)[0] for f in frames])
    agree = {}
    ref = decoded(models["plain"], x)
    for name in ("K1", "K1+K3"):
        rel = compare_preds(decoded(models[name], x), ref, NC)
        agree[f"{name} bf16"] = rel
        print(f"agree [{name} vs plain, bf16]: max abs err / max|ref| {rel}")
        check(all(v <= PRED_TOL[torch.bfloat16] for v in rel.values()),
              f"{name} bf16 predictions disagree with the plain path: {rel}")
    f32 = {"K1+K3": seeded_model(torch.float32, fused_1x1=True),
           "plain": seeded_model(torch.float32, fused_attn=False)}
    xs = x[:2]
    rel = compare_preds(decoded(f32["K1+K3"], xs), decoded(f32["plain"], xs), NC)
    agree["K1+K3 f32"] = rel
    print(f"agree [K1+K3 vs plain, f32, 2 frames]: max abs err / max|ref| {rel}")
    check(all(v <= PRED_TOL[torch.float32] for v in rel.values()),
          f"K1+K3 f32 predictions disagree with the plain path: {rel}")
    # the whole Predictor in f32: the same detections, box for box, in any order
    kept = [Predictor(f32[name], imgsz=IMGSZ, conf=0.05)(frames[:2]) for name in ("K1+K3", "plain")]
    for ra, rb in zip(*kept):
        check(len(ra) == len(rb) > 0, f"f32 detections differ in number: {len(ra)} vs {len(rb)}")
        d = np.abs(ra.boxes[:, None, :] - rb.boxes[None, :, :]).max(-1)
        check(bool((d.min(1) <= RESULT_TOL).all() and (d.min(0) <= RESULT_TOL).all()),
              f"f32 detections differ by more than {RESULT_TOL}: {d.min(1).max()}")
    agree["K1+K3 f32 detections"] = [len(r) for r in kept[0]]
    print(f"agree [K1+K3 vs plain, f32, 2 frames]: same detections {[len(r) for r in kept[0]]}")
    return x, agree


def phase_throughput(models, frames, x, rounds: int = 6):
    """img/s of each path: whole Predictor calls on the frames (host clock,
    synchronized) and ``infer`` on the letterboxed batch (host clock, synchronized).

    The paths take turns, forward then backward order in alternate rounds, so
    that drift of the card's clock or of the host's load falls on all alike;
    the medians over rounds are reported.
    """
    from quan_ultralytics_tpu_torch.engine.predictor import Predictor

    preds = {name: Predictor(m, imgsz=IMGSZ, conf=0.25) for name, m in models.items()}
    for pred in preds.values():
        pred(frames)
        pred.infer(x)
    torch.cuda.synchronize()
    names = list(preds)
    e2e = {name: [] for name in names}
    dev = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            pred = preds[name]
            t0 = time.perf_counter()
            for _ in range(3):
                pred(frames)
            torch.cuda.synchronize()
            e2e[name].append(3 * len(frames) / (time.perf_counter() - t0))
            t0 = time.perf_counter()
            for _ in range(5):
                pred.infer(x)
            torch.cuda.synchronize()
            dev[name].append(1e3 * (time.perf_counter() - t0) / 5)
    out = {}
    for name in names:
        ms = statistics.median(dev[name])
        out[name] = {"predict_img_s": statistics.median(e2e[name]), "infer_ms": ms,
                     "infer_img_s": BATCH * 1e3 / ms, "predict_img_s_rounds": e2e[name],
                     "infer_ms_rounds": dev[name]}
        print(f"speed [{name}]: predict {out[name]['predict_img_s']:.1f} img/s end to end, "
              f"infer {ms:.2f} ms per batch of {BATCH} ({BATCH * 1e3 / ms:.1f} img/s); "
              f"median of {rounds} rounds")
    return out


def _device_profile(fn, calls: int, tag: str, tables=None, top: int = 8):
    """torch.profiler over ``calls`` calls of ``fn``: device busy ms a call, device ops a
    call, the port's kernels' device ms a call and the ``top`` device ops by time (null
    where the profiler records no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        return {"device_ms": None}
    by_name = {}
    for e in ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / (1e3 * calls)
    if tables is not None:
        tables.append(f"== {tag}: {calls} calls")
        tables.append(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=30))
    return {"device_ms": sum(by_name.values()), "device_ops": len(ops) / calls,
            "kernel_device_ms": {k: sum(v for n, v in by_name.items() if k in n)
                                 for k in ("qattn_fwd_", "qattn_bwd_", "qconv1x1_")},
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:top]}


def phase_device_share(models, x, speed, tables=None):
    """Device time, device operations and busy share of one ``infer``, from
    torch.profiler over three calls (null where it records no device activity)."""
    from quan_ultralytics_tpu_torch.engine.predictor import Predictor

    out = {}
    for name, model in models.items():
        pred = Predictor(model, imgsz=IMGSZ, conf=0.25)
        pred.infer(x)
        torch.cuda.synchronize()
        prof = _device_profile(lambda: pred.infer(x), 3, f"{name}: 3 x infer, batch {BATCH} @ {IMGSZ}", tables)
        busy, wall = prof["device_ms"], speed[name]["infer_ms"]
        # device time of the port's own kernels on this path, per infer
        own = {k: prof.get("kernel_device_ms", {}).get(k, 0.0) for k in ("qattn_fwd_", "qconv1x1_")}
        out[name] = {"device_ms": busy, "device_ops": prof.get("device_ops", 0),
                     "busy_share": busy / wall if busy is not None else None, "kernel_device_ms": own}
        print(f"device [{name}]: {prof.get('device_ops', 0):.0f} device operations per infer, busy "
              + (f"{busy:.2f} ms of {wall:.2f} ms, share {busy / wall:.3f}; port kernels {own}"
                 if busy is not None else "not measured"))
    return out


# ---------------------------------------------------------------- phase 5


def make_train_batch(seed: int):
    """A seeded synthetic OBB batch at the main path's size: 8 uint8 frames
    [8, 1024, 1024, 3] (a smooth gradient with noise) and TRAIN_M padded rotated
    boxes per image (normalized xywhr; TRAIN_VALID valid rows, the rest masked)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:IMGSZ, 0:IMGSZ]
    base = np.stack([xx * 255 // IMGSZ, yy * 255 // IMGSZ, (xx + yy) * 255 // (2 * IMGSZ)], -1)
    img = np.clip(base[None] + rng.integers(-20, 21, (BATCH, IMGSZ, IMGSZ, 3)), 0, 255).astype(np.uint8)
    boxes = np.concatenate([rng.uniform(0.1, 0.9, (BATCH, TRAIN_M, 2)),
                            rng.uniform(0.02, 0.2, (BATCH, TRAIN_M, 2)),
                            rng.uniform(-math.pi / 4, 3 * math.pi / 4, (BATCH, TRAIN_M, 1))], -1)
    mask = np.arange(TRAIN_M)[None, :] < rng.integers(TRAIN_VALID[0], TRAIN_VALID[1] + 1, (BATCH, 1))
    return {"img": torch.from_numpy(img).to(DEVICE),
            "cls": torch.from_numpy(rng.integers(0, NC, (BATCH, TRAIN_M)).astype(np.int32)).to(DEVICE),
            "bboxes": torch.from_numpy(boxes.astype(np.float32)).to(DEVICE),
            "mask": torch.from_numpy(mask).to(DEVICE)}


def make_trainer(dtype: torch.dtype, model: str = MODEL, nc: int = NC, **kw):
    """The port's Trainer on the n model (weights from seed 0) with the default
    TrainConfig at batch 8 (nbs 64: accumulate 8); ``mesh`` in ``kw`` goes to the Trainer."""
    from quan_ultralytics_tpu_torch.engine.trainer import TrainConfig, Trainer
    from quan_ultralytics_tpu_torch.models.tasks import DetectionModel

    fused_attn = kw.pop("fused_attn", True)
    mesh = kw.pop("mesh", None)
    model_kw = kw.pop("model_kw", {})  # the model's own options (the stem's form)
    model = DetectionModel.from_yaml(model, nc=nc, dtype=dtype, device=DEVICE, fused_attn=fused_attn, **model_kw)
    cfg = TrainConfig(batch=BATCH, dtype="bfloat16" if dtype == torch.bfloat16 else "float32", **kw)
    return Trainer(model, cfg, steps_per_epoch=100, device=DEVICE, mesh=mesh)


def phase_train(batch):
    """16 micro-steps of the main path's train step (bf16, fused attention)."""
    from quan_ultralytics_tpu_torch.ops.kernels import qattn, qconv_fused

    trainer = make_trainer(torch.bfloat16)
    check(trainer.accumulate == 8, f"accumulate {trainer.accumulate} != 8")

    def flat(ts):
        return torch.cat([t.detach().reshape(-1) for t in ts])

    losses, changed = [], []
    _reset_counts()
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):  # the main path, driven
        p0, e0 = flat(trainer.params), flat(trainer.ema)
        loss, aux = trainer.step(batch)
        losses.append(float(loss))
        changed.append((not torch.equal(p0, flat(trainer.params)),
                        not torch.equal(e0, flat(trainer.ema)), float(aux["nan_skipped"])))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = {"qattn_fwd": qattn.launches, "qattn_fwd_tensor_cores": qattn.launches_mma,
           "qattn_bwd": qattn.launches_bwd, "qconv1x1_fused": qconv_fused.launches,
           "qattn_fwd_with_stats": qattn.launches_stats}
    print(f"train: {TRAIN_STEPS} micro-steps in {secs:.1f} s; losses {[round(x, 3) for x in losses]}")
    print(f"train: launches {got} (expected K1 {TRAIN_STEPS}, all with statistics, K2 "
          f"{TRAIN_STEPS}, K3 0)")
    check(all(math.isfinite(x) for x in losses), f"non-finite train loss: {losses}")
    check(all(c[2] == 0.0 for c in changed), "a micro-step was skipped by the NaN guard")
    update_at = [i + 1 for i, c in enumerate(changed) if c[0]]
    ema_at = [i + 1 for i, c in enumerate(changed) if c[1]]
    print(f"train: parameters changed at micro-steps {update_at}, EMA at {ema_at}")
    check(update_at == [8, 16] and ema_at == [8, 16],
          f"parameters / EMA changed at {update_at} / {ema_at}, not at [8, 16]")
    check(got == {"qattn_fwd": TRAIN_STEPS, "qattn_fwd_tensor_cores": TRAIN_STEPS,
                  "qattn_bwd": TRAIN_STEPS, "qconv1x1_fused": 0,
                  "qattn_fwd_with_stats": TRAIN_STEPS}, f"train launches {got}")
    return {"losses": losses, "launches": got, "seconds": secs, "updates_at": update_at}


def head_outputs(trainer, batch):
    """The head's outputs of a train-mode forward on ``batch``, as one flat
    list, and the number of levels: the first that many are ``feats``, the
    rest the OBB head's ``angles``, the segment head's ``mc`` and ``proto`` or
    the pose head's ``kpts``."""
    trainer.model.train()
    out = trainer.model((batch["img"].float() / 255.0).to(trainer.dtype))
    if trainer.model.task == "detect":
        return list(out), len(out)
    feats, *rest = out
    return [*feats, *[t for r in rest for t in (r if isinstance(r, (list, tuple)) else [r])]], len(feats)


def loss_of(trainer, outs, n_feats, batch):
    """The trainer's loss (`Trainer.head_loss`, chosen by the task) of flat head
    outputs ``outs`` (see `head_outputs`)."""
    n, task = n_feats, trainer.model.task
    if task == "detect":
        out = outs[:n]
    elif task == "segment":
        out = (outs[:n], outs[n:2 * n], outs[2 * n])
    else:  # OBB angles, pose keypoints
        out = (outs[:n], outs[n:])
    return trainer.head_loss(out, batch)[0]


def phase_train_grads(batch, model: str = MODEL, nc: int = NC, tag: str = "train"):
    """One f32 micro-step (TF32 off, f32 assigner metric) with fused and with plain
    attention from the same weights.

    The loss's gradient with respect to the head's outputs is ill-conditioned at
    f32 rounding (the assignment, and the OBB angle term's arccos near 1), so the
    whole micro-step's gradients of the two paths differ by more than their
    backward does. The networks' backward is held under one cotangent, the
    plain path's gradient of the loss with respect to the head's outputs: per
    leaf within GRAD_TOL, and the losses within LOSS_TOL. Reported beside it:
    the fused path's whole micro-step gradients, and the plain path's with the
    attention's output perturbed by ATTN_NOISE relative (the noise floor)."""
    from quan_ultralytics_tpu_torch.models.block import QAttention

    def step(fused, cot=None, perturb=0.0):
        tr = make_trainer(torch.float32, model=model, nc=nc, fused_attn=fused, assigner_bf16=False)
        gen = torch.Generator(device=DEVICE).manual_seed(1)
        for mod in tr.model.modules():
            if perturb and isinstance(mod, QAttention):
                mod.register_forward_hook(lambda _m, _i, o: o * (1 + perturb * torch.randn(
                    o.shape, generator=gen, device=o.device, dtype=o.dtype)))
        outs, n_feats = head_outputs(tr, batch)
        leaves = [t.detach().requires_grad_() for t in outs]
        total = loss_of(tr, leaves, n_feats, batch)
        own = torch.autograd.grad(total, leaves)

        def backward(cotangent, retain):
            gs = torch.autograd.grad(outs, tr.params, cotangent, retain_graph=retain, allow_unused=True)
            return [torch.zeros_like(p) if g is None else g for p, g in zip(tr.params, gs)]

        res = {"loss": float(total.detach()), "cot": own, "names": tr.param_names,
               "own": backward(own, cot is not None)}
        if cot is not None:
            res["same"] = backward(cot, False)
        return res

    plain = step(False)
    fused = step(True, cot=plain["cot"])
    noisy = step(False, perturb=ATTN_NOISE)
    names, ref = plain["names"], plain["own"]
    gmax = max(float(g.abs().max()) for g in ref)

    def share(grads):
        """(largest share of the tolerance used, its leaf, worst err / max|leaf|, its leaf)."""
        used, used_name, rel, rel_name = 0.0, None, 0.0, None
        for n, a, r in zip(names, grads, ref):
            check(bool(torch.isfinite(a).all()), f"non-finite f32 gradient of {n}")
            err, mag = float((a - r).abs().max()), float(r.abs().max())
            lim = GRAD_TOL * mag + GRAD_TOL * 1e-3 * gmax
            if err / lim > used:
                used, used_name = err / lim, n
            if mag >= 1e-3 * gmax and err / mag > rel:  # leaves above the absolute term's scale
                rel, rel_name = err / mag, n
        return used, used_name, rel, rel_name

    out = {"max_grad": gmax, "loss_plain": plain["loss"], "loss_fused": fused["loss"]}
    for key, grads in (("same_cotangent", fused["same"]), ("micro_step", fused["own"]),
                       ("noise_floor", noisy["own"])):
        used, used_name, rel, rel_name = share(grads)
        out[key] = {"tolerance_used": used, "leaf": used_name, "worst_rel": rel, "worst_rel_leaf": rel_name}
        print(f"{tag} f32 gradients [{key}], fused vs plain attention"
              + (f" (the plain path, attention output x (1 + {ATTN_NOISE} noise))" if key == "noise_floor" else "")
              + f": largest share of the tolerance {used:.3f} ({used_name}); worst max err / "
              f"max|leaf| over leaves above 1e-3 of the largest gradient {rel:.3e} ({rel_name})")
    loss_rel = abs(fused["loss"] - plain["loss"]) / abs(plain["loss"])
    out["loss_rel_err"] = loss_rel
    print(f"{tag} f32 loss: fused {fused['loss']:.6f}, plain {plain['loss']:.6f} (rel {loss_rel:.2e}); "
          f"largest gradient {gmax:.3e}")
    check(loss_rel <= LOSS_TOL, f"{tag}: f32 loss, fused vs plain attention: rel err {loss_rel:.3e} > {LOSS_TOL}")
    check(out["same_cotangent"]["tolerance_used"] <= 1.0,
          f"f32 gradient of {out['same_cotangent']['leaf']}, fused vs plain attention under one "
          f"cotangent: {out['same_cotangent']['tolerance_used']:.3f} of the tolerance")
    qkv = next(a for n, a in zip(names, fused["same"]) if n.endswith("attn.qkv.w"))
    check(float(qkv.abs().max()) > 0, "no gradient reached the attention's qkv")
    return out


# ---------------------------------------------------------------- phase 6


def phase_train_speed(batch, rounds: int = 3, tables=None):
    """ms per micro-step with fused (K1 + K2) and plain attention, one accumulation
    (8 micro-steps, the update included) per round, host clock, synchronized, the
    paths taking turns; then torch.profiler over one accumulation of each path:
    device ms and busy share per micro-step, and the attention kernels' device ms."""
    trainers = {"fused": make_trainer(torch.bfloat16),
                "plain": make_trainer(torch.bfloat16, fused_attn=False)}
    n = trainers["fused"].accumulate
    for tr in trainers.values():
        for _ in range(n):
            tr.step(batch)
    torch.cuda.synchronize()
    names = list(trainers)
    walls = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            for _ in range(n):
                trainers[name].step(batch)
            torch.cuda.synchronize()
            walls[name].append(1e3 * (time.perf_counter() - t0) / n)
    out = {}
    for name, tr in trainers.items():
        prof = _device_profile(lambda: tr.step(batch), n,
                               f"train [{name}]: {n} micro-steps, batch {BATCH} @ {IMGSZ}, bf16", tables)
        busy, n_ops = prof["device_ms"], prof.get("device_ops", 0)
        own = {k: prof.get("kernel_device_ms", {}).get(k, 0.0) for k in ("qattn_fwd_", "qattn_bwd_")}
        ms = statistics.median(walls[name])
        out[name] = {"ms_per_micro_step": ms, "ms_rounds": walls[name],
                     "spread_ms": max(walls[name]) - min(walls[name]),
                     "img_s": BATCH * 1e3 / ms, "device_ms": busy, "device_ops": n_ops,
                     "busy_share": busy / ms if busy is not None else None, "kernel_device_ms": own}
        print(f"train speed [{name}]: {ms:.1f} ms per micro-step of {BATCH} (median of {rounds}, "
              f"rounds {[round(w, 1) for w in walls[name]]}), {BATCH * 1e3 / ms:.1f} img/s; "
              + (f"device busy {busy:.2f} ms, share {busy / ms:.3f}, {n_ops:.0f} device ops; "
                 f"attention kernels {own}" if busy is not None else "device time not measured"))
    return out


def phase_loss_layer(batch, m_cut: int = 16, calls: int = 3):
    """The loss layer alone, ``obb_loss`` (the bf16 assigner included) and its
    backward to the head's outputs, on one train-mode forward's outputs: at the
    batch's TRAIN_M padded rows and with the rows cut to ``m_cut``; and at TRAIN_M
    with the assigner's metric chain in f32 (``assigner_bf16=False``, ROADMAP
    Queue 3, "Defaults chosen on the H100"; key ``"<TRAIN_M> f32 assigner"``). Device ms a call from torch.profiler (the
    sum of its kernels' times) and host ms a call (host clock, synchronized)."""
    tr = make_trainer(torch.bfloat16)
    with torch.no_grad():
        outs, n_feats = head_outputs(tr, batch)
    leaves = [t.detach().requires_grad_() for t in outs]

    def run(b):
        torch.autograd.grad(loss_of(tr, leaves, n_feats, b), leaves)

    out = {}
    for rows, assigner_bf16 in ((TRAIN_M, True), (m_cut, True), (TRAIN_M, False)):
        tr.cfg.assigner_bf16 = assigner_bf16
        key = rows if assigner_bf16 else f"{rows} f32 assigner"
        b = {k: (v if k == "img" else v[:, :rows]) for k, v in batch.items()}
        run(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof = _device_profile(lambda: run(b), calls, f"loss layer, M={key}")
        wall = 1e3 * (time.perf_counter() - t0) / calls
        busy, n_ops = prof["device_ms"], prof.get("device_ops", 0)
        out[key] = {"device_ms": busy, "host_ms": wall, "device_ops": n_ops}
        print(f"loss layer, M={key}: obb_loss + backward, device busy "
              + (f"{busy:.3f} ms over {n_ops:.0f} device ops" if busy is not None else "not measured")
              + f", {wall:.3f} ms a call on the host clock (profiled)")
    return out


# ---------------------------------------------------------------- phases 7-10


# the DOTA-layout set of phase_data: image sizes (h, w), 4 images of each; DOTA's
# images run from about 800 to 4,000 pixels a side (Xia et al., CVPR 2018)
DATA_SIZES = [(1024, 1024), (768, 1365), (1536, 1152), (600, 800)] * 4
DATA_BOXES = (2, 40)  # rectangles an image
FIT_EPOCHS = 2
FIT_CLOSE_MOSAIC = 1  # the last epoch trains on plain frames (the recipe closes the last 10 of 300)
VAL_CONF = 0.001
# validation with a kernel vs with the plain version in the same dtype: in f32 detection
# counts may differ on at most one image in 16 beyond those that the order of near-equal
# scores explains (phase_val), metrics by at most this
VAL_METRIC_TOL = 5e-3
LABEL_TOL = 1e-5  # a saved label's normalized corner or conf off the facade's, over max(1, |value|) (%.6g)
NMS_POOL = 2048  # candidates an image that enter rotated NMS (ops/boxes.py non_max_suppression)


def _fill_rotated(im, cx, cy, w, h, t, colour):
    """Fill the rotated rectangle in place, within its bounding box."""
    c, s = math.cos(t), math.sin(t)
    r = 0.5 * math.hypot(w, h)
    y0, y1 = max(int(cy - r), 0), min(int(cy + r) + 1, im.shape[0])
    x0, x1 = max(int(cx - r), 0), min(int(cx + r) + 1, im.shape[1])
    yy, xx = np.mgrid[y0:y1, x0:x1]
    u = (xx - cx) * c + (yy - cy) * s
    v = -(xx - cx) * s + (yy - cy) * c
    im[y0:y1, x0:x1][(np.abs(u) <= w / 2) & (np.abs(v) <= h / 2)] = colour


def phase_data(root: Path, seed: int = 0):
    """Write a DOTA-layout set with the port's PNG writer (16 images, 2-40 filled
    rotated rectangles each over the 15 classes, 8-corner labels), check that
    every PNG and the committed baseline-JPEG fixtures decode exactly, and time
    the decode of a 1024 x 1024 PNG and JPEG."""
    from quan_ultralytics_tpu_torch.cfg.datasets import DOTA_V1
    from quan_ultralytics_tpu_torch.data.native import native

    rng = np.random.default_rng(seed)
    (root / "images" / "train").mkdir(parents=True)
    (root / "labels" / "train").mkdir(parents=True)
    written, n_boxes = [], 0
    t0 = time.perf_counter()
    for i, (h, w) in enumerate(DATA_SIZES):
        yy, xx = np.mgrid[0:h, 0:w]
        im = np.stack([xx * 160 // w, yy * 160 // h, (xx + yy) * 160 // (h + w)], -1).astype(np.uint8)
        im = np.clip(im + rng.integers(0, 24, im.shape), 0, 255).astype(np.uint8)
        lines = []
        for _ in range(int(rng.integers(DATA_BOXES[0], DATA_BOXES[1] + 1))):
            bw, bh = rng.uniform(16, min(160, min(h, w) / 4), 2)
            cx, cy = rng.uniform(bw, w - bw), rng.uniform(bh, h - bh)
            t = rng.uniform(0, math.pi)
            c, sn = math.cos(t), math.sin(t)
            pts = [(cx + dx * c - dy * sn, cy + dx * sn + dy * c)
                   for dx, dy in ((-bw / 2, -bh / 2), (bw / 2, -bh / 2), (bw / 2, bh / 2), (-bw / 2, bh / 2))]
            _fill_rotated(im, cx, cy, bw, bh, t, rng.integers(170, 256, 3))
            lines.append(" ".join([str(rng.integers(0, NC))] + [f"{x / w:.6f} {y / h:.6f}" for x, y in pts]))
            n_boxes += 1
        path = root / "images" / "train" / f"P{i:04d}__0_0.png"
        native.imwrite_png(path, im)
        (root / "labels" / "train" / f"P{i:04d}__0_0.txt").write_text("\n".join(lines) + "\n")
        written.append((path, im))
    write_s = time.perf_counter() - t0
    for path, im in written:
        check(np.array_equal(native.imread(path), im), f"{path.name} does not decode to the pixels written")
    fixtures = Path(__file__).resolve().parent / "tests" / "fixtures"
    for name in ("jpeg_420_q90_rst", "jpeg_422_q75_odd", "jpeg_gray_q95"):
        check(np.array_equal(native.imread(fixtures / f"{name}.jpg"), np.load(fixtures / f"{name}.npy")),
              f"{name}.jpg does not decode to its committed OpenCV pixels")
    png = next(p for p, im in written if im.shape[:2] == (1024, 1024))
    times = {}
    for key, path in (("png_1024_ms", png), ("jpeg_1024_ms", fixtures / "jpeg_1024_q75.jpg")):
        native.imread(path)
        t0 = time.perf_counter()
        for _ in range(5):
            native.imread(path)
        times[key] = 1e3 * (time.perf_counter() - t0) / 5
    cfg = {"path": str(root), "train": "images/train", "val": "images/train", "names": DOTA_V1["names"]}
    print(f"data: {len(written)} PNG images ({n_boxes} boxes) written in {write_s:.1f} s and decoded "
          f"exactly; the JPEG fixtures decode to their OpenCV pixels; decode of a 1024 x 1024 PNG "
          f"{times['png_1024_ms']:.2f} ms, of a 1024 x 1024 baseline JPEG (4:2:0, q75) "
          f"{times['jpeg_1024_ms']:.2f} ms")
    return cfg, {"images": len(written), "boxes": n_boxes, "write_s": write_s, **times}


# the augmentation fixtures (tests/fixtures/make_augment_fixtures.py): each case's
# function of the port. The warps may miss OpenCV by one gray level on at most
# WARP_SHARE of the values (they agree exactly where the fixtures were made);
# everything else is exact.
WARP_SHARE = 1e-3


def augment_fixture_errors(fixtures: Path):
    """{case: (values off, values, max abs error)} of the port's pixel functions
    against the committed OpenCV outputs in ``fixtures``."""
    from quan_ultralytics_tpu_torch.data import augment as aug
    from quan_ultralytics_tpu_torch.data.native import pixels

    cases = json.loads((fixtures / "cases.json").read_text())
    src = np.load(fixtures / "src.npy")
    got = {}
    for name, case in cases.items():
        inp = got.get(case.get("input"), src)
        if name in ("warp_affine_turn", "warp_affine_mosaic", "warp_perspective"):
            fn = pixels.warp_perspective if name == "warp_perspective" else pixels.warp_affine
            got[name] = fn(src, np.array(case["m"]), tuple(case["dsize"]))
        elif name in ("rgb_to_hsv", "hsv_to_rgb", "rgb_to_gray", "rgb_to_lab", "lab_to_rgb"):
            got[name] = getattr(pixels, name)(inp)
        elif name == "random_hsv":
            hyp = aug.AugmentHyp(*case["gains"])
            got[name] = aug.random_hsv(src, hyp, np.random.default_rng(case["seed"]))
        elif name in ("blur", "median_blur"):
            got[name] = getattr(pixels, name)(src, case["k"])
        elif name == "clahe":
            got[name] = pixels.clahe(np.ascontiguousarray(inp[..., case["channel"]]), case["clip"])
        elif name == "fill_polygons":
            got[name] = pixels.fill_polygons(np.zeros(src.shape[:2], np.uint8),
                                             [np.array(q, np.int32) for q in case["polygons"]])
        else:
            raise PhaseError(f"augment fixtures: unknown case {name}")
    out = {}
    for name, arr in got.items():
        ref = np.load(fixtures / f"{name}.npy")
        check(arr.shape == ref.shape, f"augment fixture {name}: shape {arr.shape} != {ref.shape}")
        d = np.abs(arr.astype(int) - ref.astype(int))
        out[name] = (int((d > 0).sum()), int(d.size), int(d.max()))
    return out


def augment_fixtures_agree(errors) -> bool:
    return all(off <= (WARP_SHARE * n if name.startswith("warp") else 0) and worst <= 1
               for name, (off, n, worst) in errors.items())


def phase_augment(cfg):
    """The native augmentation library built here against the committed OpenCV
    outputs (the limits of the CPU tests), then the load time of one augmenting
    batch (mosaic, warp, photometric list, HSV, flips under the default
    AugmentHyp) and of one plain batch of BATCH at IMGSZ from phase 7's images,
    and the share of one augmenting batch that mosaic and warp take on one
    loader thread."""
    from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
    from quan_ultralytics_tpu_torch.data import build as build_mod
    from quan_ultralytics_tpu_torch.data.augment import AugmentHyp

    errors = augment_fixture_errors(Path(__file__).resolve().parent / "tests" / "fixtures" / "augment")
    print(f"augment: the library built here against OpenCV's pixels (values off, values, max error): {errors}")
    check(augment_fixtures_agree(errors), f"augment: the native pixels disagree with OpenCV: {errors}")
    tds = YOLODataset(cfg, "train", task="obb")

    def load_ms(augment: bool, workers: int = 4, rounds: int = 3):
        times = []
        for r in range(rounds):
            t0 = time.perf_counter()
            batch = next(build_dataloader(tds, BATCH, IMGSZ, hyp=AugmentHyp() if augment else None,
                                          augment=augment, seed=r, workers=workers))
            times.append(1e3 * (time.perf_counter() - t0))
        return times, batch

    aug_ms, aug_batch = load_ms(True)
    plain_ms, _ = load_ms(False)
    check(aug_batch["img"].shape == (BATCH, IMGSZ, IMGSZ, 3) and aug_batch["mask"].any(),
          "augment: an augmenting batch without labels")
    check(np.isfinite(aug_batch["bboxes"]).all(), "augment: non-finite boxes")
    # one thread: the time in mosaic and warp over the batch's time
    spent = {"mosaic": 0.0, "warp": 0.0}

    def timed(fn, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[key] += time.perf_counter() - t0
        return run

    saved = build_mod._mosaic4, build_mod.random_perspective
    build_mod._mosaic4, build_mod.random_perspective = timed(saved[0], "mosaic"), timed(saved[1], "warp")
    try:
        one_ms, _ = load_ms(True, workers=1, rounds=1)
    finally:
        build_mod._mosaic4, build_mod.random_perspective = saved
    share = {k: 1e3 * v / one_ms[0] for k, v in spent.items()}
    out = {"fixtures": errors, "augment_batch_ms": aug_ms, "plain_batch_ms": plain_ms,
           "augment_batch_ms_one_thread": one_ms[0], "share_one_thread": share}
    print(f"augment: load a batch of {BATCH} at {IMGSZ} (4 threads): augmenting "
          f"{statistics.median(aug_ms):.1f} ms (rounds {[round(t, 1) for t in aug_ms]}), plain "
          f"{statistics.median(plain_ms):.1f} ms (rounds {[round(t, 1) for t in plain_ms]}); on one thread "
          f"an augmenting batch takes {one_ms[0]:.1f} ms, mosaic {share['mosaic']:.3f} and warp "
          f"{share['warp']:.3f} of it (the mosaic's time includes its 4 loads)")
    return out


def phase_fit(cfg, run_dir: Path):
    """Trainer.fit for FIT_EPOCHS epochs at 1024, bf16, batch 8 (nbs 8: an update
    a micro-step), validating the EMA weights each epoch, with the DOTA recipe's
    augmentations (the default AugmentHyp: mosaic 1.0, fliplr 0.5, scale 0.5,
    translate 0.1, HSV) until close_mosaic (1 here) closes them for the last
    epoch; then a trainer restored from ``latest()`` runs one more epoch.
    Returns the EMA weights' state."""
    from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
    from quan_ultralytics_tpu_torch.data.augment import AugmentHyp
    from quan_ultralytics_tpu_torch.engine.trainer import TrainConfig, Trainer
    from quan_ultralytics_tpu_torch.engine.validator import Validator
    from quan_ultralytics_tpu_torch.utils.callbacks import Callbacks, CSVLogger
    from quan_ultralytics_tpu_torch.utils.checkpoint import latest

    tds = YOLODataset(cfg, "train", task="obb")
    vds = YOLODataset(cfg, "val", task="obb")
    steps = len(tds) // BATCH

    def trainer():
        # the predict phases' seeded weights (spread IQBN statistics and head biases), so
        # that scores stay spread after a few updates and validation has boxes to score
        model = seeded_model(torch.bfloat16)
        return Trainer(model, TrainConfig(batch=BATCH, nbs=BATCH, epochs=FIT_EPOCHS + 1),
                       steps_per_epoch=steps, device=DEVICE)

    # the JAX facade's loader (quan_ultralytics_tpu/engine/model.py:99-106): the recipe's
    # augmentations until close_mosaic sets hyp.mosaic to 0, then plain letterboxed frames
    hyp = AugmentHyp()
    seen = {}  # epoch -> frames and label count of its batches

    def loader(epoch):
        frames, labels = seen.setdefault(epoch, ([], [0]))
        for batch in build_dataloader(tds, BATCH, IMGSZ, hyp=hyp if hyp.mosaic else None, augment=True,
                                      seed=epoch):
            frames.append(batch["img"])
            labels[0] += int(batch["mask"].sum())
            yield batch

    def close_mosaic_hook(epoch):
        hyp.mosaic = 0.0  # reference close_mosaic (trainer.py:354)

    val_times = []

    def validate(tr):
        val = Validator(tr.model, imgsz=IMGSZ, conf=VAL_CONF)
        with tr.ema_weights():
            metrics = val(vds, batch_size=BATCH)
        val_times.append(val.speed)
        return metrics

    tr = trainer()
    ema0 = torch.cat([e.reshape(-1) for e in tr.ema]).clone()
    cb = Callbacks()
    CSVLogger(run_dir).attach(cb)
    _reset_counts()
    t0 = time.perf_counter()
    history = tr.fit(loader, validate, epochs=FIT_EPOCHS, save_dir=run_dir, callbacks=cb,
                     close_mosaic_hook=close_mosaic_hook, close_mosaic=FIT_CLOSE_MOSAIC,
                     log=lambda line: print("fit:", line))  # the main path, driven
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = _counts()
    # the augmented epochs' frames against the plain loader's, batch by batch; the closed
    # epochs' frames are the plain loader's
    closed_from = FIT_EPOCHS - FIT_CLOSE_MOSAIC
    differ = {}
    for epoch, (frames, labels) in seen.items():
        plain = [b["img"] for b in build_dataloader(tds, BATCH, IMGSZ, hyp=None, augment=False, seed=epoch)]
        differ[epoch] = sum(not np.array_equal(a, b) for a, b in zip(frames, plain))
        print(f"fit: epoch {epoch}: {len(frames)} batches, {labels[0]} labels, {differ[epoch]} batches "
              f"whose frames differ from the plain loader's")
        check(len(frames) == steps and labels[0] > 0, f"fit: epoch {epoch} had {labels[0]} labels")
        check(differ[epoch] == (len(frames) if epoch < closed_from else 0),
              f"fit: epoch {epoch}: {differ[epoch]} of {len(frames)} batches differ from the plain loader's")
    check(hyp.mosaic == 0.0, "fit: close_mosaic did not close the augmentations")
    ema_moved = float((torch.cat([e.reshape(-1) for e in tr.ema]) - ema0).abs().max())
    print(f"fit: {FIT_EPOCHS} epochs of {steps} micro-steps in {secs:.1f} s (validation included); "
          f"launches {got}; EMA moved by up to {ema_moved:.3e}")
    check(len(history) == FIT_EPOCHS and all(math.isfinite(r["loss"]) for r in history),
          f"fit history {history}")
    check(all(0 <= r[k] <= 1 for r in history for k in ("mAP50", "mAP50-95", "precision", "recall")),
          "fit: a metric outside [0, 1]")
    check(ema_moved > 0, "fit: the EMA did not move")
    n_micro = FIT_EPOCHS * steps
    n_val = FIT_EPOCHS * math.ceil(len(vds) / BATCH)
    check(got == {"qattn_fwd": n_micro + n_val, "qattn_fwd_with_stats": n_micro, "qattn_bwd": n_micro,
                  "qconv1x1_fused": 0}, f"fit launches {got}")
    for name in ("last.ckpt", "best.ckpt", "results.json", "results.csv"):
        check((run_dir / name).exists(), f"fit wrote no {name}")
    check(latest(run_dir) == str(run_dir / "last.ckpt"), f"latest() found {latest(run_dir)}")
    with tr.ema_weights():
        weights = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    overlap = loader_overlap(tr, tds)
    del tr
    tr2 = trainer()
    start = tr2.restore_checkpoint(latest(run_dir))
    check(start == FIT_EPOCHS, f"the restored trainer starts at epoch {start}")
    t0 = time.perf_counter()
    h3 = tr2.fit(loader, validate, start_epoch=start, save_dir=run_dir, close_mosaic_hook=close_mosaic_hook,
                 close_mosaic=FIT_CLOSE_MOSAIC, log=lambda line: print("fit:", line))
    torch.cuda.synchronize()
    check([r["epoch"] for r in h3] == [FIT_EPOCHS] and math.isfinite(h3[0]["loss"]),
          f"the restored trainer's epoch {h3}")
    out = {"epochs": FIT_EPOCHS, "micro_steps_per_epoch": steps, "seconds": secs,
           "epoch_s": [r["time_s"] for r in history], "history": history, "launches": got,
           "ema_moved": ema_moved, "restored_epoch_s": time.perf_counter() - t0,
           "val_speed": val_times, "augmented_epochs": closed_from,
           "batches_differing_from_plain": differ, "loader_overlap": overlap}
    print(f"fit: train time an epoch {[r['time_s'] for r in history]} s; the restored trainer's "
          f"epoch {FIT_EPOCHS} loss {h3[0]['loss']:.4f}")
    del tr2
    torch.cuda.empty_cache()
    return weights, out


OVERLAP_STEPS = 5  # timed batches of each arm of the loader-overlap measurement
OVERLAP_WARMUP = 2  # batches stepped before an arm's clock starts: the prefetcher's queue drains
GIL_PROBE_S = 2.0  # seconds the GIL probe samples the loader alone
SHORT_SWITCH_S = 2e-4  # the interpreter's switch interval in one arm (its default is 5 ms)


def _gil_probe(seconds: float, stop=None):
    """``time.sleep(0)`` (which lets the GIL go and takes it back) in a loop for
    ``seconds``, or until ``stop`` is set: the loop's count, the seconds spent in
    those calls, and the seconds in all."""
    spent, count, t_start = 0.0, 0, time.perf_counter()
    t_end = t_start + seconds
    while (stop is None or not stop.is_set()) and time.perf_counter() < t_end:
        t0 = time.perf_counter()
        time.sleep(0)
        spent += time.perf_counter() - t0
        count += 1
    return count, spent, time.perf_counter() - t_start


def _gil_wait_share(seconds: float, base_s: float, stop=None) -> float:
    """The share of the time this thread waits to take the GIL back, beyond the
    ``base_s`` that one ``time.sleep(0)`` takes with nothing else running: about
    the share of the time the other threads hold the GIL."""
    count, spent, total = _gil_probe(seconds, stop)
    return max(0.0, spent - count * base_s) / total


def loader_overlap(tr, tds, n: int = OVERLAP_STEPS):
    """The steady state of a long epoch, host clock, synchronized after each
    micro-step, for the augmenting loader and for the plain one (the closed
    epochs'): ``n`` batches of 8 at 1024 loaded and then stepped in turn (the loop
    before the prefetcher) and ``n`` fed by `prefetch_to_device`, in the order
    sequential, prefetched, prefetched, sequential, each after OVERLAP_WARMUP
    untimed batches; ms a batch of each arm (its n batches' time over n), the
    loader's wait and the micro-step in each. Then what slows the micro-step
    beside the loader: the micro-step on a batch already on the card alone,
    beside the augmenting loader's threads, the same at a switch interval of
    SHORT_SWITCH_S (the main thread takes the GIL back sooner), and beside four
    threads of the native warp alone (the host's cores, with the GIL free); the
    share of the time the loader's threads hold the GIL, and the micro-step's
    main thread, from a probe; and the blocking upload of one batch."""
    import itertools
    import threading

    from quan_ultralytics_tpu_torch.data import build_dataloader
    from quan_ultralytics_tpu_torch.data.augment import AugmentHyp
    from quan_ultralytics_tpu_torch.data.native import pixels
    from quan_ultralytics_tpu_torch.parallel.prefetch import prefetch_to_device

    def endless(seed, augment):
        return (b for e in itertools.count(seed)
                for b in build_dataloader(tds, BATCH, IMGSZ, hyp=AugmentHyp() if augment else None,
                                          augment=augment, seed=e))

    def arm(batches):
        for _ in range(OVERLAP_WARMUP):
            tr.step(next(batches))
        torch.cuda.synchronize()
        wait, step = [], []
        start = time.perf_counter()
        for _ in range(n):
            t0 = time.perf_counter()
            b = next(batches)
            t1 = time.perf_counter()
            tr.step(b)
            torch.cuda.synchronize()
            wait.append(1e3 * (t1 - t0))
            step.append(1e3 * (time.perf_counter() - t1))
        batch_ms = 1e3 * (time.perf_counter() - start) / n
        batches.close()
        return batch_ms, wait, step

    host = next(build_dataloader(tds, BATCH, IMGSZ, hyp=None, augment=False, seed=0))
    fixed = tr._batch(host)

    def alone(k: int = n):
        ms = []
        for _ in range(k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.step(fixed)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        return ms

    def beside(work, threads: int):
        """The micro-step alone while ``threads`` threads run ``work`` in a loop."""
        stop = threading.Event()

        def loop():
            while not stop.is_set():
                work()
        ts = [threading.Thread(target=loop, daemon=True) for _ in range(threads)]
        for t in ts:
            t.start()
        time.sleep(0.5)  # the loader's first batch under way
        try:
            return alone()
        finally:
            stop.set()
            for t in ts:
                t.join()

    tr.step(fixed)
    out = {"steps_timed": n, "warmup": OVERLAP_WARMUP, "intra_op_threads": torch.get_num_threads()}
    for augment in (True, False):
        rows = {"sequential": [], "prefetched": []}
        for i, kind in enumerate(("sequential", "prefetched", "prefetched", "sequential")):
            src = endless(100 * (i + 1), augment)
            rows[kind].append(arm(src if kind == "sequential" else prefetch_to_device(src, DEVICE, size=2)))
        row = {kind: {"batch_ms": [r[0] for r in rs], "wait_ms": [v for r in rs for v in r[1]],
                      "step_ms": [v for r in rs for v in r[2]]} for kind, rs in rows.items()}
        row["ratio"] = statistics.mean(row["prefetched"]["batch_ms"]) / statistics.mean(row["sequential"]["batch_ms"])
        out["augmented" if augment else "plain"] = row
        seq, pre = row["sequential"], row["prefetched"]
        print(f"fit: steady state, {'augmenting' if augment else 'plain'} loader, ms a batch of 8 at 1024 "
              f"({n} batches an arm after {OVERLAP_WARMUP}): loaded then stepped "
              f"{[round(v, 1) for v in seq['batch_ms']]} (waits median {statistics.median(seq['wait_ms']):.0f}, "
              f"steps median {statistics.median(seq['step_ms']):.0f}), prefetched "
              f"{[round(v, 1) for v in pre['batch_ms']]} (waits median {statistics.median(pre['wait_ms']):.0f}, "
              f"steps median {statistics.median(pre['step_ms']):.0f}); prefetched / sequential {row['ratio']:.3f}")

    # what slows the micro-step beside the loader
    loader_work = iter(endless(900, True))
    canvas = np.random.default_rng(0).integers(0, 256, (2 * IMGSZ, 2 * IMGSZ, 3), dtype=np.uint8)
    warp_m = np.array([[0.5, 0.1, 10.0], [-0.1, 0.5, 20.0]])
    interval = sys.getswitchinterval()
    step = {"alone_before": alone()}
    step["beside_loader"] = beside(lambda: next(loader_work), 1)  # its 4 pool threads
    sys.setswitchinterval(SHORT_SWITCH_S)
    try:
        step["beside_loader_short_switch"] = beside(lambda: next(loader_work), 1)
    finally:
        sys.setswitchinterval(interval)
    step["beside_native_warps"] = beside(lambda: pixels.warp_affine(canvas, warp_m, (IMGSZ, IMGSZ)), 4)
    step["alone_after"] = alone()
    loader_work.close()
    count, spent, _ = _gil_probe(0.5)  # nothing else running
    base = spent / count
    stop = threading.Event()

    def load_until_stopped():
        batches = endless(950, True)
        for _ in batches:
            if stop.is_set():
                break
        batches.close()
    worker = threading.Thread(target=load_until_stopped, daemon=True)
    worker.start()
    time.sleep(0.5)
    loader_share = _gil_wait_share(GIL_PROBE_S, base)
    stop.set()
    worker.join()
    done, probe = threading.Event(), {}
    sampler = threading.Thread(target=lambda: probe.setdefault("share", _gil_wait_share(60.0, base, done)))
    sampler.start()
    alone(3)
    done.set()
    sampler.join()
    upload = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr._batch(host)
        torch.cuda.synchronize()
        upload.append(1e3 * (time.perf_counter() - t0))
    out["step_ms"] = step
    out["gil_held_share"] = {"augmenting_loader": loader_share, "micro_step": probe["share"]}
    out["gil_probe_sleep0_us"] = 1e6 * base
    out["upload_ms"] = upload
    out["upload_mb"] = sum(np.asarray(v).nbytes for v in host.values()) / 1e6
    med = {k: round(statistics.median(v), 1) for k, v in step.items()}
    print(f"fit: a micro-step (median of {n}, ms): {med}; the GIL held by the augmenting loader's threads "
          f"{loader_share:.3f} of the time, by the micro-step's main thread {probe['share']:.3f} (a probe's "
          f"sleep(0) alone {1e6 * base:.1f} us); the blocking upload of a batch ({out['upload_mb']:.1f} MB) "
          f"{statistics.median(upload):.2f} ms ({[round(v, 2) for v in upload]})")
    return out


def phase_val(cfg, weights, out_dir: Path):
    """The Validator at 1024, conf 0.001, on the fitted EMA weights: bf16 with K1,
    with K1 and K3 and with the plain attention and convs, f32 with K1 and with
    the plain attention. Each run's launches are counted from 0 and read just
    after it; each kernel run is held to the plain run of its dtype."""
    from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
    from quan_ultralytics_tpu_torch.engine.validator import Validator
    from quan_ultralytics_tpu_torch.models.tasks import DetectionModel
    from quan_ultralytics_tpu_torch.ops.boxes import non_max_suppression
    from quan_ultralytics_tpu_torch.ops.kernels import qattn, qconv_fused

    ds = YOLODataset(cfg, "val", task="obb")
    nb = math.ceil(len(ds) / BATCH)
    bf16, f32 = torch.bfloat16, torch.float32
    paths = {"bf16 K1": (bf16, {}), "bf16 K1+K3": (bf16, {"fused_1x1": True}),
             "bf16 plain": (bf16, {"fused_attn": False}),
             "f32 K1": (f32, {}), "f32 plain": (f32, {"fused_attn": False})}
    # each run's launches (K1 on the tensor cores, K1 on the CUDA cores, K3 on the
    # tensor cores, K3 in all, K1 with statistics, K2): the bf16 runs launch only
    # the tensor-core kernels, f32 K1 only the CUDA-core K1, the plain runs none
    expect = {"bf16 K1": (nb, 0, 0, 0), "bf16 K1+K3": (nb, 0, 37 * nb, 37 * nb),
              "bf16 plain": (0, 0, 0, 0), "f32 K1": (0, nb, 0, 0), "f32 plain": (0, 0, 0, 0)}
    models = {}
    for name, (dtype, kw) in paths.items():
        m = DetectionModel.from_yaml(MODEL, nc=NC, dtype=dtype, device=DEVICE, **{"fused_1x1": False, **kw})
        m.load_state_dict(weights)
        models[name] = m
    for m in models.values():  # warm up: cuDNN picks its algorithms, the kernels load
        Validator(m, imgsz=IMGSZ, conf=VAL_CONF).infer(torch.zeros(BATCH, IMGSZ, IMGSZ, 3, dtype=torch.uint8,
                                                                   device=DEVICE))
    torch.cuda.synchronize()
    res = {}
    for name, m in models.items():
        val = Validator(m, imgsz=IMGSZ, conf=VAL_CONF)
        sub = out_dir / name.replace(" ", "_").replace("+", "_") / "Task1"
        js = sub.parent / "dets.json"
        sub.parent.mkdir(parents=True, exist_ok=True)
        _reset_counts()
        metrics = val(ds, batch_size=BATCH, save_json=str(js), save_submission=str(sub))  # the main path
        torch.cuda.synchronize()
        got = (qattn.launches_mma, qattn.launches_simt, qconv_fused.launches_mma, qconv_fused.launches)
        counts = _counts()
        print(f"val [{name}]: launches {counts}, K1 tensor cores / CUDA cores {got[:2]}, K3 tensor "
              f"cores {got[2]} (expected {expect[name][:3]})")
        check(got == expect[name] and counts["qattn_fwd"] == sum(got[:2])
              and counts["qattn_fwd_with_stats"] == 0 and counts["qattn_bwd"] == 0,
              f"val [{name}]: launches {counts}, {got} != {expect[name]}")
        per_image = {Path(s.im_file).stem: 0 for s in ds.samples}
        for d in json.loads(js.read_text()):
            per_image[d["image_id"]] += 1
        res[name] = {"metrics": metrics, "speed": val.speed, "detections": list(per_image.values()),
                     "task1_files": len(list(sub.glob("Task1_*.txt"))), "launches": counts}
        print(f"val [{name}]: {metrics}; {val.speed['img_s']:.1f} img/s on the host clock; a batch of "
              f"{BATCH}: load + letterbox {val.speed['load_ms']:.1f} ms, infer {val.speed['infer_ms']:.1f} "
              f"ms, match + AP {val.speed['match_ms']:.1f} ms; detections per image "
              f"{res[name]['detections']}")
    for name, r in res.items():
        check(all(math.isfinite(v) and 0 <= v <= 1 for v in r["metrics"].values()),
              f"val [{name}]: metrics {r['metrics']}")
        check(r["task1_files"] == NC, f"val [{name}]: {r['task1_files']} Task1 files, not {NC}")
    # each kernel run against the plain run of its dtype: the decoded predictions (NMS's
    # input) of every val batch, then the kept detections and the metrics
    loader = build_dataloader(ds, BATCH, IMGSZ, hyp=None, augment=False, shuffle=False, drop_last=False)
    xs = [torch.from_numpy(batch["img"]).to(DEVICE) for batch in loader]
    agree = {}
    for name, ref in (("bf16 K1", "bf16 plain"), ("bf16 K1+K3", "bf16 plain"), ("f32 K1", "f32 plain")):
        rel = [compare_preds(decoded(models[name], x), decoded(models[ref], x), NC) for x in xs]
        rel = {g: max(r[g] for r in rel) for g in rel[0]}
        a, b = res[name], res[ref]
        same = sum(x == y for x, y in zip(a["detections"], b["detections"]))
        diff = {k: abs(a["metrics"][k] - b["metrics"][k]) for k in a["metrics"]}
        agree[f"{name} vs {ref}"] = {"decoded_rel_err": rel, "same_count_images": same, "metric_diff": diff}
        print(f"val, {name} vs {ref}: decoded predictions of the {len(xs)} batches, max abs err / "
              f"max|ref| {rel}; the same detection count on {same} of {len(ds)} images "
              f"({sum(a['detections'])} vs {sum(b['detections'])} detections); metric differences {diff}")
        dtype = paths[name][0]
        check(all(v <= PRED_TOL[dtype] for v in rel.values()),
              f"val, {name}: decoded predictions disagree with {ref}: {rel}")
        check(all(v <= VAL_METRIC_TOL for v in diff.values()), f"val, {name} vs {ref}: metrics differ by {diff}")
        if dtype == f32:  # in bf16 NMS's pool is cut inside a block of tied scores: see below
            # greedy NMS keeps the higher of two overlapping boxes, and the two runs' scores
            # differ by an ulp or so: where near-equal scores overlap, the kernel's order
            # may keep another box. An image whose count differs is explained when NMS on
            # the kernel's boxes with the plain run's scores keeps the plain run's count.
            unexplained = []
            for bi, x in enumerate(xs):
                kd, rd = decoded(models[name], x), decoded(models[ref], x)
                swapped = kd.clone()
                swapped[..., 4:4 + NC] = rd[..., 4:4 + NC]
                n_swapped, n_ref = kept_counts(swapped), kept_counts(rd)
                for i in range(x.shape[0]):
                    j = bi * BATCH + i
                    if j < len(ds) and a["detections"][j] != b["detections"][j] and n_swapped[i] != n_ref[i]:
                        unexplained.append(j)
            agree[f"{name} vs {ref}"]["count_differs_unexplained"] = unexplained
            print(f"val, {name} vs {ref}: {len(ds) - same} images keep another count, explained by the "
                  f"order of near-equal scores on all but {unexplained}")
            check(len(unexplained) <= 1, f"val, {name} vs {ref}: detection counts differ on images {unexplained}, "
                  "not explained by the order of near-equal scores")
    # why bf16 keeps fewer boxes, on the first batch: the anchors whose best class score
    # equals the last one NMS_POOL takes, and what NMS keeps of f32 scores rounded to bf16
    pred = {n: decoded(models[n], xs[0]) for n in ("bf16 plain", "f32 plain")}
    rounded = pred["f32 plain"].clone()
    rounded[..., 4:4 + NC] = rounded[..., 4:4 + NC].to(bf16).float()
    pred["f32 plain, scores rounded to bf16"] = rounded
    ties = {}
    for n, p in pred.items():
        score = p[..., 4:4 + NC].amax(-1)
        last = score.topk(NMS_POOL, dim=1).values[:, -1:]
        ok = non_max_suppression(p, conf_thres=VAL_CONF, iou_thres=0.7, max_det=300, nc=NC, rotated=True)[1]
        ties[n] = {"over_conf": int((score > VAL_CONF).sum()), "tied_at_pool_cut": (score == last).sum(1).tolist(),
                   "kept": ok.sum(1).tolist()}
    print(f"val, first batch of {BATCH} ({xs[0].shape[0] * pred['f32 plain'].shape[1]} anchors): anchors "
          f"over conf, tied with the {NMS_POOL}th candidate an image, and kept by NMS an image: {ties}")
    return {"paths": res, "launches": res["bf16 K1+K3"]["launches"], "agree": agree, "ties": ties}


def write_data_yaml(cfg, path: Path) -> Path:
    """A data config file of ``cfg`` (path, train, val, names) at ``path``, in the flat YAML the CLI reads."""
    path.write_text(f"path: {cfg['path']}\ntrain: {cfg['train']}\nval: {cfg['val']}\nnames:\n"
                    + "".join(f"  {k}: {v}\n" for k, v in cfg["names"].items()))
    return path


def default_k3_sites(model, nc: int) -> int:
    """The 1x1 sites that the facade's default (``FUSED_1X1``) routes to K3 in eval."""
    from quan_ultralytics_tpu_torch.models.tasks import FUSED_1X1, DetectionModel, fused_1x1_sites

    return len(fused_1x1_sites(DetectionModel.from_yaml(model, nc=nc, device="cpu"), 1, 64)) if FUSED_1X1 else 0


def _cli(argv, main=None):
    """``cli.main(argv)`` (or another entry point's ``main``) in this process (so
    the launch counters see it): its exit code, standard output, seconds and
    launches."""
    import contextlib
    import io

    from quan_ultralytics_tpu_torch import cli
    from quan_ultralytics_tpu_torch.ops.kernels import qattn

    out = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = (main or cli.main)(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = {**_counts(), "qattn_fwd_tensor_cores": qattn.launches_mma, "qattn_fwd_cuda_cores": qattn.launches_simt}
    text = out.getvalue()
    for line in text.splitlines():  # the epoch lines and the result; not the tables
        if line.startswith(("epoch ", "{", "resumed", "best top1")):
            print("cli:", line)
    print(f"cli: {' '.join(argv[:2])}: "
          f"exit {rc} in {secs:.1f} s; "
          f"launches {got}")
    check(rc == 0, f"cli {argv[:2]} exited {rc}")
    return text, secs, got


def phase_cli(cfg, root: Path):
    """The user's entry points on the card: ``python -m quan_ultralytics_tpu_torch.cli``
    run in this process on phase_data's set: ``obb train`` from a facade checkpoint of
    the predict phases' seeded weights (2 epochs at 1024, batch 8, nbs 8,
    close_mosaic 1; the CLI gives no dtype, so the trainer casts to its bf16
    default as the JAX CLI's does, and validation runs in f32), ``obb val`` and
    ``obb predict`` (f32) of its best.pkl; then the label files predict saved against
    the facade's boxes, and ``YOLO(..., dtype=bf16, fused_1x1=True).predict``, which
    runs K3 at its 37 sites."""
    from quan_ultralytics_tpu_torch.data import YOLODataset
    from quan_ultralytics_tpu_torch.engine.model import YOLO

    import os
    import pickle

    # the run's settings file lives in the run's directory, with every logger integration
    # off but TensorBoard (local files): a client library installed here (wandb, ...) would
    # otherwise try to reach its server
    os.environ["QUAN_TORCH_SETTINGS"] = str(root / "settings.json")
    from quan_ultralytics_tpu_torch.utils import settings
    from quan_ultralytics_tpu_torch.utils.weights import export_jax_variables

    check(settings.SETTINGS.file == root / "settings.json", f"settings file {settings.SETTINGS.file}")
    off = [f"{k}=False" for k, v in settings.SETTINGS.items() if v is True and k != "tensorboard"]
    _cli(["settings", *off])
    check(not any(v is True for k, v in json.loads((root / "settings.json").read_text()).items()
                  if k != "tensorboard"), "cli settings left an integration on")

    # the predict phases' seeded weights as a facade checkpoint: from a fresh draw every score
    # is about 2.6e-4, and val and predict would keep no box at conf 0.001
    start = root / "seeded.pkl"
    tree = export_jax_variables(seeded_model(None))
    start.write_bytes(pickle.dumps({"model_yaml": MODEL, "nc": NC, "names": list(cfg["names"].values()),
                                    **tree, "raw_params": tree["params"], "step": 0}))
    data = write_data_yaml(cfg, root / "data.yaml")
    run, pred = root / "run", root / "predict"
    src = Path(cfg["path"]) / cfg["train"]
    n_images = len(YOLODataset(str(data), "train", task="obb"))
    steps = n_images // BATCH
    n_val = math.ceil(n_images / BATCH)
    text, train_s, train_n = _cli(["obb", "train", f"model={start}", f"data={data}", f"epochs={FIT_EPOCHS}",
                                   f"batch={BATCH}", f"imgsz={IMGSZ}", f"close_mosaic={FIT_CLOSE_MOSAIC}",
                                   f"nbs={BATCH}", f"save_dir={run}"])
    epoch_s = [float(ln.split("time_s=")[1].split()[0]) for ln in text.splitlines() if ln.startswith("epoch ")]
    check(len(epoch_s) == FIT_EPOCHS, f"cli train: {len(epoch_s)} epoch lines")
    for name in ("last.pkl", "best.pkl", "last.ckpt", "best.ckpt", "results.csv", "results.json"):
        check((run / name).exists(), f"cli train wrote no {name}")
    history = json.loads((run / "results.json").read_text())
    check(all(math.isfinite(r["loss"]) for r in history), f"cli train history {history}")
    n_micro, k3 = FIT_EPOCHS * steps, default_k3_sites(MODEL, NC)
    check(train_n == {"qattn_fwd": n_micro + FIT_EPOCHS * n_val, "qattn_fwd_with_stats": n_micro,
                      "qattn_bwd": n_micro, "qconv1x1_fused": k3 * FIT_EPOCHS * n_val,
                      "qattn_fwd_tensor_cores": n_micro, "qattn_fwd_cuda_cores": FIT_EPOCHS * n_val},
          f"cli train launches {train_n}")
    best = run / "best.pkl"
    text, val_s, val_n = _cli(["obb", "val", f"model={best}", f"data={data}", f"imgsz={IMGSZ}", f"batch={BATCH}",
                               f"conf={VAL_CONF}"])
    metrics = ast.literal_eval(text.strip().splitlines()[-1])  # the CLI prints the metrics dict
    check(all(0 <= metrics[k] <= 1 for k in ("mAP50", "mAP50-95", "precision", "recall")),
          f"cli val metrics {metrics}")
    check(val_n["qattn_fwd"] == val_n["qattn_fwd_cuda_cores"] == n_val and val_n["qattn_bwd"] == 0
          and val_n["qconv1x1_fused"] == k3 * n_val, f"cli val launches {val_n}")
    text, pred_s, pred_n = _cli(["obb", "predict", f"model={best}", f"source={src}", f"imgsz={IMGSZ}",
                                 f"conf={VAL_CONF}", "save_txt=True", "save_conf=True", f"save_dir={pred}"])
    lines = [ln for ln in text.splitlines() if ln.startswith("image ")]
    check(len(lines) == n_images and len(list((pred / "labels").glob("im*.txt"))) == n_images,
          f"cli predict: {len(lines)} image lines")
    check(pred_n["qattn_fwd"] == pred_n["qattn_fwd_cuda_cores"] == 1 and pred_n["qconv1x1_fused"] == k3,
          f"cli predict launches {pred_n}")
    # the label files that `obb predict save_txt=True save_conf=True` wrote, read back and held
    # to the facade's boxes: the class, the conf and the four corners, computed here from
    # xywhr (reference ops.py:572 xywhr2xyxyxyxy) and normalized by the frame's size
    got = YOLO(str(best)).predict(str(src), imgsz=IMGSZ, conf=VAL_CONF)
    check(len(got) == n_images, f"the facade predicted {len(got)} of {n_images} images")
    worst = 0.0
    for i, r in enumerate(got):
        rows = np.array((pred / "labels" / f"im{i}.txt").read_text().split(), np.float64).reshape(-1, 10)
        check(len(rows) == len(r), f"im{i}.txt holds {len(rows)} boxes, the facade keeps {len(r)}")
        if not len(r):
            continue
        x, y, w, h, t, conf, c = r.boxes.astype(np.float64).T
        ctr = np.stack([x, y], -1)
        v1 = np.stack([w / 2 * np.cos(t), w / 2 * np.sin(t)], -1)
        v2 = np.stack([-h / 2 * np.sin(t), h / 2 * np.cos(t)], -1)
        corners = np.stack([ctr + v1 + v2, ctr + v1 - v2, ctr - v1 - v2, ctr - v1 + v2], 1)
        corners = (corners / [r.orig_shape[1], r.orig_shape[0]]).reshape(-1, 8)
        check((rows[:, 0] == c).all(), f"im{i}.txt: classes differ from the facade's")
        saved, facade = rows[:, 1:], np.concatenate([corners, conf[:, None]], 1)
        worst = max(worst, float((np.abs(saved - facade) / np.maximum(1.0, np.abs(facade))).max()))
    check(worst <= LABEL_TOL, f"the saved labels are {worst:.3e} off the facade's boxes")
    check([r.verbose() for r in got] == [ln.split(" ", 3)[3] for ln in lines],
          "the CLI's per-image lines differ from the facade's predictions")
    _reset_counts()
    fused = YOLO(str(best), dtype=torch.bfloat16, fused_1x1=True)
    n_fused = len(fused.predict(str(src), imgsz=IMGSZ, conf=VAL_CONF))
    torch.cuda.synchronize()
    fused_n = _counts()
    check(n_fused == n_images and fused_n == {"qattn_fwd": 1, "qattn_fwd_with_stats": 0, "qattn_bwd": 0,
                                              "qconv1x1_fused": 37}, f"facade fused_1x1 launches {fused_n}")
    print(f"cli: the saved labels of {n_images} images ({sum(len(r) for r in got)} boxes) within {worst:.2e} "
          f"of the facade's boxes; YOLO(dtype=bf16, fused_1x1=True).predict launches {fused_n}")
    launches = {k: train_n[k] + val_n[k] + pred_n[k] for k in train_n}
    return {"train_s": train_s, "epoch_s": epoch_s, "val_s": val_s, "predict_s": pred_s,
            "val_metrics": metrics, "history": history, "launches_train": train_n, "launches_val": val_n,
            "launches_predict": pred_n, "launches": launches, "launches_facade_fused": fused_n,
            "labels_vs_facade": worst}


# ---------------------------------------------------------------- phases 12-16: the detect task


DET_MODEL, DET_IMGSZ, DET_NC = "yolo11n-quan.yaml", 640, 80
# COCO's common frame sizes (h, w): 640 x 480, 480 x 640, 640 x 427 and 500 x 375 (w x h), 4 of each
DET_SIZES = [(480, 640), (640, 480), (427, 640), (375, 500)] * 4
# rectangles an image; COCO val2017 holds 7.3 objects an image on average (Lin et al., ECCV 2014)
DET_BOXES = (2, 40)
DET_PREDICT_CONF, DET_PREDICT_IOU = 0.25, 0.45  # the Predictor's defaults
# an image of 8 whose kept count differs from the plain path's and that NMS on the kernel's
# boxes with the plain run's scores does not explain (the order of near-equal scores)
DET_UNEXPLAINED = 1
# f32 validation, kernel vs plain, held by boxes: the share of the rows NMS keeps of the whole
# candidate pool (no max_det cut, whose 300th place near-equal scores decide) (xyxy, conf, cls
# in letterbox pixels) of either run within DET_ROW_TOL of max(1, |value|) of a row of the
# other (greedy NMS may keep the other of two overlapping boxes whose scores are an ulp apart)
DET_ROW_TOL, DET_ROW_SHARE = 1e-3, 0.99


def phase_detect_data(root: Path, seed: int = 1):
    """A COCO-layout set written with the port's PNG writer: 16 images of COCO's
    four common frame sizes, 2-40 filled axis-aligned rectangles each over the
    80 classes, 'cls xc yc w h' labels; every PNG decodes exactly."""
    from quan_ultralytics_tpu_torch.cfg.datasets import COCO
    from quan_ultralytics_tpu_torch.data.native import native

    rng = np.random.default_rng(seed)
    for d in ("images", "labels"):
        (root / d / "val2017").mkdir(parents=True)
    n_boxes = 0
    t0 = time.perf_counter()
    for i, (h, w) in enumerate(DET_SIZES):
        yy, xx = np.mgrid[0:h, 0:w]
        im = np.stack([xx * 160 // w, yy * 160 // h, (xx + yy) * 160 // (h + w)], -1).astype(np.uint8)
        im = np.clip(im + rng.integers(0, 24, im.shape), 0, 255).astype(np.uint8)
        lines = []
        for _ in range(int(rng.integers(DET_BOXES[0], DET_BOXES[1] + 1))):
            bw, bh = rng.uniform(12, min(h, w) / 3, 2)
            x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            im[int(y0):int(y0 + bh), int(x0):int(x0 + bw)] = rng.integers(170, 256, 3)
            lines.append(f"{rng.integers(0, DET_NC)} {(x0 + bw / 2) / w:.6f} {(y0 + bh / 2) / h:.6f} "
                         f"{bw / w:.6f} {bh / h:.6f}")
        path = root / "images" / "val2017" / f"{i:012d}.png"
        native.imwrite_png(path, im)
        check(np.array_equal(native.imread(path), im), f"{path.name} does not decode to the pixels written")
        (root / "labels" / "val2017" / f"{i:012d}.txt").write_text("\n".join(lines) + "\n")
        n_boxes += len(lines)
    secs = time.perf_counter() - t0
    cfg = {"path": str(root), "train": "images/val2017", "val": "images/val2017", "names": COCO["names"]}
    print(f"detect data: {len(DET_SIZES)} COCO-layout PNG images ({n_boxes} boxes over {DET_NC} classes) "
          f"written in {secs:.1f} s and decoded exactly")
    return cfg, {"images": len(DET_SIZES), "boxes": n_boxes, "write_s": secs}


def _unexplained_counts(kernel: torch.Tensor, ref: torch.Tensor, n: int, **kw):
    """Images (of the first ``n``) whose count of kept detections differs between
    the kernel's and the plain run's decoded predictions and is not the count
    NMS keeps of the kernel's boxes with the plain run's scores (greedy NMS
    keeps the higher of two overlapping near-equal boxes)."""
    swapped = kernel.clone()
    swapped[..., 4:] = ref[..., 4:]
    got, mixed, want = (kept_counts(p, **kw) for p in (kernel, swapped, ref))
    return [i for i in range(n) if got[i] != want[i] and mixed[i] != want[i]]


def _matched_rows(kernel: torch.Tensor, ref: torch.Tensor, n: int, nc: int = DET_NC):
    """(rows matched, rows) of the detections NMS keeps of the first ``n`` images of
    two runs' decoded predictions at validation's conf and IoU, with no max_det cut:
    a row (xyxy, conf, cls) of either run is matched when it lies within DET_ROW_TOL
    of a row of the other."""
    from quan_ultralytics_tpu_torch.ops.boxes import non_max_suppression

    runs = [non_max_suppression(p, conf_thres=VAL_CONF, iou_thres=0.7, max_det=NMS_POOL, nc=nc)
            for p in (kernel, ref)]
    matched = total = 0
    for i in range(n):
        a, b = (det[i][ok[i]] for det, ok in runs)
        if not (len(a) and len(b)):
            total += len(a) + len(b)
            continue
        d = ((a[:, None] - b[None]).abs() / b.abs().clamp(min=1.0)[None]).amax(-1)
        matched += int((d.amin(1) <= DET_ROW_TOL).sum()) + int((d.amin(0) <= DET_ROW_TOL).sum())
        total += len(a) + len(b)
    return matched, total


def phase_detect_predict(cfg, tables=None, rounds: int = 5):
    """QUAN-YOLO11n (nc=80, seeded bf16 weights) predicts 8 of the set's frames at
    640 through the Predictor on the K1, K1+K3 and plain paths, each run's launches
    counted from 0. Each kernel path against the plain one: decoded predictions
    within PRED_TOL, and the kept counts at the Predictor's conf, or a count that NMS
    on the kernel's boxes with the plain run's scores keeps. Then ``infer`` ms of each
    path in interleaved rounds (host clock, synchronized) and its device busy ms."""
    from quan_ultralytics_tpu_torch.data.augment import letterbox
    from quan_ultralytics_tpu_torch.data.native import native
    from quan_ultralytics_tpu_torch.engine.predictor import Predictor
    from quan_ultralytics_tpu_torch.models.tasks import fused_1x1_sites
    from quan_ultralytics_tpu_torch.ops.kernels import qattn, qconv_fused

    models = build_models(DET_MODEL, DET_NC)
    n_sites = len(fused_1x1_sites(models["K1+K3"], BATCH, DET_IMGSZ))  # the head's cv3 1x1s included
    files = sorted((Path(cfg["path"]) / cfg["val"]).glob("*.png"))[:BATCH]
    frames = [native.imread(f) for f in files]
    names = list(cfg["names"].values())
    preds = {name: Predictor(m, imgsz=DET_IMGSZ, conf=DET_PREDICT_CONF, iou=DET_PREDICT_IOU, names=names)
             for name, m in models.items()}
    expect = {"K1": (1, 0), "K1+K3": (1, n_sites), "plain": (0, 0)}
    out = {"launches": {}, "detections": {}, "fused_1x1_sites": n_sites}
    for name, pred in preds.items():
        _reset_counts()
        res = pred(frames)  # the detect predict path, driven once
        torch.cuda.synchronize()
        got, counts = (qattn.launches_mma, qconv_fused.launches_mma), _counts()
        out["launches"][name], out["detections"][name] = counts, [len(r) for r in res]
        print(f"detect predict [{name}]: launches {counts}, K1 and K3 on the tensor cores {got} (expected "
              f"{expect[name]}: {n_sites} fused 1x1 sites); kept a frame {out['detections'][name]}")
        check(got == expect[name] and counts == {"qattn_fwd": got[0], "qattn_fwd_with_stats": 0, "qattn_bwd": 0,
                                                 "qconv1x1_fused": got[1]},
              f"detect predict [{name}]: launches {counts}, {got} != {expect[name]}")
        check(len(res) == len(frames), f"detect predict [{name}]: {len(res)} Results")
        for r, f in zip(res, frames):
            b = r.boxes
            check(b.shape[1] == 6 and np.isfinite(b).all() and (b[:, :4] >= 0).all()
                  and (b[:, [0, 2]] <= f.shape[1]).all() and (b[:, [1, 3]] <= f.shape[0]).all(),
                  f"detect predict [{name}]: boxes outside the frame or not finite")
    x = torch.stack([letterbox(torch.from_numpy(f).to(DEVICE), DET_IMGSZ)[0] for f in frames])
    ref = decoded(models["plain"], x)
    agree = {}
    for name in ("K1", "K1+K3"):
        kd = decoded(models[name], x)
        rel = compare_preds(kd, ref, DET_NC)
        unexplained = _unexplained_counts(kd, ref, len(frames), nc=DET_NC, rotated=False,
                                          conf=DET_PREDICT_CONF, iou=DET_PREDICT_IOU)
        agree[name] = {"decoded_rel_err": rel, "count_differs_unexplained": unexplained}
        print(f"detect predict [{name} vs plain, bf16]: decoded max abs err / max|ref| {rel}; kept counts "
              f"differ unexplained on frames {unexplained}")
        check(all(v <= PRED_TOL[torch.bfloat16] for v in rel.values()),
              f"detect predict [{name}]: decoded predictions disagree with the plain path: {rel}")
        check(len(unexplained) <= DET_UNEXPLAINED,
              f"detect predict [{name}]: kept counts differ from the plain path's on frames {unexplained}")
    for pred in preds.values():  # warm up
        pred.infer(x)
    torch.cuda.synchronize()
    order, times = list(preds), {name: [] for name in preds}
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            for _ in range(3):
                preds[name].infer(x)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0) / 3)
    speed = {f"detect {n}": {"infer_ms": statistics.median(t), "infer_ms_rounds": t,
                             "infer_img_s": BATCH * 1e3 / statistics.median(t)} for n, t in times.items()}
    for name, row in speed.items():
        print(f"speed [{name}]: infer {row['infer_ms']:.2f} ms a batch of {BATCH} at {DET_IMGSZ} "
              f"({row['infer_img_s']:.1f} img/s); median of {rounds} rounds "
              f"{[round(v, 2) for v in row['infer_ms_rounds']]}")
    share = phase_device_share({f"detect {n}": m for n, m in models.items()}, x, speed, tables)
    out.update({"agree": agree, "speed": speed, "device": share})
    del models, preds
    torch.cuda.empty_cache()
    return out


def phase_detect_train(cfg):
    """16 micro-steps of the detect train step (bf16, K1 + K2; default TrainConfig at
    batch 8: accumulate 8) at 640 on the set's first batch through the loader
    (TRAIN_M rows an image, as the JAX loader pads); ms a micro-step on the host clock
    (each step ends in its NaN guard's sync); then one f32 micro-step with fused and
    with plain attention, held as `phase_train_grads` holds the OBB one."""
    from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
    from quan_ultralytics_tpu_torch.ops.kernels import qattn

    host = next(build_dataloader(YOLODataset(cfg, "train"), BATCH, DET_IMGSZ, hyp=None, max_labels=TRAIN_M,
                                 augment=False, shuffle=False))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
    trainer = make_trainer(torch.bfloat16, model=DET_MODEL, nc=DET_NC)
    losses, times, skipped = [], [], []
    _reset_counts()
    for _ in range(TRAIN_STEPS):  # the detect train path, driven
        t0 = time.perf_counter()
        loss, aux = trainer.step(batch)
        losses.append(float(loss))
        times.append(1e3 * (time.perf_counter() - t0))
        skipped.append(float(aux["nan_skipped"]))
    torch.cuda.synchronize()
    got = {**_counts(), "qattn_fwd_tensor_cores": qattn.launches_mma}
    ms = statistics.median(times[1:])
    print(f"detect train: {TRAIN_STEPS} micro-steps at {DET_IMGSZ}, {int(batch['mask'].sum())} boxes in the "
          f"batch; losses {[round(x, 3) for x in losses]}; {ms:.1f} ms a micro-step (median after the first, "
          f"{BATCH * 1e3 / ms:.1f} img/s); launches {got}")
    check(all(math.isfinite(x) for x in losses) and not any(skipped), f"detect train losses {losses}")
    check(got == {"qattn_fwd": TRAIN_STEPS, "qattn_fwd_with_stats": TRAIN_STEPS, "qattn_bwd": TRAIN_STEPS,
                  "qconv1x1_fused": 0, "qattn_fwd_tensor_cores": TRAIN_STEPS}, f"detect train launches {got}")
    check(trainer.opt.count == TRAIN_STEPS // trainer.accumulate, f"detect train: {trainer.opt.count} updates")
    del trainer
    grads = phase_train_grads(batch, DET_MODEL, DET_NC, tag="detect train")
    torch.cuda.empty_cache()
    return {"losses": losses, "launches": got, "ms_per_micro_step": ms, "ms_steps": times,
            "img_s": BATCH * 1e3 / ms, "grads_f32": grads}


def phase_detect_fit(cfg, run_dir: Path):
    """Trainer.fit of the detect model for FIT_EPOCHS epochs at 640, bf16, batch 8
    (nbs 8) from seeded weights, with the COCO recipe's augmentations
    (``cfg/recipes/coco_detect.yaml`` over the defaults: mosaic 1.0, mixup 0,
    fliplr 0.5, scale 0.5, translate 0.1, HSV) until close_mosaic (1 here),
    validating the EMA weights each epoch; returns the EMA weights' state."""
    import dataclasses

    import quan_ultralytics_tpu_torch.cfg as cfg_mod
    from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
    from quan_ultralytics_tpu_torch.data.augment import AugmentHyp
    from quan_ultralytics_tpu_torch.engine.trainer import TrainConfig, Trainer
    from quan_ultralytics_tpu_torch.engine.validator import Validator

    recipe = cfg_mod.get_cfg(cfg=Path(cfg_mod.__file__).parent / "recipes" / "coco_detect.yaml")
    hyp = AugmentHyp(**{f.name: getattr(recipe, f.name) for f in dataclasses.fields(AugmentHyp)})
    check(recipe.task == "detect" and hyp.mosaic == 1.0, f"the COCO recipe: {recipe.task}, {hyp}")
    tds, vds = YOLODataset(cfg, "train"), YOLODataset(cfg, "val")
    steps = len(tds) // BATCH
    tr = Trainer(seeded_model(torch.bfloat16, model=DET_MODEL, nc=DET_NC),
                 TrainConfig(batch=BATCH, nbs=BATCH, epochs=FIT_EPOCHS), steps_per_epoch=steps, device=DEVICE)
    labels = {}

    def loader(epoch):
        for batch in build_dataloader(tds, BATCH, DET_IMGSZ, hyp=hyp if hyp.mosaic else None, augment=True,
                                      seed=epoch):
            labels[epoch] = labels.get(epoch, 0) + int(batch["mask"].sum())
            yield batch

    def close_mosaic_hook(epoch):
        hyp.mosaic = 0.0

    val_times = []

    def validate(trainer):
        val = Validator(trainer.model, imgsz=DET_IMGSZ, conf=VAL_CONF)
        with trainer.ema_weights():
            metrics = val(vds, batch_size=BATCH)
        val_times.append(val.speed)
        return metrics

    ema0 = torch.cat([e.reshape(-1) for e in tr.ema]).clone()
    _reset_counts()
    t0 = time.perf_counter()
    history = tr.fit(loader, validate, epochs=FIT_EPOCHS, save_dir=run_dir, close_mosaic_hook=close_mosaic_hook,
                     close_mosaic=FIT_CLOSE_MOSAIC, log=lambda line: print("detect fit:", line))  # driven
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = _counts()
    ema_moved = float((torch.cat([e.reshape(-1) for e in tr.ema]) - ema0).abs().max())
    n_micro, n_val = FIT_EPOCHS * steps, FIT_EPOCHS * math.ceil(len(vds) / BATCH)
    print(f"detect fit: {FIT_EPOCHS} epochs of {steps} micro-steps in {secs:.1f} s (validation included), "
          f"labels an epoch {labels}; launches {got}; EMA moved by up to {ema_moved:.3e}")
    check(len(history) == FIT_EPOCHS and all(math.isfinite(r["loss"]) for r in history),
          f"detect fit history {history}")
    check(all(0 <= r[k] <= 1 for r in history for k in ("mAP50", "mAP50-95", "precision", "recall")),
          "detect fit: a metric outside [0, 1]")
    check(ema_moved > 0 and hyp.mosaic == 0.0 and all(labels.get(e, 0) > 0 for e in range(FIT_EPOCHS)),
          "detect fit: the EMA did not move, close_mosaic did not close, or an epoch had no labels")
    check(got == {"qattn_fwd": n_micro + n_val, "qattn_fwd_with_stats": n_micro, "qattn_bwd": n_micro,
                  "qconv1x1_fused": 0}, f"detect fit launches {got}")
    check((run_dir / "last.ckpt").exists() and (run_dir / "best.ckpt").exists(), "detect fit wrote no checkpoints")
    with tr.ema_weights():
        weights = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    del tr
    torch.cuda.empty_cache()
    return weights, {"seconds": secs, "epoch_s": [r["time_s"] for r in history], "history": history,
                     "launches": got, "ema_moved": ema_moved, "val_speed": val_times}


def phase_detect_val(cfg, weights, out_dir: Path, n_sites: int):
    """The Validator at 640, conf 0.001, on the detect fit's EMA weights, with rect
    off and on: bf16 with K1, with K1 and K3 and plain, f32 with K1 and plain, each
    run's launches counted from 0 and the N that K1 saw recorded. Each kernel run
    against the plain run of its dtype and rect: decoded predictions of every batch
    within PRED_TOL, every metric within VAL_METRIC_TOL, and in f32 the kept counts
    per image explained as in `phase_val` and the kept rows matched (DET_ROW_SHARE)."""
    from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
    from quan_ultralytics_tpu_torch.engine.validator import Validator
    from quan_ultralytics_tpu_torch.models.block import QAttention
    from quan_ultralytics_tpu_torch.models.tasks import DetectionModel
    from quan_ultralytics_tpu_torch.ops.kernels import qattn, qconv_fused

    ds = YOLODataset(cfg, "val")
    nb = math.ceil(len(ds) / BATCH)
    bf16, f32 = torch.bfloat16, torch.float32
    paths = {"bf16 K1": (bf16, {}), "bf16 K1+K3": (bf16, {"fused_1x1": True}),
             "bf16 plain": (bf16, {"fused_attn": False}),
             "f32 K1": (f32, {}), "f32 plain": (f32, {"fused_attn": False})}
    expect = {"bf16 K1": (nb, 0, 0), "bf16 K1+K3": (nb, 0, n_sites * nb),
              "bf16 plain": (0, 0, 0), "f32 K1": (0, nb, 0), "f32 plain": (0, 0, 0)}
    seen_n = []
    models = {}
    shapes = {(DET_IMGSZ, DET_IMGSZ)} | {b["img"].shape[1:3] for b in build_dataloader(
        ds, BATCH, DET_IMGSZ, hyp=None, augment=False, shuffle=False, drop_last=False, rect=True)}
    for name, (dtype, kw) in paths.items():
        m = DetectionModel.from_yaml(DET_MODEL, nc=DET_NC, dtype=dtype, device=DEVICE, **{"fused_1x1": False, **kw})
        m.load_state_dict(weights)
        for mod in m.modules():
            if isinstance(mod, QAttention):
                mod.register_forward_pre_hook(lambda _m, a: seen_n.append(a[0].shape[1] * a[0].shape[2]))
        models[name] = m
        for h, w in shapes:  # warm up at every batch shape: cuDNN picks its algorithms, the kernels load
            Validator(m, imgsz=DET_IMGSZ, conf=VAL_CONF).infer(
                torch.zeros(BATCH, h, w, 3, dtype=torch.uint8, device=DEVICE))
    torch.cuda.synchronize()
    res, agree, n_seen = {}, {}, {}
    for rect in (False, True):
        for name, m in models.items():
            key = f"{name}{' rect' if rect else ''}"
            val = Validator(m, imgsz=DET_IMGSZ, conf=VAL_CONF)
            js = out_dir / f"{key.replace(' ', '_').replace('+', '_')}.json"
            js.parent.mkdir(parents=True, exist_ok=True)
            seen_n.clear()
            _reset_counts()
            metrics = val(ds, batch_size=BATCH, save_json=str(js), rect=rect)  # the detect val path
            torch.cuda.synchronize()
            got, counts = (qattn.launches_mma, qattn.launches_simt, qconv_fused.launches_mma), _counts()
            n_seen[key] = sorted(set(seen_n))
            per_image = {Path(s.im_file).stem: 0 for s in ds.samples}
            for d in json.loads(js.read_text()):
                per_image[d["image_id"]] += 1
            res[key] = {"metrics": metrics, "speed": val.speed, "detections": per_image,
                        "launches": counts, "attention_n": n_seen[key]}
            print(f"detect val [{key}]: launches {counts}, K1 tensor / CUDA cores, K3 {got} (expected "
                  f"{expect[name]}); K1 saw N = {n_seen[key]}; {metrics}; {val.speed['img_s']:.1f} img/s, a batch: "
                  f"load {val.speed['load_ms']:.1f} ms, infer {val.speed['infer_ms']:.1f} ms, match "
                  f"{val.speed['match_ms']:.1f} ms; detections an image {list(per_image.values())}")
            check(got == expect[name] and counts["qattn_fwd"] == sum(got[:2]) and counts["qattn_bwd"] == 0
                  and counts["qattn_fwd_with_stats"] == 0 and counts["qconv1x1_fused"] == got[2],
                  f"detect val [{key}]: launches {counts}, {got} != {expect[name]}")
            check(all(math.isfinite(v) and 0 <= v <= 1 for v in metrics.values()),
                  f"detect val [{key}]: metrics {metrics}")
        batches = list(build_dataloader(ds, BATCH, DET_IMGSZ, hyp=None, augment=False, shuffle=False,
                                        drop_last=False, rect=rect, with_meta=True))
        xs = [torch.from_numpy(batch["img"]).to(DEVICE) for batch in batches]
        stems = [[Path(f).stem for f in batch["im_files"][:batch["n_real"]]] for batch in batches]
        shapes = [tuple(x.shape[1:3]) for x in xs]
        check(rect == any(h != w for h, w in shapes), f"detect val: rect={rect}, batch shapes {shapes}")
        sfx = " rect" if rect else ""
        for name, ref in (("bf16 K1", "bf16 plain"), ("bf16 K1+K3", "bf16 plain"), ("f32 K1", "f32 plain")):
            a, b = res[name + sfx], res[ref + sfx]
            pairs = [(decoded(models[name], x), decoded(models[ref], x)) for x in xs]
            rel = [compare_preds(k, p, DET_NC) for k, p in pairs]
            rel = {g: max(r[g] for r in rel) for g in rel[0]}
            same = sum(a["detections"][k] == b["detections"][k] for k in a["detections"])
            diff = {k: abs(a["metrics"][k] - b["metrics"][k]) for k in a["metrics"]}
            row = {"decoded_rel_err": rel, "same_count_images": same, "metric_diff": diff, "batch_shapes": shapes}
            dtype = paths[name][0]
            check(all(v <= PRED_TOL[dtype] for v in rel.values()),
                  f"detect val, {name}{sfx}: decoded predictions disagree with {ref}: {rel}")
            check(all(v <= VAL_METRIC_TOL for v in diff.values()),
                  f"detect val, {name}{sfx} vs {ref}: metrics differ by {diff}")
            if dtype == f32:  # in bf16 NMS's pool is cut inside a block of tied scores
                unexplained = [stems[bi][i] for bi, (k, p) in enumerate(pairs)
                               for i in _unexplained_counts(k, p, len(stems[bi]), nc=DET_NC, rotated=False)]
                matched = [_matched_rows(k, p, len(stems[bi])) for bi, (k, p) in enumerate(pairs)]
                share = sum(m for m, _ in matched) / max(sum(t for _, t in matched), 1)
                row.update(count_differs_unexplained=unexplained, rows_matched_share=share)
                print(f"detect val, {name}{sfx} vs {ref}{sfx}: {share:.5f} of the kept rows within "
                      f"{DET_ROW_TOL} of a row of the other run; counts differ unexplained on {unexplained}")
                check(len(unexplained) <= 1, f"detect val, {name}{sfx} vs {ref}: detection counts differ on "
                      f"{unexplained}, not explained by the order of near-equal scores")
                check(share >= DET_ROW_SHARE, f"detect val, {name}{sfx} vs {ref}: {share:.4f} of the kept rows "
                      f"match, below {DET_ROW_SHARE}")
            agree[f"{name}{sfx} vs {ref}{sfx}"] = row
            print(f"detect val, {name}{sfx} vs {ref}{sfx}: decoded max abs err / max|ref| {rel}; the same "
                  f"detection count on {same} of {len(ds)} images; metric differences {diff}")
    square = [(DET_IMGSZ // 32) ** 2]  # 400 at 640
    check(all(n == square for k, n in n_seen.items() if "K1" in k and "rect" not in k),
          f"detect val: K1 saw N = {n_seen} without rect")
    check(any(n != square for k, n in n_seen.items() if "rect" in k), f"detect val: rect left N = {n_seen}")
    del models
    torch.cuda.empty_cache()
    return {"paths": res, "agree": agree, "launches": res["bf16 K1+K3"]["launches"],
            "launches_rect": res["bf16 K1+K3 rect"]["launches"], "attention_n": n_seen}


def phase_detect_cli(cfg, root: Path, n_sites: int):
    """``python -m quan_ultralytics_tpu_torch.cli detect ...`` in this process on the
    detect set (after `phase_cli`, whose settings file turns the logger clients off):
    ``detect train`` from a facade checkpoint of seeded weights (2 epochs at 640,
    batch 8, nbs 8, close_mosaic 1; bf16 steps, f32 validation), ``detect val rect=True``
    and ``detect predict save_txt=True`` (f32) of its best.pkl; the saved label lines
    held to the facade's boxes, and the facade's bf16 ``fused_1x1`` predict (K3)."""
    import pickle

    from quan_ultralytics_tpu_torch.engine.model import YOLO
    from quan_ultralytics_tpu_torch.utils.weights import export_jax_variables

    start = root / "detect_seeded.pkl"
    tree = export_jax_variables(seeded_model(None, model=DET_MODEL, nc=DET_NC))
    start.write_bytes(pickle.dumps({"model_yaml": DET_MODEL, "nc": DET_NC, "names": list(cfg["names"].values()),
                                    **tree, "raw_params": tree["params"], "step": 0}))
    data = write_data_yaml(cfg, root / "coco.yaml")
    run, pred = root / "detect_run_cli", root / "detect_predict"
    src = Path(cfg["path"]) / cfg["val"]
    n_images = len(DET_SIZES)
    steps, n_val = n_images // BATCH, math.ceil(n_images / BATCH)
    text, train_s, train_n = _cli(["detect", "train", f"model={start}", f"data={data}", f"epochs={FIT_EPOCHS}",
                                   f"batch={BATCH}", f"imgsz={DET_IMGSZ}", f"close_mosaic={FIT_CLOSE_MOSAIC}",
                                   f"nbs={BATCH}", f"save_dir={run}"])
    epoch_s = [float(ln.split("time_s=")[1].split()[0]) for ln in text.splitlines() if ln.startswith("epoch ")]
    check(len(epoch_s) == FIT_EPOCHS and (run / "best.pkl").exists() and (run / "results.csv").exists(),
          f"cli detect train: {len(epoch_s)} epoch lines")
    n_micro, k3 = FIT_EPOCHS * steps, default_k3_sites(DET_MODEL, DET_NC)
    check(train_n == {"qattn_fwd": n_micro + FIT_EPOCHS * n_val, "qattn_fwd_with_stats": n_micro,
                      "qattn_bwd": n_micro, "qconv1x1_fused": k3 * FIT_EPOCHS * n_val,
                      "qattn_fwd_tensor_cores": n_micro, "qattn_fwd_cuda_cores": FIT_EPOCHS * n_val},
          f"cli detect train launches {train_n}")
    best = run / "best.pkl"
    text, val_s, val_n = _cli(["detect", "val", f"model={best}", f"data={data}", f"imgsz={DET_IMGSZ}",
                               f"batch={BATCH}", f"conf={VAL_CONF}", "rect=True"])
    metrics = ast.literal_eval(text.strip().splitlines()[-1])
    check(all(0 <= metrics[k] <= 1 for k in ("mAP50", "mAP50-95", "precision", "recall")),
          f"cli detect val metrics {metrics}")
    check(val_n["qattn_fwd"] == val_n["qattn_fwd_cuda_cores"] == n_val and val_n["qattn_bwd"] == 0
          and val_n["qconv1x1_fused"] == k3 * n_val, f"cli detect val launches {val_n}")
    text, pred_s, pred_n = _cli(["detect", "predict", f"model={best}", f"source={src}", f"imgsz={DET_IMGSZ}",
                                 f"conf={VAL_CONF}", "save_txt=True", "save_conf=True", f"save_dir={pred}"])
    lines = [ln for ln in text.splitlines() if ln.startswith("image ")]
    check(len(lines) == n_images and pred_n["qattn_fwd"] == pred_n["qattn_fwd_cuda_cores"] == 1
          and pred_n["qconv1x1_fused"] == k3, f"cli detect predict: {len(lines)} image lines, launches {pred_n}")
    # the saved 'cls xc yc w h conf' lines, read back and held to the facade's xyxy boxes
    got = YOLO(str(best)).predict(str(src), imgsz=DET_IMGSZ, conf=VAL_CONF)
    worst, n_boxes = 0.0, 0
    for i, r in enumerate(got):
        rows = np.array((pred / "labels" / f"im{i}.txt").read_text().split(), np.float64).reshape(-1, 6)
        check(len(rows) == len(r), f"im{i}.txt holds {len(rows)} boxes, the facade keeps {len(r)}")
        if not len(r):
            continue
        h, w = r.orig_shape
        x1, y1, x2, y2, conf, c = r.boxes.astype(np.float64).T
        want = np.stack([(x1 + x2) / 2 / w, (y1 + y2) / 2 / h, (x2 - x1) / w, (y2 - y1) / h, conf], 1)
        check((rows[:, 0] == c).all(), f"im{i}.txt: classes differ from the facade's")
        worst = max(worst, float((np.abs(rows[:, 1:] - want) / np.maximum(1.0, np.abs(want))).max()))
        n_boxes += len(r)
    check(worst <= LABEL_TOL, f"the saved detect labels are {worst:.3e} off the facade's boxes")
    check([r.verbose() for r in got] == [ln.split(" ", 3)[3] for ln in lines],
          "the CLI's per-image lines differ from the facade's detect predictions")
    _reset_counts()
    n_fused = len(YOLO(str(best), dtype=torch.bfloat16, fused_1x1=True).predict(str(src), imgsz=DET_IMGSZ,
                                                                                conf=VAL_CONF))
    torch.cuda.synchronize()
    fused_n = _counts()
    check(n_fused == n_images and fused_n == {"qattn_fwd": 1, "qattn_fwd_with_stats": 0, "qattn_bwd": 0,
                                              "qconv1x1_fused": n_sites},
          f"detect facade fused_1x1 launches {fused_n}")
    print(f"cli detect: the saved labels of {n_images} images ({n_boxes} boxes) within {worst:.2e} of the "
          f"facade's boxes; YOLO(dtype=bf16, fused_1x1=True).predict launches {fused_n}")
    return {"train_s": train_s, "epoch_s": epoch_s, "val_s": val_s, "predict_s": pred_s, "val_metrics": metrics,
            "launches_train": train_n, "launches_val": val_n, "launches_predict": pred_n,
            "launches": {k: train_n[k] + val_n[k] + pred_n[k] for k in train_n},
            "launches_facade_fused": fused_n, "labels_vs_facade": worst}


# ---------------------------------------------------------------- phases 17-22: segment and pose at 640

# task -> (model, nc): QUAN-YOLO11n-seg on COCO's 80 classes, QUAN-YOLO11n-pose on its one (person)
SEGPOSE = {"segment": ("yolo11n-seg-quan.yaml", 80), "pose": ("yolo11n-pose-quan.yaml", 1)}
SEG_POLYGONS = (2, 40)  # filled polygons an image, as DET_BOXES
POSE_FIGURES = (1, 10)  # figures of 17 keypoints an image
TAIL = {"segment": "mc", "pose": "kpts"}  # the columns after the scores, in compare_preds
# f32 Predictor, kernel vs plain path: of each matched detection, the mask pixels that may differ
# (a logit at the 0.5 threshold may round either way) and the keypoint distance in pixels
MASK_SHARE, KPT_TOL = 1e-3, RESULT_TOL


def phase_segpose_data(root: Path, task: str, seed: int):
    """A COCO-layout set for the segment or pose task, written with the port's PNG
    writer: 16 images of DET_SIZES; segment: 2-40 filled polygons (stars of 6-24
    points) over the 80 classes, labelled as polygons; pose: 1-10 figures of 17
    keypoints each (a filled body box, a dot a visible point), visibility 0, 1 or 2
    (1 in 5, 1 in 5, 3 in 5), labelled 'cls cx cy w h' and 17 x 'x y v'. Every PNG
    decodes exactly."""
    from quan_ultralytics_tpu_torch.cfg.datasets import COCO
    from quan_ultralytics_tpu_torch.data.native import native, pixels

    rng = np.random.default_rng(seed)
    for d in ("images", "labels"):
        (root / d / "val2017").mkdir(parents=True)
    nc, n_obj, n_vis = SEGPOSE[task][1], 0, 0
    t0 = time.perf_counter()
    for i, (h, w) in enumerate(DET_SIZES):
        yy, xx = np.mgrid[0:h, 0:w]
        im = np.stack([xx * 160 // w, yy * 160 // h, (xx + yy) * 160 // (h + w)], -1).astype(np.uint8)
        im = np.clip(im + rng.integers(0, 24, im.shape), 0, 255).astype(np.uint8)
        lines = []
        lo, hi = SEG_POLYGONS if task == "segment" else POSE_FIGURES
        for _ in range(int(rng.integers(lo, hi + 1))):
            if task == "segment":
                r = rng.uniform(8, min(h, w) / 5)
                cx, cy = rng.uniform(r, w - r), rng.uniform(r, h - r)
                t = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(6, 25))))
                pts = np.stack([cx + r * rng.uniform(0.4, 1.0, t.size) * np.cos(t),
                                cy + r * rng.uniform(0.4, 1.0, t.size) * np.sin(t)], 1)
                mask = pixels.fill_polygons(np.zeros((h, w), np.uint8), [pts.astype(np.int32)])
                im[mask > 0] = rng.integers(170, 256, 3)
                vals = (pts / [w, h]).reshape(-1)
            else:
                bw, bh = rng.uniform(24, min(h, w) / 2.5), rng.uniform(48, min(h, w) / 1.5)
                x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                im[int(y0):int(y0 + bh), int(x0):int(x0 + bw)] = rng.integers(170, 256, 3)
                kx, ky = rng.uniform(x0, x0 + bw, 17), rng.uniform(y0, y0 + bh, 17)
                v = rng.choice([0, 1, 2], 17, p=[0.2, 0.2, 0.6])
                for x, y in zip(kx[v > 0].astype(int), ky[v > 0].astype(int)):
                    im[max(y - 2, 0):y + 3, max(x - 2, 0):x + 3] = (255, 40, 40)
                n_vis += int((v > 0).sum())
                vals = [(x0 + bw / 2) / w, (y0 + bh / 2) / h, bw / w, bh / h,
                        *np.stack([kx / w, ky / h, v], 1).reshape(-1)]
            lines.append(" ".join([str(rng.integers(0, nc))] + [f"{x:.6f}" for x in vals]))
        path = root / "images" / "val2017" / f"{i:012d}.png"
        native.imwrite_png(path, im)
        check(np.array_equal(native.imread(path), im), f"{path.name} does not decode to the pixels written")
        (root / "labels" / "val2017" / f"{i:012d}.txt").write_text("\n".join(lines) + "\n")
        n_obj += len(lines)
    secs = time.perf_counter() - t0
    names = COCO["names"] if task == "segment" else {0: "person"}
    cfg = {"path": str(root), "train": "images/val2017", "val": "images/val2017", "names": names}
    what = "polygons" if task == "segment" else f"figures ({n_vis} visible keypoints)"
    print(f"{task} data: {len(DET_SIZES)} PNG images, {n_obj} {what} over {nc} classes, written in {secs:.1f} s "
          f"and decoded exactly")
    return cfg, {"images": len(DET_SIZES), "objects": n_obj, "visible_keypoints": n_vis, "write_s": secs}


def _matched(a: np.ndarray, b: np.ndarray, tol: float):
    """For kept rows ``a`` [n, k] and ``b`` [m, k]: the rows of each within ``tol``
    (max abs) of a row of the other, and each row of ``a``'s nearest row of ``b``."""
    if not (len(a) and len(b)):
        return np.zeros(len(a), bool), np.zeros(len(b), bool), np.zeros(len(a), int)
    d = np.abs(a[:, None] - b[None]).max(-1)
    return d.min(1) <= tol, d.min(0) <= tol, d.argmin(1)


def phase_segpose_predict(cfg, task: str, tables=None, rounds: int = 5):
    """The segment or pose model (seeded bf16 weights) predicts 8 of the set's frames at
    640 through the Predictor on the K1, K1+K3 and plain paths, each run's launches
    counted from 0: masks ``[n, h, w]`` or keypoints ``[n, 17, 3]`` inside the frame.
    Each kernel path against the plain one: decoded predictions (boxes, scores, and
    the mask coefficients or keypoints) and the prototypes within PRED_TOL, kept counts
    as in `phase_detect_predict`. In f32 (TF32 off) the K1+K3 and plain Predictors keep
    the same detections on 2 frames (RESULT_TOL), with each matched detection's mask
    unequal on at most MASK_SHARE of its pixels or its keypoints within KPT_TOL px. Then
    ``infer`` ms in interleaved rounds, the whole Predictor call's ms (masks included),
    and the device busy ms of ``infer``."""
    from quan_ultralytics_tpu_torch.data.augment import letterbox
    from quan_ultralytics_tpu_torch.data.native import native
    from quan_ultralytics_tpu_torch.engine.predictor import Predictor
    from quan_ultralytics_tpu_torch.models.tasks import fused_1x1_sites
    from quan_ultralytics_tpu_torch.ops.kernels import qattn, qconv_fused

    name, nc = SEGPOSE[task]
    models = build_models(name, nc)
    n_sites = len(fused_1x1_sites(models["K1+K3"], BATCH, DET_IMGSZ))
    check(n_sites == 37, f"{task}: {n_sites} fused 1x1 sites, not 37 (Proto and cv4 hold only 3x3 convs)")
    files = sorted((Path(cfg["path"]) / cfg["val"]).glob("*.png"))[:BATCH]
    frames = [native.imread(f) for f in files]
    preds = {p: Predictor(m, imgsz=DET_IMGSZ, conf=DET_PREDICT_CONF, iou=DET_PREDICT_IOU) for p, m in models.items()}
    expect = {"K1": (1, 0), "K1+K3": (1, n_sites), "plain": (0, 0)}
    out = {"launches": {}, "detections": {}, "fused_1x1_sites": n_sites}
    for p, pred in preds.items():
        _reset_counts()
        res = pred(frames)  # the segment or pose predict path, driven once
        torch.cuda.synchronize()
        got, counts = (qattn.launches_mma, qconv_fused.launches_mma), _counts()
        out["launches"][p], out["detections"][p] = counts, [len(r) for r in res]
        print(f"{task} predict [{p}]: launches {counts}, K1 and K3 on the tensor cores {got} (expected "
              f"{expect[p]}); kept a frame {out['detections'][p]}")
        check(got == expect[p] and counts == {"qattn_fwd": got[0], "qattn_fwd_with_stats": 0, "qattn_bwd": 0,
                                              "qconv1x1_fused": got[1]},
              f"{task} predict [{p}]: launches {counts}, {got} != {expect[p]}")
        for r, f in zip(res, frames):
            check(r.boxes.shape[1] == 6 and np.isfinite(r.boxes).all(), f"{task} predict [{p}]: bad boxes")
            if task == "segment":
                check(r.masks is not None and r.masks.shape == (len(r),) + f.shape[:2] and r.masks.dtype == bool,
                      f"{task} predict [{p}]: masks {None if r.masks is None else r.masks.shape}")
            else:
                k = r.keypoints
                check(k is not None and k.shape == (len(r), 17, 3) and np.isfinite(k).all()
                      and (k[..., 0] >= 0).all() and (k[..., 0] <= f.shape[1]).all()
                      and (k[..., 1] >= 0).all() and (k[..., 1] <= f.shape[0]).all()
                      and (k[..., 2] >= 0).all() and (k[..., 2] <= 1).all(),
                      f"{task} predict [{p}]: keypoints outside the frame or not finite")
        check(sum(len(r) for r in res) > 0, f"{task} predict [{p}]: nothing kept")
    x = torch.stack([letterbox(torch.from_numpy(f).to(DEVICE), DET_IMGSZ)[0] for f in frames])
    with torch.inference_mode():
        raw = {p: models[p](x.float() / 255.0) for p in models}
    ref = models["plain"].decode(raw["plain"]).float()
    agree = {}
    for p in ("K1", "K1+K3"):
        kd = models[p].decode(raw[p]).float()
        rel = compare_preds(kd, ref, nc, TAIL[task])
        if task == "segment":
            pr = raw["plain"][2].float()
            rel["proto"] = float((raw[p][2].float() - pr).abs().max()) / float(pr.abs().max())
        unexplained = _unexplained_counts(kd, ref, len(frames), nc=nc, rotated=False, conf=DET_PREDICT_CONF,
                                          iou=DET_PREDICT_IOU)
        agree[p] = {"decoded_rel_err": rel, "count_differs_unexplained": unexplained}
        print(f"{task} predict [{p} vs plain, bf16]: max abs err / max|ref| {rel}; kept counts differ "
              f"unexplained on frames {unexplained}")
        check(all(v <= PRED_TOL[torch.bfloat16] for v in rel.values()),
              f"{task} predict [{p}]: outputs disagree with the plain path: {rel}")
        check(len(unexplained) <= DET_UNEXPLAINED, f"{task} predict [{p}]: kept counts differ on {unexplained}")
    del raw
    # the f32 Predictors, K1+K3 against plain: decoded predictions within PRED_TOL, the same
    # count of kept rows, and the masks and keypoints of the rows within RESULT_TOL of a row of the
    # other run held to the plain run's; the share of such rows is printed, not held: at the seeded
    # weights a flat image region gives many anchors one score, and which of those boxes NMS keeps,
    # and what they suppress in turn, follows the boxes' last bits (the K1 path alone shows it too)
    f32 = {p: Predictor(seeded_model(torch.float32, model=name, nc=nc, **kw), imgsz=DET_IMGSZ, conf=0.05)
           for p, kw in (("K1+K3", dict(fused_1x1=True)), ("plain", dict(fused_attn=False)))}
    rel32 = compare_preds(decoded(f32["K1+K3"].model, x[:2]), decoded(f32["plain"].model, x[:2]), nc, TAIL[task])
    check(all(v <= PRED_TOL[torch.float32] for v in rel32.values()),
          f"{task} predict [K1+K3 vs plain, f32]: decoded predictions disagree: {rel32}")
    kept = [f32[p](frames[:2]) for p in ("K1+K3", "plain")]
    worst_mask = worst_kpt = 0.0
    matched = total = 0
    for ra, rb in zip(*kept):
        check(len(ra) == len(rb) > 0, f"{task} f32 detections differ in number: {len(ra)} vs {len(rb)}")
        near, near_b, match = _matched(ra.boxes, rb.boxes, RESULT_TOL)
        matched, total = matched + int(near.sum() + near_b.sum()), total + len(ra) + len(rb)
        if task == "segment":
            worst_mask = max(worst_mask, float((ra.masks[near] != rb.masks[match[near]]).mean(axis=(1, 2)).max()))
        else:
            worst_kpt = max(worst_kpt, float(np.abs(ra.keypoints[near] - rb.keypoints[match[near]]).max()))
    share = matched / total
    agree["f32"] = {"decoded_rel_err": rel32, "detections": [len(r) for r in kept[0]], "rows_matched_share": share,
                    "worst_mask_share": worst_mask, "worst_kpt_px": worst_kpt}
    print(f"{task} predict [K1+K3 vs plain, f32, 2 frames]: decoded {rel32}; the same counts "
          f"{agree['f32']['detections']}, {share:.5f} of the kept rows within {RESULT_TOL} of a row of the other; "
          + (f"masks unequal on at most {worst_mask:.2e} of a mask's pixels" if task == "segment"
             else f"keypoints within {worst_kpt:.2e} px"))
    check(worst_mask <= MASK_SHARE and worst_kpt <= KPT_TOL, f"{task} f32 masks or keypoints: {agree['f32']}")
    del f32, kept
    for pred in preds.values():  # warm up
        pred.infer(x)
    torch.cuda.synchronize()
    order, times, calls = list(preds), {p: [] for p in preds}, {p: [] for p in preds}
    for r in range(rounds):
        for p in (order if r % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            for _ in range(3):
                preds[p].infer(x)
            torch.cuda.synchronize()
            times[p].append(1e3 * (time.perf_counter() - t0) / 3)
            t0 = time.perf_counter()
            preds[p](frames)
            calls[p].append(1e3 * (time.perf_counter() - t0))
    speed = {f"{task} {p}": {"infer_ms": statistics.median(t), "infer_ms_rounds": t,
                             "infer_img_s": BATCH * 1e3 / statistics.median(t),
                             "predict_ms": statistics.median(calls[p]), "predict_ms_rounds": calls[p]}
             for p, t in times.items()}
    for key, row in speed.items():
        print(f"speed [{key}]: infer {row['infer_ms']:.2f} ms a batch of {BATCH} at {DET_IMGSZ} "
              f"({row['infer_img_s']:.1f} img/s); the whole Predictor call {row['predict_ms']:.1f} ms; median of "
              f"{rounds} rounds {[round(v, 2) for v in row['infer_ms_rounds']]}")
    share = phase_device_share({f"{task} {p}": m for p, m in models.items()}, x, speed, tables)
    out.update({"agree": agree, "speed": speed, "device": share})
    del models, preds
    torch.cuda.empty_cache()
    return out


def phase_segpose_train(cfg, task: str, tables=None):
    """16 micro-steps of the segment or pose train step (bf16, K1 + K2; default
    TrainConfig at batch 8: accumulate 8) at 640 on the set's first batch through the
    loader (TRAIN_M rows an image; segment masks [8, 128, 160, 160] uint8); the
    batch's upload (and, for segment, the same masks' upload as f32, what the JAX
    loader's would move); ms a micro-step on the host clock; torch.profiler over 2
    micro-steps (device busy ms, K1 and K2 device ms at N = 400, the top device ops);
    then one f32 micro-step with fused and with plain attention, held as
    `phase_train_grads` holds the OBB one."""
    from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
    from quan_ultralytics_tpu_torch.ops.kernels import qattn

    name, nc = SEGPOSE[task]
    host = next(build_dataloader(YOLODataset(cfg, "train", task=task), BATCH, DET_IMGSZ, hyp=None,
                                 max_labels=TRAIN_M, augment=False, shuffle=False))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
    torch.cuda.synchronize()
    upload = {"ms": 1e3 * (time.perf_counter() - t0), "bytes": sum(v.nbytes for v in host.values())}
    if task == "segment":
        check(host["masks"].dtype == np.uint8
              and host["masks"].shape == (BATCH, TRAIN_M, DET_IMGSZ // 4, DET_IMGSZ // 4),
              f"segment masks {host['masks'].dtype} {host['masks'].shape}")
        as_f32 = host["masks"].astype(np.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.from_numpy(as_f32).to(DEVICE)
        torch.cuda.synchronize()
        upload.update(masks_bytes=host["masks"].nbytes, masks_f32_bytes=as_f32.nbytes,
                      masks_f32_ms=1e3 * (time.perf_counter() - t0))
        del as_f32
    print(f"{task} train: the batch's upload {upload}")
    trainer = make_trainer(torch.bfloat16, model=name, nc=nc)
    losses, times, skipped = [], [], []
    _reset_counts()
    for _ in range(TRAIN_STEPS):  # the segment or pose train path, driven
        t0 = time.perf_counter()
        loss, aux = trainer.step(batch)
        losses.append(float(loss))
        times.append(1e3 * (time.perf_counter() - t0))
        skipped.append(float(aux["nan_skipped"]))
    torch.cuda.synchronize()
    got = {**_counts(), "qattn_fwd_tensor_cores": qattn.launches_mma}
    ms = statistics.median(times[1:])
    print(f"{task} train: {TRAIN_STEPS} micro-steps at {DET_IMGSZ}, {int(batch['mask'].sum())} objects in the "
          f"batch; losses {[round(x, 3) for x in losses]}; {ms:.1f} ms a micro-step (median after the first, "
          f"{BATCH * 1e3 / ms:.1f} img/s); launches {got}")
    check(all(math.isfinite(x) for x in losses) and not any(skipped), f"{task} train losses {losses}")
    check(got == {"qattn_fwd": TRAIN_STEPS, "qattn_fwd_with_stats": TRAIN_STEPS, "qattn_bwd": TRAIN_STEPS,
                  "qconv1x1_fused": 0, "qattn_fwd_tensor_cores": TRAIN_STEPS}, f"{task} train launches {got}")
    check(trainer.opt.count == TRAIN_STEPS // trainer.accumulate, f"{task} train: {trainer.opt.count} updates")
    prof = _device_profile(lambda: trainer.step(batch), 2, f"{task} train micro-step", tables)
    if prof["device_ms"] is not None:
        prof["busy_share"] = prof["device_ms"] / ms
    print(f"{task} train: device profile of a micro-step {prof}")
    del trainer
    grads = phase_train_grads(batch, name, nc, tag=f"{task} train")
    del batch
    torch.cuda.empty_cache()
    return {"losses": losses, "launches": got, "ms_per_micro_step": ms, "ms_steps": times,
            "img_s": BATCH * 1e3 / ms, "upload": upload, "device": prof, "grads_f32": grads}


def phase_segpose_fit(cfg, task: str, run_dir: Path):
    """Trainer.fit of the segment or pose model for FIT_EPOCHS epochs of 2 micro-steps at
    640, bf16, batch 8 (nbs 8) from seeded weights, fed by the prefetcher, with the
    default augmentations (`AugmentHyp()`: segment mosaic 1.0, warp, HSV, flips; pose
    `_pose_sample`: the photometric list, HSV, flips) until close_mosaic (1 here),
    validating the EMA weights each epoch; returns the EMA weights' state."""
    from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
    from quan_ultralytics_tpu_torch.data.augment import AugmentHyp
    from quan_ultralytics_tpu_torch.engine.trainer import TrainConfig, Trainer
    from quan_ultralytics_tpu_torch.engine.validator import Validator

    name, nc = SEGPOSE[task]
    hyp = AugmentHyp()
    tds, vds = YOLODataset(cfg, "train", task=task), YOLODataset(cfg, "val", task=task)
    steps = len(tds) // BATCH
    tr = Trainer(seeded_model(torch.bfloat16, model=name, nc=nc),
                 TrainConfig(batch=BATCH, nbs=BATCH, epochs=FIT_EPOCHS), steps_per_epoch=steps, device=DEVICE)
    labels = {}

    def loader(epoch):
        for batch in build_dataloader(tds, BATCH, DET_IMGSZ, hyp=hyp if hyp.mosaic else None, augment=True,
                                      seed=epoch):
            labels[epoch] = labels.get(epoch, 0) + int(batch["mask"].sum())
            yield batch

    def close_mosaic_hook(epoch):
        hyp.mosaic = 0.0

    val_times = []

    def validate(trainer):
        val = Validator(trainer.model, imgsz=DET_IMGSZ, conf=VAL_CONF)
        with trainer.ema_weights():
            metrics = val(vds, batch_size=BATCH)
        val_times.append(val.speed)
        return metrics

    ema0 = torch.cat([e.reshape(-1) for e in tr.ema]).clone()
    _reset_counts()
    t0 = time.perf_counter()
    history = tr.fit(loader, validate, epochs=FIT_EPOCHS, save_dir=run_dir, close_mosaic_hook=close_mosaic_hook,
                     close_mosaic=FIT_CLOSE_MOSAIC, log=lambda line: print(f"{task} fit:", line))  # driven
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = _counts()
    ema_moved = float((torch.cat([e.reshape(-1) for e in tr.ema]) - ema0).abs().max())
    n_micro, n_val = FIT_EPOCHS * steps, FIT_EPOCHS * math.ceil(len(vds) / BATCH)
    print(f"{task} fit: {FIT_EPOCHS} epochs of {steps} micro-steps in {secs:.1f} s (validation included), "
          f"labels an epoch {labels}; launches {got}; EMA moved by up to {ema_moved:.3e}")
    check(len(history) == FIT_EPOCHS and all(math.isfinite(r["loss"]) for r in history),
          f"{task} fit history {history}")
    check(all(0 <= v <= 1 for r in history for k, v in r.items() if k.startswith(("mAP", "precision", "recall"))),
          f"{task} fit: a metric outside [0, 1]")
    check(ema_moved > 0 and hyp.mosaic == 0.0 and all(labels.get(e, 0) > 0 for e in range(FIT_EPOCHS)),
          f"{task} fit: the EMA did not move, close_mosaic did not close, or an epoch had no labels")
    check(got == {"qattn_fwd": n_micro + n_val, "qattn_fwd_with_stats": n_micro, "qattn_bwd": n_micro,
                  "qconv1x1_fused": 0}, f"{task} fit launches {got}")
    check((run_dir / "last.ckpt").exists() and (run_dir / "best.ckpt").exists(), f"{task} fit wrote no checkpoints")
    with tr.ema_weights():
        weights = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    del tr
    torch.cuda.empty_cache()
    return weights, {"seconds": secs, "epoch_s": [r["time_s"] for r in history], "history": history,
                     "launches": got, "ema_moved": ema_moved, "val_speed": val_times}


def phase_segpose_val(cfg, task: str, weights, n_sites: int):
    """The Validator at 640, conf 0.001, on the fit's EMA weights: bf16 with K1 and K3 and
    plain, f32 with K1 and plain, and for segment f32 K1 and plain with ``mask_native``
    (masks at 640 instead of 160); each run's launches counted from 0 and the N that K1
    saw recorded. Each kernel run against the plain run of its dtype: decoded predictions
    of every batch within PRED_TOL, every metric (boxes, and masks (M) or OKS (P)) within
    VAL_METRIC_TOL, and in f32 the kept counts explained and the kept rows matched as in
    `phase_detect_val`."""
    from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
    from quan_ultralytics_tpu_torch.engine.validator import Validator
    from quan_ultralytics_tpu_torch.models.block import QAttention
    from quan_ultralytics_tpu_torch.models.tasks import DetectionModel
    from quan_ultralytics_tpu_torch.ops.kernels import qattn, qconv_fused

    name, nc = SEGPOSE[task]
    ds = YOLODataset(cfg, "val", task=task)
    nb = math.ceil(len(ds) / BATCH)
    bf16, f32 = torch.bfloat16, torch.float32
    paths = {"bf16 K1+K3": (bf16, {"fused_1x1": True}), "bf16 plain": (bf16, {"fused_attn": False}),
             "f32 K1": (f32, {}), "f32 plain": (f32, {"fused_attn": False})}
    expect = {"bf16 K1+K3": (nb, 0, n_sites * nb), "bf16 plain": (0, 0, 0), "f32 K1": (0, nb, 0),
              "f32 plain": (0, 0, 0)}
    runs = [(p, False) for p in paths] + ([("f32 K1", True), ("f32 plain", True)] if task == "segment" else [])
    seen_n, models = [], {}
    for p, (dtype, kw) in paths.items():
        m = DetectionModel.from_yaml(name, nc=nc, dtype=dtype, device=DEVICE, **{"fused_1x1": False, **kw})
        m.load_state_dict(weights)
        for mod in m.modules():
            if isinstance(mod, QAttention):
                mod.register_forward_pre_hook(lambda _m, a: seen_n.append(a[0].shape[1] * a[0].shape[2]))
        models[p] = m
        Validator(m, imgsz=DET_IMGSZ, conf=VAL_CONF).infer(  # warm up: cuDNN's algorithms, the kernels' load
            torch.zeros(BATCH, DET_IMGSZ, DET_IMGSZ, 3, dtype=torch.uint8, device=DEVICE))
    torch.cuda.synchronize()
    res = {}
    for p, native in runs:
        key = f"{p}{' native' if native else ''}"
        val = Validator(models[p], imgsz=DET_IMGSZ, conf=VAL_CONF)
        seen_n.clear()
        _reset_counts()
        metrics = val(ds, batch_size=BATCH, mask_native=native)  # the segment or pose val path
        torch.cuda.synchronize()
        got, counts = (qattn.launches_mma, qattn.launches_simt, qconv_fused.launches_mma), _counts()
        res[key] = {"metrics": metrics, "speed": val.speed, "launches": counts, "attention_n": sorted(set(seen_n))}
        print(f"{task} val [{key}]: launches {counts}, K1 tensor / CUDA cores, K3 {got} (expected {expect[p]}); "
              f"K1 saw N = {res[key]['attention_n']}; {metrics}; {val.speed['img_s']:.1f} img/s, a batch: load "
              f"{val.speed['load_ms']:.1f} ms, infer {val.speed['infer_ms']:.1f} ms, match "
              f"{val.speed['match_ms']:.1f} ms")
        check(got == expect[p] and counts["qattn_fwd"] == sum(got[:2]) and counts["qattn_bwd"] == 0
              and counts["qattn_fwd_with_stats"] == 0 and counts["qconv1x1_fused"] == got[2],
              f"{task} val [{key}]: launches {counts}, {got} != {expect[p]}")
        sfx = "(M)" if task == "segment" else "(P)"
        check(set(metrics) == {"mAP50", "mAP50-95", "precision", "recall", f"mAP50{sfx}", f"mAP50-95{sfx}"}
              and all(math.isfinite(v) and 0 <= v <= 1 for v in metrics.values()),
              f"{task} val [{key}]: metrics {metrics}")
        check(res[key]["attention_n"] == [(DET_IMGSZ // 32) ** 2],
              f"{task} val [{key}]: the attention saw N = {res[key]['attention_n']}, not 400")
    batches = list(build_dataloader(ds, BATCH, DET_IMGSZ, hyp=None, augment=False, shuffle=False, drop_last=False,
                                    with_meta=True))
    xs = [torch.from_numpy(b["img"]).to(DEVICE) for b in batches]
    counts_n = [b["n_real"] for b in batches]
    agree = {}
    for k, r, native in (("bf16 K1+K3", "bf16 plain", False), ("f32 K1", "f32 plain", False),
                         ("f32 K1", "f32 plain", True)):
        if native and task != "segment":
            continue
        sfx = " native" if native else ""
        a, b = res[k + sfx], res[r + sfx]
        diff = {m: abs(a["metrics"][m] - b["metrics"][m]) for m in a["metrics"]}
        row = {"metric_diff": diff}
        check(all(v <= VAL_METRIC_TOL for v in diff.values()), f"{task} val, {k}{sfx} vs {r}: metrics differ {diff}")
        if not native:  # the decoded predictions do not depend on mask_native
            pairs = [(decoded(models[k], x), decoded(models[r], x)) for x in xs]
            rel = [compare_preds(kk, pp, nc, TAIL[task]) for kk, pp in pairs]
            rel = {g: max(q[g] for q in rel) for g in rel[0]}
            row["decoded_rel_err"] = rel
            dtype = paths[k][0]
            check(all(v <= PRED_TOL[dtype] for v in rel.values()),
                  f"{task} val, {k} vs {r}: decoded predictions disagree: {rel}")
            if dtype == f32:
                unexplained = [(bi, i) for bi, (kk, pp) in enumerate(pairs)
                               for i in _unexplained_counts(kk, pp, counts_n[bi], nc=nc, rotated=False)]
                matched = [_matched_rows(kk, pp, counts_n[bi], nc) for bi, (kk, pp) in enumerate(pairs)]
                share = sum(m for m, _ in matched) / max(sum(t for _, t in matched), 1)
                row.update(count_differs_unexplained=unexplained, rows_matched_share=share)
                check(len(unexplained) <= 1, f"{task} val, {k} vs {r}: counts differ on {unexplained}")
                check(share >= DET_ROW_SHARE, f"{task} val, {k} vs {r}: {share:.4f} of the kept rows match")
        agree[f"{k}{sfx} vs {r}{sfx}"] = row
        print(f"{task} val, {k}{sfx} vs {r}{sfx}: {row}")
    del models
    torch.cuda.empty_cache()
    out = {"paths": res, "agree": agree, "launches": res["bf16 K1+K3"]["launches"]}
    if task == "segment":
        out["launches_native"] = res["f32 K1 native"]["launches"]
    return out


def phase_segpose_cli(cfg, root: Path, task: str):
    """``python -m quan_ultralytics_tpu_torch.cli segment|pose ...`` in this process:
    ``train`` from a facade checkpoint of seeded weights (2 epochs at 640, batch 8, nbs 8,
    close_mosaic 1; bf16 steps, f32 validation), ``val`` and ``predict save_txt=True``
    (f32) of its best.pkl; the saved label lines (pose: with the keypoints) held to the
    facade's predictions."""
    import pickle

    from quan_ultralytics_tpu_torch.engine.model import YOLO
    from quan_ultralytics_tpu_torch.utils.weights import export_jax_variables

    name, nc = SEGPOSE[task]
    start = root / f"{task}_seeded.pkl"
    tree = export_jax_variables(seeded_model(None, model=name, nc=nc))
    start.write_bytes(pickle.dumps({"model_yaml": name, "nc": nc, "names": list(cfg["names"].values()),
                                    **tree, "raw_params": tree["params"], "step": 0}))
    data = write_data_yaml(cfg, root / f"{task}.yaml")
    run, pred = root / f"{task}_run_cli", root / f"{task}_predict"
    src = Path(cfg["path"]) / cfg["val"]
    # predict's conf: a segment detection carries a frame-sized mask, so the Predictor's default
    conf = DET_PREDICT_CONF if task == "segment" else VAL_CONF
    n_images = len(DET_SIZES)
    steps, n_val = n_images // BATCH, math.ceil(n_images / BATCH)
    text, train_s, train_n = _cli([task, "train", f"model={start}", f"data={data}", f"epochs={FIT_EPOCHS}",
                                   f"batch={BATCH}", f"imgsz={DET_IMGSZ}", f"close_mosaic={FIT_CLOSE_MOSAIC}",
                                   f"nbs={BATCH}", f"save_dir={run}"])
    epoch_s = [float(ln.split("time_s=")[1].split()[0]) for ln in text.splitlines() if ln.startswith("epoch ")]
    check(len(epoch_s) == FIT_EPOCHS and (run / "best.pkl").exists(), f"cli {task} train: {len(epoch_s)} epoch lines")
    n_micro, k3 = FIT_EPOCHS * steps, default_k3_sites(name, nc)
    check(train_n == {"qattn_fwd": n_micro + FIT_EPOCHS * n_val, "qattn_fwd_with_stats": n_micro,
                      "qattn_bwd": n_micro, "qconv1x1_fused": k3 * FIT_EPOCHS * n_val,
                      "qattn_fwd_tensor_cores": n_micro, "qattn_fwd_cuda_cores": FIT_EPOCHS * n_val},
          f"cli {task} train launches {train_n}")
    best = run / "best.pkl"
    text, val_s, val_n = _cli([task, "val", f"model={best}", f"data={data}", f"imgsz={DET_IMGSZ}",
                               f"batch={BATCH}", f"conf={VAL_CONF}"])
    metrics = ast.literal_eval(text.strip().splitlines()[-1])
    check(len(metrics) == 6 and all(0 <= v <= 1 for v in metrics.values()), f"cli {task} val metrics {metrics}")
    check(val_n["qattn_fwd"] == val_n["qattn_fwd_cuda_cores"] == n_val and val_n["qattn_bwd"] == 0
          and val_n["qconv1x1_fused"] == k3 * n_val, f"cli {task} val launches {val_n}")
    text, pred_s, pred_n = _cli([task, "predict", f"model={best}", f"source={src}", f"imgsz={DET_IMGSZ}",
                                 f"conf={conf}", "save_txt=True", "save_conf=True", f"save_dir={pred}"])
    lines = [ln for ln in text.splitlines() if ln.startswith("image ")]
    check(len(lines) == n_images and pred_n["qattn_fwd"] == pred_n["qattn_fwd_cuda_cores"] == 1
          and pred_n["qconv1x1_fused"] == k3, f"cli {task} predict: {len(lines)} image lines, launches {pred_n}")
    got = YOLO(str(best)).predict(str(src), imgsz=DET_IMGSZ, conf=conf)
    worst, n_obj = 0.0, 0
    for i, r in enumerate(got):
        vals = np.array((pred / "labels" / f"im{i}.txt").read_text().split(), np.float64)
        check(vals.size % max(len(r), 1) == 0, f"{task} im{i}.txt: {vals.size} values for {len(r)} objects")
        if not len(r):
            check(vals.size == 0, f"{task} im{i}.txt holds labels, the facade keeps none")
            continue
        rows = vals.reshape(len(r), -1)
        h, w = r.orig_shape
        x1, y1, x2, y2, conf, c = r.boxes.astype(np.float64).T
        cols = [(x1 + x2) / 2 / w, (y1 + y2) / 2 / h, (x2 - x1) / w, (y2 - y1) / h]
        if task == "pose":
            k = r.keypoints.astype(np.float64) / [w, h, 1.0]
            cols += list(k.reshape(len(k), -1).T)
        want = np.stack(cols + [conf], 1)
        check(rows.shape == (len(r), 1 + want.shape[1]) and (rows[:, 0] == c).all(),
              f"{task} im{i}.txt: {rows.shape} rows or classes differ from the facade's")
        worst = max(worst, float((np.abs(rows[:, 1:] - want) / np.maximum(1.0, np.abs(want))).max()))
        n_obj += len(r)
    check(n_obj > 0 and worst <= LABEL_TOL, f"the saved {task} labels ({n_obj} objects) are {worst:.3e} off "
          f"the facade's predictions")
    check([r.verbose() for r in got] == [ln.split(" ", 3)[3] for ln in lines],
          f"the CLI's per-image lines differ from the facade's {task} predictions")
    print(f"cli {task}: the saved labels of {n_images} images ({n_obj} objects) within {worst:.2e} of the facade's")
    return {"train_s": train_s, "epoch_s": epoch_s, "val_s": val_s, "predict_s": pred_s, "val_metrics": metrics,
            "launches_train": train_n, "launches_val": val_n, "launches_predict": pred_n,
            "launches": {k: train_n[k] + val_n[k] + pred_n[k] for k in train_n}, "labels_vs_facade": worst}


# ---------------------------------------------------------------- main


# ---------------------------------------------------------------- phases 23-27: classification

# CIFAR-10's python-pickle layout, 256 images a file (the real files hold 10,000)
CLS_CIFAR_PER_FILE = 256
CLS_CIFAR_BATCH = 128  # the recipe's batch (BASELINE.json #1)
CLS_CIFAR_EPOCHS = 2
# ImageNet folder layout: 4 classes x 48 train (3 batches of 64) and x 16 val, at
# frame sizes (h, w) of ImageNet photographs
CLS_IN_SIZES = [(375, 500), (500, 375), (480, 640), (240, 320)]
CLS_IN_CLASSES, CLS_IN_TRAIN, CLS_IN_VAL = 4, 48, 16
CLS_IN_BATCH = 64
CLS_IN_MAPPINGS = ("poincare", "hamilton", "raw_normalized", "mean_brightness")  # BASELINE.json #2
CLS_IN_STEPS = 3
CLS_YOLO = "yolo11n-cls-quan.yaml"
CLS_YOLO_IMGSZ, CLS_YOLO_SITES = 224, 19  # QC2PSA at P5: 7 x 7 = 49 tokens; the Classify conv 64 -> 320


def _cls_image(rng, h: int, w: int, c: int, n_classes: int) -> np.ndarray:
    """A uint8 frame whose colour and stripe frequency follow its class ``c``, with noise."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.array([255 * c // max(n_classes - 1, 1), 128, 255 - 255 * c // max(n_classes - 1, 1)])
    stripes = 60 * np.sin(xx * (c + 1) * np.pi / w)[..., None]
    return np.clip(base + stripes + rng.integers(-30, 31, (h, w, 3)), 0, 255).astype(np.uint8)


def phase_cls_data(root: Path, seed: int = 4):
    """A CIFAR-10 folder in the python-pickle format (``cifar-10-batches-py``:
    data_batch_1..5 and test_batch, 32 x 32 x 3 uint8 rows, CLS_CIFAR_PER_FILE
    images each, bytes keys) and an ImageNet-layout folder of PNG images
    (``train/``, ``val/``, one folder a class) at CLS_IN_SIZES, both read back
    through the port's loaders."""
    import pickle

    from quan_ultralytics_tpu_torch.classification.data import imagenet_folder_samples, load_cifar
    from quan_ultralytics_tpu_torch.data.native.native import imwrite_png

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    cifar = root / "cifar" / "cifar-10-batches-py"
    cifar.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        labels = rng.integers(0, 10, CLS_CIFAR_PER_FILE)
        ims = np.stack([_cls_image(rng, 32, 32, int(c), 10) for c in labels])
        with open(cifar / name, "wb") as fh:
            pickle.dump({b"batch_label": name.encode(), b"labels": [int(c) for c in labels],
                         b"data": ims.transpose(0, 3, 1, 2).reshape(len(ims), -1),
                         b"filenames": [f"{name}_{i}.png".encode() for i in range(len(ims))]}, fh)
    tx, ty, vx, vy = load_cifar(str(root / "cifar"), "cifar10")
    check(tx.shape == (5 * CLS_CIFAR_PER_FILE, 32, 32, 3) and vx.shape == (CLS_CIFAR_PER_FILE, 32, 32, 3)
          and tx.dtype == np.uint8 and set(ty) <= set(range(10)), f"CIFAR folder read as {tx.shape}, {vx.shape}")
    imagenet = root / "imagenet"
    for split, n in (("train", CLS_IN_TRAIN), ("val", CLS_IN_VAL)):
        for c in range(CLS_IN_CLASSES):
            (imagenet / split / f"n{c:08d}").mkdir(parents=True)
            for i in range(n):
                h, w = CLS_IN_SIZES[i % len(CLS_IN_SIZES)]
                imwrite_png(imagenet / split / f"n{c:08d}" / f"im{i:03d}.png",
                            _cls_image(rng, h, w, c, CLS_IN_CLASSES))
    files, labels, classes = imagenet_folder_samples(str(imagenet), "train")
    check(len(files) == CLS_IN_CLASSES * CLS_IN_TRAIN and len(classes) == CLS_IN_CLASSES,
          f"ImageNet folder: {len(files)} files, {len(classes)} classes")
    secs = time.perf_counter() - t0
    print(f"cls data: CIFAR-10 pickles {tx.shape[0]} + {vx.shape[0]} images, ImageNet folder "
          f"{len(files)} + {CLS_IN_CLASSES * CLS_IN_VAL} PNG at {CLS_IN_SIZES} (h, w), written in {secs:.1f} s")
    return root / "cifar", imagenet, {"cifar_train": int(tx.shape[0]), "cifar_test": int(vx.shape[0]),
                                      "imagenet_train": len(files), "imagenet_val": CLS_IN_CLASSES * CLS_IN_VAL,
                                      "seconds": secs}


def _tolerance_used(names, got, ref):
    """(largest share of its limit, its leaf) over leaves: max abs error within
    GRAD_TOL x max|leaf| + GRAD_TOL x 1e-3 x the largest |value| of any leaf."""
    vmax = max(float(r.abs().max()) for r in ref)
    used, used_name = 0.0, None
    for name, a, r in zip(names, got, ref):
        check(bool(torch.isfinite(a).all()), f"non-finite value of {name}")
        lim = GRAD_TOL * float(r.abs().max()) + GRAD_TOL * 1e-3 * vmax
        err = float((a - r).abs().max())
        if err > used * lim:
            used, used_name = err / lim, name
    return used, used_name


def _only_run(exp_dir: Path) -> Path:
    runs = list(exp_dir.iterdir())
    check(len(runs) == 1, f"{exp_dir}: {len(runs)} runs")
    return runs[0]


def phase_cls_cifar(cifar: Path, tmp: Path, tables=None, steps: int = 10):
    """Q-WRN-16-2 (BASELINE.json #1: poincare, CIFAR-10 at 32, batch 128, bf16,
    SGD-nesterov lr 0.1, wd 1e-4) through ``classification.cli.main``: 2 epochs
    from the pickle folder (finite losses, top-1/top-5 in [0, 1], last.pkl and
    best_model.pkl), then ``--resume last.pkl --epochs 3`` runs epoch 2 alone.
    Then ms a step and img/s on the host clock over ``steps`` steps, the device's
    busy share from torch.profiler, and one f32 step on the card against the same
    step on the CPU (same weights and batch, TF32 off): loss within LOSS_TOL
    relative, each parameter's and IQBN statistic's change within GRAD_TOL of
    its max|change| (+ GRAD_TOL x 1e-3 of the largest change)."""
    from quan_ultralytics_tpu_torch.classification.cli import main as cls_main
    from quan_ultralytics_tpu_torch.classification.data import CIFAR10_MEAN, CIFAR10_STD, batches, load_cifar
    from quan_ultralytics_tpu_torch.classification.train import ClsConfig, ClsTrainer

    common = ["--model", "qwrn16_2", "--dataset", "cifar10", "--data_dir", str(cifar),
              "--batch_size", str(CLS_CIFAR_BATCH)]
    _, fit_s, launches = _cli(common + ["--epochs", str(CLS_CIFAR_EPOCHS), "--exp_dir", str(tmp / "cls_a")],
                              cls_main)
    run = _only_run(tmp / "cls_a")
    rows = json.loads((run / "metrics.json").read_text())
    check([r["epoch"] for r in rows] == list(range(CLS_CIFAR_EPOCHS)), f"cifar epochs {rows}")
    check(all(math.isfinite(r["train_loss"]) and 0 <= r["top1"] <= r["top5"] <= 1 for r in rows),
          f"cifar metrics {rows}")
    check((run / "last.pkl").exists() and (run / "best_model.pkl").exists(), "cifar checkpoints missing")
    _, resume_s, _ = _cli(common + ["--epochs", str(CLS_CIFAR_EPOCHS + 1), "--resume", str(run / "last.pkl"),
                                    "--exp_dir", str(tmp / "cls_b")], cls_main)
    resumed = json.loads((_only_run(tmp / "cls_b") / "metrics.json").read_text())
    check([r["epoch"] for r in resumed] == [CLS_CIFAR_EPOCHS], f"resume ran epochs {[r['epoch'] for r in resumed]}")

    tx, ty, _, _ = load_cifar(str(cifar), "cifar10")
    batch = next(batches(tx, ty, CLS_CIFAR_BATCH, train=True, mean=CIFAR10_MEAN, std=CIFAR10_STD))
    steps_per_epoch = len(tx) // CLS_CIFAR_BATCH
    tr = ClsTrainer(ClsConfig(), steps_per_epoch, device=DEVICE)
    for _ in range(3):
        tr.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        tr.train_step(batch)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    prof = _device_profile(lambda: tr.train_step(batch), 3, f"qwrn16_2: 3 train steps, batch {CLS_CIFAR_BATCH} @ 32",
                           tables)
    busy = prof["device_ms"]
    speed = {"step_ms": step_ms, "img_s": CLS_CIFAR_BATCH * 1e3 / step_ms, "device_ms": busy,
             "device_ops": prof.get("device_ops"), "busy_share": busy / step_ms if busy is not None else None,
             "top": prof.get("top")}
    del tr

    # one f32 step, card against CPU, from the same weights (the same seed) and batch
    cfg32 = ClsConfig(dtype="float32")
    res = []
    for device in ("cpu", DEVICE):
        tr = ClsTrainer(cfg32, steps_per_epoch, device=device)
        before = {k: v.detach().cpu().clone() for k, v in tr.model.state_dict().items()}
        loss, _ = tr.train_step(batch)
        res.append((float(loss), {k: v.detach().cpu() - before[k] for k, v in tr.model.state_dict().items()}))
    (cpu_loss, cpu_d), (card_loss, card_d) = res
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    used, used_name = _tolerance_used(list(cpu_d), [card_d[n] for n in cpu_d], list(cpu_d.values()))
    f32 = {"loss_card": card_loss, "loss_cpu": cpu_loss, "loss_rel_err": loss_rel, "tolerance_used": used,
           "leaf": used_name}
    out = {"fit_s": fit_s, "resume_s": resume_s, "metrics": rows, "launches": launches, "speed": speed,
           "f32_card_vs_cpu": f32}
    print(f"cls cifar: qwrn16_2 2 epochs {fit_s:.1f} s (top1 {rows[-1]['top1']:.4f}, top5 {rows[-1]['top5']:.4f}), "
          f"resumed epoch 2 in {resume_s:.1f} s; a bf16 step {step_ms:.2f} ms ({speed['img_s']:.0f} img/s), "
          + (f"device busy {busy:.2f} ms ({speed['busy_share']:.3f}) over {prof['device_ops']:.0f} ops"
             if busy is not None else "device busy not measured")
          + f"; f32 step card vs CPU: loss rel {loss_rel:.2e}, {used:.3f} of the tolerance ({used_name}); "
          f"launches {launches}")
    check(loss_rel <= LOSS_TOL, f"qwrn16_2 f32 loss, card vs CPU: rel err {loss_rel:.3e} > {LOSS_TOL}")
    check(used <= 1.0, f"qwrn16_2 f32 update of {used_name}, card vs CPU: {used:.3f} of the tolerance")
    return out


def phase_cls_imagenet(imagenet: Path, tables=None):
    """``qrn34_imagenet`` (BASELINE.json #2: Q-ResNet-34, base width 64, nc 1000) at
    224 through ClsTrainer and the folder loader, batch 64, bf16: CLS_IN_STEPS
    updates under each of poincare, hamilton, raw_normalized and mean_brightness
    (finite losses), the loader's ms a batch, ms a step and img/s (host clock),
    the peak device memory, eval top-1/top-5 on the val folder."""
    from quan_ultralytics_tpu_torch.classification.data import imagenet_batches, imagenet_folder_samples
    from quan_ultralytics_tpu_torch.classification.train import ClsConfig, ClsTrainer

    tr_files, tr_labels, _ = imagenet_folder_samples(str(imagenet), "train")
    va_files, va_labels, _ = imagenet_folder_samples(str(imagenet), "val")
    out = {}
    for i, mapping in enumerate(CLS_IN_MAPPINGS):
        cfg = ClsConfig(model="qrn34_imagenet", dataset="imagenet", num_classes=1000, batch_size=CLS_IN_BATCH,
                        mapping=mapping)
        tr = ClsTrainer(cfg, len(tr_files) // CLS_IN_BATCH, device=DEVICE)
        torch.cuda.reset_peak_memory_stats()
        loader = imagenet_batches(tr_files, tr_labels, CLS_IN_BATCH, train=True, seed=i)
        load_ms, step_ms, losses = [], [], []
        for _ in range(CLS_IN_STEPS):
            t0 = time.perf_counter()
            batch = next(loader)
            load_ms.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            loss, _ = tr.train_step(batch)
            losses.append(float(loss))
            step_ms.append(1e3 * (time.perf_counter() - t0))
        loader.close()
        peak = torch.cuda.max_memory_allocated()
        val = tr.evaluate(imagenet_batches(va_files, va_labels, CLS_IN_BATCH, train=False))
        row = {"losses": losses, "load_ms": load_ms, "step_ms": step_ms,
               "img_s": CLS_IN_BATCH * 1e3 / statistics.median(step_ms[1:]), "peak_bytes": peak, **val}
        if mapping == CLS_IN_MAPPINGS[0]:
            batch = {k: torch.as_tensor(v).to(DEVICE) for k, v in batch.items()}
            prof = _device_profile(lambda: tr.train_step(batch), 2, f"qrn34_imagenet: 2 train steps, batch "
                                   f"{CLS_IN_BATCH} @ 224", tables)
            row["device_ms"], row["device_ops"] = prof["device_ms"], prof.get("device_ops")
            row["top"] = prof.get("top")
        out[mapping] = row
        print(f"cls imagenet [{mapping}]: losses {[round(v, 4) for v in losses]}; load {[round(v, 1) for v in load_ms]} "
              f"ms a batch of {CLS_IN_BATCH}; step {[round(v, 1) for v in step_ms]} ms ({row['img_s']:.0f} img/s "
              f"after the first); peak {peak / 2 ** 30:.2f} GiB; val top1 {val['top1']:.4f} top5 {val['top5']:.4f}"
              + (f"; device busy {row['device_ms']:.2f} ms a step over {row['device_ops']:.0f} ops"
                 if row.get("device_ms") is not None else ""))
        check(all(math.isfinite(v) for v in losses), f"qrn34_imagenet {mapping}: losses {losses}")
        check(0 <= val["top1"] <= val["top5"] <= 1, f"qrn34_imagenet {mapping}: {val}")
        del tr
        torch.cuda.empty_cache()
    return out


def _cls_kernels_alone(gen):
    """K1 at yolo11n-cls-quan's attention (G = 256, N = 49, dk = 2, dv = 4) and K3 at
    its Classify conv (Ci = 64, Co = 320, P = 392), bf16 and f32, and K2 at K1's
    shape in bf16, alone: each held to its plain version (qattn.FWD_TOL and BWD_TOL,
    qconv_fused.K3_TOL) and timed behind the spin kernel, bf16 beside the plain
    version, the library call and the bound."""
    from quan_ultralytics_tpu_torch.ops.kernels import qattn, qconv_fused
    from quan_ultralytics_tpu_torch.ops.mixing import MIX_MATRIX
    from quan_ultralytics_tpu_torch.ops.qconv import fold_dense_kernel

    dk, dv, heads, scale = 2, 4, 8, 2 ** -0.5
    G, n = BATCH * 4 * heads, 49
    timing = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k = (torch.randn(BATCH, 4, heads, n, dk, generator=gen, device=DEVICE).to(dtype) for _ in range(2))
        v = torch.randn(BATCH, 4, heads, n, dv, generator=gen, device=DEVICE).to(dtype)
        err, rel, ok = qattn.kernel_error(qattn.qattention_fused(q, k, v, scale),
                                          qattn.qattention_fwd_plain(q, k, v, scale), dtype, qattn.FWD_TOL)
        check(ok, f"K1 at N = 49 {dtype}: max abs err {err:.3e}, mean rel {rel:.3e}")
        ms = time_ms(lambda: qattn.qattention_fused(q, k, v, scale))[0]
        row = {"max_abs_err": err, "mean_rel_err": rel, "ms": ms}
        if dtype == torch.bfloat16:
            b, by = bound_ms(G * n * (2 * dk + 2 * dv) * q.element_size(), G * n * n * (2 * dk + 2 * dv),
                             G * n * n * 3, dtype)
            row.update({"plain_ms": time_ms(lambda: qattn.qattention_fwd_plain(q, k, v, scale), iters=5)[0],
                        "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                            q, k, v, scale=scale))[0], "bound_ms": b, "bound_by": by})
        timing[f"k1 {dtype}"] = row
        if dtype == torch.bfloat16:  # K2 at the same shape, given K1's statistics (as phase_k2)
            do = torch.randn(BATCH, 4, heads, n, dv, generator=gen, device=DEVICE).to(dtype)
            stats = qattn.new_stats(q)
            qattn.qattention_fwd(q, k, v, scale, stats)
            got = qattn.qattention_bwd(q, k, v, do, scale, stats)
            for name, a, r in zip(("dq", "dk", "dv"), got, qattn.qattention_bwd_plain(q, k, v, do, scale)):
                err, rel, ok = qattn.kernel_error(a, r, dtype, qattn.BWD_TOL)
                check(ok, f"K2 {name} at N = 49: max abs err {err:.3e}, mean rel {rel:.3e}")
            b, by = bound_ms(G * n * (4 * dk + 3 * dv) * q.element_size() + G * n * 2 * 4,
                             G * n * n * (6 * dk + 4 * dv), G * n * n * 6, dtype)
            ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
            with torch.enable_grad():
                o = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, scale=scale)
                library_ms = time_ms(lambda: torch.autograd.grad(o, (ql, kl, vl), do, retain_graph=True))[0]
            timing["k2 torch.bfloat16"] = {
                "ms": time_ms(lambda: qattn.qattention_bwd(q, k, v, do, scale, stats))[0],
                "plain_ms": time_ms(lambda: qattn.qattention_bwd_plain(q, k, v, do, scale), iters=5)[0],
                "library_ms": library_ms, "bound_ms": b, "bound_by": by}
    ci, co, p = 64, 320, BATCH * 49
    w = torch.randn(4, co, ci, 1, 1, generator=gen, device=DEVICE) / math.sqrt(4 * ci)
    sc = torch.rand(4, co, generator=gen, device=DEVICE) + 0.5
    sh = torch.randn(4, co, generator=gen, device=DEVICE) * 0.1
    for dtype in (torch.bfloat16, torch.float32):
        xk = torch.randn(BATCH, 7, 7, 4, ci, generator=gen, device=DEVICE).to(dtype)
        err, _, ok = compare(qconv_fused.qconv1x1_fused(xk, w, sc, sh),
                             qconv_fused.qconv1x1_fused_plain(xk, w, sc, sh), *qconv_fused.K3_TOL[dtype])
        check(ok, f"K3 at the Classify site {dtype}: max abs err {err:.3e}")
        row = {"max_abs_err": err, "ms": time_ms(lambda: qconv_fused.qconv1x1_fused(xk, w, sc, sh))[0]}
        if dtype == torch.bfloat16:
            dense = fold_dense_kernel(w, torch.tensor(MIX_MATRIX, device=DEVICE)).reshape(4 * co, 4 * ci)
            dense = dense.t().to(dtype).contiguous()
            x2 = xk.reshape(p, 4 * ci)
            isz = xk.element_size()
            b, by = bound_ms(p * 4 * (ci + co) * isz + 4 * ci * co * isz + 2 * 4 * co * 4, 2 * p * 4 * ci * co,
                             p * 4 * co * 9, dtype)
            row.update({"plain_ms": time_ms(lambda: qconv_fused.qconv1x1_fused_plain(xk, w, sc, sh))[0],
                        "library_ms": time_ms(lambda: torch.matmul(x2, dense))[0], "bound_ms": b, "bound_by": by})
        timing[f"k3 {dtype}"] = row
    print(f"cls yolo kernels alone: K1 G={G} N=49 {timing['k1 torch.bfloat16']}, f32 {timing['k1 torch.float32']}; "
          f"K2 {timing['k2 torch.bfloat16']}; "
          f"K3 Ci=64 Co=320 P={p} {timing['k3 torch.bfloat16']}, f32 {timing['k3 torch.float32']}")
    return timing


def phase_cls_yolo(gen, tables=None, rounds: int = 5):
    """QUAN-YOLO11n-cls (``yolo11n-cls-quan.yaml``, nc 1000, seeded weights) at 224,
    batch 8, on the K1, K1+K3 and plain paths in bf16 and f32, each run's launches
    counted from 0 (K1: 1, at N = 49; K3: the 19 fused sites, the Classify conv at
    Ci 64, Co 320 among them); logits against the plain path within PRED_TOL
    (max abs error over max|ref|). K1 at G = 256, N = 49 and K3 at the Classify
    site timed alone (behind the spin kernel) beside their plain versions, the
    library call and the bound; infer ms of each path in interleaved rounds. Then
    an f32 cross-entropy through the model in train mode, K1 + K2 against plain
    attention: loss within LOSS_TOL, each parameter's gradient within GRAD_TOL."""
    from quan_ultralytics_tpu_torch.models.block import QAttention
    from quan_ultralytics_tpu_torch.models.tasks import fused_1x1_sites
    from quan_ultralytics_tpu_torch.ops.kernels import qattn, qconv_fused

    paths = {"K1": dict(), "K1+K3": dict(fused_1x1=True), "plain": dict(fused_attn=False)}
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 256, (BATCH, CLS_YOLO_IMGSZ, CLS_YOLO_IMGSZ, 3), dtype=np.uint8)).to(DEVICE)
    x = x.float() / 255.0
    out = {"launches": {}, "agree": {}, "attention_n": []}
    for dtype in (torch.bfloat16, torch.float32):
        models = {p: seeded_model(dtype, model=CLS_YOLO, nc=1000, **kw) for p, kw in paths.items()}
        sites = fused_1x1_sites(models["K1+K3"], BATCH, CLS_YOLO_IMGSZ)
        check(len(sites) == CLS_YOLO_SITES and sites[-1] == (64, 320, BATCH * 49),
              f"yolo-cls fused sites {len(sites)}, last {sites[-1]}")
        hooks = [m.register_forward_pre_hook(lambda _m, a: out["attention_n"].append(a[0].shape[1] * a[0].shape[2]))
                 for m in models["K1"].modules() if isinstance(m, QAttention)]
        logits = {}
        for p, model in models.items():
            _reset_counts()
            with torch.inference_mode():
                logits[p] = model(x).float()  # the YOLO-cls forward, driven once
            torch.cuda.synchronize()
            counts = _counts()
            own = (qattn.launches_mma, qconv_fused.launches_mma) if dtype == torch.bfloat16 else (
                qattn.launches_simt, qconv_fused.launches_simt)
            expect = {"K1": (1, 0), "K1+K3": (1, CLS_YOLO_SITES), "plain": (0, 0)}[p]
            out["launches"][f"{p} {dtype}"] = counts
            print(f"cls yolo [{p} {dtype}]: launches {counts}, on the {dtype}'s cores {own} (expected {expect})")
            check(own == expect and counts == {"qattn_fwd": own[0], "qattn_fwd_with_stats": 0, "qattn_bwd": 0,
                                               "qconv1x1_fused": own[1]},
                  f"yolo-cls [{p} {dtype}]: launches {counts}, {own} != {expect}")
            check(logits[p].shape == (BATCH, 1000) and bool(torch.isfinite(logits[p]).all()),
                  f"yolo-cls [{p} {dtype}]: logits {tuple(logits[p].shape)}")
        for h in hooks:
            h.remove()
        ref = logits["plain"]
        for p in ("K1", "K1+K3"):
            rel = float((logits[p] - ref).abs().max()) / float(ref.abs().max())
            agree = (logits[p].argmax(-1) == ref.argmax(-1)).float().mean().item()
            out["agree"][f"{p} {dtype}"] = {"logits_rel_err": rel, "top1_agree": agree}
            print(f"cls yolo [{p} vs plain, {dtype}]: logits max abs err / max|ref| {rel:.3e}, top-1 equal on "
                  f"{agree:.3f} of the batch")
            check(rel <= PRED_TOL[dtype], f"yolo-cls [{p} {dtype}]: logits {rel:.3e} > {PRED_TOL[dtype]}")
        if dtype == torch.bfloat16:
            for m in models.values():  # warm up
                with torch.inference_mode():
                    m(x)
            times = {p: [] for p in models}
            order = list(models)
            for r in range(rounds):
                for p in (order if r % 2 == 0 else order[::-1]):
                    t0 = time.perf_counter()
                    with torch.inference_mode():
                        for _ in range(3):
                            models[p](x)
                    torch.cuda.synchronize()
                    times[p].append(1e3 * (time.perf_counter() - t0) / 3)
            out["infer_ms"] = {p: statistics.median(t) for p, t in times.items()}
            out["infer_ms_rounds"] = times
            with torch.inference_mode():
                prof = _device_profile(lambda: models["K1+K3"](x), 3, f"yolo-cls K1+K3: 3 forwards, batch {BATCH} "
                                       f"@ {CLS_YOLO_IMGSZ}", tables)
            out["device"] = {k: prof.get(k) for k in ("device_ms", "device_ops", "kernel_device_ms")}
            print(f"cls yolo: forward ms a batch of {BATCH} (host clock, median of {rounds}) {out['infer_ms']}; "
                  f"K1+K3 device {out['device']}")
        del models
    check(set(out["attention_n"]) == {49}, f"yolo-cls attention N {set(out['attention_n'])}")

    with torch.no_grad():
        out["timing"] = _cls_kernels_alone(gen)

    # f32 gradients of a cross-entropy through the model, K1 + K2 against plain attention
    labels = torch.from_numpy(rng.integers(0, 1000, BATCH)).to(DEVICE)
    grads = {}
    for p, kw in (("plain", dict(fused_attn=False)), ("fused", dict())):
        model = seeded_model(torch.float32, model=CLS_YOLO, nc=1000, **kw).train()
        _reset_counts()
        loss = torch.nn.functional.cross_entropy(model(x), labels)
        names, params = zip(*model.named_parameters())
        gs = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        grads[p] = (loss.item(), names, gs, _counts())
    (pl, names, ref, _), (fl, _, got, counts) = grads["plain"], grads["fused"]
    used, used_name = _tolerance_used(names, got, ref)
    loss_rel = abs(fl - pl) / abs(pl)
    out["grad"] = {"loss_plain": pl, "loss_fused": fl, "loss_rel_err": loss_rel, "tolerance_used": used,
                   "leaf": used_name, "launches": counts}
    print(f"cls yolo f32 gradients, K1 + K2 vs plain attention: loss rel {loss_rel:.2e}, {used:.3f} of the "
          f"tolerance ({used_name}); launches {counts}")
    check(counts["qattn_fwd_with_stats"] == 1 and counts["qattn_bwd"] == 1, f"yolo-cls grad launches {counts}")
    check(loss_rel <= LOSS_TOL, f"yolo-cls f32 loss, fused vs plain: rel {loss_rel:.3e}")
    check(used <= 1.0, f"yolo-cls f32 gradient of {used_name}: {used:.3f} of the tolerance")
    qkv = next(a for n_, a in zip(names, got) if n_.endswith("attn.qkv.w"))
    check(float(qkv.abs().max()) > 0, "yolo-cls: no gradient reached the attention's qkv")
    return out


def phase_cls_cli(cifar: Path, tmp: Path):
    """``yolo-torch classify train data=cifar10 data_dir=<the pickle folder>``, one
    epoch of Q-WRN-16-2 at batch 128, in this process: exit 0, metrics.json."""
    _, secs, launches = _cli(["classify", "train", "data=cifar10", f"data_dir={cifar}", "epochs=1",
                              f"batch={CLS_CIFAR_BATCH}", "model=qwrn16_2", f"exp_dir={tmp / 'cls_cli'}"])
    rows = json.loads((_only_run(tmp / "cls_cli") / "metrics.json").read_text())
    check([r["epoch"] for r in rows] == [0] and math.isfinite(rows[0]["train_loss"]), f"classify cli rows {rows}")
    return {"seconds": secs, "launches": launches, "metrics": rows}


# ---------------------------------------------------------------- phases 28-34: a user's model YAML

# yolo11n-hybrid-quan: the JAX package's cfg/models/yolo11-quan.yaml with QPSA at layer 10, C2f in
# the neck (layers 13, 16, 19, 22) and the HybridDetect head, at scale n, COCO nc = 80, @640. No
# catalog holds it: the script writes it to a file and reaches it only through that file's path.
HYBRID_NAME = "yolo11n-hybrid-quan.yaml"
HYBRID_YAML = """\
# yolo11n-hybrid-quan: QUAN-YOLO11 with QPSA, C2f and HybridDetect
nc: 80
scales: # [depth, width, max_channels]
  n: [0.50, 0.25, 1024]
  s: [0.50, 0.50, 1024]
  m: [0.50, 1.00, 512]
  l: [1.00, 1.00, 512]
  x: [1.00, 1.50, 512]

backbone:
  - [-1, 1, Conv, [64, 3, 2]]           # 0  P1/2
  - [-1, 1, Conv, [128, 3, 2]]          # 1  P2/4
  - [-1, 2, C3k2, [256, False, 0.25]]   # 2
  - [-1, 1, Conv, [256, 3, 2]]          # 3  P3/8
  - [-1, 2, C3k2, [512, False, 0.25]]   # 4
  - [-1, 1, Conv, [512, 3, 2]]          # 5  P4/16
  - [-1, 2, C3k2, [512, True]]          # 6
  - [-1, 1, Conv, [1024, 3, 2]]         # 7  P5/32
  - [-1, 2, C3k2, [1024, True]]         # 8
  - [-1, 1, QSPPF, [1024, 5]]           # 9
  - [-1, 1, QPSA, [1024]]               # 10

head:
  - [-1, 1, QUpsample, [2, nearest]]    # 11
  - [[-1, 6], 1, Concat, [1]]           # 12 cat P4
  - [-1, 2, C2f, [512, False]]          # 13
  - [-1, 1, QUpsample, [2, nearest]]    # 14
  - [[-1, 4], 1, Concat, [1]]           # 15 cat P3
  - [-1, 2, C2f, [256, False]]          # 16 (P3/8-small)
  - [-1, 1, Conv, [256, 3, 2]]          # 17
  - [[-1, 13], 1, Concat, [1]]          # 18 cat P4
  - [-1, 2, C2f, [512, False]]          # 19 (P4/16-medium)
  - [-1, 1, Conv, [512, 3, 2]]          # 20
  - [[-1, 10], 1, Concat, [1]]          # 21 cat P5
  - [-1, 2, C2f, [1024, True]]          # 22 (P5/32-large)
  - [[16, 19, 22], 1, HybridDetect, [nc]]  # 23
"""
HYBRID_SITES = 28  # the 1x1 Convs that fused_1x1 routes to K3: C3k2, QSPPF, QPSA and C2f's cv1/cv2, QPSA's ffn
# f32 resume, resumed epoch vs uninterrupted: per leaf, max |update difference| <= RESUME_TOL * max |update|
# + 1e-7 (the updates of one epoch, from the same state; f32 summation order only)
RESUME_TOL = 1e-3


def hybrid_yolo(path: Path, dtype, seed=0, **kw):
    """``YOLO(<the hybrid YAML's path>)`` on the card (weights from ``from_yaml``'s seed
    0), the model's weights spread from ``seed`` unless it is None (see `spread`)."""
    from quan_ultralytics_tpu_torch.engine.model import YOLO

    y = YOLO(str(path), nc=DET_NC, dtype=dtype, device=DEVICE, **kw)
    if seed is not None:
        spread(y.model, seed)
    return y


def plain_attention(model):
    """``model`` with its attention on the einsum path (no K1, no K2)."""
    from quan_ultralytics_tpu_torch.models.block import QAttention

    for mod in model.modules():
        if isinstance(mod, QAttention):
            mod.fused_attn = False
    return model


def det_frames(cfg, n: int = BATCH):
    """The detect set's first ``n`` frames, and the batch letterboxed to DET_IMGSZ on the card."""
    from quan_ultralytics_tpu_torch.data.augment import letterbox
    from quan_ultralytics_tpu_torch.data.native import native

    frames = [native.imread(f) for f in sorted((Path(cfg["path"]) / cfg["val"]).glob("*.png"))[:n]]
    return frames, torch.stack([letterbox(torch.from_numpy(f).to(DEVICE), DET_IMGSZ)[0] for f in frames])


def phase_hybrid_predict(cfg, path: Path, tables=None, rounds: int = 3):
    """yolo11n-hybrid-quan predicts 8 of the detect set's frames at 640 through
    ``YOLO(<path>).predict`` on the K1 path (QPSA's attention: N = 400, dk = dv = 4,
    G = 256), the K1+K3 path (``fused_1x1``: K3 at its 28 sites) and the plain one,
    each run's launches counted from 0; decoded predictions and kept counts held to
    the plain run as in `phase_detect_predict`; ``infer`` ms in interleaved rounds and
    device busy ms."""
    from quan_ultralytics_tpu_torch.engine.predictor import Predictor
    from quan_ultralytics_tpu_torch.models.tasks import fused_1x1_sites
    from quan_ultralytics_tpu_torch.ops.kernels import qattn, qconv_fused

    bf16 = torch.bfloat16
    yolos = {"K1": hybrid_yolo(path, bf16, fused_1x1=False), "K1+K3": hybrid_yolo(path, bf16, fused_1x1=True),
             "plain": hybrid_yolo(path, bf16, fused_1x1=False)}
    plain_attention(yolos["plain"].model)
    n_sites = len(fused_1x1_sites(yolos["K1+K3"].model, BATCH, DET_IMGSZ))
    check(n_sites == HYBRID_SITES, f"hybrid: {n_sites} fused 1x1 sites, expected {HYBRID_SITES}")
    frames, x = det_frames(cfg)
    expect = {"K1": (1, 0), "K1+K3": (1, n_sites), "plain": (0, 0)}
    out = {"launches": {}, "detections": {}, "fused_1x1_sites": n_sites}
    for name, y in yolos.items():
        _reset_counts()
        res = y.predict(frames, imgsz=DET_IMGSZ, conf=DET_PREDICT_CONF, iou=DET_PREDICT_IOU)  # driven once
        torch.cuda.synchronize()
        got, counts = (qattn.launches_mma, qconv_fused.launches_mma), _counts()
        out["launches"][name], out["detections"][name] = counts, [len(r) for r in res]
        print(f"hybrid predict [{name}]: launches {counts}, K1 and K3 on the tensor cores {got} (expected "
              f"{expect[name]}); kept a frame {out['detections'][name]}")
        check(got == expect[name] and counts == {"qattn_fwd": got[0], "qattn_fwd_with_stats": 0, "qattn_bwd": 0,
                                                 "qconv1x1_fused": got[1]},
              f"hybrid predict [{name}]: launches {counts}, {got} != {expect[name]}")
        check(len(res) == len(frames) and all(r.boxes.shape[1] == 6 and np.isfinite(r.boxes).all() for r in res),
              f"hybrid predict [{name}]: bad Results")
    ref = decoded(yolos["plain"].model, x)
    agree = {}
    for name in ("K1", "K1+K3"):
        kd = decoded(yolos[name].model, x)
        rel = compare_preds(kd, ref, DET_NC)
        unexplained = _unexplained_counts(kd, ref, len(frames), nc=DET_NC, rotated=False,
                                          conf=DET_PREDICT_CONF, iou=DET_PREDICT_IOU)
        agree[name] = {"decoded_rel_err": rel, "count_differs_unexplained": unexplained}
        print(f"hybrid predict [{name} vs plain, bf16]: decoded max abs err / max|ref| {rel}; kept counts "
              f"differ unexplained on frames {unexplained}")
        check(all(v <= PRED_TOL[bf16] for v in rel.values()),
              f"hybrid predict [{name}]: decoded predictions disagree with the plain path: {rel}")
        check(len(unexplained) <= DET_UNEXPLAINED,
              f"hybrid predict [{name}]: kept counts differ from the plain path's on frames {unexplained}")
    preds = {name: Predictor(y.model, imgsz=DET_IMGSZ, conf=DET_PREDICT_CONF) for name, y in yolos.items()}
    for pred in preds.values():
        pred.infer(x)
    torch.cuda.synchronize()
    order, times = list(preds), {name: [] for name in preds}
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            for _ in range(3):
                preds[name].infer(x)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0) / 3)
    speed = {f"hybrid {n}": {"infer_ms": statistics.median(t), "infer_ms_rounds": t} for n, t in times.items()}
    for name, row in speed.items():
        print(f"speed [{name}]: infer {row['infer_ms']:.2f} ms a batch of {BATCH} at {DET_IMGSZ}; rounds "
              f"{[round(v, 2) for v in row['infer_ms_rounds']]}")
    share = phase_device_share({f"hybrid {n}": y.model for n, y in yolos.items()}, x, speed, tables)
    out.update({"agree": agree, "speed": speed, "device": share})
    del yolos, preds
    torch.cuda.empty_cache()
    return out


def phase_hybrid_train(cfg, path: Path):
    """16 micro-steps of the hybrid model's train step, the model built by
    ``YOLO(<path>)`` (bf16, default TrainConfig at batch 8: accumulate 8; K1 with its
    statistics and K2 once a micro-step at QPSA's shape) on the detect set's first
    batch; ms a micro-step; then one f32 micro-step with fused and with plain
    attention, held as `phase_train_grads` holds the OBB one."""
    from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
    from quan_ultralytics_tpu_torch.engine.trainer import TrainConfig, Trainer
    from quan_ultralytics_tpu_torch.ops.kernels import qattn

    host = next(build_dataloader(YOLODataset(cfg, "train"), BATCH, DET_IMGSZ, hyp=None, max_labels=TRAIN_M,
                                 augment=False, shuffle=False))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
    trainer = Trainer(hybrid_yolo(path, torch.bfloat16, seed=None).model, TrainConfig(batch=BATCH), steps_per_epoch=100,
                      device=DEVICE)
    losses, times, skipped = [], [], []
    _reset_counts()
    for _ in range(TRAIN_STEPS):  # the hybrid train path, driven
        t0 = time.perf_counter()
        loss, aux = trainer.step(batch)
        losses.append(float(loss))
        times.append(1e3 * (time.perf_counter() - t0))
        skipped.append(float(aux["nan_skipped"]))
    torch.cuda.synchronize()
    got = {**_counts(), "qattn_fwd_tensor_cores": qattn.launches_mma}
    ms = statistics.median(times[1:])
    print(f"hybrid train: {TRAIN_STEPS} micro-steps at {DET_IMGSZ}; losses {[round(x, 3) for x in losses]}; "
          f"{ms:.1f} ms a micro-step (median after the first, {BATCH * 1e3 / ms:.1f} img/s); launches {got}")
    check(all(math.isfinite(x) for x in losses) and not any(skipped), f"hybrid train losses {losses}")
    check(got == {"qattn_fwd": TRAIN_STEPS, "qattn_fwd_with_stats": TRAIN_STEPS, "qattn_bwd": TRAIN_STEPS,
                  "qconv1x1_fused": 0, "qattn_fwd_tensor_cores": TRAIN_STEPS}, f"hybrid train launches {got}")
    check(trainer.opt.count == TRAIN_STEPS // trainer.accumulate, f"hybrid train: {trainer.opt.count} updates")
    del trainer
    grads = phase_train_grads(batch, str(path), DET_NC, tag="hybrid train")
    torch.cuda.empty_cache()
    return {"losses": losses, "launches": got, "ms_per_micro_step": ms, "ms_steps": times,
            "img_s": BATCH * 1e3 / ms, "grads_f32": grads}


def phase_hybrid_val(cfg, path: Path, root: Path):
    """``YOLO(<path>).val`` at 640, conf 0.001, rect off, bf16 with K1 and plain (the
    seeded weights), each run's launches counted from 0; metrics in [0, 1] and the
    K1 run's within VAL_METRIC_TOL of the plain run's; img/s on the host clock."""
    import contextlib
    import io

    from quan_ultralytics_tpu_torch.ops.kernels import qattn

    data = write_data_yaml(cfg, root / "hybrid_coco.yaml")
    nb = math.ceil(len(DET_SIZES) / BATCH)
    yolos = {"bf16 K1": hybrid_yolo(path, torch.bfloat16, fused_1x1=False),
             "bf16 plain": hybrid_yolo(path, torch.bfloat16, fused_1x1=False)}
    plain_attention(yolos["bf16 plain"].model)
    res = {}
    for name, y in yolos.items():
        tables = io.StringIO()
        _reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tables):  # the per-class table and the confusion summary
            metrics = y.val(str(data), imgsz=DET_IMGSZ, batch=BATCH, conf=VAL_CONF, rect=False)  # driven
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {**_counts(), "qattn_fwd_tensor_cores": qattn.launches_mma}
        res[name] = {"metrics": metrics, "launches": counts, "seconds": secs,
                     "img_s": len(DET_SIZES) / secs}
        print(f"hybrid val [{name}]: launches {counts}; {metrics}; {secs:.2f} s "
              f"({len(DET_SIZES) / secs:.1f} img/s, set-up included)")
        want = nb if name == "bf16 K1" else 0
        check(counts == {"qattn_fwd": want, "qattn_fwd_with_stats": 0, "qattn_bwd": 0, "qconv1x1_fused": 0,
                         "qattn_fwd_tensor_cores": want}, f"hybrid val [{name}]: launches {counts}")
        check(all(math.isfinite(v) and 0 <= v <= 1 for v in metrics.values()), f"hybrid val [{name}]: {metrics}")
    diff = {k: abs(res["bf16 K1"]["metrics"][k] - res["bf16 plain"]["metrics"][k]) for k in res["bf16 K1"]["metrics"]}
    print(f"hybrid val, bf16 K1 vs plain: metric differences {diff}")
    check(all(v <= VAL_METRIC_TOL for v in diff.values()), f"hybrid val: metrics differ by {diff}")
    return {"paths": res, "metric_diff": diff, "launches": res["bf16 K1"]["launches"]}


def phase_hybrid_cli(cfg, root: Path, path: Path):
    """``detect train|val|predict model=<path>`` in this process: ``detect train`` of
    the YAML's seeded weights (2 epochs at 640, batch 8, nbs 8, close_mosaic 1), whose
    best.pkl names the YAML's path, then ``detect val`` and ``detect predict`` of it;
    exit codes, epoch lines and launches of K1 (train steps with statistics, val and
    predict on the CUDA cores in f32) and K2."""
    from quan_ultralytics_tpu_torch.utils.weights import read_checkpoint

    data = write_data_yaml(cfg, root / "hybrid_coco.yaml")
    run = root / "hybrid_run_cli"
    steps, n_val = len(DET_SIZES) // BATCH, math.ceil(len(DET_SIZES) / BATCH)
    text, train_s, train_n = _cli(["detect", "train", f"model={path}", f"data={data}", f"epochs={FIT_EPOCHS}",
                                   f"batch={BATCH}", f"imgsz={DET_IMGSZ}", f"close_mosaic={FIT_CLOSE_MOSAIC}",
                                   f"nbs={BATCH}", f"save_dir={run}"])
    n_epochs = sum(ln.startswith("epoch ") for ln in text.splitlines())
    best = run / "best.pkl"
    check(n_epochs == FIT_EPOCHS and best.exists(), f"cli hybrid train: {n_epochs} epoch lines")
    n_micro, k3 = FIT_EPOCHS * steps, default_k3_sites(path, DET_NC)
    check(train_n == {"qattn_fwd": n_micro + FIT_EPOCHS * n_val, "qattn_fwd_with_stats": n_micro,
                      "qattn_bwd": n_micro, "qconv1x1_fused": k3 * FIT_EPOCHS * n_val,
                      "qattn_fwd_tensor_cores": n_micro, "qattn_fwd_cuda_cores": FIT_EPOCHS * n_val},
          f"cli hybrid train launches {train_n}")
    named = read_checkpoint(best)["model_yaml"]
    check(named == str(path), f"best.pkl names {named!r}, not the YAML's path")
    text, val_s, val_n = _cli(["detect", "val", f"model={best}", f"data={data}", f"imgsz={DET_IMGSZ}",
                               f"batch={BATCH}", f"conf={VAL_CONF}"])
    metrics = ast.literal_eval(text.strip().splitlines()[-1])
    check(all(0 <= metrics[k] <= 1 for k in ("mAP50", "mAP50-95", "precision", "recall")),
          f"cli hybrid val metrics {metrics}")
    check(val_n["qattn_fwd"] == val_n["qattn_fwd_cuda_cores"] == n_val and val_n["qconv1x1_fused"] == k3 * n_val,
          f"cli hybrid val launches {val_n}")
    src = Path(cfg["path"]) / cfg["val"]
    text, pred_s, pred_n = _cli(["detect", "predict", f"model={best}", f"source={src}", f"imgsz={DET_IMGSZ}",
                                 f"conf={VAL_CONF}"])
    lines = [ln for ln in text.splitlines() if ln.startswith("image ")]
    check(len(lines) == len(DET_SIZES) and pred_n["qattn_fwd"] == pred_n["qattn_fwd_cuda_cores"] == 1
          and pred_n["qconv1x1_fused"] == k3, f"cli hybrid predict: {len(lines)} image lines, launches {pred_n}")
    return {"train_s": train_s, "val_s": val_s, "predict_s": pred_s, "val_metrics": metrics,
            "launches": {k: train_n[k] + val_n[k] + pred_n[k] for k in train_n}}


def phase_hybrid_ensemble(cfg, path: Path):
    """``Ensemble([QUAN-YOLO11n, yolo11n-hybrid-quan]).decode`` on 8 letterboxed frames
    at 640 (bf16, K1 in each member), equal to the members' decoded predictions side by
    side, then ``non_max_suppression`` (``nms_axis_aligned``) at the Predictor's conf
    and IoU: finite detections inside the letterbox."""
    from quan_ultralytics_tpu_torch.models.ensemble import Ensemble
    from quan_ultralytics_tpu_torch.ops.boxes import non_max_suppression

    members = [seeded_model(torch.bfloat16, model=DET_MODEL, nc=DET_NC), hybrid_yolo(path, torch.bfloat16).model]
    ens = Ensemble(members)
    _, x = det_frames(cfg)
    img = x.float() / 255.0
    _reset_counts()
    pred = ens.decode(img)  # driven once
    torch.cuda.synchronize()
    counts = _counts()
    each = [decoded(m, x) for m in members]
    check(tuple(pred.shape) == (BATCH, sum(e.shape[1] for e in each), 4 + DET_NC),
          f"ensemble decode shape {tuple(pred.shape)}")
    err = compare_preds(pred.float(), torch.cat(each, 1), DET_NC)
    det, ok = non_max_suppression(pred, conf_thres=DET_PREDICT_CONF, iou_thres=DET_PREDICT_IOU, nc=DET_NC)
    kept = ok.sum(1).tolist()
    rows = det[ok]
    print(f"hybrid ensemble: decode {tuple(pred.shape)}, launches {counts}, vs the members side by side {err}; "
          f"NMS kept a frame {kept}")
    check(counts["qattn_fwd"] == 2 and counts["qattn_bwd"] == 0, f"ensemble launches {counts}")
    check(all(v <= PRED_TOL[torch.float32] for v in err.values()), f"ensemble decode differs from its members': {err}")
    check(bool(torch.isfinite(rows).all()) and all(k > 0 for k in kept), "ensemble NMS: no detections, or not finite")
    return {"launches": counts, "kept": kept, "anchors": int(pred.shape[1])}


def phase_hybrid_resume(cfg, path: Path, root: Path):
    """Trainer.fit of the hybrid model in f32 (TF32 off, f32 assigner metric, cuDNN's
    deterministic algorithms; batch 8, nbs 8: an update a micro-step, no augmentation)
    for 2 epochs, its ``last.ckpt`` (the JAX trainer's pickle) kept as epoch 0 left it;
    a new Trainer restores that file, holds the state bit for bit, and trains epoch 1:
    its update equals the uninterrupted run's epoch-1 update (RESUME_TOL), with the
    same counters."""
    import shutil

    from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
    from quan_ultralytics_tpu_torch.engine.trainer import TrainConfig, Trainer
    from quan_ultralytics_tpu_torch.utils.callbacks import Callbacks

    tds = YOLODataset(cfg, "train")
    steps = len(tds) // BATCH

    def loader(epoch):
        return build_dataloader(tds, BATCH, DET_IMGSZ, hyp=None, augment=False, seed=epoch)

    def trainer():
        return Trainer(hybrid_yolo(path, None, seed=None).model,
                       TrainConfig(batch=BATCH, nbs=BATCH, epochs=2, dtype="float32", assigner_bf16=False),
                       steps_per_epoch=steps, device=DEVICE)

    def flat(ts):
        return [t.detach().clone() for t in ts]

    quiet = lambda line: None  # noqa: E731
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        whole, snaps = trainer(), []
        cut = root / "resume_epoch0.ckpt"

        def keep(ckpt):  # after each epoch's last.ckpt: epoch 0's file is the interrupted run's
            snaps.append(flat(whole.params))
            if len(snaps) == 1:
                shutil.copyfile(ckpt, cut)

        cb = Callbacks()
        cb.add("on_model_save", keep)
        whole.fit(loader, None, epochs=2, save_dir=root / "resume_whole", log=quiet, callbacks=cb)
        resumed = trainer()
        start = resumed.restore_checkpoint(cut)
        exact = all(torch.equal(a, b) for a, b in zip(snaps[0], resumed.params))
        _reset_counts()
        resumed.fit(loader, None, epochs=2, start_epoch=start, save_dir=root / "resume_cut", log=quiet)  # driven
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    counts = _counts()
    used, worst_leaf = 0.0, None
    for n, a0, a1, b1 in zip(whole.param_names, snaps[0], snaps[1], resumed.params):
        da, db = a1 - a0, b1.detach() - a0
        share = float((da - db).abs().max()) / (RESUME_TOL * float(da.abs().max()) + 1e-7)
        if share > used:
            used, worst_leaf = share, n
    print(f"hybrid resume: restored at epoch {start}, the weights bit for bit {exact} (steps {resumed.steps}, "
          f"updates {resumed.opt.count} vs {whole.steps}, {whole.opt.count}); launches of the resumed epoch "
          f"{counts}; its update uses {used:.3f} of the tolerance ({worst_leaf})")
    check(start == 1 and exact and (resumed.steps, resumed.opt.count) == (whole.steps, whole.opt.count),
          "hybrid resume: the restored state or the counters differ from the uninterrupted run's")
    check(counts["qattn_fwd"] == steps and counts["qattn_bwd"] == steps, f"hybrid resume launches {counts}")
    check(used <= 1.0, f"hybrid resume: the resumed update of {worst_leaf} uses {used:.3f} of the tolerance")
    return {"launches": counts, "tolerance_used": used, "leaf": worst_leaf, "restored_exactly": exact}


# ---------------------------------------------------------------- phase 35: the TPU-chosen defaults

# the conv forms measured: (impl, fold threshold) -- `auto` folds a layer whose C_out a component
# is below the threshold (FOLD_MAX_EVAL and FOLD_MAX_TRAIN both set to it in its arm)
# rounds of phase 35: the defaults were set from two (the arms forward, then backward); one
# keeps them checked at half the script time
FORM_ROUNDS = 1
FORM_ARMS = (("grouped", None), ("folded", None), ("auto", 16), ("auto", 32), ("auto", 64), ("auto", 128))


def set_conv_form(models, impl: str, fold_max) -> None:
    from quan_ultralytics_tpu_torch.models import conv

    for m in models:
        for mod in m.modules():
            if isinstance(mod, conv.QConv2D):
                mod.impl = impl
    if fold_max is not None:
        conv.FOLD_MAX_EVAL = conv.FOLD_MAX_TRAIN = fold_max


def phase_conv_forms(x, tables=None, calls: int = 1):
    """The quaternion conv's form (ROADMAP Queue 3, "Defaults chosen on the
    H100"), measured where it is chosen:
    QUAN-YOLO11n-OBB's ``infer`` at 1024 (batch 8, bf16, K1) and its train micro-step
    (the same, accumulating: no update in the window), and a Q-WRN-16-2 train step at
    batch 128 @ 32 (bf16), under each of FORM_ARMS, in FORM_ROUNDS rounds (the arms
    forward, then backward). Device busy ms a call from torch.profiler decides; host
    ms a call (synchronized) is printed beside it. The module's thresholds are put
    back after."""
    from quan_ultralytics_tpu_torch.classification.train import ClsConfig, ClsTrainer
    from quan_ultralytics_tpu_torch.engine.predictor import Predictor
    from quan_ultralytics_tpu_torch.models import conv

    saved = (conv.FOLD_MAX_EVAL, conv.FOLD_MAX_TRAIN)
    obb = seeded_model(torch.bfloat16)
    pred = Predictor(obb, imgsz=IMGSZ)
    tr = make_trainer(torch.bfloat16, nbs=BATCH * 10 ** 6)
    batch = make_train_batch(0)
    cls = ClsTrainer(ClsConfig(model="qwrn16_2", batch_size=CLS_CIFAR_BATCH, num_classes=10),
                     steps_per_epoch=10 ** 6, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    cls_batch = {"img": torch.randn(CLS_CIFAR_BATCH, 32, 32, 3, generator=gen, device=DEVICE),
                 "label": torch.randint(0, 10, (CLS_CIFAR_BATCH,), generator=gen, device=DEVICE)}
    work = {"obb_infer": lambda: pred.infer(x), "obb_micro_step": lambda: tr.step(batch),
            "qwrn16_2_step": lambda: cls.train_step(cls_batch)}
    rows = {}
    try:
        for arms in (FORM_ARMS, FORM_ARMS[::-1])[:FORM_ROUNDS]:
            for impl, fold_max in arms:
                arm = impl if fold_max is None else f"auto{fold_max}"
                set_conv_form([obb, tr.model, cls.model], impl, fold_max)
                for w, fn in work.items():
                    fn()  # this form's first call: cuDNN picks its algorithms
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(calls):
                        fn()
                    torch.cuda.synchronize()
                    host = 1e3 * (time.perf_counter() - t0) / calls
                    busy = _device_profile(fn, calls, f"{w} [{arm}]", tables)["device_ms"]
                    check(busy is not None, "the profiler recorded no device time")
                    rows.setdefault(w, {}).setdefault(arm, []).append({"device_ms": busy, "host_ms": host})
    finally:
        conv.FOLD_MAX_EVAL, conv.FOLD_MAX_TRAIN = saved
        set_conv_form([obb, tr.model, cls.model], "auto", None)
    out = {}
    for w, arms in rows.items():
        mean = {arm: statistics.mean(r["device_ms"] for r in rs) for arm, rs in arms.items()}
        best = min(mean, key=mean.get)
        out[w] = {"arms": arms, "mean_device_ms": mean, "best": best}
        print(f"conv forms [{w}]: device busy ms a call by arm ({FORM_ROUNDS} round(s)) "
              + ", ".join(f"{arm} {[round(r['device_ms'], 3) for r in rs]} (host "
                          f"{[round(r['host_ms'], 1) for r in rs]})" for arm, rs in arms.items())
              + f"; least: {best}")
    del obb, pred, tr, cls
    torch.cuda.empty_cache()
    out["fused_1x1"] = fused_1x1_arms(x, tables, calls)
    return out


def fused_1x1_arms(x, tables=None, calls: int = 1, rounds: int = 2):
    """``fused_1x1`` off (K1) and on (K1+K3) on QUAN-YOLO11n-OBB's ``infer`` at 1024,
    batch 8, in bf16 (K3 on the tensor cores) and f32 (on the CUDA cores), the paths
    taking turns: device busy ms (torch.profiler) and host ms a call."""
    from quan_ultralytics_tpu_torch.engine.predictor import Predictor

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        preds = {name: Predictor(seeded_model(dtype, fused_1x1=on), imgsz=IMGSZ)
                 for name, on in (("K1", False), ("K1+K3", True))}
        rows = {name: [] for name in preds}
        for r in range(rounds):
            for name in (list(preds) if r % 2 == 0 else list(preds)[::-1]):
                fn = lambda: preds[name].infer(x)  # noqa: E731
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                host = 1e3 * (time.perf_counter() - t0) / calls
                busy = _device_profile(fn, calls, f"fused_1x1 [{name}, {dtype}]", tables)["device_ms"]
                rows[name].append({"device_ms": busy, "host_ms": host})
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        out[tag] = rows
        print(f"fused_1x1 [{tag}]: OBB infer @{IMGSZ}, device busy / host ms a call by round "
              + ", ".join(f"{name} {[round(r['device_ms'], 3) for r in rs]} / {[round(r['host_ms'], 1) for r in rs]}"
                          for name, rs in rows.items()))
        del preds
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phases 36-41: track, benchmark, export, embed,
# tune, autobatch and their CLI modes

TRACK_FRAMES = 16  # frames of the clip that the track phases follow
TRACK_SIZE = (480, 640)  # (h, w) of a clip frame: a COCO frame size
TRACK_OBJECTS = 6  # filled rectangles moving at constant velocities across the clip
TRACK_PAN = (2, 1)  # the camera's pan a frame in px (x, y); the background moves by minus this
# GMC's translation a frame against the pan, px: the method's own error (OpenCV's GMC is up to
# 0.62 px off the truth at a 320 x 240 test frame's corners, tests/test_torch_trackers.py), and
# its rotation part within GMC_ROT_TOL of the identity
GMC_TOL, GMC_ROT_TOL = 1.0, 1e-2
BENCH_ITERS = 10  # timed calls a row of the benchmark table (the JAX package's default)
TUNE_ITERS, TUNE_EPOCHS = 2, 1  # tuner iterations and the epochs each trains
EXPORT_OPS = {"quan_torch.qattention_fwd.default": 1, "quan_torch.qconv1x1_fused.default": 37}


def seeded_pkl(path: Path, model: str, nc: int, names=None) -> Path:
    """A facade checkpoint (``.pkl``) of `seeded_model`'s weights."""
    import pickle

    from quan_ultralytics_tpu_torch.utils.weights import export_jax_variables

    tree = export_jax_variables(seeded_model(None, model=model, nc=nc))
    path.write_bytes(pickle.dumps({"model_yaml": model, "nc": nc, "names": names, **tree,
                                   "raw_params": tree["params"], "step": 0}))
    return path


def make_clip(root: Path, seed: int = 6):
    """TRACK_FRAMES frames of 640 x 480 written as PNG into ``root``: a textured
    background (bilinear-upsampled noise with fine noise on it) panned TRACK_PAN a
    frame, under TRACK_OBJECTS filled rectangles moving at constant velocities."""
    import torch.nn.functional as F

    from quan_ultralytics_tpu_torch.data.native.native import imwrite_png

    rng = np.random.default_rng(seed)
    h, w = TRACK_SIZE
    H, W = h + TRACK_FRAMES * TRACK_PAN[1] + 16, w + TRACK_FRAMES * TRACK_PAN[0] + 16
    coarse = torch.from_numpy(rng.uniform(0, 255, (1, 3, H // 16 + 2, W // 16 + 2)).astype(np.float32))
    bg = F.interpolate(coarse, scale_factor=16, mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
    bg = np.clip(bg.numpy()[:H, :W] + rng.integers(-12, 13, (H, W, 3)), 0, 255).astype(np.uint8)
    pos = rng.uniform([0.15 * w, 0.15 * h], [0.85 * w, 0.85 * h], (TRACK_OBJECTS, 2))
    size = rng.uniform(0.06, 0.17, (TRACK_OBJECTS, 2)) * w
    vel = rng.uniform(-6, 6, (TRACK_OBJECTS, 2))
    colour = rng.integers(0, 256, (TRACK_OBJECTS, 3))
    root.mkdir(parents=True, exist_ok=True)
    frames = []
    for t in range(TRACK_FRAMES):
        x0, y0 = t * TRACK_PAN[0], t * TRACK_PAN[1]
        im = bg[y0:y0 + h, x0:x0 + w].copy()
        for p, s, v, c in zip(pos, size, vel, colour):
            cx, cy = p + v * t
            im[int(max(cy - s[1] / 2, 0)):int(min(cy + s[1] / 2, h)),
               int(max(cx - s[0] / 2, 0)):int(min(cx + s[0] / 2, w))] = c
        imwrite_png(root / f"f{t:02d}.png", im)
        frames.append(im)
    return frames


def phase_track(root: Path):
    """QUAN-YOLO11n (nc 80, seeded weights, f32; the facade's default fused_1x1:
    K1 + K3 a frame) follows the clip at 640 through `YOLO.track` with ByteTrack
    and with BoT-SORT (GMC on every frame): launches counted, ms a frame split
    into infer (letterbox, forward, NMS, copy back), the tracker's update and
    GMC; each tracker's output re-derived by a fresh tracker from the recorded
    detections (and frames); GMC's affine against the clip's pan. The trackers'
    thresholds sit at the seeded model's scores on the first frame (a track
    starts above their 95th percentile, a low-score match above the median):
    random weights give no score to the default thresholds' scale. f32, not
    bf16: in bf16 the seeded model's 300 kept scores take 1 to 3 values
    (0.9728 on all 300 of the first frame on an H100 80GB HBM3), so no
    threshold separates them.""" 
    from quan_ultralytics_tpu_torch import trackers
    from quan_ultralytics_tpu_torch.engine.model import YOLO
    from quan_ultralytics_tpu_torch.trackers import byte_tracker

    frames = make_clip(root / "clip")
    pkl = seeded_pkl(root / "track_seeded.pkl", DET_MODEL, DET_NC)
    y = YOLO(str(pkl), device=DEVICE)
    n_sites = default_k3_sites(DET_MODEL, DET_NC)
    conf = y.predict(frames[0], imgsz=DET_IMGSZ)[0].conf
    check(len(conf) >= 2, f"track: the seeded model keeps {len(conf)} detections on the first frame")
    kw = dict(track_high_thresh=float(np.quantile(conf, 0.95)), track_low_thresh=float(np.quantile(conf, 0.5)),
              new_track_thresh=float(np.quantile(conf, 0.95)))
    out = {"thresholds": kw, "frames": TRACK_FRAMES, "size": TRACK_SIZE}
    for kind in ("bytetrack", "botsort"):
        tracker = trackers.BOTSORT(**kw) if kind == "botsort" else trackers.BYTETracker(**kw)
        spent, recorded, affines = {"update": 0.0, "gmc": 0.0}, [], []
        update = tracker.update

        def timed_update(xyxy, scores, cls, _update=update, _spent=spent, _rec=recorded, **kwargs):
            _rec.append((xyxy.copy(), scores.copy(), cls.copy()))
            t0 = time.perf_counter()
            res = _update(xyxy, scores, cls, **kwargs)
            _spent["update"] += time.perf_counter() - t0
            return res

        tracker.update = timed_update
        if kind == "botsort":
            apply = tracker.gmc.apply

            def timed_apply(frame, _apply=apply, _spent=spent, _aff=affines):
                t0 = time.perf_counter()
                H = _apply(frame)
                _spent["gmc"] += time.perf_counter() - t0
                _aff.append(H)
                return H

            tracker.gmc.apply = timed_apply
        y._tracker = tracker
        byte_tracker.STrack._count = 0
        _reset_counts()
        t0 = time.perf_counter()
        tracks = y.track(frames, imgsz=DET_IMGSZ, tracker=kind, persist=True)  # the track path, driven once
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        got = _counts()
        check(got == {"qattn_fwd": TRACK_FRAMES, "qattn_fwd_with_stats": 0, "qattn_bwd": 0,
                      "qconv1x1_fused": TRACK_FRAMES * n_sites}, f"track [{kind}]: launches {got}")
        check(len(tracks) == TRACK_FRAMES and all(t.ndim == 2 and t.shape[1] == 7 and np.isfinite(t).all()
                                                  and (t[:, 4] >= 1).all() for t in tracks),
              f"track [{kind}]: bad track arrays")
        # the same detections (and frames) through a fresh tracker give the same tracks
        fresh = trackers.BOTSORT(**kw) if kind == "botsort" else trackers.BYTETracker(**kw)
        byte_tracker.STrack._count = 0
        again = [fresh.update(*det, **({"frame": f} if kind == "botsort" else {}))
                 for det, f in zip(recorded, frames)]
        check(all(np.array_equal(a, b) for a, b in zip(tracks, again)),
              f"track [{kind}]: the facade's tracks differ from the trackers' on its detections")
        ids = {}
        for t in tracks:
            for i in t[:, 4].astype(int):
                ids[i] = ids.get(i, 0) + 1
        row = {"launches": got, "ms_a_frame": 1e3 * total / TRACK_FRAMES,
               "infer_ms_a_frame": 1e3 * (total - spent["update"]) / TRACK_FRAMES,
               "update_ms_a_frame": 1e3 * (spent["update"] - spent["gmc"]) / TRACK_FRAMES,
               "gmc_ms_a_frame": 1e3 * spent["gmc"] / TRACK_FRAMES,
               "tracks_a_frame": [len(t) for t in tracks], "ids": len(ids),
               "longest_track_frames": max(ids.values(), default=0)}
        if kind == "botsort":
            Hs = np.stack(affines[1:]).astype(np.float64)
            shift = float(np.abs(Hs[:, :, 2] + np.array(TRACK_PAN)).max())
            rot = float(np.abs(Hs[:, :, :2] - np.eye(2)).max())
            row.update({"gmc_shift_err_px": shift, "gmc_rot_err": rot})
            check(shift <= GMC_TOL and rot <= GMC_ROT_TOL,
                  f"track [botsort]: GMC's affine is {shift:.3f} px / {rot:.4f} off the clip's pan")
        out[kind] = row
        print(f"track [{kind}]: {row['ms_a_frame']:.1f} ms a frame at {DET_IMGSZ} (infer "
              f"{row['infer_ms_a_frame']:.1f}, update {row['update_ms_a_frame']:.2f}, GMC "
              f"{row['gmc_ms_a_frame']:.1f}); launches {got}; tracks a frame {row['tracks_a_frame']}, "
              f"{row['ids']} IDs, the longest over {row['longest_track_frames']} frames"
              + (f"; GMC off the pan by {row['gmc_shift_err_px']:.3f} px" if kind == "botsort" else ""))
    return out


def phase_benchmark():
    """`utils.benchmarks.benchmark`: QUAN-YOLO11n-OBB at 1024 and QUAN-YOLO11n at 640,
    batch 8, bf16 and f32, BENCH_ITERS timed calls of forward + decode + NMS each
    (CUDA events, one synchronization); the table printed, launches counted."""
    from quan_ultralytics_tpu_torch.utils.benchmarks import WARMUP, benchmark, print_table

    _reset_counts()
    t0 = time.perf_counter()
    rows = (benchmark((MODEL,), (IMGSZ,), batch=BATCH, dtypes=("bfloat16", "float32"), iters=BENCH_ITERS, nc=NC)
            + benchmark((DET_MODEL,), (DET_IMGSZ,), batch=BATCH, dtypes=("bfloat16", "float32"),
                        iters=BENCH_ITERS, nc=DET_NC))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = _counts()
    calls = WARMUP + BENCH_ITERS
    k3 = 2 * calls * (default_k3_sites(MODEL, NC) + default_k3_sites(DET_MODEL, DET_NC))
    check(got == {"qattn_fwd": 4 * calls, "qattn_fwd_with_stats": 0, "qattn_bwd": 0, "qconv1x1_fused": k3},
          f"benchmark: launches {got}")
    check(len(rows) == 4 and all(r["ms_per_batch"] > 0 for r in rows), f"benchmark rows {rows}")
    print_table(rows)
    print(f"benchmark: {len(rows)} rows in {secs:.1f} s; launches {got}")
    return {"rows": rows, "launches": got, "seconds": secs}


def _graph_ops(backend):
    from collections import Counter

    return dict(Counter(str(n.target) for n in backend._fn.graph.nodes
                        if n.op == "call_function" and str(n.target).startswith("quan_torch")))


def phase_export(root: Path, data_cfg, frames, x):
    """``YOLO(.pkl, dtype=bf16).export(format="exported", imgsz=1024, batch=8)`` of
    QUAN-YOLO11n-OBB's seeded weights: the ``.pt2``'s graph holds 1 K1 and 37 K3
    operators; run, it launches them; its decoded output against the live
    model's on the phase-3 frames (bf16: PRED_TOL, and the kept counts at conf
    0.25 equal or explained); the artifact's and the live ``infer`` in
    interleaved rounds, and each one's device busy ms and operations. Then ``obb export`` (f32) and ``obb predict`` of that
    ``.pt2`` through the CLI, in this process: its decoded output within the f32
    PRED_TOL of the live f32 model, the predictions of the CLI and of the facade's
    ``YOLO(<.pt2>)`` on the DOTA set's val images."""
    from quan_ultralytics_tpu_torch.engine.model import YOLO
    from quan_ultralytics_tpu_torch.engine.predictor import Predictor

    pkl = seeded_pkl(root / "obb_seeded.pkl", MODEL, NC, names=list(data_cfg["names"].values()))
    live = YOLO(str(pkl), dtype=torch.bfloat16, device=DEVICE)
    t0 = time.perf_counter()
    pt2 = live.export(format="exported", imgsz=IMGSZ, batch=BATCH, path=str(root / "obb_bf16.pt2"))
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = YOLO(pt2, device=DEVICE)
    load_s = time.perf_counter() - t0
    ops = _graph_ops(art.model)
    check(ops == EXPORT_OPS, f"export: the .pt2's graph holds {ops}, expected {EXPORT_OPS}")
    n_nodes = sum(n.op == "call_function" for n in art.model._fn.graph.nodes)  # operator calls a run
    with torch.inference_mode():
        _reset_counts()
        got = art.model(x.float() / 255.0).float()
        torch.cuda.synchronize()
        run_n = _counts()
    check(run_n == {"qattn_fwd": 1, "qattn_fwd_with_stats": 0, "qattn_bwd": 0, "qconv1x1_fused": 37},
          f"export: the artifact's run launched {run_n}")
    ref = decoded(live.model, x)
    rel16 = compare_preds(got, ref, NC)
    unexplained = _unexplained_counts(got, ref, len(frames), nc=NC, rotated=True, conf=0.25, iou=0.45)
    print(f"export [bf16 .pt2 vs the live model]: decoded max abs err / max|ref| {rel16}; kept counts differ "
          f"unexplained on frames {unexplained}; graph {ops} of {n_nodes} operator calls; export {export_s:.1f} s, "
          f"load {load_s:.1f} s")
    check(all(v <= PRED_TOL[torch.bfloat16] for v in rel16.values()) and not unexplained,
          f"export: the bf16 artifact's predictions disagree with the live model's: {rel16}, {unexplained}")
    preds = {"artifact": Predictor(art.model, imgsz=IMGSZ), "live": Predictor(live.model, imgsz=IMGSZ)}
    for p in preds.values():
        p.infer(x)
    torch.cuda.synchronize()
    times = {k: [] for k in preds}
    for r in range(4):
        for name in (list(preds) if r % 2 == 0 else list(preds)[::-1]):
            t0 = time.perf_counter()
            for _ in range(3):
                preds[name].infer(x)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0) / 3)
    infer_ms = {k: statistics.median(v) for k, v in times.items()}
    device = {k: _device_profile(lambda p=p: p.infer(x), 3, f"export [{k}]: 3 x infer") for k, p in preds.items()}
    device = {k: {"device_ms": d["device_ms"], "device_ops": d.get("device_ops")} for k, d in device.items()}
    print(f"export: infer {infer_ms['artifact']:.2f} ms (artifact) vs {infer_ms['live']:.2f} ms (live), "
          f"bf16, batch {BATCH} @ {IMGSZ}; rounds {times}; device {device}")
    _reset_counts()
    res = art.predict(frames)  # the export path: the facade predicts from the artifact
    torch.cuda.synchronize()
    facade_n = _counts()
    check(len(res) == len(frames) and facade_n == run_n, f"export: YOLO(.pt2).predict launches {facade_n}")
    # the CLI: obb export (f32, the CLI's dtype) and obb predict from the artifact
    cli_pt2 = root / "obb_f32.pt2"
    text, cli_export_s, export_n = _cli(["obb", "export", f"model={pkl}", "format=exported", f"imgsz={IMGSZ}",
                                         f"batch={BATCH}", f"path={cli_pt2}"])
    check(f"exported: {cli_pt2}" in text and sum(export_n.values()) == 0,
          f"cli obb export: {text.strip()[-200:]}, launches {export_n} (tracing launches nothing)")
    art32 = YOLO(str(cli_pt2), device=DEVICE)
    check(_graph_ops(art32.model) == EXPORT_OPS, f"cli obb export: graph {_graph_ops(art32.model)}")
    live32 = YOLO(str(pkl), device=DEVICE)
    with torch.inference_mode():
        rel32 = compare_preds(art32.model(x.float() / 255.0).float(), decoded(live32.model, x), NC)
    print(f"export [f32 .pt2 of the CLI vs the live f32 model]: decoded max abs err / max|ref| {rel32}")
    check(all(v <= PRED_TOL[torch.float32] for v in rel32.values()),
          f"export: the f32 artifact disagrees with the live model: {rel32}")
    src = Path(data_cfg["path"]) / data_cfg["val"]
    n_images = len(list(src.glob("*.png")))
    text, cli_predict_s, cli_n = _cli(["obb", "predict", f"model={cli_pt2}", f"source={src}", "conf=0.25"])
    lines = [ln for ln in text.splitlines() if ln.startswith("image ")]
    pieces = math.ceil(n_images / BATCH)
    check(len(lines) == n_images and cli_n["qattn_fwd"] == cli_n["qattn_fwd_cuda_cores"] == pieces
          and cli_n["qconv1x1_fused"] == 37 * pieces, f"cli obb predict (.pt2): {len(lines)} lines, {cli_n}")
    check([r.verbose() for r in art32.predict(str(src), conf=0.25)] == [ln.split(" ", 3)[3] for ln in lines],
          "cli obb predict (.pt2): the lines differ from the facade's predictions")
    return {"graph_ops": ops, "graph_calls": n_nodes, "launches": facade_n, "launches_run": run_n, "export_s": export_s,
            "load_s": load_s, "bf16_vs_live": rel16, "f32_vs_live": rel32, "infer_ms": infer_ms, "device": device,
            "infer_ms_rounds": times, "cli_export_s": cli_export_s, "cli_predict_s": cli_predict_s,
            "launches_cli": {k: export_n[k] + cli_n[k] for k in cli_n}}


def phase_embed(root: Path, frames):
    """``YOLO.embed`` of QUAN-YOLO11n-OBB's seeded bf16 weights at 1024 on the 8
    phase-3 frames (layer len(specs) - 2), with K1 + K3 (the facade's default)
    against the plain attention and unfused convs on the same weights."""
    from quan_ultralytics_tpu_torch.engine.model import YOLO

    pkl = root / "obb_seeded.pkl"
    fused = YOLO(str(pkl), dtype=torch.bfloat16, device=DEVICE)
    plain = YOLO(str(pkl), dtype=torch.bfloat16, device=DEVICE, fused_1x1=False)
    plain_attention(plain.model)
    fused.embed(frames[:1], imgsz=IMGSZ)  # warm up
    _reset_counts()
    t0 = time.perf_counter()
    got = fused.embed(frames, imgsz=IMGSZ)  # the embed path, driven once
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    got_n = _counts()
    check(got_n == {"qattn_fwd": 1, "qattn_fwd_with_stats": 0, "qattn_bwd": 0, "qconv1x1_fused": 37},
          f"embed: launches {got_n}")
    _reset_counts()
    ref = plain.embed(frames, imgsz=IMGSZ)
    check(sum(_counts().values()) == 0, f"embed [plain]: launched {_counts()}")
    rel = float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6))
    print(f"embed: [{len(frames)}, {got.shape[1]}] in {ms:.1f} ms at {IMGSZ}, bf16; K1+K3 vs plain max abs err / "
          f"max|ref| {rel:.2e}; launches {got_n}")
    check(got.shape == ref.shape == (len(frames), got.shape[1]) and np.isfinite(got).all()
          and rel <= PRED_TOL[torch.bfloat16], f"embed: {got.shape}, rel {rel}")
    return {"launches": got_n, "ms": ms, "dim": int(got.shape[1]), "rel_err_vs_plain": rel}


def phase_tune(root: Path, det_cfg):
    """``YOLO.tune`` of QUAN-YOLO11n (the facade of its seeded checkpoint) on the
    16-image detect set at 640: TUNE_ITERS iterations of TUNE_EPOCHS epoch each
    (batch 8, nbs 8: an update a micro-step; bf16 steps, f32 validation), launches
    counted (K1 and K2 a micro-step, K1 and K3 a validation batch), seconds an
    iteration; then ``detect tune`` of one iteration through the CLI."""
    from quan_ultralytics_tpu_torch.engine.model import YOLO

    data = write_data_yaml(det_cfg, root / "coco_tune.yaml")
    pkl = seeded_pkl(root / "tune_seeded.pkl", DET_MODEL, DET_NC, names=list(det_cfg["names"].values()))
    n_images = len(DET_SIZES)
    steps, n_val, k3 = n_images // BATCH, math.ceil(n_images / BATCH), default_k3_sites(DET_MODEL, DET_NC)

    def expect(iters):
        return {"qattn_fwd": iters * TUNE_EPOCHS * (steps + n_val), "qattn_fwd_with_stats": iters * TUNE_EPOCHS * steps,
                "qattn_bwd": iters * TUNE_EPOCHS * steps, "qconv1x1_fused": iters * TUNE_EPOCHS * n_val * k3}

    y = YOLO(str(pkl), device=DEVICE)
    _reset_counts()
    t0 = time.perf_counter()
    best = y.tune(str(data), iterations=TUNE_ITERS, epochs=TUNE_EPOCHS, imgsz=DET_IMGSZ, batch=BATCH, nbs=BATCH,
                  save_dir=str(root / "tune"))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = _counts()
    hist = json.loads((root / "tune" / "tune_results.json").read_text())
    print(f"tune: {TUNE_ITERS} iterations in {secs:.1f} s ({secs / TUNE_ITERS:.1f} s an iteration); fitness "
          f"{[h['fitness'] for h in hist]}; launches {got}; best {best}")
    check(got == expect(TUNE_ITERS), f"tune: launches {got} != {expect(TUNE_ITERS)}")
    check(len(hist) == TUNE_ITERS and all(math.isfinite(h["fitness"]) for h in hist)
          and (root / "tune" / "best_hyperparameters.json").exists(), f"tune: history {hist}")
    text, cli_s, cli_n = _cli(["detect", "tune", f"model={pkl}", f"data={data}", "iterations=1",
                               f"epochs={TUNE_EPOCHS}", f"imgsz={DET_IMGSZ}", f"batch={BATCH}", f"nbs={BATCH}",
                               f"save_dir={root / 'tune_cli'}"])
    check(cli_n == {**expect(1), "qattn_fwd_tensor_cores": TUNE_EPOCHS * steps,
                    "qattn_fwd_cuda_cores": TUNE_EPOCHS * n_val}
          and "lr0" in text.strip().splitlines()[-1], f"cli detect tune: launches {cli_n}")
    return {"launches": got, "seconds": secs, "s_an_iteration": secs / TUNE_ITERS,
            "fitness": [h["fitness"] for h in hist], "cli_s": cli_s, "launches_cli": cli_n}


def phase_autobatch():
    """`utils.autobatch.auto_batch` of QUAN-YOLO11n-OBB on the card at 640 and 1024:
    the memory it reads is the card's."""
    from quan_ultralytics_tpu_torch.models.tasks import DetectionModel
    from quan_ultralytics_tpu_torch.utils.autobatch import auto_batch, device_hbm_bytes

    m = DetectionModel.from_yaml(MODEL, nc=NC, device=DEVICE)
    hbm = device_hbm_bytes()
    picks = {size: auto_batch(m, size) for size in (640, 1024)}
    print(f"autobatch: {hbm / 2 ** 30:.1f} GiB on the card; batch {picks[640]} at 640, {picks[1024]} at 1024")
    check(hbm == torch.cuda.get_device_properties(0).total_memory, f"autobatch: memory {hbm}")
    check(all(p >= 1 and p & (p - 1) == 0 for p in picks.values()) and picks[640] >= picks[1024],
          f"autobatch: picks {picks}")
    return {"hbm_bytes": hbm, "batch": picks}


def phase_cli_track_benchmark(root: Path):
    """``detect track`` of the clip (the facade's default tracker, ByteTrack; f32, K1
    and K3 a frame) and ``detect benchmark`` at 640 (bf16, 2 timed calls) through
    the CLI, in this process."""
    pkl = root / "track_seeded.pkl"
    k3 = default_k3_sites(DET_MODEL, DET_NC)
    text, track_s, track_n = _cli(["detect", "track", f"model={pkl}", f"source={root / 'clip'}",
                                   f"imgsz={DET_IMGSZ}"])
    lines = [ln for ln in text.splitlines() if ln.startswith("frame ")]
    check(len(lines) == TRACK_FRAMES and track_n["qattn_fwd"] == track_n["qattn_fwd_cuda_cores"] == TRACK_FRAMES
          and track_n["qconv1x1_fused"] == TRACK_FRAMES * k3, f"cli detect track: {len(lines)} lines, {track_n}")
    from quan_ultralytics_tpu_torch.utils.benchmarks import WARMUP

    text, bench_s, bench_n = _cli(["detect", "benchmark", f"model={DET_MODEL}", f"imgsz={DET_IMGSZ}",
                                   f"batch={BATCH}", "iters=2", f"nc={DET_NC}"])
    table = text.strip().splitlines()
    print("\n".join(table))
    check(len(table) == 2 and table[1].split()[:4] == [DET_MODEL, str(DET_IMGSZ), "bfloat16", str(BATCH)]
          and bench_n["qattn_fwd"] == WARMUP + 2 and bench_n["qconv1x1_fused"] == (WARMUP + 2) * k3,
          f"cli detect benchmark: {table}, {bench_n}")
    return {"track_s": track_s, "launches_track": track_n, "benchmark_s": bench_s, "launches_benchmark": bench_n}




# ---------------------------------------------------------------- phases 42-46


VIS_LAYERS = 23  # QUAN-YOLO11n-OBB layers 0-22 return one tensor each; the head (23) a tuple
PLOT_LABELS = (50, 200)  # OBB rows a 1024 frame's plot is timed with (DOTA tiles hold tens to hundreds)


def _reference_state_dict(model, prefix_fn, seed: int, dense=()):
    """A state dict in the PyTorch reference's names and layouts, drawn from
    ``seed`` with numpy: each flax leaf of ``model`` (`export_jax_variables`)
    drawn as the tests draw JAX variables (QConv2D weights U(-b, b), b =
    sqrt(3 / fan_in) / 2; QER kernels b = sqrt(3 / fan_in); IQBN gamma, var
    U(0.5, 1.5), beta, mean N(0, 0.1); QConv2D biases N(0, 0.1), QER biases
    N(0, 1)), then put in the reference's layout under ``prefix_fn``'s name
    by `utils.torch_port.to_reference_state_dict`. Returns (state dict, the
    drawn flax leaves by path)."""
    from quan_ultralytics_tpu_torch.utils.torch_port import to_reference_state_dict
    from quan_ultralytics_tpu_torch.utils.weights import _flatten, export_jax_variables

    rng = np.random.default_rng(seed)
    drawn, tree = {}, {}
    for coll, leaves in export_jax_variables(model).items():
        for path, leaf in _flatten(leaves).items():
            parent, name, shape = path[:-1], path[-1], leaf.shape
            if name == "w":
                v = rng.uniform(-1, 1, shape) * math.sqrt(3.0 / max(int(np.prod(shape[1:-1])), 1)) / 2
            elif name == "kernel":
                v = rng.uniform(-1, 1, shape) * math.sqrt(3.0 / max(int(np.prod(shape[:-1])), 1))
            elif name in ("gamma", "var"):
                v = rng.uniform(0.5, 1.5, shape)
            elif name == "bias" and parent[-1] in ("proj", "mix"):
                v = rng.normal(size=shape)
            else:
                v = rng.normal(size=shape) * 0.1
            drawn[path] = v.astype(np.float32)
            node = tree.setdefault(coll, {})
            for key in parent:
                node = node.setdefault(key, {})
            node[name] = drawn[path]
    return to_reference_state_dict(tree, prefix_fn, dense), drawn


def phase_predict_save(root: Path, frames, card: str):
    """42. ``obb predict save=True visualize=<dir>`` through ``cli.main`` on the 8
    phase-3 frames (PNG) from the seeded OBB checkpoint at 1024 (the CLI gives no
    dtype: f32, K1 and K3 on the CUDA cores): every ``im{i}.jpg`` read back by the
    port's JPEG reader at its frame's size, one ``stage{i}_*_features.png`` a layer
    in each ``im{i}`` directory. Then the facade in bf16 (K1 and K3 on the tensor
    cores): ``predict`` and ``predict(visualize=)`` of the 8 frames (the grids' s
    by difference), and the 1024 x 1024 frame's ``Results.plot`` split into
    drawing and JPEG encoding, with its own detections and with PLOT_LABELS
    seeded rotated boxes."""
    from quan_ultralytics_tpu_torch.data.native import native
    from quan_ultralytics_tpu_torch.engine.model import YOLO
    from quan_ultralytics_tpu_torch.engine.predictor import Results

    src = root / "plot_frames"
    src.mkdir()
    for i, f in enumerate(frames):
        native.imwrite_png(src / f"f{i}.png", f)
    pkl = root / "obb_seeded.pkl"
    _, cli_s, cli_n = _cli(["obb", "predict", f"model={pkl}", f"source={src}", f"imgsz={IMGSZ}", "save=True",
                            f"save_dir={root / 'pred_save'}", f"visualize={root / 'vis'}"])
    check(cli_n["qattn_fwd"] > 0 and cli_n["qconv1x1_fused"] > 0, f"predict save: launches {cli_n}")
    for i, f in enumerate(frames):
        im = native.imread(root / "pred_save" / f"im{i}.jpg")
        check(im.shape == f.shape, f"im{i}.jpg is {im.shape}, its frame {f.shape}")
        grids = sorted((root / "vis" / f"im{i}").glob("stage*_features.png"))
        check(len(grids) == VIS_LAYERS and all(native.imread(g).shape[2] == 3 for g in grids[:2]),
              f"im{i}: {len(grids)} feature grids")
    y = YOLO(str(pkl), dtype=torch.bfloat16, device=DEVICE)
    y.predict(frames[:1], imgsz=IMGSZ)  # warm up
    _reset_counts()
    t0 = time.perf_counter()
    res = y.predict(frames, imgsz=IMGSZ)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    pred_n = _counts()
    _reset_counts()
    t0 = time.perf_counter()
    y.predict(frames, imgsz=IMGSZ, visualize=root / "vis_bf16")
    torch.cuda.synchronize()
    vis_total_s = time.perf_counter() - t0
    vis_n = _counts()
    check(pred_n["qattn_fwd"] == 1 and pred_n["qconv1x1_fused"] == 37, f"predict [plot]: launches {pred_n}")
    check(vis_n["qattn_fwd"] == 2 and vis_n["qconv1x1_fused"] == 74, f"predict [visualize]: launches {vis_n}")
    r = res[0]
    check(r.orig_shape == (1024, 1024), f"frame 0 is {r.orig_shape}")
    draw, enc = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        out = r.plot()
        draw.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        data = native.encode_jpeg(out)
        enc.append(1e3 * (time.perf_counter() - t0))
    check(out.shape == (1024, 1024, 3) and data[:2] == b"\xff\xd8", "Results.plot of frame 0")
    # DOTA-like label loads on the same frame: rows drawn from a seed (centres
    # inside the frame, sides 12-90 px, any angle, conf 0.25-1, NC classes)
    rng = np.random.default_rng(5)
    by_labels = {}
    for n_rows in PLOT_LABELS:
        rows = np.concatenate([rng.uniform(40, 984, (n_rows, 2)), rng.uniform(12, 90, (n_rows, 2)),
                               rng.uniform(0, np.pi, (n_rows, 1)), rng.uniform(0.25, 1, (n_rows, 1)),
                               rng.integers(0, NC, (n_rows, 1))], 1).astype(np.float32)
        rr = Results(orig_shape=r.orig_shape, boxes=rows, names=r.names, task="obb", orig_img=r.orig_img)
        d_ms, e_ms = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            o = rr.plot()
            d_ms.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            native.encode_jpeg(o)
            e_ms.append(1e3 * (time.perf_counter() - t0))
        check(o.shape == (1024, 1024, 3) and not np.array_equal(o, out), f"Results.plot of {n_rows} labels")
        by_labels[n_rows] = {"draw_ms": statistics.median(d_ms), "jpeg_ms": statistics.median(e_ms)}
    out_d = {"cli_s": cli_s, "launches_cli": cli_n, "launches_predict": pred_n, "launches_visualize": vis_n,
             "predict_s": pred_s, "visualize_s": vis_total_s - pred_s, "detections": [len(q) for q in res],
             "plot_draw_ms": statistics.median(draw), "plot_jpeg_ms": statistics.median(enc),
             "jpeg_bytes": len(data), "plot_by_labels": by_labels}
    print(f"predict save: obb predict save=True visualize= (f32) in {cli_s:.1f} s, {len(frames)} im*.jpg and "
          f"{VIS_LAYERS} grids each, launches {cli_n}; bf16 facade: predict {pred_s:.3f} s, visualize adds "
          f"{out_d['visualize_s']:.3f} s; a 1024 frame's plot ({len(r)} detections): draw "
          f"{out_d['plot_draw_ms']:.1f} ms + JPEG {out_d['plot_jpeg_ms']:.1f} ms ({len(data)} bytes); "
          + "; ".join(f"{n} labels: draw {v['draw_ms']:.1f} ms + JPEG {v['jpeg_ms']:.1f} ms"
                      for n, v in by_labels.items()) + f"; {card}")
    return out_d


def phase_segpose_plot(root: Path, det_cfg, card: str):
    """43. ``Results.plot(filename=)`` of the segment (masks) and pose (keypoints)
    tasks at 640: seeded bf16 facades (K1 + K3) predict two of the detect set's
    frames at conf 0.01 (at most 30 detections a frame); the first frame's plot is
    timed and written."""
    from quan_ultralytics_tpu_torch.data.native import native
    from quan_ultralytics_tpu_torch.engine.model import YOLO

    frames, _ = det_frames(det_cfg, 2)
    out = {}
    for task, tag in (("segment", "seg"), ("pose", "pose")):
        model, nc = SEGPOSE[task]
        y = YOLO(str(seeded_pkl(root / f"{task}_plot.pkl", model, nc)), dtype=torch.bfloat16, device=DEVICE)
        _reset_counts()
        res = y.predict(frames, imgsz=DET_IMGSZ, conf=0.01, max_det=30)
        torch.cuda.synchronize()
        n = _counts()
        r = res[0]
        check(len(r) > 0 and (r.masks is not None if task == "segment" else r.keypoints is not None),
              f"{task} plot: {len(r)} detections")
        ms = []
        for k in range(3):
            t0 = time.perf_counter()
            im = r.plot(filename=str(root / f"{task}_plot{k}.jpg"))
            ms.append(1e3 * (time.perf_counter() - t0))
        check(native.imread(root / f"{task}_plot0.jpg").shape == im.shape == frames[0].shape,
              f"{task} plot written at {im.shape}")
        check(n["qattn_fwd"] == 1 and n["qconv1x1_fused"] > 0, f"{task} plot predict: launches {n}")
        out[tag] = {"launches": n, "detections": len(r), "plot_ms": statistics.median(ms)}
        print(f"{task} plot: {len(r)} detections, Results.plot + JPEG {out[tag]['plot_ms']:.1f} ms a "
              f"{frames[0].shape[1]}x{frames[0].shape[0]} frame; launches {n}; {card}")
    return out


def phase_val_plots(det_cfg, root: Path, card: str):
    """44. ``Validator(save_dir=)`` of seeded QUAN-YOLO11n (bf16, K1 + K3) on the
    detect set at 640: the six images (four curves at 1800 x 1200, both
    confusion matrices at 2400 x 1800) and per_class.txt; then the six images
    drawn again, timed. Random weights give metrics near 0: this holds the
    writers, not the metrics."""
    from quan_ultralytics_tpu_torch.data import YOLODataset
    from quan_ultralytics_tpu_torch.data.native import native
    from quan_ultralytics_tpu_torch.engine.validator import Validator

    model = seeded_model(torch.bfloat16, model=DET_MODEL, nc=DET_NC, fused_1x1=True)
    v = Validator(model, imgsz=DET_IMGSZ)
    ds = YOLODataset(det_cfg, "val")
    d = root / "val_plots"
    _reset_counts()
    v(ds, batch_size=BATCH, save_dir=str(d))
    torch.cuda.synchronize()
    n = _counts()
    sizes = {"PR_curve.png": (1200, 1800), "F1_curve.png": (1200, 1800), "P_curve.png": (1200, 1800),
             "R_curve.png": (1200, 1800), "confusion_matrix.png": (1800, 2400),
             "confusion_matrix_normalized.png": (1800, 2400)}
    for name, hw in sizes.items():
        check((d / name).exists() and native.imread(d / name).shape[:2] == hw, f"val save_dir: {name}")
    check((d / "per_class.txt").exists(), "val save_dir: per_class.txt")
    t0 = time.perf_counter()
    v.metrics.plot(root / "val_plots2", ds.names)
    v.confusion.plot(root / "val_plots2", ds.names, normalize=False)
    v.confusion.plot(root / "val_plots2", ds.names, normalize=True)
    six_s = time.perf_counter() - t0
    check(n["qattn_fwd"] > 0 and n["qconv1x1_fused"] > 0, f"val plots: launches {n}")
    print(f"val plots: the six images written ({', '.join(sizes)}), drawn again in {six_s:.2f} s; "
          f"launches {n}; {card}")
    return {"launches": n, "six_images_s": six_s}


def phase_autoaugment(cifar: Path, tmp: Path, cls_cifar, card: str):
    """45. ``--autoaugment``: one epoch of Q-WRN-16-2 on the CIFAR folder (batch
    128) through the classification CLI without and with the flag (each writes
    ``curves.png``), and AutoAugment of 128 CIFAR images on the host against
    phase 24's bf16 step."""
    from quan_ultralytics_tpu_torch.classification.cli import main as cls_main
    from quan_ultralytics_tpu_torch.classification.data import autoaugment, load_cifar
    from quan_ultralytics_tpu_torch.data.native import native

    common = ["--model", "qwrn16_2", "--dataset", "cifar10", "--data_dir", str(cifar),
              "--batch_size", str(CLS_CIFAR_BATCH), "--epochs", "1"]
    secs = {}
    for tag, flag in (("plain", []), ("autoaugment", ["--autoaugment"])):
        _, secs[tag], _ = _cli(common + ["--exp_dir", str(tmp / f"aa_{tag}")] + flag, cls_main)
        run = _only_run(tmp / f"aa_{tag}")
        rows = json.loads((run / "metrics.json").read_text())
        check(len(rows) == 1 and math.isfinite(rows[0]["train_loss"]), f"{tag} epoch: {rows}")
        check(native.imread(run / "curves.png").ndim == 3, f"{tag}: curves.png")
    tx, _, _, _ = load_cifar(str(cifar), "cifar10")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    augmented = [autoaugment(im, rng) for im in tx[:CLS_CIFAR_BATCH]]
    aa_ms = 1e3 * (time.perf_counter() - t0)
    check(all(a.shape == (32, 32, 3) and a.dtype == np.uint8 for a in augmented), "autoaugment output")
    step_ms = cls_cifar["speed"]["step_ms"]
    print(f"autoaugment: an epoch {secs['plain']:.1f} s plain, {secs['autoaugment']:.1f} s with --autoaugment; "
          f"AutoAugment of {CLS_CIFAR_BATCH} images {aa_ms:.1f} ms on the host against a {step_ms:.2f} ms bf16 "
          f"step; {card}")
    return {"epoch_s": secs, "autoaugment_batch_ms": aa_ms, "step_ms": step_ms}


def phase_reference_weights(x, card: str):
    """46. Reference-layout checkpoints: a state dict of QUAN-YOLO11n-OBB in the
    PyTorch reference's names and layouts, drawn from a seed with numpy,
    through ``utils.torch_port.port_state_dict`` into a bf16 model with K1 + K3
    and into one on the plain path (einsum attention, unfused 1x1 convs); the
    former's ``infer`` of phase 3's batch at 1024 held to the latter's at
    PRED_TOL. Then a Q-WRN-16-2 dict through ``port_cls_state_dict``: every
    leaf carried exactly, finite logits."""
    from quan_ultralytics_tpu_torch.classification.models import create_model
    from quan_ultralytics_tpu_torch.models.tasks import DetectionModel
    from quan_ultralytics_tpu_torch.utils.torch_port import (_cls_prefix, port_cls_state_dict, port_state_dict,
                                                             torch_prefix)
    from quan_ultralytics_tpu_torch.utils.weights import _flatten, export_jax_variables

    fused = DetectionModel.from_yaml(MODEL, nc=NC, dtype=torch.bfloat16, device=DEVICE, fused_1x1=True)
    sd, _ = _reference_state_dict(fused, torch_prefix, seed=11)
    t0 = time.perf_counter()
    port_state_dict(sd, fused)
    port_s = time.perf_counter() - t0
    plain = plain_attention(DetectionModel.from_yaml(MODEL, nc=NC, dtype=torch.bfloat16, device=DEVICE,
                                                     fused_1x1=False))
    port_state_dict(sd, plain)
    fused.eval()
    plain.eval()
    _reset_counts()
    got = decoded(fused, x)
    torch.cuda.synchronize()
    n = _counts()
    _reset_counts()
    ref = decoded(plain, x)
    check(sum(_counts().values()) == 0, f"reference weights [plain]: launched {_counts()}")
    rel = compare_preds(got, ref, NC)
    check(n["qattn_fwd"] == 1 and n["qconv1x1_fused"] == 37, f"reference weights: launches {n}")
    check(bool(torch.isfinite(got).all()) and all(v <= PRED_TOL[torch.bfloat16] for v in rel.values()),
          f"reference weights: K1+K3 vs plain {rel}")
    cls = create_model("qwrn16_2", 10).to(DEVICE)
    csd, drawn = _reference_state_dict(cls, lambda parent: _cls_prefix(parent, "wrn_cifar"), seed=12,
                                       dense=("classifier",))
    t0 = time.perf_counter()
    port_cls_state_dict(csd, cls)
    cls_port_s = time.perf_counter() - t0
    carried = {p: a for tree in export_jax_variables(cls).values() for p, a in _flatten(tree).items()}
    check(carried.keys() == drawn.keys() and all(np.array_equal(carried[p], drawn[p]) for p in drawn),
          "qwrn16_2: a carried leaf differs from the drawn one")
    with torch.no_grad():
        logits = cls.eval()(torch.from_numpy(np.random.default_rng(0).normal(size=(8, 32, 32, 3))
                                             .astype(np.float32)).to(DEVICE))
    check(logits.shape == (8, 10) and bool(torch.isfinite(logits).all()), f"qwrn16_2 logits {logits.shape}")
    print(f"reference weights: OBB dict of {len(sd)} tensors ported in {port_s:.2f} s; infer at {IMGSZ} K1+K3 vs "
          f"plain {rel}, launches {n}; qwrn16_2 dict of {len(csd)} tensors in {cls_port_s:.3f} s, every leaf "
          f"exact; {card}")
    return {"launches": n, "port_s": port_s, "cls_port_s": cls_port_s, "rel_err_vs_plain": rel,
            "n_tensors": len(sd)}


# ---------------------------------------------------------------- phases 47-52

DP_TIMEOUT_S = 420.0  # the two-rank phases' deadline: ranks still running then are killed, the phase fails
# tests/test_mesh.py:77-82 (f32): the loss within DP_LOSS_RTOL, every parameter and IQBN statistic
# within DP_RTOL |ref| + DP_ATOL (the ranks' sums and the single process's differ in order only)
DP_LOSS_RTOL, DP_RTOL, DP_ATOL = 2e-5, 1e-3, 2e-5
# at 1024 a single process's own update moves by more than those tolerances when its rows
# are summed in another order (model.0.bn.beta: 1.34 of them at 128 on the CPU, the
# bias group's warm-up lr 0.1 on a gradient of cancelling terms): the ranks are held within
# max(1, DP_NOISE times that reorder excess)
DP_NOISE = 2.0
DP_NCCL_STEPS = 8  # micro-steps of the NCCL phase: one update at accumulate 8
CLS_DP_BATCH = 128  # Q-WRN-16-2's global batch (the recipe's), 64 a rank
SPLIT_SIZE = (4000, 4000)  # (h, w): a large DOTA-v1.0 scene (800 to 4000 px a side)
SPLIT_LABELS = 200  # objects in it (DOTA-v1.0's densest scenes hold hundreds)


def _trainer_state(trainer):
    """The parameters and IQBN statistics of ``trainer`` as float32 numpy arrays by name."""
    out = {f"p:{n}": p.detach().float().cpu().numpy() for n, p in zip(trainer.param_names, trainer.params)}
    bufs = [n for n, _ in trainer.model.named_buffers() if n in trainer.model.state_dict()]
    out.update({f"s:{n}": b.float().cpu().numpy() for n, b in zip(bufs, trainer.stats)})
    return out


def _state_excess(got, ref):
    """max over leaves of |got - ref| / (DP_ATOL + DP_RTOL |ref|) (at most 1 is within
    tolerance), and the leaf where it is largest."""
    worst = max(((float(np.max(np.abs(got[k] - ref[k]) / (DP_ATOL + DP_RTOL * np.abs(ref[k])))), k) for k in ref),
                default=(0.0, None))
    return worst


def _same_detections(a, b, tol: float = RESULT_TOL):
    """Whether two lists of Results-box arrays hold the same rows, frame by frame, in any order."""
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return False
        if len(ra):
            d = np.abs(ra[:, None, :] - rb[None, :, :]).max(-1)
            if not ((d.min(1) <= tol).all() and (d.min(0) <= tol).all()):
                return False
    return len(a) == len(b)


def cls_dp_batch(seed: int = 5):
    """A seeded CIFAR-shaped batch of CLS_DP_BATCH normalized images and labels."""
    rng = np.random.default_rng(seed)
    return {"img": rng.normal(size=(CLS_DP_BATCH, 32, 32, 3)).astype(np.float32),
            "label": rng.integers(0, 10, CLS_DP_BATCH).astype(np.int64)}


def _dp_rank(rank: int, device: str, imgsz: int, data_cfg) -> dict:
    """One rank of phases 48-50 (two ranks on one card over gloo): the f32 OBB train
    step on its rows of phase 5's batch, the Validator and the Predictor sharded,
    and one Q-WRN-16-2 update on its rows; each with its launches."""
    global DEVICE, IMGSZ
    DEVICE, IMGSZ = device, imgsz  # this process's copy of the script's settings
    from quan_ultralytics_tpu_torch.classification.train import ClsConfig, ClsTrainer
    from quan_ultralytics_tpu_torch.data import YOLODataset
    from quan_ultralytics_tpu_torch.engine.predictor import Predictor
    from quan_ultralytics_tpu_torch.engine.validator import Validator
    from quan_ultralytics_tpu_torch.parallel.mesh import make_mesh, shard_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(2, device=device)
    out = {"rank": mesh.rank}
    tr = make_trainer(torch.float32, nbs=BATCH, mesh=mesh)
    rows = shard_batch(mesh, make_train_batch(0))
    _reset_counts()
    t0 = time.perf_counter()
    loss, _ = tr.step(rows)
    _sync()
    out["train"] = {"loss": float(loss), "seconds": time.perf_counter() - t0, "launches": _counts(),
                    "state": _trainer_state(tr)}
    del tr, rows
    model = seeded_model(torch.float32, fused_1x1=True)
    ds = YOLODataset(data_cfg, "val", task="obb")
    _reset_counts()
    t0 = time.perf_counter()
    metrics = Validator(model, imgsz=imgsz, conf=VAL_CONF, mesh=mesh)(ds, batch_size=BATCH)
    out["val"] = {"metrics": metrics, "seconds": time.perf_counter() - t0, "launches": _counts()}
    _reset_counts()
    t0 = time.perf_counter()
    res = Predictor(model, imgsz=imgsz, conf=0.05, mesh=mesh)(make_frames(0))
    out["predict"] = {"boxes": [r.boxes for r in res], "seconds": time.perf_counter() - t0,
                      "launches": _counts()}
    del model
    ct = ClsTrainer(ClsConfig(model="qwrn16_2", dtype="float32", batch_size=CLS_DP_BATCH), 10,
                    device=device, mesh=mesh)
    t0 = time.perf_counter()
    loss, acc = ct.train_step(shard_batch(mesh, cls_dp_batch()))
    _sync()
    out["cls"] = {"loss": float(loss), "acc": float(acc), "seconds": time.perf_counter() - t0,
                  "state": {n: p.detach().float().cpu().numpy() for n, p in ct.model.state_dict().items()}}
    return out


def _sync():
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


def phase_dp_nccl(batch, card: str):
    """47. Data parallelism over NCCL at world size 1 on the card: 8 bf16 micro-steps
    (one update) of the OBB train step at 1024, batch 8, through ``Trainer(mesh=)``
    (IQBN moments, loss normalisers and gradients through NCCL's collectives)
    against the same Trainer without a mesh. bf16: differences printed, not held."""
    import datetime

    import torch.distributed as dist

    from quan_ultralytics_tpu_torch.parallel import distributed
    from quan_ultralytics_tpu_torch.parallel.mesh import make_mesh

    backend = distributed.default_backend(DEVICE)
    distributed.initialize(backend=backend, init_method=f"tcp://localhost:{distributed.free_port()}",
                           world_size=1, rank=0, timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    try:
        mesh = make_mesh(1, device=DEVICE)
        runs = {}
        for name, m in (("single", None), (backend, mesh)):
            tr = make_trainer(torch.bfloat16, mesh=m)
            _reset_counts()
            losses, ms = [], []
            for _ in range(DP_NCCL_STEPS):
                t0 = time.perf_counter()
                losses.append(tr.step(batch)[0])
                _sync()
                ms.append(1e3 * (time.perf_counter() - t0))
            runs[name] = {"losses": [float(v) for v in losses], "launches": _counts(),
                          # the first micro-step of each run picks cuDNN's algorithms: left out
                          "ms_a_micro_step": statistics.median(ms[1:]), "ms_steps": ms,
                          "state": _trainer_state(tr), "updates": tr.opt.count}
            del tr
    finally:
        dist.destroy_process_group()
    a, b = runs[backend], runs["single"]
    loss_rel = max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a["losses"], b["losses"]))
    excess, leaf = _state_excess(a["state"], b["state"])
    print(f"dp {backend} (world 1, bf16): a micro-step {a['ms_a_micro_step']:.1f} ms (median of 2-{DP_NCCL_STEPS}) "
          f"against {b['ms_a_micro_step']:.1f} without a mesh; loss max rel diff {loss_rel:.2e}, state excess "
          f"{excess:.3g} at {leaf} (bf16: printed, not held); launches {a['launches']}; {card}")
    check(all(math.isfinite(v) for v in a["losses"]) and a["updates"] == b["updates"] == 1,
          f"dp {backend}: losses {a['losses']}, updates {a['updates']}")
    check(a["launches"]["qattn_fwd"] == DP_NCCL_STEPS and a["launches"]["qattn_bwd"] == DP_NCCL_STEPS,
          f"dp {backend}: launches {a['launches']}")
    for r in runs.values():
        del r["state"]
    return {"backend": backend, "runs": runs, "loss_max_rel_diff": loss_rel, "state_excess": excess,
            "launches": a["launches"]}


def phase_dp_gloo(data_cfg, card: str):
    """48-50. Two ranks on one card over gloo (NCCL refuses two ranks on one
    card), each naming the card itself, started by ``parallel.distributed.launch``
    under DP_TIMEOUT_S: (48) one f32 update of the OBB train step at 1024, ranks
    of batch 4 against one process of batch 8 (loss, parameters, IQBN
    statistics within tests/test_mesh.py's tolerances; the ranks' states
    bitwise equal; K1 and K2 on each rank); (49) the Validator and the
    Predictor sharded on phase 7's set and phase 3's frames in f32 with K1 + K3,
    gathered detections and metrics against the single process's; (50) one
    Q-WRN-16-2 update at batch 128 against one process."""
    from quan_ultralytics_tpu_torch.classification.train import ClsConfig, ClsTrainer
    from quan_ultralytics_tpu_torch.data import YOLODataset
    from quan_ultralytics_tpu_torch.engine.predictor import Predictor
    from quan_ultralytics_tpu_torch.engine.validator import Validator
    from quan_ultralytics_tpu_torch.parallel import distributed

    dev = torch.device(DEVICE)
    shared = f"cuda:{dev.index or 0}" if dev.type == "cuda" else str(dev)  # both ranks name the one card
    t0 = time.perf_counter()
    ranks = distributed.launch(_dp_rank, 2, args=(shared, IMGSZ, data_cfg), backend="gloo", timeout_s=DP_TIMEOUT_S)
    launch_s = time.perf_counter() - t0
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # 48: the single-process step on the global batch, and on its rows in another order: the
    # single process's own reduction-order noise, which no sharded run can undercut
    batch = make_train_batch(0)
    states = []
    for order in (torch.arange(BATCH), torch.arange(BATCH).roll(BATCH // 2)):
        tr = make_trainer(torch.float32, nbs=BATCH)
        loss, _ = tr.step({k: v[order.to(v.device)] for k, v in batch.items()})
        states.append((float(loss), _trainer_state(tr)))
        del tr
    (ref_loss, ref_state), (_, rolled) = states
    noise, noise_leaf = _state_excess(rolled, ref_state)
    limit = max(1.0, DP_NOISE * noise)
    print(f"dp gloo: the single process against itself with its rows reordered: state excess {noise:.3g} "
          f"at {noise_leaf}; the ranks are held within {limit:.3g} tolerances")
    out = {"launch_s": launch_s, "ranks": [], "reorder_excess": noise, "limit": limit}
    for r in ranks:
        t = r["train"]
        excess, leaf = _state_excess(t["state"], ref_state)
        rel = abs(t["loss"] - ref_loss) / abs(ref_loss)
        print(f"dp gloo rank {r['rank']} (f32, batch 4 of 8): loss {t['loss']:.6f} against {ref_loss:.6f} "
              f"(rel {rel:.2e}), state excess {excess:.3g} at {leaf}, step {t['seconds']:.2f} s, "
              f"launches {t['launches']}")
        check(rel <= DP_LOSS_RTOL, f"dp gloo rank {r['rank']}: loss {t['loss']} against {ref_loss}")
        check(excess <= limit, f"dp gloo rank {r['rank']}: {leaf} off the single process's by {excess:.3g} tolerances")
        check(t["launches"]["qattn_fwd"] == 1 and t["launches"]["qattn_bwd"] == 1,
              f"dp gloo rank {r['rank']}: launches {t['launches']}")
        out["ranks"].append({"rank": r["rank"], "loss_rel": rel, "state_excess": excess, "step_s": t["seconds"],
                             "launches_train": t["launches"], "launches_val": r["val"]["launches"],
                             "launches_predict": r["predict"]["launches"], "val_s": r["val"]["seconds"],
                             "predict_s": r["predict"]["seconds"], "cls_step_s": r["cls"]["seconds"]})
    a, b = (r["train"]["state"] for r in ranks)
    check(all(np.array_equal(a[k], b[k]) for k in a), "dp gloo: the ranks' parameters or statistics differ")
    # 49: sharded val and predict against the single process
    model = seeded_model(torch.float32, fused_1x1=True)
    ref_metrics = Validator(model, imgsz=IMGSZ, conf=VAL_CONF)(YOLODataset(data_cfg, "val", task="obb"),
                                                               batch_size=BATCH)
    ref_boxes = [res.boxes for res in Predictor(model, imgsz=IMGSZ, conf=0.05)(make_frames(0))]
    del model
    for r in ranks:
        m = r["val"]["metrics"]
        diff = max(abs(m[k] - ref_metrics[k]) for k in ref_metrics)
        print(f"dp gloo rank {r['rank']}: sharded val {m} (max diff {diff:.2e} from one process), "
              f"{r['val']['seconds']:.1f} s; predict {[len(x) for x in r['predict']['boxes']]} boxes "
              f"({[len(x) for x in ref_boxes]} in one process); launches val {r['val']['launches']}, "
              f"predict {r['predict']['launches']}")
        check(diff <= VAL_METRIC_TOL, f"dp gloo rank {r['rank']}: metrics {m} against {ref_metrics}")
        check(_same_detections(r["predict"]["boxes"], ref_boxes),
              f"dp gloo rank {r['rank']}: sharded predict differs from one process's")
        for what in ("val", "predict"):
            n = r[what]["launches"]
            check(n["qattn_fwd"] > 0 and n["qconv1x1_fused"] > 0, f"dp gloo rank {r['rank']} {what}: launches {n}")
    out["val_metrics"], out["val_metrics_single"] = ranks[0]["val"]["metrics"], ref_metrics
    # 50: Q-WRN-16-2, two ranks of 64 against one of 128
    ct = ClsTrainer(ClsConfig(model="qwrn16_2", dtype="float32", batch_size=CLS_DP_BATCH), 10, device=DEVICE)
    loss, acc = ct.train_step(cls_dp_batch())
    ref = {n: p.detach().float().cpu().numpy() for n, p in ct.model.state_dict().items()}
    for r in ranks:
        c = r["cls"]
        excess, leaf = _state_excess(c["state"], ref)
        rel = abs(c["loss"] - float(loss)) / abs(float(loss))
        print(f"dp gloo rank {r['rank']}: Q-WRN-16-2 loss {c['loss']:.6f} against {float(loss):.6f} (rel {rel:.2e}), "
              f"state excess {excess:.3g} at {leaf}, step {c['seconds']:.2f} s")
        check(rel <= DP_LOSS_RTOL and excess <= 1.0 and abs(c["acc"] - float(acc)) < 1e-6,
              f"dp gloo rank {r['rank']}: Q-WRN-16-2 off the single process (loss rel {rel}, {leaf} {excess})")
    print(f"dp gloo: two ranks on one card in {launch_s:.1f} s (start, build load, three paths); {card}")
    return out


def phase_int8(x, frames, card: str, tables=None, rounds: int = 3):
    """51. int8 serving (``impl="int8"``, calibrated on the 8 frames) of the OBB model at
    1024, batch 8: every int8 conv's int32 accumulator on the card (``torch._int_mm``)
    equal to its plain version (an exact float64 product), the widest layer's also to
    the plain CPU version; device busy ms and host ms of ``infer`` with fused_1x1 on
    and off against bf16 and f32 ``auto``; the share of bf16's kept boxes that int8
    keeps (printed: random weights); launches of K1 and K3 (37 with fused_1x1)."""
    from quan_ultralytics_tpu_torch.engine.predictor import Predictor
    from quan_ultralytics_tpu_torch.models import conv as conv_mod
    from quan_ultralytics_tpu_torch.ops import qconv as qc
    from quan_ultralytics_tpu_torch.ops.quant import calibrate_int8

    bf16 = torch.bfloat16
    arms = {"int8 fused_1x1": seeded_model(bf16, impl="int8", fused_1x1=True),
            "int8": seeded_model(bf16, impl="int8"),
            "bf16 auto": seeded_model(bf16, fused_1x1=True),
            "f32 auto": seeded_model(torch.float32, fused_1x1=True)}
    t0 = time.perf_counter()
    for name in ("int8 fused_1x1", "int8"):
        calibrate_int8(arms[name], [x])
    calib_s = (time.perf_counter() - t0) / 2
    n_scales = sum(1 for n, _ in arms["int8"].named_buffers() if n.endswith("act_absmax"))
    # every int8 conv's operands, recorded through one infer of the unfused arm
    calls, original = [], conv_mod.qconv2d_int8

    def record(x_, dk, b=None, **kw):
        calls.append((x_, dk, kw))
        return original(x_, dk, b, **kw)

    conv_mod.qconv2d_int8 = record
    try:
        Predictor(arms["int8"], imgsz=IMGSZ).infer(x)
    finally:
        conv_mod.qconv2d_int8 = original
    mismatched = [i for i, (x_, dk, kw) in enumerate(calls)
                  if not torch.equal(qc.int8_accumulator(x_, dk, **kw)[0],
                                     qc.int8_accumulator(x_, dk, matmul=qc.int8_matmul_plain, **kw)[0])]
    check(calls and not mismatched, f"int8: the card's accumulator differs from the plain one at convs {mismatched}")
    widest = max(range(len(calls)), key=lambda i: calls[i][1].shape[0] * calls[i][1][0].numel())
    x_, dk, kw = calls[widest]
    kw_cpu = {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
    acc_cpu = qc.int8_accumulator(x_.cpu(), dk.cpu(), **kw_cpu)[0]
    check(torch.equal(qc.int8_accumulator(x_, dk, **kw)[0].cpu(), acc_cpu),
          "int8: the widest layer's accumulator differs from the plain CPU version")
    widths = sorted({(tuple(dk_.shape), tuple(x__.shape[:3])) for x__, dk_, _ in calls})
    print(f"int8: {len(calls)} int8 convs (calibrated {n_scales} scales in {calib_s:.2f} s), accumulators equal the "
          f"plain version at every width; widest {tuple(dk.shape)} on {tuple(x_.shape)} equal the CPU's bit for bit")
    preds = {name: Predictor(m, imgsz=IMGSZ) for name, m in arms.items()}
    launches = {}
    for name in ("int8 fused_1x1", "int8"):
        _reset_counts()
        qc.int8_launches = 0
        det, ok, _ = preds[name].infer(x)
        torch.cuda.synchronize()
        launches[name] = {**_counts(), "int8_matmul": qc.int8_launches}
        check(bool(torch.isfinite(det[ok]).all()), f"{name}: non-finite detections")
    check(launches["int8 fused_1x1"]["qattn_fwd"] == 1 and launches["int8 fused_1x1"]["qconv1x1_fused"] == 37,
          f"int8 fused_1x1: launches {launches['int8 fused_1x1']}")
    check(launches["int8"]["qattn_fwd"] == 1 and launches["int8"]["qconv1x1_fused"] == 0,
          f"int8: launches {launches['int8']}")
    times = {name: [] for name in arms}
    for name, p in preds.items():  # warm up: cuDNN picks its algorithms
        p.infer(x)
    for _ in range(rounds):  # interleaved rounds, host clock, synchronized
        for name, p in preds.items():
            _sync()
            t0 = time.perf_counter()
            p.infer(x)
            _sync()
            times[name].append(1e3 * (time.perf_counter() - t0))
    speed = {}
    for name, p in preds.items():  # device busy ms from the profiler (NMS syncs: no event trick)
        prof = _device_profile(lambda p=p: p.infer(x), 3, f"int8 phase [{name}]: 3 x infer, batch {BATCH} "
                               f"@ {IMGSZ}", tables, top=6)
        host = statistics.median(times[name])
        busy = prof["device_ms"]
        speed[name] = {"host_ms": host, "device_ms": busy, "device_ops": prof.get("device_ops"),
                       "busy_share": busy / host if busy is not None else None, "top": prof.get("top")}
    kept = {name: preds[name](frames) for name in ("int8 fused_1x1", "bf16 auto")}
    share = []
    for ri, rb in zip(kept["int8 fused_1x1"], kept["bf16 auto"]):
        if not len(rb):
            continue
        if not len(ri):
            share.append(0.0)
            continue
        d = np.abs(rb.boxes[:, None, :2] - ri.boxes[None, :, :2]).max(-1)
        same_cls = rb.boxes[:, None, -1] == ri.boxes[None, :, -1]
        share.append(float(((d <= 4.0) & same_cls).any(1).mean()))
    kept_share = float(np.mean(share)) if share else float("nan")
    brief = {k: {m: (round(v, 3) if isinstance(v, float) else v) for m, v in r.items() if m != "top"}
             for k, r in speed.items()}
    print(f"int8: infer {json.dumps(brief)}; top device ops of int8 fused_1x1 {speed['int8 fused_1x1']['top']}; "
          f"int8 keeps {kept_share:.3f} of bf16's boxes (centres within 4 px, same class; random weights, "
          f"not held); launches {launches}; {card}")
    return {"launches": launches, "speed": speed, "rounds": times, "kept_share": kept_share,
            "int8_convs": len(calls), "scales": n_scales, "calibrate_s": calib_s, "widths": len(widths)}


def split_scene(seed: int):
    """A SPLIT_SIZE scene of SPLIT_LABELS filled rotated rectangles and its DOTA-YOLO label lines."""
    rng = np.random.default_rng(seed)
    h, w = SPLIT_SIZE
    im = np.clip(rng.integers(0, 40, (h, w, 3)) + 60, 0, 255).astype(np.uint8)
    lines = []
    for _ in range(SPLIT_LABELS):
        bw, bh = rng.uniform(12, 120, 2)
        cx, cy = rng.uniform(bw, w - bw), rng.uniform(bh, h - bh)
        t = rng.uniform(0, math.pi)
        c, sn = math.cos(t), math.sin(t)
        pts = [(cx + dx * c - dy * sn, cy + dx * sn + dy * c)
               for dx, dy in ((-bw / 2, -bh / 2), (bw / 2, -bh / 2), (bw / 2, bh / 2), (-bw / 2, bh / 2))]
        _fill_rotated(im, cx, cy, bw, bh, t, rng.integers(170, 256, 3))
        lines.append(" ".join([str(rng.integers(0, NC))] + [f"{x / w:.6f} {y / h:.6f}" for x, y in pts]))
    return im, lines


def phase_split_dota(root: Path, card: str, seed: int = 9):
    """52. ``data.split_dota.split_image`` of a synthetic SPLIT_SIZE PNG scene with
    SPLIT_LABELS rotated objects into 1024 windows with a 200 gap: windows, seconds,
    bytes written; every crop decodes at 1024 x 1024 and every label is kept by a window."""
    from quan_ultralytics_tpu_torch.data.native import native
    from quan_ultralytics_tpu_torch.data.split_dota import get_windows, split_image

    h, w = SPLIT_SIZE
    im, lines = split_scene(seed)
    src, lbl = root / "P9999.png", root / "P9999.txt"
    native.imwrite_png(src, im)
    lbl.write_text("\n".join(lines) + "\n")
    t0 = time.perf_counter()
    n = split_image(str(src), str(lbl), root / "split" / "images", root / "split" / "labels")
    secs = time.perf_counter() - t0
    crops = sorted((root / "split" / "images").glob("*.jpg"))
    nbytes = sum(p.stat().st_size for p in crops)
    rows = sum(len(p.read_text().splitlines()) for p in (root / "split" / "labels").glob("*.txt"))
    check(n == len(get_windows((h, w))) == len(crops) == 25, f"split_dota: {n} windows, {len(crops)} crops")
    check(all(native.read_shape(p) == (1024, 1024) for p in crops), "split_dota: a crop is not 1024 x 1024")
    check(rows >= SPLIT_LABELS, f"split_dota: {rows} label rows for {SPLIT_LABELS} objects")
    print(f"split_dota: a {w} x {h} scene with {SPLIT_LABELS} objects into {n} windows of 1024 (gap 200) in "
          f"{secs:.2f} s, {nbytes / 1e6:.1f} MB of JPEG, {rows} label rows; {card}")
    return {"windows": n, "seconds": secs, "bytes": nbytes, "label_rows": rows}



# ---------------------------------------------------------------- phases 53-57


# the stem's forms (models/tasks.py QUANYOLO, ops/stem.py) that phase 53 drives
STEM_MODES = {"plain": {}, "stem_s2d": {"stem_s2d": True}, "deep1": {"stem_deep": 1}, "deep2": {"stem_deep": 2},
              "deep3": {"stem_deep": 3}, "deep1_fine": {"stem_deep": 1, "stem_l0": "fine"}}
STEM_TRAIN = ("plain", "stem_s2d", "deep1", "deep2")  # phase 54's forms, each without and with stem_remat
STEM_TRAIN_STEPS = 3  # timed micro-steps of each (median), after one warm-up
STEM_ROUNDS = 3  # interleaved rounds of phase 53's device profiles and phase 56's times (medians)
STEM_HOST_ROUNDS = 10  # interleaved rounds of phase 53's host clock (5 calls each; medians)
# a stem form's head outputs in f32 (TF32 off) against the plain stem's: max abs diff
# within STEM_F32_TOL of max|ref| (the same products in other cuDNN algorithms)
STEM_F32_TOL = 1e-3
# phase 54's f32 micro-step against the plain stem's: the loss within STEM_LOSS_TOL
# relative, the parameters' gradient within STEM_GRAD_TOL relative L2
STEM_LOSS_TOL, STEM_GRAD_TOL = 1e-4, 2e-3
# phase 55's IQBN statistics through the collectives against one process's: each
# buffer within STEM_STATS_TOL of its max |value| (two f32 reductions: the mesh's
# two-pass sums against torch.var; tests/test_torch_parallel.py holds rtol 1e-3)
STEM_STATS_TOL = 1e-4


def _stem_models(dtype: torch.dtype, modes, **kw):
    """The seeded n model in each stem form, all holding the plain model's weights."""
    models = {}
    for name in modes:
        models[name] = seeded_model(dtype, **kw, **STEM_MODES[name])
        if name != "plain":
            models[name].load_state_dict(models["plain"].state_dict())
    return models


def _head_flat(out):
    feats, angles = out
    return list(feats) + list(angles)


def phase_stem_predict(x, card: str, tables=None, rounds: int = STEM_ROUNDS):
    """53. The stem's forms on the OBB predict path at 1024, batch 8, bf16, K1+K3
    (``infer`` of the letterboxed phase-3 batch): K1 and K3 launches (K3 at
    `fused_1x1_sites`, which leaves out the packed region's 1x1 convs), device
    busy ms from torch.profiler and host ms of ``infer`` (medians of interleaved
    rounds), decoded predictions against the plain stem in bf16 and the head
    outputs of one frame in f32 (STEM_F32_TOL); then which default these
    numbers choose."""
    from quan_ultralytics_tpu_torch.engine.predictor import Predictor
    from quan_ultralytics_tpu_torch.models.tasks import fused_1x1_sites
    from quan_ultralytics_tpu_torch.ops.kernels import qattn, qconv_fused

    models = _stem_models(torch.bfloat16, STEM_MODES, fused_1x1=True)
    preds = {n: Predictor(m, imgsz=IMGSZ, conf=0.25) for n, m in models.items()}
    out, ref = {}, decoded(models["plain"], x)
    for name, pred in preds.items():
        sites = len(fused_1x1_sites(models[name], BATCH, IMGSZ))
        pred.infer(x)
        torch.cuda.synchronize()
        _reset_counts()
        pred.infer(x)  # the path, driven once
        torch.cuda.synchronize()
        launches = {"qattn_fwd": qattn.launches_mma, "qattn_bwd": qattn.launches_bwd,
                    "qconv1x1_fused": qconv_fused.launches_mma}
        check(launches == {"qattn_fwd": 1, "qattn_bwd": 0, "qconv1x1_fused": sites}
              and qattn.launches == qattn.launches_mma and qconv_fused.launches == qconv_fused.launches_mma,
              f"stem {name}: launches {launches}, expected K1 1 and K3 {sites}")
        rel = compare_preds(decoded(models[name], x), ref, NC)
        check(all(v <= PRED_TOL[torch.bfloat16] for v in rel.values()),
              f"stem {name}: bf16 predictions disagree with the plain stem: {rel}")
        out[name] = {"launches": launches, "fused_1x1_sites": sites, "agree_bf16": rel,
                     "deep_k": models[name].deep_k}
    names = list(preds)
    host, dev = {n: [] for n in names}, {n: [] for n in names}
    for r in range(max(rounds, STEM_HOST_ROUNDS)):
        for name in (names if r % 2 == 0 else names[::-1]):
            pred = preds[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                pred.infer(x)
            torch.cuda.synchronize()
            host[name].append(1e3 * (time.perf_counter() - t0) / 5)
            if r < rounds:
                prof = _device_profile(lambda: pred.infer(x), 1, f"stem {name}: infer, round {r}",
                                       tables if r == 0 else None)
                dev[name].append(prof["device_ms"])
                out[name]["device_ops"] = prof.get("device_ops")
    del models, preds
    f32 = _stem_models(torch.float32, STEM_MODES, fused_1x1=True)
    with torch.inference_mode():
        xs = x[:1].float() / 255.0
        ref32 = _head_flat(f32["plain"](xs))
        for name in names:
            got = _head_flat(f32[name](xs))
            err = max(float((g - r).abs().max()) / max(float(r.abs().max()), 1e-6) for g, r in zip(got, ref32))
            out[name]["agree_f32_head"] = err
            check(err <= STEM_F32_TOL, f"stem {name}: f32 head outputs off the plain stem's by {err:.2e}")
    del f32
    for name in names:
        d = [v for v in dev[name] if v is not None]
        # host ms against the plain stem's in the same round (the two ran one after the other)
        diff = [a - b for a, b in zip(host[name], host["plain"])]
        out[name].update({"device_ms": statistics.median(d) if d else None, "device_ms_rounds": dev[name],
                          "host_ms": statistics.median(host[name]), "host_ms_rounds": host[name],
                          "host_ms_vs_plain": statistics.median(diff),
                          "host_ms_vs_plain_q3": statistics.quantiles(diff, n=4)[2]})
        print(f"stem [{name}]: deep level {out[name]['deep_k']}, launches K1 {out[name]['launches']['qattn_fwd']} "
              f"K3 {out[name]['launches']['qconv1x1_fused']} (= fused_1x1_sites); infer device busy "
              + (f"{out[name]['device_ms']:.3f} ms" if d else "not measured")
              + f" (median of {rounds} rounds) over {out[name]['device_ops']} device ops, host "
              f"{out[name]['host_ms']:.3f} ms (median of {max(rounds, STEM_HOST_ROUNDS)}; against the plain stem "
              f"in the same round: median {out[name]['host_ms_vs_plain']:+.3f}, upper quartile "
              f"{out[name]['host_ms_vs_plain_q3']:+.3f} ms); vs plain: bf16 "
              f"{out[name]['agree_bf16']}, f32 head max abs diff / max|ref| {out[name]['agree_f32_head']:.2e}; {card}")
    # the default: a form that takes less device time than the plain stem in every profiled round and
    # is shown no slower on the host clock: no slower than the plain stem in at least three rounds of
    # four (the upper quartile of the same-round differences at most 0). The host clock's spread
    # between rounds is far wider than the device's, so a median alone decides nothing.
    better = [n for n in names if n != "plain" and None not in dev[n] + dev["plain"]
              and all(a < b for a, b in zip(dev[n], dev["plain"])) and out[n]["host_ms_vs_plain_q3"] <= 0]
    choice = min(better, key=lambda n: out[n]["device_ms"]) if better else "plain"
    print(f"stem default: {choice} (faster in device ms in every round and no slower on the host clock in "
          f"three rounds of four: {better or 'none'})")
    return {"modes": out, "default": choice, "faster": better}


def phase_stem_train(batch, card: str):
    """54. bf16 micro-steps of the OBB train step at 1024, batch 8 (K1 and K2
    once each a micro-step) under each of STEM_TRAIN, without and with
    ``stem_remat``: after one warm-up, the launches and peak memory of one
    micro-step and the median ms of STEM_TRAIN_STEPS; then one f32
    micro-step's loss and parameter gradients in each form against the plain
    stem's (STEM_LOSS_TOL, STEM_GRAD_TOL)."""
    out = {}
    for name in STEM_TRAIN:
        for remat in (False, True):
            key = f"{name}{' remat' if remat else ''}"
            tr = make_trainer(torch.bfloat16, model_kw={**STEM_MODES[name], "stem_remat": remat})
            tr.step(batch)  # cuDNN picks its algorithms
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            loss, _ = tr.step(batch)  # the path, driven once
            torch.cuda.synchronize()
            steps = [1e3 * (time.perf_counter() - t0)]
            launches = _counts()
            for _ in range(STEM_TRAIN_STEPS - 1):
                t0 = time.perf_counter()
                tr.step(batch)
                torch.cuda.synchronize()
                steps.append(1e3 * (time.perf_counter() - t0))
            ms = statistics.median(steps)
            out[key] = {"ms": ms, "ms_steps": steps, "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
                        "loss": float(loss), "launches": launches}
            check(math.isfinite(float(loss)) and launches["qattn_fwd"] == launches["qattn_bwd"] == 1,
                  f"stem train {key}: loss {float(loss)}, launches {launches}")
            print(f"stem train [{key}]: micro-step {ms:.1f} ms (median of {STEM_TRAIN_STEPS}), peak "
                  f"{out[key]['peak_mib']:.0f} MiB, "
                  f"launches {launches}; {card}")
            del tr
            torch.cuda.empty_cache()
    grads = {}
    for name in STEM_TRAIN:
        tr = make_trainer(torch.float32, model_kw=STEM_MODES[name])
        outs, n_feats = head_outputs(tr, batch)
        loss = loss_of(tr, outs, n_feats, batch)
        g = torch.autograd.grad(loss, tr.params, allow_unused=True)
        grads[name] = (float(loss.detach()), torch.cat([(t if t is not None else torch.zeros_like(p)).reshape(-1)
                                               for t, p in zip(g, tr.params)]))
        del tr, outs, g
        torch.cuda.empty_cache()
    l0, g0 = grads["plain"]
    for name, (loss, g) in grads.items():
        rel_l, rel_g = abs(loss - l0) / abs(l0), float((g - g0).norm() / g0.norm())
        out[f"{name} f32"] = {"loss": loss, "loss_rel": rel_l, "grad_rel_l2": rel_g}
        print(f"stem train [{name}, f32]: loss {loss:.6f} (rel diff {rel_l:.2e}), gradient rel L2 {rel_g:.2e} "
              f"vs the plain stem")
        check(rel_l <= STEM_LOSS_TOL and rel_g <= STEM_GRAD_TOL,
              f"stem train {name} f32: loss rel {rel_l:.2e}, gradient rel {rel_g:.2e}")
    return out


def phase_stem_dp(batch, card: str):
    """55. stem_deep=1 through NCCL at world size 1: one f32 micro-step of
    ``Trainer(mesh=)`` (the packed IQBNs' moments through the collectives) against
    the same micro-step without a mesh: each IQBN running statistic within
    STEM_STATS_TOL of its max |value|, the loss within STEM_LOSS_TOL."""
    import datetime

    import torch.distributed as dist

    from quan_ultralytics_tpu_torch.parallel import distributed
    from quan_ultralytics_tpu_torch.parallel.mesh import make_mesh

    backend = distributed.default_backend(DEVICE)
    distributed.initialize(backend=backend, init_method=f"tcp://localhost:{distributed.free_port()}",
                           world_size=1, rank=0, timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    try:
        runs = {}
        for name, mesh in (("single", None), (backend, make_mesh(1, device=DEVICE))):
            tr = make_trainer(torch.float32, mesh=mesh, model_kw={"stem_deep": 1})
            _reset_counts()
            loss, _ = tr.step(batch)
            stats = {n: b.detach().clone() for n, b in tr.model.named_buffers() if n.endswith((".mean", ".var"))}
            runs[name] = (float(loss), stats, _counts())
            del tr
    finally:
        dist.destroy_process_group()
    (la, sa, ca), (lb, sb, _) = runs[backend], runs["single"]
    err = max(float((sa[n] - sb[n]).abs().max()) / max(float(sb[n].abs().max()), 1e-6) for n in sb)
    loss_rel = abs(la - lb) / abs(lb)
    print(f"stem dp [{backend}, world 1, deep 1, f32]: IQBN statistics max abs diff / max|value| {err:.2e} over {len(sb)} "
          f"buffers, loss rel diff {loss_rel:.2e}, launches {ca}; {card}")
    check(err <= STEM_STATS_TOL and loss_rel <= STEM_LOSS_TOL and ca["qattn_bwd"] == 1,
          f"stem dp: IQBN statistics {err:.2e}, loss {loss_rel:.2e}, launches {ca}")
    return {"backend": backend, "iqbn_max_rel_diff": err, "loss_rel_diff": loss_rel, "launches": ca}


def phase_assigner(batch, x, card: str, calls: int = 3):
    """56. The assigner's forms on the OBB train batch (1024, M = 128 padded boxes
    an image): the assigner's inputs of one ``obb_loss`` call, captured; the
    sparse form's targets against the dense form's, bit for bit, in bf16 (the
    trainer's) and f32; the loss layer (obb_loss + backward) dense and sparse:
    device ms and peak memory; the assigner alone at topk 16 (``iter``) and 32
    (``chunk``; and sparse); then NMS with ``defer_argmax`` against the default
    on the predict batch: the same detections, and ``infer`` ms."""
    from quan_ultralytics_tpu_torch.engine.predictor import Predictor
    from quan_ultralytics_tpu_torch.losses import detect as ld
    from quan_ultralytics_tpu_torch.losses import tal

    tr = make_trainer(torch.bfloat16)
    with torch.no_grad():
        outs, n_feats = head_outputs(tr, batch)
    leaves = [t.detach().requires_grad_() for t in outs]
    captured = []
    original = ld.task_aligned_assigner
    ld.task_aligned_assigner = lambda *a, **kw: captured.append((a, kw)) or original(*a, **kw)
    try:
        loss_of(tr, leaves, n_feats, batch)
    finally:
        ld.task_aligned_assigner = original
    args, kw = captured[0]
    out = {"bitwise": {}}
    for bf16 in (True, False):
        k = {**kw, "bf16_metric": bf16}
        dense, sparse = (tal.task_aligned_assigner(*args, **{**k, "impl": impl}) for impl in ("dense", "sparse"))
        same = all(torch.equal(getattr(dense, f), getattr(sparse, f)) for f in tal.AssignResult._fields)
        out["bitwise"]["bf16" if bf16 else "f32"] = same
        check(same and bool(dense.fg_mask.any()), f"assigner: sparse != dense (bf16 metric {bf16})")

    def measure(fn, tag):
        fn()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        prof = _device_profile(fn, calls, tag)
        return {"device_ms": prof["device_ms"], "device_ops": prof.get("device_ops"), "peak_mib": peak}

    for impl in ("dense", "sparse"):
        tr.cfg.assigner_impl = impl
        out[f"loss_layer {impl}"] = measure(
            lambda: torch.autograd.grad(loss_of(tr, leaves, n_feats, batch), leaves), f"loss layer {impl}")
    tr.cfg.assigner_impl = "dense"
    for name, k in (("topk16 iter", dict(topk=16, topk_impl="iter")), ("topk32 chunk", dict(topk=32)),
                    ("topk32 sparse", dict(topk=32, impl="sparse")), ("topk10 sparse", dict(impl="sparse")),
                    ("topk10 iter", {})):
        out[f"assigner {name}"] = measure(lambda: tal.task_aligned_assigner(*args, **{**kw, **k}), name)
    for key, r in out.items():
        if key != "bitwise":
            print(f"assigner [{key}], M = {TRAIN_M}: device busy "
                  + (f"{r['device_ms']:.3f} ms" if r["device_ms"] is not None else "not measured")
                  + f", peak {r['peak_mib']:.1f} MiB above the inputs; {card}")
    print(f"assigner: sparse targets == dense bit for bit {out['bitwise']}")
    del tr, leaves, outs
    model = seeded_model(torch.bfloat16, fused_1x1=True)
    preds = {d: Predictor(model, imgsz=IMGSZ, conf=0.25, defer_argmax=d) for d in (False, True)}
    res = {d: p.infer(x) for d, p in preds.items()}
    same = all(torch.equal(a, b) for a, b in zip(res[False][:2], res[True][:2]))
    check(same and int(res[False][1].sum()) > 0, "defer_argmax: the detections differ")
    ms = {False: [], True: []}
    for r in range(STEM_ROUNDS):
        for d in ((False, True) if r % 2 == 0 else (True, False)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                preds[d].infer(x)
            torch.cuda.synchronize()
            ms[d].append(1e3 * (time.perf_counter() - t0) / 5)
    out["defer_argmax"] = {"same_detections": same, "infer_ms": statistics.median(ms[True]),
                           "infer_ms_default": statistics.median(ms[False])}
    print(f"defer_argmax: the same detections ({int(res[True][1].sum())}); infer {out['defer_argmax']['infer_ms']:.3f} "
          f"ms against {out['defer_argmax']['infer_ms_default']:.3f} by default (host clock, medians of "
          f"{STEM_ROUNDS} rounds); {card}")
    return out


def phase_readers(root: Path, card: str, reps: int = 20):
    """57. The readers' newer formats (tests/fixtures/reader_fixtures.json:
    progressive JPEG, an EXIF-rotated JPEG, an Adam7 PNG) through the val loader
    of a set made of them: each image against its OpenCV pixel digest, and the
    decode ms of each (`native.imread`, mean of ``reps``)."""
    import hashlib
    import shutil

    from quan_ultralytics_tpu_torch.cfg.datasets import DOTA_V1
    from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
    from quan_ultralytics_tpu_torch.data.native import native

    fixtures = Path(__file__).resolve().parent / "tests" / "fixtures"
    digests = json.loads((fixtures / "reader_fixtures.json").read_text())
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    for name in digests:
        shutil.copy(fixtures / name, root / "images" / "val" / name)
        (root / "labels" / "val" / f"{Path(name).stem}.txt").write_text("0 0.2 0.2 0.6 0.2 0.6 0.6 0.2 0.6\n")
    cfg = {"path": str(root), "train": "images/val", "val": "images/val", "names": DOTA_V1["names"]}
    ds = YOLODataset(cfg, "val", task="obb")
    out = {}
    for i in range(len(ds)):
        name = Path(ds.samples[i].im_file).name
        im = ds.load_image(i)
        ok = list(im.shape) == digests[name]["shape"] and \
            hashlib.sha256(np.ascontiguousarray(im).tobytes()).hexdigest() == digests[name]["sha256"]
        check(ok, f"readers: {name} does not decode to its OpenCV pixels")
        t0 = time.perf_counter()
        for _ in range(reps):
            native.imread(root / "images" / "val" / name)
        out[name] = {"decode_ms": 1e3 * (time.perf_counter() - t0) / reps, "shape": list(im.shape)}
    loader = build_dataloader(ds, batch_size=len(ds), imgsz=256, augment=False, shuffle=False)
    n = sum(int(b["img"].shape[0]) for b in loader)
    check(n == len(digests), f"readers: the val loader gave {n} images")
    times = ", ".join(f"{k} {v['shape']} {v['decode_ms']:.3f} ms" for k, v in out.items())
    print(f"readers: {times} (decode, mean of {reps}); through the val loader, each equal to its OpenCV "
          f"digest; {card}")
    return out


# ---------------------------------------------------------------- phases 58-60


VIDEO_PASSES = 3  # timed decodes of each 640 x 480 clip in phase 58
VIDEO_CLIP = "track_640x480.mp4"  # make_clip's frames as mp4v MPEG-4 Part 2, the track and predict source


VIDEOS = Path(__file__).resolve().parent / "tests" / "fixtures" / "video"
# phase 64's fixtures: VP8 and MPEG-4 Advanced Simple Profile (with Xvid's and DivX's
# streams); phase 70's: VP9 and the refused FFV1 AVI; phase 58 holds the others
VIDEO_ASP_VP8 = {"vp8_64x48.webm", "vp8_p1_64x48.avi", "vp8_p3_er_64x48.avi", "vp8_p0_golden_64x48.avi",
                 "mpeg4_bvop_88x40.avi", "mpeg4_qpel_88x40.avi", "mpeg4_mq_88x40.avi", "mpeg4_asp_88x40.avi",
                 "xvid_asp_88x40.avi", "divx_asp_88x40.avi", "divx_packed_88x40.avi",
                 "track_640x480.webm", "track_640x480_xvid.avi"}
VIDEO_VP9 = {"vp9_64x48.webm", "vp9_64x48.mkv", "vp9_64x48.avi", "vp9_64x48.mp4", "vp9_tiles_512x64.mkv",
             "vp9_lossless_64x48.avi", "vp9_aq_96x64.mp4", "vp9_crafted_64x48.mkv", "vp9_arf_96x64.webm",
             "vp9_bilinear_96x64.mkv", "track_640x480_vp9.webm", "ffv1_64x48.avi"}
VIDEO_VP8_CLIP = "track_640x480.webm"  # make_clip's frames as cv2's VP80 WebM: phase 65's track source
VIDEO_ASP_CLIP = "track_640x480_xvid.avi"  # B-VOPs and quarter-pel under Xvid's user data: phase 66's source
VIDEO_VP9_CLIP = "track_640x480_vp9.webm"  # make_clip's frames as cv2's VP90 WebM: phase 71's track source
# the H.263 family's fixtures (phase 74): H.263, H.263+, Sorenson, MS-MPEG4 v2 and v3, MPEG-4 data partitioning
VIDEO_H263 = {"h263_176x144.avi", "h263_352x288.avi", "flv1_64x48.avi", "mp42_64x48.avi", "div3_64x48.avi",
              "u263_88x40.avi", "flv1_tools_88x40.avi", "mp42_tools_88x40.avi", "div3_tools_88x40.avi",
              "mpeg4_dp_88x40.avi", "flv1_droppable_88x40.avi", "track_640x480_div3.avi"}
VIDEO_DIV3_CLIP = "track_640x480_div3.avi"  # make_clip's frames as cv2's DIV3 AVI: phase 75's source
# WMV1, WMV2 and H.263+ Annex J (phase 76)
VIDEO_WMV = {"wmv1_64x48.avi", "wmv1_64x48.mkv", "wmv2_64x48.avi", "wmv2_64x48.mkv", "wmv1_ii_88x40.avi",
             "wmv1_mbrl_88x40.avi", "wmv2_loop_88x40.avi", "wmv2_crafted_88x40.avi", "u263_loop_88x40.avi",
             "track_640x480_wmv2.avi"}
VIDEO_WMV2_CLIP = "track_640x480_wmv2.avi"  # make_clip's frames through libavcodec's wmv2: phase 77's source


def _video_fixtures(names, tag: str) -> dict:
    """Each of ``names`` through `video.frames` against the port's SHA-256 in
    video_fixtures.json, or its refusal against the message recorded there."""
    import hashlib

    from quan_ultralytics_tpu_torch.data.native import video

    digests = json.loads((VIDEOS.parent / "video_fixtures.json").read_text())
    out = {}
    for name in sorted(names):
        d = digests[name]
        if "refused" in d:
            try:
                list(video.frames(VIDEOS / name))
                check(False, f"{tag}: {name} decoded; it should be refused")
            except NotImplementedError as e:
                msg = str(e).replace(str(VIDEOS / name), name)
                check(msg == d["refused"], f"{tag}: {name} refused with {msg!r}, not {d['refused']!r}")
                out[name] = {"refused": msg}
            continue
        got = list(video.frames(VIDEOS / name))
        shas = [hashlib.sha256(np.ascontiguousarray(f).tobytes()).hexdigest() for f in got]
        check(len(got) == d["frames"] and shas == [f["port"] for f in d["per_frame"]],
              f"{tag}: {name} gives {len(got)} frames, not its {d['frames']} digests")
        out[name] = {"frames": len(got), "codec": d["codec"], "container": d["container"],
                     "cv2_equal": all(f["port"] == f["cv2"] for f in d["per_frame"]),
                     "cv2_max_diff": max(f["max_diff"] for f in d["per_frame"])}
    return out


def _video_ms(name: str) -> dict:
    """The ms a frame of a clip: demux once, then decode (packets and the
    flush of a held reference) and convert to RGB, VIDEO_PASSES times."""
    from quan_ultralytics_tpu_torch.data.native import video

    t0 = time.perf_counter()
    stream = video.demux(VIDEOS / name)
    demux_ms = 1e3 * (time.perf_counter() - t0)
    spent = {"decode": 0.0, "rgb": 0.0}
    n = 0
    for _ in range(VIDEO_PASSES):
        dec = video.Decoder(stream.codec, stream.private, stream.tag, stream.size)
        for packet in [*stream.packets, None]:
            t0 = time.perf_counter()
            ready = dec.send(packet) if packet is not None else dec.flush()
            t1 = time.perf_counter()
            while ready:  # a VP9 packet may show more than one frame
                dec.rgb()
                n += 1
                t2 = time.perf_counter()
                ready = dec.next()
                t1 += time.perf_counter() - t2
            spent["decode"] += t1 - t0
            spent["rgb"] += time.perf_counter() - t1
        dec.close()
    return {"codec": stream.codec, "frames": n // VIDEO_PASSES, "demux_ms": demux_ms,
            "decode_ms": 1e3 * spent["decode"] / n, "rgb_ms": 1e3 * spent["rgb"] / n,
            "total_ms": 1e3 * (spent["decode"] + spent["rgb"]) / n}


def _print_video(tag: str, out: dict, card: str) -> None:
    print(f"{tag}: " + ", ".join(f"{k}: {v['frames']} frames equal to the port's digests"
                                 + (" (= OpenCV's)" if v["cv2_equal"] else "")
                                 for k, v in out["fixtures"].items() if "frames" in v)
          + "".join(f"; {k} refused: {v['refused']}" for k, v in out["fixtures"].items() if "refused" in v)
          + "; " + "; ".join(f"{k} ({v['codec']}) {v['decode_ms']:.2f} ms decode + {v['rgb_ms']:.2f} ms RGB a "
                             f"frame, demux {v['demux_ms']:.1f} ms" for k, v in out["ms_a_frame"].items())
          + f" (mean of {VIDEO_PASSES} passes); {card}")


def phase_video_decode(card: str):
    """58. The committed Motion-JPEG and MPEG-4 Simple Profile fixtures
    through `video.frames`, each frame against the port's SHA-256 in
    video_fixtures.json; the ms a frame of the 640 x 480 MPEG-4 and
    Motion-JPEG clips (demux once, then decode and convert to RGB, mean of
    VIDEO_PASSES)."""
    digests = json.loads((VIDEOS.parent / "video_fixtures.json").read_text())
    out = {"fixtures": _video_fixtures(set(digests) - VIDEO_ASP_VP8 - VIDEO_VP9 - VIDEO_H263, "video decode"),
           "ms_a_frame": {name: _video_ms(name) for name in ("track_640x480.mp4", "track_640x480.avi")}}
    _print_video("video decode", out, card)
    return out


def phase_video_asp_vp8_decode(card: str):
    """64. The VP8 and MPEG-4 Advanced Simple Profile fixtures (B-VOPs,
    quarter-pel, MPEG quantisation; Xvid's and DivX's streams, DivX's packed
    B-VOPs) through `video.frames`, each frame against the port's SHA-256;
    the decode and RGB ms a frame of the 640 x 480 clip as VP8 WebM and as
    the Xvid ASP AVI."""
    out = {"fixtures": _video_fixtures(VIDEO_ASP_VP8, "video VP8/ASP decode"),
           "ms_a_frame": {name: _video_ms(name) for name in (VIDEO_VP8_CLIP, VIDEO_ASP_CLIP)}}
    check(all(v["frames"] == TRACK_FRAMES for v in out["ms_a_frame"].values()),
          f"video VP8/ASP decode: the clips' frames {out['ms_a_frame']}")
    _print_video("video VP8/ASP decode", out, card)
    return out


def phase_video_vp9_decode(card: str):
    """70. The VP9 fixtures (cv2's clips in the four containers; libvpx-vp9's
    tiles with backward adaptation, lossless and segmented full-range
    streams, its two passes with compound prediction; superframes, hidden,
    intra-only, show_existing and bilinear-filtered frames)
    through `video.frames`, each frame against the port's SHA-256, the FFV1
    AVI's refusal against its recorded message; the decode and RGB ms a
    frame of the 640 x 480 clip as VP9 WebM."""
    out = {"fixtures": _video_fixtures(VIDEO_VP9, "video VP9 decode"),
           "ms_a_frame": {VIDEO_VP9_CLIP: _video_ms(VIDEO_VP9_CLIP)}}
    check(out["ms_a_frame"][VIDEO_VP9_CLIP]["frames"] == TRACK_FRAMES,
          f"video VP9 decode: the clip's frames {out['ms_a_frame']}")
    _print_video("video VP9 decode", out, card)
    return out


def phase_video_h263_decode(card: str):
    """74. The H.263 family's fixtures (cv2's H263 at QCIF and CIF, FLV1, MP42
    and DIV3; libavcodec's h263p custom format, flv, msmpeg4v2 and msmpeg4 at
    fixed quantisers, Sorenson's disposable frames; MPEG-4 with data
    partitioning) through `video.frames`, each frame against the port's
    SHA-256; the decode and RGB ms a frame of the 640 x 480 clip as DIV3,
    beside the VP8 and VP9 clips' in the same run."""
    out = {"fixtures": _video_fixtures(VIDEO_H263, "video H.263 decode"),
           "ms_a_frame": {name: _video_ms(name) for name in (VIDEO_DIV3_CLIP, VIDEO_VP8_CLIP, VIDEO_VP9_CLIP)}}
    check(all(v["frames"] == TRACK_FRAMES for v in out["ms_a_frame"].values()),
          f"video H.263 decode: the clips' frames {out['ms_a_frame']}")
    _print_video("video H.263 decode", out, card)
    return out


def phase_video_wmv_decode(card: str):
    """76. The WMV1, WMV2 and Annex J fixtures (cv2's WMV1 and WMV2 in AVI and
    Matroska; libavcodec's wmv1 with inter-intra prediction and with
    per-macroblock run-level tables in three slices, its wmv2 with the loop
    filter and the top-left vector predictor and rewritten to mspel motion,
    skip maps, per-macroblock tables, other CBP tables and ABT, its h263p
    with the deblocking filter) through
    `video.frames`, each frame against the port's SHA-256; the decode and RGB
    ms a frame of the 640 x 480 clip as WMV2, beside the DIV3 clip's in the
    same run."""
    out = {"fixtures": _video_fixtures(VIDEO_WMV, "video WMV decode"),
           "ms_a_frame": {name: _video_ms(name) for name in (VIDEO_WMV2_CLIP, VIDEO_DIV3_CLIP)}}
    check(all(v["frames"] == TRACK_FRAMES for v in out["ms_a_frame"].values()),
          f"video WMV decode: the clips' frames {out['ms_a_frame']}")
    _print_video("video WMV decode", out, card)
    return out


def vp9_clip_mp4(root: Path) -> Path:
    """The VP9 clip's packets in an MP4 (``vp09``) under ``root``, as phase 72's source."""
    from quan_ultralytics_tpu_torch.data.native import video

    path = root / "track_640x480_vp9.mp4"
    root.mkdir(parents=True, exist_ok=True)
    fixture_maker("make_video_fixtures").write_mp4(path, video.demux(VIDEOS / VIDEO_VP9_CLIP).packets, TRACK_SIZE[1], TRACK_SIZE[0])
    return path


def phase_video_track(root: Path, card: str, clip_name=VIDEO_CLIP):
    """59 (and 65 with the VP8 WebM, 71 with the VP9 WebM). ``detect track model=<seeded pkl> source=<clip>`` through
    ``cli.main`` (ByteTrack, the CLI's defaults, f32): a line a frame, K1 on
    the CUDA cores and K3 at every fused site each frame. Then
    ``YOLO.track(load_source(<clip.mp4>), tracker="botsort")`` with the
    thresholds of phase 36 (at the seeded model's first-frame scores): its
    tracks equal, frame by frame, those of ``YOLO.track`` over the decoded
    frames held as arrays (the model run again on them, a fresh BoT-SORT),
    and its ms a frame split into decode (the generator's next), infer and
    the tracker's update."""
    from quan_ultralytics_tpu_torch import trackers
    from quan_ultralytics_tpu_torch.data.loaders import load_source
    from quan_ultralytics_tpu_torch.engine.model import YOLO
    from quan_ultralytics_tpu_torch.trackers import byte_tracker

    clip = clip_name if isinstance(clip_name, Path) else VIDEOS / clip_name
    pkl = seeded_pkl(root / "video_track_seeded.pkl", DET_MODEL, DET_NC)
    k3 = default_k3_sites(DET_MODEL, DET_NC)
    text, cli_s, cli_n = _cli(["detect", "track", f"model={pkl}", f"source={clip}", f"imgsz={DET_IMGSZ}"])
    lines = [ln for ln in text.splitlines() if ln.startswith("frame ")]
    check(len(lines) == TRACK_FRAMES and cli_n["qattn_fwd"] == cli_n["qattn_fwd_cuda_cores"] == TRACK_FRAMES
          and cli_n["qconv1x1_fused"] == TRACK_FRAMES * k3, f"video cli track: {len(lines)} lines, {cli_n}")
    arrays = list(load_source(clip))
    y = YOLO(str(pkl), device=DEVICE)
    conf = y.predict(arrays[0], imgsz=DET_IMGSZ)[0].conf
    check(len(conf) >= 2, f"video track: the seeded model keeps {len(conf)} detections on the first frame")
    kw = dict(track_high_thresh=float(np.quantile(conf, 0.95)), track_low_thresh=float(np.quantile(conf, 0.5)),
              new_track_thresh=float(np.quantile(conf, 0.95)))
    spent = {"decode": 0.0, "update": 0.0}
    tracker = trackers.BOTSORT(**kw)
    update = tracker.update

    def timed_update(xyxy, scores, cls, **kwargs):
        t0 = time.perf_counter()
        res = update(xyxy, scores, cls, **kwargs)
        spent["update"] += time.perf_counter() - t0
        return res

    def timed_frames():
        gen = load_source(clip)
        while True:
            t0 = time.perf_counter()
            frame = next(gen, None)
            spent["decode"] += time.perf_counter() - t0
            if frame is None:
                return
            yield frame

    tracker.update = timed_update
    y._tracker = tracker
    byte_tracker.STrack._count = 0
    _reset_counts()
    t0 = time.perf_counter()
    tracks = y.track(timed_frames(), imgsz=DET_IMGSZ, tracker="botsort", persist=True)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    got = _counts()
    check(got == {"qattn_fwd": TRACK_FRAMES, "qattn_fwd_with_stats": 0, "qattn_bwd": 0,
                  "qconv1x1_fused": TRACK_FRAMES * k3}, f"video track [botsort]: launches {got}")
    y._tracker = trackers.BOTSORT(**kw)
    byte_tracker.STrack._count = 0
    again = y.track(arrays, imgsz=DET_IMGSZ, tracker="botsort", persist=True)
    check(len(tracks) == len(again) == TRACK_FRAMES and all(np.array_equal(a, b) for a, b in zip(tracks, again)),
          "video track [botsort]: the tracks of the streamed file differ from YOLO.track's over its decoded frames")
    row = {"cli_s": cli_s, "launches_cli": cli_n, "launches": got, "ms_a_frame": 1e3 * total / TRACK_FRAMES,
           "decode_ms_a_frame": 1e3 * spent["decode"] / TRACK_FRAMES,
           "update_ms_a_frame": 1e3 * spent["update"] / TRACK_FRAMES,
           "infer_ms_a_frame": 1e3 * (total - spent["decode"] - spent["update"]) / TRACK_FRAMES,
           "tracks_a_frame": [len(t) for t in tracks], "thresholds": kw}
    print(f"video track: detect track of {clip.name} through the CLI in {cli_s:.1f} s, {len(lines)} lines, "
          f"launches {cli_n}; YOLO.track [botsort] {row['ms_a_frame']:.1f} ms a frame (decode "
          f"{row['decode_ms_a_frame']:.2f}, infer {row['infer_ms_a_frame']:.1f}, update "
          f"{row['update_ms_a_frame']:.2f}); launches {got}; tracks a frame {row['tracks_a_frame']}; {card}")
    return row


def phase_video_predict(root: Path, card: str, clip_name=VIDEO_CLIP):
    """60 (and 66 with the Xvid ASP AVI, 72 with the VP9 MP4). ``obb predict model=<seeded pkl> source=<clip> save=True`` at
    1024 through ``cli.main`` (f32): an im{i}.jpg a frame at the frame's size
    and the facade's lines for the decoded arrays; then the facade in bf16
    (K1 + K3 on the tensor cores): ``predict(<clip.mp4>)`` against
    ``predict(<decoded arrays>)``, the same detections within PRED_TOL, and
    its ms a frame."""
    from quan_ultralytics_tpu_torch.data.loaders import load_source
    from quan_ultralytics_tpu_torch.data.native import native
    from quan_ultralytics_tpu_torch.engine.model import YOLO

    clip = clip_name if isinstance(clip_name, Path) else VIDEOS / clip_name
    pkl = seeded_pkl(root / "video_obb_seeded.pkl", MODEL, NC)
    arrays = list(load_source(clip))
    text, cli_s, cli_n = _cli(["obb", "predict", f"model={pkl}", f"source={clip}", f"imgsz={IMGSZ}", "save=True",
                               f"save_dir={root / 'video_pred'}"])
    check(cli_n["qattn_fwd"] > 0 and cli_n["qconv1x1_fused"] == 37 * cli_n["qattn_fwd"],
          f"video cli predict: launches {cli_n}")
    for i, f in enumerate(arrays):
        check(native.imread(root / "video_pred" / f"im{i}.jpg").shape == f.shape, f"video predict: im{i}.jpg")
    ref = YOLO(str(pkl), device=DEVICE).predict(arrays, imgsz=IMGSZ)
    want = [f"image {i + 1}/{len(ref)} {r.orig_shape[1]}x{r.orig_shape[0]} {r.verbose()}" for i, r in enumerate(ref)]
    check([ln for ln in text.splitlines() if ln.startswith("image ")] == want,
          "video cli predict: its lines differ from the facade's for the decoded frames")
    y = YOLO(str(pkl), dtype=torch.bfloat16, device=DEVICE)
    y.predict(arrays[:1], imgsz=IMGSZ)  # warm up
    base = y.predict(arrays, imgsz=IMGSZ)
    _reset_counts()
    t0 = time.perf_counter()
    res = y.predict(str(clip), imgsz=IMGSZ)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = _counts()
    check(got["qattn_fwd"] > 0 and got["qconv1x1_fused"] == 37 * got["qattn_fwd"] and got["qattn_bwd"] == 0,
          f"video predict: launches {got}")
    tol = PRED_TOL[torch.bfloat16]
    same = len(res) == len(base) == TRACK_FRAMES and all(
        len(a) == len(b) and np.array_equal(a.cls, b.cls)
        and np.abs(a.boxes - b.boxes).max(initial=0.0) <= tol * max(1.0, float(np.abs(b.boxes).max(initial=0.0)))
        for a, b in zip(res, base))
    check(same, "video predict: the clip's detections differ from those of its decoded frames")
    row = {"cli_s": cli_s, "launches_cli": cli_n, "launches": got, "ms_a_frame": 1e3 * secs / TRACK_FRAMES,
           "detections": [len(r) for r in res]}
    print(f"video predict: obb predict save=True of {clip.name} at {IMGSZ} through the CLI (f32) in {cli_s:.1f} s, "
          f"{len(arrays)} im*.jpg, launches {cli_n}; bf16 facade: {row['ms_a_frame']:.1f} ms a frame from the file, "
          f"launches {got}, detections {row['detections']}; {card}")
    return row


# ---------------------------------------------------------------- phases 61-63

# the formats phase 61 writes phase_data's set in, with the port's writers: (suffix, encoder)
IMAGE_SETS = {"bmp": ".bmp", "tiff_lzw_pred2": ".tif", "tiff_tiled_deflate": ".tiff", "webp_lossless": ".webp"}
TIFF_TILE = 256  # the tiled TIFFs' tile side (GeoTIFF scenes are commonly tiled at 256 or 512)
MIXED_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff")
MIXED_SIZE = (480, 640)  # (h, w) of phase 63's predict images


def _encode_as(name: str, im: np.ndarray) -> bytes:
    """``im`` in one of IMAGE_SETS' formats, by the port's writers."""
    from quan_ultralytics_tpu_torch.data.native import bmp, tiff, webp

    if name == "bmp":
        return bmp.encode(im)
    if name == "tiff_lzw_pred2":
        return tiff.encode(im, compression="lzw", predictor=True)
    if name == "tiff_tiled_deflate":
        return tiff.encode(im, compression="deflate", predictor=False, tile=TIFF_TILE)
    return webp.encode(im)


def phase_image_val(root: Path, card: str):
    """61. phase_data's 16-image set written again with the port's writers as
    BMP, TIFF (LZW with predictor 2 in one strip; Deflate in 256 tiles) and
    lossless WebP; the Validator at 1024 (conf 0.001, bf16, K1 + K3 on the
    tensor cores, seeded weights) on the PNG set and on each: the same kept
    detections, bit for bit, and the same metrics; the load + letterbox ms a
    batch and the write seconds of each format."""
    import shutil

    from quan_ultralytics_tpu_torch.data import YOLODataset
    from quan_ultralytics_tpu_torch.data.native import native
    from quan_ultralytics_tpu_torch.engine.validator import Validator

    png_cfg, _ = phase_data(root / "png")
    src = Path(png_cfg["path"])
    cfgs, write_s = {"png": png_cfg}, {}
    for name, suffix in IMAGE_SETS.items():
        dst = root / name
        shutil.copytree(src / "labels", dst / "labels")
        (dst / "images" / "train").mkdir(parents=True)
        t0 = time.perf_counter()
        for p in sorted((src / "images" / "train").glob("*.png")):
            (dst / "images" / "train" / (p.stem + suffix)).write_bytes(_encode_as(name, native.imread(p)))
        write_s[name] = time.perf_counter() - t0
        cfgs[name] = {**png_cfg, "path": str(dst)}
    m = seeded_model(torch.bfloat16, fused_1x1=True)
    Validator(m, imgsz=IMGSZ, conf=VAL_CONF).infer(torch.zeros(BATCH, IMGSZ, IMGSZ, 3, dtype=torch.uint8,
                                                               device=DEVICE))
    nb = math.ceil(len(DATA_SIZES) / BATCH)
    out = {}
    for name, cfg in cfgs.items():
        ds = YOLODataset(cfg, "val", task="obb")
        check({Path(s.im_file).suffix for s in ds.samples} == {IMAGE_SETS.get(name, ".png")},
              f"image val [{name}]: the set holds other files")
        val = Validator(m, imgsz=IMGSZ, conf=VAL_CONF)
        js = root / f"{name}_dets.json"
        _reset_counts()
        metrics = val(ds, batch_size=BATCH, save_json=str(js))  # the main path
        torch.cuda.synchronize()
        got = _counts()
        check(got == {"qattn_fwd": nb, "qattn_fwd_with_stats": 0, "qattn_bwd": 0, "qconv1x1_fused": 37 * nb},
              f"image val [{name}]: launches {got}")
        out[name] = {"metrics": metrics, "load_ms_a_batch": val.speed["load_ms"], "infer_ms": val.speed["infer_ms"],
                     "detections": json.loads(js.read_text()), "launches": got, "write_s": write_s.get(name)}
    ref = out["png"]
    for name, r in out.items():
        same = r["detections"] == ref["detections"] and r["metrics"] == ref["metrics"]
        check(same, f"image val [{name}]: the detections or metrics differ from the PNG set's")
    print("image val: " + "; ".join(
        f"{name}: load + letterbox {r['load_ms_a_batch']:.1f} ms a batch of {BATCH}"
        + (f", written in {r['write_s']:.2f} s" if r["write_s"] is not None else "") for name, r in out.items())
        + f"; {len(ref['detections'])} detections and metrics {ref['metrics']} the same bit for bit on every "
        f"format; K1 + K3 launches {ref['launches']}; {card}")
    for r in out.values():
        del r["detections"]
    return cfgs, out


def phase_image_fit(cfgs, card: str):
    """62. ``Trainer.fit`` for one epoch at 1024, bf16, batch 8 (nbs 8), the
    recipe's augmentations, seeded weights, on the BMP set (HRSC2016's
    format) and on the PNG set: the loader's batches bit for bit the same,
    K1 and K2 every micro-step, and the micro-steps' losses against each
    other (cuDNN deterministic)."""
    from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
    from quan_ultralytics_tpu_torch.data.augment import AugmentHyp
    from quan_ultralytics_tpu_torch.engine.trainer import TrainConfig, Trainer

    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name in ("png", "bmp"):
            tds = YOLODataset(cfgs[name], "train", task="obb")
            steps = len(tds) // BATCH
            tr = Trainer(seeded_model(torch.bfloat16), TrainConfig(batch=BATCH, nbs=BATCH, epochs=1),
                         steps_per_epoch=steps, device=DEVICE)
            batches, losses = [], []

            def loader(epoch, tds=tds, batches=batches):
                for b in build_dataloader(tds, BATCH, IMGSZ, hyp=AugmentHyp(), augment=True, seed=epoch):
                    batches.append({k: v for k, v in b.items() if isinstance(v, np.ndarray)})
                    yield b

            step = tr.step

            def record(batch, step=step, losses=losses):
                res = step(batch)
                losses.append(res[0].detach().float().clone())
                return res

            tr.step = record
            _reset_counts()
            t0 = time.perf_counter()
            history = tr.fit(loader, None, epochs=1)  # the main path
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = _counts()
            check(got == {"qattn_fwd": steps, "qattn_fwd_with_stats": steps, "qattn_bwd": steps,
                          "qconv1x1_fused": 0}, f"image fit [{name}]: launches {got}")
            check(len(history) == 1 and math.isfinite(history[0]["loss"]), f"image fit [{name}]: {history}")
            runs[name] = {"batches": batches, "losses": torch.stack(losses).cpu().tolist(), "seconds": secs,
                          "launches": got, "loss": history[0]["loss"]}
            del tr
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b = runs["bmp"], runs["png"]
    check(len(a["batches"]) == len(b["batches"]) > 0 and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x) for x, y in zip(a["batches"], b["batches"])),
        "image fit: the BMP set's batches differ from the PNG set's")
    diff = max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))
    out = {name: {k: v for k, v in r.items() if k != "batches"} for name, r in runs.items()}
    out["loss_max_abs_diff"] = diff
    print(f"image fit: one epoch of {len(a['losses'])} micro-steps at {IMGSZ} on the BMP set in {a['seconds']:.1f} s "
          f"(PNG {b['seconds']:.1f} s), its batches bit for bit the PNG set's; losses {a['losses']} vs "
          f"{b['losses']}, max abs difference {diff}; launches {a['launches']}; {card}")
    return out


def phase_image_sources(root: Path, png_cfg, card: str, reps: int = 5):
    """63. The committed BMP, TIFF and WebP fixtures (tests/fixtures/image)
    through the val loader, each against its OpenCV digest (a file OpenCV
    refuses, or a kind not ported, raises its named error); the decode ms of
    a 1024 x 1024 frame in BMP, TIFF LZW, TIFF tiled Deflate, lossless WebP
    and lossy WebP (q75); phase 52's 4000 x 4000 scene as a tiled Deflate
    TIFF, its split_dota crops byte-equal to those of the PNG scene; and
    ``obb predict`` through the CLI on a folder of all seven suffixes, its
    saved labels equal to those of the same pixels as PNG."""
    import hashlib
    import shutil

    from quan_ultralytics_tpu_torch.cfg.datasets import DOTA_V1
    from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
    from quan_ultralytics_tpu_torch.data.native import native, tiff
    from quan_ultralytics_tpu_torch.data.split_dota import get_windows, split_image

    fixtures = Path(__file__).resolve().parent / "tests" / "fixtures"
    digests = {k: v for k, v in json.loads((fixtures / "image_fixtures.json").read_text()).items()
               if not v.get("still")}  # phase 73's: no dataset lists them
    (root / "fixtures" / "images" / "val").mkdir(parents=True)
    (root / "fixtures" / "labels" / "val").mkdir(parents=True)
    refused = 0
    for name, ref in digests.items():
        if "raises" in ref:
            try:
                native.imread(fixtures / "image" / name)
            except (NotImplementedError, ValueError) as e:
                check(type(e).__name__ == ref["raises"], f"image fixtures: {name} raised {type(e).__name__}")
            else:
                check(False, f"image fixtures: {name} decoded; it should raise {ref['raises']}")
            refused += 1
            continue
        shutil.copy(fixtures / "image" / name, root / "fixtures" / "images" / "val" / name)
        (root / "fixtures" / "labels" / "val" / f"{Path(name).stem}.txt").write_text("0 0.2 0.2 0.6 0.2 0.6 0.6 0.2 0.6\n")
    cfg = {"path": str(root / "fixtures"), "train": "images/val", "val": "images/val", "names": DOTA_V1["names"]}
    ds = YOLODataset(cfg, "val", task="obb")
    for i in range(len(ds)):
        name = Path(ds.samples[i].im_file).name
        im = ds.load_image(i)
        check(list(im.shape) == digests[name]["shape"]
              and hashlib.sha256(np.ascontiguousarray(im).tobytes()).hexdigest() == digests[name]["sha256"],
              f"image fixtures: {name} does not decode to its OpenCV pixels")
    n = sum(int(b["img"].shape[0]) for b in build_dataloader(ds, batch_size=len(ds), imgsz=256, augment=False,
                                                             shuffle=False))
    check(n == len(ds) == len(digests) - refused, f"image fixtures: the val loader gave {n} images")
    # decode ms of a 1024 x 1024 frame in each format
    stem = next(Path(s.im_file).stem for s in YOLODataset(png_cfg, "val", task="obb").samples
                if native.read_shape(s.im_file) == (1024, 1024))
    files = {"bmp": "bmp", "tiff_lzw_pred2": "tiff_lzw_pred2", "tiff_tiled_deflate": "tiff_tiled_deflate",
             "webp_lossless": "webp_lossless"}
    paths = {k: Path(png_cfg["path"]).parent / d / "images" / "train" / (stem + IMAGE_SETS[k]) for k, d in files.items()}
    paths["png"] = Path(png_cfg["path"]) / "images" / "train" / f"{stem}.png"
    paths["webp_q75"] = fixtures / "image" / "webp_1024_q75.webp"
    decode_ms = {}
    for k, p in paths.items():
        native.imread(p)
        t0 = time.perf_counter()
        for _ in range(reps):
            im = native.imread(p)
        decode_ms[k] = 1e3 * (time.perf_counter() - t0) / reps
        check(im.shape == (1024, 1024, 3), f"image decode: {p.name} is {im.shape}")
    # the 4000 x 4000 scene as a tiled Deflate TIFF against the PNG scene
    im, lines = split_scene(9)
    crops = {}
    for kind, data in (("png", None), ("tif", tiff.encode(im, compression="deflate", predictor=True, tile=TIFF_TILE))):
        d = root / f"scene_{kind}"
        d.mkdir()
        src = d / f"P9999.{kind}"
        if data is None:
            native.imwrite_png(src, im)
        else:
            src.write_bytes(data)
        (d / "P9999.txt").write_text("\n".join(lines) + "\n")
        t0 = time.perf_counter()
        split_image(str(src), str(d / "P9999.txt"), d / "split" / "images", d / "split" / "labels")
        crops[kind] = {"seconds": time.perf_counter() - t0, "files": sorted((d / "split").rglob("*.*")),
                       "bytes": src.stat().st_size}
    a, b = crops["tif"]["files"], crops["png"]["files"]
    n_crops = sum(x.suffix == ".jpg" for x in a)
    check(len(a) == len(b) and n_crops == len(get_windows(SPLIT_SIZE))
          and all(x.name == y.name and x.read_bytes() == y.read_bytes() for x, y in zip(a, b)),
          "split_dota: the tiled TIFF scene's crops differ from the PNG scene's")
    # obb predict through the CLI on all seven suffixes, against the same pixels as PNG
    pkl = seeded_pkl(root / "images_obb_seeded.pkl", MODEL, NC)
    rng = np.random.default_rng(12)
    mixed, as_png = root / "mixed", root / "mixed_png"
    mixed.mkdir()
    as_png.mkdir()
    for i, suffix in enumerate(MIXED_SUFFIXES):
        h, w = MIXED_SIZE
        yy, xx = np.mgrid[0:h, 0:w]
        frame = np.stack([xx * 200 // w, yy * 200 // h, (xx + yy) * 100 // (h + w)], -1).astype(np.uint8)
        for _ in range(int(rng.integers(2, 12))):
            y0, x0 = int(rng.integers(0, h - 80)), int(rng.integers(0, w - 80))
            frame[y0:y0 + int(rng.integers(20, 80)), x0:x0 + int(rng.integers(20, 80))] = rng.integers(150, 256, 3)
        path = mixed / f"im{i}{suffix}"
        native.imwrite(path, frame)
        native.imwrite_png(as_png / f"im{i}.png", native.imread(path))  # the decoded pixels (JPEG is lossy)
    labels, launches, secs = {}, {}, {}
    for kind, src in (("mixed", mixed), ("png", as_png)):
        _, secs[kind], launches[kind] = _cli(["obb", "predict", f"model={pkl}", f"source={src}", f"imgsz={IMGSZ}",
                                              f"conf={VAL_CONF}", "save_txt=True", "save_conf=True",
                                              f"save_dir={root / ('pred_' + kind)}"])
        labels[kind] = sorted((root / f"pred_{kind}" / "labels").glob("*.txt"))
        check(launches[kind]["qattn_fwd"] > 0 and launches[kind]["qconv1x1_fused"] == 37 * launches[kind]["qattn_fwd"],
              f"image cli predict [{kind}]: launches {launches[kind]}")
    check(len(labels["mixed"]) > 0 and [p.name for p in labels["mixed"]]
          == [p.name for p in labels["png"]] and all(x.read_bytes() == y.read_bytes()
                                                     for x, y in zip(labels["mixed"], labels["png"])),
          "image cli predict: the labels of the mixed folder differ from those of its pixels as PNG")
    rows = sum(len(p.read_text().splitlines()) for p in labels["mixed"])
    out = {"fixtures": len(ds), "fixtures_refused": refused, "decode_1024_ms": decode_ms, "crops": n_crops,
           "split_tiff_s": crops["tif"]["seconds"], "split_png_s": crops["png"]["seconds"],
           "scene_bytes": {k: v["bytes"] for k, v in crops.items()}, "cli_predict_s": secs,
           "launches_cli": launches["mixed"], "launches_cli_png": launches["png"], "label_rows": rows}
    print(f"image sources: {len(ds)} fixtures through the val loader equal to their OpenCV digests, {refused} "
          f"refused by name; decode of a 1024 x 1024 frame "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in decode_ms.items())
          + f" (mean of {reps}); the {SPLIT_SIZE[1]} x {SPLIT_SIZE[0]} scene as a tiled Deflate TIFF "
          f"({crops['tif']['bytes'] / 1e6:.1f} MB) split in {crops['tif']['seconds']:.2f} s, its {n_crops} crops and labels "
          f"byte-equal to the PNG scene's ({crops['png']['seconds']:.2f} s); obb predict of {'/'.join(MIXED_SUFFIXES)} "
          f"through the CLI in {secs['mixed']:.1f} s, {rows} label rows equal to the PNG copies'; {card}")
    return out


# the newer TIFF and JPEG kinds (phases 67-69), written by tests/fixtures/make_image_fixtures.py's container writers
KIND_SETS = {"jpeg_ycbcr_bigtiff": ".tif", "cmyk_lzw": ".tiff"}
KIND_FIXTURES = ("jpeg_cmyk", "jpeg_ycck", "tiff_bigtiff", "tiff_cmyk", "tiff_float32", "tiff_g3_2d", "tiff_gdal",
                 "tiff_jpeg", "tiff_lzma", "tiff_old_jpeg", "tiff_pil_ccitt", "tiff_pil_cmyk", "tiff_pil_jpeg",
                 "tiff_pil_lab", "tiff_pil_ycbcr", "tiff_ycbcr")  # name prefixes of its committed fixtures


def fixture_maker(name: str):
    """tests/fixtures/<name>.py as a module: make_image_fixtures' TIFF
    container writers need numpy, struct, zlib and the port's encoders only,
    make_video_fixtures' container writers numpy and struct (both import
    OpenCV and PIL only where they call them)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / "fixtures" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _encode_kind(maker, name: str, im: np.ndarray) -> bytes:
    """``im`` in one of the new kinds, by the fixture maker's writers."""
    if name == "jpeg_ycbcr_bigtiff":  # GDAL's COMPRESS=JPEG PHOTOMETRIC=YCBCR TILED=YES BIGTIFF=YES
        return maker.gdal_jpeg_tiff(im, tile=TIFF_TILE)
    if name == "cmyk_lzw":
        return maker.tiff_file(maker.cmyk_of(im), {262: (3, [5])}, compress="lzw", rows_per_strip=64)
    if name == "ycbcr420_lzw":
        return maker.ycbcr_file(maker.rgb_to_ycbcr(im), 2, 2, rows_per_strip=64, compress="lzw")
    if name == "cielab":
        return maker.tiff_file(maker.rgb_to_ycbcr(im), {262: (3, [8])}, tile=TIFF_TILE)
    if name == "jpeg_gray_strips":
        return maker.jpeg_tiff(im[..., 1:2], maker.port_jpeg, 1, rows_per_strip=64)
    if name == "bigtiff_deflate":
        return maker.tiff_file(im, {}, tile=TIFF_TILE, predictor=True, big=True)
    bilevel = im[..., 1] < 120
    mode = {"ccitt_g4": "g4", "ccitt_g3_2d": "g3_2d", "ccitt_rle": "rle"}[name]
    return maker.fax_tiff(bilevel, mode, rows_per_strip=128, **(
        {"lsb_first": True, "align_eol": True} if mode == "g3_2d" else {}))


KIND_DECODES = ("jpeg_ycbcr_bigtiff", "jpeg_gray_strips", "ycbcr420_lzw", "cmyk_lzw", "cielab", "ccitt_g4",
                "ccitt_g3_2d", "ccitt_rle", "bigtiff_deflate")


def phase_image_kinds_sources(root: Path, png_cfg, card: str, reps: int = 5):
    """67. The committed fixtures of the newer TIFF and JPEG kinds through the val loader,
    each against its OpenCV digest; the kinds still refused (old-style JPEG,
    YCCK; float, LZMA, CMYK with alpha) raise their named errors; the decode
    ms of a 1024 x 1024 frame (phase 61's) in each new kind and of the
    committed 1024 x 1024 CMYK JPEG."""
    import hashlib
    import shutil

    from quan_ultralytics_tpu_torch.cfg.datasets import DOTA_V1
    from quan_ultralytics_tpu_torch.data import YOLODataset
    from quan_ultralytics_tpu_torch.data.native import native

    fixtures = Path(__file__).resolve().parent / "tests" / "fixtures"
    digests = {k: v for k, v in json.loads((fixtures / "image_fixtures.json").read_text()).items()
               if k.startswith(KIND_FIXTURES)}
    (root / "fixtures" / "images" / "val").mkdir(parents=True)
    (root / "fixtures" / "labels" / "val").mkdir(parents=True)
    refused = {}
    for name, ref in digests.items():
        if "raises" in ref:
            try:
                native.imread(fixtures / "image" / name)
            except (NotImplementedError, ValueError) as e:
                check(type(e).__name__ == ref["raises"] and ref.get("match", "") in str(e),
                      f"image kinds: {name} raised {type(e).__name__}: {e}")
                refused[name] = type(e).__name__
            else:
                check(False, f"image kinds: {name} decoded; it should raise {ref['raises']}")
            continue
        shutil.copy(fixtures / "image" / name, root / "fixtures" / "images" / "val" / name)
        (root / "fixtures" / "labels" / "val" / f"{Path(name).stem}.txt").write_text("0 0.2 0.2 0.6 0.2 0.6 0.6 0.2 0.6\n")
    cfg = {"path": str(root / "fixtures"), "train": "images/val", "val": "images/val", "names": DOTA_V1["names"]}
    ds = YOLODataset(cfg, "val", task="obb")
    check(len(ds) == len(digests) - len(refused) >= 18, f"image kinds: {len(ds)} fixtures in the val set")
    for i in range(len(ds)):
        name = Path(ds.samples[i].im_file).name
        im = ds.load_image(i)
        check(list(im.shape) == digests[name]["shape"]
              and hashlib.sha256(np.ascontiguousarray(im).tobytes()).hexdigest() == digests[name]["sha256"],
              f"image kinds: {name} does not decode to its OpenCV pixels")
    stem = next(Path(s.im_file).stem for s in YOLODataset(png_cfg, "val", task="obb").samples
                if native.read_shape(s.im_file) == (1024, 1024))
    frame = native.imread(Path(png_cfg["path"]) / "images" / "train" / f"{stem}.png")
    maker = fixture_maker("make_image_fixtures")
    paths = {"cmyk_jpeg": fixtures / "image" / "jpeg_cmyk_1024.jpg"}
    for name in KIND_DECODES:
        paths[name] = root / f"frame_{name}.tif"
        paths[name].write_bytes(_encode_kind(maker, name, frame))
    decode_ms, sizes = {}, {}
    for k, path in paths.items():
        native.imread(path)
        t0 = time.perf_counter()
        for _ in range(reps):
            im = native.imread(path)
        decode_ms[k] = 1e3 * (time.perf_counter() - t0) / reps
        sizes[k] = path.stat().st_size
        check(im.shape == (1024, 1024, 3), f"image kinds decode: {path.name} is {im.shape}")
    print(f"image kinds: {len(ds)} fixtures of the newer kinds through the val loader equal to their OpenCV digests, "
          f"{len(refused)} refused by name ({', '.join(f'{k}: {v}' for k, v in refused.items())}); decode of a "
          f"1024 x 1024 frame " + ", ".join(f"{k} {v:.2f} ms ({sizes[k]} B)" for k, v in decode_ms.items())
          + f" (mean of {reps}); {card}")
    return {"fixtures": len(ds), "refused": refused, "decode_1024_ms": decode_ms, "bytes_1024": sizes}


def phase_image_kinds_val_fit(root: Path, png_cfg, card: str):
    """68. Phase 7's set (phase 61's PNG set) written as GDAL's JPEG-YCbCr
    4:2:0 tiled BigTIFF and as CMYK LZW TIFF, and each set's twin: PNGs of
    the port's own decoded pixels of its files. The Validator at 1024 (conf
    0.001, bf16, K1 + K3, seeded weights) on each set and twin: the same kept
    detections and metrics, bit for bit. One ``Trainer.fit`` epoch at 1024
    (bf16, batch 8, the recipe's augmentations, cuDNN deterministic) on the
    JPEG-TIFF set and on its twin: the same loader batches; K1 and K2."""
    import shutil

    from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
    from quan_ultralytics_tpu_torch.data.augment import AugmentHyp
    from quan_ultralytics_tpu_torch.data.native import native
    from quan_ultralytics_tpu_torch.engine.trainer import TrainConfig, Trainer
    from quan_ultralytics_tpu_torch.engine.validator import Validator

    maker = fixture_maker("make_image_fixtures")
    src = Path(png_cfg["path"])
    cfgs, write_s = {}, {}
    for name, suffix in KIND_SETS.items():
        for tag in (name, f"{name}_png"):
            shutil.copytree(src / "labels", root / tag / "labels")
            (root / tag / "images" / "train").mkdir(parents=True)
        t0 = time.perf_counter()
        for p in sorted((src / "images" / "train").glob("*.png")):
            path = root / name / "images" / "train" / (p.stem + suffix)
            path.write_bytes(_encode_kind(maker, name, native.imread(p)))
            native.imwrite_png(root / f"{name}_png" / "images" / "train" / f"{p.stem}.png", native.imread(path))
        write_s[name] = time.perf_counter() - t0
        cfgs[name] = {**png_cfg, "path": str(root / name)}
        cfgs[f"{name}_png"] = {**png_cfg, "path": str(root / f"{name}_png")}
    m = seeded_model(torch.bfloat16, fused_1x1=True)
    nb = math.ceil(len(DATA_SIZES) / BATCH)
    val = {}
    for name, cfg in cfgs.items():
        ds = YOLODataset(cfg, "val", task="obb")
        check({Path(s.im_file).suffix for s in ds.samples} == {KIND_SETS.get(name, ".png")},
              f"image kinds val [{name}]: the set holds other files")
        v = Validator(m, imgsz=IMGSZ, conf=VAL_CONF)
        js = root / f"{name}_dets.json"
        _reset_counts()
        metrics = v(ds, batch_size=BATCH, save_json=str(js))  # the main path
        torch.cuda.synchronize()
        got = _counts()
        check(got == {"qattn_fwd": nb, "qattn_fwd_with_stats": 0, "qattn_bwd": 0, "qconv1x1_fused": 37 * nb},
              f"image kinds val [{name}]: launches {got}")
        val[name] = {"metrics": metrics, "load_ms_a_batch": v.speed["load_ms"], "infer_ms": v.speed["infer_ms"],
                     "detections": json.loads(js.read_text()), "launches": got, "write_s": write_s.get(name)}
    for name in KIND_SETS:
        a, b = val[name], val[f"{name}_png"]
        check(a["detections"] == b["detections"] and a["metrics"] == b["metrics"],
              f"image kinds val [{name}]: the detections or metrics differ from its PNG twin's")
    del m
    torch.cuda.empty_cache()
    fit = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name in ("jpeg_ycbcr_bigtiff", "jpeg_ycbcr_bigtiff_png"):
            tds = YOLODataset(cfgs[name], "train", task="obb")
            steps = len(tds) // BATCH
            tr = Trainer(seeded_model(torch.bfloat16), TrainConfig(batch=BATCH, nbs=BATCH, epochs=1),
                         steps_per_epoch=steps, device=DEVICE)
            batches = []

            def loader(epoch, tds=tds, batches=batches):
                for b in build_dataloader(tds, BATCH, IMGSZ, hyp=AugmentHyp(), augment=True, seed=epoch):
                    batches.append({k: v for k, v in b.items() if isinstance(v, np.ndarray)})
                    yield b

            _reset_counts()
            t0 = time.perf_counter()
            history = tr.fit(loader, None, epochs=1)  # the main path
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = _counts()
            check(got == {"qattn_fwd": steps, "qattn_fwd_with_stats": steps, "qattn_bwd": steps,
                          "qconv1x1_fused": 0}, f"image kinds fit [{name}]: launches {got}")
            check(len(history) == 1 and math.isfinite(history[0]["loss"]), f"image kinds fit [{name}]: {history}")
            fit[name] = {"batches": batches, "seconds": secs, "launches": got, "loss": history[0]["loss"]}
            del tr
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b = fit["jpeg_ycbcr_bigtiff"], fit["jpeg_ycbcr_bigtiff_png"]
    check(len(a["batches"]) == len(b["batches"]) > 0 and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x) for x, y in zip(a["batches"], b["batches"])),
        "image kinds fit: the JPEG-TIFF set's batches differ from its PNG twin's")
    print("image kinds val: " + "; ".join(
        f"{name}: load + letterbox {r['load_ms_a_batch']:.1f} ms a batch of {BATCH}"
        + (f", written in {r['write_s']:.2f} s" if r["write_s"] is not None else "") for name, r in val.items())
        + f"; detections and metrics of each set equal to its PNG twin's bit for bit; fit: one epoch on the "
        f"JPEG-YCbCr BigTIFF set in {a['seconds']:.1f} s (twin {b['seconds']:.1f} s), its batches the twin's, "
        f"losses {a['loss']} and {b['loss']}; launches {a['launches']}; {card}")
    for r in val.values():
        del r["detections"]
    return {"val": val, "fit": {k: {x: y for x, y in r.items() if x != "batches"} for k, r in fit.items()}}


def phase_image_kinds_split_cli(root: Path, card: str):
    """69. Phase 52's 4000 x 4000 scene as a tiled (256) JPEG-YCbCr 4:2:0
    BigTIFF, its ``split_dota`` crops byte-equal to those of the PNG scene of
    its decoded pixels; ``obb predict`` through ``cli.main`` on a folder of
    every new kind (JPEG-YCbCr BigTIFF, JPEG gray strips, raw YCbCr, CMYK,
    CIELab, CCITT G4, G3 2-D and RLE, BigTIFF Deflate, CMYK JPEG), its saved
    labels equal to those of the same pixels as PNG."""
    import shutil

    from quan_ultralytics_tpu_torch.data.native import native
    from quan_ultralytics_tpu_torch.data.split_dota import get_windows, split_image

    maker = fixture_maker("make_image_fixtures")
    im, lines = split_scene(9)
    t0 = time.perf_counter()
    data = _encode_kind(maker, "jpeg_ycbcr_bigtiff", im)
    write_s = time.perf_counter() - t0
    crops = {}
    for kind in ("tif", "png"):
        d = root / f"scene_{kind}"
        d.mkdir(parents=True)
        src = d / f"P9999.{kind}"
        if kind == "tif":
            src.write_bytes(data)
        else:
            native.imwrite_png(src, native.imread(root / "scene_tif" / "P9999.tif"))
        (d / "P9999.txt").write_text("\n".join(lines) + "\n")
        t0 = time.perf_counter()
        split_image(str(src), str(d / "P9999.txt"), d / "split" / "images", d / "split" / "labels")
        crops[kind] = {"seconds": time.perf_counter() - t0, "files": sorted((d / "split").rglob("*.*")),
                       "bytes": src.stat().st_size}
    a, b = crops["tif"]["files"], crops["png"]["files"]
    n_crops = sum(x.suffix == ".jpg" for x in a)
    check(len(a) == len(b) and n_crops == len(get_windows(SPLIT_SIZE))
          and all(x.name == y.name and x.read_bytes() == y.read_bytes() for x, y in zip(a, b)),
          "image kinds split_dota: the JPEG-YCbCr BigTIFF scene's crops differ from its PNG twin's")
    pkl = seeded_pkl(root / "kinds_obb_seeded.pkl", MODEL, NC)
    rng = np.random.default_rng(13)
    mixed, as_png = root / "mixed", root / "mixed_png"
    mixed.mkdir()
    as_png.mkdir()
    kinds = list(KIND_DECODES) + ["cmyk_jpeg"]
    for i, name in enumerate(kinds):
        h, w = MIXED_SIZE
        yy, xx = np.mgrid[0:h, 0:w]
        frame = np.stack([xx * 200 // w, yy * 200 // h, (xx + yy) * 100 // (h + w)], -1).astype(np.uint8)
        for _ in range(int(rng.integers(2, 12))):
            y0, x0 = int(rng.integers(0, h - 80)), int(rng.integers(0, w - 80))
            frame[y0:y0 + int(rng.integers(20, 80)), x0:x0 + int(rng.integers(20, 80))] = rng.integers(150, 256, 3)
        if name == "cmyk_jpeg":  # the committed CMYK JPEG: no CMYK JPEG encoder on the card
            path = mixed / f"im{i}.jpg"
            shutil.copy(Path(__file__).resolve().parent / "tests" / "fixtures" / "image" / "jpeg_cmyk_1024.jpg", path)
        else:
            path = mixed / f"im{i}{'.tiff' if i % 2 else '.tif'}"
            path.write_bytes(_encode_kind(maker, name, frame))
        native.imwrite_png(as_png / f"im{i}.png", native.imread(path))
    labels, launches, secs = {}, {}, {}
    for kind, src in (("kinds", mixed), ("png", as_png)):
        _, secs[kind], launches[kind] = _cli(["obb", "predict", f"model={pkl}", f"source={src}", f"imgsz={IMGSZ}",
                                              f"conf={VAL_CONF}", "save_txt=True", "save_conf=True",
                                              f"save_dir={root / ('pred_' + kind)}"])
        labels[kind] = sorted((root / f"pred_{kind}" / "labels").glob("*.txt"))
        check(launches[kind]["qattn_fwd"] > 0 and launches[kind]["qconv1x1_fused"] == 37 * launches[kind]["qattn_fwd"],
              f"image kinds cli predict [{kind}]: launches {launches[kind]}")
    check(len(labels["kinds"]) > 0 and [p.name for p in labels["kinds"]] == [p.name for p in labels["png"]]
          and all(x.read_bytes() == y.read_bytes() for x, y in zip(labels["kinds"], labels["png"])),
          "image kinds cli predict: the labels of the kinds folder differ from those of its pixels as PNG")
    rows = sum(len(p.read_text().splitlines()) for p in labels["kinds"])
    print(f"image kinds: the {SPLIT_SIZE[1]} x {SPLIT_SIZE[0]} scene as a 256-tiled JPEG-YCbCr 4:2:0 BigTIFF "
          f"({crops['tif']['bytes'] / 1e6:.2f} MB, written in {write_s:.2f} s) split in {crops['tif']['seconds']:.2f} s, "
          f"its {n_crops} crops and labels byte-equal to its PNG twin's ({crops['png']['seconds']:.2f} s); obb "
          f"predict of {len(kinds)} kinds through the CLI in {secs['kinds']:.1f} s, {rows} label rows equal to the PNG "
          f"copies'; {card}")
    return {"crops": n_crops, "split_tiff_s": crops["tif"]["seconds"], "split_png_s": crops["png"]["seconds"],
            "scene_write_s": write_s, "scene_bytes": {k: v["bytes"] for k, v in crops.items()},
            "cli_predict_s": secs, "launches_cli": launches["kinds"], "launches_cli_png": launches["png"],
            "label_rows": rows, "kinds": kinds}


def lap(t_start: float, what: str) -> None:
    """Print the script's seconds so far, after ``what``."""
    print(f"elapsed: {time.perf_counter() - t_start:.1f} s after {what}")


# ---------------------------------------------------------------- phase 73

STILL_SIDE = 512  # the side of the stills whose decode phase 73 times


def _still_files(root: Path) -> dict:
    """kind -> a STILL_SIDE x STILL_SIDE file of that kind: the raw kinds
    written here by make_still_fixtures' numpy writers, the GIF committed."""
    maker = fixture_maker("make_still_fixtures")
    im = maker.image(STILL_SIDE, STILL_SIDE, seed=6)
    gray = im[..., 1]
    root.mkdir(parents=True, exist_ok=True)
    data = {"ppm": maker.pnm(im, 6), "pgm_16bit": maker.pnm(gray.astype(np.uint16) * 257, 5, 65535),
            "pbm": maker.pnm(gray > 128, 4), "ppm_ascii": maker.pnm(im, 3), "pam": maker.pam(im[..., ::-1]),
            "pfm": maker.pfm(im.astype(np.float32)), "ras": maker.sun(im, 24),
            "hdr": maker.hdr(maker.to_rgbe(im.astype(np.float32) / 255))}
    suffix = {"pgm_16bit": ".pgm", "ppm_ascii": ".ppm"}
    files = {}
    for kind, blob in data.items():
        files[kind] = root / f"still_{kind}{suffix.get(kind, '.' + kind)}"
        files[kind].write_bytes(blob)
    files["gif"] = Path(__file__).resolve().parent / "tests" / "fixtures" / "image" / "still_gif_512.gif"
    return files


def phase_still_kinds(root: Path, card: str, reps: int = 5):
    """73. The stills cv2.imread takes outside the dataset formats: every
    committed still fixture (PxM, PAM, PFM, Sun raster, Radiance HDR, GIF)
    through `native.imread` against its OpenCV digest (or its ValueError);
    the decode ms of a 512 x 512 file of each kind; ``obb predict`` at 1024
    through ``cli.main`` of one file of each kind, a call each (f32: its line
    equals the facade's over the decoded array; K1 once and K3 at 37 sites),
    then the bf16 facade on each file against its array within PRED_TOL,
    launches counted."""
    import hashlib

    from quan_ultralytics_tpu_torch.data.native import native
    from quan_ultralytics_tpu_torch.engine.model import YOLO

    fixtures = Path(__file__).resolve().parent / "tests" / "fixtures"
    digests = {k: v for k, v in json.loads((fixtures / "image_fixtures.json").read_text()).items() if v.get("still")}
    raised = 0
    for name, ref in digests.items():
        if ref.get("raises"):
            try:
                native.imread(fixtures / "image" / name)
            except ValueError:
                raised += 1
                continue
            check(False, f"still kinds: {name} decoded; OpenCV reads nothing of it")
        im = native.imread(fixtures / "image" / name)
        check(list(im.shape) == ref["shape"] and hashlib.sha256(im.tobytes()).hexdigest() == ref["sha256"],
              f"still kinds: {name} does not decode to its OpenCV pixels")
    files = _still_files(root / "stills")
    decode_ms, sizes, arrays = {}, {}, []
    for kind, path in files.items():
        arrays.append(native.imread(path))
        t0 = time.perf_counter()
        for _ in range(reps):
            im = native.imread(path)
        decode_ms[kind] = 1e3 * (time.perf_counter() - t0) / reps
        sizes[kind] = path.stat().st_size
        check(im.shape == (STILL_SIDE, STILL_SIDE, 3), f"still kinds decode: {path.name} is {im.shape}")
    pkl = seeded_pkl(root / "still_obb_seeded.pkl", MODEL, NC)
    n = len(files)
    f32 = YOLO(str(pkl), device=DEVICE)
    cli_s, cli_n = 0.0, {}
    for path, im in zip(files.values(), arrays):  # a file a call: predict's source is one path, as in JAX
        text, secs, counts = _cli(["obb", "predict", f"model={pkl}", f"source={path}", f"imgsz={IMGSZ}"])
        check(counts["qattn_fwd"] == 1 and counts["qconv1x1_fused"] == 37, f"still cli predict {path.name}: {counts}")
        r = f32.predict(im, imgsz=IMGSZ)[0]
        check([ln for ln in text.splitlines() if ln.startswith("image ")]
              == [f"image 1/1 {r.orig_shape[1]}x{r.orig_shape[0]} {r.verbose()}"],
              f"still cli predict: the lines of {path.name} differ from the facade's for its decoded array")
        cli_s += secs
        cli_n = {k: cli_n.get(k, 0) + v for k, v in counts.items()}
    y = YOLO(str(pkl), dtype=torch.bfloat16, device=DEVICE)
    y.predict(arrays[:1], imgsz=IMGSZ)  # warm up
    base = [y.predict(im, imgsz=IMGSZ)[0] for im in arrays]
    _reset_counts()
    t0 = time.perf_counter()
    res = [y.predict(str(p), imgsz=IMGSZ)[0] for p in files.values()]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = _counts()
    check(got["qattn_fwd"] == n and got["qconv1x1_fused"] == 37 * n and got["qattn_bwd"] == 0,
          f"still predict: launches {got}")
    tol = PRED_TOL[torch.bfloat16]
    same = len(res) == len(base) == n and all(
        len(a) == len(b) and np.array_equal(a.cls, b.cls)
        and np.abs(a.boxes - b.boxes).max(initial=0.0) <= tol * max(1.0, float(np.abs(b.boxes).max(initial=0.0)))
        for a, b in zip(res, base))
    check(same, "still predict: the files' detections differ from those of their decoded arrays")
    row = {"fixtures": len(digests), "raised": raised, "decode_512_ms": decode_ms, "bytes_512": sizes,
           "cli_s": cli_s, "launches_cli": cli_n, "launches": got, "ms_an_image": 1e3 * secs / n,
           "detections": [len(r) for r in res]}
    print(f"still kinds: {len(digests) - raised} still fixtures equal to their OpenCV digests, {raised} broken ones "
          f"raise ValueError; decode of a {STILL_SIDE} x {STILL_SIDE} file "
          + ", ".join(f"{k} {v:.2f} ms ({sizes[k]} B)" for k, v in decode_ms.items())
          + f" (mean of {reps}); obb predict of the {n} files at {IMGSZ} through the CLI (f32, a call each) in "
          f"{cli_s:.1f} s, "
          f"launches {cli_n}; bf16 facade {row['ms_an_image']:.1f} ms an image, launches {got}, detections "
          f"{row['detections']}; {card}")
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", type=Path,
                    help="also write DIR/chip_smoke_profile.txt and DIR/chip_smoke_details.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    card, ptxas, sfu_rate = phase_device()
    from quan_ultralytics_tpu_torch.models.tasks import fused_1x1_sites

    models = build_models()
    sites = fused_1x1_sites(models["K1+K3"], BATCH, IMGSZ)
    check(len(sites) == 37, f"expected 37 fused 1x1 sites, found {len(sites)}")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    details = []
    with torch.no_grad():
        k1_err, k1_t = phase_k1(gen, details, sfu_rate)
        k2_err, k2_t = phase_k2(gen, details, sfu_rate)
        k3_err, k3_t = phase_k3(gen, sites, details)
    lap(t_start, "the kernel phases")

    frames = make_frames(0)
    pred_out = phase_predict(models, frames, len(sites))
    x, agree = phase_agree(models, frames)
    speed = phase_throughput(models, frames, x)
    tables = [] if args.profile else None
    share = phase_device_share(models, x, speed, tables)
    del models
    torch.cuda.empty_cache()
    lap(t_start, "the OBB predict phases")

    batch = make_train_batch(0)
    train_out = phase_train(batch)
    train_grads = phase_train_grads(batch)
    train_speed = phase_train_speed(batch, tables=tables)
    loss_layer = phase_loss_layer(batch)
    del batch
    torch.cuda.empty_cache()
    lap(t_start, "the OBB train phases")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        data_cfg, data_out = phase_data(Path(tmp) / "dota")
        augment_out = phase_augment(data_cfg)
        weights, fit_out = phase_fit(data_cfg, Path(tmp) / "run")
        val_out = phase_val(data_cfg, weights, Path(tmp) / "val")
        del weights
        torch.cuda.empty_cache()
        cli_out = phase_cli(data_cfg, Path(tmp))
        lap(t_start, "the OBB data, fit, val and cli phases")
        det_cfg, det_data = phase_detect_data(Path(tmp) / "coco")
        det_predict = phase_detect_predict(det_cfg, tables)
        det_train = phase_detect_train(det_cfg)
        det_weights, det_fit = phase_detect_fit(det_cfg, Path(tmp) / "detect_run")
        n_sites = det_predict["fused_1x1_sites"]
        det_val = phase_detect_val(det_cfg, det_weights, Path(tmp) / "detect_val", n_sites)
        del det_weights
        det_cli = phase_detect_cli(det_cfg, Path(tmp), n_sites)
        lap(t_start, "the detect phases")
        segpose = {}
        for task, seed in (("segment", 2), ("pose", 3)):
            sp_cfg, sp_data = phase_segpose_data(Path(tmp) / task, task, seed)
            sp_predict = phase_segpose_predict(sp_cfg, task, tables)
            sp_train = phase_segpose_train(sp_cfg, task, tables)
            sp_weights, sp_fit = phase_segpose_fit(sp_cfg, task, Path(tmp) / f"{task}_run")
            sp_val = phase_segpose_val(sp_cfg, task, sp_weights, sp_predict["fused_1x1_sites"])
            del sp_weights
            sp_cli = phase_segpose_cli(sp_cfg, Path(tmp), task)
            segpose[task] = {"data": sp_data, "predict": sp_predict, "train": sp_train, "fit": sp_fit,
                             "val": sp_val, "cli": sp_cli}
            lap(t_start, f"the {task} phases")
        cifar, imagenet, cls_data = phase_cls_data(Path(tmp) / "cls")
        cls_cifar = phase_cls_cifar(cifar, Path(tmp), tables)
        cls_imagenet = phase_cls_imagenet(imagenet, tables)
        cls_yolo = phase_cls_yolo(gen, tables)
        cls_cli = phase_cls_cli(cifar, Path(tmp))
        lap(t_start, "the classification phases")
        t_hybrid = time.perf_counter()
        hybrid_path = Path(tmp) / "user_models" / HYBRID_NAME
        hybrid_path.parent.mkdir()
        hybrid_path.write_text(HYBRID_YAML)
        hybrid = {"predict": phase_hybrid_predict(det_cfg, hybrid_path, tables),
                  "train": phase_hybrid_train(det_cfg, hybrid_path),
                  "val": phase_hybrid_val(det_cfg, hybrid_path, Path(tmp)),
                  "cli": phase_hybrid_cli(det_cfg, Path(tmp), hybrid_path),
                  "ensemble": phase_hybrid_ensemble(det_cfg, hybrid_path),
                  "resume": phase_hybrid_resume(det_cfg, hybrid_path, Path(tmp))}
        hybrid["seconds"] = time.perf_counter() - t_hybrid
        print(f"hybrid phases: {hybrid['seconds']:.1f} s")
        t_tools = time.perf_counter()
        tools_root = Path(tmp) / "tools"
        tools_root.mkdir()
        tools = {"track": phase_track(tools_root), "benchmark": phase_benchmark(),
                 "export": phase_export(tools_root, data_cfg, frames, x), "embed": phase_embed(tools_root, frames),
                 "tune": phase_tune(tools_root, det_cfg), "autobatch": phase_autobatch(),
                 "cli": phase_cli_track_benchmark(tools_root)}
        tools["seconds"] = time.perf_counter() - t_tools
        print(f"track, benchmark, export, embed, tune, autobatch phases: {tools['seconds']:.1f} s")
        t_plots = time.perf_counter()
        plots = {"predict_save": phase_predict_save(tools_root, frames, card),
                 "segpose": phase_segpose_plot(tools_root, det_cfg, card),
                 "val": phase_val_plots(det_cfg, tools_root, card),
                 "autoaugment": phase_autoaugment(cifar, Path(tmp), cls_cifar, card),
                 "reference_weights": phase_reference_weights(x, card)}
        plots["seconds"] = time.perf_counter() - t_plots
        print(f"plot, autoaugment and reference-weights phases: {plots['seconds']:.1f} s")
        lap(t_start, "the plot, autoaugment and reference-weights phases")
        t_dp = time.perf_counter()
        dp = {"nccl": phase_dp_nccl(make_train_batch(0), card), "gloo": phase_dp_gloo(data_cfg, card),
              "int8": phase_int8(x, frames, card, tables), "split_dota": phase_split_dota(tools_root, card)}
        dp["seconds"] = time.perf_counter() - t_dp
        print(f"data-parallel, int8 and split_dota phases: {dp['seconds']:.1f} s")
        lap(t_start, "the data-parallel, int8 and split_dota phases")
    t_forms = time.perf_counter()
    forms = phase_conv_forms(x, tables)
    print(f"conv forms phase: {time.perf_counter() - t_forms:.1f} s")
    lap(t_start, "the conv forms phase")
    t_stem = time.perf_counter()
    stem_batch = make_train_batch(0)
    stem = {"predict": phase_stem_predict(x, card, tables), "train": phase_stem_train(stem_batch, card),
            "dp": phase_stem_dp(stem_batch, card), "assigner": phase_assigner(stem_batch, x, card)}
    del stem_batch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_readers_") as tmp:
        stem["readers"] = phase_readers(Path(tmp) / "readers", card)
    stem["seconds"] = time.perf_counter() - t_stem
    print(f"stem, assigner and readers phases: {stem['seconds']:.1f} s")
    lap(t_start, "the stem, assigner and readers phases")
    t_video = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_video_") as tmp:
        videos = {"decode": phase_video_decode(card), "track": phase_video_track(Path(tmp), card),
                  "predict": phase_video_predict(Path(tmp), card)}
    videos["seconds"] = time.perf_counter() - t_video
    print(f"video phases: {videos['seconds']:.1f} s")
    lap(t_start, "the video phases")
    t_images = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_images_") as tmp:
        image_cfgs, image_val = phase_image_val(Path(tmp) / "sets", card)
        images = {"val": image_val, "fit": phase_image_fit(image_cfgs, card),
                  "sources": phase_image_sources(Path(tmp) / "sources", image_cfgs["png"], card)}
        images["seconds"] = time.perf_counter() - t_images
        print(f"image phases: {images['seconds']:.1f} s")
        lap(t_start, "the image phases")
        t_kinds = time.perf_counter()
        images["kinds"] = {"sources": phase_image_kinds_sources(Path(tmp) / "kinds", image_cfgs["png"], card),
                           **phase_image_kinds_val_fit(Path(tmp) / "kind_sets", image_cfgs["png"], card),
                           "split_cli": phase_image_kinds_split_cli(Path(tmp) / "kind_split", card)}
        images["kinds"]["seconds"] = time.perf_counter() - t_kinds
    print(f"image kind phases: {images['kinds']['seconds']:.1f} s")
    lap(t_start, "the image kind phases")
    t_asp_vp8 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_video_asp_vp8_") as tmp:
        videos["asp_vp8"] = {"decode": phase_video_asp_vp8_decode(card),
                             "track": phase_video_track(Path(tmp), card, VIDEO_VP8_CLIP),
                             "predict": phase_video_predict(Path(tmp), card, VIDEO_ASP_CLIP)}
    videos["asp_vp8"]["seconds"] = time.perf_counter() - t_asp_vp8
    print(f"VP8 and ASP video phases: {videos['asp_vp8']['seconds']:.1f} s")
    lap(t_start, "the VP8 and ASP video phases")
    t_vp9 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_video_vp9_") as tmp:
        videos["vp9"] = {"decode": phase_video_vp9_decode(card),
                         "track": phase_video_track(Path(tmp), card, VIDEO_VP9_CLIP),
                         "predict": phase_video_predict(Path(tmp), card, vp9_clip_mp4(Path(tmp) / "mp4"))}
    videos["vp9"]["seconds"] = time.perf_counter() - t_vp9
    print(f"VP9 video phases: {videos['vp9']['seconds']:.1f} s")
    lap(t_start, "the VP9 video phases")
    t_h263 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_h263_") as tmp:
        images["stills"] = phase_still_kinds(Path(tmp), card)
        videos["h263"] = {"decode": phase_video_h263_decode(card),
                          "track": phase_video_track(Path(tmp), card, VIDEO_DIV3_CLIP),
                          "predict": phase_video_predict(Path(tmp), card, VIDEO_DIV3_CLIP)}
    videos["h263"]["seconds"] = time.perf_counter() - t_h263
    print(f"still and H.263 family phases: {videos['h263']['seconds']:.1f} s")
    lap(t_start, "the still and H.263 family phases")
    t_wmv = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wmv_") as tmp:
        videos["wmv"] = {"decode": phase_video_wmv_decode(card),
                         "track": phase_video_track(Path(tmp), card, VIDEO_WMV2_CLIP),
                         "predict": phase_video_predict(Path(tmp), card, VIDEO_WMV2_CLIP)}
    videos["wmv"]["seconds"] = time.perf_counter() - t_wmv
    print(f"WMV video phases: {videos['wmv']['seconds']:.1f} s")
    lap(t_start, "the WMV video phases")
    classify = {"data": cls_data, "cifar": cls_cifar, "imagenet": cls_imagenet, "yolo": cls_yolo, "cli": cls_cli}
    detect = {"data": det_data, "predict": det_predict, "train": det_train, "fit": det_fit, "val": det_val,
              "cli": det_cli}
    if args.profile:
        out_dir = args.profile
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "chip_smoke_profile.txt").write_text("\n".join(tables))
        (out_dir / "chip_smoke_details.json").write_text(json.dumps(
            {"card": card, "ptxas": ptxas, "cases": details, "predict": pred_out,
             "agree": agree, "speed": speed, "device": share, "train": train_out,
             "train_grads": train_grads, "train_speed": train_speed,
             "loss_layer": loss_layer, "data": data_out, "augment": augment_out, "fit": fit_out,
             "val": val_out, "cli": cli_out, "detect": detect, "segpose": segpose, "classify": classify,
             "hybrid": hybrid, "tools": tools, "plots": plots, "conv_forms": forms, "data_parallel": dp,
             "stem": stem, "video": videos, "images": images},
            indent=1, default=str))

    launches = pred_out["launches"]["K1+K3"]
    on_path = share["K1+K3"]["kernel_device_ms"]  # device ms per forward, from the profiler
    train_launches = train_out["launches"]
    on_train = train_speed["fused"]["kernel_device_ms"]  # device ms per micro-step
    fit_launches, val_launches = fit_out["launches"], val_out["launches"]
    cli_launches, facade_launches = cli_out["launches"], cli_out["launches_facade_fused"]
    det_launches = {"detect_predict": det_predict["launches"]["K1+K3"], "detect_train": det_train["launches"],
                    "detect_fit": det_fit["launches"], "detect_val": det_val["launches"],
                    "detect_val_rect": det_val["launches_rect"], "detect_cli": det_cli["launches"],
                    "detect_facade_fused_1x1": det_cli["launches_facade_fused"]}
    # each kernel launched on every detect path that runs it (K3: the fused_1x1 runs)
    for path in ("detect_predict", "detect_train", "detect_fit", "detect_val", "detect_val_rect", "detect_cli",
                 "detect_facade_fused_1x1"):
        check(det_launches[path]["qattn_fwd"] > 0, f"K1 did not launch on {path}")
    for path in ("detect_train", "detect_fit", "detect_cli"):
        check(det_launches[path]["qattn_bwd"] > 0, f"K2 did not launch on {path}")
    for path in ("detect_predict", "detect_val", "detect_val_rect", "detect_facade_fused_1x1"):
        check(det_launches[path]["qconv1x1_fused"] > 0, f"K3 did not launch on {path}")
    # the segment and pose paths: K1 on each, K2 where it trains, K3 on the fused_1x1 runs
    for task, tag in (("segment", "seg"), ("pose", "pose")):
        sp = segpose[task]
        det_launches.update({f"{tag}_predict": sp["predict"]["launches"]["K1+K3"],
                             f"{tag}_train": sp["train"]["launches"], f"{tag}_fit": sp["fit"]["launches"],
                             f"{tag}_val": sp["val"]["launches"], f"{tag}_cli": sp["cli"]["launches"]})
        if task == "segment":
            det_launches["seg_val_native"] = sp["val"]["launches_native"]
    for path in [k for k in det_launches if k.startswith(("seg_", "pose_"))]:
        check(det_launches[path]["qattn_fwd"] > 0, f"K1 did not launch on {path}")
        if path.endswith(("_train", "_fit", "_cli")):
            check(det_launches[path]["qattn_bwd"] > 0, f"K2 did not launch on {path}")
        if path.endswith(("_predict", "_val")):
            check(det_launches[path]["qconv1x1_fused"] > 0, f"K3 did not launch on {path}")
    # the classification paths: K1 on the YOLO-cls forward, K3 on its fused_1x1 run, K2 under its gradient check
    det_launches.update({"cls_yolo": cls_yolo["launches"]["K1 torch.bfloat16"],
                         "cls_yolo_fused": cls_yolo["launches"]["K1+K3 torch.bfloat16"],
                         "cls_yolo_grad": cls_yolo["grad"]["launches"]})
    for path in ("cls_yolo", "cls_yolo_fused", "cls_yolo_grad"):
        check(det_launches[path]["qattn_fwd"] > 0, f"K1 did not launch on {path}")
    check(det_launches["cls_yolo_fused"]["qconv1x1_fused"] > 0, "K3 did not launch on cls_yolo_fused")
    check(det_launches["cls_yolo_grad"]["qattn_bwd"] > 0, "K2 did not launch on cls_yolo_grad")
    # the user's model YAML (QPSA: K1 and K2 at dk = dv = 4): K1 on each path, K2 where it trains,
    # K3 on its fused_1x1 predict
    det_launches.update({"hybrid_predict": hybrid["predict"]["launches"]["K1"],
                         "hybrid_predict_fused_1x1": hybrid["predict"]["launches"]["K1+K3"],
                         "hybrid_train": hybrid["train"]["launches"], "hybrid_val": hybrid["val"]["launches"],
                         "hybrid_cli": hybrid["cli"]["launches"], "hybrid_ensemble": hybrid["ensemble"]["launches"],
                         "hybrid_resume": hybrid["resume"]["launches"]})
    for path in [k for k in det_launches if k.startswith("hybrid_")]:
        check(det_launches[path]["qattn_fwd"] > 0, f"K1 did not launch on {path}")
    for path in ("hybrid_train", "hybrid_cli", "hybrid_resume"):
        check(det_launches[path]["qattn_bwd"] > 0, f"K2 did not launch on {path}")
    check(det_launches["hybrid_predict_fused_1x1"]["qconv1x1_fused"] == HYBRID_SITES,
          "K3 did not launch at every fused site on hybrid_predict_fused_1x1")
    # the track, benchmark, export (the facade predicting from the .pt2), embed and tune paths, and
    # the CLI's track, benchmark, tune and export (obb export, then obb predict of the .pt2)
    det_launches.update({"track_bytetrack": tools["track"]["bytetrack"]["launches"],
                         "track_botsort": tools["track"]["botsort"]["launches"],
                         "benchmark": tools["benchmark"]["launches"], "export": tools["export"]["launches"],
                         "embed": tools["embed"]["launches"], "tune": tools["tune"]["launches"],
                         "cli_track": tools["cli"]["launches_track"],
                         "cli_benchmark": tools["cli"]["launches_benchmark"],
                         "cli_tune": tools["tune"]["launches_cli"], "cli_export": tools["export"]["launches_cli"]})
    for path in ("track_bytetrack", "track_botsort", "benchmark", "export", "embed", "tune", "cli_track",
                 "cli_benchmark", "cli_tune", "cli_export"):
        check(det_launches[path]["qattn_fwd"] > 0, f"K1 did not launch on {path}")
        check(det_launches[path]["qconv1x1_fused"] > 0, f"K3 did not launch on {path}")
    for path in ("tune", "cli_tune"):
        check(det_launches[path]["qattn_bwd"] > 0, f"K2 did not launch on {path}")
    # predict save / visualize (f32 through the CLI, bf16 through the facade), the segment and pose
    # plots, the validator's images and the reference-weights infer: K1 and K3 on each
    det_launches.update({"cli_predict_save": plots["predict_save"]["launches_cli"],
                         "predict_plot": plots["predict_save"]["launches_predict"],
                         "predict_visualize": plots["predict_save"]["launches_visualize"],
                         "seg_plot": plots["segpose"]["seg"]["launches"],
                         "pose_plot": plots["segpose"]["pose"]["launches"],
                         "val_plots": plots["val"]["launches"],
                         "reference_weights": plots["reference_weights"]["launches"]})
    for path in ("cli_predict_save", "predict_plot", "predict_visualize", "seg_plot", "pose_plot", "val_plots",
                 "reference_weights"):
        check(det_launches[path]["qattn_fwd"] > 0, f"K1 did not launch on {path}")
        check(det_launches[path]["qconv1x1_fused"] > 0, f"K3 did not launch on {path}")
    # data parallelism (NCCL at world size 1; two gloo ranks on the card: train, val, predict)
    # and int8 serving: K1 and K2 where it trains, K1 and K3 where it infers
    det_launches["dp_nccl_train"] = dp["nccl"]["launches"]
    for r in dp["gloo"]["ranks"]:
        for what in ("train", "val", "predict"):
            det_launches[f"dp_gloo_{what}_rank{r['rank']}"] = r[f"launches_{what}"]
    det_launches.update({"int8_fused_1x1": dp["int8"]["launches"]["int8 fused_1x1"],
                         "int8": dp["int8"]["launches"]["int8"]})
    for path in [k for k in det_launches if k.startswith(("dp_", "int8"))]:
        check(det_launches[path]["qattn_fwd"] > 0, f"K1 did not launch on {path}")
        if "train" in path:
            check(det_launches[path]["qattn_bwd"] > 0, f"K2 did not launch on {path}")
        elif path != "int8":
            check(det_launches[path]["qconv1x1_fused"] > 0, f"K3 did not launch on {path}")
    # the stem's forms: predict (K1 and K3), a train micro-step with and without stem_remat (K1 and K2), NCCL
    for name, r in stem["predict"]["modes"].items():
        det_launches[f"stem_{name}_predict"] = r["launches"]
    for key, r in stem["train"].items():
        if "launches" in r:
            det_launches[f"stem_{key.replace(' ', '_')}_train"] = r["launches"]
    det_launches["stem_deep1_dp_nccl_train"] = stem["dp"]["launches"]
    for path in [k for k in det_launches if k.startswith("stem_")]:
        check(det_launches[path]["qattn_fwd"] > 0, f"K1 did not launch on {path}")
        if path.endswith("_train"):
            check(det_launches[path]["qattn_bwd"] > 0, f"K2 did not launch on {path}")
        else:
            check(det_launches[path]["qconv1x1_fused"] > 0, f"K3 did not launch on {path}")
    # the video sources: detect track (CLI, ByteTrack; facade, BoT-SORT) and obb predict (CLI; bf16 facade)
    det_launches.update({"video_cli_track": videos["track"]["launches_cli"],
                         "video_track_botsort": videos["track"]["launches"],
                         "video_cli_predict": videos["predict"]["launches_cli"],
                         "video_predict": videos["predict"]["launches"]})
    for path in ("video_cli_track", "video_track_botsort", "video_cli_predict", "video_predict"):
        check(det_launches[path]["qattn_fwd"] > 0, f"K1 did not launch on {path}")
        check(det_launches[path]["qconv1x1_fused"] > 0, f"K3 did not launch on {path}")
    # the VP8 and ASP video sources: detect track of the VP8 WebM (CLI, ByteTrack; facade, BoT-SORT) and
    # obb predict of the Xvid ASP AVI (CLI; bf16 facade)
    asp_vp8 = videos["asp_vp8"]
    det_launches.update({"video_vp8_cli_track": asp_vp8["track"]["launches_cli"],
                         "video_vp8_track_botsort": asp_vp8["track"]["launches"],
                         "video_asp_cli_predict": asp_vp8["predict"]["launches_cli"],
                         "video_asp_predict": asp_vp8["predict"]["launches"]})
    for path in ("video_vp8_cli_track", "video_vp8_track_botsort", "video_asp_cli_predict", "video_asp_predict"):
        check(det_launches[path]["qattn_fwd"] > 0, f"K1 did not launch on {path}")
        check(det_launches[path]["qconv1x1_fused"] > 0, f"K3 did not launch on {path}")
    # VP9: detect track of the VP9 WebM (CLI, ByteTrack; facade, BoT-SORT) and obb predict of its packets in
    # MP4 (CLI; bf16 facade)
    vp9 = videos["vp9"]
    det_launches.update({"video_vp9_cli_track": vp9["track"]["launches_cli"],
                         "video_vp9_track_botsort": vp9["track"]["launches"],
                         "video_vp9_cli_predict": vp9["predict"]["launches_cli"],
                         "video_vp9_predict": vp9["predict"]["launches"]})
    for path in ("video_vp9_cli_track", "video_vp9_track_botsort", "video_vp9_cli_predict", "video_vp9_predict"):
        check(det_launches[path]["qattn_fwd"] > 0, f"K1 did not launch on {path}")
        check(det_launches[path]["qconv1x1_fused"] > 0, f"K3 did not launch on {path}")
    # the stills outside the dataset formats (obb predict through the CLI, bf16 facade) and the DIV3 clip:
    # detect track (CLI, ByteTrack; facade, BoT-SORT) and obb predict (CLI; bf16 facade)
    h263 = videos["h263"]
    det_launches.update({"still_cli_predict": images["stills"]["launches_cli"],
                         "still_predict": images["stills"]["launches"],
                         "video_div3_cli_track": h263["track"]["launches_cli"],
                         "video_div3_track_botsort": h263["track"]["launches"],
                         "video_div3_cli_predict": h263["predict"]["launches_cli"],
                         "video_div3_predict": h263["predict"]["launches"]})
    for path in ("still_cli_predict", "still_predict", "video_div3_cli_track", "video_div3_track_botsort",
                 "video_div3_cli_predict", "video_div3_predict"):
        check(det_launches[path]["qattn_fwd"] > 0, f"K1 did not launch on {path}")
        check(det_launches[path]["qconv1x1_fused"] > 0, f"K3 did not launch on {path}")
    # the WMV2 clip: detect track (CLI, ByteTrack; facade, BoT-SORT) and obb predict (CLI; bf16 facade)
    wmv = videos["wmv"]
    det_launches.update({"video_wmv2_cli_track": wmv["track"]["launches_cli"],
                         "video_wmv2_track_botsort": wmv["track"]["launches"],
                         "video_wmv2_cli_predict": wmv["predict"]["launches_cli"],
                         "video_wmv2_predict": wmv["predict"]["launches"]})
    for path in ("video_wmv2_cli_track", "video_wmv2_track_botsort", "video_wmv2_cli_predict", "video_wmv2_predict"):
        check(det_launches[path]["qattn_fwd"] > 0, f"K1 did not launch on {path}")
        check(det_launches[path]["qconv1x1_fused"] > 0, f"K3 did not launch on {path}")
    # the image formats: val on each set (K1 and K3), the BMP and PNG fit epochs (K1 and K2), obb predict
    # of the mixed folder and of its PNG copies through the CLI (K1 and K3)
    det_launches.update({f"image_val_{name}": r["launches"] for name, r in images["val"].items()})
    det_launches.update({"image_fit_bmp": images["fit"]["bmp"]["launches"],
                         "image_fit_png": images["fit"]["png"]["launches"],
                         "image_cli_predict_mixed": images["sources"]["launches_cli"],
                         "image_cli_predict_png": images["sources"]["launches_cli_png"]})
    # the newer TIFF and JPEG kinds: val on each kind set and its PNG twin (K1 and K3), the JPEG-TIFF set's fit epoch and
    # its twin's (K1 and K2), obb predict of the kinds folder and of its PNG copies through the CLI (K1 and K3)
    kinds = images["kinds"]
    det_launches.update({f"image_val_{name}": r["launches"] for name, r in kinds["val"].items()})
    det_launches.update({f"image_fit_{name}": r["launches"] for name, r in kinds["fit"].items()})
    det_launches.update({"image_cli_predict_kinds": kinds["split_cli"]["launches_cli"],
                         "image_cli_predict_kinds_png": kinds["split_cli"]["launches_cli_png"]})
    for path in [k for k in det_launches if k.startswith("image_")]:
        check(det_launches[path]["qattn_fwd"] > 0, f"K1 did not launch on {path}")
        if path.startswith("image_fit"):
            check(det_launches[path]["qattn_bwd"] > 0, f"K2 did not launch on {path}")
        else:
            check(det_launches[path]["qconv1x1_fused"] > 0, f"K3 did not launch on {path}")
    cls_t = cls_yolo["timing"]
    kernels = [
        {"name": "qattn_fwd", "route": "cuda", "source": "quan_ultralytics_tpu_torch/csrc/qattn_fwd.cu",
         "replaces": "quan_ultralytics_tpu/ops/pallas/qattn.py:60",
         "launches": launches["qattn_fwd"],
         "launches_by_path": {"predict": launches["qattn_fwd"], "train": train_launches["qattn_fwd"],
                              "fit": fit_launches["qattn_fwd"], "val": val_launches["qattn_fwd"],
                              "cli": cli_launches["qattn_fwd"], "facade_fused_1x1": facade_launches["qattn_fwd"],
                              **{k: v["qattn_fwd"] for k, v in det_launches.items()}},
         "max_abs_err": k1_err,
         "kernel_ms": k1_t["ms"], **k1_t, "path_device_ms": on_path["qattn_fwd_"],
         "train_device_ms": on_train["qattn_fwd_"],
         # yolo11n-cls-quan at 224: G = 256, N = 49, alone
         "cls_n49": {"bf16": cls_t["k1 torch.bfloat16"], "f32_ms": cls_t["k1 torch.float32"]["ms"]},
         "shape": f"G={BATCH * 32} N=1024 dk=2 dv=4 bf16",
         # operators quan_torch::qattention_fwd in the exported OBB graph (.pt2, bf16 and f32)
         "export_graph_nodes": tools["export"]["graph_ops"]["quan_torch.qattention_fwd.default"],
         "library": "torch.nn.functional.scaled_dot_product_attention"},
        {"name": "qattn_bwd", "route": "cuda", "source": "quan_ultralytics_tpu_torch/csrc/qattn_bwd.cu",
         "replaces": "quan_ultralytics_tpu/ops/pallas/qattn.py:86",
         "launches": train_launches["qattn_bwd"],
         "launches_by_path": {"predict": launches["qattn_bwd"], "train": train_launches["qattn_bwd"],
                              "fit": fit_launches["qattn_bwd"], "val": val_launches["qattn_bwd"],
                              "cli": cli_launches["qattn_bwd"], "facade_fused_1x1": facade_launches["qattn_bwd"],
                              **{k: v["qattn_bwd"] for k, v in det_launches.items()}},
         "max_abs_err": k2_err, "kernel_ms": k2_t["ms"], **k2_t,
         "train_device_ms": on_train["qattn_bwd_"],
         # device ms a micro-step on the segment and pose train paths at 640 (N = 400), from the profiler
         "train_640_device_ms": {t: segpose[t]["train"]["device"].get("kernel_device_ms", {}).get("qattn_bwd_")
                                 for t in segpose},
         "cls_n49": {"bf16": cls_t["k2 torch.bfloat16"]},
         "shape": f"G={BATCH * 32} N=1024 dk=2 dv=4 bf16",
         "library": "torch.autograd.grad of torch.nn.functional.scaled_dot_product_attention "
                    "(retained graph)"},
        {"name": "qconv1x1_fused", "route": "cuda",
         "source": "quan_ultralytics_tpu_torch/csrc/qconv1x1_fused.cu",
         "replaces": "quan_ultralytics_tpu/ops/pallas/qconv_fused.py:35",
         "launches": launches["qconv1x1_fused"],
         "launches_by_path": {"predict": launches["qconv1x1_fused"],
                              "train": train_launches["qconv1x1_fused"],
                              "fit": fit_launches["qconv1x1_fused"],
                              "val": val_launches["qconv1x1_fused"],
                              "cli": cli_launches["qconv1x1_fused"],
                              "facade_fused_1x1": facade_launches["qconv1x1_fused"],
                              **{k: v["qconv1x1_fused"] for k, v in det_launches.items()}},
         "max_abs_err": k3_err,
         "kernel_ms": k3_t["ms"], **k3_t, "path_device_ms": on_path["qconv1x1_"],
         # yolo11n-cls-quan's Classify conv alone: Ci = 64, Co = 320 (channel tiles), P = 392
         "cls_classify_site": {"bf16": cls_t["k3 torch.bfloat16"], "f32_ms": cls_t["k3 torch.float32"]["ms"]},
         "shape": f"the {len(sites)} fused sites of one forward, batch {BATCH} @ {IMGSZ}, bf16, "
                  "times summed",
         "export_graph_nodes": tools["export"]["graph_ops"]["quan_torch.qconv1x1_fused.default"],
         "library": "torch.matmul with the mixing folded into the weights, no affine or SiLU "
                    "(a partial yardstick)"},
    ]
    print(json.dumps({"speed": {name: {k: v for k, v in row.items() if not k.endswith("_rounds")}
                                for name, row in speed.items()}, "device": share}))
    print(json.dumps({"train": {name: {k: v for k, v in row.items() if k != "ms_rounds"}
                                for name, row in train_speed.items()},
                      "train_grads_f32": train_grads,
                      "loss_layer_ms": {f"M={k}": v for k, v in loss_layer.items()}}))
    print(json.dumps({"data": data_out, "augment": augment_out,
                      "fit": {k: v for k, v in fit_out.items() if k != "history"},
                      "val": {name: {"metrics": r["metrics"], "speed": r["speed"]}
                              for name, r in val_out["paths"].items()},
                      "val_agree": val_out["agree"], "val_ties": val_out["ties"],
                      "cli": {k: v for k, v in cli_out.items() if k != "history"}}))
    print(json.dumps({"detect": {
        "data": det_data, "predict": {k: v for k, v in det_predict.items() if k != "device"},
        "predict_device": det_predict["device"],
        "train": {k: v for k, v in det_train.items() if k != "ms_steps"},
        "fit": {k: v for k, v in det_fit.items() if k != "history"},
        "val": {name: {"metrics": r["metrics"], "speed": r["speed"], "attention_n": r["attention_n"]}
                for name, r in det_val["paths"].items()},
        "val_agree": det_val["agree"], "cli": det_cli}}))
    print(json.dumps({"segpose": {task: {
        "data": sp["data"], "predict": {k: v for k, v in sp["predict"].items() if k != "device"},
        "predict_device": sp["predict"]["device"],
        "train": {k: v for k, v in sp["train"].items() if k != "ms_steps"},
        "fit": {k: v for k, v in sp["fit"].items() if k != "history"},
        "val": {name: {"metrics": r["metrics"], "speed": r["speed"]} for name, r in sp["val"]["paths"].items()},
        "val_agree": sp["val"]["agree"], "cli": sp["cli"]} for task, sp in segpose.items()}}))
    print(json.dumps({"classify": {
        "data": cls_data, "cifar": {k: v for k, v in cls_cifar.items() if k != "metrics"},
        "cifar_metrics": cls_cifar["metrics"][-1],
        "imagenet": {m: {k: v for k, v in r.items() if k != "top"} for m, r in cls_imagenet.items()},
        "yolo": {k: v for k, v in cls_yolo.items() if k not in ("infer_ms_rounds", "attention_n")},
        "cli": {k: v for k, v in cls_cli.items() if k != "metrics"}}}, default=str))
    hp = hybrid["predict"]
    print(json.dumps({"hybrid": {
        "predict": {k: v for k, v in hp.items() if k != "device"}, "predict_device": hp["device"],
        "train": {k: v for k, v in hybrid["train"].items() if k != "ms_steps"},
        **{k: hybrid[k] for k in ("val", "cli", "ensemble", "resume", "seconds")}}}, default=str))
    print(json.dumps({"tools": {
        "track": tools["track"], "benchmark": tools["benchmark"]["rows"],
        "export": {k: v for k, v in tools["export"].items() if k != "infer_ms_rounds"},
        "embed": tools["embed"], "tune": tools["tune"], "autobatch": tools["autobatch"],
        "cli": tools["cli"], "seconds": tools["seconds"]}}, default=str))
    print(json.dumps({"plots": plots}, default=str))
    print(json.dumps({"data_parallel": {"nccl": dp["nccl"], "gloo": dp["gloo"]}, "int8": {
        k: v for k, v in dp["int8"].items() if k != "rounds"}, "split_dota": dp["split_dota"],
        "seconds": dp["seconds"]}, default=str))
    print(json.dumps({"stem": {
        "predict": {n: {k: v for k, v in r.items() if not k.endswith("_rounds")}
                    for n, r in stem["predict"]["modes"].items()},
        "train": stem["train"], "dp": stem["dp"], "assigner": stem["assigner"], "readers": stem["readers"],
        "seconds": stem["seconds"]}}, default=str))
    print(json.dumps({"video": videos}, default=str))
    print(json.dumps({"images": images}, default=str))
    # ROADMAP Queue 3, "Defaults chosen on the H100": the TPU-chosen defaults, by the numbers of this run
    print(json.dumps({"defaults": {
        "stem": {"choice": stem["predict"]["default"], "faster": stem["predict"]["faster"],
                 "device_ms": {n: r["device_ms"] for n, r in stem["predict"]["modes"].items()},
                 "host_ms": {n: r["host_ms"] for n, r in stem["predict"]["modes"].items()}},
        "conv_forms": {w: {"mean_device_ms": r["mean_device_ms"], "best": r["best"],
                           "host_ms": {a: [x["host_ms"] for x in rs] for a, rs in r["arms"].items()}}
                       for w, r in forms.items() if w != "fused_1x1"},
        "assigner_bf16": {"M=128 bf16": loss_layer[TRAIN_M], "M=128 f32": loss_layer[f"{TRAIN_M} f32 assigner"]},
        "fused_1x1": {"obb_infer_arms": forms["fused_1x1"],
                      "obb_infer_device_ms": {n: share[n]["device_ms"] for n in ("K1", "K1+K3")},
                      "obb_infer_host_ms": {n: speed[n]["infer_ms"] for n in ("K1", "K1+K3")},
                      "detect_infer_device_ms": {n: det_predict["device"][f"detect {n}"]["device_ms"]
                                                 for n in ("K1", "K1+K3")},
                      "detect_infer_host_ms": {n: det_predict["speed"][f"detect {n}"]["infer_ms"]
                                               for n in ("K1", "K1+K3")}}}}))
    print(json.dumps({"kernels": kernels}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
