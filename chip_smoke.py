#!/usr/bin/env python
"""Drive the PyTorch/CUDA port (isopoints_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit; build every kernel under
     isopoints_torch/csrc/ (one nvcc per source, in parallel); count the
     tensor-core instructions (HMMA, HGMMA) in the SASS of the libraries of
     the kernels on mlp_mma.cuh's tile, fused_mlp, fused_igr, fused_sampler
     and fused_trace, and of their `_wide` twins (the instances above 256,
     on mlp_wide.cuh's wgmma tile) (`cuobjdump --dump-sass`; none in any
     is a failure, and so is an HMMA, no HGMMA or a spill in a `_wide`
     one), and print each one's registers and spills from nvcc's -Xptxas
     -v log;
  2. each kernel against its plain PyTorch version at full width (seeded):
     the fused SIREN MLP (3x256) value and value+grad on 262,144 points and
     the sampler on 16,384 rays (also equal to sweep_plain over the fused
     callable bit for bit: every point on fused_mlp's tile); the kNN on sphere clouds (P=8000 k=6,
     P=3000 k=8, P=6000 k=16, self-excluded) and on adversarial clouds
     (`knn_clouds`: exact duplicates, an integer lattice, masked points and
     queries, two clusters far apart, at ~3000 and at 20,480 points, past
     knn.SORT_MIN; k = 1, 8, 16, with and without self-exclusion),
     distances and indices equal bit for bit; the splat candidate
     selection and fine stage on an 8000-point sphere cloud in 2 views at
     256 px (T=16, M=256, K=5, strip 2048), the fine stage also on each
     tile's candidate list permuted (the same maps, `used` and `slots`
     permuted to match). Max error against the stated tolerance, kernel
     and plain times (median of 7 after warm-up, CUDA events) and the
     bound;
  3. the warm-up path: isopoints_torch/configs/mvr_warmup_siren.yml, 3
     warm-up train_steps, every launch counter set to 0 just before and
     read just after; the same step's loss with the fused kernels and with
     the plain field on identical draws must agree;
  4. the projected path: isopoints_torch/configs/mvr_projected_siren.yml
     through the factories, 2 warm-up steps, the resample at it=2 and 6
     more projected steps, counters set to 0 just before and read just
     after (all five kernels must have launched); the projected step's
     median time, the resample step's time, fused_mlp's launches by shape
     and each kernel's launches per projected step (the two visibility
     rasters: 2 selection and 2 fine launches, and no splat_zbuf_bwd or
     occ_bwd launch, since the rasters build no graph); one projected
     step's losses with the kernels and with
     the plain versions on identical draws must agree (rtol 1e-2, iso-point
     counts within 0.5% of the capacity);
  5. the kNN, selection and fine kernels against their plain versions on
     the projected run's own clouds, at the shapes the path gives them:
     the 3000-point iso-point buffer of the projected steps and the
     6000-point buffer of the resample, with their Newton normals and
     splat spacing, in the step's views and the back camera's (the same
     exact checks as phase 2); the kNN there at k=6 and 8 (3000 points),
     k=6 and 16 (6000) and k=8 on the resample's 8000-point seed; the
     selection and the fine stage timed on the projected-step buffer in
     the step's views, as the path calls them (wrapper, CUDA events) and
     alone (calls queued behind a spin of the card between two events, so
     no host time is inside; the selection's one torch.sum taken off);
  6. the trace path (isopoints_torch.bench): the 4x256 IGR bench field
     fitted to the r=0.6 sphere, 262,144 rays traced under the production
     schedule three ways: with the fused MLP and the in-kernel sampler,
     again with the in-kernel march (`trace_in_kernel`), and with every
     plain version. Counters set to 0 before each trace and read after it
     (fused_igr, fused_sampler and trace_march must launch); fused_igr's
     launches of the kernel trace by mode and point count (both modes must
     launch); hit masks and depths compared (the march route equal to the
     loop route, the plain route against the kernel route within the
     stated tolerances); the converged-ray invariant (every hit the trace
     finished without the sampler has f_fine <= thr at its point, exactly
     on the fused-MLP and the march route, within 1e-6 on the plain route);
     both overflow counters 0; median trace ms and rays/s; Newton
     projection rate and converged fraction of 65,536 points (f32, bf16,
     hybrid);
  7. the IGR kernels against their plain versions at full width on that
     field: fused_igr value and value+grad on 262,144 and 524,288 points
     in f32 (3xTF32) and bf16, and at the f32 mode's most frequent trace
     shape; the coarse IGR sampler on the 24,576-ray sampler buffers of
     the kernel route's and the plain route's traces (100 steps + 8 secant,
     margin 2e-3), all four outputs equal to sweep_plain over the fused
     bf16 (sweep) and f32 (fine) callables bit for bit, and against the
     plain version within the stated bars (z_secant within 1e-4 or
     IGR_F32_TOL over the ray's slope, a bar the same kernel with the bf16
     fine field must miss; a shortfall of the unconditioned 1e-4 bar is
     printed beside both versions' agreement with the exactly summed fine
     field: a known fault, ROADMAP Queue 3); the march on the trace's own
     first compacted stage (ceil(0.65 x 262,144) rays, 3 iterations), equal
     to march_plain over the fused f32 callable bit for bit and against the
     plain version; max error against the stated tolerance, kernel and
     plain times and the bound (f32 MLP work as three tf32 passes over the
     tf32 peak in every row); the f32 tile's values against exactly summed
     ones (`exact_sums`) beside cuBLAS's float32 values (TF32 off) on the
     same points: the sampler's fine evaluations on both trace buffers and
     the f32 mode's most frequent trace launch, RMS and max |err| and the
     share within 1e-6, the tile's RMS at most F32_EXACT_RATIO x cuBLAS's;
  8. the splat path at bench.py's size (isopoints_torch.bench): 24,576
     splats on the r=0.7 sphere at 512 px (strip 1280); the kNN against its
     plain version on that cloud (k = knn_k - 1, timed); forward and
     backward of Σ occupancy + Σ_{zbuf>0} zbuf with every kernel, counters
     set to 0 before and read after (splat_select, splat_fine,
     splat_zbuf_bwd and occ_bwd once each), then with every plain version
     (the spacing from the plain kNN; no launch at all) on the same inputs:
     fragment maps equal, xy gradients within 1e-5·max(1, |g|) + 16 ulp of
     max|g| per element, z within 1e-5 relative, overflow 0; the selection
     and the fine stage on the frame's own inputs against their plain
     versions (also on a permuted candidate list) and timed as in phase 5;
     both backward kernels on the frame's inputs (rebuilt from its forward and checked to
     give its gradient) run twice (the zbuf kernel's tile sums and the
     occupancy gradient bit-identical), against their plain versions
     (the zbuf kernel's points also against its own tile sums scattered
     by `index_add_`; the occupancy window kernel's renderable flags and
     search radius bit-equal to backward_window's), timed as the path
     calls them (median of 7, CUDA events) and alone (the zbuf kernel from
     a profiled frame, which must hold no `index_add_`; the occupancy
     backward's two kernels queued behind a spin of the card) with their
     bounds (the occupancy backward's from the pairs its sums need,
     `occ_bwd.occ_work`, beside the same FLOP over every patch pixel)
     and, for the zbuf backward, one per-fragment `index_add_` to
     the points (and the old per-tile `scatter_add_`); the frame time
     (median of 5 runs of 3 frames), splats/s and the kNN spacing's time;
  9. the DSS point model: isopoints_torch/configs/dss_point.yml through
     the factories, 5000 points on the r=0.5 sphere (seeded), two views at
     256 px; the kNN against its plain version on the (2, 5000) cloud of its
     spacing; forward with a mask image and backward of
     Σ(alpha − target)² + Σ|rgb − target_rgb| against a render of a shifted
     sphere; gradients of points, normal angles and colours finite and
     non-zero, log_size none; the same step with every plain version (no
     launch; loss rtol 1e-5, gradients within phase 8's per-element bound);
     the kNN and both backward kernels launched, the occupancy backward
     once for the two views (one call, one C call); that call's inputs
     (the step's signed cotangent) recorded and the occupancy backward held
     and timed on them as in phase 8; the step's time;
  10. the uni ablation arm's path, isopoints_torch/configs/mvr_uni_siren.yml
     (SIREN 3x256 under the production trace schedule with the bf16 coarse
     phase and the coarse sampler, the neural texture 3x128) through the
     factories: 2 warm-up steps, the resample and 4 projected steps,
     counters set to 0 before and read after, launches per step, fused_mlp's
     launches by mode and shape (both modes must launch) and the sampler's
     by sweep (the coarse sweep must launch); the warm-up, resample and
     projected step times; one warm-up and one projected step with the
     kernels and with the plain versions (the plain f32 and bf16 SIREN
     values tracing the same schedule) on identical draws (phase 4's bars),
     the texture's gradients of both finite and non-zero; the first warm-up
     step's trace three ways (kernels, the SIREN march, plain): launches,
     overflow 0, the converged-ray invariant as phase 6, the march route
     equal to the loop route; the SIREN bf16 mode on 262,144 points and at
     its most frequent shape held as phase 7 holds IGR's bf16 mode; the
     SIREN sampler, coarse (margin 2e-3) and fine, on the trace's own
     sampler buffer, bit for bit against sweep_plain over the fused
     callables and against the plain version within phase 7's bars; the
     SIREN march on the trace's first compacted stage, bit for bit against
     march_plain over the fused callable and against the plain version;
  11. fused_mlp timed at every shape the projected run gave it; the rows of
     the JSON line {"kernels": [...]} (each kernel timed at the shape the
     main path gives it most often);
  12. the lossS ablation arm's path, isopoints_torch/configs/mvr_lossS_siren.yml
     (the uni arm with saliency resampling, a 4096-point reference cloud)
     through the factories: 2 warm-up steps and 6 projected steps with
     resamples at 2, 4 and 6, counters set to 0 before and read after; the
     insertion gate must open at 4 and 6 and children must be appended;
     launches per step (the kNN: uni's +1 a projected step for the
     statistics, +2 more an insertion resample; fused_mlp by shape, one
     Newton set at the children's shape an insertion); the step times beside
     phase 10's; on the run's own state at the first insertion resample,
     kernels against plain: update_ref_metric's statistics bit-equal, the
     three saliency kNN calls (statistics, hot-point lookup, mothers), an
     all-masked database and one of 5 valid points (k=8) bit-equal,
     insert_around_salient's children bit-equal (none from an all-masked
     reference cloud), the whole insertion resample (valid counts within
     0.5% of the capacity, 98% of the plain version's points within 1e-4 of
     a kernel point); the statistics' kNN timed with its bound,
     update_ref_metric and farthest point sampling alone;
  13. training from data directories through the entry points a user
     calls (`create_mvr_data.main`, `train_mvr.main`): (a) the torus written
     as an MVR directory at the lossS arm's data size, 24 views at 512 px
     (timed), read back with MVRDataset: images equal to the 8-bit
     truncation of the arrays written, masks, cameras and GT points equal,
     bit for bit; (b) 8 iterations of isopoints_torch/configs/mvr_lossS_dir.yml
     with a checkpoint every 4, counters set to 0 before and read after:
     fused_mlp in both modes, the coarse sampler, the kNN, the selection
     and the fine stage must launch, the insertion gate must open at its 4
     and 6; each step's time beside phase 12's at 64 px; (c) 4 iterations,
     a resume that runs none (every restored piece of state, the iso-point
     buffer's capacity adopted, equal bit for bit to what was saved, and
     the checkpoint written back unchanged), then a resume to 8: the views
     and pixels of its 4-7 equal to (b)'s; a repeat of (b): if the two
     uninterrupted runs agree bit for bit, the resumed run must too (metrics
     rows and final checkpoint), else it must agree with (b) as closely as
     the repeat does (bars printed beside the repeat's gap); (d)
     `--exit-after` must exit with code 3 after a checkpoint holding the
     steps taken; (e) the torus in the DTU layout (8 views at 512 px,
     cameras decomposed per view, focal negated), 2 warm-up steps, the
     resample and 2 projected steps of isopoints_torch/configs/mvr_uni_dtu.yml
     (the five SIREN-path kernels must launch), and a warm-up and a projected
     step with the kernels and with the plain versions on identical draws
     (phase 4's bars);
  14. evaluation and generation through the entry points: (a) phase 13's
     8 iterations of mvr_lossS_dir.yml with `--validate-every 4
     --visualize-every 4`: an `eval_` row at its 4 (finite, iou_full in
     [0, 1]), model_best.npz (the best iou_full, its saliency state) and
     000004_mesh.ply written, the training rows of its 0-4 equal to phase
     13's run (bit for bit where two runs are), the evaluation's time by
     part; (b) `generate_mvr` on phase 13's final model.npz, mesh 256 (100³
     then 256³ in the PCA frame) and 4 views at 512 px: fused_mlp in both
     modes and the coarse sampler must launch; the grid's time a chunk, the
     host's marching tetrahedra and largest component, the render a view,
     the overflow; (c) the kernels against their plain versions on this
     phase's shapes: fused_mlp on a 262,144-point grid chunk (2e-5); the
     256³ mesh from the plain grid (face counts within 0.1%, the vertices'
     chamfer within (grid spacing / 10)²); a 16,384-ray render chunk of the 4
     views on the kernel routes and on the plain (alpha equal on >= 99.9%,
     hit depths within 1e-4 on >= 99.9% of the rays both hit, RGB within
     1e-3 on those: the level set of a barely trained field is dense, and a
     ray may stop at another crossing), its coarse sampler (picks on >= 0.99,
     f_pick 1e-5), the bf16 mode at the renders' most frequent shape as
     phase 10 holds it; (d) `evaluate --gt-sdf torus --n-samples 50000` on
     (b)'s directory: eval.csv finite, 2 kNN launches; a known answer, the
     analytic torus meshed at 256³ against the same GT points: chamfer_p on
     the card within rtol 1e-5 of the CPU's (the plain kNN, in a process
     of its own beside the evaluate entry) and below
     TORUS_CHAMFER_BAR; the chamfer's kNN at 50,000 x 50,000, k=1, bit for
     bit against the plain version; (e) phase 9's point model meshed by
     IMLS at 128³ (8 kNN launches, a chunk's bit for bit). Counters are set
     to 0 before (b), (d) and (e) and read after each;
  15. the DTU point-cloud workload (`dtu_phase`): a 1,000,000-point noisy
     torus (sigma 0.02) written without normals as a binary PLY, then
     `python -m isopoints_torch.train_dtu_points` on it with the entry's
     defaults, uncut (SIREN 3x256, batch 5000, 4000 iso-points, 2000
     iterations, warm-up 200, refreshes at 200/700/1200/1700, bilateral
     weights, SAL, mesh 256; the data normals through the grid search):
     every step and refresh recorded with its launches (the kNN must launch
     in every projected step, both kernels in every refresh) and time, the
     loss terms finite; on the run's own state the kNN at every shape the
     run gave it and at the 20,000-point default cloud's data normals (k=16,
     the Morton route) bit for bit, fused_mlp value+grad at the 4000
     iso-points within phase 2's bars, one refresh on the fused callable and
     on `PlainSDF` (counts within 0.5% of the capacity, 99% of the points
     valid in both within 1e-4), the final mesh on both (face counts within
     1e-4, the vertices' chamfer within (spacing / 10)²), a projected step's
     terms with the kernels and the plain versions (rtol 1e-5); a step each of
     weight modes 2 and 3 and of the off-normal loss (finite terms; mode 3's
     `pinverse` on the card within 1e-4 of the CPU's in float64, its float32
     gaps and weights printed); a known answer: the
     median |torus_sdf| at final.ply's vertices below the noise sigma; the
     times (PLY read, grid search, eigh, steps, refreshes, mesh parts, run);
  16. the ablation's protocol (`ablation_phase`, from the checkout root: it
     writes under out/torch_ablation): (a) `make_ablation_data` with its
     defaults (the compound mesh at 128³, 24 views at 512 px through the
     raymesh kernel), its stages timed; the kernel at the shape the dataset
     launches it, views 0-3's 1,048,576 rays (median of 7; one view's time
     beside it), against its bound (RM_FLOPS_ALL a ray-face pair) and the
     plain version (one run, bit for bit), and on every 16th ray of view 0
     against `ray_mesh_intersect_plain` (masks 0.9999, t and
     normals 1e-5); a known answer, view 0's hits mapped back through
     normalize_mesh on the compound SDF (median below ABL_MEDIAN, 99th
     percentile below ABL_P99); (b) `train_mvr` on the three
     `ablation_compound_*_dir.yml` arms over that directory, 8 iterations
     each validated at 4 (the iso arms at warm_up_iters 2, resample_every 2):
     step times and launches, the iso arms' kernels launched, lossS seeded
     at 2 and inserting at 4 and 6; (c) `summarize_ablation` on the three
     with finals at ABL_FINAL_RES³, each final's mesh, largest component and
     evaluation timed; (d) `evaluate_pointclouds` on 50,000 mesh samples
     against themselves shifted (2|offset|² within 1e-6; 2 kNN launches),
     again cut by the script to EVAL_CPU_POINTS on the card and the CPU
     (2|offset|² within 1e-6, the CPU's within rtol 1e-5; reduced from
     50,000 in PR 20 to make room for phase 21) and `filter_dtu_predictions` on an 8-view
     512-px DTU torus with FILTER_POINTS points ABL_INSET inside its surface
     (kept >= 0.99) and FILTER_OUTLIERS outside every silhouette (none
     kept), the keep set equal on the CPU; (e) `pixels_to_world` on the uni
     arm's model over one view and in training over 1024 rays (fused_mlp
     launches by shape), fused against plain on every 16th ray (masks
     0.999, points 1e-4), and the occupancy model (5 x 512, OCC_STEPS Adam
     steps on its BCE targets over 2 views x 1024 rays) on the card and the
     CPU (masks 0.999, logits 1e-4, a non-empty 128³ mesh); (f) a projected
     uni step with the debug taps on: a finite "iso" capture, the loss and
     the parameters bit-equal to the step with them off;
  17. the reference's main MVR configuration at full width (`dtu_mvr_phase`:
     configs/dtu_mvr.yml through isopoints_torch/configs/dtu_mvr_dir.yml,
     IGR 8x512 with 6 encoding frequencies and the neural texture, 2048
     rays, 4000 of 8000 iso-points, 512-px rasters, 256-px visibility,
     plain f32 products with TF32 off) on phase 13's DTU-layout torus:
     `train_mvr` for 40 warm-up steps, the resample at 40 and 3 projected
     steps with the validate cadence at 43 (the eval row finite,
     model_best.npz), each step's time and launches: the kNN, selection and
     fine kernels in every projected step, and fused_mlp, fused_igr,
     fused_sampler and trace_march never (no kernel exists for a field with
     positional encoding, in either package); a projected step under the
     profiler (busy share, the plain MLP's GEMM share); a projected step's
     terms with the kernels and with the plain versions on identical draws
     (rtol 1e-5); `generate_mvr` at mesh 256 (the config's 512 reduced),
     its stages timed;
  18. parallel/ at world size 1 under NCCL (`parallel_phase`): a projected
     step of phase 17's state through `make_train_step` over the process
     group bit-equal to the step without one (a repeat without it printed
     beside), and the step's all-reduce timed;
  19. the point-set library at full width (`pointset_phase`; every part
     with every launch counter set to 0 just before and read just after,
     its kernels launched and no plain version called, then again with
     every plain version and no launch; its time and its launches by
     kernel and shape printed): (a) the kNN kernel at k = 17, 24, 31 and 32
     (a warp a query) on `knn_clouds` and an 8000-point sphere, with and
     without self-exclusion, bit for bit, and timed at the RIMLS losses'
     shape (2 x 5000, k = 32); (b) on phase 4's SIREN 3x256 (fused_mlp,
     f32 value+grad) at the config's 8000-point capacity: the unseeded WLOP
     bootstrap, `project_points` with midpoint upsampling (k 31) and with
     edge-aware upsampling, from the resample's 6000-point buffer and 2000
     cube seeds (counts within 0.5% of the capacity, every valid |f| within
     the tolerance); (c) on a 20,000-point subsample of phase 15's scan
     with its data normals: `remove_outliers` with 1% planted blobs (all
     dropped; on the noise-free torus the torus kept), `resample_uniformly`
     (its count kept), `ear_lop_move` (k 17), `project_to_latent_surface`
     (the median |torus_sdf| lowered); (d) the RIMLS `projection_loss` and
     `repulsion_loss` at knn_k 32 on phase 9's clouds, values and
     gradients at rtol 1e-5; (e) phase 8's splat frame with
     `Vrk_isotropic=False` held as phase 8 holds its frame,
     `visible_point_mask` against the plain scatter, and a point model
     frame with `normalize_weights=False`; (f) `signed_distance_loss` on
     phase 16's compound mesh at 4096 points near it, the card against the
     CPU on 512 of them (rtol 1e-5), its sign against `compound_sdf`'s
     past one 128³ cell (>= 99.9%);
  20. the network published with IGR on the wide instances of the MLP
     tile (`igr_wide_phase`): (b) isopoints_torch/configs/igr_mvr_dir.yml
     (configs/dtu_mvr.yml without positional encoding: IGR 8x512 on raw
     xyz) through `train_mvr` on phase 13's DTU-layout torus, 40 warm-up
     steps, the resample at 40 and 3 projected steps, every step with its
     counters set to 0 just before and read just after: fused_igr in both
     modes, fused_sampler, the kNN, selection and fine launched and no
     plain MLP version called (`plain_calls`), fused_igr's launches by
     mode and shape and the sampler's by shape, each step's time, a
     profiled projected step's busy share, a projected step's terms with
     the kernels and with every plain
     version on identical draws (phase 4's bars: rtol 1e-2, counts within
     0.5% of the capacity); (a) on the trained field (`wide_kernels`):
     fused_igr value and value+grad in both modes on 262,144 and 524,288
     points and f32 on 220,202 (phase 7's bars; the f32 tile's RMS against
     exact sums beside cuBLAS's there and on the sampler's fine points),
     the coarse IGR sampler at row 3b's shape (equal to sweep_plain over
     the fused callables bit for bit; against the plain version by phase
     7's bars, its picks held to the exactly summed sweep's: on 99% of
     rays or as many as the plain version's), the march at row 9's shape
     (bit for bit over the fused callable; masks and depths as phase 7), a
     seeded SIREN 3x512 through fused_mlp (f32 value+grad on 3000 and
     262,144 points, bf16 value on 131,072), its coarse sampler (row 3c's
     shape) and march (row 9s's), IGR 4x300 and 4x288 padded to the
     384-wide instance on the card, and a width above 512 refused; each
     timed beside its plain version, the f32 cuBLAS chain (TF32 off) and
     its bound; fused_igr at (b)'s four most frequent shapes and the
     sampler at its two, timed beside their bounds;
  21. what the JAX package computed and the port refused until PR 20
     (`refusals_phase`): (a) phase 6's field and rays traced with the
     certify-then-sweep sampler (`sampler_presweep` PRE_STEPS, dense
     buffer PRE_FRACTION) on the kernels and on every plain version,
     counters set to 0 before each trace and read after it (fused_igr and
     fused_sampler must launch, nothing else; no launch on the plain
     route), the flagged share and both overflow counters (0), the kernel
     route against the plain one by phase 6's bars, against phase 6's
     dense route (hit masks equal on PRE_MASK_BAR of the rays, the depths
     of rays both hit bit for bit), the trace's time both ways and its
     roofline; (b) `Generator.generate_iso_contour` at plot_cuts' defaults
     on phase 4's trained SIREN (9 fused_mlp launches and nothing else),
     its payload against the same model's on the CPU (the grids equal,
     values within PLOT_TOL), a tapped projected step and its `debug_dump`
     (the "iso" points with finite, non-zero gradient cones), and
     `create_animation` over phase 15's *_iso.ply and phase 14's
     000004_mesh.ply (each animation's first frame equal to its PLY's
     points); (c) phase 17's state through CheckpointIO(backend="orbax")
     (torch.distributed.checkpoint) under an NCCL group at world size 1,
     restored into zeroed templates bit for bit, save and load timed
     beside the npz backend; (d) `measure_scaling` at world size 1 on that
     group (its JSON line, labelled nccl);
  22. the JAX package's last public surface (`surface_phase`): (a)
     `sample_world_points` on phase 4's SIREN 3x256 at the training batch's
     pixels (2 views x n_rays) x `n_points_per_ray` 100, through fused_mlp
     (it alone launches) and through the plain decoder (nothing launches):
     the masks equal on every ray, a differing pick only on a tie within
     SURF_MLP_TOL of the plain SDF, both routes timed, and the kernel at
     that shape against its plain version, timed beside its bound; (b)
     `rasterize_splats` with znear 0.5 and zfar 3.0 and with the default
     planes on a cloud across both planes, the renderable masks equal to
     the depth test, the select and fine kernels against the plain stages
     (idx, zbuf, occupancy, visibility, overflow identical, qvalue within
     1e-6), both renderable counts, which must differ; (c) a projected
     forward of phase 4's model with `sample_iso_offsurface=False`: finite
     outputs, the off-surface samples the on-surface ones with both masks
     False, the on-surface outputs equal to the run with the samples, and
     each kernel's launches with and without them;
then the JSON line {"kernels": [...]} (row 4 also at the statistics', the
chamfer's, the IMLS, the DTU and the RIMLS (`rimls_*`) shapes; the
SIREN-path rows with their launches in 13 (b) and (e), 14 (b) and (d) and
15; the raymesh row from 16 (a); the wide rows of phase 20 with their
launches in 20 (b); the IGR rows' `presweep_*` keys from 21 (a) and the
SIREN row's `plot_*` keys from 21 (b); the SIREN row's `world_points_*`
keys from 22 (a), the splat rows' `clip_launches` from 22 (b), and the
`offsurface_launches` / `no_offsurface_launches` of 22 (c)) and the device line {"ok": true, "device": {...}}. Phase 6 also prints
isopoints_torch.bench's roofline line.

Exits non-zero without a result when CUDA is unavailable.
"""

import collections
import contextlib
import dataclasses
import glob
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
F32_PEAK = 67e12      # H100 SXM float32 outside the tensor cores, FLOP/s
BF16_PEAK = 989e12    # H100 SXM dense bf16 tensor cores, FLOP/s
TF32_PEAK = 495e12    # H100 SXM dense tf32 tensor cores, FLOP/s
HBM_RATE = 3.35e12    # H100 SXM device memory, bytes/s
# the f32 IGR value tolerance against the plain version (phase 7), which
# also bounds the IGR sampler's z_secant as IGR_F32_TOL / slope
IGR_F32_TOL = 2e-5
# the f32 tile's RMS error against exactly summed values, over cuBLAS's
# (TF32 off) on the same points (phase 7): two float32 sums of the same
# terms in other orders differ by about this much
F32_EXACT_RATIO = 1.2
N_WARMUP_SMOKE = 3
N_PROJECTED = 6
N_UNI_PROJECTED = 4
N_LOSS_S_PROJECTED = 6
NO_LIBRARY = ("no single PyTorch call computes this function")
# phase 14 (d): the known answer's chamfer on the CPU, in a process of its
# own (argv: the checkout root, the directory of samples.npy and gt.npy);
# prints {"chamfer_p", "s"}
KNOWN_ANSWER_CPU = """
import json, os, sys, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from isopoints_torch.training.evaluation import chamfer_distance
s, g = (torch.from_numpy(np.load(os.path.join(sys.argv[2], f)))
        for f in ("samples.npy", "gt.npy"))
t = time.perf_counter()
v = chamfer_distance(s, g)["chamfer_p"]
print(json.dumps({"chamfer_p": v, "s": time.perf_counter() - t}))
"""
# phase 14's known answer: the analytic torus (R 0.4, r 0.15) meshed at 256³
# over [-1, 1]³, 50,000 samples (seed 0) against evaluate's 50,000 GT points
# of the torus: chamfer_p 4.3774e-05 on the CPU (the plain kNN), almost all of
# it the two samplings' spacing; the bar leaves 14% above that
TORUS_CHAMFER_BAR = 5e-5
# phase 15's scan: a noisy torus of the raw-scan size the DTU workload's grid
# search serves, noise sigma as train_dtu_points' default
DTU_POINTS = 1_000_000
DTU_NOISE = 0.02
# the bar on the 95th percentile of final.ply's |torus_sdf|: above the
# readings of the full schedule, 0.190 on the card at 1 M points and 0.237
# (JAX) / 0.245 (the port) on the CPU at 100,000 (tests/dtu_parity_run.py),
# where sheets that the largest component keeps set the tail in both packages
DTU_P95 = 0.25
# phase 16's known answer: the ray-cast hits of view 0, mapped back through
# normalize_mesh, against the compound solid's SDF; the mesh is that SDF's
# marching tetrahedra at 128³ over [-1, 1]³, so the hits lie within a grid
# cell (2/128) of its zero set, most of them far closer
ABL_MEDIAN = 0.004
ABL_P99 = 2.0 / 128
# Möller–Trumbore float32 operations that every ray-triangle pair needs:
# pvec (9), det (5), tvec (3), u (6) and 1/det (1). The pairs past the u
# test (csrc/raymesh.cu's early cut) also take q, v, t and u + v (22 more);
# the bound leaves them out, a lower bound ~0.2% under the work of this
# dataset (one view: 8.47e7 of 4.23e10 pairs pass the cut)
RM_FLOPS_ALL = 24
# phase 16 (d): the filter's scan, points of the torus ABL_INSET inside its
# surface (~2 px at 512 px, more than a nearest-pixel lookup's 0.71 px), and
# points outside every silhouette
FILTER_POINTS = 1_000_000
FILTER_OUTLIERS = 10_000
ABL_INSET = 0.0075
# phase 16 (d): evaluate_pointclouds' CPU reference on the script's cut of
# the 50,000-point clouds to this many (the card runs both sizes)
EVAL_CPU_POINTS = 10_000
# phase 16 (e): Adam steps of the occupancy model on the BCE targets, and
# the card's candidate logits against the CPU's, relative to max(1, |logit|):
# the trained 5 x 512 field's logits reach tens, and float32 sums of 512
# products in other orders differ by ~1e-6 of them a layer, so the gap
# grows with the logits and an absolute bar cannot hold
OCC_STEPS = 40
OCC_LOGIT_TOL = 1e-4
# phase 16 (c): the finals' mesh resolution (summarize_ablation's default)
ABL_FINAL_RES = 192


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps: int = 7) -> float:
    """Median CUDA-event time of `fn` after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


GRAD_TOL = "|err| <= 1e-5·max(1, |g|) + 16 ulp of max|g| per element"


def grad_check(a: torch.Tensor, ref: torch.Tensor):
    """(summary, passed): each element within 1e-5·max(1, |ref|) plus 16
    float32 ulp of max|ref| (the same terms summed in another order, some
    by atomics whose order changes from run to run), with the worst share
    of that bound, max|ref| and the median of the non-zero |ref|."""
    mag = ref.abs()
    big = mag.max().float()
    ulp = torch.nextafter(big, big.new_tensor(float("inf"))) - big
    worst = float(((a - ref).abs() / (1e-5 * mag.clamp(min=1.0) + 16 * ulp)).max())
    nz = mag[mag > 0]
    med = float(nz.median()) if nz.numel() else 0.0
    return (f"max err {float((a - ref).abs().max()):.3g}, worst {worst:.3g} of "
            f"the bound (max |g| {float(big):.6g}, median non-zero |g| "
            f"{med:.6g})", worst <= 1.0)


def mlp_flops(n_points: int, hidden: int, n_hidden: int) -> float:
    """Multiply-adds of one SIREN value eval, 2 FLOP each. f32 products
    count as three tf32 passes over the tf32 peak, the least time the card
    takes for them, whatever unit a kernel runs them on."""
    return 2.0 * n_points * (3 * hidden + n_hidden * hidden * hidden + hidden)


def bound_ms(flops: float, n_bytes: float, peak: float = F32_PEAK):
    t_ops, t_bytes = flops / peak, n_bytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def row(name, source, replaces, launches, err, ms, plain_ms, b,
        library_ms=None, library_note=NO_LIBRARY, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1], "library_ms": library_ms,
            "library_note": library_note, **extra}


def splat_row(name, source, replaces, launches, path, frame):
    """A splat stage's row: timed at the projected step's shape (`path`)
    and at the splat frame's (`frame`), each (err, wrapper ms, plain ms,
    bound, kernel alone ms)."""
    return row(name, source, replaces, launches, max(path[0], frame[0]),
               *path[1:4], alone_ms=path[4], frame_ms=frame[1],
               frame_alone_ms=frame[4], frame_plain_ms=frame[2],
               frame_bound_ms=frame[3][0], frame_bound_by=frame[3][1])


def knn_clouds(device):
    """Adversarial kNN inputs, B = 2, from numpy seeds, as (label, query,
    points, query mask, points mask, query is points): exact duplicates,
    an integer lattice (many exactly equal distances), masked points and
    queries, two clusters far apart (the small one has fewer points than
    k), each of about 3000 points; and a lattice and masked points and
    queries of 20,480 points, past knn.SORT_MIN (the Morton order and the
    pruning)."""
    import numpy as np
    rng = np.random.RandomState(7)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    m = lambda a: torch.from_numpy(np.asarray(a, bool)).to(device)
    ones = lambda b, n: m(np.ones((b, n), bool))
    base = rng.uniform(-1, 1, (2, 1000, 3))
    dup = np.concatenate([base] * 3, 1)[:, rng.permutation(3000)]
    axes = np.meshgrid(np.arange(16), np.arange(16), np.arange(12), indexing="ij")
    g = np.stack(axes, -1).reshape(-1, 3) / 8.0   # exact in float32
    grid = np.stack([g, g[rng.permutation(len(g))]])
    grid_mask = rng.uniform(size=grid.shape[:2]) < 0.75
    pts = rng.uniform(-1, 1, (2, 3000, 3))
    pmask = rng.uniform(size=(2, 3000)) < 0.7
    qry = rng.uniform(-1.2, 1.2, (2, 1500, 3))
    qmask = rng.uniform(size=(2, 1500)) < 0.7
    far = np.concatenate([rng.uniform(-0.5, 0.5, (2, 2990, 3)),
                          rng.uniform(-0.5, 0.5, (2, 10, 3)) + [100.0, 0.0, 0.0]], 1)
    axes = np.meshgrid(np.arange(32), np.arange(32), np.arange(20), indexing="ij")
    g = np.stack(axes, -1).reshape(-1, 3) / 16.0
    big = np.stack([g, g[rng.permutation(len(g))]])
    big_mask = rng.uniform(size=big.shape[:2]) < 0.8
    big_q = rng.uniform(-0.2, 2.2, (2, 4096, 3))
    big_qmask = rng.uniform(size=(2, 4096)) < 0.8
    return [
        ("exact duplicates", t(dup), t(dup), ones(2, 3000), ones(2, 3000), True),
        ("integer lattice", t(grid), t(grid), m(grid_mask), m(grid_mask), True),
        ("masked points and queries", t(qry), t(pts), m(qmask), m(pmask), False),
        ("masked cloud", t(pts), t(pts), m(pmask), m(pmask), True),
        ("two clusters far apart", t(far), t(far), ones(2, 3000), ones(2, 3000), True),
        ("integer lattice, 20,480 points", t(big), t(big), m(big_mask),
         m(big_mask), True),
        ("masked points and queries, 20,480 points", t(big_q), t(big),
         m(big_qmask), m(big_mask), False),
    ]


def stage_timer(stage_s):
    """timing(key, fn): `fn` wrapped to append its wall seconds, between two
    synchronisations of the card, to stage_s[key]."""
    def timing(key, fn):
        def timed_call(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            stage_s[key].append(time.perf_counter() - t)
            return out
        return timed_call
    return timing


@contextlib.contextmanager
def patched(*triples):
    """Set obj.name = fn for each (obj, name, fn) and restore after."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in triples]
    for obj, name, fn in triples:
        setattr(obj, name, fn)
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def knn_equal(q, pts, qm, pm, k, exclude_self, label):
    """The kNN kernel's distances, indices and mask equal the plain
    version's bit for bit; returns the number of valid entries."""
    from isopoints_torch.ops import knn
    a = knn.knn_points(q, pts, qm, pm, k=k, exclude_self=exclude_self)
    b = knn.knn_points(q, pts, qm, pm, k=k, exclude_self=exclude_self,
                       method="dense")
    for name in ("dists", "idx", "mask"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            bad = int((getattr(a, name) != getattr(b, name)).sum())
            fail(f"knn {label} k={k} exclude_self={exclude_self}: {name} "
                 f"differs from the plain version in {bad} entries")
    return int(a.mask.sum())


def dtu_phase(dev, kernels) -> dict:
    """Phase 15: the DTU point-cloud workload through its entry point, uncut
    (see the module docstring). `kernels` are the launch counters. Returns
    the `dtu_*` keys of the fused_mlp and knn rows of the kernels line."""
    import copy

    import numpy as np

    from isopoints_torch import bench, train_dtu_points
    from isopoints_torch.core.cloud import PointCloud
    from isopoints_torch.data import synthetic
    from isopoints_torch.ops import fused_mlp, knn
    from isopoints_torch.training import evaluation
    from isopoints_torch.utils import meshing
    from isopoints_torch.utils.io import save_ply
    from isopoints_torch.workloads import dtu_points

    t15 = time.perf_counter()
    counts = lambda: {k.name: k.launches for k in kernels}
    stage_s = collections.defaultdict(list)   # stage -> seconds a call
    timing = stage_timer(stage_s)

    # (1) the scan: a noisy torus of 1,000,000 points, no normals, binary PLY
    out_root = os.path.join(ROOT, "out")
    dtu_dir = os.path.join(out_root, "torch_dtu_points")
    shutil.rmtree(dtu_dir, ignore_errors=True)
    scan = os.path.join(out_root, "dtu_torus_1m.ply")
    t = time.perf_counter()
    pts, _ = train_dtu_points.load_cloud("synthetic:torus", DTU_NOISE,
                                         DTU_POINTS + DTU_POINTS // 20, 0,
                                         device=dev)
    if len(pts) < DTU_POINTS:
        fail(f"the synthetic torus kept {len(pts)} < {DTU_POINTS} points")
    save_ply(scan, pts[:DTU_POINTS])
    print(f"phase 15: wrote {DTU_POINTS:,} noisy torus points (sigma "
          f"{DTU_NOISE}) without normals to {os.path.relpath(scan, ROOT)} in "
          f"{time.perf_counter() - t:.2f} s ({os.path.getsize(scan) / 2**20:.1f} MiB)")

    # (2)-(3) the entry with its own defaults; each step and refresh recorded
    calls = []       # (kind, it, launches, seconds)
    run = {}
    knn_seen = {}    # (N, P, k, exclude_self) -> the run's first such inputs
    eighs = []       # (batch, seconds)
    step_fn, refresh_fn = dtu_points.train_step, dtu_points.refresh_iso
    knn_cuda, eigh_fn = knn.knn_points_cuda, torch.linalg.eigh

    def recorded(kind, fn, *args):
        before = counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        calls.append((kind, run.get("it"), {k: v - before[k] for k, v in
                                            counts().items()},
                      time.perf_counter() - t))
        return out

    def rec_step(decoder, opt_state, data, iso, draws, it, warm, cfg):
        run.update(it=it, cfg=cfg)
        return recorded("warm-up" if warm else "projected", step_fn, decoder,
                        opt_state, data, iso, draws, it, warm, cfg)

    def rec_refresh(sdf_fn, iso_points, iso_mask, u, cfg):
        run["it"] = run.get("it", -1) + 1
        return recorded("refresh", refresh_fn, sdf_fn, iso_points, iso_mask, u, cfg)

    def rec_knn(q, p, qm, pm, k, exclude_self=False):
        key = (q.shape[1], p.shape[1], k, bool(exclude_self))
        if key not in knn_seen:
            knn_seen[key] = tuple(x.clone() for x in (q, p, qm, pm))
        return knn_cuda(q, p, qm, pm, k, exclude_self)

    def rec_eigh(a, *args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = eigh_fn(a, *args, **kw)
        torch.cuda.synchronize()
        eighs.append((run.get("stage"), a.shape[:-2].numel(),
                      time.perf_counter() - t))
        return out

    normals_fn = timing("data normals", dtu_points.data_normals)

    def rec_normals(*args):
        run["stage"] = "data normals"
        try:
            return normals_fn(*args)
        finally:
            run["stage"] = None

    for k in kernels:
        k.launches = 0
    t = time.perf_counter()
    with patched((dtu_points, "train_step", rec_step),
                 (dtu_points, "refresh_iso", rec_refresh),
                 (knn, "knn_points_cuda", rec_knn),
                 (torch.linalg, "eigh", rec_eigh),
                 (knn, "grid_radius_search",
                  timing("grid search", knn.grid_radius_search)),
                 (dtu_points, "data_normals", rec_normals),
                 (train_dtu_points, "read_ply",
                  timing("PLY read", train_dtu_points.read_ply)),
                 (meshing, "eval_sdf_grid", timing("mesh grids", meshing.eval_sdf_grid)),
                 (meshing, "marching_tetrahedra",
                  timing("marching tetrahedra", meshing.marching_tetrahedra)),
                 (meshing, "largest_component",
                  timing("largest component", meshing.largest_component))):
        decoder, info = train_dtu_points.main([scan, "--out-dir", dtu_dir])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = counts()
    cfg = run["cfg"]
    iso, data, opt_state = info["iso"], info["data"], info["opt_state"]
    p_total, cap = data[0].shape[1], cfg.n_iso_points
    kinds = collections.Counter(c[0] for c in calls)
    refresh_its = [c[1] for c in calls if c[0] == "refresh"]
    print(f"train_dtu_points on {p_total:,} points, entry defaults (SIREN 3x256, "
          f"batch {cfg.batch_size}, {cap} iso-points, {cfg.total_iters} "
          f"iterations, warm-up {cfg.warm_up}, weight mode {cfg.weight_mode}, "
          f"SAL, mesh {cfg.mesh_resolution}): {run_s:.1f} s; {dict(kinds)} "
          f"(refreshes at {refresh_its}); launches in the run {launches}")
    # uncut: the entry's defaults, every step and refresh of them
    a = train_dtu_points.parse_args([scan])
    uncut = (cfg.total_iters, cfg.warm_up, cfg.resample_every, cfg.batch_size,
             cfg.n_iso_points, cfg.mesh_resolution, cfg.decoder_type) == (
        a.total_iters, a.warm_up, a.resample_every, min(a.batch_size, p_total),
        a.n_iso_points, a.mesh_resolution, a.decoder_type)
    want = [i for i in range(cfg.total_iters) if dtu_points.is_refresh(i, cfg)]
    if not uncut or kinds != {"warm-up": cfg.warm_up, "refresh": len(want),
                              "projected": cfg.total_iters - cfg.warm_up} \
            or refresh_its != want:
        fail(f"the DTU run is not the entry's default run: {cfg}, {dict(kinds)}, "
             f"refreshes at {refresh_its}")
    for it, total, terms in info["history"]:
        if not all(np.isfinite(v) for v in [total, *terms.values()]):
            fail(f"non-finite DTU loss terms at {it}: {terms}")
    print("history: " + "; ".join(f"{it} {total:.4g}" for it, total, _ in
                                  info["history"]))

    def per(kind):
        rows = [c[2] for c in calls if c[0] == kind]
        return {k: sorted(collections.Counter(r[k] for r in rows).items())
                for k in ("fused_mlp", "knn")}, rows
    per_warm, warm_rows = per("warm-up")
    per_proj, proj_rows = per("projected")
    per_ref, ref_rows = per("refresh")
    print(f"launches (count: calls) a warm-up step {per_warm}, a projected step "
          f"{per_proj}, a refresh {per_ref}")
    if any(r["knn"] < 1 for r in proj_rows):
        fail("a projected DTU step launched no kNN kernel")
    if any(r["knn"] < 1 or r["fused_mlp"] < 1 for r in ref_rows):
        fail("a DTU refresh did not launch both the kNN and the fused MLP kernels")
    step_ms = {kind: 1e3 * statistics.median(c[3] for c in calls if c[0] == kind)
               for kind in ("warm-up", "projected")}
    ref_ms = [1e3 * c[3] for c in calls if c[0] == "refresh"]

    # (4) kernels against plain on the run's own state
    knn_rows = {}
    for key, (q, p, qm, pm) in sorted(knn_seen.items()):
        n, pp, k, ex = key
        knn_equal(q, p, qm, pm, k, ex, f"{n} x {pp}")
        ms = time_ms(lambda: knn.knn_points(q, p, qm, pm, k=k, exclude_self=ex))
        pms = time_ms(lambda: knn.knn_points(q, p, qm, pm, k=k, exclude_self=ex,
                                             method="dense"), reps=3)
        b = bound_ms(9.0 * n * pp, n * 13 + pp * 13 + n * k * 12)
        knn_rows[key] = (ms, pms, b)
        print(f"knn {n} x {pp}, k={k}{', self-excluded' if ex else ''} (the "
              f"run's own inputs): equal to the plain version bit for bit; kernel "
              f"{ms:.4f} ms  plain {pms:.3f} ms  bound {b[0]:.5f} ms ({b[1]})")
    need = {(cfg.batch_size, cap, 1, False), (cap, cap, 16, True), (cap, cap, 8, False)}
    if not need <= set(knn_seen):
        fail(f"the DTU run's kNN shapes {sorted(knn_seen)} lack {sorted(need)}")
    # the data normals of the 20,000-point default cloud: the kNN route
    p20, _ = train_dtu_points.load_cloud("synthetic:torus", DTU_NOISE, 0, 0,
                                         device=dev)
    p20 = PointCloud.create(points=torch.from_numpy(p20)[None]).normalize_to_box(
        1.5)[0].points.to(dev)
    m20 = torch.ones(p20.shape[:2], dtype=torch.bool, device=dev)
    knn_equal(p20, p20, m20, m20, 16, False, "the 20,000-point default cloud")
    n20 = p20.shape[1]
    ms20 = time_ms(lambda: knn.knn_points(p20, p20, m20, m20, k=16))
    pms20 = time_ms(lambda: knn.knn_points(p20, p20, m20, m20, k=16,
                                           method="dense"), reps=3)
    b20 = bound_ms(9.0 * n20 * n20, n20 * 26 + n20 * 16 * 12)
    print(f"knn {n20} x {n20}, k=16 (the default synthetic cloud's data normals, "
          f"past knn.SORT_MIN: the Morton route): equal bit for bit; kernel "
          f"{ms20:.4f} ms  plain {pms20:.3f} ms  bound {b20[0]:.5f} ms ({b20[1]})")

    f = dtu_points.tracing_sdf(decoder)
    pack = f.pack
    x = iso.points[0]
    v, g = f.sdf_and_grad(x)
    v_ref, g_ref = fused_mlp.siren_sdf_and_grad_plain(pack, x)
    err_v = float((v - v_ref).abs().max())
    err_g = float((g - g_ref).abs().max())
    scale_g = float(g_ref.abs().max())
    if not (err_v <= 2e-5 and err_g <= 1e-4 * max(1.0, scale_g)):
        fail(f"fused_mlp value+grad at the {cap} iso-points: value err {err_v}, "
             f"grad err {err_g} (max |g| {scale_g})")
    w_bytes = 4 * sum(w.numel() + b.numel() for w, b in zip(pack.ws, pack.bs))
    mlp_ms = time_ms(lambda: f.sdf_and_grad(x))
    mlp_pms = time_ms(lambda: fused_mlp.siren_sdf_and_grad_plain(pack, x))
    mlp_b = bound_ms(3 * mlp_flops(cap, pack.hidden, pack.n_hidden) * 4,
                     cap * 28 + w_bytes, TF32_PEAK)
    print(f"fused_mlp f32 value+grad at the run's {cap} iso-points: value err "
          f"{err_v:.3g} (2e-5), grad err {err_g:.3g} (1e-4·max(1, {scale_g:.4g})); "
          f"kernel {mlp_ms:.4f} ms  plain {mlp_pms:.4f} ms  bound {mlp_b[0]:.4f} "
          f"ms ({mlp_b[1]})")

    # one refresh from the run's state with the fused callable and the plain
    u = torch.rand(iso.points.shape, generator=torch.Generator(device=dev)
                   .manual_seed(15), device=dev)
    ref_k = dtu_points.refresh_iso(f, iso.points, iso.mask, u, cfg)
    ref_p = dtu_points.refresh_iso(fused_mlp.PlainSDF(pack), iso.points, iso.mask,
                                   u, cfg)
    ref_s = dtu_points.refresh_iso(f, torch.nextafter(iso.points, torch.full_like(
        iso.points, 2.0)), iso.mask, u, cfg)

    def within(a, b):
        both = a.mask & b.mask
        d = (a.points - b.points).abs().amax(-1)[both]
        return float((d <= 1e-4).float().mean())
    n_k, n_p = int(ref_k.mask.sum()), int(ref_p.mask.sum())
    share = within(ref_k, ref_p)
    print(f"a refresh from the run's state, fused vs plain SIREN: valid {n_k} / "
          f"{n_p} (bar: within 0.5% of {cap}); {share:.4f} of the points valid in "
          f"both within 1e-4 (bar 0.99); the fused refresh against itself on "
          f"points one ulp apart: {within(ref_k, ref_s):.4f}, valid "
          f"{int(ref_s.mask.sum())}")
    if abs(n_k - n_p) > 0.005 * cap or share < 0.99:
        fail("the refresh on the fused kernel disagrees with the plain one")

    # the final mesh's grid on the fused callable and on the plain field
    t = time.perf_counter()
    mk_v, mk_f = meshing.get_surface_high_res_mesh(f, cfg.mesh_resolution, device=dev)
    mk_s = time.perf_counter() - t
    t = time.perf_counter()
    mp_v, mp_f = meshing.get_surface_high_res_mesh(fused_mlp.PlainSDF(pack),
                                                   cfg.mesh_resolution, device=dev)
    mp_s = time.perf_counter() - t
    gap = abs(len(mk_f) - len(mp_f)) / max(len(mp_f), 1)
    spacing = float(np.ptp(mp_v, axis=0).max()) / (cfg.mesh_resolution - 1)
    cd = evaluation.chamfer_distance(torch.from_numpy(mk_v).to(dev),
                                     torch.from_numpy(mp_v).to(dev))["chamfer_p"]
    print(f"the final mesh at {cfg.mesh_resolution}³ on the fused kernel "
          f"({mk_s:.2f} s) and on the plain field ({mp_s:.2f} s): faces {len(mk_f)} "
          f"/ {len(mp_f)} (gap {gap:.2e}, bar 1e-4); the vertices' chamfer {cd:.3g} "
          f"(bar (spacing / 10)² = {(spacing / 10) ** 2:.3g})")
    if gap > 1e-4 or not cd <= (spacing / 10) ** 2:
        fail("the final mesh on the fused kernel disagrees with the plain one")

    # one projected step's terms with the kernels and with the plain versions
    draws = dtu_points.DTUDraws(15, dev).step(cfg.batch_size, p_total, cap)
    it = cfg.total_iters - 1
    with torch.no_grad():
        terms_k = {k: float(v) for k, v in dtu_points.compute_losses(
            decoder, data, iso, draws, it, False, cfg).items()}
        with patched((knn, "knn_points_cuda", knn.knn_points_dense)):
            terms_p = {k: float(v) for k, v in dtu_points.compute_losses(
                decoder, data, iso, draws, it, False, cfg).items()}
    print(f"a projected step's terms, kernels {terms_k}, plain {terms_p}")
    if any(abs(terms_k[k] - terms_p[k]) > 1e-5 * abs(terms_p[k]) for k in terms_p):
        fail("a projected step's terms differ beyond rtol 1e-5 between the kernels "
             "and the plain versions")

    # (5) the other weight modes and the off-normal loss, a step each
    km = []
    pinv_fn = dtu_points.pinverse

    def rec_pinv(m):
        km.append(m.clone())
        return pinv_fn(m)
    for mode, off in ((2, False), (3, False), (1, True)):
        cfg_m = dataclasses.replace(cfg, weight_mode=mode, use_off_normal_loss=off)
        with patched((dtu_points, "pinverse", rec_pinv)):
            _, total, terms = dtu_points.train_step(
                copy.deepcopy(decoder), copy.deepcopy(opt_state), data, iso,
                draws, it, False, cfg_m)
        terms = {k: float(v) for k, v in terms.items()}
        print(f"weight mode {mode}{', off-normal loss' if off else ''}: total "
              f"{float(total):.6g} {terms}")
        if not all(np.isfinite(v) for v in terms.values()) or \
                (off and "sald" not in terms):
            fail(f"weight mode {mode} (off-normal {off}): terms {terms}")
    # mode 3 on the card against the CPU. Its Gram matrices are near
    # singular (neighbouring features a few hundredths apart), so in float32
    # any two SVD routines cut at 1e-6 of the largest singular value disagree
    # in the inverted small values. The weights kᵀK⁺k the loss reads are held
    # in float32 against float64 on the same neighbours: the card's share of
    # points more than 1e-3 off at most 1.5x the CPU's float32 share.
    # `pinverse` itself is held in float64, where the small values resolve.
    (mats,) = km

    def rel_err(a, ref):
        mag = ref.abs().amax(dim=(-2, -1)).clamp(min=1.0)
        return (a.double() - ref.double()).abs().amax(dim=(-2, -1)) / mag

    def spread(r):
        return f"max {float(r.max()):.3g}, {float((r <= 1e-4).double().mean()):.4f} within 1e-4"
    p64_card = dtu_points.pinverse(mats.double()).cpu()
    p64_cpu = dtu_points.pinverse(mats.cpu().double())
    gap64 = rel_err(p64_card, p64_cpu)
    pv_card, pv_cpu = dtu_points.pinverse(mats).cpu(), dtu_points.pinverse(mats.cpu())
    print(f"pinverse of mode 3's {mats.shape[0]} Gram matrices (8 x 8), relative to "
          f"max(1, max |entry|): float64 on the card against the CPU's "
          f"{spread(gap64)} (bar: all within 1e-4); float32 (the workload's) on "
          f"the card against the CPU's {spread(rel_err(pv_card, pv_cpu))}, and "
          f"against float64 the CPU's {spread(rel_err(pv_cpu, p64_cpu))}, the "
          f"card's {spread(rel_err(pv_card, p64_cpu))}")
    if float(gap64.max()) > 1e-4:
        fail("pinverse on the card disagrees with the CPU's in float64")
    surf = [data[0][0][draws.idx][None], data[1][0][draws.idx][None]]
    found = []

    def rec_search(*a, **k):
        found.append(knn.radius_search(*a, **k))
        return found[-1]
    with patched((dtu_points, "radius_search", rec_search)):
        w_card = dtu_points.heat_kernel_weights(*surf, iso.points, iso.grads,
                                                iso.mask).cpu()
    nb = found[0]._replace(**{f: v.cpu() for f, v in found[0]._asdict().items()})
    with patched((dtu_points, "radius_search", lambda *a, **k: nb)):
        w_cpu, w64 = (dtu_points.heat_kernel_weights(*(t.cpu().to(dt) if
            t.is_floating_point() else t.cpu() for t in (*surf, iso.points,
                                                         iso.grads, iso.mask)))
            for dt in (torch.float32, torch.float64))

    def off(w):
        gap = (w.double() - w64).abs()
        return gap, float((gap > 1e-3).double().mean())
    (gap_card, off_card), (gap_cpu, off_cpu) = off(w_card), off(w_cpu)
    print(f"mode 3's weights (float32, the run's neighbours) against float64: "
          f"the card's share more than 1e-3 off {off_card:.4f} (max "
          f"{float(gap_card.max()):.3g}, mean {float(gap_card.mean()):.3g}), the "
          f"CPU's {off_cpu:.4f} (max {float(gap_cpu.max()):.3g}, mean "
          f"{float(gap_cpu.mean()):.3g}) (bar: the card's at most 1.5x the CPU's); "
          f"card against CPU {float(((w_card - w_cpu).abs() <= 1e-3).float().mean()):.4f}"
          f" within 1e-3; {float((w64 > 0).float().mean()):.3f} of the points "
          f"weighted")
    if off_card > 1.5 * off_cpu:
        fail("mode 3's float32 weights on the card stray from float64 further "
             "than the CPU's")

    # (6) a known answer: the final mesh against the analytic torus
    verts = torch.from_numpy(np.asarray(info["mesh"][0], np.float32))
    err = synthetic.torus_sdf()(verts).abs().numpy()
    med, p95 = float(np.median(err)), float(np.percentile(err, 95))
    print(f"final.ply: {len(verts):,} vertices, {len(info['mesh'][1]):,} faces; "
          f"|torus_sdf| at the vertices, world units: median {med:.5f}, 95th "
          f"percentile {p95:.5f} (bars: median below the noise sigma {DTU_NOISE}, "
          f"95th percentile below {DTU_P95})")
    if not med < DTU_NOISE:
        fail(f"the DTU mesh's median distance to the torus {med} >= {DTU_NOISE}")
    if not p95 < DTU_P95:
        fail(f"the DTU mesh's 95th percentile distance to the torus {p95} >= "
             f"{DTU_P95}")

    # (7) times
    grid_cells = dtu_cells_over(data[0][0])
    eigh_1m = [(n, s) for stage, n, s in eighs if stage == "data normals"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"DTU times on {smi}: PLY read {sum(stage_s['PLY read']):.4f} s; data "
          f"normals {sum(stage_s['data normals']):.3f} s (grid search "
          f"{sum(stage_s['grid search']):.3f} s, {grid_cells}; eigh of "
          f"{sum(n for n, _ in eigh_1m):,} 3x3 in {len(eigh_1m)} calls "
          f"{sum(s for _, s in eigh_1m):.3f} s); median warm-up step "
          f"{step_ms['warm-up']:.2f} ms, projected step {step_ms['projected']:.2f} "
          f"ms; refreshes " + ", ".join(f"{x:.1f}" for x in ref_ms) + " ms; mesh: "
          f"grids {sum(stage_s['mesh grids']):.3f} s, marching tetrahedra "
          f"{sum(stage_s['marching tetrahedra']):.3f} s, largest component "
          f"{sum(stage_s['largest component']):.3f} s; the whole run {run_s:.1f} s")
    print(f"phase 15: {time.perf_counter() - t15:.1f} s")

    sal = (cfg.batch_size, cap, 1, False)
    return {
        "fused_mlp": dict(
            dtu_shape=f"value+grad, {cap} iso-points", dtu_launches=launches["fused_mlp"],
            dtu_launches_per_refresh=per_ref["fused_mlp"],
            dtu_max_abs_err=max(err_v, err_g), dtu_ms=mlp_ms, dtu_plain_ms=mlp_pms,
            dtu_bound_ms=mlp_b[0], dtu_bound_by=mlp_b[1]),
        "knn": dict(
            dtu_shape=f"{sal[0]} x {sal[1]}, k=1 (the SAL match)",
            dtu_launches=launches["knn"], dtu_launches_per_step=per_proj["knn"],
            dtu_launches_per_refresh=per_ref["knn"], dtu_ms=knn_rows[sal][0],
            dtu_plain_ms=knn_rows[sal][1], dtu_bound_ms=knn_rows[sal][2][0],
            dtu_bound_by=knn_rows[sal][2][1],
            dtu_shapes={f"{n}x{p},k={k}{',self' if ex else ''}": dict(
                ms=r[0], plain_ms=r[1], bound_ms=r[2][0])
                for (n, p, k, ex), r in knn_rows.items()},
            dtu_data_normals_20k_ms=ms20, dtu_data_normals_20k_plain_ms=pms20,
            dtu_data_normals_20k_bound_ms=b20[0]),
    }


def dtu_cells_over(points) -> str:
    """How many grid cells of the data normals' search hold more points than
    its 128 slots (the radius of dtu_points.data_normals)."""
    import math
    p = points.shape[0]
    ext = points.amax(0) - points.amin(0)
    r = math.sqrt(float(ext.norm()) / p) * 16.0
    c = torch.clamp(torch.floor((points - points.amin(0)) / r), 0, 1023).long()
    cid = (c[:, 0] << 20) + (c[:, 1] << 10) + c[:, 2]
    n = torch.unique(cid, return_counts=True)[1]
    return (f"{int((n > 128).sum())} of {n.numel()} cells over 128 points "
            f"({int(n[n > 128].sum() - 128 * (n > 128).sum())} points dropped "
            f"from their cells' slots), radius {r:.5f}")


def ablation_phase(dev, kernels) -> dict:
    """Phase 16: the ablation's protocol through its entry points at the
    published size (see the module docstring). `kernels` are the launch
    counters. Returns the raymesh row of the kernels line."""
    import copy

    import numpy as np

    from isopoints_torch import (evaluate_pointclouds, filter_dtu_predictions,
                                 make_ablation_data, summarize_ablation,
                                 train_mvr)
    from isopoints_torch import debug as debug_mod
    from isopoints_torch.core.camera import cameras_from_matrices
    from isopoints_torch.data import synthetic
    from isopoints_torch.misc.metrics import load_metrics
    from isopoints_torch.models import occupancy
    from isopoints_torch.models.fields import OccupancyField
    from isopoints_torch.ops import fused_mlp, raymesh
    from isopoints_torch.ops.images import arange_pixels, sample_random_pixels
    from isopoints_torch.training import trainer as trainer_mod
    from isopoints_torch.utils import fma, meshing
    from isopoints_torch.utils.io import save_ply

    t16 = time.perf_counter()
    counts = lambda: {k.name: k.launches for k in kernels}

    def reset():
        for k in kernels:
            k.launches = 0

    stage_s = collections.defaultdict(list)
    timing = stage_timer(stage_s)
    root = os.path.join(ROOT, "out", "torch_ablation")
    shutil.rmtree(root, ignore_errors=True)
    data_dir = os.path.join(root, "data")

    # (a) the dataset, through the entry with its defaults
    reset()
    with patched((meshing, "eval_sdf_grid", timing("grid", meshing.eval_sdf_grid)),
                 (meshing, "marching_tetrahedra",
                  timing("marching", meshing.marching_tetrahedra)),
                 (meshing, "largest_component",
                  timing("largest", meshing.largest_component)),
                 (synthetic, "ray_mesh_intersect",
                  timing("cast", synthetic.ray_mesh_intersect)),
                 (synthetic, "save_image", timing("png", synthetic.save_image))):
        t = time.perf_counter()
        src_v, src_f, data = make_ablation_data.main([data_dir])
        make_s = time.perf_counter() - t
    rm_launches = counts()["raymesh"]
    n_views, size = data["img.rgb"].shape[0], data["img.rgb"].shape[1]
    if rm_launches <= 0:
        fail("make_ablation_data: the raymesh kernel was not launched")
    cover = float(data["img.mask"].mean())
    print(f"ablation data (make_ablation_data, defaults): compound mesh {len(src_v)} "
          f"verts, {len(src_f)} faces; {n_views} views at {size} px written in "
          f"{make_s:.2f} s: grid {sum(stage_s['grid']):.3f} s, marching tetrahedra "
          f"{sum(stage_s['marching']):.3f} s, largest component "
          f"{sum(stage_s['largest']):.3f} s, ray cast {sum(stage_s['cast']):.3f} s "
          f"({len(stage_s['cast'])} calls, {sum(stage_s['cast']) / n_views * 1e3:.1f} "
          f"ms a view, {n_views * size * size:,} rays in all), {len(stage_s['png'])} "
          f"PNG writes {sum(stage_s['png']):.3f} s; raymesh launches {rm_launches}; "
          f"masks cover {cover:.4f}")
    if not 0.02 < cover < 0.9 or n_views != 24 or size != 512:
        fail(f"make_ablation_data: {n_views} views at {size} px, masks cover {cover}")

    # the kernel at the shape the dataset launches it (4 views, 1,048,576
    # rays, views 0-3), and its plain version on the same rays; one view's
    # time beside it
    cam4 = cameras_from_matrices(data["camera_mat"][:4], data["focal_length"],
                                 data["principal_point"], dev)
    _, ndc4 = arange_pixels((size, size), 4, device=dev)
    _, d4 = cam4.ndc_to_rays(ndc4)
    o4 = torch.broadcast_to(cam4.camera_center()[:, None, :], d4.shape)
    o4, d4 = o4.reshape(-1, 3).contiguous(), d4.reshape(-1, 3).contiguous()
    n1 = size * size
    o0, d0 = o4[:n1], d4[:n1]   # view 0
    # view 0 alone, for (e)
    cam0 = cameras_from_matrices(data["camera_mat"][:1], data["focal_length"],
                                 data["principal_point"], dev)
    _, ndc = arange_pixels((size, size), 1, device=dev)
    packed = raymesh.pack_faces(torch.as_tensor(data["mesh_verts"], device=dev),
                                torch.as_tensor(data["mesh_faces"], device=dev))
    rm_ms = time_ms(lambda: raymesh.intersect_cuda(o4, d4, packed))
    rm_one_ms = time_ms(lambda: raymesh.intersect_cuda(o0, d0, packed))
    t_k, f_k = raymesh.intersect_cuda(o4, d4, packed)
    torch.cuda.synchronize()
    t = time.perf_counter()
    t_p, f_p = raymesh.intersect_plain(o4, d4, packed)
    torch.cuda.synchronize()
    rm_plain_ms = 1e3 * (time.perf_counter() - t)
    pairs = d4.shape[0] * packed.shape[0]
    rm_b = bound_ms(RM_FLOPS_ALL * pairs,
                    (o4.numel() + d4.numel() + packed.numel()) * 4 + d4.shape[0] * 8)
    rm_one_b = bound_ms(RM_FLOPS_ALL * n1 * packed.shape[0],
                        (o0.numel() + d0.numel() + packed.numel()) * 4 + n1 * 8)
    full_equal = torch.equal(t_k, t_p) and torch.equal(f_k, f_p)
    print(f"raymesh kernel at the launched shape (4 views, {d4.shape[0]:,} rays x "
          f"{packed.shape[0]:,} faces): {rm_ms:.3f} ms (median of 7)  plain "
          f"{rm_plain_ms:.1f} ms (one run)  bound {rm_b[0]:.3f} ms ({rm_b[1]}: "
          f"{pairs:.4g} pairs x {RM_FLOPS_ALL} operations); t and faces equal the "
          f"plain version's bit for bit: {full_equal}; one view ({n1:,} rays) "
          f"{rm_one_ms:.3f} ms against {rm_one_b[0]:.3f} ms")
    if not full_equal:
        fail("raymesh: the kernel's t and faces differ from its plain version's "
             "at the launched shape")
    t_k = t_k[:n1]
    # the subset check: every 16th ray of view 0 against all faces
    sub = torch.arange(0, d0.shape[0], 16, device=dev)
    ka = raymesh.ray_mesh_intersect(o0[sub], d0[sub], torch.as_tensor(
        data["mesh_verts"], device=dev), torch.as_tensor(data["mesh_faces"], device=dev))
    pa = raymesh.ray_mesh_intersect_plain(o0[sub], d0[sub], torch.as_tensor(
        data["mesh_verts"], device=dev), torch.as_tensor(data["mesh_faces"], device=dev))
    hit_eq = float((ka.hit == pa.hit).float().mean())
    both = ka.hit & pa.hit
    t_err = float((ka.t - pa.t)[both].abs().max()) if bool(both.any()) else 0.0
    n_err = float((ka.normals - pa.normals)[both].abs().max()) if bool(both.any()) else 0.0
    bad_face = both & (ka.face_idx != pa.face_idx) & ((ka.t - pa.t).abs() > 1e-6)
    rm_err = max(t_err, n_err)
    print(f"raymesh on {sub.numel():,} rays of view 0 against the plain version: hit "
          f"masks equal on {hit_eq:.6f}, {int(both.sum())} rays both hit, t within "
          f"{t_err:.3g}, normals within {n_err:.3g}, faces differing beyond a 1e-6 t "
          f"tie {int(bad_face.sum())}")
    if hit_eq < 0.9999 or t_err > 1e-5 or n_err > 1e-5 or bool(bad_face.any()):
        fail("raymesh: the kernel disagrees with its plain version (bars: masks "
             "0.9999, t 1e-5, normals 1e-5, faces where t differs by > 1e-6)")
    # the known answer: the hits, mapped back to the solid's frame, lie on the
    # compound SDF's zero set to within the 128³ grid
    v = np.asarray(src_v, np.float32)
    center = (v.max(0) + v.min(0)) / 2.0
    scale = float(np.linalg.norm(v - center, axis=-1).max())
    hits = fma(t_k[t_k < 5e9][:, None], d0[t_k < 5e9], o0[t_k < 5e9])
    world = hits * (scale / 0.7) + torch.as_tensor(center, device=dev)
    sdf = make_ablation_data.compound_sdf()(world).abs()
    med, p99 = float(sdf.median()), float(torch.quantile(sdf[:2_000_000], 0.99))
    print(f"raymesh known answer: {world.shape[0]:,} hits of view 0 mapped back through "
          f"normalize_mesh (centre {center.tolist()}, scale {scale:.6f}): |compound_sdf| "
          f"median {med:.3g} (bar {ABL_MEDIAN}), 99th percentile {p99:.3g} (bar "
          f"{ABL_P99:.4g}, one grid cell)")
    if not (med < ABL_MEDIAN and p99 < ABL_P99):
        fail("raymesh known answer: the hits are off the compound solid's surface")
    rm_row = row("raymesh", "isopoints_torch/csrc/raymesh.cu",
                 "none (isopoints_tpu/ops/raymesh.py:36 is XLA, no Pallas kernel)",
                 rm_launches, rm_err, rm_ms, rm_plain_ms, rm_b,
                 shape=f"{d4.shape[0]} rays x {packed.shape[0]} faces (4 512-px views)",
                 plain_runs=1, subset_rays=int(sub.numel()), subset_hit_equal=hit_eq,
                 bit_equal=full_equal, one_view_ms=rm_one_ms,
                 one_view_bound_ms=rm_one_b[0], cast_s=sum(stage_s["cast"]),
                 cast_views=n_views)

    # (b) the three arms, 8 iterations each, validated at 4
    rec = {}
    step_fn = trainer_mod.MVRTrainer.train_step
    project_fn = trainer_mod.project_points
    seed_fn = trainer_mod.MVRTrainer._seed_reference

    def rec_step(self, state, *args, **kw):
        before = counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        rec["it"] = state.it
        out = step_fn(self, state, *args, **kw)
        torch.cuda.synchronize()
        rec["ms"][state.it] = 1e3 * (time.perf_counter() - t)
        rec["launches"][state.it] = {k: v - before[k] for k, v in counts().items()}
        return out

    def rec_project(*args, **kw):
        rec["inserts"].append(rec["it"])
        return project_fn(*args, **kw)

    def rec_seed(self, *args, **kw):
        rec["seeds"].append(rec["it"])
        return seed_fn(self, *args, **kw)

    cfg_root = os.path.join(ROOT, "isopoints_torch", "configs")
    arms, runs = {}, {}
    for arm in ("implicit", "uni", "lossS"):
        cfg = os.path.join(root, f"{arm}.yml")
        with open(cfg, "w") as f:
            f.write(f"inherit_from: {cfg_root}/ablation_compound_{arm}_dir.yml\n"
                    f"data:\n  data_dir: {data_dir}\n")
            if arm != "implicit":
                f.write("training:\n  warm_up_iters: 2\n  resample_every: 2\n")
        out_dir = os.path.join(root, f"ablation_{arm}")
        rec.clear()
        rec.update(ms={}, launches={}, inserts=[], seeds=[], it=0)
        reset()
        t = time.perf_counter()
        with patched((trainer_mod.MVRTrainer, "train_step", rec_step),
                     (trainer_mod, "project_points", rec_project),
                     (trainer_mod.MVRTrainer, "_seed_reference", rec_seed)):
            runs[arm] = train_mvr.main([cfg, "--out-dir", out_dir, "--max-iters", "8",
                                        "--validate-every", "4", "--print-every", "1000"])
        wall = time.perf_counter() - t
        arms[arm] = out_dir
        launched = counts()
        ms = rec["ms"]
        rows_m = load_metrics(os.path.join(out_dir, "metrics.jsonl"))
        ev = [r for r in rows_m if "eval_iou_full" in r]
        tr = [r for r in rows_m if "eval_iou_full" not in r]
        if len(ev) != 1 or [r["it"] for r in tr] != list(range(8)) or not all(
                np.isfinite(r["loss"]) for r in tr):
            fail(f"{arm} arm: metrics rows {rows_m}")
        if arm == "implicit":
            print(f"{arm} arm, 8 iterations in {wall:.1f} s: warm-up median "
                  f"{statistics.median(ms.values()):.2f} ms; launches {launched}; "
                  f"eval at 4: iou_full {ev[0]['eval_iou_full']:.4f}, psnr_full "
                  f"{ev[0]['eval_psnr_full']:.2f}, chamfer {ev[0].get('eval_chamfer')}")
            continue
        for name in ("fused_mlp", "fused_sampler", "knn", "splat_select", "splat_fine"):
            if launched[name] <= 0:
                fail(f"{arm} arm: kernel {name} was not launched")
        print(f"{arm} arm, 8 iterations in {wall:.1f} s: warm-up median "
              f"{statistics.median([ms[0], ms[1]]):.2f} ms, resamples "
              f"{ms[2]:.1f} / {ms[4]:.1f} / {ms[6]:.1f} ms, projected median "
              f"{statistics.median([ms[3], ms[5], ms[7]]):.2f} ms; launches {launched}; "
              f"seeded at {rec['seeds']}, insertions at {rec['inserts']}; eval at 4: "
              f"iou_full {ev[0]['eval_iou_full']:.4f}, psnr_full "
              f"{ev[0]['eval_psnr_full']:.2f}, chamfer {ev[0].get('eval_chamfer')}")
        if arm == "lossS" and (rec["seeds"] != [2] or rec["inserts"] != [4, 6]):
            fail(f"lossS arm: seeded at {rec['seeds']} and inserted at "
                 f"{rec['inserts']}, expected [2] and [4, 6]")
        if arm == "uni" and rec["inserts"]:
            fail(f"uni arm: insertions at {rec['inserts']}")

    # (c) the summary, with the finals at ABL_FINAL_RES³
    reset()
    t = time.perf_counter()
    summ = summarize_ablation.main([arms["implicit"], arms["uni"], arms["lossS"],
                                    "--data-dir", data_dir, "--device", "cuda",
                                    "--final-mesh-resolution", str(ABL_FINAL_RES),
                                    "--out", os.path.join(root, "ABLATION.md")])
    sum_s = time.perf_counter() - t
    head = next(i for i, line in enumerate(summ["lines"]) if line.startswith("| arm |"))
    print("\n".join(summ["lines"][head + 2:head + 5]))
    if set(summ["finals"]) != {"implicit", "uni", "lossS"} or any(
            r is None for _, r in summ["rows"]):
        fail(f"summarize_ablation: rows {summ['rows']}, finals {summ['finals']}")
    for name, tm in summ["final_times"].items():
        print(f"final {name}: chamfer_p {summ['finals'][name]:.6g}; mesh {ABL_FINAL_RES}³ "
              f"{tm['mesh']:.2f} s, largest component {tm.get('largest', 0):.2f} s "
              f"({tm.get('faces', 0):,} faces), evaluate_mesh {tm.get('evaluate', 0):.2f} s")
    print(f"summarize_ablation in {sum_s:.1f} s: launches {counts()}")

    # (d) the two scripts
    pts50, _ = meshing.sample_points_from_mesh(data["mesh_verts"], data["mesh_faces"],
                                               50_000, seed=1)
    offset = np.float32([6e-4, -5e-4, 6e-4])
    gt_ply, pred_ply = os.path.join(root, "gt50k.ply"), os.path.join(root, "pred50k.ply")
    save_ply(gt_ply, pts50)
    save_ply(pred_ply, pts50 + offset)
    reset()
    t = time.perf_counter()
    ch = evaluate_pointclouds.main([pred_ply, gt_ply, "--max-points", "50000"])
    ch_s = time.perf_counter() - t
    ev_launch = counts()["knn"]
    # the card against the CPU on the script's own seeded cut to
    # EVAL_CPU_POINTS of the same clouds (at 50,000 the CPU's plain kNN took
    # 94.8 s of the script's time limit)
    cut = str(EVAL_CPU_POINTS)
    ch_cut = evaluate_pointclouds.main([pred_ply, gt_ply, "--max-points", cut])
    t = time.perf_counter()
    ch_cpu = evaluate_pointclouds.main([pred_ply, gt_ply, "--max-points", cut,
                                        "--device", "cpu"])
    ch_cpu_s = time.perf_counter() - t
    want = 2.0 * float(np.sum(offset.astype(np.float64) ** 2))
    print(f"evaluate_pointclouds, 50,000 samples against themselves shifted by "
          f"{offset.tolist()}: chamfer_p {ch['chamfer_p']:.9g} on the card in {ch_s:.2f} s "
          f"(knn launches {ev_launch}); cut to {EVAL_CPU_POINTS:,}: {ch_cut['chamfer_p']:.9g} "
          f"on the card, {ch_cpu['chamfer_p']:.9g} on the CPU in {ch_cpu_s:.1f} s; "
          f"2|offset|² = {want:.9g}")
    if (abs(ch["chamfer_p"] - want) > 1e-6 or ev_launch != 2
            or abs(ch_cut["chamfer_p"] - want) > 1e-6
            or abs(ch_cut["chamfer_p"] - ch_cpu["chamfer_p"]) > 1e-5 * abs(ch_cpu["chamfer_p"])):
        fail("evaluate_pointclouds: the chamfer misses the offset (1e-6) or the CPU's "
             "(rtol 1e-5)")

    dtu = os.path.join(root, "dtu_torus")
    synthetic.make_synthetic_dtu(synthetic.torus_sdf(), dtu, n_views=8, image_size=512,
                                 device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    # points of the torus (R 0.4, r 0.15), ABL_INSET inside its surface
    a, b = (2 * math.pi * torch.rand(2, FILTER_POINTS, generator=g, device=dev))
    rr = 0.15 - ABL_INSET
    surf = torch.stack([(0.4 + rr * torch.cos(b)) * torch.cos(a),
                        (0.4 + rr * torch.cos(b)) * torch.sin(a), rr * torch.sin(b)], -1)
    exact = torch.stack([(0.4 + 0.15 * torch.cos(b)) * torch.cos(a),
                         (0.4 + 0.15 * torch.cos(b)) * torch.sin(a), 0.15 * torch.sin(b)], -1)
    out_pts = outside_every_silhouette(dtu, FILTER_OUTLIERS, dev)
    scan = torch.cat([surf, out_pts]).cpu().numpy()
    scan_ply = os.path.join(root, "scan.ply")
    save_ply(scan_ply, scan)
    t = time.perf_counter()
    keep = filter_dtu_predictions.main([scan_ply, dtu, os.path.join(root, "kept.ply")])
    f_s = time.perf_counter() - t
    t = time.perf_counter()
    keep_cpu = filter_dtu_predictions.main([scan_ply, dtu, os.path.join(root, "kept_cpu.ply"),
                                            "--device", "cpu"])
    f_cpu_s = time.perf_counter() - t
    exact_ply = os.path.join(root, "exact.ply")
    save_ply(exact_ply, exact.cpu().numpy())
    keep_exact = filter_dtu_predictions.main([exact_ply, dtu, os.path.join(root, "k2.ply")])
    kept_surf = float(keep[:FILTER_POINTS].mean())
    print(f"filter_dtu_predictions on 8 views at 512 px of the torus: {FILTER_POINTS:,} "
          f"points {ABL_INSET} inside the surface kept {kept_surf:.6f}, "
          f"{FILTER_OUTLIERS:,} points outside every silhouette kept "
          f"{int(keep[FILTER_POINTS:].sum())}; card {f_s:.2f} s, CPU {f_cpu_s:.1f} s, keep "
          f"sets equal: {bool(np.array_equal(keep, keep_cpu))}; points exactly on the "
          f"surface kept {float(keep_exact.mean()):.4f} (the silhouette's rim band)")
    if kept_surf < 0.99 or keep[FILTER_POINTS:].any() or not np.array_equal(keep, keep_cpu):
        fail("filter_dtu_predictions: surface points kept < 0.99, an outlier kept, or "
             "the card's keep set differs from the CPU's")

    # (e) DVR: pixels_to_world on the uni arm's model; the occupancy model
    model = runs["uni"].trainer.model
    cam_v = cameras_from_matrices(data["camera_mat"][:2], data["focal_length"],
                                  data["principal_point"], dev)
    seen = collections.Counter()
    siren_cuda = fused_mlp.siren_forward_cuda

    def rec_siren(pack, x, with_grad, bf16=False):
        seen[("bf16" if bf16 else "f32", "value+grad" if with_grad else "value",
              x.shape[0])] += 1
        return siren_cuda(pack, x, with_grad, bf16)

    reset()
    with patched((fused_mlp, "siren_forward_cuda", rec_siren)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        p_eval, m_eval = model.pixels_to_world(ndc, cam0, training=False)
        torch.cuda.synchronize()
        ptw_ms = 1e3 * (time.perf_counter() - t)
        ndc_t = sample_random_pixels(torch.Generator(device=dev).manual_seed(5), 1024,
                                     (size, size), 1, device=dev)
        t = time.perf_counter()
        p_tr, m_tr = model.pixels_to_world(ndc_t, cam0, training=True)
        torch.cuda.synchronize()
        ptw_tr_ms = 1e3 * (time.perf_counter() - t)
    ptw_launches = counts()["fused_mlp"]
    print(f"pixels_to_world (uni arm's model at its 8, SIREN 3x256, use_fused_mlp) over "
          f"one 512-px view: {ptw_ms:.1f} ms, {int(m_eval.sum()):,} of {m_eval.numel():,} "
          f"rays hit; training over 1024 rays {ptw_tr_ms:.1f} ms ({int(m_tr.sum())} hit, "
          f"points carry gradients: {p_tr.requires_grad}); fused_mlp launches "
          f"{ptw_launches} by mode and shape {dict(seen)}")
    if ptw_launches <= 0 or not p_tr.requires_grad or not bool(torch.isfinite(p_eval).all()):
        fail("pixels_to_world: no fused_mlp launch, no gradient or non-finite points")
    sub_ndc = ndc[:, ::16]
    pf, mf = model.pixels_to_world(sub_ndc, cam0, training=False)
    plain_cfg = dataclasses.replace(model.cfg, use_fused_mlp=False)
    fused_cfg, model.cfg = model.cfg, plain_cfg
    try:
        pp, mp = model.pixels_to_world(sub_ndc, cam0, training=False)
    finally:
        model.cfg = fused_cfg
    m_eq = float((mf == mp).float().mean())
    both = mf & mp
    p_err = float((pf - pp)[both].abs().max()) if bool(both.any()) else 0.0
    print(f"pixels_to_world fused against plain on {sub_ndc.shape[1]:,} rays: masks equal "
          f"on {m_eq:.6f}, points within {p_err:.3g} on the {int(both.sum())} rays both hit")
    if m_eq < 0.999 or p_err > 1e-4:
        fail("pixels_to_world: the fused route disagrees with the plain (bars 0.999, 1e-4)")

    occ = occupancy.OccupancyModel(OccupancyField(
        generator=torch.Generator(device=dev).manual_seed(0), device=dev))
    imgs = torch.as_tensor(data["img.mask"][:2], device=dev)
    ndc_o = sample_random_pixels(torch.Generator(device=dev).manual_seed(6), 1024,
                                 (size, size), 2, device=dev)
    steps = torch.rand(100, generator=torch.Generator(device=dev).manual_seed(7),
                       device=dev)
    opt = torch.optim.Adam(occ.parameters(), lr=1e-3)
    t = time.perf_counter()
    for _ in range(OCC_STEPS):
        o = occ(ndc_o, imgs, cam_v, steps)
        loss = (occupancy.occupancy_bce_loss(o.logits_freespace,
                                             torch.zeros_like(o.logits_freespace),
                                             mask=o.freespace_mask)
                + occupancy.occupancy_bce_loss(o.logits_occupancy,
                                               torch.ones_like(o.logits_occupancy),
                                               mask=o.occupancy_mask))
        opt.zero_grad()
        loss.backward()
        opt.step()
    torch.cuda.synchronize()
    occ_train_s = time.perf_counter() - t
    with torch.no_grad():
        t = time.perf_counter()
        o_dev = occ(ndc_o, imgs, cam_v, steps)
        torch.cuda.synchronize()
        occ_ms = 1e3 * (time.perf_counter() - t)
        occ_cpu = copy.deepcopy(occ).cpu()
        cam_cpu = cameras_from_matrices(data["camera_mat"][:2], data["focal_length"],
                                        data["principal_point"], "cpu")
        t = time.perf_counter()
        o_cpu = occ_cpu(ndc_o.cpu(), imgs.cpu(), cam_cpu, steps.cpu())
        occ_cpu_s = time.perf_counter() - t
    cross_eq = float((o_dev.network_mask.cpu() == o_cpu.network_mask).float().mean())
    l_ref = o_cpu.logits_freespace
    l_err = float((o_dev.logits_freespace.cpu() - l_ref).abs().max())
    # per element within OCC_LOGIT_TOL·max(1, |logit|): float32 sums of 512
    # products in another order, through 11 layers
    l_share = float(((o_dev.logits_freespace.cpu() - l_ref).abs()
                     / l_ref.abs().clamp(min=1.0)).max())
    # the same forward with TF32 products, read beside it: the gap of a
    # lower-precision run, which the bar must catch
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            o_tf = occ(ndc_o, imgs, cam_v, steps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_was
    tf_share = float(((o_tf.logits_freespace.cpu() - l_ref).abs()
                      / l_ref.abs().clamp(min=1.0)).max())
    t = time.perf_counter()
    ov, of = occ.generate_mesh(128)
    occ_mesh_s = time.perf_counter() - t
    print(f"occupancy model (OccupancyField 5x512, n_steps 100) on 2 views x 1024 rays, "
          f"after {OCC_STEPS} Adam steps on the BCE targets ({occ_train_s:.1f} s): forward "
          f"{occ_ms:.1f} ms on the card, {occ_cpu_s:.1f} s on the CPU; crossings "
          f"{int(o_dev.network_mask.sum())} (card) / {int(o_cpu.network_mask.sum())} (CPU), "
          f"masks equal on {cross_eq:.6f}, candidate logits within {l_err:.3g} "
          f"(|logit| up to {float(l_ref.abs().max()):.4g}; {l_share:.3g} of "
          f"max(1, |logit|), bar {OCC_LOGIT_TOL}; with TF32 products "
          f"{tf_share:.3g}); generate_mesh(128) {len(ov)} verts, {len(of)} faces in {occ_mesh_s:.2f} s; "
          f"final loss {loss.item():.5f}")
    if cross_eq < 0.999 or l_share > OCC_LOGIT_TOL or len(of) == 0:
        fail(f"occupancy model: masks (0.999), logits ({OCC_LOGIT_TOL} of "
             f"max(1, |logit|)) or an empty mesh")

    # (f) one projected uni step with the debug taps on, and the same step off
    trainer, state = runs["uni"].trainer, runs["uni"].state
    state = state._replace(it=state.it + 1)   # a projected step without resample
    batch = runs["uni"].views(np.asarray(train_mvr.draw_views(0, state.it, n_views)))
    snap = {k: v.clone() for k, v in model.state_dict().items()}
    opt0, gen0 = copy.deepcopy(state.opt_state), trainer.generators.state()
    debug_mod.set_debugging_mode_(True)
    try:
        _, m_on = trainer.train_step(state, *batch)
        cap = debug_mod.get_debugging_tensor()
        iso_pts = cap.pts_world.get("iso")
        iso_grad = cap.pts_world_grad.get("iso")
        after_on = {k: v.clone() for k, v in model.state_dict().items()}
    finally:
        debug_mod.set_debugging_mode_(False)
    model.load_state_dict(snap)
    trainer.generators.set_state(gen0)
    _, m_off = trainer.train_step(state._replace(opt_state=opt0), *batch)
    same = m_on["loss"] == m_off["loss"] and all(
        torch.equal(after_on[k], v) for k, v in model.state_dict().items())
    ok = (iso_pts is not None and iso_pts.dim() == 3 and iso_pts.shape[-1] == 3
          and iso_grad.shape == iso_pts.shape and bool(torch.isfinite(iso_grad).all()))
    print(f"debug taps on a projected uni step (it {state.it}): 'iso' capture "
          f"{None if iso_pts is None else tuple(iso_pts.shape)}, gradients finite "
          f"{ok}, |g| max {float(iso_grad.abs().max()) if ok else float('nan'):.4g}; loss "
          f"{m_on['loss']:.6g} and updated parameters bit-equal to the step with "
          f"debugging off: {same}")
    if not (ok and same):
        fail("debug taps: no finite (B, n_iso, 3) capture, or the taps changed the step")
    print(f"phase 16: {time.perf_counter() - t16:.1f} s")
    return rm_row


DTU_MVR_ITERS = 44         # 40 warm-up steps, the resample at 40, 3 projected
DTU_MVR_VALIDATE = 43      # the validate cadence's one evaluation, at its 43
# the kernels of the G phase's path: launched in every projected step; the
# MLP, sampler and march kernels have no instance for a field with
# positional encoding (neither has the JAX package) and must not launch
DTU_MVR_KERNELS = ("knn", "splat_select", "splat_fine")
DTU_MVR_NO_KERNEL = ("fused_mlp", "fused_igr", "fused_sampler", "trace_march")


def kernel_of(source: str) -> str:
    """The launch counter's name of a kernels-line row's source file."""
    name = os.path.splitext(os.path.basename(source))[0]
    return {"fused_trace": "trace_march"}.get(name, name)


def dtu_mvr_phase(dev, kernels):
    """Phase 17: the reference's main MVR configuration at full width
    (isopoints_torch/configs/dtu_mvr_dir.yml over configs/dtu_mvr.yml, see
    the module docstring). `kernels` are the launch counters. Returns (the
    launches by kernel of the train_mvr run, the run)."""
    import numpy as np

    from isopoints_torch import create_mvr_data, generate_mvr, train_mvr
    from isopoints_torch.factories import create_model
    from isopoints_torch.misc.metrics import load_metrics
    from isopoints_torch.models.generator import Generator
    from isopoints_torch.ops import knn
    from isopoints_torch.training import trainer as trainer_mod
    from isopoints_torch.training.trainer import compute_loss
    from isopoints_torch.utils import meshing

    t17 = time.perf_counter()
    counts = lambda: {k.name: k.launches for k in kernels}
    # the plain f32 field, as the port's parity bars assume
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg_path = os.path.join("isopoints_torch", "configs", "dtu_mvr_dir.yml")
    data_dir = os.path.join("out", "torch_data_dtu_torus")   # the config's
    if not os.path.exists(os.path.join(data_dir, "cameras.npz")):
        create_mvr_data.main(["torus", data_dir, "--dtu", "--image-size", "512",
                              "--n-views", "8"])
    stage_s = collections.defaultdict(list)
    timing = stage_timer(stage_s)
    rec = {"ms": {}, "launches": {}}
    step_fn = trainer_mod.MVRTrainer.train_step

    def rec_step(self, state, *args, **kw):
        before = counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(self, state, *args, **kw)
        torch.cuda.synchronize()
        rec["ms"][state.it] = 1e3 * (time.perf_counter() - t)
        rec["launches"][state.it] = {k: v - before[k] for k, v in counts().items()}
        return out

    out_dir = os.path.join("out", "torch_dtu_mvr_dir")
    shutil.rmtree(out_dir, ignore_errors=True)
    for k in kernels:
        k.launches = 0
    with patched((trainer_mod.MVRTrainer, "train_step", rec_step),
                 (train_mvr, "_validate", timing("validate", train_mvr._validate))):
        t = time.perf_counter()
        run = train_mvr.main([cfg_path, "--out-dir", out_dir, "--max-iters",
                              str(DTU_MVR_ITERS), "--print-every", "1000",
                              "--validate-every", str(DTU_MVR_VALIDATE),
                              "--checkpoint-every", "1000"])
        wall = time.perf_counter() - t
    launches = counts()
    cfg, trainer, state = run.cfg, run.trainer, run.state
    model = trainer.model
    warm = trainer.cfg.warm_up_iters
    width = (cfg.model.decoder_kwargs.hidden_size, cfg.model.decoder_kwargs.n_layers,
             model.decoder.num_frequencies, cfg.training.n_rays,
             model.ccfg.max_iso_per_batch, model.ccfg.n_points_per_cloud,
             cfg.renderer.raster_params.image_size, model.raster_settings.image_size)
    if width != (512, 8, 6, 2048, 4000, 8000, 512, 256):
        fail(f"dtu_mvr_dir.yml: not the config's width (hidden, layers, frequencies, "
             f"rays, visible, cloud, raster, visibility) {width}")
    rows = load_metrics(os.path.join(out_dir, "metrics.jsonl"))
    train_rows = [r for r in rows if "loss" in r]
    eval_rows = [r for r in rows if any(k.startswith("eval_") for k in r)]
    keys = ("loss", "loss_rgb", "loss_freespace", "loss_occupied", "loss_eikonal")
    if [r["it"] for r in train_rows] != list(range(DTU_MVR_ITERS)) or not all(
            math.isfinite(r[k]) for r in train_rows for k in keys):
        fail(f"dtu_mvr_dir.yml: training rows {train_rows}")
    if [r["it"] for r in eval_rows] != [DTU_MVR_VALIDATE] or not all(
            math.isfinite(v) for k, v in eval_rows[0].items() if k != "ts"):
        fail(f"dtu_mvr_dir.yml: evaluation rows {eval_rows}")
    if not os.path.exists(os.path.join(out_dir, "model_best.npz")):
        fail("dtu_mvr_dir.yml: no model_best.npz after the evaluation")
    for it, lc in sorted(rec["launches"].items()):
        if it > warm and any(lc[k] <= 0 for k in DTU_MVR_KERNELS):
            fail(f"dtu_mvr_dir.yml: projected step {it} launched {lc}")
    if any(launches[k] != 0 for k in DTU_MVR_NO_KERNEL):
        fail(f"dtu_mvr_dir.yml: a kernel with no instance for this field launched: "
             f"{launches}")
    ms = rec["ms"]
    w_ms = [ms[i] for i in range(1, warm)]
    p_ms = [ms[i] for i in range(warm + 1, DTU_MVR_ITERS)]
    print(f"dtu_mvr_dir.yml (configs/dtu_mvr.yml: IGR 8x512, 6 frequencies, "
          f"skip at 4, neural texture; 2048 rays, 4000 of 8000 iso-points, 512-px "
          f"rasters, 256-px visibility) on {data_dir}: {DTU_MVR_ITERS} iterations "
          f"in {wall:.2f} s, the evaluation at its {DTU_MVR_VALIDATE} "
          f"{sum(stage_s['validate']):.2f} s")
    print(f"  steps (ms): the first {ms[0]:.2f}; warm-up its 1-{warm - 1} median "
          f"{statistics.median(w_ms):.2f} (min {min(w_ms):.2f}, max {max(w_ms):.2f}); "
          f"resample step at its {warm} "
          f"{ms[warm]:.2f}; projected " + ", ".join(f"{v:.2f}" for v in p_ms)
          + f" (median {statistics.median(p_ms):.2f})")
    print("  launches by step (its 0, 1 and from the resample on): " + "; ".join(
        f"{it}: " + ", ".join(f"{k} {v}" for k, v in lc.items() if v)
        for it, lc in sorted(rec["launches"].items()) if it < 2 or it >= warm))
    print(f"  launches in the run: {launches} (fused_mlp, fused_igr, fused_sampler "
          f"and trace_march 0, as asserted)")
    print(f"  losses (its 0, {warm - 1} and from the resample on): " + "; ".join(
        f"{r['it']}: " + " ".join(f"{k}={r[k]:.6g}" for k in keys + ("n_iso",))
        for r in train_rows if r["it"] in (0, warm - 1) or r["it"] >= warm)
          + f"; n_iso by step {[int(r['n_iso']) for r in train_rows]}; overflow "
          f"(trace, sampler) summed {sum(r['overflow_trace'] for r in train_rows)}, "
          f"{sum(r['overflow_sampler'] for r in train_rows)}")
    print(f"  evaluation: " + " ".join(f"{k}={v:.6g}" for k, v in eval_rows[0].items()
                                       if k.startswith("eval_")))

    # one projected step under the profiler: the device's busy share and
    # the share of the plain MLP's products (the GEMM kernels)
    it = state.it
    batch = run.views(train_mvr.draw_views(0, it, 8))
    torch.cuda.synchronize()
    t = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, _ = trainer.train_step(state, *batch)
        torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t)
    dev_ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3
    is_gemm = lambda n: any(s in n.lower() for s in ("gemm", "xmma", "cutlass"))
    gemm = sum(e.time_range.elapsed_us() for e in dev_ev if is_gemm(e.name)) / 1e3
    by_name = collections.Counter()
    for e in dev_ev:
        by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3
    print(f"  a projected step (its {it}) profiled: {step_ms:.2f} ms wall, device "
          f"{busy:.2f} ms ({100 * busy / step_ms:.1f}% busy); the plain MLP's GEMMs "
          f"{gemm:.2f} ms = {100 * gemm / step_ms:.1f}% of the step, "
          f"{100 * gemm / max(busy, 1e-9):.1f}% of device time; largest kernels: "
          + "; ".join(f"{n} {v:.2f} ms" for n, v in by_name.most_common(5)))

    # the same projected step's terms with the kernels and the plain versions
    # (no kernel: plain rasterizer stages, dense kNN) on identical draws
    it = state.it
    img, mask, cam = run.views(train_mvr.draw_views(0, it, 8))
    step = trainer.step_fn(True, trainer.scheduler.at(it)["n_rays"])
    draws = trainer.draw(step.n_rays, tuple(img.shape[1:3]), img.shape[0],
                         n_points=state.points.shape[1], n_eikonal=step.n_eikonal)
    hp = {k: float(v) for k, v in trainer.scheduler.at(it).items()
          if k in ("lambda_rgb", "lambda_freespace", "lambda_occupied", "sdf_alpha")}
    hp["lambda_eikonal"] = trainer.cfg.lambda_eikonal
    plain_model = create_model(cfg, device=dev)
    plain_model.load_state_dict(model.state_dict())
    plain_model.raster_settings = dataclasses.replace(model.raster_settings,
                                                      use_pallas=False)
    res, cmp_launches = {}, {}
    for name, m in (("kernels", model), ("plain", plain_model)):
        before = counts()
        with patched(*(((knn, "knn_points_cuda", knn.knn_points_dense),)
                       if name == "plain" else ())):
            _, met, _, _, _ = compute_loss(
                m, state.points, state.points_mask, draws.pixels, img, mask, cam,
                draws.eikonal, draws.u_minsdf, hp, project=True,
                proj_draws=draws.projected, spacing=state.spacing)
        res[name] = {k: float(v.detach()) for k, v in met.items()}
        cmp_launches[name] = {k: v - before[k] for k, v in counts().items() if v - before[k]}
    gap = max(abs(res["kernels"][k] - res["plain"][k]) / max(abs(res["plain"][k]), 1e-12)
              for k in keys)
    print(f"  a projected step (its {it}) with the kernels and with the plain "
          f"versions on identical draws: {res}; launches {cmp_launches}; largest "
          f"relative gap of the terms {gap:.3g} (rtol 1e-5)")
    if res["kernels"]["n_iso"] != res["plain"]["n_iso"] or gap > 1e-5:
        fail("dtu_mvr_dir.yml: the kernel and plain paths' terms differ beyond rtol 1e-5")
    if cmp_launches["plain"] or not all(cmp_launches["kernels"].get(k, 0) > 0
                                        for k in DTU_MVR_KERNELS):
        fail(f"dtu_mvr_dir.yml: launches of the comparison {cmp_launches}")

    # generation through the entry: the mesh at 256³ (the config's 512³,
    # reduced), 4 views at the entry's 256 px
    gen_dir = os.path.join(out_dir, "generation")
    stage_s.clear()
    with patched((meshing, "eval_sdf_grid", timing("grid", meshing.eval_sdf_grid)),
                 (meshing, "marching_tetrahedra",
                  timing("marching", meshing.marching_tetrahedra)),
                 (meshing, "largest_component",
                  timing("largest", meshing.largest_component)),
                 (Generator, "raytrace_images", timing("render", Generator.raytrace_images))):
        t = time.perf_counter()
        verts, faces, rgba = generate_mvr.main([
            cfg_path, "--checkpoint", os.path.join(out_dir, "model.npz"),
            "--out-dir", gen_dir, "--mesh-resolution", "256"])
        wall_g = time.perf_counter() - t
    if len(faces) == 0 or not np.isfinite(verts).all() or not np.isfinite(rgba).all():
        fail(f"dtu_mvr_dir.yml generation: {len(verts)} verts, {len(faces)} faces")
    print(f"  generation (generate_mvr, mesh 256, reduced from the config's 512; "
          f"{rgba.shape[0]} views at {rgba.shape[1]} px) in {wall_g:.2f} s: "
          f"{len(verts)} verts, {len(faces)} faces; " + ", ".join(
              f"{k} {sum(v):.3f} s ({len(v)})" for k, v in stage_s.items()))
    print(f"phase 17: {time.perf_counter() - t17:.1f} s")
    return launches, run


def parallel_phase(dev, run) -> None:
    """Phase 18: parallel/ at world size 1 under NCCL: one projected step of
    phase 17's state through `make_train_step` over a process group against
    the same step without one (and a repeat of it), and the all-reduce's
    time."""
    import socket

    import torch.distributed as dist

    from isopoints_torch import train_mvr
    from isopoints_torch.parallel.sharding import (Mesh, all_reduce_mean,
                                                   make_mesh, make_train_step)

    t18 = time.perf_counter()
    trainer, state = run.trainer, run.state
    model = trainer.model
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, dev)
        if mesh.group is None or mesh.size != 1:
            fail(f"parallel: make_mesh did not adopt the process group: {mesh}")
        it = state.it
        img, mask, cam = run.views(train_mvr.draw_views(0, it, 8))
        n_rays = trainer.scheduler.at(it)["n_rays"]
        kw = dict(n_eikonal_points=trainer.cfg.n_eikonal_points,
                  learning_rate=trainer.cfg.learning_rate,
                  grad_clip=trainer.cfg.grad_clip)
        steps = {"no group": make_train_step(model, Mesh(), True, n_rays, **kw),
                 "group": make_train_step(model, mesh, True, n_rays, **kw)}
        draws = trainer.draw(steps["group"].n_rays, tuple(img.shape[1:3]),
                             img.shape[0], n_points=state.points.shape[1],
                             n_eikonal=steps["group"].n_eikonal)
        hp = {k: float(v) for k, v in trainer.scheduler.at(it).items()
              if k in ("lambda_rgb", "lambda_freespace", "lambda_occupied",
                       "sdf_alpha")}
        hp["lambda_eikonal"] = trainer.cfg.lambda_eikonal
        saved = {k: v.clone() for k, v in model.state_dict().items()}

        def once(name):
            model.load_state_dict(saved)
            torch.cuda.synchronize()
            t = time.perf_counter()
            opt, pts, msk, met, _ = steps[name](
                state.opt_state, state.points, state.points_mask, state.spacing,
                img, mask, cam, hp, draws)
            torch.cuda.synchronize()
            out = [v.clone() for v in model.state_dict().values()]
            out += [opt.mu[k] for k in opt.mu] + [opt.nu[k] for k in opt.nu]
            out += [pts, msk, torch.stack(list(met.values()))]
            return out, 1e3 * (time.perf_counter() - t), met

        a, a_ms, met = once("no group")
        b, b_ms, _ = once("group")
        c, c_ms, _ = once("no group")
        model.load_state_dict(saved)
        same = lambda x, y: all(torch.equal(u, v) for u, v in zip(x, y))
        repeat_equal, group_equal = same(a, c), same(a, b)
        n_par = sum(p.numel() for p in model.parameters())
        grads = [torch.randn(p.shape, device=dev) for p in model.parameters()]
        vals = torch.randn(len(met), device=dev)
        ar_ms = time_ms(lambda: all_reduce_mean(grads + [vals], mesh))
        flat = torch.randn(n_par + len(met), device=dev)
        nccl_ms = time_ms(lambda: dist.all_reduce(flat, group=mesh.group))
        print(f"parallel (world size 1, NCCL over tcp://127.0.0.1): a projected step "
              f"of phase 17's state (its {it}) through make_train_step without a "
              f"process group {a_ms:.2f} ms, with it {b_ms:.2f} ms, without again "
              f"{c_ms:.2f} ms; parameters, Adam moments, the iso-point buffer and "
              f"the metrics bit-equal with the group: {group_equal} (the repeat "
              f"without: {repeat_equal})")
        print(f"  the step's all-reduce of {n_par + len(met):,} floats "
              f"({4 * (n_par + len(met)) / 2 ** 20:.2f} MiB; the gradients and "
              f"metrics): all_reduce_mean {ar_ms:.4f} ms, the NCCL all_reduce alone "
              f"{nccl_ms:.4f} ms (CUDA events, median of 7)")
        if not group_equal:
            fail("parallel: the step over the process group is not bit-equal to "
                 "the step without one")
    finally:
        dist.destroy_process_group()
    print(f"phase 18: {time.perf_counter() - t18:.1f} s")


# phase 19's kNN orders past 16 (a warp a query) and its known answers. The
# bars were set before the first chip run from a CPU rehearsal of the same
# code on the same data (PERF.md §6): on a noise-free torus with the
# planted blobs, remove_outliers kept 100% of the torus and dropped 100% of
# the blobs; on the noisy scan it dropped every blob (and, at the scan's
# noise sigma 0.02, nearly every scan point); the latent projection lowered
# the median |torus_sdf| of the scan's subsample from 0.0133 to 0.0123; the
# signed distance's sign matched compound_sdf's on every rehearsed point
# more than a 128³ cell from the surface
PS_KS = (17, 24, 31, 32)
PS_SCAN_POINTS = 20_000    # (c): the subsample of phase 15's scan
PS_BLOBS, PS_BLOB_POINTS, PS_BLOB_SIGMA = 10, 20, 0.05   # 1% planted outliers
PS_BLOB_DROP = 0.99        # share of the planted points remove_outliers drops
PS_CLEAN_KEEP = 0.99       # share of a noise-free torus it keeps
PS_SDL_POINTS = 4096       # (f): points near the compound mesh
PS_SDL_CPU = 512           # of them, the CPU reference's (17.88 s on the GPU host)
PS_SIGN_BAR = 0.999        # sign agreement with compound_sdf past one cell


@contextlib.contextmanager
def plain_calls():
    """Count the calls of every plain version a kernel stands for (the
    dense kNN, the plain SIREN value and gradient, the plain selection,
    fine stage, zbuf and occupancy backward), by name, while the block
    runs."""
    from isopoints_torch.ops import fused_mlp, knn
    from isopoints_torch.rendering import occ_bwd, rasterizer, select, splat
    calls = collections.Counter()

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    triples = [(knn, "knn_points_dense", counting("knn", knn.knn_points_dense))]
    for mod, names in ((select, ("select_candidates_plain",)),
                       (splat, ("rasterize_fine_plain", "zbuf_backward_points_plain")),
                       (occ_bwd, ("occ_backward_plain",)),
                       (rasterizer, ("select_candidates_plain", "rasterize_fine_plain",
                                     "zbuf_backward_points_plain",
                                     "occ_backward_plain"))):
        triples += [(mod, n, counting(n, getattr(mod, n))) for n in names]
    plain = {k: dict(v) for k, v in (("_PLAIN", fused_mlp._PLAIN),
                                     ("_PLAIN_GRAD", fused_mlp._PLAIN_GRAD))}
    for attr, table in plain.items():
        getattr(fused_mlp, attr).update(
            {kind: counting(f"mlp {kind}", fn) for kind, fn in table.items()})
    try:
        with patched(*triples):
            yield calls
    finally:
        for attr, table in plain.items():
            getattr(fused_mlp, attr).update(table)


def pointset_phase(dev, kernels, p4, scene, pmodel, pcam) -> dict:
    """Phase 19: the point-set library at full width (see the module
    docstring). `p4`: phase 4's model, capacity and resample buffer;
    `scene`: phase 8's splat frame; `pmodel`, `pcam`: phase 9's point
    model and views. Returns the `rimls_*` keys of the knn row."""
    import numpy as np

    from isopoints_torch import bench, train_dtu_points
    from isopoints_torch.core.cloud import PointCloud
    from isopoints_torch.data import synthetic
    from isopoints_torch.make_ablation_data import compound_sdf
    from isopoints_torch.models import levelset
    from isopoints_torch.ops import fused_mlp, knn
    from isopoints_torch.ops import points as ops_points
    from isopoints_torch.ops.imls import project_to_latent_surface
    from isopoints_torch.rendering.rasterizer import (compute_splat_params,
                                                      visible_point_mask)
    from isopoints_torch.rendering.renderer import render_pointcloud
    from isopoints_torch.training import losses
    from isopoints_torch.utils import meshing
    from isopoints_torch.utils.io import read_ply
    from isopoints_torch.workloads import dtu_points

    t19 = time.perf_counter()
    counts = lambda: {k.name: k.launches for k in kernels}

    def run(label, fn, plain=False):
        """fn() with every launch counter 0 just before and read just after,
        the plain versions' calls counted, the kNN and fused_mlp launches
        recorded by shape; with `plain` the kNN kernel swapped for its plain
        version. Returns (out, launches, plain calls, shapes, seconds)."""
        shapes = collections.Counter()
        knn_cuda, siren_cuda = knn.knn_points_cuda, fused_mlp.siren_forward_cuda

        def rec_knn(q, p, qm, pm, k, exclude_self=False):
            shapes[f"knn {q.shape[0]}x{q.shape[1]} of {p.shape[1]} k={k}"] += 1
            return knn_cuda(q, p, qm, pm, k, exclude_self)

        def rec_siren(pack, x, with_grad, bf16=False):
            shapes[f"fused_mlp {'value+grad' if with_grad else 'value'} "
                   f"{'bf16 ' if bf16 else ''}n={x.shape[0]}"] += 1
            return siren_cuda(pack, x, with_grad, bf16)

        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        with plain_calls() as pc:
            # inside: the swapped-in dense kNN's calls count as plain
            swaps = ([(knn, "knn_points_cuda", knn.knn_points_dense)] if plain else
                     [(knn, "knn_points_cuda", rec_knn),
                      (fused_mlp, "siren_forward_cuda", rec_siren)])
            with patched(*swaps):
                out = fn()
            torch.cuda.synchronize()
        s = time.perf_counter() - t
        launched = {k: v for k, v in counts().items() if v}
        if plain:
            if launched:
                fail(f"phase 19 {label}, plain versions: kernels launched {launched}")
            if not pc:
                fail(f"phase 19 {label}, plain versions: no plain version ran")
        elif pc:
            fail(f"phase 19 {label}: plain versions ran beside the kernels: {dict(pc)}")
        print(f"phase 19 {label} ({'plain versions' if plain else 'kernels'}): "
              f"{s:.3f} s; launches {launched or 'none'}"
              + (f"; plain calls {dict(pc)}" if plain else
                 f"; by shape {dict(shapes)}"))
        return out, counts(), dict(pc), shapes, s

    def launched(label, c, names):
        for name in names:
            if c[name] <= 0:
                fail(f"phase 19 {label}: kernel {name} was not launched")

    # ---- (a) the kNN kernel at 16 < k <= 32 (a warp a query)
    g = torch.Generator(device=dev).manual_seed(19)
    v = torch.randn((2, 8000, 3), generator=g, device=dev)
    sphere = ("sphere", *(0.5 * v / v.norm(dim=-1, keepdim=True),) * 2,
              *(torch.rand((2, 8000), generator=g, device=dev) < 0.95,) * 2, True)
    cases = 0
    for k in kernels:
        k.launches = 0
    for k in PS_KS:
        for label, q, pts, qm, pm, is_self in knn_clouds(dev) + [sphere]:
            for ex in ((False, True) if is_self else (False,)):
                knn_equal(q, pts, qm, pm, k, ex, label)
                cases += 1
    if counts()["knn"] != cases:
        fail(f"phase 19 (a): {counts()['knn']} kNN launches for {cases} cases")
    print(f"phase 19 (a): the kNN kernel at k = {PS_KS} on knn_clouds' adversarial "
          f"clouds and an 8000-point sphere, with and without self-exclusion: "
          f"{cases} cases, distances, indices and masks equal to the plain "
          f"version's bit for bit")
    # the RIMLS losses' shape: phase 9's cloud in its 2 views, k = 32
    x = pmodel.points.detach().expand(pcam.batch_size, -1, -1).contiguous()
    xn = pmodel.normals().detach().expand(pcam.batch_size, -1, -1).contiguous()
    xm = torch.ones(x.shape[:2], dtype=torch.bool, device=dev)
    knn_equal(x, x, xm, xm, 32, True, "RIMLS shape")
    r_ms = time_ms(lambda: knn.knn_points(x, x, xm, xm, k=32, exclude_self=True))
    r_pms = time_ms(lambda: knn.knn_points(x, x, xm, xm, k=32, exclude_self=True,
                                           method="dense"), reps=3)
    nv = xm.sum(-1).double()
    # N·P distance evaluations of 9 FLOP (as row 4); xyz + mask in, k pairs out
    r_b = bound_ms(9.0 * float((nv * nv).sum()),
                   x.shape[0] * (x.shape[1] * 13 + x.shape[1] * 32 * 12))
    print(f"knn at the RIMLS shape ({x.shape[0]} x {x.shape[1]}, k=32, "
          f"self-excluded): kernel {r_ms:.4f} ms  plain {r_pms:.3f} ms  bound "
          f"{r_b[0]:.4f} ms ({r_b[1]})")

    # ---- (b) phase 4's SIREN 3x256 at the projected config's capacity
    model, cap = p4["model"], p4["cap"]
    f_k = model.trace_sdf_fn()
    f_p = fused_mlp.PlainSDF(fused_mlp.SirenPack(model.decoder))
    pcfg, radius = model.proj_cfg, model.cfg.object_bounding_sphere
    tol = pcfg.proj_tolerance
    cube = torch.rand((1, 4 * cap, 3), generator=g, device=dev)
    noise = torch.randn((1, cap, 3), generator=g, device=dev)   # WLOP keeps 1/4
    res_pts, res_mask = p4["res"]
    n_free = cap - res_pts.shape[1]
    buf = torch.cat([res_pts, (torch.rand((1, n_free, 3), generator=g, device=dev)
                               - 0.5) * 2.0 * radius], 1)
    bmask = torch.cat([res_mask, torch.ones((1, n_free), dtype=torch.bool,
                                            device=dev)], 1)
    parts = (
        ("(b) unseeded bootstrap", lambda f: levelset.sample_uniform_iso_points(
            f, cap, None, bounding_sphere_radius=radius, cfg=pcfg, cube_u=cube,
            wlop_noise=noise)),
        ("(b) project_points, midpoint upsampling", lambda f: levelset.project_points(
            f, buf, bmask, pcfg, skip_upsampling=False)),
        ("(b) project_points, edge-aware upsampling", lambda f: levelset.project_points(
            f, buf, bmask, pcfg, skip_upsampling=False, edge_aware=True)))
    print(f"phase 19 (b): capacity {cap}; the upsampling's input: the resample's "
          f"{res_pts.shape[1]}-point buffer ({int(res_mask.sum())} valid) and "
          f"{n_free} cube seeds, target {int(bmask.sum())}; tolerance {tol}")
    for label, fn in parts:
        outs = {}
        for plain, f in ((False, f_k), (True, f_p)):
            out, c, _, _, _ = run(label, lambda: fn(f), plain)
            if not plain:
                launched(label, c, ("fused_mlp", "knn"))
            n = int(out.mask.sum())
            fv = f(out.points[out.mask][None])
            if (abs(n - cap) > 0.005 * cap or not torch.isfinite(out.points).all()
                    or float(fv.abs().max()) > tol):
                fail(f"phase 19 {label} ({'plain' if plain else 'kernels'}): "
                     f"{n} of {cap} points (bar: within 0.5%), max |f| "
                     f"{float(fv.abs().max()):.3g} (tol {tol})")
            outs[plain] = out
        a, b = outs[False], outs[True]
        d = torch.cdist(a.points[a.mask], b.points[b.mask],
                        compute_mode="donot_use_mm_for_euclid_dist").amin(dim=1)
        print(f"  {label}: counts kernels {int(a.mask.sum())} / plain "
              f"{int(b.mask.sum())} of {cap}; the kernel run's points within "
              f"1e-5 / 1e-4 of a plain run's: {float((d <= 1e-5).float().mean()):.4f}"
              f" / {float((d <= 1e-4).float().mean()):.4f}")
        if abs(int(a.mask.sum()) - int(b.mask.sum())) > 0.005 * cap:
            fail(f"phase 19 {label}: kernel and plain counts differ by > 0.5%")

    # ---- (c) a subsample of phase 15's noisy torus scan
    scan = os.path.join(ROOT, "out", "dtu_torus_1m.ply")
    sub, _ = train_dtu_points.load_cloud(scan, 0.0, PS_SCAN_POINTS, 19, device=dev)
    sub = torch.as_tensor(sub, device=dev)[None]
    sm = torch.ones(sub.shape[:2], dtype=torch.bool, device=dev)
    sn = dtu_points.data_normals(sub, sm)
    rng = np.random.RandomState(19)
    ang = np.arange(PS_BLOBS) * 2 * np.pi / PS_BLOBS
    centers = np.stack([0.4 * np.cos(ang), 0.4 * np.sin(ang),
                        np.where(np.arange(PS_BLOBS) % 2 == 0, 0.6, -0.6)], -1)
    blobs = torch.as_tensor((centers[:, None] + PS_BLOB_SIGMA * rng.randn(
        PS_BLOBS, PS_BLOB_POINTS, 3)).reshape(1, -1, 3).astype(np.float32), device=dev)
    tsdf = synthetic.torus_sdf()
    clean = levelset.project_points_newton(tsdf, sub, sm, max_iters=30,
                                           tolerance=1e-5).points
    n_bl = blobs.shape[1]
    for label, base in (("noisy scan", sub), ("noise-free torus", clean)):
        xs = torch.cat([base, blobs], 1)
        xsm = torch.ones(xs.shape[:2], dtype=torch.bool, device=dev)
        keep = {}
        for plain in (False, True):
            keep[plain], c, _, _, _ = run(f"(c) remove_outliers, {label}",
                                          lambda: ops_points.remove_outliers(xs, xsm),
                                          plain)
            if not plain:
                launched("(c) remove_outliers", c, ("knn",))
        if not torch.equal(keep[False], keep[True]):
            fail(f"phase 19 (c) remove_outliers ({label}): kernel and plain masks differ")
        dropped = 1.0 - float(keep[False][0, -n_bl:].float().mean())
        kept = float(keep[False][0, :-n_bl].float().mean())
        print(f"  remove_outliers (k 16) on the {label} + {n_bl} planted points: "
              f"planted dropped {dropped:.4f} (bar {PS_BLOB_DROP}), the rest kept "
              f"{kept:.4f}" + (f" (bar {PS_CLEAN_KEEP})" if base is clean else ""))
        if dropped < PS_BLOB_DROP or (base is clean and kept < PS_CLEAN_KEEP):
            fail(f"phase 19 (c) remove_outliers ({label}): the known answer fails")
    rs_noise = torch.randn((1, PS_SCAN_POINTS // 2, 3), generator=g, device=dev)
    steps = (("(c) resample_uniformly", lambda: ops_points.resample_uniformly(
                 sub, sm, rs_noise)),
             ("(c) ear_lop_move", lambda: ops_points.ear_lop_move(sub, sn, sm)),
             ("(c) project_to_latent_surface",
              lambda: project_to_latent_surface(sub, sn, sm)))
    outs = {}
    for label, fn in steps:
        o = {}
        for plain in (False, True):
            o[plain], c, _, _, _ = run(label, fn, plain)
            if not plain:
                launched(label, c, ("knn",))
        ka = o[False][0] if isinstance(o[False], tuple) else o[False]
        pa = o[True][0] if isinstance(o[True], tuple) else o[True]
        err = float((ka - pa).abs().max())
        if err > 1e-6:
            fail(f"phase 19 {label}: kernels and plain versions differ by {err:.3g} "
                 f"(tol 1e-6: the kNN is bit-equal, the rest the same operations)")
        outs[label] = o[False]
    n_rs = int(outs["(c) resample_uniformly"][1].sum())
    med = lambda t: float(tsdf(t[0]).abs().median())
    m0, m1 = med(sub), med(outs["(c) project_to_latent_surface"])
    print(f"  resample_uniformly: {PS_SCAN_POINTS} -> WLOP {PS_SCAN_POINTS // 2} "
          f"-> {n_rs} points; median |torus_sdf|: scan {m0:.5f}, EAR move "
          f"{med(outs['(c) ear_lop_move']):.5f}, latent projection {m1:.5f}")
    if n_rs != PS_SCAN_POINTS or not m1 < m0:
        fail("phase 19 (c): the resample lost points or the latent projection did "
             "not move the scan toward the torus")

    # ---- (d) the DSS regularizers at knn_k 32 on phase 9's clouds
    for name in ("projection_loss", "repulsion_loss"):
        vals = {}
        for plain in (False, True):
            def step():
                xp = x.clone().requires_grad_(True)
                val = getattr(losses, name)(xp, xn, xm)
                return val.detach(), torch.autograd.grad(val, xp)[0]
            vals[plain], c, _, _, _ = run(f"(d) {name}", step, plain)
            if not plain:
                launched(name, c, ("knn",))
        (va, ga), (vb, gb) = vals[False], vals[True]
        g_err = float((ga - gb).abs().max()) / max(float(gb.abs().max()), 1e-30)
        print(f"  {name} (knn_k 32): kernels {float(va):.9g} plain {float(vb):.9g}; "
              f"gradient max err {g_err:.3g} of max |g| {float(gb.abs().max()):.4g}")
        if (abs(float(va) - float(vb)) > 1e-5 * abs(float(vb)) or g_err > 1e-5
                or not torch.isfinite(ga).all() or float(ga.abs().max()) == 0):
            fail(f"phase 19 (d) {name}: kernels and plain versions beyond rtol 1e-5")

    # ---- (e) phase 8's splat frame with the anisotropic Vrk
    ast = dataclasses.replace(scene.settings, Vrk_isotropic=False)
    a_scene = scene._replace(settings=ast)
    a_plain = dataclasses.replace(ast, use_pallas=False, use_pallas_backward=False)
    (loss_k, grad_k, gndc_k, fr_k), c, _, _, _ = run(
        "(e) anisotropic splat frame", lambda: bench.splat_step(a_scene))
    for name in ("knn", "splat_select", "splat_fine", "splat_zbuf_bwd", "occ_bwd"):
        if c[name] != 1:
            fail(f"phase 19 (e): {name} launched {c[name]} times (expected 1)")
    (loss_p, grad_p, gndc_p, fr_p), _, _, _, _ = run(
        "(e) anisotropic splat frame", lambda: bench.splat_step(a_scene, a_plain),
        plain=True)
    with torch.no_grad():
        sp_k = compute_splat_params(scene.points, scene.normals, scene.mask,
                                    scene.camera, ast)
        sp_p = compute_splat_params(scene.points, scene.normals, scene.mask,
                                    scene.camera, a_plain)
    for name in ("ellipse", "radii", "scaler", "mask"):
        if not torch.equal(getattr(sp_k, name), getattr(sp_p, name)):
            fail(f"phase 19 (e): splat {name} differs between the kNN kernel and "
                 f"its plain version")
    for name in ("idx", "zbuf", "occupancy", "visibility", "tile_overflow"):
        if not torch.equal(getattr(fr_k, name), getattr(fr_p, name)):
            fail(f"phase 19 (e): {name} differs between the kernels and the plain "
                 f"versions")
    q_err = float((fr_k.qvalue - fr_p.qvalue).detach().abs().max())
    xy = grad_check(gndc_k[..., :2], gndc_p[..., :2])
    gz_k, gz_p = gndc_k[..., 2], gndc_p[..., 2]
    z_rel = float(((gz_k - gz_p).abs() / gz_p.abs().clamp(min=1e-30))[gz_p != 0].max())
    wg = grad_check(grad_k, grad_p)
    ovf = int(fr_k.tile_overflow.sum())
    iso = bench.splat_step(scene)[3]
    print(f"  anisotropic frame: loss {float(loss_k):.9g} vs {float(loss_p):.9g}; "
          f"maps equal, qvalue err {q_err:.3g}; d/d pts_ndc xy {xy[0]}, z max rel "
          f"err {z_rel:.3g}; d/d points {wg[0]}; {int(fr_k.visibility.sum())} "
          f"visible splats (isotropic frame {int(iso.visibility.sum())}); tile "
          f"overflow {ovf}")
    if (q_err > 1e-6 or not xy[1] or z_rel > 1e-5 or not wg[1] or ovf
            or torch.equal(fr_k.idx, iso.idx)):
        fail("phase 19 (e): the anisotropic frame disagrees beyond phase 8's "
             "tolerances, overflowed, or equals the isotropic frame")
    n_sp = scene.points.shape[1]
    vis = visible_point_mask(fr_k.idx, n_sp)
    ref = torch.zeros((fr_k.idx.shape[0], n_sp + 1), dtype=torch.bool, device=dev)
    flat = fr_k.idx.reshape(ref.shape[0], -1)
    ref[torch.arange(ref.shape[0], device=dev)[:, None].expand_as(flat),
        torch.where(flat >= 0, flat, n_sp)] = True
    if not torch.equal(vis, ref[:, :n_sp]) or not torch.equal(vis, fr_k.visibility):
        fail("phase 19 (e): visible_point_mask differs from the plain scatter")
    pc = pmodel.cloud()
    tile = lambda t: t.detach().expand((pcam.batch_size,) + t.shape[1:])
    pc = PointCloud(points=tile(pc.points), mask=tile(pc.mask),
                    normals=tile(pc.normals), features=tile(pc.features))
    pst = pmodel.raster_settings
    rgba = {}
    for plain in (False, True):
        st = (dataclasses.replace(pst, use_pallas=False, use_pallas_backward=False)
              if plain else pst)
        rgba[plain], c, _, _, _ = run("(e) point model frame, unnormalised",
                                      lambda: render_pointcloud(
                                          pc, pcam, st, normalize_weights=False).rgba,
                                      plain)
        if not plain:
            launched("(e) point model frame", c, ("knn", "splat_select", "splat_fine"))
    r_err = float((rgba[False] - rgba[True]).abs().max())
    if (not torch.isfinite(rgba[False]).all() or float(rgba[False][..., :3].sum()) <= 0
            or r_err > 1e-5 * max(1.0, float(rgba[True].abs().max()))):
        fail(f"phase 19 (e): the unnormalised point model frame (err {r_err:.3g})")
    print(f"  visible_point_mask equal to the plain scatter and the frame's "
          f"visibility; point model frame with normalize_weights=False: rgb sum "
          f"{float(rgba[False][..., :3].sum()):.6g}, kernels vs plain max err {r_err:.3g}")

    # ---- (f) signed_distance_loss on phase 16's compound mesh
    mesh = read_ply(os.path.join(ROOT, "out", "torch_ablation", "data",
                                 "mesh_source.ply"))
    mv, mf = mesh["points"].astype(np.float32), mesh["faces"].astype(np.int64)
    sp_pts, sp_nrm = meshing.sample_points_from_mesh(mv, mf, PS_SDL_POINTS, seed=19)
    cell = 2.0 / 128
    xq = (sp_pts + sp_nrm * rng.uniform(-4 * cell, 4 * cell, (PS_SDL_POINTS, 1))
          ).astype(np.float32)
    f_true = compound_sdf()(torch.as_tensor(xq))

    def sdl(device, n):
        """The loss (mean) over the first n points and its gradients to the
        points and to sdf (the analytic compound SDF)."""
        p = torch.as_tensor(xq[:n], device=device).requires_grad_(True)
        s = f_true[:n].to(device).requires_grad_(True)
        val = losses.signed_distance_loss(p, s, torch.as_tensor(mv, device=device),
                                          torch.as_tensor(mf, device=device))
        gp, gs = torch.autograd.grad(val, (p, s))
        return val.detach().cpu(), gp.cpu(), gs.cpu()

    torch.cuda.synchronize()
    t = time.perf_counter()
    val_d, gp_d, _ = sdl(dev, PS_SDL_POINTS)
    torch.cuda.synchronize()
    sdl_s = time.perf_counter() - t
    card, t = sdl(dev, PS_SDL_CPU), time.perf_counter()
    cpu = sdl("cpu", PS_SDL_CPU)
    cpu_s = time.perf_counter() - t
    v_err = abs(float(card[0]) - float(cpu[0])) / abs(float(cpu[0]))
    g_errs = [float((a - b).abs().max()) / float(b.abs().max())
              for a, b in zip(card[1:], cpu[1:])]
    with torch.no_grad():
        sd = losses.mesh_signed_distance(torch.as_tensor(xq, device=dev),
                                         torch.as_tensor(mv, device=dev),
                                         torch.as_tensor(mf, device=dev)).cpu()
    far = f_true.abs() > cell
    agree = float((torch.sign(sd) == torch.sign(f_true))[far].float().mean())
    print(f"phase 19 (f): signed_distance_loss on the compound mesh ({len(mf):,} "
          f"faces) at {PS_SDL_POINTS} points within 4 cells of it: "
          f"{float(val_d):.6g}, {sdl_s:.3f} s with the gradient on the card; on "
          f"the first {PS_SDL_CPU} points card vs CPU ({cpu_s:.2f} s): the loss "
          f"{float(card[0]):.9g} vs {float(cpu[0]):.9g} (rel err {v_err:.3g}), "
          f"d/dpoints and d/dsdf max err {g_errs[0]:.3g} / {g_errs[1]:.3g} of their "
          f"max; sign equal to compound_sdf's on {agree:.5f} of the "
          f"{int(far.sum())} points past one 128³ cell (bar {PS_SIGN_BAR})")
    if (max([v_err] + g_errs) > 1e-5 or agree < PS_SIGN_BAR
            or not torch.isfinite(gp_d).all()):
        fail("phase 19 (f): the card against the CPU beyond rtol 1e-5, or the "
             "signs against compound_sdf below the bar")
    print(f"phase 19: {time.perf_counter() - t19:.1f} s")
    return {"rimls_shape": f"{x.shape[0]} x {x.shape[1]}, k=32, self-excluded",
            "rimls_ms": r_ms, "rimls_plain_ms": r_pms, "rimls_bound_ms": r_b[0],
            "rimls_bound_by": r_b[1], "k_max": 32}


# phase 20: the published IGR network (8x512, no encoding) on the wide
# instances of the MLP tile. (a)'s shapes are the trace path's rows'
# (phase 7): fused_igr on 262,144 and 524,288 points and, in f32, on 220,202
# (the f32 RMS check's); the coarse sampler at row 3b's 24,576 rays; the march
# at row 9's 170,394 rays x 3; SIREN 3x512 at rows 1, 1b, 3c and 9s's shapes
WIDE_POINTS = (262_144, 524_288)
WIDE_F32_POINTS = 220_202
WIDE_SAMPLER_RAYS = 24_576
WIDE_MARCH_RAYS, WIDE_MARCH_ITERS = 170_394, 3
WIDE_SIREN_POINTS = (3000, 262_144)
WIDE_SIREN_BF16_POINTS = 131_072
WIDE_SIREN_RAYS = 1024
WIDE_SIREN_MARCH_RAYS, WIDE_SIREN_MARCH_ITERS = 1640, 4
# widths that are not an instance's: padded to 384 (hidden, n_layers)
WIDE_ODD = ((300, 4), (288, 4))
WIDE_ABOVE = 544           # above the widest instance: refused
WIDE_ITERS = 44            # 40 warm-up steps, the resample at 40, 3 projected


def ptxas_spills(lib_path: str) -> list:
    """Each kernel's spill (stores + loads, bytes) from nvcc's -Xptxas -v
    log kept beside a library."""
    import re
    with open(lib_path + ".log") as f:
        log = f.read()
    return [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]


def ptxas_summary(lib_path: str) -> str:
    """The most registers a kernel of a library takes and its largest
    spill, from nvcc's -Xptxas -v log kept beside it."""
    import re
    with open(lib_path + ".log") as f:
        log = f.read()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = ptxas_spills(lib_path)
    serial = log.count("wgmma.mma_async instructions are serialized")
    return (f"{len(regs)} kernels, at most {max(regs, default=0)} registers a "
            f"thread, largest spill {max(spills, default=0)} bytes "
            f"({sum(1 for s in spills if s)} kernels spill); ptxas serialized the "
            f"wgmmas of {serial}")


def wide_rays(n: int, dev, seed: int):
    """(cam, dirs, t_lo, t_hi), n rays of bench.make_rays' fan over about
    [0.5, 3.5] (the unit sphere seen from (0, 0, -2) with a margin), flat
    and contiguous."""
    from isopoints_torch import bench
    cam, dirs, _ = bench.make_rays(n, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    t_lo = 0.5 + 0.1 * torch.rand(n, generator=g, device=dev)
    t_hi = 3.5 - 0.1 * torch.rand(n, generator=g, device=dev)
    return (cam.reshape(-1, 3).contiguous(), dirs.reshape(-1, 3).contiguous(),
            t_lo, t_hi)


def wide_kernels(dev, ifield, kernels, sfield=None, path_shapes=None) -> list:
    """Phase 20 (a): every wide kernel against its plain version at full
    width, on the IGR field `ifield` (8x512) and a seeded SIREN 3x512
    (`sfield`, made here when None); fused_igr also at widths that are
    not an instance's, and refused above the widest. `path_shapes`:
    (fused_igr's launches by (mode, output, points), the sampler's by
    (rays, steps, secant steps, coarse)) of phase 20 (b), whose most
    frequent shapes are timed too. Returns the rows of the kernels line
    (launches filled in by the caller)."""
    from isopoints_torch.models.fields import SDFField, SirenField
    from isopoints_torch.models.raytracing import RayTracingConfig, march_plain
    from isopoints_torch.ops import fused_mlp, fused_sampler
    from isopoints_torch.utils import fma, linspace01

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counts = lambda: {k.name: k.launches for k in kernels}
    gen = torch.Generator(device=dev).manual_seed(20)
    if sfield is None:
        sfield = SirenField(hidden_size=512, n_layers=3, generator=gen, device=dev)
    rows = []

    def pack_stats(pack):
        flops = 2.0 * sum(w.shape[0] * w.shape[1] for w in pack.ws)
        w_bytes = 4 * sum(w.numel() + b.numel() for w, b in zip(pack.ws, pack.bs))
        return flops, w_bytes

    def check_mlp(fine, coarse, n, bf16, with_grad, label, timed=True):
        """The fused callable (`coarse` in bf16) against the plain version
        on n points in [-1.2, 1.2]^3, by phase 7's bars; timed beside the
        plain version, the f32 cuBLAS chain (TF32 off) of the same work and
        the bound. Returns (err, ms, plain ms, cuBLAS ms, bound)."""
        pack = fine.pack
        plain, plain_g = fused_mlp._PLAIN[pack.kind], fused_mlp._PLAIN_GRAD[pack.kind]
        fn = coarse if bf16 else fine
        x = torch.rand((n, 3), generator=gen, device=dev) * 2.4 - 1.2
        run_k = (lambda: fn.sdf_and_grad(x)) if with_grad else (lambda: (fn(x),))
        run_p = ((lambda: plain_g(pack, x, bf16)) if with_grad
                 else (lambda: (plain(pack, x, bf16),)))
        run_c = ((lambda: plain_g(pack, x)) if with_grad
                 else (lambda: (plain(pack, x),)))
        out, ref = run_k(), run_p()
        errs = [float((a - b).abs().max()) for a, b in zip(out, ref)]
        if not all(torch.isfinite(a).all() for a in out):
            fail(f"phase 20 {label}: non-finite output")
        what = f"{label} {'bf16' if bf16 else 'f32'} {'value+grad' if with_grad else 'value'} n={n}"
        if bf16:
            own = run_c()
            own_err = [float((a - b).abs().max()) for a, b in zip(ref, own)]
            exact = (plain_g(pack, x, True, True) if with_grad
                     else (plain(pack, x, True, True),))
            share = lambda us, vs: min(float(((u - v).abs() <= 1e-5).float().mean())
                                       for u, v in zip(us, vs))
            near_k, near_p = share(out, exact), share(ref, exact)
            print(f"phase 20 {what}: max_abs_err {max(errs):.3g} (the mode's own "
                  f"error against f32 {max(own_err):.3g}); within 1e-5 of the exact "
                  f"sums on {near_k:.5f} (the plain version on {near_p:.5f}), of the "
                  f"plain version on {share(out, ref):.5f}")
            if any(e > o for e, o in zip(errs, own_err)) or near_k < min(0.99, near_p):
                fail(f"phase 20 {what}: errs {errs} (tol {own_err}), {near_k:.5f} "
                     f"within 1e-5 of the exact sums (tol 0.99 or {near_p:.5f})")
        else:
            g_tol = 1e-4 * max(1.0, float(ref[1].abs().max())) if with_grad else 0.0
            print(f"phase 20 {what}: value err {errs[0]:.3g} (tol {IGR_F32_TOL:g})"
                  + (f", grad err {errs[1]:.3g} (tol {g_tol:.3g})" if with_grad else ""))
            if errs[0] > IGR_F32_TOL or (with_grad and errs[1] > g_tol):
                fail(f"phase 20 {what}: errs {errs} (value tol {IGR_F32_TOL:g}, grad "
                     f"1e-4·max(1, |g|))")
        if not timed:
            return max(errs), None, None, None, None
        ms, plain_ms = time_ms(run_k), time_ms(run_p)
        cublas_ms = plain_ms if not bf16 else time_ms(run_c)
        flops, w_bytes = pack_stats(pack)
        flops *= n * (4 if with_grad else 1)
        b = bound_ms(flops if bf16 else 3 * flops,
                     n * (12 + (16 if with_grad else 4)) + w_bytes,
                     BF16_PEAK if bf16 else TF32_PEAK)
        print(f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  cuBLAS f32 chain "
              f"{cublas_ms:.4f} ms  bound {b[0]:.4f} ms ({b[1]}; kernel/bound "
              f"{ms / b[0]:.1f})")
        return max(errs), ms, plain_ms, cublas_ms, b

    def pick_shares(pack, args, n_sec, margin, out, ref):
        """The shares of rays whose picks (t_pick and t_min) equal those of
        the coarse sweep with exactly formed sums (`exact_sums`), for the
        kernel's outputs `out` and the plain version's `ref`. At 512 wide a
        bf16 sum in another order flips a bf16 rounding of the next operand
        on ~10% of the values (the plain version's own agreement with the
        exact sums above), and a pick moves where a step's value lies that
        close to -margin; phase 7's 99% of picks equal to the plain
        version's was set at 256 wide, so here the kernel's picks are held
        as its bf16 values are: equal to the exact sweep's on >= 99% of
        rays, or on as many as the plain version's are."""
        plain = fused_mlp._PLAIN[pack.kind]
        ref_x = fused_sampler.sweep_plain(
            lambda p: plain(pack, p, False, True), *args, n_sec, margin,
            chunk_rays=2048, sdf_fn_coarse=lambda p: plain(pack, p, True, True))
        return tuple(float(((o[0] == ref_x[0]) & (o[2] == ref_x[2])).float().mean())
                     for o in (out, ref))

    def rms_check(fine, p, label):
        """The f32 tile's RMS error against exactly summed values at most
        F32_EXACT_RATIO x cuBLAS's (phase 7)."""
        pack = fine.pack
        ex = fused_mlp._PLAIN[pack.kind](pack, p, False, True)
        stats = []
        for v in (fine(p), fused_mlp._PLAIN[pack.kind](pack, p)):
            e = (v - ex).abs()
            stats.append((float(e.square().mean().sqrt()), float(e.max())))
        ratio = stats[0][0] / stats[1][0]
        print(f"phase 20 f32 tile against exact sums on {label} ({p.shape[0]}): "
              f"tile RMS {stats[0][0]:.4g} (max {stats[0][1]:.4g}), cuBLAS RMS "
              f"{stats[1][0]:.4g} (max {stats[1][1]:.4g}), ratio {ratio:.4f} (bar "
              f"{F32_EXACT_RATIO})")
        if not ratio <= F32_EXACT_RATIO:
            fail(f"phase 20: the f32 tile's RMS error against exact sums on {label} "
                 f"is {ratio:.4f} x cuBLAS's (bar {F32_EXACT_RATIO})")
        return ratio

    def wide_row(name, source, replaces, err, ms, plain_ms, cublas_ms, b, shape):
        return row(name, source, replaces, 0, err, ms, plain_ms, b,
                   cublas_ms=cublas_ms, shape=shape)

    # ---- IGR 8x512: fused_igr in both modes
    fine = fused_mlp.make_fused_igr_sdf(ifield)
    coarse = fused_mlp.make_fused_igr_sdf(ifield, "bf16")
    ipack = fine.pack
    ih = ipack.arch_args()[0]
    print(f"phase 20 (a): IGR {ipack.n_layers - 1}x{ipack.hidden} (skip {ipack.skip_in}, "
          f"tanh {ipack.final_tanh}) on the {ih}-wide instance; tolerances as phase 7: "
          f"f32 value {IGR_F32_TOL:g}, grad 1e-4·max(1, |g|); bf16 within the mode's own "
          f"error against f32 and within 1e-5 of the exact sums on >= 99% or as many "
          f"as the plain version")
    res = {}
    for n in WIDE_POINTS:
        for bf16 in (False, True):
            for grad in (False, True):
                res[(n, bf16, grad)] = check_mlp(fine, coarse, n, bf16, grad, "fused_igr")
    res[(WIDE_F32_POINTS, False, False)] = check_mlp(fine, coarse, WIDE_F32_POINTS,
                                                     False, False, "fused_igr")
    rms_check(fine, torch.rand((WIDE_F32_POINTS, 3), generator=gen, device=dev) * 2.4 - 1.2,
              f"{WIDE_F32_POINTS} points in [-1.2, 1.2]^3")
    err, ms, pms, cms, b = res[(WIDE_POINTS[-1], True, False)]
    rows.append(wide_row("fused_igr_wide", "isopoints_torch/csrc/fused_igr.cu",
                         "isopoints_tpu/ops/pallas_mlp.py:417", err, ms, pms, cms, b,
                         f"IGR 8x512 bf16 value, {WIDE_POINTS[-1]:,} points"))
    err, ms, pms, cms, b = res[(WIDE_F32_POINTS, False, False)]
    shape_keys = {"f32_value_524288": (WIDE_POINTS[-1], False, False),
                  "f32_value_grad_524288": (WIDE_POINTS[-1], False, True)}
    rows.append(wide_row("fused_igr_wide_f32", "isopoints_torch/csrc/fused_igr.cu",
                         "isopoints_tpu/ops/pallas_mlp.py:417", err, ms, pms, cms, b,
                         f"IGR 8x512 f32 value, {WIDE_F32_POINTS:,} points")
                | {k: {"ms": res[key][1], "cublas_ms": res[key][3], "bound_ms": res[key][4][0]}
                   for k, key in shape_keys.items()})
    for n in (WIDE_F32_POINTS, WIDE_POINTS[-1]):
        _, k_ms, _, c_ms, _ = res[(n, False, False)]
        print(f"phase 20: fused_igr f32 value at {n:,} points {k_ms:.4f} ms against the f32 "
              f"cuBLAS F.linear chain's {c_ms:.4f} ms (kernel/cuBLAS {k_ms / c_ms:.3f})")

    # ---- fused_igr at phase 20 (b)'s most frequent shapes
    igr_shapes, sampler_shapes = path_shapes or ({}, {})
    for (m, what, n), c in sorted(igr_shapes.items(), key=lambda kv: -kv[1])[:4]:
        x = torch.rand((n, 3), generator=gen, device=dev) * 2.4 - 1.2
        fn = coarse if m == "bf16" else fine
        grad = what == "value+grad"
        run = (lambda: fn.sdf_and_grad(x)) if grad else (lambda: fn(x))
        chain = ((lambda: fused_mlp.igr_sdf_and_grad_plain(ipack, x)) if grad
                 else (lambda: fused_mlp.igr_sdf_plain(ipack, x)))
        flops = 2.0 * sum(w.shape[0] * w.shape[1] for w in ipack.ws) * n * (4 if grad else 1)
        b = bound_ms(flops if m == "bf16" else 3 * flops, n * (12 + (16 if grad else 4)),
                     BF16_PEAK if m == "bf16" else TF32_PEAK)
        print(f"phase 20 (a) at (b)'s shape: fused_igr {m} {what} n={n} ({c} launches in "
              f"(b)): kernel {time_ms(run):.4f} ms, f32 cuBLAS chain {time_ms(chain):.4f} ms, "
              f"bound {b[0]:.4f} ms")

    # ---- the coarse IGR sampler at row 3b's shape
    igr_flops, igr_w_bytes = pack_stats(ipack)
    plain_fine = fused_mlp.PlainSDF(ipack)
    plain_coarse = fused_mlp.PlainSDF(ipack, "bf16")
    cam, d, t_lo, t_hi = wide_rays(WIDE_SAMPLER_RAYS, dev, 20)
    s_args = (cam, d, t_lo, t_hi, linspace01(100, dev))
    n_sec, margin = 8, 2e-3
    s_kw = dict(n_secant=n_sec, margin=margin, coarse_sweep=True)
    before = counts()["fused_sampler"]
    out = fine.fused_ray_sampler(*s_args, **s_kw)
    torch.cuda.synchronize()
    if counts()["fused_sampler"] != before + 1:
        fail("phase 20: the wide IGR sampler did not launch its kernel once")
    ref_f = fused_sampler.sweep_plain(fine, *s_args, n_sec, margin, sdf_fn_coarse=coarse)
    ref = fused_sampler.sweep_plain(plain_fine, *s_args, n_sec, margin,
                                    sdf_fn_coarse=plain_coarse)
    s_exact = all(torch.equal(a, b) for a, b in zip(out, ref_f))
    same = (out[0] == ref[0]) & (out[2] == ref[2])
    s_frac = float(same.float().mean())
    s_ferr = float((out[1] - ref[1])[same].abs().max())
    picks_k, picks_p = pick_shares(ipack, s_args, n_sec, margin, out, ref)
    hit = same & (ref[1] < 0)
    dz = (out[3] - ref[3]).abs()
    _, gz = fused_mlp.igr_sdf_and_grad_plain(ipack, fma(ref[3][:, None], d, cam))
    slope = (gz * d).sum(-1).abs()
    ok_z = lambda z: ((z - ref[3]).abs() <= 1e-4) | ((z - ref[3]).abs() * slope <= IGR_F32_TOL)
    z_cond = float(ok_z(out[3])[hit].float().mean())
    z_near = float((dz <= 1e-4)[hit].float().mean())
    ctl = coarse.fused_ray_sampler(*s_args, **s_kw)
    ctl_hit = hit & (ctl[0] == ref[0])
    ctl_cond = float(ok_z(ctl[3])[ctl_hit].float().mean())
    print(f"phase 20 fused_sampler (IGR 8x512, coarse sweep) {WIDE_SAMPLER_RAYS} rays x "
          f"100 steps + 2 + {n_sec} secant, margin {margin}: all four outputs equal to "
          f"sweep_plain over the fused callables: {s_exact}; against the plain version: "
          f"picks equal on {s_frac:.5f}, f_pick err {s_ferr:.3g}, z_secant within 1e-4 "
          f"or {IGR_F32_TOL:g} / slope on {z_cond:.5f} of {int(hit.sum())} crossing rays "
          f"(the bf16 fine field: {ctl_cond:.5f}), within 1e-4 on {z_near:.5f}; picks "
          f"equal to the exactly summed sweep's on {picks_k:.5f} (the plain version's "
          f"on {picks_p:.5f})")
    if not s_exact:
        fail("phase 20: the wide IGR sampler differs from sweep_plain over the fused callables")
    if (int(hit.sum()) < 100 or picks_k < min(0.99, picks_p) or s_ferr > 1e-5
            or z_cond < 0.999):
        fail("phase 20: the wide IGR sampler disagrees with its plain version beyond "
             "phase 7's bars (the picks held to the exactly summed sweep)")
    if ctl_cond >= 0.999:
        fail(f"phase 20: the conditioned z_secant bar passes the sampler with a bf16 "
             f"fine field ({ctl_cond:.5f})")
    fine_pts = []

    def recording_fine(p):
        fine_pts.append(p.reshape(-1, 3).clone())
        return fine(p)
    fused_sampler.sweep_plain(recording_fine, *s_args, n_sec, margin, sdf_fn_coarse=coarse)
    rms_check(fine, torch.cat(fine_pts), "the sampler's fine points")
    s_ms = time_ms(lambda: fine.fused_ray_sampler(*s_args, **s_kw))
    s_pms = time_ms(lambda: fused_sampler.sweep_plain(plain_fine, *s_args, n_sec, margin,
                                                      sdf_fn_coarse=plain_coarse))
    s_b = (1e3 * max(igr_flops * WIDE_SAMPLER_RAYS * 100 / BF16_PEAK
                     + 3 * igr_flops * WIDE_SAMPLER_RAYS * (2 + n_sec) / TF32_PEAK,
                     (WIDE_SAMPLER_RAYS * 48 + 400 + 2 * igr_w_bytes) / HBM_RATE),
           "operations")
    print(f"  kernel {s_ms:.3f} ms  plain {s_pms:.3f} ms  bound {s_b[0]:.4f} ms "
          f"(kernel/bound {s_ms / s_b[0]:.1f})")
    for (nr, n_st, n_sc, crs), c in sorted(sampler_shapes.items(), key=lambda kv: -kv[1])[:2]:
        b_args = wide_rays(nr, dev, 24) + (linspace01(n_st, dev),)
        b_kw = dict(n_secant=n_sc, margin=margin if crs else 0.0, coarse_sweep=crs)
        b_ms = time_ms(lambda: fine.fused_ray_sampler(*b_args, **b_kw))
        b_b = 1e3 * (igr_flops * nr * n_st / (BF16_PEAK if crs else TF32_PEAK / 3)
                     + 3 * igr_flops * nr * (n_sc + 2 * crs) / TF32_PEAK)
        print(f"phase 20 (a) at (b)'s shape: fused_sampler {nr} rays x {n_st} steps + "
              f"{2 * crs} + {n_sc} ({'coarse' if crs else 'fine'} sweep; {c} launches in "
              f"(b)): kernel {b_ms:.3f} ms, bound {b_b:.4f} ms")
    rows.append(wide_row("fused_sampler_igr_wide", "isopoints_torch/csrc/fused_sampler.cu",
                         "isopoints_tpu/ops/pallas_sampler.py:52", max(s_ferr, float(dz[hit].max())),
                         s_ms, s_pms, s_pms, s_b,
                         f"IGR 8x512 coarse sweep, {WIDE_SAMPLER_RAYS:,} rays x 100 + 2 + 8"))

    # ---- the march at row 9's shape
    rcfg = RayTracingConfig()
    m_rays = wide_rays(WIDE_MARCH_RAYS, dev, 21)

    def march_state(fn, cam, d, t_lo, t_hi):
        n = t_lo.shape[0]
        f_s, f_e = fn(fma(t_lo[:, None], d, cam)), fn(fma(t_hi[:, None], d, cam))
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        zi = torch.zeros(n, dtype=torch.int32, device=dev)
        zf = torch.zeros(n, device=dev)
        return [t_lo.clone(), t_hi.clone(), f_s, f_e, ones, ones.clone(), zi, zi.clone(),
                zf, zf.clone()]

    def check_march(fine, plain, rays, n_it, label):
        cam, d = rays[0], rays[1]
        st = march_state(fine, *rays)
        m_args = (cam, d, st, n_it, rcfg.sdf_threshold, rcfg.line_search_step,
                  rcfg.line_step_iters, True)
        before = counts()["trace_march"]
        m_out = fine.fused_trace_stepper(*m_args)
        torch.cuda.synchronize()
        if counts()["trace_march"] != before + 1:
            fail(f"phase 20: the {label} march did not launch its kernel once")
        m_loop = march_plain(fine, *m_args)
        m_ref = march_plain(plain, *m_args)
        m_exact = all(torch.equal(a, b) for a, b in zip(m_out, m_loop))
        m_eq = min(float((a == b).float().mean()) for a, b in zip(m_out[4:8], m_ref[4:8]))
        m_close = min(float(((a - b).abs() <= 1e-5).float().mean())
                      for a, b in zip(m_out[:2], m_ref[:2]))
        m_err = max(float((a - b).abs().max()) for a, b in zip(m_out[:2], m_ref[:2]))
        moved = float((m_out[0] != st[0]).float().mean())
        print(f"phase 20 trace_march ({label}) {rays[0].shape[0]} rays x {n_it} "
              f"iterations ({moved:.3f} of the start fronts moved): all ten state arrays "
              f"equal to march_plain over the fused f32 callable: {m_exact}; against "
              f"the plain version: masks/bk equal on {m_eq:.6f}, depths within 1e-5 on "
              f"{m_close:.6f} (max diff {m_err:.3g})")
        if not m_exact:
            fail(f"phase 20: the {label} march differs from march_plain over the fused callable")
        if m_eq < 0.999 or m_close < 0.999:
            fail(f"phase 20: the {label} march disagrees with its plain version")
        ms = time_ms(lambda: fine.fused_trace_stepper(*m_args))
        pms = time_ms(lambda: march_plain(plain, *m_args))
        flops, w_bytes = pack_stats(fine.pack)
        n = rays[0].shape[0]
        b = bound_ms(3 * flops * 2 * n_it * n, n * (24 + 2 * 34) + w_bytes, TF32_PEAK)
        print(f"  kernel {ms:.3f} ms  plain {pms:.3f} ms  bound {b[0]:.4f} ms "
              f"(kernel/bound {ms / b[0]:.1f})")
        return m_err, ms, pms, b

    err, ms, pms, b = check_march(fine, plain_fine, m_rays, WIDE_MARCH_ITERS, "IGR 8x512")
    rows.append(wide_row("trace_march_wide", "isopoints_torch/csrc/fused_trace.cu",
                         "isopoints_tpu/ops/pallas_trace.py:43", err, ms, pms, pms, b,
                         f"IGR 8x512 f32, {WIDE_MARCH_RAYS:,} rays x {WIDE_MARCH_ITERS}"))

    # ---- SIREN 3x512: fused_mlp, the sampler, the march
    sfine = fused_mlp.make_fused_siren_sdf(sfield)
    scoarse = fused_mlp.make_fused_siren_sdf(sfield, "bf16")
    spack = sfine.pack
    print(f"phase 20 (a): SIREN {spack.n_hidden}x{spack.hidden} on the "
          f"{spack.arch_args()[0]}-wide instance")
    s_res = {n: check_mlp(sfine, scoarse, n, False, True, "fused_mlp SIREN")
             for n in WIDE_SIREN_POINTS}
    sb = check_mlp(sfine, scoarse, WIDE_SIREN_BF16_POINTS, True, False, "fused_mlp SIREN")
    err, ms, pms, cms, b = s_res[WIDE_SIREN_POINTS[0]]
    rows.append(wide_row("fused_mlp_wide", "isopoints_torch/csrc/fused_mlp.cu",
                         "isopoints_tpu/ops/pallas_mlp.py:250", err, ms, pms, cms, b,
                         f"SIREN 3x512 f32 value+grad, {WIDE_SIREN_POINTS[0]} points")
                | {"bf16_value_131072": {k: v for k, v in zip(
                    ("max_abs_err", "ms", "plain_ms", "cublas_ms"), sb[:4])}
                   | {"bound_ms": sb[4][0]},
                   "f32_value_grad_262144": {k: v for k, v in zip(
                       ("max_abs_err", "ms", "plain_ms", "cublas_ms"),
                       s_res[WIDE_SIREN_POINTS[1]][:4])}
                   | {"bound_ms": s_res[WIDE_SIREN_POINTS[1]][4][0]}})
    s_flops, s_w_bytes = pack_stats(spack)
    splain, splain_c = fused_mlp.PlainSDF(spack), fused_mlp.PlainSDF(spack, "bf16")
    cam, d, t_lo, t_hi = wide_rays(WIDE_SIREN_RAYS, dev, 22)
    ss_args = (cam, d, t_lo, t_hi, linspace01(100, dev))
    out = sfine.fused_ray_sampler(*ss_args, **s_kw)
    ref_f = fused_sampler.sweep_plain(sfine, *ss_args, n_sec, margin, sdf_fn_coarse=scoarse)
    ref = fused_sampler.sweep_plain(splain, *ss_args, n_sec, margin, sdf_fn_coarse=splain_c)
    ss_exact = all(torch.equal(a, b) for a, b in zip(out, ref_f))
    same = (out[0] == ref[0]) & (out[2] == ref[2])
    ss_frac = float(same.float().mean())
    ss_ferr = float((out[1] - ref[1])[same].abs().max())
    spicks_k, spicks_p = pick_shares(spack, ss_args, n_sec, margin, out, ref)
    # rays whose picked bracket holds a root of the plain fine field (phase 10)
    ts = fma(ss_args[4], (t_hi - t_lo)[:, None], t_lo[:, None])
    idx = torch.argmax((ts == ref[0][:, None]).int(), dim=-1)
    z_low = torch.gather(ts, 1, (idx - 1).clamp(min=0)[:, None])[:, 0]
    hit = same & (ref[1] < 0) & (splain(fma(z_low[:, None], d, cam)) > 0)
    dz = (out[3] - ref[3]).abs()
    _, gz = splain.sdf_and_grad(fma(ref[3][:, None], d, cam))
    slope = (gz * d).sum(-1).abs()
    ss_cond = float(((dz <= 1e-4) | (dz * slope <= IGR_F32_TOL))[hit].float().mean())
    print(f"phase 20 fused_sampler (SIREN 3x512, coarse sweep) {WIDE_SIREN_RAYS} rays x 100 "
          f"+ 2 + {n_sec}: equal to sweep_plain over the fused callables: {ss_exact}; "
          f"against the plain version: picks equal on {ss_frac:.5f}, f_pick err "
          f"{ss_ferr:.3g}, z_secant within 1e-4 or {IGR_F32_TOL:g} / slope on "
          f"{ss_cond:.5f} of the {int(hit.sum())} crossing rays whose bracket holds "
          f"the root; picks equal to the exactly summed sweep's on {spicks_k:.5f} (the "
          f"plain version's on {spicks_p:.5f})")
    if not ss_exact:
        fail("phase 20: the wide SIREN sampler differs from sweep_plain over the fused callables")
    if (int(hit.sum()) < 100 or spicks_k < min(0.99, spicks_p) or ss_ferr > 1e-5
            or ss_cond < 0.999):
        fail("phase 20: the wide SIREN sampler disagrees with its plain version beyond "
             "phase 10's bars")
    ss_ms = time_ms(lambda: sfine.fused_ray_sampler(*ss_args, **s_kw))
    ss_pms = time_ms(lambda: fused_sampler.sweep_plain(splain, *ss_args, n_sec, margin,
                                                       sdf_fn_coarse=splain_c))
    ss_b = (1e3 * max(s_flops * WIDE_SIREN_RAYS * 100 / BF16_PEAK
                      + 3 * s_flops * WIDE_SIREN_RAYS * (2 + n_sec) / TF32_PEAK,
                      (WIDE_SIREN_RAYS * 48 + 400 + 2 * s_w_bytes) / HBM_RATE),
            "operations")
    print(f"  kernel {ss_ms:.3f} ms  plain {ss_pms:.3f} ms  bound {ss_b[0]:.4f} ms "
          f"(kernel/bound {ss_ms / ss_b[0]:.1f})")
    rows.append(wide_row("fused_sampler_siren_wide", "isopoints_torch/csrc/fused_sampler.cu",
                         "isopoints_tpu/ops/pallas_sampler.py:52",
                         max(ss_ferr, float(dz[hit].max())), ss_ms, ss_pms, ss_pms, ss_b,
                         f"SIREN 3x512 coarse sweep, {WIDE_SIREN_RAYS} rays x 100 + 2 + 8"))
    err, ms, pms, b = check_march(sfine, splain, wide_rays(WIDE_SIREN_MARCH_RAYS, dev, 23),
                                  WIDE_SIREN_MARCH_ITERS, "SIREN 3x512")
    rows.append(wide_row("trace_march_siren_wide", "isopoints_torch/csrc/fused_trace.cu",
                         "isopoints_tpu/ops/pallas_trace.py:43", err, ms, pms, pms, b,
                         f"SIREN 3x512 f32, {WIDE_SIREN_MARCH_RAYS} rays x "
                         f"{WIDE_SIREN_MARCH_ITERS}"))

    # ---- widths that are not an instance's, padded to the next; refused above
    for hidden, n_layers in WIDE_ODD:
        f = SDFField(hidden_size=hidden, n_layers=n_layers, num_frequencies=0,
                     generator=gen, device=dev)
        of, oc = fused_mlp.make_fused_igr_sdf(f), fused_mlp.make_fused_igr_sdf(f, "bf16")
        print(f"phase 20 (a): IGR {n_layers}x{hidden} (skip {f.skip_in}) padded to "
              f"the {of.pack.arch_args()[0]}-wide instance")
        for bf16 in (False, True):
            check_mlp(of, oc, 65_536, bf16, True, f"fused_igr {hidden}", timed=False)
        o_args = wide_rays(4096, dev, hidden) + (linspace01(100, dev),)
        o_out = of.fused_ray_sampler(*o_args, **s_kw)
        o_ref = fused_sampler.sweep_plain(of, *o_args, n_sec, margin, sdf_fn_coarse=oc)
        if not all(torch.equal(a, b) for a, b in zip(o_out, o_ref)):
            fail(f"phase 20: the sampler at width {hidden} differs from sweep_plain over "
                 f"the fused callables")
        print(f"  the coarse sampler at width {hidden} (4096 rays) equals sweep_plain "
              f"over the fused callables: True")
    big = SDFField(hidden_size=WIDE_ABOVE, n_layers=2, num_frequencies=0, generator=gen,
                   device=dev)
    before = counts()
    try:
        fused_mlp.make_fused_igr_sdf(big)(torch.zeros((8, 3), device=dev))
        fail(f"phase 20: a field of width {WIDE_ABOVE} ran on the CUDA kernels")
    except ValueError as e:
        print(f"phase 20: width {WIDE_ABOVE} refused on a CUDA tensor: {e}")
    if counts() != before:
        fail(f"phase 20: the refused width launched a kernel")
    return rows


def igr_wide_phase(dev, kernels) -> list:
    """Phase 20: the published IGR network (8x512 without encoding) through
    isopoints_torch/configs/igr_mvr_dir.yml, then each wide kernel against
    its plain version (see the module docstring). Returns the wide rows of
    the kernels line with their launches in (b)."""
    from isopoints_torch import create_mvr_data, train_mvr
    from isopoints_torch.factories import create_model
    from isopoints_torch.misc.metrics import load_metrics
    from isopoints_torch.ops import fused_mlp, fused_sampler, knn
    from isopoints_torch.training import trainer as trainer_mod
    from isopoints_torch.training.trainer import compute_loss

    t20 = time.perf_counter()
    counts = lambda: {k.name: k.launches for k in kernels}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg_path = os.path.join("isopoints_torch", "configs", "igr_mvr_dir.yml")
    data_dir = os.path.join("out", "torch_data_dtu_torus")   # the config's
    if not os.path.exists(os.path.join(data_dir, "cameras.npz")):
        create_mvr_data.main(["torus", data_dir, "--dtu", "--image-size", "512",
                              "--n-views", "8"])
    # ---- (b) train_mvr on the config: every step with its counters set to 0
    # just before and read just after, fused_igr's launches by mode and shape
    rec = {"ms": {}, "launches": {}}
    shapes, s_shapes = collections.Counter(), collections.Counter()
    step_fn = trainer_mod.MVRTrainer.train_step
    igr_cuda = fused_mlp.igr_forward_cuda
    sweep_cuda = fused_sampler.sweep_cuda

    def rec_step(self, state, *args, **kw):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(self, state, *args, **kw)
        torch.cuda.synchronize()
        rec["ms"][state.it] = 1e3 * (time.perf_counter() - t)
        rec["launches"][state.it] = counts()
        return out

    def rec_igr(pack, x, with_grad, bf16=False):
        shapes[("bf16" if bf16 else "f32", "value+grad" if with_grad else "value",
                x.shape[0])] += 1
        return igr_cuda(pack, x, with_grad, bf16)

    def rec_sweep(pack, cam, dirs, t_lo, t_hi, steps, n_secant, margin, coarse_sweep=False,
                  fine_bf16=False):
        s_shapes[(dirs.shape[0], steps.shape[0], int(n_secant), bool(coarse_sweep))] += 1
        return sweep_cuda(pack, cam, dirs, t_lo, t_hi, steps, n_secant, margin, coarse_sweep,
                          fine_bf16)

    out_dir = os.path.join("out", "torch_igr_mvr_dir")
    shutil.rmtree(out_dir, ignore_errors=True)
    with plain_calls() as pc, patched((trainer_mod.MVRTrainer, "train_step", rec_step),
                                      (fused_mlp, "igr_forward_cuda", rec_igr),
                                      (fused_sampler, "sweep_cuda", rec_sweep)):
        t = time.perf_counter()
        run = train_mvr.main([cfg_path, "--out-dir", out_dir, "--max-iters",
                              str(WIDE_ITERS), "--print-every", "1000",
                              "--validate-every", "1000", "--checkpoint-every", "1000"])
        wall = time.perf_counter() - t
    cfg, trainer, state = run.cfg, run.trainer, run.state
    model = trainer.model
    warm = trainer.cfg.warm_up_iters
    width = (cfg.model.decoder_kwargs.hidden_size, cfg.model.decoder_kwargs.n_layers,
             model.decoder.num_frequencies, tuple(model.decoder.skip_in),
             cfg.training.n_rays, model.ccfg.max_iso_per_batch,
             cfg.renderer.raster_params.image_size, warm)
    if width != (512, 8, 0, (4,), 2048, 4000, 512, 40):
        fail(f"igr_mvr_dir.yml: not the config's width (hidden, layers, frequencies, "
             f"skip, rays, visible, raster, warm-up) {width}")
    mlp_plain = {k: v for k, v in pc.items() if k.startswith("mlp")}
    if mlp_plain:
        fail(f"igr_mvr_dir.yml: plain MLP versions ran on the kernel route: {dict(pc)}")
    total = collections.Counter()
    for lc in rec["launches"].values():
        total.update(lc)
    modes = {m for m, _, _ in shapes}
    for name in ("fused_igr", "fused_sampler", "knn", "splat_select", "splat_fine"):
        if total[name] <= 0:
            fail(f"igr_mvr_dir.yml: kernel {name} was not launched: {dict(total)}")
    if modes != {"f32", "bf16"}:
        fail(f"igr_mvr_dir.yml: fused_igr launched in modes {modes}, not both")
    for it, lc in sorted(rec["launches"].items()):
        if it > warm and any(lc[k] <= 0 for k in ("fused_igr", "knn", "splat_select",
                                                    "splat_fine")):
            fail(f"igr_mvr_dir.yml: projected step {it} launched {lc}")
    if sum(shapes.values()) != total["fused_igr"]:
        fail(f"igr_mvr_dir.yml: fused_igr's launches by shape {dict(shapes)} do not add "
             f"up to its counter {total['fused_igr']}")
    ms = rec["ms"]
    w_ms = [ms[i] for i in range(1, warm)]
    p_ms = [ms[i] for i in range(warm + 1, WIDE_ITERS)]
    keys = ("loss", "loss_rgb", "loss_freespace", "loss_occupied", "loss_eikonal")
    train_rows = [r for r in load_metrics(os.path.join(out_dir, "metrics.jsonl"))
                  if "loss" in r]
    if [r["it"] for r in train_rows] != list(range(WIDE_ITERS)) or not all(
            math.isfinite(r[k]) for r in train_rows for k in keys):
        fail(f"igr_mvr_dir.yml: training rows {train_rows}")
    print(f"phase 20 (b): igr_mvr_dir.yml (configs/dtu_mvr.yml without encoding: IGR "
          f"8x512, skip at 4, neural texture; 2048 rays, 4000 of 8000 iso-points, "
          f"512-px rasters) on {data_dir}: {WIDE_ITERS} iterations in {wall:.2f} s; "
          f"plain calls beside the kernels {dict(pc) or 'none'}")
    print(f"  steps (ms): the first {ms[0]:.2f}; warm-up its 1-{warm - 1} median "
          f"{statistics.median(w_ms):.2f} (min {min(w_ms):.2f}, max {max(w_ms):.2f}); "
          f"resample step at its {warm} {ms[warm]:.2f}; projected "
          + ", ".join(f"{v:.2f}" for v in p_ms) + f" (median {statistics.median(p_ms):.2f})")
    print("  launches by step (its 0, 1 and from the resample on): " + "; ".join(
        f"{it}: " + ", ".join(f"{k} {v}" for k, v in lc.items() if v)
        for it, lc in sorted(rec["launches"].items()) if it < 2 or it >= warm))
    print(f"  launches in the run by kernel: {dict(total)}")
    print(f"  losses (its 0, {warm - 1} and from the resample on): " + "; ".join(
        f"{r['it']}: " + " ".join(f"{k}={r[k]:.6g}" for k in keys + ("n_iso",))
        for r in train_rows if r["it"] in (0, warm - 1) or r["it"] >= warm)
          + f"; overflow (trace, sampler) summed "
          f"{sum(r['overflow_trace'] for r in train_rows)}, "
          f"{sum(r['overflow_sampler'] for r in train_rows)}")
    print("  fused_igr by mode and shape: " + ", ".join(
        f"{c} x {m} {w} n={n}" for (m, w, n), c in shapes.most_common()))
    print("  fused_sampler by shape (rays, steps, secant, coarse): " + ", ".join(
        f"{c} x {k}" for k, c in s_shapes.most_common()))

    # one projected step under the profiler: the device's busy share
    it = state.it
    batch = run.views(train_mvr.draw_views(0, it, 8))
    torch.cuda.synchronize()
    t = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, _ = trainer.train_step(state, *batch)
        torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t)
    dev_ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3
    by_name = collections.Counter()
    for e in dev_ev:
        by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3
    print(f"  a projected step (its {it}) profiled: {step_ms:.2f} ms wall, device "
          f"{busy:.2f} ms ({100 * busy / step_ms:.1f}% busy); largest kernels: "
          + "; ".join(f"{n} {v:.2f} ms" for n, v in by_name.most_common(6)))

    # the same projected step's terms with the kernels and with every plain
    # version on identical draws (phase 4's bars)
    it = state.it
    img, mask, cam = run.views(train_mvr.draw_views(0, it, 8))
    step = trainer.step_fn(True, trainer.scheduler.at(it)["n_rays"])
    draws = trainer.draw(step.n_rays, tuple(img.shape[1:3]), img.shape[0],
                         n_points=state.points.shape[1], n_eikonal=step.n_eikonal)
    hp = {k: float(v) for k, v in trainer.scheduler.at(it).items()
          if k in ("lambda_rgb", "lambda_freespace", "lambda_occupied", "sdf_alpha")}
    hp["lambda_eikonal"] = trainer.cfg.lambda_eikonal
    plain_model = create_model(cfg, device=dev)
    plain_model.load_state_dict(model.state_dict())
    plain_model.cfg = dataclasses.replace(model.cfg, use_fused_mlp=False)
    plain_model.raster_settings = dataclasses.replace(model.raster_settings,
                                                      use_pallas=False)
    plain_model.trace_sdf_fn = lambda: fused_mlp.PlainSDF(
        fused_mlp.IgrPack(plain_model.decoder))
    plain_model.trace_sdf_fn_coarse = lambda: fused_mlp.PlainSDF(
        fused_mlp.IgrPack(plain_model.decoder), "bf16")
    res, cmp_launches = {}, {}
    for name, m in (("kernels", model), ("plain", plain_model)):
        before = counts()
        with patched(*(((knn, "knn_points_cuda", knn.knn_points_dense),)
                       if name == "plain" else ())):
            _, met, _, _, _ = compute_loss(
                m, state.points, state.points_mask, draws.pixels, img, mask, cam,
                draws.eikonal, draws.u_minsdf, hp, project=True,
                proj_draws=draws.projected, spacing=state.spacing)
        res[name] = {k: float(v.detach()) for k, v in met.items()}
        cmp_launches[name] = {k: v - before[k] for k, v in counts().items() if v - before[k]}
    cap = model.ccfg.max_iso_per_batch
    gap = max(abs(res["kernels"][k] - res["plain"][k]) / max(abs(res["plain"][k]), 1e-12)
              for k in keys)
    print(f"  a projected step (its {it}) with the kernels and with the plain versions "
          f"on identical draws: {res}; launches {cmp_launches}; largest relative gap of "
          f"the terms {gap:.3g} (rtol 1e-2), iso-points {res['kernels']['n_iso']:.0f} / "
          f"{res['plain']['n_iso']:.0f} (within 0.5% of {cap})")
    if abs(res["kernels"]["n_iso"] - res["plain"]["n_iso"]) > 0.005 * cap:
        fail("igr_mvr_dir.yml: iso-point counts of the kernel and plain paths differ by > 0.5%")
    for k in keys:
        a, b = res["kernels"][k], res["plain"][k]
        if not (math.isfinite(a) and abs(a - b) <= 1e-2 * abs(b) + 1e-6):
            fail(f"igr_mvr_dir.yml {k}: kernel path {a} vs plain path {b} (rtol 1e-2)")
    if cmp_launches["plain"] or not all(cmp_launches["kernels"].get(k, 0) > 0
                                        for k in ("fused_igr", "knn", "splat_select",
                                                  "splat_fine")):
        fail(f"igr_mvr_dir.yml: launches of the comparison {cmp_launches}")
    print(f"phase 20 (b): {time.perf_counter() - t20:.1f} s")

    # ---- (a) the wide kernels on the trained field
    rows = wide_kernels(dev, model.decoder, kernels, path_shapes=(shapes, s_shapes))
    # launches in (b) by row: fused_igr's by mode; the sampler that ran is
    # the IGR field's, and no SIREN kernel runs on this path
    by_row = {"fused_igr_wide": sum(c for (m, _, _), c in shapes.items() if m == "bf16"),
              "fused_igr_wide_f32": sum(c for (m, _, _), c in shapes.items() if m == "f32"),
              "fused_sampler_siren_wide": 0}
    for r in rows:
        r["launches"] = by_row.get(r["name"], total[kernel_of(r["source"])])
    print(f"phase 20: {time.perf_counter() - t20:.1f} s")
    return rows


# phase 21 (a): the certify-then-sweep sampler on phase 6's bench field and
# rays. PRE_STEPS is JAX's test value. The dense buffer's share of the
# sampler buffer's 24,576 slots was set from a first run on the card, which
# flagged 15,762 of its 16,346 sampler rays (0.64 of the slots), with room
# to spare, so that the overflow is 0 (the check is fatal)
PRE_STEPS = 26
PRE_FRACTION = 0.9
# the presweep route against phase 6's dense route on the same kernels: a
# flagged ray runs the same sampler kernel (its result does not depend on
# the buffer it sits in), a certified one is non-surface, so hit masks may
# differ only where the certificate (L = 2) missed a crossing
PRE_MASK_BAR = 0.9999
# (b): plot_cuts' values on the card against the CPU's plain SIREN: phase
# 2's fused_mlp value bar
PLOT_TOL = 2e-5
# (d): measure_scaling's step at world size 1 (the JAX script's defaults)
SCALING_RAYS = 2048


def fallback_payloads(path: str) -> list:
    """The figures of misc/visualize.py's data-only HTML: a list a figure of
    its traces' JSON objects."""
    import re

    with open(path) as f:
        html = f.read()
    return [json.loads(m) for m in re.findall(
        r"<pre data-format='fallback-plotly-json'>(.*?)</pre>", html, re.S)]


def refusals_phase(dev, kernels, trace, siren, anim_sources, run) -> dict:
    """Phase 21: what the port refused until PR 20, on the card.
    `trace`: phase 6's bench field and rays (dict: fine, coarse, plain_fine,
    plain_coarse, rays, res_dense, trace_ms); `siren`: a trained SIREN run
    (dict: cfg, trainer, state, batch); `anim_sources`: PLY files named
    *_iso.ply / *_mesh.ply; `run`: a TrainRun (its trainer and state) for
    the checkpoint backend. Returns the `presweep_*` / `plot_*` keys of the
    kernels line's rows by row index."""
    import socket

    import numpy as np
    import torch.distributed as dist

    from isopoints_torch import bench, measure_scaling
    from isopoints_torch import debug as tdebug
    from isopoints_torch.factories import create_model
    from isopoints_torch.misc.checkpoints import CheckpointIO
    from isopoints_torch.models import raytracing
    from isopoints_torch.models.generator import Generator
    from isopoints_torch.ops import fused_mlp
    from isopoints_torch.parallel.sharding import make_mesh
    from isopoints_torch.rendering.lightrigs import create_animation

    t21 = time.perf_counter()
    counts = lambda: {k.name: k.launches for k in kernels}

    def reset():
        for k in kernels:
            k.launches = 0

    out_root = os.path.join(ROOT, "out", "torch_refusals")
    shutil.rmtree(out_root, ignore_errors=True)
    os.makedirs(out_root)
    keys = collections.defaultdict(dict)

    # ---- (a) the presweep on the bench field: kernels, plain, dense route
    fine, coarse = trace["fine"], trace["coarse"]
    rays = trace["rays"]
    cfg_pre = bench.bench_config(sampler_presweep=PRE_STEPS,
                                 sampler_dense_fraction=PRE_FRACTION)
    dense_calls = []      # (rays the call sweeps, presweep of its config)
    dense_fn = raytracing._dense_ray_sampler

    def recording_dense(*args, **kw):
        dense_calls.append((int(args[6].sum()), args[6].numel(),
                            args[7].sampler_presweep))
        return dense_fn(*args, **kw)

    igr_split = collections.Counter()
    igr_cuda = fused_mlp.igr_forward_cuda

    def recording_igr(pack, x, with_grad, bf16=False):
        igr_split[("bf16" if bf16 else "f32", x.shape[0])] += 1
        return igr_cuda(pack, x, with_grad, bf16)

    raytracing._dense_ray_sampler, fused_mlp.igr_forward_cuda = recording_dense, recording_igr
    try:
        reset()
        res_k = bench.trace(fine, coarse, rays, cfg_pre)
        torch.cuda.synchronize()
        got = counts()
        calls_k = list(dense_calls)
        dense_calls.clear()
        reset()
        res_p = bench.trace(trace["plain_fine"], trace["plain_coarse"], rays, cfg_pre)
        torch.cuda.synchronize()
        got_p = counts()
    finally:
        raytracing._dense_ray_sampler, fused_mlp.igr_forward_cuda = dense_fn, igr_cuda
    for name in ("fused_igr", "fused_sampler"):
        if got[name] <= 0:
            fail(f"phase 21 (a): {name} was not launched on the presweep route")
    if any(v for k, v in got.items() if k not in ("fused_igr", "fused_sampler")):
        fail(f"phase 21 (a): another kernel launched on the presweep route: {got}")
    if any(got_p.values()):
        fail(f"phase 21 (a): a kernel launched on the plain presweep route: {got_p}")
    swept = [(n, slots) for n, slots, pre in calls_k if pre == PRE_STEPS]
    flagged = [n for n, _, pre in calls_k if pre == 0]
    if len(swept) != 1 or len(flagged) != 1:
        fail(f"phase 21 (a): the presweep route's sampler calls {calls_k}")
    pre_modes = collections.Counter()
    for (mode, _), c in igr_split.items():
        pre_modes[mode] += c
    (n_swept, n_slots), = swept
    print(f"phase 21 (a): presweep {PRE_STEPS} steps, dense buffer "
          f"{PRE_FRACTION} of the sampler buffer's {n_slots} slots: {flagged[0]} of "
          f"{n_swept} sampler rays flagged ({flagged[0] / max(n_swept, 1):.4f}); overflow "
          f"trace {int(res_k.trace_overflow)} sampler {int(res_k.sampler_overflow)} "
          f"(plain route {int(res_p.trace_overflow)}, {int(res_p.sampler_overflow)}); "
          f"launches {got}; fused_igr by mode and rows: " + ", ".join(
              f"{c} x {m} n={n}" for (m, n), c in sorted(igr_split.items())))
    for res, label in ((res_k, "kernels"), (res_p, "plain")):
        if int(res.trace_overflow) or int(res.sampler_overflow):
            fail(f"phase 21 (a): overflow on the {label} presweep route")
    same = ((res_k.network_object_mask == res_p.network_object_mask)
            & (res_k.sampler_mask == res_p.sampler_mask))
    hit_agree = float((res_k.network_object_mask == res_p.network_object_mask)
                      .float().mean())
    smp_agree = float((res_k.sampler_mask == res_p.sampler_mask).float().mean())
    d_close = float(((res_k.dists - res_p.dists).abs() <= 1e-4)[same].float().mean())
    print(f"  kernels vs plain (phase 6's bars: masks >= 0.995, depths within "
          f"1e-4 on >= 0.99 of equal-mask rays): hit masks {hit_agree:.6f}, "
          f"sampler masks {smp_agree:.6f}, depths {d_close:.6f}")
    if hit_agree < 0.995 or smp_agree < 0.995 or d_close < 0.99:
        fail("phase 21 (a): the presweep route's kernels and plain versions disagree")
    dense = trace["res_dense"]
    both = res_k.network_object_mask & dense.network_object_mask
    pre_agree = float((res_k.network_object_mask == dense.network_object_mask)
                      .float().mean())
    n_dd = int((res_k.dists[both] != dense.dists[both]).sum())
    print(f"  presweep vs phase 6's dense route (kernels; bars: hit masks equal on "
          f">= {PRE_MASK_BAR}, depths of rays both hit equal bit for bit): hit "
          f"masks equal on {pre_agree:.6f} ({int((res_k.network_object_mask != dense.network_object_mask).sum())} "
          f"rays differ), {n_dd} of {int(both.sum())} common hits at another depth")
    if pre_agree < PRE_MASK_BAR or n_dd:
        fail("phase 21 (a): the presweep route differs from the dense route")
    pre_ms, _ = bench.time_trace(fine, coarse, rays, cfg_pre, 5)
    pre_pms, _ = bench.time_trace(trace["plain_fine"], trace["plain_coarse"], rays,
                                  cfg_pre, 1)
    print(f"  trace with the presweep: {pre_ms:.3f} ms on the kernels (median of 5), "
          f"{pre_pms:.3f} ms plain; phase 6's dense route {trace['trace_ms']:.3f} ms; "
          f"roofline: " + bench.trace_roofline(cfg_pre, bench.N_RAYS, pre_ms).report()
          + bench.UPPER_BOUND)
    keys[5].update(presweep_launches=pre_modes["bf16"])
    keys[6].update(presweep_launches=pre_modes["f32"])
    keys[7].update(presweep_launches=got["fused_sampler"],
                   presweep_shape=f"{flagged[0]} of {n_swept} sampler rays "
                   f"flagged, {n_slots} slots")

    # ---- (b) the plots: iso-contours on the card against the CPU, a tapped
    # step's debug dump, the animations
    trainer, state, batch = siren["trainer"], siren["state"], siren["batch"]
    model = trainer.model
    cpu_model = create_model(siren["cfg"], device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    reset()
    t = time.perf_counter()
    Generator(model).generate_iso_contour(os.path.join(out_root, "iso_card.html"))
    torch.cuda.synchronize()
    plot_s = time.perf_counter() - t
    got = counts()
    if got["fused_mlp"] != 9 or sum(got.values()) != 9:
        fail(f"phase 21 (b): generate_iso_contour launched {got}, expected 9 "
             f"fused_mlp launches (3 axes x 3 cuts)")
    t = time.perf_counter()
    Generator(cpu_model).generate_iso_contour(os.path.join(out_root, "iso_cpu.html"))
    plot_cpu_s = time.perf_counter() - t
    card = fallback_payloads(os.path.join(out_root, "iso_card.html"))
    ref = fallback_payloads(os.path.join(out_root, "iso_cpu.html"))
    if len(card) != 9 or len(ref) != 9:
        fail(f"phase 21 (b): {len(card)} / {len(ref)} contour figures, expected 9")
    z_err = 0.0
    for c, r in zip(card, ref):
        if c[0]["x"] != r[0]["x"] or c[0]["y"] != r[0]["y"] or \
                c[0]["contours"] != r[0]["contours"]:
            fail("phase 21 (b): the contour grids differ between the card and the CPU")
        z_err = max(z_err, float(np.abs(np.asarray(c[0]["z"]) - np.asarray(r[0]["z"])).max()))
    zs = np.asarray(card[4][0]["z"])
    print(f"phase 21 (b): generate_iso_contour (3 axes x 3 cuts x 100², SIREN of "
          f"phase 4) {plot_s:.3f} s on the card ({got['fused_mlp']} fused_mlp launches "
          f"of 10,000 points), {plot_cpu_s:.3f} s on the CPU; max |z| difference "
          f"{z_err:.3g} (bar {PLOT_TOL}); centre cut's values in [{zs.min():.3f}, "
          f"{zs.max():.3f}]")
    if not z_err <= PLOT_TOL or not (zs.min() < 0 < zs.max()):
        fail("phase 21 (b): the card's contours disagree with the CPU's or miss the surface")
    keys[0].update(plot_launches=got["fused_mlp"], plot_shape="value, 10,000 points")
    it = state.it
    tdebug.set_debugging_mode_(True)
    try:
        st, _ = trainer.train_step(state, *batch(it))
        t = time.perf_counter()
        path = trainer.debug_dump(out_root, it)
        dump_s = time.perf_counter() - t
    finally:
        tdebug.set_debugging_mode_(False)
    figs = fallback_payloads(path) if path else []
    if not figs or [tr["type"] for tr in figs[0]] != ["Scatter3d", "Cone"]:
        fail(f"phase 21 (b): debug_dump wrote {path} with {figs and [tr['type'] for tr in figs[0]]}")
    cone = np.asarray([figs[0][1][k] for k in "uvw"], dtype=np.float64)
    pts = np.asarray([figs[0][0][k] for k in "xyz"], dtype=np.float64)
    if not (np.isfinite(cone).all() and np.abs(cone).max() > 0 and np.isfinite(pts).all()):
        fail("phase 21 (b): the debug dump's gradients are not finite and non-zero")
    print(f"  a tapped projected step (its {it}) and debug_dump: {os.path.basename(path)}, "
          f"{pts.shape[1]} of the 'iso' points with their gradient cones (max "
          f"|dL/dx| {np.abs(cone).max():.3g}) in {dump_s:.3f} s")
    anim = os.path.join(out_root, "snapshots")
    os.makedirs(anim)
    for src in anim_sources:
        shutil.copy(src, anim)
    t = time.perf_counter()
    create_animation(anim)
    anim_s = time.perf_counter() - t
    from isopoints_torch.utils.io import read_ply
    iso = sorted(f for f in os.listdir(anim) if f.endswith("_iso.ply"))
    mesh = sorted(f for f in os.listdir(anim) if f.endswith("_mesh.ply"))
    for name, files in (("pts_animation.html", iso), ("mesh_animation.html", mesh)):
        figs = fallback_payloads(os.path.join(anim, name))
        first = read_ply(os.path.join(anim, files[0]))["points"]
        got_pts = np.asarray([figs[0][0][k] for k in "xyz"], np.float32).T
        if not np.array_equal(got_pts, first):
            fail(f"phase 21 (b): {name}'s first frame is not {files[0]}'s points")
    print(f"  create_animation over {len(iso)} *_iso.ply and {len(mesh)} *_mesh.ply "
          f"of earlier phases: {anim_s:.2f} s, each first frame equal to its PLY")

    # ---- (c) the checkpoint backend and (d) measure_scaling at world size 1
    # under NCCL
    trainer, state = run.trainer, run.state
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        reg = dict(model=trainer.model.state_dict(), opt=state.opt_state,
                   points=state.points, points_mask=state.points_mask,
                   spacing=state.spacing, saliency=trainer.saliency_state())
        ck_dir = os.path.join(out_root, "ckpt")
        times = {}
        for backend in ("orbax", "npz"):
            ck = CheckpointIO(ck_dir, backend=backend, **reg)
            torch.cuda.synchronize()
            t = time.perf_counter()
            path = ck.save("model.npz", it=state.it)
            times[backend + " save"] = 1e3 * (time.perf_counter() - t)
            zeroed = CheckpointIO(ck_dir, backend=backend, **{
                k: (None if v is None else _zeros_like_tree(v))
                for k, v in reg.items()})
            t = time.perf_counter()
            scalars = zeroed.load("model.npz")
            torch.cuda.synchronize()
            times[backend + " load"] = 1e3 * (time.perf_counter() - t)
            a = _leaves(reg)
            b = _leaves(zeroed.registry)
            if scalars["it"] != state.it or len(a) != len(b) or any(
                    not _equal_leaf(x, y) for x, y in zip(a, b)):
                fail(f"phase 21 (c): the {backend} backend did not restore the "
                     f"state bit for bit")
            if backend == "orbax":
                o_path = path
                n_bytes = sum(os.path.getsize(os.path.join(path, f))
                              for f in os.listdir(path))
        print(f"phase 21 (c): phase 17's state ({len(a)} entries, "
              f"{n_bytes / 2**20:.1f} MiB in {os.path.basename(o_path)}) through "
              f"CheckpointIO(backend='orbax') under NCCL at world size 1, saved and "
              f"restored into zeroed templates bit for bit: save {times['orbax save']:.1f} "
              f"ms, load {times['orbax load']:.1f} ms (npz: {times['npz save']:.1f}, "
              f"{times['npz load']:.1f} ms)")
        mesh_ = make_mesh(1, dev)
        secs = measure_scaling.measure(mesh_, SCALING_RAYS, 5, 64, dev)
        line = measure_scaling.scaling_line(1, SCALING_RAYS, secs, dist.get_backend(),
                                            torch.cuda.get_device_name(dev))
        print("phase 21 (d): measure_scaling at world size 1: " + json.dumps(line))
        if line["backend"] != "nccl" or not secs > 0:
            fail("phase 21 (d): measure_scaling did not run on NCCL")
    finally:
        dist.destroy_process_group()
    print(f"phase 21: {time.perf_counter() - t21:.1f} s")
    return dict(keys)


def _leaves(tree) -> list:
    """A registry's leaves in order (None skipped)."""
    from isopoints_torch.misc.checkpoints import _flatten
    return list(_flatten(tree, leaf=lambda x: x).values())


def _zeros_like_tree(tree):
    import numpy as np

    if isinstance(tree, dict):
        return type(tree)((k, _zeros_like_tree(v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zeros_like_tree(v) for v in tree))
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, np.ndarray):
        return np.zeros_like(tree)
    return type(tree)(0)


def _equal_leaf(a, b) -> bool:
    import numpy as np

    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.device == b.device and torch.equal(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b)) and type(a) is type(b)


def outside_every_silhouette(dtu_dir: str, n: int, dev) -> torch.Tensor:
    """n points that every view of the DTU directory sees outside the torus
    (R 0.4, r 0.15): candidates in [-0.9, 0.9]³ whose line of sight from
    each camera passes the torus by more than 0.02 (~5 px at 512 px; the
    analytic SDF at 4096 steps over the first 4 units of the ray, past
    which the torus cannot lie), independent of the masks and the filter."""
    from isopoints_torch.data.dataset import DTUDataset
    from isopoints_torch.data.synthetic import torus_sdf

    ds = DTUDataset(dtu_dir)
    g = torch.Generator(device=dev).manual_seed(4)
    cand = (torch.rand(8 * n, 3, generator=g, device=dev) * 1.8 - 0.9)
    ok = torch.ones(cand.shape[0], dtype=torch.bool, device=dev)
    sdf = torus_sdf()
    steps = torch.linspace(0.0, 1.0, 4096, device=dev)
    for v in range(len(ds)):
        cam = ds.camera([v], (512, 512), device=dev)
        c = cam.camera_center()[0]
        for lo in range(0, cand.shape[0], 2048):
            p = cand[lo:lo + 2048]
            d = (p - c) / torch.linalg.norm(p - c, dim=-1, keepdim=True)
            ray = c + 4.0 * steps[None, :, None] * d[:, None, :]
            ok[lo:lo + 2048] &= sdf(ray).amin(-1) > 0.02
    pts = cand[ok]
    if pts.shape[0] < n:
        fail(f"outside_every_silhouette: only {pts.shape[0]} of {cand.shape[0]} "
             f"candidates miss the torus in every view")
    return pts[:n]


# phase 22: the JAX package's last public surface. (a) holds the kernel to
# row 1's value tolerance against its plain version (phase 2), and a pick
# that differs from the plain decoder's to the same bar on the plain SDF at
# both picks (a tie within the tolerance); (b) renders a cloud across both
# clip planes, SURF_CLOUD splats a view at SURF_IMAGE px
SURF_MLP_TOL = 2e-5
SURF_ZNEAR, SURF_ZFAR = 0.5, 3.0
SURF_CLOUD = 20_000
SURF_IMAGE = 256


def surface_phase(dev, kernels, siren) -> dict:
    """Phase 22: the public surface that the port completed last, on the
    card. `siren`: phase 4's run (dict: model, cfg, trainer, state, batch).
    Returns the `world_points_*` / `clip_*` / `no_offsurface_*` keys of
    the kernels line's rows by row index."""
    from isopoints_torch.core.camera import PerspectiveCamera, look_at_view_transform
    from isopoints_torch.ops import fused_mlp
    from isopoints_torch.ops.images import sample_image_at_ndc
    from isopoints_torch.rendering.rasterizer import (RasterizationSettings,
                                                      compute_splat_params,
                                                      rasterize_splats,
                                                      splat_spacing)

    t22 = time.perf_counter()
    counts = lambda: {k.name: k.launches for k in kernels}

    def reset():
        for k in kernels:
            k.launches = 0

    keys = collections.defaultdict(dict)
    model, trainer, state = siren["model"], siren["trainer"], siren["state"]
    img, mask_img, cam = siren["batch"](0)
    n_rays = siren["cfg"].training.n_rays
    draws = trainer.draw(n_rays, tuple(img.shape[1:3]), cam.batch_size,
                         n_points=state.points.shape[1])
    pix = draws.pixels
    mask_gt = sample_image_at_ndc(mask_img, pix, mode="nearest")[..., 0] > 0.5

    # ---- (a) sample_world_points at the training batch's pixels
    def world_points():
        return model.sample_world_points(pix, cam, mask_gt)

    reset()
    pts_k, free_k, occ_k = world_points()
    torch.cuda.synchronize()
    got = counts()
    if got["fused_mlp"] <= 0 or any(v for k, v in got.items() if k != "fused_mlp"):
        fail(f"phase 22 (a): sample_world_points launched {got} (fused_mlp alone "
             f"expected)")
    route_ms = time_ms(world_points)
    with patched((model, "cfg", dataclasses.replace(model.cfg, use_fused_mlp=False))):
        reset()
        pts_p, free_p, occ_p = world_points()
        torch.cuda.synchronize()
        if any(counts().values()):
            fail(f"phase 22 (a): the plain decoder route launched {counts()}")
        plain_route_ms = time_ms(world_points)
    if not (torch.equal(free_k, free_p) and torch.equal(occ_k, occ_p)):
        fail(f"phase 22 (a): the masks differ on {int((free_k != free_p).sum())} "
             f"free and {int((occ_k != occ_p).sum())} occupancy rays")
    if not (torch.isfinite(pts_k).all() and int(free_k.sum()) > 0
            and int(occ_k.sum()) > 0):
        fail(f"phase 22 (a): picks finite {bool(torch.isfinite(pts_k).all())}, "
             f"{int(free_k.sum())} free and {int(occ_k.sum())} occupancy rays")
    differ = (pts_k != pts_p).any(-1)
    with torch.no_grad():
        gap = (model.decoder.sdf(pts_k[differ]) - model.decoder.sdf(pts_p[differ])).abs()
    tie = float(gap.max()) if gap.numel() else 0.0
    if tie > SURF_MLP_TOL:
        fail(f"phase 22 (a): picks of the kernel and the plain decoder differ on "
             f"{int(differ.sum())} rays, the plain SDF at them by up to {tie:.3g} > "
             f"{SURF_MLP_TOL}")
    # the kernel at this shape: the candidates as the method hands them over
    fused, seen = model.trace_sdf_fn(), []

    def recording(x):
        seen.append(x)
        return fused(x)
    with patched((model, "trace_sdf_fn", lambda: recording)):
        world_points()
    x = seen[0].reshape(-1, 3).contiguous()
    pack = fused.pack
    with torch.no_grad():
        err = float((fused(x) - fused_mlp.siren_sdf_plain(pack, x)).abs().max())
    if err > SURF_MLP_TOL:
        fail(f"phase 22 (a): fused_mlp value err {err} > {SURF_MLP_TOL} at "
             f"{x.shape[0]} points")
    n = x.shape[0]
    ms = time_ms(lambda: fused(x))
    plain_ms = time_ms(lambda: fused_mlp.siren_sdf_plain(pack, x))
    w_bytes = 4 * sum(w.numel() + b.numel() for w, b in zip(pack.ws, pack.bs))
    dec = model.decoder
    b = bound_ms(3 * mlp_flops(n, dec.hidden_size, dec.n_layers), n * 16 + w_bytes,
                 TF32_PEAK)
    shape = (f"value, {n} points ({cam.batch_size} views x {n_rays} rays x "
             f"{model.cfg.n_points_per_ray} points a ray)")
    print(f"phase 22 (a): sample_world_points on phase 4's SIREN {dec.n_layers}x"
          f"{dec.hidden_size}, {shape}: fused_mlp launches {got['fused_mlp']}; masks "
          f"equal to the plain decoder route on every ray ({int(free_k.sum())} free, "
          f"{int(occ_k.sum())} occupancy); picks differing on "
          f"{float(differ.float().mean()):.4%} of rays ({int(differ.sum())}), the "
          f"plain SDF at both picks within {tie:.3g}; route {route_ms:.3f} ms, plain "
          f"decoder route {plain_route_ms:.3f} ms; the kernel at this shape: "
          f"max_abs_err {err:.3g}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
          f"bound {b[0]:.4f} ms ({b[1]})")
    keys[0].update(world_points_launches=got["fused_mlp"], world_points_shape=shape,
                   world_points_max_abs_err=err, world_points_ms=ms,
                   world_points_plain_ms=plain_ms, world_points_bound_ms=b[0],
                   world_points_bound_by=b[1], world_points_route_ms=route_ms,
                   world_points_plain_route_ms=plain_route_ms,
                   world_points_picks_differing=float(differ.float().mean()))

    # ---- (b) the clip planes: a cloud across both planes, kernels and plain
    g = torch.Generator(device=dev).manual_seed(22)
    R, T = look_at_view_transform(2.0, [15.0, -35.0], [40.0, 210.0], device=dev)
    cam_d = PerspectiveCamera.create(R=R, T=T, focal_length=2.0, device=dev)
    cam_c = PerspectiveCamera.create(R=R, T=T, focal_length=2.0, znear=SURF_ZNEAR,
                                     zfar=SURF_ZFAR, device=dev)
    depth = 0.2 + 3.6 * torch.rand(2, SURF_CLOUD, generator=g, device=dev)
    lateral = (torch.rand(2, SURF_CLOUD, 2, generator=g, device=dev) - 0.5) * 0.9
    view = torch.cat([lateral * depth[..., None], depth[..., None]], -1)
    pts = cam_d.view_to_world(view)
    normals = cam_d.camera_center()[:, None] - pts          # facing the camera
    pmask = torch.rand(2, SURF_CLOUD, generator=g, device=dev) > 0.05
    z = cam_d.world_to_view(pts)[..., 2]
    below, above = int((pmask & (z < SURF_ZNEAR)).sum()), int((pmask & (z > SURF_ZFAR)).sum())
    if min(below, above) < 1000:
        fail(f"phase 22 (b): {below} splats before znear and {above} past zfar")
    st_k = RasterizationSettings(image_size=SURF_IMAGE, use_pallas=True)
    st_p = dataclasses.replace(st_k, use_pallas=False)
    renderable = {}
    with torch.no_grad():
        spacing = splat_spacing(pts, pmask, st_k)
        for label, c in (("clip", cam_c), ("default", cam_d)):
            sp = compute_splat_params(pts, normals, pmask, c, st_k, spacing=spacing)
            want = pmask & (z >= c.znear) & (z <= c.zfar)
            if not torch.equal(sp.mask, want):
                fail(f"phase 22 (b), {label} planes: the renderable mask differs "
                     f"from the depth test on {int((sp.mask != want).sum())} splats")
            renderable[label] = int(sp.mask.sum())
            args = (sp.pts_ndc, sp.ellipse, sp.radii, sp.cutoff, sp.mask)
            reset()
            fk = rasterize_splats(*args, st_k)
            torch.cuda.synchronize()
            got = counts()
            if got["splat_select"] <= 0 or got["splat_fine"] <= 0:
                fail(f"phase 22 (b), {label} planes: the raster launched {got}")
            reset()
            fp = rasterize_splats(*args, st_p)
            torch.cuda.synchronize()
            if any(counts().values()):
                fail(f"phase 22 (b), {label} planes: the plain raster launched {counts()}")
            for name in ("idx", "zbuf", "occupancy", "visibility", "tile_overflow"):
                if not torch.equal(getattr(fk, name), getattr(fp, name)):
                    fail(f"phase 22 (b), {label} planes: {name} differs from the "
                         f"plain stages")
            q_err = float((fk.qvalue - fp.qvalue).abs().max())
            if q_err > 1e-6:
                fail(f"phase 22 (b), {label} planes: qvalue err {q_err} > 1e-6")
            if label == "clip":
                clip_ms = time_ms(lambda: rasterize_splats(*args, st_k))
                clip_pms = time_ms(lambda: rasterize_splats(*args, st_p), reps=3)
                clip_launches = got
                keys[3]["clip_launches"] = got["splat_select"]
                keys[4]["clip_launches"] = got["splat_fine"]
                visible = int(fk.visibility.sum())
    if renderable["clip"] == renderable["default"]:
        fail(f"phase 22 (b): the clip planes cull nothing ({renderable})")
    print(f"phase 22 (b): rasterize_splats, 2 views x {SURF_CLOUD} splats at view "
          f"depths 0.2-3.8 ({below} before znear {SURF_ZNEAR}, {above} past zfar "
          f"{SURF_ZFAR}), {SURF_IMAGE} px: renderable {renderable['clip']} with the "
          f"planes, {renderable['default']} with the default ones; the select and "
          f"fine kernels ({clip_launches['splat_select']} + "
          f"{clip_launches['splat_fine']} launches) against the plain stages: "
          f"idx/zbuf/occupancy/visibility/tile_overflow identical, qvalue within "
          f"1e-6, at both planes; {visible} visible splats; raster {clip_ms:.4f} ms, "
          f"plain stages {clip_pms:.3f} ms")

    # ---- (c) a projected forward without the off-surface samples
    out, launched = {}, {}
    for flag in (True, False):
        reset()
        o, new_pts, new_mask = model(
            pix, img, mask_img, cam, draws.u_minsdf, points=state.points,
            points_mask=state.points_mask, project=True,
            sample_iso_offsurface=flag, draws=draws.projected)
        torch.cuda.synchronize()
        out[flag], launched[flag] = o, counts()
    o, ref = out[False], out[True]
    for name in ("iso_points", "iso_normals", "iso_rgb", "iso_rgb_gt",
                 "sdf_freespace", "sdf_occupancy"):
        v = getattr(o, name)
        if not bool(torch.isfinite(v[o.iso_mask]).all()):
            fail(f"phase 22 (c): non-finite {name}")
    if not (torch.equal(o.p_freespace, o.iso_points.detach())
            and torch.equal(o.p_occupancy, o.iso_points.detach())
            and not o.freespace_mask.any() and not o.occupancy_mask.any()):
        fail("phase 22 (c): the off-surface samples are not the on-surface ones "
             "with both masks False")
    if not all(torch.equal(getattr(o, k), getattr(ref, k))
               for k in ("iso_points", "iso_mask", "iso_normals", "iso_rgb")):
        fail("phase 22 (c): the on-surface outputs differ from the run with the "
             "off-surface samples")
    if int(o.iso_mask.sum()) <= 0 or any(
            launched[False][k] <= 0 for k in ("fused_mlp", "knn", "splat_select",
                                              "splat_fine")):
        fail(f"phase 22 (c): {int(o.iso_mask.sum())} iso-points, launches "
             f"{launched[False]}")
    print(f"phase 22 (c): a projected forward on phase 4's model, "
          f"{int(o.iso_mask.sum())} on-surface points, finite; launches without the "
          f"off-surface samples {launched[False]}, with them {launched[True]}")
    for i, name in ((0, "fused_mlp"), (2, "knn"), (3, "splat_select"),
                    (4, "splat_fine")):
        keys[i]["no_offsurface_launches"] = launched[False][name]
        keys[i]["offsurface_launches"] = launched[True][name]
    print(f"phase 22: {time.perf_counter() - t22:.1f} s")
    return keys


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    t_start = time.time()
    sys.path.insert(0, ROOT)
    from isopoints_torch.config import default_config_path, load_config
    from isopoints_torch.core.camera import (PerspectiveCamera,
                                             cameras_from_matrices,
                                             look_at_view_transform)
    from isopoints_torch.factories import (create_dataset, create_model,
                                           create_trainer)
    from isopoints_torch.models.combined import back_camera
    from isopoints_torch.models.fields import SirenField, sdf_and_grad
    from isopoints_torch import bench, kernel_variants, point_scene
    from isopoints_torch.models import implicit as implicit_mod
    from isopoints_torch.models import raytracing
    from isopoints_torch.models.raytracing import march_plain
    from isopoints_torch.ops import (_build, fused_mlp, fused_sampler,
                                     fused_trace, knn, raymesh)
    from isopoints_torch.rendering import occ_bwd, select, splat
    from isopoints_torch.rendering.rasterizer import (RasterizationSettings,
                                                      _rasterize_forward,
                                                      compute_splat_params,
                                                      splat_spacing,
                                                      stage_inputs)
    from isopoints_torch.models import levelset
    from isopoints_torch.ops.sampling import farthest_point_sampling
    from isopoints_torch.training import trainer as trainer_mod
    from isopoints_torch.training.trainer import compute_loss
    from isopoints_torch.utils import fma, linspace01

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = (fused_mlp.KERNEL, fused_sampler.KERNEL, knn.KERNEL,
               select.KERNEL, splat.KERNEL, fused_mlp.IGR_KERNEL,
               fused_trace.KERNEL, splat.ZBUF_KERNEL, occ_bwd.KERNEL,
               raymesh.KERNEL)

    def reset():
        for k in kernels:
            k.launches = 0

    def counts():
        return {k.name: k.launches for k in kernels}

    # ---- 1. card and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0])
    t0 = time.time()
    build_s = {}
    libs = _build.build_all(build_s)
    print(f"kernel build: {time.time() - t0:.1f} s for {sorted(libs)} ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(build_s.items()))
          + ")")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    # the fused MLP and every IGR kernel evaluate on mlp_mma.cuh's
    # tensor-core tile
    for lib in ("fused_mlp", "fused_igr", "fused_sampler", "fused_trace",
                "fused_mlp_wide", "fused_igr_wide", "fused_sampler_wide",
                "fused_trace_wide"):
        print(f"{lib} ptxas: {ptxas_summary(libs[lib])}")
        sass = subprocess.run([cuobjdump, "--dump-sass", libs[lib]],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout.splitlines()
        n_hgmma = sum("HGMMA" in line for line in sass)
        n_hmma = sum("HMMA" in line and "HGMMA" not in line for line in sass)
        print(f"{lib} SASS: {n_hmma} HMMA and {n_hgmma} HGMMA instructions "
              f"(tensor cores)")
        if n_hmma + n_hgmma == 0:
            fail(f"the {lib} library's SASS holds no tensor-core instruction")
        # the wide instances run mlp_wide.cuh's wgmma tile, without a spill
        if lib.endswith("_wide") and (n_hgmma == 0 or n_hmma > 0
                                      or any(ptxas_spills(libs[lib]))):
            fail(f"the {lib} library is not the wgmma tile without spills: {n_hmma} HMMA, "
                 f"{n_hgmma} HGMMA, spills {ptxas_spills(libs[lib])}")

    # ---- 2. kernels against their plain versions at full width
    hidden, n_hidden = 256, 3
    gen = torch.Generator(device=dev).manual_seed(0)
    field = SirenField(hidden_size=hidden, n_layers=n_hidden, generator=gen,
                       device=dev)
    sdf = fused_mlp.make_fused_siren_sdf(field)
    pack = sdf.pack
    plain = lambda p: fused_mlp.siren_sdf_plain(pack, p)
    w_bytes = 4 * sum(w.numel() + b.numel() for w, b in zip(pack.ws, pack.bs))

    def check_mlp(n, tol_v, tol_g, with_grad):
        x = torch.rand((n, 3), generator=gen, device=dev) * 2 - 1
        if with_grad:
            v, g = sdf.sdf_and_grad(x)
            v_ref, g_ref = fused_mlp.siren_sdf_and_grad_plain(pack, x)
            err_g = float((g - g_ref).abs().max())
            scale_g = float(g_ref.abs().max())
            if err_g > tol_g * max(1.0, scale_g):
                fail(f"fused_mlp grad err {err_g} > {tol_g}·max(1, {scale_g})")
        else:
            v, v_ref, err_g = sdf(x), plain(x), 0.0
        err_v = float((v - v_ref).abs().max())
        if not (err_v <= tol_v and torch.isfinite(v).all()):
            fail(f"fused_mlp value err {err_v} > {tol_v}")
        run = (lambda: sdf.sdf_and_grad(x)) if with_grad else (lambda: sdf(x))
        run_p = ((lambda: fused_mlp.siren_sdf_and_grad_plain(pack, x))
                 if with_grad else (lambda: plain(x)))
        ms, plain_ms = time_ms(run), time_ms(run_p)
        b = bound_ms(3 * mlp_flops(n, hidden, n_hidden) * (4 if with_grad else 1),
                     n * (12 + (16 if with_grad else 4)) + w_bytes, TF32_PEAK)
        return max(err_v, err_g), ms, plain_ms, b

    def check_sampler(n_rays, steps, n_secant):
        g = torch.Generator(device=dev).manual_seed(n_rays + n_secant)
        cam = torch.tensor([0.0, 0.0, -2.0], device=dev).expand(n_rays, 3).contiguous()
        d = torch.randn((n_rays, 3), generator=g, device=dev) * 0.3
        d[:, 2] = 1.0
        d = d / d.norm(dim=-1, keepdim=True)
        t_lo = 0.8 + 0.4 * torch.rand(n_rays, generator=g, device=dev)
        t_hi = t_lo + 2.2 * torch.rand(n_rays, generator=g, device=dev)
        args = (cam, d, t_lo, t_hi, steps)
        out = sdf.fused_ray_sampler(*args, n_secant=n_secant)
        ref = fused_sampler.sweep_plain(plain, *args, n_secant)
        # every point on fused_mlp's tile: sweep_plain over the fused callable
        if not all(torch.equal(a, b) for a, b in zip(
                out, fused_sampler.sweep_plain(sdf, *args, n_secant))):
            fail(f"fused_sampler (SIREN) differs from sweep_plain over the fused "
                 f"callable at {n_rays} rays")
        same = (out[0] == ref[0]) & (out[2] == ref[2])
        frac = 1.0 - float(same.float().mean())
        hit = same & (ref[1] < 0)
        err_f = float((out[1] - ref[1])[same].abs().max())
        err_z = float((out[3] - ref[3])[hit].abs().max()) if n_secant else 0.0
        if frac > 1e-3 or err_f > 1e-5 or err_z > 1e-4:
            fail(f"fused_sampler: {frac:.2e} of picks differ (tol 1e-3), "
                 f"f_pick err {err_f} (tol 1e-5), z_secant err {err_z} (tol 1e-4)")
        ms = time_ms(lambda: sdf.fused_ray_sampler(*args, n_secant=n_secant))
        plain_ms = time_ms(lambda: fused_sampler.sweep_plain(plain, *args, n_secant))
        n_evals = n_rays * (steps.shape[0] + n_secant)
        b = bound_ms(3 * mlp_flops(n_evals, hidden, n_hidden),
                     n_rays * 48 + steps.numel() * 4 + w_bytes, TF32_PEAK)
        return max(err_f, err_z), frac, ms, plain_ms, b

    def sphere_cloud(n, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        v = torch.randn(1, n, 3, generator=g, device=dev)
        v = v / v.norm(dim=-1, keepdim=True)
        return 0.5 * v, v, torch.rand(1, n, generator=g, device=dev) < 0.97

    def check_knn(pts, mask, k, timed):
        p = pts.shape[1]
        knn_equal(pts, pts, mask, mask, k, True, f"P={p}")
        if not timed:
            return None, None, (None, None), None
        ms = time_ms(lambda: knn.knn_points(pts, pts, mask, mask, k=k,
                                            exclude_self=True))
        plain_ms = time_ms(lambda: knn.knn_points(pts, pts, mask, mask, k=k,
                                                  exclude_self=True,
                                                  method="dense"), reps=3)
        # the kernel alone, from a profiled call
        prof = bench.profile_call(lambda: knn.knn_points(
            pts, pts, mask, mask, k=k, exclude_self=True), dev, "knn",
            log=lambda m: None)
        # the kNN's own kernels (from knn.SORT_MIN points: the Morton codes,
        # the boxes and the search; not the sort between them)
        alone = sum(t for key, t, _ in prof["kernels"] if "knn" in key)
        nv = float(mask.sum())
        # query IS points (read once: xyz + mask), k (f32, i64) pairs out
        b = bound_ms(9.0 * nv * nv, p * 13 + p * k * 12)
        return ms, plain_ms, b, alone

    def raster_inputs(pts, normals, mask, cam, st, spacing=None):
        """The selection's and the fine stage's inputs as the rasterizer
        forms them (rendering/rasterizer.py stage_inputs)."""
        b = cam.batch_size
        sp = compute_splat_params(pts.expand(b, -1, -1),
                                  normals.expand(b, -1, -1),
                                  mask.expand(b, -1), cam, st, spacing=spacing)
        return stage_inputs(sp.pts_ndc, sp.ellipse, sp.radii, sp.cutoff,
                            sp.mask, st)

    def sphere_raster_inputs(n_points=8000, S=256):
        pts, normals, mask = sphere_cloud(n_points, seed=3)
        R, T = look_at_view_transform(2.0, [10.0, -30.0], [20.0, 150.0],
                                      device=dev)
        cam = PerspectiveCamera.create(R=R, T=T, focal_length=2.0, device=dev)
        return raster_inputs(pts, normals, mask, cam,
                             RasterizationSettings(image_size=S, use_pallas=True))

    perm_gen = torch.Generator(device=dev).manual_seed(9)

    def fine_need(table, ci, ok, S, T, fr):
        """(pixel, candidate) pairs any walk must score: the candidates whose
        box covers the pixel, up to its last kept hit in (depth, id) order
        (none for a pixel without one)."""
        b, n_t, m = ci.shape
        a = torch.gather(table, 1, ci.reshape(b, -1, 1).expand(-1, -1, 9)
                         ).reshape(b, n_t, 1, m, 9)
        xf, yf = splat._tile_pixels(torch.arange(n_t, device=dev), S, T)
        cover = ((torch.abs(xf[None, :, :, None] - a[..., 0]) <= a[..., 6])
                 & (torch.abs(yf[None, :, :, None] - a[..., 1]) <= a[..., 7])
                 & ok[:, :, None, :])
        n_kept = (fr.idx >= 0).sum(-1, keepdim=True)
        last = (n_kept - 1).clamp(min=0)
        z_l = torch.gather(fr.zbuf, -1, last)
        g_l = torch.gather(fr.idx, -1, last)
        before = (a[..., 2] < z_l) | ((a[..., 2] == z_l) & (ci[:, :, None, :] <= g_l))
        return float((cover & before & (n_kept > 0)).sum())

    def check_raster(sel, table, label, K=5, depth_merge=0.05, timed=False):
        """Selection and fine stage against their plain versions: candidate
        sets, overflow and every fragment map identical, also with each
        tile's list permuted (`used` and `slots` permuted to match). With
        `timed`, the wrappers' and the kernels' own times (queued_ms),
        the plain times and the bounds at these shapes."""
        S, T, m_tile = sel[6], sel[7], sel[9]
        ci, ok, ovf = select.select_candidates(*sel)
        ci_p, ok_p, ovf_p = select.select_candidates_plain(*sel)
        sets = lambda c, o: [set(a[m].tolist()) for a, m in
                             zip(c.reshape(-1, c.shape[-1]).cpu(),
                                 o.reshape(-1, o.shape[-1]).cpu())]
        if sets(ci, ok) != sets(ci_p, ok_p) or not torch.equal(ovf, ovf_p):
            fail(f"splat_select ({label}): candidate sets or overflow differ "
                 f"from the plain version")
        b, p = table.shape[:2]
        fine_args = (table, ci, ok, S, T, K, depth_merge)
        fk = splat.rasterize_fine(*fine_args)
        fp = splat.rasterize_fine_plain(*fine_args)
        for name in ("idx", "zbuf", "occ", "used", "slots"):
            if not torch.equal(getattr(fk, name), getattr(fp, name)):
                fail(f"splat_fine ({label}): {name} differs from the plain version")
        q_err = float((fk.qvalue - fp.qvalue).abs().max())
        if q_err > 1e-6:
            fail(f"splat_fine ({label}): qvalue err {q_err} > 1e-6")
        vis_k = torch.zeros(b, p + 1, dtype=torch.bool, device=dev).scatter(
            1, torch.where(fk.used, ci, p).reshape(b, -1), True)
        vis_p = torch.zeros(b, p + 1, dtype=torch.bool, device=dev).scatter(
            1, torch.where(fp.used, ci, p).reshape(b, -1), True)
        if not torch.equal(vis_k, vis_p):
            fail(f"splat_fine ({label}): visibility differs from the plain version")
        # each tile's list permuted: the same maps, used and slots permuted
        perm = torch.argsort(torch.rand(ci.shape, generator=perm_gen, device=dev), -1)
        inv = torch.argsort(perm, -1)
        fq = splat.rasterize_fine(table, ci.gather(2, perm), ok.gather(2, perm),
                                  S, T, K, depth_merge)
        moved = torch.gather(inv, 2, fp.slots.long().clamp(min=0).reshape(b, ci.shape[1], -1)
                             ).reshape(fp.slots.shape)
        if not (all(torch.equal(getattr(fq, n), getattr(fp, n)) for n in ("idx", "zbuf", "occ"))
                and float((fq.qvalue - fp.qvalue).abs().max()) <= 1e-6
                and torch.equal(fq.used, fp.used.gather(2, perm))
                and torch.equal(fq.slots, torch.where(fp.slots >= 0, moved, -1).int())):
            fail(f"splat_fine ({label}): a permuted candidate list changes the maps")
        print(f"splat_select + splat_fine, {label}: P={p} x {b} views S={S} "
              f"M={m_tile}: candidate sets equal, overflow {ovf.tolist()}; "
              f"idx/zbuf/occ/used/slots/visibility identical, qvalue err "
              f"{q_err:.3g}, also on a permuted candidate list; "
              f"{int(vis_k.sum())} visible splats")
        if not timed:
            return None
        run_sel = lambda: select.select_candidates(*sel)
        run_fine = lambda: splat.rasterize_fine(*fine_args)
        sel_ms = time_ms(run_sel)
        sel_pms = time_ms(lambda: select.select_candidates_plain(*sel), reps=3)
        fine_ms = time_ms(run_fine)
        fine_pms = time_ms(lambda: splat.rasterize_fine_plain(*fine_args), reps=3)
        # the kernels alone: the calls queued behind a spin of the card,
        # timed by events (the selection's torch.sum taken off)
        sel_alone = kernel_variants.selection_alone_ms(run_sel, sel)
        fine_alone = kernel_variants.queued_ms(run_fine)
        n_t = ci.shape[1]
        # px, py, z, rx, ry (f32) + valid in; cidx (i64) + cok out
        sel_b = bound_ms(0.0, b * p * 21 + b * n_t * m_tile * 9)
        # ~12 FLOP per (pixel, candidate) pair any walk must score; the ok
        # flag in and the used flag out per slot, the id (i64) and the
        # table row (9 f32) per ok candidate only, idx (i64), zbuf, qvalue,
        # slots per fragment and occ per pixel out
        need = fine_need(table, ci, ok, S, T, fp)
        fine_b = bound_ms(12.0 * need, b * n_t * m_tile * 2 + int(ok.sum()) * 44
                          + b * S * S * (K * 20 + 4))
        print(f"  splat_select wrapper {sel_ms:.4f} ms (kernel alone "
              f"{sel_alone:.4f} ms)  plain {sel_pms:.3f} ms  bound {sel_b[0]:.4f} "
              f"ms ({sel_b[1]}); splat_fine wrapper {fine_ms:.4f} ms (kernel "
              f"alone {fine_alone:.4f} ms)  plain {fine_pms:.3f} ms  bound "
              f"{fine_b[0]:.4f} ms ({fine_b[1]}; {need:.0f} pairs a walk must "
              f"score, {float(ok.sum()) * T * T:.0f} (pixel, candidate) pairs "
              f"in the tiles)")
        return ((0.0, sel_ms, sel_pms, sel_b, sel_alone),
                (q_err, fine_ms, fine_pms, fine_b, fine_alone))

    def knn_case(pts, mask, k, label, timed=False):
        ms, pms, (bms, by), alone = check_knn(pts, mask, k, timed)
        times = (f"  kernel {ms:.4f} ms (its kernels alone {alone:.4f} ms)  plain "
                 f"{pms:.3f} ms  bound {bms:.4f} ms ({by})" if timed else "")
        print(f"knn {label} P={pts.shape[1]} k={k}: distances and indices "
              f"equal to the plain version's{times}")
        return 0.0, ms, pms, (bms, by)   # error 0: equal bit for bit

    def check_occ(args, label):
        """The occupancy backward on (pts, radii, visible, grad, settings) of
        B clouds: twice bit-identical, the window kernel's flags and search
        radius bit-equal to backward_window's, within GRAD_TOL of the plain
        version; timed as the path calls it (CUDA events), alone (queued)
        and plain. Returns (err, ms, plain ms, bound, alone ms, gradient,
        the bound over every patch pixel)."""
        pts, radii, vis, grad, st = args
        out, scratch = occ_bwd.launch(*args)
        if not torch.equal(out, occ_bwd.occ_backward_cuda(*args)):
            fail(f"occ_bwd ({label}): two runs on the same inputs differ")
        ren, sr2, _ = occ_bwd.window_of(scratch, pts.shape[1])
        n_rend = 0
        for i in range(pts.shape[0]):
            r, s2, w = occ_bwd.backward_window(pts[i], radii[i], vis[i], st)
            if not (torch.equal(ren[i], r) and torch.equal(
                    sr2[i:i + 1].view(torch.int32), s2.reshape(1).view(torch.int32))):
                fail(f"occ_bwd ({label}): cloud {i}'s renderable flags or search "
                     f"radius ({float(sr2[i])} against {float(s2)}) differ from "
                     f"backward_window's")
            n_rend += int(r.sum())
        ref = occ_bwd.occ_backward_plain(*args)
        oc = grad_check(out, ref)
        if not oc[1]:
            fail(f"occ_bwd ({label}): {oc[0]}")
        run = lambda: occ_bwd.occ_backward_cuda(*args)
        ms, alone = time_ms(run), kernel_variants.queued_ms(run)
        pms = time_ms(lambda: occ_bwd.occ_backward_plain(*args))
        # the work these inputs need: ~15 FLOP per term of the sums (dx,
        # dist², four compares, the max, two divisions, two products, two
        # sums), a compare per other nonzero pixel of a point's window;
        # beside it, 15 FLOP per (renderable point, patch pixel), the
        # row's earlier count. Points, radii, flags and the cotangent image
        # in, (B, P, 2) out
        terms, window = occ_bwd.occ_work(*args)
        n_bytes = pts.shape[0] * pts.shape[1] * (12 + 8 + 1 + 8) + 4.0 * grad.numel()
        b = bound_ms(15.0 * terms + (window - terms), n_bytes)
        b_all = bound_ms(15.0 * n_rend * w * w, n_bytes)
        print(f"occ_bwd on {label} ({pts.shape[0]} x {pts.shape[1]} points, "
              f"{n_rend} renderable, at {st.image_size} px, W={w}; cotangent "
              f"{int((grad < 0).sum())} negative, {int((grad > 0).sum())} positive "
              f"pixels): repeat bit-identical, flags and search radius bit-equal "
              f"to backward_window's, {oc[0]}  wrapper {ms:.4f} ms (kernels "
              f"alone {alone:.4f} ms)  plain {pms:.3f} ms  bound {b[0]:.4f} ms ({b[1]}; "
              f"{terms} terms, {window} nonzero window pixels; over every patch "
              f"pixel {b_all[0]:.4f} ms)")
        return float((out - ref).abs().max()), ms, pms, b, alone, out, b_all

    print("tolerances: MLP value |err| <= 2e-5, grad |err| <= 1e-4·max(1,|g|); "
          "sampler picks equal on >= 99.9% of rays, f_pick |err| <= 1e-5, "
          "z_secant |err| <= 1e-4 on crossing rays; kNN distances, indices "
          "and masks equal (torch.equal); splat "
          "candidate sets and overflow equal; idx/zbuf/occ/used/slots/"
          "visibility identical, qvalue |err| <= 1e-6")
    for n, grad in ((262_144, False), (262_144, True)):
        err, ms, pms, (bms, by) = check_mlp(n, 2e-5, 1e-4, grad)
        print(f"fused_mlp {'value+grad' if grad else 'value'} n={n}: max_abs_err "
              f"{err:.3g}  kernel {ms:.3f} ms  plain {pms:.3f} ms  bound {bms:.3f} ms ({by})")
    for steps, ns, what in ((linspace01(100, dev), 8, "linspace+secant8"),
                            (torch.rand(100, generator=gen, device=dev), 0,
                             "random, no secant")):
        err, frac, ms, pms, (bms, by) = check_sampler(16_384, steps, ns)
        print(f"fused_sampler {what} rays=16384: equal to sweep_plain over the "
              f"fused callable bit for bit; against the plain version max_abs_err "
              f"{err:.3g}  picks differing {frac:.2e}  kernel {ms:.3f} ms  plain "
              f"{pms:.3f} ms  bound {bms:.3f} ms ({by})")
    for p, k in ((8000, 6), (3000, 8), (6000, 16)):
        pts, _, mask = sphere_cloud(p, seed=p + k)
        knn_case(pts, mask, k, "sphere cloud")
    for label, q, pts, qm, pm, is_self in knn_clouds(dev):
        n_valid = [knn_equal(q, pts, qm, pm, k, ex, label)
                   for k in (1, 8, 16) for ex in ((False, True) if is_self else (False,))]
        print(f"knn {label} (B={pts.shape[0]}, {q.shape[1]} queries, "
              f"{pts.shape[1]} points) at k=1, 8, 16"
              f"{', with and without exclude_self' if is_self else ''}: "
              f"distances and indices equal to the plain version's "
              f"({n_valid} valid entries)")
    check_raster(*sphere_raster_inputs(), "8000-point sphere cloud")

    # ---- 3. the warm-up path: warm-up training steps through the factories
    def run_steps(cfg_name, n_steps):
        cfg = load_config(os.path.join(ROOT, "isopoints_torch", "configs",
                                       cfg_name), default_config_path())
        data = create_dataset(cfg, device=dev)
        images = torch.as_tensor(data["img.rgb"], device=dev)
        masks = torch.as_tensor(data["img.mask"], device=dev)
        mask_frac = float(masks.mean())
        if not 0.02 < mask_frac < 0.9:
            fail(f"synthetic sphere masks cover {mask_frac:.3f} of the pixels")
        model = create_model(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        trainer = create_trainer(model, cfg, seed=0, device=dev)
        state = trainer.init_state()
        n_views = images.shape[0]
        # each resample's seed and result, for the checks at its shapes
        resampled = []
        resample = trainer.resample_iso_points

        def recording_resample(n_points, **kw):
            out = resample(n_points, **kw)
            resampled.append((kw["init_points"], kw["init_mask"]) + tuple(out))
            return out
        trainer.resample_iso_points = recording_resample

        def batch(it):
            idx = [(2 * it) % n_views, (2 * it + 7) % n_views]
            cam = cameras_from_matrices(data["camera_mat"][idx],
                                        data["focal_length"],
                                        data["principal_point"], dev)
            i = torch.as_tensor(idx, device=dev)
            return images[i], masks[i], cam

        reset()
        step_ms, metrics, per_step = [], [], []
        for it in range(n_steps):
            before = counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = trainer.train_step(state, *batch(it))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t))
            metrics.append(m)
            per_step.append({k: v - before[k] for k, v in counts().items()})
        launches = counts()
        for i, m in enumerate(metrics):
            print(f"{cfg_name} step {i}: " + " ".join(
                f"{k}={v:.6g}" for k, v in m.items()) + f" ({step_ms[i]:.1f} ms)")
        loss_keys = ("loss", "loss_rgb", "loss_freespace", "loss_occupied",
                     "loss_eikonal")
        for m in metrics:
            if not all(torch.isfinite(torch.tensor(m[k])) for k in loss_keys):
                fail(f"non-finite loss terms {m}")
        if not trainer.check_state():
            fail(f"non-finite parameters after the {cfg_name} steps")
        return (cfg, trainer, state, batch, step_ms, metrics, per_step,
                launches, loss_keys, resampled)

    def kernels_vs_plain(cfg, trainer, state, batch, it, loss_keys, project):
        """One step's loss with the kernels and with every plain version
        (fused MLP off, plain rasterizer stages, dense kNN) on the same
        draws and the same iso-point buffer. Under a coarse trace phase the
        plain model traces with the plain f32 and bf16 SIREN values
        (`PlainSDF`), the same schedule. With a neural texture the
        texture's gradients of both runs must be finite and non-zero;
        returns their largest difference over the plain run's largest."""
        model = trainer.model
        img, mask, cam = batch(it)
        n_pts = state.points.shape[1] if project else None
        draws = trainer.draw(trainer.scheduler.at(it)["n_rays"],
                             tuple(img.shape[1:3]), 2, n_points=n_pts)
        hp = {k: float(v) for k, v in trainer.scheduler.at(it).items()
              if k in ("lambda_rgb", "lambda_freespace", "lambda_occupied",
                       "sdf_alpha")}
        hp["lambda_eikonal"] = trainer.cfg.lambda_eikonal
        plain_model = create_model(cfg, device=dev)
        plain_model.load_state_dict(model.state_dict())
        plain_model.cfg = dataclasses.replace(model.cfg, use_fused_mlp=False)
        plain_model.raster_settings = dataclasses.replace(
            model.raster_settings, use_pallas=False)
        if model.trace_sdf_fn_coarse() is not None:
            plain_model.trace_sdf_fn = lambda: fused_mlp.PlainSDF(
                fused_mlp.SirenPack(plain_model.decoder))
            plain_model.trace_sdf_fn_coarse = lambda: fused_mlp.PlainSDF(
                fused_mlp.SirenPack(plain_model.decoder), "bf16")
        textured = model.texture is not None
        res, tex_grads = {}, {}
        knn_cuda = knn.knn_points_cuda
        for name, m in (("kernels", model), ("plain", plain_model)):
            if name == "plain":   # the plain run swaps the kNN kernel out too
                knn.knn_points_cuda = knn.knn_points_dense
            try:
                with torch.set_grad_enabled(textured):
                    total, met, _, _, _ = compute_loss(
                        m, state.points, state.points_mask, draws.pixels, img,
                        mask, cam, draws.eikonal, draws.u_minsdf, hp,
                        project=project, proj_draws=draws.projected)
                    if textured:
                        tex_grads[name] = torch.autograd.grad(
                            total, list(m.texture.parameters()))
            finally:
                knn.knn_points_cuda = knn_cuda
            res[name] = {k: float(v.detach()) for k, v in met.items()}
        print(f"reference check ({'projected' if project else 'warm-up'} step), "
              f"kernels vs plain versions on one step's draws: {res}")
        cap = (model.ccfg.max_iso_per_batch if project
               else 2 * trainer.scheduler.at(it)["n_rays"])
        if abs(res["kernels"]["n_iso"] - res["plain"]["n_iso"]) > 0.005 * cap:
            fail("iso-point counts of the kernel and plain paths differ by > 0.5%")
        for k in loss_keys:
            a, b = res["kernels"][k], res["plain"][k]
            if abs(a - b) > 1e-2 * abs(b) + 1e-6:
                fail(f"{k}: kernel path {a} vs plain path {b} (rtol 1e-2)")
        if not textured:
            return None
        for name, gs in tex_grads.items():
            if not all(bool(torch.isfinite(g).all()) for g in gs) or \
                    not any(bool((g != 0).any()) for g in gs):
                fail(f"texture gradients of the {name} run are non-finite or zero")
        scale = max(float(g.abs().max()) for g in tex_grads["plain"])
        rel = max(float((a - b).abs().max()) for a, b in
                  zip(tex_grads["kernels"], tex_grads["plain"])) / scale
        print(f"  texture gradients finite and non-zero in both runs (max |g| "
              f"{scale:.4g}); largest difference {rel:.3g} of it")
        return rel

    (cfg, trainer, state, batch, step_ms, _, _, warm_launches,
     loss_keys, _) = run_steps("mvr_warmup_siren.yml", N_WARMUP_SMOKE)
    print(f"warm-up path: median step {statistics.median(step_ms):.2f} ms "
          f"(2 views x {cfg.training.n_rays} rays); launches in "
          f"{N_WARMUP_SMOKE} steps: {warm_launches}")
    for name in ("fused_mlp", "fused_sampler"):
        if warm_launches[name] <= 0:
            fail(f"kernel {name} was not launched on the warm-up path")
    kernels_vs_plain(cfg, trainer, state, batch, N_WARMUP_SMOKE, loss_keys,
                     project=False)

    # ---- 4. the projected path: warm-up, resample, projected steps
    # fused_mlp's launches in the run by (rows, points)
    mlp_split = collections.Counter()
    siren_cuda = fused_mlp.siren_forward_cuda

    def recording_siren(pack, x, with_grad, bf16=False):
        if bf16:
            fail("a bf16 fused_mlp launch on the projected path, which has no "
                 "coarse phase")
        mlp_split[("value+grad" if with_grad else "value", x.shape[0])] += 1
        return siren_cuda(pack, x, with_grad)

    fused_mlp.siren_forward_cuda = recording_siren
    try:
        (cfg, trainer, state, batch, step_ms, metrics, per_step, launches,
         loss_keys, resampled) = run_steps("mvr_projected_siren.yml",
                                           2 + N_PROJECTED)
    finally:
        fused_mlp.siren_forward_cuda = siren_cuda
    warm = trainer.cfg.warm_up_iters
    proj_ms = step_ms[warm + 1:]
    proj_launches = per_step[warm + 1:]
    print(f"projected path: {warm} warm-up steps, resample step (it={warm}) "
          f"{step_ms[warm]:.1f} ms, median projected step "
          f"{statistics.median(proj_ms):.2f} ms over {len(proj_ms)} steps; "
          f"launches in the run: {launches}")
    print(f"launches per projected step: {proj_launches[-1]}; in the resample "
          f"step: {per_step[warm]}")
    print(f"fused_mlp launches in the run: {launches['fused_mlp']} = " + ", ".join(
        f"{c} x {what} n={n}" for (what, n), c in mlp_split.most_common()))
    if sum(mlp_split.values()) != launches["fused_mlp"]:
        fail(f"fused_mlp's launches by shape {dict(mlp_split)} do not add up "
             f"to its counter")
    for name in ("fused_mlp", "fused_sampler", "knn", "splat_select",
                 "splat_fine"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the projected path")
    for name in ("knn", "splat_select", "splat_fine"):
        if any(p[name] <= 0 for p in proj_launches):
            fail(f"kernel {name} missing from a projected step")
    for p in proj_launches:
        if (p["splat_select"], p["splat_fine"], p["splat_zbuf_bwd"],
                p["occ_bwd"]) != (2, 2, 0, 0):
            fail(f"a projected step's rasters launched {p}: expected 2 selection "
                 f"and 2 fine launches and no backward (graph-free rasters)")
    n_iso = [m["n_iso"] for m in metrics[warm:]]
    if min(n_iso) <= 0 or state.points.shape[1] != cfg.model.combined_kwargs.max_iso_per_batch:
        fail(f"projected steps found no iso-points: n_iso {n_iso}")
    kernels_vs_plain(cfg, trainer, state, batch, warm + N_PROJECTED,
                     loss_keys, project=True)

    # ---- 5. kNN, selection and fine stage on the projected run's own clouds
    model = trainer.model
    st = model.raster_settings
    f_trace = model.trace_sdf_fn()
    seed_pts, seed_mask, res_pts, res_mask = resampled[-1]
    _, _, cam = batch(warm + N_PROJECTED)
    for label, pts, mask in (("projected-step buffer", state.points,
                              state.points_mask),
                             ("resample buffer", res_pts, res_mask)):
        with torch.no_grad():
            normals = sdf_and_grad(f_trace, pts)[1]
            spacing = splat_spacing(pts, mask, st)
        for view, c in (("step views", cam), ("back camera", back_camera(cam))):
            timed = label == "projected-step buffer" and view == "step views"
            out = check_raster(*raster_inputs(pts, normals, mask, c, st, spacing),
                               f"{label}, {view}", K=st.points_per_pixel,
                               depth_merge=st.depth_merging_threshold,
                               timed=timed)
            if timed:
                sel_row, fine_row = out
    k_err, k_ms, k_pms, k_b = knn_case(state.points, state.points_mask, 8,
                                       "projected-step buffer", timed=True)
    knn_case(state.points, state.points_mask, st.knn_k - 1,
             "projected-step buffer")
    knn_case(res_pts, res_mask, 16, "resample buffer")
    knn_case(res_pts, res_mask, st.knn_k - 1, "resample buffer")
    knn_case(seed_pts, seed_mask, model.proj_cfg.knn_k,
             "resample seed (before its projection)")
    # phase 19 works on this run's field, capacity and resample buffer
    p4 = {"model": model, "cap": cfg.model.combined_kwargs.n_points_per_cloud,
          "res": (res_pts, res_mask), "cfg": cfg, "trainer": trainer,
          "state": state, "batch": batch}

    # ---- 6. the trace path: the production schedule on the IGR bench field
    t_fit = time.time()
    field, fit_mse = bench.fit_sphere_field(dev)
    print(f"trace path: 4x256 IGR field fitted to the r={bench.RADIUS} sphere "
          f"in {time.time() - t_fit:.1f} s ({bench.FIT_STEPS} Adam steps), "
          f"mse {fit_mse:.3e}")
    fine, coarse = bench.trace_fns(field)
    plain_fine, plain_coarse = bench.trace_fns(field, plain=True)
    rays = bench.make_rays(bench.N_RAYS, dev)
    cfg_k = bench.bench_config()
    cfg_m = bench.bench_config(trace_in_kernel=True)
    thr = cfg_k.sdf_threshold
    # the kernel and the plain trace's sampler buffers and the march trace's
    # first compacted stage, recorded for the full-width kernel checks of
    # phase 7, each as (cam, dirs, t_lo, t_hi, steps, n_secant, margin,
    # coarse_sweep)
    captured = {}
    stepper_call, sweep_call = fine.fused_trace_stepper, raytracing.sweep_plain
    sampler_call = fine.fused_ray_sampler

    def recording_sweep(*args, **kw):
        if args[6] > 0:   # the dense sampler's sweep (with secant steps)
            captured.setdefault("sampler plain", args[1:8] + (
                kw.get("sdf_fn_coarse") is not None,))
        return sweep_call(*args, **kw)

    def recording_sampler(*args, n_secant, margin, coarse_sweep):
        if n_secant > 0:
            captured.setdefault("sampler kernel", args + (n_secant, margin,
                                                          coarse_sweep))
        return sampler_call(*args, n_secant=n_secant, margin=margin,
                            coarse_sweep=coarse_sweep)
    recording_sampler.packing_stride = sampler_call.packing_stride

    def recording_stepper(*args):
        captured.setdefault("stepper", args)
        return stepper_call(*args)

    def traced(fn_fine, fn_coarse, cfg, label, must_launch):
        reset()
        res = bench.trace(fn_fine, fn_coarse, rays, cfg)
        torch.cuda.synchronize()
        got = counts()
        print(f"trace ({label}): launches {got}; hits "
              f"{int(res.network_object_mask.sum())}, sampler rays "
              f"{int(res.sampler_mask.sum())}, overflow trace "
              f"{int(res.trace_overflow)} sampler {int(res.sampler_overflow)}")
        for name in must_launch:
            if got[name] <= 0:
                fail(f"kernel {name} was not launched on the trace path ({label})")
        for name in set(got) - set(must_launch):
            if got[name] != 0:
                fail(f"kernel {name} launched on the trace path ({label})")
        return res, got

    # fused_igr's launches of the kernel trace by (mode, rows, points)
    igr_split = collections.Counter()
    igr_cuda = fused_mlp.igr_forward_cuda

    def recording_igr(pack, x, with_grad, bf16=False):
        igr_split[("bf16" if bf16 else "f32",
                   "value+grad" if with_grad else "value", x.shape[0])] += 1
        return igr_cuda(pack, x, with_grad, bf16)

    fine.fused_trace_stepper = recording_stepper
    fine.fused_ray_sampler = recording_sampler
    fused_mlp.igr_forward_cuda = recording_igr
    try:
        res_k, trace_launches = traced(fine, coarse, cfg_k, "fused MLP + sampler",
                                       ("fused_igr", "fused_sampler"))
    finally:
        fused_mlp.igr_forward_cuda = igr_cuda
        fine.fused_ray_sampler = sampler_call
    igr_modes = collections.Counter()
    for (mode, _, _), c in igr_split.items():
        igr_modes[mode] += c
    print(f"fused_igr launches per trace: {trace_launches['fused_igr']} = " + ", ".join(
        f"{c} x {mode} {what} n={n}" for (mode, what, n), c in sorted(
            igr_split.items(), key=lambda kv: (kv[0][0], -kv[0][2]))))
    if sum(igr_split.values()) != trace_launches["fused_igr"] or \
            igr_modes["bf16"] <= 0 or igr_modes["f32"] <= 0:
        fail(f"fused_igr's trace launches {dict(igr_split)} do not add up to "
             f"its counter or miss a mode")
    res_m, march_launches = traced(fine, coarse, cfg_m, "+ in-kernel march",
                                   ("fused_igr", "fused_sampler", "trace_march"))
    fine.fused_trace_stepper = stepper_call
    raytracing.sweep_plain = recording_sweep
    try:
        res_p, _ = traced(plain_fine, plain_coarse, cfg_k, "every plain version", ())
    finally:
        raytracing.sweep_plain = sweep_call
    print("trace tolerances: the march route equals the loop route exactly "
          "(hit and sampler masks, depths with tolerance 0: the march "
          "evaluates a point with fused_igr's per-row arithmetic on the same "
          "tensor-core tile and updates its state with the loop's IEEE "
          "operations); the plain route's hit and sampler masks equal on >= "
          "99.5% of rays and depths within 1e-4 on >= 99% of the rays with "
          "equal masks; overflow 0; every hit finished without the sampler has "
          "f_fine <= thr when re-evaluated by the route's own fine callable: "
          "exactly on the fused-MLP and the march route (the same kernel "
          "arithmetic per row decided the stop), within 1e-6 on the plain "
          "route (cuBLAS rounds a point's sum by its batch)")
    for res, label in ((res_k, "kernels"), (res_m, "march"), (res_p, "plain")):
        if int(res.trace_overflow) or int(res.sampler_overflow):
            fail(f"trace ({label}): overflow trace {int(res.trace_overflow)} "
                 f"sampler {int(res.sampler_overflow)}")
        conv = res.network_object_mask & ~res.sampler_mask
        f_conv = (fine if label != "plain" else plain_fine)(res.points[conv])
        slack = 0.0 if label != "plain" else 1e-6
        worst = float(f_conv.max()) if f_conv.numel() else float("-inf")
        n_bad = int((f_conv > thr + slack).sum())
        print(f"converged-ray invariant ({label}): {int(conv.sum())} rays, max "
              f"f_fine {worst:.6g} (thr {thr:g}), {n_bad} above")
        if n_bad or not torch.isfinite(res.dists).all():
            fail(f"trace ({label}): {n_bad} converged rays with f_fine > thr")
    m_hit = float((res_k.network_object_mask == res_m.network_object_mask)
                  .float().mean())
    d_m = float((res_k.dists - res_m.dists).abs().max())
    m_exact = (torch.equal(res_k.network_object_mask, res_m.network_object_mask)
               and torch.equal(res_k.sampler_mask, res_m.sampler_mask)
               and torch.equal(res_k.dists, res_m.dists))
    print(f"march vs loop route: hit masks agree on {m_hit:.6f}, max depth diff "
          f"{d_m:.3g}; masks and depths identical: {m_exact}")
    if not m_exact:
        fail(f"march route differs from the loop route: hit masks agree on "
             f"{m_hit}, max depth diff {d_m} (tolerance 0)")
    same = ((res_k.network_object_mask == res_p.network_object_mask)
            & (res_k.sampler_mask == res_p.sampler_mask))
    hit_agree = float((res_k.network_object_mask == res_p.network_object_mask)
                      .float().mean())
    smp_agree = float((res_k.sampler_mask == res_p.sampler_mask).float().mean())
    d_close = float(((res_k.dists - res_p.dists).abs() <= 1e-4)[same]
                    .float().mean())
    print(f"kernel vs plain trace: hit masks agree on {hit_agree:.6f}, sampler "
          f"masks on {smp_agree:.6f}, depths within 1e-4 on {d_close:.6f} of "
          f"equal-mask rays (max diff {float((res_k.dists - res_p.dists).abs()[same].max()):.3g}); "
          f"march vs loop max depth diff {d_m:.3g}")
    if hit_agree < 0.995 or smp_agree < 0.995 or d_close < 0.99:
        fail("kernel and plain traces disagree beyond the stated tolerance")
    trace_ms, _ = bench.time_trace(fine, coarse, rays, cfg_k, 5)
    march_ms, _ = bench.time_trace(fine, coarse, rays, cfg_m, 5)
    plain_trace_ms, _ = bench.time_trace(plain_fine, plain_coarse, rays, cfg_k, 3)
    print(f"trace path: median trace {trace_ms:.3f} ms ({bench.N_RAYS / trace_ms * 1e3:.0f} "
          f"rays/s) with the fused MLP + sampler; {march_ms:.3f} ms "
          f"({bench.N_RAYS / march_ms * 1e3:.0f} rays/s) with the march; "
          f"{plain_trace_ms:.3f} ms with every plain version "
          f"({bench.N_RAYS} rays, median of 5/5/3)")
    # bench.py:186-216's roofline line, as isopoints_torch.bench prints it
    print("trace path roofline: " + bench.trace_roofline(cfg_k, bench.N_RAYS,
                                                         trace_ms).report()
          + bench.UPPER_BOUND)
    # phase 21 traces this field and these rays with the presweep
    p6 = dict(fine=fine, coarse=coarse, plain_fine=plain_fine,
              plain_coarse=plain_coarse, rays=rays, res_dense=res_k,
              trace_ms=trace_ms)
    pts, pmask = bench.projection_points(bench.N_POINTS, dev)
    for label, fn, kw in (("f32", fine, {}), ("bf16", coarse, {}),
                          ("hybrid", fine, dict(max_iters=4, fn_coarse=coarse,
                                                coarse_iters=8))):
        rate, frac, p_ms = bench.time_projection(fn, pts, pmask, **kw)
        print(f"iso_point_projections_per_s[{label}]: {rate:.0f} (converged "
              f"{100 * frac:.2f}% of {bench.N_POINTS}, tol 5e-5, {p_ms:.3f} ms)")
        if label != "bf16" and frac < 0.9:
            fail(f"{label} Newton projection converged only {frac:.3f}")

    # ---- 7. the IGR kernels against their plain versions at full width
    ipack = fine.pack
    igr_flops = 2.0 * sum(w.shape[0] * w.shape[1] for w in ipack.ws)
    # softplus evaluations per point: every layer but the head
    igr_softplus = sum(w.shape[0] for w in ipack.ws[:-1])
    igr_w_bytes = 4 * sum(w.numel() + b.numel() for w, b in zip(ipack.ws, ipack.bs))

    def check_igr(n, bf16, with_grad):
        fn = coarse if bf16 else fine
        x = torch.rand((n, 3), generator=gen, device=dev) * 2.4 - 1.2
        if with_grad:
            out = fn.sdf_and_grad(x)
            ref = fused_mlp.igr_sdf_and_grad_plain(ipack, x, bf16)
            run_k = lambda: fn.sdf_and_grad(x)
            run_p = lambda: fused_mlp.igr_sdf_and_grad_plain(ipack, x, bf16)
        else:
            out, ref = (fn(x),), (fused_mlp.igr_sdf_plain(ipack, x, bf16),)
            run_k = lambda: fn(x)
            run_p = lambda: fused_mlp.igr_sdf_plain(ipack, x, bf16)
        errs = [float((a - b).abs().max()) for a, b in zip(out, ref)]
        if not all(torch.isfinite(a).all() for a in out):
            fail("fused_igr: non-finite output")
        if bf16:
            # the mode's own error on these points: plain bf16 against f32
            own = ((fused_mlp.igr_sdf_and_grad_plain(ipack, x) if with_grad
                    else (fused_mlp.igr_sdf_plain(ipack, x),)))
            own_err = [float((a - b).abs().max()) for a, b in zip(ref, own)]
            exact = ((fused_mlp.igr_sdf_and_grad_plain(ipack, x, True, True)
                      if with_grad else
                      (fused_mlp.igr_sdf_plain(ipack, x, True, True),)))
            share = lambda us, vs: min(float(((u - v).abs() <= 1e-5).float().mean())
                                       for u, v in zip(us, vs))
            near_k, near_p, near_kp = share(out, exact), share(ref, exact), share(out, ref)
            print(f"fused_igr bf16 n={n}: within 1e-5 of the exact sums on "
                  f"{near_k:.5f} of outputs (the plain version on {near_p:.5f}), "
                  f"of the plain version on {near_kp:.5f}")
            if any(e > o for e, o in zip(errs, own_err)) or near_k < min(0.99, near_p):
                fail(f"fused_igr bf16: max err {errs} (tol: the mode's own "
                     f"error against f32, {own_err}), {near_k:.5f} within 1e-5 "
                     f"of the exact sums (tol: 0.99 or the plain version's "
                     f"{near_p:.5f})")
        elif errs[0] > IGR_F32_TOL or (with_grad and errs[1] > 1e-4 * max(
                1.0, float(ref[1].abs().max()))):
            fail(f"fused_igr f32: errs {errs} (value tol {IGR_F32_TOL:g}, grad 1e-4)")
        ms, plain_ms = time_ms(run_k), time_ms(run_p)
        # the products on the tensor cores: one bf16 pass, or three tf32
        # passes (hi·hi, hi·lo, lo·hi) in the f32 mode
        flops = igr_flops * n * (4 if with_grad else 1)
        b = bound_ms(flops if bf16 else 3 * flops,
                     n * (12 + (16 if with_grad else 4)) + igr_w_bytes,
                     BF16_PEAK if bf16 else TF32_PEAK)
        n_sp = n * igr_softplus
        print(f"fused_igr {'bf16' if bf16 else 'f32 (3xTF32)'} "
              f"{'value+grad' if with_grad else 'value'} n={n}: max_abs_err "
              f"{max(errs):.3g}  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
              f"bound {b[0]:.4f} ms ({b[1]}, "
              f"{'bf16 peak' if bf16 else '3 x FLOP over the tf32 peak'}); "
              f"epilogue {n_sp / 1e9:.3f} G softplus on the CUDA cores")
        return max(errs), ms, plain_ms, b

    print(f"IGR tolerances: f32 value |err| <= {IGR_F32_TOL:g}, grad |err| <= "
          "1e-4·max(1,|g|); bf16 |err| <= the mode's own max error against f32 "
          "on the same points, and within 1e-5 of the bf16 mode with exactly "
          "formed sums (`exact_sums`) on >= 99% of outputs or on as many as the "
          "plain version is (the same operands, rounded to bf16: where a sum's "
          "rounding lands on the other side of a bf16 rounding boundary the "
          "output moves by more; the tensor cores' sums are not float32 sums "
          "in the plain version's order, so both are held to exact sums); "
          "the coarse sampler and the march equal sweep_plain / march_plain "
          "over the fused callables bit for bit (the same tile per row), and "
          "against the plain versions: sampler picks equal on >= 99%, f_pick "
          "|err| <= 1e-5, z_secant within 1e-4 or within the f32 value "
          "tolerance over the ray's slope (|dz|·|df/dz| <= "
          f"{IGR_F32_TOL:g}, df/dz of the plain field at the plain root) on "
          ">= 99.9% of crossing rays, where the same kernel with a bf16 fine "
          "field must miss (the unconditioned share within 1e-4 is printed); "
          "march masks equal on >= 99.9%, depths within 1e-5 on >= 99.9%")
    for n in (bench.N_RAYS, 2 * bench.N_RAYS):
        for bf16 in (False, True):
            for grad in (False, True):
                check_igr(n, bf16, grad)
    # each mode's most frequent launch in the trace (bf16: both fronts of
    # every ray in the coarse phase)
    def most_frequent(mode):
        (_, what, n), _ = max(((k, c) for k, c in igr_split.items()
                               if k[0] == mode), key=lambda kc: (kc[1], kc[0][2]))
        return what == "value+grad", n

    grad16, n16 = most_frequent("bf16")
    grad32, n32 = most_frequent("f32")
    igr_err, igr_ms, igr_pms, igr_b = check_igr(n16, True, grad16)
    igr32_err, igr32_ms, igr32_pms, igr32_b = check_igr(n32, False, grad32)

    def exact(outs, refs):
        return all(torch.equal(a.reshape(-1), b.reshape(-1))
                   for a, b in zip(outs, refs))

    def exact_fine(p):
        v = fused_mlp.igr_sdf_plain(ipack, p.reshape(-1, 3), False, True)
        return v.reshape(p.shape[:-1])

    def ray_slope(args, z):
        """|df/dz| of the plain fine field along each ray at depth z."""
        d = args[1].reshape(-1, 3)
        c = torch.broadcast_to(args[0], args[1].shape).reshape(-1, 3)
        _, g = fused_mlp.igr_sdf_and_grad_plain(ipack, fma(z.reshape(-1, 1), d, c))
        return (g * d).sum(-1).abs().reshape(z.shape)

    def z_agree(z, z_ref, slope):
        """z_secant within 1e-4 of z_ref, or within IGR_F32_TOL / slope: how far
        a fine field within IGR_F32_TOL of the plain one moves a root where the
        ray meets the surface at that slope (a grazing ray's root is ill
        conditioned; a bf16 field or a wrong secant misses on most rays)."""
        dz = (z - z_ref).abs()
        return (dz <= 1e-4) | (dz * slope <= IGR_F32_TOL)

    # the coarse IGR sampler on both routes' sampler buffers: bit for bit
    # against sweep_plain over the fused callables (every point through the
    # same tensor-core tile), and against the all-plain version
    for buf in ("kernel", "plain"):
        *s_args, n_sec, s_margin, s_coarse = captured[f"sampler {buf}"]
        s_kw = dict(n_secant=n_sec, margin=s_margin, coarse_sweep=s_coarse)
        n_srays = s_args[1].reshape(-1, 3).shape[0]
        out = fine.fused_ray_sampler(*s_args, **s_kw)
        ref_f = fused_sampler.sweep_plain(fine, *s_args, n_sec, s_margin,
                                          sdf_fn_coarse=coarse if s_coarse else None)
        ref = fused_sampler.sweep_plain(
            plain_fine, *s_args, n_sec, s_margin,
            sdf_fn_coarse=plain_coarse if s_coarse else None)
        s_exact = exact(out, ref_f)
        same = (out[0] == ref[0]) & (out[2] == ref[2])
        s_frac = float(same.float().mean())
        s_ferr = float((out[1] - ref[1])[same].abs().max())
        hit = same & (ref[1] < 0)
        dz = (out[3] - ref[3]).abs()
        z_near = float((dz <= 1e-4)[hit].float().mean())
        s_zerr = float(dz[hit].max())
        slope = ray_slope(s_args, ref[3])
        z_cond = float(z_agree(out[3], ref[3], slope)[hit].float().mean())
        far = hit & (dz > 1e-4)   # the rays past the unconditioned bar
        far_slope, far_df = ((float(slope[far].max()), float((dz * slope)[far].max()))
                             if bool(far.any()) else (float("nan"),) * 2)
        # the control: the same kernel with the bf16 fine field must miss
        # the conditioned bar, or the bar cannot tell f32 from bf16
        ctl = coarse.fused_ray_sampler(*s_args, **s_kw)
        ctl_hit = hit & (ctl[0] == ref[0])
        ctl_cond = float(z_agree(ctl[3], ref[3], slope)[ctl_hit].float().mean())
        print(f"fused_sampler (IGR, coarse sweep {s_coarse}) on the {buf} trace's "
              f"{n_srays}-ray buffer x {s_args[4].shape[0]} steps + {n_sec} "
              f"secant, margin {s_margin}: all four outputs equal to sweep_plain "
              f"over the fused callables: {s_exact}; against the plain version: "
              f"picks equal on {s_frac:.5f}, f_pick err {s_ferr:.3g}, z_secant "
              f"within 1e-4 or {IGR_F32_TOL:g} / slope on {z_cond:.5f} of "
              f"{int(hit.sum())} crossing rays (the bf16 fine field: "
              f"{ctl_cond:.5f}), within 1e-4 on {z_near:.5f} (max {s_zerr:.3g}; "
              f"on the {int(far.sum())} rays past 1e-4 the slope is at most "
              f"{far_slope:.3g} and |dz|·slope at most {far_df:.3g})")
        if not s_exact:
            fail(f"fused_sampler (IGR) differs from sweep_plain over the fused "
                 f"callables on the {buf} trace's buffer")
        if s_frac < 0.99 or s_ferr > 1e-5:
            fail(f"fused_sampler (IGR coarse) disagrees with its plain version "
                 f"on the {buf} trace's buffer")
        if z_cond < 0.999:
            fail(f"fused_sampler (IGR coarse) z_secant within 1e-4 or "
                 f"{IGR_F32_TOL:g} / slope of the plain version's on only "
                 f"{z_cond:.5f} < 0.999 of crossing rays on the {buf} trace's buffer")
        if ctl_cond >= 0.999:
            fail(f"the conditioned z_secant bar passes the sampler with a bf16 "
                 f"fine field ({ctl_cond:.5f}) on the {buf} trace's buffer")
        if z_near < 0.999:
            # the sampler is sweep_plain over the fused callables bit for bit
            # (checked above): what moves z_secant is the fine field's f32
            # arithmetic (fused_igr's 3xTF32 against cuBLAS), through the
            # secant, on rays that meet the surface at a grazing angle. Both
            # against the fine field with exactly formed sums:
            ref_x = fused_sampler.sweep_plain(
                exact_fine, *s_args, n_sec, s_margin,
                sdf_fn_coarse=plain_coarse if s_coarse else None)
            near_x = [float(((o[3] - ref_x[3]).abs() <= 1e-4)[hit].float().mean())
                      for o in (out, ref)]
            print(f"  SHORTFALL of the unconditioned bar, a known fault (ROADMAP "
                  f"Queue 3): z_secant within 1e-4 of the plain version's on "
                  f"{z_near:.5f} < 0.999 of crossing rays; of the exactly summed "
                  f"fine field's: the kernel on {near_x[0]:.5f}, the plain "
                  f"version on {near_x[1]:.5f}")
        if buf == "kernel":   # the path's own buffer: the row of the JSON line
            sk_args, sk_kw, sk_err = s_args, s_kw, max(s_ferr, s_zerr)
            sk_rays, sk_steps = n_srays, s_args[4].shape[0]
    cs_ms = time_ms(lambda: fine.fused_ray_sampler(*sk_args, **sk_kw))
    cs_pms = time_ms(lambda: fused_sampler.sweep_plain(
        plain_fine, *sk_args, sk_kw["n_secant"], sk_kw["margin"],
        sdf_fn_coarse=plain_coarse if sk_kw["coarse_sweep"] else None))
    # the sweep's evals bf16, the 2 + n_secant fine ones f32: three tf32
    # passes each
    cs_b = (1e3 * max(igr_flops * sk_rays * sk_steps / BF16_PEAK
                      + 3 * igr_flops * sk_rays * (2 + sk_kw["n_secant"]) / TF32_PEAK,
                      (sk_rays * 48 + 4 * sk_steps + 2 * igr_w_bytes) / HBM_RATE),
            "operations")
    print(f"  kernel {cs_ms:.3f} ms  plain {cs_pms:.3f} ms  bound {cs_b[0]:.4f} ms "
          f"(the kernel trace's buffer)")

    m_args = captured["stepper"]
    cam_m, dirs_m, st_m, n_it = m_args[0], m_args[1], m_args[2], m_args[3]
    n_mrays = st_m[0].numel()
    m_out = fine.fused_trace_stepper(*m_args)
    m_ref = march_plain(plain_fine, cam_m.reshape(-1, 3), dirs_m.reshape(-1, 3),
                        [s.reshape(-1) for s in st_m], *m_args[3:])
    # bit for bit against the loop over the fused f32 callable
    m_exact = exact(m_out, march_plain(fine, cam_m.reshape(-1, 3),
                                       dirs_m.reshape(-1, 3),
                                       [s.reshape(-1) for s in st_m], *m_args[3:]))
    m_eq = min(float((a.reshape(-1) == b).float().mean())
               for a, b in zip(m_out[4:8], m_ref[4:8]))
    m_close = min(float(((a.reshape(-1) - b).abs() <= 1e-5).float().mean())
                  for a, b in zip(m_out[:2], m_ref[:2]))
    m_err = max(float((a.reshape(-1) - b).abs().max()) for a, b in zip(m_out[:2], m_ref[:2]))
    print(f"trace_march on the trace's first compacted stage: {n_mrays} rays x "
          f"{n_it} iterations: all ten state arrays equal to march_plain over "
          f"the fused f32 callable: {m_exact}; against the plain version: "
          f"masks/bk equal on {m_eq:.6f}, depths within 1e-5 on {m_close:.6f} "
          f"(max diff {m_err:.3g})")
    if not m_exact:
        fail("trace_march differs from march_plain over the fused callable")
    if m_eq < 0.999 or m_close < 0.999:
        fail("trace_march disagrees with its plain version")
    mk_ms = time_ms(lambda: fine.fused_trace_stepper(*m_args))
    mk_pms = time_ms(lambda: march_plain(
        plain_fine, cam_m.reshape(-1, 3), dirs_m.reshape(-1, 3),
        [s.reshape(-1) for s in st_m], *m_args[3:]))
    mk_b = bound_ms(3 * igr_flops * 2 * n_it * n_mrays,
                    n_mrays * (24 + 2 * 34) + igr_w_bytes, TF32_PEAK)
    print(f"  kernel {mk_ms:.3f} ms  plain {mk_pms:.3f} ms  bound {mk_b[0]:.4f} ms ({mk_b[1]})")

    # the f32 tile's sums against exactly formed ones (float64 sums rounded
    # once, `exact_sums`), beside cuBLAS's float32 sums (TF32 off) on the same
    # points: the sampler's fine evaluations (bracket re-validation and
    # secant steps) on both trace buffers, and the f32 mode's most frequent
    # launch in the trace
    def fine_points(buf):
        *f_args, n_sec, f_margin, f_coarse = captured[f"sampler {buf}"]
        pts = []

        def recording_fine(p):
            pts.append(p.reshape(-1, 3).clone())
            return fine(p)
        fused_sampler.sweep_plain(recording_fine, *f_args, n_sec, f_margin,
                                  sdf_fn_coarse=coarse if f_coarse else None)
        return torch.cat(pts)

    print(f"f32 tile against exact sums: RMS and max |err| of the values "
          f"against exactly summed ones, and the share within 1e-6; fatal if "
          f"the tile's RMS exceeds {F32_EXACT_RATIO} x cuBLAS's (float32, TF32 "
          f"off) on the same points")
    for label, p in (("the kernel trace's sampler fine points", fine_points("kernel")),
                     ("the plain trace's sampler fine points", fine_points("plain")),
                     (f"{n32} points in [-1.2, 1.2]^3 (the f32 mode's most "
                      f"frequent trace launch)",
                      torch.rand((n32, 3), generator=gen, device=dev) * 2.4 - 1.2)):
        ex = fused_mlp.igr_sdf_plain(ipack, p, False, True)
        stats = []
        for v in (fine(p), fused_mlp.igr_sdf_plain(ipack, p)):
            e = (v - ex).abs()
            stats.append((float(e.square().mean().sqrt()), float(e.max()),
                           float((e <= 1e-6).float().mean())))
        ratio = stats[0][0] / stats[1][0]
        print(f"  {label} ({p.shape[0]}): tile RMS {stats[0][0]:.4g}, max "
              f"{stats[0][1]:.4g}, within 1e-6 {stats[0][2]:.6f}; cuBLAS RMS "
              f"{stats[1][0]:.4g}, max {stats[1][1]:.4g}, within 1e-6 "
              f"{stats[1][2]:.6f}; RMS ratio {ratio:.4f}")
        if not ratio <= F32_EXACT_RATIO:
            fail(f"the f32 tile's RMS error against exact sums on {label} is "
                 f"{ratio:.4f} x cuBLAS's (bar {F32_EXACT_RATIO})")

    # ---- 8. the splat path at bench.py's size
    scene = bench.splat_scene(bench.N_SPLATS, bench.SPLAT_IMAGE_SIZE, dev)
    sst = scene.settings
    S, T, K = sst.image_size, sst.tile_size, sst.points_per_pixel
    plain_st = dataclasses.replace(sst, use_pallas=False, use_pallas_backward=False)
    # the kNN at the frame's shape, and the plain route's spacing from the
    # plain kNN (splat_spacing follows use_pallas)
    knn_case(scene.points, scene.mask, sst.knn_k - 1, "splat frame cloud",
             timed=True)
    plain_scene = scene._replace(spacing=splat_spacing(scene.points, scene.mask,
                                                       plain_st))
    sp_err = float((plain_scene.spacing - scene.spacing).abs().max())
    if sp_err > 1e-6:
        fail(f"splat spacing: kernel and plain kNN differ by {sp_err} (tol 1e-6)")
    reset()
    loss_k, grad_k, gndc_k, fr_k = bench.splat_step(scene)
    torch.cuda.synchronize()
    splat_launches = counts()
    print(f"splat path ({bench.N_SPLATS} splats @ {S} px, strip "
          f"{sst.max_points_per_strip}): launches in one forward+backward frame "
          f"{splat_launches}")
    for name, n in splat_launches.items():
        want = 1 if name in ("splat_select", "splat_fine", "splat_zbuf_bwd",
                             "occ_bwd") else 0
        if n != want:
            fail(f"splat frame: {name} launched {n} times (expected {want})")
    reset()
    loss_p, grad_p, gndc_p, fr_p = bench.splat_step(plain_scene, plain_st)
    torch.cuda.synchronize()
    if any(counts().values()):
        fail(f"the plain splat frame launched kernels: {counts()}")
    for name in ("idx", "zbuf", "occupancy", "visibility", "tile_overflow"):
        if not torch.equal(getattr(fr_k, name), getattr(fr_p, name)):
            fail(f"splat frame: {name} differs between the kernels and the plain "
                 f"versions")
    q_err = float((fr_k.qvalue - fr_p.qvalue).detach().abs().max())
    splat_ovf = int(fr_k.tile_overflow.sum())
    # the rasterizer's gradient (d loss / d pts_ndc) and the points' one
    xy = grad_check(gndc_k[..., :2], gndc_p[..., :2])
    gz_k, gz_p = gndc_k[..., 2], gndc_p[..., 2]
    z_rel = float(((gz_k - gz_p).abs() / gz_p.abs().clamp(min=1e-30))[gz_p != 0].max())
    z_zero = torch.equal(gz_k == 0, gz_p == 0)
    wg = grad_check(grad_k, grad_p)
    print(f"splat tolerances: fragment maps equal (qvalue |err| <= 1e-6), spacing "
          f"within 1e-6; of d loss / d pts_ndc, xy {GRAD_TOL} (the occupancy sums "
          f"in another order) and z within 1e-5 relative (index_add_'s order); "
          f"d loss / d points {GRAD_TOL}; overflow 0")
    print(f"splat frame, kernels vs plain versions: loss {float(loss_k):.9g} vs "
          f"{float(loss_p):.9g}; maps equal, qvalue err {q_err:.3g}, spacing err "
          f"{sp_err:.3g}; d/d pts_ndc: xy {xy[0]}, z max rel err {z_rel:.3g}; "
          f"d/d points {wg[0]}; {int(fr_k.visibility.sum())} visible splats; "
          f"overflow {splat_ovf}")
    if (q_err > 1e-6 or not xy[1] or z_rel > 1e-5 or not z_zero or not wg[1]
            or splat_ovf or not torch.isfinite(grad_k).all()):
        fail("splat frame: kernels and plain versions disagree beyond the "
             "stated tolerance, or capacities overflowed")

    # the two backward kernels' inputs, rebuilt from the frame as the
    # backward forms them: the fine stage's slots (int32) and candidates, the
    # loss's cotangents (1 where zbuf > 0; 1 on the occupancy) and the
    # visible, renderable points of the cloud
    with torch.no_grad():
        sp = compute_splat_params(scene.points, scene.normals, scene.mask,
                                  scene.camera, sst, spacing=scene.spacing)
        fr_b, slots_b, cand_b = _rasterize_forward(sp.pts_ndc, sp.ellipse,
                                                   sp.radii, sp.cutoff, sp.mask, sst)
    if not torch.equal(fr_b.idx, fr_k.idx):
        fail("splat frame: the rebuilt forward differs from the frame's")
    # the selection and the fine stage at the frame's shape, timed
    sel_frame, fine_frame = check_raster(
        *stage_inputs(sp.pts_ndc, sp.ellipse, sp.radii, sp.cutoff, sp.mask, sst),
        "splat frame", K=K, depth_merge=sst.depth_merging_threshold, timed=True)
    zb_m, n_pts = cand_b.shape[-1], bench.N_SPLATS
    zb_args = (slots_b, (fr_b.zbuf > 0).float(), cand_b, n_pts)
    zk, zt = splat.zbuf_backward_points_cuda(*zb_args, tile_sums=True)
    if not torch.equal(zt, splat.zbuf_backward_points_cuda(*zb_args,
                                                           tile_sums=True)[1]):
        fail("splat_zbuf_bwd: two runs' tile sums on the same inputs differ")
    # the rebuilt inputs are the frame's: the point sums are the frame's z
    # gradient (within the atomics' order)
    if not torch.allclose(zk, gz_k, rtol=1e-5, atol=0):
        fail("splat_zbuf_bwd: the rebuilt inputs do not give the frame's z gradient")
    zb_tiles_in = splat.to_tiles(zb_args[1], T)
    zt_err = float((zt - splat.zbuf_backward_tile_plain(
        slots_b.reshape(-1, T * T, K), zb_tiles_in, zb_m)).abs().max())
    zb_sc = torch.zeros(n_pts, device=dev).index_add_(0, cand_b.reshape(-1),
                                                      zt.reshape(-1))
    zb_ref = splat.zbuf_backward_points_plain(*zb_args)
    zb_err = float((zk - zb_ref).abs().max())
    # the library yardstick: one index_add_ of every fragment straight to its
    # point (the forward's idx map; empty fragments to a dummy row P)
    n_cl = slots_b.shape[0]
    lib_idx = (torch.where(fr_b.idx >= 0, fr_b.idx, n_pts)
               + torch.arange(n_cl, device=dev)[:, None, None, None] * (n_pts + 1)
               ).reshape(-1)
    lib_src = zb_args[1].reshape(-1)
    lib_zb = lambda: torch.zeros(n_cl * (n_pts + 1), device=dev).index_add_(
        0, lib_idx, lib_src)
    lib_err = float((lib_zb().reshape(n_cl, -1)[:, :n_pts] - zk).abs().max())
    # the yardstick of the tile-sums-only design, for continuity: a
    # per-tile scatter_add_ over (n_tiles, M + 1)
    old_sl = slots_b.reshape(-1, T * T * K)
    old_idx = torch.where(old_sl >= 0, old_sl, zb_m).long()
    old_src = zb_tiles_in.reshape(old_sl.shape)
    old_zb = lambda: torch.zeros((old_sl.shape[0], zb_m + 1), device=dev
                                 ).scatter_add_(1, old_idx, old_src)
    if (zt_err > 1e-5 or not torch.allclose(zk[0], zb_sc, rtol=1e-5, atol=0)
            or not torch.allclose(zk, zb_ref, rtol=1e-5, atol=0) or lib_err > 1e-5
            * max(1.0, float(zb_ref.abs().max()))):
        fail(f"splat_zbuf_bwd: tile sums err {zt_err} (tol 1e-5); points err "
             f"{zb_err} against the plain version, {lib_err} against index_add_ "
             f"(rtol 1e-5)")

    # the occupancy backward on the frame's inputs: the all-ones cotangent of
    # Σ occupancy, expanded as autograd hands it over
    occ_args = (sp.pts_ndc, sp.radii, fr_b.visibility & sp.mask,
                torch.ones((1, 1, 1), device=dev).expand(1, S, S), sst)
    occ_row = check_occ(occ_args, "the splat frame's inputs, all-ones cotangent")
    if not torch.equal(occ_row[5], gndc_k[..., :2]):
        fail("occ_bwd: the rebuilt inputs do not give the frame's xy gradient")

    # the zbuf row timed as the path calls it, wrapper included; its kernel
    # alone from the profiler's trace of one frame
    zb_ms = time_ms(lambda: splat.zbuf_backward_points_cuda(*zb_args))
    zb_pms = time_ms(lambda: splat.zbuf_backward_points_plain(*zb_args))
    zb_lib_ms = time_ms(lib_zb)
    zb_old_ms = time_ms(old_zb)
    prof = bench.profile_call(lambda: bench.splat_step(scene), dev,
                              "splat frame with the kernels")
    alone = lambda tag: sum(ms for key, ms, _ in prof["kernels"] if tag in key)
    alone_txt = lambda ms: f"{ms:.4f} ms" if ms > 0 else "not measured"
    scatters = [key for key, _, _ in prof["kernels"]
                if "index_add" in key or "indexFunc" in key]
    if scatters:
        fail(f"the profiled splat frame still runs an index_add_: {scatters}")
    n_frag = slots_b.numel()
    n_hit = int(torch.zeros((old_sl.shape[0], zb_m + 1), device=dev).scatter_(
        1, old_idx, 1.0)[:, :zb_m].sum())
    # slot (i32) and cotangent (f32) read per fragment, a point id (i64) per
    # hit slot, the (B, P) gradient written once
    zb_b = bound_ms(0.0, 8.0 * n_frag + 8.0 * n_hit + 4.0 * n_cl * n_pts)
    print(f"splat_zbuf_bwd on the frame's {old_sl.shape[0]} tiles x {T * T} px x "
          f"{K} (M={zb_m}, {n_hit} slots hit) to {n_pts} points: tile sums "
          f"repeat bit-identical, err {zt_err:.3g}; points err {zb_err:.3g}  "
          f"wrapper {zb_ms:.4f} ms (kernel alone "
          f"{alone_txt(alone('zbuf_points_kernel'))})  plain {zb_pms:.3f} ms  "
          f"index_add_ per fragment {zb_lib_ms:.4f} ms (tile sums alone by a "
          f"per-tile scatter_add_ {zb_old_ms:.4f} ms)  bound {zb_b[0]:.4f} ms ({zb_b[1]}); "
          f"no index_add_ in the profiled frame")
    frame_ms = bench.time_frames(lambda: bench.splat_step(scene), dev, reps=5)
    plain_frame_ms = bench.time_frames(
        lambda: bench.splat_step(plain_scene, plain_st), dev, reps=3)
    spacing_ms = bench.time_frames(lambda: splat_spacing(
        scene.points, scene.mask, sst), dev, reps=5)
    print(f"splat_fwd_bwd_points_per_s: {bench.N_SPLATS / frame_ms * 1e3:.0f} "
          f"({frame_ms:.3f} ms/frame with the kernels, median of 5 runs of "
          f"{bench.SPLAT_REP} frames; {plain_frame_ms:.3f} ms with every plain "
          f"version; +{spacing_ms:.3f} ms kNN spacing per point-set refresh)")

    # ---- 9. the DSS point model through the factories
    ps = point_scene.point_model_scene(dev)
    pcfg, pmodel, pcam = ps.cfg, ps.model, ps.camera
    n_pm = pmodel.cfg.n_points_per_cloud
    # the kNN of the model's splat spacing, at the shape its forward gives
    # it: the cloud in every view
    nv = pcam.batch_size
    knn_case(pmodel.points.detach().expand(nv, -1, -1),
             torch.ones((nv, n_pm), dtype=torch.bool, device=dev),
             pmodel.raster_settings.knn_k - 1, "point model cloud")
    point_step = lambda m: point_scene.point_model_step(ps, m)

    # the step's occupancy backward: its calls and their inputs (the
    # signed cotangent of the DSS loss), recorded where the rasterizer's
    # backward calls it
    reset()
    (pl_k, pg_k, pout), occ_calls = point_scene.record_occ_calls(
        lambda: point_step(pmodel))
    torch.cuda.synchronize()
    point_launches = counts()
    plain_pm = create_model(pcfg, device=dev)
    plain_pm.load_state_dict(pmodel.state_dict())
    plain_pm.raster_settings = dataclasses.replace(
        pmodel.raster_settings, use_pallas=False, use_pallas_backward=False)
    reset()
    pl_p, pg_p, _ = point_step(plain_pm)
    torch.cuda.synchronize()
    if any(counts().values()):
        fail(f"the plain point model step launched kernels: {counts()}")
    print(f"point model (dss_point.yml, {n_pm} points, {nv} views at "
          f"{pmodel.raster_settings.image_size} px): loss kernels "
          f"{float(pl_k):.9g} plain {float(pl_p):.9g}; launches {point_launches}; "
          f"in-mask {float(pout.inmask.float().mean()):.4f}, visible "
          f"{int(pout.visibility.sum())}")
    for name in ("knn", "splat_select", "splat_fine", "splat_zbuf_bwd", "occ_bwd"):
        if point_launches[name] <= 0:
            fail(f"kernel {name} was not launched by the point model's step")
    if len(occ_calls) != 1 or point_launches["occ_bwd"] != 1:
        fail(f"point model: the {nv}-view step made {len(occ_calls)} occupancy "
             f"calls and {point_launches['occ_bwd']} C calls (expected one each)")
    if abs(float(pl_k) - float(pl_p)) > 1e-5 * abs(float(pl_p)):
        fail("point model: kernel and plain losses differ beyond rtol 1e-5")
    for k in ("points", "normals_azim", "normals_elev", "colors"):
        a, b = pg_k[k], pg_p[k]
        if a is None or not torch.isfinite(a).all() or not bool((a != 0).any()):
            fail(f"point model: gradient of {k} is missing, non-finite or zero")
        gc = grad_check(a, b)
        print(f"  grad {k}, kernels vs plain: {gc[0]}")
        if not gc[1]:
            fail(f"point model: {k} gradient beyond {GRAD_TOL}")
    if any(g["log_size"] is not None and bool((g["log_size"] != 0).any())
           for g in (pg_k, pg_p)):
        fail("point model: log_size got a non-zero gradient")
    pm_occ = check_occ(occ_calls[0], "the point model step's own inputs, its "
                       "signed cotangent")
    point_ms = bench.time_frames(lambda: point_step(pmodel), dev, reps=5)
    print(f"point model step (forward + backward): {point_ms:.3f} ms (median of "
          f"5 runs of {bench.SPLAT_REP})")

    # ---- 10. the uni arm's SIREN schedule with the neural texture
    # fused_mlp's launches in the run by (mode, rows, points), and the
    # sampler's by (sweep, rays, steps)
    uni_mlp = collections.Counter()
    uni_smp = collections.Counter()
    sweep_cuda = fused_sampler.sweep_cuda
    traces = []   # the warm-up steps' ray_trace calls, as (args, kwargs)
    implicit_trace = implicit_mod.ray_trace

    def recording_siren_modes(pack, x, with_grad, bf16=False):
        uni_mlp[("bf16" if bf16 else "f32", "value+grad" if with_grad else "value",
                 x.shape[0])] += 1
        return siren_cuda(pack, x, with_grad, bf16)

    def recording_sweep_cuda(pack, cam, dirs, t_lo, t_hi, steps, n_secant, margin,
                             coarse_sweep=False, fine_bf16=False):
        uni_smp[("coarse" if coarse_sweep else "fine", dirs.shape[0],
                 steps.shape[0])] += 1
        return sweep_cuda(pack, cam, dirs, t_lo, t_hi, steps, n_secant, margin,
                          coarse_sweep, fine_bf16)

    def recording_trace(*args, **kw):
        traces.append((args, kw))
        return implicit_trace(*args, **kw)

    fused_mlp.siren_forward_cuda = recording_siren_modes
    fused_sampler.sweep_cuda = recording_sweep_cuda
    implicit_mod.ray_trace = recording_trace
    try:
        (u_cfg, u_trainer, u_state, u_batch, u_ms, u_metrics, u_per_step,
         u_launches, u_keys, _) = run_steps("mvr_uni_siren.yml", 2 + 1 + N_UNI_PROJECTED)
    finally:
        fused_mlp.siren_forward_cuda = siren_cuda
        fused_sampler.sweep_cuda = sweep_cuda
        implicit_mod.ray_trace = implicit_trace
    u_warm = u_trainer.cfg.warm_up_iters
    print(f"uni SIREN path (mvr_uni_siren.yml): warm-up median "
          f"{statistics.median(u_ms[:u_warm]):.2f} ms over {u_warm} steps, resample "
          f"step (it={u_warm}) {u_ms[u_warm]:.1f} ms, projected median "
          f"{statistics.median(u_ms[u_warm + 1:]):.2f} ms over "
          f"{len(u_ms) - u_warm - 1} steps; launches in the run: {u_launches}")
    for i, p in enumerate(u_per_step):
        kind = ("warm-up" if i < u_warm else "resample" if i == u_warm
                else "projected")
        print(f"  step {i} ({kind}): launches {p}")
    print(f"  fused_mlp launches in the run: {u_launches['fused_mlp']} = " + ", ".join(
        f"{c} x {mode} {what} n={n}" for (mode, what, n), c in uni_mlp.most_common()))
    print(f"  fused_sampler launches in the run: {u_launches['fused_sampler']} = "
          + ", ".join(f"{c} x {sw} sweep, {r} rays x {ns} steps"
                      for (sw, r, ns), c in uni_smp.most_common()))
    uni_modes = collections.Counter()
    for (mode, _, _), c in uni_mlp.items():
        uni_modes[mode] += c
    if sum(uni_mlp.values()) != u_launches["fused_mlp"] or min(
            uni_modes["bf16"], uni_modes["f32"]) <= 0:
        fail(f"fused_mlp's launches on the uni path {dict(uni_mlp)} do not add up "
             f"to its counter or miss a mode")
    uni_coarse = sum(c for (sw, _, _), c in uni_smp.items() if sw == "coarse")
    if sum(uni_smp.values()) != u_launches["fused_sampler"] or uni_coarse <= 0:
        fail(f"fused_sampler's launches on the uni path {dict(uni_smp)} do not add "
             f"up to its counter or hold no coarse sweep")
    for name in ("fused_mlp", "fused_sampler", "knn", "splat_select", "splat_fine"):
        if u_launches[name] <= 0:
            fail(f"kernel {name} was not launched on the uni path")
    for i, p in enumerate(u_per_step):
        if i < u_warm and (p["fused_mlp"] <= 0 or p["fused_sampler"] <= 0):
            fail(f"uni warm-up step {i} launched {p}")
        if i > u_warm and (p["splat_select"], p["splat_fine"], p["splat_zbuf_bwd"],
                           p["occ_bwd"]) != (2, 2, 0, 0):
            fail(f"uni projected step {i} launched {p}: expected 2 selection and 2 "
                 f"fine launches and no backward")
    u_iso = [m["n_iso"] for m in u_metrics[u_warm:]]
    if min(u_iso) <= 0 or u_state.points.shape[1] != u_cfg.model.combined_kwargs.max_iso_per_batch:
        fail(f"uni projected steps found no iso-points: n_iso {u_iso}")
    # one warm-up and one projected step with the kernels and plain on
    # identical draws, the texture's gradients of both
    kernels_vs_plain(u_cfg, u_trainer, u_state, u_batch, 0, u_keys, project=False)
    kernels_vs_plain(u_cfg, u_trainer, u_state, u_batch, len(u_ms), u_keys,
                     project=True)

    # the first warm-up step's trace three ways: the kernels, again with the
    # SIREN march (`trace_in_kernel`), and every plain version
    (t_f, t_cam, t_dirs, t_gt, t_u, t_cfg), t_kw = traces[0]
    t_c = t_kw["sdf_fn_coarse"]
    if not (isinstance(t_f, fused_mlp.FusedSirenSDF) and t_c is not None
            and t_c.precision == "bf16"):
        fail("the uni warm-up trace did not run on the fused f32 and bf16 SIREN "
             "callables")
    t_pf, t_pc = fused_mlp.PlainSDF(t_f.pack), fused_mlp.PlainSDF(t_f.pack, "bf16")
    t_cfg_m = dataclasses.replace(t_cfg, trace_in_kernel=True)
    u_captured = {}
    u_sampler, u_stepper = t_f.fused_ray_sampler, t_f.fused_trace_stepper

    def u_recording_sampler(*args, n_secant, margin, coarse_sweep):
        if n_secant > 0:
            u_captured.setdefault("sampler", args + (n_secant, margin, coarse_sweep))
        return u_sampler(*args, n_secant=n_secant, margin=margin,
                         coarse_sweep=coarse_sweep)
    u_recording_sampler.packing_stride = u_sampler.packing_stride

    def u_recording_stepper(*args):
        u_captured.setdefault("stepper", args)
        return u_stepper(*args)

    def u_traced(fn, fn_c, cfg, label, must_launch):
        reset()
        with torch.no_grad():
            res = raytracing.ray_trace(fn, t_cam, t_dirs, t_gt, t_u, cfg,
                                       training=t_kw.get("training", True),
                                       sdf_fn_coarse=fn_c)
        torch.cuda.synchronize()
        got = counts()
        print(f"uni trace ({label}): launches {got}; hits "
              f"{int(res.network_object_mask.sum())} of {res.dists.numel()}, "
              f"sampler rays {int(res.sampler_mask.sum())}, overflow trace "
              f"{int(res.trace_overflow)} sampler {int(res.sampler_overflow)}")
        for name in must_launch:
            if got[name] <= 0:
                fail(f"kernel {name} was not launched on the uni trace ({label})")
        for name in set(got) - set(must_launch):
            if got[name] != 0:
                fail(f"kernel {name} launched on the uni trace ({label})")
        return res

    t_f.fused_ray_sampler = u_recording_sampler
    try:
        ur_k = u_traced(t_f, t_c, t_cfg, "fused MLP + sampler",
                        ("fused_mlp", "fused_sampler"))
    finally:
        t_f.fused_ray_sampler = u_sampler
    t_f.fused_trace_stepper = u_recording_stepper
    try:
        ur_m = u_traced(t_f, t_c, t_cfg_m, "+ in-kernel SIREN march",
                        ("fused_mlp", "fused_sampler", "trace_march"))
        u_march_launches = counts()["trace_march"]
    finally:
        t_f.fused_trace_stepper = u_stepper
    ur_p = u_traced(t_pf, t_pc, t_cfg, "every plain version", ())
    t_thr = t_cfg.sdf_threshold
    for res, label in ((ur_k, "kernels"), (ur_m, "march"), (ur_p, "plain")):
        if int(res.trace_overflow) or int(res.sampler_overflow):
            fail(f"uni trace ({label}): overflow trace {int(res.trace_overflow)} "
                 f"sampler {int(res.sampler_overflow)}")
        # a training trace moves the points of out-of-mask rays to their
        # min-SDF points: the invariant holds for the in-mask hits
        conv = res.network_object_mask & ~res.sampler_mask & t_gt
        f_conv = (t_f if label != "plain" else t_pf)(res.points[conv])
        slack = 0.0 if label != "plain" else 1e-6
        n_bad = int((f_conv > t_thr + slack).sum())
        worst = float(f_conv.max()) if f_conv.numel() else float("-inf")
        print(f"uni converged-ray invariant ({label}): {int(conv.sum())} rays, max "
              f"f_fine {worst:.6g} (thr {t_thr:g}, slack {slack:g}), {n_bad} above")
        if n_bad or not torch.isfinite(res.dists).all():
            fail(f"uni trace ({label}): {n_bad} converged rays with f_fine > thr")
    um_exact = (torch.equal(ur_k.network_object_mask, ur_m.network_object_mask)
                and torch.equal(ur_k.sampler_mask, ur_m.sampler_mask)
                and torch.equal(ur_k.dists, ur_m.dists))
    u_same = ((ur_k.network_object_mask == ur_p.network_object_mask)
              & (ur_k.sampler_mask == ur_p.sampler_mask))
    u_hit_agree = float((ur_k.network_object_mask == ur_p.network_object_mask)
                        .float().mean())
    u_d_close = float(((ur_k.dists - ur_p.dists).abs() <= 1e-4)[u_same].float().mean())
    print(f"uni trace: the SIREN march route equals the loop route (masks and "
          f"depths, tolerance 0): {um_exact}; kernels vs plain: hit masks agree on "
          f"{u_hit_agree:.6f}, depths within 1e-4 on {u_d_close:.6f} of equal-mask "
          f"rays (tolerances as phase 6)")
    if not um_exact:
        fail("the SIREN march route differs from the loop route")
    if u_hit_agree < 0.995 or float(u_same.float().mean()) < 0.995 or u_d_close < 0.99:
        fail("the uni kernel and plain traces disagree beyond the stated tolerance")
    u_trace_times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            raytracing.ray_trace(t_f, t_cam, t_dirs, t_gt, t_u, t_cfg,
                                 training=t_kw.get("training", True),
                                 sdf_fn_coarse=t_c)
        torch.cuda.synchronize()
        u_trace_times.append(1e3 * (time.perf_counter() - t0))
    u_trace_ms = statistics.median(u_trace_times)

    # the three kernel instances at full width against their plain versions
    spack = t_f.pack
    s_flops = mlp_flops(1, spack.hidden, spack.n_hidden)
    s_w_bytes = 4 * sum(w.numel() + b.numel() for w, b in zip(spack.ws, spack.bs))

    def check_siren_bf16(n, with_grad):
        x = torch.rand((n, 3), generator=gen, device=dev) * 2 - 1
        fn = t_c
        if with_grad:
            out = fn.sdf_and_grad(x)
            ref = fused_mlp.siren_sdf_and_grad_plain(spack, x, True)
            own = fused_mlp.siren_sdf_and_grad_plain(spack, x)
            ex = fused_mlp.siren_sdf_and_grad_plain(spack, x, True, True)
            run_k = lambda: fn.sdf_and_grad(x)
            run_p = lambda: fused_mlp.siren_sdf_and_grad_plain(spack, x, True)
        else:
            out, ref = (fn(x),), (fused_mlp.siren_sdf_plain(spack, x, True),)
            own = (fused_mlp.siren_sdf_plain(spack, x),)
            ex = (fused_mlp.siren_sdf_plain(spack, x, True, True),)
            run_k = lambda: fn(x)
            run_p = lambda: fused_mlp.siren_sdf_plain(spack, x, True)
        errs = [float((a - b).abs().max()) for a, b in zip(out, ref)]
        own_err = [float((a - b).abs().max()) for a, b in zip(ref, own)]
        share = lambda us, vs: min(float(((u - v).abs() <= 1e-5).float().mean())
                                   for u, v in zip(us, vs))
        near_k, near_p = share(out, ex), share(ref, ex)
        print(f"fused_mlp SIREN bf16 {'value+grad' if with_grad else 'value'} n={n}: "
              f"max_abs_err {max(errs):.3g} (the mode's own error against f32 "
              f"{max(own_err):.3g}); within 1e-5 of the exact sums on {near_k:.5f} "
              f"(the plain version on {near_p:.5f})")
        if not all(torch.isfinite(a).all() for a in out) or any(
                e > o for e, o in zip(errs, own_err)) or near_k < min(0.99, near_p):
            fail(f"fused_mlp SIREN bf16: errs {errs} (tol {own_err}), {near_k:.5f} "
                 f"within 1e-5 of the exact sums (tol 0.99 or {near_p:.5f})")
        ms, plain_ms = time_ms(run_k), time_ms(run_p)
        b = bound_ms(s_flops * n * (4 if with_grad else 1),
                     n * (12 + (16 if with_grad else 4)) + s_w_bytes, BF16_PEAK)
        print(f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {b[0]:.4f} ms "
              f"({b[1]}, bf16 peak)")
        return max(errs), ms, plain_ms, b

    print("SIREN bf16 tolerances (fused_mlp's bf16 mode, as phase 7 holds IGR's): "
          "|err| <= the mode's own max error against f32 on the same points, and "
          "within 1e-5 of the exactly summed bf16 mode on >= 99% of outputs or on "
          "as many as the plain version is")
    for grad in (False, True):
        check_siren_bf16(262_144, grad)
    (_, sb_what, sb_n), _ = max(((k, c) for k, c in uni_mlp.items() if k[0] == "bf16"),
                                key=lambda kc: (kc[1], kc[0][2]))
    sb_err, sb_ms, sb_pms, sb_b = check_siren_bf16(sb_n, sb_what == "value+grad")

    def bracketed(fine, args, out):
        """Rays whose picked bracket [z_low, t_pick] holds a root of `fine`,
        f(z_low) > 0 > f(t_pick), z_low the proposal before the pick. The
        coarse pick is the first step below -margin, so its re-validated
        ends may both lie inside (on the random-init field of a first step,
        |f| ~ 0.03, most do): the secant then extrapolates from two values
        of one sign, and no version's z_secant is a root."""
        d = args[1].reshape(-1, 3)
        c = torch.broadcast_to(args[0], args[1].shape).reshape(-1, 3)
        lo, hi = args[2].reshape(-1), args[3].reshape(-1)
        ts = fma(args[4], (hi - lo)[:, None], lo[:, None])
        idx = torch.argmax((ts == out[0].reshape(-1, 1)).int(), dim=-1)
        z_low = torch.gather(ts, 1, (idx - 1).clamp(min=0)[:, None])[:, 0]
        f_low = fine(fma(z_low[:, None], d, c))
        return ((f_low > 0) & (out[1].reshape(-1) < 0)).reshape(out[1].shape)

    def siren_slope(args, z):
        """|df/dz| of the plain f32 SIREN along each ray at depth z."""
        d = args[1].reshape(-1, 3)
        c = torch.broadcast_to(args[0], args[1].shape).reshape(-1, 3)
        _, g = t_pf.sdf_and_grad(fma(z.reshape(-1, 1), d, c))
        return (g * d).sum(-1).abs().reshape(z.shape)

    *us_args, us_nsec, us_margin, us_coarse = u_captured["sampler"]
    us_rays = us_args[1].reshape(-1, 3).shape[0]
    us_steps = us_args[4].shape[0]
    if not us_coarse:
        fail("the uni trace's sampler did not sweep coarse")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for coarse_sw, margin in ((True, us_margin), (False, 0.0)):
        kw = dict(n_secant=us_nsec, margin=margin, coarse_sweep=coarse_sw)
        out = t_f.fused_ray_sampler(*us_args, **kw)
        ref_f = fused_sampler.sweep_plain(t_f, *us_args, us_nsec, margin,
                                          sdf_fn_coarse=t_c if coarse_sw else None)
        ref = fused_sampler.sweep_plain(t_pf, *us_args, us_nsec, margin,
                                        sdf_fn_coarse=t_pc if coarse_sw else None)
        s_exact = all(torch.equal(a.reshape(-1), b.reshape(-1)) for a, b in zip(out, ref_f))
        same = (out[0] == ref[0]) & (out[2] == ref[2])
        frac = float(same.float().mean())
        ferr = float((out[1] - ref[1])[same].abs().max())
        cross = same & (ref[1] < 0)
        hit = cross & bracketed(t_pf, us_args, ref)
        dz = (out[3] - ref[3]).abs()
        slope = siren_slope(us_args, ref[3])
        ok_z = (dz <= 1e-4) | (dz * slope <= IGR_F32_TOL)
        cond = float(ok_z[hit].float().mean())
        cond_all = float(ok_z[cross].float().mean())
        near = float((dz <= 1e-4)[hit].float().mean())
        if int(hit.sum()) < 100:
            fail(f"fused_sampler (SIREN, coarse {coarse_sw}): only {int(hit.sum())} "
                 f"of {int(cross.sum())} crossing rays hold a root in their bracket")
        line = (f"fused_sampler (SIREN, coarse sweep {coarse_sw}) on the uni trace's "
                f"{us_rays}-ray buffer x {us_steps} steps + {us_nsec} secant, margin "
                f"{margin} ({fused_sampler.rays_per_block(us_rays, us_steps, us_nsec, coarse_sw, n_sms)} "
                f"rays a block): all four outputs equal to sweep_plain over the "
                f"fused callables: {s_exact}; against the plain version: picks "
                f"equal on {frac:.5f}, f_pick err {ferr:.3g}, z_secant within 1e-4 "
                f"or {IGR_F32_TOL:g} / slope on {cond:.5f} of the {int(hit.sum())} "
                f"crossing rays whose bracket holds the root (within 1e-4 on "
                f"{near:.5f}; the conditioned bar on all {int(cross.sum())} "
                f"crossing rays: {cond_all:.5f})")
        if coarse_sw:
            ctl = t_c.fused_ray_sampler(*us_args, **kw)
            ctl_hit = hit & (ctl[0] == ref[0])
            dzc = (ctl[3] - ref[3]).abs()
            ctl_cond = float(((dzc <= 1e-4) | (dzc * slope <= IGR_F32_TOL))[ctl_hit]
                             .float().mean())
            line += f"; the bf16 fine field: {ctl_cond:.5f}"
        print(line)
        if not s_exact:
            fail(f"fused_sampler (SIREN, coarse {coarse_sw}) differs from sweep_plain "
                 f"over the fused callables")
        if frac < 0.99 or ferr > 1e-5 or cond < 0.999:
            fail(f"fused_sampler (SIREN, coarse {coarse_sw}) disagrees with its plain "
                 f"version beyond the stated bars")
        if coarse_sw and int(ctl_hit.sum()) >= 100 and ctl_cond >= 0.999:
            fail(f"the conditioned z_secant bar passes the SIREN sampler with a bf16 "
                 f"fine field ({ctl_cond:.5f})")
        if coarse_sw:
            us_kw, us_err = kw, max(ferr, float(dz[hit].max()) if bool(hit.any()) else 0.0)
    us_ms = time_ms(lambda: t_f.fused_ray_sampler(*us_args, **us_kw))
    us_pms = time_ms(lambda: fused_sampler.sweep_plain(
        t_pf, *us_args, us_nsec, us_margin, sdf_fn_coarse=t_pc))
    us_b = (1e3 * max(s_flops * us_rays * us_steps / BF16_PEAK
                      + 3 * s_flops * us_rays * (2 + us_nsec) / TF32_PEAK,
                      (us_rays * 48 + 4 * us_steps + 2 * s_w_bytes) / HBM_RATE),
            "operations")
    print(f"  coarse sweep: kernel {us_ms:.3f} ms  plain {us_pms:.3f} ms  bound "
          f"{us_b[0]:.4f} ms")

    um_args = u_captured["stepper"]
    um_cam, um_dirs, um_st, um_it = um_args[0], um_args[1], um_args[2], um_args[3]
    um_rays = um_st[0].numel()
    flat = lambda a: (a[0].reshape(-1, 3), a[1].reshape(-1, 3),
                      [x.reshape(-1) for x in a[2]])
    um_out = t_f.fused_trace_stepper(*um_args)
    um_loop = march_plain(t_f, *flat(um_args), *um_args[3:])
    um_ref = march_plain(t_pf, *flat(um_args), *um_args[3:])
    um_exact = all(torch.equal(a.reshape(-1), b) for a, b in zip(um_out, um_loop))
    um_eq = min(float((a.reshape(-1) == b).float().mean())
                for a, b in zip(um_out[4:8], um_ref[4:8]))
    um_close = min(float(((a.reshape(-1) - b).abs() <= 1e-5).float().mean())
                   for a, b in zip(um_out[:2], um_ref[:2]))
    um_err = max(float((a.reshape(-1) - b).abs().max()) for a, b in zip(um_out[:2], um_ref[:2]))
    print(f"trace_march (SIREN) on the uni trace's first compacted stage: {um_rays} "
          f"rays x {um_it} iterations: all ten state arrays equal to march_plain "
          f"over the fused f32 callable: {um_exact}; against the plain version: "
          f"masks/bk equal on {um_eq:.6f}, depths within 1e-5 on {um_close:.6f} "
          f"(max diff {um_err:.3g})")
    if not um_exact:
        fail("trace_march (SIREN) differs from march_plain over the fused callable")
    if um_eq < 0.999 or um_close < 0.999:
        fail("trace_march (SIREN) disagrees with its plain version")
    um_ms = time_ms(lambda: t_f.fused_trace_stepper(*um_args))
    um_pms = time_ms(lambda: march_plain(t_pf, *flat(um_args), *um_args[3:]))
    um_b = bound_ms(3 * s_flops * 2 * um_it * um_rays,
                    um_rays * (24 + 2 * 34) + s_w_bytes, TF32_PEAK)
    print(f"  kernel {um_ms:.3f} ms  plain {um_pms:.3f} ms  bound {um_b[0]:.4f} ms "
          f"({um_b[1]}); the uni warm-up trace {u_trace_ms:.3f} ms (median of 5)")

    # ---- 11. the kernels line
    # fused_mlp at every shape the projected run gave it, most frequent first
    # (the row of the JSON line)
    mlp_rows = []
    for (what, n), c in mlp_split.most_common():
        m_row = check_mlp(n, 2e-5, 1e-4, what == "value+grad")
        print(f"fused_mlp {what} n={n} ({c} launches in the projected run): "
              f"max_abs_err {m_row[0]:.3g}  kernel {m_row[1]:.4f} ms  plain "
              f"{m_row[2]:.4f} ms  bound {m_row[3][0]:.4f} ms ({m_row[3][1]})")
        mlp_rows.append(m_row)
    mlp_err, mlp_ms, mlp_pms, mlp_b = mlp_rows[0]
    (mlp_what, n_mlp), _ = mlp_split.most_common(1)[0]
    s_err, _, s_ms, s_pms, s_b = check_sampler(
        2 * cfg.training.n_rays, linspace01(trainer.model.raytrace_cfg.n_steps, dev),
        trainer.model.raytrace_cfg.n_secant_steps)
    rows = [
        row("fused_mlp", "isopoints_torch/csrc/fused_mlp.cu",
            "isopoints_tpu/ops/pallas_mlp.py:250", launches["fused_mlp"],
            mlp_err, mlp_ms, mlp_pms, mlp_b),
        row("fused_sampler", "isopoints_torch/csrc/fused_sampler.cu",
            "isopoints_tpu/ops/pallas_sampler.py:52", launches["fused_sampler"],
            s_err, s_ms, s_pms, s_b),
        row("knn", "isopoints_torch/csrc/knn.cu",
            "isopoints_tpu/ops/pallas_knn.py:83", launches["knn"],
            k_err, k_ms, k_pms, k_b),
        splat_row("splat_select", "isopoints_torch/csrc/splat_select.cu",
                  "isopoints_tpu/rendering/pallas_select.py:73",
                  launches["splat_select"], sel_row, sel_frame),
        splat_row("splat_fine", "isopoints_torch/csrc/splat_fine.cu",
                  "isopoints_tpu/rendering/pallas_splat.py:42",
                  launches["splat_fine"], fine_row, fine_frame),
        row("fused_igr (bf16)", "isopoints_torch/csrc/fused_igr.cu",
            "isopoints_tpu/ops/pallas_mlp.py:417", igr_modes["bf16"],
            igr_err, igr_ms, igr_pms, igr_b),
        row("fused_igr (f32, 3xTF32)", "isopoints_torch/csrc/fused_igr.cu",
            "isopoints_tpu/ops/pallas_mlp.py:417", igr_modes["f32"],
            igr32_err, igr32_ms, igr32_pms, igr32_b),
        row("fused_sampler (IGR, coarse sweep)",
            "isopoints_torch/csrc/fused_sampler.cu",
            "isopoints_tpu/ops/pallas_sampler.py:52",
            trace_launches["fused_sampler"], sk_err, cs_ms, cs_pms, cs_b),
        row("trace_march", "isopoints_torch/csrc/fused_trace.cu",
            "isopoints_tpu/ops/pallas_trace.py:43", march_launches["trace_march"],
            m_err, mk_ms, mk_pms, mk_b),
        row("fused_mlp (SIREN bf16)", "isopoints_torch/csrc/fused_mlp.cu",
            "isopoints_tpu/ops/pallas_mlp.py:250", uni_modes["bf16"],
            sb_err, sb_ms, sb_pms, sb_b),
        row("fused_sampler (SIREN, coarse sweep)",
            "isopoints_torch/csrc/fused_sampler.cu",
            "isopoints_tpu/ops/pallas_sampler.py:52", uni_coarse,
            us_err, us_ms, us_pms, us_b),
        row("trace_march (SIREN)", "isopoints_torch/csrc/fused_trace.cu",
            "isopoints_tpu/ops/pallas_trace.py:43", u_march_launches,
            um_err, um_ms, um_pms, um_b),
        row("splat_zbuf_bwd", "isopoints_torch/csrc/splat_zbuf_bwd.cu",
            "isopoints_tpu/rendering/pallas_splat.py:186",
            splat_launches["splat_zbuf_bwd"], zb_err, zb_ms, zb_pms, zb_b,
            library_ms=zb_lib_ms, library_note="torch.Tensor.index_add_ of "
            "every fragment to its point (empty ones to a dummy row), timed "
            "here only"),
        row("occ_bwd", "isopoints_torch/csrc/occ_bwd.cu",
            "isopoints_tpu/rendering/pallas_occ_bwd.py:41",
            splat_launches["occ_bwd"], max(occ_row[0], pm_occ[0]), *occ_row[1:4],
            library_note="no single PyTorch call computes this windowed, "
            "gated sum per point", alone_ms=occ_row[4],
            point_model_launches=point_launches["occ_bwd"],
            point_model_ms=pm_occ[1], point_model_alone_ms=pm_occ[4],
            point_model_plain_ms=pm_occ[2], point_model_bound_ms=pm_occ[3][0],
            point_model_bound_by=pm_occ[3][1], bound_ms_all_pairs=occ_row[6][0],
            point_model_bound_ms_all_pairs=pm_occ[6][0]),
    ]
    print(f"timed shapes: fused_mlp {n_mlp} points ({mlp_what}; its most "
          f"frequent launch in the projected run); fused_sampler {2 * cfg.training.n_rays} rays x "
          f"{trainer.model.raytrace_cfg.n_steps} steps (the warm-up trace); "
          f"knn P={state.points.shape[1]} k=8 and splat_select / splat_fine "
          f"{state.points.shape[1]} splats x {cam.batch_size} views at "
          f"{st.image_size} px, on the projected run's iso-point buffer (the "
          f"midpoint upsampling and the frontal raster of every projected step), "
          f"and splat_select / splat_fine again at the splat frame's shape "
          f"(frame_* keys: {bench.N_SPLATS} splats at {bench.SPLAT_IMAGE_SIZE} "
          f"px; alone_ms: the kernel alone, its calls queued behind a spin of the "
          f"card between two events, the selection's torch.sum taken off); "
          f"fused_igr bf16 {'value+grad' if grad16 else 'value'} on {n16} "
          f"points and f32 {'value+grad' if grad32 else 'value'} on {n32} "
          f"points (each mode's most frequent launch in the trace); the IGR "
          f"sampler on the kernel trace's {sk_rays}-ray buffer; trace_march on "
          f"the march trace's first compacted "
          f"stage ({n_mrays} rays x {n_it} iterations); splat_zbuf_bwd and "
          f"occ_bwd on the splat frame's own inputs ({bench.N_SPLATS} splats at "
          f"{bench.SPLAT_IMAGE_SIZE} px; occ_bwd's alone_ms: its two kernels "
          f"queued behind a spin of the card; its bound_ms from the (point, "
          f"pixel) pairs its sums need, bound_ms_all_pairs the same FLOP over "
          f"every patch pixel of every renderable point), occ_bwd again on the point model "
          f"step's own inputs (point_model_* keys: {n_pm} points x {nv} views at "
          f"{pmodel.raster_settings.image_size} px, the step's signed "
          f"cotangent; launches per step). Launches: the SIREN "
          f"kernels' in the projected path's run, fused_igr's (by mode) and "
          f"fused_sampler (IGR)'s in one bench trace, trace_march's in one trace "
          f"with the march, the splat backward's in one splat frame; the SIREN "
          f"bf16 mode on {sb_n} points ({sb_what}, its most frequent launch in "
          f"the uni run), the SIREN coarse sampler on the uni warm-up trace's "
          f"{us_rays}-ray buffer and the SIREN march on its first compacted stage "
          f"({um_rays} rays x {um_it} iterations), launches in the uni run (the "
          f"march's in one trace with it)")
    # ---- 12. the lossS arm: saliency statistics and insertion at resamples
    # what the run does, in order: each uniform resample ("uniform") and
    # each insertion ("insert"); the insertions' inputs and what each append
    # added; the trainer's saliency arrays before each update and the
    # update's inputs; fused_mlp's launches in order, by (mode, what, rows)
    events, inserts, appended, updates, s_mlp = [], [], [], [], []
    uniform_fn, project_fn = trainer_mod.sample_uniform_iso_points, trainer_mod.project_points
    insert_fn, append_fn = levelset.insert_around_salient, levelset._append_into_capacity
    update_fn = trainer_mod.MVRTrainer.update_ref_metric
    saliency_keys = ("ref_points", "ref_mask", "ref_stat_mean", "ref_stat_n")

    def recording_uniform(*args, **kw):
        events.append("uniform")
        return uniform_fn(*args, **kw)

    def recording_project(*args, **kw):
        events.append("insert")
        return project_fn(*args, **kw)

    def recording_insert(*args):
        inserts.append(args)
        return insert_fn(*args)

    def recording_append(pts, mask, nrm, new_pts, new_mask, new_nrm):
        out = append_fn(pts, mask, nrm, new_pts, new_mask, new_nrm)
        appended.append((int(new_mask.sum()), int(out[1].sum() - mask.sum())))
        return out

    def recording_update(self, *args):
        updates.append(({k: getattr(self, k) for k in saliency_keys}, args))
        return update_fn(self, *args)

    def recording_siren_lossS(pack, x, with_grad, bf16=False):
        s_mlp.append(("bf16" if bf16 else "f32",
                      "value+grad" if with_grad else "value", x.shape[0]))
        return siren_cuda(pack, x, with_grad, bf16)

    patches = ((trainer_mod, "sample_uniform_iso_points", recording_uniform),
               (trainer_mod, "project_points", recording_project),
               (levelset, "insert_around_salient", recording_insert),
               (levelset, "_append_into_capacity", recording_append),
               (trainer_mod.MVRTrainer, "update_ref_metric", recording_update),
               (fused_mlp, "siren_forward_cuda", recording_siren_lossS))
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        (_, s_trainer, _, _, s_ms, s_metrics, s_per_step, s_launches, _,
         s_resampled) = run_steps("mvr_lossS_siren.yml", 2 + N_LOSS_S_PROJECTED)
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    s_warm = s_trainer.cfg.warm_up_iters
    s_every = s_trainer.cfg.resample_every
    s_resample_its = [i for i in range(s_warm, len(s_ms))
                      if i == s_warm or i % s_every == 0]
    s_insert_its = s_resample_its[1:]
    # the event list reads uniform, uniform, insert, uniform, insert for
    # resamples at 2, 4 and 6 with the gate open at 4 and 6
    opened, k = [], -1
    for ev in events:
        if ev == "uniform":
            k += 1
        else:
            opened.append(s_resample_its[k])
    if opened != s_insert_its or not opened:
        fail(f"lossS: the insertion gate opened at its {opened}, expected "
             f"{s_insert_its}")
    if not appended or sum(a for _, a in appended) <= 0:
        fail(f"lossS: no child was appended at the inserting resamples "
             f"(valid children, appended: {appended})")
    print(f"lossS path (mvr_lossS_siren.yml): resamples at its {s_resample_its}, "
          f"insertion gate open at {opened}; valid children and appended "
          f"points per insertion {appended}; reference cloud "
          f"{tuple(s_trainer.ref_points.shape)} ({int(s_trainer.ref_mask.sum())} "
          f"valid), statistics counts up to {int(s_trainer.ref_stat_n.max())}")
    # launches per step, beside the uni run's from phase 10
    per_shape, i0 = [], 0
    for p in s_per_step:
        per_shape.append(collections.Counter(s_mlp[i0:i0 + p["fused_mlp"]]))
        i0 += p["fused_mlp"]
    if i0 != len(s_mlp) or len(s_mlp) != s_launches["fused_mlp"]:
        fail("lossS: fused_mlp's launches by shape do not add up to its counter")
    # children: 8 for each of the (at most) 64 fathers
    n_children = 8 * min(64, inserts[0][0].shape[1])
    # uni's resample step, and its projected step after a resample (which
    # takes the splat spacing of the new buffer anew: one kNN more than the
    # later ones); every lossS projected step follows a resample
    u_res = u_per_step[u_warm]["knn"]
    u_proj = u_per_step[u_warm + 1]["knn"]
    for i, p in enumerate(s_per_step):
        kind = ("warm-up" if i < s_warm else "insertion resample" if i in opened
                else "resample + seeding" if i == s_warm else "projected")
        u_i = i if i < s_warm else u_warm if i in s_resample_its else u_warm + 1
        print(f"  lossS step {i} ({kind}): {s_ms[i]:.1f} ms (uni step {u_i}: "
              f"{u_ms[u_i]:.1f} ms); launches {p}; fused_mlp by shape: "
              + ", ".join(f"{c} x {m} {w} n={n}" for (m, w, n), c in
                          sorted(per_shape[i].items(), key=lambda kv: -kv[1])))
        want = (u_per_step[i]["knn"] if i < s_warm else u_res + 1 if i == s_warm
                else u_res + 3 if i in opened else u_proj + 1)
        if p["knn"] != want:
            fail(f"lossS step {i} ({kind}) launched {p['knn']} kNN, expected "
                 f"{want} (uni: {u_res} a resample step, {u_proj} a projected "
                 f"step; +1 statistics a projected step, +2 an insertion)")
        if i in opened and per_shape[i][("f32", "value+grad", n_children)] <= 0:
            fail(f"lossS step {i}: no fused_mlp launch at the children's shape "
                 f"({n_children} points)")
    s_proj_ms = [s_ms[i] for i in range(s_warm + 1, len(s_ms))
                 if i not in s_resample_its]
    print(f"lossS times: projected median {statistics.median(s_proj_ms):.2f} ms "
          f"over {len(s_proj_ms)} steps (uni {statistics.median(u_ms[u_warm + 1:]):.2f}), "
          f"resample + seeding step (it={s_warm}) {s_ms[s_warm]:.1f} ms (uni "
          f"resample {u_ms[u_warm]:.1f}), insertion resample steps "
          + ", ".join(f"it={i} {s_ms[i]:.1f} ms" for i in opened))
    s_iso = [m["n_iso"] for m in s_metrics[s_warm:]]
    if min(s_iso) <= 0:
        fail(f"lossS projected steps found no iso-points: n_iso {s_iso}")

    # kernels against plain on the run's own state at the first insertion
    # resample: its update's inputs and the statistics before it
    knn_cuda = knn.knn_points_cuda
    snap, s_args = updates[opened[0] - s_warm]

    def set_saliency(state):
        for key in saliency_keys:
            setattr(s_trainer, key, state[key])

    def run_update(plain):
        set_saliency(snap)
        if plain:
            knn.knn_points_cuda = knn.knn_points_dense
        try:
            s_trainer.update_ref_metric(*s_args)
        finally:
            knn.knn_points_cuda = knn_cuda
        return s_trainer.ref_stat_mean, s_trainer.ref_stat_n

    before = counts()
    up_k, up_p = run_update(False), run_update(True)
    if counts()["knn"] != before["knn"] + 1:
        fail("lossS: update_ref_metric did not launch the kNN once (kernel run) "
             "and not at all (plain run)")
    if not (torch.equal(up_k[0], up_p[0]) and torch.equal(up_k[1], up_p[1])):
        fail("lossS: update_ref_metric's statistics with the kNN kernel differ "
             "from the plain version's")
    print(f"lossS update_ref_metric at it={opened[0]}: ref_stat_mean and ref_stat_n "
          f"bit-equal, kernel against plain (mean over counted points "
          f"{float(up_k[0][up_k[1] > 0].mean()):.6g})")
    iso_pts, _, iso_mask = s_args
    stats_q = (snap["ref_points"], iso_pts.reshape(1, -1, 3), snap["ref_mask"],
               iso_mask.reshape(1, -1))
    n_stats = knn_equal(*stats_q, 8, False, "saliency statistics")
    # the insertion's two kNN calls, recorded from a call on its inputs
    ins_args = inserts[0]
    knn_calls = []
    level_knn = levelset.knn_points

    def recording_knn(*args, **kw):
        knn_calls.append((args, kw))
        return level_knn(*args, **kw)
    levelset.knn_points = recording_knn
    try:
        ch_k = levelset.insert_around_salient(*ins_args)
    finally:
        levelset.knn_points = level_knn
    knn.knn_points_cuda = knn.knn_points_dense
    try:
        ch_p = levelset.insert_around_salient(*ins_args)
    finally:
        knn.knn_points_cuda = knn_cuda
    if not (torch.equal(ch_k[0], ch_p[0]) and torch.equal(ch_k[1], ch_p[1])):
        fail("lossS: insert_around_salient's children with the kernels differ "
             "from the plain version's")
    (hot_a, hot_kw), (mom_a, mom_kw) = knn_calls
    n_hot = knn_equal(*hot_a, hot_kw["k"], False, "hot-point lookup")
    n_mom = knn_equal(*mom_a, mom_kw["k"], False, "mothers")
    q_all, db_all, qm_all, dbm_all = hot_a
    none = torch.zeros_like(dbm_all)
    if knn_equal(q_all, db_all, qm_all, none, 1, False, "all-masked database"):
        fail("lossS: the kNN over an all-masked database returned a neighbour")
    pts_i, mask_i = ins_args[0], ins_args[1]
    few = torch.zeros_like(mask_i)
    few[:, torch.nonzero(mask_i[0])[:5, 0]] = True
    n_few = knn_equal(mom_a[0], pts_i, mom_a[2], few, 8, False,
                      "a database of 5 valid points")
    if n_few > 5 * int(mom_a[2].sum()):
        fail("lossS: the kNN over 5 valid points returned more than 5 a query")
    none_ref = torch.zeros_like(ins_args[4])
    ch0 = levelset.insert_around_salient(*ins_args[:4], none_ref)
    knn.knn_points_cuda = knn.knn_points_dense
    try:
        ch0_p = levelset.insert_around_salient(*ins_args[:4], none_ref)
    finally:
        knn.knn_points_cuda = knn_cuda
    if bool(ch0[1].any()) or not (torch.equal(ch0[0], ch0_p[0])
                                  and torch.equal(ch0[1], ch0_p[1])):
        fail("lossS: an all-masked reference cloud gave children, or the kernel "
             "and plain children differ")
    print(f"lossS kNN at the path's shapes, bit-equal to the plain version: "
          f"statistics {tuple(stats_q[0].shape[:2])} x {stats_q[1].shape[1]} k=8 "
          f"({n_stats} neighbours), hot-point lookup {q_all.shape[1]} x "
          f"{db_all.shape[1]} k=1 ({n_hot}; {int(dbm_all.sum())} hot), mothers "
          f"{mom_a[0].shape[1]} x {mom_a[1].shape[1]} k=8 ({n_mom}), an all-masked "
          f"database (none), 5 valid points k=8 ({n_few}); insert_around_salient "
          f"children and masks bit-equal ({int(ch_k[1].sum())} valid children), "
          f"none from an all-masked reference cloud")

    # the full insertion resample, kernels against plain on the same inputs
    hp4 = s_trainer.scheduler.at(opened[0])
    init_pts, init_mask = s_resampled[s_resample_its.index(opened[0])][:2]
    trace_fn = s_trainer.model.trace_sdf_fn

    def resample_at(plain):
        set_saliency(snap)
        if plain:
            s_trainer.model.trace_sdf_fn = lambda: fused_mlp.PlainSDF(
                fused_mlp.SirenPack(s_trainer.model.decoder))
            knn.knn_points_cuda = knn.knn_points_dense
        reset()
        try:
            out = s_trainer.resample_iso_points(
                hp4["n_points_dss"], proj_max_iters=hp4["proj_max_iters"],
                proj_tolerance=hp4["proj_tolerance"], init_points=init_pts,
                init_mask=init_mask)
        finally:
            s_trainer.model.trace_sdf_fn = trace_fn
            knn.knn_points_cuda = knn_cuda
        torch.cuda.synchronize()
        return out, counts()

    (rk_pts, rk_mask), rk_launch = resample_at(False)
    (rp_pts, rp_mask), rp_launch = resample_at(True)
    if any(rp_launch.values()) or rk_launch["knn"] <= 0 or rk_launch["fused_mlp"] <= 0:
        fail(f"lossS resample launches: kernels {rk_launch}, plain {rp_launch}")
    cap = rk_mask.shape[1]
    nk, np_ = int(rk_mask.sum()), int(rp_mask.sum())
    d_near = torch.cdist(rp_pts[0][rp_mask[0]], rk_pts[0][rk_mask[0]],
                         compute_mode="donot_use_mm_for_euclid_dist").min(-1).values
    near = float((d_near <= 1e-4).float().mean())
    print(f"lossS insertion resample (it={opened[0]}) with the kernels and with "
          f"every plain version: {nk} and {np_} valid of {cap}; of the plain "
          f"version's points {near:.5f} have a kernel point within 1e-4 "
          f"({float((d_near <= 1e-5).float().mean()):.5f} within 1e-5); launches "
          f"(kernels) {rk_launch}")
    # Newton stops at |f| <= tol (5e-5, |grad f| ~ 1): two correct fields
    # leave a point up to ~1e-4 apart; a few midpoint inserts change slot
    if abs(nk - np_) > 0.005 * cap or near < 0.98:
        fail("lossS: the insertion resample with the kernels and plain differ "
             "beyond the stated bars (counts within 0.5% of the capacity, 98% "
             "of points within 1e-4)")
    set_saliency({k: getattr(s_trainer, k) for k in saliency_keys})

    # the children's Newton projection on the run's own children of the
    # first insertion: fused_mlp (f32 value+grad) at the children's shape
    # against the plain SIREN, then the projection with each
    c_pts, c_mask = ch_k
    c_fn = s_trainer.model.trace_sdf_fn()
    c_pack = fused_mlp.SirenPack(s_trainer.model.decoder)
    c_plain = fused_mlp.PlainSDF(c_pack)
    c_x = c_pts.reshape(-1, 3)
    (c_v, c_g), (c_vp, c_gp) = c_fn.sdf_and_grad(c_x), c_plain.sdf_and_grad(c_x)
    c_err = (float((c_v - c_vp).abs().max()), float((c_g - c_gp).abs().max()))
    c_gscale = float(c_gp.abs().max())
    if not (bool(torch.isfinite(c_v).all()) and bool(torch.isfinite(c_g).all())
            and c_err[0] <= 2e-5 and c_err[1] <= 1e-4 * max(1.0, c_gscale)):
        fail(f"lossS: fused_mlp value+grad at the {c_x.shape[0]} children: "
             f"errors {c_err} against the plain SIREN (bars 2e-5 and "
             f"1e-4·max(1, {c_gscale:.4g}), phase 2's)")

    def project_children(fn):
        reset()
        out = levelset.project_points_newton(
            fn, c_pts, c_mask, max_iters=10, tolerance=hp4["proj_tolerance"])
        torch.cuda.synchronize()
        return out, counts()["fused_mlp"]

    (cp_k, c_launch), (cp_p, c_plain_launch) = (project_children(c_fn),
                                                project_children(c_plain))
    if c_launch <= 0 or c_plain_launch != 0:
        fail(f"lossS: the children's projection launched fused_mlp "
             f"{c_launch} times with the kernel and {c_plain_launch} plain")
    both = cp_k.mask & cp_p.mask
    c_d = (cp_k.points - cp_p.points).norm(dim=-1)[both]
    c_near = float((c_d <= 1e-4).float().mean()) if c_d.numel() else 0.0
    nck, ncp = int(cp_k.mask.sum()), int(cp_p.mask.sum())
    print(f"lossS children (it={opened[0]}): fused_mlp value+grad at "
          f"{c_x.shape[0]} points, max err value {c_err[0]:.3g}, grad "
          f"{c_err[1]:.3g} (max |g| {c_gscale:.4g}); Newton (10 iterations) "
          f"with the kernel ({c_launch} launches) and plain: {nck} and {ncp} "
          f"valid of {int(c_mask.sum())}; of the {int(both.sum())} valid in "
          f"both {c_near:.5f} within 1e-4 (max {float(c_d.max()) if c_d.numel() else 0.0:.3g})")
    # Newton stops at |f| <= tol (5e-5, |grad f| ~ 1): two correct fields
    # leave a point up to ~1e-4 apart
    if abs(nck - ncp) > 0.005 * c_x.shape[0] or c_near < 0.99 or nck <= 0:
        fail("lossS: the children's projection with the kernel and plain "
             "differ beyond the stated bars (counts within 0.5% of the "
             "children, 99% of the points valid in both within 1e-4)")
    c_ms = time_ms(lambda: c_fn.sdf_and_grad(c_x))
    c_pms = time_ms(lambda: c_plain.sdf_and_grad(c_x))
    c_b = bound_ms(3 * 2.0 * c_x.shape[0] * sum(w.numel() for w in c_pack.ws) * 4,
                   c_x.shape[0] * 28 + 4 * sum(w.numel() + b.numel() for w, b
                                               in zip(c_pack.ws, c_pack.bs)),
                   TF32_PEAK)
    print(f"  fused_mlp value+grad at the children's {c_x.shape[0]} points: "
          f"kernel {c_ms:.4f} ms  plain {c_pms:.4f} ms  bound {c_b[0]:.5f} ms "
          f"({c_b[1]})")

    # times: the statistics' kNN, update_ref_metric and FPS alone
    sq = stats_q
    sk_ms = time_ms(lambda: knn.knn_points(*sq, k=8))
    sk_alone = kernel_variants.queued_ms(lambda: knn.knn_points(*sq, k=8))
    sk_pms = time_ms(lambda: knn.knn_points(*sq, k=8, method="dense"), reps=3)
    nq, npts = sq[0].shape[1], sq[1].shape[1]
    sk_b = bound_ms(9.0 * float(sq[2].sum()) * float(sq[3].sum()),
                    (nq + npts) * 13 + nq * 8 * 12)
    print(f"knn at the update_ref_metric shape ({nq} queries x {npts} points, "
          f"k=8): kernel {sk_ms:.4f} ms (alone {sk_alone:.4f})  plain {sk_pms:.3f} "
          f"ms  bound {sk_b[0]:.5f} ms ({sk_b[1]}; the f32 rate over the valid "
          f"pairs' distance evaluations)")
    up_ms = time_ms(lambda: run_update(False))
    fps_n = min(s_trainer.cfg.n_ref_points, iso_pts.shape[1])
    fps_ms = time_ms(lambda: farthest_point_sampling(iso_pts[:1], fps_n,
                                                     iso_mask[:1]))
    print(f"update_ref_metric alone {up_ms:.3f} ms (median of 7, CUDA events); "
          f"farthest_point_sampling of the run's {iso_pts.shape[1]}-point iso set "
          f"({int(iso_mask[0].sum())} valid) to {fps_n} points {fps_ms:.1f} ms")
    rows[2].update(lossS_shape=f"{nq} x {npts}, k=8", lossS_ms=sk_ms,
                   lossS_alone_ms=sk_alone, lossS_plain_ms=sk_pms,
                   lossS_bound_ms=sk_b[0], lossS_bound_by=sk_b[1],
                   lossS_launches_per_projected_step=s_per_step[s_warm + 1]["knn"],
                   lossS_launches_per_insertion_resample=[
                       s_per_step[i]["knn"] for i in opened])
    rows[0].update(lossS_children_shape=f"{c_x.shape[0]} x 3, f32 value+grad",
                   lossS_children_launches_per_insertion_resample=[
                       per_shape[i][("f32", "value+grad", n_children)]
                       for i in opened],
                   lossS_children_max_abs_err=max(c_err),
                   lossS_children_ms=c_ms, lossS_children_plain_ms=c_pms,
                   lossS_children_bound_ms=c_b[0],
                   lossS_children_bound_by=c_b[1])

    # ---- 13. training from data directories: write, read back, train,
    # checkpoint, stop and resume, through the entry points a user calls
    import numpy as np
    from isopoints_torch import create_mvr_data, train_mvr
    from isopoints_torch.data.dataset import DTUDataset, MVRDataset
    from isopoints_torch.misc import checkpoints as ckpt_mod
    from isopoints_torch.misc.metrics import load_metrics
    # the configs name their data directories relative to the checkout
    os.chdir(ROOT)
    data_dir = os.path.join("out", "torch_data_torus512")
    shutil.rmtree(data_dir, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mem = create_mvr_data.main(["torus", data_dir, "--image-size", "512",
                                "--n-views", "24"])
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = MVRDataset(data_dir)
    items = [ds[i] for i in range(len(ds))]
    read_s = time.perf_counter() - t0
    if len(items) != 24 or items[0]["img.rgb"].shape != (512, 512, 3):
        fail(f"directory data: {len(items)} views of {items[0]['img.rgb'].shape}")
    for i, item in enumerate(items):
        u8 = np.clip(mem["img.rgb"][i] * 255.0, 0, 255).astype(np.uint8)
        if not (np.array_equal(item["img.rgb"], u8.astype(np.float32) / 255.0)
                and np.array_equal(item["img.mask"], mem["img.mask"][i])):
            fail(f"directory data: view {i} read back differs from the 8-bit "
                 f"truncation of the arrays written")
    for key, got in (("camera_mat", ds.camera_mat), ("points", ds.points),
                     ("normals", ds.normals), ("focal_length", ds.focal_length),
                     ("principal_point", ds.principal_point)):
        if not np.array_equal(got, mem[key]):
            fail(f"directory data: {key} read back differs from the one written")
    cover = float(np.mean(mem["img.mask"]))
    if not 0.02 < cover < 0.9:
        fail(f"the torus masks cover {cover:.3f} of the pixels")
    print(f"directory data: the torus, 24 views at 512 px written to {data_dir} "
          f"in {write_s:.2f} s (rendered on the card, PNG-encoded on the host) and "
          f"read back in {read_s:.2f} s: every image equal to the 8-bit truncation "
          f"of the arrays written, masks, cameras, GT points ({len(ds.points)}) "
          f"equal bit for bit; masks cover {cover:.4f}")

    # each run through train_mvr.main: per step its time, launches, views and
    # pixel draws; fused_mlp's and the sampler's launches by mode; the
    # insertions' iterations; each checkpoint save's time
    rec = {}
    train_step_fn = trainer_mod.MVRTrainer.train_step
    draw_fn = trainer_mod.MVRTrainer.draw
    draw_views_fn = train_mvr.draw_views
    save_fn = ckpt_mod.CheckpointIO.save

    def rec_step(self, state, *args, **kw):
        before = counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = train_step_fn(self, state, *args, **kw)
        torch.cuda.synchronize()
        rec["ms"][state.it] = 1e3 * (time.perf_counter() - t)
        rec["launches"][state.it] = {k: v - before[k] for k, v in counts().items()}
        return out

    def rec_draw(self, *args, **kw):
        d = draw_fn(self, *args, **kw)
        rec["pixels"].append(d.pixels.clone())
        return d

    def rec_views(seed, it, *args):
        idx = draw_views_fn(seed, it, *args)
        rec["views"][it] = idx.tolist()
        return idx

    def rec_project(*args, **kw):
        rec["inserts"].append(len(rec["ms"]) + rec["it0"])
        return project_fn(*args, **kw)

    def rec_siren(pack, x, with_grad, bf16=False):
        rec["mlp"][("bf16" if bf16 else "f32", "value+grad" if with_grad
                    else "value", x.shape[0])] += 1
        return siren_cuda(pack, x, with_grad, bf16)

    def rec_sweep(pack, cam, dirs, t_lo, t_hi, steps, n_secant, margin,
                  coarse_sweep=False, fine_bf16=False):
        rec["sweeps"][("coarse" if coarse_sweep else "fine", dirs.shape[0])] += 1
        return sweep_cuda(pack, cam, dirs, t_lo, t_hi, steps, n_secant, margin,
                          coarse_sweep, fine_bf16)

    def rec_save(self, *args, **kw):
        t = time.perf_counter()
        out = save_fn(self, *args, **kw)
        rec["save_s"].append(time.perf_counter() - t)
        return out

    def train(cfg_name, out_dir, n_iters, *flags, fresh=True, expect_exit=None):
        """train_mvr.main on `cfg_name` into `out_dir` (emptied first when
        `fresh`), recording as above; returns (run or None, record, wall s).
        A SystemExit is caught only to compare its code with `expect_exit`."""
        if fresh:
            shutil.rmtree(out_dir, ignore_errors=True)
        it0 = 0
        if os.path.exists(os.path.join(out_dir, "model.npz")):
            with np.load(os.path.join(out_dir, "model.npz")) as f:
                it0 = int(f["scalar:it"])
        rec.clear()
        rec.update(ms={}, launches={}, pixels=[], views={}, inserts=[], it0=it0,
                   mlp=collections.Counter(), sweeps=collections.Counter(), save_s=[])
        patches = ((trainer_mod.MVRTrainer, "train_step", rec_step),
                   (trainer_mod.MVRTrainer, "draw", rec_draw),
                   (train_mvr, "draw_views", rec_views),
                   (trainer_mod, "project_points", rec_project),
                   (fused_mlp, "siren_forward_cuda", rec_siren),
                   (fused_sampler, "sweep_cuda", rec_sweep),
                   (ckpt_mod.CheckpointIO, "save", rec_save))
        saved_attrs = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        argv = [os.path.join("isopoints_torch", "configs", cfg_name), "--out-dir",
                out_dir, "--max-iters", str(n_iters), "--print-every", "1000", *flags]
        run, code = None, None
        t = time.perf_counter()
        try:
            run = train_mvr.main(argv)
        except SystemExit as e:
            code = e.code
        finally:
            for obj, name, fn in saved_attrs:
                setattr(obj, name, fn)
        wall = time.perf_counter() - t
        if code != expect_exit:
            fail(f"train_mvr {' '.join(argv)} exited with {code!r}, expected "
                 f"{expect_exit!r}")
        return run, dict(rec), wall

    def npz(out_dir):
        with np.load(os.path.join(out_dir, "model.npz")) as f:
            return {k: f[k] for k in f.files}

    def rows_of(out_dir):
        return [{k: v for k, v in r.items() if k != "ts"}
                for r in load_metrics(os.path.join(out_dir, "metrics.jsonl"))]

    def same_arrays(a, b):
        return sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)

    # (b) the uninterrupted run, counters set to 0 just before and read after
    dir_b = os.path.join("out", "torch_mvr_lossS_dir")
    reset()
    run_b, rec_b, wall_b = train("mvr_lossS_dir.yml", dir_b, 8,
                                 "--checkpoint-every", "4")
    dir_launches = counts()
    print(f"mvr_lossS_dir.yml (the lossS arm from {data_dir}), 8 iterations in "
          f"{wall_b:.2f} s: launches {dir_launches}; fused_mlp by mode "
          f"{dict(rec_b['mlp'])}; the sampler by sweep {dict(rec_b['sweeps'])}; "
          f"insertions at its {rec_b['inserts']}")
    modes = {m for m, _, _ in rec_b["mlp"]}
    if modes != {"f32", "bf16"}:
        fail(f"mvr_lossS_dir.yml: fused_mlp launched in modes {modes}, not both")
    if not any(s == "coarse" for s, _ in rec_b["sweeps"]):
        fail("mvr_lossS_dir.yml: the sampler never ran its coarse sweep")
    for name in ("knn", "splat_select", "splat_fine"):
        if dir_launches[name] <= 0:
            fail(f"mvr_lossS_dir.yml: kernel {name} was not launched")
    if rec_b["inserts"] != [4, 6]:
        fail(f"mvr_lossS_dir.yml: the insertion gate opened at its "
             f"{rec_b['inserts']}, expected [4, 6]")
    m_b = rows_of(dir_b)
    if [r["it"] for r in m_b] != list(range(8)) or not all(
            np.isfinite([r[k] for k in loss_keys]).all() for r in m_b):
        fail(f"mvr_lossS_dir.yml: metrics rows {m_b}")
    if min(r["n_iso"] for r in m_b[2:]) <= 0:
        fail("mvr_lossS_dir.yml: a projected step found no iso-point")
    kinds = {0: "warm-up", 1: "warm-up", 2: "resample + seeding", 3: "projected",
             4: "insertion resample", 5: "projected", 6: "insertion resample",
             7: "projected"}
    for i in range(8):
        print(f"  step {i} ({kinds[i]}): {rec_b['ms'][i]:.1f} ms at 512 px "
              f"(phase 12 at 64 px: {s_ms[i]:.1f} ms); launches "
              f"{rec_b['launches'][i]}")
    proj_512 = statistics.median(rec_b["ms"][i] for i in (3, 5, 7))
    proj_64 = statistics.median(s_ms[i] for i in (3, 5, 7))
    steps_s = sum(rec_b["ms"].values()) / 1e3
    print(f"step times at 512 px / phase 12 at 64 px: warm-up median "
          f"{statistics.median([rec_b['ms'][0], rec_b['ms'][1]]):.2f} / "
          f"{statistics.median(s_ms[:2]):.2f} ms, resample + seeding "
          f"{rec_b['ms'][2]:.1f} / {s_ms[2]:.1f} ms, insertion resamples "
          f"{rec_b['ms'][4]:.1f}, {rec_b['ms'][6]:.1f} / {s_ms[4]:.1f}, "
          f"{s_ms[6]:.1f} ms, projected median {proj_512:.2f} / {proj_64:.2f} ms; "
          f"the entry's own time outside the steps {wall_b - steps_s:.2f} s "
          f"(data read, model, checkpoints: {len(rec_b['save_s'])} saves, "
          f"{1e3 * max(rec_b['save_s']):.1f} ms the longest)")
    new_shapes = sorted(set(rec_b["mlp"]) - set(s_mlp))
    print(f"fused_mlp shapes of this run not in phase 12's: {new_shapes or 'none'}")

    # (c) a run of 4 iterations, a resume that runs none, then one to 8
    dir_c = os.path.join("out", "torch_mvr_lossS_dir_resumed")
    train("mvr_lossS_dir.yml", dir_c, 4)
    saved4 = npz(dir_c)
    run_c0, rec_c0, wall_c0 = train("mvr_lossS_dir.yml", dir_c, 4, fresh=False)
    if rec_c0["ms"] or not same_arrays(npz(dir_c), saved4):
        fail("resume: a resume that runs no iteration did not write back the "
             "checkpoint it read, bit for bit")
    st = run_c0.state
    restored = {
        "parameters": all(np.array_equal(v.cpu().numpy(), saved4["model:" + k])
                          for k, v in run_c0.trainer.model.state_dict().items()),
        "Adam moments": st.opt_state.count == int(saved4["opt:count"]) and all(
            np.array_equal(v.cpu().numpy(), saved4[f"opt:{m}/{k}"])
            for m in ("mu", "nu") for k, v in getattr(st.opt_state, m).items()),
        "iso-point buffer": (np.array_equal(st.points.cpu().numpy(), saved4["points:"])
                             and np.array_equal(st.points_mask.cpu().numpy(),
                                                saved4["points_mask:"])),
        "spacing": np.array_equal(st.spacing.cpu().numpy(), saved4["spacing:"]),
        "generator state": np.array_equal(run_c0.trainer.generators.state(),
                                          saved4["scalar:rng_state"]),
        "saliency arrays": all(np.array_equal(
            run_c0.trainer.saliency_state()[k], saved4["saliency:" + k])
            for k in ("ref_points", "ref_mask", "ref_stat_mean", "ref_stat_n")),
    }
    cap = saved4["points:"].shape[1]
    start_cap = run_c0.trainer.model.ccfg.n_points_per_cloud
    print(f"resume at it 4: restored bit for bit {restored}; the buffer's capacity "
          f"{cap} adopted from the checkpoint (the start cloud holds {start_cap}); "
          f"the entry took {wall_c0:.2f} s for a resume that runs no step")
    if not all(restored.values()) or cap == start_cap:
        fail(f"resume: state not restored bit for bit: {restored}")
    run_c, rec_c, wall_c = train("mvr_lossS_dir.yml", dir_c, 8, fresh=False)
    m_c = rows_of(dir_c)
    if [r["it"] for r in m_c] != list(range(8)) or sorted(rec_c["ms"]) != [4, 5, 6, 7]:
        fail(f"resume: the resumed run stepped its {sorted(rec_c['ms'])}")
    if any(rec_c["views"][i] != rec_b["views"][i] for i in range(4, 8)) or not all(
            torch.equal(a, b) for a, b in zip(rec_c["pixels"], rec_b["pixels"][4:])):
        fail("resume: the views or pixels drawn at its 4-7 differ from the "
             "uninterrupted run's")
    print(f"resumed run, its 4-7 in {wall_c:.2f} s (steps "
          f"{sum(rec_c['ms'].values()) / 1e3:.2f} s, the entry's own time "
          f"{wall_c - sum(rec_c['ms'].values()) / 1e3:.2f} s; the uninterrupted "
          f"run's {wall_b - steps_s:.2f} s): views and pixels drawn at its 4-7 "
          f"equal to the uninterrupted run's; insertions at its {rec_c['inserts']}")
    # does a repeat of the uninterrupted run agree with it bit for bit?
    dir_r = os.path.join("out", "torch_mvr_lossS_dir_repeat")
    train("mvr_lossS_dir.yml", dir_r, 8, "--checkpoint-every", "4")
    m_r = rows_of(dir_r)
    f_b, f_r, f_c = npz(dir_b), npz(dir_r), npz(dir_c)
    repeat_equal = m_r == m_b and same_arrays(f_r, f_b)
    resumed_equal = m_c[4:] == m_b[4:] and same_arrays(f_c, f_b)

    def gaps(m_x, f_x):
        """Largest relative gap of the loss terms over its 4-7, largest
        n_iso difference, largest parameter difference at the end."""
        rel = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-6)
                  for x, y in zip(m_x[4:], m_b[4:]) for k in loss_keys)
        n_iso = max(abs(x["n_iso"] - y["n_iso"]) for x, y in zip(m_x[4:], m_b[4:]))
        par = max(float(np.abs(f_x[k] - f_b[k]).max()) for k in f_b
                  if k.startswith("model:"))
        return rel, n_iso, par

    g_rep, g_res = gaps(m_r, f_r), gaps(m_c, f_c)
    print(f"two uninterrupted runs agree bit for bit: {repeat_equal} (their gap: "
          f"loss terms {g_rep[0]:.3g} relative, n_iso {g_rep[1]:.0f}, parameters "
          f"{g_rep[2]:.3g}); the resumed run against the uninterrupted one: "
          f"bit for bit {resumed_equal} (loss terms {g_res[0]:.3g}, n_iso "
          f"{g_res[1]:.0f}, parameters {g_res[2]:.3g})")
    if repeat_equal:
        if not resumed_equal:
            fail("resume: two uninterrupted runs agree bit for bit, the resumed "
                 "run does not")
        print("  bar: bit for bit (metrics rows of its 4-7 and the final checkpoint)")
    else:
        bars = (max(2 * g_rep[0], 1e-6), max(g_rep[1], 0.005 * cap),
                max(2 * g_rep[2], 1e-7))
        print(f"  bars (the repeat's own gap, doubled; n_iso within the larger "
              f"of its gap and 0.5% of the capacity): loss terms {bars[0]:.3g}, "
              f"n_iso {bars[1]:.0f}, parameters {bars[2]:.3g}")
        if any(g > b for g, b in zip(g_res, bars)):
            fail(f"resume: the resumed run's gap {g_res} exceeds the bars {bars}")

    # (d) --exit-after: a checkpoint, then exit code 3
    dir_d = os.path.join("out", "torch_mvr_lossS_dir_exit")
    _, rec_d, _ = train("mvr_lossS_dir.yml", dir_d, 8, "--exit-after", "1e-9",
                        expect_exit=3)
    it_d = int(npz(dir_d)["scalar:it"])
    if it_d != len(rec_d["ms"]) or it_d != len(rows_of(dir_d)) or it_d < 1:
        fail(f"--exit-after: the checkpoint holds it={it_d} after "
             f"{len(rec_d['ms'])} steps")
    print(f"--exit-after 1e-9: exit code 3 after {len(rec_d['ms'])} step, the "
          f"checkpoint holds it={it_d}")

    # (e) DTU-layout data: per-view decomposed cameras on the kernel route
    dtu_dir = os.path.join("out", "torch_data_dtu_torus")
    shutil.rmtree(dtu_dir, ignore_errors=True)
    t0 = time.perf_counter()
    create_mvr_data.main(["torus", dtu_dir, "--dtu", "--image-size", "512",
                          "--n-views", "8"])
    dtu_write_s = time.perf_counter() - t0
    dtu = DTUDataset(dtu_dir)
    dcam = dtu.camera(np.arange(8), (512, 512), device=dev)
    fx = [float(k[0, 0]) for k in dtu.intrinsics]
    if len(dtu) != 8 or not bool((dcam.focal_length < 0).all()) or max(
            abs(f - 512.0) for f in fx) > 1e-2:
        fail(f"DTU data: {len(dtu)} views, focal lengths {fx} px, NDC "
             f"{dcam.focal_length.tolist()}")
    print(f"DTU-layout torus, 8 views at 512 px, written in {dtu_write_s:.2f} s; "
          f"cameras decomposed from cameras.npz: focal {min(fx):.4f}-{max(fx):.4f} "
          f"px, NDC focal negated in every view "
          f"({float(dcam.focal_length.max()):.6f} the largest)")
    reset()
    run_e, rec_e, wall_e = train("mvr_uni_dtu.yml",
                                 os.path.join("out", "torch_mvr_uni_dtu"), 5)
    dtu_launches = counts()
    print(f"mvr_uni_dtu.yml: 2 warm-up steps, the resample and 2 projected steps "
          f"in {wall_e:.2f} s, steps " + ", ".join(
              f"{rec_e['ms'][i]:.1f}" for i in range(5)) +
          f" ms; launches {dtu_launches}; fused_mlp by mode {dict(rec_e['mlp'])}")
    for name in ("fused_mlp", "fused_sampler", "knn", "splat_select", "splat_fine"):
        if dtu_launches[name] <= 0:
            fail(f"mvr_uni_dtu.yml: kernel {name} was not launched")
    dtu_batch = lambda it: run_e.views(train_mvr.draw_views(0, it, 8))
    for project, it in ((False, 0), (True, run_e.state.it)):
        kernels_vs_plain(run_e.cfg, run_e.trainer, run_e.state, dtu_batch, it,
                         loss_keys, project=project)
    # launches in the two runs, each row's own: fused_mlp by mode, the
    # SIREN sampler by sweep
    for i, name in ((2, "knn"), (3, "splat_select"), (4, "splat_fine")):
        rows[i].update(lossS_dir_launches=dir_launches[name],
                       dtu_launches=dtu_launches[name])
    for i, key, val in ((0, "mlp", "f32"), (9, "mlp", "bf16"),
                        (1, "sweeps", "fine"), (10, "sweeps", "coarse")):
        rows[i].update(**{f"{run}_launches": sum(c for k, c in r[key].items()
                                                 if k[0] == val)
                          for run, r in (("lossS_dir", rec_b), ("dtu", rec_e))})

    # ---- 14. evaluate and generate through the entry points a user calls
    from isopoints_torch import evaluate as evaluate_entry
    from isopoints_torch import generate_mvr
    from isopoints_torch.data import synthetic
    from isopoints_torch.misc.checkpoints import CheckpointIO
    from isopoints_torch.models.generator import Generator, GeneratorConfig
    from isopoints_torch.ops import imls
    from isopoints_torch.ops.images import arange_pixels
    from isopoints_torch.training import evaluation
    from isopoints_torch.utils import meshing
    from isopoints_torch.utils.io import read_ply
    t14 = time.perf_counter()
    stage_s = collections.defaultdict(list)   # stage -> wall seconds a call
    seen = {"mlp": collections.Counter(), "sweeps": collections.Counter(),
            "grids": [], "overflow": [], "knn": []}

    timing = stage_timer(stage_s)

    def seen_siren(pack, x, with_grad, bf16=False):
        seen["mlp"][("bf16" if bf16 else "f32", "value+grad" if with_grad
                     else "value", x.shape[0])] += 1
        return siren_cuda(pack, x, with_grad, bf16)

    def seen_sweep(pack, cam, dirs, t_lo, t_hi, steps, n_secant, margin,
                   coarse_sweep=False, fine_bf16=False):
        seen["sweeps"][("coarse" if coarse_sweep else "fine", dirs.shape[0])] += 1
        return sweep_cuda(pack, cam, dirs, t_lo, t_hi, steps, n_secant, margin,
                          coarse_sweep, fine_bf16)

    grid_fn = meshing.eval_sdf_grid

    def seen_grid(sdf_fn, resolution, bbox_min, bbox_max, *args, **kw):
        seen["grids"].append((resolution, np.asarray(bbox_min, np.float64),
                              np.asarray(bbox_max, np.float64)))
        return grid_fn(sdf_fn, resolution, bbox_min, bbox_max, *args, **kw)

    render_fn = Generator.raytrace_images

    def seen_render(self, *args, **kw):
        out = render_fn(self, *args, **kw)
        seen["overflow"].append(self.overflow)
        return out

    def stage(key):
        v = stage_s[key]
        return f"{sum(v):.3f} s ({len(v)} call{'s' if len(v) != 1 else ''})"

    # (a) the validate cadence: the run of phase 13 (b) with an evaluation
    # and a mesh at its 4
    MVRT = trainer_mod.MVRTrainer
    dir_v = os.path.join("out", "torch_mvr_lossS_dir_validate")
    with patched(*((MVRT, k, timing(k, getattr(MVRT, k))) for k in
                   ("eval_step", "eval_step_full", "evaluate_mesh_vs_gt")),
                 (meshing, "extract_mesh", timing("visualize",
                                                  meshing.extract_mesh))):
        _, rec_v, wall_v = train("mvr_lossS_dir.yml", dir_v, 8,
                                 "--validate-every", "4", "--visualize-every", "4")
    m_v = rows_of(dir_v)
    ev_rows = [r for r in m_v if any(k.startswith("eval_") for k in r)]
    tr_rows = [r for r in m_v if r not in ev_rows]
    if [r["it"] for r in ev_rows] != [4] or [r["it"] for r in tr_rows] != list(range(8)):
        fail(f"validate cadence: eval rows at its {[r['it'] for r in ev_rows]}, "
             f"training rows at {[r['it'] for r in tr_rows]}")
    ev = {k: v for k, v in ev_rows[0].items() if k != "it"}
    ev_keys = {"eval_iou", "eval_rgb_mse", "eval_psnr", "eval_iou_full",
               "eval_psnr_full", "eval_mse_full", "eval_chamfer", "eval_chamfer_n"}
    if set(ev) != ev_keys or not all(np.isfinite(list(ev.values()))) or not (
            0.0 <= ev["eval_iou_full"] <= 1.0):
        fail(f"validate cadence: eval row {ev}")
    for name in ("model_best.npz", "000004_mesh.ply"):
        if not os.path.exists(os.path.join(dir_v, name)):
            fail(f"validate cadence: {name} was not written")
    if len(read_ply(os.path.join(dir_v, "000004_mesh.ply"))["faces"]) == 0:
        fail("validate cadence: the visualised mesh has no face")
    with np.load(os.path.join(dir_v, "model_best.npz")) as f:
        best_iou, best_keys = float(f["scalar:loss_val_best"]), set(f.files)
    if best_iou != ev["eval_iou_full"] or not any(
            k.startswith("saliency:") for k in best_keys):
        fail(f"validate cadence: model_best.npz holds iou {best_iou} and "
             f"saliency keys {sorted(k for k in best_keys if 'saliency' in k)}")
    # the evaluation draws from the generator chain: training rows equal
    # phase 13's uninterrupted run up to its 4, where it evaluates
    if repeat_equal and tr_rows[:5] != m_b[:5]:
        fail("validate cadence: the training rows of its 0-4 differ from "
             "phase 13's uninterrupted run")
    gap_v = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-6)
                for x, y in zip(tr_rows[:5], m_b[:5]) for k in loss_keys)
    print(f"validate cadence (mvr_lossS_dir.yml, 8 iterations, --validate-every 4 "
          f"--visualize-every 4) in {wall_v:.2f} s: the eval row at its 4 {ev}; "
          f"model_best.npz (iou_full {best_iou:.6f}, its saliency state) and "
          f"000004_mesh.ply written; training rows of its 0-4 against phase 13's: "
          f"bit for bit {tr_rows[:5] == m_b[:5]} (largest relative loss gap "
          f"{gap_v:.3g}), its 5-7 drawn after the evaluation")
    print(f"  the evaluation's wall time: eval_step (2 views x 4096 rays) "
          f"{stage('eval_step')}, eval_step_full (2 views at 512 px, 524,288 rays) "
          f"{stage('eval_step_full')}, evaluate_mesh_vs_gt (96³ mesh against "
          f"{len(ds.points)} GT points) {stage('evaluate_mesh_vs_gt')}; the "
          f"visualisation's 96³ mesh of the plain field {stage('visualize')}")

    # (b) generation at full size from phase 13's final checkpoint
    cfg_dir = os.path.join("isopoints_torch", "configs", "mvr_lossS_dir.yml")
    ckpt_b = os.path.join(dir_b, "model.npz")
    gen_dir = os.path.join(dir_b, "generation")
    shutil.rmtree(gen_dir, ignore_errors=True)
    stage_s.clear()
    reset()
    with patched((fused_mlp, "siren_forward_cuda", seen_siren),
                 (fused_sampler, "sweep_cuda", seen_sweep),
                 (meshing, "eval_sdf_grid", timing("grid", seen_grid)),
                 (meshing, "marching_tetrahedra",
                  timing("marching", meshing.marching_tetrahedra)),
                 (meshing, "largest_component",
                  timing("largest", meshing.largest_component)),
                 (Generator, "raytrace_images", timing("render", seen_render))):
        t = time.perf_counter()
        g_verts, g_faces, g_rgba = generate_mvr.main([
            cfg_dir, "--checkpoint", ckpt_b, "--out-dir", gen_dir,
            "--mesh-resolution", "256", "--image-size", "512", "--n-views", "4"])
        wall_g = time.perf_counter() - t
    gen_launches = counts()
    gen_mlp = collections.Counter(seen["mlp"])
    gen_sweeps = collections.Counter(seen["sweeps"])
    if [g[0] for g in seen["grids"]] != [100, 256]:
        fail(f"generation: grids at {[g[0] for g in seen['grids']]}, expected "
             f"[100, 256]")
    if (len(g_faces) == 0 or not np.isfinite(g_verts).all()
            or g_rgba.shape != (4, 512, 512, 4) or not np.isfinite(g_rgba).all()):
        fail(f"generation: {len(g_verts)} verts, {len(g_faces)} faces, images "
             f"{g_rgba.shape}")
    if {m for m, _, _ in gen_mlp} != {"f32", "bf16"} or not any(
            s == "coarse" for s, _ in gen_sweeps):
        fail(f"generation: fused_mlp by mode {dict(gen_mlp)}, the sampler by "
             f"sweep {dict(gen_sweeps)}")
    n_chunks = [-(-g[0] ** 3 // 262_144) for g in seen["grids"]]
    fine_lo, fine_hi = seen["grids"][1][1:]
    fine_spacing = float(np.max((fine_hi - fine_lo) / 255.0))
    print(f"generation (generate_mvr, mvr_lossS_dir.yml, phase 13's model at its "
          f"8, mesh 256, 4 views at 512 px) in {wall_g:.2f} s: {len(g_verts)} "
          f"verts, {len(g_faces)} faces; launches {gen_launches}; fused_mlp by "
          f"mode {dict(gen_mlp)}; the sampler by sweep {dict(gen_sweeps)}")
    print(f"  grids on the card (fused f32 value, 262,144-point chunks): 100³ "
          f"{1e3 * stage_s['grid'][0] / n_chunks[0]:.3f} ms a chunk ({n_chunks[0]} "
          f"chunks), 256³ in the PCA frame (spacing {fine_spacing:.6f}) "
          f"{1e3 * stage_s['grid'][1] / n_chunks[1]:.3f} ms a chunk ({n_chunks[1]} "
          f"chunks); marching tetrahedra on the host {stage('marching')}; largest "
          f"component {stage('largest')}; renders {1e3 * stage_s['render'][0] / 4:.1f} "
          f"ms a view (1,048,576 rays in chunks of 16,384 a view), overflow "
          f"{seen['overflow']}")

    # (c) the kernels against their plain versions on this phase's shapes
    model_g = create_model(run_b.cfg, device=dev)
    ck = CheckpointIO(dir_b, model=model_g.state_dict())
    ck.load("model.npz")
    model_g.load_state_dict(ck.registry["model"])
    f_g = model_g.trace_sdf_fn()
    fc_g = model_g.trace_sdf_fn_coarse()
    g_pack = f_g.pack
    g_plain, g_plain_c = fused_mlp.PlainSDF(g_pack), fused_mlp.PlainSDF(g_pack, "bf16")
    g_w_bytes = 4 * sum(w.numel() + b.numel() for w, b in zip(g_pack.ws, g_pack.bs))
    # one 262,144-point chunk of a 256³ grid over the box, its middle
    ax = torch.from_numpy(np.linspace(-1.0, 1.0, 256).astype(np.float32)).to(dev)
    idx = torch.arange(32 * 262_144, 33 * 262_144, device=dev)
    chunk_pts = torch.stack([ax[idx // 65536], ax[(idx // 256) % 256], ax[idx % 256]], -1)
    v_k, v_p = f_g(chunk_pts), fused_mlp.siren_sdf_plain(g_pack, chunk_pts)
    grid_err = float((v_k - v_p).abs().max())
    if not (grid_err <= 2e-5 and torch.isfinite(v_k).all()):
        fail(f"fused_mlp on a grid chunk: max err {grid_err} > 2e-5")
    grid_ms = time_ms(lambda: f_g(chunk_pts))
    grid_pms = time_ms(lambda: fused_mlp.siren_sdf_plain(g_pack, chunk_pts))
    grid_b = bound_ms(3 * mlp_flops(262_144, g_pack.hidden, g_pack.n_hidden),
                      262_144 * 16 + g_w_bytes, TF32_PEAK)
    print(f"fused_mlp f32 value on a 262,144-point grid chunk of phase 13's model: "
          f"max_abs_err {grid_err:.3g} (tol 2e-5)  kernel {grid_ms:.4f} ms  plain "
          f"{grid_pms:.4f} ms  bound {grid_b[0]:.4f} ms ({grid_b[1]})")
    # the whole 256³ mesh from the plain grid
    t = time.perf_counter()
    p_verts, p_faces = meshing.get_surface_high_res_mesh(g_plain, 256, device=dev)
    plain_mesh_s = time.perf_counter() - t
    face_gap = abs(len(p_faces) - len(g_faces)) / max(len(p_faces), 1)
    mesh_cd = evaluation.chamfer_distance(torch.from_numpy(g_verts).to(dev),
                                          torch.from_numpy(p_verts).to(dev))["chamfer_p"]
    print(f"the 256³ mesh from the kernel grid against the one from the plain grid "
          f"({plain_mesh_s:.2f} s): faces {len(g_faces)} / {len(p_faces)} (gap "
          f"{face_gap:.2e}, bar 1e-3); the vertices' chamfer {mesh_cd:.3g} (bar "
          f"(spacing / 10)² = {(fine_spacing / 10) ** 2:.3g})")
    if face_gap > 1e-3 or not mesh_cd <= (fine_spacing / 10) ** 2:
        fail("the kernel grid's mesh disagrees with the plain grid's beyond the bars")
    # one 16,384-ray render chunk a view, on the kernel routes and the plain
    gen_g = Generator(model_g, GeneratorConfig(image_size=512))
    rt_g = gen_g.render_cfg()
    n4 = 4
    R4, T4 = look_at_view_transform(
        [run_b.cfg.data.get("camera_distance", 2.0)] * n4, [15.0] * n4,
        np.linspace(0, 360, n4, endpoint=False), device=dev)
    cam4 = PerspectiveCamera.create(R=R4, T=T4, focal_length=run_b.cfg.data.get(
        "focal_length", 2.0), device=dev)
    ndc4 = arange_pixels((512, 512), n4, device=dev)[1][:, 7 * 16384:8 * 16384]
    captured = {}
    g_sampler = f_g.fused_ray_sampler

    def g_recording_sampler(*args, n_secant, margin, coarse_sweep):
        if n_secant > 0:
            captured.setdefault("sampler", args + (n_secant, margin, coarse_sweep))
        return g_sampler(*args, n_secant=n_secant, margin=margin,
                         coarse_sweep=coarse_sweep)
    g_recording_sampler.packing_stride = g_sampler.packing_stride
    f_g.fused_ray_sampler = g_recording_sampler
    rgba_k, ovf_k = gen_g.render_chunk(ndc4, cam4, f_g, fc_g, rt_g)
    f_g.fused_ray_sampler = g_sampler
    reset()
    rgba_p, ovf_p = gen_g.render_chunk(ndc4, cam4, g_plain, g_plain_c, rt_g)
    torch.cuda.synchronize()
    if any(counts().values()):
        fail(f"the plain render chunk launched kernels: {counts()}")
    a_k, a_p = rgba_k[..., 3] > 0.5, rgba_p[..., 3] > 0.5
    alpha_eq = float((a_k == a_p).float().mean())
    # the hits' depths: on this dense level set a ray may stop at another
    # crossing on one route; the colours are held where the hit is the same
    c4, d4 = cam4.ndc_to_rays(ndc4)
    ones4 = torch.ones(d4.shape[:-1], dtype=torch.bool, device=dev)
    with torch.no_grad():
        z_k = raytracing.ray_trace(f_g, c4[:, None, :], d4, ones4, None, rt_g,
                                   training=False, sdf_fn_coarse=fc_g).dists
        z_p = raytracing.ray_trace(g_plain, c4[:, None, :], d4, ones4, None, rt_g,
                                   training=False, sdf_fn_coarse=g_plain_c).dists
    both = a_k & a_p
    same_z = both & ((z_k - z_p).abs() <= 1e-4)
    z_share = float(same_z.sum()) / max(int(both.sum()), 1)
    rgb_d = (rgba_k[..., :3] - rgba_p[..., :3]).abs().amax(-1)
    rgb_err = float(rgb_d[same_z].max()) if bool(same_z.any()) else 0.0
    rgb_all = float(rgb_d[both].max()) if bool(both.any()) else 0.0
    rend_ms = time_ms(lambda: gen_g.render_chunk(ndc4, cam4, f_g, fc_g, rt_g), reps=3)
    rend_pms = time_ms(lambda: gen_g.render_chunk(ndc4, cam4, g_plain, g_plain_c,
                                                  rt_g), reps=3)
    print(f"render chunk (4 views x 16,384 rays, the image's rows 224-255): alpha "
          f"equal on {alpha_eq:.6f} of the rays (bar 0.999; {int(a_k.sum())} / "
          f"{int(a_p.sum())} hits); hit depths within 1e-4 on {z_share:.6f} of the "
          f"rays both hit (bar 0.999), and there RGB max err {rgb_err:.3g} (bar "
          f"1e-3; on all rays both hit {rgb_all:.3g}, {int((rgb_d[both] > 1e-3).sum())} "
          f"rays beyond 1e-3); overflow {int(ovf_k)} / {int(ovf_p)}; kernels "
          f"{rend_ms:.2f} ms, plain {rend_pms:.2f} ms")
    if (alpha_eq < 0.999 or z_share < 0.999 or rgb_err > 1e-3
            or int(a_k.sum()) == 0):
        fail("the render chunk on the kernel routes disagrees with the plain routes")
    # the render's coarse sampler at its captured shape
    *gs_args, gs_nsec, gs_margin, gs_coarse = captured["sampler"]
    gs_rays, gs_steps = gs_args[1].reshape(-1, 3).shape[0], gs_args[4].shape[0]
    gs_kw = dict(n_secant=gs_nsec, margin=gs_margin, coarse_sweep=gs_coarse)
    gs_out = g_sampler(*gs_args, **gs_kw)
    gs_ref = fused_sampler.sweep_plain(g_plain, *gs_args, gs_nsec, gs_margin,
                                       sdf_fn_coarse=g_plain_c if gs_coarse else None)
    gs_same = (gs_out[0] == gs_ref[0]) & (gs_out[2] == gs_ref[2])
    gs_frac = float(gs_same.float().mean())
    gs_err = float((gs_out[1] - gs_ref[1])[gs_same].abs().max())
    if not gs_coarse or gs_frac < 0.99 or gs_err > 1e-5:
        fail(f"the render's sampler (coarse {gs_coarse}): picks equal on "
             f"{gs_frac:.5f} (bar 0.99), f_pick err {gs_err} (bar 1e-5)")
    gs_ms = time_ms(lambda: g_sampler(*gs_args, **gs_kw))
    gs_pms = time_ms(lambda: fused_sampler.sweep_plain(
        g_plain, *gs_args, gs_nsec, gs_margin, sdf_fn_coarse=g_plain_c), reps=3)
    g_flops = mlp_flops(1, g_pack.hidden, g_pack.n_hidden)
    gs_b = (1e3 * max(g_flops * gs_rays * gs_steps / BF16_PEAK
                      + 3 * g_flops * gs_rays * (2 + gs_nsec) / TF32_PEAK,
                      (gs_rays * 48 + 4 * gs_steps + 2 * g_w_bytes) / HBM_RATE),
            "operations")
    print(f"fused_sampler (SIREN, coarse sweep) on the render chunk's {gs_rays}-ray "
          f"buffer x {gs_steps} steps + {gs_nsec} secant: picks equal to the plain "
          f"version on {gs_frac:.5f}, f_pick err {gs_err:.3g}; kernel {gs_ms:.3f} ms  "
          f"plain {gs_pms:.3f} ms  bound {gs_b[0]:.4f} ms")
    # the render's most frequent bf16 launch, on phase 10's field of the width
    (_, gb_what, gb_n), _ = max(((k, c) for k, c in gen_mlp.items() if k[0] == "bf16"),
                                key=lambda kc: (kc[1], kc[0][2]))
    gb_err, gb_ms, gb_pms, gb_b = check_siren_bf16(gb_n, gb_what == "value+grad")

    # (d) the evaluate entry on (b)'s directory, and a known answer: the
    # analytic torus meshed at 256, its chamfer on the card and on the CPU
    # (the plain kNN) against the same GT points and samples. The CPU's runs
    # in a process of its own beside the entry, which keeps the card busy
    gt_t = evaluate_entry.analytic_gt_points("torus", 50000, dev)
    t_v, t_f = meshing.extract_mesh(synthetic.torus_sdf(), 256, device=dev)
    s_t, _ = meshing.sample_points_from_mesh(t_v, t_f, 50000, seed=0)
    ka_dir = os.path.join(ROOT, "out", "torch_known_answer")
    os.makedirs(ka_dir, exist_ok=True)
    np.save(os.path.join(ka_dir, "samples.npy"), s_t)
    np.save(os.path.join(ka_dir, "gt.npy"), gt_t)
    ka_proc = subprocess.Popen(
        [sys.executable, "-c", KNOWN_ANSWER_CPU, ROOT, ka_dir],
        stdout=subprocess.PIPE, text=True)
    stage_s.clear()
    seen["mlp"].clear()
    reset()
    torch.cuda.reset_peak_memory_stats()
    knn_fn = evaluation.knn_points

    def seen_knn(query, points, *args, **kw):
        seen["knn"].append((query.shape[1], points.shape[1], kw.get("k")))
        return knn_fn(query, points, *args, **kw)

    try:
        with patched((fused_mlp, "siren_forward_cuda", seen_siren),
                     (evaluate_entry, "analytic_gt_points",
                      timing("gt", evaluate_entry.analytic_gt_points)),
                     (evaluation, "sample_points_from_mesh",
                      timing("sample", evaluation.sample_points_from_mesh)),
                     (evaluation, "chamfer_distance",
                      timing("chamfer", evaluation.chamfer_distance)),
                     (evaluation, "knn_points", timing("knn", seen_knn)),
                     (evaluation, "point_face_distance",
                      timing("point_face", evaluation.point_face_distance))):
            t = time.perf_counter()
            ev_rows_d = evaluate_entry.main([gen_dir, "--gt-sdf", "torus",
                                             "--n-samples", "50000"])
            wall_d = time.perf_counter() - t
        eval_launches = counts()
        t = time.perf_counter()
        ka_out, _ = ka_proc.communicate(timeout=900)
        ka_wait_s = time.perf_counter() - t
    finally:
        if ka_proc.poll() is None:
            ka_proc.kill()
            ka_proc.wait()
    if ka_proc.returncode != 0:
        fail(f"the known answer's CPU chamfer exited with {ka_proc.returncode}")
    ka_cpu, ka_cpu_s = (json.loads(ka_out.splitlines()[-1])[k] for k in ("chamfer_p", "s"))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(os.path.join(gen_dir, "eval.csv")) as f:
        csv_rows = f.read().splitlines()
    cols = csv_rows[0].split(",") if csv_rows else []
    d_row = ev_rows_d[0] if ev_rows_d else {}
    if (cols != ["mesh", "chamfer_p", "point_face_rev"] or len(csv_rows) != 2
            or not all(np.isfinite(d_row[k]) for k in cols[1:])):
        fail(f"evaluate: eval.csv {csv_rows[:2]}")
    if eval_launches["knn"] != 2 or seen["knn"] != [(50000, len(gt_t), 1),
                                                    (len(gt_t), 50000, 1)]:
        fail(f"evaluate: kNN launches {eval_launches['knn']}, calls {seen['knn']}")
    print(f"evaluate --gt-sdf torus --n-samples 50000 on {gen_dir} in {wall_d:.2f} "
          f"s: {d_row} (no chamfer_n: the analytic GT carries no normals, as in "
          f"evaluate.py); launches {eval_launches}; the GT's Newton projection "
          f"{stage('gt')}, sampling {stage('sample')}, chamfer {stage('chamfer')} "
          f"(its two kNN calls {stage('knn')}), point-face {stage('point_face')}; "
          f"peak device memory {peak_gb:.2f} GiB")
    ka_gpu = evaluation.chamfer_distance(torch.from_numpy(s_t).to(dev),
                                         torch.from_numpy(gt_t).to(dev))["chamfer_p"]
    ka_rel = abs(ka_gpu - ka_cpu) / ka_cpu
    print(f"known answer: the analytic torus meshed at 256³ ({len(t_f)} faces), "
          f"50,000 samples against the {len(gt_t)} GT points: chamfer_p on the card "
          f"{ka_gpu:.9g}, on the CPU {ka_cpu:.9g} ({ka_cpu_s:.1f} s in its own "
          f"process beside the evaluate entry, {ka_wait_s:.1f} s waited for after "
          f"it; relative gap {ka_rel:.3g}, bar 1e-5); bar {TORUS_CHAMFER_BAR:g}")
    if ka_rel > 1e-5 or not ka_gpu < TORUS_CHAMFER_BAR:
        fail("the known answer's chamfer disagrees with the CPU's or exceeds its bar")
    # the chamfer's kNN at 50,000 x 50,000, k = 1, against the plain version
    cq = torch.from_numpy(s_t).to(dev)[None]
    cp = torch.from_numpy(gt_t).to(dev)[None]
    ones_q = torch.ones(cq.shape[:2], dtype=torch.bool, device=dev)
    ones_p = torch.ones(cp.shape[:2], dtype=torch.bool, device=dev)
    knn_equal(cq, cp, ones_q, ones_p, 1, False, "chamfer 50,000 x 50,000")
    ck_ms = time_ms(lambda: knn.knn_points(cq, cp, k=1))
    ck_pms = time_ms(lambda: knn.knn_points(cq, cp, k=1, method="dense"), reps=3)
    ck_b = bound_ms(9.0 * cq.shape[1] * cp.shape[1],
                    (cq.shape[1] + cp.shape[1]) * 13 + cq.shape[1] * 12)
    print(f"knn (the chamfer's, {cq.shape[1]} x {cp.shape[1]}, k=1, the Morton "
          f"route): distances and indices equal to the plain version; kernel "
          f"{ck_ms:.4f} ms  plain {ck_pms:.3f} ms  bound {ck_b[0]:.4f} ms "
          f"({ck_b[1]})")

    # (e) the point model's mesh after phase 9's steps: IMLS on the kNN
    captured_knn = []
    imls_knn = imls.knn_points

    def imls_recording_knn(*args, **kw):
        captured_knn.append((args, kw))
        return imls_knn(*args, **kw)

    reset()
    with patched((imls, "knn_points", imls_recording_knn)):
        t = time.perf_counter()
        pm_verts, pm_faces = pmodel.generate_mesh(resolution=128)
        torch.cuda.synchronize()
        pm_mesh_s = time.perf_counter() - t
    imls_launches = counts()
    if len(pm_faces) == 0 or imls_launches["knn"] != 8 or len(captured_knn) != 8:
        fail(f"point model mesh: {len(pm_faces)} faces, {imls_launches['knn']} kNN "
             f"launches (expected 8)")
    (iq, ip, iqm, ipm), ikw = captured_knn[3][0][:4], captured_knn[3][1]
    ipm = torch.ones(ip.shape[:2], dtype=torch.bool, device=dev) if ipm is None else ipm
    iqm = torch.ones(iq.shape[:2], dtype=torch.bool, device=dev) if iqm is None else iqm
    knn_equal(iq, ip, iqm, ipm, ikw["k"], False, "IMLS chunk")
    im_ms = time_ms(lambda: knn.knn_points(iq, ip, iqm, ipm, k=ikw["k"]))
    im_pms = time_ms(lambda: knn.knn_points(iq, ip, iqm, ipm, k=ikw["k"],
                                            method="dense"), reps=3)
    im_b = bound_ms(9.0 * iq.shape[1] * ip.shape[1],
                    iq.shape[1] * 13 + ip.shape[1] * 13 + iq.shape[1] * ikw["k"] * 12)
    print(f"point model mesh (IMLS at 128³ = 2,097,152 queries x {ip.shape[1]} "
          f"points, k={ikw['k']}): {len(pm_verts)} verts, {len(pm_faces)} faces in "
          f"{pm_mesh_s:.2f} s; launches {imls_launches}; a chunk's kNN "
          f"({iq.shape[1]} queries) equal to the plain version bit for bit; kernel "
          f"{im_ms:.4f} ms  plain {im_pms:.3f} ms  bound {im_b[0]:.4f} ms ({im_b[1]})")

    # the SIREN-path rows with this phase's shapes and launches: in (b) and
    # (d), not the comparisons of (c)
    gen_launch = lambda mode: sum(c for k, c in gen_mlp.items() if k[0] == mode) + \
        sum(c for k, c in seen["mlp"].items() if k[0] == mode)
    rows[0].update(generate_launches=gen_launch("f32"),
                   generate_shape="value, a 262,144-point 256³ grid chunk",
                   generate_max_abs_err=grid_err, generate_ms=grid_ms,
                   generate_plain_ms=grid_pms, generate_bound_ms=grid_b[0],
                   generate_bound_by=grid_b[1])
    rows[9].update(generate_launches=gen_launch("bf16"),
                   generate_shape=f"{gb_what}, {gb_n} points (the renders' most "
                   f"frequent)", generate_max_abs_err=gb_err, generate_ms=gb_ms,
                   generate_plain_ms=gb_pms, generate_bound_ms=gb_b[0],
                   generate_bound_by=gb_b[1])
    rows[10].update(generate_launches=sum(c for k, c in gen_sweeps.items()
                                          if k[0] == "coarse"),
                    generate_shape=f"{gs_rays} rays x {gs_steps} + 2 + {gs_nsec} "
                    f"(a render chunk's buffer)", generate_max_abs_err=gs_err,
                    generate_ms=gs_ms, generate_plain_ms=gs_pms,
                    generate_bound_ms=gs_b[0], generate_bound_by=gs_b[1])
    rows[2].update(evaluate_launches=eval_launches["knn"],
                   evaluate_shape=f"{cq.shape[1]} x {cp.shape[1]}, k=1",
                   evaluate_ms=ck_ms, evaluate_plain_ms=ck_pms,
                   evaluate_bound_ms=ck_b[0], evaluate_bound_by=ck_b[1],
                   imls_launches=imls_launches["knn"],
                   imls_shape=f"{iq.shape[1]} x {ip.shape[1]}, k={ikw['k']}",
                   imls_ms=im_ms, imls_plain_ms=im_pms, imls_bound_ms=im_b[0],
                   imls_bound_by=im_b[1])
    print(f"phase 14: {time.perf_counter() - t14:.1f} s")

    # ---- 15. the DTU point-cloud workload, uncut
    dtu = dtu_phase(dev, kernels)
    rows[0].update(dtu["fused_mlp"])
    rows[2].update(dtu["knn"])

    # ---- 16. the ablation's data, arms, summary and scripts; DVR, occupancy, taps
    rows.append(ablation_phase(dev, kernels))

    # ---- 17. configs/dtu_mvr.yml at full width; 18. parallel/ at world size 1
    g_launches, g_run = dtu_mvr_phase(dev, kernels)
    for r in rows:
        r["dtu_mvr_launches"] = g_launches[kernel_of(r["source"])]
    parallel_phase(dev, g_run)

    # ---- 19. the point-set library at full width
    rows[2].update(pointset_phase(dev, kernels, p4, scene, pmodel, pcam))

    # ---- 20. the published IGR network on the wide instances of the MLP tile
    rows.extend(igr_wide_phase(dev, kernels))

    # ---- 21. the presweep, the plots, the checkpoint backend, measure_scaling
    anim = sorted(glob.glob(os.path.join(ROOT, "out", "torch_dtu_points", "*_iso.ply")))
    anim.append(os.path.join(ROOT, "out", "torch_mvr_lossS_dir_validate",
                             "000004_mesh.ply"))
    for i, kv in refusals_phase(dev, kernels, p6, p4, anim, g_run).items():
        rows[i].update(kv)

    # ---- 22. sample_world_points, the clip planes, no off-surface samples
    for i, kv in surface_phase(dev, kernels, p4).items():
        rows[i].update(kv)

    print(f"chip_smoke: {time.time() - t_start:.1f} s from the CUDA check to "
          f"the kernels line, the build included")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
