#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flink_ml_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root

It needs a CUDA card and exits non-zero without one, and on any failed
phase; it imports nothing of JAX or of the JAX package. Phases 1-14 run
under the port's runtime concurrency sanitizer
(`flink_ml_tpu_torch/analysis/sanitizer.py`, enabled before phase 1):
every flow channel's condition, `capture_lock` and the tracing lock are
recorded, every pump and spawn worker and every channel is ledgered, and
after phase 14 any lock-order cycle, leaked worker or unclosed pump
channel fails the run; its stats (acquisitions, locks, edges, workers,
channels) are printed on a `sanitizer` line. Phases:

1. device: the card's name and power limit (nvidia-smi); the build of
   `flink_ml_tpu_torch/csrc/sparse_kernels.cu`, of the SGD engine's epoch
   kernels `csrc/sgd_epoch.cu`, of the floor probes
   `csrc/probes.cu` and of the replaced designs `csrc/designs.cu`, one
   nvcc each, started together; the registers of each kernel (cuobjdump
   -res-usage) and a look at the SASS: no kernel adds with ATOMG;
   sparse_grad adds to device memory with RED and in shared memory (ATOMS;
   its forms are printed), fleet_grad only with bulk reductions (no float
   RED), fleet_row_dots loads with 128-bit global loads;
2. each kernel against its plain PyTorch version, on seeded inputs with
   -1 padding and indices >= d: at edge shapes, on the index-convention
   probe, at the main path's shapes (the fit batch, 100,000 x 39, the
   1M-row transform, one rank's share of the fit batch on phase 16's
   mesh of 4, 25,000 x 39, and the 2D local scatter of phase 17's 2 x 2
   mesh, 50,000 x 39 into d = 500,000 with half the slots -1), on
   Zipf-skewed indices at the fit batch (values on
   a grid of quarters, so the gradient must be exact), on a fit batch
   sliced at an odd row offset (not 16-byte aligned), on a wide row
   (16 x 5000), on a fit batch that overflows the gradient's table (35%
   of its slots on 128 hot columns, so each block's chunks repeat enough
   columns to stay on the table; 15% on the ~1,000 columns that hash into
   8 of its entries, so they find no entry and add with RED; half uniform,
   so each block claims past its flush threshold every two or three
   chunks and adds into the reset table after; quarter-grid values,
   exact; the kernel's own counters must show mid-walk flushes and probe
   overflows and no chunk added without the table), on a tiny d (7 columns
   for the whole fit batch; quarter-grid values, exact) and at the text
   path's fit batch (phase 7). Each gradient case also prints the walk's
   counters (`sparse_grad_walk`: mid-walk flushes, probe overflows, chunks
   added with direct REDs). Each case prints CUDA-event times of the
   kernel, the plain version, one PyTorch library call, the gradient's
   replaced design (the thread-per-slot RED kernel, `csrc/designs.cu`, held
   to the same gate) and, where the batch is aligned, the floor probes (a gather
   per slot; an atomic add per slot), beside the bound from the bytes
   moved. Then the member-batched (fleet) kernels: at edge shapes (one
   member, a tile of 8 and one more) in both layouts of the (N, d)
   operand and member-minor off 16-byte alignment, and at the sparse fleet
   fit's batch (N = 8, 100,000 x 39, d = 1e6), where the row dot must equal
   solo launches bit for bit at N = 1, 8 and 9 in both layouts; their
   times in both layouts, of the row dot's replaced design (the scalar
   loads) in both, of N solo launches, of the plain version, of one
   library call each (embedding_bag over a (d, N) table, index_add_ of
   (B * nnz, N) rows) and of the row dot's probe (two 16-byte loads a slot
   from a (d, 8) table); and at phase 17's shapes (`fleet_mesh_shapes`:
   N = 2 over the fit batch, the fleet-sharded regime's; N = 8 over
   25,000 rows, the default regime's on 4 ranks), each timed beside its
   plain version, a library call and the bound; then the SGD engine's
   epoch kernels (`csrc/sgd_epoch.cu`, `sgd_epoch_phase`): the update at
   d = 1e6 and d = 100 against its op sequence bit for bit (live, dead,
   wsum 0, no mask), the pointwise pass of each form over the fit batch
   with random weights and with the `row < n` weights of a ragged batch (its
   multiplier within one ulp, its sums within 1e-5 of torch.sum's, its
   tail the body's), each timed beside its bytes' bound and its plain
   version;
3. the main paths, each run as a user runs it (fit -> transform -> save ->
   load -> transform), with the launch counts reset just before each and
   read just after, at the conf/ configurations: LogisticRegression,
   LinearSVC and LinearRegression on dense data (10M x 100, maxIter 20,
   globalBatchSize 100,000, weighted) and on wide sparse data (1M rows,
   dim 1e6, 39 non-zeros per row), each sparse path on both kernels;
   KMeans (1M x 100 uniform, k 10, maxIter 10, seed 2); the Pipeline
   StandardScaler -> OneHotEncoder (arity 10) -> VectorAssembler ->
   LogisticRegression on 1M rows of 100 features; and, on host data made
   from seeded numpy generators, the stream and online paths:
   LogisticRegression on a StreamTable of 10M x 100 rows in chunks of
   65,536 (out of core through the native data cache, built from
   native/src/datacache.cc at first use), KMeans on a StreamTable of its
   1M rows, OnlineLogisticRegression (FTRL) over 10M rows of a planted
   hyperplane (100 versions) and OnlineKMeans over the KMeans rows from
   the KMeans model (10 versions);
4. the results: each dense fit against a float64 numpy replay of the same
   epochs on the same rows and a refit bit for bit, each sparse fit
   against the same fit on the plain loss on the card, the transforms
   against float64 or plain references; KMeans against a float64 Lloyd
   from the same init rows, its assignments against float64 distances
   outside a 1e-4 relative margin, a refit bit for bit; the pipeline's
   scaler against float64 statistics, its one-hot indices against
   numpy's, its LogisticRegression against a float64 replay on the
   assembled matrix; the stream LR against the bounded fit of the rows its
   epochs train and a float64 replay, a fit that spills against its
   in-memory twin bit for bit; the stream KMeans against the float64
   Lloyd; every tenth FTRL version against a float64 replay; every
   OnlineKMeans version against a float64 update; every reloaded model
   predicts identically;
5. warm times: the median of five (LogisticRegression) or three warm fits
   and transforms of each configuration, and a torch.profiler pass over
   one warm dense and sparse LogisticRegression fit, a KMeans fit, a
   sparse transform and a pipeline transform (device time by kernel, the
   device's idle share); two warm runs of each stream and online path
   (ingest and fit; versions a second and the parts of a version timed
   apart) and a profiler pass over each (idle share, upload overlap);
   the seconds of each path and of the whole run;
6. the fifteen numeric feature stages at their conf/ shapes, on data born
   on the card (10M rows; 1M for MinMaxScaler and Bucketizer): each
   fit -> transform -> save -> load -> transform bit for bit, three warm
   fits and transforms, its peak memory and launch counts (0), then a
   float64 replay on the card: exact for the comparisons, selections and
   order statistics (Binarizer, VectorSlicer, Bucketizer, KBins bins and
   edges, VectorIndexer, the MaxAbs and MinMax extremes, the quantiles'
   order statistics, the Imputer median and mode), within 1e-6 of the
   largest replay value for the elementwise and affine stages, within 1e-5
   for DCT, the variances and the Imputer mean. Twins: Imputer median and
   most_frequent on 1% NaN, KBins quantile and kmeans, Bucketizer with NaN
   and out-of-range values under keep and skip, VectorIndexer with three
   categorical columns and unseen values; and the StreamTable fits of
   RobustScaler, KBins quantile and Imputer median on 1M x 10 seeded numpy
   host chunks, each within relativeError x n ranks of the exact
   quantiles. A profiler pass over a few of them;
7. the text path, StopWordsRemover -> HashingTF (2^18 features) -> IDF ->
   LogisticRegression (the conf/ LR params) on a DictTokenMatrix of
   1M x 100 ids born on the card over 1,000 terms (the first 100 English
   stop words) with planted labels: fit -> transform -> save -> load ->
   transform bit for bit, its launch counts equal to the sparse LR path's
   (22 row dots, 20 gradients); StopWordsRemover and HashingTF against
   numpy replays and the IDF values against float32(v) * float32(idf),
   exactly; the fit against the same fit on the plain loss (1e-4);
   accuracy above 0.7; warm times and a profiler pass. Phase 2 holds both
   kernels at its fit batch (100,000 x 100, d = 2^18; the gradient, whose
   ~900 hashed columns each sum ~10,000 float terms, within the float32
   summation bound). Then the nine string and token stages at their conf/
   shapes (CountVectorizer, NGram, StopWordsRemover, HashingTF on token
   matrices born on the card; IDF on 10M x 10 dense; FeatureHasher,
   RegexTokenizer, Tokenizer, StringIndexer on seeded numpy host columns,
   FeatureHasher through native/src/hashkernels.cc built at first use):
   fit -> transform -> save -> load -> transform bit for bit, three warm
   calls, peak memory, launch counts (0), an exact replay (numpy on the
   host, or on the card in integers or float64);
8. the evaluation path: the text path's table split by RandomSplitter
   (0.8, 0.2), the text pipeline fitted on the first part, the second part
   transformed and scored by BinaryClassificationEvaluator (all four
   metrics), then save -> load -> transform -> evaluate bit for bit; its
   launch counts equal to the sparse LR path's (22 row dots, 20
   gradients), the split equal to a numpy replay of the draw row for row,
   the fit within 1e-4 of the plain-loss fit, the metrics within 1e-9 of
   the float64 numpy oracle on the same scores, a held-out AUC above 0.9;
   warm times and a profiler pass. Then the statistics slice at its
   shapes on data born on the card: NaiveBayes (1M x 10, arity 5, labels
   2; model data equal to an integer replay, predictions to the float64
   argmax), UnivariateFeatureSelector (10M x 100, labels 10, ANOVA;
   F-statistics within 1e-4 of a float64 replay, the selection equal but
   for features within 1e-6 of the cut's p-value), Knn (20,000 x 50,
   labels 2, k 5; predictions equal to float64 neighbours outside a 1e-4
   margin), ChiSqTest, ANOVATest and FValueTest (1M x 10, both flatten
   forms; against float64 replays, statistics within 1e-6 relative and
   p-values within 1e-6 of the largest, chi-square counts exact) and RandomSplitter on a dense, a SparseBatch and a
   DictTokenMatrix column (1M rows): each through fit -> transform ->
   save -> load -> transform bit for bit, three warm calls, peak memory,
   launch counts (0), the host paths taken; then functions.py's round
   trips;
8b. the evaluation Graph: RandomSplitter (0.8, 0.2) as a node with two
   outputs, StopWordsRemover and HashingTF on each part, IDF fitted on the
   train part transforming the test part, LogisticRegression (conf/
   params) fitted on the train features transforming the test features,
   BinaryClassificationEvaluator, and a model-data edge from the LR to a
   twin LogisticRegressionModel on the test features, on phase 7's 1M x 100
   ids: Graph.fit -> GraphModel.transform -> save -> load -> transform bit
   for bit; the fit launches 22 row dots and 20 gradients, a transform 2 row
   dots; the LR within 1e-4 of the plain-loss fit, the metrics within 1e-9
   of the float64 oracle and 1e-6 of phase 8's, the twin's predictions
   equal to the LR node's; warm times and a profiler pass;
9. AgglomerativeClustering at conf/ (1000 x 100 uniform, ward, 10
   clusters; the merge loop native/src/agglomerative.cc built at first use)
   with twins (complete, single and average linkage, cosine, a distance
   threshold, the full tree, count and event-time windows, a 10,000-row
   ward run), each against the numpy merge loop exactly (but the
   10,000-row one) and, for the four linkages, against scipy's linkage
   (merge distances 1e-9, the flat partition); SQLTransformer at conf/
   (100M float64 rows, ABS, exact on the card and in a numpy replay of a
   sample) with a WHERE twin (10M rows, 1% NaN, a 100-wide vector column
   passed through; a numpy replay of SQL's three-valued logic) and a
   GROUP BY twin on the sqlite path (against sqlite3); MinHashLSH (5 tables
   x 3 functions, seed 2022) on phase 3's sparse shape with 1% planted
   near-duplicates: the coefficients against a java.util.Random replay, the
   hashes against an int64 numpy replay, the neighbours of 10 planted keys
   and a 10,000 x 10,000 similarity join against set replays; each through
   fit -> transform -> save -> load -> transform bit for bit, warm calls,
   peak memory, launch counts (0); then window_all_and_process over 1M rows
   (count, event-time tumbling and session windows) against numpy
   groupings;
10. FitFleet and the reference-format loader: a sparse LR fleet of 8
   members (learningRate {0.1, 0.05} x reg {0, 1e-3} x elasticNet
   {0, 0.5}, the last at maxIter 10; conf/ LR params) on phase 3's sparse
   table, which must launch 20 fleet row dots and 20 fleet gradients and
   no solo kernel, each member held against the same fleet on the plain
   versions on the card (1e-4 of its coefficients' scale, plus one L1 step
   on each side of 0 where elasticNet * reg > 0; its loss within 1e-3,
   its epochs equal), its gap from its solo kernel fit printed; a dense LR
   fleet of the same 8 members on phase 3's weighted 10M x 100 table, each
   member within 1e-3 of a float64 replay of its own epochs (with its
   proximal steps) and a refit bit for bit; a KMeans fleet (1M x 100,
   k 10, seeds 2-5, the last at maxIter 5), each member within 1e-3 of a
   float64 Lloyd from its init rows; a stream LR fleet of 4 members on the
   stream LR's 10M x 100 host rows in 100,000-row chunks, against the dense
   fleet on the rows its epochs train (bits expected, gate 1e-6); warm
   medians of three fleet fits beside the members' solo fits, peak memory
   and a profiler pass over a sparse fleet fit. Then the reference format:
   the sparse fleet's members scored by areaUnderROC, the winner and the
   KMeans fleet's first member written in the reference's binary layout
   with the port's encoders, loaded through load_stage and applied to the
   full tables (the winner on one solo row dot), bit for bit as the same
   model saved and loaded as npz; every committed tests/fixtures/
   reference_* directory loaded and applied on the card to the values the
   tests expect, and round-tripped through npz bit for bit;
11. fused transforms (the transform fusion planner, pipeline.py): phase 3's
   sparse LR model alone in a PipelineModel on its 1M x 39 (d = 1e6) table
   and on a 1,024-row slice, one fused segment captured as a CUDA graph
   on the first call, one sparse_row_dots launch a replay, equal bit for
   bit to the eager path and to the model's own transform, and a replay on
   a second batch of the same signature (every row moved down by one)
   equal to its eager transform and to phase 2's plain row dot; the guarded
   pipeline VectorAssembler (error; the 100 features split 60/40) ->
   StandardScaler -> Normalizer (p 2) -> Bucketizer (error; the weight
   column) -> Binarizer -> phase 3's dense LR model, at 1M and 1,024 rows:
   one segment of six stages, one transform host sync fused and two
   eager, a NaN planted in a copy raising VectorAssembler's message fused
   and eager, a guard-free two-stage twin paying none, and at 1M rows a
   second signature (1,024 rows fewer) captured into the segment's shared
   pool, which grows by its outputs and less than half the first
   capture's temporaries; the BASELINE
   pipeline planning no fused segment (OneHotEncoder hands VectorAssembler
   sparse columns, as in the JAX package) with phase 3's outputs; the
   online LR model in a PipelineModel with three versions published
   between transforms, each row stamped with its version and no capture
   after the first; every stage with a transform kernel alone at 1,024
   rows, captured and replayed equal to eager, on its batch and on a
   second one. Each fused path prints its first (capture) call, warm
   medians of five fused and five eager calls, the device's idle share of
   each (CUDA events: torch.profiler sees no kernel of a replayed graph)
   and the memory the graph keeps,
   counted directly: its static feed, and its segment's pool from the
   allocator's snapshot;
12. serving (`serving_phase`): phase 10's eight sparse LR members (d = 1e6),
   each alone in a PipelineModel registered in one ModelStore whose budget
   holds four members' constants (so traffic pages), with a quota of four
   requests each, served at buckets (64, 256, 1024, 4096), form_rows 4096
   and the default forming budget, window and admission: every (tenant x
   bucket) graph captured by `warmup` ahead of traffic; 20,000 requests of
   1-512 rows (log-uniform), each a slice of phase 3's 1M x 39 table, for
   tenants drawn by Zipf(1.1), all seeded, served through the pull loop
   and then through submit/results in each of "request", "fixed" and
   "continuous" mode from a producer thread that backs off on
   ServerOverloaded. Every served row equals its tenant's own transform of
   the same rows bit for bit (the three modes and the pull loop alike) and
   phase 2's plain row dot within ROW_DOTS_TOL; one sparse_row_dots launch
   and one transform host sync a dispatched batch; no capture after
   warmup and no "error" result; the store's ledgered model bytes within
   its budget at every page-in, and every page-out lowering
   torch.cuda.memory_allocated by at least the tenant's constant bytes.
   Then train while serving: phase 3's online LR behind a ModelLifecycle
   (a canary of 256 held-out rows), served in continuous mode while a
   trainer thread promotes 20 versions (phase 3's traced FTRL versions
   and their midpoints), sends a NaN-poisoned and a wrong-shape candidate
   (each refused once), reports a run of guard errors that rolls back to
   the last-good version (its arrays bit for bit, its original id) and
   promotes phase 10's dense fleet winner by held-out AUC: every result
   stamped with one version and equal to that version's eager transform,
   no capture. It prints requests/s and rows/s of each mode, health()'s
   p50/p99 by stage, rejected, expired and coalesced counts, the store's
   hits, misses and evictions, fused against eager warm medians at each
   bucket and the card's idle share (CUDA events);
13. checkpoint and recovery (`checkpoint_phase`) at phase 3's widths,
   each kill followed by a resume from the same directory: the dense LR
   checkpointed every epoch equal to phase 3's unchecked fit bit for bit,
   killed at the `chunk` site after chunk 7 and resumed bit for bit; the
   sparse LR (both kernels) fitted in a child process that is SIGKILLed
   once it printed its second committed cut, resumed in this process
   (launching row dots and gradients only for the epochs after the cut)
   within 1e-4 of the plain-loss fit, its gap from the unkilled fit printed
   beside the gap between two unkilled fits (ROADMAP C.21); kills at
   `snapshot.write`, at a shard write and at the manifest commit of 4
   simulated hosts, each leaving the previous cut restorable and, after the
   resume, no stray file, and a flipped byte in a shard falling back to the
   older cut with one digest mismatch; the stream LR at 10M x 100 in
   65,536-row chunks killed at an epoch and resumed bit for bit; the stream
   LR on its first 1M rows with 4 hosts and the cache's contents, resumed
   without reading its source; the out-of-core KMeans killed and resumed
   bit for bit; the online LR killed after version 50 of 100, republishing
   version 50 and every later version equal to an unkilled run's; phase
   10's sparse fleet every 5 epochs killed after chunk 2, on fleet kernels
   only, each member within phase 10's gate; the lifecycle killed at
   `lifecycle.swap` and rebuilt on its directory (the published and the
   last-good version served bit for bit, no capture); the supervisor on the
   dense LR with 4 hosts through a `host.hang.dispatch` hang (readmit) and
   a `host.die.commit` death (shrink), each recovered once, its cut swept,
   bit for bit. Each leg prints its wall, its cuts' bytes and ms a cut, its
   restores' ms, resume-to-first-epoch ms and the supervisor's detection
   ms, with the card's name and power limit;
14. the program funnel, the program bank and a traced run
   (`funnel_phase`): the dense LR (10M x 100), the sparse LR (1M x 39 of
   1e6), KMeans (1M x 100) and phase 10's 8-member sparse LR fleet, each
   fitted eagerly (`config.whole_fit = "off"`), through the funnel from an
   empty graph cache (one capture) and again (a replay, no capture): the
   dense and KMeans replays equal to the eager fits bit for bit, the
   sparse and fleet ones within the sparse gate; the replays launch 20
   row dots and 20 gradients (the sparse fit) and 20 + 20 fleet kernels
   (the fleet); the three walls, and a replay's median, device time (CUDA
   events) and idle share. Memory: the bytes the graph holds (freed when
   the cache drops it) equal to its measured kept bytes, which are its
   accounted buffers and outputs, all within the allocator's rounding, and
   less than half the fit's training data (the data on the card is read
   in place, not copied); no library state left by the capture; dropping
   the graph gives back its pool's whole reserve and nothing beyond what
   `make_room` counts for it; the first call's allocator peak at most the
   eager fit's plus the accounted bytes. A sweep: the sparse fit at another learning
   rate and an L2 regularisation replays the same graph (no capture),
   within the sparse gate (1e-4 of max |coeff|) of its eager fit, while a
   replay with the first fit's operands, or its reg alone, would be off by
   100 gates or more. The sparse fit on a copy of its data (other
   addresses) runs eagerly (no capture, no new graph) and the original
   data still replays, each within the sparse gate. The bank: a child process fills one
   (its server's warmup over two tenants at SERVE_BUCKETS, and the sparse
   fit), a fresh child warm-loads it (timed) and captures nothing in its
   warmup, its first 100 requests and its first fit (a bank hit); a
   changed fingerprint refuses the bank and a flipped byte one entry,
   each with one `bank.refused` tick. A traced run: the sparse LR
   pipeline's fit and transform from empty caches under the JSONL sink
   and the timeline: stage, iteration, compile, segment and readback
   spans whose parents resolve, `render_report`, the timeline's JSONL and
   Chrome round trips, a dispatch attribution whose parts sum to its
   window, the fit's ledger peak within the allocator's (the untracked
   bytes printed), a Prometheus snapshot with no name collision; then a
   profiler pass over each replayed fit (`utils/traceprof.py`, as every
   profiler pass since phase 5: its idle share);
15. the port's tpulint (`python -m flink_ml_tpu_torch.analysis
   --no-cache`) over this checkout, a cold lint in a fresh process (the
   coverage gates import the package where CUDA is present): its 20
   rules must run and it must exit 0; its wall and its census of
   suppressed findings by rule are printed. Then the interpretation gate
   (`analysis/spmd.py`): the SPMD interpreter must reach every per-rank
   loop phases 16-17 run (`spmd.RANKED_LOOPS`), each with collective
   events and a resolved operand at one call site or more; the count of
   ranked bodies and of events by kind are printed (phases 16-17 compare
   every rank's recorded collective sequence: the runtime half);
16. data-parallel training over a mesh of ranks (`mesh_phase`, A.10a):
   (a) MESH_RANKS (4) gloo ranks sharing this card, started by
   `flink_ml_tpu_torch.parallel.launcher.World` (spawned processes; each
   loads the kernels this process built, and runs under the sanitizer as
   one shard of the `mesh` group). Each rank makes phase 3's dense,
   sparse and KMeans tables again from their seeds and fits, through the
   estimators, the dense LR (10M x 100, weighted), the sparse LR (1M x
   39 of 1e6) and KMeans (1M x 100, k 10, maxIter 10) on its rows, each
   in plain and in overlap mode (`config.collective_overlap`), and the
   sparse LR a third time on the SparCML pair route
   (`collective_sparse_threshold` raised to MESH_PAIR_THRESHOLD), with its
   launch counts reset before and read after each fit (the sparse dense
   route: 20 row dots and 20 gradients a rank; the pair route 20 row
   dots), then every collective once on the card held to its definition
   (`collectives_check`: the ring's point-to-point staged through pinned
   host memory, C.27). Every rank ends with the same model bit for bit;
   each fit is held against phase 3's one-rank fit of the same data:
   dense within MESH_DENSE_TOL, sparse within phase 4's gate of the
   plain-loss fit, KMeans within MESH_KMEANS_SCALE_TOL of the scale with
   at most MESH_KMEANS_POINT_SHARE of the points in other cells; overlap
   against plain within the same (C.26); every rank's collective sequence
   equals the others' (`sanitizer.compare_rank_sequences`) and the
   sanitizer reports no problem. It prints each rank's launches, seconds
   and peak memory, rank 0's collective counters (calls, bytes, chunks,
   the sparse bytes against the dense-equivalent) and the gaps. (b) a
   one-rank NCCL world: every collective once on CUDA tensors over the
   world's group, held to its definition, nothing staged: the only run of
   the NCCL branch until a multi-card check exists. A rank that fails
   fails the run;
17. the rest of the multi-device layer (`mesh2d_phase`, A.10b), on phase
   16's world of four gloo ranks (`mesh2d_rank_job`, under the sanitizer,
   launch counts reset before and read after each fit on each rank): (a)
   phase 3's sparse LR through its estimator as a 2D fit on a 2 x 2 and a
   1 x 4 mesh (`mesh.create_mesh_2d`; coefficient slices over `model`,
   rows over `data`, the local gradient on `sparse_grad`, no row dot) and
   with `sparse_2d` "off" on 2 x 2 (the replicated reference: both
   kernels), each within phase 4's sparse gate of the one-rank plain-loss
   fit, every rank of a model column holding the same slice and every
   rank the same model bit for bit, and each axis's wire bytes as reckoned
   from the shapes (`mesh2d_wire_bytes`); (b) the budget case: the first
   MESH_BUDGET_ROWS rows at d = 1e6 under a per-rank `hbm_budget_bytes`
   between the 2D carries (4 d bytes) and the replicated ones (8 d): the
   2D fit admits and trains, the replicated staging raises
   HbmBudgetExceeded; (c) phase 10's 8-member sparse fleet on the ranks
   in the default regime (8 members over a rank's 25,000 rows a batch,
   each reduced on its own) and the fleet-sharded one (2 members a rank
   over every row, one gather), each member within phase 10's gate of
   phase 10's one-rank member, a default-regime member within the sparse
   gate of its solo fit on the mesh; (d) the stream LR (phase 3's first
   MAX_ITER batches) and the stream KMeans, each rank caching its rows,
   against phase 3's one-rank stream fits (MESH_DENSE_TOL; the KMeans gate
   of phase 16); (e) a checkpointed 2D fit on 2 x 2 killed at a chunk,
   resumed on 1 x 4 and on this one rank, within the sparse gate of the
   unkilled fit; then every rank's collective sequence compared by axis
   group (`sanitizer.compare_rank_sequences(mesh=)`) and the sanitizer's
   verdict; (f) the supervisor's shrink (`supervisor.supervise_world`): a
   checkpointed dense LR on 4 ranks in 2 hosts, host 1 dies at a dispatch
   boundary, the world is relaunched on the 2 survivors, whose resume is
   held within MESH_DENSE_TOL of phase 3's fit. It prints a `mesh2d` line;
18. the JAX package's examples on the port (`examples_phase`, A.18): one
   child process (`examples_child`) runs every `examples/*.py` in sorted
   order on the card, each rewritten from `flink_ml_tpu` to
   `flink_ml_tpu_torch` (`example_source`; the one unused `import jax`
   line of pipeline_serving_example.py is dropped, as this machine has no
   JAX, and a literal `/tmp/` path moves under a directory of the child's
   own, made in its TMPDIR and removed after), in-process with
   `__name__ == "__main__"` and its asserts active, with no device request (the card), under the runtime sanitizer. It
   fails the run if an example raises or prints nothing, if the sanitizer
   reports a problem, or if sparse_wide_lr_example.py launches no
   `sparse_row_dots` or no `sparse_grad` (counts reset before each example
   and read after). It prints each example's seconds, the launches of
   each example that made any and the multi-tenant store's stats line,
   and an `examples` line;
19. the port's benchmark CLI (`benchmark_phase`, A.3a): one child process
   (`benchmark_child`) runs `python -m flink_ml_tpu_torch.benchmark
   <config> --output-file <file>` (by runpy, as `-m` runs it) over
   conf/benchmark-demo.json (8 entries) and every conf/*-benchmark.json
   (36 files, 36 entries), each entry at its own shape (10M x 100 for the
   linear fits, 100M rows for SQLTransformer, 1M x 100 for KMeans, ...),
   then the demo again and one demo entry under `--profile-dir`, on the
   card with no device request, under the sanitizer. It fails the run if
   an entry raises; if its result keys are not `runner.RESULT_KEYS` (the
   JAX runner's, which tests/test_torch_benchmark.py pins); if its
   inputRecordNum is not its generator's numValues, or its
   outputRecordNum not `bench_output_rows` (the relation the CPU test
   pins); if a column of a device-born generator at or above
   DEVICE_GEN_THRESHOLD rows lies off the card, or a prefers_host_input
   stage's input on it; if a config leaves more than BENCH_LEFT_BYTES
   allocated after it (its tables and model freed before the next); if an
   entry launches a kernel (no conf/ entry is sparse); if a device-born
   table of each of the demo's generators differs from its twin of the
   same seed; if scripts/bench_diff.py over the two demo runs exits 2 (its
   table is printed, not gated: host-bound entries spread between runs);
   if the profile run writes no trace file; if the sanitizer reports a
   problem, or if the child imported JAX. It prints each entry's
   totalTimeMs, phaseTimesMs, inputThroughput, peakHbmBytes, hostSyncCount
   and gapCount, each config's seconds, bytes left and allocator peak, and
   a `benchmark` line;
20. the repo's operator tools on the port (`tools_phase`, A.19): it logs
   whether this machine has JAX at all (`importlib.util.find_spec`), then
   runs each step as its own fresh `python` process under the sanitizer
   (`FLINK_ML_TPU_SANITIZE=1`; each must end with its clean verdict) and
   `-X importtime` (none may import jax, jaxlib or flink_ml_tpu):
   (a) a child (`traced_fit_child`) with `FLINK_ML_TPU_TRACE_FILE` and
   `FLINK_ML_TPU_TIMELINE_FILE` set fits phase 3's sparse LR (1M x 39, d
   1e6, maxIter 20, globalBatchSize 100,000) through the public
   LogisticRegression, transforms, saves, loads and transforms again;
   its launches must equal phase 3's for the same path, its coefficients
   lie within phase 4's sparse gate of the plain-loss fit and its
   transform within ROW_DOTS_TOL of the plain row dots. Then
   scripts/torch_obs_report.py over its trace, as text and as `--format
   json` (the fit and the transform of LogisticRegression among the
   stages, nothing dropped), and scripts/torch_obs_timeline.py `-o ...
   --attribution --json` over its events (the attribution's parts sum to
   its window within 1e-6 ms; the whole fit is one dispatch); (b)
   scripts/torch_smoke_fit_timeline.py (56 epochs chunked in 7 cycles,
   whole in 1, the typed budget rejection), and torch_obs_timeline.py
   over both of its dumps; (c) scripts/torch_coldstart_smoke.py
   populate, serve, baseline: serve exits 0 and its `outSha` equals
   baseline's; (d) scripts/torch_make_reference_fixture.py `--out` a
   directory of its own, byte for byte the committed
   tests/fixtures/reference_*, and scripts/torch_gen_operator_docs.py
   `--out` a file, byte for byte docs/torch_operators.md. It prints each
   process's seconds, the cold-start walls and a `tools` line;
21. a `kernels` JSON line (four kernels; the fleet kernels with phase 17's
   shapes in `by_shape`, every kernel's phase-17 to phase-20 launches by
   path), then the result line.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

DENSE_ROWS, DIM = 10_000_000, 100
SPARSE_ROWS, SPARSE_DIM, NNZ = 1_000_000, 1_000_000, 39
MAX_ITER, BATCH, LEARNING_RATE, TOL = 20, 100_000, 0.1, 1e-6
LINREG_LEARNING_RATE = 0.01  # conf/linearregression-benchmark.json
KMEANS_ROWS, KMEANS_K, KMEANS_ITER, KMEANS_SEED = 1_000_000, 10, 10, 2  # conf/kmeans-benchmark.json
PIPELINE_ROWS, ARITY, PIPELINE_SEED = 1_000_000, 10, 7  # conf/standardscaler-, onehotencoder-benchmark.json
# the stream and online paths: host chunks of this many rows (not a multiple
# of the batch, so the remainder carries from chunk to chunk)
STREAM_CHUNK, KMEANS_CHUNK = 65_536, 62_500
STREAM_SEED, ONLINE_SEED, HELD_OUT_SEED = 13, 17, 19
STREAM_CACHE_BUDGET = 8 << 30  # holds the stream LR's 100 packed segments, 4.08 GB
SPILL_BATCHES = 8  # the spill twin: 8 segments against the default 64 MiB budget
ONLINE_REG, ONLINE_ELASTIC_NET = 0.01, 0.5  # both FTRL's l1 and l2 terms act
ONLINE_KMEANS_DECAY = 0.5
# FTRL zeroes a coordinate when |z| <= l1: one whose float64 |z| lies within
# this share of l1 from l1 may go either way in float32, and is not gated
NEAR_L1_SHARE = 1e-3
# KMeans near ties (the KMeans path's rule): points whose two nearest float64
# distances differ by at most this share are not gated
TIE_MARGIN = 1e-4
DEVICE = "cuda"
#: seconds the sanitizer's verdict waits for each registered worker to end
SANITIZER_JOIN_S = 30.0
#: the port's tpulint: its rules, and the seconds phase 15 allows it
LINT_RULES = 20
LINT_TIMEOUT_S = 600
#: phase 18: the examples directory, the seconds its child may take, and
#: per example the one line its rewrite drops (an import the port's run
#: does not use and this machine cannot satisfy)
EXAMPLES_DIR = "examples"
EXAMPLES_TIMEOUT_S = 600
EXAMPLE_DROPPED_LINES = {"pipeline_serving_example.py": "import jax"}
#: the example whose fit must launch both solo kernels on the card
SPARSE_EXAMPLE = "sparse_wide_lr_example.py"
MULTI_TENANT_EXAMPLE = "multi_tenant_serving_example.py"
#: phase 19: the benchmark configs (the demo, then every
#: `*-benchmark.json`), the seconds the child may take, the entry that
#: also runs under `--profile-dir`, and a cap on `numValues` (None on the
#: card: every entry at its own shape; the CPU rehearsal sets one)
BENCH_CONF_DIR, BENCH_DEMO = "conf", "benchmark-demo.json"
BENCH_TIMEOUT_S = 900
BENCH_PROFILE_ENTRY = "Bucketizer-1"
BENCH_MAX_ROWS = None
#: a config's tables and model are freed before the next config: the
#: bytes it may leave allocated on the card (its captured fit's graph)
BENCH_LEFT_BYTES = 1 << 30
#: phase 20: the seconds each of its processes may take
TOOLS_TIMEOUT_S = 300
# H100 SXM peaks (NVIDIA data sheet, at a 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# above the H100's highest SM clock, so a spin of n cycles lasts at least n / this
SPIN_CYCLES_PER_S = 2e9
MIN_SPIN_S = 0.005
# kernel vs plain version: float32 sums in another order (row dots: a warp
# shuffle tree over <= 39 terms; gradient: atomics in run-dependent order)
ROW_DOTS_TOL = dict(rtol=1e-5, atol=5e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_REL_TOL = 1e-3
DEFAULT_MASK_SHARE, OUT_OF_RANGE_SHARE = 0.05, 0.001
#: the kernels whose launches the paths count (flink_ml_tpu_torch/ops/sparsekernels.py KERNELS)
KERNEL_NAMES = ("sparse_row_dots", "sparse_grad", "fleet_row_dots", "fleet_grad")
#: the SGD engine's epoch kernels (ops/sgdkernels.py): the pointwise
#: kernel's multiplier against its plain version's (exp and log1p compiled
#: apart round alike or one ulp apart)
SGD_MULT_ULPS = 1
#: its sums against torch.sum's: float32 sums of BATCH terms in two orders
SGD_SUM_REL_TOL = 1e-5
#: phase 16: gloo ranks sharing the card, and the bounds of a job and of
#: each collective (seconds)
MESH_RANKS = 4
MESH_JOB_TIMEOUT_S, MESH_COLLECTIVE_TIMEOUT_S = 300.0, 120.0
#: the sparse LR's third mesh fit: a threshold above its pairs' bytes over
#: the dense payload's (7.8 MB a rank against 4 MB), so they ride the pairs
MESH_PAIR_THRESHOLD = 4.0
#: a dense fit on the mesh against the one-rank fit, and overlap against
#: plain at four ranks (the JAX package's sharded-against-flat tolerance,
#: tests/test_linear_models.py:168; ROADMAP C.26)
MESH_DENSE_TOL = dict(rtol=2e-5, atol=2e-6)
#: KMeans on the mesh against the one-rank fit: centroids within this share
#: of their scale, phase 4's gate of the one-rank fit against the float64
#: Lloyd, and at most this share of the points counted in another cell. The
#: sums differ in their last bits (a partial of 250,000 rows a rank, then
#: four, against one matmul over 1M rows), and on uniform points a few
#: near-ties flip and move the centroids further each epoch (on an H100:
#: 3.5e-4 of a scale of ~0.5, 70 points in other cells)
MESH_KMEANS_SCALE_TOL, MESH_KMEANS_POINT_SHARE = 1e-3, 1e-3
#: phase 17 on the same ranks: the sparse LR's 2D fits, name -> (data
#: shards, model shards, config.sparse_2d)
MESH2D_FITS = {"2d 2x2": (2, 2, "auto"), "2d 1x4": (1, 4, "auto"), "off 2x2": (2, 2, "off")}
#: phase 17(b): the budget case's rows and batch (the first rows of the
#: sparse table), so a rank's data stays far below its d-long carries
MESH_BUDGET_ROWS, MESH_BUDGET_BATCH = 4_096, 1_024
#: phase 17(e): the checkpointed 2D fit's interval and the drained chunk
#: its kill fault fires at (a cut at epoch interval x chunk)
MESH_CKPT_INTERVAL, MESH_CKPT_KILL_CHUNK = 5, 2
#: phase 17(f): the supervised dense fit's hosts (2 ranks each) and the
#: dispatch boundary of the dying host's ranks that fires `host.die`
MESH_SUPERVISED_HOSTS, MESH_SUPERVISED_AFTER = 2, 3


def launch_dict(**counts):
    """Launch counts of every kernel: the ones given, 0 for the rest."""
    return {name: counts.get(name, 0) for name in KERNEL_NAMES}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, arg_sets, iters=30, warmup=3, ahead=True):
    """Mean time of `fn` over `iters` calls between CUDA events, cycling
    through `arg_sets` (several copies of the inputs keep them out of L2).
    With `ahead`, the stream first spins for twice as long as the host
    takes to enqueue the calls (and at least MIN_SPIN_S), so the events
    time the calls back to back on the card. Without it (reported as
    `enqueue_ms`), a call that the host enqueues more slowly than the card
    runs it is timed at the host's rate."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if ahead:
        torch.cuda._sleep(int(max(2 * iters * host_s, MIN_SPIN_S) * SPIN_CYCLES_PER_S))
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def copies_for(nbytes: int, l2_multiple_bytes: int = 150 << 20) -> int:
    return max(1, math.ceil(l2_multiple_bytes / max(nbytes, 1)))


def sparse_batch(gen, rows, nnz, d, dev, mask_share, oor_share):
    """Seeded padded-CSR rows: a share of -1 padding slots and a share of
    indices >= d, which the dot clamps and the gradient drops."""
    idx = torch.randint(0, d, (rows, nnz), generator=gen, device=dev, dtype=torch.int32)
    u = torch.rand((rows, nnz), generator=gen, device=dev)
    idx = torch.where(u < mask_share, -1, idx)
    idx = torch.where(u > 1.0 - oor_share, d + idx % 5, idx).contiguous()
    vals = torch.rand((rows, nnz), generator=gen, device=dev)
    return idx, vals


EDGE_SHAPES = [(64, 5, 24), (200, 39, 64), (1, 3, 4), (33, 40, 50), (7, 0, 10),
               (300, 64, 1000), (300, 65, 1000)]


def edge_phase(sk, dev):
    """The kernels at the edges of their layout (one row, nnz above a warp
    width, a tiny d, an empty row width, the widest row of one pass of the
    row dot and the narrowest of two) and on the index-convention probe:
    an index >= d is clamped in the dot and dropped in the gradient."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    for rows, nnz, d in EDGE_SHAPES:
        idx, vals = sparse_batch(gen, rows, nnz, d, dev, 0.2, 0.05)
        coeff = torch.randn(d, generator=gen, device=dev)
        mult = torch.randn(rows, generator=gen, device=dev)
        check(torch.allclose(sk.sparse_row_dots(idx, vals, coeff),
                             sk.sparse_row_dots_plain(idx, vals, coeff), **ROW_DOTS_TOL),
              f"sparse_row_dots disagrees at {(rows, nnz, d)}")
        check(torch.allclose(sk.sparse_grad(idx, vals, mult, coeff),
                             sk.sparse_grad_plain(idx, vals, mult, coeff), **GRAD_TOL),
              f"sparse_grad disagrees at {(rows, nnz, d)}")
    idx = torch.tensor([[0, 5, -1], [7, 1, 2]], dtype=torch.int32, device=dev)
    ones = torch.ones((2, 3), device=dev)
    coeff = torch.tensor([1.0, 10.0, 100.0, 1000.0], device=dev)
    check(sk.sparse_row_dots(idx, ones, coeff).tolist() == [1001.0, 1110.0],
          "sparse_row_dots breaks the clamp convention")
    check(sk.sparse_grad(idx, ones, torch.ones(2, device=dev), coeff).tolist() == [1.0, 1.0, 1.0, 0.0],
          "sparse_grad breaks the drop convention")
    log(f"  edge shapes {EDGE_SHAPES} and the index probe agree")


ZIPF_EXPONENT = 1.1
MISALIGNED_OFFSET = 3  # rows: 3 * 39 * 4 bytes = 468, not a multiple of 16
WIDE_SHAPE = (16, 5000, 4096)
TINY_D = 7  # the tiny-d case: every slot of the fit batch on one of 7 columns
# the table-overflow case: HOT_SHARE of the slots on HOT_COLUMNS columns,
# CROWD_SHARE on the columns whose hashed table entry is one of the first
# CROWDED_ENTRIES, the rest uniform
HOT_SHARE, HOT_COLUMNS = 0.35, 128
CROWD_SHARE, CROWDED_ENTRIES = 0.15, 8


def zipf_batch(gen, rows, nnz, d, dev):
    """Seeded skewed rows, as Criteo's categorical features are skewed:
    rank k is drawn with weight k^-1.1 and the ranks are scattered over the
    columns by a seeded permutation, as hashed features are; padding and
    indices >= d as in `sparse_batch`. Values (and the caller's
    multipliers) lie on a grid of quarters, so every partial sum of the
    gradient is exact in float32 and any order of its adds gives the same,
    exact result."""
    weights = torch.arange(1, d + 1, device=dev, dtype=torch.float64) ** -ZIPF_EXPONENT
    cdf = torch.cumsum(weights, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand((rows, nnz), generator=gen, device=dev, dtype=torch.float64)
    rank = torch.searchsorted(cdf, u).clamp(max=d - 1)
    idx = torch.randperm(d, generator=gen, device=dev)[rank].to(torch.int32)
    return mask_slots(gen, idx, d), quarter_grid(gen, (rows, nnz), dev)


def quarter_grid(gen, shape, dev, signed=False):
    """Values on a grid of quarters (0..1, or -1..1 with `signed`): every
    partial sum of their products is exact in float32 below 2^20."""
    low = -4 if signed else 0
    return torch.randint(low, 5, shape, generator=gen, device=dev).to(torch.float32) / 4


def mask_slots(gen, idx, d):
    """`sparse_batch`'s padding and indices >= d on given columns."""
    u = torch.rand(idx.shape, generator=gen, device=idx.device)
    idx = torch.where(u < DEFAULT_MASK_SHARE, -1, idx)
    return torch.where(u > 1.0 - OUT_OF_RANGE_SHARE, d + idx % 5, idx).to(torch.int32).contiguous()


def crowded_batch(gen, rows, nnz, d, table, dev):
    """sparse_grad's table overflowing both ways while its blocks stay on
    it. HOT_SHARE of the slots on HOT_COLUMNS random columns: after a
    chunk's first, their slots find their entry, a quarter of every chunk,
    above the 1/8 of repeats below which a block leaves the table.
    CROWD_SHARE on the ~d * CROWDED_ENTRIES / table columns whose hashed
    entry (the kernel's multiplicative hash into `table` entries) is one of
    the first CROWDED_ENTRIES: all but the few that claim an entry within
    reach find none and add with their own RED. The rest uniform over d:
    about half of a chunk's slots claim a new entry, so at the fit batch's
    plan (chunks of 1856 slots, flush at 2048 claims) a block flushes
    every two or three chunks and then adds into the reset table. Values
    on the quarter grid: the sums are exact. Returns (idx, vals, the
    number of crowded columns)."""
    cols = torch.arange(d, device=dev, dtype=torch.int64)
    home = ((cols * 2654435761) & 0xFFFFFFFF) >> (32 - (table.bit_length() - 1))
    crowd = cols[home < CROWDED_ENTRIES]
    hot = torch.randperm(d, generator=gen, device=dev)[:HOT_COLUMNS]
    shape = (rows, nnz)
    pick_hot = hot[torch.randint(0, HOT_COLUMNS, shape, generator=gen, device=dev)]
    pick_crowd = crowd[torch.randint(0, crowd.numel(), shape, generator=gen, device=dev)]
    spread = torch.randint(0, d, shape, generator=gen, device=dev)
    u = torch.rand(shape, generator=gen, device=dev)
    mixed = torch.where(u < HOT_SHARE, pick_hot,
                        torch.where(u < HOT_SHARE + CROWD_SHARE, pick_crowd, spread))
    return mask_slots(gen, mixed, d), quarter_grid(gen, shape, dev), int(crowd.numel())


def cuobjdump(cuda_build, name, flag):
    """`cuobjdump <flag>` of the built library of csrc/<name>.cu."""
    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    return subprocess.run([tool, flag, str(cuda_build._library_path(name))], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def resource_usage(cuda_build, name):
    """Registers, stack and spills (LOCAL) of each kernel of the library, as
    cuobjdump reads them from the binary, whether this run compiled it or
    found it built."""
    usage, kernel = {}, None
    for line in cuobjdump(cuda_build, name, "-res-usage").splitlines():
        match = re.match(r"\s*Function (\S+):", line)
        if match:
            kernel = match.group(1)
        elif kernel is not None and "REG:" in line:
            usage[kernel] = " ".join(f for f in line.split() if f.split(":")[0] in ("REG", "STACK", "LOCAL"))
            kernel = None
    check(bool(usage), f"cuobjdump found no kernel in {name}")
    return usage


SASS_KERNEL = re.compile(r"\d(sparse_grad|fleet_grad|fleet_grad_copy|fleet_row_dots|row_dots)_kernel")


def check_sass(cuda_build):
    """What the compiler made of the kernels (cuobjdump -sass): no ATOMG
    anywhere (it waits for the old value); sparse_grad adds to device
    memory with RED and adds in shared memory (ATOMS: its claims and its
    table's float adds, whose form is printed); fleet_grad adds to device
    memory only with bulk reductions (UBLKRED, cp.reduce.async.bulk), no
    float RED; fleet_row_dots
    loads with 128-bit global loads (its float4 member loads). Returns the
    ATOMS forms of sparse_grad."""
    sass = cuobjdump(cuda_build, "sparse_kernels", "-sass")
    opcode = re.compile(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)((?:\.[A-Za-z0-9_]+)*)")
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            match = SASS_KERNEL.search(mangled)
            kernel = f"{match.group(1)}_kernel {mangled}" if match else mangled
            counts[kernel] = {"RED": 0, "RED_F32": 0, "ATOMG": 0, "ATOMS": 0, "BLKRED": 0,
                              "LDG128": 0, "atoms_forms": set()}
            continue
        match = opcode.search(line)
        if kernel is None or not match:
            continue
        op, mods = match.groups()
        ops = counts[kernel]
        if op in ("RED", "REDG"):
            ops["RED"] += 1
            ops["RED_F32"] += ".F" in mods  # .F32, .F32x4: a float add
        elif op == "ATOMG":
            ops["ATOMG"] += 1
        elif op == "ATOMS":
            ops["ATOMS"] += 1
            ops["atoms_forms"].add(op + mods)
        elif "BLKRED" in op:
            ops["BLKRED"] += 1
        elif op == "LDG" and ".128" in mods:
            ops["LDG128"] += 1
    forms = set()
    for kernel, ops in counts.items():
        ops["atoms_forms"] = sorted(ops["atoms_forms"])
        log(f"  sass {kernel}: {ops}")
        name = kernel.split()[0]
        check(ops["ATOMG"] == 0, f"{kernel} adds to device memory with ATOMG: {ops}")
        if name == "sparse_grad_kernel":
            check(ops["RED"] > 0, f"{kernel} adds to device memory with {ops}, not RED")
            check(ops["ATOMS"] > 0, f"{kernel} has no shared atomics: {ops}")
            forms.update(ops["atoms_forms"])
        if name == "fleet_grad_kernel":
            check(ops["BLKRED"] > 0 and ops["RED_F32"] == 0,
                  f"{kernel} must add to device memory with bulk reductions only: {ops}")
        if name == "fleet_row_dots_kernel":
            check(ops["LDG128"] > 0, f"{kernel} has no 128-bit global loads: {ops}")
    names = {k.split()[0] for k in counts}
    check({"sparse_grad_kernel", "fleet_row_dots_kernel", "fleet_grad_kernel"} <= names,
          f"kernels missing from the SASS: {sorted(names)}")
    log(f"  sparse_grad's shared atomics: {sorted(forms)}")
    return sorted(forms)


#: fleet_grad's floor probes (csrc/probes.cu `fmt_probe_red8`, by form), at N = 8
RED8_PROBES = ("two RED.128 a slot", "one RED.128 a slot", "one 32-byte bulk reduction a slot")


def load_probes(cuda_build):
    """csrc/probes.cu: the floors of random L2 access that the kernels meet:
    (gather, red, gather8, red8), red8(form, idx, table) adding member rows
    of a (d, 8) table in RED8_PROBES[form]'s way."""
    import ctypes

    lib = cuda_build.load("probes")
    for fn in (lib.fmt_probe_gather, lib.fmt_probe_gather8):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.fmt_probe_red.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    lib.fmt_probe_red8.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_int,
                                                                                      ctypes.c_void_p]
    lib.fmt_probe_red.restype = lib.fmt_probe_red8.restype = ctypes.c_int

    def gather_with(fn, what):
        def gather(idx, coeff):
            n = idx.numel()
            out = torch.empty(-(-n // 1024) * 32, device=idx.device)
            err = fn(idx.data_ptr(), coeff.data_ptr(), out.data_ptr(), n, coeff.shape[0],
                     torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"{what} probe launch failed with CUDA error {err}")
            return out
        return gather

    def red(idx, coeff):
        counts = torch.zeros_like(coeff)
        err = lib.fmt_probe_red(idx.data_ptr(), counts.data_ptr(), idx.numel(), coeff.shape[0],
                                torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"RED probe launch failed with CUDA error {err}")
        return counts

    def red8(form, idx, table):
        table.zero_()
        err = lib.fmt_probe_red8(idx.data_ptr(), table.data_ptr(), idx.numel(), table.shape[0], form,
                                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"{RED8_PROBES[form]} probe launch failed with CUDA error {err}")
        return table

    return (gather_with(lib.fmt_probe_gather, "gather"), red, gather_with(lib.fmt_probe_gather8, "gather8"),
            red8)


def load_designs(cuda_build, sk):
    """csrc/designs.cu: the designs that this port's kernels replaced, on
    the plans they ran with: (red_grad, scalar_fleet_row_dots,
    red_fleet_grad), called as sparse_grad, fleet_row_dots and fleet_grad
    are."""
    import ctypes

    lib = cuda_build.load("designs")
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.fmt_red_grad.argtypes = [vp] * 4 + [ll, i32, ll, i32, i32, vp]
    lib.fmt_scalar_fleet_row_dots.argtypes = [vp] * 4 + [ll, i32, ll, i32, ll, ll, i32, i32, vp]
    lib.fmt_red_fleet_grad.argtypes = [vp] * 4 + [ll, i32, ll, i32, ll, ll, i32, i32, vp]
    for fn in (lib.fmt_red_grad, lib.fmt_scalar_fleet_row_dots, lib.fmt_red_fleet_grad):
        fn.restype = i32

    def red_grad(idx, vals, mult, coeff):
        grad = torch.zeros_like(coeff)
        plan = sk._launch_plan(*idx.shape, True)
        err = lib.fmt_red_grad(idx.data_ptr(), vals.data_ptr(), mult.data_ptr(), grad.data_ptr(),
                               *idx.shape, coeff.shape[0], *plan, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"fmt_red_grad launch failed with CUDA error {err}")
        return grad

    def scalar_fleet_row_dots(idx, vals, coeff):
        out = torch.empty((coeff.shape[0], idx.shape[0]), device=idx.device)
        plan = sk._launch_plan(*idx.shape)
        err = lib.fmt_scalar_fleet_row_dots(
            idx.data_ptr(), vals.data_ptr(), coeff.data_ptr(), out.data_ptr(), *idx.shape,
            coeff.shape[1], coeff.shape[0], *sk._fleet_strides(coeff), *plan,
            torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"fmt_scalar_fleet_row_dots launch failed with CUDA error {err}")
        return out

    def zeroed_like(coeff):
        members, d = coeff.shape
        if coeff.is_contiguous():
            return torch.zeros((members, d), device=coeff.device)
        return torch.zeros((d, members), device=coeff.device).T

    def red_fleet_grad(idx, vals, mult, coeff):
        grad = zeroed_like(coeff)
        plan = sk._launch_plan(*idx.shape, True)
        err = lib.fmt_red_fleet_grad(
            idx.data_ptr(), vals.data_ptr(), mult.data_ptr(), grad.data_ptr(), *idx.shape,
            coeff.shape[1], coeff.shape[0], *sk._fleet_strides(grad), *plan,
            torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"fmt_red_fleet_grad launch failed with CUDA error {err}")
        return grad

    return red_grad, scalar_fleet_row_dots, red_fleet_grad


def check_probes(gather, red, idx, coeff):
    """The probes compute something checkable: a sum of the gathered
    coefficients per lane, and a count per column (gather8: see
    `check_gather8`)."""
    d = coeff.shape[0]
    flat = idx.reshape(-1)
    pad = torch.full((-flat.numel() % 1024,), -1, dtype=flat.dtype, device=flat.device)
    lanes = torch.cat([flat, pad]).reshape(-1, 8, 32, 4)
    want = torch.where(lanes >= 0, coeff[lanes.clamp(0, d - 1).long()], 0.0).sum(dim=(1, 3))
    check(torch.allclose(gather(idx, coeff), want.reshape(-1), **ROW_DOTS_TOL),
          "the gather probe's sums disagree")
    keep = flat[(flat >= 0) & (flat < d)].long()
    check(torch.equal(red(idx, coeff), torch.bincount(keep, minlength=d).to(torch.float32)),
          "the RED probe's counts disagree")


def check_gather8(gather8, idx, table):
    """The gather8 probe sums the 8 values of each gathered row of a (d, 8)
    table per lane."""
    d = table.shape[0]
    flat = idx.reshape(-1)
    pad = torch.full((-flat.numel() % 1024,), -1, dtype=flat.dtype, device=flat.device)
    lanes = torch.cat([flat, pad]).reshape(-1, 8, 32, 4)
    rows = table.sum(dim=1)[lanes.clamp(0, d - 1).long()]
    want = torch.where(lanes >= 0, rows, 0.0).sum(dim=(1, 3))
    check(torch.allclose(gather8(idx, table), want.reshape(-1), **ROW_DOTS_TOL),
          "the gather8 probe's sums disagree")


def summation_bound(idx, vals, mult, d):
    """Per column c, 2 * n_c * 2^-24 * sum |vals * mult| over its n_c slots:
    twice the worst-case error of a float32 sum of the same n_c products
    in any order, so the largest gap two orders may show."""
    keep = (idx >= 0) & (idx < d)
    flat = torch.where(keep, idx, 0).long().reshape(-1)
    mag = torch.where(keep, (vals * mult[:, None]).abs(), 0.0).double().reshape(-1)
    total = torch.zeros(d, dtype=torch.float64, device=idx.device).index_add_(0, flat, mag)
    count = torch.bincount(flat[keep.reshape(-1)], minlength=d).double()
    return 2.0 * count * 2.0**-24 * total


def measure_case(sk, probes, designs, label, idx, vals, coeff, mult, sets, exact_grad=False,
                 grad_bound=False):
    """Both kernels on one batch: held against their plain versions, and
    timed with the plain versions, one library call each, the gradient's
    replaced design (`fmt_red_grad`, held to the same gate) and, where the
    batch is aligned, the probes. `sets` are copies of (idx, vals) that
    rotate through the timed calls. With `grad_bound`, the gradient is held
    to `summation_bound` instead of GRAD_TOL: on columns that sum thousands
    of float values, cancellation leaves GRAD_TOL's rtol no scale."""
    rows, nnz = idx.shape
    d = coeff.shape[0]
    valid = idx >= 0
    safe = torch.where(valid, idx, 0).clamp(max=d - 1)
    masked_vals = torch.where(valid, vals, 0.0)
    keep = valid & (idx < d)
    batch_bytes = idx.numel() * 4 + vals.numel() * 4
    probe_ms = {}
    if idx.data_ptr() % 16 == 0 and idx.numel() % 4 == 0 and probes is not None:
        gather, red = probes[:2]
        check_probes(gather, red, idx, coeff)
        probe_ms["sparse_row_dots"] = cuda_ms(lambda i, v: gather(i, coeff), sets)
        probe_ms["sparse_grad"] = cuda_ms(lambda i, v: red(i, coeff), sets)
    results = {}

    got = sk.sparse_row_dots(idx, vals, coeff)
    want = sk.sparse_row_dots_plain(idx, vals, coeff)
    err = (got - want).abs()
    check(torch.allclose(got, want, **ROW_DOTS_TOL),
          f"sparse_row_dots disagrees with its plain version on {label}: max abs {float(err.max())}")
    lib_out = torch.nn.functional.embedding_bag(
        safe, coeff[:, None], per_sample_weights=masked_vals, mode="sum")[:, 0]
    check(torch.allclose(lib_out, want, **ROW_DOTS_TOL), "embedding_bag yardstick disagrees")
    touched = int(torch.unique(safe[valid]).numel())
    b_ms, b_by = bound_ms(batch_bytes + touched * 4 + rows * 4, 2.0 * int(valid.sum()))
    results["sparse_row_dots"] = {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / want.abs().clamp_min(1e-6)).max()),
        "ms": cuda_ms(lambda i, v: sk.sparse_row_dots(i, v, coeff), sets),
        "enqueue_ms": cuda_ms(lambda i, v: sk.sparse_row_dots(i, v, coeff), sets, ahead=False),
        "plain_ms": cuda_ms(lambda i, v: sk.sparse_row_dots_plain(i, v, coeff), sets, iters=10),
        "library_ms": cuda_ms(
            lambda s, w: torch.nn.functional.embedding_bag(
                s, coeff[:, None], per_sample_weights=w, mode="sum"),
            [(safe, masked_vals)], iters=10),
        "bound_ms": b_ms, "bound_by": b_by,
    }

    red_grad = designs[0]
    want = sk.sparse_grad_plain(idx, vals, mult, coeff)
    bound = summation_bound(idx, vals, mult, d) if grad_bound else None
    errs = {}
    for name, fn in (("sparse_grad", sk.sparse_grad), ("fmt_red_grad", red_grad)):
        got = fn(idx, vals, mult, coeff)
        err = errs[name] = (got - want).abs()
        if grad_bound:
            check(bool((err.double() <= bound).all()),
                  f"{name} exceeds the summation bound on {label}: max abs {float(err.max())}, "
                  f"largest share of the bound {float((err.double() / bound.clamp_min(1e-300)).max())}")
        else:
            check(torch.allclose(got, want, **GRAD_TOL),
                  f"{name} disagrees with its plain version on {label}: max abs {float(err.max())}")
        if exact_grad:
            check(torch.equal(got, want), f"{name} is not exact on {label}'s exact sums")
    got, walk = sk.sparse_grad_walk(idx, vals, mult, coeff)
    if grad_bound:
        check(bool(((got - want).abs().double() <= bound).all()),
              f"sparse_grad_walk exceeds the summation bound on {label}")
    else:
        check(torch.allclose(got, want, **GRAD_TOL),
              f"sparse_grad_walk disagrees with its plain version on {label}")
    if exact_grad:
        check(torch.equal(got, want), f"sparse_grad_walk is not exact on {label}'s exact sums")
    err = errs["sparse_grad"]
    flat_idx = torch.where(keep, idx, 0).long().reshape(-1)
    contrib = torch.where(keep, vals * mult[:, None], 0.0).reshape(-1)
    b_ms, b_by = bound_ms(batch_bytes + rows * 4 + d * 4, 2.0 * int(keep.sum()))
    msets = [(i, v, mult) for i, v in sets]
    results["sparse_grad"] = {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / want.abs().clamp_min(1e-6)).max()),
        "ms": cuda_ms(lambda i, v, m: sk.sparse_grad(i, v, m, coeff), msets),
        "replaced_ms": cuda_ms(lambda i, v, m: red_grad(i, v, m, coeff), msets),
        "enqueue_ms": cuda_ms(lambda i, v, m: sk.sparse_grad(i, v, m, coeff), msets, ahead=False),
        "plain_ms": cuda_ms(lambda i, v, m: sk.sparse_grad_plain(i, v, m, coeff), msets, iters=10),
        "library_ms": cuda_ms(lambda fi, c: torch.zeros_like(coeff).index_add_(0, fi, c),
                              [(flat_idx, contrib)], iters=10),
        "bound_ms": b_ms, "bound_by": b_by, "walk": walk,
    }
    results["sparse_row_dots"]["tolerance"] = ROW_DOTS_TOL
    results["sparse_grad"]["tolerance"] = (
        "per column 2 n_c 2^-24 sum |v m| (summation_bound)" if grad_bound else GRAD_TOL)
    for name, r in results.items():
        r.update(case=label, rows=rows, nnz=nnz, d=d, probe_ms=probe_ms.get(name))
        probe = f", probe {r['probe_ms']:.4f} ms" if r["probe_ms"] is not None else ""
        replaced = f", replaced design {r['replaced_ms']:.4f} ms" if "replaced_ms" in r else ""
        log(f"  {name} {label} ({rows} x {nnz}, d={d}): max_abs_err "
            f"{r['max_abs_err']:.3g}; kernel {r['ms']:.4f} ms (enqueue-bound {r['enqueue_ms']:.4f})"
            f"{replaced}, "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}){probe}"
            + (f"; walk {r['walk']}" if "walk" in r else ""))
    return results


def copies(idx, vals, offset=0):
    """(idx, vals) and enough copies of it to exceed L2 several times; with
    `offset`, each copy is the same row slice of a fresh copy of the larger
    tensor, so its base keeps its alignment."""
    n = copies_for(idx.numel() * 8)
    return [(idx[offset:], vals[offset:])] + [
        (idx.clone()[offset:], vals.clone()[offset:]) for _ in range(n - 1)]


def kernel_phase(sk, probes, designs, dev):
    """Each kernel against its plain version at the main path's shapes
    (the fit batch and the 1M-row transform), on skewed indices, on a
    misaligned row slice, on a wide row, on a batch that overflows the
    gradient's table, on a tiny d and at the text path's fit batch; the
    floor probes and the gradient's replaced design beside them."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    coeff = torch.randn(SPARSE_DIM, generator=gen, device=dev)
    results = {"sparse_row_dots": [], "sparse_grad": []}

    def run(label, idx, vals, c, mult, sets, exact_grad=False, grad_bound=False):
        res = measure_case(sk, probes, designs, label, idx, vals, c, mult, sets, exact_grad,
                           grad_bound)
        for name in results:
            results[name].append(res[name])
        return res

    # the fit batch, the 1M-row transform and one rank's share of the fit
    # batch on phase 16's mesh (the batch each rank's kernels get there)
    for label, rows in (("fit batch", BATCH), ("transform", SPARSE_ROWS),
                        (f"rank batch (1 of {MESH_RANKS})", BATCH // MESH_RANKS)):
        idx, vals = sparse_batch(gen, rows, NNZ, SPARSE_DIM, dev, DEFAULT_MASK_SHARE, OUT_OF_RANGE_SHARE)
        mult = torch.randn(rows, generator=gen, device=dev)
        run(label, idx, vals, coeff, mult, copies(idx, vals))
        del idx, vals

    # the 2D fit's local scatter on phase 17's 2 x 2 mesh: a data row's batch
    # (BATCH / 2 rows) with model slice 0's indices made local and every
    # other slot -1 (about half), into the d / 2 slice
    d_local = -(-SPARSE_DIM // 2)
    idx, vals = sparse_batch(gen, BATCH // 2, NNZ, SPARSE_DIM, dev, DEFAULT_MASK_SHARE, 0.0)
    local = torch.where((idx >= 0) & (idx < d_local), idx, -1).to(torch.int32)
    mult = torch.randn(BATCH // 2, generator=gen, device=dev)
    run("2D local scatter (2 x 2)", local, vals, coeff[:d_local].contiguous(), mult,
        copies(local, vals))
    del idx, vals, local

    idx, vals = zipf_batch(gen, BATCH, NNZ, SPARSE_DIM, dev)
    mult = quarter_grid(gen, (BATCH,), dev, signed=True)
    run("zipf", idx, vals, coeff, mult, copies(idx, vals), exact_grad=True)
    # The same skewed columns with random float values, not a gate: how far
    # float32 sums in any order stray from the float64 sum on hot columns.
    rvals = torch.rand(idx.shape, generator=gen, device=dev)
    rmult = torch.randn(BATCH, generator=gen, device=dev)
    exact = sk.sparse_grad_plain(idx, rvals.double(), rmult.double(), coeff.double())
    log(f"  zipf with float values (not a gate): max abs error against float64 "
        f"{float((sk.sparse_grad(idx, rvals, rmult, coeff).double() - exact).abs().max()):.3g} "
        f"(kernel), {float((sk.sparse_grad_plain(idx, rvals, rmult, coeff).double() - exact).abs().max()):.3g} "
        f"(plain); largest |g| {float(exact.abs().max()):.4g}")
    del idx, vals, rvals

    big_idx, big_vals = sparse_batch(gen, BATCH + MISALIGNED_OFFSET, NNZ, SPARSE_DIM, dev,
                                     DEFAULT_MASK_SHARE, OUT_OF_RANGE_SHARE)
    idx, vals = big_idx[MISALIGNED_OFFSET:], big_vals[MISALIGNED_OFFSET:]
    check(idx.data_ptr() % 16 != 0, "the misaligned slice is aligned")
    mult = torch.randn(BATCH, generator=gen, device=dev)
    run("misaligned slice", idx, vals, coeff, mult,
        copies(big_idx, big_vals, MISALIGNED_OFFSET))
    del big_idx, big_vals, idx, vals

    rows, nnz, d = WIDE_SHAPE
    idx, vals = sparse_batch(gen, rows, nnz, d, dev, 0.2, 0.05)
    wide_coeff = torch.randn(d, generator=gen, device=dev)
    mult = torch.randn(rows, generator=gen, device=dev)
    run("wide row", idx, vals, wide_coeff, mult, copies(idx, vals))
    del idx, vals

    plan = sk._grad_plan(BATCH, NNZ, sk._sm_count(dev.index or 0))
    idx, vals, crowd = crowded_batch(gen, BATCH, NNZ, SPARSE_DIM, plan.table, dev)
    log(f"  table overflow: {HOT_SHARE} of the slots on {HOT_COLUMNS} hot columns, "
        f"{CROWD_SHARE} on the {crowd} columns hashed to {CROWDED_ENTRIES} of {plan.table} "
        f"entries, the rest uniform; {plan.grid} blocks")
    mult = quarter_grid(gen, (BATCH,), dev, signed=True)
    walk = run("table overflow", idx, vals, coeff, mult, copies(idx, vals),
               exact_grad=True)["sparse_grad"]["walk"]
    check(walk["mid_walk_flushes"] > 0 and walk["overflows"] > 0 and walk["direct_chunks"] == 0,
          f"the table-overflow case does not run the table's flush and overflow paths: {walk}")
    del idx, vals

    idx = mask_slots(gen, torch.randint(0, TINY_D, (BATCH, NNZ), generator=gen, device=dev), TINY_D)
    vals = quarter_grid(gen, (BATCH, NNZ), dev)
    mult = quarter_grid(gen, (BATCH,), dev, signed=True)
    run("tiny d", idx, vals, coeff[:TINY_D].contiguous(), mult, copies(idx, vals), exact_grad=True)
    del idx, vals

    # the text path's fit batch: its own features (HashingTF -> IDF of the
    # corpus' first BATCH rows, d = 2^18, so the coefficients fit in L2).
    # Its ~90 slots a row fall on ~900 hashed columns, ~10,000 float terms
    # a column: the gradient is held to the summation bound
    idx, vals, d = text_fit_batch(dev)
    text_coeff = torch.randn(d, generator=gen, device=dev)
    mult = torch.randn(idx.shape[0], generator=gen, device=dev)
    run("text fit batch", idx, vals, text_coeff, mult, copies(idx, vals), grad_bound=True)
    exact = sk.sparse_grad_plain(idx, vals.double(), mult.double(), text_coeff.double())
    log(f"  text fit batch (not a gate): gradient max abs error against float64 "
        f"{float((sk.sparse_grad(idx, vals, mult, text_coeff).double() - exact).abs().max()):.3g} "
        f"(kernel), {float((sk.sparse_grad_plain(idx, vals, mult, text_coeff).double() - exact).abs().max()):.3g} "
        f"(plain); largest |g| {float(exact.abs().max()):.4g}")
    return results


def ulp_gap(a, b) -> int:
    """The most float32 ulps between two tensors' elements."""
    def key(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((key(a) - key(b)).abs().max()) if a.numel() else 0


def sgd_epoch_phase(dev):
    """The SGD engine's two epoch kernels (csrc/sgd_epoch.cu) against their
    plain versions at the fits' shapes, in float32: the update over d =
    SPARSE_DIM and d = DIM bit for bit, live, dead, at wsum 0 and without
    the mask; the pointwise pass of each form over the BATCH rows, with
    random weights and with the `row < n` weights of a ragged batch, its
    multiplier within SGD_MULT_ULPS ulp, its sums within SGD_SUM_REL_TOL of
    torch.sum's and its tail as the body forms it from the kernel's sums.
    Each is timed warm (the fit finds its operands in L2) beside the
    least time its bytes allow and its plain version. Returns the times."""
    from flink_ml_tpu_torch.ops import losses, optimizer
    from flink_ml_tpu_torch.ops import sgdkernels as sg

    gen = torch.Generator(device=dev)
    gen.manual_seed(27)
    hyper = optimizer.sgd_hyper(LEARNING_RATE, 1e-3, 0.5, TOL, dev)
    live, dead = torch.full((), 0.5, device=dev), torch.zeros((), device=dev)
    wsum = torch.full((), float(BATCH), device=dev)
    results = {}
    for d in (SPARSE_DIM, DIM):
        coeff = torch.randn(d, generator=gen, device=dev)
        grad = torch.randn(d, generator=gen, device=dev)
        for label, ws, crit in (("live", wsum, live), ("dead", wsum, dead),
                                ("wsum 0", torch.zeros((), device=dev), live),
                                ("no mask", wsum, None)):
            check(torch.equal(sg.sgd_update(coeff, grad, ws, hyper, crit),
                              sg.sgd_update_plain(coeff, grad, ws, hyper, crit)),
                  f"sgd_update at d = {d} ({label}) is not the op sequence bit for bit")
        args = [(coeff, grad, wsum, hyper, live)]
        kernel, plain = cuda_ms(sg.sgd_update, args), cuda_ms(sg.sgd_update_plain, args)
        bound, by = bound_ms(12 * d, 7 * d)
        results[f"sgd_update d={d}"] = {"kernel_ms": kernel, "plain_ms": plain,
                                        "bound_ms": bound}
        log(f"  sgd_update d = {d}: {kernel:.4f} ms (plain {plain:.4f}; bound {bound:.4f} by "
            f"{by}, {100 * bound / kernel:.1f}%)")
    tail = sg.EpochTail(hyper, wsum, torch.full((), 3, dtype=torch.int32, device=dev), live)
    dot = 3 * torch.randn(BATCH, generator=gen, device=dev)
    ragged = (torch.arange(BATCH, device=dev) < BATCH // 3).to(torch.float32)
    for form, fn in zip(sg.FORMS, (losses._logistic_pointwise, losses._hinge_pointwise,
                                   losses._least_square_pointwise)):
        y = (torch.randn(BATCH, generator=gen, device=dev) if form == "least_square" else
             torch.randint(0, 2, (BATCH,), generator=gen, device=dev).to(torch.float32))
        for label, wk in (("weights", torch.rand(BATCH, generator=gen, device=dev)),
                          ("ragged", ragged)):
            got = sg.sgd_pointwise(form, fn, dot, y, wk, tail)
            loss, mult = fn(dot, y, wk)
            gap = ulp_gap(got.mult, mult)
            check(gap <= SGD_MULT_ULPS, f"sgd_pointwise {form} ({label}): multiplier {gap} ulp off")
            for name, a, b in (("loss", got.lsum, torch.sum(loss)),
                               ("weight", got.wsum, torch.sum(wk))):
                rel = abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
                check(rel <= SGD_SUM_REL_TOL, f"sgd_pointwise {form} ({label}): {name} sum {rel:.3g} off")
            crit = (got.lsum / torch.clamp(got.wsum, min=1e-30)).float()
            check(bool(got.tail.live) and int(got.tail.epoch) == 4
                  and torch.equal(got.tail.criteria, crit) and torch.equal(got.tail.wsum, got.wsum),
                  f"sgd_pointwise {form} ({label}): the tail is not the body's")
            args = [(form, fn, dot, y, wk, tail)]
            kernel = cuda_ms(sg.sgd_pointwise, args)
            plain = cuda_ms(lambda f, *a: sg.sgd_pointwise_plain(*a), args)
            bound, by = bound_ms(16 * BATCH, 12 * BATCH)
            results[f"sgd_pointwise {form} {label}"] = {"kernel_ms": kernel, "plain_ms": plain,
                                                        "bound_ms": bound}
            log(f"  sgd_pointwise {form} ({label}) {BATCH} rows: {kernel:.4f} ms (plain "
                f"{plain:.4f}; bound {bound:.4f} by {by}, {100 * bound / kernel:.1f}%); "
                f"multiplier {gap} ulp off")
    return results


def _logistic64(dot, y, w):
    margin = dot * (2.0 * y - 1.0)
    return w * np.logaddexp(0.0, -margin), w * (-(2.0 * y - 1.0) / (np.exp(margin) + 1.0))


def _hinge64(dot, y, w):
    margin = 1.0 - (2.0 * y - 1.0) * dot
    return w * np.maximum(margin, 0.0), np.where(margin > 0.0, -(2.0 * y - 1.0) * w, 0.0)


def _least_square64(dot, y, w):
    diff = dot - y
    return w * 0.5 * diff * diff, w * diff


#: loss name -> its pointwise (dot, y, w) -> (per-row loss, multiplier), float64
POINTWISE64 = {"binary_logistic": _logistic64, "hinge": _hinge64, "least_square": _least_square64}


def numpy_reference_sgd(batch_rows, num_batches, max_iter, lr, tol, pointwise=_logistic64,
                        reg=0.0, elastic_net=0.0):
    """The reference's SGD semantics (SGD.java:82-292,
    TerminateOnMaxIterOrTol.java, RegularizationUtils.java) in float64
    numpy, on weighted batches `batch_rows(k) -> (X, y, w)` and a pointwise
    loss: batch k = epoch mod num_batches, the first epoch computes a
    gradient before any update, each update followed by the proximal step
    where reg > 0, one extra update after the loop. Returns (coeff, loss,
    epochs)."""
    def update(coeff, grad):
        coeff = coeff - (lr / wsum) * grad
        if reg > 0:
            coeff = coeff - lr * (elastic_net * reg * np.sign(coeff)
                                  + (1.0 - elastic_net) * reg * coeff)
        return coeff

    coeff = grad = None
    wsum, loss, epoch = 0.0, np.inf, 0
    while epoch < max_iter and loss > tol:
        Xk, yk, wk = batch_rows(epoch % num_batches)
        if coeff is None:
            coeff = np.zeros(Xk.shape[1])
            grad = np.zeros(Xk.shape[1])
        if wsum > 0:
            coeff = update(coeff, grad)
        row_loss, mult = pointwise(Xk @ coeff, yk, wk)
        grad = Xk.T @ mult
        wsum = float(np.sum(wk))
        loss = float(np.sum(row_loss)) / max(wsum, 1e-30)
        epoch += 1
    if wsum > 0:
        coeff = update(coeff, grad)
    return coeff, loss, epoch


def sigmoid64(z):
    return 1.0 - 1.0 / (1.0 + np.exp(z))


def estimator(cls, weight_col=None, learning_rate=LEARNING_RATE):
    est = (
        cls()
        .set_max_iter(MAX_ITER)
        .set_learning_rate(learning_rate)
        .set_global_batch_size(BATCH)
        .set_tol(TOL)
    )
    return est.set_weight_col(weight_col) if weight_col else est


def synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def drive(fit, table, tmp, name):
    """One path as a user runs it: fit -> transform -> save -> load ->
    transform. Returns what phase 4 checks and the first calls' times."""
    model, fit_ms = synced(fit)
    out, transform_ms = synced(lambda: model.transform(table)[0])
    from flink_ml_tpu_torch.api import Stage

    path = os.path.join(tmp, name)
    model.save(path)
    with open(os.path.join(path, "metadata")) as f:
        class_name = json.load(f)["className"]
    loaded = Stage.load(path)
    again = loaded.transform(table)[0]
    torch.cuda.synchronize()
    return {"model": model, "out": out, "fit_ms": fit_ms, "transform_ms": transform_ms,
            "class_name": class_name, "loaded": loaded, "again": again}


def same_column(a, b) -> bool:
    """Bit for bit: tensors, host arrays, object columns of token lists,
    SparseBatches (indices, values, size) and DictTokenMatrix columns
    (vocabulary and ids)."""
    from flink_ml_tpu_torch.table import DictTokenMatrix, SparseBatch

    if isinstance(a, SparseBatch):
        return (isinstance(b, SparseBatch) and a.size == b.size
                and same_column(a.indices, b.indices) and same_column(a.values, b.values))
    if isinstance(a, DictTokenMatrix):
        return (isinstance(b, DictTokenMatrix) and np.array_equal(a.vocab, b.vocab)
                and same_column(a.ids, b.ids))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, np.ndarray) and a.dtype == object:
        if len(a) and isinstance(a[0], list) and a[0] and isinstance(a[0][0], np.ndarray):
            # per-row lists of equal-length arrays (MinHashLSH's hashes)
            return len(a) == len(b) and np.array_equal(np.array(a.tolist()), np.array(b.tolist()))
        return len(a) == len(b) and all(list(x) == list(y) for x, y in zip(a, b))
    return np.array_equal(a, b)


def check_reload(name, run, java_class, columns):
    check(run["class_name"] == java_class, f"{name} model saved as {run['class_name']}")
    check(type(run["loaded"]) is type(run["model"]), f"{name} model reload type")
    for col in columns:
        check(same_column(run["again"].column(col), run["out"].column(col)),
              f"{name} {col} differs after save/load")


#: the linear paths: name -> (estimator module, class, loss, learning rate,
#: the Java class name the model is saved as), at the conf/ configurations
LINEAR_PATHS = {
    "lr": ("classification.logisticregression", "LogisticRegression", "binary_logistic",
           LEARNING_RATE, "org.apache.flink.ml.classification.logisticregression.LogisticRegressionModel"),
    "svc": ("classification.linearsvc", "LinearSVC", "hinge", LEARNING_RATE,
            "org.apache.flink.ml.classification.linearsvc.LinearSVCModel"),
    "linreg": ("regression.linearregression", "LinearRegression", "least_square",
               LINREG_LEARNING_RATE,
               "org.apache.flink.ml.regression.linearregression.LinearRegressionModel"),
}


def linear_class(name):
    import importlib

    module, cls, *_ = LINEAR_PATHS[name]
    return getattr(importlib.import_module("flink_ml_tpu_torch.models." + module), cls)


def raw_dots(name, out):
    """The raw dot a linear model's transform gives: LR's probability is
    sigmoid(dot), LinearSVC's rawPrediction[:, 0] is dot, LinearRegression's
    prediction is dot."""
    if name == "lr":
        return out.column("rawPrediction")[:, 1]
    if name == "svc":
        return out.column("rawPrediction")[:, 0]
    return out.column("prediction")


def check_dense_linear(name, run, dense_table, X64, y64, w64):
    """A dense fit against a float64 numpy replay of the same epochs on the
    same rows, a refit bit for bit, and the transform against float64."""
    from flink_ml_tpu_torch.models import _linear
    from flink_ml_tpu_torch.ops import losses

    _, cls, loss_name, lr, _ = LINEAR_PATHS[name]
    num_batches = DENSE_ROWS // BATCH
    ref_coeff, ref_loss, ref_epochs = numpy_reference_sgd(
        lambda k: (X64[k * BATCH:(k + 1) * BATCH], y64[k * BATCH:(k + 1) * BATCH],
                   w64[k * BATCH:(k + 1) * BATCH]),
        num_batches, MAX_ITER, lr, TOL, POINTWISE64[loss_name],
    )
    dense_loss = {"binary_logistic": losses.BINARY_LOGISTIC_LOSS, "hinge": losses.HINGE_LOSS,
                  "least_square": losses.LEAST_SQUARE_LOSS}[loss_name]
    coeff, loss, epochs = _linear.run_sgd(
        estimator(linear_class(name), "weight", lr), dense_table, dense_loss, "weight",
        validate_binomial=name != "linreg",
    )
    model = run["model"]
    rel = abs(loss - ref_loss) / max(abs(ref_loss), 1e-30)
    coeff_rel = float(np.max(np.abs(model.coefficient - ref_coeff)) / np.max(np.abs(ref_coeff)))
    log(f"  dense {name} loss {loss:.8f} vs float64 replay {ref_loss:.8f}: relDiff {rel:.3g}; "
        f"epochs {epochs} vs {ref_epochs}; coeff max rel {coeff_rel:.3g}")
    check(rel < LOSS_REL_TOL, f"dense {name} loss relDiff {rel} >= {LOSS_REL_TOL}")
    check(epochs == ref_epochs, f"dense {name} epoch count differs from the replay")
    check(coeff_rel < 1e-3, f"dense {name} coefficients differ from the replay by {coeff_rel}")
    check(np.array_equal(coeff, model.coefficient), f"dense {name} refit is not bit-identical")

    out = run["out"]
    pred = out.column("prediction")
    check(pred.shape == (DENSE_ROWS,) and bool(torch.isfinite(pred).all()), f"dense {name} transform")
    if name != "linreg":
        check(out.column("rawPrediction").shape == (DENSE_ROWS, 2), f"dense {name} raw shape")
    dot64 = X64[:BATCH] @ model.coefficient.astype(np.float64)
    got = raw_dots(name, out)[:BATCH].double().cpu().numpy()
    want = sigmoid64(dot64) if name == "lr" else dot64
    err = float(np.max(np.abs(got - want)))
    bound = 1e-5 * max(1.0, float(np.max(np.abs(want))))
    clear = np.abs(dot64) > 1e-4
    pred_ok = name == "linreg" or np.array_equal(
        pred[:BATCH].cpu().numpy()[clear], (dot64 >= 0)[clear].astype(np.float32))
    log(f"  dense {name} transform vs float64: max abs err {err:.3g} (bound {bound:.3g}), "
        f"predictions agree {pred_ok}")
    check(err < bound and pred_ok, f"dense {name} transform disagrees with the float64 reference")


def check_sparse_linear(name, run, s_idx, s_vals, s_y, dim=None):
    """A sparse fit on the kernels against the same fit on the plain loss
    on the card, and the transform against the plain row dots; `dim` is
    the feature count (SPARSE_DIM unless given). Returns the plain-loss
    fit's coefficients."""
    from flink_ml_tpu_torch.models.classification import linearsvc
    from flink_ml_tpu_torch.models.classification import logisticregression
    from flink_ml_tpu_torch.ops import losses
    from flink_ml_tpu_torch.ops import sparsekernels as sk
    from flink_ml_tpu_torch.ops.optimizer import SGD

    _, _, loss_name, lr, _ = LINEAR_PATHS[name]
    sgd = SGD(max_iter=MAX_ITER, learning_rate=lr, global_batch_size=BATCH, tol=TOL)
    dim = SPARSE_DIM if dim is None else dim
    c_k, loss_k, ep_k = sgd.optimize(np.zeros(dim), (s_idx, s_vals), s_y, None,
                                     losses.SPARSE_VARIANTS[loss_name])
    c_p, loss_p, ep_p = sgd.optimize(np.zeros(dim), (s_idx, s_vals), s_y, None,
                                     losses.PLAIN_SPARSE_VARIANTS[loss_name])
    model = run["model"]
    rel = abs(loss_k - loss_p) / max(abs(loss_p), 1e-30)
    scale = float(np.max(np.abs(c_p)))
    coeff_err = float(np.max(np.abs(c_k - c_p)))
    model_err = float(np.max(np.abs(model.coefficient - c_p)))
    log(f"  sparse {name} loss {loss_k:.8f} (kernels) vs {loss_p:.8f} (plain): relDiff {rel:.3g}; "
        f"coeff max abs diff {coeff_err:.3g} and {model_err:.3g} (fit) of max |coeff| {scale:.3g}")
    check(rel < LOSS_REL_TOL, f"sparse {name} loss relDiff {rel} >= {LOSS_REL_TOL}")
    check(ep_k == ep_p, f"sparse {name} epoch counts differ")
    # atomics reorder float32 sums: hold coefficients to 1e-4 of their scale
    check(coeff_err <= 1e-4 * scale and model_err <= 1e-4 * scale,
          f"sparse {name} coefficients differ from the plain-loss fit")
    coeff = torch.as_tensor(model.coefficient, device=s_idx.device)
    plain = sk.sparse_row_dots_plain(s_idx, s_vals, coeff)
    out = run["out"]
    if name == "lr":
        got, want, tol = out.column("rawPrediction"), logisticregression._predict_from_dot(plain)[1], \
            dict(rtol=1e-5, atol=1e-6)
    elif name == "svc":
        got, want, tol = out.column("rawPrediction"), linearsvc._predict_from_dot(plain, 0.0)[1], \
            ROW_DOTS_TOL
    else:
        got, want, tol = out.column("prediction"), plain, ROW_DOTS_TOL
    check(got.shape == want.shape and bool(torch.isfinite(got).all()), f"sparse {name} transform shape")
    check(torch.allclose(got, want, **tol), f"sparse {name} transform disagrees with plain")
    return c_p


def sparse_data(dev):
    """The wide sparse table's (indices, values, labels), seeded on the card:
    1M rows, 39 uniform columns of 1e6, random 0/1 labels."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    s_idx = torch.randint(0, SPARSE_DIM, (SPARSE_ROWS, NNZ), generator=gen, device=dev,
                          dtype=torch.int32)
    s_vals = torch.rand((SPARSE_ROWS, NNZ), generator=gen, device=dev)
    s_y = (torch.rand(SPARSE_ROWS, generator=gen, device=dev) > 0.5).to(torch.float32)
    return s_idx, s_vals, s_y


def kmeans_data(dev):
    """conf/kmeans-benchmark.json's input: DenseVectorGenerator's uniform
    [0, 1) vectors, 1M x 100, born on the card from a seeded generator."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(KMEANS_SEED)
    return torch.rand((KMEANS_ROWS, DIM), generator=gen, device=dev)


def kmeans_estimator():
    from flink_ml_tpu_torch.models.clustering import kmeans

    return kmeans.KMeans().set_k(KMEANS_K).set_max_iter(KMEANS_ITER).set_seed(KMEANS_SEED)


def lloyd64(X64, init, max_iter):
    """Lloyd's algorithm in float64, written apart from the port: direct
    distances (cdist without the matmul form), a scatter-add of the cells'
    sums. Returns (centroids, counts) on X64's device."""
    centroids = init.clone()
    k = init.shape[0]
    counts = None
    for _ in range(max_iter):
        assign = torch.cat([
            torch.argmin(torch.cdist(X64[i:i + 100_000], centroids,
                                     compute_mode="donot_use_mm_for_euclid_dist"), dim=1)
            for i in range(0, X64.shape[0], 100_000)])
        counts = torch.bincount(assign, minlength=k).to(torch.float64)
        sums = torch.zeros_like(centroids).index_add_(0, assign, X64)
        centroids = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1)[:, None], centroids)
    return centroids, counts


def check_kmeans(run, X):
    """KMeans against a float64 Lloyd from the same init rows; the
    transform's assignments against float64 distances outside a 1e-4
    relative margin; a refit bit for bit. Returns the points inside the
    margin and the float64 Lloyd's (centroids, counts)."""
    from flink_ml_tpu_torch.models.clustering import kmeans

    model = run["model"]
    X64 = X.double()
    idx = torch.as_tensor(kmeans.init_rows(KMEANS_ROWS, KMEANS_K, KMEANS_SEED), device=X.device)
    ref_c, ref_counts = lloyd64(X64, X64[idx], KMEANS_ITER)
    ref_c_host = ref_c.cpu().numpy()
    scale = float(np.max(np.abs(ref_c_host)))
    c_err = float(np.max(np.abs(model.centroids - ref_c_host)))
    count_diff = int(np.sum(np.abs(model.weights - ref_counts.cpu().numpy())))
    log(f"  kmeans centroids vs float64 Lloyd: max abs diff {c_err:.3g} of scale {scale:.3g}; "
        f"counts differ by {count_diff} points in all")
    check(c_err <= 1e-3 * scale, f"kmeans centroids differ from the float64 Lloyd by {c_err}")
    check(model.weights.sum() == KMEANS_ROWS, "kmeans weights do not count every point")

    C64 = torch.as_tensor(model.centroids, dtype=torch.float64, device=X.device)
    assign = run["out"].column("prediction")
    check(assign.shape == (KMEANS_ROWS,) and assign.dtype == torch.int32, "kmeans transform shape")
    inside, mismatched, _ = kmeans_assignments64(X64, C64, assign)
    log(f"  kmeans transform vs float64 distances: {inside} points within the 1e-4 margin "
        f"(not gated), {mismatched} mismatches outside it")
    check(mismatched == 0, f"kmeans transform assigns {mismatched} clear points differently")
    refit = kmeans_estimator().fit(run["table"])
    check(np.array_equal(refit.centroids, model.centroids) and np.array_equal(refit.weights, model.weights),
          "kmeans refit is not bit-identical")
    del X64
    return inside, (ref_c, ref_counts)


def pipeline_data(dev):
    """The BASELINE pipeline's input: 1M rows of 100 uniform features, a
    categorical column of arity 10 (conf/onehotencoder-benchmark.json), and
    binary labels from a seeded linear rule with noise."""
    from flink_ml_tpu_torch import Table

    gen = torch.Generator(device=dev)
    gen.manual_seed(PIPELINE_SEED)
    X = torch.rand((PIPELINE_ROWS, DIM), generator=gen, device=dev)
    cat = torch.randint(0, ARITY, (PIPELINE_ROWS,), generator=gen, device=dev).to(torch.float32)
    noise = torch.randn(PIPELINE_ROWS, generator=gen, device=dev)
    y = ((X[:, 0] + X[:, 1] - 1.0) + 0.2 * (cat - 4.5) / 4.5 + 0.3 * noise > 0).to(torch.float32)
    return Table({"features": X, "cat": cat, "label": y})


def pipeline():
    from flink_ml_tpu_torch import Pipeline
    from flink_ml_tpu_torch.models.classification import logisticregression
    from flink_ml_tpu_torch.models.feature import onehotencoder, standardscaler, vectorassembler

    # centred: uncentred scaled features (mean 1.7 in each of 100 columns)
    # make LogisticRegression at learningRate 0.1 oscillate
    return Pipeline([
        standardscaler.StandardScaler().set_input_col("features").set_output_col("scaled")
        .set_with_mean(True),
        onehotencoder.OneHotEncoder().set_input_cols("cat").set_output_cols("cat_vec"),
        vectorassembler.VectorAssembler().set_input_cols("scaled", "cat_vec")
        .set_output_col("assembled"),
        estimator(logisticregression.LogisticRegression).set_features_col("assembled"),
    ])


def check_pipeline(run, table):
    """The scaler's stats against float64, the one-hot indices against
    numpy's, the LR against a float64 replay on the assembled float64
    matrix."""
    scaler, encoder, _, lr_model = run["model"].stages
    X64 = table.column("features").double()
    mean64, std64 = X64.mean(0).cpu().numpy(), X64.std(0).cpu().numpy()
    mean_rel = float(np.max(np.abs(scaler.mean - mean64) / np.abs(mean64)))
    std_rel = float(np.max(np.abs(scaler.std - std64) / np.abs(std64)))
    log(f"  pipeline scaler vs float64: mean max rel {mean_rel:.3g}, std max rel {std_rel:.3g}")
    check(mean_rel < 1e-4 and std_rel < 1e-4, "pipeline scaler stats differ from float64")

    cat = table.column("cat").cpu().numpy().astype(np.int64)
    vec_size = int(encoder.category_sizes[0]) - 1
    check(vec_size == ARITY - 1, f"one-hot vector size {vec_size}")
    want_idx = np.where(cat < vec_size, cat, -1)
    got_idx = run["out"].column("cat_vec").indices[:, 0].cpu().numpy()
    check(np.array_equal(got_idx, want_idx), "one-hot indices differ from numpy's")

    scale = np.where(scaler.std > 0, scaler.std, 1.0)
    onehot = np.zeros((PIPELINE_ROWS, vec_size))
    rows = np.nonzero(want_idx >= 0)[0]
    onehot[rows, want_idx[rows]] = 1.0
    A64 = np.hstack([(X64.cpu().numpy() - scaler.mean) / scale, onehot])
    y64 = table.column("label").double().cpu().numpy()
    ones = np.ones(BATCH)
    ref_coeff, ref_loss, ref_epochs = numpy_reference_sgd(
        lambda k: (A64[k * BATCH:(k + 1) * BATCH], y64[k * BATCH:(k + 1) * BATCH], ones),
        PIPELINE_ROWS // BATCH, MAX_ITER, LEARNING_RATE, TOL,
    )
    coeff_rel = float(np.max(np.abs(lr_model.coefficient - ref_coeff)) / np.max(np.abs(ref_coeff)))
    pred = run["out"].column("prediction").cpu().numpy()
    accuracy = float(np.mean(pred == y64))
    log(f"  pipeline LR vs float64 replay on the assembled matrix: coeff max rel {coeff_rel:.3g} "
        f"({ref_epochs} epochs, loss {ref_loss:.6f}); training accuracy {accuracy:.4f}")
    check(coeff_rel < 1e-3, f"pipeline LR coefficients differ from the replay by {coeff_rel}")
    check(accuracy > 0.7, f"the pipeline's training accuracy {accuracy} is near chance")
    check(run["out"].column("assembled").shape == (PIPELINE_ROWS, DIM + vec_size), "assembled width")


def kmeans_assignments64(X64, C64, assign):
    """Float64 nearest centroids of X64's rows against `assign`: (points
    within the TIE_MARGIN, clear points assigned otherwise, the float64
    assignment)."""
    d64 = torch.cat([torch.cdist(X64[i:i + 100_000], C64, compute_mode="donot_use_mm_for_euclid_dist")
                     for i in range(0, X64.shape[0], 100_000)])
    two = torch.topk(d64, 2, dim=1, largest=False)
    clear = (two.values[:, 1] - two.values[:, 0]) > TIE_MARGIN * two.values[:, 1]
    mismatched = int(((assign.long() != two.indices[:, 0]) & clear).sum())
    return int((~clear).sum()), mismatched, two.indices[:, 0]


def host_columns(seed, rows, fill):
    """Host columns of `rows` rows, made chunk by chunk: chunk i of
    STREAM_CHUNK rows from np.random.default_rng([seed, i]), filled by
    `fill(rng, start, stop)`."""
    for i, start in enumerate(range(0, rows, STREAM_CHUNK)):
        fill(np.random.default_rng([seed, i]), start, min(start + STREAM_CHUNK, rows))


def stream_lr_data(rows=None):
    """conf/logisticregression-benchmark.json's table on the host, as the
    stream paths get it: 10M x 100 uniform [0, 1) features, random 0/1
    labels, uniform weights, float32; with `rows`, its first rows only
    (the same values: each chunk has its own seed, and the chunk that
    holds the last row is made whole, as in the full table, then cut)."""
    want = DENSE_ROWS if rows is None else rows
    rows = min(DENSE_ROWS, -(-want // STREAM_CHUNK) * STREAM_CHUNK)
    X = np.empty((rows, DIM), np.float32)
    y = np.empty(rows, np.float32)
    w = np.empty(rows, np.float32)

    def fill(rng, a, b):
        rng.random((b - a, DIM), dtype=np.float32, out=X[a:b])
        y[a:b] = rng.integers(0, 2, b - a)
        rng.random(b - a, dtype=np.float32, out=w[a:b])

    host_columns(STREAM_SEED, rows, fill)
    return {"features": X[:want], "label": y[:want], "weight": w[:want]}


def planted_rows(seed, rows, truth):
    """Uniform [-0.5, 0.5) features and the labels of the hyperplane
    `truth` through the origin, float32."""
    X = np.empty((rows, DIM), np.float32)

    def fill(rng, a, b):
        rng.random((b - a, DIM), dtype=np.float32, out=X[a:b])
        X[a:b] -= 0.5

    host_columns(seed, rows, fill)
    return {"features": X, "label": (X @ truth > 0).astype(np.float32)}


def stream_of(columns, rows, chunk):
    """A one-shot StreamTable of host Tables of `chunk` rows (views)."""
    from flink_ml_tpu_torch import StreamTable, Table

    return StreamTable(Table({k: v[i:i + chunk] for k, v in columns.items()})
                       for i in range(0, rows, chunk))


def device_table(columns, rows, dev):
    from flink_ml_tpu_torch import Table

    return Table({k: torch.from_numpy(v[:rows]).to(dev) for k, v in columns.items()})


def sgd_chunks(columns, rows):
    """(X, y, w) host chunks of the first `rows` rows, for SGD.optimize_stream."""
    X, y, w = columns["features"], columns["label"], columns["weight"]
    return ((X[i:min(i + STREAM_CHUNK, rows)], y[i:min(i + STREAM_CHUNK, rows)],
             w[i:min(i + STREAM_CHUNK, rows)]) for i in range(0, rows, STREAM_CHUNK))


def stream_sgd():
    from flink_ml_tpu_torch.ops.optimizer import SGD

    return SGD(max_iter=MAX_ITER, learning_rate=LEARNING_RATE, global_batch_size=BATCH, tol=TOL)


def check_stream_lr(run, columns, bounded_table, default_budget):
    """The stream fit against the port's bounded fit of the rows its epochs
    train (the first MAX_ITER batches) on the card, and against the float64
    replay; a fit whose cache spills against its in-memory twin."""
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression
    from flink_ml_tpu_torch.ops import losses

    model = run["model"]
    bounded = estimator(LogisticRegression, "weight").fit(bounded_table).coefficient
    rel = float(np.max(np.abs(model.coefficient - bounded)) / np.max(np.abs(bounded)))
    bits = bool(np.array_equal(model.coefficient, bounded))
    rows = MAX_ITER * BATCH
    X64 = columns["features"][:rows].astype(np.float64)
    y64, w64 = columns["label"][:rows].astype(np.float64), columns["weight"][:rows].astype(np.float64)
    ref, ref_loss, ref_epochs = numpy_reference_sgd(
        lambda k: (X64[k * BATCH:(k + 1) * BATCH], y64[k * BATCH:(k + 1) * BATCH],
                   w64[k * BATCH:(k + 1) * BATCH]), MAX_ITER, MAX_ITER, LEARNING_RATE, TOL)
    del X64
    ref_rel = float(np.max(np.abs(model.coefficient - ref)) / np.max(np.abs(ref)))
    log(f"  stream lr vs the bounded fit of its {rows} rows on the card: max rel {rel:.3g}, "
        f"bit-identical {bits}; vs the float64 replay: max rel {ref_rel:.3g} ({ref_epochs} epochs)")
    check(rel <= 1e-6, f"stream lr differs from the bounded fit by {rel}")
    check(ref_rel < 1e-3, f"stream lr differs from the float64 replay by {ref_rel}")
    spill_rows = SPILL_BATCHES * BATCH
    twins = {}
    for label, budget in (("spilled", default_budget), ("in memory", STREAM_CACHE_BUDGET)):
        coeff, _, epochs, stats = stream_sgd().optimize_stream(
            None, sgd_chunks(columns, spill_rows), losses.BINARY_LOGISTIC_LOSS,
            memory_budget_bytes=budget)
        twins[label] = coeff
        log(f"  stream lr on {SPILL_BATCHES} batches, {label} (budget {budget} bytes): {stats}")
        check((stats["spilledSegments"] > 0) == (label == "spilled"), f"{label} twin's cache {stats}")
    check(np.array_equal(twins["spilled"], twins["in memory"]),
          "the spilled stream fit differs from its in-memory twin")
    log("  stream lr: the spilled fit equals its in-memory twin bit for bit")
    pred = run["out"].column("prediction")
    check(pred.shape == (rows,) and bool(torch.isfinite(pred).all()), "stream lr transform")


def check_stream_kmeans(run, X, columns, lloyd, bounded_model):
    """The stream fit from the bounded fit's init rows, against the float64
    Lloyd (the bounded KMeans path's gate); its difference from the bounded fit."""
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.models.clustering import kmeans

    model = run["model"]
    drawn = kmeans._sample_without_replacement(
        np.random.RandomState(KMEANS_SEED % 2**32), KMEANS_ROWS, KMEANS_K)
    check(np.array_equal(drawn, kmeans.init_rows(KMEANS_ROWS, KMEANS_K, KMEANS_SEED)),
          "the stream fit draws other init rows")
    one = kmeans_estimator().set_max_iter(1)
    first_stream = one.fit(stream_of(columns, KMEANS_ROWS, KMEANS_CHUNK)).centroids
    first_bounded = one.fit(Table({"features": X})).centroids
    first_rel = float(np.max(np.abs(first_stream - first_bounded)) / np.max(np.abs(first_bounded)))
    check(first_rel < 1e-5, f"one stream epoch differs from one bounded epoch by {first_rel}")
    ref_c, ref_counts = (t.cpu().numpy() for t in lloyd)
    scale = float(np.max(np.abs(ref_c)))
    c_err = float(np.max(np.abs(model.centroids - ref_c)))
    count_diff = int(np.sum(np.abs(model.weights - ref_counts)))
    b_err = float(np.max(np.abs(model.centroids - bounded_model.centroids)))
    b_counts = int(np.sum(np.abs(model.weights - bounded_model.weights)))
    log(f"  stream kmeans: init rows are the bounded fit's (one epoch apart by {first_rel:.3g}); "
        f"vs float64 Lloyd max abs {c_err:.3g} of scale {scale:.3g}, counts differ by {count_diff}; "
        f"vs the bounded fit max abs {b_err:.3g}, counts differ by {b_counts}")
    check(c_err <= 1e-3 * scale, f"stream kmeans centroids differ from the float64 Lloyd by {c_err}")
    check(model.weights.sum() == KMEANS_ROWS, "stream kmeans weights do not count every point")
    C64 = torch.as_tensor(model.centroids, dtype=torch.float64, device=X.device)
    inside, mismatched, _ = kmeans_assignments64(X.double(), C64, run["out"].column("prediction"))
    log(f"  stream kmeans transform: {inside} points within the margin, {mismatched} clear mismatches")
    check(mismatched == 0, f"stream kmeans transform assigns {mismatched} clear points differently")


def online_lr_estimator():
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.linalg import DenseVector
    from flink_ml_tpu_torch.models.classification import onlinelogisticregression as olr

    return (olr.OnlineLogisticRegression().set_global_batch_size(BATCH)
            .set_reg(ONLINE_REG).set_elastic_net(ONLINE_ELASTIC_NET)
            .set_initial_model_data(Table({"coefficient": [DenseVector(np.zeros(DIM))]})))


def online_lr_fit(columns, trace=None):
    """The online fit as a user drives it: fit, then train every version
    (ten at a time, recording each tenth coefficient into `trace`)."""
    model = online_lr_estimator().fit(stream_of(columns, DENSE_ROWS, STREAM_CHUNK))
    while True:
        version = model.model_version
        if model.process_updates(10) == version:
            return model
        if trace is not None:
            trace[model.model_version] = model.coefficient.copy()


def ftrl64_replay(columns, versions):
    """FTRL-Proximal in float64 numpy, written apart from the port: returns
    {version: (coefficient, |z| - l1)} at `versions`."""
    X, y = columns["features"], columns["label"]
    l1, l2 = ONLINE_ELASTIC_NET * ONLINE_REG, (1.0 - ONLINE_ELASTIC_NET) * ONLINE_REG
    alpha = beta = 0.1
    coeff, z, n = np.zeros(DIM), np.zeros(DIM), np.zeros(DIM)
    out = {}
    for v in range(1, max(versions) + 1):
        Xb = X[(v - 1) * BATCH:v * BATCH].astype(np.float64)
        yb = y[(v - 1) * BATCH:v * BATCH].astype(np.float64)
        p = 1.0 / (1.0 + np.exp(-(Xb @ coeff)))
        count = np.count_nonzero(Xb, axis=0)
        g = np.where(count > 0, (Xb.T @ (p - yb)) / np.maximum(count, 1), 0.0)
        sigma = (np.sqrt(n + g * g) - np.sqrt(n)) / alpha
        z = z + g - sigma * coeff
        n = n + g * g
        coeff = np.where(np.abs(z) <= l1, 0.0,
                         (np.sign(z) * l1 - z) / ((beta + np.sqrt(n)) / alpha + l2))
        if v in versions:
            out[v] = (coeff, np.abs(z) - l1)
    return out


def check_online_lr(run, columns, trace, held):
    """Every tenth version and the last against the float64 FTRL replay,
    near-threshold coordinates counted and left out; the version stamp;
    accuracy on a held-out batch."""
    model, out = run["model"], run["out"]
    versions = DENSE_ROWS // BATCH
    check(model.model_version == versions, f"online lr ends at version {model.model_version}")
    check(sorted(trace) == list(range(10, versions + 1, 10)), f"online lr versions {sorted(trace)}")
    l1 = ONLINE_ELASTIC_NET * ONLINE_REG
    worst, near_total = 0.0, 0
    for v, (ref, margin) in ftrl64_replay(columns, set(trace)).items():
        clear = np.abs(margin) > NEAR_L1_SHARE * l1
        near_total += int(np.sum(~clear))
        rel = float(np.max(np.abs(trace[v] - ref)[clear]) / np.max(np.abs(ref)))
        worst = max(worst, rel)
        check(rel < 1e-3, f"online lr version {v} differs from the float64 replay by {rel}")
    zeros = int(np.sum(model.coefficient == 0.0))
    log(f"  online lr: {len(trace)} versions vs the float64 FTRL replay, worst max rel {worst:.3g}; "
        f"{near_total} near-threshold coordinates left out in all; {zeros} of {DIM} coefficients are 0")
    stamp = out.column("modelVersion")
    check(stamp.dtype == torch.int32 and bool((stamp == versions).all()), "online lr modelVersion column")
    accuracy = float((out.column("prediction") == held.column("label")).float().mean())
    log(f"  online lr held-out accuracy {accuracy:.4f} at version {model.model_version}")
    check(accuracy > 0.9, f"online lr held-out accuracy {accuracy}")


def online_kmeans_fit(columns, init_model, trace=None):
    """OnlineKMeans from a KMeans model (its centroids, its counts as
    weights) over the KMeans rows, trained one version at a time, each
    recorded into `trace` as (version, centroids, weights)."""
    from flink_ml_tpu_torch.models.clustering import onlinekmeans

    est = (onlinekmeans.OnlineKMeans().set_k(KMEANS_K).set_global_batch_size(BATCH)
           .set_decay_factor(ONLINE_KMEANS_DECAY)
           .set_initial_model_data(init_model.get_model_data()[0]))
    model = est.fit(stream_of(columns, KMEANS_ROWS, KMEANS_CHUNK))
    while True:
        version = model.model_version
        if model.process_updates(1) == version:
            return model
        if trace is not None:
            trace.append((model.model_version, model.centroids.copy(), model.weights.copy()))


def check_online_kmeans(run, X, init_model, trace):
    """Every version against a float64 replay of its decayed update from the
    version before, under the KMeans path's near-tie rule: points outside the margin
    are assigned as float64 assigns them, and the weights differ by at most
    two for each point inside it."""
    from flink_ml_tpu_torch.ops.distance import DistanceMeasure

    model = run["model"]
    versions = KMEANS_ROWS // BATCH
    check(model.model_version == versions, f"online kmeans ends at version {model.model_version}")
    check([v for v, _, _ in trace] == list(range(1, versions + 1)), "online kmeans versions")
    measure = DistanceMeasure.get_instance("euclidean")
    prev_c, prev_w = init_model.centroids, init_model.weights
    worst, inside_total, flips = 0.0, 0, 0.0
    for v, c32, w32 in trace:
        Xb = X[(v - 1) * BATCH:v * BATCH]
        assign = measure.find_closest(Xb, torch.as_tensor(prev_c, dtype=torch.float32, device=X.device))
        C64 = torch.as_tensor(prev_c, dtype=torch.float64, device=X.device)
        X64 = Xb.double()
        inside, mismatched, assign64 = kmeans_assignments64(X64, C64, assign)
        check(mismatched == 0, f"online kmeans version {v}: {mismatched} clear points assigned otherwise")
        counts = torch.bincount(assign64, minlength=KMEANS_K).double()
        sums = torch.zeros_like(C64).index_add_(0, assign64, X64)
        means = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1)[:, None], C64)
        decayed = torch.as_tensor(prev_w, dtype=torch.float64, device=X.device) * ONLINE_KMEANS_DECAY
        c64 = ((C64 * decayed[:, None] + means * counts[:, None])
               / (decayed + counts).clamp(min=1e-16)[:, None]).cpu().numpy()
        w64 = (decayed + counts).cpu().numpy()
        rel = float(np.max(np.abs(c32 - c64)) / np.max(np.abs(c64)))
        w_diff = float(np.sum(np.abs(w32 - w64)))
        check(rel <= 1e-3, f"online kmeans version {v} differs from the float64 update by {rel}")
        check(w_diff <= 2 * inside, f"online kmeans version {v} weights differ by {w_diff}")
        worst, inside_total, flips = max(worst, rel), inside_total + inside, flips + w_diff
        prev_c, prev_w = c32, w32
    C64 = torch.as_tensor(model.centroids, dtype=torch.float64, device=X.device)
    inside, mismatched, _ = kmeans_assignments64(X.double(), C64, run["out"].column("prediction"))
    log(f"  online kmeans: {versions} versions vs float64 updates, worst max rel {worst:.3g}; "
        f"{inside_total} batch points within the margin, weights apart by {flips:g} in all; "
        f"transform: {inside} points within the margin, {mismatched} clear mismatches")
    check(mismatched == 0, f"online kmeans transform assigns {mismatched} clear points differently")


def online_lr_split(columns, dev):
    """The parts of an online LR version, each timed apart: the rebatch
    generator alone, the staging of every batch (copy into a pinned buffer
    and the upload, waited for), the upload alone (CUDA events), the FTRL
    step (CUDA events) and the publication of a coefficient (host clock)."""
    from flink_ml_tpu_torch.models.classification import onlinelogisticregression as olr
    from flink_ml_tpu_torch.parallel.prefetch import DeviceStager
    from flink_ml_tpu_torch.table import global_batches

    versions = DENSE_ROWS // BATCH
    t0 = time.perf_counter()
    batches = list(global_batches(stream_of(columns, DENSE_ROWS, STREAM_CHUNK), (
        lambda t: t.column("features"), lambda t: t.column("label").astype(np.float64)), BATCH))
    rebatch_ms = (time.perf_counter() - t0) * 1e3 / versions
    stager = DeviceStager(dev, torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        staged = stager(b).wait()
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) * 1e3 / versions
    del batches
    X, y = staged
    pinned = torch.empty(X.numel() * 4 + y.numel() * 4, dtype=torch.uint8, pin_memory=True)
    target = torch.empty_like(pinned, device=dev)
    upload_ms = cuda_ms(lambda: target.copy_(pinned, non_blocking=True), [()], iters=10)
    state = tuple(torch.zeros(DIM, device=dev) for _ in range(3))
    l1, l2 = ONLINE_ELASTIC_NET * ONLINE_REG, (1.0 - ONLINE_ELASTIC_NET) * ONLINE_REG
    step_ms = cuda_ms(lambda: olr._ftrl_step(*state, X, y, 0.1, 0.1, l1, l2), [()])
    coeff = state[0] + 1.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(versions):
        coeff.cpu().numpy()
    publish_ms = (time.perf_counter() - t0) * 1e3 / versions
    log(f"  online lr per version, timed apart: rebatch {rebatch_ms:.4f} ms, staging (pinned copy + "
        f"upload) {stage_ms:.3f} ms, upload alone {upload_ms:.3f} ms "
        f"({pinned.numel() / upload_ms / 1e6:.2f} GB/s), FTRL step {step_ms:.4f} ms, publish {publish_ms:.4f} ms")
    return {"rebatch_ms": rebatch_ms, "stage_ms": stage_ms, "upload_ms": upload_ms,
            "step_ms": step_ms, "publish_ms": publish_ms}


def profile_overlap(name, run):
    """A profiler pass over one call (utils/traceprof.capture_trace): wall,
    device busy and idle share, and how much of the host-to-device copy
    time runs under kernels."""
    from flink_ml_tpu_torch.utils import traceprof

    stats = traceprof.capture_trace(run)
    wall_ms, busy_ms = stats["wallMs"], stats["deviceBusyMs"]
    copy_ms, overlap_ms = stats["hostToDeviceMs"], stats["hostToDeviceUnderKernelsMs"]
    kernel_ms = stats["byCategory"].get("kernel", {}).get("durUs", 0.0) / 1e3
    log(f"  profile {name}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"(idle {100.0 * (1.0 - busy_ms / wall_ms):.1f}%); uploads {copy_ms:.3f} ms, "
        f"kernels {kernel_ms:.3f} ms, uploads under kernels {overlap_ms:.3f} ms "
        f"({100.0 * overlap_ms / max(copy_ms, 1e-9):.1f}% of upload time)")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "upload_ms": copy_ms, "kernel_ms": kernel_ms,
            "overlap_ms": overlap_ms}

#: rows of phase 3's tables that the Table API check takes with head()
HEAD_ROWS = 1_024


def _shares_storage(a, b) -> bool:
    """Do two columns hold the same tensors (a SparseBatch's indices and
    values)?"""
    from flink_ml_tpu_torch import SparseBatch

    if isinstance(a, SparseBatch):
        return a.indices.data_ptr() == b.indices.data_ptr() and \
            a.values.data_ptr() == b.values.data_ptr()
    return a.data_ptr() == b.data_ptr()


def _on_card(col) -> bool:
    from flink_ml_tpu_torch import SparseBatch

    parts = (col.indices, col.values) if isinstance(col, SparseBatch) else (col,)
    return all(isinstance(t, torch.Tensor) and t.is_cuda == (DEVICE == "cuda") for t in parts)


def _first_rows(col, n):
    from flink_ml_tpu_torch import SparseBatch

    if isinstance(col, SparseBatch):
        return SparseBatch(col.size, col.indices[:n], col.values[:n])
    return col[:n]


def table_api_check(sk, dense_table, sparse_table, sparse_model):
    """The Table API on phase 3's device tables (the 10M x 100 dense table
    and the 1M x 39 sparse one): head(HEAD_ROWS), select, drop, rename and
    with_column leave every column on the card; select, drop and rename
    share the source's storage; none moves an `iteration.host_sync`
    counter; head's rows are the table's first rows; and the fused sparse
    LR transform of the sparse head equals its eager transform bit for
    bit, having captured or replayed a graph, with one row-dot launch
    each. Returns what the output lines print and the row dots launched."""
    from flink_ml_tpu_torch import PipelineModel
    from flink_ml_tpu_torch.utils import lazyjit

    t0 = time.perf_counter()
    out = {}
    syncs = _counter("iteration.host_sync")
    for name, table in (("dense", dense_table), ("sparse", sparse_table)):
        first = table.column_names[0]
        derived = {"head": table.head(HEAD_ROWS), "select": table.select(*table.column_names[::-1]),
                   "drop": table.drop(table.column_names[-1]),
                   "rename": table.rename({first: "renamed"}),
                   "with_column": table.with_column("extra", table.column(first))}
        out[name] = {}
        for op, t in derived.items():
            cols = [t.column(c) for c in t.column_names]
            check(all(_on_card(c) for c in cols), f"{name} {op}: a column left the card")
            shared = all(_shares_storage(t.column(c), table.column(
                first if c == "renamed" else c)) for c in t.column_names if c != "extra")
            if op in ("select", "drop", "rename"):
                check(shared, f"{name} {op}: a column was copied")
            out[name][op] = {"rows": t.num_rows, "columns": t.column_names, "shared": shared}
        head = derived["head"]
        check(head.num_rows == HEAD_ROWS and all(
            same_column(head.column(c), _first_rows(table.column(c), HEAD_ROWS))
            for c in table.column_names), f"{name} head({HEAD_ROWS}) is not the first rows")
    moved = _counter("iteration.host_sync") - syncs
    check(moved == 0, f"the Table API moved iteration.host_sync by {moved}")
    head = sparse_table.select("features").head(HEAD_ROWS)
    stamps = lambda: {(id(e), e.stamp) for c in list(lazyjit._caches)  # noqa: E731
                      for e in c.entries.values()}
    sk.reset_launch_counts()
    before = stamps()
    pipeline = PipelineModel([sparse_model])  # held: its segment's graph cache is weakly listed
    fused = pipeline.transform(head)[0]
    fused_cols = {col: fused.column(col) for col in ("prediction", "rawPrediction")}
    graphed = len(stamps() - before)  # graphs captured or replayed by the fused call
    eager = sparse_model.transform(head)[0]
    for col in ("prediction", "rawPrediction"):
        check(same_column(fused_cols[col], eager.column(col)),
              f"the fused sparse LR transform of head({HEAD_ROWS}) differs from eager in {col}")
    launches = sk.launch_counts()
    check(graphed > 0,  # on the CPU an entry with no graph, stamped alike
          f"the fused transform of head({HEAD_ROWS}) captured or replayed no graph")
    check(launches == launch_dict(sparse_row_dots=2),
          f"the fused and eager transforms of head({HEAD_ROWS}) launched {launches}")
    out["seconds"] = time.perf_counter() - t0
    log(f"  table api: head({HEAD_ROWS}), select, drop, rename and with_column on the dense and "
        f"sparse tables: every column on the card, select/drop/rename share storage, "
        f"iteration.host_sync moved {moved}; the fused sparse LR transform of head({HEAD_ROWS}) "
        f"equals eager bit for bit ({graphed} graph(s) captured or replayed; launches "
        f"{launches}); {out['seconds']:.2f} s")
    return out, launches


def _ledger_peak(category, fn):
    """fn() and the most bytes the memory ledger held under `category`
    while it ran (a register hook)."""
    from flink_ml_tpu_torch.obs import memledger

    register, peak = memledger.register, [memledger.live_bytes(category)]

    def observed(cat, nbytes, *args, **kwargs):
        handle = register(cat, nbytes, *args, **kwargs)
        if cat == category:
            peak[0] = max(peak[0], memledger.live_bytes(category))
        return handle

    memledger.register = observed
    try:
        return fn(), peak[0]
    finally:
        memledger.register = register


def budgeted_stream_kmeans(km_cols, default_model):
    """Phase 3's stream KMeans once more under `device_cache_budget(0)`: the
    device epoch cache holds no ledgered byte (every batch is staged again
    each epoch), the model equals the default run's bit for bit, and
    `config.device_cache_bytes` is restored after the scope."""
    from flink_ml_tpu_torch import config as port_config
    from flink_ml_tpu_torch.data import devicecache

    before = port_config.device_cache_bytes
    fit = lambda: kmeans_estimator().fit(stream_of(km_cols, KMEANS_ROWS, KMEANS_CHUNK))  # noqa: E731
    (default_again, default_peak) = _ledger_peak("batchCache", lambda: synced(fit))
    with port_config.device_cache_budget(0):
        nothing_fits = not devicecache.within_device_budget(1)
        (model, ms), peak = _ledger_peak("batchCache", lambda: synced(fit))
    restored = port_config.device_cache_bytes == before
    same = all(np.asarray(a).tobytes() == np.asarray(b).tobytes() for a, b in
               ((model.centroids, default_model.centroids), (model.weights, default_model.weights)))
    log(f"  stream kmeans under device_cache_budget(0): {ms:.1f} ms (default {default_again[1]:.1f} "
        f"ms), batchCache ledger peak {peak} bytes (default {default_peak}), model equal to the "
        f"default run bit for bit: {same}; device_cache_bytes restored: {restored}")
    check(nothing_fits and peak == 0, f"the budget-0 stream kmeans ledgered {peak} cache bytes")
    check(same, "the budget-0 stream kmeans differs from the default run")
    check(restored, f"device_cache_bytes is {port_config.device_cache_bytes}, not {before}")
    return {"ms": ms, "default_ms": default_again[1], "ledger_peak": peak,
            "default_ledger_peak": default_peak}


def stream_and_online_times(stream_cols, km_cols, online_cols, kmeans_model, dev, path_s):
    """Phase 5 for the stream and online paths: two warm runs of each, the
    stream fits split into ingest (rows a second into the data cache) and
    fit, the online fits in versions a second with the parts of a version
    timed apart, and a torch.profiler pass over one more run of each."""
    from flink_ml_tpu_torch.native.datacache import ReplayableStreamTable
    from flink_ml_tpu_torch.ops import losses

    def stream_fit():
        return stream_sgd().optimize_stream(
            None, sgd_chunks(stream_cols, DENSE_ROWS), losses.BINARY_LOGISTIC_LOSS)

    out = {}
    t0 = time.perf_counter()
    runs = []
    for _ in range(2):
        (_, _, _, stats), ms = synced(stream_fit)
        ingest_ms = stats["ingestSeconds"] * 1e3
        runs.append((ms, ingest_ms, ms - ingest_ms))
        log(f"  stream lr: {ms:.1f} ms = ingest {ingest_ms:.1f} ms ({DENSE_ROWS / ingest_ms * 1e3:.4g} "
            f"rows/s into the cache) + fit {ms - ingest_ms:.1f} ms; {stats}")
    out["stream lr"] = {"wall_ms": [r[0] for r in runs], "ingest_ms": [r[1] for r in runs],
                        "fit_ms": [r[2] for r in runs],
                        "profile": profile_overlap("stream lr fit (ingest included)", stream_fit)}
    path_s["stream lr"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    runs = []
    for _ in range(3):  # two timed runs, then one profiled
        t1 = time.perf_counter()
        replay = ReplayableStreamTable(stream_of(km_cols, KMEANS_ROWS, KMEANS_CHUNK), STREAM_CACHE_BUDGET)
        for _ in replay:  # the first pass caches every batch
            pass
        ingest_ms = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        for _ in replay:  # a pass that replays from the cache, as the fit's pass 0 does
            pass
        replay_ms = (time.perf_counter() - t1) * 1e3
        if len(runs) == 2:
            profile = profile_overlap("stream kmeans fit", lambda: kmeans_estimator().fit(replay))
        else:
            _, fit_ms = synced(lambda: kmeans_estimator().fit(replay))
            runs.append((ingest_ms, replay_ms, fit_ms))
            log(f"  stream kmeans: ingest {ingest_ms:.1f} ms ({KMEANS_ROWS / ingest_ms * 1e3:.4g} rows/s), "
                f"a replay pass {replay_ms:.1f} ms, fit {fit_ms:.1f} ms")
        replay.close()
    out["stream kmeans"] = {"ingest_ms": [r[0] for r in runs], "replay_ms": [r[1] for r in runs],
                            "fit_ms": [r[2] for r in runs], "profile": profile}
    path_s["stream kmeans"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    versions = DENSE_ROWS // BATCH
    walls = [synced(lambda: online_lr_fit(online_cols))[1] for _ in range(2)]
    for ms in walls:
        log(f"  online lr: {ms:.1f} ms for {versions} versions, {versions / ms * 1e3:.2f} versions/s, "
            f"{ms / versions:.3f} ms a version")
    out["online lr"] = {"wall_ms": walls, "split": online_lr_split(online_cols, dev),
                        "profile": profile_overlap("online lr fit", lambda: online_lr_fit(online_cols))}
    path_s["online lr"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    versions = KMEANS_ROWS // BATCH
    walls = [synced(lambda: online_kmeans_fit(km_cols, kmeans_model))[1] for _ in range(2)]
    for ms in walls:
        log(f"  online kmeans: {ms:.1f} ms for {versions} versions, {versions / ms * 1e3:.2f} "
            f"versions/s, {ms / versions:.3f} ms a version")
    out["online kmeans"] = {"wall_ms": walls, "profile": profile_overlap(
        "online kmeans fit", lambda: online_kmeans_fit(km_cols, kmeans_model))}
    path_s["online kmeans"] += time.perf_counter() - t0
    return out


# -- 6. the numeric feature stages ------------------------------------------------

#: rows of the conf/ tables: 10M for most stages, 1M for MinMaxScaler and
#: Bucketizer; the stream fits read 1M x 10 host rows in chunks
FEATURE_ROWS, FEATURE_SMALL_ROWS = 10_000_000, 1_000_000
FEATURE_STREAM_ROWS, FEATURE_STREAM_CHUNK = 1_000_000, 65_536
FEATURE_SEED, FEATURE_STREAM_SEED = 2, 23  # the conf/ generators' seed 2
FEATURE_REPEATS = 3
NAN_SHARE = 0.01  # the Imputer twins' missing entries
# max |port - float64 replay| over max |float64 replay|: the elementwise and
# affine stages; float32 sums of up to 10M terms (DCT at d = 100, the
# variances, the Imputer mean)
AFFINE_REL_TOL, SUM_REL_TOL = 1e-6, 1e-5
# the kmeans strategy's edges against a float64 Lloyd on the same rows:
# float32 and float64 Lloyd may stop an iteration apart
KMEANS_EDGE_TOL = 1e-3
FEATURE_JAVA = "org.apache.flink.ml.feature."
NO_LAUNCHES = launch_dict()


def feature_module(name):
    import importlib

    return importlib.import_module(f"flink_ml_tpu_torch.models.feature.{name}")


def seeded(seed, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def rel_err(got, want64):
    """max |got - want| over max |want|, in float64."""
    diff = (got.double() - want64).abs().max()
    return float(diff / want64.abs().max().clamp(min=torch.finfo(torch.float64).tiny))


def order_statistics64(X, rows):
    """Rows `rows` (0-based) of each column of X in sorted order, found in
    float64 by torch.kthvalue (a selection, not the port's sort)."""
    X64 = X.double()
    return torch.stack([torch.kthvalue(X64, int(r) + 1, dim=0).values for r in rows])


def jnp_quantile64(X, qs):
    """jnp.quantile's float32 linear quantile replayed from float64 order
    statistics: the same rows and weights, the product high * w rounded to
    float32 and the fused multiply-add done in float64, rounded once.
    Returns the quantiles and the floor rows."""
    n = X.shape[0]
    q = np.asarray(qs, np.float32) * (np.float32(n) - np.float32(1))
    low, high = np.floor(q), np.ceil(q)
    w_high = q - low
    w_low = np.float32(1) - w_high
    lo = order_statistics64(X, np.clip(low, 0, n - 1).astype(np.int64))
    hi = order_statistics64(X, np.clip(high, 0, n - 1).astype(np.int64))
    w_low = torch.as_tensor(w_low, dtype=torch.float64, device=X.device)[:, None]
    w_high = torch.as_tensor(w_high, dtype=torch.float64, device=X.device)[:, None]
    return (lo * w_low + (hi * w_high).float().double()).float(), lo


def bins64(X, edges_list):
    """Each feature's bin in float64 by counting: the edges (cast to
    float32, as the transform casts them) at or below x, minus one, clamped;
    NaN on top; a feature of <= 2 edges in bin 0."""
    out = torch.zeros(X.shape, dtype=torch.float64, device=X.device)
    for j, edges in enumerate(edges_list):
        top = max(edges.size - 2, 0)
        if top == 0:
            continue
        x = X[:, j].double()
        e = torch.as_tensor(edges.astype(np.float32).astype(np.float64), device=X.device)
        count = (x[:, None] >= e[None, :]).sum(dim=1) - 1
        out[:, j] = torch.where(torch.isnan(x), top, count.clamp(0, top)).double()
    return out


def poly_exponents(d, degree):
    """The exponent tuples of the monomials in the reference's order
    (PolynomialExpansion.java:103-117), the constant term left out."""
    def expand(last, deg):
        if deg == 0 or last < 0:
            yield (0,) * d
            return
        for i in range(deg + 1):
            for e in expand(last - 1, deg - i):
                yield e[:last] + (i,) + e[last + 1:]
    return list(expand(d - 1, degree))[1:]


def rank_window(sorted_col, value, p, eps):
    """True when `value` is within eps * n ranks of the p-quantile's rank
    ceil(p * n) in `sorted_col` (ties give a window of ranks)."""
    n = sorted_col.size
    below = np.searchsorted(sorted_col, value, side="left")
    upto = np.searchsorted(sorted_col, value, side="right")
    target = np.ceil(p * n)
    return below - eps * n - 1 <= target <= upto + eps * n + 1


def drive_feature(sk, name, stage, fit_table, table, tmp, out_cols, java, repeats=None):
    """One stage as a user runs it (`drive`: fit an estimator, transform,
    save, load, transform; `check_reload`: bit for bit), then `repeats`
    (FEATURE_REPEATS unless given) warm fits and transforms. The launch
    counts are reset before and read after; the peak is the card's
    high-water mark over the run above what it held before."""
    from flink_ml_tpu_torch.api import Estimator

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    estimator = isinstance(stage, Estimator)
    fit = (lambda: stage.fit(fit_table)) if estimator else (lambda: stage)
    run = drive(fit, table, tmp, name.replace(" ", "_"))
    repeats = FEATURE_REPEATS if repeats is None else repeats
    fits = [synced(fit)[1] for _ in range(repeats)] if estimator else []
    transforms = [synced(lambda: run["model"].transform(table)[0])[1] for _ in range(repeats)]
    counts = sk.launch_counts()
    high = torch.cuda.max_memory_allocated()
    check(counts == NO_LAUNCHES, f"{name} launched {counts}")
    check_reload(name, run, java, out_cols)
    del run["loaded"], run["again"]
    run.update(fit_ms=run["fit_ms"] if estimator else None,
               warm_fit_ms=float(np.median(fits)) if fits else None,
               warm_transform_ms=float(np.median(transforms)), fit_runs=fits,
               transform_runs=transforms, peak_gib=(high - held) / 2**30,
               high_water_gib=high / 2**30, launches=counts)
    first = f"fit {run['fit_ms']:.1f} ms, " if estimator else ""
    warm = f"fit {run['warm_fit_ms']:.3f} ms (runs {[round(t, 3) for t in fits]}), " if fits else ""
    log(f"  {name}: first {first}transform {run['transform_ms']:.1f} ms; warm median {warm}transform "
        f"{run['warm_transform_ms']:.3f} ms (runs {[round(t, 3) for t in transforms]}); peak "
        f"{run['peak_gib']:.3f} GiB above the {held / 2**30:.2f} GiB held; launches {counts}; "
        f"{time.perf_counter() - t0:.2f} s")
    return run


def feature_specs(dev):
    """name -> a function that makes (stage, fit table, transform table,
    output columns, the Java class it saves as, the check of its run) at
    the stage's conf/ shape, on data born on the card from seeded
    generators (uniform [0, 1), as the conf/ generators make it) or, for the
    stream fits, host chunks from seeded numpy. They are made one at a time,
    so each stage's data is freed before the next is made."""
    from flink_ml_tpu_torch import StreamTable, Table, Vectors
    from flink_ml_tpu_torch.ops import quantile

    def uniform(rows, cols, seed=FEATURE_SEED):
        return torch.rand((rows, cols), generator=seeded(seed, dev), device=dev)

    def columns(X):
        return {f"f{j}": X[:, j].contiguous() for j in range(X.shape[1])}

    def binarizer():
        X = uniform(FEATURE_ROWS, 5)
        thresholds = [0.5, 0.3, 0.3, 0.6, 0.8]
        outs = [f"o{j}" for j in range(5)]
        stage = feature_module("binarizer").Binarizer().set_input_cols(*columns(X)) \
            .set_output_cols(*outs).set_thresholds(*thresholds)

        def verify(run):
            for j, thr in enumerate(thresholds):
                # against the threshold as a float32, as the stage casts it
                want = (X[:, j].double() > float(np.float32(thr))).float()
                check(torch.equal(run["out"].column(outs[j]), want), f"binarizer {outs[j]}")
            return {"exact": True}
        table = Table(columns(X))
        return stage, table, table, outs, FEATURE_JAVA + "binarizer.Binarizer", verify

    def bucketizer(handle, plant):
        def make():
            x = uniform(FEATURE_SMALL_ROWS, 1)[:, 0].contiguous()
            if plant:  # NaN, below and above the splits, and the splits themselves
                x[:1000] = float("nan")
                x[1000:2000] = -0.5
                x[2000:3000] = 1.5
                x[3000:3005] = torch.tensor([0.0, 0.25, 0.5, 0.75, 1.0], device=dev)
            splits = [0.0, 0.25, 0.5, 0.75, 1.0]
            stage = feature_module("bucketizer").Bucketizer().set_input_cols("f0") \
                .set_output_cols("o0").set_splits_array([splits]).set_handle_invalid(handle)

            def verify(run):
                x64 = x.double()
                s = torch.tensor(splits, dtype=torch.float64, device=dev)
                idx = (x64[:, None] >= s[None, :]).sum(dim=1) - 1
                idx = torch.where(x64 == s[-1], len(splits) - 2, idx)
                bad = (x64 < s[0]) | (x64 > s[-1]) | torch.isnan(x64)
                want = torch.where(bad, len(splits) - 1, idx) if handle == "keep" else idx[~bad]
                check(torch.equal(run["out"].column("o0"), want.float()), f"bucketizer {handle}")
                return {"exact": True, "invalid": int(bad.sum()), "rows_out": run["out"].num_rows}
            table = Table({"f0": x})
            return stage, table, table, ["o0"], FEATURE_JAVA + "bucketizer.Bucketizer", verify
        return make

    def dct():
        X = uniform(FEATURE_ROWS, DIM)
        stage = feature_module("dct").DCT().set_input_col("input").set_output_col("o")

        def verify(run):
            B = torch.as_tensor(feature_module("dct").dct_basis(DIM), device=dev)
            err = rel_err(run["out"].column("o"), X.double() @ B.T)
            check(err <= SUM_REL_TOL, f"dct relative error {err:.3e}")
            return {"rel_err": err, "tol": SUM_REL_TOL}
        table = Table({"input": X})
        return stage, table, table, ["o"], FEATURE_JAVA + "dct.DCT", verify

    def elementwiseproduct():
        X = uniform(FEATURE_ROWS, 5)
        scaling = [1.0, 2.0, 3.0, 4.0, 5.0]
        stage = feature_module("elementwiseproduct").ElementwiseProduct().set_input_col("features") \
            .set_output_col("o").set_scaling_vec(Vectors.dense(*scaling))

        def verify(run):
            want = X.double() * torch.tensor(scaling, dtype=torch.float64, device=dev)
            err = rel_err(run["out"].column("o"), want)
            check(err <= AFFINE_REL_TOL, f"elementwiseproduct relative error {err:.3e}")
            return {"rel_err": err, "tol": AFFINE_REL_TOL}
        table = Table({"features": X})
        return stage, table, table, ["o"], FEATURE_JAVA + "elementwiseproduct.ElementwiseProduct", verify

    def interaction():
        X = uniform(FEATURE_ROWS, 5)
        stage = feature_module("interaction").Interaction().set_input_cols(*columns(X)).set_output_col("o")

        def verify(run):
            err = rel_err(run["out"].column("o"), X.double().prod(dim=1, keepdim=True))
            check(err <= AFFINE_REL_TOL, f"interaction relative error {err:.3e}")
            return {"rel_err": err, "tol": AFFINE_REL_TOL}
        table = Table(columns(X))
        return stage, table, table, ["o"], FEATURE_JAVA + "interaction.Interaction", verify

    def kbins(strategy):
        def make():
            kb = feature_module("kbinsdiscretizer")
            X = uniform(FEATURE_ROWS, 10)
            stage = kb.KBinsDiscretizer().set_input_col("input").set_output_col("o") \
                .set_strategy(strategy).set_num_bins(5)

            def verify(run):
                edges = run["model"].bin_edges
                sub = stage.get_sub_samples()
                S = X if FEATURE_ROWS <= sub else \
                    X[kb.subsample_rows(FEATURE_ROWS, sub).to(dev)]
                out = {"exact": True}
                if strategy == "uniform":
                    lo_hi = torch.stack(torch.aminmax(S.double(), dim=0)).cpu().numpy()
                    want = [np.unique(np.linspace(lo_hi[0, j], lo_hi[1, j], 6)) for j in range(10)]
                    check(all(np.array_equal(a, b) for a, b in zip(edges, want)), "kbins uniform edges")
                elif strategy == "quantile":
                    qs = np.linspace(0.0, 1.0, 6)
                    q32, lo = jnp_quantile64(S, qs)
                    low = np.floor(np.float32(qs) * (np.float32(S.shape[0]) - np.float32(1)))
                    port_lo = quantile.sorted_rows(S, low.astype(np.int64))
                    check(torch.equal(port_lo.double(), lo), "kbins quantile order statistics")
                    want = q32.double().cpu().numpy()
                    check(all(np.array_equal(a, np.unique(want[:, j])) for j, a in enumerate(edges)),
                          "kbins quantile edges")
                else:  # the port's host Lloyd against a float64 one on the same rows
                    S64 = S.double().cpu().numpy()
                    want = [kb.kmeans_1d_edges(S64[:, j], 5) for j in range(10)]
                    sizes = all(a.size == b.size for a, b in zip(edges, want))
                    err = max(float(np.max(np.abs(a - b))) for a, b in zip(edges, want)) if sizes else 1.0
                    check(err <= KMEANS_EDGE_TOL, f"kbins kmeans edges {err:.3e} from a float64 Lloyd")
                    out = {"exact_bins": True, "edge_err": err, "tol": KMEANS_EDGE_TOL}
                check(torch.equal(run["out"].column("o").double(), bins64(X, edges)),
                      f"kbins {strategy} bins")
                return out
            table = Table({"input": X})
            return stage, table, table, ["o"], FEATURE_JAVA + "kbinsdiscretizer.KBinsDiscretizerModel", verify
        return make

    def maxabsscaler():
        X = uniform(FEATURE_ROWS, DIM) * 2 - 1
        stage = feature_module("maxabsscaler").MaxAbsScaler().set_input_col("features").set_output_col("o")

        def verify(run):
            m64 = X.double().abs().amax(dim=0)
            check(np.array_equal(run["model"].max_abs, m64.cpu().numpy()), "maxabsscaler max")
            err = rel_err(run["out"].column("o"), X.double() / m64)
            check(err <= AFFINE_REL_TOL, f"maxabsscaler relative error {err:.3e}")
            return {"exact_max": True, "rel_err": err, "tol": AFFINE_REL_TOL}
        table = Table({"features": X})
        return stage, table, table, ["o"], FEATURE_JAVA + "maxabsscaler.MaxAbsScalerModel", verify

    def minmaxscaler():
        X = uniform(FEATURE_SMALL_ROWS, DIM)
        stage = feature_module("minmaxscaler").MinMaxScaler().set_input_col("features") \
            .set_output_col("output")

        def verify(run):
            mn, mx = torch.aminmax(X.double(), dim=0)
            model = run["model"]
            check(np.array_equal(model.min_vector, mn.cpu().numpy())
                  and np.array_equal(model.max_vector, mx.cpu().numpy()), "minmaxscaler min and max")
            err = rel_err(run["out"].column("output"), (X.double() - mn) / (mx - mn))
            check(err <= AFFINE_REL_TOL, f"minmaxscaler relative error {err:.3e}")
            return {"exact_min_max": True, "rel_err": err, "tol": AFFINE_REL_TOL}
        table = Table({"features": X})
        return stage, table, table, ["output"], FEATURE_JAVA + "minmaxscaler.MinMaxScalerModel", verify

    def normalizer():
        X = uniform(FEATURE_ROWS, 5)
        stage = feature_module("normalizer").Normalizer().set_input_col("features") \
            .set_output_col("o").set_p(2.0)

        def verify(run):
            X64 = X.double()
            err = rel_err(run["out"].column("o"), X64 / X64.norm(dim=1, keepdim=True))
            check(err <= AFFINE_REL_TOL, f"normalizer relative error {err:.3e}")
            return {"rel_err": err, "tol": AFFINE_REL_TOL}
        table = Table({"features": X})
        return stage, table, table, ["o"], FEATURE_JAVA + "normalizer.Normalizer", verify

    def polynomialexpansion():
        X = uniform(FEATURE_ROWS, 5)
        stage = feature_module("polynomialexpansion").PolynomialExpansion().set_input_col("features") \
            .set_output_col("o").set_degree(2)

        def verify(run):
            X64 = X.double()
            exps = poly_exponents(5, 2)
            want = torch.stack([torch.prod(X64 ** torch.tensor(e, dtype=torch.float64, device=dev), dim=1)
                                for e in exps], dim=1)
            got = run["out"].column("o")
            check(tuple(got.shape) == (FEATURE_ROWS, 20), f"polynomialexpansion shape {tuple(got.shape)}")
            err = rel_err(got, want)
            check(err <= AFFINE_REL_TOL, f"polynomialexpansion relative error {err:.3e}")
            return {"rel_err": err, "tol": AFFINE_REL_TOL}
        table = Table({"features": X})
        return stage, table, table, ["o"], FEATURE_JAVA + "polynomialexpansion.PolynomialExpansion", verify

    def robustscaler():
        X = uniform(FEATURE_ROWS, DIM)
        stage = feature_module("robustscaler").RobustScaler().set_input_col("input").set_output_col("o") \
            .set_with_centering(True).set_with_scaling(True)

        def verify(run):
            q32, lo = jnp_quantile64(X, [0.5, 0.25, 0.75])
            n = FEATURE_ROWS
            low = np.floor(np.float32([0.5, 0.25, 0.75]) * (np.float32(n) - np.float32(1)))
            port_lo = quantile.sorted_rows(X, low.astype(np.int64))
            check(torch.equal(port_lo.double(), lo), "robustscaler order statistics")
            q = q32.double().cpu().numpy()
            model = run["model"]
            check(np.array_equal(model.medians, q[0]) and np.array_equal(model.ranges, q[2] - q[1]),
                  "robustscaler medians and ranges")
            med = torch.as_tensor(model.medians, device=dev)
            rng = torch.as_tensor(np.where(model.ranges > 0, model.ranges, 1.0), device=dev)
            err = rel_err(run["out"].column("o"), (X.double() - med) / rng)
            check(err <= AFFINE_REL_TOL, f"robustscaler relative error {err:.3e}")
            return {"exact_quantiles": True, "rel_err": err, "tol": AFFINE_REL_TOL}
        table = Table({"input": X})
        return stage, table, table, ["o"], FEATURE_JAVA + "robustscaler.RobustScalerModel", verify

    def imputer(strategy, with_nan):
        def make():
            names = [f"f{j}" for j in range(15)]
            outs = [f"o{j}" for j in range(15)]
            gen = seeded(FEATURE_SEED, dev)
            X = torch.randint(0, 100, (FEATURE_ROWS, 15), generator=gen, device=dev).float()
            if with_nan:
                X[torch.rand(X.shape, generator=gen, device=dev) < NAN_SHARE] = float("nan")
            stage = feature_module("imputer").Imputer().set_input_cols(*names) \
                .set_output_cols(*outs).set_strategy(strategy)

            def verify(run):
                got = np.array([run["model"].surrogates[c] for c in names])
                want = np.empty(15)
                for j in range(15):
                    x = X[:, j].double()
                    valid = x[~torch.isnan(x)]
                    k = valid.numel()
                    if strategy == "mean":
                        want[j] = float(valid.sum() / k)
                    elif strategy == "median":
                        lo = torch.kthvalue(valid, (k - 1) // 2 + 1).values
                        hi = torch.kthvalue(valid, k // 2 + 1).values
                        want[j] = float((lo + hi) / 2)
                    else:  # the smallest of the most frequent integers
                        want[j] = float(torch.argmax(torch.bincount(valid.long(), minlength=100)))
                if strategy == "mean":
                    err = float(np.max(np.abs(got - want) / np.abs(want)))
                    check(err <= SUM_REL_TOL, f"imputer mean relative error {err:.3e}")
                    result = {"rel_err": err, "tol": SUM_REL_TOL}
                else:
                    check(np.array_equal(got, want), f"imputer {strategy} surrogates {got} vs {want}")
                    result = {"exact": True}
                for j in range(15):
                    fill = torch.tensor(got[j], dtype=torch.float32, device=dev)
                    want_col = torch.where(torch.isnan(X[:, j]), fill, X[:, j])
                    check(torch.equal(run["out"].column(outs[j]), want_col), f"imputer {strategy} {outs[j]}")
                result["filled"] = int(torch.isnan(X).sum())
                return result
            table = Table(columns(X))
            return stage, table, table, outs, FEATURE_JAVA + "imputer.ImputerModel", verify
        return make

    def variancethresholdselector():
        X = uniform(FEATURE_ROWS, DIM)
        vts = feature_module("variancethresholdselector")
        stage = vts.VarianceThresholdSelector().set_input_col("input").set_output_col("o")

        def verify(run):
            X64 = X.double()
            var64 = ((X64 - X64.mean(dim=0)) ** 2).sum(dim=0) / (FEATURE_ROWS - 1)
            err = rel_err(vts.sample_variance(X), var64)
            check(err <= SUM_REL_TOL, f"variance relative error {err:.3e}")
            kept = torch.nonzero(var64 > stage.get_variance_threshold()).flatten().cpu().numpy()
            check(np.array_equal(run["model"].indices, kept), "variancethresholdselector indices")
            check(torch.equal(run["out"].column("o"), X[:, kept]), "variancethresholdselector output")
            return {"var_rel_err": err, "tol": SUM_REL_TOL, "kept": int(kept.size)}
        table = Table({"input": X})
        return (stage, table, table, ["o"],
                FEATURE_JAVA + "variancethresholdselector.VarianceThresholdSelectorModel", verify)

    def vectorslicer():
        X = uniform(FEATURE_ROWS, 10)
        stage = feature_module("vectorslicer").VectorSlicer().set_input_col("features") \
            .set_output_col("o").set_indices(1, 3, 5, 7)

        def verify(run):
            check(torch.equal(run["out"].column("o"), X[:, [1, 3, 5, 7]]), "vectorslicer")
            return {"exact": True}
        table = Table({"features": X})
        return stage, table, table, ["o"], FEATURE_JAVA + "vectorslicer.VectorSlicer", verify

    def vectorindexer(categorical):
        def make():
            X = uniform(FEATURE_ROWS, 10)
            Xt = X
            if categorical:  # three columns of 3, 7 and 20 integer categories
                gen = seeded(FEATURE_SEED + 1, dev)
                for j, k in enumerate((3, 7, 20)):
                    X[:, j] = torch.randint(0, k, (FEATURE_ROWS,), generator=gen, device=dev).float()
                Xt = X.clone()
                Xt[:1000, 1] = 50.0  # unseen: the rows go under skip
            stage = feature_module("vectorindexer").VectorIndexer().set_input_col("input") \
                .set_output_col("o").set_max_categories(20).set_handle_invalid("skip")

            def verify(run):
                counts = [torch.unique(X[:, j].double()).numel() for j in range(10)]
                want_cols = [j for j, c in enumerate(counts) if c <= 20]
                maps = run["model"].category_maps
                check(sorted(maps) == want_cols, f"vectorindexer categorical columns {sorted(maps)}")
                for j in want_cols:  # integer categories from 0: each maps to itself
                    check(maps[j] == {float(v): v for v in range(counts[j])}, f"vectorindexer map {j}")
                keep = ~(Xt[:, 1] == 50.0) if categorical else slice(None)
                check(torch.equal(run["out"].column("o"), Xt[keep]), "vectorindexer output")
                return {"exact": True, "categorical": want_cols, "rows_out": run["out"].num_rows}
            return (stage, Table({"input": X}), Table({"input": Xt}), ["o"],
                    FEATURE_JAVA + "vectorindexer.VectorIndexerModel", verify)
        return make

    def stream_data(integers):
        """1M x 10 host rows from seeded numpy, in chunks: uniform [0, 1), or
        integers in [0, 100) with NAN_SHARE of them NaN."""
        rng = np.random.default_rng(FEATURE_STREAM_SEED)
        if integers:
            X = rng.integers(0, 100, (FEATURE_STREAM_ROWS, 10)).astype(np.float64)
            X[rng.random(X.shape) < NAN_SHARE] = np.nan
        else:
            X = rng.random((FEATURE_STREAM_ROWS, 10))
        return X, [X[i:i + FEATURE_STREAM_CHUNK] for i in range(0, FEATURE_STREAM_ROWS, FEATURE_STREAM_CHUNK)]

    def stream_robustscaler():
        X, chunks = stream_data(False)
        stream = StreamTable.from_batches([Table({"input": c}) for c in chunks])
        stage = feature_module("robustscaler").RobustScaler().set_input_col("input").set_output_col("o") \
            .set_with_centering(True)
        Xd = torch.from_numpy(X).float().to(dev)

        def verify(run):
            model, eps = run["model"], stage.get_relative_error()
            med, lo, hi = stage._fit_stream(stream)
            check(np.array_equal(med, model.medians) and np.array_equal(hi - lo, model.ranges),
                  "stream robustscaler refit")
            for j in range(10):
                col = np.sort(X[:, j])
                for p, v in ((0.5, med[j]), (0.25, lo[j]), (0.75, hi[j])):
                    check(rank_window(col, v, p, eps), f"stream robustscaler {p} of column {j}")
            want = (Xd.double() - torch.as_tensor(med, device=dev)) / torch.as_tensor(hi - lo, device=dev)
            err = rel_err(run["out"].column("o"), want)
            check(err <= AFFINE_REL_TOL, f"stream robustscaler relative error {err:.3e}")
            return {"rank_error_within": eps, "rel_err": err, "tol": AFFINE_REL_TOL}
        return (stage, stream, Table({"input": Xd}), ["o"],
                FEATURE_JAVA + "robustscaler.RobustScalerModel", verify)

    def stream_kbins():
        kb = feature_module("kbinsdiscretizer")
        X, chunks = stream_data(False)
        stream = StreamTable.from_batches([Table({"input": c}) for c in chunks])
        stage = kb.KBinsDiscretizer().set_input_col("input").set_output_col("o") \
            .set_strategy("quantile").set_num_bins(5)
        Xd = torch.from_numpy(X).float().to(dev)

        def verify(run):
            edges, qs = run["model"].bin_edges, np.linspace(0.0, 1.0, 6)
            for j, e in enumerate(edges):
                col = np.sort(X[:, j])
                check(e.size == 6 and all(rank_window(col, v, p, kb.STREAM_RELATIVE_ERROR)
                                          for p, v in zip(qs, e)), f"stream kbins edges of column {j}")
            check(torch.equal(run["out"].column("o").double(), bins64(Xd, edges)), "stream kbins bins")
            return {"rank_error_within": kb.STREAM_RELATIVE_ERROR, "exact_bins": True}
        return (stage, stream, Table({"input": Xd}), ["o"],
                FEATURE_JAVA + "kbinsdiscretizer.KBinsDiscretizerModel", verify)

    def stream_imputer():
        X, chunks = stream_data(True)
        names, outs = [f"f{j}" for j in range(10)], [f"o{j}" for j in range(10)]
        stream = StreamTable.from_batches([Table({n: c[:, j] for j, n in enumerate(names)}) for c in chunks])
        stage = feature_module("imputer").Imputer().set_input_cols(*names).set_output_cols(*outs) \
            .set_strategy("median")
        Xd = torch.from_numpy(X).float().to(dev)

        def verify(run):
            eps = stage.get_relative_error()
            for j, name in enumerate(names):
                col = np.sort(X[:, j][~np.isnan(X[:, j])])
                v = run["model"].surrogates[name]
                check(rank_window(col, v, 0.5, eps), f"stream imputer median of {name}")
                fill = torch.tensor(v, dtype=torch.float32, device=dev)
                check(torch.equal(run["out"].column(outs[j]), torch.where(torch.isnan(Xd[:, j]), fill,
                                                                          Xd[:, j])), f"stream imputer {name}")
            return {"rank_error_within": eps, "exact_fill": True}
        return (stage, stream, Table({n: Xd[:, j].contiguous() for j, n in enumerate(names)}), outs,
                FEATURE_JAVA + "imputer.ImputerModel", verify)

    return {
        "binarizer": binarizer,
        "bucketizer": bucketizer("keep", False),
        "bucketizer invalid keep": bucketizer("keep", True),
        "bucketizer invalid skip": bucketizer("skip", True),
        "dct": dct,
        "elementwiseproduct": elementwiseproduct,
        "interaction": interaction,
        "kbinsdiscretizer": kbins("uniform"),
        "kbinsdiscretizer quantile": kbins("quantile"),
        "kbinsdiscretizer kmeans": kbins("kmeans"),
        "maxabsscaler": maxabsscaler,
        "minmaxscaler": minmaxscaler,
        "normalizer": normalizer,
        "polynomialexpansion": polynomialexpansion,
        "robustscaler": robustscaler,
        "imputer": imputer("mean", False),
        "imputer median": imputer("median", True),
        "imputer most_frequent": imputer("most_frequent", True),
        "variancethresholdselector": variancethresholdselector,
        "vectorslicer": vectorslicer,
        "vectorindexer": vectorindexer(False),
        "vectorindexer categorical": vectorindexer(True),
        "stream robustscaler": stream_robustscaler,
        "stream kbinsdiscretizer quantile": stream_kbins,
        "stream imputer median": stream_imputer,
    }


#: the feature paths given a torch.profiler pass, and the call profiled
FEATURE_PROFILES = {"dct": "transform", "polynomialexpansion": "transform",
                    "kbinsdiscretizer": "fit", "robustscaler": "fit", "imputer median": "fit",
                    "imputer most_frequent": "fit", "stream robustscaler": "fit"}


def feature_phase(sk, dev, tmp):
    """Phase 6: every numeric feature stage at its conf/ shape, one path
    each (drive_feature), then its checks against a float64 replay; a
    profiler pass over one more call of the paths in FEATURE_PROFILES."""
    results = {}
    for name, make in feature_specs(dev).items():
        t0 = time.perf_counter()
        stage, fit_table, table, out_cols, java, verify = make()
        run = drive_feature(sk, name, stage, fit_table, table, tmp, out_cols, java)
        checks = verify(run)
        if name in FEATURE_PROFILES:
            call = FEATURE_PROFILES[name]
            profile_run(f"{name} {call}", (lambda: stage.fit(fit_table)) if call == "fit"
                        else (lambda: run["model"].transform(table)[0]))
        seconds = time.perf_counter() - t0
        log(f"    {name} checks: {checks}; {seconds:.2f} s")
        results[name] = {k: run[k] for k in ("fit_ms", "transform_ms", "warm_fit_ms", "warm_transform_ms",
                                              "fit_runs", "transform_runs", "peak_gib", "high_water_gib",
                                              "launches")}
        results[name].update(checks=checks, seconds=seconds)
        del stage, fit_table, table, verify, run
    return results


# -- 7. the string and token stages and the text path --------------------------------

#: the text path: a DictTokenMatrix of the shape of conf/stopwordsremover-
#: benchmark.json (1M x 100) over the vocabulary size of conf/hashingtf-
#: benchmark.json (1,000 terms), the first TEXT_STOPS of them English stop
#: words; HashingTF at its default 2^18 features; the conf/ LR params
TEXT_ROWS, TEXT_TOKENS, TEXT_TERMS, TEXT_STOPS = 1_000_000, 100, 1_000, 100
TEXT_SEED, TEXT_WEIGHT_SEED = 29, 31
TEXT_ACCURACY = 0.7
TEXT_REPEATS = 3
TEXT_LAUNCHES = launch_dict(sparse_row_dots=MAX_ITER + 2, sparse_grad=MAX_ITER)
TEXT_JAVA = "org.apache.flink.ml.builder.PipelineModel"
#: the nine stages at their conf/ shapes (rows, tokens a row, distinct values)
CV_SHAPE = (10_000_000, 100, 100)  # countvectorizer, seed 2
NGRAM_SHAPE = (10_000_000, 10, 10)  # ngram (numDistinctValues defaults to 10), n 2
SWR_SHAPE = (1_000_000, 100, 100)  # stopwordsremover
HTF_SHAPE = (100_000, 20, 1_000)  # hashingtf
IDF_SHAPE = (10_000_000, 10)  # idf, dense, minDocFreq 0
HASHER_ROWS, HASHER_FEATURES = 10_000_000, 1000  # featurehasher: f0-f4, f0-f2 categorical
REGEX_ROWS, REGEX_DISTINCT = 10_000_000, 100  # regextokenizer, pattern 1+
TOKENIZER_ROWS, TOKENIZER_DISTINCT = 100_000, 100
INDEXER_ROWS, INDEXER_DISTINCT = 1_000_000, 1_000  # stringindexer, frequencyDesc
CONF_SEED = 2
#: host replays of the host stages (FeatureHasher, RegexTokenizer) check the
#: first rows only: a Python loop over 10M rows would take minutes
HOST_REPLAY_ROWS = 200_000
_BIG = 2**31 - 1


def string_vocab(m):
    """The conf/ generators' vocabulary: decimal strings at their minimal
    unicode width."""
    return np.arange(m).astype(str).astype(f"<U{len(str(max(m - 1, 1)))}")


def term_runs_replay(mapped, width):
    """numpy replay of a padded-CSR term count: each row's distinct
    non-negative terms ascending with their counts as float32, -1 and 0
    padding, `width` slots."""
    n, k = mapped.shape
    S = np.sort(np.where(mapped >= 0, mapped, _BIG), axis=1).ravel()
    starts = np.flatnonzero(np.concatenate([[True], S[1:] != S[:-1]]) |
                            (np.arange(n * k) % k == 0))
    counts = np.diff(np.append(starts, n * k))
    rows, terms = starts // k, S[starts]
    keep = terms != _BIG
    rows, terms, counts = rows[keep], terms[keep], counts[keep]
    slot = np.arange(rows.size) - np.searchsorted(rows, rows, side="left")
    indices = np.full((n, width), -1, np.int32)
    values = np.zeros((n, width), np.float32)
    indices[rows, slot] = terms
    values[rows, slot] = counts
    return indices, values


def filter_replay(ids, keep_vocab):
    """numpy replay of StopWordsRemover on ids: kept ids left in order, -1 right."""
    keep = (ids >= 0) & keep_vocab[np.maximum(ids, 0)]
    order = np.argsort(~keep, axis=1, kind="stable")
    return np.take_along_axis(np.where(keep, ids, -1), order, axis=1)


def text_corpus(rows, dev):
    """The text path's table: ids from a seeded generator on the card over
    TEXT_TERMS terms (the first TEXT_STOPS English stop words), and labels
    planted on the other terms: 1 when a row's sum of seeded term weights
    is above the median."""
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.models.feature._stopwords import STOP_WORDS
    from flink_ml_tpu_torch.ops import tokens
    from flink_ml_tpu_torch.table import DictTokenMatrix

    vocab = np.asarray(list(STOP_WORDS["english"][:TEXT_STOPS])
                       + [f"term{i}" for i in range(TEXT_TERMS - TEXT_STOPS)])
    ids = tokens.random_token_ids(TEXT_SEED, rows, TEXT_TOKENS, TEXT_TERMS, dev)
    weight = torch.randn(TEXT_TERMS, generator=seeded(TEXT_WEIGHT_SEED, dev), device=dev)
    weight[:TEXT_STOPS] = 0.0
    score = weight[ids.long()].sum(dim=1)
    label = (score > score.median()).to(torch.float32)
    return Table({"tokens": DictTokenMatrix(vocab, ids), "label": label})


def text_pipeline():
    from flink_ml_tpu_torch import Pipeline
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression

    f = feature_module
    return Pipeline([
        f("stopwordsremover").StopWordsRemover().set_input_cols("tokens").set_output_cols("words"),
        f("hashingtf").HashingTF().set_input_col("words").set_output_col("tf"),
        f("idf").IDF().set_input_col("tf").set_output_col("features"),
        estimator(LogisticRegression),
    ])


def text_features(model, table):
    """The tables after each stage of a fitted text PipelineModel but the LR."""
    out = {}
    for stage, col in zip(model.stages[:3], ("words", "tf", "features")):
        table = stage.transform(table)[0]
        out[col] = table.column(col)
    return out


def text_fit_batch(dev):
    """The text path's fit batch (BATCH rows of its features, d = 2^18),
    for phase 2: StopWordsRemover -> HashingTF -> IDF on the first BATCH
    rows of its corpus."""
    remover, hashing_tf, idf, _ = text_pipeline().stages
    tf = hashing_tf.transform(remover.transform(text_corpus(BATCH, dev))[0])[0]
    feats = idf.fit(tf).transform(tf)[0].column("features")
    return feats.indices, feats.values, feats.size


def text_path(sk, dev, tmp):
    """The text path, fit -> transform -> save -> load -> transform with
    the launch counts reset before and read after; its gates; warm times
    and a profiler pass over one fit."""
    from flink_ml_tpu_torch.models.feature.hashingtf import bucket_lut

    t0 = time.perf_counter()
    table = text_corpus(TEXT_ROWS, dev)
    torch.cuda.synchronize()
    log(f"  text corpus on the card: {TEXT_ROWS} x {TEXT_TOKENS} ids over {TEXT_TERMS} terms in "
        f"{time.perf_counter() - t0:.2f} s")
    fit = lambda: text_pipeline().fit(table)  # noqa: E731
    sk.reset_launch_counts()
    run = drive(fit, table, tmp, "text")
    counts = sk.launch_counts()
    log(f"  text path: fit {run['fit_ms']:.1f} ms, transform {run['transform_ms']:.1f} ms (first "
        f"calls); launches {counts}")
    check(counts == TEXT_LAUNCHES, f"text path launched {counts}, expected {TEXT_LAUNCHES}")
    check_reload("text", run, TEXT_JAVA, ("prediction", "rawPrediction"))
    model = run["model"]
    feats = text_features(model, table)
    tokens = table.column("tokens")
    ids = tokens.ids.cpu().numpy()
    keep_vocab = ~np.isin(tokens.vocab, [w.lower() for w in model.stages[0].get_stop_words()])
    words = filter_replay(ids, keep_vocab)
    check(np.array_equal(feats["words"].ids.cpu().numpy(), words),
          "text StopWordsRemover differs from its numpy replay")
    dropped = int((ids >= 0).sum() - (words >= 0).sum())
    check(dropped > 0, "the text path's StopWordsRemover dropped nothing")
    tf = feats["tf"]
    lut = bucket_lut(tokens.vocab, tf.size)
    want_i, want_v = term_runs_replay(np.where(words >= 0, lut[np.maximum(words, 0)], -1),
                                      tf.indices.shape[1])
    check(tf.indices.shape == (TEXT_ROWS, TEXT_TOKENS) and tf.size == 1 << 18,
          f"text HashingTF shape {tuple(tf.indices.shape)}, size {tf.size}")
    check(np.array_equal(tf.indices.cpu().numpy(), want_i)
          and np.array_equal(tf.values.cpu().numpy(), want_v),
          "text HashingTF differs from its numpy replay")
    idf_model = model.stages[2]
    present = want_i[(want_i >= 0) & (want_v != 0)]
    df = np.bincount(present, minlength=tf.size).astype(np.float64)
    idf64 = np.log((TEXT_ROWS + 1.0) / (df + 1.0))
    check(np.array_equal(idf_model.doc_freq, df) and np.array_equal(idf_model.idf, idf64),
          "text IDF model differs from its numpy replay")
    idf32 = torch.as_tensor(idf64.astype(np.float32), device=dev)
    f = feats["features"]
    want = torch.where(tf.indices >= 0, tf.values * idf32[tf.indices.clamp(min=0).long()], 0.0)
    check(torch.equal(f.indices, tf.indices) and torch.equal(f.values, want),
          "text IDF values differ from float32(v) * float32(idf)")
    label = table.column("label")
    check_sparse_linear("lr", {"model": model.stages[-1], "out": run["out"]}, f.indices, f.values,
                        label, dim=f.size)
    accuracy = float((run["out"].column("prediction") == label).float().mean())
    log(f"  text path: {dropped} stop words dropped; HashingTF and StopWordsRemover equal their "
        f"numpy replays, IDF its float32 product; accuracy {accuracy:.4f}")
    check(accuracy > TEXT_ACCURACY, f"text path accuracy {accuracy} <= {TEXT_ACCURACY}")
    fits = [synced(fit)[1] for _ in range(TEXT_REPEATS)]
    transforms = [synced(lambda: model.transform(table)[0])[1] for _ in range(TEXT_REPEATS)]
    log(f"  text path warm: fit median {float(np.median(fits)):.3f} ms (runs "
        f"{[round(t, 3) for t in fits]}), transform median {float(np.median(transforms)):.3f} ms "
        f"(runs {[round(t, 3) for t in transforms]})")
    profile_run("text fit", fit)
    profile_run("text transform", lambda: model.transform(table)[0])
    return {"fit_ms": run["fit_ms"], "transform_ms": run["transform_ms"],
            "warm_fit_ms": float(np.median(fits)), "warm_transform_ms": float(np.median(transforms)),
            "fit_runs": fits, "transform_runs": transforms, "launches": counts,
            "accuracy": accuracy, "dropped_tokens": dropped,
            "seconds": time.perf_counter() - t0}


def text_specs(dev):
    """name -> a function that makes (stage, fit table, transform table,
    output columns, the Java class it saves as, the check of its run) for
    each of the nine stages at its conf/ shape: token matrices born on the
    card, string and number columns made by seeded numpy on the host."""
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.ops import tokens
    from flink_ml_tpu_torch.table import DictTokenMatrix

    def token_table(shape, seed=CONF_SEED):
        rows, k, m = shape
        return Table({"input": DictTokenMatrix(string_vocab(m),
                                               tokens.random_token_ids(seed, rows, k, m, dev))})

    def countvectorizer():
        table = token_table(CV_SHAPE)
        ids = table.column("input").ids
        vocab = table.column("input").vocab
        stage = feature_module("countvectorizer").CountVectorizer().set_input_col("input") \
            .set_output_col("output")

        def verify(run):
            m = vocab.size
            tf = torch.bincount(ids.reshape(-1).long(), minlength=m)
            df = torch.zeros(m, dtype=torch.int64, device=dev)
            for s in range(0, ids.shape[0], 1_000_000):
                seen = torch.zeros((min(1_000_000, ids.shape[0] - s), m), dtype=torch.bool, device=dev)
                seen.scatter_(1, ids[s:s + 1_000_000].long(), True)
                df += seen.sum(dim=0)
            tf, df = tf.cpu().numpy(), df.cpu().numpy()
            order = np.lexsort((vocab, -tf))
            want_vocab = [str(vocab[i]) for i in order if df[i] > 0]
            check(run["model"].vocabulary == want_vocab, "countvectorizer vocabulary")
            out = run["out"].column("output")
            lut = torch.as_tensor(np.argsort(order).astype(np.int64), device=dev)
            check(out.indices.shape == (CV_SHAPE[0], min(CV_SHAPE[1], m)), "countvectorizer width")
            for s in range(0, ids.shape[0], 1_000_000):
                e = min(ids.shape[0], s + 1_000_000)
                want = torch.zeros((e - s, m), dtype=torch.float32, device=dev)
                want.scatter_add_(1, lut[ids[s:e].long()], torch.ones((e - s, ids.shape[1]), device=dev))
                idx, val = out.indices[s:e], out.values[s:e]
                got = torch.zeros((e - s, m + 1), dtype=torch.float32, device=dev)
                got.scatter_(1, torch.where(idx >= 0, idx, m).long(), val)
                check(torch.equal(got[:, :m], want), f"countvectorizer counts, rows {s}-{e}")
                nnz = (idx >= 0).sum(dim=1)
                check(torch.equal(nnz, (want > 0).sum(dim=1))
                      and bool((idx[:, 1:] > idx[:, :-1]).logical_or(idx[:, 1:] < 0).all()),
                      f"countvectorizer layout, rows {s}-{e}")
            return {"exact": True, "vocabulary": len(want_vocab)}
        return stage, table, table, ("output",), FEATURE_JAVA + "countvectorizer.CountVectorizerModel", \
            verify

    def ngram():
        table = token_table(NGRAM_SHAPE)
        ids = table.column("input").ids
        vocab = table.column("input").vocab
        stage = feature_module("ngram").NGram().set_input_col("input").set_output_col("output")

        def verify(run):
            out = run["out"].column("output")
            m = vocab.size
            check(torch.equal(out.ids, ids[:, :-1] * m + ids[:, 1:]), "ngram codes")
            want = [f"{a} {b}" for a in vocab for b in vocab]
            check(out.vocab.tolist() == want, "ngram vocabulary")
            return {"exact": True, "vocabulary": len(want)}
        return stage, table, table, ("output",), FEATURE_JAVA + "ngram.NGram", verify

    def stopwordsremover():
        table = token_table(SWR_SHAPE)
        ids = table.column("input").ids
        stage = feature_module("stopwordsremover").StopWordsRemover().set_input_cols("input") \
            .set_output_cols("output")

        def verify(run):
            # no decimal term is an English stop word: the ids come back as they are
            check(run["out"].column("output").ids is ids, "stopwordsremover copied its ids")
            return {"exact": True, "dropped": 0}
        return stage, table, table, ("output",), FEATURE_JAVA + "stopwordsremover.StopWordsRemover", \
            verify

    def hashingtf():
        from flink_ml_tpu_torch.models.feature.hashingtf import bucket_lut

        table = token_table(HTF_SHAPE)
        col = table.column("input")
        stage = feature_module("hashingtf").HashingTF().set_input_col("input").set_output_col("output")

        def verify(run):
            out = run["out"].column("output")
            lut = bucket_lut(col.vocab, out.size)
            want_i, want_v = term_runs_replay(lut[col.ids.cpu().numpy()], HTF_SHAPE[1])
            check(np.array_equal(out.indices.cpu().numpy(), want_i)
                  and np.array_equal(out.values.cpu().numpy(), want_v), "hashingtf replay")
            return {"exact": True}
        return stage, table, table, ("output",), FEATURE_JAVA + "hashingtf.HashingTF", verify

    def idf():
        rows, d = IDF_SHAPE
        X = torch.rand((rows, d), generator=seeded(CONF_SEED, dev), device=dev)
        table = Table({"input": X})
        stage = feature_module("idf").IDF().set_input_col("input").set_output_col("output") \
            .set_min_doc_freq(0)

        def verify(run):
            df = (X != 0).sum(dim=0).double().cpu().numpy()
            idf64 = np.log((rows + 1.0) / (df + 1.0))
            model = run["model"]
            check(np.array_equal(model.doc_freq, df) and np.array_equal(model.idf, idf64),
                  "idf model")
            want = (X.double() * torch.as_tensor(idf64.astype(np.float32), device=dev).double()).float()
            check(torch.equal(run["out"].column("output"), want), "idf transform")
            return {"exact": True}
        return stage, table, table, ("output",), FEATURE_JAVA + "idf.IDFModel", verify

    def featurehasher():
        from flink_ml_tpu_torch.models.feature.featurehasher import _hash_index
        from flink_ml_tpu_torch.models.feature.stringindexer import _java_double_to_string

        rng = np.random.default_rng(CONF_SEED)
        names = [f"f{j}" for j in range(5)]
        cols = {name: rng.random(HASHER_ROWS) for name in names}
        table = Table(cols)
        stage = feature_module("featurehasher").FeatureHasher().set_input_cols(*names) \
            .set_categorical_cols("f0", "f1", "f2").set_num_features(HASHER_FEATURES) \
            .set_output_col("output")

        def verify(run):
            out = run["out"].column("output")
            check(out.indices.shape == (HASHER_ROWS, 5), "featurehasher width")
            idx, val = out.indices[:HOST_REPLAY_ROWS], out.values[:HOST_REPLAY_ROWS]
            for r in range(HOST_REPLAY_ROWS):
                feats = {}
                for name in ("f3", "f4"):
                    b = _hash_index(name, HASHER_FEATURES)
                    feats[b] = feats.get(b, 0.0) + float(cols[name][r])
                for name in ("f0", "f1", "f2"):
                    b = _hash_index(f"{name}={_java_double_to_string(float(cols[name][r]))}",
                                    HASHER_FEATURES)
                    feats[b] = feats.get(b, 0.0) + 1.0
                keys = sorted(feats)
                n = len(keys)
                if (idx[r, :n].tolist() != keys or (idx[r, n:] != -1).any()
                        or val[r, :n].tolist() != [feats[k] for k in keys]):
                    check(False, f"featurehasher row {r} differs from its replay")
            return {"exact": True, "replayed_rows": HOST_REPLAY_ROWS}
        return stage, table, table, ("output",), FEATURE_JAVA + "featurehasher.FeatureHasher", verify

    def strings(rows, distinct, seed=CONF_SEED):
        vocab = string_vocab(distinct)
        return vocab[np.random.default_rng(seed).integers(0, distinct, rows)]

    def regextokenizer():
        import re

        S = strings(REGEX_ROWS, REGEX_DISTINCT)
        table = Table({"input": S})
        stage = feature_module("regextokenizer").RegexTokenizer().set_input_col("input") \
            .set_output_col("output").set_pattern("1+")

        def verify(run):
            out = run["out"].column("output")
            check(len(out) == REGEX_ROWS, "regextokenizer rows")
            for r in range(HOST_REPLAY_ROWS):
                want = [t for t in re.split("1+", str(S[r]).lower()) if len(t) >= 1]
                check(list(out[r]) == want, f"regextokenizer row {r}")
            return {"exact": True, "replayed_rows": HOST_REPLAY_ROWS}
        return stage, table, table, ("output",), FEATURE_JAVA + "regextokenizer.RegexTokenizer", \
            verify

    def tokenizer():
        S = strings(TOKENIZER_ROWS, TOKENIZER_DISTINCT)
        table = Table({"input": S})
        stage = feature_module("tokenizer").Tokenizer().set_input_col("input").set_output_col("output")

        def verify(run):
            out = run["out"].column("output")
            check([list(t) for t in out] == [str(s).lower().split(" ") for s in S], "tokenizer")
            return {"exact": True, "replayed_rows": TOKENIZER_ROWS}
        return stage, table, table, ("output",), FEATURE_JAVA + "tokenizer.Tokenizer", verify

    def stringindexer():
        S = strings(INDEXER_ROWS, INDEXER_DISTINCT)
        table = Table({"input": S})
        stage = feature_module("stringindexer").StringIndexer().set_input_cols("input") \
            .set_output_cols("output").set_string_order_type("frequencyDesc")

        def verify(run):
            uniq, inv, cnt = np.unique(S, return_inverse=True, return_counts=True)
            order = sorted(range(uniq.size), key=lambda i: (-cnt[i], str(uniq[i])))
            check(run["model"].string_arrays == [[str(uniq[i]) for i in order]],
                  "stringindexer order")
            rank = np.empty(uniq.size, np.float64)
            rank[order] = np.arange(uniq.size)
            check(np.array_equal(run["out"].column("output"), rank[inv.reshape(-1)]),
                  "stringindexer transform")
            return {"exact": True}
        return stage, table, table, ("output",), FEATURE_JAVA + "stringindexer.StringIndexerModel", \
            verify

    return {
        "countvectorizer": countvectorizer,
        "featurehasher": featurehasher,
        "hashingtf": hashingtf,
        "idf": idf,
        "ngram": ngram,
        "regextokenizer": regextokenizer,
        "stopwordsremover": stopwordsremover,
        "stringindexer": stringindexer,
        "tokenizer": tokenizer,
    }


#: the text stages given a torch.profiler pass, and the call profiled
TEXT_PROFILES = {"countvectorizer": "fit", "ngram": "transform", "hashingtf": "transform"}


def text_phase(sk, dev, tmp):
    """Phase 7: the text path (text_path), then each of the nine string and
    token stages at its conf/ shape (drive_feature, then its replay)."""
    results = {"text path": text_path(sk, dev, tmp)}
    torch.cuda.empty_cache()
    for name, make in text_specs(dev).items():
        t0 = time.perf_counter()
        stage, fit_table, table, out_cols, java, verify = make()
        run = drive_feature(sk, name, stage, fit_table, table, tmp, out_cols, java)
        checks = verify(run)
        if name in TEXT_PROFILES:
            call = TEXT_PROFILES[name]
            profile_run(f"{name} {call}", (lambda: stage.fit(fit_table)) if call == "fit"
                        else (lambda: run["model"].transform(table)[0]))
        seconds = time.perf_counter() - t0
        log(f"    {name} checks: {checks}; {seconds:.2f} s")
        results[name] = {k: run[k] for k in ("fit_ms", "transform_ms", "warm_fit_ms", "warm_transform_ms",
                                              "fit_runs", "transform_runs", "peak_gib", "high_water_gib",
                                              "launches")}
        results[name].update(checks=checks, seconds=seconds)
        del stage, fit_table, table, verify, run
        torch.cuda.empty_cache()
    return results


# -- 8. the statistics slice and the evaluation path --------------------------------

#: the evaluation path: the text path's table split by RandomSplitter, the
#: text pipeline fitted on the first part, the second part scored
EVAL_WEIGHTS, EVAL_SEED = (0.8, 0.2), 37
EVAL_METRICS = ("areaUnderROC", "areaUnderPR", "ks", "areaUnderLorenz")
EVAL_AUC = 0.9
#: the evaluator's metrics against the float64 numpy oracle (its sums are
#: float64 on the card, ROADMAP C.11)
METRIC_TOL = 1e-9
EVAL_REPEATS = 3
#: the new stages at their conf/ shapes
NB_SHAPE = (1_000_000, 10, 5, 2)  # naivebayes: rows, vectorDim, featureArity, labelArity
UFS_SHAPE = (10_000_000, 100, 10)  # univariatefeatureselector: rows, vectorDim, labelArity
KNN_SHAPE = (20_000, 50, 2, 5)  # knn: rows, vectorDim, labelArity, k (its default)
#: the three stats stages and RandomSplitter have no conf/ file: 1M rows
STATS_SHAPE = (1_000_000, 10)
CHISQ_ARITY, CHISQ_LABELS, ANOVA_LABELS = 5, 2, 10
SPLIT_ROWS = 1_000_000
#: a statistic against its float64 replay, each relative to itself; a
#: p-value as max |error| over the largest replayed p-value (a p-value
#: far below 1 moves by exp(-F/2) and is not held relative to itself)
STAT_REL_TOL = 1e-6
#: UnivariateFeatureSelector: its float32 F-statistics against the float64
#: replay, and the p-value margin around the cut inside which a swap of
#: two features is rounding, not a fault
UFS_F_TOL, UFS_CUT_MARGIN = 1e-4, 1e-6
STATS_JAVA = "org.apache.flink.ml.stats."
#: the stages of phase 8 given a torch.profiler pass, and the call profiled
STATS_PROFILES = {"univariatefeatureselector": "fit"}


def host_counts():
    """The host paths the JAX package itself takes, counted where the port
    takes them (NaiveBayes' conditions and gap rescore, the chi-square
    test)."""
    from collections import Counter

    from flink_ml_tpu_torch.models.classification import naivebayes
    from flink_ml_tpu_torch.ops import stats

    return Counter(naivebayes.HOST_COUNTS) + Counter(stats.HOST_COUNTS)


def counts_since(before):
    after = host_counts()
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def split_replay(rows, weights, seed):
    """numpy replay of RandomSplitter's draw: each part's row indices."""
    fractions = np.cumsum(weights) / np.sum(weights)
    draws = np.random.RandomState(seed % 2**32).random_sample(rows)
    lower = 0.0
    parts = []
    for upper in fractions:
        parts.append(np.nonzero((draws >= lower) & (draws < upper))[0])
        lower = upper
    return parts


def eval_path(sk, dev, tmp):
    """Phase 8's main path: RandomSplitter -> the text pipeline fitted on
    the train part -> transform of the test part ->
    BinaryClassificationEvaluator -> save -> load -> transform -> evaluate,
    with the launch counts reset before and read after; its gates, warm
    times and a profiler pass."""
    from flink_ml_tpu_torch import PipelineModel, Table
    from flink_ml_tpu_torch.models.evaluation.binaryclassification import (
        BinaryClassificationEvaluator, binary_metrics)
    from flink_ml_tpu_torch.models.feature.randomsplitter import RandomSplitter

    t0 = time.perf_counter()
    table = text_corpus(TEXT_ROWS, dev)
    splitter = RandomSplitter().set_weights(*EVAL_WEIGHTS).set_seed(EVAL_SEED)
    evaluator = BinaryClassificationEvaluator().set_metrics_names(*EVAL_METRICS)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    (train, test), split_ms = synced(lambda: splitter.transform(table))
    model, fit_ms = synced(lambda: text_pipeline().fit(train))
    out, transform_ms = synced(lambda: model.transform(test)[0])
    metrics, evaluate_ms = synced(lambda: evaluator.transform(out)[0].collect()[0])
    path = os.path.join(tmp, "eval")
    model.save(path)
    loaded = PipelineModel.load(path)
    again = loaded.transform(test)[0]
    metrics_again = evaluator.transform(again)[0].collect()[0]
    torch.cuda.synchronize()
    counts = sk.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    log(f"  eval path: split {split_ms:.1f} ms ({train.num_rows} / {test.num_rows} rows), fit "
        f"{fit_ms:.1f} ms, transform {transform_ms:.1f} ms, evaluate {evaluate_ms:.1f} ms (first "
        f"calls); launches {counts}; peak {peak:.3f} GiB above the {held / 2**30:.2f} GiB held")
    check(counts == TEXT_LAUNCHES, f"eval path launched {counts}, expected {TEXT_LAUNCHES} (20 "
          f"epochs of the fit on the train part, a row dot a transform of the test part)")
    for col in ("prediction", "rawPrediction"):
        check(same_column(again.column(col), out.column(col)), f"eval path {col} differs after save/load")
    metrics = {k: float(v) for k, v in metrics.items()}
    check({k: float(v) for k, v in metrics_again.items()} == metrics,
          "eval path metrics differ after save/load")
    # the split, row for row, against the numpy replay of the draw
    ids, label = table.column("tokens").ids, table.column("label")
    for name, part, rows in zip(("train", "test"), (train, test),
                                split_replay(TEXT_ROWS, EVAL_WEIGHTS, EVAL_SEED)):
        sel = torch.as_tensor(rows, device=dev)
        check(part.num_rows == rows.size and torch.equal(part.column("tokens").ids, ids[sel])
              and torch.equal(part.column("label"), label[sel]),
              f"eval path {name} split differs from the numpy replay")
    # the fit on the train part against the same fit on the plain loss
    feats = text_features(model, train)["features"]
    lr = model.stages[-1]
    train_out = lr.transform(Table({"features": feats}))[0]
    check_sparse_linear("lr", {"model": lr, "out": train_out}, feats.indices, feats.values,
                        train.column("label"), dim=feats.size)
    # the metrics against the float64 numpy oracle on the same scores
    scores = out.column("rawPrediction")[:, 1].double().cpu().numpy()
    labels = test.column("label").double().cpu().numpy()
    oracle = binary_metrics(scores, labels, np.ones_like(labels))
    metric_err = max(abs(metrics[k] - oracle[k]) for k in EVAL_METRICS)
    log(f"  eval path metrics {json.dumps(metrics)}; max |port - float64 oracle| {metric_err:.3g}")
    check(metric_err <= METRIC_TOL, f"eval path metrics differ from the float64 oracle by {metric_err}")
    check(metrics["areaUnderROC"] > EVAL_AUC, f"held-out AUC {metrics['areaUnderROC']} <= {EVAL_AUC}")
    warm = {}
    for name, call in (("split", lambda: splitter.transform(table)),
                       ("fit", lambda: text_pipeline().fit(train)),
                       ("transform", lambda: model.transform(test)[0]),
                       ("evaluate", lambda: evaluator.transform(out)[0])):
        runs = [synced(call)[1] for _ in range(EVAL_REPEATS)]
        warm[name] = {"median_ms": float(np.median(runs)), "runs": runs}
    log("  eval path warm medians: " + "; ".join(
        f"{k} {v['median_ms']:.3f} ms (runs {[round(t, 3) for t in v['runs']]})" for k, v in warm.items()))

    def whole():
        tr, te = splitter.transform(table)
        return evaluator.transform(text_pipeline().fit(tr).transform(te)[0])[0]
    profile_run("eval path (split, fit, transform, evaluate)", whole)
    return {"split_ms": split_ms, "fit_ms": fit_ms, "transform_ms": transform_ms,
            "evaluate_ms": evaluate_ms, "warm": warm, "launches": counts, "metrics": metrics,
            "metric_err": metric_err, "peak_gib": peak, "train_rows": train.num_rows,
            "test_rows": test.num_rows, "seconds": time.perf_counter() - t0}


def anova64(X, y, k):
    """float64 one-way ANOVA on the card (two passes: the exact mean, then
    the centred class sums), labels 0..k-1: (F, p)."""
    from flink_ml_tpu_torch.ops.stats import f_sf

    n, d = X.shape
    mean = sum(X[s:s + 1_000_000].double().sum(dim=0) for s in range(0, n, 1_000_000)) / n
    sums = torch.zeros((k, d), dtype=torch.float64, device=X.device)
    ss_tot = torch.zeros(d, dtype=torch.float64, device=X.device)
    for s in range(0, n, 1_000_000):
        Xc = X[s:s + 1_000_000].double() - mean
        sums += torch.nn.functional.one_hot(y[s:s + 1_000_000].long(), k).double().T @ Xc
        ss_tot += (Xc * Xc).sum(dim=0)
    counts = torch.bincount(y.long(), minlength=k).double()
    ss_between = (sums**2 / counts[:, None]).sum(dim=0) - sums.sum(dim=0) ** 2 / n
    f = ((ss_between / (k - 1)) / ((ss_tot - ss_between) / (n - k))).cpu().numpy()
    return f, f_sf(f, float(k - 1), float(n - k))


def fvalue64(X, y):
    """float64 univariate regression F-test on the card: (F, p)."""
    from flink_ml_tpu_torch.ops.stats import f_sf

    n = X.shape[0]
    X64, y64 = X.double(), y.double()
    Xc, yc = X64 - X64.mean(dim=0), y64 - y64.mean()
    corr = ((Xc * yc[:, None]).sum(dim=0) / torch.sqrt((Xc**2).sum(dim=0) * (yc**2).sum())).cpu().numpy()
    f = corr**2 / (1 - corr**2) * (n - 2)
    return f, f_sf(f, 1.0, float(n - 2))


def chisq64(X, y, arity, labels):
    """Integer contingency counts on the card (feature arity x label arity
    a column) and the float64 statistics from them: (counts, stat, p, dof)."""
    from flink_ml_tpu_torch.ops.stats import chi2_sf

    n, d = X.shape
    counts = [torch.bincount(X[:, j].long() * labels + y.long(), minlength=arity * labels)
              .reshape(arity, labels).cpu().numpy() for j in range(d)]
    stat = []
    for observed in counts:
        o = observed.astype(np.float64)
        expected = o.sum(axis=1, keepdims=True) * o.sum(axis=0, keepdims=True) / n
        stat.append(float(np.sum((o - expected) ** 2 / expected)))
    dof = (arity - 1) * (labels - 1)
    stat = np.asarray(stat)
    return counts, stat, chi2_sf(stat, float(dof)), dof


def stat_errors(stat, stat64, p, p64):
    """(max relative error of the statistics, max |p - p64| / max p64)."""
    rel = float(np.max(np.abs(stat - stat64) / np.maximum(np.abs(stat64), 1e-300)))
    return rel, float(np.max(np.abs(p - p64)) / max(float(np.max(np.abs(p64))), 1e-300))


def stats_specs(dev):
    """name -> a function that makes (stage, fit table, transform table,
    output columns, the Java class it saves as, the check of its run) for
    each stage of phase 8 at its shape, on data born on the card."""
    from flink_ml_tpu_torch import SparseBatch, Table
    from flink_ml_tpu_torch.models.classification import knn, naivebayes
    from flink_ml_tpu_torch.models.feature import randomsplitter
    from flink_ml_tpu_torch.models.feature import univariatefeatureselector as ufs
    from flink_ml_tpu_torch.models.stats import anovatest, chisqtest, fvaluetest
    from flink_ml_tpu_torch.ops import stats, tokens
    from flink_ml_tpu_torch.table import DictTokenMatrix

    def naivebayes_spec():
        rows, d, arity, num_labels = NB_SHAPE
        gen = seeded(CONF_SEED, dev)
        X = torch.randint(0, arity, (rows, d), generator=gen, device=dev).float()
        y = torch.randint(0, num_labels, (rows,), generator=gen, device=dev).float()
        table = Table({"features": X, "label": y})
        stage = naivebayes.NaiveBayes()
        before = host_counts()

        def verify(run):
            model, s = run["model"], stage.get_smoothing()
            labels = torch.unique(y)
            cats = [torch.unique(X[:, j]) for j in range(d)]
            label_counts = [int((y == l).sum()) for l in labels]
            theta = []
            for i, l in enumerate(labels):
                rows_l = X[y == l]
                theta.append([{float(v): math.log(int((rows_l[:, j] == v).sum()) + s)
                               - math.log(label_counts[i] + s * cats[j].numel())
                               for v in cats[j]} for j in range(d)])
            pi = [math.log(c * d + s) - math.log(rows * d + labels.numel() * s) for c in label_counts]
            check(model.theta == theta and model.pi.tolist() == pi
                  and model.labels.tolist() == labels.double().cpu().tolist(),
                  "naivebayes model data differs from its integer replay")
            # the float64 argmax on the card
            scores = torch.as_tensor(pi, dtype=torch.float64, device=dev).repeat(rows, 1)
            for j in range(d):
                logp = torch.as_tensor([[theta[i][j][float(v)] for i in range(labels.numel())]
                                        for v in cats[j]], dtype=torch.float64, device=dev)
                scores += logp[torch.searchsorted(cats[j], X[:, j].contiguous())]
            want = labels[torch.argmax(scores, dim=1)]
            pred = run["out"].column("prediction")
            check(torch.equal(pred, want), "naivebayes predictions differ from the float64 argmax")
            host = counts_since(before)
            log(f"    naivebayes host paths over its runs: {host}")
            return {"exact": True, "host_paths": host}
        return stage, table, table, ("prediction",), \
            "org.apache.flink.ml.classification.naivebayes.NaiveBayesModel", verify

    def univariatefeatureselector_spec():
        rows, d, k = UFS_SHAPE
        gen = seeded(CONF_SEED, dev)
        X = torch.rand((rows, d), generator=gen, device=dev)
        y = torch.randint(0, k, (rows,), generator=gen, device=dev).float()
        table = Table({"features": X, "label": y})
        stage = ufs.UnivariateFeatureSelector().set_feature_type("continuous") \
            .set_label_type("categorical")

        def verify(run):
            _, _, f = stats.anova_f_test(X, y)  # the fit's statistics
            f64, p64 = anova64(X, y, k)
            f_err = float(np.max(np.abs(f - f64) / np.abs(f64)))
            top = int(ufs._DEFAULT_THRESHOLDS[ufs.NUM_TOP_FEATURES])
            cut = np.sort(p64)[top - 1]
            near = set(np.nonzero(np.abs(p64 - cut) <= UFS_CUT_MARGIN * cut)[0].tolist())
            want = set(np.argsort(p64, kind="stable")[:top].tolist())
            got = set(run["model"].indices.tolist())
            swapped = got ^ want
            log(f"    univariatefeatureselector: F max rel err {f_err:.3g}; {len(near)} features "
                f"within {UFS_CUT_MARGIN} of the cut p-value {cut:.6g}; {len(swapped)} swapped")
            check(f_err <= UFS_F_TOL, f"univariatefeatureselector F rel err {f_err}")
            check(len(got) == top and swapped <= near, "univariatefeatureselector selection")
            sel = torch.as_tensor(run["model"].indices, device=dev)
            check(torch.equal(run["out"].column("output"), X[:, sel]), "univariatefeatureselector gather")
            return {"f_rel_err": f_err, "near_cut": len(near), "swapped": len(swapped)}
        return stage, table, table, ("output",), \
            FEATURE_JAVA + "univariatefeatureselector.UnivariateFeatureSelectorModel", verify

    def knn_spec():
        rows, d, num_labels, k = KNN_SHAPE
        gen = seeded(CONF_SEED, dev)
        X = torch.rand((rows, d), generator=gen, device=dev)
        y = torch.randint(0, num_labels, (rows,), generator=gen, device=dev).float()
        table = Table({"features": X, "label": y})
        stage = knn.Knn().set_k(k)

        def verify(run):
            pred = run["out"].column("prediction")
            X64 = X.double()
            sq = (X64 * X64).sum(dim=1)
            margin = 0
            for s in range(0, rows, 2_000):
                D = sq[s:s + 2_000, None] - 2.0 * (X64[s:s + 2_000] @ X64.T) + sq[None, :]
                vals, idx = torch.topk(D, k + 1, dim=1, largest=False, sorted=True)
                tie = ((vals[:, k] - vals[:, k - 1]) <= TIE_MARGIN * vals[:, k].abs()).cpu().numpy()
                want = knn._majority_vote(y[idx[:, :k]].double().cpu().numpy())
                margin += int(tie.sum())
                check(np.array_equal(pred[s:s + 2_000][~tie], want[~tie]),
                      f"knn predictions differ from the float64 neighbours, rows {s}-{s + 2_000}")
            log(f"    knn: {margin} rows with their k-th and (k+1)-th float64 distances within "
                f"{TIE_MARGIN} left out")
            return {"margin_rows": margin}
        return stage, table, table, ("prediction",), \
            "org.apache.flink.ml.classification.knn.KnnModel", verify

    def stats_spec(kind, flatten):
        rows, d = STATS_SHAPE
        gen = seeded(CONF_SEED, dev)
        if kind == "chisq":
            X = torch.randint(0, CHISQ_ARITY, (rows, d), generator=gen, device=dev).float()
            y = torch.randint(0, CHISQ_LABELS, (rows,), generator=gen, device=dev).float()
            stage, stat_col = chisqtest.ChiSqTest(), "statistic"
        elif kind == "anova":
            X = torch.rand((rows, d), generator=gen, device=dev)
            y = torch.randint(0, ANOVA_LABELS, (rows,), generator=gen, device=dev).float()
            stage, stat_col = anovatest.ANOVATest(), "fValue"
        else:  # every column tied to the label, some weakly: every F large
            X = torch.rand((rows, d), generator=gen, device=dev)
            w = torch.linspace(0.02, 0.3, d, device=dev)
            y = X @ w + torch.rand(rows, generator=gen, device=dev)
            stage, stat_col = fvaluetest.FValueTest(), "fValue"
        stage.set_flatten(flatten)
        table = Table({"features": X, "label": y})
        cols = (("featureIndex", "pValue", "degreeOfFreedom", stat_col) if flatten
                else ("pValues", "degreesOfFreedom", stat_col + "s"))
        before = host_counts()

        def verify(run):
            out = run["out"]
            if flatten:
                p, stat, dof = (np.asarray(out.column(c), np.float64) for c in
                                ("pValue", stat_col, "degreeOfFreedom"))
            else:
                p, stat, dof = (np.asarray(out.column(c)[0], np.float64) for c in
                                ("pValues", stat_col + "s", "degreesOfFreedom"))
            result = {}
            if kind == "chisq":
                counts, stat64, p64, dof64 = chisq64(X, y, CHISQ_ARITY, CHISQ_LABELS)
                port_counts = list(stats.contingency_tables(X, y))
                check(all(np.array_equal(a, b) for a, b in zip(port_counts, counts)),
                      "chisqtest counts differ from the integer replay")
                result["host_paths"] = counts_since(before)
                log(f"    chisqtest host paths over its runs: {result['host_paths']}")
            elif kind == "anova":
                stat64, p64 = anova64(X, y, ANOVA_LABELS)
                dof64 = rows - 1
            else:
                stat64, p64 = fvalue64(X, y)
                dof64 = rows - 2
            stat_err, p_err = stat_errors(stat, stat64, p, p64)
            check(np.array_equal(dof, np.full(d, dof64)), f"{kind} degrees of freedom {dof}")
            check(stat_err <= STAT_REL_TOL and p_err <= STAT_REL_TOL,
                  f"{kind} statistics rel err {stat_err}, p-values {p_err}")
            result.update(stat_rel_err=stat_err, p_err=p_err)
            return result
        name = {"chisq": "chisqtest.ChiSqTest", "anova": "anovatest.ANOVATest",
                "fvalue": "fvaluetest.FValueTest"}[kind]
        return stage, table, table, cols, STATS_JAVA + name, verify

    def randomsplitter_spec():
        rows = SPLIT_ROWS
        gen = seeded(CONF_SEED, dev)
        table = Table({
            "dense": torch.rand((rows, DIM), generator=gen, device=dev),
            "sparse": SparseBatch(SPARSE_DIM, torch.randint(0, SPARSE_DIM, (rows, NNZ), generator=gen,
                                                             device=dev, dtype=torch.int32),
                                  torch.rand((rows, NNZ), generator=gen, device=dev)),
            "tokens": DictTokenMatrix(string_vocab(TEXT_TERMS),
                                      tokens.random_token_ids(CONF_SEED, rows, TEXT_TOKENS, TEXT_TERMS, dev)),
            "label": torch.arange(rows, device=dev, dtype=torch.float64)})
        stage = randomsplitter.RandomSplitter().set_weights(*EVAL_WEIGHTS).set_seed(EVAL_SEED)

        def verify(run):
            parts = stage.transform(table)
            for part, rows_i in zip(parts, split_replay(rows, EVAL_WEIGHTS, EVAL_SEED)):
                sel = torch.as_tensor(rows_i, device=dev)
                sparse = table.column("sparse")
                check(part.num_rows == rows_i.size
                      and torch.equal(part.column("dense"), table.column("dense")[sel])
                      and torch.equal(part.column("sparse").indices, sparse.indices[sel])
                      and torch.equal(part.column("sparse").values, sparse.values[sel])
                      and torch.equal(part.column("tokens").ids, table.column("tokens").ids[sel])
                      and torch.equal(part.column("label"), table.column("label")[sel]),
                      "randomsplitter parts differ from the numpy replay")
            return {"exact": True, "rows": [p.num_rows for p in parts]}
        return stage, table, table, ("dense", "sparse", "tokens", "label"), \
            FEATURE_JAVA + "randomsplitter.RandomSplitter", verify

    specs = {"naivebayes": naivebayes_spec,
             "univariatefeatureselector": univariatefeatureselector_spec,
             "knn": knn_spec}
    for kind, stage_name in (("chisq", "chisqtest"), ("anova", "anovatest"), ("fvalue", "fvaluetest")):
        for flatten in (False, True):
            specs[stage_name + (" flatten" if flatten else "")] = \
                lambda k=kind, f=flatten: stats_spec(k, f)
    specs["randomsplitter"] = randomsplitter_spec
    return specs


def functions_check(dev):
    """vector_to_array / array_to_vector on the card's layouts: a tensor
    passes through, a SparseBatch densifies to its scatter, ragged rows
    round-trip."""
    from flink_ml_tpu_torch import DenseVector, SparseBatch, array_to_vector, vector_to_array

    X = torch.rand((STATS_SHAPE[0], DIM), generator=seeded(CONF_SEED, dev), device=dev)
    check(vector_to_array(X) is X and array_to_vector(X) is X, "functions moved a tensor column")
    gen = seeded(CONF_SEED + 1, dev)
    # distinct indices a row (a repeated index would leave the scatter's
    # winner to the card's order), about a tenth of them padding
    idx = torch.argsort(torch.rand((10_000, 500), generator=gen, device=dev), dim=1)[:, :NNZ]
    pad = torch.rand((10_000, NNZ), generator=gen, device=dev) < 0.1
    idx = torch.where(pad, -1, idx).to(torch.int32)
    vals = torch.rand((10_000, NNZ), generator=gen, device=dev)
    dense = vector_to_array(SparseBatch(500, idx, vals))
    keep = idx >= 0
    want = torch.zeros((10_000, 501), dtype=torch.float64, device=dev)
    want.scatter_(1, torch.where(keep, idx, 500).long(), torch.where(keep, vals, 0.0).double())
    check(np.array_equal(dense, want[:, :500].cpu().numpy()), "vector_to_array of a SparseBatch")
    ragged = np.empty(3, dtype=object)
    ragged[:] = [DenseVector([1.0, 2.0]), DenseVector([3.0]), DenseVector([4.0, 5.0, 6.0])]
    back = array_to_vector(vector_to_array(ragged))
    check([list(v.to_array()) for v in back] == [[1.0, 2.0], [3.0], [4.0, 5.0, 6.0]],
          "functions ragged round trip")
    log("  functions.py: a tensor passes through both ways, a SparseBatch densifies to its "
        "scatter, ragged vectors round-trip")
    return {"exact": True}


def stats_phase(sk, dev, tmp):
    """Phase 8: the evaluation path (eval_path), then each new stage at its
    shape (drive_feature, then its replay), then the functions."""
    results = {"eval path": eval_path(sk, dev, tmp)}
    torch.cuda.empty_cache()
    for name, make in stats_specs(dev).items():
        t0 = time.perf_counter()
        stage, fit_table, table, out_cols, java, verify = make()
        run = drive_feature(sk, name, stage, fit_table, table, tmp, out_cols, java)
        checks = verify(run)
        if name in STATS_PROFILES:
            call = STATS_PROFILES[name]
            profile_run(f"{name} {call}", (lambda: stage.fit(fit_table)) if call == "fit"
                        else (lambda: run["model"].transform(table)[0]))
        seconds = time.perf_counter() - t0
        log(f"    {name} checks: {checks}; {seconds:.2f} s")
        results[name] = {k: run[k] for k in ("fit_ms", "transform_ms", "warm_fit_ms", "warm_transform_ms",
                                              "fit_runs", "transform_runs", "peak_gib", "high_water_gib",
                                              "launches")}
        results[name].update(checks=checks, seconds=seconds)
        del stage, fit_table, table, verify, run
        torch.cuda.empty_cache()
    results["functions"] = functions_check(dev)
    return results


# -- 8b. the evaluation Graph -------------------------------------------------------------

GRAPH_JAVA = "org.apache.flink.ml.builder.GraphModel"
#: a GraphModel transform scores the test features twice: the LR node and its
#: model-data twin, one row dot each
GRAPH_TRANSFORM_LAUNCHES = launch_dict(sparse_row_dots=2)
#: the Graph's metrics against phase 8's evaluation path in the same run: the
#: same split and fit, but the gradient's atomics order its float32 sums anew
GRAPH_EVAL_TOL = 1e-6


def eval_graph():
    """Phase 8b's Graph: RandomSplitter (0.8, 0.2) with two outputs ->
    StopWordsRemover and HashingTF on each part -> IDF fitted on the train
    part, transforming the test part (a twin IDF node carries the train
    features) -> LogisticRegression (the conf/ params) fitted on the train
    features, transforming the test features -> BinaryClassificationEvaluator;
    the LR's model data feeds a twin LogisticRegressionModel that scores the
    test features again. Outputs: metrics, predictions, the twin's
    predictions, the train features."""
    from flink_ml_tpu_torch.graph import GraphBuilder
    from flink_ml_tpu_torch.models.classification.logisticregression import (
        LogisticRegression, LogisticRegressionModel)
    from flink_ml_tpu_torch.models.evaluation.binaryclassification import (
        BinaryClassificationEvaluator)
    from flink_ml_tpu_torch.models.feature.randomsplitter import RandomSplitter

    f = feature_module
    b = GraphBuilder()
    source = b.create_table_id()
    train, test = b.add_algo_operator(
        RandomSplitter().set_weights(*EVAL_WEIGHTS).set_seed(EVAL_SEED), source)[:2]

    def term_frequencies(part):
        words = b.add_algo_operator(f("stopwordsremover").StopWordsRemover().set_input_cols("tokens")
                                    .set_output_cols("words"), part)[0]
        return b.add_algo_operator(f("hashingtf").HashingTF().set_input_col("words")
                                   .set_output_col("tf"), words)[0]

    tf_train, tf_test = term_frequencies(train), term_frequencies(test)
    feats_test = b.add_estimator(f("idf").IDF().set_input_col("tf").set_output_col("features"),
                                 [tf_train], [tf_test])[0]
    feats_train = b.add_estimator(f("idf").IDF().set_input_col("tf").set_output_col("features"),
                                  [tf_train], [tf_train])[0]
    lr = estimator(LogisticRegression)
    pred = b.add_estimator(lr, [feats_train], [feats_test])[0]
    twin = LogisticRegressionModel()
    b.set_model_data_on_model(twin, b.get_model_data_from_estimator(lr)[0])
    twin_pred = b.add_algo_operator(twin, feats_test)[0]
    metrics = b.add_algo_operator(
        BinaryClassificationEvaluator().set_metrics_names(*EVAL_METRICS), pred)[0]
    return b.build_estimator([source], [metrics, pred, twin_pred, feats_train])


def graph_lr(model):
    """The fitted LR of the evaluation GraphModel (the estimator node's)."""
    return next(n.stage for n in model.nodes
                if n.estimator_input_ids is not None and hasattr(n.stage, "coefficient"))


def graph_path(sk, dev, tmp, eval_metrics):
    """Phase 8b: the evaluation Graph, Graph.fit -> GraphModel.transform ->
    save -> load -> transform, with the launch counts reset before the fit
    and read after it, and again around one transform; its gates, warm
    times and a profiler pass."""
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.graph import GraphModel
    from flink_ml_tpu_torch.models.evaluation.binaryclassification import binary_metrics

    t0 = time.perf_counter()
    table = text_corpus(TEXT_ROWS, dev)
    graph = eval_graph()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    model, fit_ms = synced(lambda: graph.fit(table))
    counts = sk.launch_counts()
    sk.reset_launch_counts()
    (metrics_t, pred, twin, feats), transform_ms = synced(lambda: model.transform(table))
    transform_counts = sk.launch_counts()
    path = os.path.join(tmp, "graph")
    model.save(path)
    with open(os.path.join(path, "metadata")) as fh:
        class_name = json.load(fh)["className"]
    again = GraphModel.load(path).transform(table)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    metrics = {k: float(v) for k, v in metrics_t.collect()[0].items()}
    log(f"  graph path: fit {fit_ms:.1f} ms, transform {transform_ms:.1f} ms (first calls; "
        f"{pred.num_rows} test rows); launches: fit {counts}, a transform {transform_counts}; "
        f"peak {peak:.3f} GiB above the {held / 2**30:.2f} GiB held")
    check(counts == TEXT_LAUNCHES, f"graph fit launched {counts}, expected {TEXT_LAUNCHES} (20 epochs, "
          f"a row dot for the LR node's transform and one for its model-data twin's)")
    check(transform_counts == GRAPH_TRANSFORM_LAUNCHES,
          f"a GraphModel transform launched {transform_counts}, expected {GRAPH_TRANSFORM_LAUNCHES}")
    check(class_name == GRAPH_JAVA, f"graph model saved as {class_name}")
    for name in ("prediction", "rawPrediction"):
        check(same_column(twin.column(name), pred.column(name)),
              f"graph twin {name} differs from the LR node's")
        check(same_column(again[1].column(name), pred.column(name))
              and same_column(again[2].column(name), twin.column(name)),
              f"graph {name} differs after save/load")
    check({k: float(v) for k, v in again[0].collect()[0].items()} == metrics,
          "graph metrics differ after save/load")
    # the LR on the train features against the same fit on the plain loss
    lr = graph_lr(model)
    f = feats.column("features")
    train_out = lr.transform(Table({"features": f}))[0]
    check_sparse_linear("lr", {"model": lr, "out": train_out}, f.indices, f.values,
                        feats.column("label"), dim=f.size)
    scores = pred.column("rawPrediction")[:, 1].double().cpu().numpy()
    labels = pred.column("label").double().cpu().numpy()
    oracle = binary_metrics(scores, labels, np.ones_like(labels))
    metric_err = max(abs(metrics[k] - oracle[k]) for k in EVAL_METRICS)
    eval_err = max(abs(metrics[k] - eval_metrics[k]) for k in EVAL_METRICS)
    log(f"  graph metrics {json.dumps(metrics)}; max |port - float64 oracle| {metric_err:.3g}; max "
        f"|graph - phase 8 eval path| {eval_err:.3g}")
    check(metric_err <= METRIC_TOL, f"graph metrics differ from the float64 oracle by {metric_err}")
    check(eval_err <= GRAPH_EVAL_TOL, f"graph metrics differ from the eval path's by {eval_err}")
    check(metrics["areaUnderROC"] > EVAL_AUC, f"graph held-out AUC {metrics['areaUnderROC']}")
    fits = [synced(lambda: graph.fit(table))[1] for _ in range(EVAL_REPEATS)]
    transforms = [synced(lambda: model.transform(table))[1] for _ in range(EVAL_REPEATS)]
    log(f"  graph path warm: fit median {float(np.median(fits)):.3f} ms (runs "
        f"{[round(t, 3) for t in fits]}), transform median {float(np.median(transforms)):.3f} ms "
        f"(runs {[round(t, 3) for t in transforms]})")
    profile_run("graph fit", lambda: graph.fit(table))
    profile_run("graph transform", lambda: model.transform(table))
    return {"fit_ms": fit_ms, "transform_ms": transform_ms, "warm_fit_ms": float(np.median(fits)),
            "warm_transform_ms": float(np.median(transforms)), "fit_runs": fits,
            "transform_runs": transforms, "launches": counts, "transform_launches": transform_counts,
            "metrics": metrics, "metric_err": metric_err, "eval_path_err": eval_err,
            "peak_gib": peak, "test_rows": pred.num_rows, "seconds": time.perf_counter() - t0}


# -- 9. AgglomerativeClustering, SQLTransformer, MinHashLSH and the windows ------------------

AGG_SHAPE = (1_000, 100, 10)  # conf/agglomerativeclustering: rows, vectorDim, numClusters; seed 2
#: the ward twin that shows the host scale; 5,000 rows, not 10,000: at
#: 10,000 a transform took 19.9 s on the host of an H100 machine (PERF.md)
AGG_BIG_ROWS = 5_000
AGG_COUNT_WINDOW = 100
AGG_EVENT_SPAN_MS, AGG_EVENT_WINDOW_MS = 10_000, 1_000  # timestamps in [0, span), 10 windows
AGG_THRESHOLD = 3.5  # the distanceThreshold twin (average linkage)
AGG_JAVA = "org.apache.flink.ml.clustering.agglomerativeclustering.AgglomerativeClustering"
#: the merge distances against scipy's linkage, relative to the largest
SCIPY_REL_TOL = 1e-9
SQL_ROWS = 100_000_000  # conf/sqltransformer: one float64 column, seed 2
SQL_STATEMENT = "SELECT *, ABS(v1) AS v2 FROM __THIS__"  # conf/sqltransformer
SQL_WHERE_SHAPE = (10_000_000, 100)  # the WHERE twin: rows, width of the vector column passed through
SQL_WHERE = "SELECT vec, v1, ABS(v1) * 2 AS a FROM __THIS__ WHERE v1 > -0.25 AND NOT v1 > 0.4"
SQL_GROUP_ROWS, SQL_GROUPS = 100_000, 100
SQL_GROUP_BY = "SELECT g, SUM(v) AS s, COUNT(*) AS c FROM __THIS__ GROUP BY g"
SQL_SAMPLE_ROWS = 200_000  # the numpy replay of the conf/ statement: a strided sample
#: MinHashLSH: the reference's own test params (MinHashLSHTest.java), phase
#: 3's sparse shape, 1% of the rows planted as near-duplicates of others
LSH_TABLES, LSH_FUNCTIONS, LSH_SEED = 5, 3, 2022
LSH_ROWS, LSH_CHANGED = 1_000_000, 3  # rows; slots of a planted twin drawn anew
LSH_KEYS, LSH_K = 10, 10
LSH_JOIN_ROWS, LSH_THRESHOLD = 10_000, 0.6
HASH_PRIME = 2038074743
#: window_all_and_process over a 1M-row table: timestamps in [0, 10 x rows) ms
WINDOW_ROWS = 1_000_000
WINDOW_COUNT, WINDOW_TUMBLE_MS, WINDOW_GAP_MS = 1_000, 10_000, 60


def java_random_ints(seed, bound, count):
    """`count` draws of java.util.Random(seed).nextInt(bound) (the 48-bit
    LCG of its specification; bound not a power of two)."""
    mult, mask = 0x5DEECE66D, (1 << 48) - 1
    state, out = (seed ^ mult) & mask, []
    while len(out) < count:
        state = (state * mult + 0xB) & mask
        bits = state >> 17
        val = bits % bound
        if bits - val + (bound - 1) < (1 << 31):
            out.append(val)
    return out


def min_hash64(idx, a, b):
    """int64 numpy min-hash of padded index rows: min over a row's indices of
    ((1 + index) * a + b) % HASH_PRIME, HASH_PRIME for a row of padding."""
    idx = idx.astype(np.int64)[:, :, None]
    vals = ((1 + idx) * a + b) % HASH_PRIME
    return np.where(idx >= 0, vals, HASH_PRIME).min(axis=1)


def min_hash_per_function(idx, a, b):
    """The same hash on the card, one function at a time (the plain version
    of the port's broadcast over functions), in int64."""
    idx = idx.long()
    cols = [torch.where(idx >= 0, ((1 + idx) * int(ai) + int(bi)) % HASH_PRIME, HASH_PRIME).amin(dim=1)
            for ai, bi in zip(a, b)]
    return torch.stack(cols, dim=1)


def jaccard(a, b):
    a, b = set(a.tolist()), set(b.tolist())
    return 1.0 - len(a & b) / len(a | b)


def agg_against_plain(stage, table):
    """The stage's transform with each native merge loop's input kept, then
    the numpy merge loop (the plain version) on each kept input. Returns
    the transform's output, the number of loops run and the first that
    disagrees (None when all agree)."""
    from flink_ml_tpu_torch.models.clustering import agglomerativeclustering as agg

    native, calls = agg.cluster_block_native, []

    def keeping(dist, *args):
        kept = dist.copy()
        result = native(dist, *args)
        calls.append((kept, args, result))
        return result

    agg.cluster_block_native = keeping
    try:
        out = stage.transform(table)
    finally:
        agg.cluster_block_native = native
    for c, (kept, args, (pred, merges)) in enumerate(calls):
        want_pred, want_merges = agg.cluster_block_plain(kept, *args)
        if not np.array_equal(pred, want_pred) or merges != want_merges:
            first = next((m for m, (a, b) in enumerate(zip(merges, want_merges)) if a != b), None)
            return out, len(calls), {"loop": c, "merge": first, "native": merges[first:first + 2]
                                     if first is not None else None,
                                     "plain": want_merges[first:first + 2] if first is not None
                                     else None, "predictions_equal": bool(np.array_equal(
                                         pred, want_pred))}
    return out, len(calls), None


def merge_log(merges):
    return [tuple(np.asarray(merges.column(c)).tolist()) for c in merges.column_names]


def scipy_check(X64, linkage, k, distances, pred):
    """The merge distances against scipy.cluster.hierarchy.linkage (sorted,
    relative to the largest) and the flat partition at k clusters (equal up
    to relabelling)."""
    from scipy.cluster.hierarchy import fcluster
    from scipy.cluster.hierarchy import linkage as scipy_linkage

    n = X64.shape[0]
    Z = scipy_linkage(X64, method=linkage, metric="euclidean")
    got = np.sort(np.asarray(distances, np.float64))
    want = np.sort(Z[: got.size, 2])  # the first merges: numClusters, or the full tree
    rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want))) if n > k else 0.0
    labels = fcluster(Z, k, criterion="maxclust")
    pred = np.asarray(pred)
    pairs = set(zip(pred.tolist(), labels.tolist()))
    same = len(pairs) == len(set(pred.tolist())) == len(set(labels.tolist()))
    check(got.size in (n - k, n - 1) and rel <= SCIPY_REL_TOL,
          f"{linkage} merge distances differ from scipy's by {rel}")
    check(same, f"{linkage} partition at {k} clusters differs from scipy's fcluster")
    return rel


def slice8_specs(dev):
    """name -> a function that makes (stage, fit table, transform table,
    output columns, the Java class it saves as, the check of its run, the
    warm repeats) for each stage of phase 9, on data born on the card."""
    from flink_ml_tpu_torch import SparseBatch, Table
    from flink_ml_tpu_torch.common import window
    from flink_ml_tpu_torch.models.clustering import agglomerativeclustering as agg
    from flink_ml_tpu_torch.models.feature import lsh, sqltransformer

    def agg_spec(linkage="ward", measure="euclidean", rows=None, threshold=None, full_tree=False,
                 windows=None, plain=True):
        def make():
            n, d, k = AGG_SHAPE
            n = rows or n
            X = torch.rand((n, d), generator=seeded(CONF_SEED, dev), device=dev, dtype=torch.float64)
            cols = {"features": X}
            if isinstance(windows, window.EventTimeTumblingWindows):
                cols["timestamp"] = torch.randint(0, AGG_EVENT_SPAN_MS, (n,),
                                                  generator=seeded(CONF_SEED + 1, dev), device=dev)
            table = Table(cols)
            stage = agg.AgglomerativeClustering().set_linkage(linkage).set_distance_measure(measure) \
                .set_num_clusters(k).set_compute_full_tree(full_tree)
            if threshold is not None:
                stage.set_distance_threshold(threshold)
            if windows is not None:
                stage.set_windows(windows)

            def verify(run):
                Xh = X.cpu().numpy()
                if plain:
                    (out, merges), loops, differs = agg_against_plain(stage, table)
                    check(differs is None, "agglomerativeclustering's native merge loop differs "
                          f"from the numpy loop on the same distances: {differs}")
                    again = stage.transform(table)
                    pred, distances = out.column("prediction").cpu().numpy(), merges.column("distance")
                    result = {"plain_exact": True, "loops": loops, "merges": merges.num_rows,
                              "repeats": torch.equal(again[0].column("prediction"), out.column(
                                  "prediction")) and merge_log(again[1]) == merge_log(merges)}
                else:  # the transform's two host parts, timed apart
                    t0 = time.perf_counter()
                    dist = agg.distance_matrix(Xh, measure)
                    t1 = time.perf_counter()
                    pred, log_rows = agg.cluster_block_native(dist, linkage, k, None, False)
                    t2 = time.perf_counter()
                    check(np.array_equal(pred, run["out"].column("prediction").cpu().numpy()),
                          "agglomerativeclustering predictions differ from its merge loop's")
                    distances = [m[2] for m in log_rows]
                    result = {"merges": len(log_rows), "pairwise_ms": (t1 - t0) * 1e3,
                              "loop_ms": (t2 - t1) * 1e3}
                result["clusters"] = int(np.unique(pred).size)
                if windows is None and threshold is None and measure == "euclidean":
                    result["scipy_rel_err"] = scipy_check(Xh, linkage, k, distances, pred)
                log(f"    agglomerativeclustering {linkage}/{measure}: {result}")
                return result
            return stage, table, table, ("prediction",), AGG_JAVA, verify, \
                1 if rows else FEATURE_REPEATS
        return make

    def sql_conf():
        v1 = torch.rand(SQL_ROWS, generator=seeded(CONF_SEED, dev), device=dev, dtype=torch.float64)
        table = Table({"v1": v1})
        stage = sqltransformer.SQLTransformer().set_statement(SQL_STATEMENT)

        def verify(run):
            v2 = run["out"].column("v2")
            check(run["out"].column_names == ["v1", "v2"] and run["out"].column("v1") is v1,
                  "sqltransformer output columns")
            check(torch.equal(v2, v1.abs()), "sqltransformer v2 differs from |v1| on the card")
            rows = torch.arange(0, SQL_ROWS, max(1, SQL_ROWS // SQL_SAMPLE_ROWS), device=dev)
            check(np.array_equal(v2[rows].cpu().numpy(), np.abs(v1[rows].cpu().numpy())),
                  "sqltransformer v2 differs from the numpy replay")
            return {"exact": True, "sample_rows": int(rows.numel())}
        return stage, table, table, ("v1", "v2"), FEATURE_JAVA + "sqltransformer.SQLTransformer", \
            verify, FEATURE_REPEATS

    def sql_where():
        rows, width = SQL_WHERE_SHAPE
        gen = seeded(CONF_SEED, dev)
        v1 = torch.rand(rows, generator=gen, device=dev, dtype=torch.float64) - 0.5
        v1[torch.rand(rows, generator=gen, device=dev) < NAN_SHARE] = float("nan")
        vec = torch.rand((rows, width), generator=gen, device=dev)
        table = Table({"vec": vec, "v1": v1})
        stage = sqltransformer.SQLTransformer().set_statement(SQL_WHERE)

        def verify(run):
            out = run["out"]
            x = v1.cpu().numpy()
            with np.errstate(invalid="ignore"):
                keep = (x > -0.25) & ~(x > 0.4) & ~np.isnan(x)  # SQL's NULL: a NaN row drops
            sel = torch.as_tensor(np.flatnonzero(keep), device=dev)
            check(out.num_rows == int(keep.sum()), f"sqltransformer WHERE kept {out.num_rows} rows")
            check(np.array_equal(out.column("v1").cpu().numpy(), x[keep])
                  and np.array_equal(out.column("a").cpu().numpy(), np.abs(x[keep]) * 2)
                  and torch.equal(out.column("vec"), vec[sel]),
                  "sqltransformer WHERE differs from the numpy Kleene replay")
            return {"exact": True, "kept": out.num_rows, "nan_rows": int(np.isnan(x).sum())}
        return stage, table, table, ("vec", "v1", "a"), \
            FEATURE_JAVA + "sqltransformer.SQLTransformer", verify, FEATURE_REPEATS

    def sql_group_by():
        import sqlite3

        gen = seeded(CONF_SEED, dev)
        g = torch.randint(0, SQL_GROUPS, (SQL_GROUP_ROWS,), generator=gen, device=dev)
        v = torch.rand(SQL_GROUP_ROWS, generator=gen, device=dev, dtype=torch.float64)
        table = Table({"g": g, "v": v})
        stage = sqltransformer.SQLTransformer().set_statement(SQL_GROUP_BY)

        def verify(run):
            conn = sqlite3.connect(":memory:")
            conn.execute('CREATE TABLE __this__ ("g", "v")')
            conn.executemany('INSERT INTO __this__ ("g", "v") VALUES (?, ?)',
                             zip(g.cpu().tolist(), v.cpu().tolist()))
            want = conn.execute(SQL_GROUP_BY.replace("__THIS__", "__this__")).fetchall()
            conn.close()
            out = run["out"]
            got = list(zip(*[np.asarray(out.column(c)).tolist() for c in ("g", "s", "c")]))
            check(got == [tuple(r) for r in want], "sqltransformer GROUP BY differs from sqlite3's")
            return {"exact": True, "groups": len(got)}
        return stage, table, table, ("g", "s", "c"), FEATURE_JAVA + "sqltransformer.SQLTransformer", \
            verify, FEATURE_REPEATS

    def minhash():
        from flink_ml_tpu_torch import Vectors

        rows = LSH_ROWS
        planted = rows // 100
        gen = seeded(5, dev)  # phase 3's sparse rows
        idx = torch.randint(0, SPARSE_DIM, (rows, NNZ), generator=gen, device=dev, dtype=torch.int32)
        vals = torch.rand((rows, NNZ), generator=gen, device=dev)
        # the last 1% of the rows: twins of the first 1% with LSH_CHANGED slots drawn anew
        twins = idx[:planted].clone()
        twins[:, :LSH_CHANGED] = torch.randint(0, SPARSE_DIM, (planted, LSH_CHANGED), generator=gen,
                                               device=dev, dtype=torch.int32)
        idx[rows - planted:] = twins
        table = Table({"id": torch.arange(rows, device=dev), "features": SparseBatch(SPARSE_DIM, idx, vals)})
        stage = lsh.MinHashLSH().set_input_col("features").set_output_col("hashes") \
            .set_num_hash_tables(LSH_TABLES).set_num_hash_functions_per_table(LSH_FUNCTIONS) \
            .set_seed(LSH_SEED)

        def verify(run):
            model = run["model"]
            fns = LSH_TABLES * LSH_FUNCTIONS
            draws = java_random_ints(LSH_SEED, HASH_PRIME - 1, 2 * fns)
            a, b = np.asarray(draws[0::2], np.int64) + 1, np.asarray(draws[1::2], np.int64)
            check(np.array_equal(model.rand_coefficient_a, a)
                  and np.array_equal(model.rand_coefficient_b, b),
                  "minhashlsh coefficients differ from the java.util.Random replay")
            replay_rows = min(HOST_REPLAY_ROWS, rows)
            host_idx = idx[:replay_rows].cpu().numpy()
            got = np.array(run["out"].column("hashes")[:replay_rows].tolist())
            want = min_hash64(host_idx, a, b).reshape(replay_rows, LSH_TABLES, LSH_FUNCTIONS)
            check(got.dtype == np.float64 and np.array_equal(got, want.astype(np.float64)),
                  "minhashlsh hashes differ from the int64 numpy replay")
            # nearest neighbours of planted keys: candidates by the per-function
            # hash on the card, distances by sets, the stable order
            every = min_hash_per_function(idx, a, b).reshape(rows, LSH_TABLES, LSH_FUNCTIONS)
            found_twins, neighbours = 0, []
            for r in range(LSH_KEYS):
                keep = np.unique(host_idx[r][host_idx[r] >= 0])
                key = Vectors.sparse(SPARSE_DIM, keep, np.ones(keep.size))
                res = model.approx_nearest_neighbors(table, key, LSH_K)
                kh = torch.as_tensor(min_hash64(keep[None, :], a, b), device=dev).reshape(
                    1, LSH_TABLES, LSH_FUNCTIONS)
                cand = torch.nonzero((every == kh).all(dim=2).any(dim=1)).flatten().cpu().numpy()
                cand_idx = idx[torch.as_tensor(cand, device=dev)].cpu().numpy()
                dists = [jaccard(row[row >= 0], keep) for row in cand_idx]
                order = np.argsort(dists, kind="stable")[:LSH_K]
                check(np.array_equal(res.column("id").cpu().numpy(), cand[order])
                      and np.array_equal(res.column("distCol"), np.asarray(dists)[order]),
                      f"minhashlsh neighbours of row {r} differ from the replay")
                found_twins += int(rows - planted + r in cand[order].tolist())
                neighbours.append(len(cand))
            # the similarity join of the first rows with their planted twins
            m = min(LSH_JOIN_ROWS, planted)
            A = table.take(np.arange(m))
            B = table.take(np.arange(rows - planted, rows - planted + m))
            joined = model.approx_similarity_join(A, B, LSH_THRESHOLD, "id")
            a_idx = idx[:m].cpu().numpy()
            b_idx = idx[rows - planted: rows - planted + m].cpu().numpy()
            ha, hb = min_hash64(a_idx, a, b), min_hash64(b_idx, a, b)
            buckets, pairs = {}, set()
            for i in range(m):
                for t in range(LSH_TABLES):
                    buckets.setdefault((t, tuple(ha[i, t * LSH_FUNCTIONS:(t + 1) * LSH_FUNCTIONS])),
                                       []).append(i)
            for j in range(m):
                for t in range(LSH_TABLES):
                    for i in buckets.get((t, tuple(hb[j, t * LSH_FUNCTIONS:(t + 1) * LSH_FUNCTIONS])), ()):
                        pairs.add((i, j))
            want_rows = []
            for i, j in sorted(pairs):
                d = jaccard(a_idx[i][a_idx[i] >= 0], b_idx[j][b_idx[j] >= 0])
                if d <= LSH_THRESHOLD:
                    want_rows.append((i, rows - planted + j, d))
            got_rows = list(zip(np.asarray(joined.column("idA")).tolist(),
                                np.asarray(joined.column("idB")).tolist(),
                                np.asarray(joined.column("distCol")).tolist()))
            check(got_rows == want_rows, "minhashlsh similarity join differs from the set replay")
            twins_joined = sum(1 for i, j, _ in got_rows if j - (rows - planted) == i)
            log(f"    minhashlsh: coefficients and {replay_rows} rows of hashes exact; {LSH_KEYS} keys "
                f"with {neighbours} candidates, {found_twins} planted twins among their neighbours; "
                f"join of {m} x {m} rows: {len(got_rows)} pairs, {twins_joined} planted twins")
            check(twins_joined >= 0.9 * m, f"minhashlsh join found {twins_joined} of {m} planted twins")
            return {"exact": True, "candidates": neighbours, "twins_found": found_twins,
                    "join_pairs": len(got_rows), "twins_joined": twins_joined}
        return stage, table, table, ("hashes",), FEATURE_JAVA + "lsh.MinHashLSHModel", verify, 1

    return {
        "agglomerativeclustering": agg_spec(),
        "agglomerativeclustering complete": agg_spec("complete"),
        "agglomerativeclustering single": agg_spec("single"),
        "agglomerativeclustering average": agg_spec("average"),
        "agglomerativeclustering cosine average": agg_spec("average", "cosine"),
        "agglomerativeclustering distanceThreshold": agg_spec("average", threshold=AGG_THRESHOLD),
        "agglomerativeclustering computeFullTree": agg_spec(full_tree=True),
        "agglomerativeclustering count windows": agg_spec(
            windows=window.CountTumblingWindows.of(AGG_COUNT_WINDOW)),
        "agglomerativeclustering event-time windows": agg_spec(
            windows=window.EventTimeTumblingWindows.of(AGG_EVENT_WINDOW_MS)),
        "agglomerativeclustering ward big": agg_spec(rows=AGG_BIG_ROWS, plain=False),
        "sqltransformer": sql_conf,
        "sqltransformer where": sql_where,
        "sqltransformer group by": sql_group_by,
        "minhashlsh": minhash,
    }


def windows_check(dev):
    """window_all_and_process over a WINDOW_ROWS-row table on the card with
    count, event-time tumbling and session windows, each window's row count
    and first and last row ids against numpy groupings of the timestamps."""
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.common import window
    from flink_ml_tpu_torch.utils.datastream import window_all_and_process

    rows = WINDOW_ROWS
    gen = seeded(CONF_SEED, dev)
    ts = torch.randint(0, 10 * rows, (rows,), generator=gen, device=dev)
    table = Table({"id": torch.arange(rows, device=dev), "timestamp": ts,
                   "x": torch.rand(rows, generator=gen, device=dev)})

    def summary(w):
        ids = w.column("id")
        return Table({"n": np.array([w.num_rows]), "first": ids[:1], "last": ids[-1:]})

    host_ts = ts.cpu().numpy()
    starts = host_ts - host_ts % WINDOW_TUMBLE_MS
    order = np.argsort(starts, kind="stable")
    bounds = np.flatnonzero(np.diff(starts[order])) + 1
    tumbling = np.split(order, bounds)
    order = np.argsort(host_ts, kind="stable")
    sessions = [np.sort(g) for g in np.split(order, np.flatnonzero(np.diff(host_ts[order]) >
                                                                  WINDOW_GAP_MS) + 1)]
    count = [np.arange(s, s + WINDOW_COUNT) for s in range(0, rows - WINDOW_COUNT + 1, WINDOW_COUNT)]
    result = {}
    for name, windows, groups in (
            ("count", window.CountTumblingWindows.of(WINDOW_COUNT), count),
            ("event tumbling", window.EventTimeTumblingWindows.of(WINDOW_TUMBLE_MS), tumbling),
            ("event session", window.EventTimeSessionWindows.with_gap(WINDOW_GAP_MS), sessions)):
        out, ms = synced(lambda: window_all_and_process(table, windows, summary))
        got = (np.asarray(out.column("n")).tolist(), out.column("first").cpu().tolist(),
               out.column("last").cpu().tolist())
        want = ([g.size for g in groups], [int(g[0]) for g in groups], [int(g[-1]) for g in groups])
        check(got == want, f"window_all_and_process {name} windows differ from the numpy groupings")
        result[name] = {"windows": len(groups), "ms": ms}
    log(f"  window_all_and_process over {rows} rows: {json.dumps(result)}")
    return result


def slice8_phase(sk, dev, tmp):
    """Phase 9: each stage at its shape (drive_feature, then its replay),
    then window_all_and_process."""
    results = {}
    for name, make in slice8_specs(dev).items():
        t0 = time.perf_counter()
        stage, fit_table, table, out_cols, java, verify, repeats = make()
        run = drive_feature(sk, name, stage, fit_table, table, tmp, out_cols, java, repeats)
        checks = verify(run)
        seconds = time.perf_counter() - t0
        log(f"    {name} checks: {checks}; {seconds:.2f} s")
        results[name] = {k: run[k] for k in ("fit_ms", "transform_ms", "warm_fit_ms", "warm_transform_ms",
                                              "fit_runs", "transform_runs", "peak_gib", "high_water_gib",
                                              "launches")}
        results[name].update(checks=checks, seconds=seconds)
        del stage, fit_table, table, verify, run
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results["window_all_and_process"] = windows_check(dev)
    results["window_all_and_process"]["seconds"] = time.perf_counter() - t0
    return results


# -- the fleet (FitFleet) and the reference-format loader ------------------

FLEET_MEMBERS = 8
# the sparse and dense fleets' members: learningRate x reg x elasticNet,
# every other param conf/'s LR; the last member stops at FLEET_SHORT_ITER
FLEET_GRID = [(lr, reg, en) for lr in (0.1, 0.05) for reg in (0.0, 1e-3) for en in (0.0, 0.5)]
FLEET_SHORT_ITER = 10
STREAM_FLEET_MEMBERS = 4
KMEANS_FLEET_SEEDS = (2, 3, 4, 5)
KMEANS_FLEET_SHORT_ITER = 5
FLEET_REPEATS = 3
# (rows, nnz, d, members): edges of the fleet kernels' layout (a member
# tile of 8 and one member more, an empty row width, one member; 4 and 12
# members take the gradient's float4 REDs when member-minor, 3 and 9 not)
FLEET_EDGE_SHAPES = [(64, 5, 24, 8), (200, 39, 64, 8), (1, 3, 4, 1), (33, 40, 50, 3),
                     (33, 40, 50, 4), (7, 0, 10, 2), (300, 64, 1000, 9), (300, 65, 1000, 12),
                     (300, 65, 1000, 17)]
#: the designs of csrc/designs.cu that this port's kernels replaced (timed in phase 2)
REPLACED_DESIGNS = {"sparse_grad": "fmt_red_grad (csrc/designs.cu)",
                    "fleet_grad": "fmt_red_fleet_grad (csrc/designs.cu)",
                    "fleet_row_dots": "fmt_scalar_fleet_row_dots (csrc/designs.cu)"}
FLEET_SOURCES = {"fleet_row_dots": "flink_ml_tpu/ops/sparsekernels.py:96 (under jax.vmap)",
                 "fleet_grad": "flink_ml_tpu/ops/sparsekernels.py:107 (under jax.vmap)"}
REFERENCE_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures")


def fleet_layouts(C):
    """C (N, d) as member-major, member-minor and, where N is a multiple
    of 4, member-minor with a base 4 bytes past 16-byte alignment (which
    takes the scalar loads and REDs)."""
    members, d = C.shape
    layouts = {"member-major": C, "member-minor": C.T.contiguous().T}
    if members % 4 == 0:
        buf = torch.empty(d * members + 1, device=C.device)
        shifted = buf[1:].view(d, members)
        shifted.copy_(C.T)
        layouts["member-minor misaligned"] = shifted.T
    return layouts


def fleet_kernel_phase(sk, probes, designs, dev):
    """The member-batched kernels against their plain versions: at edge
    shapes, in both layouts of the (N, d) operand (and member-minor off
    16-byte alignment), and at the sparse fleet fit's batch (N = 8, BATCH x
    NNZ, d = SPARSE_DIM), where the row dot must also equal N launches of
    the solo kernel bit for bit at N = 1, 8 and 9 in both layouts (it adds
    in the solo kernel's order). CUDA-event times of each kernel in both
    layouts, of the row dot's replaced design (`fmt_scalar_fleet_row_dots`)
    in both, of N solo launches, of the plain version, of one library call
    (embedding_bag over a (d, N) table; index_add_ of (B * nnz, N) rows
    into (d, N)) and of the row dot's probe (two 16-byte loads a slot from
    a (d, 8) table), beside the bound from the bytes moved."""
    scalar_row_dots = designs[1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    for rows, nnz, d, members in FLEET_EDGE_SHAPES:
        idx, vals = sparse_batch(gen, rows, nnz, d, dev, 0.2, 0.05)
        C = torch.randn(members, d, generator=gen, device=dev)
        M = torch.randn(members, rows, generator=gen, device=dev)
        want_dots, want_grad = sk.fleet_row_dots_plain(idx, vals, C), sk.fleet_grad_plain(idx, vals, M, C)
        for layout, c in fleet_layouts(C).items():
            for name, fn in (("fleet_row_dots", sk.fleet_row_dots),
                             ("fmt_scalar_fleet_row_dots", scalar_row_dots)):
                check(torch.allclose(fn(idx, vals, c), want_dots, **ROW_DOTS_TOL),
                      f"{name} disagrees at {(rows, nnz, d, members)} {layout}")
            g = sk.fleet_grad(idx, vals, M, c)
            check(g.is_contiguous() == c.is_contiguous(), f"fleet_grad's layout {g.stride()} is not coeff's")
            check(torch.allclose(g, want_grad, **GRAD_TOL),
                  f"fleet_grad disagrees at {(rows, nnz, d, members)} {layout}")
    log(f"  fleet kernels: edge shapes (rows, nnz, d, members) {FLEET_EDGE_SHAPES} agree in both "
        f"layouts and member-minor off 16-byte alignment")

    N = FLEET_MEMBERS
    idx, vals = sparse_batch(gen, BATCH, NNZ, SPARSE_DIM, dev, DEFAULT_MASK_SHARE, OUT_OF_RANGE_SHARE)
    C = torch.randn(max(N, 9), SPARSE_DIM, generator=gen, device=dev)
    solo = torch.stack([sk.sparse_row_dots(idx, vals, C[m].contiguous()) for m in range(C.shape[0])])
    bits = {}
    for members in (1, N, 9):
        for layout, c in fleet_layouts(C[:members]).items():
            bits[f"N={members} {layout}"] = bool(torch.equal(sk.fleet_row_dots(idx, vals, c), solo[:members]))
    check(all(bits.values()), f"fleet_row_dots is not bit-identical to solo sparse_row_dots launches: {bits}")
    C = C[:N].contiguous()
    Cm = C.T.contiguous().T  # the fit's layout: member-minor
    M = torch.randn(N, BATCH, generator=gen, device=dev)
    sets = copies(idx, vals)
    valid = idx >= 0
    safe = torch.where(valid, idx, 0).clamp(max=SPARSE_DIM - 1)
    masked_vals = torch.where(valid, vals, 0.0)
    batch_bytes = idx.numel() * 8
    results = {}

    got = sk.fleet_row_dots(idx, vals, Cm)
    want = sk.fleet_row_dots_plain(idx, vals, C)
    err = (got - want).abs()
    check(torch.allclose(got, want, **ROW_DOTS_TOL),
          f"fleet_row_dots disagrees with its plain version: max abs {float(err.max())}")
    check(torch.equal(scalar_row_dots(idx, vals, Cm), got), "the replaced fleet row dot's bits differ")
    table = Cm.T  # (d, N), contiguous
    gather8 = probes[2]
    check_gather8(gather8, idx, table)
    lib = torch.nn.functional.embedding_bag(safe, table, per_sample_weights=masked_vals, mode="sum")
    check(torch.allclose(lib.T, want, **ROW_DOTS_TOL), "embedding_bag yardstick disagrees")
    touched = int(torch.unique(safe[valid]).numel())
    b_ms, b_by = bound_ms(batch_bytes + touched * N * 4 + N * BATCH * 4, 2.0 * N * int(valid.sum()))
    results["fleet_row_dots"] = {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / want.abs().clamp_min(1e-6)).max()),
        "bit_identical_to_solo": bits,
        "ms": cuda_ms(lambda i, v: sk.fleet_row_dots(i, v, Cm), sets),
        "replaced_ms": cuda_ms(lambda i, v: scalar_row_dots(i, v, Cm), sets),
        "member_major_ms": cuda_ms(lambda i, v: sk.fleet_row_dots(i, v, C), sets),
        "replaced_member_major_ms": cuda_ms(lambda i, v: scalar_row_dots(i, v, C), sets),
        "solo_n_ms": cuda_ms(lambda i, v: [sk.sparse_row_dots(i, v, C[m]) for m in range(N)], sets),
        "plain_ms": cuda_ms(lambda i, v: sk.fleet_row_dots_plain(i, v, C), sets, iters=10),
        "library_ms": cuda_ms(
            lambda sf, w: torch.nn.functional.embedding_bag(sf, table, per_sample_weights=w, mode="sum"),
            [(safe, masked_vals)], iters=10),
        "probe_ms": cuda_ms(lambda i, v: gather8(i, table), sets),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    results["fleet_row_dots"].update(rows=BATCH, nnz=NNZ, d=SPARSE_DIM, members=N, tolerance=ROW_DOTS_TOL)
    r = results["fleet_row_dots"]
    log(f"  fleet_row_dots fit batch ({N} x {BATCH} x {NNZ}, d={SPARSE_DIM}): max_abs_err "
        f"{r['max_abs_err']:.3g}; kernel {r['ms']:.4f} ms member-minor, {r['member_major_ms']:.4f} ms "
        f"member-major; replaced design {r['replaced_ms']:.4f} ms member-minor, "
        f"{r['replaced_member_major_ms']:.4f} ms member-major; probe {r['probe_ms']:.4f} ms; {N} solo "
        f"launches {r['solo_n_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"  fleet_row_dots equals solo launches of sparse_row_dots bit for bit: {bits}")
    del solo, got, want, lib

    cases = fleet_grad_cases(sk, gen, dev, idx, vals, M)
    del idx, vals, sets
    by_case = [measure_fleet_grad(sk, probes, designs, label, *case) for label, case in cases.items()]
    del cases
    main = by_case[0]
    speedups = {r["case"]: (round(r["replaced_ms"] / r["ms"], 3),
                            round(r["replaced_member_major_ms"] / r["member_major_ms"], 3))
                for r in by_case if "ms" in r}
    log(f"  fleet_grad's replaced design over the kernel, member-minor and member-major: {speedups}")
    results["fleet_grad"] = {**main, "by_case": by_case, "speedup_over_replaced": speedups}
    for name, rows in fleet_mesh_shapes(sk, dev).items():
        results[name]["by_shape"] = rows
    return results


def fleet_mesh_shapes(sk, dev):
    """Both fleet kernels at phase 17's shapes, member-minor: the
    fleet-sharded regime's (FLEET_MEMBERS / MESH_RANKS members a rank over
    the whole fit batch) and the default regime's (FLEET_MEMBERS members
    over a rank's share of it), held to their plain versions and timed
    beside the plain version, one library call and the bound."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    out = {"fleet_row_dots": [], "fleet_grad": []}
    for label, members, rows in (
            ("fleet-sharded regime", FLEET_MEMBERS // MESH_RANKS, BATCH),
            ("default regime on the mesh", FLEET_MEMBERS, BATCH // MESH_RANKS)):
        idx, vals = sparse_batch(gen, rows, NNZ, SPARSE_DIM, dev, DEFAULT_MASK_SHARE,
                                 OUT_OF_RANGE_SHARE)
        C = torch.randn(members, SPARSE_DIM, generator=gen, device=dev)
        Cm = C.T.contiguous().T
        M = torch.randn(members, rows, generator=gen, device=dev)
        sets = copies(idx, vals)
        valid = idx >= 0
        safe = torch.where(valid, idx, 0).clamp(max=SPARSE_DIM - 1)
        masked_vals = torch.where(valid, vals, 0.0)
        keep = valid & (idx < SPARSE_DIM)
        shape = {"case": label, "members": members, "rows": rows, "nnz": NNZ, "d": SPARSE_DIM}

        got, want = sk.fleet_row_dots(idx, vals, Cm), sk.fleet_row_dots_plain(idx, vals, C)
        err = (got - want).abs()
        check(torch.allclose(got, want, **ROW_DOTS_TOL),
              f"fleet_row_dots disagrees at the {label}'s shape: max abs {float(err.max())}")
        table = Cm.T
        touched = int(torch.unique(safe[valid]).numel())
        b_ms, b_by = bound_ms(idx.numel() * 8 + touched * members * 4 + members * rows * 4,
                              2.0 * members * int(valid.sum()))
        out["fleet_row_dots"].append({
            **shape, "max_abs_err": float(err.max()),
            "ms": cuda_ms(lambda i, v: sk.fleet_row_dots(i, v, Cm), sets),
            "plain_ms": cuda_ms(lambda i, v: sk.fleet_row_dots_plain(i, v, C), sets, iters=10),
            "library_ms": cuda_ms(
                lambda sf, w: torch.nn.functional.embedding_bag(sf, table, per_sample_weights=w,
                                                                mode="sum"),
                [(safe, masked_vals)], iters=10),
            "bound_ms": b_ms, "bound_by": b_by, "probe_ms": None})

        got, want = sk.fleet_grad(idx, vals, M, Cm), sk.fleet_grad_plain(idx, vals, M, C)
        err = (got - want).abs()
        check(torch.allclose(got, want, **GRAD_TOL),
              f"fleet_grad disagrees at the {label}'s shape: max abs {float(err.max())}")
        flat_idx = torch.where(keep, idx, 0).long().reshape(-1)
        contrib = torch.where(keep[None], vals[None] * M[:, :, None], 0.0).permute(
            1, 2, 0).reshape(-1, members)
        msets = [(i, v, M) for i, v in sets]
        b_ms, b_by = bound_ms(idx.numel() * 8 + members * rows * 4 + members * SPARSE_DIM * 4,
                              2.0 * members * int(keep.sum()))
        out["fleet_grad"].append({
            **shape, "max_abs_err": float(err.max()),
            "ms": cuda_ms(lambda i, v, m: sk.fleet_grad(i, v, m, Cm), msets),
            "plain_ms": cuda_ms(lambda i, v, m: sk.fleet_grad_plain(i, v, m, C), msets, iters=5),
            "library_ms": cuda_ms(
                lambda fi, c: torch.zeros((SPARSE_DIM, members), device=dev).index_add_(0, fi, c),
                [(flat_idx, contrib)], iters=10),
            "bound_ms": b_ms, "bound_by": b_by, "probe_ms": None})
        for name in out:
            r = out[name][-1]
            log(f"  {name} {label} ({members} x {rows} x {NNZ}, d={SPARSE_DIM}): max_abs_err "
                f"{r['max_abs_err']:.3g}; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        del idx, vals, C, Cm, M, sets, contrib
    return out


# the fleet gradient's cases in phase 2: label -> how its gradient is held
FLEET_GRAD_GATES = {"fit batch": "tol", "zipf": "exact", "text fit batch": "bound",
                    "text fit batch, quarter grid": "exact", "tiny d": "exact", "misaligned slice": "tol"}


def fleet_grad_cases(sk, gen, dev, idx, vals, M):
    """fleet_grad's cases at N = FLEET_MEMBERS, label -> (idx, vals, mult,
    d, sets): the fleet fit's batch (`idx`, `vals`, `M`); Zipf(1.1)
    indices; the text path's fit batch (100,000 x 100, d = 2^18, ~900
    hashed columns), with its values and with quarter-grid values on the
    same indices; a tiny d; a fit batch sliced at an odd row offset.
    Values and multipliers lie on the quarter grid where the gate is
    exact. `sets` rotate copies of (idx, vals, mult) through timed calls."""
    N = FLEET_MEMBERS
    out = {"fit batch": (idx, vals, M, SPARSE_DIM, [(i, v, M) for i, v in copies(idx, vals)])}
    zidx, zvals = zipf_batch(gen, BATCH, NNZ, SPARSE_DIM, dev)
    zmult = quarter_grid(gen, (N, BATCH), dev, signed=True)
    out["zipf"] = (zidx, zvals, zmult, SPARSE_DIM, [(i, v, zmult) for i, v in copies(zidx, zvals)])
    tidx, tvals, td = text_fit_batch(dev)
    tmult = torch.randn(N, tidx.shape[0], generator=gen, device=dev)
    out["text fit batch"] = (tidx, tvals, tmult, td, [(i, v, tmult) for i, v in copies(tidx, tvals)])
    qvals = quarter_grid(gen, tuple(tidx.shape), dev)
    qmult = quarter_grid(gen, (N, tidx.shape[0]), dev, signed=True)
    out["text fit batch, quarter grid"] = (tidx, qvals, qmult, td, None)
    tiny = mask_slots(gen, torch.randint(0, TINY_D, (BATCH, NNZ), generator=gen, device=dev), TINY_D)
    tiny_vals = quarter_grid(gen, (BATCH, NNZ), dev)
    tiny_mult = quarter_grid(gen, (N, BATCH), dev, signed=True)
    out["tiny d"] = (tiny, tiny_vals, tiny_mult, TINY_D,
                     [(i, v, tiny_mult) for i, v in copies(tiny, tiny_vals)])
    big_idx, big_vals = sparse_batch(gen, BATCH + MISALIGNED_OFFSET, NNZ, SPARSE_DIM, dev,
                                     DEFAULT_MASK_SHARE, OUT_OF_RANGE_SHARE)
    sidx, svals = big_idx[MISALIGNED_OFFSET:], big_vals[MISALIGNED_OFFSET:]
    check(sidx.data_ptr() % 16 != 0, "the misaligned slice is aligned")
    smult = torch.randn(N, BATCH, generator=gen, device=dev)
    out["misaligned slice"] = (sidx, svals, smult, SPARSE_DIM,
                               [(i, v, smult) for i, v in copies(big_idx, big_vals, MISALIGNED_OFFSET)])
    return out


def measure_fleet_grad(sk, probes, designs, label, idx, vals, M, d, sets):
    """fleet_grad on one case at N = FLEET_MEMBERS, in both layouts, held
    to its FLEET_GRAD_GATES gate with its replaced design
    (`fmt_red_fleet_grad`, both layouts). Where `sets` is given: CUDA-event
    times of each, of the plain version and of one library call (index_add_ of
    (B * nnz, N) rows into (d, N)), beside the bound from the bytes moved;
    at the fit batch also of N solo launches and of the floor probes
    (RED8_PROBES)."""
    N = FLEET_MEMBERS
    red_fleet_grad = designs[2]
    gen = torch.Generator(device=idx.device)
    gen.manual_seed(19)
    C = torch.randn(N, d, generator=gen, device=idx.device)
    Cm = C.T.contiguous().T  # the fit's layout: member-minor
    gate = FLEET_GRAD_GATES[label]
    want = sk.fleet_grad_plain(idx, vals, M, C)
    bound = (torch.stack([summation_bound(idx, vals, M[m], d) for m in range(N)])
             if gate == "bound" else None)

    def hold(name, got):
        err = (got - want).abs()
        if gate == "exact":
            check(torch.equal(got, want), f"{name} is not exact on {label}'s exact sums: max abs "
                  f"{float(err.max())}")
        elif gate == "bound":
            check(bool((err.double() <= bound).all()),
                  f"{name} exceeds the summation bound on {label}: max abs {float(err.max())}")
        else:
            check(torch.allclose(got, want, **GRAD_TOL),
                  f"{name} disagrees with its plain version on {label}: max abs {float(err.max())}")
        return err

    errs = {}
    for name, fn in (("fleet_grad", sk.fleet_grad), ("fmt_red_fleet_grad", red_fleet_grad)):
        for layout, c in (("member-minor", Cm), ("member-major", C)):
            got = fn(idx, vals, M, c)
            check(got.is_contiguous() == c.is_contiguous(), f"{name}'s layout {got.stride()} is not coeff's")
            errs[(name, layout)] = hold(f"{name} {layout}", got)
    err = torch.maximum(errs[("fleet_grad", "member-minor")], errs[("fleet_grad", "member-major")])
    r = {"case": label, "rows": idx.shape[0], "nnz": idx.shape[1], "d": d, "members": N,
         "max_abs_err": float(err.max()),
         "max_rel_err": float((err / want.abs().clamp_min(1e-6)).max()),
         "tolerance": {"tol": GRAD_TOL, "exact": "exact (quarter-grid sums)",
                       "bound": "per column 2 n_c 2^-24 sum |v m| (summation_bound)"}[gate]}
    if sets is None:
        log(f"  fleet_grad {label} ({N} x {idx.shape[0]} x {idx.shape[1]}, d={d}): exact in both layouts, "
            f"and its replaced design")
        return r
    keep = (idx >= 0) & (idx < d)
    flat_idx = torch.where(keep, idx, 0).long().reshape(-1)
    contrib = torch.where(keep[None], vals[None] * M[:, :, None], 0.0).permute(1, 2, 0).reshape(-1, N)
    lib = torch.zeros((d, N), device=idx.device).index_add_(0, flat_idx, contrib)
    hold("index_add_ yardstick", lib.T)
    b_ms, b_by = bound_ms(idx.numel() * 8 + N * idx.shape[0] * 4 + N * d * 4, 2.0 * N * int(keep.sum()))
    slow = 5 if label == "tiny d" else 30  # the RED design serialises on 7 columns
    r.update({
        "ms": cuda_ms(lambda i, v, m: sk.fleet_grad(i, v, m, Cm), sets),
        "member_major_ms": cuda_ms(lambda i, v, m: sk.fleet_grad(i, v, m, C), sets),
        "enqueue_ms": cuda_ms(lambda i, v, m: sk.fleet_grad(i, v, m, Cm), sets, ahead=False),
        "replaced_ms": cuda_ms(lambda i, v, m: red_fleet_grad(i, v, m, Cm), sets, iters=slow),
        "replaced_member_major_ms": cuda_ms(lambda i, v, m: red_fleet_grad(i, v, m, C), sets, iters=slow),
        "plain_ms": cuda_ms(lambda i, v, m: sk.fleet_grad_plain(i, v, m, C), sets, iters=5),
        "library_ms": cuda_ms(lambda fi, c: torch.zeros((d, N), device=idx.device).index_add_(0, fi, c),
                              [(flat_idx, contrib)], iters=10),
        "bound_ms": b_ms, "bound_by": b_by,
    })
    if label == "fit batch":
        r["solo_n_ms"] = cuda_ms(lambda i, v, m: [sk.sparse_grad(i, v, m[j], C[j]) for j in range(N)], sets)
        red8 = probes[3]
        table = torch.zeros((d, 8), device=idx.device)
        counts = torch.bincount(flat_idx[keep.reshape(-1)], minlength=d).to(torch.float32)
        for form, what in enumerate(RED8_PROBES):
            want_table = counts[:, None].expand(d, 8).clone()
            if form == 1:
                want_table[:, 4:] = 0.0
            check(torch.equal(red8(form, idx, table), want_table), f"the {what} probe's counts disagree")
        r["probe_ms"] = {what: cuda_ms(lambda i, v, m, f=form: red8(f, i, table), sets)
                         for form, what in enumerate(RED8_PROBES)}
    probe = (f"; probes {', '.join(f'{k} {t:.4f} ms' for k, t in r['probe_ms'].items())}"
             if "probe_ms" in r else "")
    solo = f"; {N} solo launches {r['solo_n_ms']:.4f} ms" if "solo_n_ms" in r else ""
    log(f"  fleet_grad {label} ({N} x {idx.shape[0]} x {idx.shape[1]}, d={d}): max_abs_err "
        f"{r['max_abs_err']:.3g}; kernel {r['ms']:.4f} ms member-minor (enqueue-bound "
        f"{r['enqueue_ms']:.4f}), {r['member_major_ms']:.4f} ms member-major; replaced design "
        f"{r['replaced_ms']:.4f} ms member-minor, {r['replaced_member_major_ms']:.4f} ms member-major"
        f"{solo}; plain {r['plain_ms']:.4f} ms, library "
        f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}){probe}")
    return r


def fleet_members(cls, weight_col=None, count=FLEET_MEMBERS):
    """conf/'s LR params on `count` members of FLEET_GRID; the last stops
    at FLEET_SHORT_ITER."""
    members = []
    for i, (lr, reg, en) in enumerate(FLEET_GRID[:count]):
        est = estimator(cls, weight_col, lr).set_reg(reg).set_elastic_net(en)
        members.append(est.set_max_iter(FLEET_SHORT_ITER) if i == count - 1 else est)
    return members


def kmeans_fleet_members():
    return [kmeans_estimator().set_seed(seed).set_max_iter(
        KMEANS_FLEET_SHORT_ITER if i == len(KMEANS_FLEET_SEEDS) - 1 else KMEANS_ITER)
        for i, seed in enumerate(KMEANS_FLEET_SEEDS)]


def fleet_timing(name, fleet_fit, members, table, result):
    """Warm medians of FLEET_REPEATS fleet fits and of as many rounds of
    the members' solo fits, timed the same way."""
    fleets = [synced(fleet_fit)[1] for _ in range(FLEET_REPEATS)]
    solos = [synced(lambda: [m.fit(table) for m in members])[1] for _ in range(FLEET_REPEATS)]
    result.update(fleet_ms=float(np.median(fleets)), solo_fits_ms=float(np.median(solos)),
                  fleet_runs=fleets, solo_runs=solos)
    log(f"  {name}: fleet fit median {result['fleet_ms']:.3f} ms (runs "
        f"{[round(t, 3) for t in fleets]}), {len(members)} solo fits median "
        f"{result['solo_fits_ms']:.3f} ms (runs {[round(t, 3) for t in solos]})")


def max_gap(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def sparse_fleet(sk, sparse_table):
    """The sparse LR fleet on phase 3's table: its launches (only the fleet
    kernels, one each an epoch), each member against the same fleet on the
    plain versions on the card (1e-4 of the coefficients' scale, its loss
    within LOSS_REL_TOL, the same epochs), each member's gap from its solo
    kernel fit, times, peak memory and a profiler pass."""
    from flink_ml_tpu_torch.fleet import FitFleet
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression
    from flink_ml_tpu_torch.ops import losses

    members = lambda: fleet_members(LogisticRegression)  # noqa: E731
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    (models, crit, epochs), fit_ms = synced(lambda: FitFleet(members())._fit_linear(sparse_table))
    counts = sk.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    expected = launch_dict(fleet_row_dots=MAX_ITER, fleet_grad=MAX_ITER)
    log(f"  sparse lr fleet ({FLEET_MEMBERS} members): fit {fit_ms:.1f} ms (first call); launches "
        f"{counts}; epochs {epochs.tolist()}; peak {peak:.3f} GiB above the {held / 2**30:.2f} GiB held")
    check(counts == expected, f"sparse lr fleet launched {counts}, expected {expected}")
    check(epochs.tolist() == [MAX_ITER] * (FLEET_MEMBERS - 1) + [FLEET_SHORT_ITER],
          f"sparse lr fleet epochs {epochs.tolist()}")
    plain = FitFleet(members())._fit_linear(
        sparse_table, losses.fleet_loss("binary_logistic", plain=True))
    solo = [m.fit(sparse_table) for m in members()]
    gaps, scales = sparse_fleet_gate("sparse fleet", (models, crit, epochs), plain, members())
    solo_gaps = [max_gap(got.coefficient, one.coefficient) for got, one in zip(models, solo)]
    log(f"  sparse lr fleet vs the plain-version fleet: max abs gap by member "
        f"{[f'{g:.3g}' for g in gaps]} of max |coeff| {[f'{c:.3g}' for c in scales]}; losses "
        f"{[round(float(c), 6) for c in crit]}")
    log(f"  sparse lr fleet vs each member's solo kernel fit (not gated; atomics): max abs gap by "
        f"member {[f'{g:.3g}' for g in solo_gaps]}")
    result = {"launches": counts, "fit_ms": fit_ms, "peak_gib": peak, "epochs": epochs.tolist(),
              "gap_plain": gaps, "gap_solo": solo_gaps}
    fleet_timing("sparse lr fleet", lambda: FitFleet(members()).fit(sparse_table), members(),
                 sparse_table, result)
    profile_run("sparse lr fleet fit", lambda: FitFleet(members()).fit(sparse_table))
    return models, result


def sparse_fleet_gate(label, fit, plain, members):
    """Phase 10's gate: each member of a sparse fleet `fit` (models,
    criteria, epochs) against the same fleet on the plain versions.
    Returns (max abs gap, coefficient scale) by member."""
    models, crit, epochs = fit
    plain_models, plain_crit, plain_epochs = plain
    gaps, scales = [], []
    for i, (got, ref, est) in enumerate(zip(models, plain_models, members)):
        scale = float(np.max(np.abs(ref.coefficient)))
        gap = max_gap(got.coefficient, ref.coefficient)
        rel = abs(crit[i] - plain_crit[i]) / max(abs(plain_crit[i]), 1e-30)
        gaps.append(gap)
        scales.append(scale)
        # atomics reorder float32 sums: 1e-4 of the coefficients' scale, as
        # the solo sparse fits are held; plus, under an L1 term, one step of
        # it on each side: the proximal step moves a coefficient by
        # lr * elasticNet * reg * sign(coeff), so one that rounding leaves
        # on the other side of 0 lands 2 * lr * elasticNet * reg away
        l1_step = est.get_learning_rate() * est.get_elastic_net() * est.get_reg()
        check(np.isfinite(got.coefficient).all() and gap <= 1e-4 * scale + 2.0 * l1_step,
              f"{label} member {i} differs from the plain-version fleet by {gap} (scale "
              f"{scale}, L1 step {l1_step})")
        check(rel < LOSS_REL_TOL and epochs[i] == plain_epochs[i],
              f"{label} member {i} loss {crit[i]} vs plain {plain_crit[i]}")
    return gaps, scales


def dense_fleet(dense_table, X64, y64, w64):
    """The dense LR fleet (weighted, 10M x 100): each member against a
    float64 replay of its own epochs (1e-3 of the coefficients' scale, the
    same epochs), a refit bit for bit, each member's gap from its solo fit."""
    from flink_ml_tpu_torch.fleet import FitFleet
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression

    members = lambda: fleet_members(LogisticRegression, "weight")  # noqa: E731
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (models, _, epochs), fit_ms = synced(lambda: FitFleet(members())._fit_linear(dense_table))
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    log(f"  dense lr fleet ({FLEET_MEMBERS} members): fit {fit_ms:.1f} ms (first call); epochs "
        f"{epochs.tolist()}; peak {peak:.3f} GiB above the {held / 2**30:.2f} GiB held")
    rels = []
    for i, (model, est) in enumerate(zip(models, members())):
        ref, _, ref_epochs = numpy_reference_sgd(
            lambda k: (X64[k * BATCH:(k + 1) * BATCH], y64[k * BATCH:(k + 1) * BATCH],
                       w64[k * BATCH:(k + 1) * BATCH]),
            DENSE_ROWS // BATCH, est.get_max_iter(), est.get_learning_rate(), TOL, _logistic64,
            est.get_reg(), est.get_elastic_net())
        rel = max_gap(model.coefficient, ref) / float(np.max(np.abs(ref)))
        rels.append(rel)
        check(rel < 1e-3 and epochs[i] == ref_epochs,
              f"dense fleet member {i} differs from its float64 replay by {rel} ({epochs[i]} vs "
              f"{ref_epochs} epochs)")
    refit = FitFleet(members()).fit(dense_table)
    check(all(np.array_equal(a.coefficient, b.coefficient) for a, b in zip(refit, models)),
          "dense lr fleet refit is not bit-identical")
    solo = [m.fit(dense_table) for m in members()]
    solo_gaps = [max_gap(a.coefficient, b.coefficient) for a, b in zip(models, solo)]
    same = [bool(np.array_equal(a.coefficient, b.coefficient)) for a, b in zip(models, solo)]
    log(f"  dense lr fleet vs float64 replays: max rel by member {[f'{r:.3g}' for r in rels]}; "
        f"refit bit for bit; vs solo fits (not gated): max abs gap {[f'{g:.3g}' for g in solo_gaps]}, "
        f"bit-identical {same}")
    result = {"fit_ms": fit_ms, "peak_gib": peak, "epochs": epochs.tolist(), "rel_replay": rels,
              "gap_solo": solo_gaps, "bits_solo": same}
    fleet_timing("dense lr fleet", lambda: FitFleet(members()).fit(dense_table), members(),
                 dense_table, result)
    return models, result


def kmeans_fleet(km_table):
    """The KMeans fleet (1M x 100, k 10; seeds 2-5, the last at maxIter 5):
    each member against a float64 Lloyd from its init rows (1e-3 of the
    centroids' scale), each member's gap from its solo fit."""
    from flink_ml_tpu_torch.fleet import FitFleet
    from flink_ml_tpu_torch.models.clustering import kmeans

    X = km_table.column("features")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    models, fit_ms = synced(lambda: FitFleet(kmeans_fleet_members()).fit(km_table))
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    X64 = X.double()
    errs, solo_gaps, same = [], [], []
    for model, est in zip(models, kmeans_fleet_members()):
        idx = torch.as_tensor(kmeans.init_rows(KMEANS_ROWS, KMEANS_K, est.get_seed()), device=X.device)
        ref_c, ref_counts = lloyd64(X64, X64[idx], est.get_max_iter())
        ref = ref_c.cpu().numpy()
        err = max_gap(model.centroids, ref)
        errs.append(err)
        check(err <= 1e-3 * float(np.max(np.abs(ref))) and model.weights.sum() == KMEANS_ROWS,
              f"kmeans fleet member (seed {est.get_seed()}) differs from its float64 Lloyd by {err}")
        one = est.fit(km_table)
        solo_gaps.append(max_gap(model.centroids, one.centroids))
        same.append(bool(np.array_equal(model.centroids, one.centroids)
                         and np.array_equal(model.weights, one.weights)))
    del X64
    log(f"  kmeans fleet (seeds {list(KMEANS_FLEET_SEEDS)}): fit {fit_ms:.1f} ms (first call); "
        f"peak {peak:.3f} GiB; vs float64 Lloyd max abs {[f'{e:.3g}' for e in errs]}; vs solo fits "
        f"(not gated) max abs gap {[f'{g:.3g}' for g in solo_gaps]}, bit-identical {same}")
    result = {"fit_ms": fit_ms, "peak_gib": peak, "err_lloyd64": errs, "gap_solo": solo_gaps,
              "bits_solo": same}
    fleet_timing("kmeans fleet", lambda: FitFleet(kmeans_fleet_members()).fit(km_table),
                 kmeans_fleet_members(), km_table, result)
    return models, result


def stream_fleet(stream_cols, bounded_table):
    """The stream LR fleet: the stream LR's host rows in uniform chunks of
    BATCH rows, STREAM_FLEET_MEMBERS members, each against the dense fleet's
    member on the rows its epochs train (bits expected, gate 1e-6)."""
    from flink_ml_tpu_torch.fleet import FitFleet
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression

    members = lambda: fleet_members(LogisticRegression, "weight", STREAM_FLEET_MEMBERS)  # noqa: E731
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    models, fit_ms = synced(lambda: FitFleet(members()).fit(stream_of(stream_cols, DENSE_ROWS, BATCH)))
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    bounded = FitFleet(members()).fit(bounded_table)
    rels = [max_gap(a.coefficient, b.coefficient) / float(np.max(np.abs(b.coefficient)))
            for a, b in zip(models, bounded)]
    bits = [bool(np.array_equal(a.coefficient, b.coefficient)) for a, b in zip(models, bounded)]
    log(f"  stream lr fleet ({STREAM_FLEET_MEMBERS} members, {DENSE_ROWS} rows in chunks of {BATCH}, "
        f"stacked on the card once): fit {fit_ms:.1f} ms with the chunks' staging; peak "
        f"{peak:.3f} GiB; vs the dense fleet on its rows: max rel {[f'{r:.3g}' for r in rels]}, "
        f"bit-identical {bits}")
    check(all(r <= 1e-6 for r in rels), f"stream lr fleet differs from the dense fleet by {rels}")
    return {"fit_ms": fit_ms, "peak_gib": peak, "rel_dense": rels, "bits_dense": bits}


#: the committed reference-format fixtures: name -> (input columns, output
#: column, expected values), as tests/test_reference_codecs_all.py and
#: tests/test_reference_format.py expect them; a string column stays on the host
REFERENCE_CASES = {
    "reference_standardscaler_model": ({"input": [[3.0, 6.0]]}, "output", [[1.0, 1.0]]),
    "reference_minmaxscaler_model": ({"input": [[5.0, 20.0]]}, "output", [[0.5, 0.5]]),
    "reference_maxabsscaler_model": ({"input": [[2.0, -4.0]]}, "output", [[0.5, -0.5]]),
    "reference_robustscaler_model": ({"input": [[3.0, 6.0]]}, "output", [[1.0, 1.0]]),
    "reference_idf_model": ({"input": [[2.0, 1.0]]}, "output", [[2.0 * 0.405465, 1.098612]]),
    "reference_imputer_model": ({"a": [float("nan"), 2.0], "b": [3.0, float("nan")]}, "ao",
                                [1.5, 2.0]),
    "reference_kbinsdiscretizer_model": ({"input": [[0.5], [1.5]]}, "output", [[0.0], [1.0]]),
    "reference_stringindexer_model": ({"c": np.array(["a", "b"])}, "ci", [1.0, 0.0]),
    "reference_onehotencoder_model": ({"c": [0.0, 2.0]}, "v", None),
    "reference_vectorindexer_model": ({"input": [[7.0], [5.0]]}, "output", [[1.0], [0.0]]),
    "reference_countvectorizer_model": (None, "output", None),
    "reference_minhashlsh_model": (None, "hashes", None),
    "reference_univariatefeatureselector_model": ({"features": [[1.0, 2.0, 3.0]]}, "output", [[2.0]]),
    "reference_variancethresholdselector_model": ({"input": [[1.0, 2.0, 3.0]]}, "output",
                                                  [[1.0, 3.0]]),
    "reference_naivebayes_model": ({"features": [[0.0], [1.0]]}, "prediction", [10.0, 20.0]),
    "reference_knn_model": ({"features": [[1.0, 1.0], [9.0, 9.0]]}, "prediction", [1.0, 2.0]),
    "reference_kmeans_model": ({"features": [[1.0, 1.0], [9.0, 9.0]]}, "prediction", [0, 1]),
    "reference_lr_pipelinemodel": ({"features": [[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0]]},
                                   "prediction", [1.0, 0.0]),
}


def host_values(col):
    if isinstance(col, torch.Tensor):
        return col.detach().cpu().numpy()
    return np.asarray(col)


def reference_fixture_check(dev, tmp):
    """Every committed tests/fixtures/reference_* directory loads through
    load_stage and transforms a small table on the card to the expected
    values; the loaded model saved as npz and loaded again transforms the
    same, bit for bit."""
    from flink_ml_tpu_torch import SparseBatch, Table
    from flink_ml_tpu_torch.utils import read_write

    dirs = sorted(d for d in os.listdir(REFERENCE_FIXTURES) if d.startswith("reference_"))
    check(sorted(REFERENCE_CASES) == dirs, f"reference fixtures {dirs} vs the cases here")
    for name in dirs:
        cols, out_col, expected = REFERENCE_CASES[name]
        model = read_write.load_stage(os.path.join(REFERENCE_FIXTURES, name))
        if name == "reference_countvectorizer_model":
            tokens = np.empty(1, dtype=object)
            tokens[0] = ["pear", "apple", "pear"]
            table = Table({"input": tokens})
        elif name == "reference_minhashlsh_model":
            check(list(model.rand_coefficient_a) == [1, 2, 3, 4, 5, 6]
                  and list(model.rand_coefficient_b) == [11, 12, 13, 14, 15, 16],
                  "the MinHashLSH fixture's coefficients")
            table = Table({"vec": SparseBatch(10, torch.tensor([[0, 3]], dtype=torch.int32, device=dev),
                                              torch.ones((1, 2), device=dev))})
        else:
            table = Table({k: v if isinstance(v, np.ndarray) else
                           torch.tensor(v, dtype=torch.float32, device=dev) for k, v in cols.items()})
        out = model.transform(table)[0]
        got = out.column(out_col)
        if name == "reference_onehotencoder_model":
            rows = [got.row(i) for i in range(2)]
            ok = (list(rows[0].indices) == [0] and list(rows[0].values) == [1.0]
                  and list(rows[1].indices) == [])
        elif name == "reference_countvectorizer_model":
            row = got.row(0)
            ok = list(row.indices) == [0, 1] and list(row.values) == [1.0, 2.0]
        elif name == "reference_minhashlsh_model":
            ok = len(got) == 1
        else:
            ok = np.allclose(host_values(got).astype(np.float64), np.asarray(expected, np.float64),
                             rtol=1e-6, atol=0)
        if name == "reference_imputer_model":
            ok = ok and np.allclose(host_values(out.column("bo")), [3.0, 9.0])
        check(ok, f"{name} transforms to {host_values(got) if expected is not None else got}")
        path = os.path.join(tmp, name + "_npz")
        model.save(path)
        again = read_write.load_stage(path).transform(table)[0]
        check(same_column(again.column(out_col), got), f"{name} differs after an npz round trip")
    log(f"  {len(dirs)} committed reference-format fixtures load, transform on the card as the "
        f"tests expect, and round-trip through npz bit for bit")
    return len(dirs)


def reference_format_check(sk, dev, tmp, sparse_models, km_models, sparse_table, km_table):
    """A.15 on the card: score the sparse fleet's members by areaUnderROC,
    write the winner and the KMeans fleet's first member in the reference's
    binary layout with the port's encoders, load both through load_stage
    and transform the full tables (the winner on the solo row-dot kernel);
    the predictions equal those of the same model saved and loaded as npz
    bit for bit. Then the committed fixtures."""
    from flink_ml_tpu_torch.models.evaluation.binaryclassification import (
        BinaryClassificationEvaluator)
    from flink_ml_tpu_torch.utils import javacodec, read_write

    evaluator = BinaryClassificationEvaluator().set_metrics_names("areaUnderROC")
    aucs = [float(evaluator.transform(m.transform(sparse_table)[0])[0].collect()[0]["areaUnderROC"])
            for m in sparse_models]
    check(all(np.isfinite(aucs)), f"fleet AUCs {aucs}")
    winner = int(np.argmax(aucs))
    log(f"  sparse fleet areaUnderROC by member {[round(a, 6) for a in aucs]}: winner {winner}")
    written = {}
    for name, model, payload, table, cols in (
            ("winner", sparse_models[winner],
             javacodec.encode_logisticregression_model_data(sparse_models[winner].coefficient, 0),
             sparse_table, ("prediction", "rawPrediction")),
            ("kmeans member 0", km_models[0],
             javacodec.encode_kmeans_model_data(km_models[0].centroids, km_models[0].weights),
             km_table, ("prediction",))):
        ref_path = os.path.join(tmp, name.replace(" ", "_") + "_reference")
        read_write.save_metadata(model, ref_path)
        javacodec.write_reference_data_file(ref_path, payload)
        check(not read_write.model_data_exists(ref_path), "the reference layout holds an npz")
        npz_path = os.path.join(tmp, name.replace(" ", "_") + "_npz")
        model.save(npz_path)
        loaded = read_write.load_stage(ref_path)
        sk.reset_launch_counts()
        out = loaded.transform(table)[0]
        torch.cuda.synchronize()
        counts = sk.launch_counts()
        want = read_write.load_stage(npz_path).transform(table)[0]
        for col in cols:
            check(same_column(out.column(col), want.column(col)),
                  f"{name} from the reference layout predicts {col} unlike its npz twin")
        expected = launch_dict(sparse_row_dots=1) if name == "winner" else launch_dict()
        check(counts == expected, f"{name} transform launched {counts}, expected {expected}")
        written[name] = counts
        log(f"  {name}: reference-layout directory (metadata + data/part-0-0) loads through "
            f"load_stage and transforms {table.num_rows} rows as its npz twin, bit for bit; "
            f"launches {counts}")
    fixtures = reference_fixture_check(dev, tmp)
    return {"aucs": aucs, "winner": winner, "launches": written, "fixtures": fixtures}


def fleet_phase(sk, dev, tmp, tables):
    """Phase 10: the four fleets and the reference-format loader."""
    t0 = time.perf_counter()
    out = {}
    sparse_models, out["sparse lr fleet"] = sparse_fleet(sk, tables["sparse"])
    touched = min(MAX_ITER, DENSE_ROWS // BATCH) * BATCH
    X = tables["dense"].column("features")
    X64 = X[:touched].double().cpu().numpy()
    y64 = tables["dense"].column("label")[:touched].double().cpu().numpy()
    w64 = tables["dense"].column("weight")[:touched].double().cpu().numpy()
    dense_models, out["dense lr fleet"] = dense_fleet(tables["dense"], X64, y64, w64)
    del X64
    km_models, out["kmeans fleet"] = kmeans_fleet(tables["kmeans"])
    out["stream lr fleet"] = stream_fleet(tables["stream_cols"], tables["bounded"])
    out["reference format"] = reference_format_check(
        sk, dev, tmp, sparse_models, km_models, tables["sparse"], tables["kmeans"])
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 10 took {out['seconds']:.2f} s")
    return out, {"sparse": sparse_models, "dense": dense_models}


# -- phase 11: fused transforms ---------------------------------------------------
FUSED_SMALL_ROWS = 1_024
FUSED_REPEATS = 5
#: VectorAssembler's two inputs: the BASELINE width (DIM) split 60/40
ASSEMBLER_SPLIT = 60
#: Bucketizer's splits over the weight column (uniform in [0, 1)), each exact in float32
FUSED_SPLITS = [0.0, 0.25, 0.5, 0.75, 1.0]
#: a fused sparse LR replay against the plain row dot: check_sparse_linear's
#: rawPrediction tolerance
FUSED_PLAIN_TOL = dict(rtol=1e-5, atol=1e-6)
#: a second signature of a segment grows the pool by its own outputs and
#: at most this share of the first capture's temporaries: the graphs share
#: one pool, so the second capture reuses the first one's temporaries (a
#: pool of its own would add them all again)
SECOND_SIGNATURE_TEMP_SHARE = 0.5
ONLINE_SWAPS = 3
ASSEMBLER_NAN = ("Encountered NaN while assembling a row with handleInvalid = 'error'. "
                 "Consider removing NaNs from dataset or using handleInvalid = 'keep' or 'skip'.")


def _fused_gauges():
    from flink_ml_tpu_torch.utils import metrics

    return (metrics.get_gauge("pipeline.fused_segments"),
            metrics.get_gauge("pipeline.fused_stages"))


def _counter(name):
    from flink_ml_tpu_torch.utils import metrics

    return metrics.get_counter(name)


def _eager(pm, table):
    from flink_ml_tpu_torch import config as port_config

    with port_config.pipeline_fusion_mode("off"):
        return pm.transform(table)[0]


def _transform_syncs(fn):
    before = _counter("iteration.host_sync.transform")
    synced(fn)
    return _counter("iteration.host_sync.transform") - before


def _tensor_bytes(col) -> int:
    from flink_ml_tpu_torch import SparseBatch

    if isinstance(col, SparseBatch):
        return _tensor_bytes(col.indices) + _tensor_bytes(col.values)
    return col.numel() * col.element_size() if isinstance(col, torch.Tensor) else 0


def device_span_ms(fn) -> float:
    """The card's time for one call of `fn`, whose only synchronization (if
    any) is at its end: CUDA events around the call after the stream spins
    long enough for the host to enqueue all of it, so no host gap counts."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(max(2 * host_s, MIN_SPIN_S) * SPIN_CYCLES_PER_S))
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def rolled(table):
    """`table` with every row moved down by one, the last first: a second
    batch with the first one's signature and other values in every row."""
    from flink_ml_tpu_torch import SparseBatch, Table

    def roll(col):
        if isinstance(col, SparseBatch):
            return SparseBatch(col.size, torch.roll(col.indices, 1, 0), torch.roll(col.values, 1, 0))
        return torch.roll(col, 1, 0)

    return Table({n: roll(table.column(n)) for n in table.column_names})


def graph_memory(pm):
    """What the captured graphs of `pm`'s fused segments keep, counted
    directly, in bytes: outside the pools each graph's static feed and
    copied constants; inside them the allocator's segments of each fused
    segment's shared pool (outputs and temporaries); and of those the
    graphs' outputs."""
    captured = [run[1].graphs for run in pm._fusion_plan().runs
                if run[0] == "fused" and run[1].graphs.pool is not None]
    segments = torch.cuda.memory._snapshot()["segments"] if captured else []
    static = pool = outputs = 0
    for graphs in captured:
        static += sum(e.static_bytes for e in graphs.entries.values())
        outputs += sum(e.kept_bytes - e.static_bytes for e in graphs.entries.values())
        pool += sum(s["total_size"] for s in segments
                    if tuple(s["segment_pool_id"]) == tuple(graphs.pool))
    return {"static": static, "pool": pool, "outputs": outputs}


def check_second_batch(sk, name, pm, table, first, launches_per_call):
    """A replay on a second batch of the first one's signature: no new
    capture, the replay's launches, and bit for bit the eager transform of
    that batch (a broken copy of the feed into the graph would give the
    first batch's outputs). Returns (the batch, the fused output)."""
    other = rolled(table)
    traces = _counter("jit.traces")
    sk.reset_launch_counts()
    fused = pm.transform(other)[0]
    launches = sk.launch_counts()
    check(_counter("jit.traces") == traces, f"{name}: a second batch of one signature captured")
    check(launches == launches_per_call,
          f"{name}: launches on a second batch {launches}, expected {launches_per_call}")
    eager = _eager(pm, other)
    produced = [c for c in eager.column_names if c not in table.column_names]
    for col in produced:
        check(same_column(fused.column(col), eager.column(col)),
              f"{name}: column {col} of a replay on a second batch differs from eager")
    check(any(not same_column(fused.column(c), first.column(c)) for c in produced),
          f"{name}: a second batch gave the first batch's outputs")
    return other, fused


def fused_path(sk, name, pm, table, gauges, launches_per_call):
    """One fused transform path: the first call (the capture) against a
    fresh plan, a replay, the eager twin (`pipeline_fusion = "off"`), all
    bit for bit; a replay on a second batch of the same signature against
    its eager transform; the launches of each replay; warm medians of
    both; the device's idle share of a warm call of each: its device time
    (the fused call whole, the eager one stage by stage, each stage's guard
    drain at its end; `device_span_ms`) over the warm median wall; the
    memory the captured graph keeps (`graph_memory`). No profiler pass:
    torch.profiler sees no kernel of a replayed graph, and after a capture
    it read no device time for the eager twin either. Returns (result, the
    replay, (second batch, its fused output))."""
    traces = _counter("jit.traces")
    sk.reset_launch_counts()
    first, first_ms = synced(lambda: pm.transform(table)[0])
    first_launches = sk.launch_counts()
    check(_fused_gauges() == gauges, f"{name}: plan gauges {_fused_gauges()}, expected {gauges}")
    memory = graph_memory(pm)
    captures = _counter("jit.traces") - traces
    # a CUDA graph a segment on the card; the CPU counts a new signature alike
    check(captures == gauges[0],
          f"{name}: {captures} captures on the first call")
    sk.reset_launch_counts()
    replay, replay_ms = synced(lambda: pm.transform(table)[0])
    replay_launches = sk.launch_counts()
    check(replay_launches == launches_per_call and first_launches == launches_per_call,
          f"{name}: launches first {first_launches}, replay {replay_launches}, expected "
          f"{launches_per_call} a call")
    eager, eager_ms = synced(lambda: _eager(pm, table))
    produced = [c for c in eager.column_names if c not in table.column_names]
    for col in produced:
        check(same_column(first.column(col), eager.column(col)),
              f"{name}: column {col} of the first fused call differs from eager")
        check(same_column(replay.column(col), eager.column(col)),
              f"{name}: column {col} of a replay differs from eager")
    second = check_second_batch(sk, name, pm, table, first, launches_per_call)
    fused_runs = [synced(lambda: pm.transform(table)[0])[1] for _ in range(FUSED_REPEATS)]
    eager_runs = [synced(lambda: _eager(pm, table))[1] for _ in range(FUSED_REPEATS)]
    check(_counter("jit.traces") == traces + captures, f"{name}: warm calls captured again")
    mib = {k: v / 2**20 for k, v in memory.items()}
    result = {
        "rows": table.num_rows, "gauges": list(gauges), "first_ms": first_ms,
        "first_replay_ms": replay_ms, "eager_first_ms": eager_ms,
        "fused_median_ms": float(np.median(fused_runs)),
        "eager_median_ms": float(np.median(eager_runs)),
        "fused_runs": fused_runs, "eager_runs": eager_runs,
        "graph_static_mib": mib["static"], "graph_pool_mib": mib["pool"],
        "graph_outputs_mib": mib["outputs"], "replay_launches": replay_launches,
    }
    tables = [table]
    for stage in pm.stages:
        tables.append(stage.transform(tables[-1])[0])
    result["fused_device_ms"] = device_span_ms(lambda: pm.transform(table)[0])
    result["eager_device_ms"] = sum(device_span_ms(lambda s=s, t=t: s.transform(t))
                                    for s, t in zip(pm.stages, tables))
    for mode in ("fused", "eager"):
        result[f"{mode}_idle"] = 1.0 - result[f"{mode}_device_ms"] / max(
            result[f"{mode}_median_ms"], 1e-9)
    log(f"  {name}: first (capture) {first_ms:.3f} ms, fused median "
        f"{result['fused_median_ms']:.3f} ms (runs {[round(t, 3) for t in fused_runs]}), eager "
        f"median {result['eager_median_ms']:.3f} ms (runs {[round(t, 3) for t in eager_runs]}); "
        f"the graph keeps {mib['static']:.1f} MiB of static feed and {mib['pool']:.1f} MiB of "
        f"pool ({mib['outputs']:.1f} MiB of it outputs); launches a replay {replay_launches}; "
        f"device time fused {result['fused_device_ms']:.3f} ms ({result['fused_idle']:.1%} of the "
        f"warm median idle), eager {result['eager_device_ms']:.3f} ms "
        f"({result['eager_idle']:.1%} idle); a second batch replayed equal to its eager transform")
    return result, replay, second


def check_second_signature(pm, X_all, w_all, rows):
    """The guarded pipeline on a batch of `rows - FUSED_SMALL_ROWS` rows, a
    second signature of its segment (the last chunk of a stream): it is
    captured into the segment's shared pool, which grows by its outputs
    and less than SECOND_SIGNATURE_TEMP_SHARE of the first capture's
    temporaries, and it replays equal to eager. Returns the memory
    readings, MiB."""
    from flink_ml_tpu_torch import Table

    n = rows - FUSED_SMALL_ROWS
    X = X_all[:n]
    table = Table({"va": X[:, :ASSEMBLER_SPLIT].contiguous(),
                   "vb": X[:, ASSEMBLER_SPLIT:].contiguous(), "raw": w_all[:n]})
    before = graph_memory(pm)
    traces = _counter("jit.traces")
    pm.transform(table)
    after = graph_memory(pm)
    check(_counter("jit.traces") == traces + 1,
          "guarded pipeline: a second signature not captured")
    replay, eager = pm.transform(table)[0], _eager(pm, table)
    for col in eager.column_names:
        check(same_column(replay.column(col), eager.column(col)),
              f"guarded pipeline, second signature: column {col} differs from eager")
    growth = after["pool"] - before["pool"]
    outputs = after["outputs"] - before["outputs"]
    temps = before["pool"] - before["outputs"]
    out = {"rows": n, "pool_first_mib": before["pool"] / 2**20, "temps_first_mib": temps / 2**20,
           "pool_growth_mib": growth / 2**20, "outputs_mib": outputs / 2**20}
    # the CPU captures nothing: no pool to hold to the share
    check(DEVICE != "cuda" or growth - outputs < SECOND_SIGNATURE_TEMP_SHARE * temps,
          f"guarded pipeline: a second signature grew the pool by {out['pool_growth_mib']:.1f} "
          f"MiB, its outputs {out['outputs_mib']:.1f} MiB, the first capture's temporaries "
          f"{out['temps_first_mib']:.1f} MiB")
    log(f"  guarded pipeline, a second signature ({n} rows): the shared pool grew "
        f"{out['pool_growth_mib']:.1f} MiB (its outputs {out['outputs_mib']:.1f} MiB) on the first "
        f"capture's {out['pool_first_mib']:.1f} MiB ({out['temps_first_mib']:.1f} MiB of it "
        f"temporaries); replayed equal to eager")
    return out


def guarded_pipeline(dense_lr, X, w):
    """VectorAssembler (error; the 100 features split 60/40) -> StandardScaler
    (fitted on the assembled rows) -> Normalizer (p 2) -> Bucketizer (error;
    the weight column) -> Binarizer -> the dense LR model on the normalized
    rows: six stages, two of them guarded."""
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.models.classification import logisticregression
    from flink_ml_tpu_torch.models.feature import (binarizer, bucketizer, normalizer,
                                                   standardscaler, vectorassembler)

    scaler = (standardscaler.StandardScaler().set_input_col("assembled").set_output_col("scaled")
              .set_with_mean(True).fit(Table({"assembled": X})))
    lr = logisticregression.LogisticRegressionModel()
    lr.coefficient = dense_lr.coefficient
    lr.set_features_col("norm")
    return [
        vectorassembler.VectorAssembler().set_input_cols("va", "vb").set_output_col("assembled"),
        scaler,
        normalizer.Normalizer().set_p(2.0).set_input_col("scaled").set_output_col("norm"),
        bucketizer.Bucketizer().set_input_cols("raw").set_output_cols("bucket")
        .set_splits_array([FUSED_SPLITS]),
        binarizer.Binarizer().set_input_cols("bucket").set_output_cols("bin").set_thresholds(1.5),
        lr,
    ]


def kernel_stage_cases(dev, rows):
    """Every stage with a transform kernel, alone, on seeded columns born on
    the card: name -> (stage, columns)."""
    from flink_ml_tpu_torch.linalg import Vectors
    from flink_ml_tpu_torch.models.classification import (linearsvc, logisticregression,
                                                          onlinelogisticregression)
    from flink_ml_tpu_torch.models.clustering import kmeans, onlinekmeans
    from flink_ml_tpu_torch.models.feature import (
        binarizer, bucketizer, dct, elementwiseproduct, idf, imputer, interaction,
        kbinsdiscretizer, maxabsscaler, minmaxscaler, normalizer, onehotencoder,
        polynomialexpansion, robustscaler, standardscaler, univariatefeatureselector,
        variancethresholdselector, vectorassembler, vectorslicer)
    from flink_ml_tpu_torch.models.regression import linearregression

    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    rng = np.random.default_rng(23)
    d = 8

    def mat(width=d):
        return torch.randn((rows, width), generator=gen, device=dev)

    def model(cls, **attrs):
        m = cls()
        for k, v in attrs.items():
            setattr(m, k, v)
        return m

    with_nan = torch.randn(rows, generator=gen, device=dev)
    with_nan[::7] = float("nan")
    online_lr = onlinelogisticregression.OnlineLogisticRegressionModel()
    online_lr.publish_model_arrays((rng.standard_normal(d),), 4)
    online_km = onlinekmeans.OnlineKMeansModel()
    online_km.publish_model_arrays((rng.standard_normal((5, d)), np.ones(5)), 2)
    f = {"features": mat()}
    cases = {
        "StandardScalerModel": model(standardscaler.StandardScalerModel,
                                     mean=rng.standard_normal(d), std=rng.random(d) + 0.1),
        "MinMaxScalerModel": model(minmaxscaler.MinMaxScalerModel, min_vector=-rng.random(d),
                                   max_vector=rng.random(d)),
        "MaxAbsScalerModel": model(maxabsscaler.MaxAbsScalerModel, max_abs=rng.random(d) + 0.5),
        "RobustScalerModel": model(robustscaler.RobustScalerModel, medians=rng.standard_normal(d),
                                   ranges=rng.random(d)),
        "Normalizer": normalizer.Normalizer().set_p(3.0),
        "DCT": dct.DCT(),
        "ElementwiseProduct": elementwiseproduct.ElementwiseProduct().set_scaling_vec(
            Vectors.dense(*rng.standard_normal(d))),
        "IDFModel": model(idf.IDFModel, idf=rng.random(d), doc_freq=np.ones(d), num_docs=rows),
        "KBinsDiscretizerModel": model(kbinsdiscretizer.KBinsDiscretizerModel, bin_edges=[
            np.array([-np.inf, -0.5, 0.5, np.inf])] * d),
        "PolynomialExpansion": polynomialexpansion.PolynomialExpansion().set_degree(2),
        "UnivariateFeatureSelectorModel": model(
            univariatefeatureselector.UnivariateFeatureSelectorModel, indices=np.array([5, 1, 2])),
        "VarianceThresholdSelectorModel": model(
            variancethresholdselector.VarianceThresholdSelectorModel, indices=np.array([0, 3, 7])),
        "VectorSlicer": vectorslicer.VectorSlicer().set_indices(6, 2),
        "LinearRegressionModel": model(linearregression.LinearRegressionModel,
                                       coefficient=rng.standard_normal(d)),
        "LogisticRegressionModel": model(logisticregression.LogisticRegressionModel,
                                         coefficient=rng.standard_normal(d)),
        "LinearSVCModel": model(linearsvc.LinearSVCModel, coefficient=rng.standard_normal(d)),
        "KMeansModel": model(kmeans.KMeansModel, centroids=rng.standard_normal((5, d)),
                             weights=np.ones(5)),
        "OnlineKMeansModel": online_km,
        "OnlineLogisticRegressionModel": online_lr,
    }
    out = {}
    for name, stage in cases.items():
        if hasattr(stage, "set_features_col"):
            stage.set_features_col("features")
            if hasattr(stage, "set_prediction_col"):
                stage.set_prediction_col("out")
            else:
                stage.set_output_col("out")
        else:
            stage.set_input_col("features").set_output_col("out")
        out[name] = (stage, f)
    out["Binarizer"] = (binarizer.Binarizer().set_input_cols("a", "b").set_output_cols("oa", "ob")
                        .set_thresholds(0.0, 0.5),
                        {"a": torch.randn(rows, generator=gen, device=dev),
                         "b": torch.rand(rows, generator=gen, device=dev)})
    out["Bucketizer"] = (bucketizer.Bucketizer().set_input_cols("a").set_output_cols("oa")
                         .set_splits_array([[-10.0, -0.5, 0.0, 0.5, 10.0]]),
                         {"a": torch.randn(rows, generator=gen, device=dev)})
    out["ImputerModel"] = (model(imputer.ImputerModel, surrogates={"a": 1.25})
                           .set_input_cols("a").set_output_cols("oa"), {"a": with_nan})
    out["Interaction"] = (interaction.Interaction().set_input_cols("va", "vb").set_output_col("out"),
                          {"va": mat(3), "vb": mat(4)})
    out["OneHotEncoderModel"] = (
        model(onehotencoder.OneHotEncoderModel, category_sizes=np.array([ARITY]))
        .set_input_cols("c").set_output_cols("oc"),
        {"c": torch.randint(0, ARITY, (rows,), generator=gen, device=dev).to(torch.float32)})
    out["VectorAssembler"] = (vectorassembler.VectorAssembler().set_input_cols("va", "vb")
                              .set_output_col("out"), {"va": mat(3), "vb": mat(5)})
    return out


def fusion_phase(sk, dev, runs, sparse_table, dense_table, p_table, held_table):
    """Phase 11: the transform fusion planner on the card. Returns what the
    output lines print."""
    from flink_ml_tpu_torch import PipelineModel, SparseBatch, Table
    from flink_ml_tpu_torch.models.classification import logisticregression

    t_phase = time.perf_counter()
    result = {}
    one = launch_dict(sparse_row_dots=1)

    # 1. the sparse LR model alone in a PipelineModel
    lr_model = runs["sparse lr"]["model"]
    batch = sparse_table.column("features")
    coeff = torch.as_tensor(lr_model.coefficient, dtype=torch.float32, device=dev)
    for rows in (SPARSE_ROWS, FUSED_SMALL_ROWS):
        label = f"{rows} rows"
        table = Table({"features": SparseBatch(batch.size, batch.indices[:rows],
                                               batch.values[:rows])})
        r, replay, (other, again) = fused_path(sk, f"fused sparse lr {label}",
                                               PipelineModel([lr_model]), table, (1, 1), one)
        own = lr_model.transform(table)[0]
        for col in ("prediction", "rawPrediction"):
            check(same_column(replay.column(col), own.column(col)),
                  f"fused sparse lr {label}: {col} differs from the model's own transform")
        # the second batch's replay against phase 2's plain row dot
        feats = other.column("features")
        want = logisticregression._predict_from_dot(
            sk.sparse_row_dots_plain(feats.indices, feats.values, coeff))[1]
        r["second_batch_max_abs_err"] = float(torch.max(torch.abs(again.column("rawPrediction")
                                                                  - want)))
        check(torch.allclose(again.column("rawPrediction"), want, **FUSED_PLAIN_TOL),
              f"fused sparse lr {label}: a second batch's replay differs from the plain row dot "
              f"by {r['second_batch_max_abs_err']:.3g}")
        result[f"sparse lr {label}"] = r

    # 2. the guarded pipeline at the BASELINE width, and a guard-free twin
    dense_lr = runs["dense lr"]["model"]
    X_all, w_all = dense_table.column("features"), dense_table.column("weight")
    stages = guarded_pipeline(dense_lr, X_all[:PIPELINE_ROWS], w_all[:PIPELINE_ROWS])
    for rows in (PIPELINE_ROWS, FUSED_SMALL_ROWS):
        label = f"{rows} rows"
        X = X_all[:rows]
        table = Table({"va": X[:, :ASSEMBLER_SPLIT].contiguous(),
                       "vb": X[:, ASSEMBLER_SPLIT:].contiguous(), "raw": w_all[:rows]})
        pm = PipelineModel(stages)
        r, _, _ = fused_path(sk, f"fused guarded pipeline {label}", pm, table, (1, 6),
                             launch_dict())
        if rows == PIPELINE_ROWS:
            r["second_signature"] = check_second_signature(pm, X_all, w_all, rows)
        r["syncs_fused"] = _transform_syncs(lambda: pm.transform(table))
        r["syncs_eager"] = _transform_syncs(lambda: _eager(pm, table))
        check(r["syncs_fused"] == 1 and r["syncs_eager"] == 2,
              f"guarded pipeline {label}: transform syncs fused {r['syncs_fused']}, eager "
              f"{r['syncs_eager']} (expected 1 and 2)")
        bad_va = table.column("va").clone()
        bad_va[rows // 2, 7] = float("nan")
        bad = table.with_columns({"va": bad_va})
        for mode, call in (("fused", lambda: pm.transform(bad)), ("eager", lambda: _eager(pm, bad))):
            try:
                call()
                raised = None
            except ValueError as e:
                raised = str(e)
            check(raised == ASSEMBLER_NAN,
                  f"guarded pipeline {label}: a planted NaN ({mode}) raised {raised!r}")
        free = PipelineModel(stages[1:3])
        free_table = Table({"assembled": X})
        synced(lambda: free.transform(free_table))
        r["syncs_guard_free"] = _transform_syncs(lambda: free.transform(free_table))
        check(r["syncs_guard_free"] == 0 and _fused_gauges() == (1, 2),
              f"guard-free pipeline {label}: {r['syncs_guard_free']} transform syncs")
        log(f"  guarded pipeline {label}: transform syncs fused {r['syncs_fused']}, eager "
            f"{r['syncs_eager']}, guard-free {r['syncs_guard_free']}; a planted NaN raises "
            f"VectorAssembler's message fused and eager")
        result[f"guarded pipeline {label}"] = r

    # 3. the BASELINE pipeline: vetoed (OneHotEncoder hands VectorAssembler sparse columns)
    baseline = runs["pipeline"]["model"]
    out = baseline.transform(p_table)[0]
    check(_fused_gauges() == (0, 0), f"BASELINE pipeline gauges {_fused_gauges()}")
    off = _eager(baseline, p_table)
    for col in ("prediction", "rawPrediction", "assembled", "scaled"):
        check(same_column(out.column(col), runs["pipeline"]["out"].column(col))
              and same_column(out.column(col), off.column(col)),
              f"BASELINE pipeline: {col} differs from phase 3's")
    log("  BASELINE pipeline: 0 fused segments, outputs equal to phase 3's")

    # 4. the online LR model: versions published between transforms
    online = runs["online lr"]["model"]
    arrays, version = online.model_arrays(), online.model_version
    pm = PipelineModel([online])
    pm.transform(held_table)
    traces = _counter("jit.traces")
    stamped = []
    try:
        for k in range(1, ONLINE_SWAPS + 1):
            online.publish_model_arrays((arrays[0] * (1.0 + 0.1 * k),), version + k)
            out = pm.transform(held_table)[0]
            check(_fused_gauges() == (1, 1), f"online lr: gauges {_fused_gauges()}")
            got = out.column("modelVersion")
            check(bool(torch.all(got == version + k)),
                  f"online lr: rows stamped {torch.unique(got).tolist()}, expected {version + k}")
            own = online.transform(held_table)[0]
            for col in ("prediction", "rawPrediction", "modelVersion"):
                check(same_column(out.column(col), own.column(col)),
                      f"online lr version {version + k}: {col} differs from the eager transform")
            stamped.append(version + k)
        check(_counter("jit.traces") == traces,
              f"online lr: {_counter('jit.traces') - traces} captures across {ONLINE_SWAPS} swaps")
    finally:
        online.publish_model_arrays(arrays, version)
    result["online lr"] = {"versions": stamped, "captures_across_swaps": 0}
    log(f"  online lr: versions {stamped} stamped on every row, no capture across the swaps")

    # 5. every stage with a kernel, alone, captured on the card
    equal = []
    for name, (stage, cols) in kernel_stage_cases(dev, FUSED_SMALL_ROWS).items():
        pm = PipelineModel([stage])
        table = Table(cols)
        first = pm.transform(table)[0]
        check(_fused_gauges() == (1, 1), f"{name}: gauges {_fused_gauges()}")
        replay = pm.transform(table)[0]
        eager = _eager(pm, table)
        for col in eager.column_names:
            if col not in cols:
                check(same_column(first.column(col), eager.column(col))
                      and same_column(replay.column(col), eager.column(col)),
                      f"{name}: fused column {col} differs from eager")
        check_second_batch(sk, name, pm, table, first, launch_dict())
        equal.append(name)
    check(len(equal) == 25, f"{len(equal)} kernel stages checked")
    result["kernel stages"] = equal
    log(f"  the 25 stages with a transform kernel, alone at {FUSED_SMALL_ROWS} rows: "
        "captured, replayed, equal to eager, and replayed on a second batch equal to its eager "
        "transform")
    result["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 11 took {result['seconds']:.2f} s")
    return result


# -- phase 12: serving ---------------------------------------------------------------
SERVE_REQUESTS = 20_000
SERVE_MAX_ROWS = 512
SERVE_BUCKETS = (64, 256, 1024, 4096)
SERVE_ZIPF = 1.1
SERVE_SEED = 23
#: the store's budget holds this many tenants' constants, so traffic pages
SERVE_RESIDENT = 4
#: each tenant's share of the admission queue (16 by default). Fixed
#: batching holds a tenant's requests until their rows fill the largest
#: bucket, which this few requests cannot: its run lifts the quota to that
#: bucket's rows (a request has at least one)
SERVE_QUOTA = 4
#: a refused client's backoff: doubling from the first to the second
SERVE_BACKOFF_S = (100e-6, 2e-3)
SERVE_WAIT_S = 300.0
ONLINE_REQUESTS = 2_000
#: the columns a client keeps of a sparse tenant's result and of the online LR's
SERVE_COLUMNS = ("prediction", "rawPrediction")
ONLINE_COLUMNS = ("prediction", "rawPrediction", "modelVersion")
LIFECYCLE_VERSIONS = 20
LIFECYCLE_CANARY_ROWS = 256
#: the rollback leg's health window
LIFECYCLE_WINDOW = 8


def serve_plan(count, rows_total, tenants, seed):
    """`count` requests (tenant, first row, rows): 1-SERVE_MAX_ROWS rows,
    log-uniform; tenants by Zipf(SERVE_ZIPF)."""
    rng = np.random.default_rng(seed)
    sizes = np.floor(np.exp(rng.uniform(0.0, np.log(SERVE_MAX_ROWS + 1), count))).astype(np.int64)
    sizes = np.clip(sizes, 1, SERVE_MAX_ROWS)
    starts = rng.integers(0, rows_total - SERVE_MAX_ROWS, count)
    weights = 1.0 / np.arange(1, tenants + 1) ** SERVE_ZIPF
    owners = rng.choice(tenants, size=count, p=weights / weights.sum())
    return list(zip(owners.tolist(), starts.tolist(), sizes.tolist()))


def host_column(col):
    return col.cpu().numpy() if isinstance(col, torch.Tensor) else np.asarray(col)


#: the CPU rehearsal's allowance (ROADMAP C.19: on the CPU torch's
#: vectorized math and its scalar tail may put a row an ulp away by its
#: offset in the batch); on the card served rows are held bit for bit
REHEARSAL_MAX_ULP = 2


def same_rows(a, b) -> bool:
    """Served rows against their reference: bit for bit on the card."""
    a, b = np.asarray(a), np.asarray(b)
    if DEVICE == "cuda" or a.dtype.kind != "f":
        return a.shape == b.shape and np.array_equal(a, b)
    return a.shape == b.shape and bool(np.all(np.abs(
        a.astype(np.float32).view(np.int32).astype(np.int64)
        - b.astype(np.float32).view(np.int32).astype(np.int64)) <= REHEARSAL_MAX_ULP))


def push_run(server, plan, make, tenant_of, columns, gate=None):
    """Submit every request of `plan` from a producer thread that backs off
    on ServerOverloaded (and, given `gate`, stops where the trainer stops
    it), consuming the results on this thread, of which it keeps the
    status and `columns` on the host (a client keeps what it asked for).
    Returns ({request index: {"status", column: host array}}, wall ms,
    refusals)."""
    from flink_ml_tpu_torch import flow
    from flink_ml_tpu_torch.serving import ServerOverloaded

    seqs, rejected, errors = [], [0], []

    def produce():
        try:
            for i, req in enumerate(plan):
                table = make(req)
                if gate is not None:
                    gate.wait_open(i)
                deadline, backoff = time.monotonic() + SERVE_WAIT_S, SERVE_BACKOFF_S[0]
                while True:
                    try:
                        seqs.append(server.submit(table, tenant=tenant_of(req)))
                        break
                    except ServerOverloaded:
                        rejected[0] += 1
                        check(time.monotonic() < deadline, f"request {i} was refused for "
                                                           f"{SERVE_WAIT_S} s")
                        time.sleep(backoff)
                        backoff = min(2.0 * backoff, SERVE_BACKOFF_S[1])
                if gate is not None:
                    gate.submitted = i + 1
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)
        finally:
            server.close()

    t0 = time.perf_counter()
    producer = flow.spawn(produce, name="serve.producer")
    results = {}
    for r in server.results():
        kept = {"status": r.status}
        if r.table is not None:
            kept.update((c, host_column(r.table.column(c))) for c in columns)
        results[r.seq] = kept
        if gate is not None:
            gate.retired = len(results)
    wall_ms = (time.perf_counter() - t0) * 1e3
    producer.join(timeout=SERVE_WAIT_S)
    check(not producer.is_alive(), "the producer thread did not finish")
    if errors:
        raise errors[0]
    check(len(results) == len(plan) == len(seqs), f"{len(results)} results of {len(plan)} requests")
    return {i: results[seq] for i, seq in enumerate(seqs)}, wall_ms, rejected[0]


class TrafficGate:
    """Where the online run's producer stops for the trainer: at each stop
    index the producer waits until the trainer has done what it does there
    (a promotion; the rollback leg), so each promotion lands between known
    requests. It counts what was submitted; the consumer counts what
    retired."""

    def __init__(self, stops):
        self.reached = {i: threading.Event() for i in stops}
        self.release = {i: threading.Event() for i in stops}
        self.submitted = self.retired = 0

    def wait_open(self, i):  # the producer, before request i
        if i in self.release:
            self.reached[i].set()
            check(self.release[i].wait(SERVE_WAIT_S), f"traffic was held at request {i}")

    def at(self, i):  # the trainer: the producer stands at stop i
        check(self.reached[i].wait(SERVE_WAIT_S), f"traffic never reached request {i}")

    def drain(self):  # the trainer, traffic stopped: every submitted request retired
        deadline = time.monotonic() + SERVE_WAIT_S
        while self.retired < self.submitted:
            check(time.monotonic() < deadline, "the window never drained")
            time.sleep(0.001)

    def go(self, i):
        self.release[i].set()

    def open_all(self):
        for event in self.release.values():
            event.set()


def serving_counters():
    from flink_ml_tpu_torch.utils import metrics

    return {k: metrics.get_counter(k) for k in ("iteration.host_sync.transform", "serving.coalesced")}


def stage_percentiles(server):
    return {stage: None if p is None else {"p50": p["p50"], "p99": p["p99"], "count": p["count"]}
            for stage, p in server.health().stageLatencyMs.items()}


def bucket_times(sk, pm, idx, vals):
    """Fused against eager warm medians of `pm` at each serving bucket, its
    device time (CUDA events, `device_span_ms`) and idle share."""
    from flink_ml_tpu_torch import SparseBatch, Table

    out = {}
    for bucket in SERVE_BUCKETS:
        table = Table({"features": SparseBatch(SPARSE_DIM, idx[:bucket], vals[:bucket])})
        traces = _counter("jit.traces")
        fused_runs = [synced(lambda: pm.transform(table)[0])[1] for _ in range(FUSED_REPEATS)]
        eager_runs = [synced(lambda: _eager(pm, table))[1] for _ in range(FUSED_REPEATS)]
        check(_counter("jit.traces") == traces, f"a transform at bucket {bucket} captured")
        fused_ms, eager_ms = float(np.median(fused_runs)), float(np.median(eager_runs))
        device = {"fused": device_span_ms(lambda: pm.transform(table)[0]),
                  "eager": device_span_ms(lambda: _eager(pm, table))}
        out[bucket] = {"fused_ms": fused_ms, "eager_ms": eager_ms, "fused_runs": fused_runs,
                       "eager_runs": eager_runs, "fused_device_ms": device["fused"],
                       "eager_device_ms": device["eager"],
                       "fused_idle": 1.0 - device["fused"] / max(fused_ms, 1e-9),
                       "eager_idle": 1.0 - device["eager"] / max(eager_ms, 1e-9)}
        log(f"  bucket {bucket}: fused median {fused_ms:.3f} ms (runs "
            f"{[round(t, 3) for t in fused_runs]}), eager median {eager_ms:.3f} ms (runs "
            f"{[round(t, 3) for t in eager_runs]}); device {device['fused']:.4f} / "
            f"{device['eager']:.4f} ms, idle {out[bucket]['fused_idle']:.1%} / "
            f"{out[bucket]['eager_idle']:.1%}")
    return out


def count_buckets(server):
    """Count the server's staged batches by bucket."""
    from flink_ml_tpu_torch.parallel.prefetch import next_bucket

    counts = {}
    stage = server._stage_batch

    def counted(batch):
        b = next_bucket(batch.num_rows, server.buckets)
        counts[b] = counts.get(b, 0) + 1
        return stage(batch)

    server._stage_batch = counted
    return counts


def watch_store(store, base):
    """Record, at every page-in, the store's ledgered model bytes, and at
    every page-out the fall of torch.cuda.memory_allocated against the
    tenant's constant bytes."""
    from flink_ml_tpu_torch.obs import memledger

    seen = {"peak": 0, "page_ins": 0, "page_outs": []}
    page_in, page_out = store.page_in, store._page_out_locked

    def watched_page_in(key):
        entry = page_in(key)
        seen["peak"] = max(seen["peak"], memledger.live_bytes("model") - base)
        seen["page_ins"] += 1
        return entry

    def watched_page_out(key, entry, count_eviction=True):
        nbytes = entry.dev_nbytes
        before = torch.cuda.memory_allocated()
        page_out(key, entry, count_eviction)
        seen["page_outs"].append((nbytes, before - torch.cuda.memory_allocated()))

    store.page_in, store._page_out_locked = watched_page_in, watched_page_out
    return seen


def serving_phase(sk, dev, sparse_models, sparse_table, online, online_trace, dense_models,
                  held_table):
    """Phase 12: MicroBatchServer, ModelStore and ModelLifecycle on the card.
    Returns what the output lines print."""
    from flink_ml_tpu_torch import PipelineModel, SparseBatch, Table
    from flink_ml_tpu_torch.data.modelstore import ModelStore
    from flink_ml_tpu_torch.models.classification import logisticregression
    from flink_ml_tpu_torch.obs import hist, memledger
    from flink_ml_tpu_torch.serving import MicroBatchServer

    t_phase = time.perf_counter()
    result = {}
    feats = sparse_table.column("features")
    idx_h, vals_h = feats.indices.cpu().numpy(), feats.values.cpu().numpy()
    tenants = [f"tenant{i}" for i in range(len(sparse_models))]
    pms = [PipelineModel([m]) for m in sparse_models]

    # each tenant's own transform of the whole table, and phase 2's plain row dot
    refs, plain = [], []
    for model, pm in zip(sparse_models, pms):
        own = _eager(pm, sparse_table)
        refs.append({c: host_column(own.column(c)) for c in ("prediction", "rawPrediction")})
        coeff = torch.as_tensor(model.coefficient, dtype=torch.float32, device=dev)
        plain.append(host_column(logisticregression._predict_from_dot(
            sk.sparse_row_dots_plain(feats.indices, feats.values, coeff))[1]))
        check(np.allclose(refs[-1]["rawPrediction"], plain[-1], **ROW_DOTS_TOL),
              "a tenant's transform differs from the plain row dot")

    # the store: budget for SERVE_RESIDENT tenants' constants
    memledger_base = memledger.live_bytes("model")
    probe = ModelStore(budget_bytes=None, name="probe")
    probe.register("x", PipelineModel([sparse_models[0]]))
    est = probe.estimated_nbytes("x")
    probe.unregister("x")
    store = ModelStore(budget_bytes=SERVE_RESIDENT * est)
    for key, pm in zip(tenants, pms):
        store.register(key, pm, quota=SERVE_QUOTA)
    base = memledger.live_bytes("model")
    seen = watch_store(store, base)
    log(f"  store: {len(tenants)} tenants of {est} constant bytes each (ledger base "
        f"{memledger_base} -> {base} bytes of other models), budget {store.budget_bytes} bytes "
        f"({SERVE_RESIDENT} tenants)")

    plan = serve_plan(SERVE_REQUESTS, sparse_table.num_rows, len(tenants), SERVE_SEED)
    rows_total = sum(n for _, _, n in plan)

    def make(req):
        _, start, n = req
        return Table({"features": SparseBatch(SPARSE_DIM, idx_h[start:start + n],
                                              vals_h[start:start + n])})

    def tenant_of(req):
        return tenants[req[0]]

    example = make(plan[0])
    warm = MicroBatchServer(store=store, buckets=SERVE_BUCKETS)
    sk.reset_launch_counts()
    warmed = warm.warmup(example)
    warm_launches = sk.launch_counts()
    check(warm_launches == launch_dict(sparse_row_dots=int(warmed["programs"])),
          f"warmup launched {warm_launches} for {warmed['programs']} programs")
    traces = _counter("jit.traces")
    log(f"  warmup: {warmed['programs']:.0f} (tenant x bucket) programs in "
        f"{warmed['warmupMs']:.1f} ms, {warmed['captures']:.0f} captures (one a bucket: the "
        f"tenants share their architecture's graphs)")
    check(warmed["captures"] == len(SERVE_BUCKETS),
          f"warmup captured {warmed['captures']} graphs")

    runs = {}
    for mode in ("pull",) + ("request", "fixed", "continuous"):
        hist.reset()
        before, stats0 = serving_counters(), dict(store.stats)
        sk.reset_launch_counts()
        if mode == "pull":
            server = MicroBatchServer(store=store, buckets=SERVE_BUCKETS)
        else:
            quotas = ({t: SERVE_BUCKETS[-1] for t in tenants} if mode == "fixed" else None)
            server = MicroBatchServer(store=store, buckets=SERVE_BUCKETS, batching=mode,
                                      form_rows=SERVE_BUCKETS[-1], tenant_quotas=quotas)
        by_bucket = count_buckets(server)
        if mode == "pull":
            # a client keeps what it asked for, not the batch's input buffers
            t0 = time.perf_counter()
            served = {i: {c: out.column(c) for c in SERVE_COLUMNS} for i, out in enumerate(
                server.serve((tenant_of(req), make(req)) for req in plan))}
            wall_ms = (time.perf_counter() - t0) * 1e3
            rejected = 0
        else:
            results, wall_ms, rejected = push_run(server, plan, make, tenant_of, SERVE_COLUMNS)
            statuses = sorted({r["status"] for r in results.values()})
            check(statuses == ["ok"], f"{mode}: statuses {statuses}")
            served = results
        counts = sk.launch_counts()
        after = serving_counters()
        dispatched = server.watchdog.samples
        delta = {k: after[k] - before[k] for k in after}
        check(counts == launch_dict(sparse_row_dots=dispatched),
              f"{mode}: launches {counts} for {dispatched} dispatched batches")
        check(delta["iteration.host_sync.transform"] == dispatched,
              f"{mode}: {delta['iteration.host_sync.transform']} transform syncs for "
              f"{dispatched} dispatched batches")
        check(_counter("jit.traces") == traces, f"{mode}: captured after warmup")
        mismatched = []
        for i, (owner, start, n) in enumerate(plan):
            cols = {c: host_column(v) for c, v in served[i].items() if c in SERVE_COLUMNS}
            check(len(cols["prediction"]) == n, f"{mode}: request {i} has "
                                                f"{len(cols['prediction'])} rows of {n}")
            for col in SERVE_COLUMNS:
                if not same_rows(cols[col], refs[owner][col][start:start + n]):
                    mismatched.append((i, col))
            check(np.allclose(cols["rawPrediction"], plain[owner][start:start + n], **ROW_DOTS_TOL),
                  f"{mode}: request {i} differs from the plain row dot")
        check(not mismatched, f"{mode}: {len(mismatched)} served columns differ from their "
                              f"tenant's own transform, first {mismatched[:3]}")
        stats = {k: store.stats[k] - stats0.get(k, 0) if k in ("hits", "misses", "evictions")
                 else store.stats[k] for k in store.stats}
        health = server.health()
        runs[mode] = {
            "requests": len(plan), "rows": rows_total, "wall_ms": wall_ms,
            "requests_per_s": len(plan) / (wall_ms / 1e3), "rows_per_s": rows_total / (wall_ms / 1e3),
            "dispatched": dispatched, "launches": counts["sparse_row_dots"],
            "transform_syncs": delta["iteration.host_sync.transform"],
            "rejected": health.rejected, "producer_backoffs": rejected,
            "expired": health.expired, "coalesced": delta["serving.coalesced"],
            "store": stats, "stages_ms": stage_percentiles(server),
            "buckets_seen": health.bucketsSeen, "batches_by_bucket": dict(sorted(by_bucket.items())),
        }
        log(f"  {mode}: {len(plan)} requests ({rows_total} rows) in {wall_ms:.1f} ms: "
            f"{runs[mode]['requests_per_s']:.0f} requests/s, {runs[mode]['rows_per_s']:.0f} rows/s; "
            f"{dispatched} batches, {counts['sparse_row_dots']} row dots, "
            f"{delta['iteration.host_sync.transform']} transform syncs; rejected "
            f"{health.rejected}, expired {health.expired}, coalesced {delta['serving.coalesced']}; "
            f"store hits {stats['hits']}, misses {stats['misses']}, evictions "
            f"{stats['evictions']}; every row equal to its tenant's own transform; "
            "under the sanitizer")
        log(f"    stages p50/p99 ms: " + "; ".join(
            f"{k} {v['p50']:.3f}/{v['p99']:.3f}" for k, v in runs[mode]["stages_ms"].items() if v))
    check(seen["peak"] <= store.budget_bytes,
          f"the store's ledgered bytes reached {seen['peak']} of a {store.budget_bytes} budget")
    outs = seen["page_outs"]
    check(bool(outs), "traffic never paged a tenant out")
    if DEVICE == "cuda":
        short = [(n, fell) for n, fell in outs if fell < n]
        check(not short, f"{len(short)} of {len(outs)} page-outs freed less than the tenant's "
                         f"constants: {short[:3]}")
    log(f"  store: ledgered model bytes at most {seen['peak']} of {store.budget_bytes} at "
        f"{seen['page_ins']} page-ins; {len(outs)} page-outs, each lowering memory_allocated "
        f"by at least its {outs[0][0]} constant bytes (least fall {min(f for _, f in outs)})")
    result["runs"] = runs
    result["store"] = {"budget": store.budget_bytes, "constant_bytes": est,
                       "peak_ledgered": seen["peak"], "page_ins": seen["page_ins"],
                       "page_outs": len(outs), "least_fall": min(f for _, f in outs)}
    result["buckets"] = bucket_times(sk, pms[0], feats.indices, feats.values)
    for mode, r in runs.items():
        # the run's device time: its batches by bucket, each at its bucket's
        # fused device time (CUDA events)
        r["device_ms"] = sum(n * result["buckets"][b]["fused_device_ms"]
                             for b, n in r["batches_by_bucket"].items())
        r["idle"] = 1.0 - r["device_ms"] / r["wall_ms"]
        log(f"  {mode}: device time {r['device_ms']:.1f} ms of {r['wall_ms']:.1f} ms wall, "
            f"idle {r['idle']:.1%} (batches by bucket {r['batches_by_bucket']})")
    result["launches_by_run"] = {"warmup": warm_launches["sparse_row_dots"],
                                 **{mode: r["launches"] for mode, r in runs.items()}}

    # -- train while serving ------------------------------------------------------
    result["lifecycle"] = lifecycle_soak(sk, dev, online, online_trace, dense_models, held_table)
    result["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 12 took {result['seconds']:.2f} s")
    return result


def row_invariance(dev, X_h, coeff):
    """How many rows of the first m (each serving bucket) get other bits
    than in one product over all rows: a matrix-vector product (`X @ c`,
    which picks its kernel by the row count) against the row-by-row
    reduction the online LR's kernel runs (`sum(X * c, 1)`; ROADMAP C.20)."""
    X = torch.as_tensor(X_h, device=dev)
    c = torch.as_tensor(coeff, device=dev)
    full = {"matvec": X @ c, "row sums": torch.sum(X * c, dim=1)}
    out = {}
    for name, ref in full.items():
        out[name] = {}
        for m in SERVE_BUCKETS:
            part = X[:m] @ c if name == "matvec" else torch.sum(X[:m] * c, dim=1)
            out[name][m] = int(torch.count_nonzero(part != ref[:m]))
    log(f"  rows whose dot differs from the product over all {X.shape[0]} rows, by rows "
        f"batched: {out}")
    return out


def lifecycle_soak(sk, dev, online, trace, dense_models, held_table):
    """Train while serving: `online` (phase 3's FTRL model) in a
    PipelineModel behind a ModelLifecycle, served in continuous mode, while
    a trainer thread promotes LIFECYCLE versions, sends a NaN-poisoned and a
    wrong-shape candidate, reports guard errors until traffic rolls back,
    and promotes the dense fleet's winner by held-out AUC."""
    from flink_ml_tpu_torch import PipelineModel, Table, flow
    from flink_ml_tpu_torch.fleet import promote_fleet_winner
    from flink_ml_tpu_torch.lifecycle import ModelLifecycle, PromotionRejected
    from flink_ml_tpu_torch.models.classification.onlinelogisticregression import (
        OnlineLogisticRegressionModel)
    from flink_ml_tpu_torch.models.evaluation.binaryclassification import (
        BinaryClassificationEvaluator)
    from flink_ml_tpu_torch.serving import MicroBatchServer
    from flink_ml_tpu_torch.utils import metrics

    X_h = held_table.column("features").cpu().numpy()
    arrays0, version0 = online.model_arrays(), online.model_version
    # LIFECYCLE_VERSIONS candidates along the traced FTRL versions (every
    # tenth, then the last): points of that path at even steps
    path = [np.asarray(trace[v], np.float64) for v in sorted(trace)] + [
        np.asarray(arrays0[0], np.float64)]
    candidates = []
    for at in np.linspace(0.0, len(path) - 1, LIFECYCLE_VERSIONS):
        lo, frac = int(np.floor(at)), at - np.floor(at)
        hi = min(lo + 1, len(path) - 1)
        candidates.append((1.0 - frac) * path[lo] + frac * path[hi])
    nan = candidates[6].copy()
    nan[3] = np.nan
    schedule = candidates[:7] + [nan] + candidates[7:13] + [np.ones(DIM + 1)] + candidates[13:]
    evaluator = BinaryClassificationEvaluator().set_metrics_names("areaUnderROC")
    aucs = [float(evaluator.transform(m.transform(held_table)[0])[0].collect()[0]["areaUnderROC"])
            for m in dense_models]
    canary = {"features": X_h[:LIFECYCLE_CANARY_ROWS].astype(np.float32)}
    # the canary's gate accepts any LR output (rtol 1.0): it runs on the card
    # under the capture lock, and the fleet winner, trained on other labels,
    # must pass it
    lc = ModelLifecycle(online, canary=canary, canary_rtol=1.0, health_window=LIFECYCLE_WINDOW)
    pm = PipelineModel([online])
    server = MicroBatchServer(pm, buckets=SERVE_BUCKETS, batching="continuous",
                              form_rows=SERVE_BUCKETS[-1], lifecycle=lc)
    plan = serve_plan(ONLINE_REQUESTS, X_h.shape[0], 1, SERVE_SEED + 1)
    example = Table({"features": X_h[:SERVE_MAX_ROWS]})
    warmed = server.warmup(example)
    traces = _counter("jit.traces")
    rejected0 = metrics.get_counter("lifecycle.promoteRejected")
    coalesced0 = metrics.get_counter("serving.coalesced")
    # a promotion every `step` requests over the first half; the rollback
    # leg and the fleet winner at the middle
    step = max(1, ONLINE_REQUESTS // (2 * len(schedule) + 2))
    stops = [step * (k + 1) for k in range(len(schedule))]
    middle = max(stops[-1] + 1, ONLINE_REQUESTS // 2)
    gate = TrafficGate(stops + [middle])
    published = {version0: np.asarray(arrays0[0], np.float64)}
    events = {"rejected": [], "rollback": None, "winner": None, "errors": []}

    def trainer():
        try:
            for stop, cand in zip(stops, schedule):
                gate.at(stop)
                try:
                    entry = lc.promote((cand,))
                    published[entry.version_id] = entry.arrays[0]
                except PromotionRejected as e:
                    events["rejected"].append(e.reason)
                gate.go(stop)
            gate.at(middle)
            gate.drain()
            good_id = lc.last_good
            kept = {v.version_id: v.arrays[0] for v in lc._ring}
            check(good_id in kept and good_id == online.model_version,
                  f"last-good version {good_id} ({sorted(kept)} retained; published "
                  f"{online.model_version})")
            good = kept[good_id]
            bad = lc.promote((-3.0 * candidates[-1],))
            published[bad.version_id] = bad.arrays[0]
            reports = 0
            while lc.rollback_count == 0 and reports < 4 * LIFECYCLE_WINDOW:
                lc.record_guard_error(ValueError("a guard fired on the served batch"))
                reports += 1
            events["rollback"] = {
                "from": bad.version_id, "to": online.model_version, "last_good": good_id,
                "reports": reports, "quarantined": lc.quarantined,
                "bits": bool(np.array_equal(online.coefficient, good))}
            lc.release_quarantine()
            winner, entry = promote_fleet_winner(lc, dense_models, aucs)
            published[entry.version_id] = entry.arrays[0]
            events["winner"] = {"member": winner, "version": entry.version_id, "auc": aucs[winner]}
        except BaseException as e:  # noqa: BLE001 - raised below
            events["errors"].append(e)
        finally:
            gate.open_all()

    worker = flow.spawn(trainer, name="serve.trainer")

    def make(req):
        _, start, n = req
        return Table({"features": X_h[start:start + n]})

    try:
        results, wall_ms, backoffs = push_run(server, plan, make, lambda req: None,
                                              ONLINE_COLUMNS, gate)
        worker.join(timeout=SERVE_WAIT_S)
        check(not worker.is_alive(), "the trainer thread did not finish")
        if events["errors"]:
            raise events["errors"][0]
        statuses = sorted({r["status"] for r in results.values()})
        check(statuses == ["ok"], f"online: statuses {statuses}")
        check(_counter("jit.traces") == traces, "the soak captured after warmup")
        check(sorted(events["rejected"]) == ["nonfinite", "shape"] and lc.promote_rejected == 2
              and metrics.get_counter("lifecycle.promoteRejected") - rejected0 == 2,
              f"promotions refused {events['rejected']}, counted {lc.promote_rejected}")
        rb = events["rollback"]
        check(rb is not None and rb["to"] == rb["last_good"] and rb["bits"] and rb["quarantined"],
              f"rollback {rb}")
        # every result: one version, equal to that version's eager transform
        by_version = {}
        for i, (_, start, n) in enumerate(plan):
            versions = np.unique(results[i]["modelVersion"])
            check(len(versions) == 1 and int(versions[0]) in published,
                  f"online request {i} stamped {versions}")
            by_version.setdefault(int(versions[0]), []).append(i)
        mismatched = []
        for version, members in by_version.items():
            ref_model = OnlineLogisticRegressionModel()
            ref_model.publish_model_arrays((published[version],), version)
            rows = np.concatenate([X_h[plan[i][1]:plan[i][1] + plan[i][2]] for i in members])
            ref = _eager(PipelineModel([ref_model]), Table({
                "features": torch.as_tensor(rows, dtype=torch.float32, device=dev)}))
            offset = 0
            for i in members:
                n = plan[i][2]
                for col in ONLINE_COLUMNS:
                    want = host_column(ref.column(col))[offset:offset + n]
                    if not same_rows(results[i][col], want):
                        mismatched.append((i, version, col))
                offset += n
        check(not mismatched, f"online: {len(mismatched)} served columns differ from their "
                              f"version's eager transform, first {mismatched[:3]}")
    finally:
        online.publish_model_arrays(arrays0, version0)
    rows_total = sum(n for _, _, n in plan)
    health = server.health()
    invariance = row_invariance(dev, X_h, np.asarray(arrays0[0], np.float32))
    out = {"row_invariance": invariance, "requests": len(plan), "rows": rows_total, "wall_ms": wall_ms,
           "requests_per_s": len(plan) / (wall_ms / 1e3), "rows_per_s": rows_total / (wall_ms / 1e3),
           "versions_served": sorted(by_version), "promoted": len(published) - 1,
           "refused": events["rejected"], "rollback": rb, "winner": events["winner"],
           "warmup_captures": warmed["captures"], "captures_after_warmup": 0,
           "coalesced": metrics.get_counter("serving.coalesced") - coalesced0,
           "rejected": health.rejected,
           "stages_ms": stage_percentiles(server)}
    log(f"  train while serving: {len(plan)} requests ({rows_total} rows) in {wall_ms:.1f} ms, "
        f"{out['requests_per_s']:.0f} requests/s; {len(by_version)} versions served "
        f"{sorted(by_version)}; refused {events['rejected']}; rollback {rb}; fleet winner "
        f"{events['winner']}; every result equal to its version's eager transform; no capture "
        f"after warmup; under the sanitizer")
    return out


# -- phase 13: checkpoint and recovery ----------------------------------------

CKPT_KILL_CHUNK = 7  # the dense leg's kill: after this many drained chunks (epochs)
CKPT_CHILD_CUTS = 2  # the sparse child is killed once it printed this many committed cuts
CKPT_HOSTS = 4  # simulated hosts of the sharded legs
CKPT_STREAM_KILL_EPOCH = 7
CKPT_SHARDED_STREAM_ROWS = 1_000_000  # the sharded stream leg's cut: its cache section is 0.4 GB
CKPT_SHARDED_KILL_EPOCH = 5
CKPT_KMEANS_KILL_EPOCH = 4
CKPT_FLEET_INTERVAL, CKPT_FLEET_KILL_CHUNK = 5, 2
# the sparse fault legs: (site, snapshot hosts, the site's hit that kills,
# the cut left restorable)
CKPT_SPARSE_FAULTS = (("snapshot.write", None, 5, 4),
                      ("snapshot.shard.write", CKPT_HOSTS, 4 * CKPT_HOSTS + 2, 4),
                      ("snapshot.commit", CKPT_HOSTS, 5, 4))
# the supervisor legs: (site, hit, policy, detectors); the commit site pulses
# once a host's shard and once the manifest, so hit 22 is cut 5's host 1
CKPT_SUPERVISOR_LEGS = (
    ("host.hang.dispatch", 8, {"on_hang": "readmit"},
     {"heartbeat_timeout_s": 30.0, "poll_interval_s": 0.01, "stall_safety_s": 120.0}),
    ("host.die.commit", 22, {"on_failure": "shrink"},
     {"heartbeat_timeout_s": 0.25, "poll_interval_s": 0.01, "stall_safety_s": 120.0}),
)
CKPT_CHILD_TIMEOUT_S = 600.0


def carry_template(d):
    """The SGD snapshot's `model` section: (coeff, grad, wsum, epoch)."""
    return {"model": (np.zeros(d, np.float32), np.zeros(d, np.float32), np.float32(0),
                      np.int32(0))}


def snapshot_epoch(path, key, d):
    """The epoch of the newest snapshot of `key` that restores, or None."""
    from flink_ml_tpu_torch.ckpt import snapshot

    snap = snapshot.load_job_snapshot(path, key, templates=carry_template(d))
    return None if snap is None else snap.epoch


def killed(site, after, fn):
    """Run `fn` with a fatal fault armed at `site`'s `after`-th hit: it must
    die there. Returns the wall until the kill, ms."""
    from flink_ml_tpu_torch.ckpt import faults

    t0 = time.perf_counter()
    with faults.inject(site, after=after) as plan:
        try:
            fn()
        except faults.InjectedFault:
            pass
    torch.cuda.synchronize()
    check(plan.fired, f"the fault at {site} (hit {after}) never fired")
    return (time.perf_counter() - t0) * 1e3


def stray_files(path, key):
    """Files of `key` in `path` that no committed state owns: uncommitted
    cuts' shards, temps, a torn single file's temp."""
    from flink_ml_tpu_torch.ckpt import coordinator

    base = coordinator._base(key)
    cuts = set(coordinator.committed_cuts(path, key))
    out = []
    for name in os.listdir(path):
        cut = coordinator._cut_of(name, base)
        if ".tmp" in name or (cut is not None and cut not in cuts):
            out.append(name)
    return out


def cut_meter():
    """The checkpoint spans recorded since the last call: (cuts, bytes a
    cut, ms a cut, restores, ms a restore)."""
    from flink_ml_tpu_torch.obs import tracing

    spans = tracing.drain_ring()
    saves = [s for s in spans if s["name"] == "checkpoint.save"]
    loads = [s for s in spans if s["name"] == "checkpoint.restore"]
    return {
        "cuts": len(saves),
        "bytes_a_cut": float(np.mean([s["attrs"].get("bytes", 0) for s in saves])) if saves else 0.0,
        "ms_a_cut": float(np.mean([s["durUs"] for s in saves])) / 1e3 if saves else 0.0,
        "restores": len(loads),
        "ms_a_restore": float(np.mean([s["durUs"] for s in loads])) / 1e3 if loads else 0.0,
    }


def leg_report(result, name, t0, **extra):
    stats = {"wall_s": time.perf_counter() - t0, **cut_meter(), **extra}
    result[name] = stats
    log(f"  {name}: wall {stats['wall_s']:.2f} s; {stats['cuts']} cuts of "
        f"{stats['bytes_a_cut']:.0f} B, {stats['ms_a_cut']:.3f} ms a cut; {stats['restores']} "
        f"restores, {stats['ms_a_restore']:.3f} ms a restore"
        + "".join(f"; {k} {v}" for k, v in extra.items()) + f" ({result['card']})")
    return stats


def sparse_child(spec_json: str) -> int:
    """The sparse leg's child process: the sparse LR fit, checkpointed every
    epoch into spec["dir"], printing "cut <epoch>" after each committed
    snapshot; the parent SIGKILLs it."""
    from flink_ml_tpu_torch import SparseBatch, Table
    from flink_ml_tpu_torch import config as port_config
    from flink_ml_tpu_torch.ckpt import snapshot
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression

    spec = json.loads(spec_json)
    for name, value in spec["sizes"].items():
        globals()[name] = value
    dev = torch.device(DEVICE)
    save = snapshot.save_job_snapshot

    def announced(*args, **kwargs):
        target = save(*args, **kwargs)
        print(f"cut {kwargs['epoch']}", flush=True)
        return target

    snapshot.save_job_snapshot = announced
    with port_config.use_device(dev), port_config.iteration_checkpointing(spec["dir"]):
        s_idx, s_vals, s_y = sparse_data(dev)
        table = Table({"features": SparseBatch(SPARSE_DIM, s_idx, s_vals), "label": s_y})
        estimator(LogisticRegression).fit(table)
    print("done", flush=True)
    return 0


def preempted_sparse_fit(path):
    """Run the sparse fit in a child process and SIGKILL it once it has
    printed CKPT_CHILD_CUTS committed cuts: a real preemption. Returns the
    cuts it printed."""
    import signal
    import subprocess as sp

    spec = json.dumps({"dir": path, "sizes": {n: globals()[n] for n in (
        "DEVICE", "SPARSE_ROWS", "SPARSE_DIM", "NNZ", "MAX_ITER", "BATCH", "TOL")}})
    here = os.path.dirname(os.path.abspath(__file__))
    proc = sp.Popen([sys.executable, "-c",
                     "import sys, chip_smoke; sys.exit(chip_smoke.sparse_child(sys.argv[1]))", spec],
                    cwd=here, stdout=sp.PIPE, text=True)
    timer = threading.Timer(CKPT_CHILD_TIMEOUT_S, proc.kill)
    timer.start()
    cuts = []
    try:
        for line in proc.stdout:
            if line.startswith("cut "):
                cuts.append(int(line.split()[1]))
                if len(cuts) == CKPT_CHILD_CUTS:
                    os.kill(proc.pid, signal.SIGKILL)
                    break
        proc.wait(timeout=CKPT_CHILD_TIMEOUT_S)
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    check(len(cuts) == CKPT_CHILD_CUTS and proc.returncode == -signal.SIGKILL,
          f"the sparse child printed cuts {cuts} and ended with {proc.returncode}, expected "
          f"{CKPT_CHILD_CUTS} cuts and SIGKILL")
    return cuts


def counted_stream(columns, rows, chunk, reads):
    """A one-shot StreamTable of the first `rows` rows in `chunk`-row host
    Tables, counting the Tables it hands out in reads[0]."""
    from flink_ml_tpu_torch import StreamTable, Table

    def tables():
        for i in range(0, rows, chunk):
            reads[0] += 1
            yield Table({k: v[i:min(i + chunk, rows)] for k, v in columns.items()})

    return StreamTable(tables())


def checkpoint_phase(sk, dev, card, runs, traces, dense_table, sparse_table, stream_cols,
                     km_cols, online_cols, held_table):
    """Phase 13: checkpoint and recovery at phase 3's full widths; every
    resume against its unkilled fit, bit for bit but where the gradient's
    atomics order float32 sums (the sparse and fleet legs: ROADMAP C.21)."""
    import shutil

    from flink_ml_tpu_torch import PipelineModel
    from flink_ml_tpu_torch import config as port_config
    from flink_ml_tpu_torch.ckpt import coordinator, snapshot
    from flink_ml_tpu_torch.fleet import FitFleet
    from flink_ml_tpu_torch.lifecycle import ModelLifecycle
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression
    from flink_ml_tpu_torch.obs import tracing
    from flink_ml_tpu_torch.ops import losses
    from flink_ml_tpu_torch.parallel import supervisor
    from flink_ml_tpu_torch.parallel.iteration import checkpoint_job_key
    from flink_ml_tpu_torch.utils import metrics

    result = {"card": card}
    launches = {}
    t_phase = time.perf_counter()
    tracing.configure(ring_size=1 << 16)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    lr_key = checkpoint_job_key(estimator(LogisticRegression, "weight"))
    sparse_key = checkpoint_job_key(estimator(LogisticRegression))
    try:
        # dense LR (10M x 100, weighted): checkpointed == unchecked; kill, resume
        t0 = time.perf_counter()
        cut_meter()
        want = runs["dense lr"]["model"].coefficient
        path = os.path.join(tmp, "dense")
        with port_config.iteration_checkpointing(path):
            got = estimator(LogisticRegression, "weight").fit(dense_table).coefficient
            check(np.array_equal(got, want), "dense lr: the checkpointed fit differs from phase 3's "
                  "unchecked fit")
            full = cut_meter()
            shutil.rmtree(path)
            killed("chunk", CKPT_KILL_CHUNK,
                   lambda: estimator(LogisticRegression, "weight").fit(dense_table))
            check(snapshot_epoch(path, lr_key, DIM) == CKPT_KILL_CHUNK,
                  "dense lr: the killed fit's newest cut")
            first_ms = killed("chunk", 1,
                              lambda: estimator(LogisticRegression, "weight").fit(dense_table))
            got = estimator(LogisticRegression, "weight").fit(dense_table).coefficient
        check(np.array_equal(got, want), "dense lr: the resumed fit differs from the unkilled fit")
        result["dense lr"] = {**full, "resume_to_first_epoch_ms": first_ms}
        leg_report(result, "dense lr kill-resume", t0, killed_at_epoch=CKPT_KILL_CHUNK,
                   resume_to_first_epoch_ms=round(first_ms, 3), bits="equal")

        # sparse LR (1M x 39, d 1e6, both kernels): a child process SIGKILLed
        t0 = time.perf_counter()
        path = os.path.join(tmp, "sparse")
        cuts = preempted_sparse_fit(path)
        epoch = snapshot_epoch(path, sparse_key, SPARSE_DIM)
        check(epoch is not None and epoch >= cuts[-1], f"sparse lr: the child's newest cut {epoch}")
        with port_config.iteration_checkpointing(path):
            first_ms = killed("chunk", 1, lambda: estimator(LogisticRegression).fit(sparse_table))
            epoch += 1
            sk.reset_launch_counts()
            got = estimator(LogisticRegression).fit(sparse_table).coefficient
            counts = sk.launch_counts()
        launches["checkpoint sparse resume"] = counts
        expected = launch_dict(sparse_row_dots=MAX_ITER - epoch, sparse_grad=MAX_ITER - epoch)
        check(counts == expected, f"sparse lr resume from epoch {epoch} launched {counts}, "
              f"expected {expected}")
        plain = runs["sparse lr"]["plain_coefficient"]
        scale = float(np.max(np.abs(plain)))
        unkilled = runs["sparse lr"]["model"].coefficient
        second = estimator(LogisticRegression).fit(sparse_table).coefficient
        gap_plain, gap_unkilled = max_gap(got, plain), max_gap(got, unkilled)
        gap_two = max_gap(second, unkilled)
        check(gap_plain <= 1e-4 * scale, f"sparse lr resume differs from the plain-loss fit by "
              f"{gap_plain} (scale {scale})")
        leg_report(result, "sparse lr SIGKILL-resume", t0, child_cuts=cuts, resumed_from=epoch,
                   resume_to_first_epoch_ms=round(first_ms, 3),
                   resumed_launches=counts, gap_plain=gap_plain, gap_unkilled=gap_unkilled,
                   gap_two_unkilled_fits=gap_two)
        log(f"  sparse lr (C.21): resumed fit vs the unkilled fit {gap_unkilled:.3g}, two unkilled "
            f"fits {gap_two:.3g}, resumed vs plain {gap_plain:.3g} of max |coeff| {scale:.3g} "
            f"({card})")

        # sparse LR: kills inside a commit leave the previous cut restorable
        t0 = time.perf_counter()
        fault_runs = {}
        for site, hosts, after, restorable in CKPT_SPARSE_FAULTS:
            path = os.path.join(tmp, site)
            with port_config.snapshot_hosts_mode(hosts), port_config.iteration_checkpointing(path):
                killed(site, after, lambda: estimator(LogisticRegression).fit(sparse_table))
                left = snapshot_epoch(path, sparse_key, SPARSE_DIM)
                check(left == restorable, f"sparse lr, kill at {site}: restorable cut {left}, "
                      f"expected {restorable}")
                sk.reset_launch_counts()
                got = estimator(LogisticRegression).fit(sparse_table).coefficient
                launches[f"checkpoint sparse {site}"] = sk.launch_counts()
            gap = max_gap(got, plain)
            check(gap <= 1e-4 * scale, f"sparse lr, kill at {site}: resumed fit off the plain "
                  f"fit by {gap}")
            stray = stray_files(path, sparse_key)
            check(stray == [], f"sparse lr, kill at {site}: stray files {stray}")
            fault_runs[site] = {"restorable": left, "gap_plain": gap}
        # a flipped byte in the newest cut's shard: fall back to the older cut
        cut = coordinator.committed_cuts(path, sparse_key)[-1]
        with open(coordinator.shard_file(path, sparse_key, cut, 0), "r+b") as f:
            f.seek(1000)
            byte = f.read(1)
            f.seek(1000)
            f.write(bytes([byte[0] ^ 0xFF]))
        mismatches = metrics.get_counter("checkpoint.digest.mismatch")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the refused cut's warning is expected
            left = snapshot_epoch(path, sparse_key, SPARSE_DIM)
        check(left == MAX_ITER - 1 and metrics.get_counter("checkpoint.digest.mismatch")
              == mismatches + 1, f"a flipped byte in cut {cut}: restored epoch {left}, "
              f"{metrics.get_counter('checkpoint.digest.mismatch') - mismatches} digest mismatches")
        leg_report(result, "sparse lr commit faults", t0, faults=fault_runs,
                   flipped_byte_fell_back_to=left)

        # stream LR, single file, 10M x 100 in 65,536-row chunks
        t0 = time.perf_counter()
        path = os.path.join(tmp, "stream")

        def stream_fit():
            return estimator(LogisticRegression, "weight").fit(
                stream_of(stream_cols, DENSE_ROWS, STREAM_CHUNK))

        with port_config.iteration_checkpointing(path):
            killed("epoch", CKPT_STREAM_KILL_EPOCH, stream_fit)
            check(snapshot_epoch(path, lr_key, DIM) == CKPT_STREAM_KILL_EPOCH,
                  "stream lr: the killed fit's newest cut")
            got = stream_fit().coefficient
        check(np.array_equal(got, runs["stream lr"]["model"].coefficient),
              "stream lr: the resumed fit differs from phase 3's unkilled fit")
        leg_report(result, "stream lr kill-resume", t0, killed_at_epoch=CKPT_STREAM_KILL_EPOCH,
                   bits="equal")

        # stream LR, sharded with the cache's contents, on the first 1M rows
        t0 = time.perf_counter()
        rows = min(CKPT_SHARDED_STREAM_ROWS, DENSE_ROWS)
        reads = [0]
        want = estimator(LogisticRegression, "weight").fit(
            counted_stream(stream_cols, rows, STREAM_CHUNK, reads)).coefficient
        path = os.path.join(tmp, "stream_sharded")
        reads = [0]
        with port_config.snapshot_hosts_mode(CKPT_HOSTS), port_config.iteration_checkpointing(path):
            killed("epoch", CKPT_SHARDED_KILL_EPOCH, lambda: estimator(LogisticRegression, "weight")
                   .fit(counted_stream(stream_cols, rows, STREAM_CHUNK, reads)))
            first_reads, reads[0] = reads[0], 0
            shard_bytes = metrics.get_counter("checkpoint.shard.bytes")
            restored = metrics.get_counter("devicecache.contents.restored")
            got = estimator(LogisticRegression, "weight").fit(
                counted_stream(stream_cols, rows, STREAM_CHUNK, reads)).coefficient
        segments = metrics.get_counter("devicecache.contents.restored") - restored
        check(reads[0] == 0 and segments == -(-rows // BATCH),
              f"sharded stream lr: the resume read {reads[0]} source batches and restored "
              f"{segments} segments")
        check(np.array_equal(got, want), "sharded stream lr: the resumed fit differs from the "
              "unkilled fit")
        leg_report(result, "sharded stream lr kill-resume", t0, rows=rows, hosts=CKPT_HOSTS,
                   resume_shard_bytes=metrics.get_counter("checkpoint.shard.bytes") - shard_bytes,
                   source_reads_first=first_reads, source_reads_resume=reads[0],
                   segments_restored=segments, bits="equal")

        # out-of-core KMeans (1M x 100, k 10, seed 2)
        t0 = time.perf_counter()
        path = os.path.join(tmp, "kmeans")

        def kmeans_fit():
            return kmeans_estimator().fit(stream_of(km_cols, KMEANS_ROWS, KMEANS_CHUNK))

        with port_config.iteration_checkpointing(path):
            killed("epoch", CKPT_KMEANS_KILL_EPOCH, kmeans_fit)
            got = kmeans_fit()
        want = runs["stream kmeans"]["model"]
        check(np.array_equal(got.centroids, want.centroids) and np.array_equal(got.weights,
                                                                               want.weights),
              "stream kmeans: the resumed fit differs from phase 3's unkilled fit")
        leg_report(result, "stream kmeans kill-resume", t0, killed_at_epoch=CKPT_KMEANS_KILL_EPOCH,
                   bits="equal")

        # online LR (FTRL): killed half way, after version 50 of 100
        t0 = time.perf_counter()
        kill_version = DENSE_ROWS // BATCH // 2
        unkilled = {}
        model = online_lr_estimator().fit(stream_of(online_cols, DENSE_ROWS, STREAM_CHUNK))
        while model.process_updates(1) not in unkilled:
            unkilled[model.model_version] = model.coefficient.copy()
        path = os.path.join(tmp, "online")
        with port_config.iteration_checkpointing(path):
            part = online_lr_estimator().fit(stream_of(online_cols, DENSE_ROWS, STREAM_CHUNK))
            killed("batch", kill_version, part.process_updates)
            check(part.model_version == kill_version - 1,
                  f"online lr: the killed run published version {part.model_version}")
            res = online_lr_estimator().fit(stream_of(online_cols, DENSE_ROWS, STREAM_CHUNK))
            versions = [res.process_updates(1)]
            check(versions[0] == kill_version,
                  f"online lr: the resume republished version {versions[0]}")
            same = [np.array_equal(res.coefficient, unkilled[versions[0]])]
            while True:
                v = res.process_updates(1)
                if v == versions[-1]:
                    break
                versions.append(v)
                same.append(np.array_equal(res.coefficient, unkilled[v]))
        check(versions == list(range(kill_version, max(unkilled) + 1)) and all(same),
              f"online lr: resumed versions {versions[0]}..{versions[-1]}, "
              f"{len(same) - sum(same)} differ from the unkilled run's")
        check(os.listdir(path) == [], "online lr: a completed stream keeps its snapshot")
        leg_report(result, "online lr kill-resume", t0, killed_after_version=kill_version,
                   republished=versions[0], versions_equal=len(same), bits="equal")

        # the sparse fleet: phase 10's 8 members, every 5 epochs, killed after chunk 2
        t0 = time.perf_counter()
        members = lambda: fleet_members(LogisticRegression)  # noqa: E731
        plain_fleet = FitFleet(members())._fit_linear(
            sparse_table, losses.fleet_loss("binary_logistic", plain=True))
        path = os.path.join(tmp, "fleet")
        with port_config.iteration_checkpointing(path, CKPT_FLEET_INTERVAL):
            sk.reset_launch_counts()
            killed("chunk", CKPT_FLEET_KILL_CHUNK, lambda: FitFleet(members()).fit(sparse_table))
            killed_counts = sk.launch_counts()
            sk.reset_launch_counts()
            fit = FitFleet(members())._fit_linear(sparse_table)
            counts = sk.launch_counts()
        launches["checkpoint fleet (killed)"] = killed_counts
        launches["checkpoint fleet resume"] = counts
        done = CKPT_FLEET_INTERVAL * CKPT_FLEET_KILL_CHUNK
        check(killed_counts == launch_dict(fleet_row_dots=done, fleet_grad=done)
              and counts == launch_dict(fleet_row_dots=MAX_ITER - done, fleet_grad=MAX_ITER - done),
              f"fleet: the killed fit launched {killed_counts}, the resume {counts}")
        gaps, scales = sparse_fleet_gate("resumed sparse fleet", fit, plain_fleet, members())
        leg_report(result, "sparse fleet kill-resume", t0, resumed_from=done,
                   launches_killed=killed_counts, launches_resumed=counts,
                   gap_plain=[float(g) for g in gaps])

        # the lifecycle: killed at lifecycle.swap, rebuilt on the directory
        t0 = time.perf_counter()
        online = runs["online lr"]["model"]
        arrays0, version0 = online.model_arrays(), online.model_version
        trace = traces["online lr"]
        path = os.path.join(tmp, "lifecycle")
        pm = PipelineModel([online])
        pm.transform(held_table)
        captures = _counter("jit.traces")

        def served(version, arrays):
            out = pm.transform(held_table)[0]
            own = online.transform(held_table)[0]
            check(bool(torch.all(out.column("modelVersion") == version))
                  and np.array_equal(online.coefficient, arrays[0])
                  and all(same_column(out.column(c), own.column(c))
                          for c in ("prediction", "rawPrediction")),
                  f"lifecycle: a served batch of version {version} is not that version's")

        try:
            lc = ModelLifecycle(online, checkpoint_dir=path, job_key="ckpt-lifecycle")
            good = lc.promote((trace[20],))
            lc.record_serve_ok()
            pending = (np.asarray(trace[30], np.float64),)
            killed("lifecycle.swap", 1, lambda: lc.promote(pending))
            served(good.version_id, good.arrays)  # the server kept the last-good version
            lc2 = ModelLifecycle(online, checkpoint_dir=path, job_key="ckpt-lifecycle")
            check(online.model_version == good.version_id + 1 and lc2.last_good == good.version_id,
                  f"lifecycle: restored version {online.model_version}, last good {lc2.last_good}")
            served(good.version_id + 1, pending)  # the published version, bit for bit
            lc2.rollback("phase 13")
            served(good.version_id, good.arrays)  # the last-good version, bit for bit
            check(_counter("jit.traces") == captures,
                  f"lifecycle: {_counter('jit.traces') - captures} captures after the restore")
        finally:
            online.publish_model_arrays(arrays0, version0)
        leg_report(result, "lifecycle kill-restore", t0, published=good.version_id + 1,
                   last_good=good.version_id, captures=0)

        # the supervisor on the dense LR, 4 simulated hosts
        want = runs["dense lr"]["model"].coefficient
        for site, after, policy, detectors in CKPT_SUPERVISOR_LEGS:
            t0 = time.perf_counter()
            swept = metrics.get_counter("checkpoint.sweep") + metrics.get_counter(
                "supervisor.cutSwept")
            path = os.path.join(tmp, site)
            with port_config.iteration_checkpointing(path), \
                    port_config.snapshot_hosts_mode(CKPT_HOSTS):
                from flink_ml_tpu_torch.ckpt import faults

                with faults.inject(site, after=after) as plan:
                    res = supervisor.supervise(
                        lambda device: estimator(LogisticRegression, "weight").fit(
                            dense_table).coefficient,
                        hosts=CKPT_HOSTS, checkpoint_dir=path, job_key=lr_key, **policy,
                        **detectors)
            (ev,) = res.events
            kind = "collectiveHang" if "hang" in site else "hostFailure"
            check(plan.fired and res.recoveries == 1 and ev.kind == kind
                  and res.hosts == (CKPT_HOSTS if kind == "collectiveHang" else CKPT_HOSTS - 1),
                  f"supervisor at {site}: {res.recoveries} recoveries, {ev.kind}, "
                  f"{res.hosts} hosts")
            check(np.array_equal(res.value, want), f"supervisor at {site}: the recovered fit "
                  "differs from the unkilled fit")
            stray = stray_files(path, lr_key)
            check(stray == [], f"supervisor at {site}: stray files {stray}")
            leg_report(result, f"supervisor {site}", t0, kind=ev.kind, phase=ev.phase,
                       detection_ms=round(ev.detection_ms, 3),
                       recovery_ms=round(ev.recovery_ms, 3), hosts_after=res.hosts,
                       swept=metrics.get_counter("checkpoint.sweep") + metrics.get_counter(
                           "supervisor.cutSwept") - swept, bits="equal")
    finally:
        tracing.configure()
        shutil.rmtree(tmp, ignore_errors=True)
    result["seconds"] = time.perf_counter() - t_phase
    result["launches"] = launches
    log(f"  phase 13 took {result['seconds']:.2f} s ({card})")
    return result


# -- phase 14: the program funnel, the program bank and a traced run ----------------
#: the bank's fresh child serves this many requests (then its first banked fit)
BANK_REQUESTS = 100
BANK_TENANTS = 2
BANK_SEED = 31
BANK_CHILD_TIMEOUT_S = 300.0
#: the sweep's second sparse LR fit: another learning rate and an L2
#: regularisation (elasticNet 0: no L1 step, whose sign flips near zero
#: would need more than the sparse gate), strong enough that a stale
#: learning rate or reg moves the coefficients far past the gate
SWEEP_LR, SWEEP_REG, SWEEP_EN = 0.05, 0.5, 0.0
#: a stale operand must move the sweep's coefficients by this many times
#: the sparse gate
SWEEP_SEPARATION = 100.0


#: the allocator's own rounding on the memory gates: one 2 MiB segment's
#: tail a graph (`FUNNEL_ALLOC_SLACK`), and each block rounded up to 512 B
#: (`FUNNEL_BLOCK_SLACK`); a graph's kept bytes are measured (ROADMAP C.25)
FUNNEL_ALLOC_SLACK = 2 << 20
FUNNEL_BLOCK_SLACK = 512


def static_buffers_of(entry):
    """A fit graph's static input buffers (a borrowed operand has none; the
    CPU's entry, which holds no graph, has none)."""
    return [b for b in getattr(entry, "static_in", ()) if b is not None]


def graph_tensors(entry):
    """A fit graph's own tensors: its static input buffers and its outputs
    in the pool."""
    from flink_ml_tpu_torch.utils import lazyjit

    outputs = lazyjit.flatten(entry.outputs)[0] if hasattr(entry, "outputs") else []
    return static_buffers_of(entry) + outputs


def funnel_slack(entries) -> int:
    """The memory gates' slack for the graphs `entries`: a segment tail
    each and a rounding for each of their blocks (static buffers and
    outputs)."""
    blocks = sum(len(graph_tensors(e)) for e in entries)
    return len(entries) * FUNNEL_ALLOC_SLACK + blocks * FUNNEL_BLOCK_SLACK


def reserve_of(pool, static_in):
    """From the allocator's snapshot: the bytes the graph pool `pool`
    reserves, and the bytes of the default pool's segments whose allocated
    blocks are all static buffers (`static_in`), which dropping the graph
    frees whole."""
    ptrs = {t.data_ptr() for t in static_in}
    pool_total = static_segments = 0
    for seg in torch.cuda.memory._snapshot()["segments"]:
        live = [b["address"] for b in seg["blocks"] if b["state"] == "active_allocated"]
        if tuple(seg["segment_pool_id"]) == tuple(pool):
            pool_total += seg["total_size"]
        elif live and all(a in ptrs for a in live):
            static_segments += seg["total_size"]
    return pool_total, static_segments


def _allocated(fn):
    """fn() with its wall and its memory: what was allocated before it
    (`base`), its allocator peak above that, and what it left allocated
    right after it (`left`) and once the collector has freed its garbage
    (`kept`)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, ms = synced(fn)
    left = torch.cuda.memory_allocated() - base
    gc.collect()
    return out, ms, {"base": base, "peak": torch.cuda.max_memory_allocated() - base,
                     "left": left, "kept": torch.cuda.memory_allocated() - base}


def funnel_fit(name, sk, fit, kernel, arrays, expected, gate, data_bytes):
    """One fit signature three ways: eagerly (`config.whole_fit = "off"`,
    the op-by-op fit that stages its input as the parent tree did), a
    first call through the funnel from an empty cache (a fresh process's:
    it captures), and, after a second capture, a call that replays.
    `arrays` gives the arrays a model holds; `gate(got, want)` checks them
    and returns their gap (0 for bit for bit). Memory, each within the
    allocator's rounding (`funnel_slack`): what the graph holds (the bytes
    freed when the cache drops it) is its measured kept bytes, and these
    are its own static buffers and outputs (accounted by their sizes),
    less than half the fit's training data (`data_bytes`: the data on the
    card is read in place, not copied); the capture leaves no library
    state (the capture stream's, made first, is made with the stream
    once a process); the reserve
    freed by dropping the graph (`memory_reserved`, the cache emptied on
    both sides) is the pool's whole reserve and at most what `make_room`
    counts for the graph (its kept bytes and its pool's scratch) and the
    unsplit tails of its static buffers' segments; the first call's
    allocator peak is at most the eager fit's plus the accounted bytes.
    Returns the walls, the memory, the capture counts and the replay's
    launches."""
    import gc

    from flink_ml_tpu_torch import config as port_config
    from flink_ml_tpu_torch.utils import lazyjit

    lazyjit.capture_stream()  # the stream and its library state: made once a process
    with port_config.whole_fit_mode("off"):
        eager, eager_ms, eager_mem = _allocated(fit)
    kernel.cache.clear()
    traces = _counter("jit.traces")
    first, first_ms, mem = _allocated(fit)
    captured = _counter("jit.traces") - traces
    graphs = list(kernel.cache.entries.values())
    graph_bytes = sum(e.kept_bytes for e in graphs)
    accounted = sum(t.numel() * t.element_size() for e in graphs for t in graph_tensors(e))
    static = [t for e in graphs for t in static_buffers_of(e)]
    static_bytes = sum(t.numel() * t.element_size() for t in static)
    slack = funnel_slack(graphs)
    pool = kernel.cache.pool
    counted = graph_bytes + sum(lazyjit.pool_reserve([pool]).values())
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    pool_total, static_segments = reserve_of(pool, static)
    del graphs, static
    kernel.cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    freed = reserved - torch.cuda.memory_reserved()
    held = mem["kept"] - (torch.cuda.memory_allocated() - mem["base"])
    library = mem["kept"] - held
    tails = max(0, static_segments - static_bytes)
    traces = _counter("jit.traces")
    synced(fit)  # the graph again, for the replay
    recaptured = _counter("jit.traces") - traces
    sk.reset_launch_counts()
    replay, replay_ms, replay_mem = _allocated(fit)
    counts = sk.launch_counts()
    replayed = _counter("jit.traces") - traces - recaptured
    gaps = {"first": gate(arrays(first), arrays(eager)), "replay": gate(arrays(replay), arrays(eager))}
    mib = lambda b: f"{b / 2**20:.1f} MiB"  # noqa: E731
    log(f"  {name}: eager {eager_ms:.3f} ms, first call (capture) {first_ms:.3f} ms "
        f"({first_ms / eager_ms:.2f}x eager), replay {replay_ms:.3f} ms; captures {captured}, "
        f"{recaptured} after the cache was dropped, then {replayed}; replay launches {counts}; gap "
        f"to eager {gaps}; allocator peak eager {mib(eager_mem['peak'])}, first call "
        f"{mib(mem['peak'])}, replay {mib(replay_mem['peak'])}; the first call left "
        f"{mib(mem['left'])} allocated ({mib(mem['kept'])} after a collection), of which the graph "
        f"held {held} bytes (its measured kept bytes {graph_bytes}, accounted {accounted}; slack "
        f"{slack}; training data {mib(data_bytes)}) and library state {library} bytes; dropping "
        f"the graph freed {freed} reserved bytes (its pool's {pool_total}, make_room counts "
        f"{counted}, static segments {static_segments})")
    check(captured == 1 and recaptured == 1 and replayed == 0,
          f"{name}: the first call captured {captured}, the second {recaptured}, the replay "
          f"{replayed}")
    check(counts == expected, f"{name}: the replay launched {counts}, expected {expected}")
    check(abs(held - graph_bytes) <= slack and graph_bytes <= accounted + slack
          and 2 * max(held, graph_bytes) < data_bytes,
          f"{name}: the graph held {held} bytes (measured {graph_bytes}, accounted {accounted}, "
          f"slack {slack}) of {data_bytes} bytes of training data")
    check(library == 0, f"{name}: the capture left {library} bytes of library state")
    check(pool_total <= freed <= counted + tails + slack,
          f"{name}: dropping the graph freed {freed} reserved bytes; its pool reserved "
          f"{pool_total}, make_room counts {counted}, its static segments' tails {tails}")
    check(mem["peak"] <= eager_mem["peak"] + accounted + slack,
          f"{name}: the first call's peak {mem['peak']} against the eager fit's "
          f"{eager_mem['peak']} and the graph's {accounted} accounted bytes")
    return {"eager_ms": eager_ms, "first_ms": first_ms, "replay_ms": replay_ms,
            "captures": [captured, recaptured, replayed], "replay_launches": counts,
            "gap_to_eager": gaps, "peak_bytes": {"eager": eager_mem["peak"], "first": mem["peak"],
                                                 "replay": replay_mem["peak"]},
            "graph_bytes": graph_bytes, "accounted_bytes": accounted, "held_bytes": held,
            "library_bytes": library, "slack_bytes": slack, "reserve_freed": freed,
            "pool_reserve": pool_total, "make_room_bytes": counted,
            "replay": replay}


def _table_bytes(table, *cols):
    """The bytes of a Table's tensor columns (a SparseBatch's indices and
    values)."""
    from flink_ml_tpu_torch import SparseBatch

    total = 0
    for col in cols:
        value = table.column(col)
        parts = (value.indices, value.values) if isinstance(value, SparseBatch) else (value,)
        total += sum(t.numel() * t.element_size() for t in parts)
    return total


def _bits(got, want) -> float:
    """The dense and KMeans gate: every array equal bit for bit."""
    same = all(np.asarray(g).tobytes() == np.asarray(w).tobytes() for g, w in zip(got, want))
    check(same, f"a replay differs from its eager fit (max gap "
          f"{max(max_gap(g, w) for g, w in zip(got, want))})")
    return 0.0


def _sparse_gate(scale):
    """The sparse gate (phase 4, ROADMAP C.21): 1e-4 of the coefficients'
    scale."""
    def gate(got, want):
        gap = max(max_gap(g, w) for g, w in zip(got, want))
        check(gap <= 1e-4 * scale, f"a sparse replay differs by {gap} (scale {scale})")
        return gap
    return gate


def _fleet_gate(members):
    """Phase 10's fleet gate on each member: 1e-4 of its scale plus two of
    its L1 steps."""
    def gate(got, want):
        gaps = []
        for g, w, est in zip(got, want, members):
            scale = float(np.max(np.abs(w)))
            gap = max_gap(g, w)
            l1 = est.get_learning_rate() * est.get_elastic_net() * est.get_reg()
            check(gap <= 1e-4 * scale + 2.0 * l1, f"a fleet member's replay differs by {gap}")
            gaps.append(gap)
        return max(gaps)
    return gate


def _bank_setup(dev, s_idx, s_vals):
    """The bank children's serving: BANK_TENANTS sparse LR tenants (seeded
    coefficients over SPARSE_DIM) in a store, a server over SERVE_BUCKETS,
    an example batch and BANK_REQUESTS (tenant, Table) requests of the
    table's rows."""
    from flink_ml_tpu_torch import PipelineModel, SparseBatch, Table
    from flink_ml_tpu_torch.data.modelstore import ModelStore
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegressionModel
    from flink_ml_tpu_torch.serving import MicroBatchServer

    rng = np.random.default_rng(BANK_SEED)
    store = ModelStore(budget_bytes=None)
    tenants = [f"tenant{i}" for i in range(BANK_TENANTS)]
    for key in tenants:
        model = LogisticRegressionModel()
        model.coefficient = rng.standard_normal(SPARSE_DIM) * 1e-3
        store.register(key, PipelineModel([model]))
    server = MicroBatchServer(store=store, buckets=SERVE_BUCKETS)
    idx_h, vals_h = s_idx.cpu().numpy(), s_vals.cpu().numpy()

    def rows(start, n):
        return Table({"features": SparseBatch(SPARSE_DIM, idx_h[start:start + n],
                                              vals_h[start:start + n])})

    requests = []
    for i in range(BANK_REQUESTS):
        n = int(rng.integers(1, SERVE_MAX_ROWS + 1))
        start = int(rng.integers(0, idx_h.shape[0] - n))
        requests.append((tenants[i % BANK_TENANTS], rows(start, n)))
    return server, rows(0, 64), requests


def bank_child(spec_json: str) -> int:
    """A process of the bank leg: with `config.program_bank_dir` at
    spec["dir"], warm-load the bank (timed). With spec["populate"], fill
    the bank through `ProgramBank.populate` over each tenant's warmup and
    the sparse LR fit; else warm the bank's server up, serve BANK_REQUESTS
    requests, then run the sparse LR fit, counting the captures of each
    step. Prints one JSON line."""
    from flink_ml_tpu_torch import SparseBatch, Table, compilebank
    from flink_ml_tpu_torch import config as port_config
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression
    from flink_ml_tpu_torch.ops import cuda_build
    from flink_ml_tpu_torch.ops import sparsekernels as sk

    spec = json.loads(spec_json)
    for name, value in spec["sizes"].items():
        globals()[name] = tuple(value) if isinstance(value, list) else value
    dev = torch.device(DEVICE)
    if dev.type == "cuda":
        cuda_build.load_all(("sparse_kernels",))
        sk.build()
    out = {}
    with port_config.use_device(dev), port_config.program_bank_mode(spec["dir"]):
        loads = _counter("jit.bankLoads")
        t0 = time.perf_counter()
        bank = compilebank.active_bank()
        out["load_ms"] = (time.perf_counter() - t0) * 1e3
        out["loaded_fits"] = _counter("jit.bankLoads") - loads
        s_idx, s_vals, s_y = sparse_data(dev)
        table = Table({"features": SparseBatch(SPARSE_DIM, s_idx, s_vals), "label": s_y})
        server, example, requests = _bank_setup(dev, s_idx, s_vals)
        if spec.get("populate"):
            programs = [(server.warmup, (example,), {"tenants": [t]})
                        for t in server.store.keys()]
            programs.append((lambda: estimator(LogisticRegression).fit(table), (), None))
            traces = _counter("jit.traces")
            t0 = time.perf_counter()
            out["populated"] = bank.populate(programs)
            out["populate_ms"] = (time.perf_counter() - t0) * 1e3
            out["populate_captures"] = _counter("jit.traces") - traces
            out["programs"] = len(programs)
            out["entries"] = bank.stats()["entries"]
            out["refused"] = _counter("bank.refused")
            print("bank " + json.dumps(out), flush=True)
            return 0
        traces, loads = _counter("jit.traces"), _counter("jit.bankLoads")
        t0 = time.perf_counter()
        warm = server.warmup(example)
        out["warmup_ms"] = (time.perf_counter() - t0) * 1e3
        out["warmup"] = {k: warm[k] for k in ("programs", "captures", "bankHits", "bankMisses",
                                               "bankLoads")}
        traces = _counter("jit.traces")
        served = list(server.serve(iter(requests)))
        out["served"] = len(served)
        out["serve_captures"] = _counter("jit.traces") - traces
        traces, hits = _counter("jit.traces"), _counter("bank.hits")
        t0 = time.perf_counter()
        model = estimator(LogisticRegression).fit(table)  # its readback synchronizes
        out["fit_ms"] = (time.perf_counter() - t0) * 1e3
        out["fit_captures"] = _counter("jit.traces") - traces
        out["fit_bank_hits"] = _counter("bank.hits") - hits
        out["coefficient_finite"] = bool(np.isfinite(model.coefficient).all())
        out["entries"] = bank.stats()["entries"]
        out["refused"] = _counter("bank.refused")
    print("bank " + json.dumps(out), flush=True)
    return 0


def run_bank_child(path, populate=False):
    import subprocess as sp

    spec = json.dumps({"dir": path, "populate": populate, "sizes": {n: globals()[n] for n in (
        "DEVICE", "SPARSE_ROWS", "SPARSE_DIM", "NNZ", "MAX_ITER", "BATCH", "TOL",
        "SERVE_BUCKETS", "SERVE_MAX_ROWS")}})
    here = os.path.dirname(os.path.abspath(__file__))
    proc = sp.run([sys.executable, "-c",
                   "import sys, chip_smoke; sys.exit(chip_smoke.bank_child(sys.argv[1]))", spec],
                  cwd=here, capture_output=True, text=True, timeout=BANK_CHILD_TIMEOUT_S)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("bank ")]
    check(proc.returncode == 0 and len(lines) == 1,
          f"the bank child ended with {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(lines[0][len("bank "):])


def bank_leg(tmp):
    """(c): a child fills a bank (its server's warmup over two tenants and
    the sparse fit's signature); a fresh child loads it and captures
    nothing on its first BANK_REQUESTS requests and its first banked fit;
    a changed fingerprint refuses the bank, a flipped byte one entry, with
    a warning and a `bank.refused` tick each, and neither crashes."""
    import shutil

    from flink_ml_tpu_torch import compilebank

    path = os.path.join(tmp, "bank")
    fill = run_bank_child(path, populate=True)
    fresh = run_bank_child(path)
    segments = len(SERVE_BUCKETS)  # on the CPU a segment's signature is banked all the same
    log(f"  bank: ProgramBank.populate drove {fill['populated']} of {fill['programs']} programs "
        f"({BANK_TENANTS} tenants' warmups and the sparse fit) in {fill['populate_ms']:.1f} ms with "
        f"{fill['populate_captures']} captures, filling {fill['entries']:.0f} entries; a fresh "
        f"process warm-loaded {fresh['loaded_fits']} fit "
        f"signature(s) in {fresh['load_ms']:.1f} ms and {fresh['warmup']['bankLoads']:.0f} serving "
        f"signature(s) in its warmup ({fresh['warmup_ms']:.1f} ms): captures warmup "
        f"{fresh['warmup']['captures']:.0f}, {fresh['served']} requests "
        f"{fresh['serve_captures']}, first fit {fresh['fit_captures']} ({fresh['fit_ms']:.1f} ms, "
        f"{fresh['fit_bank_hits']} bank hit)")
    check(fill["populated"] == fill["programs"] == BANK_TENANTS + 1,
          f"populate drove {fill['populated']} of {fill['programs']} programs")
    check(fill["entries"] == 1 + segments, f"the bank holds {fill['entries']} entries")
    check(fresh["loaded_fits"] == 1 and fresh["warmup"]["bankLoads"] == segments,
          f"the fresh process warm-loaded {fresh['loaded_fits']} fits and "
          f"{fresh['warmup']['bankLoads']} serving signatures")
    check(fresh["warmup"]["captures"] == 0 and fresh["serve_captures"] == 0
          and fresh["fit_captures"] == 0 and fresh["fit_bank_hits"] == 1,
          f"the fresh process captured {fresh}")
    check(fresh["served"] == BANK_REQUESTS and fresh["coefficient_finite"] and fresh["refused"] == 0,
          f"the fresh process served {fresh['served']}")
    out = {"fill": fill, "fresh": fresh}
    # a changed fingerprint refuses the whole bank; a flipped byte one entry
    for case in ("fingerprint", "flipped byte"):
        copy = os.path.join(tmp, f"bank {case}")
        shutil.copytree(path, copy)
        manifest_path = os.path.join(copy, compilebank.MANIFEST)
        manifest = json.load(open(manifest_path))
        # this process's fingerprint (the children's, on the card), changed
        # in one field for the fingerprint case
        manifest["fingerprint"] = compilebank.env_fingerprint()
        if case == "fingerprint":
            manifest["fingerprint"]["kernelSources"] = "0" * 32
        json.dump(manifest, open(manifest_path, "w"))
        if case == "flipped byte":
            record = sorted(manifest["entries"].values(), key=lambda r: r["file"])[0]
            entry = os.path.join(copy, record["file"])
            raw = bytearray(open(entry, "rb").read())
            raw[len(raw) // 2] ^= 0x01
            open(entry, "wb").write(bytes(raw))
        refused = _counter("bank.refused")
        bank = compilebank.ProgramBank(copy, warm_load=False)
        kept, ticks = bank.stats()["entries"], _counter("bank.refused") - refused
        log(f"  bank, {case}: {ticks} refusal(s), {kept:.0f} of {fill['entries']:.0f} entries kept")
        want = 0 if case == "fingerprint" else fill["entries"] - 1
        check(ticks == 1 and kept == want, f"bank {case}: {ticks} refusals, {kept} entries kept")
        out[case] = {"refused": ticks, "kept": kept}
    return out


def traced_run(sk, sparse_table, tmp, card):
    """(d): the sparse LR pipeline's fit and transform from empty program
    caches, with the JSONL span sink and the timeline on: its stage,
    iteration and compile spans with parents that resolve, the report, the
    Chrome export and the JSONL round trip, the dispatch attribution, the
    fit's ledger peak against the allocator's, and a Prometheus snapshot
    without a name collision."""
    from flink_ml_tpu_torch import Pipeline
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression
    from flink_ml_tpu_torch.obs import exporters, memledger, report, timeline, tracing
    from flink_ml_tpu_torch.utils import lazyjit

    lazyjit.forget_graphs()  # a fresh process: the fit and the segment capture
    trace_path = os.path.join(tmp, "trace.jsonl")
    tracing.configure(trace_file=trace_path)
    timeline.configure(ring_size=1 << 16)
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        live, tok = memledger.live_bytes(), memledger.mark_peak()
        model, fit_ms = synced(lambda: Pipeline([estimator(LogisticRegression)]).fit(sparse_table))
        ledger_peak = memledger.peak_since(tok) - live
        alloc_peak = torch.cuda.max_memory_allocated() - base
        out, transform_ms = synced(lambda: model.transform(sparse_table)[0])
        events, truncated = timeline.snapshot_events()
    finally:
        tracing.configure()
        timeline.configure()
    check(bool(torch.isfinite(out.column("rawPrediction")).all()), "the traced transform")
    records, dropped = report.sanitize_records(report.load_trace(trace_path))
    names = {r["name"] for r in records}
    by_id = {r["spanId"] for r in records}
    orphans = [r for r in records if r["parentId"] and r["parentId"] not in by_id]
    log(f"  traced run: fit {fit_ms:.1f} ms, transform {transform_ms:.1f} ms, {len(records)} spans "
        f"({sorted(names)}), {dropped} dropped, {len(orphans)} without a parent")
    for want in ("pipeline.stage", "stage.fit", "stage.transform", "iteration.run", "jit.compile",
                 "pipeline.segment", "readback"):
        check(want in names, f"the trace has no {want} span")
    check(dropped == 0 and not orphans, f"{dropped} dropped, {len(orphans)} orphans")
    text = report.render_report(records)
    check("== Per-stage breakdown ==" in text and "LogisticRegression" in text, "the report")
    log("  report:\n" + "\n".join("    " + line for line in text.splitlines()[:12]))
    dump = os.path.join(tmp, "timeline.jsonl")
    timeline.dump_jsonl(dump, events)
    loaded = timeline.load_events(dump)
    doc = timeline.export_chrome_file(os.path.join(tmp, "timeline.json"), loaded)
    with open(os.path.join(tmp, "timeline.json")) as f:
        check(json.load(f) == doc == timeline.to_chrome(loaded), "the Chrome export")
    key = lambda evs: [(e["ph"], e["lane"], e["name"], e["tsUs"], e.get("ref")) for e in evs]  # noqa: E731
    check(key(loaded) == key(events), "the timeline's JSONL round trip")
    att = timeline.dispatch_attribution(loaded)
    parts = sum(att[k] for k in ("dispatchMs", "deviceMs", "readbackMs", "idleGapMs"))
    log(f"  dispatch attribution: {att['gapCount']} dispatches in {att['windowMs']:.3f} ms: "
        f"dispatch {att['dispatchMs']:.3f}, device {att['deviceMs']:.3f}, readback "
        f"{att['readbackMs']:.3f}, idle gap {att['idleGapMs']:.3f} ms ({len(events)} events, "
        f"{truncated} truncated)")
    check(abs(parts - att["windowMs"]) <= 1e-6 * max(att["windowMs"], 1.0),
          f"the attribution's parts {parts} are not its window {att['windowMs']}")
    untracked = alloc_peak - ledger_peak
    log(f"  fit peak: the ledger {ledger_peak / 2**20:.1f} MiB, the allocator "
        f"{alloc_peak / 2**20:.1f} MiB; untracked by the ledger {untracked / 2**20:.1f} MiB "
        f"(temporaries and graph pools) ({card})")
    check(0 < ledger_peak and (DEVICE != "cuda" or ledger_peak <= alloc_peak),
          f"the ledger's fit peak {ledger_peak} against the allocator's {alloc_peak}")
    prom = exporters.snapshot_prometheus()  # raises on a name collision
    check("flink_ml_tpu_jit_traces_total" in prom, "the Prometheus snapshot")
    return {"spans": len(records), "names": sorted(names), "fit_ms": fit_ms,
            "transform_ms": transform_ms, "attribution": {k: v for k, v in att.items()
                                                          if k != "chunks"},
            "ledger_peak_bytes": ledger_peak, "allocator_peak_bytes": alloc_peak,
            "untracked_bytes": untracked, "prometheus_lines": prom.count("\n")}


def moved_data_leg(sgd_kernel, sparse_table, sparse_fit, first_fit, scale):
    """The sparse fit's data at other addresses (a copy of its table), as a
    pipeline stage's fresh output comes: the signature's graph reads its
    data at home, so a fit of the copy runs eagerly (no capture, no new
    graph) within the sparse gate of the eager fit, and the original
    data still replays its graph."""
    from flink_ml_tpu_torch import SparseBatch, Table
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression

    col = sparse_table.column("features")
    moved = Table({"features": SparseBatch(col.size, col.indices.clone(), col.values.clone()),
                   "label": sparse_table.column("label").clone()})
    moved_fit = lambda: estimator(LogisticRegression).fit(moved)  # noqa: E731
    captures, gaps, replays = [], [], []
    graphs = len(sgd_kernel.cache.entries)
    for fit in (moved_fit, sparse_fit, moved_fit):
        traces = _counter("jit.traces")
        stamps = {id(e): e.stamp for e in sgd_kernel.cache.entries.values()}
        gaps.append(max_gap(fit().coefficient, first_fit))
        captures.append(_counter("jit.traces") - traces)
        replays.append(sum(e.stamp != stamps.get(id(e)) for e in sgd_kernel.cache.entries.values()))
    log(f"  the sparse fit's data at other addresses (the copy, the original, the copy "
        f"again): captures {captures}, graphs replayed {replays}, graphs {graphs} then "
        f"{len(sgd_kernel.cache.entries)}; gaps to the eager fit {[f'{g:.3g}' for g in gaps]} "
        f"against the sparse gate {1e-4 * scale:.3g}")
    # the CPU borrows nothing: every call runs the function, and a call of a
    # known signature counts as a replay
    want = [0, 1, 0] if DEVICE == "cuda" else [1, 1, 1]
    check(captures == [0, 0, 0] and replays == want and len(sgd_kernel.cache.entries) == graphs,
          f"data at other addresses: captures {captures}, replays {replays}")
    check(max(gaps) <= 1e-4 * scale, f"a fit at other addresses differs by {max(gaps)}")
    return {"captures": captures, "replays": replays, "gaps": gaps}


def funnel_phase(sk, dev, card, dense_table, sparse_table, km_table, tmp):
    """Phase 14: the whole fits through the program funnel (eager, first
    call, replay), a sweep, the program bank across processes, and a
    traced run. Returns the phase's results and its launches by path."""
    from flink_ml_tpu_torch import config as port_config
    from flink_ml_tpu_torch.fleet import FitFleet
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression
    from flink_ml_tpu_torch.models.clustering import kmeans
    from flink_ml_tpu_torch.ops import optimizer

    t_phase = time.perf_counter()
    result, launches = {}, {}
    coeff = lambda m: (m.coefficient,)  # noqa: E731
    sgd_kernel = optimizer._sgd_train_flat.kernel
    dense_bytes = _table_bytes(dense_table, "features")
    sparse_bytes = _table_bytes(sparse_table, "features")
    dense = funnel_fit("dense lr", sk, lambda: estimator(LogisticRegression, "weight").fit(
        dense_table), sgd_kernel, coeff, launch_dict(), _bits, dense_bytes)
    sparse_fit = lambda: estimator(LogisticRegression).fit(sparse_table)  # noqa: E731
    with port_config.whole_fit_mode("off"):
        first_fit = sparse_fit().coefficient
    scale = float(np.max(np.abs(first_fit)))
    sparse = funnel_fit("sparse lr", sk, sparse_fit, sgd_kernel, coeff,
                        launch_dict(sparse_row_dots=MAX_ITER, sparse_grad=MAX_ITER),
                        _sparse_gate(scale), sparse_bytes)
    km = funnel_fit("kmeans", sk, lambda: kmeans_estimator().fit(km_table),
                    kmeans._lloyd_train.kernel, lambda m: (m.centroids, m.weights), launch_dict(),
                    _bits, _table_bytes(km_table, "features"))
    members = fleet_members(LogisticRegression)
    fleet = funnel_fit("sparse lr fleet", sk, lambda: FitFleet(fleet_members(
        LogisticRegression)).fit(sparse_table), optimizer._sgd_fleet_whole_fit.kernel,
        lambda models: tuple(m.coefficient for m in models),
        launch_dict(fleet_row_dots=MAX_ITER, fleet_grad=MAX_ITER), _fleet_gate(members),
        sparse_bytes)
    for name, r in (("dense lr", dense), ("sparse lr", sparse), ("kmeans", km),
                    ("sparse lr fleet", fleet)):
        r.pop("replay")
        result[name] = r
        launches[f"funnel {name} (a replay)"] = r["replay_launches"]

    # (b) a sweep: another learning rate and regularisation replays the graph
    def sweep_fit(reg=SWEEP_REG):
        return estimator(LogisticRegression, None, SWEEP_LR).set_reg(reg).set_elastic_net(
            SWEEP_EN).fit(sparse_table)

    traces = _counter("jit.traces")
    sk.reset_launch_counts()
    swept, sweep_ms = synced(sweep_fit)
    launches["funnel sparse lr sweep (a replay)"] = sk.launch_counts()
    sweep_captures = _counter("jit.traces") - traces
    with port_config.whole_fit_mode("off"):
        sweep_eager = sweep_fit().coefficient
        stale_reg = sweep_fit(reg=0.0).coefficient  # the sweep's lr with the first fit's reg
    sweep_scale = float(np.max(np.abs(sweep_eager)))
    limit = 1e-4 * sweep_scale  # the sparse gate
    sweep_gap = max_gap(swept.coefficient, sweep_eager)
    # what a replay that kept the first fit's operands would be off by
    stale = {"all": max_gap(first_fit, sweep_eager), "reg": max_gap(stale_reg, sweep_eager)}
    log(f"  sweep (lr {SWEEP_LR}, reg {SWEEP_REG}, elasticNet {SWEEP_EN}): {sweep_ms:.3f} ms, "
        f"{sweep_captures} captures, gap to its eager fit {sweep_gap:.3g} against the sparse "
        f"gate {limit:.3g} (max |coeff| {sweep_scale:.3g}); a stale operand would be off by "
        f"{stale['all']:.3g} (the first fit's lr and reg), {stale['reg']:.3g} (its reg)")
    check(sweep_captures == 0, f"the sweep captured {sweep_captures}")
    check(sweep_gap <= limit, f"the sweep's fit differs by {sweep_gap} (gate {limit})")
    check(min(stale.values()) >= SWEEP_SEPARATION * limit,
          f"the sweep cannot tell a stale operand: {stale} against the gate {limit}")
    result["sweep"] = {"ms": sweep_ms, "captures": sweep_captures, "gap_to_eager": sweep_gap,
                       "gate": limit, "scale": sweep_scale, "stale_gaps": stale}
    result["moved"] = moved_data_leg(sgd_kernel, sparse_table, sparse_fit, first_fit, scale)

    # the card's idle share of a replayed fit: CUDA events, and the profiler
    for name, fit in (("sparse lr", sparse_fit), ("dense lr", lambda: estimator(
            LogisticRegression, "weight").fit(dense_table))):
        wall = float(np.median([synced(fit)[1] for _ in range(3)]))
        device = device_span_ms(fit)
        result[name]["replay_median_ms"] = wall
        result[name]["replay_device_ms"] = device
        result[name]["replay_idle"] = 1.0 - device / wall
        log(f"  {name} replay: median {wall:.3f} ms, device {device:.3f} ms (CUDA events), idle "
            f"{100.0 * (1.0 - device / wall):.1f}% ({card})")

    with tempfile.TemporaryDirectory(dir=tmp) as bank_tmp:
        result["bank"] = bank_leg(bank_tmp)
    with tempfile.TemporaryDirectory(dir=tmp) as trace_tmp:
        result["traced"] = traced_run(sk, sparse_table, trace_tmp, card)
    # last: a profiler pass once left the next device span wrong (phase 11);
    # traceprof's idle share of each replayed fit
    for name, fit in (("dense lr", lambda: estimator(LogisticRegression, "weight").fit(
            dense_table)), ("sparse lr", sparse_fit), ("kmeans", lambda: kmeans_estimator().fit(
            km_table)), ("sparse lr fleet", lambda: FitFleet(fleet_members(
            LogisticRegression)).fit(sparse_table))):
        result[name]["replay_profile"] = profile_run(f"replayed {name} fit", fit)
    result["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 14 took {result['seconds']:.2f} s")
    return result, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; the port's kernels run only on the card",
              file=sys.stderr)
        return 2

    from flink_ml_tpu_torch import SparseBatch, Table
    from flink_ml_tpu_torch import config as port_config
    from flink_ml_tpu_torch.analysis import sanitizer
    from flink_ml_tpu_torch.models.classification import logisticregression
    from flink_ml_tpu_torch.ops import cuda_build
    from flink_ml_tpu_torch.ops import sparsekernels as sk

    # every phase runs under the concurrency sanitizer; its verdict is read
    # after phase 14, so no exit hook of its own
    sanitizer.enable(register_atexit=False)

    dev = torch.device(DEVICE)
    # parity checks cover every float32 matmul: keep TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 1. device and build ----------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    check(bool(smi), "nvidia-smi reported no card")
    card = smi[0].strip()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} ({card}), allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    t0 = time.perf_counter()
    cuda_sources = ("sparse_kernels", "sgd_epoch", "probes", "designs")
    cuda_build.load_all(cuda_sources)
    sk.build()
    build_s = time.perf_counter() - t0
    log(f"build: {', '.join(f'{n}.cu' for n in cuda_sources)} (one nvcc each, started "
        f"together) in {build_s:.2f} s")
    for name in cuda_sources:
        for kernel, usage in resource_usage(cuda_build, name).items():
            log(f"  registers {name} {kernel}: {usage}")
    shared_atomics = check_sass(cuda_build)
    probes = load_probes(cuda_build)
    designs = load_designs(cuda_build, sk)

    # -- 2. kernels against their plain versions ------------------------
    log("phase 2: kernels vs plain versions")
    edge_phase(sk, dev)
    kernel_results = kernel_phase(sk, probes, designs, dev)
    fleet_kernel_results = fleet_kernel_phase(sk, probes, designs, dev)
    log("phase 2: the SGD engine's epoch kernels vs plain versions")
    sgd_epoch_phase(dev)

    # -- 3. the main path -------------------------------------------------
    log("phase 3: main paths (launch counts reset before and read after each)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    X = torch.rand((DENSE_ROWS, DIM), generator=gen, device=dev)
    y = torch.randint(0, 2, (DENSE_ROWS,), generator=gen, device=dev).to(torch.float32)
    w = torch.rand((DENSE_ROWS,), generator=gen, device=dev)
    dense_table = Table({"features": X, "label": y, "weight": w})
    s_idx, s_vals, s_y = sparse_data(dev)
    sparse_table = Table({"features": SparseBatch(SPARSE_DIM, s_idx, s_vals), "label": s_y})
    km_table = Table({"features": kmeans_data(dev)})
    p_table = pipeline_data(dev)
    t0 = time.perf_counter()
    stream_cols = stream_lr_data()
    bounded_table = device_table(stream_cols, MAX_ITER * BATCH, dev)
    km_cols = {"features": km_table.column("features").cpu().numpy()}
    truth = np.random.default_rng(ONLINE_SEED).standard_normal(DIM).astype(np.float32)
    online_cols = planted_rows(ONLINE_SEED, DENSE_ROWS, truth)
    held_table = device_table(planted_rows(HELD_OUT_SEED, BATCH, truth), BATCH, dev)
    torch.cuda.synchronize()
    log(f"  host data of the stream and online paths made in {time.perf_counter() - t0:.2f} s")
    default_budget = port_config.datacache_memory_budget_bytes
    port_config.datacache_memory_budget_bytes = STREAM_CACHE_BUDGET

    # name -> (fit, table, launches expected of (sparse_row_dots, sparse_grad))
    sparse_launches = launch_dict(sparse_row_dots=MAX_ITER + 2, sparse_grad=MAX_ITER)
    no_launches = launch_dict()
    paths = {}
    for name, (_, _, _, lr, _) in LINEAR_PATHS.items():
        cls = linear_class(name)
        paths[f"dense {name}"] = (lambda c=cls, r=lr: estimator(c, "weight", r).fit(dense_table),
                                  dense_table, no_launches)
        paths[f"sparse {name}"] = (lambda c=cls, r=lr: estimator(c, None, r).fit(sparse_table),
                                   sparse_table, sparse_launches)
    paths["kmeans"] = (lambda: kmeans_estimator().fit(km_table), km_table, no_launches)
    paths["pipeline"] = (lambda: pipeline().fit(p_table), p_table, no_launches)
    # the stream and online paths, each run once here with its checks'
    # traces, and timed apart in phase 5
    traces = {"online lr": {}, "online kmeans": []}
    new_paths = {
        "stream lr": (lambda: estimator(logisticregression.LogisticRegression, "weight").fit(
            stream_of(stream_cols, DENSE_ROWS, STREAM_CHUNK)), bounded_table, no_launches),
        "stream kmeans": (lambda: kmeans_estimator().fit(stream_of(km_cols, KMEANS_ROWS, KMEANS_CHUNK)),
                          km_table, no_launches),
        "online lr": (lambda: online_lr_fit(online_cols, traces["online lr"]), held_table, no_launches),
        "online kmeans": (lambda: online_kmeans_fit(km_cols, runs["kmeans"]["model"],
                                                    traces["online kmeans"]), km_table, no_launches),
    }

    runs, launches, path_s = {}, launch_dict(), {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (fit, table, expected) in {**paths, **new_paths}.items():
            t0 = time.perf_counter()
            sk.reset_launch_counts()
            run = drive(fit, table, tmp, name.replace(" ", "_"))
            counts = sk.launch_counts()
            run.update(table=table, launches=counts)
            runs[name] = run
            log(f"  {name}: fit {run['fit_ms']:.1f} ms, transform {run['transform_ms']:.1f} ms "
                f"(first calls); launches {counts}")
            check(counts == expected, f"{name} launched {counts}, expected {expected} (one row "
                  f"dot and one gradient per epoch, a row dot per transform)")
            for kernel in launches:
                launches[kernel] += counts[kernel]
            path_s[name] = time.perf_counter() - t0
    log(f"  launches on the main paths: {launches}")
    check(launches == launch_dict(sparse_row_dots=3 * (MAX_ITER + 2), sparse_grad=3 * MAX_ITER),
          f"launches over phase 3 {launches}")
    table_api, table_api_launches = table_api_check(sk, dense_table, sparse_table,
                                                    runs["sparse lr"]["model"])
    for kernel in launches:
        launches[kernel] += table_api_launches[kernel]
    table_api["budgeted stream kmeans"] = budgeted_stream_kmeans(km_cols,
                                                                 runs["stream kmeans"]["model"])

    # -- 4. results against references ------------------------------------
    log("phase 4: results")
    touched = min(MAX_ITER, DENSE_ROWS // BATCH) * BATCH
    X64 = X[:touched].double().cpu().numpy()
    y64, w64 = y[:touched].double().cpu().numpy(), w[:touched].double().cpu().numpy()
    for name in LINEAR_PATHS:
        check_dense_linear(name, runs[f"dense {name}"], dense_table, X64, y64, w64)
        runs[f"sparse {name}"]["plain_coefficient"] = check_sparse_linear(
            name, runs[f"sparse {name}"], s_idx, s_vals, s_y)
    del X64
    for name, (*_, java_class) in LINEAR_PATHS.items():
        columns = ("prediction",) if name == "linreg" else ("prediction", "rawPrediction")
        for layout in ("dense", "sparse"):
            check_reload(f"{layout} {name}", runs[f"{layout} {name}"], java_class, columns)
    kmeans_margin, lloyd = check_kmeans(runs["kmeans"], km_table.column("features"))
    check_reload("kmeans", runs["kmeans"], "org.apache.flink.ml.clustering.kmeans.KMeansModel",
                 ("prediction",))
    check_pipeline(runs["pipeline"], p_table)
    check_reload("pipeline", runs["pipeline"], "org.apache.flink.ml.builder.PipelineModel",
                 ("prediction", "rawPrediction"))
    km_X = km_table.column("features")
    new_checks = {
        "stream lr": (lambda: check_stream_lr(runs["stream lr"], stream_cols, bounded_table,
                                              default_budget),
                      LINEAR_PATHS["lr"][4], ("prediction", "rawPrediction")),
        "stream kmeans": (lambda: check_stream_kmeans(runs["stream kmeans"], km_X, km_cols, lloyd,
                                                      runs["kmeans"]["model"]),
                          "org.apache.flink.ml.clustering.kmeans.KMeansModel", ("prediction",)),
        "online lr": (lambda: check_online_lr(runs["online lr"], online_cols, traces["online lr"],
                                              held_table),
                      "org.apache.flink.ml.classification.onlinelogisticregression."
                      "OnlineLogisticRegressionModel", ("prediction", "rawPrediction", "modelVersion")),
        "online kmeans": (lambda: check_online_kmeans(runs["online kmeans"], km_X, runs["kmeans"]["model"],
                                                      traces["online kmeans"]),
                          "org.apache.flink.ml.clustering.onlinekmeans.OnlineKMeansModel",
                          ("prediction",)),
    }
    for name, (run_check, java_class, columns) in new_checks.items():
        t0 = time.perf_counter()
        run_check()
        check_reload(name, runs[name], java_class, columns)
        path_s[name] += time.perf_counter() - t0
    log("  save/load: every model reloads and predicts identically")

    # -- 5. warm times --------------------------------------------------------
    log("phase 5: warm times")
    warm = {}
    for name, (fit, table, _) in paths.items():
        model = runs[name]["model"]
        repeats = 5 if name.endswith(" lr") else 3
        fits = [synced(fit)[1] for _ in range(repeats)]
        transforms = [synced(lambda: model.transform(table)[0])[1] for _ in range(repeats)]
        warm[name] = (float(np.median(fits)), float(np.median(transforms)))
        log(f"  {name}: fit median {warm[name][0]:.3f} ms (runs {[round(t, 3) for t in fits]}), "
            f"transform median {warm[name][1]:.3f} ms (runs {[round(t, 3) for t in transforms]})")
    from flink_ml_tpu_torch.models.clustering import kmeans

    draws = []
    for _ in range(3):
        t0 = time.perf_counter()
        kmeans.init_rows(KMEANS_ROWS, KMEANS_K, KMEANS_SEED)
        draws.append((time.perf_counter() - t0) * 1e3)
    log(f"  kmeans init rows (host RandomState.choice, {KMEANS_K} of {KMEANS_ROWS}): median "
        f"{float(np.median(draws)):.3f} ms (runs {[round(t, 3) for t in draws]})")
    for name in ("dense lr", "sparse lr", "kmeans"):
        profile_run(f"{name} fit", paths[name][0])
    profile_run("sparse lr transform", lambda: runs["sparse lr"]["model"].transform(sparse_table)[0])
    profile_run("pipeline transform", lambda: runs["pipeline"]["model"].transform(p_table)[0])
    new_warm = stream_and_online_times(stream_cols, km_cols, online_cols, runs["kmeans"]["model"], dev,
                                       path_s)

    # -- 6. the numeric feature stages ------------------------------------------
    log("phase 6: numeric feature stages at the conf/ shapes (launch counts reset before and "
        "read after each)")
    high_water = torch.cuda.max_memory_allocated()  # phase 6 resets the mark per stage
    with tempfile.TemporaryDirectory() as tmp:
        features = feature_phase(sk, dev, tmp)
    high_water = max([high_water / 2**30] + [r["high_water_gib"] for r in features.values()])
    for name, r in features.items():
        path_s[name] = r["seconds"]

    # -- 7. the string and token stages and the text path ----------------------------
    log("phase 7: the text path StopWordsRemover -> HashingTF -> IDF -> LogisticRegression, then "
        "the string and token stages at the conf/ shapes (launch counts reset before and read "
        "after each)")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        texts = text_phase(sk, dev, tmp)
    text_run = texts.pop("text path")
    high_water = max([high_water] + [r["high_water_gib"] for r in texts.values()])
    path_s["text path"] = text_run["seconds"]
    for name, r in texts.items():
        path_s[name] = r["seconds"]
    for kernel in launches:
        launches[kernel] += text_run["launches"][kernel]

    # -- 8. the statistics slice and the evaluation path ------------------------------
    log("phase 8: the evaluation path RandomSplitter -> text pipeline -> "
        "BinaryClassificationEvaluator, then NaiveBayes, UnivariateFeatureSelector, Knn, the "
        "three stats tests and RandomSplitter at their shapes (launch counts reset before and "
        "read after each)")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        stat_stages = stats_phase(sk, dev, tmp)
    eval_run = stat_stages.pop("eval path")
    functions = stat_stages.pop("functions")
    high_water = max([high_water] + [r["high_water_gib"] for r in stat_stages.values()])
    path_s["eval path"] = eval_run["seconds"]
    for name, r in stat_stages.items():
        path_s[name] = r["seconds"]
    for kernel in launches:
        launches[kernel] += eval_run["launches"][kernel]

    # -- 8b. the evaluation Graph ---------------------------------------------------------
    log("phase 8b: the evaluation Graph: RandomSplitter -> StopWordsRemover -> HashingTF -> IDF "
        "(fitted on the train part, transforming the test part) -> LogisticRegression -> "
        "BinaryClassificationEvaluator, with a model-data twin (launch counts reset before and "
        "read after the fit, and around one transform)")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        graph_run = graph_path(sk, dev, tmp, eval_run["metrics"])
    path_s["graph path"] = graph_run["seconds"]
    for kernel in launches:
        launches[kernel] += graph_run["launches"][kernel]

    # -- 9. AgglomerativeClustering, SQLTransformer, MinHashLSH, the windows ---------------
    log("phase 9: AgglomerativeClustering, SQLTransformer and MinHashLSH at their shapes, then "
        "window_all_and_process (launch counts reset before and read after each)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        slice8 = slice8_phase(sk, dev, tmp)
    phase9_s = time.perf_counter() - t0
    windows_run = slice8.pop("window_all_and_process")
    high_water = max([high_water] + [r["high_water_gib"] for r in slice8.values()])
    for name, r in slice8.items():
        path_s[name] = r["seconds"]
    path_s["window_all_and_process"] = windows_run["seconds"]
    log(f"  phase 9 took {phase9_s:.2f} s")

    # -- 10. the fleet and the reference-format loader ----------------------
    log("phase 10: FitFleet (sparse, dense, KMeans and stream fleets) and the reference-format "
        "loader (launch counts reset before and read after each)")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        fleets, fleet_models = fleet_phase(sk, dev, tmp, {
            "sparse": sparse_table, "dense": dense_table, "kmeans": km_table,
            "stream_cols": stream_cols, "bounded": bounded_table})
    high_water = max([high_water] + [r["peak_gib"] for r in fleets.values()
                                     if isinstance(r, dict) and "peak_gib" in r])
    path_s["fleets and reference format"] = fleets["seconds"]
    for kernel in launches:
        launches[kernel] += fleets["sparse lr fleet"]["launches"][kernel]
        launches[kernel] += fleets["reference format"]["launches"]["winner"][kernel]

    # -- 11. fused transforms ------------------------------------------------------
    log("phase 11: fused transforms: PipelineModels planned into fused segments, each one "
        "captured CUDA graph (launch counts reset before and read after each call)")
    torch.cuda.empty_cache()
    fused = fusion_phase(sk, dev, runs, sparse_table, dense_table, p_table, held_table)
    path_s["fused transforms"] = fused["seconds"]
    fused_launches = {f"fused {name} (a replay)": r["replay_launches"]["sparse_row_dots"]
                      for name, r in fused.items() if name.startswith("sparse lr")}
    for n in fused_launches.values():
        launches["sparse_row_dots"] += n

    # -- 12. serving -----------------------------------------------------------------
    log("phase 12: serving: phase 10's sparse LR members as ModelStore tenants behind a "
        "MicroBatchServer (pull loop, then request, fixed and continuous push modes), then "
        "phase 3's online LR behind a ModelLifecycle while a trainer promotes (launch counts "
        "reset before and read after each run)")
    torch.cuda.empty_cache()
    serving = serving_phase(sk, dev, fleet_models["sparse"], sparse_table, runs["online lr"]["model"],
                            traces["online lr"], fleet_models["dense"], held_table)
    path_s["serving"] = serving["seconds"]
    serving_launches = {f"serving {run}": n for run, n in serving["launches_by_run"].items()}
    for n in serving_launches.values():
        launches["sparse_row_dots"] += n

    # -- 13. checkpoint and recovery ------------------------------------------
    log("phase 13: checkpoint and recovery: kill-resume of the dense, sparse (a SIGKILLed child "
        "process), stream, KMeans, online, fleet and lifecycle paths, commit faults, and the "
        "supervisor (launch counts reset before and read after each resumed fit)")
    torch.cuda.empty_cache()
    checkpoints = checkpoint_phase(sk, dev, card, runs, traces, dense_table, sparse_table,
                                   stream_cols, km_cols, online_cols, held_table)
    path_s["checkpoint and recovery"] = checkpoints["seconds"]
    for counts in checkpoints["launches"].values():
        for kernel in launches:
            launches[kernel] += counts[kernel]

    # -- 14. the program funnel, the program bank and a traced run -------------
    log("phase 14: whole fits through the program funnel (eager, a first call that captures, "
        "a replay), a sweep, the program bank across processes, a traced run (launch counts "
        "reset before and read after each replay)")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        funnel, funnel_launches = funnel_phase(sk, dev, card, dense_table, sparse_table, km_table,
                                               tmp)
    path_s["funnel, bank and traced run"] = funnel["seconds"]
    for counts in funnel_launches.values():
        for kernel in launches:
            launches[kernel] += counts[kernel]

    # -- the sanitizer's verdict over phases 1-14 ------------------------------
    problems = sanitizer.recorder.problems(join_timeout=SANITIZER_JOIN_S)
    sanitized = sanitizer.recorder.stats()
    log("sanitizer: " + json.dumps(sanitized) + "; edges: " + "; ".join(
        f"{a} -> {b} (x{sanitizer.recorder.edges[(a, b)][1]})"
        for a, b in sorted(sanitizer.recorder.edges)))
    check(not problems, f"the sanitizer found {len(problems)} problem(s): " + "; ".join(problems))
    check(sanitized["workers"] > 0 and sanitized["channels"] > 0,
          f"the sanitizer saw no worker or no channel: {sanitized}")
    sanitizer.mark_exit_checked()

    # -- 15. the port's tpulint ----------------------------------------------------
    log("phase 15: the port's tpulint over this checkout, in a fresh process with no summary "
        "cache")
    lint = lint_phase(card)
    path_s["tpulint"] = lint["seconds"] + lint["gate_seconds"]

    # -- 16. data-parallel training over a mesh of ranks -------------------------------
    log(f"phase 16: {MESH_RANKS} gloo ranks sharing the card, each under the sanitizer: the "
        "dense LR, the sparse LR (dense and pair routes) and KMeans of phase 3, plain and "
        "overlapped, against the one-rank fits (launch counts reset before and read after "
        "each fit on each rank); then a one-rank NCCL world")
    spec = mesh_spec()
    t0 = time.perf_counter()
    with mesh_world(spec) as world:
        mesh = mesh_phase(card, dev, runs, world, spec, time.perf_counter() - t0)
        path_s["mesh"] = mesh["seconds"]

        # -- 17. the rest of the multi-device layer (A.10b) --------------------------
        log(f"phase 17: on the same {MESH_RANKS} gloo ranks: the sparse LR as a 2D fit on 2 x 2 "
            "and 1 x 4 and the replicated reference on 2 x 2, the budget case, phase 10's "
            "sparse fleet in both regimes, the stream LR and KMeans on ranks, a 2D cut resumed "
            "on 1 x 4 and on one rank (launch counts reset before and read after each fit on "
            "each rank); then the supervisor's shrink of a checkpointed dense fit from 4 ranks "
            "in 2 hosts to the survivors")
        mesh2d = mesh2d_phase(card, dev, runs, world, spec, fleet_models)
    path_s["mesh2d"] = mesh2d["seconds"]
    mesh_launches = {f"mesh {name} (rank 0 of {MESH_RANKS})": counts[0]
                     for name, counts in mesh["launches"].items()}
    for counts in mesh_launches.values():
        for kernel in launches:
            launches[kernel] += counts[kernel]
    mesh2d_launches = {f"mesh2d {name} (rank 0 of {MESH_RANKS})": counts[0]
                       for name, counts in mesh2d["launches"].items()}
    mesh2d_launches["mesh2d ckpt resumed on one rank"] = mesh2d["one_rank_launches"]
    for counts in mesh2d_launches.values():
        for kernel in launches:
            launches[kernel] += counts[kernel]

    # -- 18. the JAX package's examples on the port ------------------------------
    log("phase 18: every examples/*.py rewritten to the port, in one child process on the "
        "card under the sanitizer (launch counts reset before and read after each example)")
    torch.cuda.empty_cache()
    examples = examples_phase(card)
    path_s["examples"] = examples["seconds"]
    example_launches = {f"example {name}": r["launches"]
                        for name, r in examples["examples"].items() if any(r["launches"].values())}
    for counts in example_launches.values():
        for kernel in launches:
            launches[kernel] += counts[kernel]

    # -- 19. the port's benchmark CLI over conf/ -------------------------------------
    log("phase 19: python -m flink_ml_tpu_torch.benchmark over conf/benchmark-demo.json and "
        "every conf/*-benchmark.json at their own shapes, in one child process on the card "
        "under the sanitizer (launch counts reset before and read after each config)")
    torch.cuda.empty_cache()
    bench = benchmark_phase(card)
    path_s["benchmark"] = bench["seconds"]
    bench_launches = {"benchmark (phase 19)": bench["launches"]}
    for counts in bench_launches.values():
        for kernel in launches:
            launches[kernel] += counts[kernel]

    # -- 20. the operator tools --------------------------------------------------------
    log("phase 20: the repo's operator tools on the port, each step a fresh process under the "
        "sanitizer: a traced sparse LR fit (launch counts reset before and read after), the "
        "trace report and timeline over it, the fit-timeline smoke, the cold-start smoke "
        "(populate, serve, baseline), the fixture and operator-doc writers")
    torch.cuda.empty_cache()
    tools = tools_phase(card, runs)
    path_s["operator tools"] = tools["seconds"]
    tools_launches = {"tools traced sparse lr (phase 20)": tools["launches"]}
    for counts in tools_launches.values():
        for kernel in launches:
            launches[kernel] += counts[kernel]

    # -- 21. output ----------------------------------------------------------------
    sources = {
        "sparse_row_dots": "flink_ml_tpu/ops/sparsekernels.py:96",
        "sparse_grad": "flink_ml_tpu/ops/sparsekernels.py:107",
    }
    kernels = []
    for name, rows in kernel_results.items():
        main = rows[0]  # the fit batch: the shape of every epoch's launch
        kernels.append({
            "name": name, "route": "cuda",
            "source": "flink_ml_tpu_torch/csrc/sparse_kernels.cu",
            "replaces": sources[name],
            "launches": launches[name],
            "launches_by_path": {**{p: r["launches"][name] for p, r in runs.items()
                                    if r["launches"][name]},
                                 "text": text_run["launches"][name],
                                 "eval": eval_run["launches"][name],
                                 "graph": graph_run["launches"][name],
                                 "graph transform": graph_run["transform_launches"][name],
                                 "reference-format transform":
                                     fleets["reference format"]["launches"]["winner"][name],
                                 f"table api head({HEAD_ROWS})": table_api_launches[name],
                                 **(fused_launches if name == "sparse_row_dots" else {}),
                                 **(serving_launches if name == "sparse_row_dots" else {}),
                                 **{p: c[name] for p, c in checkpoints["launches"].items()
                                    if c[name]},
                                 **{p: c[name] for p, c in funnel_launches.items() if c[name]},
                                 **{p: c[name] for p, c in mesh_launches.items() if c[name]},
                                 **{p: c[name] for p, c in mesh2d_launches.items() if c[name]},
                                 **{p: c[name] for p, c in example_launches.items() if c[name]},
                                 **{p: c[name] for p, c in bench_launches.items()},
                                 **{p: c[name] for p, c in tools_launches.items()}},
            "launches_by_feature_path": {p: r["launches"][name] for p, r in
                                         {**features, **texts, **stat_stages, **slice8}.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err": max(r["max_rel_err"] for r in rows),
            "tolerance": ROW_DOTS_TOL if name == "sparse_row_dots" else GRAD_TOL,
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "probe_ms": main["probe_ms"], "enqueue_ms": main["enqueue_ms"],
            **({"replaced_design": REPLACED_DESIGNS[name], "replaced_ms": main["replaced_ms"],
                "shared_atomics": shared_atomics} if name in REPLACED_DESIGNS else {}),
            "shape": [main["rows"], main["nnz"], main["d"]],
            "by_shape": rows,
        })
    for name, r in fleet_kernel_results.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "flink_ml_tpu_torch/csrc/sparse_kernels.cu",
            "replaces": FLEET_SOURCES[name],
            "launches": launches[name],
            "launches_by_path": {"sparse lr fleet": fleets["sparse lr fleet"]["launches"][name],
                                 **{p: c[name] for p, c in checkpoints["launches"].items()
                                    if c[name]},
                                 **{p: c[name] for p, c in funnel_launches.items() if c[name]},
                                 **{p: c[name] for p, c in mesh2d_launches.items() if c[name]},
                                 **{p: c[name] for p, c in example_launches.items() if c[name]},
                                 **{p: c[name] for p, c in bench_launches.items()},
                                 **{p: c[name] for p, c in tools_launches.items()}},
            "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
            "tolerance": r["tolerance"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "member_major_ms": r["member_major_ms"], "solo_n_ms": r["solo_n_ms"],
            "replaced_design": REPLACED_DESIGNS[name], "replaced_ms": r["replaced_ms"],
            "replaced_member_major_ms": r["replaced_member_major_ms"], "probe_ms": r["probe_ms"],
            **({"bit_identical_to_solo": r["bit_identical_to_solo"]} if name == "fleet_row_dots"
               else {"by_case": r["by_case"]}),
            "by_shape": r["by_shape"],
            "shape": [r["members"], r["rows"], r["nnz"], r["d"]],
        })
    log("first calls: " + "; ".join(
        f"{n} fit {r['fit_ms']:.3f} ms, transform {r['transform_ms']:.3f} ms" for n, r in runs.items()))
    log("warm medians: " + "; ".join(
        f"{n} fit {f:.3f} ms, transform {t:.3f} ms" for n, (f, t) in warm.items()))
    log("stream and online, warm: " + json.dumps(new_warm))
    log("feature stages: " + json.dumps(features))
    log("text path: " + json.dumps(text_run))
    log("text stages: " + json.dumps(texts))
    log("eval path: " + json.dumps(eval_run))
    log("stats stages: " + json.dumps(stat_stages) + "; functions: " + json.dumps(functions))
    log("table api: " + json.dumps(table_api))
    log("graph path: " + json.dumps(graph_run))
    log("phase 9 stages: " + json.dumps(slice8) + "; window_all_and_process: " + json.dumps(windows_run))
    log("fleets and reference format: " + json.dumps(fleets))
    log("fused transforms: " + json.dumps(fused))
    log("serving: " + json.dumps(serving))
    log("checkpoint and recovery: " + json.dumps(checkpoints))
    log("funnel, bank and traced run: " + json.dumps(funnel, default=str))
    log("tpulint: " + json.dumps(lint))
    log("mesh: " + json.dumps(mesh, default=str))
    log("mesh2d: " + json.dumps(mesh2d, default=str))
    log("examples: " + json.dumps(examples))
    log("benchmark: " + json.dumps(bench))
    log("tools: " + json.dumps(tools))
    log("seconds by path (phases 3-20): " + "; ".join(f"{n} {t:.2f}" for n, t in path_s.items()))
    log(f"kmeans points within the 1e-4 margin: {kmeans_margin}; build {build_s:.2f} s, "
        f"peak memory {high_water:.2f} GiB, "
        f"total {time.perf_counter() - t_start:.1f} s on {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def mesh_fits():
    """Phase 16's fits on each rank: name -> (path, overlap, threshold)."""
    return {
        "dense lr plain": ("dense", False, None), "dense lr overlap": ("dense", True, None),
        "sparse lr plain": ("sparse", False, None), "sparse lr overlap": ("sparse", True, None),
        "sparse lr pairs": ("sparse", True, MESH_PAIR_THRESHOLD),
        "kmeans plain": ("kmeans", False, None), "kmeans overlap": ("kmeans", True, None),
    }


def mesh_expected_launches(name):
    """A rank's launches in a phase-16 fit: a row dot and a gradient an
    epoch on its rows; on the pair route the gradient is the pairs'
    deterministic scatter (`collectives.scatter_pairs`), not the kernel."""
    if not name.startswith("sparse"):
        return launch_dict()
    return launch_dict(sparse_row_dots=MAX_ITER,
                       sparse_grad=0 if name.endswith("pairs") else MAX_ITER)


def count_plain_launches(sk):
    """On the CPU (the rehearsal) each call of a kernel's plain version
    counts as its kernel's launch: scripts/rehearse_chip_smoke.py installs
    it in its process, and phase 16's ranks (which start without that
    stub) in theirs."""
    def counted(kernel, plain):
        def call(*args):
            kernel.launches += 1
            return plain(*args)
        return call
    if getattr(sk, "plain_launches_counted", False):  # once a process
        return
    sk.plain_launches_counted = True
    for name in ("sparse_row_dots", "sparse_grad", "fleet_row_dots", "fleet_grad"):
        setattr(sk, f"{name}_plain", counted(getattr(sk, name), getattr(sk, f"{name}_plain")))


def collectives_check(mesh, dev, self_send=False):
    """Every operation of parallel/collectives.py once on this rank's
    tensors on `dev`, each held to its definition exactly (integer-valued
    float32 operands, so any order of the sums is exact): the four
    all-reduces, all_gather (tiled and stacked), reduce_scatter,
    ppermute_ring, the chunked reduce (reduce-scatter + all-gather and the
    ring, each also issued asynchronously), the sparse pair reduce and
    host_all_reduce_sum; with `self_send` (a one-rank NCCL world) one
    point-to-point exchange with itself. Returns the operations checked."""
    from flink_ml_tpu_torch.parallel import collectives as coll

    n, r = mesh.shape["data"], mesh.rank
    base = torch.arange(n * 6 * 4, dtype=torch.float32, device=dev).reshape(n * 6, 4)
    x = base + 1000.0 * r
    ranks = torch.arange(n, dtype=torch.float32, device=dev)
    total = n * base + 1000.0 * ranks.sum()
    every = torch.cat([base + 1000.0 * q for q in range(n)])
    want = {
        "psum": (coll.all_reduce_sum(x, mesh=mesh), total),
        "pmean": (coll.all_reduce_mean(x, mesh=mesh), total / n),
        "pmax": (coll.all_reduce_max(x, mesh=mesh), base + 1000.0 * (n - 1)),
        "pmin": (coll.all_reduce_min(x, mesh=mesh), base),
        "all_gather": (coll.all_gather(x, mesh=mesh), every),
        "all_gather stacked": (coll.all_gather(x, tiled=False, mesh=mesh),
                               every.reshape(n, n * 6, 4)),
        "psum_scatter": (coll.reduce_scatter(x, mesh=mesh), total.reshape(n, 6, 4)[r]),
        "ppermute": (coll.ppermute_ring(x, mesh=mesh), base + 1000.0 * ((r - 1) % n)),
    }
    for ring in (False, True):
        for async_op in (False, True):
            got = coll.all_reduce_sum_chunked({"a": x, "b": (x[:2], x[2:])}, chunk_bytes=64,
                                              ring=ring, mesh=mesh, async_op=async_op)
            got = got.result() if async_op else got
            label = f"chunked {'ring' if ring else 'rs+ag'}{' async' if async_op else ''}"
            want[label] = (torch.cat([got["a"], got["b"][0], got["b"][1]]),
                           torch.cat([total, total[:2], total[2:]]))
    d = 50
    idx = ((torch.arange(24, device=dev, dtype=torch.int32) * 7 + 3 * r) % (d + 4)
           - 2).reshape(6, 4).to(torch.int32)
    vals = torch.full((6, 4), float(r + 1), device=dev)
    dense = torch.zeros(d, device=dev)
    for q in range(n):
        qi = ((torch.arange(24, device=dev) * 7 + 3 * q) % (d + 4) - 2)
        keep = (qi >= 0) & (qi < d)
        dense.index_add_(0, qi[keep], torch.full((int(keep.sum()),), float(q + 1), device=dev))
    want["sparse_allreduce"] = (coll.sparse_all_reduce_sum(idx, vals, d, mesh=mesh), dense)
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    hot = torch.randint(0, 64, (200_000,), generator=gen, device=dev, dtype=torch.int32)
    hot_vals = torch.randn(200_000, generator=gen, device=dev)
    first = coll.scatter_pairs(hot, hot_vals, 64)
    want["scatter_pairs repeats its bits"] = (coll.scatter_pairs(hot, hot_vals, 64), first)
    parts = [np.full(5, float(q), np.float32) for q in range(3)]
    want["host_all_reduce_sum"] = (coll.host_all_reduce_sum(mesh, parts),
                                   torch.full((5,), 3.0, device=dev))
    if self_send:
        want["p2p to itself"] = (coll._exchange(x, coll._Axis(n, mesh.group, r), [1])[0], x)
    for label, (got, expect) in want.items():
        check(got.shape == expect.shape and torch.equal(got, expect.to(got.dtype)),
              f"collective {label} on rank {r} over {mesh.group and 'its group'} differs "
              f"from its definition")
    return sorted(want)


def mesh_rank_job(spec):
    """Phase 16 on one rank of the gloo world: the dense LR, the sparse LR
    and KMeans of phase 3 through their estimators on this rank's rows
    (`mesh_fits`), each with the launch counts reset before and read
    after, then `collectives_check` on the card, then this rank's
    collective sequence held against every other rank's
    (`sanitizer.compare_rank_sequences`) and the sanitizer's verdict. The
    data is phase 3's, made again on this rank from its seeds (the whole
    table; each fit stages only its rows). Returns host values only."""
    import hashlib

    import torch.distributed as dist

    module = sys.modules[__name__]
    for name, value in spec["sizes"].items():
        setattr(module, name, value)
    from flink_ml_tpu_torch import SparseBatch, Table
    from flink_ml_tpu_torch import config as port_config
    from flink_ml_tpu_torch.analysis import sanitizer
    from flink_ml_tpu_torch.models.classification import logisticregression
    from flink_ml_tpu_torch.ops import sparsekernels as sk
    from flink_ml_tpu_torch.parallel import mesh as mesh_lib
    from flink_ml_tpu_torch.utils import metrics

    rank, dev = dist.get_rank(), torch.device(spec["device"])
    cuda = dev.type == "cuda"
    if spec["count_plain"]:
        count_plain_launches(sk)
    else:
        sk.build()  # loads the parent's build: the library exists
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    fits, tables = {}, {}

    def table_of(path):
        if path in tables:
            return tables[path]
        tables.clear()
        if cuda:
            torch.cuda.empty_cache()
        if path == "dense":
            gen = torch.Generator(device=dev)
            gen.manual_seed(2)  # phase 3's dense table, in its order
            X = torch.rand((DENSE_ROWS, DIM), generator=gen, device=dev)
            y = torch.randint(0, 2, (DENSE_ROWS,), generator=gen, device=dev).to(torch.float32)
            w = torch.rand((DENSE_ROWS,), generator=gen, device=dev)
            tables[path] = Table({"features": X, "label": y, "weight": w})
        elif path == "sparse":
            s_idx, s_vals, s_y = sparse_data(dev)
            tables[path] = Table({"features": SparseBatch(SPARSE_DIM, s_idx, s_vals),
                                  "label": s_y})
        else:
            tables[path] = Table({"features": kmeans_data(dev)})
        return tables[path]

    for name, (path, overlap, threshold) in mesh_fits().items():
        table = table_of(path)
        est = (kmeans_estimator() if path == "kmeans" else
               estimator(logisticregression.LogisticRegression,
                         "weight" if path == "dense" else None))
        threshold = port_config.collective_sparse_threshold if threshold is None else threshold
        if cuda:
            torch.cuda.synchronize()
        sk.reset_launch_counts()
        before = metrics.snapshot()
        t0 = time.perf_counter()
        with port_config.collective_overlap_mode(overlap), \
                port_config.collective_sparse_threshold_mode(threshold):
            model = est.fit(table)
        if cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = sk.launch_counts()
        delta = metrics.snapshot_delta(before, metrics.snapshot())
        arrays = ({"centroids": model.centroids, "weights": model.weights} if path == "kmeans"
                  else {"coefficient": np.asarray(model.coefficient)})
        fits[name] = {
            "seconds": seconds, "launches": launches,
            "counters": {k: v for k, v in delta["counters"].items()
                         if k.startswith(("collective.", "dispatch.whole_fit"))},
            "digest": hashlib.sha256(b"".join(np.ascontiguousarray(a).tobytes()
                                              for a in arrays.values())).hexdigest(),
            **(arrays if rank == 0 else {}),
        }
    tables.clear()
    checked = collectives_check(mesh_lib.default_mesh(), dev)
    staged = {k: v for k, v in metrics.snapshot()["counters"].items()
              if k.startswith("collective.staged.")}
    sequence = sanitizer.recorder.collective_sequences.get("mesh", {}).get(str(rank), [])
    return {
        "rank": rank, "fits": fits, "collectives_checked": checked, "staged": staged,
        "sequence_length": len(sequence),
        "sequence_digest": hashlib.sha256(repr(sequence).encode()).hexdigest()[:16],
        "sequence_problems": sanitizer.compare_rank_sequences(),
        "sanitizer_problems": sanitizer.recorder.problems(join_timeout=SANITIZER_JOIN_S),
        "sanitizer": sanitizer.recorder.stats(),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0,
    }


def nccl_rank_job(spec):
    """Phase 16(b) on the one rank of an NCCL world: `collectives_check`
    over the world's group (so every operation reaches the backend, which
    a mesh of one rank with no group skips), with a point-to-point
    exchange with itself; nothing may stage through the host."""
    import torch.distributed as dist

    from flink_ml_tpu_torch.parallel import mesh as mesh_lib
    from flink_ml_tpu_torch.utils import metrics

    dev = torch.device(spec["device"])
    mesh = mesh_lib.Mesh((mesh_lib.DATA_AXIS,), (1,), group=dist.group.WORLD, rank=0, device=dev)
    checked = collectives_check(mesh, dev, self_send=dist.get_backend() == "nccl")
    staged = {k: v for k, v in metrics.snapshot()["counters"].items()
              if k.startswith("collective.staged.")}
    return {"backend": dist.get_backend(), "checked": checked, "staged": staged}


def mesh_spec():
    """What a rank of phases 16-17 gets: its device, whether it counts the
    plain versions' calls as launches (the rehearsal), and the module's
    sizes (so the rehearsal's small sizes reach it)."""
    on_card = DEVICE == "cuda"
    return {"device": "cuda:0" if on_card else "cpu", "count_plain": not on_card,
            "sizes": {name: getattr(sys.modules[__name__], name) for name in (
                "DENSE_ROWS", "DIM", "SPARSE_ROWS", "SPARSE_DIM", "NNZ", "MAX_ITER", "BATCH",
                "KMEANS_ROWS", "KMEANS_K", "KMEANS_ITER", "KMEANS_SEED", "STREAM_CHUNK",
                "KMEANS_CHUNK", "MESH_BUDGET_ROWS", "MESH_BUDGET_BATCH")}}


def mesh_world(spec):
    """Phase 16's world of MESH_RANKS gloo ranks on this card, each under
    the sanitizer; phase 17 runs on it too."""
    from flink_ml_tpu_torch.parallel import launcher

    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks' tables need the parent's free cache
    return launcher.World(MESH_RANKS, backend="gloo", device=spec["device"],
                          timeout_s=MESH_JOB_TIMEOUT_S,
                          collective_timeout_s=MESH_COLLECTIVE_TIMEOUT_S, sanitize=True)


def mesh_phase(card, dev, runs, world, spec, spawn_s):
    """Phase 16: (a) MESH_RANKS gloo ranks on this one card (`world`, made
    in `spawn_s` by `mesh_world`), each under the sanitizer
    (`mesh_rank_job`), every fit held against phase 3's one-rank fit of
    the same data, overlap against plain, every rank's collective sequence
    against the others'; (b) a one-rank NCCL world (`nccl_rank_job`). A
    rank that fails fails the run. Returns what the output lines print."""
    from flink_ml_tpu_torch.parallel import launcher

    t0 = time.perf_counter() - spawn_s
    on_card = DEVICE == "cuda"
    device = spec["device"]
    per_rank = world.run(mesh_rank_job, spec)
    gloo_s = time.perf_counter() - t0
    r0 = per_rank[0]["fits"]
    out = {"ranks": MESH_RANKS, "spawn_s": spawn_s, "seconds_by_fit": {}, "launches": {},
           "counters": {}, "peak_gib": [r["peak_gib"] for r in per_rank]}
    for name in mesh_fits():
        digests = {r["fits"][name]["digest"] for r in per_rank}
        check(len(digests) == 1, f"mesh {name}: the ranks ended with different models")
        for r in per_rank:
            got = r["fits"][name]["launches"]
            check(got == mesh_expected_launches(name),
                  f"mesh {name}: rank {r['rank']} launched {got}, expected "
                  f"{mesh_expected_launches(name)}")
        out["seconds_by_fit"][name] = [round(r["fits"][name]["seconds"], 4) for r in per_rank]
        out["launches"][name] = [r["fits"][name]["launches"] for r in per_rank]
        out["counters"][name] = r0[name]["counters"]
        check(r0[name]["counters"].get("dispatch.whole_fit_fallback.mesh") == 1,
              f"mesh {name} was not counted as an eager mesh fit")
    for r in per_rank:
        check(not r["sequence_problems"],
              f"rank {r['rank']}: collective sequences differ: {r['sequence_problems']}")
        check(not r["sanitizer_problems"],
              f"rank {r['rank']}: the sanitizer found {r['sanitizer_problems']}")
    check(len({(r["sequence_length"], r["sequence_digest"]) for r in per_rank}) == 1,
          "the ranks recorded different collective sequences")
    pairs = r0["sparse lr pairs"]["counters"]
    check(pairs.get("collective.sparse_allreduce.calls", 0) == MAX_ITER + 1 and
          r0["sparse lr overlap"]["counters"].get("collective.sparse_allreduce.calls", 0) == 0,
          "the pair route did not carry exactly the pairs fit's gradient")
    # -- gates against phase 3's one-rank fits and between the modes
    gaps = {}
    one = runs["dense lr"]["model"].coefficient
    for name in ("dense lr plain", "dense lr overlap"):
        c = r0[name]["coefficient"]
        gaps[name] = float(np.max(np.abs(c - one)))
        check(np.allclose(c, one, **MESH_DENSE_TOL),
              f"mesh {name} differs from the one-rank fit by {gaps[name]}")
    gaps["dense overlap vs plain"] = float(np.max(np.abs(
        r0["dense lr overlap"]["coefficient"] - r0["dense lr plain"]["coefficient"])))
    check(np.allclose(r0["dense lr overlap"]["coefficient"], r0["dense lr plain"]["coefficient"],
                      **MESH_DENSE_TOL), "mesh dense overlap differs from plain")
    plain_c = runs["sparse lr"]["plain_coefficient"]
    scale = float(np.max(np.abs(plain_c)))
    for name in ("sparse lr plain", "sparse lr overlap", "sparse lr pairs"):
        gaps[name] = float(np.max(np.abs(r0[name]["coefficient"] - plain_c)))
        check(gaps[name] <= 1e-4 * scale, f"mesh {name} differs from the one-rank plain-loss "
                                          f"fit by {gaps[name]} (gate {1e-4 * scale})")
    km = runs["kmeans"]["model"]
    km_scale = float(np.max(np.abs(km.centroids)))
    for name, ref in (("kmeans plain", km), ("kmeans overlap", None)):
        want_c = km.centroids if ref is not None else r0["kmeans plain"]["centroids"]
        want_w = km.weights if ref is not None else r0["kmeans plain"]["weights"]
        gaps[name] = float(np.max(np.abs(r0[name]["centroids"] - want_c)))
        moved = float(np.sum(np.abs(r0[name]["weights"] - want_w))) / 2
        gaps[name + " points moved"] = moved
        check(gaps[name] <= MESH_KMEANS_SCALE_TOL * km_scale
              and moved <= MESH_KMEANS_POINT_SHARE * KMEANS_ROWS,
              f"mesh {name}: centroids {gaps[name]} off, {moved} points in other cells")
    out["gaps"] = gaps
    out["staged"] = per_rank[0]["staged"]
    check(out["staged"].get("collective.staged.p2p", 0) > 0 or not on_card,
          "the ring's point-to-point on CUDA tensors did not stage through the host")
    out["sequence_length"] = per_rank[0]["sequence_length"]
    out["sanitizer"] = per_rank[0]["sanitizer"]
    out["collectives_checked"] = per_rank[0]["collectives_checked"]
    # -- (b) a one-rank NCCL world
    t1 = time.perf_counter()
    backend = "nccl" if on_card else "gloo"
    with launcher.World(1, backend=backend, device=device, timeout_s=MESH_JOB_TIMEOUT_S,
                        collective_timeout_s=MESH_COLLECTIVE_TIMEOUT_S) as world:
        nccl = world.run(nccl_rank_job, spec)[0]
    check(nccl["backend"] == backend, f"the one-rank world runs {nccl['backend']}")
    check(not nccl["staged"], f"the {backend} branch staged through the host: {nccl['staged']}")
    out["nccl"] = {**nccl, "seconds": time.perf_counter() - t1}
    out["seconds"] = time.perf_counter() - t0
    log(f"  mesh of {MESH_RANKS} gloo ranks on one card: spawned in {spawn_s:.2f} s, fits and "
        f"checks {gloo_s - spawn_s:.2f} s; on {card}")
    for name in mesh_fits():
        log(f"  mesh {name}: seconds by rank {out['seconds_by_fit'][name]}; launches by rank "
            f"{[{k: v for k, v in c.items() if v} for c in out['launches'][name]]}; collectives "
            f"(rank 0) {out['counters'][name]}")
    log(f"  mesh gaps: {json.dumps(gaps)}")
    log(f"  mesh peaks by rank (GiB): {[round(p, 3) for p in out['peak_gib']]}; staged through "
        f"the host (rank 0): {out['staged']}; {out['sequence_length']} collectives a rank, "
        f"equal on every rank; sanitizer (rank 0) {out['sanitizer']}")
    log(f"  {backend} one-rank world: {len(nccl['checked'])} collectives held to their "
        f"definitions on CUDA tensors, none staged, in {out['nccl']['seconds']:.2f} s. It is "
        "the only run of the NCCL branch until a multi-card check exists; NCCL across cards "
        "stays unverified" if on_card else "  (the rehearsal runs gloo on the CPU)")
    return out


def mesh2d_budget_bytes():
    """Phase 17(b)'s per-rank budget: the rows a rank of 2 x 2 stages (its
    half of each touched batch's slots and weights, its labels of every
    batch) plus 6 * d: above the 2D carries (coefficient and gradient
    slices of d / 2, 4 * d bytes) and below the replicated ones (8 * d),
    with 2 * d to spare on each side for the rows' own count."""
    b_local = -(-MESH_BUDGET_BATCH // 2)
    batches = -(-MESH_BUDGET_ROWS // MESH_BUDGET_BATCH)
    touched = min(batches, 2)
    return touched * b_local * (NNZ * 8 + 8) + batches * b_local * 4 + 6 * SPARSE_DIM


def mesh2d_rank_job(spec):
    """Phase 17 on one rank of phase 16's gloo world: (a) the sparse LR of
    phase 3 through its estimator on the 2D meshes of MESH2D_FITS; (b) the
    budget case; (c) phase 10's sparse LR fleet in the default and the
    fleet-sharded regime; (d) the stream LR (phase 3's first MAX_ITER
    batches) and the stream KMeans on this rank's rows; (e) a checkpointed
    2D fit on 2 x 2 killed at a chunk and resumed on 1 x 4. Launch counts
    reset before and read after each; the collective counters, digests of
    the model and of this rank's model slice; then this rank's collective
    sequence against the others' on the 2 x 2 mesh and the sanitizer's
    verdict. Returns host values only."""
    import hashlib

    import torch.distributed as dist

    module = sys.modules[__name__]
    for name, value in spec["sizes"].items():
        setattr(module, name, value)
    from flink_ml_tpu_torch import SparseBatch, Table
    from flink_ml_tpu_torch import config as port_config
    from flink_ml_tpu_torch.analysis import sanitizer
    from flink_ml_tpu_torch.ckpt import faults
    from flink_ml_tpu_torch.fleet import FitFleet
    from flink_ml_tpu_torch.models.classification import logisticregression
    from flink_ml_tpu_torch.obs import memledger
    from flink_ml_tpu_torch.ops import losses, optimizer
    from flink_ml_tpu_torch.ops import sparsekernels as sk
    from flink_ml_tpu_torch.parallel import mesh as mesh_lib
    from flink_ml_tpu_torch.utils import metrics

    rank, dev = dist.get_rank(), torch.device(spec["device"])
    cuda = dev.type == "cuda"
    if spec["count_plain"]:
        count_plain_launches(sk)
    torch.backends.cuda.matmul.allow_tf32 = False
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    meshes = {(nd, nm): mesh_lib.create_mesh_2d(nm) for nd, nm in ((2, 2), (1, 4))}
    meshes[(4,)] = mesh_lib.create_mesh()
    out = {"rank": rank, "fits": {}}

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]

    def measured(name, fn, shape):
        if cuda:
            torch.cuda.synchronize()
        sk.reset_launch_counts()
        before = metrics.snapshot()
        t0 = time.perf_counter()
        with mesh_lib.use_mesh(meshes[shape]):
            value, arrays = fn(meshes[shape])
        if cuda:
            torch.cuda.synchronize()
        delta = metrics.snapshot_delta(before, metrics.snapshot())
        out["fits"][name] = {
            "seconds": time.perf_counter() - t0, "launches": sk.launch_counts(),
            "counters": {k: v for k, v in delta["counters"].items()
                         if k.startswith(("collective.", "dispatch.whole_fit"))},
            "gauges": {k: v for k, v in metrics.snapshot()["gauges"].items()
                       if k.startswith("fleet.")},
            "digest": digest(np.concatenate([np.ravel(a) for a in arrays])),
            **({"value": value} if rank == 0 else {}), **value.get("always", {})}
        return value

    s_idx, s_vals, s_y = sparse_data(dev)
    sparse_table = Table({"features": SparseBatch(SPARSE_DIM, s_idx, s_vals), "label": s_y})

    # (a) the 2D fits through the estimator
    for name, (nd, nm, mode) in MESH2D_FITS.items():
        def fit(m, mode=mode, nm=nm):
            with port_config.sparse_2d_mode(mode):
                c = np.asarray(estimator(logisticregression.LogisticRegression).fit(
                    sparse_table).coefficient)
            d_local = -(-SPARSE_DIM // nm)
            j = m.axis_index(mesh_lib.MODEL_AXIS)
            piece = np.pad(c, (0, d_local * nm - SPARSE_DIM))[j * d_local:(j + 1) * d_local]
            return {"coefficient": c, "always": {"slice_digest": digest(piece)}}, [c]
        measured(name, fit, (nd, nm))

    # (b) the budget: the 2D fit admits its slices, the replicated one is refused
    budget = mesh2d_budget_bytes()
    rows = slice(0, MESH_BUDGET_ROWS)
    budget_sgd = dict(max_iter=2, global_batch_size=MESH_BUDGET_BATCH, tol=0.0, shard_features=True)

    def budget_fit(m):
        memledger.reset()
        token = memledger.mark_peak()
        with port_config.hbm_budget_mode(budget):
            c, _, epochs = optimizer.SGD(**budget_sgd).optimize(
                np.zeros(SPARSE_DIM), (s_idx[rows], s_vals[rows]), s_y[rows], None,
                losses.SPARSE_BINARY_LOGISTIC_LOSS, mesh=m)
        return {"epochs": epochs, "finite": bool(np.isfinite(c).all()),
                "always": {"ledger_peak": memledger.peak_since(token)}}, [c]
    measured("budget 2d 2x2", budget_fit, (2, 2))

    def refused(m):
        memledger.reset()
        try:
            with port_config.hbm_budget_mode(budget):
                optimizer.SGD(**budget_sgd).optimize(
                    np.zeros(SPARSE_DIM), (s_idx[rows], s_vals[rows]), s_y[rows], None,
                    losses.SPARSE_BINARY_LOGISTIC_LOSS, mesh=m)
        except memledger.HbmBudgetExceeded as e:
            return {"always": {"refused_bytes": e.requested_bytes}}, [np.zeros(1)]
        return {"always": {"refused_bytes": 0}}, [np.zeros(1)]
    measured("budget replicated 4", refused, (4,))
    memledger.reset()

    # (c) phase 10's sparse LR fleet in both regimes
    for name, shard in (("fleet default", None), ("fleet sharded", True)):
        def fleet(m, shard=shard):
            models = FitFleet(fleet_members(logisticregression.LogisticRegression),
                              shard_fleet_axis=shard).fit(sparse_table)
            coeffs = [np.asarray(mod.coefficient) for mod in models]
            return {"coefficients": coeffs}, coeffs
        measured(name, fleet, (4,))
    # a default-regime member against its solo fit on this mesh (every rank fits)
    with mesh_lib.use_mesh(meshes[(4,)]):
        solo = fleet_members(logisticregression.LogisticRegression)[0].fit(sparse_table)
    if rank == 0:
        out["fleet member 0 solo"] = np.asarray(solo.coefficient)
    del sparse_table
    if cuda:
        torch.cuda.empty_cache()

    # (d) the stream fits on this rank's rows
    stream_cols = stream_lr_data(MAX_ITER * BATCH)
    measured("stream lr", lambda m: (lambda c: ({"coefficient": c}, [c]))(np.asarray(
        estimator(logisticregression.LogisticRegression, "weight").fit(
            stream_of(stream_cols, MAX_ITER * BATCH, STREAM_CHUNK)).coefficient)), (4,))
    del stream_cols
    km_cols = {"features": kmeans_data(dev).cpu().numpy()}

    def stream_kmeans(m):
        model = kmeans_estimator().fit(stream_of(km_cols, KMEANS_ROWS, KMEANS_CHUNK))
        return {"centroids": model.centroids, "weights": model.weights}, [model.centroids]
    measured("stream kmeans", stream_kmeans, (4,))
    del km_cols

    # (e) a checkpointed 2D fit on 2 x 2 killed, then resumed on 1 x 4
    ckpt_sgd = dict(max_iter=MAX_ITER, learning_rate=LEARNING_RATE, global_batch_size=BATCH,
                    tol=TOL, shard_features=True, checkpoint_dir=spec["ckpt"],
                    checkpoint_key="mesh2d", checkpoint_interval=MESH_CKPT_INTERVAL)

    def killed(m):
        try:
            with faults.inject("chunk", after=MESH_CKPT_KILL_CHUNK):
                optimizer.SGD(**ckpt_sgd).optimize(np.zeros(SPARSE_DIM), (s_idx, s_vals), s_y,
                                                   None, losses.SPARSE_BINARY_LOGISTIC_LOSS,
                                                   mesh=m)
        except faults.InjectedFault:
            return {"killed": True}, [np.zeros(1)]
        return {"killed": False}, [np.zeros(1)]
    measured("ckpt 2x2 killed", killed, (2, 2))

    # the 2 x 2 cut kept apart for the parent's resume on one rank: the 1 x 4
    # resume writes cuts of its own after it
    if rank == 0:
        import shutil

        shutil.copytree(spec["ckpt"], spec["ckpt"] + "_one_rank")
    dist.barrier()

    def resumed(m):
        restores = metrics.get_counter("checkpoint.restore.count")
        c, _, epochs = optimizer.SGD(**ckpt_sgd).optimize(
            np.zeros(SPARSE_DIM), (s_idx, s_vals), s_y, None, losses.SPARSE_BINARY_LOGISTIC_LOSS,
            mesh=m)
        return {"coefficient": np.asarray(c), "epochs": epochs,
                "restored": restored_epoch(metrics, restores)}, [np.asarray(c)]
    measured("ckpt resumed 1x4", resumed, (1, 4))
    del s_idx, s_vals, s_y

    sequence = sanitizer.recorder.collective_sequences.get("mesh", {}).get(str(rank), [])
    out.update(
        sequence_length=len(sequence),
        sequence_problems=sanitizer.compare_rank_sequences(mesh=meshes[(2, 2)]),
        sanitizer_problems=sanitizer.recorder.problems(join_timeout=SANITIZER_JOIN_S),
        sanitizer=sanitizer.recorder.stats(),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0)
    return out


def restored_epoch(metrics, restores_before):
    """The epoch of the cut the fit just run restored (the
    `checkpoint.restore.epoch` gauge), 0 when it restored none."""
    if metrics.get_counter("checkpoint.restore.count") <= restores_before:
        return 0
    return int(metrics.get_gauge("checkpoint.restore.epoch"))


def mesh2d_expected_launches(name):
    """A rank's launches in a phase-17 fit: a 2D fit scatters its local
    gradient with `sparse_grad` an epoch unless its pairs ride the pair
    exchange (`collectives.sparse_reduce_wins`, whose scatter is not the
    kernel), and runs no row dot (the forward is a gather and a model-axis
    reduce); the replicated fit runs both kernels an epoch; the fleets
    their member-batched kernels an epoch; the killed and the resumed
    checkpointed fits share the epochs."""
    from flink_ml_tpu_torch.parallel import collectives

    def grads(batch, nd, nm, epochs):
        pairs = collectives.sparse_reduce_wins(-(-batch // nd) * NNZ, -(-SPARSE_DIM // nm))
        return 0 if pairs else epochs

    killed = MESH_CKPT_INTERVAL * MESH_CKPT_KILL_CHUNK
    per = {"2d 2x2": dict(sparse_grad=grads(BATCH, 2, 2, MAX_ITER)),
           "2d 1x4": dict(sparse_grad=grads(BATCH, 1, 4, MAX_ITER)),
           "off 2x2": dict(sparse_row_dots=MAX_ITER, sparse_grad=MAX_ITER),
           "budget 2d 2x2": dict(sparse_grad=grads(MESH_BUDGET_BATCH, 2, 2, 2)),
           "fleet default": dict(fleet_row_dots=MAX_ITER, fleet_grad=MAX_ITER),
           "fleet sharded": dict(fleet_row_dots=MAX_ITER, fleet_grad=MAX_ITER),
           "ckpt 2x2 killed": dict(sparse_grad=grads(BATCH, 2, 2, killed)),
           "ckpt resumed 1x4": dict(sparse_grad=grads(BATCH, 1, 4, MAX_ITER - killed))}
    return launch_dict(**per.get(name, {}))


def mesh2d_wire_bytes(nd, nm):
    """The per-axis wire bytes of one 2D sparse LR fit on an nd x nm mesh,
    reckoned from the shapes: `model` the (b_local, nnz) active values an
    epoch and the final gather of [flag | slice | criteria | epochs];
    `data` the [grad slice | loss | weight] payload an epoch and the
    label flag's min."""
    b_local, d_local = -(-BATCH // nd), -(-SPARSE_DIM // nm)
    return {"model": MAX_ITER * b_local * NNZ * 4 + (d_local + 3) * 4,
            "data": MAX_ITER * (d_local + 2) * 4 + 4}


def mesh_supervised_job(spec, ckpt):
    """Phase 17(f) on every rank of a supervised world: phase 3's dense LR
    (10M x 100, weighted) with checkpoints every MESH_CKPT_INTERVAL epochs
    on the world's data mesh; it restores the newest committed cut. Returns
    rank 0's coefficient, the epochs, the mesh's shape and the epoch of the
    cut it restored (0: none)."""
    import torch.distributed as dist

    module = sys.modules[__name__]
    for name, value in spec["sizes"].items():
        setattr(module, name, value)
    from flink_ml_tpu_torch.ops import losses, optimizer
    from flink_ml_tpu_torch.ops import sparsekernels as sk
    from flink_ml_tpu_torch.parallel import mesh as mesh_lib
    from flink_ml_tpu_torch.utils import metrics

    dev = torch.device(spec["device"])
    if spec["count_plain"]:
        count_plain_launches(sk)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)  # phase 3's dense table, in its order
    X = torch.rand((DENSE_ROWS, DIM), generator=gen, device=dev)
    y = torch.randint(0, 2, (DENSE_ROWS,), generator=gen, device=dev).to(torch.float32)
    w = torch.rand((DENSE_ROWS,), generator=gen, device=dev)
    m = mesh_lib.default_mesh()
    restores = metrics.get_counter("checkpoint.restore.count")
    c, _, epochs = optimizer.SGD(
        max_iter=MAX_ITER, learning_rate=LEARNING_RATE, global_batch_size=BATCH, tol=TOL,
        checkpoint_dir=ckpt, checkpoint_key="supervised", checkpoint_interval=MESH_CKPT_INTERVAL,
    ).optimize(np.zeros(DIM), X, y, w, losses.BINARY_LOGISTIC_LOSS, mesh=m)
    return {"coefficient": np.asarray(c) if dist.get_rank() == 0 else None, "epochs": epochs,
            "shape": dict(m.shape), "restored": restored_epoch(metrics, restores)}


def mesh2d_phase(card, dev, runs, world, spec, fleet_models):
    """Phase 17 (A.10b) on phase 16's gloo world (`mesh2d_rank_job`), then
    the supervisor's shrink over ranks (`supervise_world`, its own worlds),
    every result held to its gate. Returns what the output lines print."""
    from flink_ml_tpu_torch import config as port_config
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression
    from flink_ml_tpu_torch.ops import losses, optimizer
    from flink_ml_tpu_torch.ops import sparsekernels as sk
    from flink_ml_tpu_torch.parallel import supervisor
    from flink_ml_tpu_torch.utils import metrics

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh2d_")
    try:
        per_rank = world.run(mesh2d_rank_job, {**spec, "ckpt": os.path.join(tmp, "ckpt")})
        ranks_s = time.perf_counter() - t0
        out = {"seconds_by_fit": {}, "launches": {}, "counters": {}, "gaps": {},
               "peak_gib": [r["peak_gib"] for r in per_rank]}
        r0 = per_rank[0]["fits"]
        for name in r0:
            fits = [r["fits"][name] for r in per_rank]
            check(len({f["digest"] for f in fits}) == 1,
                  f"mesh2d {name}: the ranks ended with different results")
            for r, f in zip(per_rank, fits):
                check(f["launches"] == mesh2d_expected_launches(name),
                      f"mesh2d {name}: rank {r['rank']} launched {f['launches']}, expected "
                      f"{mesh2d_expected_launches(name)}")
            out["seconds_by_fit"][name] = [round(f["seconds"], 4) for f in fits]
            out["launches"][name] = [f["launches"] for f in fits]
            out["counters"][name] = r0[name]["counters"]
        for r in per_rank:
            check(not r["sequence_problems"],
                  f"rank {r['rank']}: collective sequences differ: {r['sequence_problems']}")
            check(not r["sanitizer_problems"],
                  f"rank {r['rank']}: the sanitizer found {r['sanitizer_problems']}")
        check(len({r["sequence_length"] for r in per_rank}) == 1,
              "the ranks recorded collective sequences of different lengths")
        # (a) every 2D fit against the one-rank plain-loss fit, the slices of a
        # model column equal, the wire bytes of each axis as the shapes give them
        plain_c = runs["sparse lr"]["plain_coefficient"]
        scale = float(np.max(np.abs(plain_c)))
        for name, (nd, nm, mode) in MESH2D_FITS.items():
            c = r0[name]["value"]["coefficient"]
            gap = out["gaps"][name] = max_gap(c, plain_c)
            check(gap <= 1e-4 * scale, f"mesh2d {name} differs from the one-rank plain-loss "
                                       f"fit by {gap} (gate {1e-4 * scale})")
            columns = {}
            for q, r in enumerate(per_rank):
                columns.setdefault(q % nm, set()).add(r["fits"][name]["slice_digest"])
            check(all(len(v) == 1 for v in columns.values()),
                  f"mesh2d {name}: a model column's ranks hold different slices")
            wire = {axis: r0[name]["counters"].get(f"collective.axis.{axis}.bytes", 0)
                    for axis in ("model", "data")}
            # the replicated reference: rows over all the ranks (C.36), one
            # reduce of [grad | loss | weight] an epoch and the label flag's
            want = (mesh2d_wire_bytes(nd, nm) if mode == "auto" else
                    {"model": 0, "data": MAX_ITER * (SPARSE_DIM + 2) * 4 + 4})
            check(wire == want, f"mesh2d {name}: wire bytes {wire}, reckoned {want}")
            out.setdefault("wire_bytes", {})[name] = wire
            check(r0[name]["counters"].get("dispatch.whole_fit_fallback.mesh") == 1,
                  f"mesh2d {name} was not counted as an eager mesh fit")
        # (b) the budget
        budget = r0["budget 2d 2x2"]
        check(budget["value"]["epochs"] == 2 and budget["value"]["finite"],
              f"the 2D fit under the budget did not train: {budget['value']}")
        for r in per_rank:
            peak = r["fits"]["budget 2d 2x2"]["ledger_peak"]
            check(4 * SPARSE_DIM <= peak <= mesh2d_budget_bytes(),
                  f"rank {r['rank']}: the 2D fit's ledgered peak {peak} is not its slices "
                  "within the budget")
            refused = r["fits"]["budget replicated 4"]["refused_bytes"]
            check(refused >= 8 * SPARSE_DIM,  # both carries in one staging, each leaf aligned
                  f"rank {r['rank']}: the replicated carries were not refused at admission "
                  f"({refused} bytes refused)")
        out["budget"] = {"budget_bytes": mesh2d_budget_bytes(),
                         "ledger_peak_2d": budget["ledger_peak"],
                         "refused_bytes": r0["budget replicated 4"]["refused_bytes"]}
        # (c) the fleets against phase 10's one-rank fleet, a member against
        # its solo fit on the mesh
        members = fleet_members(LogisticRegression)
        for name in ("fleet default", "fleet sharded"):
            coeffs = r0[name]["value"]["coefficients"]
            gaps = []
            for i, (c, ref, est) in enumerate(zip(coeffs, fleet_models["sparse"], members)):
                l1_step = est.get_learning_rate() * est.get_elastic_net() * est.get_reg()
                gap = max_gap(c, ref.coefficient)
                gaps.append(gap)
                check(gap <= 1e-4 * float(np.max(np.abs(ref.coefficient))) + 2.0 * l1_step,
                      f"mesh2d {name} member {i} differs from phase 10's member by {gap}")
            out["gaps"][name] = gaps
            sharded = 1.0 if name.endswith("sharded") else 0.0
            check(r0[name]["gauges"].get("fleet.sharded") == sharded,
                  f"mesh2d {name}: fleet.sharded {r0[name]['gauges']}")
        check(r0["fleet sharded"]["counters"].get("collective.all_gather.calls") == 1 and
              not r0["fleet sharded"]["counters"].get("collective.psum.calls"),
              "the fleet-sharded regime must gather once and never reduce across members")
        solo = per_rank[0]["fleet member 0 solo"]
        solo_gap = out["gaps"]["fleet default member 0 vs its solo fit"] = max_gap(
            r0["fleet default"]["value"]["coefficients"][0], solo)
        check(solo_gap <= 1e-4 * float(np.max(np.abs(solo))),
              f"a default-regime member differs from its solo fit on the mesh by {solo_gap}")
        # (d) the stream fits against the one-rank stream fits
        one = runs["stream lr"]["model"].coefficient
        c = r0["stream lr"]["value"]["coefficient"]
        out["gaps"]["stream lr"] = max_gap(c, one)
        check(np.allclose(c, one, **MESH_DENSE_TOL),
              f"mesh2d stream lr differs from the one-rank stream fit by {out['gaps']['stream lr']}")
        km = runs["stream kmeans"]["model"]
        got = r0["stream kmeans"]["value"]
        out["gaps"]["stream kmeans"] = max_gap(got["centroids"], km.centroids)
        moved = float(np.sum(np.abs(np.asarray(got["weights"]) - km.weights))) / 2
        check(out["gaps"]["stream kmeans"] <= MESH_KMEANS_SCALE_TOL * float(np.max(np.abs(
            km.centroids))) and moved <= MESH_KMEANS_POINT_SHARE * KMEANS_ROWS,
            f"mesh2d stream kmeans: centroids {out['gaps']['stream kmeans']} off, {moved} points "
            "in other cells")
        # (e) the 2 x 2 cut resumed on 1 x 4 and, from its copy taken before
        # that resume wrote cuts of its own, on this one rank: each restores
        # the killed fit's last cut and trains the epochs after it
        check(r0["ckpt 2x2 killed"]["value"]["killed"], "the checkpointed 2D fit was not killed")
        unkilled = r0["2d 2x2"]["value"]["coefficient"]
        scale2d = float(np.max(np.abs(unkilled)))
        resumed = r0["ckpt resumed 1x4"]["value"]
        killed_at = MESH_CKPT_INTERVAL * MESH_CKPT_KILL_CHUNK
        s_idx, s_vals, s_y = sparse_data(dev)
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        restores = metrics.get_counter("checkpoint.restore.count")
        one_rank = optimizer.SGD(
            max_iter=MAX_ITER, learning_rate=LEARNING_RATE, global_batch_size=BATCH, tol=TOL,
            shard_features=True, checkpoint_dir=os.path.join(tmp, "ckpt_one_rank"),
            checkpoint_key="mesh2d", checkpoint_interval=MESH_CKPT_INTERVAL,
        ).optimize(np.zeros(SPARSE_DIM), (s_idx, s_vals), s_y, None,
                   losses.SPARSE_BINARY_LOGISTIC_LOSS)
        torch.cuda.synchronize()
        one_rank_launches = sk.launch_counts()
        one_rank_restored = restored_epoch(metrics, restores)
        del s_idx, s_vals, s_y
        want_one = launch_dict(sparse_row_dots=MAX_ITER - killed_at,
                               sparse_grad=MAX_ITER - killed_at)
        check(one_rank_launches == want_one,
              f"the 2 x 2 cut resumed on one rank launched {one_rank_launches}, expected "
              f"{want_one}: it did not train the epochs after its cut")
        out["one_rank_launches"] = one_rank_launches
        for label, (c, epochs, restored) in (
                ("resumed on 1x4", (resumed["coefficient"], resumed["epochs"],
                                    resumed["restored"])),
                ("resumed on one rank", (one_rank[0], one_rank[2], one_rank_restored))):
            gap = out["gaps"][f"ckpt {label}"] = max_gap(c, unkilled)
            check(gap <= 1e-4 * scale2d and epochs == MAX_ITER and restored == killed_at,
                  f"the 2 x 2 cut {label}: {gap} from the unkilled fit, {epochs} epochs, "
                  f"restored the cut of epoch {restored} (the killed fit's last: {killed_at})")
        # (f) the supervisor's shrink over ranks
        t1 = time.perf_counter()
        ckpt = os.path.join(tmp, "supervised")
        res = supervisor.supervise_world(
            mesh_supervised_job, spec, ckpt, world_size=MESH_RANKS, hosts=MESH_SUPERVISED_HOSTS,
            fault="host.die.dispatch", after=MESH_SUPERVISED_AFTER, checkpoint_dir=ckpt,
            job_key="supervised", job_timeout_s=MESH_JOB_TIMEOUT_S,
            world_kwargs=dict(backend="gloo", device=spec["device"],
                              timeout_s=MESH_JOB_TIMEOUT_S,
                              collective_timeout_s=MESH_COLLECTIVE_TIMEOUT_S, sanitize=True))
        (event,) = res.events
        check(event.kind == "hostFailure" and event.quarantined and res.hosts == 1 and
              event.phase == "dispatch" and event.recovery_ms is not None and
              len(res.value) == MESH_RANKS // MESH_SUPERVISED_HOSTS,
              f"the supervisor did not shrink to the surviving host: {res.events}, {res.hosts}")
        # the fault fires at the dispatch of the chunk after the cut of epoch
        # (after - 1) * interval: the survivors resume there, not from 0
        last_cut = (MESH_SUPERVISED_AFTER - 1) * MESH_CKPT_INTERVAL
        for value in res.value:
            check(value["shape"] == {"data": MESH_RANKS // MESH_SUPERVISED_HOSTS} and
                  value["epochs"] == MAX_ITER and value["restored"] == last_cut,
                  f"the resumed world ran {dict(value, coefficient=None)}, expected a resume "
                  f"from the cut of epoch {last_cut}")
        value = res.value[0]
        one = runs["dense lr"]["model"].coefficient
        out["gaps"]["supervised dense lr after the shrink"] = max_gap(value["coefficient"], one)
        check(np.allclose(value["coefficient"], one, **MESH_DENSE_TOL),
              "the dense fit resumed after the shrink differs from the one-rank fit by "
              f"{out['gaps']['supervised dense lr after the shrink']}")
        out["supervisor"] = {"seconds": time.perf_counter() - t1, "attempts": res.attempts,
                             "detection_ms": event.detection_ms,
                             "recovery_ms": event.recovery_ms, "hosts_after": event.hosts_after,
                             "restored_epoch": value["restored"]}
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    out["sequence_length"] = per_rank[0]["sequence_length"]
    out["sanitizer"] = per_rank[0]["sanitizer"]
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 17 on the {MESH_RANKS} gloo ranks of phase 16: fits and checks "
        f"{ranks_s:.2f} s; the supervised shrink {out['supervisor']['seconds']:.2f} s; on {card}")
    for name in r0:
        log(f"  mesh2d {name}: seconds by rank {out['seconds_by_fit'][name]}; launches by rank "
            f"{[{k: v for k, v in c.items() if v} for c in out['launches'][name]]}; collectives "
            f"(rank 0) {out['counters'][name]}")
    log(f"  mesh2d gaps: {json.dumps(out['gaps'])}")
    log(f"  mesh2d wire bytes by axis (rank 0, as reckoned from the shapes): "
        f"{json.dumps(out['wire_bytes'])}; budget {json.dumps(out['budget'])}")
    log(f"  mesh2d supervisor: {json.dumps(out['supervisor'])}; peaks by rank (GiB): "
        f"{[round(p, 3) for p in out['peak_gib']]}; {out['sequence_length']} collectives a rank")
    return out


def lint_phase(card):
    """Phase 15: `python -m flink_ml_tpu_torch.analysis --no-cache` over
    this checkout in a fresh process (a cold lint). The registry must hold
    LINT_RULES rules and the lint exit 0 with no finding left. Then the
    interpretation gate: the SPMD interpreter (analysis/spmd.py) over the
    checkout must reach every per-rank loop phases 16-17 run
    (`spmd.RANKED_LOOPS`), each with collective events and a collective
    whose operand it resolved at one call site or more, so the mesh rules
    did not quietly give up on them. Returns the lint's wall, the gate's,
    the census of suppressed findings by rule, the rules and the gate."""
    import subprocess as sp

    from flink_ml_tpu_torch.analysis import engine, spmd

    rules = [rule.id for rule in engine.all_rules()]
    check(len(rules) == LINT_RULES, f"tpulint has {len(rules)} rules, not {LINT_RULES}: {rules}")
    here = os.path.dirname(os.path.abspath(__file__))
    module = [sys.executable, "-m", "flink_ml_tpu_torch.analysis"]
    t0 = time.perf_counter()
    proc = sp.run(module + ["--format", "json", "--no-cache"],
                  cwd=here, capture_output=True, text=True, timeout=LINT_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"tpulint exited {proc.returncode}: {proc.stdout[-3000:]} "
                                f"{proc.stderr[-2000:]}")
    report = json.loads(proc.stdout)
    check(report["clean"] and not report["findings"], f"tpulint left {report['findings']}")
    census = {}
    for finding in report["suppressed"]:
        census[finding["rule"]] = census.get(finding["rule"], 0) + 1
    log(f"  tpulint: {len(rules)} rules, exit 0 in {seconds:.2f} s (a fresh process, no "
        f"cache), {len(report['suppressed'])} suppressed findings: {dict(sorted(census.items()))}; "
        f"on {card}")
    t0 = time.perf_counter()
    project = engine.Project.load(root=here)
    gate = spmd.gate(project)
    interp = spmd.interpretation(project)
    gate_seconds = time.perf_counter() - t0
    missed = {name: row for name, row in gate.items() if not all(row)}
    check(not missed, "the SPMD interpretation missed per-rank loops (bindings, collectives, "
                      f"resolved): {missed}")
    log(f"  spmd gate: {len(interp.bodies)} ranked bodies interpreted; all {len(gate)} per-rank "
        f"loops of phases 16-17 reached with collectives and a resolved operand, in "
        f"{gate_seconds:.2f} s; events by kind {interp.counts()}")
    for name, (bindings, collectives, _) in gate.items():
        log(f"    {name}: {bindings} call-site binding(s), up to {collectives} collective(s)")
    return {"seconds": seconds, "gate_seconds": gate_seconds, "rules": rules,
            "suppressed": len(report["suppressed"]), "census": dict(sorted(census.items())),
            "bodies": len(interp.bodies), "events": interp.counts(), "gate": gate}


def example_source(path, tmp):
    """An example's source on the port: `flink_ml_tpu` rewritten to
    `flink_ml_tpu_torch`, each literal `/tmp/` path moved under the
    directory `tmp`, and the line EXAMPLE_DROPPED_LINES names for it
    (which must be there, once) dropped."""
    with open(path) as f:
        text = re.sub(r"\bflink_ml_tpu\b", "flink_ml_tpu_torch", f.read())
    text = re.sub(r"(?<=[\"'])/tmp/", f"{tmp}/", text)
    check("/tmp/" not in text.replace(f"{tmp}/", ""), f"{path} keeps a /tmp/ path")
    dropped = EXAMPLE_DROPPED_LINES.get(os.path.basename(path))
    if dropped is None:
        return text
    lines = text.split("\n")
    check(lines.count(dropped) == 1, f"{path} holds {lines.count(dropped)} lines {dropped!r}")
    lines.remove(dropped)
    return "\n".join(lines)


def examples_child(spec_json: str) -> int:
    """Phase 18's child process: each example of spec["examples"] in turn,
    rewritten (`example_source`), in this process with `__name__ ==
    "__main__"`, under the sanitizer; on the card with no device request,
    in the CPU rehearsal (spec["device"] "cpu") under `use_device("cpu")`,
    with each plain version's call counted as its kernel's launch. Prints
    one `example {json}` line an example (its seconds, stdout, launches and
    error, if any), then one `sanitizer {json}` line."""
    import contextlib
    import gc
    import io
    import shutil
    import traceback

    from flink_ml_tpu_torch import config as port_config
    from flink_ml_tpu_torch.analysis import sanitizer
    from flink_ml_tpu_torch.ops import sparsekernels as sk

    spec = json.loads(spec_json)
    on_cpu = spec["device"] == "cpu"
    if on_cpu:
        count_plain_launches(sk)
    sanitizer.enable(register_atexit=False)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    for path in spec["examples"]:
        name = os.path.basename(path)
        out, error = io.StringIO(), None
        code = compile(example_source(path, tmp), path, "exec")
        namespace = {"__name__": "__main__", "__file__": path}
        place = port_config.use_device("cpu") if on_cpu else contextlib.nullcontext()
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with place, contextlib.redirect_stdout(out):
                exec(code, namespace)
            if not on_cpu:
                torch.cuda.synchronize()
        except BaseException:  # noqa: B902 -- an example's failure is reported, not raised
            error = traceback.format_exc()
        seconds = time.perf_counter() - t0
        # the functions an example defines hold its globals in a cycle, and
        # with them what it left open (a model whose version stream it read
        # in part keeps its ingest pump): free them now, as the end of the
        # script would, not whenever the cycle collector next runs
        namespace.clear()
        gc.collect()
        print("example " + json.dumps({"name": name, "seconds": seconds, "stdout": out.getvalue(),
                                       "launches": sk.launch_counts(), "error": error}),
              flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    problems = sanitizer.recorder.problems(join_timeout=SANITIZER_JOIN_S)
    print("sanitizer " + json.dumps({"problems": problems, "stats": sanitizer.recorder.stats()}),
          flush=True)
    sanitizer.mark_exit_checked()
    return 0


def examples_phase(card):
    """Phase 18: every examples/*.py on the port in one child process
    (`examples_child`), on the card, under the sanitizer. Fails if an
    example raises or prints nothing, if the sanitizer reports a problem,
    or if SPARSE_EXAMPLE launches no `sparse_row_dots` or no
    `sparse_grad`. Returns the phase's seconds, each example's seconds,
    output lines and launches, the multi-tenant store's stats line and the
    sanitizer's stats."""
    import subprocess as sp

    here = os.path.dirname(os.path.abspath(__file__))
    paths = sorted(os.path.join(here, EXAMPLES_DIR, n)
                   for n in os.listdir(os.path.join(here, EXAMPLES_DIR)) if n.endswith(".py"))
    check(len(paths) >= 38, f"phase 18 found {len(paths)} examples, expected 38 or more")
    spec = json.dumps({"examples": paths, "device": DEVICE})
    t0 = time.perf_counter()
    proc = sp.run([sys.executable, "-c",
                   "import sys, chip_smoke; sys.exit(chip_smoke.examples_child(sys.argv[1]))", spec],
                  cwd=here, capture_output=True, text=True, timeout=EXAMPLES_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"the examples' child exited {proc.returncode}: "
                                f"{proc.stdout[-3000:]} {proc.stderr[-3000:]}")
    results, verdict = {}, None
    for line in proc.stdout.splitlines():
        if line.startswith("example {"):
            r = json.loads(line[len("example "):])
            results[r["name"]] = r
        elif line.startswith("sanitizer {"):
            verdict = json.loads(line[len("sanitizer "):])
    names = [os.path.basename(p) for p in paths]
    check(list(results) == names, f"phase 18 ran {list(results)}, expected {names}")
    failed = {n: r["error"] for n, r in results.items() if r["error"]}
    check(not failed, "examples raised on the port: " + "; ".join(
        f"{n}: {e[-1500:]}" for n, e in failed.items()))
    silent = [n for n, r in results.items() if not r["stdout"].strip()]
    check(not silent, f"examples printed nothing: {silent}")
    check(verdict is not None, "the examples' child printed no sanitizer verdict")
    check(not verdict["problems"], f"the sanitizer found {len(verdict['problems'])} problem(s) "
                                   "in the examples: " + "; ".join(verdict["problems"]))
    sparse = results[SPARSE_EXAMPLE]["launches"]
    check(sparse["sparse_row_dots"] > 0 and sparse["sparse_grad"] > 0,
          f"{SPARSE_EXAMPLE} launched {sparse}: both solo kernels must run")
    for n, r in results.items():
        made = {k: v for k, v in r["launches"].items() if v}
        log(f"  {n}: {r['seconds']:.3f} s, {len(r['stdout'].strip().splitlines())} line(s)"
            + (f"; launches {made}" if made else ""))
    store_line = next((line for line in results[MULTI_TENANT_EXAMPLE]["stdout"].splitlines()
                       if "store stats" in line), "")
    log(f"  {MULTI_TENANT_EXAMPLE}: {store_line}")
    log(f"  sanitizer (the examples' child): {json.dumps(verdict['stats'])}")
    log(f"  phase 18: {len(results)} examples green in {seconds:.2f} s (the child's wall, its "
        f"start included; the examples {sum(r['seconds'] for r in results.values()):.2f} s) on "
        f"{card}")
    return {"seconds": seconds,
            "examples": {n: {"seconds": r["seconds"], "lines": len(r["stdout"].strip().splitlines()),
                             "launches": r["launches"]} for n, r in results.items()},
            "store_stats": store_line, "sanitizer": verdict["stats"]}


def bench_configs(tmp):
    """Phase 19's config files, in order: the demo, every
    `conf/*-benchmark.json` (sorted), the demo again (for bench_diff) and
    BENCH_PROFILE_ENTRY alone (for `--profile-dir`), as (label, path).
    With BENCH_MAX_ROWS set, each is a copy under `tmp` with `numValues`
    capped; the profile entry is always a copy of its one entry."""
    here = os.path.dirname(os.path.abspath(__file__))
    conf = os.path.join(here, BENCH_CONF_DIR)
    names = [BENCH_DEMO] + sorted(n for n in os.listdir(conf) if n.endswith("-benchmark.json"))
    out = []
    for label, name in [(n, n) for n in names] + [("demo again", BENCH_DEMO)]:
        path = os.path.join(conf, name)
        if BENCH_MAX_ROWS is not None:
            path = capped_config(path, os.path.join(tmp, f"{len(out)}-{name}"))
        out.append((label, path))
    from flink_ml_tpu_torch.benchmark import runner

    demo = runner.load_config(out[0][1])
    profile = os.path.join(tmp, "profile-entry.json")
    with open(profile, "w") as f:
        json.dump({"version": 1, BENCH_PROFILE_ENTRY: demo[BENCH_PROFILE_ENTRY]}, f)
    out.append(("profile", profile))
    return out


def capped_config(path, dest):
    """A copy of the config at `path` with every generator's numValues at
    most BENCH_MAX_ROWS (the CPU rehearsal's sizes)."""
    from flink_ml_tpu_torch.benchmark import runner

    cfg = runner.load_config(path)
    for name, entry in cfg.items():
        if name == "version":
            continue
        for key in ("inputData", "modelData"):
            pm = entry.get(key, {}).get("paramMap", {})
            if "numValues" in pm:
                pm["numValues"] = min(pm["numValues"], BENCH_MAX_ROWS)
    with open(dest, "w") as f:
        json.dump(cfg, f)
    return dest


def table_placement(tables):
    """Where each column of generated `tables` lies: its device type for a
    tensor (a DictTokenMatrix's ids), "host" for anything else."""
    from flink_ml_tpu_torch.table import DictTokenMatrix

    cols = []
    for t in tables:
        for name in t.column_names:
            col = t.column(name)
            arr = col.ids if isinstance(col, DictTokenMatrix) else col
            cols.append({"name": name, "rows": int(t.num_rows),
                         "where": arr.device.type if isinstance(arr, torch.Tensor) else "host"})
    return cols


def benchmark_child(spec_json: str) -> int:
    """Phase 19's child process: `python -m flink_ml_tpu_torch.benchmark
    <config> --output-file <file>` (`--profile-dir` for the last) run in
    this process by runpy, as `-m` runs it, once for each of
    spec["configs"], under the sanitizer; on the card with no device
    request, in the CPU rehearsal under `use_device("cpu")`. Each
    generated table's placement is recorded (`table_placement`, with the
    runner's prefer-host flag) through the runner's `instantiate_generator`.
    Prints one `bench {json}` line a config (its results, placements,
    seconds, launches, bytes left allocated and allocator peak), a
    `determinism {json}` line (each device-born generator's table twice
    from one seed), a `benchdiff {json}` line (scripts/bench_diff.py over
    the two demo runs) and a `sanitizer {json}` line."""
    import contextlib
    import gc
    import io
    import runpy
    import shutil

    from flink_ml_tpu_torch import config as port_config
    from flink_ml_tpu_torch.analysis import sanitizer
    from flink_ml_tpu_torch.benchmark import datagenerator, runner
    from flink_ml_tpu_torch.ops import sparsekernels as sk

    spec = json.loads(spec_json)
    on_cpu = spec["device"] == "cpu"
    if on_cpu:
        count_plain_launches(sk)
    sanitizer.enable(register_atexit=False)
    placed = []
    resolve = runner.instantiate_generator

    def recorded(gen_spec):
        gen = resolve(gen_spec)
        make = gen.get_data

        def get_data():
            tables = make()
            placed.append({"generator": gen_spec["className"].rsplit(".", 1)[1],
                           "preferHost": datagenerator._prefer_host,
                           "columns": table_placement(tables)})
            return tables
        gen.get_data = get_data
        return gen
    runner.instantiate_generator = recorded

    def place():
        return port_config.use_device("cpu") if on_cpu else contextlib.nullcontext()

    def allocated():
        gc.collect()
        if on_cpu:
            return 0
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    configs = bench_configs(tmp)
    base = allocated()
    outputs = {}
    for i, (label, path) in enumerate(configs):
        out_file = os.path.join(tmp, f"{i}.results.json")
        argv = [path, "--output-file", out_file]
        if label == "profile":
            argv += ["--profile-dir", os.path.join(tmp, "profile")]
        placed.clear()
        sk.reset_launch_counts()
        if not on_cpu:
            torch.cuda.reset_peak_memory_stats()
        printed, error = io.StringIO(), None
        t0 = time.perf_counter()
        saved = sys.argv
        sys.argv = ["flink_ml_tpu_torch.benchmark"] + argv
        try:
            with place(), contextlib.redirect_stdout(printed):
                runpy.run_module("flink_ml_tpu_torch.benchmark", run_name="__main__")
        except Exception:  # a config's failure is reported, not raised
            import traceback

            error = traceback.format_exc()
        finally:
            sys.argv = saved
        seconds = time.perf_counter() - t0
        outputs[label] = out_file
        entries = runner.load_config(path)
        results = {}
        if error is None:
            with open(out_file) as f:
                results = json.load(f)
        trace_files = []
        if label == "profile":
            for root, _, files in os.walk(os.path.join(tmp, "profile")):
                trace_files += [os.path.join(root, n) for n in files]
        print("bench " + json.dumps({
            "label": label, "entries": {n: e for n, e in entries.items() if n != "version"},
            "results": results, "placed": list(placed), "seconds": seconds,
            "launches": sk.launch_counts(), "error": error,
            "leftBytes": allocated() - base,
            "peakBytes": 0 if on_cpu else torch.cuda.max_memory_allocated(),
            "printed": printed.getvalue()[-2000:], "traceFiles": len(trace_files)}), flush=True)

    # each device-born generator, twice from one seed (the demo's shapes)
    demo = runner.load_config(configs[0][1])
    same = {}
    with place():
        for name in ("KMeans-1", "LogisticRegression-1", "NaiveBayes-1", "HashingTF-1",
                     "Bucketizer-1"):
            gen_spec = demo[name]["inputData"]
            first, second = resolve(gen_spec).get_data(), resolve(gen_spec).get_data()
            equal, where = True, set()
            for a, b in zip(first, second):
                for col in a.column_names:
                    x, y = a.column(col), b.column(col)
                    x, y = getattr(x, "ids", x), getattr(y, "ids", y)
                    where.add(x.device.type if isinstance(x, torch.Tensor) else "host")
                    equal = equal and isinstance(x, torch.Tensor) and torch.equal(x, y)
            same[name] = {"generator": gen_spec["className"].rsplit(".", 1)[1],
                          "equal": bool(equal), "where": sorted(where)}
            del first, second
    print("determinism " + json.dumps(same), flush=True)

    import subprocess as sp

    here = os.path.dirname(os.path.abspath(__file__))
    diff = sp.run([sys.executable, os.path.join(here, "scripts", "bench_diff.py"),
                   outputs[BENCH_DEMO], outputs["demo again"]],
                  capture_output=True, text=True, timeout=120)
    print("benchdiff " + json.dumps({"rc": diff.returncode, "stdout": diff.stdout,
                                     "stderr": diff.stderr[-2000:]}), flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    problems = sanitizer.recorder.problems(join_timeout=SANITIZER_JOIN_S)
    jax_loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                                      "flink_ml_tpu"))
    print("sanitizer " + json.dumps({"problems": problems, "stats": sanitizer.recorder.stats(),
                                     "jaxModules": jax_loaded}), flush=True)
    sanitizer.mark_exit_checked()
    return 0


def benchmark_phase(card):
    """Phase 19: the port's benchmark CLI over the demo and every
    `conf/*-benchmark.json`, at their own shapes, in one child process
    (`benchmark_child`) on the card under the sanitizer. Fails if an entry
    raises, if its result keys are not `runner.RESULT_KEYS`, if its
    inputRecordNum is not its generator's numValues or its
    outputRecordNum not `bench_output_rows`, if a numeric or token column
    of a device generator at or above DEVICE_GEN_THRESHOLD rows lies off
    the device (or on it, for a `prefers_host_input` stage), if a config
    leaves more than BENCH_LEFT_BYTES allocated, if an entry launches a
    kernel (no `conf/` entry is sparse), if a device-born table differs
    from its twin of the same seed, if bench_diff exits 2, if the profile
    run writes no trace file, if the sanitizer reports a problem or if the
    child imported JAX. Returns the phase's seconds, each entry's numbers
    and the checks' verdicts."""
    import subprocess as sp

    from flink_ml_tpu_torch.benchmark import datagenerator, runner

    here = os.path.dirname(os.path.abspath(__file__))
    spec = json.dumps({"device": DEVICE})
    t0 = time.perf_counter()
    proc = sp.run([sys.executable, "-c",
                   "import sys, chip_smoke; chip_smoke.BENCH_MAX_ROWS = "
                   f"{BENCH_MAX_ROWS!r}; sys.exit(chip_smoke.benchmark_child(sys.argv[1]))",
                   spec], cwd=here, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"the benchmark child exited {proc.returncode}: "
                                f"{proc.stdout[-3000:]} {proc.stderr[-3000:]}")
    runs, same, diff, verdict = [], None, None, None
    for line in proc.stdout.splitlines():
        if line.startswith("bench {"):
            runs.append(json.loads(line[len("bench "):]))
        elif line.startswith("determinism {"):
            same = json.loads(line[len("determinism "):])
        elif line.startswith("benchdiff {"):
            diff = json.loads(line[len("benchdiff "):])
        elif line.startswith("sanitizer {"):
            verdict = json.loads(line[len("sanitizer "):])
    configs = sorted(n for n in os.listdir(os.path.join(here, BENCH_CONF_DIR))
                     if n.endswith("-benchmark.json"))
    labels = [BENCH_DEMO] + configs + ["demo again", "profile"]
    check([r["label"] for r in runs] == labels,
          f"phase 19 ran {[r['label'] for r in runs]}, expected {labels}")
    failed = {r["label"]: r["error"] for r in runs if r["error"]}
    check(not failed, "benchmark configs raised on the port: " + "; ".join(
        f"{n}: {e[-1500:]}" for n, e in failed.items()))
    threshold = datagenerator.DEVICE_GEN_THRESHOLD
    device_born = ("DenseVectorGenerator", "DoubleGenerator", "LabeledPointWithWeightGenerator",
                   "RandomStringArrayGenerator")
    entries = {}
    for r in runs:
        names = list(r["entries"])
        check(list(r["results"]) == names, f"{r['label']}: results for {list(r['results'])}, "
                                           f"expected {names}")
        check(len(r["placed"]) == len(names), f"{r['label']}: {len(r['placed'])} generated "
                                              f"tables for {len(names)} entries")
        check(not any(r["launches"].values()), f"{r['label']} launched {r['launches']}: no "
                                               "conf/ entry is sparse")
        check(r["leftBytes"] <= BENCH_LEFT_BYTES,
              f"{r['label']} left {r['leftBytes']} bytes allocated after its entries")
        for (name, entry), placed in zip(r["entries"].items(), r["placed"]):
            res = r["results"][name]["results"]
            check(r["results"][name]["stage"] == entry["stage"], f"{name}: the stage echoed")
            check(set(res) == runner.RESULT_KEYS,
                  f"{name}: result keys {sorted(set(res) ^ runner.RESULT_KEYS)} differ")
            n = int(entry["inputData"]["paramMap"].get("numValues", 10))
            check(res["inputRecordNum"] == n, f"{name}: inputRecordNum {res['inputRecordNum']} "
                                              f"against numValues {n}")
            want = bench_output_rows(entry, n)
            check(res["outputRecordNum"] == want,
                  f"{name}: outputRecordNum {res['outputRecordNum']}, expected {want}")
            where = {c["where"] for c in placed["columns"]}
            if placed["preferHost"]:
                check(where == {"host"}, f"{name}: a prefers_host_input stage got {where}")
            elif placed["generator"] in device_born and n >= threshold:
                check(where == {torch.device(DEVICE).type},
                      f"{name}: {placed['generator']} at {n} rows placed {where}")
            if r["label"] in ("demo again", "profile"):
                continue
            entries[name] = {
                "config": r["label"], "totalTimeMs": res["totalTimeMs"],
                "phaseTimesMs": res["phaseTimesMs"], "inputThroughput": res["inputThroughput"],
                "peakHbmBytes": res["peakHbmBytes"], "hostSyncCount": res["hostSyncCount"],
                "gapCount": res["gapCount"], "hostDispatchMs": res["hostDispatchMs"],
                "inputRecordNum": n, "outputRecordNum": res["outputRecordNum"],
                "placement": sorted(where), "preferHost": placed["preferHost"]}
    check(len(entries) == 44, f"phase 19 ran {len(entries)} entries, expected 44")
    check(runs[-1]["traceFiles"] > 0, "--profile-dir wrote no trace file")
    check(same is not None and all(v["equal"] for v in same.values())
          and all(v["where"] == [torch.device(DEVICE).type] for v in same.values()),
          f"device-born tables from one seed differ or lie off the device: {same}")
    check(diff is not None and diff["rc"] in (0, 1),
          f"bench_diff over the two demo runs exited {diff and diff['rc']}: {diff}")
    check(verdict is not None, "the benchmark child printed no sanitizer verdict")
    check(not verdict["problems"], f"the sanitizer found {len(verdict['problems'])} problem(s) "
                                   "in the benchmark child: " + "; ".join(verdict["problems"]))
    check(not verdict["jaxModules"], f"the benchmark child imported {verdict['jaxModules']}")
    for name, e in entries.items():
        phases = ", ".join(f"{k} {v:.3f}" for k, v in e["phaseTimesMs"].items())
        log(f"  {name} ({e['config']}): totalTimeMs {e['totalTimeMs']:.3f} [{phases}], "
            f"inputThroughput {e['inputThroughput']:.1f} rec/s, peakHbmBytes "
            f"{e['peakHbmBytes']}, hostSyncCount {e['hostSyncCount']}, gapCount "
            f"{e['gapCount']} ({e['hostDispatchMs']:.3f} ms), {e['inputRecordNum']} -> "
            f"{e['outputRecordNum']} rows, tables on {e['placement']}")
    for r in runs:
        log(f"  {r['label']}: {r['seconds']:.2f} s, left {r['leftBytes'] / 2**20:.1f} MiB, "
            f"allocator peak {r['peakBytes'] / 2**30:.2f} GiB")
    log("  determinism: " + json.dumps(same))
    shown = [line for line in diff["stdout"].splitlines()
             if re.search(r"totalTimeMs|Throughput|regression|compared metrics", line)]
    log(f"  bench_diff demo against demo again (exit {diff['rc']}; not a gate: host-bound "
        "entries spread between runs; its time and throughput rows):\n" + "\n".join(
            "    " + line for line in shown))
    log(f"  sanitizer (the benchmark child): {json.dumps(verdict['stats'])}")
    log(f"  phase 19: {len(entries)} entries of {len(runs) - 2} configs green in {seconds:.2f} s "
        f"(the child's wall, its start included; the entries "
        f"{sum(e['totalTimeMs'] for e in entries.values()) / 1e3:.2f} s of totalTimeMs) on {card}")
    return {"seconds": seconds, "entries": entries,
            "configs": {r["label"]: {"seconds": r["seconds"], "leftBytes": r["leftBytes"],
                                     "peakBytes": r["peakBytes"]} for r in runs},
            "determinism": same, "bench_diff_rc": diff["rc"], "sanitizer": verdict["stats"],
            "launches": launch_dict()}


def bench_output_rows(entry, n):
    """The rows a `conf/` entry's transform gives for n input rows (the
    relation tests/test_torch_benchmark.py pins on both packages): n, and
    for AgglomerativeClustering its merge table's n - numClusters rows
    besides."""
    if entry["stage"]["className"].rsplit(".", 1)[1] == "AgglomerativeClustering":
        return n + n - int(entry["stage"].get("paramMap", {}).get("numClusters", 2))
    return n


# -- phase 20: the repo's operator tools on the port -----------------------------------
#: the tools of scripts/ that phase 20 runs, each the port's counterpart of
#: a JAX script of the same name without `torch_`
TOOL_SCRIPTS = ("torch_obs_report.py", "torch_obs_timeline.py", "torch_smoke_fit_timeline.py",
                "torch_coldstart_smoke.py", "torch_make_reference_fixture.py",
                "torch_gen_operator_docs.py")
#: how a CPU rehearsal runs a tool: the script as `__main__` under
#: `use_device("cpu")` (the tools take no device flag, as the JAX ones)
CPU_TOOL_RUNNER = ("import runpy, sys\n"
                   "from flink_ml_tpu_torch import config\n"
                   "sys.argv = sys.argv[1:]\n"
                   "with config.use_device('cpu'):\n"
                   "    runpy.run_path(sys.argv[0], run_name='__main__')\n")
SANITIZER_CLEAN = "FLINK_ML_TPU_SANITIZE: clean"


def traced_fit_child(spec_json: str) -> int:
    """Phase 20(a)'s child: phase 3's sparse LR through the public
    LogisticRegression (fit, transform, save, load, transform) at
    spec's sizes, with the trace and timeline sinks its parent set in the
    environment; on the card with no device request, in the CPU rehearsal
    under `use_device("cpu")` with each plain version's call counted as its
    kernel's launch. Writes the coefficients to spec["coefficient"] and
    prints one `traced {json}` line: the launches, the first calls' times
    and the transform's largest distance from the plain row dots."""
    import contextlib
    import shutil

    spec = json.loads(spec_json)
    for name in ("SPARSE_ROWS", "SPARSE_DIM", "NNZ", "MAX_ITER", "BATCH"):
        globals()[name] = spec[name]  # the parent's sizes (the rehearsal's are small)
    from flink_ml_tpu_torch import SparseBatch, Table
    from flink_ml_tpu_torch import config as port_config
    from flink_ml_tpu_torch.api import Stage
    from flink_ml_tpu_torch.models.classification import logisticregression
    from flink_ml_tpu_torch.ops import sparsekernels as sk

    on_cpu = spec["device"] == "cpu"
    if on_cpu:
        count_plain_launches(sk)

    def sync():
        if not on_cpu:
            torch.cuda.synchronize()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_traced_")
    with port_config.use_device("cpu") if on_cpu else contextlib.nullcontext():
        dev = torch.device(spec["device"])
        s_idx, s_vals, s_y = sparse_data(dev)
        table = Table({"features": SparseBatch(SPARSE_DIM, s_idx, s_vals), "label": s_y})
        sync()
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        model = estimator(logisticregression.LogisticRegression).fit(table)
        sync()
        fit_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        out = model.transform(table)[0]
        sync()
        transform_ms = (time.perf_counter() - t0) * 1e3
        path = os.path.join(tmp, "model")
        model.save(path)
        again = Stage.load(path).transform(table)[0]
        sync()
        launches = sk.launch_counts()
        coeff = torch.as_tensor(model.coefficient, device=dev)
        raw = out.column("rawPrediction")
        want = logisticregression._predict_from_dot(sk.sparse_row_dots_plain(s_idx, s_vals,
                                                                              coeff))[1]
        err = float((raw - want).abs().max())
        close = bool(torch.allclose(raw, want, **ROW_DOTS_TOL))
        reloaded = bool(torch.equal(again.column("rawPrediction"), raw))
        shape_ok = tuple(raw.shape) == tuple(want.shape) and bool(torch.isfinite(raw).all())
    np.save(spec["coefficient"], np.asarray(model.coefficient))
    shutil.rmtree(tmp, ignore_errors=True)
    print("traced " + json.dumps({"launches": launches, "fit_ms": fit_ms,
                                  "transform_ms": transform_ms, "transform_max_abs_err": err,
                                  "transform_close": close, "reload_equal": reloaded,
                                  "shape_ok": shape_ok}), flush=True)
    return 0


def tool_command(script, args):
    """scripts/<script> with `args` as a user runs it on the card, or (the
    CPU rehearsal) the same script as `__main__` under `use_device("cpu")`."""
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, "scripts", script)
    if DEVICE == "cuda":
        return [sys.executable, path, *args]
    return [sys.executable, "-c", CPU_TOOL_RUNNER, path, *args]


def imported_jax(stderr):
    """The modules of jax, jaxlib or flink_ml_tpu in a `python -X
    importtime` process's stderr (each import's line ends in its name)."""
    names = (line.rsplit("|", 1)[1].strip() for line in stderr.splitlines()
             if line.startswith("import time:") and "|" in line)
    return sorted({n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flink_ml_tpu")})


def run_step(label, cmd, card, env=None, expect_rc=0):
    """One fresh process of phase 20 from the checkout's root, under the
    sanitizer (`FLINK_ML_TPU_SANITIZE=1`, so it ends with status 66 on a
    violation, else with its clean verdict on stderr) and `-X importtime`
    (each module it imports named on stderr). Fails the run on another
    exit status than `expect_rc`, a missing verdict, or an import of jax
    or the JAX package, which the machine with the card may have
    installed. Returns its stdout, stderr and seconds."""
    import subprocess as sp

    here = os.path.dirname(os.path.abspath(__file__))
    child_env = {**os.environ, **(env or {}), "FLINK_ML_TPU_SANITIZE": "1"}
    t0 = time.perf_counter()
    proc = sp.run([cmd[0], "-X", "importtime", *cmd[1:]], cwd=here, env=child_env,
                  capture_output=True, text=True, timeout=TOOLS_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    stderr = "\n".join(line for line in proc.stderr.splitlines()
                       if not line.startswith("import time:"))
    check(proc.returncode == expect_rc, f"phase 20 {label} exited {proc.returncode}, expected "
                                        f"{expect_rc}: {proc.stdout[-3000:]} {stderr[-3000:]}")
    check(SANITIZER_CLEAN in stderr, f"phase 20 {label}: no clean sanitizer verdict: "
                                     f"{stderr[-2000:]}")
    jax_modules = imported_jax(proc.stderr)
    check(not jax_modules, f"phase 20 {label} imported {jax_modules[:10]}")
    log(f"  {label}: {seconds:.2f} s (exit {proc.returncode}, no jax module imported) on {card}")
    return {"stdout": proc.stdout, "stderr": stderr, "seconds": seconds}


def same_tree(got, want, names):
    """The relative paths under `want`'s `names` whose bytes `got` lacks or
    differs in (both directions)."""
    def files(root):
        out = {}
        for name in names:
            for base, _, found in os.walk(os.path.join(root, name)):
                for f in found:
                    full = os.path.join(base, f)
                    with open(full, "rb") as fh:
                        out[os.path.relpath(full, root)] = fh.read()
        return out
    a, b = files(got), files(want)
    return sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))


def tools_phase(card, runs):
    """Phase 20: the operator tools of scripts/ on the port, each step a
    fresh process under the sanitizer (`run_step`). The steps on the card
    run one at a time: the traced fit, the fit-timeline smoke, then the
    cold-start smoke's three processes alone (their walls are reported);
    the steps that need no card (the report, the timelines, the writers)
    run beside the first two. Fails if a step exits otherwise than its JAX
    counterpart would on success, if a sanitizer verdict is missing, if
    the traced fit's launches differ from phase 3's for the same path or
    its results from phase 4's references, if the report drops a record or
    lacks the fit or the transform, if the attribution's parts miss its
    window or the whole fit is not one dispatch, if the fit-timeline
    smoke's cycles are not 7 and 1, if the cold-start serve traced or
    compiled or its output differs from the baseline's, or if a writer's
    output differs from the committed files. Returns the phase's seconds,
    the launches and each step's numbers."""
    import importlib.util
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from flink_ml_tpu_torch.ops import sparsekernels as sk

    here = os.path.dirname(os.path.abspath(__file__))
    jax_absent = importlib.util.find_spec("jax") is None
    log(f"  importlib.util.find_spec('jax') is None: {jax_absent} (this machine "
        f"{'has no' if jax_absent else 'has a'} JAX; each process below is held to import "
        "none of it)")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    steps = {}
    trace, events = os.path.join(tmp, "trace.jsonl"), os.path.join(tmp, "events.jsonl")
    fixtures, doc = os.path.join(tmp, "fixtures"), os.path.join(tmp, "torch_operators.md")
    chrome = os.path.join(tmp, "fit.timeline.json")
    def tool(label, script, args):
        return run_step(label, tool_command(script, args), card)

    with ThreadPoolExecutor(max_workers=4) as beside:
        # (d) the writers: no card needed, no JAX either
        writers = {
            "fixtures": beside.submit(tool, "torch_make_reference_fixture.py",
                                      "torch_make_reference_fixture.py", ["--out", fixtures]),
            "docs": beside.submit(tool, "torch_gen_operator_docs.py",
                                  "torch_gen_operator_docs.py", ["--out", doc])}

        # (a) a traced fit, then the report and the timeline over it
        coeff_path = os.path.join(tmp, "coefficient.npy")
        spec = json.dumps({"device": DEVICE, "SPARSE_ROWS": SPARSE_ROWS,
                           "SPARSE_DIM": SPARSE_DIM, "NNZ": NNZ, "MAX_ITER": MAX_ITER,
                           "BATCH": BATCH, "coefficient": coeff_path})
        step = run_step("traced sparse LR child", [
            sys.executable, "-c",
            "import sys, chip_smoke; sys.exit(chip_smoke.traced_fit_child(sys.argv[1]))", spec],
            card, env={"FLINK_ML_TPU_TRACE_FILE": trace, "FLINK_ML_TPU_TIMELINE_FILE": events})
        readers = {
            "text": beside.submit(tool, "torch_obs_report.py (text)", "torch_obs_report.py",
                                  [trace]),
            "json": beside.submit(tool, "torch_obs_report.py --format json",
                                  "torch_obs_report.py", [trace, "--format", "json"]),
            "timeline": beside.submit(tool, "torch_obs_timeline.py --attribution --json",
                                      "torch_obs_timeline.py",
                                      [events, "-o", chrome, "--attribution", "--json"])}

        # (b) the fit-timeline smoke, and both of its dumps rendered
        dump = os.path.join(tmp, "smoke.jsonl")
        smoke = tool("torch_smoke_fit_timeline.py", "torch_smoke_fit_timeline.py", [dump])
        renders = {name: beside.submit(tool, f"torch_obs_timeline.py {name}",
                                       "torch_obs_timeline.py",
                                       [os.path.join(tmp, name), "-o",
                                        os.path.join(tmp, name + ".timeline.json")])
                   for name in ("smoke.jsonl", "smoke-wholefit.jsonl")}
        writers = {k: f.result() for k, f in writers.items()}
        readers = {k: f.result() for k, f in readers.items()}
        rendered = {k: f.result()["stdout"].strip() for k, f in renders.items()}

    lines = [line for line in step["stdout"].splitlines() if line.startswith("traced {")]
    check(len(lines) == 1, f"the traced child printed {len(lines)} result lines")
    traced = json.loads(lines[0][len("traced "):])
    want_launches = runs["sparse lr"]["launches"]
    check(traced["launches"] == want_launches,
          f"the traced sparse LR launched {traced['launches']}, phase 3 {want_launches}")
    plain = runs["sparse lr"]["plain_coefficient"]
    coeff_err = float(np.max(np.abs(np.load(coeff_path) - plain)))
    scale = float(np.max(np.abs(plain)))
    check(coeff_err <= 1e-4 * scale, f"the traced fit's coefficients lie {coeff_err} from the "
                                     f"plain-loss fit (scale {scale})")
    check(traced["shape_ok"] and traced["transform_close"] and traced["reload_equal"],
          f"the traced transform: {traced}")
    steps["traced fit"] = {**traced, "seconds": step["seconds"], "coeff_max_abs_err": coeff_err}
    log(f"  traced sparse LR: fit {traced['fit_ms']:.1f} ms, transform "
        f"{traced['transform_ms']:.1f} ms (first calls, the trace and timeline sinks on); launches "
        f"{traced['launches']} (phase 3: {want_launches}); coefficients {coeff_err:.3g} from the "
        f"plain-loss fit (scale {scale:.3g}), transform {traced['transform_max_abs_err']:.3g} from "
        f"the plain row dots, on {card}")

    stage_names = ("LogisticRegression.fit", "LogisticRegressionModel.transform")
    text, as_json, tl = readers["text"], readers["json"], readers["timeline"]
    check("dropped" not in text["stderr"], f"the report dropped records: {text['stderr'][-1000:]}")
    check(all(n in text["stdout"] for n in stage_names),
          f"the text report lacks {stage_names}: {text['stdout'][-2000:]}")
    check("dropped" not in as_json["stderr"], "the JSON report dropped records")
    labels = [st["label"] for st in json.loads(as_json["stdout"])["stages"]]
    check(all(n in labels for n in stage_names), f"the JSON report's stages are {labels}")
    check("dropped" not in tl["stderr"] and "skipped" not in tl["stderr"],
          f"the timeline dropped events: {tl['stderr'][-1000:]}")
    attr = json.loads(tl["stdout"][tl["stdout"].index("{"):])
    parts = sum(attr[k] for k in ("dispatchMs", "deviceMs", "readbackMs", "idleGapMs"))
    check(abs(parts - attr["windowMs"]) <= 1e-6, f"attribution parts {parts} ms against window "
                                                 f"{attr['windowMs']} ms")
    check(attr["gapCount"] == 1, f"the whole fit showed {attr['gapCount']} dispatches")
    with open(chrome) as f:
        chrome_events = len(json.load(f)["traceEvents"])
    steps["report"] = {"stages": labels, "seconds": text["seconds"] + as_json["seconds"]}
    steps["timeline"] = {"attribution": {k: attr[k] for k in (
        "windowMs", "gapCount", "dispatchMs", "deviceMs", "readbackMs", "idleGapMs")},
        "chromeEvents": chrome_events, "seconds": tl["seconds"]}
    log(f"  report stages {labels}; timeline {chrome_events} trace events, attribution "
        + ", ".join(f"{k} {attr[k]:.3f}" for k in ("windowMs", "dispatchMs", "deviceMs",
                                                   "readbackMs", "idleGapMs"))
        + f" ms over {attr['gapCount']} dispatch(es), on {card}")

    for want in ("smoke fit (chunked): 56 epochs", "over 7 chunks",
                 "smoke fit (whole-fit): 56 epochs", "over 1 chunks",
                 "budget probe: clean typed rejection"):
        check(want in smoke["stdout"], f"the fit-timeline smoke printed no {want!r}: "
                                       f"{smoke['stdout'][-2000:]}")
    steps["fit timeline smoke"] = {"stdout": smoke["stdout"].strip().splitlines(),
                                   "rendered": rendered, "seconds": smoke["seconds"]}

    committed = os.path.join(here, "tests", "fixtures")
    names = sorted(n for n in os.listdir(committed) if n.startswith("reference_"))
    check(sorted(os.listdir(fixtures)) == names,
          f"the fixture writer wrote {sorted(os.listdir(fixtures))}, committed {names}")
    differ = same_tree(fixtures, committed, names)
    check(not differ, f"the fixture writer's files differ from the committed ones: {differ}")
    with open(doc, "rb") as f, open(os.path.join(here, "docs", "torch_operators.md"), "rb") as g:
        check(f.read() == g.read(), "docs/torch_operators.md is not what the writer writes")
    steps["writers"] = {"fixture dirs": len(names), "docs": writers["docs"]["stdout"].strip(),
                        "seconds": writers["fixtures"]["seconds"] + writers["docs"]["seconds"]}

    # (c) the cold-start smoke: populate, serve, baseline, each a fresh process, alone
    bank = os.path.join(tmp, "bank")
    cold = {}
    for mode in ("populate", "serve", "baseline"):
        out = tool(f"torch_coldstart_smoke.py {mode}", "torch_coldstart_smoke.py", [bank, mode])
        cold[mode] = {**json.loads(out["stdout"].strip().splitlines()[-1]),
                      "seconds": out["seconds"]}
    serve, base = cold["serve"], cold["baseline"]
    check(serve["serveTraceCount"] == 0 and serve["serveCompileCount"] == 0
          and serve["bankHits"] > 0 and serve["bankLoads"] > 0, f"cold-start serve: {serve}")
    check(serve["outSha"] == base["outSha"],
          f"cold-start serve's output {serve['outSha']} is not the baseline's {base['outSha']}")
    steps["coldstart"] = cold
    for mode in ("serve", "baseline"):
        log(f"  cold start {mode}: coldStartMs {cold[mode]['coldStartMs']:.3f}, firstServeMs "
            f"{cold[mode]['firstServeMs']:.3f}, traces {cold[mode]['serveTraceCount']:.0f}, "
            f"compiles {cold[mode]['serveCompileCount']:.0f}, bank hits "
            f"{cold[mode]['bankHits']:.0f}, loads {cold[mode]['bankLoads']:.0f} "
            f"({cold[mode]['bankLoadMs']:.3f} ms), on {card}")
    shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    log(f"  phase 20: {len(TOOL_SCRIPTS)} tools green in {seconds:.2f} s on {card}")
    return {"seconds": seconds, "jax_absent": jax_absent, "steps": steps,
            "launches": {k: traced["launches"][k] for k in sk.launch_counts()}}


def profile_run(name, run):
    """A profiler pass over one warm call (a fit or a transform) through
    utils/traceprof.capture_trace: the wall time, the device's busy time
    (the union of its kernels and copies) and the largest kernels.
    Returns the wall, busy time and idle share. A replayed CUDA graph's
    kernels appear only where the profiler reports graph kernels: the
    line prints how many device events the trace held."""
    from flink_ml_tpu_torch.utils import traceprof

    stats = traceprof.capture_trace(run)
    wall_ms, busy_ms = stats["wallMs"], stats["deviceBusyMs"]
    idle = 1.0 - busy_ms / wall_ms
    log(f"  profile {name}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
        f"idle {100.0 * idle:.1f}% ({stats['deviceEvents']} device events)")
    for kernel, top in list(stats["topKernels"].items())[:8]:
        log(f"    {top['durUs'] / 1e3:8.3f} ms  x{top['count']:<4d} {kernel[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle": idle,
            "device_events": stats["deviceEvents"]}


if __name__ == "__main__":
    sys.exit(main())
