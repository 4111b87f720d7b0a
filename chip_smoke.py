"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (one JSON line each; any failure raises and exits non-zero):
  1. device  — the card's name and nvidia-smi's name and power limit.
  2. build   — nvcc builds every kernel of the path into build/kernels/,
     one process a library, all started together.
  3. kernel vs plain — the CUDA layered kernel against its plain PyTorch
     version on the same LLRs on the card: bits, ok, iterations and the
     final posteriors must be identical (fixed and track mode, rate 1/2,
     3/4 and 9/10 — row
     degrees 7-8, 14-15 and 30-31, one build of the kernel each — scalar
     and offset alpha/beta, the learned schedule, the stored trap batch,
     and each main-path leg's shapes), and the tile plans
     (decode/layered_qc.tile_plan): the 32-frame cases take clusters of 4
     (DSMEM), 13 frames the fallback's plan (one frame to a cluster of 8),
     8023an at 601 frames a cluster of one with a ragged last tile, and
     the leg shapes a cluster of one a frame with the lowest-degree
     block-columns in the L2 scratch. Each case prints its plan and the
     clusters resident (cudaOccupancyMaxActiveClusters); the cases must
     include a plan with CS > 1 and one with CS = 1.
  4. main path — the three benchmark legs through bench.run_benchmark
     (headline dvbs2/64800/12 fixed-25 at batch 4096; rate 3/4; the
     production leg with early termination and the learned schedule),
     with the kernel's launch count read around them.
  5. waterfall — frame error rates at 0.95 and 1.2 dB inside bands set
     from curves/dvbs2_64800_12_tpu_golden.json (same surrogate code; a
     frame error is a wrong message bit, as the golden sweep counted).
  6. exact kernel vs plain — the layered exact-BP kernel (spa and
     minstar) against its plain version on the same LLRs on the card:
     rate 1/2 fixed at 1.0 dB and track at 1.2 dB (32 frames, and 13
     for a ragged last tile), rate 3/4 fixed at 3.0 dB, rate 9/10 fixed
     at 4.0 dB and track at 3.8 dB (its 8-, 16- and 32-wide builds), the
     stored trap batch with layered/spa/50, each rule at the timed
     shape (4096 frames), and 8023an at 601 frames (CS = 1, ragged).
     Bits, ok and iterations must be identical, and the posteriors after
     one sweep within EXACT_MAX_ULPS; plans printed and gated as in 3.
  7. exact kernel timed — run_benchmark on dvbs2/64800/12 with
     layered/spa/25/noet and layered/minstar/25/noet at 4096 frames,
     1.5 dB: ms, launches, bound, plain ms, FER <= 0.01.
  8. sweep vs golden — run_sweep of layered/norm:0.8125/25 at 1.0, 1.05
     and 1.1 dB (batch 2048, 100 frame errors or 32768 frames) must
     overlap the golden FER curve (report.curves_overlap).
  9. production inputs — the production sweep's first batch of 4096
     frames at 1.5 dB, drawn as run_sweep draws it, through the min-sum
     kernel and its plain version with the primary layered/norm:0.8125/50
     (track mode); the rows it failed through the exact kernel and its
     plain version with the fallback layered/spa/50; criteria as in 3
     and 6, plans printed.
  10. production path — the CLI's sweep with the production retry decoder
     layered/norm:0.8125/50;retry=layered/spa/50 at 1.5 dB, 65536 frames
     in batches of 4096: FER <= 1.5e-4, the fallback fired, the exact
     kernel launched; then the 8 trap frames through the same decoder:
     the primary fails all 8 and the retry recovers each codeword.
  11. flooding kernel vs plain — K2 (csrc/flooding.cu) against its plain
     version on mackay1008 on the same LLRs on the card: minsum fixed at
     2.5 dB and track at 2.0 dB, spa and minstar fixed and track at
     1.5 dB (32 frames; 13, a frame a tile), each rule in track mode
     at 601 frames (F >= 2, a ragged last tile) and minsum fixed there,
     minsum track at 2048 frames (tiles of 2 whose frames stop at
     different iterations), each rule at the timed leg's shape (2048
     frames), and the form "global" on a seeded (3,6)-regular n = 16384
     graph (bench/flooding_probe.regular_graph; the all-zero codeword's
     LLRs), minsum track and spa fixed. Bits, ok and iterations identical;
     posteriors after one iteration within EXACT_MAX_ULPS. Each case
     prints its plan (decode/flooding.flooding_plan: a tile's whole state
     in one block's shared memory, form "chip", or in a device-memory
     scratch, form "global") and the blocks launched; the cases must
     include both forms, a ragged tile of F >= 2 and such a track tile.
  12. QC flooding kernel vs plain — K3 (csrc/flooding_qc.cu) the same
     way on dvbs2/64800/12, each rule: fixed at 1.5 dB and track at 1.2
     dB (32 and 13 frames), r=3/4 fixed at 3.0 dB and r=9/10 fixed at 4.0
     dB (its 16- and 32-wide builds), the stored trap batch with spa/50,
     and each timed leg's shape (4096 frames). Each case prints the tile
     plan (decode/layered_qc.tile_plan, form "flooding": a dvbs2/64800
     frame over a cluster of 8, its whole decoder state on chip) and the
     clusters resident.
  13. flooding legs timed — bench.FLOODING_LEGS through run_benchmark
     (mackay1008 minsum, and spa and minstar on the same shape; the three
     dvbs2/64800/12 flooding legs): ms, Mbit/s, launches, bound, plain ms,
     FER (mackay1008 <= 0.01; the DVB-S2 legs are held to no band: the
     repo stores no flooding FER for that code); each mackay1008 leg also
     K2's device and host µs a decode (bench/flooding_probe.time_decode)
     and its plan.
  14. mackay1008 sweep vs golden — run_sweep of spa/50 and
     minsum/norm:0.8125/25 at 1.5 and 2.0 dB (batch 4096, 100 frame
     errors or 65536 frames) must overlap curves/mackay1008_tpu_golden.json
     and curves/mackay1008_cpu_golden.json.
  15. flooding fallback in production — the CLI's sweep with
     layered/norm:0.8125/50;retry=spa/50 at 1.5 dB, 65536 frames in
     batches of 4096: FER <= 1.5e-4, K1a and K3 launched, the fallback
     got frames; then the 8 trap frames: the primary fails all 8 and the
     flooding retry recovers each codeword.
  16. classic kernel vs plain — K1b/K1c' (csrc/layered_classic.cu, graphs
     that repeat a block-column in a layer) against its plain version on
     ccsds/4096/12, /23 and /45 (row degrees 6, 10 and 18: its 8-, 16- and
     32-wide builds), each rule fixed and track (32 frames, and 13 for a
     ragged last tile) at an Eb/N0 where some of 32 frames fail; min-sum
     also with offset:0.15 and the per-iteration schedule
     dvbs2_64800_12_T25; each rule at the timed shape (4096 frames, a
     frame an SM); each rule in track mode on ccsds/1024/12 at 601 frames
     (several frames a tile, a ragged last tile) and on ccsds/16384/12 at
     16 frames (a frame over a cluster of 8; the all-zero codeword's LLRs,
     since the port cannot encode k = 16384 yet); two K3 cases (spa fixed
     and track) on the multi-edge ccsds/4096/12 and one on ccsds/4096/45 at
     601 frames (its LLRs read from [B, n], not held on chip). Bits, ok and
     iterations identical; posteriors after one sweep within
     EXACT_MAX_ULPS; each case prints its tile plan (form "classic") and
     the clusters resident, and the cases must include a plan with
     F >= 2 and one with CS > 1. The other layered kernels refuse a
     multi-edge graph and the classic kernel a graph without one.
  17. CCSDS legs timed — bench.CCSDS_LEGS through run_benchmark
     (ccsds/4096/12, 2.5 dB, 4096 frames, layered/{norm:0.8125,spa,minstar}
     /25/noet): ms, Mbit/s, launches, bound, plain ms, FER < 0.5.
  18. CCSDS sweep vs the JAX reference — run_sweep of
     layered/norm:0.8125/50 at 2.0 and 2.5 dB, 8192 frames each, must
     overlap ecc_ldpc_tpu_torch/data/ccsds_4096_12_jax_cpu.json.
  19. CCSDS production path — the CLI's sweep with
     layered/norm:0.8125/50;retry=layered/spa/50 at the reference's retry
     points, 1.5 and 2.5 dB, 65536 frames each in batches of 4096: the
     classic kernel ran both the primary (min-sum) and the fallback (spa),
     the fallback got frames (at 1.5 dB: from 2.0 dB up this surrogate's
     frame errors are undetected), and the FER overlaps the reference.
  20. xor kernels vs plain — the XOR instantiations of csrc/layered_qc.cu
     and csrc/flooding_qc.cu (K4's layered and flooding modes) and of
     csrc/layered_exact.cu against their plain versions on 8023an (Z = 64
     XOR-permutation blocks, row degree 32): each rule, layered and
     flooding, fixed at 3.6 dB and track at 3.4 dB (32 frames, and 13 for
     a ragged last tile); layered and flooding min-sum and spa also at 601
     frames (CS = 1, a ragged last tile of F); layered min-sum also with
     offset:0.15 and the per-iteration schedule dvbs2_64800_12_T25; the
     toy Z = 16 xor code
     (the 8-wide builds), min-sum layered and flooding, fixed and track;
     each XOR_LEGS shape (2048 frames). Bits, ok and iterations identical;
     posteriors after one sweep within EXACT_MAX_ULPS, and min-sum's final
     posteriors identical. The K3 cases of phases 12, 16 and 20 must
     include a plan with CS = 8 on dvbs2/64800 and one with CS = 1, F >= 2
     and a ragged last tile. The classic kernel
     refuses 8023an (no layer repeats a block-column: its xor
     instantiation takes only graphs that do, phase 43), and no roll
     instantiation launches in 20-22.
  21. xor legs timed — bench.XOR_LEGS through run_benchmark (8023an,
     4.0 dB, 2048 frames, layered/norm:0.8125/25/noet and
     minsum/norm:0.8125/25/noet), and layered/spa/25/noet on the same
     shape: ms, Mbit/s, launches by perm, bound, plain ms, FER <= 0.01.
  22. 8023an sweeps vs the JAX reference — run_sweep of
     layered/norm:0.8125/25 at 3.4 and 3.6 dB and of minsum/norm:0.8125/25
     at 3.6 and 3.8 dB, 8192 frames a point, must overlap
     ecc_ldpc_tpu_torch/data/8023an_jax_cpu.json (the overlap with the TPU
     goldens, measured through a bf16 permutation, is printed and gates
     nothing); then the CLI's sweep with
     layered/norm:0.8125/50;retry=layered/spa/50 at 3.6 dB, 65536 frames
     in batches of 4096: both xor kernels launched, the fallback got
     frames, and the FER overlaps the reference's retry point.
  23. K5 vs plain — the all-reduce (csrc/ring.cu: one push into every
     rank's slot, ordered on the device by interprocess events, then the
     sum) on D = 2 and D = 4 ranks (4 processes under
     torch.distributed.run, gloo between them, a group of the first D for
     each D) of the one card, through bench/ring.py (the first job of one
     launch of four ranks, bench/ranks.py, whose later jobs are the
     sharded sweeps of 24 and 34 and the graph-parallel tiers of 49, so
     the ranks start once): f32 and int64 at the
     sweep counters' shape [2, 4], at a ragged 1001 elements and at 16 MiB
     per rank; K5's sum identical to the plain version's on every rank and
     the ranks identical to each other, 2 launches a call; K5, the plain
     version and gloo's all_reduce timed on the same CUDA tensors. The
     card's compute mode is printed. Then across nodes: bench/ring.py
     --check on two nodes of two ranks each (two torch.distributed.run
     agents, run_nodes), on ranks 0 and 2 (one a node: the blocks through
     host memory only) and on all four (CUDA IPC within a node, host
     memory across): the same identities, f32 and int64, 2 launches a
     call, and each rank's Ring plan the nodes and peers asked for.
  24. the sharded sweep at full width — bench/sharded.py on meshes 1x1,
     2x1 and 2x2 (in phase 23's launch of 4 ranks, a group of the first
     B*S for each mesh, one after another): dvbs2/64800/12,
     layered/norm:0.8125/25, 1.0 and 1.1 dB, 4096 frames a point per step,
     2 steps; the integer counters identical on every rank and mesh, K1a
     and K5 launched on every rank of 2x1 and 2x2, each Ring's plan one
     node (CUDA IPC only); frames/s per mesh, and run_sweep's on the same
     points beside them.
  25. the entry point — the CLI's sweep on a 2x2 mesh of ranks on two
     nodes of two ranks each (run_nodes: K5 through CUDA IPC within a
     node and host memory across), 100 frame errors or 32768 frames a
     point: every rank exits 0, every rank's Ring states the plan of its
     node and made calls, and rank 0's results overlap the golden curve.
  26. families vs plain — K1a (fixed and track), K1c (spa, track) and K3
     (minsum, track) against their plain versions on 80211n/1944/12 and
     80211n/648/56 (odd Z = 81, 27: clusters of one), wimax/2304/56,
     nr5g/bg1/384 (768 punctured columns at LLR +0.0), nr5g/bg1/208/3168
     (1408 filler columns at LLR 60), nr5g/bg1/384/8448/12672 (a graph
     truncated to 13 x 35), sc/3/6/10/64 and punct/80211n~1944~12/0:81, at
     32 frames, 13 frames and the sweeps' 4096; then
     nr5g/bg2/52/500/1200/rv0..3, each redundancy version alone (32 and 13
     frames) and the four transmissions of one codeword summed by
     harq_combine. Bits, ok and iterations identical, posteriors after one
     sweep within EXACT_MAX_ULPS (min-sum's final ones identical); each
     case prints its plan.
  27. row degree 34 — dvbs2/16200/910 through the 64-wide builds of K1a
     (fixed, track), K1c (spa, minstar) and K3 (minsum, spa), and its H
     written by matrixio.dumps_matlab_sparse, loaded through mat: and
     decoded by K2 (minsum, spa; the form "global"), each against its plain
     version as in 26; the ptxas report (registers, spill) of every
     64-wide instance; each 64-wide case timed by run_benchmark at 4096
     frames (ms, launches, bound, plain ms at the same shape), and beside
     it the same decoder on dvbs2/16200/89 (row degree 28: the 32-wide
     builds on the same 48,960 edges) with its builds' spill.
  28. family sweeps — the CLI's sweep of layered/norm:0.8125/25 on each
     of the five family goldens (80211n/1944/12, wimax/2304/12,
     wimax/2304/56, nr5g/bg1/384, nr5g/bg2/384) at the golden's points,
     16384 frames a point in batches of 4096, must overlap the golden
     (curves_overlap); K2's sweeps of minsum/norm:0.8125/25 on
     gallager/2052/3/6/s0 and on a dense: file of 80211n/648/12's H must
     overlap the JAX CPU references in ecc_ldpc_tpu_torch/data; spa/50
     (K3) on 80211n/1944/12 and layered/spa/25 (K1c) on wimax/2304/56
     decode most frames. The launches from here to the end of 29 are the
     families' path's.
  29. families timed — bench/families.py over its whole list: one JSON
     line a row with the card's name and power limit, and the table.
  30. wide rows — sc/2/80/6/32 and sc/3/96/10/64 (row degrees 80 and 96)
     through the wide builds of K1a (fixed, track), K1c (spa, minstar),
     K3 (minsum, spa, minstar) and, on their H written by
     matrixio.dumps_matlab_sparse and loaded through mat:, K2 (minsum,
     spa, minstar), each against its plain version as in 26 (32 and 13
     frames); the wide instances' ptxas lines; each wide leg timed on
     sc/3/96/10/64 at 1024 frames (ms, bound, plain ms, plan, spill).
  31. the G cache — HOME pointed at an empty directory: ccsds/16384/45's
     generator built cold (host elimination) and warm (the cache file),
     G's bytes on the card; a batch encoded on the card with every
     syndrome zero, a noiseless batch through K1b with no error, and a
     two-point layered/norm:0.8125/25 sweep through K1b whose FER falls.
  32. channels — every kind (qpsk, qam16/64/256, 8psk, apsk16:r56,
     apsk32:r34, each also with :il; bsc, bec, rayleigh, hard): the
     card's LLRs against the CPU's on the same draws (rtol 1e-5, atol
     1e-4), each channel's ms at dvbs2/16200/12, B = 4096; the uncoded
     anchors through bpsk/N (bpsk, qpsk, hard and rayleigh inside the
     99.9% Wilson interval of their closed forms, 8psk within 0.8-1.25x
     of its approximation).
  33. modem goldens — run_sweep of dvbs2/16200/12 with
     layered/norm:0.8125/25 over apsk16:r56:il, apsk32:r34:il and bpsk at
     each golden's points and frame counts, held to the JAX package's
     golden gate (CI overlap, or within 1.25x at a saturated point;
     curves_overlap printed beside it); 80211n/1944/12 over qam64:il,
     wimax/2304/12 over rayleigh and mackay1008 spa/50 over bec:0.4 (K2)
     against their JAX CPU references by curves_overlap; then the BPSK
     golden's saturated 0.8 dB again with 4 x 16384 frames, seeds 0 and 1,
     each overlapping the JAX package's CPU sweep of 65536 frames there
     (ecc_ldpc_tpu_torch/data/dvbs2_16200_12_bpsk08_jax_cpu.json).
  34. the sharded modem sweep — bench.SHARDED_MODEM_SWEEP (apsk16:r56:il)
     on meshes 1x1 and 2x1 through bench/sharded.py (in phase 23's
     launch, one node) and through the CLI on 2x1 with --channel on two
     nodes of one rank each (K5 through host memory only): identical
     counters, K5 launched on every rank of 2x1, each CLI rank's plan its
     own node.
  35. precision kernels vs plain — K1a (roll on dvbs2/16200/12, xor on
     8023an), K1c (spa, minstar) and K1b/K1c' (min-sum, spa on
     ccsds/1024/12) with bf16 message storage, q:6:0.25 and q:4:1.0, fixed
     and track, at 32 and 13 frames, and K1a's 8-, 16-, 32-, 64-wide and
     wide builds once under q:6:0.25, each against its plain version with
     the same precision: bits, ok and iterations identical, posteriors
     after one sweep within EXACT_MAX_ULPS, min-sum's final posteriors
     identical; each prints its plan (with its precision); then each leg
     of 36 at its own shape (4096 frames).
  36. precision timed — bench.PRECISION_LEGS through run_benchmark
     (/25/noet, 4096 frames): min-sum and spa on dvbs2/64800/12 at 1.5 dB
     with /pallas (bf16) and on q:6:0.25, and min-sum and spa on
     ccsds/4096/12 at 2.5 dB on q:6:0.25 (K1b, K1c'): ms, launches, bound,
     plain ms, FER <= 0.01 (< 0.5 on CCSDS, as its f32 legs); the
     registers and spill of every instance of the three layered sources'
     f32 and precision (_prec) libraries.
  37. precision curves — layered/norm:0.8125/25 with backend pallas
     (bf16) at the golden's points 0.95-1.1 dB must overlap the golden it
     made, phase 8's f32 run printed beside it; on 80211n/1944/12 at its
     golden's steepest point, 16384 frames, q:6:0.25 within 4x float
     (or 1e-3) and q:3:1.0 above 10x q:6:0.25; one point through the
     CLI's --backend pallas.
  38. post-decode forms — bitflip/50 and gdbf/theta:-0.5/50 on
     80211n/1944/12 and bitflip/50 on mackay1008 over the hard channel at
     6.0 and 7.0 dB (every frame fails at 4 and 5), 1024 frames: card
     against CPU on the same LLRs (majority identical; GDBF but for frames
     within 1e-5 of theta), ms, FER falling; layered/norm:0.8125/50 with
     and without /cleanup through the CLI at 1.5 dB, 65536 frames: the
     cleanup's frame errors no more than the decoder's plus the frames it
     made wrong (counted on the same batches regenerated), and the
     cleanup of a 1.05 dB batch's failed rows on the card equal to the
     CPU's; CRC24A over nr5g/bg1/384 (with_crc): 4096 frames on the card,
     every CRC check equal to the bit-serial reference's, ok = syndrome
     AND CRC.
  39. learn — the CLI's `learn` at full width on the card:
     dvbs2/64800/12, T = 25, batch 16, 3 steps over 1.8-2.6 dB (the
     production schedule's code, T and band): seconds a step, peak memory
     above what earlier phases left allocated, the losses finite, the
     parameters in the clip region; on the first training batch
     (regenerated) the twin's final hard decisions equal to the plain
     layered decoder's with count signs; the trained
     schedule through K1a (make_decoder, 25 iterations, no early
     termination) on 256 frames at 2.2 dB, bits, ok and iterations equal
     to its plain version's.
  40. findsnr — the CLI's `findsnr` of layered/norm:0.8125/25 at FER 1e-2
     on dvbs2/64800/12 (bracket 0.9-1.4 dB, 0.02 dB, 2048 frames a step,
     16384 a probe): the answer inside 1.05-1.25 dB (the golden's 1.10 and
     1.20 dB points, with a margin); the probes printed.
  41. trap — harvest() of dvbs2/64800/12 with layered/norm:0.8125/25 at 1.1
     dB (2048 frames, K1a) and of mackay1008 with the default
     minsum/norm:0.8125/25 at 2.0 dB (8192 frames, K2): the summaries; the
     histogram total equal to the failed frames counted again on the
     card; every stored failure's b equal to the weight of H e computed
     on the card; the CLI's `trap --out` report equal to the library's.
  42. bench — the CLI's `bench` (decode only, dvbs2/64800/12
     layered/norm:0.8125/25/noet, 4096 frames, with --profile-dir),
     `--pipeline` and `--ab` (the plain and learned schedules, noet) at
     1024 frames, bench.scaling over the host's cards, and `sweep
     --profile-dir`: the JSON lines, and both traces naming K1a's kernel.
     The launches of 39-42 are counted per phase (zeroed before, read
     after).
  43. multi-edge xor graphs — K1b/K1c' (csrc/layered_classic.cu) in its
     xor instantiation on seeded xor graphs that repeat a block-column in
     every layer (bench/multi_edge.py: Z = 64 and 256), each rule, fixed
     and track, 32, 13 and 601 frames: bits, ok, iterations and the final
     posteriors identical to the plain version (0 ulps); then the min-sum
     decoder through get_decoder at 4096 frames, timed, its launches
     counted there.
  44. wide classic rows — the same on circulant multi-edge graphs of row
     degree 40 (the 64-wide build) and 80 (the wide build), with the
     ptxas registers and spill of every classic instance.
  45. /pallas kernels vs plain — the precision libraries' new instances
     at 32 and 13 frames, fixed and track, 0 ulps: K3's bf16 storage
     (nr5g/bg1/384 and wimax/576/12, each rule), K2's bf16 matmul inputs
     (mackay1008, 80211n/648/12), K4's bf16 permutations (8023an, layered
     and flooding).
  46. /pallas legs — bench.PALLAS_LEGS (B = 4096, /25/noet) beside their
     f32 legs in the same call, each after its kernel against its plain
     version at the leg's shape.
  47. /pallas goldens — `sweep --backend pallas` of 8023an through the CLI
     at both TPU goldens' points (flooding from 3.2 dB, layered from 3.0
     dB), each point by the reference gate's rule.
  48. /xla-mm — mackay1008 on the expanded graph, minsum and spa, equal
     to K2 in f32.
  49. graph-parallel — bench/graph_parallel.py on 2 and 4 ranks of the
     card (in phase 23's launch): the QC tier on dvbs2/64800/12 (32 frames, 1.2 dB) bits, ok and
     iterations identical to K3 on one rank; the check-sharded tier on
     mackay1008 (256 frames, 2.5 dB) agreeing on ok frames; ms a decode
     and K5 calls a decode.
  50. experiment kernels vs plain — every variant of the experiments'
     kernels (ecc_ldpc_tpu_torch/experiments) against its plain version
     on the card, at the plans phase 51 runs: E5-E7 (csrc/micro_ops.cu:
     every dtype, every op) at [368, 128] and [368, 16896], outputs 0
     ulps apart; E1's seven variants (runtime tables), E2's seven and E3
     (static libraries) on dvbs2/64800/12 (272 frames, one a tile, on 132
     blocks: each block takes tiles in turn; 3 sweeps), bits identical
     and posteriors 0 ulps apart, E3 equal to E1 full; E4's three
     variants on mackay1008 (2045 frames: 8 a tile, 256 tiles on 132
     blocks, the last of 5; and 13 frames, one a block; 5 iterations),
     bits, ok and iterations identical and posteriors 0 ulps apart.
  51. the experiments at full width — each of the six scripts' main()
     at its own configuration (E1 at B = 128 and 4096, E2 at 4096, E3 at
     both, beside K1a's bf16 library; E4 at B = 2048 beside K2; E5-E7 at
     [368, 128] and [368, 16896]), one JSON line a variant; E3's bits
     equal E1 full's at both batches; and E6's library call (one
     torch.roll by the chain's shift).
Then the kernels line (the launches of phases 28-29, 31-42 and 47-49
added to the kernels that decode them, the families' errors to theirs,
an entry with "width": 64 for each 64-wide instance timed in 27, one with
"width": "wide" for each wide instance timed in 30, one with its
"precision" for each (kernel, precision) timed in 36 and 46, one for
each new classic instance timed in 43-44, and one for each experiment
kernel, E1-E7, with its launches in 51 and its comparisons in 50),
nvidia-smi's line, and the result line last.

The script leaves no process behind, whether it ends, fails or is sent
SIGTERM: it reaps every process it starts, however deep (the ranks that
torch.distributed.run starts in sessions of their own come back to it
when their launcher ends first), and stops any still alive at its end;
each launcher of ranks gets SIGTERM if the script dies, so that it
stops its ranks.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import io
import json
import math
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ecc_ldpc_tpu_torch import _build
from ecc_ldpc_tpu_torch.bench import families
from ecc_ldpc_tpu_torch.bench.flooding_probe import (
    regular_graph,
    time_decode,
    zero_codeword_llr,
)
from ecc_ldpc_tpu_torch.bench.multi_edge import multi_edge_graph
from ecc_ldpc_tpu_torch.bench.ring import CASES as RING_CASES
from ecc_ldpc_tpu_torch.bench.throughput import (
    CCSDS_LEGS,
    CCSDS_PRODUCTION_SWEEP,
    EXACT_LEGS,
    PALLAS_LEGS,
    PRECISION_LEGS,
    SHARDED_MESHES,
    SHARDED_SWEEP,
    FLOODING_LEGS,
    FLOODING_PRODUCTION_SWEEP,
    LEGS,
    PRODUCTION_SWEEP,
    XOR_LEGS,
    XOR_PRODUCTION_SWEEP,
    decode_bound,
    event_seconds,
    make_inputs,
    rule_of,
    run_benchmark,
)
from ecc_ldpc_tpu_torch.chan.awgn import awgn_llr, make_channel
from ecc_ldpc_tpu_torch.cli.main import main as cli_main
from ecc_ldpc_tpu_torch.codes.matrixio import dumps_dense, dumps_matlab_sparse
from ecc_ldpc_tpu_torch.codes.nr5g import harq_combine
from ecc_ldpc_tpu_torch.codes.qc import QCXorCode, expand_qc_xor
from ecc_ldpc_tpu_torch.codes.registry import get_code
from ecc_ldpc_tpu_torch.decode.api import (
    choose_graph,
    get_decoder,
    parse_decoder_spec,
)
from ecc_ldpc_tpu_torch.decode.flooding import (
    flooding_decode_cuda,
    flooding_with_posteriors_cuda,
    flooding_with_posteriors_plain,
    tpu_flooding_precision,
)
from ecc_ldpc_tpu_torch.decode.flooding_qc import (
    flooding_qc_decode_cuda,
    flooding_qc_with_posteriors_cuda,
    flooding_qc_with_posteriors_plain,
)
from ecc_ldpc_tpu_torch.decode.flooding_qc import (
    tpu_flooding_precision as tpu_flooding_qc_precision,
)
from ecc_ldpc_tpu_torch.decode.layered_qc import (
    classic_with_posteriors_cuda,
    exact_with_posteriors_cuda,
    layered_classic_cuda,
    layered_decode_cuda,
    layered_exact_cuda,
    minsum_with_posteriors_cuda,
    plain_with_posteriors,
    tpu_msg_dtype,
    tpu_precision,
)
from ecc_ldpc_tpu_torch.decode.quant import describe
from ecc_ldpc_tpu_torch.dist.ring import node_plan
from ecc_ldpc_tpu_torch.encode.structured import build_encoder
from ecc_ldpc_tpu_torch.experiments import ablate, micro, smallcode_opt2
from ecc_ldpc_tpu_torch.experiments import common as exp_common
from ecc_ldpc_tpu_torch.experiments.variants import (
    E2_VARIANTS,
    E3_FLAGS,
    ROLL,
)
from ecc_ldpc_tpu_torch.graph.qc import compile_qc_graph
from ecc_ldpc_tpu_torch.sim import (
    PointResult,
    StoppingRule,
    SweepSpec,
    curves_overlap,
    run_sweep,
)
from ecc_ldpc_tpu_torch.sim.runner import Pipeline, step_seed

ROOT = pathlib.Path(__file__).resolve().parent
# FER limits: the headline and production legs decode at operating points
# where the code is far below 1e-2; the repo stores no r=3/4 FER at 3.0 dB,
# so that leg is held only to "decodes most frames".
FER_MAX = {"headline": 0.01, "r34": 0.5, "prod": 0.01}
# kernel vs plain on the card: (name, code, decoder spec, Eb/N0 dB), B=32
PARITY_CASES = [
    ("r12_fixed_1.0dB", "dvbs2/64800/12", "layered/norm:0.8125/25/noet", 1.0),
    ("r12_fixed_1.5dB", "dvbs2/64800/12", "layered/norm:0.8125/25/noet", 1.5),
    ("r12_track_op2_1.2dB", "dvbs2/64800/12",
     "layered/sched:dvbs2_64800_12_T25_op2", 1.2),
    ("r12_track_norm_1.05dB", "dvbs2/64800/12", "layered/norm:0.8125/25", 1.05),
    ("r12_fixed_offset_1.2dB", "dvbs2/64800/12",
     "layered/norm:0.8125/offset:0.15/25/noet", 1.2),
    ("r34_fixed_3.0dB", "dvbs2/64800/34", "layered/norm:0.8125/25/noet", 3.0),
    ("r910_fixed_4.0dB", "dvbs2/64800/910", "layered/norm:0.8125/25/noet", 4.0),
    ("r910_fixed_offset_4.0dB", "dvbs2/64800/910",
     "layered/norm:0.8125/offset:0.15/25/noet", 4.0),
    ("r910_track_3.8dB", "dvbs2/64800/910", "layered/norm:0.8125/25", 3.8),
]
# K1a's tile plans (decode/layered_qc.tile_plan) at their own batch sizes:
# (name, code, decoder spec, Eb/N0 dB, B). 13 frames is the fallback's
# plan (one frame to a cluster of 8 blocks); 8023an at 601 frames takes
# CS = 1 and ends in a ragged tile
PLAN_CASES = [
    ("r12_track_1.05dB_13frames", "dvbs2/64800/12", "layered/norm:0.8125/25",
     1.05, 13),
    ("8023an_track_3.4dB_601frames", "8023an", "layered/norm:0.8125/25",
     3.4, 601),
]
# waterfall bands around the golden curve (0.79 at 0.95 dB, 0.0011 at 1.2)
WATERFALL = [(0.95, ">=", 0.5), (1.2, "<=", 0.02)]
WATERFALL_DECODER = "layered/norm:0.8125/25"
WATERFALL_FRAMES = 2048
TRAP_FILE = ROOT / "tests" / "data" / "trap_batch_dvbs2_64800_12.npz"
GOLDEN = ROOT / "curves" / "dvbs2_64800_12_tpu_golden.json"
# exact kernel vs plain on the card: (name, code, spec with {cn}, Eb/N0, B)
EXACT_CASES = [
    ("r12_fixed_1.0dB", "dvbs2/64800/12", "layered/{cn}/25/noet", 1.0, 32),
    ("r12_track_1.2dB", "dvbs2/64800/12", "layered/{cn}/25", 1.2, 32),
    # a ragged last tile, as the retry fallback's batches have
    ("r12_track_1.2dB_13frames", "dvbs2/64800/12", "layered/{cn}/25", 1.2, 13),
    ("r34_fixed_3.0dB", "dvbs2/64800/34", "layered/{cn}/25/noet", 3.0, 32),
    ("r910_fixed_4.0dB", "dvbs2/64800/910", "layered/{cn}/25/noet", 4.0, 32),
    ("r910_track_3.8dB", "dvbs2/64800/910", "layered/{cn}/25", 3.8, 32),
    ("8023an_track_3.4dB_601frames", "8023an", "layered/{cn}/25", 3.4,
     601),
]
# Posteriors after one fixed sweep may differ from the plain version's by
# at most this many f32 ulps; bits, ok and iterations must be identical.
EXACT_MAX_ULPS = 0
EXACT_FER_MAX = 0.01
SWEEP_DECODER = "layered/norm:0.8125/25"
SWEEP_EBN0 = (1.0, 1.05, 1.1)
# the production point: the reference saw 0 frame errors in 1.0M frames
# with retry and FER 3.9e-5 without at 1.5 dB (README.md); 65536 frames
PRODUCTION_FRAMES = 65536
PRODUCTION_FER_MAX = 1.5e-4
KINDS = ("minsum", "spa", "minstar")
RULE = {"minsum": "minsum/norm:0.8125", "spa": "spa", "minstar": "minstar"}
# K2 vs plain on mackay1008: (name, spec, Eb/N0 dB, B). 601 frames take
# tiles of F = 2 (track) and 6 (fixed), the last one ragged; 2048 track
# frames tiles of 2, whose frames stop at different iterations
FLOODING_CASES = [
    ("minsum_fixed_2.5dB", "minsum/norm:0.8125/25/noet", 2.5, 32),
    ("minsum_track_2.0dB", "minsum/norm:0.8125/25", 2.0, 32),
    ("minsum_track_2.0dB_13frames", "minsum/norm:0.8125/25", 2.0, 13),
    *[(f"{k}_{m}_1.5dB", f"{k}/25" + ("/noet" if m == "fixed" else ""),
       1.5, 32) for k in ("spa", "minstar") for m in ("fixed", "track")],
    ("spa_track_1.5dB_13frames", "spa/50", 1.5, 13),
    *[(f"{k}_track_1.5dB_601frames", f"{r}/25", 1.5, 601)
      for k, r in (("minsum", "minsum/norm:0.8125"), ("spa", "spa"),
                   ("minstar", "minstar"))],
    ("minsum_fixed_2.0dB_601frames", "minsum/norm:0.8125/25/noet", 2.0, 601),
    ("minsum_track_2.0dB_2048frames", "minsum/norm:0.8125/25", 2.0, 2048),
]
# K2's form "global": (name, decoder arguments) on the seeded (3,6)-regular
# n = 16384 graph, whose frame (262 KB of state) does not fit a block
FLOODING_GLOBAL_N = 16384
FLOODING_GLOBAL_CASES = [
    ("regular16384_minsum_track_2.0dB",
     dict(kind="minsum", alpha=0.8125, max_iters=25, early_term=True)),
    ("regular16384_spa_fixed_2.0dB",
     dict(kind="spa", max_iters=10, early_term=False)),
]
FLOODING_GLOBAL_B = 32
# K3 vs plain: (name, code, spec with {r} for the rule, Eb/N0, B)
FLOODING_QC_CASES = [
    ("r12_fixed_1.5dB", "dvbs2/64800/12", "{r}/25/noet", 1.5, 32),
    ("r12_track_1.2dB", "dvbs2/64800/12", "{r}/25", 1.2, 32),
    ("r12_track_1.2dB_13frames", "dvbs2/64800/12", "{r}/25", 1.2, 13),
    ("r34_fixed_3.0dB", "dvbs2/64800/34", "{r}/25/noet", 3.0, 32),
    ("r910_fixed_4.0dB", "dvbs2/64800/910", "{r}/25/noet", 4.0, 32),
]
MACKAY_FER_MAX = 0.01
GOLDEN_MACKAY = {"spa/50": ROOT / "curves" / "mackay1008_tpu_golden.json",
                 "minsum/norm:0.8125/25":
                     ROOT / "curves" / "mackay1008_cpu_golden.json"}
MACKAY_SWEEP_EBN0 = (1.5, 2.0)
# K1b/K1c' vs plain: code -> Eb/N0 where 25 iterations fail some of 32
# frames (on the card, seed 1, min-sum decodes 27, 14 and 18 of them)
CLASSIC_CODES = {"ccsds/4096/12": 1.5, "ccsds/4096/23": 2.0,
                 "ccsds/4096/45": 2.8}
CLASSIC_CASES = [  # (name, spec with {r} for the rule, B)
    ("fixed", "layered/{r}/25/noet", 32),
    ("track", "layered/{r}/25", 32),
    ("track_13frames", "layered/{r}/25", 13),
]
CLASSIC_MINSUM_CASES = [
    ("fixed_offset", "layered/norm:0.8125/offset:0.15/25/noet", 32),
    ("track_sched", "layered/sched:dvbs2_64800_12_T25", 32),
]
# the classic kernel's other plans, each rule in track mode: (name, code,
# Eb/N0, B, whether the code has an encoder); several frames a tile with a
# ragged last one, and a frame over a cluster of 8 (the all-zero
# codeword's LLRs: the port cannot encode k = 16384 yet)
CLASSIC_PLAN_CASES = [
    ("track_601frames", "ccsds/1024/12", 1.5, 601, True),
    ("track_16frames", "ccsds/16384/12", 1.2, 16, False),
]
# K3 on multi-edge graphs: (name, code, spec, B); the 601-frame plan keeps
# its LLRs in [B, n]
CLASSIC_FLOODING_CASES = [
    ("spa_fixed", "ccsds/4096/12", "spa/25/noet", 32),
    ("spa_track", "ccsds/4096/12", "spa/25", 32),
    ("spa_track_601frames", "ccsds/4096/45", "spa/25", 601),
]
CCSDS_REFERENCE = (ROOT / "ecc_ldpc_tpu_torch" / "data"
                   / "ccsds_4096_12_jax_cpu.json")
CCSDS_SWEEP_DECODER = "layered/norm:0.8125/50"
CCSDS_SWEEP_EBN0 = (2.0, 2.5)
CCSDS_SWEEP_FRAMES = 8192
CCSDS_FER_MAX = 0.5
# the xor kernels vs plain on 8023an: (name, spec with {r} for the rule,
# Eb/N0, B); at 3.4-3.6 dB 25 iterations fail some of 32 frames
XOR_CASES = [
    ("fixed_3.6dB", "{r}/25/noet", 3.6, 32),
    ("track_3.4dB", "{r}/25", 3.4, 32),
    ("track_3.4dB_13frames", "{r}/25", 3.4, 13),
]
# the xor tile kernels (K1a, K1c, K3) at CS = 1 with a ragged last tile
XOR_PLAN_CASES = [("track_3.4dB_601frames", "{r}/25", 3.4, 601)]
XOR_MINSUM_CASES = [
    ("fixed_offset_3.6dB", "layered/norm:0.8125/offset:0.15/25/noet", 3.6),
    ("track_sched_3.4dB", "layered/sched:dvbs2_64800_12_T25", 3.4),
]
XOR_RULES = {"layered": {"minsum": "layered/norm:0.8125", "spa": "layered/spa",
                         "minstar": "layered/minstar"},
             "flooding": RULE}
XOR_TOY_EBN0 = 2.0  # the toy code fails some of 32 frames here
XOR_REFERENCE = ROOT / "ecc_ldpc_tpu_torch" / "data" / "8023an_jax_cpu.json"
# sweep decoder -> (Eb/N0 points, the TPU golden printed beside them)
XOR_SWEEPS = {
    "layered/norm:0.8125/25": ((3.4, 3.6), ROOT / "curves"
                               / "8023an_layered_tpu_golden.json"),
    "minsum/norm:0.8125/25": ((3.6, 3.8), ROOT / "curves"
                              / "8023an_tpu_golden.json"),
}
XOR_SWEEP_FRAMES = 8192
XOR_FER_MAX = 0.01
RING_RANKS = (2, 4)
# 49. graph-parallel decoding (bench/graph_parallel.py) on D ranks of the
# card
GRAPH_PARALLEL_RANKS = (2, 4)
# 34. the sharded modem sweep's meshes on one node
MODEM_MESHES = ("1x1", "2x1")
# the one-node rank programs of phases 23, 24, 34 and 49, one launch of
# four ranks (rank_jobs, bench/ranks.py): name -> (the job's module and
# arguments, "{out}" the lines' directory; its share of the launch's time
# limit in seconds)
RANK_JOBS_WORLD = 4
RANK_JOBS = {
    "ring": (("bench.ring", "{out}", "--ranks",
              ",".join(map(str, RING_RANKS))), 300),
    "sharded": (("bench.sharded", ",".join(SHARDED_MESHES), "{out}"), 900),
    "modem": (("bench.sharded", ",".join(MODEM_MESHES), "{out}", "modem"),
              600),
    "graph_parallel": (("bench.graph_parallel", "{out}", "--ranks",
                        ",".join(map(str, GRAPH_PARALLEL_RANKS))), 600),
}
# the integer counters a sharded sweep must reproduce on every mesh
SHARDED_COUNTERS = ("frames", "bit_errors", "frame_errors", "iters_sum",
                    "bit_errors_sq")
CLI_MESH = "2x2"
CLI_NODES = (2, 2)  # nodes, ranks a node: the mixed route of K5
CLI_MESH_FRAMES = 32768
# K5 across two nodes of two ranks (bench/ring.py --ranks): one rank a
# node (host memory only), then all four (CUDA IPC within a node)
RING_NODE_GROUPS = ("0+2", "4")
# 26. the other code families, kernel vs plain: code -> Eb/N0 where 25
# iterations fail some of 32 frames. 802.11n's Z = 81 and 27 are odd (a
# cluster of one only), the nr5g codes carry 768/416 punctured columns at
# LLR +0.0, 1408 filler columns at LLR 60, and a truncated graph
FAMILY_CODES = {
    "80211n/1944/12": 1.25, "80211n/648/56": 3.5, "wimax/2304/56": 3.25,
    "nr5g/bg1/384": 0.9, "nr5g/bg1/208/3168": 1.0,
    "nr5g/bg1/384/8448/12672": 2.0, "sc/3/6/10/64": 2.0,
    "punct/80211n~1944~12/0:81": 1.5,
}
FAMILY_FULL_B = 4096  # the family sweeps' batch
FAMILY_CASES = [  # (name, decoder spec, B) on every family code
    ("k1a_fixed", "layered/norm:0.8125/25/noet", 32),
    ("k1a_track", "layered/norm:0.8125/25", 32),
    ("k1a_track_13frames", "layered/norm:0.8125/25", 13),
    ("k1a_track_full", "layered/norm:0.8125/25", FAMILY_FULL_B),
    ("k1c_spa_track", "layered/spa/25", 32),
    ("k1c_spa_track_13frames", "layered/spa/25", 13),
    ("k1c_spa_track_full", "layered/spa/25", FAMILY_FULL_B),
    ("k3_minsum_track", "minsum/norm:0.8125/25", 32),
    ("k3_minsum_track_13frames", "minsum/norm:0.8125/25", 13),
    ("k3_minsum_track_full", "minsum/norm:0.8125/25", FAMILY_FULL_B),
]
# the NR circular buffer: each redundancy version alone, then the four
# transmissions of one codeword summed by harq_combine
HARQ_CODE = "nr5g/bg2/52/500/1200/rv{rv}"
HARQ_EBN0 = 1.0
HARQ_DECODER = "layered/norm:0.8125/25"
# 27. row degree 34 on the 64-wide builds: (name, decoder spec, B)
WIDE_CODE = "dvbs2/16200/910"
WIDE_EBN0 = 4.3
WIDE_CASES = [
    ("k1a_fixed", "layered/norm:0.8125/25/noet", 32),
    ("k1a_track", "layered/norm:0.8125/25", 32),
    ("k1a_track_13frames", "layered/norm:0.8125/25", 13),
    ("k1c_spa_track", "layered/spa/25", 32),
    ("k1c_minstar_track", "layered/minstar/25", 32),
    ("k1c_spa_track_13frames", "layered/spa/25", 13),
    ("k3_minsum_track", "minsum/norm:0.8125/25", 32),
    ("k3_spa_track", "spa/25", 32),
    ("k3_minsum_track_13frames", "minsum/norm:0.8125/25", 13),
]
# K2 on the same H loaded through matrixio (mat:): (name, spec, B)
WIDE_K2_CASES = [
    ("k2_minsum_fixed", "minsum/norm:0.8125/25/noet", 32),
    ("k2_minsum_track", "minsum/norm:0.8125/25", 32),
    ("k2_spa_track", "spa/25", 32),
    ("k2_spa_track_13frames", "spa/25", 13),
]
# the 64-wide instances timed: (kernels-line name, wrapper key, decoder)
WIDE_LEGS = [
    ("layered_qc", "k1a", "layered/norm:0.8125/25/noet"),
    ("layered_exact:spa", "k1c", "layered/spa/25/noet"),
    ("layered_exact:minstar", "k1c", "layered/minstar/25/noet"),
    ("flooding_qc:minsum", "k3", "minsum/norm:0.8125/25/noet"),
    ("flooding_qc:spa", "k3", "spa/25/noet"),
    ("flooding:minsum", "k2", "minsum/norm:0.8125/25/noet"),
    ("flooding:spa", "k2", "spa/25/noet"),
]
WIDE_B = 4096
# the same legs on the 32-wide builds, beside them: dvbs2/16200/89 has row
# degree 28, the same 48,960 edges and Z = 360 (its H through mat: for K2)
NARROW_CODE = "dvbs2/16200/89"
NARROW_EBN0 = 3.6
# 28. family sweeps: golden file -> its code (layered/norm:0.8125/25, bpsk,
# the golden's own points), FAMILY_SWEEP_FRAMES frames a point
FAMILY_GOLDENS = {
    "80211n/1944/12": ROOT / "curves" / "80211n_1944_12_tpu_golden.json",
    "wimax/2304/12": ROOT / "curves" / "wimax_2304_12_tpu_golden.json",
    "wimax/2304/56": ROOT / "curves" / "wimax_2304_56_tpu_golden.json",
    "nr5g/bg1/384": ROOT / "curves" / "nr5g_bg1_384_tpu_golden.json",
    "nr5g/bg2/384": ROOT / "curves" / "nr5g_bg2_384_tpu_golden.json",
}
FAMILY_SWEEP_DECODER = "layered/norm:0.8125/25"
FAMILY_SWEEP_FRAMES = 16384
FAMILY_SWEEP_BATCH = 4096
# K2 sweeps against JAX CPU references (ecc_ldpc_tpu_torch/data): the code,
# or (for dense:) the registered code whose H the script writes as dense
# 0/1 text, the reference file, and the points
K2_FAMILY_DECODER = "minsum/norm:0.8125/25"
K2_FAMILY_SWEEPS = [
    ("gallager/2052/3/6/s0", None,
     ROOT / "ecc_ldpc_tpu_torch" / "data" / "gallager_2052_3_6_s0_jax_cpu.json"),
    ("dense:", "80211n/648/12",
     ROOT / "ecc_ldpc_tpu_torch" / "data" / "dense_80211n_648_12_jax_cpu.json"),
]
# the exact rules on the families' path: (decoder, code, Eb/N0), 16384
# frames, held to "decodes most frames" (no stored curve of these rules)
FAMILY_EXACT_SWEEPS = [
    ("spa/50", "80211n/1944/12", 1.25),
    ("layered/spa/25", "wimax/2304/56", 3.25),
]

# 30. rows wider than 64 (the wide builds): code -> Eb/N0 where some of 32
# frames fail; the cases (name, decoder spec, B) on each, through K1a,
# K1c, K3 and, on the code's H loaded through mat:, K2
WIDE_ROW_CODES = {"sc/2/80/6/32": 6.0, "sc/3/96/10/64": 5.0}
WIDE_ROW_CASES = [
    ("k1a_fixed", "layered/norm:0.8125/25/noet", 32),
    ("k1a_track", "layered/norm:0.8125/25", 32),
    ("k1a_track_13frames", "layered/norm:0.8125/25", 13),
    ("k1c_spa_track", "layered/spa/25", 32),
    # minstar at 8 iterations: its plain version walks 96 slots a layer
    # in Python, 7-15 s a case at 25
    ("k1c_minstar_track", "layered/minstar/8", 32),
    ("k1c_minstar_fixed_13frames", "layered/minstar/8/noet", 13),
    ("k3_minsum_track", "minsum/norm:0.8125/25", 32),
    ("k3_spa_track", "spa/25", 32),
    ("k3_minstar_track", "minstar/8", 32),
]
WIDE_ROW_K2_CASES = [
    ("k2_minsum_fixed", "minsum/norm:0.8125/25/noet", 32),
    ("k2_minsum_track", "minsum/norm:0.8125/25", 32),
    ("k2_spa_track", "spa/25", 32),
    ("k2_minstar_track", "minstar/8", 32),
]
# the wide legs timed on the widest code, at WIDE_ROW_B frames (the names
# of WIDE_LEGS; at 4096 frames the plain minstar leg alone takes ~20 s)
WIDE_ROW_TIMED = "sc/3/96/10/64"
WIDE_ROW_B = 1024

# 31. the host-side G cache: CCSDS k = 16384 at rate 4/5 (n * m = 1.38e8),
# encoded on the card and decoded through K1b, and a two-point sweep
GCACHE_CODE = "ccsds/16384/45"
GCACHE_B = 256
GCACHE_DECODER = "layered/norm:0.8125/25"
GCACHE_EBN0 = (2.5, 3.0)
GCACHE_FRAMES = 2048
# 32. the channels on the card: every kind, bare and (symbols) with :il
CHANNEL_CODE = "dvbs2/16200/12"
CHANNEL_SPECS = ["qpsk", "qam16", "qam64", "qam256", "8psk", "apsk16:r56",
                 "apsk32:r34"]
CHANNEL_SPECS += [f"{c}:il" for c in CHANNEL_SPECS] + [
    "bsc:0.05", "bec:0.3", "rayleigh", "hard"]
CHANNEL_EBN0 = 3.0
CHANNEL_B = 64         # the card against the CPU on the same draws
CHANNEL_TIMED_B = 4096  # each channel's ms at the APSK goldens' shape
# the tolerance of tests/test_torch_modem.py (f32 log-sum-exp; the card's
# logaddexp, exp and log1p against the CPU's)
CHANNEL_RTOL, CHANNEL_ATOL = 1e-5, 1e-4
# uncoded anchors through bpsk/N: (channel, Eb/N0, closed form, exact);
# an exact one must lie in the 99.9% Wilson interval of the bit errors,
# an approximation within 0.8-1.25x
ANCHOR_N = 4800  # every symbol size divides it
ANCHOR_FRAMES = 4096
ANCHORS = [("bpsk", 4.0, "bpsk", True), ("qpsk", 4.0, "bpsk", True),
           ("hard", 4.0, "bpsk", True), ("rayleigh", 10.0, "rayleigh", True),
           ("8psk", 8.0, "8psk", False)]
ANCHOR_Z = 3.29
# 33. the goldens on dvbs2/16200/12 and the JAX CPU references: (code,
# decoder, channel, file)
MODEM_GOLDENS = [
    ("dvbs2/16200/12", "layered/norm:0.8125/25", "apsk16:r56:il",
     ROOT / "curves" / "dvbs2_16200_12_apsk16_tpu_golden.json"),
    ("dvbs2/16200/12", "layered/norm:0.8125/25", "apsk32:r34:il",
     ROOT / "curves" / "dvbs2_16200_12_apsk32_tpu_golden.json"),
    ("dvbs2/16200/12", "layered/norm:0.8125/25", "bpsk",
     ROOT / "curves" / "dvbs2_16200_12_tpu_golden.json"),
]
MODEM_REFERENCES = [
    ("80211n/1944/12", "layered/norm:0.8125/25", "qam64:il",
     ROOT / "ecc_ldpc_tpu_torch" / "data" / "80211n_1944_12_qam64il_jax_cpu.json"),
    ("wimax/2304/12", "layered/norm:0.8125/25", "rayleigh",
     ROOT / "ecc_ldpc_tpu_torch" / "data" / "wimax_2304_12_rayleigh_jax_cpu.json"),
    ("mackay1008", "spa/50", "bec:0.4",
     ROOT / "ecc_ldpc_tpu_torch" / "data" / "mackay1008_spa50_bec04_jax_cpu.json"),
]
MODEM_SWEEP_BATCH = 1024  # the goldens' own batch: their frame counts exactly
# the BPSK golden's saturated point again, at 4x its frames and two seeds,
# held to the JAX package's own CPU sweep there (65536 frames), against
# which the golden's 16384 frames read low: (Eb/N0, frames, seeds,
# reference)
SATURATED = (0.8, 4 * 16384, (0, 1), ROOT / "ecc_ldpc_tpu_torch" / "data"
             / "dvbs2_16200_12_bpsk08_jax_cpu.json")

# 35. the message precisions through the layered kernels against their
# plain versions: name -> the plain version's precision (decode/quant.py)
PRECISIONS = {"bf16": ("bf16",), "q:6:0.25": ("q", 6, 0.25),
              "q:4:1.0": ("q", 4, 1.0)}
PRECISION_T = 10  # iterations a case (the plain versions walk each layer)
# (kernels-line name, code, the spec's rule part, Eb/N0): K1a roll and xor,
# K1c spa and minstar, K1b and K1c' spa; each precision, fixed and track,
# at PRECISION_FRAMES frames
PRECISION_CASES = [
    ("layered_qc", "dvbs2/16200/12", "layered/norm:0.8125", 1.5),
    ("layered_qc:xor", "8023an", "layered/norm:0.8125", 3.4),
    ("layered_exact:spa", "dvbs2/16200/12", "layered/spa", 1.5),
    ("layered_exact:minstar", "dvbs2/16200/12", "layered/minstar", 1.5),
    ("layered_classic:minsum", "ccsds/1024/12", "layered/norm:0.8125", 1.5),
    ("layered_classic:spa", "ccsds/1024/12", "layered/spa", 1.5),
]
PRECISION_FRAMES = (32, 13)
# K1a's row widths once each under q:6:0.25, track mode: width -> (code,
# Eb/N0); row degrees 8, 15, 28, 34 and 80
PRECISION_WIDTHS = {"8": ("dvbs2/16200/12", 1.5),
                    "16": ("dvbs2/16200/34", 3.2),
                    "32": ("dvbs2/16200/89", 3.6),
                    "64": ("dvbs2/16200/910", 4.3),
                    "wide": ("sc/2/80/6/32", 6.0)}
# 37. bf16 against the golden it made (the golden's decoder and points
# 0.95-1.1 dB, as phase 8 runs f32); the q: ordering on 80211n/1944/12 at
# its golden's steepest point; one point through the CLI
PRECISION_GOLDEN_EBN0 = (0.95, 1.0, 1.05, 1.1)
QUANT_ORDER_CODE = "80211n/1944/12"
QUANT_ORDER_GOLDEN = ROOT / "curves" / "80211n_1944_12_tpu_golden.json"
QUANT_ORDER_FRAMES = 16384
QUANT_ORDER_DECODERS = ("layered/norm:0.8125/25",
                        "layered/norm:0.8125/q:6:0.25/25",
                        "layered/norm:0.8125/q:3:1.0/25")
PRECISION_CLI_EBN0 = 1.05
PRECISION_CLI_FRAMES = 8192
# 38. bit flipping over the hard channel, card against CPU on the same
# LLRs: (code, decoder); at 4.0 and 5.0 dB every frame of these codes
# fails (FER 1.0 on the CPU at 256 frames), so the points are 6.0 and 7.0
BITFLIP_CASES = [("80211n/1944/12", "bitflip/50"),
                 ("80211n/1944/12", "gdbf/theta:-0.5/50"),
                 ("mackay1008", "bitflip/50")]
BITFLIP_EBN0 = (6.0, 7.0)
BITFLIP_B = 1024
GDBF_NEAR_THETA = 1e-5
# the cleanup at the production point, through the CLI, against the same
# decoder without it on the same draws; card against CPU on the failed
# rows of a batch at CLEANUP_HARD_EBN0, where many rows fail
CLEANUP_CODE = "dvbs2/64800/12"
CLEANUP_DECODER = "layered/norm:0.8125/50"
CLEANUP_EBN0 = 1.5
CLEANUP_FRAMES = 65536
CLEANUP_BATCH = 4096
CLEANUP_HARD_EBN0 = 1.05
# CRC24A over NR base graph 1 at Z = 384, at a point where some frames fail
CRC_CODE = "nr5g/bg1/384"
CRC_NAME = "24a"
CRC_DECODER = "layered/norm:0.8125/25"
CRC_B = 4096
CRC_EBN0 = 1.0


# phases 39-42: the four entry points of slice 13
# 39. NOMS training at full width (the production schedule's code, T and
# band; its JSON: 55 steps of batch 16), a few steps
LEARN_CODE = "dvbs2/64800/12"
LEARN_ARGS = ["--ebn0", "1.8:2.6", "--iters", "25", "--steps", "3",
              "--batch", "16", "--seed", "0"]
LEARN_BAND = (1.8, 2.6)
LEARN_DECODE_FRAMES = 256  # the trained schedule through K1a and plain
LEARN_DECODE_EBN0 = 2.2
# 40. the operating point of the golden's decoder at FER 1e-2: between the
# golden's last point above it (1.10 dB) and its first below (1.20 dB),
# with 0.05 dB of margin (f32 messages against the golden's bf16)
FINDSNR_ARGS = ["--code", "dvbs2/64800/12", "--decoder",
                "layered/norm:0.8125/25", "--target-fer", "1e-2",
                "--bracket", "0.9:1.4", "--tol-db", "0.02", "--batch",
                "2048", "--max-frames", "16384", "-v"]
FINDSNR_BAND = (1.05, 1.25)
# 41. trapping sets: (code, decoder, Eb/N0, frames, batch)
TRAP_CASES = [("dvbs2/64800/12", "layered/norm:0.8125/25", 1.1, 2048, 2048),
              ("mackay1008", "minsum/norm:0.8125/25", 2.0, 8192, 2048)]
TRAP_SEED = 7
# 42. the bench modes and the profiler traces
BENCH_CODE = "dvbs2/64800/12"
BENCH_DECODER = "layered/norm:0.8125/25/noet"
BENCH_AB_DECODERS = ("layered/norm:0.8125/25/noet",
                     "layered/sched:dvbs2_64800_12_T25/noet")
K1A_KERNEL = "layered_qc_kernel"  # K1a's symbol in a profiler trace

T_START = time.perf_counter()


def adopt_orphans() -> None:
    """Make this process the reaper of every process it starts, however
    deep (Linux PR_SET_CHILD_SUBREAPER): a process whose parent ends
    before it (a rank that torch.distributed.run started in a session of
    its own) comes back to this one instead of to init, so that
    stop_children() finds it."""
    ctypes.CDLL(None).prctl(36, 1, 0, 0, 0)


def _children() -> dict:
    """{pid: command line} of this process's live children."""
    out = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            stat = pathlib.Path(f"/proc/{entry}/stat").read_text()
            cmd = pathlib.Path(f"/proc/{entry}/cmdline").read_bytes()
        except OSError:
            continue
        state, ppid = stat[stat.rfind(")") + 2:].split()[:2]
        if int(ppid) == os.getpid() and state != "Z":
            out[int(entry)] = cmd.replace(b"\0", b" ").decode(
                errors="replace").strip()
    return out


def _reap() -> None:
    with contextlib.suppress(ChildProcessError):
        while os.waitpid(-1, os.WNOHANG)[0] > 0:
            pass


def stop_children(grace: float = 10.0, limit: float = 90.0) -> list:
    """Stop every process this one started that is still alive, orphans
    included (adopt_orphans): SIGTERM when first seen, SIGKILL once it has
    outlived `grace` seconds, until none is left (or `limit` seconds have
    passed); a rank whose launcher was stopped comes back to this process
    and is stopped in turn. Reaps every child; returns the command lines
    of those it stopped."""
    stopped, since = {}, {}
    end = time.monotonic() + limit
    while True:
        _reap()
        alive = _children()
        if not alive or time.monotonic() > end:
            return list(stopped.values())
        now = time.monotonic()
        for pid, cmd in alive.items():
            stopped.setdefault(pid, cmd)
            sig = signal.SIGTERM
            if pid not in since:
                since[pid] = now
            elif now - since[pid] > grace:
                sig = signal.SIGKILL
            else:
                continue
            with contextlib.suppress(OSError):
                os.kill(pid, sig)
        time.sleep(0.1)


def _terminated(signum, frame):
    """SIGTERM ends the script as an exception would, so that its
    processes are stopped on the way out."""
    raise SystemExit(128 + signum)


def emit(phase: str, **kw) -> None:
    """One JSON line for a phase, with the script's elapsed seconds."""
    print(json.dumps({"phase": phase, "t": round(time.perf_counter()
                                                - T_START, 1), **kw}),
          flush=True)


def smi_sample() -> str:
    """The card's SM and memory clocks, power draw, temperature and active
    clock-limit reasons, as nvidia-smi prints them (its error text if the
    query fails), to read beside a timing."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu,clocks_throttle_reasons.active",
         "--format=csv,noheader"], capture_output=True, text=True)
    return (out.stdout or out.stderr).strip()


def timed(fn, *args, **kw):
    """(result, ms) of one call, synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def same_floats(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when two f32 tensors hold the same bits (NaN and -0.0 too)."""
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def tile_line(wrapper, B: int) -> dict:
    """The tile plan of a tile kernel's wrapper's last launch (K1a, K1c,
    K1b/K1c', K3: its cluster size, frames a tile, tiles, and the clusters
    launched, at most those resident by cudaOccupancyMaxActiveClusters; K2:
    its form, frames a tile, tiles and the blocks launched), and whether
    the last tile is ragged."""
    plan, resident = wrapper.last_plan[:2]
    line = dict(plan=dict(plan.as_dict(), resident=resident),
                ragged=B % plan.frames != 0)
    if len(wrapper.last_plan) > 2:  # the layered kernels' message precision
        line["plan"]["precision"] = wrapper.last_plan[2]
    return line


def frozen(res, max_iters: int) -> int:
    """Frames that stopped before max_iters (track mode's freeze)."""
    return int((res.iterations < max_iters).sum().item())


def compare(graph, llr, kw):
    """Kernel and plain version on the same LLRs; raises unless bits, ok,
    iterations and the final posteriors are identical. Returns (the
    numbers to print, the kernel's DecodeResult)."""
    dkw = {k: kw[k] for k in ("alpha", "beta", "max_iters", "early_term")
           if k in kw}
    (kern, ktot), kern_ms = timed(minsum_with_posteriors_cuda, graph, llr,
                                  **dkw)
    (plain, ptot), plain_ms = timed(plain_with_posteriors, graph, llr, **dkw)
    err = max(
        (kern.bits.int() - plain.bits.int()).abs().max().item(),
        (kern.ok.int() - plain.ok.int()).abs().max().item(),
        (kern.iterations - plain.iterations).abs().max().item(),
        (ktot - ptot).abs().max().item(),
    )
    same = (torch.equal(kern.bits, plain.bits) and torch.equal(kern.ok, plain.ok)
            and torch.equal(kern.iterations, plain.iterations)
            and same_floats(ktot, ptot))
    if not same:
        raise AssertionError(f"kernel and plain version differ (max abs err {err})")
    return dict(kernel_ms=kern_ms, plain_ms=plain_ms, max_abs_err=float(err),
                frames=llr.shape[0], ok_frames=int(kern.ok.sum().item()),
                mean_iters=kern.iterations.float().mean().item(),
                frozen_frames=frozen(kern, dkw.get("max_iters", 25)),
                **tile_line(layered_decode_cuda, llr.shape[0])), kern


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 on a line where adjacent floats differ by 1 (+0 = -0)."""
    i = x.contiguous().view(torch.int32).long()
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def _first(x):
    """A per-iteration schedule's first entry (as a schedule), or x."""
    return np.asarray(x)[:1] if np.ndim(x) else x


def compare_posteriors(kernel_fn, plain_fn, graph, llr, dkw,
                       final_exact: bool = False, tiles=None) -> dict:
    """A kernel's with-posteriors wrapper and its plain version on the same
    LLRs with decoder arguments dkw: raises unless bits, ok and iterations
    are identical and, after one fixed iteration (a schedule's first
    alpha/beta), the posteriors are within EXACT_MAX_ULPS; with
    final_exact (min-sum) also unless the final posteriors are identical.
    With `tiles` (the tile kernel's wrapper) the line carries the decode's
    tile plan, and whether a tile's frames stopped at different
    iterations."""
    (kern, ktot), kern_ms = timed(kernel_fn, graph, llr, **dkw)
    plan = {} if tiles is None else dict(
        tile_line(tiles, llr.shape[0]),
        spread_stops=spread_stops(kern, tiles.last_plan[0].frames))
    (plain, ptot), plain_ms = timed(plain_fn, graph, llr, **dkw)
    same = (torch.equal(kern.bits, plain.bits) and torch.equal(kern.ok, plain.ok)
            and torch.equal(kern.iterations, plain.iterations))
    max_abs = (ktot - ptot).abs().max().item()
    one = dict(dkw, max_iters=1, early_term=False)
    for ab in ("alpha", "beta"):
        if ab in one:
            one[ab] = _first(one[ab])
    _, k1 = kernel_fn(graph, llr, **one)
    _, p1 = plain_fn(graph, llr, **one)
    ulps1 = int((_ordered(k1) - _ordered(p1)).abs().max().item())
    if not same:
        raise AssertionError(
            f"{kernel_fn.__name__} and its plain version decide differently "
            f"(posterior max abs err {max_abs}, one-sweep ulps {ulps1})")
    if ulps1 > EXACT_MAX_ULPS:
        raise AssertionError(f"{kernel_fn.__name__}: one-sweep posteriors "
                             f"{ulps1} ulps apart")
    if final_exact and not same_floats(ktot, ptot):
        raise AssertionError(f"{kernel_fn.__name__}: final posteriors differ "
                             f"(max abs err {max_abs})")
    return dict(kernel_ms=kern_ms, plain_ms=plain_ms, max_abs_err=max_abs,
                one_sweep_max_ulps=ulps1, frames=llr.shape[0],
                ok_frames=int(kern.ok.sum().item()),
                mean_iters=kern.iterations.float().mean().item(),
                frozen_frames=frozen(kern, dkw.get("max_iters", 25)), **plan)


def compare_exact(graph, llr, kw) -> dict:
    """The exact-BP kernel (K1c) against its plain version."""
    dkw = dict(max_iters=kw.get("max_iters", 25),
               early_term=kw.get("early_term", True), cn=kw["cn"])
    return compare_posteriors(exact_with_posteriors_cuda,
                              plain_with_posteriors, graph, llr, dkw,
                              tiles=layered_exact_cuda)


def need_plan(kernel: str, lines, what: str, pred) -> None:
    """Raise unless one of a kernel's cases launched a plan that `pred`
    (of the case line) accepts; `what` names it."""
    if not any(pred(r) for r in lines):
        raise AssertionError(f"{kernel}: no case launched {what}")


def check_plans(kernel: str, lines) -> None:
    """Raise unless a kernel's cases launched a plan with CS > 1 and one
    with CS = 1."""
    need_plan(kernel, lines, "a plan with CS = 1",
              lambda r: r["plan"]["cluster"] == 1)
    need_plan(kernel, lines, "a plan with CS > 1",
              lambda r: r["plan"]["cluster"] > 1)


def compare_classic(graph, llr, kw) -> dict:
    """The classic kernel (K1b, K1c'; multi-edge graphs) against its plain
    version."""
    dkw = dict(alpha=kw.get("alpha", 1.0), beta=kw.get("beta", 0.0),
               max_iters=kw.get("max_iters", 25),
               early_term=kw.get("early_term", True),
               cn=kw.get("cn", "minsum"))
    return compare_posteriors(classic_with_posteriors_cuda,
                              plain_with_posteriors, graph, llr, dkw,
                              tiles=layered_classic_cuda)


def compare_flooding(graph, llr, kw, kernel_fn, plain_fn) -> dict:
    """A flooding kernel (K2 or K3) against its plain version; the line
    carries its tile plan."""
    dkw = dict(kind=kw["kind"], alpha=kw.get("alpha", 1.0),
               beta=kw.get("beta", 0.0), max_iters=kw.get("max_iters", 25),
               early_term=kw.get("early_term", True))
    tiles = (flooding_qc_decode_cuda
             if kernel_fn is flooding_qc_with_posteriors_cuda
             else flooding_decode_cuda)
    return compare_posteriors(kernel_fn, plain_fn, graph, llr, dkw,
                              tiles=tiles)


def spread_stops(res, frames: int) -> bool:
    """Some tile of `frames` frames holds frames that stopped at different
    iterations (track mode's per-frame freeze inside one tile)."""
    it = res.iterations
    whole = it.shape[0] // frames * frames
    tiles = it[:whole].view(-1, frames)
    return bool((tiles.amax(1) != tiles.amin(1)).any().item())


def check_k2_plans(lines) -> None:
    """Raise unless K2's cases launched both forms, a tile of F >= 2 with a
    ragged last tile, and a track tile whose frames stopped at different
    iterations."""
    need_plan("K2", lines, 'the form "chip"',
              lambda r: r["plan"]["form"] == "chip")
    need_plan("K2", lines, 'the form "global"',
              lambda r: r["plan"]["form"] == "global")
    need_plan("K2", lines, "F >= 2 with a ragged last tile",
              lambda r: r["plan"]["frames"] >= 2 and r["ragged"])
    need_plan("K2", lines, "a tile whose frames stop at different "
              "iterations", lambda r: r["spread_stops"])


def bench_line(res, launches, smi_before) -> dict:
    return dict(smi_before=smi_before, smi_after=smi_sample(),
                ms=res.wall_s_per_batch * 1e3, mbps=res.throughput_mbps,
                tries_ms=[t * 1e3 for t in res.tries_s], launches=launches,
                bound_ms=res.bound_ms, bound_by=res.roofline_form,
                frame_errors=res.frame_errors, frames=res.batch,
                fer=res.frame_errors / res.batch,
                codeword_frame_errors=res.codeword_frame_errors,
                mean_iters=res.mean_iters)


def point_line(pr: PointResult) -> dict:
    return dict(ebn0_db=pr.ebn0_db, frames=pr.frames,
                frame_errors=pr.frame_errors, fer=pr.fer, fer_ci=pr.fer_ci,
                bit_errors=pr.bit_errors, ber=pr.ber,
                mean_iters=pr.mean_iters, wall_s=pr.wall_s)


def ccsds_path(dev, spec12, k3, flood_err, k3_lines) -> list:
    """Phases 16-19: the classic kernel on multi-edge graphs (CCSDS
    AR4JA) against its plain version, timed, in a sweep and in the
    production retry decoder; returns its entries of the kernels line.
    flood_err and k3_lines gain the K3 cases on the multi-edge graphs."""
    # 16. the classic kernel (K1b, K1c') against its plain version
    t0 = time.perf_counter()
    classic_err = dict.fromkeys(KINDS, 0.0)
    classic_lines = []

    def note(code, name, spec_str, ebn0, graph, llr, kw):
        r = compare_classic(graph, llr, kw)
        cn = kw.get("cn", "minsum")
        classic_err[cn] = max(classic_err[cn], r["max_abs_err"])
        classic_lines.append(r)
        emit("classic_vs_plain", code=code, case=name, decoder=spec_str,
             ebn0_db=ebn0, **r)
        return r

    for code, ebn0 in CLASSIC_CODES.items():
        cases = [(f"{k}_{name}", spec_str.format(r=RULE[k]), B)
                 for k in KINDS for name, spec_str, B in CLASSIC_CASES]
        cases += [(f"minsum_{name}", spec_str, B)
                  for name, spec_str, B in CLASSIC_MINSUM_CASES]
        for name, spec_str, B in cases:
            x = make_inputs(code, spec_str, B, ebn0, dev, seed=1)
            note(code, name, spec_str, ebn0, x.graph, x.llr, x.kw)
    for name, code, ebn0, B, encodable in CLASSIC_PLAN_CASES:
        for k in KINDS:
            spec_str = f"layered/{RULE[k]}/25"
            if encodable:
                x = make_inputs(code, spec_str, B, ebn0, dev, seed=1)
                inputs = x.graph, x.llr, x.kw
            else:
                inputs = zero_codeword(code, spec_str, B, ebn0, dev)
            note(code, f"{k}_{name}", spec_str, ebn0, *inputs)
    classic_parity = {}
    for cn in KINDS:
        x = make_inputs(**CCSDS_LEGS[cn], device=dev, seed=0)
        classic_parity[cn] = note(CCSDS_LEGS[cn]["code"], f"{cn}_bench_shape",
                                  CCSDS_LEGS[cn]["decoder"],
                                  CCSDS_LEGS[cn]["ebn0_db"], x.graph, x.llr,
                                  x.kw)
        del x
    need_plan("layered_classic", classic_lines, "a plan with F >= 2",
              lambda r: r["plan"]["frames"] >= 2)
    need_plan("layered_classic", classic_lines, "a plan with CS > 1",
              lambda r: r["plan"]["cluster"] > 1)
    for name, code, spec_str, B in CLASSIC_FLOODING_CASES:
        x = make_inputs(code, spec_str, B, CLASSIC_CODES[code], dev, seed=1)
        r = compare_flooding(x.graph, x.llr, x.kw, *k3)
        flood_err["flooding_qc:spa"] = max(flood_err["flooding_qc:spa"],
                                           r["max_abs_err"])
        k3_lines.append(dict(r, code=code))
        emit("flooding_qc_vs_plain", code=code, case=name,
             decoder=spec_str, **r)
        del x
    # each layered kernel takes only its own form of graph
    ccsds12 = choose_graph(get_code(CCSDS_PRODUCTION_SWEEP["code"]),
                           "layered/spa/2")
    refusals = [
        (layered_classic_cuda, choose_graph(spec12, "layered/spa/2"), {}),
        (layered_decode_cuda, ccsds12, {}),
        (layered_exact_cuda, ccsds12, {"cn": "spa"}),
    ]
    for fn, graph, kw in refusals:
        try:
            fn(graph, torch.zeros((1, graph.n), device=dev), max_iters=2, **kw)
        except ValueError:
            continue
        raise AssertionError(f"{fn.__name__} took the other form of graph")
    emit("classic_vs_plain", refusals=len(refusals),
         seconds=time.perf_counter() - t0)

    # 17. the CCSDS legs timed; each rule's count read around its own run
    classic_bench, classic_bench_launches, classic_plans = {}, {}, {}
    for cn in KINDS:
        layered_classic_cuda.by_rule = dict.fromkeys(KINDS, 0)
        smi_before = smi_sample()
        res = run_benchmark(**CCSDS_LEGS[cn], device=dev)
        classic_bench_launches[cn] = layered_classic_cuda.by_rule[cn]
        classic_plans[cn] = tile_line(layered_classic_cuda, res.batch)["plan"]
        emit("ccsds_bench", cn=cn, code=res.code, decoder=res.decoder,
             plain_ms=classic_parity[cn]["plain_ms"], plan=classic_plans[cn],
             **bench_line(res, classic_bench_launches[cn], smi_before))
        if not res.frame_errors / res.batch < CCSDS_FER_MAX:
            raise AssertionError(f"ccsds {cn}: FER above {CCSDS_FER_MAX}")
        if classic_bench_launches[cn] <= 0:
            raise AssertionError(f"ccsds {cn}: the classic kernel never "
                                 f"launched")
        classic_bench[cn] = res

    # 18. the CCSDS sweep against the JAX package's CPU reference
    with open(CCSDS_REFERENCE) as f:
        reference = [PointResult.from_json(d) for d in json.load(f)]
    t0 = time.perf_counter()
    swept = run_sweep(SweepSpec(
        code=CCSDS_PRODUCTION_SWEEP["code"], decoder=CCSDS_SWEEP_DECODER,
        ebn0_db=CCSDS_SWEEP_EBN0, batch=CCSDS_PRODUCTION_SWEEP["batch"],
        stopping=StoppingRule(min_frame_errors=10 ** 9,
                              max_frames=CCSDS_SWEEP_FRAMES)), device=dev)
    ref = [q for q in reference if q.decoder == CCSDS_SWEEP_DECODER]
    overlap = curves_overlap(swept, ref, "fer")
    for pr in swept:
        g = next(q for q in ref if abs(q.ebn0_db - pr.ebn0_db) < 1e-9)
        emit("ccsds_vs_reference", decoder=CCSDS_SWEEP_DECODER,
             **point_line(pr), reference_fer=g.fer,
             reference_fer_ci=g.fer_ci)
    emit("ccsds_vs_reference", overlap=overlap,
         seconds=time.perf_counter() - t0)
    if not overlap:
        raise AssertionError("the CCSDS sweep misses the JAX reference")

    # 19. the CCSDS production path through the CLI at the reference's
    # retry points (the fallback gets frames at the lower one): counts
    # from this run
    ref_retry = [q for q in reference
                 if q.decoder == CCSDS_PRODUCTION_SWEEP["decoder"]]
    layered_classic_cuda.launches = 0
    layered_classic_cuda.frames = 0
    layered_classic_cuda.by_rule = dict.fromkeys(KINDS, 0)
    layered_classic_cuda.frames_by_rule = dict.fromkeys(KINDS, 0)
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "production_ccsds.json"
        t0 = time.perf_counter()
        rc = cli_main([
            "sweep", "--code", CCSDS_PRODUCTION_SWEEP["code"],
            "--decoder", CCSDS_PRODUCTION_SWEEP["decoder"],
            "--ebn0", ",".join(str(q.ebn0_db) for q in ref_retry),
            "--batch", str(CCSDS_PRODUCTION_SWEEP["batch"]),
            "--min-frame-errors", "1000000",
            "--max-frames", str(PRODUCTION_FRAMES), "--out", str(out)])
        wall = time.perf_counter() - t0
        prods = [PointResult.from_json(d) for d in json.loads(out.read_text())]
    ccsds_sweep = dict(layered_classic_cuda.by_rule)
    overlap = curves_overlap(prods, ref_retry, "fer")
    for pr, q in zip(prods, ref_retry):
        emit("production_ccsds", decoder=pr.decoder, **point_line(pr),
             reference_fer=q.fer, reference_fer_ci=q.fer_ci)
    emit("production_ccsds", rc=rc, seconds=wall, launches=ccsds_sweep,
         frames_to_fallback=layered_classic_cuda.frames_by_rule["spa"],
         overlap=overlap)
    if rc != 0 or [pr.frames for pr in prods] != [PRODUCTION_FRAMES] * len(
            ref_retry):
        raise AssertionError(f"ccsds production sweep: rc {rc}, "
                             f"{[pr.frames for pr in prods]} frames")
    if ccsds_sweep["minsum"] <= 0 or ccsds_sweep["spa"] <= 0:
        raise AssertionError("the CCSDS production sweep missed a rule of "
                             "the classic kernel")
    if layered_classic_cuda.frames_by_rule["spa"] <= 0:
        raise AssertionError("the CCSDS fallback got no frames")
    if not overlap:
        raise AssertionError("the CCSDS production FER misses the reference")

    kernels = []
    # K1b's and K1c' spa's counts are the CCSDS production sweep's (primary
    # and fallback), minstar's its own timed run's
    for cn in KINDS:
        res = classic_bench[cn]
        kernels.append({
            "name": f"layered_classic:{cn}",
            "route": "cuda",
            "source": "ecc_ldpc_tpu_torch/csrc/layered_classic.cu",
            "replaces": "ecc_ldpc_tpu/decode/pallas/layered_qc.py:"
                        + ("415" if cn == "minsum" else "630"),
            "launches": (classic_bench_launches[cn] if cn == "minstar"
                         else ccsds_sweep[cn]),
            "max_abs_err": classic_err[cn],
            "ms": res.wall_s_per_batch * 1e3,
            "plain_ms": classic_parity[cn]["plain_ms"],
            "bound_ms": res.bound_ms,
            "bound_by": res.roofline_form,
            "library_ms": None,
            "plan": classic_plans[cn],
        })
    return kernels


def compare_xor(schedule: str, graph, llr, kw) -> dict:
    """The xor instantiation of the kernel that serves `schedule` and the
    rule in kw against its plain version."""
    if schedule == "flooding":
        dkw = dict(kind=kw["kind"], alpha=kw.get("alpha", 1.0),
                   beta=kw.get("beta", 0.0), max_iters=kw.get("max_iters", 25),
                   early_term=kw.get("early_term", True))
        return compare_posteriors(
            flooding_qc_with_posteriors_cuda, flooding_qc_with_posteriors_plain,
            graph, llr, dkw, final_exact=kw["kind"] == "minsum",
            tiles=flooding_qc_decode_cuda)
    if kw.get("cn", "minsum") != "minsum":
        return compare_exact(graph, llr, kw)
    dkw = {k: kw[k] for k in ("alpha", "beta", "max_iters", "early_term")
           if k in kw}
    return compare_posteriors(minsum_with_posteriors_cuda,
                              plain_with_posteriors, graph, llr, dkw,
                              final_exact=True, tiles=layered_decode_cuda)


def xor_toy(dev):
    """The toy xor code (Z = 16, a 4x8 base from default_rng(3), as the
    JAX package's tests build it): its graph and 32 frames of LLRs of the
    all-zero codeword at XOR_TOY_EBN0."""
    Z = 16
    base = np.random.default_rng(3).integers(0, Z, size=(4, 8)).astype(
        np.int32)
    spec = expand_qc_xor(QCXorCode(Z=Z, base=base), name="toyxor16")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cw = torch.zeros((32, spec.n), dtype=torch.uint8, device=dev)
    return compile_qc_graph(spec), awgn_llr(gen, cw, XOR_TOY_EBN0, 0.5)


def zero_codeword(code: str, spec_str: str, B: int, ebn0: float, dev,
                  seed: int = 1):
    """(graph, LLRs of B all-zero codewords through the code's channel at
    ebn0, decoder arguments): for codes the port cannot encode yet."""
    spec = get_code(code)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cw = torch.zeros((B, spec.n), dtype=torch.uint8, device=dev)
    return (choose_graph(spec, spec_str), make_channel(spec)(gen, cw, ebn0),
            parse_decoder_spec(spec_str))


def check_k3_plans(lines) -> None:
    """Raise unless K3's cases (phases 12, 16, 20) launched a dvbs2/64800
    frame over a cluster of 8 and several frames an SM with a ragged last
    tile."""
    need_plan("flooding_qc", lines, "a cluster of 8 on dvbs2/64800",
              lambda r: r["plan"]["cluster"] == 8
              and r["code"].startswith("dvbs2/64800"))
    need_plan("flooding_qc", lines, "CS = 1, F >= 2 with a ragged last tile",
              lambda r: r["plan"]["cluster"] == 1
              and r["plan"]["frames"] >= 2 and r["ragged"])


def xor_path(dev, k3_lines) -> list:
    """Phases 20-22: the xor instantiations of the QC kernels (K4's two
    modes, and exact BP) on IEEE 802.3an against their plain versions,
    timed, in sweeps and in the production retry decoder; returns their
    entries of the kernels line."""
    wrappers = {"layered": layered_decode_cuda, "exact": layered_exact_cuda,
                "flooding": flooding_qc_decode_cuda}
    roll_before = {k: w.launches_by_perm["roll"] for k, w in wrappers.items()}

    # 20. each xor kernel against its plain version
    t0 = time.perf_counter()
    xor_err = {}

    def note(key, r):
        xor_err[key] = max(xor_err.get(key, 0.0), r["max_abs_err"])

    code = XOR_LEGS["layered"]["code"]
    for schedule, rules in XOR_RULES.items():
        cases = [(f"{k}_{name}", spec_str.format(r=rules[k]), ebn0, B)
                 for k in KINDS for name, spec_str, ebn0, B in XOR_CASES]
        if schedule == "layered":
            cases += [(f"minsum_{name}", spec_str, ebn0, 32)
                      for name, spec_str, ebn0 in XOR_MINSUM_CASES]
        cases += [(f"{k}_{name}", spec_str.format(r=rules[k]), ebn0, B)
                  for k in ("minsum", "spa")
                  for name, spec_str, ebn0, B in XOR_PLAN_CASES]
        for name, spec_str, ebn0, B in cases:
            x = make_inputs(code, spec_str, B, ebn0, dev, seed=1)
            r = compare_xor(schedule, x.graph, x.llr, x.kw)
            note(f"{schedule}:{name.split('_')[0]}", r)
            if schedule == "flooding":
                k3_lines.append(dict(r, code=code))
            emit("xor_vs_plain", code=code, schedule=schedule, case=name,
                 decoder=spec_str, ebn0_db=ebn0, **r)
    toy, toy_llr = xor_toy(dev)
    for schedule in ("layered", "flooding"):
        for mode, et in (("fixed", False), ("track", True)):
            kw = dict(alpha=0.8125, max_iters=25, early_term=et,
                      kind="minsum")
            r = compare_xor(schedule, toy, toy_llr, kw)
            note(f"{schedule}:minsum", r)
            emit("xor_vs_plain", code=toy.name, schedule=schedule,
                 case=f"minsum_{mode}", ebn0_db=XOR_TOY_EBN0, **r)
    xor_parity = {}
    for leg, cfg in XOR_LEGS.items():
        x = make_inputs(**cfg, device=dev, seed=0)
        xor_parity[leg] = r = compare_xor(leg, x.graph, x.llr, x.kw)
        note(f"{leg}:minsum", r)
        emit("xor_vs_plain", code=cfg["code"], schedule=leg,
             case="minsum_bench_shape", decoder=cfg["decoder"], **r)
        del x
    an = choose_graph(get_code(code), "layered/spa/2")
    for cn in ("minsum", "spa"):  # K1b, K1c′
        try:
            layered_classic_cuda(an, torch.zeros((1, an.n), device=dev),
                                 max_iters=2, cn=cn)
        except ValueError:
            pass
        else:
            raise AssertionError(f"layered_classic_cuda ({cn}) took a "
                                 f"graph that repeats no block-column in a "
                                 f"layer")
    check_k3_plans(k3_lines)
    emit("xor_vs_plain", refusals=2, seconds=time.perf_counter() - t0)

    # 21. the xor legs timed, and exact BP on the same shape; each count
    # read around its own run
    timed_legs = {**XOR_LEGS,
                  "spa": dict(XOR_LEGS["layered"], decoder="layered/spa/25/noet")}
    kernel_of = {"layered": "layered", "flooding": "flooding", "spa": "exact"}
    xor_bench, xor_launches, xor_plans = {}, {}, {}
    for leg, cfg in timed_legs.items():
        x = make_inputs(**cfg, device=dev, seed=0)
        if leg == "spa":
            xor_parity[leg] = r = compare_xor("layered", x.graph, x.llr, x.kw)
            note("layered:spa", r)
            emit("xor_vs_plain", code=cfg["code"], schedule="layered",
                 case="spa_bench_shape", decoder=cfg["decoder"], **r)
        del x
        w = wrappers[kernel_of[leg]]
        w.launches_by_perm = dict.fromkeys(w.launches_by_perm, 0)
        smi_before = smi_sample()
        res = run_benchmark(**cfg, device=dev)
        xor_launches[leg] = dict(w.launches_by_perm)
        xor_plans[leg] = (tile_line(w, res.batch)["plan"]
                          if hasattr(w, "last_plan") else None)
        emit("xor_bench", leg=leg, code=res.code, decoder=res.decoder,
             plan=xor_plans[leg],
             plain_ms=xor_parity[leg]["plain_ms"],
             launches_by_perm=xor_launches[leg],
             **bench_line(res, xor_launches[leg]["xor"], smi_before))
        if not res.frame_errors / res.batch <= XOR_FER_MAX:
            raise AssertionError(f"8023an {leg}: FER above {XOR_FER_MAX}")
        if xor_launches[leg]["xor"] <= 0 or xor_launches[leg]["roll"]:
            raise AssertionError(f"8023an {leg}: not the xor kernel alone")
        xor_bench[leg] = res

    # 22. the sweeps against the JAX package's CPU reference; K4's flooding
    # count read around its sweep
    with open(XOR_REFERENCE) as f:
        reference = [PointResult.from_json(d) for d in json.load(f)]
    sweep_launches = {}
    for dec_spec, (ebn0s, golden_path) in XOR_SWEEPS.items():
        with open(golden_path) as f:
            golden = [PointResult.from_json(d) for d in json.load(f)]
        ref = [q for q in reference if q.decoder == dec_spec]
        for w in wrappers.values():
            w.launches_by_perm = dict.fromkeys(w.launches_by_perm, 0)
        t0 = time.perf_counter()
        swept = run_sweep(SweepSpec(
            code=code, decoder=dec_spec, ebn0_db=ebn0s,
            batch=XOR_LEGS["layered"]["batch"],
            stopping=StoppingRule(min_frame_errors=10 ** 9,
                                  max_frames=XOR_SWEEP_FRAMES)), device=dev)
        sweep_launches[dec_spec] = {k: dict(w.launches_by_perm)
                                    for k, w in wrappers.items()}
        overlap = curves_overlap(swept, ref, "fer")
        golden_overlap = curves_overlap(swept, golden, "fer")
        for pr in swept:
            q = next(q for q in ref if abs(q.ebn0_db - pr.ebn0_db) < 1e-9)
            g = next(q for q in golden if abs(q.ebn0_db - pr.ebn0_db) < 1e-9)
            emit("xor_vs_reference", decoder=dec_spec, **point_line(pr),
                 reference_fer=q.fer, reference_fer_ci=q.fer_ci,
                 golden_fer=g.fer, golden_fer_ci=g.fer_ci)
        emit("xor_vs_reference", decoder=dec_spec, overlap=overlap,
             golden_overlap_information_only=golden_overlap,
             golden=golden_path.name, launches=sweep_launches[dec_spec],
             seconds=time.perf_counter() - t0)
        if not overlap:
            raise AssertionError(f"{dec_spec}: the 8023an sweep misses the "
                                 f"JAX reference")

    # the production retry decoder through the CLI: counts from this run
    (ref_retry,) = [q for q in reference
                    if q.decoder == XOR_PRODUCTION_SWEEP["decoder"]]
    for w in wrappers.values():
        w.launches_by_perm = dict.fromkeys(w.launches_by_perm, 0)
    layered_exact_cuda.frames_by_perm = dict.fromkeys(
        layered_exact_cuda.frames_by_perm, 0)
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "production_8023an.json"
        t0 = time.perf_counter()
        rc = cli_main([
            "sweep", "--code", XOR_PRODUCTION_SWEEP["code"],
            "--decoder", XOR_PRODUCTION_SWEEP["decoder"],
            "--ebn0", str(XOR_PRODUCTION_SWEEP["ebn0_db"]),
            "--batch", str(XOR_PRODUCTION_SWEEP["batch"]),
            "--min-frame-errors", "1000000",
            "--max-frames", str(PRODUCTION_FRAMES), "--out", str(out)])
        wall = time.perf_counter() - t0
        (prod,) = [PointResult.from_json(d)
                   for d in json.loads(out.read_text())]
    retry_launches = {k: dict(w.launches_by_perm) for k, w in wrappers.items()}
    overlap = curves_overlap([prod], [ref_retry], "fer")
    emit("production_8023an", decoder=prod.decoder, rc=rc, **point_line(prod),
         reference_fer=ref_retry.fer, reference_fer_ci=ref_retry.fer_ci,
         seconds=wall, launches=retry_launches,
         frames_to_fallback=layered_exact_cuda.frames_by_perm["xor"],
         overlap=overlap)
    if rc != 0 or prod.frames != PRODUCTION_FRAMES:
        raise AssertionError(f"8023an production sweep: rc {rc}, "
                             f"{prod.frames} frames")
    if (retry_launches["layered"]["xor"] <= 0
            or retry_launches["exact"]["xor"] <= 0):
        raise AssertionError("the 8023an production sweep missed a xor kernel")
    if layered_exact_cuda.frames_by_perm["xor"] <= 0:
        raise AssertionError("the 8023an fallback got no frames")
    if not overlap:
        raise AssertionError("the 8023an production FER misses the reference")
    roll_after = {k: w.launches_by_perm["roll"] for k, w in wrappers.items()}
    if any(roll_after.values()):
        raise AssertionError(f"a roll kernel launched on a xor path "
                             f"({roll_after}; before: {roll_before})")

    # K4 layered's count is the production sweep's primary, K4 flooding's
    # the flooding sweep's, exact BP's (xor) the production fallback's
    rows = [
        ("layered_qc:xor", "layered", "layered:minsum",
         "ecc_ldpc_tpu_torch/csrc/layered_qc.cu",
         "ecc_ldpc_tpu/decode/pallas/layered_xor.py:65",
         retry_launches["layered"]["xor"]),
        ("flooding_qc:minsum:xor", "flooding", "flooding:minsum",
         "ecc_ldpc_tpu_torch/csrc/flooding_qc.cu",
         "ecc_ldpc_tpu/decode/pallas/layered_xor.py:65",
         sweep_launches["minsum/norm:0.8125/25"]["flooding"]["xor"]),
        ("layered_exact:spa:xor", "spa", "layered:spa",
         "ecc_ldpc_tpu_torch/csrc/layered_exact.cu",
         "ecc_ldpc_tpu/decode/pallas/layered_qc.py:501",
         retry_launches["exact"]["xor"]),
    ]
    kernels = []
    for name, leg, err_key, src, replaces, launches in rows:
        res = xor_bench[leg]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": xor_err[err_key],
            "ms": res.wall_s_per_batch * 1e3,
            "plain_ms": xor_parity[leg]["plain_ms"],
            "bound_ms": res.bound_ms,
            "bound_by": res.roofline_form,
            "library_ms": None,
        })
        if xor_plans[leg] is not None:  # the tile kernels, K1a, K1c, K3
            kernels[-1]["plan"] = xor_plans[leg]
    return kernels


def ptxas_wide(report: str, width: int = 64) -> dict:
    """{kernel function: "registers, spill stores/loads" line} of the
    instances of one width in a ptxas -v report (their template's first
    argument, mangled "ILi64E")."""
    out, fn = {}, None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif fn and f"ILi{width}E" in fn and ("spill" in ln
                                              or "registers" in ln):
            out[fn] = (out.get(fn, "") + " " + ln.strip()).strip()
    return out


def note_compare(lines, errs, key, phase, code, name, spec_str, ebn0, r):
    """Keep a compare's line and its kernel's largest error, and print it."""
    errs[key] = max(errs.get(key, 0.0), r["max_abs_err"])
    lines.append(dict(r, code=code))
    emit(phase, code=code, case=name, decoder=spec_str, ebn0_db=ebn0,
         kernel=key, **r)


def compare_spec(graph, llr, kw):
    """(kernel key, compare line) of the kernel a parsed decoder spec
    runs: K1a for layered min-sum, K1c for the exact layered rules, K3
    for QC flooding, K2 for flooding on an unstructured graph."""
    if kw["kind"] == "layered":
        if kw.get("cn", "minsum") == "minsum":
            return "layered_qc", compare(graph, llr, kw)[0]
        return f"layered_exact:{kw['cn']}", compare_exact(graph, llr, kw)
    if hasattr(graph, "Z"):
        return f"flooding_qc:{kw['kind']}", compare_flooding(
            graph, llr, kw, flooding_qc_with_posteriors_cuda,
            flooding_qc_with_posteriors_plain)
    return f"flooding:{kw['kind']}", compare_flooding(
        graph, llr, kw, flooding_with_posteriors_cuda,
        flooding_with_posteriors_plain)


WRAPPERS = {"layered_qc": layered_decode_cuda,
            "layered_exact": layered_exact_cuda,
            "layered_classic": layered_classic_cuda,
            "flooding": flooding_decode_cuda,
            "flooding_qc": flooding_qc_decode_cuda}


def families_path(dev, ptxas: dict) -> dict:
    """Phases 26-29: the other code families (802.11n, WiMAX, 5G NR with
    filler, puncturing, truncation and the circular buffer, SC, punct:)
    through K1a, K1c and K3 against their plain versions; row degree 34
    through the 64-wide builds of K1a, K1c, K3 and K2 (through mat:),
    timed; the family sweeps against the goldens and the JAX CPU
    references; bench/families.py. Returns {"errs": largest error per
    kernels-line name, "launches": the path's launches per wrapper
    (phases 28-29), "wide": the 64-wide entries of the kernels line}."""
    errs, lines = {}, []
    t0 = time.perf_counter()
    # 26. the families, kernel vs plain
    for code, ebn0 in FAMILY_CODES.items():
        for name, spec_str, B in FAMILY_CASES:
            x = make_inputs(code, spec_str, B, ebn0, dev, seed=1)
            key, r = compare_spec(x.graph, x.llr, x.kw)
            note_compare(lines, errs, key, "family_vs_plain", code, name,
                         spec_str, ebn0, r)
            del x
    specs = [get_code(HARQ_CODE.format(rv=rv)) for rv in range(4)]
    enc = build_encoder(specs[0])
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    msg = torch.randint(0, 2, (32, specs[0].k), generator=gen, device=dev,
                        dtype=torch.uint8)
    cw = enc(msg)
    kw = parse_decoder_spec(HARQ_DECODER)
    llrs = []
    for rv, spec in enumerate(specs):
        llrs.append(make_channel(spec)(gen, cw, HARQ_EBN0))
        graph = choose_graph(spec, HARQ_DECODER)
        for B in (32, 13):
            key, r = compare_spec(graph, llrs[-1][:B].contiguous(), kw)
            note_compare(lines, errs, key, "family_vs_plain", spec.name,
                         f"rv{rv}_track_{B}frames", HARQ_DECODER, HARQ_EBN0, r)
    combined = harq_combine(*llrs)
    key, r = compare_spec(choose_graph(specs[0], HARQ_DECODER), combined, kw)
    note_compare(lines, errs, key, "family_vs_plain", specs[0].name,
                 "harq_combine_rv0123", HARQ_DECODER, HARQ_EBN0, r)
    emit("harq", frames=32, ok_frames_combined=r["ok_frames"],
         seconds=time.perf_counter() - t0)
    need_plan("layered_qc", lines, "a cluster of one on an odd Z",
              lambda r: r["code"].startswith("80211n")
              and r["plan"]["cluster"] == 1)

    # 27. row degree 34 through the 64-wide builds, and their spill
    t0 = time.perf_counter()
    spill = {}  # (source, width) -> the most any instance spills
    for src in ("layered_qc", "layered_exact", "flooding_qc", "flooding"):
        for width in (64, 32):
            fns = ptxas_wide(ptxas[src], width)
            spill[src, width] = max(
                int(v.split(" bytes spill stores")[0].split()[-1])
                for v in fns.values())
            emit("wide_ptxas", source=src, width=width, kernels=fns)
    wide_lines = []
    for name, spec_str, B in WIDE_CASES:
        x = make_inputs(WIDE_CODE, spec_str, B, WIDE_EBN0, dev, seed=1)
        key, r = compare_spec(x.graph, x.llr, x.kw)
        note_compare(wide_lines, errs, f"{key}:64", "wide_vs_plain",
                     WIDE_CODE, name, spec_str, WIDE_EBN0, r)
        del x
    tmp = tempfile.TemporaryDirectory()
    mat = pathlib.Path(tmp.name) / "dvbs2_16200_910.mat"
    mat.write_text(dumps_matlab_sparse(get_code(WIDE_CODE)))
    mat_code = f"mat:{mat}"
    narrow_mat = pathlib.Path(tmp.name) / "dvbs2_16200_89.mat"
    narrow_mat.write_text(dumps_matlab_sparse(get_code(NARROW_CODE)))
    for name, spec_str, B in WIDE_K2_CASES:
        x = make_inputs(mat_code, spec_str, B, WIDE_EBN0, dev, seed=1)
        key, r = compare_spec(x.graph, x.llr, x.kw)
        note_compare(wide_lines, errs, f"{key}:64", "wide_vs_plain",
                     mat_code, name, spec_str, WIDE_EBN0, r)
        del x
    need_plan("flooding", wide_lines, "the 64-wide build",
              lambda r: r["plan"].get("width") == 64)
    wide = []
    for name, _, dec in WIDE_LEGS:
        code = mat_code if name.startswith("flooding:") else WIDE_CODE
        wrapper = WRAPPERS[name.split(":")[0]]
        # the plain version at the timed shape (run_benchmark's seed)
        x = make_inputs(code, dec, WIDE_B, WIDE_EBN0, dev, seed=0)
        key, parity = compare_spec(x.graph, x.llr, x.kw)
        errs[f"{key}:64"] = max(errs.get(f"{key}:64", 0.0),
                                parity["max_abs_err"])
        del x
        wrapper.launches = 0
        smi_before = smi_sample()
        res = run_benchmark(code=code, decoder=dec, batch=WIDE_B,
                            ebn0_db=WIDE_EBN0, device=dev)
        launches = wrapper.launches
        plan = tile_line(wrapper, WIDE_B)["plan"]
        emit("wide_bench", kernel=name, code=code, decoder=dec, plan=plan,
             plain_ms=parity["plain_ms"],
             **bench_line(res, launches, smi_before))
        if launches <= 0:
            raise AssertionError(f"{name} (64-wide) never launched")
        wide.append({
            "name": name, "width": 64, "route": "cuda",
            "source": dict(
                layered_qc="ecc_ldpc_tpu_torch/csrc/layered_qc.cu",
                layered_exact="ecc_ldpc_tpu_torch/csrc/layered_exact.cu",
                flooding_qc="ecc_ldpc_tpu_torch/csrc/flooding_qc.cu",
                flooding="ecc_ldpc_tpu_torch/csrc/flooding.cu")[
                    name.split(":")[0]],
            "replaces": dict(
                layered_qc="ecc_ldpc_tpu/decode/pallas/layered_qc.py:146",
                layered_exact="ecc_ldpc_tpu/decode/pallas/layered_qc.py:501",
                flooding_qc="ecc_ldpc_tpu/decode/pallas/flooding_qc.py:85",
                flooding="ecc_ldpc_tpu/decode/pallas/fused_mm.py:151")[
                    name.split(":")[0]],
            "launches": launches,
            "max_abs_err": errs.get(f"{name}:64", 0.0),
            "ms": res.wall_s_per_batch * 1e3,
            "plain_ms": parity["plain_ms"],
            "bound_ms": res.bound_ms, "bound_by": res.roofline_form,
            "library_ms": None, "code": code, "batch": WIDE_B,
            "plan": plan,
            "spill_bytes_max": spill[name.split(":")[0], 64],
        })
        # the 32-wide build on the same work, beside it
        code = (f"mat:{narrow_mat}" if name.startswith("flooding:")
                else NARROW_CODE)
        smi_before = smi_sample()
        res = run_benchmark(code=code, decoder=dec, batch=WIDE_B,
                            ebn0_db=NARROW_EBN0, device=dev)
        emit("narrow_bench", kernel=name, code=code, decoder=dec,
             plan=tile_line(wrapper, WIDE_B)["plan"],
             **bench_line(res, None, smi_before))
        wide[-1].update(ms_32wide=res.wall_s_per_batch * 1e3,
                        bound_ms_32wide=res.bound_ms, code_32wide=code,
                        spill_bytes_max_32wide=spill[name.split(":")[0], 32])
    emit("wide", seconds=time.perf_counter() - t0)

    # 28. the family sweeps (the path: counts from here to the end of 29)
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    for code, path in FAMILY_GOLDENS.items():
        golden = [PointResult.from_json(d) for d in
                  json.loads(path.read_text())]
        out = pathlib.Path(tmp.name) / f"{code.replace('/', '_')}.json"
        t1 = time.perf_counter()
        rc = cli_main([
            "sweep", "--code", code, "--decoder", FAMILY_SWEEP_DECODER,
            "--ebn0", ",".join(str(g.ebn0_db) for g in golden),
            "--batch", str(FAMILY_SWEEP_BATCH), "--min-frame-errors",
            "1000000", "--max-frames", str(FAMILY_SWEEP_FRAMES),
            "--out", str(out)])
        swept = [PointResult.from_json(d) for d in json.loads(out.read_text())]
        overlap = curves_overlap(swept, golden, "fer")
        for pr in swept:
            g = next(q for q in golden if abs(q.ebn0_db - pr.ebn0_db) < 1e-9)
            emit("family_vs_golden", code=code, decoder=FAMILY_SWEEP_DECODER,
                 **point_line(pr), golden_fer=g.fer, golden_fer_ci=g.fer_ci)
        emit("family_vs_golden", code=code, rc=rc, overlap=overlap,
             golden=path.name, seconds=time.perf_counter() - t1)
        if rc != 0 or not overlap:
            raise AssertionError(f"{code}: the sweep misses {path.name}")
    for code, source, ref_path in K2_FAMILY_SWEEPS:
        if source is not None:  # a dense 0/1 text file of source's H
            dense = pathlib.Path(tmp.name) / f"{source.replace('/', '_')}.txt"
            dense.write_text(dumps_dense(get_code(source)))
            code = f"{code}{dense}"
        ref = [PointResult.from_json(d) for d in
               json.loads(ref_path.read_text())]
        before = flooding_decode_cuda.launches
        swept = run_sweep(SweepSpec(
            code=code, decoder=K2_FAMILY_DECODER,
            ebn0_db=tuple(q.ebn0_db for q in ref), batch=FAMILY_SWEEP_BATCH,
            stopping=StoppingRule(min_frame_errors=1_000_000,
                                  max_frames=FAMILY_SWEEP_FRAMES)),
            device=dev)
        overlap = curves_overlap(swept, ref, "fer")
        for pr in swept:
            q = next(q for q in ref if abs(q.ebn0_db - pr.ebn0_db) < 1e-9)
            emit("family_vs_reference", code=code, decoder=K2_FAMILY_DECODER,
                 **point_line(pr), reference_fer=q.fer,
                 reference_fer_ci=q.fer_ci)
        emit("family_vs_reference", code=code, overlap=overlap,
             reference=ref_path.name,
             k2_launches=flooding_decode_cuda.launches - before)
        if not overlap or flooding_decode_cuda.launches == before:
            raise AssertionError(f"{code}: K2's sweep misses {ref_path.name}")
    for dec, code, ebn0 in FAMILY_EXACT_SWEEPS:
        (pr,) = run_sweep(SweepSpec(
            code=code, decoder=dec, ebn0_db=(ebn0,), batch=FAMILY_SWEEP_BATCH,
            stopping=StoppingRule(min_frame_errors=1_000_000,
                                  max_frames=FAMILY_SWEEP_FRAMES)),
            device=dev)
        emit("family_exact_sweep", code=code, decoder=dec, **point_line(pr))
        if not pr.fer < 0.5:
            raise AssertionError(f"{code} {dec}: FER {pr.fer}")
    emit("family_sweeps", seconds=time.perf_counter() - t0)
    tmp.cleanup()

    # 29. bench/families.py over its whole list
    t0 = time.perf_counter()
    rows = families.run()
    print(families.table(rows), flush=True)
    emit("families", rows=len(rows), card=rows[0][1],
         seconds=time.perf_counter() - t0)
    if len(rows) != len(families.DEFAULT_CONFIGS):
        raise AssertionError("a bench/families.py row did not run")
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    for k in ("layered_qc", "layered_exact", "flooding", "flooding_qc"):
        if launches[k] <= 0:
            raise AssertionError(f"the families' path never launched {k}")
    return dict(errs=errs, launches=launches, wide=wide)


def wide_rows_path(dev, ptxas: dict) -> dict:
    """Phase 30: rows of degree 80 and 96 (sc/2/80/6/32, sc/3/96/10/64)
    through the wide builds of K1a, K1c, K3 and, on their H loaded through
    mat:, K2, each case against its plain version to the existing rules;
    the wide legs timed on sc/3/96/10/64 with their plain time, plan and
    the wide instances' spill. Returns {"errs": largest error per
    kernels-line name, "wide": the entries with "width": "wide"}."""
    errs, lines = {}, []
    t0 = time.perf_counter()
    spill = {}
    for src in ("layered_qc", "layered_exact", "flooding_qc", "flooding"):
        fns = ptxas_wide(ptxas[src], 0)  # ct::kWide: the mangled "ILi0E"
        if not fns:
            raise AssertionError(f"{src}: no wide instance in the build")
        spill[src] = max(
            int(v.split(" bytes spill stores")[0].split()[-1])
            for v in fns.values())
        emit("wide_rows_ptxas", source=src, kernels=fns)
    tmp = tempfile.TemporaryDirectory()
    mats = {}
    for code, ebn0 in WIDE_ROW_CODES.items():
        for name, spec_str, B in WIDE_ROW_CASES:
            x = make_inputs(code, spec_str, B, ebn0, dev, seed=1)
            key, r = compare_spec(x.graph, x.llr, x.kw)
            note_compare(lines, errs, f"{key}:wide", "wide_rows_vs_plain",
                         code, name, spec_str, ebn0, r)
            del x
        mat = pathlib.Path(tmp.name) / f"{code.replace('/', '_')}.mat"
        mat.write_text(dumps_matlab_sparse(get_code(code)))
        mats[code] = f"mat:{mat}"
        for name, spec_str, B in WIDE_ROW_K2_CASES:
            # the codewords of the registered code (the loaded H is
            # rank-deficient: the load counts k as n - m)
            x = make_inputs(mats[code], spec_str, B, ebn0, dev, seed=1,
                            source=code)
            key, r = compare_spec(x.graph, x.llr, x.kw)
            note_compare(lines, errs, f"{key}:wide", "wide_rows_vs_plain",
                         mats[code], name, spec_str, ebn0, r)
            del x
    need_plan("flooding", lines, "the wide build",
              lambda r: r["plan"].get("width", 0) > 64)
    wide = []
    ebn0 = WIDE_ROW_CODES[WIDE_ROW_TIMED]
    for name, _, dec in WIDE_LEGS:
        src = name.split(":")[0]
        code = mats[WIDE_ROW_TIMED] if src == "flooding" else WIDE_ROW_TIMED
        wrapper = WRAPPERS[src]
        x = make_inputs(code, dec, WIDE_ROW_B, ebn0, dev, seed=0,
                        source=WIDE_ROW_TIMED)
        key, parity = compare_spec(x.graph, x.llr, x.kw)
        errs[f"{key}:wide"] = max(errs.get(f"{key}:wide", 0.0),
                                  parity["max_abs_err"])
        del x
        wrapper.launches = 0
        smi_before = smi_sample()
        res = run_benchmark(code=code, decoder=dec, batch=WIDE_ROW_B,
                            ebn0_db=ebn0, device=dev, source=WIDE_ROW_TIMED)
        launches = wrapper.launches
        plan = tile_line(wrapper, WIDE_ROW_B)["plan"]
        emit("wide_rows_bench", kernel=name, code=code, decoder=dec,
             plan=plan, plain_ms=parity["plain_ms"], spill_bytes_max=spill[src],
             **bench_line(res, launches, smi_before))
        if launches <= 0:
            raise AssertionError(f"{name} (wide) never launched")
        wide.append({
            "name": name, "width": "wide", "route": "cuda",
            "source": f"ecc_ldpc_tpu_torch/csrc/{src}.cu",
            "replaces": dict(
                layered_qc="ecc_ldpc_tpu/decode/pallas/layered_qc.py:146",
                layered_exact="ecc_ldpc_tpu/decode/pallas/layered_qc.py:501",
                flooding_qc="ecc_ldpc_tpu/decode/pallas/flooding_qc.py:85",
                flooding="ecc_ldpc_tpu/decode/pallas/fused_mm.py:151")[src],
            "launches": launches,
            "max_abs_err": errs.get(f"{name}:wide", 0.0),
            "ms": res.wall_s_per_batch * 1e3,
            "plain_ms": parity["plain_ms"],
            "bound_ms": res.bound_ms, "bound_by": res.roofline_form,
            "library_ms": None, "code": code, "batch": WIDE_ROW_B,
            "plan": plan, "spill_bytes_max": spill[src],
        })
    tmp.cleanup()
    emit("wide_rows", seconds=time.perf_counter() - t0)
    return dict(errs=errs, wide=wide)


class _Home:
    """HOME pointed at a fresh temporary directory while open, so that the
    G cache (~/.cache/ecc_ldpc_tpu_torch) starts empty."""

    def __enter__(self):
        self.tmp = tempfile.TemporaryDirectory()
        self.old = os.environ.get("HOME")
        os.environ["HOME"] = self.tmp.name
        return self.tmp.name

    def __exit__(self, *exc):
        if self.old is None:
            del os.environ["HOME"]
        else:
            os.environ["HOME"] = self.old
        self.tmp.cleanup()


def gcache_path(dev) -> dict:
    """Phase 31: ccsds/16384/45's generator built cold into an empty cache
    and again warm (host seconds, the file, G's bytes on the card), a batch
    encoded on the card with every syndrome zero, a noiseless batch decoded
    through K1b with no error, and a two-point sweep through K1b whose FER
    falls. Returns K1b's launches on this path."""
    from ecc_ldpc_tpu_torch.decode.layered_qc import (
        _plain_layers,
        _syndrome_fail_plain,
    )
    from ecc_ldpc_tpu_torch.encode import dense

    t0 = time.perf_counter()
    with _Home():
        spec = get_code(GCACHE_CODE)
        t1 = time.perf_counter()
        enc = dense.DenseEncoder.build(spec)
        cold = time.perf_counter() - t1
        path = pathlib.Path(dense.cache_path(spec))
        t1 = time.perf_counter()
        enc = dense.DenseEncoder.build(spec)
        warm = time.perf_counter() - t1
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        enc._tables(dev)
        g_bytes = torch.cuda.memory_allocated(dev) - before
        emit("gcache", code=GCACHE_CODE, cold_s=cold, warm_s=warm,
             file=path.name, file_bytes=path.stat().st_size,
             k=enc.k, n=enc.n, cells=spec.n * spec.m, g_hbm_bytes=g_bytes)
        if not path.exists() or warm >= cold:
            raise AssertionError("the G cache did not serve the warm build")
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        msg = torch.randint(0, 2, (GCACHE_B, enc.k), generator=gen,
                            device=dev, dtype=torch.uint8)
        cw = enc(msg)
        graph = choose_graph(spec, GCACHE_DECODER)
        fail = _syndrome_fail_plain(_plain_layers(graph, dev),
                                    (1.0 - 2.0 * cw.float()).t(), graph.Z)
        if bool(fail.any()) or not torch.equal(enc.extract_message(cw), msg):
            raise AssertionError("a ccsds/16384/45 codeword fails its checks")
        for w in WRAPPERS.values():
            w.launches = 0
        llr = make_channel(spec)(None, cw, 0.0,
                                 torch.zeros(cw.shape, device=dev)) * 10.0
        res = get_decoder(graph, GCACHE_DECODER, device=dev)(llr)
        if not (bool(res.ok.all()) and torch.equal(res.bits, cw)):
            raise AssertionError("K1b misses a noiseless ccsds/16384/45 frame")
        swept = run_sweep(SweepSpec(
            code=GCACHE_CODE, decoder=GCACHE_DECODER, ebn0_db=GCACHE_EBN0,
            batch=GCACHE_B, stopping=StoppingRule(
                min_frame_errors=10 ** 9, max_frames=GCACHE_FRAMES)),
            device=dev)
        launches = layered_classic_cuda.launches
        for pr in swept:
            emit("gcache_sweep", code=GCACHE_CODE, decoder=GCACHE_DECODER,
                 **point_line(pr))
        if launches <= 0 or any(w.launches for k, w in WRAPPERS.items()
                                if k != "layered_classic"):
            raise AssertionError("ccsds/16384/45 did not decode through K1b")
        if not swept[0].fer > swept[1].fer:
            raise AssertionError("the ccsds/16384/45 FER does not fall")
    emit("gcache", launches=launches, noiseless_frames=GCACHE_B,
         seconds=time.perf_counter() - t0)
    return {"layered_classic:minsum": launches}


def _event_ms(fn, reps: int = 5) -> float:
    """Median ms of fn() on the card by CUDA events, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def channels_path(dev) -> None:
    """Phase 32: every channel kind's LLRs on the card against the same
    channel on the CPU from the same draws (CHANNEL_RTOL/ATOL), each
    channel's ms a batch at dvbs2/16200/12, B = 4096, and the uncoded
    anchors through bpsk/N against their closed forms."""
    from ecc_ldpc_tpu_torch.chan.awgn import uncoded_bpsk_ber
    from ecc_ldpc_tpu_torch.chan.modem import (
        build_channel,
        uncoded_8psk_ber_approx,
        uncoded_rayleigh_ber,
    )
    from ecc_ldpc_tpu_torch.sim.stopping import wilson_interval

    t0 = time.perf_counter()
    code = get_code(CHANNEL_CODE)
    cpu = torch.device("cpu")
    for spec_str in CHANNEL_SPECS:
        ch = build_channel(code, spec_str)
        gen = torch.Generator().manual_seed(7)
        cw = torch.randint(0, 2, (CHANNEL_B, code.n), generator=gen,
                           dtype=torch.uint8)
        noise = ch.draw(gen, CHANNEL_B, cpu)
        want = ch(None, cw, CHANNEL_EBN0, noise)
        got = ch(None, cw.to(dev), CHANNEL_EBN0, noise.to(dev)).cpu()
        err = (got - want).abs().max().item()
        close = torch.allclose(got, want, rtol=CHANNEL_RTOL,
                               atol=CHANNEL_ATOL)
        gdev = torch.Generator(device=dev)
        gdev.manual_seed(8)
        big = torch.randint(0, 2, (CHANNEL_TIMED_B, code.n), generator=gdev,
                            device=dev, dtype=torch.uint8)
        z = ch.draw(gdev, CHANNEL_TIMED_B, dev)
        ms = _event_ms(lambda: ch(None, big, CHANNEL_EBN0, z))
        emit("channel_vs_cpu", channel=spec_str, code=CHANNEL_CODE,
             draws=ch.draws, count=ch.count, max_abs_err=err, close=close,
             ms=ms, timed_batch=CHANNEL_TIMED_B)
        del big, z
        if not close:
            raise AssertionError(f"{spec_str}: the card's LLRs differ from "
                                 f"the CPU's by {err}")
    theory = {"bpsk": uncoded_bpsk_ber, "8psk": uncoded_8psk_ber_approx,
              "rayleigh": uncoded_rayleigh_ber}
    for channel, ebn0, form, exact in ANCHORS:
        (pr,) = run_sweep(SweepSpec(
            code=f"bpsk/{ANCHOR_N}", decoder="none", ebn0_db=(ebn0,),
            batch=ANCHOR_FRAMES, channel=channel,
            stopping=StoppingRule(min_frame_errors=10 ** 9,
                                  max_frames=ANCHOR_FRAMES)), device=dev)
        want = float(theory[form](ebn0))
        bits = pr.frames * ANCHOR_N
        lo, hi = wilson_interval(pr.bit_errors, bits, ANCHOR_Z)
        ok = lo <= want <= hi if exact else 0.8 * want < pr.ber < 1.25 * want
        emit("uncoded_anchor", channel=channel, ebn0_db=ebn0, ber=pr.ber,
             ci=[lo, hi], theory=want, exact=exact, bits=bits)
        if not ok:
            raise AssertionError(f"uncoded {channel} at {ebn0} dB: BER "
                                 f"{pr.ber} against {want}")
    emit("channels", seconds=time.perf_counter() - t0)


def _curve_sweep(code, decoder, channel, ref, dev):
    """run_sweep of (code, decoder, channel) at each of ref's points and
    frame counts, in batches of MODEM_SWEEP_BATCH."""
    out = []
    for q in ref:
        (pr,) = run_sweep(SweepSpec(
            code=code, decoder=decoder, ebn0_db=(q.ebn0_db,),
            batch=MODEM_SWEEP_BATCH, channel=channel,
            stopping=StoppingRule(min_frame_errors=10 ** 9,
                                  max_frames=q.frames)), device=dev)
        out.append(pr)
    return out


def golden_overlap(swept, golden) -> bool:
    """The JAX package's golden gate (tests/ber/test_golden_gate.py
    fer_pt_ok) at every shared point: the FER CIs overlap, or, near
    saturation (golden FER >= 0.5), the FERs are within 1.25x, where the
    TPU's bf16 messages and the port's f32 ones legitimately disagree on
    which marginal frames converge within the iteration cap."""
    by = {round(q.ebn0_db, 6): q for q in golden}
    for m in swept:
        r = by[round(m.ebn0_db, 6)]
        lo, hi = m.fer_ci
        if r.fer_ci[1] < lo or hi < r.fer_ci[0]:
            if not (r.fer >= 0.5 and 0.8 <= m.fer / r.fer <= 1.25):
                return False
    return True


def saturated_point(dev) -> None:
    """Phase 33's last sweeps: dvbs2/16200/12 over BPSK at the golden's
    saturated 0.8 dB with SATURATED's frames, once a seed; each must
    overlap the JAX CPU reference there (curves_overlap), the golden's
    overlap printed beside it."""
    ebn0, frames, seeds, path = SATURATED
    code, decoder, channel, golden_path = MODEM_GOLDENS[2]
    (ref,) = [PointResult.from_json(d) for d in json.loads(path.read_text())]
    golden = [q for q in (PointResult.from_json(d) for d in
                          json.loads(golden_path.read_text()))
              if abs(q.ebn0_db - ebn0) < 1e-9]
    for seed in seeds:
        t1 = time.perf_counter()
        (pr,) = run_sweep(SweepSpec(
            code=code, decoder=decoder, ebn0_db=(ebn0,),
            batch=MODEM_SWEEP_BATCH, channel=channel, seed=seed,
            stopping=StoppingRule(min_frame_errors=10 ** 9,
                                  max_frames=frames)), device=dev)
        overlap = curves_overlap([pr], [ref], "fer")
        emit("modem_saturated", code=code, channel=channel, seed=seed,
             **point_line(pr), reference=path.name, reference_fer=ref.fer,
             reference_fer_ci=ref.fer_ci, reference_frames=ref.frames,
             overlap=overlap, golden_fer=golden[0].fer,
             golden_fer_ci=golden[0].fer_ci,
             golden_overlap=curves_overlap([pr], golden, "fer"),
             seconds=time.perf_counter() - t1)
        if not overlap:
            raise AssertionError(f"{code} at {ebn0} dB, seed {seed}, misses "
                                 f"{path.name}")


def modem_sweeps_path(dev) -> dict:
    """Phase 33: the APSK goldens and the BPSK golden of dvbs2/16200/12,
    each swept at its own points and frame counts and held to it by the
    JAX package's golden gate (golden_overlap; curves_overlap printed
    beside it), then the coded sweeps against the JAX CPU references by
    curves_overlap. Returns the launches of K1a and K2 on this path."""
    t0 = time.perf_counter()
    for w in WRAPPERS.values():
        w.launches = 0
    goldens = {path for *_, path in MODEM_GOLDENS}
    for code, decoder, channel, path in MODEM_GOLDENS + MODEM_REFERENCES:
        ref = [PointResult.from_json(d) for d in json.loads(path.read_text())]
        if any(q.channel != channel or q.code != code or q.decoder != decoder
               for q in ref):
            raise AssertionError(f"{path.name} is not {code} {decoder} "
                                 f"{channel}")
        t1 = time.perf_counter()
        swept = _curve_sweep(code, decoder, channel, ref, dev)
        overlap = curves_overlap(swept, ref, "fer")
        gate = golden_overlap(swept, ref) if path in goldens else overlap
        for pr, q in zip(swept, ref):
            emit("modem_vs_reference", code=code, decoder=decoder,
                 channel=channel, **point_line(pr), reference_fer=q.fer,
                 reference_fer_ci=q.fer_ci, reference_frames=q.frames)
        emit("modem_vs_reference", code=code, channel=channel,
             reference=path.name, overlap=overlap, gate=gate,
             seconds=time.perf_counter() - t1)
        if not gate:
            raise AssertionError(f"{code} over {channel} misses {path.name}")
    saturated_point(dev)
    launches = {"layered_qc": layered_decode_cuda.launches,
                "flooding:spa": flooding_decode_cuda.launches}
    emit("modem_sweeps", launches=launches, seconds=time.perf_counter() - t0)
    if min(launches.values()) <= 0:
        raise AssertionError(f"the modem sweeps missed a kernel: {launches}")
    return launches


def modem_dist_path(rank_out: pathlib.Path) -> int:
    """Phase 34: the sharded sweep over apsk16:r56:il
    (bench.SHARDED_MODEM_SWEEP) on meshes 1x1 and 2x1 through
    bench/sharded.py (one node; rank_jobs' lines in rank_out), and through
    the CLI on 2x1 with --channel on two nodes of one rank each
    (run_nodes: K5 through host memory only): the same counters
    everywhere, K5 launched on every rank of 2x1, each CLI rank's plan its
    own node. Returns rank 0's launches of K1a and K5 there."""
    from ecc_ldpc_tpu_torch.bench.throughput import SHARDED_MODEM_SWEEP as M

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    counters = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mesh in MODEM_MESHES:
            b, s = (int(x) for x in mesh.split("x"))
            lines = rank_lines(rank_out, f"sharded_{mesh}_modem", b * s)
            for line in lines:
                emit("modem_sharded", **line)
                if line["counters"] != lines[0]["counters"]:
                    raise AssertionError(f"{mesh}: ranks disagree")
                if b * s > 1 and line["launches"]["ring"] <= 0:
                    raise AssertionError(f"{mesh}: K5 never launched")
                one_node = node_plans(1, b * s)
                if b * s > 1 and line["plan"] != one_node[line["rank"]]:
                    raise AssertionError(f"{mesh}: not one node: "
                                         f"{line['plan']}")
            counters[mesh] = [{k: c[k] for k in SHARDED_COUNTERS}
                              for c in lines[0]["counters"]]
        launches = dict(lines[0]["launches"])
        out = pathlib.Path(tmp) / "modem_cli.json"
        launch = run_nodes(2, 1, [
            "ecc_ldpc_tpu_torch.cli", "sweep", "--code", M["code"],
            "--decoder", M["decoder"], "--channel", M["channel"],
            "--ebn0", ",".join(map(str, M["ebn0_db"])),
            "--batch", str(M["batch"]), "--mesh", "2x1",
            "--min-frame-errors", str(10 ** 9),
            "--max-frames", str(M["steps"] * M["batch"]),
            "--out", str(out)], 600)
        counters["cli_2x1"] = [
            {k: d[k] for k in SHARDED_COUNTERS}
            for d in json.loads(out.read_text())]
    cli_launches = check_node_launch(launch, 2, 1, "phase 34")
    launches["ring"] += cli_launches[0]
    emit("modem_sharded", channel=M["channel"], counters=counters,
         cli_plans=list(node_plans(2, 1).values()),
         cli_ring_launches=cli_launches,
         launches_rank0=launches, seconds=time.perf_counter() - t0)
    if not counters["1x1"] == counters["2x1"] == counters["cli_2x1"]:
        raise AssertionError(f"the modem sweep's counters depend on the "
                             f"mesh: {counters}")
    return launches


def _die_with_parent() -> None:
    """In a launcher of ranks, before it runs: SIGTERM when this script
    dies (PR_SET_PDEATHSIG), on which torch.distributed.run stops its
    ranks."""
    ctypes.CDLL(None).prctl(1, signal.SIGTERM, 0, 0, 0)


def _launch(cmds: list, what: str, timeout: float) -> str:
    """Start each command of `cmds` (torch.distributed.run agents) in a
    process group of its own, its output to a file; at the time limit
    each gets SIGTERM (on which it stops its ranks) and its group SIGKILL
    60 s later if it is still there; raises unless every one exits 0
    (which an agent does only when every rank does). Returns their
    outputs, one after another."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    with contextlib.ExitStack() as stack:
        logs = [stack.enter_context(tempfile.TemporaryFile("w+"))
                for _ in cmds]
        procs = [subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                  stderr=subprocess.STDOUT, text=True,
                                  process_group=0,
                                  preexec_fn=_die_with_parent)
                 for cmd, log in zip(cmds, logs)]
        end, late = time.monotonic() + timeout, False
        try:
            for proc in procs:
                proc.wait(timeout=max(end - time.monotonic(), 0.0))
        except subprocess.TimeoutExpired:
            late = True
            for proc in procs:
                proc.terminate()  # torch.distributed.run stops its ranks
            for proc in procs:
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
    out = "\n".join(outs)
    codes = [proc.returncode for proc in procs]
    if late:
        raise AssertionError(f"{what}: no end after {timeout} s\n"
                             f"{out[-4000:]}")
    if any(codes):
        raise AssertionError(f"{what}: exit {codes}\n{out[-4000:]}")
    return out


def run_ranks(nproc: int, args: list, timeout: float) -> str:
    """`python -m torch.distributed.run --standalone` with nproc ranks of
    the module args[0] (its arguments after it), under _launch. Returns
    its output."""
    return _launch([[sys.executable, "-m", "torch.distributed.run",
                     "--standalone", f"--nproc-per-node={nproc}", "-m",
                     *args]], f"{args[0]} on {nproc} ranks", timeout)


def free_port() -> int:
    """A TCP port of 127.0.0.1 that is free now."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_nodes(nnodes: int, nproc: int, args: list, timeout: float) -> str:
    """nnodes torch.distributed.run agents on this host, each a node of
    nproc ranks of the module args[0] (its arguments after it), meeting
    through a static rendezvous on 127.0.0.1 (--nnodes, --node-rank,
    --master-addr, --master-port; the launcher numbers the ranks node by
    node and tells each rank its node, GROUP_RANK), under _launch. Returns
    their outputs, node by node."""
    port = free_port()
    return _launch([[sys.executable, "-m", "torch.distributed.run",
                     f"--nnodes={nnodes}", f"--node-rank={i}",
                     f"--nproc-per-node={nproc}", "--master-addr=127.0.0.1",
                     f"--master-port={port}", "-m", *args]
                    for i in range(nnodes)],
                   f"{args[0]} on {nnodes} nodes x {nproc} ranks", timeout)


def node_plans(nnodes: int, nproc: int) -> dict:
    """rank -> the plan line (dist/ring.NodePlan.line) a Ring of every rank
    of nnodes x nproc ranks, numbered node by node, must state."""
    keys = [r // nproc for r in range(nnodes * nproc)]
    return {r: node_plan(keys, r).line() for r in range(len(keys))}


def check_node_launch(out: str, nnodes: int, nproc: int, what: str) -> dict:
    """From a two-node launch's output: every rank's Ring stated the plan
    its node and peers call for (node_plans) and no other, and every rank's
    Rings counted K5 launches at their close (Ring.launches, which only
    ring_allreduce_cuda adds to, where it launches). Returns {rank: K5
    launches}."""
    want = node_plans(nnodes, nproc)
    plans = set(re.findall(r"ring: rank \d+ D=\d+ node \d+/\d+ "
                           r"ipc=\[[\d,]*\] host=\[[\d,]*\]", out))
    if plans != set(want.values()):
        raise AssertionError(f"{what}: Ring plans {sorted(plans)}, asked "
                             f"for {sorted(want.values())}")
    launches = collections.Counter()
    for rank, n in re.findall(r"ring: rank (\d+) D=\d+ closed after (\d+) "
                              r"K5 launches", out):
        launches[int(rank)] += int(n)
    if sorted(launches) != sorted(want) or min(launches.values()) <= 0:
        raise AssertionError(f"{what}: K5 launches by rank {dict(launches)}")
    return dict(launches)


def rank_jobs(out: pathlib.Path) -> None:
    """The one-node rank programs of phases 23 (bench/ring.py), 24 and 34
    (bench/sharded.py) and 49 (bench/graph_parallel.py), RANK_JOBS, in one
    torch.distributed.run launch of RANK_JOBS_WORLD ranks
    (bench/ranks.py: one after another in the same processes and group,
    so the ranks start once), each rank writing its lines into `out`,
    where those phases read them."""
    torch.cuda.empty_cache()  # the ranks need the card's memory
    t0 = time.perf_counter()
    args = []
    for job, _ in RANK_JOBS.values():
        args += ["--", *(a.format(out=out) for a in job)]
    run_ranks(RANK_JOBS_WORLD, ["ecc_ldpc_tpu_torch.bench.ranks", *args[1:]],
              sum(limit for _, limit in RANK_JOBS.values()))
    emit("rank_jobs", jobs=list(RANK_JOBS), ranks=RANK_JOBS_WORLD,
         seconds=time.perf_counter() - t0)


def rank_lines(out_dir: pathlib.Path, stem: str, nproc: int) -> list:
    return [json.loads((out_dir / f"{stem}_rank{r}.json").read_text())
            for r in range(nproc)]


def ring_nodes_path() -> None:
    """Phase 23, across nodes: bench/ring.py --check on two nodes of two
    ranks each (run_nodes), on the groups RING_NODE_GROUPS: ranks 0 and 2,
    one a node (host memory only), and all four (CUDA IPC within a node,
    host memory across). Every case, f32 and int64, identical to the plain
    version and across ranks, 2 launches a call, and each rank's plan the
    one its nodes call for."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run_nodes(2, 2, ["ecc_ldpc_tpu_torch.bench.ring", tmp, "--ranks",
                         ",".join(RING_NODE_GROUPS), "--check"], 300)
        lines = rank_lines(pathlib.Path(tmp), "ring", 4)
    want = {(2, r): p for r, p in node_plans(2, 1).items()}
    want.update({(4, r): p for r, p in node_plans(2, 2).items()})
    for line in lines:
        seen = collections.Counter()
        for c in line["cases"]:
            emit("ring_across_nodes", rank=line["rank"], **c)
            group_rank = int(c["plan"].split()[2])
            if c["plan"] != want[c["D"], group_rank]:
                raise AssertionError(f"K5 across nodes: rank {line['rank']} "
                                     f"planned {c['plan']!r}")
            if not (c["identical_to_plain"] and c["ranks_identical"]
                    and c["launches"] == 2):
                raise AssertionError(f"K5 across nodes differs from its "
                                     f"plain version: rank {line['rank']}, "
                                     f"{c}")
            seen[c["D"], c["dtype"]] += 1
        groups = [2, 4] if line["rank"] in (0, 2) else [4]
        if sorted(seen) != sorted((D, t) for D in groups
                                  for t in ("float32", "int64")):
            raise AssertionError(f"K5 across nodes: rank {line['rank']} "
                                 f"ran {dict(seen)}")
    emit("ring_across_nodes", groups=list(RING_NODE_GROUPS),
         seconds=time.perf_counter() - t0)


def dist_path(dev, rank_out: pathlib.Path) -> list:
    """Phases 23-25: K5 on several ranks of the one card against its plain
    version, the sharded sweep at full width on three meshes (both from
    rank_jobs' lines in rank_out), and the CLI under
    torch.distributed.run; returns K5's entry of the kernels line."""
    torch.cuda.empty_cache()  # the ranks need the card's memory
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True)
    emit("ring_device", compute_mode=(mode.stdout or mode.stderr).strip())

    # 23. K5 against its plain version on D ranks of the card (rank_jobs:
    # 4 processes, a group of the first D for each D)
    ring_cases = {}
    t0 = time.perf_counter()
    lines = rank_lines(rank_out, "ring", RANK_JOBS_WORLD)
    for line in lines:
        for c in line["cases"]:
            if not (c["identical_to_plain"] and c["ranks_identical"]):
                raise AssertionError(f"K5 differs from its plain version "
                                     f"or across ranks: rank "
                                     f"{line['rank']}, {c}")
            if c["launches"] != 2:
                raise AssertionError(f"K5 launched {c['launches']} "
                                     f"kernels a call for D = {c['D']}")
    for D in RING_RANKS:
        ring_cases[D] = [c for c in lines[0]["cases"] if c["D"] == D]
        if len(ring_cases[D]) != len(RING_CASES):
            raise AssertionError(f"K5 at D = {D}: a case missing")
        for c in ring_cases[D]:
            emit("ring_vs_plain", **c)
        emit("ring_vs_plain", D=D, ranks=D, seconds=time.perf_counter() - t0)
    ring_nodes_path()

    # 24. the sharded sweep on each mesh, in rank_jobs' launch (a group of
    # the first B*S ranks for each); counts from each rank's own run
    sharded = {}
    sizes = {m: math.prod(int(x) for x in m.split("x"))
             for m in SHARDED_MESHES}
    every = {m: rank_lines(rank_out, f"sharded_{m}", D)
             for m, D in sizes.items()}
    emit("sharded_sweep", meshes=list(SHARDED_MESHES))
    for mesh, lines in every.items():
        b, s = (int(x) for x in mesh.split("x"))
        for line in lines:
            emit("sharded_sweep", **line)
            if line["counters"] != lines[0]["counters"]:
                raise AssertionError(f"{mesh}: ranks disagree on counters")
            if line["launches"]["layered_qc"] <= 0:
                raise AssertionError(f"{mesh} rank {line['rank']}: K1a never "
                                     f"launched")
            if b * s > 1 and line["launches"]["ring"] <= 0:
                raise AssertionError(f"{mesh} rank {line['rank']}: K5 never "
                                     f"launched")
            one_node = node_plans(1, b * s)
            if b * s > 1 and line["plan"] != one_node[line["rank"]]:
                raise AssertionError(f"{mesh}: not one node: {line['plan']}")
        emit("sharded_sweep", mesh=mesh, ranks=b * s,
             frames_per_s=lines[0]["frames_per_s"])
        sharded[mesh] = lines
    want = [{k: c[k] for k in SHARDED_COUNTERS}
            for c in sharded[SHARDED_MESHES[0]][0]["counters"]]
    for mesh, lines in sharded.items():
        got = [{k: c[k] for k in SHARDED_COUNTERS} for c in lines[0]["counters"]]
        if got != want:
            raise AssertionError(f"mesh {mesh} counters {got} != 1x1's {want}")
    frames = SHARDED_SWEEP["steps"] * SHARDED_SWEEP["batch"]
    if any(c["frames"] != frames for c in want):
        raise AssertionError(f"the sharded sweep ran {want}")
    # run_sweep (one process, a step-seeded stream) on the same points
    swept = run_sweep(SweepSpec(
        code=SHARDED_SWEEP["code"], decoder=SHARDED_SWEEP["decoder"],
        ebn0_db=SHARDED_SWEEP["ebn0_db"], batch=SHARDED_SWEEP["batch"],
        stopping=StoppingRule(min_frame_errors=10 ** 9, max_frames=frames)),
        device=dev)
    emit("sharded_sweep", run_sweep_frames_per_s=sum(
        pr.frames for pr in swept) / sum(pr.wall_s for pr in swept),
        run_sweep=[point_line(pr) for pr in swept])

    # 25. the entry point: the CLI's sweep on a 2x2 mesh of ranks on two
    # nodes of two ranks each (K5 through CUDA IPC and host memory)
    with open(GOLDEN) as f:
        golden = [PointResult.from_json(d) for d in json.load(f)]
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "sharded_cli.json"
        t0 = time.perf_counter()
        launch = run_nodes(*CLI_NODES, [
            "ecc_ldpc_tpu_torch.cli", "sweep", "--code", SHARDED_SWEEP["code"],
            "--decoder", SHARDED_SWEEP["decoder"],
            "--ebn0", ",".join(map(str, SHARDED_SWEEP["ebn0_db"])),
            "--batch", str(SHARDED_SWEEP["batch"]), "--mesh", CLI_MESH,
            "--min-frame-errors", "100", "--max-frames", str(CLI_MESH_FRAMES),
            "--out", str(out)], 900)
        wall = time.perf_counter() - t0
        cli = [PointResult.from_json(d) for d in json.loads(out.read_text())]
    cli_launches = check_node_launch(launch, *CLI_NODES, "phase 25")
    overlap = curves_overlap(cli, golden, "fer")
    for pr in cli:
        g = next(q for q in golden if abs(q.ebn0_db - pr.ebn0_db) < 1e-9)
        emit("sharded_cli", mesh=CLI_MESH, decoder=pr.decoder, **point_line(pr),
             golden_fer=g.fer, golden_fer_ci=g.fer_ci)
    emit("sharded_cli", mesh=CLI_MESH, nodes=CLI_NODES[0],
         ranks_a_node=CLI_NODES[1],
         plans=list(node_plans(*CLI_NODES).values()),
         ring_launches=cli_launches, overlap=overlap, seconds=wall)
    if not overlap:
        raise AssertionError("the sharded CLI sweep misses the golden curve")

    # K5's numbers at the main path's shape: the counters (int64 [2, 4]) on
    # the 2x2 mesh's 4 ranks; its launches are rank 0's in the 2x2 sweep
    # and in the CLI's two-node sweep
    (main_case,) = [c for c in ring_cases[4]
                    if c["case"] == "counters" and c["dtype"] == "int64"]
    return [{
        "name": "ring",
        "route": "cuda",
        "source": "ecc_ldpc_tpu_torch/csrc/ring.cu",
        "replaces": "ecc_ldpc_tpu/dist/ring.py:27",
        "launches": sharded["2x2"][0]["launches"]["ring"] + cli_launches[0],
        "max_abs_err": max(c["max_abs_err"] for cs in ring_cases.values()
                           for c in cs),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["gloo_all_reduce_ms"],
    }]


def precision_kwargs(precision) -> dict:
    """A kernel wrapper's msg_dtype / quant for a plain version's
    precision (decode/quant.py)."""
    if precision is None:
        return {}
    if precision == ("bf16",):
        return dict(msg_dtype=torch.bfloat16)
    if precision == ("bf16-perm",):
        return dict(perm_dtype=torch.bfloat16)
    return dict(quant=tuple(precision[1:]))


def with_precision(fn):
    """A with-posteriors kernel wrapper taking the plain version's
    `precision` argument, for compare_posteriors."""
    def run(graph, llr, precision=None, **kw):
        return fn(graph, llr, **kw, **precision_kwargs(precision))

    run.__name__ = fn.__name__
    return run


PRECISION_KERNELS = {
    "layered_qc": (with_precision(minsum_with_posteriors_cuda),
                   layered_decode_cuda),
    "layered_exact": (with_precision(exact_with_posteriors_cuda),
                      layered_exact_cuda),
    "layered_classic": (with_precision(classic_with_posteriors_cuda),
                        layered_classic_cuda),
}


def spec_precision(graph, kw):
    """The precision a parsed layered spec decodes with: q: from `quant`,
    /pallas the TPU kernel's storage (tpu_msg_dtype), else None."""
    if kw.get("quant"):
        return ("q", *kw["quant"])
    if kw.get("backend") == "pallas" and (
            tpu_msg_dtype(graph, kw.get("cn", "minsum")) == torch.bfloat16):
        return ("bf16",)
    return None


def layered_source(graph, cn: str):
    """(source, kernels-line name, the TPU function's line) of the layered
    kernel that decodes `graph` with rule `cn`."""
    if not graph.intra_layer_dup_free:
        return ("layered_classic", f"layered_classic:{cn}",
                "415" if cn == "minsum" else "630")
    if cn == "minsum":
        return "layered_qc", "layered_qc", "146"
    return "layered_exact", f"layered_exact:{cn}", "501"


def compare_precision(source: str, graph, llr, kw, precision) -> dict:
    """The layered kernel of csrc/<source>.cu with `precision` against
    the plain version with it: bits, ok and iterations identical, one
    sweep's posteriors within EXACT_MAX_ULPS, and min-sum's final ones
    identical. The line carries the plan and its precision."""
    kernel_fn, wrapper = PRECISION_KERNELS[source]
    cn = kw.get("cn", "minsum")
    dkw = dict(max_iters=kw.get("max_iters", 25),
               early_term=kw.get("early_term", True), cn=cn,
               precision=precision)
    if source != "layered_exact":
        dkw.update(alpha=kw.get("alpha", 1.0), beta=kw.get("beta", 0.0))
    return compare_posteriors(kernel_fn, plain_with_posteriors, graph, llr,
                              dkw, final_exact=cn == "minsum", tiles=wrapper)


def precision_kernels_path(dev) -> dict:
    """Phase 35: every precision kernel case (K1a roll and xor, K1c spa
    and minstar, K1b and K1c' spa; bf16, q:6:0.25 and q:4:1.0; fixed and
    track; 32 and 13 frames) and each K1a row width once under q:6:0.25
    against the plain versions on the card; then each timed leg of 36 at
    its own shape (one plain call's ms). Returns {"errs": the largest
    error per (kernels-line name, precision), "parity": the timed legs'
    compare lines}."""
    t0 = time.perf_counter()
    errs, lines = {}, []
    for name, code, rule, ebn0 in PRECISION_CASES:
        source = name.split(":")[0]
        for pname, precision in PRECISIONS.items():
            for mode in ("fixed", "track"):
                spec_str = f"{rule}/{PRECISION_T}" + (
                    "/noet" if mode == "fixed" else "")
                for B in PRECISION_FRAMES:
                    x = make_inputs(code, spec_str, B, ebn0, dev, seed=1)
                    r = compare_precision(source, x.graph, x.llr, x.kw,
                                          precision)
                    key = (name.replace(":xor", ""), pname)
                    errs[key] = max(errs.get(key, 0.0), r["max_abs_err"])
                    lines.append(r)
                    emit("precision_vs_plain", kernel=name, code=code,
                         precision=pname, decoder=spec_str, ebn0_db=ebn0,
                         **r)
                    del x
    for width, (code, ebn0) in PRECISION_WIDTHS.items():
        spec_str = f"layered/norm:0.8125/{PRECISION_T}"
        x = make_inputs(code, spec_str, 32, ebn0, dev, seed=1)
        r = compare_precision("layered_qc", x.graph, x.llr, x.kw,
                              PRECISIONS["q:6:0.25"])
        key = ("layered_qc", "q:6:0.25")
        errs[key] = max(errs.get(key, 0.0), r["max_abs_err"])
        emit("precision_vs_plain", kernel="layered_qc", width=width,
             code=code, precision="q:6:0.25", decoder=spec_str, **r)
        del x
    parity = {}
    for leg, cfg in PRECISION_LEGS.items():
        x = make_inputs(**cfg, device=dev, seed=0)
        precision = spec_precision(x.graph, x.kw)
        if precision is None:
            raise AssertionError(f"{leg}: {cfg['decoder']} stores f32")
        source = layered_source(x.graph, x.kw.get("cn", "minsum"))[0]
        parity[leg] = r = compare_precision(source, x.graph, x.llr, x.kw,
                                            precision)
        lines.append(r)
        emit("precision_vs_plain", kernel=source, case=f"{leg}_bench_shape",
             decoder=cfg["decoder"], **r)
        del x
    check_plans("precision", lines)
    emit("precision_kernels", seconds=time.perf_counter() - t0,
         cases=len(lines) + len(PRECISION_WIDTHS))
    return dict(errs=errs, parity=parity)


def instance_ptxas(report: str) -> dict:
    """{kernel instance: "registers, spill" line} of a ptxas -v report."""
    out, fn = {}, None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif fn and ("spill stores" in ln or "registers" in ln):
            out[fn] = (out.get(fn, "") + " " + ln.strip()).strip()
    return out


def precision_timed_path(dev, ptxas: dict, parity: dict, errs: dict) -> list:
    """Phase 36: PRECISION_LEGS through run_benchmark (dvbs2/64800/12,
    B = 4096, 1.5 dB, 25 fixed iterations): ms, launches, bound, one plain
    call's ms, FER <= 0.01; and the registers and spill of every instance
    of the layered sources' f32 and precision libraries. Returns the
    kernels-line entries, one per (kernel, precision)."""
    for lib, (src, _) in _build.LIBRARIES.items():
        if src not in ("layered_qc", "layered_exact", "layered_classic"):
            continue
        fns = instance_ptxas(ptxas[lib])
        emit("precision_ptxas", library=lib, instances=len(fns),
             max_spill_stores=max(
                 int(v.split(" bytes spill stores")[0].split()[-1])
                 for v in fns.values()), kernels=fns)
    out = []
    for leg, cfg in PRECISION_LEGS.items():
        cn = parse_decoder_spec(cfg["decoder"]).get("cn", "minsum")
        graph = choose_graph(get_code(cfg["code"]), cfg["decoder"])
        src, name, line = layered_source(graph, cn)
        wrapper = WRAPPERS[src]
        fer_max = (EXACT_FER_MAX if graph.intra_layer_dup_free
                   else CCSDS_FER_MAX)
        before = wrapper.launches
        smi_before = smi_sample()
        res = run_benchmark(**cfg, device=dev)
        launches = wrapper.launches - before
        plan = tile_line(wrapper, res.batch)["plan"]
        pname = plan["precision"]
        fer = res.frame_errors / res.batch
        emit("precision_bench", leg=leg, kernel=name, decoder=cfg["decoder"],
             plan=plan, plain_ms=parity[leg]["plain_ms"],
             **bench_line(res, launches, smi_before))
        if launches <= 0 or pname == "f32":
            raise AssertionError(f"{leg}: no {pname} launch of {name}")
        if not fer <= fer_max:
            raise AssertionError(f"{leg}: FER {fer} above {fer_max}")
        out.append({
            "name": name, "precision": pname, "route": "cuda",
            "source": f"ecc_ldpc_tpu_torch/csrc/{src}.cu",
            "replaces": f"ecc_ldpc_tpu/decode/pallas/layered_qc.py:{line}",
            "launches": launches,
            "max_abs_err": max(errs.get((name, pname), 0.0),
                               parity[leg]["max_abs_err"]),
            "ms": res.wall_s_per_batch * 1e3,
            "plain_ms": parity[leg]["plain_ms"],
            "bound_ms": res.bound_ms, "bound_by": res.roofline_form,
            "library_ms": None, "code": res.code, "batch": res.batch,
            "plan": plan,
        })
    return out


def precision_curves_path(dev, f32_golden_run: list) -> None:
    """Phase 37: layered/norm:0.8125/25 with backend "pallas" (bf16 on
    dvbs2/64800/12) at the golden's points 0.95-1.1 dB must overlap the
    golden it made, with phase 8's f32 run printed beside it; on
    80211n/1944/12 at its golden's steepest point, 16384 frames, q:6:0.25
    within 4x float (or 1e-3) and q:3:1.0 above 10x q:6:0.25; one point of
    the same bf16 sweep through the CLI's --backend pallas."""
    t0 = time.perf_counter()
    with open(GOLDEN) as f:
        golden = [PointResult.from_json(d) for d in json.load(f)]
    before = layered_decode_cuda.launches_by_precision["bf16"]
    swept = run_sweep(SweepSpec(
        code="dvbs2/64800/12", decoder=SWEEP_DECODER,
        ebn0_db=PRECISION_GOLDEN_EBN0, batch=2048, backend="pallas",
        stopping=StoppingRule(min_frame_errors=100, max_frames=32768)),
        device=dev)
    bf16_launches = layered_decode_cuda.launches_by_precision["bf16"] - before
    overlap = curves_overlap(swept, golden, "fer")
    f32 = {round(p.ebn0_db, 6): p for p in f32_golden_run}
    for pr in swept:
        g = next(q for q in golden if abs(q.ebn0_db - pr.ebn0_db) < 1e-9)
        f = f32.get(round(pr.ebn0_db, 6))
        emit("bf16_vs_golden", decoder=SWEEP_DECODER, backend="pallas",
             **point_line(pr), golden_fer=g.fer, golden_fer_ci=g.fer_ci,
             f32_fer=f.fer if f else None, f32_fer_ci=f.fer_ci if f else None)
    emit("bf16_vs_golden", overlap=overlap, bf16_launches=bf16_launches)
    if bf16_launches <= 0:
        raise AssertionError("the pallas sweep never stored bf16 messages")
    if not overlap:
        raise AssertionError("the bf16 sweep misses the golden it made")
    # the q: ordering at the steepest point of the 80211n/1944/12 golden
    with open(QUANT_ORDER_GOLDEN) as f:
        pts = sorted((PointResult.from_json(d) for d in json.load(f)),
                     key=lambda p: p.ebn0_db)
    drops = [np.log10(a.fer / max(b.fer, 1e-12)) / (b.ebn0_db - a.ebn0_db)
             for a, b in zip(pts, pts[1:])]
    ebn0 = pts[int(np.argmax(drops))].ebn0_db
    fers = {}
    for dec in QUANT_ORDER_DECODERS:
        (pr,) = run_sweep(SweepSpec(
            code=QUANT_ORDER_CODE, decoder=dec, ebn0_db=(ebn0,), batch=4096,
            stopping=StoppingRule(min_frame_errors=10 ** 9,
                                  max_frames=QUANT_ORDER_FRAMES)), device=dev)
        fers[dec] = pr.fer
        emit("quant_ordering", code=QUANT_ORDER_CODE, **point_line(pr),
             decoder=dec)
    f_float, f_q6, f_q3 = (fers[d] for d in QUANT_ORDER_DECODERS)
    if not f_q6 <= 4 * max(f_float, 1e-3):
        raise AssertionError(f"q:6:0.25 FER {f_q6} above 4x float {f_float}")
    if not f_q3 > 10 * f_q6:
        raise AssertionError(f"q:3:1.0 FER {f_q3} not above 10x {f_q6}")
    # one point through the CLI's --backend pallas
    before = layered_decode_cuda.launches_by_precision["bf16"]
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "bf16.json"
        rc = cli_main([
            "sweep", "--code", "dvbs2/64800/12", "--decoder", SWEEP_DECODER,
            "--backend", "pallas", "--ebn0", str(PRECISION_CLI_EBN0),
            "--batch", "2048", "--min-frame-errors", "1000000",
            "--max-frames", str(PRECISION_CLI_FRAMES), "--out", str(out)])
        (pr,) = [PointResult.from_json(d) for d in json.loads(out.read_text())]
    launches = layered_decode_cuda.launches_by_precision["bf16"] - before
    overlap = curves_overlap([pr], golden, "fer")
    emit("bf16_cli", rc=rc, **point_line(pr), bf16_launches=launches,
         overlap=overlap, seconds=time.perf_counter() - t0)
    if rc != 0 or launches <= 0 or not overlap:
        raise AssertionError(f"the CLI's --backend pallas point: rc {rc}, "
                             f"{launches} bf16 launches, overlap {overlap}")


def bitflip_path(dev) -> None:
    """Phase 38a: bitflip/50 and gdbf/theta:-0.5/50 over the hard channel
    at BITFLIP_B frames, card against CPU on the same LLRs (majority
    flipping identical; GDBF identical but for frames whose metric came
    within GDBF_NEAR_THETA of theta), the card's ms, FER falling with
    Eb/N0."""
    from ecc_ldpc_tpu_torch.decode.bitflip import decode_bitflip

    for code, dec in BITFLIP_CASES:
        kw = parse_decoder_spec(dec)
        variant = "maj" if kw["kind"] == "bitflip" else "gdbf"
        args = dict(variant=variant, theta=kw.get("theta", 0.0),
                    max_iters=kw["max_iters"],
                    early_term=kw.get("early_term", True))
        graph = choose_graph(get_code(code), dec)
        fers = []
        for pi, ebn0 in enumerate(BITFLIP_EBN0):
            spec = SweepSpec(code=code, decoder=dec, ebn0_db=(ebn0,),
                             batch=BITFLIP_B, channel="hard")
            pipe = Pipeline.build(spec, dev)
            gen = torch.Generator(device=dev)
            gen.manual_seed(step_seed(spec.seed, 0, pi, 0))
            msg, llr = pipe.frames(gen, ebn0)
            decode_bitflip(graph, llr, **args)  # warm-up
            card, ms = timed(decode_bitflip, graph, llr, **args)
            cpu, margin = decode_bitflip(graph, llr.cpu(), margin=True,
                                         **args)
            same = ((card.bits.cpu() == cpu.bits).all(1)
                    & (card.ok.cpu() == cpu.ok)
                    & (card.iterations.cpu() == cpu.iterations))
            differ = torch.nonzero(~same).squeeze(1).tolist()
            near = torch.nonzero(margin < GDBF_NEAR_THETA).squeeze(1).tolist()
            msg_hat = message_of(code, card.bits)
            fer = float((msg_hat != msg).any(1).float().mean())
            fers.append(fer)
            emit("bitflip", code=code, decoder=dec, ebn0_db=ebn0,
                 channel="hard", frames=BITFLIP_B, ms=ms, fer=fer,
                 ok_frames=int(card.ok.sum()),
                 mean_iters=card.iterations.float().mean().item(),
                 frames_differing=differ, frames_near_theta=near)
            if variant == "maj" and differ:
                raise AssertionError(f"{dec}: card and CPU differ on "
                                     f"frames {differ}")
            if not set(differ) <= set(near):
                raise AssertionError(f"{dec}: frames {differ} differ, only "
                                     f"{near} come near theta")
        if not fers[1] < fers[0]:
            raise AssertionError(f"{code} {dec}: FER {fers} does not fall")


def message_of(code: str, bits):
    """The message bits a decoded batch of `code` carries (its encoder's
    extract_message)."""
    from ecc_ldpc_tpu_torch.bench.throughput import _encoder

    return _encoder(code).extract_message(bits)


def cleanup_path(dev) -> None:
    """Phase 38b: CLEANUP_DECODER with and without /cleanup through the
    CLI on the same draws; the same batches regenerated: the cleanup's FER
    no higher than the decoder's but for frames it made wrong (counted);
    card against CPU on the failed rows of a batch at CLEANUP_HARD_EBN0."""
    from ecc_ldpc_tpu_torch.decode.cleanup import bitflip_cleanup

    t0 = time.perf_counter()
    points = {}
    for dec in (CLEANUP_DECODER, CLEANUP_DECODER + "/cleanup"):
        with tempfile.TemporaryDirectory() as tmp:
            out = pathlib.Path(tmp) / "cleanup.json"
            rc = cli_main([
                "sweep", "--code", CLEANUP_CODE, "--decoder", dec,
                "--ebn0", str(CLEANUP_EBN0), "--batch", str(CLEANUP_BATCH),
                "--min-frame-errors", "1000000",
                "--max-frames", str(CLEANUP_FRAMES), "--out", str(out)])
            (points[dec],) = [PointResult.from_json(d)
                              for d in json.loads(out.read_text())]
        if rc != 0:
            raise AssertionError(f"{dec}: the CLI exits {rc}")
        emit("cleanup_cli", decoder=dec, **point_line(points[dec]))
    spec = SweepSpec(code=CLEANUP_CODE, decoder=CLEANUP_DECODER,
                     ebn0_db=(CLEANUP_EBN0,), batch=CLEANUP_BATCH)
    pipe = Pipeline.build(spec, dev)
    graph = choose_graph(get_code(CLEANUP_CODE), CLEANUP_DECODER)
    dec = get_decoder(graph, CLEANUP_DECODER, device=dev)
    counts = dict(wrong=0, wrong_after=0, made_wrong=0, repaired=0,
                  failed_rows=0)
    for step in range(CLEANUP_FRAMES // CLEANUP_BATCH):
        gen = torch.Generator(device=dev)
        gen.manual_seed(step_seed(spec.seed, 0, 0, step))
        msg, llr = pipe.frames(gen, CLEANUP_EBN0)
        res = dec(llr)
        bits, _ = bitflip_cleanup(graph, res.bits)
        before_w = (message_of(CLEANUP_CODE, res.bits)
                    != msg).any(1)
        after_w = (message_of(CLEANUP_CODE, bits)
                   != msg).any(1)
        counts["wrong"] += int(before_w.sum())
        counts["wrong_after"] += int(after_w.sum())
        counts["made_wrong"] += int((after_w & ~before_w).sum())
        counts["repaired"] += int((before_w & ~after_w).sum())
        counts["failed_rows"] += int((~res.ok).sum())
    plain, clean = points[CLEANUP_DECODER], points[CLEANUP_DECODER + "/cleanup"]
    emit("cleanup", ebn0_db=CLEANUP_EBN0, frames=CLEANUP_FRAMES, **counts,
         cli_frame_errors=plain.frame_errors,
         cli_cleanup_frame_errors=clean.frame_errors)
    if (counts["wrong"], counts["wrong_after"]) != (plain.frame_errors,
                                                    clean.frame_errors):
        raise AssertionError("the regenerated batches do not give the CLI's "
                             "counts")
    if not clean.frame_errors <= plain.frame_errors + counts["made_wrong"]:
        raise AssertionError("the cleanup raised the FER beyond the frames "
                             "it made wrong")
    # card against CPU on a batch where many rows fail
    gen = torch.Generator(device=dev)
    gen.manual_seed(step_seed(spec.seed, 0, 1, 0))
    _, llr = pipe.frames(gen, CLEANUP_HARD_EBN0)
    res = dec(llr)
    failed = torch.nonzero(~res.ok).squeeze(1)
    rows = res.bits.index_select(0, failed)
    card_bits, card_ok = bitflip_cleanup(graph, rows)
    cpu_bits, cpu_ok = bitflip_cleanup(graph, rows.cpu())
    same = (torch.equal(card_bits.cpu(), cpu_bits)
            and torch.equal(card_ok.cpu(), cpu_ok))
    emit("cleanup_vs_cpu", ebn0_db=CLEANUP_HARD_EBN0, failed_rows=len(failed),
         repaired_rows=int(card_ok.sum()), same=same,
         bits_flipped=int((card_bits != rows).sum()),
         seconds=time.perf_counter() - t0)
    if len(failed) == 0 or not same:
        raise AssertionError(f"cleanup card vs CPU: {len(failed)} failed "
                             f"rows, identical {same}")


def crc_ref_batch(bits: np.ndarray, name: str) -> np.ndarray:
    """The bit-serial long division of codes/crc.crc_bits_ref, one
    register a row, stepped over every row together: uint8 [B, r]."""
    from ecc_ldpc_tpu_torch.codes.crc import POLYNOMIALS

    r, poly = POLYNOMIALS[name]
    top, reg = 1 << r, np.zeros(len(bits), np.int64)
    for col in np.concatenate([bits.astype(np.int64).T,
                               np.zeros((r, len(bits)), np.int64)]):
        reg = (reg << 1) | col
        reg = np.where(reg & top, reg ^ (top | poly), reg)
    return np.stack([(reg >> (r - 1 - i)) & 1 for i in range(r)],
                    1).astype(np.uint8)


def crc_path(dev) -> None:
    """Phase 38c: with_crc(build_ecc(CRC_CODE), CRC_NAME): CRC_B payloads
    encoded and decoded on the card; the CRC of every decoded message
    equal to the bit-serial reference's, and ok = syndrome AND CRC."""
    from ecc_ldpc_tpu_torch.codes.crc import crc_bits_ref, make_crc, with_crc
    from ecc_ldpc_tpu_torch.ecc import build_ecc

    ecc = build_ecc(CRC_CODE, CRC_DECODER, device=dev)
    wrapped = with_crc(ecc, CRC_NAME)
    gen = torch.Generator(device=dev)
    gen.manual_seed(38)
    payload = torch.randint(0, 2, (CRC_B, wrapped.k_payload), generator=gen,
                            device=dev, dtype=torch.uint8)
    cw = wrapped.encode(payload)
    llr = wrapped.transmit(gen, cw, CRC_EBN0)
    res = wrapped.decode(llr)
    inner = ecc.decode(llr)
    msg_crc = ecc.extract_message(res.bits)
    _, check = make_crc(CRC_NAME, wrapped.k_payload, dev)
    card_check = check(msg_crc).cpu().numpy()
    host = msg_crc.cpu().numpy()
    k = wrapped.k_payload
    ref = crc_ref_batch(host[:, :k], CRC_NAME)
    for i in range(4):  # the batched register is crc_bits_ref's division
        if not np.array_equal(ref[i], crc_bits_ref(host[i, :k], CRC_NAME)):
            raise AssertionError("the batched reference differs")
    ref_check = (ref == host[:, k:]).all(1)
    ok_rule = torch.equal(res.ok, inner.ok & check(msg_crc))
    payload_ok = (wrapped.extract_payload(res.bits) == payload).all(1)
    emit("crc", code=CRC_CODE, crc=CRC_NAME, frames=CRC_B, ebn0_db=CRC_EBN0,
         syndrome_ok=int(inner.ok.sum()), crc_ok=int(card_check.sum()),
         ok=int(res.ok.sum()), payload_ok=int(payload_ok.sum()),
         crc_equals_reference=bool(np.array_equal(card_check, ref_check)),
         ok_is_syndrome_and_crc=ok_rule)
    if not np.array_equal(card_check, ref_check) or not ok_rule:
        raise AssertionError("the CRC check differs from the bit-serial "
                             "reference, or ok is not syndrome AND CRC")
    if not 0 < int(res.ok.sum()) < CRC_B:
        raise AssertionError("the CRC batch decodes all frames or none")


def run_cli(argv: list) -> tuple:
    """(exit code, standard output lines, seconds) of one CLI call in this
    process (the kernels' counters see its launches)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    return rc, buf.getvalue().splitlines(), time.perf_counter() - t0


def learn_path(dev) -> dict:
    """Phase 39: `cli learn` at full width on the card (dvbs2/64800/12, T =
    25, batch 16, the production schedule's band): seconds a step, peak
    memory above what was allocated before it, the loss finite and the
    parameters in the clip region; on the first training batch the twin's
    final hard decisions against the plain layered decoder with count
    signs; the trained schedule through K1a (make_decoder, 25 iterations,
    no early termination) against its plain version on
    LEARN_DECODE_FRAMES frames. K1a's launches in the phase."""
    from ecc_ldpc_tpu_torch.decode.api import make_decoder
    from ecc_ldpc_tpu_torch.decode.layered_qc import layered_decode_plain
    from ecc_ldpc_tpu_torch.learn import load_schedule, unrolled_posteriors
    from ecc_ldpc_tpu_torch.learn.noms import (
        ALPHA_MAX,
        ALPHA_MIN,
        training_batch,
    )

    layered_decode_cuda.launches = 0
    out = ROOT / "build" / "learned_dvbs2_64800_12_T25.json"
    out.parent.mkdir(exist_ok=True)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    # what earlier phases left allocated counts in the peak; the training's
    # own peak is the rise above it
    base = torch.cuda.memory_allocated(dev)
    rc, lines, wall = run_cli(["learn", "--code", LEARN_CODE, *LEARN_ARGS,
                               "--out", str(out), "-v"])
    peak = torch.cuda.max_memory_allocated(dev) - base
    steps = [ln.split() for ln in lines if ln.startswith("  step ")]
    step_s = [float(w[-2]) for w in steps]
    losses = [float(w[3].rstrip(",")) for w in steps]
    d = json.loads(out.read_text())
    params = load_schedule(str(out))
    a, b = params.alphas, params.betas
    in_region = bool(np.all(a >= ALPHA_MIN) and np.all(a <= ALPHA_MAX)
                     and np.all(b >= 0.0))
    emit("learn", rc=rc, code=LEARN_CODE, args=LEARN_ARGS, seconds=wall,
         step_s=step_s, losses=losses, peak_bytes=peak,
         peak_gib=peak / 2**30, allocated_before_bytes=base,
         alphas=d["alphas"], betas=d["betas"],
         in_clip_region=in_region, out=lines[-2:])
    if rc != 0 or len(losses) != 3 or not np.all(np.isfinite(losses)):
        raise AssertionError(f"learn: rc {rc}, losses {losses}")
    if not in_region:
        raise AssertionError("learn: a parameter left the clip region")

    spec = get_code(LEARN_CODE)
    graph = compile_qc_graph(spec)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    _, cw, llr = training_batch(gen, build_encoder(spec), spec.k, spec.rate,
                                16, LEARN_BAND, dev)
    with torch.no_grad():
        post, twin_ms = timed(unrolled_posteriors, graph, llr, a, b,
                              remat=False)
    (plain, ptot), plain_ms = timed(plain_with_posteriors, graph, llr,
                                    alpha=a, beta=b, max_iters=params.iters,
                                    early_term=False, sign_mode="count")
    twin_bits = (post[-1] < 0).to(torch.uint8)
    same_bits = torch.equal(twin_bits, plain.bits)
    emit("learn_twin_vs_plain", frames=16, twin_ms=twin_ms,
         plain_ms=plain_ms, bits_identical=same_bits,
         posteriors_identical=same_floats(post[-1], ptot),
         max_abs_err=(post[-1] - ptot).abs().max().item(),
         frame_errors=int((plain.bits != cw).any(1).sum()))
    if not same_bits:
        raise AssertionError("the twin's hard decisions differ from the "
                             "plain decoder's with count signs")

    x = make_inputs(LEARN_CODE, BENCH_DECODER, LEARN_DECODE_FRAMES,
                    LEARN_DECODE_EBN0, dev, seed=39)
    dec = make_decoder(graph, "layered", alpha=a, beta=b,
                       max_iters=params.iters, early_term=False, device=dev)
    kern, kern_ms = timed(dec, x.llr)
    plain, plain_ms = timed(layered_decode_plain, graph, x.llr, alpha=a,
                            beta=b, max_iters=params.iters,
                            early_term=False)
    same = (torch.equal(kern.bits, plain.bits)
            and torch.equal(kern.ok, plain.ok)
            and torch.equal(kern.iterations, plain.iterations))
    errors, cw_errors = x.frame_errors(kern.bits)
    launches = layered_decode_cuda.launches
    emit("learn_schedule_k1a", frames=LEARN_DECODE_FRAMES,
         ebn0_db=LEARN_DECODE_EBN0, kernel_ms=kern_ms, plain_ms=plain_ms,
         identical=same, frame_errors=errors,
         codeword_frame_errors=cw_errors, launches=launches)
    if not same:
        raise AssertionError("K1a and its plain version differ on the "
                             "trained schedule")
    if launches <= 0:
        raise AssertionError("the trained schedule never launched K1a")
    return {"layered_qc": launches}


def findsnr_path(dev) -> dict:
    """Phase 40: `cli findsnr` on the golden's decoder at FER 1e-2; the
    answer inside FINDSNR_BAND. K1a's launches in the phase."""
    layered_decode_cuda.launches = 0
    rc, lines, wall = run_cli(["findsnr", *FINDSNR_ARGS])
    op = json.loads(lines[-1])
    probes = [ln.strip() for ln in lines if ln.startswith("  probe ")]
    launches = layered_decode_cuda.launches
    emit("findsnr", rc=rc, seconds=wall, probes=probes, result=op,
         band=FINDSNR_BAND, launches=launches)
    lo, hi = FINDSNR_BAND
    if rc != 0 or not lo <= op["ebn0_db"] <= hi:
        raise AssertionError(f"findsnr: rc {rc}, {op['ebn0_db']} dB outside "
                             f"{FINDSNR_BAND}")
    if launches <= 0:
        raise AssertionError("findsnr never launched K1a")
    return {"layered_qc": launches}


def trap_path(dev) -> dict:
    """Phase 41: harvest() of each TRAP_CASES case on the card, summary
    printed; the histogram total equal to the frames whose bits differ from
    the codeword, counted again on the device on the same frames
    (harvest_batch); every stored failure's b equal to the weight of H e
    computed on the device; the CLI's `trap --out` report equal to the
    library's. K1a's and K2's launches in the harvests."""
    from ecc_ldpc_tpu_torch.ecc import build_ecc
    from ecc_ldpc_tpu_torch.sim.microscope import harvest, harvest_batch

    added = collections.Counter()
    for code, decoder, ebn0, frames, batch in TRAP_CASES:
        layered_decode_cuda.launches = 0
        flooding_decode_cuda.launches = 0
        t0 = time.perf_counter()
        rep = harvest(code, decoder, ebn0_db=ebn0, frames=frames,
                      batch=batch, seed=TRAP_SEED, device=dev)
        wall = time.perf_counter() - t0
        launches = {"layered_qc": layered_decode_cuda.launches,
                    "flooding:minsum": flooding_decode_cuda.launches}
        added.update(launches)
        ecc = build_ecc(code, decoder, device=dev)
        failed, step = 0, 0
        for start in range(0, frames, batch):
            b = min(batch, frames - start)
            cw, llr = harvest_batch(ecc, TRAP_SEED, step, b, ebn0, dev)
            failed += int((ecc.decode(llr).bits != cw).any(1).sum().item())
            step += 1
        rows = torch.as_tensor(np.concatenate(
            [np.full(len(r), i) for i, r in enumerate(ecc.spec.row_cols)]),
            device=dev)
        cols = torch.as_tensor(np.concatenate(ecc.spec.row_cols),
                               dtype=torch.long, device=dev)
        e = torch.zeros((len(rep.failures), ecc.n), dtype=torch.int32,
                        device=dev)
        for i, f in enumerate(rep.failures):
            e[i, list(f.vn_set)] = 1
        synd = torch.zeros((len(rep.failures), ecc.spec.m), dtype=torch.int32,
                           device=dev).index_add_(1, rows, e[:, cols])
        b_card = (synd % 2).sum(1).tolist()
        b_ok = b_card == [f.b for f in rep.failures]
        total = sum(rep.histogram.values())
        with tempfile.TemporaryDirectory() as tmp:
            path = pathlib.Path(tmp) / "trap.json"
            rc, lines, cli_s = run_cli([
                "trap", "--code", code, "--decoder", decoder, "--ebn0",
                str(ebn0), "--frames", str(frames), "--batch", str(batch),
                "--seed", str(TRAP_SEED), "--out", str(path)])
            cli_json = json.loads(path.read_text())
        emit("trap", code=code, decoder=decoder, ebn0_db=ebn0, frames=frames,
             seconds=wall, frames_per_s=frames / wall,
             summary=rep.summary().splitlines(), histogram_total=total,
             failed_on_card=failed, stored=len(rep.failures),
             b_equals_card_syndrome=b_ok, launches=launches, cli_rc=rc,
             cli_seconds=cli_s,
             cli_equals_library=cli_json == json.loads(json.dumps(
                 rep.to_json())))
        if total != failed or not failed:
            raise AssertionError(f"trap {code}: histogram total {total}, "
                                 f"{failed} failed frames on the card")
        if not b_ok:
            raise AssertionError(f"trap {code}: a failure's b differs from "
                                 f"its syndrome weight on the card")
        if rc != 0 or cli_json != json.loads(json.dumps(rep.to_json())):
            raise AssertionError(f"trap {code}: the CLI's report differs")
        if sum(launches.values()) <= 0:
            raise AssertionError(f"trap {code}: no kernel launched")
    return dict(added)


def trace_names(prof: pathlib.Path, name: str) -> list:
    """The Chrome traces in prof whose events include a kernel named
    `name`."""
    hits = []
    for path in sorted(prof.glob("trace_*.json")):
        events = json.loads(path.read_text()).get("traceEvents", [])
        if any(name in str(ev.get("name", "")) for ev in events):
            hits.append(path.name)
    return hits


def bench_path(dev) -> dict:
    """Phase 42: `cli bench` (decode only, the headline's code and decoder
    at 4096 frames, with --profile-dir), --pipeline and --ab (two arms) at
    1024 frames, bench.scaling over the host's cards, and `cli sweep
    --profile-dir`: each JSON line printed, each trace naming K1a's
    kernel. K1a's and K2's launches in the phase."""
    from ecc_ldpc_tpu_torch.bench.scaling import run_scaling

    layered_decode_cuda.launches = 0
    flooding_decode_cuda.launches = 0
    base = ["--code", BENCH_CODE]
    lines_out = {}
    with tempfile.TemporaryDirectory() as tmp:
        prof_bench = pathlib.Path(tmp) / "bench"
        prof_sweep = pathlib.Path(tmp) / "sweep"
        runs = {
            "bench": ["bench", *base, "--decoder", BENCH_DECODER, "--batch",
                      "4096", "--profile-dir", str(prof_bench)],
            "pipeline": ["bench", "--pipeline", *base, "--decoder",
                         BENCH_DECODER, "--batch", "1024"],
            "ab": ["bench", "--ab", *base, "--batch", "1024",
                   *[a for d in BENCH_AB_DECODERS for a in ("--decoder", d)]],
            "sweep": ["sweep", *base, "--decoder", SWEEP_DECODER, "--ebn0",
                      "1.2", "--batch", "2048", "--max-frames", "2048",
                      "--profile-dir", str(prof_sweep)],
        }
        for key, argv in runs.items():
            smi_before = smi_sample()
            rc, lines, wall = run_cli(argv)
            line = json.loads(lines[-1]) if key != "sweep" else lines[-1]
            lines_out[key] = line
            emit("bench", mode=key, rc=rc, seconds=wall, line=line,
                 smi_before=smi_before, smi_after=smi_sample())
            if rc != 0:
                raise AssertionError(f"cli {key}: rc {rc}")
        traces = {"bench": trace_names(prof_bench, K1A_KERNEL),
                  "sweep": trace_names(prof_sweep, K1A_KERNEL)}
        sizes = {k: sum(p.stat().st_size for p in d.glob("trace_*.json"))
                 for k, d in (("bench", prof_bench), ("sweep", prof_sweep))}
    rows = run_scaling()
    for row in rows:
        emit("bench", mode="scaling", line=row)
    emit("bench_traces", traces_naming_k1a=traces, trace_bytes=sizes)
    if not all(traces.values()):
        raise AssertionError(f"a --profile-dir trace lacks {K1A_KERNEL}")
    ab = lines_out["ab"]
    if len(ab["arms"]) != 2 or not all(a["mbps"] > 0 for a in ab["arms"]):
        raise AssertionError("bench --ab: not two timed arms")
    if not 0.0 <= lines_out["pipeline"]["decode_share"] <= 1.0:
        raise AssertionError("bench --pipeline: decode share outside [0, 1]")
    if len(rows) != torch.cuda.device_count() or rows[0]["efficiency"] != 1.0:
        raise AssertionError(f"bench.scaling: rows {rows}")
    launches = {"layered_qc": layered_decode_cuda.launches,
                "flooding:minsum": flooding_decode_cuda.launches}
    if min(launches.values()) <= 0:
        raise AssertionError(f"bench: a kernel never launched {launches}")
    return launches


# phases 43-49: slice 14
# 43. the accumulate form on xor graphs that repeat a block-column in a
# layer (bench/multi_edge.py): (Z, mb, nb, degree, Eb/N0, frames a case);
# 32 and 13 frames spread a frame over a cluster, 601 frames take CS = 1
XOR_MULTI_EDGE = [(64, 4, 16, 8, 2.5, (32, 13, 601)),
                  (256, 6, 24, 12, 2.5, (32, 601))]
# 44. rows wider than 32 through K1b/K1c': circulant multi-edge graphs of
# degree 40 (the 64-wide build) and 80 (the wide build)
WIDE_CLASSIC = [(32, 4, 48, 40, 3.0, (13, 601)),
                (32, 4, 100, 80, 3.5, (32, 601))]
MULTI_EDGE_T = 10       # iterations a case
MULTI_EDGE_TIMED_B = 4096
# 45. the precision libraries' instances at small sizes: (kernels-line
# name "<library>:<precision>", code, decoder spec, Eb/N0); the precision
# is the name's, whatever /pallas picks for the code (wimax/576/12 fits
# the TPU's VMEM at f32; K3 bf16 runs there at Z = 24 as the CPU tests
# hold it against the JAX kernel)
PALLAS_CASES = [
    ("flooding_qc:bf16", "nr5g/bg1/384", "{r}/10", 1.0),
    ("flooding_qc:bf16", "wimax/576/12", "{r}/10", 2.0),
    ("flooding:bf16", "mackay1008", "minsum/norm:0.8125/10", 2.0),
    ("flooding:bf16", "80211n/648/12", "minsum/norm:0.8125/10", 2.0),
    ("layered_qc:bf16-perm", "8023an", "layered/norm:0.8125/10", 3.4),
    ("flooding_qc:bf16-perm", "8023an", "minsum/norm:0.8125/10", 3.4),
]
PALLAS_FRAMES = (32, 13)
# 47. the two 8023an goldens the TPU made through these roundings, swept
# through the CLI with --backend pallas at their points (frames capped)
PALLAS_GOLDENS = [ROOT / "curves" / "8023an_tpu_golden.json",
                  ROOT / "curves" / "8023an_layered_tpu_golden.json"]
PALLAS_GOLDEN_FRAMES = 32768
# 48. /xla-mm on mackay1008 against K2 in f32
XLA_MM_SPECS = ("minsum/norm:0.8125/25", "spa/25")
XLA_MM_B = 2048
XLA_MM_EBN0 = 2.0


def _timed_decode(graph, spec: str, B: int, ebn0: float, dev, wrapper,
                  accumulate: bool) -> dict:
    """One decoder of `spec` on `graph` through get_decoder, B all-zero
    codewords at ebn0: the wrapper's launches in a warm-up and 5 timed
    decodes (counts zeroed before), ms (median, CUDA events) and the
    bound."""
    kw = parse_decoder_spec(spec)
    llr = zero_codeword_llr(graph, B, ebn0, dev, seed=2)
    dec = get_decoder(graph, spec, device=dev)
    wrapper.launches = 0
    res = dec(llr)
    torch.cuda.synchronize()
    times = [event_seconds(lambda: dec(llr)) for _ in range(5)]
    cn, schedule = rule_of(kw)
    bound_s, form = decode_bound(graph.n, graph.num_block_edges * graph.Z,
                                 B, int(res.iterations.sum().item()), cn,
                                 graph.m, schedule, accumulate)
    return dict(ms=float(np.median(times)) * 1e3,
                tries_ms=[t * 1e3 for t in times],
                launches=wrapper.launches, bound_ms=bound_s * 1e3,
                bound_by=form, frames=B,
                ok_frames=int(res.ok.sum().item()),
                **tile_line(wrapper, B))


def multi_edge_path(dev, ptxas: dict) -> list:
    """Phases 43-44: K1b/K1c' on xor graphs that repeat a block-column in
    a layer (its xor instantiation) and on circulant ones of row degree 40
    and 80 (its 64-wide and wide builds): every rule, fixed and track,
    against the plain version (bits, ok, iterations and the final
    posteriors identical: 0 ulps); then each graph's min-sum decoder timed
    through get_decoder at 4096 frames, its launches counted there.
    Returns the kernels-line entries."""
    entries = []
    for phase, cases, perm in (("43", XOR_MULTI_EDGE, "xor"),
                               ("44", WIDE_CLASSIC, "roll")):
        for Z, mb, nb, d, ebn0, frames in cases:
            graph = multi_edge_graph(Z, mb, nb, d, perm, seed=d)
            err, plain_ms = 0.0, None
            for cn in KINDS:
                for track in (False, True):
                    for B in frames:
                        llr = zero_codeword_llr(graph, B, ebn0, dev)
                        dkw = dict(alpha=0.8125, beta=0.0,
                                   max_iters=MULTI_EDGE_T, early_term=track,
                                   cn=cn)
                        r = compare_posteriors(
                            classic_with_posteriors_cuda,
                            plain_with_posteriors, graph, llr, dkw,
                            final_exact=True, tiles=layered_classic_cuda)
                        err = max(err, r["max_abs_err"])
                        emit("multi_edge_vs_plain", step=phase,
                             graph=graph.name, cn=cn, track=track, **r)
            width = "xor" if perm == "xor" else ("64" if d <= 64 else "wide")
            spec = f"layered/norm:0.8125/{MULTI_EDGE_T}/noet"
            llr = zero_codeword_llr(graph, MULTI_EDGE_TIMED_B, ebn0, dev, 2)
            _, plain_ms = timed(plain_with_posteriors, graph, llr,
                                alpha=0.8125, max_iters=MULTI_EDGE_T,
                                early_term=False)
            t = _timed_decode(graph, spec, MULTI_EDGE_TIMED_B, ebn0, dev,
                              layered_classic_cuda, accumulate=True)
            by_perm = dict(layered_classic_cuda.launches_by_perm)
            emit("multi_edge_timed", step=phase, graph=graph.name,
                 decoder=spec, plain_ms=plain_ms, launches_by_perm=by_perm,
                 **t)
            if t["launches"] <= 0:
                raise AssertionError(f"{graph.name}: K1b never launched")
            entries.append({
                "name": f"layered_classic:{width}", "route": "cuda",
                "source": "ecc_ldpc_tpu_torch/csrc/layered_classic.cu",
                "replaces": "ecc_ldpc_tpu/decode/pallas/layered_qc.py:415",
                "launches": t["launches"], "max_abs_err": err,
                "ms": t["ms"], "plain_ms": plain_ms,
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None, "graph": graph.name,
                "plan": t["plan"]})
    for lib in ("layered_classic", "layered_classic_prec",
                "layered_classic_prec_xor"):
        emit("classic_ptxas", library=lib,
             instances=instance_ptxas(ptxas.get(lib, "")))
    return entries


PALLAS_KERNELS = {
    "flooding_qc": (flooding_qc_with_posteriors_cuda,
                    flooding_qc_with_posteriors_plain,
                    flooding_qc_decode_cuda),
    "flooding": (flooding_with_posteriors_cuda,
                 flooding_with_posteriors_plain, flooding_decode_cuda),
}


def compare_pallas(graph, llr, kw, name: str) -> dict:
    """The kernel of the kernels-line name `name` ("<library>:<precision>":
    K3 bf16 storage, K2 bf16 matmul inputs, K4 bf16 permutations) against
    its plain version on the same LLRs with that precision: bits, ok,
    iterations and the final posteriors identical."""
    lib, prec = name.split(":")
    precision = {"bf16": ("bf16",), "bf16-perm": ("bf16-perm",)}[prec]
    if lib == "layered_qc":
        dkw = dict(alpha=kw.get("alpha", 1.0), beta=kw.get("beta", 0.0),
                   max_iters=kw.get("max_iters", 25),
                   early_term=kw.get("early_term", True),
                   precision=precision)
        fns = (with_precision(minsum_with_posteriors_cuda),
               plain_with_posteriors, layered_decode_cuda)
    else:
        dkw = dict(kind=kw["kind"], alpha=kw.get("alpha", 1.0),
                   beta=kw.get("beta", 0.0),
                   max_iters=kw.get("max_iters", 25),
                   early_term=kw.get("early_term", True),
                   precision=precision)
        fns = PALLAS_KERNELS[lib]
    return compare_posteriors(fns[0], fns[1], graph, llr, dkw,
                              final_exact=True, tiles=fns[2])


def pallas_kernels_path(dev) -> dict:
    """Phase 45: the precision libraries' new instances (K3 bf16 storage,
    K2 bf16 matmul inputs, K4 bf16 permutations, layered and flooding)
    against their plain versions: each case fixed and track, 32 and 13
    frames, 0 ulps. Returns the largest error per kernels-line name."""
    errs = collections.defaultdict(float)
    for name, code, spec_str, ebn0 in PALLAS_CASES:
        for kind in (KINDS if "{r}" in spec_str else (None,)):
            base = spec_str.format(r=RULE[kind]) if kind else spec_str
            for track in (False, True):
                spec = base + ("" if track else "/noet") + "/pallas"
                for B in PALLAS_FRAMES:
                    x = make_inputs(code, spec, B, ebn0, dev, seed=1)
                    r = compare_pallas(x.graph, x.llr, x.kw, name)
                    errs[name] = max(errs[name], r["max_abs_err"])
                    emit("pallas_vs_plain", kernel=name, code=code,
                         decoder=spec, **r)
    return dict(errs)


def pallas_legs_path(dev, ptxas: dict, errs: dict) -> list:
    """Phase 46: each `/pallas` leg (bench.PALLAS_LEGS, B = 4096,
    /25/noet) beside its f32 leg in the same call, after the kernel
    against its plain version at the leg's shape; launches counted around
    each leg's own run. Returns the kernels-line entries."""
    sources = {"flooding_qc": "ecc_ldpc_tpu_torch/csrc/flooding_qc.cu",
               "flooding": "ecc_ldpc_tpu_torch/csrc/flooding.cu",
               "layered_qc": "ecc_ldpc_tpu_torch/csrc/layered_qc.cu"}
    replaces = {
        "flooding_qc:bf16": "ecc_ldpc_tpu/decode/pallas/flooding_qc.py:85",
        "flooding:bf16": "ecc_ldpc_tpu/decode/pallas/fused_mm.py:151",
        "layered_qc:bf16-perm": "ecc_ldpc_tpu/decode/pallas/layered_xor.py:65",
        "flooding_qc:bf16-perm":
            "ecc_ldpc_tpu/decode/pallas/layered_xor.py:65"}
    wrappers = {"flooding_qc": flooding_qc_decode_cuda,
                "flooding": flooding_decode_cuda,
                "layered_qc": layered_decode_cuda}
    entries = []
    for leg, cfg in PALLAS_LEGS.items():
        x = make_inputs(**cfg, device=dev, seed=0)
        lib = ("layered_qc" if x.kw["kind"] == "layered" else
               "flooding_qc" if hasattr(x.graph, "Z") else "flooding")
        prec = (describe(tpu_precision(x.graph)) if lib == "layered_qc" else
                describe(tpu_flooding_qc_precision(x.graph, x.kw["kind"]))
                if lib == "flooding_qc" else
                describe(tpu_flooding_precision(x.graph, x.kw["kind"])))
        name = f"{lib}:{prec}"
        if name not in replaces:
            raise AssertionError(f"{leg}: /pallas rounds {prec} there")
        r = compare_pallas(x.graph, x.llr, x.kw, name)
        errs[name] = max(errs.get(name, 0.0), r["max_abs_err"])
        emit("pallas_vs_plain", kernel=name, leg=leg, **r)
        del x
        runs = {}
        for which, spec in (("f32", cfg["decoder"].replace("/pallas", "")),
                            (prec, cfg["decoder"])):
            w = wrappers[lib]
            w.launches = 0
            w.launches_by_precision = collections.Counter()
            smi_before = smi_sample()
            res = run_benchmark(**dict(cfg, decoder=spec), device=dev)
            runs[which] = (res, w.launches, dict(w.launches_by_precision))
            emit("pallas_leg", leg=leg, precision=which, decoder=spec,
                 code=cfg["code"], launches_by_precision=runs[which][2],
                 plan=tile_line(w, res.batch)["plan"],
                 **bench_line(res, w.launches, smi_before))
        res, launches, by_prec = runs[prec]
        if by_prec.get(prec, 0) <= 0 or launches <= 0:
            raise AssertionError(f"{leg}: the {prec} kernel never launched")
        entries.append({
            "name": name, "route": "cuda", "source": sources[lib],
            "replaces": replaces[name], "launches": by_prec[prec],
            "max_abs_err": errs[name], "ms": res.wall_s_per_batch * 1e3,
            "f32_ms": runs["f32"][0].wall_s_per_batch * 1e3,
            "plain_ms": r["plain_ms"], "bound_ms": res.bound_ms,
            "bound_by": res.roofline_form, "library_ms": None,
            "precision": prec, "leg": leg})
    for lib in ("flooding_prec", "flooding_qc_prec", "layered_qc_prec"):
        emit("pallas_ptxas", library=lib,
             instances=instance_ptxas(ptxas.get(lib, "")))
    return entries


def _fer_ok(m: PointResult, r: PointResult) -> bool:
    """The JAX package's golden gate rule (tests/ber/test_golden_gate.py):
    Wilson-CI overlap of FER, or within 1.25x where the golden saturates
    at FER >= 0.5."""
    lo, hi = m.fer_ci
    if not (r.fer_ci[1] < lo or hi < r.fer_ci[0]):
        return True
    return r.fer >= 0.5 and 0.8 <= m.fer / r.fer <= 1.25


def pallas_goldens_path() -> dict:
    """Phase 47: the two 8023an TPU goldens (made through K4's bf16
    permutations) against CLI sweeps with --backend pallas at each
    golden's points (its frames, at most PALLAS_GOLDEN_FRAMES), by the
    reference gate's rule: FER by _fer_ok at every point, BER overlap or
    within 2x. Returns the launches of K4 (bf16-perm) in the sweeps."""
    added = collections.Counter()
    for path in PALLAS_GOLDENS:
        golden = [PointResult.from_json(d) for d in json.loads(
            path.read_text())]
        frames = min(max(g.frames for g in golden), PALLAS_GOLDEN_FRAMES)
        for w in (layered_decode_cuda, flooding_qc_decode_cuda):
            w.launches_by_precision = collections.Counter()
        with tempfile.TemporaryDirectory() as tmp:
            out = pathlib.Path(tmp) / "pallas.json"
            t0 = time.perf_counter()
            rc = cli_main([
                "sweep", "--code", golden[0].code, "--decoder",
                golden[0].decoder, "--ebn0",
                ",".join(str(g.ebn0_db) for g in golden),
                "--batch", "4096", "--backend", "pallas",
                "--min-frame-errors", "1000000", "--max-frames",
                str(frames), "--out", str(out)])
            wall = time.perf_counter() - t0
            swept = [PointResult.from_json(d)
                     for d in json.loads(out.read_text())]
        launches = {"layered_qc": dict(layered_decode_cuda.launches_by_precision),
                    "flooding_qc":
                        dict(flooding_qc_decode_cuda.launches_by_precision)}
        added["layered_qc:bf16-perm"] += launches["layered_qc"].get(
            "bf16-perm", 0)
        added["flooding_qc:bf16-perm"] += launches["flooding_qc"].get(
            "bf16-perm", 0)
        fer_ok = all(_fer_ok(m, g) for m, g in zip(swept, golden))
        ber_ok = curves_overlap(swept, golden, "ber") or all(
            0.5 <= m.ber / g.ber <= 2.0 for m, g in zip(swept, golden)
            if g.ber > 0)
        for m, g in zip(swept, golden):
            emit("pallas_vs_golden", decoder=g.decoder, **point_line(m),
                 golden_fer=g.fer, golden_fer_ci=g.fer_ci,
                 golden_ber=g.ber, golden=path.name)
        emit("pallas_vs_golden", golden=path.name, rc=rc, fer_ok=fer_ok,
             ber_ok=ber_ok, launches=launches, seconds=wall)
        if rc != 0 or not (fer_ok and ber_ok):
            raise AssertionError(f"{path.name}: the --backend pallas sweep "
                                 f"misses the golden")
        if sum(sum(v.values()) for v in launches.values()) <= 0 or not any(
                v.get("bf16-perm") for v in launches.values()):
            raise AssertionError(f"{path.name}: K4's bf16 kernel never ran")
    return dict(added)


def xla_mm_path(dev) -> dict:
    """Phase 48: `/xla-mm` on mackay1008 (the expanded graph by
    choose_graph's rule) against K2 in f32 on the same LLRs: bits, ok and
    iterations equal, for minsum and spa; K2's launches under /xla-mm
    counted (zeroed just before). Returns them by kernels-line name."""
    spec = get_code("mackay1008")
    added = {}
    for base in XLA_MM_SPECS:
        graph = choose_graph(spec, base, backend="xla-mm")
        x = make_inputs("mackay1008", base, XLA_MM_B, XLA_MM_EBN0, dev,
                        seed=4)
        want = get_decoder(graph, base, device=dev)(x.llr)
        flooding_decode_cuda.launches = 0
        got, ms = timed(get_decoder(graph, base + "/xla-mm", device=dev),
                        x.llr)
        launches = flooding_decode_cuda.launches
        same = (torch.equal(got.bits, want.bits)
                and torch.equal(got.ok, want.ok)
                and torch.equal(got.iterations, want.iterations))
        emit("xla_mm", decoder=base + "/xla-mm", graph=type(graph).__name__,
             frames=XLA_MM_B, ok_frames=int(got.ok.sum().item()),
             equal_to_k2_f32=same, launches=launches, ms=ms)
        if not same or launches <= 0:
            raise AssertionError(f"{base}/xla-mm differs from K2 f32 or "
                                 f"never launched it")
        key = "flooding:" + parse_decoder_spec(base)["kind"]
        added[key] = added.get(key, 0) + launches
    return added


def graph_parallel_path(rank_out: pathlib.Path) -> dict:
    """Phase 49: both graph-parallel tiers (dist/graph_parallel.py) on D =
    2 and 4 ranks of the card (bench/graph_parallel.py in rank_jobs'
    launch, a group of the first D for each D; its lines in rank_out):
    the QC tier on dvbs2/64800/12 bit-identical to K3 on one rank, the
    generic tier on mackay1008 agreeing with the single-rank flooding
    decoder on ok frames. Returns K5's launches on rank 0 in the tiers'
    decodes."""
    lines = rank_lines(rank_out, "graph_parallel", RANK_JOBS_WORLD)
    for line in lines:
        emit("graph_parallel", **line)
        for tier in line["tiers"]:
            if not tier["pass"]:
                raise AssertionError(f"graph-parallel {tier['tier']} tier "
                                     f"at D = {tier['D']}, rank "
                                     f"{line['rank']} failed")
    for D in GRAPH_PARALLEL_RANKS:
        if sum(t["D"] == D for q in lines for t in q["tiers"]) != 2 * D:
            raise AssertionError(f"graph-parallel D = {D}: a tier missing")
    ring = sum(t["ring_launches"] for t in lines[0]["tiers"])
    if ring <= 0:
        raise AssertionError("K5 never ran on the graph-parallel path")
    return {"ring": ring}


# phases 50-51: the experiments' kernels (E1-E7, ecc_ldpc_tpu_torch/experiments)
# frames and sweeps of an E1-E3 comparison: 272 tiles of one frame on 132
# blocks, so each block takes two or three tiles in turn and reuses its
# state slab, spill and prefetch buffers, as the main path's 4096 do
EXP_LAYERED = (272, 3)
# E4's frames and iterations: 2045 frames run F = 8, 256 tiles on 132
# blocks, the last of 5 frames (the main path's 2048 run F = 8, 256 full
# tiles); 13 frames run one a block
EXP_FLOODING = ((2045, 5), (13, 5))
EXP_MICRO = (8, 2)        # inner and reps of an E5-E7 comparison
EXP_SOURCES = {
    "ablate_layered": ("ablate_layered.cu", "experiments/ablate_layered.py:116"),
    "ablate_layered2": ("ablate_layered.cu",
                        "experiments/ablate_layered2.py:113"),
    "static_unroll": ("ablate_layered.cu", "experiments/static_unroll.py:108"),
    "dcmajor": ("dcmajor.cu", "experiments/smallcode_opt2.py:183"),
    "micro_ops:ew": ("micro_ops.cu", "experiments/micro_vpu.py:73"),
    "micro_ops:roll": ("micro_ops.cu", "experiments/micro_vpu.py:92"),
    "micro_ops:op": ("micro_ops.cu", "experiments/micro_vpu2.py:66"),
}
EXP_MAINS = ("micro_vpu", "micro_vpu2", "ablate_layered", "ablate_layered2",
             "static_unroll", "smallcode_opt2")


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in units in the last place between two f32
    tensors (0: the same bits)."""
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    oa = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ob = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((oa - ob).abs().max().item()) if a.numel() else 0


def _micro_x(dtype: str, cols: int, dev, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if dtype.startswith("int"):
        lim = 100 if dtype == "int8" else 1000
        x = rng.integers(-lim, lim, (micro.Z, cols))
    else:
        x = 3 * rng.standard_normal((micro.Z, cols))
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def experiments_kernels_path(dev) -> dict:
    """Phase 50: every variant of E1-E7 against its plain version on the
    card, on the same inputs, at the plans phase 51 runs: E5-E7 at both
    of its shapes, [368, 128] and [368, 16896], with EXP_MICRO steps,
    outputs 0 ulps apart; E1 and E2's variants and E3 on dvbs2/64800/12
    (EXP_LAYERED: more tiles than blocks), bits identical and final
    posteriors 0 ulps apart, and E3's bits and posteriors equal to E1
    full's (E3 is E1 full without the cap, which these magnitudes never
    reach); E4's three variants on mackay1008 (EXP_FLOODING: F = 8 with a
    ragged last tile and more tiles than blocks, and one frame a block),
    bits, ok and iterations identical and final posteriors 0 ulps apart
    (each variable's sum in ascending edge order, as the plain version
    adds). The counts are the wrappers' own and are not the main path's.
    Returns {kernels-line name: {"ulps", "max_abs_err", "plain_ms", "ms",
    "shape"}}: the largest ulps and error over every case, the times and
    shape of its first (the plain version's time beside the kernel's)."""
    t0 = time.perf_counter()
    out = {}

    def note(name, kern_ms, plain_ms, ulps, err, shape):
        o = out.setdefault(name, dict(ulps=0, max_abs_err=0.0,
                                      plain_ms=plain_ms, ms=kern_ms,
                                      shape=shape))
        o["ulps"] = max(o["ulps"], ulps)
        o["max_abs_err"] = max(o["max_abs_err"], err)

    inner, reps = EXP_MICRO
    cases = 0
    for cols in (micro.L, micro.FULL_L):
        for kind, dtypes, fn, plain in (
                ("ew", micro.EW_DTYPES, micro.ew_cuda, micro.ew_plain),
                ("roll", micro.ROLL_DTYPES, micro.roll_cuda,
                 micro.roll_plain)):
            for dtype in dtypes:
                x = _micro_x(dtype, cols, dev, 5)
                fn(x, dtype, inner, reps)  # warm
                got, ms = timed(fn, x, dtype, inner, reps)
                ref, pms = timed(plain, x, dtype, inner, reps)
                u = _ulps(got, ref)
                note(f"micro_ops:{kind}", ms, pms, u,
                     (got - ref).abs().max().item(),
                     [micro.Z, cols, inner * reps])
                cases += 1
                if u:
                    raise AssertionError(
                        f"E5/E6 {kind} {dtype} [{micro.Z}, {cols}]: {u} ulps")
        for name in micro.OPS:
            for dtype in micro.OP_DTYPES:
                a, b = micro.op_inputs(dtype, micro.Z, cols, dev, seed=6)
                micro.op_cuda(a, b, name, inner, reps)  # warm
                got, ms = timed(micro.op_cuda, a, b, name, inner, reps)
                ref, pms = timed(micro.op_plain, a, b, name, inner, reps)
                u = _ulps(got, ref)
                note("micro_ops:op", ms, pms, u,
                     float(torch.nan_to_num((got - ref).abs()).max().item()),
                     [micro.Z, cols, inner * reps])
                cases += 1
                if u:
                    raise AssertionError(
                        f"E7 {name} {dtype} [{micro.Z}, {cols}]: {u} ulps")
    emit("experiments_micro", seconds=time.perf_counter() - t0, cases=cases,
         **{k: v for k, v in out.items()})

    t1 = time.perf_counter()
    graph = ablate.static_graph()
    B, iters = EXP_LAYERED
    llr3 = ablate.inputs3(graph, B, dev, seed=4, mean=0.5)
    llr = {r: ablate.to_var(graph, llr3, r) for r in (True, False)}
    cases = [("ablate_layered", v, fl, False)
             for v, fl in ablate.E1_VARIANTS.items()]
    cases += [("ablate_layered2", v, fl, True)
              for v, fl in E2_VARIANTS.items()]
    cases.append(("static_unroll", "full", E3_FLAGS, True))
    kept = {}
    for name, v, fl, static in cases:
        x = llr[bool(fl & ROLL)]
        ablate.ablate_cuda(graph, x, fl, iters, static=static)  # warm
        (bits, post), ms = timed(ablate.ablate_cuda, graph, x, fl, iters,
                                 static=static, with_posteriors=True)
        (rbits, rpost), pms = timed(ablate.ablate_plain, graph, x, fl,
                                    iters)
        same = torch.equal(bits, rbits)
        u = _ulps(post, rpost)
        emit("experiments_layered", kernel=name, variant=v, flags=fl,
             frames=B, iters=iters, bits_equal=same, post_ulps=u, ms=ms,
             plain_ms=pms, ones=int(bits.sum().item()),
             plan=ablate.ablate_cuda.last_plan[0].as_dict(),
             blocks=ablate.ablate_cuda.last_plan[1])
        note(name, ms, pms, u, (post - rpost).abs().max().item(),
             [B, graph.n, iters])
        if not same or u:
            raise AssertionError(f"{name} {v}: bits equal {same}, {u} ulps")
        kept[name, v] = bits, post
    e1, e3 = kept["ablate_layered", "full"], kept["static_unroll", "full"]
    if not (torch.equal(e1[0], e3[0]) and same_floats(e1[1], e3[1])):
        raise AssertionError("E3 differs from E1 full")

    t2 = time.perf_counter()
    for B, iters in EXP_FLOODING:
        x = make_inputs("mackay1008", "minsum/norm:0.8125/5", B, 2.0, dev,
                        seed=8)
        fgraph = x.graph
        for v in smallcode_opt2.VARIANTS:
            smallcode_opt2.dcmajor_cuda(fgraph, x.llr, v, iters)  # warm
            (res, post), ms = timed(smallcode_opt2.dcmajor_cuda, fgraph,
                                    x.llr, v, iters, with_posteriors=True)
            (ref, rpost), pms = timed(smallcode_opt2.dcmajor_plain, fgraph,
                                      x.llr, v, iters)
            same = (torch.equal(res.bits, ref.bits)
                    and torch.equal(res.ok, ref.ok)
                    and torch.equal(res.iterations, ref.iterations))
            u = _ulps(post, rpost)
            plan = smallcode_opt2.dcmajor_cuda.last_plan
            emit("experiments_flooding", variant=v, frames=B, iters=iters,
                 same=same, post_ulps=u, ok=int(res.ok.sum().item()), ms=ms,
                 plain_ms=pms, plan=plan,
                 last_tile_frames=B - (plan["tiles"] - 1) * plan["frames"])
            note("dcmajor", ms, pms, u, (post - rpost).abs().max().item(),
                 [B, fgraph.n, iters])
            if not same or u:
                raise AssertionError(f"E4 {v} at {B} frames: bits, ok and "
                                     f"iterations equal {same}, {u} ulps")
    emit("experiments_kernels", seconds=time.perf_counter() - t0,
         layered_s=t2 - t1, flooding_s=time.perf_counter() - t2)
    return out


def _json_lines(text: str) -> list:
    out = []
    for ln in text.splitlines():
        if ln.startswith("{"):
            out.append(json.loads(ln))
    return out


def experiments_mains_path(dev) -> tuple:
    """Phase 51: each experiment's main at its script's own configuration
    (the E1-E3 scripts on dvbs2/64800/12, E1 at B = 128 and 4096, E2 at
    4096, E3 at both; E4 on mackay1008 at B = 2048; E5-E7 at [368, 128] and
    [368, 16896]), its output printed as it ran, the kernels' counts zeroed
    before and read after. Also E6's library call: one torch.roll by the
    chain's shift. Returns ({script: [its JSON lines]}, {kernels-line
    name: launches}, library ms of E6)."""
    import importlib

    ablate.ablate_cuda.launches_by_library.clear()
    smallcode_opt2.dcmajor_cuda.launches = 0
    micro.ew_cuda.launches = micro.roll_cuda.launches = 0
    micro.op_cuda.launches = 0
    lines = {}
    for name in EXP_MAINS:
        t0 = time.perf_counter()
        buf = io.StringIO()
        mod = importlib.import_module(f"ecc_ldpc_tpu_torch.experiments.{name}")
        with contextlib.redirect_stdout(buf):
            rc = mod.main([])
        print(buf.getvalue(), end="", flush=True)
        lines[name] = _json_lines(buf.getvalue())
        emit("experiments_main", script=name, rc=rc,
             seconds=time.perf_counter() - t0, lines=len(lines[name]))
        if rc != 0:
            raise AssertionError(f"{name}.main() returned {rc}")
    by_lib = ablate.ablate_cuda.launches_by_library
    launches = {
        "ablate_layered": by_lib["ablate_layered"],
        "ablate_layered2": sum(by_lib[ablate.library_of(fl, True)]
                               for fl in E2_VARIANTS.values()),
        "static_unroll": by_lib[ablate.library_of(E3_FLAGS, True)],
        "dcmajor": smallcode_opt2.dcmajor_cuda.launches,
        "micro_ops:ew": micro.ew_cuda.launches,
        "micro_ops:roll": micro.roll_cuda.launches,
        "micro_ops:op": micro.op_cuda.launches,
    }
    same = [ln for ln in lines["static_unroll"] if "bits_equal_e1_full" in ln]
    if len(same) != 2 or not all(ln["bits_equal_e1_full"] for ln in same):
        raise AssertionError("E3's bits differ from E1 full's at full width")
    x = torch.ones((micro.Z, micro.L), device=dev)
    shift = micro.roll_total() % micro.Z
    lib_ms = exp_common.seconds(lambda: torch.roll(x, shift, 0), dev) * 1e3
    emit("experiments_mains", launches=launches, roll_library_ms=lib_ms)
    return lines, launches, lib_ms


def _pick(lines: list, **kw) -> dict:
    for ln in lines:
        if all(ln.get(k) == v for k, v in kw.items()):
            return ln
    raise AssertionError(f"no line with {kw}")


def experiments_entries(parity: dict, lines: dict, launches: dict,
                        roll_ms: float) -> list:
    """The kernels-line entries of E1-E7: ms of each kernel's first variant
    at its script's configuration (E1, E3: full at B = 128; E2: full at
    4096; E4: full at 2048; E5, E6: f32, E7: add f32, at [368, 128]), its
    bound from the same line, launches of phase 51, the comparisons of
    phase 50 (the plain version's ms there, at `plain_shape`: frames, n
    and sweeps for E1-E4, rows, columns and steps for E5-E7)."""
    picks = {
        "ablate_layered": _pick(lines["ablate_layered"], variant="full",
                                regime="latency"),
        "ablate_layered2": _pick(lines["ablate_layered2"], variant="full"),
        "static_unroll": _pick(lines["static_unroll"], variant="static",
                               regime="latency"),
        "dcmajor": _pick(lines["smallcode_opt2"], variant="dcmajor/full/bf16"),
        "micro_ops:ew": _pick(lines["micro_vpu"], kind="ew", dtype="float32",
                              shape_name="tpu"),
        "micro_ops:roll": _pick(lines["micro_vpu"], kind="roll",
                                dtype="float32", shape_name="tpu"),
        "micro_ops:op": _pick(lines["micro_vpu2"], op="add", dtype="float32",
                              shape_name="tpu"),
    }
    out = []
    for name, ln in picks.items():
        src, replaces = EXP_SOURCES[name]
        p = parity[name]
        out.append({
            "name": name, "route": "cuda",
            "source": f"ecc_ldpc_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": p["max_abs_err"],
            "ms": ln["ms"], "plain_ms": p["plain_ms"],
            "bound_ms": ln["bound_ms"], "bound_by": ln["bound_by"],
            "library_ms": roll_ms if name == "micro_ops:roll" else None,
            "plain_shape": p["shape"], "ms_at_plain_shape": p["ms"],
        })
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; it runs on the card")
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit("device", name=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         kernels={k: [ln.strip() for ln in v["ptxas"].splitlines()
                      if "registers" in ln or "spill" in ln]
                  for k, v in built.items()})

    dev = torch.device("cuda", 0)
    max_err = 0.0
    k1a_lines = []
    cases = [(name, code, spec_str, ebn0, 32)
             for name, code, spec_str, ebn0 in PARITY_CASES] + PLAN_CASES
    for name, code, spec_str, ebn0, B in cases:
        x = make_inputs(code, spec_str, B, ebn0, dev, seed=1)
        r, _ = compare(x.graph, x.llr, x.kw)
        max_err = max(max_err, r["max_abs_err"])
        k1a_lines.append(r)
        emit("kernel_vs_plain", case=name, code=code, **r)
    trap = np.load(TRAP_FILE)
    spec12 = get_code("dvbs2/64800/12")
    trap_spec = "layered/sched:dvbs2_64800_12_T25_op2"
    r, _ = compare(choose_graph(spec12, trap_spec),
                torch.as_tensor(trap["llr"], device=dev),
                parse_decoder_spec(trap_spec))
    max_err = max(max_err, r["max_abs_err"])
    emit("kernel_vs_plain", case="trap_batch_track_op2", **r)
    # each main-path leg's own shapes and inputs (run_benchmark's seed)
    leg_parity = {}
    for leg, cfg in LEGS.items():
        x = make_inputs(**cfg, device=dev, seed=0)
        r, _ = compare(x.graph, x.llr, x.kw)
        leg_parity[leg] = r
        max_err = max(max_err, r["max_abs_err"])
        k1a_lines.append(r)
        emit("kernel_vs_plain", case=f"{leg}_shape", **r)
        del x
    check_plans("layered_qc", k1a_lines)

    # the main path: counts from these three legs only
    layered_decode_cuda.launches = 0
    results, leg_plans = {}, {}
    for leg, cfg in LEGS.items():
        before = layered_decode_cuda.launches
        smi_before = smi_sample()
        res = run_benchmark(**cfg, device=dev)
        leg_plans[leg] = tile_line(layered_decode_cuda, res.batch)["plan"]
        fer = res.frame_errors / res.batch
        emit("main_path", leg=leg, smi_before=smi_before,
             smi_after=smi_sample(), mbps=res.throughput_mbps,
             s_per_batch=res.wall_s_per_batch, mean_iters=res.mean_iters,
             tries_ms=[t * 1e3 for t in res.tries_s],
             frame_errors=res.frame_errors, frames=res.batch, fer=fer,
             codeword_frame_errors=res.codeword_frame_errors,
             bound_ms=res.bound_ms, bound_by=res.roofline_form,
             bound_mbps=res.roofline_mbps,
             launches=layered_decode_cuda.launches - before,
             plan=leg_plans[leg],
             line=json.loads(res.json_line()))
        if not fer <= FER_MAX[leg]:
            raise AssertionError(f"{leg}: FER {fer} above {FER_MAX[leg]}")
        results[leg] = res
    launches = layered_decode_cuda.launches
    if launches <= 0:
        raise AssertionError("the main path never launched the layered kernel")

    for ebn0, op, lim in WATERFALL:
        x = make_inputs("dvbs2/64800/12", WATERFALL_DECODER, WATERFALL_FRAMES,
                        ebn0, dev, seed=3)
        res = x.decode(x.llr)
        errors, cw_errors = x.frame_errors(res.bits)
        fer = errors / WATERFALL_FRAMES
        emit("waterfall", ebn0_db=ebn0, decoder=WATERFALL_DECODER,
             frames=WATERFALL_FRAMES, fer=fer, band=f"{op} {lim}",
             codeword_frame_errors=cw_errors,
             mean_iters=res.iterations.float().mean().item())
        if not (fer >= lim if op == ">=" else fer <= lim):
            raise AssertionError(f"FER {fer} at {ebn0} dB outside {op} {lim}")

    # 6. the exact-BP kernel against its plain version
    exact_err = {"spa": 0.0, "minstar": 0.0}
    k1c_lines = []
    for cn in ("spa", "minstar"):
        for name, code, spec_str, ebn0, B in EXACT_CASES:
            spec_str = spec_str.format(cn=cn)
            x = make_inputs(code, spec_str, B, ebn0, dev, seed=1)
            r = compare_exact(x.graph, x.llr, x.kw)
            exact_err[cn] = max(exact_err[cn], r["max_abs_err"])
            k1c_lines.append(r)
            emit("exact_vs_plain", case=f"{cn}_{name}", code=code,
                 decoder=spec_str, **r)
    check_plans("layered_exact", k1c_lines)
    trap_spa = "layered/spa/50"
    r = compare_exact(choose_graph(spec12, trap_spa),
                      torch.as_tensor(trap["llr"], device=dev),
                      parse_decoder_spec(trap_spa))
    exact_err["spa"] = max(exact_err["spa"], r["max_abs_err"])
    emit("exact_vs_plain", case="spa_trap_batch_track_50", decoder=trap_spa, **r)
    exact_parity = {}
    for cn in ("spa", "minstar"):
        x = make_inputs(**EXACT_LEGS[cn], device=dev, seed=0)
        exact_parity[cn] = r = compare_exact(x.graph, x.llr, x.kw)
        exact_err[cn] = max(exact_err[cn], r["max_abs_err"])
        emit("exact_vs_plain", case=f"{cn}_bench_shape", **r)
        del x

    # 7. the exact kernel timed at full width; each rule's count is read
    # around its own run
    exact_bench, exact_bench_launches, exact_plans = {}, {}, {}
    for cn in ("spa", "minstar"):
        layered_exact_cuda.launches = 0
        smi_before = smi_sample()
        res = run_benchmark(**EXACT_LEGS[cn], device=dev)
        exact_bench_launches[cn] = layered_exact_cuda.launches
        exact_plans[cn] = tile_line(layered_exact_cuda, res.batch)["plan"]
        fer = res.frame_errors / res.batch
        emit("exact_bench", cn=cn, smi_before=smi_before,
             smi_after=smi_sample(), ms=res.wall_s_per_batch * 1e3,
             mbps=res.throughput_mbps,
             tries_ms=[t * 1e3 for t in res.tries_s],
             launches=exact_bench_launches[cn], bound_ms=res.bound_ms,
             bound_by=res.roofline_form,
             plain_ms=exact_parity[cn]["plain_ms"], plan=exact_plans[cn],
             frame_errors=res.frame_errors,
             frames=res.batch, fer=fer,
             codeword_frame_errors=res.codeword_frame_errors)
        if not fer <= EXACT_FER_MAX:
            raise AssertionError(f"{cn}: FER {fer} above {EXACT_FER_MAX}")
        if exact_bench_launches[cn] <= 0:
            raise AssertionError(f"{cn}: the exact kernel never launched")
        exact_bench[cn] = res

    # 8. the sweep against the golden curve
    with open(GOLDEN) as f:
        golden = [PointResult.from_json(d) for d in json.load(f)]
    t0 = time.perf_counter()
    swept = run_sweep(SweepSpec(
        code="dvbs2/64800/12", decoder=SWEEP_DECODER, ebn0_db=SWEEP_EBN0,
        batch=2048, stopping=StoppingRule(min_frame_errors=100,
                                          max_frames=32768)), device=dev)
    overlap = curves_overlap(swept, golden, "fer")
    for pr in swept:
        g = next(q for q in golden if abs(q.ebn0_db - pr.ebn0_db) < 1e-9)
        emit("sweep_vs_golden", decoder=SWEEP_DECODER, **point_line(pr),
             golden_fer=g.fer, golden_fer_ci=g.fer_ci)
    emit("sweep_vs_golden", overlap=overlap,
         seconds=time.perf_counter() - t0)
    if not overlap:
        raise AssertionError("the sweep's FER curve misses the golden curve")
    f32_golden_run = swept  # printed beside the bf16 run of phase 37

    # 9. the production sweep's own inputs: its first batch, as run_sweep
    # draws it, through the primary's kernel and plain version; then the
    # rows the primary failed, as with_retry gathers them, through the
    # fallback's
    prod_spec = SweepSpec(code=PRODUCTION_SWEEP["code"],
                          decoder=PRODUCTION_SWEEP["decoder"],
                          ebn0_db=(PRODUCTION_SWEEP["ebn0_db"],),
                          batch=PRODUCTION_SWEEP["batch"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(step_seed(prod_spec.seed, 0, 0, 0))
    _, llr = Pipeline.build(prod_spec, dev).frames(gen, prod_spec.ebn0_db[0])
    primary_spec, fallback_spec = prod_spec.decoder.split(";retry=")
    graph = choose_graph(spec12, prod_spec.decoder)
    r, kern = compare(graph, llr, parse_decoder_spec(primary_spec))
    max_err = max(max_err, r["max_abs_err"])
    emit("kernel_vs_plain", case="production_first_batch",
         decoder=primary_spec, **r)
    failed = torch.nonzero(~kern.ok).squeeze(1)
    if len(failed) == 0:
        raise AssertionError("the production batch sent no frame to retry")
    r = compare_exact(graph, llr.index_select(0, failed),
                      parse_decoder_spec(fallback_spec))
    exact_err["spa"] = max(exact_err["spa"], r["max_abs_err"])
    emit("exact_vs_plain", case="spa_production_fallback_rows",
         decoder=fallback_spec, **r)
    del llr, kern

    # 10. the production path through the CLI: counts from this run only
    layered_decode_cuda.launches = 0
    layered_exact_cuda.launches = 0
    layered_exact_cuda.frames = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "production.json"
        t0 = time.perf_counter()
        rc = cli_main([
            "sweep", "--code", PRODUCTION_SWEEP["code"],
            "--decoder", PRODUCTION_SWEEP["decoder"],
            "--ebn0", str(PRODUCTION_SWEEP["ebn0_db"]),
            "--batch", str(PRODUCTION_SWEEP["batch"]),
            "--min-frame-errors", "1000000",
            "--max-frames", str(PRODUCTION_FRAMES), "--out", str(out)])
        wall = time.perf_counter() - t0
        (prod,) = [PointResult.from_json(d)
                   for d in json.loads(out.read_text())]
    sweep_launches = {"layered_qc": layered_decode_cuda.launches,
                      "layered_exact": layered_exact_cuda.launches}
    emit("production", decoder=prod.decoder, rc=rc, **point_line(prod),
         seconds=wall, launches=sweep_launches,
         frames_to_fallback=layered_exact_cuda.frames)
    if rc != 0 or prod.frames != PRODUCTION_FRAMES:
        raise AssertionError(f"production sweep: rc {rc}, {prod.frames} frames")
    if not prod.fer <= PRODUCTION_FER_MAX:
        raise AssertionError(f"production FER {prod.fer} above "
                             f"{PRODUCTION_FER_MAX}")
    if sweep_launches["layered_exact"] <= 0 or layered_exact_cuda.frames <= 0:
        raise AssertionError("the retry fallback never ran: no exact launch")
    if sweep_launches["layered_qc"] <= 0:
        raise AssertionError("the production primary never launched")
    # the stored trap frames through the same decoder on the card
    production = PRODUCTION_SWEEP["decoder"]
    graph = choose_graph(spec12, production)
    llr = torch.as_tensor(trap["llr"], device=dev)
    cw = torch.as_tensor(trap["cw"], device=dev)
    primary = get_decoder(graph, production.split(";retry=")[0], device=dev)(llr)
    retried = get_decoder(graph, production, device=dev)(llr)
    emit("production_trap", frames=len(cw),
         primary_ok=int(primary.ok.sum().item()),
         retry_ok=int(retried.ok.sum().item()),
         retry_exact=bool(torch.equal(retried.bits, cw)),
         iterations=retried.iterations.tolist())
    if bool(primary.ok.any()):
        raise AssertionError("the primary decodes a stored trap frame")
    if not (bool(retried.ok.all()) and torch.equal(retried.bits, cw)):
        raise AssertionError("the retry decoder misses a trap codeword")

    # 11. the flooding kernel (K2) against its plain version on mackay1008
    k2 = (flooding_with_posteriors_cuda, flooding_with_posteriors_plain)
    k3 = (flooding_qc_with_posteriors_cuda, flooding_qc_with_posteriors_plain)
    flood_err = {f"flooding:{k}": 0.0 for k in KINDS}
    flood_err.update({f"flooding_qc:{k}": 0.0 for k in KINDS})
    k2_lines = []
    for name, spec_str, ebn0, B in FLOODING_CASES:
        x = make_inputs("mackay1008", spec_str, B, ebn0, dev, seed=1)
        r = compare_flooding(x.graph, x.llr, x.kw, *k2)
        key = f"flooding:{x.kw['kind']}"
        flood_err[key] = max(flood_err[key], r["max_abs_err"])
        k2_lines.append(r)
        emit("flooding_vs_plain", case=name, decoder=spec_str, **r)
    big = regular_graph(FLOODING_GLOBAL_N)
    for name, kw in FLOODING_GLOBAL_CASES:
        llr = zero_codeword_llr(big, FLOODING_GLOBAL_B, 2.0, dev)
        r = compare_flooding(big, llr, kw, *k2)
        key = f"flooding:{kw['kind']}"
        flood_err[key] = max(flood_err[key], r["max_abs_err"])
        k2_lines.append(r)
        emit("flooding_vs_plain", case=name, code=big.name, **r)
    del big
    check_k2_plans(k2_lines)
    # each rule at the timed leg's shape (the leg's code, batch and seed)
    mackay_legs = {k: dict(FLOODING_LEGS["mackay"],
                           decoder=f"{RULE[k]}/25/noet") for k in KINDS}
    flood_parity = {}
    for k in KINDS:
        x = make_inputs(**mackay_legs[k], device=dev, seed=0)
        flood_parity[f"flooding:{k}"] = r = compare_flooding(
            x.graph, x.llr, x.kw, *k2)
        flood_err[f"flooding:{k}"] = max(flood_err[f"flooding:{k}"],
                                         r["max_abs_err"])
        emit("flooding_vs_plain", case=f"{k}_bench_shape", **r)

    # 12. the QC flooding kernel (K3) against its plain version; its case
    # lines (with 16's and 20's) are held to the plans they must include
    k3_lines = []
    for k in KINDS:
        for name, code, spec_str, ebn0, B in FLOODING_QC_CASES:
            spec_str = spec_str.format(r=RULE[k])
            x = make_inputs(code, spec_str, B, ebn0, dev, seed=1)
            r = compare_flooding(x.graph, x.llr, x.kw, *k3)
            flood_err[f"flooding_qc:{k}"] = max(flood_err[f"flooding_qc:{k}"],
                                                r["max_abs_err"])
            k3_lines.append(dict(r, code=code))
            emit("flooding_qc_vs_plain", code=code, case=f"{k}_{name}",
                 decoder=spec_str, **r)
    r = compare_flooding(choose_graph(spec12, "spa/50"),
                         torch.as_tensor(trap["llr"], device=dev),
                         parse_decoder_spec("spa/50"), *k3)
    flood_err["flooding_qc:spa"] = max(flood_err["flooding_qc:spa"],
                                       r["max_abs_err"])
    emit("flooding_qc_vs_plain", case="spa_trap_batch_track_50",
         decoder="spa/50", **r)
    for k in KINDS:
        x = make_inputs(**FLOODING_LEGS[f"dvbs2_{k}"], device=dev, seed=0)
        flood_parity[f"flooding_qc:{k}"] = r = compare_flooding(
            x.graph, x.llr, x.kw, *k3)
        flood_err[f"flooding_qc:{k}"] = max(flood_err[f"flooding_qc:{k}"],
                                            r["max_abs_err"])
        emit("flooding_qc_vs_plain", case=f"{k}_bench_shape", **r)
        del x

    # 13. the flooding legs timed; each count read around its own run
    flood_bench, flood_launches, flood_plans = {}, {}, {}
    timed_legs = [(f"flooding:{k}", mackay_legs[k], flooding_decode_cuda)
                  for k in KINDS]
    timed_legs += [(f"flooding_qc:{k}", FLOODING_LEGS[f"dvbs2_{k}"],
                    flooding_qc_decode_cuda) for k in KINDS]
    for key, cfg, wrapper in timed_legs:
        wrapper.launches = 0
        smi_before = smi_sample()
        res = run_benchmark(**cfg, device=dev)
        flood_launches[key] = wrapper.launches
        flood_plans[key] = tile_line(wrapper, res.batch)["plan"]
        per_decode = {}
        if wrapper is flooding_decode_cuda:  # host and device µs a decode
            x = make_inputs(**cfg, device=dev, seed=0)
            per_decode = time_decode(x.graph, x.llr, x.kw)[0]
            del per_decode["plan"], x
        emit("flooding_bench", kernel=key, code=cfg["code"],
             decoder=cfg["decoder"], plain_ms=flood_parity[key]["plain_ms"],
             plan=flood_plans[key], **per_decode,
             **bench_line(res, flood_launches[key], smi_before))
        if flood_launches[key] <= 0:
            raise AssertionError(f"{key}: the kernel never launched")
        if cfg["code"] == "mackay1008" and not (
                res.frame_errors / res.batch <= MACKAY_FER_MAX):
            raise AssertionError(f"{key}: FER above {MACKAY_FER_MAX}")
        flood_bench[key] = res

    # 14. the mackay1008 sweep against the golden curves; K2's count read
    # around the spa/50 sweep, the path that decodes with it in a sweep
    for dec_spec, path in GOLDEN_MACKAY.items():
        with open(path) as f:
            golden = [PointResult.from_json(d) for d in json.load(f)
                      if d["decoder"] == dec_spec]
        flooding_decode_cuda.launches = 0
        t0 = time.perf_counter()
        swept = run_sweep(SweepSpec(
            code="mackay1008", decoder=dec_spec, ebn0_db=MACKAY_SWEEP_EBN0,
            batch=4096, stopping=StoppingRule(min_frame_errors=100,
                                              max_frames=65536)), device=dev)
        if dec_spec == "spa/50":
            flood_launches["flooding:spa"] = flooding_decode_cuda.launches
        overlap = curves_overlap(swept, golden, "fer")
        for pr in swept:
            g = next(q for q in golden if abs(q.ebn0_db - pr.ebn0_db) < 1e-9)
            emit("mackay_vs_golden", decoder=dec_spec, **point_line(pr),
                 golden_fer=g.fer, golden_fer_ci=g.fer_ci, golden=path.name)
        emit("mackay_vs_golden", decoder=dec_spec, overlap=overlap,
             launches=flooding_decode_cuda.launches,
             seconds=time.perf_counter() - t0)
        if not overlap:
            raise AssertionError(f"{dec_spec}: mackay1008 FER misses "
                                 f"{path.name}")

    # 15. the floor program's first production decoder, with the flooding
    # fallback, through the CLI: counts from this run only
    layered_decode_cuda.launches = 0
    flooding_qc_decode_cuda.launches = 0
    flooding_qc_decode_cuda.frames = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "production_flooding.json"
        t0 = time.perf_counter()
        rc = cli_main([
            "sweep", "--code", FLOODING_PRODUCTION_SWEEP["code"],
            "--decoder", FLOODING_PRODUCTION_SWEEP["decoder"],
            "--ebn0", str(FLOODING_PRODUCTION_SWEEP["ebn0_db"]),
            "--batch", str(FLOODING_PRODUCTION_SWEEP["batch"]),
            "--min-frame-errors", "1000000",
            "--max-frames", str(PRODUCTION_FRAMES), "--out", str(out)])
        wall = time.perf_counter() - t0
        (prod,) = [PointResult.from_json(d)
                   for d in json.loads(out.read_text())]
    flood_sweep = {"layered_qc": layered_decode_cuda.launches,
                   "flooding_qc": flooding_qc_decode_cuda.launches}
    emit("production_flooding", decoder=prod.decoder, rc=rc,
         **point_line(prod), seconds=wall, launches=flood_sweep,
         frames_to_fallback=flooding_qc_decode_cuda.frames)
    if rc != 0 or prod.frames != PRODUCTION_FRAMES:
        raise AssertionError(f"flooding production sweep: rc {rc}, "
                             f"{prod.frames} frames")
    if not prod.fer <= PRODUCTION_FER_MAX:
        raise AssertionError(f"flooding production FER {prod.fer} above "
                             f"{PRODUCTION_FER_MAX}")
    if flood_sweep["flooding_qc"] <= 0 or flooding_qc_decode_cuda.frames <= 0:
        raise AssertionError("the flooding fallback never ran")
    if flood_sweep["layered_qc"] <= 0:
        raise AssertionError("the production primary never launched")
    flood_launches["flooding_qc:spa"] = flood_sweep["flooding_qc"]
    production = FLOODING_PRODUCTION_SWEEP["decoder"]
    graph = choose_graph(spec12, production)
    llr = torch.as_tensor(trap["llr"], device=dev)
    cw = torch.as_tensor(trap["cw"], device=dev)
    primary = get_decoder(graph, production.split(";retry=")[0],
                          device=dev)(llr)
    retried = get_decoder(graph, production, device=dev)(llr)
    emit("production_flooding_trap", frames=len(cw),
         primary_ok=int(primary.ok.sum().item()),
         retry_ok=int(retried.ok.sum().item()),
         retry_exact=bool(torch.equal(retried.bits, cw)),
         iterations=retried.iterations.tolist())
    if bool(primary.ok.any()):
        raise AssertionError("the primary decodes a stored trap frame")
    if not (bool(retried.ok.all()) and torch.equal(retried.bits, cw)):
        raise AssertionError("the flooding retry misses a trap codeword")

    kernels_ccsds = ccsds_path(dev, spec12, k3, flood_err, k3_lines)
    kernels_xor = xor_path(dev, k3_lines)
    # phases 23, 24, 34 and 49 read the lines of one launch of ranks
    rank_dir = tempfile.TemporaryDirectory()
    rank_out = pathlib.Path(rank_dir.name)
    rank_jobs(rank_out)
    kernels_dist = dist_path(dev, rank_out)

    hl = results["headline"]
    kernels = [{
        "name": "layered_qc",
        "route": "cuda",
        "source": "ecc_ldpc_tpu_torch/csrc/layered_qc.cu",
        "replaces": "ecc_ldpc_tpu/decode/pallas/layered_qc.py:146",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": hl.wall_s_per_batch * 1e3,
        "plain_ms": leg_parity["headline"]["plain_ms"],
        "bound_ms": hl.bound_ms,
        "bound_by": hl.roofline_form,
        "library_ms": None,
        "plan": leg_plans["headline"],
    }]
    for cn in ("spa", "minstar"):
        res = exact_bench[cn]
        kernels.append({
            "name": f"layered_exact:{cn}",
            "route": "cuda",
            "source": "ecc_ldpc_tpu_torch/csrc/layered_exact.cu",
            "replaces": "ecc_ldpc_tpu/decode/pallas/layered_qc.py:501",
            # spa: the production sweep (the retry fallback); minstar: its
            # own timed run, the only path that decodes with it
            "launches": (sweep_launches["layered_exact"] if cn == "spa"
                         else exact_bench_launches[cn]),
            "max_abs_err": exact_err[cn],
            "ms": res.wall_s_per_batch * 1e3,
            "plain_ms": exact_parity[cn]["plain_ms"],
            "bound_ms": res.bound_ms,
            "bound_by": res.roofline_form,
            "library_ms": None,
            "plan": exact_plans[cn],
        })
    # K2's minsum count is its leg's (the benchmark's mackay1008 path), spa's
    # the spa/50 golden sweep's, minstar's its own timed run's; K3's spa
    # count is the production sweep's fallback, minsum's and minstar's
    # their timed legs'
    sources = {"flooding": ("ecc_ldpc_tpu_torch/csrc/flooding.cu",
                            "ecc_ldpc_tpu/decode/pallas/fused_mm.py:151"),
               "flooding_qc": ("ecc_ldpc_tpu_torch/csrc/flooding_qc.cu",
                               "ecc_ldpc_tpu/decode/pallas/flooding_qc.py:85")}
    for key, res in flood_bench.items():
        src, replaces = sources[key.split(":")[0]]
        kernels.append({
            "name": key,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": flood_launches[key],
            "max_abs_err": flood_err[key],
            "ms": res.wall_s_per_batch * 1e3,
            "plain_ms": flood_parity[key]["plain_ms"],
            "bound_ms": res.bound_ms,
            "bound_by": res.roofline_form,
            "library_ms": None,
        })
        kernels[-1]["plan"] = flood_plans[key]
    kernels += kernels_ccsds + kernels_xor + kernels_dist
    fam = families_path(dev, {k: v["ptxas"] for k, v in built.items()})
    # the families' path adds its launches (phases 28-29) and its errors
    # (phase 26) to the kernels that decode it; the 64-wide instances
    # (phase 27) take entries of their own
    family_path = {"layered_qc": "layered_qc",
                   "layered_exact:spa": "layered_exact",
                   "flooding_qc:spa": "flooding_qc",
                   "flooding:minsum": "flooding"}
    for k in kernels:
        k["max_abs_err"] = max(k["max_abs_err"],
                               fam["errs"].get(k["name"], 0.0))
        if k["name"] in family_path:
            k["launches"] += fam["launches"][family_path[k["name"]]]
    kernels += fam["wide"]
    # phases 30-34: the wide builds' entries of their own; the G cache's
    # K1b launches, the modem sweeps' K1a and K2 launches and the sharded
    # modem sweep's K1a and K5 launches (rank 0) added to their kernels
    wide_rows = wide_rows_path(dev, {k: v["ptxas"] for k, v in built.items()})
    added = gcache_path(dev)
    channels_path(dev)
    for k, v in modem_sweeps_path(dev).items():
        added[k] = added.get(k, 0) + v
    for k, v in modem_dist_path(rank_out).items():
        key = "layered_qc" if k == "layered_qc" else "ring"
        added[key] = added.get(key, 0) + v
    # phases 35-38: the precision cases (comparisons, not counted), each
    # timed leg's launches (36), then K1a's launches in 37-38 by precision:
    # the f32 ones to the f32 min-sum entry, the others to K1a's entry of
    # their precision
    prec = precision_kernels_path(dev)
    precision = precision_timed_path(
        dev, {k: v["ptxas"] for k, v in built.items()}, prec["parity"],
        prec["errs"])
    k1a = collections.Counter(layered_decode_cuda.launches_by_precision)
    precision_curves_path(dev, f32_golden_run)
    bitflip_path(dev)
    cleanup_path(dev)
    crc_path(dev)
    k1a = collections.Counter(layered_decode_cuda.launches_by_precision) - k1a
    for k in precision:
        if k["name"] == "layered_qc":
            k["launches"] += k1a[k["precision"]]
    added["layered_qc"] = added.get("layered_qc", 0) + k1a["f32"]
    # phases 39-42: each phase's K1a and K2 launches (counts zeroed before
    # each and read after it; K1a all f32)
    for path in (learn_path, findsnr_path, trap_path, bench_path):
        for k, v in path(dev).items():
            added[k] = added.get(k, 0) + v
    for k in kernels:
        k["launches"] += added.get(k["name"], 0)
    kernels += wide_rows["wide"] + precision
    # phases 43-49: the new instances' entries of their own (43-46); the
    # goldens' K4 bf16 launches (47), /xla-mm's K2 launches (48) and the
    # graph-parallel tiers' K5 launches on rank 0 (49) added to theirs
    ptxas = {k: v["ptxas"] for k, v in built.items()}
    kernels += multi_edge_path(dev, ptxas)
    kernels += pallas_legs_path(dev, ptxas, pallas_kernels_path(dev))
    added = pallas_goldens_path()
    for k, v in xla_mm_path(dev).items():
        added[k] = added.get(k, 0) + v
    for k, v in graph_parallel_path(rank_out).items():
        added[k] = added.get(k, 0) + v
    rank_dir.cleanup()
    for k in kernels:
        if "precision" not in k or k["name"].endswith(k["precision"]):
            k["launches"] += added.get(k["name"], 0)
    # phases 50-51: the experiments' kernels, entries of their own
    exp_parity = experiments_kernels_path(dev)
    kernels += experiments_entries(exp_parity, *experiments_mains_path(dev))
    if any(k["launches"] <= 0 for k in kernels):
        raise AssertionError("a kernel of the path never launched")
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    adopt_orphans()
    signal.signal(signal.SIGTERM, _terminated)
    try:
        rc = main()
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        left = stop_children()
        if left:
            print(json.dumps({"phase": "stopped", "processes": left}),
                  file=sys.stderr, flush=True)
    sys.exit(rc)
