#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; none catches its own failure, so any failure exits
non-zero before the last line:

  1. card: the `nvidia-smi` name and power limit;
  2. build: every CUDA kernel (`build.KERNELS`: prox_update,
     flash_attention, decode_attention, decode_attention_paged, rwkv6_scan,
     rwkv6_scan_bwd, rglru_scan with its backward), compiled from the
     sources
     in this checkout, all at once (the old libraries are removed
     first), with ptxas's registers and spills, and for every
     instantiation of the flash, decode, paged decode, WKV and RG-LRU
     kernels its registers, spills and static shared bytes, beside the
     dynamic shared bytes a launch asks for;
  3. kernels: each kernel against its plain PyTorch version at its main
     path's shapes and one larger case, with timings (device time from
     torch.profiler, and CUDA events around back-to-back calls, which
     add the host's gaps), the card's lower bound and, for attention,
     PyTorch's scaled_dot_product_attention as the yardstick; flash also
     at S = 17 (a cut 16-row fragment) and S = 65 under a window of 40
     (edges inside a tile), decode also with rows at the chunk and tile
     edges (lengths 0, 1, 63, 64, 65, R, R + 1 and T = 700 for chunks of
     R = split_rows rows), each decode case with its split_rows and
     split count;
  4. training main path: `repro_torch.launch.train` at full qwen2-0.5b
     width, A=4 agents, M=2 walks, 3 supersteps, with every kernel launch
     count reset just before and read just after;
  5. training reference: the smoke config in f32 for 2 supersteps on the
     card and on the CPU (plain versions) from one state, which must
     agree;
  6. training profile: 1 more superstep under torch.profiler (2 until
     phase 49 came; cut for time), device time by kernel, the device's
     busy share and the host's op calls, read from the raw events (the
     host's self time, which needs `key_averages()`'s grouping, went for
     time when phase 50 came);
  7. serving main path: `repro_torch.launch.serve` at full qwen2-0.5b
     width (16 requests, max_batch 8, prompts of 200, budgets 16/64) at
     the engine's default, overlapped admission (fused mixed steps ran,
     first tokens resolved deferred), counts reset just before and read
     just after (24 flash launches per admission, 24 decode launches per
     decode step, mixed or not), every request served to its budget, and
     two requests re-served alone giving the same tokens;
  8. serving reference: the smoke config in f32, prefill_into_slot and 8
     decode_rows steps on the card and on the CPU from one set of
     parameters, which must agree;
  9. serving profile: 8 steady decode steps at full width under
     torch.profiler, on the arena and on the paged pool (the engine's
     default; the arena's admissions ride the 7 steps after the first,
     so the profiled steps are pure decode): device time by kernel,
     launches per step, busy share (and its estimate without the
     profiler, from 8 unprofiled steps);
 10. paged kernels: the paged and ring decode kernels against their
     plain versions in f32 and bf16 at the paged serving shape and a
     large one, timed as in phase 3 (gather + SDPA beside them, as no
     single PyTorch call computes paged attention), with a ring at
     window 256 (rows unwrapped, part-filled and wrapped) that must be
     bitwise invariant under a joint rotation of table and starts, and
     an identity table that must reproduce the linear decode kernel
     within one bf16 ulp (whether it does so bitwise is printed); each
     case with its split_rows and split count, and bitwise invariant to
     the table's width (W against 2W, the extra entries null), to the
     batch (each row alone) and to a second call, the shared ticket
     counters back at 0 after every launch; ptxas's registers, spills and
     shared bytes of paged_fwd;
 11. paged serving main path: `repro_torch.launch.serve --paged` at full
     width on phase 7's workload (block size 16, chunks of 32),
     overlapped as phase 7, counts
     reset just before and read just after (24 paged launches per decode
     step, no linear decode launch), every block returned; then the same
     requests in a block-scarce pool under "recompute" (preempting
     exactly as often as the same run at smoke size on the CPU, with the
     unpreempted run's tokens) and under "reserve" (never preempting);
 12. ring-paged serving: a full-width model with a 256-token window
     through `Engine(paged=True)` (overlapped), 12 prompts of 200 in 8
     rows, budgets 80 and 160 alternating (160 and 320 until phase 49
     came; cut for time), so every ring wraps and the
     four later admissions ride decode steps of full rings (24 ring
     launches per step, no more blocks in use than once the first rings
     were full, every block returned);
 13. paged reference: the smoke config in f32 on the card and on the CPU,
     paged, paged with preemption and ring-paged: logits within 1e-4,
     equal tokens, equal preemption counts;
 14. WKV kernel: the rwkv6_scan library built (phase 2) and its ptxas
     lines, then the kernel against its plain version in bf16 and f32 at
     rwkv6-1.6b's shapes (32 heads of 64, in the model's [B, S, H, hd]
     layout): a 200-token prefill, a decode step of 8 rows from a random
     state, a 4096-token prompt, also run in 8 pieces with the state
     carried, which must equal one pass bitwise, a chunk boundary (S =
     128), one S on each side of the chunked body's threshold, head_dim
     32, and strong decays (w0 = 0, +1, +2, held to the reference's
     chunked-form bound of 1e-3); each case with its body and device
     launches a call; timed as in phase 3;
 15. RWKV6 serving main path: `repro_torch.launch.serve --arch
     rwkv6-1.6b` at full width on phase 7's workload, counts reset just
     before and read just after (24 rwkv6_scan launches per admission and
     per decode step, no attention kernel; beside them the device launches
     its bodies make), every prompt prefilled at its
     exact length, every request served to its budget, and two requests
     re-served alone giving the same tokens;
 16. RWKV6 reference: the smoke config in f32 on the card and on the CPU
     from one set of parameters: prefill_into_slot (one prompt of 100
     tokens, so the chunked body), a readmission over a
     used slot and 8 decode_rows steps (logits within 1e-4, states within
     1e-4 + 1e-5 of their size), and an engine whose tokens must be equal;
 17. RWKV6 serving profile: 8 steady decode steps at full width under
     torch.profiler: device time by kernel, launches per step, busy share,
     and the admission round before them: the WKV kernel's wrapper calls
     and device launches per admission and per step;
 18. RG-LRU kernel and attention at head_dim 256: the fused rglru_scan
     kernel (gate math and recurrence) and its ptxas lines, against its
     plain version (bitwise, bf16 and f32) at recurrentgemma-2b's width
     (2560): a 200-token prefill, a decode step of 8 rows from a random
     state, and a 4096-step prompt, also in 8 pieces with the state
     carried, which must equal one pass bitwise;
     flash prefill with 10 query heads of 256 over 1 kv head (200 tokens,
     and 3,000 under the 2048-token window, which binds) and grouped
     decode at G * hd = 2560 (a 512-slot ring, lengths spread, a full
     2048 ring, and rows at the chunk edges of T = 2100) against their
     plain versions, beside SDPA, and flash at S = 17; timed as in phase
     3;
 19. hybrid serving main path: `repro_torch.launch.serve --arch
     recurrentgemma-2b` at full width and depth on phase 7's workload,
     counts reset just before and read just after (18 rglru_scan launches
     per admission and per decode step, 8 flash launches per admission, 8
     decode launches per decode step, no other kernel), every prompt
     prefilled at its exact length, every request served to its budget,
     two requests re-served alone giving the same tokens; then a long
     prompt (3,000 tokens and 32 new ones at capacity 4096), so the
     2048-token ring wraps and the window binds in the prefill kernel;
 20. hybrid reference: the smoke config in f32 (window 32) on the card
     and on the CPU from one set of parameters: prompts past the window,
     a readmission over a used slot and decode steps (logits within 1e-4,
     states within 1e-4 + 1e-5 of their size), engines whose tokens must
     be equal; then recurrentgemma-2b's widths (d_model 2560, 10:1 heads
     of 256, RG-LRU 2560, d_ff 7680) cut to 3 layers and vocab 512;
 21. hybrid serving profile: 8 steady decode steps at full width under
     torch.profiler: launches per step, device ms, busy share, the RG-LRU
     kernel's time per launch in the model, and its wrapper calls and
     device launches per admission and per step;
 22. the serialized scheduler: phase 7's, phase 11's (with its 112-block
     "recompute" arm, which preempts during overlapped admissions) and
     phase 12's workloads through `Engine(..., overlap=False)`, every
     request's tokens equal to the overlapped run's, both arms' tokens/s,
     p50/p99, prefill wait, mixed steps and overlapped admissions;
 23. mixed steps, card against CPU: the smoke config in f32, three
     mixed steps on the arena, the pool and the ring (logits within
     1e-4, equal tokens);
 24. mixed-step profile at full width: one arena mixed step (B = 8, Sp =
     256) and one pool and one ring mixed step (C = 32) beside a decode
     step plus the standalone prefill or chunk on the same state: kernel
     launches per mixed step (24 flash + 24 decode; 24 paged; 24 ring,
     asserted), device launches and ms, and the largest |logit|
     difference of the mixed step's decode rows from a standalone decode
     step (0: the trunk is row-stable), with the ops of
     `attention.MIXED_PER_HALF` per half and shared, beside each shared
     op's row stability;
 25. attention kernels at head_dim 128 against their plain versions, at
     the dense family's main-path shapes: flash over the 256-token
     prompt bucket and decode over 8 arena rows of 512 for
     internlm2-1.8b (16 query heads over 8 kv heads), qwen3-8b (32 over
     8) and nemotron-4-15b (48 over 8), paged decode for qwen3-8b (256
     blocks of 16), timed beside SDPA (gather + SDPA for paged);
 26. the mixed step's row stability (phase 24's report, with each
     norm's f32 mean of squares beside it) at every dense config's
     widths (qwen2-0.5b and those three), on layer 0's random weights,
     swept over the engine's prompt buckets (Sp = 8 ... 512) and the
     pool's chunk of 32 beside B = 1, 4 and 8 decode rows; one JSON line
     (the whole report in build/row_stability_sweep.json), failing
     if an op the mixed step shares between its halves is not
     row-stable at some shape;
 27. dense serving: the three at full width through
     `repro_torch.launch.serve` on phase 7's workload with budgets 8/32
     (DENSE_SERVE_ARGS; 16/64 until phase 49 came), internlm2-1.8b at
     full depth, qwen3-8b and nemotron-4-15b cut to DENSE_CUT_LAYERS
     (4, as dbrx and deepseek; full depth until phase 50 came, cut for
     time), qwen3-8b also on phase 11's pool, each overlapped and then
     serialized: one flash launch per layer an admission and one decode
     (paged) launch per layer a step (24, 4, 4), every budget served,
     every block
     returned, tokens equal between the schedulers request by request,
     peak memory;
 28. dense reference: phases 8 and 23 on the three smoke configs (card
     against CPU, f32, logits within 1e-4, equal tokens);
 29. dense training: one superstep of internlm2-1.8b at full width cut
     to 2 layers (phase 4's settings, bf16 compute; one prox launch a
     leaf), the same in f32 card against CPU at A=2, M=1, and one of
     nemotron's smoke config on bf16 parameters, card against CPU;
 30. DP baseline main path: `repro_torch.launch.train --baseline` at full
     qwen2-0.5b width with phase 4's settings (global batch 8 x 256,
     adamw, constant 3e-4), 3 steps, counts reset just before and read
     just after (no kernel runs), finite losses, step ms and peak; then
     3 steps at smoke size in f32, adamw and sgd with momentum, card
     against CPU from one set of parameters (loss, params, moments);
 31. long-sequence superstep: `repro_torch.launch.train` at full
     qwen2-0.5b width, A=4, M=2, 2 x 2048 tokens an agent (two K/V
     chunks), remat on, 2 supersteps, counts reset just before and read
     just after (14 prox launches a superstep), superstep ms and peak;
     then one superstep at S = 1024 with remat on and one with it off,
     each with its peak;
 32. windowed training past one chunk: the smoke config in f32 at S =
     1100, window 0 and 300, one superstep card against CPU from one
     state (loss and state within 1e-4), and agent 0's gradient on the
     card with remat on and off against the CPU's;
 33. checkpoints: phase 32's card state and a nemotron smoke state on bf16
     parameters written in the reference's format and loaded into
     templates on the card and on the CPU, bitwise, dtypes kept;
 34. backward kernels: the WKV backward (`csrc/rwkv6_scan_bwd.cu`) and the
     RG-LRU backward (`rglru_bwd` in `csrc/rglru_scan.cu`) and their
     ptxas lines, each against its plain version (`ref.rwkv6_bwd`,
     `ref.rglru_gated_bwd`) in bf16 and f32, with a repeat that must be
     bitwise, timed as in phase 3 beside its bound: WKV at rwkv6's
     training shape (B 2, H 32, S 256, hd 64), S = 16, hd 32 and strong
     decays; RG-LRU at B 2, S 256, W 2560 and S = 3;
 35. rwkv6-1.6b training: 3 API-BCD supersteps at full width, depth cut
     to 2 of 24 layers, A=4, M=2, B=2, S=256, bf16 compute, counts reset
     before and read after each superstep (per agent and recurrent
     layer one backward launch and, with remat, two forward launches;
     one prox launch a leaf), superstep ms and peak;
 36. recurrentgemma-2b training: the same at full width cut to 3 of 26
     layers (rglru, rglru, attn) at A=2, M=1 (A=4, M=2's state alone
     would be ~121 GB);
 37. both families through `repro_torch.launch.train --smoke` on the card
     (API-BCD, then `--baseline`), then one f32 superstep and one
     DP-baseline step at smoke size, card against CPU;
 38. the MoE family (dbrx-132b), smoke config in f32, card against CPU
     from one set of parameters: exact-length prefill and 8 decode steps
     (logits within 1e-4), an engine with a mid-flight admission (equal
     tokens, the serialized arena, prefill shapes the prompt lengths),
     the scatter variant's train_loss (within 1e-4), then phase 37's
     training checks (aux > 0 through the CLI; one prox launch a leaf);
 39. dbrx-132b served at full width cut to 4 of 40 layers (bf16, 28.5
     GB) through `repro_torch.launch.serve --layers 4` on phase 7's
     workload: the serialized arena, exact-length prefill, 4 flash
     launches an admission and 4 decode launches a step and no other
     kernel, every budget served, the init's and the run's peaks; two
     requests re-served alone with the same tokens, one decode step over
     8 rows repeated bitwise on a copy of its arena, the slots that the
     admissions drop at capacity (the port's routing on each layer's
     input, apart from the run), each MoE layer's decode ms against its
     bound (its expert weights read once, 1.89 ms), `launch.serve --arch
     dbrx-132b --smoke`; then flash at 48 query heads over 8 kv heads of
     128, S = 200, against its plain version and SDPA, timed as phase 25
     (8 steady decode steps profiled as phase 9 until MoE and MLA came to
     the model axis; cut for time);
 40. MLA in f32, card against CPU from one set of parameters: deepseek-
     v2-236b's smoke config (MLA over the MoE with a shared expert) as
     phase 38 holds dbrx's (exact-length prefill and 8 decode steps, a
     mid-flight admission on the serialized arena, then phase 37's
     training checks: the CLI with aux > 0, one superstep and one DP
     step, one prox launch a leaf); tests/test_server.py's dense MLA
     stack on the arena and a 6-block pool (preempting), overlapped and
     serialized, every run's tokens equal; with a window of 16 it
     resolves to the serialized arena, tokens equal;
 41. MLA at full width, bf16: deepseek-v2-236b cut to 4 of 60 layers
     (16.94 B parameters, 33.9 GB) through `repro_torch.launch.serve
     --layers 4` on phase 7's workload as phase 39 serves dbrx, but with
     no attention kernel launched (MLA's cores are plain PyTorch, as the
     reference's are jnp), each MLA layer's decode ms against its bound
     (wq_a ... wo and the latent cache read once) beside each MoE
     layer's (2.25 ms); then the dense
     MLA stack at deepseek's widths (4 layers, its d_ff 1536 as a swiglu
     MLP; built here, not registered) from the arena and the pool (256
     blocks of 16, chunks of 32), overlapped and serialized, tokens equal
     between the schedulers, phase 26's row-stability sweep over its
     shared products and norms (build/row_stability_sweep_mla.json),
     its MLA layers' decode ms, and two bf16 supersteps at 2 layers, A=2,
     M=1, 2 x 256 tokens (one prox launch a leaf each, ms, peak); both
     models' 8 profiled decode steps were cut for time when MoE and MLA
     came to the model axis;
 42. the attention kernels at whisper-small's and phi-3-vision's shapes,
     bf16, against their plain versions and timed as phase 3 (SDPA with
     is_causal=False beside the non-causal cases): flash non-causal over
     whisper's encoder (1500 x 1500, 12 heads of 64) and cross-attention
     prefill (200 over 1500), S = T = 17 and S = 65 over T = 130 (hd 96),
     flash causal at hd 96 (1224 tokens, 32 heads); decode over the cross
     K/V (8 rows of 1500, G = 1) and at hd 96 (8 rows over 1280); paged
     and ring at hd 96 with phase 10's bitwise checks; the ptxas lines of
     every hd 96 instantiation are printed in phase 2 ("hd96_ptxas");
 43. whisper's smoke config in f32, card against CPU from one set of
     parameters: encode, a prefill and 8 decode steps (logits within 1e-4,
     equal tokens; 3L flash launches a prefill, 2L decode launches a
     step), train_loss and one API-BCD superstep (phase 37's rule);
 44. whisper-small at full width and depth through `repro_torch.launch.
     serve --arch whisper-small` (the raw loop: 8 requests, prompts of 32,
     64 new tokens): 36 flash launches for the prefill, 24 decode
     launches a step, no other kernel, peaks; then 3 API-BCD supersteps at
     A=4, M=2, 128 tokens over 1500 frames an agent (finite losses, one
     prox launch a leaf, ms, peak);
 45. phi-3-vision-4.2b: its smoke config in f32 with head_dim 96, card
     against CPU (patches, prefill and 8 decode steps, within 1e-4, equal
     tokens); full width and depth through the raw loop (8 requests,
     1024 patches + prompts of 200, 64 new tokens: 32 flash launches at hd
     96, 32 decode launches a step, the init's and the run's peaks); full
     width cut to 4 layers, text-only, through the engine on phase 7's
     workload (arena and pool, overlapped and serialized, equal tokens),
     phase 26's row-stability sweep at its widths
     (build/row_stability_sweep_phi3.json); 3 supersteps at 2 layers, A=2,
     M=1, 1024 patches + 128 tokens an agent;
 46. the convex reference in float64 (`repro_torch.core`), each figure of
     `repro_torch.examples.decentralized_lsq` (Figs. 3-6: cpusmall N=20,
     cadata N=50, ijcnn1 N=50 on 10,000 rows, USPS N=10 on 2,000) at the
     example's data size: WPG, I-BCD, API-BCD and gAPI-BCD for 50
     run_serial activations and DGD for 5 rounds on the card and on the
     CPU, within 1e-9 of max |x|; then every method through
     simulate_incremental on the card (Figs. 3-4 in full, the Newton
     methods of Figs. 5-6 cut to NEWTON_CUT, the cut printed), each
     trace's metric past its start, with updates/s, host ms an update,
     device ms and launches an update under torch.profiler over 5
     updates and the busy share; DGD through simulate_gossip; no kernel
     of the port launches;
 47. the async trainer (`repro_torch.dist.async_*`) on Fig. 3's problem
     (cpusmall, N=20, all 8,192 rows, API-BCD tau 0.1, M=2): an update's
     clock with and without the wait the worker adds (host ms, device ms
     and launches); `run_threaded` with 4 workers (local steps 4, max
     delay 2, adaptive, mid-round, speeds 1, 3, 1, 1, a 10 ms floor) on
     the card twice and on the CPU once: equal integer trace columns,
     tokens and objectives within 1e-9, equal digests on the card and in
     its repeat; then `python -m repro_torch.launch.train_async
     --processes 4` on the card for the arms of
     benchmarks/bench_async_bcd.py (ASYNC_RUNS: lockstep over tcp,
     async+mid over tcp and file, async, async+mid+measured; its repeat
     and lockstep's file run cut for time since phase 49 came), each
     run's 4 digests equal, tcp equal to file, staleness and
     view lag within 4; wall s, updates/s, waits, each process's update
     EMA and peak, the time to lockstep's final objective and the
     speed-ups (printed, not gated); one logistic run (ijcnn1, N=50,
     10,000 rows, cut to 4 rounds x 3 local steps) with equal digests
     and an objective below its start; no kernel of the port launches.
 48. cost accounting (`repro_torch.utils.roofline.StepCost`,
     `repro_torch.launch.dryrun`): the A=4, M=2 qwen2-0.5b superstep at
     2 x 256 tokens an agent, an 8-row qwen2 decode step with every row
     at a capacity of 512, a 2048-token qwen2 prefill (flash) and an
     8-row rwkv6-1.6b decode step (the WKV kernel), each counted on the
     card and held equal to the dry run's count on fake tensors (FLOPs by
     unit and bytes, exactly, and each kernel's calls); each timed
     unprofiled (host clock to synchronize) and profiled (device ms from
     raw events), with its roofline bound and the term that sets it, the
     roofline share (bound / device ms), mfu (model FLOPs / (wall s x
     peak)) and max_memory_allocated beside the dry run's argument bytes;
     the host cost of the count check with no count open; then
     `repro_torch.examples.train_lm_apibcd --preset paper --steps 12`
     (its 300 steps cut to 12; 30 until phase 49 came, 20 until its TP
     arm came), which must print
     "(improved)", and
     `repro_torch.examples.serve_batched --arch qwen2-0.5b`, every request
     to its budget.
 49. the superstep across processes (`dist.trainer.make_mesh_train_step`
     through `repro_torch.launch.train --processes 4 --backend gloo`, its
     parent run in this process through the module's `main` and its ranks
     spawned as `python -m`, every rank on this one card):
     `ops.prox_update` at the TP arm's two piece shapes ([1, 75968, 896]
     of the embedding, [1, 24, 896, 2432] of w_gate; the R=2 shards at
     full depth too) against its plain version; then phase 4's run (full
     qwen2-0.5b width cut to 4 layers, A=4, M=2, 2 x 256 tokens an agent,
     3 supersteps; full depth until the TP arm came) as 4 ranks of R=1,
     each rank's per-part digests equal to its agent slot of the
     one-process make_train_step run from the same init and batches (made
     here first, then freed); then A=2, M=1 as 2 agents x 2 replicas at
     the config's bf16 (4 layers; full depth until the TP arm came), each
     rank's digests equal to its shard of the one-process run with each
     agent's gradient split over the replicas' rows as the mesh splits it;
     that split run in f32, made here, held to make_train_step in f32 at
     atol 1e-5; then TP: A=2, M=1 as 2 agents x model parallel 2
     (`--model-parallel 2`) at full width and depth in bf16, its checks
     first (4 ranks of this script with `--train-mesh-rank`: the arm's
     bf16 run, whose losses must equal the launch's bitwise and whose
     gathered leaves are kept, then an f32 run at 4 layers, each rank's
     piece within 1e-5 of its cut of the R2 arm's one-process f32
     make_train_step (the same run), while this process makes the
     one-process f32 and bf16 runs at full depth), then the launch: the
     4 ranks' losses equal, the leaves the model axis does not split
     bitwise equal across each model line, the
     mesh's bf16 losses and gathered params no farther from one process's
     f32 run than 1.25 x one process's own bf16 gap to it (both printed);
     every rank's bytes sent by kind equal to `trainer.superstep_sends`
     (on the TP arm with the model axis's sums: the forward's, remat's
     replay, the backward's), 14 prox launches a superstep; per rank the
     superstep ms, the token hop's ms, the model axis's ms, the bytes sent
     and the peak GB, with the card's name and power limit, and the
     phase's seconds.
 50. serving across processes, the data axis too (`Engine(mesh=...)`,
     `dist.serving` with its `RowSplit`, `dist.tensor_parallel`): flash,
     decode, paged and ring decode against their plain versions at a
     rank's shard of qwen2-0.5b at model parallel 2 (7 query heads over 1
     kv head of 64; decode, paged and ring also at a data line's 2 of the
     4 rows) and of internlm2-1.8b (8 over 4 of 128); then the checks'
     four ranks (this script with `--serve-mesh-rank`, all on this one
     card over gloo, full qwen2-0.5b width and depth) serve the first 4
     of the workload's requests at 16 new tokens in f32 on the arena and
     take the first decode step's logits in bf16 and f32, first on the
     ("data", "model") = (1, 2) mesh (each data line a mesh of its own,
     side by side: the tokens on one; the logits, then the same requests
     on the pool in 2 rows at 4 layers, on the other; both engines
     through the fused mixed step that "auto" picks there), then on
     (2, 2), while this process takes the same on one process from the
     same init; then `repro_torch.launch.serve_mesh --processes 4
     --model-parallel 2 --backend gloo --layers 4` on (2, 2) (its parent
     in this process; full width, 4 of its 24 layers), all ranks on this
     one card, 8 requests of 64-token prompts, budgets 4/16 (8/32 until
     the data axis came), max_batch 4 (2 rows a data line), arms arena
     and paged, each overlapped ("async", which "auto" picks on a data
     axis) and serialized, in bf16 (each arm a replayed warm-up, then the
     timed pass; the (1, 2) launch ran until the data axis came). Held: the
     ranks' digests equal in every arm, overlapped equal to serialized on
     each backend; each mesh's f32 tokens equal to the one-process f32
     engine's (the (1, 2) pool's to its pool's), each (1, 2) engine with
     mixed steps; its first decode step's f32 logits within 1e-4 of the
     largest |logit| of one process's, its bf16 logits no farther from
     one process's f32 logits than one process's own bf16 logits are
     (bf16's own error at this width, measured here: 0.0186 of the
     largest |logit| on the card; the gap to one process's bf16 logits is
     printed); every launch rank's bytes by kind equal to
     `dist.serving.serve_step_sends` (the model axis's sums and the data
     axis's gathers of ids); on every rank of the launch and of the
     (1, 2) lines a flash launch a layer an admission its data line
     prefilled (arena), a decode or paged launch a layer a decode step
     and no other. Printed: per rank the decode step and admission ms,
     tokens/s, the axes' ms a step (model and data), bytes a decode step
     and the peak GB, with the card's name and power limit, and the
     seconds of the phase, its check ranks and its launch. MoE and MLA on
     the model axis (in the check ranks, after the qwen2 meshes): flash
     and decode at dbrx-132b's rank shard (24 query heads over 4 kv heads
     of 128 at model parallel 2; the prompt length 64, 4 rows of 128)
     against their plain versions; then each (1, 2) check line serves one
     family at full width, cut to 1 layer: line 0 dbrx-132b (its 16
     experts 8 to a rank, GQA on the rank's heads), line 1
     deepseek-v2-236b (its 160 experts 80 to a rank, its shared experts'
     columns, MLA's 128 heads 64 to a rank over the whole latent cache),
     each rank drawing only its piece (`tensor_parallel.init_shard`, the
     whole leaf freed before the next), the first decode step's bf16
     logits, then in f32 the workload's tokens (`Engine(mesh=...)`, the
     serialized arena at exact prompt lengths) and logits; once every
     rank has freed its piece, each line's first rank takes one
     process's whole model through the same. Held as the qwen2 lines:
     the f32 tokens equal one process's, the f32 logits within 1e-4, the
     bf16 logits no farther from one process's f32 than one process's
     own bf16; on dbrx's line a flash launch a layer an admission and a
     decode launch a layer a decode step, on deepseek's none, and no
     other. Printed: each rank's init and serving seconds and peak GB,
     and one process's. The recurrent families and the encoder-decoder
     on the model axis (after the MoE cases, and in the check ranks after
     each line's MoE family): the WKV scan on rwkv6-1.6b's 16 heads
     (prefill S = 64 and 200, decode), the RG-LRU scan on
     recurrentgemma-2b's 1280 channels (prefill, decode), flash and
     decode on its MQA shard (5 query heads over the one kv head of 256,
     its 2048 window) and on whisper-small's 6 heads (the encoder's
     non-causal flash over 1500 frames, decode over the cross K/V)
     against their plain versions; then line 0 serves recurrentgemma-2b
     (3 layers: rglru, rglru, attn) and whisper-small (1 encoder and 1
     decoder layer, 1500 frames), line 1 rwkv6-1.6b (1 layer) and
     phi-3-vision-4.2b (1 layer, 1024 patches), the recurrent families
     through `Engine(mesh=...)` on the arena as above, whisper and phi-3
     through the ported wave steps (`dist.serving.make_prefill_step` /
     `make_decode_step`: the raw loop's batch of 4 prompts of 64 tokens,
     16 greedy steps), each against one process's whole model. Held:
     the f32 tokens equal one process's, the f32 logits within 1e-5, the
     bf16 logits no farther from one process's f32 than 1.25x one
     process's own bf16 gap (phase 49's rule), and on every rank, as in
     one process, a flash launch an attention layer an admission (three
     a whisper prefill: encoder, self, cross), a decode launch one a
     step (two a whisper step), a WKV or RG-LRU launch a recurrent layer
     an admission and a step, and no other.

Each phase line prints the seconds since the start. Then it prints the `kernels` JSON line and, last, the `ok` JSON line.

    python3 chip_smoke.py --mesh-only nccl

runs phases 1, 2 (prox_update, the attention kernels and the forward
scans), 49 with `--backend nccl`, one GPU a rank (four GPUs), and 50
over gloo and over nccl (its checks and its launch, one GPU a rank, four
of them), whose digests must be equal, and prints the `ok` line last;
`--mesh-only gloo --serving` runs phases 1, 2 and 50 on one GPU.
(`--serve-mesh-rank BACKEND DIR WORLD MP --rank R --coordinator
HOST:PORT` is one rank of phase 50's checks, `--train-mesh-rank BACKEND
DIR --rank R ...` one of phase 49's TP checks; each phase starts its own
through `launch.mesh.run_ranks`, as `python -m chip_smoke`.)
With no GPU, or without the rest of the repo beside it, it exits
non-zero and prints no result.
"""
import contextlib
import dataclasses
import json
import os
import re
import resource
import subprocess
import sys
import tempfile
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device; this script runs on the card only")

from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.core import (  # noqa: E402
    APIBCD, CyclicWalk, global_objective, hamiltonian_cycle, run_serial,
    simulate_gossip, simulate_incremental)
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.data import DATASETS, make_problem  # noqa: E402
from repro_torch.data.tokens import agent_batches  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.dist.async_schedule import WalkSequence  # noqa: E402
from repro_torch.dist.async_trainer import (  # noqa: E402
    AsyncBCDConfig, run_threaded)
from repro_torch.dist import trainer as dist_trainer  # noqa: E402
from repro_torch.dist.sharding import (local_shard,  # noqa: E402
                                       shard_shape, state_shardings)
from repro_torch.dist.trainer import (  # noqa: E402
    init_train_state, make_dp_baseline_step, make_train_step)
from repro_torch.examples import decentralized_lsq  # noqa: E402
from repro_torch.examples import serve_batched  # noqa: E402
from repro_torch.examples import train_lm_apibcd  # noqa: E402
from repro_torch.kernels import costs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as wkv  # noqa: E402
from repro_torch.kernels import tickets as ticket_pool  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_cuda, num_splits, split_rows)
from repro_torch.kernels.decode_attention_paged import (  # noqa: E402
    decode_attention_paged_cuda, decode_attention_ring_cuda, paged_num_splits,
    paged_split_rows)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda)
from repro_torch.kernels.prox_update import prox_update_cuda  # noqa: E402
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    rglru_scan_bwd_cuda, rglru_scan_cuda)
from repro_torch.kernels.rwkv6_scan import (  # noqa: E402
    rwkv6_scan_bwd_cuda, rwkv6_scan_cuda)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402
from repro_torch.utils import roofline  # noqa: E402

COUNTERS = {"prox_update": prox_update_cuda,
            "flash_attention": flash_attention_cuda,
            "decode_attention": decode_attention_cuda,
            "decode_attention_paged": decode_attention_paged_cuda,
            "decode_attention_ring": decode_attention_ring_cuda,
            "rwkv6_scan": rwkv6_scan_cuda,
            "rwkv6_scan_bwd": rwkv6_scan_bwd_cuda,
            "rglru_scan": rglru_scan_cuda,
            "rglru_scan_bwd": rglru_scan_bwd_cuda}
KW = dict(tau=0.05, rho=20.0, num_walks=2, num_agents=4)   # the CLI's
STEPS = 3
# qwen2-0.5b leaves: embed.table, final_norm.scale and 12 stacked-layer
# leaves (ln1, wq, wk, wv, wo, bq, bk, bv, ln2, w_gate, w_up, w_down)
LEAVES = 14
N_LAYERS = 24           # qwen2-0.5b: one attention kernel launch per layer


# the attention kernels' libraries
ATTENTION_LIBRARIES = ("flash_attention", "decode_attention",
                       "decode_attention_paged")

# the dense configs this script serves at full width besides qwen2-0.5b
DENSE_ARCHS = ("internlm2-1.8b", "qwen3-8b", "nemotron-4-15b")
# phase 27 serves the two largest at this depth (--layers), for time
DENSE_CUT_LAYERS = {"qwen3-8b": 4, "nemotron-4-15b": 4}

SERVE_ARGS = ["--arch", "qwen2-0.5b", "--requests", "16", "--max-batch", "8",
              "--prompt-len", "200", "--new-tokens", "64", "--mixed"]
# phase 27's workload: phase 7's with its budgets halved to 8/32, cut for
# time since phase 49 came (16 requests on 8 rows still admit mid-flight)
DENSE_SERVE_ARGS = SERVE_ARGS[2:-3] + ["--new-tokens", "32", "--mixed"]


def reset_counts():
    for fn in COUNTERS.values():
        fn.launches = 0


def counts():
    return {name: fn.launches for name, fn in COUNTERS.items()}


def main_args(steps, log_every):
    return ["--arch", "qwen2-0.5b", "--agents", "4", "--walks", "2",
            "--steps", str(steps), "--batch-per-agent", "2", "--seq", "256",
            "--log-every", str(log_every)]


DEV = torch.device("cuda")


T0 = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


def event_ms(fn, iters):
    """Mean ms per call of fn() between CUDA events around iters back-to-
    back calls, after one warm-up: device time plus any gap the host
    leaves between launches (the wrapper's checks and allocation)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters):
    """Device ms per call of fn() from CUDA events around `iters` calls
    queued behind a sleep kernel, so that the device runs them back to
    back with no host gap between them (the gaps between back-to-back
    launches stay in). The sleep is sized from one call's host time; if
    the host still took longer to queue the calls than the device slept,
    that is said, and the time includes its gaps."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    slept, start, end = (torch.cuda.Event(enable_timing=True)
                         for _ in range(3))
    slept.record()
    torch.cuda._sleep(int(min(2.0, 2 * host_s * iters + 1e-3) * 2e9))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    queue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if queue_ms > slept.elapsed_time(start):
        print(f"queued_ms: the host took {queue_ms:.3f} ms to queue what the "
              f"device slept {slept.elapsed_time(start):.3f} ms for; host "
              "gaps included", flush=True)
    return start.elapsed_time(end) / iters


PAD_KERNEL = "spin_kernel"     # the kernel of torch.cuda._sleep
PAD_LAUNCHES = 128


def pad_profile():
    """Sleeps that bracket what a profile counts: late in a long run the
    profiler drops device events at a profile's edge (8 to 22 by phase
    18), or every event of a short profile, so a count is taken between
    PAD_LAUNCHES sleeps on each side, which every count leaves out by
    name (PAD_KERNEL)."""
    for _ in range(PAD_LAUNCHES):
        torch.cuda._sleep(100)


def cuda_events(prof):
    """(name, device µs) of every device event of a profile (kernels and
    copies), read from the profiler's raw events: `key_averages()` first
    builds and groups a Python event for every event of the profile,
    which takes seconds for the tens of thousands a step launches."""
    from torch.autograd import DeviceType

    return [(ev.name(), ev.duration_ns() / 1e3)
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == DeviceType.CUDA
            and not getattr(ev, "is_hidden_event", lambda: False)()]


def cuda_rows(prof):
    """[(device ms, count, name)] of a profile's device events by name,
    pad_profile()'s sleeps and events of no duration left out."""
    rows = {}
    for name, us in cuda_events(prof):
        if PAD_KERNEL in name or us <= 0:
            continue
        ms, n = rows.get(name, (0.0, 0))
        rows[name] = (ms + us / 1e3, n + 1)
    return [(ms, n, name) for name, (ms, n) in rows.items()]


def device_launches(fn, calls=50, attempts=6):
    """Device launches a call of fn(), after one warm-up call: each
    kernel's count over `calls` calls in one profile between
    pad_profile()'s sleeps, divided by `calls` and rounded, summed over
    the kernels. A profile that shows a loss reaching fn's events is
    taken again, up to `attempts` times: one that kept no more sleeps
    than one side holds (the loss at an edge may then pass the sleeps),
    or in which a kernel of fn kept fewer than half the events of its
    calls (it rounds to none, though fn launches it once a call or more),
    or no event of fn at all. A loss only lowers a count, so when every
    profile showed one, the largest count is taken, and that is said; it
    raises when no profile recorded an event of fn."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = 0
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad_profile()
            for _ in range(calls):
                fn()
            pad_profile()
            torch.cuda.synchronize()
        by_name = Counter(name for name, _ in cuda_events(prof))
        pads = sum(n for name, n in by_name.items() if PAD_KERNEL in name)
        counts = [n for name, n in by_name.items() if PAD_KERNEL not in name]
        per_kernel = [round(n / calls) for n in counts]
        if counts and all(per_kernel) and pads > PAD_LAUNCHES:
            return sum(per_kernel)
        best = max(best, sum(per_kernel))
        print(f"device_launches: the profile lost events (kept {pads} of "
              f"{2 * PAD_LAUNCHES} sleeps; events of the calls by kernel "
              f"{counts}); again", flush=True)
    if not best:
        raise AssertionError("device_launches: no profile recorded a device "
                             "event of the calls")
    print(f"device_launches: every profile lost events; the largest count, "
          f"{best}", flush=True)
    return best


def device_ms(fn, iters, one_kernel=False, attempts=4, launches=None):
    """Mean device ms per call of fn(): the time of every kernel and copy
    it launched, from torch.profiler's device events (no host gaps), after
    one warm-up. Late in a long run the profiler drops the first device
    events of a profile, a count that grows over the run (12 to 22 by
    phase 18), so for a fn that launches one kernel (`one_kernel`, a
    kernel's wrapper), or `launches` kernels (counted by
    device_launches), the time is the mean per recorded event. A profile
    that recorded no device event is taken again, up to `attempts` times;
    when none did, or one kept fewer than half the events of its calls
    (counted in a profile of one call), the calls are timed queued
    behind a sleep instead (`queued_ms`), and that is said."""
    from torch.profiler import ProfilerActivity, profile

    def device_events(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = cuda_events(prof)
        return sum(us for _, us in events), len(events)

    fn()
    torch.cuda.synchronize()
    per_call = launches or (1 if one_kernel else 0)
    for _ in range(attempts):
        if not per_call:
            per_call = device_events(1)[1]
            if not per_call:
                print("device_ms: the profile recorded no device time; "
                      "again", flush=True)
                continue
        total_us, n = device_events(iters)
        if not total_us:
            print("device_ms: the profile recorded no device time; again",
                  flush=True)
            continue
        if n >= per_call * iters:
            return total_us / 1e3 / iters
        if 2 * n >= per_call * iters:
            print(f"device_ms: the profile kept {n} of {per_call * iters} "
                  "device events; mean per event", flush=True)
            return total_us / 1e3 / n * per_call
        print(f"device_ms: the profile kept {n} of {per_call * iters} "
              "device events; timed queued behind a sleep instead",
              flush=True)
        return queued_ms(fn, iters)
    print("device_ms: torch.profiler recorded no device time; timed queued "
          "behind a sleep instead", flush=True)
    return queued_ms(fn, iters)


def timings(fn, plain, library, iters, one_kernel=True, launches=None):
    """Device ms (profiler) and event ms of fn, of its plain version and of
    the library call (None where there is none); `one_kernel`: fn makes
    one device launch, `launches`: fn makes that many (else its launches
    are counted in a profile)."""
    t = {"kernel_ms": device_ms(fn, iters, one_kernel=one_kernel,
                                launches=launches),
         "event_ms": event_ms(fn, iters),
         "plain_ms": device_ms(plain, 3), "plain_event_ms": event_ms(plain, 3),
         "library_ms": None, "library_event_ms": None}
    if library is not None:
        t["library_ms"] = device_ms(library, iters)
        t["library_event_ms"] = event_ms(library, iters)
    return t


def bf16_ulp(v):
    """Spacing of bf16 values at |v|: 2^(e-8) for |v| = m * 2^e, m in [.5, 1)."""
    _, e = torch.frexp(v.float())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def check_prox_case(label, shape, dtype, gen):
    x = torch.randn(shape, generator=gen, device=DEV).to(dtype)
    g = torch.randn(shape, generator=gen, device=DEV)
    z = torch.randn(shape, generator=gen, device=DEV)
    xn, d = ops.prox_update(x, g, z, **KW)
    torch.cuda.synchronize()
    rxn, rd = ref.prox_update(x, g, z, **KW)
    err_x = (xn.float() - rxn.float()).abs()
    err_d = float((d - rd).abs().max())
    if dtype == torch.float32:
        tol = 1e-6 * float(rxn.abs().max())
        ok = float(err_x.max()) <= tol and err_d <= 1e-6 * float(rd.abs().max())
        rule = "max_abs_err <= 1e-6 * max|x_new| (x_new and delta)"
    else:
        ok = bool((err_x <= bf16_ulp(rxn)).all()) and \
            err_d <= 1e-6 * float(rd.abs().max())
        rule = "|x_new - plain| <= 1 bf16 ulp; delta <= 1e-6 * max|delta|"
    max_err = max(float(err_x.max()), err_d)
    del xn, d, rxn, rd, err_x
    t = timings(lambda: ops.prox_update(x, g, z, **KW),
                lambda: ref.prox_update(x, g, z, **KW), None, 10)
    cost = costs.prox_update(x, g, z)
    nbytes = cost.bytes
    t_bytes, t_ops = bound_terms(cost)
    case = {"case": label, "shape": list(shape), "dtype": str(dtype),
            "max_abs_err": max_err, "tolerance": rule, **t,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes,
            "achieved_GBps": nbytes / t["kernel_ms"] / 1e6}
    print(json.dumps(case), flush=True)
    if not ok:
        raise AssertionError(f"prox_update kernel disagrees with its plain "
                             f"version on {label}: {case}")
    return case


def reference_check():
    """Smoke config in f32, 2 supersteps, card vs CPU from one state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke("qwen2-0.5b"), compute_dtype="float32")
    model = build_model(cfg)
    tcfg = TrainConfig(num_agents=4, num_walks=2)
    cpu = init_train_state(model, tcfg, torch.Generator().manual_seed(0))
    gpu = {part: {k: v.to(DEV, copy=True) for k, v in leaves.items()}
           for part, leaves in cpu.items()}
    step_fn = make_train_step(model, tcfg)
    batches = agent_batches(cfg.vocab_size, 4, 2, 32, seed=1)
    worst = {}
    for step in range(2):
        toks, targs = next(batches)
        b_cpu = {"tokens": torch.from_numpy(toks),
                 "targets": torch.from_numpy(targs)}
        cpu, m_cpu = step_fn(cpu, b_cpu, step)
        gpu, m_gpu = step_fn(gpu, {k: v.to(DEV) for k, v in b_cpu.items()},
                             step)
        np.testing.assert_allclose(float(m_gpu["loss"]), float(m_cpu["loss"]),
                                   rtol=1e-4)
    for part in cpu:
        for k, v in cpu[part].items():
            err = float((gpu[part][k].cpu() - v).abs().max())
            worst[part] = max(worst.get(part, 0.0), err)
    print(json.dumps({"reference_max_abs_err": worst, "tolerance": 1e-4}),
          flush=True)
    # f32 sums run in another order on the card than on the CPU
    if max(worst.values()) > 1e-4:
        raise AssertionError(f"card and CPU disagree: {worst}")


def profile_supersteps():
    """Device time by kernel over 1 superstep of the main path (state
    init included), the device's busy share of the steps' wall time, and
    the host's op calls by name, all read from the profiler's raw events
    (`cuda_events`; `key_averages()` groups a Python event for each of
    the superstep's ~10^5 host and device events first)."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = train_cli.parse_args(main_args(steps=1, log_every=0))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = train_cli.train(args)
    # kernels and copies only: an aten op's row repeats its kernels' time
    rows = sorted(cuda_rows(prof), reverse=True)
    device_ms = sum(ms for ms, _, _ in rows)
    if not device_ms:
        print("profile: no device time recorded (not measured)")
        return
    steps_ms = sum(out["step_ms"])
    host = Counter(ev.name() for ev in prof.profiler.kineto_results.events()
                   if ev.device_type() == DeviceType.CPU)
    print(json.dumps({"profile_1_superstep": {
        "steps_wall_ms": steps_ms, "device_ms_incl_init": device_ms,
        "device_busy_share": device_ms / steps_ms,
        "host_op_calls": sum(host.values()),
        "host_top_calls": [{"count": n, "name": name[:60]}
                           for name, n in host.most_common(8)],
        "prox_update_device_ms": sum(ms for ms, _, name in rows
                                     if "prox" in name),
        "top": [{"ms": ms, "count": n, "name": name[:90]}
                for ms, n, name in rows[:15]]}}), flush=True)


def bf16_close(got, want):
    """|kernel - plain| <= 1 bf16 ulp of plain + 1e-5: both accumulate in
    f32 and round once to bf16, so they land at most one ulp apart, and
    their f32 sums (in another order) differ by ~1e-6 of the O(1) terms,
    which can exceed the ulp of an output near zero."""
    err = (got.float() - want.float()).abs()
    return bool((err <= bf16_ulp(want) + 1e-5).all()), float(err.max())


ATTN_RULE = "|kernel - plain| <= 1 bf16 ulp of plain + 1e-5 (f32 sums in both)"


def bound_terms(cost):
    """(bytes ms, operations ms): a kernel call's `kernels.costs` record
    against the card's memory rate and its units' peaks."""
    return (cost.bytes / roofline.HBM_BW * 1e3,
            roofline.compute_seconds(cost.ops) * 1e3)


def attention_case(name, label, fn, plain, library, cost, iters,
                   dtype=torch.bfloat16):
    """Check fn() against plain() and time fn, plain and the library call;
    `cost`: the call's `kernels.costs` record."""
    got = fn()
    torch.cuda.synchronize()
    ok, max_err = bf16_close(got, plain())
    del got
    t = timings(fn, plain, library, iters)
    t_bytes, t_ops = bound_terms(cost)
    nbytes, flops = cost.bytes, cost.flops
    case = {"case": label, "dtype": str(dtype), "max_abs_err": max_err,
            "tolerance": ATTN_RULE, **t,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
            "achieved_GBps": nbytes / t["kernel_ms"] / 1e6,
            "achieved_TFLOPs": flops / t["kernel_ms"] / 1e9}
    print(json.dumps(case), flush=True)
    if not ok:
        raise AssertionError(f"{name} kernel disagrees with its plain version "
                             f"on {label}: {case}")
    return case


def check_flash_case(label, s, gen, h=14, kv=2, hd=64, window=0,
                     causal=True, t=None):
    """Prefill of one prompt of s tokens over t keys (t = s by default), h
    heads over kv heads of hd (qwen2-0.5b's 14 over 2 of 64 by default),
    bf16, in the model's [1, S, heads, hd] layout, causal (under a sliding
    window if given) or, with causal=False, every query over every key
    (the whisper encoder's and cross-attention's prefill)."""
    bf = torch.bfloat16
    t = t or s
    q = torch.randn((1, s, h, hd), generator=gen, device=DEV).to(bf)
    k = torch.randn((1, t, kv, hd), generator=gen, device=DEV).to(bf)
    v = torch.randn((1, t, kv, hd), generator=gen, device=DEV).to(bf)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window and window < s:
        i = torch.arange(s, device=DEV)
        mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)

        def library():
            return sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    else:
        def library():
            return sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
    case = attention_case(
        "flash_attention", label,
        lambda: ops.flash_attention(q, k, v, causal=causal, window=window),
        lambda: ref.attention(q, k, v, causal=causal, window=window),
        library, costs.flash_attention(q, k, v, causal=causal,
                                       window=window), iters=20)
    return dict(case, shape=[list(q.shape), list(k.shape)], window=window,
                causal=causal)


def check_decode_case(label, b, t, gen, h=14, kv=2, hd=64, full=False,
                      edges=False):
    """One decode step of b rows over [b, t, kv, hd] caches (slices of an
    arena), h query heads (qwen2-0.5b's 14 over 2 of 64 by default), bf16,
    lengths spread over 1..t (all t if `full`; with `edges`, the 8 rows
    sit at the kernel's chunk and tile edges: 0, 1, 63, 64, 65, R, R + 1
    and t for chunks of R = split_rows rows)."""
    bf = torch.bfloat16
    rows, splits = split_rows(t, kv, hd), num_splits(t, kv, hd)
    q = torch.randn((b, h, hd), generator=gen, device=DEV).to(bf)
    arena = torch.randn((2, 2, b, t, kv, hd), generator=gen,
                        device=DEV).to(bf)
    k, v = arena[1, 0], arena[1, 1]
    lengths = torch.linspace(1, t, b, device=DEV).round().to(torch.int32)
    lengths[0] = t
    if full:
        lengths.fill_(t)
    if edges:
        lengths = torch.tensor([0, 1, 63, 64, 65, rows, rows + 1, t],
                               dtype=torch.int32, device=DEV)
    valid = torch.arange(t, device=DEV)[None] < lengths[:, None]
    qt = q[:, :, None]
    kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
    mask = valid[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    case = attention_case(
        "decode_attention", label,
        lambda: ops.decode_attention(q, k, v, lengths=lengths),
        lambda: ref.decode_attention(q, k, v, lengths=lengths),
        lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True),
        costs.decode_attention(q, k, v, lengths=lengths), iters=50)
    print(json.dumps({"decode_split": {"case": label, "split_rows": rows,
                                       "splits": splits,
                                       "blocks": kv * b * splits}}),
          flush=True)
    return dict(case, shape=[list(q.shape), list(k.shape)],
                lengths=[int(lengths.min()), int(lengths.max())],
                split_rows=rows, splits=splits)


def serving_summary(out, launches):
    """The numbers of one `serve_cli.serve` run."""
    st = out["stats"]
    decode = out["decode_ms"]
    return {
        "tokens_per_s": out["tokens_per_s"], "p50_s": out["p50_s"],
        "p99_s": out["p99_s"], "requests": len(out["outputs"]),
        "tokens": sum(len(o) for o in out["outputs"]),
        "max_len": out["max_len"], "admissions": st["admissions"],
        "decode_steps": st["decode_steps"],
        "first_decode_ms": decode[0],
        "decode_ms_per_step_after_first": float(np.mean(decode[1:])),
        "decode_ms_median_after_first": float(np.median(decode[1:])),
        "prefill_ms_per_admission": sum(out["admit_ms"]) / st["admissions"],
        "admit_rounds_ms": out["admit_ms"],
        "peak_GB": out["peak_bytes"] / 1e9, "paged": out["paged"],
        "num_blocks": out["num_blocks"], "free_blocks": out["free_blocks"],
        "num_preemptions": out["num_preemptions"], "launches": launches,
        "stats": st}


def assert_overlapped(what, st):
    """The engine ran overlapped admission: fused mixed steps carried
    prefills and first tokens resolved deferred."""
    if (st["overlap_mode"] != "fused" or st["mixed_steps"] < 1
            or st["overlapped_admissions"] < 1):
        raise AssertionError(f"{what}: not overlapped: {st}")


def serve_main_path():
    """The serving main path at full width, at the engine's default
    (overlapped); returns (result, launches, the serve() output)."""
    args = serve_cli.parse_args(SERVE_ARGS)
    print(" ".join(SERVE_ARGS))
    reset_counts()
    out = serve_cli.serve(args)
    launches = counts()
    st = out["stats"]
    summary = serving_summary(out, launches)
    print(json.dumps({"serving_main_path": summary}), flush=True)
    assert_overlapped("the arena main path", st)
    n_layers = N_LAYERS
    if launches["flash_attention"] != n_layers * st["admissions"]:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times for "
                             f"{st['admissions']} admissions")
    if launches["decode_attention"] != n_layers * st["decode_steps"]:
        raise AssertionError(f"decode_attention launched "
                             f"{launches['decode_attention']} times for "
                             f"{st['decode_steps']} decode steps")
    if [len(o) for o in out["outputs"]] != out["budgets"]:
        raise AssertionError("a request did not get its budget's tokens: "
                             f"{[len(o) for o in out['outputs']]}")

    # two requests (a short and a long budget) re-served alone
    _, cfg, model, params = serve_cli.build(args)
    prompts, budgets = serve_cli.workload(args, cfg.vocab_size)
    eng = Engine(model, params, max_batch=args.max_batch,
                 max_len=out["max_len"])
    del params
    for uid in (0, 1):
        eng.submit(prompts[uid], max_new_tokens=budgets[uid])
        (alone,) = eng.run()[-1:]
        if alone.output.tolist() != out["outputs"][uid]:
            raise AssertionError(f"request {uid} served alone gave "
                                 f"{alone.output.tolist()}, batched "
                                 f"{out['outputs'][uid]}")
    print(json.dumps({"solo_reserves_equal": [0, 1]}), flush=True)
    return summary, launches, out


def serving_reference_check(arch="qwen2-0.5b", exact=False):
    """`arch`'s smoke config in f32: prefill_into_slot + 8 decode_rows
    steps on the card and on the CPU from one set of parameters; prompts
    padded to 8 or 16 tokens, or at their `exact` length (a family whose
    engine does not pad)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    slots, cap = 2, 32
    # (device, params, arena): the CPU run first, the card's second
    runs = [(dev, {k: v.to(dev) for k, v in cpu.items()},
             model.init_arena(slots, cap, dtype=torch.float32, device=dev))
            for dev in (torch.device("cpu"), DEV)]
    worst, tie_free, equal = 0.0, 0, 0
    lengths = np.zeros(slots, np.int32)
    for slot, plen in ((1, 11), (0, 5)):
        toks = np.zeros((1, plen if exact else 16 if plen > 8 else 8),
                        np.int32)
        toks[0, :plen] = rng.integers(0, cfg.vocab_size, plen)
        want, got = (model.prefill_into_slot(
            p, torch.from_numpy(toks).to(dev), plen, slot, arena)[0].cpu()
            for dev, p, arena in runs)
        worst = max(worst, float((got - want).abs().max()))
        lengths[slot] = plen
    cur = rng.integers(0, cfg.vocab_size, slots).astype(np.int32)
    for _ in range(8):
        want, got = (model.decode_rows(
            p, torch.from_numpy(cur)[:, None].to(dev), arena,
            torch.from_numpy(lengths).to(dev))[0][:, -1].cpu()
            for dev, p, arena in runs)
        worst = max(worst, float((got - want).abs().max()))
        top2 = want.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 1e-3
        same = got.argmax(-1) == want.argmax(-1)
        if not bool(same[sure].all()):
            raise AssertionError("card and CPU pick different greedy tokens "
                                 "where the top-2 margin exceeds 1e-3")
        tie_free += int(sure.sum())
        equal += int(same.sum())
        # both devices continue from the CPU's tokens
        cur = want.argmax(-1).numpy().astype(np.int32)
        lengths += 1
    print(json.dumps({"serving_reference_max_abs_err": worst, "arch": arch,
                      "tolerance": 1e-4, "greedy_tokens_checked": tie_free,
                      "greedy_tokens_equal": equal}), flush=True)
    # f32 sums run in another order on the card than on the CPU
    if worst > 1e-4:
        raise AssertionError(f"card and CPU serving logits differ by {worst}")


def launches_by_kernel(prof):
    """Device launches in a profile (pad_profile()'s sleeps left out): the
    total, and the sums over the WKV kernels (`wkv_fwd`, the name every
    body's kernels share) and the RG-LRU kernel (`rglru_fwd`)."""
    out = {"total": 0, "wkv_fwd": 0, "rglru_fwd": 0}
    for name, _ in cuda_events(prof):
        if PAD_KERNEL in name:
            continue
        out["total"] += 1
        for key in ("wkv_fwd", "rglru_fwd"):
            if key in name:
                out[key] += 1
    return out


def profile_decode_steps(steps=8, paged=False, argv=SERVE_ARGS):
    """Device time by kernel over `steps` steady decode steps at full
    width (8 live rows of 200-token prompts of `argv`'s model; arena or
    paged pool),
    launches per step and the device's busy share of the steps' wall time
    under the profiler; and the admission round before them (8 admissions
    and one decode step) profiled apart, for the recurrent kernels' wrapper
    calls and device launches per admission beside those per step. The
    `steps` steps before the profiled ones run unprofiled: their wall time
    over the profiled device time estimates the busy share without the
    profiler's host overhead. Both profiles are bracketed by
    pad_profile()'s sleeps, which no count or time includes. Returns the
    recurrent kernels' wrapper calls and device launches per admission
    and per step ({"per_admission": ..., "per_step": ...}), or None when
    the profile recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    args = serve_cli.parse_args(argv)
    _, cfg, model, params = serve_cli.build(args)
    prompts, _ = serve_cli.workload(args, cfg.vocab_size)
    eng = Engine(model, params, max_batch=8, max_len=512, paged=paged)
    del params
    for p in prompts[:8]:
        eng.submit(p, max_new_tokens=2 * steps + 4)
    reset_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as aprof:
        pad_profile()
        eng.step()          # admission round + the first decode step
        pad_profile()
        torch.cuda.synchronize()
    round_calls = counts()
    admitted = eng.stats["admissions"]
    round_launches = launches_by_kernel(aprof)
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()          # each step ends in its [B] token fetch
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad_profile()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        wall_ms = (time.perf_counter() - t0) * 1e3
        pad_profile()
        torch.cuda.synchronize()
    step_calls = counts()
    rows = sorted(((ms, n, name[:90]) for ms, n, name in cuda_rows(prof)),
                  reverse=True)
    step_launches = launches_by_kernel(prof)
    # the admission round's launches less one decode step's, per admission
    recurrent = {"rwkv6_scan": "wkv_fwd", "rglru_scan": "rglru_fwd"}
    per_admission = {
        name: {"wrapper_calls": (round_calls[name] - step_calls[name] / steps)
               / max(1, admitted),
               "device_launches": (round_launches[key]
                                   - step_launches[key] / steps)
               / max(1, admitted)}
        for name, key in recurrent.items()}
    per_step = {name: {"wrapper_calls": step_calls[name] / steps,
                       "device_launches": step_launches[key] / steps}
                for name, key in recurrent.items()}
    device_ms = sum(ms for ms, _, _ in rows)
    if not device_ms:
        print("serving profile: no device time recorded (not measured)")
        return None
    backend = "paged" if paged else "arena"
    if cfg.name != "qwen2-0.5b":
        backend = f"{cfg.name}_{backend}"
    print(json.dumps({f"profile_{steps}_{backend}_decode_steps": {
        "steps_wall_ms": wall_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "unprofiled_steps_wall_ms": plain_wall_ms,
        "device_busy_share_unprofiled_estimate": device_ms / plain_wall_ms,
        "device_launches_per_step": sum(n for _, n, _ in rows) / steps,
        "decode_attention_device_ms": sum(
            ms for ms, _, name in rows
            if "decode_fwd" in name or "paged_fwd" in name),
        "rwkv6_scan_device_ms": sum(ms for ms, _, name in rows
                                    if "wkv_fwd" in name),
        "rglru_scan_device_ms": sum(ms for ms, _, name in rows
                                    if "rglru_fwd" in name),
        "rglru_scan_us_per_launch": 1e3 * sum(
            ms for ms, _, name in rows if "rglru_fwd" in name) / max(1, sum(
                n for _, n, name in rows if "rglru_fwd" in name)),
        "rwkv6_scan_us_per_launch": 1e3 * sum(
            ms for ms, _, name in rows if "wkv_fwd" in name) / max(1, sum(
                n for _, n, name in rows if "wkv_fwd" in name)),
        "admission_round": {"admissions": admitted, "decode_steps": 1,
                            "wrapper_calls": round_calls,
                            "device_launches": round_launches},
        "recurrent_per_admission": per_admission,
        "recurrent_per_decode_step": per_step,
        "top": [{"ms": ms, "count": n, "name": name}
                for ms, n, name in rows[:15]]}}), flush=True)
    return {"per_admission": per_admission, "per_step": per_step}


def assert_recurrent_launches(what, measured, name, per_admission,
                              per_step):
    """The profiled admission and step of `what` (profile_decode_steps'
    return) made `name`'s wrapper calls and device launches as expected:
    (wrapper calls, device launches) per admission and per step."""
    want = {"per_admission": per_admission, "per_step": per_step}
    got = None if measured is None else {
        key: (measured[key][name]["wrapper_calls"],
              measured[key][name]["device_launches"]) for key in want}
    if got is None or any(abs(a - b) > 1e-6 for key in want
                          for a, b in zip(got[key], want[key])):
        raise AssertionError(f"{what}: {name} (wrapper calls, device "
                             f"launches) {got}, expected {want}")


PAGED_SERVE_ARGS = SERVE_ARGS + ["--paged", "--block-size", "16"]
SCARCE_BLOCKS = 112     # 8 prompts of 13 blocks + watermark fill it
RING_WINDOW = 256
RING_BUDGETS = (80, 160)    # alternating, every one past the window


def _pool_operands(b, max_len, bs, dtype, gen, h=14, kv=2, hd=64):
    """q [b,h,hd] and a k/v pool [2, 1 + b*W, bs, kv, hd] (block 0 the null
    block; qwen2-0.5b's 14 heads over 2 of 64 by default) with random
    disjoint tables [b, W], W = max_len / bs."""
    w = max_len // bs
    nb = 1 + b * w
    q = torch.randn((b, h, hd), generator=gen, device=DEV).to(dtype)
    pool = torch.randn((2, nb, bs, kv, hd), generator=gen,
                       device=DEV).to(dtype)
    perm = torch.randperm(nb - 1, generator=gen, device=DEV) + 1
    tables = perm[:b * w].reshape(b, w).to(torch.int32)
    return q, pool[0], pool[1], tables


def _gather_sdpa(q, kp, vp, tables, valid):
    """Gather the pages into a linear cache, then SDPA with a length mask:
    the informative point of comparison (no single PyTorch call computes
    paged attention)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, w = tables.shape

    def run():
        kf, vf = (p[tables.long()].reshape(b, w * p.shape[1], p.shape[2],
                                           p.shape[3]).transpose(1, 2)
                  for p in (kp, vp))
        return sdpa(q[:, :, None], kf, vf, attn_mask=valid[:, None, None],
                    enable_gqa=True)
    return run


def check_paged_case(label, b, max_len, bs, dtype, gen, **heads):
    """One paged decode step of b rows whose lengths spread over
    1..max_len; table entries past a row's blocks point at block 0.
    `heads`: h, kv and hd, if not qwen2-0.5b's."""
    q, kp, vp, tables = _pool_operands(b, max_len, bs, dtype, gen, **heads)
    w = tables.shape[1]
    lengths = torch.linspace(1, max_len, b, device=DEV).round().to(
        torch.int32)
    lengths[0] = max_len
    nblk = (lengths + bs - 1) // bs
    tables[torch.arange(w, device=DEV)[None] >= nblk[:, None]] = 0
    valid = torch.arange(w * bs, device=DEV)[None] < lengths[:, None]
    case = attention_case(
        "decode_attention_paged", label,
        lambda: ops.decode_attention_paged(q, kp, vp, tables,
                                           lengths=lengths),
        lambda: ref.decode_attention_paged(q, kp, vp, tables,
                                           lengths=lengths),
        None, costs.decode_attention_paged(q, kp, vp, tables,
                                           lengths=lengths),
        iters=50, dtype=dtype)
    lib = _gather_sdpa(q, kp, vp, tables, valid)
    case.update(gather_sdpa_ms=device_ms(lib, 50),
                gather_sdpa_event_ms=event_ms(lib, 50),
                shape=[list(q.shape), list(kp.shape), list(tables.shape)],
                lengths=[int(lengths.min()), int(lengths.max())],
                **check_pool_invariance(label, q, kp, vp, tables, lengths))
    print(json.dumps({"gather_sdpa": {k: case[k] for k in (
        "case", "dtype", "gather_sdpa_ms", "gather_sdpa_event_ms")}}),
        flush=True)
    return case


def tickets_zero():
    """The decode kernels' shared ticket counters, all back at 0."""
    torch.cuda.synchronize()
    return all(not bool(t.any()) for t in ticket_pool.TICKETS.values())


def check_pool_invariance(label, q, kp, vp, tables, lengths, ring=None):
    """The paged (ring) kernel's output must be bitwise the same under a
    table of width W and of 2W (the extra entries null; a ring in its
    unrotated order, starts 0), for each row alone and in the batch, and
    in a second call; the ticket counters must be back at 0 after each
    launch. Every row here lies within W * bs. Returns the split_rows,
    split count and the checks."""
    ring = ring or {}

    def run(qq, tt, ll, rr):
        if rr:
            return ops.decode_attention_ring(qq, kp, vp, tt, lengths=ll,
                                             **rr)
        return ops.decode_attention_paged(qq, kp, vp, tt, lengths=ll)

    b, w = tables.shape
    bs, hd = kp.shape[1], q.shape[2]
    cap = w * bs if not ring else min(ring["window"], w * bs)
    base = run(q, tables, lengths, ring)
    checks = {"repeat_bitwise": torch.equal(run(q, tables, lengths, ring),
                                            base),
              "tickets_zero": tickets_zero()}
    flat, wide_ring = tables, {}
    if ring:
        flat = ref.ring_order(tables, ring["ring_starts"]).int()
        wide_ring = dict(ring_starts=torch.zeros_like(ring["ring_starts"]),
                         window=ring["window"])
    wide = torch.cat([flat, torch.zeros_like(flat)], dim=1).contiguous()
    checks["width_bitwise"] = torch.equal(run(q, wide, lengths, wide_ring),
                                          base)
    checks["batch_bitwise"] = all(torch.equal(run(
        q[i:i + 1], tables[i:i + 1].contiguous(), lengths[i:i + 1],
        {k: (v[i:i + 1] if torch.is_tensor(v) else v)
         for k, v in ring.items()})[0], base[i]) for i in range(b))
    checks["tickets_zero"] &= tickets_zero()
    out = {"split_rows": paged_split_rows(hd),
           "splits": paged_num_splits(cap, hd),
           "blocks": kp.shape[2] * b * paged_num_splits(cap, hd), **checks}
    print(json.dumps({"paged_split": {"case": label, "dtype": str(q.dtype),
                                      **out}}), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"paged kernel not invariant on {label}: "
                             f"{checks}")
    return out


def check_ring_case(label, b, window, bs, dtype, gen, **heads):
    """One ring decode step of b rows over rings of window / bs blocks,
    rows unwrapped, part-filled and wrapped (lengths 1..3*window), random
    ring starts; rotating table and starts together must leave the
    output bitwise unchanged. `heads`: h, kv and hd, if not qwen2-0.5b's."""
    q, kp, vp, tables = _pool_operands(b, window, bs, dtype, gen, **heads)
    w = tables.shape[1]
    lengths = torch.linspace(1, 3 * window, b, device=DEV).round().to(
        torch.int32)
    starts = torch.randint(0, w, (b,), generator=gen, device=DEV,
                           dtype=torch.int32)
    live = torch.clamp(lengths, max=window)
    order = (starts.long()[:, None] + torch.arange(w, device=DEV)[None]) % w
    ring_tables = torch.gather(tables, 1, order).contiguous()
    valid = torch.arange(w * bs, device=DEV)[None] < live[:, None]
    kw = dict(ring_starts=starts, lengths=lengths, window=window)
    case = attention_case(
        "decode_attention_ring", label,
        lambda: ops.decode_attention_ring(q, kp, vp, tables, **kw),
        lambda: ref.decode_attention_ring(q, kp, vp, tables, **kw),
        None, costs.decode_attention_ring(q, kp, vp, tables, lengths=lengths,
                                          window=window),
        iters=50, dtype=dtype)
    base = ops.decode_attention_ring(q, kp, vp, tables, **kw)
    for shift in (1, w // 2, w - 1):
        rot = torch.roll(tables, shift, dims=1).contiguous()
        out = ops.decode_attention_ring(
            q, kp, vp, rot, ring_starts=(starts + shift) % w,
            lengths=lengths, window=window)
        if not torch.equal(out, base):
            raise AssertionError(f"ring kernel changes under a rotation by "
                                 f"{shift} ({label})")
    lib = _gather_sdpa(q, kp, vp, ring_tables, valid)
    case.update(gather_sdpa_ms=device_ms(lib, 50),
                gather_sdpa_event_ms=event_ms(lib, 50),
                rotation_invariant="bitwise",
                shape=[list(q.shape), list(kp.shape), list(tables.shape)],
                lengths=[int(lengths.min()), int(lengths.max())],
                **check_pool_invariance(label, q, kp, vp, tables, lengths,
                                        dict(ring_starts=starts,
                                             window=window)))
    print(json.dumps({"ring_rotation_bitwise": label}), flush=True)
    print(json.dumps({"gather_sdpa": {k: case[k] for k in (
        "case", "dtype", "gather_sdpa_ms", "gather_sdpa_event_ms")}}),
        flush=True)
    return case


def check_identity_table(gen):
    """The arena's [8,512,2,64] cache cut into blocks of 16 under an
    identity table: the paged kernel against the linear decode kernel."""
    b, t, h, kv, hd, bs = 8, 512, 14, 2, 64, 16
    bf = torch.bfloat16
    q = torch.randn((b, h, hd), generator=gen, device=DEV).to(bf)
    k, v = (torch.randn((b, t, kv, hd), generator=gen, device=DEV).to(bf)
            for _ in range(2))
    lengths = torch.linspace(1, t, b, device=DEV).round().to(torch.int32)
    w = t // bs
    null = torch.zeros((1, bs, kv, hd), dtype=bf, device=DEV)
    pk, pv = (torch.cat([null, x.reshape(b * w, bs, kv, hd)]) for x in (k, v))
    tables = (1 + torch.arange(b * w, device=DEV)).reshape(b, w).to(
        torch.int32)
    paged = ops.decode_attention_paged(q, pk, pv, tables, lengths=lengths)
    linear = ops.decode_attention(q, k, v, lengths=lengths)
    ok, err = bf16_close(paged, linear)
    print(json.dumps({"identity_table_vs_linear_kernel": {
        "max_abs_err": err, "bitwise": bool(torch.equal(paged, linear)),
        "paged_split_rows": paged_split_rows(hd),
        "linear_split_rows": split_rows(t, kv, hd),
        "tolerance": "<= 1 bf16 ulp + 1e-5"}}), flush=True)
    if not ok:
        raise AssertionError(f"paged kernel with an identity table differs "
                             f"from the linear kernel by {err}")


def dense_kernel_cases(gen):
    """Phase a: the attention kernels at the new dense configs' main-path
    shapes (head_dim 128 over 8 kv heads; G = 4 for qwen3-8b, 2 for
    internlm2-1.8b, 6 for nemotron-4-15b), bf16, against their plain
    versions, timed beside SDPA (flash, decode) and gather + SDPA (paged):
    flash over the 256-token prompt bucket, decode over 8 arena rows of
    512 with lengths 1..512, paged over 8 rows of <= 512 tokens in 256
    blocks of 16. Returns (flash, decode, paged) cases."""
    flash, decode, paged = [], [], []
    for arch in DENSE_ARCHS:
        cfg = get_config(arch)
        heads = dict(h=cfg.num_heads, kv=cfg.num_kv_heads, hd=cfg.head_dim)
        tag = f"{arch} {cfg.num_heads}:{cfg.num_kv_heads} heads of " \
              f"{cfg.head_dim}"
        flash.append(check_flash_case(f"{tag}, prefill Sp=256", 256, gen,
                                      **heads))
        decode.append(check_decode_case(f"{tag}, decode B=8 T=512", 8, 512,
                                        gen, **heads))
        if arch == "qwen3-8b":
            paged.append(check_paged_case(
                f"{tag}, paged B=8 <=512 tokens, 256 blocks of 16", 8, 512,
                16, torch.bfloat16, gen, **heads))
        torch.cuda.empty_cache()
    return flash, decode, paged


def paged_serve_main_path(arena_outputs):
    """Phase 11: the paged serving main path, then a block-scarce pool
    under "recompute" and "reserve", all at the engine's default
    (overlapped). Returns (summary, launches, {"paged": the main path's
    serve() output, "scarce": the "recompute" arm's})."""
    n_layers = N_LAYERS
    args = serve_cli.parse_args(PAGED_SERVE_ARGS)
    print(" ".join(PAGED_SERVE_ARGS))
    reset_counts()
    out = serve_cli.serve(args)
    launches = counts()
    summary = serving_summary(out, launches)
    summary["requests_equal_to_arena"] = sum(
        a == b for a, b in zip(out["outputs"], arena_outputs))
    print(json.dumps({"paged_serving_main_path": summary}), flush=True)
    assert_overlapped("the paged main path", out["stats"])
    steps = out["stats"]["decode_steps"]
    if launches["decode_attention_paged"] != n_layers * steps:
        raise AssertionError(f"decode_attention_paged launched "
                             f"{launches['decode_attention_paged']} times "
                             f"for {steps} decode steps")
    if launches["decode_attention"] or launches["decode_attention_ring"]:
        raise AssertionError(f"the paged path launched another decode "
                             f"kernel: {launches}")
    if [len(o) for o in out["outputs"]] != out["budgets"]:
        raise AssertionError("a request did not get its budget's tokens")
    if out["free_blocks"] != out["num_blocks"]:
        raise AssertionError(f"{out['num_blocks'] - out['free_blocks']} "
                             "blocks were not returned")
    torch.cuda.empty_cache()

    # block accounting depends on lengths only: the smoke config on the
    # CPU preempts exactly as often as full width on the card
    scarce_argv = PAGED_SERVE_ARGS + ["--num-blocks", str(SCARCE_BLOCKS)]
    cpu = serve_cli.serve(serve_cli.parse_args(
        scarce_argv + ["--smoke", "--device", "cpu"]))
    predicted = cpu["num_preemptions"]
    if predicted < 1:
        raise AssertionError("the scarce pool does not preempt at smoke "
                             "size; shrink it")
    runs, outs = {}, {"paged": out}
    for policy in ("recompute", "reserve"):
        argv = scarce_argv + ["--preemption", policy]
        print(" ".join(argv))
        reset_counts()
        run = serve_cli.serve(serve_cli.parse_args(argv))
        run_launches = counts()
        if policy == "recompute":
            assert_overlapped("the scarce pool", run["stats"])
            outs["scarce"] = run
        runs[policy] = serving_summary(run, run_launches)
        runs[policy]["outputs_equal_to_unpreempted"] = (
            run["outputs"] == out["outputs"])
        want = predicted if policy == "recompute" else 0
        if run["num_preemptions"] != want:
            raise AssertionError(f"{policy}: {run['num_preemptions']} "
                                 f"preemptions, expected {want}")
        if run["outputs"] != out["outputs"]:
            raise AssertionError(f"{policy}: the scarce pool changed the "
                                 "tokens")
        if run["free_blocks"] != run["num_blocks"]:
            raise AssertionError(f"{policy}: blocks were not returned")
        if (run_launches["decode_attention_paged"]
                != n_layers * run["stats"]["decode_steps"]):
            raise AssertionError(f"{policy}: paged launches "
                                 f"{run_launches}")
        torch.cuda.empty_cache()
    print(json.dumps({"paged_scarce_pool": {
        "num_blocks": SCARCE_BLOCKS, "predicted_preemptions_cpu": predicted,
        **runs}}), flush=True)
    return summary, launches, outs


def ring_serving(overlap=True):
    """Phase 12: a full-width windowed model served from the ring-paged
    pool through `Engine(..., overlap=overlap)`; returns (summary,
    launches, outputs in submit order)."""
    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg, window=RING_WINDOW)
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    rng = np.random.default_rng(0)
    # 12 requests in 8 rows: the four admitted when the first short ones
    # finish ride the decode steps of the full rings
    prompts = [rng.integers(0, cfg.vocab_size, (200,)) for _ in range(12)]
    budgets = [RING_BUDGETS[i % 2] for i in range(12)]
    eng = Engine(model, params, max_batch=8, max_len=512, paged=True,
                 block_size=16, prefill_chunk=32, overlap=overlap)
    del params
    ring_blocks = RING_WINDOW // 16
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    uids = [eng.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    in_use, full_at, latency = [], None, {}
    while eng.pending or eng.num_active:
        for r in eng.step():
            latency[r.uid] = time.perf_counter() - t0
        in_use.append(eng._allocator.in_use)
        live = [int(eng._lengths[s]) for s in range(eng.max_batch)
                if eng._slot_req[s] is not None]
        if full_at is None and live and min(live) >= RING_WINDOW:
            full_at = len(in_use)
    total = time.perf_counter() - t0
    launches = counts()
    done = {r.uid: r for r in eng.run()}
    st = eng.stats
    steps = st["decode_steps"]
    lats = [latency[u] for u in uids]
    summary = {
        "window": RING_WINDOW, "requests": len(uids),
        "budgets": RING_BUDGETS, "tokens_per_s": sum(budgets) / total,
        "p50_s": float(np.percentile(lats, 50)),
        "p99_s": float(np.percentile(lats, 99)), "decode_steps": steps,
        "decode_ms_per_step": st["decode_s"] / steps * 1e3,
        "prefill_ms_per_admission": (st["admit_host_s"]
                                     + st["prefill_wait_s"])
        / st["admissions"] * 1e3,
        "peak_blocks_in_use": eng._allocator.peak_in_use,
        "blocks_in_use_once_full": in_use[full_at - 1] if full_at else None,
        "peak_GB": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "stats": st}
    print(json.dumps({"ring_paged_serving" if overlap
                      else "ring_paged_serving_serialized": summary}),
          flush=True)
    if overlap:
        assert_overlapped("the ring pool", st)
    if launches["decode_attention_ring"] != N_LAYERS * steps:
        raise AssertionError(f"decode_attention_ring launched "
                             f"{launches['decode_attention_ring']} times "
                             f"for {steps} decode steps")
    if launches["decode_attention_paged"] or launches["decode_attention"]:
        raise AssertionError(f"the ring path launched another decode "
                             f"kernel: {launches}")
    if [len(done[u].output) for u in uids] != budgets:
        raise AssertionError("a ring request did not get its budget")
    if full_at is None or any(n > in_use[full_at - 1]
                              for n in in_use[full_at:]):
        raise AssertionError(f"blocks were allocated after the rings were "
                             f"full: {in_use}")
    if eng._allocator.peak_in_use != 8 * ring_blocks:
        raise AssertionError(f"peak {eng._allocator.peak_in_use} blocks, "
                             f"rings hold {8 * ring_blocks}")
    if eng.free_blocks != eng.num_blocks:
        raise AssertionError("ring blocks were not returned")
    return summary, launches, [done[u].output.tolist() for u in uids]


def paged_reference_check():
    """Phase 13: the smoke config in f32 on the card and on the CPU from
    one set of parameters: the paged entry points' logits (live rows,
    1e-4), then three engines (paged, paged in a scarce pool, ring-paged)
    whose tokens and preemption counts must be equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke("qwen2-0.5b"), compute_dtype="float32")
    cpu_dev = torch.device("cpu")
    rng = np.random.default_rng(7)
    workload = [(5, 6), (11, 14), (3, 9), (8, 1), (14, 5), (2, 20), (9, 4)]
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n, _ in workload]
    budgets = [b for _, b in workload]
    long_prompt = rng.integers(0, cfg.vocab_size, (19,))     # two chunks
    worst, report = 0.0, {}
    for window in (0, 16):
        model = build_model(cfg, window=window)
        cpu = model.init(torch.Generator().manual_seed(0))
        runs = [(dev, {k: v.to(dev) for k, v in cpu.items()},
                 model.init_pool(12, 8, dtype=torch.float32, device=dev))
                for dev in (cpu_dev, DEV)]
        tables = np.zeros((3, 8), np.int32)
        tables[0, :3] = [4, 9, 2]
        toks = np.zeros((1, 16), np.int32)
        for start in (0, 16):
            part = long_prompt[start:start + 16]
            toks[:] = 0
            toks[0, :len(part)] = part
            want, got = (model.prefill_chunk_into_blocks(
                p, torch.from_numpy(toks).to(dev), len(part), start,
                torch.from_numpy(tables[0]).to(dev), pool)[0].cpu()
                for dev, p, pool in runs)
            worst = max(worst, float((got - want).abs().max()))
        # a live row, a dead row, and a dead row drifted past the table
        lengths = np.array([len(long_prompt), 0, 8 * 8 + 5], np.int32)
        cur = np.array([3, 5, 7], np.int32)
        free = iter([1, 3, 5, 6, 7, 8, 10, 11])
        for _ in range(20):
            pos = int(lengths[0]) % (window or 1 << 30)
            if tables[0, pos // 8] == 0:
                tables[0, pos // 8] = next(free)
            want, got = (model.decode_rows_paged(
                p, torch.from_numpy(cur)[:, None].to(dev), pool,
                torch.from_numpy(tables).to(dev),
                torch.from_numpy(lengths).to(dev))[0].cpu()
                for dev, p, pool in runs)
            # dead rows read the null block, whose contents differ by
            # device (winners of duplicate writes): the live row counts
            worst = max(worst, float((got[0] - want[0]).abs().max()))
            cur = want[:, -1].argmax(-1).numpy().astype(np.int32)
            lengths = lengths + 1
        engines = ({"ring": dict(block_size=8, num_blocks=24)} if window
                   else {"paged": dict(block_size=4, num_blocks=24),
                         "paged_scarce": dict(block_size=4, num_blocks=9)})
        for name, geom in engines.items():
            got = []
            for dev, p, _ in runs:
                eng = Engine(model, p, max_batch=3, max_len=32,
                             cache_dtype=torch.float32, paged=True,
                             prefill_chunk=4, **geom)
                for prompt, budget in zip(prompts, budgets):
                    eng.submit(prompt, max_new_tokens=budget)
                done = sorted(eng.run(), key=lambda r: r.uid)
                got.append(([r.output.tolist() for r in done],
                            eng.num_preemptions, eng.free_blocks))
            report[name] = {"preemptions": got[1][1],
                            "tokens_equal": got[0][0] == got[1][0]}
            if got[0] != got[1]:
                raise AssertionError(f"{name}: card and CPU engines differ "
                                     f"(preemptions {got[0][1]} / "
                                     f"{got[1][1]})")
    if report["paged_scarce"]["preemptions"] < 1:
        raise AssertionError("the scarce smoke pool did not preempt")
    print(json.dumps({"paged_reference_max_abs_err": worst,
                      "tolerance": 1e-4, "engines": report}), flush=True)
    # f32 sums run in another order on the card than on the CPU
    if worst > 1e-4:
        raise AssertionError(f"card and CPU paged logits differ by {worst}")


RWKV_SERVE_ARGS = ["--arch", "rwkv6-1.6b"] + SERVE_ARGS[2:]
RWKV_RULE = ("|kernel - plain| <= 1e-5 * rms(plain) + 1e-4 * |plain|, out "
             "and final state (f32 sums in another order; the state carries "
             "each step's rounding, and an output near zero is a cancelling "
             "sum of 64 terms of the outputs' size)")


def rwkv_close(got, want):
    """(ok, max |got - want|) under RWKV_RULE."""
    want = want.float()
    err = (got.float() - want).abs()
    tol = 1e-5 * want.pow(2).mean().sqrt() + 1e-4 * want.abs()
    return bool((err <= tol).all()), float(err.max())


STRONG_DECAY_ATOL = 1e-3   # the reference's own CHUNKED_ATOL (module doc)


def wkv_launches_per_call(s):
    """Device launches of one rwkv6_scan call over s steps: the chunked
    body makes two, the step body one."""
    return 2 if wkv.body(s) else 1


def check_rwkv_case(label, b, s, dtype, gen, pieces=1, hd=64, w0=-2.0,
                    heads=None):
    """The WKV recurrence of rwkv6-1.6b (32 heads of 64, or of hd; `heads`
    of them: a rank's share on a model axis) for b
    rows of s steps from a random state, r/k/v in dtype and the model's
    [B, S, H, hd] layout viewed as [B, H, S, hd], decays exp(-exp(w0 + 0.5
    z)) (w0 = -2: the model's exp(-exp(-2)); 0 to +2: strong decays, held
    to STRONG_DECAY_ATOL instead of RWKV_RULE). With pieces > 1 the kernel
    also runs the steps in that many pieces (each on chunk edges and long
    enough for the chunked body), the state carried in place, and must
    equal its one pass bitwise."""
    h = heads or 2048 // hd
    r, k, v = (torch.randn((b, s, h, hd), generator=gen, device=DEV)
               .to(dtype).transpose(1, 2) for _ in range(3))
    w = torch.exp(-torch.exp(w0 + 0.5 * torch.randn(
        (b, s, h, hd), generator=gen, device=DEV))).transpose(1, 2)
    u = (0.1 * torch.randn((h, hd), generator=gen, device=DEV)).to(dtype)
    state = torch.randn((b, h, hd, hd), generator=gen, device=DEV)
    got_state = state.clone()
    out, _ = ops.rwkv6_scan(r, k, v, w, u, got_state)
    torch.cuda.synchronize()
    want, want_state = ref.rwkv6(r, k, v, w, u, state)
    if w0 == -2.0:
        tolerance = RWKV_RULE
        ok_out, err_out = rwkv_close(out, want)
        ok_state, err_state = rwkv_close(got_state, want_state)
    else:
        tolerance = (f"|kernel - plain| <= {STRONG_DECAY_ATOL} (the "
                     "reference's chunked-form bound)")
        err_out = float((out - want).abs().max())
        err_state = float((got_state - want_state).abs().max())
        ok_out = err_out <= STRONG_DECAY_ATOL
        ok_state = err_state <= STRONG_DECAY_ATOL
    del want, want_state
    pieces_bitwise = None
    if pieces > 1:
        carried = state.clone()
        cut = s // pieces
        parts = [ops.rwkv6_scan(r[:, :, a:a + cut], k[:, :, a:a + cut],
                                v[:, :, a:a + cut], w[:, :, a:a + cut], u,
                                carried)[0]
                 for a in range(0, s, cut)]
        pieces_bitwise = bool(torch.equal(torch.cat(parts, dim=2), out)
                              and torch.equal(carried, got_state))
        del parts, carried
    del out
    scratch = state.clone()
    per_call = device_launches(lambda: ops.rwkv6_scan(r, k, v, w, u,
                                                      scratch))
    t = timings(lambda: ops.rwkv6_scan(r, k, v, w, u, scratch),
                lambda: ref.rwkv6(r, k, v, w, u, state), None,
                iters=20 if s > 1000 else 50, launches=per_call)
    # the fewest operations: the chunked form (`costs.rwkv6_scan`)
    cost = costs.rwkv6_scan(r, k, v, w, u, state)
    nbytes, flops = cost.bytes, cost.flops
    t_bytes, t_ops = bound_terms(cost)
    case = {"case": label, "dtype": str(dtype), "w0": w0,
            "body": "chunked" if wkv.body(s) else "step",
            "chunk": wkv.body(s), "device_launches_per_call": per_call,
            "shape": [list(r.shape), list(state.shape)],
            "max_abs_err": max(err_out, err_state), "max_abs_err_out": err_out,
            "max_abs_err_state": err_state, "tolerance": tolerance,
            "pieces": pieces, "pieces_equal_one_pass_bitwise": pieces_bitwise,
            **t, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
            "achieved_GBps": nbytes / t["kernel_ms"] / 1e6}
    print(json.dumps(case), flush=True)
    if not (ok_out and ok_state) or pieces_bitwise is False:
        raise AssertionError(f"rwkv6_scan kernel disagrees with its plain "
                             f"version on {label}: {case}")
    if per_call != wkv_launches_per_call(s):
        raise AssertionError(f"rwkv6_scan made {per_call} device launches "
                             f"in a call on {label}, expected "
                             f"{wkv_launches_per_call(s)}")
    return case


def rwkv_serve_main_path():
    """Phase 15: the RWKV6 serving main path at full width; returns
    (summary, launches)."""
    args = serve_cli.parse_args(RWKV_SERVE_ARGS)
    print(" ".join(RWKV_SERVE_ARGS))
    reset_counts()
    out = serve_cli.serve(args)
    launches = counts()
    st = out["stats"]
    summary = serving_summary(out, launches)
    summary["prefill_shapes"] = out["prefill_shapes"]
    print(json.dumps({"rwkv_serving_main_path": summary}), flush=True)
    want = N_LAYERS * (st["admissions"] + st["decode_steps"])
    if launches["rwkv6_scan"] != want:
        raise AssertionError(f"rwkv6_scan launched {launches['rwkv6_scan']} "
                             f"times for {st['admissions']} admissions and "
                             f"{st['decode_steps']} decode steps")
    if any(n for name, n in launches.items() if name != "rwkv6_scan"):
        raise AssertionError(f"the RWKV6 path launched another kernel: "
                             f"{launches}")
    if out["prefill_shapes"] != [args.prompt_len]:
        raise AssertionError(f"prompts were not prefilled at their exact "
                             f"length: {out['prefill_shapes']}")
    if [len(o) for o in out["outputs"]] != out["budgets"]:
        raise AssertionError("a request did not get its budget's tokens: "
                             f"{[len(o) for o in out['outputs']]}")
    _, cfg, model, params = serve_cli.build(args)
    prompts, budgets = serve_cli.workload(args, cfg.vocab_size)
    eng = Engine(model, params, max_batch=args.max_batch,
                 max_len=out["max_len"])
    del params
    for uid in (0, 1):
        eng.submit(prompts[uid], max_new_tokens=budgets[uid])
        (alone,) = eng.run()[-1:]
        if alone.output.tolist() != out["outputs"][uid]:
            raise AssertionError(f"rwkv request {uid} served alone gave "
                                 f"{alone.output.tolist()}, batched "
                                 f"{out['outputs'][uid]}")
    print(json.dumps({"rwkv_solo_reserves_equal": [0, 1]}), flush=True)
    return summary, launches


def rwkv_reference_check():
    """Phase 16: the RWKV6 smoke config in f32 on the card and on the CPU
    from one set of parameters: prefill_into_slot into two slots (one
    prompt of 100, long enough for the chunked WKV body), 8
    decode_rows steps, a readmission over slot 0's state and 4 more steps
    (logits within 1e-4, states within 1e-4 + 1e-5 of their size at the
    end), then an engine on each device whose tokens must be equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke("rwkv6-1.6b"),
                              compute_dtype="float32")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(6)
    slots = 2
    runs = [(dev, {k: v.to(dev) for k, v in cpu.items()},
             model.init_arena(slots, 128, device=dev))
            for dev in (torch.device("cpu"), DEV)]
    worst = 0.0
    lengths = np.zeros(slots, np.int32)
    cur = np.zeros(slots, np.int32)

    def admit(slot, plen):
        nonlocal worst
        toks = rng.integers(0, cfg.vocab_size, (1, plen)).astype(np.int32)
        want, got = (model.prefill_into_slot(
            p, torch.from_numpy(toks).to(dev), plen, slot, arena)[0].cpu()
            for dev, p, arena in runs)
        worst = max(worst, float((got - want).abs().max()))
        lengths[slot] = plen
        cur[slot] = int(want[0, -1].argmax())

    def decode(steps):
        nonlocal worst, cur, lengths
        for _ in range(steps):
            want, got = (model.decode_rows(
                p, torch.from_numpy(cur)[:, None].to(dev), arena,
                torch.from_numpy(lengths).to(dev))[0][:, -1].cpu()
                for dev, p, arena in runs)
            worst = max(worst, float((got - want).abs().max()))
            cur = want.argmax(-1).numpy().astype(np.int32)
            lengths = lengths + 1

    admit(1, 100)       # the chunked body (100 >= CHUNKED_MIN_STEPS)
    admit(0, 5)
    decode(8)
    admit(0, 9)         # over the state its previous occupant left
    decode(4)
    state_ok = True
    state_err = {}
    for name, leaf in runs[0][2][0].items():
        got = runs[1][2][0][name].cpu()
        state_err[name] = float((got - leaf).abs().max())
        state_ok &= bool(((got - leaf).abs()
                          <= 1e-4 + 1e-5 * leaf.abs()).all())
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in
               (5, 100, 3, 8, 14, 2, 9)]
    budgets = [6, 3, 9, 1, 5, 7, 4]
    tokens = []
    for _, p, _ in runs:
        eng = Engine(model, p, max_batch=3, max_len=128,
                     cache_dtype=torch.float32)
        for prompt, budget in zip(prompts, budgets):
            eng.submit(prompt, max_new_tokens=budget)
        tokens.append([r.output.tolist()
                       for r in sorted(eng.run(), key=lambda r: r.uid)])
    print(json.dumps({"rwkv_reference_max_abs_err": worst,
                      "state_max_abs_err": state_err, "tolerance": 1e-4,
                      "engine_tokens_equal": tokens[0] == tokens[1]}),
          flush=True)
    # f32 sums run in another order on the card than on the CPU
    if worst > 1e-4 or not state_ok:
        raise AssertionError(f"card and CPU RWKV6 serving differ: logits "
                             f"{worst}, states {state_err}")
    if tokens[0] != tokens[1]:
        raise AssertionError("card and CPU RWKV6 engines give different "
                             "tokens")


RG_SERVE_ARGS = ["--arch", "recurrentgemma-2b"] + SERVE_ARGS[2:]
RG_LAYERS, RG_ATTN_LAYERS = 18, 8   # recurrentgemma-2b: RG-LRU, attention
RG_WIDTH = 2560
LONG_PROMPT, LONG_NEW, LONG_CAPACITY = 3000, 32, 4096
RG_WINDOW = 2048


def check_rglru_case(label, b, s, dtype, gen, pieces=1, width=None):
    """The fused RG-LRU (gate math and recurrence) at recurrentgemma-2b's
    width (or `width` channels: a rank's share on a model axis) for b rows
    of s steps from a random state: gate products, xa and
    the parameters in dtype at the model's scales (b_a, b_i near 0, lamb
    spread over (-1, 3) around the model's 1), out in dtype. Bitwise
    against the plain version (`ref.rglru_gated`: the block's former op
    sequence, then the scan), out and final state; with pieces > 1 the
    kernel also runs the steps in that many pieces, the state carried in
    place, and must equal its one pass bitwise."""
    w = width or RG_WIDTH

    def draw(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=DEV)).to(
            dtype)
    ga, gi, xa = draw(b, s, w), draw(b, s, w), draw(b, s, w)
    b_a, b_i = draw(w, scale=0.1), draw(w, scale=0.1)
    lamb = (-1.0 + 4.0 * torch.rand(w, generator=gen, device=DEV)).to(dtype)
    args = (ga, gi, b_a, b_i, lamb, xa)
    state = torch.randn((b, w), generator=gen, device=DEV)
    got_state = state.clone()
    out, _ = ops.rglru_scan(*args, got_state)
    torch.cuda.synchronize()
    want, want_state = ref.rglru_gated(*args, state)
    bitwise = bool(torch.equal(out, want) and torch.equal(got_state,
                                                          want_state))
    max_err = max(float((out.float() - want.float()).abs().max()),
                  float((got_state - want_state).abs().max()))
    del want, want_state
    pieces_bitwise = None
    if pieces > 1:
        carried = state.clone()
        cut = s // pieces
        parts = [ops.rglru_scan(ga[:, x:x + cut], gi[:, x:x + cut], b_a, b_i,
                                lamb, xa[:, x:x + cut], carried)[0]
                 for x in range(0, s, cut)]
        pieces_bitwise = bool(torch.equal(torch.cat(parts, dim=1), out)
                              and torch.equal(carried, got_state))
        del parts, carried
    del out
    scratch = state.clone()
    per_call = device_launches(lambda: ops.rglru_scan(*args, scratch))
    t = timings(lambda: ops.rglru_scan(*args, scratch),
                lambda: ref.rglru_gated(*args, state), None,
                iters=20 if s > 1000 else 50)
    cost = costs.rglru_scan(*args, state)
    nbytes, flops = cost.bytes, cost.flops
    t_bytes, t_ops = bound_terms(cost)
    case = {"case": label, "dtype": str(dtype),
            "shape": [list(xa.shape), list(state.shape)],
            "max_abs_err": max_err, "bitwise": bitwise,
            "tolerance": "bitwise (out and final state)",
            "device_launches_per_call": per_call,
            "pieces": pieces, "pieces_equal_one_pass_bitwise": pieces_bitwise,
            **t, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
            "achieved_GBps": nbytes / t["kernel_ms"] / 1e6}
    print(json.dumps(case), flush=True)
    if not bitwise or pieces_bitwise is False:
        raise AssertionError(f"rglru_scan kernel disagrees with its plain "
                             f"version on {label}: {case}")
    if per_call != 1:
        raise AssertionError(f"rglru_scan made {per_call} device launches "
                             f"in a call on {label}, expected 1")
    return case


def _assert_hybrid_launches(what, launches, admissions, steps):
    """18 RG-LRU launches per admission and decode step, 8 flash launches
    per admission, 8 decode launches per step, and no other kernel."""
    want = {"rglru_scan": RG_LAYERS * (admissions + steps),
            "flash_attention": RG_ATTN_LAYERS * admissions,
            "decode_attention": RG_ATTN_LAYERS * steps}
    want.update({name: 0 for name in launches if name not in want})
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want} "
                             f"for {admissions} admissions and {steps} "
                             "decode steps")


def hybrid_serve_main_path():
    """Phase 19: the recurrentgemma-2b serving main path at full width and
    depth, solo re-serves, and the long-prompt arm; returns (summary,
    launches)."""
    args = serve_cli.parse_args(RG_SERVE_ARGS)
    print(" ".join(RG_SERVE_ARGS))
    reset_counts()
    out = serve_cli.serve(args)
    launches = counts()
    st = out["stats"]
    summary = serving_summary(out, launches)
    summary["prefill_shapes"] = out["prefill_shapes"]
    print(json.dumps({"hybrid_serving_main_path": summary}), flush=True)
    _assert_hybrid_launches("the hybrid serving main path", launches,
                            st["admissions"], st["decode_steps"])
    if out["prefill_shapes"] != [args.prompt_len]:
        raise AssertionError(f"prompts were not prefilled at their exact "
                             f"length: {out['prefill_shapes']}")
    if [len(o) for o in out["outputs"]] != out["budgets"]:
        raise AssertionError("a request did not get its budget's tokens: "
                             f"{[len(o) for o in out['outputs']]}")
    torch.cuda.empty_cache()
    _, cfg, model, params = serve_cli.build(args)
    prompts, budgets = serve_cli.workload(args, cfg.vocab_size)
    eng = Engine(model, params, max_batch=args.max_batch,
                 max_len=out["max_len"])
    for uid in (0, 1):
        eng.submit(prompts[uid], max_new_tokens=budgets[uid])
        (alone,) = eng.run()[-1:]
        if alone.output.tolist() != out["outputs"][uid]:
            raise AssertionError(f"hybrid request {uid} served alone gave "
                                 f"{alone.output.tolist()}, batched "
                                 f"{out['outputs'][uid]}")
    print(json.dumps({"hybrid_solo_reserves_equal": [0, 1]}), flush=True)
    del eng
    torch.cuda.empty_cache()

    # the long prompt: the 2048-token ring wraps and the window binds
    eng = Engine(model, params, max_batch=args.max_batch,
                 max_len=LONG_CAPACITY)
    del params
    ring = eng._caches[1]["k"].shape[2]
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (LONG_PROMPT,))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    eng.submit(prompt, max_new_tokens=LONG_NEW)
    (done,) = eng.run()
    total = time.perf_counter() - t0
    long_launches = counts()
    lst = eng.stats
    long_arm = {
        "prompt": LONG_PROMPT, "new_tokens": LONG_NEW,
        "capacity": eng.capacity, "ring": ring, "window": RG_WINDOW,
        "seconds": total, "tokens": len(done.output),
        "prefill_ms": (lst["admit_host_s"] + lst["prefill_wait_s"]) * 1e3,
        "decode_ms_per_step": lst["decode_s"] / lst["decode_steps"] * 1e3,
        "decode_steps": lst["decode_steps"],
        "prefill_shapes": sorted(eng.prefill_shapes),
        "peak_GB": torch.cuda.max_memory_allocated() / 1e9,
        "launches": long_launches}
    print(json.dumps({"hybrid_long_prompt": long_arm}), flush=True)
    if ring != RG_WINDOW or eng.capacity != LONG_CAPACITY:
        raise AssertionError(f"the ring holds {ring} rows at capacity "
                             f"{eng.capacity}, expected {RG_WINDOW} at "
                             f"{LONG_CAPACITY}")
    if len(done.output) != LONG_NEW or sorted(eng.prefill_shapes) != [
            LONG_PROMPT]:
        raise AssertionError(f"the long prompt was not served whole: "
                             f"{long_arm}")
    _assert_hybrid_launches("the long prompt", long_launches,
                            lst["admissions"], lst["decode_steps"])
    del eng
    torch.cuda.empty_cache()
    return summary, launches


def _close(got, want, atol):
    """(ok, max |got - want|): every element within atol + 1e-5 |want|."""
    err = (got.float() - want.float()).abs()
    return bool((err <= atol + 1e-5 * want.float().abs()).all()), float(
        err.max())


def hybrid_reference_check():
    """Phase 20: card against CPU from one set of parameters, f32: the
    smoke config (window 32) with prompts past the window, a readmission
    over a used slot and decode steps, and engines whose tokens must be
    equal; then recurrentgemma-2b's widths cut to 3 layers and vocab 512,
    so that hd 256 and G = 10 go through the model on both devices."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu_dev = torch.device("cpu")
    smoke = dataclasses.replace(get_smoke("recurrentgemma-2b"),
                                compute_dtype="float32")
    wide = dataclasses.replace(get_config("recurrentgemma-2b"), num_layers=3,
                               layer_types=("rglru", "rglru", "attn"),
                               vocab_size=512, compute_dtype="float32")
    report = {}
    for name, cfg, plan in (
            ("smoke", smoke, ((1, 40), (0, 11), 8, (0, 23), 4)),
            ("full_width_3_layers", wide, ((1, 40), (0, 11), 4, (0, 23),
                                           2))):
        model = build_model(cfg)
        cpu = model.init(torch.Generator().manual_seed(0))
        runs = [(dev, {k: v.to(dev) for k, v in cpu.items()},
                 model.init_arena(2, 64, dtype=torch.float32, device=dev))
                for dev in (cpu_dev, DEV)]
        rng = np.random.default_rng(8)
        lengths = np.zeros(2, np.int32)
        cur = np.zeros(2, np.int32)
        worst = 0.0
        for item in plan:
            if isinstance(item, tuple):
                slot, plen = item
                toks = rng.integers(0, cfg.vocab_size, (1, plen)).astype(
                    np.int32)
                want, got = (model.prefill_into_slot(
                    p, torch.from_numpy(toks).to(dev), plen, slot,
                    arena)[0].cpu() for dev, p, arena in runs)
                worst = max(worst, float((got - want).abs().max()))
                lengths[slot], cur[slot] = plen, int(want[0, -1].argmax())
                continue
            for _ in range(item):
                want, got = (model.decode_rows(
                    p, torch.from_numpy(cur)[:, None].to(dev), arena,
                    torch.from_numpy(lengths).to(dev))[0][:, -1].cpu()
                    for dev, p, arena in runs)
                worst = max(worst, float((got - want).abs().max()))
                cur = want.argmax(-1).numpy().astype(np.int32)
                lengths = lengths + 1
        state_ok, state_err = True, {}
        for si, (cseg, gseg) in enumerate(zip(runs[0][2], runs[1][2])):
            for leaf, c in cseg.items():
                ok, err = _close(gseg[leaf].cpu(), c, 1e-4)
                state_ok &= ok
                state_err[f"{si}.{leaf}"] = err
        report[name] = {"logits_max_abs_err": worst,
                        "state_max_abs_err": max(state_err.values())}
        if name == "smoke":
            prompts = [rng.integers(0, cfg.vocab_size, (n,))
                       for n in (40, 9, 33, 5, 50, 3)]
            budgets = [12, 12, 6, 20, 8, 9]
            tokens = []
            for _, p, _ in runs:
                eng = Engine(model, p, max_batch=3, max_len=64,
                             cache_dtype=torch.float32)
                for prompt, budget in zip(prompts, budgets):
                    eng.submit(prompt, max_new_tokens=budget)
                tokens.append([r.output.tolist() for r in
                               sorted(eng.run(), key=lambda r: r.uid)])
            report[name]["engine_tokens_equal"] = tokens[0] == tokens[1]
            if tokens[0] != tokens[1]:
                raise AssertionError("card and CPU hybrid engines give "
                                     "different tokens")
        # f32 sums run in another order on the card than on the CPU
        if worst > 1e-4 or not state_ok:
            raise AssertionError(f"card and CPU hybrid serving differ "
                                 f"({name}): logits {worst}, states "
                                 f"{state_err}")
        del runs, cpu
    print(json.dumps({"hybrid_reference": report, "tolerance":
                      "logits 1e-4; states 1e-4 + 1e-5 |x|"}), flush=True)


def scheduler_summary(out):
    """The numbers the two schedulers are compared by, from a serve()
    output."""
    st = out["stats"]
    return {"tokens_per_s": out["tokens_per_s"], "p50_s": out["p50_s"],
            "p99_s": out["p99_s"], "prefill_wait_s": st["prefill_wait_s"],
            "admit_host_s": st["admit_host_s"],
            "prefill_ms_per_admission": (st["admit_host_s"]
                                         + st["prefill_wait_s"])
            / st["admissions"] * 1e3,
            "decode_steps": st["decode_steps"],
            "decode_ms_per_step": st["decode_s"] / st["decode_steps"] * 1e3,
            "mixed_steps": st["mixed_steps"],
            "overlapped_admissions": st["overlapped_admissions"],
            "overlap_mode": st["overlap_mode"],
            "preemptions": st["preemptions"]}


def serialized_arms(arena, paged):
    """Phase 22: phase 7's, phase 11's (main path and the 112-block
    "recompute" arm) and phase 12's workloads again through
    `Engine(..., overlap=False)`: every request's tokens must equal the
    overlapped run's. Returns the serialized arms' kernel launches by
    path."""
    report, launches = {}, {}
    arms = [("arena", SERVE_ARGS, arena),
            ("paged", PAGED_SERVE_ARGS, paged["paged"]),
            ("paged_scarce_recompute",
             PAGED_SERVE_ARGS + ["--num-blocks", str(SCARCE_BLOCKS)],
             paged["scarce"])]
    for name, argv, overlapped in arms:
        print(" ".join(argv), "(overlap=False)")
        reset_counts()
        out = serve_cli.serve(serve_cli.parse_args(argv), overlap=False)
        launches[name] = counts()
        st = out["stats"]
        if st["overlap_mode"] or st["mixed_steps"]:
            raise AssertionError(f"{name}: overlap=False ran overlapped: "
                                 f"{st}")
        differ = [u for u, (a, b) in enumerate(zip(out["outputs"],
                                                   overlapped["outputs"]))
                  if a != b]
        if differ or len(out["outputs"]) != len(overlapped["outputs"]):
            raise AssertionError(f"{name}: overlapped and serialized tokens "
                                 f"differ for requests {differ}")
        report[name] = {"requests_equal": len(out["outputs"]),
                        "overlapped": scheduler_summary(overlapped),
                        "serialized": scheduler_summary(out)}
        if name == "paged_scarce_recompute" and (
                st["preemptions"] != overlapped["stats"]["preemptions"]):
            print(json.dumps({"scarce_preemptions": {
                "overlapped": overlapped["stats"]["preemptions"],
                "serialized": st["preemptions"]}}), flush=True)
        torch.cuda.empty_cache()
    return report, launches


def ring_arms(ring_summary, ring_outputs):
    """Phase 22, the ring: phase 12's workload through
    `Engine(..., overlap=False)`, tokens equal request by request."""
    summary, launches, outputs = ring_serving(overlap=False)
    differ = [u for u, (a, b) in enumerate(zip(outputs, ring_outputs))
              if a != b]
    if differ:
        raise AssertionError(f"ring: overlapped and serialized tokens "
                             f"differ for requests {differ}")
    keys = ("tokens_per_s", "p50_s", "p99_s", "decode_steps",
            "decode_ms_per_step", "prefill_ms_per_admission")
    pick = {}
    for arm, summ in (("overlapped", ring_summary),
                      ("serialized", summary)):
        st = summ["stats"]
        pick[arm] = {**{k: summ[k] for k in keys},
                     "prefill_wait_s": st["prefill_wait_s"],
                     "mixed_steps": st["mixed_steps"],
                     "overlapped_admissions": st["overlapped_admissions"],
                     "overlap_mode": st["overlap_mode"]}
    return {"requests_equal": len(outputs), **pick}, launches


def mixed_reference_check(arch="qwen2-0.5b"):
    """Phase 23: `arch`'s smoke config in f32 (TF32 off), one set of
    parameters:
    two live rows and three mixed steps prefilling the middle slot (the
    arena: three prompts; the pool and the ring: three chunks of one
    prompt) on the card and on the CPU; logits within 1e-4 and equal
    greedy tokens, from the logits and from the `*_tokens` entry
    points."""
    from repro_torch.models import transformer as TF

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    devs = (torch.device("cpu"), DEV)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (11, 6, 4, 9, 13)]
    report = {}

    def compare(name, pairs, token_pairs):
        worst = max(float((got.cpu() - want).abs().max())
                    for want, got in pairs)
        equal = all(bool((got.cpu().argmax(-1) == want.argmax(-1)).all())
                    for want, got in pairs)
        equal &= all(torch.equal(want, got.cpu())
                     for want, got in token_pairs)
        report[name] = {"max_abs_err": worst, "tokens_equal": equal}
        if worst > 1e-4 or not equal:
            raise AssertionError(f"mixed step {name}: card and CPU differ "
                                 f"({report[name]})")

    for window in (0, 16):
        model = build_model(cfg, window=window)
        cpu = model.init(torch.Generator().manual_seed(0))
        params = [{k: v.to(d) for k, v in cpu.items()} for d in devs]
        cur = np.array([3, 0, 5], np.int32)
        pairs, token_pairs = [], []
        if not window:
            arenas = [model.init_arena(3, 32, dtype=torch.float32, device=d)
                      for d in devs]
            pos = np.array([11, 0, 6], np.int32)
            for slot, prompt in zip((0, 2), prompts[:2]):
                toks = np.zeros((1, 16), np.int32)
                toks[0, :len(prompt)] = prompt
                for d, p, a in zip(devs, params, arenas):
                    model.prefill_into_slot(p, torch.from_numpy(toks).to(d),
                                            len(prompt), slot, a)
            for prompt in prompts[2:]:
                toks = np.zeros((1, 16 if len(prompt) > 8 else 8), np.int32)
                toks[0, :len(prompt)] = prompt
                probe = [[{k: v.clone() for k, v in seg.items()}
                          for seg in a] for a in arenas]
                (wd, wp, _), (gd, gp, _) = [TF.mixed_step(
                    cfg, p, torch.from_numpy(cur).to(d), a,
                    torch.from_numpy(pos).to(d),
                    torch.from_numpy(toks).to(d), len(prompt), 1)
                    for d, p, a in zip(devs, params, probe)]
                pairs += [(wd[[0, 2]], gd[[0, 2]]), (wp, gp)]
                (wn, _, wpos, wt), (gn, _, gpos, gt) = [
                    model.mixed_step_tokens(
                        p, torch.from_numpy(cur).to(d), a,
                        torch.from_numpy(pos).to(d),
                        torch.from_numpy(toks).to(d), len(prompt), 1)
                    for d, p, a in zip(devs, params, arenas)]
                token_pairs += [(wn[[0, 2]], gn[[0, 2]]), (wpos, gpos),
                                (wt, gt)]
                cur = wn.numpy().copy()
                cur[1] = int(wt)
                pos = wpos.numpy().copy()
                pos[1] = len(prompt)
            compare("arena", pairs, token_pairs)
            continue
        for name, win in (("paged", 0), ("ring", window)):
            model = build_model(cfg, window=win)
            pools = [model.init_pool(24, 4, dtype=torch.float32, device=d)
                     for d in devs]
            tables = np.zeros((3, 8), np.int32)
            tables[0, :3] = [5, 2, 9]
            tables[2, :2] = [7, 1]
            lengths = np.array([11, 0, 6], np.int32)
            for row, prompt in zip((0, 2), prompts[:2]):
                toks = np.zeros((1, 16), np.int32)
                toks[0, :len(prompt)] = prompt
                for d, p, pool in zip(devs, params, pools):
                    model.prefill_chunk_into_blocks(
                        p, torch.from_numpy(toks).to(d), len(prompt), 0,
                        torch.from_numpy(tables[row]).to(d), pool)
            c_table = np.array([12, 13, 14, 0], np.int32)
            free = iter([3, 4, 6, 8, 10, 11])
            cur = np.array([3, 0, 5], np.int32)
            for i in range(3):
                for row in (0, 2):
                    at = int(lengths[row]) % (win or 1 << 30)
                    if tables[row, at // 4] == 0:
                        tables[row, at // 4] = next(free)
                part = prompts[4][i * 4:(i + 1) * 4]
                toks = np.zeros((1, 4), np.int32)
                toks[0, :len(part)] = part
                ops_in = [(p, pool, torch.from_numpy(cur).to(d),
                           torch.from_numpy(tables).to(d),
                           torch.from_numpy(lengths).to(d),
                           torch.from_numpy(toks).to(d),
                           torch.from_numpy(c_table).to(d))
                          for d, p, pool in zip(devs, params, pools)]
                probe = [[{k: v.clone() for k, v in seg.items()}
                          for seg in pool] for pool in pools]
                (wd, wc, _), (gd, gc, _) = [TF.mixed_step_paged(
                    cfg, p, c, pr, t, ln, tk, len(part), i * 4, ct,
                    window=win)
                    for (p, _, c, t, ln, tk, ct), pr in zip(ops_in, probe)]
                pairs += [(wd[[0, 2]], gd[[0, 2]]), (wc, gc)]
                (wn, _, wl, wt), (gn, _, gl, gt) = [
                    model.mixed_step_paged_tokens(p, c, pool, t, ln, tk,
                                                  len(part), i * 4, ct)
                    for p, pool, c, t, ln, tk, ct in ops_in]
                token_pairs += [(wn[[0, 2]], gn[[0, 2]]), (wl, gl)]
                if i == 2:
                    token_pairs.append((wt, gt))
                cur = wn.numpy().copy()
                lengths = wl.numpy().copy()
                lengths[1] = 0
            compare(name, pairs, token_pairs)
            pairs, token_pairs = [], []
    print(json.dumps({"mixed_reference": report, "arch": arch,
                      "tolerance": 1e-4}),
          flush=True)


# the mixed trunk's shared products: (name, leaf of layer 0), where the
# config has the leaf
SHARED_PRODUCTS = (("wq", "attn.wq"), ("wk", "attn.wk"), ("wv", "attn.wv"),
                   ("wq_a", "attn.wq_a"), ("wq_b", "attn.wq_b"),
                   ("wkv_a", "attn.wkv_a"),
                   ("wo", "attn.wo"), ("w_gate", "mlp.w_gate"),
                   ("w_up", "mlp.w_up"), ("w_down", "mlp.w_down"))


def _row_stability(params, h_rows, p_rows, gen):
    """Bitwise row stability of the mixed trunk's shared ops at the main
    path's shapes: each op on B decode rows and on S prefill rows alone
    against the same rows of one [1, B + S, .] call, max |difference| of
    (decode rows, prefill rows), layer 0's weights, unit-normal inputs
    (the ops' kernels are chosen by shape, not values). The products,
    rmsnorm over d_model, qk-norm over hd on [rows, heads, hd] where the
    config has it, and the unembedding on the B + 1 rows the mixed step
    selects (B decode rows against the prompt's last one); beside each
    norm, its f32 mean of squares ("_f32_mean"), where another summation
    order shows at once, though it tips the bf16 output only now and
    then. An MLA layer has MLA's down products (wq_a, wkv_a), wq_b and
    its q_norm and kv_norm (over q_lora and r, one per token)."""
    from repro_torch.models.layers import rmsnorm

    out = {}

    def one(name, width, fn, p=p_rows, heads=()):
        xd = torch.randn((h_rows, 1) + heads + (width,), generator=gen,
                         device=DEV).to(torch.bfloat16)
        xp = torch.randn((1, p) + heads + (width,), generator=gen,
                         device=DEV).to(torch.bfloat16)
        xm = torch.cat([xd.transpose(0, 1), xp], dim=1)
        full = fn(xm)[0]
        out[name] = [float((fn(xd)[:, 0].float() - full[:h_rows].float())
                           .abs().max()),
                     float((fn(xp)[0].float() - full[h_rows:].float())
                           .abs().max())]

    for name, leaf in SHARED_PRODUCTS:
        w = params.get(f"segments.0.{leaf}")
        if w is not None:
            one(name, w.shape[1], lambda x, w=w[0]: x @ w)
    def mean_sq(x):
        x = x.float()
        return torch.mean(x * x, dim=-1)

    scale = {"scale": params["segments.0.ln1.scale"][0]}
    d = scale["scale"].shape[0]
    one("rmsnorm", d, lambda x: rmsnorm(scale, x))
    one("rmsnorm_f32_mean", d, mean_sq)
    mla = "segments.0.attn.wkv_a" in params
    for name in ("q_norm", "kv_norm") if mla else ():
        w = params[f"segments.0.attn.{name}.scale"]
        one(name, w.shape[1], lambda x, w=w[0]: rmsnorm({"scale": w}, x))
        one(f"{name}_f32_mean", w.shape[1], mean_sq)
    for name in () if mla else ("q_norm", "k_norm"):
        w = params.get(f"segments.0.attn.{name}.scale")
        if w is not None:
            heads = params["segments.0.attn.wq" if name == "q_norm"
                           else "segments.0.attn.wk"].shape[2] // w.shape[1]
            one(name, w.shape[1], lambda x, w=w[0]: rmsnorm({"scale": w}, x),
                heads=(heads,))
            one(f"{name}_f32_mean", w.shape[1], mean_sq, heads=(heads,))
    head = params.get("head")
    if head is None:
        head = params["embed.table"].T
    one("unembed", head.shape[0], lambda x: x @ head, p=1)
    return out


# phase 26's sweep: the engine's prompt buckets (powers of two from its
# floor of 8 up to the arena's capacity of 512) and the pool's chunk of
# 32, each beside B = 1, 4 and 8 decode rows
SWEEP_SP = (8, 16, 32, 64, 128, 256, 512)
SWEEP_B = (1, 4, 8)
SWEEP_CHUNK = 32


def _per_half(op):
    """Whether the mixed step runs the op of a row-stability report per
    half: the products of `attention.MIXED_PER_HALF`, and every norm (the
    layer norms, qk-norm and MLA's q_norm and kv_norm go through
    `mixed_norm`)."""
    from repro_torch.models.attention import MIXED_PER_HALF

    base = op.replace("_f32_mean", "")
    return base in MIXED_PER_HALF or base in ("q_norm", "k_norm", "kv_norm")


def dense_row_stability(gen, configs=None, out="row_stability_sweep.json"):
    """Phase 26: `_row_stability` at every dense config's widths (layer 0's
    weights and the unembedding, random bf16, made on the card; `configs`
    in place of those, as phase 41 gives the dense MLA stack), for the
    arena's mixed batch (B decode rows + Sp prompt rows, every prompt
    bucket) and the pool's (B + C = 32), B = 1, 4, 8. Prints one JSON line:
    for each config, each op that is not bitwise row-stable with the
    shapes where it is not and their largest difference, and the shared
    ops among them (those the mixed step does not run per half). Writes
    the whole report to build/`out`. Raises if a shared op is not
    row-stable at some shape: there the overlapped engine's tokens could
    leave the serialized ones."""
    from repro_torch.models import transformer as TF
    from repro_torch.models.layers import _he

    bf = torch.bfloat16
    report, unstable, shared = {}, {}, {}
    if configs is None:
        configs = [get_config(a) for a in ("qwen2-0.5b",) + DENSE_ARCHS]
    for cfg in configs:
        arch = cfg.name
        params = {f"segments.0.{k}": v for k, v in TF.block_init(
            gen, (1,), cfg, "attn", bf).items()}
        params["head"] = _he(gen, (cfg.d_model, cfg.vocab_size), bf,
                             cfg.d_model)
        shapes = {f"arena_B{b}_Sp{sp}": (b, sp)
                  for b in SWEEP_B for sp in SWEEP_SP}
        shapes.update({f"pool_B{b}_C{SWEEP_CHUNK}": (b, SWEEP_CHUNK)
                       for b in SWEEP_B})
        report[arch] = {name: _row_stability(params, b, p, gen)
                        for name, (b, p) in shapes.items()}
        del params
        torch.cuda.empty_cache()
        ops_ = {}
        for shape, r in report[arch].items():
            for op, d in r.items():
                if any(d):
                    ops_.setdefault(op, {})[shape] = max(d)
        unstable[arch] = ops_
        moved = sorted(op for op in ops_ if not _per_half(op))
        if moved:
            shared[arch] = {op: ops_[op] for op in moved}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", out), "w") as f:
        json.dump(report, f)
    print(json.dumps({"row_stability_sweep": {
        "Sp": SWEEP_SP, "B": SWEEP_B, "pool_chunk": SWEEP_CHUNK,
        "not_row_stable": {arch: {op: {"shapes": len(v),
                                       "max_abs": max(v.values())}
                                  for op, v in ops_.items()}
                           for arch, ops_ in unstable.items()},
        "shared_not_row_stable": shared}}), flush=True)
    if shared:
        raise AssertionError(f"shared ops of the mixed step are not "
                             f"row-stable: {shared}")
    return report


# steps each of phase 24's profiles counts and times (each holds some
# 3,000-5,000 device launches a step; 5 until phase 49's TP arm came)
MIXED_PROFILE_CALLS = 3


def profile_mixed_steps():
    """Phase 24: one arena mixed step (8 rows, one slot dead, a 200-token
    prompt at Sp = 256) and one pool and one ring mixed step (8 rows, a
    32-token chunk) at full qwen2-0.5b width, each beside a decode step
    plus the standalone prefill (or chunk) on the same state: kernel
    launches per mixed step (asserted), device launches and device ms
    (torch.profiler), the largest |logit| difference between the mixed
    step's decode rows and a standalone decode step, and the
    admission's against its standalone prefill, with the products of
    `attention.MIXED_PER_HALF` per half (the port) and shared (what it
    would be without the split), and each shared op's row stability."""
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as TF
    from repro_torch.serve.bucketing import table_width

    args = serve_cli.parse_args(SERVE_ARGS)
    _, cfg, model, params = serve_cli.build(args)
    # the engine's one cast, so each call casts nothing
    params = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
              for k, v in params.items()}
    prompts, _ = serve_cli.workload(args, cfg.vocab_size)
    b, dead, plen = 8, 3, len(prompts[0])
    gen = torch.Generator(device=DEV).manual_seed(3)
    cur = torch.tensor([int(p[-1]) for p in prompts[:b]], dtype=torch.int32,
                       device=DEV)
    report = {}

    def clone(caches):
        return [{k: v.clone() for k, v in seg.items()} for seg in caches]

    def logit_gaps(mixed_fn, decode_fn, prefill_fn, caches):
        gaps, per_half = {}, A.MIXED_PER_HALF
        for split in (True, False):
            A.MIXED_PER_HALF = per_half if split else frozenset()
            try:
                ld, lp, _ = mixed_fn(clone(caches))
            finally:
                A.MIXED_PER_HALF = per_half
            live = [r for r in range(b) if r != dead]
            c = clone(caches)
            want_d = decode_fn(c)
            want_p = prefill_fn(c)
            gaps["per_half" if split else "shared"] = {
                "decode_rows": float((ld[live] - want_d[live]).abs().max()),
                "admission": float((lp - want_p).abs().max())}
        return gaps

    def measure(name, mixed, serial, want_launches, gaps, rows):
        reset_counts()
        mixed()
        torch.cuda.synchronize()
        got = {k: v for k, v in counts().items() if v}
        if got != want_launches:
            raise AssertionError(f"{name} mixed step launched {got}, "
                                 f"expected {want_launches}")
        n_mixed = device_launches(mixed, calls=MIXED_PROFILE_CALLS)
        n_serial = device_launches(serial, calls=MIXED_PROFILE_CALLS)
        report[name] = {
            "kernel_launches_per_mixed_step": got,
            "mixed_step": {"device_launches": n_mixed,
                           "device_ms": device_ms(mixed, MIXED_PROFILE_CALLS,
                                                  launches=n_mixed)},
            "decode_step_plus_standalone": {
                "device_launches": n_serial,
                "device_ms": device_ms(serial, MIXED_PROFILE_CALLS,
                                       launches=n_serial)},
            "max_abs_logit_diff": gaps, "row_stability": rows}
        print(json.dumps({f"mixed_step_profile_{name}": report[name]}),
              flush=True)

    # the arena: 7 live rows of 200-token prompts, slot 3 dead
    arena = model.init_arena(b, 512, device=DEV)
    sp = 256
    toks = [torch.zeros((1, sp), dtype=torch.int32, device=DEV)
            for _ in range(b)]
    for slot, p in enumerate(prompts[:b]):
        toks[slot][0, :plen] = torch.from_numpy(p.astype(np.int32))
        if slot != dead:
            model.prefill_into_slot_token(params, toks[slot], plen, slot,
                                          arena)
    pos = torch.full((b,), plen, dtype=torch.int32, device=DEV)
    p_toks = toks[dead]
    gaps = logit_gaps(
        lambda c: TF.mixed_step(cfg, params, cur, c, pos, p_toks, plen,
                                dead),
        lambda c: TF.decode_rows(cfg, params, cur[:, None], c, pos)[0],
        lambda c: TF.prefill_into_slot(cfg, params, p_toks, plen, dead,
                                       c)[0], arena)
    measure("arena_B8_Sp256",
            lambda: model.mixed_step_tokens(params, cur, arena, pos, p_toks,
                                            plen, dead),
            lambda: (model.decode_rows_tokens(params, cur, arena, pos),
                     model.prefill_into_slot_token(params, p_toks, plen,
                                                   dead, arena)),
            {"flash_attention": N_LAYERS, "decode_attention": N_LAYERS},
            gaps, _row_stability(params, b, sp, gen))
    del arena
    torch.cuda.empty_cache()

    # the pool and the ring: 7 live rows, the dead row's chunk 3 (ctx 96)
    c, bs = 32, 16
    for name, window in (("paged_B8_C32", 0), ("ring_B8_C32", RING_WINDOW)):
        wmodel = build_model(cfg, window=window)
        w = table_width(plen + 1, bs, 256, window=window)
        pool = wmodel.init_pool(8 * w + w, bs, device=DEV)
        tables = torch.zeros((b, w), dtype=torch.int32, device=DEV)
        for row in range(b):
            if row != dead:
                tables[row] = torch.arange(1 + row * w, 1 + (row + 1) * w,
                                           dtype=torch.int32, device=DEV)
        c_table = torch.arange(1 + b * w, 1 + (b + 1) * w, dtype=torch.int32,
                               device=DEV)
        for row, p in enumerate(prompts[:b]):
            table = c_table if row == dead else tables[row]
            for i in range(4 if row == dead else -(-plen // c)):
                chunk = torch.zeros((1, c), dtype=torch.int32, device=DEV)
                part = torch.from_numpy(p[i * c:(i + 1) * c].astype(np.int32))
                chunk[0, :len(part)] = part
                if row == dead and i == 3:
                    ctoks = chunk      # chunk 3 rides the mixed step
                    break
                wmodel.prefill_chunk_into_blocks_token(
                    params, chunk, len(part), i * c, table, pool)
        lengths = torch.full((b,), plen, dtype=torch.int32, device=DEV)
        lengths[dead] = 0
        gaps = logit_gaps(
            lambda cc: TF.mixed_step_paged(cfg, params, cur, cc, tables,
                                           lengths, ctoks, c, 3 * c, c_table,
                                           window=window),
            lambda cc: TF.decode_rows_paged(cfg, params, cur[:, None], cc,
                                            tables, lengths,
                                            window=window)[0],
            lambda cc: TF.prefill_chunk_into_blocks(
                cfg, params, ctoks, c, 3 * c, c_table, cc,
                window=window)[0], pool)
        kernel = "decode_attention_ring" if window else "decode_attention_paged"
        measure(name,
                lambda: wmodel.mixed_step_paged_tokens(
                    params, cur, pool, tables, lengths, ctoks, c, 3 * c,
                    c_table),
                lambda: (wmodel.decode_rows_paged_tokens(
                    params, cur, pool, tables, lengths),
                    wmodel.prefill_chunk_into_blocks_token(
                        params, ctoks, c, 3 * c, c_table, pool)),
                {kernel: N_LAYERS}, gaps,
                _row_stability(params, b, c, gen))
        del pool
        torch.cuda.empty_cache()
    return report


def dense_serving(arch, paged=False, layers=0):
    """Phase 27: `arch` at full width and depth (`layers`: cut to that
    many, through --layers) on phase 7's workload with its budgets halved
    (`paged`: phase 11's pool, 256 blocks of 16, chunks of 32) through
    `repro_torch.launch.serve` at the engine's default (overlapped), then
    through `overlap=False`: one flash launch per layer an admission and
    one decode (paged) launch per layer a step in both, every request
    served to its budget, the pool's blocks all returned, and every
    request's tokens equal between the schedulers. Returns (the
    overlapped run's launches, the serialized run's)."""
    argv = ["--arch", arch] + DENSE_SERVE_ARGS
    if paged:
        argv += ["--paged", "--block-size", "16"]
    if layers:
        argv += ["--layers", str(layers)]
    n_layers = layers or get_config(arch).num_layers
    decode = "decode_attention_paged" if paged else "decode_attention"
    runs, launches = {}, {}
    for overlap in (True, False):
        print(" ".join(argv), f"(overlap={overlap})")
        reset_counts()
        out = serve_cli.serve(serve_cli.parse_args(argv), overlap=overlap)
        got = counts()
        st = out["stats"]
        if overlap:
            assert_overlapped(f"{arch} {decode}", st)
        elif st["overlap_mode"] or st["mixed_steps"]:
            raise AssertionError(f"{arch}: overlap=False ran overlapped")
        want = {"flash_attention": 0 if paged else n_layers
                * st["admissions"], decode: n_layers * st["decode_steps"]}
        want.update({k: 0 for k in got if k not in want})
        if got != want:
            raise AssertionError(f"{arch} (overlap={overlap}): launches "
                                 f"{got}, expected {want}")
        if [len(o) for o in out["outputs"]] != out["budgets"]:
            raise AssertionError(f"{arch}: a request did not get its budget")
        if paged and out["free_blocks"] != out["num_blocks"]:
            raise AssertionError(f"{arch}: blocks were not returned")
        runs[overlap], launches[overlap] = out, got
        summary = serving_summary(out, got)
        summary["decode_launches_per_step"] = got[decode] / st["decode_steps"]
        print(json.dumps({f"dense_serving_{arch}_"
                          f"{'paged' if paged else 'arena'}_"
                          f"{'overlapped' if overlap else 'serialized'}":
                          summary}), flush=True)
        del out
        torch.cuda.empty_cache()
    differ = [u for u, (a, b) in enumerate(zip(runs[True]["outputs"],
                                               runs[False]["outputs"]))
              if a != b]
    if differ:
        raise AssertionError(f"{arch}: overlapped and serialized tokens "
                             f"differ for requests {differ}")
    print(json.dumps({"dense_schedulers_equal": {
        "arch": arch, "paged": paged,
        "requests_equal": len(runs[True]["outputs"])}}), flush=True)
    return launches[True], launches[False]


# phase 29: internlm2-1.8b at full width cut to 2 of its 24 layers; the
# card against the CPU with A=2 agents and M=1 walk
TRAIN_CUT_LAYERS = 2
CPU_AGENTS, CPU_WALKS = 2, 1


def _state_close(card, cpu, atol_fn):
    """{part: (ok, max |card - cpu|)}: each leaf of each part within
    atol_fn(cpu leaf, part)."""
    out = {}
    for part, leaves in cpu.items():
        ok, worst = True, 0.0
        for k, want in leaves.items():
            err = (card[part][k].cpu().float() - want.float()).abs()
            ok &= bool((err <= atol_fn(want.float(), part)).all())
            worst = max(worst, float(err.max()))
        out[part] = (ok, worst)
    return out


def dense_training():
    """Phase 29: one API-BCD superstep of internlm2-1.8b at full width,
    depth cut to 2 of 24 layers, A=4, M=2, B=2, S=256 (phase 4's
    settings), in its own dtypes (bf16 compute) on the card, one
    prox_update launch a leaf; then in f32 from one state on the card and
    on the CPU (the plain versions), which must agree (loss rtol 1e-4,
    state 1e-4, phase 5's), at A=2, M=1 (CPU_AGENTS): the CPU's copy of
    the state at A=4, M=2 would hold 40 GB of the host's memory beside
    the step's temporaries, at A=2, M=1 16 GB. Then one superstep of
    nemotron's smoke config with its full config's bf16 parameters (f32
    compute), card against CPU: the update runs on bf16 leaves, and every
    leaf lies within one bf16 ulp of its value plus one of the leaf's
    largest |value| of the CPU's (both round the same f32 gradient and
    update to bf16, where the f32 sums' order can tip a rounding, and a
    gradient tipped by one ulp moves the update and the token's f32 delta
    by at most one bf16 ulp of the leaf's scale; tests/test_torch_dense.py
    holds the CPU path so against the reference)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = get_config("internlm2-1.8b")
    cfg = dataclasses.replace(full, num_layers=TRAIN_CUT_LAYERS,
                              layer_types=("attn",) * TRAIN_CUT_LAYERS)
    tcfg = TrainConfig(num_agents=4, num_walks=2, tau=0.05, rho=20.0)
    toks, targs = next(agent_batches(cfg.vocab_size, 4, 2, 256, seed=0))
    batch = {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(targs)}
    report = {}

    # the config's own dtypes on the card
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, tcfg,
                             torch.Generator(device=DEV).manual_seed(0))
    leaves = len(state["params"])
    step_fn = make_train_step(model, tcfg)
    gpu_batch = {k: v.to(DEV) for k, v in batch.items()}
    reset_counts()
    t0 = time.perf_counter()
    state, m = step_fn(state, gpu_batch, 0)
    torch.cuda.synchronize()
    report["internlm2_bf16_compute"] = {
        "layers": TRAIN_CUT_LAYERS, "leaves": leaves,
        "loss": float(m["loss"]),
        "superstep_ms_incl_first_use": (time.perf_counter() - t0) * 1e3,
        "launches": counts(),
        "peak_GB": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps({"dense_training": report}), flush=True)
    if counts()["prox_update"] != leaves or not np.isfinite(float(
            m["loss"])):
        raise AssertionError(f"internlm2 superstep: {report}")
    del state, m
    torch.cuda.empty_cache()

    # f32, card against CPU, from one state
    for name, c, t, b, tol in (
            ("internlm2_f32_card_vs_cpu",
             dataclasses.replace(cfg, compute_dtype="float32"),
             TrainConfig(num_agents=CPU_AGENTS, num_walks=CPU_WALKS,
                         tau=0.05, rho=20.0),
             {k: v[:CPU_AGENTS] for k, v in batch.items()},
             lambda want, part: 1e-4),
            ("nemotron_smoke_bf16_params_card_vs_cpu",
             dataclasses.replace(get_smoke("nemotron-4-15b"),
                                 param_dtype="bfloat16",
                                 compute_dtype="float32"),
             TrainConfig(num_agents=4, num_walks=2), None,
             lambda want, part: (bf16_ulp(want)
                                 + bf16_ulp(want.abs().max())))):
        model = build_model(c)
        if b is None:
            bt, bg = next(agent_batches(c.vocab_size, 4, 2, 32, seed=1))
            b = {"tokens": torch.from_numpy(bt),
                 "targets": torch.from_numpy(bg)}
        cpu = init_train_state(model, t, torch.Generator().manual_seed(0))
        gpu = {part: {k: v.to(DEV, copy=True) for k, v in leaves_.items()}
               for part, leaves_ in cpu.items()}
        step_fn = make_train_step(model, t)
        t0 = time.perf_counter()
        cpu, m_cpu = step_fn(cpu, b, 0)
        cpu_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        gpu, m_gpu = step_fn(gpu, {k: v.to(DEV) for k, v in b.items()}, 0)
        torch.cuda.synchronize()
        launches = counts()
        close = _state_close(gpu, cpu, tol)
        report[name] = {
            "param_dtype": c.param_dtype,
            "x_dtypes": sorted({str(v.dtype) for v in gpu["params"].values()}),
            "loss_card": float(m_gpu["loss"]),
            "loss_cpu": float(m_cpu["loss"]),
            "max_abs_err": {p: e for p, (_, e) in close.items()},
            "cpu_superstep_s": cpu_s, "launches": launches,
            "peak_GB": torch.cuda.max_memory_allocated() / 1e9,
            "host_peak_rss_GB": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1e6}
        print(json.dumps({"dense_training": {name: report[name]}}),
              flush=True)
        if (not all(ok for ok, _ in close.values())
                or launches["prox_update"] != len(cpu["params"])
                or report[name]["x_dtypes"] != [f"torch.{c.param_dtype}"]
                or abs(float(m_gpu["loss"]) - float(m_cpu["loss"]))
                > 1e-4 * abs(float(m_cpu["loss"]))):
            raise AssertionError(f"{name}: card and CPU disagree: "
                                 f"{report[name]}")
        del cpu, gpu
        torch.cuda.empty_cache()
    return report


# phase 30's card-against-CPU arms: (name, optimizer, schedule), as
# tests/test_torch_train_paths.py runs them against the reference
DP_STEPS, DP_LR = 3, 3e-4
DP_ARMS = (("adamw_constant", lambda: optim.adamw(weight_decay=0.0),
            lambda: optim.constant(DP_LR)),
           ("sgd_momentum_warmup_cosine", lambda: optim.sgd(momentum=0.9),
            lambda: optim.warmup_cosine(0.1, 2, 3)))


def _to(tree, device):
    """A copy of a tree of dicts (and tuples) of tensors on `device`."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, device) for v in tree)
    return tree.to(device, copy=True)


def _max_err(card, cpu):
    """max |card - cpu| over a tree's tensor leaves."""
    if isinstance(cpu, dict):
        return max((_max_err(card[k], v) for k, v in cpu.items()),
                   default=0.0)
    return float((card.cpu().double() - cpu.double()).abs().max())


def dp_baseline():
    """Phase 30: the DP baseline main path, `repro_torch.launch.train
    --baseline` at full qwen2-0.5b width with phase 4's settings (global
    batch 8 x 256, adamw without weight decay at a constant 3e-4) for
    STEPS steps, counts reset just before and read just after (the
    baseline runs no kernel: the reference's runs no Pallas kernel
    either); then, at smoke size in f32, DP_STEPS steps of each DP_ARMS
    arm on the card and on the CPU from one set of parameters.

    Tolerances: loss rtol 1e-4 (phase 5's). sgd with momentum: params and
    velocity within 1e-5. adamw: Adam's first steps move a parameter by
    about lr * sign(g), so a gradient near zero whose sign the two f32
    summation orders flip can move it by up to 2 * lr a step: params
    within 2 * lr * DP_STEPS everywhere and within 1e-5 (rtol 1e-5) on
    all but 0.1 % of elements; mu within 1e-5 and nu within 1e-7 (squares
    of gradients of ~1e-3)."""
    argv = main_args(STEPS, log_every=1) + ["--baseline"]
    print(" ".join(argv))
    reset_counts()
    out = train_cli.train(train_cli.parse_args(argv))
    launches = counts()
    report = {"main_path": {
        "losses": out["losses"], "step_ms": out["step_ms"],
        "step_ms_after_first": float(np.mean(out["step_ms"][1:])),
        "peak_GB": out["peak_bytes"] / 1e9, "launches": launches}}
    print(json.dumps({"dp_baseline": report}), flush=True)
    if not np.all(np.isfinite(out["losses"])) or any(launches.values()):
        raise AssertionError(f"DP baseline main path: {report}")
    torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke("qwen2-0.5b"),
                              compute_dtype="float32")
    model = build_model(cfg)
    p0 = model.init(torch.Generator().manual_seed(0))
    for name, make_opt, make_sched in DP_ARMS:
        opt = make_opt()
        step_fn = make_dp_baseline_step(model, opt, make_sched())
        cpu = (p0, opt.init(p0))
        card = _to(cpu, DEV)
        batches = agent_batches(cfg.vocab_size, 4, 2, 32, seed=1)
        losses = []
        for step in range(DP_STEPS):
            toks, targs = (torch.from_numpy(x.reshape(-1, 32))
                           for x in next(batches))
            b = {"tokens": toks, "targets": targs}
            *cpu, m_cpu = step_fn(*cpu, b, step)
            *card, m_card = step_fn(*card, _to(b, DEV), step)
            losses.append((float(m_card["loss"]), float(m_cpu["loss"])))
        (pc, sc), (pg, sg) = cpu, card
        errs = {"params": _max_err(pg, pc)}
        ok = all(abs(g - c) <= 1e-4 * abs(c) for g, c in losses)
        if name.startswith("sgd"):
            errs["velocity"] = _max_err(sg, sc)
            ok &= errs["params"] <= 1e-5 and errs["velocity"] <= 1e-5
        else:
            errs["mu"], errs["nu"] = (_max_err(sg[p], sc[p])
                                      for p in ("mu", "nu"))
            off = sum(int(((pg[k].cpu() - v).abs()
                           > 1e-5 + 1e-5 * v.abs()).sum())
                      for k, v in pc.items())
            total = sum(v.numel() for v in pc.values())
            errs["params_off_1e-5"] = [off, total]
            ok &= (errs["params"] <= 2 * DP_LR * DP_STEPS
                   and off <= total // 1000 and errs["mu"] <= 1e-5
                   and errs["nu"] <= 1e-7
                   and int(sg["count"]) == int(sc["count"]) == DP_STEPS)
        report[name] = {"losses_card_cpu": losses, "max_abs_err": errs}
        print(json.dumps({"dp_baseline": {name: report[name]}}), flush=True)
        if not ok:
            raise AssertionError(f"DP baseline {name}: card and CPU "
                                 f"disagree: {report[name]}")
    return report


def _loss_grads(model, params, batch, remat):
    """(loss, {leaf: gradient}) of model.train_loss at params, by
    torch.autograd.grad on detached leaves, as the trainer takes it."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, _ = model.train_loss(leaves, batch, remat=remat)
    return loss.detach(), dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()))))


LONG_SEQ = 2048          # phase 31: two K/V chunks of 1024 an agent
REMAT_SEQ = 1024         # phase 31's peak with remat on and off


def long_sequence_training():
    """Phase 31: `repro_torch.launch.train` at full qwen2-0.5b width, A=4,
    M=2, 2 x LONG_SEQ tokens an agent (remat on, the default), 2
    supersteps, counts reset just before and read just after (one
    prox_update launch a leaf a superstep); then one superstep at
    REMAT_SEQ from a fresh state with remat on and one with it off (a
    model from `dataclasses.replace(model, train_loss=...)`), each with
    its peak and its peak over the state. The superstep's peak may be
    its update's (the embedding's temporaries), so one agent's loss and
    gradient alone, the part remat changes, is measured too: its peak
    over what was allocated before it, at REMAT_SEQ and LONG_SEQ, remat
    on and off."""
    from repro_torch.models import transformer as TF

    steps = 2
    argv = ["--arch", "qwen2-0.5b", "--agents", "4", "--walks", "2",
            "--steps", str(steps), "--batch-per-agent", "2", "--seq",
            str(LONG_SEQ), "--log-every", "1"]
    print(" ".join(argv))
    reset_counts()
    out = train_cli.train(train_cli.parse_args(argv))
    launches = counts()
    report = {f"S{LONG_SEQ}_remat": {
        "losses": out["losses"], "superstep_ms": out["step_ms"],
        "peak_GB": out["peak_bytes"] / 1e9, "launches": launches}}
    print(json.dumps({"long_sequence": report}), flush=True)
    if (not np.all(np.isfinite(out["losses"]))
            or launches["prox_update"] != LEAVES * steps):
        raise AssertionError(f"long-sequence superstep: {report}")
    torch.cuda.empty_cache()

    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg)
    tcfg = TrainConfig(num_agents=4, num_walks=2, tau=0.05, rho=20.0)
    state = init_train_state(model, tcfg,
                             torch.Generator(device=DEV).manual_seed(0))
    toks, targs = next(agent_batches(cfg.vocab_size, 4, 2, REMAT_SEQ,
                                     seed=0))
    batch = {"tokens": torch.from_numpy(toks).to(DEV),
             "targets": torch.from_numpy(targs).to(DEV)}
    for step, remat in enumerate((True, False)):
        m = dataclasses.replace(model, train_loss=(
            lambda p, b, remat=remat: TF.train_loss(cfg, p, b,
                                                    remat=remat)))
        step_fn = make_train_step(m, tcfg)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, met = step_fn(state, batch, step)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        report[f"S{REMAT_SEQ}_{'remat' if remat else 'no_remat'}"] = {
            "loss": float(met["loss"]),
            "superstep_ms": (time.perf_counter() - t0) * 1e3,
            "peak_GB": peak / 1e9, "state_GB": base / 1e9,
            "peak_over_state_GB": (peak - base) / 1e9}
        if not np.isfinite(float(met["loss"])):
            raise AssertionError(f"S={REMAT_SEQ} remat={remat}: {report}")
    params0 = {k: v[0] for k, v in state["params"].items()}
    grad_peaks = {}
    for seq in (REMAT_SEQ, LONG_SEQ):
        toks, targs = next(agent_batches(cfg.vocab_size, 1, 2, seq, seed=3))
        agent = {"tokens": torch.from_numpy(toks[0]).to(DEV),
                 "targets": torch.from_numpy(targs[0]).to(DEV)}
        for remat in (True, False):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss, grads = _loss_grads(model, params0, agent, remat)
            torch.cuda.synchronize()
            grad_peaks[f"S{seq}_{'remat' if remat else 'no_remat'}"] = (
                (torch.cuda.max_memory_allocated() - base) / 1e9)
            del loss, grads
    report["agent_gradient_peak_over_start_GB"] = grad_peaks
    print(json.dumps({"long_sequence": {
        k: v for k, v in report.items() if not k.startswith(
            f"S{LONG_SEQ}")}}), flush=True)
    del state, params0
    torch.cuda.empty_cache()
    return report


WINDOWED_SEQ = 1100      # phase 32: past one K/V chunk of 1024
WINDOWS = (0, 300)


def windowed_reference_check():
    """Phase 32: the smoke config in f32 at S = WINDOWED_SEQ, window 0 and
    300 (`build_model(cfg, window=300)`), one superstep (A=4, M=2, one
    sequence an agent) on the card and on the CPU from one state: loss
    rtol 1e-4 and every state leaf within 1e-4 (phase 5's limits); then
    agent 0's loss and gradient on the card with remat on and off against
    the CPU's with it on: loss rtol 1e-5, every gradient leaf within rtol
    1e-4 / atol 1e-5 (the bound tests/test_torch_model.py holds the f32
    gradient to against the reference). Returns the card's state after
    the windowed step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke("qwen2-0.5b"),
                              compute_dtype="float32")
    tcfg = TrainConfig(num_agents=4, num_walks=2)
    toks, targs = next(agent_batches(cfg.vocab_size, 4, 1, WINDOWED_SEQ,
                                     seed=2))
    b_cpu = {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(targs)}
    b_card = _to(b_cpu, DEV)
    report = {}
    for window in WINDOWS:
        model = build_model(cfg, window=window)
        cpu = init_train_state(model, tcfg, torch.Generator().manual_seed(0))
        p0 = {k: v[0].clone() for k, v in cpu["params"].items()}
        card = _to(cpu, DEV)
        step_fn = make_train_step(model, tcfg)
        cpu, m_cpu = step_fn(cpu, b_cpu, 0)
        card, m_card = step_fn(card, b_card, 0)
        close = _state_close(card, cpu, lambda want, part: 1e-4)
        state_err = {part: err for part, (_, err) in close.items()}
        agent0 = {k: v[0] for k, v in b_cpu.items()}
        loss_c, grads_c = _loss_grads(model, p0, agent0, remat=True)
        grads_ok, grad_err, losses = True, {}, {}
        for remat in (True, False):
            loss_g, grads_g = _loss_grads(model, _to(p0, DEV),
                                          _to(agent0, DEV), remat)
            losses[remat] = float(loss_g)
            grad_err[remat] = _max_err(grads_g, grads_c)
            grads_ok &= abs(float(loss_g) - float(loss_c)) <= 1e-5 * abs(
                float(loss_c))
            grads_ok &= all(bool(((grads_g[k].cpu() - g).abs()
                                  <= 1e-5 + 1e-4 * g.abs()).all())
                            for k, g in grads_c.items())
        report[f"window_{window}"] = {
            "loss_card": float(m_card["loss"]),
            "loss_cpu": float(m_cpu["loss"]), "state_max_abs_err": state_err,
            "agent0_loss_cpu": float(loss_c),
            "agent0_loss_card_remat_no_remat": [losses[True], losses[False]],
            "grad_max_abs_err_remat_no_remat": [grad_err[True],
                                                grad_err[False]]}
        print(json.dumps({"windowed_reference": {
            f"window_{window}": report[f"window_{window}"]}}), flush=True)
        if (abs(float(m_card["loss"]) - float(m_cpu["loss"]))
                > 1e-4 * abs(float(m_cpu["loss"]))
                or not all(ok for ok, _ in close.values()) or not grads_ok):
            raise AssertionError(f"window {window}: card and CPU disagree: "
                                 f"{report[f'window_{window}']}")
    return card


def _assert_loaded(got, want, what):
    for part, leaves in want.items():
        for k, v in leaves.items():
            g = got[part][k]
            if g.dtype != v.dtype or not torch.equal(g.cpu(), v.cpu()):
                raise AssertionError(f"{what}: {part}/{k} did not load back "
                                     "bitwise")


def checkpoint_on_card(state):
    """Phase 33: `save_checkpoint` of phase 32's card state (qwen2 smoke,
    window 300, after one superstep), loaded into a template of zeros on
    the card and on the CPU: bitwise, dtypes kept; the same for one
    superstep's state of nemotron's smoke config on bf16 parameters. At
    smoke size: a full-width qwen2 state at A=4, M=2 is ~39.5 GB on
    disk."""
    import shutil

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint

    cfg = dataclasses.replace(get_smoke("nemotron-4-15b"),
                              param_dtype="bfloat16")
    tcfg = TrainConfig(num_agents=4, num_walks=2)
    model = build_model(cfg)
    nemo = init_train_state(model, tcfg,
                            torch.Generator(device=DEV).manual_seed(0))
    toks, targs = next(agent_batches(cfg.vocab_size, 4, 2, 32, seed=1))
    nemo, _ = make_train_step(model, tcfg)(
        nemo, {"tokens": torch.from_numpy(toks).to(DEV),
               "targets": torch.from_numpy(targs).to(DEV)}, 0)
    path = os.path.join(ROOT, "build", "chip_smoke_checkpoint")
    report = {}
    for name, st in (("qwen2_smoke_window_300", state),
                     ("nemotron_smoke_bf16_params", nemo)):
        shutil.rmtree(path, ignore_errors=True)
        t0 = time.perf_counter()
        save_checkpoint(path, st, step=1, metadata={"arch": name})
        save_s = time.perf_counter() - t0
        for device in (DEV, torch.device("cpu")):
            like = {part: {k: torch.zeros_like(v, device=device)
                           for k, v in leaves.items()}
                    for part, leaves in st.items()}
            got, step = load_checkpoint(path, like)
            if step != 1 or {v.device.type for p in got.values()
                             for v in p.values()} != {device.type}:
                raise AssertionError(f"{name}: loaded on the wrong device "
                                     f"or step {step}")
            _assert_loaded(got, st, f"{name} on {device.type}")
        report[name] = {
            "bytes": os.path.getsize(os.path.join(path, "arrays.npz")),
            "save_s": save_s,
            "param_dtypes": sorted({str(v.dtype)
                                    for v in st["params"].values()}),
            "bitwise_card_and_cpu": True}
    shutil.rmtree(path, ignore_errors=True)
    print(json.dumps({"checkpoint": report}), flush=True)
    return report


BWD_RULE = ("|kernel - plain| <= 1e-5 * rms(plain) + 1e-4 * |plain|, every "
            "gradient (f32 sums in another order; chip_smoke's WKV rule)")


def check_wkv_bwd_case(label, b, s, dtype, gen, hd=64, w0=-2.0):
    """The WKV backward at rwkv6-1.6b's width (2048 / hd heads), b rows of
    s steps from a random state, r/k/v in dtype and the model's [B, S, H,
    hd] layout viewed as [B, H, S, hd] (dout too, as autograd gives it),
    decays exp(-exp(w0 + 0.5 z)) (w0 = 0 to +2: strong decays, down to
    ~1e-30 and below): against `ref.rwkv6_bwd` under BWD_RULE, and a
    repeat that must be bitwise. No gradient of the final state, as in
    training."""
    h = 2048 // hd

    def bshd(scale=1.0):
        return (scale * torch.randn((b, s, h, hd), generator=gen,
                                    device=DEV)).transpose(1, 2)
    r, k, v = (bshd().to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(w0 + 0.5 * bshd()))
    u = (0.1 * torch.randn((h, hd), generator=gen, device=DEV)).to(dtype)
    state = torch.randn((b, h, hd, hd), generator=gen, device=DEV)
    args = (r, k, v, w, u, state, bshd(), None)
    got = rwkv6_scan_bwd_cuda(*args)
    again = rwkv6_scan_bwd_cuda(*args)
    torch.cuda.synchronize()
    want = ref.rwkv6_bwd(*args)
    names = ("dr", "dk", "dv", "dw", "du", "dstate_in")
    errs, ok = {}, True
    for name, g, x in zip(names, got, want):
        close, errs[name] = rwkv_close(g, x)
        ok &= close
    repeat_bitwise = all(torch.equal(g, x) for g, x in zip(got, again))
    del got, again, want
    per_call = device_launches(lambda: rwkv6_scan_bwd_cuda(*args))
    t = timings(lambda: rwkv6_scan_bwd_cuda(*args),
                lambda: ref.rwkv6_bwd(*args), None, iters=20,
                launches=per_call)
    cost = costs.rwkv6_scan_bwd(*args[:7])
    nbytes, flops = cost.bytes, cost.flops
    t_bytes, t_ops = bound_terms(cost)
    case = {"case": label, "dtype": str(dtype), "w0": w0,
            "shape": [list(r.shape), list(state.shape)],
            "w_min": float(w.min()),
            "max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
            "tolerance": BWD_RULE, "repeat_bitwise": repeat_bitwise,
            "device_launches_per_call": per_call, **t,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}
    print(json.dumps(case), flush=True)
    if not ok or not repeat_bitwise:
        raise AssertionError(f"rwkv6_scan backward kernel disagrees with "
                             f"its plain version on {label}: {case}")
    return case


def check_rglru_bwd_case(label, b, s, dtype, gen):
    """The RG-LRU backward at recurrentgemma-2b's width for b rows of s
    steps from a random state, inputs drawn as `check_rglru_case` draws
    them, dout in dtype: against `ref.rglru_gated_bwd` under BWD_RULE
    (bitwise or not is printed), and a repeat that must be bitwise."""
    w = RG_WIDTH

    def draw(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=DEV)).to(
            dtype)
    ga, gi, xa = draw(b, s, w), draw(b, s, w), draw(b, s, w)
    b_a, b_i = draw(w, scale=0.1), draw(w, scale=0.1)
    lamb = (-1.0 + 4.0 * torch.rand(w, generator=gen, device=DEV)).to(dtype)
    state = torch.randn((b, w), generator=gen, device=DEV)
    args = (ga, gi, b_a, b_i, lamb, xa, state, draw(b, s, w), None)
    got = rglru_scan_bwd_cuda(*args)
    again = rglru_scan_bwd_cuda(*args)
    torch.cuda.synchronize()
    want = ref.rglru_gated_bwd(*args)
    names = ("dgate_a", "dgate_i", "db_a", "db_i", "dlamb", "dxa", "dh0")
    errs, ok = {}, True
    for name, g, x in zip(names, got, want):
        close, errs[name] = rwkv_close(g, x)
        ok &= close
    bitwise = all(torch.equal(g, x) for g, x in zip(got, want))
    repeat_bitwise = all(torch.equal(g, x) for g, x in zip(got, again))
    del got, again, want
    per_call = device_launches(lambda: rglru_scan_bwd_cuda(*args))
    t = timings(lambda: rglru_scan_bwd_cuda(*args),
                lambda: ref.rglru_gated_bwd(*args), None,
                iters=20, launches=per_call)
    cost = costs.rglru_scan_bwd(*args[:8])
    nbytes, flops = cost.bytes, cost.flops
    t_bytes, t_ops = bound_terms(cost)
    case = {"case": label, "dtype": str(dtype),
            "shape": [list(xa.shape), list(state.shape)],
            "max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
            "tolerance": BWD_RULE, "bitwise": bitwise,
            "repeat_bitwise": repeat_bitwise,
            "device_launches_per_call": per_call, **t,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}
    print(json.dumps(case), flush=True)
    if not ok or not repeat_bitwise:
        raise AssertionError(f"rglru_scan backward kernel disagrees with "
                             f"its plain version on {label}: {case}")
    return case


def backward_kernel_cases(gen):
    """Phase 34: each backward kernel against its plain version, in bf16
    (the training path's compute dtype) at every case and in f32 at the
    training shapes: WKV at rwkv6's training shape (B 2, H 32, S 256, hd
    64), S = 16, hd 32 and strong decays (w0 = +2); RG-LRU at B 2, S 256,
    W 2560 and S = 3. (The f32 runs of the smaller cases and the
    final-state gradients are left to the card tests, to keep the phase
    near 40 s: the plain WKV backward takes ~15 ms a call at S = 256.)"""
    wkv_cases = [check_wkv_bwd_case("wkv bwd training B=2 S=256", 2, 256,
                                    dtype, gen)
                 for dtype in (torch.bfloat16, torch.float32)]
    wkv_cases += [
        check_wkv_bwd_case("wkv bwd B=2 S=16", 2, 16, torch.bfloat16, gen),
        check_wkv_bwd_case("wkv bwd hd 32 B=2 S=256", 2, 256,
                           torch.bfloat16, gen, hd=32),
        check_wkv_bwd_case("wkv bwd strong decays w0=+2 B=2 S=256", 2, 256,
                           torch.bfloat16, gen, w0=2.0)]
    torch.cuda.empty_cache()
    rg_cases = [check_rglru_bwd_case("rglru bwd training B=2 S=256 W=2560",
                                     2, 256, dtype, gen)
                for dtype in (torch.bfloat16, torch.float32)]
    rg_cases.append(check_rglru_bwd_case("rglru bwd B=2 S=3 W=2560", 2, 3,
                                         torch.bfloat16, gen))
    torch.cuda.empty_cache()
    return wkv_cases, rg_cases


# phases 35 and 36: the recurrent families at full width, depth cut
RWKV_TRAIN_LAYERS = 2          # of rwkv6-1.6b's 24
RG_TRAIN_LAYERS = 3            # of recurrentgemma-2b's 26: one period
RECURRENT_STEPS = 3


def recurrent_training(arch, layers, agents, walks):
    """Phases 35 and 36: RECURRENT_STEPS API-BCD supersteps of `arch` at
    full width, depth cut to `layers`, B = 2, S = 256, bf16 compute, on
    the card; each superstep's counts reset just before and read just
    after: per agent one backward launch per recurrent layer and (remat)
    two forward launches per recurrent layer, one prox launch a leaf, no
    attention kernel (training attention is plain chunked attention).
    Returns the report, with the counts summed over the supersteps."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers,
                              layer_types=full.layer_types[:layers])
    kind = "rwkv" if arch.startswith("rwkv") else "rglru"
    fwd, bwd = (("rwkv6_scan", "rwkv6_scan_bwd") if kind == "rwkv"
                else ("rglru_scan", "rglru_scan_bwd"))
    n_rec = sum(t == kind for t in cfg.layer_types)
    tcfg = TrainConfig(num_agents=agents, num_walks=walks, tau=0.05,
                       rho=20.0)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, tcfg,
                             torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    state_gb = torch.cuda.memory_allocated() / 1e9
    n_params = sum(v[0].numel() for v in state["params"].values())
    leaves = len(state["params"])
    step_fn = make_train_step(model, tcfg)
    batches = agent_batches(cfg.vocab_size, agents, 2, 256, seed=0)
    want = {fwd: 2 * agents * n_rec, bwd: agents * n_rec,
            "prox_update": leaves}
    losses, step_ms, total = [], [], {}
    for step in range(RECURRENT_STEPS):
        toks, targs = next(batches)
        batch = {"tokens": torch.from_numpy(toks).to(DEV),
                 "targets": torch.from_numpy(targs).to(DEV)}
        reset_counts()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch, step)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        got = {k: v for k, v in counts().items() if v}
        if got != want:
            raise AssertionError(f"{arch} superstep {step}: launches {got}, "
                                 f"expected {want}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        losses.append(float(m["loss"]))
    report = {"arch": arch, "layers": layers,
              "layer_types": list(cfg.layer_types), "agents": agents,
              "walks": walks, "batch": [2, 256],
              "compute_dtype": cfg.compute_dtype, "params": n_params,
              "leaves": leaves, "state_GB": state_gb, "losses": losses,
              "superstep_ms": step_ms,
              "superstep_ms_after_first": float(np.mean(step_ms[1:])),
              "launches_per_superstep": want, "launches": total,
              "peak_GB": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps({"recurrent_training": report}), flush=True)
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{arch}: non-finite losses {losses}")
    del state
    torch.cuda.empty_cache()
    return report


def training_reference_check(arch):
    """Phase 37 for one family (phase 38 for dbrx): `repro_torch.launch.
    train --smoke` on the card through its CLI (3 supersteps, then 2
    DP-baseline steps; finite losses, and an MoE family's load-balance
    term above 0 in every step), then the smoke config in f32 from one
    state on the card and on the CPU: one superstep (A=4, M=2; one prox
    launch a leaf; loss rtol 1e-4, params, token and zhat within phase
    5's 1e-4, gacc, which holds gradients of up to ~50 on the recurrent
    models, within 1e-4 of its leaf's largest |value| where that passes
    1) and one DP-baseline step with sgd and momentum 0.9 at phase 30's
    rate (loss rtol 1e-4, params within 1e-4, the velocity, which is the
    gradient, as gacc; adamw's first step moves a parameter by lr *
    sign(g), which f32 noise can flip). Returns the report, with the
    superstep's launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    for extra, steps in (([], 3), (["--baseline"], 2)):
        argv = ["--arch", arch, "--smoke", "--steps", str(steps), "--seq",
                "64", "--batch-per-agent", "2", "--log-every", "0", *extra]
        out = train_cli.train(train_cli.parse_args(argv))
        report["cli" + "".join(extra)] = {"argv": " ".join(argv),
                                          "losses": out["losses"],
                                          "auxs": out["auxs"]}
        if not np.all(np.isfinite(out["losses"])):
            raise AssertionError(f"{arch} CLI: non-finite losses {out}")
        if "moe" in get_smoke(arch).layer_types and min(out["auxs"]) <= 0:
            raise AssertionError(f"{arch} CLI: no load-balance term {out}")
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    model = build_model(cfg)
    toks, targs = next(agent_batches(cfg.vocab_size, 4, 2, 48, seed=1))
    b = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(targs)}
    tcfg = TrainConfig(num_agents=4, num_walks=2)
    step_fn = make_train_step(model, tcfg)
    cpu = init_train_state(model, tcfg, torch.Generator().manual_seed(0))
    gpu = _to(cpu, DEV)
    cpu, m_cpu = step_fn(cpu, b, 0)
    reset_counts()
    gpu, m_gpu = step_fn(gpu, _to(b, DEV), 0)
    launches = {k: v for k, v in counts().items() if v}
    close = _state_close(gpu, cpu, lambda want, part: 1e-4 * (
        max(1.0, float(want.abs().max())) if part == "gacc" else 1.0))
    ok = all(c for c, _ in close.values()) and abs(
        float(m_gpu["loss"]) - float(m_cpu["loss"])) \
        <= 1e-4 * abs(float(m_cpu["loss"]))
    ok &= launches.get("prox_update") == len(cpu["params"])
    report["superstep_card_vs_cpu"] = {
        "loss_card": float(m_gpu["loss"]), "loss_cpu": float(m_cpu["loss"]),
        "aux_card": float(m_gpu["aux"]), "aux_cpu": float(m_cpu["aux"]),
        "leaves": len(cpu["params"]), "launches": launches,
        "max_abs_err": {p: e for p, (_, e) in close.items()}}
    p0 = model.init(torch.Generator().manual_seed(0))
    opt = optim.sgd(momentum=0.9)
    dp_step = make_dp_baseline_step(model, opt, optim.constant(DP_LR))
    bg = {k: v.reshape(-1, v.shape[-1]) for k, v in b.items()}
    pc, sc, mc = dp_step(p0, opt.init(p0), bg, 0)
    pg, sg, mg = dp_step(*_to((p0, opt.init(p0)), DEV), _to(bg, DEV), 0)
    # the velocity after one step is the gradient: its leaf's scale
    close = _state_close({"params": pg, "velocity": sg},
                         {"params": pc, "velocity": sc},
                         lambda want, part: 1e-4 * (
                             max(1.0, float(want.abs().max()))
                             if part == "velocity" else 1.0))
    dp_errs = {p: e for p, (_, e) in close.items()}
    ok &= all(c for c, _ in close.values()) and abs(
        float(mg["loss"]) - float(mc["loss"])) <= 1e-4 * abs(float(mc["loss"]))
    report["dp_step_card_vs_cpu"] = {"loss_card": float(mg["loss"]),
                                     "loss_cpu": float(mc["loss"]),
                                     "max_abs_err": dp_errs}
    print(json.dumps({"training_reference": {arch: report}}), flush=True)
    if not ok:
        raise AssertionError(f"{arch}: card and CPU disagree: {report}")
    return report


# phase 38: the MoE family (dbrx-132b) at smoke size, card against CPU
MOE_ARCH = "dbrx-132b"


def mid_flight_engines(arch):
    """`arch`'s smoke config in f32 (TF32 off), one set of parameters on
    the CPU and a copy on the card: an engine on each serves a request of
    7 tokens, and one of 5 admitted after two steps; the tokens must be
    equal, from the serialized arena, each prompt prefilled at its exact
    length. Returns (model, CPU params, card params, the runs)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    gpu = _to(cpu, DEV)
    rng = np.random.default_rng(14)
    first, later = (rng.integers(0, cfg.vocab_size, (n,)) for n in (7, 5))
    runs = {}
    for name, params in (("cpu", cpu), ("card", gpu)):
        eng = Engine(model, params, max_batch=2, max_len=32,
                     cache_dtype=torch.float32)
        eng.submit(first, max_new_tokens=8)
        eng.step()
        eng.step()
        eng.submit(later, max_new_tokens=4)        # admitted mid-flight
        runs[name] = {"outputs": [r.output.tolist() for r in
                                  sorted(eng.run(), key=lambda r: r.uid)],
                      "prefill_shapes": sorted(eng.prefill_shapes),
                      "paged": eng.paged, "overlap": eng.overlap}
    print(json.dumps({"mid_flight_engines": {arch: runs}}), flush=True)
    if (runs["card"] != runs["cpu"] or runs["card"]["prefill_shapes"]
            != [5, 7] or runs["card"]["paged"] or runs["card"]["overlap"]):
        raise AssertionError(f"{arch} engines, card against CPU: {runs}")
    return model, cpu, gpu, runs


def moe_reference_check():
    """Phase 38: dbrx's smoke config in f32 on the card and on the CPU from
    one set of parameters: exact-length prefill_into_slot and 8 decode
    steps (phase 8's check; logits within 1e-4), an engine on each with
    one mid-flight admission (equal tokens, the arena, serialized, every
    prompt prefilled at its exact length), the scatter variant's
    train_loss (REPRO_MOE_SCATTER; loss, nll and aux within 1e-4 of their
    size), then phase 37's training checks (the CLI's API-BCD and
    --baseline runs with aux > 0, one superstep and one DP-baseline step
    card against CPU, one prox launch a leaf). Returns the training
    report."""
    serving_reference_check(MOE_ARCH, exact=True)
    model, cpu, gpu, runs = mid_flight_engines(MOE_ARCH)
    cfg = model.cfg
    report = {"engines": runs}

    toks, targs = next(agent_batches(cfg.vocab_size, 1, 2, 48, seed=2))
    batch = {"tokens": torch.from_numpy(toks[0]),
             "targets": torch.from_numpy(targs[0])}
    os.environ["REPRO_MOE_SCATTER"] = "1"
    (lc, mc), (lg, mg) = (model.train_loss(p, _to(batch, dev))
                          for p, dev in ((cpu, torch.device("cpu")),
                                         (gpu, DEV)))
    del os.environ["REPRO_MOE_SCATTER"]
    scatter = {k: (float(dict(mg, loss=lg)[k]), float(dict(mc, loss=lc)[k]))
               for k in ("loss", "nll", "aux")}
    report["scatter_train_loss_card_cpu"] = scatter
    print(json.dumps({"moe_reference": report}), flush=True)
    if any(abs(g - c) > 1e-4 * max(1.0, abs(c))
           for g, c in scatter.values()) or scatter["aux"][1] <= 0:
        raise AssertionError(f"dbrx scatter train_loss, card against CPU: "
                             f"{scatter}")
    return training_reference_check(MOE_ARCH)


# phase 39: dbrx-132b at full width, depth cut to 4 of its 40 layers (a
# layer is 6.52 GB of bf16 parameters, beside the 2.47 GB embedding and
# head: 28.5 GB), on phase 7's workload
MOE_LAYERS = 4
MOE_SERVE_ARGS = ["--arch", MOE_ARCH, "--layers", str(MOE_LAYERS)] + \
    SERVE_ARGS[2:]


def moe_admission_drops(cfg, params, prompts):
    """Slots dropped at capacity over the admissions of `prompts` (each
    prefilled alone at its exact length, as the engine admits them),
    counted with the port's routing (`moe.route`, `moe.bucket_positions`)
    on each MoE layer's input, layer by layer, apart from the serving
    run: {"dropped_by_layer", "slots_by_layer", "capacity"}."""
    from repro_torch.models import attention as A
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TF
    from repro_torch.models.layers import rmsnorm

    p = TF._cast(cfg, params)
    dropped = [0] * cfg.num_layers
    slots, caps = 0, set()
    for prompt in prompts:
        x = TF._embed_tokens(cfg, p, torch.as_tensor(prompt[None],
                                                     device=DEV))
        s = x.shape[1]
        positions = torch.arange(s, device=DEV)[None]
        cap = MOE.capacity(cfg, s)
        caps.add(cap)
        slots += s * cfg.moe.top_k
        for i, lp in enumerate(TF._layers(p, 0, cfg.num_layers)):
            h = rmsnorm(lp["ln1"], x)
            if cfg.mla is not None:
                attn, _ = A.mla_prefill(lp["attn"], cfg, h, positions)
            else:
                attn, _ = A.gqa_prefill(lp["attn"], cfg, h, positions,
                                        kernel=True)
            x = x + attn
            h = rmsnorm(lp["ln2"], x)
            _, _, gate_i = MOE.route(lp["moe"], cfg, h)
            pos = MOE.bucket_positions(gate_i, cfg.moe.num_experts)
            dropped[i] += int((pos >= cap).sum())
            x = x + MOE.moe_apply(lp["moe"], cfg, h, with_aux=False)[0]
    return {"dropped_by_layer": dropped, "slots_by_layer": slots,
            "capacity": sorted(caps)}


def moe_decode_layers(cfg, params, gen):
    """Device ms of each MoE layer's `moe_apply` at the decode step's
    shape (8 rows of one token, bf16), beside its bound: the layer's
    expert weights read once."""
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TF

    x = torch.randn((8, 1, cfg.d_model), generator=gen, device=DEV).to(
        torch.bfloat16)
    out = []
    for lp in TF._layers(TF._cast(cfg, params), 0, cfg.num_layers):
        moe = lp["moe"]
        nbytes = sum(moe[k].numel() * moe[k].element_size()
                     for k in ("w_gate", "w_up", "w_down"))
        out.append({"ms": device_ms(lambda: MOE.moe_apply(
            moe, cfg, x, with_aux=False), 10),
            "launches": device_launches(lambda: MOE.moe_apply(
                moe, cfg, x, with_aux=False), calls=10),
            "expert_bytes": nbytes,
            "bound_ms": nbytes / roofline.HBM_BW * 1e3})
    return out


def moe_serving(gen, arch=MOE_ARCH, argv=MOE_SERVE_ARGS):
    """Phase 39: dbrx-132b at full width cut to MOE_LAYERS layers (phase
    41: deepseek-v2-236b, `arch` and `argv`), bf16 parameters, through
    `repro_torch.launch.serve --layers` on phase 7's workload: the arena,
    serialized, every prompt prefilled at its exact length, one flash
    launch a layer an admission and one decode launch a layer a step and
    no other kernel (MLA: no attention kernel at all; its cores are plain
    PyTorch), every budget served, the init's and the run's peaks; then
    two requests re-served alone (the same tokens), one decode step over
    8 live rows repeated on a copy of its arena (bitwise equal logits),
    the slots the admissions drop at capacity, each MoE layer's decode
    time against its bound, and `launch.serve --arch ... --smoke` on the
    card. Returns (the run's launches, the report)."""
    args = serve_cli.parse_args(argv)
    print(" ".join(argv))
    reset_counts()
    out = serve_cli.serve(args)
    launches = counts()
    st = out["stats"]
    summary = serving_summary(out, launches)
    summary.update(arch=arch, layers=args.layers,
                   prefill_shapes=out["prefill_shapes"],
                   init_peak_GB=out["init_peak_bytes"] / 1e9,
                   after_init_GB=out["init_bytes"] / 1e9)
    print(json.dumps({"moe_serving": summary}), flush=True)
    want = {k: 0 for k in launches}
    if get_config(arch).mla is None:
        want.update(flash_attention=args.layers * st["admissions"],
                    decode_attention=args.layers * st["decode_steps"])
    if launches != want:
        raise AssertionError(f"{arch} serving: launches {launches}, "
                             f"expected {want}")
    if out["paged"] or st["overlap_mode"] or st["mixed_steps"]:
        raise AssertionError(f"{arch} serving did not run the serialized "
                             f"arena: {st}")
    if out["prefill_shapes"] != [args.prompt_len]:
        raise AssertionError(f"{arch} prompts were not prefilled at their "
                             f"exact length: {out['prefill_shapes']}")
    if [len(o) for o in out["outputs"]] != out["budgets"]:
        raise AssertionError(f"a {arch} request did not get its budget's "
                             f"tokens: {[len(o) for o in out['outputs']]}")
    torch.cuda.empty_cache()

    _, cfg, model, params = serve_cli.build(args)
    prompts, budgets = serve_cli.workload(args, cfg.vocab_size)
    report = {"arch": arch, "serving": summary,
              "admission_drops": moe_admission_drops(cfg, params, prompts)}
    print(json.dumps({"moe_serving": {"admission_drops": report[
        "admission_drops"]}}), flush=True)

    # one decode step over 8 live rows, twice on copies of one arena
    arena = model.init_arena(8, out["max_len"], device=DEV)
    toks = []
    for slot, prompt in enumerate(prompts[:8]):
        tok, _ = model.prefill_into_slot_token(
            params, torch.as_tensor(prompt[None], device=DEV), len(prompt),
            slot, arena)
        toks.append(tok)
    tokens = torch.stack(toks)[:, None]
    positions = torch.tensor([len(p) for p in prompts[:8]],
                             dtype=torch.int32, device=DEV)
    first, second = (model.decode_rows(params, tokens, [
        {k: v.clone() for k, v in seg.items()} for seg in arena],
        positions)[0] for _ in range(2))
    report["decode_repeat_bitwise"] = bool(torch.equal(first, second))
    del arena, first, second
    report["moe_decode_layers"] = moe_decode_layers(cfg, params, gen)
    if cfg.mla is not None:
        report["mla_decode_layers"] = mla_decode_layers(cfg, params, gen)
    print(json.dumps({"moe_serving": {k: v for k, v in report.items()
                                      if k != "serving"}}), flush=True)
    if not report["decode_repeat_bitwise"]:
        raise AssertionError(f"a repeated {arch} decode step gave other "
                             "logits")

    eng = Engine(model, params, max_batch=args.max_batch,
                 max_len=out["max_len"])
    del params
    for uid in (0, 1):
        eng.submit(prompts[uid], max_new_tokens=budgets[uid])
        (alone,) = eng.run()[-1:]
        if alone.output.tolist() != out["outputs"][uid]:
            raise AssertionError(f"{arch} request {uid} served alone gave "
                                 f"{alone.output.tolist()}, batched "
                                 f"{out['outputs'][uid]}")
    print(json.dumps({"moe_solo_reserves_equal": [0, 1]}), flush=True)
    del eng
    torch.cuda.empty_cache()

    argv = ["--arch", arch, "--smoke", "--requests", "4", "--max-batch",
            "2", "--prompt-len", "8", "--new-tokens", "4"]
    print(" ".join(argv))
    smoke = serve_cli.serve(serve_cli.parse_args(argv))
    if [len(o) for o in smoke["outputs"]] != smoke["budgets"]:
        raise AssertionError(f"{arch} smoke CLI: {smoke['outputs']}")
    return launches, report


# phases 40 and 41: MLA (deepseek-v2-236b's latent attention)
MLA_ARCH = "deepseek-v2-236b"
# (prompt_len, budget, arrival_step), as tests/test_server.py's _STAGGER
STAGGER = [(9, 6, 0), (5, 8, 0), (7, 5, 2), (4, 7, 3), (6, 6, 5)]


def mla_test_config():
    """tests/test_server.py's _mla_cfg (a dense MLA stack: 2 layers,
    d_model 64, 4 heads, kv_lora 16, q_lora 32, nope 16, rope 8, v 16),
    in f32 compute."""
    from repro_torch.configs.base import ArchConfig, MLAConfig

    return ArchConfig(name="mla-overlap-t", family="dense", source="test",
                      num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                      d_ff=128, vocab_size=256, tie_embeddings=True,
                      compute_dtype="float32",
                      mla=MLAConfig(kv_lora_rank=16, q_lora_rank=32,
                                    qk_nope_head_dim=16, qk_rope_head_dim=8,
                                    v_head_dim=16))


def run_staggered(eng, vocab):
    """Drive STAGGER through `eng`: (outputs in submit order, stats)."""
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, vocab, (n,)), b) for n, b, _ in STAGGER]
    outs, uids, nxt, step_i = {}, [], 0, 0
    while nxt < len(reqs) or eng.num_active or eng.pending:
        if step_i >= 400:
            raise AssertionError("the engine did not drain in 400 steps")
        while nxt < len(reqs) and STAGGER[nxt][2] <= step_i:
            uids.append(eng.submit(reqs[nxt][0], max_new_tokens=reqs[nxt][1]))
            nxt += 1
        for r in eng.step():
            outs[r.uid] = r.output.tolist()
        step_i += 1
    return [outs[u] for u in uids], eng.stats


def mla_reference_check():
    """Phase 40: MLA in f32 (TF32 off), card against CPU from one set of
    parameters. deepseek's smoke config (MLA over the MoE with a shared
    expert): exact-length prefill and 8 decode steps (phase 8's check,
    logits within 1e-4), an engine with a mid-flight admission (equal
    tokens, the serialized arena, prefill shapes the lengths), then phase
    37's training checks (launch.train --smoke with API-BCD and
    --baseline, finite losses and aux > 0; one superstep and one DP step
    within phase 37's rule; one prox launch a leaf). The dense MLA stack
    at _mla_cfg's shape: the arena and the pool (6 blocks of 4, so it
    preempts), overlapped and serialized, on STAGGER, every run's tokens
    equal on the card and the CPU; and with a window of 16 it resolves to
    the serialized arena, card against CPU. Returns the training
    report."""
    serving_reference_check(MLA_ARCH, exact=True)
    mid_flight_engines(MLA_ARCH)
    cfg = mla_test_config()
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    gpu = _to(cpu, DEV)
    report = {}
    for paged in (False, True):
        runs = {}
        for overlap in (True, False):
            for name, params in (("cpu", cpu), ("card", gpu)):
                eng = Engine(model, params, max_batch=2, max_len=24,
                             paged=paged, block_size=4, prefill_chunk=4,
                             num_blocks=6 if paged else None, overlap=overlap,
                             cache_dtype=torch.float32)
                runs[name, overlap] = run_staggered(eng, cfg.vocab_size)
        outs = {k: v[0] for k, v in runs.items()}
        st = {f"{name}_{'overlapped' if ov else 'serialized'}": {
            k: v[1][k] for k in ("overlap_mode", "mixed_steps",
                                 "overlapped_admissions", "preemptions")}
            for (name, ov), v in runs.items()}
        report["paged" if paged else "arena"] = {"outputs": outs[
            "card", True], "stats": st}
        if len({str(o) for o in outs.values()}) != 1:
            raise AssertionError(f"MLA {'paged' if paged else 'arena'} "
                                 f"engines disagree: {outs}")
        if any(runs[n, True][1]["mixed_steps"] < 1 for n in ("cpu", "card")):
            raise AssertionError(f"MLA engines ran no mixed step: {st}")
        if paged and any(v[1]["preemptions"] < 1 for v in runs.values()):
            raise AssertionError(f"the MLA pool did not preempt: {st}")
    windowed = build_model(cfg, window=16)
    wruns = {}
    for name, params in (("cpu", cpu), ("card", gpu)):
        eng = Engine(windowed, params, max_batch=2, max_len=32, paged=True,
                     cache_dtype=torch.float32)
        if eng.paged or eng.overlap:
            raise AssertionError("windowed MLA did not resolve to the "
                                 "serialized arena")
        wruns[name] = run_staggered(eng, cfg.vocab_size)[0]
    report["windowed_arena"] = wruns["card"]
    print(json.dumps({"mla_reference": report}), flush=True)
    if wruns["card"] != wruns["cpu"]:
        raise AssertionError(f"windowed MLA, card against CPU: {wruns}")
    return training_reference_check(MLA_ARCH)


MLA_LAYERS = 4              # of deepseek-v2-236b's 60: 16.94 B parameters
MLA_SERVE_ARGS = ["--arch", MLA_ARCH, "--layers", str(MLA_LAYERS)] + \
    SERVE_ARGS[2:]
MLA_TRAIN_LAYERS = 2        # the dense MLA superstep: ~1.40 B parameters


def dense_mla_config(layers=MLA_LAYERS):
    """The dense MLA stack at deepseek-v2-236b's widths (its attention,
    its d_ff of 1536 as a swiglu MLP, its embedding and head), cut to
    `layers`, as tests/test_server.py builds _mla_cfg in place: no
    registry entry."""
    full = get_config(MLA_ARCH)
    return dataclasses.replace(full, name="deepseek-v2-dense-mla",
                               family="dense", num_layers=layers,
                               layer_types=("attn",) * layers, moe=None)


def mla_decode_layers(cfg, params, gen, b=8, t=512):
    """Device ms and launches of each layer's `mla_decode` (the
    projections, the absorbed attention in f32 and wo) over b rows of a
    t-slot latent arena, bf16, beside its bound: the latent cache and
    wq_a ... wo read once."""
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as TF

    m = cfg.mla
    x = torch.randn((b, 1, cfg.d_model), generator=gen, device=DEV).to(
        torch.bfloat16)
    out = []
    for lp in TF._layers(TF._cast(cfg, params), 0, cfg.num_layers):
        attn = lp["attn"]
        cache = {"ckv": torch.randn((b, t, m.kv_lora_rank), generator=gen,
                                    device=DEV).to(torch.bfloat16),
                 "kpe": torch.randn((b, t, m.qk_rope_head_dim),
                                    generator=gen, device=DEV).to(
                                        torch.bfloat16),
                 "ptr": torch.full((b,), 232, dtype=torch.int32,
                                   device=DEV)}
        pos = cache["ptr"].reshape(b, 1).clone()
        nbytes = sum(v.numel() * v.element_size()
                     for v in list(attn.values()) + [cache["ckv"],
                                                     cache["kpe"]])

        def fn(attn=attn, cache=cache, pos=pos):
            return A.mla_decode(attn, cfg, x, cache, pos)

        out.append({"ms": device_ms(fn, 10),
                    "launches": device_launches(fn, calls=10),
                    "bytes": nbytes,
                    "bound_ms": nbytes / roofline.HBM_BW * 1e3})
    return out


def dense_mla_serving():
    """Phase 41's dense MLA arms: `dense_mla_config()` through
    `repro_torch.launch.serve` on phase 7's workload from the arena and
    the paged pool (256 blocks of 16, chunks of 32), overlapped and then
    serialized: no attention kernel launched (MLA's cores are plain
    PyTorch), mixed steps in the overlapped runs, every budget served,
    every block returned, and each request's tokens equal between the
    schedulers on each backend. Returns the summaries."""
    cfg = dense_mla_config()
    report = {}
    for paged in (False, True):
        argv = SERVE_ARGS[2:] + (["--paged", "--block-size", "16"]
                                 if paged else [])
        backend = "paged" if paged else "arena"
        runs = {}
        for overlap in (True, False):
            print(cfg.name, " ".join(argv), f"(overlap={overlap})")
            reset_counts()
            out = serve_cli.serve(serve_cli.parse_args(argv), overlap=overlap,
                                  cfg=cfg)
            got = counts()
            st = out["stats"]
            if overlap:
                assert_overlapped(f"dense MLA {backend}", st)
            elif st["overlap_mode"] or st["mixed_steps"]:
                raise AssertionError("dense MLA: overlap=False ran "
                                     "overlapped")
            if any(got.values()):
                raise AssertionError(f"dense MLA {backend} launched "
                                     f"kernels: {got}")
            if out["paged"] != paged or [len(o) for o in out["outputs"]] \
                    != out["budgets"]:
                raise AssertionError(f"dense MLA {backend}: not served "
                                     f"as asked")
            if paged and out["free_blocks"] != out["num_blocks"]:
                raise AssertionError("dense MLA: blocks were not returned")
            runs[overlap] = out
            summary = serving_summary(out, got)
            summary.update(init_peak_GB=out["init_peak_bytes"] / 1e9,
                           after_init_GB=out["init_bytes"] / 1e9)
            name = f"{backend}_{'overlapped' if overlap else 'serialized'}"
            report[name] = summary
            print(json.dumps({f"dense_mla_serving_{name}": summary}),
                  flush=True)
            torch.cuda.empty_cache()
        differ = [u for u, (a, b) in enumerate(zip(runs[True]["outputs"],
                                                   runs[False]["outputs"]))
                  if a != b]
        if differ:
            raise AssertionError(f"dense MLA {backend}: overlapped and "
                                 f"serialized tokens differ for {differ}")
    return report


def dense_mla_training():
    """Phase 41's supersteps: two API-BCD supersteps of the dense MLA
    stack cut to MLA_TRAIN_LAYERS layers in its own dtypes (bf16
    parameters and compute), A=2, M=1, 2 x 256 tokens an agent (the
    first's ms includes first use): finite losses, one prox launch a leaf
    (16) each, superstep ms and peak."""
    cfg = dense_mla_config(MLA_TRAIN_LAYERS)
    tcfg = TrainConfig(num_agents=2, num_walks=1, tau=0.05, rho=20.0)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, tcfg,
                             torch.Generator(device=DEV).manual_seed(0))
    leaves = len(state["params"])
    n_params = sum(v[0].numel() for v in state["params"].values())
    state_gb = torch.cuda.memory_allocated() / 1e9
    step_fn = make_train_step(model, tcfg)
    toks, targs = next(agent_batches(cfg.vocab_size, 2, 2, 256, seed=0))
    batch = {"tokens": torch.from_numpy(toks).to(DEV),
             "targets": torch.from_numpy(targs).to(DEV)}
    step_ms, total = [], 0
    for step in range(2):
        reset_counts()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch, step)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = {k: v for k, v in counts().items() if v}
        total += launches.get("prox_update", 0)
        loss = float(m["loss"])
        if launches != {"prox_update": leaves} or not np.isfinite(loss):
            raise AssertionError(f"dense MLA superstep {step}: loss {loss}, "
                                 f"launches {launches}, {leaves} leaves")
    report = {"layers": MLA_TRAIN_LAYERS, "agents": 2, "walks": 1,
              "batch": [2, 256], "params": n_params, "leaves": leaves,
              "state_GB": state_gb, "loss": loss, "superstep_ms": step_ms,
              "launches_per_superstep": launches,
              "launches": {"prox_update": total},
              "peak_GB": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps({"dense_mla_training": report}), flush=True)
    del state
    torch.cuda.empty_cache()
    return report


def mla_full_width(gen):
    """Phase 41: deepseek-v2-236b at full width cut to MLA_LAYERS layers
    through `launch.serve --layers` (`moe_serving`, no attention kernel),
    the dense MLA stack at its widths served four ways with its shared
    ops' row stability (phase 26's sweep), each MLA layer's decode time
    against its bound and two bf16 supersteps of the dense stack.
    Returns the report."""
    report = {}
    _, report["deepseek"] = moe_serving(gen, MLA_ARCH, MLA_SERVE_ARGS)
    torch.cuda.empty_cache()
    report["dense_serving"] = dense_mla_serving()
    dense_row_stability(gen, [dense_mla_config(1)],
                        out="row_stability_sweep_mla.json")
    cfg = dense_mla_config()
    _, _, _, params = serve_cli.build(serve_cli.parse_args(SERVE_ARGS[2:]),
                                      cfg)
    report["dense_mla_decode_layers"] = mla_decode_layers(cfg, params, gen)
    print(json.dumps({"dense_mla_decode_layers": report[
        "dense_mla_decode_layers"]}), flush=True)
    del params
    torch.cuda.empty_cache()
    report["training"] = dense_mla_training()
    return report


# phases 42-45: the encoder-decoder (whisper-small) and the VLM
# (phi-3-vision-4.2b)
WHISPER = "whisper-small"
PHI3 = "phi-3-vision-4.2b"
WHISPER_SERVE_ARGS = ["--arch", WHISPER, "--requests", "8", "--prompt-len",
                      "32", "--new-tokens", "64"]
PHI3_SERVE_ARGS = ["--arch", PHI3, "--requests", "8", "--prompt-len", "200",
                   "--new-tokens", "64"]
PHI3_ENGINE_LAYERS = 4      # phi-3 through the engine: 4 of its 32 layers
PHI3_TRAIN_LAYERS = 2       # its superstep: 0.42 B parameters, A=2, M=1


def new_shape_kernel_cases(gen):
    """Phase 42: the attention kernels at the shapes of whisper-small and
    phi-3-vision, bf16, each against its plain version and timed as phase
    3 times them (SDPA beside flash and decode, with is_causal=False for
    the non-causal cases; gather + SDPA beside paged and ring): flash
    non-causal at whisper's encoder ([1,1500,12,64] over itself, 1500 no
    multiple of the 64-row tile) and cross-attention prefill (200 queries
    over 1500 keys), edge cases S = T = 17 and S = 65 over T = 130, flash
    causal at phi-3's hd 96 (1024 patches + 200 tokens, 32 heads); decode
    over whisper's cross K/V (8 rows, 1500 each, G = 1) and at hd 96 (8
    rows over 1280, lengths 1..1280); paged and ring at hd 96, each
    bitwise invariant to the table's width, the batch and a repeat (phase
    10's checks). Returns (flash, decode, paged, ring) cases."""
    w_heads = dict(h=12, kv=12, hd=64)
    p_heads = dict(h=32, kv=32, hd=96)
    flash = [
        check_flash_case("whisper encoder, non-causal S=T=1500, 12 heads "
                         "of 64", 1500, gen, causal=False, **w_heads),
        check_flash_case("whisper cross-attention prefill, non-causal "
                         "S=200 T=1500", 200, gen, causal=False, t=1500,
                         **w_heads),
        check_flash_case("non-causal S=T=17 (a cut fragment)", 17, gen,
                         causal=False, **w_heads),
        check_flash_case("non-causal S=65 T=130 at hd 96 (both cut "
                         "mid-tile)", 65, gen, causal=False, t=130,
                         **p_heads),
        check_flash_case("phi-3 prefill S=1224 (1024 patches + 200), 32 "
                         "heads of 96", 1224, gen, **p_heads)]
    torch.cuda.empty_cache()
    decode = [
        check_decode_case("whisper cross K/V B=8 T=1500, 12 heads of 64 "
                          "(G 1)", 8, 1500, gen, full=True, **w_heads),
        check_decode_case("phi-3 decode B=8 T=1280, 32 heads of 96", 8,
                          1280, gen, **p_heads)]
    torch.cuda.empty_cache()
    paged = [check_paged_case(
        "phi-3 paged B=8 <=1280 tokens bs=16, 32 heads of 96", 8, 1280, 16,
        dtype, gen, **p_heads) for dtype in (torch.bfloat16, torch.float32)]
    ring = [check_ring_case(
        f"ring window {RING_WINDOW} B=8 bs=16, 32 heads of 96", 8,
        RING_WINDOW, 16, dtype, gen, **p_heads)
        for dtype in (torch.bfloat16, torch.float32)]
    torch.cuda.empty_cache()
    return flash, decode, paged, ring


def _greedy_run(model, params, batch, start, steps, cache_len, dev):
    """model.prefill of `batch` on `dev` with a cache of cache_len rows in
    f32, then `steps` decode steps at positions start + i, each from the
    step's greedy token: (logits [B, 1 + steps, V] on the CPU, flash and
    decode launches of the prefill, decode launches a step)."""
    reset_counts()
    logits, caches = model.prefill(params, {k: v.to(dev) for k, v in
                                            batch.items()},
                                   cache_dtype=torch.float32,
                                   cache_len=cache_len)
    prefill = counts()
    seq = [logits.cpu()]
    tok = logits[:, -1].argmax(-1)[:, None].int()
    reset_counts()
    for i in range(steps):
        logits, caches = model.decode_step(params, tok, caches, start + i)
        seq.append(logits.cpu())
        tok = logits[:, -1].argmax(-1)[:, None].int()
    per_step = {k: v / steps for k, v in counts().items()}
    return torch.cat(seq, dim=1), prefill, per_step


def _card_vs_cpu_serving(what, model, batch, start, steps, want_prefill,
                         want_step):
    """_greedy_run on the CPU and the card from one set of f32 parameters
    (TF32 off): logits within 1e-4, equal greedy tokens, and the card's
    launches as expected ({kernel: count}, the others 0). Returns the
    report."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = model.init(torch.Generator().manual_seed(0))
    (want, _, _), (got, prefill, per_step) = (
        _greedy_run(model, p, batch, start, steps, start + steps, dev)
        for dev, p in ((torch.device("cpu"), cpu), (DEV, _to(cpu, DEV))))
    err = float((got - want).abs().max())
    equal = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    report = {"max_abs_err": err, "tolerance": 1e-4, "tokens_equal": equal,
              "prefill_launches": {k: v for k, v in prefill.items() if v},
              "launches_per_step": {k: v for k, v in per_step.items() if v}}
    print(json.dumps({f"{what}_card_vs_cpu": report}), flush=True)
    if err > 1e-4 or not equal:
        raise AssertionError(f"{what}: card and CPU disagree: {report}")
    for got, want in ((prefill, want_prefill), (per_step, want_step)):
        full = {k: want.get(k, 0) for k in got}
        if got != full:
            raise AssertionError(f"{what}: launches {got}, expected {full}")
    return report


def _frames_batch(cfg, lead, seed, tokens=None):
    """Random frames [*lead, T_enc, D] (f32) beside random tokens and
    targets [*lead, S] (S = `tokens`), numpy from `seed`."""
    rng = np.random.default_rng(seed)
    out = {"frames": rng.standard_normal(
        lead + (cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    if tokens:
        toks = rng.integers(0, cfg.vocab_size, lead + (tokens + 1,)).astype(
            np.int32)
        out.update(tokens=toks[..., :-1], targets=toks[..., 1:])
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}


def whisper_reference_check():
    """Phase 43: whisper's smoke config in f32 (TF32 off), card against CPU
    from one set of parameters: `encode` (within 1e-4), a batched prefill
    and 8 decode steps (logits within 1e-4, equal tokens; 3L flash
    launches a prefill, the encoder's, the decoder's self-attention's and
    its cross-attention's, and 2L decode launches a step, self and
    cross), `train_loss` (rtol 1e-4) and one API-BCD superstep (A=4, M=2,
    phase 37's rule; one prox launch a leaf)."""
    from repro_torch.models import encdec as ED

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke(WHISPER), compute_dtype="float32")
    model = build_model(cfg)
    n = cfg.num_layers
    batch = _frames_batch(cfg, (2,), 1, tokens=9)
    report = {"serving": _card_vs_cpu_serving(
        "whisper_smoke", model, {k: batch[k] for k in ("frames", "tokens")},
        9, 8, {"flash_attention": 3 * n}, {"decode_attention": 2 * n})}
    cpu = model.init(torch.Generator().manual_seed(0))
    gpu = _to(cpu, DEV)
    enc = [ED.encode(cfg, p, batch["frames"].to(d), kernel=True).cpu()
           for d, p in (("cpu", cpu), (DEV, gpu))]
    loss = [float(model.train_loss(p, _to(batch, d))[0])
            for d, p in (("cpu", cpu), (DEV, gpu))]
    report.update(encode_max_abs_err=float((enc[1] - enc[0]).abs().max()),
                  train_loss=loss)
    tcfg = TrainConfig(num_agents=4, num_walks=2)
    step_fn = make_train_step(model, tcfg)
    b = _frames_batch(cfg, (4, 2), 2, tokens=16)
    state = init_train_state(model, tcfg, torch.Generator().manual_seed(0))
    gstate = _to(state, DEV)
    state, m_cpu = step_fn(state, b, 0)
    reset_counts()
    gstate, m_gpu = step_fn(gstate, _to(b, DEV), 0)
    launches = {k: v for k, v in counts().items() if v}
    close = _state_close(gstate, state, lambda want, part: 1e-4 * (
        max(1.0, float(want.abs().max())) if part == "gacc" else 1.0))
    report["superstep_card_vs_cpu"] = {
        "loss_card": float(m_gpu["loss"]), "loss_cpu": float(m_cpu["loss"]),
        "leaves": len(state["params"]), "launches": launches,
        "max_abs_err": {p: e for p, (_, e) in close.items()}}
    print(json.dumps({"whisper_reference": report}), flush=True)
    ok = report["encode_max_abs_err"] <= 1e-4 and abs(
        loss[1] - loss[0]) <= 1e-4 * abs(loss[0])
    ok &= all(c for c, _ in close.values()) and abs(
        float(m_gpu["loss"]) - float(m_cpu["loss"])) \
        <= 1e-4 * abs(float(m_cpu["loss"]))
    ok &= launches == {"prox_update": len(state["params"])}
    if not ok:
        raise AssertionError(f"whisper: card and CPU disagree: {report}")
    return report


def raw_serving(argv, per_prefill, per_step):
    """`repro_torch.launch.serve` through its raw loop (`serve_raw`) with
    `argv` at full width, counts reset just before and read just after:
    per_prefill and per_step ({kernel: launches}) for the one prefill and
    each decode step, no other kernel; every row gets prefill's token and
    one a step, all in the vocabulary. Returns (summary, launches)."""
    print(" ".join(argv))
    args = serve_cli.parse_args(argv)
    reset_counts()
    out = serve_cli.main(argv)
    got = counts()
    want = {k: per_prefill.get(k, 0) + args.new_tokens * per_step.get(k, 0)
            for k in got}
    toks = np.asarray(out["tokens"])
    summary = {"argv": " ".join(argv), "prefill_s": out["prefill_s"],
               "decode_s": out["decode_s"],
               "decode_ms_per_step": out["decode_s"] * 1e3 / args.new_tokens,
               "tokens_per_s": out["tokens_per_s"], "prefix": out["prefix"],
               "init_peak_GB": out["init_peak_bytes"] / 1e9,
               "peak_GB": out["peak_bytes"] / 1e9, "launches": got,
               "first_row": toks[0].tolist()}
    print(json.dumps({"raw_serving": summary}), flush=True)
    if got != want:
        raise AssertionError(f"{argv}: launches {got}, expected {want}")
    if toks.shape != (args.requests, args.new_tokens + 1) or toks.min() < 0:
        raise AssertionError(f"{argv}: tokens of shape {toks.shape}")
    return summary, got


def profile_raw_decode(argv, steps=8):
    """Steady decode steps of the raw loop's model at full width (`argv`'s
    --arch, --requests rows after a prefill of `raw_prompt`'s batch, bf16
    parameters as `serve_raw` casts them): `steps` steps timed on the host
    clock, then `steps` more under torch.profiler between pad_profile()'s
    sleeps: device ms and device launches a step, the busy share of the
    steps' wall time (profiled, and estimated from the unprofiled steps),
    the attention kernels' device ms. Returns the report."""
    from torch.profiler import ProfilerActivity, profile

    args = serve_cli.parse_args(argv)
    _, cfg, model, params = serve_cli.build(args)
    params = {k: v.to(getattr(torch, cfg.compute_dtype))
              if v.is_floating_point() else v for k, v in params.items()}
    prompt, prefix = serve_cli.raw_prompt(cfg, args.requests,
                                          args.prompt_len, DEV)
    pos = args.prompt_len + prefix
    logits, caches = model.prefill(params, prompt,
                                   cache_len=pos + 2 * steps + 1)
    tok = logits[:, -1].argmax(-1)[:, None].int()

    def run(n):
        # as the raw loop: each step's token stays on the device
        nonlocal tok, caches, pos, logits
        for _ in range(n):
            logits, caches = model.decode_step(params, tok, caches, pos)
            tok = logits[:, -1].argmax(-1)[:, None].int()
            pos += 1

    run(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad_profile()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        pad_profile()
        torch.cuda.synchronize()
    rows = cuda_rows(prof)
    device = sum(ms for ms, _, _ in rows)
    report = {"arch": cfg.name, "rows": args.requests, "steps": steps,
              "device_ms_per_step": device / steps,
              "device_launches_per_step": sum(n for _, n, _ in rows) / steps,
              "wall_ms_per_step": wall_ms / steps,
              "unprofiled_wall_ms_per_step": plain_ms / steps,
              "device_busy_share": device / wall_ms if wall_ms else None,
              "device_busy_share_unprofiled_estimate": device / plain_ms,
              "attention_device_ms_per_step": sum(
                  ms for ms, _, name in rows if "decode_fwd" in name) / steps}
    print(json.dumps({"profile_raw_decode": report}), flush=True)
    del params, caches
    torch.cuda.empty_cache()
    return report


def superstep_run(what, cfg, agents, walks, batch, steps=3):
    """`steps` API-BCD supersteps of `cfg` in its own dtypes from a state
    made on the card, on `batch` (leaves [A, ...], on the card), and one
    more under torch.profiler (device ms, device launches, busy share):
    finite losses, one prox launch a leaf each and no other kernel, ms a
    superstep (the first includes first use) and the peak. "launches"
    counts the `steps` supersteps' prox launches. Returns the report."""
    from torch.profiler import ProfilerActivity, profile

    tcfg = TrainConfig(num_agents=agents, num_walks=walks, tau=0.05,
                       rho=20.0)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, tcfg,
                             torch.Generator(device=DEV).manual_seed(0))
    leaves = len(state["params"])
    n_params = sum(v[0].numel() for v in state["params"].values())
    state_gb = torch.cuda.memory_allocated() / 1e9
    step_fn = make_train_step(model, tcfg)
    step_ms, losses, total = [], [], 0

    def one(step):
        nonlocal state, total
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch, step)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = {k: v for k, v in counts().items() if v}
        total += launches.get("prox_update", 0)
        losses.append(float(m["loss"]))
        if launches != {"prox_update": leaves} or not np.isfinite(
                losses[-1]):
            raise AssertionError(f"{what} superstep {step}: loss "
                                 f"{losses[-1]}, launches {launches}, "
                                 f"{leaves} leaves")

    for step in range(steps):
        one(step)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one(steps)
    wall = step_ms.pop()
    events = cuda_events(prof)
    device = sum(us for _, us in events) / 1e3
    report = {"layers": cfg.num_layers, "agents": agents, "walks": walks,
              "batch": {k: list(v.shape) for k, v in batch.items()},
              "params": n_params, "leaves": leaves, "state_GB": state_gb,
              "losses": losses, "superstep_ms": step_ms,
              "superstep_ms_after_first": float(np.mean(step_ms[1:])),
              "profiled_superstep": {
                  "wall_ms": wall, "device_ms": device,
                  "device_launches": len(events),
                  "device_busy_share": device / wall},
              "launches": {"prox_update": total - leaves},
              "peak_GB": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps({f"{what}_training": report}), flush=True)
    del state
    torch.cuda.empty_cache()
    return report


def whisper_full():
    """Phase 44: whisper-small at full width and depth (12 + 12 layers).
    Served through `launch.serve --arch whisper-small` (the raw loop: 8
    requests, prompts of 32, 64 new tokens, 1500 random frames each):
    36 flash launches for the prefill (12 encoder, 12 self, 12 cross) and
    24 decode launches a step (12 self, 12 over the cross K/V), no other
    kernel; 8 steady decode steps profiled. Then 3 API-BCD supersteps at
    A=4, M=2, one sequence of 128 tokens over 1500 frames an agent.
    Returns (serving summary and launches, training report)."""
    n = get_config(WHISPER).num_layers
    serving = raw_serving(WHISPER_SERVE_ARGS, {"flash_attention": 3 * n},
                          {"decode_attention": 2 * n})
    torch.cuda.empty_cache()
    profile_raw_decode(WHISPER_SERVE_ARGS)
    cfg = get_config(WHISPER)
    batch = _to(_frames_batch(cfg, (4, 1), 3, tokens=128), DEV)
    return serving, superstep_run("whisper_full", cfg, 4, 2, batch)


def phi3_full(gen):
    """Phase 45: phi-3-vision-4.2b. (a) its smoke config in f32 with
    head_dim raised to 96, card against CPU: a prefill with the patch
    prefix and 8 decode steps (logits within 1e-4, equal tokens; L flash
    launches a prefill and L decode a step). (b) Full width and depth
    through `launch.serve --arch phi-3-vision-4.2b` (the raw loop: 8
    requests, 1024 random patches + prompts of 200, 64 new tokens): 32
    flash launches at hd 96 for the prefill and 32 decode launches a
    step, the init's and the run's peaks, 8 steady decode steps
    profiled. (c) Full width cut to 4
    layers, text-only prompts through the engine (phase 27's
    `dense_serving`): the arena and the pool, overlapped and serialized
    with equal tokens; phase 26's row-stability sweep at its widths (d
    3072, d_ff 8192, H * hd 3072); three supersteps at 2 layers, A=2,
    M=1, 1024 patches + 128 tokens an agent. Returns the report."""
    cfg = dataclasses.replace(get_smoke(PHI3), compute_dtype="float32",
                              head_dim=96)
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)),
        "patches": torch.from_numpy(rng.standard_normal(
            (2, cfg.num_patches, cfg.d_model)).astype(np.float32))}
    n = cfg.num_layers
    report = {"smoke_hd96": _card_vs_cpu_serving(
        "phi3_smoke_hd96", build_model(cfg), batch, cfg.num_patches + 9, 8,
        {"flash_attention": n}, {"decode_attention": n})}
    full = get_config(PHI3)
    report["raw"], report["raw_launches"] = raw_serving(
        PHI3_SERVE_ARGS, {"flash_attention": full.num_layers},
        {"decode_attention": full.num_layers})
    torch.cuda.empty_cache()
    report["raw_profile"] = profile_raw_decode(PHI3_SERVE_ARGS)
    report["engine"] = {paged: dense_serving(PHI3, paged,
                                             layers=PHI3_ENGINE_LAYERS)
                        for paged in (False, True)}
    dense_row_stability(gen, [dataclasses.replace(
        full, num_layers=1, layer_types=("attn",))],
        out="row_stability_sweep_phi3.json")
    cut = dataclasses.replace(full, num_layers=PHI3_TRAIN_LAYERS,
                              layer_types=("attn",) * PHI3_TRAIN_LAYERS)
    g = torch.Generator(device=DEV).manual_seed(5)
    toks = torch.randint(0, full.vocab_size, (2, 1, 129), generator=g,
                         device=DEV, dtype=torch.int32)
    tbatch = {"tokens": toks[..., :-1].contiguous(),
              "targets": toks[..., 1:].contiguous(),
              "patches": torch.randn((2, 1, full.num_patches, full.d_model),
                                     generator=g, device=DEV)}
    report["training"] = superstep_run("phi3_2_layers", cut, 2, 1, tbatch)
    return report


# phase 46: the convex reference (float64), each figure of
# examples/decentralized_lsq.py at the example's own data size
CONVEX_UPDATES = 50     # run_serial activations, card against CPU
CONVEX_DGD_ROUNDS = 5
# activations a Newton method (I-BCD, API-BCD: ~7,400 launches, ~0.1 s
# an update) takes through the simulator in Figs. 5-6, cut from the
# figures' 800 and 300 (to 150 and 60 until phase 49 came, then to 40
# and 15 to keep the script inside its limit); lsq and the gradient
# methods run in full. Their card-against-CPU walks are cut from
# CONVEX_UPDATES to NEWTON_UPDATES the same way (the CPU's Newton prox
# takes ~0.1-0.3 s an update)
NEWTON_CUT = {"fig5_ijcnn1": 40, "fig6_usps": 15}
NEWTON_UPDATES = 15
NEWTON_METHODS = ("I-BCD", "API-BCD")


def convex_gap(card, cpu):
    """max |card - cpu| over max |cpu|."""
    cpu = cpu.double()
    return float((card.cpu() - cpu).abs().max() / cpu.abs().max())


def convex_walker(method, net):
    """fn() taking one activation a call, the state walking the
    Hamiltonian cycle from run_serial's starts."""
    order = hamiltonian_cycle(net)
    n, m = net.num_agents, method.num_walks
    walks = [CyclicWalk(order) for _ in range(m)]
    pos = [(w * n) // m for w in range(m)]
    rng = np.random.default_rng(0)
    st = {"state": method.init(), "k": 0}

    def step():
        w = st["k"] % m
        st["state"] = method.update(st["state"], pos[w], w)
        pos[w] = walks[w].next_agent(pos[w], rng)
        st["k"] += 1
    return step


def convex_profile(fn, calls=5, attempts=3):
    """(device launches, device ms) an update: every device event of
    `calls` calls of fn in one profile between pad_profile()'s sleeps
    (left out by name), over `calls`, after one warm-up call. A profile
    that kept no more sleeps than one side holds may have lost events of
    the calls too, so it is taken again, up to `attempts` times; the last
    is kept, and that is said. A Newton update is ~7,400 device events,
    so they are read from the profiler's raw events (`cuda_events`)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad_profile()
            for _ in range(calls):
                fn()
            pad_profile()
            torch.cuda.synchronize()
        events = cuda_events(prof)
        pads = sum(PAD_KERNEL in name for name, _ in events)
        if pads > PAD_LAUNCHES:
            break
        print(f"convex_profile: the profile kept {pads} of "
              f"{2 * PAD_LAUNCHES} sleeps; again", flush=True)
    calls_us = [us for name, us in events if PAD_KERNEL not in name]
    return len(calls_us) / calls, sum(calls_us) / 1e3 / calls


def convex_reference():
    """Phase 46: every figure of `repro_torch.examples.decentralized_lsq`
    (Figs. 3-6) on the card in float64. Each method's run_serial walk
    (CONVEX_UPDATES activations) and DGD's rounds against the same on the
    CPU, within 1e-9 of max |x|; then each method through
    simulate_incremental on the card (the Newton methods of Figs. 5-6
    cut to NEWTON_CUT), its metric past its start; updates/s and host ms
    an update from that run, device ms and launches an update under
    torch.profiler over 5 updates, and the busy share (device ms over the
    wall ms of 5 unprofiled updates, after them). No kernel of the port
    launches."""
    reset_counts()
    report = {}
    for fig in decentralized_lsq.FIGURES:
        t_fig = time.perf_counter()
        problem, net, methods, dgd, iters = decentralized_lsq.build_figure(
            fig, DEV)
        _, _, cpu_methods, cpu_dgd, _ = decentralized_lsq.build_figure(
            fig, "cpu")
        rows = sum(f.shape[0] for f in problem.features) + len(
            problem.test_features)
        print(f"{fig}: N {net.num_agents}, {rows} rows, p {problem.dim}, "
              f"{problem.kind}", flush=True)
        gaps = {}
        threads = torch.get_num_threads()
        for method, cpu_method in zip(methods, cpu_methods):
            walk = (NEWTON_UPDATES if method.name in NEWTON_METHODS
                    and fig in NEWTON_CUT else CONVEX_UPDATES)
            card = run_serial(method, net, walk)
            # tiny f64 ops: threads only slow the CPU's side down
            torch.set_num_threads(1)
            cpu = run_serial(cpu_method, net, walk)
            torch.set_num_threads(threads)
            gaps[method.name] = max(convex_gap(card.xs, cpu.xs),
                                    convex_gap(card.tokens, cpu.tokens))
        xs, cpu_xs = dgd.init(), cpu_dgd.init()
        for _ in range(CONVEX_DGD_ROUNDS):
            xs, cpu_xs = dgd.round(xs), cpu_dgd.round(cpu_xs)
        gaps["DGD"] = convex_gap(xs, cpu_xs)
        print(json.dumps({"figure": fig, "card_vs_cpu": gaps,
                          "seconds": time.perf_counter() - t_fig}),
              flush=True)
        bad = {k: v for k, v in gaps.items() if not v <= 1e-9}
        assert not bad, f"{fig}: card and CPU differ by {bad}"

        lower = problem.kind == "lsq"
        out = {"card_vs_cpu": gaps, "methods": {}}
        order = hamiltonian_cycle(net)
        for method in methods:
            steps = iters
            if method.name in NEWTON_METHODS and fig in NEWTON_CUT:
                steps = NEWTON_CUT[fig]
                print(f"  {method.name}: cut to {steps} of {iters} "
                      "activations", flush=True)
            walks = [CyclicWalk(order) for _ in range(method.num_walks)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = simulate_incremental(method, net, walks,
                                       max_iterations=steps, eval_every=10)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            first, last = res.trace[0], res.trace[-1]
            assert last.iteration == steps, (fig, method.name, last)
            better = (last.metric < first.metric if lower
                      else last.metric > first.metric)
            assert better, (f"{fig} {method.name}: metric {first.metric} "
                            f"-> {last.metric}")
            fn = convex_walker(method, net)
            t0 = time.perf_counter()
            launches, dev_ms = convex_profile(fn)
            profile_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 5
            row = {"activations": steps, "updates_per_s": steps / wall,
                   "host_ms_per_update": wall * 1e3 / steps,
                   "device_ms_per_update": dev_ms,
                   "launches_per_update": launches,
                   "wall_ms_per_update": wall_ms,
                   "busy_share": dev_ms / wall_ms,
                   "metric": [first.metric, last.metric],
                   "sim_time_ms": last.time * 1e3, "comm": last.comm,
                   "simulate_s": wall, "profile_s": profile_s}
            out["methods"][method.name] = row
            print(json.dumps({"figure": fig, "method": method.name, **row}),
                  flush=True)
        rounds = max(iters // net.num_agents, 50)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = simulate_gossip(dgd, net, max_rounds=rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        first, last = res.trace[0], res.trace[-1]
        better = (last.metric < first.metric if lower
                  else last.metric > first.metric)
        assert better, f"{fig} DGD: metric {first.metric} -> {last.metric}"
        out["DGD"] = {"rounds": rounds, "rounds_per_s": rounds / wall,
                      "metric": [first.metric, last.metric],
                      "sim_time_ms": last.time * 1e3, "comm": last.comm}
        out["seconds"] = time.perf_counter() - t_fig
        print(json.dumps({"figure": fig, "method": "DGD", **out["DGD"],
                          "figure_s": out["seconds"]}), flush=True)
        report[fig] = out
    assert not any(counts().values()), counts()
    return report


# phase 47: the async runtime on Fig. 3's problem (`FIGURES`: cpusmall,
# N = 20, all 8,192 rows, lsq, API-BCD tau 0.1) with M = 2 walks, and the
# launcher's arms with benchmarks/bench_async_bcd.py:53-59's flags and its
# quick settings (4 processes, 12 rounds, 4 local steps, max delay 4, a
# 3x straggler on process 1, a 10 ms update floor, rate rounds 4)
ASYNC_PROCS = 4
ASYNC_FIG = "fig3_cpusmall"
ASYNC_LAUNCH = ["--walks", "2", "--rounds", "12", "--straggle", "1:3.0",
                "--min-update-ms", "10", "--seed", "0"]
ASYNC_ASYNC = ["--max-delay", "4", "--local-steps", "4", "--adaptive"]
ASYNC_ARMS = {
    "lockstep": ["--max-delay", "0", "--local-steps", "1"],
    "async": ASYNC_ASYNC,
    "async+mid": ASYNC_ASYNC + ["--mid-round"],
    "async+mid+measured": ASYNC_ASYNC + [
        "--mid-round", "--measured-speeds", "--rate-rounds", "4"],
}
# (arm, transport), in order. The second tcp run of async+mid is cut for
# time (each launch starts four processes that import torch; launch_s
# says how long): its file run repeats it. Lockstep's file run and the
# measured arm's repeat are cut too (since phase 49 came): async+mid
# holds tcp against file, and tests/test_torch_async.py the measured
# arm's repeats
ASYNC_RUNS = (("lockstep", "tcp"),
              ("async+mid", "tcp"), ("async+mid", "file"),
              ("async", "tcp"), ("async+mid+measured", "tcp"))
# the logistic run through the Newton prox, cut for time (Fig. 5 walks
# 800 activations a method)
ASYNC_LOGISTIC = ["--dataset", "ijcnn1", "--agents", "50", "--subsample",
                  "10000", "--tau", "0.1", "--walks", "2", "--rounds", "4",
                  "--local-steps", "3", "--max-delay", "2", "--seed", "0"]
INT_TRACE = ("event", "round", "epoch", "own_updates", "applied_updates",
             "comm_events", "ingested", "staleness", "view_lag", "gated")


def async_figure():
    """(dataset, agents, rows, tau) of Fig. 3, every row of its dataset."""
    ds, n, _, _, _, _, tau, sub, _ = decentralized_lsq.FIGURES[ASYNC_FIG]
    return ds, n, sub or DATASETS[ds].num_samples, tau


def async_update_clock(problem, tau):
    """An API-BCD lsq update on the card with and without the wait the
    async worker adds after each: host ms of each (100 updates after a
    warm-up), and device ms and launches an update under the profiler."""
    method = APIBCD(problem, tau=tau, num_walks=2, device=DEV)
    steps = WalkSequence(problem.num_agents, 1, 0, 2)
    st = {"state": method.init()}

    def update():
        agent, walk = steps.take(1)[0]
        st["state"] = method.update(st["state"], agent, walk)

    def synced():
        update()
        torch.cuda.current_stream().synchronize()

    launches, dev_ms = convex_profile(update)
    out = {}
    for name, fn in (("unsynced", update), ("synced", synced)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        out[f"{name}_host_ms"] = (time.perf_counter() - t0) * 10.0
    return {**out, "device_ms": dev_ms, "launches": launches}


def async_threaded(problem, tau):
    """run_threaded at P = 4 on the card twice and on the CPU once: equal
    integer trace columns, tokens within 1e-9 of max |z| and objectives
    within 1e-9 of max |objective|, 4 equal card digests and a card
    repeat's equal to them."""
    cfg = AsyncBCDConfig(
        num_procs=ASYNC_PROCS, num_agents=problem.num_agents, num_walks=2,
        rounds=12, local_steps=4, max_delay=2, adaptive=True, mid_round=True,
        speeds=(1.0, 3.0, 1.0, 1.0), min_update_s=0.01)

    def go(device):
        methods = [APIBCD(problem, tau=tau, num_walks=2, device=device)
                   for _ in range(ASYNC_PROCS)]
        t0 = time.perf_counter()
        res = run_threaded(cfg, methods)
        return res, time.perf_counter() - t0

    card, card_s = go(DEV)
    repeat, _ = go(DEV)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cpu, cpu_s = go("cpu")
    torch.set_num_threads(threads)
    digests = {r.digest for r in card}
    assert len(digests) == 1, digests
    assert {r.digest for r in repeat} == digests, (
        [r.digest for r in repeat], digests)
    token_gap = obj_gap = 0.0
    for c, h in zip(card, cpu):
        assert [[rec[k] for k in INT_TRACE] for rec in c.trace] == [
            [rec[k] for k in INT_TRACE] for rec in h.trace], c.proc
        token_gap = max(token_gap, convex_gap(c.tokens, h.tokens))
        co = torch.tensor([rec["objective"] for rec in c.trace])
        ho = torch.tensor([rec["objective"] for rec in h.trace])
        obj_gap = max(obj_gap, convex_gap(co, ho))
    assert token_gap <= 1e-9 and obj_gap <= 1e-9, (token_gap, obj_gap)
    first, last = card[0].trace[0], card[0].trace[-1]
    assert last["objective"] < first["objective"], (first, last)
    return {"digest": card[0].digest, "card_s": card_s, "cpu_s": cpu_s,
            "card_wall_s": max(r.wall_s for r in card),
            "cpu_wall_s": max(r.wall_s for r in cpu),
            "updates": card[0].applied_updates,
            "ingested": sum(r.mid_round_ingested for r in card),
            "max_view_lag": max(r.max_view_lag for r in card),
            "update_ema_ms": [r.update_ema_s * 1e3 for r in card],
            "objective": [first["objective"], last["objective"]],
            "card_vs_cpu_tokens": token_gap, "card_vs_cpu_objective": obj_gap}


def train_async(flags, out):
    """`python -m repro_torch.launch.train_async` with 4 processes on the
    card: (the merged run, launch seconds). Fails unless it exits 0 with
    4 equal digests."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train_async",
           "--processes", str(ASYNC_PROCS), "--timeout", "300",
           "--out", out, *flags]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=400)
    launch_s = time.perf_counter() - t0
    digests = [ln.split("digest=")[1] for ln in res.stdout.splitlines()
               if "ASYNC_BCD_OK" in ln]
    if res.returncode != 0 or len(digests) != ASYNC_PROCS \
            or len(set(digests)) != 1:
        print(res.stdout[-6000:], res.stderr[-6000:], flush=True)
        raise AssertionError(f"train_async {flags}: rc {res.returncode}, "
                             f"digests {digests}")
    with open(out) as f:
        run = json.load(f)
    assert run["digest"] == digests[0] and run["device"].startswith("cuda")
    return run, launch_s


def async_summary(run, launch_s, target=None):
    """The numbers phase 47 prints for one launcher run."""
    procs = run["processes"]
    own = sum(p["own_updates"] for p in procs)
    recs = sorted((r for p in procs for r in p["trace"]),
                  key=lambda r: r["wall_s"])
    hit = None if target is None else next(
        (r["wall_s"] for r in recs if r["objective"] <= target), None)
    return {"digest": run["digest"], "launch_s": launch_s,
            "wall_s": run["wall_s"], "total_updates": run["total_updates"],
            "updates_per_s": own / run["wall_s"],
            "comm_events": run["total_comm_events"],
            "final_objective": run["final_objective"],
            "gate_wait_s": sum(p["gate_wait_s"] for p in procs),
            "ingest_wait_s": sum(p["ingest_wait_s"] for p in procs),
            "max_staleness": run["max_staleness"],
            "max_view_lag": run["max_view_lag"],
            "ingested": run["mid_round_ingested"],
            "update_ema_ms": [p["update_ema_s"] * 1e3 for p in procs],
            "local_steps": [p["local_steps"] for p in procs],
            "speed_buckets": procs[0]["speed_buckets"],
            "peak_mb": [p["peak_bytes"] / 2 ** 20 for p in procs],
            "time_to_lockstep_objective_s": hit}


def async_runtime():
    """Phase 47: the async runtime on one card. The threaded runtime card
    against CPU (async_threaded) and a synchronised update's clock on
    Fig. 3's problem; `launch.train_async` with 4 processes on the card
    for each of ASYNC_RUNS (equal digests within each run, tcp against
    file, repeats, staleness and view lag within the bound of 4); one
    logistic run (ijcnn1) through the Newton prox. No kernel of the port
    launches; no speed is gated."""
    t_phase = time.perf_counter()
    reset_counts()
    ds, n, rows, tau = async_figure()
    flags = ["--dataset", ds, "--agents", str(n), "--subsample", str(rows),
             "--tau", str(tau)]
    problem = make_problem(ds, n, seed=0, subsample=rows)
    clock = async_update_clock(problem, tau)
    print(json.dumps({"async_update_clock": clock}), flush=True)
    threaded = async_threaded(problem, tau)
    print(json.dumps({"async_threaded": threaded}), flush=True)
    assert not any(counts().values()), counts()

    runs = {}
    with tempfile.TemporaryDirectory() as td:
        for i, (arm, transport) in enumerate(ASYNC_RUNS):
            run, launch_s = train_async(
                [*flags, *ASYNC_LAUNCH, *ASYNC_ARMS[arm],
                 "--transport", transport],
                os.path.join(td, f"{i}.json"))
            runs.setdefault(arm, []).append((transport, run, launch_s))
        print(f"logistic: cut to 4 rounds x 3 local steps a process "
              f"(ijcnn1, N = 50, 10,000 rows)", flush=True)
        logistic, logistic_s = train_async(
            [*ASYNC_LOGISTIC, "--transport", "tcp"],
            os.path.join(td, "logistic.json"))

    target = runs["lockstep"][0][1]["final_objective"]
    lock_wall = runs["lockstep"][0][1]["wall_s"]
    report = {}
    for arm, got in runs.items():
        row = async_summary(got[0][1], got[0][2], target)
        hit = row["time_to_lockstep_objective_s"]
        row["speedup_vs_lockstep"] = lock_wall / hit if hit else None
        row["runs"] = [{"transport": t, "digest": r["digest"],
                        "wall_s": r["wall_s"], "launch_s": s,
                        "max_staleness": r["max_staleness"],
                        "max_view_lag": r["max_view_lag"],
                        "speed_buckets": r["processes"][0]["speed_buckets"],
                        "update_ema_ms": [p["update_ema_s"] * 1e3
                                          for p in r["processes"]]}
                       for t, r, s in got]
        report[arm] = row
        print(json.dumps({"async_arm": arm, **row}), flush=True)
    print(json.dumps({"async_speedups": {
        arm: row["speedup_vs_lockstep"] for arm, row in report.items()}}),
        flush=True)
    for arm, row in report.items():
        assert len({r["digest"] for r in row["runs"]}) == 1, (arm,
                                                             row["runs"])
        assert all(r["max_staleness"] <= 4 and r["max_view_lag"] <= 4
                   for r in row["runs"]), (arm, row["runs"])

    logistic_problem = make_problem("ijcnn1", 50, seed=0, subsample=10000)
    start = float(global_objective(logistic_problem, torch.zeros(
        logistic_problem.dim, dtype=torch.float64)))
    row = async_summary(logistic, logistic_s)
    assert row["final_objective"] < start, (row["final_objective"], start)
    print(json.dumps({"async_logistic": {**row, "start_objective": start}}),
          flush=True)
    print(json.dumps({"phase47_s": time.perf_counter() - t_phase}),
          flush=True)
    return report


def ptxas_report(logs, names=("flash_attention", "decode_attention",
                              "decode_attention_paged", "rwkv6_scan",
                              "rwkv6_scan_bwd", "rglru_scan")):
    """Phase 2: registers, spills and static shared bytes that ptxas
    reports for every instantiation of the flash, decode, WKV and RG-LRU
    kernels
    (names demangled with c++filt where the toolkit's machine has it), and
    the dynamic shared bytes each launch asks for, from the libraries'
    own size functions at the head dims and groups the main paths use."""
    import ctypes
    import re

    records = []
    for lib in names:
        entry = None
        for line in logs[lib].splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = {"library": lib, "kernel": m.group(1)}
                records.append(entry)
                continue
            if entry is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                entry.update(stack_frame=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                entry["registers"] = int(m.group(1))
                smem = re.search(r"(\d+) bytes smem", line)
                entry["static_smem"] = int(smem.group(1)) if smem else 0
    try:
        names_out = subprocess.run(
            ["c++filt"], input="\n".join(r["kernel"] for r in records),
            capture_output=True, text=True, check=True,
            timeout=60).stdout.splitlines()
        for r, name in zip(records, names_out):
            name = name.replace("(anonymous namespace)::", "")
            r["kernel"] = name.split("(")[0].removeprefix("void ")
    except (OSError, subprocess.SubprocessError):
        pass
    for r in records:
        print(json.dumps({"ptxas": r}), flush=True)
    flash = build.load("flash_attention")
    decode = build.load("decode_attention")
    paged = build.load("decode_attention_paged")
    for fn in (flash.flash_attention_smem_bytes,
               decode.decode_attention_smem_bytes,
               paged.decode_attention_paged_smem_bytes):
        fn.restype = ctypes.c_int
    dynamic = {f"flash hd {hd} {dt}": flash.flash_attention_smem_bytes(
        int(dt == "bf16"), hd) for hd in (32, 64, 96, 128, 256)
        for dt in ("bf16", "f32")}
    # G 1: whisper's cross K/V (hd 64) and phi-3-vision (hd 96)
    dynamic.update({f"decode hd {hd} G {g} {dt}":
                    decode.decode_attention_smem_bytes(int(dt == "bf16"), hd,
                                                       g)
                    for hd, g in ((64, 7), (256, 10), (32, 4), (128, 2),
                                  (128, 4), (128, 6), (128, 8), (64, 1),
                                  (96, 1))
                    for dt in ("bf16", "f32")})
    # the paged main paths: qwen2 (hd 64, G 7, bs 16) at 4 and 32 splits,
    # recurrentgemma (hd 256, G 10) and qwen3-8b (hd 128, G 4) at 4,
    # phi-3-vision (hd 96, G 1) at 10
    dynamic.update({f"paged hd {hd} G {g} splits {n} bs 16 {dt}":
                    paged.decode_attention_paged_smem_bytes(
                        int(dt == "bf16"), hd, g, n, paged_split_rows(hd), 16)
                    for hd, g, n in ((64, 7, 4), (64, 7, 32), (256, 10, 4),
                                     (128, 4, 4), (96, 1, 10))
                    for dt in ("bf16", "f32")})
    wkv_lib = build.load("rwkv6_scan")
    rglru_lib = build.load("rglru_scan")
    wkv_lib.rwkv6_scan_smem_bytes.restype = ctypes.c_int
    rglru_lib.rglru_scan_smem_bytes.restype = ctypes.c_int
    dynamic.update({f"wkv chunk {wkv.CHUNK} hd {hd} {dt} launch {n + 1}":
                    wkv_lib.rwkv6_scan_smem_bytes(int(dt == "bf16"), hd, n)
                    for hd in (32, 64) for n in (0, 1)
                    for dt in ("bf16", "f32")})
    dynamic.update({f"rglru {dt}": rglru_lib.rglru_scan_smem_bytes(
        int(dt == "bf16")) for dt in ("bf16", "f32")})
    print(json.dumps({"dynamic_smem_bytes": dynamic}), flush=True)
    return records


def kernel_entry(name, source, replaces, launches, cases, rep):
    """One kernel's record in the `kernels` line: its launches summed over
    the main paths that run it (`launches`: {path: count}, each counted
    from zero), the main-path case `rep` for shape and times, the worst
    case for the error, every case."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches, "shape": rep["shape"],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": rep["kernel_ms"], "kernel_ms": rep["kernel_ms"],
            "event_ms": rep["event_ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"], "cases": cases}


# phase 48's steps: (label, arch, shape, API-BCD TrainConfig or None)
COST_STEPS = [
    ("qwen2 superstep A=4 M=2 2x256", "qwen2-0.5b",
     ShapeConfig("superstep_a4_2x256", 256, 8, "train"),
     TrainConfig(num_agents=4, num_walks=2, tau=0.05, rho=20.0)),
    ("qwen2 decode B=8 T=512", "qwen2-0.5b",
     ShapeConfig("decode_b8_t512", 512, 8, "decode"), None),
    ("qwen2 prefill S=2048", "qwen2-0.5b",
     ShapeConfig("prefill_s2048", 2048, 1, "prefill"), None),
    ("rwkv6 decode B=8", "rwkv6-1.6b",
     ShapeConfig("decode_b8", 512, 8, "decode"), None),
]


def _count_difference(card, fake):
    """What differs between the card's count and the dry run's, by part."""
    sc = fake["step_cost"]
    parts = {"flops_by_unit": (card.ops_by_unit(), sc["flops_by_unit"]),
             "aten_flops": (sum(card.flops_by_unit.values()),
                            sc["aten_flops"]),
             "aten_bytes": (card.aten_bytes, sc["aten_bytes"]),
             "kernels": (card.by_kernel(), sc["kernels"])}
    return {k: {"card": a, "fake": b} for k, (a, b) in parts.items()
            if a != b}


def cost_step(label, arch, shape, train, smi, reps):
    """Count one step on the card against the dry run's fake count, then,
    after a warm step, time it unprofiled (`reps` steps, host clock to
    synchronize each) and profiled (device ms of `reps` steps from raw
    events). A profile that recorded no device time is taken again, up to
    3 times in all, and it raises when none did: the step launches
    kernels, so an empty profile is a failed measurement."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    fake = dryrun.lower_combo(arch, shape, train=train, verbose=False)
    fake_s = time.perf_counter() - t0
    combo = dryrun.make_combo(arch, shape, train=train)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    inputs = dryrun.step_inputs(
        combo, device=DEV, generator=torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    with roofline.StepCost() as card:
        dryrun.run_step(combo, inputs)
    torch.cuda.synchronize()
    diff = _count_difference(card, fake)

    def step():
        dryrun.run_step(combo, inputs)

    step()                      # warm, uncounted
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    attempts = 3
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad_profile()
            for _ in range(reps):
                step()
            pad_profile()
            torch.cuda.synchronize()
        rows = cuda_rows(prof)
        device = sum(ms for ms, _, _ in rows) / reps
        if device:
            break
        print(f"{label}: the profile recorded no device time; again",
              flush=True)
    else:
        raise AssertionError(f"{label}: {attempts} profiles of {reps} steps "
                             "recorded no device time")
    peak = torch.cuda.max_memory_allocated()
    del inputs
    torch.cuda.empty_cache()
    rl = fake["roofline"]
    bound_ms = max(rl["compute_s"], rl["memory_s"]) * 1e3
    wall = float(np.median(walls))
    rec = {"step": label, "arch": combo.name,
           "shape": dataclasses.asdict(shape),
           "card": smi, "flops": card.flops, "bytes": card.bytes,
           "flops_by_unit": card.ops_by_unit(),
           "kernels": card.by_kernel(),
           "equal_to_fake_count": not diff, "fake_count_s": fake_s,
           "wall_ms": walls, "wall_ms_median": wall,
           "device_ms": device,
           "device_launches": sum(n for _, n, _ in rows) / reps,
           "busy_share": device / wall,
           "bound_ms": bound_ms, "bound_by": rl["dominant"],
           "compute_ms": rl["compute_s"] * 1e3,
           "memory_ms": rl["memory_s"] * 1e3,
           "roofline_share": bound_ms / device,
           "model_flops": fake["model_flops"],
           "mfu": roofline.mfu(fake["model_flops"], wall / 1e3,
                               combo.cfg.compute_dtype),
           "useful_flop_ratio": fake["useful_flop_ratio"],
           "peak_GB": peak / 1e9,
           "dry_run_argument_GB":
               fake["memory_analysis"]["argument_size_in_bytes"] / 1e9}
    print(json.dumps({"cost_step": rec}), flush=True)
    if diff:
        raise AssertionError(f"{label}: the card's count differs from the "
                             f"dry run's on fake tensors: {diff}")
    return rec


def check_cost(reps):
    """The host time of the count check in an `ops` dispatcher with no
    count open, per call (one global lookup and a null context)."""
    q = torch.empty(1, 1, 1, 1)
    assert costs.OPEN is None
    t0 = time.perf_counter()
    for _ in range(reps):
        with ops._counted(costs.flash_attention, q, q, q):
            pass
    return (time.perf_counter() - t0) / reps * 1e6


# the paper preset's steps in phase 48 (its 300 cut for time)
EXAMPLE_STEPS = 12


def cost_accounting(smi):
    """Phase 48 (see the module's docstring). Returns its records."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    steps = [cost_step(label, arch, shape, train, smi,
                       reps=3 if train is not None else 8)
             for label, arch, shape, train in COST_STEPS]
    check_us = check_cost(200_000)
    decode = steps[1]
    print(json.dumps({"count_check": {
        "host_us_per_call": check_us,
        "calls_per_qwen2_decode_step": decode["kernels"][
            "decode_attention"]["calls"],
        "host_us_per_decode_step": check_us * decode["kernels"][
            "decode_attention"]["calls"],
        "decode_step_wall_ms_no_count_open": decode["wall_ms_median"],
        "card": smi}}), flush=True)

    t1 = time.perf_counter()
    out = train_lm_apibcd.main(["--preset", "paper", "--steps",
                                str(EXAMPLE_STEPS)])
    train_s = time.perf_counter() - t1
    if not out["improved"] or not np.all(np.isfinite(out["losses"])):
        raise AssertionError(f"train_lm_apibcd --preset paper did not "
                             f"improve: {out['losses']}")
    t1 = time.perf_counter()
    served = serve_batched.main(["--arch", "qwen2-0.5b"])
    serve_s = time.perf_counter() - t1
    lengths = [len(served["outputs"][uid])
               for uid in range(len(served["budgets"]))]
    if lengths != served["budgets"]:
        raise AssertionError(f"serve_batched: outputs of {lengths} tokens "
                             f"for budgets {served['budgets']}")
    print(json.dumps({"examples": {
        f"train_lm_apibcd_paper_{EXAMPLE_STEPS}_steps": {
            "s": train_s, "first10": float(np.mean(out["losses"][:10])),
            "last10": float(np.mean(out["losses"][-10:])),
            "improved": out["improved"]},
        "serve_batched_qwen2": {"s": serve_s, "steps": served["steps"],
                                "tokens_per_s": served["tokens_per_s"]},
        "card": smi}}), flush=True)
    print(f"phase 48: {time.perf_counter() - t0:.1f} s", flush=True)
    return steps


# phase 49: the superstep across processes. The R = 1 arm is phase 4's
# run (A=4, M=2, 2 x 256 tokens an agent, bf16 compute) as 4 ranks; the
# R = 2 arm is A=2, M=1 as 2 agents x 2 replicas, also in bf16. Its
# 1e-5 hold against make_train_step runs in f32 in this process (the
# replicas' gradients round as 256-row products where the one-process
# step's round as 512-row ones, which bf16 shows). The TP arm is A=2,
# M=1 as 2 agents x model parallel 2 (tensor parallelism), in bf16 at
# full width and depth; its f32 hold (full width, TP_CHECK_LAYERS layers)
# and the leaves its bf16 gate gathers come from ranks this script
# starts itself (--train-mesh-rank), its one-process f32 and bf16 runs
# from this process (the f32 one at TP_CHECK_LAYERS is the R2 arm's).
MESH_ARGS = ["--arch", "qwen2-0.5b", "--batch-per-agent", "2", "--seq",
             "256", "--steps", str(STEPS), "--log-every", "1", "--timeout",
             "500"]
# arm: (agents, walks, replica, model parallel)
MESH_ARMS = {"R1": (4, 2, 1, 1), "R2": (2, 1, 2, 1), "TP": (2, 1, 1, 2)}
# the R1 and R2 arms test the mesh's mechanics (the hop, the replicas,
# the digests), not depth: cut to this many layers for time when the TP
# arm came
MESH_LAYERS = {"R1": 4, "R2": 4}
# the TP arm's f32 hold runs at the R2 arm's depth: the R2 arm's
# one-process f32 run (A=2, M=1, same init and batches) is its reference
TP_CHECK_LAYERS = MESH_LAYERS["R2"]
# the leaves (params part) the TP arm's bf16 gate gathers from its ranks
TP_GATHERED = ("embed.table", "segments.0.attn.wq", "segments.0.attn.wo",
               "segments.0.ln1.scale", "final_norm.scale")
# the bf16 gate: the mesh's gap to one process's f32 run, over one
# process's own bf16 gap to it
TP_BF16_RATIO = 1.25
TP_F32_ATOL = 1e-5


def mesh_flags(arm, backend):
    agents, walks, replica, mp = MESH_ARMS[arm]
    flags = [*MESH_ARGS, "--backend", backend, "--agents", str(agents),
             "--walks", str(walks), "--processes",
             str(agents * replica * mp)]
    if mp > 1:
        flags += ["--model-parallel", str(mp)]
    if arm in MESH_LAYERS:
        flags += ["--layers", str(MESH_LAYERS[arm])]
    return flags


def mesh_sizes(arm):
    agents, _, replica, mp = MESH_ARMS[arm]
    return {"agent": agents, "replica": replica, "model": mp}


def replica_grad(replica):
    """trainer._grad as the mesh step takes an agent's gradient at
    `replica` replicas: each replica's rows apart, each gradient in f32
    times its share of the rows, summed in the replicas' order (what the
    reduce-scatter sums)."""
    plain = dist_trainer._grad

    def grad(model, params, batch):
        rows = next(iter(batch.values())).shape[0]
        per = rows // replica
        total, first = {}, None
        for j in range(replica):
            g, aux = plain(model, params, {k: v[j * per:(j + 1) * per]
                                           for k, v in batch.items()})
            for k, gk in g.items():
                gk = gk.float() * (per / rows)
                if j:
                    total[k] += gk
                else:
                    total[k] = gk
            first = first or aux
        return total, first

    return grad


def one_process_mesh_run(flags, grad=None, f32=False):
    """The launcher's run of `flags` in this process, through
    make_train_step on the card from the same seeded init and batches
    (with `grad` in place of the trainer's gradient, where given; with
    f32 products where `f32`): (model, TrainConfig, final state,
    losses)."""
    args = train_cli.parse_args(flags)
    cfg = train_cli._config(args)
    if f32:
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    model = build_model(cfg)
    tcfg = TrainConfig(num_agents=args.agents, num_walks=args.walks,
                       tau=args.tau, rho=args.rho)
    state = init_train_state(model, tcfg,
                             torch.Generator(device=DEV).manual_seed(0))
    step_fn = make_train_step(model, tcfg)
    batches = agent_batches(cfg.vocab_size, args.agents,
                            args.batch_per_agent, args.seq, seed=0)
    losses = []
    with (mock.patch.object(dist_trainer, "_grad", grad) if grad
          else contextlib.nullcontext()):
        for step in range(args.steps):
            toks, targs = next(batches)
            state, met = step_fn(state, {
                "tokens": torch.from_numpy(toks).to(DEV),
                "targets": torch.from_numpy(targs).to(DEV)}, step)
            losses.append(float(met["loss"]))
    torch.cuda.synchronize()
    return model, tcfg, state, losses


def gap_reference(state, losses):
    """What the TP arm's bf16 gate reads of a one-process run: its losses
    and its TP_GATHERED params, on the host."""
    return {"losses": losses, "leaves": {k: state["params"][k].cpu()
                                         for k in TP_GATHERED}}


def shard_digests(state, specs, sizes):
    """[{part: digest} of each rank's part of `state`], ranks row-major
    over `sizes`, as each rank of the launcher prints them."""
    from repro_torch.dist.sharding import mesh_coords

    out = []
    for rank in range(int(np.prod(list(sizes.values())))):
        coords = mesh_coords(sizes, rank)
        out.append({part: train_cli.part_digests({part: {
            k: local_shard(v, specs[part][k], sizes, coords)
            for k, v in leaves.items()}})[part]
            for part, leaves in state.items()})
    return out


def mesh_launch(flags, processes):
    """`repro_torch.launch.train`'s CLI with `flags` on the card, its
    parent in this process (`train_cli.main`, the module's entry point;
    run as `python -m` it would import torch once more before it
    spawns): (each rank's record in rank order, launch s). Fails unless
    every rank exits 0 and the parent's checks pass."""
    t0 = time.perf_counter()
    out = train_cli.main(flags)
    launch_s = time.perf_counter() - t0
    if len(out["ranks"]) != processes:
        raise AssertionError(f"launch.train {flags}: "
                             f"{len(out['ranks'])} rank records")
    return sorted(out["ranks"], key=lambda r: r["rank"]), launch_s


def mesh_rows(arm, ranks, backend, sends):
    """Phase 49's per-rank gates on one launch (every rank on the card
    over `backend`, its bytes every superstep equal to `sends`, the
    prox kernel LEAVES x STEPS times) and its per-rank record."""
    rows = []
    for rec in ranks:
        r = rec["rank"]
        assert rec["device"].startswith("cuda") and rec["backend"] == backend
        if any(sent != sends[r] for sent in rec["sent"]):
            raise AssertionError(f"{arm} rank {r} sent {rec['sent']}, the "
                                 f"leaf arithmetic says {sends[r]}")
        if rec["prox_update_launches"] != LEAVES * STEPS:
            raise AssertionError(f"{arm} rank {r}: prox_update launched "
                                 f"{rec['prox_update_launches']} times")
        rows.append({"rank": r, "coords": rec["coords"],
                     "superstep_ms": rec["step_ms"],
                     "hop_ms": rec["hop_ms"], "axis_ms": rec["axis_ms"],
                     "sent_bytes": rec["sent"][-1],
                     "peak_GB": rec["peak_bytes"] / 1e9,
                     "setup_s": rec["setup_s"], "finish_s": rec["finish_s"],
                     "prox_update_launches": rec["prox_update_launches"],
                     "losses": rec["losses"]})
    return rows


def mesh_record(arm, flags, smi, backend, ranks, rows, sends, **extra):
    """Phase 49's `mesh_training` record of one arm, printed."""
    out = {"arm": arm, "flags": " ".join(flags), "card": smi,
           "note": ("all ranks shared one card over gloo (host buffers); "
                    "times measure this transport, not NVLink"
                    if backend == "gloo" else
                    "one GPU a rank over NCCL"),
           "devices": [rec["device"] for rec in ranks], **extra,
           "collective_bytes_per_superstep": sum(sum(s.values())
                                                 for s in sends),
           "collective_bound_ms_nvlink": roofline.Roofline(
               {}, 0, collective_bytes=sum(sum(s.values()) for s in sends),
               chips=len(ranks)).collective_s * 1e3,
           "prox_update_launches": sum(r["prox_update_launches"]
                                       for r in rows),
           "ranks": rows}
    print(json.dumps({"mesh_training": out}), flush=True)
    return out


def mesh_arm(arm, smi, backend):
    """One replica arm of phase 49 (R1, R2): the one-process reference,
    its digests of each rank's part, the launch, and the per-rank
    numbers. Returns (its record, the one-process f32 make_train_step
    run of its flags, on the host, where the arm has replicas: (model,
    TrainConfig, state, losses); else None)."""
    agents, walks, replica, _ = MESH_ARMS[arm]
    flags = mesh_flags(arm, backend)
    sizes = mesh_sizes(arm)
    t0 = time.perf_counter()
    gap = f32_run = None
    if replica > 1:
        # the replicas' arithmetic in one process, in f32, held to
        # make_train_step in f32 at atol 1e-5
        model, tcfg, plain, losses = one_process_mesh_run(flags, f32=True)
        _, _, split, _ = one_process_mesh_run(flags, replica_grad(replica),
                                              f32=True)
        gap = {part: max(float((split[part][k] - v).abs().max())
                         for k, v in leaves.items())
               for part, leaves in plain.items()}
        f32_run = (model, tcfg, {part: {k: v.cpu() for k, v in
                                        leaves.items()}
                                 for part, leaves in plain.items()}, losses)
        del plain, split
        torch.cuda.empty_cache()
    # the ranks' digests: their parts of the one-process run at the
    # config's dtype (the gradient split as the replicas split it)
    model, tcfg, plain, _ = one_process_mesh_run(
        flags, replica_grad(replica) if replica > 1 else None)
    shapes = dist_trainer._param_shapes(model)
    specs = state_shardings(sizes, dist_trainer._state_shapes(shapes, tcfg))
    want = shard_digests(plain, specs, sizes)
    del plain
    torch.cuda.empty_cache()
    reference_s = time.perf_counter() - t0
    print(json.dumps({"mesh_reference": arm, "seconds": reference_s,
                      "replica_split_vs_one_process_max_abs": gap}),
          flush=True)
    if gap is not None and max(gap.values()) > 1e-5:
        raise AssertionError(f"{arm}: the replicas' gradient split leaves "
                             f"the one-process state by {gap} (> 1e-5)")
    ranks, launch_s = mesh_launch(flags, agents * replica)
    for rec in ranks:
        if rec["digests"] != want[rec["rank"]]:
            raise AssertionError(f"{arm} rank {rec['rank']} {rec['coords']}: "
                                 f"digests {rec['digests']}, the "
                                 f"one-process run's {want[rec['rank']]}")
    sends = dist_trainer.superstep_sends(shapes, sizes, 2)
    rows = mesh_rows(arm, ranks, backend, sends)
    return mesh_record(arm, flags, smi, backend, ranks, rows, sends,
                       launch_s=launch_s, reference_s=reference_s,
                       digests_equal=True,
                       replica_split_vs_one_process_max_abs=gap), f32_run


def _tp_rank_run(flags, device, mesh, comm, layers=0, f32=False):
    """This rank's run of `flags` on `mesh` (cut to `layers`, in f32 where
    `f32`): (model, TrainConfig, its state, losses)."""
    from repro_torch.dist.trainer import (init_mesh_train_state,
                                          make_mesh_train_step)

    args = train_cli.parse_args(flags + (["--layers", str(layers)]
                                         if layers else []))
    cfg = train_cli._config(args)
    if f32:
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    model = build_model(cfg)
    tcfg = TrainConfig(num_agents=args.agents, num_walks=args.walks,
                       tau=args.tau, rho=args.rho)
    state = init_mesh_train_state(
        model, tcfg, mesh, torch.Generator(device=device).manual_seed(0))
    step_fn = make_mesh_train_step(model, tcfg, mesh, comm)
    batches = agent_batches(cfg.vocab_size, args.agents,
                            args.batch_per_agent, args.seq, seed=0)
    losses = []
    for step in range(args.steps):
        toks, targs = next(batches)
        state, met = step_fn(state, {
            "tokens": torch.from_numpy(toks).to(device),
            "targets": torch.from_numpy(targs).to(device)}, step)
        losses.append(float(met["loss"]))
    torch.cuda.synchronize()
    return model, tcfg, state, losses


def train_mesh_rank(rank, coordinator, backend, out):
    """`--train-mesh-rank`: one rank of the TP arm's checks on its
    (agent, replica, model) = (2, 1, 2) mesh over `backend`: the arm's
    bf16 run at full depth (its losses and its pieces of TP_GATHERED,
    written to OUT/bf16.rank<R>.pt), then the f32 run at TP_CHECK_LAYERS
    layers (its losses and its state's piece, OUT/f32.rank<R>.pt), which
    `tp_checks` holds against the one-process f32 run."""
    import torch.distributed as dist

    from repro_torch.dist.collectives import Collectives
    from repro_torch.launch.mesh import (init_distributed,
                                         make_training_mesh, rank_device)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    agents, _, replica, mp = MESH_ARMS["TP"]
    device = rank_device(DEV, rank)
    torch.cuda.set_device(device)
    init_distributed(rank, agents * replica * mp, coordinator, backend,
                     device, timeout_s=400)
    mesh = make_training_mesh(agents, replica, mp)
    comm = Collectives(mesh, device)
    flags = mesh_flags("TP", backend)
    for name, layers, f32 in (("bf16", 0, False),
                              ("f32", TP_CHECK_LAYERS, True)):
        _, _, state, losses = _tp_rank_run(flags, device, mesh, comm,
                                           layers=layers, f32=f32)
        kept = ({"leaves": {k: state["params"][k].cpu() for k in TP_GATHERED}}
                if name == "bf16" else
                {"state": {part: {k: v.cpu() for k, v in leaves.items()}
                           for part, leaves in state.items()}})
        torch.save({"losses": losses, "coords": mesh.coords,
                    "device": str(device), **kept},
                   os.path.join(out, f"{name}.rank{rank}.pt"))
        del state, kept
        torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()


def check_ranks(flag, world, backend, out, timeout, while_running,
                extra=()):
    """`world` ranks of this script, `python -m chip_smoke FLAG BACKEND
    OUT *EXTRA --rank R --coordinator HOST:PORT`, started and ended by
    `launch.mesh.run_ranks` (the launchers' parent), with
    `while_running()` in this process meanwhile; prints the end of each
    rank's log and fails unless every rank exited 0. Returns
    (`while_running`'s result, the ranks' seconds)."""
    from repro_torch.launch.mesh import run_ranks

    path = os.pathsep.join([ROOT] + [
        p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, {"PYTHONPATH": path}):
        run = run_ranks("chip_smoke", [flag, backend, out, *extra], world,
                        "--rank", timeout, while_running=while_running)
    ranks_s = time.perf_counter() - t0
    for r, log in enumerate(run.outs):
        print("\n".join(f"  c{r}| {ln}" for ln in log.splitlines()[-30:]),
              flush=True)
    if any(run.rcs):
        raise AssertionError(f"{flag} ranks over {backend}: rcs {run.rcs}"
                             + (" (timed out)" if run.timed_out else ""))
    return run.during, ranks_s


def check_rank_args(argv):
    """(rank, coordinator, backend, dir, *extra) of a check rank's
    arguments as `check_ranks` starts it: BACKEND DIR *EXTRA --rank R
    --coordinator HOST:PORT."""
    *head, _, rank, _, coordinator = argv
    backend, out, *extra = head
    return (int(rank), coordinator, backend, out, *extra)


def tp_checks(backend, f32_run):
    """The TP arm's checks: this script's ranks (`train_mesh_rank`) over
    `backend` while this process runs the one-process bf16 and f32 runs
    of the arm's flags at full depth; then each rank's f32 piece against
    its cut of `f32_run` (the one-process f32 run at TP_CHECK_LAYERS
    layers, `mesh_arm`'s). Returns ({"f32": each rank's record,
    "mesh_bf16": the ranks' losses and their TP_GATHERED params joined,
    "one_bf16", "one_f32": the one-process runs' `gap_reference`s}, the
    ranks' seconds)."""
    from repro_torch.dist.sharding import gather_shards
    from repro_torch.dist.trainer import state_specs

    agents, _, replica, mp = MESH_ARMS["TP"]
    world = agents * replica * mp
    flags = mesh_flags("TP", backend)
    sizes = mesh_sizes("TP")

    def references():
        refs = {}
        for name, f32 in (("one_f32", True), ("one_bf16", False)):
            model, tcfg, plain, losses = one_process_mesh_run(flags,
                                                              f32=f32)
            refs[name] = gap_reference(plain, losses)
            del plain
            torch.cuda.empty_cache()
        return refs, state_specs(model, tcfg, sizes)["params"]

    model32, tcfg32, plain32, plain_losses = f32_run
    specs32 = state_specs(model32, tcfg32, sizes)
    f32, pieces = [], []
    with tempfile.TemporaryDirectory(prefix="train_mesh_checks_") as out:
        (refs, specs), ranks_s = check_ranks(
            "--train-mesh-rank", world, backend, out, 450, references)
        for r in range(world):
            got = torch.load(os.path.join(out, f"f32.rank{r}.pt"))
            f32.append({
                "f32_state_max_abs": {part: max(float((v - local_shard(
                    plain32[part][k], specs32[part][k], sizes,
                    got["coords"])).abs().max()) for k, v in leaves.items())
                    for part, leaves in got["state"].items()},
                "losses": got["losses"], "one_process_losses": plain_losses,
                "device": got["device"]})
            del got
            pieces.append(torch.load(os.path.join(out, f"bf16.rank{r}.pt")))
    if not all(g["device"].startswith("cuda") for g in f32):
        raise AssertionError(f"the TP check ranks ran on {f32}")
    mesh_bf16 = {"losses": pieces[0]["losses"],
                 "rank_losses": [p["losses"] for p in pieces],
                 "leaves": {k: gather_shards([p["leaves"][k] for p in pieces],
                                             specs[k], sizes)
                            for k in TP_GATHERED}}
    del pieces
    return {"f32": f32, "mesh_bf16": mesh_bf16, **refs}, ranks_s


def bf16_gaps(got, f32_ref):
    """The largest |difference| from the one-process f32 run `f32_ref`
    (a `gap_reference`) of `got`'s losses, and of its TP_GATHERED params
    over every gathered leaf (by leaf beside)."""
    leaves = {k: float((got["leaves"][k] - v).abs().max())
              for k, v in f32_ref["leaves"].items()}
    return {"losses": max(abs(a - b) for a, b in zip(got["losses"],
                                                     f32_ref["losses"])),
            "leaves": max(leaves.values()), "by_leaf": leaves}


def mesh_tp_arm(smi, backend, f32_run):
    """Phase 49's TP arm: the launch at full qwen2-0.5b width and depth
    as 4 ranks of (A=2, M=1, R=1, mp=2), gated for lockstep (equal losses
    on every rank, the leaves the axis does not split bitwise equal
    across each model line), the prox kernel's launches, the bytes
    (`superstep_sends`, the model axis's sums included), and its checks
    (`tp_checks`): f32 within TP_F32_ATOL of one process at
    TP_CHECK_LAYERS layers (`f32_run`, the R2 arm's one-process f32
    run), and bf16 within TP_BF16_RATIO of one process's own bf16 gap to
    its f32 run."""
    agents, _, replica, mp = MESH_ARMS["TP"]
    flags = mesh_flags("TP", backend)
    sizes = mesh_sizes("TP")
    t0 = time.perf_counter()
    checks, checks_s = tp_checks(backend, f32_run)
    f32_ref = checks["one_f32"]
    ranks, launch_s = mesh_launch(flags, agents * replica * mp)
    cfg = train_cli._config(train_cli.parse_args(flags))
    shapes = dist_trainer._param_shapes(build_model(cfg))
    sends = dist_trainer.superstep_sends(shapes, sizes, 2, cfg=cfg,
                                         seq=train_cli.parse_args(flags).seq)
    # lockstep: the launch exits 0 only where its parent found the ranks'
    # losses equal and the unsplit leaves bitwise equal across each line
    rows = mesh_rows("TP", ranks, backend, sends)
    f32_gaps = [g["f32_state_max_abs"] for g in checks["f32"]]
    worst32 = max(max(g.values()) for g in f32_gaps)
    mesh_bf16 = checks["mesh_bf16"]
    if any(ls != ranks[0]["losses"] for ls in mesh_bf16["rank_losses"]):
        raise AssertionError(f"TP: the check ranks' bf16 losses "
                             f"{mesh_bf16['rank_losses']} are not the "
                             f"launch's {ranks[0]['losses']}")
    gaps = {"mesh_bf16_vs_one_process_f32": bf16_gaps(mesh_bf16, f32_ref),
            "one_process_bf16_vs_f32": bf16_gaps(checks["one_bf16"],
                                                 f32_ref)}
    out = mesh_record(
        "TP", flags, smi, backend, ranks, rows, sends, launch_s=launch_s,
        checks_s=checks_s, lockstep=True,
        f32_layers=TP_CHECK_LAYERS, f32_state_max_abs_by_rank=f32_gaps,
        f32_losses=checks["f32"][0]["losses"],
        f32_one_process_losses=checks["f32"][0]["one_process_losses"],
        bf16_gaps=gaps, bf16_ratio_limit=TP_BF16_RATIO,
        losses={"mesh_bf16": ranks[0]["losses"],
                "one_process_bf16": checks["one_bf16"]["losses"],
                "one_process_f32": f32_ref["losses"]},
        arm_s=time.perf_counter() - t0)
    if not worst32 <= TP_F32_ATOL:
        raise AssertionError(f"TP: the f32 mesh state is {worst32} from one "
                             f"process's at {TP_CHECK_LAYERS} layers "
                             f"(> {TP_F32_ATOL})")
    mesh_gap, one_gap = (gaps["mesh_bf16_vs_one_process_f32"],
                         gaps["one_process_bf16_vs_f32"])
    for what in ("losses", "leaves"):
        if not mesh_gap[what] <= TP_BF16_RATIO * one_gap[what]:
            raise AssertionError(
                f"TP: the bf16 mesh's {what} are {mesh_gap[what]} from one "
                f"process's f32 run, beyond {TP_BF16_RATIO} x one "
                f"process's own bf16 gap {one_gap[what]}")
    return out


def mesh_training(smi, gen, backend="gloo"):
    """Phase 49 (see the module's docstring) over `backend`. Returns (the
    prox cases at the TP arm's piece shapes, which are the R = 2 shard
    shapes at full depth, {arm: record})."""
    t0 = time.perf_counter()
    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg)
    shapes = dist_trainer._param_shapes(model)
    r2 = state_shardings(mesh_sizes("R2"), dist_trainer._state_shapes(
        shapes, TrainConfig(num_agents=2, num_walks=1)))["params"]
    tp = dist_trainer.state_specs(model, TrainConfig(num_agents=2,
                                                     num_walks=1),
                                  mesh_sizes("TP"), shapes)["params"]
    cases = []
    for k in ("embed.table", "segments.0.mlp.w_gate"):
        stacked = (2,) + tuple(shapes[k].shape)
        shape = shard_shape(stacked, r2[k], mesh_sizes("R2"))
        if shape != shard_shape(stacked, tp[k], mesh_sizes("TP")):
            raise AssertionError(f"{k}: the R=2 shard {shape} is not the TP "
                                 f"piece")
        cases.append(check_prox_case(
            f"{k} TP mp=2 piece = R=2 shard at full depth", shape,
            torch.float32, gen))
    torch.cuda.empty_cache()
    arms, f32_runs = {}, {}
    for arm in ("R1", "R2"):
        arms[arm], f32_runs[arm] = mesh_arm(arm, smi, backend)
    # the R2 arm's one-process run is the TP arm's f32 reference: the
    # same run of the same flags, cut to the same depth
    r2, tp = ((train_cli._config(a), a.agents, a.walks, a.batch_per_agent,
               a.seq, a.steps, a.tau, a.rho)
              for a in (train_cli.parse_args(flags) for flags in (
                  mesh_flags("R2", backend),
                  mesh_flags("TP", backend)
                  + ["--layers", str(TP_CHECK_LAYERS)])))
    if r2 != tp:
        raise AssertionError("the R2 arm's one-process run is not the TP "
                             "arm's at TP_CHECK_LAYERS layers")
    arms["TP"] = mesh_tp_arm(smi, backend, f32_runs.pop("R2"))
    del f32_runs
    print(json.dumps({"phase49_s": time.perf_counter() - t0}), flush=True)
    return cases, arms


# phase 50: serving across processes, on the ("data", "model") = (2, 2)
# mesh of MESH_WORLD ranks: qwen2-0.5b at full width (budgets 4/16 on 8
# requests of 64-token prompts in 4 rows: phase 27's 8/32 until the data
# axis came, halved for time), four bf16 arms in one launch of
# launch.serve_mesh; the checks' ranks (this script with
# --serve-mesh-rank, MESH_WORLD of them) serve the first 4 requests at 16
# new tokens in f32 and take the first decode step's logits, on (1, 2)
# (each of the two data lines a mesh of its own, side by side: the arena's
# tokens on one; the logits, then the pool's tokens on the other), then
# on (2, 2)
MESH_SERVE_ARGS = ["--arch", "qwen2-0.5b", "--requests", "8", "--max-batch",
                   "4", "--prompt-len", "64", "--new-tokens", "16", "--mixed",
                   "--timeout", "400"]
MESH_F32_ARGS = ["--requests", "4", "--new-tokens", "16"]
# the (1, 2) check line's pool serves the f32 workload in this many rows:
# in 4 rows the pool stages all 4 requests at its first step, and no
# prefill rides a decode step; in 2 the later ones stream beside decoding
# rows (the arena streams one admission a step in any number of rows). It
# serves at the launch's MESH_SERVE_LAYERS layers, for time (the layers
# add no path; the arena's line and the logits stay at full depth)
MESH_POOL_ROWS = 2
MESH_SERVE_ARMS = ("arena", "arena-serialized", "paged", "paged-serialized")
# the four arms' launch tests the lockstep scheduler, the bytes and the
# launches, not depth: cut to this many layers for time when phase 49's
# TP arm came (the checks' f32 tokens and logits stay at full depth)
MESH_SERVE_LAYERS = 4
MESH_MP = 2
# the launch's and the check ranks' processes, at model parallel MESH_MP:
# (2, 2). The (1, 2) launch (2 processes) was cut for time when the data
# axis came: the (2, 2) launch runs the same launcher, arms and model-axis
# sums (and gave its digests bitwise), the check ranks keep the (1, 2)
# mesh's f32 tokens and logits and its fused mixed steps (arena and pool),
# and tests/test_torch_serve_mesh.py its launcher in bf16 on the CPU
MESH_WORLD = 4
F32_LOGIT_GAP = 1e-4
# the families of the model axis on the (1, MESH_MP) check lines, each
# line's one after another (line 0: dbrx-132b's experts over the axis,
# GQA at 24 of 48 heads; recurrentgemma-2b's RG-LRU channels, 1280 a
# rank, and its MQA layer's 5 query heads over the one kv head whole;
# whisper-small's 6 of 12 heads in the encoder, the decoder's self- and
# cross-attention and its odd vocabulary whole. Line 1: deepseek-v2-236b's
# experts and MLA heads, the latents whole on each rank; rwkv6-1.6b's 16
# of 32 heads with their WKV state; phi-3-vision's 16 of 32 heads of 96
# behind its 1024 patches), at full width cut to MESH_FAMILY_LAYERS
# layers: a dbrx rank's f32 piece is ~6.5 GB a layer beside 2.5 GB of
# embedding and head, deepseek's ~8.0 beside 2.1, and one process's whole
# f32 model, taken on the line's first rank after every line has freed
# its pieces, ~18 and ~20 GB; the other four families' whole models are
# 0.3-6 GB
MESH_LINE_FAMILIES = (("dbrx-132b", "recurrentgemma-2b", "whisper-small"),
                      ("deepseek-v2-236b", "rwkv6-1.6b",
                       "phi-3-vision-4.2b"))
# each family's fewest layers that keep its shape: recurrentgemma's
# (rglru, rglru, attn) runs its MQA layer; whisper's 1 encoder and 1
# decoder layer over its 1500 frames
MESH_FAMILY_LAYERS = {"dbrx-132b": 1, "deepseek-v2-236b": 1,
                      "rwkv6-1.6b": 1, "recurrentgemma-2b": 3,
                      "whisper-small": 1, "phi-3-vision-4.2b": 1}
# the families the engine cannot take (frames, patches): served through
# the ported wave steps (`dist.serving.make_prefill_step` /
# `make_decode_step`) on the raw loop's batch (`launch.serve.raw_prompt`)
# of WAVE_REQUESTS prompts of WAVE_PROMPT tokens and WAVE_NEW new ones
WAVE_FAMILIES = ("whisper-small", "phi-3-vision-4.2b")
WAVE_REQUESTS, WAVE_PROMPT, WAVE_NEW = 4, 64, 16
# the gates of the families this slice put on the axis: f32 logits within
# 1e-5 of the largest |logit| of one process's, and the bf16 gap to one
# process's f32 logits at most 1.25x one process's own (phase 49's rule;
# dbrx, deepseek and qwen2 keep F32_LOGIT_GAP and 1.0x)
NEW_FAMILY_F32_GAP = 1e-5
NEW_FAMILY_BF16_FACTOR = 1.25


def mesh_label(sizes):
    """The "(data, model)" label of a mesh's {axis: size}."""
    return f"({sizes['data']}, {sizes['model']})"


def mesh_kernel_cases(gen):
    """Phase 50's kernel cases: flash, decode, paged and ring decode at the
    rank's shard of qwen2-0.5b at model parallel 2 (7 query heads over 1
    kv head of 64; the prompt bucket 64, 4 rows of 128), decode, paged
    and ring at a data line's 2 of those rows (the (2, 2) mesh; flash is
    the same call, on the line that owns the slot), flash, decode and
    paged at internlm2-1.8b's shard (8 over 4 of 128), and flash and
    decode at dbrx-132b's (24 over 4 of 128, G = 6: 10 of the decode
    kernel's 16 MMA rows padding) at its check line's exact prompt length
    and rows; then the shapes the recurrent families and the
    encoder-decoder give a rank (`mesh_family_kernel_cases`). Returns
    (flash, decode, paged, ring, rwkv6_scan, rglru_scan) cases."""
    flash, decode, paged, ring = [], [], [], []
    cfg = get_config("dbrx-132b")
    heads = dict(h=cfg.num_heads // MESH_MP, kv=cfg.num_kv_heads // MESH_MP,
                 hd=cfg.head_dim)
    tag = (f"dbrx-132b rank shard at mp={MESH_MP}, {heads['h']}:"
           f"{heads['kv']} heads of {heads['hd']}")
    flash.append(check_flash_case(f"{tag}, exact-length prefill S=64", 64,
                                  gen, **heads))
    decode.append(check_decode_case(f"{tag}, decode B=4 T=128", 4, 128, gen,
                                    **heads))
    for arch in ("qwen2-0.5b", "internlm2-1.8b"):
        cfg = get_config(arch)
        heads = dict(h=cfg.num_heads // MESH_MP,
                     kv=cfg.num_kv_heads // MESH_MP, hd=cfg.head_dim)
        tag = (f"{arch} rank shard at mp={MESH_MP}, {heads['h']}:"
               f"{heads['kv']} heads of {heads['hd']}")
        flash.append(check_flash_case(f"{tag}, prefill Sp=64", 64, gen,
                                      **heads))
        rows = (4, 2) if arch == "qwen2-0.5b" else (4,)
        for b in rows:
            where = "" if b == 4 else f", a data line's {b} of 4 rows"
            decode.append(check_decode_case(
                f"{tag}{where}, decode B={b} T=128", b, 128, gen, **heads))
            paged.append(check_paged_case(
                f"{tag}{where}, paged B={b} <=128 tokens bs=16", b, 128, 16,
                torch.bfloat16, gen, **heads))
            if arch == "qwen2-0.5b":
                ring.append(check_ring_case(
                    f"{tag}{where}, ring window 64 B={b} bs=16", b, 64, 16,
                    torch.bfloat16, gen, **heads))
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    more = mesh_family_kernel_cases(gen)
    print(json.dumps({"mesh_family_kernel_cases_s":
                      time.perf_counter() - t0}), flush=True)
    return (flash + more[0], decode + more[1], paged, ring, more[2],
            more[3])


def mesh_family_kernel_cases(gen):
    """The kernel cases at the shapes a rank of MESH_MP gets from the
    families this slice put on the model axis, each against its plain
    version: the WKV scan on rwkv6-1.6b's 16 heads (prefill S = 64, the
    check line's exact prompt, and S = 200, the chunked body; decode of
    4 rows), the RG-LRU scan on recurrentgemma-2b's 1280 channels
    (prefill, decode), flash on recurrentgemma's MQA shard (5 query heads
    over the one kv head of 256, its 2048 window, S = 64 and S = 3000
    where the window binds) and on whisper-small's encoder shard (q and
    k/v [1, 1500, 6, 64], non-causal), decode on recurrentgemma's G = 5
    shard at hd 256 (11 of the 16 MMA rows padding) over the check line's
    128-row arena and over whisper's cross K/V [4, 1500, 6, 64] (every
    row valid). Returns (flash, decode, rwkv6_scan, rglru_scan) cases."""
    rg = get_config("recurrentgemma-2b")
    mqa = dict(h=rg.num_heads // MESH_MP, kv=1, hd=rg.head_dim)
    tag = (f"recurrentgemma-2b rank shard at mp={MESH_MP}, {mqa['h']}:1 "
           f"heads of {mqa['hd']} (the kv head whole)")
    flash = [check_flash_case(f"{tag}, prefill S=64, window "
                              f"{rg.attn_window}", 64, gen,
                              window=rg.attn_window, **mqa),
             check_flash_case(f"{tag}, prefill S=3000, window "
                              f"{rg.attn_window}", 3000, gen,
                              window=rg.attn_window, **mqa)]
    decode = [check_decode_case(f"{tag}, decode B=4 T=128 (G=5)", 4, 128,
                                gen, **mqa)]
    wh = get_config("whisper-small")
    heads = dict(h=wh.num_heads // MESH_MP, kv=wh.num_kv_heads // MESH_MP,
                 hd=wh.head_dim)
    tag = f"whisper-small rank shard at mp={MESH_MP}, {heads['h']} heads"
    flash.append(check_flash_case(
        f"{tag}, encoder T={wh.encoder_seq}, non-causal", wh.encoder_seq,
        gen, causal=False, **heads))
    decode.append(check_decode_case(
        f"{tag}, cross K/V B={WAVE_REQUESTS} T={wh.encoder_seq}, all "
        "valid", WAVE_REQUESTS, wh.encoder_seq, gen, full=True, **heads))
    rw = get_config("rwkv6-1.6b")
    h = rw.d_model // rw.rwkv_head_dim // MESH_MP
    tag = f"rwkv6-1.6b rank shard at mp={MESH_MP}, {h} heads"
    rwkv = [check_rwkv_case(f"{tag}, prefill S={n}", 1, n, torch.bfloat16,
                            gen, heads=h) for n in (64, 200)]
    rwkv.append(check_rwkv_case(f"{tag}, decode B=4", 4, 1, torch.bfloat16,
                                gen, heads=h))
    w = rg.rnn_width // MESH_MP
    tag = f"recurrentgemma-2b rank shard at mp={MESH_MP}, {w} channels"
    rglru = [check_rglru_case(f"{tag}, prefill S=64", 1, 64, torch.bfloat16,
                              gen, width=w),
             check_rglru_case(f"{tag}, decode B=4", 4, 1, torch.bfloat16,
                              gen, width=w)]
    torch.cuda.empty_cache()
    return flash, decode, rwkv, rglru


def serve_mesh_launch(backend, arms):
    """`repro_torch.launch.serve_mesh`'s CLI with MESH_SERVE_ARGS over
    `backend` on MESH_WORLD ranks at model parallel MESH_MP, its parent
    in this process (`serve_mesh.run_parent`, what its entry point runs;
    as `python -m` it would import torch once more before it spawns):
    ({(arm, process): record}, launch s). Fails unless it returns 0 with
    a record from every rank of every arm."""
    import io

    from repro_torch.launch import serve_mesh

    flags = [*MESH_SERVE_ARGS, "--processes", str(MESH_WORLD),
             "--model-parallel", str(MESH_MP), "--layers",
             str(MESH_SERVE_LAYERS), "--backend", backend, "--arms",
             ",".join(arms)]
    print("serve_mesh " + " ".join(flags), flush=True)
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = serve_mesh.run_parent(serve_mesh._build_parser().parse_args(
            flags), flags)
    launch_s = time.perf_counter() - t0
    records = {}
    for line in log.getvalue().splitlines():
        if "SERVE_MESH_ARM " in line:
            rec = json.loads(line.split("SERVE_MESH_ARM ", 1)[1])
            records[rec["arm"], rec["process"]] = rec
    print("\n".join(ln for ln in log.getvalue().splitlines()
                    if "SERVE_MESH_ARM " not in ln), flush=True)
    if rc != 0 or len(records) != MESH_WORLD * len(arms):
        raise AssertionError(f"serve_mesh over {backend} on {MESH_WORLD} "
                             f"processes: rc {rc}, {len(records)} records")
    return records, launch_s


def mesh_f32_workload(cfg):
    """The f32 check's workload (serve_mesh's, MESH_F32_ARGS: its first 4
    requests at 16 new tokens) and the arena's max_len of phase 50's
    launches."""
    from repro_torch.launch import serve_mesh
    from repro_torch.serve import bucket_length

    args = serve_mesh._build_parser().parse_args(MESH_SERVE_ARGS)
    max_len = bucket_length(args.prompt_len + args.new_tokens)
    args = serve_mesh._build_parser().parse_args(MESH_SERVE_ARGS
                                                 + MESH_F32_ARGS)
    return serve_mesh._workload(cfg, args), max_len


def first_decode_logits(model, params, prompts, capacity, mesh=None,
                        comm=None):
    """The logits [B, 1, V] (the whole vocabulary) of the first decode
    step of `prompts` (B token-id arrays) admitted into slots 0..B-1 of
    an arena of `capacity` in the compute dtype, each padded to its
    bucket as the engine pads it (at its exact length where the family
    does not pad, as MoE), and decoded from its greedy first token:
    through `model` itself, or on `mesh` through this rank's slice
    (`dist.serving.local_model`) of its data line's rows
    (`dist.serving.RowSplit`; the slices and rows gathered). The
    parameters are the engine's (`tensor_parallel.serving_params`: the
    whole model's or, on a mesh, the rank's piece)."""
    from repro_torch.dist import serving
    from repro_torch.dist.tensor_parallel import model_axis, serving_params
    from repro_torch.serve import bucket_length
    from repro_torch.serve.engine import probe_family_caps

    pad = probe_family_caps(model, capacity=capacity).pad_prompts
    device = next(iter(params.values())).device
    steps, axis = model, None
    if mesh is not None:
        steps = serving.local_model(model, mesh, comm)
        axis = model_axis(mesh, comm)
    rows = serving.RowSplit(len(prompts), mesh, comm, device)
    params = serving_params(model.cfg, params, mesh)
    arena = steps.init_arena(rows.rows, capacity,
                             dtype=getattr(torch, model.cfg.compute_dtype),
                             device=device)
    mine = prompts[rows.lo:rows.hi]
    firsts = []
    for row, p in enumerate(mine):
        width = min(bucket_length(len(p), 8), capacity) if pad else len(p)
        toks = np.zeros((1, width), np.int32)
        toks[0, :len(p)] = p
        tok, arena = steps.prefill_into_slot_token(
            params, torch.from_numpy(toks).to(device), len(p), row, arena)
        firsts.append(tok)
    positions = torch.tensor([len(p) for p in mine], dtype=torch.int32,
                             device=device)
    logits, _ = steps.decode_rows(params, torch.stack(firsts)[:, None],
                                  arena, positions)
    if axis is not None:
        logits = axis.gather_vocab(logits)
    return rows.gather(logits)


def serve_f32(cfg, params, work, max_len, mesh=None, paged=False):
    """`work` served in f32 by one engine (on `mesh`, this rank's; on the
    pool in MESH_POOL_ROWS rows where `paged`, else on the arena in a row
    a request) overlapped as "auto" picks: (its tokens by uid, its
    stats)."""
    eng = Engine(build_model(dataclasses.replace(cfg,
                                                 compute_dtype="float32")),
                 params, max_batch=MESH_POOL_ROWS if paged else len(work),
                 max_len=max_len, mesh=mesh, cache_dtype=torch.float32,
                 paged=paged)
    for p, b in work:
        eng.submit(p, max_new_tokens=b)
    done = sorted(eng.run(), key=lambda r: r.uid)
    return [r.output.tolist() for r in done], eng.stats


def one_rank_logits(cfg, params, prompts, max_len, mesh=None, comm=None):
    """{dtype: first_decode_logits} in bf16 and f32, as f32 on the CPU."""
    return {dtype: first_decode_logits(
        build_model(dataclasses.replace(cfg, compute_dtype=dtype)), params,
        prompts, max_len, mesh, comm).float().cpu()
        for dtype in ("bfloat16", "float32")}


def pool_check(device):
    """The (1, 2) line's pool check model, qwen2-0.5b at full width cut to
    MESH_SERVE_LAYERS layers, and its params from seed 0 on `device`."""
    full = get_config("qwen2-0.5b")
    cfg = dataclasses.replace(
        full, num_layers=MESH_SERVE_LAYERS,
        layer_types=full.layer_types[:MESH_SERVE_LAYERS])
    return cfg, build_model(cfg).init(
        torch.Generator(device=device).manual_seed(0))


def line_engine(cfg, params, work, max_len, mesh, paged):
    """`serve_f32` on the (1, mp) line `mesh`, the kernels' launches
    counted from zero: {"outputs", "launches", "paged", "layers" and the
    stats the launch rule and the fused gate read}."""
    reset_counts()
    outputs, st = serve_f32(cfg, params, work, max_len, mesh, paged)
    return {"outputs": outputs, "launches": counts(), "paged": paged,
            "layers": cfg.num_layers,
            **{k: st[k] for k in ("overlap_mode", "decode_steps",
                                  "mixed_steps", "admissions")}}


def family_config(arch):
    """A family's full-width config cut to its MESH_FAMILY_LAYERS layers
    (the encoder-decoder's encoder too)."""
    full = get_config(arch)
    n = MESH_FAMILY_LAYERS[arch]
    return dataclasses.replace(
        full, num_layers=n, layer_types=full.layer_types[:n],
        encoder_layers=min(full.encoder_layers, n))


def cast_leaves(params, dtype):
    """`params` with every float leaf in `dtype`, cast in place leaf by
    leaf (each old leaf freed as its cast takes its place), the cache
    emptied after, so no process holds two copies of the model."""
    for k, v in params.items():
        if v.is_floating_point():
            params[k] = v.to(dtype)
    torch.cuda.empty_cache()
    return params


def family_serve(cfg, params, work, max_len, mesh=None, comm=None):
    """A family served at both precisions from `params` (the whole
    model's or, on `mesh`, the rank's piece, in the config's bf16), cast
    in place: the first decode step's bf16 logits, then in f32 the
    workload's tokens through one engine (`line_engine`'s record, its
    launches counted) and the f32 logits. Returns (that record, {dtype:
    logits on the host})."""
    prompts = [p for p, _ in work]
    logits = {}
    for dtype in ("bfloat16", "float32"):
        cast_leaves(params, getattr(torch, dtype))
        if dtype == "float32":
            engine = line_engine(cfg, params, work, max_len, mesh, False)
        logits[dtype] = first_decode_logits(
            build_model(dataclasses.replace(cfg, compute_dtype=dtype)),
            params, prompts, max_len, mesh, comm).float().cpu()
    return engine, logits


def wave_steps(cfg, params, new_tokens, mesh=None, comm=None):
    """The raw loop's batch of WAVE_REQUESTS prompts (`launch.serve.
    raw_prompt`, seed 0: frames or patches with them) prefilled with a
    cache of prompt + prefix + `new_tokens` rows in the compute dtype and
    decoded greedily `new_tokens` steps: through the wave steps on `mesh`
    (`dist.serving.make_prefill_step` / `make_decode_step`, `params` the
    rank's piece or the whole model's), or through the whole model.
    Returns (the tokens [B][new_tokens + 1], the last step's logits of
    every row and the whole vocabulary)."""
    from repro_torch.dist import serving
    from repro_torch.dist.tensor_parallel import model_axis, serving_params
    from repro_torch.launch.mesh import Mesh

    model = build_model(cfg)
    # one process: the steps on a mesh of one rank are the model's own
    mesh = mesh or Mesh(("data", "model"), (1, 1), rank=0)
    batch, prefix = serve_cli.raw_prompt(cfg, WAVE_REQUESTS, WAVE_PROMPT,
                                         DEV)
    p = WAVE_PROMPT
    params = serving_params(cfg, params, mesh)
    prefill, rows = serving.make_prefill_step(model, mesh, comm,
                                              WAVE_REQUESTS, DEV)
    decode, _ = serving.make_decode_step(model, mesh, comm, WAVE_REQUESTS,
                                         DEV)
    ids, logits, caches = prefill(params, batch,
                                  cache_len=p + prefix + new_tokens,
                                  cache_dtype=getattr(torch,
                                                      cfg.compute_dtype))
    tokens = [ids]
    for i in range(new_tokens):
        ids, logits, caches = decode(params, ids[:, None], caches,
                                     p + prefix + i)
        tokens.append(ids)
    if logits.shape[-1] != cfg.vocab_size:
        logits = model_axis(mesh, comm).gather_vocab(logits)
    return torch.stack(tokens, 1).tolist(), rows.gather(logits)


def wave_serve(cfg, params, mesh=None, comm=None):
    """`family_serve` for the families the engine cannot take, through
    `wave_steps`: the first decode step's bf16 logits, then in f32 the
    tokens of WAVE_NEW steps (its launches counted) and the first decode
    step's f32 logits."""
    logits = {}
    for dtype in ("bfloat16", "float32"):
        cast_leaves(params, getattr(torch, dtype))
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        if dtype == "float32":
            reset_counts()
            tokens, _ = wave_steps(c, params, WAVE_NEW, mesh, comm)
            engine = {"outputs": tokens, "launches": counts(),
                      "prefills": 1, "decode_steps": WAVE_NEW,
                      "layers": cfg.num_layers}
        logits[dtype] = wave_steps(c, params, 1, mesh, comm)[1].float().cpu()
    return engine, logits


def family_line(arch, mesh, device, out):
    """`--serve-mesh-rank`'s family part on this rank's (1, mp) line
    `mesh`: the rank's piece of `family_config(arch)` drawn without the
    whole model (`tensor_parallel.init_shard`, seed 0, the config's
    parameter dtype), served by `family_serve` (`wave_serve` for
    WAVE_FAMILIES) on the line; its first rank writes the logits to
    OUT/family.<arch>.pt. Returns the rank's record (its engine, the
    seconds of its init and of its serving, its peak)."""
    from repro_torch.dist.collectives import Collectives
    from repro_torch.dist.tensor_parallel import init_shard

    cfg = family_config(arch)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = init_shard(cfg, torch.Generator(device=device).manual_seed(0),
                        mesh)
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    if arch in WAVE_FAMILIES:
        engine, logits = wave_serve(cfg, params, mesh,
                                    Collectives(mesh, device))
    else:
        work, max_len = mesh_f32_workload(cfg)
        engine, logits = family_serve(cfg, params, work, max_len, mesh,
                                      Collectives(mesh, device))
    if mesh.coords["model"] == 0:
        torch.save(logits, os.path.join(out, f"family.{arch}.pt"))
    del params
    torch.cuda.empty_cache()
    record = {"arch": arch, "engine": engine, "init_s": init_s,
              "serve_s": time.perf_counter() - t0 - init_s,
              "peak_GB": torch.cuda.max_memory_allocated(device) / 1e9,
              "peak_reserved_GB": torch.cuda.max_memory_reserved(device)
              / 1e9}
    print(json.dumps({"family_line": {k: v for k, v in record.items()
                                      if k != "engine"}}), flush=True)
    return record


def family_reference(arch, device, out):
    """One process's run of `family_line`'s family from the same init
    (`family_serve` on the whole model, cast to f32 in place after the
    bf16 logits); writes OUT/family_one.<arch>.pt ({"tokens", "logits",
    "launches"}) and returns its seconds and peak."""
    cfg = family_config(arch)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device=device).manual_seed(0))
    if arch in WAVE_FAMILIES:
        engine, logits = wave_serve(cfg, params)
    else:
        work, max_len = mesh_f32_workload(cfg)
        engine, logits = family_serve(cfg, params, work, max_len)
    torch.save({"tokens": engine["outputs"], "logits": logits,
                "launches": engine["launches"]},
               os.path.join(out, f"family_one.{arch}.pt"))
    del params
    torch.cuda.empty_cache()
    record = {"arch": arch, "s": time.perf_counter() - t0,
              "peak_GB": torch.cuda.max_memory_allocated(device) / 1e9}
    print(json.dumps({"family_one_process": record}), flush=True)
    return record


def serve_mesh_rank(rank, coordinator, backend, out, world, mp):
    """`--serve-mesh-rank`: one rank of phase 50's checks over `backend`,
    `world` ranks at model parallel `mp`, from the launches' init: first
    each data line as a ("data", "model") = (1, mp) mesh of its own (the
    mesh's "side" axis sets the lines side by side), the first line
    serving the f32 workload through `Engine(mesh=...)` on the arena, the
    last taking the first decode step's logits in bf16 and f32, then
    serving the workload on the pool at `pool_check`'s depth
    (`line_engine`: both run the fused mixed step that "auto" picks on
    one data line). Then the arena's
    tokens and the logits on the (world / mp, mp) serving mesh. Then each
    line serves its families of MESH_LINE_FAMILIES one after another
    (`family_line`), and once every rank has freed its pieces the first
    rank of each line takes one process's run of each
    (`family_reference`). Writes OUT/rank<R>.json (its tokens, its line's
    engine, its families' records, its device), and
    from the first rank of the last line and rank 0 the logits
    (OUT/logits_line.pt, OUT/logits.pt)."""
    import torch.distributed as dist

    from repro_torch.dist.collectives import Collectives
    from repro_torch.launch.mesh import (init_distributed, make_mesh,
                                         make_serving_mesh, rank_device)

    world, mp = int(world), int(mp)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = rank_device(DEV, rank)
    torch.cuda.set_device(device)
    init_distributed(rank, world, coordinator, backend, device,
                     timeout_s=300)
    cfg = get_config("qwen2-0.5b")
    params = build_model(cfg).init(
        torch.Generator(device=device).manual_seed(0))
    work, max_len = mesh_f32_workload(cfg)
    prompts = [p for p, _ in work]
    record = {"device": str(device)}
    lines = world // mp
    side = make_mesh(("side", "data", "model"), (lines, 1, mp))
    line = side.coords["side"]
    t0 = time.perf_counter()
    if line == 0:
        record["line"] = line_engine(cfg, params, work, max_len, side, False)
    if line == lines - 1:
        logits = one_rank_logits(cfg, params, prompts, max_len, side,
                                 Collectives(side, device))
        if side.coords["model"] == 0:
            torch.save(logits, os.path.join(out, "logits_line.pt"))
        record["line"] = line_engine(*pool_check(device), work, max_len,
                                     side, True)
    record["line_s"] = time.perf_counter() - t0
    mesh = make_serving_mesh(mp)
    t0 = time.perf_counter()
    record["outputs"], _ = serve_f32(cfg, params, work, max_len, mesh)
    logits = one_rank_logits(cfg, params, prompts, max_len, mesh,
                             Collectives(mesh, device))
    record["mesh_s"] = time.perf_counter() - t0
    record["mesh"] = mesh.shape
    if rank == 0:
        torch.save(logits, os.path.join(out, "logits.pt"))
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    archs = MESH_LINE_FAMILIES[line % len(MESH_LINE_FAMILIES)]
    record["families"] = {arch: family_line(arch, side, device, out)
                          for arch in archs}
    # every line's pieces are freed before one process's models are drawn
    dist.barrier()
    if side.coords["model"] == 0:
        record["family_one"] = {arch: family_reference(arch, device, out)
                                for arch in archs}
    record["family_s"] = time.perf_counter() - t0
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
    dist.barrier()
    dist.destroy_process_group()


def mesh_checks(backend):
    """Phase 50's checks: MESH_WORLD ranks of this script
    (`serve_mesh_rank`) over `backend` while this process takes the
    one-process f32 tokens (arena and pool) and logits from the same
    init (the pool at `pool_check`'s depth). Holds each (1, MESH_MP)
    line's engine, rank by rank: mixed
    steps of the fused step, a flash launch a layer an admission (arena)
    and a decode or paged launch a layer a decode step, and no other
    launch; the pool's tokens equal one process's pool's (the arena's
    are held in `mesh_logit_gates`). Returns ({"float32": one process's
    arena tokens, "one": its logits by dtype, "meshes": {label:
    {"tokens", "logits"}} for the (1, MESH_MP) lines and the (data,
    MESH_MP) mesh, "lines": each line's engine on each rank, tokens
    left out}, the ranks' seconds)."""
    cfg = get_config("qwen2-0.5b")

    def references():
        params = build_model(cfg).init(
            torch.Generator(device=DEV).manual_seed(0))
        work, max_len = mesh_f32_workload(cfg)
        want = {"float32": serve_f32(cfg, params, work, max_len)[0],
                "paged_float32": serve_f32(*pool_check(DEV), work, max_len,
                                           paged=True)[0],
                "one": one_rank_logits(cfg, params, [p for p, _ in work],
                                       max_len)}
        del params
        torch.cuda.empty_cache()
        return want

    world = MESH_WORLD
    got = []
    with tempfile.TemporaryDirectory(prefix="serve_mesh_checks_") as out:
        want, ranks_s = check_ranks(
            "--serve-mesh-rank", world, backend, out, 500, references,
            extra=(str(world), str(MESH_MP)))
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                got.append(json.load(f))
        line_logits = torch.load(os.path.join(out, "logits_line.pt"))
        mesh_logits = torch.load(os.path.join(out, "logits.pt"))
        families = family_checks(got, out)
    if any(g["outputs"] != got[0]["outputs"] for g in got):
        raise AssertionError("the check ranks' f32 tokens disagree")
    if not all(g["device"].startswith("cuda") for g in got):
        raise AssertionError(f"the check ranks ran on {got}")
    for r, g in enumerate(got):
        e = g["line"]
        if e["outputs"] != got[r // MESH_MP * MESH_MP]["line"]["outputs"]:
            raise AssertionError(f"rank {r}: its line's f32 tokens disagree")
        if e["paged"] and e["outputs"] != want["paged_float32"]:
            raise AssertionError("the (1, 2) line's f32 pool leaves the "
                                 "one-process f32 pool's tokens")
        if e["overlap_mode"] != "fused" or not e["mixed_steps"]:
            raise AssertionError(f"rank {r}: its line's engine ran no "
                                 f"fused mixed step: {e}")
        rule = dict.fromkeys(e["launches"], 0)
        if e["paged"]:
            rule["decode_attention_paged"] = e["layers"] * e["decode_steps"]
        else:
            rule["flash_attention"] = e["layers"] * e["admissions"]
            rule["decode_attention"] = e["layers"] * e["decode_steps"]
        if e["launches"] != rule:
            raise AssertionError(f"rank {r}: its line's engine launched "
                                 f"{e['launches']}, the rule {rule}")
    want["lines"] = [{k: v for k, v in g["line"].items() if k != "outputs"}
                     for g in got]
    want["families"] = families
    want["meshes"] = {
        mesh_label({"data": 1, "model": MESH_MP}): {
            "tokens": got[0]["line"]["outputs"], "logits": line_logits},
        mesh_label(got[0]["mesh"]): {"tokens": got[0]["outputs"],
                                     "logits": mesh_logits}}
    want["rank_s"] = [{k: g[k] for k in ("line_s", "mesh_s", "family_s")}
                      for g in got]
    return want, ranks_s


def family_launch_rule(arch, e):
    """The launches of a family's f32 run `e` on a check line or in one
    process (its kernels' counts, its admissions and decode steps, or its
    wave prefill and steps): a flash launch an attention layer an
    admission and a decode launch one a step (none where the attention is
    MLA), a WKV or RG-LRU launch a recurrent layer an admission and a
    step; for the wave families a flash launch an encoder layer and two a
    decoder layer (self- and cross-attention) a prefill and two decode
    launches a decoder layer a step, or one each a layer of the VLM."""
    cfg = family_config(arch)
    rule = dict.fromkeys(e["launches"], 0)
    if arch in WAVE_FAMILIES:
        per = 2 if cfg.encoder_layers else 1
        rule["flash_attention"] = e["prefills"] * (
            cfg.encoder_layers + per * cfg.num_layers)
        rule["decode_attention"] = e["decode_steps"] * per * cfg.num_layers
        return rule
    kinds = cfg.layer_types
    attn = 0 if cfg.mla is not None else sum(k in ("attn", "moe")
                                             for k in kinds)
    rule["flash_attention"] = attn * e["admissions"]
    rule["decode_attention"] = attn * e["decode_steps"]
    steps = e["admissions"] + e["decode_steps"]
    rule["rwkv6_scan"] = kinds.count("rwkv") * steps
    rule["rglru_scan"] = kinds.count("rglru") * steps
    return rule


def family_checks(got, out):
    """Phase 50's family gates, each family of MESH_LINE_FAMILIES on its
    (1, MESH_MP) check line (`family_line`) against one process's run
    (`family_reference`, in OUT): the line's f32 tokens equal on its
    ranks and to one process's, the logit gates of `mesh_logit_gates`
    (the families this slice added at NEW_FAMILY_F32_GAP and
    NEW_FAMILY_BF16_FACTOR), and on every rank of the line, as in one
    process, the launches of `family_launch_rule` and no other. Returns
    {arch: its line, its gaps, its engine, each rank's seconds and peak
    and one process's}."""
    checked = {}
    for line, archs in enumerate(MESH_LINE_FAMILIES):
        ranks = got[line * MESH_MP:(line + 1) * MESH_MP]
        for arch in archs:
            recs = [g["families"][arch] for g in ranks]
            one = torch.load(os.path.join(out, f"family_one.{arch}.pt"))
            logits = torch.load(os.path.join(out, f"family.{arch}.pt"))
            cfg = family_config(arch)
            engine = recs[0]["engine"]
            for r, rec in enumerate(recs):
                e = rec["engine"]
                if e["outputs"] != engine["outputs"]:
                    raise AssertionError(f"{arch}: its line's ranks' f32 "
                                         "tokens disagree")
                rule = family_launch_rule(arch, e)
                if e["launches"] != rule or one["launches"] != rule:
                    raise AssertionError(
                        f"{arch} rank {r}: its line's engine launched "
                        f"{e['launches']}, one process {one['launches']}, "
                        f"the rule {rule}")
            label = f"{mesh_label({'data': 1, 'model': MESH_MP})} {arch}"
            new = arch not in ("dbrx-132b", "deepseek-v2-236b")
            gaps = mesh_logit_gates({
                "one": one["logits"], "float32": one["tokens"],
                "meshes": {label: {"tokens": engine["outputs"],
                                   "logits": logits}}},
                **(dict(f32_gap=NEW_FAMILY_F32_GAP,
                        bf16_factor=NEW_FAMILY_BF16_FACTOR) if new else {}))
            checked[arch] = {
                "line": line, "layers": cfg.num_layers,
                "logit_gap_of_max": gaps[label],
                "f32_tokens_equal_one_process": True,
                "engine": {k: v for k, v in engine.items()
                           if k != "outputs"},
                "one_process_launches": one["launches"],
                "tokens": engine["outputs"],
                "ranks": [{k: rec[k] for k in ("init_s", "serve_s",
                                               "peak_GB",
                                               "peak_reserved_GB")}
                          for rec in recs],
                "one_process": ranks[0]["family_one"][arch]}
    return checked


def mesh_logit_gates(checks, f32_gap=F32_LOGIT_GAP, bf16_factor=1.0):
    """Each checked mesh's first-decode logit gaps ({mesh: gaps}), held:
    its f32 tokens equal one process's, its f32 logits within `f32_gap`
    of the largest |logit| of one process's, and its bf16 logits no
    farther from one process's f32 logits than `bf16_factor` times one
    process's own bf16 logits are (the gap to one process's bf16 logits
    is printed, not gated)."""
    def gap(got, want):
        return float((got - want).abs().max() / want.abs().max())

    one = checks["one"]
    bf16_error = gap(one["bfloat16"], one["float32"])
    out = {}
    for label, got in checks["meshes"].items():
        logits = got["logits"]
        gaps = out[label] = {
            "bfloat16": gap(logits["bfloat16"], one["bfloat16"]),
            "float32": gap(logits["float32"], one["float32"]),
            "one_process_bf16_vs_f32": bf16_error,
            "mesh_bf16_vs_one_process_f32": gap(logits["bfloat16"],
                                                one["float32"])}
        if not gaps["float32"] <= f32_gap:
            raise AssertionError(
                f"{label}: the mesh's f32 logits are {gaps['float32']} of "
                f"the largest |logit| from one process's (> {f32_gap})")
        if not gaps["mesh_bf16_vs_one_process_f32"] <= (bf16_factor
                                                        * bf16_error):
            raise AssertionError(
                f"{label}: the mesh's bf16 logits are "
                f"{gaps['mesh_bf16_vs_one_process_f32']} of the largest "
                f"|logit| from one process's f32 logits, beyond "
                f"{bf16_factor} x one process's own bf16 gap {bf16_error}")
        if got["tokens"] != checks["float32"]:
            raise AssertionError(f"{label}: the mesh's f32 tokens leave the "
                                 f"one-process f32 engine's")
    print(json.dumps({"mesh_logit_gaps": out}), flush=True)
    return out


def mesh_launch_rows(records, cfg, args):
    """Every rank's row of the launch's `records`, held: the ranks'
    digests equal in every arm and overlapped equal to serialized (in the
    overlap mode "auto" picks on a data axis, "async"), on the (MESH_WORLD
    / MESH_MP, MESH_MP) mesh, bytes equal to `serve_step_sends`, a flash
    launch a layer an admission its data line prefilled (arena) and a
    decode or paged launch a layer a decode step, every rank on the card.
    Returns (rows, {arm: digest}, {arm: rank 0's launches})."""
    from repro_torch.dist.serving import serve_step_sends
    from repro_torch.serve import bucket_length

    digests, rows, launches = {}, [], {}
    unit = bucket_length(args.prompt_len, 8)
    mesh = {"data": MESH_WORLD // MESH_MP, "model": MESH_MP}
    for arm in MESH_SERVE_ARMS:
        recs = [records[arm, p] for p in range(MESH_WORLD)]
        digests[arm] = {r["digest"] for r in recs}
        if len(digests[arm]) != 1 or any(r["outputs"] != recs[0]["outputs"]
                                         for r in recs):
            raise AssertionError(f"{arm}: the ranks disagree: "
                                 f"{[r['digest'] for r in recs]}")
        for r in recs:
            st = r["engine_stats"]
            mode = "" if arm.endswith("-serialized") else "async"
            if r["mesh"] != mesh or r["overlap_mode"] != mode:
                raise AssertionError(f"{arm} rank {r['process']}: mesh "
                                     f"{r['mesh']}, overlap mode "
                                     f"{r['overlap_mode']!r} ({mode!r})")
            if r["sent"] != r["sent_reckoned"] or not r["sent"]:
                raise AssertionError(f"{arm} rank {r['process']} sent "
                                     f"{r['sent']}, serve_step_sends "
                                     f"reckons {r['sent_reckoned']}")
            got = r["launches"]
            per_step = MESH_SERVE_LAYERS * st["decode_steps"]
            want = {"flash_attention": 0, "decode_attention": 0,
                    "decode_attention_paged": 0, "decode_attention_ring": 0,
                    "rwkv6_scan": 0, "rglru_scan": 0}
            if r["backend"] == "paged":
                want["decode_attention_paged"] = per_step
            else:
                want["flash_attention"] = (MESH_SERVE_LAYERS
                                           * st["line_admissions"])
                want["decode_attention"] = per_step
            if got != want:
                raise AssertionError(f"{arm} rank {r['process']}: launches "
                                     f"{got}, one process's rule {want}")
            if not r["device"].startswith("cuda"):
                raise AssertionError(f"{arm} ran on {r['device']}")
            decode_bytes = serve_step_sends(
                cfg, r["mesh"], args.max_batch, unit)[r["process"]]["decode"]
            rows.append({
                "mesh": mesh_label(r["mesh"]), "arm": arm,
                "rank": r["process"], "data_line": r["data_index"],
                "overlap_mode": r["overlap_mode"], "digest": r["digest"],
                "decode_step_ms": r["derived"]["decode_step_ms"],
                "admission_ms": r["derived"]["admission_ms_per_admission"],
                "tokens_per_s": r["derived"]["throughput_tok_s"],
                "axis_ms_per_decode_step": r["axis_ms_per_decode_step"],
                "axis_ms_per_decode_step_by_axis": {
                    a: ms / max(st["decode_steps"], 1)
                    for a, ms in r["axis_ms_by_axis"].items()},
                "axis_ms": r["axis_ms"], "calls": r["calls"],
                "bytes_per_decode_step": decode_bytes,
                "sent": r["sent"], "peak_GB": r["peak_bytes"] / 1e9,
                "decode_steps": st["decode_steps"],
                "admissions": st["admissions"],
                "line_admissions": st["line_admissions"],
                "mixed_steps": st["mixed_steps"], "launches": got,
                "setup_s": r["setup_s"], "wall_s": r["wall_s"]})
        launches[arm] = records[arm, 0]["launches"]
    for overlapped in ("arena", "paged"):
        if digests[overlapped] != digests[f"{overlapped}-serialized"]:
            raise AssertionError(f"{overlapped}: overlapped "
                                 f"{digests[overlapped]} != serialized "
                                 f"{digests[overlapped + '-serialized']}")
    return rows, {a: sorted(d)[0] for a, d in digests.items()}, launches


def mesh_serving(smi, gen, backend="gloo", kernels=True):
    """Phase 50 (see the module's docstring) over `backend` (its kernel
    cases where `kernels`). Returns (the kernel cases, {(mesh, path): its
    launches}: rank 0's of each of the launch's arms and the (1, MESH_MP)
    check line's pool's, {arm: the launch's digest})."""
    from repro_torch.launch import serve_mesh

    t0 = time.perf_counter()
    cases = mesh_kernel_cases(gen) if kernels else None
    checks, checks_s = mesh_checks(backend)
    gaps = mesh_logit_gates(checks)
    args = serve_mesh._build_parser().parse_args(
        MESH_SERVE_ARGS + ["--layers", str(MESH_SERVE_LAYERS)])
    cfg = serve_mesh._config(args)
    records, launch_s = serve_mesh_launch(backend, MESH_SERVE_ARMS)
    label = mesh_label({"data": MESH_WORLD // MESH_MP, "model": MESH_MP})
    rows, digests, got = mesh_launch_rows(records, cfg, args)
    launches = {("qwen2", label, f"rank 0, {arm}"): got[arm]
                for arm in MESH_SERVE_ARMS}
    line = mesh_label({"data": 1, "model": MESH_MP})
    for r in (0, MESH_WORLD - 1):
        e = checks["lines"][r]
        launches["qwen2", line, f"check rank {r}, f32 "
                 f"{'pool' if e['paged'] else 'arena'} (fused), "
                 f"{e['layers']} layers"] = e["launches"]
    for arch, fam in checks["families"].items():
        path = ("wave steps" if arch in WAVE_FAMILIES
                else "arena (serialized)")
        launches[arch, line, f"check rank {fam['line'] * MESH_MP}, f32 "
                 f"{path}, {fam['layers']} layers"] = fam["engine"][
                     "launches"]
        digests[f"{arch} {line} f32 tokens"] = fam["tokens"]
    arena, paged = (records[a, 0]["outputs"] for a in ("arena", "paged"))
    out = {"card": smi, "backend": backend,
           "note": ("every rank shared one card over gloo (host buffers); "
                    "times measure this transport, not NVLink"
                    if backend == "gloo" else "one GPU a rank over NCCL"),
           "mesh": label, "launch_s": launch_s, "checks_s": checks_s,
           "check_rank_s": checks["rank_s"],
           "logit_gap_of_max": gaps,
           "f32_tokens_equal_one_process": True,
           "line_pool_f32_tokens_equal_one_process": True,
           "lines": checks["lines"],
           "families": {arch: {k: v for k, v in fam.items() if k != "tokens"}
                        for arch, fam in checks["families"].items()},
           "overlapped_equals_serialized": True,
           # not gated: the pool's chunk prefill is plain PyTorch, the
           # arena's flash, so a bf16 token may differ, as in phase 11
           "paged_requests_equal_to_arena": sum(
               a == b for a, b in zip(arena, paged)),
           "digests": digests, "ranks": rows,
           "phase50_s": time.perf_counter() - t0}
    print(json.dumps({"mesh_serving": out}), flush=True)
    family_s = {arch: [round(max(r["init_s"] + r["serve_s"]
                                 for r in f["ranks"]), 2),
                       round(f["one_process"]["s"], 2)]
                for arch, f in checks["families"].items()}
    print(f"phase 50: {out['phase50_s']:.1f} s (check ranks {checks_s:.1f} "
          f"s, of which each family's line and one process's run "
          f"{family_s} s; launch {label} {launch_s:.1f} s)", flush=True)
    return cases, launches, digests


def main():
    phase("1 card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)

    phase("2 build")
    for name in build.KERNELS:
        build.library_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    logs = build.build(*build.KERNELS)
    print(f"build_s {time.perf_counter() - t0:.3f}")
    for name in build.KERNELS:
        print(f"  [{name}]")
        for line in logs[name].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  " + line.strip())
    ptx = ptxas_report(logs)
    print(json.dumps({"hd96_ptxas": [
        r for r in ptx if r["library"] in ATTENTION_LIBRARIES
        and re.search(r"\b96\b", r["kernel"])]}), flush=True)

    phase("3 kernels against their plain versions")
    gen = torch.Generator(device=DEV).manual_seed(0)
    cases = [check_prox_case(label, shape, dtype, gen) for label, shape, dtype
             in (("embed.table", (4, 151936, 896), torch.float32),
                 ("mlp.w_gate", (4, 24, 896, 4864), torch.float32),
                 ("mlp.w_gate bf16 x", (4, 24, 896, 4864), torch.bfloat16))]
    torch.cuda.empty_cache()
    flash_cases = [check_flash_case("serving prefill Sp=256", 256, gen),
                   check_flash_case("long prompt S=2048", 2048, gen),
                   check_flash_case("S=17 (cuts a 16-row fragment)", 17, gen),
                   check_flash_case("S=65, window 40 (edges mid-tile)", 65,
                                    gen, window=40)]
    decode_cases = [check_decode_case("serving decode B=8 T=512", 8, 512, gen),
                    check_decode_case("B=64 T=4096", 64, 4096, gen),
                    check_decode_case("chunk edges B=8 T=700", 8, 700, gen,
                                      edges=True)]
    torch.cuda.empty_cache()

    phase("4 main path: repro_torch.launch.train, full qwen2-0.5b")
    argv = main_args(STEPS, log_every=1)
    print(" ".join(argv))
    reset_counts()
    out = train_cli.train(train_cli.parse_args(argv))
    launches = prox_update_cuda.launches
    print(json.dumps({"main_path": {**out, "launches": counts(),
                                    "peak_GB": out["peak_bytes"] / 1e9}}),
          flush=True)
    if not np.all(np.isfinite(out["losses"])):
        raise AssertionError(f"non-finite losses {out['losses']}")
    if launches != LEAVES * STEPS:
        raise AssertionError(f"prox_update launched {launches} times in "
                             f"{STEPS} supersteps, expected {LEAVES * STEPS}")
    torch.cuda.empty_cache()

    phase("5 reference: card against CPU at smoke size")
    reference_check()

    phase("6 profile")
    profile_supersteps()
    torch.cuda.empty_cache()

    phase("7 serving main path: repro_torch.launch.serve, full qwen2-0.5b")
    _, serve_launches, arena_out = serve_main_path()
    arena_outputs = arena_out["outputs"]
    torch.cuda.empty_cache()

    phase("8 serving reference: card against CPU at smoke size")
    serving_reference_check()

    phase("9 serving profile")
    profile_decode_steps()
    torch.cuda.empty_cache()
    profile_decode_steps(paged=True)
    torch.cuda.empty_cache()

    phase("10 paged kernels against their plain versions")
    paged_cases = [
        check_paged_case("paged serving decode B=8 <=512 tokens bs=16",
                         8, 512, 16, dtype, gen)
        for dtype in (torch.bfloat16, torch.float32)]
    paged_cases += [
        check_paged_case("paged B=64 <=4096 tokens bs=16", 64, 4096, 16,
                         dtype, gen)
        for dtype in (torch.bfloat16, torch.float32)]
    ring_cases = [
        check_ring_case(f"ring window {RING_WINDOW} B=8 bs=16 (lengths "
                        f"1..{3 * RING_WINDOW})", 8, RING_WINDOW, 16, dtype,
                        gen)
        for dtype in (torch.bfloat16, torch.float32)]
    check_identity_table(gen)
    print(json.dumps({"paged_fwd_ptxas": [
        r for r in ptx if r["library"] == "decode_attention_paged"]}),
        flush=True)
    torch.cuda.empty_cache()

    phase("11 paged serving main path: repro_torch.launch.serve --paged")
    _, paged_launches, paged_outs = paged_serve_main_path(arena_outputs)
    torch.cuda.empty_cache()

    phase("12 ring-paged serving: window 256, full qwen2-0.5b")
    ring_summary, ring_launches, ring_outputs = ring_serving()
    torch.cuda.empty_cache()

    phase("13 paged reference: card against CPU at smoke size")
    paged_reference_check()

    phase("14 WKV kernel against its plain version")
    if not build.library_path("rwkv6_scan").is_file():
        raise AssertionError("phase 2 did not build rwkv6_scan")
    print(json.dumps({"wkv_fwd_ptxas": [
        r for r in ptx if r["library"] == "rwkv6_scan"],
        "chunk": wkv.CHUNK, "chunked_min_steps": wkv.CHUNKED_MIN_STEPS}),
        flush=True)
    rwkv_cases = []
    below = wkv.CHUNKED_MIN_STEPS - 1
    for dtype in (torch.bfloat16, torch.float32):
        rwkv_cases += [
            check_rwkv_case("rwkv prefill B=1 S=200", 1, 200, dtype, gen),
            check_rwkv_case("rwkv decode B=8 S=1", 8, 1, dtype, gen),
            check_rwkv_case("rwkv long prompt B=1 S=4096, 8 pieces", 1,
                            4096, dtype, gen, pieces=8),
            check_rwkv_case("rwkv chunk boundary B=2 S=128", 2, 128, dtype,
                            gen),
            check_rwkv_case(f"rwkv below the threshold B=2 S={below}", 2,
                            below, dtype, gen),
            check_rwkv_case(f"rwkv at the threshold B=2 S={below + 1}", 2,
                            below + 1, dtype, gen),
            check_rwkv_case("rwkv hd 32 B=2 S=200", 2, 200, dtype, gen,
                            hd=32)]
        rwkv_cases += [
            check_rwkv_case(f"rwkv strong decays w0={w0:+.0f} B=1 S=200", 1,
                            200, dtype, gen, w0=w0)
            for w0 in (0.0, 1.0, 2.0)]
        torch.cuda.empty_cache()

    phase("15 RWKV6 serving main path: repro_torch.launch.serve, full "
          "rwkv6-1.6b")
    _, rwkv_launches = rwkv_serve_main_path()
    torch.cuda.empty_cache()

    phase("16 RWKV6 reference: card against CPU at smoke size")
    rwkv_reference_check()

    phase("17 RWKV6 serving profile")
    # the phase 15 path's admissions and steps, profiled: wrapper calls
    # beside the device launches they made
    prompt_len = serve_cli.parse_args(RWKV_SERVE_ARGS).prompt_len
    assert_recurrent_launches(
        "the RWKV6 serving profile",
        profile_decode_steps(argv=RWKV_SERVE_ARGS), "rwkv6_scan",
        (N_LAYERS, N_LAYERS * wkv_launches_per_call(prompt_len)),
        (N_LAYERS, N_LAYERS * wkv_launches_per_call(1)))
    torch.cuda.empty_cache()

    phase("18 RG-LRU kernel and attention at head_dim 256 against their "
          "plain versions")
    print(json.dumps({"rglru_fwd_ptxas": [
        r for r in ptx if r["library"] == "rglru_scan"]}), flush=True)
    rglru_cases = []
    for dtype in (torch.bfloat16, torch.float32):
        rglru_cases += [
            check_rglru_case("rglru prefill B=1 S=200 W=2560", 1, 200,
                             dtype, gen),
            check_rglru_case("rglru decode B=8 S=1 W=2560", 8, 1, dtype,
                             gen),
            check_rglru_case("rglru long prompt B=1 S=4096 W=2560, 8 pieces",
                             1, 4096, dtype, gen, pieces=8)]
        torch.cuda.empty_cache()
    rg_attn = dict(h=10, kv=1, hd=256)
    flash_cases += [
        check_flash_case("hybrid prefill S=200, 10:1 heads of 256, window "
                         f"{RG_WINDOW}", 200, gen, window=RG_WINDOW,
                         **rg_attn),
        check_flash_case(f"hybrid long prompt S={LONG_PROMPT}, window "
                         f"{RG_WINDOW} (binds)", LONG_PROMPT, gen,
                         window=RG_WINDOW, **rg_attn)]
    torch.cuda.empty_cache()
    flash_cases.append(check_flash_case(
        "hybrid S=17, 10:1 heads of 256", 17, gen, **rg_attn))
    decode_cases += [
        check_decode_case("hybrid decode B=8 ring 512, 10:1 heads of 256",
                          8, 512, gen, **rg_attn),
        check_decode_case(f"hybrid decode B=8 full ring {RG_WINDOW}", 8,
                          RG_WINDOW, gen, full=True, **rg_attn),
        check_decode_case("hybrid chunk edges B=8 T=2100", 8, 2100, gen,
                          edges=True, **rg_attn)]
    torch.cuda.empty_cache()

    phase("19 hybrid serving main path: repro_torch.launch.serve, full "
          "recurrentgemma-2b")
    _, rg_launches = hybrid_serve_main_path()
    torch.cuda.empty_cache()

    phase("20 hybrid reference: card against CPU")
    hybrid_reference_check()
    torch.cuda.empty_cache()

    phase("21 hybrid serving profile")
    # one device launch a wrapper call: the gates and the scan in one
    # kernel
    assert_recurrent_launches(
        "the hybrid serving profile",
        profile_decode_steps(argv=RG_SERVE_ARGS), "rglru_scan",
        (RG_LAYERS, RG_LAYERS), (RG_LAYERS, RG_LAYERS))
    torch.cuda.empty_cache()

    phase("22 the serialized scheduler on phases 7, 11 and 12's workloads")
    schedulers, ser_launches = serialized_arms(arena_out, paged_outs)
    schedulers["ring"], ser_ring_launches = ring_arms(ring_summary,
                                                      ring_outputs)
    print(json.dumps({"schedulers": schedulers}), flush=True)
    del arena_out, paged_outs
    torch.cuda.empty_cache()

    phase("23 mixed steps: card against CPU at smoke size")
    mixed_reference_check()

    phase("24 mixed-step profile: full qwen2-0.5b")
    profile_mixed_steps()
    torch.cuda.empty_cache()

    phase("25 attention kernels at head_dim 128 (internlm2-1.8b, qwen3-8b, "
          "nemotron-4-15b) against their plain versions")
    dense_flash, dense_decode, dense_paged = dense_kernel_cases(gen)
    flash_cases += dense_flash
    decode_cases += dense_decode
    paged_cases += dense_paged
    print(json.dumps({"hd128_ptxas": [
        r for r in ptx if "128" in r["kernel"]
        and r["library"] != "rwkv6_scan"]}), flush=True)

    phase("26 row stability of the mixed step's shared ops: every dense "
          "config, every prompt bucket, B = 1, 4, 8")
    dense_row_stability(gen)

    phase("27 dense serving main paths: repro_torch.launch.serve, full "
          "internlm2-1.8b, qwen3-8b (also --paged) and nemotron-4-15b at "
          "full width, the last two cut to 4 layers")
    dense_launches = {}
    for arch, paged in [(a, False) for a in DENSE_ARCHS] + [("qwen3-8b",
                                                              True)]:
        dense_launches[arch, paged] = dense_serving(
            arch, paged, layers=DENSE_CUT_LAYERS.get(arch, 0))

    phase("28 dense reference: card against CPU at smoke size")
    for arch in DENSE_ARCHS:
        serving_reference_check(arch)
        mixed_reference_check(arch)

    phase("29 dense training: internlm2-1.8b full width, 2 layers; "
          "nemotron smoke with bf16 parameters")
    dense_training()
    torch.cuda.empty_cache()

    phase("30 DP baseline main path: repro_torch.launch.train --baseline, "
          "full qwen2-0.5b; card against CPU at smoke size")
    dp_baseline()
    torch.cuda.empty_cache()

    phase(f"31 long-sequence superstep: full qwen2-0.5b, S = {LONG_SEQ}, "
          "remat; peaks at S = 1024 with remat and without")
    long_run = long_sequence_training()

    phase(f"32 windowed training past one chunk (S = {WINDOWED_SEQ}): card "
          "against CPU at smoke size")
    windowed_state = windowed_reference_check()

    phase("33 checkpoints on the card")
    checkpoint_on_card(windowed_state)
    del windowed_state
    torch.cuda.empty_cache()

    phase("34 backward kernels (WKV, RG-LRU) against their plain versions")
    print(json.dumps({"bwd_ptxas": [
        r for r in ptx if r["library"] == "rwkv6_scan_bwd"
        or "bwd" in r["kernel"]]}), flush=True)
    wkv_bwd_cases, rg_bwd_cases = backward_kernel_cases(gen)

    phase(f"35 rwkv6-1.6b training: full width, {RWKV_TRAIN_LAYERS} "
          "layers, A=4, M=2")
    rwkv_train = recurrent_training("rwkv6-1.6b", RWKV_TRAIN_LAYERS, 4, 2)

    phase(f"36 recurrentgemma-2b training: full width, {RG_TRAIN_LAYERS} "
          "layers, A=2, M=1")
    rg_train = recurrent_training("recurrentgemma-2b", RG_TRAIN_LAYERS, 2, 1)

    phase("37 recurrent training on the card through the CLI, and card "
          "against CPU at smoke size")
    for arch in ("rwkv6-1.6b", "recurrentgemma-2b"):
        training_reference_check(arch)

    phase("38 MoE reference (dbrx-132b): card against CPU at smoke size, "
          "serving and training")
    moe_train = moe_reference_check()
    torch.cuda.empty_cache()

    phase(f"39 dbrx-132b serving: full width, {MOE_LAYERS} layers, through "
          "repro_torch.launch.serve; flash at 48:8 heads of 128")
    moe_launches, _ = moe_serving(gen)
    torch.cuda.empty_cache()
    flash_cases.append(check_flash_case(
        "dbrx-132b 48:8 heads of 128, exact-length prefill S=200", 200, gen,
        h=48, kv=8, hd=128))
    torch.cuda.empty_cache()

    phase("40 MLA reference (deepseek-v2-236b, a dense MLA stack): card "
          "against CPU at smoke size, serving and training")
    mla_train = mla_reference_check()
    torch.cuda.empty_cache()

    phase(f"41 MLA at full width: deepseek-v2-236b, {MLA_LAYERS} layers, "
          "through repro_torch.launch.serve; the dense MLA stack on the "
          "arena and the pool, its row stability, its superstep")
    mla_full = mla_full_width(gen)
    torch.cuda.empty_cache()

    phase("42 attention kernels at whisper-small's and phi-3-vision's "
          "shapes: non-causal flash, head_dim 96")
    new_flash, new_decode, new_paged, new_ring = new_shape_kernel_cases(gen)
    flash_cases += new_flash
    decode_cases += new_decode
    paged_cases += new_paged
    ring_cases += new_ring

    phase("43 whisper reference: card against CPU at smoke size, serving "
          "and training")
    whisper_reference_check()
    torch.cuda.empty_cache()

    phase("44 whisper-small at full width and depth: launch.serve's raw "
          "loop, 3 supersteps")
    (_, whisper_launches), whisper_train = whisper_full()

    phase(f"45 phi-3-vision-4.2b: smoke at hd 96 card against CPU; full "
          f"depth through the raw loop; {PHI3_ENGINE_LAYERS} layers through "
          "the engine, row stability; a superstep")
    phi3 = phi3_full(gen)
    torch.cuda.empty_cache()

    phase("46 the convex reference in float64: Figs. 3-6 card against CPU, "
          "through the simulator, profiled")
    convex_reference()

    phase("47 the async trainer: the threaded runtime card against CPU; "
          "launch.train_async with 4 processes on the card, 4 arms, "
          "async+mid over tcp and file; a logistic run")
    async_runtime()

    phase("48 cost accounting: four steps counted on the card against the "
          "dry run's fake count, timed beside their roofline bounds; the "
          "two LM examples")
    cost_accounting(smi)

    phase("49 the superstep across processes: launch.train --processes 4 "
          "at full qwen2-0.5b width, R=1 (A=4, M=2) and R=2 (A=2, M=1) "
          f"at {MESH_LAYERS['R1']} layers, digests against the one-process "
          "step; TP (A=2, M=1, --model-parallel 2) at full depth, lockstep, "
          "bytes, f32 and bf16 against one process")
    mesh_cases, mesh_arms = mesh_training(smi, gen)
    cases += mesh_cases

    phase("50 serving across processes, the data axis too, and every family "
          "on the model axis: f32 tokens and first-decode logits on 4 check "
          "ranks, (1, 2) on each data line side by side (the arena and the "
          "pool through the fused mixed step), then (2, 2), against one "
          "process; then at full width on the (1, 2) check lines, against "
          "one process: dbrx-132b, recurrentgemma-2b and whisper-small on "
          "one, deepseek-v2-236b, rwkv6-1.6b and phi-3-vision-4.2b on the "
          f"other ({MESH_FAMILY_LAYERS} layers; experts, MLA heads, RWKV "
          "heads and RG-LRU channels split, the one MQA kv head whole; "
          "whisper and phi-3 through the wave steps); then "
          "launch.serve_mesh --processes 4 --model-parallel 2 on (2, 2) at "
          "full qwen2-0.5b width, arena and pool, overlapped (async) and "
          "serialized")
    tp_cases, tp_launches, _ = mesh_serving(smi, gen)
    for got, more in zip((flash_cases, decode_cases, paged_cases, ring_cases,
                          rwkv_cases, rglru_cases), tp_cases):
        got += more

    def tp_paths(kernel):
        """{path: launches} of `kernel` in phase 50's paths."""
        return {f"{model} mesh {mesh} {path}": got[kernel]
                for (model, mesh, path), got in tp_launches.items()
                if got[kernel]}

    def dense_paths(kernel, paged=False):
        """{path: launches} of phase 27's runs of `kernel`."""
        out = {}
        for (arch, pg), runs in dense_launches.items():
            if pg == paged:
                cut = DENSE_CUT_LAYERS.get(arch)
                name = f"{arch} {cut} layers" if cut else arch
                for sched, got in zip(("overlapped", "serialized"), runs):
                    out[f"{name} {'paged' if paged else 'arena'}, "
                        f"{sched}"] = got[kernel]
        return out

    def phi3_paths(kernel, paged=False):
        """{path: launches} of phase 45's engine runs of `kernel`."""
        return {f"phi-3 {PHI3_ENGINE_LAYERS} layers "
                f"{'paged' if paged else 'arena'}, {sched}": got[kernel]
                for sched, got in zip(("overlapped", "serialized"),
                                      phi3["engine"][paged])}

    # top level: each kernel's main-path case for the times (the largest
    # leaf's f32 case for prox_update), the worst case for the error
    print(json.dumps({"kernels": [
        kernel_entry("prox_update",
                     "src/repro_torch/kernels/csrc/prox_update.cu",
                     "src/repro/kernels/prox_update.py:35",
                     {"qwen2 training": launches,
                      f"qwen2 training S={LONG_SEQ}":
                          long_run[f"S{LONG_SEQ}_remat"]["launches"][
                              "prox_update"],
                      "rwkv6 training": rwkv_train["launches"][
                          "prox_update"],
                      "recurrentgemma training": rg_train["launches"][
                          "prox_update"],
                      "dbrx smoke training": moe_train[
                          "superstep_card_vs_cpu"]["launches"][
                          "prox_update"],
                      "deepseek smoke training": mla_train[
                          "superstep_card_vs_cpu"]["launches"][
                          "prox_update"],
                      "dense MLA training": mla_full["training"][
                          "launches"]["prox_update"],
                      "whisper-small training": whisper_train["launches"][
                          "prox_update"],
                      "phi-3 training, 2 layers": phi3["training"][
                          "launches"]["prox_update"],
                      "qwen2 mesh R=1, 4 processes": mesh_arms["R1"][
                          "prox_update_launches"],
                      "qwen2 mesh R=2, 4 processes": mesh_arms["R2"][
                          "prox_update_launches"],
                      "qwen2 mesh TP (A=2, mp=2), 4 processes": mesh_arms[
                          "TP"]["prox_update_launches"]},
                     cases, cases[1]),
        kernel_entry("flash_attention",
                     "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:78",
                     {"qwen2 arena, overlapped":
                          serve_launches["flash_attention"],
                      "qwen2 arena, serialized":
                          ser_launches["arena"]["flash_attention"],
                      "recurrentgemma arena":
                          rg_launches["flash_attention"],
                      **dense_paths("flash_attention"),
                      "dbrx arena": moe_launches["flash_attention"],
                      "whisper-small raw loop":
                          whisper_launches["flash_attention"],
                      "phi-3 raw loop": phi3["raw_launches"][
                          "flash_attention"],
                      **phi3_paths("flash_attention"),
                      **tp_paths("flash_attention")},
                     flash_cases, flash_cases[0]),
        kernel_entry("decode_attention",
                     "src/repro_torch/kernels/csrc/decode_attention.cu",
                     "src/repro/kernels/decode_attention.py:89",
                     {"qwen2 arena, overlapped":
                          serve_launches["decode_attention"],
                      "qwen2 arena, serialized":
                          ser_launches["arena"]["decode_attention"],
                      "recurrentgemma arena":
                          rg_launches["decode_attention"],
                      **dense_paths("decode_attention"),
                      "dbrx arena": moe_launches["decode_attention"],
                      "whisper-small raw loop":
                          whisper_launches["decode_attention"],
                      "phi-3 raw loop": phi3["raw_launches"][
                          "decode_attention"],
                      **phi3_paths("decode_attention"),
                      **tp_paths("decode_attention")},
                     decode_cases, decode_cases[0]),
        kernel_entry("decode_attention_paged",
                     "src/repro_torch/kernels/csrc/decode_attention_paged.cu",
                     "src/repro/kernels/decode_attention.py:188",
                     {"qwen2 paged, overlapped":
                          paged_launches["decode_attention_paged"],
                      "qwen2 paged, serialized":
                          ser_launches["paged"]["decode_attention_paged"],
                      **dense_paths("decode_attention_paged", paged=True),
                      **phi3_paths("decode_attention_paged", paged=True),
                      **tp_paths("decode_attention_paged")},
                     paged_cases, paged_cases[0]),
        kernel_entry("decode_attention_ring",
                     "src/repro_torch/kernels/csrc/decode_attention_paged.cu",
                     "src/repro/kernels/decode_attention.py:298",
                     {"qwen2 ring, overlapped":
                          ring_launches["decode_attention_ring"],
                      "qwen2 ring, serialized":
                          ser_ring_launches["decode_attention_ring"]},
                     ring_cases, ring_cases[0]),
        kernel_entry("rwkv6_scan",
                     "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                     "src/repro/kernels/rwkv6_scan.py:45",
                     {"rwkv6 arena": rwkv_launches["rwkv6_scan"],
                      "rwkv6 training": rwkv_train["launches"][
                          "rwkv6_scan"],
                      **tp_paths("rwkv6_scan")},
                     rwkv_cases, rwkv_cases[0]),
        kernel_entry("rwkv6_scan_bwd",
                     "src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu",
                     "src/repro/models/rwkv6.py:110 (no TPU kernel: the "
                     "reference differentiates its lax.scan)",
                     {"rwkv6 training": rwkv_train["launches"][
                         "rwkv6_scan_bwd"]},
                     wkv_bwd_cases, wkv_bwd_cases[0]),
        kernel_entry("rglru_scan",
                     "src/repro_torch/kernels/csrc/rglru_scan.cu",
                     "src/repro/kernels/rglru_scan.py:37",
                     {"recurrentgemma arena": rg_launches["rglru_scan"],
                      "recurrentgemma training": rg_train["launches"][
                          "rglru_scan"],
                      **tp_paths("rglru_scan")},
                     rglru_cases, rglru_cases[0]),
        kernel_entry("rglru_scan_bwd",
                     "src/repro_torch/kernels/csrc/rglru_scan.cu",
                     "src/repro/models/rglru.py:77 (no TPU kernel: the "
                     "reference differentiates its lax.scan)",
                     {"recurrentgemma training": rg_train["launches"][
                         "rglru_scan_bwd"]},
                     rg_bwd_cases, rg_bwd_cases[0])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def mesh_only(backend, train=True):
    """`--mesh-only BACKEND [--serving]`: the card line, the builds of
    prox_update, the attention kernels and the forward scans, phase 49
    over BACKEND (not with `--serving`: `train` False), and phase 50 over
    gloo and over BACKEND, whose digests must be equal (nccl needs a GPU
    a rank: four for phase 49 and for phase 50's check ranks and (2, 2)
    launch)."""
    phase("1 card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    phase("2 build: prox_update, the attention kernels and the forward "
          "scans")
    names = ("prox_update",) + ATTENTION_LIBRARIES + ("rwkv6_scan",
                                                      "rglru_scan")
    for name in names:
        build.library_path(name).unlink(missing_ok=True)
    build.build(*names)
    gen = torch.Generator(device=DEV).manual_seed(0)
    if train:
        phase(f"49 the superstep across processes over {backend}")
        mesh_training(smi.splitlines()[0], gen, backend)
    phase(f"50 serving across processes over gloo and {backend}")
    _, _, want = mesh_serving(smi.splitlines()[0], gen)
    if backend != "gloo":
        _, _, got = mesh_serving(smi.splitlines()[0], gen, backend,
                                 kernels=False)
        if got != want:
            raise AssertionError(f"serve_mesh over {backend} gave {got}, "
                                 f"over gloo {want}")
        print(json.dumps({"serve_mesh_digests_equal": [backend, "gloo"]}),
              flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-only"]:
        mesh_only(sys.argv[2], train=sys.argv[3:4] != ["--serving"])
    elif sys.argv[1:2] == ["--serve-mesh-rank"]:
        serve_mesh_rank(*check_rank_args(sys.argv[2:]))
    elif sys.argv[1:2] == ["--train-mesh-rank"]:
        train_mesh_rank(*check_rank_args(sys.argv[2:]))
    else:
        main()
