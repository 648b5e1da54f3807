"""Drive the PyTorch/CUDA port's serving, training and generation paths on
one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing its own lines; any failure exits non-zero with no
result line (``--profile`` adds device-time breakdowns of steady decode
ticks after phase 4, of train steps after phase 7 and of ``generate()``
decode steps after phase 10):

1. device    — the card's name and power limit (nvidia-smi) and torch's name;
2. build     — nvcc builds every kernel of every path from ``ops/csrc``, one
               process per source, all started together;
3. kernel    — the paged decode kernel B8 (the decode template over bf16
               or fp32 pools) against its plain PyTorch version at GPT-345M
               decode shapes (bf16 and fp32), with kernel, plain, library
               and bound times; two planted rounding faults made through
               the plain version (p kept in fp32, p against the final max)
               must each break the bf16 limit;
4. serving   — a ``ServingEngine`` at GPT-345M width (random weights from a
               seed) serves 8 requests; the kernel launch counts must equal
               decode ticks x layers, the shared prefix must be reused, and
               no page may leak; tokens/s, TTFT p50 and TPOT p50 printed;
5. e2e       — the first decode tick's logits through the kernel and through
               the plain version agree, and the greedy streams are compared;
6. flash     — the three flash-attention kernels (forward, dQ, dK/dV) each
               against its plain version at GPT-345M training shapes (b 8,
               h 16, s 1024, d 64, causal; bf16 and fp32; dropout 0 and
               0.1), at GPT-1.3B's (d 128, bf16) and at an mp 2 rank's of
               GPT-1.3B (8 local heads of 16 taken from an [8, 1024, 8,
               384] fused-qkv shard, mp rank 1's global-head meta), with
               kernel, plain, library and bound times; at dropout 0.1 the
               dQ and dK/dV kernels given another seed's keep mask, or
               delta zeroed, must each break the limit on their outputs;
7. train     — ``Trainer.fit`` through ``build_module``/``build_dataloader``
               on ``pretrain_gpt_345M_single_card.yaml`` (24 layers, batch 8,
               seq 1024, bf16, dropout 0.1) over a seeded synthetic corpus:
               each flash kernel launches steps x 24 times, every loss is
               finite and the loss falls; step ms (CUDA events between the
               ends of consecutive steps, nothing synchronised), tokens/s
               and MFU printed;
8. train-e2e — one train step through the kernels and one through their
               plain versions (same weights, batch and dropout seeds, 6
               layers at full width), on two batches: loss, grad norm and
               every gradient leaf agree; then four planted faults (a
               kernel given seed+1, dV without the keep mask) must each
               break one of those limits;
9. decode    — the contiguous decode kernels B7 and B9 (int8 K/V) on caches
               of 512, 712 and 1024 positions (tiles of 256, 8 and 256) and
               the paged int8 kernel B10 on phase 3's pools, each against
               its plain version at GPT-345M decode shapes (bf16 and fp32),
               with kernel, plain, library and bound times;
10. generate — ``GPTGenerationModule.generate_ids`` through ``build_module``
               on ``generation_gpt_345M_single_card.yaml`` (12 of its 24
               layers since PR 20, bf16) for 8 left-padded prompts of
               24..312 tokens and 200 new tokens, greedy and with the
               config's sampling: B7 launches steps x 12 times; the first decode step's logits through the
               kernel and through the plain version (48 new tokens) agree;
               then the same at
               ``Model.decode_kv_dtype=int8`` through B9; tokens/s and ms
               per decode step printed;
11. int8     — phase 4's requests through a ``ServingEngine`` at
               ``kv_dtype="int8"``: B10 launches ticks x 24 times, the
               prefix is reused, no page leaks, and the pools take
               (d + 4) / 2d of the bf16 engine's bytes;
12. ce       — the fused LM-head cross-entropy kernels B4 (forward), B5
               (dh) and B6 (dW) each against its plain version at GPT-1.3B
               training shapes (8192 tokens, hidden 2048, vocab 50304,
               bf16) and at a small fp32 case, labels including -1 and both
               vocab ends, with kernel, plain, library and bound times;
               three planted faults made through the plain version must
               each break the bf16 limit;
13. train-1.3b — ``Trainer.fit`` through ``build_module``/``build_dataloader``
               on ``pretrain_gpt_1.3B_single_card.yaml`` with
               ``Model.fused_ce=True`` (24 layers, hidden 2048, 16 heads of
               128, batch 8, seq 1024, bf16, dropout 0.1, full recompute)
               for 20 steps, evaluating every 10 steps over 2 batches of
               the Eval split: B4 launches steps + eval batches times, B5
               and B6 steps times, B1 24 x (2 steps + eval batches), B2 and
               B3 24 x steps; every loss finite and falling; step ms,
               tokens/s, MFU and peak memory printed;
14. train-1.3b-e2e — one train step of that config cut to 4 layers, on two
               batches, through the kernels, through the plain versions of
               B1-B6, through the logits path, without recompute and with
               layer 0 opted out of it: all agree within limits, the fused
               path's peak memory lies at least one fp32 logits tensor
               below the logits path's, and two planted kernel-path faults
               (B6 without the one-hot term, B4 given labels + 1) must each
               break a limit;
15. cp-kernels — the ring-CP pair entries B11 (``block_fwd_lse``,
               ``block_dq``, ``block_dkv``: B1-B3 with global offsets)
               against their plain versions at the CP drive's pair shape
               (b 1, h 16, d 128, s_blk 4096, bf16), a diagonal causal
               pair and an off-diagonal pair, dropout 0 and 0.1, with
               kernel, plain, library (SDPA on the pair) and bound times;
               the offsets or h0 dropped under dropout must break the limit
               on both ``block_dq`` and ``block_dkv``;
16. cp-ring  — the ring at cp 2 and 4, its ranks processes that share the
               card over gloo (b 1, h 16, d 128, seq 16384, bf16): output
               and dq, dk, dv equal single-process B1-B3 on the whole
               sequence within phase 6's limits at dropout 0 and 0.1; B1
               launches 3 + 2(cp - 1) times per forward on each rank; the
               backward without its last shift home must break the limit;
17. train-cp — ``tools/train.py`` on ``pretrain_gpt_1.3B_longcontext_cp8
               .yaml`` at cp 2 (the yaml's 8 cut to the card's 2 ranks),
               seq 16384 (its 32768 cut), one sequence per step (no
               accumulation), full width, 1 of its 24 layers (to keep the
               script inside its time), bf16, dropout 0.1, full
               recompute, on 2 ranks sharing the card over gloo, for 6 steps
               and one evaluation: losses finite, falling and equal on both
               ranks, parameters equal across ranks, B1-B3 launched exactly
               as the ring under recompute launches them, no plain version;
               step ms, global tokens/s, MFU, the gradient all-reduce's ms,
               peak memory per rank and the backend printed;
18. train-cp-e2e — one step of that config cut to 2 layers at seq 4096
               (hidden dropout 0, attention dropout 0.1) at cp 1, cp 2 and
               dp 2 x cp 2 on the same global batch: loss, grad norm and
               every gradient leaf within phase 8's limits of cp 1;
19. mp-kernels — the vocab-parallel fused cross-entropy B12 (B4-B6 on a
               vocab shard, its shards combined over the mp group) on 2
               ranks sharing the card over gloo, at the mp drive's shard
               (8192 tokens, hidden 2048, vocab 50304 split in two, bf16),
               labels over the whole vocab: loss, dh, dW and each rank's
               partial dh against its plain version within CE_TOL; the
               backward given b = -a, or off-shard labels wrapped to a
               column of the shard, must break the limit; B4-B6 at the
               shard with independent a and b timed beside their plain
               versions, the logits path on the shard and their bounds;
20. train-mp — ``tools/train.py`` on ``pretrain_gpt_1.3B_single_card
               .yaml`` with ``Model.fused_ce=True`` at mp 2 (heads, MLP and
               vocab split over 2 ranks sharing the card over gloo), full
               width, 2 of its 24 layers (for time), batch 8 of 1024
               tokens, bf16, dropout 0.1,
               full recompute, for 5 steps and one evaluation of 1 batch:
               losses finite, falling and equal on both ranks, replicated
               parameters equal, B1-B3 and B12 launched exactly as the path
               launches them, no plain version and no logits path; step
               ms, tokens/s, MFU, the all-reduce ms per step, peak memory
               and launches per rank printed;
21. train-mp-e2e — one step of that config cut to 2 layers at mp 1, mp 2
               and dp 2 x mp 2 on the same global batch: loss, grad norm
               and every gathered gradient leaf within phase 8's limits of
               mp 1;
22. resume-1.3b — phase 13's configuration (full width, 1 of its 24
               layers for time, fused CE, full recompute, dropout 0.1): run
               A trains 3 steps and
               saves at step 2 through the async snapshot
               (``FLEETX_CKPT_ASYNC_SNAPSHOT=1``); run A2 trains the same
               3 steps again (the card's run-to-run gap: 0 when it repeats
               bit for bit); run B, a fresh trainer that restores step 2,
               trains step 3: its loss, grad norm, parameters, AdamW state
               and generator must equal A's within A2's gap, and a resume
               without the generator's state or without the AdamW moments
               must break that gate; checkpoint bytes, the save's blocking
               and total seconds, the load's seconds and the peak device
               memory across the save printed;
23. preempt  — ``tools/train.py`` as a subprocess on the 345M yaml (2 of
               its 24 layers) over a seeded corpus: a launch sent SIGTERM
               once its log shows step 3 exits 0 with a checkpoint at the
               step it reached, a relaunch with
               ``Engine.save_load.ckpt_dir`` resumes and ends at step 6,
               and the two launches' losses, joined, equal an
               uninterrupted launch's; seconds from the signal to exit and
               from the relaunch to its first step printed;
24. sentry   — phase 14's configuration (2 layers): four batches with the
               third NaN (through B4-B6) skip one step and end with the
               parameters, AdamW state and generator of a run over the
               other three, bit for bit, the skipped batch consumed; then
               phase 13's step at 4 layers with the sentry on and off (on,
               off, off, on): the cost of its per-step host read;
25. resume-mp — phase 21's configuration (1 layer) at mp 2 on 2 ranks
               sharing the card: fresh processes resume a per-rank
               checkpoint of step 1 and take step 2, equal on both ranks
               to the uninterrupted run bit for bit (sha256 of every
               tensor); a load of it at mp 1 raises
               ``ElasticMeshMismatch`` and quarantines nothing;
26. pp-e2e   — phase 21's configuration at 4 layers (the 1.3B, hidden
               dropout 0, attention dropout 0.1; the logits loss, as under
               pp) as 4 microbatches of 2: one step at pp 1 (accumulating
               over them), pp 2, pp 2 x v 2, mp 2 and pp 2 x mp 2 (ranks
               sharing the card over gloo) on the same global batch: loss,
               grad norm and every gradient leaf (the stages joined, the
               mp shards gathered) of each pipeline within phase 8's
               limits of the unpipelined run of its layout (pp 1, or mp 2
               for pp 2 x mp 2, whose gaps to pp 1 are logged); the tied
               embedding's gradient left unsummed, and two microbatches
               swapped at the stage boundary, must each break a limit;
27. train-pp — ``tools/train.py`` on ``pretrain_gpt_1.3B_single_card
               .yaml`` at pp 2 (2 layers a stage, 4 of its 24, 2 ranks
               sharing the card over gloo), full width, bf16, dropout
               0.1, full recompute, the logits loss, batch 8 as 4
               microbatches of 2, for 3 steps and one 1-batch
               evaluation, then 3 steps at
               virtual pp 2: losses finite, falling and equal on both
               ranks, the tied embedding's copies bit-equal after every
               step, B1-B3 launched exactly as the schedule launches them,
               no plain version and no fused CE; step ms, tokens/s, MFU,
               point-to-point ms and MB, collective ms, each rank's busy
               share and peak memory printed;
28. resume-pp — phase 26's configuration at pp 2, 2 layers (one a stage):
               fresh processes resume
               a per-stage checkpoint of step 1 and take step 2, equal on
               both ranks to the uninterrupted run bit for bit; a load of
               it at pp 1 raises ``ElasticMeshMismatch`` and quarantines
               nothing;
29. kernels-6.7b — B1-B3 at GPT-6.7B's microbatch (b 2, h 32, s 1024, d
               128, bf16, dropout 0 and 0.1) and B4-B6 over its 2048 tokens
               at hidden 4096, vocab 50304 (bf16) against their plain
               versions at phase 6's and phase 12's limits, each launched
               twice with equal bits, each with a planted fault that must
               break its limit; kernel, plain, library and bound times;
30. train-zero — ``tools/train.py`` on ``pretrain_gpt_6.7B_sharding16
               .yaml`` at sharding 2 (stage 2; the yaml's 16 cut to the
               card's 2 ranks sharing it over gloo), full width, 1 of its
               32 layers, bf16, dropout 0.1, fused CE, full recompute, the
               yaml's batch (local 8 in 4 microbatches of 2), 3 steps and a
               1-batch evaluation, the ZeRO update shard on; then the same
               drive at dp 2 with the replicated update
               (``FLEETX_ZERO_UPDATE=0``): losses finite and falling, the
               parameters bit-equal on both ranks after every step, the
               two runs within phase 8's loss and grad norm limits, and
               equal up to the first update (the first step with a rate
               above 0) with its grad norms within 1e-6 and its sampled
               parameters within a clip-scale rounding, the AdamW state per
               rank at most 0.55 of the replicated run's, B1-B6 launched as
               the path launches them; at 1 layer, the two updates with
               the clip's scale forced to 1 bit-equal for 1 step, and a
               norm from one rank's slices alone and one slice left stale
               on one rank must each break a gate; step ms, tokens/s,
               MFU, peak memory per rank, reduce-scatter, all-gather and
               all-reduce ms and GB per step printed;
31. elastic  — ``tools/train.py`` on the 1.3B yaml at 1 layer, full
               width, sharding 2 on 2 ranks, with the host-loss fault
               before step 3: the emergency checkpoint from the sharded
               moments, the mesh shrunk to one rank (the other exits 0),
               the resume through reshard-on-load to step 6; the restored
               step, the consumed samples and every loss within phase 8's
               loss limit of an uninterrupted 1-rank run; the checkpoint
               loaded at one rank equals its reload on the 2-rank mesh
               tensor for tensor and in meta.
32. kernels-175b — B1-B3 and B12's kernels at GPT-175B's mp 2 shapes
               against their plain versions, with planted faults, kernel,
               plain, library and bound times;
33. switches-1.3b — the GPT and Trainer switches at GPT-1.3B's width, 2
               layers: the recompute save-sets against no recompute, the
               unfused q/k/v, flax dropout, Momentum/SGD, the clips and the
               bf16 moments;
34. train-175b-sp — ``tools/train.py`` on the 175B yaml at mp 2 x Megatron
               sequence parallel, one layer at full width, on 2 ranks
               sharing the card, against the same drive without SP;
35. slot-serving — phase 4's requests through the slot cache
               (``paged=False``): every decode tick launches B7 once per
               layer and no other decode kernel, nothing leaks; the same
               requests with B7's plain version: the first decode tick's
               logits within LOGIT_TOL, the greedy common-prefix fraction
               logged; then at int8 KV through B9; the launch gate one tick
               short and the logits gate on rolled rows must break;
36. chunked  — chunked prefill (chunk 128, ``cache_len`` 1024), paged (B8)
               and slot (B7), over two prompts of 900 tokens and six of
               40-64, each against its unchunked engine: at most one
               prefill-shaped call per tick, every active stream one token
               on each tick with a prompt mid-prefill, first-token logits
               within LOGIT_TOL, launches once per layer of each decode
               forward, nothing leaks; the longest tick and the short
               streams' TPOT p50/p99 logged; the unchunked run, an engine
               that skips decode on chunk ticks, and the other long
               prompt's logits must each break a gate;
37. spec     — speculative decoding at k 4 on the paged engine (GPT-345M
               at 12 of its 24 layers since PR 20), the n-gram
               proposer on prompts repeating a 32-token pattern (16 new
               tokens each) and the self-draft proposer, at bf16 and at
               int8 KV: where a greedy
               stream parts from the plain engine's, the plain top-2 logit
               gap there lies within LOGIT_TOL, as does every self-draft
               rejection's; B8 (B10) launched once per layer of each plain
               tick, B7 once per layer of each single-token draft forward;
               a seeded sampling run repeats; acceptance rate, tokens per
               verify, verify ms and TPOT against the plain engine logged;
               an engine accepting every draft, the n-gram rejections, a
               draft step short and another seed must each break a gate.
38. tiers    — the host and disk page tiers at GPT-345M full depth: four
               512-token system prompts with 8 requests each (wave 1), 8
               unrelated prompts that push every warm page out of a
               256-page pool into a 64-page host tier and a disk tier under
               a temporary directory (wave 2), then wave 1 again, last
               group first: its
               streams byte-equal to an engine whose pool never evicts
               serving wave 1 twice, both tiers revived from, B8 launched
               once per layer of each decode forward, nothing leaks; a
               fresh engine on the directory revives a request's pages and
               prewarms another's prefix, each stream equal; a flipped
               byte in one file is refused and the request re-prefilled
               with wave 1's stream, and values revived one position off
               their keys must break the first-token logits gate; spill
               and revive pages, bytes and ms, TTFT cold, revived and
               prewarmed, and wave 3's host ms by part (ticks, admissions,
               decode, each tier's puts, gets and syncs) logged;
39. roles    — a prefill-role and a decode-role engine: phase 4's kind of
               traffic (8 requests of 32-512 tokens, two sampled) parked
               after the first token, shipped as bytes by ``export_kv`` and
               admitted by ``submit(kv_payloads=, history=[t0])``, at bf16
               (B8) and int8 (B10): streams byte-equal to one colocated
               engine's and each second token's logits bit-equal to
               colocated's, shipped bytes = pages x one page's wire size; a
               ship with a flipped byte is refused (its request replayed,
               its stream still equal), a page one layer short is refused,
               and a valid page with its values one position off must break
               the logits gate; export and admit ms and the time to the
               second token against colocated logged;
40. recovery — crash recovery on paged and slot engines at bf16 and int8
               (B8, B7, B10, B9): a tick fault at tick 5, streams (greedy
               and seeded sampling) byte-equal to the fault-free run and
               the first tick after the recovery giving its logits bit for
               bit (a catch-up one position late must break that); a
               poison request retired alone by bisection, its neighbours
               equal; a prefill that fails twice quarantined; a 2 s hang
               against a 0.5 s watchdog recovered, streams and logits as
               after the tick fault; every tick failing runs
               out the recovery budget (``RecoveryExhausted``, health
               dead); ``shutdown`` under load returns every request's
               partial stream; time to recover, replay ms and probes
               logged;
41. mesh     — mesh serving at mp 2, GPT-345M at full width, 3 of its 24
               layers (cut for time), two ranks sharing the card
               over gloo, each an engine over the
               whole weights keeping its heads, MLP and vocab shard,
               against single-card engines of the same weights: phase 4's
               requests paged at bf16 (B8, 16 new tokens, as every case),
               int8 KV with int8 weights
               paged (B10) and slot (B9), slot (B7), chunk 128 on the two
               900-token prompts, n-gram spec at k 4, a tick fault
               recovered: each rank's streams equal the single card's but
               where its top-2 gap lies within LOGIT_TOL, first-token
               logits within 0.07 (fp32: 1e-3) and bit-equal on both
               ranks, each
               rank's KV bytes in [0.45, 0.55] of the single card's, the
               decode kernel once per layer of each single-token forward
               on each rank; collective ms per tick and TPOT/TTFT p50
               against the single card logged; a rank holding the other's
               q/k/v head slice, and the row-parallel sums skipped (both
               in the same spawn), must each break the gate;
42. int8-weights — int8 weights on the single card, paged at bf16 KV (B8)
               and int8 KV (B10) and slot (B7), against bf16 weights on
               phase 4's requests made greedy: the int8 leaves equal the
               host's ``quantize_tree_int8`` bit for bit, the weight bytes
               equal the shapes', a stream parts only at a bf16 top-2 gap
               within 0.25 and first-token logits lie within it;
               ``quant_parity_frac`` and TPOT against bf16 weights logged;
               a served engine whose scales are loaded with their
               channels reversed must break the split-and-logits gate and
               the leaves gate;
43. obs      — a live engine under ``FLEETX_OBS_PORT=0`` with
               ``log_every`` 4: ``/metrics`` scraped over HTTP during and
               after a drain, its counters equal to ``snapshot()``;
               ``/healthz`` 200, then 503 on ``request_shutdown``; the
               snapshot line on every fourth tick; counters read a tick
               late must break the counter gate.
44. fleet    — two replica processes on the card, each serving a GPT-345M
               engine of the same CPU-drawn weights (24 layers, bf16, pages
               of 16) through ``tools/serve``'s worker; here a
               ``ServingRouter`` over two ``ReplicaClient``s behind an
               ``ApiServer`` on port 0: phase 4's requests (32 new tokens)
               over HTTP to both routes, half SSE, two sampled with fixed
               seeds: streams byte-equal to an in-process engine's; again
               with the replica decoding request 0 SIGKILLed after its
               eighth token: byte-equal, a migration and a dead replica
               recorded; a replacement replica joins and a seeded
               32-request Poisson trace runs through ``run_trace`` (goodput,
               TTFT and TPOT p50/p99 logged); the SIGTERM drain fan-out
               ends both surviving processes with exit 0, each having
               launched B8 once per layer of each decode forward; HTTP TTFT
               and TPOT against the in-process engine, RPCs per tick and
               the time from the kill to the first migrated token logged; a
               router that migrates without the history and a replica that
               replays one token late must each break the stream gate;
45. serve-cli — ``python -m fleetx_tpu_torch.tools.serve --demo
               --replicas 2 --port 0`` on the card: one streamed chat
               completion equals the demo engine's greedy stream in
               process; SIGTERM ends it with exit 0 and no process left;
46. ernie    — B1 in the encoders' mode (non-causal, per-row ``kv_lens``,
               bf16, 12 heads of 64) against its plain version at
               ERNIE-base's shapes (b 8, s 512, key lengths 512, 300, 129,
               65, 64, 17, 1 and 0: the filler row comes out as zeros) and
               ViT-B/16's (s 256, key lengths 197), with kernel, plain,
               SDPA (the same masked function) and bound times; the kernel
               given one key fewer a row, or ``causal`` flipped, must break
               the limit; then an ``ErnieScoringEngine`` over ERNIE-base
               (12 layers, hidden 768, vocab 40000, weights from
               ``init_params``) serves 21 seeded fill-in-blank and scoring
               requests of 16-512 tokens (length buckets 64, 256 and 512,
               filler rows) through B1 and through its plain version:
               MLM and SOP logits within LOGIT_TOL, ids equal wherever the
               plain top-2 gap exceeds it (the equal fraction logged), B1
               once per layer of each batched forward; TTFT p50 and
               requests/s logged;
47. vit      — ``EmbeddingEngine``s over ViT-B/16 at 224 (1000 classes, and
               its embedding mode) serve 12 seeded images through B1 and
               its plain version: embeddings within VIT_EMB_TOL (relative
               L2), class logits within LOGIT_TOL and ids under the top-2
               rule, B1 once per layer of each forward; one image's
               embedding at buckets 1, 2, 4 and 8 (largest difference and
               bit-equality logged); TTFT p50 and vectors/s logged;
48. hetero   — two GPT-345M ``ServingEngine``s (B8), two ViT-B/16
               embedding engines and an ERNIE-base engine (B1) behind one
               ``ServingRouter`` and an ``ApiServer`` in this process:
               ``/v1/models`` lists the three families, ``/v1/completions``
               reaches ``gpt`` and ``ernie``, ``/v1/embeddings`` on two
               images returns the engines' wire vectors exactly; a mixed
               pass gives the lone replicas' GPT streams byte for byte and
               embeddings within VIT_EMB_TOL (TTFT p50 by family logged);
               ``serving_hetero``'s fault plan (a ViT replica killed with
               its batch dispatched, a GPT replica killed mid-stream): one
               terminal result each, the same gates, no dispatch across
               families; B8 once per layer of each decode forward and B1
               once per layer of each encoder forward; the routers run at
               the default DRR quantum, and a lone image is answered in
               the router's first tick;
49. moe      — ``Trainer.fit`` through ``build_module`` on
               ``pretrain_moe_small.yaml`` at full width and depth (12
               layers, hidden 1024, 8 experts, gshard top 2, capacity 1.2,
               bf16, dropout 0.1), one rank, batch 8 of 1024 tokens, 6
               steps: every loss finite and falling, B1, B2 and B3 once per
               layer per step; ``lm_loss``, ``balance_loss``, each layer's
               dropped share, step ms, tokens/s, the MoE MFU, peak memory
               and the dense and expert parameter bytes logged;
50. moe-ep   — expert parallelism at dp 2, two ranks sharing the card over
               gloo, 4 experts each: (a) the yaml at full width, 2 layers,
               fp32, capacity factor 0.5 (tokens dropped), one step on one
               global batch at dp 1 and dp 2: every layer's expert ids and
               keep flags bit-equal, loss, grad norm and every parameter
               after the step within MOE_E2E_TOL; routing per rank with a
               per-rank capacity, the expert gradients summed over the
               data group and the clip's norm over one rank's experts must
               each break that gate; (b) bf16 at full depth, 4 steps of
               ``Trainer.fit`` on phase 49's global batches: losses within
               MOE_BF16_LOSS_TOL of phase 49's, each rank's expert bytes
               half the model's; all-to-all ms and MB and the all-reduce ms
               per step logged;
51. encoder-bwd — B2 (dQ) and B3 (dK/dV) in the encoders' training mode
               (non-causal, per-row ``kv_lens``, bf16, head dim 64, batch
               64) against their plain versions within FLASH_TOL, each
               launched twice with equal bits: at ERNIE-345M's shape (16
               heads, s 512, dropout 0.1, the key lengths of 64
               ``ErnieDataset`` samples) and ViT-B/16's (12 heads, 197
               tokens padded to 256, dropout 0); ``kv_lens`` one short,
               ``causal`` flipped and (ERNIE) another dropout seed must
               each break the limit; kernel, plain, SDPA-backward (the same
               key mask) and bound times;
52. train-ernie — ``Trainer.fit`` through ``build_module`` on
               ``pretrain_ernie_base_345M_single_card.yaml`` at full width
               and depth (24 layers, hidden 1024, 16 heads, vocab 40000,
               batch 64 of 512 tokens, 80 masked slots, bf16, dropout 0.1,
               the right padding as key lengths) over ``ErnieDataset`` on a
               synthetic corpus, 12 steps: every loss finite and falling,
               B1, B2 and B3 once per layer per step; ``lm_loss`` and
               ``sop_loss``, step ms, tokens/s, MFU, peak memory and the
               loader's wait logged; then at 2 layers and fp32 one step
               through the kernels against their plain versions: loss
               within 1e-5, grad norm and every gradient leaf within 1e-4
               (ENCODER_E2E_TOL), and seven planted kernel faults (B1/B3
               given one key fewer, B2 run causal, phase 8's four) must
               each break it;
53. train-vit — ``Trainer.fit`` on ``vit_base_patch16_224.yaml`` at full
               width and depth (12 layers, hidden 768, 1000 classes,
               global batch 256 in 4 micro-batches of 64, bf16, drop path
               0.1, mixup 0.8, label smoothing 0.1) over 512
               ``SyntheticClsDataset`` images seen once an epoch, 6 steps
               and one evaluation of 2 Eval batches: every loss finite and
               falling, B2 and B3 once per layer per micro-batch, B1 too
               and once per layer per evaluation batch; eval loss and
               accuracy, step ms, images/s, MFU, peak memory and the
               loader's wait logged; then at 2 layers, fp32, one
               micro-batch of 64 images, the kernel path against the plain
               path as in phase 52 (three planted faults: no attention
               dropout here).

Every drive writes into an output directory of its own, deleted with its
phase. The script is the reaper of every process it starts, also of those
whose parent ends first, and stops and reaps them all before it prints its
result or when a phase fails. The line before the last is the kernels' JSON
record; the last line is ``{"ok": true, "device": {...}}``. Needs CUDA: without it the script exits
non-zero before any phase runs. ``--profile`` also breaks down the 1.3B
train steps after phase 13.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import gc
import hashlib
import json
import math
import multiprocessing.resource_tracker
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from fleetx_tpu_torch.models.gpt import generation as gen  # noqa: E402
from fleetx_tpu_torch.models.gpt import model as gpt_model  # noqa: E402
from fleetx_tpu_torch.models.gpt.convert import init_params  # noqa: E402
from fleetx_tpu_torch.models.gpt.generation import (  # noqa: E402
    GenerationConfig,
)
from fleetx_tpu_torch.models.gpt.model import (  # noqa: E402
    GPTConfig,
    GPTForPretraining,
)
from fleetx_tpu_torch.core.engine import Trainer, peak_flops  # noqa: E402
from fleetx_tpu_torch.data import build_dataloader  # noqa: E402
from fleetx_tpu_torch.models import build_module  # noqa: E402
from fleetx_tpu_torch.ops import _build  # noqa: E402
from fleetx_tpu_torch.ops import ce_loss as ce  # noqa: E402
from fleetx_tpu_torch.ops import decode_attention as da  # noqa: E402
from fleetx_tpu_torch.ops import flash_attention as fa  # noqa: E402
from fleetx_tpu_torch.parallel import launch  # noqa: E402
from fleetx_tpu_torch.ops.quant import (  # noqa: E402
    QUANT_PREFIX_BUDGET,
    dequantize_kv,
    quant_parity_frac,
    quantize_kv,
)
from fleetx_tpu_torch.resilience.faults import faults  # noqa: E402
from fleetx_tpu_torch.serving import (  # noqa: E402
    HostPageStore,
    RecoveryExhausted,
    ServingEngine,
    ServingMetrics,
)
from fleetx_tpu_torch.serving.cache_manager import payload_nbytes  # noqa: E402
from fleetx_tpu_torch.tools.kernel_cases import (  # noqa: E402
    CP_BLOCK,
    CP_DEGREE,
    CP_PAIRS,
    CP_SEED,
    CP_SEQ,
    DEVICE,
    FLASH_MP_META,
    GEN_PROMPT_LENS,
    contiguous_case,
    contiguous_cases,
    cuda_ms,
    decode_bound,
    decode_case,
    flash_delta,
    flash_inputs,
    rotation_copies,
    sdpa_times,
)
from fleetx_tpu_torch.utils.config import get_config  # noqa: E402

HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
LOGIT_TOL = 5e-2  # fp32 logits of bf16 activations after 24 layers
MAX_NEW = 64
ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT,
                      "configs/nlp/gpt/generation_gpt_345M_single_card.yaml")
TRAIN_CONFIG = os.path.join(ROOT,
                            "configs/nlp/gpt/pretrain_gpt_345M_single_card.yaml")
TRAIN_STEPS = 30
TRAIN_13B_CONFIG = os.path.join(
    ROOT, "configs/nlp/gpt/pretrain_gpt_1.3B_single_card.yaml")
TRAIN_13B_STEPS = 20
EVAL_FREQ, EVAL_ITERS = 10, 2  # phase 13 evaluates after steps 10 and 20
# phase 12: (tokens, hidden, vocab) by dtype: GPT-1.3B's LM head in bf16,
# a small case for the fp32 (CUDA-core) kernels
CE_SHAPES = {torch.bfloat16: (8192, 2048, 50304),
             torch.float32: (1024, 256, 8192)}
# phase 10: the generation config at bf16 (the yaml itself computes in
# fp32: use_pure_fp16 False) over GEN_PROMPT_LENS
GEN_BF16 = "Engine.mix_precision.use_pure_fp16=True"
GEN_SEED = 2024
# device-time classes of a profile, by kernel-name marks (first match wins)
PROFILE_CLASSES = (
    ("fused CE kernels", ("ce_stats_kernel", "ce_fwd_kernel",
                          "ce_bwd_kernel", "ce_combine_kernel",
                          "ce_dl_kernel", "ce_prod_kernel")),
    ("port kernels", ("flash_", "decode_scores_kernel",
                      "decode_values_kernel")),
    ("gemm", ("nvjet", "gemm", "cutlass", "Kernel2")),
    ("optimizer", ("multi_tensor", "fused_adam", "FusedAdam")),
    ("int hash", ("<int, int", "Functor<int")),
    ("copies and casts", ("copy", "bfloat16_copy")),
)
# the CUDA kernels each entry of the kernels' record launches on the bf16
# path (the names a profile shows)
_DECODE_KERNELS = ["decode_scores_kernel", "decode_values_kernel"]
_CE_GRAD_KERNELS = ["ce_dl_kernel", "ce_prod_kernel"]
CUDA_KERNELS = {
    "paged_decode": _DECODE_KERNELS, "decode": _DECODE_KERNELS,
    "decode_q8": _DECODE_KERNELS, "paged_decode_q8": _DECODE_KERNELS,
    "flash_fwd": ["flash_fwd_wg_kernel"],
    "flash_bwd_dq": ["flash_bwd_dq_wg_kernel"],
    "flash_bwd_dkv": ["flash_bwd_dkv_wg_kernel"],
    "block_fwd_lse": ["flash_fwd_wg_kernel"],
    "block_dq": ["flash_bwd_dq_wg_kernel"],
    "block_dkv": ["flash_bwd_dkv_wg_kernel"],
    "ce_fwd": ["ce_stats_kernel", "ce_combine_kernel"],
    "ce_dh": _CE_GRAD_KERNELS, "ce_dw": _CE_GRAD_KERNELS,
    "vp_ce_fwd": ["ce_stats_kernel", "ce_combine_kernel"],
    "vp_ce_dh": _CE_GRAD_KERNELS, "vp_ce_dw": _CE_GRAD_KERNELS,
}
# phase 8 limits, kernels vs plain versions in one bf16 train step: loss
# (absolute), grad norm (relative) and the largest relative L2 difference
# of one gradient leaf. Each lies between the largest gap of sound runs and
# the smallest gap of a planted fault that the metric sees; the readings
# are in PERF.md (sound: 5.7e-6, 1.0e-4, 7.8e-3; faults: 1.1e-3, 6.9e-4,
# 9.2e-2)
TRAIN_E2E_TOL = {"loss": 1e-4, "grad_norm": 3e-4, "grad_leaf": 3e-2}
# phase 14 limits, the same three metrics for the 4-layer GPT-1.3B step
# (kernels vs plain versions of B1-B6, fused vs logits path), started
# from phase 8's
TRAIN_13B_E2E_TOL = dict(TRAIN_E2E_TOL)


_CLOCK = {"t0": time.monotonic(), "phase": None}


def log(phase: str, **fields) -> None:
    """One line of ``phase``; before a phase's first line, a ``[clock]``
    line with the seconds since the script started."""
    if phase != _CLOCK["phase"]:
        _CLOCK["phase"] = phase
        print(f"[clock] phase={phase} "
              f"at_s={time.monotonic() - _CLOCK['t0']:.1f}", flush=True)
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


# ---------------------------------------------------------------- processes

PR_SET_CHILD_SUBREAPER = 36  # <linux/prctl.h>


def adopt_orphans() -> None:
    """Make this process the parent of every process below it whose own
    parent ends first, so that :func:`stop_descendants` finds them all."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def descendants() -> dict:
    """pid -> command line of every process below this one, zombies
    included."""
    parents, names = {}, {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmdline = f.read().replace(b"\0", b" ").decode(
                    errors="replace").strip()
        except OSError:  # it ended meanwhile
            continue
        # "pid (comm) state ppid ...": comm may hold spaces and parentheses
        parents[int(entry)] = int(stat.rsplit(")", 1)[1].split()[1])
        names[int(entry)] = cmdline or stat.split(" ", 1)[1].rsplit(")")[0]
    below, frontier = {}, [os.getpid()]
    while frontier:
        top = frontier.pop()
        for pid, ppid in parents.items():
            if ppid == top and pid not in below:
                below[pid] = names[pid]
                frontier.append(pid)
    return below


def reap() -> None:
    """Collect the exit status of every child that has ended."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def stop_descendants(grace: float = 10.0) -> dict:
    """Stop every process below this one and reap it: multiprocessing's
    resource tracker by its own shutdown, the rest by SIGTERM and, after
    ``grace`` seconds, SIGKILL. Returns those that were still there
    (pid -> command line)."""
    tracker = multiprocessing.resource_tracker._resource_tracker
    if hasattr(tracker, "_stop"):  # else SIGTERM is ignored: SIGKILL
        tracker._stop()  # closes its pipe and waits for it to exit
    reap()
    left = descendants()
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in descendants():
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        deadline = time.monotonic() + grace
        while descendants() and time.monotonic() < deadline:
            reap()
            time.sleep(0.05)
        if not descendants():
            break
    if descendants():
        raise RuntimeError(f"processes outlived SIGKILL: {descendants()}")
    return left


# ----------------------------------------------------------------- phase 1-2

CARD = {}  # the card's nvidia-smi name and power limit (phase 1)


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    CARD["line"] = card
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    log("device", torch_name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    return {"platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    t0 = time.perf_counter()
    seconds = _build.build(da.KERNEL, fa.KERNEL, ce.KERNEL)
    log("build", kernels=",".join(seconds), seconds=round(
        time.perf_counter() - t0, 3))
    for name in seconds:
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log("build", ptxas=repr(line.strip()))


# ------------------------------------------------------------------ phase 3

def library_decode_ms(q, kvs, starts, ends) -> float:
    """SDPA over each row's window as a yardstick (never used by the port):
    one call per K/V copy, pre-transposed to [b, h, L, d] (pre-gathered
    from the pools for the paged kernels, pre-dequantized to q's dtype for
    the int8 ones), the window as a boolean mask; timed over the copies in
    turn."""
    qt = q.transpose(1, 2).contiguous()
    args = []
    for k, v in kvs:
        pos = torch.arange(k.shape[1], device=q.device)
        mask = ((pos[None] >= starts[:, None].long())
                & (pos[None] < ends[:, None].long()))[:, None, None, :]
        args.append((k.transpose(1, 2).contiguous(),
                     v.transpose(1, 2).contiguous(), mask))
    it = iter(range(1 << 30))

    def library():
        k, v, mask = args[next(it) % len(args)]
        torch.nn.functional.scaled_dot_product_attention(qt, k, v,
                                                         attn_mask=mask)

    return cuda_ms(library, iters=100)


def check_and_time(name, label, dtype, run, plain, lib_kvs, case,
                   nbytes, flops, phase="decode", faults=None,
                   **extra) -> dict:
    """Hold ``run(i)`` (decode kernel ``name`` on the case's K/V copy i),
    launched twice with equal bits, against ``plain(i)`` on copy 0 by
    ``da.decode_gaps``, where each
    planted fault of ``faults()`` (outputs of the plain version with one
    rounding fault, :func:`planted_decode_faults`) must break the limit,
    and time the
    kernel, the plain version (both rotating over the copies) and the
    library call over ``lib_kvs``; logs its lines and returns the JSON
    record's numbers."""
    before = dict(da.launches)
    got = run(0)
    again = run(0)
    torch.cuda.synchronize()
    if da.launches[name] != before[name] + 2:
        raise AssertionError(f"{name} did not launch")
    if not torch.equal(got, again):
        raise AssertionError(f"{name} {label} {dtype}: two launches on the "
                             "same inputs differ")
    want = plain(0)
    gaps = da.decode_gaps(got, want)
    err, tol, ok = gaps.pop("max_abs_err"), da.DECODE_TOL[dtype], gaps.pop("ok")
    if not ok:
        raise AssertionError(f"{name} {label} {dtype}: max abs err {err}, "
                             f"{gaps} against {tol}")
    for fault, out in (faults() if faults is not None else {}).items():
        caught = da.decode_gaps(got, out)
        log(phase, name=name, case=repr(label), planted_fault=repr(fault),
            **caught)
        if caught["ok"]:
            raise AssertionError(f"{name} {label}: the limit misses the "
                                 f"planted fault {fault!r}: {caught}")
    if not got.float().abs().max().item() < 100.0:
        raise AssertionError(f"{name} {label}: garbage reached the output")
    it = iter(range(1 << 30))
    n = len(case["caches"]) if "caches" in case else len(case["pools"])
    kernel_ms = cuda_ms(lambda: run(next(it) % n), iters=200)
    plain_ms = cuda_ms(lambda: plain(next(it) % n), iters=20)
    library_ms = library_decode_ms(case["q"], lib_kvs, case["starts"],
                                   case["ends"])
    da.launches.update(before)  # checks and timing are not the path
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(phase, name=name, case=repr(label),
        dtype=str(dtype).split(".")[-1], max_abs_err=err, tol=tol, **gaps,
        copies=n, kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=max(bytes_ms, ops_ms), bound_by=bound_by, bytes=nbytes,
        flops=flops, gb_per_s=nbytes / kernel_ms * 1e-6, **extra)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": bound_by,
            "library_ms": library_ms}


def phase_kernel() -> dict:
    """B8 against its plain version at 345M decode shapes, bf16 and fp32;
    at bf16 the planted rounding faults must break the limit. Returns the
    bf16 record (the serving dtype) for the JSON line."""
    record = None
    for dtype in (torch.bfloat16, torch.float32):
        case = decode_case(dtype)
        q, pools, tables = case["q"], case["pools"], case["tables"]
        kw = dict(tables=tables, end=case["ends"], starts=case["starts"])

        def run(i, fn=da.paged_decode_attention):
            k, v = pools[i]
            return fn(q, k, v, **kw)

        def plain(i):
            return run(i, da.paged_decode_attention_ref)

        def faults():
            k, v = pools[0]
            return planted_decode_faults(q, k, v, None, None,
                                         block_k=case["page_size"], **kw)

        lib_kvs = [(da.paged_gather_kv(k, tables), da.paged_gather_kv(v, tables))
                   for k, v in pools]
        nbytes, flops = decode_bound(case, dtype)
        rec = check_and_time(
            "paged_decode", "phase 3 pools", dtype, run, plain, lib_kvs, case,
            nbytes, flops, phase="kernel",
            faults=faults if dtype == torch.bfloat16 else None,
            ends=case["ends"].tolist(), starts=case["starts"].tolist())
        if dtype == torch.bfloat16:
            record = rec
        del case, pools, lib_kvs
    return record


# ------------------------------------------------------------------ phase 4

def serving_requests(vocab: int, seed: int = 0) -> list:
    """Eight requests with prompts of 32..512 tokens: 0 and 1 share a
    64-token prefix, 6 are greedy and 2 sample (top_k 50, top_p 0.75);
    each asks for 64 new tokens."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, 64)
    lengths = [96, 160, 32, 512, 256, 384, 48, 200]
    prompts = [np.concatenate([prefix, rng.randint(0, vocab, n - 64)])
               if i < 2 else rng.randint(0, vocab, n)
               for i, n in enumerate(lengths)]
    sampling = {3, 6}
    return [dict(prompt=p, max_length=MAX_NEW,
                 decode_strategy="sampling" if i in sampling else "greedy",
                 top_k=50, top_p=0.75, seed=100 + i)
            for i, p in enumerate(prompts)]


def serving_config() -> tuple:
    """GPT-345M's config (24 layers, hidden 1024, 16 heads of 64, vocab
    50304, bf16 compute) and its generation knobs."""
    conf = get_config(CONFIG, nranks=1)  # also on a mesh's rank
    return (GPTConfig.from_model_config(conf.Model),
            GenerationConfig.from_config(conf.Generation))


def build_engine(kv_dtype=None, params=None, dtype=None, layers=None,
                 **kw):
    """A ServingEngine at GPT-345M width with random weights from seed 0
    (or ``params``), 8 lanes of 1024 positions, 16-position pages, bf16
    (or ``kv_dtype``) KV, bf16 compute (or ``dtype``), the config's 24
    layers (or ``layers``); ``kw`` sets further engine switches."""
    cfg, gen_cfg = serving_config()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if params is None:
        params = init_params(cfg, seed=0)
    kw = dict(dict(slots=8, page_size=16, cache_len=1024), **kw)
    engine = ServingEngine(GPTForPretraining(cfg, device="meta"), params,
                           gen_cfg=gen_cfg, kv_dtype=kv_dtype, **kw)
    del params
    return engine, cfg


def zero_launches() -> None:
    """Set every decode kernel's launch count to 0 (just before a path)."""
    for name in da.NAMES:
        da.launches[name] = 0


def serve(engine, requests) -> tuple:
    """Submit ``requests``, tick to the end; (results, decode ticks,
    seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in requests:
        engine.submit(**r)
    ticks = 0
    while engine.scheduler.queue_depth or engine.cache_manager.active_count:
        ticks += engine.step()["decoded"] > 0
    results = engine.drain()
    torch.cuda.synchronize()
    return results, ticks, time.perf_counter() - t0


def phase_serving(engine, cfg, phase: str = "serving") -> dict:
    """The port's serving path: 8 requests through submit/step/drain. Every
    decode tick must launch the engine's paged decode kernel (B8; B10 at
    int8 KV) once per layer, and no other decode kernel."""
    name = "paged_decode_q8" if engine.kv_dtype == "int8" else "paged_decode"
    requests = serving_requests(cfg.vocab_size)
    serve(engine, [dict(prompt=np.arange(40), max_length=4)])  # warm-up
    engine.metrics = ServingMetrics(engine.slots)
    engine.publish_quant_metrics()
    seen = watch_forwards(engine)
    zero_launches()
    results, ticks, seconds = serve(engine, requests)
    counts = dict(da.launches)
    launches = counts.pop(name)
    snap = engine.metrics.snapshot()
    reasons = {r.finish_reason for r in results.values()}
    tokens = sum(len(r.tokens) for r in results.values())
    ttft = [r.ttft_s for r in results.values()]
    tpot = [(r.latency_s - r.ttft_s) / (len(r.tokens) - 1)
            for r in results.values() if len(r.tokens) > 1]
    log(phase, requests=len(results), tokens=tokens, decode_ticks=ticks,
        kernel=name, kernel_launches=launches, layers=cfg.num_layers,
        tokens_per_s=tokens / seconds, seconds=seconds,
        ttft_ms_p50=float(np.median(ttft)) * 1e3,
        tpot_ms_p50=float(np.median(tpot)) * 1e3,
        prefix_hits=snap["prefix_hits"],
        prefill_tokens_saved=snap["prefill_tokens_saved"],
        pages_in_use=engine.cache_manager.pages_in_use,
        kv_dtype=snap["kv_dtype"], kv_cache_bytes=snap["kv_cache_bytes"],
        kv_bytes_per_token=snap["kv_bytes_per_token"],
        finish_reasons=snap["finish_reasons"])
    if any(counts.values()):
        raise AssertionError(f"other decode kernels launched: {counts}")
    if len(results) != len(requests) or not reasons <= {"max_length", "eos"}:
        raise AssertionError(f"requests finished {snap['finish_reasons']}")
    for r in results.values():
        if not (len(r.tokens) and r.tokens.min() >= 0
                and r.tokens.max() < cfg.vocab_size):
            raise AssertionError(f"request {r.id} emitted {r.tokens}")
    if snap["prefix_hits"] < 1:
        raise AssertionError("the shared 64-token prefix was not reused")
    # a speculative engine's verify ticks launch no decode kernel
    launch_gate(name, launches, seen["decode"], cfg.num_layers)
    if not engine.spec and seen["decode"] != ticks:
        raise AssertionError(f"{seen['decode']} decode forwards in {ticks} "
                             "ticks")
    if engine.cache_manager.pages_in_use:
        raise AssertionError(f"{engine.cache_manager.pages_in_use} pages "
                             "leaked after the drain")
    return {"launches": launches, "kv_cache_bytes": snap["kv_cache_bytes"]}


def phase_profile(engine, cfg, ticks: int = 20) -> None:
    """``--profile``: device time by kernel over ``ticks`` steady decode
    ticks of the phase-4 batch (all 8 lanes decoding), and the device's
    busy share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    for r in serving_requests(cfg.vocab_size, seed=2):
        engine.submit(**r)
    engine.step()  # admissions + the first decode tick
    engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    engine.drain()
    report_profile("profile", prof, wall, ticks, "tick")


# ------------------------------------------------------------------ phase 5

def phase_e2e(cfg) -> None:
    """The same greedy requests served by two fresh engines: decode
    attention through the kernel, then through the plain version. The
    first decode tick's logits must agree within LOGIT_TOL; later greedy
    tokens may diverge after a near-tie, so their common-prefix fraction
    is reported."""
    requests = [dict(r, decode_strategy="greedy")
                for r in serving_requests(cfg.vocab_size, seed=1)]
    runs = []
    for attention in (da.paged_decode_attention,
                      da.paged_decode_attention_ref):
        engine, _ = build_engine()
        gpt_model.paged_decode_attention = attention
        first = []
        forward = engine.executor.forward

        def record(cache, ids, *args, **kw):
            logits, cache = forward(cache, ids, *args, **kw)
            if ids.shape[1] == 1 and not first:
                first.append(logits.clone())
            return logits, cache

        engine.executor.forward = record
        try:
            results, _, _ = serve(engine, requests)
        finally:
            gpt_model.paged_decode_attention = da.paged_decode_attention
        runs.append((first[0], results))
        del engine
    (lk, rk), (lp, rp) = runs
    err = (lk - lp).abs().max().item()
    agree = [common_prefix(rk[i].tokens, rp[i].tokens) / len(rp[i].tokens)
             for i in rp]
    log("e2e", first_tick_logits_max_abs_err=err, tol=LOGIT_TOL,
        greedy_common_prefix_frac=float(np.mean(agree)),
        per_request=[round(a, 3) for a in agree])
    if not (math.isfinite(err) and err <= LOGIT_TOL):
        raise AssertionError(f"first-tick logits differ by {err}")


# ------------------------------------------------------------------ phase 6

def flash_bound(name: str, q: torch.Tensor) -> tuple:
    """(bytes, flops) of one causal call at q's shape: each input read
    once and each output written once; 2 flops per multiply-add over the
    s(s+1)/2 live (q, k) pairs, for the 2 (forward), 3 (dQ) or 4 (dK/dV)
    products the function needs."""
    b, s, h, d = q.shape
    operand = b * s * h * d * q.element_size()
    row = b * h * s * 4  # an fp32 [b*h, s] lse or delta
    product = 2 * b * h * d * s * (s + 1) // 2
    if name == "flash_fwd":   # q, k, v -> out, lse
        return 4 * operand + row, 2 * product
    if name == "flash_bwd_dq":  # q, k, v, dO, lse, delta -> dQ
        return 5 * operand + 2 * row, 3 * product
    return 6 * operand + 2 * row, 4 * product  # ... -> dK, dV


def phase_flash() -> dict:
    """B1, B2 and B3 against their plain versions at GPT-345M training
    shapes (head dim 64; bf16 and fp32), at GPT-1.3B's (head dim 128,
    bf16) and at an mp 2 rank's of GPT-1.3B (8 local heads with mp rank
    1's global-head meta, so the dropout hash and the grid see phase 20's
    ids and strides), dropout 0 and 0.1, with kernel, plain, library (SDPA,
    dropout 0, yardstick only) and bound times; at dropout 0.1 two planted
    faults (another seed, delta zeroed) must break B2's and B3's limits.
    Returns the records of the 345M drive's case (bf16, dropout 0.1) by
    kernel name, each with the 1.3B drive's case under ``"d128"`` and the
    mp drive's under ``"mp"``."""
    records = {}
    bf16 = torch.bfloat16
    for d, h, meta, dtypes, key in (
            (64, 16, None, (bf16, torch.float32), None),
            (128, 16, None, (bf16,), "d128"),
            (128, FLASH_MP_META[2], FLASH_MP_META, (bf16,), "mp")):
        for dtype in dtypes:
            for name, rec in flash_cases(dtype, d, h, meta).items():
                if key is None:
                    records[name] = rec
                else:
                    records[name][key] = rec
    return records


def flash_cases(dtype, d: int, h: int = 16, meta=None, b: int = 8,
                strict: bool = False, s: int = 1024) -> dict:
    """Phase 6 at one dtype, head dim, head count, meta (None: the
    identity), batch and sequence; returns the dropout-0.1 records by
    kernel name.
    ``strict`` (phase 29) also launches each kernel twice on the same
    inputs (the bits must be equal) and plants B1 given another seed at
    dropout 0.1 (it must break the limit)."""
    records = {}
    sets = flash_inputs(dtype, d=d, h=h, b=b, s=s)
    lib = sdpa_times(sets, causal=True)
    for rate in (0.0, 0.1):
        kw = dict(causal=True, dropout_rate=rate, seed=-1234567, meta=meta)
        before = dict(fa.launches)
        state = []
        for q, k, v, do in sets:
            out, lse = fa.flash_fwd(q, k, v, **kw)
            state.append((out, lse, flash_delta(do, out)))
        q, k, v, do = sets[0]
        out, lse, delta = state[0]
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        want_out, want_lse = fa.flash_attention_fwd_ref(q, k, v, **kw)
        want_dq = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
        want_dk, want_dv = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                **kw)
        lse_err = (lse - want_lse).abs().max().item()
        atol, rtol = fa.FLASH_TOL[dtype]
        if strict:
            again = (*fa.flash_fwd(q, k, v, **kw),
                     fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                     *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
            same = [torch.equal(x, y)
                    for x, y in zip(again, (out, lse, dq, dk, dv))]
            log("flash", heads=h, head_dim=d, batch=b, dropout=rate,
                twice_equal=same)
            if not all(same):
                raise AssertionError(f"flash d {d} h {h} b {b}: two "
                                     f"launches differ ({same})")
            del again
            if rate > 0.0:
                wrong = _tol_ratio(fa.flash_fwd(
                    q, k, v, **dict(kw, seed=kw["seed"] + 1))[0], want_out,
                    atol, rtol)
                log("flash", name="flash_fwd", heads=h, batch=b,
                    dropout=rate, planted_fault="'seed + 1'",
                    tol_ratio=wrong)
                if not wrong > 1.0:
                    raise AssertionError(f"B1 given seed + 1 at h {h} is "
                                         f"held within the limit ({wrong})")
        errs = {"flash_fwd": _max_err(out, want_out),
                "flash_bwd_dq": _max_err(dq, want_dq),
                "flash_bwd_dkv": max(_max_err(dk, want_dk),
                                     _max_err(dv, want_dv))}
        # worst |got - want| / (atol + rtol*|want|): <= 1 passes
        worst = {"flash_fwd": _tol_ratio(out, want_out, atol, rtol),
                 "flash_bwd_dq": _tol_ratio(dq, want_dq, atol, rtol),
                 "flash_bwd_dkv": max(_tol_ratio(dk, want_dk, atol, rtol),
                                      _tol_ratio(dv, want_dv, atol, rtol))}
        # the outputs' mean magnitude: a kernel that wrote zeros shows here
        mean_abs = {"flash_fwd": out.float().abs().mean().item(),
                    "flash_bwd_dq": dq.float().abs().mean().item(),
                    "flash_bwd_dkv": dk.float().abs().mean().item()}
        if meta is not None and rate > 0.0:
            # the shard's heads keyed as heads 0.. of an unsharded call
            # (the identity meta) must break the limit
            wrong = _tol_ratio(fa.flash_fwd(
                q, k, v, **dict(kw, meta=None))[0], want_out, atol, rtol)
            log("flash", name="flash_fwd", heads=h, dropout=rate,
                planted_fault="'identity meta'", tol_ratio=wrong)
            if not wrong > 1.0:
                raise AssertionError(f"the identity meta at h {h} is held "
                                     f"within the limit ({wrong})")
        if rate > 0.0:
            # B2 and B3 given another seed's keep mask, or delta zeroed,
            # must each break the limit on their own outputs
            for fault, seed, fdelta in (
                    ("seed + 1", kw["seed"] + 1, delta),
                    ("delta zeroed", kw["seed"], torch.zeros_like(delta))):
                fkw = dict(kw, seed=seed)
                fdq = fa.flash_bwd_dq(q, k, v, do, lse, fdelta, **fkw)
                fdk, fdv = fa.flash_bwd_dkv(q, k, v, do, lse, fdelta, **fkw)
                for name, ratio in (
                        ("flash_bwd_dq", _tol_ratio(fdq, want_dq, atol, rtol)),
                        ("flash_bwd_dkv", max(
                            _tol_ratio(fdk, want_dk, atol, rtol),
                            _tol_ratio(fdv, want_dv, atol, rtol)))):
                    log("flash", name=name, dtype=str(dtype).split(".")[-1],
                        head_dim=d, heads=h, dropout=rate,
                        planted_fault=repr(fault), tol_ratio=ratio)
                    if not ratio > 1.0:
                        raise AssertionError(
                            f"{name} d {d} h {h}: the planted fault "
                            f"{fault!r} is held within the limit ({ratio})")
                del fdq, fdk, fdv
        del want_out, want_lse, want_dq, want_dk, want_dv
        it = iter(range(1 << 30))

        def pick():
            i = next(it) % len(sets)
            return sets[i], state[i]

        calls = {
            "flash_fwd": (
                lambda: fa.flash_fwd(*pick()[0][:3], **kw),
                lambda: fa.flash_attention_fwd_ref(*pick()[0][:3], **kw)),
            "flash_bwd_dq": (
                lambda: fa.flash_bwd_dq(*_bwd_args(pick()), **kw),
                lambda: fa.flash_bwd_dq_ref(*_bwd_args(pick()), **kw)),
            "flash_bwd_dkv": (
                lambda: fa.flash_bwd_dkv(*_bwd_args(pick()), **kw),
                lambda: fa.flash_bwd_dkv_ref(*_bwd_args(pick()), **kw)),
        }
        for name, (kernel, plain) in calls.items():
            kernel_ms = cuda_ms(kernel, iters=30, warmup=3)
            plain_ms = cuda_ms(plain, iters=3, warmup=1)
            nbytes, flops = flash_bound(name, q)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
            bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
            library_ms = lib["forward" if name == "flash_fwd"
                             else "backward"]
            log("flash", name=name, dtype=str(dtype).split(".")[-1],
                head_dim=d, heads=h, meta=meta, dropout=rate,
                max_abs_err=errs[name], atol=atol,
                rtol=rtol, tol_ratio=worst[name],
                out_mean_abs=mean_abs[name],
                kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by=bound_by, bytes=nbytes, flops=flops,
                tflops=flops / kernel_ms * 1e-9,
                **({"lse_max_abs_err": lse_err}
                   if name == "flash_fwd" else {}))
            if not worst[name] <= 1.0:
                raise AssertionError(
                    f"{name} {dtype} d {d} h {h} meta {meta} dropout "
                    f"{rate}: max abs err "
                    f"{errs[name]}, {worst[name]} x (atol {atol} + rtol "
                    f"{rtol} x |plain|)")
            if name == "flash_fwd" and not lse_err <= 1e-3:
                raise AssertionError(f"flash_fwd lse err {lse_err}")
            if dtype == torch.bfloat16 and rate > 0.0:
                records[name] = {
                    "max_abs_err": errs[name], "ms": kernel_ms,
                    "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": bound_by, "library_ms": library_ms}
        fa.launches.update(before)  # checks and timing are not the path
    del sets, state
    torch.cuda.empty_cache()
    return records


def _bwd_args(picked):
    (q, k, v, do), (_, lse, delta) = picked
    return q, k, v, do, lse, delta


def _max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def _tol_ratio(got, want, atol, rtol) -> float:
    """max |got - want| / (atol + rtol*|want|); NaN anywhere gives inf."""
    err = (got.float() - want.float()).abs()
    ratio = (err / (atol + rtol * want.float().abs())).max().item()
    return ratio if math.isfinite(ratio) else math.inf


# ------------------------------------------------------------------ phase 7

def write_corpus(prefix: str, tokens: int = 400_000, seed: int = 0,
                 stride: int = 1) -> None:
    """A learnable synthetic corpus for ``GPTDataset``: documents of
    200-2000 tokens from a 2048-token sub-vocabulary (ids 0, stride, ...,
    2047·stride), where each token is followed by one of 4 fixed
    successors, written as ``{prefix}_ids.npy`` + ``{prefix}_idx.npz``."""
    rng = np.random.RandomState(seed)
    succ = rng.randint(0, 2048, size=(2048, 4)).astype(np.int32)
    docs, total = [], 0
    while total < tokens:
        n = int(rng.randint(200, 2001))
        pick = rng.randint(0, 4, size=n)
        ids = np.empty(n, np.int32)
        ids[0] = rng.randint(2048)
        for i in range(1, n):
            ids[i] = succ[ids[i - 1], pick[i]]
        docs.append(ids)
        total += n
    np.save(prefix + "_ids.npy", np.concatenate(docs) * np.int32(stride))
    np.savez(prefix + "_idx.npz",
             lens=np.array([len(d) for d in docs], np.int32))


def own_output_dir(prefix: str) -> str:
    """The override of a drive's ``Engine.save_load.output_dir``: a fresh
    directory beside the corpus at ``prefix``, deleted with the phase's
    temporary directory, so that no drive resumes from another's
    checkpoint."""
    return ("Engine.save_load.output_dir="
            + tempfile.mkdtemp(prefix="out-", dir=os.path.dirname(prefix)))


def drop_output_dirs(prefix: str) -> None:
    """Delete the drives' output directories beside the corpus at
    ``prefix`` (at the end of a phase: checkpoints take disk)."""
    root = os.path.dirname(prefix)
    for name in os.listdir(root):
        if name.startswith("out-"):
            shutil.rmtree(os.path.join(root, name))


def train_config(prefix: str, *extra):
    """The 345M pretraining config over the corpus at ``prefix``, writing
    into a directory of its own: a short warmup and a max_lr at which the
    loss moves within the drive; no width, depth, batch or sequence
    override."""
    return get_config(TRAIN_CONFIG, overrides=[
        own_output_dir(prefix), f"Data.Train.dataset.input_dir={prefix}",
        f"Engine.max_steps={TRAIN_STEPS}", "Engine.logging_freq=5",
        "Optimizer.lr.warmup_steps=5", "Optimizer.lr.max_lr=5.0e-4",
        "Optimizer.lr.min_lr=5.0e-5", "Optimizer.lr.decay_steps=1000",
        *extra])


def phase_train(prefix: str, profile: bool) -> dict:
    """The port's training path: ``Trainer.fit`` on the 345M config. Every
    layer's attention must launch B1 forward and B2, B3 backward once per
    step."""
    cfg = train_config(prefix)
    module = build_module(cfg)
    trainer = Trainer(cfg, module)
    trainer.init_state()
    gcfg = module.gpt_config
    ends = []  # an event at the end of each step's work on the stream
    inner = trainer.train_step

    def timed(batch):
        out = inner(batch)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        return out

    trainer.train_step = timed
    torch.cuda.reset_peak_memory_stats()
    loader = build_dataloader(cfg, "Train")
    for name in fa.NAMES:
        fa.launches[name] = 0
    t0 = time.perf_counter()
    trainer.fit(loader)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(fa.launches)
    losses = [float(h["loss"]) for h in trainer.history]
    steps = trainer.step
    tokens = cfg.Global.global_batch_size * cfg.Data.Train.dataset.max_seq_len
    step_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
    steady = float(np.median(step_ms[2:])) * 1e-3
    flops = trainer._flops_per_token(cfg.Data.Train.dataset.max_seq_len)
    log("train", steps=steps, layers=gcfg.num_layers,
        params_m=trainer.n_params / 1e6, dtype=str(gcfg.dtype).split(".")[-1],
        batch=cfg.Global.global_batch_size,
        seq=cfg.Data.Train.dataset.max_seq_len,
        step_ms_median=steady * 1e3, step_ms_second=step_ms[0],
        tokens_per_s=tokens / steady,
        mfu=tokens / steady * flops / peak_flops(trainer.device),
        fit_seconds=seconds, peak_mem_gb=torch.cuda.max_memory_allocated()
        / 1e9, launches=launches)
    log("train", losses=[round(x, 4) for x in losses],
        grad_norms=[round(float(h["grad_norm"]), 4)
                    for h in trainer.history])
    if steps != TRAIN_STEPS:
        raise AssertionError(f"trained {steps} of {TRAIN_STEPS} steps")
    if launches != {n: steps * gcfg.num_layers for n in fa.NAMES}:
        raise AssertionError(f"flash launches {launches} over {steps} steps "
                             f"x {gcfg.num_layers} layers")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss in {losses}")
    if not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if profile:
        phase_train_profile(trainer, loader)
    return {name: {"launches": launches[name]} for name in fa.NAMES}


def phase_train_profile(trainer, loader, steps: int = 3,
                        phase: str = "train-profile") -> None:
    """``--profile``: device time by kernel over ``steps`` train steps of
    a drive's trainer, and the device's busy share of their wall time."""
    from torch.profiler import ProfilerActivity, profile

    batch = trainer._to_device(next(iter(loader)))
    trainer.train_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(phase, prof, wall, steps, "step")


def report_profile(phase, prof, wall, n, unit) -> None:
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        # user annotations (Optimizer.step#...) span kernels listed anyway
        if (us > 0 and e.device_type.name == "CUDA"
                and not getattr(e, "is_user_annotation", False)):
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(us for us, _, _ in rows) * 1e-6
    classes = {}
    for us, _, key in rows:
        cls = next((name for name, marks in PROFILE_CLASSES
                    if any(m in key for m in marks)), "other")
        classes[cls] = classes.get(cls, 0.0) + us / n * 1e-3
    log(phase, **{f"{unit}s": n, f"{unit}_ms": wall / n * 1e3,
                  f"device_busy_ms_per_{unit}": busy / n * 1e3,
                  "device_busy_share": busy / wall,
                  f"kernels_per_{unit}": sum(c for _, c, _ in rows) / n,
                  f"ms_per_{unit}_by_class": {
                      k: round(v, 3) for k, v in sorted(
                          classes.items(), key=lambda kv: -kv[1])}})
    for us, c, key in rows[:15]:
        log(phase, **{f"ms_per_{unit}": us / n * 1e-3,
                      f"calls_per_{unit}": c / n,
                      "share_of_busy": us * 1e-6 / busy,
                      "kernel": repr(key[:90])})


# ------------------------------------------------------------------ phase 8

def _e2e_step(cfg, batch, fns=None) -> tuple:
    """One train step of a fresh trainer (seeded init) with the kernel
    wrappers named in ``fns`` ({(module, name): function}) swapped for the
    given functions: (loss, grad norm, the unclipped gradients by parameter
    name, the step's peak device memory in bytes above what was allocated
    when it began)."""
    fns = fns or {}
    saved = {key: getattr(*key) for key in fns}
    for (mod, name), fn in fns.items():
        setattr(mod, name, fn)
    try:
        trainer = Trainer(cfg, build_module(cfg))
        trainer.init_state()
        names = [n for n, _ in trainer.module.nets.named_parameters()]
        grads, clip = [], trainer.clip

        def capture(gs, norm=None):
            grads.extend(g.detach().clone()
                         for g in whole_grads(trainer, gs))
            return clip(gs, norm)

        trainer.clip = capture
        device_batch = trainer._to_device(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # weights, batch, earlier runs
        out = trainer.train_step(device_batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    if len(grads) != len(names):
        raise AssertionError(f"{len(grads)} gradients for {len(names)} "
                             "parameters")
    return (float(out["loss"]), float(out["grad_norm"]),
            dict(zip(names, grads)), peak)


def _e2e_gaps(run, ref) -> dict:
    """Gaps of ``run`` from ``ref`` in each metric of TRAIN_E2E_TOL, and
    the gradient leaf with the largest gap."""
    (loss, norm, grads, _), (loss0, norm0, grads0, _) = run, ref
    leaf = {n: (torch.linalg.vector_norm((grads[n] - g0).float())
                / torch.linalg.vector_norm(g0.float())).item()
            for n, g0 in grads0.items() if g0.any()}
    worst = max(leaf, key=leaf.get)
    return {"loss": abs(loss - loss0), "grad_norm": abs(norm - norm0) / norm0,
            "grad_leaf": leaf[worst], "worst_leaf": worst}


def planted_faults() -> dict:
    """Kernel-path faults phase 8 must catch, each a wrapper swapped in at
    run time: one kernel given seed+1 (its dropout mask then differs from
    the other kernels'), and B3 computing dV without the keep mask."""
    fwd, dq, dkv = fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv

    def reseed(fn):
        return lambda *a, **kw: fn(*a, **{**kw, "seed": kw["seed"] + 1})

    def dv_without_keep(*a, **kw):
        dk, _ = dkv(*a, **kw)
        _, dv = dkv(*a, **{**kw, "dropout_rate": 0.0})
        return dk, dv

    return {"B1 seed+1": {(fa, "flash_fwd"): reseed(fwd)},
            "B2 seed+1": {(fa, "flash_bwd_dq"): reseed(dq)},
            "B3 seed+1": {(fa, "flash_bwd_dkv"): reseed(dkv)},
            "B3 dV without keep": {(fa, "flash_bwd_dkv"): dv_without_keep}}


# the plain versions of B1-B6, keyed as _e2e_step swaps them in
PLAIN_FLASH = {(fa, "flash_fwd"): fa.flash_attention_fwd_ref,
               (fa, "flash_bwd_dq"): fa.flash_bwd_dq_ref,
               (fa, "flash_bwd_dkv"): fa.flash_bwd_dkv_ref}
PLAIN_CE = {(ce, "fused_ce_fwd"): ce.fused_ce_fwd_ref,
            (ce, "fused_ce_dh"): ce.fused_ce_dh_ref,
            (ce, "fused_ce_dw"): ce.fused_ce_dw_ref}


def phase_train_e2e(prefix: str, layers: int = 6) -> None:
    """One train step of the 345M config cut to ``layers`` layers, through
    the kernels and through their plain versions: same weights (seeded
    init), batch and dropout seeds (dropout 0.1), on the first two batches.
    Each gap must be within TRAIN_E2E_TOL; each planted fault on the first
    batch must exceed it in at least one metric."""
    cfg = train_config(prefix, f"Model.num_layers={layers}")
    loader = iter(build_dataloader(cfg, "Train"))
    batches = [next(loader), next(loader)]
    faults = planted_faults()
    for i, batch in enumerate(batches):
        ref = _e2e_step(cfg, batch, PLAIN_FLASH)
        run = _e2e_step(cfg, batch)
        gaps = _e2e_gaps(run, ref)
        log("train-e2e", layers=layers, batch=i, loss_kernel=run[0],
            loss_plain=ref[0], grad_norm_kernel=run[1],
            grad_norm_plain=ref[1], tol=TRAIN_E2E_TOL, **gaps)
        over = [m for m, tol in TRAIN_E2E_TOL.items() if not gaps[m] <= tol]
        if over or not (math.isfinite(run[0]) and math.isfinite(run[1])):
            raise AssertionError(f"train step through the kernels vs plain "
                                 f"versions, batch {i}: {gaps}")
        if i == 0:
            for name, fns in faults.items():
                gaps = _e2e_gaps(_e2e_step(cfg, batch, fns), ref)
                caught = [m for m, tol in TRAIN_E2E_TOL.items()
                          if gaps[m] > tol]
                log("train-e2e", planted_fault=repr(name), caught=caught,
                    **gaps)
                if not caught:
                    raise AssertionError(f"phase 8 misses the planted fault "
                                         f"{name!r}: {gaps}")
        del ref, run
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 9

def generation_prompts(vocab: int, seed: int = 4) -> tuple:
    """Phase 10's batch: 8 prompts of GEN_PROMPT_LENS tokens left-padded
    (with id 0) to the longest; (ids [8, 312] int64, mask int32)."""
    rng = np.random.RandomState(seed)
    width = max(GEN_PROMPT_LENS)
    ids = np.zeros((len(GEN_PROMPT_LENS), width), np.int64)
    mask = np.zeros(ids.shape, np.int32)
    for r, n in enumerate(GEN_PROMPT_LENS):
        ids[r, width - n:] = rng.randint(0, vocab, n)
        mask[r, width - n:] = 1
    return ids, mask


def contiguous_bound(case, dtype, quant: bool) -> tuple:
    """(bytes, flops): each live K/V vector read once (d bytes and an fp32
    scale at int8), q read and out written once, the window bounds read."""
    q = case["q"]
    b, _, h, d = q.shape
    item = torch.tensor([], dtype=dtype).element_size()
    live = int((~case["dead"]).sum())
    vector = d + 4 if quant else d * item
    return (live * h * vector * 2 + 2 * b * h * d * item + 8 * b,
            live * h * 4 * d)


def planted_decode_faults(q, k, v, k_scale, v_scale, *, end, starts,
                          block_k, tables=None) -> dict:
    """Outputs of the plain version with one rounding fault each, which
    phase 3's and 9's bf16 limit must catch: p kept in fp32, p rounded against
    the final max instead of each tile's running max, and (int8) K/V
    dequantized to fp32 instead of q's dtype. ``tables`` gathers each
    row's logical buffer from paged pools first."""
    if tables is not None:
        k, v = (da.paged_gather_kv(t, tables) for t in (k, v))
        if k_scale is not None:
            k_scale, v_scale = (da.paged_gather_kv(t, tables)
                                for t in (k_scale, v_scale))

    def kv(dtype):
        if k_scale is None:
            return k.to(dtype), v.to(dtype)
        return (dequantize_kv(k, k_scale, dtype),
                dequantize_kv(v, v_scale, dtype))

    def window(q, kv, block_k):
        return da._window_attention(q, *kv, end=end, starts=starts,
                                    block_k=block_k)

    faults = {
        "p not rounded": window(q.float(), [t.float() for t in kv(q.dtype)],
                                block_k).to(q.dtype),
        "p against the final max": window(q, kv(q.dtype), k.shape[1])}
    if k_scale is not None:
        faults["K/V dequantized to fp32"] = window(q, kv(torch.float32),
                                                   block_k)
    return faults


def phase_decode_kernels() -> dict:
    """B7, B9 and B10 each against its plain version at GPT-345M decode
    shapes, bf16 and fp32. Returns, by kernel name, the bf16 records of
    the main path's shapes: B7/B9 on phase 10's cache, B10 on phase 3's
    pools."""
    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, cache_len, starts, ends in contiguous_cases():
            block_k = da.fit_decode_blocks(cache_len)[0]
            for quant in (False, True):
                name = "decode_q8" if quant else "decode"
                case = contiguous_case(dtype, cache_len, starts, ends,
                                       quant=quant)
                q, caches = case["q"], case["caches"]
                kw = dict(end=case["ends"], starts=case["starts"])

                def run(i, fn=da.decode_attention):
                    c = caches[i]
                    return fn(q, c["k"], c["v"], k_scale=c["k_scale"],
                              v_scale=c["v_scale"], **kw)

                def plain(i):
                    return run(i, da.decode_attention_ref)

                def faults(c=caches[0]):
                    return planted_decode_faults(
                        q, c["k"], c["v"], c["k_scale"], c["v_scale"],
                        block_k=block_k, **kw)

                lib_kvs = [(dequantize_kv(c["k"], c["k_scale"], dtype),
                            dequantize_kv(c["v"], c["v_scale"], dtype))
                           if quant else (c["k"], c["v"]) for c in caches]
                nbytes, flops = contiguous_bound(case, dtype, quant)
                rec = check_and_time(
                    name, label, dtype, run, plain, lib_kvs, case, nbytes,
                    flops, faults=faults if dtype == torch.bfloat16 else None,
                    cache_len=cache_len, block_k=block_k)
                del case, caches, lib_kvs
                if dtype == torch.bfloat16 and label == "generate":
                    records[name] = rec
        # B10 on phase 3's pools, quantized, their copies repeated until
        # they hold twice the L2
        case = decode_case(dtype)
        nbytes, flops = decode_bound(case, dtype, quant=True)
        pools = [(quantize_kv(k.float()), quantize_kv(v.float()))
                 for k, v in case["pools"]]
        copies = rotation_copies(nbytes)
        case["pools"] = pools = [
            pools[i] if i < len(pools) else
            tuple((w.clone(), sc.clone()) for w, sc in pools[i % len(pools)])
            for i in range(max(copies, len(pools)))]
        q = case["q"]
        kw = dict(tables=case["tables"], end=case["ends"],
                  starts=case["starts"])

        def run(i, fn=da.paged_decode_attention):
            (k, ks), (v, vs) = pools[i]
            return fn(q, k, v, k_scale=ks, v_scale=vs, **kw)

        def plain(i):
            return run(i, da.paged_decode_attention_ref)

        def faults():
            (k, ks), (v, vs) = pools[0]
            return planted_decode_faults(q, k, v, ks, vs,
                                         block_k=case["page_size"], **kw)

        lib_kvs = [(dequantize_kv(da.paged_gather_kv(k, case["tables"]),
                                  da.paged_gather_kv(ks, case["tables"]),
                                  dtype),
                    dequantize_kv(da.paged_gather_kv(v, case["tables"]),
                                  da.paged_gather_kv(vs, case["tables"]),
                                  dtype))
                   for (k, ks), (v, vs) in pools]
        rec = check_and_time(
            "paged_decode_q8", "phase 3 pools", dtype, run, plain, lib_kvs,
            case, nbytes, flops,
            faults=faults if dtype == torch.bfloat16 else None,
            page_size=case["page_size"])
        if dtype == torch.bfloat16:
            records["paged_decode_q8"] = rec
        del case, pools, lib_kvs
        torch.cuda.empty_cache()
    return records


# ----------------------------------------------------------------- phase 10

def generation_module(*overrides):
    """``build_module`` on the generation config at bf16 (plus
    ``overrides``), weights from ``init_params(seed=GEN_SEED)``."""
    conf = get_config(CONFIG, overrides=[GEN_BF16, *overrides])
    module = build_module(conf)
    module.set_state(init_params(module.gpt_config, seed=GEN_SEED))
    return module


@contextlib.contextmanager
def watch_decode_steps(attention=None):
    """For the ``generate()`` calls inside: count the cached forwards
    (``generation.decode_step``: the prefill and each decode step), record
    a CUDA event at the end of each, keep the first decode step's logits,
    and, given ``attention``, run decode attention through it."""
    calls = {"n": 0, "events": [], "first": None}
    inner = gen.decode_step

    def watched(model, cache, ids, *args, **kw):
        logits, cache = inner(model, cache, ids, *args, **kw)
        calls["n"] += 1
        calls["events"].append(torch.cuda.Event(enable_timing=True))
        calls["events"][-1].record()
        if ids.shape[1] == 1 and calls["first"] is None:
            calls["first"] = logits[:, -1].float().clone()
        return logits, cache

    gen.decode_step = watched
    if attention is not None:
        gpt_model.decode_attention = attention
    try:
        yield calls
    finally:
        gen.decode_step = inner
        gpt_model.decode_attention = da.decode_attention


def run_generate(module, ids, mask, gen_cfg, label, name, *, generator=None,
                 attention=None) -> dict:
    """One ``generate_ids`` call with ``gen_cfg``; checks that every decode
    step launched kernel ``name`` once per layer (and no other decode
    kernel) unless ``attention`` replaces it, and logs tokens/s and ms per
    decode step (CUDA events between the ends of consecutive steps)."""
    module.generation_cfg = gen_cfg
    layers = module.gpt_config.num_layers
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with watch_decode_steps(attention) as calls:
        out = module.generate_ids(ids, attention_mask=mask,
                                  generator=generator)  # numpy: synchronised
    seconds = time.perf_counter() - t0
    launches = dict(da.launches)
    steps = calls["n"] - 1
    ev = calls["events"]
    step_ms = [a.elapsed_time(b) for a, b in zip(ev[1:], ev[2:])]
    new = out[:, ids.shape[1]:]
    vocab = module.gpt_config.vocab_size
    log("generate", run=repr(label), kv=module.gpt_config.decode_kv_dtype,
        strategy=gen_cfg.decode_strategy, rows=len(out), new_tokens=new.shape[1],
        decode_steps=steps, launches={n: c for n, c in launches.items() if c},
        seconds=seconds, tokens_per_s=new.size / seconds,
        decode_step_ms_median=float(np.median(step_ms)),
        decode_step_ms_p90=float(np.percentile(step_ms, 90)),
        eos_rows=int((new == gen_cfg.eos_token_id).any(1).sum()))
    want = {n: 0 for n in da.NAMES}
    if attention is None:
        want[name] = steps * layers
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    if not (steps >= 1 and new.shape[1] == gen_cfg.max_length
            and new.min() >= 0 and new.max() < vocab):
        raise AssertionError(f"{label}: {steps} steps, tokens {new}")
    if not np.array_equal(out[:, :ids.shape[1]], ids):
        raise AssertionError(f"{label}: the prompt was not kept")
    return {"tokens": out, "steps": steps, "first": calls["first"],
            "launches": launches[name]}


GEN_PLAIN_NEW = 48  # the plain-version runs' new tokens (200 until cut
# for phases 41-43): they hold the first step's logits
GEN_LAYERS = 12  # phase 10's depth: the generation yaml's 24 cut for time
# (PR 20)


def phase_generate(profile: bool) -> dict:
    """The port's generation path, bf16 KV then int8 KV, each greedy
    through the kernel and through the plain version (first decode step's
    logits within LOGIT_TOL), and bf16 with the config's own sampling.
    Returns the main path's launch counts of B7 and B9."""
    out = {}
    greedy_tokens = {}
    for kv, name in ((None, "decode"), ("int8", "decode_q8")):
        module = generation_module(
            f"Model.num_layers={GEN_LAYERS}",
            *([] if kv is None else [f"Model.decode_kv_dtype={kv}"]))
        cfg = module.gpt_config
        ids, mask = generation_prompts(cfg.vocab_size)
        base = module.generation_cfg
        greedy = dataclasses.replace(base, decode_strategy="greedy")
        run_generate(module, ids, mask,
                     dataclasses.replace(greedy, max_length=4), "warm-up",
                     name)
        tag = "bf16 kv" if kv is None else "int8 kv"
        kernel = run_generate(module, ids, mask, greedy, f"{tag} greedy",
                              name)
        launches = kernel["launches"]
        if kv is None:
            sampled = run_generate(
                module, ids, mask, base, f"{tag} sampling", name,
                generator=torch.Generator(device=DEVICE).manual_seed(7))
            launches += sampled["launches"]
        plain = run_generate(
            module, ids, mask,
            dataclasses.replace(greedy, max_length=GEN_PLAIN_NEW),
            f"{tag} greedy plain", name, attention=da.decode_attention_ref)
        err = (kernel["first"] - plain["first"]).abs().max().item()
        width = ids.shape[1]
        agree = [quant_parity_frac(a[width:width + GEN_PLAIN_NEW],
                                   b[width:]) for a, b in
                 zip(kernel["tokens"], plain["tokens"])]
        log("generate", kv=tag, first_step_logits_max_abs_err=err,
            tol=LOGIT_TOL, greedy_common_prefix_frac_kernel_vs_plain=float(
                np.mean(agree)), per_row=[round(a, 3) for a in agree])
        if not (math.isfinite(err) and err <= LOGIT_TOL):
            raise AssertionError(f"{tag}: first decode step logits differ "
                                 f"by {err}")
        greedy_tokens[tag] = kernel["tokens"][:, width:]
        out[name] = {"launches": launches}
        if profile and kv is None:
            phase_generate_profile(module, ids, mask, greedy)
        del module
        gc.collect()
        torch.cuda.empty_cache()
    frac = [quant_parity_frac(a, b) for a, b in
            zip(greedy_tokens["int8 kv"], greedy_tokens["bf16 kv"])]
    log("generate", int8_vs_bf16_greedy_quant_parity_frac=float(np.mean(frac)),
        per_row=[round(f, 3) for f in frac])
    return out


def phase_generate_profile(module, ids, mask, greedy, steps: int = 20):
    """``--profile``: device time by kernel over ``steps`` steady decode
    steps of a greedy ``generate()`` (sampling included), and the device's
    busy share of their wall time."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    inner = gen.decode_step
    state = {"n": 0}

    def profiled(*args, **kw):
        if state["n"] == 5:
            torch.cuda.synchronize()
            prof.start()
            state["t0"] = time.perf_counter()
        result = inner(*args, **kw)
        state["n"] += 1
        if state["n"] == 5 + steps:
            torch.cuda.synchronize()
            state["wall"] = time.perf_counter() - state["t0"]
            prof.stop()
        return result

    module.generation_cfg = dataclasses.replace(greedy, max_length=steps + 10)
    gen.decode_step = profiled
    try:
        module.generate_ids(ids, attention_mask=mask)
    finally:
        gen.decode_step = inner
    report_profile("gen-profile", prof, state["wall"], steps, "step")


# ----------------------------------------------------------------- phase 11

def phase_int8_serving(bf16_kv_bytes: int) -> dict:
    """Phase 4's requests through an int8-KV engine (B10)."""
    engine, cfg = build_engine(kv_dtype="int8")
    rec = phase_serving(engine, cfg, "int8-serving")
    d = cfg.head_dim
    ratio = rec["kv_cache_bytes"] / bf16_kv_bytes
    log("int8-serving", kv_cache_bytes_int8=rec["kv_cache_bytes"],
        kv_cache_bytes_bf16=bf16_kv_bytes, ratio=ratio,
        want=(d + 4) / (2 * d))
    if rec["kv_cache_bytes"] * 2 * d != bf16_kv_bytes * (d + 4):
        raise AssertionError(f"int8 pools take {ratio} of the bf16 bytes")
    del engine
    return {"launches": rec["launches"]}


# ----------------------------------------------------------------- phase 12

def ce_inputs(dtype, n: int, e: int, v: int, seed: int = 0,
              w_std: float = 0.05) -> tuple:
    """h [n, E] ~ N(0, 1) (as the final LayerNorm hands it over), W [V, E]
    ~ N(0, w_std²) (0.05: scores of std ~2 at E 2048), int32 labels with
    -1, 0, V - 1 and V first, and the masked-mean cotangent g = mask / Σ
    mask over a random 0/1 mask (zeros included), on the card."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    h = torch.randn(n, e, generator=g, device=DEVICE).to(dtype)
    w = (torch.randn(v, e, generator=g, device=DEVICE) * w_std).to(dtype)
    labels = torch.randint(0, v, (n,), generator=g, device=DEVICE,
                           dtype=torch.int32)
    labels[:4] = torch.tensor([-1, 0, v - 1, v], dtype=torch.int32)
    mask = (torch.rand(n, generator=g, device=DEVICE) > 0.2).float()
    return h, w, labels, mask / mask.sum()


def ce_bound(name: str, h: torch.Tensor, w: torch.Tensor) -> tuple:
    """(bytes, flops) of one call: h, W and the int32 labels read once
    (and the fp32 a, b, lse in the backward), the outputs written once
    (fp32 loss and lse; dh or dW in the operands' dtype); 2 flops per
    multiply-add of s = h·Wᵀ, and of dl times an operand in the
    backward."""
    n, e = h.shape
    v = w.shape[0]
    operands = (n + v) * e * h.element_size() + 4 * n
    product = 2 * n * v * e
    if name == "ce_fwd":
        return operands + 8 * n, product
    out = (n if name == "ce_dh" else v) * e * h.element_size()
    return operands + 12 * n + out, 2 * product


def library_ce_times(h, w, labels, g) -> dict:
    """The logits path as a sequence of PyTorch calls, a yardstick only:
    forward = one GEMM with fp32 output, logsumexp and a gather of the
    label logit; backward = softmax minus the one-hot times g, the cast to
    the operands' dtype, and the two products (dh and dW), from the saved
    logits; dh and dw = the same function as B5 or B6 alone: the logits
    GEMM again, softmax minus the one-hot times g, the cast, and the one
    product."""
    lab = labels.long().clamp(0, w.shape[0] - 1)[:, None]
    rows = torch.arange(h.shape[0], device=h.device)

    def logits():
        if h.dtype == torch.bfloat16:
            return torch.mm(h, w.t(), out_dtype=torch.float32)
        return torch.mm(h, w.t())

    def forward():
        s = logits()
        return torch.logsumexp(s, -1) - s.gather(1, lab)[:, 0]

    s = logits()

    def dl_of(scores):
        dl = torch.softmax(scores, -1)
        dl[rows, lab[:, 0]] -= 1.0
        return (dl * g[:, None]).to(h.dtype)

    def backward():
        dl = dl_of(s)
        return dl @ w, dl.t() @ h

    times = {"forward": cuda_ms(forward, iters=10, warmup=2),
             "backward": cuda_ms(backward, iters=10, warmup=2)}
    del s
    times["dh"] = cuda_ms(lambda: dl_of(logits()) @ w, iters=10, warmup=2)
    times["dw"] = cuda_ms(lambda: dl_of(logits()).t() @ h, iters=10,
                          warmup=2)
    return times


def planted_ce_faults(h, w, labels, g, lse) -> dict:
    """Outputs of the plain versions with one fault each, which phase 12's
    bf16 limit must catch, by (fault, output): dl kept in fp32 before its
    product; the running sum not rescaled when the max moves; the label
    column off by one. The grads are held by the same flip-aware check as
    the kernels' (readings of the kernels' own dl), so a fault passes
    only where the kernels' dl would explain it."""
    args = (h, w, labels, g, -g, lse)
    loss_nr, lse_nr = ce._fwd_plain(h, w, labels, rescale=False)
    off = labels + 1
    return {
        ("dl kept in fp32", "dh"): ce._grad_plain(
            *args, wrt="h", dl_dtype=torch.float32),
        ("dl kept in fp32", "dW"): ce._grad_plain(
            *args, wrt="w", dl_dtype=torch.float32),
        ("sum not rescaled", "loss"): loss_nr,
        ("sum not rescaled", "lse"): lse_nr,
        ("label column off by one", "loss"): ce.fused_ce_fwd_ref(
            h, w, off)[0],
        ("label column off by one", "dh"): ce.fused_ce_dh_ref(
            h, w, off, g, -g, lse),
        ("label column off by one", "dW"): ce.fused_ce_dw_ref(
            h, w, off, g, -g, lse)}


def ce_readings(h, w, labels, a, b, lse, wrt: str, group=None):
    """The readings ``ce.grads_gaps`` takes of the bf16 B5 (``wrt="h"``) or
    B6's own dl on these inputs (computed at the first call, then kept).
    With an mp ``group``, those of the sum over the group of B5's partial
    dh: every rank's rows must be sound, the product is the sum of the
    ranks' fp64 products, and its scale their summed magnitudes plus the
    sum's own (as ``ce.ce_gaps`` scales the summed dh). Those take
    collectives, so they are made here, on every rank at once, and not
    when ``ce.grads_gaps`` first asks (only where some element is beyond
    the bound, which may differ by rank)."""
    import torch.distributed as dist

    kept = []

    def readings():
        if not kept:
            kept.append(ce.kernel_readings(h, w, labels, a, b, lse, wrt))
        return kept[0]

    if group is None:
        return readings
    rows_ok, product = readings()
    ok = rows_ok.to(torch.int32)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=group)
    total, scale = product.clone(), product.abs()
    dist.all_reduce(total, group=group)
    dist.all_reduce(scale, group=group)
    kept[0] = (ok.bool(), total, scale + total.abs())
    return readings


def phase_ce() -> dict:
    """B4, B5 and B6 each against its plain version at GPT-1.3B training
    shapes (bf16) and at a small fp32 case, with kernel, plain, library
    and bound times; the bf16 limit must catch each planted fault. The
    backward kernels and their plain versions take the kernel's lse.
    Returns the bf16 records by kernel name."""
    records = {}
    for dtype, shape in CE_SHAPES.items():
        got = ce_case(dtype, *shape)
        if dtype == torch.bfloat16:
            records = got
    return records


def ce_case(dtype, n: int, e: int, v: int, strict: bool = False,
            w_std: float = 0.05) -> dict:
    """Phase 12 at one dtype and (tokens, hidden, vocab) over W ~ N(0,
    w_std²); returns the bf16 records by kernel name. ``strict`` (phase
    29) launches B5 and B6 twice too (B4 always is): the bits must be
    equal."""
    records = {}
    h, w, labels, g = ce_inputs(dtype, n, e, v, w_std=w_std)
    before = dict(ce.launches)
    loss, lse = ce.fused_ce_fwd(h, w, labels)
    again = ce.fused_ce_fwd(h, w, labels)
    dh = ce.fused_ce_dh(h, w, labels, g, -g, lse)
    dw = ce.fused_ce_dw(h, w, labels, g, -g, lse)
    torch.cuda.synchronize()
    if {k: ce.launches[k] - before[k] for k in ce.NAMES} != {
            "ce_fwd": 2, "ce_dh": 1, "ce_dw": 1}:
        raise AssertionError(f"ce launches {ce.launches} from {before}")
    if not (torch.equal(loss, again[0]) and torch.equal(lse, again[1])):
        raise AssertionError(f"ce_fwd {dtype}: two launches on the same "
                             "inputs differ")
    if strict:
        same = [torch.equal(dh, ce.fused_ce_dh(h, w, labels, g, -g, lse)),
                torch.equal(dw, ce.fused_ce_dw(h, w, labels, g, -g, lse))]
        log("ce", tokens=n, hidden=e, vocab=v, twice_equal_dh_dw=same)
        if not all(same):
            raise AssertionError(f"ce_dh/ce_dw at E {e}: two launches "
                                 f"differ ({same})")
    del again
    want_loss, want_lse = ce.fused_ce_fwd_ref(h, w, labels)
    want = {"loss": want_loss, "lse": want_lse,
            "dh": ce.fused_ce_dh_ref(h, w, labels, g, -g, lse),
            "dW": ce.fused_ce_dw_ref(h, w, labels, g, -g, lse)}
    got = {"loss": loss, "lse": lse, "dh": dh, "dW": dw}
    kind = {"loss": "stats", "lse": "stats", "dh": "grads",
            "dW": "grads"}
    readings = {"dh": ce_readings(h, w, labels, g, -g, lse, "h"),
                "dW": ce_readings(h, w, labels, g, -g, lse, "w")}

    def gaps_of(out, k):
        # bf16 grads: aware of dl's rounding flips (ce.grads_gaps)
        if dtype == torch.bfloat16 and kind[k] == "grads":
            return ce.grads_gaps(out, want[k], readings[k])
        return ce.ce_gaps(out, want[k], dtype, kind[k])

    gaps = {k: gaps_of(got[k], k) for k in got}
    for k, gap in gaps.items():
        log("ce", dtype=str(dtype).split(".")[-1], output=k,
            tol=ce.CE_TOL[dtype][kind[k]],
            mean_abs=got[k].float().abs().mean().item(), **gap)
    caught = {}  # fault -> whether any of its outputs breaks the limit
    if dtype == torch.bfloat16:
        for (fault, k), out in planted_ce_faults(h, w, labels, g,
                                                 lse).items():
            gap = gaps_of(out, k)
            log("ce", planted_fault=repr(fault), output=k, **gap)
            caught[fault] = caught.get(fault, False) or not gap["ok"]
    bad = [k for k, gap in gaps.items() if not gap["ok"]]
    if bad or not torch.equal(loss[[0, 3]], lse[[0, 3]]):
        raise AssertionError(f"ce kernels vs plain {dtype}: {bad} "
                             f"{gaps}; loss/lse of unmatched labels "
                             f"{loss[[0, 3]]} {lse[[0, 3]]}")
    missed = [fault for fault, hit in caught.items() if not hit]
    if missed:
        raise AssertionError(f"the ce limit misses the planted faults "
                             f"{missed}")
    del want, got, readings
    torch.cuda.empty_cache()
    lib = library_ce_times(h, w, labels, g)
    calls = {
        "ce_fwd": (lambda: ce.fused_ce_fwd(h, w, labels),
                   lambda: ce.fused_ce_fwd_ref(h, w, labels),
                   lib["forward"], ("loss", "lse")),
        "ce_dh": (lambda: ce.fused_ce_dh(h, w, labels, g, -g, lse),
                  lambda: ce.fused_ce_dh_ref(h, w, labels, g, -g, lse),
                  lib["dh"], ("dh",)),
        "ce_dw": (lambda: ce.fused_ce_dw(h, w, labels, g, -g, lse),
                  lambda: ce.fused_ce_dw_ref(h, w, labels, g, -g, lse),
                  lib["dw"], ("dW",)),
    }
    library = {"ce_fwd": "logits path forward",
               "ce_dh": "logits path dh alone (GEMM, softmax, one "
                        "product)",
               "ce_dw": "logits path dW alone (GEMM, softmax, one "
                        "product)"}
    for name, (kernel, plain, library_ms, outs) in calls.items():
        kernel_ms = cuda_ms(kernel, iters=10, warmup=2)
        plain_ms = cuda_ms(plain, iters=2, warmup=1)
        nbytes, flops = ce_bound(name, h, w)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        err = max(gaps[k]["max_abs_err"] for k in outs)
        log("ce", name=name, dtype=str(dtype).split(".")[-1], tokens=n,
            hidden=e, vocab=v, max_abs_err=err, kernel_ms=kernel_ms,
            plain_ms=plain_ms, library_ms=library_ms,
            library=library[name],
            library_backward_ms=lib["backward"],
            bound_ms=max(bytes_ms, ops_ms), bound_by=bound_by,
            bytes=nbytes, flops=flops, tflops=flops / kernel_ms * 1e-9,
            share_of_bound=max(bytes_ms, ops_ms) / kernel_ms)
        if dtype == torch.bfloat16:
            records[name] = {
                "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms), "bound_by": bound_by,
                "library_ms": library_ms}
            if name != "ce_fwd":
                records[name]["library_backward_ms"] = lib["backward"]
    ce.launches.update(before)  # checks and timing are not the path
    del h, w, labels, g, loss, lse, dh, dw
    torch.cuda.empty_cache()
    return records


# ----------------------------------------------------------------- phase 13

def train_13b_config(prefix: str, *extra):
    """The 1.3B single-card config with ``Model.fused_ce=True`` over the
    corpus at ``prefix`` (both splits), writing into a directory of its
    own: a short warmup and a max_lr at which the loss moves within the
    drive, evaluation every EVAL_FREQ steps over EVAL_ITERS batches; no
    width, depth, batch or sequence override."""
    return get_config(TRAIN_13B_CONFIG, overrides=[
        own_output_dir(prefix), f"Data.Train.dataset.input_dir={prefix}",
        f"Data.Eval.dataset.input_dir={prefix}", "Model.fused_ce=True",
        f"Engine.max_steps={TRAIN_13B_STEPS}", "Engine.logging_freq=5",
        f"Engine.eval_freq={EVAL_FREQ}", f"Engine.eval_iters={EVAL_ITERS}",
        "Optimizer.lr.warmup_steps=5", "Optimizer.lr.max_lr=3.0e-4",
        "Optimizer.lr.min_lr=3.0e-5", "Optimizer.lr.decay_steps=1000",
        *extra])


def zero_train_launches() -> None:
    """Set B1-B6's launch counts to 0 (just before a path)."""
    for mod in (fa, ce):
        for name in mod.NAMES:
            mod.launches[name] = 0


def phase_train_13b(prefix: str, profile: bool) -> dict:
    """The port's 1.3B training path: ``Trainer.fit`` with the Eval loader
    on the 1.3B config under fused_ce and full recompute. Returns the
    launch counts of B1-B6."""
    cfg = train_13b_config(prefix)
    module = build_module(cfg)
    gcfg = module.gpt_config
    if not (gcfg.fused_ce and gcfg.use_recompute
            and gcfg.recompute_granularity == "full"):
        raise AssertionError(f"the 1.3B config resolved to {gcfg}")
    trainer = Trainer(cfg, module)
    trainer.init_state()
    ends, evals = [], []  # an event at the end of each step; eval records
    step, evaluate = trainer.train_step, trainer.evaluate

    def timed(batch):
        out = step(batch)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        return out

    def watched(data, epoch=0):
        t0 = time.perf_counter()
        loss = evaluate(data, epoch)
        torch.cuda.synchronize()
        evals.append({"after_step": len(ends), "loss": loss,
                      "seconds": time.perf_counter() - t0})
        return loss

    trainer.train_step, trainer.evaluate = timed, watched
    loader = build_dataloader(cfg, "Train")
    eval_loader = build_dataloader(cfg, "Eval")
    if len(eval_loader) < EVAL_ITERS:
        raise AssertionError(f"the Eval split holds {len(eval_loader)} "
                             f"batches, fewer than {EVAL_ITERS}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_train_launches()
    t0 = time.perf_counter()
    trainer.fit(loader, eval_loader)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {**fa.launches, **ce.launches}
    steps, layers = trainer.step, gcfg.num_layers
    eval_batches = len(evals) * EVAL_ITERS
    losses = [float(h["loss"]) for h in trainer.history]
    seq = cfg.Data.Train.dataset.max_seq_len
    tokens = cfg.Global.global_batch_size * seq
    # intervals between the ends of consecutive steps, but not across an
    # evaluation
    after_eval = {e["after_step"] for e in evals}
    step_ms = [a.elapsed_time(b) for i, (a, b) in
               enumerate(zip(ends, ends[1:]), start=1) if i not in after_eval]
    steady = float(np.median(step_ms[2:])) * 1e-3
    flops = trainer._flops_per_token(seq)
    log("train-1.3b", steps=steps, layers=layers,
        params_m=trainer.n_params / 1e6, dtype=str(gcfg.dtype).split(".")[-1],
        batch=cfg.Global.global_batch_size, seq=seq,
        recompute=gcfg.recompute_granularity, fused_ce=gcfg.fused_ce,
        step_ms_median=steady * 1e3, step_ms_second=step_ms[0],
        tokens_per_s=tokens / steady,
        mfu=tokens / steady * flops / peak_flops(trainer.device),
        fit_seconds=seconds,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches)
    log("train-1.3b", losses=[round(x, 4) for x in losses],
        grad_norms=[round(float(h["grad_norm"]), 4)
                    for h in trainer.history],
        evals=[{k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in e.items()} for e in evals])
    want = {"ce_fwd": steps + eval_batches, "ce_dh": steps, "ce_dw": steps,
            "flash_fwd": layers * (2 * steps + eval_batches),
            "flash_bwd_dq": layers * steps, "flash_bwd_dkv": layers * steps}
    if steps != TRAIN_13B_STEPS or len(evals) != TRAIN_13B_STEPS // EVAL_FREQ:
        raise AssertionError(f"trained {steps} steps with {len(evals)} "
                             "evaluations")
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss in {losses}")
    if not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if not all(e["loss"] is not None and math.isfinite(e["loss"])
               for e in evals):
        raise AssertionError(f"eval losses {evals}")
    if profile:
        phase_train_profile(trainer, loader, phase="train-1.3b-profile")
    return launches


# ----------------------------------------------------------------- phase 14

def phase_train_13b_e2e(prefix: str, layers: int = 4) -> None:
    """One train step of the 1.3B config cut to ``layers`` layers, on its
    first two batches, five ways: (a) through the kernels, (b) through the
    plain versions of B1-B6, (c) through the logits path (fused_ce off),
    (d) without recompute, (e) with layer 0 opted out of recompute. (b)
    and (c) must lie within TRAIN_13B_E2E_TOL of (a); (d) and (e) must
    equal (a), or lie within those limits if the card's GEMMs do not
    repeat bit for bit (logged as ``bitwise``). (a)'s peak memory must lie
    at least one fp32 logits tensor below (c)'s; each planted kernel-path
    fault on the first batch must break a limit against (b)."""
    depth = f"Model.num_layers={layers}"
    cfgs = {"a kernels": train_13b_config(prefix, depth),
            "c logits": train_13b_config(prefix, depth, "Model.fused_ce=False"),
            "d no recompute": train_13b_config(prefix, depth,
                                               "Model.use_recompute=False"),
            "e layer 0 not recomputed": train_13b_config(
                prefix, depth, "Model.no_recompute_layers=[0]")}
    loader = iter(build_dataloader(cfgs["a kernels"], "Train"))
    batches = [next(loader), next(loader)]
    tokens = batches[0]["tokens"].size
    logits_bytes = tokens * cfgs["a kernels"].Model.vocab_size * 4
    fwd, dw = ce.fused_ce_fwd, ce.fused_ce_dw

    def dw_without_onehot(h, w, labels, a, b, lse):
        return dw(h, w, labels, a, torch.zeros_like(b), lse)

    faults = {"B6 without the one-hot term": {
                  (ce, "fused_ce_dw"): dw_without_onehot},
              "B4 given labels + 1": {
                  (ce, "fused_ce_fwd"): lambda h, w, lab: fwd(h, w, lab + 1)}}
    for i, batch in enumerate(batches):
        run = _e2e_step(cfgs["a kernels"], batch)
        ref = _e2e_step(cfgs["a kernels"], batch, {**PLAIN_FLASH, **PLAIN_CE})
        runs = {"b plain": ref}
        for label in ("c logits", "d no recompute",
                      "e layer 0 not recomputed"):
            runs[label] = _e2e_step(cfgs[label], batch)
        for label, other in runs.items():
            gaps = _e2e_gaps(other, run)
            bitwise = (other[0] == run[0] and other[1] == run[1] and all(
                torch.equal(g, run[2][n]) for n, g in other[2].items()))
            log("train-1.3b-e2e", layers=layers, batch=i, run=repr(label),
                loss_this=other[0], loss_kernels=run[0],
                grad_norm_this=other[1], grad_norm_kernels=run[1],
                step_peak_gb_this=other[3] / 1e9,
                step_peak_gb_kernels=run[3] / 1e9, bitwise=bitwise,
                tol=TRAIN_13B_E2E_TOL, **gaps)
            over = [m for m, tol in TRAIN_13B_E2E_TOL.items()
                    if not gaps[m] <= tol]
            if over or not (math.isfinite(other[0])
                            and math.isfinite(other[1])):
                raise AssertionError(f"1.3B step, batch {i}, {label} vs "
                                     f"the kernels: {gaps}")
        saved = runs["c logits"][3] - run[3]
        log("train-1.3b-e2e", batch=i, peak_mem_saved_gb=saved / 1e9,
            want_at_least_gb=logits_bytes / 1e9)
        if saved < logits_bytes:
            raise AssertionError(f"the fused path saved {saved} bytes of "
                                 f"peak memory, under {logits_bytes}")
        if i == 0:
            for name, fns in faults.items():
                gaps = _e2e_gaps(_e2e_step(cfgs["a kernels"], batch, fns), ref)
                caught = [m for m, tol in TRAIN_13B_E2E_TOL.items()
                          if gaps[m] > tol]
                log("train-1.3b-e2e", planted_fault=repr(name),
                    caught=caught, **gaps)
                if not caught:
                    raise AssertionError(f"phase 14 misses the planted "
                                         f"fault {name!r}: {gaps}")
        del run, ref, runs
        gc.collect()
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 15
# the context-parallel drive: the long-context yaml at cp 2, seq 16384, one
# sequence per step; its ring pairs are [1, 4096, 16, 128] bf16
CP_CONFIG = os.path.join(
    ROOT, "configs/nlp/gpt/pretrain_gpt_1.3B_longcontext_cp8.yaml")
CP_STEPS, CP_EVAL_ITERS = 6, 1
CP_TRAIN_LAYERS = 1  # phase 17's depth: the yaml's 24 cut for time (2
# until cut for phases 49-50)
BLOCK_KERNEL = {"block_fwd_lse": "flash_fwd", "block_dq": "flash_bwd_dq",
                "block_dkv": "flash_bwd_dkv"}


def cp_pair_bound(name: str, q: torch.Tensor, causal: bool) -> tuple:
    """(bytes, flops) of one pair call: phase 6's count over the pair's
    live cells, s(s+1)/2 on the diagonal and s·s across blocks."""
    nbytes, flops = flash_bound(BLOCK_KERNEL[name], q)
    if not causal:
        s = q.shape[1]
        flops = flops * s // (s + 1) * 2
    return nbytes, flops


def _bh(x: torch.Tensor) -> torch.Tensor:
    """[b, s, h] fp32 -> contiguous [b*h, s] (the plain versions' rows)."""
    b, s, h = x.shape
    return x.transpose(1, 2).reshape(b * h, s).contiguous()


def _pair_plain(q, k, v, do, meta, causal, rate, kv_len, lse, delta):
    """The plain versions of B11's three entries (the plain B1-B3 with the
    same meta): out, lse [b, s, h], and dq, dk, dv from the given lse and
    delta ([b, s, h], the kernels', as phase 6 feeds both sides)."""
    b, s, h, _ = q.shape
    kw = dict(causal=causal, dropout_rate=rate, seed=CP_SEED, meta=meta,
              kv_lens=torch.full((b,), kv_len, dtype=torch.int32,
                                 device=q.device))
    out, plain_lse = fa.flash_attention_fwd_ref(q, k, v, **kw)
    dq = fa.flash_bwd_dq_ref(q, k, v, do, _bh(lse), _bh(delta), **kw)
    dk, dv = fa.flash_bwd_dkv_ref(q, k, v, do, _bh(lse), _bh(delta), **kw)
    return out, plain_lse.view(b, h, s).transpose(1, 2), dq, dk, dv


def _pair_kernels(q, k, v, do, meta, causal, rate, kv_len):
    """B11's three entries on the card: out, lse, dq, dk, dv, and the
    delta the backward took."""
    kw = dict(causal=causal, dropout_rate=rate, kv_len=kv_len)
    out, lse = fa.block_fwd_lse(q, k, v, CP_SEED, meta, **kw)
    delta = (do.float() * out.float()).sum(-1)
    dq = fa.block_dq(q, k, v, do, lse, delta, CP_SEED, meta, **kw)
    dk, dv = fa.block_dkv(q, k, v, do, lse, delta, CP_SEED, meta, **kw)
    return out, lse, dq, dk, dv, delta


def _pair_ratios(got, want) -> dict:
    """B11's entries' worst tol ratio (phase 6's FLASH_TOL at bf16) and
    max abs error, from (out, lse, dq, dk, dv) of kernels and plain."""
    atol, rtol = fa.FLASH_TOL[torch.bfloat16]
    names = {"block_fwd_lse": (0,), "block_dq": (2,), "block_dkv": (3, 4)}
    return {name: (max(_tol_ratio(got[i], want[i], atol, rtol) for i in idx),
                   max(_max_err(got[i], want[i]) for i in idx))
            for name, idx in names.items()}


def phase_cp_kernels() -> dict:
    """B11's entries against their plain versions at the CP drive's pair
    shape (b 1, h 16, d 128, s_blk 4096, bf16): a diagonal causal pair and
    an off-diagonal pair with q_off != k_off, dropout 0 and 0.1, with
    kernel, plain, library (SDPA on the pair) and bound times. Two planted
    faults under dropout must break the limit on both ``block_dq`` and
    ``block_dkv``: the offsets dropped to 0, and h0 dropped (a pair of
    heads 16-31 of 32, as under mp). Returns the records of the
    off-diagonal pair at dropout 0.1 (the ring's hops), with the diagonal
    pair's time beside."""
    before = (dict(fa.launches), dict(fa.block_launches))
    sets = flash_inputs(torch.bfloat16, b=1, s=CP_BLOCK, h=16, d=128,
                        copies=2, seed=15)
    records = {name: {} for name in fa.BLOCK_NAMES}
    for label, (causal, meta) in CP_PAIRS.items():
        lib = sdpa_times(sets, causal, iters=20)
        for rate in (0.0, 0.1):
            q, k, v, do = sets[0]
            args = (meta, causal, rate, CP_SEQ)
            got = _pair_kernels(q, k, v, do, *args)
            torch.cuda.synchronize()
            want = _pair_plain(q, k, v, do, *args, got[1], got[5])
            ratios = _pair_ratios(got, want)
            lse_err = _max_err(got[1], want[1])
            del want
            it = iter(range(1 << 30))

            def inputs():
                q, k, v, do = sets[next(it) % len(sets)]
                out, lse = fa.block_fwd_lse(q, k, v, CP_SEED, meta,
                                            causal=causal, dropout_rate=rate,
                                            kv_len=CP_SEQ)
                return q, k, v, do, lse, (do.float() * out.float()).sum(-1)

            staged = [inputs() for _ in sets]
            kw = dict(causal=causal, dropout_rate=rate, kv_len=CP_SEQ)
            pick = iter(range(1 << 30))

            def nxt():
                return staged[next(pick) % len(staged)]

            b = q.shape[0]
            pkw = dict(causal=causal, dropout_rate=rate, seed=CP_SEED,
                       meta=meta, kv_lens=torch.full(
                           (b,), CP_SEQ, dtype=torch.int32, device=q.device))

            def plain_bwd(fn):
                q, k, v, do, lse, delta = nxt()
                return fn(q, k, v, do, _bh(lse), _bh(delta), **pkw)

            calls = {
                "block_fwd_lse": (
                    lambda: fa.block_fwd_lse(*nxt()[:3], CP_SEED, meta, **kw),
                    lambda: fa.flash_attention_fwd_ref(*nxt()[:3], **pkw)),
                "block_dq": (
                    lambda: fa.block_dq(*nxt(), CP_SEED, meta, **kw),
                    lambda: plain_bwd(fa.flash_bwd_dq_ref)),
                "block_dkv": (
                    lambda: fa.block_dkv(*nxt(), CP_SEED, meta, **kw),
                    lambda: plain_bwd(fa.flash_bwd_dkv_ref)),
            }
            for name, (kernel, plain) in calls.items():
                kernel_ms = cuda_ms(kernel, iters=20, warmup=3)
                plain_ms = cuda_ms(plain, iters=2, warmup=1)
                nbytes, flops = cp_pair_bound(name, q, causal)
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
                library_ms = lib["forward" if name == "block_fwd_lse"
                                 else "backward"]
                ratio, err = ratios[name]
                log("cp-kernels", name=name, pair=label, causal=causal,
                    meta=list(meta), dropout=rate, max_abs_err=err,
                    tol_ratio=ratio, kernel_ms=kernel_ms, plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    tflops=flops / kernel_ms * 1e-9,
                    **({"lse_max_abs_err": lse_err}
                       if name == "block_fwd_lse" else {}))
                if not ratio <= 1.0:
                    raise AssertionError(f"{name} {label} dropout {rate}: "
                                         f"{ratio} x the bf16 limit")
                if name == "block_fwd_lse" and not lse_err <= 1e-3:
                    raise AssertionError(f"block_fwd_lse lse err {lse_err}")
                rec = records[name]
                if rate > 0.0 and label == "off-diagonal":
                    rec.update(max_abs_err=max(rec.get("max_abs_err", 0.0),
                                               err),
                               ms=kernel_ms, plain_ms=plain_ms,
                               bound_ms=max(bytes_ms, ops_ms),
                               bound_by="bytes" if bytes_ms >= ops_ms
                               else "operations", library_ms=library_ms)
                elif rate > 0.0:
                    rec["ms_diagonal"] = kernel_ms
                    rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
            del staged
    # planted faults at dropout 0.1: the kernels given a wrong meta, held
    # against the plain versions given the right one
    q, k, v, do = sets[0]
    causal, meta = CP_PAIRS["off-diagonal"]
    mp_meta = (0, 16, 16, 32) + meta[4:]
    faults = {"offsets dropped": (meta, meta[:4] + (0, 0)),
              "h0 dropped": (mp_meta, (0, 0, 16, 32) + meta[4:])}
    for fault, (right, wrong) in faults.items():
        got = _pair_kernels(q, k, v, do, wrong, causal, 0.1, CP_SEQ)
        want = _pair_plain(q, k, v, do, right, causal, 0.1, CP_SEQ, got[1],
                           got[5])
        ratios = _pair_ratios(got, want)
        caught = [n for n, (r, _) in ratios.items() if r > 1.0]
        log("cp-kernels", planted_fault=repr(fault), caught=caught,
            tol_ratios={n: r for n, (r, _) in ratios.items()})
        missed = {"block_dq", "block_dkv"} - set(caught)
        if missed:
            raise AssertionError(f"phase 15's {sorted(missed)} miss the "
                                 f"planted fault {fault!r}: {ratios}")
        del want, got
    fa.launches.update(before[0])  # checks and timing are not the path
    fa.block_launches.update(before[1])
    del sets
    torch.cuda.empty_cache()
    return records


# ----------------------------------------------------------------- phase 16

def cp_ring_inputs(seq: int, seed: int = 16) -> tuple:
    """The global [1, seq, 16, 128] bf16 q, k, v, dO of phase 16, made on
    the card from a seed (every rank and the parent make the same)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return tuple(torch.randn(1, seq, 16, 128, generator=g, device=DEVICE)
                 .to(torch.bfloat16) for _ in range(4))


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A bf16 card tensor as int16 bits on the host (picklable, exact)."""
    return t.detach().contiguous().view(torch.int16).cpu().numpy()


def _from_host(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).view(torch.bfloat16).to(DEVICE)


def cp_ring_rank(cp: int, seq: int, rates) -> dict:
    """One rank of phase 16: this rank's zig-zag share of the ring's
    forward and backward at each dropout rate (bf16 bits), the launch
    counts of each, and the shares of a run at rate 0.1 whose backward
    skips its last shift home (a planted fault)."""
    from fleetx_tpu_torch.parallel import context_parallel as cpar
    from fleetx_tpu_torch.parallel.mesh import build_mesh, set_mesh

    mesh = build_mesh(1, cp)
    set_mesh(mesh)
    shares = [cpar.zigzag_slice(t, cp, mesh.cp_rank)
              for t in cp_ring_inputs(seq)]

    def run(rate):
        q, k, v = (t.detach().clone().requires_grad_() for t in shares[:3])
        for counts in (fa.launches, fa.block_launches):
            counts.update(dict.fromkeys(counts, 0))
        out = cpar.ring_self_attention(
            q, k, v, causal=True, expected_cp=cp, dropout_rate=rate,
            seed=CP_SEED if rate else None)
        torch.cuda.synchronize()
        fwd = {**fa.launches, **fa.block_launches}
        out.backward(shares[3])
        torch.cuda.synchronize()
        return {"shares": [_to_host(t) for t in (out, q.grad, k.grad,
                                                 v.grad)],
                "forward": fwd,
                "total": {**fa.launches, **fa.block_launches}}

    results = {rate: run(rate) for rate in rates}
    shift, calls = cpar.ring_shift, []

    def no_last_shift_home(tensors, mesh):
        calls.append(1)  # forward cp - 1, backward cp - 1 hops, then home
        if len(calls) == 2 * (cp - 1) + 1:
            return list(tensors)
        return shift(tensors, mesh)

    cpar.ring_shift = no_last_shift_home
    try:
        results["fault"] = run(0.1)
    finally:
        cpar.ring_shift = shift
    return results


def _merged(results, key, cp) -> list:
    """The global natural-order out, dq, dk, dv from the ranks' shares."""
    from fleetx_tpu_torch.parallel.context_parallel import zigzag_merge

    return [zigzag_merge(torch.cat([_from_host(r[key]["shares"][i])
                                    for r in results], dim=1), cp)
            for i in range(4)]


def phase_cp_ring() -> None:
    """The ring at cp 2 and 4, its ranks processes that share the card over
    gloo (b 1, h 16, d 128, seq 16384, bf16): the zig-zag-merged output and
    dq, dk, dv equal single-process B1-B3 on the whole sequence within
    phase 6's limits at dropout 0 and 0.1; each rank launches B1 (through
    block_fwd_lse) 3 + 2(cp - 1) times per forward, B2 and B3 as often per
    backward; the backward without its last shift home breaks the limit."""
    from fleetx_tpu_torch.parallel.launch import spawn

    rates = (0.0, 0.1)
    before = dict(fa.launches)
    q, k, v, do = cp_ring_inputs(CP_SEQ)
    want = {}
    for rate in rates:
        qt, kt, vt = (t.clone().requires_grad_() for t in (q, k, v))
        out = fa.flash_attention(qt, kt, vt, causal=True, dropout_rate=rate,
                                 seed=CP_SEED)
        out.backward(do)
        want[rate] = [out.detach(), qt.grad, kt.grad, vt.grad]
    torch.cuda.synchronize()
    fa.launches.update(before)  # the comparison's launches are not the path
    atol, rtol = fa.FLASH_TOL[torch.bfloat16]
    for cp in (2, 4):
        t0 = time.perf_counter()
        results = spawn(cp_ring_rank, cp, (cp, CP_SEQ, rates), timeout=300)
        seconds = time.perf_counter() - t0
        per_pass = 3 + 2 * (cp - 1)
        for key in rates + ("fault",):
            got = _merged(results, key, cp)
            ref = want[0.1 if key == "fault" else key]
            ratios = [_tol_ratio(g, w, atol, rtol) for g, w in zip(got, ref)]
            errs = [_max_err(g, w) for g, w in zip(got, ref)]
            log("cp-ring", cp=cp, seq=CP_SEQ, run=repr(key),
                tol_ratios=dict(zip(("out", "dq", "dk", "dv"), ratios)),
                max_abs_errs=dict(zip(("out", "dq", "dk", "dv"), errs)),
                launches_rank0=results[0][key]["total"],
                spawn_seconds=seconds)
            if key == "fault":
                if max(ratios) <= 1.0:
                    raise AssertionError(f"phase 16 misses the planted fault "
                                         f"at cp {cp}: {ratios}")
                continue
            if not max(ratios) <= 1.0:
                raise AssertionError(f"ring at cp {cp}, dropout {key}: "
                                     f"{ratios} x the bf16 limit")
            for rank, r in enumerate(results):
                fwd, total = r[key]["forward"], r[key]["total"]
                want_fwd = {"flash_fwd": per_pass, "block_fwd_lse": per_pass,
                            "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                            "block_dq": 0, "block_dkv": 0}
                want_total = {n: per_pass for n in want_fwd}
                if fwd != want_fwd or total != want_total:
                    raise AssertionError(f"cp {cp} rank {rank} launches "
                                         f"{fwd} / {total}")
        del results
    del want
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 17

def cp_overrides(prefix: str, *extra) -> list:
    """The long-context yaml at cp 2, seq 16384, one sequence per step, over
    the corpus at ``prefix``: a short warmup and a max_lr at which the loss
    moves within the drive; full width, CP_TRAIN_LAYERS layers."""
    return [own_output_dir(prefix), f"Data.Train.dataset.input_dir={prefix}",
            f"Data.Eval.dataset.input_dir={prefix}",
            f"Distributed.cp_degree={CP_DEGREE}",
            f"Model.num_layers={CP_TRAIN_LAYERS}",
            f"Data.Train.dataset.max_seq_len={CP_SEQ}",
            f"Data.Eval.dataset.max_seq_len={CP_SEQ}",
            "Global.local_batch_size=1", "Global.micro_batch_size=1",
            f"Engine.max_steps={CP_STEPS}", "Engine.logging_freq=1",
            f"Engine.eval_freq={CP_STEPS}",
            f"Engine.eval_iters={CP_EVAL_ITERS}",
            "Optimizer.lr.warmup_steps=1", "Optimizer.lr.max_lr=3.0e-4",
            "Optimizer.lr.min_lr=3.0e-5", "Optimizer.lr.decay_steps=1000",
            *extra]


def cp_train_rank(argv) -> dict:
    """One rank of phase 17: ``tools/train.py``'s ``main`` on ``argv``,
    with CUDA events at the ends of the steps, the gradient all-reduce and
    the ring's block exchanges timed (synchronised on both sides; the
    exchanges summed per step), the evaluation's mean kept, and the plain
    versions of B1-B3 counted (none may run)."""
    import torch.distributed as dist

    from fleetx_tpu_torch.core import engine
    from fleetx_tpu_torch.parallel import context_parallel as cpar
    from fleetx_tpu_torch.tools import train as train_cli

    backend = dist.get_backend()
    ends, reduce_ms, shift_ms, step_shift_ms, evals = [], [], [], [], []
    step, reduce, evaluate = (engine.Trainer.train_step,
                              engine.all_reduce_sum, engine.Trainer.evaluate)
    shift = cpar.ring_shift

    def synced_ms(fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def timed_step(self, batch):
        first = len(shift_ms)
        out = step(self, batch)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        step_shift_ms.append(sum(shift_ms[first:]))
        return out

    def timed_reduce(tensors, *a, **kw):
        reduce_ms.append(synced_ms(reduce, tensors, *a, **kw)[1])

    def timed_shift(tensors, mesh):
        out, ms = synced_ms(shift, tensors, mesh)
        shift_ms.append(ms)
        return out

    def kept_eval(self, data, epoch=0):
        evals.append(evaluate(self, data, epoch))
        return evals[-1]

    plain_calls = dict.fromkeys(PLAIN_FLASH.values(), 0)

    def counted(fn):
        def wrapper(*a, **kw):
            plain_calls[fn] += 1
            return fn(*a, **kw)
        return wrapper

    engine.Trainer.train_step, engine.Trainer.evaluate = timed_step, kept_eval
    engine.all_reduce_sum, cpar.ring_shift = timed_reduce, timed_shift
    for fn in PLAIN_FLASH.values():
        setattr(fa, fn.__name__, counted(fn))
    torch.cuda.reset_peak_memory_stats()
    for counts in (fa.launches, fa.block_launches, ce.launches):
        counts.update(dict.fromkeys(counts, 0))
    t0 = time.perf_counter()
    trainer = train_cli.main(list(argv))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
    return {"backend": backend, "losses": [float(h["loss"])
                                           for h in trainer.history],
            "grad_norms": [float(h["grad_norm"]) for h in trainer.history],
            "evals": evals, "step_ms": step_ms, "reduce_ms": reduce_ms,
            "shift_ms": step_shift_ms, "shifts": len(shift_ms),
            "launches": {**fa.launches, **fa.block_launches, **ce.launches},
            "plain_calls": {fn.__name__: n for fn, n in plain_calls.items()},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "checksum": float(sum(p.detach().double().sum()
                                  for p in trainer.module.nets.parameters())),
            "n_params": trainer.n_params, "steps": trainer.step,
            "fit_seconds": seconds,
            "cp_layers": trainer.module.gpt_config.num_layers,
            "cp_degree": trainer.module.gpt_config.cp_degree,
            "fused_ce": trainer.module.gpt_config.fused_ce,
            "recompute": trainer.module.gpt_config.recompute_granularity}


def phase_train_cp(prefix: str) -> dict:
    """The port's CP training path: ``tools/train.py`` on the long-context
    yaml (GPT-1.3B at full width, CP_TRAIN_LAYERS layers, bf16, dropout
    0.1, full recompute) at cp 2, seq 16384, on 2 ranks that share the card over
    gloo, for CP_STEPS steps and one evaluation. Every loss finite and
    falling and equal on both ranks, the parameters equal across ranks,
    and B1-B3 launched exactly as the ring under recompute launches them
    (no plain version). Returns rank 0's B11 launch counts."""
    from fleetx_tpu_torch.core.engine import model_flops_per_token
    from fleetx_tpu_torch.parallel.launch import spawn

    argv = ["-c", CP_CONFIG] + [x for o in cp_overrides(prefix)
                                for x in ("-o", o)]
    results = spawn(cp_train_rank, CP_DEGREE, (argv,), timeout=900)
    r0 = results[0]
    layers, per_pass = r0["cp_layers"], 3 + 2 * (CP_DEGREE - 1)
    steps, evals = r0["steps"], CP_EVAL_ITERS * len(r0["evals"])
    b1 = layers * per_pass * (2 * steps + evals)  # forward, recompute, eval
    b23 = layers * per_pass * steps
    want = {"flash_fwd": b1, "block_fwd_lse": b1, "flash_bwd_dq": b23,
            "block_dq": b23, "flash_bwd_dkv": b23, "block_dkv": b23,
            "ce_fwd": 0, "ce_dh": 0, "ce_dw": 0}
    steady = float(np.median(r0["step_ms"][1:])) * 1e-3
    tokens = CP_SEQ  # the global batch: one sequence, split over the ring
    flops = model_flops_per_token(r0["n_params"], layers, CP_SEQ, 2048)
    for rank, r in enumerate(results):
        log("train-cp", rank=rank, backend=r["backend"], steps=r["steps"],
            layers=layers, cp=r["cp_degree"], seq=CP_SEQ,
            recompute=r["recompute"], fused_ce=r["fused_ce"],
            params_m=r["n_params"] / 1e6,
            step_ms=[round(x, 1) for x in r["step_ms"]],
            all_reduce_ms=[round(x, 1) for x in r["reduce_ms"]],
            ring_exchange_ms=[round(x, 1) for x in r["shift_ms"]],
            ring_exchanges=r["shifts"],
            peak_mem_gb=r["peak_mem_gb"], fit_seconds=r["fit_seconds"],
            launches=r["launches"], plain_calls=r["plain_calls"],
            checksum=r["checksum"])
    log("train-cp", step_ms_median=steady * 1e3, tokens_per_s=tokens / steady,
        mfu=tokens / steady * flops / PEAK_FLOPS[torch.bfloat16],
        all_reduce_ms_median=float(np.median(r0["reduce_ms"])),
        ring_exchange_ms_median=float(np.median(r0["shift_ms"])),
        losses=[round(x, 4) for x in r0["losses"]],
        grad_norms=[round(x, 4) for x in r0["grad_norms"]],
        evals=r0["evals"])
    if r0["backend"] != "gloo":
        raise AssertionError(f"ranks sharing one card ran {r0['backend']}")
    if steps != CP_STEPS or len(r0["evals"]) != 1:
        raise AssertionError(f"{steps} steps, {len(r0['evals'])} evals")
    for rank, r in enumerate(results):
        if r["launches"] != want or any(r["plain_calls"].values()):
            raise AssertionError(f"rank {rank}: launches {r['launches']}, "
                                 f"want {want}; plain {r['plain_calls']}")
        if (r["losses"] != r0["losses"] or r["evals"] != r0["evals"]
                or r["checksum"] != r0["checksum"]):
            raise AssertionError(f"rank {rank} disagrees with rank 0: "
                                 f"{r['losses']} {r['checksum']}")
    losses = r0["losses"]
    if not all(math.isfinite(x) for x in losses + r0["evals"]):
        raise AssertionError(f"non-finite loss in {losses} {r0['evals']}")
    if not np.mean(losses[-2:]) < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    return {name: {"launches": r0["launches"][name]}
            for name in fa.BLOCK_NAMES}


# ----------------------------------------------------------------- phase 18

CP_E2E_LAYERS, CP_E2E_SEQ = 2, 4096


def cp_e2e_overrides(prefix: str, dp: int, cp: int) -> list:
    """Phase 18's config: the long-context yaml cut to CP_E2E_LAYERS layers
    at seq CP_E2E_SEQ, hidden dropout 0 (its mask follows the zig-zag
    order), attention dropout 0.1; a global batch of 2 sequences over dp
    ranks."""
    return [own_output_dir(prefix), f"Data.Train.dataset.input_dir={prefix}",
            f"Data.Train.dataset.max_seq_len={CP_E2E_SEQ}",
            f"Model.num_layers={CP_E2E_LAYERS}",
            "Model.hidden_dropout_prob=0.0",
            "Model.attention_probs_dropout_prob=0.1",
            f"Distributed.dp_degree={dp}", f"Distributed.cp_degree={cp}",
            f"Global.local_batch_size={2 // dp}",
            f"Global.micro_batch_size={2 // dp}"]


def whole_grads(trainer, grads):
    """The whole gradients of the clip's ``grads``: under the ZeRO
    weight-update shard this rank's slices, gathered over the zero group
    (a collective: every rank of the step calls it)."""
    return grads if trainer.zero is None else trainer.zero.whole(grads)


def cp_e2e_rank(overrides, batch, grads_path) -> tuple:
    """One rank of a phase-18 run: one train step of a fresh trainer on its
    dp rows of the global ``batch``; rank 0 saves the summed gradients
    (by parameter name) to ``grads_path``. Returns (loss, grad norm)."""
    cfg = get_config(CP_CONFIG, overrides=list(overrides))
    trainer = Trainer(cfg, build_module(cfg))
    trainer.init_state()
    mesh = trainer.mesh
    b = batch["tokens"].shape[0] // mesh.dp
    rows = {k: v[mesh.dp_rank * b:(mesh.dp_rank + 1) * b]
            for k, v in batch.items()}
    names = [n for n, _ in trainer.module.nets.named_parameters()]
    grads, clip = [], trainer.clip

    def capture(gs, norm=None):
        grads.extend(g.detach().clone() for g in whole_grads(trainer, gs))
        return clip(gs, norm)

    trainer.clip = capture
    out = trainer.train_step(trainer._to_device(rows))
    if mesh.rank == 0:
        torch.save({n: g.cpu() for n, g in zip(names, grads)}, grads_path)
    return float(out["loss"]), float(out["grad_norm"])


def phase_train_cp_e2e(prefix: str) -> None:
    """One step of the CP config cut to CP_E2E_LAYERS layers at seq 4096
    (hidden dropout 0, attention dropout 0.1) three ways on the same
    global batch: cp 1 in this process, cp 2 on 2 ranks and dp 2 x cp 2 on
    4 ranks (all on the card, over gloo). Loss, grad norm and every
    gradient leaf of the two rings must lie within phase 8's limits of cp
    1."""
    from fleetx_tpu_torch.parallel.launch import spawn

    cfg1 = get_config(CP_CONFIG, overrides=cp_e2e_overrides(prefix, 1, 1),
                      nranks=1)
    batch = next(iter(build_dataloader(cfg1, "Train")))
    ref = _e2e_step(cfg1, batch)
    with tempfile.TemporaryDirectory() as tmp:
        for dp, cp in ((1, 2), (2, 2)):
            path = os.path.join(tmp, f"grads_dp{dp}_cp{cp}.pt")
            outs = spawn(cp_e2e_rank, dp * cp,
                         (cp_e2e_overrides(prefix, dp, cp), batch, path),
                         timeout=600)
            grads = {n: g.to(DEVICE) for n, g in torch.load(path).items()}
            gaps = _e2e_gaps((outs[0][0], outs[0][1], grads, 0), ref)
            log("train-cp-e2e", layers=CP_E2E_LAYERS, seq=CP_E2E_SEQ, dp=dp,
                cp=cp, loss_this=outs[0][0], loss_cp1=ref[0],
                grad_norm_this=outs[0][1], grad_norm_cp1=ref[1],
                ranks_agree=len(set(outs)) == 1, tol=TRAIN_E2E_TOL, **gaps)
            over = [m for m, tol in TRAIN_E2E_TOL.items()
                    if not gaps[m] <= tol]
            if over or len(set(outs)) != 1 or not math.isfinite(outs[0][0]):
                raise AssertionError(f"dp {dp} x cp {cp} vs cp 1: {gaps}, "
                                     f"ranks {outs}")
            del grads
    del ref
    gc.collect()
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 19
# the tensor-parallel drive: the 1.3B yaml at mp 2 on 2 ranks that share
# the card; each rank's B12 runs B4-B6 on its vocab shard of the LM head,
# [8192, 2048] bf16 activations against [25152, 2048] of the embeddings
MP_DEGREE, MP_STEPS, MP_EVAL_ITERS = 2, 5, 1
MP_TRAIN_LAYERS = 2  # phase 20's depth: the yaml's 24 cut for time
MP_CE_SHAPE = (8192, 2048, 50304)  # tokens, hidden, the global vocab
MP_E2E_LAYERS = 2
VP_KERNEL = {"vp_ce_fwd": "ce_fwd", "vp_ce_dh": "ce_dh", "vp_ce_dw": "ce_dw"}
VP_KIND = {"loss": "stats", "dh": "grads", "dW": "grads",
           "dh_partial": "grads"}


def _vp_run(h, shard, labels, g, group, swaps) -> dict:
    """One B12 forward and backward (cotangent g) of ``fused_linear_ce`` on
    this rank's ``shard`` with the ce module's entries in ``swaps`` (name:
    function) swapped in: loss, dh (summed over the shards), this shard's
    dW, this rank's partial dh (B5's output before the sum), and the
    arguments the backward gave B5 and B6 (``args``, by ``wrt``)."""
    names = ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw", "local_labels")
    saved = {name: getattr(ce, name) for name in names}
    fns = {**saved, **swaps}
    partial, args = [], {}

    def dh_kept(*a):
        args["h"] = a
        partial.append(fns["fused_ce_dh"](*a))
        return partial[-1]

    def dw_kept(*a):
        args["w"] = a
        return fns["fused_ce_dw"](*a)

    for name, fn in {**fns, "fused_ce_dh": dh_kept,
                     "fused_ce_dw": dw_kept}.items():
        setattr(ce, name, fn)
    try:
        hh = h.clone().requires_grad_()
        ww = shard.clone().requires_grad_()
        loss = ce.fused_linear_ce(hh, ww, labels, mp_group=group)
        loss.backward(g)
        torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(ce, name, fn)
    return {"loss": loss.detach(), "dh": hh.grad, "dW": ww.grad,
            "dh_partial": partial[0], "args": args}


def vp_faults() -> dict:
    """Planted B12 faults phase 19's limits must catch, as swaps of the ce
    module's entries: the backward kernels given b = -a (the plain
    cross-entropy's cotangent, not B12's independent one), and labels off
    the shard wrapped to a column of it instead of -1."""
    dh, dw = ce.fused_ce_dh, ce.fused_ce_dw

    def wrapped_labels(labels, v_loc, mp_rank):
        return ((labels.to(torch.int32) - mp_rank * v_loc) % v_loc).to(
            torch.int32)

    return {"b = -a": {
                "fused_ce_dh": lambda h, w, l, a, b, lse: dh(h, w, l, a, -a,
                                                             lse),
                "fused_ce_dw": lambda h, w, l, a, b, lse: dw(h, w, l, a, -a,
                                                             lse)},
            "off-shard labels as column ids": {
                "local_labels": wrapped_labels}}


def vp_rank(n: int, e: int, v: int) -> dict:
    """One rank of phase 19: B12 on this rank's vocab shard of phase 12's
    kind of inputs at the path's shape (labels over the global vocab, so
    about half lie off each shard, and -1 and V among them), through the
    kernels, through their plain versions and with each planted fault. The
    gaps of each run from the plain one by output (CE_TOL at bf16; the
    summed dh against the partials' summed magnitudes plus its own), and
    B12's launches in the kernel run (one per entry) and the plain run
    (none); and the time of one all-reduce of a [tokens, hidden]
    activation over the group."""
    import torch.distributed as dist

    from fleetx_tpu_torch.parallel.mesh import build_mesh, set_mesh

    mesh = build_mesh(1, 1, MP_DEGREE)
    set_mesh(mesh)
    h, w, labels, g = ce_inputs(torch.bfloat16, n, e, v, seed=19)
    v_loc = v // MP_DEGREE
    shard = w[mesh.mp_rank * v_loc:(mesh.mp_rank + 1) * v_loc].contiguous()
    del w
    group, bf16 = mesh.mp_group, torch.bfloat16
    plain = {"fused_ce_fwd": ce.fused_ce_fwd_ref,
             "fused_ce_dh": ce.fused_ce_dh_ref,
             "fused_ce_dw": ce.fused_ce_dw_ref}
    launched = {}
    for label, swaps in (("kernels", {}), ("plain", plain)):
        before = dict(ce.vp_launches)
        run = _vp_run(h, shard, labels, g, group, swaps)
        launched[label] = {k: ce.vp_launches[k] - before[k]
                           for k in ce.VP_NAMES}
        if label == "kernels":
            got = run
    want = run
    scale = want["dh_partial"].float().abs()
    dist.all_reduce(scale, group=group)
    scale += want["dh"].float().abs()  # see ce.ce_gaps
    # the grads' checks are aware of dl's rounding flips: readings of the
    # kernels' own dl (B5's partial, its sum over the group, B6's shard),
    # by which the kernel run and every planted fault are held
    dh_args, dw_args = got["args"]["h"], got["args"]["w"]
    readings = {"dh_partial": ce_readings(*dh_args, "h"),
                "dh": ce_readings(*dh_args, "h", group=group),
                "dW": ce_readings(*dw_args, "w")}

    def gaps(out):
        return {k: ce.grads_gaps(out[k], want[k], readings[k],
                                 scale=scale if k == "dh" else None)
                if VP_KIND[k] == "grads" else
                ce.ce_gaps(out[k], want[k], bf16, VP_KIND[k])
                for k in VP_KIND}

    faults = {name: gaps(_vp_run(h, shard, labels, g, group, swaps))
              for name, swaps in vp_faults().items()}
    # the transport of the mp drive: one [tokens, hidden] activation
    # all-reduced over the group, bf16 (a row-parallel output) and fp32
    # (the embedding's sum), 5 times after a warm-up
    transport = {}
    for dtype in (bf16, torch.float32):
        act = torch.ones(n, e, dtype=dtype, device=DEVICE)
        dist.all_reduce(act, group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            dist.all_reduce(act, group=group)
        torch.cuda.synchronize()
        transport[str(dtype).split(".")[-1]] = {
            "mb": act.numel() * act.element_size() / 2 ** 20,
            "ms": (time.perf_counter() - t0) / 5 * 1e3}
    return {"gaps": gaps(got), "faults": faults, "launched": launched,
            "transport": transport,
            "off_shard": float((ce.local_labels(labels, v_loc, mesh.mp_rank)
                                < 0).float().mean()),
            "mean_abs": {k: got[k].float().abs().mean().item()
                         for k in VP_KIND}}


def phase_mp_kernels() -> dict:
    """B12 against its plain version on MP_DEGREE ranks that share the card
    (loss, dh, dW and each rank's partial dh within CE_TOL at bf16), the
    planted faults each breaking the limit on some rank; then B12's
    kernels (B4-B6 at the vocab shard, independent a and b) timed in this
    process beside their plain versions, the library yardstick (the logits
    path on the shard) and their bounds. Returns B12's records."""
    from fleetx_tpu_torch.parallel.launch import spawn

    n, e, v = MP_CE_SHAPE
    v_loc, bf16 = v // MP_DEGREE, torch.bfloat16
    results = spawn(vp_rank, MP_DEGREE, (n, e, v), timeout=600)
    caught = {}
    for rank, r in enumerate(results):
        for k, gap in r["gaps"].items():
            log("mp-kernels", rank=rank, output=k, tol=ce.CE_TOL[bf16][
                VP_KIND[k]], mean_abs=r["mean_abs"][k], **gap)
        for fault, outs in r["faults"].items():
            for k, gap in outs.items():
                log("mp-kernels", rank=rank, planted_fault=repr(fault),
                    output=k, **gap)
            caught[fault] = caught.get(fault, False) or not all(
                gap["ok"] for gap in outs.values())
        log("mp-kernels", rank=rank, launched=r["launched"],
            off_shard_labels=r["off_shard"], all_reduce=r["transport"])
        bad = [k for k, gap in r["gaps"].items() if not gap["ok"]]
        if bad or r["launched"] != {
                "kernels": dict.fromkeys(ce.VP_NAMES, 1),
                "plain": dict.fromkeys(ce.VP_NAMES, 0)}:
            raise AssertionError(f"B12 vs plain on rank {rank}: {bad} "
                                 f"{r['gaps']}; launched {r['launched']}")
    missed = [fault for fault, hit in caught.items() if not hit]
    if missed:
        raise AssertionError(f"phase 19 misses the planted faults {missed}")
    h, w, labels, g = ce_inputs(bf16, n, e, v, seed=19)
    shard = w[:v_loc].contiguous()  # rank 0's
    del w
    l_loc = ce.local_labels(labels, v_loc, 0)
    before = dict(ce.launches)
    loss, lse = ce.fused_ce_fwd(h, shard, l_loc)
    again = ce.fused_ce_fwd(h, shard, l_loc)
    torch.cuda.synchronize()
    if not (torch.equal(loss, again[0]) and torch.equal(lse, again[1])):
        raise AssertionError("B12's forward at the shard: two launches on the "
                             "same inputs differ")
    del loss, again
    a, b = g * 0.5, -g  # independent cotangents, as B12's backward has
    lib = library_ce_times(h, shard, l_loc, g)
    calls = {
        "vp_ce_fwd": (lambda: ce.fused_ce_fwd(h, shard, l_loc),
                      lambda: ce.fused_ce_fwd_ref(h, shard, l_loc),
                      lib["forward"], ("loss",)),
        "vp_ce_dh": (lambda: ce.fused_ce_dh(h, shard, l_loc, a, b, lse),
                     lambda: ce.fused_ce_dh_ref(h, shard, l_loc, a, b, lse),
                     lib["dh"], ("dh_partial", "dh")),
        "vp_ce_dw": (lambda: ce.fused_ce_dw(h, shard, l_loc, a, b, lse),
                     lambda: ce.fused_ce_dw_ref(h, shard, l_loc, a, b, lse),
                     lib["dw"], ("dW",))}
    records = {}
    for name, (kernel, plain, library_ms, outs) in calls.items():
        kernel_ms = cuda_ms(kernel, iters=10, warmup=2)
        plain_ms = cuda_ms(plain, iters=2, warmup=1)
        nbytes, flops = ce_bound(VP_KERNEL[name], h, shard)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_FLOPS[bf16] * 1e3
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        err = max(r["gaps"][k]["max_abs_err"] for r in results for k in outs)
        log("mp-kernels", name=name, kernel=VP_KERNEL[name], tokens=n,
            hidden=e, vocab_shard=v_loc, max_abs_err=err,
            kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            library="logits path on the shard " + {
                "vp_ce_fwd": "forward", "vp_ce_dh": "dh alone",
                "vp_ce_dw": "dW alone"}[name],
            library_backward_ms=lib["backward"],
            bound_ms=max(bytes_ms, ops_ms), bound_by=bound_by, bytes=nbytes,
            flops=flops, tflops=flops / kernel_ms * 1e-9,
            share_of_bound=max(bytes_ms, ops_ms) / kernel_ms)
        records[name] = {"max_abs_err": err, "ms": kernel_ms,
                         "plain_ms": plain_ms,
                         "bound_ms": max(bytes_ms, ops_ms),
                         "bound_by": bound_by, "library_ms": library_ms}
        if name != "vp_ce_fwd":
            records[name]["library_backward_ms"] = lib["backward"]
    ce.launches.update(before)  # timing is not the path
    del h, shard, labels, g, lse, a, b
    torch.cuda.empty_cache()
    return records


# ----------------------------------------------------------------- phase 20

def mp_overrides(prefix: str, *extra) -> list:
    """The 1.3B single-card yaml at mp 2 with the fused CE over the corpus
    at ``prefix``: MP_STEPS steps (warmup 1, a max_lr at which the loss
    moves within the drive) and one evaluation over MP_EVAL_ITERS batch;
    full width, MP_TRAIN_LAYERS layers, the yaml's batch 8 of 1024
    tokens."""
    return [own_output_dir(prefix), f"Data.Train.dataset.input_dir={prefix}",
            f"Data.Eval.dataset.input_dir={prefix}", "Model.fused_ce=True",
            f"Distributed.mp_degree={MP_DEGREE}",
            f"Model.num_layers={MP_TRAIN_LAYERS}",
            f"Engine.max_steps={MP_STEPS}", "Engine.logging_freq=1",
            f"Engine.eval_freq={MP_STEPS}",
            f"Engine.eval_iters={MP_EVAL_ITERS}",
            "Optimizer.lr.warmup_steps=1", "Optimizer.lr.max_lr=3.0e-4",
            "Optimizer.lr.min_lr=3.0e-5", "Optimizer.lr.decay_steps=1000",
            *extra]


def mp_train_rank(argv) -> dict:
    """One rank of phase 20: ``tools/train.py``'s ``main`` on ``argv``,
    with CUDA events at the ends of the steps, every all-reduce timed
    (synchronised on both sides) and summed per step, the evaluation's
    mean kept, and the plain versions of B1-B6 and the logits loss
    counted (none may run)."""
    import torch.distributed as dist

    from fleetx_tpu_torch.core import engine
    from fleetx_tpu_torch.models import language_module as lm
    from fleetx_tpu_torch.tools import train as train_cli

    backend = dist.get_backend()
    ends, evals, reduces, step_reduces = [], [], [], []
    step, evaluate = engine.Trainer.train_step, engine.Trainer.evaluate
    all_reduce = dist.all_reduce

    def timed_step(self, batch):
        first = len(reduces)
        out = step(self, batch)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        mine = reduces[first:]
        step_reduces.append((sum(ms for ms, _ in mine), len(mine),
                             sum(nbytes for _, nbytes in mine)))
        return out

    def timed_all_reduce(t, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = all_reduce(t, *a, **kw)
        torch.cuda.synchronize()
        reduces.append(((time.perf_counter() - t0) * 1e3,
                        t.numel() * t.element_size()))
        return out

    def kept_eval(self, data, epoch=0):
        evals.append(evaluate(self, data, epoch))
        return evals[-1]

    calls = dict.fromkeys(list(PLAIN_FLASH.values())
                          + list(PLAIN_CE.values()), 0)
    logits = {"vocab_parallel_token_losses": 0}

    def counted(fn, counts, key):
        def wrapper(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return wrapper

    engine.Trainer.train_step, engine.Trainer.evaluate = timed_step, kept_eval
    dist.all_reduce = timed_all_reduce
    for fn in calls:
        mod = fa if fn in PLAIN_FLASH.values() else ce
        setattr(mod, fn.__name__, counted(fn, calls, fn))
    for name in logits:
        setattr(lm, name, counted(getattr(lm, name), logits, name))
    torch.cuda.reset_peak_memory_stats()
    for counts in (fa.launches, ce.launches, ce.vp_launches):
        counts.update(dict.fromkeys(counts, 0))
    t0 = time.perf_counter()
    trainer = train_cli.main(list(argv))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    gcfg = trainer.module.gpt_config
    nets = trainer.module.nets
    return {"backend": backend,
            "losses": [float(x["loss"]) for x in trainer.history],
            "grad_norms": [float(x["grad_norm"]) for x in trainer.history],
            "evals": evals,
            "step_ms": [a.elapsed_time(b) for a, b in zip(ends, ends[1:])],
            "reduce_ms": [x[0] for x in step_reduces],
            "reduces": [x[1] for x in step_reduces],
            "reduce_gb": [x[2] / 1e9 for x in step_reduces],
            "launches": {**fa.launches, **ce.launches, **ce.vp_launches},
            "plain_calls": {fn.__name__: c for fn, c in calls.items()},
            "logits_calls": logits,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "replicated": float(sum(
                p.detach().double().sum() for n, p in nets.named_parameters()
                if n not in trainer.mp_split)),
            "n_params": trainer.n_params, "steps": trainer.step,
            "fit_seconds": seconds, "layers": gcfg.num_layers,
            "mp": gcfg.mp_degree, "fused_ce": gcfg.fused_ce,
            "recompute": gcfg.recompute_granularity,
            "tokens": trainer.cfg.Global.global_batch_size
            * trainer.cfg.Data.Train.dataset.max_seq_len}


def phase_train_mp(prefix: str) -> dict:
    """The port's tensor-parallel training path: ``tools/train.py`` on the
    1.3B yaml (full width and depth, bf16, dropout 0.1, full recompute)
    with the fused CE at mp 2, on 2 ranks that share the card over gloo,
    for MP_STEPS steps and one evaluation. Every loss finite, falling and
    equal on both ranks, the replicated parameters equal across ranks, and
    per rank B1-B3 and B12 (B4-B6 on the shard) launched exactly as the
    path under recompute launches them: no plain version, no logits path.
    Returns rank 0's launch counts."""
    from fleetx_tpu_torch.core.engine import model_flops_per_token
    from fleetx_tpu_torch.parallel.launch import spawn

    argv = ["-c", TRAIN_13B_CONFIG] + [x for o in mp_overrides(prefix)
                                       for x in ("-o", o)]
    results = spawn(mp_train_rank, MP_DEGREE, (argv,), timeout=900)
    r0 = results[0]
    layers, steps = r0["layers"], r0["steps"]
    evals = MP_EVAL_ITERS * len(r0["evals"])
    want = {"flash_fwd": layers * (2 * steps + evals),
            "flash_bwd_dq": layers * steps, "flash_bwd_dkv": layers * steps,
            "ce_fwd": steps + evals, "ce_dh": steps, "ce_dw": steps,
            "vp_ce_fwd": steps + evals, "vp_ce_dh": steps, "vp_ce_dw": steps}
    steady = float(np.median(r0["step_ms"][1:])) * 1e-3
    flops = model_flops_per_token(r0["n_params"], layers, 1024, 2048)
    for rank, r in enumerate(results):
        log("train-mp", rank=rank, backend=r["backend"], steps=r["steps"],
            layers=layers, mp=r["mp"], recompute=r["recompute"],
            fused_ce=r["fused_ce"], params_m=r["n_params"] / 1e6,
            step_ms=[round(x, 1) for x in r["step_ms"]],
            all_reduce_ms=[round(x, 1) for x in r["reduce_ms"]],
            all_reduces=r["reduces"],
            all_reduce_gb=[round(x, 3) for x in r["reduce_gb"]],
            peak_mem_gb=r["peak_mem_gb"], fit_seconds=r["fit_seconds"],
            launches=r["launches"], plain_calls=r["plain_calls"],
            logits_calls=r["logits_calls"], replicated=r["replicated"])
    log("train-mp", step_ms_median=steady * 1e3,
        tokens_per_s=r0["tokens"] / steady,
        mfu=r0["tokens"] / steady * flops / PEAK_FLOPS[torch.bfloat16],
        all_reduce_ms_median=float(np.median(r0["reduce_ms"][1:])),
        losses=[round(x, 4) for x in r0["losses"]],
        grad_norms=[round(x, 4) for x in r0["grad_norms"]],
        evals=r0["evals"])
    if r0["backend"] != "gloo":
        raise AssertionError(f"ranks sharing one card ran {r0['backend']}")
    if steps != MP_STEPS or len(r0["evals"]) != 1 or not r0["fused_ce"]:
        raise AssertionError(f"{steps} steps, {len(r0['evals'])} evals, "
                             f"fused_ce {r0['fused_ce']}")
    for rank, r in enumerate(results):
        if (r["launches"] != want or any(r["plain_calls"].values())
                or any(r["logits_calls"].values())):
            raise AssertionError(
                f"rank {rank}: launches {r['launches']}, want {want}; plain "
                f"{r['plain_calls']}; logits {r['logits_calls']}")
        if (r["losses"] != r0["losses"] or r["evals"] != r0["evals"]
                or r["replicated"] != r0["replicated"]):
            raise AssertionError(f"rank {rank} disagrees with rank 0: "
                                 f"{r['losses']} {r['replicated']}")
    losses = r0["losses"]
    if not all(math.isfinite(x) for x in losses + r0["evals"]):
        raise AssertionError(f"non-finite loss in {losses} {r0['evals']}")
    if not np.mean(losses[-2:]) < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    return r0["launches"]


# ----------------------------------------------------------------- phase 21

def mp_e2e_rank(overrides, batch, grads_path) -> tuple:
    """One rank of a phase-21 run: one train step of a fresh trainer (its
    shards of the seeded init) on its dp rows of the global ``batch``; the
    ranks of dp rank 0 save their gradient shards (by parameter name) to
    ``grads_path`` formatted with their mp rank. Returns (loss, grad
    norm)."""
    cfg = get_config(TRAIN_13B_CONFIG, overrides=list(overrides))
    trainer = Trainer(cfg, build_module(cfg))
    trainer.init_state()
    mesh = trainer.mesh
    b = batch["tokens"].shape[0] // mesh.dp
    rows = {k: v[mesh.dp_rank * b:(mesh.dp_rank + 1) * b]
            for k, v in batch.items()}
    names = [n for n, _ in trainer.module.nets.named_parameters()]
    grads, clip = [], trainer.clip

    def capture(gs, norm=None):
        grads.extend(g.detach().clone() for g in whole_grads(trainer, gs))
        return clip(gs, norm)

    trainer.clip = capture
    out = trainer.train_step(trainer._to_device(rows))
    if mesh.dp_rank == 0:
        torch.save({n: g.cpu() for n, g in zip(names, grads)},
                   grads_path.format(mesh.mp_rank))
    replicated = float(sum(p.detach().double().sum() for n, p in
                           trainer.module.nets.named_parameters()
                           if n not in trainer.mp_split))
    return float(out["loss"]), float(out["grad_norm"]), replicated


def phase_train_mp_e2e(prefix: str) -> None:
    """One step of the 1.3B config with the fused CE cut to MP_E2E_LAYERS
    layers (dropout 0.1, full recompute) three ways on the same global
    batch of 8: mp 1 in this process, mp 2 on 2 ranks and dp 2 x mp 2 on
    4 ranks (all on the card, over gloo). Loss, grad norm and every
    gradient leaf (the shards gathered) of both must lie within phase 8's
    limits of mp 1; every rank the same loss, grad norm and replicated
    parameters."""
    from fleetx_tpu_torch.models.gpt.convert import gather_params
    from fleetx_tpu_torch.parallel.launch import spawn

    base = [own_output_dir(prefix), f"Data.Train.dataset.input_dir={prefix}",
            "Model.fused_ce=True", f"Model.num_layers={MP_E2E_LAYERS}"]
    cfg1 = get_config(TRAIN_13B_CONFIG, overrides=base, nranks=1)
    batch = next(iter(build_dataloader(cfg1, "Train")))
    rows = batch["tokens"].shape[0]
    ref = _e2e_step(cfg1, batch)
    gcfg = build_module(cfg1).gpt_config  # what the shards gather into
    with tempfile.TemporaryDirectory() as tmp:
        for dp in (1, 2):
            path = os.path.join(tmp, f"grads_dp{dp}_mp{{}}.pt")
            over = base + [f"Distributed.mp_degree={MP_DEGREE}",
                           f"Distributed.dp_degree={dp}",
                           f"Global.local_batch_size={rows // dp}",
                           f"Global.micro_batch_size={rows // dp}"]
            outs = spawn(mp_e2e_rank, dp * MP_DEGREE, (over, batch, path),
                         timeout=600)
            grads = gather_params([torch.load(path.format(r))
                                   for r in range(MP_DEGREE)], gcfg)
            grads = {n: g.to(DEVICE) for n, g in grads.items()}
            gaps = _e2e_gaps((outs[0][0], outs[0][1], grads, 0), ref)
            log("train-mp-e2e", layers=MP_E2E_LAYERS, dp=dp, mp=MP_DEGREE,
                loss_this=outs[0][0], loss_mp1=ref[0],
                grad_norm_this=outs[0][1], grad_norm_mp1=ref[1],
                ranks_agree=len(set(outs)) == 1, tol=TRAIN_E2E_TOL, **gaps)
            over = [m for m, tol in TRAIN_E2E_TOL.items()
                    if not gaps[m] <= tol]
            if over or len(set(outs)) != 1 or not math.isfinite(outs[0][0]):
                raise AssertionError(f"dp {dp} x mp {MP_DEGREE} vs mp 1: "
                                     f"{gaps}, ranks {outs}")
            del grads
    del ref
    gc.collect()
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 22
# the resume drive: phase 13's 1.3B configuration, 3 steps, saved at step 2
RESUME_STEPS, RESUME_SAVE_AT = 3, 2
RESUME_LAYERS = 1  # phase 22's depth: 1 of the yaml's 24, for the script's
# time (full width kept; 4 until cut for phases 41-43, 2 for phases 49-50)


def trainer_tensors(trainer):
    """(key, tensor) of every parameter and AdamW state tensor (exp_avg,
    exp_avg_sq, step) by parameter name, and the dropout generator."""
    for n, p in trainer.module.nets.named_parameters():
        yield n, p.detach()
        for k, v in trainer.optimizer.state.get(p, {}).items():
            yield f"{n}:{k}", v.detach()
    yield "generator", trainer.generator.get_state()


def host_state(trainer) -> dict:
    """A copy on the host of :func:`trainer_tensors`."""
    return {k: t.to("cpu", copy=True) for k, t in trainer_tensors(trainer)}


def state_gaps(want: dict, trainer) -> dict:
    """How far ``trainer``'s tensors lie from the host copy ``want``: how
    many differ in any bit, and the largest absolute gap among them
    (compared where the trainer's tensor lies, each copy moved there)."""
    unequal, gap = [], 0.0
    keys = []
    for k, t in trainer_tensors(trainer):
        keys.append(k)
        ref = want[k].to(t.device)
        if torch.equal(t, ref):
            continue
        unequal.append(k)
        if t.is_floating_point():
            gap = max(gap, float((t.double() - ref.double()).abs().max()))
        else:
            gap = math.inf
    if sorted(keys) != sorted(want):
        raise AssertionError("the trainers hold different state tensors")
    return {"tensors": len(keys), "unequal": len(unequal),
            "max_abs_gap": gap, "first_unequal": unequal[:3]}


def run_gaps(ref: dict, run: dict, first: int = 0) -> dict:
    """Per-step loss and grad-norm gaps of ``run`` against ``ref``'s steps
    from ``first`` on, and the state gaps of ``run`` (already measured)."""
    n = len(run["losses"])
    steps = slice(first, first + n)
    return {"loss": max((abs(a - b) for a, b in
                         zip(run["losses"], ref["losses"][steps])),
                        default=0.0),
            "grad_norm": max((abs(a - b) for a, b in
                              zip(run["grad_norms"], ref["grad_norms"][steps])),
                             default=0.0),
            "state": run["state"]["max_abs_gap"],
            "unequal_tensors": run["state"]["unequal"]}


def resume_config(prefix: str, out: str, *extra):
    """Phase 13's configuration (full width, RESUME_LAYERS layers) for
    RESUME_STEPS steps without evaluation, writing into ``out``."""
    return train_13b_config(prefix, f"Engine.max_steps={RESUME_STEPS}",
                            f"Model.num_layers={RESUME_LAYERS}",
                            "Engine.eval_freq=0", "Engine.logging_freq=1",
                            f"Engine.save_load.output_dir={out}", *extra)


def resume_run(cfg, want=None, plant=None, async_snapshot=False) -> dict:
    """A fresh trainer of ``cfg`` fitted to its max_steps. When ``cfg``'s
    output directory holds a step, ``init_state`` restores it (timed) and
    ``load(step=RESUME_SAVE_AT)`` confirms it; ``plant(trainer)`` then
    plants a fault. Every save is timed, with the peak device memory
    across it. Returns the per-step losses and grad norms, the B1-B6
    launches of the fit, the save and load records, and the state: its
    gaps against the host copy ``want``, or the host copy itself."""
    if async_snapshot:
        os.environ["FLEETX_CKPT_ASYNC_SNAPSHOT"] = "1"
    try:
        trainer = Trainer(cfg, build_module(cfg))
    finally:
        os.environ.pop("FLEETX_CKPT_ASYNC_SNAPSHOT", None)
    loads, saves = [], []
    load, save = trainer.load, trainer.save

    def timed_load(step=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = load(step)
        torch.cuda.synchronize()
        loads.append({"step": trainer.step, "seconds":
                      time.perf_counter() - t0})
        return ok

    def timed_save(epoch=0):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        save(epoch)
        saves.append({"step": trainer.step,
                      "held_gb": held / 1e9,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9})

    trainer.load, trainer.save = timed_load, timed_save
    trainer.init_state()
    loader = build_dataloader(cfg, "Train")
    if loads:
        if not (trainer.load(step=RESUME_SAVE_AT)
                and trainer.step == RESUME_SAVE_AT):
            raise AssertionError(f"resumed at step {trainer.step}")
        loader.batch_sampler.consumed_samples = trainer.consumed_samples
    if plant is not None:
        plant(trainer)
    zero_train_launches()
    trainer.fit(loader)
    torch.cuda.synchronize()
    out = {"losses": [float(h["loss"]) for h in trainer.history],
           "grad_norms": [float(h["grad_norm"]) for h in trainer.history],
           "launches": {**fa.launches, **ce.launches}, "loads": loads,
           "saves": saves, "last_save": trainer.last_save,
           "save_failures": trainer.save_failures,
           "step": trainer.step, "consumed": trainer.consumed_samples,
           "state": (host_state(trainer) if want is None
                     else state_gaps(want, trainer))}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_resume_13b(prefix: str) -> dict:
    """The port's resume at the 1.3B step. Run A: RESUME_STEPS steps of
    phase 13's configuration saving at step RESUME_SAVE_AT through the
    async snapshot. Run A2: the same steps again, no save: the card's
    run-to-run gap on this path (0 when it repeats bit for bit). Run B: a
    fresh trainer restores step RESUME_SAVE_AT and trains the last step:
    its loss, grad norm, parameters, AdamW state and generator must equal
    A's within A2's gap (bit for bit when that is 0). Two planted faults,
    a resume without the generator's state and one without the AdamW
    moments, must each break that gate. Returns run A's launch counts."""
    out_a = tempfile.mkdtemp(prefix="out-", dir=os.path.dirname(prefix))
    free = shutil.disk_usage(out_a).free
    log("resume-1.3b", disk_free_gb=free / 1e9, where=out_a)
    cfg_a = resume_config(prefix, out_a,
                          f"Engine.save_load.save_steps={RESUME_SAVE_AT}")
    a = resume_run(cfg_a, async_snapshot=True)
    want_state = a.pop("state")
    layers = cfg_a.Model.num_layers
    want = {"ce_fwd": RESUME_STEPS, "ce_dh": RESUME_STEPS,
            "ce_dw": RESUME_STEPS, "flash_fwd": layers * 2 * RESUME_STEPS,
            "flash_bwd_dq": layers * RESUME_STEPS,
            "flash_bwd_dkv": layers * RESUME_STEPS}
    if a["launches"] != want:
        raise AssertionError(f"run A launched {a['launches']}, want {want}")
    saved = a["last_save"]
    if (saved is None or saved["step"] != RESUME_SAVE_AT or a["save_failures"]
            or saved["total_s"] is None or len(a["saves"]) != 1):
        raise AssertionError(f"run A's saves: {a['saves']} {saved}")
    ckpt = os.path.join(out_a, "checkpoints", str(RESUME_SAVE_AT))
    nbytes = sum(os.path.getsize(os.path.join(ckpt, f))
                 for f in os.listdir(ckpt))
    log("resume-1.3b", run="A", layers=layers, steps=a["step"],
        losses=a["losses"], grad_norms=a["grad_norms"],
        launches=a["launches"], checkpoint_bytes=nbytes,
        state_bytes=saved["bytes"], save_blocking_s=saved["blocking_s"],
        save_write_s=saved["write_s"], save_total_s=saved["total_s"],
        save_peak_mem_gb=a["saves"][0]["peak_gb"],
        save_held_mem_gb=a["saves"][0]["held_gb"])
    a2 = resume_run(resume_config(prefix, tempfile.mkdtemp(
        prefix="out-", dir=os.path.dirname(prefix)),
        "Engine.save_load.save_steps=0"), want=want_state)
    spread = run_gaps(a, a2)
    bitwise = (a2["losses"] == a["losses"]
               and a2["grad_norms"] == a["grad_norms"]
               and a2["state"]["unequal"] == 0)
    log("resume-1.3b", run="A2 (the same steps again)", bitwise=bitwise,
        losses=a2["losses"], grad_norms=a2["grad_norms"],
        state=a2["state"], run_to_run_gap=spread)
    if not (math.isfinite(spread["state"]) and a2["step"] == a["step"]):
        raise AssertionError(f"run A2 against A: {spread}")
    limit = {k: spread[k] for k in ("loss", "grad_norm", "state")}

    def resumed(plant=None):
        run = resume_run(resume_config(prefix, out_a), want=want_state,
                         plant=plant)
        gaps = run_gaps(a, run, first=RESUME_SAVE_AT)
        held = (run["step"] == a["step"] and run["consumed"] == a["consumed"]
                and all(gaps[k] <= limit[k] for k in limit)
                and (not bitwise or gaps["unequal_tensors"] == 0))
        return run, gaps, held

    b, gaps, held = resumed()
    log("resume-1.3b", run="B (resumed)", losses=b["losses"],
        grad_norms=b["grad_norms"], state=b["state"], gaps=gaps,
        limit=limit, held=held, load_seconds=b["loads"][0]["seconds"],
        consumed=b["consumed"], launches=b["launches"])
    if b["launches"] != {k: v // RESUME_STEPS for k, v in want.items()}:
        raise AssertionError(f"the resumed step launched {b['launches']}")
    if not held:
        raise AssertionError(f"the resume departs from run A: {gaps}, "
                             f"limit {limit}")

    def no_generator(trainer):
        trainer.generator.manual_seed(trainer.seed)

    def no_moments(trainer):
        for s in trainer.optimizer.state.values():
            s["exp_avg"].zero_()
            s["exp_avg_sq"].zero_()

    for name, plant in (("generator not restored", no_generator),
                        ("AdamW moments not restored", no_moments)):
        _, fault_gaps, fault_held = resumed(plant)
        log("resume-1.3b", planted_fault=repr(name), gaps=fault_gaps,
            caught=not fault_held)
        if fault_held:
            raise AssertionError(f"phase 22 misses the planted fault "
                                 f"{name!r}: {fault_gaps}")
    return {**a["launches"], "checkpoint_bytes": nbytes,
            "save_blocking_s": saved["blocking_s"],
            "save_total_s": saved["total_s"],
            "load_s": b["loads"][0]["seconds"], "bitwise": bitwise}


# ----------------------------------------------------------------- phase 23
PREEMPT_STEPS, PREEMPT_AT = 6, 3
PREEMPT_LAYERS = 2  # of the 345M yaml's 24 (24 until cut for phases 41-43,
# 4 until cut for phases 49-50)
# the training CLI as a command (its own interpreter)
TRAIN_CLI = [sys.executable, "-m", "fleetx_tpu_torch.tools.train"]
TRAIN_LINE = re.compile(r"\[train\] epoch: \d+, batch: (\d+), loss: "
                        r"([-0-9.naif]+),")
# the trainer's own lines: a save's and a load's seconds
SAVED_LINE = re.compile(r"saved checkpoint at step \d+ -> \S+ \(([0-9.]+) s")
LOADED_LINE = re.compile(r"restored checkpoint step \d+ \(epoch \d+\) in "
                         r"([0-9.]+) s")


def run_cli(argv, signal_at=None, timeout=600.0) -> dict:
    """``TRAIN_CLI`` with ``argv`` from the repo's root (the synchronous
    save path: no async snapshot). Its log's per-step losses (as printed,
    9 decimals), the seconds from launch to its first step line, and,
    given ``signal_at``, the seconds from the SIGTERM sent once the log
    shows step ``signal_at`` to the process's exit."""
    env = {k: v for k, v in os.environ.items()
           if k != "FLEETX_CKPT_ASYNC_SNAPSHOT"}
    t0 = time.perf_counter()
    proc = subprocess.Popen(TRAIN_CLI + list(argv), cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    watchdog = threading.Timer(timeout, proc.kill)  # a silent hang ends too
    watchdog.start()
    losses, first_step_s, signalled, lines = {}, None, None, []
    seconds = {}
    try:
        for line in proc.stdout:
            lines.append(line)
            for key, pattern in (("save_s", SAVED_LINE),
                                 ("load_s", LOADED_LINE)):
                m = pattern.search(line)
                if m is not None:
                    seconds[key] = float(m.group(1))
            m = TRAIN_LINE.search(line)
            if m is None:
                continue
            losses[int(m.group(1))] = m.group(2)
            if first_step_s is None:
                first_step_s = time.perf_counter() - t0
            if signal_at is not None and signalled is None \
                    and int(m.group(1)) >= signal_at:
                signalled = time.perf_counter()
                proc.send_signal(signal.SIGTERM)
        rc = proc.wait()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    exited = time.perf_counter()
    if rc != 0:
        raise AssertionError(f"the CLI exited {rc}:\n" + "".join(lines[-40:]))
    return {"losses": losses, "first_step_s": first_step_s, **seconds,
            "signal_to_exit_s": (None if signalled is None
                                 else exited - signalled),
            "log_tail": lines[-3:]}


def phase_preempt(prefix: str) -> dict:
    """``tools/train.py`` as a subprocess on the 345M yaml (full width,
    PREEMPT_LAYERS of its 24 layers) over the corpus at ``prefix``: an
    uninterrupted reference to
    step PREEMPT_STEPS; a launch sent SIGTERM once its log shows step
    PREEMPT_AT must exit 0 with a checkpoint at the step it reached; a
    relaunch with ``ckpt_dir`` must resume there and end at step
    PREEMPT_STEPS. The two launches' per-step losses, joined, must equal
    the reference's as printed (9 decimals, which tell float32 losses of
    this size apart)."""
    base = ["-c", TRAIN_CONFIG, "-o", f"Data.Train.dataset.input_dir={prefix}",
            "-o", f"Model.num_layers={PREEMPT_LAYERS}",
            "-o", f"Engine.max_steps={PREEMPT_STEPS}",
            "-o", "Engine.logging_freq=1", "-o", "Engine.eval_freq=0",
            "-o", "Engine.save_load.save_steps=0",
            "-o", "Optimizer.lr.warmup_steps=2",
            "-o", "Optimizer.lr.max_lr=5.0e-4"]
    out = tempfile.mkdtemp(prefix="out-", dir=os.path.dirname(prefix))
    out_arg = ["-o", f"Engine.save_load.output_dir={out}"]
    # the reference and the preempted launch run side by side on the card
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ref = pool.submit(run_cli, base + ["-o", own_output_dir(prefix)])
        first = run_cli(base + out_arg, signal_at=PREEMPT_AT)
        ref = ref.result()
    steps = sorted(int(n) for n in os.listdir(os.path.join(out, "checkpoints"))
                   if n.isdigit())
    second = run_cli(base + out_arg + [
        "-o", f"Engine.save_load.ckpt_dir={out}"])
    reached = max(first["losses"])
    joined = {**first["losses"], **second["losses"]}
    log("preempt", ref_losses=ref["losses"], first_losses=first["losses"],
        checkpoints=steps, second_losses=second["losses"],
        signal_to_exit_s=first["signal_to_exit_s"],
        save_s=first.get("save_s"), load_s=second.get("load_s"),
        resume_to_first_step_s=second["first_step_s"],
        fresh_to_first_step_s=ref["first_step_s"],
        second_log_tail=second["log_tail"])
    if steps != [reached] or reached < PREEMPT_AT or reached >= PREEMPT_STEPS:
        raise AssertionError(f"preempted at step {reached}, checkpoints "
                             f"{steps}")
    if (min(second["losses"]) != reached + 1
            or max(second["losses"]) != PREEMPT_STEPS):
        raise AssertionError(f"the relaunch trained {sorted(second['losses'])}"
                             f" after step {reached}")
    if joined != ref["losses"] or len(joined) != PREEMPT_STEPS:
        raise AssertionError(f"preempted and resumed {joined} against the "
                             f"uninterrupted {ref['losses']}")
    if first.get("save_s") is None or second.get("load_s") is None:
        raise AssertionError("the launches logged no save or no load")
    return {"signal_to_exit_s": first["signal_to_exit_s"],
            "save_s": first["save_s"], "load_s": second["load_s"],
            "resume_to_first_step_s": second["first_step_s"]}


# ----------------------------------------------------------------- phase 24
SENTRY_LAYERS, SENTRY_BATCHES, SENTRY_NAN_AT = 2, 4, 2  # 4 layers and 5
# batches until cut for phases 41-43
SENTRY_COST_STEPS, SENTRY_COST_LAYERS = 6, 4  # 10 steps at 24 until cut


def sentry_fit(cfg, data) -> dict:
    """A fresh trainer of ``cfg`` fitted on the list ``data``; its state
    on the host, skips, step, consumed samples and B4-B6 launches."""
    trainer = Trainer(cfg, build_module(cfg))
    trainer.init_state()
    zero_train_launches()
    trainer.fit(data)
    torch.cuda.synchronize()
    out = {"state": host_state(trainer), "skips": trainer.sentry_skips,
           "step": trainer.step, "consumed": trainer.consumed_samples,
           "losses": [float(h["loss"]) for h in trainer.history],
           "launches": {**fa.launches, **ce.launches}}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sentry_step_ms(prefix: str, sentry: str) -> dict:
    """SENTRY_COST_STEPS steps of phase 13's configuration cut to
    SENTRY_COST_LAYERS layers with ``FLEETX_SENTRY=sentry``: the median
    interval between the ends of consecutive steps (CUDA events; the first
    two left out)."""
    os.environ["FLEETX_SENTRY"] = sentry
    try:
        cfg = train_13b_config(prefix, f"Engine.max_steps={SENTRY_COST_STEPS}",
                               f"Model.num_layers={SENTRY_COST_LAYERS}",
                               "Engine.eval_freq=0")
        trainer = Trainer(cfg, build_module(cfg))
    finally:
        os.environ.pop("FLEETX_SENTRY", None)
    trainer.init_state()
    ends, step = [], trainer.train_step

    def timed(batch):
        out = step(batch)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        return out

    trainer.train_step = timed
    trainer.fit(build_dataloader(cfg, "Train"))
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
    out = {"sentry": sentry, "step_ms_median": float(np.median(step_ms[2:])),
           "steps": trainer.step, "enabled": trainer._sentry_enabled}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_sentry(prefix: str) -> dict:
    """Phase 14's 1.3B configuration cut to SENTRY_LAYERS layers: over
    SENTRY_BATCHES batches with batch SENTRY_NAN_AT poisoned by the fault
    injector (``loss_mask`` NaN, through B4-B6), the sentry skips one
    step, and the parameters, AdamW state and generator equal those of a
    run over the other batches bit for bit; the skipped batch counts as
    consumed. Then the cost of the sentry's host read: phase 13's
    configuration at SENTRY_COST_LAYERS layers with the sentry on and off,
    in the order on, off, off, on."""
    cfg = train_13b_config(prefix, f"Model.num_layers={SENTRY_LAYERS}",
                           f"Engine.max_steps={SENTRY_BATCHES}",
                           "Engine.eval_freq=0")
    it = iter(build_dataloader(cfg, "Train"))
    data = [next(it) for _ in range(SENTRY_BATCHES)]
    faults.configure(nan_batch=str(SENTRY_NAN_AT))
    try:
        faulty = sentry_fit(cfg, data)
        injected = faults.injected["nan"]
    finally:
        faults.reset()
    clean = sentry_fit(cfg, [b for i, b in enumerate(data)
                             if i != SENTRY_NAN_AT])
    unequal = [k for k in clean["state"]
               if not torch.equal(clean["state"][k], faulty["state"][k])]
    batch = cfg.Global.global_batch_size
    log("sentry", layers=SENTRY_LAYERS, batches=SENTRY_BATCHES,
        nan_batch=SENTRY_NAN_AT, injected=injected, skips=faulty["skips"],
        steps=faulty["step"], consumed=faulty["consumed"],
        losses=faulty["losses"], clean_losses=clean["losses"],
        launches=faulty["launches"], clean_launches=clean["launches"],
        tensors=len(clean["state"]), unequal_tensors=len(unequal))
    n = SENTRY_BATCHES
    if (injected != 1 or faulty["skips"] != 1 or faulty["step"] != n - 1
            or faulty["consumed"] != n * batch
            or clean["consumed"] != (n - 1) * batch):
        raise AssertionError(f"skips {faulty['skips']}, step "
                             f"{faulty['step']}, consumed "
                             f"{faulty['consumed']}")
    if any(faulty["launches"][k] != n for k in ce.NAMES):
        raise AssertionError(f"B4-B6 launched {faulty['launches']}: the NaN "
                             "batch did not pass through them")
    if unequal or faulty["losses"] != clean["losses"]:
        raise AssertionError(f"the skip moved {unequal[:3]}")
    del faulty, clean
    costs = [sentry_step_ms(prefix, s) for s in ("1", "0", "0", "1")]
    on = [c["step_ms_median"] for c in costs if c["sentry"] == "1"]
    off = [c["step_ms_median"] for c in costs if c["sentry"] == "0"]
    cost = (np.mean(on) - np.mean(off)) / np.mean(off)
    log("sentry", step_ms_on=on, step_ms_off=off, cost_share=cost)
    if [c["enabled"] for c in costs] != [True, False, False, True] or any(
            c["steps"] != SENTRY_COST_STEPS for c in costs):
        raise AssertionError(f"the sentry cost runs: {costs}")
    return {"step_ms_on": on, "step_ms_off": off, "cost_share": cost}


# ----------------------------------------------------------------- phase 25
RESUME_MP_LAYERS = 1  # phase 25's depth (2 until cut for phases 49-50)


def tensor_digests(trainer) -> dict:
    """sha256 of the bytes of every tensor of :func:`trainer_tensors`."""
    return {k: hashlib.sha256(t.cpu().reshape(-1).view(torch.uint8)
                              .numpy().tobytes()).hexdigest()
            for k, t in trainer_tensors(trainer)}


def mp_resume_rank(overrides, resume: bool) -> dict:
    """One rank of phase 25: a fresh trainer of ``overrides`` (which name
    its output directory) fitted to its max_steps; with ``resume`` it
    restores that directory's step 1 first and its sampler starts after
    the consumed samples. Returns the per-step losses and grad norms,
    digests of its tensors, its step, consumed samples and launches."""
    cfg = get_config(TRAIN_13B_CONFIG, overrides=list(overrides))
    trainer = Trainer(cfg, build_module(cfg))
    trainer.init_state()
    loader = build_dataloader(cfg, "Train")
    if resume:
        if not (trainer.load(step=1) and trainer.step == 1):
            raise AssertionError(f"resumed at step {trainer.step}")
        loader.batch_sampler.consumed_samples = trainer.consumed_samples
    for counts in (fa.launches, ce.launches, ce.vp_launches):
        counts.update(dict.fromkeys(counts, 0))
    trainer.fit(loader)
    torch.cuda.synchronize()
    return {"losses": [float(h["loss"]) for h in trainer.history],
            "grad_norms": [float(h["grad_norm"]) for h in trainer.history],
            "digests": tensor_digests(trainer), "step": trainer.step,
            "consumed": trainer.consumed_samples,
            "launches": {**fa.launches, **ce.launches, **ce.vp_launches}}


def phase_resume_mp(prefix: str) -> None:
    """Phase 21's configuration (the 1.3B cut to RESUME_MP_LAYERS layers,
    fused CE) at mp 2 on 2 ranks sharing the card over gloo: an
    uninterrupted run of 2 steps that saves per-rank files at step 1 and
    2; fresh processes resume from a copy of step 1 alone and take step
    2. On both ranks the step-2 loss and grad norm and every parameter,
    AdamW tensor and the generator equal the uninterrupted run's (sha256
    of their bytes). A load of that checkpoint at mp 1 raises
    ``ElasticMeshMismatch`` and quarantines nothing."""
    from fleetx_tpu_torch.parallel.launch import spawn
    from fleetx_tpu_torch.resilience.elastic import ElasticMeshMismatch

    whole = tempfile.mkdtemp(prefix="out-", dir=os.path.dirname(prefix))
    part = tempfile.mkdtemp(prefix="out-", dir=os.path.dirname(prefix))
    base = [f"Data.Train.dataset.input_dir={prefix}", "Model.fused_ce=True",
            f"Model.num_layers={RESUME_MP_LAYERS}", "Engine.max_steps=2",
            "Engine.logging_freq=1", "Engine.save_load.save_steps=1",
            "Optimizer.lr.warmup_steps=1", "Optimizer.lr.max_lr=3.0e-4"]
    mp = [f"Distributed.mp_degree={MP_DEGREE}"]
    t0 = time.perf_counter()
    a = spawn(mp_resume_rank, MP_DEGREE,
              (base + mp + [f"Engine.save_load.output_dir={whole}"], False),
              timeout=600)
    shutil.copytree(os.path.join(whole, "checkpoints", "1"),
                    os.path.join(part, "checkpoints", "1"))
    files = sorted(os.listdir(os.path.join(part, "checkpoints", "1")))
    b = spawn(mp_resume_rank, MP_DEGREE,
              (base + mp + [f"Engine.save_load.output_dir={part}"], True),
              timeout=600)
    for rank, (x, y) in enumerate(zip(a, b)):
        unequal = [k for k in x["digests"] if x["digests"][k] !=
                   y["digests"].get(k)]
        log("resume-mp", rank=rank, layers=RESUME_MP_LAYERS, mp=MP_DEGREE,
            files=files, losses=x["losses"], resumed_losses=y["losses"],
            grad_norms=x["grad_norms"], resumed_grad_norms=y["grad_norms"],
            tensors=len(x["digests"]), unequal_tensors=len(unequal),
            launches=x["launches"], resumed_launches=y["launches"])
        if (unequal or y["losses"] != x["losses"][1:]
                or y["grad_norms"] != x["grad_norms"][1:]
                or (x["step"], x["consumed"]) != (y["step"], y["consumed"])
                or x["digests"].keys() != y["digests"].keys()):
            raise AssertionError(f"rank {rank}: the resume departs from the "
                                 f"uninterrupted run ({unequal[:3]})")
        if not (y["launches"]["vp_ce_fwd"] == 1
                and y["launches"]["flash_bwd_dkv"] == RESUME_MP_LAYERS):
            raise AssertionError(f"rank {rank} launched {y['launches']}")
    if files != ["meta.json", "state-mp0.pt", "state-mp1.pt"]:
        raise AssertionError(f"step 1 holds {files}")
    cfg1 = get_config(TRAIN_13B_CONFIG, overrides=base + [
        f"Engine.save_load.output_dir={part}"], nranks=1)
    trainer = Trainer(cfg1, build_module(cfg1))
    try:
        trainer.init_state()
        raise AssertionError("an mp 2 checkpoint loaded at mp 1")
    except ElasticMeshMismatch as e:
        refused = str(e)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    steps = sorted(os.listdir(os.path.join(part, "checkpoints")))
    quarantined = os.path.exists(os.path.join(part, "quarantine"))
    log("resume-mp", mp1_load=refused, steps_left=steps,
        quarantined=quarantined, seconds=time.perf_counter() - t0)
    if steps != ["1", "2"] or quarantined:
        raise AssertionError(f"after the refused load: {steps}, quarantine "
                             f"{quarantined}")


# ----------------------------------------------------------------- phase 26
# the pipeline drives: the 1.3B yaml at pp 2, its batch of 8 streamed as 4
# microbatches of 2 (Engine.accumulate_steps 4); phase 26 and 28 cut it to
# PP_E2E_LAYERS layers, phase 27 runs it at full width and depth
PP_DEGREE, PP_MICRO, PP_E2E_LAYERS = 2, 2, 4
RESUME_PP_LAYERS = 2  # phase 28's depth: one layer a stage (4 until cut for
# phases 49-50)
PP_STEPS, PP_V2_STEPS, PP_EVAL_ITERS = 3, 3, 1  # 5 pp steps until cut
PP_TRAIN_LAYERS = 4  # phase 27's depth: the yaml's 24 cut for time


def pp_e2e_overrides(prefix: str, *extra) -> list:
    """Phase 26's configuration: the 1.3B yaml cut to PP_E2E_LAYERS layers
    (the logits loss: the fused CE is off under pp), hidden dropout 0,
    attention dropout 0.1, microbatches of PP_MICRO rows."""
    return [own_output_dir(prefix), f"Data.Train.dataset.input_dir={prefix}",
            f"Model.num_layers={PP_E2E_LAYERS}",
            "Model.hidden_dropout_prob=0.0",
            "Model.attention_probs_dropout_prob=0.1",
            f"Global.micro_batch_size={PP_MICRO}", *extra]


def swap_first_sends():
    """A planted fault: the first stage's first two sends (microbatches 0
    and 1 leaving chunk 0) go out in the other order, so the next stage
    runs each microbatch's layers on the other's activations. Returns the
    function that takes the fault out again."""
    from fleetx_tpu_torch.parallel import pipeline as pl

    send, held = pl.Transport.send, []

    def swapped(self, t, dst):
        if len(held) == 0:
            held.append((t.detach().clone(), dst))
            return
        send(self, t, dst)
        if len(held) == 1:
            send(self, *held[0])
            held.append(None)

    pl.Transport.send = swapped
    return lambda: setattr(pl.Transport, "send", send)


def pp_e2e_rank(runs, batch, grads_path) -> list:
    """One rank of phase 26: for each (label, overrides, fault) of ``runs``
    in turn, one train step of a fresh trainer (its stage and shards of
    the seeded init) on the global ``batch``; the ranks of dp rank 0
    save their gradients (by parameter name) to ``grads_path`` formatted
    with the label, their stage and mp rank. ``fault``: None, ``"tied"``
    (the tied embedding's gradient not summed over its two stages) or
    ``"swap"`` (:func:`swap_first_sends` on the first stage). Returns
    [(loss, grad norm)] in the order of ``runs``."""
    from fleetx_tpu_torch.core import engine

    out = []
    for label, overrides, fault in runs:
        cfg = get_config(TRAIN_13B_CONFIG, overrides=list(overrides))
        trainer = Trainer(cfg, build_module(cfg))
        trainer.init_state()
        mesh = trainer.mesh
        undo = None
        if fault == "tied":
            summed = engine.Trainer._sum_tied_grads
            engine.Trainer._sum_tied_grads = lambda self, *args: None
            undo = lambda: setattr(engine.Trainer, "_sum_tied_grads", summed)
        elif fault == "swap" and mesh.is_first_stage:
            undo = swap_first_sends()
        names = [n for n, _ in trainer.module.nets.named_parameters()]
        grads, clip = [], trainer.clip

        def capture(gs, norm=None):
            grads.extend(g.detach().clone()
                         for g in whole_grads(trainer, gs))
            return clip(gs, norm)

        trainer.clip = capture
        try:
            step = trainer.train_step(trainer._to_device(batch))
        finally:
            if undo is not None:
                undo()
        if mesh.dp_rank == 0:
            torch.save({n: g.cpu() for n, g in zip(names, grads)},
                       grads_path.format(label=label, pp=mesh.pp_rank,
                                         mp=mesh.mp_rank))
        out.append((float(step["loss"]), float(step["grad_norm"])))
        del trainer, grads
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_train_pp_e2e(prefix: str) -> None:
    """One step of the 1.3B config cut to PP_E2E_LAYERS layers (hidden
    dropout 0, attention dropout 0.1) on the same global batch of 8 rows
    as 4 microbatches of 2: at pp 1 in this process (accumulating over
    them), and at pp 2, pp 2 × v 2, mp 2 and pp 2 × mp 2 on ranks sharing
    the card over gloo. Each pipeline is held to the unpipelined run of
    its own tensor layout within phase 8's limits, every rank the same
    loss and grad norm: pp 2 and pp 2 × v 2 to pp 1, pp 2 × mp 2 to mp 2
    (mp's bf16 sums of row-parallel partials alone move the loss by about
    phase 8's loss limit, phase 21's concern; those gaps to pp 1 are
    logged beside). Gradients are compared leaf by leaf, the stages
    joined and the mp shards gathered. The tied embedding's gradient left
    unsummed over its two stages, and two microbatches' activations
    swapped at the stage boundary, must each break a limit against pp
    1."""
    from fleetx_tpu_torch.models.gpt.convert import (
        gather_params,
        gather_stages,
    )
    from fleetx_tpu_torch.parallel.launch import spawn

    base = pp_e2e_overrides(prefix)
    cfg1 = get_config(TRAIN_13B_CONFIG, overrides=base, nranks=1)
    batch = next(iter(build_dataloader(cfg1, "Train")))
    if cfg1.Engine.accumulate_steps != 4:
        raise AssertionError(f"pp 1 accumulates "
                             f"{cfg1.Engine.accumulate_steps} microbatches")
    gcfg = build_module(cfg1).gpt_config
    runs = {"pp1": _e2e_step(cfg1, batch)}
    pp = [f"Distributed.pp_degree={PP_DEGREE}"]
    mp = [f"Distributed.mp_degree={MP_DEGREE}"]
    v2 = ["Model.virtual_pp_degree=2"]
    # label: (overrides, fault, the run it is held to, its pp and mp)
    two = (PP_DEGREE, 1)
    plan = {"pp2": (pp, None, "pp1", two),
            "pp2xv2": (pp + v2, None, "pp1", two),
            "tied": (pp, "tied", "pp1", two), "swap": (pp, "swap", "pp1", two),
            "mp2": (mp, None, None, (1, MP_DEGREE)),
            "pp2xmp2": (pp + mp, None, "mp2", (PP_DEGREE, MP_DEGREE))}
    faults = {"tied": "the tied embedding's gradient not summed over its "
                      "two stages",
              "swap": "microbatches 0 and 1 swapped at the stage boundary"}
    spawns = {PP_DEGREE: ["pp2", "pp2xv2", "tied", "swap", "mp2"],
              PP_DEGREE * MP_DEGREE: ["pp2xmp2"]}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "grads_{label}_pp{pp}_mp{mp}.pt")
        for nprocs, labels in spawns.items():
            t0 = time.perf_counter()
            outs = spawn(pp_e2e_rank, nprocs,
                         ([(x, base + plan[x][0], plan[x][1])
                           for x in labels], batch, path), timeout=600)
            for i, label in enumerate(labels):
                stages, m = plan[label][3]
                shards = [gather_stages([torch.load(path.format(
                    label=label, pp=p, mp=r)) for p in range(stages)])
                    for r in range(m)]
                grads = gather_params(shards, dataclasses.replace(
                    gcfg, mp_degree=m))
                if len({o[i] for o in outs}) != 1:
                    raise AssertionError(f"{label}: the ranks disagree: "
                                         f"{[o[i] for o in outs]}")
                runs[label] = (*outs[0][i], {n: g.to(DEVICE) for n, g in
                                             grads.items()}, 0)
            log("pp-e2e", ranks=nprocs, runs=len(labels),
                seconds=time.perf_counter() - t0)
    for label, (_, fault, held_to, _) in plan.items():
        run = runs[label]
        gaps = _e2e_gaps(run, runs[held_to or "pp1"])
        over = [m for m, tol in TRAIN_E2E_TOL.items() if not gaps[m] <= tol]
        if fault is not None:
            log("pp-e2e", planted_fault=repr(faults[fault]), caught=over,
                **gaps)
            if not over:
                raise AssertionError(f"phase 26 misses the planted fault "
                                     f"{faults[fault]!r}: {gaps}")
            continue
        to_pp1 = {} if held_to in (None, "pp1") else {
            f"{k}_to_pp1": v for k, v in _e2e_gaps(run, runs["pp1"]).items()}
        log("pp-e2e", layers=PP_E2E_LAYERS, run=label,
            held_to=held_to or "none (phase 21 holds mp)", loss_this=run[0],
            loss_ref=runs[held_to or "pp1"][0], grad_norm_this=run[1],
            grad_norm_ref=runs[held_to or "pp1"][1], tol=TRAIN_E2E_TOL,
            **gaps, **to_pp1)
        if held_to is not None and (over or not math.isfinite(run[0])):
            raise AssertionError(f"{label} vs {held_to}: {gaps}")
    del runs
    gc.collect()
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 27

def pp_overrides(prefix: str, *extra) -> list:
    """The 1.3B yaml at pp 2 over the corpus at ``prefix``: its batch of 8
    as 4 microbatches of 2, the logits loss, PP_STEPS steps (warmup 1, a
    max_lr at which the loss moves within the drive) and one evaluation
    over PP_EVAL_ITERS batch; full width, PP_TRAIN_LAYERS layers, bf16,
    dropout 0.1, full recompute (from the yaml)."""
    return [own_output_dir(prefix), f"Data.Train.dataset.input_dir={prefix}",
            f"Data.Eval.dataset.input_dir={prefix}",
            f"Distributed.pp_degree={PP_DEGREE}",
            f"Model.num_layers={PP_TRAIN_LAYERS}",
            f"Global.micro_batch_size={PP_MICRO}",
            f"Engine.max_steps={PP_STEPS}", "Engine.logging_freq=1",
            f"Engine.eval_freq={PP_STEPS}",
            f"Engine.eval_iters={PP_EVAL_ITERS}",
            "Optimizer.lr.warmup_steps=1", "Optimizer.lr.max_lr=3.0e-4",
            "Optimizer.lr.min_lr=3.0e-5", "Optimizer.lr.decay_steps=1000",
            *extra]


def pp_fit_watched(argv) -> dict:
    """``tools/train.py``'s ``main`` on ``argv`` on this rank, watched:
    CUDA events at the ends of the steps; every point-to-point send and
    receive and every collective timed on the host (synchronised on both
    sides, so a receive includes the wait for the other stage) and summed
    per step with its bytes; a fingerprint of the tied word embedding
    after every step (two int64 sums of its bits, on the card); the
    evaluation's mean; the plain versions of B1-B3 counted (none may
    run); B1-B6 and B12 launches from 0 at the start."""
    import torch.distributed as dist

    from fleetx_tpu_torch.core import engine
    from fleetx_tpu_torch.parallel import pipeline as pl
    from fleetx_tpu_torch.tools import train as train_cli

    ends, evals, prints, events = [], [], [], []
    saved = (engine.Trainer.train_step, engine.Trainer.evaluate,
             pl.Transport.send, pl.Transport.recv, dist.all_reduce,
             dist.broadcast)
    step, evaluate, send, recv, all_reduce, broadcast = saved

    def synced(kind, fn, nbytes):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            events.append((kind, (time.perf_counter() - t0) * 1e3,
                           nbytes(a, out)))
            return out
        return wrapper

    def timed_step(self, batch):
        first = len(events)
        out = step(self, batch)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        mine = events[first:]
        per = {k: (sum(ms for kk, ms, _ in mine if kk == k),
                   sum(b for kk, _, b in mine if kk == k))
               for k in ("p2p", "collective")}
        tied = self.module.nets.gpt.word_embeddings.detach()
        bits = tied.view(torch.int32).long()
        prints.append((per, torch.stack([bits.sum(), (bits * bits).sum()])))
        return out

    def kept_eval(self, data, epoch=0):
        evals.append(evaluate(self, data, epoch))
        return evals[-1]

    def size(t):
        return t.numel() * t.element_size()

    calls = dict.fromkeys(PLAIN_FLASH.values(), 0)

    def counted(fn):
        def wrapper(*a, **kw):
            calls[fn] += 1
            return fn(*a, **kw)
        return wrapper

    engine.Trainer.train_step, engine.Trainer.evaluate = timed_step, kept_eval
    pl.Transport.send = synced("p2p", send, lambda a, out: size(a[1]))
    pl.Transport.recv = synced("p2p", recv, lambda a, out: size(out))
    dist.all_reduce = synced("collective", all_reduce,
                             lambda a, out: size(a[0]))
    dist.broadcast = synced("collective", broadcast,
                            lambda a, out: size(a[0]))
    for fn in calls:
        setattr(fa, fn.__name__, counted(fn))
    try:
        torch.cuda.reset_peak_memory_stats()
        for counts in (fa.launches, ce.launches, ce.vp_launches):
            counts.update(dict.fromkeys(counts, 0))
        t0 = time.perf_counter()
        trainer = train_cli.main(list(argv))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        (engine.Trainer.train_step, engine.Trainer.evaluate,
         pl.Transport.send, pl.Transport.recv, dist.all_reduce,
         dist.broadcast) = saved
        for fn in calls:
            setattr(fa, fn.__name__, fn)
    gcfg = trainer.module.gpt_config
    step_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
    per = [p for p, _ in prints[1:]]
    tied = trainer.module.nets.gpt.word_embeddings.detach()
    return {"losses": [float(h["loss"]) for h in trainer.history],
            "grad_norms": [float(h["grad_norm"]) for h in trainer.history],
            "evals": evals, "step_ms": step_ms,
            "p2p_ms": [p["p2p"][0] for p in per],
            "p2p_mb": [p["p2p"][1] / 1e6 for p in per],
            "collective_ms": [p["collective"][0] for p in per],
            "collective_mb": [p["collective"][1] / 1e6 for p in per],
            "tied_prints": [f.tolist() for _, f in prints],
            "tied_sha256": hashlib.sha256(tied.cpu().reshape(-1).view(
                torch.uint8).numpy().tobytes()).hexdigest(),
            "launches": {**fa.launches, **ce.launches, **ce.vp_launches},
            "plain_calls": {fn.__name__: c for fn, c in calls.items()},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "n_params": trainer.n_params, "steps": trainer.step,
            "fit_seconds": seconds, "layers": gcfg.num_layers,
            "stage_layers": len(trainer.module.nets.gpt.layers),
            "microbatches": gcfg.num_microbatches,
            "virtual_pp": gcfg.virtual_pp, "fused_ce": gcfg.fused_ce,
            "recompute": gcfg.recompute_granularity,
            "pp_rank": trainer.mesh.pp_rank,
            "tokens": trainer.cfg.Global.global_batch_size
            * trainer.cfg.Data.Train.dataset.max_seq_len}


def pp_train_rank(argv, argv_v2, port_v2) -> list:
    """One rank of phase 27: the pp 2 drive (:func:`pp_fit_watched` on
    ``argv``), then, in a process group rebuilt on ``port_v2``, the
    virtual pp 2 drive on ``argv_v2``. Returns both records."""
    import torch.distributed as dist

    from fleetx_tpu_torch.parallel.mesh import set_mesh

    backend = dist.get_backend()
    first = pp_fit_watched(argv)  # main() leaves the group at its end
    gc.collect()
    torch.cuda.empty_cache()
    set_mesh(None)
    os.environ["MASTER_PORT"] = str(port_v2)
    second = pp_fit_watched(argv_v2)
    return [dict(first, backend=backend), dict(second, backend=backend)]


def phase_train_pp(prefix: str) -> dict:
    """The port's pipeline training path: ``tools/train.py`` on the 1.3B
    yaml at pp 2 (PP_TRAIN_LAYERS of its 24 layers, half on each of 2
    ranks sharing the card over gloo; full width, bf16, dropout 0.1, full
    recompute, the logits loss), its batch of 8 as 4 microbatches of 2,
    for PP_STEPS steps and one evaluation; then PP_V2_STEPS steps at
    virtual pp 2 (two chunks a stage). Losses finite, falling and equal on
    both ranks; the tied embedding's two copies bit-equal after every
    step; per rank B1-B3 launched exactly as the schedule launches them
    (a stage's layers × 4 microbatches forward, recompute and backward
    per step, the forward per evaluation batch), no plain version and no
    fused CE.
    Returns rank 0's launch counts of the pp 2 drive."""
    from fleetx_tpu_torch.core.engine import model_flops_per_token
    from fleetx_tpu_torch.parallel.launch import free_port, spawn

    argv = ["-c", TRAIN_13B_CONFIG] + [x for o in pp_overrides(prefix)
                                       for x in ("-o", o)]
    argv_v2 = ["-c", TRAIN_13B_CONFIG] + [x for o in pp_overrides(
        prefix, "Model.virtual_pp_degree=2", f"Engine.max_steps={PP_V2_STEPS}",
        "Engine.eval_freq=0") for x in ("-o", o)]
    t0 = time.perf_counter()
    results = spawn(pp_train_rank, PP_DEGREE, (argv, argv_v2, free_port()),
                    timeout=900)
    out = None
    for drive, (label, steps, evals) in enumerate(
            (("pp2", PP_STEPS, PP_EVAL_ITERS),
             ("pp2xv2", PP_V2_STEPS, 0))):
        runs = [r[drive] for r in results]
        r0 = runs[0]
        lps, n = r0["stage_layers"], r0["microbatches"]
        want = {"flash_fwd": lps * n * (2 * steps + evals),
                "flash_bwd_dq": lps * n * steps,
                "flash_bwd_dkv": lps * n * steps,
                "ce_fwd": 0, "ce_dh": 0, "ce_dw": 0,
                "vp_ce_fwd": 0, "vp_ce_dh": 0, "vp_ce_dw": 0}
        steady = float(np.median(r0["step_ms"][1:])) * 1e-3
        flops = model_flops_per_token(r0["n_params"], r0["layers"], 1024,
                                      2048)
        for r in runs:
            busy = [1.0 - (p + c) / s for p, c, s in
                    zip(r["p2p_ms"], r["collective_ms"], r["step_ms"])]
            log("train-pp", run=label, rank=r["pp_rank"],
                backend=r["backend"], steps=r["steps"], layers=r["layers"],
                stage_layers=r["stage_layers"], microbatches=n,
                virtual_pp=r["virtual_pp"], recompute=r["recompute"],
                fused_ce=r["fused_ce"], params_m=r["n_params"] / 1e6,
                step_ms=[round(x, 1) for x in r["step_ms"]],
                p2p_ms=[round(x, 1) for x in r["p2p_ms"]],
                p2p_mb=[round(x, 1) for x in r["p2p_mb"]],
                collective_ms=[round(x, 1) for x in r["collective_ms"]],
                collective_mb=[round(x, 1) for x in r["collective_mb"]],
                busy_share=[round(x, 3) for x in busy],
                peak_mem_gb=r["peak_mem_gb"], fit_seconds=r["fit_seconds"],
                launches=r["launches"], plain_calls=r["plain_calls"])
        log("train-pp", run=label, step_ms_median=steady * 1e3,
            tokens_per_s=r0["tokens"] / steady,
            mfu=r0["tokens"] / steady * flops / PEAK_FLOPS[torch.bfloat16],
            p2p_ms_median=float(np.median(r0["p2p_ms"])),
            p2p_mb_per_step=float(np.median(r0["p2p_mb"])),
            collective_ms_median=float(np.median(r0["collective_ms"])),
            losses=[round(x, 4) for x in r0["losses"]],
            grad_norms=[round(x, 4) for x in r0["grad_norms"]],
            evals=r0["evals"], seconds=time.perf_counter() - t0)
        if r0["backend"] != "gloo":
            raise AssertionError(f"ranks sharing one card ran "
                                 f"{r0['backend']}")
        if (r0["steps"] != steps or len(r0["evals"]) != (1 if evals else 0)
                or r0["fused_ce"] or n != 4
                or lps != PP_TRAIN_LAYERS // PP_DEGREE):
            raise AssertionError(f"{label}: {r0['steps']} steps, "
                                 f"{len(r0['evals'])} evals, fused_ce "
                                 f"{r0['fused_ce']}, {n} microbatches, "
                                 f"{lps} layers a stage")
        for r in runs:
            if r["launches"] != want or any(r["plain_calls"].values()):
                raise AssertionError(
                    f"{label} rank {r['pp_rank']}: launches "
                    f"{r['launches']}, want {want}; plain "
                    f"{r['plain_calls']}")
            if (r["losses"] != r0["losses"] or r["evals"] != r0["evals"]
                    or r["grad_norms"] != r0["grad_norms"]):
                raise AssertionError(f"{label}: rank {r['pp_rank']} "
                                     f"disagrees with rank 0: {r['losses']}")
            if (r["tied_prints"] != r0["tied_prints"]
                    or r["tied_sha256"] != r0["tied_sha256"]):
                raise AssertionError(f"{label}: the tied embedding's copies "
                                     "differ after a step")
        losses = r0["losses"]
        if not all(math.isfinite(x) for x in losses + r0["evals"]):
            raise AssertionError(f"non-finite loss in {losses} {r0['evals']}")
        if not np.mean(losses[-2:]) < losses[0]:
            raise AssertionError(f"{label}: loss did not fall: {losses}")
        if out is None:
            out = {k: results[0][0]["launches"][k] for k in fa.NAMES}
    return out


# ----------------------------------------------------------------- phase 28

def phase_resume_pp(prefix: str) -> None:
    """Phase 26's configuration (the 1.3B cut to RESUME_PP_LAYERS layers,
    logits loss, attention dropout 0.1) at pp 2 on 2 ranks sharing the
    card over gloo: an uninterrupted run of 2 steps that saves per-stage
    files at step 1 and 2; fresh processes resume from a copy of step 1
    alone and take step 2. On both ranks the step-2 loss and grad norm and
    every parameter, AdamW tensor and the generator equal the
    uninterrupted run's (sha256 of their bytes). A load of that checkpoint
    at pp 1 raises ``ElasticMeshMismatch`` and quarantines nothing."""
    from fleetx_tpu_torch.parallel.launch import spawn
    from fleetx_tpu_torch.resilience.elastic import ElasticMeshMismatch

    whole = tempfile.mkdtemp(prefix="out-", dir=os.path.dirname(prefix))
    part = tempfile.mkdtemp(prefix="out-", dir=os.path.dirname(prefix))
    base = pp_e2e_overrides(prefix, "Engine.max_steps=2",
                            "Engine.logging_freq=1",
                            "Engine.save_load.save_steps=1",
                            "Optimizer.lr.warmup_steps=1",
                            "Optimizer.lr.max_lr=3.0e-4",
                            f"Model.num_layers={RESUME_PP_LAYERS}")[1:]
    pp = [f"Distributed.pp_degree={PP_DEGREE}"]
    t0 = time.perf_counter()
    a = spawn(mp_resume_rank, PP_DEGREE,
              (base + pp + [f"Engine.save_load.output_dir={whole}"], False),
              timeout=600)
    shutil.copytree(os.path.join(whole, "checkpoints", "1"),
                    os.path.join(part, "checkpoints", "1"))
    files = sorted(os.listdir(os.path.join(part, "checkpoints", "1")))
    b = spawn(mp_resume_rank, PP_DEGREE,
              (base + pp + [f"Engine.save_load.output_dir={part}"], True),
              timeout=600)
    lps, n = RESUME_PP_LAYERS // PP_DEGREE, 8 // PP_MICRO
    for rank, (x, y) in enumerate(zip(a, b)):
        unequal = [k for k in x["digests"] if x["digests"][k] !=
                   y["digests"].get(k)]
        log("resume-pp", rank=rank, layers=RESUME_PP_LAYERS, pp=PP_DEGREE,
            files=files, losses=x["losses"], resumed_losses=y["losses"],
            grad_norms=x["grad_norms"], resumed_grad_norms=y["grad_norms"],
            tensors=len(x["digests"]), unequal_tensors=len(unequal),
            launches=x["launches"], resumed_launches=y["launches"])
        if (unequal or y["losses"] != x["losses"][1:]
                or y["grad_norms"] != x["grad_norms"][1:]
                or (x["step"], x["consumed"]) != (y["step"], y["consumed"])
                or x["digests"].keys() != y["digests"].keys()):
            raise AssertionError(f"rank {rank}: the resume departs from the "
                                 f"uninterrupted run ({unequal[:3]})")
        if not (y["launches"]["flash_fwd"] == 2 * lps * n
                and y["launches"]["flash_bwd_dkv"] == lps * n
                and y["launches"]["ce_fwd"] == 0):
            raise AssertionError(f"rank {rank} launched {y['launches']}")
    if (a[0]["digests"]["gpt.word_embeddings"]
            != a[1]["digests"]["gpt.word_embeddings"]):
        raise AssertionError("the tied embedding's copies differ")
    if files != ["meta.json", "state-pp0-mp0.pt", "state-pp1-mp0.pt"]:
        raise AssertionError(f"step 1 holds {files}")
    cfg1 = get_config(TRAIN_13B_CONFIG, overrides=base + [
        f"Engine.save_load.output_dir={part}"], nranks=1)
    trainer = Trainer(cfg1, build_module(cfg1))
    try:
        trainer.init_state()
        raise AssertionError("a pp 2 checkpoint loaded at pp 1")
    except ElasticMeshMismatch as e:
        refused = str(e)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    steps = sorted(os.listdir(os.path.join(part, "checkpoints")))
    quarantined = os.path.exists(os.path.join(part, "quarantine"))
    log("resume-pp", pp1_load=refused, steps_left=steps,
        quarantined=quarantined, seconds=time.perf_counter() - t0)
    if steps != ["1", "2"] or quarantined:
        raise AssertionError(f"after the refused load: {steps}, quarantine "
                             f"{quarantined}")


def common_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


# ----------------------------------------------------------------- phase 29
# GPT-6.7B's kernel shapes: the flash kernels at a microbatch of 2 rows of
# 1024 tokens, 32 heads of 128; the fused CE over those 2048 tokens at its
# hidden 4096
FLASH_67B = dict(b=2, h=32, d=128)
CE_67B_SHAPE = (2048, 4096, 50304)


def phase_kernels_67b() -> tuple:
    """B1-B3 and B4-B6 at GPT-6.7B's shapes against their plain versions
    (phase 6's and phase 12's limits and planted faults, each kernel
    launched twice with equal bits), with kernel, plain, library and bound
    times. Returns the flash and the CE records by kernel name."""
    flash = flash_cases(torch.bfloat16, FLASH_67B["d"], h=FLASH_67B["h"],
                        b=FLASH_67B["b"], strict=True)
    ce_records = ce_case(torch.bfloat16, *CE_67B_SHAPE, strict=True)
    gc.collect()
    torch.cuda.empty_cache()
    return flash, ce_records


# ----------------------------------------------------------------- phase 30
TRAIN_67B_CONFIG = os.path.join(
    ROOT, "configs/nlp/gpt/pretrain_gpt_6.7B_sharding16.yaml")
ZERO_LAYERS = 1  # of the yaml's 32: the replicated run fits beside it, and
# the script inside its time (4 until cut for phases 41-43, 2 until cut
# for phases 49-50)
ZERO_FAULT_LAYERS = 1  # the planted-fault and forced-scale drives' depth
ZERO_STEPS, ZERO_EVAL_ITERS = 3, 1  # 3 steps (5 until cut for time)
ZERO_FORCED_STEPS = 1  # the forced-scale pair's steps (2 until cut for
# phases 41-43)
ZERO_SAMPLE_STRIDE = 97  # the first update compared at every 97th element
ZERO_UPDATE_NORM_TOL = 1e-6  # relative: the norm's summation order alone


def zero_overrides(prefix: str, layers: int, steps: int, *extra) -> list:
    """The 6.7B sharding yaml at sharding 2 on 2 ranks with the fused CE
    over the corpus at ``prefix``: full width, ``layers`` of its 32, the
    yaml's batch (local 8 in 4 microbatches of 2), full recompute, bf16,
    dropout 0.1, ``steps`` steps and one evaluation of ZERO_EVAL_ITERS
    batch after the last."""
    return [own_output_dir(prefix), f"Data.Train.dataset.input_dir={prefix}",
            f"Data.Eval.dataset.input_dir={prefix}", "Model.fused_ce=True",
            "Distributed.sharding.sharding_degree=2",
            f"Model.num_layers={layers}", f"Engine.max_steps={steps}",
            "Engine.logging_freq=1", f"Engine.eval_freq={steps}",
            f"Engine.eval_iters={ZERO_EVAL_ITERS}",
            "Optimizer.lr.warmup_steps=1", "Optimizer.lr.max_lr=3.0e-4",
            "Optimizer.lr.min_lr=3.0e-5", "Optimizer.lr.decay_steps=1000",
            *extra]


def param_digest(trainer, replicated_only: bool = False) -> int:
    """A digest of every parameter's bits (their int32 views summed,
    weighted by the parameter's place), computed on the device; with
    ``replicated_only``, of those mp does not split."""
    total = 0
    for i, (n, p) in enumerate(trainer.module.nets.named_parameters()):
        if replicated_only and n in trainer.mp_split:
            continue
        bits = p.detach().reshape(-1).view(torch.int32)
        total += (i + 1) * int(bits.sum(dtype=torch.int64))
    return total


def forced_scale_runs(runs) -> list:
    """Each ``(argv, zero)`` of ``runs`` fitted in this group, in turn, with
    ``FLEETX_ZERO_UPDATE=zero`` through the pieces ``tools/train.py``'s
    ``main`` runs (its group stays up): each run's update shard, losses,
    grad norms and a digest of the parameters after every step."""
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.utils.config import get_config, parse_args

    out = []
    for argv, zero in runs:
        os.environ["FLEETX_ZERO_UPDATE"] = zero
        args = parse_args(list(argv))
        cfg = get_config(args.config, overrides=args.override)
        trainer = Trainer(cfg, build_module(cfg))
        digests, step = [], trainer.train_step

        def digested(batch, step=step, trainer=trainer, digests=digests):
            result = step(batch)
            digests.append(param_digest(trainer))
            return result

        trainer.train_step = digested
        trainer.fit(build_dataloader(cfg, "Train"))
        out.append({"zero": trainer.zero is not None, "digests": digests,
                    "losses": [float(x["loss"]) for x in trainer.history],
                    "grad_norms": [float(x["grad_norm"])
                                   for x in trainer.history]})
        del trainer, step, digested
        gc.collect()
        torch.cuda.empty_cache()
    return out


def zero_train_rank(argv, zero: str, fault: str = "", forced=()) -> dict:
    """One rank of phase 30: ``tools/train.py``'s ``main`` on ``argv`` with
    ``FLEETX_ZERO_UPDATE=zero``; CUDA events at the ends of the steps, the
    update shard's reduce-scatter and all-gather (or the replicated path's
    all-reduce) timed, synchronised on both sides, with their bytes; a
    digest of the parameters after every step, and on rank 0 every
    ZERO_SAMPLE_STRIDE-th element of each parameter after the first step
    with a learning rate above 0 (the warmup's step 1 has 0), with its
    step; the
    evaluation's mean; the AdamW state's bytes and the peak memory.
    ``fault`` names the planted faults: "norm" (the clip's norm from this
    rank's slices alone, every step), "ungathered" (rank 1 keeps its stale
    copy of one parameter's other slice in step 2). ``forced`` runs first
    (:func:`forced_scale_runs`)."""
    forced = forced_scale_runs(forced)
    os.environ["FLEETX_ZERO_UPDATE"] = zero
    import torch.distributed as dist

    from fleetx_tpu_torch.core import engine
    from fleetx_tpu_torch.parallel import sharding
    from fleetx_tpu_torch.tools import train as train_cli

    ends, evals, digests, comms, current, true_norms = [], [], [], [], [], []
    sample = []
    step, evaluate = engine.Trainer.train_step, engine.Trainer.evaluate

    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    def timed(kind, fn, count):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            current.append((kind, (time.perf_counter() - t0) * 1e3,
                            count(*a, **kw)))
            return out
        return wrapper

    def timed_step(self, batch):
        del current[:]
        out = step(self, batch)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        comms.append(list(current))
        digests.append(param_digest(self))
        if not sample and out["lr"] > 0 and dist.get_rank() == 0:
            sample.append((len(ends), torch.cat([
                p.detach().reshape(-1)[::ZERO_SAMPLE_STRIDE]
                for p in self.module.nets.parameters()]).cpu().numpy()))
        return out

    def kept_eval(self, data, epoch=0):
        evals.append(evaluate(self, data, epoch))
        return evals[-1]

    engine.Trainer.train_step, engine.Trainer.evaluate = timed_step, kept_eval
    sharding.ZeroShards.reduce_scatter = timed(
        "reduce_scatter", sharding.ZeroShards.reduce_scatter,
        lambda self, grads: nbytes(grads))
    sharding.ZeroShards.all_gather = timed(
        "all_gather", sharding.ZeroShards.all_gather,
        lambda self: nbytes(self.shards) * self.world)
    engine.all_reduce_sum = timed("all_reduce", engine.all_reduce_sum,
                                  lambda tensors, *a, **kw: nbytes(tensors))
    if "norm" in fault:
        norm = engine.global_norm

        def local_norm(*a, **kw):
            true_norms.append(float(norm(*a, **kw)))
            return norm(*a, **{**kw, "zero_group": None, "zero_parts": None})

        engine.global_norm = local_norm
    if "ungathered" in fault and dist.get_rank() == 1:
        place, skipped = sharding._place, []

        def stale_once(target, rows, plan):
            if len(ends) == 1 and not skipped:
                skipped.append(True)
                return
            place(target, rows, plan)

        sharding._place = stale_once
    backend = dist.get_backend()
    torch.cuda.reset_peak_memory_stats()
    zero_train_launches()
    t0 = time.perf_counter()
    trainer = train_cli.main(list(argv))
    torch.cuda.synchronize()
    gcfg = trainer.module.gpt_config
    return {"backend": backend,
            "zero": trainer.zero is not None,
            "mesh": (trainer.mesh.dp, trainer.mesh.fsdp),
            "losses": [float(x["loss"]) for x in trainer.history],
            "grad_norms": [float(x["grad_norm"]) for x in trainer.history],
            "lrs": [float(x["lr"]) for x in trainer.history],
            "weight_decay": float(trainer.cfg.Optimizer.weight_decay),
            "update_sample": sample[0] if sample else None,
            "forced": forced,
            "evals": evals, "digests": digests, "true_norms": true_norms,
            "step_ms": [a.elapsed_time(b) for a, b in zip(ends, ends[1:])],
            "comms": comms, "opt_bytes": trainer.opt_state_device_bytes(),
            "launches": {**fa.launches, **ce.launches},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "n_params": trainer.n_params, "steps": trainer.step,
            "accum": trainer.accumulate_steps,
            "fit_seconds": time.perf_counter() - t0,
            "layers": gcfg.num_layers, "fused_ce": gcfg.fused_ce,
            "tokens": trainer.cfg.Global.global_batch_size
            * trainer.cfg.Data.Train.dataset.max_seq_len}


def _comm_per_step(run: dict, kind: str) -> tuple:
    """Median ms and GB per step of one collective kind (steps 2 on)."""
    ms = [sum(c[1] for c in step if c[0] == kind) for step in run["comms"]]
    gb = [sum(c[2] for c in step if c[0] == kind) / 1e9
          for step in run["comms"]]
    return float(np.median(ms[1:] or ms)), float(np.median(gb))


def first_update_gaps(a: dict, b: dict) -> dict:
    """Two runs from the same weights and batches that may differ only in
    the clip's scale (the norm's summation order), up to the first step k
    with a learning rate above 0: the largest loss gap and relative grad
    norm gap of steps 1..k, and the sampled parameters' gaps after step k
    in units of the limit a clip-scale rounding allows (two fp32 ulps of
    the value plus ``lr · 2**-20``, a few ulps of AdamW's unit ratio m /
    (sqrt(v) + eps) at the step's rate); the same ratio for ``a``'s
    parameters moved by the weight decay's size ``lr · wd`` (the limit's
    resolution: above 1)."""
    (k, x), (kb, y) = a["update_sample"], b["update_sample"]
    lr = a["lrs"][k - 1]
    limit = (2 * np.spacing(np.maximum(np.abs(x), np.abs(y))).astype(
        np.float64) + lr * 2.0 ** -20)
    gap = np.abs(x.astype(np.float64) - y)
    moved = np.abs(x * (1 - lr * a["weight_decay"]) - y.astype(np.float64))
    return {"step": k, "steps_equal": k == kb, "lr": lr,
            "loss": max(abs(p - q) for p, q in zip(a["losses"][:k],
                                                   b["losses"][:k])),
            "grad_norm": max(abs(p - q) / q for p, q in
                             zip(a["grad_norms"][:k], b["grad_norms"][:k])),
            "sampled": int(x.size), "unequal": int((x != y).sum()),
            "max_abs": float(gap.max()),
            "max_limit_ratio": float((gap / limit).max()),
            "decay_sized_limit_ratio": float((moved / limit).max())}


def phase_train_zero(prefix: str) -> dict:
    """The port's sharded data-parallel path: ``tools/train.py`` on the
    6.7B sharding yaml at sharding 2 (stage 2) on 2 ranks sharing the card
    over gloo, full width, ZERO_LAYERS layers, bf16, dropout 0.1, fused
    CE, full recompute, ZERO_STEPS steps and a 1-batch evaluation, the
    update shard on; then the same drive at dp 2 with
    ``FLEETX_ZERO_UPDATE=0`` (the replicated update). Gates: losses finite
    and falling, the parameters bit-equal on both ranks after every step,
    the two runs within TRAIN_E2E_TOL in loss and grad norm, the AdamW
    state per rank at most 0.55 of the replicated run's, B1-B6 launched
    as the path launches them; and the first update (the first step with
    a learning rate above 0) held tightly, since the two runs differ only
    in the clip's scale, from the norm's summation order: equal losses
    up to it, grad norms within ZERO_UPDATE_NORM_TOL relative, and the
    sampled parameters after it within :func:`first_update_gaps`'s ulp
    limit. Then,
    in one group at ZERO_FAULT_LAYERS: the forced-scale pair (the clip's
    scale 1 on both sides, ``clip_norm`` far above the norm), sharded and
    replicated for ZERO_FORCED_STEPS steps, whose parameters must be
    bit-equal after every step, and a 2-step drive with two planted
    faults that must each break a gate. Returns rank 0's launch counts of
    the sharded run."""
    from fleetx_tpu_torch.core.engine import model_flops_per_token
    from fleetx_tpu_torch.parallel.launch import spawn

    def argv(layers, steps, *extra):
        return ["-c", TRAIN_67B_CONFIG] + [
            x for o in zero_overrides(prefix, layers, steps, *extra)
            for x in ("-o", o)]

    dp2 = ("Distributed.sharding.sharding_degree=1",
           "Distributed.dp_degree=2")
    runs = {"sharded": spawn(zero_train_rank, 2,
                             (argv(ZERO_LAYERS, ZERO_STEPS), "1"),
                             timeout=900)}
    gc.collect()
    runs["replicated"] = spawn(zero_train_rank, 2,
                               (argv(ZERO_LAYERS, ZERO_STEPS, *dp2), "0"),
                               timeout=900)
    r0 = runs["sharded"][0]
    layers, steps = r0["layers"], r0["steps"]
    evals = ZERO_EVAL_ITERS * len(r0["evals"])
    micro = r0["accum"]  # the yaml's local batch 8 in microbatches of 2
    want = {"flash_fwd": layers * (2 * steps * micro + evals),
            "flash_bwd_dq": layers * steps * micro,
            "flash_bwd_dkv": layers * steps * micro,
            "ce_fwd": steps * micro + evals, "ce_dh": steps * micro,
            "ce_dw": steps * micro}
    flops = model_flops_per_token(r0["n_params"], layers, 1024, 4096)
    for label, results in runs.items():
        for rank, r in enumerate(results):
            log("train-zero", run=label, rank=rank, backend=r["backend"],
                zero=r["zero"], dp_fsdp=r["mesh"], steps=r["steps"],
                layers=layers, params_m=r["n_params"] / 1e6,
                step_ms=[round(x, 1) for x in r["step_ms"]],
                peak_mem_gb=r["peak_mem_gb"],
                opt_state_gb=r["opt_bytes"] / 1e9,
                fit_seconds=r["fit_seconds"], launches=r["launches"],
                launches_per_step={
                    k: (v - evals * {"flash_fwd": layers,
                                     "ce_fwd": 1}.get(k, 0)) / steps
                    for k, v in r["launches"].items()})
        steady = float(np.median(results[0]["step_ms"][1:])) * 1e-3
        comm = {kind: _comm_per_step(results[0], kind)
                for kind in ("reduce_scatter", "all_gather", "all_reduce")}
        log("train-zero", run=label, step_ms_median=steady * 1e3,
            tokens_per_s=results[0]["tokens"] / steady,
            mfu=results[0]["tokens"] / steady * flops
            / PEAK_FLOPS[torch.bfloat16],
            reduce_scatter_ms=comm["reduce_scatter"][0],
            reduce_scatter_gb=comm["reduce_scatter"][1],
            all_gather_ms=comm["all_gather"][0],
            all_gather_gb=comm["all_gather"][1],
            all_reduce_ms=comm["all_reduce"][0],
            all_reduce_gb=comm["all_reduce"][1],
            losses=[round(x, 5) for x in results[0]["losses"]],
            grad_norms=[round(x, 5) for x in results[0]["grad_norms"]],
            evals=results[0]["evals"])
    rep = runs["replicated"][0]
    gaps = {"loss": max(abs(a - b) for a, b in zip(r0["losses"],
                                                  rep["losses"])),
            "grad_norm": max(abs(a - b) / b for a, b in
                             zip(r0["grad_norms"], rep["grad_norms"]))}
    ratio = r0["opt_bytes"] / rep["opt_bytes"]
    first = first_update_gaps(r0, rep)
    log("train-zero", sharded_vs_replicated=gaps, tol=TRAIN_E2E_TOL,
        opt_state_ratio=ratio, first_update=first,
        first_update_tol={"loss": 0.0, "grad_norm": ZERO_UPDATE_NORM_TOL,
                          "max_limit_ratio": 1.0},
        digests_equal_by_step=[x == y for x, y in zip(r0["digests"],
                                                      rep["digests"])])
    if r0["backend"] != "gloo" or not r0["zero"] or rep["zero"]:
        raise AssertionError(f"backend {r0['backend']}, update shard "
                             f"{r0['zero']} / {rep['zero']}")
    if r0["mesh"] != (1, 2) or rep["mesh"] != (2, 1):
        raise AssertionError(f"meshes {r0['mesh']} {rep['mesh']}")
    if steps != ZERO_STEPS or len(r0["evals"]) != 1 or not r0["fused_ce"]:
        raise AssertionError(f"{steps} steps, {len(r0['evals'])} evals, "
                             f"fused_ce {r0['fused_ce']}")
    for label, results in runs.items():
        a, b = results
        if a["digests"] != b["digests"] or len(a["digests"]) != steps:
            raise AssertionError(f"{label}: the ranks' parameters differ "
                                 f"after a step: {a['digests']} "
                                 f"{b['digests']}")
        if a["losses"] != b["losses"] or a["evals"] != b["evals"]:
            raise AssertionError(f"{label}: the ranks' losses differ")
        for r in results:
            if r["launches"] != want:
                raise AssertionError(f"{label}: launches {r['launches']}, "
                                     f"want {want}")
        losses = a["losses"]
        if not all(math.isfinite(x) for x in losses + a["evals"]):
            raise AssertionError(f"{label}: non-finite loss {losses}")
        if not np.mean(losses[-2:]) < losses[0]:
            raise AssertionError(f"{label}: loss did not fall: {losses}")
    if not (gaps["loss"] <= TRAIN_E2E_TOL["loss"]
            and gaps["grad_norm"] <= TRAIN_E2E_TOL["grad_norm"]):
        raise AssertionError(f"sharded vs replicated: {gaps}")
    if not (first["steps_equal"] and first["loss"] == 0.0
            and first["grad_norm"] <= ZERO_UPDATE_NORM_TOL
            and first["max_limit_ratio"] <= 1.0
            and first["decay_sized_limit_ratio"] > 1.0):
        raise AssertionError(f"the first update, sharded vs replicated: "
                             f"{first}")
    if not ratio <= 0.55:
        raise AssertionError(f"AdamW state per rank {r0['opt_bytes']} B is "
                             f"{ratio:.3f} of the replicated run's")
    launches = r0["launches"]
    del runs, r0, rep
    gc.collect()
    # in one group: first the forced-scale pair, then the planted faults
    # in a drive of 2 steps: a norm from this rank's slices alone must
    # break the first update's norm gate against the whole model's norm of
    # the same gradients; one parameter's slice left stale on rank 1 in
    # step 2 the bit-equality gate
    clip_off = "Optimizer.grad_clip.clip_norm=1e9"
    forced = [(argv(ZERO_FAULT_LAYERS, ZERO_FORCED_STEPS, clip_off), "1"),
              (argv(ZERO_FAULT_LAYERS, ZERO_FORCED_STEPS, clip_off, *dp2),
               "0")]
    a, b = spawn(zero_train_rank, 2,
                 (argv(ZERO_FAULT_LAYERS, 2), "1", "norm,ungathered",
                  forced), timeout=900)
    sharded, replicated = a["forced"]
    same = [x == y for x, y in zip(sharded["digests"],
                                   replicated["digests"])]
    log("train-zero", forced_scale=clip_off, layers=ZERO_FAULT_LAYERS,
        zero=(sharded["zero"], replicated["zero"]),
        losses_sharded=sharded["losses"],
        losses_replicated=replicated["losses"],
        grad_norms_sharded=sharded["grad_norms"],
        grad_norms_replicated=replicated["grad_norms"],
        digests_equal_by_step=same)
    if not (sharded["zero"] and not replicated["zero"]
            and len(same) == ZERO_FORCED_STEPS and all(same)
            and sharded["losses"] == replicated["losses"]
            and max(sharded["grad_norms"]) < 1e9
            and b["forced"] == a["forced"]):
        raise AssertionError("with the clip's scale forced to 1 the sharded "
                             "and the replicated update part")
    norm_gap = abs(a["grad_norms"][0] - a["true_norms"][0]) \
        / a["true_norms"][0]
    equal = [x == y for x, y in zip(a["digests"], b["digests"])]
    caught = {"norm": norm_gap > ZERO_UPDATE_NORM_TOL,
              "ungathered": equal == [True, False]}
    log("train-zero", planted_faults="'norm' (steps 1-2), 'ungathered' "
        "(step 2)", grad_norm_gap_step1=norm_gap,
        ranks_bit_equal_by_step=equal, caught=caught)
    if not all(caught.values()):
        raise AssertionError(f"phase 30's gates miss a planted fault: "
                             f"{caught}")
    return launches


# ----------------------------------------------------------------- phase 31
# phase 31's depth 1 (2 until cut for phases 49-50)
ELASTIC_LAYERS, ELASTIC_STEPS, ELASTIC_LOSS_AT = 1, 6, 3
ELASTIC_BATCH = 16  # the global batch: the yaml's local 8 on each of 2


def elastic_overrides(prefix: str, out: str, *extra) -> list:
    """The 1.3B yaml at ELASTIC_LAYERS layers, full width, over the corpus
    at ``prefix``, fused CE, ELASTIC_STEPS steps of the global batch
    ELASTIC_BATCH (in one microbatch on each rank), into ``out``."""
    return [f"Engine.save_load.output_dir={out}",
            f"Data.Train.dataset.input_dir={prefix}", "Model.fused_ce=True",
            f"Model.num_layers={ELASTIC_LAYERS}",
            f"Engine.max_steps={ELASTIC_STEPS}", "Engine.logging_freq=1",
            "Engine.eval_freq=0",
            "Optimizer.lr.warmup_steps=1", "Optimizer.lr.max_lr=3.0e-4",
            "Optimizer.lr.min_lr=3.0e-5", "Optimizer.lr.decay_steps=1000",
            *extra]


def elastic_rank(argv, host_loss_step) -> dict:
    """One rank of phase 31: ``tools/train.py``'s ``main`` on ``argv`` with
    the host-loss fault at ``host_loss_step`` (None: no fault); every
    applied step's loss, whichever trainer took it. Returns whether this
    rank left, the losses, and the final trainer's step, restored step,
    consumed samples, mesh and world."""
    from fleetx_tpu_torch.core import engine
    from fleetx_tpu_torch.tools import train as train_cli

    losses, step = [], engine.Trainer.train_step

    def kept(self, batch):
        out = step(self, batch)
        if not out["skipped"]:
            losses.append(float(out["loss"]))
        return out

    engine.Trainer.train_step = kept
    if host_loss_step is not None:
        faults.configure(host_loss_step=str(host_loss_step))
    try:
        trainer = train_cli.main(list(argv))
        injected = dict(faults.injected)
    finally:
        faults.reset()
        engine.Trainer.train_step = step
    out = {"left": trainer is None, "losses": losses, "injected": injected}
    if trainer is not None:
        out.update(step=trainer.step, restored=trainer._restored_step,
                   consumed=trainer.consumed_samples,
                   mesh=(trainer.mesh.dp, trainer.mesh.fsdp),
                   world=trainer.mesh.world,
                   global_batch=trainer.cfg.Global.global_batch_size)
    return out


def reload_digests(trainer, step: int) -> dict:
    """sha256 of every parameter and whole AdamW moment of ``trainer``
    after it loads ``step``, with the restored meta (a collective under
    the update shard: every rank calls it)."""
    trainer.load(step=step)
    out = {"meta": (trainer.step, trainer.start_epoch,
                    trainer.consumed_samples)}
    tensors = dict(trainer.module.nets.named_parameters())
    for n, s in trainer.optimizer_state(torch.device("cpu")).items():
        tensors.update({f"{n}:{k}": v for k, v in s.items()
                        if k != "step"})
    for k, t in tensors.items():
        out[k] = hashlib.sha256(t.detach().cpu().contiguous().reshape(-1)
                                .view(torch.uint8).numpy().tobytes()
                                ).hexdigest()
    return out


def reload_rank(overrides, step: int) -> dict:
    """One rank of phase 31's same-mesh reload: a fresh trainer of the
    sharding-2 configuration loads ``step``; its digests."""
    cfg = get_config(TRAIN_13B_CONFIG, overrides=list(overrides))
    trainer = Trainer(cfg, build_module(cfg))
    trainer.init_state()
    return reload_digests(trainer, step)


def phase_elastic(prefix: str) -> None:
    """Elastic shrink and reshard-on-load: ``tools/train.py`` on the 1.3B
    yaml at ELASTIC_LAYERS layers, full width, sharding 2 (stage 2) on 2
    ranks, the host-loss fault before step ELASTIC_LOSS_AT: the emergency
    checkpoint is written from the sharded moments, the mesh shrinks to
    fsdp 1 on 1 rank (rank 1 leaves), the survivor resumes through
    reshard-on-load and finishes ELASTIC_STEPS steps. Gates: the restored
    step, the consumed samples, every loss within TRAIN_E2E_TOL of an
    uninterrupted 1-rank run over the same global batches, rank 1 gone
    with exit code 0; and the checkpoint loaded at 1 rank equal, tensor
    for tensor and in meta, to a reload on the 2-rank mesh."""
    from fleetx_tpu_torch.parallel import launch

    root = os.path.dirname(prefix)
    one = ("Distributed.sharding.sharding_degree=1",
           f"Global.local_batch_size={ELASTIC_BATCH}",
           f"Global.micro_batch_size={ELASTIC_BATCH}")
    two = ("Distributed.sharding.sharding_degree=2",
           "Distributed.sharding.sharding_stage=2",
           f"Global.local_batch_size={ELASTIC_BATCH // 2}",
           f"Global.micro_batch_size={ELASTIC_BATCH // 2}")

    def argv(out, *extra):
        return ["-c", TRAIN_13B_CONFIG] + [
            x for o in elastic_overrides(prefix, out, *extra)
            for x in ("-o", o)]

    t0 = time.perf_counter()
    ref = elastic_rank(argv(os.path.join(root, "out-elastic-ref"), *one),
                       None)
    gc.collect()
    torch.cuda.empty_cache()
    out = os.path.join(root, "out-elastic")
    runs = launch.spawn(elastic_rank, 2, (argv(out, *two), ELASTIC_LOSS_AT),
                        timeout=900)
    exitcodes = list(launch.last_exitcodes)
    survivor, departed = runs
    gap = max(abs(a - b) for a, b in zip(survivor["losses"],
                                         ref["losses"]))
    log("elastic", ref_losses=[round(x, 5) for x in ref["losses"]],
        losses=[round(x, 5) for x in survivor["losses"]],
        departed_losses=[round(x, 5) for x in departed["losses"]],
        loss_gap=gap, tol=TRAIN_E2E_TOL["loss"], exitcodes=exitcodes,
        restored=survivor.get("restored"), mesh=survivor.get("mesh"),
        consumed=survivor.get("consumed"), seconds=time.perf_counter() - t0)
    if not departed["left"] or survivor["left"] or exitcodes != [0, 0]:
        raise AssertionError(f"left {[r['left'] for r in runs]}, exit codes "
                             f"{exitcodes}")
    if (survivor["step"], survivor["restored"], survivor["mesh"],
            survivor["world"]) != (ELASTIC_STEPS, ELASTIC_LOSS_AT, (1, 1), 1):
        raise AssertionError(f"after the shrink: {survivor}")
    if survivor["consumed"] != ELASTIC_STEPS * ELASTIC_BATCH \
            or survivor["global_batch"] != ELASTIC_BATCH:
        raise AssertionError(f"consumed {survivor['consumed']}")
    if (len(survivor["losses"]) != ELASTIC_STEPS
            or departed["losses"] != survivor["losses"][:ELASTIC_LOSS_AT]
            or not gap <= TRAIN_E2E_TOL["loss"]):
        raise AssertionError(f"losses {survivor['losses']} against "
                             f"{ref['losses']}: gap {gap}")
    # the emergency checkpoint (sharding 2) reloaded on its own mesh and at
    # one rank
    same = launch.spawn(reload_rank, 2, (
        elastic_overrides(prefix, out, *two), ELASTIC_LOSS_AT), timeout=900)
    cfg = get_config(TRAIN_13B_CONFIG,
                     overrides=elastic_overrides(prefix, out, *one))
    trainer = Trainer(cfg, build_module(cfg))
    trainer.init_state()
    single = reload_digests(trainer, ELASTIC_LOSS_AT)
    del trainer
    differ = sorted(k for k in single if single[k] != same[0].get(k))
    log("elastic", reloaded_tensors=len(single) - 1, meta=single["meta"],
        ranks_equal=same[0] == same[1], differ=differ[:8])
    if same[0] != same[1] or differ or single["meta"] != (
            ELASTIC_LOSS_AT, 0, ELASTIC_LOSS_AT * ELASTIC_BATCH):
        raise AssertionError(f"reshard-on-load differs in {differ}, meta "
                             f"{single['meta']}")
    gc.collect()
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 32
# GPT-175B's kernel shapes at mp 2: the flash kernels over one rank's 48 of
# the 96 heads of 128 (mp rank 1's global-head meta) at a microbatch of 1
# row of 2048 tokens; B12's kernels (B4-B6 on the vocab shard) over those
# 2048 tokens at hidden 12288 and a shard of 25600 of the 51200 rows
FLASH_175B = dict(b=1, s=2048, h=48, d=128)
FLASH_175B_META = (0, 48, 48, 96, 0, 0)
CE_175B_SHAPE = (2048, 12288, 25600)
# W's stds of the tensor-core comparison: the 175B yaml's
# initializer_range (scores of std ~2.2 at E 12288) and phase 12's
CE_175B_W_STDS = (0.02, 0.05)


def tensor_core_lse_gaps(n: int, e: int, v: int, w_std: float) -> dict:
    """B4's lse, its plain version's and cuBLAS's bf16 tensor-core GEMM's
    (fp32 output) against the lse of an fp64 product, each as its largest
    ratio to CE_TOL's stats bound: the tensor cores' fp32 accumulation over
    K = E products drifts from IEEE fp32 sums as K grows."""
    h, w, labels, _ = ce_inputs(torch.bfloat16, n, e, v, w_std=w_std)
    _, lse = ce.fused_ce_fwd(h, w, labels)
    _, lse_plain = ce.fused_ce_fwd_ref(h, w, labels)
    lse64 = torch.logsumexp(h.double() @ w.double().t(), -1)
    lse_tc = torch.logsumexp(torch.mm(h, w.t(), out_dtype=torch.float32)
                             .double(), -1)
    atol, rtol, _ = ce.CE_TOL[torch.bfloat16]["stats"]
    bound = atol * lse64.abs().max() + rtol * lse64.abs()
    out = {k: ((x.double() - lse64).abs() / bound).max().item()
           for k, x in (("kernel", lse), ("plain", lse_plain),
                        ("library", lse_tc))}
    out["kernel_mean_signed"] = (lse.double() - lse64).mean().item()
    del h, w, lse64, lse_tc
    torch.cuda.empty_cache()
    return out


def phase_kernels_175b() -> tuple:
    """B1-B3 and B12's kernels at GPT-175B's mp 2 shapes against their
    plain versions (phase 6's and phase 12's limits and planted faults,
    each kernel launched twice with equal bits), with kernel, plain,
    library and bound times. Returns the flash and the CE records by
    kernel name."""
    flash = flash_cases(torch.bfloat16, FLASH_175B["d"], h=FLASH_175B["h"],
                        meta=FLASH_175B_META, b=FLASH_175B["b"],
                        s=FLASH_175B["s"], strict=True)
    ce_records = ce_case(torch.bfloat16, *CE_175B_SHAPE, strict=True)
    # B4's accumulation against fp64 beside the library's tensor cores (a
    # single accumulator over E 12288 drifts beyond CE_TOL of the IEEE
    # plain version: cuBLAS's, and B4's before it summed per 1024)
    for w_std in CE_175B_W_STDS:
        gaps = tensor_core_lse_gaps(*CE_175B_SHAPE, w_std)
        log("ce", tokens=CE_175B_SHAPE[0], hidden=CE_175B_SHAPE[1],
            vocab=CE_175B_SHAPE[2], w_std=w_std,
            lse_tol_ratio_to_fp64=gaps)
        if not gaps["kernel"] <= min(gaps["library"], 1.0):
            raise AssertionError(f"B4's lse at E {CE_175B_SHAPE[1]} drifts "
                                 f"from fp64 as far as the tensor cores': "
                                 f"{gaps}")
    gc.collect()
    torch.cuda.empty_cache()
    return flash, ce_records


# ----------------------------------------------------------------- phase 33
SWITCH_LAYERS, SWITCH_STEPS = 2, 3  # the 1.3B yaml's full width, 2 layers
# (for the script's time)
SAVE_SETS = {"none": ("Model.use_recompute=False",),
             "full": ("Model.recompute_granularity=full",),
             "full_attn": ("Model.recompute_granularity=full_attn",),
             "core_attn": ("Model.recompute_granularity=core_attn",),
             "full+ffn_gelu": ("Model.recompute_granularity=full",
                               "Model.recompute_extra_saves=[ffn_gelu]")}


def switch_run(prefix: str, batches, steps: int, *extra, params=None,
               profile_at=None) -> dict:
    """``steps`` train steps of a fresh 1.3B trainer (SWITCH_LAYERS
    layers, fused CE, dropout 0.1; the seeded init, or ``params``) on
    ``batches`` with ``extra`` overrides: losses, grad norms, the first
    step's unclipped gradients, the peak memory of the steps after the
    first above what was allocated before them and the memory the last
    step's forward kept for its backward, step ms (CUDA events), B1-B6 launches per
    step, the AdamW state's bytes and the trainer."""
    cfg = train_13b_config(prefix, f"Model.num_layers={SWITCH_LAYERS}",
                           f"Engine.max_steps={steps}",
                           "Engine.logging_freq=1", *extra)
    trainer = Trainer(cfg, build_module(cfg))
    trainer.init_state(params)
    grads, clip = [], trainer.clip

    def capture(gs, norm=None):
        if not grads:
            grads.extend(g.detach().clone() for g in gs)
        return clip(gs, norm)

    trainer.clip = capture
    loss_fn, kept = trainer.module.loss_fn, []

    def watched_loss(*a, **kw):  # what the forward keeps for the backward
        out = loss_fn(*a, **kw)
        kept.append(torch.cuda.memory_allocated())
        return out

    trainer.module.loss_fn = watched_loss
    device_batches = [trainer._to_device(b) for b in batches[:steps]]
    torch.cuda.synchronize()
    zero_train_launches()
    ends = [torch.cuda.Event(enable_timing=True)]
    ends[0].record()
    outs, held = [], None
    for b in device_batches:
        outs.append(trainer.train_step(b))
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        if held is None:
            # the steady steps' peak: the first step also allocates the
            # optimizer state and the gradients
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    trainer.module.loss_fn = loss_fn
    names = [n for n, _ in trainer.module.nets.named_parameters()]
    return {"losses": [float(o["loss"]) for o in outs],
            "kept": kept[-1] - held,
            "grad_norms": [float(o["grad_norm"]) for o in outs],
            "grads": dict(zip(names, grads)),
            "peak": torch.cuda.max_memory_allocated() - held,
            "step_ms": [a.elapsed_time(b) for a, b in zip(ends, ends[1:])],
            "launches": {k: v / steps for mod in (fa, ce)
                         for k, v in mod.launches.items()},
            "opt_bytes": trainer.opt_state_device_bytes(),
            "trainer": trainer}


def _bitwise(a: dict, b: dict) -> bool:
    return (a["losses"] == b["losses"] and a["grad_norms"] == b["grad_norms"]
            and all(torch.equal(g, b["grads"][n])
                    for n, g in a["grads"].items()))


def _free(*runs) -> None:
    for run in runs:
        run.pop("trainer", None)
        run.pop("grads", None)
    gc.collect()
    torch.cuda.empty_cache()


def phase_switches_13b(prefix: str) -> dict:
    """The GPT and Trainer switches at GPT-1.3B's full width, 2 layers,
    fused CE, dropout 0.1, on the same seed and batches:

    - the save-sets (none, ``full``, ``full_attn``, ``core_attn``, ``full``
      + ``ffn_gelu``), 3 steps each: losses and first-step gradients
      bit-equal to the run without recompute (within TRAIN_E2E_TOL,
      logged, if the card's GEMMs do not repeat), the memory the forward
      keeps for the backward ordered full < core_attn <= full_attn <
      none, the step peak of none the largest (under full the rerun holds
      a whole layer's activations at once, under a save-set one segment's,
      so their peaks are not ordered by what is kept), B1 launched once a
      layer a step without recompute and twice with (B1 reruns in every
      save-set's backward);
    - the split q/k/v layout from the fused run's weights
      (``qkv_state_layout``, through ``convert_qkv_layout``): 2 steps'
      losses within TRAIN_E2E_TOL, then a greedy ``generate()`` of 16
      tokens (fp32 compute) byte-equal to the fused model's;
    - ``fast_dropout: False``: finite losses, one key's mask equal on the
      card and on the CPU bit for bit, and the dropout's ms against the
      hash's on a [8, 1024, 2048] bf16 activation;
    - Momentum with the block-RMS clip and SGD (nesterov) with the
      by-value clip, 3 steps on one batch: finite and falling;
    - ``moment_dtype: bfloat16``: a bf16 first moment, the state 0.75 of
      the fp32 run's within 1%;
    - the profiler (``Profiler.enable``, ``scheduler: [1, 3]``) and
      ``FLEETX_OBS_PORT=0``: the trace file, the kernel view naming
      ``flash_fwd_wg_kernel`` and ``ce_stats_kernel``, ``/metrics``
      counting the steps and a tokens/s gauge above 0.

    Returns B1-B6's launches per step by save-set."""
    import urllib.request

    from fleetx_tpu_torch.models.gpt.convert import qkv_state_layout
    from fleetx_tpu_torch.models.gpt.generation import GenerationConfig
    from fleetx_tpu_torch.obs import get_registry
    from fleetx_tpu_torch.obs import http as obs_http
    from fleetx_tpu_torch.ops.dropout import (
        FlaxDropout,
        HashDropout,
        threefry_keep,
    )
    from fleetx_tpu_torch.utils.profiler_summary import kernel_table

    cfg0 = train_13b_config(prefix)
    loader = iter(build_dataloader(cfg0, "Train"))
    batches = [next(loader) for _ in range(SWITCH_STEPS)]
    runs, launches = {}, {}
    for label, extra in SAVE_SETS.items():
        runs[label] = run = switch_run(prefix, batches, SWITCH_STEPS, *extra)
        launches[label] = run["launches"]
        log("switches", save_set=label, losses=run["losses"],
            grad_norms=run["grad_norms"],
            step_ms=[round(x, 2) for x in run["step_ms"]],
            step_peak_gb=run["peak"] / 1e9, kept_gb=run["kept"] / 1e9,
            launches_per_step=run["launches"])
        run.pop("trainer")
        gc.collect()
        torch.cuda.empty_cache()
    ref = runs["none"]
    for label, run in runs.items():
        want_b1 = SWITCH_LAYERS * (1 if label == "none" else 2)
        bitwise = _bitwise(run, ref)
        gaps = _e2e_gaps((run["losses"][0], run["grad_norms"][0],
                          run["grads"], 0),
                         (ref["losses"][0], ref["grad_norms"][0],
                          ref["grads"], 0))
        log("switches", save_set=label, bitwise_to_none=bitwise,
            b1_per_step=run["launches"]["flash_fwd"], want_b1=want_b1,
            **gaps)
        if not bitwise and any(gaps[m] > tol for m, tol in
                               TRAIN_E2E_TOL.items()):
            raise AssertionError(f"save-set {label} vs none: {gaps}")
        if run["launches"]["flash_fwd"] != want_b1:
            raise AssertionError(f"save-set {label}: B1 "
                                 f"{run['launches']['flash_fwd']} a step, "
                                 f"want {want_b1}")
    order = ["full", "core_attn", "full_attn", "none"]
    kept = [runs[k]["kept"] for k in order]
    peaks = {k: run["peak"] for k, run in runs.items()}
    log("switches", kept_order=order, kept_gb=[x / 1e9 for x in kept],
        step_peak_gb={k: p / 1e9 for k, p in peaks.items()})
    if not (kept[0] < kept[1] <= kept[2] < kept[3]):
        raise AssertionError(f"kept for the backward, {order}: {kept}")
    if max(peaks, key=peaks.get) != "none":
        raise AssertionError(f"a save-set's step peak over none's: {peaks}")
    fused_losses = runs["full"]["losses"][:2]
    _free(*runs.values())
    # the split q/k/v layout from the fused run's weights
    fused = switch_run(prefix, batches, 2)
    start = init_params(fused["trainer"].module.gpt_config, seed=int(
        cfg0.Global.seed), device=DEVICE)
    whole = fused["trainer"].module.gpt_config
    split = switch_run(prefix, batches, 2, "Model.fuse_attn_qkv=False",
                       params=qkv_state_layout(start, whole, to_fused=False))
    gaps = [abs(a - b) for a, b in zip(split["losses"], fused["losses"])]
    log("switches", layout="split q/k/v", losses=split["losses"],
        losses_fused=fused["losses"], gaps=gaps)
    if not all(g <= TRAIN_E2E_TOL["loss"] for g in gaps):
        raise AssertionError(f"split q/k/v vs fused: {gaps}")
    trained = {n: p.detach() for n, p in
               fused["trainer"].module.nets.named_parameters()}
    tokens = {}
    prompt = torch.from_numpy(batches[0]["tokens"][:4, :32]).to(DEVICE)
    for layout, weights in (("fused", trained), ("split", qkv_state_layout(
            trained, whole, to_fused=False))):
        gcfg = dataclasses.replace(whole, dtype=torch.float32,
                                   fuse_attn_qkv=layout == "fused")
        model = gpt_model.GPTForPretraining(gcfg, device="meta")
        model.load_state_dict(weights, assign=True)
        before = da.launches["decode"]
        with torch.no_grad():
            tokens[layout] = gen.generate(model, prompt, GenerationConfig(
                max_length=16, decode_strategy="greedy")).cpu()
        decode_launches = da.launches["decode"] - before
        del model
    same = torch.equal(tokens["fused"], tokens["split"])
    log("switches", layout="split q/k/v", generate_byte_equal=same,
        decode_launches=decode_launches, new_tokens=16)
    if not same or decode_launches == 0:
        raise AssertionError("greedy generate() of the split layout differs "
                             f"from the fused: {tokens}")
    _free(fused, split)
    # fast_dropout: False (flax's threefry nn.Dropout)
    flax = switch_run(prefix, batches, 2, "Model.fast_dropout=False")
    key = (0x12345678, 0x9ABCDEF0)
    idx = torch.arange(8 * 1024 * 2048, device=DEVICE).view(8, 1024, 2048)
    card = threefry_keep(key, idx, 0.9).cpu()
    host = threefry_keep(key, idx.cpu(), 0.9)
    act = torch.randn(8, 1024, 2048, device=DEVICE).to(torch.bfloat16)
    threefry_ms = cuda_ms(lambda: FlaxDropout(0.1)(act, False, seed=key),
                          iters=5, warmup=1)
    hash_ms = cuda_ms(lambda: HashDropout(0.1)(act, False, seed=77),
                      iters=5, warmup=1)
    log("switches", dropout="threefry", losses=flax["losses"],
        mask_card_equals_cpu=torch.equal(card, host),
        keep_share=card.float().mean().item(), threefry_ms=threefry_ms,
        hash_ms=hash_ms, activation="[8, 1024, 2048] bf16")
    if not (torch.equal(card, host)
            and all(math.isfinite(x) for x in flax["losses"])):
        raise AssertionError(f"threefry dropout: {flax['losses']}")
    del idx, act, card, host
    _free(flax)
    # Momentum and SGD with the other clips, on one batch thrice
    same_batch = [batches[0]] * 3
    lr = ("Optimizer.lr.warmup_steps=0", "Optimizer.lr.max_lr=0.05",
          "Optimizer.lr.min_lr=0.005")
    for label, extra in (
            ("Momentum + ClipGradByNorm", (
                "Optimizer.name=Momentum", "Optimizer.momentum=0.9",
                "Optimizer.grad_clip.name=ClipGradByNorm",
                "Optimizer.grad_clip.clip_norm=1.0")),
            ("SGD + ClipGradByValue", (
                "Optimizer.name=SGD", "Optimizer.use_nesterov=True",
                "Optimizer.grad_clip.name=ClipGradByValue",
                "Optimizer.grad_clip.clip_value=0.001"))):
        run = switch_run(prefix, same_batch, 3, *lr, *extra)
        log("switches", optimizer=repr(label), losses=run["losses"],
            grad_norms=run["grad_norms"], state_gb=run["opt_bytes"] / 1e9)
        losses = run["losses"]
        if not (all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0]):
            raise AssertionError(f"{label}: losses {losses}")
        _free(run)
    # AdamW at moment_dtype: bfloat16 against fp32 moments
    fp32 = switch_run(prefix, batches, 2)
    bf16 = switch_run(prefix, batches, 2, "Optimizer.moment_dtype=bfloat16")
    dtypes = {str(st["exp_avg"].dtype)
              for st in bf16["trainer"].optimizer.state.values()}
    ratio = bf16["opt_bytes"] / fp32["opt_bytes"]
    log("switches", moment_dtype="bfloat16", exp_avg_dtypes=sorted(dtypes),
        state_gb=bf16["opt_bytes"] / 1e9, state_gb_fp32=fp32["opt_bytes"] / 1e9,
        ratio=ratio, losses=bf16["losses"], losses_fp32=fp32["losses"])
    if dtypes != {"torch.bfloat16"} or abs(ratio - 0.75) > 0.0075:
        raise AssertionError(f"bf16 moments: {dtypes}, ratio {ratio}")
    _free(fp32, bf16)
    # the profiler and the exposition
    os.environ["FLEETX_OBS_PORT"] = "0"
    prof_dir = os.path.join(os.path.dirname(prefix), "profiler_log")
    cfg = train_13b_config(prefix, f"Model.num_layers={SWITCH_LAYERS}",
                           f"Engine.max_steps={SWITCH_STEPS}",
                           "Engine.logging_freq=1", "Profiler.enable=True",
                           "Profiler.scheduler=[1,3]",
                           f"Profiler.profiler_log={prof_dir}")
    text = get_registry().prometheus_text()
    steps_before = sum(float(line.split()[-1]) for line in text.splitlines()
                       if line.startswith("fleetx_train_steps_total "))
    trainer = Trainer(cfg, build_module(cfg))
    trainer.fit(batches)
    server = obs_http.get_server()
    body = urllib.request.urlopen(server.url + "/metrics",
                                  timeout=30).read().decode()
    metrics = {line.split()[0]: float(line.split()[-1])
               for line in body.splitlines()
               if line and not line.startswith("#")}
    table = [name for name, _, _ in kernel_table(trainer.profiler_trace)]
    named = {k: any(k in name for name in table)
             for k in ("flash_fwd_wg_kernel", "ce_stats_kernel")}
    log("switches", profiler_trace=trainer.profiler_trace,
        trace_bytes=os.path.getsize(trainer.profiler_trace),
        kernel_view_top=table[:8], kernel_view_names=named,
        steps_total=metrics.get("fleetx_train_steps_total"),
        steps_before=steps_before,
        tokens_per_s=metrics.get("fleetx_train_tokens_per_second"),
        hbm_bytes=metrics.get("fleetx_train_step_hbm_bytes"))
    if not (all(named.values()) and metrics.get(
            "fleetx_train_steps_total") == steps_before + SWITCH_STEPS
            and metrics.get("fleetx_train_tokens_per_second", 0) > 0):
        raise AssertionError(f"profiler/obs: {named}, {metrics}")
    server.stop()
    os.environ.pop("FLEETX_OBS_PORT")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------- phase 34
TRAIN_175B_CONFIG = os.path.join(
    ROOT, "configs/nlp/gpt/pretrain_gpt_175B_mp8_pp16.yaml")
SP_LAYERS, SP_STEPS, SP_EVAL_ITERS = 1, 3, 1  # 1 of the yaml's 96 layers
SP_STEP1_TOL = {"loss": 1e-6, "grad_norm": 1e-4}  # relative, step 1


def sp_overrides(prefix: str, *extra) -> list:
    """The 175B yaml at mp 2 (of its 8) and pp 1 (of its 16), 1 of its
    96 layers, full width, seq 2048, its core_attn recompute and
    sequence parallelism, fused CE, a global batch of 2 sequences in 2
    microbatches of 1, SP_STEPS steps and one evaluation of SP_EVAL_ITERS
    batch after the last."""
    return [own_output_dir(prefix), f"Data.Train.dataset.input_dir={prefix}",
            f"Data.Eval.dataset.input_dir={prefix}",
            "Distributed.mp_degree=2", "Distributed.pp_degree=1",
            f"Model.num_layers={SP_LAYERS}", "Model.fused_ce=True",
            "Global.global_batch_size=2", "Global.local_batch_size=2",
            "Global.micro_batch_size=1", f"Engine.max_steps={SP_STEPS}",
            "Engine.logging_freq=1", f"Engine.eval_freq={SP_STEPS}",
            f"Engine.eval_iters={SP_EVAL_ITERS}",
            "Optimizer.lr.warmup_steps=1", "Optimizer.lr.max_lr=3.0e-4",
            "Optimizer.lr.min_lr=3.0e-5", "Optimizer.lr.decay_steps=1000",
            *extra]


def sp_fit(argv=None, overrides=None, steps=SP_STEPS, evaluate=True,
           fault=None) -> dict:
    """One drive of phase 34 on this rank: ``tools/train.py``'s ``main`` on
    ``argv``, or (in a group that is up) the same pieces on ``overrides``
    for ``steps`` steps without evaluation. Per step: loss, grad norm, the
    replicated parameters' digest, ms (CUDA events), the sequence
    collectives' and the all-reduces' ms, calls and GB (each synchronised
    on both sides), B1-B3 and B12 launches; the peak memory. ``fault``:
    ``"no sp sum"`` skips the gradient sum on rank 1, ``"s0 at 0"`` keys
    every sequence shard's hidden dropout at position 0."""
    import torch.distributed as dist

    from fleetx_tpu_torch.core import engine
    from fleetx_tpu_torch.parallel import tensor_parallel as tp
    from fleetx_tpu_torch.tools import train as train_cli

    rows = []
    coll = {"all_gather": [0.0, 0, 0], "reduce_scatter": [0.0, 0, 0],
            "all_reduce": [0.0, 0, 0]}
    step, collective = engine.Trainer.train_step, tp._collective
    all_reduce = dist.all_reduce
    shard_fn = gpt_model.sequence_shard
    sp_sum = engine.Trainer._sum_sequence_parallel_grads

    def timed(kind, fn, nbytes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        c = coll[kind]
        c[0] += (time.perf_counter() - t0) * 1e3
        c[1] += 1
        c[2] += nbytes
        return out

    def timed_collective(op, out, src, group):
        kind = ("all_gather" if op is dist.all_gather_into_tensor
                else "reduce_scatter")
        return timed(kind, lambda: collective(op, out, src, group),
                     max(out.numel(), src.numel()) * src.element_size())

    def timed_all_reduce(t, *a, **kw):
        return timed("all_reduce", lambda: all_reduce(t, *a, **kw),
                     t.numel() * t.element_size())

    def watched_step(self, batch):
        before = {k: list(v) for k, v in coll.items()}
        launched = {**fa.launches, **ce.vp_launches}
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(self, batch)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        rows.append({
            "loss": float(out["loss"]), "grad_norm": float(out["grad_norm"]),
            "replicated": param_digest(self, replicated_only=True),
            "events": (start, end),
            "coll": {k: [v[i] - before[k][i] for i in range(3)]
                     for k, v in coll.items()},
            "launches": {k: v - launched[k] for k, v in
                         {**fa.launches, **ce.vp_launches}.items()}})
        return out

    def skip_on_rank1(self):
        # rank 1 takes part in the collective (or rank 0 would wait in it)
        # and keeps its own partial gradients
        kept = {n: p.grad.clone() for n, p in
                self.module.nets.named_parameters()
                if p.grad is not None and n not in self.mp_split}
        sp_sum(self)
        if dist.get_rank() == 1:
            for n, p in self.module.nets.named_parameters():
                if n in kept:
                    p.grad.copy_(kept[n])

    engine.Trainer.train_step = watched_step
    tp._collective = timed_collective
    dist.all_reduce = timed_all_reduce
    if fault == "no sp sum":
        engine.Trainer._sum_sequence_parallel_grads = skip_on_rank1
    if fault == "s0 at 0":
        gpt_model.sequence_shard = lambda shard, b, s_loc, mp, r: shard_fn(
            shard, b, s_loc, mp, 0)
    torch.cuda.reset_peak_memory_stats()
    try:
        if argv is not None:
            trainer = train_cli.main(list(argv))
        else:
            cfg = get_config(TRAIN_175B_CONFIG, overrides=list(overrides)
                             + [f"Engine.max_steps={steps}",
                                "Engine.eval_freq=0"])
            trainer = Trainer(cfg, build_module(cfg))
            trainer.fit(build_dataloader(cfg, "Train"))
    finally:
        engine.Trainer.train_step = step
        tp._collective = collective
        dist.all_reduce = all_reduce
        engine.Trainer._sum_sequence_parallel_grads = sp_sum
        gpt_model.sequence_shard = shard_fn
    torch.cuda.synchronize()
    for r in rows:
        start, end = r.pop("events")
        r["ms"] = start.elapsed_time(end)
    gcfg = trainer.module.gpt_config
    out = {"rows": rows, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "sp": gcfg.sp, "recompute": gcfg.recompute_granularity,
           "n_params": trainer.n_params, "layers": gcfg.num_layers,
           "hidden": gcfg.hidden_size, "heads": gcfg.num_attention_heads,
           "vocab": gcfg.vocab_size, "steps": trainer.step,
           "opt_gb": trainer.opt_state_device_bytes() / 1e9}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sp_rank(argv, off, port_v2) -> dict:
    """One rank of phase 34: the SP drive through ``tools/train.py``'s
    ``main`` (which leaves the group at its end), then, in a group rebuilt
    on ``port_v2``, the same drive with ``sequence_parallel: False`` and
    the two planted faults (2 steps and 1)."""
    import torch.distributed as dist

    from fleetx_tpu_torch.parallel.env import init_dist_env
    from fleetx_tpu_torch.parallel.mesh import set_mesh

    backend = dist.get_backend()
    runs = {"on": sp_fit(argv=argv)}
    set_mesh(None)
    os.environ["MASTER_PORT"] = str(port_v2)
    init_dist_env()
    runs["off"] = sp_fit(overrides=off)
    on_overrides = [o for o in off if o != "Model.sequence_parallel=False"]
    # the warmup gives step 1 a rate of 0: the sum's fault shows in step 2
    for fault, steps in (("no sp sum", 2), ("s0 at 0", 1)):
        runs[fault] = sp_fit(overrides=on_overrides, steps=steps,
                             fault=fault)
    runs["backend"] = backend
    return runs


def phase_train_175b_sp(prefix: str) -> dict:
    """The port's Megatron sequence-parallel path: ``tools/train.py`` on the
    175B yaml at mp 2 × SP, one layer at full width, on 2 ranks that share
    the card over gloo, SP_STEPS steps of 2 microbatches and one
    evaluation; then the same drive without SP. Gates: every loss finite
    and falling; the mp-replicated parameters bit-equal on both ranks
    after every step; SP off within TRAIN_E2E_TOL of SP on in loss and
    grad norm, and within SP_STEP1_TOL at step 1; B1-B3 and B12 launched
    as core_attn recompute launches them (B1 twice per microbatch). The
    planted faults — the SP gradient sum skipped on rank 1, the sequence
    shards' dropout keyed at position 0 — must break the replicas gate
    and the step-1 gate. Returns rank 0's launches per step."""
    from fleetx_tpu_torch.core.engine import model_flops_per_token
    from fleetx_tpu_torch.parallel.launch import free_port, spawn

    on = sp_overrides(prefix)
    argv = ["-c", TRAIN_175B_CONFIG] + [x for o in on for x in ("-o", o)]
    off = sp_overrides(prefix, "Model.sequence_parallel=False")
    results = spawn(sp_rank, 2, (argv, off, free_port()), timeout=900)
    r0 = results[0]
    if r0["backend"] != "gloo":
        raise AssertionError(f"ranks sharing one card ran {r0['backend']}")
    first = r0["on"]
    tokens = 2 * 2048
    flops = model_flops_per_token(first["n_params"], first["layers"], 2048,
                                  first["hidden"]) * tokens
    per_step = {}
    for label in ("on", "off"):
        run = r0[label]
        steady = float(np.median([r["ms"] for r in run["rows"][1:]]))
        coll = {k: [round(float(np.median([r["coll"][k][i]
                                            for r in run["rows"][1:]])), 3)
                    for i in range(3)] for k in run["rows"][0]["coll"]}
        per_step[label] = run["rows"][-1]["launches"]
        log("train-175b-sp", sp=run["sp"], layers=run["layers"],
            hidden=run["hidden"], heads=run["heads"], vocab=run["vocab"],
            recompute=run["recompute"], params_m=run["n_params"] / 1e6,
            losses=[r["loss"] for r in run["rows"]],
            grad_norms=[r["grad_norm"] for r in run["rows"]],
            step_ms=[round(r["ms"], 1) for r in run["rows"]],
            step_ms_median=steady, tokens_per_s=tokens / steady * 1e3,
            mfu=flops / (steady * 1e-3) / PEAK_FLOPS[torch.bfloat16],
            peak_gb_per_rank=[r[label]["peak_gb"] for r in results],
            opt_state_gb=run["opt_gb"],
            collectives_ms_calls_bytes_per_step=coll,
            launches_last_step=run["rows"][-1]["launches"])
    # gates
    for label in ("on", "off"):
        losses = [r["loss"] for r in r0[label]["rows"]]
        if not all(math.isfinite(x) for x in losses) or len(losses) != \
                SP_STEPS:
            raise AssertionError(f"SP {label}: losses {losses}")
        for i, (a, b) in enumerate(zip(results[0][label]["rows"],
                                       results[1][label]["rows"])):
            if (a["replicated"], a["loss"]) != (b["replicated"], b["loss"]):
                raise AssertionError(f"SP {label} step {i + 1}: the ranks' "
                                     f"replicated parameters differ")
    losses = [r["loss"] for r in first["rows"]]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if not first["sp"] or r0["off"]["sp"]:
        raise AssertionError("the drives' sequence parallelism is not as set")
    gaps = []
    for a, b in zip(first["rows"], r0["off"]["rows"]):
        gaps.append({"loss": abs(a["loss"] - b["loss"]),
                     "grad_norm": abs(a["grad_norm"] - b["grad_norm"])
                     / b["grad_norm"]})
    step1 = {"loss": gaps[0]["loss"] / abs(r0["off"]["rows"][0]["loss"]),
             "grad_norm": gaps[0]["grad_norm"]}
    log("train-175b-sp", sp_on_vs_off=gaps, step1_relative=step1,
        step1_tol=SP_STEP1_TOL, tol=TRAIN_E2E_TOL)
    if any(g[m] > TRAIN_E2E_TOL[m] for g in gaps for m in g) or any(
            step1[m] > tol for m, tol in SP_STEP1_TOL.items()):
        raise AssertionError(f"SP on vs off: {gaps}, step 1 {step1}")
    want = {"flash_fwd": 4 * SP_LAYERS, "flash_bwd_dq": 2 * SP_LAYERS,
            "flash_bwd_dkv": 2 * SP_LAYERS, "vp_ce_fwd": 2, "vp_ce_dh": 2,
            "vp_ce_dw": 2}
    for label in ("on", "off"):
        got = {k: r0[label]["rows"][1]["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"SP {label}: launches {got}, want {want}")
    # planted faults
    a, b = results[0]["no sp sum"]["rows"][-1], results[1]["no sp sum"][
        "rows"][-1]
    caught_sum = a["replicated"] != b["replicated"]
    wrong = results[0]["s0 at 0"]["rows"][0]["loss"]
    ref = r0["off"]["rows"][0]["loss"]
    caught_s0 = abs(wrong - ref) / abs(ref) > SP_STEP1_TOL["loss"]
    log("train-175b-sp", planted_fault="'SP gradient sum skipped on rank 1'",
        replicas_differ=caught_sum)
    log("train-175b-sp", planted_fault="'dropout s0 at 0'", loss=wrong,
        loss_sp_off=ref, relative=abs(wrong - ref) / abs(ref))
    if not (caught_sum and caught_s0):
        raise AssertionError(f"phase 34 misses a planted fault: sum "
                             f"{caught_sum}, s0 {caught_s0}")
    return per_step["on"]


# ------------------------------------------------------------ phases 35-37
# the serving engine's slot cache, chunked prefill and speculative decoding
# at GPT-345M width, full depth (24 layers)

CHUNK = 128          # phase 36's prefill chunk
SPEC_K = 4           # phase 37's draft length


def launch_gate(what: str, launches: int, forwards: int, layers: int) -> None:
    """A decode kernel launched once per layer of each single-token forward
    of the path, and nowhere else."""
    if launches != forwards * layers:
        raise AssertionError(f"{what}: {launches} launches over {forwards} "
                             f"single-token forwards x {layers} layers")


def must_break(gate, *args, label: str) -> None:
    """A planted fault must make ``gate`` raise."""
    try:
        gate(*args)
    except AssertionError as exc:
        log(_CLOCK["phase"], planted_fault=label, caught=str(exc)[:120])
        return
    raise AssertionError(f"the planted fault {label!r} passed its gate")


def watch_forwards(engine) -> dict:
    """Wrap the engine's executor: count its single-token (decode) and
    prefill-shaped forwards, and keep the logits of its first decode
    forward (``first``, cleared by the caller after a warm-up)."""
    seen = {"decode": 0, "prefill": 0, "first": []}
    forward = engine.executor.forward

    def counted(cache, ids, *args, **kw):
        logits, cache = forward(cache, ids, *args, **kw)
        if ids.shape[1] == 1:
            seen["decode"] += 1
            if not seen["first"]:
                seen["first"].append(logits[:, -1].float().clone())
        else:
            seen["prefill"] += 1
        return logits, cache

    engine.executor.forward = counted
    return seen


def watch_samples(engine) -> dict:
    """Wrap ``engine._sample``: per request, the logits row its first token
    came from (``rows[rid]``), and for each token the gap between the
    row's two largest logits (``gaps``) and the largest (``tops``)."""
    rows, gaps, tops = {}, {}, {}
    sample = engine._sample

    def kept(reqs, logits):
        top = torch.topk(logits.float(), 2, dim=-1).values.cpu()
        for i, r in enumerate(reqs):
            if not r.tokens:
                rows[r.id] = logits[i].float().clone()
            gaps.setdefault(r.id, []).append(float(top[i, 0] - top[i, 1]))
            tops.setdefault(r.id, []).append(float(top[i, 0]))
        return sample(reqs, logits)

    engine._sample = kept
    return {"rows": rows, "gaps": gaps, "tops": tops}


def tpot_ms(results, ids=None) -> list:
    """Per-request decode ms per token after the first."""
    return [(r.latency_s - r.ttft_s) / (len(r.tokens) - 1) * 1e3
            for rid, r in results.items()
            if len(r.tokens) > 1 and (ids is None or rid in ids)]


def quantiles(xs, qs=(50, 99)) -> list:
    return [float(np.percentile(xs, q)) for q in qs] if xs else [None] * 2


def drained(engine, what: str) -> None:
    """Nothing leaks after a drain: every lane free, no page held, the
    manager's invariants hold."""
    manager = engine.cache_manager
    if manager.free_count != engine.slots or (
            engine.paged and manager.pages_in_use):
        raise AssertionError(f"{what}: {manager.active_count} lanes, "
                             f"{getattr(manager, 'pages_in_use', 0)} pages "
                             "held after the drain")
    manager.check_invariants()


def logits_gate(what: str, got, want) -> float:
    err = (got - want).abs().max().item()
    if not (math.isfinite(err) and err <= LOGIT_TOL):
        raise AssertionError(f"{what}: logits differ by {err}")
    return err


def phase_slot_serving(params, cfg) -> dict:
    """Phase 35: phase 4's requests through the slot cache (``paged=False``)
    — every decode tick launches B7 once per layer and no other decode
    kernel, nothing leaks — then through an engine whose B7 is its plain
    version: the first decode tick's logits agree within LOGIT_TOL and the
    greedy common-prefix fraction is reported; then at int8 KV (B9). The
    launch gate given one tick short and the logits gate given the plain
    run's rows rolled by one must each break."""
    requests = serving_requests(cfg.vocab_size)
    greedy_ids = [i for i, r in enumerate(requests)
                  if r["decode_strategy"] == "greedy"]
    out, firsts, streams = {}, {}, {}
    for label, kv, attention in (
            ("kernel", None, da.decode_attention),
            ("plain", None, da.decode_attention_ref),
            ("int8", "int8", da.decode_attention)):
        engine, _ = build_engine(kv, params=params, paged=False)
        gpt_model.decode_attention = attention
        try:
            serve(engine, [dict(prompt=np.arange(40), max_length=4)])
            seen = watch_forwards(engine)
            seen["first"].clear()
            seen["decode"] = 0
            zero_launches()
            results, ticks, seconds = serve(engine, requests)
        finally:
            gpt_model.decode_attention = da.decode_attention
        counts = dict(da.launches)
        drained(engine, f"slot {label}")
        name = "decode_q8" if kv else "decode"
        launches = counts.pop(name) if label != "plain" else 0
        tokens = sum(len(r.tokens) for r in results.values())
        log("slot-serving", run=label, kv_dtype=engine.kv_dtype,
            requests=len(results), tokens=tokens, decode_ticks=ticks,
            kernel=name, kernel_launches=launches,
            tokens_per_s=tokens / seconds, seconds=seconds,
            ttft_ms_p50=float(np.median([r.ttft_s for r in
                                         results.values()])) * 1e3,
            tpot_ms_p50=float(np.median(tpot_ms(results))),
            finish_reasons=engine.metrics.snapshot()["finish_reasons"])
        if any(counts.values()):
            raise AssertionError(f"slot {label}: other decode kernels "
                                 f"launched: {counts}")
        if len(results) != len(requests):
            raise AssertionError(f"slot {label}: {len(results)} results")
        for r in results.values():
            if not (len(r.tokens) and r.tokens.min() >= 0
                    and r.tokens.max() < cfg.vocab_size):
                raise AssertionError(f"request {r.id} emitted {r.tokens}")
        if label != "plain":
            launch_gate(f"slot {label}", launches, seen["decode"],
                        cfg.num_layers)
            if seen["decode"] != ticks:
                raise AssertionError(f"{seen['decode']} decode forwards in "
                                     f"{ticks} ticks")
            out[name] = {"launches": launches, "ticks": ticks}
        firsts[label] = seen["first"][0]
        streams[label] = [results[rid] for rid in sorted(results)]
        del engine
    err = logits_gate("slot first tick", firsts["kernel"], firsts["plain"])
    agree = [common_prefix(streams["kernel"][i].tokens,
                           streams["plain"][i].tokens)
             / len(streams["plain"][i].tokens) for i in greedy_ids]
    log("slot-serving", first_tick_logits_max_abs_err=err, tol=LOGIT_TOL,
        greedy_common_prefix_frac=float(np.mean(agree)),
        per_request=[round(a, 3) for a in agree])
    must_break(launch_gate, "slot kernel", out["decode"]["launches"]
               - cfg.num_layers, out["decode"]["ticks"], cfg.num_layers,
               label="one tick through the plain version")
    must_break(logits_gate, "slot first tick", firsts["kernel"],
               firsts["plain"].roll(1, 0), label="rows rolled by one")
    return out


def chunked_requests(vocab: int, seed: int = 5) -> list:
    """Six greedy prompts of 40-64 tokens asking 64 new tokens, and two of
    900 asking 16, in the order short, short, short, long, short, short,
    short, long: the long prompts arrive while short streams decode."""
    rng = np.random.RandomState(seed)
    lengths = [40, 52, 64, 900, 44, 58, 61, 900]
    return [dict(prompt=rng.randint(0, vocab, n),
                 max_length=16 if n == 900 else MAX_NEW, min_length=0,
                 decode_strategy="greedy") for n in lengths]


def chunk_run(params, paged: bool, chunk: int, requests,
              fault: bool = False) -> dict:
    """Serve ``requests`` through one engine, tick by tick, recording per
    tick its prefill-shaped calls, its wall time and, on ticks that start
    with a prompt mid-prefill, each active stream's token gain.
    ``fault``: decode skipped on every tick that runs a chunk (a planted
    stall), for at most 12 ticks."""
    engine, cfg = build_engine(params=params, paged=paged,
                               prefill_chunk=chunk)
    seen = watch_forwards(engine)
    samples = watch_samples(engine)
    if fault:
        run_chunk, tick = engine._chunk_tick, engine._tick_decode
        state = {"chunked": False}

        def chunk_tick():
            state["chunked"] = True
            return run_chunk()

        def tick_decode():
            if state.pop("chunked", False):
                return []
            return tick()

        engine._chunk_tick, engine._tick_decode = chunk_tick, tick_decode
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in requests:
        engine.submit(**r)
    per_tick, gains, ticks = [], [], 0
    while engine.scheduler.queue_depth or engine._active or \
            engine._prefilling:
        before = ({r.id: len(r.tokens) for r in engine._active.values()}
                  if engine._prefilling else {})
        reqs = list(engine._active.values())
        prefills = seen["prefill"]
        t = time.perf_counter()
        summary = engine.step()
        per_tick.append((seen["prefill"] - prefills,
                         time.perf_counter() - t))
        ticks += summary["decoded"] > 0
        gains.extend(len(r.tokens) - before[r.id] for r in reqs
                     if r.id in before)
        if fault and len(per_tick) >= 12:
            break
    results = engine.drain() if not fault else {}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not fault:
        drained(engine, f"chunked paged={paged} chunk={chunk}")
    snap = engine.metrics.snapshot()
    return dict(results=results, per_tick=per_tick, gains=gains,
                ticks=ticks, seconds=seconds, decode_forwards=seen["decode"],
                launches=dict(da.launches), first_rows=samples["rows"],
                prefill_chunks=snap["prefill_chunks"],
                stall_ms_max=snap["prefill_stall_ms_max"],
                layers=cfg.num_layers)


def one_call_gate(run) -> None:
    worst = max(n for n, _ in run["per_tick"])
    if worst > 1:
        raise AssertionError(f"a tick made {worst} prefill-shaped calls")


def stall_gate(run) -> None:
    if not run["gains"] or set(run["gains"]) != {1}:
        raise AssertionError(f"active streams gained "
                             f"{sorted(set(run['gains']))} tokens on ticks "
                             "with a prompt mid-prefill")


def phase_chunked(params, cfg) -> dict:
    """Phase 36: chunked prefill, paged (B8) and slot (B7), ``prefill_chunk``
    128, ``cache_len`` 1024, over :func:`chunked_requests`, each against the
    same engine unchunked. Gates: at most one prefill-shaped call per tick;
    every active stream gains one token on each tick that starts with a
    prompt mid-prefill; each request's first-token logits (the final
    chunk's) within LOGIT_TOL of the unchunked engine's; the decode kernel
    launched once per layer of each decode forward; nothing leaks.
    Recorded: the longest tick, and TPOT p50/p99 of the short streams,
    chunked against unchunked. Planted: the unchunked run through the
    one-call gate, a chunked engine that skips decode on chunk ticks
    through the stall gate, and the first long prompt's logits against the
    second's, must each break."""
    requests = chunked_requests(cfg.vocab_size)
    short = {i for i, r in enumerate(requests) if len(r["prompt"]) < 900}
    longs = sorted(set(range(len(requests))) - short)
    out = {}
    for paged in (True, False):
        name = "paged_decode" if paged else "decode"
        runs = {c: chunk_run(params, paged, c, requests) for c in (0, CHUNK)}
        one, base = runs[CHUNK], runs[0]
        one_call_gate(one)
        stall_gate(one)
        errs = [logits_gate(f"request {i} first token",
                            one["first_rows"][i], base["first_rows"][i])
                for i in range(len(requests))]
        for label, run in runs.items():
            launch_gate(f"chunked {name} chunk={label}", run["launches"][name],
                        run["decode_forwards"], run["layers"])
            others = {k: v for k, v in run["launches"].items()
                      if k != name and v}
            if others:
                raise AssertionError(f"other decode kernels launched: "
                                     f"{others}")
            p50, p99 = quantiles(tpot_ms(run["results"], short))
            log("chunked", layout="paged" if paged else "slot",
                prefill_chunk=label, ticks=len(run["per_tick"]),
                decode_ticks=run["ticks"],
                prefill_chunks=run["prefill_chunks"],
                max_prefill_calls_per_tick=max(n for n, _ in run["per_tick"]),
                longest_tick_ms=max(t for _, t in run["per_tick"]) * 1e3,
                prefill_stall_ms_max=run["stall_ms_max"],
                short_tpot_ms_p50=p50, short_tpot_ms_p99=p99,
                seconds=run["seconds"], kernel=name,
                kernel_launches=run["launches"][name])
        if one["prefill_chunks"] != 2 * math.ceil(900 / CHUNK):
            raise AssertionError(f"{one['prefill_chunks']} chunks ran")
        log("chunked", layout="paged" if paged else "slot",
            first_token_logits_max_abs_err=max(errs), tol=LOGIT_TOL,
            stream_gains=sorted(set(one["gains"])),
            gained_ticks=len(one["gains"]))
        must_break(one_call_gate, base, label="no chunking (one tick admits "
                   "all eight)")
        must_break(logits_gate, "long prompts swapped",
                   one["first_rows"][longs[0]], base["first_rows"][longs[1]],
                   label="the other long prompt's logits")
        if paged:
            must_break(stall_gate, chunk_run(params, True, CHUNK, requests,
                                             fault=True),
                       label="decode skipped on chunk ticks")
        out[name] = {"launches": one["launches"][name],
                     "decode_ticks": one["ticks"]}
    return out


SPEC_NEW = 16  # phase 37's new tokens a request (64 until cut for 41-43)
SPEC_LAYERS = 12  # phase 37's depth: GPT-345M's 24 cut for time (PR 20)


def spec_requests(vocab: int, seed: int = 6, sampling: bool = False) -> list:
    """Eight prompts that repeat a 32-token pattern of their own 3 to 8
    times (96..256 tokens), asking SPEC_NEW new tokens each."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(8):
        pattern = rng.randint(0, vocab, 32)
        kw = (dict(decode_strategy="sampling", temperature=1.0, top_k=50,
                   top_p=0.75, seed=300 + i) if sampling
              else dict(decode_strategy="greedy"))
        out.append(dict(prompt=np.tile(pattern, 3 + i % 6),
                        max_length=min(SPEC_NEW, MAX_NEW), min_length=0,
                        **kw))
    return out


def spec_run(params, requests, kv=None, spec=None, fault=None) -> dict:
    """Serve ``requests`` through one paged engine: plain (``spec`` None),
    or speculative with ``spec`` = ``"ngram"`` | ``"self"`` at k SPEC_K.
    Records the decode forwards, the draft's single-token forwards, the
    launches, each greedy request's top-2 logit gaps (plain) and, at every
    rejected draft of a greedy row, the verify's gap between its argmax
    and the drafted token, and the verify calls' ms. ``fault="accept"``:
    every draft accepted (a planted acceptance fault)."""
    old = os.environ.pop("FLEETX_SERVING_SPEC_DRAFT", None)
    try:
        if spec == "self":
            os.environ["FLEETX_SERVING_SPEC_DRAFT"] = "self"
        engine, cfg = build_engine(kv, params=params, spec=spec is not None,
                                   spec_k=SPEC_K, layers=SPEC_LAYERS)
    finally:
        os.environ.pop("FLEETX_SERVING_SPEC_DRAFT", None)
        if old is not None:
            os.environ["FLEETX_SERVING_SPEC_DRAFT"] = old
    seen = watch_forwards(engine)
    samples = watch_samples(engine)
    rejections, verify_ms = [], []
    if spec is not None:
        accept, verify = engine._accept, engine._verify

        def timed_verify(draft, k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits = verify(draft, k)
            torch.cuda.synchronize()
            verify_ms.append((time.perf_counter() - t) * 1e3)
            return logits

        def watched_accept(logits, draft, dlen):
            out, emitted, accepted = accept(logits, draft, dlen)
            for slot, req in engine._active.items():
                j = int(accepted[slot])
                if req.greedy and j < dlen[slot]:
                    row = logits[slot, j]
                    rejections.append(float(row.max()
                                            - row[int(draft[slot, j])]))
            if fault == "accept":
                for slot in engine._active:
                    n = int(dlen[slot])
                    out[slot, :n] = draft[slot, :n]
                    accepted[slot], emitted[slot] = n, n + 1
            return out, emitted, accepted

        engine._verify, engine._accept = timed_verify, watched_accept
    zero_launches()
    results, ticks, seconds = serve(engine, requests)
    drained(engine, f"spec {spec} kv={kv}")
    snap = engine.metrics.snapshot()
    draft_forwards = (engine._proposer.single_token_forwards
                      if spec == "self" else 0)
    del engine
    return dict(results=results, decode_forwards=seen["decode"],
                draft_forwards=draft_forwards, launches=dict(da.launches),
                gaps=samples["gaps"], rejections=rejections,
                verify_ms=verify_ms, seconds=seconds, snap=snap,
                layers=cfg.num_layers)


def divergence_gate(spec_run_, plain_run) -> list:
    """Wherever a greedy spec stream parts from the plain engine's, the
    plain engine's top-2 logit gap at that position lies within LOGIT_TOL
    (the split comes from rounding between the decode kernel and the dense
    verify, not from acceptance). Returns the (request, index, gap)
    splits."""
    splits = []
    for rid, want in plain_run["results"].items():
        got = spec_run_["results"][rid].tokens
        n = common_prefix(got, want.tokens)
        if n == len(got) == len(want.tokens):
            continue
        gaps = plain_run["gaps"][rid]
        gap = gaps[n] if n < len(gaps) else float("inf")
        splits.append((rid, n, gap))
        if not gap <= LOGIT_TOL:
            raise AssertionError(f"request {rid} parts from the plain "
                                 f"stream at token {n}, where the plain "
                                 f"top-2 gap is {gap}")
    return splits


def rejection_gate(run) -> None:
    """A self-draft rejection only ever falls on a near-tie."""
    worst = max(run["rejections"], default=0.0)
    if not worst <= LOGIT_TOL:
        raise AssertionError(f"a rejected draft lies {worst} below the "
                             "verify's argmax")


def phase_spec(params, cfg) -> dict:
    """Phase 37: speculative decoding at k SPEC_K on the paged engine, the
    n-gram proposer over :func:`spec_requests` and the self-draft proposer
    (``FLEETX_SERVING_SPEC_DRAFT=self``), at bf16 and at int8 KV, each
    against the plain engine. Gates: where a greedy stream parts from the
    plain engine's, the plain top-2 gap there lies within LOGIT_TOL, and so
    does every self-draft rejection's gap; B8 (B10 at int8) launched once
    per layer of each plain tick (the verify launches none), B7 once per
    layer of each single-token draft forward; a seeded sampling run repeats
    its tokens. Recorded: acceptance rate, tokens per verify, verify ms,
    TPOT against the plain engine. Planted: an engine that accepts every
    draft through the divergence gate, the n-gram rejections through the
    self-draft gate, a launch count one draft step short, and the sampling
    run with another seed, must each break. The engines hold the first
    SPEC_LAYERS layers of ``params``."""
    params = first_layers(params, SPEC_LAYERS)
    requests = spec_requests(cfg.vocab_size)
    out = {}
    for kv in (None, "int8"):
        paged_name = "paged_decode_q8" if kv else "paged_decode"
        plain = spec_run(params, requests, kv)
        launch_gate(f"plain kv={kv}", plain["launches"][paged_name],
                    plain["decode_forwards"], plain["layers"])
        base_tpot = float(np.median(tpot_ms(plain["results"])))
        for proposer in ("ngram", "self"):
            run = spec_run(params, requests, kv, proposer)
            launch_gate(f"{proposer} kv={kv} plain ticks",
                        run["launches"][paged_name], run["decode_forwards"],
                        run["layers"])
            launch_gate(f"{proposer} kv={kv} draft", run["launches"]["decode"],
                        run["draft_forwards"], run["layers"])
            others = {k: v for k, v in run["launches"].items()
                      if k not in (paged_name, "decode") and v}
            if others:
                raise AssertionError(f"other decode kernels launched: "
                                     f"{others}")
            splits = divergence_gate(run, plain)
            if proposer == "self":
                rejection_gate(run)
            snap = run["snap"]
            log("spec", proposer=proposer, kv_dtype=kv or "bf16", k=SPEC_K,
                acceptance_rate=snap["spec_acceptance_rate"],
                tokens_per_verify=snap["spec_tokens_per_tick_mean"],
                verify_calls=len(run["verify_ms"]),
                verify_ms_p50=quantiles(run["verify_ms"])[0],
                plain_ticks=run["decode_forwards"],
                draft_forwards=run["draft_forwards"],
                b7_launches=run["launches"]["decode"],
                paged_launches=run["launches"][paged_name],
                tpot_ms_p50=float(np.median(tpot_ms(run["results"]))),
                plain_tpot_ms_p50=base_tpot, splits=splits,
                rejections=len(run["rejections"]),
                worst_rejection_gap=max(run["rejections"], default=None),
                seconds=run["seconds"], plain_seconds=plain["seconds"])
            key = f"launches_spec_{proposer}"
            out.setdefault(paged_name, {})[key] = run["launches"][paged_name]
            if proposer == "self":
                out.setdefault("decode", {})[
                    f"launches_draft_{kv or 'bf16'}"] = \
                    run["launches"]["decode"]
            if proposer == "ngram" and kv is None:
                must_break(rejection_gate, run,
                           label="n-gram rejections through the self-draft "
                           "gate")
                must_break(launch_gate, "draft", run["draft_forwards"] + 1,
                           run["draft_forwards"], run["layers"],
                           label="a draft step without its launches")
        if kv is None:
            faulty = spec_run(params, requests, kv, "ngram", fault="accept")
            must_break(divergence_gate, faulty, plain,
                       label="every draft accepted")
    sampled = [spec_run(params, spec_requests(cfg.vocab_size, sampling=True),
                        None, "ngram") for _ in range(2)]

    def repeat_gate(a, b) -> None:
        for rid, r in a["results"].items():
            if r.tokens.tolist() != b["results"][rid].tokens.tolist():
                raise AssertionError(f"seeded request {rid} did not repeat")

    repeat_gate(*sampled)
    other = [dict(r, seed=r["seed"] + 1)
             for r in spec_requests(cfg.vocab_size, sampling=True)]
    must_break(repeat_gate, sampled[0],
               spec_run(params, other, None, "ngram"),
               label="another seed")
    log("spec", sampling_repeats=True,
        sampling_acceptance_rate=sampled[0]["snap"]["spec_acceptance_rate"])
    return out


# ------------------------------------------------------------ phases 38-40
# the serving engine's page tiers, prefill/decode roles with KV shipping
# and crash recovery at GPT-345M width, full depth (24 layers)

TIER_PREFIX = 512      # phase 38's system prompts, four of them
TIER_POOL = 257        # phase 38's pool: 256 usable pages of 16
TIER_HOST_PAGES = 64   # its host tier's budget in pages; the disk the rest
TIER_DISK_PAGES = 1024
TIER_LANES = 16        # two system prompts' requests decode together


def tier_requests(vocab: int, seed: int = 7) -> tuple:
    """Phase 38's traffic: wave 1, four 512-token system prompts each with
    eight requests of 32-64 suffix tokens asking 64 new tokens; wave 2,
    eight unrelated prompts of 384-448 tokens asking 16, which push every
    warm page of wave 1 out of the pool (the last ones into the host
    tier)."""
    rng = np.random.RandomState(seed)
    first = []
    for _ in range(4):
        prefix = rng.randint(0, vocab, TIER_PREFIX)
        first += [dict(prompt=np.concatenate(
            [prefix, rng.randint(0, vocab, rng.randint(32, 65))]),
            max_length=MAX_NEW, decode_strategy="greedy") for _ in range(8)]
    second = [dict(prompt=rng.randint(0, vocab, rng.randint(384, 449)),
                   max_length=16, decode_strategy="greedy")
              for _ in range(8)]
    return first, second


def in_order(engine, requests) -> list:
    """:func:`serve`'s results in submit order; with
    :func:`watch_samples` on the engine, each result carries its first
    token's logits row as ``first_row``."""
    results, _, _ = serve(engine, requests)
    rows = getattr(engine, "first_rows", {})
    out = []
    for rid in sorted(results):
        out.append(results[rid])
        out[-1].first_row = rows.get(rid)
    return out


def watch_first_rows(engine):
    engine.first_rows = watch_samples(engine)["rows"]
    return engine


def streams_gate(what: str, got, want) -> None:
    """Greedy and seeded streams byte-equal, request by request."""
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if a.tokens.tolist() != b.tokens.tolist()]
    if bad or len(got) != len(want):
        raise AssertionError(f"{what}: the streams of requests {bad} "
                             f"differ ({len(got)} against {len(want)})")


def revival_gate(what: str, got, want) -> None:
    """Revived pages hold the spilled bytes, so a request served over them
    makes its reference's very prefill call: the streams byte-equal and
    the first token's logits bit-equal (a revival one position off can
    leave a random-weight model's greedy stream as it was, not its
    logits)."""
    streams_gate(what, got, want)
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if not torch.equal(a.first_row, b.first_row)]
    if bad:
        worst = max((got[i].first_row - want[i].first_row).abs().max().item()
                    for i in bad)
        raise AssertionError(f"{what}: the first-token logits of requests "
                             f"{bad} differ (by up to {worst})")


def watch_rows(engine) -> dict:
    """Wrap ``engine._sample``: every logits row a token was drawn from,
    keyed ``(request id, tokens emitted before it)`` (a rolled-back tick's
    row is replaced when the tick is redone), with the tick it came on."""
    rows, ticks = {}, {}
    sample = engine._sample

    def kept(reqs, logits):
        for i, r in enumerate(reqs):
            key = (r.id, len(r.tokens))
            rows[key] = logits[i].float().clone()
            ticks[key] = engine._ticks
        return sample(reqs, logits)

    engine._sample = kept
    return {"rows": rows, "ticks": ticks}


def rows_gate(what: str, got: dict, want: dict, keys) -> None:
    """The logits rows ``keys`` (``(request, tokens before)`` pairs, the
    same requests in the same submit order on both engines) bit-equal:
    replayed or shipped K/V one position off can leave a random-weight
    model's greedy stream as it was, not these rows."""
    keys = sorted(keys)
    missing = [k for k in keys if k not in got or k not in want]
    bad = [k for k in keys if k not in missing
           and not torch.equal(got[k], want[k])]
    if not keys or missing or bad:
        worst = max(((got[k] - want[k]).abs().max().item() for k in bad),
                    default=None)
        raise AssertionError(f"{what}: of {len(keys)} logits rows, {missing} "
                             f"are missing and {bad} differ (by up to "
                             f"{worst})")


def watch_tiers(engine) -> dict:
    """Time the pool's batched spill and revive copies (device synced),
    with their pages and bytes."""
    seen = {"spill_ms": [], "revive_ms": [], "spill_pages": 0,
            "revive_pages": 0, "spill_bytes": 0, "revive_bytes": 0}
    pool = engine.cache_manager.pool
    spill, revive = pool._spill_fn, pool._revive_fn

    def timed_spill(pages):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = spill(pages)
        seen["spill_ms"].append((time.perf_counter() - t) * 1e3)
        seen["spill_pages"] += len(pages)
        seen["spill_bytes"] += sum(n for _, n in out)
        return out

    def timed_revive(entries):
        torch.cuda.synchronize()
        t = time.perf_counter()
        revive(entries)
        torch.cuda.synchronize()
        seen["revive_ms"].append((time.perf_counter() - t) * 1e3)
        seen["revive_pages"] += len(entries)
        seen["revive_bytes"] += sum(payload_nbytes(p) for _, p in entries)

    pool._spill_fn, pool._revive_fn = timed_spill, timed_revive
    return seen


def time_calls(targets) -> dict:
    """Wrap each ``(object, method name, label)``: the host ms its calls
    took, summed per label, and their count (``label + "_calls"``)."""
    spent = {}
    for obj, name, label in targets:
        def timed(*args, _fn=getattr(obj, name), _label=label, **kw):
            t = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                spent[_label] = spent.get(_label, 0.0) + (
                    time.perf_counter() - t) * 1e3
                spent[_label + "_calls"] = spent.get(_label + "_calls", 0) + 1
        setattr(obj, name, timed)
    return spent


def spill_warm(engine) -> int:
    """Evict every warm (zero-ref) trie page of ``engine``'s pool through
    the pool's own LRU eviction, so that the page tiers hold them all;
    returns how many pages went."""
    pool = engine.cache_manager.pool
    n = pool.cached_pages
    while pool.cached_pages:
        pool._evict_subtree(next(iter(pool._cached.values())))
    return n


def single_ttft_ms(engine, request) -> tuple:
    """One request alone on ``engine``: its result and TTFT in ms."""
    (res,) = in_order(engine, [request])
    return res, res.ttft_s * 1e3


def phase_tiers(params, cfg) -> dict:
    """Phase 38: the host and disk page tiers (module docstring)."""
    first, second = tier_requests(cfg.vocab_size)
    ref = watch_first_rows(build_engine(params=params, slots=TIER_LANES)[0])
    # 1025 pages: it never evicts here. Its first pass warms the trie (one token a
    # request, but request 9's whole stream: the corrupt-file check's
    # reference); the second serves wave 1 from the device trie
    ref_cold = in_order(ref, [dict(r, max_length=MAX_NEW if i == 9 else 1)
                              for i, r in enumerate(first)])
    ref_warm = in_order(ref, first)
    snap = ref.metrics.snapshot()
    if snap["prefix_hits"] < 2 * len(first) - 4:
        raise AssertionError(f"the reference trie missed: {snap}")
    page_bytes = snap["kv_bytes_per_token"] * ref.page_size
    del ref
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        disk = dict(disk_cache_dir=tmp,
                    disk_cache_bytes=TIER_DISK_PAGES * page_bytes * 2)
        engine = watch_first_rows(build_engine(
            params=params, slots=TIER_LANES, num_pages=TIER_POOL,
            host_cache_bytes=TIER_HOST_PAGES * page_bytes, **disk)[0])
        tiers = watch_tiers(engine)
        seen = watch_forwards(engine)
        zero_launches()
        wave1 = in_order(engine, first)
        in_order(engine, second)
        host0, disk0 = (engine._dram_store.revived_pages,
                        engine._disk_store.hits)
        revived0 = tiers["revive_pages"]
        # wave 1 again, last group first: the host tier holds the pages
        # spilled last; its ticks broken down on the host's clock
        wave3 = time_calls([
            (engine, "step", "tick"), (engine, "_admit", "admit"),
            (engine, "_tick_decode", "decode"),
            (engine._dram_store, "put", "host_put"),
            (engine._dram_store, "get", "host_get"),
            (engine._disk_store, "put", "disk_put"),
            (engine._disk_store, "get", "disk_get"),
            (engine.metrics, "observe_host_tier", "host_sync"),
            (engine.metrics, "observe_disk_tier", "disk_sync")])
        got = in_order(engine, first[::-1])[::-1]
        for attr in ("step", "_admit", "_tick_decode"):
            delattr(engine, attr)
        revival_gate("tiers: wave 1 served again", got, ref_warm)
        launches = da.launches["paged_decode"]
        launch_gate("tiers", launches, seen["decode"], cfg.num_layers)
        drained(engine, "tiers")
        snap = engine.metrics.snapshot()
        host_revived = engine._dram_store.revived_pages - host0
        disk_revived = engine._disk_store.hits - disk0
        if not (host_revived and disk_revived):
            raise AssertionError(f"wave 3 revived {host_revived} pages from "
                                 f"the host, {disk_revived} from the disk")
        if tiers["revive_pages"] - revived0 < 4 * TIER_PREFIX // 16:
            raise AssertionError("wave 3 did not revive the prefixes")
        log("tiers", requests=len(first), second_wave=len(second),
            pool_pages=TIER_POOL, host_tier_pages=TIER_HOST_PAGES,
            page_bytes=page_bytes, b8_launches=launches,
            spilled_pages=tiers["spill_pages"],
            spilled_bytes=tiers["spill_bytes"],
            spill_subtrees=len(tiers["spill_ms"]),
            spill_ms_per_subtree_p50=quantiles(tiers["spill_ms"])[0],
            spill_ms_max=max(tiers["spill_ms"]),
            revived_pages=tiers["revive_pages"],
            revived_bytes=tiers["revive_bytes"],
            revive_calls=len(tiers["revive_ms"]),
            revive_ms_per_call_p50=quantiles(tiers["revive_ms"])[0],
            revive_ms_max=max(tiers["revive_ms"]),
            wave3_from_host_pages=host_revived,
            wave3_from_disk_pages=disk_revived,
            host_evicted_pages=snap["host_evicted_pages"],
            disk_files=len(os.listdir(tmp)),
            disk_bytes=snap["disk_cache_bytes"],
            ttft_ms_p50_wave1=quantiles([r.ttft_s * 1e3 for r in wave1])[0],
            ttft_ms_p50_wave3=quantiles([r.ttft_s * 1e3 for r in got])[0],
            tpot_ms_p50_wave3=quantiles(tpot_ms(dict(enumerate(got))))[0])
        log("tiers", **{f"wave3_{k}" + ("" if k.endswith("_calls") else "_ms"):
                        v for k, v in sorted(wave3.items())})
        out["launches"] = launches
        # the pages still warm in the pool go to the tiers too, so that a
        # fresh engine finds every page of wave 1 on the disk
        log("tiers", flushed_warm_pages=spill_warm(engine))
        del engine
        # TTFT of one request: cold, its pages revived from the disk, and
        # after prewarm (a device trie hit). Every engine compared with the
        # reference has its lanes: a decode forward's rows repeat their
        # bits only at the same batch
        cold, _ = build_engine(params=params, slots=TIER_LANES)
        _, ttft_cold = single_ttft_ms(cold, first[24])
        del cold
        fresh = watch_first_rows(build_engine(params=params,
                                              slots=TIER_LANES, **disk)[0])
        res, ttft_disk = single_ttft_ms(fresh, first[24])
        revival_gate("tiers: revived from the disk", [res], [ref_warm[24]])
        warm = fresh.prewarm(first[0]["prompt"])
        if warm < TIER_PREFIX:
            raise AssertionError(f"prewarm made {warm} tokens warm")
        res, ttft_warm = single_ttft_ms(fresh, first[0])
        revival_gate("tiers: prewarmed", [res], [ref_warm[0]])
        # planted: a flipped byte in the file of request 9's first suffix
        # page; the revival refuses it and prefills from the prefix, as
        # wave 1 did for that request
        pool = fresh.cache_manager.pool
        chunks = pool._chunks(first[9]["prompt"])
        path = fresh._disk_store._path(tuple(chunks[:TIER_PREFIX // 16 + 1]))
        raw = bytearray(open(path, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(path, "wb").write(bytes(raw))
        misses = fresh._disk_store.misses
        (res,) = in_order(fresh, [first[9]])
        if os.path.exists(path) or fresh._disk_store.misses == misses:
            raise AssertionError("the corrupt page file was not refused")
        revival_gate("tiers: corrupt file re-prefilled", [res],
                     [ref_cold[9]])
        log("tiers", prewarm_tokens=warm, ttft_ms_cold=ttft_cold,
            ttft_ms_revived_from_disk=ttft_disk,
            ttft_ms_prewarmed=ttft_warm, corrupt_file_refused=True)
        del fresh
        # planted: values revived one position off their keys
        bad = watch_first_rows(build_engine(params=params, slots=TIER_LANES,
                                            **disk)[0])
        revive = bad.cache_manager.pool._revive_fn
        value = bad.cache_manager.payload_leaves.index("value")

        def shifted(entries):
            moved = []
            for page, payload in entries:
                payload = list(payload)
                payload[value] = payload[value].roll(1, dims=1)
                moved.append((page, payload))
            revive(moved)

        bad.cache_manager.pool._revive_fn = shifted
        (res,) = in_order(bad, [first[17]])
        must_break(revival_gate, "tiers: values one position off", [res],
                   [ref_warm[17]], label="values revived one position off")
        log("tiers", planted_stream_differs=res.tokens.tolist()
            != ref_warm[17].tokens.tolist())
        del bad
    return out


def ship_run(params, cfg, kv, requests) -> dict:
    """Phase 39 at one KV precision: ``requests`` through one colocated
    engine, then through a prefill-role engine shipping each parked
    request's pages as bytes to a decode-role engine, with the planted
    faults on two of them."""
    colocated, _ = build_engine(kv, params=params)
    want_rows = watch_rows(colocated)["rows"]
    stamps = {}

    def stamped(i):
        return lambda rid, tok, done: stamps.setdefault(i, []).append(
            time.perf_counter())

    t0 = time.perf_counter()
    for i, r in enumerate(requests):
        colocated.submit(**r, on_token=stamped(("co", i)))
    res = colocated.drain()
    want = [res[rid] for rid in sorted(res)]
    second_co = [stamps[("co", i)][1] - t0 for i in range(len(requests))]
    del colocated
    pre, _ = build_engine(kv, params=params, role="prefill")
    dec, _ = build_engine(kv, params=params, role="decode")
    seen = watch_forwards(dec)
    dec_rows = watch_rows(dec)["rows"]
    admit_ms, export_ms = [], []
    admit = dec._admit_shipped

    def timed_admit(req):
        torch.cuda.synchronize()
        t = time.perf_counter()
        admit(req)
        torch.cuda.synchronize()
        admit_ms.append((time.perf_counter() - t) * 1e3)

    dec._admit_shipped = timed_admit
    name = "paged_decode_q8" if kv else "paged_decode"
    zero_launches()
    page_wire = len(HostPageStore.payload_to_bytes(
        pre.cache_manager.read_pages([1])[0]))
    t0 = time.perf_counter()
    rids = [pre.submit(**r) for r in requests]
    handed, shipped, got, refusals = {}, {}, {}, []
    first_ship, drids = None, {}
    while len(got) < len(requests):
        pre.step()
        for erid in pre.prefilled_ready():
            i = rids.index(erid)
            if i == 2:  # planted: one byte of the ship flipped
                faults.configure(kv_ship_corrupt=str(pre._fault_ships))
            t = time.perf_counter()
            blobs = pre.export_kv(erid)
            export_ms.append((time.perf_counter() - t) * 1e3)
            faults.reset()
            stub = pre.take_result(erid)
            shipped[i] = sum(len(b) for b in blobs)
            if i == 0:
                first_ship = (blobs, stub.tokens)
            kw = dict(requests[i], history=stub.tokens,
                      on_token=stamped(("dec", i)))
            if i == 5:  # planted: a page one layer short
                leaves = HostPageStore.payload_from_bytes(blobs[0])
                short = HostPageStore.payload_to_bytes(
                    [None if x is None else x[:-1] for x in leaves])
                try:
                    dec.submit(**kw, kv_payloads=[short] + blobs[1:])
                except ValueError as exc:
                    refusals.append(("one layer short", str(exc)[:80]))
            try:
                handed[i] = dec.submit(**kw, kv_payloads=blobs)
            except ValueError as exc:
                refusals.append(("corrupt ship", str(exc)[:80]))
                handed[i] = dec.submit(**kw)  # the fallback: replay
            drids[i] = handed[i]
        dec.step()
        for i, drid in list(handed.items()):
            r = dec.take_result(drid)
            if r is not None:
                got[i] = r
                del handed[i]
    got = [got[i] for i in range(len(requests))]
    second_dec = [stamps[("dec", i)][0] - t0 for i in range(len(requests))]
    if [what for what, _ in refusals] != ["corrupt ship", "one layer short"]:
        raise AssertionError(f"planted ship faults refused: {refusals}")
    streams_gate(f"ship {kv or 'bf16'}", got, want)
    # the decode replica's second token comes from the shipped (or, for
    # the corrupt ship, replayed) K/V: its logits bit-equal to colocated's
    second = {(i, 1): dec_rows[(drid, 1)] for i, drid in drids.items()
              if (drid, 1) in dec_rows}
    want_second = {(i, 1): want_rows[(rid, 1)]
                   for i, rid in enumerate(sorted(res))
                   if (rid, 1) in want_rows}
    rows_gate(f"ship {kv or 'bf16'}: second-token logits", second,
              want_second, [(i, 1) for i in range(len(requests))])
    for i, r in enumerate(requests):
        pages = -(-len(r["prompt"]) // dec.page_size)
        if shipped[i] != pages * page_wire:
            raise AssertionError(f"request {i} shipped {shipped[i]} bytes "
                                 f"for {pages} pages of {page_wire}")
    counts = dict(da.launches)
    launches = counts.pop(name)
    if any(counts.values()):
        raise AssertionError(f"ship: other decode kernels launched {counts}")
    launch_gate(f"ship {kv or 'bf16'}", launches, seen["decode"],
                cfg.num_layers)
    drained(dec, "decode role")
    moved = dict(pages_shipped=pre.metrics.kv_pages_shipped,
                 pages_revived_remote=dec.metrics.kv_pages_revived_remote)
    del pre, dec
    # planted: request 0's first page shipped with its values one position
    # off their keys (a valid blob), admitted by a fresh decode replica
    blobs, history = first_ship
    bad, _ = build_engine(kv, params=params, role="decode")
    bad_rows = watch_rows(bad)["rows"]
    leaves = list(HostPageStore.payload_from_bytes(blobs[0]))
    value = bad.cache_manager.payload_leaves.index("value")
    leaves[value] = leaves[value].roll(1, dims=1)
    rid = bad.submit(**dict(requests[0], history=history), kv_payloads=[
        HostPageStore.payload_to_bytes(leaves)] + blobs[1:])
    res_bad = bad.drain()[rid]
    must_break(rows_gate, f"ship {kv or 'bf16'}: values one position off",
               {(0, 1): bad_rows.get((rid, 1))},
               {(0, 1): want_second[(0, 1)]}, [(0, 1)],
               label="a shipped page's values one position off")
    del bad
    log("roles", kv_dtype=kv or "bf16", requests=len(requests),
        kernel=name, kernel_launches=launches,
        shipped_bytes=sum(shipped.values()), page_wire_bytes=page_wire,
        **moved,
        export_ms_p50=quantiles(export_ms)[0], export_ms_max=max(export_ms),
        admit_ms_p50=quantiles(admit_ms)[0], admit_ms_max=max(admit_ms),
        ttft_ms_p50_prefill_role=quantiles(
            [r.ttft_s * 1e3 for r in want])[0],
        second_token_ms_p50_colocated=quantiles(second_co)[0] * 1e3,
        second_token_ms_p50_disaggregated=quantiles(second_dec)[0] * 1e3,
        second_token_logits_bit_equal=len(second),
        refusals=refusals, planted_stream_differs=res_bad.tokens.tolist()
        != want[0].tokens.tolist())
    return {name: launches}


def phase_roles(params, cfg) -> dict:
    """Phase 39: prefill/decode roles with the KV shipped as bytes, at bf16
    (B8) and int8 (B10) KV."""
    out = {}
    for kv in (None, "int8"):
        out.update(ship_run(params, cfg, kv,
                            serving_requests(cfg.vocab_size, seed=3)))
    return out


def recovery_requests(vocab: int) -> list:
    """Phase 40's traffic: phase 4's kind (prompts of 32-512 tokens, two
    of the eight sampled) at seed 4, 32 new tokens each."""
    return [dict(r, max_length=32) for r in serving_requests(vocab, seed=4)]


def recovery_run(params, cfg, paged=True, kv=None, plan=None,
                 requests=None, tamper=None, **engine_kw) -> dict:
    """Serve ``requests`` (default :func:`recovery_requests`) on a fresh
    engine (given to ``tamper`` first, when set), under the fault ``plan``
    (its attempt indices counted from this engine's start); record each
    tick's wall time and summary, every sampled logits row, the rows of
    the first tick that decoded after each recovery (``post_keys``), the
    recoveries' replay ms and the launches."""
    engine, _ = build_engine(kv, params=params, paged=paged, **engine_kw)
    if tamper is not None:
        tamper(engine)
    seen = watch_forwards(engine)
    watched = watch_rows(engine)
    spent = {"replay_prefill_ms": [], "catch_up_ms": []}

    def timed(fn, key):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            spent[key].append((time.perf_counter() - t) * 1e3)
            return out
        return run

    engine._replay_prefill = timed(engine._replay_prefill,
                                   "replay_prefill_ms")
    engine._catch_up = timed(engine._catch_up, "catch_up_ms")
    requests = requests or recovery_requests(cfg.vocab_size)
    zero_launches()
    if plan:
        faults.configure(**plan)
    ticks = []
    try:
        for r in requests:
            engine.submit(**r)
        while engine.scheduler.queue_depth or engine._active:
            t = time.perf_counter()
            summary = engine.step()
            torch.cuda.synchronize()
            ticks.append((t, time.perf_counter(), summary))
    finally:
        faults.reset()
    for thread in engine.abandoned:
        thread.join()
    res = engine.drain()
    drained(engine, f"recovery paged={paged} kv={kv}")
    # time to recover: from the start of a faulted tick to the end of the
    # first tick after it that decoded
    recover_ms, post = [], set()
    for j, (t, _, s) in enumerate(ticks):
        if s["recovered"] and (j == 0 or not ticks[j - 1][2]["recovered"]):
            k = next((k for k in range(j + 1, len(ticks))
                      if ticks[k][2]["decoded"]), None)
            if k is not None:
                recover_ms.append((ticks[k][1] - t) * 1e3)
                post.add(k)  # the engine's tick count is the loop's index
    return dict(results=[res[rid] for rid in sorted(res)], engine=engine,
                rows=watched["rows"], post_keys=[
                    key for key, tick in watched["ticks"].items()
                    if tick in post],
                decode_forwards=seen["decode"], launches=dict(da.launches),
                recover_ms=recover_ms, ticks=len(ticks),
                replay_prefill_ms=sum(spent["replay_prefill_ms"]),
                replays=len(spent["replay_prefill_ms"]),
                catch_up_ms=sum(spent["catch_up_ms"]))


def phase_recovery(params, cfg) -> dict:
    """Phase 40: crash recovery, paged and slot (module docstring)."""
    out = {}
    clean = {}
    for paged, kv in ((True, None), (False, None), (True, "int8"),
                      (False, "int8")):
        name = ("paged_decode" if paged else "decode") + ("_q8" if kv else "")
        base = recovery_run(params, cfg, paged, kv)
        run = recovery_run(params, cfg, paged, kv, plan=dict(tick_raise="5"))
        what = f"tick 5 raised, paged={paged} kv={kv or 'bf16'}"
        streams_gate(what, run["results"], base["results"])
        # the first tick after the recovery decodes from replayed K/V
        rows_gate(f"{what}: first tick after the recovery", run["rows"],
                  base["rows"], run["post_keys"])
        if run["engine"].metrics.engine_recoveries != 1:
            raise AssertionError(f"{what}: "
                                 f"{run['engine'].metrics.engine_recoveries} "
                                 "recoveries")
        counts = dict(run["launches"])
        launches = counts.pop(name)
        if any(counts.values()):
            raise AssertionError(f"{what}: other kernels launched {counts}")
        launch_gate(what, launches, run["decode_forwards"], cfg.num_layers)
        out[name] = {"launches_recovery": launches}
        log("recovery", run="tick_raise", paged=paged, kv_dtype=kv or "bf16",
            kernel=name, kernel_launches=launches,
            decode_forwards=run["decode_forwards"],
            time_to_recover_ms=run["recover_ms"],
            replay_prefill_ms=run["replay_prefill_ms"],
            replays=run["replays"], catch_up_ms=run["catch_up_ms"],
            ticks=run["ticks"],
            clean_ticks=base["ticks"], post_recovery_rows=len(
                run["post_keys"]),
            sampled_requests=sum(1 for r in recovery_requests(
                cfg.vocab_size) if r["decode_strategy"] != "greedy"))
        if kv is None:
            clean[paged] = base["results"]
        if paged and kv is None:
            clean["rows"] = base["rows"]
            # planted: every catch-up starts one position late, leaving
            # the first replayed token's K/V unwritten
            def late(engine):
                catch_up = engine._catch_up
                engine._catch_up = lambda replayed: catch_up(
                    [(req, start + 1) for req, start in replayed])

            bad = recovery_run(params, cfg, paged, kv,
                               plan=dict(tick_raise="5"), tamper=late)
            must_break(rows_gate, f"{what}: catch-up one position late",
                       bad["rows"], base["rows"], bad["post_keys"],
                       label="catch-up one position late")
            log("recovery", run="planted_late_catch_up",
                planted_stream_differs=[r.tokens.tolist() for r in
                                        bad["results"]]
                != [r.tokens.tolist() for r in base["results"]])
            del bad
        del base, run
    # a poison request: bisection retires it alone
    run = recovery_run(params, cfg, plan=dict(poison_request="2"))
    res, eng = run["results"], run["engine"]
    if res[2].finish_reason != "error" or eng.metrics.poison_retired != 1:
        raise AssertionError(f"poison: {res[2].finish_reason}, "
                             f"{eng.metrics.poison_retired} retired")
    streams_gate("poison neighbours", res[:2] + res[3:],
                 clean[True][:2] + clean[True][3:])
    launch_gate("poison", run["launches"]["paged_decode"],
                run["decode_forwards"], cfg.num_layers)
    log("recovery", run="poison", probes=eng.probes,
        poison_partial_tokens=len(res[2].tokens),
        recoveries=eng.metrics.engine_recoveries,
        time_to_recover_ms=run["recover_ms"],
        replay_prefill_ms=run["replay_prefill_ms"], replays=run["replays"])
    # a prefill that fails twice: its request is quarantined
    faults.configure(prefill_raise=f"{eng._fault_prefills}+")
    try:
        rid = eng.submit(**serving_requests(cfg.vocab_size, seed=5)[0])
        res = eng.drain(max_ticks=10)
    finally:
        faults.reset()
    if res[rid].finish_reason != "error" or len(res[rid].tokens):
        raise AssertionError(f"prefill poison: {res[rid].finish_reason}")
    log("recovery", run="prefill_raise", quarantined=rid,
        poison_retired=eng.metrics.poison_retired)
    del run, eng
    # a hung tick of ~2 s against a 0.5 s watchdog
    hang = recovery_run(params, cfg, plan=dict(tick_hang="5", tick_hang_s=2.0),
                        tick_timeout_s=0.5)
    eng = hang["engine"]
    if not eng.hang_diagnostics or eng.metrics.engine_recoveries < 1:
        raise AssertionError("the hung tick was not caught")
    streams_gate("hung tick", hang["results"], clean[True])
    rows_gate("hung tick: first tick after the recovery", hang["rows"],
              clean["rows"], hang["post_keys"])
    log("recovery", run="tick_hang", hang_diagnostics=eng.hang_diagnostics,
        time_to_recover_ms=hang["recover_ms"],
        replay_prefill_ms=hang["replay_prefill_ms"],
        zombie_threads=len(eng.abandoned),
        b8_launches=hang["launches"]["paged_decode"],
        decode_forwards=hang["decode_forwards"])
    del hang, eng
    # every tick raises: the budget runs out and the engine reads dead
    engine, _ = build_engine(params=params, paged=False, max_recoveries=2)
    faults.configure(tick_raise="0+")
    try:
        engine.submit(**serving_requests(cfg.vocab_size)[0])
        raised = None
        for _ in range(10):
            try:
                engine.step()
            except RecoveryExhausted as exc:
                raised = exc
                break
    finally:
        faults.reset()
    if raised is None or engine.health()["state"] != "dead":
        raise AssertionError(f"no RecoveryExhausted ({engine.health()})")
    log("recovery", run="exhausted", recoveries=engine.metrics
        .engine_recoveries, health=engine.health()["state"])
    del engine
    # shutdown under load with no grace: partials for every request
    engine, _ = build_engine(params=params)
    rids = [engine.submit(**r) for r in recovery_requests(cfg.vocab_size)]
    for _ in range(3):
        engine.step()
    res = engine.shutdown(grace_s=0.0)
    if (set(res) != set(rids)
            or {r.finish_reason for r in res.values()} != {"shutdown"}
            or any(not len(res[rid].tokens) for rid in rids)):
        raise AssertionError("shutdown: " + str(
            {rid: (r.finish_reason, len(r.tokens)) for rid, r in res.items()}))
    for i, rid in enumerate(rids):
        want = clean[True][i].tokens.tolist()
        if res[rid].tokens.tolist() != want[:len(res[rid].tokens)]:
            raise AssertionError(f"shutdown: request {i}'s partial stream "
                                 "is not its stream's head")
    log("recovery", run="shutdown", partial_tokens=[
        len(res[rid].tokens) for rid in rids], health=engine.health()["state"])
    del engine
    return out


# ----------------------------------------------------------------- phase 41
MESH_MP = 2            # phase 41's mp extent: two ranks share the card
MESH_LAYERS = 3        # phase 41's depth: GPT-345M's 24 cut for time
MESH_FAULT_TICK = 5    # its recovered tick fault


MESH_NEW = 16  # new tokens of phase 41's requests (phase 4's 64)


def mesh_cases(vocab: int) -> dict:
    """Phase 41's traffic by case: (engine switches, requests, the decode
    kernel its single-token forwards launch), each request taking MESH_NEW
    new tokens. The first case serves phase 4's requests, the others its
    first two, but for the chunked case (four of phase 36's, both
    900-token prompts among them) and the spec case (phase 37's first
    four)."""
    base = [dict(r, max_length=min(r["max_length"], MESH_NEW))
            for r in serving_requests(vocab)]
    short = base[:2]
    chunk = [dict(r, max_length=min(r["max_length"], MESH_NEW))
             for i, r in enumerate(chunked_requests(vocab))
             if i in (0, 3, 4, 7)]  # both 900-token prompts
    spec = [dict(r, max_length=min(r["max_length"], MESH_NEW))
            for r in spec_requests(vocab)[:4]]
    return {
        "paged": (dict(), base, "paged_decode"),
        "int8": (dict(kv_dtype="int8", weight_dtype="int8"), short,
                 "paged_decode_q8"),
        "slot": (dict(paged=False), short, "decode"),
        "slot-int8": (dict(paged=False, kv_dtype="int8",
                           weight_dtype="int8"), short, "decode_q8"),
        "chunk": (dict(prefill_chunk=CHUNK), chunk, "paged_decode"),
        "spec": (dict(spec=True, spec_k=SPEC_K), spec, "paged_decode"),
        "fault": (dict(), short, "paged_decode"),
        "fp32": (dict(dtype=torch.float32), short, "paged_decode"),
    }


# the limits of phase 41's logits gates. At bf16: above the sound runs'
# largest first-token gap (0.0493), below the planted faults' smallest
# (0.10, the other rank's head slice). At fp32 the engines' logits differ
# only by the order of fp32 sums. The greedy splits are held at LOGIT_TOL
# (phase 37's gate).
MESH_BF16_TOL = 0.07
MESH_FP32_TOL = 1e-3


def mesh_fault_requests(vocab: int) -> list:
    """The planted faults' traffic: two greedy requests of phase 4's."""
    return [dict(r, max_length=16) for r in serving_requests(vocab)[:2]]


def row_digest(row: torch.Tensor) -> str:
    return hashlib.sha256(row.float().cpu().numpy().tobytes()).hexdigest()


def rows_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max())


def collective_clock() -> dict:
    """Time every collective of this process (the row-parallel
    all-reduces, the embedding's sum, the logits' all-gather, the clock's
    broadcast): the device is synchronised before each, so a reading is
    the collective's own host time. The broadcasts (the clock's) are also
    summed apart, under ``broadcast_ms``."""
    import torch.distributed as tdist

    clock = {"ms": 0.0, "calls": 0, "broadcast_ms": 0.0}
    for name in ("all_reduce", "all_gather_into_tensor", "broadcast"):
        fn = getattr(tdist, name)

        def timed(*a, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _fn(*a, **kw)
            ms = (time.perf_counter() - t) * 1e3
            clock["ms"] += ms
            clock["calls"] += 1
            if _name == "broadcast":
                clock["broadcast_ms"] += ms
            return out

        setattr(tdist, name, timed)
    return clock


def mesh_serve(engine, requests, cfg, kernel, fault_tick=None) -> dict:
    """Serve ``requests`` on one engine (its warm-up first), counting its
    forwards and the decode launches; with ``fault_tick``, the tick fault
    planted on every rank at that tick. Returns streams, first-token
    rows (their digests; the rows themselves on mp rank 0), TTFT and TPOT,
    the cache's bytes and the launch counts."""
    serve(engine, [dict(prompt=np.arange(40), max_length=4)])  # warm-up
    seen = watch_forwards(engine)
    samples = watch_samples(engine)
    zero_launches()
    if fault_tick:
        faults.configure(tick_raise=str(fault_tick))
    try:
        results, ticks, seconds = serve(engine, requests)
    finally:
        faults.reset()
    counts = dict(da.launches)
    launches = counts.pop(kernel)
    drained(engine, f"mesh {kernel}")
    if any(counts.values()):
        raise AssertionError(f"other decode kernels launched: {counts}")
    launch_gate(f"mesh {kernel}", launches, seen["decode"], cfg.num_layers)
    ids = sorted(results)
    rows = samples["rows"]
    sampled = [rid for rid, r in zip(ids, requests)
               if r.get("decode_strategy") == "sampling"]
    return {"tokens": {i: results[i].tokens.tolist() for i in ids},
            "sampled": sampled,
            "rows": {i: rows[i].cpu().numpy() for i in ids},
            "digests": {i: row_digest(rows[i]) for i in ids},
            "gaps": samples["gaps"], "tops": samples["tops"],
            "ticks": ticks, "seconds": seconds,
            "ttft_ms": [results[i].ttft_s * 1e3 for i in ids],
            "tpot_ms": tpot_ms(results), "launches": launches,
            "forwards": seen["decode"],
            "cache_bytes": engine.cache_manager.cache_nbytes(),
            "recoveries": engine.metrics.engine_recoveries,
            "snapshot": engine.metrics.snapshot()}


def mesh_planted(params, cfg, mesh) -> dict:
    """Phase 41's planted faults on one rank, each a short run by name:
    ``"heads"``, this rank holding the other rank's q/k/v head slice;
    ``"allreduce"``, the row-parallel projections' partial sums never
    summed."""
    from fleetx_tpu_torch.models.gpt.convert import shard_params
    from fleetx_tpu_torch.parallel import tensor_parallel as tp

    out = {}
    summed = tp.RowParallelDense.forward
    for fault in ("heads", "allreduce"):
        engine, _ = build_engine(params=params, mesh=mesh,
                                 layers=MESH_LAYERS)
        if fault == "heads":
            other = shard_params(params, dataclasses.replace(
                cfg, mp_degree=MESH_MP), 1 - mesh.mp_rank)
            for n, t in engine.model.state_dict().items():
                if ".qkv_proj." in n:
                    t.copy_(other[n].to(t.dtype))
        else:
            def unsummed(self, x):
                return tp._BiasAdd.apply(
                    torch.nn.functional.linear(x.to(self.dtype),
                                               self.dense_weight()),
                    self.bias)
            tp.RowParallelDense.forward = unsummed
        try:
            out[fault] = mesh_serve(engine, mesh_fault_requests(
                cfg.vocab_size), cfg, "paged_decode")
        finally:
            tp.RowParallelDense.forward = summed
        del engine
    return out


def mesh_config() -> GPTConfig:
    """GPT-345M's serving config cut to MESH_LAYERS layers. Its seed-0
    ``init_params`` are the first MESH_LAYERS layers of the whole
    model's: the draws run in state-dict order, the layers in turn."""
    return dataclasses.replace(serving_config()[0], num_layers=MESH_LAYERS)


def first_layers(params: dict, layers: int) -> dict:
    """``params`` without the decoder layers from ``layers`` on."""
    return {n: t for n, t in params.items()
            if not (n.startswith("gpt.layers.")
                    and int(n.split(".")[2]) >= layers)}


def mesh_rank() -> dict:
    """Phase 41 on one rank of the mp MESH_MP mesh: every case of
    :func:`mesh_cases` through an engine built from the whole GPT-345M
    state dict (``init_params`` seed 0, as the single-card engines), then
    the planted faults (:func:`mesh_planted`, under ``"planted"``)."""
    from fleetx_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(mp=MESH_MP)
    cfg = mesh_config()
    params = init_params(cfg, seed=0)
    clock = collective_clock()
    out = {}
    for name, (kw, requests, kernel) in mesh_cases(cfg.vocab_size).items():
        engine, _ = build_engine(params=params, mesh=mesh,
                                 layers=MESH_LAYERS, **kw)
        clock.update(ms=0.0, calls=0, broadcast_ms=0.0)
        run = mesh_serve(engine, requests, cfg, kernel,
                         MESH_FAULT_TICK if name == "fault" else None)
        run["collective_ms"], run["collective_calls"] = (clock["ms"],
                                                         clock["calls"])
        run["clock_ms"] = clock["broadcast_ms"]
        if mesh.mp_rank:
            run["rows"] = {}  # the digests carry rank 1's rows
        out[name] = run
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    out["planted"] = mesh_planted(params, cfg, mesh)
    return out


def mesh_compare(got: dict, ref: dict) -> dict:
    """A mesh run against the single card's: each greedy request's first
    split ``(request, token, single-card top-2 gap there)`` and each
    sampled one's ``(request, token)`` (a draw parts wherever it falls near
    a boundary of the categorical), the largest first-token logits gap,
    and the largest gap between the two runs' top logits over each
    request's common prefix and its split (the same tokens fed)."""
    splits, sampled_splits, drift = [], [], 0.0
    for rid, want in ref["tokens"].items():
        tokens = got["tokens"][rid]
        n = common_prefix(tokens, want)
        tops = got.get("tops", {}).get(rid, [])
        if len(tops) == len(tokens):  # every token sampled (no verify)
            drift = max([drift] + [abs(a - b) for a, b in zip(
                tops[:n + 1], ref["tops"][rid][:n + 1])])
        if n == len(tokens) == len(want):
            continue
        if rid in ref.get("sampled", ()):
            sampled_splits.append((rid, n))
            continue
        gaps = ref["gaps"][rid]
        splits.append((rid, n, round(gaps[n], 5) if n < len(gaps)
                       else float("inf")))
    first = max(rows_err(row, ref["rows"][rid])
                for rid, row in got["rows"].items()) if got["rows"] else 0.0
    return {"splits": splits, "sampled_splits": sampled_splits,
            "first_token_err": first, "top_drift": drift}


def mesh_streams_gate(what: str, got: dict, ref: dict,
                      tol: float = MESH_BF16_TOL) -> dict:
    """A greedy mesh stream equals the single-card engine's, or parts from
    it only where the single-card top-2 logit gap lies within
    ``min(tol, LOGIT_TOL)``; every first-token logits row, and the top
    logit of every token the two runs share (a sampled stream's split
    included), within ``tol`` of the single card's."""
    report = mesh_compare(got, ref)
    for rid, n, gap in report["splits"]:
        if not gap <= min(tol, LOGIT_TOL):
            raise AssertionError(f"{what}: request {rid} parts at token {n}, "
                                 f"where the single-card top-2 gap is {gap}")
    for key in ("first_token_err", "top_drift"):
        err = report[key]
        if not (math.isfinite(err) and err <= tol):
            raise AssertionError(f"{what}: {key} {err} beyond {tol}")
    return report


def phase_mesh(params, cfg) -> dict:
    """Phase 41: mesh serving at mp MESH_MP, GPT-345M at full width and
    MESH_LAYERS of its 24 layers (the first MESH_LAYERS of ``params``),
    two ranks that share the card over gloo (``mesh_rank``) against
    single-card engines of the same weights and switches: phase 4's
    requests paged at bf16 (B8); int8 KV and int8 weights paged (B10) and
    slot (B9); slot (B7); chunk CHUNK on the two 900-token prompts;
    n-gram spec at k SPEC_K; a tick fault recovered. Gates: each rank's
    streams equal the single card's but where its top-2 gap lies within
    LOGIT_TOL, first-token rows within MESH_BF16_TOL (MESH_FP32_TOL at
    fp32) and bit-equal on the two ranks; each rank's KV bytes in [0.45,
    0.55] of the single card's; the decode kernel launched once per layer
    of each single-token forward on each rank. The collective ms per tick
    and TPOT/TTFT p50 against the single card printed. A rank holding the
    other's head slice, and the row-parallel sums skipped, run after the
    cases in the same ranks, must each break the stream gate."""
    from fleetx_tpu_torch.parallel.launch import spawn

    cfg = dataclasses.replace(cfg, num_layers=MESH_LAYERS)
    params = first_layers(params, MESH_LAYERS)
    refs = {}
    for name, (kw, requests, kernel) in mesh_cases(cfg.vocab_size).items():
        if name == "fault":  # the fault-free run of its traffic: phase 4's
            # first four requests, cut at MESH_NEW tokens
            base = refs["paged"]
            refs[name] = dict(base, tokens={
                i: t[:MESH_NEW] for i, t in base["tokens"].items()
                if i <= len(requests)}, rows={
                i: r for i, r in base["rows"].items() if i <= len(requests)})
            continue
        if name == "spec":  # a spec stream is the plain engine's (phase 37)
            kw = {k: v for k, v in kw.items() if not k.startswith("spec")}
        engine, _ = build_engine(params=params, layers=MESH_LAYERS, **kw)
        refs[name] = mesh_serve(engine, requests, cfg, kernel)
        del engine
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(mesh_rank, MESH_MP, (), timeout=900)
    spawn_s = time.perf_counter() - t0
    out, failed = {}, []
    for name, (kw, _, kernel) in mesh_cases(cfg.vocab_size).items():
        ref = refs[name]
        tol = (MESH_FP32_TOL if kw.get("dtype") is torch.float32
               else MESH_BF16_TOL)
        r0 = ranks[0][name]
        report = mesh_compare(r0, ref)
        log("mesh", case=name, mp=MESH_MP, kernel=kernel,
            requests=len(r0["tokens"]), splits=report["splits"],
            sampled_splits=report["sampled_splits"],
            first_token_logits_max_abs_err=report["first_token_err"],
            top_logit_drift=report["top_drift"], tol=tol,
            launches_per_rank=[r[name]["launches"] for r in ranks],
            forwards_per_rank=[r[name]["forwards"] for r in ranks],
            kv_bytes_per_rank=[r[name]["cache_bytes"] for r in ranks],
            kv_bytes_single=ref["cache_bytes"],
            weight_bytes_per_rank=r0["snapshot"]["weight_bytes"],
            decode_ticks=r0["ticks"],
            collective_ms_per_tick=(r0["collective_ms"] / max(r0["ticks"], 1)),
            collective_calls=r0["collective_calls"],
            clock_broadcast_ms_per_tick=(r0["clock_ms"]
                                         / max(r0["ticks"], 1)),
            ttft_ms_p50=float(np.median(r0["ttft_ms"])),
            ttft_ms_p50_single=float(np.median(ref["ttft_ms"])),
            tpot_ms_p50=quantiles(r0["tpot_ms"])[0],
            tpot_ms_p50_single=quantiles(ref["tpot_ms"])[0],
            recoveries=r0["recoveries"], mesh=r0["snapshot"]["mesh"],
            mesh_devices=r0["snapshot"]["mesh_devices"])
        try:
            mesh_streams_gate(f"mesh {name}", r0, ref, tol)
            for rank, run in enumerate(ranks):
                got = run[name]
                if got["tokens"] != r0["tokens"] or (
                        got["digests"] != r0["digests"]):
                    raise AssertionError(f"mesh {name}: rank {rank} parts "
                                         "from rank 0")
                share = got["cache_bytes"] / ref["cache_bytes"]
                if not 0.45 <= share <= 0.55:
                    raise AssertionError(f"mesh {name}: rank {rank} holds "
                                         f"{share} of the single card's KV")
                if got["recoveries"] != (name == "fault"):
                    raise AssertionError(f"mesh {name}: {got['recoveries']} "
                                         "recoveries")
            if (r0["snapshot"]["mesh"], r0["snapshot"]["mesh_devices"]) != (
                    f"mp{MESH_MP}", MESH_MP):
                raise AssertionError(f"mesh gauges: {r0['snapshot']}")
        except AssertionError as exc:
            failed.append(str(exc))
        out.setdefault(kernel, {})[f"launches_mesh_{name}"] = r0["launches"]
    log("mesh", spawn_seconds=spawn_s)
    # the planted runs serve phase 4's first two requests (ids 1 and 2,
    # after the warm-up's 0) for 16 tokens
    base = refs["paged"]
    fault_ref = {"tokens": {i: base["tokens"][i][:16] for i in (1, 2)},
                 "rows": {i: base["rows"][i] for i in (1, 2)},
                 "gaps": base["gaps"], "tops": base["tops"], "sampled": []}
    for fault, got in ranks[0]["planted"].items():
        must_break(mesh_streams_gate, f"mesh planted {fault}", got,
                   fault_ref, label=fault)
    if failed:
        raise AssertionError("; ".join(failed))
    return out


# ----------------------------------------------------------------- phase 42
INT8_WEIGHT_LOGIT_TOL = 0.25  # first-token logits, int8 against bf16 weights


def int8_weight_requests(vocab: int) -> list:
    """Phase 4's requests, every one greedy."""
    return [dict(r, decode_strategy="greedy")
            for r in serving_requests(vocab)]


def int8_leaves_gate(what: str, state: dict, want: dict) -> None:
    """The engine's int8 values byte-equal, and its scales bit-equal, to
    ``quantize_tree_int8`` of the same weights computed on the host."""
    for name, t in want.items():
        if not (name.endswith("_q8") or name.endswith("_scale")):
            continue
        got = state[name].cpu()
        if got.shape != t.shape or not torch.equal(got, t):
            raise AssertionError(f"{what}: {name} {tuple(got.shape)} is not "
                                 f"the host quantization {tuple(t.shape)}")


def int8_split_gate(what: str, got: dict, ref: dict) -> list:
    """Where an int8-weight greedy stream parts from the bf16-weight
    engine's, the bf16 top-2 logit gap there lies within
    INT8_WEIGHT_LOGIT_TOL, and every first-token row lies within it.
    Returns the gaps at the splits."""
    report = mesh_compare(got, ref)
    for rid, n, gap in report["splits"]:
        if not gap <= INT8_WEIGHT_LOGIT_TOL:
            raise AssertionError(f"{what}: request {rid} parts at token {n} "
                                 f"where the bf16 top-2 gap is {gap}")
    err = report["first_token_err"]
    if not (math.isfinite(err) and err <= INT8_WEIGHT_LOGIT_TOL):
        raise AssertionError(f"{what}: first-token logits differ by {err}")
    return [gap for _, _, gap in report["splits"]]


def phase_int8_weights(params, cfg) -> dict:
    """Phase 42: int8 weights on the single card, paged at bf16 KV (B8)
    and int8 KV (B10) and slot (B7), each against the same engine at bf16
    weights on phase 4's requests made greedy: the engine's int8 leaves
    equal the host's ``quantize_tree_int8`` of the same weights (values
    byte for byte, scales bit for bit), the weight bytes equal the int8
    values plus fp32 scales plus the float rest from the shapes, a stream
    parts from the bf16-weight one only where the bf16 top-2 gap lies
    within INT8_WEIGHT_LOGIT_TOL and every first-token row within it; each
    stream's ``quant_parity_frac`` and TPOT against bf16 weights logged.
    A served paged engine whose scales are loaded with their channels
    reversed (row ``r`` dequantized with channel ``C - 1 - r``'s scale,
    the word and position tables along their hidden axis) must break the
    split-and-logits gate against the bf16-weight engine, and the leaves
    gate."""
    from fleetx_tpu_torch.ops import quant as q8

    requests = int8_weight_requests(cfg.vocab_size)
    host = {k: v.cpu() for k, v in params.items()}
    want = q8.quantize_tree_int8(host, cfg.head_dim)
    out, bf16_paged = {}, None
    for label, kw, kernel in (("paged", dict(), "paged_decode"),
                              ("paged-int8kv", dict(kv_dtype="int8"),
                               "paged_decode_q8"),
                              ("slot", dict(paged=False), "decode")):
        runs = {}
        for wd in ("bf16", "int8"):
            engine, _ = build_engine(params=params, weight_dtype=wd, **kw)
            runs[wd] = mesh_serve(engine, requests, cfg, kernel)
            runs[wd]["weight_bytes"] = engine.weight_nbytes()
            if wd == "int8":
                state = {k: v.detach() for k, v in
                         engine.model.state_dict().items()}
            del engine
        int8_leaves_gate(f"int8 weights {label}", state, want)
        by_shape = sum(int(np.prod(t.shape)) * (
            1 if n.endswith("_q8") else 4 if n.endswith("_scale")
            else t.element_size()) for n, t in state.items())
        got = runs["int8"]
        if not (got["weight_bytes"] == by_shape
                == got["snapshot"]["weight_bytes"]):
            raise AssertionError(f"int8 weights {label}: "
                                 f"{got['weight_bytes']} bytes, shapes give "
                                 f"{by_shape}")
        ref = runs["bf16"]
        splits = int8_split_gate(f"int8 weights {label}", got, ref)
        fracs = [quant_parity_frac(got["tokens"][i], ref["tokens"][i])
                 for i in sorted(got["tokens"])]
        errs = [rows_err(got["rows"][i], ref["rows"][i])
                for i in sorted(got["rows"])]
        log("int8-weights", case=label, kernel=kernel,
            weight_bytes=got["weight_bytes"],
            weight_bytes_bf16=ref["weight_bytes"],
            quant_parity_frac=[round(f, 3) for f in fracs],
            quant_parity_frac_mean=float(np.mean(fracs)),
            quant_budget=1 - QUANT_PREFIX_BUDGET, split_gaps=splits,
            first_token_logits_max_abs_err=max(errs),
            tol=INT8_WEIGHT_LOGIT_TOL,
            tpot_ms_p50=quantiles(got["tpot_ms"])[0],
            tpot_ms_p50_bf16=quantiles(ref["tpot_ms"])[0],
            launches=got["launches"], forwards=got["forwards"])
        out.setdefault(kernel, {})["launches_int8_weights"] = got["launches"]
        bf16_paged = bf16_paged or ref
        del runs
    engine, _ = build_engine(params=params, weight_dtype="int8")
    with torch.no_grad():
        for name, t in engine.model.state_dict().items():
            if name.endswith("_scale"):  # [C, 1] or a table's [1, E]
                t.copy_(t.flip(0 if t.shape[0] > 1 else 1))
    state = {k: v.detach() for k, v in engine.model.state_dict().items()}
    wrong = mesh_serve(engine, requests, cfg, "paged_decode")
    del engine
    label = "channel scales reversed"
    report = mesh_compare(wrong, bf16_paged)
    log("int8-weights", planted_fault=label,
        first_token_logits_max_abs_err=report["first_token_err"],
        splits=report["splits"], tol=INT8_WEIGHT_LOGIT_TOL)
    must_break(int8_split_gate, "int8 weights, scales reversed", wrong,
               bf16_paged, label=label)
    must_break(int8_leaves_gate, "int8 weights, scales reversed", state,
               want, label=label)
    return out


# ----------------------------------------------------------------- phase 43
OBS_LOG_EVERY = 4


def scrape(url: str) -> tuple:
    """``(status, body)`` of a GET, the status of an HTTP error too."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def engine_counters(text: str, engine: str) -> dict:
    """The ``fleetx_serving_*_total`` counters of ``engine`` in a
    Prometheus text, by name (``retired_total`` by reason)."""
    out = {}
    for line in text.splitlines():
        if not line.startswith("fleetx_serving_") or "_total{" not in line:
            continue
        head, value = line.rsplit(" ", 1)
        name, _, labels = head.partition("{")
        lab = dict(p.split("=", 1) for p in labels.rstrip("}").split(","))
        if lab.pop("engine") != f'"{engine}"':
            continue
        key = name if not lab else f"{name}:{lab['reason'].strip(chr(34))}"
        out[key] = float(value)
    return out


def counters_gate(what: str, counters: dict, snap: dict) -> None:
    want = {"fleetx_serving_submitted_total": snap["submitted"],
            "fleetx_serving_admitted_total": snap["admitted"],
            "fleetx_serving_tokens_total": snap["tokens_generated"],
            "fleetx_serving_ticks_total": snap["ticks"],
            "fleetx_serving_prefix_hits_total": snap["prefix_hits"]}
    want.update({f"fleetx_serving_retired_total:{r}": n
                 for r, n in snap["finish_reasons"].items()})
    bad = {k: (counters.get(k), v) for k, v in want.items()
           if counters.get(k) != v}
    if bad:
        raise AssertionError(f"{what}: /metrics against snapshot(): {bad}")


def phase_obs(params, cfg) -> dict:
    """Phase 43: a live engine under ``FLEETX_OBS_PORT=0`` (the exposition
    server on an ephemeral port) with ``log_every`` OBS_LOG_EVERY serves
    phase 4's requests; ``/metrics`` and ``/healthz`` are scraped over
    HTTP in the middle of the drain and after it: the counters equal
    ``snapshot()`` each time, ``/healthz`` reads 200 and then 503
    (``draining``) on ``request_shutdown``, and the snapshot line is
    written on every OBS_LOG_EVERY-th tick. Counters read one tick late
    must break the counter gate."""
    from fleetx_tpu_torch.obs import http as obs_http

    os.environ["FLEETX_OBS_PORT"] = "0"
    try:
        engine, _ = build_engine(params=params, log_every=OBS_LOG_EVERY)
    finally:
        os.environ.pop("FLEETX_OBS_PORT", None)
    server = obs_http.get_server()
    if server is None:
        raise AssertionError("FLEETX_OBS_PORT=0 started no server")
    log("obs", url=server.url, log_every=OBS_LOG_EVERY)
    label = engine.metrics.engine_label
    lines = []
    log_snapshot = engine.metrics.log_snapshot
    engine.metrics.log_snapshot = lambda: (lines.append(engine._ticks),
                                           log_snapshot())
    for r in serving_requests(cfg.vocab_size):
        engine.submit(**r)
    readings = []
    t0 = time.perf_counter()
    while engine.scheduler.queue_depth or engine.cache_manager.active_count:
        engine.step()
        if engine._ticks in (8, 40):  # during the drain
            status, text = scrape(server.url + "/metrics")
            readings.append((status, engine_counters(text, label),
                             engine.metrics.snapshot()))
            if engine._ticks == 8:
                health = scrape(server.url + "/healthz")
    seconds = time.perf_counter() - t0
    engine.drain()
    status, text = scrape(server.url + "/metrics")
    readings.append((status, engine_counters(text, label),
                     engine.metrics.snapshot()))
    for i, (status, counters, snap) in enumerate(readings):
        if status != 200:
            raise AssertionError(f"/metrics answered {status}")
        counters_gate(f"scrape {i}", counters, snap)
    stale = dict(readings[0][2], ticks=readings[0][2]["ticks"] + 1)
    must_break(counters_gate, "scrape read a tick late", readings[0][1],
               stale, label="counters one tick late")
    engine.request_shutdown(grace_s=0.0)
    after = scrape(server.url + "/healthz")
    engine.shutdown(grace_s=0.0)
    ticks = engine.metrics.snapshot()["ticks"]
    body = json.loads(after[1])
    log("obs", scrapes=len(readings),
        metrics_bytes=len(text), healthz_during=health[0],
        healthz_after_shutdown=after[0], state=body.get("state"),
        ticks=ticks, log_lines=len(lines), seconds=seconds)
    if health[0] != 200 or after[0] != 503 or body.get("state") != "draining":
        raise AssertionError(f"/healthz: {health[0]} then {after[0]} {body}")
    if lines != list(range(OBS_LOG_EVERY, ticks + 1, OBS_LOG_EVERY)):
        raise AssertionError(f"log_snapshot at ticks {lines} of {ticks}")
    del engine
    gc.collect()  # the server stays up: a later phase's trainer reads it
    return {"ticks": ticks}


# ----------------------------------------------------------------- phase 44

FLEET_NEW = 32       # phase 44's new tokens a request (phase 4's 64)
FLEET_KILL_AT = 8    # request 0's streamed tokens when a replica is killed
FLEET_GRACE_S = 30.0
# the prefix trie off in phase 44's engines: a shared page's K/V bytes are
# those of the prompt that first computed it (its prefill call's shape),
# and which replica, and which request first, gets phase 4's shared
# prefix depends on the dispatch; with the trie on, a greedy stream can
# part from the reference's at a near-tie (probe P1, PR 18)
FLEET_ENGINE = dict(prefix_cache=False)
FLEET_TRACE = dict(seed=44, n_requests=32, arrival_rate=16.0)
# how a phase-44 replica process starts: a fresh interpreter (never a fork
# of this process, which holds a CUDA context) running fleet_replica
FLEET_REPLICA_ARGV = [sys.executable, "-c",
                      "import sys, chip_smoke; "
                      "sys.exit(chip_smoke.fleet_replica(sys.argv[1:]))"]


def fleet_params(cfg) -> dict:
    """Seed-0 weights drawn on the CPU (one torch.Generator) and moved to
    the card: every replica process and the in-process reference hold the
    same bits."""
    return {k: v.to("cuda")
            for k, v in init_params(cfg, seed=0, device="cpu").items()}


def fleet_engine(device_index: int = 0, device=None):
    """Phase 44's engine (phase 4's: GPT-345M, 8 lanes of 1024 positions,
    pages of 16, bf16; FLEET_ENGINE's prefix trie off) over
    :func:`fleet_params`, on ``cuda:{index % count}`` (``tools/serve``'s
    placement)."""
    from fleetx_tpu_torch.tools.serve import _replica_device

    dev = _replica_device(device_index, device)
    cfg, _ = serving_config()
    params = {k: v.to(dev) for k, v in fleet_params(cfg).items()}
    engine, _ = build_engine(params=params, device=dev, **FLEET_ENGINE)
    return engine


def fleet_replica(argv) -> int:
    """A phase-44 replica process (``argv``: index, port file, counts
    file): ``tools/serve``'s worker over :func:`fleet_engine`; at its
    drain it writes the decode kernels' launches and its decode forwards
    to the counts file."""
    import argparse

    from fleetx_tpu_torch.tools import serve as fleet_serve

    index, port_file, counts_file = int(argv[0]), argv[1], argv[2]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    watched = {}

    def build(device_index, device=None):
        engine = fleet_engine(device_index, device)
        watched.update(seen=watch_forwards(engine))
        zero_launches()  # the replica's path starts here
        return engine

    def on_drained(engine):
        torch.cuda.synchronize()
        with open(counts_file + ".tmp", "w") as f:
            json.dump({"launches": dict(da.launches),
                       "decode_forwards": watched["seen"]["decode"],
                       "prefill_forwards": watched["seen"]["prefill"],
                       "layers": engine.model.cfg.num_layers,
                       "pages_in_use": engine.cache_manager.pages_in_use},
                      f)
        os.replace(counts_file + ".tmp", counts_file)

    args = argparse.Namespace(device_index=index, port_file=port_file,
                              grace_s=FLEET_GRACE_S, rpc_port=0, device=None)
    return fleet_serve.run_replica_worker(args, build=build,
                                          on_drained=on_drained)


def start_fleet_replica(index: int, where: str) -> tuple:
    """Start replica ``index`` (its port and counts files under
    ``where``); returns ``(process, port file, counts file)``."""
    port_file = os.path.join(where, f"replica_{index}.port")
    counts = os.path.join(where, f"replica_{index}.counts.json")
    proc = subprocess.Popen(FLEET_REPLICA_ARGV
                            + [str(index), port_file, counts], cwd=ROOT)
    return proc, port_file, counts


def fleet_http_kw(request: dict) -> tuple:
    """A phase-4 request as the OpenAI body fields the front door maps
    onto engine kwargs, and those engine kwargs (the reference submits
    them): temperature 0 is greedy (the yaml's default strategy samples),
    a sampled request keeps its top-k, top-p and seed."""
    if request["decode_strategy"] == "greedy":
        body = {"temperature": 0}
        kw = {"decode_strategy": "greedy"}
    else:
        body = {"temperature": 1.0, "top_k": request["top_k"],
                "top_p": request["top_p"], "seed": request["seed"]}
        kw = {"decode_strategy": "sampling", "temperature": 1.0,
              "top_k": request["top_k"], "top_p": request["top_p"],
              "seed": request["seed"]}
    return dict(body, max_tokens=FLEET_NEW), dict(kw, max_length=FLEET_NEW)


def fleet_http(url: str, i: int, request: dict, on_chunk=None) -> dict:
    """Request ``i`` over HTTP: even ones to ``/v1/chat/completions``, odd
    ones to ``/v1/completions``; 0, 1, 4 and 5 stream (SSE), the others
    aggregate. Returns the tokens, the router's id, the finish reason and
    the client-side token times; ``on_chunk(i, result so far)`` runs after
    each streamed token."""
    import urllib.request

    body, _ = fleet_http_kw(request)
    text = " ".join(str(int(t)) for t in request["prompt"])
    chat = i % 2 == 0
    stream = i % 4 < 2
    if chat:
        body["messages"] = [{"role": "user", "content": text}]
    else:
        body["prompt"] = text
    body["stream"] = stream
    path = "/v1/chat/completions" if chat else "/v1/completions"
    req = urllib.request.Request(url + path, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    t0 = time.perf_counter()
    out = {"tokens": [], "times": [], "sent": t0, "stream": stream}
    with urllib.request.urlopen(req, timeout=300) as resp:
        if not stream:
            payload = json.loads(resp.read())
            out.update(tokens=payload["tokens"],
                       rid=int(payload["id"].split("-")[1]),
                       finish=payload["choices"][0]["finish_reason"],
                       times=[time.perf_counter()])
            return out
        for line in resp:
            line = line.decode().strip()
            if not line.startswith("data: ") or line[6:] == "[DONE]":
                continue
            chunk = json.loads(line[6:])
            out["rid"] = int(chunk["id"].split("-")[1])
            if "token" in chunk:
                out["tokens"].append(chunk["token"])
                out["times"].append(time.perf_counter())
                if on_chunk is not None:
                    on_chunk(i, out)
            out["finish"] = chunk["choices"][0]["finish_reason"] or out.get(
                "finish")
    return out


def fleet_pass(url: str, requests: list, on_chunk=None) -> list:
    """The requests at once over HTTP, one client thread each; results in
    request order."""
    with concurrent.futures.ThreadPoolExecutor(len(requests)) as pool:
        futures = [pool.submit(fleet_http, url, i, r, on_chunk)
                   for i, r in enumerate(requests)]
        return [f.result() for f in futures]


def token_streams_gate(what: str, got: list, want: list) -> None:
    """Each request's streamed tokens byte-equal to the reference's, none
    lost, repeated or reordered."""
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if list(a) != list(b)]
    if bad or len(got) != len(want):
        raise AssertionError(f"{what}: the streams of requests {bad} differ "
                             f"({len(got)} against {len(want)})")


def http_latency(results: list) -> dict:
    """TTFT and TPOT p50 at the HTTP client, over the streamed requests."""
    ttft = [(r["times"][0] - r["sent"]) * 1e3 for r in results
            if r["stream"] and r["times"]]
    tpot = [(r["times"][-1] - r["times"][0]) / (len(r["times"]) - 1) * 1e3
            for r in results if r["stream"] and len(r["times"]) > 1]
    return {"ttft_ms_p50": quantiles(ttft)[0],
            "tpot_ms_p50": quantiles(tpot)[0]}


def count_rpcs():
    """Count and time the replica RPCs this process makes (the clients
    call ``wire.rpc_call``): ``{method: [calls, seconds]}`` and the
    undo."""
    from fleetx_tpu_torch.serving.api import wire

    counts = {}
    call = wire.rpc_call

    def counted(url, payload=None, **kw):
        t0 = time.perf_counter()
        try:
            return call(url, payload, **kw)
        finally:
            entry = counts.setdefault(kw.get("method", "rpc"), [0, 0.0])
            entry[0] += 1
            entry[1] += time.perf_counter() - t0

    wire.rpc_call = counted
    return counts, lambda: setattr(wire, "rpc_call", call)


def planted_fleet_run(params, requests, kws, plant) -> list:
    """Phase 44's kill through two in-process replica servers on the card
    (the same router, RPC and engine code): ``plant(router, servers)``
    breaks one piece first; returns each request's streamed tokens."""
    from fleetx_tpu_torch.serving import ServingRouter
    from fleetx_tpu_torch.serving.api.replica_client import ReplicaClient
    from fleetx_tpu_torch.serving.api.replica_server import ReplicaServer

    servers = [ReplicaServer(build_engine(params=params,
                                          **FLEET_ENGINE)[0]).start()
               for _ in range(2)]
    try:
        router = ServingRouter([ReplicaClient(s.url, timeout_s=60)
                                for s in servers], probe_every=1)
        plant(router, servers)
        streams = {}
        rids = [router.submit(r["prompt"], on_token=lambda rid, t, f:
                              streams.setdefault(rid, []).append(int(t)),
                              **kw) for r, kw in zip(requests, kws)]
        while (len(streams.get(rids[0], [])) < FLEET_KILL_AT
               and router.result(rids[0]) is None):
            router.step()
        servers[router._requests[rids[0]].replica].stop()
        router.drain(max_ticks=2000)
        return [streams.get(rid, []) for rid in rids]
    finally:
        for s in servers:
            with contextlib.suppress(Exception):
                s.stop()


def history_dropped(router, servers) -> None:
    """Planted: the router forgets a migrated request's history, so the
    survivor starts it again (``submit`` without ``history``)."""
    requeue = router._requeue_head

    def forgetful(reqs):
        for req in reqs:
            req.tokens = []
        requeue(reqs)

    router._requeue_head = forgetful


def replay_one_late(router, servers) -> None:
    """Planted: each replica replays a migrated history one token short,
    so it emits that history's last token again."""
    for server in servers:
        submit = server.engine.submit

        def late(prompt, *, history=None, _submit=submit, **kw):
            return _submit(prompt, history=(list(history)[:-1]
                                            if history else history), **kw)

        server.engine.submit = late


def phase_fleet(cfg) -> dict:
    """Phase 44: two replica processes on the card serve GPT-345M through
    ``tools/serve``'s worker; the front door (a ``ServingRouter`` over two
    ``ReplicaClient``s and an ``ApiServer`` on port 0) runs here. Phase
    4's requests (32 new tokens) over HTTP, half SSE, to both routes: the
    streams equal an in-process engine's of the same bits; again with one
    replica SIGKILLed mid-stream (no token lost or repeated, a migration
    and a dead replica recorded); a replacement replica joins, a seeded
    32-request Poisson trace runs through ``run_trace`` (goodput logged);
    the SIGTERM drain fan-out ends both surviving processes with exit 0,
    and each launched B8 once per layer of each decode forward. Planted:
    a router that migrates without the history and a replica that
    replays one token late must each break the stream gate."""
    from fleetx_tpu_torch.obs import get_event_log
    from fleetx_tpu_torch.serving import (
        ServingRouter,
        TenantSpec,
        WorkloadSpec,
        generate_trace,
        run_trace,
        score_goodput,
        trace_hash,
    )
    from fleetx_tpu_torch.serving.api.replica_client import ReplicaClient
    from fleetx_tpu_torch.serving.api.server import ApiServer
    from fleetx_tpu_torch.tools.serve import stop_replicas, wait_for_port

    where = tempfile.mkdtemp(prefix="fleet-")
    procs = {}
    t_start = time.perf_counter()
    for i in range(2):  # both start now, while the reference runs here
        procs[i] = start_fleet_replica(i, where)
    requests = serving_requests(cfg.vocab_size)
    kws = [fleet_http_kw(r)[1] for r in requests]
    params = fleet_params(cfg)
    reference, _ = build_engine(params=params, **FLEET_ENGINE)
    serve(reference, [dict(prompt=np.arange(40), max_length=4)])  # warm-up
    results, ticks, seconds = serve(reference, [
        dict(kw, prompt=r["prompt"]) for r, kw in zip(requests, kws)])
    want = [results[rid].tokens.tolist() for rid in sorted(results)]
    in_process = [results[rid] for rid in sorted(results)]
    log("fleet", reference_ttft_ms_p50=quantiles(
        [r.ttft_s * 1e3 for r in in_process])[0],
        reference_tpot_ms_p50=quantiles(tpot_ms(results))[0],
        reference_seconds=seconds, decode_ticks=ticks)
    del reference
    deadline = time.monotonic() + 300
    urls = [wait_for_port(procs[i][0], procs[i][1], i, deadline)
            for i in range(2)]
    start_s = time.perf_counter() - t_start
    clients = [ReplicaClient(u, timeout_s=60, connect_wait_s=30)
               for u in urls]
    router = ServingRouter(clients, probe_every=1)
    api = ApiServer(router, model_id="gpt-345m").start()
    token_times = {}
    make_cb = router._make_cb

    def timed_cb(req):
        cb = make_cb(req)

        def inner(erid, tok, finished):
            token_times.setdefault(req.rid, []).append(time.perf_counter())
            cb(erid, tok, finished)
        return inner

    router._make_cb = timed_cb
    rpcs, undo_rpcs = count_rpcs()
    try:
        fleet_pass(api.url, requests[:2])  # each replica's first requests
        # pass 1: clean
        rpcs.clear()
        ticks0 = router._ticks
        t0 = time.perf_counter()
        clean = fleet_pass(api.url, requests)
        ticks = max(router._ticks - ticks0, 1)
        pass_s = time.perf_counter() - t0
        rpc_per_tick = sum(n for n, _ in rpcs.values()) / ticks
        token_streams_gate("fleet", [r["tokens"] for r in clean], want)
        finishes = [r["finish"] for r in clean]
        if set(finishes) - {"length", "stop"}:
            raise AssertionError(f"fleet: finished {finishes}")
        latency = http_latency(clean)
        log("fleet", replicas=2, start_s=start_s, requests=len(clean),
            router_ticks=ticks, tick_ms=pass_s / ticks * 1e3,
            rpc_calls_per_tick=rpc_per_tick,
            rpc_ms_per_tick={m: t / ticks * 1e3 for m, (_, t) in
                             rpcs.items()},
            rpc_ms_per_call={m: t / n * 1e3 for m, (n, t) in rpcs.items()},
            http_ttft_ms_p50=latency["ttft_ms_p50"],
            http_tpot_ms_p50=latency["tpot_ms_p50"])
        # pass 2: a replica process SIGKILLed mid-stream
        get_event_log().clear()
        token_times.clear()
        killed = {}

        def kill_at(i, out):
            # SIGKILL the process decoding request 0 (an SSE chat stream)
            if i == 0 and len(out["tokens"]) == FLEET_KILL_AT:
                with api._lock:
                    index = router._requests[out["rid"]].replica
                procs[index][0].kill()
                killed.update(index=index, at=time.perf_counter())

        failover = fleet_pass(api.url, requests, on_chunk=kill_at)
        if not killed:
            raise AssertionError("fleet: request 0 finished before the kill")
        token_streams_gate("fleet after the kill",
                           [r["tokens"] for r in failover], want)
        snap = router.metrics.snapshot()
        migrated = sorted({e.attrs["request"] for e in
                           get_event_log().find("request_migrated")})
        after = [t for rid in migrated for t in token_times.get(rid, [])
                 if t > killed["at"]]
        if snap["migrated"] < 1 or snap["replica_deaths"] < 1:
            raise AssertionError(f"fleet: migrated {snap['migrated']}, "
                                 f"deaths {snap['replica_deaths']}")
        procs[killed["index"]][0].wait()
        log("fleet", killed_replica=killed["index"],
            killed_at_token=FLEET_KILL_AT, migrated=snap["migrated"],
            replica_deaths=snap["replica_deaths"],
            migrated_requests=len(migrated),
            kill_to_first_migrated_token_ms=(min(after) - killed["at"]) * 1e3
            if after else None, states=router.replica_states,
            streams_equal=len(failover))
        # a replacement replica joins, then a seeded Poisson trace
        t0 = time.perf_counter()
        procs[2] = start_fleet_replica(2, where)
        url = wait_for_port(procs[2][0], procs[2][1], 2,
                            time.monotonic() + 300)
        with api._lock:
            router.add_replica(ReplicaClient(url, timeout_s=60,
                                             connect_wait_s=30))
        join_s = time.perf_counter() - t0
        spec = WorkloadSpec(vocab=cfg.vocab_size, tenants=(TenantSpec(
            "chat", prompt_len=(32, 512), gen_len=(16, FLEET_NEW),
            ttft_deadline_s=1.0, tpot_deadline_ms=100.0),), **FLEET_TRACE)
        trace = generate_trace(spec)
        with api._lock:  # no driver tick interleaves the trace's
            outcomes = run_trace(router, trace)
        score = score_goodput(outcomes)
        log("fleet", trace=trace_hash(trace), join_s=join_s,
            goodput=score["goodput"], finish_reasons=score["finish_reasons"],
            ttft_ms_p50=score["ttft_ms_p50"], ttft_ms_p99=score["ttft_ms_p99"],
            tpot_ms_p50=score["tpot_ms_p50"], tpot_ms_p99=score["tpot_ms_p99"])
        if score["completed_frac"] != 1.0:
            raise AssertionError(f"fleet: the trace lost requests: {score}")
        # the SIGTERM drain fan-out
        with api._lock:
            router.shutdown(FLEET_GRACE_S)
    finally:
        undo_rpcs()
        api.stop()
    survivors = [i for i in procs if i != killed.get("index")]
    codes = stop_replicas([procs[i][0] for i in survivors], FLEET_GRACE_S)
    if codes != [0] * len(survivors):
        raise AssertionError(f"fleet: replicas {survivors} exited {codes}")
    launches = 0
    for i in survivors:
        with open(procs[i][2]) as f:
            counts = json.load(f)
        name_counts = dict(counts["launches"])
        b8 = name_counts.pop("paged_decode")
        if any(name_counts.values()):
            raise AssertionError(f"replica {i}: other decode kernels "
                                 f"launched {name_counts}")
        launch_gate(f"fleet replica {i}", b8, counts["decode_forwards"],
                    counts["layers"])
        if counts["pages_in_use"]:
            raise AssertionError(f"replica {i}: {counts['pages_in_use']} "
                                 "pages held after its drain")
        launches += b8
        log("fleet", replica=i, exit_code=0, kernel="paged_decode",
            kernel_launches=b8, decode_forwards=counts["decode_forwards"],
            prefill_forwards=counts["prefill_forwards"])
    shutil.rmtree(where, ignore_errors=True)
    # planted: each must break the stream gate
    for label, plant in (("a router migrating without the history",
                          history_dropped),
                         ("a replica replaying one token late",
                          replay_one_late)):
        got = planted_fleet_run(params, requests, kws, plant)
        must_break(token_streams_gate, f"planted: {label}", got, want,
                   label=label)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"paged_decode": launches}


# ----------------------------------------------------------------- phase 45

SERVE_CLI_ARGV = [sys.executable, "-m", "fleetx_tpu_torch.tools.serve",
                  "--demo", "--replicas", "2", "--port", "0", "--grace-s",
                  "10"]

def phase_serve_cli() -> None:
    """Phase 45: ``python -m fleetx_tpu_torch.tools.serve --demo
    --replicas 2 --port 0`` on the card: one streamed chat completion
    equals the demo engine's greedy stream in process, and SIGTERM ends
    the launcher with exit 0 and no process of it left."""
    import urllib.request

    from fleetx_tpu_torch.tools.serve import _build_demo_engine

    where = tempfile.mkdtemp(prefix="serve-cli-")
    port_file = os.path.join(where, "api.port")
    t0 = time.perf_counter()
    proc = subprocess.Popen(SERVE_CLI_ARGV + ["--api-port-file", port_file],
                            cwd=ROOT)
    demo = _build_demo_engine(0)
    rid = demo.submit([1, 2, 3], max_length=20)
    want = demo.drain()[rid].tokens.tolist()
    del demo
    deadline = time.monotonic() + 300
    while not os.path.exists(port_file):
        if proc.poll() is not None:
            raise AssertionError(f"serve exited {proc.returncode} before "
                                 "serving")
        if time.monotonic() > deadline:
            raise AssertionError("serve never published its API port")
        time.sleep(0.1)
    up_s = time.perf_counter() - t0
    with open(port_file) as f:
        url = f"http://127.0.0.1:{int(f.read())}"
    below = {pid: cmd for pid, cmd in descendants().items()
             if "fleetx_tpu_torch.tools.serve" in cmd}
    body = {"stream": True, "max_tokens": 20,
            "messages": [{"role": "user", "content": "1 2 3"}]}
    req = urllib.request.Request(url + "/v1/chat/completions",
                                 json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    got = []
    with urllib.request.urlopen(req, timeout=120) as resp:
        for line in resp:
            line = line.decode().strip()
            if line.startswith("data: {"):
                chunk = json.loads(line[6:])
                if "token" in chunk:
                    got.append(chunk["token"])
    token_streams_gate("serve-cli", [got], [want])
    proc.send_signal(signal.SIGTERM)
    code = proc.wait(timeout=120)
    time.sleep(0.5)
    reap()
    left = {pid: cmd for pid, cmd in descendants().items() if pid in below}
    log("serve-cli", processes=len(below), up_s=up_s, tokens=len(got),
        exit_code=code, left=left)
    if code != 0 or left or len(below) != 3:
        raise AssertionError(f"serve-cli: exit {code}, {len(below)} "
                             f"processes, left {left}")
    shutil.rmtree(where, ignore_errors=True)


# --------------------------------------------------------------- phase 46-48

ERNIE_CONFIG = os.path.join(ROOT, "configs/nlp/ernie/pretrain_ernie_base.yaml")
VIT_CONFIG = os.path.join(ROOT, "configs/vis/vit/vit_base_patch16_224.yaml")
# B1's encoder mode, non-causal with per-row key lengths: (batch, sequence,
# kv_lens) at ERNIE-base's 512-position bucket (rows past, on and below a
# 64-key tile border, one key, a filler row) and at ViT-B/16's 197 tokens
# padded to the tile; 12 heads of 64, bf16
ENCODER_FLASH = {"ernie": (8, 512, [512, 300, 129, 65, 64, 17, 1, 0]),
                 "vit": (8, 256, [197] * 8)}
ENCODER_HEADS = 12
# phase 47: ViT embeddings, kernel path against the plain path and across
# batch makeup: |a - b|_2 / |b|_2 per vector (bf16 features after 12
# layers, where a one-ulp change of an attention output carries on)
VIT_EMB_TOL = 2e-2
VIT_IMAGES = 12      # phase 47's images (ticks of 8 and 4 at 8 slots)
# the timed windows of phases 46 and 47: enough requests for seconds of
# host clock at the cells' own traffic (ERNIE: ernie_requests' length mix
# drawn again; ViT: VIT_POOL seeded images in turn), all submitted at once
ERNIE_WINDOW = 2048
VIT_WINDOW = 1024
VIT_POOL = 64
HETERO_NEW = 16      # phase 48's new GPT tokens a request (phase 4's 64)


def encoder_model(path: str) -> dict:
    """The ``Model`` section of a config file through the port's
    ``get_config``, with the compute dtype its ``Engine`` section gives."""
    from fleetx_tpu_torch.models.language_module import resolve_compute_dtype

    conf = get_config(path, nranks=1)
    return dict(conf.Model, dtype=resolve_compute_dtype(conf.Engine))


def ernie_config():
    """ERNIE-base (hidden 768, 12 layers, 12 heads of 64, vocab 40000, 512
    positions, bf16) from its config file."""
    from fleetx_tpu_torch.models.ernie.model import ErnieConfig

    return ErnieConfig.from_model_config(encoder_model(ERNIE_CONFIG))


def vit_config(num_classes=None):
    """ViT-B/16 at 224 (the config file's ``ViT_base_patch16_224``, 1000
    classes, bf16); ``num_classes`` 0 is its embedding mode."""
    from fleetx_tpu_torch.models.vision.vit import ViTConfig

    model = encoder_model(VIT_CONFIG)
    if num_classes is not None:
        model["num_classes"] = num_classes
    return ViTConfig.from_model_config(model)


def encoder_bound(b: int, s: int, h: int, d: int, lens, nbytes_el: int):
    """(bytes, flops) of one B1 call in the encoders' mode: q read once and
    out and the fp32 lse written once, all s rows; k and v read once over
    each row's kv_lens[b] live keys only; two products (q·kᵀ and p·v) of
    2·d flops over the s × kv_lens[b] live (query, key) pairs of each row,
    the pairs this run's key lengths leave."""
    live = sum(int(n) for n in lens)
    rows = b * s * h * d * nbytes_el
    return (2 * rows + 2 * live * h * d * nbytes_el + b * h * s * 4,
            2 * 2 * h * d * s * live)


def library_masked_ms(sets, kv) -> float:
    """SDPA on the same masked function as a yardstick (never used by the
    port): each set's q, k, v pre-transposed to [b, h, s, d], the key
    lengths as a boolean key mask, dropout 0, non-causal."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    s = sets[0][0].shape[1]
    mask = (torch.arange(s, device=kv.device)[None] < kv[:, None].long())[
        :, None, None, :]
    args = [tuple(x.transpose(1, 2).contiguous() for x in st[:3])
            for st in sets]
    it = iter(range(1 << 30))

    def call():
        sdpa(*args[next(it) % len(args)], attn_mask=mask)

    return cuda_ms(call, iters=30, warmup=3)


def encoder_flash_cases() -> dict:
    """Phase 46's kernel gate: B1 non-causal with ragged ``kv_lens`` at the
    ERNIE and ViT shapes of ENCODER_FLASH (q, k, v strided views of one
    fused buffer, as the qkv projection hands them over) against its plain
    version within FLASH_TOL; a row of length 0 comes out as zeros with
    lse -1e30; the kernel given one key fewer a row, or ``causal``
    flipped, must break the limit. Kernel, plain, SDPA and bound times;
    returns the records by case."""
    records = {}
    bf16 = torch.bfloat16
    d = 64
    atol, rtol = fa.FLASH_TOL[bf16]
    for label, (b, s, lens) in ENCODER_FLASH.items():
        sets = flash_inputs(bf16, b=b, s=s, h=ENCODER_HEADS, d=d)
        kv = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
        kw = dict(causal=False, kv_lens=kv)
        before = dict(fa.launches)
        q, k, v, _ = sets[0]
        out, lse = fa.flash_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        want, want_lse = fa.flash_attention_fwd_ref(q, k, v, **kw)
        err, ratio = _max_err(out, want), _tol_ratio(out, want, atol, rtol)
        lse_err = (lse - want_lse).abs().max().item()
        empty = [i for i, n in enumerate(lens) if n == 0]
        empty_ok = all(not out[i].any() and bool(
            (lse.view(b, ENCODER_HEADS, s)[i] <= -1e29).all())
            for i in empty)
        planted = {
            "kv_lens - 1": _tol_ratio(fa.flash_fwd(
                q, k, v, causal=False, kv_lens=(kv - 1).clamp_min(0))[0],
                want, atol, rtol),
            "causal flipped": _tol_ratio(fa.flash_fwd(
                q, k, v, causal=True, kv_lens=kv)[0], want, atol, rtol)}
        it = iter(range(1 << 30))

        def pick():
            return sets[next(it) % len(sets)][:3]

        kernel_ms = cuda_ms(lambda: fa.flash_fwd(*pick(), **kw), iters=30,
                            warmup=3)
        plain_ms = cuda_ms(lambda: fa.flash_attention_fwd_ref(*pick(), **kw),
                           iters=3, warmup=1)
        library_ms = library_masked_ms(sets, kv)
        nbytes, flops = encoder_bound(b, s, ENCODER_HEADS, d, lens, 2)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_FLOPS[bf16] * 1e3
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        log("encoder-flash", case=label, batch=b, seq=s, heads=ENCODER_HEADS,
            head_dim=d, kv_lens=lens, max_abs_err=err, tol_ratio=ratio,
            lse_max_abs_err=lse_err, empty_rows_zero=empty_ok,
            planted_tol_ratio=planted, kernel_ms=kernel_ms,
            plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(bytes_ms, ops_ms), bound_by=bound_by,
            tflops=flops / kernel_ms * 1e-9)
        if not (ratio <= 1.0 and lse_err <= 1e-3 and empty_ok
                and torch.isfinite(out.float()).all()):
            raise AssertionError(
                f"B1 {label}: max abs err {err}, {ratio} x the limit, lse "
                f"err {lse_err}, empty rows zero {empty_ok}")
        for fault, wrong in planted.items():
            if not wrong > 1.0:
                raise AssertionError(f"B1 {label}: the planted fault "
                                     f"{fault!r} is held within the limit "
                                     f"({wrong})")
        records[label] = {
            "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": bound_by,
            "library_ms": library_ms}
        fa.launches.update(before)  # checks and timing are not the path
        del sets, out, want
    torch.cuda.empty_cache()
    return records


@contextlib.contextmanager
def plain_b1():
    """B1's plain version in place of the kernel wrapper (the encoder
    engines' plain path on the card)."""
    saved = fa.flash_fwd
    fa.flash_fwd = fa.flash_attention_fwd_ref
    try:
        yield
    finally:
        fa.flash_fwd = saved


def watch_encoder(engine) -> dict:
    """Wrap an encoder engine's batched forward: keep each forward's
    request count, input shape and outputs (fp32 copies)."""
    seen = {"batches": [], "shapes": []}
    run, forward = engine._run_batch, engine.model.forward

    def kept_forward(*args, **kw):
        out = forward(*args, **kw)
        seen["shapes"].append(tuple(args[0].shape))
        outs = out if isinstance(out, tuple) else (out,)
        seen["outputs"] = tuple(o.float().clone() for o in outs)
        return out

    def kept_run(requests):
        got = run(requests)
        seen["batches"].append((len(requests), seen.pop("outputs")))
        return got

    engine.model.forward = kept_forward
    engine._run_batch = kept_run
    return seen


def unwatch_encoder(engine) -> None:
    """Undo watch_encoder."""
    del engine.model.forward, engine._run_batch


def encoder_drive(engine, prompts) -> tuple:
    """Submit ``prompts``, tick to the end: (results in order, forwards,
    seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [engine.submit(p) for p in prompts]
    forwards = 0
    while len(engine.scheduler):
        forwards += engine.step()["forwards"]
    res = engine.drain()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if any(res[r].finish_reason != "complete" for r in rids):
        raise AssertionError(f"{type(engine).__name__}: finished "
                             f"{[res[r].finish_reason for r in rids]}")
    return [res[r] for r in rids], forwards, seconds


def ernie_requests(vocab: int, seed: int = 46) -> list:
    """21 prompts of 16..512 tokens, by submission order 8 short (16-64),
    8 middling (65-256) and 5 long (257-512): three ticks of 8 slots in
    length buckets 64, 256 and 512, the last with three filler rows. Half
    fill-in-blank (1-8 mask tokens, id 3), half scoring (no mask). Seeds
    past ``seed`` draw the same mix again (ernie_window)."""
    rng = np.random.RandomState(seed)
    out = []
    for i, (lo, hi) in enumerate([(16, 64)] * 8 + [(65, 256)] * 8
                                 + [(257, 512)] * 5):
        p = rng.randint(4, vocab, rng.randint(lo, hi + 1)).astype(np.int32)
        if i % 2 == 0:
            p[rng.choice(p.size, rng.randint(1, 9), replace=False)] = 3
        out.append(p)
    return out


def ernie_window(vocab: int) -> list:
    """ERNIE_WINDOW prompts: ernie_requests drawn again at seeds 1000..."""
    out = []
    for k in range(-(-ERNIE_WINDOW // 21)):
        out += ernie_requests(vocab, seed=1000 + k)
    return out[:ERNIE_WINDOW]


def timed_window(engine, prompts, what: str) -> dict:
    """The rate of ``engine`` over ``prompts`` submitted at once, timed on
    the host clock from the first submit to the last result (the engine
    warmed up before): requests, forwards, seconds, requests/s."""
    results, forwards, seconds = encoder_drive(engine, prompts)
    return {f"{what}_window": len(results), f"{what}_window_forwards":
            forwards, f"{what}_window_s": seconds,
            f"{what}_per_s": len(results) / seconds}


def per_request_rows(seen, prompts, mask_id=None) -> list:
    """Each request's output rows from the watched forwards, in order (the
    real rows of each batch; filler rows dropped): ERNIE (``mask_id``):
    the MLM rows of its masks, or its SOP row; ViT: its output row."""
    rows = []
    for n, outs in seen["batches"]:
        for i in range(n):
            if mask_id is None:
                rows.append(outs[0][i])
                continue
            masks = int((prompts[len(rows)] == mask_id).sum())
            rows.append(outs[0][i, :masks] if masks else outs[1][i])
    if len(rows) != len(prompts):
        raise AssertionError(f"{len(rows)} output rows for {len(prompts)} "
                             "requests")
    return rows


def near_tie_gate(what: str, got_ids, want_ids, want_rows) -> float:
    """Ids equal to the plain path's wherever the plain top-2 logit gap
    exceeds LOGIT_TOL; returns the fraction of equal ids."""
    equal = total = 0
    for r, (a, b, row) in enumerate(zip(got_ids, want_ids, want_rows)):
        row = row.reshape(len(b), -1)
        top = torch.topk(row, 2, dim=-1).values
        for t, (x, y) in enumerate(zip(a, b)):
            total += 1
            equal += x == y
            gap = float(top[t, 0] - top[t, 1])
            if x != y and gap > LOGIT_TOL:
                raise AssertionError(f"{what}: request {r} id {t} is {x}, "
                                     f"plain {y}, top-2 gap {gap}")
    return equal / max(total, 1)


def rows_gap(got, want) -> float:
    return max((a - b).abs().max().item() for a, b in zip(got, want))


def phase_ernie(kernel_records: dict) -> dict:
    """Phase 46: B1's gate at the encoder shapes (encoder_flash_cases),
    then an ``ErnieScoringEngine`` on ERNIE-base weights from
    ``init_params`` (seed 0) serves ernie_requests through the kernel and,
    on the same card, through B1's plain version: MLM and SOP logits of
    every real row within LOGIT_TOL, ids equal wherever the plain top-2
    gap exceeds it; B1 launched once per layer of each batched forward.
    Returns B1's launches and the drive's numbers."""
    from fleetx_tpu_torch.models.ernie.convert import init_params as ernie_init
    from fleetx_tpu_torch.models.ernie.model import ErnieForPretraining
    from fleetx_tpu_torch.serving import ErnieScoringEngine

    kernel_records.update(encoder_flash_cases())
    cfg = ernie_config()
    engine = ErnieScoringEngine(ErnieForPretraining(cfg, device="meta"),
                                ernie_init(cfg, seed=0), slots=8)
    prompts = ernie_requests(cfg.vocab_size)
    encoder_drive(engine, prompts)  # warm-up: every bucket's first call
    seen = watch_encoder(engine)
    fa.launches["flash_fwd"] = 0  # the path starts here
    results, forwards, seconds = encoder_drive(engine, prompts)
    launches = fa.launches["flash_fwd"]
    launch_gate("ernie B1", launches, forwards, cfg.num_layers)
    got_rows = per_request_rows(seen, prompts, engine.mask_token_id)
    shapes = list(seen["shapes"])
    seen["batches"].clear()
    with plain_b1():
        plain, _, _ = encoder_drive(engine, prompts)
    want_rows = per_request_rows(seen, prompts, engine.mask_token_id)
    err = rows_gap(got_rows, want_rows)
    frac = near_tie_gate("ernie", [r.tokens.tolist() for r in results],
                         [r.tokens.tolist() for r in plain], want_rows)
    ttft = quantiles([r.ttft_s * 1e3 for r in results])[0]
    if not (math.isfinite(err) and err <= LOGIT_TOL):
        raise AssertionError(f"ernie: logits differ by {err}")
    unwatch_encoder(engine)  # the window times the engine alone
    rate = timed_window(engine, ernie_window(cfg.vocab_size), "requests")
    log("ernie", layers=cfg.num_layers, hidden=cfg.hidden_size,
        heads=cfg.num_attention_heads, vocab=cfg.vocab_size,
        requests=len(prompts), batch_shapes=shapes, forwards=forwards,
        kernel="flash_fwd", kernel_launches=launches,
        logits_max_abs_err=err, tol=LOGIT_TOL, ids_equal_frac=frac,
        burst_ttft_ms_p50=ttft, burst_s=seconds, **rate,
        card=repr(CARD.get("line")))
    del engine, seen
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches}


def vit_images(n: int, seed: int = 47) -> list:
    rng = np.random.RandomState(seed)
    return [rng.rand(224, 224, 3).astype(np.float32) for _ in range(n)]


def vector_gaps(got, want) -> list:
    """|a - b|_2 / |b|_2 of each pair of vectors."""
    return [(torch.linalg.vector_norm(a - b)
             / torch.linalg.vector_norm(b)).item() for a, b in zip(got, want)]


def vit_params(seed: int = 0) -> dict:
    """ViT-B/16 classification weights drawn on the card (seed 0)."""
    from fleetx_tpu_torch.models.vision.convert import init_params as vit_init

    return vit_init(vit_config(), seed=seed)


def vit_engine(params: dict, classify: bool, **kw):
    """An ``EmbeddingEngine`` over ViT-B/16 (``params`` without the head in
    embedding mode), 8 slots."""
    from fleetx_tpu_torch.models.vision.vit import ViT
    from fleetx_tpu_torch.serving import EmbeddingEngine

    cfg = vit_config(None if classify else 0)
    if not classify:
        params = {k: v for k, v in params.items() if not k.startswith("head.")}
    return EmbeddingEngine(ViT(cfg, device="meta"), params,
                           **dict(dict(slots=8), **kw))


def phase_vit() -> dict:
    """Phase 47: ``EmbeddingEngine``s over ViT-B/16 (weights from
    ``init_params``, seed 0) in embedding mode and in classification mode
    (1000 classes) serve VIT_IMAGES seeded 224×224×3 images through B1
    and through its plain version: each embedding within VIT_EMB_TOL, the
    class logits within LOGIT_TOL and the class ids equal wherever the
    plain top-2 gap exceeds it; B1 once per layer of each forward. Then
    one image's embedding at buckets 1, 2, 4 and 8 (the largest gap to
    bucket 1, and whether it is bit-equal, logged). Returns B1's launches
    and the drive's numbers."""
    from fleetx_tpu_torch.serving import encode_floats

    params = vit_params()
    images = vit_images(VIT_IMAGES)
    prompts = [encode_floats(x) for x in images]
    pool = [encode_floats(x) for x in vit_images(VIT_POOL, seed=470)]
    window = [pool[i % VIT_POOL] for i in range(VIT_WINDOW)]
    out = {"launches": 0}
    for classify in (False, True):
        engine = vit_engine(params, classify)
        cfg = engine.model.cfg
        encoder_drive(engine, prompts)  # warm-up: every bucket's first call
        seen = watch_encoder(engine)
        fa.launches["flash_fwd"] = 0  # the path starts here
        results, forwards, seconds = encoder_drive(engine, prompts)
        launches = fa.launches["flash_fwd"]
        launch_gate("vit B1", launches, forwards, cfg.num_layers)
        out["launches"] += launches
        got = per_request_rows(seen, prompts)
        seen["batches"].clear()
        with plain_b1():
            plain, _, _ = encoder_drive(engine, prompts)
        want = per_request_rows(seen, prompts)
        mode = "classify" if classify else "embed"
        unwatch_encoder(engine)  # the window times the engine alone
        fields = dict(mode=mode, images=len(prompts), forwards=forwards,
                      kernel="flash_fwd", kernel_launches=launches,
                      burst_ttft_ms_p50=quantiles(
                          [r.ttft_s * 1e3 for r in results])[0],
                      burst_s=seconds,
                      **timed_window(engine, window, "vectors"),
                      card=repr(CARD.get("line")))
        if classify:
            err = rows_gap(got, want)
            frac = near_tie_gate("vit classes",
                                 [r.tokens.tolist() for r in results],
                                 [r.tokens.tolist() for r in plain], want)
            log("vit", **fields, logits_max_abs_err=err, tol=LOGIT_TOL,
                ids_equal_frac=frac)
            if not (math.isfinite(err) and err <= LOGIT_TOL):
                raise AssertionError(f"vit classes: logits differ by {err}")
        else:
            gaps = vector_gaps(got, want)
            log("vit", **fields, width=len(results[0].tokens),
                embedding_rel_gap_max=max(gaps), tol=VIT_EMB_TOL)
            if not max(gaps) <= VIT_EMB_TOL:
                raise AssertionError(f"vit embeddings: relative gap "
                                     f"{max(gaps)} > {VIT_EMB_TOL}")
            # batch makeup: image 0 in row 0 of buckets 1, 2, 4, 8
            x = torch.from_numpy(np.stack(images[:8])).to(DEVICE)
            with torch.no_grad():
                rows = {n: engine.model(x[:n])[0].float() for n in (1, 2, 4,
                                                                     8)}
            log("vit", batch_makeup_max_abs_diff={
                n: (r - rows[1]).abs().max().item() for n, r in rows.items()},
                bit_equal={n: bool(torch.equal(r, rows[1]))
                           for n, r in rows.items()},
                rel_gap={n: vector_gaps([r], [rows[1]])[0]
                         for n, r in rows.items()})
        del engine, seen
    gc.collect()
    torch.cuda.empty_cache()
    return out


def encoder_forwards(engines) -> int:
    """The batched forwards the encoder engines have run (each engine's
    ``fleetx_serving_batched_forwards_total``)."""
    return sum(int(e.metrics._c_batched_forwards.value) for e in engines)


def relative_gap(vec, want) -> float:
    """|a - b|_2 / |b|_2 of two embedding vectors (numpy)."""
    return float(np.linalg.norm(vec - want) / np.linalg.norm(want))


def hetero_answers(what: str, rids, res, want: dict) -> dict:
    """Beside chaos_check's gates: ERNIE answers of the lone engine's
    lengths (how many equal it, logged), TTFT p50 by family."""
    ernie = [res[r] for f, _, r in rids if f == "ernie"]
    lens = [len(r.tokens) for r in ernie]
    if lens != [len(t) for t in want["ernie"]]:
        raise AssertionError(f"{what}: ERNIE answers of {lens} tokens, "
                             f"want {[len(t) for t in want['ernie']]}")
    equal = sum(a.tokens.tolist() == b for a, b in zip(ernie, want["ernie"]))
    ttft = {}
    for fam, _, rid in rids:
        ttft.setdefault(fam, []).append(res[rid].ttft_s * 1e3)
    return {"ttft_ms_p50": {f: quantiles(t)[0] for f, t in ttft.items()},
            "ernie_equal_lone": f"{equal}/{len(lens)}"}


def phase_hetero(cfg) -> dict:
    """Phase 48: one process serves two GPT-345M ``ServingEngine``s (phase
    44's weights and engine, B8), two ViT-B/16 ``EmbeddingEngine``s and
    an ERNIE-base ``ErnieScoringEngine`` (B1) behind a ``ServingRouter``
    and an ``ApiServer``: over HTTP ``/v1/models`` lists the three
    families, ``/v1/completions`` reaches ``gpt`` and ``ernie`` (the ERNIE
    ids equal a lone engine's), ``/v1/embeddings`` on two images returns
    the engines' wire vectors exactly; a mixed in-process pass
    (``chaos_check.hetero_pass``) gives the lone replicas' GPT streams
    byte for byte and their embeddings within VIT_EMB_TOL (TTFT p50 by
    family logged); then ``chaos_check.hetero_fault_plan`` over the same
    engines (``serving_hetero``: ViT replica 2 killed at router tick 1
    with its batch dispatched, GPT replica 1 at tick 3 mid-stream): one
    terminal result each, the same gates, no dispatch across families.
    B8 once per layer of each decode forward, B1 once per layer of each
    encoder forward. The routers run at the default DRR quantum, which
    prices an image at the ViT's 197 rows of work: a lone image sent to a
    router over one ViT engine is answered in its first tick."""
    import urllib.request

    from fleetx_tpu_torch.models.ernie.convert import init_params as ernie_init
    from fleetx_tpu_torch.models.ernie.model import ErnieForPretraining
    from fleetx_tpu_torch.serving import (
        ErnieScoringEngine,
        ServingRouter,
        decode_floats,
        encode_floats,
    )
    from fleetx_tpu_torch.serving.api.server import ApiServer
    from fleetx_tpu_torch.tools.chaos_check import (
        HETERO_KILL,
        hetero_fault_plan,
        hetero_pass,
    )

    params = fleet_params(cfg)
    gpts = [build_engine(params=params, **FLEET_ENGINE)[0] for _ in range(2)]
    del params
    weights = vit_params()
    vits = [vit_engine(weights, False, slots=4) for _ in range(2)]
    del weights
    ecfg = ernie_config()
    ernie = ErnieScoringEngine(ErnieForPretraining(ecfg, device="meta"),
                               ernie_init(ecfg, seed=0), slots=4)
    fleet = ([("gpt", g) for g in gpts] + [("vit", v) for v in vits]
             + [("ernie", ernie)])  # replicas 0-1 GPT, 2-3 ViT, 4 ERNIE
    engines = [e for _, e in fleet]
    gpt_reqs = [dict(prompt=r["prompt"], max_length=HETERO_NEW,
                     decode_strategy=r["decode_strategy"], top_k=r["top_k"],
                     top_p=r["top_p"], seed=r["seed"])
                for r in serving_requests(cfg.vocab_size)]
    ernie_reqs = ernie_requests(ecfg.vocab_size)[::5]
    images = vit_images(8, seed=48)
    requests = {"gpt": gpt_reqs,
                "vit": [dict(prompt=encode_floats(x)) for x in images],
                "ernie": [dict(prompt=p) for p in ernie_reqs]}
    # the lone replicas' answers (each engine warmed up by them)
    res, _, _ = serve(gpts[0], gpt_reqs)
    want = {"gpt": [res[r].tokens.tolist() for r in sorted(res)]}
    lone, _, _ = encoder_drive(vits[0], [encode_floats(x) for x in images])
    want["vit"] = [decode_floats(r.tokens) for r in lone]
    lone, _, _ = encoder_drive(ernie, ernie_reqs)
    want["ernie"] = [r.tokens.tolist() for r in lone]
    blank = ernie_reqs[0]
    lone, _, _ = encoder_drive(ernie, [blank])
    want_blank = lone[0].tokens.tolist()
    watched = [watch_forwards(g) for g in gpts]
    wire_tokens = {}
    for e in vits:  # the wire tokens each ViT result carried, by prompt
        take = e.take_result

        def taken(rid, _take=take):
            r = _take(rid)
            if r is not None:
                wire_tokens[r.prompt.tobytes()] = r.tokens.copy()
            return r

        e.take_result = taken
    zero_launches()
    fa.launches["flash_fwd"] = 0  # the path starts here
    forwards0 = encoder_forwards(vits + [ernie])
    lone = ServingRouter([vits[0]])
    rid = lone.submit(encode_floats(images[0]))
    first_ticks = 0
    while lone.result(rid) is None and first_ticks < 600:
        lone.step()
        first_ticks += 1
    if first_ticks != 1:
        raise AssertionError(f"hetero: an image at the default DRR quantum "
                             f"took {first_ticks} router ticks to answer")
    del lone
    router = ServingRouter(engines, probe_every=1)
    api = ApiServer(router, model_id="fleet-hetero").start()
    try:
        with urllib.request.urlopen(api.url + "/v1/models", timeout=60) as r:
            listing = json.loads(r.read())
        families = sorted(m["id"] for m in listing["data"][1:])
        if families != ["ernie", "gpt", "vit"]:
            raise AssertionError(f"hetero: /v1/models lists {families}")

        def post(path, body):
            req = urllib.request.Request(
                api.url + path, json.dumps(body).encode(),
                {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as resp:
                return json.loads(resp.read())

        comp = post("/v1/completions", {"model": "gpt", "prompt": [
            int(t) for t in gpt_reqs[0]["prompt"]], "max_tokens": 8,
            "temperature": 0})
        got = [int(t) for t in comp["choices"][0]["text"].split()]
        if got != want["gpt"][0][:8]:
            raise AssertionError(f"hetero: GPT completion {got}")
        comp = post("/v1/completions", {"model": "ernie", "prompt": [
            int(t) for t in blank]})
        got = [int(t) for t in comp["choices"][0]["text"].split()]
        if got != want_blank:
            raise AssertionError(f"hetero: ERNIE completion {got}, lone "
                                 f"engine {want_blank}")
        t0 = time.perf_counter()
        emb = post("/v1/embeddings", {"input": [
            [float(v) for v in x.reshape(-1)] for x in images[:2]]})
        http_s = time.perf_counter() - t0
        for x, d in zip(images[:2], emb["data"]):
            sent = wire_tokens[encode_floats(x).tobytes()]
            if not np.array_equal(np.asarray(d["embedding"], np.float32),
                                  decode_floats(sent)):
                raise AssertionError("hetero: /v1/embeddings vector differs "
                                     "from the engine's wire tokens")
        # a clean mixed pass in process (under the lock the front door's
        # ticking thread waits)
        with api._lock:
            rids, res, gap, bit_equal = hetero_pass(
                router, requests, want, relative_gap, VIT_EMB_TOL,
                max_ticks=2000)
    finally:
        api.stop()
    log("hetero", card=repr(CARD.get("line")), families=families,
        drr_quantum=router.drr_quantum, image_first_ticks=first_ticks,
        embeddings_http_s=http_s,
        embeddings_width=len(emb["data"][0]["embedding"]),
        embedding_rel_gap_max=gap,
        embeddings_bit_equal=f"{bit_equal}/{len(images)}",
        **hetero_answers("hetero clean", rids, res, want))
    # serving_hetero's fault plan over the same engines
    router, rids, res, gap, bit_equal, given = hetero_fault_plan(
        fleet, requests, want, relative_gap, VIT_EMB_TOL, max_ticks=2000)
    answers = hetero_answers("hetero killed", rids, res, want)
    snap = router.metrics.snapshot()
    torch.cuda.synchronize()
    b8 = da.launches["paged_decode"]
    launch_gate("hetero B8", b8, sum(w["decode"] for w in watched),
                cfg.num_layers)
    b1 = fa.launches["flash_fwd"]
    launch_gate("hetero B1", b1, encoder_forwards(vits + [ernie]) - forwards0,
                ecfg.num_layers)
    log("hetero", fault_plan=HETERO_KILL, requests=len(rids),
        migrated=snap["migrated"], replica_deaths=snap["replica_deaths"],
        states=router.replica_states, submits=given,
        paged_decode_launches=b8, flash_fwd_launches=b1,
        embedding_rel_gap_max=gap,
        embeddings_bit_equal=f"{bit_equal}/{len(images)}", **answers)
    del engines, fleet, gpts, vits, ernie, router
    gc.collect()
    torch.cuda.empty_cache()
    return {"paged_decode": b8, "flash_fwd": b1}


# ------------------------------------------------------------ phases 49-50
MOE_CONFIG = os.path.join(ROOT, "configs/nlp/moe/pretrain_moe_small.yaml")
MOE_STEPS = 6        # phase 49's steps at the yaml's full depth
MOE_BATCH = 8        # the global batch of phases 49-50 (the yaml's local 8)
MOE_EP_STEPS = 4     # phase 50(b)'s steps: phase 49's first global batches
MOE_E2E_LAYERS = 2   # phase 50(a)'s depth of the yaml's 12, fp32
MOE_E2E_CF = 0.5     # phase 50(a)'s capacity factor: tokens are dropped
# phase 50(a), fp32, dp 2 against dp 1 on one global batch: the loss (abs)
# and grad norm (relative) as TRAIN_E2E_TOL, and each parameter leaf after
# the step (relative L2: AdamW's first step moves every element by about
# lr, so a gradient summed wrongly moves a leaf by ~1e-3 of its norm)
MOE_E2E_TOL = {"loss": 1e-4, "grad_norm": 3e-4, "param_leaf": 1e-4}
MOE_BF16_LOSS_TOL = 2e-2  # phase 50(b): each bf16 loss against phase 49's
MOE_PLANTS = ("per-rank routing", "expert grads summed",
              "norm of the local experts")


def moe_overrides(prefix: str, *extra, dp: int = 1,
                  steps: int = MOE_STEPS) -> list:
    """Overrides of ``pretrain_moe_small.yaml`` at its full width (its
    depth unless ``extra`` cuts it) over the corpus at ``prefix``, at dp
    ``dp`` (the global batch MOE_BATCH split over the ranks), a short
    warmup and a max_lr at which the loss moves within the drive."""
    rows = MOE_BATCH // dp
    return [own_output_dir(prefix), f"Data.Train.dataset.input_dir={prefix}",
            f"Distributed.dp_degree={dp}", f"Global.local_batch_size={rows}",
            f"Global.micro_batch_size={rows}", f"Engine.max_steps={steps}",
            "Engine.logging_freq=1", "Engine.eval_freq=0",
            "Optimizer.lr.warmup_steps=1", "Optimizer.lr.max_lr=5.0e-4",
            "Optimizer.lr.min_lr=5.0e-5", "Optimizer.lr.decay_steps=1000",
            *extra]


def moe_config(prefix: str, *extra, dp: int = 1, steps: int = MOE_STEPS):
    """The config of :func:`moe_overrides`."""
    return get_config(MOE_CONFIG, overrides=moe_overrides(
        prefix, *extra, dp=dp, steps=steps), nranks=dp)


def watch_moe_routing(calls: list):
    """Record each MoE layer's routing as it runs (expert ids, keep flags
    and the entries dropped at capacity, on the host) into ``calls``;
    returns the function that stops it."""
    from fleetx_tpu_torch.parallel import moe

    real = moe.route

    def route(probs, cfg, key):
        out = real(probs, cfg, key)
        idx, _, weights, keep = out[:4]
        calls.append({"ids": idx.cpu(), "keep": keep.cpu(),
                      "dropped": int(((weights > 0) & ~keep).sum()),
                      "entries": keep.numel()})
        return out

    moe.route = route
    return lambda: setattr(moe, "route", real)


def moe_bytes(trainer) -> dict:
    """The parameter bytes this rank holds, dense and expert."""
    from fleetx_tpu_torch.parallel.moe import is_expert_param

    out = {"dense": 0, "expert": 0}
    for n, p in trainer.module.nets.named_parameters():
        out["expert" if is_expert_param(n) else "dense"] += (
            p.numel() * p.element_size())
    return out


def phase_moe(prefix: str) -> dict:
    """Phase 49: ``Trainer.fit`` through ``build_module`` on
    ``pretrain_moe_small.yaml`` at full width and depth (12 layers, hidden
    1024, 8 experts, gshard top 2, capacity 1.2), one rank, bf16, dropout
    0.1, MOE_STEPS steps: every loss finite and the loss falling, B1, B2
    and B3 once per layer per step; ``lm_loss``, ``balance_loss``, each
    layer's dropped share, step ms, tokens/s, the MoE MFU, peak memory and
    the parameter bytes (dense, expert) logged. Returns the launches and
    the losses phase 50(b) is held to."""
    cfg = moe_config(prefix)
    module = build_module(cfg)
    trainer = Trainer(cfg, module)
    trainer.init_state()
    gcfg = module.gpt_config
    ends = []
    inner = trainer.train_step

    def timed(batch):
        out = inner(batch)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        return out

    trainer.train_step = timed
    routing = []
    stop = watch_moe_routing(routing)
    torch.cuda.reset_peak_memory_stats()
    for name in fa.NAMES:
        fa.launches[name] = 0
    t0 = time.perf_counter()
    try:
        trainer.fit(build_dataloader(cfg, "Train"))
        torch.cuda.synchronize()
    finally:
        stop()
    seconds = time.perf_counter() - t0
    launches = {n: fa.launches[n] for n in fa.NAMES}
    steps = trainer.step
    losses = [float(h["loss"]) for h in trainer.history]
    seq = cfg.Data.Train.dataset.max_seq_len
    tokens = MOE_BATCH * seq
    step_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
    steady = float(np.median(step_ms[1:])) * 1e-3
    flops = trainer._flops_per_token(seq, tokens)
    layers = gcfg.num_layers
    dropped = [sum(c["dropped"] for c in routing[i::layers])
               / sum(c["entries"] for c in routing[i::layers])
               for i in range(layers)]
    nbytes = moe_bytes(trainer)
    log("moe", card=repr(CARD.get("line")), steps=steps, layers=layers,
        hidden=gcfg.hidden_size, experts=gcfg.num_experts, gate=gcfg.gate,
        top_k=gcfg.top_k, capacity_factor=gcfg.capacity_factor,
        params_b=trainer.n_params / 1e9, dense_bytes=nbytes["dense"],
        expert_bytes=nbytes["expert"],
        dtype=str(gcfg.dtype).split(".")[-1], batch=MOE_BATCH, seq=seq,
        step_ms=[round(x, 2) for x in step_ms],
        step_ms_median=steady * 1e3, tokens_per_s=tokens / steady,
        flops_per_token=flops,
        mfu=tokens / steady * flops / peak_flops(trainer.device),
        fit_seconds=seconds,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches)
    log("moe", losses=[round(x, 5) for x in losses],
        lm_loss=[round(float(h["lm_loss"]), 5) for h in trainer.history],
        balance_loss=[round(float(h["balance_loss"]), 5)
                      for h in trainer.history],
        grad_norms=[round(float(h["grad_norm"]), 4)
                    for h in trainer.history],
        dropped_share_by_layer=[round(x, 4) for x in dropped])
    if steps != MOE_STEPS or len(routing) != steps * layers:
        raise AssertionError(f"moe: {steps} steps, {len(routing)} routed "
                             "forwards")
    if launches != {n: steps * layers for n in fa.NAMES}:
        raise AssertionError(f"moe: flash launches {launches} over {steps} "
                             f"steps x {layers} layers")
    if not all(math.isfinite(x) for x in losses) or not (
            np.mean(losses[-2:]) < losses[0]):
        raise AssertionError(f"moe: losses {losses}")
    del trainer, module
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses}


def moe_plant(label: str):
    """Swap in phase 50(a)'s planted fault ``label`` (None: none); returns
    the function that puts the code back. The faults: routing each rank's
    tokens alone with a capacity of its own (the reference's per-rank
    semantics, not JAX's global routing); the expert gradients summed over
    the data group like the dense ones (the trainer told no parameter is
    an expert block); the clip's norm over this rank's experts only."""
    from fleetx_tpu_torch.core import engine
    from fleetx_tpu_torch.parallel import moe
    from fleetx_tpu_torch.parallel.mesh import get_mesh

    if label is None:
        return lambda: None
    if label == "per-rank routing":
        real = moe.route

        def route(probs, cfg, key):
            world = get_mesh().data_world
            n = probs.shape[0] // world
            k, cap = moe.moe_capacity(cfg, n)
            key = key if cfg.gate == "gshard" else None
            parts = [moe.compute_routing_indices(
                probs[r * n:(r + 1) * n], k, cap, cfg.gate, key,
                offset=r * n, probs=probs[r * n:(r + 1) * n])
                for r in range(world)]
            idx, pos, weights, keep, aux = (list(x) for x in zip(*parts))
            pos = [p + r * cap for r, p in enumerate(pos)]
            return (torch.cat(idx), torch.cat(pos), torch.cat(weights),
                    torch.cat(keep), torch.stack(aux).mean(), cap * world)

        moe.route = route
        return lambda: setattr(moe, "route", real)
    if label == "expert grads summed":
        real = engine.is_expert_param
        engine.is_expert_param = lambda name: False
        return lambda: setattr(engine, "is_expert_param", real)
    real = engine.global_norm
    engine.global_norm = lambda *a, **kw: real(*a, **{**kw, "ep_group": None})
    return lambda: setattr(engine, "global_norm", real)


def moe_e2e_step(cfg, batch, plant=None) -> dict:
    """One train step of a fresh trainer of ``cfg`` (the seeded init) on
    its data rank's rows of ``batch`` with ``plant`` swapped in: the loss,
    grad norm, each layer's routing, the parameters after the step, the
    entries dropped at capacity, the expert blocks and the mesh."""
    undo = moe_plant(plant)
    routing = []
    stop = watch_moe_routing(routing)
    try:
        trainer = Trainer(cfg, build_module(cfg))
        trainer.init_state()
        mesh = trainer.mesh
        b = MOE_BATCH // mesh.data_world
        rows = {k: v[mesh.data_rank * b:(mesh.data_rank + 1) * b]
                for k, v in batch.items()}
        out = trainer.train_step(trainer._to_device(rows))
        torch.cuda.synchronize()
    finally:
        stop()
        undo()
    from fleetx_tpu_torch.parallel.moe import is_expert_param

    params = {n: p.detach() for n, p in
              trainer.module.nets.named_parameters()}
    return {"loss": float(out["loss"]), "grad_norm": float(out["grad_norm"]),
            "routing": routing, "params": params,
            "dropped": sum(c["dropped"] for c in routing),
            "experts_held": next(p.shape[0] for n, p in params.items()
                                 if is_expert_param(n)), "mesh": mesh}


def moe_e2e_gaps(run: dict, ref: dict) -> dict:
    """Gaps of a dp 2 rank's step ``run`` from the dp 1 reference ``ref``
    (loss, grad norm, routing per layer, parameters whole): the metrics
    of MOE_E2E_TOL, the worst leaf, and whether every layer's expert ids
    and keep flags are bit-equal."""
    from fleetx_tpu_torch.parallel.moe import expert_block

    routing, mesh = run["routing"], run["mesh"]
    same = len(routing) == len(ref["routing"]) and all(
        torch.equal(a["ids"], b["ids"]) and torch.equal(a["keep"], b["keep"])
        for a, b in zip(routing, ref["routing"]))
    leaf = {}
    for n, p in run["params"].items():
        want = ref["params"][n].to(p.device)
        if want.shape != p.shape:  # an expert leaf: this rank's block
            want = want[expert_block(want.shape[0], mesh.data_world,
                                     mesh.data_rank)]
        leaf[n] = (torch.linalg.vector_norm((p - want).float())
                   / torch.linalg.vector_norm(want.float())).item()
    worst = max(leaf, key=leaf.get)
    return {"routing_bit_equal": same,
            "loss": abs(run["loss"] - ref["loss"]),
            "grad_norm": (abs(run["grad_norm"] - ref["grad_norm"])
                          / ref["grad_norm"]),
            "param_leaf": leaf[worst], "worst_leaf": worst,
            "loss_this": run["loss"], "grad_norm_this": run["grad_norm"],
            "dropped": run["dropped"], "experts_held": run["experts_held"]}


def moe_e2e_rank(overrides, batch, ref_path) -> dict:
    """One rank of phase 50(a): the sound dp 2 step, then each planted
    fault's, each against the dp 1 reference at ``ref_path``."""
    ref = torch.load(ref_path, map_location="cpu")
    cfg = get_config(MOE_CONFIG, overrides=list(overrides), nranks=2)
    out = {}
    for plant in (None,) + MOE_PLANTS:
        run = moe_e2e_step(cfg, batch, plant)
        out[plant or "sound"] = moe_e2e_gaps(run, ref)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return out


def moe_e2e_breaks(gaps: dict) -> list:
    """The gates of phase 50(a) that ``gaps`` break."""
    broken = [m for m, tol in MOE_E2E_TOL.items() if not gaps[m] <= tol]
    if not gaps["routing_bit_equal"]:
        broken.append("routing")
    return broken


def phase_moe_ep(prefix: str, losses49: list) -> dict:
    """Phase 50: expert parallelism, two ranks sharing the card over gloo,
    dp 2, 4 of the 8 experts each.

    (a) ``pretrain_moe_small.yaml`` at full width, MOE_E2E_LAYERS layers,
    fp32, capacity factor MOE_E2E_CF (tokens are dropped): one step on one
    global batch at dp 1 here and at dp 2 on the ranks: every layer's
    expert ids and keep flags bit-equal, the loss, grad norm and every
    parameter after the step within MOE_E2E_TOL; each of MOE_PLANTS must
    break that gate.

    (b) bf16 at full depth, MOE_EP_STEPS steps of ``Trainer.fit`` on phase
    49's global batches: each loss within MOE_BF16_LOSS_TOL of phase 49's,
    each rank's expert bytes in [0.45, 0.55] of the whole model's expert
    bytes; the all-to-all ms and MB and the data-group all-reduce ms per
    step logged."""
    from fleetx_tpu_torch.parallel.launch import spawn

    # no warmup: the step's update moves every parameter (at lr 0 the
    # parameter gate would hold whatever the gradients were); AdamW's
    # epsilon 1e-6: the key bias's gradient is 0 in exact arithmetic, and
    # at 1e-8 its summation noise became ±lr steps
    extra = (f"Model.num_layers={MOE_E2E_LAYERS}",
             f"Model.capacity_factor={MOE_E2E_CF}",
             "Engine.mix_precision.use_pure_fp16=False",
             "Optimizer.lr.warmup_steps=0", "Optimizer.epsilon=1e-6")
    cfg1 = moe_config(prefix, *extra)
    batch = next(iter(build_dataloader(cfg1, "Train")))
    ref = moe_e2e_step(cfg1, batch)
    dropped = ref["dropped"]
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "dp1.pt")
        torch.save({"loss": ref["loss"], "grad_norm": ref["grad_norm"],
                    "routing": ref["routing"],
                    "params": {n: p.cpu() for n, p in ref["params"].items()}},
                   ref_path)
        del ref["params"]
        gc.collect()
        torch.cuda.empty_cache()
        over = moe_overrides(prefix, *extra, dp=2)
        ranks = spawn(moe_e2e_rank, 2, (over, batch, ref_path), timeout=900)
    sound = [r["sound"] for r in ranks]
    for r, g in enumerate(sound):
        log("moe-ep", part="a", rank=r, layers=MOE_E2E_LAYERS,
            capacity_factor=MOE_E2E_CF, dropped_dp1=dropped,
            loss_dp1=ref["loss"], grad_norm_dp1=ref["grad_norm"],
            tol=MOE_E2E_TOL, **g)
    if dropped <= 0 or any(g["dropped"] != dropped for g in sound):
        raise AssertionError(f"moe-ep: dropped {dropped} at dp 1, "
                             f"{[g['dropped'] for g in sound]} at dp 2")
    broken = [moe_e2e_breaks(g) for g in sound]
    half = build_module(cfg1).gpt_config.num_experts // 2
    if any(broken) or any(g["experts_held"] != half for g in sound):
        raise AssertionError(f"moe-ep: dp 2 against dp 1 breaks {broken}: "
                             f"{sound}")
    for plant in MOE_PLANTS:
        gaps = [r[plant] for r in ranks]
        caught = sorted({m for g in gaps for m in moe_e2e_breaks(g)})
        log("moe-ep", planted_fault=plant, breaks=caught,
            **{k: max(g[k] for g in gaps) for k in MOE_E2E_TOL})
        if not caught:
            raise AssertionError(f"moe-ep: the planted fault {plant!r} "
                                 "passed the gate")
    # (b): full depth, bf16, phase 49's global batches
    runs = spawn(moe_ep_fit_rank, 2, (prefix,), timeout=900)
    for r, run in enumerate(runs):
        log("moe-ep", part="b", rank=r, **run)
    gaps = [abs(a - b) for a, b in zip(runs[0]["losses"], losses49)]
    share = [run["expert_bytes"] / run["expert_bytes_whole"] for run in runs]
    log("moe-ep", part="b", loss_gaps=gaps, tol=MOE_BF16_LOSS_TOL,
        expert_share=share)
    if (len(gaps) != MOE_EP_STEPS or not all(g <= MOE_BF16_LOSS_TOL
                                             for g in gaps)
            or runs[0]["losses"] != runs[1]["losses"]):
        raise AssertionError(f"moe-ep: dp 2 losses {runs[0]['losses']} / "
                             f"{runs[1]['losses']} against phase 49's "
                             f"{losses49[:MOE_EP_STEPS]}")
    if not all(0.45 <= s <= 0.55 for s in share):
        raise AssertionError(f"moe-ep: expert byte shares {share}")
    gc.collect()
    torch.cuda.empty_cache()
    return {n: runs[0]["launches"][n] for n in fa.NAMES}


def moe_ep_fit_rank(prefix: str) -> dict:
    """One rank of phase 50(b): ``Trainer.fit`` at dp 2 on phase 49's
    config and corpus for MOE_EP_STEPS steps; the all-to-alls (their ms,
    each synchronised on both sides, and MB) and the data-group gradient
    all-reduce (ms) timed per step."""
    from fleetx_tpu_torch.core import engine
    from fleetx_tpu_torch.parallel import moe

    cfg = moe_config(prefix, dp=2, steps=MOE_EP_STEPS)
    trainer = Trainer(cfg, build_module(cfg))
    trainer.init_state()
    spent = {"a2a_s": 0.0, "a2a_bytes": 0, "a2a_calls": 0,
             "all_reduce_s": 0.0}
    exchange, reduce_sum = moe._exchange, engine.all_reduce_sum

    def timed_exchange(x, send, recv, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exchange(x, send, recv, group)
        torch.cuda.synchronize()
        spent["a2a_s"] += time.perf_counter() - t0
        spent["a2a_bytes"] += (x.numel() + out.numel()) * x.element_size()
        spent["a2a_calls"] += 1
        return out

    def timed_reduce(tensors, group=None, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce_sum(tensors, group=group, **kw)
        torch.cuda.synchronize()
        spent["all_reduce_s"] += time.perf_counter() - t0

    moe._exchange, engine.all_reduce_sum = timed_exchange, timed_reduce
    for name in fa.NAMES:
        fa.launches[name] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        trainer.fit(build_dataloader(cfg, "Train"))
        torch.cuda.synchronize()
    finally:
        moe._exchange, engine.all_reduce_sum = exchange, reduce_sum
    wall = time.perf_counter() - t0
    steps = trainer.step
    nbytes = moe_bytes(trainer)
    whole = nbytes["expert"] * trainer.ep_world
    return {"steps": steps, "backend": torch.distributed.get_backend(),
            "losses": [float(h["loss"]) for h in trainer.history],
            "grad_norms": [float(h["grad_norm"]) for h in trainer.history],
            "step_s": wall / steps,
            "a2a_ms_per_step": spent["a2a_s"] * 1e3 / steps,
            "a2a_mb_per_step": spent["a2a_bytes"] / 1e6 / steps,
            "a2a_calls_per_step": spent["a2a_calls"] / steps,
            "all_reduce_ms_per_step": spent["all_reduce_s"] * 1e3 / steps,
            "expert_bytes": nbytes["expert"], "expert_bytes_whole": whole,
            "dense_bytes": nbytes["dense"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": {n: fa.launches[n] for n in fa.NAMES}}


# --------------------------------------------------------------- phase 51-53

ERNIE_345M_CONFIG = os.path.join(
    ROOT, "configs/nlp/ernie/pretrain_ernie_base_345M_single_card.yaml")
ERNIE_TRAIN_STEPS = 12  # phase 52's steps at the yaml's full depth
VIT_TRAIN_STEPS = 6    # phase 53's steps (4 micro-batches each)
VIT_TRAIN_SAMPLES = 512  # phase 53's training set: 2 steps an epoch
ENCODER_EVAL_ITERS = 2  # phase 53's evaluation: 2 Eval batches of 256
ENCODER_E2E_LAYERS = 2  # the kernel-vs-plain steps' depth, fp32
VIT_E2E_BATCH = 64      # phase 53(b)'s one micro-batch
# phases 52(b) and 53(b), one fp32 train step through B1-B3 against their
# plain versions (same weights, batch and draws): loss (absolute), grad
# norm and the worst gradient leaf (relative L2)
ENCODER_E2E_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "grad_leaf": 1e-4}
# phase 51's B2/B3 cases: (heads, sequence, dropout) at the two drives'
# shapes, head dim 64, batch 64, bf16; ERNIE's key lengths come from
# ErnieDataset samples, ViT's are its 197 tokens padded to the tile
ENCODER_BWD = {"ernie": (16, 512, 0.1), "vit": (12, 256, 0.0)}
ENCODER_BWD_BATCH = 64


def write_ernie_corpus(prefix: str, tokens: int = 200_000,
                       seed: int = 10) -> None:
    """:func:`write_corpus`'s documents with every id moved past ERNIE's
    special ids (pad 0, CLS 1, SEP 2, MASK 3), as ``ErnieDataset`` reads
    them."""
    write_corpus(prefix, tokens=tokens, seed=seed)
    ids = np.load(prefix + "_ids.npy")
    np.save(prefix + "_ids.npy", ids + np.int32(4))


def ernie_overrides(prefix: str, *extra) -> list:
    """Overrides of the ERNIE-345M single-card config (its width, depth,
    batch 64 and sequence 512) over the corpus at ``prefix`` (4,096
    samples drawn from its documents): a one-step warmup and a learning
    rate at which the loss moves within the drive."""
    return [own_output_dir(prefix), f"Data.Train.dataset.input_dir={prefix}",
            "Data.Train.dataset.num_samples=4096",
            f"Engine.max_steps={ERNIE_TRAIN_STEPS}", "Engine.logging_freq=1",
            "Optimizer.lr.warmup=1", "Optimizer.lr.max_lr=5.0e-4",
            "Optimizer.lr.total_steps=1000", *extra]


def vit_overrides(prefix: str, *extra) -> list:
    """Overrides of ``vit_base_patch16_224.yaml`` (its width, depth, global
    batch 256 in 4 micro-batches of 64) for a short drive: VIT_TRAIN_SAMPLES
    synthetic images seen once an epoch (random labels: what six steps can
    learn is to fit the images they saw before), a learning rate schedule
    without warmup, one evaluation at the last step over ENCODER_EVAL_ITERS
    Eval batches (the same images: the synthetic set draws by index)."""
    return [own_output_dir(prefix), f"Engine.max_steps={VIT_TRAIN_STEPS}",
            f"Data.Train.dataset.num_samples={VIT_TRAIN_SAMPLES}",
            f"Engine.num_train_epochs={VIT_TRAIN_STEPS}",
            "Engine.logging_freq=1", f"Engine.eval_freq={VIT_TRAIN_STEPS}",
            f"Engine.eval_iters={ENCODER_EVAL_ITERS}",
            "Optimizer.lr.warmup_epochs=0", "Optimizer.lr.learning_rate=1.0e-3",
            *extra]


def ernie_lengths(prefix: str, n: int) -> list:
    """The key lengths (non-pad tokens) of ``n`` samples of the 345M
    config's ``ErnieDataset`` over the corpus at ``prefix``."""
    from fleetx_tpu_torch.data import build_dataset

    cfg = get_config(ERNIE_345M_CONFIG, overrides=ernie_overrides(prefix),
                     nranks=1)
    ds = build_dataset(cfg.Data.Train.dataset, seed=cfg.Global.seed)
    return [int((ds[i]["input_ids"] != 0).sum()) for i in range(n)]


def encoder_bwd_bound(name: str, b: int, s: int, h: int, d: int, lens,
                      nbytes_el: int) -> tuple:
    """(bytes, flops) of one B2 or B3 call in the encoders' mode: q and
    dO read over all s rows, k and v over each row's live keys only, lse
    and delta rows read, dQ (or dK and dV, every key row) written once; 3
    (dQ) or 4 (dK/dV) products of 2·d flops over the s × kv_lens[b] live
    (query, key) pairs of each row."""
    live = sum(int(n) for n in lens)
    rows = b * s * h * d * nbytes_el
    keys = live * h * d * nbytes_el
    stats = 2 * b * h * s * 4
    pairs = 2 * h * d * s * live
    if name == "flash_bwd_dq":
        return 3 * rows + 2 * keys + stats, 3 * pairs
    return 4 * rows + 2 * keys + stats, 4 * pairs


def library_masked_bwd_ms(sets, kv) -> float:
    """SDPA's backward (dQ, dK and dV in one call) on the same masked
    function as a yardstick (never used by the port): each set's q, k, v
    and dO in [b, h, s, d], the key lengths as a boolean key mask, dropout
    0, non-causal."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    s = sets[0][0].shape[1]
    mask = (torch.arange(s, device=kv.device)[None] < kv[:, None].long())[
        :, None, None, :]
    runs = []
    for q, k, v, do in sets:
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        runs.append((sdpa(qt, kt, vt, attn_mask=mask), (qt, kt, vt),
                     do.transpose(1, 2).contiguous()))
    it = iter(range(1 << 30))

    def call():
        out, inputs, dot = runs[next(it) % len(runs)]
        torch.autograd.grad(out, inputs, dot, retain_graph=True)

    return cuda_ms(call, iters=20, warmup=2)


def phase_encoder_bwd(prefix: str) -> dict:
    """Phase 51: B2 (dQ) and B3 (dK/dV) in the encoders' training mode,
    non-causal with per-row ``kv_lens``, bf16, head dim 64, batch 64, at
    ERNIE-345M's shape (16 heads, s 512, dropout 0.1, the key lengths of
    64 ``ErnieDataset`` samples) and ViT-B/16's (12 heads, its 197 tokens
    padded to 256, dropout 0), each against its plain version within
    FLASH_TOL and launched twice with equal bits; ``kv_lens`` one short,
    another dropout seed (ERNIE) and ``causal`` flipped must each break
    the limit. Kernel, plain, SDPA-backward and bound times. Returns the
    records by kernel name and case."""
    bf16, d, b = torch.bfloat16, 64, ENCODER_BWD_BATCH
    atol, rtol = fa.FLASH_TOL[bf16]
    records = {"flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    lens_by_case = {"ernie": ernie_lengths(prefix, b), "vit": [197] * b}
    for label, (h, s, rate) in ENCODER_BWD.items():
        lens = lens_by_case[label]
        sets = flash_inputs(bf16, b=b, s=s, h=h, d=d)
        kv = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
        kw = dict(causal=False, kv_lens=kv, dropout_rate=rate,
                  seed=-24681357)
        before = dict(fa.launches)
        state = []
        for q, k, v, do in sets:
            out, lse = fa.flash_fwd(q, k, v, **kw)
            state.append((out, lse, flash_delta(do, out)))
        q, k, v, do = sets[0]
        _, lse, delta = state[0]
        args = (q, k, v, do, lse, delta)
        got = {"flash_bwd_dq": (fa.flash_bwd_dq(*args, **kw),),
               "flash_bwd_dkv": fa.flash_bwd_dkv(*args, **kw)}
        again = {"flash_bwd_dq": (fa.flash_bwd_dq(*args, **kw),),
                 "flash_bwd_dkv": fa.flash_bwd_dkv(*args, **kw)}
        torch.cuda.synchronize()
        want = {"flash_bwd_dq": (fa.flash_bwd_dq_ref(*args, **kw),),
                "flash_bwd_dkv": fa.flash_bwd_dkv_ref(*args, **kw)}
        faults = {"kv_lens - 1": dict(kw, kv_lens=(kv - 1).clamp_min(0)),
                  "causal flipped": dict(kw, causal=True)}
        if rate:
            faults["seed + 1"] = dict(kw, seed=kw["seed"] + 1)
        fns = {"flash_bwd_dq": lambda *a, **k: (fa.flash_bwd_dq(*a, **k),),
               "flash_bwd_dkv": fa.flash_bwd_dkv}
        plains = {"flash_bwd_dq": fa.flash_bwd_dq_ref,
                  "flash_bwd_dkv": fa.flash_bwd_dkv_ref}

        def ratio(outs, wants):
            return max(_tol_ratio(o, w, atol, rtol)
                       for o, w in zip(outs, wants))

        it = iter(range(1 << 30))

        def pick():
            i = next(it) % len(sets)
            return sets[i] + state[i][1:]

        library_ms = library_masked_bwd_ms(sets, kv)
        for name in records:
            worst = ratio(got[name], want[name])
            err = max(_max_err(o, w) for o, w in zip(got[name], want[name]))
            same = all(torch.equal(x, y)
                       for x, y in zip(got[name], again[name]))
            planted = {f: ratio(fns[name](*args, **fkw), want[name])
                       for f, fkw in faults.items()}
            kernel_ms = cuda_ms(lambda: fns[name](*pick(), **kw), iters=20,
                                warmup=3)
            plain_ms = cuda_ms(lambda: plains[name](*pick(), **kw), iters=2,
                               warmup=1)
            nbytes, flops = encoder_bwd_bound(name, b, s, h, d, lens, 2)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / PEAK_FLOPS[bf16] * 1e3
            bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
            log("encoder-bwd", name=name, case=label, batch=b, seq=s,
                heads=h, head_dim=d, dropout=rate,
                kv_lens_min=min(lens), kv_lens_max=max(lens),
                kv_lens_mean=float(np.mean(lens)), max_abs_err=err,
                tol_ratio=worst, twice_equal=same, planted_tol_ratio=planted,
                kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by=bound_by, bound_share=max(bytes_ms, ops_ms)
                / kernel_ms, tflops=flops / kernel_ms * 1e-9)
            if not (worst <= 1.0 and same and all(
                    torch.isfinite(o.float()).all() for o in got[name])):
                raise AssertionError(f"{name} {label}: {worst} x the limit, "
                                     f"twice equal {same}")
            for fault, wrong in planted.items():
                if not wrong > 1.0:
                    raise AssertionError(f"{name} {label}: the planted "
                                         f"fault {fault!r} is held within "
                                         f"the limit ({wrong})")
            records[name][label] = {
                "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms), "bound_by": bound_by,
                "library_ms": library_ms}
        fa.launches.update(before)  # checks and timing are not the path
        del sets, state, got, again, want
        torch.cuda.empty_cache()
    return records


def timed_fit(trainer, loader, valid=None) -> dict:
    """``trainer.fit(loader, valid)`` with an event at the end of each
    step's work on the stream and the host seconds each step waited on
    the loader; the flash launch counts of the run (zeroed first)."""
    ends, waits = [], []
    inner = trainer.train_step

    def timed(batch):
        out = inner(batch)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        return out

    class Timed:  # the loader, each fetch timed
        batch_sampler = loader.batch_sampler
        dataset = loader.dataset

        def __iter__(self):
            it = iter(loader)
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                waits.append(time.perf_counter() - t0)
                yield batch

    trainer.train_step = timed
    torch.cuda.reset_peak_memory_stats()
    for name in fa.NAMES:
        fa.launches[name] = 0
    t0 = time.perf_counter()
    trainer.fit(Timed(), valid)
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0,
            "step_ms": [a.elapsed_time(b) for a, b in zip(ends, ends[1:])],
            "waits_s": waits, "launches": {n: fa.launches[n]
                                           for n in fa.NAMES},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def encoder_faults(attention_dropout: bool) -> dict:
    """Kernel-path faults phases 52(b) and 53(b) must catch, each a wrapper
    swapped in at run time: B1 and B3 given one key fewer a row, B2 run
    causal; under attention dropout also phase 8's (a kernel given seed +
    1, dV without the keep mask)."""
    fwd, dq, dkv = fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv

    def shorter(fn):
        return lambda *a, **kw: fn(*a, **{
            **kw, "kv_lens": (kw["kv_lens"] - 1).clamp_min(0)})

    faults = {"B1 kv_lens - 1": {(fa, "flash_fwd"): shorter(fwd)},
              "B2 causal": {(fa, "flash_bwd_dq"): lambda *a, **kw: dq(
                  *a, **{**kw, "causal": True})},
              "B3 kv_lens - 1": {(fa, "flash_bwd_dkv"): shorter(dkv)}}
    if attention_dropout:
        faults.update(planted_faults())
    return faults


def encoder_e2e(label: str, cfg, batch, layers: int,
                attention_dropout: bool) -> None:
    """Phases 52(b) and 53(b): one fp32 train step of ``cfg`` on ``batch``
    through B1-B3 and through their plain versions (fresh trainers, the
    same seeded weights and draws): within ENCODER_E2E_TOL; each planted
    kernel fault of :func:`encoder_faults` must exceed it in at least one
    metric."""
    ref = _e2e_step(cfg, batch, PLAIN_FLASH)
    run = _e2e_step(cfg, batch)
    gaps = _e2e_gaps(run, ref)
    log(label, layers=layers, dtype="float32", loss_kernel=run[0],
        loss_plain=ref[0], grad_norm_kernel=run[1], grad_norm_plain=ref[1],
        tol=ENCODER_E2E_TOL, **gaps)
    over = [m for m, tol in ENCODER_E2E_TOL.items() if not gaps[m] <= tol]
    if over or not (math.isfinite(run[0]) and math.isfinite(run[1])):
        raise AssertionError(f"{label}: kernels vs plain versions {gaps}")
    for name, fns in encoder_faults(attention_dropout).items():
        gaps = _e2e_gaps(_e2e_step(cfg, batch, fns), ref)
        caught = [m for m, tol in ENCODER_E2E_TOL.items() if gaps[m] > tol]
        log(label, planted_fault=repr(name), caught=caught, **gaps)
        if not caught:
            raise AssertionError(f"{label} misses the planted fault "
                                 f"{name!r}: {gaps}")
    del ref, run
    gc.collect()
    torch.cuda.empty_cache()


def encoder_train_log(label: str, trainer, cfg, run: dict, samples: int,
                      unit: str, per_sample: int) -> dict:
    """Log a drive's step times, rates, MFU and memory; returns the
    median step seconds and MFU."""
    # the first steps grow the allocator's pools: the later half of the
    # intervals is the steady pace; of it, the intervals whose batch was
    # ready (interval i runs from the end of step i to the end of step
    # i + 1, whose fetch is wait i + 1) are the device's pace
    intervals = run["step_ms"]
    half = len(intervals) // 2
    steady = float(np.median(intervals[half:])) * 1e-3
    fed = [ms for ms, wait in zip(intervals[half:], run["waits_s"][half + 1:])
           if wait < 1e-3]
    flops = trainer.module.model_flops_per_sample(trainer.n_params)
    peak = peak_flops(trainer.device)
    mfu = samples * flops / steady / peak
    log(label, card=repr(CARD.get("line")), steps=trainer.step,
        params_m=trainer.n_params / 1e6, batch=samples,
        step_ms=[round(x, 2) for x in run["step_ms"]],
        step_ms_median=steady * 1e3,
        **{f"{unit}_per_s": samples / steady},
        tokens_per_s=samples * per_sample / steady,
        flops_per_sample=flops, mfu=mfu,
        step_ms_fed_median=float(np.median(fed)) if fed else None,
        mfu_fed=(samples * flops / (np.median(fed) * 1e-3) / peak
                 if fed else None),
        fit_seconds=run["seconds"],
        loader_wait_s=[round(x, 4) for x in run["waits_s"]],
        loader_wait_s_median=float(np.median(run["waits_s"][1:])),
        peak_mem_gb=run["peak_gb"], launches=run["launches"])
    return {"step_s": steady, "mfu": mfu}


def phase_train_ernie(prefix: str) -> dict:
    """Phase 52: (a) ``Trainer.fit`` through ``build_module`` on
    ``pretrain_ernie_base_345M_single_card.yaml`` at full width and depth
    (24 layers, hidden 1024, 16 heads, vocab 40000, batch 64 of 512
    tokens, 80 masked slots, bf16, hidden and attention dropout 0.1, the
    right padding as key lengths) over ``ErnieDataset`` on a synthetic
    corpus, ERNIE_TRAIN_STEPS steps: every loss finite and falling, B1, B2
    and B3 once per layer per step; ``lm_loss``/``sop_loss``, step ms,
    tokens/s, MFU, peak memory and the loader's wait logged. (b) the
    config at ENCODER_E2E_LAYERS layers and fp32: one step through the
    kernels against the plain versions (:func:`encoder_e2e`). Returns the
    launches."""
    cfg = get_config(ERNIE_345M_CONFIG, overrides=ernie_overrides(prefix),
                     nranks=1)
    module = build_module(cfg)
    trainer = Trainer(cfg, module)
    trainer.init_state()
    ecfg = module.ernie_config
    run = timed_fit(trainer, build_dataloader(cfg, "Train"))
    steps, layers = trainer.step, ecfg.num_layers
    seq = cfg.Data.Train.dataset.max_seq_len
    losses = [float(h["loss"]) for h in trainer.history]
    log("train-ernie", layers=layers, hidden=ecfg.hidden_size,
        heads=ecfg.num_attention_heads, vocab=ecfg.vocab_size, seq=seq,
        dtype=str(ecfg.dtype).split(".")[-1],
        dropout=(ecfg.hidden_dropout_prob,
                 ecfg.attention_probs_dropout_prob),
        right_padded_inputs=ecfg.right_padded_inputs)
    rates = encoder_train_log("train-ernie", trainer, cfg, run,
                              cfg.Global.global_batch_size, "sequences", seq)
    log("train-ernie", losses=[round(x, 5) for x in losses],
        lm_loss=[round(float(h["lm_loss"]), 5) for h in trainer.history],
        sop_loss=[round(float(h["sop_loss"]), 5) for h in trainer.history],
        grad_norms=[round(float(h["grad_norm"]), 4)
                    for h in trainer.history])
    if steps != ERNIE_TRAIN_STEPS:
        raise AssertionError(f"train-ernie: {steps} steps")
    if run["launches"] != {n: steps * layers for n in fa.NAMES}:
        raise AssertionError(f"train-ernie: flash launches {run['launches']}"
                             f" over {steps} steps x {layers} layers")
    if not all(math.isfinite(x) for x in losses) or not (
            np.mean(losses[-2:]) < losses[0]):
        raise AssertionError(f"train-ernie: losses {losses}")
    del trainer, module
    gc.collect()
    torch.cuda.empty_cache()
    e2e = get_config(ERNIE_345M_CONFIG, overrides=ernie_overrides(
        prefix, f"Model.num_layers={ENCODER_E2E_LAYERS}",
        "Engine.mix_precision.use_pure_fp16=False"), nranks=1)
    encoder_e2e("train-ernie-e2e", e2e,
                next(iter(build_dataloader(e2e, "Train"))),
                ENCODER_E2E_LAYERS,
                e2e.Model.attention_probs_dropout_prob > 0)
    return {"launches": run["launches"], **rates}


def phase_train_vit(prefix: str) -> dict:
    """Phase 53: (a) ``Trainer.fit`` through ``build_module`` on
    ``vit_base_patch16_224.yaml`` at full width and depth (12 layers,
    hidden 768, 12 heads, 1000 classes, global batch 256 in 4 micro-batches
    of 64, bf16, drop path 0.1, mixup 0.8, label smoothing 0.1) on
    ``SyntheticClsDataset``, VIT_TRAIN_STEPS steps and one evaluation of
    ENCODER_EVAL_ITERS Eval batches: every loss finite and falling, B2 and
    B3 once per layer per micro-batch, B1 too and once per layer per
    evaluation batch; eval loss and accuracy (and the initial weights'
    on the same batches), step ms, images/s, MFU, peak memory and the
    loader's wait logged. (b) at ENCODER_E2E_LAYERS layers,
    fp32 and one micro-batch of VIT_E2E_BATCH images: one step through the
    kernels against the plain versions (:func:`encoder_e2e`). Returns the
    launches."""
    cfg = get_config(VIT_CONFIG, overrides=vit_overrides(prefix), nranks=1)
    module = build_module(cfg)
    trainer = Trainer(cfg, module)
    trainer.init_state()
    vcfg = module.vit_config
    micro = trainer.accumulate_steps
    # the initial weights on the evaluation's batches (not the path: the
    # fit's launches are counted from zero)
    eval_before = trainer.evaluate(build_dataloader(cfg, "Eval"))
    evals, evaluate = [], trainer.evaluate

    def recorded(data, epoch=0):
        evals.append(evaluate(data, epoch=epoch))
        return evals[-1]

    trainer.evaluate = recorded
    run = timed_fit(trainer, build_dataloader(cfg, "Train"),
                    build_dataloader(cfg, "Eval"))
    steps, layers = trainer.step, vcfg.num_layers
    losses = [float(h["loss"]) for h in trainer.history]
    log("train-vit", layers=layers, hidden=vcfg.hidden_size,
        heads=vcfg.num_attention_heads, classes=vcfg.num_classes,
        tokens=vcfg.num_patches + 1, micro_batches=micro,
        dtype=str(vcfg.dtype).split(".")[-1],
        drop_path=vcfg.drop_path_rate, mixup=module.mixup_alpha,
        label_smoothing=module.label_smoothing)
    rates = encoder_train_log("train-vit", trainer, cfg, run,
                              cfg.Global.global_batch_size, "images",
                              vcfg.num_patches + 1)
    eval_after = evals[-1] if len(evals) == 1 else math.nan
    log("train-vit", losses=[round(x, 5) for x in losses],
        acc=[round(float(h["acc"]), 5) for h in trainer.history],
        grad_norms=[round(float(h["grad_norm"]), 4)
                    for h in trainer.history],
        eval_loss_before=eval_before, eval_loss=eval_after,
        eval=trainer.eval_metrics)
    want = {n: steps * micro * layers for n in fa.NAMES}
    want["flash_fwd"] += ENCODER_EVAL_ITERS * layers
    if steps != VIT_TRAIN_STEPS or run["launches"] != want:
        raise AssertionError(f"train-vit: {steps} steps, flash launches "
                             f"{run['launches']} (want {want})")
    if not all(math.isfinite(x) for x in losses) or not (
            np.mean(losses[-2:]) < losses[0]):
        raise AssertionError(f"train-vit: losses {losses}, eval loss "
                             f"{eval_before} -> {eval_after}")
    if not math.isfinite(trainer.eval_metrics.get("acc", math.nan)):
        raise AssertionError(f"train-vit: eval {trainer.eval_metrics}")
    del trainer, module
    gc.collect()
    torch.cuda.empty_cache()
    e2e = get_config(VIT_CONFIG, overrides=vit_overrides(
        prefix, f"Model.num_layers={ENCODER_E2E_LAYERS}",
        "Engine.mix_precision.use_pure_fp16=False",
        f"Global.local_batch_size={VIT_E2E_BATCH}",
        f"Global.micro_batch_size={VIT_E2E_BATCH}"), nranks=1)
    encoder_e2e("train-vit-e2e", e2e,
                next(iter(build_dataloader(e2e, "Train"))),
                ENCODER_E2E_LAYERS, bool(e2e.Model.get("attn_drop_rate")))
    return {"launches": run["launches"], **rates}


# torch._dynamo, torch.distributed.fsdp and torch.distributed.tensor are
# imported lazily by a Trainer's set-up: most of a spawned rank's start
# where the sources compile anew in every process
FORKSERVER_PRELOAD = ("numpy", "torch", "torch.distributed",
                      "torch._dynamo", "torch.distributed.fsdp",
                      "torch.distributed.tensor",
                      "fleetx_tpu_torch.core.engine",
                      "fleetx_tpu_torch.data", "fleetx_tpu_torch.models",
                      "fleetx_tpu_torch.parallel.env",
                      "fleetx_tpu_torch.tools.train")


def share_bytecode(where: str) -> subprocess.Popen:
    """Let the interpreters this script starts (the fork server, the CLI
    launches) read compiled bytecode under ``where``, and start the one
    that writes it: a fresh interpreter importing FORKSERVER_PRELOAD.
    Where ``PYTHONDONTWRITEBYTECODE`` is set, each fresh interpreter
    compiles torch's sources anew; the fork server inherits this
    process's ``-B``, so it reads the cache but writes none."""
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = where
    return subprocess.Popen(
        [sys.executable, "-c", "import " + ", ".join(FORKSERVER_PRELOAD)],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    adopt_orphans()
    bytecode = tempfile.mkdtemp(prefix="pycache-")
    writer = share_bytecode(bytecode)
    # the multi-rank drives fork their ranks from one server that has
    # imported torch and the port once (a fresh interpreter per rank
    # spent most of its start on those imports)
    launch.use_forkserver(FORKSERVER_PRELOAD)
    try:
        records, device = run_phases()
    finally:
        launch.stop_forkserver()
        writer.wait()
        left = stop_descendants()
        shutil.rmtree(bytecode, ignore_errors=True)
    log("processes", left_at_end=left)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


def run_phases() -> tuple:
    """Every phase in turn; returns the kernels' records and the device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profile = "--profile" in sys.argv[1:]
    device = phase_device()
    phase_build()
    kernel = phase_kernel()
    engine, cfg = build_engine()
    served = phase_serving(engine, cfg)
    kernel["launches"] = served["launches"]
    if profile:
        phase_profile(engine, cfg)
    del engine
    phase_e2e(cfg)
    torch.cuda.empty_cache()
    flash = phase_flash()
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "corpus")
        write_corpus(prefix)
        for name, counts in phase_train(prefix, profile).items():
            flash[name].update(counts)
        gc.collect()  # the drive's trainer (and its optimizer state)
        torch.cuda.empty_cache()
        phase_train_e2e(prefix)
    gc.collect()
    torch.cuda.empty_cache()
    decode = phase_decode_kernels()
    for name, counts in phase_generate(profile).items():
        decode[name].update(counts)
    decode["paged_decode_q8"].update(
        phase_int8_serving(served["kv_cache_bytes"]))
    gc.collect()
    torch.cuda.empty_cache()
    serving_params = init_params(cfg, seed=0)
    slot = phase_slot_serving(serving_params, cfg)
    chunked = phase_chunked(serving_params, cfg)
    spec = phase_spec(serving_params, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    tiers = phase_tiers(serving_params, cfg)
    roles = phase_roles(serving_params, cfg)
    recovered = phase_recovery(serving_params, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    meshed = phase_mesh(serving_params, cfg)
    int8_weights = phase_int8_weights(serving_params, cfg)
    phase_obs(serving_params, cfg)
    del serving_params
    gc.collect()
    torch.cuda.empty_cache()
    kernel["launches_fleet"] = phase_fleet(cfg)["paged_decode"]
    phase_serve_cli()
    encoder = {}
    flash["flash_fwd"]["launches_ernie"] = phase_ernie(encoder)["launches"]
    flash["flash_fwd"]["launches_vit"] = phase_vit()["launches"]
    hetero = phase_hetero(cfg)
    kernel["launches_hetero"] = hetero["paged_decode"]
    flash["flash_fwd"]["launches_hetero"] = hetero["flash_fwd"]
    for label, rec in encoder.items():  # B1 at the encoder shapes
        flash["flash_fwd"][label] = rec
    kernel.update(meshed["paged_decode"])
    kernel.update(int8_weights["paged_decode"])
    for name in ("decode", "decode_q8", "paged_decode_q8"):
        decode[name].update(meshed.get(name, {}))
        decode[name].update(int8_weights.get(name, {}))
    kernel["launches_tiers"] = tiers["launches"]
    kernel["launches_roles"] = roles["paged_decode"]
    kernel["launches_recovery"] = recovered["paged_decode"]["launches_recovery"]
    decode["paged_decode_q8"]["launches_roles"] = roles["paged_decode_q8"]
    for name in ("decode", "decode_q8", "paged_decode_q8"):
        decode[name].update(recovered[name])
    kernel["launches_chunked"] = chunked["paged_decode"]["launches"]
    kernel.update(spec["paged_decode"])
    decode["decode"]["launches_slot"] = slot["decode"]["launches"]
    decode["decode"]["launches_chunked_slot"] = chunked["decode"]["launches"]
    decode["decode"].update(spec["decode"])
    decode["decode_q8"]["launches_slot"] = slot["decode_q8"]["launches"]
    decode["paged_decode_q8"].update(spec["paged_decode_q8"])
    gc.collect()
    torch.cuda.empty_cache()
    ce_records = phase_ce()
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "corpus")
        write_corpus(prefix, tokens=800_000, seed=1)
        counts = phase_train_13b(prefix, profile)
        for name in ce.NAMES:
            ce_records[name]["launches"] = counts[name]
        for name in fa.NAMES:
            flash[name]["launches_1_3b"] = counts[name]
        gc.collect()  # the drive's trainer (and its optimizer state)
        torch.cuda.empty_cache()
        phase_train_13b_e2e(prefix)
    gc.collect()
    torch.cuda.empty_cache()
    cp_records = phase_cp_kernels()
    phase_cp_ring()
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "corpus")
        write_corpus(prefix, tokens=800_000, seed=2)
        for name, counts in phase_train_cp(prefix).items():
            cp_records[name].update(counts)
        phase_train_cp_e2e(prefix)
    vp_records = phase_mp_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "corpus")
        # ids spread over the vocab (stride 24: up to 49128), so that about
        # half of the labels lie on each vocab shard
        write_corpus(prefix, tokens=800_000, seed=3, stride=24)
        counts = phase_train_mp(prefix)
        for name in ce.VP_NAMES:
            vp_records[name]["launches"] = counts[name]
        for name in fa.NAMES:
            flash[name]["launches_mp"] = counts[name]
        phase_train_mp_e2e(prefix)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "corpus")
        write_corpus(prefix, tokens=800_000, seed=4)
        resume = phase_resume_13b(prefix)
        for name in ce.NAMES:
            ce_records[name]["launches_resume_1_3b"] = resume[name]
        for name in fa.NAMES:
            flash[name]["launches_resume_1_3b"] = resume[name]
        drop_output_dirs(prefix)
        phase_preempt(prefix)
        drop_output_dirs(prefix)
        phase_sentry(prefix)
        drop_output_dirs(prefix)
        phase_resume_mp(prefix)
        drop_output_dirs(prefix)
        phase_train_pp_e2e(prefix)
        drop_output_dirs(prefix)
        for name, count in phase_train_pp(prefix).items():
            flash[name]["launches_pp"] = count
        drop_output_dirs(prefix)
        phase_resume_pp(prefix)
    gc.collect()
    torch.cuda.empty_cache()
    flash_67b, ce_67b = phase_kernels_67b()
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "corpus")
        write_corpus(prefix, tokens=800_000, seed=5)
        counts = phase_train_zero(prefix)
        for name, rec in flash_67b.items():
            flash[name]["6.7b"] = dict(rec, launches=counts[name])
        for name, rec in ce_67b.items():
            ce_records[name]["6.7b"] = dict(rec, launches=counts[name])
        drop_output_dirs(prefix)
        phase_elastic(prefix)
    gc.collect()
    torch.cuda.empty_cache()
    flash_175b, ce_175b = phase_kernels_175b()
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "corpus")
        write_corpus(prefix, tokens=800_000, seed=6)
        for label, counts in phase_switches_13b(prefix).items():
            for name in fa.NAMES:
                flash[name].setdefault("launches_per_step_save_sets", {})[
                    label] = counts[name]
        drop_output_dirs(prefix)
        gc.collect()
        torch.cuda.empty_cache()
        # ids spread over the 51200 rows (stride 24: up to 49128), so that
        # about half of the labels lie on each vocab shard
        prefix = os.path.join(tmp, "corpus_175b")
        write_corpus(prefix, tokens=800_000, seed=7, stride=24)
        per_step = phase_train_175b_sp(prefix)
    for name, rec in flash_175b.items():
        flash[name]["175b"] = dict(rec, launches=SP_STEPS * per_step[name],
                                   launches_per_step=per_step[name])
    for name in ce.VP_NAMES:
        vp_records[name]["175b"] = dict(
            ce_175b[VP_KERNEL[name]], launches=SP_STEPS * per_step[name],
            launches_per_step=per_step[name])
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "corpus")
        write_corpus(prefix, tokens=200_000, seed=9)
        moe = phase_moe(prefix)
        drop_output_dirs(prefix)
        moe_ep = phase_moe_ep(prefix, moe["losses"])
    for name in fa.NAMES:
        flash[name]["launches_moe"] = moe["launches"][name]
        flash[name]["launches_moe_ep_per_rank"] = moe_ep[name]
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "corpus")
        write_ernie_corpus(prefix, tokens=600_000)
        for name, cases in phase_encoder_bwd(prefix).items():
            flash[name]["encoders"] = cases
        ernie = phase_train_ernie(prefix)
        drop_output_dirs(prefix)
        vit = phase_train_vit(prefix)
    for name in fa.NAMES:
        flash[name]["launches_ernie_345m"] = ernie["launches"][name]
        flash[name]["launches_vit_b16"] = vit["launches"][name]
    records = [dict(name="paged_decode", route="cuda",
                    source="fleetx_tpu_torch/ops/csrc/decode_attention.cu",
                    replaces="fleetx_tpu/ops/pallas/decode_attention.py:465",
                    **kernel)]
    source = "fleetx_tpu_torch/ops/csrc/flash_attention.cu"
    replaces = {"flash_fwd": 287, "flash_bwd_dq": 397, "flash_bwd_dkv": 502}
    for name in fa.NAMES:
        records.append(dict(
            name=name, route="cuda", source=source,
            replaces=f"fleetx_tpu/ops/pallas/flash_attention.py:"
                     f"{replaces[name]}", **flash[name]))
    replaces = {"decode": 243, "decode_q8": 329, "paged_decode_q8": 479}
    for name in ("decode", "decode_q8", "paged_decode_q8"):
        records.append(dict(
            name=name, route="cuda",
            source="fleetx_tpu_torch/ops/csrc/decode_attention.cu",
            replaces=f"fleetx_tpu/ops/pallas/decode_attention.py:"
                     f"{replaces[name]}", **decode[name]))
    replaces = {"ce_fwd": 86, "ce_dh": 119, "ce_dw": 150}
    for name in ce.NAMES:
        records.append(dict(
            name=name, route="cuda",
            source="fleetx_tpu_torch/ops/csrc/ce_loss.cu",
            replaces=f"fleetx_tpu/ops/pallas/ce_loss.py:{replaces[name]}",
            **ce_records[name]))
    replaces = {"block_fwd_lse": 820, "block_dq": 836, "block_dkv": 852}
    for name in fa.BLOCK_NAMES:
        records.append(dict(
            name=name, route="cuda", source=source,
            replaces=f"fleetx_tpu/ops/pallas/flash_attention.py:"
                     f"{replaces[name]}", **cp_records[name]))
    for name in ce.VP_NAMES:  # B12: B4-B6 on a vocab shard (_vp_stats)
        records.append(dict(
            name=name, route="cuda",
            source="fleetx_tpu_torch/ops/csrc/ce_loss.cu",
            replaces="fleetx_tpu/ops/pallas/ce_loss.py:298",
            **vp_records[name]))
    for record in records:  # the bf16 path's CUDA kernels of each entry
        record["cuda_kernels"] = CUDA_KERNELS[record["name"]]
    return records, device


if __name__ == "__main__":
    sys.exit(main())
