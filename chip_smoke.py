"""Drive the PyTorch/CUDA port's serving paths on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. Device: a CUDA card is required; prints its name and power limit and
   turns TF32 off for float32 products and convolutions.
2. Build: compiles the CUDA kernels from tensorlink_tpu_torch/ops/csrc/
   (one nvcc per source, started together) into build/tensorlink_tpu_torch/.
3. Kernels: each kernel over full-precision, int8 and packed-int4 pages,
   and paged_prefill_attention, against its plain PyTorch version at the
   main path's shapes and at small edge cases (float32 rtol = atol =
   2e-5; bfloat16 q compared in float32 at 1.6e-2); a known-answer check
   of the int4 split-half nibble order inside the kernels; the ragged
   kernel's bf16 rows bitwise equal however a chunk is framed (chunks of
   1 to 88 positions: narrow and wide tiles); paged_attention's rows
   bitwise equal to the ragged kernel's rows at the same positions, in a
   decode slot, verify slots of 4 and 9 positions (3 and 8 drafts) and a
   128-row prefill chunk, bf16 and
   f32, every page format (decode_rows_check); then each
   variant timed at the main path's shape in bfloat16 (kernel_ms and
   library_ms eager: median of 30 calls between CUDA events, the host
   work of each call included; device_ms and library_device_ms: 10 calls
   captured in a CUDA graph, median of 30 replays) beside its plain
   version, torch's
   scaled_dot_product_attention over pre-gathered KV where one call
   computes the same function, and its bound on the card. The flash
   kernel likewise: against its plain version on the main shape (B 4, T
   2048, Hq 16, Hkv 8, hd 128), tests/test_ops.py's shapes, three sliding
   windows, T 100 and 37 and head_dim 64 and 256; timed at the main shape
   beside one causal GQA scaled_dot_product_attention call. bfloat16 runs
   the tensor-core bodies of flash and of the ragged kernel, whose one-row
   launch paged_attention is (also at head_dim 16, test_ops.py's MQA and
   prefill shapes), float32 the scalar bodies.
4. Step parity: qwen3-0p6b at full width in float32, three
   paged_ragged_step chunks on a mixed block with the kernels and with
   their plain versions, over fp, int8 and int4 pages — counts and
   lengths equal; the logits of every draw made from equal tokens on
   both paths within a limit per page format, and tokens equal (int4: a
   slot's tokens may part only where the plain logits' top two lie
   within that limit); every layer, fed the same input on both paths,
   within rtol = atol = 2e-5 on its output and with byte-equal quantized
   pages and scales (fp pages within 2e-5); free running, fp pages within
   4 times that bound and quantized codes within 1 of each other.
5. Serving: qwen3-0p6b at full width in bfloat16 behind a
   ContinuousBatcher, three runs of the same 8 requests from 4 threads
   — fp pages, int8 pages, and int8 weights over int4 pages — each with the kernels' launch counts checked against
   the chunks run and all in the run's page format, the plain versions
   never called, the prefix cache hit, pages conserved, and a greedy
   request re-run alone equal to its co-batched stream.
6. Dense parity: qwen3-0p6b at full width in float32 with
   flash_attention on, GenerationEngine's prefill of two prompts through
   the flash kernel and through its plain version — every layer from the
   same input within rtol = atol = 2e-5, last-token logits within a limit
   set from readings — and greedy generate_compiled, beam and lookahead
   token-equal on both paths. Then bf16 parity: qwen3-0p6b in bfloat16,
   the tensor-core bodies on real activations: one ragged chunk's layers
   over MAIN's mixed block (fp pages), one decode step of its slots after
   it, and one flash prefill of two prompts, each layer's attention
   output from the kernel against the
   plain version's on the same inputs, per row max |diff| within 1.6e-2
   x the row's max |plain|; a planted off-by-one mask must fail that.
7. Dense serving: qwen3-0p6b at full width in bfloat16 with
   flash_attention on: generate_compiled and generate_chunked (equal
   tokens) on 8 mixed greedy/sampled requests, a 3000-token prompt
   (chunked prefill), beam, lookahead, and an int8 weights + int8 dense
   cache engine; the flash kernel's launches equal n_layers x the flash
   prefills the engines counted, and no plain attention runs.

8. The rest of the single-card engine, qwen3-0p6b in bfloat16 at full
   width and MODEL_LAYERS (14) of its 28 layers (spec serving at all
   28), every engine on the CUDA kernels (each phase resets the
   counts, then checks one ragged launch a layer per chunk and
   chunk_steps - 1 decode launches, and no plain version): speculative
   serving over fp and int8 pages (16 requests, half repetitive, spec on
   and off: greedy streams equal or parted only at a near-tie, the plain
   top-two gap logged; drafts packed, more than one token per verify
   pass, verify slots of 8 drafts; tokens/s both ways as readings);
   migration over fp, int8 and int4 pages between two engines (a stream
   frozen mid-decode, shipped through the TLTS frame and adopted, equal
   to its uninterrupted run; nothing left in transit; int4 → int8
   refused), one prefill→decode handoff and a drain that sheds its queue;
   the host-RAM tier (a prefix churned out and promoted back) and one
   fleet pull; two tenants (bf16 and int8 weights) on one shared page
   pool, each equal to its solo runs within its quota; and a live weight
   publish mid-stream. gemm_rows reads whether a row's bits depend on the
   GEMM's height (also on the host: c.gemm_rows("cpu")).
9. Checkpoints: qwen3-0p6b (phase 8's seeded bf16 tree) written by the
   port's export_hf in 256 MiB shards with an index and an HF Qwen3
   config under build/checkpoints/, read back by load_params with no
   config given (the preset's config, every leaf bitwise; layers [10,
   14) alone equal that slice), its load time and rate printed beside
   the card's name and power limit, and 8 requests served through the
   kernels from the loaded tree token-equal to an engine over the source
   tree. Then mixtral-8x7b at full width and 2 of its 32 layers (seeded
   bf16, default 4 GiB shards), loaded back bitwise and served through
   the kernels over fp and int8 pages, a greedy request alone equal to
   its co-batched stream. In each of those runs the first chunk's ragged
   launches and the first live decode step's paged_attention launches
   (Hq 32, Hkv 8, hd 128, pages of 16) are held per layer against their
   plain versions on the same inputs, as bf16 parity (phase 6) holds
   them, with a planted fault above the bound (the ragged launch's own
   key masked; the decode launch's query heads over the next kv head).
   Each layer's dense-dispatch MoE MLP of one ragged chunk is held per
   row within 1.6e-2 x the row's max of a float32 reference that routes
   apart from the program (the plain router product, numpy's stable
   top-2 on the host, which ttr.top_k must match) and runs only each
   token's top-2 experts; a third expert's gate switched on reads above
   that bound, and the capacity dispatch at capacity factor E/K is
   within it of the dense dispatch. The checkpoints are deleted at the
   end of the phase.
10. The node path: a port ValidatorNode (HTTP endpoint) and WorkerNode
   on 127.0.0.1 (keys and logs under build/node/), the worker on the
   card. POST /request-model hosts qwen3-0p6b at full width (seeded
   bf16 weights, the default int8 KV pages) and 8 concurrent greedy
   /v1/generate requests (prompts of 64 to 1536 bytes, NODE_NEW (32) new
   tokens), a
   streamed /v1/chat/completions and a sampled request flow through the
   validator's remote ContinuousBatcher, GENERATE and TOKEN frames, and
   the worker's ContinuousEngine. Held: every request finishes; the
   worker engine made one ragged launch a layer per chunk and
   chunk_steps - 1 decode launches, in int8, and no plain version ran;
   each greedy request's tokens equal, and its HTTP text equals the text
   of, an in-process ContinuousBatcher over the same seeded tree with the
   worker's knobs; the streamed chat's deltas join to the plain run of
   the same request; neither node's network process maps a torch or jax
   library; /stats shows int8 pages of 59,136 bytes a position,
   /metrics carries tlink_engine_* and /healthz lists the model. Prints
   client tokens/s and request latency over HTTP, and the engine's
   first-token times (from /trace) beside the in-process run's: readings
   with the card's name and power limit, not claims.
11. Training, every step on the card in float32 with TF32 off unless
   named: one make_train_step(adamw, grad clip 1.0, remat) step of a
   seeded 2-layer tree at qwen3-0p6b's widths (B 2, T 64) on the card
   and on the host — loss within 1e-5 relative, grad_norm within 1e-4,
   each leaf's gradient within 1e-4 relative in its norm, and a
   gradient with one layer's wq gradient zeroed reading far above that;
   qwen3-0p6b at full depth: eight AdamW steps on one repeated batch (B
   4, T 256) cut the loss by more than 10%, n_micro 2 against 1 on that
   batch (loss 1e-5, grad_norm 1e-4), and bfloat16 steps at n_micro 2
   whose accumulated gradients are float32 (step ms, tokens/s and MFU
   against the datasheet peak as readings); a port validator, worker and
   user on 127.0.0.1 train DistributedModels of qwen3-0p6b's widths at
   4 layers, B 2, T 64, three steps each (the downloaded tree bitwise the seeded one
   before, losses within 1e-4 of make_train_step; after, under SGD with
   momentum every param within rtol 2e-4, atol 2e-5, and under AdamW
   each leaf within 2e-4 in its norm; the validator's proof verdict over
   3 steps equal to the one the same verification gives on sketches of
   the in-process gradients at the job's coordinates, each logged sketch
   within cosine 0.999 of its in-process one, a checkpoint restored bitwise and its next step's loss
   equal to the in-process loss of the snapshot, an HF export loaded
   back bitwise); and serve-and-train — a ContinuousBatcher over qwen3-0p6b
   in bf16 serves 8 interactive greedy requests in two waves while a
   ServeTrainLoop takes 4 AdamW steps between chunks and publishes
   twice: every stream full length, the kernels' launches per chunk,
   and a greedy request after the last publish equal to a fresh engine
   over the published tree.

12. Fleet serving and control-plane recovery: qwen3-0p6b at full width
   (seeded bf16, int8 pages, spec decoding off so a stream's bits do not
   depend on its neighbours), port validators and workers on 127.0.0.1,
   every worker's engine on the one card with a 16 GB share advertised
   (build/fleet/). A validator with fleet_replicas 2 and three workers:
   8 greedy /v1/generate requests route over both replicas (/fleet
   counts each); a POST /fleet/deploy of r0 under 8 live streams drains
   r0's worker onto r1's (at least one stream page-shipped) and rehosts
   r0 on the third worker, no stream dropped; then the validator crashes
   under 4 live streams, a new one restarts on its journal, re-attaches
   both replicas and each stream by its jrid. A second cluster, a
   prefill-role and a decode-role worker, hands every request over the
   wire (handoff counters nonzero). In each step every worker that
   served launched both paged kernels, in int8, one ragged launch a
   layer per chunk and chunk_steps - 1 decode launches, and no plain
   version ran. Every stream equals the same prompt alone on an
   in-process engine over the same tree, token for token; a stream that
   took the re-prefill rung may part only where the reference's top two
   logits lie within 0.0625 (logged). Prints HTTP tokens/s with two
   replicas beside phase 10's one, the drain's seconds, page bytes
   shipped and their rate, and the restarted validator's time to
   re-attach: readings with the card's name and power limit, not claims.
13. Pipeline stages and job repair (build/stages/): qwen3-0p6b at full
   width and depth, seeded bf16, every worker on the one card. A port
   validator (HTTP endpoint), three workers and a user; capacities
   pinned (checked with the planner) so the planner splits the model
   over workers 0 and 1, 14 layers each, with the tied head on stage 0
   (the head hop); worker 2 starts too small to be planned. The
   in-process reference is a worker's FORWARD handler holding the WHOLE
   model (its GenerationEngine, flash off: the einsum path the stages
   run) driven by DistributedModel's own pipelined loops — the stages'
   ops at the stages' shapes without the wire. (1) A forward of 4 x 64
   tokens through the worker-to-worker chain: logits per row within
   1.6e-2 of the row's max of the in-process forward's. (2) 8 prompts,
   32 new tokens, rows 0-3 greedy and 4-7 sampled, per-row budgets, in
   one generate: sampled rows token-equal to the reference, greedy rows
   to the reference and to generate_compiled, parting only where the
   reference's top two logits lie within SPEC_TIE (logged); the hidden
   bytes per decode step over the wire equal 2 hops x 8 rows x d_model x
   2 bytes; num_beams 4 and lookahead token-equal to the reference
   (lookahead also to vanilla greedy, up to a logged near-tie; beam
   against generate_beam as a reading). (3) ContinuousBatcher(model) in
   its pipelined mode, 2 slots, 4 requests admitted mid-flight: streams
   equal to step 2's, up to a logged near-tie. (4) A worker.session_step
   crash planted on worker 0 mid-stream: the slot set re-establishes on
   worker 2 and both streams finish equal to step 2's. (6) The validator
   hosts the model over workers 1 and 2 (two stages) and answers 2
   greedy /v1/generate requests, each equal to the reference. (5) A
   second cluster: a continuous stream's worker crashed at its second
   chunk (worker.cont_step) with a spare — both greedy streams equal an
   in-process ContinuousEngine's up to a logged near-tie, the kernels'
   launches counted per worker (_WorkerLaunches) — and a training job
   (2 layers at full width, f32, SGD with momentum, checkpoints every 2
   steps) whose worker crashes at its 4th optimizer step: it rolls back
   to the step-2 checkpoint on the spare, and every loss is within 1e-4
   of make_train_step's over the batches it really trained. Prints
   pipelined tokens/s beside single-stage in-process tokens/s, the
   hidden bytes per decode step, seconds from each crash to the first
   token after it and the training rollback's seconds: readings with
   the card's name and power limit, not claims.
14. Pipelined training and its repair (build/stages_train/): qwen3-0p6b
   at full width and STAGES_TRAIN_DEPTH (8) of its 28 layers, seeded
   f32, every worker on the one card. A
   port validator, four workers and a user; capacities pinned (checked
   with the training planner, which counts gradients and optimizer
   state) so the job splits 4/4 over two workers with the tied head on
   stage 0, n_micro 2, B 2, T 64. (1) Three AdamW steps with the
   micro-batches overlapped: each loss within 1e-4 (relative) of
   make_train_step's in process on the same tree, each leaf of the
   merged tree (the tied embedding, which both of stage 0's gradients
   reach, included) within 2e-4 in its norm, two micro-batches seen in
   flight. (2) From a checkpoint saved before step 1, the first two
   steps again with overlap off: losses within 1e-5 of the overlapped
   ones. (3) SGD with momentum, checkpoints every 2 steps, a
   worker.train_step crash planted on the stage-1 worker at its 4th
   optimizer step, after stage 0 applied it: the job repairs onto a
   spare, rolls both stages back and re-drives that step, each loss within
   1e-4 of the in-process chain over the batches it really trained, the
   params elementwise within rtol 2e-4, atol 2e-5. (4) The stage-0
   worker stopped between a micro-batch's FORWARD and its BACKWARD in
   step 3: stage 0 is re-shipped to a spare, both stages restore the
   step-2 checkpoint and the step is re-driven; every loss within 1e-4
   of the in-process chain. No kernel launches on the training path
   (asserted; the kernels line says 0). Prints the split step's seconds
   beside the in-process step's, the bytes of logits, hidden state and
   gradient shipped per step, the rollbacks' seconds, and the whole
   script's seconds, with the card's name and power limit: readings, not
   claims.
15. Tensor-parallel serving: qwen3-0p6b bf16 at full width and
   MODEL_LAYERS layers (phase 8's seeded tree) served at tensor_parallel=2 with both shards
   named on the one card (tp_devices=["cuda:0", "cuda:0"]; 8 query and 4
   kv heads a shard). (1) For fp, int8 and int4 pages, one ragged chunk
   over MAIN's block and one decode step after it through the tp step's
   forward: every shard's launch of each kernel bitwise equal to the
   same heads of one launch over both shards' heads joined, on the same
   inputs, and within the bf16 bound (1.6e-2 of each row's max) of its
   plain version; over fp pages each layer's output at tp=2 against the
   tp=1 forward's, a reading. (2) fp and then int8 pages: 8 requests of
   64 to 1024 tokens, TP_NEW (16) new tokens each (2 speculating, 3 greedy, 3
   sampled), on a tp=1 and a tp=2 engine of 8 slots: greedy streams
   equal or parted only where the tp=1 top-two gap is within SPEC_TIE
   (logged); per chunk exactly twice tp=1's launches of each kernel
   (launches_tp on the kernels line); every trie page both engines hold
   for the same tokens within 1.6e-2 of each layer's max (dequantized
   for int8); page conservation; tensor_parallel 2 in the snapshot; each
   shard's pages contiguous with n_kv / 2 heads and 57,344 (fp) or
   29,568 (int8) KV bytes per token at 28 layers (n_layers / 28 of it); a tp=2 migration export with a
   tp=1 export's shapes and dtypes. (3) Readings, not claims (both
   shards share one card, so tp=2 doubles the launches for no gain):
   tokens/s and ms per chunk at tp=2 and tp=1, and the card's busy share
   over 2 chunks inside profiling.trace for each engine.
16. The dense engine on a {data: 2, tensor: 2} mesh whose four devices
   are cuda:0, and ZeRO-1 (mesh_phase). (1) At phase 3's flash shape
   each (data, tensor) shard's flash_attention launch (B 2, Hq 8, Hkv
   4, contiguous pieces as the placed cache holds them) bitwise the same
   block of one launch over the whole, and within the bf16 bound of the
   plain version. (2) qwen3-0p6b bf16 at full width and
   MESH_SERVE_LAYERS (14) layers, flash on, placed by the Megatron partition_specs: 8 prompts of 256–2000
   tokens x 32 greedy tokens through generate_compiled, a beam of 4 over
   2 of them and lookahead over 2 repetitive prompts, then both engines
   at quant="int8+kv", against the unsharded GenerationEngine on the
   same tree: prefill logits within MESH_LOGITS_OF_ONE of the unsharded
   engine's and within 2x its distance from a float32 engine (per row,
   of the row's max); greedy streams and
   beams equal or parted only where the unsharded run's top-two (beam:
   selection) gap is within MESH_TIE (logged); with the counts zeroed
   before the sharded engines, exactly L x 4 flash launches a B=8
   prefill and L x 2 a B=1 one (rows replicated over data run once on
   the one card), no plain attention (launches_mesh on the kernels
   line). (3) qwen3-0p6b f32 at full width and MESH_TRAIN_LAYERS (8)
   layers, B 4, T 128, AdamW,
   two steps each of the unsharded n_micro=2 step, zero1 on {data: 2}
   and zero1 x tp on {data: 2, tp: 2}: loss, grad norm and every param
   bitwise equal, and each replica's optimizer bytes exactly what the
   specs give (about 1/2 and 1/4). (4) Readings, not claims: tokens/s
   sharded and unsharded, the steps' ms, optimizer bytes. mesh_cards()
   runs (2) over four distinct cards and a worker planned {data: 2,
   tensor: 2} over them (serving and 2 ZeRO-1 training steps through a
   DistributedModel).
17. ZeRO-3 training of a placed tree on an {fsdp, tensor} mesh whose
   four devices are cuda:0 (fsdp_phase). (1) Phase 16's qwen3-0p6b f32
   tree (full width, MESH_TRAIN_LAYERS layers, B 4, T 128, n_micro 2,
   AdamW) placed by
   partition_specs(fsdp_axis="fsdp") on {fsdp: 2, tensor: 2} and on
   {fsdp: 4}: two make_train_step(mesh=) steps each, the losses within
   FSDP_LOSS_RTOL, each leaf's gradient within FSDP_GRAD_RTOL and its
   params within FSDP_PARAM_RTOL of phase 16's unsharded step (in its
   norm); each device's params, gradients and optimizer state exactly a
   quarter of the split leaves plus the replicated ones; the first
   layout's two steps run twice, bitwise equal. (2) A validator, a worker
   with MLConfig(mesh_devices=["cuda:0"] * 4) and a user: a
   DistributedModel at 4 layers (B 2) asking parallelism {tensor: 2} is
   planned {tensor: 2, fsdp: 2}, trains two steps within
   TRAIN_NODE_LOSS_RTOL of the same placed step in process, and its
   checkpoint holds the job's trees joined on the host, bitwise, and its
   HF export loads back bitwise. No attention kernel runs (0 launches,
   asserted; launches_fsdp_training on the kernels line). (3) Readings,
   not claims: step ms per layout, and one step of each layout and of
   the unsharded step traced by torch.profiler (device launches, the
   card's busy share). fsdp_cards() runs (1) over four distinct cards
   and reads each card's peak memory against the unsharded step's.
18. Mixtral-8x7B at full width with its experts split over an expert
   mesh axis whose four devices are cuda:0 (expert_phase). (1) bf16, 2
   of its 32 layers, flash on, placed by partition_specs(
   expert_axis="expert") on {expert: 4} and {expert: 2, tensor: 2}: the
   GenerationEngine's dense dispatch (each expert shard's experts over
   every token, summed in shard order) over 8 prompts of 64–512 tokens x
   32 greedy tokens and a beam of 4 over 2 of them, held as phase 16
   holds its mesh engine against the unsharded engine on the same tree;
   with the counts zeroed, exactly layers x tensor shards flash launches
   a prefill (the expert shards on one card run attention once), no
   plain attention (launches_expert on the kernels line). (2) f32, 1
   layer, B 4, T 128, AdamW, two steps of the capacity-factor sparse
   dispatch on {expert: 4} against the unsharded sparse step: losses,
   gradients and params within phase 17's bounds, each device's params,
   gradients and optimizer state a quarter of the expert leaves plus the
   replicated rest, two placed runs bitwise, the sparse gradients at
   capacity factor E/K the dense dispatch's. (3) Readings, not claims:
   tokens/s and step ms, sharded and unsharded. expert_cards() runs (1)
   and (2) over four distinct cards with each card's peak memory, then a
   worker with MLConfig(mesh_devices=4) whose Mixtral jobs get the
   default {expert: 4} plan: static and beam requests and two training
   steps through a DistributedModel.
19. The stage and seq mesh axes and the quantized collectives
   (product_phase), qwen3-0p6b at full width, every mesh device cuda:0.
   (1) f32, AdamW, B 4, T 256, 28 layers placed by stage_param_specs on
   {stage: 4} (7 layers a stage device; the embedding, norm and head
   replicated): two make_train_step(mesh=) steps, each batch through the
   in-mesh GPipe (parallel/pipeline.py) in pp_n_micro micro-batches,
   against the unsharded step within phase 17's bounds (loss, each
   gradient leaf, the params); each device's params, gradients and
   optimizer state exactly a quarter of the layers beside the replicated
   rest; two runs bitwise. (2) f32, B 1, T 8192, SP_LAYERS layers: the
   unsharded stage_forward and the same stage over {seq: 4} (ring
   attention, parallel/ring.py), forward and gradients within
   SP_LOGITS_RTOL, SP_LOSS_RTOL and SP_GRAD_RTOL, two ring runs bitwise;
   layer 0's attention through the int8 ring within 0.06 of the exact
   ring's (tests/test_ring.py's bound), twice bitwise; each run's peak
   bytes. (3) A validator, a worker with MLConfig(mesh_devices=
   ["cuda:0"] * 2) and a user: DistributedModels at 4 layers asking
   parallelism {stage: 2} and then {seq: 2}, planned so; each one's
   forward equal to the in-process placed forward and two AdamW steps
   within TRAIN_NODE_LOSS_RTOL of the in-process placed step. No
   attention kernel runs on these training paths (0 launches, asserted;
   launches_product_training on the kernels line). (4) bf16, QTP_LAYERS
   layers, phase 15's requests over fp pages: a tp=2
   ContinuousEngine whose config sets collective_quant beside tp=1:
   every gather of a split activation int8 (counted), greedy streams
   equal or parted only where tp=1's top two lie within QTP_TIE
   (logged), twice tp=1's paged launches a chunk, no plain attention
   (launches_tp_quant on the kernels line). pipeline_cards() and
   seq_cards() run (1) and (2) over four distinct cards with each card's
   peak memory.
20. One mesh over two processes (coslice_phase, parallel/multihost.py),
   qwen3-0p6b at full width, f32. (1) Two member processes join one
   torch.distributed group over gloo (two ranks on one card: NCCL
   refuses that), each holding two positions on cuda:0 of a
   four-position mesh over the group's global device list; COSLICE_LAYERS
   layers, B 4, T 128, two AdamW steps on {fsdp: 2, tensor: 2} and on
   {tensor: 4} (make_train_step(mesh=)), after this process ran the same
   steps with all four positions its own while they started. Each member's losses and
   gradient norms bitwise the other's and this process's, each
   position's params (SHA-256 of its pieces) bitwise this process's;
   readings: step ms against one process, bytes each member sent a step.
   (2) A validator with co_slice_planning, two worker processes of one
   slice (each mesh_devices ["cuda:0"] * 2, joined at start) and a user:
   a COSLICE_NODE_LAYERS-layer job planned one merged stage with one
   coworker over four devices; its forward and three AdamW steps
   bitwise the same DistributedModel driver over a bare worker in this
   process, a checkpoint round trip bitwise, generate refused
   ("co-slice"). No attention kernel runs (0 launches, asserted).
   coslice_cards() runs (1) over two processes x two cards (NCCL) with
   each card's peak memory.
21. The slot engine over a tree placed on a planned mesh (placed_phase;
   engine/paged.py make_placed_ragged_step), every position cuda:0. (1)
   qwen3-0p6b bf16, MODEL_LAYERS layers placed by stage_param_specs on
   {tensor: 4}: one ragged chunk over MAIN's block and one decode step
   through the placed forward, each shard's launch of each kernel (2 kv
   heads, 4 query heads) bitwise the same heads of one launch over the
   joined shards and within the bf16 bound of its plain version. (2)
   qwen3-0p6b bf16 at full width and 28 layers through ContinuousEngine
   over the tree placed on {tensor: 4} (fp pages, int8 pages, fp with
   spec decoding) and on {fsdp: 2, tensor: 2} (fp), phase 15's 8
   requests x 32 tokens, each held against the unsharded slot engine in
   its page format: greedy streams equal or parted only at a logged
   near-tie (MESH_TIE, the Megatron rows), per chunk tensor x its
   launches of each kernel, no plain version, the pages both tries hold
   per layer within PLACED_PAGE_OF_BF16 x the unsharded engine's distance
   from a float32 engine's, the pages split by kv head over the first group's
   tensor shards with each position's KV bytes per token (0 off that
   group). (3) mixtral-8x7b bf16 at full width, 2 of 32 layers, on
   {expert: 4} through the slot engine (the dense dispatch) beside the
   unsharded one: 8 greedy prompts x 32, streams parted only at a logged
   near-tie or routing flip. (4) A validator, a worker with
   MLConfig(mesh_devices=["cuda:0"] * 4) and a user: a 4-layer job
   asking parallelism {tensor: 2, fsdp: 2}, its continuous GENERATEs
   answered by the job's slot engine (its chunks move, the dense engine
   is never called), the kernels once a shard a layer per chunk, tokens
   equal to an in-process placed slot engine with the worker's knobs.
   Readings: tokens/s and ms per chunk beside the unsharded engine's
   (launches_placed on the kernels line). placed_cards() runs (2)'s fp
   runs over four distinct cards with each card's peak memory.
22. Placed co-hosting and OLMo-2 (olmo_phase for (1), placed_pool_phase
   for (2) and (3)), every position cuda:0. (1) olmo2-7b bf16 at full width (32 heads and kv heads, hd
   128, qk_norm_full, post norm), OLMO_LAYERS (8) of 32 layers placed by
   stage_param_specs on {tensor: 4} (the JAX planner's axes for it on
   four devices): placed_kernel_check's per-shard comparison at its
   shard shape (8 query and 8 kv heads, a head group of 1; at 4 layers),
   then fp and int8 pages through ContinuousEngine over the placed tree
   (each shard's q and k columns gathered whole for the norm over the
   whole projection, the pages split by kv head) against the unsharded
   slot engine: phase 15's 8 requests x 32, held as phase 21 holds its
   runs (near-ties within MESH_TIE, 4x the launches a chunk, the page
   distance rule, the layout). (2) Two qwen3-0p6b tenants (bf16 trees of
   seeds 0 and 1, POOLED_LAYERS (14) layers) on {tensor: 4}, on one
   SharedPagePool made on their page mesh: 600 pages with quotas of 300,
   then a pool of POOLED_SMALL_PAGES where the second tenant's
   admissions reclaim the first's cached pages; phase 8's co-hosting
   prompts x 32, each
   tenant's streams bitwise its private placed engine's, the pool
   conserved at every boundary and whole at close. (3) Phase 21's node
   job planned {tensor: 2, fsdp: 2} on a worker with
   cont_pool_pages=256: its continuous answers from a pool tenant, equal
   to the in-process private placed engine's, the dense engine never
   called (launches_placed_pool on the kernels line). placed_cards()
   also runs (1)'s fp run at full depth over four cards with each card's
   peak memory.

Every phase that means a one-device worker sets MLConfig(mesh_devices=1):
by default a worker advertises every local card.

Phases 1-3 run alone (their timings are the kernels line's), then
phase 18 (its training step alone holds about 45 GiB). Then the parent
runs phases 4-10 and 12 while two worker processes (LANES) run 11,
13-15 and 22's OLMo-2 part, and 16-17, 19-21 and 22's pool part, in
that order, beside it on the same card:
every phase is host-bound, so the three share the card and the host's
cores; each lane's log is printed when it ends, and a failed lane fails
the run. Only the speeds, which are readings, see the other lanes. Each
phase's line gives its seconds and the memory its process reserved at
most.

The line before the last is one JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import gc
import json
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

_T_START = time.monotonic()  # before numpy, torch and the port are imported

import numpy as np
import torch

from tensorlink_tpu_torch.engine.generate import GenerationEngine
from tensorlink_tpu_torch.engine import paged
from tensorlink_tpu_torch.engine.loader import export_hf, load_params
from tensorlink_tpu_torch.engine.paged import PagedKVCache, paged_ragged_step
from tensorlink_tpu_torch.engine.sampling import SamplingParams
from tensorlink_tpu_torch.ml.batching import ContinuousBatcher
from tensorlink_tpu_torch.models import config_presets, init_params
from tensorlink_tpu_torch.models import transformer as ttr
from tensorlink_tpu_torch.models.quant import (
    pack_int4,
    quantize_kv,
    quantize_kv4,
    unpack_int4,
)
from tensorlink_tpu_torch.ops import _build
from tensorlink_tpu_torch.ops import attention as att
from tensorlink_tpu_torch.parallel import mesh as tmesh
from tensorlink_tpu_torch.parallel.expert import sparse_moe_mlp

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)
# free-running f32 pages after 3 chunks over 28 layers, in units of the
# per-layer 2e-5 bound: earlier H100 runs read 2.1-2.3
FREE_RUNNING_X = 4.0
# free-running f32 logits, |kernel - plain| at every draw made from equal
# tokens, per page format: H100 readings 3.2e-5, 1.5e-3 and 1.1e-2 (the
# int4 slot that parts does so at a plain top-two gap of 3.8e-4)
FREE_RUNNING_LOGITS = {"fp": 1e-4, "int8": 5e-3, "int4": 3e-2}
# at qwen3-0p6b's 28 layers; a shallower engine holds n_layers / 28 of it
KV_BYTES_PER_TOKEN = {"fp": 114_688, "int8": 59_136, "int4": 30_464}
MAIN = dict(S=8, C=128, Hq=16, Hkv=8, hd=128, page=16, n_pp=256)
MAIN_STARTS = [0, 896, 1536, 3071, 2000, 57, 4000, 0]
MAIN_NVALID = [128, 128, 1, 1, 1, 1, 1, 0]  # 2 prefills, 5 decodes, idle
MAIN_LENGTHS = [0, 1, 17, 777, 2048, 3100, 4000, 4096]
FORMATS = att.FORMATS  # "fp", "int8", "int4"
REPLACES = {
    "ragged_paged_attention": "tensorlink_tpu/ops/attention.py:711",
    "paged_attention": "tensorlink_tpu/ops/attention.py:899",
    "paged_prefill_attention": "tensorlink_tpu/ops/attention.py:451",
}
SOURCE = {
    "ragged_paged_attention": "ragged_paged_attention.cu",
    "paged_attention": "ragged_paged_attention.cu",
    "paged_prefill_attention": "ragged_paged_attention.cu",
}
_RAGGED_DESIGN = (
    "bf16: tensor cores (mma.sync m16n8k16, f32 accumulators), 64-row "
    "tiles of one (slot, kv head), 64-position key stages gathered through "
    "the block table by cp.async into a 2- or 3-stage ring (2 for fp pages "
    "at hd 128: two blocks an SM), 512-position splits "
    "merged by a combine pass; int8/int4 codes widened exactly to bf16, K "
    "scales on score columns, V scales folded into P. f32: scalar f32 "
    "FMAs over 16-row tiles, 16 pages per block, dequantized at the load")
DESIGN = {
    "ragged_paged_attention": _RAGGED_DESIGN,
    "paged_prefill_attention": "the ragged kernel with S = 1; "
                               + _RAGGED_DESIGN,
    "paged_attention": (
        "the ragged kernel's one-row (C = 1) launch, each slot's row at its "
        "length - 1 read from lengths in the kernel; bf16: its tensor-core "
        "body on narrow tiles, all 4 warps on each 64-position stage (QK^T "
        "by key columns, P exchanged in shared memory, PV by output "
        "columns), bitwise equal to the ragged kernel's row at the same "
        "position; " + _RAGGED_DESIGN),
    "flash_attention": (
        "bf16: warpgroup tensor cores (wgmma m64nNk16 from 128B-swizzled "
        "shared tiles, f32 accumulators, P in registers as the PV A "
        "operand), 2 warpgroups x 64 rows over the G heads of a kv head, "
        "64-key K/V tiles through a 2-stage cp.async ring, 2 blocks per "
        "SM at hd <= 128, q tiles with the most keys first. f32: scalar "
        "f32 FMAs, 64-row x 32-key tiles per query head"),
}
# dense parity: f32 last-token logits, |kernel - plain| after 28 layers of
# a flash prefill: H100 reading 6.5e-6 (plain logits std 0.64)
DENSE_LOGITS = 2e-5
# bf16 parity: each full-width layer's attention output (before o_proj and
# the residual), the tensor-core kernel against its plain version on the
# same inputs, per row: max |diff| within this times the row's max
# |plain| (the kernels' own bf16 tolerance, per output row). A planted
# fault, the plain version with each row's own key masked (an off-by-one
# causal mask), must read above it
BF16_ATTN_TOL = 1.6e-2
DENSE_SEQ_BUCKETS = (128, 256, 512, 1024, 2048)
DENSE_NEW = 32  # new tokens per request in the dense serving run
SERVE_NEW = 32  # new tokens per request of the serving runs
SERVE_RUNS = (  # (page format, weight quant, requests): 8 of _requests'
    ("none", None, 8),  # 16, cut for the script's time limit
    ("int8", None, 8),
    ("int4", "int8", 8),
)


def log(*a):
    print(*a, flush=True)


def _fmt(kv_quant: str) -> str:
    return "fp" if kv_quant == "none" else kv_quant


# -- phase 1 -----------------------------------------------------------
def _smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = _smi()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    return smi


# -- phase 2 -----------------------------------------------------------
def build_phase() -> None:
    t0 = time.monotonic()
    secs = _build.build_all()
    log(f"build: {json.dumps(secs)} wall {time.monotonic() - t0:.2f}s")
    for name in _build.KERNELS:
        for fn, usage in _ptxas_usage(_build.build_log(name)):
            log(f"  ptxas {name} {fn}: {usage}")


def _ptxas_usage(text: str) -> list:
    """``(kernel<template args>, "registers, static shared memory;
    spills")`` per entry function in ``nvcc -Xptxas -v`` output. Dynamic
    shared memory is set at the launch (each source's shape structs)."""
    out, fn, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = _kernel_name(m.group(1)), ""
        elif fn and "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif fn and "registers" in line:
            out.append((fn, f"{line.split(':', 1)[-1].strip()}; {spill}"))
            fn = None
    return out


def _kernel_name(mangled: str) -> str:
    """A readable name for a mangled kernel: its identifier and template
    arguments (dtype, integers)."""
    m = re.search(r"(flash_bf16_kernel|flash_kernel|attend_bf16|"
                  r"combine_bf16|attend_kernel|combine_kernel)(I.*)?",
                  mangled)
    if not m:
        return mangled
    targs = (m.group(2) or "")[1:]
    args = ["float"] if targs.startswith("f") else \
        ["bf16"] if targs.startswith("13__nv_bfloat16") else []
    ints = re.findall(r"Li(\d+)E", targs)
    return m.group(1) + (f"<{','.join(args + ints)}>" if targs else "")


# -- phase 3 -----------------------------------------------------------
def _pages(P, Hkv, page, hd, dtype, fmt, gen):
    """K and V page pools of random normals, in ``dtype`` for fp pages or
    quantized by the port's quantize_kv / quantize_kv4: ``(k, v, scales)``
    with ``scales`` the k_scale / v_scale keywords (empty for fp)."""
    dev = torch.device("cuda")
    out = []
    for _ in range(2):
        x = torch.randn((P, Hkv, page, hd), generator=gen, device=dev)
        if fmt == "fp":
            out.append((x.to(dtype), None))
        else:
            out.append((quantize_kv if fmt == "int8" else quantize_kv4)(x))
    (k, ks), (v, vs) = out
    return k, v, ({} if ks is None else dict(k_scale=ks, v_scale=vs))


def _case(rng, S, C, Hq, Hkv, hd, page, n_pp, starts, nv, lens, dtype,
          fmt="fp"):
    dev = torch.device("cuda")
    P = 1 + S * n_pp
    bt = rng.permutation(np.arange(1, P))[: S * n_pp].reshape(S, n_pp)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))

    def i32(a):
        return torch.tensor(np.asarray(a, np.int32), device=dev)

    q = torch.from_numpy(rng.standard_normal((S, C, Hq, hd), np.float32))
    k, v, sc = _pages(P, Hkv, page, hd, dtype, fmt, gen)
    return dict(
        q=q.to(dev, dtype), k=k, v=v, sc=sc, bt=i32(bt), starts=i32(starts),
        nv=i32(nv), lens=i32(lens), scale=hd**-0.5,
    )


def _ragged(c, kernel):
    fn = att.ragged_paged_attention if kernel else \
        att.ragged_paged_attention_ref
    return fn(c["q"], c["k"], c["v"], c["bt"], c["starts"], c["nv"],
              scale=c["scale"], **c["sc"])


def _decode(c, kernel):
    fn = att.paged_attention if kernel else att.paged_attention_ref
    return fn(c["q"][:, 0].contiguous(), c["k"], c["v"], c["bt"], c["lens"],
              scale=c["scale"], **c["sc"])


def _prefill(c, kernel, slot=1):
    """Slot ``slot`` of a case as one paged_prefill_attention call: its
    whole query block at its start, over its block-table row."""
    fn = att.paged_prefill_attention if kernel else \
        att.paged_prefill_attention_ref
    return fn(c["q"][slot], c["k"], c["v"], c["bt"][slot],
              c["starts"][slot], scale=c["scale"], **c["sc"])


EDGE_CASES = [
    # S, C, Hq, Hkv, hd, page, n_pp, starts, n_valid, lengths
    (4, 8, 8, 2, 32, 8, 4, [13, 0, 11, 0], [1, 8, 5, 0], [0, 1, 9, 32]),
    (3, 16, 8, 1, 64, 4, 8, [0, 3, 17], [16, 16, 9], [5, 32, 0]),
    (2, 8, 4, 2, 32, 8, 2, [0, 0], [0, 0], [0, 0]),  # all idle
    (2, 8, 4, 2, 32, 8, 4, [13, 0], [5, 0], [14, 3]),  # verify-style rows
    (2, 4, 32, 2, 256, 16, 3, [20, 1], [4, 3], [47, 16]),  # G 16, hd 256
    (2, 3, 48, 2, 128, 32, 2, [5, 60], [3, 1], [63, 33]),  # G 24: 2 tiles
    # pages that neither divide the bf16 body's 64-position stages nor are
    # multiples of them: 24, 96, and 48 across a 512-position split
    (3, 16, 8, 2, 128, 24, 6, [0, 40, 100], [16, 16, 1], [24, 130, 101]),
    (2, 4, 8, 2, 64, 96, 3, [200, 5], [4, 1], [204, 6]),
    (2, 16, 4, 2, 32, 48, 12, [500, 0], [16, 3], [516, 575]),
    # head_dim 16: bf16 only (the scalar bodies need a multiple of 32, so
    # f32 and paged_attention skip these); the page-24 case's int4 rows
    # are 8 bytes
    (3, 8, 8, 1, 16, 8, 4, [0, 3, 17], [8, 8, 1], [5, 9, 18]),
    (2, 16, 4, 2, 16, 16, 3, [0, 20], [16, 1], [16, 21]),
    (2, 8, 4, 1, 16, 24, 4, [30, 3], [8, 1], [40, 90]),
]
# paged_prefill_attention: tests/test_ops.py's small cases, as (C, Hq, Hkv,
# hd, page, n_pp, start), plus MAIN's second slot (C 128 at start 896,
# n_pp 256) and a page of 24; its head_dim 16 case in bf16 only
PREFILL_CASES = [
    (8, 8, 2, 32, 8, 4, 0),
    (8, 8, 2, 32, 8, 4, 13),
    (4, 8, 1, 64, 4, 8, 27),
    (8, 8, 2, 128, 24, 4, 50),
    (16, 4, 4, 16, 16, 3, 16),
]


def _scalar_takes(hd: int) -> bool:
    """The scalar bodies (every f32 launch) need head_dim a multiple of
    32; the bf16 tensor-core bodies take any multiple of 16."""
    return hd % 32 == 0


def _err(a, b, tol):
    a, b = a.float().cpu(), b.float().cpu()
    if not torch.isfinite(a).all():
        raise AssertionError("kernel output is not finite")
    np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)
    return float((a - b).abs().max())


def _variants():
    return [(n, f) for n in REPLACES for f in FORMATS]


def kernel_checks() -> dict:
    """Every kernel variant against its plain version; returns the max
    abs error per (kernel, format) and dtype."""
    rng = np.random.default_rng(0)
    m = MAIN
    errs = {v: {"float32": 0.0, "bfloat16": 0.0} for v in _variants()}
    cases = [(m["S"], m["C"], m["Hq"], m["Hkv"], m["hd"], m["page"],
              m["n_pp"], MAIN_STARTS, MAIN_NVALID, MAIN_LENGTHS)]
    cases += EDGE_CASES
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        dname = str(dtype).split(".")[1]

        def note(key, e):
            errs[key][dname] = max(errs[key][dname], e)

        for fmt in FORMATS:
            for i, spec in enumerate(cases):
                if dtype == torch.float32 and not _scalar_takes(spec[4]):
                    continue
                c = _case(rng, *spec, dtype=dtype, fmt=fmt)
                got, want = _ragged(c, True), _ragged(c, False)
                torch.cuda.synchronize()
                note(("ragged_paged_attention", fmt), _err(got, want, tol))
                for s, nv in enumerate(spec[8]):  # rows past n_valid: zeros
                    tail = got[s, nv:]
                    if tail.numel() and float(tail.abs().max()) != 0.0:
                        raise AssertionError("a row past n_valid is not zero")
                got, want = _decode(c, True), _decode(c, False)
                torch.cuda.synchronize()
                note(("paged_attention", fmt), _err(got, want, tol))
                if i == 0:  # MAIN's slot 1: C 128 at 896 over 256 pages
                    got, want = _prefill(c, True), _prefill(c, False)
                    torch.cuda.synchronize()
                    note(("paged_prefill_attention", fmt),
                         _err(got, want, tol))
            for C, Hq, Hkv, hd, page, n_pp, start in PREFILL_CASES:
                if dtype == torch.float32 and not _scalar_takes(hd):
                    continue
                # slot 1 of a 2-slot case: its table row, its start
                c = _case(rng, 2, C, Hq, Hkv, hd, page, n_pp, [0, start],
                          [C, C], [0, 0], dtype=dtype, fmt=fmt)
                got, want = _prefill(c, True), _prefill(c, False)
                torch.cuda.synchronize()
                note(("paged_prefill_attention", fmt), _err(got, want, tol))
    log("kernels vs plain versions: max abs err " + json.dumps(
        {f"{n}/{f}": e for (n, f), e in errs.items()}))
    return errs


def nibble_order_check() -> None:
    """Known answer for the int4 split-half layout inside both kernels:
    V row 0 of a one-page slot holds codes c_d = (d % 15) - 7 (packed by
    pack_int4, scale 1), the query sees only position 0, so the output
    must be c_d exactly. An interleaved unpack would give element 2b the
    code of element b."""
    dev = torch.device("cuda")
    hd, page = 128, 16
    codes = torch.randint(-7, 8, (2, 1, page, hd), device=dev,
                          dtype=torch.int32)
    want = torch.arange(hd, device=dev) % 15 - 7
    codes[1, 0, 0] = want
    v = pack_int4(codes)
    k = pack_int4(torch.zeros_like(codes))
    if not torch.equal(unpack_int4(v), codes):
        raise AssertionError("pack_int4/unpack_int4 do not round-trip")
    ones = torch.ones((2, 1, page), device=dev)
    sc = dict(k_scale=ones, v_scale=ones.clone())
    bt = torch.ones((1, 1), dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    q = torch.randn((1, 1, 2, hd), device=dev)  # 2 query heads, G 2
    outs = {
        "paged_attention": att.paged_attention(q[:, 0], k, v, bt, one,
                                               scale=1.0, **sc)[0],
        "ragged_paged_attention": att.ragged_paged_attention(
            q, k, v, bt, zero, one, scale=1.0, **sc)[0, 0],
        "paged_prefill_attention": att.paged_prefill_attention(
            q[0], k, v, bt[0], 0, scale=1.0, **sc)[0],
    }
    torch.cuda.synchronize()
    for name, out in outs.items():
        for h in range(out.shape[0]):
            if not torch.equal(out[h], want.float()):
                bad = int((out[h] != want.float()).sum())
                raise AssertionError(f"{name}: int4 nibble order wrong "
                                     f"({bad} of {hd} elements)")
    log("int4 nibble order (split-half) inside the kernels: exact")


# chunks of a 128-position prefill that framing_check runs on their own:
# wide tiles, and chunks of 1, 4 and 8 positions (2, 8 and 16 rows at G 2:
# narrow tiles, whose four warps split each key stage). At start 300 the
# whole chunk's warps hold positions 316..323 and 380..387, across the key
# stages at 320 and 384: the chunks [16, 20) and [80, 84) see no key of
# the later stage, which the whole chunk computes for them fully masked
FRAMINGS = ((0, 40), (40, 128), (0, 64), (64, 128), (0, 1), (127, 128),
            (40, 44), (62, 66), (56, 64), (120, 128), (16, 20), (80, 84))


def framing_check() -> None:
    """Chunk-framing invariance of the ragged kernel's bf16 body, which
    the prefix cache's bitwise reuse rests on: a prefill slot's 128 rows
    at start 300, run whole and as each chunk of FRAMINGS (each at its own
    start, beside an idle slot), give bitwise-equal rows in every page
    format."""
    dev = torch.device("cuda")
    for fmt in FORMATS:
        c = _case(np.random.default_rng(5), 2, 128, 16, 8, 128, 16, 64,
                  [300, 0], [128, 0], [0, 0], torch.bfloat16, fmt)
        full = _ragged(c, True)
        for a, b in FRAMINGS:
            part = att.ragged_paged_attention(
                c["q"][:, a:b].contiguous(), c["k"], c["v"], c["bt"],
                torch.tensor([300 + a, 0], dtype=torch.int32, device=dev),
                torch.tensor([b - a, 0], dtype=torch.int32, device=dev),
                scale=c["scale"], **c["sc"])
            if not torch.equal(part[0], full[0, a:b]):
                raise AssertionError(f"ragged {fmt}: rows [{a}, {b}) differ "
                                     "bitwise from the whole chunk's")
    log(f"ragged chunk framing (bf16; fp, int8, int4 pages): rows bitwise "
        f"equal over {len(FRAMINGS)} framings of a 128-row chunk (chunks of "
        f"1 to 88 positions)")


# decode_rows_check: (S, Hq, Hkv, hd, page, n_pp, lengths). MAIN's decode
# slots, then head_dim 16 (bf16 only: the f32 scalar body needs a multiple
# of 32; G 8 fills half a narrow tile) and pages of 24 and 96
DECODE_ROWS_CASES = [
    (MAIN["S"], MAIN["Hq"], MAIN["Hkv"], MAIN["hd"], MAIN["page"],
     MAIN["n_pp"], MAIN_LENGTHS),
    (3, 8, 1, 16, 8, 20, [5, 9, 150]),
    (2, 4, 1, 16, 24, 8, [40, 190]),
    (3, 8, 2, 128, 24, 8, [24, 130, 101]),
    (2, 8, 2, 64, 96, 3, [204, 6]),
]
# (C, valid rows) of the ragged launches a decode row is held to: a
# one-row slot and verify slots of 4 and of 9 positions (3 and 8 drafts;
# at G = 2 the 9-position slot is 18 rows, a wide tile), one valid row in
# a 128-row launch (a narrow tile of the general kernel, as the decode
# slots of the unified step), and a 128-row prefill chunk (wide tiles)
DECODE_ROW_CHUNKS = ((1, 1), (4, 4), (9, 9), (128, 1), (128, 128))
VERIFY_SLOTS = (4, 9)  # valid rows of the chunks whose every row is held


def decode_rows_check() -> int:
    """The contract speculative decoding's verify == sequential decode
    rests on: a paged_attention row at length p + 1 is bitwise the
    ragged kernel's row at position p, whether that row sits in a one-row
    slot, in a verify slot of 4 or 9 positions (each row checked), alone
    in a 128-row launch or in a 128-row prefill chunk (DECODE_ROW_CHUNKS),
    in bf16 (the tensor-core body: narrow and wide tiles) and in f32 (the
    scalar body), over fp, int8 and int4 pages. Returns the rows
    compared."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    n_rows = 0
    for dtype in (torch.bfloat16, torch.float32):
        for fmt in FORMATS:
            for S, Hq, Hkv, hd, page, n_pp, lens in DECODE_ROWS_CASES:
                if dtype == torch.float32 and not _scalar_takes(hd):
                    continue
                cap = n_pp * page
                c = _case(rng, S, 1, Hq, Hkv, hd, page, n_pp, [0] * S,
                          [0] * S, lens, dtype, fmt)
                for C, n_v in DECODE_ROW_CHUNKS:
                    C = min(C, cap)
                    n_v = min(n_v, C)
                    st = [min(max(n - n_v, 0), cap - n_v) for n in lens]
                    nv = [n_v if n > 0 else 0 for n in lens]
                    q = torch.from_numpy(rng.standard_normal(
                        (S, C, Hq, hd), np.float32)).to(dev, dtype)
                    rag = att.ragged_paged_attention(
                        q, c["k"], c["v"], c["bt"],
                        torch.tensor(st, dtype=torch.int32, device=dev),
                        torch.tensor(nv, dtype=torch.int32, device=dev),
                        scale=c["scale"], **c["sc"])
                    # the rows checked: every row of a verify slot, the
                    # last valid position's row otherwise
                    rows = range(n_v) if n_v in VERIFY_SLOTS else [None]
                    for j in rows:
                        at = [(n - 1 - a) if j is None else j
                              for n, a in zip(lens, st)]
                        at = [max(x, 0) for x in at]
                        dlen = [a + x + 1 if n > 0 else 0
                                for n, a, x in zip(lens, st, at)]
                        qd = q[torch.arange(S, device=dev),
                               torch.tensor(at, device=dev)].contiguous()
                        dec = att.paged_attention(
                            qd, c["k"], c["v"], c["bt"],
                            torch.tensor(dlen, dtype=torch.int32,
                                         device=dev),
                            scale=c["scale"], **c["sc"])
                        for s in range(S):
                            if dlen[s] == 0:
                                continue
                            if not torch.equal(dec[s], rag[s, at[s]]):
                                raise AssertionError(
                                    f"decode rows ({dtype}, {fmt}, hd {hd}, "
                                    f"page {page}, {n_v} of {C} rows): slot "
                                    f"{s} at length {dlen[s]} differs from "
                                    f"the ragged row at {dlen[s] - 1}")
                            n_rows += 1
    torch.cuda.synchronize()
    log(f"decode rows == ragged rows bitwise (bf16 and f32; fp, int8, int4 "
        f"pages; (C, valid rows) {DECODE_ROW_CHUNKS}): {n_rows} rows")
    return n_rows


def _time_ms(fn, runs=30, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def _graph_ms(fn, reps=10, runs=30) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph, the graph replayed between CUDA events (median of ``runs``
    replays after warm-up), divided by ``reps``. The wrappers' host work
    (checks, allocation, the launch itself) is outside the timed region,
    which _time_ms (eager) includes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(ts)


def _gathered(c, rows=None):
    """Per-slot contiguous KV [S, Hkv, K, hd] of fp pages for the library
    yardstick (gathered once, outside the timed region); ``rows`` picks
    slots."""
    bt = c["bt"] if rows is None else c["bt"][rows]
    S, n_pp = bt.shape
    _, Hkv, page, hd = c["k"].shape

    def g(p):
        x = p[bt.long()]  # [S, n_pp, Hkv, page, hd]
        return x.permute(0, 2, 1, 3, 4).reshape(S, Hkv, n_pp * page, hd)

    return g(c["k"]).contiguous(), g(c["v"]).contiguous()


def _kv_bytes_per_position(fmt, hd, elt):
    """Bytes of one position's K or V row of one kv head: the codes plus
    its f32 scale for quantized pages."""
    return {"fp": hd * elt, "int8": hd + 4, "int4": hd // 2 + 4}[fmt]


def kernel_timings() -> dict:
    """Each variant at the main path's shape in bfloat16 q: kernel, plain
    version and (fp pages only) one SDPA call, with the bound computed
    from this run's inputs."""
    m = MAIN
    dtype = torch.bfloat16
    S, C, Hq, Hkv, hd = m["S"], m["C"], m["Hq"], m["Hkv"], m["hd"]
    G, K, elt, page = Hq // Hkv, m["n_pp"] * m["page"], 2, m["page"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pos = torch.arange(K, device="cuda")
    starts, nvs, lens = MAIN_STARTS, MAIN_NVALID, MAIN_LENGTHS
    out = {}
    for fmt in FORMATS:
        c = _case(np.random.default_rng(1), S, C, Hq, Hkv, hd, page,
                  m["n_pp"], starts, nvs, lens, dtype, fmt)
        row = _kv_bytes_per_position(fmt, hd, elt)
        lib = {}
        if fmt == "fp":
            kg, vg = (x.repeat_interleave(G, dim=1) for x in _gathered(c))
            q_pos = torch.tensor(starts, device="cuda")[:, None] + \
                torch.arange(C, device="cuda")[None, :]
            mask = pos[None, None, :] <= q_pos[:, :, None]  # [S, C, K]
            mask[:, :, 0] = True  # idle rows: keep SDPA finite (timing only)
            qs = c["q"].permute(0, 2, 1, 3)  # [S, Hq, C, hd]
            lib["ragged_paged_attention"] = lambda: sdpa(
                qs, kg, vg, attn_mask=mask[:, None])
            dmask = pos[None, :] < torch.tensor(lens, device="cuda")[:, None]
            dmask[:, 0] = True  # length-0 slot: keep SDPA finite
            qd = c["q"][:, 0].contiguous()[:, :, None]  # [S, Hq, 1, hd]
            lib["paged_attention"] = lambda: sdpa(
                qd, kg, vg, attn_mask=dmask[:, None, None])
            # the prefill slot alone: its KV up to start + C, causal rows
            kp, vp = (x.repeat_interleave(G, dim=1)
                      for x in _gathered(c, rows=[1]))
            pmask = pos[None, :] <= (starts[1] + torch.arange(
                C, device="cuda"))[:, None]
            qp = c["q"][1:2].permute(0, 2, 1, 3)
            lib["paged_prefill_attention"] = lambda: sdpa(
                qp, kp, vp, attn_mask=pmask[None, None])

        # ragged: rows (s, c) valid when c < n_valid; row sees keys <= start+c
        live = sum(st + nv for st, nv in zip(starts, nvs) if nv > 0)
        pairs = sum(st + j + 1 for st, nv in zip(starts, nvs)
                    for j in range(nv))
        n_bytes = (sum(nvs) * Hq * hd * elt  # q: the valid rows only
                   + c["q"].numel() * elt  # every output row (zeros too)
                   + 2 * live * Hkv * row  # live K and V (+ scales), once
                   + sum(-(-(st + nv) // page) for st, nv in
                         zip(starts, nvs) if nv > 0) * 4 + 2 * S * 4)
        out[("ragged_paged_attention", fmt)] = dict(
            fn=lambda c=c: _ragged(c, True),
            plain=lambda c=c: _ragged(c, False),
            bytes=n_bytes, flops=4 * hd * Hq * pairs,
        )
        n_live = sum(1 for n in lens if n > 0)  # a length-0 slot reads no q
        n_bytes = ((n_live + S) * Hq * hd * elt + 2 * sum(lens) * Hkv * row
                   + sum(-(-n // page) for n in lens) * 4 + S * 4)
        out[("paged_attention", fmt)] = dict(
            fn=lambda c=c: _decode(c, True),
            plain=lambda c=c: _decode(c, False),
            bytes=n_bytes, flops=4 * hd * Hq * sum(lens),
        )
        st, n = starts[1], nvs[1]
        n_bytes = (2 * n * Hq * hd * elt + 2 * (st + n) * Hkv * row
                   + -(-(st + n) // page) * 4 + 2 * 4)
        out[("paged_prefill_attention", fmt)] = dict(
            fn=lambda c=c: _prefill(c, True),
            plain=lambda c=c: _prefill(c, False), bytes=n_bytes,
            flops=4 * hd * Hq * sum(st + j + 1 for j in range(n)),
        )
        for name in REPLACES:
            r = out[(name, fmt)]
            fn = r.pop("fn")
            r["ms"] = _time_ms(fn)
            r["device_ms"] = _graph_ms(fn)
            r["plain_ms"] = _time_ms(r.pop("plain"), runs=20)
            has = name in lib
            r["library_ms"] = _time_ms(lib[name]) if has else None
            r["library_device_ms"] = _graph_ms(lib[name]) if has else None
            t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
            t_ops = r["flops"] / PEAK_FLOPS[dtype] * 1e3
            r["bound_ms"] = max(t_bytes, t_ops)
            r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            lib_s, lib_d = ("null", "null") if not has else (
                f"{r['library_ms']:.4f}", f"{r['library_device_ms']:.4f}")
            log(f"{name}/{fmt} (bf16 q, main-path shape): kernel_ms "
                f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
                f"{lib_s} bound_ms {r['bound_ms']:.5f} ({r['bound_by']}: "
                f"{r['bytes']} B, {r['flops']} flop); device kernel_ms "
                f"{r['device_ms']:.4f} library_ms {lib_d}")
        del c
        torch.cuda.empty_cache()
    return out


def kernel_profile(runs: int = 20) -> dict:
    """Device time of each CUDA kernel that one paged_attention and one
    ragged_paged_attention call launch at MAIN's shapes in bfloat16 (the
    attend and combine passes apart), per page format: ``runs`` calls of
    each under torch.profiler, mean microseconds per call by kernel
    name."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for fmt in FORMATS:
        c = _case(np.random.default_rng(1), MAIN["S"], MAIN["C"], MAIN["Hq"],
                  MAIN["Hkv"], MAIN["hd"], MAIN["page"], MAIN["n_pp"],
                  MAIN_STARTS, MAIN_NVALID, MAIN_LENGTHS, torch.bfloat16,
                  fmt)
        for name, fn in (("paged_attention", lambda: _decode(c, True)),
                         ("ragged_paged_attention", lambda: _ragged(c, True))):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(runs):
                    fn()
                torch.cuda.synchronize()
            times = {}
            for e in prof.key_averages():
                t = getattr(e, "device_time_total", None)
                if t is None:
                    t = getattr(e, "cuda_time_total", 0.0)
                if t > 0:  # "void (anonymous namespace)::attend_bf16<..>(.."
                    key = re.sub(r"\(.*", "", e.key.replace(
                        "(anonymous namespace)::", "")).replace("void ", "")
                    times[key] = t / runs
            out[(name, fmt)] = times
            log(f"profile {name}/{fmt} (bf16 q, main-path shape): device us "
                f"per call by kernel {json.dumps(times)}")
        del c
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _patched_kernels(name: str, patches):
    """Launches inside use kernels built from a copy of ops/csrc under
    build/<name>/ in which each ``(old, new)`` of ``patches`` replaces
    its text, found exactly once, in ragged_paged_attention.cu."""
    import shutil
    from pathlib import Path

    root = Path(__file__).resolve().parent / "build" / name
    src = root / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    cu = src / "ragged_paged_attention.cu"
    text = cu.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise AssertionError(f"{name}: patch target not found once: "
                                 f"{old!r}")
        text = text.replace(old, new)
    cu.write_text(text)
    saved = _build.CSRC, _build.BUILD_DIR, _build._libs
    _build.CSRC, _build.BUILD_DIR, _build._libs = src, root / "lib", {}
    try:
        yield
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._libs = saved


NARROW_TEST = "bool narrow_rows(int rows) { return rows <= NR; }"


def wide_tile_timings() -> dict:
    """kernel_timings() of the ragged kernel with its narrow tiles
    switched off (NARROW_TEST answering false): every tile wide, so a
    decode tile's products run on one warp while three wait (PR 4's
    tile). Not a phase of main(): run it beside kernel_timings() in one
    process to see what the narrow tiles buy."""
    off = NARROW_TEST.replace("rows <= NR", "false")
    with _patched_kernels("wide_tiles", [(NARROW_TEST, off)]):
        log("wide tiles only (narrow tiles off):")
        return kernel_timings()


# the attend pass with its products and softmax skipped (every stage's
# copies still made), and with its copies skipped (every stage computed on
# what shared memory holds): what each costs alone
ATTEND_PARTS_OFF = {
    "compute off": [
        ("    if (narrow) {\n      // Each warp takes",
         "    if (k0 < 0) {\n      // Each warp takes"),
        ("    } else if (warp_live && k0 <= lim_hi) {",
         "    } else if (k0 < 0) {"),
    ],
    "copies off": [
        ("  auto load_stage = [&](int k0, int st) {\n",
         "  auto load_stage = [&](int k0, int st) {\n"
         "    if (k0 >= 0) return;\n"),
    ],
}


def attend_parts_profile() -> dict:
    """kernel_profile() of builds with each part of the attend pass in
    ATTEND_PARTS_OFF switched off (their outputs are garbage; only the
    times count). Not a phase of main()."""
    out = {}
    for name, patches in ATTEND_PARTS_OFF.items():
        with _patched_kernels(name.replace(" ", "_"), patches):
            log(f"attend pass, {name}:")
            out[name] = kernel_profile()
    return out


# flash_attention: (B, T, Hq, Hkv, hd, window). The main shape first (k/v
# read in place from a longer cache, as the engine passes them), then
# tests/test_ops.py's shapes, its three windows, two T that are no
# multiple of the kernel's tiles, and head_dim 64 and 256; the head_dim 16
# shapes (test_ops.py's MQA shape, and windows 8 and 16 below a tile) run
# in bf16 only (the f32 scalar body needs a multiple of 32)
FLASH_MAIN = (4, 2048, 16, 8, 128, None)
FLASH_CASES = [
    FLASH_MAIN,
    (2, 256, 8, 2, 64, None), (1, 128, 4, 4, 32, None),
    (1, 64, 2, 2, 128, None),
    (1, 128, 4, 2, 32, 8), (1, 128, 4, 2, 32, 64), (1, 128, 4, 2, 32, 200),
    (2, 100, 16, 8, 128, None), (3, 37, 16, 8, 128, None),
    (2, 512, 8, 2, 64, 200), (1, 256, 8, 1, 256, None), (2, 37, 8, 4, 256, 16),
    (2, 128, 8, 1, 16, None), (1, 128, 4, 2, 16, 8), (2, 100, 8, 2, 16, 16),
]


def _flash_case(rng, B, T, Hq, Hkv, hd, window, dtype, pad=64):
    """Seeded q and k/v views ``[:, :T]`` of a ``[B, T + pad, Hkv, hd]``
    cache (the engine's layout), in ``dtype`` on the card."""
    dev = torch.device("cuda")

    def rand(shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev, dtype)

    q = rand((B, T, Hq, hd))
    k = rand((B, T + pad, Hkv, hd))[:, :T]
    v = rand((B, T + pad, Hkv, hd))[:, :T]
    return dict(q=q, k=k, v=v, scale=hd**-0.5, window=window)


def _flash(c, kernel):
    fn = att.flash_attention if kernel else att.flash_attention_ref
    return fn(c["q"], c["k"], c["v"], scale=c["scale"], window=c["window"])


def flash_checks() -> dict:
    """flash_attention against its plain version on every FLASH_CASES
    shape in float32 (rtol = atol = 2e-5) and bfloat16 (1.6e-2); returns
    the max abs error per dtype."""
    rng = np.random.default_rng(11)
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        dname = str(dtype).split(".")[1]
        for spec in FLASH_CASES:
            if dtype == torch.float32 and not _scalar_takes(spec[4]):
                continue
            c = _flash_case(rng, *spec, dtype=dtype)
            got, want = _flash(c, True), _flash(c, False)
            torch.cuda.synchronize()
            try:
                e = _err(got, want, tol)
            except AssertionError as exc:
                raise AssertionError(f"flash_attention {spec} {dname}: "
                                     f"{exc}") from None
            errs[dname] = max(errs[dname], e)
    try:
        c = _flash_case(rng, 1, 100, 4, 2, 32, None, torch.float32)
        att.flash_attention(c["q"], c["k"], c["v"], scale=1.0, block_q=64,
                            block_k=64)
        raise AssertionError("flash_attention took T 100 with 64-row blocks")
    except ValueError:
        pass
    log(f"flash_attention vs plain version over {len(FLASH_CASES)} shapes: "
        f"max abs err {json.dumps(errs)}")
    return errs


def flash_timing() -> dict:
    """flash_attention at FLASH_MAIN in bfloat16: kernel, plain version and
    one scaled_dot_product_attention call (causal, GQA), with the bound
    from this run's shape."""
    B, T, Hq, Hkv, hd, _ = FLASH_MAIN
    dtype = torch.bfloat16
    c = _flash_case(np.random.default_rng(12), *FLASH_MAIN, dtype=dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (c[n].transpose(1, 2) for n in ("q", "k", "v"))
    def kernel():
        return _flash(c, True)

    def library():
        return sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

    r = dict(
        ms=_time_ms(kernel), device_ms=_graph_ms(kernel),
        plain_ms=_time_ms(lambda: _flash(c, False), runs=10),
        library_ms=_time_ms(library), library_device_ms=_graph_ms(library),
        # each input read once, the output written once; 4 * hd FLOPs per
        # visible (query head, key) pair: T (T + 1) / 2 pairs per head
        bytes=(2 * B * T * Hq * hd + 2 * B * T * Hkv * hd) * 2,
        flops=4 * hd * Hq * B * T * (T + 1) // 2,
    )
    t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = r["flops"] / PEAK_FLOPS[dtype] * 1e3
    r["bound_ms"] = max(t_bytes, t_ops)
    r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"flash_attention (bf16, B {B} T {T} Hq {Hq} Hkv {Hkv} hd {hd}): "
        f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
        f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
        f"({r['bound_by']}: {r['bytes']} B, {r['flops']} flop); device "
        f"kernel_ms {r['device_ms']:.4f} library_ms "
        f"{r['library_device_ms']:.4f}")
    del c, qt, kt, vt
    torch.cuda.empty_cache()
    return r


# -- phase 4 -----------------------------------------------------------
def _fill_quantized(cache, packed, gen):
    """Seeded random codes and scales (about the scale of N(0, 1) rows)
    under every page of a quantized cache."""
    levels = 7 if packed else 127
    lo = -128 if packed else -127  # int4: any packed byte
    for t in (cache.k, cache.v):
        t.copy_(torch.randint(lo, 128, t.shape, generator=gen,
                              device=t.device, dtype=torch.int8))
    for t in (cache.k_scale, cache.v_scale):
        t.copy_((2.5 + torch.rand(t.shape, generator=gen, device=t.device))
                / levels)


def _codes(pages, packed):
    return unpack_int4(pages) if packed else pages.to(torch.int32)


def _teacher_forced_layers(cfg, params, cache, arrays) -> float:
    """Both attention paths through each layer from the SAME layer input
    (the plain path's output feeds the next layer): each layer's output
    within rtol = atol = 2e-5, fp pages within that bound, quantized
    pages and scales byte-equal (the same quantize code on the same
    k/v). Returns the worst |diff| / (2e-5 + 2e-5 |plain|) ratio (<= 1
    passes)."""
    blk, starts, nv = arrays
    page, n_pp = cache.page_size, cache.pages_per_slot
    bt = cache.block_tables
    write_pg, write_off, pos, _ = paged._ragged_write_indices(
        bt, starts, nv, page, n_pp, blk.shape[1]
    )
    x = paged._embed_tokens(params, blk.long(), cfg)
    cos, sin = paged.rope_tables(pos, paged._rope_dim(cfg), cfg.rope_theta)
    worst = 0.0
    for i, lp in enumerate(paged._layers(params)):
        outs = []
        for kernel in (True, False):
            kv = tuple(t.clone() for t in cache.layer_kv(i))
            y, kv = paged._ragged_block(x, lp, cfg, cos, sin, kv, write_pg,
                                        write_off, bt, starts, nv, kernel)
            outs.append((y, kv))
        (yk, kvk), (yp, kvp) = outs
        pairs = [(yk, yp)]
        # page 0 is scratch: padding rows race to write it, nothing reads it
        if cache.quantized:
            for a, b in zip(kvk, kvp):
                if not torch.equal(a[1:], b[1:]):
                    raise AssertionError(f"layer {i}: quantized pages or "
                                         "scales differ between the paths")
        else:
            pairs += [(kvk[0][1:], kvp[0][1:]), (kvk[1][1:], kvp[1][1:])]
        for a, b in pairs:
            d = (a - b).abs() / (2e-5 + 2e-5 * b.abs())
            worst = max(worst, float(d.max()))
        x = yp
    return worst


def _free_running_pages(cfg, cache_k, cache_p) -> str:
    """Compare the two paths' fp pages after free running: held to
    FREE_RUNNING_X times the per-layer bound."""
    worst, ratio = 0.0, 0.0
    for a, b in ((cache_k.k, cache_p.k), (cache_k.v, cache_p.v)):
        for layer in range(cfg.n_layers):
            x, y = a[layer, 1:], b[layer, 1:]
            if not torch.isfinite(x).all():
                raise AssertionError("pages are not finite")
            d = (x - y).abs()
            worst = max(worst, float(d.max()))
            ratio = max(ratio, float((d / (2e-5 + 2e-5 * y.abs())).max()))
    if ratio > FREE_RUNNING_X:
        raise AssertionError(
            f"step parity: free-running pages differ by {worst:.3e}, "
            f"{ratio:.2f}x the per-layer bound (> {FREE_RUNNING_X})"
        )
    return (f"free-running pages max abs diff {worst:.3e} ({ratio:.3f}x "
            f"the per-layer 2e-5 bound over {cfg.n_layers} layers, limit "
            f"{FREE_RUNNING_X}x)")


def _free_running_codes(cfg, cache_k, cache_p, upto) -> str:
    """Compare the two paths' quantized pages after free running, slot by
    slot over positions ``0 .. upto[s] - 1`` (read through the slot's
    block table): every code within 1. Returns a report: the share of
    codes that differ and the scales' worst relative difference."""
    packed = cache_k.k.shape[-1] != cfg.head_dim
    page = cache_k.page_size
    n_diff, n_all, dmax, srel = 0, 0, 0, 0.0
    for s, n in enumerate(upto):
        pos = torch.arange(n, device=cache_k.k.device)
        pg = cache_k.block_tables[s].long()[pos // page]
        off = pos % page
        for a, b in ((cache_k.k, cache_p.k), (cache_k.v, cache_p.v)):
            d = (_codes(a[:, pg, :, off], packed)
                 - _codes(b[:, pg, :, off], packed)).abs()
            dmax = max(dmax, int(d.max()))
            n_diff += int((d > 0).sum())
            n_all += d.numel()
        for a, b in ((cache_k.k_scale, cache_p.k_scale),
                     (cache_k.v_scale, cache_p.v_scale)):
            x, y = a[:, pg, :, off], b[:, pg, :, off]
            if not torch.isfinite(x).all():
                raise AssertionError("scales are not finite")
            srel = max(srel, float(((x - y).abs()
                                    / y.abs().clamp_min(1e-30)).max()))
    if dmax > 1:
        raise AssertionError(f"step parity: free-running codes differ by "
                             f"{dmax} (> 1)")
    return (f"free-running codes: {n_diff} of {n_all} differ "
            f"({n_diff / n_all:.3e}), all within 1; scales max rel diff "
            f"{srel:.3e}")


def _recording_sampler(store: list):
    """``paged._sample_rows`` unchanged, but keeping a copy of every
    logits batch it samples from, in draw order."""
    real = paged._sample_rows

    def rec(logits, *args):
        store.append(logits.clone())
        return real(logits, *args)

    return rec


def _stream_parity(trace_k, trace_p, logits_k, logits_p, n_steps) -> dict:
    """Walk both paths' draws in order (a chunk's column j is its j-th
    draw). Every draw a slot makes from equal inputs on both paths (its
    tokens equal so far) compares the logits it sampled from. Returns the
    worst |logit diff|, the draws compared, the plain logits' mean row
    std, and for each slot whose tokens differ: the position that gave
    the first differing token and both paths' top-2 gaps there."""
    S = len(trace_k[0][1])
    worst, n_cmp, stds, div = 0.0, 0, [], {}
    for ci, ((tk, nk, _, _), (tp, _, lens, _)) in enumerate(
            zip(trace_k, trace_p)):
        for j in range(n_steps):
            a, b = logits_k[ci * n_steps + j], logits_p[ci * n_steps + j]
            for s in range(S):
                if s in div or j >= nk[s]:
                    continue
                if not torch.isfinite(a[s]).all():
                    raise AssertionError("step parity: logits not finite")
                worst = max(worst, float((a[s] - b[s]).abs().max()))
                stds.append(float(b[s].std()))
                n_cmp += 1
                ta, tb = tk[s][j], tp[s][j]
                if ta != tb:
                    div[s] = dict(
                        pos=lens[s] - nk[s] + j,
                        gap_plain=float(b[s, tb] - b[s, ta]),
                        gap_kernel=float(a[s, ta] - a[s, tb]),
                    )
    return dict(worst=worst, draws=n_cmp, std=statistics.fmean(stds),
                div=div)


def step_parity(kv_quant: str = "none") -> None:
    cfg = config_presets()["qwen3-0p6b"].with_(dtype=torch.float32)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    params = init_params(cfg, g, device=dev)
    S, C, page, max_len, n_steps = 8, 128, 16, 2048, 8
    base = PagedKVCache.init(cfg, S, page_size=page, max_len=max_len,
                             kv_quant=kv_quant, device=dev)
    n_pp = base.pages_per_slot
    rng = np.random.default_rng(7)
    perm = rng.permutation(np.arange(1, base.n_pages))[: S * n_pp]
    base.block_tables.copy_(torch.from_numpy(
        perm.reshape(S, n_pp).astype(np.int32)))
    # existing context: seeded random KV under every slot's pages
    gk = torch.Generator(device=dev)
    gk.manual_seed(99)
    if base.quantized:
        _fill_quantized(base, kv_quant == "int4", gk)
    else:
        base.k.normal_(generator=gk)
        base.v.normal_(generator=gk)
    lengths = [100, 250, 37, 300, 511, 1000, 1500, 1900]
    base.lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
    prompts = {s: rng.integers(0, cfg.vocab_size, size=3 * C) for s in (0, 1)}
    V = cfg.vocab_size

    def run(kernel):
        cache = base.clone()
        counts = torch.zeros((S, V), dtype=torch.int32, device=dev)
        cur = [int(t) for t in rng_tok]
        lens = list(lengths)
        fed = {0: 0, 1: 0}
        trace, logits = [], []
        real = paged._sample_rows
        paged._sample_rows = _recording_sampler(logits)
        try:
            for chunk in range(3):
                cache, counts, lens = _chunk(chunk, kernel, cache, counts,
                                             cur, lens, fed, trace)
        finally:
            paged._sample_rows = real
        if len(logits) != 3 * n_steps:
            raise AssertionError(f"step parity: {len(logits)} draws")
        return trace, cache, counts, logits

    def _chunk(chunk, kernel, cache, counts, cur, lens, fed, trace):
        blk = np.zeros((S, C), np.int32)
        starts = np.array(lens, np.int32)
        nv = np.zeros(S, np.int32)
        emit = np.zeros(S, bool)
        for s in range(S):
            if s in fed and fed[s] < 2 * C:  # prefill at an offset
                blk[s] = prompts[s][fed[s]:fed[s] + C]
                nv[s] = C
                fed[s] += C
                emit[s] = fed[s] >= 2 * C
            else:
                blk[s, 0] = cur[s]
                nv[s] = 1
                emit[s] = True
        if chunk == 0:
            first_block[:] = [blk.copy(), starts.copy(), nv.copy()]
        up = [torch.tensor(a, device=dev) for a in (
            blk, starts, nv, np.zeros(S, np.int32), emit,
            np.arange(S, dtype=np.int32), np.zeros(S, np.int32),
            np.zeros(S, np.float32), np.zeros(S, np.int32),
            np.ones(S, np.float32), np.zeros(S, np.float32),
            np.zeros(S, np.float32))]
        blk_t, st_t, nv_t, ns_t, em_t, sd_t, stp_t, tmp_t, tk_t, tp_t, \
            pr_t, fq_t = up
        rem = torch.full((S,), 64, dtype=torch.int32, device=dev)
        eos = torch.full((S, 8), -1, dtype=torch.int32, device=dev)
        toks, n_tok, _m, n_exec, cache, _d, _s, counts, _r = \
            paged_ragged_step(
                params, blk_t, cache, st_t, nv_t, ns_t, em_t, sd_t,
                stp_t, tmp_t, tk_t, tp_t, pr_t, fq_t, counts, rem, eos,
                cfg, n_steps, 1, kernel=kernel,
            )
        toks, n_tok = toks.cpu().numpy(), n_tok.cpu().numpy()
        lens = cache.lengths.cpu().tolist()
        for s in range(S):
            if n_tok[s]:
                cur[s] = int(toks[s, n_tok[s] - 1])
        trace.append((toks.tolist(), n_tok.tolist(), lens, int(n_exec)))
        return cache, counts, lens

    rng_tok = rng.integers(0, V, size=S)
    first_block: list = []
    t0 = time.monotonic()
    att.reset_counts()
    trace_k, cache_k, counts_k, logits_k = run(True)
    fmt = _fmt(kv_quant)
    for fn in (att.ragged_paged_attention, att.paged_attention):
        if fn.launches_by_format[fmt] != fn.launches or not fn.launches:
            raise AssertionError(f"step parity ({fmt}): kernel launches "
                                 f"{fn.launches_by_format}")
    trace_p, cache_p, counts_p, logits_p = run(False)
    blk0, starts0, nv0 = first_block
    # (a) free running: per-layer differences add up over 28 layers. Token
    # counts, lengths and n_exec never depend on token values here (no EOS,
    # budget 64), so they are equal in every format.
    if [t[1:] for t in trace_k] != [t[1:] for t in trace_p]:
        raise AssertionError(f"step parity ({fmt}): counts or lengths "
                             f"differ\nkernel {trace_k}\nplain  {trace_p}")
    par = _stream_parity(trace_k, trace_p, logits_k, logits_p, n_steps)
    div, limit = par["div"], FREE_RUNNING_LOGITS[fmt]
    free = (f"logits of {par['draws']} draws from equal inputs within "
            f"{par['worst']:.3e} (limit {limit:.1e}; plain logits' row std "
            f"{par['std']:.3f})")
    if par["worst"] > limit:
        raise AssertionError(f"step parity ({fmt}): {free}")
    # int4 only: one code a level off moves its value by amax/7, and the
    # random-weight model's greedy argmax may then flip, but only at a
    # near-tie: the plain path's top two logits within the limit
    if fmt != "int4" or any(d["gap_plain"] > limit for d in div.values()):
        if div:
            raise AssertionError(
                f"step parity ({fmt}): tokens differ in slots {div} "
                f"(limit {limit:.1e})\nkernel {trace_k}\nplain  {trace_p}")
    held = [s for s in range(S) if s not in div]
    if not all(torch.equal(counts_k[s], counts_p[s]) for s in held):
        raise AssertionError(f"step parity ({fmt}): counts differ")
    if div:
        free += f"; tokens equal in slots {held}, diverged at {div}"
    if fmt == "fp":
        free += "; " + _free_running_pages(cfg, cache_k, cache_p)
    else:
        # positions 0 .. p (p's own KV included) were written from equal
        # tokens on both paths
        upto = [div[s]["pos"] + 1 if s in div else trace_p[-1][2][s]
                for s in range(S)]
        free += "; " + _free_running_codes(cfg, cache_k, cache_p, upto)
    # (b) teacher forced: every layer from the same input, rtol = atol =
    # 2e-5 on its output (the first chunk's mixed block)
    first = (torch.tensor(blk0, device=dev), torch.tensor(starts0, device=dev),
             torch.tensor(nv0, device=dev))
    tf_ratio = _teacher_forced_layers(cfg, params, base, first)
    if tf_ratio > 1.0:
        raise AssertionError(
            f"step parity ({fmt}): a layer's output or pages differ beyond "
            f"rtol = atol = 2e-5 ({tf_ratio:.2f}x the bound)"
        )
    pages = "pages and scales byte-equal" if base.quantized else \
        "output and pages"
    log(f"step parity (qwen3-0p6b f32, {fmt} pages, 3 chunks, kernel vs "
        f"plain): {free}; "
        f"teacher-forced per layer {pages}, output {tf_ratio:.3f}x the 2e-5 "
        f"bound; {time.monotonic() - t0:.1f}s")
    del params, base, cache_k, cache_p
    torch.cuda.empty_cache()


# -- phase 5 -----------------------------------------------------------
def _requests(cfg):
    rng = np.random.default_rng(2024)
    V = cfg.vocab_size
    warm = rng.integers(0, V, 64).tolist()
    shared = rng.integers(0, V, 512).tolist()
    reqs = []
    for i in range(16):
        n = int(rng.integers(64, 1537))
        if i in (0, 5, 10, 15):  # four requests share a 512-token prefix
            ids = shared + rng.integers(0, V, max(n - 512, 64)).tolist()
        else:
            ids = rng.integers(0, V, n).tolist()
        knobs = {} if i % 2 == 0 else dict(temperature=0.8, top_k=50,
                                           top_p=0.95)
        reqs.append((ids, knobs))
    return warm, reqs


def serving_phase(kv_quant: str = "none", quant: str | None = None,
                  n_req: int = 16) -> dict:
    cfg = config_presets()["qwen3-0p6b"]  # bfloat16
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(5678)
    params = init_params(cfg, g, device=dev)
    eng = GenerationEngine(cfg, params, max_seq_len=4096, quant=quant,
                           device="cuda")
    del params
    b = ContinuousBatcher(engine=eng, max_slots=8, page_size=16,
                          chunk_steps=8, prefill_chunk=128,
                          prefix_cache=True, kv_quant=kv_quant, seed=0)
    cont = b.engine
    fmt = _fmt(kv_quant)
    V = cfg.vocab_size
    warm, all_reqs = _requests(cfg)
    # 8 requests: thread 0 runs request 0 and then 5, a sharer of its prefix
    pick = range(16) if n_req == 16 else (0, 1, 2, 3, 5, 6, 7, 9)
    reqs = [all_reqs[i] for i in pick]
    b.generate(warm, max_new_tokens=8)  # warm-up
    results, ttft = {}, {}
    errors = []
    chunks0, skipped0 = cont.chunks, cont.stats["prefill_tokens_skipped"]
    att.reset_counts()

    def worker(t):
        try:
            for i in range(t, n_req, 4):
                ids, knobs = reqs[i]
                t_sub = time.monotonic()
                first = []

                def cb(toks, first=first, t_sub=t_sub):
                    if not first:
                        first.append(time.monotonic() - t_sub)

                results[i] = b.generate(ids, max_new_tokens=SERVE_NEW,
                                        stream_cb=cb,
                                        timeout=600, **knobs)
                ttft[i] = first[0]
        except Exception as e:  # noqa: BLE001 — re-raised on the main thread
            errors.append(e)

    t0 = time.monotonic()
    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.monotonic() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads) or len(results) != n_req:
        raise AssertionError("serving: not every request finished")
    chunks = cont.chunks - chunks0
    launches = {n: getattr(att, n).launches for n in REPLACES}
    by_format = {n: dict(getattr(att, n).launches_by_format)
                 for n in REPLACES}
    plain_calls = sum(getattr(att, n + "_ref").calls for n in REPLACES)
    for i, toks in results.items():
        if len(toks) != SERVE_NEW or not all(0 <= t < V for t in toks):
            raise AssertionError(f"request {i}: bad output {len(toks)} tokens")
    L = cfg.n_layers
    # paged_prefill_attention has no engine caller: the run launches it 0
    # times, and its entry in the kernels line says so from this count
    want = {"ragged_paged_attention": L * chunks,
            "paged_attention": L * (8 - 1) * chunks,
            "paged_prefill_attention": 0}
    for name, n in want.items():
        if launches[name] != n or by_format[name][fmt] != n:
            raise AssertionError(f"{name}: launches {launches[name]} "
                                 f"{by_format[name]} vs {n} in {fmt} for "
                                 f"{chunks} chunks")
    if plain_calls:
        raise AssertionError(f"plain attention ran {plain_calls} times")
    skipped = cont.stats["prefill_tokens_skipped"] - skipped0
    if skipped <= 0:
        raise AssertionError("serving: the prefix cache was never hit")
    cont.check_page_conservation()
    # determinism on the card: a greedy request re-run alone
    solo = b.generate(reqs[0][0], max_new_tokens=SERVE_NEW)
    if solo != results[0]:
        raise AssertionError("serving: a greedy re-run alone differs from "
                             "its co-batched stream")
    snap = b.stats()["engine"]
    kv_bytes_per_token = snap["kv_page_bytes"] // cont.cache.page_size
    if kv_bytes_per_token != KV_BYTES_PER_TOKEN[fmt]:
        raise AssertionError(f"serving: {kv_bytes_per_token} KV bytes per "
                             f"token, not {KV_BYTES_PER_TOKEN[fmt]}")
    b.close()  # closes the engine, which checks page conservation again
    tt = sorted(ttft.values())
    gen_tokens = sum(len(t) for t in results.values())
    res = dict(
        kv_quant=kv_quant, weight_quant=snap["weight_quant"],
        requests=n_req, wall_s=wall, tokens_per_s=gen_tokens / wall,
        ttft_p50_s=tt[len(tt) // 2], ttft_p95_s=tt[int(0.95 * (len(tt) - 1))],
        chunks=chunks, launches=launches, launches_by_format=by_format,
        prefill_tokens_skipped=skipped,
        prompt_tokens=sum(len(r[0]) for r in reqs),
        decode_steps=snap["decode_steps"],
        kv_bytes_per_token=kv_bytes_per_token,
        kv_page_bytes=snap["kv_page_bytes"],
    )
    log(f"serving (qwen3-0p6b bf16, {fmt} pages, weights "
        f"{quant or 'bf16'}, 8 slots, {n_req} requests x {SERVE_NEW} "
        "tokens): "
        f"{json.dumps(res)}")
    del eng, b, cont
    torch.cuda.empty_cache()
    return res


# -- phase 6 -----------------------------------------------------------
@contextlib.contextmanager
def _plain_flash():
    """The dense engine's flash calls take the plain version while inside
    (the parity phase's reference path; the engine reads the wrapper from
    ``ops.attention`` at each forward)."""
    real = att.flash_attention

    def plain(q, k, v, *, scale, window=None, **_blocks):
        return att.flash_attention_ref(q, k, v, scale=scale, window=window)

    att.flash_attention = plain
    try:
        yield
    finally:
        att.flash_attention = real


def _dense_teacher_forced(eng, toks, mask) -> float:
    """Each layer of a fresh-cache flash prefill run twice from the SAME
    input, through the kernel and through the plain version (the plain
    path's output feeds the next layer): returns the worst |diff| / (2e-5
    + 2e-5 |plain|) over the layers' outputs (<= 1 passes)."""
    cfg, params, dev = eng.cfg, eng.params, eng.device
    B, T = toks.shape
    cache = eng.new_cache(B)
    tok_t = torch.tensor(toks, device=dev).long()
    pos = torch.arange(T, device=dev)[None].expand(B, T)
    cos, sin = ttr.rope_tables(pos, ttr._rope_dim(cfg), cfg.rope_theta)
    x = ttr._embed_tokens(params, tok_t, cfg)
    worst = 0.0
    for i, lp in enumerate(ttr._layers(params)):
        outs = []
        for fn in (att.flash_attention, att.flash_attention_ref):
            def attn(q, k, v, _bias, scale, fn=fn):
                return fn(q, k, v, scale=scale, window=cfg.sliding_window)

            kv = tuple(t.clone() for t in cache.layer_kv(i))
            outs.append(ttr._block(x, lp, cfg, cos, sin, None, kv,
                                   cache.length, attn, T))
        yk, yp = outs
        worst = max(worst, float(((yk - yp).abs()
                                  / (2e-5 + 2e-5 * yp.abs())).max()))
        x = yp
    return worst


def dense_parity() -> dict:
    """qwen3-0p6b at full width in float32 with flash_attention on: one
    prefill of two prompts (300 and 512 tokens, bucket 512) through the
    kernel and through the plain version — each layer from the same input
    within rtol = atol = 2e-5, the last-token logits within
    DENSE_LOGITS — and greedy generate_compiled, generate_beam and
    generate_lookahead token-equal on both paths (lookahead also equal to
    generate_compiled)."""
    cfg = config_presets()["qwen3-0p6b"].with_(dtype=torch.float32,
                                                flash_attention=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    params = init_params(cfg, g, device=dev)
    eng = GenerationEngine(cfg, params, max_seq_len=1024,
                           seq_buckets=(128, 256, 512), device="cuda")
    del params
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (300,
                                                                      512)]
    toks = np.zeros((2, 512), np.int32)
    mask = np.zeros((2, 512), bool)
    for i, p in enumerate(prompts):
        toks[i, :len(p)], mask[i, :len(p)] = p, True
    t0 = time.monotonic()
    att.reset_counts()
    tf_ratio = _dense_teacher_forced(eng, toks, mask)
    if tf_ratio > 1.0:
        raise AssertionError(f"dense parity: a layer's output differs beyond "
                             f"rtol = atol = 2e-5 ({tf_ratio:.2f}x the bound)")
    rep = (prompts[0][:40] * 5)[:200]  # repetitive: lookahead drafts hit

    def run():
        eng.flash_prefills = 0
        logits, _c, lens, _b = eng.prefill(prompts)
        out = dict(
            logits=logits[:len(lens)].float(),
            greedy=eng.generate_compiled(prompts, max_new_tokens=16).sequences,
            beam=eng.generate_beam([prompts[0]], num_beams=4,
                                   max_new_tokens=8).sequences,
            look=eng.generate_lookahead([rep], max_new_tokens=24).sequences,
            look_ref=eng.generate_compiled([rep],
                                           max_new_tokens=24).sequences,
            flash_prefills=eng.flash_prefills,
        )
        torch.cuda.synchronize()
        return out

    att.reset_counts()
    k = run()
    launches = att.flash_attention.launches
    with _plain_flash():
        p = run()
    if launches != cfg.n_layers * k["flash_prefills"] or not launches:
        raise AssertionError(f"dense parity: {launches} flash launches for "
                             f"{k['flash_prefills']} flash prefills")
    if not torch.isfinite(k["logits"]).all():
        raise AssertionError("dense parity: prefill logits not finite")
    dl = float((k["logits"] - p["logits"]).abs().max())
    if dl > DENSE_LOGITS:
        raise AssertionError(f"dense parity: last-token logits differ by "
                             f"{dl:.3e} (> {DENSE_LOGITS:.1e})")
    for name in ("greedy", "beam", "look"):
        if k[name] != p[name]:
            raise AssertionError(f"dense parity: {name} tokens differ\n"
                                 f"kernel {k[name]}\nplain  {p[name]}")
    if k["look"] != k["look_ref"]:
        raise AssertionError("dense parity: lookahead differs from "
                             "generate_compiled")
    res = dict(layer_ratio=tf_ratio, logits_max_abs_diff=dl,
               logits_std=float(p["logits"].std()),
               flash_launches=launches, flash_prefills=k["flash_prefills"],
               greedy_tokens=sum(len(s) for s in k["greedy"]))
    log(f"dense parity (qwen3-0p6b f32, flash kernel vs plain, prompts 300 + "
        f"512 in bucket 512): teacher-forced per layer {tf_ratio:.3f}x the "
        f"2e-5 bound; last-token logits max abs diff {dl:.3e} (limit "
        f"{DENSE_LOGITS:.1e}, plain logits std {res['logits_std']:.3f}); "
        f"greedy generate_compiled, beam 4 and lookahead token-equal; "
        f"{time.monotonic() - t0:.1f}s")
    del eng
    torch.cuda.empty_cache()
    return res


def _attn_ratio(got, want, tol) -> float:
    """The worst output row's max |got - want| over tol times that row's
    max |want| (<= 1 passes; a row of plain zeros must be zeros)."""
    d = (got.float() - want.float()).abs().amax(-1)
    ref = want.float().abs().amax(-1)
    return float((d / (tol * ref.clamp_min(1e-30))).max())


def _held(real, plain, fault, readings: list):
    """``real`` (a kernel wrapper) wrapped so that every call is also
    computed by ``plain`` and by ``fault`` on the same inputs, appending
    ``(the kernel's _attn_ratio, the fault's)`` to ``readings``."""

    def held(*a, **kw):
        out = real(*a, **kw)
        want = plain(*a, **kw)
        readings.append((_attn_ratio(out, want, BF16_ATTN_TOL),
                         _attn_ratio(fault(*a, **kw), want, BF16_ATTN_TOL)))
        return out

    return held


def _ragged_plain(q, kp, vp, bt, starts, nv, **kw):
    return att.ragged_paged_attention_ref(q, kp, vp, bt, starts, nv, **kw)


def _ragged_fault(q, kp, vp, bt, starts, nv, **kw):
    """The plain version with each row's own key masked: every row sits
    one position earlier."""
    return att.ragged_paged_attention_ref(q, kp, vp, bt, starts - 1, nv, **kw)


def _decode_plain(q, kp, vp, bt, lengths, **kw):
    return att.paged_attention_ref(q, kp, vp, bt, lengths, **kw)


def _decode_fault(q, kp, vp, bt, lengths, **kw):
    """The plain version with each row's own key masked: every slot one
    position shorter."""
    return att.paged_attention_ref(q, kp, vp, bt, lengths - 1, **kw)


def _decode_head_fault(q, kp, vp, bt, lengths, **kw):
    """The plain version with every query head group over the next kv
    head (a wrong GQA mapping)."""
    kw = {k: v.roll(-1, 1) for k, v in kw.items() if torch.is_tensor(v)} \
        | {k: v for k, v in kw.items() if not torch.is_tensor(v)}
    return att.paged_attention_ref(q, kp.roll(-1, 1), vp.roll(-1, 1), bt,
                                   lengths, **kw)


def _flash_plain(q, k, v, *, scale, window=None, **_blocks):
    return att.flash_attention_ref(q, k, v, scale=scale, window=window)


def _flash_fault(q, k, v, *, scale, window=None, **_blocks):
    """The plain version with each row's own key masked: row t over keys
    before t (row 0 sees none and gives zeros)."""
    rest = att.flash_attention_ref(q[:, 1:], k[:, :-1], v[:, :-1],
                                   scale=scale, window=window)
    return torch.cat([torch.zeros_like(q[:, :1]), rest], dim=1)


def bf16_parity() -> dict:
    """qwen3-0p6b at full width in bfloat16, where the tensor-core bodies
    run on the model's own (qk-normed) activations: (a) one ragged chunk's
    layers over MAIN's mixed block (2 prefills, 5 decodes, an idle slot)
    with fp pages of seeded random context, then one paged_decode_step of
    every slot after it (paged_attention's decode tiles), and (b) one
    flash prefill of the dense engine over two prompts (300 and 512
    tokens, bucket 512).
    Each layer's attention output, the kernel's against the plain
    version's on the same inputs, is held per row to BF16_ATTN_TOL; the
    planted fault (each row's own key masked) must read above it at every
    layer."""
    cfg = config_presets()["qwen3-0p6b"]  # bfloat16
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2468)
    params = init_params(cfg, g, device=dev)
    S, C, page = MAIN["S"], MAIN["C"], MAIN["page"]
    cache = PagedKVCache.init(cfg, S, page_size=page,
                              max_len=MAIN["n_pp"] * page, device=dev)
    n_pp = cache.pages_per_slot
    rng = np.random.default_rng(8)
    perm = rng.permutation(np.arange(1, cache.n_pages))[: S * n_pp]
    cache.block_tables.copy_(torch.from_numpy(
        perm.reshape(S, n_pp).astype(np.int32)))
    gk = torch.Generator(device=dev)
    gk.manual_seed(97)
    cache.k.normal_(generator=gk)
    cache.v.normal_(generator=gk)
    blk = torch.tensor(rng.integers(0, cfg.vocab_size, size=(S, C)),
                       dtype=torch.int32, device=dev)
    starts, nv = (torch.tensor(a, dtype=torch.int32, device=dev)
                  for a in (MAIN_STARTS, MAIN_NVALID))
    t0 = time.monotonic()
    att.reset_counts()
    paged_r: list = []
    real = paged.ragged_paged_attention  # what _ragged_block launches
    paged.ragged_paged_attention = _held(real, _ragged_plain, _ragged_fault,
                                         paged_r)
    try:
        bt = cache.block_tables
        write_pg, write_off, pos, _ = paged._ragged_write_indices(
            bt, starts, nv, page, n_pp, C)
        x = paged._embed_tokens(params, blk.long(), cfg)
        cos, sin = paged.rope_tables(pos, paged._rope_dim(cfg),
                                     cfg.rope_theta)
        for i, lp in enumerate(paged._layers(params)):
            x, _ = paged._ragged_block(x, lp, cfg, cos, sin,
                                       cache.layer_kv(i), write_pg,
                                       write_off, bt, starts, nv, True)
    finally:
        paged.ragged_paged_attention = real
    launches = att.ragged_paged_attention.launches_by_format["fp"]
    if launches != cfg.n_layers or len(paged_r) != cfg.n_layers:
        raise AssertionError(f"bf16 parity: {launches} ragged launches for "
                             f"{cfg.n_layers} layers")
    # one decode step of every slot after the chunk (the idle slot stays
    # idle), each layer's paged_attention held the same way
    lens = [st + n for st, n in zip(MAIN_STARTS, MAIN_NVALID)]
    cache.lengths.copy_(torch.tensor(lens, dtype=torch.int32))
    tok = torch.tensor(rng.integers(0, cfg.vocab_size, size=S),
                       dtype=torch.int32, device=dev)
    decode_r: list = []
    real_dec = paged.paged_attention  # what _paged_block launches
    paged.paged_attention = _held(real_dec, _decode_plain, _decode_fault,
                                  decode_r)
    try:
        logits, _ = paged.paged_decode_step(
            params, tok, cache, cache.lengths > 0, cfg, kernel=True)
    finally:
        paged.paged_attention = real_dec
    launches = att.paged_attention.launches_by_format["fp"]
    if launches != cfg.n_layers or len(decode_r) != cfg.n_layers:
        raise AssertionError(f"bf16 parity: {launches} paged_attention "
                             f"launches for {cfg.n_layers} layers")
    if not torch.isfinite(logits).all():
        raise AssertionError("bf16 parity: decode step logits not finite")
    del cache
    eng = GenerationEngine(cfg.with_(flash_attention=True), params,
                           max_seq_len=1024, seq_buckets=(128, 256, 512),
                           device="cuda")
    del params
    toks = np.zeros((2, 512), np.int32)
    for i, n in enumerate((300, 512)):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    att.reset_counts()
    dense_r: list = []
    flash = _held(att.flash_attention, _flash_plain, _flash_fault, dense_r)
    dcache = eng.new_cache(2)
    tok_t = torch.tensor(toks, device=dev).long()
    pos = torch.arange(512, device=dev)[None].expand(2, 512)
    cos, sin = ttr.rope_tables(pos, ttr._rope_dim(cfg), cfg.rope_theta)
    x = ttr._embed_tokens(eng.params, tok_t, cfg)

    def attn(q, k, v, _bias, scale):
        return flash(q, k, v, scale=scale, window=cfg.sliding_window)

    for i, lp in enumerate(ttr._layers(eng.params)):
        x = ttr._block(x, lp, cfg, cos, sin, None, dcache.layer_kv(i),
                       dcache.length, attn, 512)
    if att.flash_attention.launches != cfg.n_layers \
            or len(dense_r) != cfg.n_layers:
        raise AssertionError(f"bf16 parity: {att.flash_attention.launches} "
                             f"flash launches for {cfg.n_layers} layers")
    res = {}
    for key, r in (("ragged", paged_r), ("decode", decode_r),
                   ("flash", dense_r)):
        res[key] = max(k for k, _ in r)
        res[f"{key}_fault"] = min(f for _, f in r)
    log(f"bf16 parity (qwen3-0p6b bf16, each layer's attention output, "
        f"kernel vs plain on the same inputs, per row max |diff| within "
        f"{BF16_ATTN_TOL} x the row's max |plain|): ragged chunk over "
        f"MAIN's block {res['ragged']:.3f}x the bound (own-key fault, least "
        f"over layers: {res['ragged_fault']:.3f}x), the decode step after "
        f"it {res['decode']:.3f}x (fault {res['decode_fault']:.3f}x), flash "
        f"prefill {res['flash']:.3f}x (fault {res['flash_fault']:.3f}x); "
        f"{time.monotonic() - t0:.1f}s")
    if max(res["ragged"], res["decode"], res["flash"]) > 1.0:
        raise AssertionError(f"bf16 parity: an attention output differs "
                             f"beyond the bound: {res}")
    if min(res["ragged_fault"], res["decode_fault"],
           res["flash_fault"]) <= 1.0:
        raise AssertionError(f"bf16 parity: the planted fault passes the "
                             f"check, which then proves nothing: {res}")
    del eng
    torch.cuda.empty_cache()
    return res


# -- phase 7 -----------------------------------------------------------
def _sync_s(fn):
    """Run ``fn`` and return ``(its result, wall seconds to the device's
    end)``."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


def dense_serving() -> dict:
    """qwen3-0p6b at full width in bfloat16 with flash_attention on,
    through GenerationEngine: generate_compiled and generate_chunked on 8
    of _requests' prompts (greedy and sampled) x DENSE_NEW tokens, equal
    to each other; a 3000-token prompt (chunked prefill, flash on its
    first chunk); generate_beam and generate_lookahead; and generate_compiled
    on an int8 weights + int8 dense cache engine. The kernel's launches
    must equal n_layers x the flash prefills the engines counted, and no
    plain attention runs."""
    cfg = config_presets()["qwen3-0p6b"].with_(flash_attention=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(8765)
    params = init_params(cfg, g, device=dev)
    kw = dict(max_seq_len=4096, seq_buckets=DENSE_SEQ_BUCKETS,
              batch_buckets=(1, 2, 4, 8), device="cuda")
    eng = GenerationEngine(cfg, params, **kw)
    eng8 = GenerationEngine(cfg, params, quant="int8+kv", **kw)
    del params
    V = cfg.vocab_size
    _warm, reqs = _requests(cfg)
    reqs = reqs[:8]
    prompts = [r[0] for r in reqs]
    sp = SamplingParams.stack([SamplingParams.make(**r[1]) for r in reqs],
                              pad_to=8)
    rng = np.random.default_rng(77)
    long = rng.integers(0, V, 3000).tolist()
    rep = (prompts[1][:48] * 6)[:256]
    eng.generate_compiled([prompts[0][:64]], max_new_tokens=4)  # warm-up
    eng8.generate_compiled([prompts[0][:64]], max_new_tokens=4)
    att.reset_counts()
    eng.flash_prefills = eng8.flash_prefills = 0
    new = DENSE_NEW
    comp, t_comp = _sync_s(lambda: eng.generate_compiled(
        prompts, max_new_tokens=new, sampling=sp, seed=3))
    first = []
    t_sub = time.monotonic()

    def cb(_toks):
        if not first:
            first.append(time.monotonic() - t_sub)

    chunked, t_chunk = _sync_s(lambda: eng.generate_chunked(
        prompts, max_new_tokens=new, sampling=sp, seed=3, chunk_steps=8,
        stream_cb=cb))
    n_flash_8 = eng.flash_prefills
    one, t_long = _sync_s(lambda: eng.generate_compiled(
        [long], max_new_tokens=16))
    n_flash_long = eng.flash_prefills - n_flash_8
    beam, t_beam = _sync_s(lambda: eng.generate_beam(
        [prompts[2]], num_beams=4, max_new_tokens=16))
    look, t_look = _sync_s(lambda: eng.generate_lookahead(
        [rep], max_new_tokens=32))
    q8, t_q8 = _sync_s(lambda: eng8.generate_compiled(
        prompts, max_new_tokens=new, sampling=sp, seed=3))
    launches = att.flash_attention.launches
    plain = {f.__name__: f.calls for f in att._REFS if f.calls}
    n_prefills = eng.flash_prefills + eng8.flash_prefills
    L = cfg.n_layers
    if launches != L * n_prefills or not launches:
        raise AssertionError(f"dense serving: {launches} flash launches for "
                             f"{n_prefills} flash prefills x {L} layers")
    if plain:
        raise AssertionError(f"dense serving: plain attention ran {plain}")
    if n_flash_8 != 2 or n_flash_long != 1:
        raise AssertionError(f"dense serving: flash prefills {n_flash_8} "
                             f"(8 prompts, twice) and {n_flash_long} (the "
                             "3000-token prompt, first chunk only)")
    if chunked.sequences != comp.sequences:
        raise AssertionError("dense serving: generate_chunked differs from "
                             "generate_compiled")
    for name, r, n in (("compiled", comp, new), ("int8+kv", q8, new),
                       ("long", one, 16), ("beam", beam, 16),
                       ("lookahead", look, 32)):
        for s in r.sequences:
            if len(s) != n or not all(0 <= t < V for t in s):
                raise AssertionError(f"dense serving {name}: bad output "
                                     f"{len(s)} tokens")
    gen = sum(len(s) for s in comp.sequences)
    res = dict(
        requests=len(prompts), prompt_tokens=sum(len(p) for p in prompts),
        new_tokens=new, compiled_s=t_comp, compiled_tokens_per_s=gen / t_comp,
        chunked_s=t_chunk, chunked_ttft_s=first[0],
        long_prompt_s=t_long, beam_s=t_beam, lookahead_s=t_look,
        lookahead=eng.last_lookahead_stats, int8_kv_s=t_q8,
        int8_kv_tokens_per_s=gen / t_q8,
        flash_prefills=n_prefills, launches=launches,
    )
    log(f"dense serving (qwen3-0p6b bf16, flash on, GenerationEngine): "
        f"{json.dumps(res)}")
    del eng, eng8
    torch.cuda.empty_cache()
    return res


# -- phase 8: the rest of the single-card engine -------------------------
# speculative decoding, live migration with drain and handoff, the
# host-RAM prefix tier and the fleet pull, co-hosting on a shared page
# pool, and live weight publish — all qwen3-0p6b in bf16 at full width,
# through the CUDA kernels
NEW_PATHS = ("ragged_paged_attention", "paged_attention")
# spec == plain on the card: a greedy stream may part only where the plain
# run's top-two logit gap is within this (bf16 logits; H100 readings: the
# streams that part do so at gaps of 0 and 0.015625, and the top logits
# of draws made from equal tokens differ by at most 0.03125)
SPEC_TIE = 0.0625
GEMM_ROWS_M = (8, 72, 1024)  # decode slots, 8 verify slots of 9, a block
_MODEL: dict = {}
# the depth of _model()'s tree (phases 8-9, 11's serve-and-train, 15 and
# 19's tp serving): cut from 28 so that the whole script stays well inside
# its time limit; phases 5-7 serve at full depth
MODEL_LAYERS = 14
SPEC_LAYERS = 28  # spec serving's depth (spec_serving says why)


def gemm_rows(device: str = "cuda") -> dict:
    """Whether a row's bits depend on the GEMM's height: the same rows
    through ``models/quant.py::matmul`` at M = 8 and 72 against the same
    rows inside M = 1024 (qwen3-0p6b's q, kv, MLP and output widths), and
    through one whole layer's non-attention work (norm, q/k/v projections
    with qk-norm and rope, output projection, MLP) as a [8, 1] decode
    batch against the same rows of an [8, 128] block. bf16 and f32 (TF32
    off); weights random from a seed. Returns and prints, per case, rows
    bitwise equal or the max |diff|. Runs on the card or, with
    ``device="cpu"``, on the host (python -c "import chip_smoke as c;
    c.gemm_rows('cpu')")."""
    from tensorlink_tpu_torch.models.quant import matmul

    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    out: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        cfg = config_presets()["qwen3-0p6b"].with_(
            n_layers=1, vocab_size=1024, dtype=dtype)
        g = torch.Generator(device=dev)
        g.manual_seed(31)
        params = init_params(cfg, g, device=dev)
        lp = ttr._layers(params)[0]
        d = cfg.d_model
        for name, w in (("wq", lp["attn"]["wq"]), ("wk", lp["attn"]["wk"]),
                        ("w_up", lp["mlp"]["w_up"]),
                        ("w_down", lp["mlp"]["w_down"])):
            x = torch.randn((1024, w.shape[0]), generator=g, device=dev)
            x = x.to(dtype)
            full = matmul(x, w)
            for m in GEMM_ROWS_M[:-1]:
                part = matmul(x[:m], w)
                diff = (part.float() - full[:m].float()).abs().max().item()
                out[f"{dt} matmul {name} M={m} vs 1024"] = (
                    "bitwise" if torch.equal(part, full[:m]) else diff)
        S, C = 8, 128
        x = torch.randn((S, C, d), generator=g, device=dev).to(dtype)
        pos = torch.arange(C, device=dev)[None, :].expand(S, C) + 300
        cols = torch.arange(S, device=dev) * 13 % C
        rows = torch.arange(S, device=dev)

        def layer(xb, pb):
            cos, sin = ttr.rope_tables(pb, ttr._rope_dim(cfg),
                                       cfg.rope_theta)
            h = ttr._norm(xb, lp["ln1"], cfg)
            q, k, v = ttr._qkv(h, lp, cfg, cos, sin)
            return k, v, ttr._residual(xb, q, lp, cfg)

        blk = layer(x, pos)
        dec = layer(x[rows, cols][:, None].contiguous(),
                    pos[rows, cols][:, None].contiguous())
        for name, a, b in zip(("k", "v", "out"), dec, blk):
            a, b = a[:, 0], b[rows, cols]
            out[f"{dt} layer {name} [8,1] vs [8,128]"] = (
                "bitwise" if torch.equal(a, b)
                else (a.float() - b.float()).abs().max().item())
    log(f"gemm rows ({device}): {json.dumps(out)}")
    return out


def _model(n_layers: int = MODEL_LAYERS):
    """qwen3-0p6b in bf16 at full width, random weights from a seed (one
    copy for every engine of phase 8), cut to its first ``n_layers`` of
    28 layers (a copy of those layers, made once)."""
    if not _MODEL:
        cfg = config_presets()["qwen3-0p6b"]
        g = torch.Generator(device="cuda")
        g.manual_seed(4321)
        _MODEL[cfg.n_layers] = cfg, init_params(cfg, g, device="cuda")
    if n_layers not in _MODEL:
        from tensorlink_tpu_torch.engine.optimizers import tree_map

        cfg, params = _MODEL[config_presets()["qwen3-0p6b"].n_layers]
        _MODEL[n_layers] = cfg.with_(n_layers=n_layers), dict(
            params, layers=tree_map(lambda t: t[:n_layers].clone(),
                                    params["layers"]))
    return _MODEL[n_layers]


def _gen(max_seq_len=4096, quant=None, n_layers=MODEL_LAYERS):
    cfg, params = _model(n_layers)
    return GenerationEngine(cfg, params, max_seq_len=max_seq_len,
                            quant=quant, device="cuda")


def _cont(gen, **kw):
    from tensorlink_tpu_torch.engine.continuous import ContinuousEngine

    for k, v in dict(max_slots=8, page_size=16, chunk_steps=8,
                     prefill_chunk=128).items():
        kw.setdefault(k, v)
    return ContinuousEngine(gen, **kw)


class _Launches:
    """The kernel counts of one phase: reset on entry; on :meth:`check`,
    every engine of the phase took the CUDA kernels (one ragged launch a
    layer per chunk, chunk_steps - 1 decode launches a layer per chunk,
    each once a shard for a tensor-parallel engine), in the expected page
    formats, and no plain version ran."""

    def __init__(self, label: str):
        self.label = label
        self.engines: list = []
        att.reset_counts()

    def add(self, ce):
        if not ce.use_kernel:
            raise AssertionError(f"{self.label}: an engine off the kernels")
        ce._chunks0 = ce.chunks
        self.engines.append(ce)
        return ce

    def check(self) -> dict:
        depths = {e.cfg.n_layers for e in self.engines}
        if len(depths) != 1:
            raise AssertionError(f"{self.label}: engines of depths {depths}")
        L = depths.pop()
        chunks = sum(e.chunks - e._chunks0 for e in self.engines)
        # a sharded engine (tensor-parallel, or over a placed tree)
        # launches each kernel once a shard of its pages
        launched = sum(e.cache.tp * (e.chunks - e._chunks0)
                       for e in self.engines)
        steps = {e.chunk_steps for e in self.engines}
        if chunks == 0 or len(steps) != 1:
            raise AssertionError(f"{self.label}: {chunks} chunks")
        want = {"ragged_paged_attention": L * launched,
                "paged_attention": L * (steps.pop() - 1) * launched}
        got = {n: getattr(att, n).launches for n in NEW_PATHS}
        plain = {f.__name__: f.calls for f in att._REFS if f.calls}
        if got != want or plain:
            raise AssertionError(f"{self.label}: launches {got} vs {want}, "
                                 f"plain versions {plain}")
        fmts = {n: {f: c for f, c in getattr(att, n).launches_by_format
                    .items() if c} for n in NEW_PATHS}
        return dict(chunks=chunks, launches=got, by_format=fmts)


def _equal_stream(label, got, want) -> bool:
    """A path that computes every row at the same GEMM heights as its
    reference must give the reference's greedy stream exactly."""
    if list(got) != list(want):
        i = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y),
                 min(len(got), len(want)))
        raise AssertionError(f"{label}: the stream parts at token {i}")
    return True


def _spec_prompts(cfg):
    """8 repetitive prompts (two-token and five-token cycles, and a
    "code-like" block repeated) and 8 of _requests' prompts with their
    knobs (half greedy, half sampled)."""
    rng = np.random.default_rng(99)
    V = cfg.vocab_size
    reps = []
    for i in range(8):
        unit = rng.integers(0, V, (2, 5, 24, 3)[i % 4]).tolist()
        reps.append(((unit * (600 // len(unit)))[: 200 + 50 * i], {}))
    _warm, reqs = _requests(cfg)
    return reps + [reqs[i] for i in range(8)]


def _draw_recorder(store: list):
    """Wrappers for ``paged._row_keys``/``paged._sample_rows`` that keep,
    per draw, each row's (seed, step) and its logits' top two values and
    ids — on the card, read once after the run."""
    real_keys, real_sample = paged._row_keys, paged._sample_rows
    cur = {}

    def keys(seeds, steps):
        cur["ids"] = (seeds, steps)
        return real_keys(seeds, steps)

    def sample(logits, *a):
        v, i = torch.topk(logits.float(), 2, dim=-1)
        store.append((*cur["ids"], v, i))
        return real_sample(logits, *a)

    return keys, sample


def _draws(store) -> dict:
    """(seed, step) → (top-two values, ids) of the draw made there: the
    LAST row recorded under that key (a row the verify walk stopped, or a
    finished slot's frozen row, is recorded earlier or under a step no
    draw uses)."""
    out = {}
    for seeds, steps, v, i in store:
        seeds, steps = seeds.tolist(), steps.tolist()
        v, i = v.tolist(), i.tolist()
        for r in range(len(seeds)):
            out[(seeds[r], steps[r])] = (v[r], i[r])
    return out


def _top_is(v, ids, tok) -> bool:
    """``tok`` is a greedy draw of these top two (ties both count)."""
    return ids[0] == tok or (ids[1] == tok and v[1] == v[0])


def spec_serving(kv_quant: str) -> dict:
    """Speculative decoding at full width: 16 requests x 64 tokens (8
    repetitive, 8 of _requests'), all opted in, on 8 slots with
    spec_draft 8, then the same requests with spec off, each draw's top
    two logits recorded. Greedy streams equal, or parted only where the
    plain run's top-two gap is within SPEC_TIE (logged with the largest
    |spec - plain| top logit over the draws made from equal tokens);
    spec_drafted > 0, more than one token per verify pass, and ragged
    launches whose verify slots carry 8 drafts (9 positions, 18 rows at
    G = 2). At full depth: the widest verify slot rests on the model's
    greedy continuations repeating the prompt's cycles (at 14 layers the
    widest held 3 drafts)."""
    cfg, _ = _model(SPEC_LAYERS)
    gen = _gen(n_layers=SPEC_LAYERS)
    prompts = _spec_prompts(cfg)
    runs = {}
    for spec in (True, False):
        ce = _cont(gen, kv_quant=kv_quant, spec_decode=spec, spec_draft=8)
        lc = _Launches(f"spec serving {kv_quant} spec={spec}")
        lc.add(ce)
        widest = [0]
        real = ce._pack_drafts

        def pack(blk, n_valid, remaining, real=real, widest=widest):
            n_spec = real(blk, n_valid, remaining)
            widest[0] = max(widest[0], int(n_spec.max()))
            return n_spec

        ce._pack_drafts = pack
        store: list = []
        real_fns = paged._row_keys, paged._sample_rows
        paged._row_keys, paged._sample_rows = _draw_recorder(store)
        try:
            reqs = [ce.submit(ids, max_new_tokens=64, seed=100 + i,
                              sampling=SamplingParams.make(**knobs),
                              speculative=True)
                    for i, (ids, knobs) in enumerate(prompts)]
            torch.cuda.synchronize()
            t0 = time.monotonic()
            ce.run_until_idle()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        finally:
            paged._row_keys, paged._sample_rows = real_fns
        if not all(r.finished and len(r.tokens) == 64 for r in reqs):
            raise AssertionError(f"spec serving {kv_quant}: a request "
                                 "did not finish")
        ce.check_page_conservation()
        snap = ce.serving_snapshot()
        runs[spec] = dict(
            streams=[list(r.tokens) for r in reqs], wall_s=wall,
            tokens_per_s=64 * len(reqs) / wall, widest=widest[0],
            launches=lc.check(), snap=snap, draws=_draws(store),
        )
        ce.close()
        del ce
    on, off = runs[True], runs[False]
    if not on["snap"]["spec_drafted"] > 0:
        raise AssertionError("spec serving: nothing was drafted")
    if not on["snap"]["spec_tokens_per_pass"] > 1:
        raise AssertionError("spec serving: tokens per pass "
                             f"{on['snap']['spec_tokens_per_pass']}")
    if on["widest"] != 8:
        raise AssertionError(f"spec serving: widest verify slot "
                             f"{on['widest']} drafts, not 8")
    parted, sampled, noise, n_cmp = [], [], 0.0, 0
    for i, ((ids, knobs), a, b) in enumerate(zip(prompts, on["streams"],
                                                 off["streams"])):
        if knobs:
            sampled.append(a == b)
            continue
        at = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                  len(b))
        for n in range(at + (at < len(b))):
            (vs, ids_s), (vp, ids_p) = (on["draws"][(100 + i, n)],
                                        off["draws"][(100 + i, n)])
            if not (_top_is(vp, ids_p, b[n]) and _top_is(vs, ids_s, a[n])):
                raise AssertionError(f"spec serving: draw {n} of request "
                                     f"{i} not recorded")
            if n < at:
                noise = max(noise, abs(vs[0] - vp[0]))
                n_cmp += 1
        if at < len(b):
            gap = vp[0] - vp[1]
            parted.append(dict(request=i, at=at, gap=gap))
            log(f"spec serving {kv_quant} request {i}: parts at token {at} "
                f"of 64, plain top-two gap {gap:.6g}")
    worst = max((p["gap"] for p in parted), default=0.0)
    res = dict(
        kv_quant=kv_quant, requests=len(prompts),
        tokens_per_s_spec_on=on["tokens_per_s"],
        tokens_per_s_spec_off=off["tokens_per_s"],
        wall_s_spec_on=on["wall_s"], wall_s_spec_off=off["wall_s"],
        spec_drafted=on["snap"]["spec_drafted"],
        spec_accepted=on["snap"]["spec_accepted"],
        spec_verify_passes=on["snap"]["spec_verify_passes"],
        spec_killed=on["snap"]["spec_killed"],
        spec_tokens_per_pass=on["snap"]["spec_tokens_per_pass"],
        widest_verify_drafts=on["widest"],
        greedy_parted=parted,
        greedy_equal=f"{16 - len(sampled) - len(parted)} of "
                     f"{16 - len(sampled)}",
        top_logit_diff_at_equal_draws=noise, equal_draws=n_cmp,
        sampled_equal=f"{sum(sampled)} of {len(sampled)}",
        launches_on=on["launches"], launches_off=off["launches"],
    )
    log(f"spec serving (qwen3-0p6b bf16, {_fmt(kv_quant)} pages, 8 slots, "
        f"spec_draft 8; readings, not a claim): {json.dumps(res)}")
    if worst > SPEC_TIE:
        raise AssertionError(f"spec serving {kv_quant}: a greedy stream "
                             f"parts at a plain top-two gap {worst} > "
                             f"{SPEC_TIE}")
    del gen
    torch.cuda.empty_cache()
    return res

def _ship(src, dst, req, mig_id):
    """Freeze ``req``'s slot on ``src``, export through the TLTS frame,
    stage on ``dst``, commit, and resubmit with the ticket."""
    from tensorlink_tpu_torch.core import serialization as ser

    slot = req.slot
    src.freeze_slot(slot)
    src.check_page_conservation()
    chain, limit = src.migration_chain(slot)
    blob = src.export_slot(slot, n_skip=dst.resident_prefix_pages(chain,
                                                                  limit))
    blob = ser.decode(ser.encode(blob), copy=True)
    if not dst.stage_migration(mig_id, blob):
        raise AssertionError(f"migration {mig_id}: staging refused")
    moved = src.commit_migration(slot)
    return dst.submit(
        moved.prompt + moved.tokens,
        max_new_tokens=moved.budget - len(moved.tokens),
        sampling=moved.sampling, seed=moved.seed,
        start_step=moved.start_step + len(moved.tokens), adopt=mig_id,
    ), moved, int(blob["k"].shape[0])


def migration_phase() -> dict:
    """Two ContinuousEngines on the card, for fp, int8 and int4 pages: a
    greedy stream frozen mid-decode (with a neighbour decoding on each
    engine), exported, staged and adopted, equal to its uninterrupted
    run; pages in transit 0 and conservation on both; an int4 → int8
    staging refused. Then one prefill→decode handoff and a drain that
    sheds the queue onto the other engine. Streams are held equal token
    for token: every row runs at its reference's GEMM heights."""
    cfg, _ = _model()
    gen = _gen()
    rng = np.random.default_rng(55)
    prompt = rng.integers(0, cfg.vocab_size, 700).tolist()
    res: dict = {}
    exported: dict = {}
    for kv_quant in ("none", "int8", "int4"):
        lc = _Launches(f"migration {kv_quant}")
        ref = lc.add(_cont(gen, kv_quant=kv_quant))
        want = ref.submit(prompt, max_new_tokens=48, seed=3)
        ref.run_until_idle()
        src = lc.add(_cont(gen, kv_quant=kv_quant))
        dst = lc.add(_cont(gen, kv_quant=kv_quant))
        src.submit(prompt[:300], max_new_tokens=64, seed=4)
        dst.submit(prompt[100:500], max_new_tokens=64, seed=5)
        r = src.submit(prompt, max_new_tokens=48, seed=3)
        while len(r.tokens) < 20:
            src.step_chunk()
        dst.step_chunk()
        r2, moved, n_pages = _ship(src, dst, r, f"m-{kv_quant}")
        src.run_until_idle()
        dst.run_until_idle()
        got = moved.tokens + r2.tokens
        same = _equal_stream(f"migration {kv_quant}", got, want.tokens)
        for e in (src, dst):
            if e.serving_snapshot()["pages_in_transit"]:
                raise AssertionError("migration: pages left in transit")
            e.check_page_conservation()
        if dst.stats["migrations_adopted"] != 1:
            raise AssertionError("migration: the ticket was not adopted")
        exported[kv_quant] = src
        res[_fmt(kv_quant)] = dict(stream=same, pages_shipped=n_pages,
                                   launches=lc.check())
        for e in (ref, dst):
            e.close()
    # int4 pages cannot land in an int8 engine (same byte dtype)
    src, dst = exported["int4"], _cont(gen, kv_quant="int8")
    r = src.submit(prompt[:200], max_new_tokens=32, seed=6)
    while len(r.tokens) < 10:
        src.step_chunk()
    src.freeze_slot(r.slot)
    if dst.stage_migration("x", src.export_slot(r.slot)):
        raise AssertionError("migration: int4 pages staged into int8")
    dst.check_page_conservation()
    src.abort_migration(r.slot)
    src.run_until_idle()
    for e in list(exported.values()) + [dst]:
        e.close()
    res["int4_to_int8_refused"] = True

    # one prefill→decode handoff and one drain
    lc = _Launches("handoff and drain")
    ref = lc.add(_cont(gen))
    want = ref.submit(prompt[:400], max_new_tokens=32, seed=8)
    ref.run_until_idle()
    pre = lc.add(_cont(gen, handoff_after_prefill=True,
                       worker_role="prefill"))
    dec = lc.add(_cont(gen, worker_role="decode"))
    pre.submit(prompt[:400], max_new_tokens=32, seed=8, handoff=True)
    manifest = []
    while not manifest:
        pre.step_chunk()
        manifest = pre.handoff_manifest()
    (slot, req), = manifest
    chain, limit = pre.migration_chain(slot)
    blob = pre.export_slot(slot, n_skip=dec.resident_prefix_pages(chain,
                                                                  limit))
    if not dec.stage_migration("h", blob):
        raise AssertionError("handoff: staging refused")
    moved = pre.commit_handoff(slot)
    r2 = dec.submit(moved.prompt, max_new_tokens=moved.budget,
                    seed=moved.seed, adopt="h")
    dec.run_until_idle()
    hand = _equal_stream("handoff", r2.tokens, want.tokens)
    if pre.stats["handoffs_completed"] != 1 or moved.tokens:
        raise AssertionError("handoff: not completed at the boundary")
    queued = [pre.submit(prompt[i:i + 200], max_new_tokens=16, seed=i)
              for i in range(0, 80, 8)]
    pre.begin_drain()
    shed = pre.shed_queued()
    if len(shed) != len(queued) or pre.submit([1, 2],
                                              max_new_tokens=2).error is None:
        raise AssertionError("drain: the fence did not hold")
    moved_q = [dec.submit(q.prompt, max_new_tokens=q.budget, seed=q.seed)
               for q in shed]
    dec.run_until_idle()
    if not all(q.finished and len(q.tokens) == 16 for q in moved_q):
        raise AssertionError("drain: a shed request did not finish")
    for e in (pre, dec, ref):
        e.check_page_conservation()
        e.close()
    res["handoff"] = dict(stream=hand, launches=lc.check(),
                          drained=len(shed))
    log(f"migration (qwen3-0p6b bf16, 700-token prompt, frozen at 20 of 48 "
        f"tokens): {json.dumps(res)}")
    del gen
    torch.cuda.empty_cache()
    return res


def host_tier_phase() -> dict:
    """The host-RAM tier: 2 slots over a 512-position engine (65 pages),
    a 256-token shared prefix served, then three 400-token prompts of
    churn that force its pages out of the trie into the host tier; the
    re-request is promoted back (host_tier_hits > 0, prefill skipped) and
    equal to the first run. Then one fleet pull between two engines
    through make_fleet_fetcher over their router snapshots."""
    from tensorlink_tpu_torch.fleet.prefixmap import make_fleet_fetcher

    cfg, _ = _model()
    gen = _gen(max_seq_len=512)
    rng = np.random.default_rng(66)
    V = cfg.vocab_size
    shared = rng.integers(0, V, 256).tolist()
    oracle = shared + rng.integers(0, V, 40).tolist()
    churn = [rng.integers(0, V, 400).tolist() for _ in range(3)]
    lc = _Launches("host tier")
    ce = lc.add(_cont(gen, max_slots=2, host_tier_pages=64))
    first = ce.submit(oracle, max_new_tokens=32, seed=1)
    ce.run_until_idle()
    for i, p in enumerate(churn):
        ce.submit(p, max_new_tokens=32, seed=10 + i)
        ce.run_until_idle()
    demoted = ce.stats["prefix_demotions"]
    skipped0 = ce.stats["prefill_tokens_skipped"]
    again = ce.submit(oracle, max_new_tokens=32, seed=1)
    ce.run_until_idle()
    if demoted <= 0 or ce.stats["host_tier_hits"] <= 0 or \
            again.cache_tier != "host":
        raise AssertionError(f"host tier: demotions {demoted}, hits "
                             f"{ce.stats['host_tier_hits']}, tier "
                             f"{again.cache_tier}")
    skipped = ce.stats["prefill_tokens_skipped"] - skipped0
    if skipped <= 0:
        raise AssertionError("host tier: no prefill skipped")
    tier = _equal_stream("host tier", again.tokens, first.tokens)
    ce.check_page_conservation()
    snap = ce.serving_snapshot()
    ce.close()
    # the fleet pull: r1 served the prompt, r0 never saw it
    r0 = lc.add(_cont(gen, max_slots=2))
    r1 = lc.add(_cont(gen, max_slots=2))
    cold = r1.submit(oracle, max_new_tokens=32, seed=1)
    r1.run_until_idle()
    engines = {"r0": r0, "r1": r1}
    r0.fetch_prefix = make_fleet_fetcher(
        "r0", r0.page_size,
        lambda: {rid: e.router_snapshot() for rid, e in engines.items()},
        {rid: (lambda ch, lim, ns, e=e: e.export_prefix_pages(
            ch, lim, n_skip=ns)) for rid, e in engines.items()},
    )
    pulled = r0.submit(oracle, max_new_tokens=32, seed=1)
    r0.run_until_idle()
    if r0.stats["fleet_pulls"] != 1 or pulled.cache_tier != "fleet":
        raise AssertionError(f"fleet pull: {r0.stats['fleet_pulls']} pulls, "
                             f"tier {pulled.cache_tier}")
    pull = _equal_stream("fleet pull", pulled.tokens, cold.tokens)
    for e in (r0, r1):
        e.check_page_conservation()
        e.close()
    res = dict(
        demotions=demoted, host_tier_hits=snap["host_tier_hits"],
        prefill_tokens_skipped=skipped, stream=tier,
        tier_fetch_ms_count=snap["tier_fetch_ms_count"],
        tier_fetch_ms_sum=snap["tier_fetch_ms_sum"],
        fleet_pull=dict(stream=pull,
                        skipped=r0.stats["prefill_tokens_skipped"]),
        launches=lc.check(),
    )
    log(f"host tier (qwen3-0p6b bf16, fp pages, 64-page host tier): "
        f"{json.dumps(res)}")
    del gen
    torch.cuda.empty_cache()
    return res


def cohost_phase() -> dict:
    """Two tenants of one geometry on a SharedPagePool of 600 pages (bf16
    weights, and int8 weights over the same checkpoint), quotas 300 each,
    4 requests each stepped from one thread: each tenant's greedy streams
    equal its solo runs, each within its quota, the pool conserved at
    every boundary and whole at the end."""
    from tensorlink_tpu_torch.engine.paged import SharedPagePool

    cfg, _ = _model()
    gens = {"bf16": _gen(max_seq_len=2048),
            "int8": _gen(max_seq_len=2048, quant="int8")}
    rng = np.random.default_rng(77)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (300, 700, 150, 1000)]
    lc = _Launches("co-hosting")
    solo = {}
    for name, gen in gens.items():
        ce = lc.add(_cont(gen, max_slots=4))
        rs = [ce.submit(p, max_new_tokens=32, seed=i)
              for i, p in enumerate(prompts)]
        ce.run_until_idle()
        solo[name] = [list(r.tokens) for r in rs]
        ce.close()
    pool = SharedPagePool(cfg, 600, page_size=16, device="cuda")
    tenants = {name: lc.add(_cont(gen, max_slots=4, pool=pool,
                                  model_id=name, page_quota=300))
               for name, gen in gens.items()}
    a, b = tenants.values()
    if a.cache.k is not b.cache.k:
        raise AssertionError("co-hosting: tenants hold separate pages")
    reqs = {name: [ce.submit(p, max_new_tokens=32, seed=i)
                   for i, p in enumerate(prompts)]
            for name, ce in tenants.items()}
    peak = {name: 0 for name in tenants}
    while a.step_chunk() | b.step_chunk():
        pool.check_page_conservation()
        for name, ce in tenants.items():
            peak[name] = max(peak[name], ce.alloc.used)
            if ce.alloc.used > ce.alloc.quota:
                raise AssertionError(f"co-hosting: {name} over its quota")
    streams = {}
    for name in tenants:
        streams[name] = [
            _equal_stream(f"co-hosting {name} request {i}", r.tokens,
                          solo[name][i])
            for i, r in enumerate(reqs[name])]
    for ce in tenants.values():
        ce.close()
    if pool.alloc.n_free != 600 or pool.tenants:
        raise AssertionError("co-hosting: pages not returned at close")
    res = dict(streams=streams, peak_pages_used=peak, quota=300,
               launches=lc.check())
    log(f"co-hosting (qwen3-0p6b bf16 + int8 weights, one pool): "
        f"{json.dumps(res)}")
    del gens
    torch.cuda.empty_cache()
    return res


def publish_phase() -> dict:
    """publish_weights of a perturbed copy while a stream decodes: the
    stream runs to its full length, weights_version grows, the prefix
    trie is fenced, and no parameter or page tensor changes shape, dtype
    or device."""
    cfg, params = _model()
    gen = _gen()
    lc = _Launches("publish")
    ce = lc.add(_cont(gen))
    rng = np.random.default_rng(88)
    warm = rng.integers(0, cfg.vocab_size, 300).tolist()
    ce.submit(warm, max_new_tokens=4, seed=1)
    ce.run_until_idle()
    resident = ce.prefix.n_resident
    live = ce.submit(rng.integers(0, cfg.vocab_size, 500).tolist(),
                     max_new_tokens=64, seed=2)
    while len(live.tokens) < 16:
        ce.step_chunk()

    def layout():
        leaves = []

        def walk(t, path):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, f"{path}/{k}")
            else:
                leaves.append((path, tuple(t.shape), t.dtype, t.device))

        walk(gen.params, "")
        c = ce.cache
        return leaves + [(n, tuple(t.shape), t.dtype, t.device)
                         for n, t in (("k", c.k), ("v", c.v),
                                      ("bt", c.block_tables))]

    before = layout()
    new = {k: v for k, v in params.items()}
    new["final_norm"] = {"scale": params["final_norm"]["scale"] * 1.01}
    version = ce.publish_weights(new)
    fenced = ce.prefix.n_resident == 0 and not ce.prefix.match(
        warm, len(warm) - 1)
    ce.run_until_idle()
    after = layout()
    if not (live.finished and len(live.tokens) == 64):
        raise AssertionError("publish: the live stream did not finish")
    if version != 2 or ce.weights_version != 2 or not fenced:
        raise AssertionError(f"publish: version {version}, fenced {fenced}")
    if before != after:
        raise AssertionError("publish: a tensor changed shape, dtype or "
                             "device")
    ce.check_page_conservation()
    ce.close()
    res = dict(weights_version=version, resident_before=resident,
               fenced=fenced, tensors=len(before), launches=lc.check())
    log(f"publish (qwen3-0p6b bf16, mid-stream): {json.dumps(res)}")
    del gen
    torch.cuda.empty_cache()
    return res


# -- phase 9 -----------------------------------------------------------
# checkpoints written and read back by the port's loader, under the
# git-ignored build/ directory, deleted at the end of the phase
CKPT_ROOT = Path(__file__).resolve().parent / "build" / "checkpoints"
MIXTRAL_LAYERS = 2  # of 32: full depth is about 93 GB in bf16
# the bf16 MoE MLP against its f32 reference, per row: max |diff| within
# MOE_TOL x the row's max |reference| (bf16_parity's bound)
MOE_TOL = 1.6e-2
CKPT_REQUESTS = (0, 1, 2, 3, 5, 6, 7, 9)  # 8 of _requests', 0 greedy
CKPT_NEW = 32  # new tokens per request
QWEN3_SHARD_BYTES = 256 * 2**20  # qwen3-0p6b's 1.19 GB in several shards


def _hf_config(cfg) -> dict:
    """A Hugging Face config dict (Qwen3 or Mixtral field names) that
    config_from_hf parses back to ``cfg`` in bf16."""
    hf = dict(model_type=cfg.family, vocab_size=cfg.vocab_size,
              hidden_size=cfg.d_model, num_hidden_layers=cfg.n_layers,
              num_attention_heads=cfg.n_heads,
              num_key_value_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
              intermediate_size=cfg.d_ff,
              max_position_embeddings=cfg.max_seq_len,
              rms_norm_eps=cfg.norm_eps, rope_theta=cfg.rope_theta,
              tie_word_embeddings=cfg.tie_embeddings)
    if cfg.moe:
        hf.update(num_local_experts=cfg.n_experts,
                  num_experts_per_tok=cfg.n_experts_per_tok,
                  sliding_window=cfg.sliding_window)
    return hf


def _same_tree(label, got: dict, want: dict) -> int:
    """Every leaf of ``want`` bitwise in ``got`` (same dtype, shape and
    device); returns the bytes compared."""
    n = 0
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            n += _same_tree(f"{label}/{k}", g, w)
            continue
        if g.dtype != w.dtype or g.shape != w.shape \
                or g.device != w.device or not torch.equal(g, w):
            raise AssertionError(f"{label}/{k}: the loaded leaf differs")
        n += w.numel() * w.element_size()
    if set(got) != set(want):
        raise AssertionError(f"{label}: leaves {sorted(got)} vs "
                             f"{sorted(want)}")
    return n


def _load(ckpt, **kw):
    """``load_params`` onto the card, timed to the device's end."""
    (cfg, params), secs = _sync_s(lambda: load_params(ckpt, device="cuda",
                                                      **kw))
    return cfg, params, secs


def _ckpt_serve(cfg, params, kv_quant, lc, solo=False) -> list:
    """8 of _requests' prompts through one ContinuousEngine on the
    kernels (engines join ``lc``); with ``solo``, also the greedy request
    alone on a fresh engine, which must equal its co-batched stream."""
    _, all_reqs = _requests(cfg)
    reqs = [all_reqs[i] for i in CKPT_REQUESTS]
    gen = GenerationEngine(cfg, params, max_seq_len=4096, device="cuda")
    ce = lc.add(_cont(gen, kv_quant=kv_quant))
    out = [ce.submit(ids, max_new_tokens=CKPT_NEW,
                     sampling=SamplingParams.make(**knobs), seed=i)
           for i, (ids, knobs) in enumerate(reqs)]
    ce.run_until_idle()
    if not all(r.finished and r.error is None
               and len(r.tokens) == CKPT_NEW for r in out):
        raise AssertionError(f"{lc.label}: a request did not finish")
    ce.close()  # checks page conservation
    streams = [list(r.tokens) for r in out]
    if solo:
        alone = lc.add(_cont(gen, kv_quant=kv_quant))
        r = alone.submit(reqs[0][0], max_new_tokens=CKPT_NEW, seed=0)
        alone.run_until_idle()
        alone.close()
        _equal_stream(f"{lc.label}: greedy alone vs co-batched", r.tokens,
                      streams[0])
    return streams


def _moe_reference(h, p, cfg):
    """The MoE MLP in float32 over only each token's top-k experts,
    gathered per expert. It routes apart from the program: the router
    product is the plain ``h @ router`` in the model's dtype (the JAX
    model's definition), and the top-k comes from numpy's stable argsort
    on the host (ties to the lower index, as ``lax.top_k``), which
    ``ttr.top_k`` on the card must match on the same logits."""
    d, E, K = cfg.d_model, cfg.n_experts, cfg.n_experts_per_tok
    x = h.reshape(-1, d).float()
    logits = (h @ p["router"]).float().reshape(-1, E)
    order = np.argsort(-logits.cpu().numpy(), axis=-1, kind="stable")
    topi = torch.from_numpy(order[:, :K].copy()).to(h.device)
    if not torch.equal(ttr.top_k(logits, K)[1], topi):
        raise AssertionError("MoE check: ttr.top_k picks other experts "
                             "than numpy's stable sort")
    w = torch.softmax(logits.gather(-1, topi), dim=-1)
    out = torch.zeros_like(x)
    for e in range(E):
        rows, rank = (topi == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        y = (ttr._act(xe @ p["w_gate"][e].float(), cfg.act)
             * (xe @ p["w_up"][e].float())) @ p["w_down"][e].float()
        out.index_add_(0, rows, y * w[rows, rank, None])
    return out.reshape(h.shape)


def _moe_check(cfg, chunk_calls) -> dict:
    """Each layer's dense-dispatch _moe_mlp of one ragged chunk (inputs
    and output recorded while the engine ran it) against
    _moe_reference, per row within MOE_TOL x the row's max; a third
    expert's gate switched on (top-3) must read above the bound; the
    capacity dispatch at capacity factor E/K within the same bound of the
    dense dispatch. Also reads how many tokens a float32 router product
    would route to another top-k set (not a gate)."""
    K = cfg.n_experts_per_tok
    res = dict(dense=0.0, fault=float("inf"), sparse=0.0,
               f32_router_rerouted=0, tokens=0)
    for h, p, out in chunk_calls:
        want = _moe_reference(h, p, cfg)
        res["dense"] = max(res["dense"], _attn_ratio(out, want, MOE_TOL))
        fault = ttr._moe_mlp(h, p, cfg.with_(n_experts_per_tok=K + 1))
        res["fault"] = min(res["fault"], _attn_ratio(fault, want, MOE_TOL))
        sparse = sparse_moe_mlp(h, p, cfg,
                                capacity_factor=cfg.n_experts / K)
        res["sparse"] = max(res["sparse"], _attn_ratio(sparse, out, MOE_TOL))
        bf = ttr.top_k(ttr._mm(h, p["router"]).float(), K)[1]
        f32 = ttr.top_k(h.float() @ p["router"].float(), K)[1]
        res["f32_router_rerouted"] += int(
            (bf.sort(-1).values != f32.sort(-1).values).any(-1).sum())
        res["tokens"] += h.shape[0] * h.shape[1]
    if res["dense"] > 1.0 or res["sparse"] > 1.0:
        raise AssertionError(f"MoE check: beyond the bound: {res}")
    if res["fault"] <= 1.0:
        raise AssertionError(f"MoE check: the planted third expert passes "
                             f"the check, which then proves nothing: {res}")
    return res


@contextlib.contextmanager
def _record_moe_chunk(calls: list, n_layers: int):
    """Record (h, layer params, output) of the first ``n_layers`` calls
    of the MoE MLP with more than one row per slot: one ragged chunk."""
    real = ttr._moe_mlp

    def rec(h, p, cfg):
        out = real(h, p, cfg)
        if h.shape[1] > 1 and len(calls) < n_layers:
            calls.append((h.clone(), p, out.clone()))
        return out

    ttr._moe_mlp = rec
    try:
        yield
    finally:
        ttr._moe_mlp = real


@contextlib.contextmanager
def _hold_attention(readings: dict, n_layers: int):
    """Hold the engine's first ``n_layers`` ragged launches with a valid
    row (the first chunk's layers) and its first ``n_layers`` decode
    launches with a slot of positive length (the first live decode
    step's) as bf16_parity does: each against its plain version on the
    same inputs and against a planted fault (the ragged launch's own key
    masked; the decode launch's query heads over the next kv head, since
    one key masked among a decode row's hundreds can read under the
    bound), into ``readings["ragged"]`` and ``readings["decode"]``, with
    the query and page shapes under ``readings["shapes"]``. The plain
    calls stay out of the counts that _Launches.check reads."""
    real = {"ragged": paged.ragged_paged_attention,
            "decode": paged.paged_attention}
    held = {"ragged": _held(real["ragged"], _ragged_plain, _ragged_fault,
                            readings["ragged"]),
            "decode": _held(real["decode"], _decode_plain,
                            _decode_head_fault, readings["decode"])}
    refs = (att.ragged_paged_attention_ref, att.paged_attention_ref)

    def hold(key):
        def call(q, kp, *a, **kw):
            # a[-1]: the ragged launch's n_valid, the decode's lengths
            if len(readings[key]) >= n_layers or not bool((a[-1] > 0).any()):
                return real[key](q, kp, *a, **kw)
            readings["shapes"].setdefault(
                key, dict(q=list(q.shape), pages=list(kp.shape)))
            calls = [r.calls for r in refs]
            try:
                return held[key](q, kp, *a, **kw)
            finally:
                for r, n in zip(refs, calls):
                    r.calls = n

        return call

    paged.ragged_paged_attention = hold("ragged")
    paged.paged_attention = hold("decode")
    try:
        yield
    finally:
        paged.ragged_paged_attention = real["ragged"]
        paged.paged_attention = real["decode"]


def _held_readings(label, readings: dict, n_layers: int) -> dict:
    """The worst kernel reading and the least fault reading of each held
    kernel; raises unless every layer was held, every kernel reading is
    within the bound and every fault reading above it."""
    res = {"shapes": readings["shapes"]}
    for key in ("ragged", "decode"):
        r = readings[key]
        if len(r) != n_layers:
            raise AssertionError(f"{label}: {len(r)} {key} launches held "
                                 f"for {n_layers} layers")
        res[key] = max(k for k, _ in r)
        res[f"{key}_fault"] = min(f for _, f in r)
    if max(res["ragged"], res["decode"]) > 1.0:
        raise AssertionError(f"{label}: an attention output differs beyond "
                             f"the bound: {res}")
    if min(res["ragged_fault"], res["decode_fault"]) <= 1.0:
        raise AssertionError(f"{label}: the planted fault passes the check, "
                             f"which then proves nothing: {res}")
    return res


def checkpoint_phase() -> dict:
    """qwen3-0p6b (phase 8's seeded tree) and a 2-layer full-width
    Mixtral written by export_hf and read back by load_params, bitwise;
    served through the kernels from the loaded trees."""
    smi = _smi()
    res: dict = {}
    CKPT_ROOT.mkdir(parents=True, exist_ok=True)
    try:
        # qwen3-0p6b: several 256 MiB shards and the index
        cfg, params = _model()
        d = CKPT_ROOT / "qwen3-0p6b"
        _, export_s = _sync_s(lambda: export_hf(
            cfg, params, d, hf_config=_hf_config(cfg),
            max_shard_bytes=QWEN3_SHARD_BYTES))
        shards = sorted(f.name for f in d.glob("*.safetensors"))
        if len(shards) < 3 or not (d / "model.safetensors.index.json") \
                .exists():
            raise AssertionError(f"qwen3 export: {shards}")
        lcfg, lparams, load_s = _load(d)
        if lcfg != cfg:
            raise AssertionError(f"qwen3: loaded config {lcfg} != {cfg}")
        nbytes = _same_tree("qwen3", lparams, params)
        _, part, _ = _load(d, layer_range=(10, 14))
        want = {k: v for k, v in params.items() if k != "layers"}
        want["layers"] = {
            g: {k: v[10:14] for k, v in leaves.items()}
            for g, leaves in params["layers"].items()}
        _same_tree("qwen3 layers [10, 14)", part, want)
        del part, want
        res["qwen3"] = q = dict(shards=len(shards), bytes=nbytes,
                                export_s=export_s, load_s=load_s,
                                load_gb_per_s=nbytes / load_s / 1e9)
        lc = _Launches("checkpoint qwen3")
        got = _ckpt_serve(cfg, lparams, "none", lc)
        q["launches"] = lc.check()
        lc = _Launches("checkpoint qwen3 source")
        want = _ckpt_serve(cfg, params, "none", lc)
        q["launches_source"] = lc.check()
        for i, (a, b) in enumerate(zip(got, want)):
            _equal_stream(f"qwen3 loaded vs source, request {i}", a, b)
        del lparams
        shutil.rmtree(d)
        log(f"checkpoint qwen3-0p6b bf16 ({smi}): {json.dumps(q)}")

        # Mixtral at full width, 2 of its 32 layers, default 4 GiB shards
        cfg = config_presets()["mixtral-8x7b"].with_(
            n_layers=MIXTRAL_LAYERS)
        g = torch.Generator(device="cuda")
        g.manual_seed(1357)
        params = init_params(cfg, g, device="cuda")
        d = CKPT_ROOT / "mixtral-8x7b"
        _, export_s = _sync_s(lambda: export_hf(
            cfg, params, d, hf_config=_hf_config(cfg)))
        shards = sorted(f.name for f in d.glob("*.safetensors"))
        lcfg, lparams, load_s = _load(d)
        if lcfg != cfg:
            raise AssertionError(f"mixtral: loaded config {lcfg} != {cfg}")
        nbytes = _same_tree("mixtral", lparams, params)
        del params
        torch.cuda.empty_cache()
        res["mixtral"] = m = dict(layers=cfg.n_layers, shards=len(shards),
                                  bytes=nbytes, export_s=export_s,
                                  load_s=load_s,
                                  load_gb_per_s=nbytes / load_s / 1e9)
        calls: list = []
        for kv_quant in ("none", "int8"):
            fmt = _fmt(kv_quant)
            lc = _Launches(f"checkpoint mixtral {fmt}")
            readings: dict = dict(ragged=[], decode=[], shapes={})
            with _record_moe_chunk(calls, cfg.n_layers), \
                    _hold_attention(readings, cfg.n_layers):
                _ckpt_serve(cfg, lparams, kv_quant, lc, solo=True)
            m[f"launches_{fmt}"] = lc.check()
            m[f"attention_{fmt}"] = _held_readings(
                f"checkpoint mixtral {fmt} attention", readings,
                cfg.n_layers)
        m["moe"] = _moe_check(cfg, calls)
        del calls, lparams
        shutil.rmtree(d)
        log(f"checkpoint mixtral-8x7b widths, {cfg.n_layers} layers, bf16 "
            f"({smi}; MoE bound {MOE_TOL} and attention bound "
            f"{BF16_ATTN_TOL} x the row's max): {json.dumps(m)}")
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
        torch.cuda.empty_cache()
    return res


# -- phase 10 ----------------------------------------------------------
NODE_ROOT = Path(__file__).resolve().parent / "build" / "node"
NODE_MODEL = "qwen3-0p6b"
NODE_NEW = 32  # new tokens per request
NODE_GREEDY = 8  # concurrent greedy /v1/generate requests


@contextlib.contextmanager
def _clean_spawn():
    """Start node processes from the port's node modules alone: a spawned
    child re-runs the parent's main script unless ``__main__`` has no file,
    and this script imports torch and the whole port, which a node's
    network process must not."""
    main = sys.modules["__main__"]
    path = main.__dict__.pop("__file__", None)
    try:
        yield
    finally:
        if path is not None:
            main.__file__ = path


def _http(port, method, path, body=None, rid="", timeout=900.0):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    payload = json.dumps(body).encode() if body is not None else None
    headers = {"X-Request-Id": rid} if rid else {}
    if payload is not None:
        headers["Content-Type"] = "application/json"
    conn.request(method, path, body=payload, headers=headers)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    if resp.status != 200:
        raise AssertionError(f"node: {method} {path} answered {resp.status}: "
                             f"{data[:300]!r}")
    if resp.getheader("Content-Type", "").startswith("application/json"):
        return json.loads(data)
    return data.decode()


def _sse(port, path, body, rid, timeout=900.0) -> list:
    """POST and read the whole server-sent event stream's data payloads."""
    import socket

    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    payload = json.dumps(body).encode()
    s.sendall(f"POST {path} HTTP/1.1\r\nHost: x\r\nX-Request-Id: {rid}\r\n"
              f"Content-Type: application/json\r\nContent-Length: "
              f"{len(payload)}\r\n\r\n".encode() + payload)
    buf = b""
    while chunk := s.recv(65536):
        buf += chunk
    s.close()
    head, _, rest = buf.partition(b"\r\n\r\n")
    if b" 200 " not in head.split(b"\r\n")[0]:
        raise AssertionError(f"node: SSE {path} answered {head[:200]!r}")
    return [blk.strip()[len("data: "):] for blk in rest.decode().split("\n\n")
            if blk.strip().startswith("data: ")]


def _node_messages():
    """8 greedy prompts of 64 to 1536 printable bytes, a chat turn and a
    sampled prompt, from a seed."""
    rng = np.random.default_rng(31)
    chars = np.array(list("abcdefghijklmnopqrstuvwxyz ,.ABCDEFGH0123456789"))

    def text(n):
        return "".join(rng.choice(chars, n))

    return ([text(int(rng.integers(64, 1537))) for _ in range(NODE_GREEDY)],
            text(200), text(300))


def _first_token_ms(rid: str) -> float:
    from tensorlink_tpu_torch.core.trace import get_tracer

    spans = [s for s in get_tracer().collect(rid) if s["name"] == "first_token"]
    if len(spans) != 1:
        raise AssertionError(f"node: trace {rid} has {len(spans)} first_token "
                             "spans")
    return float(spans[0]["dur_ms"])


def _net_process_libraries(node) -> list:
    """torch or jax libraries mapped into a node's network process (its
    /proc maps): the network half must load neither."""
    maps = Path(f"/proc/{node._proc.pid}/maps").read_text()
    return sorted({line.split()[-1] for line in maps.splitlines()
                   if re.search(r"libtorch|libc10|jaxlib|xla_extension",
                                line)})


def _quantiles(xs) -> tuple:
    xs = sorted(xs)
    return xs[len(xs) // 2], xs[int(0.95 * (len(xs) - 1))]


def _wait_idle(cont, rt) -> None:
    """Until the worker's slot engine has no work and its chunk count has
    stopped moving (the serial run loop may still hold a queued marker)."""
    deadline = time.monotonic() + 60
    last = -1
    while time.monotonic() < deadline:
        if not cont.has_work() and not rt.cont_scheduled and \
                cont.chunks == last:
            return
        last = cont.chunks
        time.sleep(0.2)
    raise AssertionError("node: the worker's engine never went idle")


def node_phase() -> dict:
    """The node path: a port validator (HTTP endpoint) and worker on
    127.0.0.1 host qwen3-0p6b at full width (seeded bf16, int8 KV pages
    by default) and serve 8 concurrent greedy /v1/generate requests, a
    streamed /v1/chat/completions and a sampled request through the
    worker's ContinuousEngine on the card. Holds every request finished,
    the greedy streams token-equal (and their texts equal) to an
    in-process ContinuousBatcher over the same seeded weights and knobs,
    the streamed deltas equal to the plain chat text, the worker engine's
    launch counts, /stats, /metrics and /healthz."""
    from tensorlink_tpu_torch.api.formatter import extract_reasoning_and_answer
    from tensorlink_tpu_torch.core.config import (
        MLConfig,
        ValidatorConfig,
        WorkerConfig,
    )
    from tensorlink_tpu_torch.nodes.runners import ValidatorNode, WorkerNode

    shutil.rmtree(NODE_ROOT, ignore_errors=True)
    ml = MLConfig(mesh_devices=1)  # device None: the card
    common = dict(local_test=True, log_dir=str(NODE_ROOT / "logs"),
                  env_file=str(NODE_ROOT / ".env"), ml=ml)
    nodes = []
    try:
        with _clean_spawn():
            v = ValidatorNode(ValidatorConfig(
                endpoint=True, endpoint_port=0,
                key_dir=str(NODE_ROOT / "vkeys"), **common)).start()
            nodes.append(v)
            w = WorkerNode(WorkerConfig(
                seed_validators=[["127.0.0.1", v.port]],
                key_dir=str(NODE_ROOT / "wkeys"), **common)).start()
            nodes.append(w)
        deadline = time.monotonic() + 60
        while not v.status()["peers"]:
            if time.monotonic() > deadline:
                raise AssertionError("node: the worker never joined")
            time.sleep(0.1)
        for n in nodes:
            libs = _net_process_libraries(n)
            if libs:
                raise AssertionError(f"node: the {n.role}'s network process "
                                     f"mapped {libs}")
        port = v.api.port
        t0 = time.monotonic()
        host = _http(port, "POST", "/request-model", {"hf_name": NODE_MODEL})
        host_s = time.monotonic() - t0
        if host.get("status") != "ready":
            raise AssertionError(f"node: hosting answered {host}")
        job = v.executor.hosted[NODE_MODEL]
        if job.batcher.mode != "remote":
            raise AssertionError(f"node: batcher mode {job.batcher.mode}")
        rt = w.executor.jobs[job.replicas[0]["job_id"]]
        # each request's prompt ids and tokens as the validator's batcher
        # sees them, keyed by trace id (the X-Request-Id sent)
        seen = {}
        inner = job.batcher.generate

        def recording(ids, **kw):
            out = inner(ids, **kw)
            seen[kw.get("trace_id", "")] = (list(ids), list(out))
            return out

        job.batcher.generate = recording
        greedy, chat_msg, sampled_msg = _node_messages()
        _http(port, "POST", "/v1/generate", {
            "hf_name": NODE_MODEL, "message": "warm up the slot engine",
            "max_new_tokens": 8, "do_sample": False})
        cont = rt.cont
        if cont is None or cont.kv_quant != "int8":
            raise AssertionError("node: the worker serves no int8 slot engine")
        _wait_idle(cont, rt)
        lc = _Launches("node path")
        lc.add(cont)
        chat = {"model": NODE_MODEL, "max_tokens": NODE_NEW,
                "temperature": 0.0,
                "messages": [{"role": "user", "content": chat_msg}]}
        calls = {
            f"node-greedy-{i}": lambda m=m, i=i: _http(
                port, "POST", "/v1/generate",
                {"hf_name": NODE_MODEL, "message": m, "do_sample": False,
                 "max_new_tokens": NODE_NEW}, rid=f"node-greedy-{i}")
            for i, m in enumerate(greedy)
        }
        calls["node-chat"] = lambda: _sse(
            port, "/v1/chat/completions", {**chat, "stream": True},
            "node-chat")
        calls["node-sampled"] = lambda: _http(
            port, "POST", "/v1/generate",
            {"hf_name": NODE_MODEL, "message": sampled_msg,
             "max_new_tokens": NODE_NEW, "do_sample": True,
             "temperature": 0.8, "top_k": 50, "top_p": 0.95},
            rid="node-sampled")
        results, latency, errors = {}, {}, []

        def one(rid):
            try:
                t = time.monotonic()
                results[rid] = calls[rid]()
                latency[rid] = time.monotonic() - t
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        t0 = time.monotonic()
        threads = [threading.Thread(target=one, args=(r,)) for r in calls]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.monotonic() - t0
        if errors:
            raise errors[0]
        if any(t.is_alive() for t in threads) or len(results) != len(calls):
            raise AssertionError("node: not every request finished")
        _wait_idle(cont, rt)
        launches = lc.check()
        # the streamed deltas join to the same chat request's plain text
        events = results["node-chat"]
        if events[-1] != "[DONE]":
            raise AssertionError("node: the chat stream did not end in [DONE]")
        streamed = "".join(
            c["choices"][0]["delta"].get("content") or ""
            for c in map(json.loads, events[:-1]) if c.get("choices"))
        plain = _http(port, "POST", "/v1/chat/completions", chat,
                      rid="node-chat-plain")
        if streamed != plain["choices"][0]["message"]["content"] or \
                seen["node-chat"] != seen["node-chat-plain"]:
            raise AssertionError("node: the streamed chat differs from its "
                                 "plain run")
        stats = _http(port, "GET", "/stats")
        snap = next(m for m in stats["models"]
                    if m["name"] == NODE_MODEL)["serving"]["engine"]
        # 59,136 bytes a position: 2 x 28 layers x 8 kv heads x (128 codes
        # + a 4-byte scale), in pages of 16 positions
        if snap["kv_quant"] != "int8" or snap["kv_page_bytes"] != \
                KV_BYTES_PER_TOKEN["int8"] * ml.cont_page_size:
            raise AssertionError(f"node: /stats engine {snap['kv_quant']} "
                                 f"{snap['kv_page_bytes']}")
        if "tlink_engine_" not in _http(port, "GET", "/metrics"):
            raise AssertionError("node: /metrics carries no tlink_engine_*")
        if NODE_MODEL not in _http(port, "GET", "/healthz")["hosted_models"]:
            raise AssertionError("node: /healthz does not list the model")
        http_ttft = [_first_token_ms(f"node-greedy-{i}")
                     for i in range(NODE_GREEDY)]
        tok = job.tokenizer
        node = {f"node-greedy-{i}": seen[f"node-greedy-{i}"]
                for i in range(NODE_GREEDY)}
        node_tokens = sum(len(out) for _ids, out in node.values())
        v.executor.unhost_model(NODE_MODEL)
    finally:
        for n in reversed(nodes):
            n.stop()
        # drop the worker's engine before the in-process one is built
        nodes = v = w = job = rt = cont = lc = None
        torch.cuda.empty_cache()

    # the in-process reference: the same seeded tree, the worker's knobs
    cfg = config_presets()[NODE_MODEL]
    g = torch.Generator(device="cuda")
    g.manual_seed(0)  # the hosted spec's seed
    eng = GenerationEngine(cfg, init_params(cfg, g, device="cuda"),
                           max_seq_len=min(cfg.max_seq_len, ml.max_seq_len),
                           seq_buckets=ml.seq_buckets,
                           batch_buckets=ml.batch_buckets, device="cuda")
    b = ContinuousBatcher(
        engine=eng, max_slots=ml.cont_max_slots, page_size=ml.cont_page_size,
        chunk_steps=ml.cont_chunk_steps, prefill_chunk=ml.prefill_chunk,
        prefix_cache=ml.prefix_cache, kv_quant=ml.kv_quant,
        spec_decode=ml.spec_decode, spec_draft=ml.spec_draft,
        default_priority=ml.default_priority, eos_ids=tok.eos_ids)
    ref, errors = {}, []

    def local(rid):
        try:
            ref[rid] = b.generate(node[rid][0], max_new_tokens=NODE_NEW,
                                  trace_id=f"inproc-{rid}")
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.monotonic()
    threads = [threading.Thread(target=local, args=(r,)) for r in node]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    local_wall = time.monotonic() - t0
    if errors:
        raise errors[0]
    eos = set(tok.eos_ids)
    for rid, (_ids, out) in node.items():
        _equal_stream(f"node {rid}", out, ref[rid])
        want = extract_reasoning_and_answer(
            tok.decode([t for t in ref[rid] if t not in eos]))[1]
        if results[rid]["response"] != want:
            raise AssertionError(f"node {rid}: the HTTP text differs from the "
                                 "in-process run's")
    local_ttft = [_first_token_ms(f"inproc-{rid}") for rid in node]
    b.close()
    del eng, b
    torch.cuda.empty_cache()
    greedy_lat = [latency[r] for r in node]
    p50, p95 = _quantiles(http_ttft)
    l50, l95 = _quantiles(local_ttft)
    q50, q95 = _quantiles(greedy_lat)
    res = dict(
        card=_smi(), host_s=host_s, requests=len(calls), wall_s=wall,
        http_tokens_per_s=node_tokens / wall,
        http_first_token_ms_p50=p50, http_first_token_ms_p95=p95,
        http_latency_s_p50=q50, http_latency_s_p95=q95,
        local_wall_s=local_wall,
        local_tokens_per_s=sum(len(t) for t in ref.values()) / local_wall,
        local_first_token_ms_p50=l50, local_first_token_ms_p95=l95,
        host_gap_ms=snap["host_gap_ms"], kv_page_bytes=snap["kv_page_bytes"],
        chunks=launches["chunks"], launches=launches["launches"],
        by_format=launches["by_format"],
    )
    log(f"node path (qwen3-0p6b bf16, int8 pages, validator + worker on "
        f"127.0.0.1, {len(calls)} concurrent requests x {NODE_NEW} "
        f"tokens): {json.dumps(res)}")
    return res


# -- phase 11 ----------------------------------------------------------
TRAIN_MODEL = "qwen3-0p6b"
TRAIN_SEED = 777
TRAIN_HOST_LAYERS = 2  # the card-against-host step, at full width
TRAIN_HOST_BT = (1, 64)  # its batch rows x tokens
# the node path at full width and 4 of 28 layers: each parameters()
# download ships the whole float32 tree through the P2P frames
TRAIN_NODE_LAYERS = 4
# the node path's batch rows x tokens: each step's f32 logits cross the
# user (T 128 shipped 311 MB a step), so T is cut to 64
TRAIN_NODE_BT = (2, 64)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GNORM_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-4  # each leaf's gradient, relative in its norm
TRAIN_NODE_LOSS_RTOL = 1e-4
TRAIN_NODE_PARAMS = dict(rtol=2e-4, atol=2e-5)  # tests/test_training_e2e.py
# the proof of learning: each logged gradient sketch against the sketch of
# the in-process gradients at the job's coordinates (the worker's are the
# clipped sum-form gradients, rounded to 1e-6), and the verdict's median
# cosine against the in-process log's
TRAIN_PROOF_SKETCH_COS = 0.999
TRAIN_PROOF_MEDIAN_ATOL = 0.02
TRAIN_PROOF_DRAWS = 400  # coordinate draws for the verdict's spread
PEAK_SOURCE = ("NVIDIA H100 SXM datasheet, dense: FP32 67 TFLOPS (no "
               "TF32), BF16 Tensor Core 989 TFLOPS")


def _train_cfg(n_layers: int | None, dtype):
    cfg = config_presets()[TRAIN_MODEL]
    return cfg.with_(n_layers=n_layers or cfg.n_layers, dtype=dtype)


def _seeded(cfg, device: str, seed: int = TRAIN_SEED) -> dict:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return init_params(cfg, g, device=device)


def _named(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def _leaf_errs(got: dict, want: dict) -> dict:
    """Each leaf's ``||got - want|| / ||want||`` in float64 on the host."""
    g, w = _named(got), _named(want)
    if set(g) != set(w):
        raise AssertionError(f"training: leaves {sorted(g)} vs {sorted(w)}")
    out = {}
    for k in w:
        a = g[k].detach().double().cpu()
        b = w[k].detach().double().cpu()
        out[k] = float(torch.linalg.vector_norm(a - b)
                       / torch.linalg.vector_norm(b))
    return out


def _recording(opt, store: list):
    """``opt`` whose update keeps the gradients the train step hands it."""

    def update(grads, state, params=None):
        store.append(grads)
        return opt.update(grads, state, params)

    return opt._replace(update=update)


def _timed_step(ts, params, state, batch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, m = ts.step_fn(params, state, batch)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    return params, state, loss, float(m["grad_norm"]), \
        time.perf_counter() - t0


def _keeping_grads(opt, device=None):
    """``opt`` with its update wrapped to keep a copy of each step's
    gradients (the token-mean gradients, before the clip; on ``device``
    when given, else where they are), and the list they are kept in."""
    from tensorlink_tpu_torch.engine.optimizers import tree_map

    kept = []
    update = opt.update

    def keep(grads, state, params):
        kept.append(tree_map(lambda t: t.detach().to(
            device or t.device, copy=True), grads))
        return update(grads, state, params)

    return opt._replace(update=keep), kept


def _proof_check(verdict: dict, log: list, kept: list, job_id: str) -> dict:
    """The validator's proof-of-learning verdict for one worker, held to
    what platform/proofs.py gives (a) on the log the worker recorded and
    (b) on sketches of the in-process run's gradients ``kept`` at the
    job's coordinates, each logged sketch within TRAIN_PROOF_SKETCH_COS of
    its in-process one. The verdict's ``ok`` is a property of the data:
    its continuity test asks consecutive gradients not to be
    anti-correlated, and on uniform random tokens their true cosine is
    about 0, so a 3-step log's median lands below the bar for some
    coordinate draws. Readings: the full gradients' consecutive cosines
    and the share of TRAIN_PROOF_DRAWS coordinate draws whose verdict on
    ``kept`` fails."""
    from tensorlink_tpu_torch.engine.optimizers import global_norm
    from tensorlink_tpu_torch.platform import proofs

    ok, detail = proofs.verify_proof_log(log)
    want = {"ok": ok, **detail, "total_steps": len(kept)}
    if len(log) != len(kept) or verdict != want:
        raise AssertionError(f"training node: proof verdict {verdict}, "
                             f"the worker's log gives {want}")

    def local_log(seed):
        out, prev = [], ""
        for i, g in enumerate(kept):
            e = proofs.proof_entry(i + 1, float(global_norm(g)),
                                   proofs.gradient_sketch(g, seed=seed), prev)
            out.append(e)
            prev = e["hash"]
        return out

    def cos(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))

    mine = local_log(int(job_id[:8], 16))
    sketch_cos = [cos(a["sketch"], b["sketch"]) for a, b in zip(log, mine)]
    lok, ldetail = proofs.verify_proof_log(mine)
    med, lmed = verdict.get("median_cosine"), ldetail.get("median_cosine")
    near_bar = lmed is not None and abs(lmed + 0.2) <= TRAIN_PROOF_MEDIAN_ATOL
    if (min(sketch_cos) < TRAIN_PROOF_SKETCH_COS
            or med is None or lmed is None
            or abs(med - lmed) > TRAIN_PROOF_MEDIAN_ATOL
            or (not near_bar and (ok, detail.get("reason"))
                != (lok, ldetail.get("reason")))):
        raise AssertionError(
            f"training node: proof verdict {verdict} against the in-process "
            f"gradients' {lok} {ldetail}, sketch cosines {sketch_cos}")

    def full_cos(g1, g2):
        dot = n1 = n2 = 0.0
        for a, b in zip(proofs._tree_leaves(g1), proofs._tree_leaves(g2)):
            a, b = a.double().reshape(-1), b.double().reshape(-1)
            dot, n1, n2 = dot + float(a @ b), n1 + float(a @ a), \
                n2 + float(b @ b)
        return dot / (n1 * n2) ** 0.5

    draws = np.random.default_rng(TRAIN_SEED).integers(
        0, 2**32, TRAIN_PROOF_DRAWS)
    failing = sum(not proofs.verify_proof_log(local_log(int(d)))[0]
                  for d in draws)
    return dict(verdict=verdict, in_process_verdict={"ok": lok, **ldetail},
                sketch_cos=sketch_cos,
                full_grad_cos=[full_cos(a, b) for a, b in zip(kept, kept[1:])],
                draws=int(TRAIN_PROOF_DRAWS),
                draws_failing_share=failing / TRAIN_PROOF_DRAWS)


def train_card_vs_host() -> dict:
    """One make_train_step(adamw, grad clip 1.0, remat) step of a seeded
    2-layer tree at qwen3-0p6b's widths in float32, B, T TRAIN_HOST_BT, on the
    card and on the host: loss, grad_norm and every leaf's gradient held,
    and a gradient with one layer's wq gradient zeroed read against the
    same bound."""
    from tensorlink_tpu_torch.engine.optimizers import tree_map
    from tensorlink_tpu_torch.engine.training import (
        make_optimizer,
        make_train_step,
    )

    cfg = _train_cfg(TRAIN_HOST_LAYERS, torch.float32)
    host = _seeded(cfg, "cpu")
    toks = np.random.default_rng(TRAIN_SEED).integers(
        0, cfg.vocab_size, TRAIN_HOST_BT).astype(np.int32)
    runs = {}
    for dev in ("cuda", "cpu"):
        params = host if dev == "cpu" else tree_map(lambda t: t.to(dev), host)
        grads: list = []
        ts = make_train_step(cfg, _recording(make_optimizer(
            "adamw", lr=1e-3, grad_clip=1.0), grads), remat=True)
        t0 = time.perf_counter()
        _, _, m = ts.step_fn(params, ts.init_state(params),
                             {"tokens": torch.as_tensor(toks, device=dev)})
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        runs[dev] = dict(loss=loss, grad_norm=gnorm, grads=grads[0],
                         s=time.perf_counter() - t0)
    card, cpu = runs["cuda"], runs["cpu"]
    errs = _leaf_errs(card["grads"], cpu["grads"])
    faulty = tree_map(lambda t: t, card["grads"])
    wq = faulty["layers"]["attn"]["wq"].clone()
    wq[0] = 0
    faulty["layers"]["attn"]["wq"] = wq
    fault = max(_leaf_errs(faulty, cpu["grads"]).values())
    res = dict(
        card=_smi(), loss_card=card["loss"], loss_host=cpu["loss"],
        loss_rel=_rel(card["loss"], cpu["loss"]),
        grad_norm_card=card["grad_norm"], grad_norm_host=cpu["grad_norm"],
        grad_norm_rel=_rel(card["grad_norm"], cpu["grad_norm"]),
        grad_leaf_rel_max=max(errs.values()),
        grad_leaf_rel_worst=max(errs, key=errs.get),
        fault_rel=fault, step_s_card=card["s"], step_s_host=cpu["s"],
    )
    log(f"training card vs host (qwen3-0p6b widths, {TRAIN_HOST_LAYERS} "
        f"layers, f32, B, T {TRAIN_HOST_BT}): {json.dumps(res)}")
    if res["loss_rel"] > TRAIN_LOSS_RTOL \
            or res["grad_norm_rel"] > TRAIN_GNORM_RTOL \
            or res["grad_leaf_rel_max"] > TRAIN_GRAD_RTOL:
        raise AssertionError(f"training: card and host steps differ: {res}")
    if fault <= 100 * TRAIN_GRAD_RTOL:
        raise AssertionError(f"training: a zeroed wq gradient reads only "
                             f"{fault}")
    del runs, card, cpu, host
    torch.cuda.empty_cache()
    return res


def train_full_depth() -> dict:
    """qwen3-0p6b at full width and depth in float32: eight AdamW steps on
    one repeated batch (B 4, T 256) must cut the loss by more than 10%;
    n_micro 2 against 1 on that batch; a bfloat16 n_micro=2 step whose
    accumulated gradients are float32. Readings: step ms, tokens/s and
    MFU against the datasheet peak of the dtype."""
    from tensorlink_tpu_torch.engine import training as tt

    cfg = _train_cfg(None, torch.float32)
    n_params = cfg.param_count()
    toks = torch.as_tensor(np.random.default_rng(TRAIN_SEED + 1).integers(
        0, cfg.vocab_size, (4, 256)).astype(np.int32), device="cuda")
    batch = {"tokens": toks}
    res = {"card": _smi(), "params": n_params, "peak_source": PEAK_SOURCE}

    ts = tt.make_train_step(cfg, tt.make_optimizer("adamw", lr=1e-3),
                            remat=True)
    params = _seeded(cfg, "cuda")
    state = ts.init_state(params)
    losses, secs = [], []
    for _ in range(8):
        params, state, loss, _, dt = _timed_step(ts, params, state, batch)
        losses.append(loss)
        secs.append(dt)
    del params, state
    torch.cuda.empty_cache()
    if not losses[-1] < 0.9 * losses[0]:
        raise AssertionError(f"training: 8 steps took the loss {losses}")
    step = statistics.median(secs[-5:])
    tps = toks.numel() / step
    res["f32"] = dict(losses=losses, step_ms=step * 1e3, tokens_per_s=tps,
                      mfu=6 * n_params * tps / PEAK_FLOPS[torch.float32])

    micro = {}
    for n_micro in (1, 2):
        p0 = _seeded(cfg, "cuda")
        tsm = tt.make_train_step(cfg, tt.make_optimizer("adamw", lr=1e-3),
                                 n_micro=n_micro, remat=True)
        _, _, loss, gnorm, _ = _timed_step(tsm, p0, tsm.init_state(p0), batch)
        micro[n_micro] = (loss, gnorm)
        del p0
        torch.cuda.empty_cache()
    res["n_micro"] = dict(
        loss_1=micro[1][0], loss_2=micro[2][0],
        loss_rel=_rel(micro[2][0], micro[1][0]),
        grad_norm_1=micro[1][1], grad_norm_2=micro[2][1],
        grad_norm_rel=_rel(micro[2][1], micro[1][1]))
    if res["n_micro"]["loss_rel"] > TRAIN_LOSS_RTOL \
            or res["n_micro"]["grad_norm_rel"] > TRAIN_GNORM_RTOL:
        raise AssertionError(f"training: n_micro 2 against 1: "
                             f"{res['n_micro']}")

    bcfg = cfg.with_(dtype=torch.bfloat16)
    carry = []
    inner = tt._accum_micro_grads

    def spy(*a):
        out = inner(*a)
        from tensorlink_tpu_torch.engine.optimizers import tree_leaves

        carry.append({t.dtype for t in tree_leaves(out[0])})
        return out

    tt._accum_micro_grads = spy
    try:
        tsb = tt.make_train_step(bcfg, tt.make_optimizer("adamw", lr=1e-3),
                                 n_micro=2, remat=True)
        params = _seeded(bcfg, "cuda")
        state = tsb.init_state(params)
        blosses, bsecs = [], []
        for _ in range(6):
            params, state, loss, _, dt = _timed_step(tsb, params, state,
                                                     batch)
            blosses.append(loss)
            bsecs.append(dt)
    finally:
        tt._accum_micro_grads = inner
    del params, state
    torch.cuda.empty_cache()
    if carry != [{torch.float32}] * 6 or not np.isfinite(blosses).all():
        raise AssertionError(f"training: bf16 carry {carry}, losses "
                             f"{blosses}")
    step = statistics.median(bsecs[-5:])
    tps = toks.numel() / step
    res["bf16_n_micro_2"] = dict(
        losses=blosses, carry="float32", step_ms=step * 1e3,
        tokens_per_s=tps,
        mfu=6 * n_params * tps / PEAK_FLOPS[torch.bfloat16])
    log(f"training full depth (qwen3-0p6b, 28 layers, B 4, T 256, AdamW "
        f"lr 1e-3, remat): {json.dumps(res)}")
    return res


def train_node_phase() -> dict:
    """Training over the node stack: a port validator, worker (on the
    card) and user on 127.0.0.1; a DistributedModel of qwen3-0p6b's widths
    at 4 layers in float32 trains three steps, held against
    make_train_step on the same seeded tree; proofs, checkpoint save and
    restore, and HF export. A job under SGD with momentum holds its
    params elementwise; one under AdamW holds each leaf in its norm."""
    from tensorlink_tpu_torch.core.config import (
        MLConfig,
        UserConfig,
        ValidatorConfig,
        WorkerConfig,
    )
    from tensorlink_tpu_torch.engine.paged import device_tensor
    from tensorlink_tpu_torch.engine.optimizers import tree_map
    from tensorlink_tpu_torch.engine.training import (
        causal_lm_loss,
        make_optimizer,
        make_train_step,
    )
    from tensorlink_tpu_torch.ml.module import DistributedModel
    from tensorlink_tpu_torch.nodes.runners import (
        UserNode,
        ValidatorNode,
        WorkerNode,
    )

    # its own root: phase 10, in another process, clears NODE_ROOT
    root = NODE_ROOT.parent / "train_node"
    shutil.rmtree(root, ignore_errors=True)
    cfg = _train_cfg(TRAIN_NODE_LAYERS, torch.float32)
    B, T = TRAIN_NODE_BT
    rng = np.random.default_rng(TRAIN_SEED + 2)
    batches = [rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
               for _ in range(4)]
    common = dict(local_test=True, log_dir=str(root / "logs"),
                  env_file=str(root / ".env"), ml=MLConfig(mesh_devices=1))
    nodes = []
    res = {"card": _smi(), "layers": TRAIN_NODE_LAYERS}
    try:
        with _clean_spawn():
            v = ValidatorNode(ValidatorConfig(
                endpoint=False, key_dir=str(root / "vkeys"), **common)).start()
            nodes.append(v)
            seeds = [["127.0.0.1", v.port]]
            w = WorkerNode(WorkerConfig(
                seed_validators=seeds, key_dir=str(root / "wkeys"),
                **common)).start()
            nodes.append(w)
            u = UserNode(UserConfig(
                seed_validators=seeds, key_dir=str(root / "ukeys"),
                **common)).start()
            nodes.append(u)
        deadline = time.monotonic() + 60
        while len(v.status()["peers"]) < 2:
            if time.monotonic() > deadline:
                raise AssertionError("training node: the nodes never met")
            time.sleep(0.1)

        def job(opt: str, kw: dict, pull: bool):
            """A training job of the seeded tree: three steps beside
            make_train_step in process. The worker's tree is held bitwise
            the seeded one first — through parameters() when ``pull``,
            else in the worker's memory (each download moves the whole
            float32 tree through the P2P frames). Returns the job and its
            readings."""
            t0 = time.monotonic()
            model = DistributedModel(cfg, node=u, seed=TRAIN_SEED,
                                     training=True, seq_len=T, batch=B)
            attach = time.monotonic() - t0
            rt = w.executor.jobs[model.job_id]
            ref = _seeded(cfg, "cuda")
            nbytes = _same_tree(f"training node {opt}: the worker's tree",
                                download(model) if pull else rt.params, ref)
            model.init_optimizer(opt, **kw)
            local_opt, kept = _keeping_grads(
                make_optimizer(opt, grad_clip=1.0, **kw))
            ts = make_train_step(cfg, local_opt, remat=True)
            state = ts.init_state(ref)
            out = dict(attach_s=attach, bytes_checked=nbytes, losses=[],
                       node_s=[], local_s=[])
            grads[model.job_id] = kept
            for toks in batches[:3]:
                t0 = time.perf_counter()
                r = model.train_step(toks)
                out["node_s"].append(time.perf_counter() - t0)
                ref, state, loss, _, dt = _timed_step(
                    ts, ref, state,
                    {"tokens": torch.as_tensor(toks, device="cuda")})
                out["local_s"].append(dt)
                out["losses"].append((r["loss"], loss))
                if _rel(r["loss"], loss) > TRAIN_NODE_LOSS_RTOL:
                    raise AssertionError(f"training node {opt}: losses "
                                         f"{out['losses']}")
            got = rt.params
            out["param_leaf_rel_max"] = max(_leaf_errs(got, ref).values())
            worst, bad = 0.0, 0
            for k, want in _named(ref).items():
                d = (_named(got)[k] - want).abs()
                lim = TRAIN_NODE_PARAMS["atol"] \
                    + TRAIN_NODE_PARAMS["rtol"] * want.abs()
                bad += int((d > lim).sum())
                worst = max(worst, float((d / lim).max()))
            out.update(params_outside_bound=bad, params_worst_of_bound=worst)
            return model, out

        grads = {}  # job id -> the in-process run's gradients per step

        def download(model):
            return tree_map(lambda a: device_tensor(a, "cuda"),
                            model.parameters()[0])

        # SGD with momentum: the params move linearly with the gradients,
        # so the elementwise bound holds them
        model, sgd = job("sgd", dict(lr=0.1, momentum=0.9), pull=False)
        res["sgd_momentum"] = sgd
        model.shutdown()
        grads.clear()
        if sgd["params_outside_bound"]:
            raise AssertionError(f"training node sgd: params outside "
                                 f"{TRAIN_NODE_PARAMS}: {sgd}")
        # AdamW divides each update by the gradient's own size: entries
        # whose gradient cancels to about eps move by up to lr on rounding
        # alone, so the elementwise count is a reading and each leaf is
        # held in its norm
        model, adamw = job("adamw", dict(lr=1e-3), pull=True)
        res["adamw"] = adamw
        if adamw["param_leaf_rel_max"] > TRAIN_NODE_PARAMS["rtol"]:
            raise AssertionError(f"training node adamw: {adamw}")
        rt = w.executor.jobs[model.job_id]
        pol = v.send_request("job_proofs", {"job_id": model.job_id})
        verdicts = pol.get("verdicts") or {}
        if list(verdicts) != [w.node_id]:
            raise AssertionError(f"training node: proofs {pol}")
        res["proofs"] = [_proof_check(verdicts[w.node_id], rt.proof_log,
                                      grads.pop(model.job_id), model.job_id)]

        ckpt = root / "ckpt"
        model.save_checkpoint(str(ckpt))
        snap = tree_map(lambda t: t.clone(), rt.params)
        after = model.train_step(batches[3])["loss"]
        model.restore_checkpoint(str(ckpt))
        res["bytes_restored"] = _same_tree("training node: the restored "
                                           "tree", rt.params, snap)
        again = model.train_step(batches[3])["loss"]
        with torch.no_grad():
            local = float(causal_lm_loss(
                snap, cfg, torch.as_tensor(batches[3], device="cuda"))[0])
        res["restore"] = dict(step_after_save=after, step_after_restore=again,
                              in_process=local)
        res["restore"]["bitwise"] = after == again
        if _rel(again, after) > 1e-6 or _rel(again, local) > TRAIN_LOSS_RTOL:
            raise AssertionError(f"training node: restore {res['restore']}")

        out = model.export_hf_checkpoint(str(root / "hf"))
        _, loaded = load_params(out, cfg, device="cuda")
        res["bytes_exported"] = _same_tree("training node: the exported "
                                           "tree", loaded, rt.params)
        model.shutdown()
    finally:
        for n in reversed(nodes):
            n.stop()
        nodes = v = w = u = rt = None
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    res.update(
        node_step_s=statistics.median(adamw["node_s"]),
        local_step_s=statistics.median(adamw["local_s"]),
        logits_bytes_per_step=2 * B * T * cfg.vocab_size * 4,
    )
    log(f"training node path (qwen3-0p6b widths, {TRAIN_NODE_LAYERS} "
        f"layers, f32, B {B}, T {T}, validator + worker + user on "
        f"127.0.0.1): {json.dumps(res)}")
    return res


def train_profile(steps: int = 3) -> dict:
    """Where a full-depth qwen3-0p6b train step's time goes (a tool, not a
    phase of main(); run device_phase() first): B 4, T 256, AdamW, remat,
    float32 and bfloat16, ``steps`` steps after two warm-up steps under
    torch.profiler. Prints per dtype the wall time per step, the device's
    busy time per step (the sum of its kernels' device time: one stream,
    so kernels do not overlap), the busy share of the wall, the launches
    per step, and the five kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from tensorlink_tpu_torch.engine.training import (
        make_optimizer,
        make_train_step,
    )

    out = {"card": _smi()}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = _train_cfg(None, dtype)
        toks = torch.as_tensor(np.random.default_rng(TRAIN_SEED + 1).integers(
            0, cfg.vocab_size, (4, 256)).astype(np.int32), device="cuda")
        ts = make_train_step(cfg, make_optimizer("adamw", lr=1e-3),
                             remat=True)
        params = _seeded(cfg, "cuda")
        state = ts.init_state(params)
        for _ in range(2):
            params, state, *_ = _timed_step(ts, params, state,
                                            {"tokens": toks})
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                params, state, *_ = _timed_step(ts, params, state,
                                                {"tokens": toks})
            wall = (time.perf_counter() - t0) / steps
        kernels, launches = {}, 0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0.0)
            if t > 0:
                kernels[e.key[:80]] = t / steps / 1e3
                launches += e.count
        busy = sum(kernels.values())
        top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:5])
        out[str(dtype).split(".")[-1]] = dict(
            wall_ms=wall * 1e3, device_busy_ms=busy,
            busy_share=busy / (wall * 1e3),
            launches_per_step=launches / steps, top_kernels_ms=top)
        del params, state
        torch.cuda.empty_cache()
    log(f"training profile (qwen3-0p6b, 28 layers, B 4, T 256, AdamW, remat; "
        f"per step): {json.dumps(out)}")
    return out


SERVE_TRAIN_REQUESTS = 8
SERVE_TRAIN_NEW = 64


def serve_train_phase() -> dict:
    """Serve-and-train: a ContinuousBatcher over qwen3-0p6b in bf16 (fp
    pages, 8 slots) serves 8 interactive greedy requests in two waves
    while a ServeTrainLoop (yields above best_effort, publishes every 2
    steps, 4 AdamW steps of B 2, T 128) trains between chunks. Every
    stream finishes; 4 train steps and 2 publishes; the kernels' launch
    counts per chunk; a greedy request after the last publish equals a
    fresh engine over the published tree."""
    from tensorlink_tpu_torch.engine.optimizers import tree_map
    from tensorlink_tpu_torch.engine.serve_train import ServeTrainLoop
    from tensorlink_tpu_torch.engine.training import (
        make_optimizer,
        make_train_step,
    )

    cfg, params = _model()
    knobs = dict(max_slots=8, page_size=16, chunk_steps=8,
                 prefill_chunk=128, kv_quant="none", eos_ids=[])
    b = ContinuousBatcher(engine=_gen(), **knobs)
    lc = _Launches("serve-and-train")
    lc.add(b._cont)
    rng = np.random.default_rng(TRAIN_SEED + 3)
    data = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 128)),
                            dtype=torch.int32, device="cuda")
            for _ in range(4)]
    ts = make_train_step(cfg, make_optimizer("adamw", lr=1e-3), remat=True)
    loop = ServeTrainLoop(
        b, ts, tree_map(lambda t: t.clone(), params),
        data_fn=lambda i: {"tokens": data[i]} if i < len(data) else None,
        publish_every=2, max_steps=4, peak_flops=PEAK_FLOPS[torch.bfloat16],
        cfg=cfg, yield_above="best_effort")
    prompts = [ids for ids, _ in _requests(cfg)[1][:SERVE_TRAIN_REQUESTS + 1]]
    outs, errors = {}, []

    def one(i):
        try:
            outs[i] = b.generate(prompts[i], max_new_tokens=SERVE_TRAIN_NEW,
                                 priority="interactive", timeout=600)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    def wave(ids):
        threads = [threading.Thread(target=one, args=(i,)) for i in ids]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)

    def until(cond, what):
        deadline = time.monotonic() + 300
        while not cond():
            if time.monotonic() > deadline:
                raise AssertionError(f"serve-and-train: {what}")
            time.sleep(0.05)

    t0 = time.monotonic()
    loop.attach()
    half = SERVE_TRAIN_REQUESTS // 2
    wave(range(half))
    until(lambda: loop.publishes >= 1, "no publish after the first wave")
    steps_between = loop.step
    wave(range(half, SERVE_TRAIN_REQUESTS))
    until(lambda: loop.done, "the loop did not finish")
    wall = time.monotonic() - t0
    if errors:
        raise errors[0]
    if sorted(outs) != list(range(SERVE_TRAIN_REQUESTS)) or any(
            len(o) != SERVE_TRAIN_NEW for o in outs.values()):
        raise AssertionError("serve-and-train: a stream was dropped or cut")
    last = b.generate(prompts[SERVE_TRAIN_REQUESTS],
                      max_new_tokens=SERVE_TRAIN_NEW, priority="interactive")
    snap = b._cont.serving_snapshot()
    if snap["train_steps"] != 4 or snap["weights_published"] != 2 \
            or loop.publishes != 2:
        raise AssertionError(f"serve-and-train: train_steps "
                             f"{snap['train_steps']}, published "
                             f"{snap['weights_published']}")
    launches = lc.check()
    published = tree_map(lambda t: t.clone(), b._cont.engine.params)
    b.close()
    fresh = ContinuousBatcher(
        engine=GenerationEngine(cfg, published, max_seq_len=4096,
                                device="cuda"), **knobs)
    want = fresh.generate(prompts[SERVE_TRAIN_REQUESTS],
                          max_new_tokens=SERVE_TRAIN_NEW,
                          priority="interactive")
    fresh.close()
    _equal_stream("serve-and-train: after the last publish", last, want)
    res = dict(card=_smi(), requests=SERVE_TRAIN_REQUESTS + 1,
               wall_s=wall, train_steps=snap["train_steps"],
               weights_published=snap["weights_published"],
               weights_version=snap["weights_version"],
               steps_before_second_wave=steps_between,
               train_step_ms=snap["train_step_ms"],
               train_mfu=snap["train_mfu"], losses_last=loop.last_loss,
               launches=launches)
    log(f"serve-and-train (qwen3-0p6b bf16, fp pages, 8 slots): "
        f"{json.dumps(res)}")
    del b, fresh, published, loop
    torch.cuda.empty_cache()
    return res


def training_phase() -> dict:
    return dict(
        card_vs_host=_phase("training: card vs host", train_card_vs_host),
        full_depth=_phase("training: full depth", train_full_depth),
        node=_phase("training: node path", train_node_phase),
        serve_train=_phase("training: serve-and-train", serve_train_phase),
    )


# -- phase 12 ----------------------------------------------------------
FLEET_ROOT = Path(__file__).resolve().parent / "build" / "fleet"
FLEET_ROUTED = 8  # greedy requests routed over the two replicas
FLEET_LIVE = 8  # streams live through the rolling deploy
FLEET_HANDOFF = 4  # streams through the prefill → decode pools
FLEET_RESTART = 4  # streams live when the validator crashes
FLEET_NEW = 32  # new tokens per routed or handed-off request
FLEET_LIVE_NEW = 160  # new tokens per stream live through an action
FLEET_MEM_GB = 16.0  # each worker's advertised share of the one card


class _WorkerLaunches:
    """Kernel launches per worker engine while installed: every engine a
    worker builds (``DistributedWorker._ensure_cont``) has its chunks run
    under one lock, so the global counters' change across a chunk is that
    engine's. Several workers' ML threads share the card and the counters
    otherwise."""

    def __init__(self):
        self.lock = threading.Lock()
        self.recs: list = []  # [{"worker", "ce", "chunks", "by_format"}]
        self._real = None

    def __enter__(self):
        from tensorlink_tpu_torch.ml.worker import DistributedWorker

        real = self._real = DistributedWorker._ensure_cont

        def ensure(worker, rt):
            ce = real(worker, rt)
            if ce is not None and not getattr(ce, "_fleet_counted", False):
                self._wrap(str(worker.node.node_id), ce)
            return ce

        DistributedWorker._ensure_cont = ensure
        att.reset_counts()
        return self

    def __exit__(self, *exc):
        from tensorlink_tpu_torch.ml.worker import DistributedWorker

        DistributedWorker._ensure_cont = self._real

    def _wrap(self, wid: str, ce) -> None:
        if not ce.use_kernel:
            raise AssertionError(f"fleet: worker {wid[:8]}'s engine is off "
                                 "the kernels")
        rec = {"worker": wid, "ce": ce, "chunks": 0,
               "by_format": {n: dict.fromkeys(FORMATS, 0) for n in NEW_PATHS}}
        step = ce.step_chunk

        def counted(*a, **kw):
            with self.lock:
                before = {n: dict(getattr(att, n).launches_by_format)
                          for n in NEW_PATHS}
                c0 = ce.chunks
                try:
                    return step(*a, **kw)
                finally:
                    for n in NEW_PATHS:
                        for f, c in getattr(att, n).launches_by_format.items():
                            rec["by_format"][n][f] += c - before[n][f]
                    rec["chunks"] += ce.chunks - c0

        ce.step_chunk = counted
        ce._fleet_counted = True
        with self.lock:
            self.recs.append(rec)

    def mark(self) -> dict:
        """The counts so far, per engine (a step's baseline)."""
        with self.lock:
            return {id(r["ce"]): (r["chunks"], {n: dict(f) for n, f in
                                                r["by_format"].items()})
                    for r in self.recs}

    def since(self, label: str, base: dict, min_workers: int) -> dict:
        """Each worker's launches since ``base``: every worker whose
        engines ran a chunk launched both paged kernels, in int8, one
        ragged launch a layer per chunk and chunk_steps - 1 decode
        launches; no plain version ran; at least ``min_workers``
        served."""
        per: dict = {}
        with self.lock:
            for r in self.recs:
                c0, f0 = base.get(id(r["ce"]), (0, None))
                chunks = r["chunks"] - c0
                if not chunks:
                    continue
                ce = r["ce"]
                L = ce.cfg.n_layers
                got = {n: {f: c - (f0[n][f] if f0 else 0)
                           for f, c in r["by_format"][n].items()}
                       for n in NEW_PATHS}
                want = {"ragged_paged_attention": L * chunks,
                        "paged_attention": L * (ce.chunk_steps - 1) * chunks}
                if {n: sum(got[n].values()) for n in NEW_PATHS} != want or \
                        any(got[n]["int8"] != want[n] for n in NEW_PATHS):
                    raise AssertionError(f"fleet {label}: worker "
                                         f"{r['worker'][:8]} launches {got} "
                                         f"for {chunks} chunks")
                w = per.setdefault(r["worker"][:8], {
                    "chunks": 0, **{n: 0 for n in NEW_PATHS}})
                w["chunks"] += chunks
                for n in NEW_PATHS:
                    w[n] += got[n]["int8"]
        plain = {f.__name__: f.calls for f in att._REFS if f.calls}
        if plain:
            raise AssertionError(f"fleet {label}: plain versions {plain}")
        if len(per) < min_workers or not all(
                w[n] > 0 for w in per.values() for n in NEW_PATHS):
            raise AssertionError(f"fleet {label}: launches per worker {per}")
        return per


def _fleet_nodes(root: Path, n_workers: int, vml, roles=None):
    """A port validator (HTTP endpoint) and ``n_workers`` workers on
    127.0.0.1, each worker on the card with a FLEET_MEM_GB share."""
    from tensorlink_tpu_torch.core.config import (
        MLConfig,
        ValidatorConfig,
        WorkerConfig,
    )
    from tensorlink_tpu_torch.nodes.runners import ValidatorNode, WorkerNode

    common = dict(local_test=True, log_dir=str(root / "logs"),
                  env_file=str(root / ".env"))
    nodes = []
    try:
        with _clean_spawn():
            v = ValidatorNode(ValidatorConfig(
                endpoint=True, endpoint_port=0, key_dir=str(root / "vkeys"),
                ml=vml, **common)).start()
            nodes.append(v)
            for i in range(n_workers):
                ml = MLConfig(spec_decode=False, max_memory_gb=FLEET_MEM_GB,
                              worker_role=(roles or {}).get(i, "mixed"),
                              mesh_devices=1)
                nodes.append(WorkerNode(WorkerConfig(
                    seed_validators=[["127.0.0.1", v.port]],
                    key_dir=str(root / f"w{i}keys"), ml=ml,
                    **common)).start())
        deadline = time.monotonic() + 60
        while len(v.status()["peers"]) < n_workers:
            if time.monotonic() > deadline:
                raise AssertionError("fleet: the workers never joined")
            time.sleep(0.1)
    except BaseException:
        for n in reversed(nodes):
            n.stop()
        raise
    return nodes


def _fleet_messages(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    chars = np.array(list("abcdefghijklmnopqrstuvwxyz ,.ABCDEFGH0123456789"))
    return ["".join(rng.choice(chars, int(rng.integers(64, 257))))
            for _ in range(n)]


def _http_all(port, calls: dict) -> tuple:
    """Run ``{rid: body}`` as concurrent /v1/generate requests; returns
    (results, wall seconds)."""
    results, errors = {}, []

    def one(rid):
        try:
            results[rid] = _http(port, "POST", "/v1/generate", calls[rid],
                                 rid=rid)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.monotonic()
    threads = [threading.Thread(target=one, args=(r,)) for r in calls]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.monotonic() - t0
    if errors:
        raise errors[0]
    if len(results) != len(calls):
        raise AssertionError("fleet: a request never finished (dropped)")
    return results, wall


def _fleet_body(message: str, n: int) -> dict:
    return {"hf_name": NODE_MODEL, "message": message, "do_sample": False,
            "max_new_tokens": n}


class _FleetRecorder:
    """The streams of phase 12 as the validator's batchers return them
    (trace id → prompt ids and tokens), the re-attached ones by jrid, the
    redirects each request followed, the page bytes each migration put
    shipped and the validator's drain summaries with their seconds."""

    def __init__(self):
        self.streams: dict = {}
        self.progress: dict = {}
        self.redirects: dict = {}
        self.put_bytes: list = []
        self.drains: list = []
        self._undo: list = []

    def _patch(self, owner, name, make):
        real = getattr(owner, name)
        setattr(owner, name, make(real))
        self._undo.append((owner, name, real))

    def __enter__(self):
        from tensorlink_tpu_torch.ml.module import DistributedModel
        from tensorlink_tpu_torch.ml.worker import DistributedWorker

        def generate(real):
            def wrapped(batcher, ids, **kw):
                tid = kw.get("trace_id") or ""
                cb = kw.get("stream_cb")
                if cb is not None:
                    # tokens streamed so far: progress that needs no text
                    # (most of the vocabulary decodes to no byte)
                    def counting(toks, cb=cb):
                        self.progress[tid] = self.progress.get(tid, 0) + \
                            sum(t is not None for t in toks)
                        return cb(toks)

                    kw["stream_cb"] = counting
                out = real(batcher, ids, **kw)
                self.streams[kw.get("trace_id") or ""] = (list(ids),
                                                          list(out))
                return out
            return wrapped

        def reattach(real):
            def wrapped(model, jrid, **kw):
                out = real(model, jrid, **kw)
                self.streams[f"reattach-{jrid}"] = (list(kw["prompt"]),
                                                    list(out))
                return out
            return wrapped

        def follow(real):
            def wrapped(model, wid, mig, **kw):
                self.redirects.setdefault(str(mig.get("trace_id") or ""),
                                          []).append(bool(mig.get("mig")))
                return real(model, wid, mig, **kw)
            return wrapped

        def mig_request(real):
            def wrapped(worker, peer, body, timeout=60.0):
                if body.get("op") == "put":
                    self.put_bytes.append(sum(
                        int(getattr(a, "nbytes", 0))
                        for a in body["blob"].values()))
                return real(worker, peer, body, timeout)
            return wrapped

        self._patch(ContinuousBatcher, "generate", generate)
        self._patch(DistributedModel, "reattach_continuous", reattach)
        self._patch(DistributedModel, "_follow_redirect", follow)
        self._patch(DistributedWorker, "_mig_request", mig_request)
        return self

    def watch_drains(self, validator) -> None:
        """Time the validator's drain_worker verbs (the autopilot's)."""
        bridge = validator.executor.bridge
        real = bridge.request

        def request(verb, payload=None, timeout=None):
            t0 = time.monotonic()
            out = real(verb, payload, timeout)
            if verb == "drain_worker":
                self.drains.append((dict(out or {}),
                                    time.monotonic() - t0))
            return out

        bridge.request = request

    def __exit__(self, *exc):
        for owner, name, real in reversed(self._undo):
            setattr(owner, name, real)


def _fleet_job(v):
    job = v.executor.hosted[NODE_MODEL]
    if job.status != "ready":
        raise AssertionError(f"fleet: hosting is {job.status}: {job.error}")
    return job


def _entry(rep) -> str:
    return rep["model"].plan.stages[0].worker_id


def _fleet_hosted(port):
    host = _http(port, "POST", "/request-model", {"hf_name": NODE_MODEL})
    if host.get("status") != "ready":
        raise AssertionError(f"fleet: hosting answered {host}")


def fleet_serving(rec, counts) -> dict:
    """Steps 1, 2 and 4 of phase 12 on one fleet: a validator with
    fleet_replicas 2 and three workers host qwen3-0p6b (two replicas on
    two workers; the third is where a rolling deploy rehosts). Routing,
    a rolling deploy of r0 under live streams, then a validator crash
    mid-decode and a restart on its journal."""
    from tensorlink_tpu_torch.api.schemas import GenerationRequest
    from tensorlink_tpu_torch.core.config import MLConfig, ValidatorConfig
    from tensorlink_tpu_torch.nodes.runners import ValidatorNode

    root = FLEET_ROOT / "fleet"
    vml = MLConfig(fleet_replicas=2, fleet_autopilot_interval_s=0.5,
                   spec_decode=False)
    nodes = _fleet_nodes(root, 3, vml)
    v, workers = nodes[0], nodes[1:]
    res: dict = {}
    try:
        port = v.api.port
        t0 = time.monotonic()
        _fleet_hosted(port)
        res["host_s"] = time.monotonic() - t0
        job = _fleet_job(v)
        entries = [_entry(r) for r in job.replicas]
        if len(set(entries)) != 2:
            raise AssertionError(f"fleet: replicas on workers {entries}")
        rec.watch_drains(v)
        # step 1: routing
        base = counts.mark()
        msgs = _fleet_messages(FLEET_ROUTED, 41)
        out, wall = _http_all(port, {
            f"fleet-route-{i}": _fleet_body(m, FLEET_NEW)
            for i, m in enumerate(msgs)})
        fleet = _http(port, "GET", "/fleet")["fleet"][NODE_MODEL]
        routed = {rid: r["routed"]
                  for rid, r in fleet["router"]["replicas"].items()}
        if fleet["replicas"] != 2 or min(routed.values()) < 1:
            raise AssertionError(f"fleet: routed {routed}")
        toks = sum(len(rec.streams[r][1]) for r in out)
        res["routing"] = dict(
            requests=len(out), wall_s=wall, http_tokens_per_s=toks / wall,
            routed=routed, launches=counts.since("routing", base, 2))
        # step 2: a rolling deploy of r0 under live streams
        base = counts.mark()
        src = next(w for w in workers if w.node_id == entries[0])
        r0_job = job.replicas[0]["job_id"]
        # the live streams enter through generate_api in process: eight
        # HTTP generations would hold all eight of the API server's
        # worker threads, and POST /fleet/deploy would wait behind them
        live = {f"fleet-live-{i}": GenerationRequest.parse(
                    _fleet_body(m, FLEET_LIVE_NEW))
                for i, m in enumerate(_fleet_messages(FLEET_LIVE, 43))}
        box: dict = {}
        live_errs: list = []

        def live_one(rid):
            try:
                box[rid] = v.executor.generate_api(live[rid], trace_id=rid)
            except Exception as e:  # noqa: BLE001 — re-raised below
                live_errs.append(e)

        runners = [threading.Thread(target=live_one, args=(r,))
                   for r in live]
        for t in runners:
            t.start()
        deadline = time.monotonic() + 300
        while True:
            # r0's streams admitted and decoding: those page-ship
            rt = src.executor.jobs.get(r0_job)
            ce = rt.cont if rt is not None else None
            try:
                kinds = [k for k, _s, _r in ce.live_manifest()] if ce else []
            except RuntimeError:  # the engine's thread changed it under us
                kinds = []
            if len(kinds) >= 2 and set(kinds) == {"decode"} and \
                    ce.stats["decode_steps"] >= 32:
                break
            if time.monotonic() > deadline:
                raise AssertionError("fleet: r0 never reached steady decode")
            time.sleep(0.05)
        t0 = time.monotonic()
        dep = _http(port, "POST", "/fleet/deploy",
                    {"model": NODE_MODEL, "replicas": ["r0"]})
        if not dep.get("ok"):
            raise AssertionError(f"fleet: deploy answered {dep}")
        while True:
            hist = _http(port, "GET", "/fleet")["fleet"][NODE_MODEL][
                "autopilot"]["history"]
            if any(h["kind"] == "deploy_done" for h in hist):
                break
            failed = [h for h in hist if "error" in h]
            if failed or time.monotonic() > deadline:
                raise AssertionError(f"fleet: deploy history {hist}")
            time.sleep(0.2)
        deploy_s = time.monotonic() - t0
        for t in runners:
            t.join(timeout=900)
        if live_errs:
            raise live_errs[0]
        if len(box) != FLEET_LIVE:
            raise AssertionError("fleet: a live stream was dropped")
        if not rec.drains:
            raise AssertionError("fleet: the deploy sent no drain")
        summary, drain_s = rec.drains[-1]
        if not summary.get("ok") or summary["migrated"] < 1 or \
                summary["migrated"] + summary["fell_back"] < 1:
            raise AssertionError(f"fleet: drain summary {summary}")
        new_entry = _entry(job.replicas[0])
        if new_entry in entries:
            raise AssertionError("fleet: r0 was not rehosted on the third "
                                 "worker")
        shipped = sum(rec.put_bytes)
        res["deploy"] = dict(
            streams=len(box), deploy_s=deploy_s, drain_s=drain_s,
            migrated=summary["migrated"], fell_back=summary["fell_back"],
            page_bytes_shipped=shipped,
            page_gb_per_s=shipped / drain_s / 1e9,
            launches=counts.since("rolling deploy", base, 2))
        # step 4: the validator crashes mid-decode and restarts
        base = counts.mark()
        jrids, errs = {}, []
        restart_msgs = _fleet_messages(FLEET_RESTART, 47)

        def stream(i, m):
            try:
                v.executor.generate_api(
                    GenerationRequest.parse(_fleet_body(m, FLEET_LIVE_NEW)),
                    on_delta=lambda _s: None,  # a streamed request
                    meta_cb=lambda meta: jrids.__setitem__(i, meta["jrid"]),
                    trace_id=f"fleet-crash-{i}")
            except Exception as e:  # noqa: BLE001 — the crash is the point
                errs.append(e)

        threads = [threading.Thread(target=stream, args=(i, m), daemon=True)
                   for i, m in enumerate(restart_msgs)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 300
        while len(jrids) < FLEET_RESTART or min(
                rec.progress.get(f"fleet-crash-{i}", 0)
                for i in range(FLEET_RESTART)) < 8:
            if errs or time.monotonic() > deadline:
                raise AssertionError(f"fleet: restart streams never decoded "
                                     f"({rec.progress}, {errs})")
            time.sleep(0.02)
        v.crash()
        t0 = time.monotonic()
        with _clean_spawn():
            v2 = ValidatorNode(ValidatorConfig(
                endpoint=True, endpoint_port=0, local_test=True,
                key_dir=str(root / "vkeys"), log_dir=str(root / "logs"),
                env_file=str(root / ".env"), ml=vml)).start()
        nodes.append(v2)
        while True:
            j2 = v2.executor.hosted.get(NODE_MODEL)
            if j2 is not None and j2.status == "ready" and \
                    not v2.executor.recovering:
                break
            if time.monotonic() > deadline:
                raise AssertionError("fleet: the journal replay never "
                                     "re-attached the model")
            time.sleep(0.05)
        reattach_s = time.monotonic() - t0
        if len(j2.replicas) != 2:
            raise AssertionError(f"fleet: {len(j2.replicas)} replicas "
                                 "re-attached")
        for i, m in enumerate(restart_msgs):
            body = dict(_fleet_body(m, FLEET_LIVE_NEW), reattach=jrids[i])
            got = v2.executor.generate_api(GenerationRequest.parse(body))
            if got["jrid"] != jrids[i]:
                raise AssertionError("fleet: re-attach answered another jrid")
            rec.streams[f"fleet-crash-{i}"] = rec.streams.pop(
                f"reattach-{jrids[i]}")
        res["restart"] = dict(
            streams=FLEET_RESTART, reattach_s=reattach_s,
            launches=counts.since("validator restart", base, 1))
        v2.executor.unhost_model(NODE_MODEL)
    finally:
        for n in reversed(nodes):
            n.stop()
    return res


def fleet_handoff(rec, counts) -> dict:
    """Step 3 of phase 12: a prefill-role and a decode-role worker; every
    request prefills on the first and is handed to the second."""
    from tensorlink_tpu_torch.core.config import MLConfig

    nodes = _fleet_nodes(FLEET_ROOT / "handoff", 2,
                         MLConfig(spec_decode=False),
                         roles={0: "prefill", 1: "decode"})
    v, pre, dec = nodes
    try:
        _fleet_hosted(v.api.port)
        job = _fleet_job(v)
        if _entry(job.replicas[0]) != pre.node_id:
            raise AssertionError("fleet: the job was not placed on the "
                                 "prefill worker")
        base = counts.mark()
        out, wall = _http_all(v.api.port, {
            f"fleet-handoff-{i}": _fleet_body(m, FLEET_NEW)
            for i, m in enumerate(_fleet_messages(FLEET_HANDOFF, 53))})
        stats = {}
        for name, w in (("prefill", pre), ("decode", dec)):
            ces = [rt.cont for rt in w.executor.jobs.values() if rt.cont]
            stats[name] = {k: sum(int(c.stats[k]) for c in ces) for k in (
                "handoffs_started", "handoffs_completed",
                "migrations_adopted")}
        if stats["prefill"]["handoffs_completed"] < 1 or \
                stats["decode"]["migrations_adopted"] < 1:
            raise AssertionError(f"fleet: handoff counters {stats}")
        res = dict(requests=len(out), wall_s=wall, counters=stats,
                   launches=counts.since("handoff", base, 2))
        v.executor.unhost_model(NODE_MODEL)
    finally:
        for n in reversed(nodes):
            n.stop()
    return res


def _fleet_reference(streams: dict, shipped: dict) -> dict:
    """Every recorded greedy stream against the same prompt alone on an
    in-process ContinuousEngine over the same seeded tree with the
    workers' knobs. Equal token for token, except a stream that took a
    re-prefill rung (a redirect with no page ticket): its KV was rebuilt
    at other GEMM heights, so it may part where the reference's top two
    logits lie within SPEC_TIE (logged)."""
    from tensorlink_tpu_torch.core.config import MLConfig
    from tensorlink_tpu_torch.engine.continuous import ContinuousEngine

    ml = MLConfig(spec_decode=False)
    cfg = config_presets()[NODE_MODEL]
    g = torch.Generator(device="cuda")
    g.manual_seed(0)  # the hosted spec's seed
    eng = GenerationEngine(cfg, init_params(cfg, g, device="cuda"),
                           max_seq_len=min(cfg.max_seq_len, ml.max_seq_len),
                           seq_buckets=ml.seq_buckets,
                           batch_buckets=ml.batch_buckets, device="cuda")
    ce = ContinuousEngine(
        eng, max_slots=ml.cont_max_slots, page_size=ml.cont_page_size,
        chunk_steps=ml.cont_chunk_steps, prefill_chunk=ml.prefill_chunk,
        prefix_cache=ml.prefix_cache, kv_quant=ml.kv_quant,
        spec_decode=False)
    from tensorlink_tpu_torch.api.tokenizer import load_tokenizer

    eos = load_tokenizer({"name": NODE_MODEL}).eos_ids
    labels = sorted(streams)
    store: list = []
    real_fns = paged._row_keys, paged._sample_rows
    paged._row_keys, paged._sample_rows = _draw_recorder(store)
    try:
        reqs = {lab: ce.submit(streams[lab][0], seed=5000 + k, eos_ids=eos,
                               max_new_tokens=(FLEET_LIVE_NEW
                                               if "live" in lab or
                                               "crash" in lab else FLEET_NEW))
                for k, lab in enumerate(labels)}
        ce.run_until_idle()
    finally:
        paged._row_keys, paged._sample_rows = real_fns
    draws = _draws(store)
    parted = []
    for k, lab in enumerate(labels):
        got, want = streams[lab][1], list(reqs[lab].tokens)
        if lab in shipped and not all(shipped[lab]):
            at = next((j for j, (x, y) in enumerate(zip(got, want))
                       if x != y), None)
            if at is None:
                _equal_stream(f"fleet {lab}", got, want)
                continue
            v, _ids = draws[(5000 + k, at)]
            gap = v[0] - v[1]
            log(f"fleet {lab} (re-prefilled): parts at token {at} of "
                f"{len(want)}, reference top-two gap {gap:.6g}")
            if gap > SPEC_TIE:
                raise AssertionError(f"fleet {lab}: a re-prefilled stream "
                                     f"parts at a gap {gap} > {SPEC_TIE}")
            parted.append(dict(stream=lab, at=at, gap=gap))
            continue
        _equal_stream(f"fleet {lab}", got, want)
    ce.close()
    del ce, eng
    torch.cuda.empty_cache()
    return dict(streams=len(labels), parted=parted)


def fleet_phase(node: dict | None = None) -> dict:
    """Phase 12, fleet serving and control-plane recovery on the card:
    qwen3-0p6b at full width, seeded bf16 weights, int8 pages, every
    worker an engine on the one card. Routing over two replicas, a
    rolling deploy under live streams, a prefill → decode handoff over
    the wire and a validator restart, each step's launches counted per
    worker; then every stream against the in-process reference."""
    shutil.rmtree(FLEET_ROOT, ignore_errors=True)
    with _FleetRecorder() as rec, _WorkerLaunches() as counts:
        serving = fleet_serving(rec, counts)
        handoff = fleet_handoff(rec, counts)
        streams = dict(rec.streams)
        shipped = dict(rec.redirects)
        totals = {n: sum(r["by_format"][n]["int8"] for r in counts.recs)
                  for n in NEW_PATHS}
        counts.recs.clear()
    torch.cuda.empty_cache()
    moved = [lab for lab, hops in shipped.items() if lab.startswith(
        "fleet-live") and all(hops)]
    if not moved:
        raise AssertionError("fleet: no live stream moved by page ship")
    ref = _fleet_reference(streams, shipped)
    res = dict(card=_smi(), **serving, handoff=handoff,
               page_shipped_streams=len(moved), reference=ref,
               by_format={n: {"int8": totals[n]} for n in NEW_PATHS})
    if node:
        res["routing"]["node_path_http_tokens_per_s"] = \
            node["http_tokens_per_s"]
    shutil.rmtree(FLEET_ROOT, ignore_errors=True)
    log(f"fleet (qwen3-0p6b bf16, int8 pages, workers sharing the card; "
        f"readings, not claims): {json.dumps(res)}")
    return res


STAGES_ROOT = Path(__file__).resolve().parent / "build" / "stages"
STAGES_SEED = 0  # the pipelined and hosted models' weights
STAGES_SEQ = 1024  # the jobs' seq_len: each session's cache room
STAGES_FWD = (4, 64)  # rows x tokens of the forward step
# step 2: 8 prompts, rows 0-3 greedy and 4-7 sampled, per-row budgets
STAGES_BUDGETS = (32, 32, 24, 32, 32, 16, 32, 28)
STAGES_SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
STAGES_GEN_SEED = 7
STAGES_BEAMS = 4
STAGES_CONT = 4  # continuous requests, admitted mid-flight into 2 slots
STAGES_HTTP = 2  # greedy /v1/generate requests to the hosted 2-stage model
# the session op of stage 0's worker (stage op or head hop, counted from
# when the plan is planted) that crashes it in step 4: mid-decode
STAGES_CRASH_OP = 13
STAGES_REPAIR_NEW = 64  # new tokens per continuous stream of step 5
STAGES_TRAIN_LAYERS = 2
STAGES_TRAIN_STEPS = 6  # the crash comes at the 4th; checkpoints every 2


class _Reference:
    """The stages' in-process reference: GenerationEngine holding the
    whole model on the card over the same seeded tree, flash off (the
    einsum attention every stage runs). Each call builds its engine over
    those params at the pipelined ops' heights: one batch bucket of the
    op's rows, one sequence bucket of its padded prompt length and a
    cache of its session's length. Its decode steps are then the stages'
    GEMMs at the stages' heights; only the prefill's head differs (the
    engine applies it to each row's last token, the head's worker to
    every position), so a stream may part at a near-tie."""

    def __init__(self, cfg, seed: int, seq_len: int):
        self.cfg = cfg.with_(flash_attention=False)
        self.params = _seeded(cfg, "cuda", seed)
        self.seq_len = seq_len

    def engine(self, rows: int, T: int, new: int) -> GenerationEngine:
        return GenerationEngine(
            self.cfg, self.params, max_seq_len=min(self.seq_len, T + new),
            seq_buckets=(T,), batch_buckets=(rows,), device="cuda")

    def generate(self, prompts, budgets, knobs, seed: int = 0,
                 eos=()) -> tuple:
        """The split job's decode as ``DistributedModel.generate``
        documents it, through the engine's prefill and decode step: each
        draw with the key ``fold_in(PRNGKey(seed), step)`` over all rows,
        per-row knobs, budgets capped by the cache's room, finished rows
        re-fed their last token. Returns (streams, gaps): a greedy row's
        gap at each draw is its top-two logit gap, a sampled row's the
        top-two gap of its gumbel-perturbed scores times its temperature
        (logit units)."""
        from tensorlink_tpu_torch.engine import prng
        from tensorlink_tpu_torch.engine.generate import _decode_step
        from tensorlink_tpu_torch.engine.sampling import _filter, sample

        n = len(prompts)
        eng = self.engine(n, max(len(p) for p in prompts), max(budgets))
        logits, cache, _lens, _B = eng.prefill(prompts)
        eff = [max(min(b, eng.max_seq_len - len(p)), 0)
               for p, b in zip(prompts, budgets)]
        sp = SamplingParams.stack([SamplingParams.make(**k) for k in knobs],
                                  pad_to=n).to("cuda")
        cols = [c.reshape(-1) for c in (sp.temperature, sp.top_k, sp.top_p,
                                        sp.presence_penalty,
                                        sp.frequency_penalty)]
        base = prng.PRNGKey(seed, device="cuda")
        seqs, gaps = [[] for _ in range(n)], [[] for _ in range(n)]
        done = np.asarray([e <= 0 for e in eff])
        for step in range(max(eff)):
            key = prng.fold_in(base, torch.tensor(step, device="cuda"))
            lg = logits.float()
            tok = sample(lg, key, sp)
            _g, _i, masked = _filter(lg, *cols, None)
            top = torch.topk(lg, 2, dim=-1).values
            pert = torch.topk(prng.gumbel(key, lg.shape) + masked, 2,
                              dim=-1).values
            gap = torch.where(cols[0] > 0, (pert[:, 0] - pert[:, 1])
                              * cols[0], top[:, 0] - top[:, 1])
            tok_h, gap_h = tok.cpu().numpy(), gap.cpu().numpy()
            for i in range(n):
                if not done[i]:
                    seqs[i].append(int(tok_h[i]))
                    gaps[i].append(float(gap_h[i]))
                done[i] |= int(tok_h[i]) in eos or len(seqs[i]) >= eff[i]
            if done.all():
                break
            logits, cache = _decode_step(eng.params, tok, cache, eng.cfg)
        return seqs, gaps


class _BeamRecord:
    """One beam search's frontiers, as ``engine/generate.py``'s
    ``beam_frontier_step`` and ``_beam_topk`` see them (the engine's
    loop and the split job's both call them): the frontier after the
    prefill and after each step, each step's selection gap (the K-th
    candidate's score over the next one's; for the prefill, the K-th
    log-probability over the next) and the final pool."""

    def __init__(self, K: int):
        self.K = K
        self.frontiers: list = []
        self.gaps: list = []
        self.pool: list = []

    @contextlib.contextmanager
    def recording(self):
        from tensorlink_tpu_torch.engine import generate as eg

        real_step, real_topk = eg.beam_frontier_step, eg._beam_topk
        K = self.K

        def topk(logits, k):
            vals, idx = real_topk(logits, k + 1)
            if not self.gaps:
                self.gaps.append(float(vals[0, K - 1] - vals[0, K]))
            return vals[:, :k], idx[:, :k]

        def step(beams, scores, alive, done_pool, vals, idx, *rest):
            if not self.frontiers:
                self.frontiers.append([list(b) for b in beams])
            cand = sorted((scores[k] + float(vals[k, j])
                           for k in range(K) if alive[k]
                           for j in range(vals.shape[1])), reverse=True)
            self.gaps.append(cand[K - 1] - cand[K] if len(cand) > K
                             else float("inf"))
            out = real_step(beams, scores, alive, done_pool, vals, idx, *rest)
            if out is not None:
                self.frontiers.append([list(b) for b in out[0]])
            self.pool = done_pool  # the caller appends its survivors last
            return out

        eg.beam_frontier_step, eg._beam_topk = step, topk
        try:
            yield self
        finally:
            eg.beam_frontier_step, eg._beam_topk = real_step, real_topk


def _held_beam(label, got, got_rec, want, want_rec, parted: list,
               tie: float = SPEC_TIE, phase: str = "stages") -> None:
    """Beam ``got`` equal to ``want``, or their frontiers first differ at
    a step where the reference's selection gap is within ``tie``, or
    (equal frontiers throughout) the reference's best two finished
    beams' normalized scores lie within it (logged)."""
    if list(got) == list(want):
        return
    at = next((s for s, (f, g) in enumerate(zip(got_rec.frontiers,
                                                want_rec.frontiers))
               if sorted(map(tuple, f)) != sorted(map(tuple, g))), None)
    if at is None:
        best = sorted((s for s, _ in want_rec.pool), reverse=True)
        at, gap = "the final pick", float(best[0] - best[1])
    else:
        gap = want_rec.gaps[at]
    log(f"{phase} {label}: the frontiers part at step {at}, reference "
        f"selection gap {gap:.6g}")
    if not gap <= tie:
        raise AssertionError(f"{phase} {label}: parts at a gap {gap} > "
                             f"{tie}")
    parted.append(dict(stream=label, at=at, gap=gap))


def _held_stream(label, got, want, gaps, parted: list) -> None:
    """``got`` equal to ``want``, or parted first at a token where the
    reference's draw was a near-tie: its gap (``_Reference.generate``)
    within SPEC_TIE (logged)."""
    got, want = list(got), list(want)
    if got == want:
        return
    at = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y),
              None)
    if at is None or at >= len(gaps):
        raise AssertionError(f"stages {label}: {len(got)} tokens against "
                             f"{len(want)}")
    log(f"stages {label}: parts at token {at} of {len(want)}, reference "
        f"top-two gap {gaps[at]:.6g}")
    if gaps[at] > SPEC_TIE:
        raise AssertionError(f"stages {label}: parts at a gap {gaps[at]} > "
                             f"{SPEC_TIE}")
    parted.append(dict(stream=label, at=at, gap=gaps[at]))


def _two_stage_caps(cfg, seq_len: int, *, batch: int = 1,
                    training: bool = False, n_workers: int = 3) -> tuple:
    """Advertised bytes that make the planner split ``cfg`` (``batch``,
    ``seq_len``; a training plan counts gradients and optimizer state)
    over the first two of ``n_workers`` workers, half its layers each
    (a tied head on stage 0), and plan nothing on the others: checked
    with the planner itself, and each stage's recruit estimate (the
    job's total over its share of layers, ``ml/validator.py``) within its
    worker's bytes. The embedding counts against stage 0 alone."""
    from tensorlink_tpu_torch.parallel.planner import (
        MemoryEstimate,
        WorkerCapacity,
        plan_sharding,
    )

    est = MemoryEstimate.build(cfg, batch=batch, seq_len=seq_len,
                               training=training)
    pb = 2 if cfg.dtype == torch.bfloat16 else 4
    emb = cfg.vocab_size * cfg.d_model * pb
    per_layer = (est.total - 2 * emb) / cfg.n_layers
    half = cfg.n_layers // 2
    caps = (emb + (half + 0.5) * per_layer,
            emb + (half + 0.25) * per_layer) + (1e6,) * (n_workers - 2)
    plan = plan_sharding(cfg, [WorkerCapacity(str(i), c)
                               for i, c in enumerate(caps)],
                         batch=batch, seq_len=seq_len, training=training)
    got = [(s.worker_id, s.layer_lo, s.layer_hi, s.holds_head)
           for s in plan.stages]
    tied = bool(cfg.tie_embeddings)
    recruit = [est.total * (s.layer_hi - s.layer_lo) / cfg.n_layers
               for s in plan.stages]
    if got != [("0", 0, half, tied), ("1", half, cfg.n_layers, not tied)] \
            or any(r > c for r, c in zip(recruit, caps)):
        raise AssertionError(f"stages: capacities {caps} plan {got} "
                             f"recruit {recruit}")
    return caps


def _one_card(ml_cls):
    """A worker config factory whose workers advertise their one card
    (``mesh_devices=1``; the default advertises every local card)."""
    return lambda: ml_cls(mesh_devices=1)


def _stages_nodes(root: Path, n_workers: int, ml_fn, endpoint: bool):
    """A port validator, ``n_workers`` workers on the card and a user on
    127.0.0.1."""
    from tensorlink_tpu_torch.core.config import (
        MLConfig,
        UserConfig,
        ValidatorConfig,
        WorkerConfig,
    )
    from tensorlink_tpu_torch.nodes.runners import (
        UserNode,
        ValidatorNode,
        WorkerNode,
    )

    common = dict(local_test=True, log_dir=str(root / "logs"),
                  env_file=str(root / ".env"))
    nodes = []
    try:
        with _clean_spawn():
            v = ValidatorNode(ValidatorConfig(
                endpoint=endpoint, endpoint_port=0, monitor_interval=0.5,
                keeper_interval=5.0, proposal_interval=0.0,
                key_dir=str(root / "vkeys"), ml=MLConfig(),
                **common)).start()
            nodes.append(v)
            seeds = [["127.0.0.1", v.port]]
            for i in range(n_workers):
                nodes.append(WorkerNode(WorkerConfig(
                    seed_validators=seeds, key_dir=str(root / f"w{i}keys"),
                    ml=ml_fn(), **common)).start())
            nodes.append(UserNode(UserConfig(
                seed_validators=seeds, key_dir=str(root / "ukeys"),
                **common)).start())
        deadline = time.monotonic() + 60
        while len(v.status()["peers"]) < n_workers + 1:
            if time.monotonic() > deadline:
                raise AssertionError("stages: the nodes never met")
            time.sleep(0.1)
    except BaseException:
        _stop_nodes(nodes)
        raise
    return nodes[0], nodes[1:-1], nodes[-1]


def _stop_nodes(nodes) -> None:
    """Stop every node at once: a crashed worker's network process takes
    its full join timeout."""
    def one(n):
        try:
            n.stop()
        except Exception as e:  # noqa: BLE001 — a crashed node's teardown
            log(f"stages: stopping a node: {e}")

    threads = [threading.Thread(target=one, args=(n,)) for n in nodes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)


def _pin(workers, caps) -> None:
    for w, c in zip(workers, caps):
        w.send_request("set_capacity", {"hbm_bytes": float(c),
                                        "n_devices": 1})


def _planted(worker, site: str, nth: int, fired: list) -> None:
    """Install a crash at the nth call of ``site`` on a live worker (the
    count starts now); the time it fires goes to ``fired``."""
    from tensorlink_tpu_torch.core.faults import FaultCrash, FaultPlan

    plan = FaultPlan.from_dict({"seed": 7, "rules": [
        {"site": site, "op": "crash", "nth": nth}]})
    real = plan.inject

    def inject(s, key=""):
        try:
            return real(s, key)
        except FaultCrash:
            fired.append(time.monotonic())
            raise

    plan.inject = inject
    worker.executor.faults = plan


class _Hops:
    """The hidden states the stage workers ship to each other (the
    ``chain_send`` requests of their executors' bridges): bytes and
    positions per hop."""

    def __init__(self, workers):
        self.hops: list = []
        for w in workers:
            bridge = w.executor.bridge
            real = bridge.request

            def request(verb, payload=None, timeout=None, real=real):
                if verb == "chain_send":
                    h = payload["body"].get("hidden")
                    if h is not None:
                        self.hops.append((int(h.shape[1]), int(h.nbytes)))
                return real(verb, payload, timeout)

            bridge.request = request

    def per_decode_step(self, n_steps: int) -> float:
        return sum(b for t, b in self.hops if t == 1) / max(n_steps, 1)


def _stages_prompts(cfg) -> list:
    rng = np.random.default_rng(71)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(16, 257)))
            .tolist() for _ in STAGES_BUDGETS]


def _knobs(rows):
    greedy = dict(temperature=0.0, top_k=0, top_p=1.0)
    return [STAGES_SAMPLED if r >= 4 else greedy for r in rows]


def _stream_requests(fn, prompts, budgets, stagger=0.3) -> tuple:
    """Each prompt through ``fn(i, prompt, budget, stream_cb)`` on its own
    thread, started ``stagger`` seconds apart: (results, streams with each
    token's arrival time)."""
    results, errors = {}, []
    streams = {i: [] for i in range(len(prompts))}

    def one(i):
        def cb(toks, i=i):
            now = time.monotonic()
            streams[i].extend((now, int(t)) for t in toks if t is not None)
        try:
            results[i] = fn(i, prompts[i], budgets[i], cb)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
        time.sleep(stagger)
    for t in threads:
        t.join(timeout=600)
    if errors:
        raise errors[0]
    if len(results) != len(prompts):
        raise AssertionError("stages: a request never finished")
    for i, r in results.items():
        if [t for _, t in streams[i]] != list(r):
            raise AssertionError(f"stages: stream {i} differs from its "
                                 "result")
    return results, streams


def stages_serving() -> dict:
    """Steps 1-4 and 6 of phase 13: qwen3-0p6b split over two workers."""
    from tensorlink_tpu_torch.api.formatter import extract_reasoning_and_answer
    from tensorlink_tpu_torch.api.tokenizer import load_tokenizer
    from tensorlink_tpu_torch.core.config import MLConfig
    from tensorlink_tpu_torch.ml.module import DistributedModel

    root = STAGES_ROOT / "serving"
    cfg = config_presets()[NODE_MODEL]
    caps = _two_stage_caps(cfg, STAGES_SEQ)
    ref = _Reference(cfg, STAGES_SEED, STAGES_SEQ)
    v, ws, user = _stages_nodes(root, 3, _one_card(MLConfig),
                                endpoint=True)
    res: dict = {"card": _smi(), "capacities": list(caps)}
    parted: list = []
    nodes = [user, *ws, v]
    try:
        _pin(ws, caps)
        model = DistributedModel(NODE_MODEL, node=user, seed=STAGES_SEED,
                                 seq_len=STAGES_SEQ, batch=1)
        plan = [(s.worker_id, s.layer_lo, s.layer_hi, s.holds_head)
                for s in model.plan.stages]
        if model.plan.n_stages != 2 or plan[0][0] != ws[0].node_id or \
                model.plan.stages[1].holds_head or \
                not model.plan.stages[0].holds_head:
            raise AssertionError(f"stages: plan {plan}")
        res["plan"] = [(lo, hi, head) for _w, lo, hi, head in plan]
        hops = _Hops(ws[:2])

        # step 1: a forward, held per row to the in-process forward's logits
        rng = np.random.default_rng(72)
        toks = rng.integers(0, cfg.vocab_size, STAGES_FWD).astype(np.int32)
        got = model(toks).float()
        with torch.no_grad():
            want, _ = ttr.forward(ref.params, torch.as_tensor(
                toks, device="cuda"), cfg)
        want = want.float()
        rel = ((got - want).abs().amax(dim=(1, 2))
               / want.abs().amax(dim=(1, 2))).max().item()
        res["forward"] = dict(shape=list(got.shape), row_rel_err=rel,
                              bound=BF16_ATTN_TOL, chained=model.chain_forwards)
        if not rel <= BF16_ATTN_TOL or not model.chain_forwards:
            raise AssertionError(f"stages forward: {res['forward']}")

        # step 2: one batched generate, per-row knobs and budgets, against
        # the engine's decode with the same draws; greedy rows also
        # against the engine's own compiled loop
        prompts = _stages_prompts(cfg)
        knobs = _knobs(range(len(prompts)))
        kw = dict(max_new_tokens=max(STAGES_BUDGETS),
                  budgets=list(STAGES_BUDGETS), seed=STAGES_GEN_SEED,
                  **{k: [kn[k] for kn in knobs]
                     for k in ("temperature", "top_k", "top_p")})
        torch.cuda.synchronize()
        t0 = time.monotonic()
        seqs = model.generate(prompts, **kw)
        wall = time.monotonic() - t0
        n_tok = sum(len(s) for s in seqs)
        n_decode = max(STAGES_BUDGETS) - 1
        t0 = time.monotonic()
        want, gaps = ref.generate(prompts, STAGES_BUDGETS, knobs,
                                  seed=STAGES_GEN_SEED)
        torch.cuda.synchronize()
        ref_wall = time.monotonic() - t0
        for r in range(len(prompts)):
            kind = "sampled" if r >= 4 else "greedy"
            _held_stream(f"{kind} row {r}", seqs[r], want[r], gaps[r], parted)
        greedy = list(range(4))
        eng = ref.engine(len(prompts), max(map(len, prompts)),
                         max(STAGES_BUDGETS))
        t0 = time.monotonic()
        comp = eng.generate_compiled(
            [prompts[r] for r in greedy], max_new_tokens=max(STAGES_BUDGETS),
            budgets=[STAGES_BUDGETS[r] for r in greedy])
        torch.cuda.synchronize()
        eng_wall = time.monotonic() - t0
        for k, r in enumerate(greedy):
            _held_stream(f"greedy row {r} vs generate_compiled", seqs[r],
                         comp.sequences[k], gaps[r], parted)
        res["generate"] = dict(
            rows=len(prompts), tokens=n_tok, wall_s=wall,
            pipelined_tokens_per_s=n_tok / wall,
            in_process_tokens_per_s=n_tok / ref_wall,
            generate_compiled_tokens_per_s=sum(
                len(s) for s in comp.sequences) / eng_wall,
            hidden_bytes_per_decode_step=hops.per_decode_step(n_decode),
            hidden_bytes_per_decode_step_want=2 * len(prompts) * cfg.d_model
            * 2)
        if res["generate"]["hidden_bytes_per_decode_step"] != \
                res["generate"]["hidden_bytes_per_decode_step_want"]:
            raise AssertionError(f"stages: hops {res['generate']}")

        # beam search against generate_beam twice: at the split job's
        # prefill height (K rows of the prompt's length) and with the
        # engine's default buckets (one row, a 256-token bucket, a
        # 4096-token cache)
        K, p0, n0 = STAGES_BEAMS, prompts[0], STAGES_BUDGETS[0]
        beams = {}
        for name, eng_ in (
                ("split", None),
                ("same heights", ref.engine(K, len(p0), n0)),
                ("default buckets", GenerationEngine(
                    ref.cfg, ref.params, device="cuda"))):
            rec = _BeamRecord(K)
            with rec.recording():
                if eng_ is None:
                    best = model.generate([p0], max_new_tokens=n0,
                                          num_beams=K)[0]
                else:
                    best = eng_.generate_beam([p0], num_beams=K,
                                              max_new_tokens=n0).sequences[0]
            beams[name] = (best, rec)
        n_parted = len(parted)
        for name in ("same heights", "default buckets"):
            _held_beam(f"beam vs generate_beam at {name}", *beams["split"],
                       *beams[name], parted)
        res["beam"] = dict(num_beams=K, tokens=len(beams["split"][0]),
                           equals={n: beams[n][0] == beams["split"][0]
                                   for n in beams if n != "split"},
                           parted=parted[n_parted:])
        # prompt-lookup speculation: vanilla greedy, held to the engine's
        # greedy decode and to its own lookahead
        rep = (rng.integers(0, cfg.vocab_size, 5).tolist() * 40)[:160]
        look = model.generate([rep], max_new_tokens=32, lookahead=True)
        greedy1 = [knobs[0]]
        vanilla, vgaps = ref.generate([rep], [32], greedy1)
        _held_stream("lookahead vs greedy", look[0], vanilla[0], vgaps[0],
                     parted)
        look_eng = ref.engine(1, len(rep), 32).generate_lookahead(
            [rep], max_new_tokens=32)
        _held_stream("lookahead vs generate_lookahead", look[0],
                     look_eng.sequences[0], vgaps[0], parted)
        res["lookahead"] = dict(tokens=len(look[0]))

        # step 3: continuous batching, 2 slots, requests admitted mid-flight
        b = ContinuousBatcher(model, eos_ids=[], max_slots=2)
        if b.mode != "pipelined":
            raise AssertionError(f"stages: batcher mode {b.mode}")
        cont = list(range(STAGES_CONT))
        out, _streams = _stream_requests(
            lambda i, p, n, cb: b.generate(p, max_new_tokens=n, stream_cb=cb,
                                           timeout=600),
            [prompts[r] for r in cont], [STAGES_BUDGETS[r] for r in cont])
        for i, r in enumerate(cont):
            _held_stream(f"continuous request {i}", out[i], want[r],
                         gaps[r], parted)
        b.close()
        res["continuous"] = dict(requests=len(out), slots=2)

        # step 4: stage 0's worker dies mid-stream; the slot set
        # re-establishes on the third worker
        _pin(ws[2:], (8e9,))
        fired: list = []
        b = ContinuousBatcher(model, eos_ids=[], max_slots=2)
        _planted(ws[0], "worker.session_step", STAGES_CRASH_OP, fired)
        out, streams = _stream_requests(
            lambda i, p, n, cb: b.generate(p, max_new_tokens=n, stream_cb=cb,
                                           timeout=600),
            prompts[:2], list(STAGES_BUDGETS[:2]), stagger=0.0)
        b.close()
        if not fired or model.plan.stages[0].worker_id != ws[2].node_id:
            raise AssertionError(f"stages: crash {fired}, plan "
                                 f"{model.plan.stages[0].worker_id[:8]}")
        for i in range(2):
            _held_stream(f"re-established stream {i}", out[i], want[i],
                         gaps[i], parted)
        after = [t for s in streams.values() for t, _ in s if t > fired[0]]
        res["crash"] = dict(streams=2, crash_to_first_token_s=min(after)
                            - fired[0], new_stage0=ws[2].node_id[:8])
        model.shutdown()
        time.sleep(1.0)  # the workers release the job's reservations

        # step 6: a validator-hosted model planned over two workers, over
        # HTTP
        _pin(ws[1:], caps[:2])
        job = v.executor.host_model(NODE_MODEL, seq_len=STAGES_SEQ,
                                    seed=STAGES_SEED)
        if job.status != "ready" or job.model.plan.n_stages != 2:
            raise AssertionError(f"stages: hosting {job.status} {job.error}")
        recorded: dict = {}
        real_gen = ContinuousBatcher.generate

        def recording(batcher, ids, **kw):
            toks_ = real_gen(batcher, ids, **kw)
            recorded[kw.get("trace_id") or ""] = (
                list(ids), list(toks_), int(kw["max_new_tokens"]))
            return toks_

        ContinuousBatcher.generate = recording
        try:
            msgs = _fleet_messages(STAGES_HTTP, 73)
            http, wall = _http_all(v.api.port, {
                f"stages-http-{i}": {"hf_name": NODE_MODEL, "message": m,
                                     "do_sample": False,
                                     "max_new_tokens": 32}
                for i, m in enumerate(msgs)})
        finally:
            ContinuousBatcher.generate = real_gen
        tok = load_tokenizer({"name": NODE_MODEL})
        eos = set(tok.eos_ids)
        for rid in http:
            ids, got_toks, n = recorded[rid]
            ref_toks, ref_gaps = ref.generate([ids], [n], [knobs[0]],
                                              eos=eos)
            _held_stream(f"http {rid}", got_toks, ref_toks[0], ref_gaps[0],
                         parted)
            text = extract_reasoning_and_answer(
                tok.decode([t for t in got_toks if t not in eos]))[1]
            if http[rid]["response"] != text:
                raise AssertionError(f"stages http {rid}: the response body "
                                     "is not the served tokens' text")
        res["http"] = dict(requests=len(http), wall_s=wall,
                           stages=job.model.plan.n_stages)
        v.executor.unhost_model(NODE_MODEL)
    finally:
        _stop_nodes(nodes)
        nodes = v = ws = user = None
    res["parted"] = parted
    del ref
    torch.cuda.empty_cache()
    return res


def stages_repair() -> dict:
    """Step 5 of phase 13, single-stage repair: a continuous stream whose
    worker crashes mid-stream, and a training job whose worker crashes
    at an optimizer step, each repaired onto a spare."""
    from tensorlink_tpu_torch.core.config import MLConfig
    from tensorlink_tpu_torch.engine.continuous import ContinuousEngine
    from tensorlink_tpu_torch.engine.training import (
        make_optimizer,
        make_train_step,
    )
    from tensorlink_tpu_torch.ml.module import DistributedModel

    root = STAGES_ROOT / "repair"

    def wml():
        return MLConfig(spec_decode=False, max_memory_gb=FLEET_MEM_GB,
                        mesh_devices=1)

    cfg = config_presets()[NODE_MODEL]
    v, ws, user = _stages_nodes(root, 3, wml, endpoint=False)
    res: dict = {"card": _smi()}
    parted: list = []
    nodes = [user, *ws, v]
    try:
        # 5a: a continuous stream, its worker crashed mid-stream
        _pin(ws, (8e9, 4e9, 1e6))
        with _WorkerLaunches() as counts:
            model = DistributedModel(NODE_MODEL, node=user, seed=STAGES_SEED,
                                     seq_len=STAGES_SEQ, batch=1)
            if model.plan.n_stages != 1 or \
                    model.plan.stages[0].worker_id != ws[0].node_id:
                raise AssertionError("stages repair: plan")
            prompts = _stages_prompts(cfg)[:2]
            fired: list = []
            _planted(ws[0], "worker.cont_step", 2, fired)
            base = counts.mark()
            out, streams = _stream_requests(
                lambda i, p, n, cb: model.generate(
                    [p], max_new_tokens=n, continuous=True,
                    stream_cb=cb)[0],
                prompts, [STAGES_REPAIR_NEW] * 2, stagger=0.05)
            launches = counts.since("stages repair", base, 2)
            by_format = {n: {"int8": sum(r["by_format"][n]["int8"]
                                         for r in counts.recs)}
                         for n in NEW_PATHS}
            counts.recs.clear()
        if not fired or model.plan.stages[0].worker_id != ws[1].node_id:
            raise AssertionError("stages repair: the crash or the repair "
                                 "did not happen")
        after = [t for s in streams.values() for t, _ in s if t > fired[0]]
        model.shutdown()
        time.sleep(1.0)  # the workers release the job's reservations
        ml = wml()
        gen = GenerationEngine(
            cfg, _seeded(cfg, "cuda", STAGES_SEED),
            max_seq_len=min(cfg.max_seq_len, ml.max_seq_len),
            seq_buckets=ml.seq_buckets, batch_buckets=ml.batch_buckets,
            device="cuda")
        ce = ContinuousEngine(
            gen, max_slots=ml.cont_max_slots, page_size=ml.cont_page_size,
            chunk_steps=ml.cont_chunk_steps, prefill_chunk=ml.prefill_chunk,
            prefix_cache=ml.prefix_cache, kv_quant=ml.kv_quant,
            spec_decode=False)
        store: list = []
        real_fns = paged._row_keys, paged._sample_rows
        paged._row_keys, paged._sample_rows = _draw_recorder(store)
        try:
            reqs = [ce.submit(p, max_new_tokens=STAGES_REPAIR_NEW,
                              seed=9000 + i) for i, p in enumerate(prompts)]
            ce.run_until_idle()
        finally:
            paged._row_keys, paged._sample_rows = real_fns
        draws = _draws(store)
        for i, r in enumerate(reqs):
            gaps = [draws[(9000 + i, j)][0][0] - draws[(9000 + i, j)][0][1]
                    for j in range(len(r.tokens))]
            _held_stream(f"repaired stream {i}", out[i], r.tokens, gaps, parted)
        ce.close()
        del ce, gen
        res["continuous"] = dict(
            streams=2, crash_to_first_token_s=min(after) - fired[0],
            launches=launches, by_format=by_format)

        # 5b: training, its worker crashed at the 4th optimizer step
        tcfg = _train_cfg(STAGES_TRAIN_LAYERS, torch.float32)
        _pin(ws[1:], (8e9, 1e6))
        B, T = 2, 64
        rng = np.random.default_rng(TRAIN_SEED + 5)
        batches = [rng.integers(0, tcfg.vocab_size, (B, T)).astype(np.int32)
                   for _ in range(STAGES_TRAIN_STEPS)]
        model = DistributedModel(tcfg, node=user, seed=TRAIN_SEED,
                                 training=True, seq_len=T, batch=B,
                                 ckpt_every_steps=2,
                                 ckpt_dir=str(root / "ckpt"))
        if model.plan.stages[0].worker_id != ws[1].node_id:
            raise AssertionError("stages repair: training plan")
        _pin(ws[2:], (8e9,))
        opt = dict(lr=0.1, momentum=0.9)
        model.init_optimizer("sgd", **opt)
        rollback: list = []
        real_recover = model._recover_training

        def timed_recover():
            t0 = time.monotonic()
            real_recover()
            rollback.append(time.monotonic() - t0)

        model._recover_training = timed_recover
        fired = []
        _planted(ws[1], "worker.train_step", 4, fired)
        losses = [model.train_step(b)["loss"] for b in batches]
        step, new_wid = model._step, model.plan.stages[0].worker_id
        model.shutdown()
        if not fired or new_wid != ws[2].node_id or step != 5:
            raise AssertionError(f"stages repair: training crash {fired}, "
                                 f"step {step}")

        def chain(bs):
            ts = make_train_step(tcfg, make_optimizer("sgd", grad_clip=1.0,
                                                      **opt), remat=True)
            p = _seeded(tcfg, "cuda")
            s, out_ = ts.init_state(p), []
            for toks in bs:
                p, s, m = ts.step_fn(p, s, {"tokens": torch.as_tensor(
                    toks, device="cuda")})
                out_.append(float(m["loss"]))
            return out_

        want = chain(batches[:3])
        want += chain(batches[:2] + batches[3:])[2:]
        errs = [_rel(g, w) for g, w in zip(losses, want)]
        res["training"] = dict(losses=losses, in_process=want,
                               max_rel_err=max(errs), bound=TRAIN_NODE_LOSS_RTOL,
                               rollback_s=rollback[0] if rollback else None,
                               steps_kept=step)
        if max(errs) > TRAIN_NODE_LOSS_RTOL or not rollback:
            raise AssertionError(f"stages repair: training {res['training']}")
    finally:
        _stop_nodes(nodes)
        nodes = v = ws = user = None
        shutil.rmtree(root, ignore_errors=True)
    res["parted"] = parted
    torch.cuda.empty_cache()
    return res


def stages_phase() -> dict:
    """Phase 13, pipeline stages and job repair on the card: qwen3-0p6b
    at full width, seeded bf16, split over two workers sharing the card
    (steps 1-4 and 6), then single-stage repair (step 5). Readings, with
    the card's name and power limit, not claims."""
    shutil.rmtree(STAGES_ROOT, ignore_errors=True)
    serving = stages_serving()
    log(f"stages readings ({serving['card']}): pipelined "
        f"{serving['generate']['pipelined_tokens_per_s']:.2f} tokens/s "
        f"against {serving['generate']['in_process_tokens_per_s']:.2f} "
        "single-stage in process (the engine at the split ops' heights, "
        "no wire) and "
        f"{serving['generate']['generate_compiled_tokens_per_s']:.2f} "
        "(generate_compiled); hidden-state bytes per decode step over the "
        f"wire {serving['generate']['hidden_bytes_per_decode_step']:.0f}; "
        "crash to the first token after it "
        f"{serving['crash']['crash_to_first_token_s']:.3f} s")
    repair = stages_repair()
    log(f"stages repair readings ({repair['card']}): crash to the first "
        "token after it "
        f"{repair['continuous']['crash_to_first_token_s']:.3f} s; training "
        f"rollback {repair['training']['rollback_s']:.3f} s")
    res = dict(serving=serving, repair=repair,
               by_format=repair["continuous"]["by_format"])
    shutil.rmtree(STAGES_ROOT, ignore_errors=True)
    log(f"stages (qwen3-0p6b bf16, workers sharing the card; readings, not "
        f"claims): {json.dumps(res)}")
    return res


# -- phase 14 ----------------------------------------------------------
STAGES_TRAIN_ROOT = Path(__file__).resolve().parent / "build" / "stages_train"
# batch rows x tokens of every split step: cut from (4, 128), whose f32
# logits (622 MB a step through the user) made the phase 143 s on the H100
STAGES_TRAIN_BT = (2, 64)
# of qwen3-0p6b's 28 layers: cut from full depth (163.1 s for the phase
# on the H100) so the whole script stays well inside its time limit
STAGES_TRAIN_DEPTH = 8
STAGES_TRAIN_MICRO = 2
STAGES_TRAIN_PARITY = 3  # AdamW steps held against the in-process step
STAGES_TRAIN_SERIAL = 2  # of those, repeated serially from the checkpoint
STAGES_TRAIN_OVERLAP_RTOL = 1e-5  # overlap against serial, relative
STAGES_TRAIN_SGD = dict(lr=0.1, momentum=0.9)
STAGES_TRAIN_CRASH_STEPS = 4  # step 3: the crash comes at the 4th
STAGES_TRAIN_STOP_STEPS = 3  # step 4: the stop comes in the 3rd


class _Wire:
    """The arrays a DistributedModel's train ops ship each way through
    the user node, by kind: logits (the head's output and its cotangent,
    vocab-wide), hidden states between the stages, and the gradients of
    the stages' inputs; and the most train requests open at once (two
    means two micro-batches in flight)."""

    def __init__(self, model):
        self.bytes = dict(logits=0, hidden=0, grad=0)
        self.now = self.most = 0
        self._lock = threading.Lock()
        vocab = model.cfg.vocab_size
        real = model._request

        def request(wid, tag, body, *a, **kw):
            if "tag" not in body:
                return real(wid, tag, body, *a, **kw)
            with self._lock:
                self.now += 1
                self.most = max(self.most, self.now)
            try:
                resp = real(wid, tag, body, *a, **kw)
            finally:
                with self._lock:
                    self.now -= 1
            fwd = tag == "fwd"
            for arr in (body.get("hidden" if fwd else "grad"),
                        resp.get("out" if fwd else "grad")):
                if arr is None:
                    continue
                arr = np.asarray(arr)
                kind = "logits" if arr.shape[-1] == vocab else \
                    "hidden" if fwd else "grad"
                with self._lock:
                    self.bytes[kind] += int(arr.nbytes)
            return resp

        model._request = request


def _stage_trees(ws, model) -> list:
    """Each stage's tree in its worker's memory (the executors run in
    this process), in plan order."""
    by_id = {w.node_id: w for w in ws}
    return [by_id[s.worker_id].executor.jobs[model.job_id].params
            for s in model.plan.stages]


def _merged_tree(trees: list) -> dict:
    """The stages' trees as one model tree: the embedding and final norm
    from stage 0 (the tied head's holder), the layers concatenated."""
    full = {k: v for k, v in trees[0].items() if k != "layers"}

    def cat(*xs):
        if isinstance(xs[0], dict):
            return {k: cat(*(x[k] for x in xs)) for k in xs[0]}
        return torch.cat(xs, dim=0)

    full["layers"] = cat(*(t["layers"] for t in trees))
    return full


def _elementwise(got: dict, want: dict) -> tuple:
    """(entries outside TRAIN_NODE_PARAMS, the worst entry's share of its
    bound), over every leaf."""
    worst, bad = 0.0, 0
    g = _named(got)
    for k, w in _named(want).items():
        d = (g[k] - w).abs()
        lim = TRAIN_NODE_PARAMS["atol"] + TRAIN_NODE_PARAMS["rtol"] * w.abs()
        bad += int((d > lim).sum())
        worst = max(worst, float((d / lim).max()))
    return bad, worst


def _chain(cfg, opt_name: str, opt_kw: dict, batches) -> tuple:
    """make_train_step over the seeded tree, ``batches`` in order, with
    the split job's micro count: (losses, final params, step seconds)."""
    from tensorlink_tpu_torch.engine.training import (
        make_optimizer,
        make_train_step,
    )

    ts = make_train_step(cfg, make_optimizer(opt_name, grad_clip=1.0,
                                             **opt_kw),
                         n_micro=STAGES_TRAIN_MICRO, remat=True)
    p = _seeded(cfg, "cuda")
    s, losses, secs = ts.init_state(p), [], []
    for toks in batches:
        p, s, loss, _, dt = _timed_step(ts, p, s, {
            "tokens": torch.as_tensor(toks, device="cuda")})
        losses.append(loss)
        secs.append(dt)
    return losses, p, secs


def _held_losses(label: str, got, want, rtol: float) -> float:
    errs = [_rel(g, w) for g, w in zip(got, want)]
    if len(got) != len(want) or max(errs) > rtol:
        raise AssertionError(f"stages training {label}: losses {got} "
                             f"against {want} (rtol {rtol})")
    return max(errs)


def _train_job(user, ws, cfg, planned, **kw):
    """A two-stage training job of the seeded tree on ``planned`` (the
    first two workers the capacities name): checks the plan."""
    from tensorlink_tpu_torch.ml.module import DistributedModel

    B, T = STAGES_TRAIN_BT
    model = DistributedModel(cfg, node=user, seed=TRAIN_SEED, training=True,
                             seq_len=T, batch=B, n_micro=STAGES_TRAIN_MICRO,
                             **kw)
    stages = model.plan.stages
    if model.plan.n_stages != 2 or stages[1].holds_head or \
            not stages[0].holds_head or model.plan.n_micro != 2 or \
            [s.worker_id for s in stages] != [w.node_id for w in planned] or \
            [(s.layer_lo, s.layer_hi) for s in stages] != \
            [(0, cfg.n_layers // 2), (cfg.n_layers // 2, cfg.n_layers)]:
        raise AssertionError(f"stages training: plan {model.plan.to_json()}")
    return model


def _timed_recover(model) -> list:
    """Wrap the job's recovery to keep its seconds."""
    took, real = [], model._recover_training

    def recover():
        t0 = time.monotonic()
        real()
        took.append(time.monotonic() - t0)

    model._recover_training = recover
    return took


def stages_training() -> dict:
    """Steps 1-4 of phase 14: qwen3-0p6b at full width and
    STAGES_TRAIN_DEPTH layers, seeded f32, trained split in two halves
    over two workers on the card, against make_train_step in process;
    then the two crashes of a split step."""
    from tensorlink_tpu_torch.core.config import MLConfig

    cfg = _train_cfg(STAGES_TRAIN_DEPTH, torch.float32)
    B, T = STAGES_TRAIN_BT
    caps = _two_stage_caps(cfg, T, batch=B, training=True, n_workers=4)
    rng = np.random.default_rng(TRAIN_SEED + 7)
    batches = [rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
               for _ in range(max(STAGES_TRAIN_PARITY,
                                  STAGES_TRAIN_CRASH_STEPS))]
    root = STAGES_TRAIN_ROOT
    t_sec = time.monotonic()
    v, ws, user = _stages_nodes(root, 4, _one_card(MLConfig),
                                endpoint=False)
    res: dict = {"card": _smi(), "layers": cfg.n_layers, "batch": B,
                 "tokens": T, "n_micro": STAGES_TRAIN_MICRO}
    secs = res["seconds"] = {"nodes": time.monotonic() - t_sec}
    nodes = [user, *ws, v]
    att.reset_counts()
    try:
        # 1: parity, AdamW, micro-batches overlapped
        t_sec = time.monotonic()
        _pin(ws, caps)
        model = _train_job(user, ws, cfg, ws[:2])
        model.init_optimizer("adamw", lr=1e-3)
        model.save_checkpoint(str(root / "start"))
        wire = _Wire(model)
        over, over_s = [], []
        for toks in batches[:STAGES_TRAIN_PARITY]:
            t0 = time.perf_counter()
            over.append(model.train_step(toks)["loss"])
            over_s.append(time.perf_counter() - t0)
        ref_losses, ref, local_s = _chain(cfg, "adamw", dict(lr=1e-3),
                                          batches[:STAGES_TRAIN_PARITY])
        flight = wire.most
        shipped = {k: b / STAGES_TRAIN_PARITY for k, b in wire.bytes.items()}
        errs = _leaf_errs(_merged_tree(_stage_trees(ws, model)), ref)
        res["parity"] = dict(
            optimizer="adamw", losses=over, in_process=ref_losses,
            max_rel_err=_held_losses("parity", over, ref_losses,
                                     TRAIN_NODE_LOSS_RTOL),
            param_leaf_rel_max=max(errs.values()),
            embed_tok_rel=errs["embed/tok"], in_flight_most=flight,
            split_step_s=over_s, in_process_step_s=local_s,
            bytes_per_step=shipped)
        del ref
        if max(errs.values()) > TRAIN_NODE_PARAMS["rtol"] or flight < 2:
            raise AssertionError(f"stages training parity: {res['parity']}")

        # 2: the same steps serially from the checkpoint
        secs["parity"] = time.monotonic() - t_sec
        t_sec = time.monotonic()
        model.restore_checkpoint(str(root / "start"))
        wire.most = 0
        serial, serial_s = [], []
        for toks in batches[:STAGES_TRAIN_SERIAL]:
            t0 = time.perf_counter()
            serial.append(model.train_step(toks, overlap=False)["loss"])
            serial_s.append(time.perf_counter() - t0)
        res["serial"] = dict(
            losses=serial, overlapped=over[:STAGES_TRAIN_SERIAL],
            max_rel_err=_held_losses("overlap against serial", serial,
                                     over[:STAGES_TRAIN_SERIAL],
                                     STAGES_TRAIN_OVERLAP_RTOL),
            in_flight_most=wire.most, serial_step_s=serial_s,
            overlapped_step_s=over_s[:STAGES_TRAIN_SERIAL])
        if wire.most != 1:
            raise AssertionError(f"stages training serial: {res['serial']}")
        model.shutdown()
        time.sleep(1.0)  # the workers release the job's reservations
        torch.cuda.empty_cache()

        # 3: the stage-1 worker crashes inside the optimizer, after stage
        # 0 applied the update (SGD with momentum: params elementwise)
        secs["serial"] = time.monotonic() - t_sec
        t_sec = time.monotonic()
        _pin(ws, caps)
        model = _train_job(user, ws, cfg, ws[:2], ckpt_every_steps=2,
                           ckpt_dir=str(root / "ckpt3"))
        _pin(ws[2:3], (8e10,))
        model.init_optimizer("sgd", **STAGES_TRAIN_SGD)
        took = _timed_recover(model)
        fired: list = []
        _planted(ws[1], "worker.train_step", 4, fired)
        crash_s, losses = [], []
        for toks in batches[:STAGES_TRAIN_CRASH_STEPS]:
            t0 = time.perf_counter()
            losses.append(model.train_step(toks)["loss"])
            crash_s.append(time.perf_counter() - t0)
        applied0 = ws[0].executor.jobs[model.job_id].opt_steps
        step = model._step
        if not fired or model.plan.stages[1].worker_id != ws[2].node_id or \
                step != STAGES_TRAIN_CRASH_STEPS - 1 or \
                applied0 != STAGES_TRAIN_CRASH_STEPS + 1 or not took:
            raise AssertionError(f"stages training crash: fired {fired}, "
                                 f"step {step}, stage 0 applied {applied0}")
        trees = _stage_trees(ws, model)
        want = _chain(cfg, "sgd", STAGES_TRAIN_SGD, batches[:3])[0]
        after, p, _ = _chain(cfg, "sgd", STAGES_TRAIN_SGD,
                             batches[:2] + batches[3:STAGES_TRAIN_CRASH_STEPS])
        want += after[2:]
        bad, worst = _elementwise(_merged_tree(trees), p)
        res["crash_in_optimizer"] = dict(
            optimizer="sgd momentum", losses=losses, in_process=want,
            max_rel_err=_held_losses("crash in the optimizer", losses, want,
                                     TRAIN_NODE_LOSS_RTOL),
            stage0_updates_applied=applied0, steps_kept=step,
            rollback_s=took[0], step_s=crash_s,
            params_outside_bound=bad, params_worst_of_bound=worst)
        del trees, p
        if bad:
            raise AssertionError(f"stages training crash: params outside "
                                 f"{TRAIN_NODE_PARAMS}: "
                                 f"{res['crash_in_optimizer']}")
        model.shutdown()
        time.sleep(1.0)
        torch.cuda.empty_cache()

        # 4: the stage-0 worker stops between a micro-batch's FORWARD and
        # its BACKWARD (workers 0 and 2 planned, worker 3 the spare)
        secs["crash_in_optimizer"] = time.monotonic() - t_sec
        t_sec = time.monotonic()
        live = [ws[0], ws[2]]
        _pin(live + [ws[3]], caps[:2] + (1e6,))
        model = _train_job(user, ws, cfg, live, ckpt_every_steps=2,
                           ckpt_dir=str(root / "ckpt4"))
        _pin(ws[3:], (8e10,))
        model.init_optimizer("sgd", **STAGES_TRAIN_SGD)
        took = _timed_recover(model)
        real_bwd, stopped = model._train_backward, []

        def backward(dlogits, tag):
            if tag == "s3m0" and not stopped:
                ws[0].stop()
                stopped.append(time.monotonic())
            return real_bwd(dlogits, tag)

        model._train_backward = backward
        losses = [model.train_step(toks)["loss"]
                  for toks in batches[:STAGES_TRAIN_STOP_STEPS]]
        step = model._step
        if not stopped or model.plan.stages[0].worker_id != ws[3].node_id \
                or step != STAGES_TRAIN_STOP_STEPS or not took:
            raise AssertionError(f"stages training stop: step {step}, "
                                 f"plan {model.plan.to_json()}")
        want = _chain(cfg, "sgd", STAGES_TRAIN_SGD,
                      batches[:STAGES_TRAIN_STOP_STEPS])[0]
        res["stop_before_backward"] = dict(
            losses=losses, in_process=want,
            max_rel_err=_held_losses("stop before the backward", losses,
                                     want, TRAIN_NODE_LOSS_RTOL),
            rollback_s=took[0], steps_kept=step)
        model.shutdown()
        secs["stop_before_backward"] = time.monotonic() - t_sec
        launches = {n: getattr(att, n).launches for n in REPLACES}
        launches["flash_attention"] = att.flash_attention.launches
        res["launches"] = launches
        if any(launches.values()):
            raise AssertionError(f"stages training: kernels launched "
                                 f"{launches}; the training path has none")
    finally:
        t_sec = time.monotonic()
        _stop_nodes(nodes)
        nodes = v = ws = user = model = None
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
        res.setdefault("seconds", {})["stop_nodes"] = time.monotonic() - t_sec
    return res


def stages_training_phase() -> dict:
    """Phase 14, pipelined training and its repair on the card. Readings,
    with the card's name and power limit, not claims (the serving loop's
    busy share is read in phase 15)."""
    t0 = time.monotonic()
    shutil.rmtree(STAGES_TRAIN_ROOT, ignore_errors=True)
    tr = stages_training()
    p = tr["parity"]
    log(f"stages training readings ({tr['card']}): split step "
        f"{statistics.median(p['split_step_s']):.3f} s (overlapped) and "
        f"{statistics.median(tr['serial']['serial_step_s']):.3f} s (serial) "
        f"against {statistics.median(p['in_process_step_s']):.3f} s in "
        "process; bytes shipped through the user per step: logits "
        f"{p['bytes_per_step']['logits']:.0f}, hidden "
        f"{p['bytes_per_step']['hidden']:.0f}, gradient "
        f"{p['bytes_per_step']['grad']:.0f}; rollback "
        f"{tr['crash_in_optimizer']['rollback_s']:.3f} s (crash in the "
        f"optimizer), {tr['stop_before_backward']['rollback_s']:.3f} s "
        "(stop before the backward)")
    res = dict(training=tr, seconds=time.monotonic() - t0)
    shutil.rmtree(STAGES_TRAIN_ROOT, ignore_errors=True)
    half = tr["layers"] // 2
    log(f"stages training (qwen3-0p6b f32, {tr['layers']} layers split "
        f"{half}/{half}, workers sharing the card; readings, not claims; "
        f"{tr['card']}): {json.dumps(res)}")
    log(f"phase 14 took {res['seconds']:.1f} s ({tr['card']})")
    return res


# -- phase 15 ----------------------------------------------------------
TP_DEGREE = 2
TP_DEVICES = ("cuda:0", "cuda:0")  # both shards on the one card
TP_NEW = 16  # new tokens per request
TP_PROFILE_CHUNKS = 2  # traced chunks per engine for the busy share
TP_ROOT = Path(__file__).resolve().parent / "build" / "tp"
# one shard's KV bytes per token: half of KV_BYTES_PER_TOKEN's (at 28
# layers, as that table)
KV_BYTES_PER_TOKEN_SHARD = {"fp": 57_344, "int8": 29_568}


def _at_depth(table: dict, fmt: str, n_layers: int) -> int:
    """A KV-bytes-per-token table's entry (read at 28 layers) for an
    engine of ``n_layers`` layers."""
    return table[fmt] * n_layers // 28


def _tp_prompts(cfg) -> list:
    """8 requests of 64 to 1024 tokens: 2 repetitive ones that speculate,
    3 greedy and 3 sampled."""
    rng = np.random.default_rng(1515)
    V = cfg.vocab_size
    out = []
    for i in range(8):
        n = int(rng.integers(64, 1025))
        if i < 2:
            unit = rng.integers(0, V, (5, 3)[i]).tolist()
            out.append(((unit * (n // len(unit) + 1))[:n], {}, True))
            continue
        knobs = {} if i % 2 == 0 else dict(temperature=0.8, top_k=50,
                                           top_p=0.95)
        out.append((rng.integers(0, V, n).tolist(), knobs, False))
    return out


def _tp_engine(tp: int, devices=TP_DEVICES, gen=None, **kw):
    """A phase-15 engine (over ``gen``, default phase 8's tree);
    ``devices=None`` lays the shards on the distinct local cards."""
    kw = dict(spec_decode=True, spec_draft=8) | kw
    if tp > 1:
        kw.update(tensor_parallel=tp,
                  tp_devices=None if devices is None else list(devices))
    return _cont(gen or _gen(), **kw)


def _tp_serve(tp: int, kv_quant: str, prompts, devices=TP_DEVICES,
              gen=None) -> tuple:
    """The 8 requests on one engine, every draw's top two recorded; the
    kernels' launches checked per chunk (``_Launches``: tp launches of
    each a layer)."""
    ce = _tp_engine(tp, devices, gen, kv_quant=kv_quant)
    return ce, _drawn_serve(ce, f"tp serving {kv_quant} tp={tp}", prompts,
                            TP_NEW)


def _drawn_serve(ce, label: str, prompts, n_new: int) -> dict:
    """``prompts`` (``(ids, knobs, speculative)``) x ``n_new`` tokens on
    ``ce``, every draw's top two recorded; the kernels' launches checked
    per chunk (``_Launches``: a launch of each a layer and shard of the
    pages)."""
    lc = _Launches(label)
    lc.add(ce)
    store: list = []
    real_fns = paged._row_keys, paged._sample_rows
    paged._row_keys, paged._sample_rows = _draw_recorder(store)
    try:
        reqs = [ce.submit(ids, max_new_tokens=n_new, seed=300 + i,
                          sampling=SamplingParams.make(**knobs),
                          speculative=spec)
                for i, (ids, knobs, spec) in enumerate(prompts)]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        ce.run_until_idle()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        paged._row_keys, paged._sample_rows = real_fns
    if not all(r.finished and len(r.tokens) == n_new for r in reqs):
        raise AssertionError(f"{label}: a request did not finish")
    launches = lc.check()
    ce.check_page_conservation()
    chunks = launches["chunks"]
    return dict(
        streams=[list(r.tokens) for r in reqs], draws=_draws(store),
        wall_s=wall, tokens_per_s=n_new * len(reqs) / wall, chunks=chunks,
        ms_per_chunk=wall * 1e3 / chunks, launches=launches,
        per_chunk={n: c / chunks for n, c in launches["launches"].items()},
        snap=ce.serving_snapshot(),
    )


def _held_greedy(label, prompts, got, want, tie=SPEC_TIE) -> list:
    """Greedy streams of ``got`` equal ``want``'s, or parted only where
    ``want``'s top-two gap at the parting draw is within ``tie``
    (logged). Returns the partings."""
    parted = []
    for i, ((_ids, knobs, _s), a, b) in enumerate(zip(
            prompts, got["streams"], want["streams"])):
        if knobs:
            continue
        at = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                  len(b))
        if at == len(b):
            continue
        (vg, ig), (vw, iw) = (got["draws"][(300 + i, at)],
                              want["draws"][(300 + i, at)])
        if not (_top_is(vw, iw, b[at]) and _top_is(vg, ig, a[at])):
            raise AssertionError(f"{label}: draw {at} of request {i} not "
                                 "recorded")
        gap = vw[0] - vw[1]
        log(f"{label} request {i}: parts at token {at} of {len(b)}, the "
            f"reference's top-two gap {gap:.6g}")
        if gap > tie:
            raise AssertionError(f"{label}: request {i} parts at token {at} "
                                 f"at a top-two gap {gap} > {tie}")
        parted.append(dict(request=i, at=at, gap=gap))
    return parted


def _dequantized(fields, page: int, head_dim: int) -> list:
    """One page's K and V over every layer as float32 ``[L, n_kv, page,
    hd]`` (quantized codes times their scales), for a whole cache's
    fields or a tp cache's (shards joined by kv head)."""
    def rows(t):
        if isinstance(t, tmesh.Sharded):  # on its first shard's card
            dev = t.shards[0].device
            return torch.cat([x[:, page].to(dev) for x in t.shards], dim=1)
        return t[:, page]

    k, v = rows(fields[0]), rows(fields[1])
    if len(fields) == 2:
        return [k.float(), v.float()]
    return [_codes(c, c.shape[-1] != head_dim).float() * rows(s)[..., None]
            for c, s in ((k, fields[2]), (v, fields[3]))]


def _tp_trie_pages(one, tp) -> dict:
    """Every trie page both engines hold for the same token chain (the
    same tokens at the same positions): the tp engine's shards joined by
    kv head against the tp=1 engine's page, per layer, as the worst max
    |diff| over BF16_ATTN_TOL times the layer's max |tp=1| (<= 1 passes),
    dequantized for int8 pages."""
    by_hash = {n.key_hash: n for n in tp.prefix._by_page.values()}
    worst, n_pages, n_equal, max_abs = 0.0, 0, 0, 0.0
    for node in one.prefix._by_page.values():
        other = by_hash.get(node.key_hash)
        if other is None or other.depth != node.depth:
            continue
        hd = one.cfg.head_dim
        a = _dequantized(one.cache.fields(), node.page, hd)
        b = _dequantized(tp.cache.fields(), other.page, hd)
        same = True
        for x, y in zip(b, a):
            d = (x - y).abs().flatten(1).amax(1)  # per layer
            ref = y.abs().flatten(1).amax(1).clamp_min(1e-30)
            worst = max(worst, float((d / (BF16_ATTN_TOL * ref)).max()))
            max_abs = max(max_abs, float(d.max()))
            same = same and bool((d == 0).all())
        n_pages += 1
        n_equal += same
    if n_pages == 0:
        raise AssertionError("tp: the two engines share no trie chain")
    return dict(pages=n_pages, pages_bitwise=n_equal, max_abs_diff=max_abs,
                of_bound=worst)


def _tp_layout(ce, fmt) -> dict:
    """The tp engine's cache: every page field split in two contiguous
    shards of n_kv / 2 kv heads on the card, the control tensors whole,
    and one shard's KV bytes per token half the whole's."""
    c = ce.cache
    cfg = ce.cfg
    per_token = 0
    for f in c.fields():
        if not isinstance(f, tmesh.Sharded) or len(f.shards) != TP_DEGREE:
            raise AssertionError(f"tp: a page field is not split in "
                                 f"{TP_DEGREE}: {f!r}")
        for s in f.shards:
            if s.shape[2] != cfg.n_kv_heads // TP_DEGREE \
                    or not s.is_contiguous() or s.device.type != "cuda":
                raise AssertionError(f"tp: shard {tuple(s.shape)} on "
                                     f"{s.device}")
        per_token += f.shards[0].numel() * f.shards[0].element_size()
    per_token //= c.n_pages * c.page_size
    want = _at_depth(KV_BYTES_PER_TOKEN_SHARD, fmt, cfg.n_layers)
    if per_token != want:
        raise AssertionError(f"tp: {per_token} KV bytes per token a shard, "
                             f"not {want}")
    if isinstance(c.block_tables, tmesh.Sharded) \
            or isinstance(c.lengths, tmesh.Sharded):
        raise AssertionError("tp: control state was sharded")
    snap = ce.serving_snapshot()
    if snap["tensor_parallel"] != TP_DEGREE:
        raise AssertionError(f"tp: snapshot says tensor_parallel "
                             f"{snap['tensor_parallel']}")
    whole = snap["kv_page_bytes"] // c.page_size
    want = _at_depth(KV_BYTES_PER_TOKEN, fmt, cfg.n_layers)
    if whole != want:
        raise AssertionError(f"tp: {whole} KV bytes per token, not {want}")
    return dict(kv_bytes_per_token_shard=per_token,
                kv_bytes_per_token=whole)


def _tp_export_layout(one, tp, prompt) -> dict:
    """One request frozen once it decodes on each engine and exported:
    the tp export's arrays have the tp=1 export's shapes and dtypes; then
    both thaw and finish."""
    blobs = []
    for ce in (one, tp):
        # room to be frozen mid-decode after a chunk
        r = ce.submit(prompt, max_new_tokens=32, seed=7)
        for _ in range(8):
            ce.step_chunk()
            if r.slot >= 0 and r.slot not in ce._prefilling \
                    and ce._active[r.slot]:
                break
        ce.freeze_slot(r.slot)
        blobs.append(ce.export_slot(r.slot))
        ce.abort_migration(r.slot)
        ce.run_until_idle()
        if not r.finished:
            raise AssertionError("tp: a thawed request did not finish")
    a, b = blobs
    keys = [k for k in ("k", "v", "k_scale", "v_scale") if k in a]
    layout = {k: (tuple(np.asarray(a[k]).shape), str(np.asarray(a[k]).dtype))
              for k in keys}
    got = {k: (tuple(np.asarray(b[k]).shape), str(np.asarray(b[k]).dtype))
           for k in keys if k in b}
    if got != layout or a["dtype"] != b["dtype"]:
        raise AssertionError(f"tp: export layout {got} vs tp=1 {layout}")
    return {k: list(v) for k, v in layout.items()}


def _traced_busy(ce, prompts, root: Path) -> dict:
    """Two chunks warm, then TP_PROFILE_CHUNKS chunks inside the port's
    ``profiling.trace``: the card's busy share of the window (its kernels'
    device time over the window's wall time; one stream)."""
    from tensorlink_tpu_torch.utils import profiling

    for i, (ids, _knobs, _spec) in enumerate(prompts):
        ce.submit(ids, max_new_tokens=32, seed=i)  # live in the window
    for _ in range(2):
        ce.step_chunk()
    torch.cuda.synchronize()
    with profiling.trace(root) as prof:
        t0 = time.perf_counter()
        for _ in range(TP_PROFILE_CHUNKS):
            ce.step_chunk()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, launches = 0.0, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            busy += t / 1e3
            launches += e.count
    ce.run_until_idle()
    shutil.rmtree(root, ignore_errors=True)
    if busy <= 0:
        raise AssertionError("tp: the trace holds no device kernel")
    return dict(chunks=TP_PROFILE_CHUNKS, wall_ms=wall * 1e3,
                device_busy_ms=busy, busy_share=busy / (wall * 1e3),
                device_launches=launches)


def _shard_checker(real, plain, whole_call, n_shards, readings: dict):
    """``real`` (a kernel wrapper launched per shard) wrapped so that each
    shard's output is held against ``plain`` on its own inputs (the
    bf16 bound) and, once every shard of a layer has launched, each
    shard's output is compared bitwise with the same heads of one launch
    over all the shards' heads joined (``whole_call``)."""
    pending: list = []

    def held(q, kp, vp, *rest, **kw):
        out = real(q, kp, vp, *rest, **kw)
        readings["plain"] = max(readings.get("plain", 0.0), _attn_ratio(
            out, plain(q, kp, vp, *rest, **kw), BF16_ATTN_TOL))
        pending.append((q, kp, vp, rest, kw, out))
        if len(pending) == n_shards:
            qs, kps, vps = zip(*[(p[0], p[1], p[2]) for p in pending])
            kw0 = dict(pending[0][4])
            for name in ("k_scale", "v_scale"):
                if kw0.get(name) is not None:
                    kw0[name] = torch.cat([p[4][name] for p in pending], 1)
            whole = whole_call(torch.cat(qs, -2).contiguous(),
                               torch.cat(kps, 1).contiguous(),
                               torch.cat(vps, 1).contiguous(),
                               *pending[0][3], **kw0)
            got = torch.cat([p[5] for p in pending], -2)
            readings["layers"] = readings.get("layers", 0) + 1
            if not torch.equal(got, whole):
                readings["unequal"] = readings.get("unequal", 0) + 1
                readings["max_diff"] = max(
                    readings.get("max_diff", 0.0),
                    float((got.float() - whole.float()).abs().max()))
            pending.clear()
        return out

    return held


def tp_kernel_check(fmt: str) -> dict:
    """One ragged chunk over MAIN's block (2 prefills, 5 decodes, an idle
    slot) and one decode step of its slots after it, through the tp=2
    step's forward on qwen3-0p6b bf16 at full width and MODEL_LAYERS
    layers, pages of
    seeded random context in ``fmt``: every shard's launch of each kernel
    (n_kv / 2 = 4 kv heads, 8 query heads) bitwise equal to the same
    heads of one launch over both shards' heads joined on the same
    inputs, and within the bf16 bound of its plain version. Over fp
    pages also the tp=1 forward on the same pages: each layer's output,
    tp=2 against tp=1, as the largest max |diff| over the layers (a
    reading: a GEMM's bits may depend on its width)."""
    cfg, params = _model()
    dev = torch.device("cuda")
    S, C, page = MAIN["S"], MAIN["C"], MAIN["page"]
    kvq = {"fp": "none"}.get(fmt, fmt)
    whole = PagedKVCache.init(cfg, S, page_size=page,
                              max_len=MAIN["n_pp"] * page, kv_quant=kvq,
                              device=dev)
    n_pp = whole.pages_per_slot
    rng = np.random.default_rng(15)
    perm = rng.permutation(np.arange(1, whole.n_pages))[: S * n_pp]
    whole.block_tables.copy_(torch.from_numpy(
        perm.reshape(S, n_pp).astype(np.int32)))
    gk = torch.Generator(device=dev)
    gk.manual_seed(151)
    if fmt == "fp":
        whole.k.normal_(generator=gk)
        whole.v.normal_(generator=gk)
    else:
        _fill_quantized(whole, fmt == "int4", gk)
    mesh = tmesh.serving_mesh(TP_DEGREE, devices=list(TP_DEVICES))
    split = tmesh.Split(2)
    tpc = PagedKVCache(
        k=tmesh.put(mesh, whole.k, split), v=tmesh.put(mesh, whole.v, split),
        block_tables=whole.block_tables.clone(),
        lengths=whole.lengths.clone(),
        k_scale=None if kvq == "none" else tmesh.put(mesh, whole.k_scale,
                                                     split),
        v_scale=None if kvq == "none" else tmesh.put(mesh, whole.v_scale,
                                                     split),
    )
    placed = tmesh.put(mesh, params, ttr.tp_partition_specs(cfg))
    fwd = paged._TP(placed, cfg, ttr.TPLayout(mesh.flat()), True)
    blk = torch.tensor(rng.integers(0, cfg.vocab_size, size=(S, C)),
                       dtype=torch.int32, device=dev)
    starts, nv = (torch.tensor(a, dtype=torch.int32, device=dev)
                  for a in (MAIN_STARTS, MAIN_NVALID))
    wp, wo, pos, _ = paged._ragged_write_indices(tpc.block_tables, starts,
                                                 nv, page, n_pp, C)
    ragged_r, decode_r = {}, {}
    hidden: dict = {"tp1": [], "tp2": []}
    real_r, real_d = paged.ragged_paged_attention, paged.paged_attention
    real_res, real_tpres = paged._residual, paged._tp_residual

    def rec_res(x, *a):
        out = real_res(x, *a)
        hidden["tp1"].append(out)
        return out

    def rec_tpres(x, *a):
        out = real_tpres(x, *a)
        hidden["tp2"].append(out[mesh.flat()[0]])
        return out

    paged.ragged_paged_attention = _shard_checker(
        real_r, att.ragged_paged_attention_ref, att.ragged_paged_attention,
        TP_DEGREE, ragged_r)
    paged.paged_attention = _shard_checker(
        real_d, att.paged_attention_ref, att.paged_attention, TP_DEGREE,
        decode_r)
    paged._tp_residual = rec_tpres
    try:
        x_tp = fwd.ragged(blk, tpc, starts, nv, wp, wo, pos)
        lens = [st + n for st, n in zip(MAIN_STARTS, MAIN_NVALID)]
        tpc.lengths.copy_(torch.tensor(lens, dtype=torch.int32))
        tok = torch.tensor(rng.integers(0, cfg.vocab_size, size=S),
                           dtype=torch.int32, device=dev)
        logits, _ = fwd.decode(tok, tpc, tpc.lengths > 0)
    finally:
        paged.ragged_paged_attention = real_r
        paged.paged_attention = real_d
        paged._tp_residual = real_tpres
    torch.cuda.synchronize()
    L = cfg.n_layers
    for name, r in (("ragged", ragged_r), ("decode", decode_r)):
        if r.get("layers") != L:
            raise AssertionError(f"tp kernels {fmt}: {r.get('layers')} "
                                 f"{name} layers held, not {L}")
        if r.get("unequal"):
            raise AssertionError(f"tp kernels {fmt}: {r['unequal']} {name} "
                                 f"layers' shard outputs differ from the "
                                 f"joined launch's heads by up to "
                                 f"{r['max_diff']}")
        if r["plain"] > 1.0:
            raise AssertionError(f"tp kernels {fmt}: a shard's {name} "
                                 f"output is {r['plain']}x the bf16 bound "
                                 "off its plain version")
    if not torch.isfinite(logits).all() or not torch.isfinite(x_tp[
            mesh.flat()[0]]).all():
        raise AssertionError(f"tp kernels {fmt}: not finite")
    res = dict(ragged_of_bound=ragged_r["plain"],
               decode_of_bound=decode_r["plain"], layers=L,
               ragged_shard_bitwise=True, decode_shard_bitwise=True)
    if fmt == "fp":
        paged._residual = rec_res
        try:
            paged._Whole(params, cfg, True).ragged(blk, whole, starts, nv,
                                                   wp, wo, pos)
        finally:
            paged._residual = real_res
        per_layer = [float((a.float() - b.float()).abs().max())
                     for a, b in zip(hidden["tp1"], hidden["tp2"])]
        if len(per_layer) != L:
            raise AssertionError(f"tp kernels: {len(per_layer)} layers "
                                 "compared")
        res["hidden_max_abs_diff_by_layer"] = per_layer
        res["hidden_layers_bitwise"] = sum(d == 0.0 for d in per_layer)
    del whole, tpc, placed, fwd
    torch.cuda.empty_cache()
    return res


def tp_cards() -> dict:
    """Not a phase of ``main()``: it needs four cards on one host.
    Phase 15's fp serving at tensor_parallel 2 and 4 with the
    devices left out — the shards on distinct cards, so every gather
    copies between cards (``parallel/mesh.py::to_device``) — against the
    tp=1 engine on card 0: greedy streams equal up to a logged near-tie,
    per chunk tp times tp=1's launches of each kernel, each shard's pages
    on its own card, page conservation. Tokens/s and ms per chunk are
    readings."""
    n = torch.cuda.device_count()
    if n < 4:
        raise SystemExit(f"tp_cards: needs 4 cards, have {n}")
    cfg, _ = _model()
    prompts = _tp_prompts(cfg)
    one, r1 = _tp_serve(1, "none", prompts)
    one.close()
    res = dict(card=_smi(), cards=n, tp1=dict(
        tokens_per_s=r1["tokens_per_s"], ms_per_chunk=r1["ms_per_chunk"]))
    for tp in (2, 4):
        ce, r = _tp_serve(tp, "none", prompts, devices=None)
        want = [torch.device("cuda", i) for i in range(tp)]
        for f in ce.cache.fields():
            if [s.device for s in f.shards] != want:
                raise AssertionError(f"tp_cards: pages on "
                                     f"{[str(s.device) for s in f.shards]}")
        parted = _held_greedy(f"tp_cards tp={tp}", prompts, r, r1)
        for name in NEW_PATHS:
            if r["per_chunk"][name] != tp * r1["per_chunk"][name]:
                raise AssertionError(f"tp_cards tp={tp}: {name} launches "
                                     f"per chunk {r['per_chunk'][name]}")
        ce.check_page_conservation()
        ce.close()
        sampled = [a == b for (_i, k, _s), a, b in zip(
            prompts, r["streams"], r1["streams"]) if k]
        res[f"tp{tp}"] = dict(
            tokens_per_s=r["tokens_per_s"], ms_per_chunk=r["ms_per_chunk"],
            chunks=r["chunks"], greedy_parted=parted,
            sampled_equal=f"{sum(sampled)} of {len(sampled)}")
        del ce
        torch.cuda.empty_cache()
    log(f"tp_cards (qwen3-0p6b bf16, fp pages, shards on distinct cards; "
        f"readings, not claims; {res['card']} x {n}): {json.dumps(res)}")
    return res


def tp_phase() -> dict:
    """Phase 15: tensor-parallel serving of qwen3-0p6b bf16 at full width
    and depth, both shards on the one card. Serving, the per-shard kernel
    checks, the pages and layout, the launches, and readings."""
    t0 = time.monotonic()
    cfg, _ = _model()
    prompts = _tp_prompts(cfg)
    kernels = {}
    for fmt in FORMATS:
        kernels[fmt] = tp_kernel_check(fmt)
    serving, layout, launches_tp = {}, {}, {}
    for kv_quant in ("none", "int8"):
        fmt = _fmt(kv_quant)
        one, r1 = _tp_serve(1, kv_quant, prompts)
        tp, r2 = _tp_serve(TP_DEGREE, kv_quant, prompts)
        label = f"tp serving {fmt}"
        parted = _held_greedy(label, prompts, r2, r1)
        for name in NEW_PATHS:
            if r2["per_chunk"][name] != TP_DEGREE * r1["per_chunk"][name]:
                raise AssertionError(f"{label}: {name} launches per chunk "
                                     f"{r2['per_chunk'][name]} vs tp=1's "
                                     f"{r1['per_chunk'][name]}")
        pages = _tp_trie_pages(one, tp)
        if pages["of_bound"] > 1.0:
            raise AssertionError(f"{label}: trie pages {pages}")
        layout[fmt] = _tp_layout(tp, fmt)
        if fmt == "fp":
            fresh = np.random.default_rng(16).integers(
                0, cfg.vocab_size, 100).tolist()
            layout["export"] = _tp_export_layout(one, tp, fresh)
            serving["busy"] = {
                "tp1": _traced_busy(one, prompts, TP_ROOT / "tp1"),
                "tp2": _traced_busy(tp, prompts, TP_ROOT / "tp2"),
            }
        tp.check_page_conservation()
        one.close()
        tp.close()
        launches_tp[fmt] = r2["launches"]
        sampled = [a == b for (_i, k, _s), a, b in zip(
            prompts, r2["streams"], r1["streams"]) if k]
        serving[fmt] = dict(
            tokens_per_s_tp2=r2["tokens_per_s"],
            tokens_per_s_tp1=r1["tokens_per_s"],
            ms_per_chunk_tp2=r2["ms_per_chunk"],
            ms_per_chunk_tp1=r1["ms_per_chunk"],
            chunks_tp2=r2["chunks"], chunks_tp1=r1["chunks"],
            launches_per_chunk_tp2=r2["per_chunk"],
            launches_per_chunk_tp1=r1["per_chunk"],
            greedy_parted=parted,
            sampled_equal=f"{sum(sampled)} of {len(sampled)}",
            spec_tokens_per_pass=r2["snap"]["spec_tokens_per_pass"],
            trie_pages=pages,
        )
        del one, tp
        torch.cuda.empty_cache()
    res = dict(card=_smi(), kernels=kernels, serving=serving, layout=layout,
               launches_tp=launches_tp, seconds=time.monotonic() - t0)
    log(f"tp (qwen3-0p6b bf16, tensor_parallel={TP_DEGREE}, both shards on "
        f"cuda:0; one card: a correctness run, the speeds are readings, "
        f"not claims; {res['card']}): {json.dumps(res)}")
    log(f"phase 15 took {res['seconds']:.1f} s ({res['card']})")
    return res


# -- phase 16: the dense engine on a {data, tensor} mesh, and ZeRO-1 ------
# tlint: disable=TL006(read-only constant table — never mutated)
MESH_AXES = {"data": 2, "tensor": 2}
MESH_DEVICES = ("cuda:0",) * 4  # every shard on the one card
MESH_NEW = 32  # new tokens per request
MESH_SEQ_BUCKETS = (256, 512, 1024, 2048)
MESH_PROMPT_LENS = (256, 400, 700, 1000, 1300, 1600, 1850, 2000)
# a sharded greedy stream may part from the unsharded one only where the
# unsharded model's top-two logit gap at the parting token is within this.
# The Megatron specs' row-split products sum two partial products, which
# rounds differently from one whole product, at every layer: on the H100
# the two engines' prefill logits differed by at most 0.0625 (bf16) and
# 0.0703 (int8+kv), and a gap closes when the two logits move apart, so
# the hold is twice the larger (the gaps seen at partings: 0 to 0.047)
MESH_TIE = 0.140625
# the prefill logits, per row relative to the row's largest |logit|: the
# sharded engine's distance from the unsharded engine's, in each quant
# mode (read on the H100: 0.0223 bf16, 0.0247 int8+kv; twice the larger
# of those), and from a float32 engine on the same tree at most this
# multiple of the unsharded engine's, the error bf16 itself brings
MESH_LOGITS_OF_ONE = 0.05
MESH_LOGITS_OF_BF16 = 2.0
# phase 16's serving and phases 16-17's training depth, of 28: cut so
# that the whole script stays well inside its time limit
MESH_SERVE_LAYERS = 14
MESH_TRAIN_LAYERS = 8
MESH_TRAIN_BT = (4, 128)
MESH_TRAIN_SEED = 1414


def _mesh_prompts(cfg) -> list:
    rng = np.random.default_rng(1616)
    return [rng.integers(0, cfg.vocab_size, n).tolist()
            for n in MESH_PROMPT_LENS]


def _top_two_gap(eng, ids) -> float:
    """The engine's top-two logit gap for the next token after ``ids``."""
    logits = eng.prefill([ids])[0][0].float()
    v = torch.topk(logits, 2).values
    return float(v[0] - v[1])


def _mesh_held(label, ref, prompts, got, want, parted: list) -> None:
    """Greedy streams equal, or parted only where the unsharded engine
    ``ref``'s top-two gap at the parting token is within MESH_TIE
    (logged in ``parted``)."""
    for i, (p, a, b) in enumerate(zip(prompts, got, want)):
        at = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                  None)
        if at is None:
            if len(a) != len(b):
                raise AssertionError(f"{label} {i}: {len(a)} vs {len(b)} "
                                     "tokens")
            continue
        gap = _top_two_gap(ref, p + b[:at])
        log(f"{label} request {i}: parts at token {at}, unsharded top-two "
            f"gap {gap:.6g}")
        if gap > MESH_TIE:
            raise AssertionError(f"{label} {i}: parts at token {at} at a "
                                 f"top-two gap {gap} > {MESH_TIE}")
        parted.append(dict(label=label, request=i, at=at, gap=gap))


def mesh_flash_check() -> dict:
    """Each (data, tensor) shard's flash_attention launch at phase 3's
    flash shape (B 4, T 2048, Hq 16, Hkv 8, hd 128, bf16), fed
    contiguous pieces of its own as the placed cache holds them (B 2,
    Hq 8, Hkv 4): bitwise the same rows and heads of one launch over the
    whole, and within the bf16 bound of the plain version."""
    B, T, Hq, Hkv, hd, _ = FLASH_MAIN
    dp, tp = MESH_AXES["data"], MESH_AXES["tensor"]
    c = _flash_case(np.random.default_rng(1617), *FLASH_MAIN,
                    dtype=torch.bfloat16)
    whole = _flash(c, True)
    b, hq, hk = B // dp, Hq // tp, Hkv // tp
    err = 0.0
    for d in range(dp):
        for t in range(tp):
            rows = slice(d * b, (d + 1) * b)

            def kv(x):
                # the engine's layout: a contiguous piece of the padded
                # cache, read through its first T positions
                base = x._base if x._base is not None else x
                return base[rows, :, t * hk:(t + 1) * hk].contiguous()[:, :T]

            s = dict(c, q=c["q"][rows, :, t * hq:(t + 1) * hq].contiguous(),
                     k=kv(c["k"]), v=kv(c["v"]))
            got = _flash(s, True)
            if not torch.equal(got, whole[rows, :, t * hq:(t + 1) * hq]):
                raise AssertionError(f"mesh flash shard ({d}, {t}) is not "
                                     "the whole launch's block")
            err = max(err, _err(got, _flash(s, False), BF16_TOL))
    log(f"mesh flash: {dp * tp} shards bitwise the whole launch's blocks, "
        f"max abs err vs plain {err}")
    return {"shards": dp * tp, "max_abs_err": err}


def _cast_tree(tree, dtype=torch.float32):
    """A copy of a parameter tree in ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _mesh_engines(cfg, params, mesh, quant=None):
    from tensorlink_tpu_torch.models.transformer import (
        cache_specs,
        partition_specs,
    )

    kw = dict(max_seq_len=MESH_SEQ_BUCKETS[-1] + 2 * MESH_NEW,
              seq_buckets=MESH_SEQ_BUCKETS, batch_buckets=(1, 2, 4, 8))
    one = GenerationEngine(cfg, params, quant=quant, device="cuda", **kw)
    placed = tmesh.put(mesh, params, partition_specs(cfg))
    sharded = GenerationEngine(cfg, placed, mesh=mesh, quant=quant,
                               cache_specs=cache_specs(cfg), **kw)
    return one, sharded


def mesh_serving(devices=MESH_DEVICES) -> dict:
    """Phase 16 step 1: qwen3-0p6b bf16 at full width and
    MESH_SERVE_LAYERS layers, flash on,
    served by the unsharded GenerationEngine and by one on a {data: 2,
    tensor: 2} mesh over ``devices``: 8 prompts of 256–2000 tokens (one
    B=8 prefill at T 2048) x MESH_NEW greedy tokens through
    generate_compiled, a beam of 4 over 2 of them, lookahead over 2, then
    both engines at quant="int8+kv". The counts are zeroed before the
    sharded engines run and read after: L x 4 flash launches for a B=8
    prefill (rows split over data, heads over tensor), L x 2 for a B=1
    one on the one card (its rows replicated over data: one data group
    runs per distinct device set; L x 4 on four cards), no plain
    attention."""
    cfg = config_presets()["qwen3-0p6b"].with_(flash_attention=True,
                                               n_layers=MESH_SERVE_LAYERS)
    mesh = tmesh.build_mesh(MESH_AXES, list(devices) if devices else None)
    g = torch.Generator(device="cuda")
    g.manual_seed(1618)
    params = init_params(cfg, g, device="cuda")
    prompts = _mesh_prompts(cfg)
    L, V = cfg.n_layers, cfg.vocab_size
    res = {"mesh": {k: str(v) for k, v in mesh.shape.items()}}
    parted, seen, b8, lg32 = [], {}, {}, None
    for quant in (None, "int8+kv"):
        label = f"mesh {quant or 'bf16'}"
        one, sharded = _mesh_engines(cfg, params, mesh, quant)
        if sharded._fmesh is not mesh:
            raise AssertionError(f"{label}: the flash prefill is not per "
                                 "shard")
        for leaf in (sharded.params["layers"]["attn"]["wq"],):
            leaf = getattr(leaf, "q", leaf)
            if leaf.devices != mesh.flat():
                raise AssertionError(f"{label}: wq on {leaf.devices}")
        one.generate_compiled([prompts[0][:256]], max_new_tokens=2)
        want, t_one = _sync_s(lambda: one.generate_compiled(
            prompts, max_new_tokens=MESH_NEW))
        lg_one = one.prefill(prompts)[0].float()
        if lg32 is None:
            f32 = GenerationEngine(
                cfg.with_(dtype=torch.float32),
                _cast_tree(params),
                max_seq_len=one.max_seq_len, seq_buckets=MESH_SEQ_BUCKETS,
                batch_buckets=(8,), device="cuda")
            lg32 = f32.prefill(prompts)[0].float()
            del f32
        want_beams = want_look = None
        if quant is None:
            want_beams = []
            for p in prompts[:2]:
                with _BeamRecord(4).recording() as rec:
                    want_beams.append((one.generate_beam(
                        [p], num_beams=4, max_new_tokens=16).sequences[0],
                        rec))
            # repetitive prompts of 384 tokens: lookahead's drafts hit
            rep = [(p[:48] * 8)[:MESH_SEQ_BUCKETS[1] * 3 // 4]
                   for p in prompts[2:4]]
            want_look = [one.generate_lookahead([r], max_new_tokens=MESH_NEW)
                         .sequences[0] for r in rep]
        sharded.generate_compiled([prompts[0][:256]], max_new_tokens=2)
        torch.cuda.synchronize()
        att.reset_counts()
        sharded.flash_prefills = 0
        got, t_mesh = _sync_s(lambda: sharded.generate_compiled(
            prompts, max_new_tokens=MESH_NEW))
        n8 = att.flash_attention.launches
        lg = sharded.prefill(prompts)[0].float()
        n_prefill = att.flash_attention.launches - n8
        beams = look = None
        if quant is None:
            beams = []
            for p in prompts[:2]:
                with _BeamRecord(4).recording() as rec:
                    beams.append((sharded.generate_beam(
                        [p], num_beams=4, max_new_tokens=16).sequences[0],
                        rec))
            look = [sharded.generate_lookahead([r], max_new_tokens=MESH_NEW)
                    .sequences[0] for r in rep]
        launches = att.flash_attention.launches
        plain = {f.__name__: f.calls for f in att._REFS if f.calls}
        if plain:
            raise AssertionError(f"{label}: plain attention ran {plain}")
        if n8 != L * 4 or n_prefill != L * 4:
            raise AssertionError(f"{label}: {n8} and {n_prefill} flash "
                                 f"launches for a B=8 prefill, not {L} x 4")
        b8[quant or "bf16"] = n_prefill
        # a B=1 prefill (beam, lookahead) keeps its rows whole over data:
        # one data group runs per distinct set of devices (on one card,
        # one group; on four cards, both, each filling its own replica)
        tp, flat = MESH_AXES["tensor"], mesh.flat()
        sets = len({tuple(flat[d * tp:(d + 1) * tp])
                    for d in range(MESH_AXES["data"])})
        one_row = 2 + 2 if quant is None else 0  # beam and lookahead prefills
        if launches != 2 * L * 4 + one_row * L * tp * sets:
            raise AssertionError(f"{label}: {launches} flash launches")
        def rel(a, b):
            return float(((a - b).abs() / b.abs().amax(-1, keepdim=True))
                         .max())

        err_one, err_mesh = rel(lg_one, lg32), rel(lg, lg32)
        of_one = rel(lg, lg_one)
        log(f"{label}: prefill logits from the float32 engine's: unsharded "
            f"{err_one:.6g}, sharded {err_mesh:.6g} of the row's max; "
            f"sharded from unsharded {of_one:.6g} (bound "
            f"{MESH_LOGITS_OF_ONE}), {float((lg - lg_one).abs().max()):.6g}"
            f" at most")
        if not torch.isfinite(lg).all() or of_one > MESH_LOGITS_OF_ONE \
                or err_mesh > MESH_LOGITS_OF_BF16 * err_one:
            raise AssertionError(f"{label}: prefill logits {of_one} of the "
                                 f"row's max from the unsharded engine's "
                                 f"(bound {MESH_LOGITS_OF_ONE}); {err_mesh} "
                                 f"from float32's, the unsharded engine's "
                                 f"{err_one}")
        for s in got.sequences:
            if len(s) != MESH_NEW or not all(0 <= t < V for t in s):
                raise AssertionError(f"{label}: bad output {len(s)} tokens")
        _mesh_held(f"{label} compiled", one, prompts, got.sequences,
                   want.sequences, parted)
        if quant is None:
            _mesh_held(f"{label} lookahead", one, rep, look, want_look,
                       parted)
            for i, ((a, ra), (b, rb)) in enumerate(zip(beams, want_beams)):
                _held_beam(f"beam {i}", a, ra, b, rb, parted, tie=MESH_TIE,
                           phase=label)
        gen = sum(len(s) for s in got.sequences)
        seen[quant or "bf16"] = launches
        res[quant or "bf16"] = dict(
            tokens_per_s_mesh=gen / t_mesh, tokens_per_s_one=gen / t_one,
            compiled_s_mesh=t_mesh, compiled_s_one=t_one,
            flash_launches=launches, logits_of_f32_mesh=err_mesh,
            logits_of_f32_one=err_one, logits_mesh_of_one=of_one,
            logits_abs_max=float((lg - lg_one).abs().max()))
        del one, sharded
        torch.cuda.empty_cache()
    res["parted"] = parted
    res["largest_gap"] = max((p["gap"] for p in parted), default=0.0)
    res["launches"] = sum(seen.values())
    res["launches_per_b8_prefill"] = b8
    return res


def mesh_zero1(n_layers: int = MESH_TRAIN_LAYERS,
               keep: dict | None = None) -> dict:
    """Phase 16 step 3: qwen3-0p6b f32 at full width and ``n_layers``,
    B 4, T 128, AdamW, two steps each of the unsharded n_micro=2 step,
    zero1 on {data: 2} and zero1 x tp on {data: 2, tp: 2} (every replica
    on the one card): loss, grad norm and every param bitwise equal
    across the three; each replica's optimizer bytes exactly what the
    specs give (each leaf whose leading dim divides the grid split over
    it). Two unsharded steps from the same start run first: whether the
    default kernels are bitwise repeatable (a reading); where not, the
    three run under torch.use_deterministic_algorithms(True,
    warn_only=True). ``keep`` (a dict) receives the unsharded run's
    tree, batches, gradients per step, params and readings, which phase
    17 holds its placed steps against."""
    from tensorlink_tpu_torch.engine.optimizers import tree_leaves
    from tensorlink_tpu_torch.engine.training import (
        _dp_shardable,
        make_optimizer,
        make_train_step,
    )

    cfg = _train_cfg(n_layers, torch.float32)
    B, T = MESH_TRAIN_BT
    rng = np.random.default_rng(MESH_TRAIN_SEED)
    batches = [{"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32), device="cuda")}
        for _ in range(2)]
    opt = make_optimizer("adamw", lr=1e-3, grad_clip=1.0)
    dev = list(MESH_DEVICES)

    def run(ts, params, state):
        out, ms = [], []
        for b in batches:
            t0 = time.perf_counter()
            params, state, m = ts.step_fn(params, state, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return params, state, out, ms

    base = make_train_step(cfg, opt, n_micro=2)
    p0 = _seeded(cfg, "cuda", MESH_TRAIN_SEED)
    pa, _, ma, _ = run(base, p0, base.init_state(p0))
    pb, _, mb, _ = run(base, p0, base.init_state(p0))
    repeatable = ma == mb and all(torch.equal(x, y) for x, y in zip(
        tree_leaves(pa), tree_leaves(pb)))
    del pa, pb
    ctx = contextlib.nullcontext() if repeatable else _deterministic()
    res = dict(card=_smi(), layers=n_layers, default_repeatable=repeatable)
    with ctx:
        kopt, kept = _keeping_grads(opt)
        keeping = make_train_step(cfg, kopt, n_micro=2)
        ref, rstate, mref, ms_ref = run(keeping, p0, keeping.init_state(p0))
        if keep is not None:
            keep.update(cfg=cfg, p0=p0, batches=batches, opt=opt,
                        grads=kept, params=ref, losses=mref, step_ms=ms_ref,
                        deterministic=not repeatable)
        else:
            kept.clear()
        full_bytes = sum(t.numel() * t.element_size()
                         for t in tree_leaves(rstate))
        del rstate
        z1 = make_train_step(cfg, opt, n_micro=2, zero1=True,
                             mesh=tmesh.build_mesh({"data": 2}, dev[:2]))
        mesh = tmesh.serving_mesh(2, dp=2, devices=dev)
        zt = make_train_step(cfg, opt, n_micro=2, zero1=True, mesh=mesh,
                             dp_axis="data", tp_axis="tp")
        for name, ts, params in (
                ("zero1", z1, p0),
                ("zero1 x tp", zt, tmesh.put(
                    mesh, p0, ttr.tp_partition_specs(cfg, axis="tp")))):
            state = ts.init_state(params)
            world = 2 if ts.tp_axis is None else 4
            want = sum((t.numel() // world if _dp_shardable(
                tuple(t.shape), world) else t.numel()) * t.element_size()
                for t in tree_leaves(tmesh.full_tree(state)))
            per = tmesh.shard_bytes(state, 0)
            if per != want:
                raise AssertionError(f"mesh {name}: {per} optimizer bytes "
                                     f"a replica, the specs give {want}")
            got, _, m, ms = run(ts, params, state)
            if m != mref:
                raise AssertionError(f"mesh {name}: (loss, grad_norm) {m} "
                                     f"vs the unsharded step's {mref}")
            for a, b in zip(tree_leaves(tmesh.full_tree(got)),
                            tree_leaves(ref), strict=True):
                if not torch.equal(a, b):
                    raise AssertionError(f"mesh {name}: params differ from "
                                         "the unsharded step's")
            res[name] = dict(step_ms=ms, opt_bytes_per_replica=per,
                             opt_bytes_of_unsharded=per / full_bytes)
            del got, state
            torch.cuda.empty_cache()
    res.update(unsharded_step_ms=ms_ref, losses=mref,
               opt_bytes_unsharded=full_bytes)
    return res


@contextlib.contextmanager
def _deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def mesh_phase(keep: dict | None = None) -> dict:
    """Phase 16: the dense engine on a {data: 2, tensor: 2} mesh whose four
    devices are all cuda:0, and ZeRO-1 (see mesh_serving,
    mesh_flash_check and mesh_zero1; ``keep`` receives the unsharded
    training run for phase 17). The speeds are readings, not claims: four
    shards on one card quadruple the dense path's launches."""
    t0 = time.monotonic()
    res = dict(card=_smi(), flash=mesh_flash_check())
    res["serving"] = mesh_serving()
    res["zero1"] = mesh_zero1(keep=keep)
    res["seconds"] = time.monotonic() - t0
    log(f"mesh (qwen3-0p6b: {MESH_AXES} on one card; a correctness run, "
        f"the speeds are readings, not claims; {res['card']}): "
        f"{json.dumps(res)}")
    log(f"phase 16 took {res['seconds']:.1f} s ({res['card']})")
    return res


def mesh_cards() -> dict:
    """Not a phase of ``main()``: it needs four cards on one host. Phase
    16's serving with the mesh's four devices on four distinct cards, then
    a port validator, a worker advertising the four cards
    (MLConfig(mesh_devices=4)) and a user on 127.0.0.1: a job planned
    with parallelism {data: 2, tensor: 2} through a user's
    DistributedModel (the validator's HTTP hosting takes no parallelism
    in either package) answers a static, a beam and a streamed request
    over the port's P2P frames, each equal to the in-process unsharded
    engine up to a logged near-tie; then a training job on the same plan
    takes 2 ZeRO-1 AdamW steps, each loss within 1e-4 of make_train_step
    in process, its optimizer state split over the data replicas' cards."""
    from tensorlink_tpu_torch.core.config import (
        MLConfig,
        UserConfig,
        ValidatorConfig,
        WorkerConfig,
    )
    from tensorlink_tpu_torch.engine.optimizers import tree_leaves
    from tensorlink_tpu_torch.engine.training import (
        make_optimizer,
        make_train_step,
    )
    from tensorlink_tpu_torch.ml.module import DistributedModel
    from tensorlink_tpu_torch.nodes.runners import (
        UserNode,
        ValidatorNode,
        WorkerNode,
    )

    n = torch.cuda.device_count()
    if n < 4:
        raise SystemExit(f"mesh_cards: needs 4 cards, have {n}")
    res = dict(card=_smi(), cards=n, serving=mesh_serving(devices=None))
    root = Path(__file__).resolve().parent / "build" / "mesh_cards"
    shutil.rmtree(root, ignore_errors=True)
    common = dict(local_test=True, log_dir=str(root / "logs"),
                  env_file=str(root / ".env"))
    plan = dict(MESH_AXES)
    cfg = config_presets()["qwen3-0p6b"]
    nodes = []
    try:
        with _clean_spawn():
            v = ValidatorNode(ValidatorConfig(
                endpoint=False, key_dir=str(root / "vkeys"), ml=MLConfig(),
                **common)).start()
            nodes.append(v)
            seeds = [["127.0.0.1", v.port]]
            w = WorkerNode(WorkerConfig(
                seed_validators=seeds, key_dir=str(root / "wkeys"),
                ml=MLConfig(mesh_devices=4), **common)).start()
            nodes.append(w)
            u = UserNode(UserConfig(
                seed_validators=seeds, key_dir=str(root / "ukeys"),
                ml=MLConfig(), **common)).start()
            nodes.append(u)
        deadline = time.monotonic() + 60
        while len(v.status()["peers"]) < 2:
            if time.monotonic() > deadline:
                raise AssertionError("mesh_cards: the nodes never met")
            time.sleep(0.1)
        model = DistributedModel(cfg, node=u, seed=1619, parallelism=plan,
                                 seq_len=2048)
        rt = w.executor.jobs[model.job_id]
        cards = [torch.device("cuda", i) for i in range(4)]
        if rt.mesh is None or rt.mesh.flat() != cards:
            raise AssertionError(f"mesh_cards: the worker's mesh {rt.mesh}")
        g = torch.Generator(device="cuda")
        g.manual_seed(1619)
        ref = GenerationEngine(cfg, init_params(cfg, g, device="cuda"),
                               max_seq_len=2048, device="cuda")
        prompts = [p[:300] for p in _mesh_prompts(cfg)[:2]]
        parted: list = []
        got = model.generate(prompts, max_new_tokens=MESH_NEW)
        want = ref.generate_compiled(prompts, max_new_tokens=MESH_NEW)
        _mesh_held("mesh_cards static", ref, prompts,
                   [list(s) for s in got], want.sequences, parted)
        streamed = []
        got = model.generate(prompts[:1], max_new_tokens=MESH_NEW,
                             stream_cb=lambda t: streamed.append(t))
        if len(streamed) < 2:
            raise AssertionError(f"mesh_cards: {len(streamed)} steps "
                                 "streamed")
        _mesh_held("mesh_cards streamed", ref, prompts[:1],
                   [list(s) for s in got], want.sequences[:1], parted)
        # the worker's engine runs the same beam loop: record it there
        with _BeamRecord(4).recording() as got_rec:
            beam = model.generate(prompts[:1], max_new_tokens=16,
                                  num_beams=4)
        with _BeamRecord(4).recording() as want_rec:
            want_b = ref.generate_beam(prompts[:1], num_beams=4,
                                       max_new_tokens=16)
        res["beam_equal"] = list(beam[0]) == want_b.sequences[0]
        _held_beam("beam", list(beam[0]), got_rec, want_b.sequences[0],
                   want_rec, parted, tie=MESH_TIE, phase="mesh_cards")
        res["parted"] = parted
        del ref
        torch.cuda.empty_cache()
        tcfg = _train_cfg(4, torch.float32)
        B, T = MESH_TRAIN_BT
        tm = DistributedModel(tcfg, node=u, seed=1620, training=True,
                              parallelism=plan, batch=B, seq_len=T,
                              n_micro=2)
        trt = w.executor.jobs[tm.job_id]
        if w.executor._zero1_dp(trt) != 2:
            raise AssertionError("mesh_cards: the training job is not zero1")
        tm.init_optimizer("adamw", lr=1e-3)
        split = [t for t in tree_leaves(trt.opt_state) if t.grid[1] > 1]
        if not split or any(t.devices != cards for t in split):
            raise AssertionError("mesh_cards: no optimizer state split over "
                                 "the data replicas' cards")
        full = sum(t.numel() * t.element_size()
                   for t in tree_leaves(tmesh.full_tree(trt.opt_state)))
        res["opt_bytes_card0_of_whole"] = tmesh.shard_bytes(
            trt.opt_state, 0) / full
        ts = make_train_step(tcfg, make_optimizer("adamw", lr=1e-3,
                                                  grad_clip=1.0), n_micro=2)
        local = _seeded(tcfg, "cuda", 1620)
        state = ts.init_state(local)
        rng = np.random.default_rng(1621)
        losses = []
        for _ in range(2):
            toks = rng.integers(0, tcfg.vocab_size, (B, T)).astype(np.int32)
            r = tm.train_step(toks)
            local, state, m = ts.step_fn(local, state, {
                "tokens": torch.as_tensor(toks, device="cuda")})
            losses.append((r["loss"], float(m["loss"])))
            if _rel(r["loss"], float(m["loss"])) > TRAIN_NODE_LOSS_RTOL:
                raise AssertionError(f"mesh_cards: losses {losses}")
        res["train_losses"] = losses
    finally:
        for nd in reversed(nodes):
            nd.stop()
    log(f"mesh_cards (qwen3-0p6b, {MESH_AXES} on four cards; readings, not "
        f"claims; {res['card']} x {n}): {json.dumps(res)}")
    return res


# -- phase 17 ----------------------------------------------------------
FSDP_LAYOUTS = {"fsdp2-tensor2": {"fsdp": 2, "tensor": 2},
                "fsdp4": {"fsdp": 4}}
FSDP_DEVICES = ("cuda:0",) * 4  # every shard on the one card
FSDP_REPEAT = "fsdp2-tensor2"  # the layout whose two runs must be bitwise
FSDP_NODE_LAYERS = 4  # the node path's depth: its logits cross the user
FSDP_NODE_BT = (2, 64)  # batch rows x tokens of the node path's steps
FSDP_NODE_HINT = {"tensor": 2}  # the planner fills the rest with fsdp
FSDP_NODE_SEED = 1717
FSDP_ROOT = Path(__file__).resolve().parent / "build" / "fsdp"
# the placed steps against the unsharded n_micro=2 step, relative, read
# from the card (H100 readings, PR 15: losses 0-1.6e-7; each leaf's
# gradient in its norm, ||d|| / ||ref||, 3.7e-6 at step 1 and 6.9e-5 at
# step 2, after AdamW's first update moved the params apart; the params
# after both steps 6.3e-6)
FSDP_LOSS_RTOL = 1e-6
FSDP_GRAD_RTOL = (2e-5, 2.5e-4)  # step 1, step 2
FSDP_PARAM_RTOL = 2.5e-5


def _leaf_rel(got, want: torch.Tensor) -> float:
    """``||got - want|| / ||want||`` in float64, ``want`` whole (on the
    host or a card) and ``got`` whole or placed: a placed leaf piece by
    piece on its devices, each against its cut of ``want``, so no card
    joins it."""
    if not isinstance(got, tmesh.Sharded):
        d = (got.double() - want.to(got.device).double())
        return float(torch.linalg.vector_norm(d)
                     / torch.linalg.vector_norm(want.double()))
    sq = 0.0
    for j in got.first_of_keys().values():
        piece = got.shards[j]
        cut = tmesh.piece(want, got.spec, got.mesh, j).to(piece.device)
        sq += float(torch.sum((piece.double() - cut.double()) ** 2))
    return (sq ** 0.5) / float(torch.linalg.vector_norm(want.double()))


def _placed_share(label: str, tree, n: int) -> dict:
    """Each device's bytes of a placed tree: exactly a quarter (1/n) of
    the leaves split over every device plus the leaves it replicates
    (asserted)."""
    from tensorlink_tpu_torch.engine.optimizers import tree_leaves

    split = rep = 0
    for t in tree_leaves(tree):
        b = t.numel() * t.element_size()
        pieces = t.pieces()
        if pieces == n:
            split += b
        elif pieces == 1:
            rep += b
        else:
            raise AssertionError(f"fsdp {label}: a leaf in {pieces} "
                                 f"pieces of {n}: {t}")
    want = split // n + rep
    got = [tmesh.shard_bytes(tree, j) for j in range(n)]
    if any(g != want for g in got):
        raise AssertionError(f"fsdp {label}: {got} bytes a device, the "
                             f"specs give {want}")
    return dict(bytes_per_device=want, whole=split + rep,
                of_whole=want / (split + rep))


def _traced_step(ts, params, state, batch) -> dict:
    """One train step traced by ``torch.profiler`` (the device's activity
    alone, no trace file: the host's ops would cost seconds to record and
    export): its wall time, the card's busy share (its kernels' device
    time over the wall time; one stream) and the device launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ts.step_fn(params, state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, launches = 0.0, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            busy += t / 1e3
            launches += e.count
    if busy <= 0:
        raise AssertionError("fsdp: the trace holds no device kernel")
    return dict(wall_ms=wall, device_busy_ms=busy, busy_share=busy / wall,
                device_launches=launches)


def _fsdp_reference(n_layers: int = MESH_TRAIN_LAYERS) -> dict:
    """Phase 16's unsharded run on its own (mesh_zero1's tree, batches,
    AdamW and steps, its gradients kept), for fsdp_phase or fsdp_cards
    without phase 16. The peak bytes on the card are read over a run
    that keeps nothing."""
    from tensorlink_tpu_torch.engine.training import (
        make_optimizer,
        make_train_step,
    )

    cfg = _train_cfg(n_layers, torch.float32)
    B, T = MESH_TRAIN_BT
    rng = np.random.default_rng(MESH_TRAIN_SEED)
    batches = [{"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32), device="cuda")}
        for _ in range(2)]
    opt = make_optimizer("adamw", lr=1e-3, grad_clip=1.0)
    p0 = _seeded(cfg, "cuda", MESH_TRAIN_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = make_train_step(cfg, opt, n_micro=2)
    p, st = p0, base.init_state(p0)
    for b in batches:
        p, st, _ = base.step_fn(p, st, b)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del p, st
    kopt, kept = _keeping_grads(opt)
    keeping = make_train_step(cfg, kopt, n_micro=2)
    p, st, losses, ms = p0, keeping.init_state(p0), [], []
    for b in batches:
        t0 = time.perf_counter()
        p, st, m = keeping.step_fn(p, st, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append((float(m["loss"]), float(m["grad_norm"])))
    return dict(cfg=cfg, p0=p0, batches=batches, opt=opt, grads=kept,
                params=p, losses=losses, step_ms=ms, deterministic=False,
                peak_bytes=peak)


def fsdp_layouts(ref: dict, devices=FSDP_DEVICES, names=None,
                 trace: bool = True) -> dict:
    """Phase 17 steps 1–2: the reference's tree placed by
    ``partition_specs(tensor_axis=, fsdp_axis=)`` on each layout of
    FSDP_LAYOUTS (or ``names``) over ``devices``, two
    ``make_train_step(mesh=)`` AdamW steps over the reference's batches:
    each step's loss within FSDP_LOSS_RTOL and each leaf's gradient (read
    as the step hands it to ``sharded_update``) within FSDP_GRAD_RTOL of
    the unsharded step's, the params after both steps within
    FSDP_PARAM_RTOL; the params,
    gradients and optimizer state split a quarter to each device beside
    their replicated leaves; FSDP_REPEAT's two steps run twice bitwise
    equal. Readings: step ms, and (``trace``) one traced step of each
    layout and of the unsharded step (busy share, launches)."""
    from tensorlink_tpu_torch.engine import training as tt
    from tensorlink_tpu_torch.engine.optimizers import tree_leaves

    cfg, p0, batches, opt = (ref["cfg"], ref["p0"], ref["batches"],
                             ref["opt"])
    res: dict = dict(card=_smi(), layers=cfg.n_layers,
                     unsharded=dict(step_ms=ref["step_ms"],
                                    losses=ref["losses"]))
    ctx = _deterministic() if ref["deterministic"] else \
        contextlib.nullcontext()
    inner = tt.sharded_update
    with ctx:
        if trace:
            base = tt.make_train_step(cfg, opt, n_micro=2)
            res["unsharded"]["traced"] = _traced_step(
                base, p0, base.init_state(p0), batches[0])
            del base
        for name in names or FSDP_LAYOUTS:
            torch.cuda.empty_cache()  # the earlier phases' cached blocks
            axes = FSDP_LAYOUTS[name]
            mesh = tmesh.build_mesh(axes, list(devices))
            kw = dict(tensor_axis="tensor" if "tensor" in axes else None,
                      fsdp_axis="fsdp")
            placed = tmesh.put(mesh, p0, ttr.partition_specs(cfg, **kw))
            ts = tt.make_train_step(cfg, opt, n_micro=2, mesh=mesh)
            out: dict = dict(axes=axes, params=_placed_share(
                "params", placed, mesh.size))
            grads_err, shares = [], []

            def spy(optimizer, grads, state, params, specs, m):
                want = _named(ref["grads"][len(grads_err)])
                grads_err.append(max(_leaf_rel(g, want[k]) for k, g in
                                     _named(grads).items()))
                shares.append(_placed_share("gradients", grads, m.size))
                return inner(optimizer, grads, state, params, specs, m)

            def run(step_ms: list, first: bool):
                p, st = placed, ts.init_state(placed)
                if first:
                    out["optimizer_state"] = _placed_share(
                        "optimizer state", st, mesh.size)
                losses = []
                for b in batches:
                    t0 = time.perf_counter()
                    p, st, m = ts.step_fn(p, st, b)
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    losses.append((float(m["loss"]), float(m["grad_norm"])))
                return p, st, losses

            ms: list = []
            tt.sharded_update = spy
            try:
                p, st, losses = run(ms, True)
            finally:
                tt.sharded_update = inner
            for (lg, _), (lw, _) in zip(losses, ref["losses"]):
                if _rel(lg, lw) > FSDP_LOSS_RTOL:
                    raise AssertionError(f"fsdp {name}: losses {losses} vs "
                                         f"{ref['losses']}")
            if any(e > b for e, b in zip(grads_err, FSDP_GRAD_RTOL)):
                raise AssertionError(f"fsdp {name}: a gradient leaf "
                                     f"{grads_err} from the unsharded one")
            want = _named(ref["params"])
            perr = max(_leaf_rel(g, want[k]) for k, g in _named(p).items())
            if perr > FSDP_PARAM_RTOL:
                raise AssertionError(f"fsdp {name}: a param leaf {perr} "
                                     "from the unsharded one")
            out.update(step_ms=ms, losses=losses, grads=shares[0],
                       grad_leaf_rel_max=grads_err,
                       param_leaf_rel_max=perr,
                       loss_rel=[_rel(a[0], b[0]) for a, b in
                                 zip(losses, ref["losses"])])
            if name == FSDP_REPEAT:
                ms2: list = []
                p2, st2, losses2 = run(ms2, False)
                same = losses2 == losses and all(
                    torch.equal(x, y)
                    for a, b in zip(tree_leaves((p, st)),
                                    tree_leaves((p2, st2)), strict=True)
                    for x, y in zip(a.shards, b.shards))
                if not same:
                    raise AssertionError(f"fsdp {name}: two runs differ "
                                         f"({losses} vs {losses2})")
                out.update(repeat_bitwise=True, repeat_step_ms=ms2)
                del p2, st2
            if trace:
                out["traced"] = _traced_step(
                    ts, placed, ts.init_state(placed), batches[0])
            res[name] = out
            del p, st, placed
            torch.cuda.empty_cache()
    return res


def fsdp_node(devices=FSDP_DEVICES) -> dict:
    """Phase 17 step 3: a port validator, a worker advertising
    ``devices`` (``MLConfig(mesh_devices=[...])``: the four shards on the
    card) and a user on 127.0.0.1. A DistributedModel of qwen3-0p6b's
    widths at FSDP_NODE_LAYERS layers, f32, asking parallelism
    FSDP_NODE_HINT, is planned {tensor: 2, fsdp: 2}, as the JAX planner
    plans it; the worker trains its placed tree: two AdamW steps within
    TRAIN_NODE_LOSS_RTOL of the same placed step in process; the
    checkpoint file's params and optimizer state are the job's trees
    joined on the host, bitwise, and the HF export loads back bitwise."""
    from tensorlink_tpu_torch.core import serialization as ser
    from tensorlink_tpu_torch.core.config import (
        MLConfig,
        UserConfig,
        ValidatorConfig,
        WorkerConfig,
    )
    from tensorlink_tpu_torch.engine import training as tt
    from tensorlink_tpu_torch.engine.optimizers import tree_leaves
    from tensorlink_tpu_torch.ml.module import DistributedModel
    from tensorlink_tpu_torch.models.sharded import whole
    from tensorlink_tpu_torch.nodes.runners import (
        UserNode,
        ValidatorNode,
        WorkerNode,
    )

    root = FSDP_ROOT / "node"
    shutil.rmtree(root, ignore_errors=True)
    cfg = _train_cfg(FSDP_NODE_LAYERS, torch.float32)
    B, T = FSDP_NODE_BT
    rng = np.random.default_rng(FSDP_NODE_SEED)
    batches = [rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
               for _ in range(2)]
    common = dict(local_test=True, log_dir=str(root / "logs"),
                  env_file=str(root / ".env"))
    nodes = []
    res: dict = dict(card=_smi(), layers=FSDP_NODE_LAYERS,
                     hint=FSDP_NODE_HINT)
    try:
        with _clean_spawn():
            v = ValidatorNode(ValidatorConfig(
                endpoint=False, key_dir=str(root / "vkeys"), ml=MLConfig(),
                **common)).start()
            nodes.append(v)
            seeds = [["127.0.0.1", v.port]]
            w = WorkerNode(WorkerConfig(
                seed_validators=seeds, key_dir=str(root / "wkeys"),
                ml=MLConfig(mesh_devices=list(devices)), **common)).start()
            nodes.append(w)
            u = UserNode(UserConfig(
                seed_validators=seeds, key_dir=str(root / "ukeys"),
                ml=MLConfig(), **common)).start()
            nodes.append(u)
        deadline = time.monotonic() + 60
        while len(v.status()["peers"]) < 2:
            if time.monotonic() > deadline:
                raise AssertionError("fsdp node: the nodes never met")
            time.sleep(0.1)
        model = DistributedModel(cfg, node=u, seed=FSDP_NODE_SEED,
                                 training=True, parallelism=FSDP_NODE_HINT,
                                 batch=B, seq_len=T, n_micro=2)
        axes = model.plan.stages[0].mesh_axes
        if axes != {"tensor": 2, "fsdp": 2}:
            raise AssertionError(f"fsdp node: planned {axes}")
        rt = w.executor.jobs[model.job_id]
        if rt.mesh is None or not tmesh.is_sharded(rt.params):
            raise AssertionError(f"fsdp node: the job's mesh {rt.mesh}")
        model.init_optimizer("adamw", lr=1e-3)
        mesh = tmesh.build_mesh(axes, list(devices))
        local = tmesh.put(mesh, _seeded(cfg, "cuda", FSDP_NODE_SEED),
                          ttr.partition_specs(cfg, tensor_axis="tensor",
                                              fsdp_axis="fsdp"))
        ts = tt.make_train_step(cfg, tt.make_optimizer(
            "adamw", lr=1e-3, grad_clip=1.0), n_micro=2, mesh=mesh)
        state = ts.init_state(local)
        losses, node_s = [], []
        for toks in batches:
            t0 = time.perf_counter()
            r = model.train_step(toks)
            node_s.append(time.perf_counter() - t0)
            local, state, m = ts.step_fn(local, state, {
                "tokens": torch.as_tensor(toks, device="cuda")})
            losses.append((r["loss"], float(m["loss"])))
            if _rel(r["loss"], float(m["loss"])) > TRAIN_NODE_LOSS_RTOL:
                raise AssertionError(f"fsdp node: losses {losses}")
        job = whole(rt.params, "cpu")
        res.update(losses=losses, node_step_s=node_s,
                   param_leaf_rel_max=max(
                       _leaf_rel(g, _named(job)[k])
                       for k, g in _named(local).items()))
        ckpt = root / "ckpt"
        model.save_checkpoint(str(ckpt))
        saved = ser.decode_from_file(
            ckpt / f"stage_0_{FSDP_NODE_LAYERS}.tlts")
        state_leaves = tree_leaves(tmesh.full_tree(rt.opt_state, "cpu"))
        nbytes = 0
        for label, got, want in (
                ("params", tree_leaves(saved["params"]), tree_leaves(job)),
                ("optimizer state", tree_leaves(saved["opt_state"]),
                 state_leaves)):
            for a, b in zip(got, want, strict=True):
                a = torch.as_tensor(np.asarray(a))
                if a.shape != b.shape or not torch.equal(a, b):
                    raise AssertionError(f"fsdp node: the checkpoint's "
                                         f"{label} are not the job's")
                nbytes += b.numel() * b.element_size()
        res["checkpoint_bytes"] = nbytes
        out = model.export_hf_checkpoint(str(root / "hf"))
        _, loaded = load_params(out, cfg, device="cpu")
        res["export_bytes"] = _same_tree("fsdp node: the exported tree",
                                         loaded, job)
        res["opt_bytes_device0_of_whole"] = tmesh.shard_bytes(
            rt.opt_state, 0) / sum(t.numel() * t.element_size()
                                   for t in state_leaves)
        model.shutdown()
    finally:
        for nd in reversed(nodes):
            nd.stop()
        nodes = v = w = u = rt = None
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return res


def fsdp_phase(ref: dict | None = None) -> dict:
    """Phase 17: ZeRO-3 training of a placed tree on an {fsdp, tensor}
    mesh whose four devices are cuda:0 (fsdp_layouts against phase 16's
    unsharded step, ``ref``, or its own run of it), then the node path
    (fsdp_node). No attention kernel runs (the training forward keeps the
    einsum attention): 0 launches, asserted. The speeds are readings,
    not claims: four shards on one card multiply the step's launches."""
    t0 = time.monotonic()
    if not ref:
        ref = _fsdp_reference()
    att.reset_counts()
    res = dict(card=_smi(), layouts=fsdp_layouts(ref))
    ref.clear()
    torch.cuda.empty_cache()
    res["seconds_layouts"] = time.monotonic() - t0
    res["node"] = fsdp_node()
    launches = {n: getattr(att, n).launches for n in REPLACES}
    launches["flash_attention"] = att.flash_attention.launches
    if any(launches.values()):
        raise AssertionError(f"fsdp: kernels launched {launches}; the "
                             "training path has none")
    res["launches"] = launches
    res["seconds"] = time.monotonic() - t0
    lay = res["layouts"]
    names = ["unsharded", *FSDP_LAYOUTS]
    log(f"fsdp readings ({res['card']}): step ms "
        + ", ".join(f"{n} {lay[n]['step_ms']}" for n in names)
        + "; device launches of one traced step "
        + ", ".join(f"{n} {lay[n]['traced']['device_launches']}"
                    for n in names)
        + "; the card's busy share of it "
        + ", ".join(f"{n} {lay[n]['traced']['busy_share']:.4f}"
                    for n in names))
    log(f"fsdp (qwen3-0p6b f32, {lay['layers']} layers, B 4, T 128, "
        f"n_micro 2, AdamW; shards on one card; readings, not claims; "
        f"{res['card']}): {json.dumps(res)}")
    log(f"phase 17 took {res['seconds']:.1f} s ({res['card']})")
    return res


def fsdp_cards() -> dict:
    """Not a phase of ``main()``: it needs four cards on one host. Phase
    17's layouts with their four devices on four distinct cards: each
    card's ``torch.cuda.max_memory_allocated`` through the placed tree's
    placement, state and two steps beside the unsharded step's on card 0
    (the reference waits on the host meanwhile, so no card holds a whole
    tree); the losses, gradients and params held as in phase 17."""
    n = torch.cuda.device_count()
    if n < 4:
        raise SystemExit(f"fsdp_cards: needs 4 cards, have {n}")
    cards = [torch.device("cuda", i) for i in range(4)]
    ref = _fsdp_reference()
    res: dict = dict(card=_smi(), cards=n,
                     unsharded_peak_bytes_card0=ref["peak_bytes"],
                     unsharded=dict(step_ms=ref["step_ms"],
                                    losses=ref["losses"]))
    from tensorlink_tpu_torch.engine.optimizers import tree_map

    def host(tree):
        return tree_map(lambda t: t.cpu(), tree)

    for key in ("p0", "params"):
        ref[key] = host(ref[key])
    ref["grads"] = [host(g) for g in ref["grads"]]
    for name in FSDP_LAYOUTS:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        lay = fsdp_layouts(ref, cards, names=[name], trace=False)[name]
        torch.cuda.synchronize()
        lay["peak_bytes"] = [torch.cuda.max_memory_allocated(c)
                             for c in cards]
        lay["peak_of_unsharded_card0"] = [
            b / ref["peak_bytes"] for b in lay["peak_bytes"]]
        res[name] = lay
    log(f"fsdp_cards (qwen3-0p6b f32, {FSDP_LAYOUTS} on four cards; "
        f"readings, not claims; {res['card']} x {n}): {json.dumps(res)}")
    return res


# -- phase 18 ----------------------------------------------------------
# Mixtral-8x7B at full width, its experts split over an expert mesh axis
EXPERT_LAYOUTS = {"expert4": {"expert": 4},
                  "expert2-tensor2": {"expert": 2, "tensor": 2}}
EXPERT_DEVICES = ("cuda:0",) * 4  # every shard on the one card
EXPERT_PROMPT_LENS = (64, 96, 128, 200, 256, 320, 400, 512)
EXPERT_SEQ_BUCKETS = (128, 256, 512, 1024)
EXPERT_NEW = 32  # new tokens per request
EXPERT_BEAM = (2, 4, 16)  # prompts, beams, new tokens
EXPERT_SERVE_SEED = 1818
EXPERT_TRAIN_LAYERS = 1  # of 32: a layer's tree, grads and AdamW state
EXPERT_TRAIN_BT = (4, 128)  # are about 27.4 GB in f32
EXPERT_TRAIN_SEED = 1819
EXPERT_NODE_BT = (4, 128)
EXPERT_NODE_SEED = 1820


def _expert_cfg(n_layers: int, dtype):
    return config_presets()["mixtral-8x7b"].with_(n_layers=n_layers,
                                                  dtype=dtype)


def _expert_specs(cfg, axes: dict):
    return ttr.partition_specs(
        cfg, tensor_axis="tensor" if axes.get("tensor", 1) > 1 else None,
        expert_axis="expert")


def _expert_sets(mesh) -> int:
    """How many expert sub-groups of a mesh run attention: one per
    distinct set of devices the tensor shards of an expert index lie on
    (one on one card; ``expert`` of them on distinct cards)."""
    ep = mesh.shape.get("expert", 1)
    tp = mesh.size // ep
    flat = mesh.flat()
    return len({tuple(flat[e * tp:(e + 1) * tp]) for e in range(ep)})


class _RouterRecord:
    """Every router product of a MoE forward in call order (float32
    ``[B, T, E]`` on the device), through ``models/transformer.py::
    _moe_gates``: the dense dispatch's one routing call, once per layer
    and distinct device."""

    def __init__(self):
        self.calls: list = []

    @contextlib.contextmanager
    def recording(self):
        real = ttr._moe_gates

        def gates(h, router, cfg):
            self.calls.append(ttr._mm(h, router).float())
            return real(h, router, cfg)

        ttr._moe_gates = gates
        try:
            yield self
        finally:
            ttr._moe_gates = real

    def at(self, step: int, layer: int, row: int, pos: int, n_layers: int,
           per_layer: int = 1):
        """Row ``row``'s router logits at position ``pos`` in layer
        ``layer`` of forward ``step`` (0 the prefill, then one per decode
        step); ``per_layer`` calls a layer (one per distinct device)."""
        return self.calls[(step * n_layers + layer) * per_layer][row, pos]


def _routing_flip(one: _RouterRecord, got: _RouterRecord, step: int, rows,
                  positions, cfg, per_layer: int) -> dict | None:
    """Whether the unsharded run ``one`` and the sharded run ``got`` sent
    some row of ``rows`` at forward ``step`` to different top-k experts
    in some layer: the layers, the unsharded router's k-th over (k+1)-th
    logit gap there, the largest router-logit difference between the two
    runs there and the unsharded router's largest logit, else None. A
    flip needs the gap within twice that difference."""
    K, L = cfg.n_experts_per_tok, cfg.n_layers
    hits = []
    for row, pos in zip(rows, positions):
        for layer in range(L):
            a = one.at(step, layer, row, pos, L)
            b = got.at(step, layer, row, pos, L, per_layer)
            ta, tb = ttr.top_k(a, K)[1], ttr.top_k(b, K)[1]
            if set(ta.tolist()) == set(tb.tolist()):
                continue
            v = torch.sort(a, descending=True).values
            hits.append(dict(row=row, layer=layer,
                             gap=float(v[K - 1] - v[K]),
                             delta=float((a - b).abs().max()),
                             scale=float(a.abs().max())))
    if not hits:
        return None
    return min(hits, key=lambda h: h["gap"])


def _moe_held(label, ref, prompts, got, want, parted: list, flip) -> None:
    """``_mesh_held`` for a MoE model: a stream may also part where the
    two runs routed the parting token's forward to different experts
    (``flip(i, at)``, :func:`_routing_flip`) with the router logits
    within MESH_LOGITS_OF_ONE of the unsharded router's largest logit of
    each other (a routing near-tie: the experts' outputs differ by far
    more than the final top-two gap can show). Logged in ``parted``."""
    for i, (p, a, b) in enumerate(zip(prompts, got, want)):
        at = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                  None)
        if at is None:
            if len(a) != len(b):
                raise AssertionError(f"{label} {i}: {len(a)} vs {len(b)} "
                                     "tokens")
            continue
        gap = _top_two_gap(ref, p + b[:at])
        f = flip(i, at)
        log(f"{label} request {i}: parts at token {at}, unsharded top-two "
            f"gap {gap:.6g}, routing {f}")
        routed = f is not None and f["delta"] <= MESH_LOGITS_OF_ONE * \
            f["scale"]
        if gap > MESH_TIE and not routed:
            raise AssertionError(f"{label} {i}: parts at token {at} at a "
                                 f"top-two gap {gap} > {MESH_TIE}, routing "
                                 f"{f}")
        parted.append(dict(label=label, request=i, at=at, gap=gap,
                           routing=f if gap > MESH_TIE else None))


def _moe_beam_held(label, got, got_rec, want, want_rec, parted: list, flip,
                   phase: str) -> None:
    """``_held_beam`` for a MoE model: the frontiers may also part at a
    step whose forward the two runs routed to different experts for some
    beam (``flip(step)``), under :func:`_moe_held`'s bound."""
    try:
        _held_beam(label, got, got_rec, want, want_rec, parted,
                   tie=MESH_TIE, phase=phase)
        return
    except AssertionError:
        at = next((s for s, (f, g) in enumerate(zip(got_rec.frontiers,
                                                    want_rec.frontiers))
                   if sorted(map(tuple, f)) != sorted(map(tuple, g))), None)
        f = flip(at) if at is not None else None
        log(f"{phase} {label}: the frontiers part at step {at}, routing {f}")
        if f is None or f["delta"] > MESH_LOGITS_OF_ONE * f["scale"]:
            raise
        parted.append(dict(stream=label, at=at, routing=f))


def _peaks(cards) -> list:
    torch.cuda.synchronize()
    return [torch.cuda.max_memory_allocated(c) for c in cards]


def expert_serving(devices=EXPERT_DEVICES, cards=None) -> dict:
    """Phase 18 step 1: mixtral-8x7b bf16 at full width, MIXTRAL_LAYERS of
    its 32 layers, flash on, served by the unsharded GenerationEngine and
    by one over each layout of EXPERT_LAYOUTS on ``devices`` (placed by
    partition_specs(expert_axis="expert"), the dense dispatch: each expert
    shard's experts over every token, summed in shard order): 8 prompts
    of 64–512 tokens x EXPERT_NEW greedy tokens through generate_compiled
    and a beam over 2 of them, held as phase 16 holds its mesh engine
    (prefill logits MESH_LOGITS_OF_ONE of the unsharded engine's and
    within MESH_LOGITS_OF_BF16 x its distance from a float32 engine;
    streams and beams equal or parted at a logged near-tie, MESH_TIE).
    With the counts zeroed before each sharded engine runs: exactly
    layers x tensor shards x distinct device sets flash launches a
    prefill, no plain attention. ``cards`` (distinct cards): each card's
    peak memory over the sharded engine's run beside card 0's over the
    unsharded engine's."""
    cfg = _expert_cfg(MIXTRAL_LAYERS, torch.bfloat16).with_(
        flash_attention=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(EXPERT_SERVE_SEED)
    params = init_params(cfg, g, device="cuda")
    rng = np.random.default_rng(EXPERT_SERVE_SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in EXPERT_PROMPT_LENS]
    n_beam, beams_k, beam_new = EXPERT_BEAM
    L, V = cfg.n_layers, cfg.vocab_size
    kw = dict(max_seq_len=EXPERT_SEQ_BUCKETS[-1] + 2 * EXPERT_NEW,
              seq_buckets=EXPERT_SEQ_BUCKETS, batch_buckets=(1, 2, 4, 8))
    whole = sum(t.numel() * t.element_size() for t in
                _leaves_of(params))
    res: dict = dict(card=_smi(), layers=L, tree_bytes=whole)
    f32 = GenerationEngine(cfg.with_(dtype=torch.float32),
                           _cast_tree(params), device="cuda", **kw)
    lg32 = f32.prefill(prompts)[0].float()
    del f32
    torch.cuda.empty_cache()
    if cards:
        torch.cuda.reset_peak_memory_stats(cards[0])
    one = GenerationEngine(cfg, params, device="cuda", **kw)
    one.generate_compiled([prompts[0]], max_new_tokens=2)
    with _RouterRecord().recording() as route_one:
        want, t_one = _sync_s(lambda: one.generate_compiled(
            prompts, max_new_tokens=EXPERT_NEW))
    lg_one = one.prefill(prompts)[0].float()
    want_beams = []
    for p in prompts[:n_beam]:
        with _BeamRecord(beams_k).recording() as rec, \
                _RouterRecord().recording() as route:
            want_beams.append((one.generate_beam(
                [p], num_beams=beams_k, max_new_tokens=beam_new)
                .sequences[0], rec, route))
    if cards:
        res["unsharded_peak_bytes_card0"] = _peaks(cards[:1])[0]

    def rel(a, b):
        return float(((a - b).abs() / b.abs().amax(-1, keepdim=True)).max())

    err_one = rel(lg_one, lg32)
    gen = sum(len(s) for s in want.sequences)
    res["unsharded"] = dict(tokens_per_s=gen / t_one, compiled_s=t_one,
                            logits_of_f32=err_one)
    parted: list = []
    for name, axes in EXPERT_LAYOUTS.items():
        mesh = tmesh.build_mesh(axes, list(devices) if devices else None)
        placed = tmesh.put(mesh, params, _expert_specs(cfg, axes))
        tp = axes.get("tensor", 1)
        if cards:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            for c in cards:
                torch.cuda.reset_peak_memory_stats(c)
        sharded = GenerationEngine(
            cfg, placed, mesh=mesh, cache_specs=ttr.cache_specs(
                cfg, data_axis=None, tensor_axis="tensor" if tp > 1 else None),
            **kw)
        if sharded._fmesh is not mesh:
            raise AssertionError(f"expert {name}: the flash prefill is not "
                                 "per shard")
        w_gate = sharded.params["layers"]["mlp"]["w_gate"]
        if w_gate.n_expert != axes["expert"]:
            raise AssertionError(f"expert {name}: w_gate {w_gate}")
        sharded.generate_compiled([prompts[0]], max_new_tokens=2)
        torch.cuda.synchronize()
        att.reset_counts()
        sharded.flash_prefills = 0
        with _RouterRecord().recording() as route_mesh:
            got, t_mesh = _sync_s(lambda: sharded.generate_compiled(
                prompts, max_new_tokens=EXPERT_NEW))
        n8 = att.flash_attention.launches
        lg = sharded.prefill(prompts)[0].float()
        n_prefill = att.flash_attention.launches - n8
        beams = []
        for p in prompts[:n_beam]:
            with _BeamRecord(beams_k).recording() as rec, \
                    _RouterRecord().recording() as route:
                beams.append((sharded.generate_beam(
                    [p], num_beams=beams_k, max_new_tokens=beam_new)
                    .sequences[0], rec, route))
        launches = att.flash_attention.launches
        plain = {f.__name__: f.calls for f in att._REFS if f.calls}
        paged_runs = {n: getattr(att, n).launches for n in REPLACES
                      if getattr(att, n).launches}
        if plain or paged_runs:
            raise AssertionError(f"expert {name}: plain attention ran "
                                 f"{plain}, paged kernels {paged_runs}")
        per = L * tp * _expert_sets(mesh)
        prefills = 2 + n_beam  # compiled, prefill, each beam's
        if n8 != per or n_prefill != per or launches != prefills * per \
                or sharded.flash_prefills != prefills:
            raise AssertionError(f"expert {name}: {n8}, {n_prefill} and "
                                 f"{launches} flash launches, {per} a "
                                 f"prefill wanted")
        err_mesh, of_one = rel(lg, lg32), rel(lg, lg_one)
        log(f"expert {name}: prefill logits from the float32 engine's: "
            f"unsharded {err_one:.6g}, sharded {err_mesh:.6g} of the row's "
            f"max; sharded from unsharded {of_one:.6g} (bound "
            f"{MESH_LOGITS_OF_ONE}), {float((lg - lg_one).abs().max()):.6g}"
            f" at most")
        if not torch.isfinite(lg).all() or of_one > MESH_LOGITS_OF_ONE \
                or err_mesh > MESH_LOGITS_OF_BF16 * err_one:
            raise AssertionError(f"expert {name}: prefill logits {of_one} "
                                 f"of the row's max from the unsharded "
                                 f"engine's; {err_mesh} from float32's, the "
                                 f"unsharded engine's {err_one}")
        for s in got.sequences:
            if len(s) != EXPERT_NEW or not all(0 <= t < V for t in s):
                raise AssertionError(f"expert {name}: bad output {len(s)} "
                                     "tokens")
        # the dense dispatch routes once per layer and distinct device
        per_layer = len(set(mesh.flat()))
        _moe_held(f"expert {name} compiled", one, prompts, got.sequences,
                  want.sequences, parted,
                  lambda i, at: _routing_flip(
                      route_one, route_mesh, at, [i],
                      [len(prompts[i]) - 1 if at == 0 else 0], cfg,
                      per_layer))
        for i, ((a, ra, qa), (b, rb, qb)) in enumerate(zip(beams,
                                                            want_beams)):
            _moe_beam_held(
                f"beam {i}", a, ra, b, rb, parted,
                lambda at, qa=qa, qb=qb, i=i: _routing_flip(
                    qb, qa, at, range(1 if at == 0 else beams_k),
                    [len(prompts[i]) - 1] if at == 0 else [0] * beams_k,
                    cfg, per_layer),
                phase=f"expert {name}")
        out = dict(axes=axes, tokens_per_s=gen / t_mesh, compiled_s=t_mesh,
                   flash_launches=launches, flash_launches_per_prefill=per,
                   logits_of_f32=err_mesh, logits_of_unsharded=of_one,
                   logits_abs_max=float((lg - lg_one).abs().max()),
                   bytes_per_device=[tmesh.shard_bytes(placed, j)
                                     for j in range(mesh.size)])
        if cards:
            out["peak_bytes"] = _peaks(cards)
        res[name] = out
        del sharded, placed
        torch.cuda.empty_cache()
    res["parted"] = parted
    res["largest_gap"] = max((p["gap"] for p in parted if p.get("gap")
                              is not None and not p.get("routing")),
                             default=0.0)
    res["launches"] = sum(res[n]["flash_launches"] for n in EXPERT_LAYOUTS)
    return res


def _leaves_of(tree) -> list:
    from tensorlink_tpu_torch.engine.optimizers import tree_leaves

    return tree_leaves(tree)


def expert_training(devices=EXPERT_DEVICES, cards=None) -> dict:
    """Phase 18 step 2: mixtral-8x7b f32 at full width, EXPERT_TRAIN_LAYERS
    of its layers, B 4, T 128, AdamW, two steps of the capacity-factor
    sparse dispatch (the worker's training dispatch on an expert axis),
    unsharded and placed on {expert: 4} over ``devices``: the losses
    within FSDP_LOSS_RTOL, each leaf's gradient within FSDP_GRAD_RTOL and
    the params after both steps within FSDP_PARAM_RTOL of the unsharded
    step's (in its norm); each device's params, gradients and AdamW state
    exactly a quarter of the expert leaves plus the replicated rest; two
    placed runs bitwise; at moe_capacity_factor = E/K the placed sparse
    gradients equal the dense dispatch's within the first step's bounds.
    No attention kernel runs (0 launches, asserted). The card holds one
    tree with its gradients and AdamW state at a time: the seeded tree,
    the unsharded run's gradients and params and the first placed run's
    pieces wait on the host. Readings: step ms of a first unsharded run
    that keeps nothing and of the second placed run, and their peak
    memory (``cards``: each card's over the placed steps, card 0's over
    the unsharded ones)."""
    from tensorlink_tpu_torch.engine import training as tt
    from tensorlink_tpu_torch.engine.optimizers import tree_map

    cfg = _expert_cfg(EXPERT_TRAIN_LAYERS, torch.float32).with_(
        moe_dispatch="sparse")
    B, T = EXPERT_TRAIN_BT
    rng = np.random.default_rng(EXPERT_TRAIN_SEED)
    batches = [{"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32), device="cuda")}
        for _ in range(2)]
    opt = tt.make_optimizer("adamw", lr=1e-3, grad_clip=1.0)
    p_host = tree_map(lambda t: t.cpu(),
                      _seeded(cfg, "cuda", EXPERT_TRAIN_SEED))
    torch.cuda.empty_cache()
    res: dict = dict(card=_smi(), layers=cfg.n_layers,
                     capacity_factor=cfg.moe_capacity_factor)
    att.reset_counts()

    def unsharded(ts):
        """The seeded tree on the card and its fresh state; nothing else
        holds them, so a step's input is freed once the step returns."""
        p = tree_map(lambda t: t.to("cuda"), p_host)
        return p, ts.init_state(p)

    def run(ts, start, ms: list):
        params, state = start()
        losses = []
        for b in batches:
            t0 = time.perf_counter()
            params, state, m = ts.step_fn(params, state, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append((float(m["loss"]), float(m["grad_norm"])))
        return params, state, losses

    def host(tree):
        return tree_map(lambda t: t.cpu(), tree)

    # the unsharded step alone first, keeping nothing: its ms and peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain = tt.make_train_step(cfg, opt)
    ms_one: list = []
    p, st, _ = run(plain, lambda: unsharded(plain), ms_one)
    res["unsharded"] = dict(step_ms=ms_one, peak_bytes=_peaks(
        [torch.cuda.current_device()])[0])
    del p, st, plain
    torch.cuda.empty_cache()
    kopt, kept = _keeping_grads(opt, "cpu")
    base = tt.make_train_step(cfg, kopt)
    ref_p, st, ref_losses = run(base, lambda: unsharded(base), [])
    del st, base
    ref_p = host(ref_p)
    torch.cuda.empty_cache()
    mesh = tmesh.build_mesh({"expert": 4}, list(devices))
    placed = tmesh.put(mesh, p_host, _expert_specs(cfg, {"expert": 4}))
    res["params"] = _placed_share("expert params", placed, mesh.size)
    inner = tt.sharded_update
    grads_err, shares = [], []

    def spy(optimizer, grads, state, params, specs, m):
        want = _named(kept[len(grads_err)])
        grads_err.append(max(_leaf_rel(g, want[k]) for k, g in
                             _named(grads).items()))
        shares.append(_placed_share("expert gradients", grads, m.size))
        return inner(optimizer, grads, state, params, specs, m)

    ts = tt.make_train_step(cfg, opt, mesh=mesh)

    def start():
        state = ts.init_state(placed)
        res["optimizer_state"] = _placed_share("expert optimizer state",
                                               state, mesh.size)
        return placed, state

    ms_checked: list = []
    tt.sharded_update = spy
    try:
        p1, s1, losses = run(ts, start, ms_checked)
    finally:
        tt.sharded_update = inner
    for (lg, _), (lw, _) in zip(losses, ref_losses):
        if _rel(lg, lw) > FSDP_LOSS_RTOL:
            raise AssertionError(f"expert training: losses {losses} vs "
                                 f"{ref_losses}")
    if any(e > b for e, b in zip(grads_err, FSDP_GRAD_RTOL)):
        raise AssertionError(f"expert training: a gradient leaf {grads_err}"
                             " from the unsharded one")
    want = _named(ref_p)
    perr = max(_leaf_rel(g, want[k]) for k, g in _named(p1).items())
    if perr > FSDP_PARAM_RTOL:
        raise AssertionError(f"expert training: a param leaf {perr} from "
                             "the unsharded one")
    del ref_p, want
    kept.clear()
    res.update(losses=losses, unsharded_losses=ref_losses, grads=shares[0],
               grad_leaf_rel_max=grads_err, param_leaf_rel_max=perr,
               loss_rel=[_rel(a[0], b[0]) for a, b in
                         zip(losses, ref_losses)],
               step_ms_with_checks=ms_checked)
    # the first run's pieces wait on the host for the second
    first = [{j: t.shards[j].cpu() for j in t.distinct()}
             for t in _leaves_of((p1, s1))]
    del p1, s1
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    for c in cards or [torch.cuda.current_device()]:
        torch.cuda.reset_peak_memory_stats(c)
    ms: list = []
    p2, s2, losses2 = run(ts, lambda: (placed, ts.init_state(placed)), ms)
    res.update(step_ms=ms, peak_bytes=_peaks(
        cards or [torch.cuda.current_device()]))
    same = losses2 == losses and all(
        t.distinct() == list(f) and all(
            torch.equal(t.shards[j].cpu(), x) for j, x in f.items())
        for t, f in zip(_leaves_of((p2, s2)), first, strict=True))
    if not same:
        raise AssertionError(f"expert training: two runs differ ({losses} "
                             f"vs {losses2})")
    res["repeat_bitwise"] = True
    del p2, s2, first
    torch.cuda.empty_cache()
    # no token drops at E/K: the sparse dispatch is the dense one
    E_K = cfg.n_experts / cfg.n_experts_per_tok
    toks = batches[0]["tokens"]
    gs, ls = tt.placed_grads(placed, cfg.with_(moe_capacity_factor=E_K), toks)
    gd, ld = tt.placed_grads(placed, cfg.with_(moe_dispatch="dense"), toks)
    dense_err = max(_leaf_rel(a, b.full()) for a, b in zip(
        _leaves_of(gs), _leaves_of(gd), strict=True))
    if _rel(float(ls), float(ld)) > FSDP_LOSS_RTOL \
            or dense_err > FSDP_GRAD_RTOL[0]:
        raise AssertionError(f"expert training: sparse at E/K {float(ls)}, "
                             f"dense {float(ld)}; a gradient leaf "
                             f"{dense_err} apart")
    res.update(dense_loss_rel=_rel(float(ls), float(ld)),
               dense_grad_leaf_rel_max=dense_err)
    del gs, gd, placed
    torch.cuda.empty_cache()
    launches = {n: getattr(att, n).launches for n in REPLACES}
    launches["flash_attention"] = att.flash_attention.launches
    if any(launches.values()):
        raise AssertionError(f"expert training: kernels launched "
                             f"{launches}; the training path has none")
    del p_host
    torch.cuda.empty_cache()
    # what the phase leaves allocated on each card (a leak would show)
    res["left_bytes"] = [torch.cuda.memory_allocated(c)
                         for c in cards or [torch.cuda.current_device()]]
    return res


def expert_phase() -> dict:
    """Phase 18: Mixtral-8x7B at full width with its experts split over an
    expert mesh axis whose four devices are cuda:0 — bf16 serving through
    the dense dispatch on {expert: 4} and {expert: 2, tensor: 2}
    (expert_serving), f32 training through the sparse dispatch on
    {expert: 4} (expert_training). The speeds are readings, not claims:
    four shards on one card run each expert block's launches in turn."""
    t0 = time.monotonic()
    res = dict(card=_smi(), serving=expert_serving())
    res["seconds_serving"] = time.monotonic() - t0
    res["training"] = expert_training()
    res["seconds"] = time.monotonic() - t0
    log(f"expert (mixtral-8x7b at full width, {MIXTRAL_LAYERS} layers "
        f"serving and {EXPERT_TRAIN_LAYERS} training, shards on one card; "
        f"readings, not claims; {res['card']}): {json.dumps(res)}")
    log(f"phase 18 took {res['seconds']:.1f} s ({res['card']})")
    return res


def expert_node(cards) -> dict:
    """A port validator, a worker advertising four cards
    (MLConfig(mesh_devices=4)) and a user on 127.0.0.1: a 2-layer
    Mixtral-8x7B job the planner gives its default plan, {expert: 4},
    answers a static and a beam request over the port's P2P frames, each
    equal to the in-process unsharded engine up to a logged near-tie;
    then an f32 training job on the same default plan takes 2 AdamW steps
    through a DistributedModel (the worker trains with the sparse
    dispatch), each loss within TRAIN_NODE_LOSS_RTOL of the same placed
    step in process over the same cards."""
    from tensorlink_tpu_torch.core.config import (
        MLConfig,
        UserConfig,
        ValidatorConfig,
        WorkerConfig,
    )
    from tensorlink_tpu_torch.engine.training import (
        make_optimizer,
        make_train_step,
    )
    from tensorlink_tpu_torch.ml.module import DistributedModel
    from tensorlink_tpu_torch.nodes.runners import (
        UserNode,
        ValidatorNode,
        WorkerNode,
    )

    root = Path(__file__).resolve().parent / "build" / "expert_cards"
    shutil.rmtree(root, ignore_errors=True)
    common = dict(local_test=True, log_dir=str(root / "logs"),
                  env_file=str(root / ".env"))
    cfg = _expert_cfg(MIXTRAL_LAYERS, torch.bfloat16)
    res: dict = {}
    nodes = []
    try:
        with _clean_spawn():
            v = ValidatorNode(ValidatorConfig(
                endpoint=False, key_dir=str(root / "vkeys"), ml=MLConfig(),
                **common)).start()
            nodes.append(v)
            seeds = [["127.0.0.1", v.port]]
            w = WorkerNode(WorkerConfig(
                seed_validators=seeds, key_dir=str(root / "wkeys"),
                ml=MLConfig(mesh_devices=4), **common)).start()
            nodes.append(w)
            u = UserNode(UserConfig(
                seed_validators=seeds, key_dir=str(root / "ukeys"),
                ml=MLConfig(), **common)).start()
            nodes.append(u)
        deadline = time.monotonic() + 60
        while len(v.status()["peers"]) < 2:
            if time.monotonic() > deadline:
                raise AssertionError("expert_cards: the nodes never met")
            time.sleep(0.1)
        model = DistributedModel(cfg, node=u, seed=EXPERT_NODE_SEED,
                                 seq_len=1024)
        rt = w.executor.jobs[model.job_id]
        axes = {k: v for k, v in rt.stage["mesh_axes"].items() if v > 1}
        if axes != {"expert": 4} or rt.mesh.flat() != list(cards):
            raise AssertionError(f"expert_cards: the worker's plan {axes} "
                                 f"on {rt.mesh}")
        res["plan"] = axes
        g = torch.Generator(device="cuda")
        g.manual_seed(EXPERT_NODE_SEED)
        ref = GenerationEngine(cfg, init_params(cfg, g, device="cuda"),
                               max_seq_len=1024, device="cuda")
        rng = np.random.default_rng(EXPERT_NODE_SEED)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in (200, 300)]
        parted: list = []
        # the worker's executor runs in this process: its routing records
        # here, once per layer and card
        per_layer = len(set(rt.mesh.flat()))
        with _RouterRecord().recording() as route_got:
            got = model.generate(prompts, max_new_tokens=EXPERT_NEW)
        with _RouterRecord().recording() as route_want:
            want = ref.generate_compiled(prompts, max_new_tokens=EXPERT_NEW)
        _moe_held("expert_cards static", ref, prompts,
                  [list(s) for s in got], want.sequences, parted,
                  lambda i, at: _routing_flip(
                      route_want, route_got, at, [i],
                      [len(prompts[i]) - 1 if at == 0 else 0], cfg,
                      per_layer))
        with _BeamRecord(4).recording() as got_rec, \
                _RouterRecord().recording() as q_got:
            beam = model.generate(prompts[:1], max_new_tokens=16,
                                  num_beams=4)
        with _BeamRecord(4).recording() as want_rec, \
                _RouterRecord().recording() as q_want:
            want_b = ref.generate_beam(prompts[:1], num_beams=4,
                                       max_new_tokens=16)
        _moe_beam_held(
            "beam", list(beam[0]), got_rec, want_b.sequences[0], want_rec,
            parted, lambda at: _routing_flip(
                q_want, q_got, at, range(1 if at == 0 else 4),
                [len(prompts[0]) - 1] if at == 0 else [0] * 4, cfg,
                per_layer),
            phase="expert_cards")
        res["parted"] = parted
        del ref
        model.shutdown()
        torch.cuda.empty_cache()
        tcfg = _expert_cfg(MIXTRAL_LAYERS, torch.float32)
        B, T = EXPERT_NODE_BT
        tm = DistributedModel(tcfg, node=u, seed=EXPERT_NODE_SEED + 1,
                              training=True, batch=B, seq_len=T, n_micro=1)
        trt = w.executor.jobs[tm.job_id]
        taxes = {k: v for k, v in trt.stage["mesh_axes"].items() if v > 1}
        if taxes != {"expert": 4}:
            raise AssertionError(f"expert_cards: the training plan {taxes}")
        tm.init_optimizer("adamw", lr=1e-3)
        mesh = tmesh.build_mesh({"expert": 4}, list(cards))
        local = tmesh.put(mesh, _seeded(tcfg, "cuda", EXPERT_NODE_SEED + 1),
                          _expert_specs(tcfg, {"expert": 4}))
        ts = make_train_step(tcfg.with_(moe_dispatch="sparse"),
                             make_optimizer("adamw", lr=1e-3,
                                            grad_clip=1.0), mesh=mesh)
        state = ts.init_state(local)
        losses = []
        for _ in range(2):
            toks = rng.integers(0, tcfg.vocab_size, (B, T)).astype(np.int32)
            r = tm.train_step(toks)
            local, state, m = ts.step_fn(local, state, {
                "tokens": torch.as_tensor(toks, device="cuda")})
            losses.append((r["loss"], float(m["loss"])))
            if _rel(r["loss"], float(m["loss"])) > TRAIN_NODE_LOSS_RTOL:
                raise AssertionError(f"expert_cards: losses {losses}")
        res["train_losses"] = losses
        tm.shutdown()
    finally:
        for nd in reversed(nodes):
            nd.stop()
    return res


def expert_cards() -> dict:
    """Not a phase of ``main()``: it needs four cards on one host. Phase
    18's serving and training with the mesh's four devices on four
    distinct cards, each card's peak memory beside the unsharded
    reference's on card 0, then expert_node over the same cards."""
    n = torch.cuda.device_count()
    if n < 4:
        raise SystemExit(f"expert_cards: needs 4 cards, have {n}")
    cards = [torch.device("cuda", i) for i in range(4)]
    res: dict = dict(card=_smi(), cards=n)
    res["serving"] = expert_serving(devices=cards, cards=cards)
    torch.cuda.empty_cache()
    res["training"] = expert_training(devices=cards, cards=cards)
    torch.cuda.empty_cache()
    res["node"] = expert_node(cards)
    log(f"expert_cards (mixtral-8x7b at full width on four cards; "
        f"readings, not claims; {res['card']} x {n}): {json.dumps(res)}")
    return res


# -- phase 19: the stage and seq mesh axes, and the quantized collectives --
# qwen3-0p6b at full width: an in-mesh GPipe over {stage: 4}, ring
# attention over {seq: 4} at T 8192, and tp=2 serving whose gathers move
# int8 (collective_quant)
# tlint: disable=TL006(read-only constant table — never mutated)
PP_AXES = {"stage": 4}
PP_DEVICES = ("cuda:0",) * 4  # every stage on the one card
PP_LAYERS = 28  # full depth: 7 layers a stage device
PP_BT = (4, 256)
PP_SEED = 1919
# tlint: disable=TL006(read-only constant table — never mutated)
SP_AXES = {"seq": 4}
SP_DEVICES = ("cuda:0",) * 4  # every ring device on the one card
SP_LAYERS = 8  # of 28: the depth the time budget allows at T 8192
SP_T = 8192
SP_SEED = 1920
PRODUCT_NODE_LAYERS = 4  # the worker jobs' depth: logits cross the user
PRODUCT_NODE_BT = (2, 64)  # small: each step's f32 logits cross the user
PRODUCT_NODE_SEED = 1921
PRODUCT_NODE_DEVICES = ("cuda:0",) * 2  # the worker's two mesh devices
PRODUCT_ROOT = Path(__file__).resolve().parent / "build" / "product"
QTP_LAYERS = 14  # of 28: the quantized tp serving's depth (time budget)
# the pipelined steps against the unsharded step: phase 17's bounds, as
# the differences have phase 17's causes (each micro-batch's products at
# another GEMM height, per-piece gradient sums; AdamW's first update
# moves entries whose gradient cancels to about eps by up to lr)
PP_LOSS_RTOL = FSDP_LOSS_RTOL
PP_GRAD_RTOL = FSDP_GRAD_RTOL
PP_PARAM_RTOL = FSDP_PARAM_RTOL
# the ring against the unsharded einsum attention at T 8192 (float32),
# about 5x an H100's readings (logits 4.7e-6 of the largest logit, loss
# 7.9e-8, the worst gradient leaf 9.4e-6 in its norm; PERF.md §6): the
# blockwise softmax sums the same terms in another order
SP_LOGITS_RTOL = 2.5e-5
SP_LOSS_RTOL = 5e-7
SP_GRAD_RTOL = 5e-5
# tests/test_ring.py: the int8 ring's attention output within 0.06 of the
# exact ring's (N(0,1) K/V measured ~0.012)
RING_QUANT_BOUND = 0.06
# a quantized-gather tp=2 greedy stream may part from tp=1's only where
# tp=1's top two logits lie within this of each other: the int8 gathers
# moved the top logit of draws from equal tokens by up to 0.3125 at 28
# layers on an H100 (every parting there at a gap of 0.03125 or less)
QTP_TIE = 0.5


def _pp_reference(n_layers: int | None = None, peak: bool = False) -> dict:
    """The unsharded float32 AdamW step (``make_train_step``, n_micro 1,
    remat) on the seeded tree, two steps over PP_BT batches, each step's
    gradients kept; with ``peak``, first the card's peak bytes over a
    run that keeps nothing."""
    from tensorlink_tpu_torch.engine.training import (
        make_optimizer,
        make_train_step,
    )

    cfg = _train_cfg(n_layers or PP_LAYERS, torch.float32)
    B, T = PP_BT
    rng = np.random.default_rng(PP_SEED)
    batches = [{"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32), device="cuda")}
        for _ in range(2)]
    opt = make_optimizer("adamw", lr=1e-3, grad_clip=1.0)
    p0 = _seeded(cfg, "cuda", PP_SEED)
    peak_bytes = None
    if peak:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = make_train_step(cfg, opt)
        p, st = p0, base.init_state(p0)
        for b in batches:
            p, st, _ = base.step_fn(p, st, b)
        torch.cuda.synchronize()
        peak_bytes = torch.cuda.max_memory_allocated()
        del p, st
    kopt, kept = _keeping_grads(opt)
    keeping = make_train_step(cfg, kopt)
    p, st, losses, ms = p0, keeping.init_state(p0), [], []
    for b in batches:
        t0 = time.perf_counter()
        p, st, m = keeping.step_fn(p, st, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append((float(m["loss"]), float(m["grad_norm"])))
    return dict(cfg=cfg, p0=p0, batches=batches, opt=opt, grads=kept,
                params=p, losses=losses, step_ms=ms, peak_bytes=peak_bytes)


def _stage_share(label: str, tree, mesh) -> dict:
    """Each stage device's bytes of a tree placed by the stage specs:
    exactly 1/n_stage of the layer leaves, plus the replicated rest
    (asserted)."""
    from tensorlink_tpu_torch.engine.optimizers import tree_leaves

    layers = tree["layers"]
    whole = sum(t.numel() * t.element_size() for t in tree_leaves(layers))
    rest = sum(t.numel() * t.element_size() for k, v in tree.items()
               if k != "layers" for t in tree_leaves(v))
    n = mesh.shape["stage"]
    got = [tmesh.shard_bytes(layers, j) for j in range(mesh.size)]
    if any(g * n != whole for g in got):
        raise AssertionError(f"stage {label}: {got} layer bytes a device "
                             f"of {whole}")
    if any(tmesh.shard_bytes({k: v for k, v in tree.items()
                              if k != "layers"}, j) != rest
           for j in range(mesh.size)):
        raise AssertionError(f"stage {label}: the replicated leaves")
    return dict(layer_bytes_per_device=got[0], layer_bytes=whole,
                of_layers=got[0] / whole, replicated_bytes=rest)


def pipeline_steps(ref: dict, devices=PP_DEVICES) -> dict:
    """Phase 19 step 1: the reference's tree placed by
    ``stage_param_specs`` on ``{stage: 4}`` over ``devices`` (each stage
    device holds its 7 layers; the embedding, norm and head replicate),
    two ``make_train_step(mesh=)`` AdamW steps, each batch through the
    in-mesh GPipe in ``pp_n_micro`` micro-batches: each step's loss within
    PP_LOSS_RTOL, each leaf's gradient within PP_GRAD_RTOL and the params
    after both steps within PP_PARAM_RTOL of the unsharded step's; the
    params, gradients and optimizer state 1/4 of the layers a device; the
    two steps run twice, bitwise equal."""
    from tensorlink_tpu_torch.engine import training as tt
    from tensorlink_tpu_torch.engine.optimizers import tree_leaves
    from tensorlink_tpu_torch.parallel.pipeline import pp_n_micro
    from tensorlink_tpu_torch.parallel.planner import (
        StagePlan,
        stage_param_specs,
    )

    cfg, p0, batches, opt = (ref["cfg"], ref["p0"], ref["batches"],
                             ref["opt"])
    mesh = tmesh.build_mesh(PP_AXES, list(devices))
    specs = stage_param_specs(cfg, StagePlan(
        worker_id="w0", layer_lo=0, layer_hi=cfg.n_layers, first=True,
        last=True, holds_head=True, mesh_axes=dict(PP_AXES)))
    placed = tmesh.put(mesh, p0, specs)
    ts = tt.make_train_step(cfg, opt, mesh=mesh)
    res: dict = dict(axes=PP_AXES, layers=cfg.n_layers,
                     n_micro=pp_n_micro(PP_AXES["stage"], PP_BT[0]),
                     params=_stage_share("params", placed, mesh))
    inner = tt.sharded_update
    grads_err, shares = [], []

    def spy(optimizer, grads, state, params, sp, m):
        want = _named(ref["grads"][len(grads_err)])
        grads_err.append(max(_leaf_rel(g, want[k])
                             for k, g in _named(grads).items()))
        shares.append(_stage_share("gradients", grads, m))
        return inner(optimizer, grads, state, params, sp, m)

    def run(step_ms: list, first: bool):
        p, st = placed, ts.init_state(placed)
        if first:
            res["optimizer_state"] = [_stage_share("optimizer state", s, mesh)
                                      for s in _state_trees(st)]
        losses = []
        for b in batches:
            t0 = time.perf_counter()
            p, st, m = ts.step_fn(p, st, b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append((float(m["loss"]), float(m["grad_norm"])))
        return p, st, losses

    ms: list = []
    tt.sharded_update = spy
    try:
        p, st, losses = run(ms, True)
    finally:
        tt.sharded_update = inner
    for (lg, _), (lw, _) in zip(losses, ref["losses"]):
        if _rel(lg, lw) > PP_LOSS_RTOL:
            raise AssertionError(f"stage: losses {losses} vs "
                                 f"{ref['losses']}")
    if any(e > b for e, b in zip(grads_err, PP_GRAD_RTOL)):
        raise AssertionError(f"stage: a gradient leaf {grads_err} from the "
                             "unsharded one")
    want = _named(ref["params"])
    perr = max(_leaf_rel(g, want[k]) for k, g in _named(p).items())
    if perr > PP_PARAM_RTOL:
        raise AssertionError(f"stage: a param leaf {perr} from the "
                             "unsharded one")
    ms2: list = []
    p2, st2, losses2 = run(ms2, False)
    same = losses2 == losses and all(
        torch.equal(x, y)
        for a, b in zip(tree_leaves((p, st)), tree_leaves((p2, st2)),
                        strict=True)
        for x, y in zip(a.shards, b.shards))
    if not same:
        raise AssertionError(f"stage: two runs differ ({losses} vs "
                             f"{losses2})")
    res.update(step_ms=ms, repeat_step_ms=ms2, losses=losses,
               unsharded_losses=ref["losses"],
               unsharded_step_ms=ref["step_ms"], grads=shares[0],
               grad_leaf_rel_max=grads_err, param_leaf_rel_max=perr,
               loss_rel=[_rel(a[0], b[0]) for a, b in
                         zip(losses, ref["losses"])],
               repeat_bitwise=True)
    del p, st, p2, st2, placed
    return res


def _state_trees(state) -> list:
    """The param-shaped trees of an optimizer state (AdamW's moments)."""
    if isinstance(state, dict):
        return [state] if "layers" in state else []
    if isinstance(state, tuple):
        return [t for s in state for t in _state_trees(s)]
    return []


def _seq_run(params, cfg, toks, mesh, cards) -> dict:
    """One float32 forward and backward of the causal-LM loss over
    ``toks`` (remat), unsharded or sequence parallel over ``mesh``: the
    logits, loss, gradients, ms and each of ``cards``' peak bytes."""
    from tensorlink_tpu_torch.engine.optimizers import tree_leaves, tree_map
    from tensorlink_tpu_torch.engine.training import _nll_sum

    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    t0 = time.perf_counter()
    with torch.enable_grad():
        logits, _ = ttr.stage_forward(leaves, cfg, tokens=toks, first=True,
                                      last=True, remat=True, seq_mesh=mesh)
        nll, n = _nll_sum(logits, toks, None)
        loss = nll / n
        # one thread, as GradFold's: over cards a block checkpointed
        # across the ring's devices would be recomputed by two at once
        with torch.autograd.set_multithreading_enabled(False):
            grads = torch.autograd.grad(loss, tree_leaves(leaves))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return dict(logits=logits.detach(), loss=float(loss.detach()),
                grads=grads, ms=ms,
                peak_bytes=[torch.cuda.max_memory_allocated(c)
                            for c in cards])


def seq_steps(devices=SP_DEVICES) -> dict:
    """Phase 19 step 2: qwen3-0p6b f32 at SP_LAYERS layers, B 1, T 8192:
    the unsharded ``stage_forward`` (einsum attention over the whole
    sequence) and the same stage over ``{seq: 4}`` (each ring device's
    2048 rows, ring attention), forward and gradients: the logits within
    SP_LOGITS_RTOL of the largest logit, the loss within SP_LOSS_RTOL,
    each gradient leaf within SP_GRAD_RTOL in its norm; the ring run
    twice, bitwise. Layer 0's attention through the int8 ring within
    RING_QUANT_BOUND of the exact ring's, twice bitwise. Readings: ms
    and each card's peak bytes of each run (on one card the ring's four
    devices share it)."""
    from tensorlink_tpu_torch.engine.optimizers import tree_map
    from tensorlink_tpu_torch.parallel.ring import ring_attention

    cfg = _train_cfg(SP_LAYERS, torch.float32)
    params = _seeded(cfg, "cuda", SP_SEED)
    rng = np.random.default_rng(SP_SEED)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, SP_T)).astype(
        np.int32), device="cuda")
    mesh = tmesh.build_mesh(SP_AXES, list(devices))
    cards = list(dict.fromkeys(mesh.flat()))
    ref = _seq_run(params, cfg, toks, None, cards)
    ring = _seq_run(params, cfg, toks, mesh, cards)
    scale = float(ref["logits"].abs().max())
    logits_rel = float((ring["logits"] - ref["logits"]).abs().max()) / scale
    names = list(_named(params))
    grad_rel = {k: float(torch.linalg.vector_norm((a - b).double())
                         / torch.linalg.vector_norm(b.double()))
                for k, a, b in zip(names, ring["grads"], ref["grads"])}
    res = dict(axes=SP_AXES, layers=SP_LAYERS, T=SP_T,
               logits_rel=logits_rel, loss=ring["loss"],
               unsharded_loss=ref["loss"],
               loss_rel=_rel(ring["loss"], ref["loss"]),
               grad_leaf_rel_max=max(grad_rel.values()),
               grad_leaf_rel_worst=max(grad_rel, key=grad_rel.get),
               ms=ring["ms"], unsharded_ms=ref["ms"],
               peak_bytes=ring["peak_bytes"],
               unsharded_peak_bytes=ref["peak_bytes"])
    if (logits_rel > SP_LOGITS_RTOL or res["loss_rel"] > SP_LOSS_RTOL
            or res["grad_leaf_rel_max"] > SP_GRAD_RTOL):
        raise AssertionError(f"seq: the ring against the unsharded stage "
                             f"{json.dumps(res)}")
    del ref
    again = _seq_run(params, cfg, toks, mesh, cards)
    if not (torch.equal(again["logits"], ring["logits"]) and all(
            torch.equal(a, b) for a, b in zip(again["grads"],
                                              ring["grads"]))):
        raise AssertionError("seq: two ring runs differ")
    res.update(repeat_bitwise=True, repeat_ms=again["ms"])
    del again, ring
    # layer 0's q/k/v at T 8192 through the exact and the int8 ring
    with torch.no_grad():
        lp = tree_map(lambda t: t[0], params["layers"])
        pos = torch.arange(SP_T, device="cuda")[None]
        cos, sin = ttr.rope_tables(pos, ttr._rope_dim(cfg), cfg.rope_theta)
        x = ttr._embed_tokens(params, toks.long(), cfg)
        q, k, v = ttr._qkv(ttr._norm(x, lp["ln1"], cfg), lp, cfg, cos, sin)
        exact = ring_attention(q, k, v, mesh)
        quant = [ring_attention(q, k, v, mesh, quantized=True)
                 for _ in range(2)]
    qerr = float((quant[0] - exact).abs().max())
    if qerr >= RING_QUANT_BOUND or not torch.equal(quant[0], quant[1]):
        raise AssertionError(f"seq: the int8 ring {qerr} from the exact "
                             "ring, or two runs differ")
    res.update(ring_quant_max_abs=qerr, ring_quant_bitwise=True)
    del params, quant, exact
    torch.cuda.empty_cache()
    return res


def product_node(devices=PRODUCT_NODE_DEVICES) -> dict:
    """Phase 19 step 3: a port validator, a worker advertising
    ``devices`` (``MLConfig(mesh_devices=[...])``) and a user on
    127.0.0.1; DistributedModels of qwen3-0p6b's widths at
    PRODUCT_NODE_LAYERS layers, f32, asking parallelism ``{stage: 2}``
    and then ``{seq: 2}``: each is planned with that axis, its worker
    runs its slice through the in-mesh GPipe or the ring, its eval
    forward's logits equal the in-process placed forward's, and two
    AdamW steps' losses stay within TRAIN_NODE_LOSS_RTOL of the same
    placed step in process."""
    from tensorlink_tpu_torch.core.config import (
        MLConfig,
        UserConfig,
        ValidatorConfig,
        WorkerConfig,
    )
    from tensorlink_tpu_torch.engine import training as tt
    from tensorlink_tpu_torch.ml.module import DistributedModel
    from tensorlink_tpu_torch.nodes.runners import (
        UserNode,
        ValidatorNode,
        WorkerNode,
    )
    from tensorlink_tpu_torch.parallel.planner import (
        StagePlan,
        stage_param_specs,
    )

    root = PRODUCT_ROOT / "node"
    shutil.rmtree(root, ignore_errors=True)
    cfg = _train_cfg(PRODUCT_NODE_LAYERS, torch.float32)
    B, T = PRODUCT_NODE_BT
    rng = np.random.default_rng(PRODUCT_NODE_SEED)
    batches = [rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
               for _ in range(2)]
    common = dict(local_test=True, log_dir=str(root / "logs"),
                  env_file=str(root / ".env"))
    nodes = []
    res: dict = dict(layers=PRODUCT_NODE_LAYERS)
    try:
        with _clean_spawn():
            v = ValidatorNode(ValidatorConfig(
                endpoint=False, key_dir=str(root / "vkeys"), ml=MLConfig(),
                **common)).start()
            nodes.append(v)
            seeds = [["127.0.0.1", v.port]]
            w = WorkerNode(WorkerConfig(
                seed_validators=seeds, key_dir=str(root / "wkeys"),
                ml=MLConfig(mesh_devices=list(devices)), **common)).start()
            nodes.append(w)
            u = UserNode(UserConfig(
                seed_validators=seeds, key_dir=str(root / "ukeys"),
                ml=MLConfig(), **common)).start()
            nodes.append(u)
        deadline = time.monotonic() + 60
        while len(v.status()["peers"]) < 2:
            if time.monotonic() > deadline:
                raise AssertionError("product node: the nodes never met")
            time.sleep(0.1)
        for hint in ({"stage": 2}, {"seq": 2}):
            label = "stage" if "stage" in hint else "seq"
            model = DistributedModel(cfg, node=u, seed=PRODUCT_NODE_SEED,
                                     training=True, parallelism=hint,
                                     batch=B, seq_len=T)
            axes = model.plan.stages[0].mesh_axes
            if axes != hint:
                raise AssertionError(f"product node {label}: planned {axes}")
            rt = w.executor.jobs[model.job_id]
            if rt.mesh is None or dict(rt.mesh.shape) != hint:
                raise AssertionError(f"product node {label}: the job's mesh "
                                     f"{rt.mesh}")
            mesh = tmesh.build_mesh(hint, list(devices))
            local = tmesh.put(mesh, _seeded(cfg, "cuda", PRODUCT_NODE_SEED),
                              stage_param_specs(cfg, StagePlan(
                                  worker_id="w0", layer_lo=0,
                                  layer_hi=cfg.n_layers, first=True,
                                  last=True, holds_head=True,
                                  mesh_axes=dict(hint))))
            toks0 = torch.as_tensor(batches[0], device="cuda")
            got = torch.as_tensor(model(batches[0]), device="cuda")
            with torch.no_grad():
                want, _ = (ttr.stage_forward(
                    local, cfg, tokens=toks0, first=True, last=True,
                    seq_mesh=mesh) if label == "seq" else
                    _pipelined(local, cfg, mesh, toks0))
            fwd_rel = float((got - want).abs().max()
                            / want.abs().max())
            if fwd_rel > TRAIN_NODE_LOSS_RTOL:
                raise AssertionError(f"product node {label}: the forward "
                                     f"{fwd_rel} from in process")
            model.init_optimizer("adamw", lr=1e-3)
            ts = tt.make_train_step(cfg, tt.make_optimizer(
                "adamw", lr=1e-3, grad_clip=1.0), mesh=mesh)
            state = ts.init_state(local)
            losses, node_s = [], []
            for toks in batches:
                t0 = time.perf_counter()
                r = model.train_step(toks)
                node_s.append(time.perf_counter() - t0)
                local, state, m = ts.step_fn(local, state, {
                    "tokens": torch.as_tensor(toks, device="cuda")})
                losses.append((r["loss"], float(m["loss"])))
                if _rel(r["loss"], float(m["loss"])) > TRAIN_NODE_LOSS_RTOL:
                    raise AssertionError(f"product node {label}: losses "
                                         f"{losses}")
            res[label] = dict(axes=axes, forward_rel=fwd_rel, losses=losses,
                              node_step_s=node_s)
            model.shutdown()
            del local, state, rt
    finally:
        for nd in reversed(nodes):
            nd.stop()
        nodes = v = w = u = None
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return res


def _pipelined(params, cfg, mesh, toks):
    from tensorlink_tpu_torch.parallel.pipeline import (
        pipelined_stage_forward,
        pp_n_micro,
    )

    return pipelined_stage_forward(
        params, cfg, mesh, tokens=toks,
        n_micro=pp_n_micro(mesh.shape["stage"], toks.shape[0]), first=True,
        last=True)


def quant_tp_serving() -> dict:
    """Phase 19 step 4: qwen3-0p6b bf16 (phase 8's seeded tree at
    QTP_LAYERS layers), phase 15's 8 requests over fp pages on a tp=1
    engine and on a ``ContinuousEngine(tensor_parallel=2)`` whose config
    sets ``collective_quant`` (both shards on the one card): every gather
    of a split activation through ``quantized_all_gather`` (4 a layer per
    forward, counted; qwen3's tied head gathers nothing), greedy streams
    equal or
    parted only where tp=1's top two lie within QTP_TIE (logged), each
    chunk twice tp=1's launches of both paged kernels, no plain
    attention (``_Launches``)."""
    from tensorlink_tpu_torch.engine.optimizers import tree_map
    from tensorlink_tpu_torch.parallel import ring as tring

    cfg, params = _model()
    L = QTP_LAYERS
    cfg = cfg.with_(n_layers=L)
    params = dict(params, layers=tree_map(lambda t: t[:L], params["layers"]))
    prompts = _tp_prompts(cfg)

    def gen(c):
        return GenerationEngine(c, params, max_seq_len=4096, device="cuda")

    one, r1 = _tp_serve(1, "none", prompts, gen=gen(cfg))
    calls = []
    real = tring.quantized_all_gather

    def counted(parts, device, **kw):
        calls.append(len(parts))
        return real(parts, device, **kw)

    tring.quantized_all_gather = counted
    try:
        tp, r2 = _tp_serve(TP_DEGREE, "none", prompts,
                           gen=gen(cfg.with_(collective_quant=True)))
    finally:
        tring.quantized_all_gather = real
    # an untied head's vocabulary columns gather too; qwen3's tied head
    # makes the whole vocabulary on each shard
    want = r2["chunks"] * tp.chunk_steps * (4 * L + (not cfg.tie_embeddings))
    if len(calls) != want or set(calls) != {TP_DEGREE}:
        raise AssertionError(f"quant tp: {len(calls)} quantized gathers, "
                             f"{want} wanted")
    label = "quant tp serving fp"
    parted = _held_greedy(label, prompts, r2, r1, tie=QTP_TIE)
    for name in NEW_PATHS:
        if r2["per_chunk"][name] != TP_DEGREE * r1["per_chunk"][name]:
            raise AssertionError(f"{label}: {name} launches per chunk "
                                 f"{r2['per_chunk'][name]} vs tp=1's "
                                 f"{r1['per_chunk'][name]}")
    tp.check_page_conservation()
    top1 = [abs(a[0][0] - b[0][0]) for key, a in r2["draws"].items()
            for b in [r1["draws"].get(key)] if b and a[1][0] == b[1][0]]
    sampled = [a == b for (_i, k, _s), a, b in zip(
        prompts, r2["streams"], r1["streams"]) if k]
    one.close()
    tp.close()
    res = dict(layers=L, quantized_gathers=len(calls),
               greedy_parted=parted,
               sampled_equal=f"{sum(sampled)} of {len(sampled)}",
               top1_logit_diff_max=max(top1) if top1 else 0.0,
               tokens_per_s_tp2=r2["tokens_per_s"],
               tokens_per_s_tp1=r1["tokens_per_s"],
               ms_per_chunk_tp2=r2["ms_per_chunk"],
               ms_per_chunk_tp1=r1["ms_per_chunk"],
               launches_tp_quant=r2["launches"])
    del one, tp
    torch.cuda.empty_cache()
    return res


def product_phase() -> dict:
    """Phase 19: the stage and seq mesh axes and the quantized
    collectives (pipeline_steps, seq_steps, product_node,
    quant_tp_serving). No attention kernel runs on the training paths
    (the GPipe and the ring keep the einsum attention): 0 launches,
    asserted. The speeds are readings, not claims: the mesh's devices
    share one card."""
    t0 = time.monotonic()
    res: dict = dict(card=_smi())
    att.reset_counts()
    ref = _pp_reference()
    res["stage"] = pipeline_steps(ref)
    ref.clear()
    torch.cuda.empty_cache()
    res["seconds_stage"] = time.monotonic() - t0
    log(f"product stage: {json.dumps(res['stage'])}")
    res["seq"] = seq_steps()
    res["seconds_seq"] = time.monotonic() - t0 - res["seconds_stage"]
    log(f"product seq: {json.dumps(res['seq'])}")
    t1 = time.monotonic()
    res["node"] = product_node()
    res["seconds_node"] = time.monotonic() - t1
    launches = {n: getattr(att, n).launches for n in REPLACES}
    launches["flash_attention"] = att.flash_attention.launches
    if any(launches.values()):
        raise AssertionError(f"product: kernels launched {launches}; the "
                             "training paths have none")
    res["launches_training"] = launches
    t1 = time.monotonic()
    res["tp_quant"] = quant_tp_serving()
    res["seconds_tp_quant"] = time.monotonic() - t1
    res["seconds"] = time.monotonic() - t0
    st, sq = res["stage"], res["seq"]
    log(f"product readings ({res['card']}): stage {PP_AXES} step ms "
        f"{st['step_ms']} against unsharded {st['unsharded_step_ms']}; seq "
        f"{SP_AXES} T {SP_T} fwd+bwd ms {sq['ms']} against unsharded "
        f"{sq['unsharded_ms']}, peak bytes {sq['peak_bytes']} against "
        f"{sq['unsharded_peak_bytes']}; quant tp tokens/s "
        f"{res['tp_quant']['tokens_per_s_tp2']} against tp=1 "
        f"{res['tp_quant']['tokens_per_s_tp1']}")
    log(f"product (qwen3-0p6b: {PP_AXES} f32 {PP_LAYERS} layers B, T "
        f"{PP_BT}; "
        f"{SP_AXES} f32 {SP_LAYERS} layers B 1 T {SP_T}; tp=2 "
        f"collective_quant bf16 {QTP_LAYERS} layers; devices on one card; "
        f"readings, not claims; {res['card']}): {json.dumps(res)}")
    log(f"phase 19 took {res['seconds']:.1f} s ({res['card']})")
    return res


def pipeline_cards() -> dict:
    """Not a phase of ``main()``: it needs four cards on one host. Phase
    19 step 1 with the four stages on four distinct cards: each card's
    peak memory through the placed tree, its state and two steps beside
    the unsharded step's peak on card 0, and the step time with real
    peer copies; the losses, gradients and params held as in phase
    19."""
    from tensorlink_tpu_torch.engine.optimizers import tree_map

    n = torch.cuda.device_count()
    if n < 4:
        raise SystemExit(f"pipeline_cards: needs 4 cards, have {n}")
    cards = [torch.device("cuda", i) for i in range(4)]
    ref = _pp_reference(peak=True)
    res: dict = dict(card=_smi(), cards=n,
                     unsharded_peak_bytes_card0=ref["peak_bytes"],
                     unsharded_step_ms=ref["step_ms"])

    def host(tree):
        return tree_map(lambda t: t.cpu(), tree)

    ref["p0"], ref["params"] = host(ref["p0"]), host(ref["params"])
    ref["grads"] = [host(g) for g in ref["grads"]]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    out = pipeline_steps(ref, cards)
    torch.cuda.synchronize()
    out["peak_bytes"] = [torch.cuda.max_memory_allocated(c) for c in cards]
    out["peak_of_unsharded_card0"] = [b / ref["peak_bytes"]
                                      for b in out["peak_bytes"]]
    res["stage"] = out
    log(f"pipeline_cards (qwen3-0p6b f32 {PP_LAYERS} layers, {PP_AXES} on "
        f"four cards; readings, not claims; {res['card']} x {n}): "
        f"{json.dumps(res)}")
    return res


def seq_cards() -> dict:
    """Not a phase of ``main()``: it needs four cards on one host. Phase
    19 step 2 with the ring's four devices on four distinct cards: each
    card's peak memory through the ring step beside the unsharded step's
    (which runs on card 0), and the ring step's time with real peer
    copies; the forward and gradients held as in phase 19."""
    n = torch.cuda.device_count()
    if n < 4:
        raise SystemExit(f"seq_cards: needs 4 cards, have {n}")
    res = dict(card=_smi(), cards=n,
               seq=seq_steps([torch.device("cuda", i) for i in range(4)]))
    log(f"seq_cards (qwen3-0p6b f32 {SP_LAYERS} layers, T {SP_T}, {SP_AXES} "
        f"on four cards; readings, not claims; {res['card']} x {n}): "
        f"{json.dumps(res)}")
    return res


# -- phase 20 -----------------------------------------------------------
# tlint: disable=TL006(read-only table)
COSLICE_LAYOUTS = {"fsdp2-tensor2": {"fsdp": 2, "tensor": 2},
                   "tensor4": {"tensor": 4}}
COSLICE_LAYERS = 8  # of 28: the depth the time budget allows
COSLICE_BT = (4, 128)
COSLICE_STEPS = 2
COSLICE_SEED = 2020
# each member's mesh devices: both members on the one card (gloo)
COSLICE_MEMBER_DEVICES = (("cuda:0", "cuda:0"), ("cuda:0", "cuda:0"))
COSLICE_NODE_LAYERS = 2  # the node path's depth: its logits and its
COSLICE_NODE_BT = (2, 32)  # checkpoint cross the host
COSLICE_NODE_STEPS = 3
COSLICE_NODE_SEED = 2021
COSLICE_ROOT = Path(__file__).resolve().parent / "build" / "coslice"
COSLICE_TIMEOUT = 600.0  # seconds a member process may take
LAUNCH_NAMES = (*REPLACES, "flash_attention")

# a member process of phase 20's direct steps (not the parent: CUDA is
# first touched after the join)
_COSLICE_MEMBER = """
import sys
sys.path.insert(0, {repo!r})
import chip_smoke
chip_smoke._coslice_member({rank}, {coord!r}, {work!r})
"""

# a worker process of phase 20's node path: a WorkerNode whose two mesh
# devices join the other worker's in one group
_COSLICE_WORKER = """
import json, sys, time
sys.path.insert(0, {repo!r})


def main():
    import signal
    import threading

    import torch

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tensorlink_tpu_torch.core.config import MLConfig, WorkerConfig
    from tensorlink_tpu_torch.nodes.runners import WorkerNode
    from tensorlink_tpu_torch.ops import attention as att

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    node = WorkerNode(WorkerConfig(
        local_test=True, key_dir={keys!r}, log_dir={logs!r},
        env_file={env!r}, seed_validators=[["127.0.0.1", {vport}]],
        ml=MLConfig(device={device!r}, mesh_devices={devices!r},
                    slice_id="chip-slice:0", coordinator_address={coord!r},
                    num_processes=2, process_id={rank}, dtype="float32"),
    )).start()
    att.reset_counts()  # this process's launches: the job's alone
    print("WORKER_READY", flush=True)
    while not stop.wait(1.0):
        pass
    with open({counts!r}, "w") as f:
        json.dump({{n: getattr(att, n).launches for n in {names!r}}}, f)
    node.stop()  # its network process too


if __name__ == "__main__":
    main()
"""


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch_counts() -> dict:
    """This process's attention-kernel launches since the last
    ``att.reset_counts()``, by kernel."""
    return {n: getattr(att, n).launches for n in LAUNCH_NAMES}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _digests(tree, mesh, positions) -> dict:
    """Each of ``positions``' pieces of a placed tree as one SHA-256 over
    its leaves' bytes, in the tree's order (the bits of what the position
    holds)."""
    import hashlib

    from tensorlink_tpu_torch.engine.optimizers import tree_leaves

    out = {}
    for j in positions:
        h = hashlib.sha256()
        for leaf in tree_leaves(tree):
            h.update(leaf.shards[j].detach().cpu().contiguous().numpy()
                     .tobytes())
        out[str(j)] = h.hexdigest()
    return out


def _coslice_steps(spec: dict, devices, dev, peaks=()) -> dict:
    """Phase 20's direct steps over ``devices`` (one process's list of a
    mesh, or the global list of a group), the weights and batches made on
    ``dev``: per layout, the seeded tree placed by ``partition_specs``,
    COSLICE_STEPS placed AdamW steps (``make_train_step(mesh=)``), each
    step's loss and gradient norm (as float hex), wall ms and the bytes
    this process sent, the digest of every position this process holds
    after the last step, and the peak bytes of each card of ``peaks``."""
    from tensorlink_tpu_torch.engine import training as tt
    from tensorlink_tpu_torch.models.base import ModelConfig
    from tensorlink_tpu_torch.parallel import multihost

    cfg = ModelConfig.from_json(spec["cfg"])
    B, T = spec["bt"]
    rng = np.random.default_rng(spec["seed"])
    batches = [{"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32), device=dev)}
        for _ in range(spec["steps"])]
    p0 = _seeded(cfg, dev, spec["seed"])
    out: dict = {}
    for name, axes in spec["layouts"].items():
        mesh = tmesh.build_mesh(axes, list(devices))
        placed = tmesh.put(mesh, p0, ttr.partition_specs(
            cfg, tensor_axis="tensor",
            fsdp_axis="fsdp" if "fsdp" in axes else None))
        ts = tt.make_train_step(cfg, tt.make_optimizer(
            "adamw", lr=1e-3, grad_clip=1.0), n_micro=1, remat=True,
            mesh=mesh)
        p, st = placed, ts.init_state(placed)
        steps = []
        for b in batches:
            sent = multihost.EXCHANGED["sent"]
            _sync(dev)
            t0 = time.perf_counter()
            p, st, m = ts.step_fn(p, st, b)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            _sync(dev)
            steps.append(dict(loss=loss.hex(), grad_norm=gnorm.hex(),
                              ms=(time.perf_counter() - t0) * 1e3,
                              sent_bytes=multihost.EXCHANGED["sent"] - sent))
        out[name] = dict(steps=steps, digests=_digests(
            p, mesh, [j for j in range(mesh.size) if mesh.is_local(j)]))
        del p, st, placed
        out[name]["peak_bytes"] = {
            str(d): torch.cuda.max_memory_allocated(d) for d in peaks}
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    return out


def _coslice_member(rank: int, coord: str, work: str) -> None:
    """A member process of phase 20's direct steps: join the group (gloo
    over two ranks on one card, NCCL over distinct cards, decided at the
    join), wait for the parent's ``go``, run :func:`_coslice_steps` over
    the global device list, and write what it read to
    ``member<rank>.json``."""
    from tensorlink_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = Path(work)
    spec = json.loads((work / "spec.json").read_text())
    if not multihost.maybe_initialize(coord, 2, rank,
                                      devices=spec["members"][rank]):
        raise SystemExit("coslice member: the group was not joined")
    devs = multihost.global_devices()
    mine = [torch.device(d) for d in spec["members"][rank]]
    cards = [d for d in dict.fromkeys(mine) if d.type == "cuda"]
    deadline = time.monotonic() + COSLICE_TIMEOUT
    while not (work / "go").exists():
        if time.monotonic() > deadline:
            raise SystemExit("coslice member: no go")
        time.sleep(0.05)
    res = dict(rank=rank, backend=multihost.backend(),
               global_devices=[[d.rank, str(d.device)] for d in devs])
    att.reset_counts()
    res["layouts"] = _coslice_steps(spec, devs, mine[0], peaks=cards)
    res["launches"] = _launch_counts()
    multihost.shutdown()
    (work / f"member{rank}.json").write_text(json.dumps(res))


def coslice_start(members=COSLICE_MEMBER_DEVICES) -> dict:
    """Start phase 20 step 1's two member processes (``members``: each
    one's two mesh devices): they import and join while this process
    runs its one-process steps, then wait for :func:`coslice_steps`'s
    ``go``. Returns the handle :func:`coslice_steps` and
    :func:`coslice_stop` take."""
    root = COSLICE_ROOT / "steps"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cfg = _train_cfg(COSLICE_LAYERS, torch.float32)
    spec = dict(cfg=cfg.to_json(), bt=list(COSLICE_BT),
                seed=COSLICE_SEED, steps=COSLICE_STEPS,
                layouts=COSLICE_LAYOUTS, members=[list(m) for m in members])
    (root / "spec.json").write_text(json.dumps(spec))
    coord = f"127.0.0.1:{_free_port()}"
    repo = str(Path(__file__).resolve().parent)
    pre = dict(root=root, spec=spec, members=members, procs=[], logs=[])
    for r in range(2):
        pre["logs"].append(open(root / f"member{r}.log", "w"))
        pre["procs"].append(subprocess.Popen(
            [sys.executable, "-c", _COSLICE_MEMBER.format(
                repo=repo, rank=r, coord=coord, work=str(root))],
            cwd=repo, stdout=pre["logs"][-1], stderr=subprocess.STDOUT))
    return pre


def coslice_stop(pre: dict) -> None:
    """Stop what :func:`coslice_start` started (idempotent)."""
    for p in pre["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in pre["logs"]:
        f.close()


def coslice_steps(pre: dict | None = None) -> dict:
    """Phase 20 step 1: two member processes (:func:`coslice_start`),
    each holding two positions of a four-position mesh, run the direct
    placed steps (:func:`_coslice_steps`) on ``{fsdp: 2, tensor: 2}`` and
    ``{tensor: 4}``; this process runs the same steps with the mesh's four
    positions its own first. Held: each member's losses and gradient
    norms bitwise equal to the other's and to this process's, and each
    position's params after the last step (SHA-256 of its pieces) bitwise
    this process's; the backend is gloo for two ranks on one card, NCCL
    when each rank's cards are its own. Readings: each step's ms beside
    the one-process step's (a member's first step includes its cold
    start), the bytes each member sent a step, each member's peak
    bytes. Each member counts its own kernel launches over its steps;
    the training path has none (asserted)."""
    pre = pre or coslice_start()
    root, spec, members = pre["root"], pre["spec"], pre["members"]
    procs = pre["procs"]
    flat = [d for m in members for d in m]
    res: dict = dict(card=_smi(), layers=COSLICE_LAYERS, bt=COSLICE_BT,
                     members=[list(m) for m in members])
    try:
        one = _coslice_steps(spec, flat, flat[0])
        if torch.device(flat[0]).type == "cuda":
            torch.cuda.empty_cache()
        (root / "go").write_text("")
        for p in procs:
            p.wait(timeout=COSLICE_TIMEOUT)
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise AssertionError(
                    f"coslice member {r} exited {p.returncode}: "
                    + (root / f"member{r}.log").read_text()[-3000:])
        got = [json.loads((root / f"member{r}.json").read_text())
               for r in range(2)]
    finally:
        coslice_stop(pre)
    want_backend = "nccl" if len({d for m in members for d in m}) == len(
        flat) else "gloo"
    res["launches_members"] = [g["launches"] for g in got]
    for g in got:
        if any(g["launches"].values()):
            raise AssertionError(f"coslice: member {g['rank']} launched "
                                 f"{g['launches']}; the training path has "
                                 "none")
        if g["backend"] != want_backend:
            raise AssertionError(f"coslice: member {g['rank']} joined over "
                                 f"{g['backend']}, not {want_backend}")
        if g["global_devices"] != [[r, str(torch.device(d))]
                                   for r, m in enumerate(members)
                                   for d in m]:
            raise AssertionError(f"coslice: global devices "
                                 f"{g['global_devices']}")
    for name in COSLICE_LAYOUTS:
        ref = one[name]
        for g in got:
            mine = g["layouts"][name]
            for a, b in zip(mine["steps"], ref["steps"], strict=True):
                if (a["loss"], a["grad_norm"]) != (b["loss"],
                                                   b["grad_norm"]):
                    raise AssertionError(
                        f"coslice {name}: member {g['rank']}'s step "
                        f"{a} is not one process's {b}")
            for j, d in mine["digests"].items():
                if ref["digests"][j] != d:
                    raise AssertionError(
                        f"coslice {name}: member {g['rank']}'s position "
                        f"{j} params differ from one process's")
        held = sorted(j for g in got for j in g["layouts"][name]["digests"])
        if held != sorted(ref["digests"]):
            raise AssertionError(f"coslice {name}: the members hold "
                                 f"positions {held}")
        res[name] = dict(
            losses=[float.fromhex(s["loss"]) for s in ref["steps"]],
            one_process_step_ms=[s["ms"] for s in ref["steps"]],
            member_step_ms=[[s["ms"] for s in g["layouts"][name]["steps"]]
                            for g in got],
            member_sent_bytes=[[s["sent_bytes"] for s in
                                g["layouts"][name]["steps"]] for g in got],
            member_peak_bytes=[g["layouts"][name].get("peak_bytes")
                               for g in got],
            bitwise=True)
    res["backend"] = want_backend
    return res


class _InProcessWorker:
    """A user node's stand-in that hands each request to a bare port
    worker in this process: the reference driver of phase 20's node
    path."""

    def __init__(self, devices):
        import types

        from tensorlink_tpu_torch.core.config import MLConfig, WorkerConfig
        from tensorlink_tpu_torch.ml.worker import DistributedWorker

        class Bridge:
            def __init__(self):
                self.sent = []

            def request(self, verb, payload=None, timeout=None):
                self.sent.append((verb, payload))

            notify = request

        node = types.SimpleNamespace(
            bridge=Bridge(), node_id="in-process",
            config=WorkerConfig(ml=MLConfig(device=devices[0],
                                            mesh_devices=list(devices))),
            crash=lambda: None)
        self.w = DistributedWorker(node)

    def connect_to(self, host, port):
        return "in-process"

    def send_request(self, verb, payload=None, timeout=None):
        from tensorlink_tpu_torch.p2p import protocol as proto

        tag = payload["tag"]
        kind = "load_stage" if tag == proto.MODULE else tag
        n = len(self.w.bridge.sent)
        self.w._handle(kind, {"rid": "r", "peer": "p", **payload["body"]})
        [(_, sent)] = self.w.bridge.sent[n:]
        return sent["body"]


def coslice_node(members=COSLICE_MEMBER_DEVICES, device="cuda:0",
                 during=None) -> dict:
    """Phase 20 step 2: a validator with ``co_slice_planning``, two worker
    processes advertising one slice (each ``MLConfig(mesh_devices=...)``
    two positions, joined in one group at start) and a user. A
    DistributedModel of qwen3-0p6b's widths at COSLICE_NODE_LAYERS layers,
    f32, is planned one merged stage with one coworker over four devices;
    its eval forward and COSLICE_NODE_STEPS AdamW steps (one batch) are
    bitwise the same driver's over a bare worker in this process whose
    mesh holds the four positions (the loss falls); a checkpoint saved by
    the primary and restored by both members gives the same logits
    bitwise; ``generate`` is refused ("co-slice"); each worker process
    counts its own kernel launches, none (asserted). ``during()`` runs
    while the worker processes start (phase 20 runs its step 1 there)."""
    import json as _json

    from tensorlink_tpu_torch.core.config import (
        MLConfig,
        UserConfig,
        ValidatorConfig,
    )
    from tensorlink_tpu_torch.ml.module import DistributedModel
    from tensorlink_tpu_torch.nodes.runners import UserNode, ValidatorNode

    root = COSLICE_ROOT / "node"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cfg = _train_cfg(COSLICE_NODE_LAYERS, torch.float32)
    B, T = COSLICE_NODE_BT
    batch = np.random.default_rng(COSLICE_NODE_SEED).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)
    common = dict(local_test=True, log_dir=str(root / "logs"),
                  env_file=str(root / ".env"))
    repo = str(Path(__file__).resolve().parent)
    res: dict = dict(card=_smi(), layers=COSLICE_NODE_LAYERS,
                     bt=COSLICE_NODE_BT)
    nodes, procs, logs, model = [], [], [], None
    try:
        with _clean_spawn():
            v = ValidatorNode(ValidatorConfig(
                endpoint=False, key_dir=str(root / "vkeys"),
                ml=MLConfig(co_slice_planning=True), **common)).start()
            nodes.append(v)
        coord = f"127.0.0.1:{_free_port()}"
        t0 = time.monotonic()
        for r, devs in enumerate(members):
            logs.append(open(root / f"worker{r}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _COSLICE_WORKER.format(
                    repo=repo, keys=str(root / f"wkeys{r}"),
                    logs=str(root / f"wlogs{r}"), env=str(root / f".wenv{r}"),
                    vport=v.port, device=devs[0], devices=list(devs),
                    coord=coord, rank=r,
                    counts=str(root / f"worker{r}.launches.json"),
                    names=list(LAUNCH_NAMES))],
                cwd=repo, stdout=logs[-1], stderr=subprocess.STDOUT))
        if during is not None:
            during()
        deadline = time.monotonic() + COSLICE_TIMEOUT
        while True:
            stats = v.send_request("stats_workers", timeout=15.0)
            if len(stats) == 2 and all(s.get("slice_id") == "chip-slice:0"
                                       for s in stats):
                break
            for r, p in enumerate(procs):
                if p.poll() is not None:
                    raise AssertionError(
                        f"coslice worker {r} exited {p.returncode}: "
                        + (root / f"worker{r}.log").read_text()[-3000:])
            if time.monotonic() > deadline:
                raise AssertionError(f"coslice node: workers {stats}")
            time.sleep(0.25)
        res["workers_up_s"] = time.monotonic() - t0
        t1 = time.monotonic()
        with _clean_spawn():
            u = UserNode(UserConfig(
                seed_validators=[["127.0.0.1", v.port]],
                key_dir=str(root / "ukeys"), ml=MLConfig(),
                **common)).start()
            nodes.append(u)
        model = DistributedModel(cfg, node=u, seed=COSLICE_NODE_SEED,
                                 training=True, batch=B, seq_len=T,
                                 device=device)
        st = model.plan.stages
        n_dev = int(np.prod(list(st[0].mesh_axes.values())))
        if len(st) != 1 or len(st[0].coworkers) != 1 or n_dev != 4:
            raise AssertionError(f"coslice node: planned {model.plan}")
        res["mesh_axes"] = dict(st[0].mesh_axes)
        plan = _json.loads(_json.dumps(model.plan.to_json()))
        plan["stages"][0]["coworkers"] = []
        ref = DistributedModel(
            cfg, node=_InProcessWorker([d for m in members for d in m]),
            training=True, batch=B, seq_len=T, start_session=False,
            device=device)
        ref._attach({"job_id": model.job_id, "plan": plan,
                     "model": model.model_spec,
                     "workers": {plan["stages"][0]["worker_id"]:
                                 ["127.0.0.1", 1]}})
        toks = batch[:1, :16]
        got, want = model(toks), ref(toks)
        if not torch.equal(got, want):
            raise AssertionError("coslice node: the merged forward is not "
                                 "the in-process one")
        model.init_optimizer("adamw", lr=5e-3)
        ref.init_optimizer("adamw", lr=5e-3)
        steps, step_s = [], []
        for _ in range(COSLICE_NODE_STEPS):
            t0 = time.perf_counter()
            g = model.train_step(batch)
            step_s.append(time.perf_counter() - t0)
            w = ref.train_step(batch)
            steps.append((g["loss"], g["grad_norm"]))
            if (g["loss"], g["grad_norm"]) != (w["loss"], w["grad_norm"]):
                raise AssertionError(f"coslice node: step {g} is not the "
                                     f"in-process step {w}")
        if not steps[-1][0] < steps[0][0]:
            raise AssertionError(f"coslice node: losses {steps}")
        res.update(losses=steps, node_step_s=step_s)
        before = model(toks)
        t0 = time.perf_counter()
        paths = model.save_checkpoint(str(root / "ckpt"))["paths"]
        model.restore_checkpoint(str(root / "ckpt"))
        res["checkpoint_s"] = time.perf_counter() - t0
        if len(paths) != 1 or not torch.equal(model(toks), before):
            raise AssertionError("coslice node: the checkpoint round trip "
                                 "changed the logits")
        try:
            model.generate([[1, 2, 3]], max_new_tokens=2)
        except RuntimeError as e:
            if "co-slice" not in str(e):
                raise
        else:
            raise AssertionError("coslice node: generate was not refused")
        model.shutdown()
        model = None
        res["job_s"] = time.monotonic() - t1
    finally:
        t1 = time.monotonic()
        if model is not None:
            try:
                model.shutdown()
            # tlint: disable=TL005(the phase already failed; its error is raised)
            except Exception:  # noqa: BLE001
                pass
        for nd in reversed(nodes):  # the user and validator first: the
            nd.stop()  # workers' network processes then stop at once
        for p in procs:  # each stops its network process on SIGTERM
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        counted = [root / f"worker{r}.launches.json"
                   for r in range(len(procs))]
        workers = [json.loads(c.read_text()) if c.exists() else None
                   for c in counted]
        shutil.rmtree(root, ignore_errors=True)
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        res["teardown_s"] = time.monotonic() - t1
    # each worker process counted its own launches, from its start to its
    # stop: the job's alone
    if len(workers) != len(members) or None in workers:
        raise AssertionError(f"coslice node: worker launch counts {workers}")
    if any(any(w.values()) for w in workers):
        raise AssertionError(f"coslice node: the workers launched {workers}; "
                             "the training path has none")
    res["launches_workers"] = workers
    return res


def coslice_phase() -> dict:
    """Phase 20: qwen3-0p6b trains on one placed mesh spanning two member
    processes joined by torch.distributed (parallel/multihost.py), both on
    the one card over gloo: coslice_steps, then coslice_node. No
    attention kernel runs (the training forward keeps the einsum
    attention): the spanning runs' launches are counted in the processes
    that run them (the two members, the two workers) and are 0,
    asserted; this process's reference runs are counted apart. The
    speeds are readings, not claims."""
    t0 = time.monotonic()
    att.reset_counts()
    res: dict = dict(card=_smi())

    def steps():  # while the node path's workers start
        res["steps"] = coslice_steps()
        res["seconds_steps"] = time.monotonic() - t0
        log(f"coslice steps: {json.dumps(res['steps'])}")

    res["node"] = coslice_node(during=steps)
    reference = _launch_counts()
    if any(reference.values()):
        raise AssertionError(f"coslice: the reference runs launched "
                             f"{reference}; the training path has none")
    spanning = (res["steps"]["launches_members"]
                + res["node"]["launches_workers"])
    res["launches"] = {n: sum(c[n] for c in spanning) for n in LAUNCH_NAMES}
    res["launches_by_process"] = dict(
        members=res["steps"]["launches_members"],
        workers=res["node"]["launches_workers"])
    res["launches_reference"] = reference
    res["seconds"] = time.monotonic() - t0
    st = res["steps"]
    log(f"coslice readings ({res['card']}): backend {st['backend']}; "
        + "; ".join(f"{n} step ms two processes {st[n]['member_step_ms']} "
                    f"against one {st[n]['one_process_step_ms']}, bytes "
                    f"sent a step {st[n]['member_sent_bytes']}"
                    for n in COSLICE_LAYOUTS)
        + f"; node path {res['node']['mesh_axes']} step s "
        f"{res['node']['node_step_s']}; kernel launches of the spanning "
        f"runs {res['launches_by_process']}, of this process's reference "
        f"runs {reference}")
    log(f"coslice (qwen3-0p6b f32, {COSLICE_LAYERS} layers, B, T "
        f"{COSLICE_BT}, n_micro 1, AdamW; node path {COSLICE_NODE_LAYERS} "
        f"layers, B, T {COSLICE_NODE_BT}; two processes on one card; "
        f"readings, not claims; {res['card']}): {json.dumps(res)}")
    log(f"phase 20 took {res['seconds']:.1f} s ({res['card']})")
    return res


def coslice_cards() -> dict:
    """Not a phase of ``main()``: it needs four cards on one host. Phase
    20 step 1 over two processes x two cards, each member's cards its own,
    so the group runs over NCCL: held bitwise against one process over
    the four cards, with each card's peak memory (read by the member that
    drives it) and the step ms."""
    n = torch.cuda.device_count()
    if n < 4:
        raise SystemExit(f"coslice_cards: needs 4 cards, have {n}")
    res = dict(card=_smi(), cards=n, steps=coslice_steps(coslice_start(
        members=(("cuda:0", "cuda:1"), ("cuda:2", "cuda:3")))))
    log(f"coslice_cards (qwen3-0p6b f32 {COSLICE_LAYERS} layers, two "
        f"processes x two cards over {res['steps']['backend']}; readings, "
        f"not claims; {res['card']} x {n}): {json.dumps(res)}")
    return res


# -- phase 21: the slot engine over a tree placed on a planned mesh -------
# tlint: disable=TL006(read-only constant table — never mutated)
PLACED_LAYOUTS = {"tensor4": {"tensor": 4},
                  "fsdp2-tensor2": {"fsdp": 2, "tensor": 2}}
PLACED_DEVICES = ("cuda:0",) * 4  # every position on the one card
PLACED_LAYERS = 28  # qwen3-0p6b at full depth
PLACED_NEW = 32  # new tokens per request
PLACED_SEQ = 2048  # the engines' positions: phase 15's prompts fit
# (layout, page format, spec decoding): fp, int8 and spec on {tensor: 4},
# fp on {fsdp: 2, tensor: 2}; the unsharded reference runs once a format,
# spec off
PLACED_RUNS = (("tensor4", "none", False), ("tensor4", "int8", False),
               ("tensor4", "none", True), ("fsdp2-tensor2", "none", False))
# the placed engine's pages against the unsharded engine's, per layer
# (the largest |diff| over the pages both tries hold for one token chain,
# over the layer's largest |value|): at most this multiple of the
# unsharded bf16 engine's distance from a float32 engine's on the same
# tree, plus one int8 level over int8 pages. The Megatron rows (wo,
# w_down) sum partial products in another order than the whole product,
# which moves the residual stream and every later layer's K and V by
# bf16 rounding, as bf16 itself moves them from float32 (phase 16's rule
# for the same layout's logits is 2x; a CPU rehearsal at tiny widths read
# up to 2.09x with four partial sums, so 3x)
PLACED_PAGE_OF_BF16 = 3.0
# tlint: disable=TL006(read-only constant table — never mutated)
PLACED_MOE_AXES = {"expert": 4}
PLACED_MOE_SEED = 2122
PLACED_NODE_LAYERS = 4  # the node job's depth: its start-up is the cost
# tlint: disable=TL006(read-only constant table — never mutated)
PLACED_NODE_HINT = {"tensor": 2, "fsdp": 2}
PLACED_NODE_SEED = 2121
PLACED_NODE_REQUESTS = 3  # continuous GENERATEs, one after another
PLACED_ROOT = Path(__file__).resolve().parent / "build" / "placed"


def _page_drift(got, want) -> dict:
    """Per layer, the largest |diff| between the pages of engine ``got``
    and engine ``want`` over every token chain both tries hold
    (dequantized; a sharded cache's shards joined by kv head), over the
    largest |value| of ``want``'s pages of that layer."""
    by_hash = {n.key_hash: n for n in got.prefix._by_page.values()}
    hd = want.cfg.head_dim
    diff = torch.zeros(want.cfg.n_layers, dtype=torch.float64)
    scale = torch.zeros_like(diff)
    n, same = 0, 0
    for node in want.prefix._by_page.values():
        other = by_hash.get(node.key_hash)
        if other is None or other.depth != node.depth:
            continue
        a = _dequantized(got.cache.fields(), other.page, hd)
        b = _dequantized(want.cache.fields(), node.page, hd)
        for x, y in zip(a, b):
            d = (x.double() - y.double().to(x.device)).abs().flatten(1)
            diff = torch.maximum(diff, d.amax(1).cpu())
            scale = torch.maximum(scale, y.double().abs().flatten(1)
                                  .amax(1).cpu())
        n += 1
        same += all(torch.equal(x, y.to(x.device)) for x, y in zip(a, b))
    if n == 0:
        raise AssertionError("placed: the two engines share no trie chain")
    return dict(chains=n, chains_bitwise=same,
                by_layer=(diff / scale.clamp_min(1e-30)).tolist())


def _placed_tree(cfg, params, axes: dict, devices):
    """``params`` placed by ``stage_param_specs`` on ``axes`` over
    ``devices`` (None: the distinct local cards), as a worker places a
    one-stage job on its planned mesh."""
    from tensorlink_tpu_torch.parallel.planner import (
        StagePlan,
        stage_param_specs,
    )

    mesh = tmesh.build_mesh(axes, list(devices) if devices else None)
    stage = StagePlan(worker_id="w0", layer_lo=0, layer_hi=cfg.n_layers,
                      first=True, last=True, holds_head=True,
                      mesh_axes=dict(axes))
    return mesh, tmesh.put(mesh, params, stage_param_specs(cfg, stage))


def _placed_gen(cfg, params, axes: dict, devices, **kw):
    """A GenerationEngine over the placed tree, built as the worker
    builds a planned-mesh job's (its dense cache over the same mesh)."""
    mesh, placed = _placed_tree(cfg, params, axes, devices)
    tp = axes.get("tensor", 1)
    return GenerationEngine(
        cfg, placed, mesh=mesh, device="cuda",
        cache_specs=ttr.cache_specs(
            cfg, data_axis=None, tensor_axis="tensor" if tp > 1 else None),
        **kw)


def _position_kv_bytes(ce) -> list:
    """KV bytes per token each position of the placed mesh holds: its
    shard of the pages (the first group's tensor positions), else 0."""
    from tensorlink_tpu_torch.models.sharded import _Placed

    pl = _Placed(ce.engine.params, ce.cfg)
    c = ce.cache
    per = [0] * pl.mesh.size
    for s, j in enumerate(pl.groups[0] if c.tp > 1 else [0]):
        for f in c.fields():
            x = f.shards[s] if isinstance(f, tmesh.Sharded) else f
            per[j] += x.numel() * x.element_size()
    return [b // (c.n_pages * c.page_size) for b in per]


def _placed_layout(ce, axes: dict, fmt: str, whole: int | None = None
                   ) -> dict:
    """The placed engine's pages: split in ``tensor`` contiguous shards of
    n_kv / tensor kv heads on the first group's devices, the control
    tensors whole on the mesh's first device; each position's KV bytes
    per token the whole's (``whole``, default qwen3-0p6b's from
    KV_BYTES_PER_TOKEN) over ``tensor`` (0 off the first group), and the
    snapshot's page bytes the whole engine's."""
    from tensorlink_tpu_torch.models.sharded import _Placed

    c, cfg = ce.cache, ce.cfg
    tp = axes.get("tensor", 1)
    pl = _Placed(ce.engine.params, cfg)
    group = pl.lays[0].devices
    if c.tp != tp:
        raise AssertionError(f"placed: pages split {c.tp} ways on {axes}")
    for f in c.fields():
        shards = f.shards if isinstance(f, tmesh.Sharded) else [f]
        if [s.device for s in shards] != group[:len(shards)]:
            raise AssertionError(f"placed: pages on "
                                 f"{[str(s.device) for s in shards]}")
        for s in shards:
            if s.shape[2] != cfg.n_kv_heads // tp or not s.is_contiguous():
                raise AssertionError(f"placed: shard {tuple(s.shape)}")
    if isinstance(c.block_tables, tmesh.Sharded) \
            or c.block_tables.device != group[0]:
        raise AssertionError("placed: control state is not whole on the "
                             "mesh's first device")
    if whole is None:
        whole = _at_depth(KV_BYTES_PER_TOKEN, fmt, cfg.n_layers)
    per = _position_kv_bytes(ce)
    want = [whole // tp if j in pl.groups[0] else 0
            for j in range(len(per))]
    if per != want:
        raise AssertionError(f"placed: KV bytes per token by position "
                             f"{per}, not {want}")
    snap = ce.serving_snapshot()
    if snap["kv_page_bytes"] // c.page_size != whole:
        raise AssertionError(f"placed: {snap['kv_page_bytes']} page bytes")
    return dict(kv_bytes_per_token_by_position=per,
                kv_bytes_per_token=whole)


def placed_kernel_check(model=None, label: str = "placed kernels") -> dict:
    """One ragged chunk over MAIN's block and one decode step after it,
    through the placed step's forward (``paged._PlacedFwd``) over
    qwen3-0p6b bf16 at full width and MODEL_LAYERS layers (or ``model``,
    a ``(cfg, params)``) placed on {tensor: 4} over cuda:0, fp pages of
    seeded random context: every shard's launch of each kernel (qwen3:
    n_kv / 4 = 2 kv heads, 4 query heads, a shape no other phase
    launches) bitwise equal to the same heads of one launch over the four
    shards' heads joined on the same inputs, and within the bf16 bound of
    its plain version."""
    cfg, params = model or _model()
    dev = torch.device("cuda")
    S, C, page = MAIN["S"], MAIN["C"], MAIN["page"]
    whole = PagedKVCache.init(cfg, S, page_size=page,
                              max_len=MAIN["n_pp"] * page, device=dev)
    n_pp = whole.pages_per_slot
    rng = np.random.default_rng(21)
    perm = rng.permutation(np.arange(1, whole.n_pages))[: S * n_pp]
    whole.block_tables.copy_(torch.from_numpy(
        perm.reshape(S, n_pp).astype(np.int32)))
    gk = torch.Generator(device=dev)
    gk.manual_seed(211)
    whole.k.normal_(generator=gk)
    whole.v.normal_(generator=gk)
    _, placed = _placed_tree(cfg, params, PLACED_LAYOUTS["tensor4"],
                             PLACED_DEVICES)
    fwd = paged._PlacedFwd(placed, cfg, True)
    _, cmesh = paged.placed_cache_mesh(placed, cfg)
    split = tmesh.Split(2)
    pc = PagedKVCache(
        k=tmesh.put(cmesh, whole.k, split), v=tmesh.put(cmesh, whole.v, split),
        block_tables=whole.block_tables.clone(),
        lengths=whole.lengths.clone())
    del whole
    tp = pc.tp
    blk = torch.tensor(rng.integers(0, cfg.vocab_size, size=(S, C)),
                       dtype=torch.int32, device=dev)
    starts, nv = (torch.tensor(a, dtype=torch.int32, device=dev)
                  for a in (MAIN_STARTS, MAIN_NVALID))
    wp, wo, pos, _ = paged._ragged_write_indices(pc.block_tables, starts,
                                                 nv, page, n_pp, C)
    ragged_r, decode_r = {}, {}
    real_r, real_d = paged.ragged_paged_attention, paged.paged_attention
    paged.ragged_paged_attention = _shard_checker(
        real_r, att.ragged_paged_attention_ref, att.ragged_paged_attention,
        tp, ragged_r)
    paged.paged_attention = _shard_checker(
        real_d, att.paged_attention_ref, att.paged_attention, tp, decode_r)
    try:
        x = fwd.ragged(blk, pc, starts, nv, wp, wo, pos)
        lens = [st + n for st, n in zip(MAIN_STARTS, MAIN_NVALID)]
        pc.lengths.copy_(torch.tensor(lens, dtype=torch.int32))
        tok = torch.tensor(rng.integers(0, cfg.vocab_size, size=S),
                           dtype=torch.int32, device=dev)
        logits, _ = fwd.decode(tok, pc, pc.lengths > 0)
    finally:
        paged.ragged_paged_attention = real_r
        paged.paged_attention = real_d
    torch.cuda.synchronize()
    L = cfg.n_layers
    for name, r in (("ragged", ragged_r), ("decode", decode_r)):
        if r.get("layers") != L or r.get("unequal") or r["plain"] > 1.0:
            raise AssertionError(f"{label}: {name} over {tp} shards: {r}")
    if not torch.isfinite(logits).all() or not all(
            torch.isfinite(t).all() for t in x.values()):
        raise AssertionError(f"{label}: not finite")
    del pc, placed, fwd
    torch.cuda.empty_cache()
    return dict(shards=tp, layers=L, kv_heads_per_shard=cfg.n_kv_heads // tp,
                q_heads_per_shard=cfg.n_heads // tp,
                ragged_of_bound=ragged_r["plain"],
                decode_of_bound=decode_r["plain"],
                ragged_shard_bitwise=True, decode_shard_bitwise=True)


def placed_serving(devices=PLACED_DEVICES, runs=PLACED_RUNS) -> dict:
    """qwen3-0p6b bf16 at full width and PLACED_LAYERS layers through the
    slot engine over a tree placed by stage_param_specs (``runs``),
    each run held against the unsharded slot engine over the same weights
    and page format (spec off): phase 15's 8 requests x PLACED_NEW tokens
    (3 sampled, 2 repetitive ones that speculate where spec is on),
    greedy streams equal or parted only where the unsharded run's top-two
    gap is within MESH_TIE (logged); per chunk, tensor x the unsharded
    engine's launches of each kernel (each shard's launch counted), no
    plain version; the pages both engines' tries hold, per layer, within
    PLACED_PAGE_OF_BF16 x the unsharded engine's distance from a float32
    engine's (fp pages, the same requests; one int8 level more over int8
    pages); the pages' layout and each position's KV bytes per token.
    Readings: tokens/s and ms per chunk beside the unsharded engine's."""
    cfg, params = _model(PLACED_LAYERS)
    prompts = _tp_prompts(cfg)
    refs = {}
    for kv_quant in sorted({kv for _l, kv, _s in runs} | {"none"}):
        one = _cont(GenerationEngine(cfg, params, max_seq_len=PLACED_SEQ,
                                     device="cuda"), kv_quant=kv_quant)
        refs[kv_quant] = one, _drawn_serve(
            one, f"placed reference {_fmt(kv_quant)}", prompts, PLACED_NEW)
    f32 = _cont(GenerationEngine(cfg.with_(dtype=torch.float32),
                                 _cast_tree(params), max_seq_len=PLACED_SEQ,
                                 device="cuda"))
    f32_run = _drawn_serve(f32, "placed reference f32", prompts, PLACED_NEW)
    bf16_drift = _page_drift(refs["none"][0], f32)
    f32.close()
    del f32
    torch.cuda.empty_cache()
    res: dict = dict(card=_smi(), layers=cfg.n_layers, requests=len(prompts),
                     new_tokens=PLACED_NEW, unsharded={
                         _fmt(kv): dict(tokens_per_s=r["tokens_per_s"],
                                        ms_per_chunk=r["ms_per_chunk"],
                                        chunks=r["chunks"],
                                        launches_per_chunk=r["per_chunk"])
                         for kv, (_o, r) in refs.items()})
    launches = {}
    for name, kv_quant, spec in runs:
        axes = PLACED_LAYOUTS[name]
        fmt = _fmt(kv_quant)
        label = f"placed {name} {fmt}" + (" spec" if spec else "")
        gen = _placed_gen(cfg, params, axes, devices,
                          max_seq_len=PLACED_SEQ)
        ce = _cont(gen, kv_quant=kv_quant, spec_decode=spec, spec_draft=8)
        if ce._mesh is None or ce._mesh.shape != axes:
            raise AssertionError(f"{label}: not the placed step")
        r = _drawn_serve(ce, label, prompts, PLACED_NEW)
        one, r1 = refs[kv_quant]
        parted = _held_greedy(label, prompts, r, r1, tie=MESH_TIE)
        tp = ce.cache.tp
        for n in NEW_PATHS:
            if r["per_chunk"][n] != tp * r1["per_chunk"][n]:
                raise AssertionError(f"{label}: {n} launches per chunk "
                                     f"{r['per_chunk'][n]}, the unsharded "
                                     f"engine's {r1['per_chunk'][n]}")
        pages = _page_drift(ce, one)
        level = 1.0 / 127 if kv_quant == "int8" else 0.0
        of_bound = [d / (PLACED_PAGE_OF_BF16 * b + level) for d, b in zip(
            pages["by_layer"], bf16_drift["by_layer"])]
        pages["of_bound"] = max(of_bound)
        if pages["of_bound"] > 1.0:
            raise AssertionError(f"{label}: pages {pages}, the bf16 "
                                 f"engine's from float32 {bf16_drift}")
        sampled = [a == b for (_i, k, _s), a, b in zip(
            prompts, r["streams"], r1["streams"]) if k]
        out = dict(axes=axes, layout=_placed_layout(ce, axes, fmt),
                   tokens_per_s=r["tokens_per_s"],
                   ms_per_chunk=r["ms_per_chunk"], chunks=r["chunks"],
                   launches_per_chunk=r["per_chunk"], greedy_parted=parted,
                   sampled_equal=f"{sum(sampled)} of {len(sampled)}",
                   trie_pages=pages)
        if spec:
            snap = r["snap"]
            if snap["spec_drafted"] <= 0 \
                    or snap["spec_tokens_per_pass"] <= 1.0:
                raise AssertionError(f"{label}: drafted "
                                     f"{snap['spec_drafted']}, "
                                     f"{snap['spec_tokens_per_pass']} "
                                     "tokens a verify pass")
            out["spec_tokens_per_pass"] = snap["spec_tokens_per_pass"]
        res[label.removeprefix("placed ")] = out
        launches[label] = r["launches"]
        ce.close()
        del ce, gen
        torch.cuda.empty_cache()
    for one, _r in refs.values():
        one.close()
    res["bf16_page_drift_from_f32"] = bf16_drift
    res["f32_tokens_per_s"] = f32_run["tokens_per_s"]
    res["launches"] = launches
    return res


def _prefill_flip(one, sharded, ids, cfg, per_layer: int):
    """:func:`_routing_flip` over every position of one prefill of
    ``ids`` through the unsharded dense engine and the placed one: a slot
    engine's stream can part well after a position whose experts flipped
    (that position's K and V moved, not its token), so the whole context
    up to the parting token is searched."""
    with _RouterRecord().recording() as a:
        one.prefill([ids])
    with _RouterRecord().recording() as b:
        sharded.prefill([ids])
    return _routing_flip(a, b, 0, [0] * len(ids), range(len(ids)), cfg,
                         per_layer)


def placed_moe_serving(devices=PLACED_DEVICES) -> dict:
    """mixtral-8x7b bf16 at full width and MIXTRAL_LAYERS of its 32
    layers through the slot engine over a tree placed on {expert: 4}
    (placed_moe_mlp's dense dispatch: each expert shard's experts over
    every token, summed in shard order) beside the unsharded slot engine
    on the same weights: 8 greedy prompts of 64–512 tokens x PLACED_NEW
    tokens, fp pages. Streams equal or parted at a logged near-tie or a
    routing flip (``_moe_held``: the flip read from one dense prefill of
    the parting context through the unsharded and the placed engine);
    per chunk one launch of each kernel a layer, as unsharded (the pages
    live on the first expert shard, whose attention runs once), no plain
    version."""
    cfg = _expert_cfg(MIXTRAL_LAYERS, torch.bfloat16)
    g = torch.Generator(device="cuda")
    g.manual_seed(PLACED_MOE_SEED)
    params = init_params(cfg, g, device="cuda")
    rng = np.random.default_rng(PLACED_MOE_SEED)
    prompts = [(rng.integers(0, cfg.vocab_size, n).tolist(), {}, False)
               for n in EXPERT_PROMPT_LENS]
    kw = dict(max_seq_len=EXPERT_SEQ_BUCKETS[-1] + 2 * PLACED_NEW,
              seq_buckets=EXPERT_SEQ_BUCKETS, batch_buckets=(1,))
    dense = GenerationEngine(cfg, params, device="cuda", **kw)
    one = _cont(dense)
    r1 = _drawn_serve(one, "placed moe reference", prompts, PLACED_NEW)
    one.close()
    gen = _placed_gen(cfg, params, PLACED_MOE_AXES, devices, **kw)
    ce = _cont(gen)
    if ce._mesh is None or ce.cache.tp != 1:
        raise AssertionError("placed moe: not the placed step")
    r = _drawn_serve(ce, "placed moe expert4", prompts, PLACED_NEW)
    for n in NEW_PATHS:
        if r["per_chunk"][n] != r1["per_chunk"][n]:
            raise AssertionError(f"placed moe: {n} launches per chunk "
                                 f"{r['per_chunk'][n]} vs "
                                 f"{r1['per_chunk'][n]}")
    parted: list = []
    per_layer = len(set(gen.mesh.flat()))
    ids = [p for p, _k, _s in prompts]
    _moe_held("placed moe expert4", dense, ids, r["streams"], r1["streams"],
              parted, lambda i, at: _prefill_flip(
                  dense, gen, ids[i] + r1["streams"][i][:at], cfg,
                  per_layer))
    ce.close()
    res = dict(card=_smi(), layers=cfg.n_layers, axes=PLACED_MOE_AXES,
               tokens_per_s=r["tokens_per_s"], ms_per_chunk=r["ms_per_chunk"],
               chunks=r["chunks"], launches_per_chunk=r["per_chunk"],
               unsharded=dict(tokens_per_s=r1["tokens_per_s"],
                              ms_per_chunk=r1["ms_per_chunk"],
                              chunks=r1["chunks"]),
               parted=parted, launches=r["launches"])
    del ce, gen, one, dense, params
    torch.cuda.empty_cache()
    return res


def placed_node(devices=PLACED_DEVICES, pool_pages: int = 0) -> dict:
    """A port validator, a worker advertising ``devices``
    (``MLConfig(mesh_devices=[...])``, and ``cont_pool_pages=pool_pages``)
    and a user on 127.0.0.1: a
    DistributedModel of qwen3-0p6b bf16 at full width and
    PLACED_NODE_LAYERS layers asking parallelism PLACED_NODE_HINT is
    planned {tensor: 2, fsdp: 2}; its continuous GENERATEs are answered
    by the job's slot engine over the placed tree (its chunks move, the
    dense engine's generate and prefill calls do not), each kernel
    launched once a shard a layer per chunk, the tokens equal to an
    in-process slot engine with the worker's knobs over the same seeded
    tree placed the same way. With ``pool_pages`` the job's slot engine is
    a tenant of the worker's shared pool, made on its page mesh (split by
    kv head over the first group's two tensor positions), and the
    reference is a private engine: pooled == private, bitwise."""
    from tensorlink_tpu_torch.core.config import (
        MLConfig,
        UserConfig,
        ValidatorConfig,
        WorkerConfig,
    )
    from tensorlink_tpu_torch.ml.module import DistributedModel
    from tensorlink_tpu_torch.nodes.runners import (
        UserNode,
        ValidatorNode,
        WorkerNode,
    )

    label = "placed pool node" if pool_pages else "placed node"
    root = PLACED_ROOT / label.replace(" ", "_")
    shutil.rmtree(root, ignore_errors=True)
    cfg = config_presets()["qwen3-0p6b"].with_(n_layers=PLACED_NODE_LAYERS)
    rng = np.random.default_rng(PLACED_NODE_SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (40, 300, 700)[:PLACED_NODE_REQUESTS]]
    common = dict(local_test=True, log_dir=str(root / "logs"),
                  env_file=str(root / ".env"))
    nodes = []
    res: dict = dict(card=_smi(), layers=PLACED_NODE_LAYERS,
                     hint=PLACED_NODE_HINT)
    try:
        with _clean_spawn():
            v = ValidatorNode(ValidatorConfig(
                endpoint=False, key_dir=str(root / "vkeys"), ml=MLConfig(),
                **common)).start()
            nodes.append(v)
            seeds = [["127.0.0.1", v.port]]
            w = WorkerNode(WorkerConfig(
                seed_validators=seeds, key_dir=str(root / "wkeys"),
                ml=MLConfig(mesh_devices=list(devices),
                            cont_pool_pages=pool_pages), **common)).start()
            nodes.append(w)
            u = UserNode(UserConfig(
                seed_validators=seeds, key_dir=str(root / "ukeys"),
                ml=MLConfig(), **common)).start()
            nodes.append(u)
        deadline = time.monotonic() + 60
        while len(v.status()["peers"]) < 2:
            if time.monotonic() > deadline:
                raise AssertionError(f"{label}: the nodes never met")
            time.sleep(0.1)
        model = DistributedModel(cfg, node=u, seed=PLACED_NODE_SEED,
                                 parallelism=PLACED_NODE_HINT)
        axes = model.plan.stages[0].mesh_axes
        if axes != PLACED_NODE_HINT:
            raise AssertionError(f"{label}: planned {axes}")
        rt = w.executor.jobs[model.job_id]
        if rt.mesh is None or not tmesh.is_sharded(rt.params):
            raise AssertionError(f"{label}: the job's mesh {rt.mesh}")
        static: dict = {}

        def counted(name):
            real = getattr(rt.engine, name)

            def call(*a, **k):
                static[name] = static.get(name, 0) + 1
                return real(*a, **k)

            return call

        for name in ("generate", "generate_compiled", "generate_chunked",
                     "generate_beam", "generate_lookahead", "prefill"):
            setattr(rt.engine, name, counted(name))
        # the first request builds the job's slot engine
        model.generate([prompts[0]], max_new_tokens=4, continuous=True)
        cont = rt.cont
        if cont is None or cont._mesh is not rt.mesh or cont.cache.tp != 2:
            raise AssertionError(f"{label}: the slot engine {cont}")
        if bool(pool_pages) != (cont.pool is not None) or (
                pool_pages and (cont.cache.k is not cont.pool.kv[0]
                                or cont.pool.n_pages - 1 != pool_pages)):
            raise AssertionError(f"{label}: the engine's pool {cont.pool}")
        lc = _Launches(label)
        lc.add(cont)
        t0 = time.monotonic()
        got = [model.generate([p], max_new_tokens=PLACED_NEW, seed=i,
                              continuous=True)[0]
               for i, p in enumerate(prompts)]
        wall = time.monotonic() - t0
        launches = lc.check()
        if static:
            raise AssertionError(f"{label}: the dense engine ran "
                                 f"{static}")
        # the reference: the worker's knobs, the same requests in the
        # same order (the warm one first: its pages are in the trie)
        ml = w.executor.node.config.ml
        g = torch.Generator(device="cuda")
        g.manual_seed(PLACED_NODE_SEED)
        ref_gen = _placed_gen(cfg, init_params(cfg, g, device="cuda"),
                              axes, devices, max_seq_len=min(
                                  cfg.max_seq_len, ml.max_seq_len))
        ref = _cont(ref_gen, max_slots=ml.cont_max_slots,
                    page_size=ml.cont_page_size,
                    chunk_steps=ml.cont_chunk_steps,
                    prefill_chunk=ml.prefill_chunk,
                    prefix_cache=ml.prefix_cache,
                    kv_quant=str(ml.kv_quant or "none"),
                    spec_decode=bool(ml.spec_decode),
                    spec_draft=int(ml.spec_draft))
        ref.submit(prompts[0], max_new_tokens=4, seed=0)
        ref.run_until_idle()
        for i, p in enumerate(prompts):
            req = ref.submit(p, max_new_tokens=PLACED_NEW, seed=i)
            ref.run_until_idle()
            _equal_stream(f"{label} request {i}", got[i], req.tokens)
        ref.close()
        if pool_pages:
            res["pool"] = dict(pages=pool_pages,
                               placement=list(cont.pool.placement),
                               tenants=len(cont.pool.tenants))
        res.update(planned=axes, chunks=launches["chunks"],
                   launches=launches, wall_s=wall,
                   tokens_per_s=PLACED_NEW * len(prompts) / wall,
                   dense_calls=static)
        model.shutdown()
    finally:
        for nd in reversed(nodes):
            nd.stop()
        nodes = v = w = u = rt = None
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return res


def placed_phase() -> dict:
    """Phase 21: the slot engine over a tree placed on a planned mesh,
    every position on cuda:0. The per-shard kernel check, qwen3-0p6b's
    runs, mixtral-8x7b on {expert: 4}, the node path, and readings."""
    t0 = time.monotonic()
    res = dict(kernels=placed_kernel_check(), serving=placed_serving(),
               moe=placed_moe_serving(), node=placed_node())
    res["seconds"] = time.monotonic() - t0
    log(f"placed (qwen3-0p6b bf16 at {PLACED_LAYERS} layers on "
        f"{list(PLACED_LAYOUTS.values())}, mixtral-8x7b at {MIXTRAL_LAYERS} "
        f"layers on {PLACED_MOE_AXES}, every position on cuda:0; one card: "
        f"a correctness run, the speeds are readings, not claims; "
        f"{_smi()}): {json.dumps(res)}")
    log(f"phase 21 took {res['seconds']:.1f} s ({_smi()})")
    return res


def placed_cards() -> dict:
    """Not a phase of ``main()``: it needs four cards on one host. Phase
    21's fp runs of qwen3-0p6b on {tensor: 4} and {fsdp: 2, tensor: 2}
    with the positions on the distinct local cards, against the
    unsharded slot engine on card 0: greedy streams equal up to a logged
    near-tie, per chunk tensor x the unsharded launches of each kernel,
    each shard's pages on its own card; each card's peak memory. Then
    phase 22's olmo2-7b run over fp pages at full depth (32 layers, 14.6
    GB in bf16) on {tensor: 4} over the four cards against the unsharded
    engines on card 0, with each card's peak. Tokens/s and ms per chunk
    are readings."""
    n = torch.cuda.device_count()
    if n < 4:
        raise SystemExit(f"placed_cards: needs 4 cards, have {n}")
    cards = [torch.device("cuda", i) for i in range(n)]
    for c in cards:
        torch.empty(1, device=c)  # a card's stats exist once it is used
        torch.cuda.reset_peak_memory_stats(c)
    res = placed_serving(devices=None, runs=tuple(
        (name, "none", False) for name in PLACED_LAYOUTS))
    res["peak_bytes"] = _peaks(cards)
    res["cards"] = n
    log(f"placed_cards (qwen3-0p6b bf16 at {PLACED_LAYERS} layers, "
        f"positions on distinct cards; readings, not claims; "
        f"{res['card']} x {n}): {json.dumps(res)}")
    gc.collect()
    torch.cuda.empty_cache()
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    olmo = olmo_serving(_olmo(config_presets()[OLMO_MODEL].n_layers),
                        devices=None, formats=("none",))
    olmo["peak_bytes"] = _peaks(cards)
    log(f"placed_cards (olmo2-7b bf16 at full depth on {OLMO_AXES}, "
        f"positions on distinct cards, the unsharded engines on card 0; "
        f"readings, not claims; {olmo['card']} x {n}): {json.dumps(olmo)}")
    res["olmo"] = olmo
    return res


# -- phase 22: placed co-hosting and OLMo-2 -------------------------------
OLMO_MODEL = "olmo2-7b"
OLMO_LAYERS = 8  # of 32: a tree is about 4.9 GB in bf16 (14.6 GB at 32)
OLMO_SEED = 2222
# the JAX planner's axes for olmo2-7b on four devices (32 kv heads)
# tlint: disable=TL006(read-only constant table — never mutated)
OLMO_AXES = {"tensor": 4}
OLMO_SEQ = 1088  # phase 15's prompts (64 to 1024 tokens) and 32 new ones
OLMO_FORMATS = ("none", "int8")
POOLED_LAYERS = MODEL_LAYERS  # 14 of 28, as phase 8's co-hosting (time)
POOLED_SEEDS = (0, 1)  # the two tenants' trees
# tlint: disable=TL006(read-only constant table — never mutated)
POOLED_AXES = {"tensor": 4}
POOLED_PROMPT_LENS = (300, 700, 150, 1000)  # phase 8's co-hosting prompts
POOLED_NEW = 32
POOLED_PAGES = 600
POOLED_QUOTA = 300
# a tenant's 4 requests take 144 pages and its trie keeps about 140 of
# them after: the second tenant's admissions reclaim the first's
POOLED_SMALL_PAGES = 200
POOLED_NODE_PAGES = 256  # the node job's pool (its requests take 72)


def _kv_bytes(cfg, fmt: str) -> int:
    """KV bytes per token of a whole paged cache over ``cfg`` in page
    format ``fmt`` (int8 and int4: one f32 scale a head and position)."""
    hd = cfg.head_dim
    per_head = {"fp": hd * torch.finfo(cfg.dtype).bits // 8,
                "int8": hd + 4, "int4": hd // 2 + 4}[fmt]
    return 2 * cfg.n_layers * cfg.n_kv_heads * per_head


def _olmo(n_layers: int = OLMO_LAYERS):
    """olmo2-7b in bf16 at full width (d_model 4096, 32 heads and kv
    heads, hd 128, d_ff 11008, vocab 100,352, untied head, post norm,
    qk_norm_full), random weights from OLMO_SEED, ``n_layers`` of 32."""
    cfg = config_presets()[OLMO_MODEL].with_(n_layers=n_layers)
    g = torch.Generator(device="cuda")
    g.manual_seed(OLMO_SEED)
    return cfg, init_params(cfg, g, device="cuda")


def olmo_serving(model=None, devices=PLACED_DEVICES,
                 formats=OLMO_FORMATS) -> dict:
    """olmo2-7b bf16 at full width (``model``, default OLMO_LAYERS layers)
    through the slot engine over the tree placed by stage_param_specs on
    {tensor: 4} (8 query and 8 kv heads a shard; each shard's q and k
    columns gathered whole for the norm over the whole projection), each
    page format of ``formats`` held against the unsharded slot engine
    over the same weights: phase 15's 8 requests x PLACED_NEW tokens,
    greedy streams equal or parted only where the unsharded run's
    top-two gap is within MESH_TIE (logged); per chunk 4x the unsharded
    engine's launches of each kernel, no plain version; the pages both
    tries hold, per layer, within phase 21's rule (PLACED_PAGE_OF_BF16 x
    the unsharded engine's distance from a float32 engine's, one int8
    level more over int8 pages); the pages split by kv head, each
    position's KV bytes per token a quarter of the whole's. Readings:
    tokens/s and ms per chunk beside the unsharded engine's."""
    cfg, params = model or _olmo()
    prompts = _tp_prompts(cfg)
    kw = dict(max_seq_len=OLMO_SEQ, device="cuda")
    refs = {}
    for kv_quant in formats:
        one = _cont(GenerationEngine(cfg, params, **kw), kv_quant=kv_quant)
        refs[kv_quant] = one, _drawn_serve(
            one, f"olmo reference {_fmt(kv_quant)}", prompts, PLACED_NEW)
    f32 = _cont(GenerationEngine(cfg.with_(dtype=torch.float32),
                                 _cast_tree(params), **kw))
    f32_run = _drawn_serve(f32, "olmo reference f32", prompts, PLACED_NEW)
    bf16_drift = _page_drift(refs["none"][0], f32)
    f32.close()
    del f32
    gc.collect()
    torch.cuda.empty_cache()
    res: dict = dict(card=_smi(), layers=cfg.n_layers, axes=OLMO_AXES,
                     requests=len(prompts), new_tokens=PLACED_NEW,
                     unsharded={
                         _fmt(kv): dict(tokens_per_s=r["tokens_per_s"],
                                        ms_per_chunk=r["ms_per_chunk"],
                                        chunks=r["chunks"])
                         for kv, (_o, r) in refs.items()})
    launches = {}
    for kv_quant in formats:
        fmt = _fmt(kv_quant)
        label = f"olmo tensor4 {fmt}"
        gen = _placed_gen(cfg, params, OLMO_AXES, devices,
                          max_seq_len=OLMO_SEQ)
        ce = _cont(gen, kv_quant=kv_quant)
        tp = OLMO_AXES["tensor"]
        if ce._mesh is None or ce._mesh.shape != OLMO_AXES \
                or ce.cache.tp != tp:
            raise AssertionError(f"{label}: not the placed step")
        r = _drawn_serve(ce, label, prompts, PLACED_NEW)
        one, r1 = refs[kv_quant]
        parted = _held_greedy(label, prompts, r, r1, tie=MESH_TIE)
        for n in NEW_PATHS:
            if r["per_chunk"][n] != tp * r1["per_chunk"][n]:
                raise AssertionError(f"{label}: {n} launches per chunk "
                                     f"{r['per_chunk'][n]}, the unsharded "
                                     f"engine's {r1['per_chunk'][n]}")
        pages = _page_drift(ce, one)
        level = 1.0 / 127 if kv_quant == "int8" else 0.0
        pages["of_bound"] = max(d / (PLACED_PAGE_OF_BF16 * b + level)
                                for d, b in zip(pages["by_layer"],
                                                bf16_drift["by_layer"]))
        if pages["of_bound"] > 1.0:
            raise AssertionError(f"{label}: pages {pages}, the bf16 "
                                 f"engine's from float32 {bf16_drift}")
        sampled = [a == b for (_i, k, _s), a, b in zip(
            prompts, r["streams"], r1["streams"]) if k]
        res[fmt] = dict(
            layout=_placed_layout(ce, OLMO_AXES, fmt, _kv_bytes(cfg, fmt)),
            tokens_per_s=r["tokens_per_s"], ms_per_chunk=r["ms_per_chunk"],
            chunks=r["chunks"], launches_per_chunk=r["per_chunk"],
            greedy_parted=parted,
            sampled_equal=f"{sum(sampled)} of {len(sampled)}",
            trie_pages=pages)
        launches[label] = r["launches"]
        ce.close()
        del ce, gen
        gc.collect()
        torch.cuda.empty_cache()
    for one, _r in refs.values():
        one.close()
    res["bf16_page_drift_from_f32"] = bf16_drift
    res["f32_tokens_per_s"] = f32_run["tokens_per_s"]
    res["launches"] = launches
    return res


def _pooled_run(label: str, tenants: dict, pool, prompts, want: dict,
                sequential: bool) -> dict:
    """Each tenant's requests (``prompts`` x POOLED_NEW, seed i), stepped
    from one thread (together, or one tenant to the end after the
    other): the pool conserved and every quota held at each chunk
    boundary; each stream bitwise ``want``'s (its private engine's)."""
    reqs: dict = {}
    peak = {name: 0 for name in tenants}

    def boundary():
        pool.check_page_conservation()
        for name, ce in tenants.items():
            peak[name] = max(peak[name], ce.alloc.used)
            if ce.alloc.used > ce.alloc.quota:
                raise AssertionError(f"{label}: {name} over its quota")

    def submit(name):
        reqs[name] = [tenants[name].submit(p, max_new_tokens=POOLED_NEW,
                                           seed=i)
                      for i, p in enumerate(prompts)]

    if sequential:
        for name, ce in tenants.items():
            submit(name)
            while ce.step_chunk():
                boundary()
    else:
        for name in tenants:
            submit(name)
        busy = True
        while busy:
            busy = False
            for ce in tenants.values():
                busy |= ce.step_chunk()
            boundary()
    for name, rs in reqs.items():
        for i, r in enumerate(rs):
            _equal_stream(f"{label} {name} request {i}", r.tokens,
                          want[name][i])
    return dict(peak_pages_used=peak, cache_reclaims=pool.cache_reclaims,
                cross_preemptions=pool.cross_preemptions)


def placed_pool_serving(devices=PLACED_DEVICES) -> dict:
    """Two qwen3-0p6b tenants (bf16 trees from seeds 0 and 1,
    POOLED_LAYERS layers at full width), both placed on {tensor: 4}, on
    one SharedPagePool made on their page mesh (``mesh=``; the pages
    split by kv head over the four positions): phase 8's co-hosting
    prompts x POOLED_NEW on each. (1) 600 pages, quotas of 300, the two
    stepped together; (2) POOLED_SMALL_PAGES pages, the first tenant's
    requests to their end and then the second's, whose admissions
    reclaim the first's cached pages. In both each tenant's streams are
    bitwise its private placed engine's, the pool conserved and the
    quotas held at every chunk boundary, both tenants reading the pool's
    page tensors, and every page back at close; one launch of each
    kernel a shard and layer per chunk, no plain version."""
    from tensorlink_tpu_torch.engine.paged import SharedPagePool

    cfg = config_presets()["qwen3-0p6b"].with_(n_layers=POOLED_LAYERS)
    gens = {}
    for seed in POOLED_SEEDS:
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        gens[f"seed{seed}"] = _placed_gen(
            cfg, init_params(cfg, g, device="cuda"), POOLED_AXES, devices,
            max_seq_len=PLACED_SEQ)
    rng = np.random.default_rng(77)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in POOLED_PROMPT_LENS]
    lc = _Launches("placed pool")
    private = {}
    for name, gen in gens.items():
        ce = lc.add(_cont(gen, max_slots=4))
        rs = [ce.submit(p, max_new_tokens=POOLED_NEW, seed=i)
              for i, p in enumerate(prompts)]
        ce.run_until_idle()
        private[name] = [list(r.tokens) for r in rs]
        ce.close()
    dev, cmesh = paged.placed_cache_mesh(next(iter(gens.values())).params,
                                         cfg)
    res: dict = dict(card=_smi(), layers=cfg.n_layers, axes=POOLED_AXES,
                     prompts=list(POOLED_PROMPT_LENS), new_tokens=POOLED_NEW)
    for run, (n_pages, quota, sequential) in (
            ("shared", (POOLED_PAGES, POOLED_QUOTA, False)),
            ("small", (POOLED_SMALL_PAGES, POOLED_SMALL_PAGES, True))):
        label = f"placed pool {run}"
        pool = SharedPagePool(cfg, n_pages, page_size=16, device=dev,
                              mesh=cmesh)
        tenants = {name: lc.add(_cont(gen, max_slots=4, pool=pool,
                                      model_id=name, page_quota=quota))
                   for name, gen in gens.items()}
        for ce in tenants.values():
            c = ce.cache
            if c.k is not pool.kv[0] or c.tp != POOLED_AXES["tensor"] \
                    or [t.device for t in c.k.shards] != list(cmesh.flat()):
                raise AssertionError(f"{label}: a tenant's pages are not "
                                     "the pool's split ones")
        out = _pooled_run(label, tenants, pool, prompts, private, sequential)
        for ce in tenants.values():
            ce.close()
        if pool.alloc.n_free != n_pages or pool.tenants:
            raise AssertionError(f"{label}: pages not returned at close")
        if run == "small" and (out["cache_reclaims"] <= 0
                               or out["cross_preemptions"]):
            raise AssertionError(f"{label}: reclaims {out}")
        out.update(pages=n_pages, quota=quota,
                   placement=list(pool.placement))
        res[run] = out
        del pool, tenants
        gc.collect()
    res["launches"] = lc.check()
    del gens
    gc.collect()
    torch.cuda.empty_cache()
    return res


def olmo_phase() -> dict:
    """Phase 22, part 1: olmo2-7b on {tensor: 4}, every position on
    cuda:0. Its per-shard kernel check at its shard shape (Hq 8, Hkv 8,
    hd 128: a head group of 1), then its serving runs."""
    from tensorlink_tpu_torch.engine.optimizers import tree_map

    t0 = time.monotonic()
    cfg, params = model = _olmo()
    # the check at half the serving depth (a layer's launches are what it
    # holds), as phase 21's: views of the first layers
    res = dict(kernels=placed_kernel_check(
        (cfg.with_(n_layers=OLMO_LAYERS // 2), dict(params, layers=tree_map(
            lambda t: t[:OLMO_LAYERS // 2], params["layers"]))),
        "olmo kernels"))
    res["serving"] = olmo_serving(model)
    del model, params
    res["seconds"] = time.monotonic() - t0
    log(f"olmo (olmo2-7b bf16 at {OLMO_LAYERS} layers on {OLMO_AXES}, every "
        f"position on cuda:0; one card: a correctness run, the speeds are "
        f"readings, not claims; {_smi()}): {json.dumps(res)}")
    log(f"phase 22 (1) took {res['seconds']:.1f} s ({_smi()})")
    return res


def placed_pool_phase() -> dict:
    """Phase 22, parts 2 and 3: the two tenants on one placed pool, and
    the node job on a pool, every position on cuda:0."""
    t0 = time.monotonic()
    res = dict(pool=placed_pool_serving(),
               node=placed_node(pool_pages=POOLED_NODE_PAGES))
    res["seconds"] = time.monotonic() - t0
    log(f"placed pool (two qwen3-0p6b tenants at {POOLED_LAYERS} layers on "
        f"one pool on {POOLED_AXES}, a pooled node job, every position on "
        f"cuda:0; one card: a correctness run, the speeds are readings, not "
        f"claims; {_smi()}): {json.dumps(res)}")
    log(f"phase 22 (2, 3) took {res['seconds']:.1f} s ({_smi()})")
    return res


# a phase starts once the card has this much memory free, or after
# PHASE_FREE_WAIT_S: the lanes' processes share the card
PHASE_FREE_GIB = 24.0
PHASE_FREE_WAIT_S = 180.0


def _await_memory(name: str) -> None:
    t0 = time.monotonic()
    while torch.cuda.mem_get_info()[0] < PHASE_FREE_GIB * 2**30 \
            and time.monotonic() - t0 < PHASE_FREE_WAIT_S:
        time.sleep(1.0)
    waited = time.monotonic() - t0
    if waited >= 1.0:
        log(f"phase {name}: waited {waited:.0f}s for {PHASE_FREE_GIB} GiB "
            f"of the card free ({torch.cuda.mem_get_info()[0] / 2**30:.1f})")


def _phase(name, fn, *args):
    if torch.cuda.is_available():  # phase 1 fails without a card
        _await_memory(name)
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    out = fn(*args)
    # the reserved memory this process's phase peaked at; what it frees
    # goes back to the card for the other processes: an engine's metrics
    # gauges refer back to it, so its pages go only at a collection
    peak = torch.cuda.max_memory_reserved() / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    live = torch.cuda.memory_allocated() / 2**30
    log(f"phase {name}: {time.monotonic() - t0:.1f}s, peak {peak:.1f} GiB "
        f"reserved, {live:.1f} GiB live after")
    return out


# phases 11, 13-17 and 19-22 run in two worker processes ("lanes")
# beside the parent's phases 4-10 and 12, once the kernel timings (which
# must run alone on the card) and phase 18 (its expert training step
# alone holds about 45 GiB) are done: each phase is host-bound (one thread
# issues its launches; the card is busy a tenth to a third of the time),
# so three processes share the card and the host's cores. Each lane runs
# its phases in order (phase 17 holds against phase 16's unsharded run,
# in the same lane) and writes their results as JSON; the parent prints
# its log and fails if a lane fails. Nothing about a check changes: only
# the speeds, which are readings, see the other lanes' load. Phase 22's
# two parts end one lane each, which keeps the lanes near even.
# tlint: disable=TL006(read-only constant table — never mutated)
LANES = {
    "lane1": ("training", "stages", "stages training", "tensor parallel",
              "olmo"),
    "lane2": ("mesh", "fsdp", "product parallel", "coslice",
              "placed serving", "placed pool"),
}
LANE_ROOT = Path(__file__).resolve().parent / "build" / "lanes"


def _watch_parent() -> None:
    """End this lane (through its phases' clean-up) if the process that
    started it is gone."""
    import _thread
    import os

    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        _thread.interrupt_main()
        time.sleep(60.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def run_lane(lane: str) -> None:
    """One lane's phases, in a process of its own (the device set up as
    phase 1 does); their results to ``LANE_ROOT/<lane>.json``."""
    _watch_parent()
    device_phase()
    reference: dict = {}  # phase 16's unsharded training run, for 17
    fns = {
        "training": training_phase, "stages": stages_phase,
        "stages training": stages_training_phase,
        "tensor parallel": tp_phase,
        "mesh": lambda: mesh_phase(reference),
        "fsdp": lambda: fsdp_phase(reference),
        "product parallel": product_phase,
        "coslice": coslice_phase, "placed serving": placed_phase,
        "olmo": olmo_phase, "placed pool": placed_pool_phase,
    }
    out = {}
    for name in LANES[lane]:
        out[name] = _jsonable(_phase(name, fns[name]))
    (LANE_ROOT / f"{lane}.json").write_text(json.dumps(out))


def _jsonable(x):
    """A phase's result as JSON takes it: string keys, lists for tuples,
    numbers for tensors and numpy scalars, ``repr`` for anything else."""
    if isinstance(x, dict):
        return {k if isinstance(k, str) else str(k): _jsonable(v)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (torch.Tensor, np.ndarray, np.generic)):
        return x.tolist()
    if x is None or isinstance(x, (str, int, float, bool)):
        return x
    return repr(x)


def _start_lanes() -> dict:
    """Start every lane's process; its output goes to
    ``LANE_ROOT/<lane>.log``."""
    shutil.rmtree(LANE_ROOT, ignore_errors=True)
    LANE_ROOT.mkdir(parents=True)
    repo = Path(__file__).resolve().parent
    procs = {}
    for lane in LANES:
        out = open(LANE_ROOT / f"{lane}.log", "w")
        procs[lane] = (subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke as c; c.run_lane({lane!r})"],
            cwd=repo, stdout=out, stderr=subprocess.STDOUT), out)
    return procs


def _stop_lanes(procs: dict) -> None:
    """Stop every lane still running (a failed parent leaves none) and
    print the log of each the parent did not join."""
    for lane, (p, out) in procs.items():
        if p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if not out.closed:
            out.close()
            log(f"-- {lane}, stopped (exit {p.returncode}):")
            sys.stdout.write((LANE_ROOT / f"{lane}.log").read_text())
            sys.stdout.flush()


def _join_lanes(procs: dict) -> dict:
    """Wait for every lane, print its log, and return its phases'
    results; a lane that failed fails the run."""
    results, failed = {}, []
    for lane, (p, out) in procs.items():
        rc = p.wait()
        out.close()
        log(f"-- {lane} ({', '.join(LANES[lane])}), exit {rc}:")
        sys.stdout.write((LANE_ROOT / f"{lane}.log").read_text())
        sys.stdout.flush()
        if rc != 0:
            failed.append(f"{lane} (exit {rc})")
            continue
        results.update(json.loads((LANE_ROOT / f"{lane}.json").read_text()))
    if failed:
        raise AssertionError(f"chip_smoke: {', '.join(failed)} failed")
    return results


def main() -> None:
    t_start = time.monotonic()
    _phase("device", device_phase)
    _phase("build", build_phase)
    errs = _phase("kernels", kernel_checks)
    _phase("nibble order", nibble_order_check)
    _phase("chunk framing", framing_check)
    _phase("decode rows", decode_rows_check)
    ferrs = _phase("flash kernel", flash_checks)
    times = _phase("kernel timings", kernel_timings)
    ftime = _phase("flash timing", flash_timing)
    expert = _phase("expert", expert_phase)
    lanes = _start_lanes()
    try:
        serving, dense, new_paths, node, fleet = _parent_phases()
        done = _join_lanes(lanes)
    finally:
        _stop_lanes(lanes)
    done["expert"] = expert
    _report(t_start, errs, ferrs, times, ftime, serving, dense, new_paths,
            node, fleet, done)


def _parent_phases() -> tuple:
    """Phases 4-10 and 12, in the parent while the lanes run."""
    for kv_quant in ("none", "int8", "int4"):
        _phase(f"step parity {kv_quant}", step_parity, kv_quant)
    _phase("dense parity", dense_parity)
    _phase("bf16 parity", bf16_parity)
    serving = {}
    for kv_quant, quant, n_req in SERVE_RUNS:
        serving[_fmt(kv_quant)] = _phase(f"serving {kv_quant}", serving_phase,
                                         kv_quant, quant, n_req)
    dense = _phase("dense serving", dense_serving)
    _phase("gemm rows", gemm_rows)
    new_paths = {}
    for kv_quant in ("none", "int8"):
        r = _phase(f"spec serving {kv_quant}", spec_serving, kv_quant)
        new_paths[f"spec {_fmt(kv_quant)}"] = r["launches_on"]
    mig = _phase("migration", migration_phase)
    for fmt in FORMATS:
        new_paths[f"migration {fmt}"] = mig[fmt]["launches"]
    new_paths["handoff and drain"] = mig["handoff"]["launches"]
    new_paths["host tier"] = _phase("host tier", host_tier_phase)["launches"]
    new_paths["co-hosting"] = _phase("co-hosting", cohost_phase)["launches"]
    new_paths["publish"] = _phase("publish", publish_phase)["launches"]
    ck = _phase("checkpoint", checkpoint_phase)
    new_paths["checkpoint qwen3"] = ck["qwen3"]["launches"]
    new_paths["checkpoint qwen3 source"] = ck["qwen3"]["launches_source"]
    for fmt in ("fp", "int8"):
        new_paths[f"checkpoint mixtral {fmt}"] = \
            ck["mixtral"][f"launches_{fmt}"]
    node = _phase("node", node_phase)
    fleet = _phase("fleet", fleet_phase, node)
    return serving, dense, new_paths, node, fleet


def _report(t_start, errs, ferrs, times, ftime, serving, dense, new_paths,
            node, fleet, done) -> None:
    """The kernels line and the last line, from every phase's results
    (the lanes' ``done``, by phase name)."""
    training = done["training"]
    new_paths["serve-and-train"] = training["serve_train"]["launches"]
    new_paths["fleet"] = fleet
    new_paths["stages repair"] = done["stages"]
    # the training path runs the einsum attention: 0 launches, asserted
    train_launches = done["stages training"]["training"]["launches"]
    tp = done["tensor parallel"]
    mesh, fsdp = done["mesh"], done["fsdp"]
    expert, product = done["expert"], done["product parallel"]
    coslice, placed = done["coslice"], done["placed serving"]
    # phase 21's runs, each shard's launch counted
    placed_runs = dict(placed["serving"]["launches"])
    placed_runs["placed moe expert4"] = placed["moe"]["launches"]
    placed_runs["placed node fsdp2-tensor2"] = placed["node"]["launches"]
    # phase 22: OLMo-2 on {tensor: 4}, the two pooled tenants (with their
    # private runs) and the pooled node job, each shard's launch counted
    pool_phase = done["placed pool"]
    pool_runs = dict(done["olmo"]["serving"]["launches"])
    pool_runs["pool tensor4"] = pool_phase["pool"]["launches"]
    pool_runs["pool node fsdp2-tensor2"] = pool_phase["node"]["launches"]
    kernels = []
    for name, fmt in _variants():
        t = times[(name, fmt)]
        on_path = name != "paged_prefill_attention"
        entry = {
            "name": name, "route": "cuda",
            "source": f"tensorlink_tpu_torch/ops/csrc/{SOURCE[name]}",
            "replaces": REPLACES[name],
            "launches": serving[fmt]["launches_by_format"][name][fmt],
            "max_abs_err": errs[(name, fmt)]["float32"],
            "max_abs_err_bf16": errs[(name, fmt)]["bfloat16"],
            "ms": t["ms"], "kernel_ms": t["ms"], "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"],
            "launches_stages_training": train_launches[name],
            "launches_fsdp_training": fsdp["launches"][name],
            # phase 19: the GPipe's and the ring's training steps
            "launches_product_training": product["launches_training"][name],
            # phase 20: the spanning steps' and the merged job's, counted
            # in the member and worker processes
            "launches_coslice_training": coslice["launches"][name],
            "design": DESIGN[name],
        }
        if fmt == "fp":
            entry["library_call"] = \
                "torch.nn.functional.scaled_dot_product_attention"
        else:
            entry["library_call"] = None
            entry["library_note"] = ("no single PyTorch call consumes int8 "
                                     "or packed-int4 pages")
        if name in NEW_PATHS:
            entry["launches_new_paths"] = {
                label: r["by_format"][name].get(fmt, 0)
                for label, r in new_paths.items()
                if r["by_format"][name].get(fmt, 0)
            }
            # the validator + worker run of phase 10 (int8 pages)
            entry["launches_node_path"] = node["by_format"][name].get(fmt, 0)
            # phase 15's tp=2 serving (fp and int8 pages), each shard's
            # launch counted
            served = tp["launches_tp"].get(fmt)
            entry["launches_tp"] = (served["by_format"][name].get(fmt, 0)
                                    if served else 0)
            # phase 19's tp=2 serving with the int8 gathers (fp pages),
            # each shard's launch counted
            entry["launches_tp_quant"] = product["tp_quant"][
                "launches_tp_quant"]["by_format"][name].get(fmt, 0)
            # phase 21: the slot engine over placed trees
            entry["launches_placed"] = {
                label.removeprefix("placed "): r["by_format"][name].get(
                    fmt, 0)
                for label, r in placed_runs.items()
                if r["by_format"][name].get(fmt, 0)}
            entry["launches_placed_pool"] = {
                label: r["by_format"][name].get(fmt, 0)
                for label, r in pool_runs.items()
                if r["by_format"][name].get(fmt, 0)}
            held = tp["kernels"][fmt]
            entry["tp_shard_of_bound"] = held[
                "ragged_of_bound" if name == "ragged_paged_attention"
                else "decode_of_bound"]
        if name != "paged_prefill_attention" and fmt == "fp":
            kernels.append(entry)  # PR 1's two entries, as they were
            continue
        entry["format"] = fmt
        if not on_path:
            entry["launches_note"] = ("no engine caller: the main path "
                                      "never launches it")
        kernels.append(entry)
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "tensorlink_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "tensorlink_tpu/ops/attention.py:151",
        "launches": dense["launches"],
        "max_abs_err": ferrs["float32"], "max_abs_err_bf16": ferrs["bfloat16"],
        "ms": ftime["ms"], "kernel_ms": ftime["ms"],
        "device_ms": ftime["device_ms"],
        "plain_ms": ftime["plain_ms"], "bound_ms": ftime["bound_ms"],
        "bound_by": ftime["bound_by"], "library_ms": ftime["library_ms"],
        "library_device_ms": ftime["library_device_ms"],
        "library_call": "torch.nn.functional.scaled_dot_product_attention",
        "launches_stages_training": train_launches["flash_attention"],
        "launches_fsdp_training": fsdp["launches"]["flash_attention"],
        "launches_product_training": product["launches_training"][
            "flash_attention"],
        "launches_coslice_training": coslice["launches"]["flash_attention"],
        # phase 16: the sharded engines' prefills, each (data, tensor)
        # shard's launch counted (L x 4 a B=8 prefill)
        "launches_mesh": mesh["serving"]["launches"],
        "launches_mesh_per_b8_prefill": mesh["serving"][
            "launches_per_b8_prefill"]["bf16"],
        "mesh_shard_max_abs_err": mesh["flash"]["max_abs_err"],
        # phase 18: the expert-mesh engines' prefills, each running
        # sub-group's tensor shard counted (2 layers x 1 on {expert: 4},
        # x 2 on {expert: 2, tensor: 2} a prefill, on the one card)
        "launches_expert": expert["serving"]["launches"],
        "launches_expert_per_prefill": {
            n: expert["serving"][n]["flash_launches_per_prefill"]
            for n in EXPERT_LAYOUTS},
        "design": DESIGN["flash_attention"],
    })
    log(f"chip_smoke: all 22 phases in {time.monotonic() - t_start:.1f} s, "
        f"{time.monotonic() - _T_START:.1f} s since the script started "
        f"({_smi()})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
