#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (unified_audio_tpu_torch) on one card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and the CUDA toolkit (nvcc); without them it exits non-zero and
prints no result. Phases, each fatal on failure:

1. device: the card's name and power limit (nvidia-smi).
2. kernels: builds ``csrc/paged_attention.cu`` and ``csrc/vq.cu`` (one nvcc
   each, started together), then holds each kernel against its plain
   PyTorch version, plain and kernel in turns, each timed twice: its device
   time (the CUDA records one call leaves, summed from torch.profiler's
   CUPTI records; this is the ``ms`` of the kernels line) and its wall time
   per call with the host's dispatch (CUDA events around back-to-back
   calls). The timer counts the records by name: a window of N calls must
   hold N times one call's records, and one call exactly one record of the
   kernel under test (each window opens with ``LEAD_INS`` lead-in kernels,
   left out of the count, because a profiler session can lose its first
   device records); a window that does not is timed again once, then the
   run fails (``records`` on the kernels line: the kernel's records
   over its timed windows, so 400 for a decode kernel, four windows of
   100 calls, and 100 for K5/K6, two windows of 50). Every decode kernel (K1-K4, K7), its plain
   version and its library call are timed twice more in turns with the
   layer cycling 0..11, so that each call finds its layer out of L2 as in a
   decode step (``cold_ms`` on the kernels line; the calls above reuse one
   layer, warm in L2). K1 and K7 are the tiled kernels (K/V tiles staged
   in a shared-memory ring by cp.async, lane groups over the head
   dimension); K2, K3 and K4 the pipelined ones (256 threads per slot and
   head, two keys in flight a thread).
   The owner flash-decode kernels K1 (bf16/fp32 pool) and K2 (int8 pool) run
   at the serving shapes (16 slots, 12 layers, 8 heads of 64, 64-token
   blocks, 14-block regions in a 256-block pool, inactive slots, positions
   up to a region's end). The stream flash-decode kernels K3 (bf16/fp32
   pool) and K4 (int8 pool) run at the UniTok serving shapes (16 slots, a
   12-layer pool of 320 64-token blocks, the bound at 320, tables scattered
   as a ``BlockAllocator`` hands them out, inactive slots, a slot whose only
   keys lie in the last chunk, a row with no visible key, which must come
   out as finite zeros). The block-table flash-decode kernel K7 (bf16/fp32
   pool; no serving path launches it) runs at UniSE serving width (16
   slots, a 12-layer pool of 320 64-token blocks, 14-entry tables scattered
   by a ``BlockAllocator``, trash entries x100, a repeated block, an index
   past the table, inactive slots). K1, K3 and K7 are also timed against
   one ``scaled_dot_product_attention`` call on the same function (a
   boolean mask over the pool prefix). Tolerances:
   fp32 within 1e-5 (abs and rel); bf16
   output within 2 bf16 ulps of the fp32 plain result on the same
   bf16-valued inputs (ulp floored at that of 2**-8). The VQ kernels K5
   (nearest code) and K6 (fused 4-layer residual encode) run on random fp32
   rows at M = 240 (a 9.6-s clip, the most rows that take 16 a cluster),
   M = 250 (one 10-s clip, 32 a cluster) and M = 2000 (eight clips),
   N = 1024, D = 512:
   codes equal to the plain search in >= 99.9% of places, every other one a
   near tie (fp64 distance excess <= 1e-5 (|x|^2 + max |e|^2)); K6 judged
   layer by layer on the residuals its own codes leave. Both launch one
   kernel (the codebook split over a cluster of 8 CTAs, the argmin merged
   in distributed shared memory); before each M a line gives its plan:
   rows a cluster, clusters, the clusters the card holds at once
   (cudaOccupancyMaxActiveClusters) and the L2 bytes a call reads and
   writes, reckoned from the plan (``vq.l2_bytes``). K8, the latent
   attention (``csrc/latent_attention.cu``, built beside them), runs at the
   Moonlight serving cell's shapes (``LATENT``): the decode step's call
   over a 27-layer bf16 latent pool, warm and cold, and the prefill's over
   a dense cache of 64 x 504, each against the plain version, held to fp32
   no further than the plain version plus 2e-3 of the output's scale.
   Then K8 on its main path: the Moonlight stack's serving engine at
   published widths (``MOONLIGHT``: 2 layers, bf16, 64 slots of SE and TSE
   requests, the decode steps replayed as a CUDA graph) with K8's launch
   count set to 0 before it; it fails unless the count is layers x
   (prefill waves + steps) and every request completes. Those launches are
   the kernels line's K8 launches; the timing calls before are printed
   apart.
3. UniSE serving: serves synthetic 16 kHz requests (SE, TSE, rTSE; greedy
   and sampled; more 5-s segments than the 16 slots) at full UniSE width
   through ``unified_audio_tpu_torch.cli serve``, once with the int8 pool
   (K2) and once, shorter, with the bf16 pool (K1). The int8 pass also
   holds two "ss" lines (a 10-s and a 7.5-s mix: the separation cascade,
   its SE phase riding the first engine run with the other lines, then TSE
   and rTSE for every segment against enrollment rows made on the card)
   and an SE line whose mix is a 44.1 kHz wav (resampled to 16 kHz on the
   card). Checks: 32 global and 250 semantic ids in range per segment,
   finite output wavs of the input's length (of the 16 kHz length for the
   resampled line; ``<stem>_s1.wav`` and ``<stem>_s2.wav`` for each "ss"
   line), each kernel launched 12 times per decode step, no plain
   attention run, and every enrollment the cascades' TSE/rTSE requests
   carried a CUDA tensor. Then, on two segments in fp32, teacher-forced decode
   steps through the kernels agree with the plain attention path: max
   |logit difference| within 1e-4. On the fp32 pools those steps leave, K7
   (a seeded random q, every layer, each engine's block tables and
   positions) equals K1 on the owner engine's regions and K3 on the plain
   engine's allocator tables, within the fp32 tolerance above.
4. HCodec-1.0 round trip: ``unified_audio_tpu_torch.cli codec --model
   hcodec10`` on a synthetic 10-s 16 kHz wav at full width with random
   weights, the plain VQ functions made to raise. Checks: codes (1, 4, 250)
   per stream in [0, 1024), a finite output wav of the input's length, K6
   launched exactly twice. Then the round trip's rtfx (audio seconds over
   the median wall time of 10 synchronized tokenize + detokenize runs); the
   staged encode (K5, one launch per layer) on the round trip's own latents
   against K6 under the near-tie rule; and the round trip with the plain
   VQ: codes equal in >= 99.9% of places and, where all are equal, the
   waveforms within 1e-5.
5. HCodec-2.0 round trip: ``cli codec --model hcodec20`` on a synthetic
   10-s 48 kHz wav at full width (``hcodec20_config()``: 1536-wide STFT
   encoder and decoder, 16 x 1024 codes a stream; HuBERT-base on the
   16-kHz resample; fp32, TF32 off) with random weights, the plain VQ
   functions made to raise. Checks: codes (1, 16, 125) per stream in [0,
   1024), a finite 48 kHz output of 480,000 samples, K6 launched exactly
   twice. The encoder's STFT on the card (cuFFT) against the same frames
   on the CPU: the DC and Nyquist bins' imaginary parts +0.0 and their
   phase equal (the line also counts the -0.0 that cuFFT itself gives
   there, before the STFT pins the sign). K6 at nq = 16 (every codebook
   slot of a launch) at M = 125 (the clip) and M = 1184 (32 clips of 3 s)
   against the plain search under ``judge_codes``, timed in turns, each M
   after its plan line. The rtfx of one 10-s clip (median of 10
   synchronized tokenize + detokenize runs) and of the
   ``benchmarks/bench_hcodec20.py`` configuration (encode + decode of 32
   clips of 142,080 samples with random HuBERT-shaped features, median of
   5, rtfx = 32 x 3 s over it, as that script counts). The round trip with
   the plain VQ: codes equal in >= 99.9% of places.
6. UniTok-audio at full width (``UniTokConfig``: 8 codebooks of 1024, LM
   512 x 12 layers, 8 heads of 64; bf16) over phase 4's HCodec-1.0, the
   plain attention paths made to raise. (a) ``UniTokEngine.run`` in the
   stream mode over an int8 pool (K4): 24 requests over the 7 tasks on 5-s
   synthetic inputs (250 HuBERT frames, 125 codec frames), VC/TSE with a
   2-s reference, LASS with 20 random caption frames, half sampled; codes
   (125, 8) in [0, 1024), through ``UniTokPipeline.codes_to_audio`` to
   finite 80,000-sample wavs, K4 launched 12 times per decode step, every
   bound a 64-block bucket within the pool. (b) One bf16 pool and one
   ``BlockAllocator`` shared by a UniSE engine (phase 3's LM) and a UniTok
   engine, both in the stream mode, stepped in turn (K3): disjoint blocks,
   outputs in range, K3 launched 12 times per step of each engine, no block
   left held; after the first steps, K7 with each engine's tables and
   positions equals K3 on the mask they give (bf16 tolerance, every
   layer). (c) Teacher-forced fp32 decode through K3 (fp32 pool) and K4
   (int8 pool) against the plain attention: max |logit difference| within
   1e-4. Prints UniTok codes per second of engine wall time.
7. UniSE SFT training at full width through ``cli train-unise`` (the LM
   512 x 12, 8 heads of 64; XLSR-53, 24 x 1024, and WavLM-base-plus
   frozen; the BiCodec encoder and speaker encoder; batch 32 x 5 s; fp32,
   TF32 off). Synthetic SCP lists (4 speakers x 3 utterances of 6 s of
   ``synth_speech``, a noise, an RIR) feed the host simulation; the config
   is ``configs/unise.yaml`` with the SCP paths, 30 steps
   (``samples_per_epoch``) of one epoch, a 5-step warmup, validation on
   the same lists every 15 steps (2 batches) and the checkpoint directory
   changed (printed). Checks: every step's loss finite, the validation
   loss lower at step 30 than at 15, a checkpoint at step 30. Prints the
   median step wall time over steps 5-30, training tokens/s (32 x 283
   targets a step), the device time of the frozen tokenize + features,
   the LM's forward + backward and the update (CUDA events), the host's
   wait between steps, the card's busy share over profiled step 20 and
   the peak memory allocated. Then one TSE batch of 2 x 5 s from a seed
   through the trained stack on the card and on a CPU copy: tokens equal
   in >= 99.9% of places, the loss within 1e-4 relative, each LM gradient
   within 1e-3 of its largest entry. A second ``train-unise`` on the same
   checkpoint directory must say it resumed at step 30 and run its first
   step at the schedule's rate for step 30. Last, ``cli serve --ckpt`` on
   the step-30 checkpoint with the int8 pool: a 10-s TSE line (2
   segments), K2 launched 12 times a decode step, a finite output of the
   input's length.
8. HCodec-1.0 GAN training at full width through ``cli train-codec``
   (``hcodec10_config()``: the SEANet encoder's convs trained as weight
   norm (g, v), 2 x 4 EMA codebooks of 1024 x 512 with k-means on the
   first batch and quantizer dropout, the semantic decoder; HuBERT-base
   frozen; MPD 2/3/5/7/11 + MS-STFT 1024/256, 2048/512, 512/128; batch 8 x
   3 s; fp32, TF32 off), the plain VQ search made to raise. The config is
   ``configs/hcodec10.yaml`` with only these changes (printed): a
   ``dataset`` of synthetic domain SCP lists (6 speech-like tone wavs as
   "speech", 6 noise wavs as "audio", 4 s each), 30 steps
   (``max_steps``), ``train.perceptual_start_step`` 10 (steps 11-30 run
   the adversarial terms and the discriminator) and the checkpoint
   directory in a temporary directory. Checks: every loss finite; the mel
   loss's mean over steps 26-30 below its mean over steps 1-5 within each
   domain seen in both (a batch is one domain's); after step 1 all 8
   layers initted with cluster sizes summing to the 600 rows a layer
   searches (the EMA of k-means' bins and the batch's counts); K5
   launched exactly 8 x 30 + 8 x 51 times (each layer's search a step,
   k-means' 50 iterations and final bins on step 1). Prints the median
   step wall time over steps 5-30, audio seconds trained a second (8 x 3
   s over it), the device time (CUDA events) of the HuBERT features, the
   generator's forward + backward, the discriminator's and the two
   updates, the host's time between steps, the busy share of profiled
   step 20 and the peak memory the run allocated beyond what the earlier
   phases hold. Then one generator step with
   the GAN terms of the trained codec on 2 x 3 s on the card and on a CPU
   copy (the same dropout cutoffs): the card's codes under
   ``judge_codes`` and equal to the CPU's in >= 99.9% of places, the
   losses within 1e-4 relative, each generator gradient within 1e-3 of
   its largest entry. K5 on the first layer's k-means start (600 rows
   against 1024 rows drawn from them with replacement, duplicates in
   different CTAs) equal to the plain search exactly, timed against it.
   Last, ``cli codec --ckpt`` on the step-30 checkpoint (weight norm
   folded on load) with a 10-s clip: K6 launched twice, codes (1, 4, 250)
   in [0, 1024), a finite output of the input's length.
9. The JAX CLI's remaining commands at full width, random weights. (a)
   ``cli enhance --mode se`` on a 7.5-s synthetic noisy wav (2 segments;
   the LM fp32), then ``--mode ss`` on it: outputs finite at the input's
   length, tokens in range; the generated tokens per second. The tokens
   of every generate call (SE; ss's SE, TSE and rTSE, the latter two with
   the enrollment the card's SE made) are teacher-forced through a CPU
   copy of the WavLM and LM: every card token within 1e-4 (relative) of
   the CPU's top logit in its range; prints the share equal to the CPU's
   argmax and the first step where they part. (b) ``cli codec --dtype bfloat16`` for ``hcodec10`` and
   ``hcodec20`` on 10-s clips, the plain VQ made to raise: K6 twice a
   round trip, the codec and its LSTMs in bf16, a finite output; the codes
   of a fp32 build of the same seed equal in >= 0.75 of places; K6's codes
   on the bf16 path's own fp32-cast latents under ``judge_codes``; their
   agreement with a bf16-rounded residual (the JAX package's bf16 encode;
   K6 keeps it fp32), by layer; the decode SNR of the same codes, bf16
   against fp32, above 15 dB; fp32 and bf16 round trips timed in turns,
   median of 10. (c) ``cli eval --mode se --spk-sim --utmos-ckpt`` (a
   random UTMOS head the smoke writes) over 4 noisy/clean pairs of 5 s:
   every metric finite; seconds an utterance. Then
   ``roundtrip_codec_eval`` through the bf16 HCodec-1.0 on the clean
   clips: K6 twice a clip.
10. HCodec-1.5 adaptive and FlexiCodec at full width, random weights, fp32
   with TF32 off, one 10-s 16 kHz clip each. (a) ``cli codec --model
   hcodec15`` (``adaptive15_config()``, XLSR-53), the plain VQ made to
   raise: K6 twice a round trip; codes (1, 4, 250) with the group lengths
   injected (lengths summing to 250, at most 8, -1 at the padding groups
   after the last valid one), the token rate the groups over 10 s, the
   output finite at the input's length; K6 on the live aggregated groups
   (M = 250, the padding groups' rows zero) under ``judge_codes`` and equal
   to tokenize's codes, timed against the plain search; the round trip's
   median wall of 5, its device time, busy share and kernel launches
   (``profile_roundtrip.profile_calls``); a CPU copy of the same weights:
   the group ids equal up to the first similarity within 1e-5 of the
   threshold (the count of such similarities printed), and, with none,
   the codes equal in >= 99.5% of places. (b) ``cli codec --model
   flexicodec`` with each semantic stream: the log-fbank fallback,
   ``--cmvn`` (a synthetic 560-dim ``am.mvn`` the smoke writes) and
   ``--cmvn --sensevoice-ckpt`` (a random funasr-layout SenseVoiceSmall
   state dict the smoke writes at ``sensevoice_small_config()`` width):
   codes (1, 312, 9), a finite output; the FSQ and DAC codes of a CPU copy
   equal in >= 99.9% of places; the round trip timed as in (a).
11. The causal codecs and the remaining training objectives at full
   width, random weights, fp32 with TF32 off. (a) ``cli train-codec`` of
   ``configs/hcodec10.yaml`` plus ``codec: {causal: true}``, 10 steps of
   8 x 3 s on phase 8's synthetic domains (the GAN terms from step 6), the
   plain search made to raise: a causal encoder built, every loss finite,
   K5 launched 8 x 10 + 8 x 51 times; the median step wall, audio s/s and
   the busy share of profiled step 8; then ``codec_agreement`` on the
   trained causal codec. (b) A 10-s 16 kHz clip through a causal
   HCodec-1.0 and a 10-s 48 kHz clip through a causal HCodec-2.0
   (``HCodecTokenizer``): K6 twice a round trip, codes (1, 4, 250) and (1,
   16, 125); a CPU copy's search, layer by layer on its own latents with
   the card's earlier codes, equal to the card's codes in >= 99.5% of
   places and every other one a near tie (``judge_codes``); the rtfx,
   median of 5; the acoustic encoder's latents, with the clip's second
   half replaced, unmoved (<= 1e-5 of their max) for the frames whose
   receptive field ends before it and moved (> 1e-3) for the others. (c)
   HCodec-1.5's training forward + backward (``adaptive15_config()``,
   ``trainable``) on 4 x 3 s with XLSR-53 features, three steps (k-means
   on the first: K5 8 x 52, then 8 a step): steps 1 and 2 profiled
   (device time, launches), step 3's wall unprofiled; row 0
   from the initial state with the same k-means rows and dropout cutoffs
   on the card and on a CPU copy: the loss terms within 1e-4 relative, the
   gradient norms of the encoder, the aggregators, the bottleneck and the
   decoder within 1e-3, the group ids equal up to the first similarity
   within 1e-5 of the threshold. (d) FlexiCodec's training forward +
   backward on 4 x 3 s (the log-fbank stream, a random HuBERT-base's
   ``teacher_features`` as the distillation target) in the DualCodec and
   the aligned mode: wall (median of 3), device time, busy share, launches;
   row 0 on a CPU copy: commit and distill losses within 1e-4 relative,
   ``recons`` within 1e-4 of its peak, DAC codes >= 99.9% equal. (e) 16
   synthetic 5-s wavs through ``tokenize_corpus`` on the card's BiCodec
   tokenizer (one shard), then 20 ``PretrainTrainer`` steps at
   ``LlamaConfig()`` width fed by ``TokenCorpusIterator`` (batch 16 x (32
   + 250)): the step wall, training tokens/s, the loss and accuracy; step
   1's loss within 1e-4 of a CPU copy's. (f) ``UniTokPipeline.train_loss``
   forward + backward with the full-width UniTok LM (fp32) over phase 4's
   HCodec-1.0 tokenizer, tasks "codec" and "tse" (a reference wav), 4 x 5
   s: K6 twice a call (the target's tokenize), the wall;
   row 0's loss and accuracy within 1e-4 of a CPU copy of the LM on the
   same codes and features, the CPU tokenizer's target codes >= 99.5%
   equal to the card's.
12. Parallel training (``parallel/*``) through NCCL at world size 1 (one
   card), at full width, random weights, fp32 with TF32 off; prints the
   NCCL version and the world size. (a) ``torchrun --standalone
   --nproc_per_node 1 -m unified_audio_tpu_torch.cli train-unise`` on phase
   7's configuration (32 x 5 s, ``tp: 1``, one data worker so that the
   batches are the seed's), 8 steps: the command must say it joined an
   NCCL group of 1 on the (dp 1, tp 1) mesh; steps 1-2's loss and accuracy
   within 1e-5 relative of the same configuration's run without
   ``torchrun`` (2 steps, in this process); the median step wall (metrics
   records, steps 3-8) beside phase 7's. (b) ``CodecGANTrainer`` at
   HCodec-1.0's full width against the full discriminator ensemble, 5
   steps of 8 x 3 s (the GAN terms from step 3), without a mesh and with
   the (dp 1) mesh of an in-process NCCL group, both on deterministic
   kernels (``torch.use_deterministic_algorithms``, cuDNN's): every
   metric and the EMA buffers within 1e-5; K5's launches in the mesh run
   8 a step + 8 x 51 for k-means, each search's codes equal to the plain
   search's; both runs' median step walls beside phase 8's. (c)
   ``llama_pipeline_forward`` (pp = 1, 2 microbatches) and
   ``llama_sequence_parallel_forward`` (sp = 1) of the 512 x 12 LM on 4 x
   540 positions within 1e-5 of the dense backbone. The group is destroyed
   at the end.
13. The serving engines' API at phase 3's width (LM 512 x 12, bf16, 16
   slots): (a) 20 five-second segments as ``cli serve`` makes them (SE,
   TSE, rTSE, half sampled, mixes and 5-s enrollments on the int16 wire,
   one 3-s enrollment as exact-length features made on the card) on an
   int8 pool (K2), served in turns by the displacing ``run`` and by the
   admit/step/harvest loop, three passes each: greedy tokens equal in all
   passes, K2 launched 12 times a decode step, every block returned; both
   serving rates (median of 3) and the run's host split (``t_prestage``,
   ``t_admit``, ``t_step``, ``t_drain``, ``t_harvest``, stash fetches,
   step calls). (b) A request cancelled after 40 steps on a two-slot bf16
   pool (K1): its slot done on the card at once, the survivor's tokens
   equal to its solo run's, every block free. (c) The int8 feature wire
   against the bf16 one on 16 segments of host WavLM features: the card's
   dequant equal to q * 2^e, the feature SNR, the token agreement. (d) In
   (a), every request of a run staged by ``prestage`` (the first wave
   before admission, the next during the first decode chunk), its tokens
   those of the loop's admission-time staging. (e) UniTok in the owner
   mode with displacing admission: phase 6's 24 requests on an int8 pool
   (K2) and 16 on a bf16 pool (K1), codes in range, launches 12 a step,
   one stash fetch; teacher-forced fp32 decode through K1 and K2 against
   the plain attention within 1e-4.
14. The last modules, fp32 with TF32 off, seeded weights, each against
   the same module on the CPU (max abs err <= 1e-4 x max(1, max |cpu|)):
   (a) HCodec-1.0's PriorNet transformer (768 wide, 12 heads, 2 layers)
   with routed experts (3, top-1) on 500 frames; (b) the ring-KV
   streaming transformer at Mimi's width (512, 8 heads, context 16, 32
   layers) on a 10-s clip's 250 frames, and streamed on the card in chunks
   of 1 and 4 (rings of 16 and 19) against its own offline forward within
   1e-4, with the time a chunk; (c) the conformer at UniSE's width (6 x
   512) on 500 frames; (d) GRVQ at HCodec-2.0's latent width (512, 2
   quantizers of two 1024-code groups of 8) on 125 frames, each quantizer
   judged on the CPU's residual: indices equal or near ties (fp64 cosines
   within 1e-5); (e) the SEANet decoder, the inverse of HCodec-1.0's
   encoder, 500 frames to 160,000 samples; (f) the native loader built
   with g++ here: wavs read bit-equal to the Python reader, 20 pinned
   batches of 8 x 4 s copied to the card without blocking and checked
   there; (g) ``utils/profiling.py`` around UniSE decode steps on an int8
   pool at serving width: ``StepTimer(device="cuda")`` at or above each
   step's CUDA-event time, and ``trace`` of one step whose Chrome trace
   names K2's kernel and the recorder's spans; K2 launched 12 times a
   step. Prints the phase's time.
15. The last public callables, fp32 with TF32 off: (a) UniSE's LM
   (``LlamaConfig()``, 512 x 12) with 16 slots prefilled to depths 40 + 37
   i into a dense cache of 1,024 positions and, the same prompts, into an
   owner pool (14-block regions of 64-token blocks); 32 greedy steps
   through ``CodecLM.decode_ids_multi`` (each slot at its own depth) and
   through ``paged_decode_ids(use_kernel="owner")`` (K1): logits within
   2e-4 (the JAX package's own bound for this comparison), greedy ids
   equal, K1 launched 12 times a step; ms a step of each path (CUDA
   events) and, over 4 more steps under the profiler, device ms and
   records a step. (b) ``UniSE.stft_logmel`` of a 10-s clip (640, 320,
   80 mels) and ``mdct``/``imdct`` at a frame of 512 ("same", "center")
   against the CPU (1e-4 x max(1, max |cpu|)), and the round trip's
   error. (c) The TAP, TSDP and TSTP pooling heads on 500 x 1536 speaker
   features and ``FactorizedVectorQuantize.decode_latents`` (8192 codes
   of 8) on 500 frames against the CPU: indices equal or near ties (fp64
   cosines within 1e-5). Prints the phase's time.
16. No module of jax, flax or the JAX package (``unified_audio_tpu``) was
   loaded at all.

Prints the rates, a JSON line of the kernels (launches from the paths
above, each kernel's time, its plain version's and its bound; K1's
launches are phases 3's, 13's and 15's, K2's phases 3's, 13's and 14's, and
phase 7 prints its own
serve's; K5's are
phase 4's staged encode, phase 8's training, phase 11's causal
training and HCodec-1.5 training forwards and phase 12's dp codec
training, and its ``kmeans_m600``
entry the times on k-means' start at M = 600; K6's are the round trips'
(phases 4, 5, 8, 9's two bf16 ones and ``roundtrip_codec_eval``, 10's
HCodec-1.5 one and 11's causal ones) and phase 11's UniTok
``train_loss`` tokenizes, its ``nq16`` entry the times at HCodec-2.0's shapes
and its ``hcodec15_groups`` entry those at HCodec-1.5's aggregated
groups; K7's launches are those of the serving paths, 0, and the smoke's
own check calls are printed on the line before; K8's are phase 2's
Moonlight serving run's, its timing calls printed on that line), and as
its last line the device JSON object.
"""
import dataclasses
import itertools
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
L = 12  # LM layers: each decode step launches K1 or K2 once per layer
K1_TPU = "unified_audio_tpu/ops/pallas/paged_attention.py:602"
K2_TPU = "unified_audio_tpu/ops/pallas/paged_attention.py:540"
K3_TPU = "unified_audio_tpu/ops/pallas/paged_attention.py:668"
K4_TPU = "unified_audio_tpu/ops/pallas/paged_attention.py:295"
K7_TPU = "unified_audio_tpu/ops/pallas/paged_attention.py:94"
K5_TPU = "unified_audio_tpu/ops/pallas/vq_kernel.py:45"
K6_TPU = "unified_audio_tpu/ops/pallas/vq_kernel.py:148"
SOURCE = "unified_audio_tpu_torch/csrc/paged_attention.cu"
LATENT_SOURCE = "unified_audio_tpu_torch/csrc/latent_attention.cu"
# K8 at the Moonlight serving cell's shapes: 64 slots, 27 layers, 16 heads
# over 576-wide latent rows (rank 512), 64-row blocks in 14-block regions;
# SE prompts of 252 positions, TSE of 504 (a quarter), 0-283 generated; the
# prefill a wave of 64 x 504 positions
LATENT = dict(slots=64, layers=27, heads=16, width=576, rank=512, bs=64,
              region=14, prompts=(252, 504), tse_share=0.25, generated=283,
              prefill=504)
# K8's main path: the Moonlight serving engine at published widths, cut to
# 2 layers (the dense layer 0 and one of routed experts), 64 slots of 5-s
# mixtures (250 WavLM frames of 768), half of them TSE with an enrollment
MOONLIGHT = dict(layers=2, slots=64, feats=768, frames=250, max_global=32,
                 max_semantic=256, steps=32 + 1 + 250)
VQ_SOURCE = "unified_audio_tpu_torch/csrc/vq.cu"
# NVIDIA H100 SXM data sheet: HBM3 rate, dense bf16 and TF32 tensor and fp32
# peaks
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
SR = 16000
SR20 = 48000  # HCodec-2.0's rate
CLIP_S = 10.0  # the round trip's clip, as bench.py times it
VQ_SHAPES = dict(n=1024, d=512, nq=4)  # HCodec-1.0: 4 x 1024 codes of 512
NQ20 = 16  # HCodec-2.0: 16 x 1024 codes of 512 a stream
K6_20_M = (125, 1184)  # one 10-s clip; 32 clips of 3 s (bench_hcodec20.py)
BENCH20 = dict(batch=32, seconds=3.0)  # benchmarks/bench_hcodec20.py
# the CUDA function each wrapper launches once a call (as the profiler
# names it), whose records the timer counts
CUDA_KERNELS = {"paged_flash_decode_owner": "owner_decode_kernel_tiled",
                "paged_flash_decode_owner_q8": "owner_decode_kernel_pipelined",
                "paged_flash_decode_stream_flat":
                    "stream_decode_kernel_pipelined",
                "paged_flash_decode_stream_flat_q8":
                    "stream_decode_kernel_pipelined",
                "paged_flash_decode": "table_decode_kernel_tiled",
                "latent_attention": "latent_attention_kernel",
                "vq": "vq_search_kernel"}
ITERS = 100  # calls per timed window of a decode kernel (50 for K5/K6)
PAD_S = 0.02  # idle time at each end of a profiled window
LEAD_IN = "spin_kernel"  # the kernel of torch.cuda._sleep (ATen's Sleep.cu)
# lead-in kernels a window opens with: sessions lost their first device
# record (windows of plain K1 calls) and two records, a call's first two
# kernels in a one-call window (plain K6 at nq = 16, 177 records a call;
# H100, torch 2.11); ~300 s into a run (phase 8) windows lost records past
# the 8 lead-ins: 4 and 5 of the plain K5 search's 8 in one-call windows,
# in another the K5 kernel's one record
LEAD_INS = 8


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def latent_case(torch, rng, layers):
    """K8's decode arguments at the serving cell's shapes: a bf16 pool of
    ``layers`` layers, owner regions, the cell's contexts -> (q, pool,
    tables, positions)."""
    c = LATENT
    nb = (c["slots"] + 1) * c["region"]
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1e9)))
    pool = torch.randn((layers, nb, c["bs"], c["width"]), generator=gen,
                       device="cuda").bfloat16()
    tables = (c["region"] + torch.arange(c["slots"] * c["region"],
                                         device="cuda")).view(
        c["slots"], c["region"]).int()
    prompt = np.where(rng.random(c["slots"]) < c["tse_share"],
                      c["prompts"][1], c["prompts"][0])
    pos = prompt + rng.integers(0, c["generated"] + 1, c["slots"])
    q = torch.randn((c["slots"], 1, c["heads"], c["width"]), generator=gen,
                    device="cuda").bfloat16()
    return q, pool, tables, torch.as_tensor(pos, dtype=torch.int32,
                                            device="cuda")


def latent_phase(torch, la, gpu):
    """K8 alone at the Moonlight serving cell's shapes (``LATENT``): the
    decode step's call (64 slots through their tables) warm on one layer
    and cold with the layer cycling 0..26, and the prefill's (a dense cache
    of 64 x 504, causal), each against the plain version in turns, with
    its error against fp32 and its bound: the decode's live rows (and q,
    the output) over 3.35 TB/s, the prefill's operations over the bf16
    peak or its bytes (q, cache, output), whichever is larger -> the
    kernels-line entry."""
    c = LATENT
    rng = np.random.default_rng(23)
    scale = (128 + c["width"] - c["rank"]) ** -0.5
    rank = c["rank"]
    q, pool, tables, pos = latent_case(torch, rng, c["layers"])
    live = int((pos.long() + 1).sum())
    row = c["width"] * 2
    io = 2 * q.numel() * 2 + tables.numel() * 4
    dec_bound = bound(live * row + io,
                      2 * live * c["heads"] * (c["width"] + rank), "bf16")

    def held(q_, rows, p0, tables_=None):
        got = la.latent_attention(q_, rows, p0, rank, scale, tables_)
        plain = la.latent_attention_ref(q_, rows, p0, rank, scale, tables_)
        exact = la.latent_attention_ref(q_.float(), rows.float(), p0, rank,
                                        scale, tables_)
        err = (got.float() - exact).abs().max().item()
        plain_err = (plain.float() - exact).abs().max().item()
        top = exact.abs().max().item()
        if not err <= plain_err + 2e-3 * top:
            fail(f"K8 max abs err {err} vs fp32, plain {plain_err} "
                 f"(scale {top})")
        return err, plain_err

    dec_err = held(q, pool[0], pos, tables)
    kernel = CUDA_KERNELS["latent_attention"]
    warm = in_turns(torch, [
        lambda: la.latent_attention_ref(q, pool[0], pos, rank, scale, tables),
        lambda: la.latent_attention(q, pool[0], pos, rank, scale, tables)],
        kernels=[None, kernel])
    layers = itertools.cycle(range(c["layers"]))
    cold = in_turns(torch, [
        lambda: la.latent_attention_ref(q, pool[next(layers)], pos, rank,
                                        scale, tables),
        lambda: la.latent_attention(q, pool[next(layers)], pos, rank, scale,
                                    tables)], kernels=[None, kernel])
    del pool
    torch.cuda.empty_cache()
    b, t = c["slots"], c["prefill"]
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1e9)))
    cache = torch.randn((b, t, c["width"]), generator=gen,
                        device="cuda").bfloat16()
    qp = torch.randn((b, t, c["heads"], c["width"]), generator=gen,
                     device="cuda").bfloat16()
    p0 = torch.zeros((b,), dtype=torch.int32, device="cuda")
    pre_err = held(qp, cache, p0)
    pairs = b * t * (t + 1) // 2
    pre_bound = bound(2 * qp.numel() + 2 * cache.numel()
                      + 2 * b * t * c["heads"] * rank,
                      2 * pairs * c["heads"] * (c["width"] + rank), "bf16")
    pre = in_turns(torch, [
        lambda: la.latent_attention_ref(qp, cache, p0, rank, scale),
        lambda: la.latent_attention(qp, cache, p0, rank, scale)],
        iters=10, kernels=[None, kernel])
    print(f"K8 latent_attention decode at the Moonlight cell's shapes (64 "
          f"slots, {live} live rows, {live * row / 1e6:.1f} MB): max abs err "
          f"{dec_err[0]:.3e} vs fp32 (plain {dec_err[1]:.3e}); kernel "
          f"{warm[1]['ms'] * 1e3:.2f} us warm, {cold[1]['ms'] * 1e3:.2f} us "
          f"cold (layers 0..26); plain {warm[0]['ms'] * 1e3:.2f} / "
          f"{cold[0]['ms'] * 1e3:.2f} us; bound {dec_bound[0] * 1e3:.2f} us "
          f"({dec_bound[1]}); wall with dispatch {warm[1]['wall_ms'] * 1e3:.1f}"
          f" us | {gpu}", flush=True)
    print(f"K8 latent_attention prefill of 64 x 504 (causal): max abs err "
          f"{pre_err[0]:.3e} vs fp32 (plain {pre_err[1]:.3e}); kernel "
          f"{pre[1]['ms'] * 1e3:.1f} us, plain {pre[0]['ms'] * 1e3:.1f} us, "
          f"bound {pre_bound[0] * 1e3:.1f} us ({pre_bound[1]}; "
          f"{2 * pairs * c['heads'] * (c['width'] + rank) / 1e9:.1f} GFLOP) | "
          f"{gpu}", flush=True)
    return {"name": la.latent_attention.__name__, "route": "cuda",
            "source": LATENT_SOURCE,
            "replaces": "none (the JAX package has no latent attention)",
            "max_abs_err": dec_err[0], "ms": warm[1]["ms"],
            "plain_ms": warm[0]["ms"], "bound_ms": dec_bound[0],
            "bound_by": dec_bound[1], "library_ms": None,
            "cold_ms": cold[1]["ms"], "cold_plain_ms": cold[0]["ms"],
            "records": warm[1]["records"] + cold[1]["records"],
            "prefill": {"ms": pre[1]["ms"], "plain_ms": pre[0]["ms"],
                        "bound_ms": pre_bound[0], "bound_by": pre_bound[1],
                        "max_abs_err": pre_err[0]}}


def moonlight_phase(torch, la, gpu):
    """K8 on its main path (``MOONLIGHT``): the Moonlight engine admits
    64 requests and runs its decode steps, replayed as a CUDA graph after
    the first, with K8's launch count set to 0 first; fails unless every
    request completes and the count is layers x (prefill waves + steps)
    -> that count."""
    from unified_audio_tpu_torch.models.lm.moonlight import MoonlightConfig
    from unified_audio_tpu_torch.models.lm.sft import build_sft
    from unified_audio_tpu_torch.serve.engine import (
        ContinuousBatchingEngine, Request, segment_chunks)
    from unified_audio_tpu_torch.utils.initialization import init_random_

    c = MOONLIGHT
    dev = torch.device("cuda")
    cfg = MoonlightConfig(num_layers=c["layers"])
    torch.set_default_dtype(torch.bfloat16)
    try:
        with dev:
            sft = build_sft(cfg, feats_dim=c["feats"])
    finally:
        torch.set_default_dtype(torch.float32)
    init_random_(sft, torch.Generator(device=dev).manual_seed(3))
    eng = ContinuousBatchingEngine(sft.eval(), num_slots=c["slots"],
                                   max_global=c["max_global"],
                                   max_semantic=c["max_semantic"],
                                   mix_buckets=(256,))
    if not eng._graphed or list(eng.pool) != ["kv"]:
        fail("the Moonlight engine does not replay its steps over a latent "
             "pool")
    rng = np.random.default_rng(29)

    def feats():
        return rng.standard_normal((c["frames"], c["feats"])).astype(
            np.float32)

    reqs = [Request(task_id=i % 2, mix_feats=feats(),
                    enroll_feats=feats() if i % 2 else None,
                    do_sample=i % 4 == 0, uid=i) for i in range(c["slots"])]
    gen = torch.Generator(device=dev).manual_seed(7)
    la.latent_attention.launches = 0
    t0 = time.perf_counter()
    if len(eng.admit_many(reqs)) != len(reqs):
        fail("the Moonlight engine did not admit every request")
    for n in segment_chunks(c["steps"], 256):
        eng.step(n, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = eng.harvest()
    stats = eng.stats()
    launches = la.latent_attention.launches
    want = cfg.num_layers * (stats["prefill_waves"] + c["steps"])
    if launches != want or stats["graph_replays"] < c["steps"] - 2:
        fail(f"K8 launched {launches} times on the Moonlight engine, not "
             f"{cfg.num_layers} layers x ({stats['prefill_waves']} prefill "
             f"waves + {c['steps']} steps) = {want}; replays "
             f"{stats['graph_replays']}")
    if len(done) != len(reqs):
        fail(f"the Moonlight engine completed {len(done)} of {len(reqs)}")
    print(f"Moonlight engine ({cfg.num_layers} layers at published widths, "
          f"bf16, {c['slots']} slots): {stats['prefill_waves']} prefill "
          f"waves, {c['steps']} steps ({stats['graph_replays']} replayed) "
          f"in {wall:.2f} s; K8 launches {launches} = layers x (waves + "
          f"steps) | {gpu}", flush=True)
    del eng, sft
    torch.cuda.empty_cache()
    return launches


def profiled(torch, fn, n, lead_in=True):
    """-> (CUDA records by name, their summed us) of ``n`` calls of ``fn``
    under torch.profiler (CUPTI). The window opens PAD_S before the first
    call and closes PAD_S after the card is done: the profiler keeps only
    the device records whose timestamps, mapped to the host's clock, fall
    inside its window. A session can also lose its first device records,
    so the window starts with a lead-in: ``LEAD_INS`` ``torch.cuda._sleep``
    kernels (``LEAD_IN``), waited for and left out of the result, then PAD_S
    more (``lead_in=False`` leaves it out, for ``profiler_windows.py``).
    The loss takes the first records, so a window that kept a lead-in
    record kept every call's; one that kept none is opened again with 8
    times the lead-ins (twice at most)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    tries = (LEAD_INS, 8 * LEAD_INS, 64 * LEAD_INS) if lead_in else (0,)
    for lead_ins in tries:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PAD_S)
            if lead_ins:
                for _ in range(lead_ins):
                    torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                time.sleep(PAD_S)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            time.sleep(PAD_S)
        counts, us, leads = Counter(), 0.0, 0
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if LEAD_IN in ev.name:
                leads += 1
            else:
                counts[ev.name] += 1
                us += ev.time_range.elapsed_us()
        if leads or not lead_ins:
            return counts, us
        print(f"chip_smoke: a window lost all {lead_ins} lead-in records",
              flush=True)
    fail(f"windows lost all of {tries} lead-in records")


def time_ms(torch, fn, iters, kernel=None):
    """-> (device ms, wall ms, records) per call of ``fn``. Device: the time
    of the CUDA records (kernels, copies) that ``iters`` calls leave under
    torch.profiler, summed. The records are counted by name: the window
    must hold ``iters`` times the records of one profiled call, name for
    name, and one call must launch exactly one kernel whose name holds
    ``kernel`` (where given); a window that does not is timed once more,
    then the run fails. ``records`` counts the window's ``kernel`` records.
    Wall: CUDA events around ``iters`` back-to-back calls; it holds the
    host's dispatch too wherever the host is slower than the card, as it is
    for a small decode kernel behind its wrapper's Python checks."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    per_call, _ = profiled(torch, fn, 1)
    mine = sum(n for name, n in per_call.items() if kernel and kernel in name)
    if kernel is not None and mine != 1:
        fail(f"one call left {mine} records of {kernel}: {dict(per_call)}")
    want = {name: iters * n for name, n in per_call.items()}
    for _ in range(2):
        counts, us = profiled(torch, fn, iters)
        if dict(counts) == want and us > 0:
            return (1e-3 * us / iters, a.elapsed_time(b) / iters,
                    iters * mine)
        print(f"chip_smoke: {sum(counts.values())} CUDA records in a window "
              f"of {iters} calls, {sum(want.values())} expected; timing it "
              "again", flush=True)
    fail(f"the profiler's records of {iters} calls do not match one call's "
         f"{dict(per_call)}: {dict(counts)}")


def in_turns(torch, fns, iters=ITERS, kernels=None):
    """Times each of ``fns`` twice, in the order f0, f1, ..., f1, f0 (the
    versions alternate) -> [{"ms": device ms, "wall_ms": wall ms,
    "records": the records of ``kernels[i]`` over both windows}], the two
    timings of each averaged. ``kernels[i]`` names the one kernel a call of
    ``fns[i]`` launches (None for a plain version or a library call)."""
    n = len(fns)
    kernels = kernels or [None] * n
    t = [time_ms(torch, fns[i], iters, kernels[i])
         for i in list(range(n)) + list(range(n))[::-1]]
    return [{"ms": (t[i][0] + t[2 * n - 1 - i][0]) / 2,
             "wall_ms": (t[i][1] + t[2 * n - 1 - i][1]) / 2,
             "records": t[i][2] + t[2 * n - 1 - i][2]}
            for i in range(n)]


def cycling(call):
    """-> a function that calls ``call(0)``, ``call(1)``, ..., ``call(L -
    1)``, ``call(0)``, ...: one layer after another, as a decode step does,
    so that each call finds its layer's rows out of L2 (the 12 layers'
    pools far exceed its 50 MB)."""
    layers = itertools.cycle(range(L))
    return lambda: call(next(layers))


def at_layer(args, pos, li):
    out = list(args)
    out[pos] = li
    return out


def timed(torch, kernel, ref, args, li_pos, lib_at=None, rows=None):
    """The plain version, the kernel and, where given, the library call
    (``lib_at(li)`` builds it for layer ``li``) timed in turns, warm (100
    calls on layer ``args[li_pos]``) and cold (the layer cycling 0..11) ->
    {"ms"/"wall_ms": the kernel's warm, "plain_ms"/"plain_wall_ms": the
    plain version's, "library_ms" (None without ``lib_at``),
    "library_err": its max abs error against the plain version on the (S,)
    bool ``rows``, "cold_ms", "cold_plain_ms", "cold_library_ms": the
    device times of the cold calls, and "records": the kernel's CUDA
    records over its four timed windows}."""
    fns = [lambda: ref(*args), lambda: kernel(*args)]
    names = [None, CUDA_KERNELS[kernel.__name__]]
    cold = [cycling(lambda li: ref(*at_layer(args, li_pos, li))),
            cycling(lambda li: kernel(*at_layer(args, li_pos, li)))]
    out = {"library_ms": None, "cold_library_ms": None}
    if lib_at is not None:
        lib = lib_at(args[li_pos])
        fns.append(lib)
        want = ref(*args)[rows].float()
        got = lib()[0].transpose(0, 1)[rows].float()
        out["library_err"] = (got - want).abs().max().item()
        libs = [lib_at(li) for li in range(L)]
        cold.append(cycling(lambda li: libs[li]()))
    names += [None] * (len(fns) - 2)
    t = in_turns(torch, fns, kernels=names)
    out.update(t[1], plain_ms=t[0]["ms"], plain_wall_ms=t[0]["wall_ms"])
    c = in_turns(torch, cold, kernels=names)
    out.update(cold_ms=c[1]["ms"], cold_plain_ms=c[0]["ms"],
               records=t[1]["records"] + c[1]["records"])
    if lib_at is not None:
        out["library_ms"] = t[2]["ms"]
        out["cold_library_ms"] = c[2]["ms"]
    return out


def check_kernel(torch, pa, kernel, ref, dtype, quant):
    """K1 (float pool) or K2 (int8 pool) against its plain version at the
    UniSE serving shapes -> {"err": max abs error vs the fp32 plain result,
    "bound": (ms, bound by), and the times of ``timed``, K1's with its
    library call on the active slots}."""
    args = pa.serving_case(quant, dtype, "cuda")
    err, ok = pa.compare_with_plain(kernel, ref, args)
    if not ok:
        fail(f"{kernel.__name__} {dtype}: max abs err {err} outside "
             "tolerance, or inactive slots not zero")
    lib_at = None if quant else (
        lambda li: owner_sdpa_call(torch, at_layer(args, -1, li)))
    return {"err": err, "bound": owner_bound(args, quant),
            **timed(torch, kernel, ref, args, -1, lib_at, args[-2] >= 0)}


def report(name, kernel, dtype, r, gpu):
    lib = ("" if r.get("library_ms") is None else
           f"; scaled_dot_product_attention {r['library_ms'] * 1e3:.1f} us "
           f"(max abs err {r['library_err']:.3e} vs plain)")
    cold_lib = ("" if r.get("cold_library_ms") is None else
                f", library {r['cold_library_ms'] * 1e3:.1f} us")
    print(f"{name} {kernel.__name__} q {str(dtype)[6:]}: max abs err "
          f"{r['err']:.3e} vs fp32 plain; device time per layer call: kernel "
          f"{r['ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us{lib}, "
          f"bound {r['bound'][0] * 1e3:.2f} us ({r['bound'][1]}); cold "
          f"(layers 0..11 in turn): kernel {r['cold_ms'] * 1e3:.2f} us, "
          f"plain {r['cold_plain_ms'] * 1e3:.2f} us{cold_lib}; wall per "
          f"call with dispatch: kernel {r['wall_ms'] * 1e3:.1f} us, plain "
          f"{r['plain_wall_ms'] * 1e3:.1f} us; {r['records']} kernel records "
          f"timed | {gpu}", flush=True)


def bound(bytes_moved, ops, ops_type):
    """-> (ms, "bytes" or "operations"): the least time the card could take,
    the larger of bytes over the HBM rate and operations over the peak."""
    t_bytes = bytes_moved / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[ops_type]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def owner_bound(args, quant):
    """Bound of one K1 or K2 call on ``args``: the live prefix's K and V
    rows read once (and, for the int8 pool, their scales), q, the start
    blocks and positions read and the output written once; two dot products
    of the head dim per key and head, at the rate of q's type."""
    q, index = args[0], args[-2].cpu()
    tokens = int((index[index >= 0] + 1).sum())
    h, hd = q.shape[1], q.shape[2]
    moved = (2 * tokens * h * hd * args[1].element_size()
             + 2 * q.numel() * q.element_size() + 2 * index.numel() * 4)
    if quant:
        moved += 2 * tokens * 4
    return bound(moved, 4 * tokens * h * hd,
                 "fp32" if q.element_size() == 4 else "bf16")


def stream_bound(args, quant):
    """Bound of one K3 or K4 call on ``args``: the K and V rows any slot
    sees read once (and, for the int8 pool, their scales), the visibility
    mask, q and the output; two dot products of the head dim per visible
    (slot, key) pair and head, at the rate of q's type."""
    q, seen = args[0], args[-3] != 0
    keys = int(seen.any(0).sum())
    h, hd = q.shape[1], q.shape[2]
    moved = (2 * keys * h * hd * args[1].element_size() + seen.numel()
             + 2 * q.numel() * q.element_size())
    if quant:
        moved += 2 * keys * 4
    return bound(moved, 4 * int(seen.sum()) * h * hd,
                 "fp32" if q.element_size() == 4 else "bf16")


def sdpa_call(torch, args):
    """K3's function as one library call: scaled_dot_product_attention of
    q (1, H, S, hd) against the prefix as (1, H, nb*BS, hd) under the
    boolean visibility mask, inputs permuted beforehand."""
    q, kpool, vpool, vis, li, nb = args
    s, h, hd = q.shape

    def heads_first(pool):
        return pool[li, :nb].reshape(-1, h, hd).transpose(0, 1)[None] \
            .contiguous()

    qh = q.transpose(0, 1)[None].contiguous()
    k, v = heads_first(kpool), heads_first(vpool)
    mask = (vis != 0)[None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qh, k, v, attn_mask=mask)


def owner_sdpa_call(torch, args):
    """K1's function as one library call: ``sdpa_call`` over the layer's
    pool prefix up to the last region's end (the first blocks plus the
    blocks the longest prefix spans) under the boolean mask of each slot's
    positions 0..index from its first block."""
    q, kpool, vpool, start, index, li = args
    bs = kpool.shape[2]
    nb = int(start.max()) + -(-(int(index.max()) + 1) // bs)
    key = torch.arange(nb * bs, device=q.device)
    first = start.long()[:, None] * bs
    vis = (key >= first) & (key <= first + index.long()[:, None])
    return sdpa_call(torch, [q, kpool, vpool, vis, li, nb])


def check_stream(torch, pa, kernel, ref, dtype, quant):
    """K3 (float pool) or K4 (int8 pool) against its plain version at the
    UniTok serving shapes -> the dict of ``check_kernel``, K3's with its
    library call on the rows with a visible key."""
    args = pa.stream_serving_case(quant, dtype, "cuda")
    empty = ~(args[-3] != 0).any(1)
    err, ok = pa.compare_with_plain(kernel, ref, args, empty=empty)
    if not (ok and bool(empty.any())):
        fail(f"{kernel.__name__} {dtype}: max abs err {err} outside "
             "tolerance, or rows with no visible key not finite zeros")
    lib_at = None if quant else (
        lambda li: sdpa_call(torch, at_layer(args, -2, li)))
    return {"err": err, "bound": stream_bound(args, quant),
            **timed(torch, kernel, ref, args, -2, lib_at, ~empty)}


def table_bound(args):
    """Bound of one K7 call on ``args``: the distinct K and V rows the
    active slots attend read once, q, the table entries the positions reach
    and the positions read and the output written once; two dot products
    of the head dim per attended (slot, position) pair and head, at the
    rate of q's type."""
    q, kpool, _, tables, index, _ = args
    bs, mb = kpool.shape[2], tables.shape[1]
    tables, index = tables.cpu().long(), index.cpu().long()
    pos = np.arange(mb * bs)
    seen = pos[None] <= index.numpy()[:, None]  # (S, MB*BS): table's only
    rows = tables.numpy()[:, pos // bs] * bs + pos % bs
    entries = int(np.minimum(-(-(index.numpy() + 1) // bs), mb).clip(0).sum())
    h, hd = q.shape[1], q.shape[2]
    moved = (2 * len(np.unique(rows[seen])) * h * hd * kpool.element_size()
             + 2 * q.numel() * q.element_size() + 4 * entries
             + 4 * index.numel())
    return bound(moved, 4 * int(seen.sum()) * h * hd,
                 "fp32" if q.element_size() == 4 else "bf16")


def check_table(torch, pa, kernel, ref, dtype, quant):
    """K7 against its plain version at ``table_serving_case`` -> the dict
    of ``check_kernel``, with its library call (``sdpa_call`` over the
    layer's whole pool under the visibility the tables give) judged on the
    active slots whose live prefix repeats no block."""
    from unified_audio_tpu_torch.serve.paged import table_visibility

    args = pa.table_serving_case(dtype, "cuda")
    err, ok = pa.compare_with_plain(kernel, ref, args)
    if not ok:
        fail(f"{kernel.__name__} {dtype}: max abs err {err} outside "
             "tolerance, or inactive slots not zero")
    q, kpool, vpool, tables, index, li = args
    nb, bs, mb = kpool.shape[1], kpool.shape[2], tables.shape[1]
    vis = table_visibility(tables, index, nb, bs)
    distinct = []
    for row, i in zip(tables.tolist(), index.tolist()):
        n = min(mb, i // bs + 1)
        distinct.append(i >= 0 and len(set(row[:n])) == n)
    return {"err": err, "bound": table_bound(args),
            **timed(torch, kernel, ref, args, -1,
                    lambda li: sdpa_call(torch, [q, kpool, vpool, vis, li,
                                                 nb]),
                    torch.tensor(distinct, device=q.device))}


@contextmanager
def uncounted(tally, *wrappers):
    """Kernel launches inside the block are the smoke's own check calls:
    they are added to ``tally`` (by wrapper name) and the wrappers' launch
    counts are left as they were."""
    saved = [w.launches for w in wrappers]
    try:
        yield
    finally:
        for w, n in zip(wrappers, saved):
            tally[w.__name__] = tally.get(w.__name__, 0) + w.launches - n
            w.launches = n


def table_on_live_pool(torch, pa, paged, eng, against, seed=11):
    """K7 on an engine's live pool, block tables and positions (-1 where a
    slot is inactive), a seeded random q, every layer, against K1
    (``against="K1"``: each table's first block as the region start) or K3
    (``"K3"``: the visibility the tables give over the whole pool) -> max
    abs error; fails outside ``compare_kernels``' tolerance."""
    from unified_audio_tpu_torch.serve.engine import PHASE_DONE

    st, k, v = eng.state, eng.pool["k"], eng.pool["v"]
    active = st["active"] if "active" in st else st["phase"] != PHASE_DONE
    index = torch.where(active, st["index"], -1).int()
    tables = st["block_tables"]
    g = torch.Generator(device=k.device).manual_seed(seed)
    q = torch.randn(len(index), k.shape[3] // 64, 64, generator=g,
                    device=k.device).to(k.dtype)
    if against == "K1":
        start = tables[:, 0].contiguous()

        def other(li):
            return pa.paged_flash_decode_owner(q, k, v, start, index, li)
    else:
        vis = paged.table_visibility(tables, index, k.shape[1],
                                     k.shape[2]).to(torch.int8)

        def other(li):
            return pa.paged_flash_decode_stream_flat(q, k, v, vis, li)
    worst = 0.0
    for li in range(k.shape[0]):
        err, ok = pa.compare_kernels(
            pa.paged_flash_decode(q, k, v, tables, index, li), other(li),
            index < 0)
        if not ok:
            fail(f"K7 against {against} on a live {k.dtype} pool, layer "
                 f"{li}: max abs err {err} outside tolerance")
        worst = max(worst, err)
    return worst


def vq_bound(m, n, d, nq):
    """Bound of an nq-layer search of M rows: x and the codebooks read
    once, the codes written once; 2 M N D operations per layer, each taken
    at fp32 accuracy as three TF32 products on the tensor cores (3xTF32, the
    kernel's route: three times the work at 495 TFLOP/s takes less time
    than fp32 at 67 TFLOP/s)."""
    return bound(4 * (m * d + nq * n * d + m * nq), 3 * 2 * nq * m * n * d,
                 "tf32")


def vq_plan_line(torch, vq, m, nq=VQ_SHAPES["nq"]):
    """-> (the cluster plan of a launch of M rows at N = 1024, D = 512 as
    one printable line, {"rows", "clusters", "active_clusters",
    "l2_bytes": {1 and nq: bytes}})."""
    n, d = VQ_SHAPES["n"], VQ_SHAPES["d"]
    rows = vq.plan(m, vq.active_clusters(d, 16))
    plan = {"rows": rows, "clusters": -(-m // rows),
            "active_clusters": vq.active_clusters(d, rows),
            "l2_bytes": {q: vq.l2_bytes(m, n, d, q, rows) for q in (1, nq)}}
    return (f"VQ plan at M={m}: {rows} rows a cluster of {vq.CLUSTER} CTAs "
            f"(codebook chunks of {-(-n // vq.CLUSTER)}), {plan['clusters']}"
            f" clusters, {plan['active_clusters']} active at once "
            f"(cudaOccupancyMaxActiveClusters); L2 bytes a call: K5 "
            f"{plan['l2_bytes'][1]}, K6 {plan['l2_bytes'][nq]}"), plan


def check_vq(torch, vq, m, nq=VQ_SHAPES["nq"], names=("K5", "K6")):
    """K5 (layer 0) and K6 (nq layers) against the plain search on random
    rows of M at N = 1024, D = 512 -> {name: (share equal, worst excess,
    ms, plain ms, records)} for the kernels in ``names``."""
    x, cbs = vq.random_case(m, **{**VQ_SHAPES, "nq": nq}, seed=m)
    cb0 = cbs[0].contiguous()
    out = {}
    for name, kernel, ref, books in (
            ("K5", lambda: vq.nearest_code(x, cb0)[:, None],
             lambda: vq.nearest_code_ref(x, cb0), cbs[:1]),
            ("K6", lambda: vq.rvq_encode_fused(x, cbs),
             lambda: vq.rvq_encode_fused_ref(x, cbs), cbs)):
        if name not in names:
            continue
        codes = kernel()
        torch.cuda.synchronize()
        share, worst, ok = vq.judge_codes(x, books, codes)
        if not (share >= 0.999 and ok):
            fail(f"{name} at M={m}: {share:.5f} of codes equal to the plain "
                 f"search, worst distance excess {worst:.3e}")
        plain, kern = in_turns(torch, [ref, kernel], iters=50,
                               kernels=[None, CUDA_KERNELS["vq"]])
        out[name] = (share, worst, kern["ms"], plain["ms"], kern["records"])
    return out


# ---------------------------------------------------------------------------
# UniSE serving
# ---------------------------------------------------------------------------

def synth_speech(rng, n, sr=SR):
    t = np.arange(n) / sr
    f0 = rng.uniform(90, 250)
    x = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6.3)) / k
            for k in range(1, 8))
    x *= 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
    return x / np.abs(x).max()


def write_requests(tmp, rng, write_wav, spec, name):
    """spec: (task, mix seconds, sampled[, mix rate]) -> JSONL file of
    requests with synthetic mixes (speech-like tone + noise; 16 kHz unless
    a rate is given) and 5-s enrolls for TSE/rTSE."""
    lines = []
    for i, (task, secs, sampled, *rate) in enumerate(spec):
        sr = rate[0] if rate else SR
        n = int(secs * sr)
        mix = 0.6 * synth_speech(rng, n, sr) + 0.3 * rng.standard_normal(n)
        line = {"task": task, "mix": str(tmp / f"{name}_mix{i}.wav"),
                "output": str(tmp / f"{name}_out{i}.wav"),
                "do_sample": sampled}
        write_wav(line["mix"], (0.5 * mix / np.abs(mix).max()).astype(
            np.float32), sr)
        if task in ("tse", "rtse"):
            line["enroll"] = str(tmp / f"{name}_enroll{i}.wav")
            write_wav(line["enroll"], (0.4 * synth_speech(rng, 80000)).astype(
                np.float32), 16000)
        lines.append(line)
    path = tmp / f"{name}.jsonl"
    path.write_text("\n".join(json.dumps(l) for l in lines))
    return path, lines


@contextmanager
def patched(pairs):
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in pairs]
    for obj, name, value in pairs:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def serve_and_check(torch, cli, path, lines, kv_quant, records, read_wav):
    """``cli serve`` on ``lines``; checks every output (each regular line's,
    then each "ss" line's ``_s1``/``_s2``, the order the CLI decodes them
    in) -> (summary, [(line, output path)])."""
    argv = ["serve", "--requests", str(path)]
    if kv_quant:
        argv += ["--kv-quant", kv_quant]
    records.clear()
    summary = cli.main(argv)
    st = summary["engine_stats"]
    outputs = [(l, l["output"]) for l in lines if l["task"] != "ss"]
    for l in lines:
        if l["task"] == "ss":
            out = Path(l["output"])
            outputs += [(l, str(out.with_name(f"{out.stem}_s{k}.wav")))
                        for k in (1, 2)]
    if len(records) != len(outputs) or st["requests_completed"] != \
            summary["segments"] or summary["outputs"] != [
                o for _, o in outputs]:
        fail(f"served {st['requests_completed']} of {summary['segments']} "
             f"segments; {len(records)} decodes for {len(outputs)} outputs")
    for (line, out_path), (g, s, wav, orig_len) in zip(outputs, records):
        if g.shape[1:] != (32,) or s.shape[1:] != (250,):
            fail(f"token shapes {g.shape} {s.shape}")
        if not (0 <= g.min() and g.max() < 4096 and 0 <= s.min()
                and s.max() < 8192):
            fail("token ids out of range")
        out, fs = read_wav(out_path)
        mix, mix_fs = read_wav(line["mix"])
        n = -(-mix.shape[-1] * SR // mix_fs)  # the input's 16 kHz length
        if not (np.isfinite(wav).all() and wav.shape == (orig_len,)
                and out.shape == (1, n) and fs == SR
                and np.isfinite(out).all()):
            fail(f"output {out_path}: shape {out.shape} at {fs} Hz, the "
                 f"input {mix.shape} at {mix_fs} Hz")
    return summary, outputs


def check_cascades(torch, cli, lines, outputs, records, admitted, read_wav,
                   gpu):
    """The "ss" lines of a serve pass: prints each one's outputs, and fails
    unless every TSE/rTSE request of the cascades (2 per 5-s segment of
    each) carried its enrollment rows as a CUDA tensor, the rows of its
    own cascade's SE result (one tensor a cascade), and a resampled line
    came out at the 16 kHz length (checked by ``serve_and_check``)."""
    ss = [l for l in lines if l["task"] == "ss"]
    if not ss:
        return
    seg = 5 * SR
    want = sum(2 * -(-read_wav(l["mix"])[0].shape[-1] // seg) for l in ss)
    first = cli.SS_UID * 4 * 65536  # the cascades' engine uids start here
    phase2 = [r for u, r in admitted.items()
              if u >= first and r.task_id in (1, 2)]
    rows = {id(r.enroll_feats) for r in phase2}
    if len(phase2) != want or len(rows) != len(ss) or not all(
            torch.is_tensor(r.enroll_feats)
            and r.enroll_feats.device.type == "cuda" for r in phase2):
        fail(f"{len(phase2)} cascade TSE/rTSE requests ({want} expected) "
             f"over {len(rows)} enrollments, CUDA tensors: "
             f"{[getattr(r.enroll_feats, 'device', None) for r in phase2]}")
    for (line, out_path), (_, _, wav, _) in zip(outputs, records):
        mix, fs = read_wav(line["mix"])
        if line["task"] == "ss" or fs != SR:
            print(f"{line['task']} line, {mix.shape[-1]} samples at {fs} Hz"
                  f" -> {Path(out_path).name}: {wav.shape[0]} samples at "
                  f"{SR} Hz, peak {np.abs(wav).max():.4f}, finite | {gpu}",
                  flush=True)
    print(f"cascades: {len(ss)}, their {len(phase2)} TSE/rTSE requests "
          f"each carrying its cascade's enrollment rows, a "
          f"{tuple(phase2[0].enroll_feats.shape)} tensor on "
          f"{phase2[0].enroll_feats.device}", flush=True)


def decode_agreement(torch, unise, kv_quant, steps=24):
    """Teacher-forced greedy decode of two SE segments in fp32 through the
    owner kernels and through the plain attention -> (max |logit diff|,
    the engines by mode, holding the pools those steps left)."""
    from unified_audio_tpu_torch.models.lm.llama import range_mask
    from unified_audio_tpu_torch.serve.engine import (ContinuousBatchingEngine,
                                                      Request)
    from unified_audio_tpu_torch.serve.paged import paged_decode_ids

    sft = unise.sft.float()
    cfg = sft.cfg
    rng = np.random.default_rng(1)
    reqs = [Request(task_id=0, mix_wav=(0.5 * synth_speech(rng, 80000)
                                        ).astype(np.float32),
                    do_sample=False, uid=i) for i in range(2)]
    engines = {mode: ContinuousBatchingEngine(
        sft, num_slots=2, max_global=32, max_semantic=256, mix_buckets=(256,),
        kv_quant=kv_quant, use_kernel=mode, feature_fn=unise.wavlm_feats,
        frames_fn=unise.wavlm_frames, wav_buckets=(80000,))
        for mode in ("owner", "")}
    for eng in engines.values():
        eng.admit_many(reqs)
    dev = sft.codec_embedding.weight.device
    gmask = range_mask(cfg, cfg.global_offset, cfg.global_size, dev)
    ids = torch.full((2,), cfg.global_sos, dtype=torch.int32, device=dev)
    worst = 0.0
    with torch.no_grad():
        for _ in range(steps):
            logits = {}
            for mode, eng in engines.items():
                st = eng.state
                logits[mode] = paged_decode_ids(
                    cfg, sft, eng.pool, st["block_tables"], st["index"],
                    st["phase"] != 2, ids, eng.block_size,
                    eng._block_bound(), mode)
                st["index"] += 1
            worst = max(worst, (logits["owner"] - logits[""]).abs().max().item())
            ids = (logits[""] + gmask).argmax(-1).int()
    return worst, engines


# ---------------------------------------------------------------------------
# HCodec-1.0 round trip
# ---------------------------------------------------------------------------

def median_wall(torch, fn, runs):
    """-> (median, min, max) seconds of ``runs`` synchronized calls of
    ``fn`` after one warm-up call."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), min(times), max(times)


def roundtrip_phase(torch, cli, vq, gpu, tmp, write_wav, read_wav):
    """Steps of phase 4 -> (K5 launches and K6 launches on their paths,
    round-trip rtfx)."""
    built = []
    build = cli._build_hcodec

    def recording(*args, **kw):
        built.append(build(*args, **kw))
        return built[-1]

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain VQ search ran in the kernel round trip")

    rng = np.random.default_rng(7)
    n = int(CLIP_S * SR)
    wav = 0.5 * synth_speech(rng, n) + 0.05 * rng.standard_normal(n)
    wav_in, wav_out = tmp / "clip.wav", tmp / "clip_out.wav"
    write_wav(wav_in, (0.8 * wav / np.abs(wav).max()).astype(np.float32), SR)
    guards = [(cli, "_build_hcodec", recording),
              (vq, "nearest_code_ref", forbidden),
              (vq, "rvq_encode_fused_ref", forbidden)]
    with patched(guards):
        vq.nearest_code.launches = vq.rvq_encode_fused.launches = 0
        summary = cli.main(["codec", "--model", "hcodec10", "--input",
                            str(wav_in), "--output", str(wav_out)])
        k6_launches = vq.rvq_encode_fused.launches
        if k6_launches != 2:
            fail(f"K6 launched {k6_launches} times in one round trip, not 2")
        tok = built[0]
        x = torch.as_tensor(read_wav(wav_in)[0], device="cuda")
        codes = [c.cpu() for c in tok.tokenize(x)]
    if summary["acoustic_shape"] != [1, 4, 250]:
        fail(f"acoustic codes of shape {summary['acoustic_shape']}")
    for c in codes:
        if c.shape != (1, 4, 250) or not (0 <= int(c.min())
                                          and int(c.max()) < 1024):
            fail(f"codes of shape {tuple(c.shape)} in "
                 f"[{int(c.min())}, {int(c.max())}]")
    rec, fs = read_wav(wav_out)
    if not (fs == SR and rec.shape == (1, n) and np.isfinite(rec).all()):
        fail(f"round-trip wav of shape {rec.shape} at {fs} Hz")

    def roundtrip():
        return tok.detokenize(*tok.tokenize(x))

    wall, lo, hi = median_wall(torch, roundtrip, 10)
    out = roundtrip()
    rtfx = CLIP_S / wall
    print(f"hcodec10 round trip rtfx {rtfx:.2f} (median of 10: {wall * 1e3:.2f}"
          f" ms for {CLIP_S:.0f} s of 16 kHz audio; range "
          f"{lo * 1e3:.2f}-{hi * 1e3:.2f} ms); K6 launches "
          f"{k6_launches} | {gpu}", flush=True)

    # K5 on its own path: the staged encode of the round trip's latents
    latents = [z.reshape(-1, z.shape[-1]).contiguous() for z in tok.latents(x)]
    books = [q.codebooks() for q in (tok.codec.quantizer,
                                     tok.codec.semantic_quantizer)]
    vq.nearest_code.launches = 0
    staged = [vq.rvq_encode_staged(z, b) for z, b in zip(latents, books)]
    k5_launches = vq.nearest_code.launches
    if k5_launches != 8:
        fail(f"K5 launched {k5_launches} times in the staged encode, not 8")
    for z, b, got in zip(latents, books, staged):
        fused = vq.rvq_encode_fused(z, b)
        same = float((fused == got).float().mean())
        worst = 0.0
        for codes_ in (got, fused):
            share, w, ok = vq.judge_codes(z, b, codes_)
            worst = max(worst, w)
            if not ok:
                fail(f"staged/fused codes off the plain search: excess {w}")
        if same < 0.999:
            fail(f"staged K5 and fused K6 agree on {same:.5f} of codes")
        print(f"staged K5 vs fused K6 on the round trip's latents: {same:.5f}"
              f" of codes equal, worst distance excess {worst:.3e}; K5 "
              f"launches {k5_launches}", flush=True)

    # the round trip with the plain VQ, outside the guards
    with patched([(vq, "rvq_encode_fused", vq.rvq_encode_fused_ref)]):
        plain_codes = tok.tokenize(x)
    plain_out = tok.detokenize(*plain_codes)
    same = float(np.mean([float((a.cpu() == b).float().mean())
                          for a, b in zip(plain_codes, codes)]))
    diff = float((plain_out - out).abs().max())
    if same < 0.999 or (same == 1.0 and not diff <= 1e-5):
        fail(f"plain-VQ round trip: {same:.5f} of codes equal, waveform "
             f"max |diff| {diff:.3e}")
    print(f"round trip with plain VQ: {same:.5f} of codes equal, waveform "
          f"max |diff| {diff:.3e}", flush=True)
    return k5_launches, k6_launches, rtfx, tok


# ---------------------------------------------------------------------------
# HCodec-2.0 round trip
# ---------------------------------------------------------------------------

def stft_edges(torch, dsp, x, n_fft, hop):
    """The encoder's STFT of ``x`` (padded as ``CodecEncoder20`` pads it) on
    the card against the same frames on the CPU -> (the -0.0 imaginary
    parts cuFFT itself gives at the DC and Nyquist bins, of how many; bins
    there with a negative real part; max |S_card - S_cpu| / max |S|).
    Fails unless stft's DC and Nyquist bins are +0.0 and their phase
    equals the CPU's."""
    pad = (n_fft - hop) // 2
    xp = torch.nn.functional.pad(x, (pad, pad))
    raw = torch.fft.rfft(dsp.frame(xp, n_fft, hop) * dsp.hann_window(
        n_fft, x.device), n=n_fft, dim=-1)[..., [0, -1]]
    card = dsp.stft(xp, n_fft, hop).cpu()
    cpu = dsp.stft(xp.cpu(), n_fft, hop)
    edges = (slice(None), [0, -1])
    if torch.signbit(card[edges].imag).any() or not torch.equal(
            card[edges].angle(), cpu[edges].angle()):
        fail("the card's STFT phase at DC/Nyquist differs from the CPU's")
    return (int(torch.signbit(raw.imag).sum()), raw.numel(),
            int((cpu[edges].real < 0).sum()),
            float((card - cpu).abs().max() / cpu.abs().max()))


def hcodec20_phase(torch, cli, vq, dsp, gpu, tmp, write_wav, read_wav):
    """Phase 5 -> (K6 launches on the round trip, {M: (share, worst, ms,
    plain ms, records)} of K6 at nq = 16)."""
    built = []
    build = cli._build_hcodec

    def recording(*args, **kw):
        built.append(build(*args, **kw))
        return built[-1]

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain VQ search ran in the kernel round trip")

    rng = np.random.default_rng(8)
    n = int(CLIP_S * SR20)
    wav = 0.5 * synth_speech(rng, n, SR20) + 0.05 * rng.standard_normal(n)
    wav_in, wav_out = tmp / "clip48.wav", tmp / "clip48_out.wav"
    write_wav(wav_in, (0.8 * wav / np.abs(wav).max()).astype(np.float32),
              SR20)
    guards = [(cli, "_build_hcodec", recording),
              (vq, "nearest_code_ref", forbidden),
              (vq, "rvq_encode_fused_ref", forbidden)]
    with patched(guards):
        vq.rvq_encode_fused.launches = 0
        t0 = time.perf_counter()
        summary = cli.main(["codec", "--model", "hcodec20", "--input",
                            str(wav_in), "--output", str(wav_out)])
        cli_s = time.perf_counter() - t0
        k6_launches = vq.rvq_encode_fused.launches
        if k6_launches != 2:
            fail(f"K6 launched {k6_launches} times in one HCodec-2.0 round "
                 "trip, not 2")
        tok = built[0]
        x = torch.as_tensor(read_wav(wav_in)[0], device="cuda")
        codes = tok.tokenize(x)
    frames = n // tok.hop_length
    if summary["acoustic_shape"] != [1, NQ20, frames]:
        fail(f"HCodec-2.0 acoustic codes of shape {summary['acoustic_shape']}")
    for c in codes:
        if tuple(c.shape) != (1, NQ20, frames) or not (
                0 <= int(c.min()) and int(c.max()) < 1024):
            fail(f"HCodec-2.0 codes of shape {tuple(c.shape)} in "
                 f"[{int(c.min())}, {int(c.max())}]")
    rec, fs = read_wav(wav_out)
    if not (fs == SR20 and rec.shape == (1, n) and np.isfinite(rec).all()):
        fail(f"HCodec-2.0 round-trip wav of shape {rec.shape} at {fs} Hz")
    print(f"hcodec20 round trip through cli codec ({cli_s:.1f} s with the "
          f"build): codes {tuple(codes[0].shape)} per stream in "
          f"[{min(int(c.min()) for c in codes)}, "
          f"{max(int(c.max()) for c in codes)}], {len(torch.unique(codes[0]))}"
          f" distinct acoustic codes; output {rec.shape[1]} samples at {fs} "
          f"Hz, finite; K6 launches {k6_launches} | {gpu}", flush=True)

    neg0, n_edge, negative, rel = stft_edges(torch, dsp, x, tok.config.n_fft,
                                             tok.config.istft_hop)
    print(f"hcodec20 encoder STFT on the card vs the CPU: DC/Nyquist "
          f"imaginary parts -0.0 in cuFFT's own output {neg0} of {n_edge}, "
          f"+0.0 after stft in all; {negative} of those bins with a negative"
          f" real part, phase equal to the CPU's in all; max |S_card - "
          f"S_cpu| / max |S| {rel:.3e}", flush=True)

    k6 = {}
    for m in K6_20_M:
        line, plan = vq_plan_line(torch, vq, m, NQ20)
        print(line, flush=True)
        share, worst, ms, plain_ms, n_rec = check_vq(torch, vq, m, NQ20,
                                                     ("K6",))["K6"]
        k6[m] = (share, worst, ms, plain_ms, n_rec)
        b_ms, _ = vq_bound(m, VQ_SHAPES["n"], VQ_SHAPES["d"], NQ20)
        print(f"K6 at M={m}, N=1024, D=512, nq={NQ20}: {share:.5f} of codes "
              f"equal to plain, worst distance excess {worst:.3e}; kernel "
              f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
              f"{b_ms * 1e3:.2f} us (3xTF32 at 495 TFLOP/s); L2 bytes "
              f"{plan['l2_bytes'][NQ20]} | {gpu}", flush=True)

    def roundtrip():
        return tok.detokenize(*tok.tokenize(x))

    wall, lo, hi = median_wall(torch, roundtrip, 10)
    print(f"hcodec20 round trip rtfx {CLIP_S / wall:.2f} (median of 10: "
          f"{wall * 1e3:.2f} ms for {CLIP_S:.0f} s of 48 kHz audio; range "
          f"{lo * 1e3:.2f}-{hi * 1e3:.2f} ms) | {gpu}", flush=True)

    # benchmarks/bench_hcodec20.py: encode + decode of a batch with random
    # HuBERT-shaped features (no frontend), rtfx = batch x seconds / p50
    b, secs = BENCH20["batch"], BENCH20["seconds"]
    t = int(secs * SR20) // tok.hop_length * tok.hop_length
    g = torch.Generator(device="cuda").manual_seed(0)
    bwav = torch.randn(b, t, 1, generator=g, device="cuda")
    feat = torch.randn(b, t // 3 // 320, tok.config.feat_dim, generator=g,
                       device="cuda")
    codec = tok.codec

    def batch_roundtrip():
        with torch.no_grad():
            return codec.decode(*codec.encode(bwav, feat))

    wall, lo, hi = median_wall(torch, batch_roundtrip, 5)
    print(f"hcodec20 bench_hcodec20 configuration (batch {b} x {t} samples,"
          f" K6 at M={b * (t // tok.hop_length)}): rtfx {b * secs / wall:.2f}"
          f" (median of 5: {wall * 1e3:.2f} ms; range {lo * 1e3:.2f}-"
          f"{hi * 1e3:.2f} ms) | {gpu}", flush=True)

    # the round trip with the plain VQ, outside the guards
    with patched([(vq, "rvq_encode_fused", vq.rvq_encode_fused_ref)]):
        plain_codes = tok.tokenize(x)
    same = float(np.mean([float((a == b_).float().mean())
                          for a, b_ in zip(plain_codes, codes)]))
    if same < 0.999:
        fail(f"HCodec-2.0 plain-VQ round trip: {same:.5f} of codes equal")
    print(f"hcodec20 round trip with plain VQ: {same:.5f} of codes equal",
          flush=True)
    return k6_launches, k6


# ---------------------------------------------------------------------------
# UniTok-audio served from the paged pool in the stream mode
# ---------------------------------------------------------------------------

def unitok_requests(torch, tok, rng, n):
    """``n`` requests cycling through the 7 tasks on 5-s synthetic inputs
    (250 HuBERT frames, 125 codec frames): VC and TSE carry a 2-s
    reference's features, LASS 20 frames of random caption features (there
    is no text encoder); odd ones are sampled."""
    from unified_audio_tpu_torch.models.unitok.model import UNITOK_TASKS
    from unified_audio_tpu_torch.serve.unitok_engine import UniTokRequest

    def clips(secs, level):
        m = int(secs * SR)
        x = np.stack([level * synth_speech(rng, m)
                      + 0.05 * rng.standard_normal(m) for _ in range(n)])
        return torch.as_tensor(x.astype(np.float32), device="cuda")

    wavs, refs = clips(5.0, 0.5), clips(2.0, 0.4)
    feats = tok.extract_features(tok.pad_wav(wavs)).cpu().numpy()
    ref_feats = tok.extract_features(refs).cpu().numpy()
    frames = wavs.shape[1] // tok.hop_length
    tasks = list(UNITOK_TASKS)
    reqs = []
    for i in range(n):
        task = tasks[i % len(tasks)]
        reqs.append(UniTokRequest(
            task_id=UNITOK_TASKS[task], num_frames=frames,
            input_feats=feats[i],
            ref_feats=ref_feats[i] if task in ("tse", "vc") else None,
            caption_feats=(rng.standard_normal((20, 768)).astype(np.float32)
                           if task == "lass" else None),
            do_sample=i % 2 == 1, uid=i))
    return reqs


def check_codes(results, reqs, k):
    for r in reqs:
        c = results[r.uid].codes
        if c.shape != (r.num_frames, k) or not (0 <= c.min()
                                                and c.max() < 1024):
            fail(f"UniTok request {r.uid}: codes of shape {c.shape} in "
                 f"[{c.min()}, {c.max()}]")


def unitok_agreement(torch, lm, reqs, quant, steps=24, mode="stream"):
    """Teacher-forced decode of two same-signature UniTok requests in fp32
    through the kernels of ``mode`` (the stream kernels, or the owner
    kernels) and through the plain attention: max |logit diff| over
    ``steps`` steps."""
    from unified_audio_tpu_torch.models.unitok.model import delay_window_masks
    from unified_audio_tpu_torch.serve.unitok_engine import UniTokEngine

    kernel_mode = mode
    engines = {mode: UniTokEngine(lm, num_slots=2, use_kernel=mode,
                                  kv_quant=quant) for mode in (mode, "")}
    for eng in engines.values():
        eng.admit_wave(reqs)
    code_mask, _ = delay_window_masks(lm.cfg, "cuda")
    ids = torch.full((2, lm.cfg.num_codebooks), lm.cfg.bos, dtype=torch.int32,
                     device="cuda")
    worst = 0.0
    for _ in range(steps):
        logits = {}
        for mode, eng in engines.items():
            logits[mode] = eng.decode_logits(ids)
            eng.state["index"] += 1
        worst = max(worst, (logits[kernel_mode] - logits[""]).abs().max()
                    .item())
        ids = (logits[""] + code_mask).argmax(-1).int()
    return worst


def unitok_phase(torch, cli, pa, paged, tok, unise, gpu, tally):
    """Phase 6 -> (K3 launches, K4 launches) on their serving passes, the
    full-width UniTok LM (left in fp32) and the 24 requests of its int8
    pass; the K7 check's launches go to ``tally``."""
    from unified_audio_tpu_torch.models.unitok.model import UniTokConfig, UniTokLM
    from unified_audio_tpu_torch.models.unitok.pipeline import UniTokPipeline
    from unified_audio_tpu_torch.serve.engine import Request
    from unified_audio_tpu_torch.serve.unitok_engine import UniTokEngine
    from unified_audio_tpu_torch.utils.initialization import init_random_

    cfg = UniTokConfig()
    with torch.device("cuda"):
        lm = UniTokLM(cfg)
    init_random_(lm, torch.Generator(device="cuda").manual_seed(3)).eval()
    pipe = UniTokPipeline(tok, lm.to(torch.bfloat16))
    k = cfg.num_codebooks
    rng = np.random.default_rng(5)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain attention path ran during serving")

    guards = [(paged, "_plain_attention", forbidden),
              (pa, "paged_flash_decode_stream_flat_ref", forbidden),
              (pa, "paged_flash_decode_stream_flat_q8_ref", forbidden)]

    # int8 pool, K4: 24 requests over the 7 tasks through 16 slots
    reqs = unitok_requests(torch, tok, rng, 24)
    eng = UniTokEngine(lm, num_slots=16, use_kernel="stream", kv_quant="int8")
    bounds = []
    block_bound = eng._block_bound

    def recorded_bound():
        bounds.append(block_bound())
        return bounds[-1]

    with patched(guards + [(eng, "_block_bound", recorded_bound)]):
        pa.paged_flash_decode_stream_flat_q8.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = eng.run(reqs, gen)
        torch.cuda.synchronize()
        engine_s = time.perf_counter() - t0
        k4 = pa.paged_flash_decode_stream_flat_q8.launches
    st = eng.stats()
    if k4 != L * st["decode_steps"] or st["decode_steps"] == 0:
        fail(f"K4 launched {k4} times for {st['decode_steps']} decode steps "
             f"of {L} layers")
    if not all(b % 64 == 0 and 64 <= b <= eng.num_blocks for b in bounds):
        fail(f"decode bounds {sorted(set(bounds))} not 64-block buckets "
             f"within the pool's {eng.num_blocks} blocks")
    check_codes(results, reqs, k)
    codes = torch.as_tensor(np.stack([results[r.uid].codes for r in reqs]),
                            device="cuda").long()
    wav = pipe.codes_to_audio(codes)
    n_out = reqs[0].num_frames * tok.hop_length
    if wav.shape != (len(reqs), n_out) or not bool(torch.isfinite(wav).all()):
        fail(f"UniTok waveforms of shape {tuple(wav.shape)}, finite "
             f"{bool(torch.isfinite(wav).all())}")
    n_codes = k * sum(r.num_frames for r in reqs)
    print(f"unitok int8 pool (stream, K4): {len(reqs)} requests over 7 tasks,"
          f" codes {tuple(results[0].codes.shape)} each, {st['decode_steps']}"
          f" decode steps, {st['prefill_waves']} prefill waves, bounds "
          f"{min(bounds)}-{max(bounds)} of {eng.num_blocks} blocks; engine "
          f"{engine_s:.2f} s = {n_codes / engine_s:.0f} codes/s "
          f"({n_codes / k / engine_s:.0f} frames/s); K4 launches {k4}; "
          f"waveforms {tuple(wav.shape)} finite | {gpu}", flush=True)

    # one bf16 pool and one allocator shared by UniSE and UniTok, K3
    unise.sft.to(torch.bfloat16)
    nb = 320
    pool_ref = paged.PoolRef(paged.init_pool(cfg.llama_config, nb, 64,
                                             dtype=torch.bfloat16,
                                             device="cuda"))
    alloc = paged.BlockAllocator(nb)
    eng_u = cli.make_engine(unise, 4, use_kernel="stream", pool_ref=pool_ref,
                            allocator=alloc)
    eng_t = UniTokEngine(lm, num_slots=4, use_kernel="stream",
                         pool_ref=pool_ref, allocator=alloc)
    seg = unise.config.segment_len
    sem_len = unise._semantic_len()
    u_reqs = [Request(task_id=i % 2, mix_wav=(0.5 * synth_speech(rng, seg)
                                              ).astype(np.float32),
                      enroll_wav=((0.4 * synth_speech(rng, seg)).astype(
                          np.float32) if i % 2 else None),
                      semantic_length=sem_len, do_sample=i >= 2, uid=100 + i)
              for i in range(4)]
    # the pass-1 requests without a reference or caption: one signature
    t_reqs = [dataclasses.replace(r, uid=200 + r.uid) for r in reqs
              if r.ref_feats is None and r.caption_feats is None][:4]
    with patched(guards):
        if len(eng_u.admit_many(u_reqs)) != 4 or \
                len(eng_t.admit_wave(t_reqs)) != 4:
            fail("the shared pool did not admit 4 + 4 requests")
        held_u = {b for bl in eng_u._slot_blocks for b in bl}
        held_t = {b for bl in eng_t._slot_blocks for b in bl}
        if not held_u or not held_t or held_u & held_t:
            fail(f"shared pool blocks overlap: {sorted(held_u & held_t)}")
        pa.paged_flash_decode_stream_flat.launches = 0
        res_u, res_t = {}, {}
        check_s = None
        t0 = time.perf_counter()
        while len(res_u) < len(u_reqs) or len(res_t) < len(t_reqs):
            for e, res, n in ((eng_u, res_u, len(u_reqs)),
                              (eng_t, res_t, len(t_reqs))):
                if len(res) < n:
                    e.step(1, gen)
                    res.update({r.uid: r for r in e.harvest()})
            if check_s is None:  # K7 on the tables the two engines hold
                t1 = time.perf_counter()
                with uncounted(tally, pa.paged_flash_decode,
                               pa.paged_flash_decode_stream_flat):
                    errs = [table_on_live_pool(torch, pa, paged, e, "K3")
                            for e in (eng_u, eng_t)]
                check_s = time.perf_counter() - t1
        shared_s = time.perf_counter() - t0 - check_s
        k3 = pa.paged_flash_decode_stream_flat.launches
    steps_u = eng_u.stats()["decode_steps"]
    steps_t = eng_t.stats()["decode_steps"]
    if k3 != L * (steps_u + steps_t):
        fail(f"K3 launched {k3} times for {steps_u} + {steps_t} decode "
             f"steps of {L} layers")
    for r in res_u.values():
        if r.global_ids.shape != (32,) or r.semantic_ids.shape != (sem_len,) \
                or not (0 <= r.global_ids.min() and r.global_ids.max() < 4096
                        and 0 <= r.semantic_ids.min()
                        and r.semantic_ids.max() < 8192):
            fail(f"shared pool UniSE result {r.uid} out of range")
    check_codes(res_t, t_reqs, k)
    if len(alloc.free) != nb - 1:
        fail(f"shared pool leaked blocks: {nb - 1 - len(alloc.free)} held")
    print(f"shared bf16 pool (stream, K3): UniSE {len(u_reqs)} segments in "
          f"{steps_u} steps and UniTok {len(t_reqs)} requests in {steps_t} "
          f"steps, stepped in turn, {len(held_u)} + {len(held_t)} disjoint "
          f"blocks; {shared_s:.2f} s; K3 launches {k3} | {gpu}", flush=True)
    print(f"K7 on the shared bf16 pool after the first steps, every layer, "
          f"vs K3 on the mask the tables give: UniSE engine max abs err "
          f"{errs[0]:.3e}, UniTok engine {errs[1]:.3e}", flush=True)

    # teacher-forced fp32: the stream kernels against the plain attention
    lm.float()
    two = [r for r in reqs if r.task_id == 0][:2]
    for quant in (None, "int8"):
        worst = unitok_agreement(torch, lm, two, quant)
        print(f"teacher-forced fp32 UniTok decode, {quant or 'fp32'} pool: "
              f"stream kernels vs plain attention max |logit diff| "
              f"{worst:.2e}", flush=True)
        if not worst <= 1e-4:
            fail(f"stream-kernel decode disagrees with the plain path: "
                 f"{worst}")
    return k3, k4, lm, reqs


# ---------------------------------------------------------------------------
# The serving engines' API (phase 13)
# ---------------------------------------------------------------------------

API_SEGMENTS = 20  # phase 13's UniSE requests: the 16 slots and 4 more

def api_requests(torch, unise, rng):
    """Phase 13's UniSE requests, one 5-s segment each, made as ``cli
    serve`` makes them from phase 3's kinds of line: peak-normalized mixes
    on the int16 wire; SE, TSE and rTSE in turn, TSE/rTSE with a 5-s
    enrollment (the wire too) except request 1, whose 3-s enrollment goes
    in as exact-length features made on the card; every other pair
    sampled."""
    from unified_audio_tpu_torch.serve.engine import Request

    cfg = unise.config
    seg, sem = cfg.segment_len, unise._semantic_len()

    def normalized(x):
        return (x / np.abs(x).max()).astype(np.float32)

    reqs = []
    for i in range(API_SEGMENTS):
        mix = normalized(0.6 * synth_speech(rng, seg)
                         + 0.3 * rng.standard_normal(seg))
        enroll_wav = enroll_feats = None
        if i == 1:
            e = normalized(synth_speech(rng, 3 * seg // 5))
            enroll_feats = unise.wavlm_feats(
                torch.as_tensor(e[None], device="cuda"))[0]
        elif i % 3:
            enroll_wav = normalized(synth_speech(rng, seg))
        reqs.append(Request(task_id=i % 3, mix_wav=mix, enroll_wav=enroll_wav,
                            enroll_feats=enroll_feats,
                            global_length=cfg.global_tokens,
                            semantic_length=sem, do_sample=i % 4 >= 2,
                            uid=i))
    return reqs


def same_tokens(a, b, uids):
    return all(np.array_equal(a[u].global_ids, b[u].global_ids)
               and np.array_equal(a[u].semantic_ids, b[u].semantic_ids)
               for u in uids)


def displacing_pass(torch, cli, pa, unise, gpu):
    """Phase 13 (a) and (d): the displacing ``run`` (inputs prestaged) and
    the admit/step/harvest loop (inputs staged at admission) on one int8
    pool (K2), one pass each -> K2 launches. Their rates are compared over
    many pairs by ``serve/profile_step.py``, not here."""
    from unified_audio_tpu_torch.serve.profile_step import harvest_loop

    k2 = pa.paged_flash_decode_owner_q8
    reqs = api_requests(torch, unise, np.random.default_rng(13))
    tokens = sum(r.global_length + 1 + r.semantic_length for r in reqs)
    greedy = [r.uid for r in reqs if not r.do_sample]
    eng = cli.make_engine(unise, 16, "int8")
    prestaged = set()
    prestage = eng.prestage

    def recording_prestage(rs):
        before = set(eng._staged)
        prestage(rs)
        prestaged.update(set(eng._staged) - before)

    eng.prestage = recording_prestage
    t_keys = ("t_prestage", "t_admit", "t_step", "t_drain", "t_harvest")
    outs, walls, launches = {}, {}, 0
    for kind in ("run", "loop"):
        gen = torch.Generator(device="cuda").manual_seed(0)
        before = eng.stats()
        k2.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "run":
            out = eng.run(reqs, gen)
        else:
            out, _ = harvest_loop(eng, reqs, gen)
        torch.cuda.synchronize()
        walls[kind] = time.perf_counter() - t0
        after = eng.stats()
        steps = after["decode_steps"] - before["decode_steps"]
        launches += k2.launches
        if k2.launches != L * steps or sorted(out) != list(range(
                API_SEGMENTS)):
            fail(f"phase 13 {kind}: {len(out)} results, K2 launched "
                 f"{k2.launches} times for {steps} decode steps")
        if kind == "run":
            split = {k: after[k] - before.get(k, 0) for k in t_keys
                     + ("stash_fetches", "step_dispatches")}
            if prestaged != set(range(API_SEGMENTS)):
                fail(f"the run prestaged {sorted(prestaged)}, not every "
                     "request")
        if after["blocks_held"]:
            fail(f"{after['blocks_held']} blocks held after the {kind}")
        outs[kind] = out
    if not same_tokens(outs["run"], outs["loop"], greedy):
        fail("phase 13: the displacing run's greedy tokens differ from the "
             "admit/step/harvest loop's")
    sampled_same = same_tokens(outs["run"], outs["loop"],
                               [r.uid for r in reqs if r.do_sample])
    print(f"phase 13 (a) {API_SEGMENTS} segments over 16 slots, int8 pool "
          f"(K2), one pass each: displacing run {walls['run']:.3f} s "
          f"({tokens / walls['run']:.0f} tokens/s), admit/step/harvest loop "
          f"{walls['loop']:.3f} s ({tokens / walls['loop']:.0f} tokens/s); "
          f"greedy tokens equal, sampled equal {sampled_same}; the run's "
          f"host split "
          + ", ".join(f"{k} {split[k]:.3f} s" for k in t_keys)
          + f", stash fetches {split['stash_fetches']}, step calls "
          f"{split['step_dispatches']}; (d) every request of the run "
          f"prestaged, its tokens the unstaged loop's | {gpu}", flush=True)
    return launches


def cancel_pass(torch, cli, pa, unise, gpu):
    """Phase 13 (b): a request cancelled mid-flight on a two-slot bf16 pool
    (K1); the survivor's tokens equal its solo run's and every block comes
    back -> K1 launches."""
    k1 = pa.paged_flash_decode_owner
    reqs = api_requests(torch, unise, np.random.default_rng(14))
    keep = dataclasses.replace(reqs[0], uid=100)
    victim = dataclasses.replace(reqs[3], uid=101, do_sample=False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1.launches = 0
    solo = cli.make_engine(unise, 2).run([keep], gen)[100]
    eng = cli.make_engine(unise, 2)
    free0 = len(eng.allocator.free)
    # one wave each, as the solo run admits ``keep``
    if eng.admit_many([keep]) != [100] or eng.admit_many([victim]) != [101]:
        fail("the cancel engine did not admit its two requests")
    eng.step(40, gen)
    if not eng.cancel(101) or eng.cancel(999):
        fail("cancel did not find the victim, or found a stranger")
    done = int(eng.state["phase"][1]) == 2  # PHASE_DONE
    eng.step(eng._remaining[0], gen)
    out = eng.harvest()
    st = eng.stats()
    if not (done and len(out) == 1 and out[0].uid == 100
            and same_tokens({100: out[0]}, {100: solo}, [100])
            and len(eng.allocator.free) == free0 and st["blocks_held"] == 0
            and st["requests_cancelled"] == 1):
        fail(f"cancel: phase done {done}, results {[r.uid for r in out]}, "
             f"free blocks {len(eng.allocator.free)} of {free0}")
    print(f"phase 13 (b) cancel after 40 of "
          f"{keep.global_length + 1 + keep.semantic_length} steps on a bf16 "
          f"pool (K1): "
          f"the victim's slot done on the card at once, the survivor's "
          f"{len(solo.global_ids)} + {len(solo.semantic_ids)} greedy tokens "
          f"equal its solo run's, all {free0} blocks free again | {gpu}",
          flush=True)
    return k1.launches


def feature_wire_pass(torch, cli, pa, unise, gpu):
    """Phase 13 (c): the int8 feature wire against the bf16 one on 16 SE
    requests of host features (int8 pool, K2) -> K2 launches."""
    from unified_audio_tpu_torch.serve import engine as eng_mod

    k2 = pa.paged_flash_decode_owner_q8
    reqs = api_requests(torch, unise, np.random.default_rng(15))[:16]
    feats = unise.wavlm_feats(torch.as_tensor(
        np.stack([r.mix_wav for r in reqs]), device="cuda")).cpu().numpy()
    rows = np.stack([eng_mod._quantize_feats_row(f) for f in feats])
    back = rows[..., :-1].astype(np.float32) * np.ldexp(
        np.float32(1), rows[..., -1:].astype(np.int32))
    card = eng_mod._dequant_feats(torch.as_tensor(rows, device="cuda"),
                                  torch.float32).cpu().numpy()
    if not np.array_equal(card, back):
        fail("the card's int8 wire dequant differs from q * 2^e")
    snr = 10 * np.log10((feats ** 2).sum() / ((feats - back) ** 2).sum())
    fr = [dataclasses.replace(r, mix_wav=None, mix_feats=feats[i],
                              enroll_wav=None, enroll_feats=None, task_id=0,
                              do_sample=False) for i, r in enumerate(reqs)]
    k2.launches = 0
    out = {w: cli.make_engine(unise, 16, "int8", feats_wire=w).run(fr)
           for w in ("bf16", "int8")}
    same = np.mean([np.mean(np.concatenate([
        out["bf16"][r.uid].global_ids == out["int8"][r.uid].global_ids,
        out["bf16"][r.uid].semantic_ids == out["int8"][r.uid].semantic_ids]))
        for r in fr])
    print(f"phase 13 (c) int8 feature wire on {len(fr)} segments' WavLM "
          f"features (host, {feats.shape[1]} x {feats.shape[2]} each): "
          f"feature SNR {snr:.2f} dB, the "
          f"card's dequant equal to q * 2^e, {rows.nbytes} wire bytes "
          f"against {feats.size * 2} bf16; greedy tokens equal to the bf16 "
          f"wire's in {same:.4f} of places | {gpu}", flush=True)
    return k2.launches


def unitok_owner_pass(torch, pa, paged, lm, reqs, gpu):
    """Phase 13 (e): UniTok in the owner mode with displacing admission
    (24 requests over 16 slots), int8 pool (K2) and bf16 pool (K1), then
    teacher-forced fp32 decode through K1/K2 against the plain attention
    -> (K1 launches, K2 launches)."""
    from unified_audio_tpu_torch.serve.unitok_engine import UniTokEngine

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain attention path ran during serving")

    k = lm.cfg.num_codebooks
    lm.to(torch.bfloat16)
    counts = {}
    with patched([(paged, "_plain_attention", forbidden),
                  (pa, "paged_flash_decode_owner_ref", forbidden),
                  (pa, "paged_flash_decode_owner_q8_ref", forbidden)]):
        for quant, kernel in (("int8", pa.paged_flash_decode_owner_q8),
                              (None, pa.paged_flash_decode_owner)):
            eng = UniTokEngine(lm, num_slots=16, use_kernel="owner",
                               kv_quant=quant)
            kernel.launches = 0
            gen = torch.Generator(device="cuda").manual_seed(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eng.run(reqs, gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = eng.stats()
            # the requests past the 16 slots displace finished ones, whose
            # codes come back in the one drain at the end
            if kernel.launches != L * st["decode_steps"] or \
                    st["blocks_held"] or st["stash_fetches"] != 1:
                fail(f"UniTok owner {quant or 'bf16'}: {kernel.__name__} "
                     f"launched {kernel.launches} times for "
                     f"{st['decode_steps']} steps; stats {st}")
            check_codes(out, reqs, k)
            counts[kernel.__name__] = kernel.launches
            n_codes = k * sum(r.num_frames for r in reqs)
            print(f"phase 13 (e) UniTok owner mode, {quant or 'bf16'} pool "
                  f"({'K2' if quant else 'K1'}): {len(reqs)} requests over 16 "
                  f"slots, {st['prefill_waves']} waves displacing, "
                  f"{st['stash_fetches']} stash fetch(es), "
                  f"{st['decode_steps']} decode steps in "
                  f"{st['step_dispatches']} step calls; "
                  f"{n_codes / wall:.0f} codes/s; {kernel.__name__} "
                  f"launches {kernel.launches} | {gpu}", flush=True)
    lm.float()
    two = [r for r in reqs if r.task_id == 0][:2]
    for quant in (None, "int8"):
        worst = unitok_agreement(torch, lm, two, quant, mode="owner")
        print(f"phase 13 (e) teacher-forced fp32 UniTok decode, "
              f"{quant or 'fp32'} pool: owner kernels vs plain attention max "
              f"|logit diff| {worst:.2e}", flush=True)
        if not worst <= 1e-4:
            fail(f"owner-kernel UniTok decode disagrees with the plain "
                 f"path: {worst}")
    return (counts[pa.paged_flash_decode_owner.__name__],
            counts[pa.paged_flash_decode_owner_q8.__name__])


def engine_api_phase(torch, cli, pa, paged, unise, lm, t_reqs, gpu):
    """Phase 13 -> {kernel name: launches} of its serving passes."""
    t0 = time.perf_counter()
    unise.sft.to(torch.bfloat16)
    k1, k2 = pa.paged_flash_decode_owner, pa.paged_flash_decode_owner_q8
    with torch.no_grad():
        n2 = displacing_pass(torch, cli, pa, unise, gpu)
        n1 = cancel_pass(torch, cli, pa, unise, gpu)
        n2 += feature_wire_pass(torch, cli, pa, unise, gpu)
    u1, u2 = unitok_owner_pass(torch, pa, paged, lm, t_reqs, gpu)
    print(f"phase 13 took {time.perf_counter() - t0:.1f} s | {gpu}",
          flush=True)
    return {k1.__name__: n1 + u1, k2.__name__: n2 + u2}


# ---------------------------------------------------------------------------
# UniSE SFT training
# ---------------------------------------------------------------------------

TRAIN_STEPS = 30  # steps of the training run (batch 32 x 5 s)
RESUME_STEPS = 3  # steps of the resumed run
TIMED_FROM = 5  # the median step time is over steps TIMED_FROM..TRAIN_STEPS
PROFILED_STEP = 20  # the step traced for the device's busy share
BATCH = 32


def write_train_data(tmp, rng, write_wav):
    """Synthetic SCP lists: 4 speakers x 3 utterances of 6 s (speech-like
    tones), a 12-s noise and a 0.4-s exponentially decaying RIR."""
    lines = []
    for spk in range(4):
        for u in range(3):
            path = tmp / f"spk{spk}_{u}.wav"
            write_wav(path, (0.5 * synth_speech(rng, 6 * SR)).astype(
                np.float32), SR)
            lines.append(f"spk{spk}_u{u} spk{spk} {path}")
    (tmp / "speech.scp").write_text("\n".join(lines) + "\n")
    noise = np.cumsum(rng.standard_normal(12 * SR)) * 0.01
    noise -= np.convolve(noise, np.ones(400) / 400, mode="same")
    write_wav(tmp / "noise.wav", (0.3 * noise / np.abs(noise).max()).astype(
        np.float32), SR)
    (tmp / "noise.scp").write_text(f"n0 {SR} 0 {12 * SR} {tmp / 'noise.wav'}\n")
    n = int(0.4 * SR)
    rir = rng.standard_normal(n) * np.exp(-np.arange(n) / (0.05 * SR))
    rir[0] = 1.0
    write_wav(tmp / "rir.wav", (0.9 * rir / np.abs(rir).max()).astype(
        np.float32), SR)
    (tmp / "rir.scp").write_text(f"r0 {tmp / 'rir.wav'}\n")
    return {k: [str(tmp / f"{k}.scp")] for k in ("speech", "noise", "rir")}


def train_config(tmp, scps, steps, name, extra=None):
    """configs/unise.yaml with the SCP paths, the run's length, a 5-step
    warmup, validation and the checkpoint directory changed, and the
    ``extra`` changes (printed)."""
    from unified_audio_tpu_torch.utils.config import load_yaml

    cfg = load_yaml(REPO / "configs" / "unise.yaml")
    changes = {f"dataset.{k}_scp": v for k, v in scps.items()}
    changes.update({"dataset.samples_per_epoch": steps * BATCH,
                    "max_epochs": 1, "opt.warmup_steps": 5,
                    "val_every": 15, "val_batches": 2,
                    "ckpt_dir": str(tmp / "ckpt")})
    changes.update(extra or {})
    for key, value in changes.items():
        node = cfg
        *parents, leaf = key.split(".")
        for k in parents:
            node = node[k]
        node[leaf] = value
    cfg["val_dataset"] = dict(cfg["dataset"])
    print(f"train config {name}: configs/unise.yaml with "
          f"{json.dumps(changes)}, val_dataset = dataset", flush=True)
    path = tmp / f"{name}.yaml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    return path


class StepRecorder:
    """Wraps the trainer's phases for one run: each step's loss, accuracy,
    rate and wall time (``train_step`` ends in a host sync), the host's
    wait between steps (the data and the logging), the device time of the
    frozen inputs, the LM's forward + backward and the update (CUDA events),
    and a torch.profiler trace of step ``profile_at``."""

    def __init__(self, torch, trainer_cls, unise_cls, profile_at=None):
        self.torch, self.profile_at = torch, profile_at
        self.steps, self.trainer, self.targets = [], None, None
        self._last_end = None
        self._events = {}
        outer = self
        train_step = trainer_cls.train_step
        phases = [(unise_cls, "frozen_inputs"),
                  (trainer_cls, "loss_backward"), (trainer_cls, "update")]

        def timed(name, fn):
            def wrapper(*args, **kw):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(*args, **kw)
                b.record()
                outer._events[name] = (a, b)
                if name == "frozen_inputs":  # G + T + 2 targets a segment
                    outer.targets = out[2].shape[1] + out[3].shape[1] + 2
                return out
            return wrapper

        def step(trainer, task, *args):
            outer.trainer = trainer
            start = time.perf_counter()
            wait = (None if outer._last_end is None
                    else start - outer._last_end)
            lr = trainer.optimizer.lr
            prof = None
            if trainer.step + 1 == outer.profile_at:
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
            loss, acc = train_step(trainer, task, *args)
            end = time.perf_counter()
            if prof is not None:
                prof.__exit__(None, None, None)
                outer.busy = busy_share(torch, prof, end - start)
            outer.steps.append(dict(
                step=trainer.step, task=task, loss=loss, acc=acc, lr=lr,
                wall_s=end - start, wait_s=wait,
                **{f"{k}_ms": a.elapsed_time(b)
                   for k, (a, b) in outer._events.items()}))
            outer._last_end = end
            return loss, acc

        self.patches = [(trainer_cls, "train_step", step)] + [
            (cls, name, timed(name, getattr(cls, name)))
            for cls, name in phases]


def busy_share(torch, prof, wall_s):
    """-> (the share of ``wall_s`` in which the card ran a kernel or a
    copy, the device records' count): the union of their intervals."""
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy * 1e-6 / wall_s, len(spans)


def train_phase(torch, cli, pa, gpu, tmp, write_wav, read_wav):
    """Phase 7: UniSE's SFT training through ``cli train-unise`` at full
    width on the card; the card against the CPU on one batch; a resume; the
    step-30 checkpoint served through K2."""
    import contextlib
    import io
    from collections import Counter

    from unified_audio_tpu_torch.models.unise.model import UniSE
    from unified_audio_tpu_torch.train.optim import warmup_exp_decay_schedule
    from unified_audio_tpu_torch.train.sft_trainer import SFTTrainer

    rng = np.random.default_rng(9)
    scps = write_train_data(tmp, rng, write_wav)
    rec = StepRecorder(torch, SFTTrainer, UniSE, profile_at=PROFILED_STEP)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patched(rec.patches):
        trainer = cli.main(["train-unise", "--config", str(train_config(
            tmp, scps, TRAIN_STEPS, "train"))])
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = rec.steps
    if [r["step"] for r in steps] != list(range(1, TRAIN_STEPS + 1)):
        fail(f"trained steps {[r['step'] for r in steps]}")
    losses = [r["loss"] for r in steps]
    if not np.isfinite(losses).all():
        fail(f"a training loss is not finite: {losses}")
    ckpt_dir = tmp / "ckpt"
    records = [json.loads(l) for l in
               (ckpt_dir / "metrics.jsonl").read_text().splitlines()]
    val = {r["step"]: r["valid_loss"] for r in records if "valid_loss" in r}
    if sorted(val) != [15, 30] or not val[30] < val[15]:
        fail(f"validation loss {val}: it must fall from step 15 to step 30")
    ckpt30 = ckpt_dir / "step_00000030.pt"
    if not ckpt30.exists():
        fail("no checkpoint at step 30")
    timed_steps = [r for r in steps if r["step"] >= TIMED_FROM]
    step_ms = 1e3 * float(np.median([r["wall_s"] for r in timed_steps]))
    print(f"train-unise: {TRAIN_STEPS} steps of {BATCH} x 5 s at full width "
          f"(LM 512 x 12, XLSR-53 24 x 1024, WavLM-base-plus, BiCodec "
          f"encoder and speaker encoder; fp32, TF32 off) in {run_s:.1f} s; "
          f"losses {losses[0]:.4f} -> {losses[-1]:.4f}, all finite (by "
          f"step: {[round(x, 2) for x in losses]}); tasks "
          f"{dict(Counter(r['task'] for r in steps))}; validation loss "
          f"{val[15]:.4f} at step 15 -> {val[30]:.4f} at step 30 | {gpu}",
          flush=True)
    parts = {k: float(np.median([r[f"{k}_ms"] for r in timed_steps]))
             for k in ("frozen_inputs", "loss_backward", "update")}
    wait_ms = 1e3 * float(np.median([r["wait_s"] for r in timed_steps]))
    busy, n_records = rec.busy
    print(f"train step (median of steps {TIMED_FROM}-{TRAIN_STEPS}): wall "
          f"{step_ms:.1f} ms = {BATCH * rec.targets / step_ms * 1e3:.0f} "
          f"training tokens/s ({BATCH} x {rec.targets} targets a step); "
          f"device "
          f"time: tokenize + features (frozen) "
          f"{parts['frozen_inputs']:.1f} ms, LM forward + backward "
          f"{parts['loss_backward']:.1f} ms, optimizer {parts['update']:.1f} "
          f"ms; host data wait between steps {wait_ms:.1f} ms; device busy "
          f"{100 * busy:.1f}% of profiled step {PROFILED_STEP} "
          f"({n_records} CUDA records); peak memory allocated "
          f"{peak_gb:.2f} GB | {gpu}", flush=True)

    agreement(torch, cli, trainer, gpu)

    # resume: a few more steps on the same ckpt_dir
    rec2 = StepRecorder(torch, SFTTrainer, UniSE)
    err = io.StringIO()
    with patched(rec2.patches), contextlib.redirect_stderr(err):
        resumed = cli.main(["train-unise", "--config", str(train_config(
            tmp, scps, RESUME_STEPS, "resume"))])
    sys.stderr.write(err.getvalue())
    want_lr = warmup_exp_decay_schedule(warmup_steps=5)(TRAIN_STEPS)
    first = rec2.steps[0]
    if "resumed from step 30" not in err.getvalue() or first["step"] != 31 \
            or first["lr"] != want_lr or resumed.step != 33:
        fail(f"resume: first step {first['step']} at lr {first['lr']}, "
             f"schedule(30) = {want_lr}; stderr {err.getvalue()!r}")
    print(f"resumed at step 30: steps 31-{resumed.step}, first lr "
          f"{first['lr']:.9g} = schedule(30), losses "
          f"{[round(r['loss'], 4) for r in rec2.steps]}", flush=True)
    del trainer, resumed
    torch.cuda.empty_cache()

    # the step-30 checkpoint served through K2
    path, lines = write_requests(tmp, rng, write_wav,
                                 [("tse", 10.0, False)], "trained")
    pa.paged_flash_decode_owner_q8.launches = 0
    summary = cli.main(["serve", "--requests", str(path), "--kv-quant",
                        "int8", "--ckpt", str(ckpt30)])
    k2 = pa.paged_flash_decode_owner_q8.launches
    out, fs = read_wav(lines[0]["output"])
    st = summary["engine_stats"]
    if summary["segments"] != 2 or k2 < L * st["decode_steps"] or \
            out.shape != (1, 10 * SR) or not np.isfinite(out).all():
        fail(f"serving the trained checkpoint: {summary['segments']} "
             f"segments, K2 launches {k2}, output {out.shape}")
    print(f"serve --ckpt step 30 --kv-quant int8: 2 segments, "
          f"{st['decode_steps']} decode steps, K2 launches {k2}, output "
          f"{out.shape} finite | {gpu}", flush=True)
    return step_ms


def agreement(torch, cli, trainer, gpu):
    """One TSE batch of 2 segments from a seed through the trained stack
    on the card and a CPU copy of it: tokens equal in >= 99.9% of places,
    the loss within 1e-4 relative, each LM gradient within 1e-3 of its
    largest entry."""
    from unified_audio_tpu_torch.train.sft_trainer import SFTTrainer

    gpu_u = trainer.unise
    cpu_u = cli._build_unise(device="cpu", tokenize=True)
    for name in ("sft", "wavlm"):
        getattr(cpu_u, name).load_state_dict(getattr(gpu_u, name).state_dict())
    cpu_u.tokenizer.model.load_state_dict(gpu_u.tokenizer.model.state_dict())
    cpu_u.tokenizer.ssl.load_state_dict(gpu_u.tokenizer.ssl.state_dict())
    rng = np.random.default_rng(11)
    wavs = [np.stack([0.5 * synth_speech(rng, 5 * SR) + 0.05 *
                      rng.standard_normal(5 * SR) for _ in range(2)]).astype(
        np.float32) for _ in range(3)]
    out = []
    for u in (gpu_u, cpu_u):
        t = SFTTrainer(u)
        dev = t.device()
        frozen = u.frozen_inputs(*(torch.as_tensor(w, device=dev)
                                   for w in wavs))
        loss, _ = t.loss_backward("tse", frozen)
        out.append((frozen[2].cpu(), frozen[3].cpu(), loss.item(),
                    {k: p.grad.cpu() for k, p in u.sft.named_parameters()}))
        u.sft.zero_grad()
    (gg, gs, gl, ggrad), (cg, cs, cl, cgrad) = out
    same = torch.cat([(gg == cg).flatten(), (gs == cs).flatten()])
    share = same.float().mean().item()
    rel = abs(gl - cl) / abs(cl)
    grad_err = max(((ggrad[k] - g).abs().max() / g.abs().max()).item()
                   for k, g in cgrad.items())
    print(f"card vs CPU, one TSE batch of 2 x 5 s through the trained stack: "
          f"tokens equal {share:.5f} ({int(same.sum())} of {same.numel()}), "
          f"loss {gl:.9g} vs {cl:.9g} (rel {rel:.2e}), LM gradients max "
          f"|diff| / max |grad| {grad_err:.2e} | {gpu}", flush=True)
    if share < 0.999 or rel > 1e-4 or grad_err > 1e-3:
        fail("the card's training step disagrees with the CPU's")
    del cpu_u


# ---------------------------------------------------------------------------
# HCodec-1.0 GAN training
# ---------------------------------------------------------------------------

CODEC_STEPS = 30  # steps of the codec training run
CODEC_ADV_FROM = 10  # perceptual_start_step: steps 11-30 run the GAN terms
CODEC_BATCH, CODEC_SEG = 8, 48000  # configs/hcodec10.yaml: 8 x 3 s
CODEC_PROFILED_STEP = 20  # an adversarial step, traced for the busy share
# K5 launches the run implies: each of the 2 x 4 layers searches once a
# step, and on the first step its k-means searches 50 times plus once for
# the final bins
CODEC_K5 = 8 * CODEC_STEPS + 8 * (50 + 1)


def write_domain_data(tmp, rng, write_wav):
    """Synthetic domain SCP lists: 6 speech-like tone wavs ("speech") and 6
    band-limited noise wavs ("audio"), 4 s each at 16 kHz."""
    scps = {}
    for domain in ("speech", "audio"):
        lines = []
        for i in range(6):
            n = 4 * SR
            if domain == "speech":
                x = 0.5 * synth_speech(rng, n)
            else:
                x = np.convolve(rng.standard_normal(n), np.ones(8) / 8,
                                mode="same")
                x = 0.3 * x / np.abs(x).max()
            path = tmp / f"{domain}{i}.wav"
            write_wav(path, x.astype(np.float32), SR)
            lines.append(f"{domain}{i} s{i} {path}")
        (tmp / f"{domain}.scp").write_text("\n".join(lines) + "\n")
        scps[domain] = [str(tmp / f"{domain}.scp")]
    return scps


def codec_train_config(tmp, scps):
    """configs/hcodec10.yaml with the synthetic domains as its dataset, 30
    steps, the GAN terms from step 10 and the checkpoint directory in
    ``tmp`` (printed)."""
    from unified_audio_tpu_torch.utils.config import load_yaml

    cfg = load_yaml(REPO / "configs" / "hcodec10.yaml")
    changes = {"dataset": {"domain_scps": scps}, "max_steps": CODEC_STEPS,
               "train.perceptual_start_step": CODEC_ADV_FROM,
               "ckpt_dir": str(tmp / "codec_ckpt")}
    for key, value in changes.items():
        node = cfg
        *parents, leaf = key.split(".")
        for k in parents:
            node = node[k]
        node[leaf] = value
    print(f"train config codec: configs/hcodec10.yaml with "
          f"{json.dumps(changes)}", flush=True)
    path = tmp / "codec.yaml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    return path


class CodecStepRecorder:
    """Wraps codec training for one run: each step's metrics, domain and
    wall time (``train_step`` ends in one host read), the device time (CUDA
    events)
    of the HuBERT features, the generator's forward + backward, the
    discriminator's and each side's update, a torch.profiler trace of step
    ``profile_at``, the codebooks' state after step 1 and the first layer's
    k-means rows and initial codebook."""

    def __init__(self, torch, modules, profile_at):
        trainer_cls, optim_cls, ssl_cls, quant, data_cls = modules
        self.torch, self.profile_at = torch, profile_at
        self.steps, self.after_first, self.kmeans0 = [], None, None
        self.domains = []  # each batch's domain, in the order of the steps
        self._events, self._last_end = {}, None
        outer = self

        def timed(name, fn):
            def wrapper(self_, *args, **kw):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(self_, *args, **kw)
                b.record()
                key = name
                if name == "update":
                    key = ("gen_update" if self_ is outer.trainer.gen_opt
                           else "disc_update")
                outer._events[key] = (a, b)
                return out
            return wrapper

        train_step = trainer_cls.train_step
        outer.trainer = None

        def step(trainer, wav, feat):
            outer.trainer = trainer
            start = time.perf_counter()
            wait = None if outer._last_end is None else start - outer._last_end
            prof = None
            if trainer.step + 1 == outer.profile_at:
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
            outer._events.pop("disc_step", None)
            metrics = train_step(trainer, wav, feat)
            end = time.perf_counter()
            if prof is not None:
                prof.__exit__(None, None, None)
                outer.busy = busy_share(torch, prof, end - start)
            ms = {f"{k}_ms": a.elapsed_time(b)
                  for k, (a, b) in outer._events.items()}
            outer.steps.append(dict(step=trainer.step, wall_s=end - start,
                                    wait_s=wait, **metrics, **ms))
            if trainer.step == 1:
                outer.after_first = [
                    (q._codebook.initted.item(),
                     q._codebook.cluster_size.sum().item())
                    for rvq in (trainer.codec.quantizer,
                                trainer.codec.semantic_quantizer)
                    for q in rvq.layers]
            outer._last_end = end
            return metrics

        sample_vectors = quant.sample_vectors

        def recording_rows(samples, num, generator=None):
            out = sample_vectors(samples, num, generator)
            if outer.kmeans0 is None:
                outer.kmeans0 = (samples.clone(), out.clone())
            return out

        batches = data_cls._batches

        def recording_batches(self_):
            for wav, domain in batches(self_):
                outer.domains.append(domain)
                yield wav, domain

        self.patches = [
            (data_cls, "_batches", recording_batches),
            (trainer_cls, "train_step", step),
            (trainer_cls, "generator_step",
             timed("gen_step", trainer_cls.generator_step)),
            (trainer_cls, "discriminator_step",
             timed("disc_step", trainer_cls.discriminator_step)),
            (optim_cls, "step", timed("update", optim_cls.step)),
            (ssl_cls, "forward", timed("hubert", ssl_cls.forward)),
            (quant, "sample_vectors", recording_rows)]


def codec_train_phase(torch, cli, vq, gpu, tmp, write_wav, read_wav):
    """Phase 8: HCodec-1.0 GAN training through ``cli train-codec`` at full
    width on the card, the plain search made to raise; the card against
    the CPU on one step; K5 on k-means' duplicated codebook; the final
    checkpoint through ``cli codec --ckpt`` -> (K5's launches on the
    training path, K6's in that round trip, K5's times on k-means' start
    for the kernels line)."""
    from unified_audio_tpu_torch.data.hcodec_data import DomainWeightedIterator
    from unified_audio_tpu_torch.models.ssl.wav2vec2 import Wav2Vec2Model
    from unified_audio_tpu_torch.ops import quant
    from unified_audio_tpu_torch.train.codec_trainer import CodecGANTrainer
    from unified_audio_tpu_torch.train.optim import Optimizer

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain VQ search ran in codec training")

    rng = np.random.default_rng(13)
    config = codec_train_config(tmp, write_domain_data(tmp, rng, write_wav))
    rec = CodecStepRecorder(torch, (CodecGANTrainer, Optimizer,
                                    Wav2Vec2Model, quant,
                                    DomainWeightedIterator),
                            CODEC_PROFILED_STEP)
    guards = rec.patches + [(vq, "nearest_code_ref", forbidden),
                            (vq, "rvq_encode_fused_ref", forbidden)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9  # earlier phases' tensors
    vq.nearest_code.launches = 0
    t0 = time.perf_counter()
    with patched(guards):
        trainer = cli.main(["train-codec", "--config", str(config)])
    run_s = time.perf_counter() - t0
    k5 = vq.nearest_code.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - held_gb
    steps = rec.steps
    if [r["step"] for r in steps] != list(range(1, CODEC_STEPS + 1)):
        fail(f"codec training steps {[r['step'] for r in steps]}")
    names = ("mel", "commit", "semantic", "adv", "fm", "gen_loss",
             "disc_loss")
    values = np.array([[r[k] for k in names] for r in steps])
    if not np.isfinite(values).all():
        fail(f"a codec training loss is not finite: {values.tolist()}")
    mel = values[:, 0]
    # a batch is one domain's, and the noise domain's mel loss is the
    # larger: steps 26-30 against steps 1-5 within each domain
    domains = np.array(rec.domains[:CODEC_STEPS])
    falls = {}
    for d in sorted(set(domains)):
        first, last = mel[:5][domains[:5] == d], mel[-5:][domains[-5:] == d]
        if len(first) and len(last):
            falls[d] = (float(first.mean()), float(last.mean()))
    if not falls or any(b >= a for a, b in falls.values()):
        fail(f"mel loss (mean of steps 1-5, of 26-30) by domain: {falls}")
    adv_on = [r["step"] for r in steps if r["adv"] != 0.0]
    if adv_on != list(range(CODEC_ADV_FROM + 1, CODEC_STEPS + 1)):
        fail(f"the GAN terms ran at steps {adv_on}")
    m = CODEC_BATCH * CODEC_SEG // 640  # rows a layer searches: 8 x 75
    first = rec.after_first
    if len(first) != 8 or any(i != 1.0 or abs(n - m) > 1e-3 * m
                              for i, n in first):
        fail(f"after step 1 (initted, sum of cluster sizes) per layer: "
             f"{first}; want (1, {m}) each")
    if k5 != CODEC_K5:
        fail(f"K5 launched {k5} times in codec training, not {CODEC_K5}")
    ckpt = tmp / "codec_ckpt" / f"step_{CODEC_STEPS:08d}.pt"
    if not ckpt.exists():
        fail(f"no codec checkpoint at step {CODEC_STEPS}")
    print(f"train-codec: {CODEC_STEPS} steps of HCodec-1.0 at full width "
          f"({CODEC_BATCH} x 3 s, MPD 2/3/5/7/11 + MS-STFT "
          f"1024/2048/512, HuBERT-base frozen; fp32, TF32 off) in "
          f"{run_s:.1f} s; mel loss (mean of steps 1-5 -> of 26-30) by "
          f"domain {json.dumps(falls)}; every loss finite; by step domain "
          f"{''.join(d[0] for d in domains)}, mel "
          f"{[round(float(x), 3) for x in mel]}, gen "
          f"{[round(r['gen_loss'], 3) for r in steps]}, disc "
          f"{[round(r['disc_loss'], 3) for r in steps]}; after step 1 all 8 "
          f"layers initted, cluster sizes summing to "
          f"{[round(n, 3) for _, n in first]} (M = {m}); K5 launches {k5} "
          f"= {CODEC_K5} (8 a step + 8 x 51 for k-means), the plain search "
          f"unused | {gpu}", flush=True)

    timed_steps = [r for r in steps if r["step"] >= TIMED_FROM]
    step_ms = 1e3 * float(np.median([r["wall_s"] for r in timed_steps]))
    adv = [r for r in steps if r["step"] > CODEC_ADV_FROM]
    pre = [r for r in steps if TIMED_FROM <= r["step"] <= CODEC_ADV_FROM]
    med = lambda rows, k: float(np.median([r[k] for r in rows]))
    wait_ms = 1e3 * med(timed_steps, "wait_s")
    gen_fb = [r["gen_step_ms"] - r["gen_update_ms"] for r in adv]
    disc_fb = [r["disc_step_ms"] - r["disc_update_ms"] for r in adv]
    busy, n_records = rec.busy
    print(f"codec train step (median of steps {TIMED_FROM}-{CODEC_STEPS}): "
          f"wall {step_ms:.1f} ms = "
          f"{CODEC_BATCH * CODEC_SEG / SR / step_ms * 1e3:.1f} audio seconds"
          f" trained a second ({CODEC_BATCH} x 3 s a step); device time "
          f"(medians of the adversarial steps {CODEC_ADV_FROM + 1}-"
          f"{CODEC_STEPS}): HuBERT features {med(adv, 'hubert_ms'):.1f} ms, "
          f"generator forward + backward {float(np.median(gen_fb)):.1f} ms "
          f"({med(pre, 'gen_step_ms') - med(pre, 'gen_update_ms'):.1f} ms "
          f"before step {CODEC_ADV_FROM + 1}, without the GAN terms), "
          f"discriminator forward + backward {float(np.median(disc_fb)):.1f}"
          f" ms, generator update {med(adv, 'gen_update_ms'):.1f} ms, "
          f"discriminator update {med(adv, 'disc_update_ms'):.1f} ms; host "
          f"between steps {wait_ms:.1f} ms; device busy {100 * busy:.1f}% "
          f"of profiled step {CODEC_PROFILED_STEP} ({n_records} CUDA "
          f"records); peak memory allocated by the run {peak_gb:.2f} GB "
          f"(beside {held_gb:.2f} GB the earlier phases hold) | {gpu}",
          flush=True)

    codec_agreement(torch, vq, quant, trainer, gpu)

    # K5 on the first layer's k-means start: M = 600 rows against 1024 rows
    # drawn from them with replacement (duplicates in different CTAs)
    samples, init = (t.contiguous() for t in rec.kmeans0)
    got = vq.nearest_code(samples, init)
    want = vq.nearest_code_ref(samples, init)
    dups = init.shape[0] - torch.unique(init, dim=0).shape[0]
    if samples.shape[0] != m or not torch.equal(got, want):
        fail(f"K5 on k-means' initial codebook: {samples.shape[0]} rows, "
             f"codes equal {float((got == want).float().mean()):.5f}")
    plain, kern = in_turns(torch, [lambda: vq.nearest_code_ref(samples, init),
                                   lambda: vq.nearest_code(samples, init)],
                           iters=50, kernels=[None, CUDA_KERNELS["vq"]])
    b_ms, _ = vq_bound(m, VQ_SHAPES["n"], VQ_SHAPES["d"], 1)
    print(f"K5 on k-means' initial codebook at M={m}, N=1024, D=512 "
          f"({dups} duplicate rows): codes equal to plain exactly; kernel "
          f"{kern['ms'] * 1e3:.2f} us, plain {plain['ms'] * 1e3:.2f} us, "
          f"bound {b_ms * 1e3:.2f} us (3xTF32 at 495 TFLOP/s) | {gpu}",
          flush=True)

    # the final checkpoint served by the round trip through K6
    n = int(CLIP_S * SR)
    wav = 0.5 * synth_speech(rng, n) + 0.05 * rng.standard_normal(n)
    wav_in, wav_out = tmp / "codec_in.wav", tmp / "codec_out.wav"
    write_wav(wav_in, (0.8 * wav / np.abs(wav).max()).astype(np.float32), SR)
    from unified_audio_tpu_torch.models.hcodec.codec import HCodec
    codes = []
    encode = HCodec.encode

    def recording(self, w, f):
        codes.append(encode(self, w, f))
        return codes[-1]

    vq.rvq_encode_fused.launches = 0
    with patched([(HCodec, "encode", recording),
                  (vq, "nearest_code_ref", forbidden),
                  (vq, "rvq_encode_fused_ref", forbidden)]):
        summary = cli.main(["codec", "--model", "hcodec10", "--input",
                            str(wav_in), "--output", str(wav_out),
                            "--ckpt", str(ckpt)])
    k6 = vq.rvq_encode_fused.launches
    out, fs = read_wav(wav_out)
    ranges = [(int(c.min()), int(c.max())) for c in codes[0]]
    if k6 != 2 or summary["acoustic_shape"] != [1, 4, 250] or not all(
            0 <= lo and hi < 1024 for lo, hi in ranges) or \
            out.shape != (1, n) or not np.isfinite(out).all():
        fail(f"codec --ckpt of the trained checkpoint: K6 launches {k6}, "
             f"codes {summary['acoustic_shape']} in {ranges}, output "
             f"{out.shape}")
    print(f"codec --ckpt step {CODEC_STEPS}: codes (1, 4, 250) a stream in "
          f"{ranges}, K6 launches {k6}, a finite output of {n} samples | "
          f"{gpu}", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return k5, k6, {"max_abs_err": 0.0, "ms": kern["ms"],
                    "plain_ms": plain["ms"], "bound_ms": b_ms,
                    "records": kern["records"]}, step_ms


def codec_agreement(torch, vq, quant, trainer, gpu):
    """One generator step (the GAN terms on) of the trained codec on 2 x 3 s
    from a seed, on the card and on a CPU copy of the codec and the
    discriminators, the same dropout cutoffs: the card's codes under
    ``judge_codes`` and equal to the CPU's in >= 99.9% of places, each loss
    within 1e-4 relative, each generator gradient within 1e-3 of its
    largest entry."""
    from unified_audio_tpu_torch.models.hcodec.codec import HCodec
    from unified_audio_tpu_torch.train.codec_trainer import CodecGANTrainer
    from unified_audio_tpu_torch.train.discriminators import (
        CodecDiscriminator)

    rng = np.random.default_rng(12)
    wav = np.stack([0.5 * synth_speech(rng, CODEC_SEG) + 0.05 *
                    rng.standard_normal(CODEC_SEG) for _ in range(2)])
    feat = 0.5 * rng.standard_normal((2, CODEC_SEG // 320, 768))
    codec_cpu = HCodec(trainer.codec.config, trainable=True)
    codec_cpu.load_state_dict(trainer.codec.state_dict())
    disc_cpu = CodecDiscriminator()
    disc_cpu.load_state_dict(trainer.disc.state_dict())
    out = []
    for codec, disc in ((trainer.codec, trainer.disc), (codec_cpu, disc_cpu)):
        dev = next(codec.parameters()).device
        searches = []
        search = quant.nearest_code

        def recording(x, codebook):
            codes = search(x, codebook)
            searches.append((x.detach().reshape(-1, x.shape[-1]),
                             codebook.clone(), codes.reshape(-1)))
            return codes

        t = CodecGANTrainer(codec, trainer.cfg, disc,
                            torch.Generator().manual_seed(5))
        codec.zero_grad(set_to_none=True)  # the last update's gradients
        with patched([(quant, "nearest_code", recording)]):
            loss, scalars, _ = t.generator_loss(
                torch.as_tensor(wav, dtype=torch.float32, device=dev),
                torch.as_tensor(feat, dtype=torch.float32, device=dev), True)
        loss.backward()
        out.append(({k: v.item() for k, v in scalars.items()},
                    {k: p.grad.cpu() for k, p in codec.named_parameters()},
                    searches))
        codec.zero_grad(set_to_none=True)
    (g_s, g_grad, g_codes), (c_s, c_grad, c_codes) = out
    worst, equal, total = 0.0, 0, 0
    for (x, cb, codes), (_, _, cpu) in zip(g_codes, c_codes):
        _, w, ok = vq.judge_codes(x, [cb], codes[:, None])
        if not ok:
            fail(f"a card code of the training step is no near tie: {w}")
        worst = max(worst, w)
        equal += int((codes.cpu() == cpu).sum())
        total += codes.numel()
    rel = max(abs(g_s[k] - c_s[k]) / max(abs(c_s[k]), 1e-30) for k in c_s)
    grad_err = max(((g_grad[k] - g).abs().max() / g.abs().max()).item()
                   for k, g in c_grad.items() if g.abs().max() > 0)
    print(f"card vs CPU, one generator step (GAN terms on) of the trained "
          f"codec on 2 x 3 s: {len(g_codes)} searches, codes equal "
          f"{equal / total:.5f} ({equal} of {total}), worst distance excess "
          f"{worst:.3e}; losses max rel diff {rel:.2e} (gen "
          f"{g_s['gen_loss']:.6f} vs {c_s['gen_loss']:.6f}); generator "
          f"gradients max |diff| / max |grad| {grad_err:.2e} | {gpu}",
          flush=True)
    if equal / total < 0.999 or rel > 1e-4 or grad_err > 1e-3:
        fail("the card's codec training step disagrees with the CPU's")


# ---------------------------------------------------------------------------
# The JAX CLI's remaining commands: enhance, codec --dtype bfloat16, eval
# ---------------------------------------------------------------------------

ENHANCE_S = 7.5  # cli enhance's clip: two 5-s segments
EVAL_PAIRS = 4  # cli eval's noisy/clean pairs of 5 s
BF16_AGREE = 0.75  # bf16 codes against fp32 (the JAX package's bound)
NEAR_TIE = 1e-4  # a card token's gap to the CPU's top logit, relative
SNR_DB = 15.0  # decode SNR of the same codes, bf16 against fp32


def noisy_clean(rng, n, sr=SR):
    """A synthetic speech-like clip and a noisy copy, the same peak scale
    (0.8 at the noisy one's peak)."""
    clean = 0.5 * synth_speech(rng, n, sr)
    noisy = clean + 0.1 * rng.standard_normal(n)
    scale = 0.8 / np.abs(noisy).max()
    return ((noisy * scale).astype(np.float32),
            (clean * scale).astype(np.float32))


def teacher_forced_gaps(torch, unise, wav, g, s, task="se", enroll=None):
    """The card's greedy tokens ``g`` (B, 32) and ``s`` (B, 250) of
    ``task`` on ``wav`` (1, T), with the enrollment ``enroll`` (1, T_e)
    for "tse" and "rtse", teacher-forced through a CPU copy of ``unise``'s
    WavLM and LM (fp32) -> (each card token's gap to the CPU's top logit
    of its range, relative to |top| floored at 1, (B, 282); whether the
    CPU's argmax is the card's token, (B, 282))."""
    import copy

    from unified_audio_tpu_torch.models.lm.llama import range_mask
    from unified_audio_tpu_torch.models.unise.model import TASK_MAP

    sft = copy.deepcopy(unise.sft).cpu().float()
    cpu = type(unise)(unise.config, unise.tokenizer,
                      copy.deepcopy(unise.wavlm).cpu(), sft)
    cfg = sft.cfg
    segs, _ = cpu._segment(wav)
    enroll_feats = None
    if enroll is None:  # SE peak-normalizes its segments, TSE does not
        segs = segs / np.max(np.abs(wav), axis=-1, keepdims=True)
    else:
        enroll_feats = cpu.extract_semantic_features(enroll).expand(
            segs.shape[0], -1, -1)
    g = torch.as_tensor(g).long() + cfg.global_offset
    s = torch.as_tensor(s).long() + cfg.semantic_offset
    b, n_g = g.shape

    def col(i):
        return torch.full((b, 1), i, dtype=torch.long)

    # fed: [gSOS g1..g32 sSOS s1..s249]; position 32 predicts the discarded
    # 33rd global sample
    fed = torch.cat([col(cfg.global_sos), g, col(cfg.semantic_sos),
                     s[:, :-1]], 1)
    with torch.no_grad():
        embeds = torch.cat([sft.prompt(TASK_MAP[task], enroll_feats,
                                       cpu.extract_semantic_features(segs)),
                            sft.codec_embedding(fed)], 1)
        logits = sft.output_head(sft.backbone(embeds)[:, -fed.shape[1]:])
    ranged = torch.cat([
        logits[:, :n_g] + range_mask(cfg, cfg.global_offset, cfg.global_size),
        logits[:, n_g + 1:] + range_mask(cfg, cfg.semantic_offset,
                                         cfg.semantic_size)], 1).float()
    tokens = torch.cat([g, s], 1)
    top = ranged.max(-1).values
    mine = ranged.gather(-1, tokens[..., None])[..., 0]
    gap = (top - mine) / top.abs().clamp(min=1.0)
    return gap.numpy(), (ranged.argmax(-1) == tokens).numpy()


def enhance_phase(torch, cli, gpu, tmp, write_wav, read_wav):
    """Phase 9a: ``cli enhance --mode se``, then ``--mode ss``, on a 7.5-s
    noisy clip; every generate call's tokens (SE; ss's SE, TSE and rTSE)
    held to a CPU run of the same model."""
    from unified_audio_tpu_torch.models.unise.model import UniSE

    noisy, _ = noisy_clean(np.random.default_rng(9), int(ENHANCE_S * SR))
    write_wav(tmp / "noisy.wav", noisy, SR)
    built, calls = [], []
    build, decode = cli._build_unise, UniSE._decode_tokens

    def once(**kw):  # the stack is built by the first command only
        if not built:
            t0 = time.perf_counter()
            built.append(build(**kw))
            built.append(time.perf_counter() - t0)
        return built[0]

    def recording(self, g, s, orig_len):
        est = decode(self, g, s, orig_len)
        calls.append((torch.as_tensor(g).cpu().numpy(),
                      torch.as_tensor(s).cpu().numpy(), est))
        return est

    tokens = {}
    with patched([(cli, "_build_unise", once),
                  (UniSE, "_decode_tokens", recording)]):
        for mode in ("se", "ss"):
            calls.clear()
            out = tmp / f"enhanced_{mode}.wav"
            t0 = time.perf_counter()
            cli.main(["enhance", "--mode", mode, "--input",
                      str(tmp / "noisy.wav"), "--output", str(out)])
            wall = time.perf_counter() - t0
            unise, build_s = built
            cfg = unise.sft.cfg
            n_seg = unise._segment(noisy[None])[0].shape[0]
            outs = ([out] if mode == "se" else
                    [out.with_name(out.stem + f"_s{i}.wav") for i in (1, 2)])
            for path in outs:
                rec, fs = read_wav(path)
                if not (fs == SR and rec.shape == (1, noisy.size)
                        and np.isfinite(rec).all()):
                    fail(f"enhance {mode}: {path.name} of shape {rec.shape}"
                         f" at {fs} Hz")
            for g, s, _ in calls:
                # ss's first call: SE of the first segment alone
                if not (g.shape[0] == s.shape[0] in (1, n_seg)
                        and g.shape[1] == unise.config.global_tokens
                        and s.shape[1] == unise._semantic_len()
                        and 0 <= g.min() and g.max() < cfg.global_size
                        and 0 <= s.min() and s.max() < cfg.semantic_size):
                    fail(f"enhance {mode}: tokens {g.shape} {s.shape} out "
                         "of range")
            n_tok = sum(g.size + s.size for g, s, _ in calls)
            secs = wall - (build_s if mode == "se" else 0.0)
            print(f"cli enhance --mode {mode} ({ENHANCE_S} s, {n_seg} "
                  "segments): "
                  f"{len(calls)} generate call(s), {n_tok} tokens in "
                  f"{secs:.2f} s = {n_tok / secs:.0f} tokens/s (wall "
                  f"{wall:.2f} s{f' with the {build_s:.1f} s build' if mode == 'se' else ''}"
                  f"); outputs {[p.name for p in outs]} finite | {gpu}",
                  flush=True)
            tokens[mode] = list(calls)
    # ss: SE of the first segment, whose output (cut to one segment and
    # scaled to a 0.99 peak, as separate_ss does) is TSE's and rTSE's
    # enrollment over every segment
    ss_se, ss_tse, ss_rtse = tokens["ss"]
    seg = unise.config.segment_len
    est = ss_se[2][:seg]
    enroll = est[None] / (np.max(np.abs(est)) + 1e-5) * 0.99
    for name, wav, (g, s, _), task, enr in (
            ("se", noisy[None], tokens["se"][0], "se", None),
            ("ss se", noisy[None, :seg], ss_se, "se", None),
            ("ss tse", noisy[None], ss_tse, "tse", enroll),
            ("ss rtse", noisy[None], ss_rtse, "rtse", enroll)):
        gap, same = teacher_forced_gaps(torch, unise, wav, g, s, task, enr)
        parted = np.argwhere(~same)
        print(f"enhance {name} tokens teacher-forced through the CPU's LM: "
              f"{same.mean():.5f} equal to the CPU's argmax, largest gap to "
              f"the top logit {gap.max():.3e} (relative; limit {NEAR_TIE}); "
              "first step where they part: "
              f"{tuple(int(i) for i in parted[0]) if parted.size else 'none'}"
              " (segment, step)", flush=True)
        if not gap.max() <= NEAR_TIE:
            fail(f"enhance {name}: a card token is {gap.max():.3e} below the "
                 "CPU's top logit")
    return unise


def bf16_residual_codes(torch, vq, lat, books):
    """The JAX package's bf16 encode: each layer's search on the fp32
    values, the residual rounded to bf16 after each layer -> (M, nq)."""
    residual, codes = lat, []
    for cb in books:
        idx = vq.nearest_code_ref(residual.float(), cb.float())
        residual = residual - cb[idx.long()]
        codes.append(idx)
    return torch.stack(codes, -1)


def codec_bf16_phase(torch, cli, vq, gpu, tmp, write_wav, read_wav):
    """Phase 9b: ``cli codec --dtype bfloat16`` for HCodec-1.0 and 2.0 on
    10-s clips -> K6 launches of the two round trips."""

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain VQ search ran in the kernel round trip")

    k6_launches = 0
    for model, sr in (("hcodec10", SR), ("hcodec20", SR20)):
        n = int(CLIP_S * sr)
        wav, _ = noisy_clean(np.random.default_rng(10), n, sr)
        clip, out = tmp / f"{model}.wav", tmp / f"{model}_bf16.wav"
        write_wav(clip, wav, sr)
        built = []
        build = cli._build_hcodec

        def recording(*args, **kw):
            built.append(build(*args, **kw))
            return built[-1]

        with patched([(cli, "_build_hcodec", recording),
                      (vq, "nearest_code_ref", forbidden),
                      (vq, "rvq_encode_fused_ref", forbidden)]):
            vq.rvq_encode_fused.launches = 0
            summary = cli.main(["codec", "--model", model, "--dtype",
                                "bfloat16", "--input", str(clip),
                                "--output", str(out)])
            k6 = vq.rvq_encode_fused.launches
        if k6 != 2:
            fail(f"{model} bf16: K6 launched {k6} times in a round trip")
        k6_launches += k6
        t16 = built[0]
        lstm_dtypes = {p.dtype for m in t16.codec.modules()
                       if isinstance(m, torch.nn.LSTM)
                       for p in m.parameters()}
        if t16.dtype != torch.bfloat16 or lstm_dtypes != {torch.bfloat16}:
            fail(f"{model} bf16: codec {t16.dtype}, LSTMs {lstm_dtypes}")
        rec, fs = read_wav(out)
        if not (fs == sr and rec.shape == (1, n) and np.isfinite(rec).all()):
            fail(f"{model} bf16 output of shape {rec.shape} at {fs} Hz")
        t32 = cli._build_hcodec(model, device="cuda")  # same seed, fp32
        x = torch.as_tensor(read_wav(clip)[0], device="cuda")
        c32, c16 = t32.tokenize(x), t16.tokenize(x)
        nq = c16[0].shape[1]
        agree = float(np.mean([float((a == b).float().mean())
                               for a, b in zip(c32, c16)]))
        # K6 on the bf16 path's own fp32 latents against the plain search,
        # and against the JAX package's bf16-rounded residual
        worst, dev, first = 0.0, [], None
        for lat, rvq, codes in zip(t16.latents(x), (
                t16.codec.quantizer, t16.codec.semantic_quantizer), c16):
            lat = lat.reshape(-1, lat.shape[-1])
            flat = codes.transpose(-1, -2).reshape(-1, nq)
            share, w, ok = vq.judge_codes(lat.float().contiguous(),
                                          rvq.fp32_codebooks(), flat)
            worst = max(worst, w)
            if not ok:
                fail(f"{model} bf16: K6 codes off the plain search ({w})")
            per_layer = (bf16_residual_codes(torch, vq, lat, rvq.codebooks())
                         == flat).float().mean(0).cpu().numpy()
            dev.append(per_layer)
            parted = np.flatnonzero(per_layer < 1.0)
            if parted.size and (first is None or parted[0] < first):
                first = int(parted[0])
        dev = np.concatenate(dev)
        r32 = t32.detokenize(*c32)
        r16 = t16.detokenize(*c32)
        if r16.dtype != torch.float32:
            fail(f"{model} bf16 decode gave {r16.dtype}")
        snr = float(10 * torch.log10(r32.square().mean()
                                     / (r16 - r32).square().mean()))
        print(f"{model} bf16 through cli codec: codes "
              f"{summary['acoustic_shape']}, K6 launches {k6}; codes equal "
              f"to fp32 {agree:.5f} (limit {BF16_AGREE}); K6 on the bf16 "
              f"latents vs the plain search: worst distance excess "
              f"{worst:.3e}; vs a bf16-rounded residual (the JAX package's "
              f"encode) {dev.mean():.5f} equal over {nq} layers x 2 streams,"
              f" layer 0 {min(dev[0], dev[nq]):.5f}, first layer below 1: "
              f"{first}; decode SNR of the fp32 codes, bf16 vs fp32 "
              f"{snr:.2f} dB (limit {SNR_DB}) | {gpu}", flush=True)
        if agree < BF16_AGREE or not snr > SNR_DB:
            fail(f"{model} bf16: agreement {agree}, SNR {snr}")

        def roundtrip(tok):
            return lambda: tok.detokenize(*tok.tokenize(x))

        walls = {"fp32": [], "bf16": []}
        for tok in (t32, t16):
            roundtrip(tok)()
        for _ in range(10):  # in turns
            for name, tok in (("fp32", t32), ("bf16", t16)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                roundtrip(tok)()
                torch.cuda.synchronize()
                walls[name].append(time.perf_counter() - t0)
        med = {k: float(np.median(v)) for k, v in walls.items()}
        print(f"{model} round trip of {CLIP_S:.0f} s, fp32 and bf16 in "
              f"turns, median of 10: fp32 {med['fp32'] * 1e3:.2f} ms (rtfx "
              f"{CLIP_S / med['fp32']:.2f}), bf16 {med['bf16'] * 1e3:.2f} ms "
              f"(rtfx {CLIP_S / med['bf16']:.2f}) | {gpu}", flush=True)
        del t32, t16
        built.clear()
        torch.cuda.empty_cache()
    return k6_launches


def eval_phase(torch, cli, vq, gpu, tmp, write_wav):
    """Phase 9c: ``cli eval --mode se --spk-sim --utmos-ckpt`` over 4
    noisy/clean pairs, then ``roundtrip_codec_eval`` through the bf16
    HCodec-1.0 -> K6 launches of the round trips."""
    from unified_audio_tpu_torch.eval.runner import roundtrip_codec_eval
    from unified_audio_tpu_torch.eval.utmos import UTMOSConfig, UTMOSHead
    from unified_audio_tpu_torch.utils.initialization import init_random_

    rng = np.random.default_rng(11)
    for d in ("noisy", "clean"):
        (tmp / d).mkdir()
    for i in range(EVAL_PAIRS):
        noisy, clean = noisy_clean(rng, 5 * SR)
        write_wav(tmp / "noisy" / f"u{i}.wav", noisy, SR)
        write_wav(tmp / "clean" / f"u{i}.wav", clean, SR)
    head = init_random_(UTMOSHead(UTMOSConfig()),
                        torch.Generator().manual_seed(12))
    torch.save(head.state_dict(), tmp / "utmos.pt")
    t0 = time.perf_counter()
    summary = cli.main(["eval", "--mode", "se", "--test-dir",
                        str(tmp / "noisy"), "--tgt-dir", str(tmp / "clean"),
                        "--spk-sim", "--utmos-ckpt", str(tmp / "utmos.pt")])
    wall = time.perf_counter() - t0
    want = {"num_utts", "stoi", "pesq", "pesq_mos_lqo", "utmos_learned",
            "si_snr", "lsd", "spk_sim"}
    if set(summary) != want or summary["num_utts"] != EVAL_PAIRS or not all(
            np.isfinite(v) for v in summary.values()):
        fail(f"cli eval summary {summary}")
    print(f"cli eval --mode se --spk-sim --utmos-ckpt over {EVAL_PAIRS} "
          f"pairs of 5 s: {json.dumps(summary)}; {wall:.2f} s with the "
          f"build, {wall / EVAL_PAIRS:.2f} s an utterance | {gpu}",
          flush=True)

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain VQ search ran in roundtrip_codec_eval")

    tok = cli._build_hcodec("hcodec10", device="cuda", dtype=torch.bfloat16)
    with patched([(vq, "rvq_encode_fused_ref", forbidden)]):
        vq.rvq_encode_fused.launches = 0
        rt = roundtrip_codec_eval(tok, sorted((tmp / "clean").glob("*.wav")))
        k6 = vq.rvq_encode_fused.launches
    if k6 != 2 * EVAL_PAIRS or not all(np.isfinite(v) for v in rt.values()):
        fail(f"roundtrip_codec_eval: K6 launches {k6}, summary {rt}")
    print(f"roundtrip_codec_eval, bf16 HCodec-1.0, {EVAL_PAIRS} clips: "
          f"{json.dumps(rt)}; K6 launches {k6}", flush=True)
    return k6


# ---------------------------------------------------------------------------
# HCodec-1.5 adaptive and FlexiCodec through cli codec
# ---------------------------------------------------------------------------

NEAR_SIM = 1e-5  # |similarity - threshold| within which a boundary may flip
GROUP_CODES_AGREE = 0.995  # card codes equal to the CPU's (a near tie at one
# layer parts the rest of its row)
FLEXI_AGREE = 0.999  # FlexiCodec's card codes equal to the CPU's
ROUNDTRIP_RUNS = 5  # round trips a median wall is taken over


def write_am_mvn(path, dim=560, seed=0):
    """A synthetic Kaldi nnet CMVN file: shifts near minus a log-mel mean,
    rescales near one over its spread."""
    rng = np.random.default_rng(seed)

    def row(v):
        return " ".join(f"{x:.6f}" for x in v)

    path.write_text(
        f"<Nnet>\n<Splice> {dim} {dim}\n[ 0 ]\n<AddShift> {dim} {dim}\n"
        f"<LearnRateCoef> 0 [ {row(-(12.0 + rng.standard_normal(dim)))} ]\n"
        f"<Rescale> {dim} {dim}\n<LearnRateCoef> 0 [ "
        f"{row(0.3 + 0.05 * rng.random(dim))} ]\n</Nnet>\n")
    return path


def cpu_copy(torch, module):
    """An eval copy of ``module`` on the CPU (same weights)."""
    import copy

    return copy.deepcopy(module).to("cpu").eval()


def timed_roundtrip(torch, fn, label, gpu):
    """Median wall of ROUNDTRIP_RUNS calls of ``fn`` (one warm-up), then two
    calls under torch.profiler (CUPTI: device time, kernel launches, busy
    share) -> (rtfx, the profile dict); prints one line."""
    from unified_audio_tpu_torch.models.hcodec.profile_roundtrip import (
        profile_calls)

    wall, lo, hi = median_wall(torch, fn, ROUNDTRIP_RUNS)
    prof = profile_calls(fn, 2, wall * 1e3)
    rtfx = CLIP_S / wall
    dev = prof["device_ms"]
    print(f"{label} round trip of {CLIP_S:.0f} s: rtfx {rtfx:.2f} (median of "
          f"{ROUNDTRIP_RUNS}: {wall * 1e3:.2f} ms, range {lo * 1e3:.2f}-"
          f"{hi * 1e3:.2f}); device "
          f"{'not measured' if dev is None else f'{dev:.2f} ms'}, busy "
          f"{prof['device_busy_share'] or 0:.3f}, {prof['launches']:.0f} "
          f"kernel launches; top kernels "
          f"{[(k['name'][:40], round(k['ms'], 3)) for k in prof['top_kernels'][:3]]}"
          f" | {gpu}", flush=True)
    return rtfx, prof


def hcodec15_phase(torch, cli, vq, gpu, tmp, write_wav, read_wav):
    """Phase 10a: ``cli codec --model hcodec15`` on a 10-s clip at
    ``adaptive15_config()`` width -> (K6 launches of the round trip, K6's
    timing at the aggregated rows)."""
    from unified_audio_tpu_torch.models.hcodec import adaptive
    from unified_audio_tpu_torch.models.hcodec.adaptive_tokenizer import (
        AdaptiveHCodecTokenizer)

    rng = np.random.default_rng(13)
    n = int(CLIP_S * SR)
    wav = 0.5 * synth_speech(rng, n) + 0.05 * rng.standard_normal(n)
    clip, out = tmp / "clip15.wav", tmp / "clip15_out.wav"
    write_wav(clip, (0.8 * wav / np.abs(wav).max()).astype(np.float32), SR)
    built = []
    build = cli._build_hcodec15

    def recording(*args, **kw):
        built.append(build(*args, **kw))
        return built[-1]

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain VQ search ran in the kernel round trip")

    with patched([(cli, "_build_hcodec15", recording),
                  (vq, "nearest_code_ref", forbidden),
                  (vq, "rvq_encode_fused_ref", forbidden)]):
        vq.rvq_encode_fused.launches = 0
        t0 = time.perf_counter()
        summary = cli.main(["codec", "--model", "hcodec15", "--input",
                            str(clip), "--output", str(out)])
        cli_s = time.perf_counter() - t0
        k6_launches = vq.rvq_encode_fused.launches
    if k6_launches != 2:
        fail(f"hcodec15: K6 launched {k6_launches} times in one round trip, "
             "not 2")
    t = int(CLIP_S * SR) // 640
    if summary["acoustic_shape"] != [1, 4, t]:
        fail(f"hcodec15: acoustic codes of shape {summary['acoustic_shape']}")
    rec, fs = read_wav(out)
    if not (fs == SR and rec.shape == (1, n) and np.isfinite(rec).all()):
        fail(f"hcodec15: round-trip wav of shape {rec.shape} at {fs} Hz")
    tok = built[0]
    codec, cfg = tok.codec, tok.codec.config
    x = torch.as_tensor(read_wav(clip)[0], device="cuda")
    xp = tok.pad_wav(x)
    with torch.no_grad():
        feats = tok.extract_features(xp)
        a_groups, s_groups, gid, counts = codec.align(xp[..., None], feats)
        codes = tok.tokenize(x)
    size = cfg.base.codebook_size
    groups = int((counts > 0).sum())
    for name in ("acoustic_codes", "semantic_codes"):
        c = codes[name].transpose(-1, -2)
        plain, lengths = adaptive.extract_length(c, size)
        valid = lengths[0] > 0
        if not (c.shape == (1, t, 4) and int(lengths.sum()) == t
                and int(valid.sum()) == groups
                and bool(valid[:groups].all())
                and bool(((c >= 0) == valid[None, :, None]).all())
                and int(lengths.max()) <= cfg.max_group_len
                and 0 <= int(plain[0, :groups].min())
                and int(plain.max()) < size):
            fail(f"hcodec15 {name}: shape {tuple(c.shape)}, lengths summing "
                 f"to {int(lengths.sum())}, {int(valid.sum())} groups "
                 f"({groups} aggregated)")
    rate = float(codes["token_rate_hz"][0])
    if not (abs(rate - groups / CLIP_S) < 1e-4
            and summary["tokens_per_sec"] == round(rate, 2)):
        fail(f"hcodec15: token rate {rate} for {groups} groups, JSON line "
             f"{summary['tokens_per_sec']}")
    # K6 on the live aggregated groups (zero rows at the padding groups)
    worst, timing = 0.0, None
    for rows, rvq, c in ((a_groups, codec.quantizer, codes["acoustic_codes"]),
                         (s_groups, codec.semantic_quantizer,
                          codes["semantic_codes"])):
        flat = rows.reshape(-1, rows.shape[-1]).contiguous()
        pad = (counts == 0).reshape(-1)
        if not bool((flat[pad] == 0).all()):
            fail("hcodec15: a padding group's row is not zero")
        books = rvq.fp32_codebooks()
        got = vq.rvq_encode_fused(flat, books)
        share, w, ok = vq.judge_codes(flat, books, got)
        worst = max(worst, w)
        kept = c.transpose(-1, -2).reshape(-1, 4)[~pad] % size
        if not (ok and share >= 0.999
                and torch.equal(got[~pad].long(), kept.long())):
            fail(f"hcodec15: K6 on the aggregated groups: {share:.5f} equal "
                 f"to the plain search, worst excess {w:.3e}, or not the "
                 "codes of tokenize")
        if timing is None:
            plain_t, kern_t = in_turns(
                torch, [lambda: vq.rvq_encode_fused_ref(flat, books),
                        lambda: vq.rvq_encode_fused(flat, books)],
                iters=50, kernels=[None, CUDA_KERNELS["vq"]])
            timing = {"M": flat.shape[0], "padding_rows": int(pad.sum()),
                      "ms": kern_t["ms"], "plain_ms": plain_t["ms"],
                      "bound_ms": vq_bound(flat.shape[0], VQ_SHAPES["n"],
                                           VQ_SHAPES["d"], 4)[0],
                      "records": kern_t["records"], "max_abs_err": worst}
    timing["max_abs_err"] = worst
    print(f"hcodec15 through cli codec ({cli_s:.1f} s with the build): codes "
          f"{summary['acoustic_shape']}, {groups} groups of {t} frames "
          f"(token rate {rate:.2f} Hz), K6 launches {k6_launches}; K6 on the "
          f"aggregated groups (M={timing['M']}, {timing['padding_rows']} zero "
          f"padding rows) vs the plain search: worst distance excess "
          f"{worst:.3e}; kernel {timing['ms'] * 1e3:.2f} us, plain "
          f"{timing['plain_ms'] * 1e3:.2f} us, bound "
          f"{timing['bound_ms'] * 1e3:.2f} us | {gpu}", flush=True)

    def roundtrip():
        c = tok.tokenize(x)
        return tok.detokenize(c["acoustic_codes"], c["semantic_codes"])

    timed_roundtrip(torch, roundtrip, "hcodec15", gpu)

    # the card against a CPU copy of the same weights: group ids where no
    # similarity lies within NEAR_SIM of the threshold, then the codes
    cpu_tok = AdaptiveHCodecTokenizer(cpu_copy(torch, codec),
                                      cpu_copy(torch, tok.ssl))
    t0 = time.perf_counter()
    with torch.no_grad():
        feats_c = cpu_tok.extract_features(xp.cpu())
        sem_c = cpu_tok.codec.semantic_encoder(feats_c)
        sem_g = codec.semantic_encoder(feats)
    thr = cfg.similarity_threshold
    sims_c = adaptive.consecutive_similarities(sem_c)[0]
    sims_g = adaptive.consecutive_similarities(sem_g)[0].cpu()
    near = ((sims_c - thr).abs() <= NEAR_SIM) | ((sims_g - thr).abs()
                                                  <= NEAR_SIM)
    gid_c = adaptive.similarity_group_ids(sem_c, thr, cfg.max_group_len)[0]
    upto = int(near.nonzero()[0]) + 1 if bool(near.any()) else t
    same_ids = torch.equal(gid_c[:upto], gid[0, :upto].cpu())
    feat_err = float((feats_c - feats.cpu()).abs().max()
                     / feats_c.abs().max())
    print(f"hcodec15 card vs CPU: XLSR features max |diff| / max "
          f"{feat_err:.2e}; similarities max |diff| "
          f"{float((sims_c - sims_g).abs().max()):.2e}, {int(near.sum())} "
          f"within {NEAR_SIM} of the threshold {thr}, smallest margin "
          f"{float((sims_c - thr).abs().min()):.3e}; group ids equal over "
          f"{upto} of {t} frames: {same_ids}", flush=True)
    if not same_ids:
        fail("hcodec15: the card's group ids differ from the CPU's away from "
             "the threshold")
    if upto == t:
        with torch.no_grad():
            codes_c = cpu_tok.tokenize(x.cpu())
        eq = [float((codes_c[k] == codes[k].cpu()).float().mean())
              for k in ("acoustic_codes", "semantic_codes")]
        print(f"hcodec15 card vs CPU codes (CPU {time.perf_counter() - t0:.1f}"
              f" s): acoustic {eq[0]:.5f}, semantic {eq[1]:.5f} equal "
              f"(limit {GROUP_CODES_AGREE})", flush=True)
        if min(eq) < GROUP_CODES_AGREE:
            fail(f"hcodec15: card codes equal to the CPU's in {eq}")
    else:
        print("hcodec15 card vs CPU codes: not compared (a similarity lies "
              f"within {NEAR_SIM} of the threshold)", flush=True)
    del cpu_tok, tok, built[:]
    torch.cuda.empty_cache()
    return k6_launches, timing


def flexicodec_phase(torch, cli, gpu, tmp, write_wav, read_wav):
    """Phase 10b: ``cli codec --model flexicodec`` on a 10-s clip with each
    semantic stream (log-fbank, ``--cmvn``, ``--cmvn --sensevoice-ckpt``),
    each run's codes held to a CPU copy of the same model."""
    from unified_audio_tpu_torch.models.hcodec.flexicodec import (
        match_frame_rate)
    from unified_audio_tpu_torch.models.ssl.sanm import (
        SenseVoiceSemanticEncoder, sensevoice_small_config)
    from unified_audio_tpu_torch.utils.initialization import init_random_

    rng = np.random.default_rng(14)
    n = int(CLIP_S * SR)
    wav = 0.5 * synth_speech(rng, n) + 0.05 * rng.standard_normal(n)
    clip, out = tmp / "clip_flexi.wav", tmp / "clip_flexi_out.wav"
    write_wav(clip, (0.8 * wav / np.abs(wav).max()).astype(np.float32), SR)
    am = write_am_mvn(tmp / "am.mvn")
    with torch.device("cuda"):
        teacher = SenseVoiceSemanticEncoder(sensevoice_small_config())
    init_random_(teacher, torch.Generator(device="cuda").manual_seed(21))
    sv = tmp / "sensevoice.pt"
    torch.save({k: v.cpu() for k, v in teacher.state_dict().items()}, sv)
    del teacher
    built = []
    build = cli._build_flexicodec

    def recording(*args, **kw):
        built.append(build(*args, **kw))
        return built[-1]

    x = torch.as_tensor(read_wav(clip)[0], device="cuda")
    for name, cmvn, ckpt in (("log-fbank", None, None), ("cmvn", am, None),
                             ("SAN-M teacher", am, sv)):
        extra = ((["--cmvn", str(cmvn)] if cmvn else [])
                 + (["--sensevoice-ckpt", str(ckpt)] if ckpt else []))
        built.clear()
        with patched([(cli, "_build_flexicodec", recording)]):
            t0 = time.perf_counter()
            summary = cli.main(["codec", "--model", "flexicodec", "--input",
                                str(clip), "--output", str(out), *extra])
            cli_s = time.perf_counter() - t0
        model = built[0]
        mcfg = model.config
        t = n // mcfg.hop_length
        rec, fs = read_wav(out)
        if not (summary["acoustic_shape"] == [1, t, mcfg.n_codebooks]
                and fs == SR and rec.shape == (1, t * mcfg.hop_length)
                and np.isfinite(rec).all()):
            fail(f"flexicodec {name}: codes {summary['acoustic_shape']}, wav "
                 f"of shape {rec.shape}")
        cmvn_s = str(cmvn) if cmvn else None
        teacher = cli._build_sensevoice(ckpt, "cuda") if ckpt else None

        def semantic(x, teacher):
            return match_frame_rate(cli.flexicodec_semantic(
                x, mcfg.ssl_dim, cmvn_s, teacher), 2 * t)

        with torch.no_grad():
            sem_g = semantic(x, teacher)
            ac_g, sc_g = model.encode(x, sem_g)
            cpu = cpu_copy(torch, model)
            sem_c = semantic(x.cpu(), teacher and cpu_copy(torch, teacher))
            ac_c, sc_c = cpu.encode(x.cpu(), sem_c)
        sem_err = float((sem_g.cpu() - sem_c).abs().max()
                        / sem_c.abs().max())
        eq_a = float((ac_g.cpu() == ac_c).float().mean())
        eq_s = float((sc_g.cpu() == sc_c).float().mean())
        print(f"flexicodec ({name} stream) through cli codec ({cli_s:.1f} s "
              f"with the build): codes {summary['acoustic_shape']} + "
              f"semantic {list(sc_g.shape)}, {summary['tokens_per_sec']} "
              f"frames/s; card vs CPU: semantic stream max |diff| / max "
              f"{sem_err:.2e}, FSQ codes {eq_s:.5f} and DAC codes {eq_a:.5f} "
              f"equal (limit {FLEXI_AGREE}) | {gpu}", flush=True)
        if min(eq_a, eq_s) < FLEXI_AGREE:
            fail(f"flexicodec {name}: card codes equal to the CPU's in "
                 f"{eq_a}, {eq_s}")
        del cpu

        def roundtrip():
            return model.decode(*model.encode(x, semantic(x, teacher)))

        with torch.no_grad():
            timed_roundtrip(torch, roundtrip, f"flexicodec ({name})", gpu)
    built.clear()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 11: the causal codecs and the remaining training objectives
# ---------------------------------------------------------------------------

CAUSAL_STEPS = 10  # steps of the causal codec training run
CAUSAL_ADV_FROM = 5  # perceptual_start_step: steps 6-10 run the GAN terms
CAUSAL_PROFILED_STEP = 8
CAUSAL_K5 = 8 * CAUSAL_STEPS + 8 * (50 + 1)
TRAIN_BATCH = 4  # phase 11's training forwards: 4 clips a batch
TRAIN_SEG_S = 3.0
PRETRAIN_WAVS = 16  # 5-s wavs tokenized into the pretraining shards
PRETRAIN_STEPS = 20
UNITOK_SEG_S = 5.0


def hold(what, got, want, rel):
    """Fail unless |got - want| <= rel |want|; -> the relative gap."""
    gap = abs(got - want) / max(abs(want), 1e-30)
    if not gap <= rel:
        fail(f"{what}: card {got!r} against the CPU's {want!r} (relative "
             f"gap {gap:.2e} > {rel})")
    return gap


def clips(rng, b, n, sr=SR):
    """(b, n) synthetic speech-like clips, fp32 numpy."""
    return np.stack([0.5 * synth_speech(rng, n, sr) + 0.05 *
                     rng.standard_normal(n) for _ in range(b)]).astype(
                         np.float32)


def causal_train_phase(torch, cli, vq, gpu, tmp, write_wav):
    """Phase 11a: ``cli train-codec`` of a causal HCodec-1.0
    (``configs/hcodec10.yaml`` plus ``codec: {causal: true}``) for
    ``CAUSAL_STEPS`` steps of 8 x 3 s, the plain search made to raise;
    one generator step of the trained codec against a CPU copy
    (``codec_agreement``) -> K5's launches on the training path."""
    from unified_audio_tpu_torch.data.hcodec_data import DomainWeightedIterator
    from unified_audio_tpu_torch.models.ssl.wav2vec2 import Wav2Vec2Model
    from unified_audio_tpu_torch.ops import quant
    from unified_audio_tpu_torch.train.codec_trainer import CodecGANTrainer
    from unified_audio_tpu_torch.train.optim import Optimizer
    from unified_audio_tpu_torch.utils.config import load_yaml

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain VQ search ran in codec training")

    rng = np.random.default_rng(31)
    cfg = load_yaml(REPO / "configs" / "hcodec10.yaml")
    changes = {"codec": {"causal": True}, "max_steps": CAUSAL_STEPS,
               "dataset": {"domain_scps": write_domain_data(tmp, rng,
                                                            write_wav)},
               "ckpt_dir": str(tmp / "causal_ckpt")}
    cfg.update(changes)
    cfg["train"]["perceptual_start_step"] = CAUSAL_ADV_FROM
    path = tmp / "causal.yaml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    rec = CodecStepRecorder(torch, (CodecGANTrainer, Optimizer,
                                    Wav2Vec2Model, quant,
                                    DomainWeightedIterator),
                            CAUSAL_PROFILED_STEP)
    torch.cuda.empty_cache()
    vq.nearest_code.launches = 0
    t0 = time.perf_counter()
    with patched(rec.patches + [(vq, "nearest_code_ref", forbidden),
                                (vq, "rvq_encode_fused_ref", forbidden)]):
        trainer = cli.main(["train-codec", "--config", str(path)])
    run_s = time.perf_counter() - t0
    k5 = vq.nearest_code.launches
    steps = rec.steps
    enc = trainer.codec.encoder.model
    if not (trainer.codec.config.causal and enc[0].causal
            and enc[14].causal):
        fail("train-codec with codec: {causal: true} built a non-causal "
             "codec")
    if [r["step"] for r in steps] != list(range(1, CAUSAL_STEPS + 1)):
        fail(f"causal codec training steps {[r['step'] for r in steps]}")
    names = ("mel", "commit", "semantic", "adv", "fm", "gen_loss",
             "disc_loss")
    values = np.array([[r[k] for k in names] for r in steps])
    if not np.isfinite(values).all():
        fail(f"a causal codec training loss is not finite: "
             f"{values.tolist()}")
    if k5 != CAUSAL_K5:
        fail(f"K5 launched {k5} times in causal codec training, not "
             f"{CAUSAL_K5}")
    timed = [r for r in steps if r["step"] >= 3]
    step_ms = 1e3 * float(np.median([r["wall_s"] for r in timed]))
    busy, n_records = rec.busy
    print(f"train-codec causal HCodec-1.0: {CAUSAL_STEPS} steps of "
          f"{CODEC_BATCH} x 3 s (the GAN terms from step "
          f"{CAUSAL_ADV_FROM + 1}) in {run_s:.1f} s with the build; step "
          f"wall {step_ms:.1f} ms (median of steps 3-{CAUSAL_STEPS}) = "
          f"{CODEC_BATCH * CODEC_SEG / SR / step_ms * 1e3:.1f} audio s/s; "
          f"device busy {100 * busy:.1f}% of profiled step "
          f"{CAUSAL_PROFILED_STEP} ({n_records} CUDA records); mel by step "
          f"{[round(float(x), 3) for x in values[:, 0]]}; K5 launches {k5} "
          f"= {CAUSAL_K5} (8 a step + 8 x 51 for k-means), the plain search "
          f"unused | {gpu}", flush=True)
    codec_agreement(torch, vq, quant, trainer, gpu)
    del trainer
    torch.cuda.empty_cache()
    return k5


def causal_roundtrip_phase(torch, cli, vq, gpu):
    """Phase 11b: a 10-s 16 kHz clip through a causal HCodec-1.0 and a 10-s
    48 kHz clip through a causal HCodec-2.0 (``HCodecTokenizer``, random
    weights): K6 twice a round trip, codes equal to a CPU copy's, the rtfx
    (median of ROUNDTRIP_RUNS), then the acoustic encoder's causality on the
    card -> K6's launches."""
    from unified_audio_tpu_torch.models.hcodec.codec import (hcodec10_config,
                                                             hcodec20_config)
    from unified_audio_tpu_torch.models.hcodec.tokenizer import (
        HCodecTokenizer)

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain VQ search ran in the kernel round trip")

    k6_total = 0
    for model, cfg, sr, seed in (("hcodec10", hcodec10_config(causal=True),
                                  SR, 32),
                                 ("hcodec20", hcodec20_config(causal=True),
                                  SR20, 33)):
        tok = cli._build_hcodec(model, seed=seed, device="cuda", cfg=cfg)
        n = int(CLIP_S * sr)
        x = torch.as_tensor(clips(np.random.default_rng(seed), 1, n, sr),
                            device="cuda")
        with patched([(vq, "nearest_code_ref", forbidden),
                      (vq, "rvq_encode_fused_ref", forbidden)]):
            vq.rvq_encode_fused.launches = 0
            codes = tok.tokenize(x)
            out = tok.detokenize(*codes)
            k6 = vq.rvq_encode_fused.launches
        k6_total += k6
        t = n // cfg.hop_length
        if k6 != 2 or codes[0].shape != (1, cfg.num_quantizers, t) or \
                out.shape != (1, n) or not bool(torch.isfinite(out).all()):
            fail(f"causal {model}: K6 launched {k6} times, codes "
                 f"{tuple(codes[0].shape)}, output {tuple(out.shape)}")
        wall, lo, hi = median_wall(
            torch, lambda: tok.detokenize(*tok.tokenize(x)), ROUNDTRIP_RUNS)
        t0 = time.perf_counter()
        cpu = HCodecTokenizer(cpu_copy(torch, tok.codec),
                              cpu_copy(torch, tok.ssl))
        eq, judged = codes_vs_cpu(torch, vq, cpu, x.cpu(), codes)
        cpu_s = time.perf_counter() - t0
        del cpu
        # causality: samples from the clip's middle on replaced; the latents
        # of the frames whose receptive field ends before them must hold
        start = n // 2
        y = x.clone()
        y[:, start:] = torch.randn(1, n - start, device="cuda",
                                   generator=torch.Generator(
                                       device="cuda").manual_seed(seed))
        with torch.no_grad():
            za, zb = (tok.codec.encoder(w[..., None] if model == "hcodec10"
                                        else w) for w in (x, y))
        if model == "hcodec10":  # frame i reads samples < 640 (i + 1)
            kept = start // cfg.hop_length
        else:  # frame i reads STFT frames <= 4 i + 3, samples < 3840 i + 4320
            kept = (start - 4320) // 3840 + 1
        diff = (za - zb).abs().amax(-1)[0] / za.abs().max()
        before, after = float(diff[:kept].max()), float(diff[kept:].min())
        print(f"causal {model} round trip of {CLIP_S:.0f} s at {sr} Hz: "
              f"codes {list(codes[0].shape)} a stream, K6 launches {k6}, "
              f"rtfx {CLIP_S / wall:.2f} (median of {ROUNDTRIP_RUNS}: "
              f"{wall * 1e3:.2f} ms, range {lo * 1e3:.2f}-{hi * 1e3:.2f}); "
              f"card vs CPU codes acoustic {eq[0]:.5f}, semantic {eq[1]:.5f} "
              f"equal; layer by layer on the CPU's latents {judged[0]:.5f}, "
              f"{judged[1]:.5f} (CPU {cpu_s:.1f} s; limit "
              f"{GROUP_CODES_AGREE}, the rest near ties); "
              f"causality: samples from {start} replaced, encoder latents of "
              f"frames 0-{kept - 1} moved by {before:.2e} of the latents' "
              f"max, frames {kept}-{t - 1} by at least {after:.2e} | {gpu}",
              flush=True)
        if min(judged) < GROUP_CODES_AGREE:
            fail(f"causal {model}: card codes equal to the CPU's search in "
                 f"{judged} of places")
        if not (before <= 1e-5 and after > 1e-3):
            fail(f"causal {model}: the encoder is not causal on the card "
                 f"({before:.2e} before frame {kept}, {after:.2e} after)")
        del tok
        torch.cuda.empty_cache()
    return k6_total


def codes_vs_cpu(torch, vq, cpu_tok, x, codes):
    """The card's codes (acoustic, semantic; each (1, nq, T)) against a CPU
    copy of the tokenizer on the same wav ``x`` -> (the share of codes equal
    to the CPU tokenize's, the share equal to the CPU's search layer by
    layer, per stream). The second runs ``judge_codes`` on the CPU's
    latents: each layer's code against the plain search of the residual
    the card's own earlier codes leave, so that one near tie counts once
    and not again in every later layer of its frame; a code that differs
    must be a near tie, or the run fails."""
    with torch.no_grad():
        cpu_codes = cpu_tok.tokenize(x)
        latents = cpu_tok.latents(x)
    eq, judged = [], []
    for c, cc, lat, rvq in zip(codes, cpu_codes, latents,
                               (cpu_tok.codec.quantizer,
                                cpu_tok.codec.semantic_quantizer)):
        eq.append(float((c.cpu() == cc).float().mean()))
        share, worst, ok = vq.judge_codes(
            lat.reshape(-1, lat.shape[-1]), rvq.codebooks(),
            c.cpu().transpose(-1, -2).reshape(-1, c.shape[1]))
        if not ok:
            fail(f"a card code parts from the CPU's search by more than a "
                 f"near tie (distance excess {worst:.3e})")
        judged.append(share)
    return eq, judged


def handed_draws(torch, quant, seed):
    """Patches handing the same k-means rows and dropout cutoffs to every
    run (the card's and the CPU copy's), drawn from ``seed`` on the host;
    ``reset()`` starts the sequence again."""
    state = {}

    def reset():
        state["rng"] = np.random.default_rng(seed)

    def rows(m, num, generator=None):
        r = state["rng"]
        idx = r.permutation(m)[:num] if m >= num else r.integers(0, m, num)
        return torch.as_tensor(idx).long()

    def cut(nq, generator=None):
        return int(state["rng"].integers(0, nq))

    reset()
    return ([(quant, "sample_rows", rows), (quant, "dropout_cutoff", cut)],
            reset)


def grad_norms(module, groups):
    """-> {group: global L2 norm of the gradients of the parameters whose
    names start with one of its prefixes}."""
    out = {}
    for name, prefixes in groups.items():
        sq = [p.grad.double().square().sum().item()
              for k, p in module.named_parameters()
              if p.grad is not None and k.startswith(prefixes)]
        out[name] = float(np.sqrt(sum(sq)))
    return out


def adaptive_train_phase(torch, vq, xlsr, gpu):
    """Phase 11c: HCodec-1.5's training forward + backward at
    ``adaptive15_config()`` width on 4 x 3 s with XLSR-53 features, two
    steps (k-means on the first; the first two profiled, the third's wall
    unprofiled); then row 0 on the card against a CPU copy from the same
    state with the same draws -> K5's launches."""
    from unified_audio_tpu_torch.models.hcodec import adaptive
    from unified_audio_tpu_torch.models.hcodec.adaptive_tokenizer import (
        AdaptiveHCodecTokenizer)
    from unified_audio_tpu_torch.models.hcodec.profile_roundtrip import (
        profile_calls)
    from unified_audio_tpu_torch.ops import quant
    from unified_audio_tpu_torch.train.discriminators import (
        multiscale_mel_loss)
    from unified_audio_tpu_torch.utils.initialization import init_random_

    cfg = adaptive.adaptive15_config()
    with torch.device("cuda"):
        codec = adaptive.AdaptiveHCodec(cfg, trainable=True)
    init_random_(codec, torch.Generator(device="cuda").manual_seed(34))
    state0 = {k: v.clone() for k, v in codec.state_dict().items()}
    n = int(TRAIN_SEG_S * SR)
    x = torch.as_tensor(clips(np.random.default_rng(34), TRAIN_BATCH, n),
                        device="cuda")
    with torch.no_grad():
        feats = AdaptiveHCodecTokenizer(codec, xlsr).extract_features(x)
    codec.train()  # the tokenizer put it in eval; cuDNN's LSTM backward
    thr = cfg.similarity_threshold

    def loss_terms(model, w, f):
        recon, pred, commit = model(w[..., None], f, train=True,
                                    threshold=thr)
        mel = multiscale_mel_loss(w[:, :recon.shape[-1]], recon)
        sem = (pred - f).abs().mean()
        return 15.0 * mel + commit + sem, {"mel": mel, "commit": commit,
                                           "semantic": sem}

    patches, reset = handed_draws(torch, quant, 35)
    def step():
        codec.zero_grad(set_to_none=True)
        total, _ = loss_terms(codec, x, feats)
        total.backward()

    # steps 1 (k-means) and 2 under the profiler (CUPTI device time and
    # launches), step 3 without it for the wall
    steps = []
    with patched(patches):
        for i in range(3):
            vq.nearest_code.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prof = profile_calls(step, 1) if i < 2 else step()
            torch.cuda.synchronize()
            steps.append((1e3 * (time.perf_counter() - t0), prof,
                          vq.nearest_code.launches))
    k5_steps = [n for _, _, n in steps]
    if k5_steps != [8 * 52, 8, 8]:
        fail(f"hcodec15 training: K5 launched {k5_steps} times in steps "
             f"1-3, not [{8 * 52}, 8, 8]")
    k5 = sum(k5_steps)
    with torch.no_grad():
        counts = codec.align(x[..., None], feats, thr)[3]
    groups = int((counts > 0).sum())

    # row 0, card against CPU, from the initial state with the same draws
    groups_of = {"encoder": ("encoder.",),
                 "aggregators": ("acoustic_aggregator.",
                                 "semantic_aggregator."),
                 "bottleneck": ("bottleneck_transformer.",),
                 "decoder": ("decoder.",)}
    out = []
    cpu = adaptive.AdaptiveHCodec(cfg, trainable=True)
    for model, dev in ((codec, "cuda"), (cpu, "cpu")):
        model.load_state_dict({k: v.to(dev) for k, v in state0.items()})
        model.zero_grad(set_to_none=True)
        reset()
        w, f = x[:1].to(dev), feats[:1].to(dev)
        with patched(patches):
            total, terms = loss_terms(model, w, f)
            total.backward()
            with torch.no_grad():
                emb = model.semantic_encoder(f)
                gid = adaptive.similarity_group_ids(emb, thr,
                                                    cfg.max_group_len)
                sims = adaptive.consecutive_similarities(emb)
        out.append(({k: v.item() for k, v in terms.items()},
                    grad_norms(model, groups_of), gid.cpu(), sims.cpu()))
    (g_t, g_n, g_id, g_s), (c_t, c_n, c_id, c_s) = out
    near = ((g_s - thr).abs() <= NEAR_SIM) | ((c_s - thr).abs() <= NEAR_SIM)
    upto = (int(near[0].nonzero()[0]) + 1 if bool(near.any())
            else g_id.shape[1])
    if not torch.equal(g_id[:, :upto], c_id[:, :upto]):
        fail("hcodec15 training: the card's group ids differ from the CPU's "
             "away from the threshold")
    loss_gap = max(hold(f"hcodec15 {k}", g_t[k], c_t[k], 1e-4) for k in c_t)
    grad_gap = max(hold(f"hcodec15 |grad| {k}", g_n[k], c_n[k], 1e-3)
                   for k in c_n)
    del cpu
    (w1, p1, _), (w2, p2, _), (w3, _, _) = steps
    print(f"hcodec15 training forward + backward (adaptive15_config(), "
          f"{TRAIN_BATCH} x 3 s, XLSR-53 features, threshold {thr}): {groups}"
          f" groups of {TRAIN_BATCH} x {counts.shape[1]} frames; step 1 (k-"
          f"means) device {p1['device_ms']:.1f} ms, {p1['launches']:.0f} "
          f"launches ({w1:.1f} ms wall under the profiler); step 2 device "
          f"{p2['device_ms']:.1f} ms, {p2['launches']:.0f} launches ("
          f"{w2:.1f} ms profiled); step 3 wall {w3:.1f} ms unprofiled, busy "
          f"{p2['device_ms'] / w3:.3f}; K5 launches {k5} (8 x 52, then 8 a "
          f"step); row 0 card vs CPU: loss terms "
          f"max rel gap {loss_gap:.2e} ({json.dumps({k: round(v, 6) for k, v in c_t.items()})}), "
          f"gradient norms by part max rel gap {grad_gap:.2e}, group ids "
          f"equal over {upto} of {g_id.shape[1]} frames | {gpu}", flush=True)
    del codec
    torch.cuda.empty_cache()
    return k5


def flexicodec_train_phase(torch, cli, gpu):
    """Phase 11d: FlexiCodec's training forward + backward at full width on
    4 x 3 s (the log-fbank semantic stream, HuBERT ``teacher_features`` as
    the distillation target), in the DualCodec and the aligned mode; row 0
    forward against a CPU copy. The weights are ``init_random_``'s with
    every bias drawn too (normal, std 0.02): with zero biases the aligned
    mode's padding groups decode to latents of exactly zero, whose nearest
    DAC code is an exact tie over the whole unit codebook, which the card
    and the CPU break differently (a trained model's biases are not
    zero)."""
    import dataclasses as dc

    from unified_audio_tpu_torch.models.hcodec.flexicodec import (
        FlexiCodec, FlexiCodecConfig, match_frame_rate, teacher_features)
    from unified_audio_tpu_torch.models.hcodec.profile_roundtrip import (
        profile_calls)
    from unified_audio_tpu_torch.models.ssl.wav2vec2 import (
        Wav2Vec2Model, hubert_base_config)
    from unified_audio_tpu_torch.utils.initialization import init_random_

    with torch.device("cuda"):
        hubert = Wav2Vec2Model(hubert_base_config())
    init_random_(hubert, torch.Generator(device="cuda").manual_seed(36))
    hubert.eval()
    n = int(TRAIN_SEG_S * SR)
    x = torch.as_tensor(clips(np.random.default_rng(36), TRAIN_BATCH, n),
                        device="cuda")
    teacher = teacher_features(hubert, x)
    del hubert
    base = FlexiCodecConfig(sample_rate=SR)
    t = n // base.hop_length
    sem = match_frame_rate(cli.flexicodec_semantic(x, base.ssl_dim), 2 * t)
    for mode, cfg in (("DualCodec", base),
                      ("aligned", dc.replace(
                          base, use_similarity_alignment=True,
                          use_query_token_aggregator=True,
                          use_bottleneck_transformer=True))):
        with torch.device("cuda"):
            model = FlexiCodec(cfg, trainable=True)
        gen = torch.Generator(device="cuda").manual_seed(37)
        init_random_(model, gen)
        with torch.no_grad():
            for m in model.modules():
                if getattr(m, "bias", None) is not None:
                    m.bias.normal_(0.0, 0.02, generator=gen)

        def step():
            model.zero_grad(set_to_none=True)
            out = model(x, sem, teacher)
            total = (out["recons"] - x[:, :out["recons"].shape[-1]]).abs(
            ).mean() + out["commit_loss"] + out["distill_loss"]
            total.backward()
            return out

        wall, lo, hi = median_wall(torch, step, 3)
        prof = profile_calls(step, 1, wall * 1e3)
        cpu = cpu_copy(torch, model)
        with torch.no_grad():
            g = model(x[:1], sem[:1], teacher[:1])
            c = cpu(x[:1].cpu(), sem[:1].cpu(), teacher[:1].cpu())
        gaps = {k: hold(f"flexicodec {mode} {k}", float(g[k]), float(c[k]),
                        1e-4) for k in ("commit_loss", "distill_loss")}
        r = c["recons"]
        rec_gap = float((g["recons"].cpu() - r).abs().max() / r.abs().max())
        eq = float((g["acoustic_codes"].cpu() == c["acoustic_codes"]).float()
                   .mean())
        groups = ("" if g["group_ids"] is None else
                  f", {int(g['group_ids'].max()) + 1} groups of {t} frames")
        print(f"flexicodec {mode} training forward + backward ({TRAIN_BATCH}"
              f" x 3 s, log-fbank stream, HuBERT teacher features{groups}): "
              f"wall {wall * 1e3:.1f} ms (median of 3, range {lo * 1e3:.1f}-"
              f"{hi * 1e3:.1f}), device {prof['device_ms']:.1f} ms, busy "
              f"{prof['device_busy_share'] or 0:.3f}, {prof['launches']:.0f} "
              f"launches; row 0 card vs CPU: commit_loss gap "
              f"{gaps['commit_loss']:.2e}, distill_loss gap "
              f"{gaps['distill_loss']:.2e}, recons max |diff| / max "
              f"{rec_gap:.2e}, DAC codes {eq:.5f} equal | {gpu}", flush=True)
        if rec_gap > 1e-4 or eq < FLEXI_AGREE:
            fail(f"flexicodec {mode}: recons gap {rec_gap:.2e}, codes "
                 f"equal {eq:.5f}")
        del model, cpu
        torch.cuda.empty_cache()


def pretrain_phase(torch, xlsr, gpu, tmp, write_wav):
    """Phase 11e: 16 synthetic 5-s wavs tokenized into shards by the
    card's BiCodec tokenizer (``tokenize_corpus``), then 20
    ``PretrainTrainer`` steps at ``LlamaConfig()`` width fed by
    ``TokenCorpusIterator`` (batch 16 x (32 + 250)), the reference's
    optimizer with a 5-step warmup (the default 2,000 would keep the rate
    near 0 for the whole run): the loss must fall; the first step's loss
    held to a CPU copy."""
    from unified_audio_tpu_torch.data.token_corpus import (
        TokenCorpusIterator, tokenize_corpus)
    from unified_audio_tpu_torch.models.bicodec.bicodec import (BiCodec,
                                                                BiCodecConfig)
    from unified_audio_tpu_torch.models.bicodec.tokenizer import (
        BiCodecTokenizer)
    from unified_audio_tpu_torch.models.lm.llama import CodecLM, LlamaConfig
    from unified_audio_tpu_torch.train.optim import Optimizer
    from unified_audio_tpu_torch.train.pretrain import PretrainTrainer
    from unified_audio_tpu_torch.utils.initialization import init_random_

    rng = np.random.default_rng(38)
    n = int(5 * SR)
    paths = []
    for i in range(PRETRAIN_WAVS):
        p = tmp / f"pre{i}.wav"
        write_wav(p, clips(rng, 1, n)[0], SR)
        paths.append(p)
    with torch.device("cuda"):
        bicodec = BiCodec(BiCodecConfig(), tokenize=True)
    init_random_(bicodec, torch.Generator(device="cuda").manual_seed(38))
    t0 = time.perf_counter()
    shards = tokenize_corpus(BiCodecTokenizer(bicodec, xlsr).eval(), paths,
                             tmp / "shards", utterances_per_shard=16)
    tok_s = time.perf_counter() - t0
    del bicodec
    cfg = LlamaConfig()
    with torch.device("cuda"):
        model = CodecLM(cfg)
    init_random_(model, torch.Generator(device="cuda").manual_seed(39))
    trainer = PretrainTrainer(cfg, model, Optimizer(model.parameters(),
                                                    warmup_steps=5),
                              device="cuda")
    cpu = CodecLM(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in
                         trainer.model.state_dict().items()})
    batches, walls, metrics = [], [], []
    train_step = PretrainTrainer.train_step

    def recording(self, g, s, cond=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(self, g, s, cond)
        walls.append(time.perf_counter() - t0)
        metrics.append(out)
        batches.append((g, s))
        return out

    data = TokenCorpusIterator(shards, batch_size=16, semantic_len=250,
                               seed=40)
    with patched([(PretrainTrainer, "train_step", recording)]):
        trainer.fit(data, max_steps=PRETRAIN_STEPS, log_every=10)
    g, s = batches[0]
    if g.shape != (16, 32) or s.shape != (16, 250) or len(shards) != 1:
        fail(f"pretraining batches {g.shape} + {s.shape} from "
             f"{len(shards)} shards")
    with torch.no_grad():
        want, want_acc = cpu.pretrain_loss(torch.as_tensor(g),
                                           torch.as_tensor(s))
    gap = hold("pretraining step 1 loss", metrics[0][0], float(want), 1e-4)
    losses = np.array([m[0] for m in metrics])
    if not (np.isfinite(losses).all() and losses[-5:].mean() < losses[0]):
        fail(f"pretraining losses {losses.tolist()}: not finite, or the "
             "last 5 not below the first")
    step_s = float(np.median(walls[2:]))
    tokens = 16 * (32 + 250 + 1)
    print(f"pretraining: {PRETRAIN_WAVS} wavs of 5 s tokenized by BiCodec "
          f"into {len(shards)} shards in {tok_s:.1f} s; {PRETRAIN_STEPS} "
          f"PretrainTrainer steps of LlamaConfig() ({cfg.hidden_size} x "
          f"{cfg.num_layers}), batch 16 x (32 + 250): step wall "
          f"{step_s * 1e3:.1f} ms (median of steps 3-{PRETRAIN_STEPS}) = "
          f"{tokens / step_s:.0f} training tokens/s; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, accuracy "
          f"{metrics[0][1]:.4f} -> {metrics[-1][1]:.4f}; step 1 loss vs CPU "
          f"relative gap {gap:.2e} | {gpu}", flush=True)
    del trainer, cpu
    torch.cuda.empty_cache()


def unitok_train_phase(torch, vq, tok, gpu):
    """Phase 11f: ``UniTokPipeline.train_loss`` forward + backward with the
    full-width UniTok LM (fp32) over the HCodec-1.0 tokenizer, tasks
    "codec" and "tse" (a reference wav), 4 x 5 s: K6 twice a call (the
    target's tokenize); row 0's loss and accuracy held to a CPU copy of the
    LM on the card's codes and features, the CPU tokenizer's codes equal to
    the card's -> K6's launches."""
    from unified_audio_tpu_torch.models.unitok.model import (UNITOK_TASKS,
                                                             UniTokConfig,
                                                             UniTokLM)
    from unified_audio_tpu_torch.models.unitok.pipeline import UniTokPipeline
    from unified_audio_tpu_torch.utils.initialization import init_random_

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain VQ search ran in the target's tokenize")

    with torch.device("cuda"):
        lm = UniTokLM(UniTokConfig())
    init_random_(lm, torch.Generator(device="cuda").manual_seed(3))
    pipe = UniTokPipeline(tok, lm.train())
    cpu_lm = cpu_copy(torch, lm).train()
    rng = np.random.default_rng(41)
    n = int(UNITOK_SEG_S * SR)
    inp, tgt = (torch.as_tensor(clips(rng, TRAIN_BATCH, n), device="cuda")
                for _ in range(2))
    ref = torch.as_tensor(clips(rng, TRAIN_BATCH, 3 * 640), device="cuda")
    k6 = 0
    for task in ("codec", "tse"):
        r = ref if task == "tse" else None
        lm.zero_grad(set_to_none=True)
        with patched([(vq, "nearest_code_ref", forbidden),
                      (vq, "rvq_encode_fused_ref", forbidden)]):
            vq.rvq_encode_fused.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, acc = pipe.train_loss(task, inp, tgt, ref_wav=r)
            loss.backward()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = vq.rvq_encode_fused.launches
        k6 += launches
        loss, acc = loss.item(), acc.item()
        if launches != 2 or not np.isfinite(loss):
            fail(f"unitok train_loss {task}: K6 launched {launches} times, "
                 f"loss {loss}")
        # row 0 on the CPU: the LM on the card's codes and features, and the
        # CPU tokenizer's codes
        with torch.no_grad():
            codes = pipe.audio_to_codes(tgt[:1])
            feats = tok.extract_features(inp[:1])
            rf = tok.extract_features(r[:1]) if r is not None else None
            g_loss, g_acc = lm.loss(UNITOK_TASKS[task], None, rf, feats,
                                    codes)
            c_loss, c_acc = cpu_lm.loss(UNITOK_TASKS[task], None,
                                        None if rf is None else rf.cpu(),
                                        feats.cpu(), codes.cpu())
        gap = hold(f"unitok {task} loss", float(g_loss), float(c_loss), 1e-4)
        hold(f"unitok {task} accuracy", float(g_acc), float(c_acc), 1e-4)
        print(f"unitok train_loss {task} ({TRAIN_BATCH} x 5 s, UniTokConfig()"
              f" fp32{', a reference wav' if r is not None else ''}): loss "
              f"{loss:.4f}, accuracy {acc:.4f}; forward + "
              f"backward {wall * 1e3:.1f} ms wall (the first call's "
              f"one-time costs included for \"codec\"); K6 launches "
              f"{launches}; row 0 vs a CPU copy of the LM"
              f" on the same codes: loss gap {gap:.2e} | {gpu}", flush=True)
    from unified_audio_tpu_torch.models.hcodec.tokenizer import (
        HCodecTokenizer)
    cpu_tok = HCodecTokenizer(cpu_copy(torch, tok.codec),
                              cpu_copy(torch, tok.ssl))
    with torch.no_grad():
        got = pipe.audio_to_codes(tgt[:1]).cpu()
        want = UniTokPipeline(cpu_tok, cpu_lm).audio_to_codes(tgt[:1].cpu())
    eq = float((got == want).float().mean())
    print(f"unitok target codes, card vs CPU tokenizer: {eq:.5f} equal "
          f"(limit {GROUP_CODES_AGREE})", flush=True)
    if eq < GROUP_CODES_AGREE:
        fail(f"unitok: the card's target codes equal the CPU's in {eq}")
    del pipe, lm, cpu_lm, cpu_tok
    torch.cuda.empty_cache()
    return k6


def training_objectives_phase(torch, cli, vq, tok, gpu, tmp, write_wav):
    """Phase 11 -> (K5 launches, K6 launches) on its paths."""
    from unified_audio_tpu_torch.models.ssl.wav2vec2 import (
        Wav2Vec2Model, wav2vec2_large_xlsr53_config)
    from unified_audio_tpu_torch.utils.initialization import init_random_

    t0 = time.perf_counter()
    k5 = causal_train_phase(torch, cli, vq, gpu, tmp, write_wav)
    k6 = causal_roundtrip_phase(torch, cli, vq, gpu)
    with torch.device("cuda"):
        xlsr = Wav2Vec2Model(wav2vec2_large_xlsr53_config())
    init_random_(xlsr, torch.Generator(device="cuda").manual_seed(30)).eval()
    k5 += adaptive_train_phase(torch, vq, xlsr, gpu)
    flexicodec_train_phase(torch, cli, gpu)
    pretrain_phase(torch, xlsr, gpu, tmp, write_wav)
    del xlsr
    k6 += unitok_train_phase(torch, vq, tok, gpu)
    print(f"phase 11 took {time.perf_counter() - t0:.1f} s; K5 launches "
          f"{k5}, K6 launches {k6} on its paths", flush=True)
    return k5, k6



# ---------------------------------------------------------------------------
# Phase 12: parallel training through torch.distributed at world size 1
# ---------------------------------------------------------------------------

TORCHRUN_STEPS = 8  # train-unise steps under torchrun
PAR_CODEC_STEPS, PAR_CODEC_ADV_FROM = 5, 2  # phase 12's codec runs
PAR_SEQ = (4, 540)  # (B, S) of the pipeline and sequence-parallel forwards


def metrics_by_step(path):
    return {r["step"]: r for r in map(json.loads,
                                      Path(path).read_text().splitlines())
            if "loss" in r}


def torchrun_phase(torch, cli, gpu, tmp, write_wav, train_ms):
    """Phase 12 (a): ``cli train-unise`` under ``torchrun`` (NCCL, world 1)
    against the same configuration's run without it."""
    import os

    scps = write_train_data(tmp, np.random.default_rng(9), write_wav)
    one_worker = {"dataset.num_workers": 1, "tp": 1, "log_every": 1}
    paths = {name: train_config(tmp, scps, steps, name, dict(
        one_worker, ckpt_dir=str(tmp / f"ckpt_{name}")))
        for name, steps in (("torchrun", TORCHRUN_STEPS), ("single", 2))}
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = str(REPO)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "unified_audio_tpu_torch.cli",
         "train-unise", "--config", str(paths["torchrun"])],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    run_s = time.perf_counter() - t0
    joined = [l for l in proc.stderr.splitlines() if l.startswith("torchrun:")]
    if proc.returncode != 0 or not joined or "nccl group of 1" not in \
            joined[0]:
        fail(f"train-unise under torchrun: rc {proc.returncode}, "
             f"{joined}; stderr tail {proc.stderr[-3000:]}")
    par = metrics_by_step(tmp / "ckpt_torchrun" / "metrics.jsonl")
    torch.cuda.empty_cache()
    cli.main(["train-unise", "--config", str(paths["single"])])
    torch.cuda.empty_cache()
    single = metrics_by_step(tmp / "ckpt_single" / "metrics.jsonl")
    if sorted(par) != list(range(1, TORCHRUN_STEPS + 1)) or \
            not np.isfinite([r["loss"] for r in par.values()]).all():
        fail(f"torchrun steps {sorted(par)}")
    for step in (1, 2):
        for k in ("loss", "acc"):
            a, b = par[step][k], single[step][k]
            if abs(a - b) > 1e-5 * max(abs(b), 1e-6):
                fail(f"step {step} {k} under torchrun {a} vs {b} without")
    walls = [par[s]["wall_s"] - par[s - 1]["wall_s"]
             for s in range(3, TORCHRUN_STEPS + 1)]
    step_ms = 1e3 * float(np.median(walls))
    print(f"{joined[0]}", flush=True)
    print(f"train-unise under torchrun (NCCL, world 1, phase 7's 32 x 5 s "
          f"at full width, one data worker): {TORCHRUN_STEPS} steps in "
          f"{run_s:.1f} s of command; steps 1-2 loss "
          f"{[par[s]['loss'] for s in (1, 2)]} acc "
          f"{[par[s]['acc'] for s in (1, 2)]} = the run without torchrun's "
          f"{[single[s]['loss'] for s in (1, 2)]} / "
          f"{[single[s]['acc'] for s in (1, 2)]} within 1e-5; step wall "
          f"(median of steps 3-{TORCHRUN_STEPS}, metrics records, data wait "
          f"included) {step_ms:.1f} ms beside phase 7's {train_ms:.1f} ms "
          f"(train_step alone) | {gpu}", flush=True)
    return step_ms


def codec_mesh_phase(torch, vq, gpu, mesh, codec_ms):
    """Phase 12 (b): the codec GAN trainer without a mesh and on the (dp 1)
    mesh, from the same weights and batches -> K5's launches in the mesh
    run."""
    from unified_audio_tpu_torch.models.hcodec.codec import (HCodec,
                                                             hcodec10_config)
    from unified_audio_tpu_torch.ops import quant
    from unified_audio_tpu_torch.train.codec_trainer import (
        CodecGANTrainer, CodecTrainConfig)
    from unified_audio_tpu_torch.train.discriminators import (
        CodecDiscriminator)
    from unified_audio_tpu_torch.utils.initialization import init_random_

    cfg = hcodec10_config()
    rng = np.random.default_rng(21)
    wav = np.stack([0.5 * synth_speech(rng, CODEC_SEG)
                    for _ in range(CODEC_BATCH)]).astype(np.float32)
    wav = torch.as_tensor(wav, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(22)
    feat = torch.randn(CODEC_BATCH, CODEC_SEG * 50 // SR, cfg.feat_dim,
                       device="cuda", generator=g)
    # both runs on the deterministic kernels (index_add_'s, cuDNN's):
    # otherwise two runs of one trainer part by up to ~5e-5 (relative) by
    # step 5 (H100, torch 2.11), more than the mesh may
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    runs = []
    for m in (None, mesh):
        gen = torch.Generator(device="cuda").manual_seed(0)
        with torch.device("cuda"):
            codec, disc = HCodec(cfg, trainable=True), CodecDiscriminator()
        init_random_(codec, gen)
        init_random_(disc, gen)
        trainer = CodecGANTrainer(codec, CodecTrainConfig(
            perceptual_start_step=PAR_CODEC_ADV_FROM), disc,
            torch.Generator().manual_seed(1), mesh=m)
        searches = []
        search = quant.nearest_code

        def recording(x, codebook):
            codes = search(x, codebook)
            if m is not None:
                searches.append((x.detach().reshape(-1, x.shape[-1]).float(),
                                 codebook.clone(), codes.reshape(-1)))
            return codes

        vq.nearest_code.launches = 0
        metrics, walls = [], []
        with patched([(quant, "nearest_code", recording)]):
            for _ in range(PAR_CODEC_STEPS):
                t0 = time.perf_counter()
                metrics.append(trainer.train_step(wav, feat))
                walls.append(time.perf_counter() - t0)
        k5 = vq.nearest_code.launches
        buffers = {k: v.clone() for k, v in codec.state_dict().items()
                   if "._codebook." in k}
        runs.append((metrics, walls, k5, buffers, searches))
        del trainer, codec, disc
        torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = deterministic
    (m0, w0, _, b0, _), (m1, w1, k5, b1, searches) = runs
    worst = 0.0
    for a, b in zip(m0, m1):
        for k, v in a.items():
            err = abs(v - b[k]) / max(abs(v), 1e-6)
            worst = max(worst, err)
    buf = max(float(((v - b1[k]).abs().max() / v.abs().max().clamp(min=1))
                    .item()) for k, v in b0.items())
    want_k5 = 8 * PAR_CODEC_STEPS + 8 * (quant.KMEANS_ITERS + 1)
    equal = all(torch.equal(codes, vq.nearest_code_ref(x.contiguous(), cb))
                for x, cb, codes in searches)
    if not worst <= 1e-5 or not buf <= 1e-5 or k5 != want_k5 or \
            len(searches) != k5 or not equal:
        fail(f"codec trainer on the dp 1 mesh: metrics off by {worst:.3e} "
             f"(relative), EMA buffers by {buf:.3e}, K5 launches {k5} "
             f"(want {want_k5}), {len(searches)} searches, codes equal to "
             f"plain {equal}")
    med = lambda w: 1e3 * float(np.median(w[PAR_CODEC_ADV_FROM:]))
    print(f"CodecGANTrainer(mesh=dp 1, NCCL) at HCodec-1.0 full width, "
          f"{PAR_CODEC_STEPS} steps of {CODEC_BATCH} x 3 s (GAN terms from "
          f"step {PAR_CODEC_ADV_FROM + 1}): every metric within "
          f"{worst:.2e} (relative) and the EMA buffers within {buf:.2e} of "
          f"the run without a mesh; gen_loss by step "
          f"{[round(r['gen_loss'], 4) for r in m1]}; K5 launches {k5} = "
          f"{want_k5}, every search's codes equal to plain; step wall "
          f"(median of the GAN steps {PAR_CODEC_ADV_FROM + 1}-"
          f"{PAR_CODEC_STEPS}, deterministic kernels) {med(w1):.1f} ms with "
          f"the mesh, {med(w0):.1f} ms without; phase 8's {codec_ms:.1f} ms "
          f"(steps {TIMED_FROM}-{CODEC_STEPS}, GAN terms from step "
          f"{CODEC_ADV_FROM + 1}, HuBERT features and data included) | "
          f"{gpu}", flush=True)
    return k5


def forwards_phase(torch, gpu):
    """Phase 12 (c): the pipeline (pp 1) and sequence-parallel (sp 1)
    forwards of the full-width LM against the dense backbone."""
    from unified_audio_tpu_torch.models.lm.llama import (LlamaBackbone,
                                                         LlamaConfig)
    from unified_audio_tpu_torch.parallel.mesh import make_mesh_axes
    from unified_audio_tpu_torch.parallel.pipeline import (
        llama_pipeline_forward)
    from unified_audio_tpu_torch.parallel.sequence import (
        llama_sequence_parallel_forward)
    from unified_audio_tpu_torch.utils.initialization import init_random_

    cfg = LlamaConfig()
    gen = torch.Generator(device="cuda").manual_seed(31)
    with torch.device("cuda"):
        bb = LlamaBackbone(cfg)
    init_random_(bb, gen)
    x = torch.randn(*PAR_SEQ, cfg.hidden_size, device="cuda", generator=gen)
    with torch.no_grad():
        dense = bb.backbone(x)
        pipe = bb.norm(llama_pipeline_forward(bb, x, make_mesh_axes(pp=1),
                                              2))
        seq = bb.norm(llama_sequence_parallel_forward(
            bb, x, make_mesh_axes(sp=1)))
    errs = [float((y - dense).abs().max()) for y in (pipe, seq)]
    if not max(errs) <= 1e-5:
        fail(f"pipeline / sequence-parallel forwards vs dense: {errs}")
    print(f"llama_pipeline_forward (pp 1, 2 microbatches) and "
          f"llama_sequence_parallel_forward (sp 1) of the 512 x 12 LM on "
          f"{PAR_SEQ[0]} x {PAR_SEQ[1]} positions: max abs diff from the "
          f"dense backbone {errs[0]:.2e} and {errs[1]:.2e} | {gpu}",
          flush=True)


def parallel_phase(torch, cli, vq, gpu, tmp, write_wav, train_ms, codec_ms):
    """Phase 12 -> K5's launches on its path (the dp codec run)."""
    import socket

    from unified_audio_tpu_torch.parallel import distributed
    from unified_audio_tpu_torch.parallel.mesh import make_mesh_axes

    t0 = time.perf_counter()
    torchrun_phase(torch, cli, gpu, tmp, write_wav, train_ms)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.initialize(f"127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        dist = torch.distributed
        print(f"NCCL version {'.'.join(map(str, torch.cuda.nccl.version()))}",
              flush=True)
        print(f"world size {dist.get_world_size()} (backend "
              f"{dist.get_backend()})", flush=True)
        k5 = codec_mesh_phase(torch, vq, gpu, make_mesh_axes(dp=1), codec_ms)
        forwards_phase(torch, gpu)
    finally:
        torch.distributed.destroy_process_group()
    print(f"phase 12 took {time.perf_counter() - t0:.1f} s; K5 launches "
          f"{k5}", flush=True)
    return k5


# ---------------------------------------------------------------------------
# The last modules (phase 14)
# ---------------------------------------------------------------------------

LAST_SEED = 14
MOE_KW = dict(hidden_size=768, intermediate_size=3072, num_heads=12,
              num_layers=2, use_moe=True, moe_experts=3, moe_topk=1)
RING = dict(dim=512, num_layers=32, num_heads=8, context=16)
GRVQ = dict(input_dim=512, codebook_size=1024, codebook_dim=8,
            num_quantizers=2)
LOADER = dict(files=8, crop_s=4.0, batch=8, workers=4, batches=20)


def seeded(torch, module):
    """``module`` on the CPU with weights from ``LAST_SEED`` (eval), and its
    copy on the card."""
    import copy

    from unified_audio_tpu_torch.utils.initialization import init_random_

    init_random_(module, torch.Generator().manual_seed(LAST_SEED))
    module.eval()
    return module, copy.deepcopy(module).to("cuda")


def card_against_cpu(torch, what, cpu_m, card_m, x, rel, gpu, fn=None,
                     phase=14):
    """``fn(module, x)`` (default ``module(x)``) on the CPU and on the card
    on the same fp32 input: fails unless max |card - cpu| <= rel * max(1,
    max |cpu|); prints the error and the card's median wall of 5 calls,
    as a line of ``phase`` -> (cpu output, card output, card ms)."""
    fn = fn or (lambda m, t: m(t))
    xt = torch.as_tensor(x)
    with torch.no_grad():
        want = fn(cpu_m, xt)
        xc = xt.to("cuda")
        got = fn(card_m, xc)
        wall, _, _ = median_wall(torch, lambda: fn(card_m, xc), 5)
    err = float((got.cpu() - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    if not (np.isfinite(err) and err <= rel * scale):
        fail(f"{what}: card against the CPU max abs err {err:.3e} > "
             f"{rel} x {scale:.3g}")
    print(f"phase {phase} {what}: output {tuple(got.shape)}, card against "
          f"the CPU max abs err {err:.3e} (bound {rel} x max(1, max |cpu|) = "
          f"{rel * scale:.3e}); card {wall * 1e3:.2f} ms a call (median of "
          f"5) | {gpu}", flush=True)
    return want, got, wall * 1e3


def moe_check(torch, gpu):
    """(a) HCodec-1.0's PriorNet transformer (768 wide, 12 heads, 2
    layers) with routed experts (3, top-1) on a 10-s clip's 500 decoder
    frames."""
    from unified_audio_tpu_torch.nn.transformer import Transformer

    cpu_m, card_m = seeded(torch, Transformer(**MOE_KW))
    x = np.random.default_rng(1).standard_normal((1, 500, 768)).astype(
        np.float32)
    card_against_cpu(torch, "(a) MoE transformer 768 x 2, 3 experts top-1",
                     cpu_m, card_m, x, 1e-4, gpu)


def stream_all(torch, m, x, chunk):
    """x (1, T, D) on the card through ``m.step`` in chunks of ``chunk``
    with the tightest ring (context + chunk - 1) -> (output, ms a chunk)."""
    state = m.init_state(1, m.context + chunk - 1)
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(0, x.shape[1], chunk):
            y, state = m.step(x[:, i:i + chunk], state)
            outs.append(y)
    torch.cuda.synchronize()
    n = len(outs)
    return torch.cat(outs, dim=1), (time.perf_counter() - t0) * 1e3 / n


def ring_check(torch, gpu):
    """(b) The ring-KV streaming transformer at Mimi's width (512, 8 heads,
    context 16, 32 layers) on a 10-s clip's 250 frames: offline on the
    card against the CPU; streamed in chunks of 1 and 4 against its own
    offline forward within 1e-4."""
    from unified_audio_tpu_torch.nn.streaming import StreamingTransformer

    cpu_m, card_m = seeded(torch, StreamingTransformer(**RING))
    x = np.random.default_rng(2).standard_normal((1, 250, 512)).astype(
        np.float32)
    _, offline, _ = card_against_cpu(
        torch, "(b) ring-KV streaming transformer 512 x 32, offline", cpu_m,
        card_m, x, 1e-4, gpu)
    xc = torch.as_tensor(x, device="cuda")
    for chunk in (1, 4):
        stream_all(torch, card_m, xc, chunk)  # warm-up
        streamed, ms = stream_all(torch, card_m, xc, chunk)
        err = float((streamed - offline).abs().max())
        if not err <= 1e-4:
            fail(f"ring-KV stream in chunks of {chunk}: max abs err "
                 f"{err:.3e} against the offline forward")
        print(f"phase 14 (b) streamed in chunks of {chunk} (ring of "
              f"{RING['context'] + chunk - 1}): max abs err {err:.3e} "
              f"against the offline forward; {ms:.3f} ms a chunk "
              f"({ms / chunk:.3f} ms a frame) | {gpu}", flush=True)


def conformer_check(torch, gpu):
    """(c) The conformer at UniSE's width (6 x 512, 8 heads of 64) on a
    10-s clip's 500 frames."""
    from unified_audio_tpu_torch.models.lm.conformer import ConformerEncoder

    cpu_m, card_m = seeded(torch, ConformerEncoder())
    x = np.random.default_rng(3).standard_normal((1, 500, 512)).astype(
        np.float32)
    card_against_cpu(torch, "(c) conformer 6 x 512", cpu_m, card_m, x, 1e-4,
                     gpu)


def grvq_layer_ties(torch, layer, r, got):
    """The rows where the card's fused index ``got`` differs from the CPU's
    on residual ``r`` -> the largest fp64 cosine gap between the two
    choices over those rows and both groups (0 when none differ)."""
    with torch.no_grad():
        want = layer(r)["indices"]
    worst = 0.0
    n = layer.codebook_size
    for name, proj, cb, of in (("a", layer.in_proj_a, layer.codebook_a,
                                lambda i: i // n),
                               ("b", layer.in_proj_b, layer.codebook_b,
                                lambda i: i % n)):
        with torch.no_grad():
            z = proj(r).double()
        z = z / z.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        c = cb.detach().double()
        c = c / c.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        cos = z @ c.T  # (B, T, N)
        a, b = of(got.long()), of(want.long())
        diff = a != b
        if diff.any():
            ga = cos.gather(-1, a[..., None])[..., 0]
            gb = cos.gather(-1, b[..., None])[..., 0]
            worst = max(worst, float((gb - ga).abs()[diff].max()))
    return int((got != want).sum()), worst


def grvq_check(torch, gpu):
    """(d) GRVQ at HCodec-2.0's latent width (512; 2 quantizers of two
    1024-code groups of 8) on a 10-s clip's 125 frames: the whole stack on
    the card against the CPU, and each quantizer judged on the residual
    the CPU's codes leave: every index equal, or a near tie (the two
    choices' fp64 cosines within 1e-5)."""
    from unified_audio_tpu_torch.ops.grvq import (
        AutoGroupResidualVectorQuantize)

    cpu_m, card_m = seeded(torch, AutoGroupResidualVectorQuantize(**GRVQ))
    z = np.random.default_rng(4).standard_normal((1, 125, 512)).astype(
        np.float32)
    zt = torch.as_tensor(z)
    with torch.no_grad():
        want = cpu_m(zt)
        got = card_m(zt.to("cuda"))
        wall, _, _ = median_wall(torch, lambda: card_m(zt.to("cuda")), 5)
    equal = float((got["indices"].cpu() == want["indices"]).float().mean())
    r, differ, worst = zt, 0, 0.0
    for q_cpu, q_card in zip(cpu_m.quantizers, card_m.quantizers):
        with torch.no_grad():
            idx = q_card(r.to("cuda"))["indices"].cpu()
            n, gap = grvq_layer_ties(torch, q_cpu, r, idx)
            r = r - q_cpu(r)["z_q"]
        differ, worst = differ + n, max(worst, gap)
    if not worst <= 1e-5:
        fail(f"GRVQ: {differ} indices differ from the CPU's, cosine gap "
             f"{worst:.3e} > 1e-5")
    same = got["indices"].cpu() == want["indices"]
    zq_err = float((got["z_q"].cpu() - want["z_q"]).abs().max()) \
        if bool(same.all()) else float("nan")
    if bool(same.all()) and not zq_err <= 1e-4:
        fail(f"GRVQ z_q: card against the CPU max abs err {zq_err:.3e}")
    print(f"phase 14 (d) GRVQ 512 wide, 2 x (1024 x 1024) codes on 125 "
          f"frames: indices {tuple(got['indices'].shape)} equal to the CPU's "
          f"in {equal:.4f} of places, {differ} layer-judged differences "
          f"(worst cosine gap {worst:.2e}); z_q max abs err {zq_err:.3e}; "
          f"card {wall * 1e3:.2f} ms a call | {gpu}", flush=True)


def seanet_decoder_check(torch, gpu):
    """(e) The SEANet decoder, the inverse of HCodec-1.0's encoder (512 ->
    32 filters, ratios (8, 5, 4, 2), a 2-layer skip-LSTM): 500 latent
    frames to 10 s of 16 kHz audio."""
    from unified_audio_tpu_torch.nn.blocks import SEANetDecoder

    cpu_m, card_m = seeded(torch, SEANetDecoder(dimension=512, n_filters=32,
                                                ratios=(8, 5, 4, 2), lstm=2))
    z = np.random.default_rng(5).standard_normal((1, 500, 512)).astype(
        np.float32)
    _, got, _ = card_against_cpu(torch, "(e) SEANet decoder 512 -> 1, hop "
                                 "320", cpu_m, card_m, z, 1e-4, gpu)
    if tuple(got.shape) != (1, int(CLIP_S * SR), 1):
        fail(f"SEANet decoder output {tuple(got.shape)}")


def loader_check(torch, tmp, write_wav, read_wav, gpu):
    """(f) The native loader built with this machine's g++: 8 synthetic
    10-s wavs read bit-equal to the Python reader, then 20 pinned batches
    of 8 x 4-s crops (4 C++ workers) copied to the card without blocking,
    each equal there to the host batch."""
    from unified_audio_tpu_torch.data import native_loader as nl

    t0 = time.perf_counter()
    nl.get_library()
    built = time.perf_counter() - t0
    rng = np.random.default_rng(6)
    paths = []
    for i in range(LOADER["files"]):
        p = tmp / f"loader_{i}.wav"
        write_wav(p, 0.5 * synth_speech(rng, int(CLIP_S * SR)), SR)
        paths.append(p)
        native, sr = nl.read_wav_native(p)
        plain, sr2 = read_wav(p)  # (channels, T)
        if sr != sr2 or not np.array_equal(native, plain[0]):
            fail(f"native read of {p.name} differs from the Python reader")
    crop = int(LOADER["crop_s"] * SR)
    n = LOADER["batches"]
    with nl.NativeAudioLoader(paths, crop, LOADER["batch"],
                              workers=LOADER["workers"], seed=LAST_SEED,
                              pin_memory=True) as loader:
        first = loader.next()  # the workers' start
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            host = loader.next()
            if not host.is_pinned():
                fail("the native loader's batch is not in pinned memory")
            card = host.to("cuda", non_blocking=True)
            if not (torch.equal(card.cpu(), host)
                    and bool(torch.isfinite(card).all())):
                fail("a pinned batch differs on the card")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    mb = n * first.numel() * 4 / 1e6
    print(f"phase 14 (f) native loader: g++ build and load {built:.2f} s; "
          f"8 wavs read bit-equal to the Python reader; {n} pinned batches "
          f"{tuple(first.shape)} to the card in {wall:.3f} s "
          f"({n / wall:.1f} batches/s, {mb / wall:.1f} MB/s, each checked "
          f"on the card) | {gpu}", flush=True)


def traced_decode_check(torch, cli, pa, unise, tmp, gpu):
    """(g) ``utils/profiling.py`` around UniSE decode steps on an int8 pool
    at serving width (16 slots, LM 512 x 12): ``StepTimer(device="cuda")``
    over 6 steps (the first left out) against each step's CUDA-event time,
    then ``trace`` of one step in a ``span`` (the recorder is on while the
    profiler runs); the Chrome trace must name K2's kernel, the span and the engine's own
    ``engine.step`` span, and the recorder must hold both -> K2 launches."""
    from unified_audio_tpu_torch.utils import profiling

    k2 = pa.paged_flash_decode_owner_q8
    eng = cli.make_engine(unise, 16, "int8")
    reqs = api_requests(torch, unise, np.random.default_rng(7))[:16]
    gen = torch.Generator(device="cuda").manual_seed(0)
    k2.launches = 0
    eng.admit_many(reqs)
    eng.step(1, gen)  # warm-up
    timer = profiling.StepTimer(device="cuda")
    events = []
    for _ in range(6):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with timer:
            start.record()
            eng.step(1, gen)
            end.record()
        events.append(start.elapsed_time(end) / 1e3)
    summary = timer.summary()
    ev = sorted(events[1:])
    if not all(w >= e for w, e in zip(timer.times, events)) \
            or not summary["p50_s"] >= ev[len(ev) // 2]:
        fail(f"StepTimer below the CUDA-event time: {timer.times} against "
             f"{events}")
    profiling.reset()  # on while the profiler runs
    with profiling.trace(tmp / "trace") as prof:
        with profiling.span("unise_decode_step"):
            eng.step(1, gen)
    torch.cuda.synchronize()
    names = {str(e.get("name")) for e in json.loads(
        Path(prof.trace_path).read_text())["traceEvents"]}
    kernel = CUDA_KERNELS[k2.__name__]
    spans = [profiling.PREFIX + n for n in ("unise_decode_step",
                                            "engine.step")]
    recorded = [(s["name"], s["attrs"]) for s in profiling.export()["spans"]
                if s["parent"] is None or s["name"] == "engine.step"]
    if not any(kernel in n for n in names) or not set(spans) <= names \
            or recorded != [("unise_decode_step", {}),
                            ("engine.step", {"n": 1})]:
        fail(f"the trace of a decode step names no {kernel} or no span, or "
             f"the recorder lacks them: {sorted(names)[:40]}, {recorded}")
    steps = 1 + 6 + 1
    if k2.launches != L * steps:
        fail(f"K2 launched {k2.launches} times in {steps} decode steps")
    print(f"phase 14 (g) int8 UniSE decode step, 16 slots: StepTimer p50 "
          f"{summary['p50_s'] * 1e3:.3f} ms, p90 {summary['p90_s'] * 1e3:.3f}"
          f" ms, against the CUDA-event median {ev[len(ev) // 2] * 1e3:.3f} "
          f"ms; the trace ({Path(prof.trace_path).stat().st_size} bytes) "
          f"names {kernel} and the step's spans; K2 launches "
          f"{k2.launches} | {gpu}", flush=True)
    return k2.launches


def last_modules_phase(torch, cli, pa, unise, gpu, tmp, write_wav,
                       read_wav):
    """Phase 14: the modules of the last slice at full width on the card,
    fp32 with TF32 off, each held against the same seeded module on the
    CPU -> K2 launches (the traced decode steps)."""
    t0 = time.perf_counter()
    cli._fp32_without_tf32()
    moe_check(torch, gpu)
    ring_check(torch, gpu)
    conformer_check(torch, gpu)
    grvq_check(torch, gpu)
    seanet_decoder_check(torch, gpu)
    loader_check(torch, tmp, write_wav, read_wav, gpu)
    k2 = traced_decode_check(torch, cli, pa, unise, tmp, gpu)
    print(f"phase 14 took {time.perf_counter() - t0:.1f} s | {gpu}",
          flush=True)
    return k2



# ---------------------------------------------------------------------------
# The last public callables (phase 15)
# ---------------------------------------------------------------------------

DENSE_SLOTS, DENSE_STEPS, DENSE_LEN = 16, 32, 1024
DENSE_DEPTHS = [40 + 37 * i for i in range(DENSE_SLOTS)]  # 40 .. 595
DENSE_BS, DENSE_REGION = 64, 14  # the serving pool's blocks and regions
DENSE_ATOL = 2e-4  # the JAX package's own paged-against-dense bound
TRACED_STEPS = 4  # steps of each path traced after the greedy run
MDCT_FRAME = 512


def greedy_steps(torch, step, ids):
    """``DENSE_STEPS`` greedy steps of ``step(ids) -> logits`` -> (logits
    (steps, S, V) and ids (steps, S) on the card, median ms a step by CUDA
    events)."""
    logits, out, times = [], [], []
    with torch.no_grad():
        for _ in range(DENSE_STEPS):
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            lg = step(ids)
            t1.record()
            ids = torch.argmax(lg, -1).int()
            logits.append(lg)
            out.append(ids)
            times.append((t0, t1))
    torch.cuda.synchronize()
    ms = float(np.median([a.elapsed_time(b) for a, b in times]))
    return torch.stack(logits), torch.stack(out), ms


def dense_against_k1(torch, pa, paged, unise, gpu):
    """(a) UniSE's LM (``LlamaConfig()``: 512 x 12, 8 heads), fp32: 16
    slots prefilled to staggered depths (40 + 37 i) into a dense cache of
    1,024 positions, and the same prompts prefilled into an owner pool
    (14-block regions of 64-token blocks); then 32 greedy steps through
    ``decode_ids_multi`` and through ``paged_decode_ids(use_kernel=
    "owner")`` (K1): logits within 2e-4, greedy ids equal; then 4 more
    steps of each path under the profiler (device time and records a
    step) -> K1's launches in the greedy run."""
    import copy

    from unified_audio_tpu_torch.models.lm.llama import init_cache

    lm = copy.deepcopy(unise.sft).float().eval()
    cfg, dev = lm.cfg, "cuda"
    rng = np.random.default_rng(15)
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, d)),
                               device=dev) for d in DENSE_DEPTHS]
    ids0 = torch.as_tensor(rng.integers(0, cfg.vocab_size, DENSE_SLOTS),
                           dtype=torch.int32, device=dev)
    alloc = paged.RegionAllocator((DENSE_SLOTS + 2) * DENSE_REGION,
                                  DENSE_REGION)
    tables = torch.tensor([alloc.alloc(DENSE_REGION)
                           for _ in range(DENSE_SLOTS)], dtype=torch.int32,
                          device=dev)
    pool = paged.init_pool(cfg, alloc.num_blocks, DENSE_BS,
                           dtype=torch.float32, device=dev)
    dense = init_cache(cfg, DENSE_SLOTS, DENSE_LEN, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for b, ids in enumerate(prompts):
            embeds = lm.embed_codes(ids)
            row = {"k": dense["k"][:, b:b + 1], "v": dense["v"][:, b:b + 1],
                   "index": 0}  # views: the prefill writes the slot's row
            lm.cached_forward(embeds, row)
            own = init_cache(cfg, 1, ids.shape[1], device=dev)
            lm.cached_forward(embeds, own)
            paged.scatter_prefill(pool, tables[b:b + 1], own["k"], own["v"],
                                  DENSE_BS)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    dense["index"] = torch.tensor(DENSE_DEPTHS, dtype=torch.int32,
                                  device=dev)

    def dense_step(ids):
        return lm.decode_ids_multi(ids, dense)[0]

    index = dense["index"].clone()
    active = torch.ones(DENSE_SLOTS, dtype=torch.bool, device=dev)

    def paged_step(ids):
        nonlocal index
        lg = paged.paged_decode_ids(cfg, lm, pool, tables, index, active, ids,
                                    DENSE_BS, use_kernel="owner")
        index = index + 1
        return lg

    want, want_ids, dense_ms = greedy_steps(torch, dense_step, ids0)
    k1 = pa.paged_flash_decode_owner
    k1.launches = 0
    got, got_ids, paged_ms = greedy_steps(torch, paged_step, ids0)
    n = k1.launches
    err = float((got - want).abs().max())
    if not err <= DENSE_ATOL:
        fail(f"phase 15 (a): K1's paged decode against the dense per-slot "
             f"decode max abs logit diff {err:.3e} > {DENSE_ATOL}")
    if not bool((got_ids == want_ids).all()):
        fail("phase 15 (a): K1's greedy ids differ from the dense decode's")
    if n != cfg.num_layers * DENSE_STEPS:
        fail(f"phase 15 (a): K1 launched {n} times in {DENSE_STEPS} steps "
             f"of {cfg.num_layers} layers")
    ends = dense["index"].cpu().tolist()
    if ends != [d + DENSE_STEPS for d in DENSE_DEPTHS]:
        fail(f"phase 15 (a): the dense indices ended at {ends}")
    traced = {}  # 4 more steps of each path under the profiler
    for name, step in (("dense", dense_step), ("paged", paged_step)):
        with torch.no_grad():
            counts, us = profiled(torch, lambda: step(got_ids[-1]),
                                  TRACED_STEPS)
        traced[name] = (us / 1e3 / TRACED_STEPS,
                        sum(counts.values()) / TRACED_STEPS)
    print(f"phase 15 (a) dense decode_ids_multi against the K1 paged decode "
          f"(paged_decode_ids, owner mode), LM {cfg.hidden_size} x "
          f"{cfg.num_layers}, fp32, {DENSE_SLOTS} slots at depths "
          f"{DENSE_DEPTHS[0]}..{DENSE_DEPTHS[-1]} (dense cache "
          f"{DENSE_LEN} positions, {2 * dense['k'].numel() * 4 / 1e6:.0f} "
          f"MB), {DENSE_STEPS} greedy steps: max abs logit diff {err:.3e} "
          f"(bound {DENSE_ATOL}), greedy ids equal; dense "
          f"{dense_ms:.3f} ms a step, paged {paged_ms:.3f} ms a step "
          f"(median, CUDA events); device time a step under the profiler "
          f"(CUPTI records, {TRACED_STEPS} more steps): dense "
          f"{traced['dense'][0]:.3f} ms in {traced['dense'][1]:.0f} "
          f"records, paged {traced['paged'][0]:.3f} ms in "
          f"{traced['paged'][1]:.0f}; the two prefills {prefill_s:.2f} s; K1 "
          f"launches {n} | {gpu}", flush=True)
    return n


def signal_ops_check(torch, unise, gpu):
    """(b) ``UniSE.stft_logmel`` of a 10-s 16-kHz clip (n_fft 640, hop
    320, 80 mels) and ``mdct``/``imdct`` at a frame of 512 ("same" and
    "center"), on the card against the CPU (1e-4 x max(1, max |cpu|));
    the round trip's error away from the ends."""
    from unified_audio_tpu_torch.ops import dsp

    rng = np.random.default_rng(16)
    n = int(CLIP_S * SR)
    clip = (0.5 * synth_speech(rng, n) + 0.1 * rng.standard_normal(n)
            ).astype(np.float32)[None]
    mel, _, _ = card_against_cpu(
        torch, "(b) UniSE.stft_logmel, 10 s, n_fft 640, hop 320, 80 mels",
        unise, unise, clip, 1e-4, gpu, fn=lambda m, x: m.stft_logmel(x),
        phase=15)
    if tuple(mel.shape) != (1, n // unise.config.hop_length,
                            unise.config.n_mels):
        fail(f"phase 15 (b): log-mel {tuple(mel.shape)}")
    for padding in ("same", "center"):
        coeffs, got, _ = card_against_cpu(
            torch, f"(b) mdct, frame {MDCT_FRAME}, {padding!r}", None, None,
            clip, 1e-4, gpu, fn=lambda m, x: dsp.mdct(x, MDCT_FRAME, padding),
            phase=15)
        _, y, _ = card_against_cpu(
            torch, f"(b) imdct, frame {MDCT_FRAME}, {padding!r}", None, None,
            coeffs.numpy(), 1e-4, gpu,
            fn=lambda m, c: dsp.imdct(c, padding), phase=15)
        inner = slice(MDCT_FRAME, n - MDCT_FRAME)
        rt = float((y.cpu()[0, inner] - torch.as_tensor(clip[0, inner])
                    ).abs().max())
        if not rt <= 1e-3:
            fail(f"phase 15 (b): the {padding!r} MDCT round trip's error "
                 f"{rt:.3e}")
        print(f"phase 15 (b) MDCT round trip on the card, {padding!r}: max "
              f"abs reconstruction error {rt:.3e} away from the ends | {gpu}",
              flush=True)


def pools_and_latents_check(torch, gpu):
    """(c) The TAP, TSDP and TSTP pooling heads on 500 frames of BiCodec's
    1536-channel speaker features, and ``FactorizedVectorQuantize.
    decode_latents`` at BiCodec's widths (8192 codes of 8) on 500 frames,
    card against the CPU: the pools within 1e-4 x max(1, max |cpu|), every
    index equal or a near tie (fp64 cosines within 1e-5), the rows equal
    where the indices are; ``tokenize`` (1024 -> 8, then the search) equal
    on the card to ``decode_latents`` of its projection."""
    from unified_audio_tpu_torch.models.bicodec import speaker
    from unified_audio_tpu_torch.ops.quant import FactorizedVectorQuantize

    rng = np.random.default_rng(17)
    feats = rng.standard_normal((1, 500, 1536)).astype(np.float32)
    for name in ("tap_pool", "tsdp_pool", "tstp_pool"):
        pool = getattr(speaker, name)
        card_against_cpu(torch, f"(c) {name}, 500 x 1536", None, None, feats,
                         1e-4, gpu, fn=lambda m, x: pool(x), phase=15)
    cpu_m, card_m = seeded(torch, FactorizedVectorQuantize(
        1024, 8192, 8, tokenize=True))
    z = torch.as_tensor(rng.standard_normal((1, 500, 8)).astype(np.float32))
    with torch.no_grad():
        want_q, want_i = cpu_m.decode_latents(z)
        got_q, got_i = card_m.decode_latents(z.to("cuda"))
        wall, _, _ = median_wall(torch,
                                 lambda: card_m.decode_latents(z.to("cuda")),
                                 5)
        x = torch.as_tensor(rng.standard_normal((1, 500, 1024)).astype(
            np.float32), device="cuda")
        tok = card_m.tokenize(x)
        via = card_m.decode_latents(card_m.in_project(x))[1]
    got_i, got_q = got_i.cpu(), got_q.cpu()
    if not bool((tok == via).all()):
        fail("phase 15 (c): tokenize differs from decode_latents of its "
             "projection")
    differ = got_i != want_i
    cb = cpu_m.codebook.weight.double()
    cb = cb / cb.norm(dim=-1, keepdim=True)
    zn = z.double() / z.double().norm(dim=-1, keepdim=True)
    cos = torch.einsum("btd,nd->btn", zn, cb)
    gap = (cos.gather(-1, want_i.long()[..., None])
           - cos.gather(-1, got_i.long()[..., None]))[differ]
    worst = float(gap.abs().max()) if bool(differ.any()) else 0.0
    if not worst <= 1e-5:
        fail(f"phase 15 (c): decode_latents indices differ from the CPU's "
             f"by a cosine gap of {worst:.3e}")
    same = ~differ
    row_err = float((got_q - want_q)[same].abs().max())
    if not row_err == 0.0:
        fail(f"phase 15 (c): decode_latents rows differ where the indices "
             f"agree ({row_err:.3e})")
    print(f"phase 15 (c) FactorizedVectorQuantize.decode_latents, 8192 x 8 "
          f"codes, 500 frames: {int(differ.sum())} indices differ from the "
          f"CPU's (worst fp64 cosine gap {worst:.2e}), rows equal where the "
          f"indices are; tokenize equal to decode_latents of its "
          f"projection; card {wall * 1e3:.2f} ms a call | {gpu}", flush=True)


def last_callables_phase(torch, cli, pa, paged, unise, gpu):
    """Phase 15: the last public callables at full width on the card, fp32
    with TF32 off -> K1's launches in (a)."""
    t0 = time.perf_counter()
    cli._fp32_without_tf32()
    k1 = dense_against_k1(torch, pa, paged, unise, gpu)
    signal_ops_check(torch, unise, gpu)
    pools_and_latents_check(torch, gpu)
    print(f"phase 15 took {time.perf_counter() - t0:.1f} s | {gpu}",
          flush=True)
    return k1


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA card")
    if not (REPO / "unified_audio_tpu_torch").is_dir():
        fail(f"run from a checkout: no unified_audio_tpu_torch beside {__file__}")
    sys.path.insert(0, str(REPO))
    from unified_audio_tpu_torch import cli
    from unified_audio_tpu_torch.data.audio_io import read_wav, write_wav
    from unified_audio_tpu_torch.models.unise.model import UniSE
    from unified_audio_tpu_torch.ops.cuda import latent_attention as la
    from unified_audio_tpu_torch.ops.cuda import paged_attention as pa
    from unified_audio_tpu_torch.ops.cuda import vq
    from unified_audio_tpu_torch.ops import dsp
    from unified_audio_tpu_torch.ops.cuda.build import load_library
    from unified_audio_tpu_torch.serve import paged
    from unified_audio_tpu_torch.serve.engine import ContinuousBatchingEngine

    # 1. device
    gpu = gpu_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(gpu)
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{count} card(s)", flush=True)

    # 2. kernels: one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        list(pool.map(load_library, ("paged_attention.cu", "vq.cu",
                                     "latent_attention.cu")))
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    results = {}
    for name, kernel, ref, quant, check in (
            ("K1", pa.paged_flash_decode_owner,
             pa.paged_flash_decode_owner_ref, False, check_kernel),
            ("K2", pa.paged_flash_decode_owner_q8,
             pa.paged_flash_decode_owner_q8_ref, True, check_kernel),
            ("K3", pa.paged_flash_decode_stream_flat,
             pa.paged_flash_decode_stream_flat_ref, False, check_stream),
            ("K4", pa.paged_flash_decode_stream_flat_q8,
             pa.paged_flash_decode_stream_flat_q8_ref, True, check_stream),
            ("K7", pa.paged_flash_decode, pa.paged_flash_decode_ref, False,
             check_table)):
        for dtype in (torch.float32, torch.bfloat16):
            r = check(torch, pa, kernel, ref, dtype, quant)
            results[name, dtype] = r
            report(name, kernel, dtype, r, gpu)
    vq_results = {}
    for m in (240, 250, 2000):
        line, plan = vq_plan_line(torch, vq, m)
        print(line, flush=True)
        for name, (share, worst, ms, plain_ms, n_rec) in check_vq(
                torch, vq, m).items():
            vq_results[name, m] = (worst, ms, plain_ms, n_rec)
            nq = 1 if name == "K5" else VQ_SHAPES["nq"]
            b_ms, _ = vq_bound(m, VQ_SHAPES["n"], VQ_SHAPES["d"], nq)
            print(f"{name} at M={m}, N=1024, D=512"
                  f"{'' if name == 'K5' else ', nq=4'}: {share:.5f} of codes "
                  f"equal to plain, worst distance excess {worst:.3e}; kernel"
                  f" {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
                  f"{b_ms * 1e3:.2f} us (3xTF32 at 495 TFLOP/s); L2 bytes "
                  f"{plan['l2_bytes'][nq]} | {gpu}", flush=True)
    k8_tally = {}
    with uncounted(k8_tally, la.latent_attention):
        latent = latent_phase(torch, la, gpu)
    torch.cuda.empty_cache()
    k8_launches = moonlight_phase(torch, la, gpu)

    # 3. UniSE serving. From here on K7's count holds the serving paths'
    # launches; the smoke's own K7 checks go to ``tally``.
    tally = {pa.paged_flash_decode.__name__: pa.paged_flash_decode.launches}
    pa.paged_flash_decode.launches = 0
    records = []
    decode = UniSE._decode_tokens

    def recording(self, g, s, orig_len):
        wav = decode(self, g, s, orig_len)
        records.append((np.asarray(g), np.asarray(s), wav, orig_len))
        recording.unise = self
        return wav

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain attention path ran during serving")

    admitted = {}  # uid -> the request as the engine admitted it
    admit = ContinuousBatchingEngine.admit_many

    def recording_admit(self, reqs, *args, **kwargs):
        admitted.update((r.uid, r) for r in reqs)
        return admit(self, reqs, *args, **kwargs)

    guards = [(UniSE, "_decode_tokens", recording),
              (ContinuousBatchingEngine, "admit_many", recording_admit),
              (paged, "_plain_attention", forbidden),
              (pa, "paged_flash_decode_owner_ref", forbidden),
              (pa, "paged_flash_decode_owner_q8_ref", forbidden)]
    rng = np.random.default_rng(0)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp, patched(guards):
        tmp = Path(tmp)
        spec1 = ([("se", 7.5, i % 2 == 1) for i in range(8)]
                 + [("tse", 7.5, False), ("tse", 7.5, True),
                    ("rtse", 7.5, False), ("rtse", 7.5, True),
                    ("ss", 10.0, False), ("ss", 7.5, True),
                    ("se", 5.0, False, 44100)])
        spec2 = [("se", 5.0, False), ("se", 5.0, True), ("tse", 5.0, False),
                 ("rtse", 5.0, True)]
        for name, spec, quant, kernel in (
                ("int8", spec1, "int8", pa.paged_flash_decode_owner_q8),
                ("bf16", spec2, "", pa.paged_flash_decode_owner)):
            path, lines = write_requests(tmp, rng, write_wav, spec, name)
            pa.paged_flash_decode_owner.launches = 0
            pa.paged_flash_decode_owner_q8.launches = 0
            admitted.clear()
            summary, outputs = serve_and_check(torch, cli, path, lines, quant,
                                               records, read_wav)
            n = kernel.launches
            launches[kernel.__name__] = n
            st = summary["engine_stats"]
            if n < L * st["decode_steps"]:
                fail(f"{kernel.__name__} launched {n} times for "
                     f"{st['decode_steps']} decode steps of {L} layers")
            print(f"serve {name} pool: {summary['requests']} requests, "
                  f"{summary['segments']} segments, {st['tokens_generated']} "
                  f"tokens, {st['decode_steps']} decode steps, "
                  f"{st['prefill_waves']} prefill waves; engine "
                  f"{summary['engine_s']:.2f} s = "
                  f"{st['tokens_generated'] / summary['engine_s']:.0f} "
                  f"tokens/s; wall {summary['wall_s']:.2f} s; "
                  f"{kernel.__name__} launches {n} | {gpu}", flush=True)
            check_cascades(torch, cli, lines, outputs, records, admitted,
                           read_wav, gpu)
    unise = recording.unise
    for quant in (None, "int8"):
        worst, engines = decode_agreement(torch, unise, quant)
        print(f"teacher-forced fp32 decode, {quant or 'fp32'} pool: owner "
              f"kernels vs plain attention max |logit diff| {worst:.2e}",
              flush=True)
        # sound kernels read 9.5e-7 (fp32 pool) and 7.5e-6 (int8 pool) on
        # an H100; a dropped or doubled key moves logits by far more
        if not worst <= 1e-4:
            fail(f"owner-kernel decode disagrees with the plain path: {worst}")
        if quant is None:  # K7 has no int8 variant (nor has the TPU kernel)
            with uncounted(tally, pa.paged_flash_decode,
                           pa.paged_flash_decode_owner,
                           pa.paged_flash_decode_stream_flat):
                errs = [table_on_live_pool(torch, pa, paged, engines[mode],
                                           against)
                        for mode, against in (("owner", "K1"), ("", "K3"))]
            print(f"K7 on the live fp32 pools of those steps, every layer: "
                  f"vs K1 (owner engine's regions) max abs err "
                  f"{errs[0]:.3e}, vs K3 (plain engine's allocator tables) "
                  f"{errs[1]:.3e}", flush=True)

    # 4. HCodec-1.0 round trip
    with tempfile.TemporaryDirectory() as tmp:
        k5_launches, k6_launches, _, tok = roundtrip_phase(
            torch, cli, vq, gpu, Path(tmp), write_wav, read_wav)

    # 5. HCodec-2.0 round trip
    with tempfile.TemporaryDirectory() as tmp:
        k6_20_launches, k6_20 = hcodec20_phase(torch, cli, vq, dsp, gpu,
                                               Path(tmp), write_wav, read_wav)
    torch.cuda.empty_cache()

    # 6. UniTok-audio in the stream mode
    k3_launches, k4_launches, unitok_lm, unitok_reqs = unitok_phase(
        torch, cli, pa, paged, tok, unise, gpu, tally)

    # 7. UniSE SFT training
    with tempfile.TemporaryDirectory() as tmp:
        train_ms = train_phase(torch, cli, pa, gpu, Path(tmp), write_wav,
                               read_wav)

    # 8. HCodec-1.0 GAN training
    with tempfile.TemporaryDirectory() as tmp:
        k5_train_launches, k6_train_launches, k5_train, codec_ms = \
            codec_train_phase(torch, cli, vq, gpu, Path(tmp), write_wav,
                              read_wav)

    # 9. the JAX CLI's remaining commands: enhance, codec --dtype bfloat16,
    # eval
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        enhance_phase(torch, cli, gpu, Path(tmp), write_wav, read_wav)
        k6_cli_launches = codec_bf16_phase(torch, cli, vq, gpu, Path(tmp),
                                           write_wav, read_wav)
        k6_cli_launches += eval_phase(torch, cli, vq, gpu, Path(tmp),
                                      write_wav)
        print(f"phase 9 took {time.perf_counter() - t0:.1f} s", flush=True)

    # 10. HCodec-1.5 adaptive and FlexiCodec through cli codec
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        k6_15_launches, k6_15 = hcodec15_phase(torch, cli, vq, gpu, Path(tmp),
                                               write_wav, read_wav)
        flexicodec_phase(torch, cli, gpu, Path(tmp), write_wav, read_wav)
        print(f"phase 10 took {time.perf_counter() - t0:.1f} s", flush=True)

    # 11. the causal codecs and the remaining training objectives
    with tempfile.TemporaryDirectory() as tmp:
        k5_11_launches, k6_11_launches = training_objectives_phase(
            torch, cli, vq, tok, gpu, Path(tmp), write_wav)

    # 12. parallel training through torch.distributed at world size 1
    with tempfile.TemporaryDirectory() as tmp:
        k5_12_launches = parallel_phase(torch, cli, vq, gpu, Path(tmp),
                                        write_wav, train_ms, codec_ms)

    # 13. the serving engines' API: displacing run, cancel, the int8
    # feature wire, prestage, UniTok in the owner mode
    torch.cuda.empty_cache()
    for name, n in engine_api_phase(torch, cli, pa, paged, unise, unitok_lm,
                                    unitok_reqs, gpu).items():
        launches[name] += n

    # 14. the last modules: MoE, the ring-KV stream, the conformer, GRVQ,
    # the SEANet decoder, the native loader, profiling around a decode step
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        launches[pa.paged_flash_decode_owner_q8.__name__] += \
            last_modules_phase(torch, cli, pa, unise, gpu, Path(tmp),
                               write_wav, read_wav)

    # 15. the last public callables: the dense per-slot decode against K1,
    # the log-mel and the MDCT, the pooling heads and decode_latents
    torch.cuda.empty_cache()
    launches[pa.paged_flash_decode_owner.__name__] += last_callables_phase(
        torch, cli, pa, paged, unise, gpu)

    # 16. nothing of JAX or the JAX package was loaded
    jax_side = {m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "unified_audio_tpu")}
    if jax_side:
        fail(f"the port loaded JAX-side modules: {sorted(jax_side)}")

    # the kernels at the main path's shapes: K1-K4 and K7 bf16 at the
    # serving shapes, K5/K6 at one 10-s clip of HCodec-1.0 (M = 250; K6's
    # ``nq16`` entry at HCodec-2.0's 16 layers, M = 125 and 1184). The
    # functions of
    # K1, K3 and K7 are each one scaled_dot_product_attention call under a
    # boolean mask; no single PyTorch call computes the others: K2/K4
    # dequantize int8 rows by per-token scales, K5/K6 are a product and an
    # argmin
    kernels = []
    k7 = pa.paged_flash_decode
    print(f"K7 launches on the serving paths {k7.launches}; the smoke's own "
          f"K7 check calls {tally[k7.__name__]}", flush=True)
    launches.update({pa.paged_flash_decode_stream_flat.__name__: k3_launches,
                     pa.paged_flash_decode_stream_flat_q8.__name__:
                     k4_launches, k7.__name__: k7.launches})
    for name, fn, tpu in (("K1", pa.paged_flash_decode_owner, K1_TPU),
                          ("K2", pa.paged_flash_decode_owner_q8, K2_TPU),
                          ("K3", pa.paged_flash_decode_stream_flat, K3_TPU),
                          ("K4", pa.paged_flash_decode_stream_flat_q8,
                           K4_TPU),
                          ("K7", k7, K7_TPU)):
        r = results[name, torch.bfloat16]
        kernels.append({"name": fn.__name__, "route": "cuda",
                        "source": SOURCE, "replaces": tpu,
                        "launches": launches[fn.__name__],
                        "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                        "bound_by": r["bound"][1],
                        "library_ms": r.get("library_ms"),
                        "cold_ms": r["cold_ms"],
                        "cold_plain_ms": r["cold_plain_ms"],
                        "cold_library_ms": r["cold_library_ms"],
                        "records": r["records"]})
    for name, fn, tpu, n_launch, nq in (
            ("K5", vq.nearest_code, K5_TPU,
             k5_launches + k5_train_launches + k5_11_launches
             + k5_12_launches, 1),
            ("K6", vq.rvq_encode_fused, K6_TPU,
             k6_launches + k6_20_launches + k6_train_launches
             + k6_cli_launches + k6_15_launches + k6_11_launches, 4)):
        err, ms, plain_ms, n_rec = vq_results[name, 250]
        b_ms, b_by = vq_bound(250, VQ_SHAPES["n"], VQ_SHAPES["d"], nq)
        kernels.append({"name": fn.__name__, "route": "cuda",
                        "source": VQ_SOURCE, "replaces": tpu,
                        "launches": n_launch, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None,
                        "records": n_rec})
    kernels[-2]["kmeans_m600"] = k5_train
    kernels[-1]["nq16"] = {
        f"M={m}": {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": vq_bound(m, VQ_SHAPES["n"], VQ_SHAPES["d"],
                                        NQ20)[0], "records": n_rec}
        for m, (_, worst, ms, plain_ms, n_rec) in k6_20.items()}
    kernels[-1]["hcodec15_groups"] = k6_15
    k8 = la.latent_attention
    print(f"K8 launches on the Moonlight serving path {k8_launches}; the "
          f"smoke's own K8 check and timing calls "
          f"{k8_tally[k8.__name__]}", flush=True)
    kernels.append({**latent, "launches": k8_launches})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
