#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

It drives the slices of the port, each deployed on engine 'fused': ResNet-18 FP8
PTQ, ResNet-18 INT8 PTQ (--int8-mxu --quantize-input), MobileNetV2 FP8 PTQ
under --bn-mode fp32_after and folded, ViT-S/16 FP8 PTQ, ViT-S/16 and
MobileNetV2 on the int8 datapath, the layer options (1-D, transposed and
grouped convs, MobileNetV2 width_mult and LSQ_paper), INT8 PTQ with
output quant (BASELINE.json config 2) on ResNet-18 and MobileNetV2 in both
bn modes, ResNet-18 FP8 with --quantize-input, ResNet-18 FP8 with the MSE
range search (BASELINE.json config 3; at E4M3 and E5M2 too), and ResNet-50
FP8 PTQ, with ResNet-18's space-to-depth stem beside, QAT of MobileNetV2 FP8
(BASELINE.json config 5), the analytical SQNR study (config 1),
bench.py's five rows with their deployment flags on 'bf16' and 'fused', and
the checkpoints and serving export of deployed models, and their
data- and tensor-parallel runs over two ranks on the one card.  Every
slice deploys
through the CLI's prepare pass (nn/bake.prepare_inference), and every phase
that runs a slice's models after it (fused against bf16, throughput,
profile) runs the prepared forward.  Every phase but gate runs under the
kernel gate's 'always' mode (ops/kernels/autotune.py: each kernel of its path
launches, as before the gate); gate runs the user's default, 'auto'.  After
it, checkpoint saves, restores and re-deploys calibrated and QAT states,
and export serializes the deployed models with their kernels as torch ops
and runs them from the artifacts alone.  Phases, one JSON line each (a failed phase prints "ok": false and
the script exits 1 without the final result line):

1. env        - card name and power limit (nvidia-smi), torch and nvcc
                versions, the kernels' build from csrc/ (one nvcc per
                source, all started together) and its seconds.
2. check      - each FP8 kernel against its plain PyTorch version on the
                card at the main path's shapes, batch 64: qmatmul at the
                three downsample shapes, the fc and one in-kernel FP8-weight
                case, and at the edges of its 128 x BN x 64 tiling (M =
                1,000 and 12,608, K = 72 and 1,000, N = 16 and 24, float32
                and bf16 x); qconv3x3 at ResNet-18's seven 3x3 shapes plus one
                residual case and the edges of its tiling (CONV_EDGES: Cin 8,
                16, 24 and 72, whose 64-wide K chunks straddle taps, odd H
                at stride 2, 1x1 and 2x2 maps, M not a multiple of 128,
                Cout 8 and 24, float32 and bf16 residuals, float32
                outputs, relu6 and no activation); qstem at (64, 224, 224,
                3) and at the edges of its tiling (STEM_EDGES: S = 32 and
                40, cin 1 and 4, bf16 images, float32 outputs).  Holds if >= 99%
                of elements are exact and the rest within one FP8 grid step
                (the kernel sums in another order than cuDNN/cuBLAS in fp32).
   mbits_check - each FP8 kernel at the other mantissa widths the MSE
                search's vote can give (M = 1, 2, 3, 5, 6), one main-path
                shape each (qmatmul: the 14x14 downsample and the fc with
                in-kernel weights; qconv3x3 56x56x64; the stem; qdwconv3x3
                56x56x144; a 28x28 qblock), held as phases 2 and 8 with
                each quantizer's own M in the grid step; not timed.
3. int8_check - each int8 kernel against its plain version (exact integer
                sums in float64): qmatmul_int8 at the three downsample shapes
                and the fc with baked int8 weights, plus one in-kernel-weight
                and one unsigned-grid case and the edges of its tiling
                (INT8_MATMUL_EDGES: M 1, 64 and 1,000, K 72 and 100, N 24
                and 1,000, unsigned and in-kernel weights, a 4-bit input
                grid, K split over a cluster); qconv3x3_int8 at the seven 3x3
                shapes, baked, plus in-kernel and unsigned weights and the
                edges of its tiling (H = 15 at stride 2, 7x7 with in-kernel
                unsigned weights, Cin = 16, Cout = 80).  Holds if >= 99% of
                elements are exact and all within rtol = atol = 2e-5.
                library_ms times torch._int_mm on the s8 operands (for the
                conv, on a prebuilt s8 im2col matrix: PyTorch has no int8
                convolution on CUDA, so it times the product alone; none
                where _int_mm does not take the shape).
   batch256   - qmatmul (downsamples and fc), qconv3x3_int8 and qconv3x3
                (FP8, then int_asym output quant; the seven 3x3 shapes),
                qmatmul_int8 (downsamples and fc) and qstem (FP8, then
                int_asym) at ResNet-18's shapes at batch 256, checked as in
                phases 2, 3 and 10, timed warm and cold, with sums per
                forward.
4. slice      - the FP8 main path as a user runs it: validate-quantized
                through the CLI's entry point (cli/image_net.
                validate_quantized) on ResNet-18 at full width with random
                torchvision-layout weights from the seed and synthetic
                224x224 data: calibrate 1 batch, bake, evaluate 2 batches
                with engine='fused', after the CLI's prepare pass (one
                forward of a zero image).  Launch counts are zeroed just
                before and read just after: exactly 1 stem, 16 conv3x3 and 4
                qmatmul per forward (the prepare forward and the two
                evaluation batches), no int8 kernel.  Then the state that
                run calibrated (kept as the CLI bakes it, Forwards) under
                'fused' and 'bf16' on the same batches, both baked and
                prepared, the prepared fused logits
                first held bit-equal to the unprepared ones: logits finite,
                top-1 (argmax) equal on >= 99% of images and >= 98% of
                logits within one grid step of the fc's output quantizer
                (2^-M at its own M).
5. int8_slice - the INT8 path the same way: calibrate, bake_int8_weights,
                evaluate 2 batches; exactly 16 qconv3x3_int8 and 4
                qmatmul_int8 launches per forward and none of the FP8
                kernels (the stem runs ops/int8.int8_conv).  Then 'fused'
                against 'bf16' (ops/int8) on one calibrated, int8-baked
                state: logits finite, top-1 agreeing on >= 99% of images,
                >= 98% of logits within rtol = atol = 1e-3 (an input-quant
                bin flip from one float ulp upstream moves a few).
6. timing     - per kernel, summed over one ResNet-18 forward at batch 64:
                device ms (kernel_ms: CUDA events, the calls enqueued while
                the card spins, so no host time) of the kernel, of its
                plain version, of one
                PyTorch call computing the same function (library_ms: bf16
                channels-last F.conv2d, torch.matmul, F.conv2d +
                max_pool2d, torch._int_mm) and the bound max(bytes / 3.35
                TB/s, operations / peak: 989 TFLOP/s bf16, 1,979 TOP/s
                int8); for the redesigned kernels (COLD_TIMED) also
                ms_cold, with the L2 cache flushed by a 64 MB write before
                each call (cold_ms); images/s of FP8 'fused' against 'bf16' at batch 64
                and 256, timed in turns (fused, bf16, bf16, fused, ...),
                each turn's ms listed and images/s from their median; and
                images/s of INT8 'fused' at batch 64 and 256.
7. profile    - torch.profiler over three fused forwards at batch 64, FP8
                and INT8: device time per forward by kernel name (the
                port's kernels and the top PyTorch kernels), kernel
                launches per forward and the device's idle share of the
                wall time ("not measured" if the profiler records no device
                time), of the prepared model, and beside it ("unprepared")
                the launches, wall and busy ms and idle share of the same
                model before its prepare pass; so in every profile phase.
8. mnv2_*     - MobileNetV2 FP8 (tonylins topology at full width, 1000
                classes, random fan-in-scaled weights from the seed), per bn
                mode: the slice as in phase 4 (fp32_after: 17 qblock and 2
                qmatmul launches per forward; folded: 17 qdwconv3x3 and 35
                qmatmul), with the input-dependent share of the logits'
                spread (> 0.01, so that fused against bf16 does not compare
                constants); throughput of fused against bf16 at batch 64;
                a profile.  The first fused forward records the depthwise
                and block kernels' operands, and mnv2_check holds each
                distinct call against its plain version (qdwconv3x3 100%
                exact: the same products summed in the same order; qblock
                as phase 2, its project sum runs over chunks, and in a
                residual block one step of the project's grid is added to
                the bound: that stage is quantized before the add) and times it
                as phase 6, the bound counting the stencil's float32
                operations at 67 TFLOP/s (for a block the larger of the
                stencil's and the tensor cores' time, separate pipes), plus
                two blocks as a --quant-setup dw_bf16_acts model calls them
                (expand and dw without output quant; not counted as
                launches of the main path) and two blocks at the edges of
                qblock's tiling on synthetic operands (BLOCK_EDGES: 15x15
                with a residual, 14x14 at stride 2 with hid 144 and Cout
                24); qblock and qdwconv3x3 are also timed with the L2
                flushed (cold_ms).  library_ms: bf16 channels-last
                F.conv2d(groups=C), and for a block the three stages as
                three calls (torch.matmul, F.conv2d(groups=C),
                torch.matmul).
9. vit_*      - ViT-S/16 FP8 (patch 16, dim 384, depth 12, 6 heads, MLP
                ratio 4, 1000 classes, random timm-layout weights from the
                seed, --quant-setup all): validate-quantized as in phase 4
                (12 flash_mha and 37 qmatmul launches per forward), the
                input-dependent share of the logits (> 0.01), then fused
                against bf16 (whose attention is the float32 chain) on one
                calibrated, baked state.  Twelve E3M4 blocks make the logits
                chaotic, so fused is held to the floor that moving every
                input by one float32 ulp gives the bf16 model: the rms gap
                to bf16 over the logits' spread at most twice the floor,
                with activation quantization on and off, and the rms error
                against the float32 forward at most 1.25 times bf16's (the
                shares of phase 4 are printed beside); throughput of fused
                against bf16 at batch 64; a profile.  vit_check holds
                the first fused forward's attention call (recorded, 12 uses)
                and synthetic calls (64, 6, S, 64) for S in {50, 128, 129,
                256, 385} (one step, a ragged last step, three steps)
                (strided float32 views as the model passes them) and one
                on contiguous bf16 operands against
                flash_mha_plain: >= 99% bit-equal and all within 2 bf16 ulps
                at the larger of the two outputs and the attention-weighted
                mean of |v| (where the weighted sum cancels, a p rounded to
                its neighbouring bf16 value moves it by a step of the
                terms); timed as in phase 6 and cold, the bound from the bytes the
                kernel reads (float32 or bf16 q, k, v) and writes (float32)
                and 4*B*H*S^2*D tensor-core operations; library_ms:
                F.scaled_dot_product_attention on contiguous bf16
                (B, H, S, D).  Then the forward's four qmatmul calls (qkv,
                proj, mlp2: 12 uses each; the head: 1) and two edge calls
                at the ViT's M (K = 72, N = 16; K = 1,000, N = 24 with
                float32 x, input quant and in-kernel weights) against
                qmatmul_plain as in phase 2, timed warm and cold as in
                phase 6, with their sums per ViT forward (the kernels
                line's qmatmul row stays ResNet-18's forward).
   vit_int8_slice - ViT-S/16 on the int8 datapath (VIT_INT8_CLI_ARGS:
                bench.py's INT8 row's quantizers without its TPU flags)
                through validate-quantized: exactly 37 qmatmul_int8
                launches per forward, every one through its s8 input
                branch (the operand made by its producer, PrequantS8), and
                12 flash_mha on the unpadded 197-token stream; fused against
                bf16 from the run's calibrated, int8-baked state, chaotic
                (unquantized logits, flash's bf16 operands): the rms gap at
                most twice bf16's one-ulp floor, input share > 0.01; the s8
                branch against its plain version at its four shapes (qkv,
                proj, mlp2: 12 uses; the head: 1), as phase 3, timed as
                phase 6 (library_ms: torch._int_mm on the s8 operands),
                its sums per forward the kernels line's qmatmul_int8_s8
                row; the attention call against flash_mha_plain as in
                vit_check; vit_int8_throughput: fused against bf16 at
                batch 64 as phase 6.
   mnv2_int8_qi_slice - MobileNetV2 on the int8 datapath (the CLI's
                default bn mode, fp32_after): exactly 35 qmatmul_int8
                launches per forward (float32 x) and no other kernel (no
                qblock, no qdwconv3x3), the stem and the 17 depthwise convs
                on ops/int8.int8_conv (18 calls per forward); fused against
                bf16 as phase 5; each distinct qmatmul_int8 call of the
                first fused forward against its plain version as phase 3;
                mnv2_int8_qi_throughput as vit_int8_throughput.
   layer_options_check - one forward each on the card against a CPU copy
                (the plain versions), FP8 on 'fused' at batch 4:
                QuantConv1d (k 5, stride 2, BN, relu), QuantConvTranspose
                (4x4, stride 2, SAME) and a conv with groups 4 (the composed
                path: all within one grid step, >= 98% equal), MobileNetV2
                at width_mult 1.4 (3 qblock, 14 qdwconv3x3 and 29 qmatmul
                launches: its blocks whose widths are not multiples of 8
                go layer by layer) and MobileNetV2 LSQ_paper at full width
                (35 qmatmul launches with in-kernel input quant); each
                distinct kernel call of the two card forwards against its
                plain version by its kernel's check (deploy_replay), the
                chaotic end-to-end gap to the CPU copy printed.
10. int_*     - the integer branches of the FP8/bf16 kernels and input
                quantization in qmatmul.  int_check: as phase 2 on the
                integer grids (int_asym output quant, baked int_sym
                weights): qstem, qconv3x3 at the seven 3x3 shapes plus a
                residual case, qmatmul at the three downsamples and the fc,
                plus in-kernel int_sym weights (signed; unsigned on the
                [0, 255] grid) and two edge cases (M = 1,000 and 777, K =
                72 and 1,000, N = 16 and 24); >= 99% exact, the rest within
                one integer step; then qmatmul with the input quantized in
                the kernel, FP8 at the four calls of a --quantize-input
                forward, one int_asym case and two edge cases (K = 72, N =
                24; K = 1,000, N = 16 on bf16 x) (float32 output: >= 99%
                exact, all within 1e-5 of the largest); each timed as phase
                6, with sums per forward.  int8oq_slice: BASELINE config 2 (per-channel
                symmetric_uniform weights, asymmetric_uniform activations
                at each layer's output, current_minmax / allminmax) on
                ResNet-18 as phase 4: exactly 1 qstem, 16 qconv3x3 and 4
                qmatmul launches per forward and no int8 kernel, fused
                against bf16 on the fc's integer grid, input-dependent
                share > 0.01; a throughput turn and a profile.  qi_slice:
                the FP8 main path with --quantize-input: 4 qmatmul per
                forward and neither qstem nor qconv3x3; its logits are not
                quantized and chaotic (every layer quantizes its input on
                an E3M4 grid), so fused is held against the same model on
                the CPU (the kernels' plain versions), as in vit_slice the
                rms gap over their spread at most twice the
                one-float32-ulp floor; the gaps of fused and bf16 to the
                'parity' engine (the reference's semantics) and parity's
                own floor are printed.  mnv2_int8_*: MobileNetV2 under config 2's
                quantizers in both bn modes as phase 8 (17 qblock + 2
                qmatmul; 17 qdwconv3x3 + 35 qmatmul, each with a throughput
                turn and a profile), and mnv2_int8_check on their recorded
                depthwise and block calls, with the edge blocks on the
                integer grids.
11. batch256_block_attn - flash_mha on (256, 6, 197, 64) float32 views,
                qblock on the FP8 fp32_after forward's recorded calls with
                x repeated to N = 256 and qdwconv3x3 at MobileNetV2's ten
                depthwise shapes at batch 256 (FP8, then integer grids),
                checked as in phases 8 and 9, timed warm and cold, with
                sums per forward.
12. mse_*      - BASELINE.json config 3 on ResNet-18 through
                validate-quantized (MSE_CLI_ARGS): the MSE search for
                weights and activations on one calibration batch of 64
                with the mantissa-bit sweep and vote, one pass of the
                network format search, bake, prepare, 2 evaluation
                batches; mse_e4m3_slice the same at E4M3 without the
                sweep.  As phase 4, plus the format search's fixed-mode
                forwards before the bake (4 qmatmul launches each, counted
                by Forwards); fused and bf16 take the state the CLI's run
                calibrated and format-searched (so the search runs once a
                slice), their formats held equal to the deployed model's.  The line prints the seconds
                of the calibration and of the format search and the
                histogram of the FP8 formats voted, deployed and compared.
                A throughput turn and a profile each.  mse_e5m2_slice: the
                same at E5M2 (--fp8-mantissa-bits 2, no sweep), without a
                throughput turn or a profile.
13. r50_*      - ResNet-50 FP8 (stages 3, 4, 6, 3, bottleneck blocks, full
                width, 1000 classes, random bottleneck-scaled weights from
                the seed, models/convert.random_resnet_state_dict) as phase
                4: exactly 1 qstem, 16 qconv3x3 and 37 qmatmul launches per
                forward (32 block 1x1 convs, 4 downsamples, the fc), fused
                against bf16, input-dependent share > 0.01, a throughput
                turn and a profile.  r50_check holds the first fused
                forward's distinct qmatmul and qconv3x3 calls (recorded)
                against their plain versions as phase 2 and times them as
                phase 6, warm and cold, with their sums per ResNet-50
                forward (the kernels line's rows stay ResNet-18's).
14. s2d_check  - ResNet-18 FP8 with stem_s2d=True and 'input' (fed
                space_to_depth(x)) from phase 4's calibrated state, baked
                and prepared: bit-equal to unprepared, against phase 4's
                default-stem model at its measures, 0 qstem, 16 qconv3x3
                and 4 qmatmul launches per forward; images/s of 'input'
                beside the default stem.
15. qat_slice  - BASELINE.json config 5 through train-quantized
                (QAT_CLI_ARGS): MobileNetV2 FP8 at full width, 1000 classes,
                batch 64, fp32_after, per-channel E3M4 weights with learned
                maxvals, current_minmax / allminmax, 1 calibration batch, 8
                SGD steps (lr 0.001, momentum 0.9) with Adam (1e-5) on the
                ranges, oscillation dampening and freezing, BN
                re-estimation on 2 batches, then bake, prepare and 2
                evaluation batches on 'fused'.  Training runs the composed
                bf16 route, so exactly 17 qblock and 2 qmatmul launches per
                deployed forward (the prepare pass and the 2 batches) and
                none before; every step's loss finite; some learned maxval
                off its calibrated value; fused against bf16 on the one
                trained, baked, prepared state as phase 8.  Prints each
                step's ms, images/s and the peak memory of training.
16. qat_check  - the learn step on the card against the CPU at batch 8 from
                one calibrated state: each layer's gradients on pinned
                inputs at cosine >= 0.99, the chaotic end-to-end logits held
                to twice their one-ulp floor, the one-step loss and update
                cosines printed beside the ulp-moved CPU run's; a repeated
                batch's loss falls over 8 steps.
17. sqnr_study - the study at its reference size (5M samples, 1,000
                candidates, seed 10) on the card: the table, its seconds,
                the reference's qualitative results (see the phase), and
                the card's ranges and MSEs against the CPU's at 200k
                samples.

18. cast_check - the deployment cast path (ops/fp8.fp8_quantize_cast) on
                the card for M in {2, 3, 4} at maxval 1.0, 3.7, 57.0 and
                0.013 (JAX's tests/test_cast_quant.py cases): equal by value
                to the exact pipeline, bit-equal to the CPU's, and its 1-byte
                store_f8 bytes equal to the CPU's (E3M4 as its IEEE codes).
19. deploy_rows - bench.py's five configurations (DEPLOY_ROWS: MobileNetV2
                dw_bf16_acts at batch 2048, ViT-S/16 at 128, ResNet-50 with
                deploy_act_f8 at 512, ResNet-18 INT8 with conv_out_bf16 and
                int8_assume_signed at 1024, ResNet-18 FP8 with the s2d
                'input' stem at 1024; the FP8 rows with deploy_cast_quant
                and conv_out_bf16), each at full width from the seed's
                random weights, calibrated on 128 synthetic images, deployed
                on the card, on bf16 serving input, on 'bf16' and 'fused'.
                One line per row: launches per forward (the 'fused' row's
                kernels exactly, none on 'bf16'), top-1 agreement >= 98%
                with the row without its flags (on the ViT row, FLOOR_ROWS,
                or at least that exact model's agreement with itself on
                inputs moved by one bf16 ulp: its random-weight logits are
                chaotic), logits bit-equal where only deploy_cast_quant
                (INT8: int8_assume_signed) differs, every distinct kernel
                call of the 'fused' forward run again whole against its
                plain version (deploy_replay), the 'bf16' layers on the
                card against a CPU copy (layer_hold), the 'fused' logits against
                the 'bf16' ones, images/s against the float32 forward
                (quantization off, bf16 images) at the same batch, peak
                memory, the card's name and power limit.
20. gate       - the kernel gate's default, 'auto', from an empty live cache
                (a temporary file): ResNet-18 FP8, MobileNetV2
                FP8 fp32_after, ViT-S/16 FP8 and ResNet-18 INT8 input
                quant (GATE_MODELS) through validate-quantized at batch 64,
                whose first evaluation batch races each kernel against its
                composed route at each new shape.  One line per model: the
                launches of the evaluation batches and of one prepared
                forward equal what the gates' answers imply, whatever the
                verdicts (the launches inside the races and the prepare
                pass apart); the prepare passes race and record nothing;
                the prepared fused logits bit-equal to the unprepared ones
                and held against bf16 as the slice phases hold them;
                images/s under auto, always and bf16, in turns (on the
                INT8 row, auto's images/s over always's at least 0.9, the
                median of 24 adjacent short pairs); the host
                microseconds of one forward's warm gate calls.  Then the
                cache file reloaded answers the four prepared forwards with
                zero races and the same verdicts; one line per verdict
                (kernel and composed ms) and the phase's line.
21. checkpoint - utils/checkpoint.py through the CLI: ResNet-18 FP8
                validate-quantized (as phase 4) with --save-checkpoint-dir,
                then with --load-type quantized from it: the metrics lines
                equal and the deployed models' logits bit-equal; two runs
                under --deterministic (undone after): bit-equal logits; each
                run 1 qstem + 16 qconv3x3 + 4 qmatmul per baked forward.
                train-quantized (phase 15's MobileNetV2 FP8, 2 steps) with
                --save-checkpoint-dir: the QAT state restored into a fresh
                init_qat_state equals the trained one tensor for tensor
                (model, both optimizers, oscillation state, step), and its
                fixed-mode forward on the card is bit-equal.
22. export     - serving/export.py at full width: the slices' deployed
                'fused' models (ResNet-18 FP8 with a symbolic batch,
                ResNet-18 INT8 input quant, MobileNetV2 FP8 in both bn
                modes, ViT-S/16 FP8) and ResNet-18 FP8 on 'bf16' with
                deploy_cast_quant, conv_out_bf16 and deploy_act_f8 (E3M4)
                exported (the eight kernels as fp8tpu::* ops), then loaded
                and run in one serving process that imports neither
                ...models nor ...nn.layers.  Per artifact (one line each:
                export seconds, artifact MB, launches, largest difference):
                logits bit-equal to the live model's (the symbolic one at
                batches 1, 7 and 64, the others at 64), kernel launches per
                forward equal, PyTorch launches per forward (the launch
                calls torch.profiler records; the artifact also loaded
                here, beside the live model under the artifact's cuDNN
                settings) no more than live's; the
                symbolic artifact's images/s beside live's in turns (no
                bound); the phase's seconds.
23. parallel   - distribution (parallel/) on the one card: two ranks as
                torchrun starts them (gloo, both on cuda:0, each a
                subprocess under its own timeout, the gate's 'always'),
                each through the CLI's entry points with its mesh flags,
                against one process on the card running the same command
                at the same global batch (computed here while the ranks
                run).  (a) ResNet-18 FP8 at --data-parallel 2, global batch
                128: metrics equal (loss rtol 1e-5), every quantizer's
                state within JAX's own bound (rtol 1e-6 / atol 1e-7; its
                bit-equality printed beside a witness of whether cuBLAS's
                fc product of one rank's 64 rows equals those rows of the
                128-row product), each rank's logits held as phase 2 holds
                a kernel against one process deploying the same state and
                within one grid step of the single process's, top-1 equal;
                (b) the same with the MSE search: tables within rtol 1e-5,
                the voted M and each pick whose two best candidates differ
                by more than that equal; (c) --model-parallel 2 at batch
                64: logits bit-equal, parameter bytes at rest, gathered and
                in the operand caches per rank; (d) MobileNetV2 FP8 QAT
                (config 5) at --data-parallel 2, global batch 16, 2 steps:
                the ranks' whole state bit-equal after each step
                (digests), every layer's gradients on pinned inputs over
                the two ranks at cosine >= 0.99 with one process's, the
                end-to-end updates' cosines printed beside the floor of one
                process whose BN sums as the ranks do, deployed on 'fused'
                (17 qblock + 2 qmatmul a forward); (e) a one-rank NCCL
                group: an all_reduce on the card and (a)'s calibration bit-
                equal to (a)'s single process.  Launches of the ranks'
                deployed forwards are added to the kernels line; each
                sub-run's seconds and the collectives (count, host
                seconds) of a calibration forward are a record (the ranks
                share the card with the references; one card shows no
                scaling).

Then a {"kernels": [...]} line (launches: the sum over the main-path runs
of phases 4, 5, 8, 9 (vit_int8_slice and mnv2_int8_qi_slice included), 10,
12, 13, 15, 19, 20 (outside the races) and 21,
the artifact forwards of phase 22 and the ranks' runs of phase 23; times: the FP8 forwards of
phases 6, 8 and 9; max_abs_err over every check, phase 19's replays
included; after qmatmul_int8 its s8 input branch, qmatmul_int8_s8: the
launches of vit_int8_slice's main path, its times and bound per ViT-S
INT8 forward), the nvidia-smi name/power-limit line, and last
{"ok": true, "device": {...}}.  The plain versions run with TF32 off.
"""

import json
import logging
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SEED = 0
BATCH = 64
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12           # dense int8 tensor-core peak
FP32_FLOPS_PER_S = 67e12           # float32 outside the tensor cores
MBITS = 4                          # E3M4, the main path's format
THROUGHPUT_TURNS = 2               # pairs of (fused, bf16) / (bf16, fused)
THROUGHPUT_ITERS = 5               # forwards per timed turn

# (H, Cin, Cout, stride, uses per ResNet-18 forward) of the 3x3 convs
CONV_SHAPES = [(56, 64, 64, 1, 4), (56, 64, 128, 2, 1), (28, 128, 128, 1, 3),
               (28, 128, 256, 2, 1), (14, 256, 256, 1, 3), (14, 256, 512, 2, 1),
               (7, 512, 512, 1, 3)]


def matmul_shapes(batch=BATCH):
    """(M, K, N, out) of ResNet-18's qmatmul calls: the 1x1/2 downsamples
    and the fc."""
    return [(batch * 28 * 28, 64, 128, "norm"), (batch * 14 * 14, 128, 256, "norm"),
            (batch * 7 * 7, 256, 512, "norm"), (batch, 512, 1000, "value")]


MATMUL_SHAPES = matmul_shapes()
# (M, K, N, x dtype, weights, out) of qmatmul calls at the edges of its
# 128 x BN x 64 tiling that the main path does not reach: M not a multiple
# of 128, K not a multiple of 64, N below 32, float32 and bf16 x, weights
# baked or quantized in the kernel
MATMUL_EDGES = {"fp8": [(1000, 72, 16, "bf16", "baked", "norm"),
                        (BATCH, 1000, 24, "float32", "in-kernel", "value"),
                        (12608, 1000, 24, "bf16", "baked", "norm")],
                "int": [(1000, 72, 16, "bf16", "in-kernel", "value"),
                        (777, 1000, 24, "float32", "baked", "norm")]}


FAILED = []     # the lines that reported ok false, repeated on stderr at the end


def emit(obj):
    print(json.dumps(obj), flush=True)
    if obj.get("ok") is False:
        FAILED.append(obj)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def nvcc_version():
    from fp8_quantization_tpu_torch.ops.kernels.build import _nvcc
    out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[-1]


def time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters=20, warmup=3, repeats=3):
    """Device ms per call of ``fn``: the calls are enqueued while the card
    spins (torch.cuda._sleep) before the start event, so the time between
    the events is the card's alone even where the wrapper's Python takes
    longer than a short kernel; the least of ``repeats`` such timings, so
    that a host stall past the spin (a shared host's CPU) does not count."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = math.inf
    for _ in range(repeats):
        torch.cuda._sleep(spin_cycles(host_s))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def spin_cycles(host_s):
    """Clock cycles for the card to spin while the host spends ``host_s``
    enqueueing (1.5x and 0.2 ms more, at the H100's 1.98 GHz boost clock;
    a slower clock spins longer), at most one second."""
    return int(min(1.5 * host_s + 2e-4, 1.0) * 1.98e9)


def cold_ms(fn, iters=10):
    """Device ms of one call of ``fn`` with the L2 cache (50 MB) flushed
    before it by a 64 MB scratch write; the card spins while the host
    enqueues the call, and the events bracket the call alone."""
    import torch
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        scratch.fill_(1)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles(host_s))
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


# the redesigned kernels, timed also with the L2 cache flushed (cold_ms)
COLD_TIMED = ("qmatmul", "qconv3x3_int8", "qblock", "flash_mha", "qconv3x3",
              "qmatmul_int8", "qdwconv3x3", "qstem")


def bound_ms(bytes_moved, flops, peak=BF16_FLOPS_PER_S):
    return 1e3 * max(bytes_moved / HBM_BYTES_PER_S, flops / peak)


def bound_by(bytes_moved, flops, peak=BF16_FLOPS_PER_S):
    return "bytes" if bytes_moved / HBM_BYTES_PER_S > flops / peak else "operations"


def const_mbits(consts):
    """The mantissa bits M of the FP8 quantizer of the (6, 1) ``consts``,
    from row 4, ``g = -M - 2^E + 1`` with E = 8 - sign bits - M."""
    g = float(consts[4, 0])
    for sign in (1, 0):
        for m in range(1, 9 - sign):
            if -m - 2.0 ** (8 - sign - m) + 1.0 == g:
                return m
    raise ValueError(f"no 8-bit FP8 format has g = {g}")


def grid_step(a, b, consts, normalized, method="fp8"):
    """One grid step of the quantizer of the (6, 1) ``consts`` at the larger
    of |a|, |b|: FP8, 2^-M of the magnitude (M that quantizer's own) plus
    the smallest step; int_asym, one integer step (delta, or 1 on the
    normalized grid)."""
    import torch
    if method == "int_asym":
        return 1.0 if normalized else float(consts[0, 0])
    min_step = 2.0 ** (1.0 + float(consts[4, 0]))
    if not normalized:
        min_step *= float(consts[5, 0])
    return torch.maximum(a.abs(), b.abs()) * 2.0 ** -const_mbits(consts) + min_step


def grid_check(out, ref, consts, normalized, extra=0.0, method="fp8"):
    """(ok, max_abs_err, exact share): >= 99% exact, the rest within one
    grid step of the output quantizer (grid_step), plus ``extra`` (per
    element) where a step upstream carries through."""
    import torch
    a, b = out.float(), ref.float()
    diff = (a - b).abs()
    step = grid_step(a, b, consts, normalized, method) + extra
    exact = float((diff == 0).float().mean())
    ok = bool(torch.isfinite(a).all()) and bool((diff <= step).all()) and exact >= 0.99
    return ok, float(diff.max()), exact


def sum_check(out, ref):
    """(ok, max_abs_err, exact share) of an output with no quantizer after
    the product (the sums run in another order): >= 99% exact, all within
    1e-5 of the largest magnitude."""
    import torch
    a, b = out.float(), ref.float()
    diff = (a - b).abs()
    exact = float((diff == 0).float().mean())
    ok = (bool(torch.isfinite(a).all()) and exact >= 0.99
          and float(diff.max()) <= 1e-5 * float(b.abs().max()))
    return ok, float(diff.max()), exact


def fp32_sum_check(args, cfg, out, ref):
    """(ok, max_abs_err against the plain version, exact share) of a qmatmul
    call with the input quantized in the kernel (no quantizer after the
    product): sum_check's bound against the plain version (every output
    within 1e-5 of the largest magnitude), and against the float64 sum of
    the same exact bf16 products every output within the float32
    summation bound (K + 8) * 2^-24 of the sum of the products'
    magnitudes (times the epilogue's factors), plus 2^-23 of the output
    for the epilogue's add: any order of float32 sums meets both.
    sum_check's third condition, 99% bit-equal to the plain version, holds
    where the partial sums are exact (ResNet-18's shapes); at MobileNetV2
    LSQ_paper's K of 576 to 1280 on dense float32 inputs the kernel's
    tensor-core chunks and the plain version's sgemm round differently
    (74-98% bit-equal on an H100), so it is printed, not held."""
    import torch
    from fp8_quantization_tpu_torch.nn.activations import get_activation
    from fp8_quantization_tpu_torch.ops.kernels.common import quantize_prepared
    x, w, w_c, a_c, scale, shift = args
    xf = quantize_prepared(x.float(), cfg.act_method, a_c, normalized=True)
    wf = quantize_prepared(w.float(), cfg.weight_method, w_c, channel_axis=0,
                           normalized=True)
    xf, wf = (t.to(torch.bfloat16).double() for t in (xf, wf))
    f = scale.double() * float(a_c[5, 0])
    if cfg.weight_method != "none":
        f = f * w_c[5].double()
    exact = (xf @ wf.t()) * f + shift.double()
    act = get_activation(cfg.activation)
    if act is not None:         # relu, relu6: 1-Lipschitz, the bound holds
        exact = act(exact)
    k = x.shape[1]
    bound = (k + 8) * 2.0 ** -24 * (xf.abs() @ wf.abs().t()) * f.abs() + 2.0 ** -23 * exact.abs()
    diff = (out.float() - ref.float()).abs()
    ok = (bool(torch.isfinite(out).all())
          and float(diff.max()) <= 1e-5 * float(ref.float().abs().max())
          and bool(((out.double() - exact).abs() <= bound).all()))
    return ok, float(diff.max()), float((diff == 0).float().mean())


class Inputs:
    """Random operands on the card from one seeded generator, on the FP8
    grids of M mantissa bits (``grid="fp8"``, ``mbits``) or the integer
    ones (``grid="int"``: int_asym activations, per-channel int_sym
    weights)."""

    def __init__(self, grid="fp8", mbits=MBITS):
        import torch
        self.g = torch.Generator(device="cuda").manual_seed(SEED)
        self.grid = grid
        self.mbits = mbits
        self.act_method = "fp8" if grid == "fp8" else "int_asym"

    def randn(self, *shape, scale=1.0):
        import torch
        return torch.randn(*shape, generator=self.g, device="cuda") * scale

    def uniform(self, n, lo, hi):
        import torch
        return torch.rand(n, generator=self.g, device="cuda") * (hi - lo) + lo

    def norms(self, *shape, maxval=4.0):
        """Activations on the normalized grid, bf16 (a factored input): FP8
        values of M mantissa bits, or the integers xint - zp of a relu'd
        block output."""
        import torch
        from fp8_quantization_tpu_torch.ops.fp8 import fp8_consts, fp8_quantize_prepared
        if self.grid == "int":
            x = torch.round(torch.relu(self.randn(*shape)) * 40.0).clamp(0.0, 255.0)
            return x.to(torch.bfloat16).contiguous()
        c = fp8_consts(torch.tensor([maxval], device="cuda"), self.mbits)
        return fp8_quantize_prepared(self.randn(*shape), c,
                                     normalized=True).to(torch.bfloat16).contiguous()

    def weight_norms(self, w):
        """Per-output-channel normalized weights (dim 0), float32 values: the
        FP8 grid of M mantissa bits, or the signed 8-bit integers of a
        symmetric quantizer."""
        import torch
        from fp8_quantization_tpu_torch.ops.fp8 import fp8_consts, fp8_quantize_prepared
        amax = w.abs().reshape(w.shape[0], -1).amax(dim=1)
        if self.grid == "int":
            delta = (amax / 127.0).reshape(-1, *[1] * (w.dim() - 1))
            return torch.round(w / delta).clamp(-128.0, 127.0)
        return fp8_quantize_prepared(w, fp8_consts(amax, self.mbits), channel_axis=0,
                                     normalized=True)

    def out_consts(self, y0):
        """(6, 1) output-quant constants with a range 0.8 of y0's."""
        import torch
        from fp8_quantization_tpu_torch.ops import uniform
        from fp8_quantization_tpu_torch.ops.fp8 import fp8_consts
        if self.grid == "int":
            delta, zf = uniform.asymmetric_set_quant_range(0.8 * y0.min(), 0.8 * y0.max(), 8)
            return uniform.int_asym_consts(delta, zf, 8)
        return fp8_consts(torch.tensor([0.8 * float(y0.abs().max())], device="cuda"),
                          self.mbits)


def in_kernel_weights(inp, N, K, unsigned=False):
    """(float32 w, (6, N) constants, method) of weights quantized in the
    kernel: FP8 on the FP8 grid, int_sym (signed or on the unsigned [0,
    255] grid) on the integer grids."""
    from fp8_quantization_tpu_torch.ops import uniform
    from fp8_quantization_tpu_torch.ops.fp8 import fp8_consts
    w = inp.randn(N, K, scale=0.02)
    w = (w.abs() if unsigned else w).contiguous()
    if inp.grid == "fp8":
        return w, fp8_consts(w.abs().amax(dim=1), inp.mbits), "fp8"
    delta, sgn = uniform.symmetric_set_quant_range(w.amin(dim=1), w.amax(dim=1), 8)
    return w, uniform.int_sym_consts(delta, sgn, 8), "int_sym"


def matmul_edge_cases(inp):
    """qmatmul cases at the edges of its tiling (MATMUL_EDGES; uses 0),
    with the output quant of ``inp``'s grid."""
    import torch
    from fp8_quantization_tpu_torch.ops.kernels import qmatmul as qm
    cases = []
    for M, K, N, xdt, weights, out in MATMUL_EDGES[inp.grid]:
        x = inp.norms(M, K)
        if xdt == "float32":
            x = x.float().contiguous()
        scale, shift = inp.uniform(N, 0.005, 0.015), inp.randn(N, scale=0.1)
        if inp.grid == "int":
            scale = scale * 0.05
        if weights == "baked":
            w = inp.weight_norms(inp.randn(N, K, scale=0.05)).to(torch.bfloat16)
            w_c, wm = None, "none"
        else:
            w, w_c, wm = in_kernel_weights(inp, N, K)
        y0 = qm.qmatmul_plain(x, w, w_c, None, scale, shift,
                              qm.FusedQuantMatmulConfig(weight_method=wm))
        cfg = qm.FusedQuantMatmulConfig(weight_method=wm, act_method=inp.act_method,
                                        emit_norm=out == "norm")
        nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
                  + M * N * (2 if out == "norm" else 4))
        xt, wt = x.to(torch.bfloat16), w.to(torch.bfloat16).t()
        cases.append((f"qmatmul {M}x{K}x{N} edge {xdt} x {weights} w {out}",
                       (x, w, w_c, inp.out_consts(y0), scale, shift), cfg,
                       2 * M * N * K, nbytes, 0,
                       lambda xt=xt, wt=wt: torch.matmul(xt, wt)))
    return cases


def matmul_cases(inp, batch=BATCH, edges=True):
    """(name, args, cfg, flops, bytes, uses, library fn) per qmatmul case:
    the three downsamples and the fc with baked weights, then weights
    quantized in the kernel (FP8; on the int grids signed and unsigned),
    then the edge cases (matmul_edge_cases)."""
    import torch
    from fp8_quantization_tpu_torch.ops.kernels import qmatmul as qm
    cases = []
    extra = ([(batch, 512, 1000, "fp8w")] if inp.grid == "fp8" else
             [(batch, 512, 1000, "int_sym w"),
              (batch * 14 * 14, 128, 256, "int_sym w unsigned")])
    for M, K, N, out in matmul_shapes(batch) + (extra if edges else []):
        x = inp.norms(M, K)
        scale, shift = inp.uniform(N, 0.005, 0.015), inp.randn(N, scale=0.1)
        if inp.grid == "int":
            scale = scale * 0.05
        if out == "fp8w" or out.startswith("int_sym"):   # quantized in the kernel
            w, w_c, wm = in_kernel_weights(inp, N, K, out.endswith("unsigned"))
        else:
            w = inp.weight_norms(inp.randn(N, K, scale=0.05)).to(torch.bfloat16)
            w_c, wm = None, "none"
        emit_norm = out == "norm"
        y0 = qm.qmatmul_plain(x, w, w_c, None, scale, shift,
                              qm.FusedQuantMatmulConfig(weight_method=wm))
        cfg = qm.FusedQuantMatmulConfig(weight_method=wm, act_method=inp.act_method,
                                        emit_norm=emit_norm)
        args = (x, w, w_c, inp.out_consts(y0), scale, shift)
        out_bytes = M * N * (2 if emit_norm else 4)
        nbytes = x.numel() * 2 + w.numel() * w.element_size() + out_bytes
        xt, wt = x, w.to(torch.bfloat16).t()
        cases.append((f"qmatmul {M}x{K}x{N} {out}", args, cfg, 2 * M * N * K,
                      nbytes, 1 if wm == "none" else 0,
                      lambda xt=xt, wt=wt: torch.matmul(xt, wt)))
    return cases + (matmul_edge_cases(inp) if edges else [])


def qi_matmul_cases(inp):
    """qmatmul with the input quantized in the kernel: the four calls of a
    ResNet-18 FP8 --quantize-input forward (the materialized float32 block
    outputs, baked FP8 weights, float32 output; uses 1 each), then one
    int_asym input case with in-kernel int_sym weights and two edge cases
    (uses 0)."""
    import torch
    from fp8_quantization_tpu_torch.ops import uniform
    from fp8_quantization_tpu_torch.ops.fp8 import fp8_consts
    from fp8_quantization_tpu_torch.ops.kernels import qmatmul as qm
    cases = []
    shapes = [(M, K, N, "fp8", 1, "") for M, K, N, _ in MATMUL_SHAPES]
    shapes.append((BATCH * 14 * 14, 128, 256, "int_asym", 0, ""))
    # edges: K and M off the tile, N below 32; a bf16 x is converted by the
    # wrapper (the kernel quantizes float32 inputs)
    shapes += [(1000, 72, 24, "fp8", 0, " edge"),
               (BATCH, 1000, 16, "int_asym", 0, " edge bf16 x")]
    for M, K, N, method, uses, label in shapes:
        x = torch.relu(inp.randn(M, K)).contiguous()
        if label.endswith("bf16 x"):
            x = x.to(torch.bfloat16)
        scale, shift = inp.uniform(N, 0.5, 1.5), inp.randn(N, scale=0.1)
        if method == "fp8":
            w = inp.weight_norms(inp.randn(N, K, scale=0.05)).to(torch.bfloat16)
            w_c, wm = None, "none"
            a_c = fp8_consts(torch.tensor([0.8 * float(x.max())], device="cuda"), MBITS)
        else:
            w = inp.randn(N, K, scale=0.05).contiguous()
            delta, sgn = uniform.symmetric_set_quant_range(w.amin(dim=1), w.amax(dim=1), 8)
            w_c, wm = uniform.int_sym_consts(delta, sgn, 8), "int_sym"
            a_delta, a_zf = uniform.asymmetric_set_quant_range(
                x.float().min(), 0.8 * x.float().max(), 8)
            a_c = uniform.int_asym_consts(a_delta, a_zf, 8)
        cfg = qm.FusedQuantMatmulConfig(weight_method=wm, act_method=method,
                                        quantize_input=True)
        nbytes = x.numel() * x.element_size() + w.numel() * w.element_size() + M * N * 4
        xt, wt = x.to(torch.bfloat16), w.to(torch.bfloat16).t()
        cases.append((f"qmatmul {M}x{K}x{N} {method} input quant{label}",
                      (x, w, w_c, a_c, scale, shift), cfg, 2 * M * N * K, nbytes,
                      uses, lambda xt=xt, wt=wt: torch.matmul(xt, wt)))
    return cases


# (batch, H, Cin, Cout, stride, residual dtype, emit_norm, activation) of
# qconv3x3 calls at the edges of its tiling that the main path does not
# reach: Cin 8, 16, 24 and 72 (a 64-wide K chunk straddles taps), odd H at
# stride 2, 1x1 and 2x2 maps, M not a multiple of 128, Cout 8 and 24, a
# float32 and a bf16 residual (the wrapper casts it to bf16 under
# emit_norm, to float32 otherwise), float32 outputs, relu6 and no
# activation; each on the FP8 and the integer grids
CONV_EDGES = [(3, 9, 8, 8, 1, None, True, "relu6"),
              (5, 15, 16, 24, 2, None, True, None),
              (4, 7, 24, 32, 1, "float32", False, "relu"),
              (2, 10, 72, 64, 2, "bfloat16", True, "relu6"),
              (3, 12, 72, 24, 1, "bfloat16", False, None),
              (7, 1, 64, 64, 1, None, True, "relu"),
              (6, 2, 32, 16, 2, None, False, None),
              (5, 2, 64, 128, 1, "float32", True, "relu"),
              (3, 28, 128, 128, 1, None, True, "relu6")]


def conv_cases(inp, batch=BATCH, edges=True):
    """(name, args, cfg, flops, bytes, uses, library fn) per qconv3x3 case:
    ResNet-18's seven 3x3 shapes (relu, output quant, bf16 norms out), one
    residual case, then (``edges``) CONV_EDGES."""
    import torch
    import torch.nn.functional as F
    from fp8_quantization_tpu_torch.ops.kernels import qconv as qc
    shapes = [(batch, H, cin, cout, s, None, True, "relu", uses)
              for H, cin, cout, s, uses in CONV_SHAPES]
    if edges:
        shapes += [(batch, 28, 128, 128, 1, "float32", True, "relu", 0)]
        shapes += [edge + (0,) for edge in CONV_EDGES]
    cases = []
    for n, H, cin, cout, s, res_dtype, emit, act, uses in shapes:
        residual = res_dtype is not None
        x = inp.norms(n, H, H, cin)
        w4 = inp.weight_norms(inp.randn(cout, cin, 3, 3, scale=0.05))
        w = qc.weight_matrix(w4)
        scale, shift = inp.uniform(cout, 0.005, 0.015), inp.randn(cout, scale=0.1)
        if inp.grid == "int":
            scale = scale * 0.05
        ho = (H - 1) // s + 1
        # residual values exact in bf16, so the wrapper's cast loses nothing
        res = (inp.norms(n, ho, ho, cout).to(getattr(torch, res_dtype))
               if residual else None)
        y0 = qc.qconv3x3_plain(x, w, None, scale, shift, res,
                               qc.FusedConvConfig(stride=s, residual=residual))
        cfg = qc.FusedConvConfig(act_method=inp.act_method, activation=act,
                                 residual=residual, emit_norm=emit, stride=s)
        args = (x, w, inp.out_consts(y0), scale, shift, res)
        flops = 2 * n * ho * ho * 9 * cin * cout
        nbytes = x.numel() * 2 + w.numel() * 2 + n * ho * ho * cout * (2 if emit else 4)
        if residual:
            nbytes += res.numel() * (2 if emit else 4)
        xl = x.permute(0, 3, 1, 2)                  # NCHW view, channels-last
        wl = w4.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        name = f"qconv3x3 {H}x{H}x{cin}->{cout} s{s}"
        if uses == 0:
            name += (f" edge batch {n} {res_dtype or 'no'} residual "
                     f"{'norm' if emit else 'value'} {act}")
        cases.append((name, args, cfg, flops, nbytes, uses,
                      lambda xl=xl, wl=wl, s=s: F.conv2d(xl, wl, stride=s, padding=1)))
    return cases


# (batch, S, cin, x dtype, out) of qstem calls the main path does not make:
# small maps (one 8x8 tile; 2x2 tiles with a ragged edge), cin 1 and 4
# (runs of 7 and 28 taps), bf16 images and float32 outputs
STEM_EDGES = [(3, 32, 3, "float32", "value"), (2, 40, 1, "bfloat16", "norm"),
              (2, 40, 4, "float32", "norm"), (1, 64, 3, "bfloat16", "value")]


def stem_cases(inp, batch=BATCH, edges=True):
    """(name, args, cfg, flops, bytes, uses, library fn) per qstem case:
    ResNet-18's stem, (batch, 224, 224, 3) float32 images, bf16 norms out,
    then (``edges``) STEM_EDGES."""
    import torch
    import torch.nn.functional as F
    from fp8_quantization_tpu_torch.ops.kernels import qstem as qs
    cases = []
    for n, S, cin, xdt, out in [(batch, 224, 3, "float32", "norm")] + (STEM_EDGES if edges else []):
        x = inp.randn(n, S, S, cin).to(getattr(torch, xdt)).contiguous()
        w4 = inp.weight_norms(inp.randn(64, cin, 7, 7, scale=0.05))
        w = qs.weight_matrix(w4)
        scale, shift = inp.uniform(64, 0.5, 1.5), inp.randn(64, scale=0.1)
        if inp.grid == "int":
            scale = scale * 0.02
        y0 = qs.qstem_plain(x, w, None, scale, shift, qs.FusedStemConfig(act_method="none"))
        cfg = qs.FusedStemConfig(act_method=inp.act_method, emit_norm=out == "norm")
        args = (x, w, inp.out_consts(y0), scale, shift)
        conv, p = (S - 1) // 2 + 1, qs.stem_out_size(S)
        flops = 2 * n * conv * conv * 49 * cin * 64
        nbytes = (x.numel() * x.element_size() + w.numel() * 2
                  + n * p * p * 64 * (2 if out == "norm" else 4))
        xl = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        wl = w4.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        name = f"qstem {S}x{S}x{cin}->64"
        if S != 224:
            name += f" edge batch {n} {xdt} x {out}"
        cases.append((name, args, cfg, flops, nbytes, 1 if S == 224 else 0,
                      lambda xl=xl, wl=wl: F.max_pool2d(
                          F.conv2d(xl, wl, stride=2, padding=3), 3, 2, 1)))
    return cases


def kernel_table():
    """name -> (wrapper, plain, module, CUDA source) of the eight kernels."""
    from fp8_quantization_tpu_torch.ops.kernels import (
        attention, qblock, qconv, qconv_int8, qdwconv, qmatmul, qmatmul_int8,
        qstem)
    return {
        "qstem": (qstem.fused_quant_stem, qstem.qstem_plain, qstem, "qstem"),
        "qconv3x3": (qconv.fused_quant_conv3x3, qconv.qconv3x3_plain, qconv,
                     "qconv"),
        "qmatmul": (qmatmul.fused_quant_matmul, qmatmul.qmatmul_plain, qmatmul,
                    "qmatmul"),
        "qconv3x3_int8": (qconv_int8.fused_quant_conv3x3_int8,
                          qconv_int8.qconv3x3_int8_plain, qconv_int8,
                          "qconv_int8"),
        "qmatmul_int8": (qmatmul_int8.fused_quant_matmul_int8,
                         qmatmul_int8.qmatmul_int8_plain, qmatmul_int8,
                         "qmatmul_int8"),
        "qdwconv3x3": (qdwconv.fused_quant_dwconv3x3, qdwconv.qdwconv3x3_plain,
                       qdwconv, "qdwconv"),
        "qblock": (qblock.fused_inverted_residual, qblock.qblock_plain, qblock,
                   "qblock"),
        "flash_mha": (attention.flash_mha, attention.flash_mha_plain,
                      attention, "flash_mha"),
    }


def check_cases(kinds, results, label, timed=True):
    """Each case against its plain version, timed (kernel, plain, library
    call; not with ``timed`` false) and bounded; one line each.
    ``results[kernel]`` sums the cases weighted by their uses per forward."""
    from fp8_quantization_tpu_torch.ops.kernels.common import no_tf32
    table = kernel_table()
    ok_all = True
    for kname, cases in kinds:
        wrapper, plain = table[kname][:2]
        agg = results.setdefault(kname, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                             bound_ms=0.0, library_ms=0.0))
        for name, args, cfg, flops, nbytes, uses, lib in cases:
            out = wrapper(*args, cfg=cfg)
            with no_tf32():
                ref = plain(*args, cfg)
            consts = args[3] if kname == "qmatmul" else args[2]
            if getattr(cfg, "quantize_input", False):       # no output quant
                ok, err, exact = sum_check(out, ref)
            else:
                ok, err, exact = grid_check(out, ref, consts,
                                            getattr(cfg, "emit_norm", False),
                                            method=cfg.act_method)
            bms = bound_ms(nbytes, flops)
            if not timed:
                emit({"phase": label, "case": name, "ok": ok, "max_abs_err": err,
                      "exact": exact, "bound_ms": bms})
                ok_all &= ok
                agg["max_abs_err"] = max(agg["max_abs_err"], err)
                continue
            ms = kernel_ms(lambda: wrapper(*args, cfg=cfg))
            cold = {"ms_cold": cold_ms(lambda: wrapper(*args, cfg=cfg))} \
                if kname in COLD_TIMED else {}
            with no_tf32():
                pms = kernel_ms(lambda: plain(*args, cfg), iters=5)
            lms = kernel_ms(lib)
            emit({"phase": label, "case": name, "ok": ok, "max_abs_err": err,
                  "exact": exact, "ms": ms, **cold, "plain_ms": pms, "library_ms": lms,
                  "bound_ms": bms, "bound_by": bound_by(nbytes, flops),
                  "uses_per_forward": uses})
            ok_all &= ok
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
            if uses:
                for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                             ("bound_ms", bms), *cold.items()):
                    agg[k] = agg.get(k, 0.0) + uses * v
                agg["bytes"] = agg.get("bytes", 0) + uses * nbytes
                agg["flops"] = agg.get("flops", 0) + uses * flops
    return ok_all


def phase_check_and_time(results):
    """Phases 2 and 6 for the FP8 kernels: one pass over the cases, holding
    each against its plain version and timing kernel, plain and library
    call; the sums per ResNet-18 FP8 forward go to ``results``."""
    inp = Inputs()
    return check_cases((("qstem", stem_cases(inp)), ("qconv3x3", conv_cases(inp)),
                        ("qmatmul", matmul_cases(inp))), results, "check")


# mantissa widths other than E3M4 that the MSE search's vote can give a
# quantizer (E6M1 .. E1M6)
OTHER_MBITS = (1, 2, 3, 5, 6)


def phase_mbits_check(results):
    """Each FP8 kernel at the other mantissa widths M (OTHER_MBITS), one
    main-path shape each, on operands and output quantizers of that M:
    qmatmul at the 14x14 downsample (baked) and the fc with FP8 weights
    quantized in the kernel, qconv3x3 at 56x56x64, the stem, qdwconv3x3 at
    MobileNetV2's 56x56x144 stride 1 and qblock on a 28x28 residual block
    (synthetic operands).  Held as phases 2 and 8 (grid_step reading each
    quantizer's own M from its constants; qdwconv3x3 bit-equal); not
    timed."""
    from fp8_quantization_tpu_torch.ops.kernels.common import no_tf32
    ok_all = True
    for m in OTHER_MBITS:
        inp = Inputs("fp8", mbits=m)
        mm = [c for c in matmul_cases(inp)
              if c[0].endswith(("x128x256 norm", "x1000 fp8w"))]
        kinds = (("qstem", stem_cases(inp, edges=False)),
                 ("qconv3x3", conv_cases(inp, edges=False)[:1]),
                 ("qmatmul", mm))
        ok_all &= len(mm) == 2
        ok_all &= check_cases(kinds, results, f"mbits_check M={m}", timed=False)
        a, kw = synthetic_dw(inp, BATCH, 56, 144, 1)
        dw = mnv2_dw_case(a, kw, 0, f" M={m}")
        a, kw = synthetic_block(inp, 28, 1, 32, 192, 32, True)
        blk = mnv2_block_case(a, kw, 0, f" M={m}")
        for kname, (name, call, plain, check, *_rest) in (("qdwconv3x3", dw),
                                                          ("qblock", blk)):
            out = call()
            with no_tf32():
                ref = plain()
            ok, err, exact = check(out, ref)
            if kname == "qdwconv3x3":
                ok = ok and dw_exact(out, ref)
            emit({"phase": f"mbits_check M={m}", "case": name, "ok": ok,
                  "max_abs_err": err, "exact": exact})
            agg = results.setdefault(kname, {})
            agg["max_abs_err"] = max(agg.get("max_abs_err", 0.0), err)
            ok_all &= ok
    return ok_all


def phase_int_check(int_results):
    """The integer branches and input quantization of the FP8/bf16 kernels,
    as phase 2 on the integer grids: qstem, qconv3x3 and qmatmul as a
    ResNet-18 INT8 output-quant forward calls them (sums per forward in
    ``int_results``), qmatmul with in-kernel int_sym weights (signed,
    unsigned), and qmatmul with FP8 input quant as a --quantize-input
    forward calls it (sums under "qmatmul_qi") plus one int_asym input
    case.  Int outputs hold if >= 99% are exact and the rest within one
    integer step; input-quant outputs (float32, no output quant) if >= 99%
    are exact and all within 1e-5 of the largest."""
    inp = Inputs("int")
    ok = check_cases((("qstem", stem_cases(inp)), ("qconv3x3", conv_cases(inp)),
                      ("qmatmul", matmul_cases(inp))), int_results, "int_check")
    qi = {}
    ok &= check_cases((("qmatmul", qi_matmul_cases(Inputs())),), qi, "int_check")
    int_results["qmatmul_qi"] = qi["qmatmul"]
    emit({"phase": "int_check", "case": "sums per forward", "ok": ok,
          "resnet18_int8_out_quant": {k: int_results[k] for k in
                                      ("qstem", "qconv3x3", "qmatmul")},
          "resnet18_fp8_quantize_input_qmatmul": qi["qmatmul"]})
    return ok


# ---- the int8 kernels --------------------------------------------------------

def int8_operands(inp, x, w, signed=True, prequant=True, a_bits=8):
    """(args, s8 x, s8 w, zp) of an int8 kernel call: the asymmetric
    ``a_bits`` input grid from x's range, per-channel symmetric 8-bit
    weights (dim 0), a folded BN; x and w on the s8 grid and the zero
    point, for the library call."""
    import torch
    from fp8_quantization_tpu_torch.ops import int8 as i8
    from fp8_quantization_tpu_torch.ops import uniform
    if not signed:
        w = w.abs()
    w2 = w.reshape(w.shape[0], -1)
    delta, sgn = uniform.symmetric_set_quant_range(w2.amin(dim=1), w2.amax(dim=1), 8)
    a_delta, a_zero = uniform.asymmetric_set_quant_range(x.min(), x.max(), a_bits)
    sgn = sgn.to(torch.float32)
    grid = i8.int8_shifted_grid(w, delta.reshape(-1, *[1] * (w.dim() - 1)), sgn, 8)
    w_s8 = grid.to(torch.int8).contiguous()
    n = w.shape[0]
    args = (x.contiguous(), w_s8 if prequant else w.contiguous(), delta.contiguous(),
            torch.stack([torch.zeros_like(sgn), sgn]),
            torch.stack([a_delta, a_zero, torch.zeros_like(a_delta)]),
            inp.uniform(n, 0.5, 1.5), inp.randn(n, scale=0.1))
    dx, zp = i8.act_int_params(a_delta, a_zero, a_bits)
    x_s8 = i8.quantize_act(x, dx, zp, a_bits).to(torch.int8)
    return args, x_s8, w_s8, zp


# (M, K, N, label, baked, signed, input bits) of qmatmul_int8 calls at the
# edges of its tiling that the main path does not reach: M 1, 64 and 1000,
# K 72 and 100 (not a multiple of the 32-wide chunk nor of 16, so the
# weights are staged without cp.async), N 24 and 1000, unsigned and
# in-kernel float32 weights, a 4-bit input grid; M = 64 and 1 split K over
# a cluster (the last chunk ragged)
INT8_MATMUL_EDGES = [(1, 100, 1000, "edge baked", True, True, 8),
                     (BATCH, 72, 24, "edge in-kernel w", False, True, 8),
                     (1000, 100, 24, "edge baked unsigned", True, False, 8),
                     (1000, 72, 1000, "edge in-kernel w unsigned 4-bit x", False, False, 4),
                     (BATCH, 100, 1000, "edge baked 4-bit x", True, True, 4),
                     (1, 72, 24, "edge in-kernel w", False, True, 8)]


def int8_matmul_cases(inp, batch=BATCH, edges=True):
    """(name, args, cfg, ops, bytes, uses, library fn) per qmatmul_int8
    case: the three downsamples and the fc with baked weights, then
    (``edges``) in-kernel and unsigned weights and INT8_MATMUL_EDGES.  The
    library call is torch._int_mm where it takes the shape (M > 16, K and
    N multiples of 8), else none."""
    import torch
    from fp8_quantization_tpu_torch.ops.kernels import qmatmul_int8 as qm
    cases = []
    shapes = [(M, K, N, "baked", True, True, 8) for M, K, N, _ in matmul_shapes(batch)]
    if edges:
        shapes += [(batch, 512, 1000, "in-kernel w", False, True, 8),
                   (batch * 14 * 14, 128, 256, "baked unsigned", True, False, 8)]
        shapes += INT8_MATMUL_EDGES
    for M, K, N, label, prequant, signed, a_bits in shapes:
        x = torch.relu(inp.randn(M, K))          # a block output: relu'd
        args, x_s8, w_s8, _ = int8_operands(inp, x, inp.randn(N, K, scale=0.05),
                                            signed, prequant, a_bits)
        cfg = qm.Int8MatmulConfig(activation=None, act_n_bits=a_bits)
        w_t = w_s8.t()

        def lib(x_s8=x_s8, w_t=w_t):
            return torch._int_mm(x_s8, w_t)
        nbytes = M * K * 4 + N * K * args[1].element_size() + M * N * 4 + 8 * N
        uses = 1 if label == "baked" else 0
        cases.append((f"qmatmul_int8 {M}x{K}x{N} {label}", args, cfg, 2 * M * N * K,
                      nbytes, uses, lib if M > 16 and K % 8 == 0 and N % 8 == 0 else None))
    return cases


def im2col_s8(x_s8, pad_value, stride):
    """(N*Ho*Wo, 9*Cin) s8 matrix of 3x3 SAME windows, padding = pad_value,
    columns (dy*3 + dx)*Cin + ci."""
    import torch
    n, h, w, c = x_s8.shape
    xp = torch.full((n, h + 2, w + 2, c), pad_value, dtype=torch.int8, device=x_s8.device)
    xp[:, 1:h + 1, 1:w + 1] = x_s8
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    taps = [xp[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]
            for dy in range(3) for dx in range(3)]
    return torch.cat(taps, dim=-1).reshape(n * ho * wo, 9 * c).contiguous()


def int8_conv_cases(inp, batch=BATCH, edges=True):
    """qconv3x3_int8 cases: ResNet-18's seven 3x3 shapes with baked
    weights, in-kernel and unsigned weights, and (``edges``) the edges of
    its tiling: odd H at stride 2, the 7x7 map with in-kernel unsigned
    weights, Cin = 16, Cout not a multiple of the tile."""
    import torch
    from fp8_quantization_tpu_torch.ops.kernels import qconv_int8 as qc
    cases = []
    shapes = [(H, cin, cout, s, uses, "baked", True, True)
              for H, cin, cout, s, uses in CONV_SHAPES]
    if edges:
        shapes += [(28, 128, 128, 1, 0, "in-kernel w", False, True),
                   (28, 128, 256, 2, 0, "baked unsigned", True, False),
                   (15, 64, 64, 2, 0, "baked, odd H", True, True),
                   (7, 512, 512, 1, 0, "in-kernel w unsigned", False, False),
                   (15, 16, 32, 1, 0, "in-kernel w, Cin 16", False, True),
                   (9, 16, 80, 2, 0, "baked unsigned, Cin 16", True, False)]
    for H, cin, cout, s, uses, label, prequant, signed in shapes:
        x = torch.relu(inp.randn(batch, H, H, cin))   # every 3x3 input follows a relu
        w4 = inp.randn(cout, cin, 3, 3, scale=0.05)
        args, x_s8, w_s8, zp = int8_operands(inp, x, w4, signed, prequant)
        args = (args[0], qc.weight_matrix(args[1])) + args[2:]
        w_t = qc.weight_matrix(w_s8).t()
        cols = im2col_s8(x_s8, int(zp) - 128, s)
        cfg = qc.Int8ConvConfig(stride=s, activation="relu")
        ho = (H - 1) // s + 1
        ops = 2 * batch * ho * ho * 9 * cin * cout
        nbytes = x.numel() * 4 + cout * 9 * cin * args[1].element_size() \
            + batch * ho * ho * cout * 4 + 8 * cout

        def lib(cols=cols, w_t=w_t):
            return torch._int_mm(cols, w_t)
        cases.append((f"qconv3x3_int8 {H}x{H}x{cin}->{cout} s{s} {label}", args, cfg,
                      ops, nbytes, uses, lib))
    return cases


def int8_check(out, ref):
    """(ok, max_abs_err, exact share): >= 99% exact, all within 2e-5."""
    import torch
    a, b = out.float(), ref.float()
    diff = (a - b).abs()
    exact = float((diff == 0).float().mean())
    ok = (bool(torch.isfinite(a).all()) and bool((diff <= 2e-5 + 2e-5 * b.abs()).all())
          and exact >= 0.99)
    return ok, float(diff.max()), exact


def phase_int8_check(results):
    """The int8 kernels against their plain versions, timed like phase 2."""
    import torch
    table = kernel_table()
    inp = Inputs()
    ok_all = True
    for kname, make in (("qconv3x3_int8", int8_conv_cases),
                        ("qmatmul_int8", int8_matmul_cases)):
        wrapper, plain = table[kname][:2]
        agg = results.setdefault(kname, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                             bound_ms=0.0, library_ms=0.0,
                                             peak=INT8_OPS_PER_S))
        for name, args, cfg, ops, nbytes, uses, lib in make(inp):
            out = wrapper(*args, cfg=cfg)
            torch.cuda.synchronize()
            ref = plain(*args, cfg)
            ok, err, exact = int8_check(out, ref)
            ms = kernel_ms(lambda: wrapper(*args, cfg=cfg))
            cold = {"ms_cold": cold_ms(lambda: wrapper(*args, cfg=cfg))} \
                if kname in COLD_TIMED else {}
            pms = kernel_ms(lambda: plain(*args, cfg), iters=3)
            lms = kernel_ms(lib) if lib is not None else None
            bms = bound_ms(nbytes, ops, INT8_OPS_PER_S)
            emit({"phase": "int8_check", "case": name, "ok": ok, "max_abs_err": err,
                  "exact": exact, "ms": ms, **cold, "plain_ms": pms, "library_ms": lms,
                  "bound_ms": bms,
                  "bound_by": bound_by(nbytes, ops, INT8_OPS_PER_S),
                  "uses_per_forward": uses})
            ok_all &= ok
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
            if uses:
                for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                             ("bound_ms", bms), *cold.items()):
                    if v is not None:
                        agg[k] = agg.get(k, 0.0) + uses * v
                agg["bytes"] = agg.get("bytes", 0) + uses * nbytes
                agg["flops"] = agg.get("flops", 0) + uses * ops
    return ok_all


EVAL_BATCHES = 2
# validate-quantized as a user runs it: the main path's config (bench.py's
# ResNet-18 FP8 row without the TPU deploy flags), synthetic data, random
# torchvision-layout weights from the seed
CLI_ARGS = ["validate-quantized", "--device", "cuda", "--engine", "fused",
            "--architecture", "resnet18_quantized", "--per-channel",
            "--fp8-set-maxval", "--fp8-mantissa-bits", str(MBITS),
            "--weight-quant-method", "current_minmax",
            "--act-quant-method", "allminmax", "--num-est-batches", "1",
            "--max-eval-batches", str(EVAL_BATCHES), "--batch-size", str(BATCH),
            "--seed", str(SEED)]


# launches per ResNet-18 FP8 forward: the stem, the 16 3x3 convs, the three
# 1x1/2 downsamples and the fc
RESNET_FP8_LAUNCHES = {"qstem": 1, "qconv3x3": 16, "qmatmul": 4}


def expected_launches(per_forward, forwards=EVAL_BATCHES + 1, unbaked=None,
                       unbaked_forwards=0):
    """Launch counts of a main-path run for every kernel: ``per_forward``
    times the forwards of the baked model (by default the CLI's prepare
    pass and EVAL_BATCHES evaluation batches), plus ``unbaked`` times the
    fixed-mode forwards before the bake (the format search's), 0 for the
    kernels neither names."""
    from fp8_quantization_tpu_torch.ops import kernels
    unbaked = unbaked or {}
    return {k: per_forward.get(k, 0) * forwards + unbaked.get(k, 0) * unbaked_forwards
            for k in kernels.WRAPPERS}


class Forwards:
    """Counts, while active, the fixed-mode forwards of the models (ResNet,
    MobileNetV2, ViT), baked and not, and the calls of ops/int8.int8_conv
    (``int8_convs``), times calibrate and the format search
    (``seconds``), and keeps the FP8 formats' histogram right after
    calibrate (``voted``), the calibrated state the CLI bakes
    (``calibrated``) and the last model that evaluate took."""

    def __init__(self):
        self.baked = self.unbaked = self.int8_convs = 0
        self.seconds = {}
        self.voted = None
        self.calibrated = None
        self.model = None

    def __enter__(self):
        import copy

        import torch
        from fp8_quantization_tpu_torch.calibration import calibrate, format_search
        from fp8_quantization_tpu_torch.cli import image_net
        from fp8_quantization_tpu_torch.models import mobilenet_v2, resnet, vit
        from fp8_quantization_tpu_torch.nn.layers import QuantizedLayerBase
        from fp8_quantization_tpu_torch.ops import int8 as int8_ops
        self.saved = []

        def patch(mod, attr, make):
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))
            setattr(mod, attr, make(fn))

        def count(fn):
            def forward(model, x, mode="fixed", **kw):
                if mode == "fixed":
                    baked = any(m.w_factor is not None or m.w_int8 is not None
                                for m in model.modules()
                                if isinstance(m, QuantizedLayerBase))
                    if baked:
                        self.baked += 1
                    else:
                        self.unbaked += 1
                return fn(model, x, mode=mode, **kw)
            return forward

        def timed(key):
            def make(fn):
                def run(*a, **kw):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = fn(*a, **kw)
                    torch.cuda.synchronize()
                    self.seconds[key] = self.seconds.get(key, 0.0) + time.perf_counter() - t0
                    if key == "calibrate_s":
                        self.voted = mbits_histogram(a[0])
                    return out
                return run
            return make

        def keep(fn):
            def run(model, *a, **kw):
                self.model = model
                return fn(model, *a, **kw)
            return run

        def conv_calls(fn):
            def run(*a, **kw):
                self.int8_convs += 1
                return fn(*a, **kw)
            return run

        def snapshot(fn):
            def run(model, *a, **kw):
                self.calibrated = copy.deepcopy(model.state_dict())
                return fn(model, *a, **kw)
            return run

        for cls in (resnet.QuantizedResNet, mobilenet_v2.QuantizedMobileNetV2,
                    vit.QuantizedViT):
            patch(cls, "forward", count)
        patch(calibrate, "calibrate", timed("calibrate_s"))
        patch(calibrate, "evaluate", keep)
        patch(format_search, "network_format_search", timed("format_search_s"))
        patch(image_net, "bake_for_eval", snapshot)
        patch(int8_ops, "int8_conv", conv_calls)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)


def mbits_of(model):
    """{path: M} of the model's FP8 quantizers."""
    from fp8_quantization_tpu_torch.nn.quantizers import Quantizer
    return {n: int(float(m.mantissa_bits)) for n, m in model.named_modules()
            if isinstance(m, Quantizer) and m.spec.is_fp8}


def mbits_histogram(model):
    """{M: number of FP8 quantizers of the model with M mantissa bits}."""
    hist = {}
    for k in mbits_of(model).values():
        hist[k] = hist.get(k, 0) + 1
    return dict(sorted(hist.items()))


def run_main_path(cli, per_forward, unbaked=None, info=None):
    """validate-quantized through the CLI's entry point with the launch
    counts zeroed just before and read just after: (metrics, counts, the
    counts ``per_forward`` asks for, ok of the metrics line, the deployed
    model's FP8 formats (mbits_of)).  The baked forwards (the prepare pass
    and the evaluation batches) launch ``per_forward``, fixed-mode forwards
    before the bake (the format search's) ``unbaked``; ``info`` receives
    the forwards, the seconds of calibrate and the format search, the FP8
    formats' histograms after calibrate and as deployed, the calibrated
    state the CLI baked, the calls of ops/int8.int8_conv and qmatmul_int8's
    launches on its s8 input branch."""
    import torch
    from fp8_quantization_tpu_torch.cli import image_net
    from fp8_quantization_tpu_torch.ops import kernels
    from fp8_quantization_tpu_torch.ops.kernels import qmatmul_int8
    kernels.reset_launch_counts()
    with Forwards() as fw:
        metrics = image_net.validate_quantized(image_net.build_parser().parse_args(cli))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    ok = (math.isfinite(metrics["loss"])
          and metrics["num_examples"] == BATCH * EVAL_BATCHES
          and fw.baked == EVAL_BATCHES + 1 and (unbaked or not fw.unbaked))
    if info is not None:
        info.update(forwards={"baked": fw.baked, "unbaked": fw.unbaked},
                    **fw.seconds, mbits_voted=fw.voted,
                    mbits_deployed=mbits_histogram(fw.model), int8_convs=fw.int8_convs,
                    s8_launches=qmatmul_int8.fused_quant_matmul_int8.s8_launches)
        info["calibrated"] = fw.calibrated
    return (metrics, counts, expected_launches(per_forward, fw.baked, unbaked,
                                               fw.unbaked), ok, mbits_of(fw.model))


def engine_pair(cli, calibrated=None):
    """The evaluation batches and the model of ``cli`` under 'fused' and
    'bf16', built from the seed's weights and calibrated (as 'fused', on the
    first batch, and format-searched where ``cli`` asks for it, as the CLI
    deploys it) to one state, not yet baked; with ``calibrated`` (the
    state the CLI's own run baked, Forwards) that state is loaded instead
    of calibrating and searching again."""
    from itertools import islice

    from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
    from fp8_quantization_tpu_torch.cli import image_net
    from fp8_quantization_tpu_torch.data.imagenet import make_dataloaders
    _, val = make_dataloaders(None, batch_size=BATCH, seed=SEED)
    batches = list(islice(iter(val), EVAL_BATCHES))
    args = image_net.build_parser().parse_args(cli)
    fused = image_net.build_model(args)
    if calibrated is not None:
        fused.load_state_dict(calibrated)
    else:
        calibrate(fused, batches[:1], device="cuda", num_batches=1)
        if args.format_search_passes > 0:
            image_net.format_search(fused, batches[:1], args, "cuda")
    bf16 = image_net.build_model(image_net.build_parser().parse_args(
        cli + ["--engine", "bf16"]))
    bf16.load_state_dict(fused.state_dict())
    return batches, fused, bf16


def fused_forward(fused, x, captures, first):
    """One fixed-mode forward of the baked 'fused' model; the first one of
    a run records the depthwise, block and attention kernels' operands
    (Capture) when ``captures`` is given."""
    if not (first and captures is not None):
        return fused(x, mode="fixed", quant_w=False)
    with Capture() as cap:
        a = fused(x, mode="fixed", quant_w=False)
    for k, calls in cap.calls.items():
        captures.setdefault(k, {}).update(calls)
    return a


def logit_step(quantizer, a, b):
    """One grid step of the last layer's output quantizer at the larger of
    |a|, |b|: FP8 with its own M, 2^-M of the magnitude plus maxval *
    2^(1 + g) (maxval * 2^-10 at E3M4), or the integer step of an int_asym
    quantizer."""
    import torch
    if quantizer.spec.is_fp8:
        consts = quantizer.act_consts()[1]
        return (torch.maximum(a.abs(), b.abs()) * 2.0 ** -const_mbits(consts)
                + float(quantizer.maxval) * 2.0 ** (1.0 + float(consts[4, 0])))
    return float(torch.clamp(quantizer.delta, min=1e-8))


# the unprepared copy of each slice's fused model (prepare_models), by the
# slice's label, for the profile phases
UNPREPARED = {}
# the calibrated state of phase 4's fused model before its bake
# (phase_slice, label "slice"), for s2d_check
CALIBRATED = {}


def prepare_models(label, fused, bf16, batches, quant_w=False):
    """The prepare pass (nn/bake.prepare_inference, on the card, as the CLI
    runs it) on both baked models, after an unprepared copy of fused is
    kept (UNPREPARED[label]); then the prepared fused logits are held
    bit-equal to the unprepared ones on the batches: (ok, line fields)."""
    import copy

    import torch
    from fp8_quantization_tpu_torch.nn.bake import prepare_inference
    unprepared = UNPREPARED[label] = copy.deepcopy(fused)
    xs = [torch.as_tensor(x, device="cuda") for x, _ in batches]
    example = torch.zeros((1,) + tuple(xs[0].shape[1:]), device="cuda")
    for model in (fused, bf16):
        prepare_inference(model, example, quant_w=quant_w)
    equal = []
    with torch.no_grad():
        for x in xs:
            equal.append(bool(torch.equal(
                unprepared(x, mode="fixed", quant_w=quant_w),
                fused(x, mode="fixed", quant_w=quant_w))))
    return all(equal), {"prepared_logits_bit_equal": equal}


def phase_slice(results, label="slice", cli=CLI_ARGS,
                per_forward=RESNET_FP8_LAUNCHES, head="fc", min_share=0.0,
                captures=None, plain_reference=False, unbaked=None):
    """A main path through the CLI's entry point (launch counts against
    ``per_forward``), then fused against bf16 on one calibrated, baked
    state, judged on the grid of the ``head`` layer's output quantizer
    (logit_step): top-1 (argmax) equal on >= 99% of images, >= 98% within
    one step; the plain CPU reference of fused (plain_witness) is printed
    beside each image whose top-1 differs.  With
    ``plain_reference`` (--quantize-input, where fused and bf16 differ by
    design, see QI_CLI_ARGS) the judged reference is instead the same fused
    model on the CPU, where every wrapper takes its plain version.  Its
    logits are not quantized and chaotic (a last-bit difference anywhere
    flips input-quantizer bins downstream), so, as vit_slice does, the rms
    gap over the logits' spread (logit_gap) to the plain versions is held
    to at most twice the floor that moving every input value by one
    float32 ulp gives the fused model on the card; the gaps of fused and
    bf16 to the 'parity' engine (the reference's semantics, from the same
    calibrated state, weights quantized on the fly) and parity's own
    one-ulp floor are printed, as is fused against bf16.
    With ``captures`` the first fused forward records the depthwise and
    block kernels' operands (Capture); ``min_share`` bounds the
    input-dependent share of the logits from below; ``unbaked`` gives the
    launches of a fixed-mode forward before the bake (run_main_path).
    Both models are prepared after the bake (prepare_models, whose
    bit-equality check joins ok), so every comparison and every later
    phase on them runs the prepared forward."""
    import copy

    import torch
    from fp8_quantization_tpu_torch.nn.bake import bake_weights

    info = {}
    metrics, counts, want, metrics_ok, deployed = run_main_path(
        cli, per_forward, unbaked, info)
    # the state the CLI calibrated (and format-searched) and then baked
    batches, fused, bf16 = engine_pair(cli, info.pop("calibrated"))
    as_deployed = mbits_of(fused) == deployed
    parity = None
    if plain_reference:        # the reference's semantics, same state
        from fp8_quantization_tpu_torch.cli import image_net
        parity = image_net.build_model(image_net.build_parser().parse_args(
            cli + ["--engine", "parity"]))
        parity.load_state_dict(fused.state_dict())
    if label == "slice":
        CALIBRATED[label] = copy.deepcopy(fused.state_dict())
    bake_weights(fused)
    bake_weights(bf16)
    prep_ok, prep_line = prepare_models(label, fused, bf16, batches)
    plain = copy.deepcopy(fused).cpu() if plain_reference else None
    agree, exact, within, share, classes, gap, finite = [], [], [], [], [], [], True
    flips = []
    runs = {"fused": [], "plain": [], "fused_ulp": [], "bf16": [], "parity": [],
            "parity_ulp": []}
    head_q = getattr(fused, head).act_q
    with torch.no_grad():
        for i, (x, _) in enumerate(batches):
            xt = torch.as_tensor(x, device="cuda")
            a = fused_forward(fused, xt, captures, i == 0)
            b = bf16(xt, mode="fixed", quant_w=False)
            finite &= bool(torch.isfinite(a).all())
            agree.append(float((a.argmax(-1) == b.argmax(-1)).float().mean()))
            step = logit_step(head_q, a, b)
            within.append(float(((a - b).abs() <= step).float().mean()))
            for j in torch.nonzero(a.argmax(-1) != b.argmax(-1)).flatten().tolist():
                ca, cb = int(a[j].argmax()), int(b[j].argmax())
                flips.append({"batch": i, "row": j, "fused_top1": ca, "bf16_top1": cb,
                              "fused_top2": a[j].topk(2).values.tolist(),
                              "bf16_top2": b[j].topk(2).values.tolist(),
                              "fused_at_bf16_top1": float(a[j, cb]),
                              "bf16_at_fused_top1": float(b[j, ca]),
                              "step_at_top": float(torch.as_tensor(step).expand_as(a)[j, ca])})
            exact.append(float((a == b).float().mean()))
            gap.append(logit_gap(a, b))
            share.append(input_share(a))
            classes.append(len(set(a.argmax(-1).tolist())))
            if plain is not None:
                x_ulp = torch.nextafter(xt, torch.full_like(xt, math.inf))
                runs["fused"].append(a)
                runs["bf16"].append(b)
                runs["fused_ulp"].append(fused(x_ulp, mode="fixed", quant_w=False))
                runs["plain"].append(plain(torch.as_tensor(x), mode="fixed",
                                           quant_w=False).to(a.device))
                runs["parity"].append(parity(xt, mode="fixed"))
                runs["parity_ulp"].append(parity(x_ulp, mode="fixed"))
    mean = lambda v: sum(v) / len(v)  # noqa: E731
    if plain is None:
        close = mean(agree) >= 0.99 and mean(within) >= 0.98
    else:
        t = {k: torch.cat(v) for k, v in runs.items()}
        plain_gap = {"fused_vs_plain_cpu": logit_gap(t["fused"], t["plain"]),
                     "fused_one_ulp_floor": logit_gap(t["fused_ulp"], t["fused"])}
        close = plain_gap["fused_vs_plain_cpu"] <= 2 * plain_gap["fused_one_ulp_floor"]
    ok = (counts == want and finite and metrics_ok and close and prep_ok
          and as_deployed and min(share) > min_share)
    line = {"phase": label, "ok": ok, "metrics": metrics, "launches": counts,
            "expected_launches": want, **info, **prep_line,
            "mbits_compared": mbits_histogram(fused), "formats_as_deployed": as_deployed,
            "logits_finite": finite,
            "top1_agree_vs_bf16": mean(agree),
            "logits_within_one_step_vs_bf16": mean(within),
            "logits_exact_vs_bf16": mean(exact), "logit_gap_vs_bf16": gap,
            "top1_flips_vs_bf16": plain_witness(fused, batches, flips[:8]),
            "input_dependent_share": share, "distinct_top1_classes": classes}
    if plain is not None:
        argmax = {k: v.argmax(-1) for k, v in t.items()}
        plain_gap.update({"fused_vs_parity": logit_gap(t["fused"], t["parity"]),
                          "bf16_vs_parity": logit_gap(t["bf16"], t["parity"]),
                          "parity_one_ulp_floor": logit_gap(t["parity_ulp"], t["parity"])})
        line.update({"logit_gaps": plain_gap,
                     "top1_agree_fused_vs_parity": float(
                         (argmax["fused"] == argmax["parity"]).float().mean()),
                     "top1_agree_bf16_vs_parity": float(
                         (argmax["bf16"] == argmax["parity"]).float().mean()),
                     "top1_agree_vs_plain_cpu": float(
                         (argmax["fused"] == argmax["plain"]).float().mean()),
                     "top1_agree_fused_one_ulp": float(
                         (argmax["fused"] == argmax["fused_ulp"]).float().mean())})
    emit(line)
    add_launches(results, counts)
    return ok, fused, bf16


def plain_witness(fused, batches, flips):
    """``flips`` (images whose top-1 differs between fused and bf16), each
    with a second witness: the same prepared fused model on the CPU, where
    every wrapper takes its plain version (its top-1, top-2 and logits at
    the two engines' top-1 classes)."""
    if not flips:
        return flips
    import copy

    import torch
    plain = copy.deepcopy(fused).cpu()
    outs = {}
    with torch.no_grad():
        for i in sorted({f["batch"] for f in flips}):
            outs[i] = plain(torch.as_tensor(batches[i][0]), mode="fixed", quant_w=False)
    for f in flips:
        p = outs[f["batch"]][f["row"]]
        f.update(plain_top1=int(p.argmax()), plain_top2=p.topk(2).values.tolist(),
                 plain_at_fused_top1=float(p[f["fused_top1"]]),
                 plain_at_bf16_top1=float(p[f["bf16_top1"]]))
    return flips


def add_launches(results, counts):
    """Add one main-path run's launch counts to each kernel's total."""
    for k, n in counts.items():
        r = results.setdefault(k, {})
        r["launches"] = r.get("launches", 0) + n


# validate-quantized on the INT8 path: bench.py's ResNet-18 INT8 row without
# the TPU deploy flags (conv_out_bf16, int8_assume_signed)
INT8_CLI_ARGS = ["validate-quantized", "--device", "cuda", "--engine", "fused",
                 "--architecture", "resnet18_quantized",
                 "--qmethod", "symmetric_uniform", "--qmethod-act", "asymmetric_uniform",
                 "--per-channel", "--quantize-input", "--int8-mxu",
                 "--weight-quant-method", "current_minmax",
                 "--act-quant-method", "allminmax", "--num-est-batches", "1",
                 "--max-eval-batches", str(EVAL_BATCHES), "--batch-size", str(BATCH),
                 "--seed", str(SEED)]


def phase_int8_slice(results):
    """The INT8 path through the CLI's entry point, then fused against bf16
    (ops/int8) on the calibrated state the CLI baked, int8-baked."""
    import torch
    from fp8_quantization_tpu_torch.nn.bake import bake_int8_weights

    info = {}
    metrics, counts, want, metrics_ok, _ = run_main_path(
        INT8_CLI_ARGS, {"qconv3x3_int8": 16, "qmatmul_int8": 4}, info=info)
    batches, fused, bf16 = engine_pair(INT8_CLI_ARGS, info["calibrated"])
    bake_int8_weights(fused)
    bake_int8_weights(bf16)
    prep_ok, prep_line = prepare_models("int8_slice", fused, bf16, batches,
                                        quant_w=True)
    agree, within, exact, finite = [], [], [], True
    with torch.no_grad():
        for x, _ in batches:
            xt = torch.as_tensor(x, device="cuda")
            a = fused(xt, mode="fixed", quant_w=True)
            b = bf16(xt, mode="fixed", quant_w=True)
            finite &= bool(torch.isfinite(a).all())
            agree.append(float((a.argmax(-1) == b.argmax(-1)).float().mean()))
            within.append(float(((a - b).abs() <= 1e-3 + 1e-3 * b.abs()).float().mean()))
            exact.append(float((a == b).float().mean()))
    mean = lambda v: sum(v) / len(v)  # noqa: E731
    ok = (counts == want and finite and metrics_ok and prep_ok
          and mean(agree) >= 0.99 and mean(within) >= 0.98)
    emit({"phase": "int8_slice", "ok": ok, "metrics": metrics, "launches": counts,
          "expected_launches": want, **prep_line, "logits_finite": finite,
          "top1_agree_vs_bf16": mean(agree),
          "logits_within_1e-3_vs_bf16": mean(within),
          "logits_exact_vs_bf16": mean(exact)})
    add_launches(results, counts)
    return ok, fused


# BASELINE.json config 2, INT8 PTQ with output quant: per-channel symmetric
# weights, asymmetric per-tensor activations quantized at each layer's
# output (no --quantize-input, no --int8-mxu); the FP8/bf16 kernels'
# integer branches: 1 qstem, 16 qconv3x3 and 4 qmatmul per forward
INT8_OQ_QUANT = ["--qmethod", "symmetric_uniform", "--qmethod-act", "asymmetric_uniform"]
INT8_OQ_CLI_ARGS = ["validate-quantized", "--device", "cuda", "--engine", "fused",
                    "--architecture", "resnet18_quantized", *INT8_OQ_QUANT,
                    "--per-channel", "--weight-quant-method", "current_minmax",
                    "--act-quant-method", "allminmax", "--num-est-batches", "1",
                    "--max-eval-batches", str(EVAL_BATCHES), "--batch-size", str(BATCH),
                    "--seed", str(SEED)]
# the main path's FP8 config with --quantize-input: the downsamples and the
# fc quantize their inputs in qmatmul; the stem and the 3x3 convs take the
# bf16 path, as in JAX (4 qmatmul launches per forward, no qstem/qconv3x3)
QI_CLI_ARGS = CLI_ARGS + ["--quantize-input"]
QI_LAUNCHES = {"qmatmul": 4}
# BASELINE.json config 3 on ResNet-18: the MSE range search for weights and
# activations with the mantissa-bit sweep and vote (each quantizer its own
# M, E6M1 .. E1M6), one pass of the network format search, then the bake
# and the prepared deploy; and the same at E4M3 without the sweep.  Before
# the bake the format search's fixed-mode forwards quantize the weights in
# qmatmul (the downsamples and the fc) and run the stem and the 3x3 convs
# composed: 4 qmatmul launches each (RESNET_FP8_UNBAKED)
MSE_CLI_ARGS = ["validate-quantized", "--device", "cuda", "--engine", "fused",
                "--architecture", "resnet18_quantized", "--per-channel",
                "--fp8-set-maxval", "--weight-quant-method", "MSE",
                "--act-quant-method", "MSE", "--fp8-mse-include-mantissa-bits",
                "--format-search-passes", "1", "--num-est-batches", "1",
                "--max-eval-batches", str(EVAL_BATCHES), "--batch-size", str(BATCH),
                "--seed", str(SEED)]
MSE_E4M3_CLI_ARGS = MSE_CLI_ARGS + ["--fp8-mantissa-bits", "3",
                                    "--no-fp8-mse-include-mantissa-bits"]
RESNET_FP8_UNBAKED = {"qmatmul": 4}
# config 3's E5M2 half: the range search alone at M = 2 (no mantissa sweep),
# then the format search as in mse_slice
MSE_E5M2_CLI_ARGS = MSE_CLI_ARGS + ["--fp8-mantissa-bits", "2",
                                    "--no-fp8-mse-include-mantissa-bits"]
# the main path's FP8 config on ResNet-50 (bench.py's ResNet-50 row without
# its TPU deploy flags), random torchvision-layout bottleneck weights from
# the seed (models/convert.random_resnet_state_dict's bottleneck scales)
R50_CLI_ARGS = [a if a != "resnet18_quantized" else "resnet50_quantized"
                for a in CLI_ARGS]
# launches per ResNet-50 FP8 forward: the stem, the 16 3x3 convs, and on
# qmatmul the 32 block 1x1 convs, the 4 downsamples (layer1_0's at stride 1,
# 64 -> 256) and the fc
RESNET50_FP8_LAUNCHES = {"qstem": 1, "qconv3x3": 16, "qmatmul": 37}
# fused and bf16 under --quantize-input: every layer quantizes its input
# on an E3M4 grid and the logits are not quantized, so a last-bit
# difference anywhere (another summation order) flips bins downstream and
# the logits are chaotic: qi_slice holds fused against its plain versions
# on the CPU, to the one-ulp noise floor of the fused model (phase_slice),
# and prints the gaps of fused and bf16 to 'parity' (the reference), whose
# Factored-input semantics both follow (nn/layers.py)


# ---- MobileNetV2 -----------------------------------------------------------

def mnv2_cli_args(bn_mode, int8=False):
    """validate-quantized on MobileNetV2 FP8 (BASELINE.json config 4 without
    the pretrained checkpoint): the main path's quantizer config, random
    fan-in-scaled tonylins-layout weights from the seed; with ``int8``
    BASELINE config 2's quantizers (INT8_OQ_QUANT) instead."""
    quant = (INT8_OQ_QUANT if int8 else
             ["--fp8-set-maxval", "--fp8-mantissa-bits", str(MBITS)])
    return ["validate-quantized", "--device", "cuda", "--engine", "fused",
            "--architecture", "mobilenet_v2_quantized", "--bn-mode", bn_mode,
            "--per-channel", *quant, "--weight-quant-method", "current_minmax",
            "--act-quant-method", "allminmax", "--num-est-batches", "1",
            "--max-eval-batches", str(EVAL_BATCHES), "--batch-size", str(BATCH),
            "--seed", str(SEED)]


# launches per MobileNetV2 forward: fp32_after runs the 17 blocks as qblock
# and the head and classifier as qmatmul; folded runs them layer by layer
# (16 expand + 17 project + head + classifier on qmatmul, 17 depthwise)
MNV2_LAUNCHES = {"fp32_after": {"qblock": 17, "qmatmul": 2},
                 "folded": {"qdwconv3x3": 17, "qmatmul": 35}}


# the launch counts a wrapper keeps (qmatmul_int8's s8 input branch its own)
COUNTS = ("launches", "s8_launches")


class Capture:
    """Records, while active, the first call of each distinct shape and
    config of every kernel wrapper as the model calls them, with the number of calls (uses): the
    check phases replay them."""

    def __init__(self):
        from fp8_quantization_tpu_torch.ops.kernels import (
            attention, qblock, qconv, qconv_int8, qdwconv, qmatmul, qmatmul_int8,
            qstem)
        self.targets = [(qdwconv, "fused_quant_dwconv3x3", "qdwconv3x3"),
                        (qblock, "fused_inverted_residual", "qblock"),
                        (attention, "flash_mha", "flash_mha"),
                        (qmatmul, "fused_quant_matmul", "qmatmul"),
                        (qconv, "fused_quant_conv3x3", "qconv3x3"),
                        (qstem, "fused_quant_stem", "qstem"),
                        (qconv_int8, "fused_quant_conv3x3_int8", "qconv3x3_int8"),
                        (qmatmul_int8, "fused_quant_matmul_int8", "qmatmul_int8")]
        self.calls = {}            # kernel -> {key: [args, kwargs, uses]}

    def __enter__(self):
        import torch
        self.saved = []
        for mod, attr, kname in self.targets:
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))

            def record(*args, _fn=fn, _k=kname, **kw):
                key = (tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else a
                             for a in args), kw.get("cfg", kw.get("sm_scale")))
                hit = self.calls.setdefault(_k, {}).setdefault(key, [args, kw, 0])
                hit[2] += 1
                return _fn(*args, **kw)
            # the wrapper counts its launches on the name it is bound to
            for count in COUNTS:
                if hasattr(fn, count):
                    setattr(record, count, getattr(fn, count))
            setattr(mod, attr, record)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            for count in COUNTS:
                if hasattr(fn, count):
                    setattr(fn, count, getattr(getattr(mod, attr), count))
            setattr(mod, attr, fn)


def input_share(logits):
    """The share of the logits' spread that depends on the input: their
    standard deviation across the batch (per class) over their standard
    deviation around the global mean.  Near 0 when every image gets the
    same logits."""
    centred = logits - logits.mean(dim=0, keepdim=True)
    return float((centred.pow(2).mean() / (logits - logits.mean()).pow(2).mean()).sqrt())


def mnv2_dw_case(args, kw, uses, label=""):
    """(name, call, plain call, check(out, ref), bytes, op seconds, uses,
    library fn) of one recorded qdwconv3x3 call."""
    import torch
    import torch.nn.functional as F
    from fp8_quantization_tpu_torch.ops.kernels import qdwconv as qd
    x, w, a_c, scale, shift = args
    cfg = kw["cfg"]
    n, h, wd, c = x.shape
    ho, wo = qd.out_hw(h, wd, cfg.stride)
    out_bytes = n * ho * wo * c * (2 if cfg.emit_norm else 4)
    nbytes = x.numel() * 2 + w.numel() * 4 + out_bytes + 2 * c * 4
    op_s = 18 * n * ho * wo * c / FP32_FLOPS_PER_S
    xl = x.permute(0, 3, 1, 2)                       # NCHW view, channels-last
    wl = w.permute(2, 0, 1)[:, None].to(x.dtype).contiguous(
        memory_format=torch.channels_last)
    return (f"qdwconv3x3 {h}x{wd}x{c} s{cfg.stride}{label}",
            lambda: qd.fused_quant_dwconv3x3(*args, **kw),
            lambda: qd.qdwconv3x3_plain(*args, cfg),
            lambda out, ref: grid_check(out, ref, a_c, cfg.emit_norm,
                                        method=cfg.act_method),
            nbytes, op_s, uses,
            lambda: F.conv2d(xl, wl, stride=cfg.stride, padding=1, groups=c))


# (H, C, stride, uses per MobileNetV2 forward) of its depthwise convs
DW_SHAPES = [(112, 32, 1, 1), (112, 96, 2, 1), (56, 144, 1, 1), (56, 144, 2, 1),
             (28, 192, 1, 2), (28, 192, 2, 1), (14, 384, 1, 4), (14, 576, 1, 2),
             (14, 576, 2, 1), (7, 960, 1, 3)]
# (batch, H, C, stride, emit_norm, activation) of qdwconv3x3 calls the main
# path does not make: C % 8 != 0 (12, 20: the one-thread-per-output route),
# odd maps at both strides, 1x1 and 2x2 maps, C = 8 and 24 (groups of one
# 8-channel vector), float32 outputs, relu and no activation, batch 1
DW_EDGES = [(3, 15, 24, 2, True, "relu"), (2, 9, 12, 1, True, None),
            (1, 1, 32, 1, False, "relu6"), (4, 2, 64, 2, True, None),
            (1, 13, 72, 1, False, None), (5, 8, 8, 2, True, "relu6"),
            (2, 30, 40, 2, True, "relu6"), (2, 7, 20, 2, False, "relu")]


def synthetic_dw(inp, n, h, c, stride, emit=True, act="relu6"):
    """(args, kw) of a qdwconv3x3 call on synthetic operands of ``inp``'s
    grid: bf16 input norms, per-channel normalized taps, an output
    quantizer set from the range of the plain output."""
    from fp8_quantization_tpu_torch.ops.kernels import qdwconv as qd
    x = inp.norms(n, h, h, c)
    w = qd.weight_taps(inp.weight_norms(inp.randn(c, 1, 3, 3)))
    scale, shift = inp.uniform(c, 0.5, 1.5), inp.randn(c, scale=0.1)
    if inp.grid == "int":
        scale = scale * 0.02
    y0 = qd.qdwconv3x3_plain(x, w, None, scale, shift, qd.DwConvConfig(stride=stride))
    cfg = qd.DwConvConfig(act_method=inp.act_method, activation=act, emit_norm=emit,
                          stride=stride)
    return (x, w, inp.out_consts(y0), scale, shift), {"cfg": cfg}


def dw_exact(out, ref):
    """Every element of a qdwconv3x3 output equal to its plain version's
    (the same products summed in the same order), counted exactly."""
    return bool((out.float() == ref.float()).all())


def mnv2_block_case(args, kw, uses, label=""):
    """The same for one recorded qblock call."""
    import torch
    import torch.nn.functional as F
    from fp8_quantization_tpu_torch.ops.kernels import qblock as qb
    from fp8_quantization_tpu_torch.ops.kernels.qdwconv import out_hw
    cfg = kw["cfg"]
    x, w1, wd, w2, a_c = args[:5]
    xf = kw.get("x_factor")
    xf = torch.ones((), device=x.device) if xf is None else xf
    n, h, w, cin = x.shape
    hid, cout = w2.shape
    ho, wo = out_hw(h, w, cfg.stride)
    out_bytes = n * ho * wo * cout * (2 if cfg.out_bf16 else 4)
    nbytes = (x.numel() * 2 + (w1.numel() * 2 if w1 is not None else 0)
              + wd.numel() * 4 + w2.numel() * 2 + out_bytes
              + (4 * hid + 2 * cout) * 4)
    mm = 2 * n * ho * wo * hid * cout + (2 * n * h * w * cin * hid if cfg.expand else 0)
    # the tensor cores and the float32 stencil are separate pipes: the
    # slower of the two bounds the operations
    op_s = max(mm / BF16_FLOPS_PER_S, 18 * n * ho * wo * hid / FP32_FLOPS_PER_S)
    # the yardstick: the three stages as three PyTorch calls on bf16
    x2d = x.reshape(-1, cin)
    hl = torch.empty((n, h, w, hid), dtype=torch.bfloat16,
                     device=x.device).normal_().permute(0, 3, 1, 2)
    wdl = wd.permute(2, 0, 1)[:, None].to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    n2 = torch.empty((n * ho * wo, hid), dtype=torch.bfloat16, device=x.device).normal_()

    def lib():
        if cfg.expand:
            torch.matmul(x2d, w1)
        F.conv2d(hl, wdl, stride=cfg.stride, padding=1, groups=hid)
        return torch.matmul(n2, w2)
    tag = "t1" if not cfg.expand else ("res" if cfg.use_res else f"s{cfg.stride}")
    name = f"qblock {h}x{w} {cin}->{hid}->{cout} {tag}{label}"
    return (name, lambda: qb.fused_inverted_residual(*args, **kw),
            lambda: qb.qblock_plain(*args, xf, cfg), block_check(args, kw), nbytes,
            op_s, uses, lib)


def block_check(args, kw):
    """check(out, ref) of a qblock call: grid_check on the block's output
    quantizer, widened in a residual block by one step of the project's
    grid, because the project output is quantized before the add: a bin
    flip there moves the sum by one step of the project's grid (at |sum -
    residual| <= |sum| + |residual|), which can be several steps of the
    block quantizer's grid after cancellation."""
    import torch
    from fp8_quantization_tpu_torch.ops.kernels import qblock as qb
    cfg = kw["cfg"]
    x, a_c = args[0], args[4]
    xf = kw.get("x_factor")
    xf = torch.ones((), device=x.device) if xf is None else xf
    col = cfg.final_row

    def check(out, ref):
        extra = 0.0
        proj = cfg.methods[qb.ROW_PROJECT]
        if cfg.use_res and proj != "none":
            f_out = float(a_c[5, col]) if cfg.emit_norm else 1.0
            y = torch.maximum(out.float().abs(), ref.float().abs()) * f_out
            p = y + (x.float() * xf).abs()
            extra = grid_step(p, p, a_c[:, qb.ROW_PROJECT:qb.ROW_PROJECT + 1],
                              False, proj) / f_out
        return grid_check(out, ref, a_c[:, col:col + 1], cfg.emit_norm, extra,
                          cfg.methods[col])
    return check


def synthetic_block(inp, h, stride, cin, hid, cout, use_res, batch=BATCH):
    """(args, kw) of a qblock call at a shape the main path does not give:
    random bf16 input norms and per-channel normalized weights from
    ``inp`` (FP8 or the integer grids), each stage's fold and output
    quantizer set from the range of that stage's own output in the plain
    arithmetic, so every stage quantizes real values; bf16 normalized
    output."""
    import torch
    from fp8_quantization_tpu_torch.ops.kernels import qblock as qb
    from fp8_quantization_tpu_torch.ops.kernels.common import quantize_prepared
    from fp8_quantization_tpu_torch.ops.kernels.qdwconv import dw_taps_sum
    method = inp.act_method
    cfg = qb.FusedBlockConfig(expand=True, stride=stride, use_res=use_res,
                              emit_norm=True, methods=(method,) * 4)
    x = inp.norms(batch, h, h, cin)
    w1 = inp.weight_norms(inp.randn(hid, cin)).t().contiguous()
    wd = inp.weight_norms(inp.randn(hid, 9)).t().reshape(3, 3, hid).contiguous()
    w2 = inp.weight_norms(inp.randn(cout, hid)).t().contiguous()

    def fold(y, lo, hi):
        y = y.reshape(-1, y.shape[-1])
        return 3.0 / y.std(dim=0).clamp_min(1e-6), inp.uniform(y.shape[-1], lo, hi)

    def norm(y, c):
        return quantize_prepared(y, method, c, normalized=True).to(torch.bfloat16).float()

    y1 = x.float() @ w1
    s1, b1 = fold(y1, -0.5, 1.0)
    h1 = torch.clamp(y1 * s1 + b1, 0.0, 6.0)
    c_exp = inp.out_consts(h1)
    yd = dw_taps_sum(norm(h1, c_exp), wd, stride)
    sd, bd = fold(yd, -0.5, 1.0)
    hd = torch.clamp(yd * sd + bd, 0.0, 6.0)
    c_dw = inp.out_consts(hd)
    y2 = norm(hd, c_dw).reshape(-1, hid) @ w2
    s2, b2 = fold(y2, -0.3, 0.3)
    s2 = s2 / 3.0
    p = (y2 * s2 + b2).reshape(*hd.shape[:3], cout)
    c_proj = inp.out_consts(p)
    xf = None
    c_blk = c_proj
    if use_res:
        xf = (p.std() / x.float().std().clamp_min(1e-6)).reshape(())
        c_blk = inp.out_consts(quantize_prepared(p, method, c_proj) + x.float() * xf)
    a_c = torch.cat([c_exp, c_dw, c_proj, c_blk], dim=1).contiguous()
    args = (x, w1.to(torch.bfloat16), wd, w2.to(torch.bfloat16), a_c, s1, b1, sd, bd,
            s2, b2)
    return args, {"cfg": cfg, "x_factor": xf}


# (H, stride, Cin, hid, Cout, residual) of qblock calls at the edges of its
# tiling: a 15x15 map (whole-image tile, 225 pixels, ragged m16 rows) with
# a residual, and a 14x14 map at stride 2 (a 7x7 output, hid split 4 ways
# with a 16-byte-padded Cin)
BLOCK_EDGES = [(15, 1, 24, 144, 24, True), (14, 2, 24, 144, 24, False)]


def capture_dw_bf16_blocks():
    """The qblock calls of one fused forward of MobileNetV2 under
    --quant-setup dw_bf16_acts (bn mode fp32_after), calibrated on one batch
    and baked: its expand and dw stages do not quantize their outputs."""
    import torch
    from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
    from fp8_quantization_tpu_torch.cli import image_net
    from fp8_quantization_tpu_torch.data.imagenet import make_dataloaders
    from fp8_quantization_tpu_torch.nn.bake import bake_weights

    model = image_net.build_model(image_net.build_parser().parse_args(
        mnv2_cli_args("fp32_after") + ["--quant-setup", "dw_bf16_acts"]))
    _, val = make_dataloaders(None, batch_size=BATCH, seed=SEED)
    batch = next(iter(val))
    calibrate(model, [batch], device="cuda", num_batches=1)
    bake_weights(model)
    with torch.no_grad(), Capture() as cap:
        model(torch.as_tensor(batch[0], device="cuda"), mode="fixed", quant_w=False)
    return cap.calls.get("qblock", {})


def phase_mnv2_check(results, captures, label="mnv2_check", dw_bf16=True, grid="fp8"):
    """Each MobileNetV2 kernel against its plain version on the operands the
    main path gave it (recorded by the slice phases), timed as in phase 2
    (qblock also with the L2 flushed, cold_ms): 17 depthwise calls in 10
    shapes and 17 blocks in 12 configurations, plus (``dw_bf16``) two
    blocks (56x56 residual, 14x14 without residual) as a dw_bf16_acts model
    calls them (expand and dw rows "none"), plus the blocks at the edges of
    qblock's tiling (BLOCK_EDGES) on synthetic operands of ``grid``."""
    from fp8_quantization_tpu_torch.ops.kernels.common import no_tf32
    cases = [("qdwconv3x3", mnv2_dw_case(a, kw, u))
             for a, kw, u in captures.get("qdwconv3x3", {}).values()]
    cases += [("qblock", mnv2_block_case(a, kw, u))
              for a, kw, u in captures.get("qblock", {}).values()]
    n_main = len(cases)
    for a, kw, _ in (capture_dw_bf16_blocks().values() if dw_bf16 else ()):
        cfg = kw["cfg"]
        if (cfg.expand and cfg.stride == 1
                and (a[0].shape[1], cfg.use_res) in ((56, True), (14, False))):
            cases.append(("qblock", mnv2_block_case(
                a, kw, 0, " dw_bf16_acts " + "/".join(cfg.methods))))
    inp = Inputs(grid)
    for edge in BLOCK_EDGES:
        a, kw = synthetic_block(inp, *edge)
        cases.append(("qblock", mnv2_block_case(a, kw, 0, f" edge {grid}")))
    for n, h, c, s, norm, act in DW_EDGES:
        a, kw = synthetic_dw(inp, n, h, c, s, norm, act)
        cases.append(("qdwconv3x3", mnv2_dw_case(
            a, kw, 0, f" edge {grid} batch {n} {'norm' if norm else 'value'} {act}")))
    want_cases = {"qdwconv3x3": 10, "qblock": 12}
    ok_all = (all(len(captures.get(k, {})) == n for k, n in want_cases.items())
              and len(cases) == n_main + 2 * dw_bf16 + len(BLOCK_EDGES) + len(DW_EDGES))
    for kname, (name, call, plain, check, nbytes, op_s, uses, lib) in cases:
        agg = results.setdefault(kname, {})
        for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                  "bytes_s", "ops_s") + (("ms_cold",) if kname in COLD_TIMED else ()):
            agg.setdefault(k, 0.0)
        out = call()
        with no_tf32():
            ref = plain()
        ok, err, exact = check(out, ref)
        if kname == "qdwconv3x3":
            ok = ok and dw_exact(out, ref)           # the same sums, in order
        ms = kernel_ms(call)
        cold = {"ms_cold": cold_ms(call)} if kname in COLD_TIMED else {}
        with no_tf32():
            pms = kernel_ms(plain, iters=2, warmup=1)
        lms = kernel_ms(lib)
        bytes_s = nbytes / HBM_BYTES_PER_S
        bms = 1e3 * max(bytes_s, op_s)
        emit({"phase": label, "case": name, "ok": ok, "max_abs_err": err,
              "exact": exact, "ms": ms, **cold, "plain_ms": pms, "library_ms": lms,
              "bound_ms": bms, "bound_by": "bytes" if bytes_s > op_s else "operations",
              "uses_per_forward": uses})
        ok_all &= ok
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                     ("bound_ms", bms), ("bytes_s", bytes_s), ("ops_s", op_s),
                     *cold.items()):
            agg[k] += uses * v
    return ok_all


# ---- ViT-S/16 -----------------------------------------------------------------

# validate-quantized on ViT-S/16 FP8 (bench.py's ViT row without the TPU
# deploy flags): the main path's quantizer config, random fan-in-scaled
# timm-layout weights from the seed
VIT_CLI_ARGS = ["validate-quantized", "--device", "cuda", "--engine", "fused",
                "--architecture", "vit_small_quantized", "--quant-setup", "all",
                "--per-channel", "--fp8-set-maxval", "--fp8-mantissa-bits", str(MBITS),
                "--weight-quant-method", "current_minmax",
                "--act-quant-method", "allminmax", "--num-est-batches", "1",
                "--max-eval-batches", str(EVAL_BATCHES), "--batch-size", str(BATCH),
                "--seed", str(SEED)]
# launches per ViT-S forward: one attention per block; qkv, proj and mlp2 of
# the 12 blocks and the head on qmatmul (the patch embed and the gelu mlp1
# are composed PyTorch)
VIT_LAUNCHES = {"flash_mha": 12, "qmatmul": 37}


def logit_gap(a, b):
    """rms(a - b) over the spread of b around its per-class means."""
    return float((a - b).pow(2).mean().sqrt() / (b - b.mean(dim=0)).pow(2).mean().sqrt())


def phase_vit_slice(results, captures):
    """The ViT-S main path through the CLI's entry point, then fused against
    bf16 on one calibrated, baked state.  Twelve E3M4 blocks make the logits
    chaotic: moving every input value by one float32 ulp moves them about
    as far as any other last-bit change does.  So fused is held to that
    floor, measured here on the bf16 model: its gap to bf16 (rms over the
    logits' spread) at most twice the floor, with activation
    quantization on (the main path) and off, and its quantization error
    (against the float32 forward, unquantized weights) at most 1.25 times
    bf16's.  The shares of phase 4 are printed beside."""
    import torch
    from fp8_quantization_tpu_torch.nn.bake import bake_weights

    info = {}
    metrics, counts, want, metrics_ok, _ = run_main_path(VIT_CLI_ARGS, VIT_LAUNCHES,
                                                         info=info)
    batches, fused, bf16 = engine_pair(VIT_CLI_ARGS, info["calibrated"])
    xs = [torch.as_tensor(x, device="cuda") for x, _ in batches]
    with torch.no_grad():
        ref32 = torch.cat([bf16(x, mode="fp32") for x in xs])
    bake_weights(fused)
    bake_weights(bf16)
    prep_ok, prep_line = prepare_models("vit_slice", fused, bf16, batches)
    out = {k: [] for k in ("a", "b", "b_ulp", "a_off", "b_off", "b_off_ulp")}
    with torch.no_grad():
        for i, x in enumerate(xs):
            x_ulp = torch.nextafter(x, torch.full_like(x, math.inf))
            out["a"].append(fused_forward(fused, x, captures, i == 0))
            out["b"].append(bf16(x, mode="fixed", quant_w=False))
            out["b_ulp"].append(bf16(x_ulp, mode="fixed", quant_w=False))
            out["a_off"].append(fused(x, mode="fixed", quant_w=False, quant_a=False))
            out["b_off"].append(bf16(x, mode="fixed", quant_w=False, quant_a=False))
            out["b_off_ulp"].append(bf16(x_ulp, mode="fixed", quant_w=False,
                                         quant_a=False))
    t = {k: torch.cat(v) for k, v in out.items()}
    a, b = t["a"], t["b"]
    step = logit_step(fused.head.act_q, a, b)
    gaps = {"quant": logit_gap(a, b), "quant_floor": logit_gap(t["b_ulp"], b),
            "act_quant_off": logit_gap(t["a_off"], t["b_off"]),
            "act_quant_off_floor": logit_gap(t["b_off_ulp"], t["b_off"]),
            "fused_vs_fp32": logit_gap(a, ref32), "bf16_vs_fp32": logit_gap(b, ref32)}
    finite = bool(torch.isfinite(a).all())
    share = [input_share(x) for x in out["a"]]
    ok = (counts == want and finite and metrics_ok and prep_ok and min(share) > 0.01
          and gaps["quant"] <= 2 * gaps["quant_floor"]
          and gaps["act_quant_off"] <= 2 * gaps["act_quant_off_floor"]
          and gaps["fused_vs_fp32"] <= 1.25 * gaps["bf16_vs_fp32"])
    emit({"phase": "vit_slice", "ok": ok, "metrics": metrics, "launches": counts,
          "expected_launches": want, **prep_line, "logits_finite": finite,
          "logit_gaps": gaps,
          "top1_agree_vs_bf16": float((a.argmax(-1) == b.argmax(-1)).float().mean()),
          "top1_agree_bf16_one_ulp": float(
              (t["b_ulp"].argmax(-1) == b.argmax(-1)).float().mean()),
          "logits_within_one_step_vs_bf16": float(((a - b).abs() <= step).float().mean()),
          "logits_exact_vs_bf16": float((a == b).float().mean()),
          "input_dependent_share": share,
          "distinct_top1_classes": [len(set(x.argmax(-1).tolist())) for x in out["a"]]})
    add_launches(results, counts)
    return ok, fused, bf16


def flash_check(out, ref, q, k, v, sm_scale):
    """(ok, max_abs_err, exact share): >= 99% bit-equal, every element within
    2 bf16 ulps at the larger of |out|, |ref| and the attention-weighted
    mean of |v| (float32 softmax of the bf16 operands)."""
    import torch
    a, b = out.float(), ref.float()
    qb, kb, vb = (t.to(torch.bfloat16).float() for t in (q, k, v))
    attn = torch.softmax((qb @ kb.transpose(-1, -2)) * sm_scale, dim=-1)
    mag = torch.maximum(torch.maximum(a.abs(), b.abs()), attn @ vb.abs())
    _, e = torch.frexp(torch.clamp(mag, min=2.0 ** -126))
    ulp = torch.ldexp(torch.ones_like(mag), e - 8)
    diff = (a - b).abs()
    exact = float((diff == 0).float().mean())
    ok = bool(torch.isfinite(a).all()) and bool((diff <= 2 * ulp).all()) and exact >= 0.99
    return ok, float(diff.max()), exact


def flash_synthetic_cases():
    """(name, q, k, v) of the calls the main path does not make: views of a
    (B, S, 3, H, D) float32 tensor as the model passes them, and contiguous
    bf16 operands."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    cases = []
    for s in (50, 128, 129, 256, 385):
        qkv = torch.randn(BATCH, s, 3, 6, 64, generator=g, device="cuda") * 1.5
        cases.append((f"flash_mha ({BATCH},6,{s},64) f32 views",
                      *(qkv[:, :, i].transpose(1, 2) for i in range(3))))
    qkv = torch.randn(3, BATCH, 6, 197, 64, generator=g, device="cuda").to(torch.bfloat16)
    cases.append((f"flash_mha ({BATCH},6,197,64) bf16", *qkv.unbind(0)))
    return cases


def vit_matmul_check(captures):
    """qmatmul against qmatmul_plain on the first fused ViT forward's calls
    (qkv, proj, mlp2: 12 uses each; the head: 1), checked as phase 2 and
    timed as phase 6; one line each and a line with their sums per
    forward.  They are not added to the kernels line's qmatmul row, which
    holds ResNet-18's forward."""
    import torch
    from fp8_quantization_tpu_torch.ops.kernels import qmatmul as qm
    from fp8_quantization_tpu_torch.ops.kernels.common import no_tf32
    recorded = list(captures.get("qmatmul", {}).values())
    ok_all = sorted(u for _, _, u in recorded) == [1, 12, 12, 12]
    total = dict(ms=0.0, ms_cold=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    for args, kw, uses, label in ([(*r, "ViT") for r in recorded]
                                  + vit_matmul_edges(captures)):
        x, w, _, a_c, scale, shift = args
        cfg = kw["cfg"]
        (m, k), n = x.shape, w.shape[0]
        out = qm.fused_quant_matmul(*args, **kw)
        with no_tf32():
            ref = qm.qmatmul_plain(*args, cfg)
        if cfg.quantize_input:
            ok, err, exact = sum_check(out, ref)
        else:
            ok, err, exact = grid_check(out, ref, a_c, cfg.emit_norm)
        ms = kernel_ms(lambda: qm.fused_quant_matmul(*args, **kw))
        cms = cold_ms(lambda: qm.fused_quant_matmul(*args, **kw))
        with no_tf32():
            pms = kernel_ms(lambda: qm.qmatmul_plain(*args, cfg), iters=2, warmup=1)
        xl, wl = x.to(torch.bfloat16), w.to(torch.bfloat16).t()
        lms = kernel_ms(lambda: torch.matmul(xl, wl))
        nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
                  + m * n * (2 if cfg.emit_norm else 4))
        flops = 2 * m * n * k
        bms = bound_ms(nbytes, flops)
        emit({"phase": "vit_check", "case": f"qmatmul {m}x{k}x{n} {label}", "ok": ok,
              "max_abs_err": err, "exact": exact, "ms": ms, "ms_cold": cms,
              "plain_ms": pms, "library_ms": lms, "bound_ms": bms,
              "bound_by": bound_by(nbytes, flops), "uses_per_forward": uses})
        ok_all &= ok
        for key, val in (("ms", ms), ("ms_cold", cms), ("plain_ms", pms),
                         ("library_ms", lms), ("bound_ms", bms)):
            total[key] += uses * val
    emit({"phase": "vit_check", "case": "qmatmul per ViT forward", "ok": ok_all, **total})
    return ok_all


def vit_matmul_edges(captures):
    """(args, kwargs, uses 0, label) of two qmatmul calls at the ViT's M
    (12,608 rows, not a multiple of 128) that its forward does not make: K
    = 72 and N = 16 with the forward's qkv output quantizer, and K = 1000,
    N = 24 on float32 x with FP8 input quant and in-kernel FP8 weights."""
    import torch
    from fp8_quantization_tpu_torch.ops.fp8 import fp8_consts
    from fp8_quantization_tpu_torch.ops.kernels import qmatmul as qm
    (x0, _, _, a_c, _, _), kw, _ = max(captures["qmatmul"].values(),
                                       key=lambda r: r[0][0].shape[0] * r[0][1].shape[0])
    inp = Inputs()
    m = x0.shape[0]
    edges = []
    for k, n, quant_in in ((72, 16, False), (1000, 24, True)):
        scale, shift = inp.uniform(n, 0.005, 0.015), inp.randn(n, scale=0.1)
        if quant_in:
            x = torch.relu(inp.randn(m, k)).contiguous()
            w, w_c, wm = in_kernel_weights(inp, n, k)
            a = fp8_consts(torch.tensor([0.8 * float(x.max())], device="cuda"), MBITS)
            cfg = qm.FusedQuantMatmulConfig(weight_method=wm, act_method="fp8",
                                            quantize_input=True)
            label = "edge float32 x, input quant, in-kernel w"
        else:
            x = inp.norms(m, k)
            w = inp.weight_norms(inp.randn(n, k, scale=0.05)).to(torch.bfloat16)
            w_c, a = None, a_c
            cfg = qm.FusedQuantMatmulConfig(weight_method="none", act_method="fp8",
                                            emit_norm=kw["cfg"].emit_norm)
            label = "edge bf16 x, baked w"
        edges.append(((x, w, w_c, a, scale, shift), {"cfg": cfg}, 0, label))
    return edges


# ---- the int8 datapath beyond ResNet-18, the layer options ---------------

# validate-quantized on the int8 datapath (bench.py's INT8 row's quantizers
# without its TPU deploy flags) for ``arch``
def int8_qi_cli_args(arch):
    return ["validate-quantized", "--device", "cuda", "--engine", "fused",
            "--architecture", arch, "--qmethod", "symmetric_uniform",
            "--qmethod-act", "asymmetric_uniform", "--per-channel",
            "--quantize-input", "--int8-mxu", "--weight-quant-method", "current_minmax",
            "--act-quant-method", "allminmax", "--num-est-batches", "1",
            "--max-eval-batches", str(EVAL_BATCHES), "--batch-size", str(BATCH),
            "--seed", str(SEED)]


VIT_INT8_CLI_ARGS = int8_qi_cli_args("vit_small_quantized")
# launches per ViT-S INT8 forward: qkv, proj and mlp2 of the 12 blocks and
# the head on qmatmul_int8's s8 input branch (every one of them, S8_LAUNCHES;
# mlp1's gelu and its s8 epilogue stay ops/int8), one flash_mha a block on
# the unpadded 197-token stream
VIT_INT8_LAUNCHES = {"flash_mha": 12, "qmatmul_int8": 37}
VIT_INT8_S8_LAUNCHES = 37
MNV2_INT8_QI_CLI_ARGS = int8_qi_cli_args("mobilenet_v2_quantized")
# launches per MobileNetV2 INT8 forward (the CLI's default bn mode,
# fp32_after): 16 expand + 17 project 1x1s, the head and the classifier on
# qmatmul_int8 with float32 input; the stem and the 17 depthwise convs on
# ops/int8.int8_conv (MNV2_INT8_CONVS), no qblock, no qdwconv3x3
MNV2_INT8_QI_LAUNCHES = {"qmatmul_int8": 35}
MNV2_INT8_CONVS = 18


def s8_branch_check(results, recorded, s8_launches):
    """qmatmul_int8's s8 input branch against its plain version at the
    shapes of the first ViT INT8 forward (qkv, proj, mlp2: 12 uses each; the
    head: 1), timed (kernel, plain, torch._int_mm on the s8 operands) and
    bounded (int8 peak); their sums per forward are the kernels line's row
    ``qmatmul_int8_s8``."""
    import torch
    from fp8_quantization_tpu_torch.ops.kernels import qmatmul_int8 as qm
    ok_all = sorted(u for _, _, u in recorded) == [1, 12, 12, 12]
    agg = results.setdefault("qmatmul_int8_s8", dict(
        max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
        bytes=0, flops=0, peak=INT8_OPS_PER_S))
    agg["launches"] = s8_launches
    for args, kw, uses in recorded:
        x, w = args[0], args[1]
        (m, k), n = x.shape, w.shape[0]
        cfg = kw["cfg"]
        out = qm.fused_quant_matmul_int8(*args, **kw)
        torch.cuda.synchronize()
        ref = qm.qmatmul_int8_plain(*args, cfg)
        ok, err, exact = int8_check(out, ref)
        ok &= x.dtype == torch.int8 and w.dtype == torch.int8
        ms = kernel_ms(lambda: qm.fused_quant_matmul_int8(*args, **kw))
        pms = kernel_ms(lambda: qm.qmatmul_int8_plain(*args, cfg), iters=3)
        w_t = w.t()
        lms = kernel_ms(lambda: torch._int_mm(x, w_t))
        nbytes = m * k + n * k + m * n * 4 + 12 * n
        ops = 2 * m * n * k
        bms = bound_ms(nbytes, ops, INT8_OPS_PER_S)
        emit({"phase": "vit_int8_slice", "case": f"qmatmul_int8 s8 {m}x{k}x{n}", "ok": ok,
              "max_abs_err": err, "exact": exact, "ms": ms, "plain_ms": pms,
              "library_ms": lms, "bound_ms": bms,
              "bound_by": bound_by(nbytes, ops, INT8_OPS_PER_S), "uses_per_forward": uses})
        ok_all &= ok
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        for key, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms), ("bound_ms", bms),
                       ("bytes", nbytes), ("flops", ops)):
            agg[key] += uses * v
    return ok_all


def phase_vit_int8_slice(results):
    """ViT-S/16 on the int8 datapath through the CLI's entry point: 37
    qmatmul_int8 launches a forward, every one through the s8 input branch,
    and 12 flash_mha.  Then fused against bf16 on one calibrated, int8-baked
    state: the logits are not quantized and chaotic (each layer quantizes
    its input, and flash's bf16 operands differ from bf16's float32
    attention), so, as vit_slice does, fused's gap to bf16 (rms over the
    logits' spread) is held to at most twice the gap that moving every
    input value by one float32 ulp gives bf16.  The s8 branch against its
    plain version at each of its shapes (s8_branch_check) and the
    attention call against flash_mha_plain.  Returns (ok, fused, bf16)."""
    import torch
    from fp8_quantization_tpu_torch.nn.bake import bake_int8_weights
    from fp8_quantization_tpu_torch.ops.kernels import attention
    info = {}
    metrics, counts, want, metrics_ok, _ = run_main_path(VIT_INT8_CLI_ARGS,
                                                         VIT_INT8_LAUNCHES, info=info)
    s8, s8_want = info["s8_launches"], VIT_INT8_S8_LAUNCHES * info["forwards"]["baked"]
    batches, fused, bf16 = engine_pair(VIT_INT8_CLI_ARGS, info["calibrated"])
    bake_int8_weights(fused)
    bake_int8_weights(bf16)
    prep_ok, prep_line = prepare_models("vit_int8_slice", fused, bf16, batches,
                                        quant_w=True)
    out = {"a": [], "b": [], "b_ulp": []}
    with torch.no_grad():
        for i, (x, _) in enumerate(batches):
            xt = torch.as_tensor(x, device="cuda")
            if i == 0:
                with Capture() as cap:
                    out["a"].append(fused(xt, mode="fixed", quant_w=True))
            else:
                out["a"].append(fused(xt, mode="fixed", quant_w=True))
            out["b"].append(bf16(xt, mode="fixed", quant_w=True))
            x_ulp = torch.nextafter(xt, torch.full_like(xt, math.inf))
            out["b_ulp"].append(bf16(x_ulp, mode="fixed", quant_w=True))
    t = {k: torch.cat(v) for k, v in out.items()}
    a, b = t["a"], t["b"]
    gaps = {"int8": logit_gap(a, b), "int8_floor": logit_gap(t["b_ulp"], b)}
    finite = bool(torch.isfinite(a).all())
    share = [input_share(x) for x in out["a"]]
    branch_ok = s8_branch_check(results, list(cap.calls.get("qmatmul_int8", {}).values()), s8)
    flash = list(cap.calls.get("flash_mha", {}).values())
    flash_ok, flash_err = len(flash) == 1 and flash[0][2] == 12, None
    for args, kw, _ in flash:
        o = attention.flash_mha(*args, **kw)
        r = attention.flash_mha_plain(*args, **kw)
        ok_f, flash_err, _ = flash_check(o, r, *args, kw["sm_scale"])
        flash_ok &= ok_f and args[0].shape[2] == 197
    ok = (counts == want and s8 == s8_want and finite and metrics_ok and prep_ok
          and branch_ok and flash_ok and min(share) > 0.01
          and gaps["int8"] <= 2 * gaps["int8_floor"])
    emit({"phase": "vit_int8_slice", "ok": ok, "metrics": metrics, "launches": counts,
          "expected_launches": want, "s8_launches": s8, "expected_s8_launches": s8_want,
          **prep_line, "logits_finite": finite, "logit_gaps": gaps,
          "top1_agree_vs_bf16": float((a.argmax(-1) == b.argmax(-1)).float().mean()),
          "top1_agree_bf16_one_ulp": float((t["b_ulp"].argmax(-1) == b.argmax(-1))
                                           .float().mean()),
          "flash_max_abs_err": flash_err, "input_dependent_share": share})
    add_launches(results, counts)
    return ok, fused, bf16


def int8_float_calls_check(label, recorded):
    """qmatmul_int8 (float32 x) against its plain version at each call the
    first forward recorded, untimed."""
    import torch
    from fp8_quantization_tpu_torch.ops.kernels import qmatmul_int8 as qm
    ok_all, worst = bool(recorded), 0.0
    for args, kw, _ in recorded:
        out = qm.fused_quant_matmul_int8(*args, **kw)
        torch.cuda.synchronize()
        ok, err, _ = int8_check(out, qm.qmatmul_int8_plain(*args, kw["cfg"]))
        ok_all &= ok and args[0].dtype == torch.float32
        worst = max(worst, err)
    emit({"phase": label, "case": f"qmatmul_int8 at {len(recorded)} shapes", "ok": ok_all,
          "max_abs_err": worst, "uses": sum(u for _, _, u in recorded)})
    return ok_all


def phase_mnv2_int8_qi_slice(results):
    """MobileNetV2 on the int8 datapath (--int8-mxu --quantize-input, the
    CLI's default bn mode) through the CLI's entry point: 35 qmatmul_int8
    launches a forward and the stem and 17 depthwise convs on ops/int8's
    (grouped) int8_conv; then fused against bf16 on one calibrated,
    int8-baked state at phase_int8_slice's bound (top-1 >= 99%, >= 98% of
    the logits within 1e-3 relative), and each distinct qmatmul_int8 call
    of the first forward against its plain version.  Returns (ok, fused,
    bf16)."""
    import torch
    from fp8_quantization_tpu_torch.nn.bake import bake_int8_weights
    info = {}
    metrics, counts, want, metrics_ok, _ = run_main_path(MNV2_INT8_QI_CLI_ARGS,
                                                         MNV2_INT8_QI_LAUNCHES, info=info)
    s8, convs, baked = info["s8_launches"], info["int8_convs"], info["forwards"]["baked"]
    batches, fused, bf16 = engine_pair(MNV2_INT8_QI_CLI_ARGS, info["calibrated"])
    bake_int8_weights(fused)
    bake_int8_weights(bf16)
    prep_ok, prep_line = prepare_models("mnv2_int8_qi_slice", fused, bf16, batches,
                                        quant_w=True)
    agree, within, exact, finite = [], [], [], True
    with torch.no_grad():
        for i, (x, _) in enumerate(batches):
            xt = torch.as_tensor(x, device="cuda")
            if i == 0:
                with Capture() as cap:
                    a = fused(xt, mode="fixed", quant_w=True)
            else:
                a = fused(xt, mode="fixed", quant_w=True)
            b = bf16(xt, mode="fixed", quant_w=True)
            finite &= bool(torch.isfinite(a).all())
            agree.append(float((a.argmax(-1) == b.argmax(-1)).float().mean()))
            within.append(float(((a - b).abs() <= 1e-3 + 1e-3 * b.abs()).float().mean()))
            exact.append(float((a == b).float().mean()))
    calls_ok = int8_float_calls_check("mnv2_int8_qi_slice",
                                      list(cap.calls.get("qmatmul_int8", {}).values()))
    mean = lambda v: sum(v) / len(v)  # noqa: E731
    ok = (counts == want and s8 == 0 and convs == MNV2_INT8_CONVS * baked and finite
          and metrics_ok and prep_ok and calls_ok and mean(agree) >= 0.99
          and mean(within) >= 0.98)
    emit({"phase": "mnv2_int8_qi_slice", "ok": ok, "metrics": metrics, "launches": counts,
          "expected_launches": want, "int8_conv_calls": convs,
          "expected_int8_conv_calls": MNV2_INT8_CONVS * baked, **prep_line,
          "logits_finite": finite, "top1_agree_vs_bf16": mean(agree),
          "logits_within_1e-3_vs_bf16": mean(within), "logits_exact_vs_bf16": mean(exact)})
    add_launches(results, counts)
    return ok, fused, bf16


LAYER_OPTION_BATCH = 4


def card_vs_cpu(model, x, quant_w=False, capture=None, **kw):
    """(card output, CPU output) of one fixed-mode forward of ``model`` (on
    the CPU, calibrated and baked) and of its copy on the card; the card's
    forward alone inside ``capture`` (a Capture) where one is given."""
    import contextlib
    import copy

    import torch
    card = copy.deepcopy(model).cuda()
    with torch.no_grad():
        ref = model(x, mode="fixed", quant_w=quant_w, **kw)
        with capture or contextlib.nullcontext():
            out = card(x.cuda(), mode="fixed", quant_w=quant_w, **kw)
    torch.cuda.synchronize()
    return card, out.cpu(), ref


def step_check(out, ref, quantizer):
    """(ok, share equal, max |diff|): every element within one grid step of
    ``quantizer``'s output (logit_step), >= 98% of them equal."""
    import torch
    step = logit_step(quantizer, out, ref)
    diff = (out - ref).abs()
    equal = float((diff == 0).float().mean())
    ok = bool(torch.isfinite(out).all()) and bool((diff <= step).all()) and equal >= 0.98
    return ok, equal, float(diff.max())


# launches of one MobileNetV2 forward on 'fused' at width_mult 1.4: qblock
# for the three blocks whose widths are multiples of 8 (224 -> 1344 -> 224
# twice, 224 -> 1344 -> 448), the 14 others layer by layer (their
# depthwise convs on qdwconv3x3, their 27 1x1s on qmatmul, with the head
# and the classifier 29); under LSQ_paper every 1x1 and the classifier on
# qmatmul with the input quantized in the kernel, nothing else
LAYER_OPTION_LAUNCHES = {"width_mult 1.4": {"qblock": 3, "qdwconv3x3": 14, "qmatmul": 29},
                         "LSQ_paper": {"qmatmul": 35}}


def phase_layer_options_check(results):
    """One forward each on the card against its CPU copy (where every
    wrapper takes its plain version), FP8 on 'fused' at small batch:
    QuantConv1d, QuantConvTranspose and a grouped conv (the composed path
    there; within one grid step of their output quantizer, >= 98% equal),
    MobileNetV2 at width_mult 1.4 and MobileNetV2 LSQ_paper at full width,
    with every kernel's launches counted (LAYER_OPTION_LAUNCHES).  Each
    distinct kernel call of the MobileNetV2 forwards (Capture) is held
    against its plain version on the same card tensors by its kernel's
    check (deploy_replay: qmatmul with input quant summed as vit_check
    does, qblock by block_check, qdwconv3x3 on its grid).  The end-to-end
    gap to the CPU copy is printed, not held: every composed layer (the
    stem, the depthwise convs off the kernels) sums in another order than
    cuDNN, and 17 blocks of E3M4 quantizers carry the flips to the
    logits."""
    import torch
    from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
    from fp8_quantization_tpu_torch.models import convert
    from fp8_quantization_tpu_torch.models.mobilenet_v2 import mobilenetv2_quantized
    from fp8_quantization_tpu_torch.nn import layers
    from fp8_quantization_tpu_torch.nn.bake import bake_weights
    from fp8_quantization_tpu_torch.nn.config import make_layer_config
    from fp8_quantization_tpu_torch.ops import kernels
    cfg = make_layer_config(engine="fused", per_channel_weights=True, fp8_mantissa_bits=MBITS,
                            fp8_set_maxval=True, weight_range_method="current_minmax",
                            act_range_method="allminmax")
    g = torch.Generator().manual_seed(SEED)
    ok_all = True
    torch.manual_seed(SEED)
    cases = [("QuantConv1d k5 s2 bn relu", layers.QuantConv1d(
                 64, 128, 5, 2, (2, 2), bn=True, activation="relu", config=cfg),
              (LAYER_OPTION_BATCH, 3001, 64)),
             ("QuantConvTranspose k4 s2 SAME", layers.QuantConvTranspose(
                 64, 32, (4, 4), (2, 2), config=cfg), (LAYER_OPTION_BATCH, 57, 57, 64)),
             ("QuantConv groups 4 bn relu", layers.QuantConv(
                 128, 256, 3, 1, 1, bn=True, activation="relu", groups=4, config=cfg),
              (LAYER_OPTION_BATCH, 56, 56, 128))]
    for name, layer, shape in cases:
        x = torch.randn(*shape, generator=g)
        calibrate(layer, [x], device="cpu")
        bake_weights(layer)
        _, out, ref = card_vs_cpu(layer, x)
        ok, equal, err = step_check(out, ref, layer.act_q)
        emit({"phase": "layer_options_check", "case": name, "ok": ok, "equal": equal,
              "max_abs_err": err})
        ok_all &= ok
    x = torch.randn(LAYER_OPTION_BATCH, 224, 224, 3, generator=g)
    for name, setup, width in (("width_mult 1.4", None, 1.4), ("LSQ_paper", "LSQ_paper", 1.0)):
        model = mobilenetv2_quantized(cfg, setup, device="cpu", width_mult=width)
        convert.load_tonylins_mobilenet_v2(model, convert.random_mobilenet_v2_state_dict(
            SEED, width_mult=width))
        calibrate(model, [x], device="cpu")
        bake_weights(model)
        kernels.reset_launch_counts()
        cap = Capture()
        card, out, ref = card_vs_cpu(model, x, capture=cap)
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        replay_ok, calls = deploy_replay(results, cap.calls, LAYER_OPTION_BATCH)
        xc = x.cuda()
        with torch.no_grad():
            ulp = card(torch.nextafter(xc, torch.full_like(xc, math.inf)), mode="fixed",
                       quant_w=False).cpu()
        qi = [kw["cfg"].quantize_input for args, kw, _ in cap.calls.get("qmatmul", {}).values()]
        ok = (replay_ok and bool(torch.isfinite(out).all())
              and launches == LAYER_OPTION_LAUNCHES[name]
              and bool(qi) and qi == [setup is not None] * len(qi))
        emit({"phase": "layer_options_check", "case": f"MobileNetV2 {name}", "ok": ok,
              "launches": launches, "expected_launches": LAYER_OPTION_LAUNCHES[name],
              "calls": calls, "top1_agree_vs_plain_cpu": float(
                  (out.argmax(-1) == ref.argmax(-1)).float().mean()),
              "logit_gaps": {"card_vs_plain_cpu": logit_gap(out, ref),
                             "card_one_ulp_floor": logit_gap(ulp, out)},
              "equal": float((out == ref).float().mean())})
        ok_all &= ok
    return ok_all


def phase_batch256():
    """The redesigned kernels on ResNet-18's path at its shapes at batch
    256: qmatmul at the three downsamples and the fc (FP8, baked weights),
    qconv3x3_int8 at the seven 3x3 shapes (baked weights), qconv3x3 at the
    seven 3x3 shapes (FP8, then int_asym output quant), qmatmul_int8 at
    the downsamples and the fc (baked weights) and qstem (FP8, then
    int_asym), each held against its plain version as in phases 2, 3 and
    10 and timed warm and with the L2 cache flushed (cold_ms), with sums
    per batch-256 forward."""
    from fp8_quantization_tpu_torch.ops.kernels.common import no_tf32
    table = kernel_table()
    ok_all = True
    for kname, label, cases, peak in (
            ("qmatmul", "qmatmul", matmul_cases(Inputs(), 256, edges=False),
             BF16_FLOPS_PER_S),
            ("qconv3x3_int8", "qconv3x3_int8", int8_conv_cases(Inputs(), 256, edges=False),
             INT8_OPS_PER_S),
            ("qconv3x3", "qconv3x3", conv_cases(Inputs(), 256, edges=False),
             BF16_FLOPS_PER_S),
            ("qconv3x3", "qconv3x3 int_asym", conv_cases(Inputs("int"), 256, edges=False),
             BF16_FLOPS_PER_S),
            ("qmatmul_int8", "qmatmul_int8", int8_matmul_cases(Inputs(), 256, edges=False),
             INT8_OPS_PER_S),
            ("qstem", "qstem", stem_cases(Inputs(), 256, edges=False), BF16_FLOPS_PER_S),
            ("qstem", "qstem int_asym", stem_cases(Inputs("int"), 256, edges=False),
             BF16_FLOPS_PER_S)):
        wrapper, plain = table[kname][:2]
        total = dict(ms=0.0, ms_cold=0.0, library_ms=0.0, bound_ms=0.0)
        for name, args, cfg, flops, nbytes, uses, lib in cases:
            out = wrapper(*args, cfg=cfg)
            with no_tf32():
                ref = plain(*args, cfg)
            if kname in ("qmatmul", "qconv3x3", "qstem"):
                ok, err, exact = grid_check(out, ref, args[3 if kname == "qmatmul" else 2],
                                            cfg.emit_norm, method=cfg.act_method)
            else:
                ok, err, exact = int8_check(out, ref)
            del out, ref
            ms = kernel_ms(lambda: wrapper(*args, cfg=cfg))
            cms = cold_ms(lambda: wrapper(*args, cfg=cfg))
            lms = kernel_ms(lib)
            bms = bound_ms(nbytes, flops, peak)
            emit({"phase": "batch256", "case": name, "ok": ok, "max_abs_err": err,
                  "exact": exact, "ms": ms, "ms_cold": cms, "library_ms": lms,
                  "bound_ms": bms, "bound_by": bound_by(nbytes, flops, peak),
                  "uses_per_forward": uses})
            ok_all &= ok
            for key, val in (("ms", ms), ("ms_cold", cms), ("library_ms", lms),
                             ("bound_ms", bms)):
                total[key] += uses * val
        emit({"phase": "batch256", "case": f"{label} per ResNet-18 forward at batch 256",
              "ok": ok_all, **total})
    return ok_all


def phase_batch256_block_attn(captures):
    """The redesigned flash_mha, qblock and qdwconv3x3 at batch 256:
    flash_mha on (256, 6, 197, 64) float32 views of a qkv tensor (checked
    as in vit_check, 12 uses per ViT forward), qblock on the MobileNetV2
    FP8 fp32_after forward's recorded calls with x repeated to N = 256
    (checked as in mnv2_check), qdwconv3x3 at MobileNetV2's ten depthwise
    shapes on synthetic FP8, then integer-grid operands (relu6, bf16 norms
    out; 100% exact); each timed warm and with the L2 cache flushed, with
    sums per batch-256 forward."""
    import torch
    import torch.nn.functional as F
    from fp8_quantization_tpu_torch.ops.kernels import attention
    from fp8_quantization_tpu_torch.ops.kernels.common import no_tf32
    n = 256
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    qkv = torch.randn(n, 197, 3, 6, 64, generator=g, device="cuda") * 1.5
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    scale = 0.125
    out = attention.flash_mha(q, k, v, sm_scale=scale)
    with no_tf32():
        ref = attention.flash_mha_plain(q, k, v, sm_scale=scale)
        ok_all, err, exact = flash_check(out, ref, q, k, v, scale)
    del out, ref
    ms = kernel_ms(lambda: attention.flash_mha(q, k, v, sm_scale=scale))
    cms = cold_ms(lambda: attention.flash_mha(q, k, v, sm_scale=scale))
    ql, kl, vl = (t.to(torch.bfloat16).contiguous() for t in (q, k, v))
    lms = kernel_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl))
    nbytes, flops = 3 * q.numel() * 4 + q.numel() * 4, 4 * n * 6 * 197 * 197 * 64
    uses = VIT_LAUNCHES["flash_mha"]
    emit({"phase": "batch256_block_attn", "case": f"flash_mha ({n},6,197,64) f32 views",
          "ok": ok_all, "max_abs_err": err, "exact": exact, "ms": ms, "ms_cold": cms,
          "library_ms": lms, "bound_ms": bound_ms(nbytes, flops),
          "bound_by": bound_by(nbytes, flops), "uses_per_forward": uses,
          "per_vit_forward": {"ms": uses * ms, "ms_cold": uses * cms,
                              "library_ms": uses * lms,
                              "bound_ms": uses * bound_ms(nbytes, flops)}})
    del qkv, q, k, v, ql, kl, vl
    recorded = list(captures.get("qblock", {}).values())
    ok_all &= len(recorded) == 12
    total = dict(ms=0.0, ms_cold=0.0, library_ms=0.0, bound_ms=0.0)
    for a, kw, uses in recorded:
        args = (a[0].repeat(n // a[0].shape[0], 1, 1, 1), *a[1:])
        name, call, plain, check, nbytes, op_s, uses, lib = mnv2_block_case(args, kw, uses)
        out = call()
        with no_tf32():
            ref = plain()
        ok, err, exact = check(out, ref)
        del out, ref
        ms, cms, lms = kernel_ms(call), cold_ms(call), kernel_ms(lib)
        bms = 1e3 * max(nbytes / HBM_BYTES_PER_S, op_s)
        emit({"phase": "batch256_block_attn", "case": name, "ok": ok, "max_abs_err": err,
              "exact": exact, "ms": ms, "ms_cold": cms, "library_ms": lms,
              "bound_ms": bms, "uses_per_forward": uses})
        ok_all &= ok
        for key, val in (("ms", ms), ("ms_cold", cms), ("library_ms", lms),
                         ("bound_ms", bms)):
            total[key] += uses * val
    emit({"phase": "batch256_block_attn", "case": f"qblock per MobileNetV2 forward at batch {n}",
          "ok": ok_all, **total})
    for grid in ("fp8", "int"):
        inp = Inputs(grid)
        total = dict(ms=0.0, ms_cold=0.0, library_ms=0.0, bound_ms=0.0)
        for h, c, s, uses in DW_SHAPES:
            a, kw = synthetic_dw(inp, n, h, c, s)
            name, call, plain, _, nbytes, op_s, uses, lib = mnv2_dw_case(a, kw, uses, f" {grid}")
            out = call()
            ref = plain()
            ok = dw_exact(out, ref)
            err = float((out.float() - ref.float()).abs().max())
            del out, ref
            ms, cms, lms = kernel_ms(call), cold_ms(call), kernel_ms(lib)
            bms = 1e3 * max(nbytes / HBM_BYTES_PER_S, op_s)
            emit({"phase": "batch256_block_attn", "case": name, "ok": ok, "max_abs_err": err,
                  "ms": ms, "ms_cold": cms, "library_ms": lms, "bound_ms": bms,
                  "uses_per_forward": uses})
            ok_all &= ok
            for key, val in (("ms", ms), ("ms_cold", cms), ("library_ms", lms),
                             ("bound_ms", bms)):
                total[key] += uses * val
            del a, kw
        emit({"phase": "batch256_block_attn",
              "case": f"qdwconv3x3 {grid} per MobileNetV2 forward at batch {n}",
              "ok": ok_all, **total})
    return ok_all


def phase_vit_check(results, captures):
    """flash_mha against flash_mha_plain on the first fused forward's
    attention call (12 uses) and the synthetic calls, timed as phase 6;
    then the forward's qmatmul calls (vit_matmul_check)."""
    import torch
    import torch.nn.functional as F
    from fp8_quantization_tpu_torch.ops.kernels import attention
    from fp8_quantization_tpu_torch.ops.kernels.common import no_tf32
    recorded = list(captures.get("flash_mha", {}).values())
    cases = [("flash_mha (%d,%d,%d,%d) recorded" % tuple(a[0].shape), *a, uses)
             for a, _, uses in recorded]
    cases += [(*c, 0) for c in flash_synthetic_cases()]
    ok_all = len(recorded) == 1 and recorded[0][2] == VIT_LAUNCHES["flash_mha"]
    agg = results.setdefault("flash_mha", {})
    for k in ("max_abs_err", "ms", "ms_cold", "plain_ms", "library_ms", "bound_ms",
              "bytes", "flops"):
        agg.setdefault(k, 0.0)
    for name, q, k, v, uses in cases:
        b, h, s, d = q.shape
        scale = 1.0 / float(d) ** 0.5
        out = attention.flash_mha(q, k, v, sm_scale=scale)
        with no_tf32():
            ref = attention.flash_mha_plain(q, k, v, sm_scale=scale)
            ok, err, exact = flash_check(out, ref, q, k, v, scale)
        ms = kernel_ms(lambda: attention.flash_mha(q, k, v, sm_scale=scale))
        cms = cold_ms(lambda: attention.flash_mha(q, k, v, sm_scale=scale))
        with no_tf32():
            pms = kernel_ms(lambda: attention.flash_mha_plain(q, k, v, sm_scale=scale),
                          iters=2, warmup=1)
        ql, kl, vl = (t.to(torch.bfloat16).contiguous() for t in (q, k, v))
        lms = kernel_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl))
        nbytes = 3 * q.numel() * q.element_size() + q.numel() * 4
        flops = 4 * b * h * s * s * d
        bms = bound_ms(nbytes, flops)
        emit({"phase": "vit_check", "case": name, "ok": ok, "max_abs_err": err,
              "exact": exact, "ms": ms, "ms_cold": cms, "plain_ms": pms,
              "library_ms": lms, "bound_ms": bms, "bound_by": bound_by(nbytes, flops),
              "uses_per_forward": uses})
        ok_all &= ok
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        for key, val in (("ms", ms), ("ms_cold", cms), ("plain_ms", pms), ("library_ms", lms),
                         ("bound_ms", bms), ("bytes", nbytes), ("flops", flops)):
            agg[key] += uses * val
    return vit_matmul_check(captures) and ok_all


def phase_int8_throughput(fused):
    """Forward ms of the INT8 'fused' model at batch 64 and 256 (quant_w=True,
    int8-baked weights); images/s from the median of four runs."""
    import statistics

    import torch
    rows = {}
    with torch.no_grad():
        for batch in (BATCH, 256):
            x = torch.randn(batch, 224, 224, 3, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(1))
            ms = [time_ms(lambda: fused(x, mode="fixed", quant_w=True),
                          iters=THROUGHPUT_ITERS) for _ in range(2 * THROUGHPUT_TURNS)]
            med = statistics.median(ms)
            rows[f"int8_fused_b{batch}"] = {"ms": ms, "median_ms": med,
                                            "images_per_s": batch / med * 1e3}
    emit({"phase": "int8_throughput", "ok": True, **rows})


def phase_throughput(fused, bf16, label="throughput", batches=(BATCH, 256),
                     quant_w=False):
    """Forward ms of both engines, in turns (fused, bf16, bf16, fused, ...)
    so that a drift of the host or the card falls on both; images/s from
    the median of the turns.  ``quant_w``: True for int8-baked models."""
    import statistics

    import torch
    rows = {}
    with torch.no_grad():
        for batch in batches:
            x = torch.randn(batch, 224, 224, 3, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(1))
            turns = {"fused": [], "bf16": []}
            for order in ("fused", "bf16") * THROUGHPUT_TURNS:
                models = (("fused", fused), ("bf16", bf16))
                for name, model in (models if order == "fused" else models[::-1]):
                    turns[name].append(time_ms(
                        lambda: model(x, mode="fixed", quant_w=quant_w),
                        iters=THROUGHPUT_ITERS))
            for name, ms in turns.items():
                med = statistics.median(ms)
                rows[f"{name}_b{batch}"] = {"ms": ms, "median_ms": med,
                                            "images_per_s": batch / med * 1e3}
    emit({"phase": label, "ok": True, **rows})


def profile_forwards(model, x, quant_w, n=3):
    """torch.profiler over ``n`` forwards after a warm one: ([(kernel name,
    device ms per forward, launches per forward)], wall ms per forward)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        model(x, mode="fixed", quant_w=quant_w)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                model(x, mode="fixed", quant_w=quant_w)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.key, us / 1e3 / n, e.count / n))
    return rows, wall_ms


def phase_profile(fused, label="profile", quant_w=False,
                  kernel_names=("qstem", "qconv3x3", "qmatmul"), unprepared=None):
    """The prepared forward under torch.profiler: device time by kernel,
    launches per forward, idle share; with ``unprepared`` (the same model
    before the prepare pass) its launches, wall ms and idle share beside."""
    import torch
    x = torch.randn(BATCH, 224, 224, 3, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    rows, wall_ms = profile_forwards(fused, x, quant_w)
    if not rows:
        emit({"phase": label, "ok": True, "device_time": "not measured",
              "wall_ms_per_forward": wall_ms})
        return True
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    ours = {k: sum(r[1] for r in rows if k + "_kernel" in r[0]) for k in kernel_names}
    line = {"phase": label, "ok": True, "wall_ms_per_forward": wall_ms,
            "device_busy_ms_per_forward": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "launches_per_forward": sum(r[2] for r in rows),
            "port_kernels_ms": ours,
            "other_ms": busy - sum(ours.values()),
            "top": [{"name": r[0][:80], "ms": r[1], "calls": r[2]} for r in rows[:12]]}
    if unprepared is not None:
        urows, uwall = profile_forwards(unprepared, x, quant_w)
        ubusy = sum(r[1] for r in urows)
        line["unprepared"] = {"launches_per_forward": sum(r[2] for r in urows),
                              "wall_ms_per_forward": uwall,
                              "device_busy_ms_per_forward": ubusy,
                              "idle_share": max(0.0, 1.0 - ubusy / uwall)}
    emit(line)
    return True


def phase_mnv2_int8_check(int_results, int_captures):
    """mnv2_check on the MobileNetV2 INT8 slices' calls, then their sums
    per forward (qblock: fp32_after; qdwconv3x3: folded)."""
    ok = phase_mnv2_check(int_results, int_captures, "mnv2_int8_check", dw_bf16=False,
                          grid="int")
    emit({"phase": "mnv2_int8_check", "case": "sums per forward", "ok": ok,
          **{k: int_results.get(k) for k in ("qblock", "qdwconv3x3")}})
    return ok


def int_phases(results, slice_out):
    """Phase 10: the integer branches of the FP8/bf16 kernels and input
    quantization in qmatmul (int_check), BASELINE config 2 on ResNet-18
    (int8oq_slice, a throughput turn and a profile), ResNet-18 FP8
    --quantize-input (qi_slice), MobileNetV2 under config 2's quantizers in
    both bn modes (each with a throughput turn and a profile), and its
    depthwise and block calls (mnv2_int8_check).
    Their launches join the kernels line; their times print per forward."""
    int_results, int_captures = {}, {}

    def int8oq_slice():
        ok, slice_out["int8oq"], slice_out["int8oq_bf16"] = phase_slice(
            results, "int8oq_slice", INT8_OQ_CLI_ARGS, RESNET_FP8_LAUNCHES, "fc", 0.01)
        return ok

    def mnv2_int8_slice(bn_mode):
        key = "int8_" + bn_mode
        ok, slice_out[key], slice_out[key + "_bf16"] = phase_slice(
            results, f"mnv2_{key}_slice", mnv2_cli_args(bn_mode, int8=True),
            MNV2_LAUNCHES[bn_mode], "classifier", 0.01, int_captures)
        return ok

    mnv2 = []
    for bn_mode, kernel_names in (("fp32_after", ("qblock", "qmatmul")),
                                  ("folded", ("qdwconv3x3", "qmatmul"))):
        key = "int8_" + bn_mode
        mnv2 += [
            (f"mnv2_{key}_slice", lambda m=bn_mode: mnv2_int8_slice(m)),
            (f"mnv2_{key}_throughput", lambda k=key: phase_throughput(
                slice_out[k], slice_out[k + "_bf16"], f"mnv2_{k}_throughput",
                (BATCH,)) or True),
            (f"mnv2_{key}_profile", lambda k=key, n=kernel_names: phase_profile(
                slice_out[k], f"mnv2_{k}_profile", kernel_names=n,
                unprepared=UNPREPARED.get(f"mnv2_{k}_slice")))]

    return [
        ("int_check", lambda: phase_int_check(int_results)),
        ("int8oq_slice", int8oq_slice),
        ("int8oq_throughput", lambda: phase_throughput(
            slice_out["int8oq"], slice_out["int8oq_bf16"], "int8oq_throughput",
            (BATCH,)) or True),
        ("int8oq_profile", lambda: phase_profile(
            slice_out["int8oq"], "int8oq_profile",
            unprepared=UNPREPARED.get("int8oq_slice"))),
        ("qi_slice", lambda: phase_slice(results, "qi_slice", QI_CLI_ARGS, QI_LAUNCHES,
                                         "fc", 0.01, plain_reference=True)[0]),
        *mnv2,
        ("mnv2_int8_check", lambda: phase_mnv2_int8_check(int_results, int_captures))]


# ---- ResNet-50 and the s2d stem -------------------------------------------------

def recorded_case(kname, args, kw):
    """(name, call, plain call, consts, bytes, operations, library fn) of
    one recorded qmatmul or qconv3x3 call."""
    import torch
    import torch.nn.functional as F
    from fp8_quantization_tpu_torch.ops.kernels import qconv as qc
    from fp8_quantization_tpu_torch.ops.kernels import qmatmul as qm
    cfg = kw["cfg"]
    out_size = 2 if cfg.emit_norm else 4
    if kname == "qmatmul":
        x, w, _, a_c = args[:4]
        (m, k), n = x.shape, w.shape[0]
        nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
                  + m * n * out_size)
        xl, wl = x.to(torch.bfloat16), w.to(torch.bfloat16).t()
        return (f"qmatmul {m}x{k}x{n} {cfg.activation}",
                lambda: qm.fused_quant_matmul(*args, **kw),
                lambda: qm.qmatmul_plain(*args, cfg), a_c, nbytes, 2 * m * n * k,
                lambda: torch.matmul(xl, wl))
    x, w, a_c = args[:3]
    residual = args[5] if len(args) > 5 else None
    nb, h, wd, cin = x.shape
    cout = w.shape[0]
    ho, wo = qc.out_hw(h, wd, cfg.stride)
    nbytes = x.numel() * 2 + w.numel() * 2 + nb * ho * wo * cout * out_size
    xl = x.permute(0, 3, 1, 2)                          # NCHW view, channels-last
    wl = w.reshape(cout, 3, 3, cin).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    return (f"qconv3x3 {h}x{wd}x{cin}->{cout} s{cfg.stride}",
            lambda: qc.fused_quant_conv3x3(*args, **kw),
            lambda: qc.qconv3x3_plain(*args[:5], residual, cfg),
            a_c, nbytes, 2 * nb * ho * wo * 9 * cin * cout,
            lambda: F.conv2d(xl, wl, stride=cfg.stride, padding=1))


def phase_r50_check(captures):
    """qmatmul and qconv3x3 against their plain versions on the first fused
    ResNet-50 forward's distinct calls (recorded by r50_slice: 37 qmatmul
    calls, among them M = 200,704 at K = 64 and K = 2,048 at M = 3,136; 16
    qconv3x3 calls in 7 shapes, three of them stride 2 with Cin = Cout),
    held as phase 2 and timed as phase 6, warm and with the L2 flushed
    (cold_ms); one line each and a line with each kernel's sums per
    ResNet-50 forward.  They are not added to the kernels line's rows,
    which hold ResNet-18's forward."""
    from fp8_quantization_tpu_torch.ops.kernels.common import no_tf32
    ok_all = True
    for kname, n_uses in (("qmatmul", RESNET50_FP8_LAUNCHES["qmatmul"]),
                          ("qconv3x3", RESNET50_FP8_LAUNCHES["qconv3x3"])):
        recorded = list(captures.get(kname, {}).values())
        ok_k = sum(u for _, _, u in recorded) == n_uses
        total = dict(ms=0.0, ms_cold=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        for args, kw, uses in recorded:
            name, call, plain, consts, nbytes, flops, lib = recorded_case(kname, args, kw)
            out = call()
            with no_tf32():
                ref = plain()
            ok, err, exact = grid_check(out, ref, consts, kw["cfg"].emit_norm,
                                        method=kw["cfg"].act_method)
            del out, ref
            ms, cms, lms = kernel_ms(call), cold_ms(call), kernel_ms(lib)
            with no_tf32():
                pms = kernel_ms(plain, iters=2, warmup=1)
            bms = bound_ms(nbytes, flops)
            emit({"phase": "r50_check", "case": name, "ok": ok, "max_abs_err": err,
                  "exact": exact, "ms": ms, "ms_cold": cms, "plain_ms": pms,
                  "library_ms": lms, "bound_ms": bms, "bound_by": bound_by(nbytes, flops),
                  "uses_per_forward": uses})
            ok_k &= ok
            for key, val in (("ms", ms), ("ms_cold", cms), ("plain_ms", pms),
                             ("library_ms", lms), ("bound_ms", bms)):
                total[key] += uses * val
        emit({"phase": "r50_check", "case": f"{kname} per ResNet-50 forward",
              "ok": ok_k, "distinct_calls": len(recorded), **total})
        ok_all &= ok_k
    return ok_all


def phase_s2d_check(slice_out):
    """ResNet-18 FP8 with the space-to-depth stem (stem_s2d=True, and
    'input' fed space_to_depth(x)), each built from phase 4's calibrated
    state (CALIBRATED["slice"]), baked and prepared (on an example of the
    geometry it takes, QuantizedResNet.input_shape): prepared logits bit-equal to
    unprepared; held against phase 4's prepared default-stem fused model on
    its batches at phase 4's measures (top-1 on >= 99% of images, >= 98% of
    logits within one step of the fc's output quantizer); per forward 0
    qstem (the s2d stem rides the general conv path, as in JAX), 16
    qconv3x3 and 4 qmatmul launches (not added to the kernels line).  Then
    images/s of the 'input' model (its images s2d'd before the timed
    forwards) beside the default stem, in turns; a record, not a claim."""
    import copy
    import statistics
    from itertools import islice

    import torch
    from fp8_quantization_tpu_torch.data.imagenet import make_dataloaders
    from fp8_quantization_tpu_torch.models.resnet import resnet18_quantized
    from fp8_quantization_tpu_torch.nn.bake import (
        bake_weights, prepare_inference)
    from fp8_quantization_tpu_torch.ops import kernels
    from fp8_quantization_tpu_torch.ops.s2d import space_to_depth
    default = slice_out["fused"]
    _, val = make_dataloaders(None, batch_size=BATCH, seed=SEED)
    xs = [torch.as_tensor(x, device="cuda") for x, _ in islice(iter(val), EVAL_BATCHES)]
    with torch.no_grad():
        refs = [default(x, mode="fixed", quant_w=False) for x in xs]
    ok_all, models = True, {}
    for mode in (True, "input"):
        feed = space_to_depth if mode == "input" else (lambda x: x)
        model = resnet18_quantized(default.config, device="cuda", stem_s2d=mode).eval()
        model.load_state_dict(CALIBRATED["slice"])
        bake_weights(model)
        unprepared = copy.deepcopy(model)
        example = torch.zeros(model.input_shape((1, 224, 224, 3)), device="cuda")
        prepare_inference(model, example, quant_w=False)
        kernels.reset_launch_counts()
        with torch.no_grad():
            outs = [model(feed(x), mode="fixed", quant_w=False) for x in xs]
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = expected_launches({"qconv3x3": 16, "qmatmul": 4}, len(xs))
        with torch.no_grad():
            equal = [bool(torch.equal(unprepared(feed(x), mode="fixed", quant_w=False), a))
                     for x, a in zip(xs, outs)]
        agree, within, exact = [], [], []
        for a, b in zip(outs, refs):
            step = logit_step(default.fc.act_q, a, b)
            agree.append(float((a.argmax(-1) == b.argmax(-1)).float().mean()))
            within.append(float(((a - b).abs() <= step).float().mean()))
            exact.append(float((a == b).float().mean()))
        finite = all(bool(torch.isfinite(a).all()) for a in outs)
        ok = (counts == want and finite and all(equal) and min(agree) >= 0.99
              and min(within) >= 0.98)
        emit({"phase": "s2d_check", "case": f"stem_s2d={mode}", "ok": ok,
              "launches": counts, "expected_launches": want,
              "prepared_logits_bit_equal": equal, "logits_finite": finite,
              "top1_agree_vs_default_stem": agree,
              "logits_within_one_step_vs_default_stem": within,
              "logits_exact_vs_default_stem": exact})
        ok_all &= ok
        models[mode] = model
        del unprepared
    x = torch.randn(BATCH, 224, 224, 3, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    runs = (("default_stem", default, x), ("s2d_input", models["input"], space_to_depth(x)))
    turns = {name: [] for name, _, _ in runs}
    with torch.no_grad():
        for order in range(2 * THROUGHPUT_TURNS):
            for name, model, xin in (runs if order % 2 == 0 else runs[::-1]):
                turns[name].append(time_ms(lambda: model(xin, mode="fixed", quant_w=False),
                                           iters=THROUGHPUT_ITERS))
    rows = {}
    for name, ms in turns.items():
        med = statistics.median(ms)
        rows[f"{name}_b{BATCH}"] = {"ms": ms, "median_ms": med,
                                    "images_per_s": BATCH / med * 1e3}
    emit({"phase": "s2d_check", "case": "throughput", "ok": ok_all, **rows})
    return ok_all


# ---- QAT (BASELINE config 5) and the analytical study (config 1) ------------

QAT_STEPS = 8                      # training batches of qat_slice
QAT_LR = "0.001"
# train-quantized as a user runs it: MobileNetV2 FP8 with the main path's
# quantizers and learned maxvals, SGD with Adam on the ranges, oscillation
# dampening and freezing, BN re-estimation, deployed on the fused engine
QAT_CLI_ARGS = ["train-quantized", "--device", "cuda", "--engine", "fused",
                "--architecture", "mobilenet_v2_quantized", "--bn-mode", "fp32_after",
                "--per-channel", "--fp8-set-maxval", "--fp8-mantissa-bits", str(MBITS),
                "--fp8-learn-maxval", "--weight-quant-method", "current_minmax",
                "--act-quant-method", "allminmax", "--num-est-batches", "1",
                "--max-epochs", "1", "--max-train-batches", str(QAT_STEPS),
                "--optimizer", "SGD", "--learning-rate", QAT_LR, "--momentum", "0.9",
                "--sep-quant-optimizer", "--quant-optimizer", "Adam",
                "--quant-learning-rate", "1e-5",
                "--oscillations-dampen-weight", "0.01",
                "--oscillations-freeze-threshold", "0.02",
                "--reestimate-bn-stats", "--reestimate-bn-batches", "2",
                "--max-eval-batches", str(EVAL_BATCHES), "--batch-size", str(BATCH),
                "--seed", str(SEED)]


class TrainRecorder:
    """Records, while active, each QAT step's loss, metrics and seconds
    (host clock, card synchronised), the learned ranges right after
    init_qat_state (the calibrated values) with the train state, and the
    trained state that train-quantized deploys (before its bake)."""

    def __init__(self):
        self.steps, self.state, self.calibrated, self.trained = [], None, None, None

    def __enter__(self):
        import torch
        from fp8_quantization_tpu_torch.cli import image_net
        from fp8_quantization_tpu_torch.training import qat
        self.saved = []

        def patch(mod, attr, make):
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))
            setattr(mod, attr, make(fn))

        def init(fn):
            def run(*a, **kw):
                state = self.state = fn(*a, **kw)
                self.calibrated = {n: p.detach().clone() for n, p in
                                   state.model.named_parameters() if n.endswith("maxval")}
                torch.cuda.reset_peak_memory_stats()
                return state
            return run

        def make_step(fn):
            def make(*a, **kw):
                step = fn(*a, **kw)

                def timed(state, x, y):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = step(state, x, y)
                    torch.cuda.synchronize()
                    self.steps.append({"s": time.perf_counter() - t0, **out[1]})
                    return out
                return timed
            return make

        def deploy(fn):
            def run(model, *a, **kw):
                if self.trained is None:
                    self.peak_bytes = torch.cuda.max_memory_allocated()
                self.trained = {k: v.detach().clone() for k, v in model.state_dict().items()}
                return fn(model, *a, **kw)
            return run

        patch(qat, "init_qat_state", init)
        patch(qat, "make_train_step", make_step)
        patch(image_net, "deploy_and_evaluate", deploy)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)


def phase_qat_slice(results):
    """BASELINE config 5 through train-quantized (QAT_CLI_ARGS): the launch
    counts zeroed just before and read just after (training and the BN
    re-estimation run the composed bf16 route; the deployed forwards, the
    prepare pass and the evaluation batches, exactly 17 qblock and 2
    qmatmul each); every step's loss finite; some learned maxval moved off
    its calibrated value; then on the one trained state, baked and
    prepared, fused (the CLI's deployed model) against bf16 at the
    MobileNetV2 slice's measures.  Prints ms per step, images/s and the
    peak memory of training."""
    import statistics

    import torch
    from fp8_quantization_tpu_torch.cli import image_net
    from fp8_quantization_tpu_torch.data.imagenet import make_dataloaders
    from fp8_quantization_tpu_torch.nn.bake import bake_weights, prepare_inference
    from fp8_quantization_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    with Forwards() as fw, TrainRecorder() as rec:
        metrics = image_net.train_quantized(image_net.build_parser().parse_args(QAT_CLI_ARGS))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = expected_launches(MNV2_LAUNCHES["fp32_after"], fw.baked, {}, fw.unbaked)
    losses = [s["loss"] for s in rec.steps]
    moved = {n: float((p.detach() - rec.calibrated[n]).abs().max())
             for n, p in rec.state.model.named_parameters() if n in rec.calibrated}
    fused = fw.model
    bf16 = image_net.build_model(image_net.build_parser().parse_args(
        QAT_CLI_ARGS + ["--engine", "bf16"]))
    bf16.load_state_dict(rec.trained)
    bake_weights(bf16)
    prepare_inference(bf16, torch.zeros((1, 224, 224, 3), device="cuda"), quant_w=False)
    from itertools import islice
    _, val = make_dataloaders(None, batch_size=BATCH, seed=SEED)
    agree, within, share, finite = [], [], [], True
    with torch.no_grad():
        for x, _ in islice(iter(val), EVAL_BATCHES):
            xt = torch.as_tensor(x, device="cuda")
            a = fused(xt, mode="fixed", quant_w=False)
            b = bf16(xt, mode="fixed", quant_w=False)
            finite &= bool(torch.isfinite(a).all())
            agree.append(float((a.argmax(-1) == b.argmax(-1)).float().mean()))
            step = logit_step(fused.classifier.act_q, a, b)
            within.append(float(((a - b).abs() <= step).float().mean()))
            share.append(input_share(a))
    mean = lambda v: sum(v) / len(v)  # noqa: E731
    step_ms = [s["s"] * 1e3 for s in rec.steps]
    med = statistics.median(step_ms[1:] or step_ms)
    x0, y0 = next(iter(make_dataloaders(None, batch_size=BATCH, seed=SEED)[0]))
    prof = profile_train_step(rec.state, x0, y0)
    ok = (counts == want and fw.baked == EVAL_BATCHES + 1 and len(losses) == QAT_STEPS
          and all(math.isfinite(v) for v in losses) and math.isfinite(metrics["loss"])
          and max(moved.values(), default=0.0) > 0 and finite
          and mean(agree) >= 0.99 and mean(within) >= 0.98 and min(share) > 0.01)
    emit({"phase": "qat_slice", "ok": ok, "metrics": metrics, "launches": counts,
          "expected_launches": want,
          "forwards": {"baked": fw.baked, "unbaked": fw.unbaked},
          "train_losses": losses,
          "frozen_fraction": [s.get("frozen_fraction") for s in rec.steps],
          "learned_maxvals": len(moved),
          "maxvals_moved": sum(v > 0 for v in moved.values()),
          "max_maxval_move": max(moved.values(), default=0.0),
          "step_ms": step_ms, "median_step_ms_after_first": med,
          "train_images_per_s": BATCH / med * 1e3,
          "train_peak_memory_bytes": rec.peak_bytes, "train_step_profile": prof,
          "top1_agree_vs_bf16": mean(agree), "logits_within_one_step_vs_bf16": mean(within),
          "input_dependent_share": share, "logits_finite": finite})
    add_launches(results, counts)
    return ok


def profile_train_step(state, x, y):
    """One more QAT step (after a warm one) under torch.profiler: device
    busy ms, kernel launches, the idle share of the wall time and the five
    kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fp8_quantization_tpu_torch.training import qat
    step = qat.make_train_step(state)
    step(state, x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, (getattr(e, "self_device_time_total", 0) or 0) / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy == 0:
        return {"device_busy_ms": "not measured", "wall_ms": wall_ms}
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
            "kernel_launches": sum(r[2] for r in rows), "top_kernels": rows[:5]}


def _one_step(model, x, y, lr):
    """One learn step (SGD, Adam on the ranges) from ``model``'s state:
    (loss, {name: update})."""
    from fp8_quantization_tpu_torch.training import qat
    state = qat.init_qat_state(model, model.config,
                               qat.make_optimizer("SGD", lr, momentum=0.9),
                               qat.make_optimizer("Adam", 1e-5))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, m = qat.make_train_step(state)(state, x, y)
    return m["loss"], {n: p.detach() - before[n] for n, p in model.named_parameters()}


def _cosine(u, v):
    return float((u * v).sum() / (u.norm() * v.norm() + 1e-30))


def _layer_inputs(model, x):
    """{layer path: its input} of every quantized layer in one learn-mode
    forward with batch statistics."""
    import torch
    from fp8_quantization_tpu_torch.nn.layers import QuantizedLayerBase
    seen, hooks = {}, []
    for name, mod in model.named_modules():
        if isinstance(mod, QuantizedLayerBase):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, a, n=name: seen.setdefault(n, a[0].detach().clone())))
    try:
        with torch.no_grad():
            model(x, mode="learn", train_bn=True)
    finally:
        for h in hooks:
            h.remove()
    return seen


def _layer_grads(layer, x, seed):
    """{name: gradient} of one layer's learn-mode forward with batch
    statistics on ``x`` against a fixed random cotangent."""
    import torch
    x = x.clone().requires_grad_()
    y = layer(x, mode="learn", train_bn=True)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(seed)).to(y.device)
    (y * g).sum().backward()
    grads = {n: p.grad for n, p in layer.named_parameters() if p.grad is not None}
    grads["input"] = x.grad
    return grads


def phase_qat_check():
    """QAT's step on the card against the CPU, from one calibrated state of
    full-width MobileNetV2 (QAT_CLI_ARGS' config: the bf16 route in learn
    mode), batch 8, TF32 off and cuDNN deterministic.

    Layer by layer, on the inputs the CPU's learn-mode forward gives each
    quantized layer and one fixed random cotangent: every gradient (input,
    weight, BN, learned maxvals) at cosine >= 0.99 with the CPU's (an ulp of
    summation order flips a single element's bin; directions are compared,
    not bits).  End to end the forward is chaotic: cuDNN's fp32 sums differ
    from the CPU's in the last bit, one stem output in about 10^6 crosses a
    quantizer's bin (PR 12's first card run), and 52 quantized layers carry
    it to the logits.  So, as vit_slice does, the learn-mode logits' gap to
    the CPU (rms over their spread) is held to at most twice the gap that
    moving every input by one float32 ulp gives on the CPU; the loss's
    relative gap after one step and the updates' cosines against the CPU
    are printed beside the same numbers for the ulp-moved CPU run.  Then the
    loss on one repeated batch must fall over 8 steps on the card (SGD, lr
    0.05, momentum 0.9)."""
    import copy
    import statistics

    import torch
    from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
    from fp8_quantization_tpu_torch.cli import image_net
    from fp8_quantization_tpu_torch.data.imagenet import make_dataloaders
    from fp8_quantization_tpu_torch.training import qat

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        train, _ = make_dataloaders(None, batch_size=8, seed=SEED)
        x, y = next(iter(train))
        xt = torch.as_tensor(x)
        x_ulp = torch.nextafter(xt, torch.full_like(xt, math.inf))
        i = QAT_CLI_ARGS.index("cuda")
        cpu = image_net.build_model(image_net.build_parser().parse_args(
            QAT_CLI_ARGS[:i] + ["cpu"] + QAT_CLI_ARGS[i + 1:]))
        calibrate(cpu, [(x, y)], device="cpu", num_batches=1)
        for path, names in qat.quant_trainable_mask(cpu, cpu.config).items():
            cpu.get_submodule(path).make_range_trainable(names)
        card, cpu_ulp = copy.deepcopy(cpu).cuda(), copy.deepcopy(cpu)

        # layer by layer, inputs pinned
        inputs = _layer_inputs(copy.deepcopy(cpu), xt)
        layer_cos, low = {}, []
        for k, (name, inp) in enumerate(inputs.items()):
            layer = cpu.get_submodule(name)
            ref = _layer_grads(copy.deepcopy(layer), inp, k)
            got = _layer_grads(copy.deepcopy(layer).cuda(), inp.cuda(), k)
            for n, g in ref.items():
                if float(g.norm()) == 0.0:
                    continue
                c = layer_cos[f"{name}:{n}"] = _cosine(g, got[n].cpu())
                if c < 0.99:
                    low.append((f"{name}:{n}", c))

        # end to end: the chaotic forward against its one-ulp floor
        with torch.no_grad():
            logits = {"cpu": cpu(xt, mode="learn", train_bn=True),
                      "cpu_ulp": cpu_ulp(x_ulp, mode="learn", train_bn=True),
                      "card": card(xt.cuda(), mode="learn", train_bn=True).cpu()}
        gap = logit_gap(logits["card"], logits["cpu"])
        floor = logit_gap(logits["cpu_ulp"], logits["cpu"])
        losses, updates = {}, {}
        for tag, model, xi in (("cpu", cpu, xt), ("cpu_ulp", cpu_ulp, x_ulp),
                               ("card", card, xt.cuda())):
            losses[tag], updates[tag] = _one_step(model, xi, y, 0.001)
        step_cos = {tag: [_cosine(u, updates[tag][n].cpu())
                          for n, u in updates["cpu"].items() if float(u.norm()) > 0]
                    for tag in ("card", "cpu_ulp")}

        state = qat.init_qat_state(card, card.config,
                                   qat.make_optimizer("SGD", 0.05, momentum=0.9),
                                   qat.make_optimizer("Adam", 1e-5))
        step = qat.make_train_step(state)
        repeated = []
        for _ in range(8):
            state, m = step(state, x, y)
            repeated.append(m["loss"])
    finally:
        torch.backends.cudnn.deterministic = prev
    ok = (not low and gap <= 2 * floor and repeated[-1] < repeated[0]
          and all(math.isfinite(v) for v in repeated))
    emit({"phase": "qat_check", "ok": ok, "layers": len(inputs),
          "layer_gradients_compared": len(layer_cos),
          "min_layer_gradient_cosine": min(layer_cos.values()), "below_0.99": low,
          "logit_gap_card_vs_cpu": gap, "logit_gap_one_ulp_floor": floor,
          "loss": losses, "loss_rel_gap_card": abs(losses["card"] - losses["cpu"]) / losses["cpu"],
          "loss_rel_gap_one_ulp": abs(losses["cpu_ulp"] - losses["cpu"]) / losses["cpu"],
          "update_cosine_median": {k: statistics.median(v) for k, v in step_cos.items()},
          "update_cosine_min": {k: min(v) for k, v in step_cos.items()},
          "repeated_batch_losses": repeated})
    return ok


SQNR_REF = dict(n_samples=5_000_000, seed=10, num_candidates=1000)


class StudyWarnings(logging.Handler):
    """Collects the analytic-against-empirical warnings of the study, each
    with the (distribution, exp_bits, "quant" | "dot") it was raised in."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.where, self.records = None, []

    def emit(self, record):
        self.records.append((*self.where, record.getMessage()))


def run_study(device, handler, **kw):
    """analytical.study.run_full_study on ``device`` with ``handler``
    attributing each warning: (results, printed lines, seconds)."""
    from fp8_quantization_tpu_torch.analytical import quant_error, study
    lines, saved = [], (quant_error.compute_expected_quant_mse,
                        quant_error.compute_expected_dot_prod_mse)
    rows = [(d.describe(), e) for d in study.default_distributions()
            for e in (5, 4, 3, 2, 0)]
    calls = iter(rows)

    def quant_mse(*a, **k):
        handler.where = (*next(calls), "quant")
        return saved[0](*a, **k)

    def dot_mse(*a, **k):
        handler.where = (*handler.where[:2], "dot")
        return saved[1](*a, **k)

    quant_error.log.addHandler(handler)
    quant_error.compute_expected_quant_mse, quant_error.compute_expected_dot_prod_mse = (
        quant_mse, dot_mse)
    try:
        if device == "cuda":
            import torch
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = study.run_full_study(printer=lines.append, device=device, **kw)
        seconds = time.perf_counter() - t0
    finally:
        quant_error.compute_expected_quant_mse, quant_error.compute_expected_dot_prod_mse = saved
        quant_error.log.removeHandler(handler)
    return res, lines, seconds


def phase_sqnr_study():
    """BASELINE config 1 at the reference size (SQNR_REF) on the card: the
    15-row table and its seconds.  Checks, from what the JAX reference
    shows at this size (cli/compute_quant_error.py --cpu): the Gaussian's
    SQNR rises from E5M2 to E2M5; the analytic-against-empirical
    cross-check stays quiet on every quantization MSE and on the uniform's
    and the Gaussian's dot products (Student's t's dot products, whose
    Monte-Carlo estimate of x^2 y^2 has heavy tails, warn in the reference
    too, at E2M5 and INT8: those warnings are printed, not failed); heavier
    tails favour exponent bits: INT8 ranks above E3M4 on the Gaussian and
    below it on Student's t.  Then at 200,000 samples and 120 candidates
    the card's picked ranges equal the CPU run's within one candidate step
    and its MSEs agree to 1e-4 relative."""
    handler = StudyWarnings()
    res, lines, seconds = run_study("cuda", handler, **SQNR_REF)
    sqnr = {(r.distribution.split()[0], r.exp_bits): float(r.quant_sqnr_db) for r in res}
    gauss = [sqnr[("Gaussian", e)] for e in (5, 4, 3, 2)]
    rises = all(a < b for a, b in zip(gauss, gauss[1:]))
    unexpected = [w for w in handler.records
                  if not (w[0].startswith("Student") and w[2] == "dot")]
    tails = (sqnr[("Gaussian", 0)] > sqnr[("Gaussian", 3)]
             and sqnr[("Student's-t", 0)] < sqnr[("Student's-t", 3)])
    import numpy as np
    from fp8_quantization_tpu_torch.analytical.study import default_distributions
    small = dict(n_samples=200_000, seed=10, num_candidates=120)
    card, _, card_s = run_study("cuda", StudyWarnings(), **small)
    cpu, _, cpu_s = run_study("cpu", StudyWarnings(), **small)
    # the line search's candidate step: (absmax + 0.5) * 10 / candidates
    steps = {}
    for d in default_distributions():
        sample = d.sample((small["n_samples"],), np.random.RandomState(10))
        steps[d.describe()] = ((float(np.abs(sample.astype(np.float32)).max()) + 0.5)
                               * 10.0 / small["num_candidates"])
    gaps = []
    for a, b in zip(card, cpu):
        step = steps[b.distribution]
        gaps.append({"row": (b.distribution.split()[0], b.exp_bits),
                     "range_gap_in_steps": abs(a.range_max - b.range_max) / step,
                     "mse_rel": abs(a.quant_mse - b.quant_mse) / b.quant_mse,
                     "dot_mse_rel": abs(a.dot_prod_mse - b.dot_prod_mse) / b.dot_prod_mse})
    agree = all(g["range_gap_in_steps"] <= 1.0 and g["mse_rel"] <= 1e-4
                and g["dot_mse_rel"] <= 1e-4 for g in gaps)
    ok = rises and not unexpected and tails and agree
    emit({"phase": "sqnr_study", "ok": ok, "seconds": seconds, "table": lines,
          "warnings": handler.records, "gaussian_rises": rises,
          "tails_favour_exponent_bits": tails,
          "best_format": {d: max((e for (dd, e) in sqnr if dd == d),
                                 key=lambda e, d=d: sqnr[(d, e)])
                          for d in {k[0] for k in sqnr}},
          "small_card_s": card_s, "small_cpu_s": cpu_s,
          "card_vs_cpu": gaps, "card_vs_cpu_ok": agree})
    print("\n".join(lines), flush=True)
    return ok


# bench.py's five rows (bench.py:198-266): the configurations the JAX
# package deploys, with its flags; per row the architecture, bench.py's
# batch, the base config, the row's flags, the flags of its cast-only twin
# (bit-equal to the exact config), quant_setup, stem_s2d and the launches
# of one 'fused' forward
DEPLOY_FP8 = dict(qmethod="fp_quantizer", per_channel_weights=True,
                  fp8_mantissa_bits=4, fp8_set_maxval=True,
                  weight_range_method="current_minmax",
                  act_range_method="allminmax")
DEPLOY_INT8 = dict(qmethod="symmetric_uniform", act_qmethod="asymmetric_uniform",
                   per_channel_weights=True, quantize_input=True,
                   weight_range_method="current_minmax",
                   act_range_method="allminmax", int8_mxu=True)
DEPLOY_CAST = dict(deploy_cast_quant=True, conv_out_bf16=True)
DEPLOY_ROWS = [
    ("mnv2", "mobilenet_v2", 2048, DEPLOY_FP8, DEPLOY_CAST,
     dict(deploy_cast_quant=True), "dw_bf16_acts", False,
     {"qblock": 17, "qmatmul": 2}),
    ("vit", "vit_small", 128, DEPLOY_FP8, DEPLOY_CAST,
     dict(deploy_cast_quant=True), None, False,
     {"flash_mha": 12, "qmatmul": 37}),
    ("resnet50", "resnet50", 512, DEPLOY_FP8, dict(DEPLOY_CAST, deploy_act_f8=True),
     dict(deploy_cast_quant=True), None, False,
     {"qstem": 1, "qconv3x3": 16, "qmatmul": 37}),
    ("resnet18_int8", "resnet18", 1024, DEPLOY_INT8,
     dict(conv_out_bf16=True, int8_assume_signed=True),
     dict(int8_assume_signed=True), None, False,
     {"qconv3x3_int8": 16, "qmatmul_int8": 4}),
    ("resnet18_fp8", "resnet18", 1024, DEPLOY_FP8, DEPLOY_CAST,
     dict(deploy_cast_quant=True), None, "input", {"qconv3x3": 16, "qmatmul": 4}),
]
DEPLOY_CAL = 128                   # calibration images, as bench.py
DEPLOY_ITERS = 3                   # timed forwards per engine, after a warm one
CAST_MAXVALS = (1.0, 3.7, 57.0, 0.013)


def deploy_model(arch, cfg, setup, s2d, engine):
    """A row's model at full width, 1000 classes, on the card, with the
    seed's random weights."""
    from fp8_quantization_tpu_torch.models import convert
    from fp8_quantization_tpu_torch.models.mobilenet_v2 import mobilenetv2_quantized
    from fp8_quantization_tpu_torch.models.resnet import QUANT_ARCHITECTURES
    from fp8_quantization_tpu_torch.models.vit import vit_small_quantized
    from fp8_quantization_tpu_torch.nn.config import make_layer_config
    config = make_layer_config(engine=engine, **cfg)
    if arch == "mobilenet_v2":
        model = mobilenetv2_quantized(config, quant_setup=setup)
        convert.load_tonylins_mobilenet_v2(
            model, convert.random_mobilenet_v2_state_dict(SEED))
    elif arch == "vit_small":
        model = vit_small_quantized(config, quant_setup=setup)
        convert.load_timm_vit(model, convert.random_vit_state_dict(SEED))
    else:
        model = QUANT_ARCHITECTURES[arch + "_quantized"](
            config, quant_setup=setup, stem_s2d=s2d)
        convert.load_torchvision_resnet(model, convert.random_resnet_state_dict(
            SEED, model.stage_sizes, arch == "resnet50"))
    return model.eval()


def phase_cast_check():
    """The cast path on the card: its constants computed on the card equal
    the CPU's (cast_scale must be the exact factor over a power of two),
    fp8_quantize_cast equal by value to the exact pipeline
    (ops/fp8.quantize_to_fp8) and bit for bit to the CPU's, and its
    store_f8 bytes equal to the CPU's, for M in {2, 3, 4} at the four
    maxvals of JAX's tests/test_cast_quant.py and at 64 more drawn from
    the seed."""
    import numpy as np
    import torch
    from fp8_quantization_tpu_torch.ops import fp8
    cases, ok = [], True
    for mbits in (2, 3, 4):
        for maxval in CAST_MAXVALS:
            rng = np.random.RandomState(0)
            x = torch.from_numpy(np.concatenate([
                rng.uniform(-1.5 * maxval, 1.5 * maxval, 50_000),
                rng.normal(0, maxval / 50, 50_000),
                [0.0, -0.0, maxval, -maxval, maxval * 1e-9]]).astype(np.float32))
            xc = x.cuda()
            mv = torch.tensor(np.float32(maxval))
            c = fp8.fp8_cast_consts(mv, mbits)
            card_c = fp8.fp8_cast_consts(mv.cuda(), mbits)
            card = fp8.fp8_quantize_cast(xc, card_c)
            exact = fp8.quantize_to_fp8(xc, mv.cuda(), torch.tensor(float(mbits)).cuda())
            cpu = fp8.fp8_quantize_cast(x, c)
            stored = fp8.fp8_quantize_cast(xc, card_c, normalized=True, store_f8=True)
            cpu_stored = fp8.fp8_quantize_cast(x, c, normalized=True, store_f8=True)
            row = {"mbits": mbits, "maxval": maxval,
                   "consts_equal_cpu": bool(torch.equal(card_c.cpu(), c)),
                   "equal_exact": bool(torch.equal(card, exact)),
                   "bits_equal_cpu": bool(torch.equal(card.cpu().view(torch.int32),
                                                      cpu.view(torch.int32))),
                   "bytes_equal_cpu": bool(torch.equal(stored.cpu().view(torch.uint8),
                                                       cpu_stored.view(torch.uint8))),
                   "stored_dtype": str(stored.dtype)}
            ok &= (row["consts_equal_cpu"] and row["equal_exact"]
                   and row["bits_equal_cpu"] and row["bytes_equal_cpu"])
            cases.append(row)
    # the constants at many maxvals: on the card as on the CPU, and
    # cast_scale the exact pipeline's factor over a power of two
    many = torch.from_numpy(np.random.RandomState(SEED).uniform(
        0.01, 100.0, 64).astype(np.float32))
    consts = {}
    for mbits in (2, 3, 4):
        c = fp8.fp8_cast_consts(many.cuda(), mbits)
        factor = fp8.fp8_consts(many.cuda(), torch.tensor(float(mbits)).cuda())[5]
        pow2 = fp8.IEEE_F8[mbits][0] / (2.0 - 2.0 ** -mbits)
        consts[mbits] = {
            "equal_cpu": bool(torch.equal(c.cpu(), fp8.fp8_cast_consts(many, mbits))),
            "scale_is_factor_over_pow2": bool(torch.equal(c[0] * pow2, factor))}
        ok &= all(consts[mbits].values())
    emit({"phase": "cast_check", "ok": ok, "cases": cases, "consts_64_maxvals": consts})
    return ok


# images per chunk of a plain version in deploy_replay: each kernel call of
# a row's deployed forward is run again whole, and its plain version over
# the same batch this many images at a time (the plain qblock would hold
# several float32 copies of a 112x112x96 map per image at batch 2048)
REPLAY_IMAGES = 256
# the positional arguments of each kernel wrapper that carry the batch
BATCH_ARGS = {"qmatmul": (0,), "qconv3x3": (0, 5), "qstem": (0,), "qblock": (0,),
              "qdwconv3x3": (0,), "flash_mha": (0, 1, 2), "qconv3x3_int8": (0,),
              "qmatmul_int8": (0,)}


def replay_plain(kname, args, kw):
    """The plain version of a recorded kernel call."""
    import torch
    from fp8_quantization_tpu_torch.ops.kernels import attention, qblock, qconv
    if kname == "flash_mha":
        return attention.flash_mha_plain(*args, **kw)
    if kname == "qblock":
        xf = kw.get("x_factor")
        xf = torch.ones((), device=args[0].device) if xf is None else xf
        return qblock.qblock_plain(*args, xf, kw["cfg"])
    if kname == "qconv3x3":
        return qconv.qconv3x3_plain(*args[:5], args[5] if len(args) > 5 else None,
                                    kw["cfg"])
    return kernel_table()[kname][1](*args, kw["cfg"])


def replay_check(kname, args, kw, out, ref):
    """(ok, max_abs_err, exact share) of a recorded call's output against its
    plain version, by the check of its kernel's own phase."""
    cfg = kw.get("cfg")
    if kname == "flash_mha":
        return flash_check(out, ref, *args[:3], kw["sm_scale"])
    if kname in ("qconv3x3_int8", "qmatmul_int8"):
        return int8_check(out, ref)
    if kname == "qblock":
        return block_check(args, kw)(out, ref)
    if kname == "qmatmul" and cfg.quantize_input:
        return fp32_sum_check(args, cfg, out, ref)
    if getattr(cfg, "quantize_input", False) or cfg.act_method == "none":
        return sum_check(out, ref)
    consts = args[3] if kname == "qmatmul" else args[2]
    return grid_check(out, ref, consts, getattr(cfg, "emit_norm", False),
                      method=cfg.act_method)


def deploy_replay(results, calls, batch):
    """Each distinct kernel call of a row's deployed 'fused' forward
    (Capture), run again whole on the card and held against its plain
    version on the same card tensors, computed over the whole batch
    REPLAY_IMAGES images at a time, by its kernel's check (the checks of
    phases 2, 3, mnv2_check and vit_check): (ok, one entry per call).
    Each kernel's max_abs_err in ``results`` takes these in."""
    from fp8_quantization_tpu_torch.ops.kernels.common import no_tf32
    table = kernel_table()
    ok_all, cases = True, []
    for kname, recorded in calls.items():
        for args, kw, uses in recorded.values():
            out = table[kname][0](*args, **kw)
            lead = args[0].shape[0]
            step = REPLAY_IMAGES * (lead // batch)
            ok, err, exact = lead % batch == 0, 0.0, 0.0
            for s in range(0, lead, step):
                part = tuple(a[s:s + step] if i in BATCH_ARGS[kname] and a is not None
                             else a for i, a in enumerate(args))
                with no_tf32():
                    ref = replay_plain(kname, part, kw)
                c_ok, c_err, c_exact = replay_check(kname, part, kw, out[s:s + step], ref)
                ok, err = ok and c_ok, max(err, c_err)
                exact += c_exact * part[0].shape[0] / lead
                del ref
            del out
            shapes = " x ".join(str(tuple(a.shape)) for a in args[:3] if hasattr(a, "shape"))
            cases.append({"case": f"{kname} {shapes}", "uses": uses, "ok": ok,
                          "max_abs_err": err, "exact": exact})
            ok_all &= ok
            agg = results.setdefault(kname, {})
            agg["max_abs_err"] = max(agg.get("max_abs_err", 0.0), err)
    return ok_all, cases


# the layers that layer_hold runs again, by class name
HELD_LAYERS = ("QuantConv", "QuantLinear", "QuantLayerNorm", "QuantizedActivation",
               "QuantSelfAttention")
LAYER_HOLD_IMAGES = 16


def to_device(obj, device):
    """A layer's arguments (tensors, Factored, tuples, dicts) on ``device``."""
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if hasattr(obj, "_fields"):
        return type(obj)(*(to_device(o, device) for o in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(o, device) for o in obj)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    return obj


def layer_hold(model, x, quant_w=False):
    """Every quantized layer of a deployed model (HELD_LAYERS) on the card
    against the same layer of a CPU copy of it, on the inputs the card's
    forward of ``x`` gave that layer: the CPU runs the port's composed
    path, which tests/test_torch_deploy_flags.py holds to JAX's, so a
    fault of the card's path shows in the first layer it reaches, whatever
    the logits do downstream.  Per layer the share of output elements that
    differ (by value) and the largest difference in steps: of the layer's
    output quantizer (grid_step, with the IEEE subnormal step under
    deploy_act_f8) where it quantizes its output, else one bfloat16 ulp of
    the layer's largest output.  (ok, summary): ok when no
    layer differs by more than a step, and no quantized one on more than
    1% of its elements (the sums run in another order; a difference of a
    few float32 ulps flips a bin on a share of the values of the order of
    2^-20)."""
    import copy

    import torch
    from fp8_quantization_tpu_torch.nn.factored import materialize
    recorded, handles = {}, []
    for name, mod in model.named_modules():
        if type(mod).__name__ in HELD_LAYERS:
            handles.append(mod.register_forward_hook(
                lambda m, a, kw, out, name=name: recorded.__setitem__(
                    name, (to_device(a, "cpu"), to_device(kw, "cpu"),
                           materialize(out).float().cpu())),
                with_kwargs=True))
    try:
        with torch.no_grad():
            model(x, mode="fixed", quant_w=quant_w)
    finally:
        for h in handles:
            h.remove()
    cpu = dict(copy.deepcopy(model).cpu().named_modules())
    rows = []
    with torch.no_grad():
        for name, (args, kw, out) in recorded.items():
            mod = cpu[name]
            y = materialize(mod(*args, **kw)).float()
            cfg = mod.config
            quantized = (kw.get("quant_a", True) and cfg.quant_a
                         and (type(mod).__name__ == "QuantizedActivation"
                              or not cfg.quantize_input))
            diff = (out - y).abs()
            if quantized:
                quant = getattr(mod, "act_q", None) or mod.proj.act_q
                method, consts = quant.act_consts()
                step = grid_step(out, y, consts, False, method)
                if quant.spec.store_f8 or quant.spec.cast_ieee_subnorm:
                    # below smallest_normal the IEEE grid's step is twice
                    # the paper grid's bottom step
                    step = step + 2.0 ** (1.0 + float(consts[4, 0])) * float(consts[5, 0])
            else:
                step = torch.clamp(torch.maximum(out.abs(), y.abs()).max() * 2.0 ** -8,
                                   min=2.0 ** -126)
            rows.append({"layer": name, "quantized": bool(quantized),
                         "differ": float((diff > 0).float().mean()),
                         "max_steps": float((diff / step).max())})
    worst = max(rows, key=lambda r: (r["quantized"], r["differ"]))
    ok = all(r["max_steps"] <= 1.0 and (r["differ"] <= 0.01 or not r["quantized"])
             for r in rows)
    return ok, {"layers": len(rows), "images": int(x.shape[0]),
                "quantized_layers": sum(r["quantized"] for r in rows),
                "most_differing_quantized": worst,
                "max_steps": max(r["max_steps"] for r in rows),
                "layers_differing": sum(r["differ"] > 0 for r in rows)}


# the rows whose top-1 may instead be held to the one-ulp floor: the
# random-weight ViT's logits are chaotic (its exact model flips top-1 on
# about a fifth of the images when every input moves by one bf16 ulp; no
# redraw of its weights calmed that, PERF.md)
FLOOR_ROWS = ("vit",)
HEADS = {"mobilenet_v2": "classifier", "vit_small": "head", "resnet18": "fc",
         "resnet50": "fc"}


def deploy_row(results, label, arch, batch, cfg, flags, cast_flags, setup, s2d,
               per_forward):
    """One of bench.py's rows on the card (see phase_deploy_rows): (ok, line)."""
    import statistics

    import torch
    from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
    from fp8_quantization_tpu_torch.nn.bake import (
        bake_int8_weights, prepare_for_deployment, prepare_inference)
    from fp8_quantization_tpu_torch.ops import kernels
    from fp8_quantization_tpu_torch.ops.s2d import space_to_depth
    int8 = cfg is DEPLOY_INT8
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(batch, 224, 224, 3, device="cuda", generator=gen)
    base = deploy_model(arch, dict(cfg, **flags), setup, False, "bf16")
    calibrate(base, [x[:DEPLOY_CAL]], device="cuda")
    state = base.state_dict()
    del base
    # serving input: bf16 images, s2d'd for the 'input' stem; the float32
    # side takes the bf16 images themselves (bench.py:125-136)
    xb = x.to(torch.bfloat16)
    del x
    xq = space_to_depth(xb) if s2d == "input" else xb

    def deployed(fl, engine, stem=s2d):
        model = deploy_model(arch, dict(cfg, **fl), setup, stem, engine)
        model.load_state_dict(state)
        xin = xq if stem == s2d else xb
        example = torch.zeros((1,) + tuple(xin.shape[1:]), device="cuda")
        if int8:
            bake_int8_weights(model)
            prepare_inference(model, example, quant_w=True)
        else:
            prepare_for_deployment(model, example)
        return model

    def timed(fn):
        ms = [time_ms(fn, iters=1, warmup=1 if i == 0 else 0)
              for i in range(DEPLOY_ITERS)]
        return statistics.median(ms), ms

    # every bf16 input one ulp away from zero, and one toward it: the top-1
    # floor of the random-weight logits
    bits = xq.view(torch.int16)
    moved = [(bits + 1).view(torch.bfloat16),
             torch.where((bits & 0x7FFF) != 0, bits - 1, bits).view(torch.bfloat16)]
    line, ok = {"phase": f"deploy_{label}", "batch": batch, "flags": flags,
                "quant_setup": setup, "stem_s2d": s2d}, True
    deploy, head_q = {}, None
    with torch.no_grad():
        for engine in ("bf16", "fused"):
            logits = {}
            for name, fl in (("exact", {}), ("cast", cast_flags)):
                model = deployed(fl, engine)
                logits[name] = model(xq, mode="fixed", quant_w=int8)
                if name == "exact":
                    logits["moved"] = [model(m, mode="fixed", quant_w=int8)
                                       for m in moved]
                del model
            model = deployed(flags, engine)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            model(xq, mode="fixed", quant_w=int8)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            kernels.reset_launch_counts()
            with Capture() as cap:
                logits["deploy"] = model(xq, mode="fixed", quant_w=int8)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            med, ms = timed(lambda: model(xq, mode="fixed", quant_w=int8))
            top1, *floors = (float((y.argmax(-1) == logits["exact"].argmax(-1))
                                   .float().mean())
                             for y in [logits["deploy"]] + logits["moved"])
            floor = min(floors)
            finite = bool(torch.isfinite(logits["deploy"].float()).all())
            cast_equal = bool(torch.equal(logits["cast"], logits["exact"]))
            want = {k: per_forward.get(k, 0) if engine == "fused" else 0
                    for k in kernels.WRAPPERS}
            top1_ok = top1 >= 0.98 or (label in FLOOR_ROWS and top1 >= floor)
            row = {"launches": counts, "launches_ok": counts == want,
                   "top1_vs_exact": top1, "top1_floor_one_ulp": floor,
                   "distinct_top1": len(set(logits["deploy"].argmax(-1).tolist())),
                   "input_share": input_share(logits["deploy"].float()),
                   "top1_ok": top1_ok, "cast_only_bit_equal": cast_equal,
                   "finite": finite, "median_ms": med, "ms": ms,
                   "images_per_s": batch / med * 1e3, "peak_gb": peak / 1e9}
            ok &= counts == want and top1_ok and cast_equal and finite
            if engine == "fused":
                add_launches(results, counts)
                row["replay_ok"], row["replay"] = deploy_replay(results, cap.calls, batch)
                ok &= row["replay_ok"]
                head_q = getattr(model, HEADS[arch]).act_q
            else:
                row["floor_gap"] = min(logit_gap(m, logits["exact"])
                                       for m in logits["moved"])
                row["layer_hold_ok"], row["layer_hold"] = layer_hold(
                    model, xq[:LAYER_HOLD_IMAGES], int8)
                ok &= row["layer_hold_ok"]
                # float32: the same calibrated state without quantization
                # (bench.py's fp32 side), on the bf16 images and the
                # default stem
                base32 = model if s2d != "input" else deployed(flags, engine, False)
                med32, ms32 = timed(lambda: base32(xb, mode="fixed", quant_w=False,
                                                   quant_a=False))
                line["fp32"] = {"median_ms": med32, "ms": ms32,
                                "images_per_s": batch / med32 * 1e3}
                del base32
            deploy[engine] = logits["deploy"]
            line[engine] = row
            del model, logits, cap
            torch.cuda.empty_cache()
    for engine in ("bf16", "fused"):
        line[engine]["vs_fp32"] = line["fp32"]["median_ms"] / line[engine]["median_ms"]
    # fused against bf16, both deployed with the row's flags: the kernels
    # skip the flags' roundings, which the logits spread as they spread a
    # one-ulp input move, so the gap is held to twice that floor's
    a, b = deploy["fused"].float(), deploy["bf16"].float()
    top1 = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    floor = line["bf16"]["top1_floor_one_ulp"]
    pair = {"top1": top1, "logit_gap": logit_gap(a, b),
            "floor_gap": line["bf16"]["floor_gap"], "exact": float((a == b).float().mean())}
    if int8:     # float logits: the fc quantizes its input
        pair["within_1e-3"] = float(((a - b).abs() <= 1e-3 + 1e-3 * b.abs())
                                    .float().mean())
    else:
        pair["within_one_step"] = float(((a - b).abs() <= logit_step(head_q, a, b))
                                        .float().mean())
    pair_ok = ((top1 >= 0.98 or (label in FLOOR_ROWS and top1 >= floor))
               and pair["logit_gap"] <= 2 * pair["floor_gap"])
    pair["ok"] = pair_ok
    line["fused_vs_bf16"] = pair
    ok &= pair_ok
    line["ok"] = ok
    return ok, line


def phase_deploy_rows(results):
    """bench.py's five configurations on 'bf16' and 'fused' at bench.py's
    batches (DEPLOY_ROWS), each as bench_model builds it: random full-width
    weights from the seed, calibrated on 128 synthetic images, deployed on
    the card (prepare_for_deployment; the int8 bake and the prepare pass on
    the INT8 row), bf16 serving input.  Per row and engine: the port's
    kernel launches of one forward (counted from zero just before it and
    read just after; the 'fused' row's expected kernels, none on 'bf16'),
    top-1 agreement >= 98% with the same row without its deployment flags
    on the same engine (on the rows of FLOOR_ROWS, or no lower than that
    exact model's agreement with itself when every input moves by one bf16
    ulp, the lower of the moves away from and toward zero; both are
    printed), logits bit-equal to the exact config where only
    deploy_cast_quant (INT8: int8_assume_signed) differs, images/s (median
    of DEPLOY_ITERS forwards after a warm one) against the float32 forward
    of the same calibrated state with quantization off at the same batch
    on the bf16 images (bench.py's fp32 side), and the peak memory of the
    deployed forward.  On 'fused' every distinct kernel call of that
    forward is replayed against its plain version (deploy_replay); on
    'bf16' every row is held layer by layer against a CPU copy
    (layer_hold): the random-weight logits are chaotic or nearly the same
    class for every image (distinct_top1 and input_share are printed), so
    their top-1 alone says little.  The deployed 'fused' logits are held against the
    deployed 'bf16' ones: top-1 >= 98% (FLOOR_ROWS: or the floor) and the
    rms gap over the logits' spread (logit_gap) at most twice the gap
    that the one-ulp move gives the exact 'bf16' model, as vit_slice holds
    fused against bf16 (the kernels skip conv_out_bf16's rounding and f8
    storage, as the Pallas kernels do, and at these depths the logits
    spread that difference as they spread a one-ulp move, so a per-logit
    bound of one step of the head's grid does not hold: the share within
    it is printed beside)."""
    import torch
    smi = smi_line()
    ok = True
    for row in DEPLOY_ROWS:
        try:
            row_ok, line = deploy_row(results, *row)
        except torch.cuda.OutOfMemoryError:
            traceback.print_exc()
            row_ok, line = False, {"phase": f"deploy_{row[0]}", "ok": False,
                                   "error": "out of memory"}
        line["nvidia_smi"] = smi
        emit(line)
        ok &= row_ok
        torch.cuda.empty_cache()
    return ok


# the kernel gate's default (phase gate): one model each, its CLI args,
# its head layer, how fused is held against bf16 (GATE_JUDGES) and whether
# it evaluates with quant_w (the int8 bake)
GATE_MODELS = (("resnet18", CLI_ARGS, "fc", "step", False),
               ("mnv2_fp32_after", mnv2_cli_args("fp32_after"), "classifier", "step",
                False),
               ("vit", VIT_CLI_ARGS, "head", "floor", False),
               ("resnet18_int8", INT8_CLI_ARGS, "fc", "int8", True))
# each gate of ops/kernels/autotune.py and the kernel its "kernel" answer launches
GATE_KERNELS = {"pallas_wins": "qmatmul", "int8_matmul_wins": "qmatmul_int8",
                "conv3_group": "qconv3x3", "conv3_int8_group": "qconv3x3_int8",
                "dw_group": "qdwconv3x3", "stem_group": "qstem", "attn_wins": "flash_mha",
                "ir_group": "qblock"}
GATE_MODES = ("auto", "always", "bf16")        # the throughput turns' order
GATE_TURNS = 4                     # pairs of turns (THROUGHPUT_TURNS' 2 spread too wide)
GATE_ITERS = 10                    # forwards per timed turn
# auto's images/s on the INT8 row may fall below always's by at most this
# share (gate_pair_ratio): a route the gate wrongly kept off the card, as
# JAX's unraced int8 1x1 rule did, cost 17%.  The median ratio of the
# throughput turns (``auto_over_always``, ten forwards a turn, a bf16 turn
# between some pairs) stays a record: for identical routes it read
# 0.91-1.08 on a shared host (ResNet-18 FP8, every verdict "kernel"), as
# wide as the loss it is meant to catch; the host paces the forward (its
# pageable copies wait for the card), so timing the card alone cannot help
GATE_INT8_SLACK = 0.10


def gate_of(key):
    """The gate whose cache key ``key`` is (ops/kernels/autotune.py's key
    forms)."""
    if not isinstance(key[0], str):
        return "pallas_wins"
    tags = (("irb", "ir_group"), ("ig", "conv3_int8_group"), ("im", "int8_matmul_wins"),
            ("c", "conv3_group"), ("d", "dw_group"), ("s", "stem_group"),
            ("a", "attn_wins"))
    return next(gate for tag, gate in tags if key[0].startswith(tag))


class GateWatch:
    """While active: tallies, per kernel, the gates' "kernel" answers given
    outside a race (``kernel``: the launches those answers imply), counts
    the races (``races``, a block's race holding its layers' races) and the
    kernel launches made inside them (``race_launches``), the gate calls
    made outside a race and the host seconds spent in them (``calls``,
    ``gate_s``), and records each prepare pass's races, new verdicts and
    launches (``prepares``)."""

    def __enter__(self):
        from fp8_quantization_tpu_torch.nn import bake
        from fp8_quantization_tpu_torch.ops import kernels
        from fp8_quantization_tpu_torch.ops.kernels import autotune
        self.kernel = dict.fromkeys(kernels.WRAPPERS, 0)
        self.races = self.depth = self.calls = 0
        self.gate_s = 0.0
        self.race_launches = dict.fromkeys(kernels.WRAPPERS, 0)
        self.prepares = []
        self.saved = []

        def patch(mod, attr, make):
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))
            setattr(mod, attr, make(fn))

        def tally(kname):
            def make(gate):
                def run(*a, **kw):
                    if self.depth:          # a gate inside a block's race
                        return gate(*a, **kw)
                    races, t0 = self.races, time.perf_counter()
                    answer = gate(*a, **kw)
                    if self.races == races:     # a warm call, no race in it
                        self.gate_s += time.perf_counter() - t0
                        self.calls += 1
                    first = answer[0] if isinstance(answer, tuple) else answer
                    self.kernel[kname] += int(bool(first))
                    return answer
                return run
            return make

        def race(fn):
            def run(*a, **kw):
                before = kernels.launch_counts()
                self.depth += 1
                try:
                    win = fn(*a, **kw)
                finally:
                    self.depth -= 1
                self.races += 1
                if not self.depth:
                    for k, n in kernels.launch_counts().items():
                        self.race_launches[k] += n - before[k]
                return win
            return run

        def prepare(fn):
            def run(*a, **kw):
                import torch
                races, known = self.races, autotune.decisions()
                before = kernels.launch_counts()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                self.prepares.append({
                    "races": self.races - races,
                    "new_verdicts": len(autotune.decisions()) - len(known),
                    "launches": {k: n - before[k]
                                 for k, n in kernels.launch_counts().items()}})
                return out
            return run

        for gate, kname in GATE_KERNELS.items():
            patch(autotune, gate, tally(kname))
        patch(autotune, "_race", race)
        patch(bake, "prepare_inference", prepare)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)


def gate_judge(kind, head_q, fused, bf16, xs, quant_w):
    """(ok, line fields): the prepared fused logits against bf16's to the
    slice phases' bounds: "step" as phase 4 (top-1 >= 99%, >= 98% within
    one step of the head's output quantizer), "int8" as phase 5 (top-1 >=
    99%, >= 98% within rtol = atol = 1e-3), "floor" as vit_slice (the rms
    gap over the logits' spread at most twice the one-ulp floor of bf16)."""
    import torch
    with torch.no_grad():
        a = torch.cat([fused(x, mode="fixed", quant_w=quant_w) for x in xs])
        b = torch.cat([bf16(x, mode="fixed", quant_w=quant_w) for x in xs])
        finite = bool(torch.isfinite(a).all())
        agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        if kind == "floor":
            b_ulp = torch.cat([bf16(torch.nextafter(x, torch.full_like(x, math.inf)),
                                    mode="fixed", quant_w=quant_w) for x in xs])
            gap, floor = logit_gap(a, b), logit_gap(b_ulp, b)
            return finite and gap <= 2 * floor, {
                "top1_agree_vs_bf16": agree, "logit_gap_vs_bf16": gap,
                "bf16_one_ulp_floor": floor}
        tol = (logit_step(head_q, a, b) if kind == "step"
               else 1e-3 + 1e-3 * b.abs())
        within = float(((a - b).abs() <= tol).float().mean())
    return finite and agree >= 0.99 and within >= 0.98, {
        "top1_agree_vs_bf16": agree, "logits_within_bound_vs_bf16": within}


def gate_throughput(fused, bf16, x, quant_w):
    """Images/s of the prepared fused model under the gate's auto and always
    modes and of bf16, in turns (auto, always, bf16, bf16, always, auto, ...)
    as phase_throughput takes them; from the median of the turns and from
    the best turn (``*_best_images_per_s``).  ``auto_over_always``: the
    median over the rounds of auto's images/s over always's in the same
    round, where the two turns sit side by side, so that a shared host's
    slow spells touch both."""
    import statistics

    from fp8_quantization_tpu_torch.ops.kernels import autotune
    turns = {m: [] for m in GATE_MODES}
    for order in (1, -1) * GATE_TURNS:
        for mode in GATE_MODES[::order]:
            autotune.MODE = "auto" if mode == "bf16" else mode
            model = bf16 if mode == "bf16" else fused
            turns[mode].append(time_ms(lambda: model(x, mode="fixed", quant_w=quant_w),
                                       iters=GATE_ITERS))
    autotune.MODE = "auto"
    rates = {f"{m}_images_per_s": x.shape[0] / statistics.median(ms) * 1e3
             for m, ms in turns.items()}
    rates.update({f"{m}_best_images_per_s": x.shape[0] / min(ms) * 1e3
                  for m, ms in turns.items()})
    rates["auto_over_always"] = statistics.median(
        b / a for a, b in zip(turns["auto"], turns["always"]))
    return rates


GATE_PAIRS = 24          # adjacent (auto, always) turns of the INT8 row's check
GATE_PAIR_ITERS = 3      # forwards per turn of a pair


def gate_pair_ratio(model, x, quant_w):
    """Auto's images/s over always's: the median over GATE_PAIRS pairs of
    adjacent short turns (GATE_PAIR_ITERS forwards each, the order
    alternating), so that a shared host's slow spells touch both turns of
    a pair.  (The median, and the ratios of each pair.)"""
    import statistics

    import torch

    from fp8_quantization_tpu_torch.ops.kernels import autotune
    ratios = []
    with torch.no_grad():
        for i in range(GATE_PAIRS):
            ms = {}
            for mode in ("auto", "always")[::1 if i % 2 == 0 else -1]:
                autotune.MODE = mode
                ms[mode] = time_ms(lambda: model(x, mode="fixed", quant_w=quant_w),
                                   iters=GATE_PAIR_ITERS, warmup=1)
            ratios.append(ms["always"] / ms["auto"])
    autotune.MODE = "auto"
    return statistics.median(ratios), ratios


def gate_model(results, label, cli, head, kind, quant_w, watch):
    """One model of phase gate: (ok, line, the prepared fused model, one
    batch)."""
    import copy

    import torch
    from fp8_quantization_tpu_torch.cli import image_net
    from fp8_quantization_tpu_torch.nn.bake import (
        bake_int8_weights, bake_weights, prepare_inference)
    from fp8_quantization_tpu_torch.ops import kernels

    # the main path: the first evaluation batch races each new shape
    kernels.reset_launch_counts()
    tallied, race_launches = dict(watch.kernel), dict(watch.race_launches)
    with Forwards() as fw:
        metrics = image_net.validate_quantized(image_net.build_parser().parse_args(cli))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    outside_races = {k: n - (watch.race_launches[k] - race_launches[k])
                     for k, n in counts.items()}
    cli_prepare = watch.prepares[-1]
    eval_launches = {k: n - cli_prepare["launches"][k] for k, n in outside_races.items()}
    implied = {k: watch.kernel[k] - tallied[k] for k in counts}
    add_launches(results, outside_races)
    cli_ok = (math.isfinite(metrics["loss"]) and fw.baked == EVAL_BATCHES + 1
              and eval_launches == implied and cli_prepare["races"] == 0
              and cli_prepare["new_verdicts"] == 0)

    # the same state on fused and bf16, baked and prepared (the verdicts
    # of the main path's shapes are known now: no race from here on)
    batches, fused, bf16 = engine_pair(cli)
    races = watch.races
    for model in (fused, bf16):
        (bake_int8_weights if quant_w else bake_weights)(model)
    unprepared = copy.deepcopy(fused)
    xs = [torch.as_tensor(x, device="cuda") for x, _ in batches]
    example = torch.zeros((1,) + tuple(xs[0].shape[1:]), device="cuda")
    for model in (fused, bf16):
        prepare_inference(model, example, quant_w=quant_w)
    prep = watch.prepares[-2:]
    with torch.no_grad():
        equal = [bool(torch.equal(unprepared(x, mode="fixed", quant_w=quant_w),
                                  fused(x, mode="fixed", quant_w=quant_w))) for x in xs]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        tallied, calls, gate_s = dict(watch.kernel), watch.calls, watch.gate_s
        fused(xs[0], mode="fixed", quant_w=quant_w)
        torch.cuda.synchronize()
    per_forward = kernels.launch_counts()
    gate_calls, gate_us = watch.calls - calls, (watch.gate_s - gate_s) * 1e6
    implied_fwd = {k: watch.kernel[k] - tallied[k] for k in per_forward}
    judged, judge_line = gate_judge(kind, getattr(fused, head).act_q, fused, bf16, xs,
                                    quant_w)
    rates = gate_throughput(fused, bf16, xs[0], quant_w)
    # the INT8 row: auto keeps no route off the card that always would win
    # with (JAX's unraced int8 1x1 rule did)
    fast = True
    if kind == "int8":
        ratio, pairs = gate_pair_ratio(fused, xs[0], quant_w)
        rates.update(auto_over_always_paired=ratio, paired_ratios=pairs)
        fast = ratio >= 1 - GATE_INT8_SLACK
    ok = (cli_ok and all(equal) and per_forward == implied_fwd and watch.races == races
          and all(p["races"] == 0 and p["new_verdicts"] == 0 for p in prep) and judged
          and fast)
    auto_ms = xs[0].shape[0] / rates["auto_images_per_s"] * 1e3
    line = {"model": label, "ok": ok, "metrics": metrics,
            "launches_per_forward": per_forward,
            "launches_the_verdicts_imply": implied_fwd,
            "main_path_eval_launches": eval_launches,
            "main_path_launches_implied": implied,
            "prepare_passes": [cli_prepare] + prep,
            "prepared_logits_bit_equal": equal, **judge_line, **rates,
            "auto_not_below_always": fast,
            "gate_calls_per_forward": gate_calls,
            "gate_host_us_per_forward": gate_us,
            "gate_host_share_of_auto_forward": gate_us / 1e3 / auto_ms}
    return ok, line, fused, xs[0]


def phase_gate(results):
    """The kernel gate's default (ops/kernels/autotune.py, mode auto) on the
    card, with an empty live cache in a temporary file: ResNet-18 FP8, MobileNetV2 FP8 fp32_after,
    ViT-S/16 FP8 and ResNet-18 INT8 input quant (GATE_MODELS) through
    validate-quantized at batch 64, the first evaluation batch racing each
    kernel against its composed route.  Per model: the launches of the two
    evaluation batches, and of one prepared forward, equal what the gates'
    answers imply (GateWatch), whatever the verdicts; the prepare passes
    race and record nothing; the prepared fused logits bit-equal to the
    unprepared ones and held against bf16 (gate_judge); images/s under
    auto, always and bf16 (gate_throughput), the INT8 row's auto within
    GATE_INT8_SLACK of always's in short adjacent pairs (gate_pair_ratio);
    the host time of the warm gate calls of
    one forward.  Then the cache file reloaded
    into an empty in-process cache answers every gate of the four prepared
    forwards with zero races and the same verdicts.  One line per verdict
    (the gate's key, kernel and composed ms, the verdict)."""
    import shutil
    import tempfile

    import torch
    from fp8_quantization_tpu_torch.ops.kernels import autotune

    tmp = tempfile.mkdtemp(prefix="fp8tpu_gate_")
    saved = (autotune._CACHE_PATH, autotune._CACHE, autotune._TIMES,
             autotune._DISK_LOADED)
    autotune._CACHE_PATH = os.path.join(tmp, "live.json")
    autotune._CACHE, autotune._TIMES, autotune._DISK_LOADED = {}, {}, False
    autotune.MODE = "auto"
    ok, kept = True, []
    try:
        with GateWatch() as watch:
            for label, cli, head, kind, quant_w in GATE_MODELS:
                m_ok, line, fused, x = gate_model(results, label, cli, head, kind,
                                                  quant_w, watch)
                emit({"phase": "gate_model", "nvidia_smi": smi_line(), **line})
                ok &= m_ok
                kept.append((fused, x, quant_w))
            verdicts, table = autotune.decisions(), autotune.decision_table()
            with open(autotune._CACHE_PATH) as f:
                file_verdicts = json.load(f)
            autotune._CACHE, autotune._DISK_LOADED = {}, False
            races = watch.races
            with torch.no_grad():
                for fused, x, quant_w in kept:
                    fused(x, mode="fixed", quant_w=quant_w)
            reload_ok = (watch.races == races and autotune.decisions() == verdicts
                         and file_verdicts == table)
        times = autotune.races()
        for key, verdict in verdicts.items():
            t_kernel, t_composed = times[key]
            emit({"phase": "gate_verdict", "gate": gate_of(key),
                  "key": autotune.key_name(key),
                  "kernel_ms": t_kernel * 1e3, "composed_ms": t_composed * 1e3,
                  "verdict": "kernel" if verdict else "composed"})
        ok &= reload_ok and len(times) == len(verdicts)
        emit({"phase": "gate", "ok": ok, "races": len(times),
              "kernel_verdicts": sum(bool(v) for v in verdicts.values()),
              "composed_verdicts": sum(not v for v in verdicts.values()),
              "reload_zero_races_same_verdicts": reload_ok})
    finally:
        (autotune._CACHE_PATH, autotune._CACHE, autotune._TIMES,
         autotune._DISK_LOADED) = saved
        shutil.rmtree(tmp, ignore_errors=True)
    return ok


# ---- checkpoints (utils/checkpoint.py) and the serving export (serving/export.py)

QAT_CKPT_STEPS = 2                 # training batches of the checkpoint phase's QAT run


def cli_forward_logits(cli, x):
    """validate-quantized through the CLI's entry point with the launch
    counts zeroed just before and read just after: (metrics, counts, the
    counts RESNET_FP8_LAUNCHES asks for, the deployed model's logits on
    ``x``)."""
    import torch
    from fp8_quantization_tpu_torch.cli import image_net
    from fp8_quantization_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    with Forwards() as fw:
        metrics = image_net.validate_quantized(image_net.build_parser().parse_args(cli))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = expected_launches(RESNET_FP8_LAUNCHES, fw.baked)
    with torch.no_grad():
        logits = fw.model(x, mode="fixed", quant_w=False)
    return metrics, counts, want, logits


def phase_checkpoint(results):
    """utils/checkpoint.py through the CLI on the card.  ResNet-18 FP8
    (CLI_ARGS, batch 64, 'fused'): validate-quantized with
    --save-checkpoint-dir, then again with --load-type quantized from that
    directory: the metrics lines equal and the deployed (baked, prepared)
    models' logits on one batch bit-equal.  Two runs under --deterministic
    (the deterministic settings undone after): bit-equal logits.  Each run
    launches exactly RESNET_FP8_LAUNCHES per baked forward.  Then
    train-quantized (QAT_CLI_ARGS, MobileNetV2 FP8, QAT_CKPT_STEPS steps)
    with --save-checkpoint-dir: its QAT state restored into the state
    init_qat_state builds for a fresh model equals the trained one tensor
    for tensor (model, both optimizers' moments, oscillation state, step),
    and the restored model's fixed-mode forward on the card (unbaked) is
    bit-equal to the trained model's."""
    import shutil
    import tempfile

    import torch
    from fp8_quantization_tpu_torch.cli import image_net
    from fp8_quantization_tpu_torch.training import qat
    from fp8_quantization_tpu_torch.utils.checkpoint import (
        latest_step, restore_checkpoint)

    tmp = tempfile.mkdtemp(prefix="fp8tpu_ckpt_")
    x = torch.randn(BATCH, 224, 224, 3, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    line = {"phase": "checkpoint"}
    try:
        t0 = time.perf_counter()
        ck = os.path.join(tmp, "ptq")
        runs = {}
        for name, extra in (("save", ["--save-checkpoint-dir", ck]),
                            ("load", ["--load-type", "quantized",
                                      "--load-checkpoint-dir", ck])):
            runs[name] = cli_forward_logits(CLI_ARGS + extra, x)
        prev = (torch.are_deterministic_algorithms_enabled(),
                torch.backends.cudnn.benchmark,
                os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
        try:
            for name in ("deterministic_1", "deterministic_2"):
                runs[name] = cli_forward_logits(CLI_ARGS + ["--deterministic"], x)
        finally:
            torch.use_deterministic_algorithms(prev[0])
            torch.backends.cudnn.benchmark = prev[1]
            if prev[2] is None:
                os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        launches_ok = all(r[1] == r[2] for r in runs.values())
        for r in runs.values():
            add_launches(results, r[1])
        ptq_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        qck = os.path.join(tmp, "qat")
        qat_cli = QAT_CLI_ARGS + ["--max-train-batches", str(QAT_CKPT_STEPS),
                                  "--save-checkpoint-dir", qck]
        with Forwards(), TrainRecorder() as rec:
            qmetrics = image_net.train_quantized(image_net.build_parser().parse_args(qat_cli))
        trained = rec.state
        args = image_net.build_parser().parse_args(qat_cli)
        fresh_model = image_net.build_model(args)
        restored = restore_checkpoint(qck, qat.init_qat_state(
            fresh_model, fresh_model.config,
            qat.make_optimizer(args.optimizer, float(args.learning_rate)),
            qat.make_optimizer(args.quant_optimizer, args.quant_learning_rate),
            oscillation=trained.oscillation))
        unequal = [k for k, v in trained.model.state_dict().items()
                   if not torch.equal(v, restored.model.state_dict()[k])]
        for a, b in ((trained.optimizer, restored.optimizer),
                     (trained.quant_optimizer, restored.quant_optimizer)):
            for i, (sa, sb) in enumerate(zip(a.state_dict()["state"].values(),
                                             b.state_dict()["state"].values())):
                unequal += [f"opt{i}.{k}" for k in sa if not torch.equal(sa[k], sb[k])]
        for layer, st in (trained.osc_state or {}).items():
            unequal += [f"osc.{layer}.{k}" for k, v in st.items()
                        if not torch.equal(v, restored.osc_state[layer][k])]
        with torch.no_grad():
            same_fwd = bool(torch.equal(trained.model(x, mode="fixed"),
                                        restored.model(x, mode="fixed")))
        qat_s = time.perf_counter() - t0

        load_equal = runs["save"][0] == runs["load"][0]
        restored_bits = bool(torch.equal(runs["save"][3], runs["load"][3]))
        det_bits = bool(torch.equal(runs["deterministic_1"][3], runs["deterministic_2"][3]))
        qat_ok = (not unequal and same_fwd and restored.step == trained.step == QAT_CKPT_STEPS
                  and latest_step(qck) == 0 and math.isfinite(qmetrics["loss"]))
        ok = load_equal and restored_bits and det_bits and launches_ok and qat_ok
        line.update(ok=ok, metrics_equal_after_load=load_equal,
                    restored_logits_bit_equal=restored_bits,
                    deterministic_logits_bit_equal=det_bits,
                    deterministic_metrics=[runs[k][0] for k in ("deterministic_1",
                                                                  "deterministic_2")],
                    launches={k: r[1] for k, r in runs.items()},
                    expected_launches=runs["save"][2], ptq_s=ptq_s,
                    qat_state_unequal=unequal[:8], qat_step=restored.step,
                    qat_restored_forward_bit_equal=same_fwd,
                    qat_checkpoint_step=latest_step(qck), qat_s=qat_s,
                    checkpoint_mb={"ptq": os.path.getsize(os.path.join(
                        ck, "step_0", "state.pt")) / 2 ** 20,
                        "qat": os.path.getsize(os.path.join(
                            qck, "step_0", "state.pt")) / 2 ** 20})
        emit(line)
        return ok
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the CUDA runtime and driver calls that put work on the card's queue
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemcpy",
                "cudaMemsetAsync", "cudaMemset")


def profile_calls(fns, n=5):
    """torch.profiler over ``n`` calls of each of ``fns`` (a dict of
    callables), one profile a call, the callables taken in turn, after a
    warm call of each: {name: {"calls": the launch calls (LAUNCH_CALLS)
    of one call, "records": its device records (kernels, copies and
    fills), "names": those records by name}}, from the profile with the
    most launch calls.  The most, and the calls rather than the records,
    since the profiler drops device records and adds none: a long process
    recorded 216 a forward of ResNet-18 FP8 in every profile where a fresh
    one recorded 259, and a profile now and then records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    runs = {k: [] for k in fns}
    with torch.no_grad():
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        for _ in range(n):
            for k, fn in fns.items():
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                events = prof.key_averages()
                names = {e.key: e.count for e in events
                         if e.device_type == torch.autograd.DeviceType.CUDA}
                runs[k].append({"calls": sum(e.count for e in events
                                             if e.key in LAUNCH_CALLS),
                                "records": sum(names.values()), "names": names})
    return {k: max(r, key=lambda c: (c["calls"], c["records"])) for k, r in runs.items()}


def names_differing(a, b):
    """{launch name: [count in a, count in b]} where two profiles'
    launches by name differ."""
    return {k: [a.get(k, 0), b.get(k, 0)] for k in set(a) | set(b)
            if a.get(k, 0) != b.get(k, 0)}


def export_input(shape, seed):
    """The export phase's input of ``shape``: the same values in the
    serving process as in this one."""
    import torch
    return torch.randn(shape, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(seed))


def serve_artifacts(spec_path):
    """The serving side of the export phase, in a process of its own: each
    artifact of the spec loaded with serving.load_exported (the op library,
    no model code), run on each of its inputs with the launch counts zeroed
    just before and read just after, its logits saved, and one forward at
    its last batch profiled; prints one JSON line, with the port modules
    this process imported."""
    import torch
    from fp8_quantization_tpu_torch.ops import kernels
    from fp8_quantization_tpu_torch.serving import load_exported
    with open(spec_path) as f:
        spec = json.load(f)
    out = {}
    for case in spec["cases"]:
        t0 = time.perf_counter()
        fn = load_exported(case["path"], device="cuda")
        load_s = time.perf_counter() - t0
        runs = []
        for shape in case["shapes"]:
            x = export_input(shape, case["seed"])
            kernels.reset_launch_counts()
            with torch.no_grad():
                y = fn(x)
            torch.cuda.synchronize()
            runs.append(kernels.launch_counts())
            torch.save(y.cpu(), os.path.join(spec["dir"], f"{case['name']}_{shape[0]}.pt"))
        x = export_input(case["shapes"][-1], case["seed"])
        out[case["name"]] = {"load_s": load_s, "launches": runs,
                             "profile": profile_calls({"artifact": lambda: fn(x)})["artifact"]}
    mods = sorted(m for m in sys.modules if m.startswith("fp8_quantization_tpu"))
    print(json.dumps({"cases": out, "modules": mods}), flush=True)


EXPORT_BATCHES = {"resnet18_fp8": (1, 7, BATCH)}     # the symbolic-batch artifact


def export_cases(slice_out):
    """(name, deployed model, quant_w, batch_size of the export) of the
    export phase: the slices' deployed 'fused' models (ResNet-18 FP8, with
    a symbolic batch; ResNet-18 INT8, int8-baked; MobileNetV2 FP8 in both
    bn modes; ViT-S/16 FP8) and ResNet-18 FP8 on 'bf16' with
    deploy_cast_quant, conv_out_bf16 and deploy_act_f8 (E3M4), calibrated
    on one batch and deployed here (nn/bake.prepare_for_deployment)."""
    from itertools import islice

    import torch
    from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
    from fp8_quantization_tpu_torch.cli import image_net
    from fp8_quantization_tpu_torch.data.imagenet import make_dataloaders
    from fp8_quantization_tpu_torch.nn.bake import prepare_for_deployment
    deploy = image_net.build_model(image_net.build_parser().parse_args(
        CLI_ARGS + ["--engine", "bf16", "--deploy-cast-quant", "--conv-out-bf16",
                    "--deploy-act-f8"]))
    _, val = make_dataloaders(None, batch_size=BATCH, seed=SEED)
    calibrate(deploy, list(islice(iter(val), 1)), device="cuda", num_batches=1)
    prepare_for_deployment(deploy, torch.zeros((1, 224, 224, 3), device="cuda"))
    return [("resnet18_fp8", slice_out["fused"], False, None),
            ("resnet18_int8", slice_out["int8"], True, BATCH),
            ("mnv2_fp32_after", slice_out["fp32_after"], False, BATCH),
            ("mnv2_folded", slice_out["folded"], False, BATCH),
            ("vit_s16_fp8", slice_out["vit"], False, BATCH),
            ("resnet18_fp8_bf16_deploy_f8", deploy, False, BATCH)]


def phase_export(results, slice_out):
    """serving/export.py on the card at full width (export_cases): each
    deployed model exported (export seconds, artifact MB), then every
    artifact loaded and run in one serving process that imports neither
    fp8_quantization_tpu_torch.models nor ...nn.layers (serve_artifacts).
    Per artifact: its logits bit-equal to the live model's on the same
    input (the symbolic-batch ResNet-18 at batches 1, 7 and 64, the others
    at 64), its kernel launches per forward equal to the live forward's
    (the wrappers' counters), and its PyTorch launches per forward
    (profile_calls: the launch calls torch.profiler records, five forwards
    of each, the two profiled in turn), the artifact loaded in this process
    beside the live model, no more than the live forward's, with the
    device records and the kernel names whose counts differ (the serving
    process's counts and its names that differ from the artifact's in this
    process printed beside).  The symbolic-batch
    artifact's images/s at batch 64 beside the live model's, in turns
    (artifact, live, live, artifact), a record with no bound.  One line
    per artifact and the phase's line with its seconds."""
    import shutil
    import statistics
    import tempfile

    import torch
    from fp8_quantization_tpu_torch.ops import kernels
    from fp8_quantization_tpu_torch.serving import (
        export_quantized_model, load_exported)
    from fp8_quantization_tpu_torch.serving.export import conv_flags, conv_tf32

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="fp8tpu_export_")
    try:
        cases, live = [], {}
        for seed, (name, model, quant_w, batch) in enumerate(export_cases(slice_out)):
            t0 = time.perf_counter()
            path, shape = export_quantized_model(
                model, os.path.join(tmp, f"{name}.pt2"), batch_size=batch,
                quant_w=quant_w)
            export_s = time.perf_counter() - t0
            shapes = [list(model.input_shape((b, 224, 224, 3)))
                      for b in EXPORT_BATCHES.get(name, (BATCH,))]
            cases.append({"name": name, "path": path, "shapes": shapes, "seed": seed})
            runs = []
            for shp in shapes:
                x = export_input(shp, seed)
                kernels.reset_launch_counts()
                with torch.no_grad():
                    y = model(x, mode="fixed", quant_w=quant_w)
                torch.cuda.synchronize()
                runs.append((kernels.launch_counts(), y.cpu()))
            # PyTorch launches of the live forward and of the artifact, side
            # by side in this process under the cuDNN settings the artifact
            # runs under (serving.export.conv_flags); the serving process's
            # count is printed beside as a record (a fresh process's
            # libraries pick a copy kernel more or less now and then)
            x = export_input(shapes[-1], seed)
            fn = load_exported(path, device="cuda")
            tf32 = conv_tf32(model)

            def live_fwd(m=model, q=quant_w, xx=x, t=tf32):
                with conv_flags(t):
                    return m(xx, mode="fixed", quant_w=q)
            prof = profile_calls({"live": live_fwd, "artifact": lambda f=fn, xx=x: f(xx)})
            live[name] = {"model": model, "quant_w": quant_w, "runs": runs,
                          "export_s": export_s, "shape": shape,
                          "mb": os.path.getsize(path) / 2 ** 20,
                          "profile": prof}
            del fn
        spec = os.path.join(tmp, "spec.json")
        with open(spec, "w") as f:
            json.dump({"dir": tmp, "cases": cases}, f)
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
             "import chip_smoke; chip_smoke.serve_artifacts(sys.argv[2])", ROOT, spec],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        serve_s = time.perf_counter() - t0
        if done.returncode != 0:
            print(done.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the serving process exited {done.returncode}")
        served = json.loads(done.stdout.strip().splitlines()[-1])
        # model code, or anything of the JAX package
        model_code = [m for m in served["modules"]
                      if m.startswith(("fp8_quantization_tpu_torch.models",
                                       "fp8_quantization_tpu_torch.nn.layers"))
                      or m.split(".")[0] == "fp8_quantization_tpu"]
        ok = not model_code
        for case in cases:
            name, lv, sv = case["name"], live[case["name"]], served["cases"][case["name"]]
            bits, diffs = [], []
            for shp, (counts, y) in zip(case["shapes"], lv["runs"]):
                art = torch.load(os.path.join(tmp, f"{name}_{shp[0]}.pt"))
                bits.append(bool(torch.equal(art, y)))
                diffs.append(float((art - y).abs().max()))
            launches_equal = [c == s for (c, _), s in zip(lv["runs"], sv["launches"])]
            case_ok = (all(bits) and all(launches_equal)
                       and lv["profile"]["artifact"]["calls"] <= lv["profile"]["live"]["calls"])
            ok &= case_ok
            for counts in sv["launches"]:
                add_launches(results, counts)
            emit({"phase": "export_model", "model": name, "ok": case_ok,
                  "input_shape": lv["shape"], "batches": [s[0] for s in case["shapes"]],
                  "export_s": lv["export_s"], "artifact_mb": lv["mb"],
                  "load_s": sv["load_s"], "logits_bit_equal": bits,
                  "max_abs_diff": max(diffs), "launches_live": [c for c, _ in lv["runs"]],
                  "launches_artifact": sv["launches"],
                  "kernel_launches_equal": launches_equal,
                  "torch_launches_per_forward": {
                      "live": lv["profile"]["live"]["calls"],
                      "artifact": lv["profile"]["artifact"]["calls"],
                      "artifact_in_serving_process": sv["profile"]["calls"]},
                  "device_records_per_forward": {
                      "live": lv["profile"]["live"]["records"],
                      "artifact": lv["profile"]["artifact"]["records"],
                      "artifact_in_serving_process": sv["profile"]["records"]},
                  "launch_names_differing": names_differing(
                      lv["profile"]["live"]["names"], lv["profile"]["artifact"]["names"]),
                  "serving_process_names_differing": names_differing(
                      lv["profile"]["artifact"]["names"], sv["profile"]["names"])})
        # the symbolic-batch artifact against the live model, in turns
        sym = live["resnet18_fp8"]
        fn = load_exported(cases[0]["path"], device="cuda")
        x = export_input([BATCH, 224, 224, 3], 0)
        turns = {"artifact": [], "live": []}
        calls = {"artifact": lambda: fn(x),
                 "live": lambda: sym["model"](x, mode="fixed", quant_w=False)}
        with torch.no_grad():
            for order in (("artifact", "live"), ("live", "artifact")) * THROUGHPUT_TURNS:
                for k in order:
                    turns[k].append(time_ms(calls[k], iters=THROUGHPUT_ITERS))
        rate = {k: {"ms": v, "images_per_s": BATCH / statistics.median(v) * 1e3}
                for k, v in turns.items()}
        emit({"phase": "export", "ok": ok, "serving_modules_model_code": model_code,
              "serve_s": serve_s, "resnet18_fp8_b64_turns": rate,
              "s": time.perf_counter() - t_phase})
        return ok
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- parallel: two ranks on the one card -------------------------------------

PAR_BATCH = 128                    # global batch of sub-runs (a) and (b)
PAR_TIMEOUT = 420                  # seconds each rank process may take
PAR_RANKS = 2


def _cli_with(cli, **flags):
    """``cli`` with each ``--flag value`` of ``flags`` set (added or
    replaced; underscores become dashes)."""
    out = list(cli)
    for k, v in flags.items():
        opt = "--" + k.replace("_", "-")
        if opt in out:
            out[out.index(opt) + 1] = str(v)
        else:
            out += [opt, str(v)]
    return out


# (a) ResNet-18 FP8 PTQ, (b) the MSE search (config 3), (c) weight-gather
# tensor parallelism, (d) MobileNetV2 FP8 QAT (config 5); each sub-run is
# (its command, its flags over two ranks)
PAR_RUNS = {
    "a": (_cli_with(CLI_ARGS, batch_size=PAR_BATCH, max_eval_batches=1),
          ["--data-parallel", "2"]),
    "b": (_cli_with(CLI_ARGS, batch_size=PAR_BATCH, max_eval_batches=1,
                    weight_quant_method="MSE", act_quant_method="MSE"),
          ["--data-parallel", "2"]),
    "c": (_cli_with(CLI_ARGS, max_eval_batches=1), ["--model-parallel", "2"]),
    "d": (_cli_with(QAT_CLI_ARGS, batch_size=16, max_train_batches=2,
                    max_eval_batches=1), ["--data-parallel", "2"]),
}


def _quant_state(model):
    """{module.name: tensor on the host} of every quantizer's and
    estimator's state."""
    from fp8_quantization_tpu_torch.nn.quantizers import Quantizer
    out = {}
    for name, qz in model.named_modules():
        if isinstance(qz, Quantizer):
            for k, v in list(qz.state().items()) + [
                    ("est_" + k, v) for k, v in qz.est_state().items()]:
                out[f"{name}.{k}"] = v.detach().cpu().clone()
    return out


def _digest(model):
    """sha256 of every tensor of ``model``'s state dict, in order."""
    import hashlib

    import torch
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


class RunCapture:
    """While active, what a CLI run of the parallel phase leaves: the
    quantizer state as calibration (or training) left it, the head's output
    quant constants, each evaluation batch's logits, the collectives and
    seconds of sharded calibration, the deployed model's parameter bytes
    (at rest, in the operand caches, gathered) and the launch counts at the
    end of the evaluation; under a mesh, the deployed model's logits of the
    whole first evaluation batch in this process alone (after the counts
    are read); under train-quantized the weights at init and as trained,
    and a digest of the whole model state after each step.  With
    ``deploy=False`` the run ends where the deployment would begin (its
    metrics are then empty)."""

    def __init__(self, deploy=True):
        from fp8_quantization_tpu_torch.parallel import collectives
        self.deploy = deploy
        self.stats = collectives.CollectiveStats()
        self.logits, self.digests, self.calibrate_s = [], [], []
        self.quant = self.consts = self.init = self.trained = self.bytes = None
        self.quant_w = self.launches = self.whole_batch_logits = None

    def __enter__(self):
        import torch
        from fp8_quantization_tpu_torch import parallel
        from fp8_quantization_tpu_torch.calibration import calibrate
        from fp8_quantization_tpu_torch.cli import image_net
        from fp8_quantization_tpu_torch.parallel import api
        from fp8_quantization_tpu_torch.training import qat
        self.saved = []

        def patch(mod, attr, make):
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))
            setattr(mod, attr, make(fn))

        def weights(model):
            return {k: v.detach().cpu().clone() for k, v in model.named_parameters()
                    if k.endswith(".weight")}

        def deploy(fn):
            def run(model, args, cal, val, device, mesh=None):
                from fp8_quantization_tpu_torch.ops import kernels
                with api.gather_weights(mesh, model):
                    self.quant = _quant_state(model)
                    if hasattr(model, "fc"):
                        self.consts = model.fc.act_q.act_consts()[1].cpu()
                    if self.init is not None:
                        self.trained = weights(model)
                if not self.deploy:
                    return {}
                out = fn(model, args, cal, val, device, mesh)
                torch.cuda.synchronize()
                self.launches = kernels.launch_counts()
                if mesh is not None:
                    x = torch.as_tensor(next(iter(val))[0]).to(device)
                    with torch.no_grad(), api.gather_weights(mesh, model):
                        self.whole_batch_logits = model(
                            x, mode="fixed", quant_w=self.quant_w).float().cpu()
                rest = api.state_bytes(model)
                with api.gather_weights(mesh, model):
                    full = api.state_bytes(model)
                self.bytes = {"at_rest": rest, "gathered": full,
                              "operand_cache": api.operand_cache_bytes(model),
                              "cuda_max_allocated": torch.cuda.max_memory_allocated()}
                return out
            return run

        def keep_logits(fn):
            def run(logits, y):
                self.logits.append(logits.detach().float().cpu())
                return fn(logits, y)
            return run

        def sharded(fn):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw, stats=self.stats)
                torch.cuda.synchronize()
                self.calibrate_s.append(time.perf_counter() - t0)
                return out
            return run

        def bake(fn):
            def run(*a, **kw):
                self.quant_w = fn(*a, **kw)
                return self.quant_w
            return run

        def init(fn):
            def run(model, *a, **kw):
                state = fn(model, *a, **kw)
                self.init = weights(model)
                return state
            return run

        def make_step(fn):
            def make(*a, **kw):
                step = fn(*a, **kw)

                def digested(state, x, y):
                    out = step(state, x, y)
                    self.digests.append(_digest(state.model))
                    return out
                return digested
            return make

        patch(image_net, "deploy_and_evaluate", deploy)
        patch(image_net, "bake_for_eval", bake)
        patch(calibrate, "batch_stats", keep_logits)
        patch(parallel, "calibrate_sharded", sharded)
        patch(qat, "init_qat_state", init)
        patch(qat, "make_train_step", make_step)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)


def capture_cli_run(cli, deploy=True):
    """Run ``cli`` (validate-quantized or train-quantized) through the
    CLI's entry points with the launch counts zeroed just before and read
    just after: {metrics, launches, seconds, and what RunCapture kept}
    (``deploy``: RunCapture's)."""
    import torch
    from fp8_quantization_tpu_torch.cli import image_net
    from fp8_quantization_tpu_torch.ops import kernels
    args = image_net.build_parser().parse_args(cli)
    run = (image_net.validate_quantized if args.command == "validate-quantized"
           else image_net.train_quantized)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with RunCapture(deploy) as cap:
        metrics = run(args)
    torch.cuda.synchronize()
    return {"metrics": metrics, "launches": cap.launches or kernels.launch_counts(),
            "whole_batch_logits": cap.whole_batch_logits,
            "s": time.perf_counter() - t0, "quant": cap.quant, "consts": cap.consts,
            "logits": cap.logits, "init": cap.init, "trained": cap.trained,
            "digests": cap.digests, "bytes": cap.bytes,
            "collectives": {"count": cap.stats.count, "elements": cap.stats.elements,
                            "s": cap.stats.seconds, "calibrate_s": cap.calibrate_s}}


def qat_layer_cosines(cli):
    """(d)'s step layer by layer with pinned inputs, as qat_check holds
    the card against the CPU: from one calibrated state of ``cli``'s model
    with its ranges trainable, each quantized layer's learn-mode forward
    with batch statistics on the input one process's forward gives it,
    against a fixed cotangent, once on the whole batch in this process
    alone and once on this rank's rows over the data group (BN's
    statistics reduced, the gradients averaged): {layer:gradient: cosine}
    of the two (the input's gradient on this rank's rows)."""
    import copy

    import torch
    from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
    from fp8_quantization_tpu_torch.cli import image_net
    from fp8_quantization_tpu_torch.data.imagenet import make_dataloaders
    from fp8_quantization_tpu_torch.parallel import (
        batch_sharding, collectives, make_mesh)
    from fp8_quantization_tpu_torch.training import qat
    args = image_net.build_parser().parse_args(cli)
    image_net.seed_run(args)
    model = image_net.build_model(args)
    train, _ = make_dataloaders(None, batch_size=args.batch_size, seed=args.seed)
    x, _ = next(iter(train))
    x = torch.as_tensor(x).cuda()
    calibrate(model, [x], device="cuda", num_batches=1)
    for path, names in qat.quant_trainable_mask(model, model.config).items():
        model.get_submodule(path).make_range_trainable(names)
    mesh = make_mesh(data=PAR_RANKS, model=1)
    rows = batch_sharding(mesh)
    cos = {}
    for k, (name, inp) in enumerate(_layer_inputs(copy.deepcopy(model), x).items()):
        layer = model.get_submodule(name)
        ref = _layer_grads(copy.deepcopy(layer), inp, k)
        dp = copy.deepcopy(layer)
        xr = rows(inp).clone().requires_grad_()
        with collectives.reducing_over(mesh.data_group):
            y = dp(xr, mode="learn", train_bn=True)
            g = torch.randn((y.shape[0] * PAR_RANKS,) + tuple(y.shape[1:]),
                            generator=torch.Generator().manual_seed(k)).to(y.device)
            (y * rows(g)).sum().backward()
            collectives.average_gradients(dp.parameters())
        got = {n: p.grad for n, p in dp.named_parameters() if p.grad is not None}
        got["input"], ref["input"] = xr.grad, rows(ref["input"])
        for n, gr in ref.items():
            if float(gr.norm()) > 0:
                cos[f"{name}:{n}"] = _cosine(got[n], gr)
    return cos


def parallel_rank(out_dir, names):
    """One rank of the parallel phase (its rank in torchrun's environment
    variables): each sub-run of ``names`` through the CLI with its mesh
    flags, its results saved to ``out_dir/<name>_rank<r>.pt``; after (d),
    its step layer by layer (qat_layer_cosines); then it leaves the
    group."""
    import torch
    from fp8_quantization_tpu_torch.ops.kernels.common import no_tf32
    from fp8_quantization_tpu_torch.parallel import multihost
    rank = int(os.environ["RANK"])
    for name in names.split(","):
        cli, mesh_flags = PAR_RUNS[name]
        with no_tf32():
            res = capture_cli_run(cli + mesh_flags)
            if name == "d":
                res["layer_cosines"] = qat_layer_cosines(cli)
        torch.save(res, os.path.join(out_dir, f"{name}_rank{rank}.pt"))
        print(f"rank {rank}: {name} done in {res['s']:.1f} s", flush=True)
    multihost.shutdown()


class OneRankSums:
    """parallel.collectives as BN reads it inside a scope of one rank:
    BN's statistics by the ranks' two-pass sums, nothing reduced."""

    @staticmethod
    def active():
        return True

    @staticmethod
    def size():
        return 1

    @staticmethod
    def all_sum_grad(t):
        return t


def nccl_rank(out_dir):
    """Sub-run (e): a one-rank NCCL group (initialize), one all_reduce on
    the card, then (a)'s calibration at world size 1 through
    calibrate_sharded on the 1 x 1 mesh, its quantizer state saved."""
    import torch
    import torch.distributed as dist
    from fp8_quantization_tpu_torch.cli import image_net
    from fp8_quantization_tpu_torch.data.imagenet import make_dataloaders
    from fp8_quantization_tpu_torch.ops.kernels.common import no_tf32
    from fp8_quantization_tpu_torch.parallel import (
        calibrate_sharded, initialize, make_mesh)
    t0 = time.perf_counter()
    info = initialize(f"tcp://localhost:{os.environ['MASTER_PORT']}",
                      world_size=1, rank=0, device="cuda")
    backend = dist.get_backend()
    t = torch.arange(4.0, device="cuda")
    dist.all_reduce(t)
    args = image_net.build_parser().parse_args(PAR_RUNS["a"][0])
    image_net.seed_run(args)
    with no_tf32():
        model = image_net.build_model(args)
        train, _ = make_dataloaders(None, batch_size=args.batch_size, seed=args.seed)
        calibrate_sharded(model, train, make_mesh(1, 1), device="cuda", num_batches=1)
    torch.cuda.synchronize()
    torch.save({"info": info, "backend": backend, "all_reduce": t.cpu(),
                "quant": _quant_state(model), "s": time.perf_counter() - t0},
               os.path.join(out_dir, "e_rank0.pt"))
    dist.destroy_process_group()


class Ranks:
    """``n`` rank processes running ``body`` (Python source that imports
    chip_smoke) with torchrun's variables (gloo for two ranks on one card;
    the kernel gate's 'always'), their output in files of ``out_dir``;
    ``wait`` gives each its own timeout: (ok, seconds, the ranks'
    tails)."""

    def __init__(self, n, body, out_dir, tag):
        import socket
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        self.t0 = time.perf_counter()
        self.procs, self.logs = [], []
        for r in range(n):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                       LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), FP8TPU_PALLAS_AUTOTUNE="always")
            log = open(os.path.join(out_dir, f"{tag}_rank{r}.log"), "w+")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", f"import sys; sys.path.insert(0, {ROOT!r}); "
                 f"import chip_smoke; {body}"], cwd=ROOT, env=env,
                stdout=log, stderr=subprocess.STDOUT, text=True))

    def wait(self):
        tails, ok = [], True
        try:
            for p, log in zip(self.procs, self.logs):
                try:
                    p.wait(timeout=max(1.0, self.t0 + PAR_TIMEOUT - time.perf_counter()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
                log.seek(0)
                tails.append({"rc": p.returncode, "tail": log.read()[-3000:]})
                ok &= p.returncode == 0
        finally:
            for p, log in zip(self.procs, self.logs):
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        return ok, time.perf_counter() - self.t0, tails


def gemm_rows_witness():
    """Whether cuBLAS's float32 product at ResNet-18's fc shape (K = 512,
    N = 1,000, operands exact in bf16, TF32 off) gives the first rows of a
    PAR_BATCH-row product bit for bit when it multiplies one rank's rows
    alone: the per-rank batch of (a) against the single process's."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(SEED)
    a = torch.randn(PAR_BATCH, 512, device="cuda", generator=g).bfloat16().float()
    w = torch.randn(1000, 512, device="cuda", generator=g).bfloat16().float()
    rows = PAR_BATCH // PAR_RANKS
    part, alone = F.linear(a, w)[:rows], F.linear(a[:rows], w)
    return {"bit_equal": bool(torch.equal(part, alone)),
            "equal_share": float((part == alone).float().mean()),
            "max_rel_gap": float(((part - alone).abs()
                                  / part.abs().clamp(min=1e-30)).max())}


def _exact_equal(a, b):
    """(all equal, keys that differ, largest relative gap)."""
    diff, worst = [], 0.0
    for k in a:
        if not (a[k].shape == b[k].shape and bool((a[k] == b[k]).all())):
            diff.append(k)
            den = b[k].float().abs().clamp(min=1e-30)
            worst = max(worst, float(((a[k].float() - b[k].float()).abs() / den).max()))
    return not diff and a.keys() == b.keys(), diff[:8], worst


def _mse_check(dp, single, rtol=1e-5):
    """(ok, worst table gap, picks compared, picks differing) of (b): every
    MSE table within rtol of one process's, the voted M equal, and each
    channel's maxval equal wherever its two best candidates' errors differ
    by more than rtol."""
    import torch
    worst, compared, differ, ok = 0.0, 0, [], True
    for k, t in dp.items():
        if k.endswith(".mantissa_bits"):
            ok &= bool(torch.equal(t, single[k]))
        if not k.endswith(".est_mses"):
            continue
        ref = single[k]
        gap = float(((t - ref).abs() / ref.abs().clamp(min=1e-30)).max())
        worst = max(worst, gap)
        ok &= bool(torch.allclose(t, ref, rtol=rtol, atol=0.0))
        best = t.amin(dim=0)                                  # (n, C)
        top2 = torch.sort(best, dim=0).values[:2]
        clear = (top2[1] - top2[0]) > rtol * top2[1].abs()
        base = k[:-len(".est_mses")]
        mv, mv_ref = dp[base + ".maxval"].reshape(-1), single[base + ".maxval"].reshape(-1)
        for c in torch.nonzero(clear.reshape(-1)).reshape(-1).tolist():
            compared += 1
            if mv.numel() > 1 and mv[c] != mv_ref[c] or mv.numel() == 1 and mv[0] != mv_ref[0]:
                differ.append(f"{base}[{c}]")
    return ok and not differ, worst, compared, differ


def phase_parallel(results):
    """Distribution (parallel/) on the one card: two ranks as torchrun
    would start them (gloo, both on cuda:0), each through the CLI with its
    mesh flags, against one process on the same card running the same
    command at the same global batch (in this process, launch counts and
    all).  (a) ResNet-18 FP8 PTQ at --data-parallel 2, global batch 128:
    every quantizer's state bit-equal to the single process's, top-1 and
    top-5 equal, loss within rtol 1e-5, each rank's deployed logits held
    against its rows of the single process's as phase 2 holds a kernel.
    (b) the same with the MSE search: tables within rtol 1e-5, the voted M
    and each clear pick equal.  (c) --model-parallel 2 at batch 64: logits
    bit-equal, each rank's parameter bytes at rest and gathered.  (d)
    MobileNetV2 FP8 QAT (config 5) at --data-parallel 2, global batch 16,
    2 steps: after each step the ranks' whole state bit-equal (digests),
    each layer's weight update at cosine >= 0.99 with the single process's,
    then deployed on 'fused' (17 qblock and 2 qmatmul launches a deployed
    forward).  (e) a one-rank NCCL group: one all_reduce on the card and
    (a)'s calibration at world size 1 bit-equal to (a)'s single process.
    Every rank runs in a subprocess under its own timeout, one pair of
    ranks running (a) to (d) in turn; the ranks' launches are added to the
    kernels line.  Prints each sub-run's seconds
    and the collectives (count, seconds) of a calibration forward, a
    record: one card shows no scaling."""
    import shutil
    import tempfile

    import torch
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="fp8tpu_parallel_")
    try:
        from fp8_quantization_tpu_torch.nn import layers
        # the ranks and the NCCL rank run while this process computes the
        # references, so their seconds overlap (a record only)
        names = ",".join(PAR_RUNS)
        gloo = Ranks(PAR_RANKS, f"chip_smoke.parallel_rank({tmp!r}, {names!r})",
                     tmp, "gloo")
        nccl = Ranks(1, f"chip_smoke.nccl_rank({tmp!r})", tmp, "nccl")
        single = {}
        try:
            for name, (cli, _) in PAR_RUNS.items():
                single[name] = capture_cli_run(cli)
            # (d)'s floor: one process whose BN sums as the ranks do, up to
            # its trained weights
            saved, layers.collectives = layers.collectives, OneRankSums
            try:
                single["d_floor"] = capture_cli_run(PAR_RUNS["d"][0], deploy=False)
            finally:
                layers.collectives = saved
            witness = gemm_rows_witness()
        finally:
            ok_ranks, ranks_s, tails = gloo.wait()
            ok_e, _, e_tails = nccl.wait()
        if not (ok_ranks and ok_e):
            emit({"phase": "parallel", "ok": False, "ranks": tails, "nccl": e_tails})
            return False
        ranks = {name: [torch.load(os.path.join(tmp, f"{name}_rank{r}.pt"),
                                   weights_only=False) for r in range(PAR_RANKS)]
                 for name in PAR_RUNS}
        e = torch.load(os.path.join(tmp, "e_rank0.pt"), weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    ok = True
    for name, runs in ranks.items():
        for r in runs:
            add_launches(results, r["launches"])

    def metrics_ok(runs, ref):
        m = [r["metrics"] for r in runs]
        return (all(x["top_1_accuracy"] == ref["top_1_accuracy"]
                    and x["top_5_accuracy"] == ref["top_5_accuracy"]
                    and x["num_examples"] == ref["num_examples"]
                    and abs(x["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"]) for x in m))

    # (a) and (b): data-parallel PTQ
    line = {}
    for name in ("a", "b"):
        runs, ref = ranks[name], single[name]
        state_eq = [_exact_equal(r["quant"], ref["quant"]) for r in runs]
        rows = ref["logits"][0].shape[0] // PAR_RANKS

        def part(t, i):
            return t[i * rows:(i + 1) * rows]
        # each rank's logits against one process deploying the same state
        # (the evaluation alone), then against the single process's
        same = [grid_check(r["logits"][0], part(r["whole_batch_logits"], i),
                           r["consts"], False) for i, r in enumerate(runs)]
        against = []
        for i, r in enumerate(runs):
            a, b = r["logits"][0], part(ref["logits"][0], i)
            within = bool(torch.isfinite(a).all()) and bool(
                ((a - b).abs() <= grid_step(a, b, ref["consts"], False)).all())
            against.append({"within_one_step": within,
                            "exact_share": float((a == b).float().mean()),
                            "max_abs_err": float((a - b).abs().max()),
                            "top1_equal": float((a.argmax(-1) == b.argmax(-1)).float().mean())})
        want = expected_launches(RESNET_FP8_LAUNCHES, forwards=2)
        sub = {"s": [r["s"] for r in runs], "single_s": ref["s"],
               "metrics": runs[0]["metrics"], "single_metrics": ref["metrics"],
               "metrics_ok": metrics_ok(runs, ref["metrics"]),
               "launches_ok": all(r["launches"] == want for r in runs),
               "quant_state_bit_equal": [s[0] for s in state_eq],
               "quant_state_differing": [s[1] for s in state_eq],
               "quant_state_max_rel_gap": [s[2] for s in state_eq],
               "logits_vs_same_state_ok": [g[0] for g in same],
               "logits_vs_same_state_exact_share": [g[2] for g in same],
               "logits_vs_single": against,
               "collectives_per_calibration_forward": [r["collectives"] for r in runs]}
        sub_ok = (sub["metrics_ok"] and sub["launches_ok"] and all(g[0] for g in same)
                  and all(c["within_one_step"] and c["top1_equal"] >= 0.99 for c in against))
        if name == "a":
            # min and max are order-free, but cuBLAS may sum a GEMM of one
            # rank's rows in another order than of all of them (the
            # witness): the state is held at JAX's own bound
            # (tests/test_parallel.py), its bit-equality printed
            sub["fc_gemm_rows_witness"] = witness
            sub["quant_state_within_jax_bound"] = [all(
                torch.allclose(r["quant"][k].float(), ref["quant"][k].float(),
                               rtol=1e-6, atol=1e-7) for k in ref["quant"]) for r in runs]
            sub_ok &= all(sub["quant_state_within_jax_bound"])
        else:
            checks = [_mse_check(r["quant"], ref["quant"]) for r in runs]
            sub.update(mse_ok=[c[0] for c in checks], mse_table_max_rel_gap=[c[1] for c in checks],
                       mse_picks_compared=[c[2] for c in checks],
                       mse_picks_differing=[c[3][:8] for c in checks])
            sub_ok &= all(c[0] for c in checks)
        sub["ok"] = sub_ok
        line[name] = sub
        ok &= sub_ok

    # (c) tensor parallelism
    runs, ref = ranks["c"], single["c"]
    want = expected_launches(RESNET_FP8_LAUNCHES, forwards=2)
    bits = [bool(torch.equal(r["logits"][0], ref["logits"][0])) for r in runs]
    line["c"] = {"s": [r["s"] for r in runs], "single_s": ref["s"], "logits_bit_equal": bits,
                 "metrics_ok": metrics_ok(runs, ref["metrics"]),
                 "launches_ok": all(r["launches"] == want for r in runs),
                 "param_bytes_per_rank": [r["bytes"] for r in runs],
                 "param_bytes_single": ref["bytes"]}
    line["c"]["ok"] = (all(bits) and line["c"]["metrics_ok"] and line["c"]["launches_ok"]
                       and all(r["bytes"]["at_rest"] < ref["bytes"]["at_rest"] for r in runs))
    ok &= line["c"]["ok"]

    # (d) data-parallel QAT
    import statistics
    runs, ref = ranks["d"], single["d"]
    want = expected_launches(MNV2_LAUNCHES["fp32_after"], forwards=2)

    def update_cosines(run):
        return [_cosine(run["trained"][k] - run["init"][k], w - ref["init"][k])
                for k, w in ref["trained"].items()
                if float((w - ref["init"][k]).norm()) > 0]
    e2e = {"ranks": update_cosines(runs[0]), "one_process_floor": update_cosines(single["d_floor"])}
    layer_cos = runs[0]["layer_cosines"]
    low = {k: c for r in runs for k, c in r["layer_cosines"].items() if c < 0.99}
    digests_equal = runs[0]["digests"] == runs[1]["digests"] and len(runs[0]["digests"]) == 2
    line["d"] = {"s": [r["s"] for r in runs], "single_s": ref["s"],
                 "state_bit_equal_after_each_step": digests_equal,
                 "layer_gradients_compared": len(layer_cos),
                 "min_layer_gradient_cosine": min(min(r["layer_cosines"].values()) for r in runs),
                 "below_0.99": low,
                 "update_cosine_end_to_end": {k: {"min": min(v), "median": statistics.median(v)}
                                              for k, v in e2e.items()},
                 "metrics": runs[0]["metrics"],
                 "single_metrics": ref["metrics"],
                 "launches_ok": all(r["launches"] == want for r in runs),
                 "launches": runs[0]["launches"],
                 "collectives_calibration": [r["collectives"] for r in runs]}
    line["d"]["ok"] = (digests_equal and not low and line["d"]["launches_ok"]
                       and all(math.isfinite(r["metrics"]["loss"]) for r in runs))
    ok &= line["d"]["ok"]

    # (e) a one-rank NCCL group
    e_eq = _exact_equal(e["quant"], single["a"]["quant"])
    line["e"] = {"s": e["s"], "backend": e["backend"], "info": e["info"],
                 "all_reduce": e["all_reduce"].tolist(), "quant_state_bit_equal": e_eq[0],
                 "quant_state_differing": e_eq[1]}
    line["e"]["ok"] = (e["backend"] == "nccl" and e_eq[0]
                       and e["all_reduce"].tolist() == [0.0, 1.0, 2.0, 3.0])
    ok &= line["e"]["ok"]
    emit({"phase": "parallel", "ok": ok, "ranks": PAR_RANKS, "backend": "gloo",
          "ranks_s": ranks_s, "sub_runs": line, "s": time.perf_counter() - t_phase})
    return ok


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from fp8_quantization_tpu_torch.ops.kernels import autotune, build
    from fp8_quantization_tpu_torch.ops.kernels.common import no_tf32

    ok_all = True
    smi = smi_line()
    build_s = build.build_all()
    emit({"phase": "env", "ok": True, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc_version(),
          "device": torch.cuda.get_device_name(0), "build_s": build_s})

    results = {}
    slice_out = {}
    captures, vit_captures, r50_captures = {}, {}, {}

    def run_slice():
        ok, fused, bf16 = phase_slice(results)
        slice_out.update(fused=fused, bf16=bf16)
        return ok

    def run_int8_slice():
        ok, slice_out["int8"] = phase_int8_slice(results)
        return ok

    def run_mnv2_slice(bn_mode):
        ok, slice_out[bn_mode], slice_out[bn_mode + "_bf16"] = phase_slice(
            results, f"mnv2_{bn_mode}_slice", mnv2_cli_args(bn_mode),
            MNV2_LAUNCHES[bn_mode], "classifier", 0.01, captures)
        return ok

    def keep_models(label, out):
        ok, slice_out[label], slice_out[label + "_bf16"] = out
        return ok

    def run_vit_slice():
        ok, slice_out["vit"], slice_out["vit_bf16"] = phase_vit_slice(
            results, vit_captures)
        return ok

    vit_phases = [
        ("vit_slice", run_vit_slice),
        ("vit_check", lambda: phase_vit_check(results, vit_captures)),
        ("vit_throughput", lambda: phase_throughput(
            slice_out["vit"], slice_out["vit_bf16"], "vit_throughput", (BATCH,)) or True),
        ("vit_profile", lambda: phase_profile(
            slice_out["vit"], "vit_profile", kernel_names=("flash_mha", "qmatmul"),
            unprepared=UNPREPARED.get("vit_slice")))]

    mnv2_phases = []
    for bn_mode, kernel_names in (("fp32_after", ("qblock", "qmatmul")),
                                  ("folded", ("qdwconv3x3", "qmatmul"))):
        mnv2_phases += [
            (f"mnv2_{bn_mode}_slice", lambda m=bn_mode: run_mnv2_slice(m)),
            (f"mnv2_{bn_mode}_throughput", lambda m=bn_mode: phase_throughput(
                slice_out[m], slice_out[m + "_bf16"], f"mnv2_{m}_throughput",
                (BATCH,)) or True),
            (f"mnv2_{bn_mode}_profile", lambda m=bn_mode, k=kernel_names: phase_profile(
                slice_out[m], f"mnv2_{m}_profile", kernel_names=k,
                unprepared=UNPREPARED.get(f"mnv2_{m}_slice")))]

    def run_mse_slice(label, cli):
        ok, slice_out[label], slice_out[label + "_bf16"] = phase_slice(
            results, label, cli, RESNET_FP8_LAUNCHES, "fc", 0.01,
            unbaked=RESNET_FP8_UNBAKED)
        return ok

    mse_phases = []
    for label, cli in (("mse_slice", MSE_CLI_ARGS), ("mse_e4m3_slice", MSE_E4M3_CLI_ARGS)):
        mse_phases += [
            (label, lambda k=label, c=cli: run_mse_slice(k, c)),
            (label.replace("slice", "throughput"), lambda k=label: phase_throughput(
                slice_out[k], slice_out[k + "_bf16"], k.replace("slice", "throughput"),
                (BATCH,)) or True),
            (label.replace("slice", "profile"), lambda k=label: phase_profile(
                slice_out[k], k.replace("slice", "profile"),
                unprepared=UNPREPARED.get(k)))]

    def run_r50_slice():
        ok, slice_out["r50"], slice_out["r50_bf16"] = phase_slice(
            results, "r50_slice", R50_CLI_ARGS, RESNET50_FP8_LAUNCHES, "fc", 0.01,
            r50_captures)
        return ok

    r50_phases = [
        ("r50_slice", run_r50_slice),
        ("r50_throughput", lambda: phase_throughput(
            slice_out["r50"], slice_out["r50_bf16"], "r50_throughput", (BATCH,)) or True),
        ("r50_profile", lambda: phase_profile(
            slice_out["r50"], "r50_profile", unprepared=UNPREPARED.get("r50_slice"))),
        ("r50_check", lambda: phase_r50_check(r50_captures))]

    phases = [("check", lambda: phase_check_and_time(results)),
              ("mbits_check", lambda: phase_mbits_check(results)),
              ("int8_check", lambda: phase_int8_check(results)),
              ("batch256", phase_batch256),
              ("slice", run_slice),
              ("int8_slice", run_int8_slice),
              ("throughput", lambda: phase_throughput(slice_out["fused"],
                                                      slice_out["bf16"]) or True),
              ("int8_throughput", lambda: phase_int8_throughput(slice_out["int8"]) or True),
              ("profile", lambda: phase_profile(
                  slice_out["fused"], unprepared=UNPREPARED.get("slice"))),
              ("int8_profile", lambda: phase_profile(
                  slice_out["int8"], "int8_profile", quant_w=True,
                  kernel_names=("qconv3x3_int8", "qmatmul_int8"),
                  unprepared=UNPREPARED.get("int8_slice")))]
    phases += mnv2_phases + [("mnv2_check", lambda: phase_mnv2_check(results, captures))]
    phases += int_phases(results, slice_out)
    phases += vit_phases
    for label, run in (("vit_int8", phase_vit_int8_slice),
                       ("mnv2_int8_qi", phase_mnv2_int8_qi_slice)):
        phases += [
            (label + "_slice", lambda k=label, f=run: keep_models(k, f(results))),
            (label + "_throughput", lambda k=label: phase_throughput(
                slice_out[k], slice_out[k + "_bf16"], k + "_throughput", (BATCH,),
                quant_w=True) or True)]
    phases += [("layer_options_check", lambda: phase_layer_options_check(results))]
    phases += [("batch256_block_attn", lambda: phase_batch256_block_attn(captures))]
    phases += mse_phases
    phases += [("mse_e5m2_slice", lambda: run_mse_slice("mse_e5m2_slice", MSE_E5M2_CLI_ARGS))]
    phases += r50_phases + [("s2d_check", lambda: phase_s2d_check(slice_out))]
    phases += [("qat_slice", lambda: phase_qat_slice(results)),
               ("qat_check", phase_qat_check),
               ("sqnr_study", phase_sqnr_study),
               ("cast_check", phase_cast_check),
               ("deploy_rows", lambda: phase_deploy_rows(results)),
               ("gate", lambda: phase_gate(results)),
               ("checkpoint", lambda: phase_checkpoint(results)),
               ("export", lambda: phase_export(results, slice_out)),
               ("parallel", lambda: phase_parallel(results))]
    for name, fn in phases:
        t0 = time.perf_counter()
        # every phase but gate launches each kernel of its path, as before
        # the gate: the gate's research escape hatch (phase_gate sets auto)
        autotune.MODE = "always"
        try:
            with no_tf32():
                ok = bool(fn())
        except Exception:  # noqa: BLE001 - report the phase and go on
            traceback.print_exc()
            ok = False
        emit({"phase": name + "_done", "ok": ok, "s": time.perf_counter() - t0})
        ok_all &= ok

    table = kernel_table()
    rows = []
    for name, (_, _, mod, source) in table.items():
        r = results.get(name, {})
        if "bytes_s" in r:      # the MobileNetV2 kernels: mixed operation types
            by = "bytes" if r["bytes_s"] > r["ops_s"] else "operations"
        else:
            by = bound_by(r.get("bytes", 0), r.get("flops", 0),
                          r.get("peak", BF16_FLOPS_PER_S))
        rows.append({"name": name, "route": "cuda",
                     "source": f"fp8_quantization_tpu_torch/csrc/{source}.cu",
                     "replaces": mod.REPLACES, "launches": r.get("launches"),
                     "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
                     "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
                     "bound_by": by, "library_ms": r.get("library_ms")})
        if name == "qmatmul_int8":      # row 2p: its s8 input branch
            r = results.get("qmatmul_int8_s8", {})
            rows.append({"name": "qmatmul_int8_s8", "route": "cuda",
                         "source": f"fp8_quantization_tpu_torch/csrc/{source}.cu",
                         "replaces": mod.REPLACES, "launches": r.get("launches"),
                         "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
                         "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
                         "bound_by": bound_by(r.get("bytes", 0), r.get("flops", 0),
                                              INT8_OPS_PER_S),
                         "library_ms": r.get("library_ms")})
    emit({"kernels": rows})
    print(smi, flush=True)
    if not ok_all:
        for obj in FAILED:
            print(json.dumps(obj)[:2000], file=sys.stderr)
        failed = [o["phase"][:-len("_done")] for o in FAILED
                  if o.get("phase", "").endswith("_done")]
        print(f"chip_smoke: a phase failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
