// GQA prefill attention with an online softmax, causal or not:
//   o[b, h, i] = softmax_{j <= i}(q[b, h, i] . k[b, h/G, j] / sqrt(D))
//                . v[b, h/G, j]
// fp32 arithmetic, the output in the input dtype (bf16 or fp32).  V may
// have its own head dim DV (MLA's decompressed heads: D = 192 with DV =
// 128, its smoke variant's 48 with 32), and a window W > 0 bands each row
// to keys j > i - W (hymba's sliding window of 2,048): the key tiles
// below a query block's band are never loaded, only the band's edge tiles
// are masked, so a banded pass costs O(S W) and not O(S^2).  Non-causal
// (causal = 0, no window): every one of the S query rows attends to all T
// keys, and T may differ from S (whisper's encoder, S = T = 1,500 audio
// frames, and its cross attention, 448 text rows over those 1,500 frames).
// Each block then runs all ceil(T / 64) key tiles; the last tile's keys
// past T are masked in the kernel (TMA fills them with zeros, whose score
// 0 is no -inf).  Key 0 lies in every block's first tile, so every row's
// running max is finite from there on.
//
// Replaces: repro/kernels/flash_attention.py::flash_attention_pallas
// (_flash_kernel): grid (batch, heads, query blocks), the query tile
// resident while K/V stream in chunks, the causal bound stopping the chunk
// loop at the diagonal, kv head h // G with no K/V repeat.  The reference
// runs MLA's, the window's, the encoder's and the cross attention through
// XLA (sdpa in repro/models/layers.py); here they stay on this kernel.
//
// One C entry, two kernels: bf16 inputs take the Hopper kernel (wgmma fed
// by a TMA ring, namespace hopper), fp32 inputs the SIMT kernel (namespace
// simt, with its own note).  Both mask with -1e30 (the reference's NEG),
// divide by max(l, 1e-30) and take the batch, head and sequence strides of
// q, k, v and o (the head dim contiguous), so the model's (B, S, H, D)
// projections go in and come out without a transpose; neither pads S.
//
// ---- bf16: the Hopper kernel ----
// What bounds it on an H100: the operations.  The causal products take
// 2 * B * H * D * S * (S + 1) FLOP (QK^T and PV over the lower triangle):
// 32 GFLOP at B = 1, H = 15, S = 4,096, D = 64, 0.033 ms at the bf16
// tensor-core peak (989 TFLOP/s), against 4 MB of Q, K, V and O (1.2 us at
// 3.35 TB/s).  The kernel issues twice that work on the tensor cores (P.V
// three times, below).  What holds it back at D = 64 is the loop itself
// more than the exponentials (chip_ab_flash.py --ablate on an H100, in
// PERF.md): with one P.V product, no split and a multiply in place of ex2
// it still takes 68% of its time at S = 32,768; the two extra P.V products
// cost 24% and the split 16%, and the multiply alone saves nothing.
//
// Numerics: the reference does all its arithmetic in fp32, P.V included,
// and the output has to stay within one bf16 ulp (+1e-6) of it.  Q.K^T on
// the bf16 operands with fp32 accumulators is exact in its products; the
// fp32 scores are scaled after the product (for D = 128, 1/sqrt(D) is not
// a power of two, so scaling Q in bf16 would round), as
// exp2(x * c - m * c) with c = log2(e) / sqrt(D) and one fma.  P is not a
// bf16 value: p = p_hi + p_mid + p_lo, each piece the top 8 significant
// bits of what is left (truncation, so each residual is exact), holds the
// fp32 p exactly, and three P.V products go into the same accumulators.
// Two pieces (2^-16 per weight) miss the 1e-6 floor near zero outputs (an
// emulation of the arithmetic on the CPU at the card tests' shapes).  The
// row sums take the fp32 p.
//
// Design:
//  - Grid (H * DVT / DV, B, ceil(S / 128)): block z takes query tile
//    n - 1 - z, so the longest causal rows of every head start first (in
//    a non-causal pass every block runs the same T keys: the order is
//    moot);
//    block x takes head x / (DVT / DV) and DV of V's DVT output columns
//    (DV = DVT up to 128; 128 at DVT = 256 and 64 at 192, whose whole O
//    accumulators do not fit beside the scores and the P pieces, so each
//    column block repeats the Q.K^T and the softmax).  288 threads: two
//    consumer warpgroups of 64 query rows each and one producer warp.
//  - The producer (one thread) loads the block's 128 x D Q tile once, then
//    the K and V tiles of BK = 64 keys into a ring of NS stages, with
//    cp.async.bulk.tensor (TMA): a "full" mbarrier per stage counts the
//    bytes in, an "empty" one (one arrival per consumer warp) frees the
//    stage for the next load.  The tensor maps describe each operand in
//    4-D (D, S, heads, B) with the caller's byte strides, so strided views
//    go in without a copy (every stride and base a multiple of 16 bytes:
//    the wrapper raises otherwise).  TMA fills keys past T and rows past
//    S with zeros and the kernel masks those keys.  SWIZZLE_128B: a 64-column bf16 row
//    is exactly one 128-byte span, tiles sit on 1,024-byte boundaries, and
//    wider rows load as D / 64 boxes of 64 columns (V as DV / 64: the
//    block's columns only).  D = 32 rows are 64 bytes: SWIZZLE_64B, one
//    32-column box, descriptors in the 64-byte mode.
//  - A consumer warpgroup, at step kt, issues S = Q.K^T of tile kt (wgmma
//    m64n64k16, both operands K-major in shared memory) and O += P.V of
//    tile kt - 1 (wgmma m64nDk16, P from registers: for 16 keys the
//    accumulator layout is the A-operand layout; V N-major in shared
//    memory: the transpose bit), then runs tile kt's online softmax on the
//    fp32 scores while the P.V product is in flight (a row lives in the 4
//    threads of a quad: two xor shuffles; the masks only where the tile
//    crosses the diagonal or T), waits for it, frees tile kt - 1's stage,
//    rescales O by alpha and splits tile kt's P.  The two warpgroups take
//    turns at issuing (two named barriers), so one's softmax overlaps the
//    other's products (without the turns it runs 13% slower at S =
//    32,768).  Both run every tile of the
//    block (a tile past a row's diagonal is all masked and adds nothing),
//    so their turns pair up.
//  - BK = 64 keys per stage, NS = 6 stages at D <= 64 (4 at D = 128 and
//    192, 3 at D = 256, whose 64 KB Q tile and 48 KB stages leave room for
//    no more), in the 168 registers a thread has with 9 warps on the SM:
//    with 128 keys per stage the P pieces of the tile in flight and the
//    scores of the next no longer fit, and ptxas spills.  At DV = 128 the
//    O accumulators double: ptxas spills a little and serialises the
//    wgmmas (the -Xptxas -v counts are in PERF.md).
//  - The output, divided by max(l, 1e-30), is stored as bf16 pairs straight
//    from the accumulators; rows past S are not stored.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;

struct Strides {
  long long b, h, s;
};

namespace hopper {

constexpr int BQ = 128;                    // query rows per block
constexpr int BK = 64;                     // keys per stage
constexpr int kConsumers = 256;            // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kEncodeError = 1000;         // + the CUresult of the encode

// Q and K rows whose head dim is a multiple of 64 are read as 64-column
// boxes of 128 bytes (128-byte swizzle); D = 32 and MLA's smoke D = 48 as
// 32-column boxes of 64 bytes (64-byte swizzle), D = 48's second box half
// past the row (TMA fills it with zeros, which the D / 16 steps of Q.K^T
// never read).  V has its own head dim DVT (MLA: 128 beside D = 192, 32
// beside 48) and its own swizzle.  A block owns DV of the DVT output
// columns: the O accumulators of DVT = 192 or 256 do not fit a thread's
// registers beside the scores and the P pieces, so those take DVT / DV
// column blocks, each with the whole Q.K^T and softmax.
template <int D, int DVT>
struct Cfg {
  static constexpr int SPAN = D % 64 == 0 ? 128 : 64;  // bytes, swizzled row
  static constexpr int BOXC = SPAN / 2;            // columns of a box
  static constexpr int BOXES = (D + BOXC - 1) / BOXC;  // boxes of a Q/K row
  static constexpr int DP = BOXES * BOXC;          // Q/K columns in smem
  static constexpr uint64_t LAYOUT = SPAN == 128 ? 1 : 2;  // descriptor mode
  static constexpr int ATOM = 8 * SPAN;            // 8 swizzled rows
  static constexpr int DV = DVT == 256 ? 128 : DVT == 192 ? 64 : DVT;
  static constexpr int NCOL = DVT / DV;            // column blocks
  static constexpr int VSPAN = DV % 64 == 0 ? 128 : 64;
  static constexpr int VBOXC = VSPAN / 2;
  static constexpr int VBOXES = DV / VBOXC;        // boxes of a V row
  static constexpr uint64_t VLAYOUT = VSPAN == 128 ? 1 : 2;
  static constexpr int VATOM = 8 * VSPAN;
  static constexpr int NS = D <= 64 ? 6 : D == 256 ? 3 : 4;  // ring stages
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int K_BYTES = BK * DP * 2;
  static constexpr int V_BYTES = BK * DV * 2;
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr int BAR_OFF = Q_BYTES + NS * STAGE_BYTES;
  // 1,024 of slack to align the tiles, the tiles, 2 NS + 1 mbarriers
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (2 * NS + 1);
  static_assert(SMEM <= 232448, "over the 227 KB a block can use");
  static_assert(D % 16 == 0 && DV % VBOXC == 0, "whole k16 steps and boxes");
};

// wgmma shared-memory descriptor for a swizzled operand: start address,
// leading and stride byte offsets (each >> 4), layout (1: 128-byte
// swizzle, 2: 64-byte)
template <uint64_t LAYOUT>
__device__ __forceinline__ uint64_t swz(uint32_t addr, uint32_t lbo,
                                       uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | LAYOUT << 62;
}

// d (64 x 64, fp32) (+)= a (64 x 16, smem) . b (64 x 16, smem)^T, both
// K-major; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 32, fp32) += a (64 x 16, bf16 pairs in registers) . b (16 x 32,
// smem, N-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64, fp32) += a (64 x 16, bf16 pairs in registers) . b (16 x 64,
// smem, N-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, fp32) += a (64 x 16, bf16 pairs in registers) . b (16 x 128,
// smem, N-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// (a, b) = hi + mid + lo exactly, as three bf16x2 values (a in the low
// halves): each piece is the top 8 significant bits of what is left
// (truncation, so each subtraction is exact), and the 24 bits of an fp32
// value fit in three pieces
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  hi = __byte_perm(ua, ub, 0x7632);  // the high 16 bits of each
  a -= __uint_as_float(ua & 0xFFFF0000u);
  b -= __uint_as_float(ub & 0xFFFF0000u);
  ua = __float_as_uint(a);
  ub = __float_as_uint(b);
  mid = __byte_perm(ua, ub, 0x7632);
  a -= __uint_as_float(ua & 0xFFFF0000u);
  b -= __uint_as_float(ub & 0xFFFF0000u);
  lo = __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// the two consumer warpgroups take turns at issuing their products (named
// barriers 1 and 2 over their 256 threads), so one's softmax runs while the
// other's products hold the tensor cores
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(kConsumers) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;" ::"r"(2 - wg), "n"(kConsumers)
               : "memory");
}

// S = Q.K^T of one key tile: both operands K-major in shared memory, D/16
// steps of 32 bytes along a swizzled row, box after box
template <class C, int D>
__device__ __forceinline__ void issue_scores(float (&sc)[BK / 2], uint32_t qa,
                                             uint32_t ks) {
  constexpr int PER = C::SPAN / 32;  // k16 steps in a box
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(sc,
             swz<C::LAYOUT>(qa + (kk / PER) * BQ * C::SPAN + (kk % PER) * 32,
                            16, C::ATOM),
             swz<C::LAYOUT>(ks + (kk / PER) * BK * C::SPAN + (kk % PER) * 32,
                            16, C::ATOM),
             kk > 0);
}

// O += P.V of one key tile over the block's DV columns, P in three bf16
// pieces: 16 keys per step, V N-major (8-key groups one swizzle atom
// apart, each further box of columns BK rows on)
template <class C>
__device__ __forceinline__ void issue_values(float (&acc)[C::DV / 2],
                                             const uint32_t (&ph)[BK / 4],
                                             const uint32_t (&pm)[BK / 4],
                                             const uint32_t (&pl)[BK / 4],
                                             uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t vd = swz<C::VLAYOUT>(vs + kk * 16 * C::VSPAN,
                                        BK * C::VSPAN, C::VATOM);
    wgmma_rs(acc, ph + 4 * kk, vd);
    wgmma_rs(acc, pm + 4 * kk, vd);
    wgmma_rs(acc, pl + 4 * kk, vd);
  }
}

// 2^x on the SFU (MUFU.EX2, about 2 ulp, as exp2f computes it in range);
// results below 2^-126 flush to 0, which no weight of a row (whose largest
// is 1) can tell from its sum
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the online softmax of one tile on the raw scores sc (in place: the
// weights), rows r0 and r1 = r0 + 8; masks where the tile crosses (causal)
// the warpgroup's first row, the T keys or (window > 0) the lower edge of
// a row's band (keys j > row - window); returns each row's alpha.  A row whose band
// starts past this tile has seen only masked keys (its max is still
// -1e30): it takes 0 as its max's term, so its weights and alpha are
// exp2(-1e30 c) = 0, and it adds nothing until its band begins.
__device__ __forceinline__ void softmax(float (&sc)[BK / 2], int k0, int qw0,
                                        int r0, int t, int causal,
                                        int window, int quad, float c,
                                        float& m0, float& m1, float& l0,
                                        float& l1, float& al0, float& al1) {
  const int r1 = r0 + 8;
  const bool edge = (causal && k0 + BK - 1 > qw0) || k0 + BK > t ||
                    (window > 0 && k0 <= qw0 + 63 - window);
  float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int row = (i & 2) ? r1 : r0;
    const int col = k0 + (i / 4) * 8 + 2 * quad + (i & 1);
    if (edge && ((causal && col > row) || col >= t ||
                 (window > 0 && col <= row - window)))
      sc[i] = kNeg;
    if (i & 2)
      mx1 = fmaxf(mx1, sc[i]);
    else
      mx0 = fmaxf(mx0, sc[i]);
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {  // a row: the 4 threads of a quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(~0u, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(~0u, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float mc0 = mn0 == kNeg ? 0.f : mn0 * c,
              mc1 = mn1 == kNeg ? 0.f : mn1 * c;
  al0 = ex2(fmaf(m0, c, -mc0));
  al1 = ex2(fmaf(m1, c, -mc1));
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    sc[i] = ex2(fmaf(sc[i], c, (i & 2) ? -mc1 : -mc0));
    if (i & 2)
      sum1 += sc[i];
    else
      sum0 += sc[i];
  }
  l0 = al0 * l0 + sum0;
  l1 = al1 * l1 + sum1;
}

// pair j of the weights = accumulators 2j, 2j + 1 (row r1 when j is odd):
// for 16 keys the accumulator layout is the A-operand layout of a k16 step
__device__ __forceinline__ void split_weights(const float (&sc)[BK / 2],
                                              uint32_t (&ph)[BK / 4],
                                              uint32_t (&pm)[BK / 4],
                                              uint32_t (&pl)[BK / 4]) {
#pragma unroll
  for (int j = 0; j < BK / 4; ++j)
    split3(sc[2 * j], sc[2 * j + 1], ph[j], pm[j], pl[j]);
}

template <int D, int DVT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 __nv_bfloat16* __restrict__ o, int s, int t, int g,
                 int window, int causal, Strides os_, float scale) {
  using C = Cfg<D, DVT>;
  constexpr int NS = C::NS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
      ~1023u;
  const uint32_t q_sm = base;                // [box][BQ rows][SPAN]
  const uint32_t kv_sm = base + C::Q_BYTES;  // stage i: K, then V
  const uint32_t full = base + C::BAR_OFF, empty = full + 8 * NS,
                 qbar = empty + 8 * NS;

  // block x: head x / NCOL, output columns col0 .. col0 + DV - 1
  const int hh = blockIdx.x / C::NCOL, b = blockIdx.y, kh = hh / g;
  const int col0 = (blockIdx.x % C::NCOL) * C::DV;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  // the causal bound, or all T keys
  const int kt_end =
      causal ? (min(q0 + BQ, s) - 1) / BK + 1 : (t + BK - 1) / BK;
  // the band's first key tile: keys below q0 - window + 1 are outside
  // every row's band, and their tiles are not loaded
  const int kt0 = window > 0 ? max(q0 - window + 1, 0) / BK : 0;
  const int n_kt = kt_end - kt0;  // tiles the block runs
  // the warpgroup, broadcast from lane 0 so that the compiler sees it is
  // uniform (wgmma in a branch it cannot prove uniform is serialised)
  const int wg = __shfl_sync(~0u, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumers / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp
    if (threadIdx.x == kConsumers) {  // one thread issues every load
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int bx = 0; bx < C::BOXES; ++bx)
        tma_load(q_sm + bx * BQ * C::SPAN, &qmap, qbar, bx * C::BOXC, q0, hh,
                 b);
      for (int i = 0; i < n_kt; ++i) {
        const int st = i % NS, kt = kt0 + i;
        if (i >= NS) mbar_wait(empty + 8 * st, (i / NS - 1) & 1);
        const uint32_t ks = kv_sm + st * C::STAGE_BYTES,
                       vs = ks + C::K_BYTES;
        mbar_expect_tx(full + 8 * st, C::STAGE_BYTES);
        for (int bx = 0; bx < C::BOXES; ++bx)
          tma_load(ks + bx * BK * C::SPAN, &kmap, full + 8 * st,
                   bx * C::BOXC, kt * BK, kh, b);
        for (int bx = 0; bx < C::VBOXES; ++bx)
          tma_load(vs + bx * BK * C::VSPAN, &vmap, full + 8 * st,
                   col0 + bx * C::VBOXC, kt * BK, kh, b);
      }
    }
  } else {  // the consumer warpgroups
    // a consumer warpgroup: rows qw0 .. qw0 + 63; this thread holds rows r0
    // and r0 + 8, columns 8c + 2 quad + {0, 1} of every accumulator.  Both
    // warpgroups run all n_kt tiles (a tile past a row's diagonal or
    // before its band is all masked and adds nothing), so their turns
    // pair up.
    const int tw = threadIdx.x % 128, lane = tw % 32, quad = lane % 4;
    const int qw0 = q0 + wg * 64;
    const int r0 = qw0 + (tw / 32) * 16 + lane / 4, r1 = r0 + 8;
    const uint32_t qa = q_sm + wg * 64 * C::SPAN;
    // exp(scale * (x - m)) = exp2(x * c - m * c) on the raw scores x
    const float c = scale * 1.44269504088896341f;

    float acc[C::DV / 2];
#pragma unroll
    for (int i = 0; i < C::DV / 2; ++i) acc[i] = 0.f;
    float m0 = kNeg, m1 = kNeg;  // running max of the raw scores
    float l0 = 0.f, l1 = 0.f;    // this thread's part of the row sums
    float al0, al1;
    float sc[BK / 2];            // scores, then weights, of tile i
    uint32_t ph[BK / 4], pm[BK / 4], pl[BK / 4];  // weights of tile i - 1
    if (wg == 1) turn_pass(wg);  // warpgroup 0 goes first
    mbar_wait(qbar, 0);

    // the block's first tile: its scores and softmax
    mbar_wait(full, 0);
    turn_wait(wg);
    wg_fence();
    issue_scores<C, D>(sc, qa, kv_sm);
    wg_commit();
    turn_pass(wg);
    wg_wait<0>();
    reg_fence(sc);
    softmax(sc, kt0 * BK, qw0, r0, t, causal, window, quad, c, m0, m1, l0,
            l1, al0, al1);
    split_weights(sc, ph, pm, pl);

    // tile i's scores and tile i - 1's values in one turn, then tile i's
    // softmax while the values are in flight
    for (int i = 1; i < n_kt; ++i) {
      const int st = i % NS, prev = (i - 1) % NS;
      mbar_wait(full + 8 * st, (i / NS) & 1);
      turn_wait(wg);
      wg_fence();
      issue_scores<C, D>(sc, qa, kv_sm + st * C::STAGE_BYTES);
      wg_commit();
      issue_values<C>(acc, ph, pm, pl,
                      kv_sm + prev * C::STAGE_BYTES + C::K_BYTES);
      wg_commit();
      turn_pass(wg);
      wg_wait<1>();
      reg_fence(sc);
      softmax(sc, (kt0 + i) * BK, qw0, r0, t, causal, window, quad, c, m0,
              m1, l0, l1, al0, al1);
      wg_wait<0>();
      reg_fence(acc);
      reg_fence(ph);
      reg_fence(pm);
      reg_fence(pl);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * prev);  // tile i - 1 is read
#pragma unroll
      for (int j = 0; j < C::DV / 2; ++j) acc[j] *= (j & 2) ? al1 : al0;
      split_weights(sc, ph, pm, pl);
    }

    // the last tile's values; warpgroup 1's last turn is not waited for
    const int last = (n_kt - 1) % NS;
    turn_wait(wg);
    wg_fence();
    issue_values<C>(acc, ph, pm, pl,
                    kv_sm + last * C::STAGE_BYTES + C::K_BYTES);
    wg_commit();
    if (wg == 0) turn_pass(wg);
    wg_wait<0>();
    reg_fence(acc);
    reg_fence(ph);
    reg_fence(pm);
    reg_fence(pl);

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(~0u, l0, off);
      l1 += __shfl_xor_sync(~0u, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob = o + b * os_.b + hh * os_.h + col0;
#pragma unroll
    for (int c8 = 0; c8 < C::DV / 8; ++c8) {
      const int col = c8 * 8 + 2 * quad;
      if (r0 < s)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * os_.s + col) =
            __floats2bfloat162_rn(acc[4 * c8] / d0, acc[4 * c8 + 1] / d0);
      if (r1 < s)
        *reinterpret_cast<__nv_bfloat162*>(ob + r1 * os_.s + col) =
            __floats2bfloat162_rn(acc[4 * c8 + 2] / d1, acc[4 * c8 + 3] / d1);
    }
  }
}

// a (cols, S, heads, B) bf16 operand with strides st = (batch, head, seq)
// in elements, read in boxes of boxc columns x rows, swizzled as the
// descriptors expect (span: bytes of a swizzled box row); a box reaching
// past the row reads zeros
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                  int cols, int boxc, int span, int s, int heads, int b,
                  const long long* st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)s,
                              (cuuint64_t)heads, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)boxc, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                span == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D, int DVT>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int hkv, int s, int t, const long long* st, float scale,
           int window, int causal, cudaStream_t stream) {
  using C = Cfg<D, DVT>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  CUresult r =
      make_map(encode, &qm, q, D, C::BOXC, C::SPAN, s, h, b, st, BQ);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &km, k, D, C::BOXC, C::SPAN, t, hkv, b, st + 3, BK);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &vm, v, DVT, C::VBOXC, C::VSPAN, t, hkv, b, st + 6,
                 BK);
  if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D, DVT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(h * C::NCOL, b, (s + BQ - 1) / BQ);
  flash_kernel<D, DVT><<<grid, kThreads, C::SMEM, stream>>>(
      qm, km, vm, (__nv_bfloat16*)o, s, t, h / hkv, window, causal,
      Strides{st[9], st[10], st[11]}, scale);
  return (int)cudaGetLastError();
}

}  // namespace hopper

// ---- fp32: the SIMT kernel ----
// What bounds it on an H100: the operations, 2 * B * H * D * S * (S + 1)
// FLOP, here on the fp32 SIMT units (67 TFLOP/s peak; the tensor cores
// would need split TF32 to keep fp32 accuracy), reading its operands from
// shared memory, so it sits well below that bound.
//
// Design (simple and right first):
//  - Grid (ceil(S / 64), H, B), 256 threads.  Block x takes query tile
//    n_tiles - 1 - x, so the longest causal rows start first.
//  - Non-causal: every block runs all ceil(T / 64) key tiles, keys past T
//    masked; T may differ from S.
//  - The 64-row query tile (pre-scaled by 1/sqrt(D), as the TPU kernel
//    does) stays in shared memory; 64-key K and V tiles stream through it
//    up to the tile that holds the block's last row (the causal bound).
//  - Thread (ty, tx) of a 16 x 16 layout owns rows 4ty..4ty+3 and key
//    columns tx + 16c of the score tile and output dims tx + 16c of the
//    accumulators, which stay in registers; the row max and sum reduce
//    over the 16 lanes of a half-warp with shuffles.  K rows are padded to
//    D + 1 floats so the 16 columns a half-warp reads fall in 16 banks.
//  - Rows past S are not stored and keys past T load as zeros and are
//    masked.  Without a window every row meets key 0 in its first tile,
//    so its running max is finite from then on and a masked score adds
//    exp(-1e30 - m) = 0.  With one, a row whose band starts past the
//    block's first tile weighs its masked keys exp(0) = 1 until its band
//    begins; that tile's alpha, exp(-1e30 - m), is exactly 0 and clears
//    them (the values are finite).
//  - expf, no fast math.
namespace simt {

constexpr int kThreads = 256;
constexpr int BQ = 64;
constexpr int BK = 64;

__host__ __device__ constexpr int smem_floats(int d, int dv) {
  return BQ * (d + 1)    // Q tile (padded)
         + BK * (d + 1)  // K tile (padded)
         + BK * dv       // V tile
         + BQ * BK;      // weights
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int s,
                 int t, int g, int window, int causal, Strides qs_,
                 Strides ks_, Strides vs_, Strides os_, float scale) {
  constexpr int QP = D + 1, KP = D + 1, NC = DV / 16;
  extern __shared__ float sm[];
  float* qs = sm;
  float* ks = qs + BQ * QP;
  float* vs = ks + BK * KP;
  float* ps = vs + BK * DV;

  const int tile = gridDim.x - 1 - blockIdx.x;
  const int hh = blockIdx.y, b = blockIdx.z, kh = hh / g;
  const int q0 = tile * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const float* qb = q + b * qs_.b + hh * qs_.h;
  const float* kb = k + b * ks_.b + kh * ks_.h;
  const float* vb = v + b * vs_.b + kh * vs_.h;
  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D, row = q0 + r;
    qs[r * QP + d] = row < s ? qb[row * qs_.s + d] * scale : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  const int q_hi = min(q0 + BQ, s);  // rows [q0, q_hi)
  // the causal bound (keys < q_hi), or all T keys
  const int n_kt = causal ? (q_hi + BK - 1) / BK : (t + BK - 1) / BK;
  // the band's first key tile (window > 0): no row of the block reaches
  // a key below q0 - window + 1
  const int kt0 = window > 0 ? max(q0 - window + 1, 0) / BK : 0;
  for (int kt = kt0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q is loaded; the previous tile's readers are done
    for (int i = tid; i < BK * D; i += kThreads) {
      const int j = i / D, d = i - j * D, key = k0 + j;
      ks[j * KP + d] = key < t ? kb[key * ks_.s + d] : 0.f;
    }
    for (int i = tid; i < BK * DV; i += kThreads) {
      const int j = i / DV, d = i - j * DV, key = k0 + j;
      vs[j * DV + d] = key < t ? vb[key * vs_.s + d] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = qs[(ty * 4 + r) * QP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = ks[(tx + 16 * c) * KP + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty * 4 + r;
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx + 16 * c;
        if ((causal && col > row) || col >= t ||
            (window > 0 && col <= row - window))
          sc[r][c] = kNeg;
        mx = fmaxf(mx, sc[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, off, 16));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(sc[r][c] - m_new);
        ps[(ty * 4 + r) * BK + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(~0u, sum, off, 16);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = ps[(ty * 4 + r) * BK + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[j * DV + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }

  float* ob = o + b * os_.b + hh * os_.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= s) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[row * os_.s + tx + 16 * c] = acc[r][c] / den;
  }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int hkv, int s, int t, const long long* st, float scale,
           int window, int causal, cudaStream_t stream) {
  const int smem = smem_floats(D, DV) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((s + BQ - 1) / BQ, h, b);
  flash_kernel<D, DV><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, s, t,
      h / hkv, window, causal, qs, ks, vs, os, scale);
  return (int)cudaGetLastError();
}

}  // namespace simt

}  // namespace

extern "C" {

// q (B, H, S, D), k (B, Hkv, T, D), v (B, Hkv, T, DV), o (B, H, S, DV),
// each given by its batch, head and sequence strides in elements (12
// values: q, k, v, o), the head dim contiguous.  is_bf16: the Hopper
// kernel (q, k, v and their strides 16-byte aligned), else fp32 on the
// SIMT kernel; (D, DV) in {(32, 32), (64, 64), (128, 128), (192, 192),
// (256, 256), (192, 128), (48, 32)}; H a multiple of Hkv.  causal = 1:
// T == S, query i attends to keys j <= i, and window > 0 bands it to keys
// j > i - window; causal = 0: every query attends to all T keys (window
// 0).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int b, int h, int hkv, int s, int t,
                           int d, int dv, const long long* strides,
                           int is_bf16, float scale, int window, int causal,
                           int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || s <= 0 || t <= 0 || hkv <= 0 || h % hkv != 0 || b > 65535 ||
      h > 65535 || window < 0 || (causal && t != s) ||
      (!causal && window > 0))
    return (int)cudaErrorInvalidValue;
  if (is_bf16 && (s + hopper::BQ - 1) / hopper::BQ > 65535)
    return (int)cudaErrorInvalidValue;
#define FLASH_CASE(D, DV)                                                   \
  if (d == D && dv == DV)                                                   \
    return is_bf16 ? hopper::launch<D, DV>(q, k, v, o, b, h, hkv, s, t,     \
                                           strides, scale, window, causal,  \
                                           stream)                          \
                   : simt::launch<D, DV>(q, k, v, o, b, h, hkv, s, t,       \
                                         strides, scale, window, causal,    \
                                         stream);
  FLASH_CASE(32, 32)
  FLASH_CASE(64, 64)
  FLASH_CASE(128, 128)
  FLASH_CASE(192, 192)
  FLASH_CASE(256, 256)
  FLASH_CASE(192, 128)
  FLASH_CASE(48, 32)
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
