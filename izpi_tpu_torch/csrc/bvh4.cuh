// Closest hit through a BVH4 for one ray, with a 64-entry stack in the
// thread's local memory: the traversal of bvh4_traverse.cu and of the
// forward kernel's BVH form (diff_trace.cu), one thread per ray
// (bvh4_closest), and of the RGB megakernel's BVH form (megakernel_rgb.cu,
// one path per thread from the camera to the deposit), the same visits
// taken by a warp together (bvh4_closest_warp).
//
// A visit pops one node, slab-tests its four children against the ray's
// shrinking best t (the reference's tMax shrink, bvh4.go:130), tests the
// primitives of the leaf children it hits in slot order with the
// megakernels' primitive test (common.cuh prim_test; a strict < keeps the
// earlier primitive on a tie), then pushes the internal children it hits,
// ordered by entry distance with the sorting network of
// izpi_tpu/ops/bvh_kernel.py:395-408 so that the nearest is popped next. A
// zero direction component divides as 1e-30 (bvh_kernel.py:168). The plain
// version, izpi_tpu_torch/accel/traverse.py closest_bvh, does the same
// operations on the same nodes, so both give the same (t, index) and visit
// counts; the build keeps IEEE rounding (-fmad=false) for that.
//
// Tables (izpi_tpu_torch/ops/bvh_kernel.py pack_tables):
//   nodes (Nn, 32) 4-byte words: bounds [minx×4 miny×4 minz×4 maxx×4 maxy×4
//         maxz×4] as f32 | child[4] | count[4] as i32 (bvh_build.py:10-14);
//   prims (P, 16) f32: g0 g1 g2 g3 | kind as i32 bits | pad (3).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace izpi {

constexpr int kStack = 64;     // accel/traverse.py STACK_DEPTH, checked at build
constexpr int kNodeWords = 32;
constexpr int kPrimWords = 16;
constexpr float kInvEps = 1e-30f;

__device__ __forceinline__ void cmp_exchange(float* key, int* ch, bool* push, int a, int b) {
  if (key[a] < key[b]) {
    const float k = key[a];
    key[a] = key[b];
    key[b] = k;
    const int c = ch[a];
    ch[a] = ch[b];
    ch[b] = c;
    const bool p = push[a];
    push[a] = push[b];
    push[b] = p;
  }
}

// A visit's node work: load node `node`'s row and slab-test its four
// children against [t_min, t_best], the best t at the pop
// (traverse.slab_test_4). key: each child's entry distance; hit: its box is
// hit, it is not empty, and the ray holds no NaN.
__device__ __forceinline__ void bvh4_children(const int* __restrict__ nodes, int node,
                                              const float (&od)[3], const float (&inv)[3],
                                              bool live, float t_min, float t_best,
                                              float (&key)[4], bool (&hit)[4], int (&ch)[4],
                                              int (&cnt)[4]) {
  const float4* nb = reinterpret_cast<const float4*>(nodes + (size_t)node * kNodeWords);
  float bnd[24];
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const float4 v = __ldg(nb + q);
    bnd[4 * q + 0] = v.x;
    bnd[4 * q + 1] = v.y;
    bnd[4 * q + 2] = v.z;
    bnd[4 * q + 3] = v.w;
  }
  const int4 c4 = __ldg(reinterpret_cast<const int4*>(nb + 6));
  const int4 n4 = __ldg(reinterpret_cast<const int4*>(nb + 7));
  ch[0] = c4.x;
  ch[1] = c4.y;
  ch[2] = c4.z;
  ch[3] = c4.w;
  cnt[0] = n4.x;
  cnt[1] = n4.y;
  cnt[2] = n4.z;
  cnt[3] = n4.w;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    float tn = t_min, tf = t_best;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float t0 = (bnd[ax * 4 + s] - od[ax]) * inv[ax];
      const float t1 = (bnd[12 + ax * 4 + s] - od[ax]) * inv[ax];
      tn = fmaxf(tn, fminf(t0, t1));
      tf = fminf(tf, fmaxf(t0, t1));
    }
    key[s] = tn;
    hit[s] = live && tf > tn && cnt[s] != -1;
  }
}

// A visit's push: the internal children it hit, sorted by entry distance,
// farthest pushed first, so that the nearest is popped next.
__device__ __forceinline__ void bvh4_push(float (&key)[4], int (&ch)[4], const bool (&hit)[4],
                                          const int (&cnt)[4], int* stack, int& sp) {
  bool push[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) push[s] = hit[s] && cnt[s] == 0;
  cmp_exchange(key, ch, push, 0, 1);
  cmp_exchange(key, ch, push, 2, 3);
  cmp_exchange(key, ch, push, 0, 2);
  cmp_exchange(key, ch, push, 1, 3);
  cmp_exchange(key, ch, push, 1, 2);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    // The build checks the worst-case stack against kStack, so the guard
    // never drops a node.
    if (push[s] && sp < kStack) stack[sp++] = ch[s];
  }
}

// The closest hit of ray (o, d) at `tme` in [t_min, t_max] (t_max clamped to
// kTMax by the caller): returns the index into the tree's reordered
// primitives, or -1 on a miss, with its t in t_out (t_max on a miss). Adds
// the nodes popped to `visits` and the primitives tested to `tests`.
__device__ __forceinline__ int bvh4_closest(const int* __restrict__ nodes,
                                            const float* __restrict__ prims, V3 o, V3 d,
                                            float tme, float t_min, float t_max, float& t_out,
                                            int& visits, int& tests) {
  const float od[3] = {o.x, o.y, o.z};
  const float inv[3] = {1.0f / (d.x == 0.0f ? kInvEps : d.x), 1.0f / (d.y == 0.0f ? kInvEps : d.y),
                        1.0f / (d.z == 0.0f ? kInvEps : d.z)};
  // A NaN in the ray visits no child, as in the TPU kernel, whose min/max
  // carry the NaN into every slab test; fminf/fmaxf would drop it and walk
  // the whole tree (such a ray hits no primitive either way).
  const bool live = !(isnan(o.x) || isnan(o.y) || isnan(o.z) || isnan(d.x) || isnan(d.y) ||
                      isnan(d.z));

  float t_best = t_max;
  int best = -1;
  int stack[kStack];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const int node = stack[--sp];
    ++visits;
    float key[4];
    bool hit[4];
    int ch[4], cnt[4];
    bvh4_children(nodes, node, od, inv, live, t_min, t_best, key, hit, ch, cnt);

    // Leaf children, in slot order: their contiguous primitives.
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (!(hit[s] && cnt[s] > 0)) continue;
      for (int k = 0; k < cnt[s]; ++k) {
        const int p = ch[s] + k;
        const float* g = prims + (size_t)p * kPrimWords;
        float t;
        const bool ok = prim_test(g, __float_as_int(__ldg(g + 12)), o, d, tme, t_min, t_best, t);
        ++tests;
        if (ok && t < t_best) {
          t_best = t;
          best = p;
        }
      }
    }

    bvh4_push(key, ch, hit, cnt, stack, sp);
  }
  t_out = t_best;
  return best;
}

// The closest hit of bvh4_closest for the RGB megakernel's BVH form
// (megakernel_rgb.cu), taken by the 32 lanes of a warp together: every lane
// calls it, `active` or not, since it holds warp collectives over the whole
// warp. Each active lane pops, box-tests, pushes and tests exactly the nodes
// and primitives of bvh4_closest, in its order, against the same running
// best t; only when it does so changes. The warp runs a non-speculative
// "while-while" (Aila and Laine, 2009):
//  - inner passes: each lane that holds no leaves pops a node, box-tests its
//    children against its best t, pushes the internal ones it hits and
//    holds the leaf ones, until every lane holds leaves or has an empty
//    stack;
//  - a leaf pass: the lanes that hold leaves test their primitives
//    together, each its own in slot order, one primitive a round.
// bvh4_closest's warp passes its visit loop as often as its longest lane
// pops, and in each pass tests only the leaves of that pass's nodes; here
// the leaf tests of many passes share one. A node's children are pushed
// before its leaves are tested, which leaves the stack and every later box
// test as bvh4_closest has them: the push reads the box tests of the pop,
// not the leaves' hits. An inactive lane visits nothing. `tally`
// (megakernel_rgb.cu: nothing in a main instance, the probe's counts in
// the probe instance) sees each inner pass (visit_pass), each lane's
// primitives at each leaf pass (test_pass) and the call's counts (done).
template <class Tally>
__device__ __forceinline__ int bvh4_closest_warp(const int* __restrict__ nodes,
                                                 const float* __restrict__ prims, bool active,
                                                 V3 o, V3 d, float tme, float t_min,
                                                 float t_max, float& t_out, int& visits,
                                                 int& tests, Tally& tally) {
  const float od[3] = {o.x, o.y, o.z};
  const float inv[3] = {1.0f / (d.x == 0.0f ? kInvEps : d.x), 1.0f / (d.y == 0.0f ? kInvEps : d.y),
                        1.0f / (d.z == 0.0f ? kInvEps : d.z)};
  const bool live = !(isnan(o.x) || isnan(o.y) || isnan(o.z) || isnan(d.x) || isnan(d.y) ||
                      isnan(d.z));
  float t_best = t_max;
  int best = -1;
  int stack[kStack];
  int sp = 0;
  if (active) stack[sp++] = 0;
  int my_visits = 0, my_tests = 0;
  int leaf_node = 0;     // the node whose leaf children the lane holds
  unsigned leaves = 0u;  // their slots, a bit each
  int held = 0;          // their primitives
  for (;;) {
    for (;;) {  // inner passes
      const bool more = leaves == 0u && sp > 0;
      if (!__any_sync(0xffffffffu, more)) break;
      tally.visit_pass();
      if (!more) continue;
      const int node = stack[--sp];
      ++my_visits;
      float key[4];
      bool hit[4];
      int ch[4], cnt[4];
      bvh4_children(nodes, node, od, inv, live, t_min, t_best, key, hit, ch, cnt);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (hit[s] && cnt[s] > 0) {
          leaves |= 1u << s;
          held += cnt[s];
        }
      }
      leaf_node = node;
      bvh4_push(key, ch, hit, cnt, stack, sp);
    }
    if (!__any_sync(0xffffffffu, leaves != 0u)) break;
    tally.test_pass(held);
    if (leaves != 0u) {  // the leaf pass: the held slots' runs, one after another
      const int* row = nodes + (size_t)leaf_node * kNodeWords;
      int s = __ffs(leaves) - 1;
      int p = __ldg(row + 24 + s);
      int end = p + __ldg(row + 28 + s);
      for (;;) {
        const float* g = prims + (size_t)p * kPrimWords;
        float t;
        const bool ok = prim_test(g, __float_as_int(__ldg(g + 12)), o, d, tme, t_min, t_best, t);
        ++my_tests;
        if (ok && t < t_best) {
          t_best = t;
          best = p;
        }
        if (++p == end) {
          leaves &= leaves - 1u;
          if (leaves == 0u) break;
          s = __ffs(leaves) - 1;
          p = __ldg(row + 24 + s);
          end = p + __ldg(row + 28 + s);
        }
      }
      held = 0;
    }
  }
  tally.done(active, my_visits, my_tests);
  visits += my_visits;
  tests += my_tests;
  t_out = t_best;
  return best;
}

}  // namespace izpi
