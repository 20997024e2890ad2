// Kernels that are never launched: each runs one unit of the megakernels'
// work once, so that its SASS (cuobjdump -sass) holds that unit's
// instructions and no loop. chip_smoke.py's bounds of the megakernels
// multiply them by the units a launch ran (its counter buffers): a
// Threefry call (threefry.cuh), a primitive test of each kind (common.cuh
// prim_test), and a BVH4 node visit without its leaf tests (bvh4.cuh: the
// children's slab test and the near-first push). probe_empty stores one
// value and exits; its instructions are taken from theirs. Not part of the
// library: chip_smoke.py compiles this file alone to a cubin, with the
// kernels' flags, so the units compile as they do in the kernels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh4.cuh"
#include "common.cuh"

namespace izpi {

// The ray and the keys come in as kernel parameters (the constant bank), as
// registers hold them in the kernels; the primitive and the node are loaded,
// as the kernels load them.
__global__ void probe_empty(float* __restrict__ out, float x) { out[0] = x; }

__global__ void probe_cipher(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1,
                             uint32_t* __restrict__ out) {
  threefry2x32(k0, k1, x0, x1);
  out[0] = x0;
  out[1] = x1;
}

template <int kKind>
__global__ void probe_prim(const float* __restrict__ g, V3 o, V3 d, float time, float t_min,
                           float t_max, float* __restrict__ out) {
  float t;
  const bool ok = prim_test(g, kKind, o, d, time, t_min, t_max, t);
  out[0] = ok ? t : -1.0f;
}
template __global__ void probe_prim<kTriangle>(const float*, V3, V3, float, float, float,
                                               float*);
template __global__ void probe_prim<kRect>(const float*, V3, V3, float, float, float, float*);
template __global__ void probe_prim<kSphere>(const float*, V3, V3, float, float, float,
                                             float*);

// out: the stack after the push (at most four) and its depth.
__global__ void probe_visit(const int* __restrict__ nodes, int node, V3 o, V3 inv_d,
                            float t_min, float t_best, int* __restrict__ out) {
  const float od[3] = {o.x, o.y, o.z};
  const float inv[3] = {inv_d.x, inv_d.y, inv_d.z};
  float key[4];
  bool hit[4];
  int ch[4], cnt[4];
  bvh4_children(nodes, node, od, inv, true, t_min, t_best, key, hit, ch, cnt);
  int stack[4];
  int sp = 0;
  bvh4_push(key, ch, hit, cnt, stack, sp);
  for (int i = 0; i < 4; ++i) out[i] = i < sp ? stack[i] : -1;
  out[4] = sp;
}

}  // namespace izpi
