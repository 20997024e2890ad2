// Lazy Threefry draws for the persistent megakernels (megakernel_rgb.cu,
// megakernel_spectral.cu): the cipher calls one lane needs in one trip of
// the render loop, run one call per pass of a loop the warp takes together.
//
// A bounce's 12 uniforms are uniforms_n<12> under bounce_key(path key,
// depth, 0); counter pair i (0..5) gives uniforms i and i + 6. A material
// reads only some of them (integrator/path.py bounce_rgb, bounce_spectral):
//   metal                       us[0..2]          pairs 0, 1, 2
//   dielectric                  us[3]             pair 3
//   diffuse                     us[4]             pair 4, then
//     us[4] <  0.5: light sample  us[5..8]        pairs 5, 0, 1, 2
//     us[4] >= 0.5: cosine lobe   us[9], us[10]   pair 3 (pair 4 has us[10])
// so a scatter costs the two fold-ins plus 1 to 5 pairs, where drawing all
// 12 costs 2 + 6 calls. A new sample costs its path key (two fold-ins), the
// camera key (two more) and uniforms_n<5> (three pairs); a spectral sample's
// λ reuses the camera's first fold-in (fold_in(path key, 0), the same for
// every depth-0 salt) and adds one fold-in and one pair.
//
// Each call ciphers the counters the eager functions of threefry.cuh would
// cipher under the same key, so every uniform has their bits. Only the
// uniforms of the pairs drawn are set.
//
// A lane queues, when its path ends, the next sample's draws (`new_sample`,
// which start at once) and its bounce's (`bounce`, which follow them), then
// `run`s them: one threefry2x32 per pass, a small switch to route its
// output. The warp passes as often as its longest queue needs, with every
// lane that has a call left in the same cipher code, so a lane that scatters
// and a lane that starts a camera ray share passes instead of taking turns.
#pragma once

#include <stdint.h>

#include "threefry.cuh"

namespace izpi {

constexpr uint32_t kCameraSalt = 0x5EEDu;  // camera.py CAMERA_SALT
constexpr uint32_t kLambdaSalt = 0x7A3Bu;  // integrator/wavefront.py LAMBDA_SALT

// A bounce's pairs, in the order drawn, one per nibble from the lowest; a
// nibble of 0xF ends the list.
constexpr uint32_t kPairsMetal = 0xFFFFF210u;
constexpr uint32_t kPairsDielectric = 0xFFFFFFF3u;
constexpr uint32_t kPairsDiffuse = 0xFFFFFFF4u;  // then by us[4]:
constexpr uint32_t kPairsLight = 0xFFFF2105u;
constexpr uint32_t kPairsCosine = 0xFFFFFFF3u;
constexpr uint32_t kPairsNone = 0xFFFFFFFFu;

__host__ __device__ __forceinline__ int count_pairs(uint32_t list) {
  int n = 0;
  for (; (list & 0xFu) != 0xFu; list >>= 4) ++n;
  return n;
}

// The pairs a scatter off a material of pair list `list` draws, us[4] = u4.
__host__ __device__ __forceinline__ int pairs_drawn(uint32_t list, float u4) {
  return count_pairs(list) +
         (list == kPairsDiffuse ? count_pairs(u4 < 0.5f ? kPairsLight : kPairsCosine) : 0);
}

// What the next call computes.
enum DrawStep : int {
  kDrawDone = 0,
  kFoldDepth,  // fold_in(path key, depth)
  kFoldSalt,   // fold_in(., 0): the bounce key
  kPair0, kPair1, kPair2, kPair3, kPair4, kPair5,  // a bounce pair
  kKeySid,     // fold_in(seed, sample id)
  kKeyPix,     // fold_in(., pixel): the new path key
  kCamFold,    // fold_in(path key, 0)
  kCamSalt,    // fold_in(., CAMERA_SALT): the camera key
  kCam0, kCam1, kCam2,  // uniforms_n<5>'s pairs
  kLamSalt,    // fold_in(fold_in(path key, 0), LAMBDA_SALT): the λ key
  kLam,        // uniforms_n<1>
};

// One lane's draws in one trip. The bounce's draws need the path's key
// (k0, k1) and depth, which `run` and `advance` take from the caller.
template <bool kLambda>
struct Draws {
  int step;           // the next call, kDrawDone when none is left
  uint32_t kk0, kk1;  // its key
  uint32_t c0, c1;    // its counter pair
  uint32_t pairs;     // the bounce's pairs still to draw (kPairsNone: no bounce)
  uint32_t pix;       // the new sample's pixel
  uint32_t z0, z1;    // fold_in(new path key, 0), kept for λ

  float us[12];       // the bounce's uniforms (those of the pairs drawn)
  float cu[5];        // the camera's
  float ul;           // λ's
  uint32_t key0, key1;  // the new sample's path key

  __device__ __forceinline__ void clear() {
    step = kDrawDone;
    pairs = kPairsNone;
  }

  // Queue the draws of sample `sample_id` of pixel `pixel`; they start at
  // once. Call before `bounce`.
  __device__ __forceinline__ void new_sample(uint32_t seed0, uint32_t seed1,
                                             uint32_t sample_id, uint32_t pixel) {
    call(kKeySid, seed0, seed1, 0u, sample_id);
    pix = pixel;
  }

  // Queue the draws of bounce `depth` of the path keyed (k0, k1), scattering
  // off a material whose pair list is `pair_list` (kPairsMetal, ...), after
  // the new sample's, if any.
  __device__ __forceinline__ void bounce(uint32_t k0, uint32_t k1, uint32_t depth,
                                         uint32_t pair_list) {
    pairs = pair_list;
    if (step == kDrawDone) call(kFoldDepth, k0, k1, 0u, depth);
  }

  __device__ __forceinline__ void run(uint32_t seed0, uint32_t seed1, uint32_t k0,
                                      uint32_t k1, uint32_t depth) {
    while (step != kDrawDone) advance(seed0, seed1, k0, k1, depth);
  }

  __device__ __forceinline__ void call(int s, uint32_t k0, uint32_t k1, uint32_t x0,
                                       uint32_t x1) {
    step = s;
    kk0 = k0;
    kk1 = k1;
    c0 = x0;
    c1 = x1;
  }

  // The next bounce pair under the bounce key (kk0, kk1), or done.
  __device__ __forceinline__ void next_pair() {
    const uint32_t i = pairs & 0xFu;
    pairs = (pairs >> 4) | 0xF0000000u;
    if (i != 0xFu) {
      call(kPair0 + (int)i, kk0, kk1, i, i + 6u);
    } else {
      step = kDrawDone;
    }
  }

  // After the new sample's draws: the bounce's first call, or done.
  __device__ __forceinline__ void then_bounce(uint32_t k0, uint32_t k1, uint32_t depth) {
    if (pairs != kPairsNone) {
      call(kFoldDepth, k0, k1, 0u, depth);
    } else {
      step = kDrawDone;
    }
  }

  __device__ __forceinline__ void advance(uint32_t seed0, uint32_t seed1, uint32_t k0,
                                          uint32_t k1, uint32_t depth) {
    uint32_t y0 = c0, y1 = c1;
    threefry2x32(kk0, kk1, y0, y1);
    const float a = bits_to_uniform(y0), b = bits_to_uniform(y1);
    switch (step) {
      case kFoldDepth: call(kFoldSalt, y0, y1, 0u, 0u); break;
      case kFoldSalt: kk0 = y0; kk1 = y1; next_pair(); break;
      case kPair0: us[0] = a; us[6] = b; next_pair(); break;
      case kPair1: us[1] = a; us[7] = b; next_pair(); break;
      case kPair2: us[2] = a; us[8] = b; next_pair(); break;
      case kPair3: us[3] = a; us[9] = b; next_pair(); break;
      case kPair4:  // only a diffuse scatter draws pair 4; us[4] picks its lobe
        us[4] = a;
        us[10] = b;
        pairs = a < 0.5f ? kPairsLight : kPairsCosine;
        next_pair();
        break;
      case kPair5: us[5] = a; us[11] = b; next_pair(); break;
      case kKeySid: call(kKeyPix, y0, y1, 0u, pix); break;
      case kKeyPix: key0 = y0; key1 = y1; call(kCamFold, y0, y1, 0u, 0u); break;
      case kCamFold:
        if (kLambda) {
          z0 = y0;
          z1 = y1;
        }
        call(kCamSalt, y0, y1, 0u, kCameraSalt);
        break;
      case kCamSalt: call(kCam0, y0, y1, 0u, 3u); break;
      case kCam0: cu[0] = a; cu[3] = b; call(kCam1, kk0, kk1, 1u, 4u); break;
      case kCam1: cu[1] = a; cu[4] = b; call(kCam2, kk0, kk1, 2u, 5u); break;
      case kCam2:
        cu[2] = a;
        if (kLambda) {
          call(kLamSalt, z0, z1, 0u, kLambdaSalt);
        } else {
          then_bounce(k0, k1, depth);
        }
        break;
      case kLamSalt: call(kLam, y0, y1, 0u, 1u); break;
      default: ul = a; then_bounce(k0, k1, depth); break;  // kLam
    }
  }
};

}  // namespace izpi
