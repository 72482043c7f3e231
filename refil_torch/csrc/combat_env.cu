// The combat env's step and observation (envs/combat/env.py) as two kernels.
//
// Replaces no TPU kernel: the JAX package's env (refil_tpu/envs/combat/env.py)
// is jnp ops that XLA fuses into the block's program. Op by op on the card the
// step and the observation are ~490 kernels an env step, ~60% of a training
// block's kernels; here they are two launches:
//
//   combat_step_kernel:    EntityBattle.step_state without `record`: action
//                          decode, enemy targeting for every difficulty tier
//                          (the focus fire's in-order, overkill-aware picks),
//                          movement against the pathing grid, fire, shields,
//                          cooldowns, Medivac heals and energy, deaths,
//                          reward, termination and info.
//   combat_observe_kernel: EntityBattle.observe: the pairwise distances once,
//                          the available actions, the entity features, the
//                          observation and entity masks.
//
// The contract is bit equality with the op path on the card (the op path is
// held to the JAX env on the CPU), so every float operation here is the one
// ATen runs, in its order and rounding: no FMA contraction (__fmul_rn,
// __fadd_rn), IEEE division and square root, sums over unit slots in slot
// order, the sum of squares of a norm as two rounded products and one
// rounded add, Python-float constants rounded to float32 as ATen rounds a
// scalar operand, a division by a Python float taken as ATen's CUDA kernel
// takes it (times the float32 reciprocal, computed by the wrapper), and the
// first index of a tie in every argmin.
//
// Bound: the work is tiny (16 units, a 16x16 distance matrix, <= Ne dependent
// focus-fire picks) and the bytes few (~4.9 KB an env a step on 3-8sz, read
// and written once: the step 1.5 KB, the observation 3.4 KB), so at B 8 a
// launch and the focus fire's dependent chain bound it, and at B 4096 its
// bytes (20 MB, ~6 us at 3.35 TB/s; ops/combat_env.bytes_per_step).
// Design: one warp per env, 4 envs per block (fewer where the flat env's
// widest maps pass 48 KB of shared memory); an env's state lives in shared
// memory for the launch; lanes stride over units, unit pairs and output
// elements, so any Na, Ne fit (the flat maps hold up to 64 enemies); the
// focus fire stays sequential over enemies inside the warp, each pick a
// warp argmin.
//
// Interface: plain C (extern "C"), loaded with ctypes by ops/combat_env.py,
// whose structures mirror Params, StepIO and ObserveIO field for field. The
// launchers enqueue on the given stream and return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// the launchers' arguments: plain C structures, with external linkage
struct Params {
  int B, Na, Ne, nte, nta, A, n_types, M;
  int tier, has_medivac, trivial, episode_limit, regen_delay;
  int only_positive, sparse, scale;
  int utb, sb, nf;
  float lo, hi, move_amount, half_move, shoot_range, sight_range, step_mul, slack;
  float eps_focus, eps_div, far_, regen_amt, rdv, neg, rdv_neg, reward_win;
  float reward_defeat, inv_scale, inv_map, center_x, center_y, heal_per_step;
  float energy_per_step, energy_regen;
  // unit tables by unit id: unit_f rows health_max, shield_max, energy_max,
  // damage, weapon_range, cooldown_frames, speed_step; unit_i rows
  // is_medivac, ignores_pathing, local_type; grid the (M, M) walkability
  const float* unit_f;
  const int* unit_i;
  const uint8_t* grid;
};

struct StepIO {
  const int64_t* a_type;
  const int64_t* e_type;
  const uint8_t* a_active;
  const uint8_t* e_active;
  const float* a_pos;
  const float* e_pos;
  const float* a_health;
  const float* a_shield;
  const float* a_cd;
  const float* a_energy;
  const float* e_health;
  const float* e_shield;
  const float* e_cd;
  const int64_t* e_slot_of_tag;
  const int64_t* a_slot_of_tag;
  const int64_t* a_last_hit;
  const int64_t* e_last_hit;
  const float* attack_point;
  const float* prev_a_hp;
  const float* prev_e_hp;
  const uint8_t* dead_a;
  const uint8_t* dead_e;
  const int64_t* t;
  const int64_t* actions;
  float* o_a_pos;
  float* o_e_pos;
  float* o_a_health;
  float* o_a_shield;
  float* o_a_cd;
  float* o_a_energy;
  float* o_e_health;
  float* o_e_shield;
  float* o_e_cd;
  int64_t* o_a_last_hit;
  int64_t* o_e_last_hit;
  float* o_prev_a_hp;
  float* o_prev_e_hp;
  uint8_t* o_dead_a;
  uint8_t* o_dead_e;
  int64_t* o_t;
  float* o_reward;
  uint8_t* o_done;
  uint8_t* o_won;
  uint8_t* o_at_limit;
};

struct ObserveIO {
  const int64_t* a_type;
  const int64_t* e_type;
  const uint8_t* a_active;
  const uint8_t* e_active;
  const float* a_pos;
  const float* e_pos;
  const float* a_health;
  const float* a_shield;
  const float* a_cd;
  const float* a_energy;
  const float* e_health;
  const float* e_shield;
  const float* e_cd;
  const int64_t* a_tags;
  const int64_t* e_tags;
  float* o_entities;
  uint8_t* o_obs_mask;
  uint8_t* o_entity_mask;
  uint8_t* o_avail;
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kEnvsPerBlock = 4;
constexpr int kMaxSmemPerBlock = 48 * 1024;

enum UnitF { kHealthMax = 0, kShieldMax, kEnergyMax, kDamage, kWeaponRange, kCooldown, kSpeed };
enum UnitI { kIsMedivac = 0, kIgnoresPathing, kLocalType };

// float arithmetic as ATen's elementwise kernels round it, one op at a time
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float b2f(bool b) { return b ? 1.0f : 0.0f; }
// _norm: (x * x).sum(-1) then sqrt
__device__ __forceinline__ float norm2(float dx, float dy) {
  return __fsqrt_rn(add(mul(dx, dx), mul(dy, dy)));
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ int64_t clampl(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// the first index of the least value, across the warp (a lane with no
// element holds (inf, INT_MAX))
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// shared memory of one env, carved in the same order on host and device
// (the host carves from a null base to size an env's share)
struct Carver {
  uintptr_t base;
  size_t off;
  template <class T>
  __host__ __device__ T* take(int n) {
    T* p = reinterpret_cast<T*>(base + off);
    off += (static_cast<size_t>(n) * sizeof(T) + 15) / 16 * 16;
    return p;
  }
};

struct StepSmem {
  float *apx, *apy, *epx, *epy, *napx, *napy, *nepx, *nepy, *dea, *alloc, *a_hp, *e_wr;
  float *thr_dist, *a_dmg, *e_dmg, *heal, *rd_a, *rt_a, *rd_e, *rt_e;
  int *a_ty, *e_ty, *atk_slot, *heal_slot, *nearest, *thr, *e_target;
  // flags a unit, each array written by one phase: af, ef (decode,
  // engagement), af2, ef2 (who fires or heals), cnt_a, cnt_e (the counts
  // the reward and termination take)
  uint8_t *af, *ef, *af2, *ef2, *cnt_a, *cnt_e;
};

enum AllyBits { kAAlive = 1, kAMove = 2, kAAttack = 4, kAHeal = 8, kAMed = 16 };
enum EnemyBits { kEAlive = 1, kEEngage = 2 };
enum FireBits { kFires = 1, kCanHeal = 2 };
enum CountBits { kNewDead = 1, kAliveNow = 2, kCombatNow = 4 };

__host__ __device__ inline StepSmem carve_step(Carver& c, int Na, int Ne) {
  StepSmem s;
  s.apx = c.take<float>(Na); s.apy = c.take<float>(Na);
  s.epx = c.take<float>(Ne); s.epy = c.take<float>(Ne);
  s.napx = c.take<float>(Na); s.napy = c.take<float>(Na);
  s.nepx = c.take<float>(Ne); s.nepy = c.take<float>(Ne);
  s.dea = c.take<float>(Ne * Na);
  s.alloc = c.take<float>(Na); s.a_hp = c.take<float>(Na); s.e_wr = c.take<float>(Ne);
  s.thr_dist = c.take<float>(Ne); s.a_dmg = c.take<float>(Na); s.e_dmg = c.take<float>(Ne);
  s.heal = c.take<float>(Na);
  s.rd_a = c.take<float>(Na); s.rt_a = c.take<float>(Na);
  s.rd_e = c.take<float>(Ne); s.rt_e = c.take<float>(Ne);
  s.a_ty = c.take<int>(Na); s.e_ty = c.take<int>(Ne);
  s.atk_slot = c.take<int>(Na); s.heal_slot = c.take<int>(Na);
  s.nearest = c.take<int>(Ne); s.thr = c.take<int>(Ne); s.e_target = c.take<int>(Ne);
  s.af = c.take<uint8_t>(Na); s.ef = c.take<uint8_t>(Ne);
  s.af2 = c.take<uint8_t>(Na); s.ef2 = c.take<uint8_t>(Ne);
  s.cnt_a = c.take<uint8_t>(Na); s.cnt_e = c.take<uint8_t>(Ne);
  return s;
}

inline size_t step_env_bytes(int Na, int Ne) {
  Carver c{0, 0};
  carve_step(c, Na, Ne);
  return c.off;
}

// EntityBattle._walkable: the grid cell of a position is pathable (out of
// bounds is not); floor, then int64, as torch.floor(x).long()
__device__ __forceinline__ bool walkable(const Params& p, float x, float y) {
  const int64_t xi = static_cast<int64_t>(floorf(x));
  const int64_t yi = static_cast<int64_t>(floorf(y));
  const bool inb = xi >= 0 && xi < p.M && yi >= 0 && yi < p.M;
  const int64_t cx = clampl(xi, 0, p.M - 1), cy = clampl(yi, 0, p.M - 1);
  return inb && p.grid[cx * p.M + cy] != 0;
}

// EntityBattle._apply_pathing: clip to the border; on a real grid, blocked
// moves slide along walls (x only, then y only) or cancel
__device__ __forceinline__ void apply_pathing(const Params& p, float px, float py, float dx,
                                              float dy, bool ignores, float& ox, float& oy) {
  const float fx = clampf(add(px, dx), p.lo, p.hi), fy = clampf(add(py, dy), p.lo, p.hi);
  if (p.trivial) {
    ox = fx;
    oy = fy;
    return;
  }
  const bool ok = walkable(p, fx, fy) || ignores;
  // disp * axis_x and disp * axis_y, each product rounded (a zero keeps its sign)
  const float xx = clampf(add(px, mul(dx, 1.0f)), p.lo, p.hi);
  const float xy = clampf(add(py, mul(dy, 0.0f)), p.lo, p.hi);
  const float yx = clampf(add(px, mul(dx, 0.0f)), p.lo, p.hi);
  const float yy = clampf(add(py, mul(dy, 1.0f)), p.lo, p.hi);
  const bool ok_x = walkable(p, xx, xy), ok_y = walkable(p, yx, yy);
  if (ok) {
    ox = fx; oy = fy;
  } else if (ok_x) {
    ox = xx; oy = xy;
  } else if (ok_y) {
    ox = yx; oy = yy;
  } else {
    ox = px; oy = py;
  }
}

__global__ void __launch_bounds__(kEnvsPerBlock * 32)
combat_step_kernel(const Params p, const StepIO io, const int env_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= p.B) return;  // a whole warp: no lane of a live env leaves
  const int Na = p.Na, Ne = p.Ne, T = p.n_types;
  Carver carver{reinterpret_cast<uintptr_t>(smem) + static_cast<size_t>(warp) * env_bytes, 0};
  const StepSmem s = carve_step(carver, Na, Ne);
  const float* uf = p.unit_f;
  const int* ui = p.unit_i;
  const float INF = __int_as_float(0x7f800000);
  const int64_t t1 = io.t[b] + 1;

  // ---- load, decode the agents' actions ----
  for (int i = lane; i < Na; i += 32) {
    const int64_t k = static_cast<int64_t>(b) * Na + i;
    const int ty = static_cast<int>(io.a_type[k]);
    const float h = io.a_health[k];
    const bool alive = h > 0.0f && io.a_active[k] != 0;
    const bool med = ui[kIsMedivac * T + ty] != 0;
    const int64_t a = io.actions[k];
    const bool is_attack = a >= 6;
    const int64_t tag = clampl(a - 6, 0, p.nte + p.nta - 1);
    const int64_t atk = clampl(
        io.e_slot_of_tag[static_cast<int64_t>(b) * p.nte + clampl(tag, 0, p.nte - 1)], 0, Ne - 1);
    const int64_t hs = clampl(
        io.a_slot_of_tag[static_cast<int64_t>(b) * p.nta + clampl(tag - p.nte, 0, p.nta - 1)],
        0, Na - 1);
    s.a_ty[i] = ty;
    s.apx[i] = io.a_pos[2 * k];
    s.apy[i] = io.a_pos[2 * k + 1];
    s.a_hp[i] = add(h, io.a_shield[k]);
    s.alloc[i] = 0.0f;
    s.atk_slot[i] = static_cast<int>(atk);
    s.heal_slot[i] = static_cast<int>(hs);
    s.af[i] = (alive ? kAAlive : 0) | ((a >= 2 && a <= 5 && alive) ? kAMove : 0) |
              ((is_attack && !med && alive) ? kAAttack : 0) |
              ((is_attack && med && alive) ? kAHeal : 0) | (med ? kAMed : 0);
  }
  for (int j = lane; j < Ne; j += 32) {
    const int64_t k = static_cast<int64_t>(b) * Ne + j;
    const int ty = static_cast<int>(io.e_type[k]);
    s.e_ty[j] = ty;
    s.epx[j] = io.e_pos[2 * k];
    s.epy[j] = io.e_pos[2 * k + 1];
    s.e_wr[j] = uf[kWeaponRange * T + ty];
    s.ef[j] = (io.e_health[k] > 0.0f && io.e_active[k] != 0) ? kEAlive : 0;
  }
  __syncwarp();

  // ---- d_ea (Ne, Na): _FAR where the ally is dead ----
  for (int idx = lane; idx < Ne * Na; idx += 32) {
    const int j = idx / Na, i = idx - j * Na;
    const float d = norm2(sub(s.epx[j], s.apx[i]), sub(s.epy[j], s.apy[i]));
    s.dea[idx] = (s.af[i] & kAAlive) ? d : p.far_;
  }
  __syncwarp();

  // ---- each enemy's nearest ally, engagement, the kiting threat ----
  for (int j = lane; j < Ne; j += 32) {
    const float* row = s.dea + j * Na;
    float nd = row[0];
    int na = 0;
    for (int i = 1; i < Na; ++i) {
      if (row[i] < nd) {
        nd = row[i];
        na = i;
      }
    }
    s.nearest[j] = na;
    const int ty = s.e_ty[j];
    const bool engage = (s.ef[j] & kEAlive) && nd <= p.sight_range &&
                        ui[kIsMedivac * T + ty] == 0;
    if (engage) s.ef[j] |= kEEngage;
    if (p.tier >= 3) {
      const float lim = sub(s.e_wr[j], p.eps_focus);
      float td = INF;
      int ti = 0;
      for (int i = 0; i < Na; ++i) {
        const float d = uf[kWeaponRange * T + s.a_ty[i]] < lim ? row[i] : p.far_;
        if (i == 0 || d < td) {
          td = d;
          ti = i;
        }
      }
      s.thr_dist[j] = td;
      s.thr[j] = ti;
    }
    if (p.tier < 2) s.e_target[j] = na;
  }
  __syncwarp();

  // ---- focus fire (tier >= 2): enemies pick in slot order ----
  if (p.tier >= 2) {
    for (int j = 0; j < Ne; ++j) {
      const float* row = s.dea + j * Na;
      const float wr = s.e_wr[j];
      float bs = INF, bf = INF;
      int bsi = 0x7fffffff, bfi = 0x7fffffff;
      bool fin = false, rng_any = false;
      for (int i = lane; i < Na; i += 32) {
        const float d = row[i];
        const bool rng = d <= wr;
        const float hp = s.a_hp[i];
        const float eff = sub(hp, s.alloc[i]);
        const float tie = mul(p.eps_focus, d);
        const float sc = (rng && eff > 0.0f) ? add(eff, tie) : INF;
        const float fb = rng ? add(hp, tie) : INF;
        if (sc < bs || (sc == bs && i < bsi)) { bs = sc; bsi = i; }
        if (fb < bf || (fb == bf && i < bfi)) { bf = fb; bfi = i; }
        fin |= isfinite(sc);
        rng_any |= rng;
      }
      warp_argmin(bs, bsi);
      warp_argmin(bf, bfi);
      fin = __any_sync(kFull, fin);
      rng_any = __any_sync(kFull, rng_any);
      const int tgt = rng_any ? (fin ? bsi : bfi) : s.nearest[j];
      if (lane == 0) {
        s.e_target[j] = tgt;
        const float pot = mul(mul(uf[kDamage * T + s.e_ty[j]], b2f(s.ef[j] & kEAlive)),
                              b2f(rng_any));
        s.alloc[tgt] = add(s.alloc[tgt], pot);
      }
      __syncwarp();
    }
  }

  // ---- movement ----
  for (int i = lane; i < Na; i += 32) {
    const int64_t k = static_cast<int64_t>(b) * Na + i;
    const int ty = s.a_ty[i];
    const uint8_t f = s.af[i];
    const float spd = uf[kSpeed * T + ty];
    const int64_t ac = clampl(io.actions[k], 0, 5);
    // move_dirs rows: no-op, stop, north, south, east, west
    const float dirx = ac == 4 ? 1.0f : (ac == 5 ? -1.0f : 0.0f);
    const float diry = ac == 2 ? 1.0f : (ac == 3 ? -1.0f : 0.0f);
    const float sc = fminf(spd, p.move_amount);
    float dx, dy;
    if (f & kAMove) {
      dx = mul(sc, dirx);
      dy = mul(sc, diry);
    } else if (f & (kAAttack | kAHeal)) {
      const int tslot = (f & kAMed) ? s.heal_slot[i] : s.atk_slot[i];
      const float tx = (f & kAMed) ? s.apx[tslot] : s.epx[tslot];
      const float ty_ = (f & kAMed) ? s.apy[tslot] : s.epy[tslot];
      const float dlx = sub(tx, s.apx[i]), dly = sub(ty_, s.apy[i]);
      const float dist = norm2(dlx, dly);
      const float wrs = sub(uf[kWeaponRange * T + ty], p.slack);
      const bool need = dist > wrs;
      const float amt = fminf(spd, fmaxf(sub(dist, wrs), 0.0f));
      const float den = fmaxf(dist, p.eps_div);
      dx = mul(mul(amt, dvd(dlx, den)), b2f(need));
      dy = mul(mul(amt, dvd(dly, den)), b2f(need));
    } else {
      dx = 0.0f;
      dy = 0.0f;
    }
    apply_pathing(p, s.apx[i], s.apy[i], dx, dy, ui[kIgnoresPathing * T + ty] != 0,
                  s.napx[i], s.napy[i]);
  }
  {
    const float apx = io.attack_point[2 * b], apy = io.attack_point[2 * b + 1];
    for (int j = lane; j < Ne; j += 32) {
      const int64_t k = static_cast<int64_t>(b) * Ne + j;
      const int ty = s.e_ty[j];
      const uint8_t f = s.ef[j];
      const float spd = uf[kSpeed * T + ty], wr = s.e_wr[j];
      float amt, dist, dlx, dly;
      if (p.tier == 0) {
        // attack-move only: march on the attack point
        dlx = sub(apx, s.epx[j]);
        dly = sub(apy, s.epy[j]);
        dist = norm2(dlx, dly);
        amt = fminf(spd, dist);
      } else {
        // chase the target into weapon range, or advance on the attack point
        const int tg = s.e_target[j];
        const float gx = (f & kEEngage) ? s.apx[tg] : apx;
        const float gy = (f & kEEngage) ? s.apy[tg] : apy;
        dlx = sub(gx, s.epx[j]);
        dly = sub(gy, s.epy[j]);
        dist = norm2(dlx, dly);
        const float stop = (f & kEEngage) ? sub(wr, p.slack) : 0.0f;
        amt = fminf(spd, fmaxf(sub(dist, stop), 0.0f));
      }
      const float den = fmaxf(dist, p.eps_div);
      const float alive = b2f(f & kEAlive);
      float dx = mul(dvd(mul(amt, dlx), den), alive);
      float dy = mul(dvd(mul(amt, dly), den), alive);
      if (p.tier >= 3) {
        const bool cooling = sub(io.e_cd[k], p.step_mul) > 0.0f;
        const float td = s.thr_dist[j];
        if ((f & kEEngage) && cooling && td <= wr) {
          const int th = s.thr[j];
          float awx = sub(s.epx[j], s.apx[th]), awy = sub(s.epy[j], s.apy[th]);
          const float an = fmaxf(norm2(awx, awy), p.eps_div);
          awx = dvd(awx, an);
          awy = dvd(awy, an);
          const float back = fminf(spd, fmaxf(sub(sub(wr, p.slack), td), 0.0f));
          dx = mul(mul(back, awx), alive);
          dy = mul(mul(back, awy), alive);
        }
      }
      apply_pathing(p, s.epx[j], s.epy[j], dx, dy, ui[kIgnoresPathing * T + ty] != 0,
                    s.nepx[j], s.nepy[j]);
    }
  }
  __syncwarp();

  // ---- who fires and heals, from the moved positions ----
  for (int i = lane; i < Na; i += 32) {
    const int64_t k = static_cast<int64_t>(b) * Na + i;
    const int ty = s.a_ty[i];
    const float wr = uf[kWeaponRange * T + ty];
    const float cd = fmaxf(sub(io.a_cd[k], p.step_mul), 0.0f);
    const int atk = s.atk_slot[i];
    const float ad = norm2(sub(s.nepx[atk], s.napx[i]), sub(s.nepy[atk], s.napy[i]));
    const bool fires = (s.af[i] & kAAttack) && cd <= 0.0f && ad <= wr && (s.ef[atk] & kEAlive);
    s.a_dmg[i] = mul(uf[kDamage * T + ty], b2f(fires));
    uint8_t f = fires ? kFires : 0;
    if (p.has_medivac) {
      const int hs = s.heal_slot[i];
      const float hd = norm2(sub(s.napx[hs], s.napx[i]), sub(s.napy[hs], s.napy[i]));
      const bool can = (s.af[i] & kAHeal) && hd <= wr && (s.af[hs] & kAAlive) &&
                       io.a_energy[k] >= p.energy_per_step;
      s.heal[i] = mul(p.heal_per_step, b2f(can));
      if (can) f |= kCanHeal;
    }
    s.af2[i] = f;
  }
  for (int j = lane; j < Ne; j += 32) {
    const int64_t k = static_cast<int64_t>(b) * Ne + j;
    const int tg = s.e_target[j];
    const float cd = fmaxf(sub(io.e_cd[k], p.step_mul), 0.0f);
    const float ed = norm2(sub(s.napx[tg], s.nepx[j]), sub(s.napy[tg], s.nepy[j]));
    const bool fires = (s.ef[j] & kEEngage) && cd <= 0.0f && ed <= s.e_wr[j];
    s.e_dmg[j] = mul(uf[kDamage * T + s.e_ty[j]], b2f(fires));
    s.ef2[j] = fires ? kFires : 0;
  }
  __syncwarp();

  // ---- damage (shields first), heals, cooldowns, regeneration, deaths ----
  for (int j = lane; j < Ne; j += 32) {
    const int64_t k = static_cast<int64_t>(b) * Ne + j;
    const int ty = s.e_ty[j];
    float dmg = 0.0f;
    for (int i = 0; i < Na; ++i) {  // _scatter_sum: slot order from x[0]
      const float x = mul(s.a_dmg[i], b2f(s.atk_slot[i] == j));
      dmg = i == 0 ? x : add(dmg, x);
    }
    const float sh = io.e_shield[k], h = io.e_health[k];
    float shn = fmaxf(sub(sh, dmg), 0.0f);
    const float hn = fmaxf(sub(h, fmaxf(sub(dmg, sh), 0.0f)), 0.0f);
    const float cd = fmaxf(sub(io.e_cd[k], p.step_mul), 0.0f);
    const int64_t lh = dmg > 0.0f ? t1 : io.e_last_hit[k];
    const bool regen = (t1 - lh) >= p.regen_delay && hn > 0.0f;
    shn = fminf(add(shn, mul(p.regen_amt, b2f(regen))), uf[kShieldMax * T + ty]);
    shn = hn > 0.0f ? shn : 0.0f;
    const float hp = add(hn, shn);
    const bool active = io.e_active[k] != 0, dead = io.dead_e[k] != 0;
    const bool nd = !dead && active && hn <= 0.0f;
    const bool track = !dead && active && hn > 0.0f;
    const float prev = io.prev_e_hp[k];
    s.rd_e[j] = mul(prev, b2f(nd));
    s.rt_e[j] = mul(sub(prev, hp), b2f(track));
    const bool alive_now = hn > 0.0f && active;
    s.cnt_e[j] = (nd ? kNewDead : 0) | (alive_now ? kAliveNow : 0) |
                 ((alive_now && ui[kIsMedivac * T + ty] == 0) ? kCombatNow : 0);
    io.o_e_pos[2 * k] = s.nepx[j];
    io.o_e_pos[2 * k + 1] = s.nepy[j];
    io.o_e_health[k] = hn;
    io.o_e_shield[k] = shn;
    io.o_e_cd[k] = (s.ef2[j] & kFires) ? uf[kCooldown * T + ty] : cd;
    io.o_e_last_hit[k] = lh;
    io.o_prev_e_hp[k] = hp;
    io.o_dead_e[k] = dead || nd;
  }
  for (int i = lane; i < Na; i += 32) {
    const int64_t k = static_cast<int64_t>(b) * Na + i;
    const int ty = s.a_ty[i];
    const uint8_t f = s.af[i], f2 = s.af2[i];
    float dmg = 0.0f;
    for (int j = 0; j < Ne; ++j) {
      const float x = mul(s.e_dmg[j], b2f(s.e_target[j] == i));
      dmg = j == 0 ? x : add(dmg, x);
    }
    const float sh = io.a_shield[k], h = io.a_health[k];
    float shn = fmaxf(sub(sh, dmg), 0.0f);
    float hn = fmaxf(sub(h, fmaxf(sub(dmg, sh), 0.0f)), 0.0f);
    if (p.has_medivac) {
      float amt = 0.0f;
      for (int m = 0; m < Na; ++m) {
        const float x = mul(s.heal[m], b2f(s.heal_slot[m] == i));
        amt = m == 0 ? x : add(amt, x);
      }
      hn = hn > 0.0f ? fminf(add(hn, amt), uf[kHealthMax * T + ty]) : hn;
      const float e = sub(io.a_energy[k], mul(p.energy_per_step, b2f(f2 & kCanHeal)));
      const float r = mul(mul(p.energy_regen, b2f(f & kAMed)), b2f(f & kAAlive));
      io.o_a_energy[k] = fminf(fmaxf(add(e, r), 0.0f), uf[kEnergyMax * T + ty]);
    }
    const float cd = fmaxf(sub(io.a_cd[k], p.step_mul), 0.0f);
    const int64_t lh = dmg > 0.0f ? t1 : io.a_last_hit[k];
    const bool regen = (t1 - lh) >= p.regen_delay && hn > 0.0f;
    shn = fminf(add(shn, mul(p.regen_amt, b2f(regen))), uf[kShieldMax * T + ty]);
    shn = hn > 0.0f ? shn : 0.0f;
    const float hp = add(hn, shn);
    const bool active = io.a_active[k] != 0, dead = io.dead_a[k] != 0;
    const bool nd = !dead && active && hn <= 0.0f;
    const bool track = !dead && active && hn > 0.0f;
    const float prev = io.prev_a_hp[k];
    s.rd_a[i] = mul(prev, b2f(nd));
    s.rt_a[i] = mul(sub(prev, hp), b2f(track));
    const bool alive_now = hn > 0.0f && active;
    s.cnt_a[i] = (nd ? kNewDead : 0) | (alive_now ? kAliveNow : 0) |
                 ((alive_now && !(f & kAMed)) ? kCombatNow : 0);
    io.o_a_pos[2 * k] = s.napx[i];
    io.o_a_pos[2 * k + 1] = s.napy[i];
    io.o_a_health[k] = hn;
    io.o_a_shield[k] = shn;
    io.o_a_cd[k] = (f2 & kFires) ? uf[kCooldown * T + ty] : cd;
    io.o_a_last_hit[k] = lh;
    io.o_prev_a_hp[k] = hp;
    io.o_dead_a[k] = dead || nd;
  }
  __syncwarp();

  // ---- reward, termination, info (_seq_sum in slot order) ----
  if (lane == 0) {
    float de1 = s.rd_e[0], de2 = s.rt_e[0];
    int nd_e = 0, n_e = 0, c_e = 0;
    for (int j = 0; j < Ne; ++j) {
      if (j > 0) {
        de1 = add(de1, s.rd_e[j]);
        de2 = add(de2, s.rt_e[j]);
      }
      const int bits = s.cnt_e[j];
      nd_e += (bits & kNewDead) != 0;
      n_e += (bits & kAliveNow) != 0;
      c_e += (bits & kCombatNow) != 0;
    }
    float da1 = s.rd_a[0], da2 = s.rt_a[0];
    int nd_a = 0, n_a = 0, c_a = 0;
    for (int i = 0; i < Na; ++i) {
      if (i > 0) {
        da1 = add(da1, s.rd_a[i]);
        da2 = add(da2, s.rt_a[i]);
      }
      const int bits = s.cnt_a[i];
      nd_a += (bits & kNewDead) != 0;
      n_a += (bits & kAliveNow) != 0;
      c_a += (bits & kCombatNow) != 0;
    }
    const float delta_enemy = add(de1, de2);
    const float delta_deaths = mul(p.rdv, static_cast<float>(nd_e));
    const float delta_ally = mul(p.neg, add(da1, da2));
    float reward;
    if (p.only_positive) {
      reward = fabsf(add(delta_enemy, delta_deaths));
    } else {
      reward = sub(sub(add(delta_enemy, delta_deaths), delta_ally),
                   mul(p.rdv_neg, static_cast<float>(nd_a)));
    }
    bool lost, won;
    if (p.has_medivac) {
      lost = c_a == 0 && n_e > 0;
      won = c_e == 0 && n_a > 0;
    } else {
      lost = n_a == 0 && n_e > 0;
      won = n_e == 0 && n_a > 0;
    }
    const bool over = lost || won || (n_a == 0 && n_e == 0);
    if (p.sparse) {
      reward = won ? 1.0f : (lost ? -1.0f : 0.0f);
    } else {
      reward = add(reward, won ? p.reward_win : 0.0f);
      reward = add(reward, lost ? p.reward_defeat : 0.0f);
    }
    const bool at_limit = t1 >= p.episode_limit && !over;
    if (p.scale && !p.sparse) reward = mul(reward, p.inv_scale);
    io.o_t[b] = t1;
    io.o_reward[b] = reward;
    io.o_done[b] = over || at_limit;
    io.o_won[b] = won;
    io.o_at_limit[b] = at_limit;
  }
}

struct ObsSmem {
  float *px, *py, *d, *hf, *sf, *enf, *cdf, *red;
  int *ty, *tag;
  uint8_t *bits, *av;
};
enum ObsBits { kOActive = 1, kOAlive = 2, kOHealthy = 4 };

__host__ __device__ inline ObsSmem carve_observe(Carver& c, int N, int Na, int A) {
  ObsSmem s;
  s.px = c.take<float>(N); s.py = c.take<float>(N);
  s.d = c.take<float>(N * N);
  s.hf = c.take<float>(N); s.sf = c.take<float>(N);
  s.enf = c.take<float>(N); s.cdf = c.take<float>(N);
  s.red = c.take<float>(4);  // com x, com y, max_d_com
  s.ty = c.take<int>(N); s.tag = c.take<int>(N);
  s.bits = c.take<uint8_t>(N);
  s.av = c.take<uint8_t>(Na * A);
  return s;
}

inline size_t observe_env_bytes(int N, int Na, int A) {
  Carver c{0, 0};
  carve_observe(c, N, Na, A);
  return c.off;
}

__global__ void __launch_bounds__(kEnvsPerBlock * 32)
combat_observe_kernel(const Params p, const ObserveIO io, const int env_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= p.B) return;
  const int Na = p.Na, Ne = p.Ne, N = Na + Ne, A = p.A, T = p.n_types;
  Carver carver{reinterpret_cast<uintptr_t>(smem) + static_cast<size_t>(warp) * env_bytes, 0};
  const ObsSmem s = carve_observe(carver, N, Na, A);
  const float* uf = p.unit_f;
  const int* ui = p.unit_i;

  // ---- per entity: allies 0..Na-1, enemies Na..N-1 ----
  for (int e = lane; e < N; e += 32) {
    const bool ally = e < Na;
    const int64_t k = ally ? static_cast<int64_t>(b) * Na + e
                           : static_cast<int64_t>(b) * Ne + (e - Na);
    const int ty = static_cast<int>(ally ? io.a_type[k] : io.e_type[k]);
    const bool active = (ally ? io.a_active[k] : io.e_active[k]) != 0;
    const float h = ally ? io.a_health[k] : io.e_health[k];
    const float sh = ally ? io.a_shield[k] : io.e_shield[k];
    const float cd = ally ? io.a_cd[k] : io.e_cd[k];
    const float en = ally ? io.a_energy[k] : 0.0f;
    const bool alive = h > 0.0f && active;
    const float* pos = ally ? io.a_pos : io.e_pos;
    s.px[e] = pos[2 * k];
    s.py[e] = pos[2 * k + 1];
    s.ty[e] = ty;
    s.tag[e] = static_cast<int>(ally ? io.a_tags[k] : io.e_tags[k]);
    s.bits[e] = (active ? kOActive : 0) | (alive ? kOAlive : 0) | (h > 0.0f ? kOHealthy : 0);
    const float alive_f = b2f(alive), gate = b2f(ally && alive);
    s.hf[e] = mul(dvd(h, fmaxf(uf[kHealthMax * T + ty], p.eps_div)), alive_f);
    s.sf[e] = mul(dvd(sh, fmaxf(uf[kShieldMax * T + ty], p.eps_div)), alive_f);
    const float emax = uf[kEnergyMax * T + ty];
    s.enf[e] = mul(emax > 0.0f ? dvd(en, fmaxf(emax, p.eps_div)) : 0.0f, gate);
    s.cdf[e] = mul(dvd(cd, uf[kCooldown * T + ty]), gate);
  }
  __syncwarp();

  // ---- centre of mass over real units (slot order), /max(count, 1) ----
  if (lane < 2) {
    const float* x = lane ? s.py : s.px;
    float acc = 0.0f;
    int n = 0;
    for (int e = 0; e < N; ++e) {
      const bool active = s.bits[e] & kOActive;
      const float v = mul(x[e], b2f(active));
      acc = e == 0 ? v : add(acc, v);
      n += active;
    }
    s.red[lane] = dvd(acc, static_cast<float>(n > 1 ? n : 1));
  }
  __syncwarp();
  {
    const float cx = s.red[0], cy = s.red[1];
    float m = -__int_as_float(0x7f800000);
    for (int e = lane; e < N; e += 32)
      m = fmaxf(m, mul(norm2(sub(s.px[e], cx), sub(s.py[e], cy)), b2f(s.bits[e] & kOActive)));
    m = warp_max(m);
    if (lane == 0) s.red[2] = fmaxf(m, p.eps_div);
  }

  // ---- _dists: 0 on the diagonal, _FAR where either unit is dead ----
  for (int idx = lane; idx < N * N; idx += 32) {
    const int i = idx / N, j = idx - i * N;
    float d = 0.0f;
    if (i != j) {
      d = ((s.bits[i] & kOHealthy) && (s.bits[j] & kOHealthy))
              ? norm2(sub(s.px[i], s.px[j]), sub(s.py[i], s.py[j]))
              : p.far_;
    }
    s.d[idx] = d;
  }
  __syncwarp();

  // ---- get_avail_actions ----
  const int64_t avail_base = static_cast<int64_t>(b) * Na * A;
  for (int idx = lane; idx < Na * A; idx += 32) {
    const int i = idx / A, a = idx - i * A;
    const bool alive = s.bits[i] & kOAlive;
    const int ty = s.ty[i];
    const bool med = ui[kIsMedivac * T + ty] != 0;
    bool v = false;
    if (!alive) {
      v = a == 0;  // dead and inactive agents: only no-op
    } else if (a == 1) {
      v = true;  // stop
    } else if (a >= 2 && a < 6) {
      const float x = s.px[i], y = s.py[i], m = p.half_move;
      // n, s, e, w: the border, then (on a real grid) the probe's cell
      if (a == 2) v = add(y, m) < p.hi;
      else if (a == 3) v = sub(y, m) > p.lo;
      else if (a == 4) v = add(x, m) < p.hi;
      else v = sub(x, m) > p.lo;
      if (!p.trivial) {
        const float qx = a == 4 ? add(x, m) : (a == 5 ? add(x, -m) : add(x, 0.0f));
        const float qy = a == 2 ? add(y, m) : (a == 3 ? add(y, -m) : add(y, 0.0f));
        v = v && (walkable(p, qx, qy) || ui[kIgnoresPathing * T + ty] != 0);
      }
    } else if (a >= 6 && a < 6 + p.nte) {
      // attack: an enemy with this tag within shoot range
      if (!med) {
        for (int j = 0; j < Ne; ++j)
          v |= s.tag[Na + j] == a - 6 && s.d[i * N + Na + j] <= p.shoot_range;
      }
    } else if (a >= 6 + p.nte) {
      // heal: a non-Medivac ally with this tag within range
      if (med) {
        for (int m = 0; m < Na; ++m)
          v |= s.tag[m] - p.nte == a - 6 - p.nte && s.d[i * N + m] <= p.shoot_range &&
               ui[kIsMedivac * T + s.ty[m]] == 0;
      }
    }
    s.av[idx] = v;
    io.o_avail[avail_base + idx] = v;
  }
  __syncwarp();

  // ---- masks ----
  const int64_t mask_base = static_cast<int64_t>(b) * N * N;
  for (int idx = lane; idx < N * N; idx += 32) {
    const int i = idx / N, j = idx - i * N;
    io.o_obs_mask[mask_base + idx] =
        s.d[idx] > p.sight_range || !(s.bits[i] & kOActive) || !(s.bits[j] & kOActive);
  }
  for (int e = lane; e < N; e += 32)
    io.o_entity_mask[static_cast<int64_t>(b) * N + e] = !(s.bits[e] & kOActive);

  // ---- entity features, in get_entity_size's order ----
  const int n_tags = p.nte + p.nta;
  const int o_type = n_tags + A - 2, o_h = o_type + p.utb, o_en = o_h + 1 + p.sb;
  const int o_pc = o_en + 2, o_pm = o_pc + 2;
  const float cx = s.red[0], cy = s.red[1], mdc = s.red[2];
  const int64_t ent_base = static_cast<int64_t>(b) * N * p.nf;
  for (int idx = lane; idx < N * p.nf; idx += 32) {
    const int e = idx / p.nf, f = idx - e * p.nf;
    const float act = b2f(s.bits[e] & kOActive), alive = b2f(s.bits[e] & kOAlive);
    float v;
    if (f < n_tags) {
      v = mul(b2f(s.tag[e] == f), act);
    } else if (f < o_type) {
      v = mul(e < Na ? b2f(s.av[e * A + 2 + (f - n_tags)]) : 0.0f, act);
    } else if (f < o_h) {
      v = mul(b2f(ui[kLocalType * T + s.ty[e]] == f - o_type), act);
    } else if (f == o_h) {
      v = s.hf[e];
    } else if (f < o_en) {
      v = s.sf[e];
    } else if (f == o_en) {
      v = s.enf[e];
    } else if (f == o_en + 1) {
      v = s.cdf[e];
    } else if (f < o_pm) {
      const bool y = f == o_pc + 1;
      v = mul(mul(sub(y ? s.py[e] : s.px[e], y ? p.center_y : p.center_x), p.inv_map), alive);
    } else {
      const bool y = f == o_pm + 1;
      v = mul(dvd(sub(y ? s.py[e] : s.px[e], y ? cy : cx), mdc), alive);
    }
    io.o_entities[ent_base + idx] = v;
  }
}

// envs a block: kEnvsPerBlock, halved while their shared memory passes
// 48 KB (the flat env's widest maps); 0 where one env's alone does
int envs_per_block(size_t env_bytes) {
  int w = kEnvsPerBlock;
  while (w > 1 && w * env_bytes > kMaxSmemPerBlock) w /= 2;
  return w * env_bytes > kMaxSmemPerBlock ? 0 : w;
}

}  // namespace

extern "C" {

int combat_step_launch(const Params* p, const StepIO* io, cudaStream_t stream) {
  const int env_bytes = static_cast<int>(step_env_bytes(p->Na, p->Ne));
  const int w = envs_per_block(env_bytes);
  if (p->B < 1 || w == 0) return (int)cudaErrorInvalidValue;
  combat_step_kernel<<<(p->B + w - 1) / w, w * 32, env_bytes * w, stream>>>(*p, *io, env_bytes);
  return (int)cudaGetLastError();
}

int combat_observe_launch(const Params* p, const ObserveIO* io, cudaStream_t stream) {
  const int env_bytes = static_cast<int>(observe_env_bytes(p->Na + p->Ne, p->Na, p->A));
  const int w = envs_per_block(env_bytes);
  if (p->B < 1 || w == 0) return (int)cudaErrorInvalidValue;
  combat_observe_kernel<<<(p->B + w - 1) / w, w * 32, env_bytes * w, stream>>>(*p, *io,
                                                                             env_bytes);
  return (int)cudaGetLastError();
}

const char* combat_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
