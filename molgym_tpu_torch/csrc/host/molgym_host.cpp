// molgym-tpu native host runtime: batched molecular energy/reward evaluation.
//
// Role: the host-side counterpart of the TPU rollout. The reference spends
// its step time in SCINE Sparrow C++ SCF calls made one-by-one from Python
// (reference molgym/reward.py:36-55, molgym/calculator.py); here the whole
// env batch crosses the Python boundary ONCE per vector-step (via
// jax.experimental.io_callback -> ctypes) and fans out over a persistent
// thread pool. Built-in semiempirical-style pair potentials (Lennard-Jones,
// Morse) provide a fast native backend; external QM backends (Sparrow) plug
// in on the Python side behind the same batched interface.
//
// Exposed C ABI (ctypes):
//   mg_batch_reward(...)   batched interaction rewards
//   mg_energy(...)         single-molecule energy
//   mg_gradients(...)      single-molecule analytic gradients
//   mg_pool_stats(...)     cumulative evaluation counters (observability)
//
// Build: make -C csrc   (g++ -O3 -shared -fPIC, no external deps)

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" double mg_eht_energy(const int* zs, const double* positions, int n);
extern "C" double mg_nddo_energy(const int* zs, const double* positions, int n,
                                 int charge, int multiplicity);
extern "C" int mg_nddo_gradients(const int* zs, const double* positions, int n,
                                 int charge, int multiplicity, double* grad);

namespace {

inline double eht_total_energy(const int* zs, const double* pos, int n) {
  return mg_eht_energy(zs, pos, n);
}

// ---------------------------------------------------------------------------
// Element data (covalent radii, Angstrom; index = atomic number, 0 = null)
// ---------------------------------------------------------------------------
constexpr int kMaxZ = 36;
constexpr double kRadii[kMaxZ] = {
    0.20, 0.31, 0.28, 1.28, 0.96, 0.84, 0.76, 0.71, 0.66, 0.57, 0.58, 1.66,
    1.41, 1.21, 1.11, 1.07, 1.05, 1.02, 1.06, 2.03, 1.76, 1.50, 1.50, 1.50,
    1.50, 1.50, 1.50, 1.50, 1.50, 1.50, 1.50, 1.50, 1.50, 1.50, 1.50, 1.20};

inline double radius(int z) {
  if (z < 0 || z >= kMaxZ) return 1.5;
  return kRadii[z];
}

enum Method : int {
  kLennardJones = 0,
  kMorse = 1,
  kExtendedHuckel = 2,
  kPM6 = 3  // native NDDO SCF (csrc/nddo.cpp), reference reward parity
};

struct PairParams {
  double epsilon = 0.15;  // well depth, Hartree-like units
  double morse_a = 1.7;   // Morse width parameter (1/Angstrom)
};

// ---------------------------------------------------------------------------
// Pair potentials + analytic gradients
// ---------------------------------------------------------------------------
inline double pair_energy(int method, const PairParams& p, int zi, int zj,
                          double r) {
  const double r_eq = radius(zi) + radius(zj);
  if (method == kMorse) {
    const double x = std::exp(-p.morse_a * (r - r_eq));
    return p.epsilon * (x * x - 2.0 * x);
  }
  const double sigma = r_eq / std::pow(2.0, 1.0 / 6.0);
  const double s6 = std::pow(sigma * sigma / (r * r), 3.0);
  return 4.0 * p.epsilon * (s6 * s6 - s6);
}

inline double pair_denergy_dr(int method, const PairParams& p, int zi, int zj,
                              double r) {
  const double r_eq = radius(zi) + radius(zj);
  if (method == kMorse) {
    const double x = std::exp(-p.morse_a * (r - r_eq));
    return p.epsilon * (-2.0 * p.morse_a) * (x * x - x);
  }
  const double sigma = r_eq / std::pow(2.0, 1.0 / 6.0);
  const double s6 = std::pow(sigma * sigma / (r * r), 3.0);
  return 4.0 * p.epsilon * (-12.0 * s6 * s6 + 6.0 * s6) / r;
}

// Geometry-keyed energy cache for the SCF backends. Atoms never move once
// placed on the canvas, so the previous-canvas energy E(prev) of step t is
// bit-identical to the E(all) computed at step t-1, and single-atom energies
// recur constantly — exact-byte keying (FNV-1a over method/zs/positions)
// turns ~3 SCF evaluations per env-step into ~1. This extends the
// reference's atomic-energy cache (molgym/reward.py:57-62) to whole
// canvases; SCF energies are deterministic, so hits are exact. Entries carry
// a SECOND, independent hash of the same key bytes that is verified on
// lookup: a primary-hash collision (the only way a hit could be wrong) is
// detected unless both hashes collide simultaneously (~2^-128), and falls
// back to a recompute.
struct EnergyCache {
  std::mutex mu;
  struct Entry {
    uint64_t check;  // secondary hash of the key bytes, verified on get
    double e;
  };
  std::unordered_map<uint64_t, Entry> map;
  std::atomic<long long> hits{0}, misses{0};

  struct Key {
    uint64_t k, check;
  };

  static Key key(int method, const int* zs, const double* pos, int n) {
    uint64_t h1 = 1469598103934665603ull;   // FNV-1a
    uint64_t h2 = 0x9e3779b97f4a7c15ull;    // independent splitmix-style mix
    auto mix = [&h1, &h2](const unsigned char* p, size_t len) {
      for (size_t i = 0; i < len; ++i) {
        h1 ^= p[i];
        h1 *= 1099511628211ull;
        h2 += p[i];
        h2 ^= h2 >> 30;
        h2 *= 0xbf58476d1ce4e5b9ull;
      }
    };
    mix(reinterpret_cast<const unsigned char*>(&method), sizeof(method));
    mix(reinterpret_cast<const unsigned char*>(&n), sizeof(n));
    mix(reinterpret_cast<const unsigned char*>(zs), sizeof(int) * n);
    mix(reinterpret_cast<const unsigned char*>(pos), sizeof(double) * 3 * n);
    return Key{h1, h2};
  }

  bool get(const Key& k, double* e) {
    std::lock_guard<std::mutex> lock(mu);
    auto it = map.find(k.k);
    if (it == map.end() || it->second.check != k.check) return false;
    *e = it->second.e;
    return true;
  }

  void put(const Key& k, double e) {
    std::lock_guard<std::mutex> lock(mu);
    if (map.size() > 200000) map.clear();  // bound memory; correctness-free
    map.emplace(k.k, Entry{k.check, e});
  }
};

EnergyCache& energy_cache() {
  static EnergyCache c;
  return c;
}

double total_energy(int method, const PairParams& p, const int* zs,
                    const double* pos, int n) {
  if (method == kExtendedHuckel || method == kPM6) {
    EnergyCache& cache = energy_cache();
    const EnergyCache::Key k = EnergyCache::key(method, zs, pos, n);
    double e;
    if (cache.get(k, &e)) {
      cache.hits.fetch_add(1);
      return e;
    }
    cache.misses.fetch_add(1);
    e = method == kExtendedHuckel
            ? eht_total_energy(zs, pos, n)
            // neutral, multiplicity (sum Z) % 2 + 1 (reward.py:17-19,28-32)
            : mg_nddo_energy(zs, pos, n, /*charge=*/0, /*multiplicity=*/0);
    cache.put(k, e);
    return e;
  }
  double e = 0.0;
  for (int i = 0; i < n; ++i) {
    for (int j = i + 1; j < n; ++j) {
      const double dx = pos[3 * i] - pos[3 * j];
      const double dy = pos[3 * i + 1] - pos[3 * j + 1];
      const double dz = pos[3 * i + 2] - pos[3 * j + 2];
      const double r = std::sqrt(std::max(dx * dx + dy * dy + dz * dz, 1e-12));
      e += pair_energy(method, p, zs[i], zs[j], r);
    }
  }
  return e;
}

void total_gradients(int method, const PairParams& p, const int* zs,
                     const double* pos, int n, double* grad) {
  std::memset(grad, 0, sizeof(double) * 3 * n);
  if (method == kPM6) {
    mg_nddo_gradients(zs, pos, n, 0, 0, grad);
    return;
  }
  if (method == kExtendedHuckel) {
    // central finite differences (EHT has no cheap analytic gradient here)
    const double eps = 1e-4;
    std::vector<double> work(pos, pos + 3 * n);
    for (int i = 0; i < 3 * n; ++i) {
      work[i] = pos[i] + eps;
      const double ep = eht_total_energy(zs, work.data(), n);
      work[i] = pos[i] - eps;
      const double em = eht_total_energy(zs, work.data(), n);
      work[i] = pos[i];
      grad[i] = (ep - em) / (2.0 * eps);
    }
    return;
  }
  for (int i = 0; i < n; ++i) {
    for (int j = i + 1; j < n; ++j) {
      const double dx = pos[3 * i] - pos[3 * j];
      const double dy = pos[3 * i + 1] - pos[3 * j + 1];
      const double dz = pos[3 * i + 2] - pos[3 * j + 2];
      const double r = std::sqrt(std::max(dx * dx + dy * dy + dz * dz, 1e-12));
      const double dEdr = pair_denergy_dr(method, p, zs[i], zs[j], r);
      const double fx = dEdr * dx / r, fy = dEdr * dy / r, fz = dEdr * dz / r;
      grad[3 * i] += fx;
      grad[3 * i + 1] += fy;
      grad[3 * i + 2] += fz;
      grad[3 * j] -= fx;
      grad[3 * j + 1] -= fy;
      grad[3 * j + 2] -= fz;
    }
  }
}

// ---------------------------------------------------------------------------
// Persistent thread pool (created once, reused across io_callback invocations)
// ---------------------------------------------------------------------------
class ThreadPool {
 public:
  explicit ThreadPool(int n_threads) : stop_(false) {
    for (int i = 0; i < n_threads; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lock(mu_);
            cv_.wait(lock, [this] { return stop_ || !tasks_.empty(); });
            if (stop_ && tasks_.empty()) return;
            task = std::move(tasks_.front());
            tasks_.pop();
          }
          task();
        }
      });
    }
  }

  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  void run_batch(int n, const std::function<void(int)>& fn) {
    if (n <= 0) return;
    std::atomic<int> next(0), done(0);
    std::mutex done_mu;
    std::condition_variable done_cv;
    const int n_workers = static_cast<int>(workers_.size());
    const int n_shards = std::min(n, n_workers);
    {
      std::unique_lock<std::mutex> lock(mu_);
      for (int s = 0; s < n_shards; ++s) {
        tasks_.push([&next, &done, &done_mu, &done_cv, &fn, n, n_shards] {
          for (;;) {
            const int i = next.fetch_add(1);
            if (i >= n) break;
            fn(i);
          }
          // Signal while holding done_mu: once the caller sees every shard
          // done it returns, and done_cv, a local of its frame, is gone.
          std::unique_lock<std::mutex> dlock(done_mu);
          done.fetch_add(1);
          done_cv.notify_one();
        });
      }
    }
    cv_.notify_all();
    std::unique_lock<std::mutex> dlock(done_mu);
    done_cv.wait(dlock, [&done, n_shards] { return done.load() >= n_shards; });
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> tasks_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

ThreadPool& pool() {
  static ThreadPool p(
      std::max(2u, std::thread::hardware_concurrency()));
  return p;
}

std::atomic<long long> g_total_evals(0);
std::atomic<long long> g_total_batches(0);

}  // namespace

extern "C" {

// Batched interaction reward: r_i = -(E(canvas_i + new_i) - E(canvas_i) -
// E(new atom alone)) for every env in the batch, in parallel (reference
// semantics: molgym/reward.py:36-55). Invalid entries are skipped.
//
//   zs:        [n_mols, max_atoms] atomic numbers (0 = empty slot)
//   positions: [n_mols, max_atoms, 3] Angstrom
//   n_atoms:   [n_mols]
//   new_z:     [n_mols]; new_pos: [n_mols, 3]
//   valid:     [n_mols] (0/1)
//   rewards:   [n_mols] out
int mg_batch_reward(int n_mols, int max_atoms, const int* zs,
                    const double* positions, const int* n_atoms,
                    const int* new_z, const double* new_pos,
                    const unsigned char* valid, int method, double epsilon,
                    double* rewards) {
  PairParams params;
  params.epsilon = epsilon;
  std::atomic<long long> evals(0);
  pool().run_batch(n_mols, [&](int m) {
    if (!valid[m]) {
      rewards[m] = 0.0;
      return;
    }
    evals.fetch_add(3);  // e_all, e_prev, e_atom
    const int n = n_atoms[m];
    // assemble compacted molecule + the new atom
    std::vector<int> z_all(n + 1);
    std::vector<double> p_all(3 * (n + 1));
    int count = 0;
    for (int a = 0; a < max_atoms && count < n; ++a) {
      const int z = zs[m * max_atoms + a];
      if (z <= 0) continue;
      z_all[count] = z;
      std::memcpy(&p_all[3 * count], &positions[(m * max_atoms + a) * 3],
                  3 * sizeof(double));
      ++count;
    }
    z_all[count] = new_z[m];
    std::memcpy(&p_all[3 * count], &new_pos[3 * m], 3 * sizeof(double));

    const double e_all = total_energy(method, params, z_all.data(),
                                      p_all.data(), count + 1);
    const double e_prev =
        total_energy(method, params, z_all.data(), p_all.data(), count);
    // E(new atom alone): zero for pair potentials, but NOT for electronic-
    // structure methods (EHT) where the isolated atom carries its orbital
    // energies (reference semantics: reward.py:43-44,57-62).
    const double e_atom =
        total_energy(method, params, &z_all[count], &p_all[3 * count], 1);
    rewards[m] = -(e_all - e_prev - e_atom);
    // A non-converged SCF (PM6) yields NaN; map it to a very negative reward
    // so the env's min_reward clamp terminates the episode (reference
    // environment.py:68-70 semantics for runaway energies).
    if (!std::isfinite(rewards[m])) rewards[m] = -1e6;
  });
  g_total_evals.fetch_add(evals.load());
  g_total_batches.fetch_add(1);
  return 0;
}

double mg_energy(const int* zs, const double* positions, int n, int method,
                 double epsilon) {
  PairParams params;
  params.epsilon = epsilon;
  return total_energy(method, params, zs, positions, n);
}

int mg_gradients(const int* zs, const double* positions, int n, int method,
                 double epsilon, double* grad_out) {
  PairParams params;
  params.epsilon = epsilon;
  total_gradients(method, params, zs, positions, n, grad_out);
  return 0;
}

void mg_pool_stats(long long* total_evals, long long* total_batches) {
  *total_evals = g_total_evals.load();
  *total_batches = g_total_batches.load();
}

}  // extern "C"
