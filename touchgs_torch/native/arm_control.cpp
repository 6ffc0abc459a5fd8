// Compliant arm controller — implementation.  See arm_control.h.
#include "arm_control.h"

#include <cmath>
#include <cstring>

namespace {

constexpr int kMaxJ = TGS_ARM_MAX_JOINTS;

struct Mat4 {
  double m[16];  // column-major
};

Mat4 identity4() {
  Mat4 t{};
  t.m[0] = t.m[5] = t.m[10] = t.m[15] = 1.0;
  return t;
}

Mat4 mul(const Mat4& a, const Mat4& b) {
  Mat4 c{};
  for (int col = 0; col < 4; ++col)
    for (int row = 0; row < 4; ++row) {
      double s = 0;
      for (int k = 0; k < 4; ++k) s += a.m[k * 4 + row] * b.m[col * 4 + k];
      c.m[col * 4 + row] = s;
    }
  return c;
}

// Standard DH link transform.
Mat4 dh_transform(double a, double alpha, double d, double theta) {
  const double ct = std::cos(theta), st = std::sin(theta);
  const double ca = std::cos(alpha), sa = std::sin(alpha);
  Mat4 t{};
  // column 0
  t.m[0] = ct; t.m[1] = st; t.m[2] = 0; t.m[3] = 0;
  // column 1
  t.m[4] = -st * ca; t.m[5] = ct * ca; t.m[6] = sa; t.m[7] = 0;
  // column 2
  t.m[8] = st * sa; t.m[9] = -ct * sa; t.m[10] = ca; t.m[11] = 0;
  // column 3
  t.m[12] = a * ct; t.m[13] = a * st; t.m[14] = d; t.m[15] = 1;
  return t;
}

struct Arm {
  int n = 0;
  double dh[kMaxJ][4];   // a, alpha, d, theta_offset
  double mass[kMaxJ];
  double com[kMaxJ][3];

  // FK of every joint frame; frames[i] = base->frame_i (after joint i).
  void chain(const double* q, Mat4* frames) const {
    Mat4 t = identity4();
    for (int i = 0; i < n; ++i) {
      t = mul(t, dh_transform(dh[i][0], dh[i][1], dh[i][2],
                              dh[i][3] + q[i]));
      frames[i] = t;
    }
  }

  void fk(const double* q, double* pose16) const {
    Mat4 frames[kMaxJ];
    chain(q, frames);
    const Mat4& t = n ? frames[n - 1] : identity4();
    std::memcpy(pose16, t.m, sizeof(double) * 16);
  }

  // Geometric Jacobian, [v; w], base frame, row-major 6 x n.
  void jacobian(const double* q, double* J) const {
    Mat4 frames[kMaxJ];
    chain(q, frames);
    const double* pe = &frames[n - 1].m[12];
    double zi[3] = {0, 0, 1}, pi[3] = {0, 0, 0};
    for (int i = 0; i < n; ++i) {
      if (i > 0) {
        const Mat4& f = frames[i - 1];
        zi[0] = f.m[8]; zi[1] = f.m[9]; zi[2] = f.m[10];
        pi[0] = f.m[12]; pi[1] = f.m[13]; pi[2] = f.m[14];
      } else {
        zi[0] = 0; zi[1] = 0; zi[2] = 1;
        pi[0] = pi[1] = pi[2] = 0;
      }
      const double r[3] = {pe[0] - pi[0], pe[1] - pi[1], pe[2] - pi[2]};
      const double v[3] = {zi[1] * r[2] - zi[2] * r[1],
                           zi[2] * r[0] - zi[0] * r[2],
                           zi[0] * r[1] - zi[1] * r[0]};
      for (int k = 0; k < 3; ++k) {
        J[k * n + i] = v[k];
        J[(k + 3) * n + i] = zi[k];
      }
    }
  }

  // Static gravity torques: tau_i = sum_j>=i  z_i x (c_j - p_i) . (m_j g).
  void gravity(const double* q, double* tau) const {
    Mat4 frames[kMaxJ];
    chain(q, frames);
    const double g[3] = {0, 0, -9.81};
    for (int i = 0; i < n; ++i) tau[i] = 0;
    for (int j = 0; j < n; ++j) {
      if (mass[j] == 0) continue;
      // COM of link j in base frame
      const Mat4& fj = frames[j];
      double cj[3];
      for (int k = 0; k < 3; ++k)
        cj[k] = fj.m[12 + k] + fj.m[0 + k] * com[j][0] +
                fj.m[4 + k] * com[j][1] + fj.m[8 + k] * com[j][2];
      const double w[3] = {mass[j] * g[0], mass[j] * g[1], mass[j] * g[2]};
      for (int i = 0; i <= j; ++i) {
        double zi[3] = {0, 0, 1}, pi[3] = {0, 0, 0};
        if (i > 0) {
          const Mat4& f = frames[i - 1];
          zi[0] = f.m[8]; zi[1] = f.m[9]; zi[2] = f.m[10];
          pi[0] = f.m[12]; pi[1] = f.m[13]; pi[2] = f.m[14];
        }
        const double r[3] = {cj[0] - pi[0], cj[1] - pi[1], cj[2] - pi[2]};
        const double v[3] = {zi[1] * r[2] - zi[2] * r[1],
                             zi[2] * r[0] - zi[0] * r[2],
                             zi[0] * r[1] - zi[1] * r[0]};
        // gravity-compensating torque OPPOSES the load
        tau[i] -= v[0] * w[0] + v[1] * w[1] + v[2] * w[2];
      }
    }
  }
};

// rotation-vector error of R_target * R^T (angle-axis, safe at 0 AND pi)
void rot_error(const double* pose, const double* target, double* w3) {
  // E = Rt * R^T
  double e[9];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      double s = 0;
      for (int k = 0; k < 3; ++k)
        s += target[k * 4 + r] * pose[k * 4 + c];  // Rt(r,k) * R(c,k)^T
      e[c * 3 + r] = s;
    }
  const double tr = e[0] + e[4] + e[8];
  const double cs = std::fmin(1.0, std::fmax(-1.0, (tr - 1.0) * 0.5));
  const double ang = std::acos(cs);
  if (ang < 1e-9) {
    // small angle: E - E^T ~ 2 [w]_x
    w3[0] = 0.5 * (e[5] - e[7]);
    w3[1] = 0.5 * (e[6] - e[2]);
    w3[2] = 0.5 * (e[1] - e[3]);
    return;
  }
  if (ang > M_PI - 1e-4) {
    // near/at pi E is (almost) symmetric and E - E^T loses the axis; use
    // the diagonal form E = 2 a a^T - I (a = unit axis), signs from the
    // off-diagonals.  Without this branch a flipped target pose produced
    // ZERO corrective torque (r4 review finding).
    double a[3] = {std::sqrt(std::fmax(0.0, (e[0] + 1.0) * 0.5)),
                   std::sqrt(std::fmax(0.0, (e[4] + 1.0) * 0.5)),
                   std::sqrt(std::fmax(0.0, (e[8] + 1.0) * 0.5))};
    // pick the largest component as reference for sign recovery
    int m = 0;
    if (a[1] > a[m]) m = 1;
    if (a[2] > a[m]) m = 2;
    if (m == 0) {
      a[1] = std::copysign(a[1], e[0 * 3 + 1] + e[1 * 3 + 0]);
      a[2] = std::copysign(a[2], e[0 * 3 + 2] + e[2 * 3 + 0]);
    } else if (m == 1) {
      a[0] = std::copysign(a[0], e[0 * 3 + 1] + e[1 * 3 + 0]);
      a[2] = std::copysign(a[2], e[1 * 3 + 2] + e[2 * 3 + 1]);
    } else {
      a[0] = std::copysign(a[0], e[0 * 3 + 2] + e[2 * 3 + 0]);
      a[1] = std::copysign(a[1], e[1 * 3 + 2] + e[2 * 3 + 1]);
    }
    const double n = std::sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
    const double kk = (n > 0) ? ang / n : 0.0;
    w3[0] = kk * a[0];
    w3[1] = kk * a[1];
    w3[2] = kk * a[2];
    return;
  }
  const double axis[3] = {e[5] - e[7], e[6] - e[2], e[1] - e[3]};
  const double k = ang / (2.0 * std::sin(ang));
  w3[0] = k * axis[0];
  w3[1] = k * axis[1];
  w3[2] = k * axis[2];
}

void compliance_tau(const Arm& arm, const double* q, const double* dq,
                    const double* target, const double* stiff6,
                    const double* damp6, double* tau) {
  const int n = arm.n;
  double pose[16], J[6 * kMaxJ];
  arm.fk(q, pose);
  arm.jacobian(q, J);
  double err[6];
  err[0] = target[12] - pose[12];
  err[1] = target[13] - pose[13];
  err[2] = target[14] - pose[14];
  rot_error(pose, target, err + 3);
  double xdot[6] = {0, 0, 0, 0, 0, 0};
  for (int r = 0; r < 6; ++r)
    for (int i = 0; i < n; ++i) xdot[r] += J[r * n + i] * dq[i];
  double f[6];
  for (int r = 0; r < 6; ++r)
    f[r] = stiff6[r] * err[r] - damp6[r] * xdot[r];
  double taug[kMaxJ];
  arm.gravity(q, taug);
  for (int i = 0; i < n; ++i) {
    double s = 0;
    for (int r = 0; r < 6; ++r) s += J[r * n + i] * f[r];
    tau[i] = s + taug[i];
  }
}

struct Sim {
  Arm* arm = nullptr;
  int n = 0;
  double q[kMaxJ], dq[kMaxJ];
  double inertia[kMaxJ];
  double damping = 1.0;
  double plane_z = -1e9;
  double k_contact = 0.0;
  // guarded-move command state
  double cmd_pose[16];
  bool cmd_init = false;
  bool contact_latched = false;

  void contact_force(double* f3) const {
    double pose[16];
    arm->fk(q, pose);
    const double pen = plane_z - pose[14];  // penetration below the plane
    f3[0] = 0; f3[1] = 0;
    f3[2] = (k_contact > 0 && pen > 0) ? k_contact * pen : 0.0;
  }

  void step(const double* target, const double* stiff6, const double* damp6,
            double dt) {
    double tau[kMaxJ];
    compliance_tau(*arm, q, dq, target, stiff6, damp6, tau);
    // subtract the gravity load itself (the sim's plant has gravity acting;
    // compliance_tau added compensation, so the two cancel — apart from the
    // contact reaction mapped through J^T)
    double taug[kMaxJ];
    arm->gravity(q, taug);
    double f3[3];
    contact_force(f3);
    double J[6 * kMaxJ];
    arm->jacobian(q, J);
    for (int i = 0; i < n; ++i) {
      double tc = 0;
      for (int k = 0; k < 3; ++k) tc += J[k * n + i] * f3[k];
      const double acc =
          (tau[i] - taug[i] + tc - damping * dq[i]) / inertia[i];
      dq[i] += acc * dt;
      q[i] += dq[i] * dt;
    }
  }
};

}  // namespace

extern "C" {

void* tgs_arm_create(int n_joints, const double* dh, const double* mass,
                     const double* com) {
  if (n_joints < 1 || n_joints > kMaxJ) return nullptr;
  Arm* a = new Arm();
  a->n = n_joints;
  for (int i = 0; i < n_joints; ++i) {
    for (int k = 0; k < 4; ++k) a->dh[i][k] = dh[i * 4 + k];
    a->mass[i] = mass ? mass[i] : 0.0;
    for (int k = 0; k < 3; ++k) a->com[i][k] = com ? com[i * 3 + k] : 0.0;
  }
  return a;
}

void tgs_arm_destroy(void* h) { delete static_cast<Arm*>(h); }

void tgs_arm_fk(void* h, const double* q, double* pose16) {
  static_cast<Arm*>(h)->fk(q, pose16);
}

void tgs_arm_jacobian(void* h, const double* q, double* J) {
  static_cast<Arm*>(h)->jacobian(q, J);
}

void tgs_arm_gravity(void* h, const double* q, double* tau) {
  static_cast<Arm*>(h)->gravity(q, tau);
}

void tgs_arm_compliance_tau(void* h, const double* q, const double* dq,
                            const double* target_pose16,
                            const double* stiff6, const double* damp6,
                            double* tau) {
  compliance_tau(*static_cast<Arm*>(h), q, dq, target_pose16, stiff6, damp6,
                 tau);
}

void* tgs_sim_create(void* arm, const double* q0, const double* inertia,
                     double damping, double plane_z, double k_contact) {
  Arm* a = static_cast<Arm*>(arm);
  if (!a) return nullptr;
  Sim* s = new Sim();
  s->arm = a;
  s->n = a->n;
  for (int i = 0; i < a->n; ++i) {
    s->q[i] = q0 ? q0[i] : 0.0;
    s->dq[i] = 0.0;
    s->inertia[i] = inertia ? inertia[i] : 0.1;
  }
  s->damping = damping;
  s->plane_z = plane_z;
  s->k_contact = k_contact;
  return s;
}

void tgs_sim_destroy(void* s) { delete static_cast<Sim*>(s); }

void tgs_sim_state(void* s, double* q, double* dq) {
  Sim* sim = static_cast<Sim*>(s);
  for (int i = 0; i < sim->n; ++i) {
    if (q) q[i] = sim->q[i];
    if (dq) dq[i] = sim->dq[i];
  }
}

void tgs_sim_contact_force(void* s, double* f3) {
  static_cast<Sim*>(s)->contact_force(f3);
}

void tgs_sim_step_compliance(void* s, const double* target_pose16,
                             const double* stiff6, const double* damp6,
                             double dt) {
  static_cast<Sim*>(s)->step(target_pose16, stiff6, damp6, dt);
}

int tgs_sim_step_guarded(void* s, const double* dir3, double speed,
                         double f_stop, const double* stiff6,
                         const double* damp6, double dt, double tol_n) {
  Sim* sim = static_cast<Sim*>(s);
  if (!sim->cmd_init) {
    sim->arm->fk(sim->q, sim->cmd_pose);
    sim->cmd_init = true;
  }
  double f3[3];
  sim->contact_force(f3);
  const double f_along =
      -(f3[0] * dir3[0] + f3[1] * dir3[1] + f3[2] * dir3[2]);
  if (!sim->contact_latched && f_along >= f_stop) sim->contact_latched = true;
  if (!sim->contact_latched) {
    // approach: advance the commanded pose along dir at `speed`
    for (int k = 0; k < 3; ++k) sim->cmd_pose[12 + k] += dir3[k] * speed * dt;
  } else {
    // force hold: proportional force loop moves the setpoint along dir.
    // The loop gain must invert the Cartesian stiffness AS SEEN ALONG the
    // approach direction — with anisotropic stiffness, k_dir = Σ k_i·d_i²
    // (dir3 is expected unit-norm; normalize defensively).
    double d2 = dir3[0] * dir3[0] + dir3[1] * dir3[1] + dir3[2] * dir3[2];
    if (d2 <= 0) d2 = 1.0;
    double k_dir = (stiff6[0] * dir3[0] * dir3[0] +
                    stiff6[1] * dir3[1] * dir3[1] +
                    stiff6[2] * dir3[2] * dir3[2]) / d2;
    const double kf = 0.5 / (k_dir > 0 ? k_dir : 1.0);
    const double e = f_stop - f_along;
    for (int k = 0; k < 3; ++k) sim->cmd_pose[12 + k] += dir3[k] * kf * e;
  }
  sim->step(sim->cmd_pose, stiff6, damp6, dt);
  return (sim->contact_latched && std::fabs(f_stop - f_along) <= tol_n) ? 1
                                                                        : 0;
}

}  // extern "C"
