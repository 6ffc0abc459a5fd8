// Compliant arm controller for touch-capture motions (C ABI).
//
// Native equivalent of the reference's compliant joint controller used to
// press the DenseTact sensor against a surface during data collection
// (data_collection/ros1/capturedata/src/arm_compliant_control.cpp,
// 956 LoC, KDL + robot_controllers_interface).  Clean-room design, no ROS/KDL:
//
//  - serial arm from standard DH parameters (n <= TGS_ARM_MAX_JOINTS);
//  - forward kinematics + geometric Jacobian + static gravity torques;
//  - Cartesian compliance law  tau = J^T (K dx + D dv) + tau_gravity
//    with rotation-vector orientation error;
//  - guarded approach: servo the tool along a Cartesian direction until the
//    measured (or simulated) contact force reaches a setpoint, then hold it
//    with a proportional force loop — the touch-capture primitive;
//  - a built-in fixed-step joint-space simulator (diagonal inertia +
//    viscous damping + optional plane contact) so the control law is
//    testable without hardware.
//
// Plain C ABI for ctypes (no pybind11 in this environment).
#pragma once

#include <cstdint>

#define TGS_ARM_MAX_JOINTS 16

extern "C" {

// dh: n rows of [a, alpha, d, theta_offset] (standard DH).
// mass: n link masses (kg); com: n rows of [x, y, z] link COM in the link
// frame (used for gravity compensation; pass zeros to disable).
void* tgs_arm_create(int n_joints, const double* dh, const double* mass,
                     const double* com);
void tgs_arm_destroy(void* h);

// pose: column-major 4x4 tool transform in the base frame.
void tgs_arm_fk(void* h, const double* q, double* pose16);

// J: row-major 6 x n geometric Jacobian ([v; w] convention, base frame).
void tgs_arm_jacobian(void* h, const double* q, double* J);

// Static gravity torques (base-frame g = [0, 0, -9.81]).
void tgs_arm_gravity(void* h, const double* q, double* tau);

// Cartesian compliance torques toward a target pose:
//   tau = J^T (K * [dp; drot] - D * J dq) + gravity(q)
// stiff6/damp6 are the diagonal K and D (N/m, Nm/rad; N s/m, Nm s/rad).
void tgs_arm_compliance_tau(void* h, const double* q, const double* dq,
                            const double* target_pose16,
                            const double* stiff6, const double* damp6,
                            double* tau);

// ---- simulator + guarded touch move -------------------------------------

// Create a simulator over the arm: diagonal joint inertia (kg m^2) and
// viscous joint damping.  Optional contact plane z = plane_z with normal
// +z and contact stiffness k_contact (N/m): penetration produces a tool
// force the guarded controller feels (set k_contact = 0 for free space).
void* tgs_sim_create(void* arm, const double* q0, const double* inertia,
                     double damping, double plane_z, double k_contact);
void tgs_sim_destroy(void* s);
void tgs_sim_state(void* s, double* q, double* dq);
// Simulated contact force on the tool, base frame (3-vector).
void tgs_sim_contact_force(void* s, double* f3);

// One compliance-control simulation step toward target_pose16 (dt seconds).
void tgs_sim_step_compliance(void* s, const double* target_pose16,
                             const double* stiff6, const double* damp6,
                             double dt);

// Guarded touch move: advance the target along dir3 (unit, base frame) at
// `speed` m/s until |contact force along dir3| >= f_stop (N); afterwards a
// proportional force loop holds f_stop.  Returns 1 once contact is held
// within tol_n of the setpoint, else 0.  Call repeatedly (dt per call);
// state (current commanded pose) lives in the simulator handle.
int tgs_sim_step_guarded(void* s, const double* dir3, double speed,
                         double f_stop, const double* stiff6,
                         const double* damp6, double dt, double tol_n);

}  // extern "C"
