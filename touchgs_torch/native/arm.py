"""ctypes bindings for the native compliant arm controller (port of
``touchgs_tpu/native/arm.py``).

The Python side of ``arm_control.cpp``, the counterpart of the reference's
compliant capture controller
(``data_collection/ros1/capturedata/src/arm_compliant_control.cpp``): a
serial arm in standard DH with forward kinematics, the geometric Jacobian,
gravity torques and Cartesian compliance torques, and a fixed-step
simulator with an optional contact plane for compliance moves and the
guarded approach-until-force move of a touch capture.

The methods take tensors or array-likes and return float64 CPU tensors.
Poses cross the C ABI column-major: `CompliantArm.fk` reads the 16 values
as the columns of the 4x4 pose, and a target pose is passed by its columns
(numpy's ``order="F"`` in the JAX package, a transpose here).
"""
from __future__ import annotations

import ctypes
import weakref
from typing import Optional, Sequence

import torch

from touchgs_torch.native import loader

MAX_JOINTS = 16            # TGS_ARM_MAX_JOINTS, arm_control.h


def _bind(lib: ctypes.CDLL) -> None:
    if getattr(lib, "_tgs_arm_bound", False):
        return
    vp, d = ctypes.c_void_p, ctypes.c_double
    lib.tgs_arm_create.restype = vp
    lib.tgs_arm_create.argtypes = [ctypes.c_int, vp, vp, vp]
    lib.tgs_arm_destroy.restype = None
    lib.tgs_arm_destroy.argtypes = [vp]
    for name, n_args in (("tgs_arm_fk", 2), ("tgs_arm_jacobian", 2),
                         ("tgs_arm_gravity", 2),
                         ("tgs_arm_compliance_tau", 6)):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [vp] * (1 + n_args)
    lib.tgs_sim_create.restype = vp
    lib.tgs_sim_create.argtypes = [vp, vp, vp, d, d, d]
    lib.tgs_sim_destroy.restype = None
    lib.tgs_sim_destroy.argtypes = [vp]
    lib.tgs_sim_state.restype = None
    lib.tgs_sim_state.argtypes = [vp, vp, vp]
    lib.tgs_sim_contact_force.restype = None
    lib.tgs_sim_contact_force.argtypes = [vp, vp]
    lib.tgs_sim_step_compliance.restype = None
    lib.tgs_sim_step_compliance.argtypes = [vp, vp, vp, vp, d]
    lib.tgs_sim_step_guarded.restype = ctypes.c_int
    lib.tgs_sim_step_guarded.argtypes = [vp, vp, d, d, vp, vp, d, d]
    lib._tgs_arm_bound = True


def _f64(a, n: Optional[int] = None) -> torch.Tensor:
    """``a`` as a contiguous float64 CPU tensor, checked to hold ``n``
    values where given (the C side reads exactly that many)."""
    t = torch.as_tensor(a, dtype=torch.float64, device="cpu").contiguous()
    if n is not None and t.numel() != n:
        raise ValueError(f"expected {n} values, got shape {tuple(t.shape)}")
    return t


def _columns(pose) -> torch.Tensor:
    """A 4x4 pose's 16 values column by column (numpy's ``order="F"``)."""
    t = _f64(pose, 16)
    return t.permute(*reversed(range(t.dim()))).contiguous().view(16)


def arm_available() -> bool:
    return loader.native_available()


class CompliantArm:
    """Serial arm (standard DH) with compliance control primitives."""

    def __init__(self, dh: Sequence[Sequence[float]],
                 mass: Optional[Sequence[float]] = None,
                 com: Optional[Sequence[Sequence[float]]] = None):
        lib = loader._ensure_built()
        if lib is None:
            raise RuntimeError(
                f"native arm controller unavailable ({loader._error})")
        _bind(lib)
        self._lib = lib
        self._h = None
        self.n = len(dh)
        dh = _f64(dh, 4 * self.n)
        mass = _f64(torch.zeros(self.n) if mass is None else mass, self.n)
        com = _f64(torch.zeros(self.n, 3) if com is None else com, 3 * self.n)
        self._h = lib.tgs_arm_create(self.n, dh.data_ptr(), mass.data_ptr(),
                                     com.data_ptr())
        if not self._h:
            raise ValueError(f"tgs_arm_create rejected n_joints={self.n} "
                             f"(must be 1..{MAX_JOINTS})")
        # the simulators over this arm, closed before it (`close`)
        self._sims = weakref.WeakSet()

    def _q(self, q) -> torch.Tensor:
        return _f64(q, self.n)

    def fk(self, q) -> torch.Tensor:
        """The 4x4 tool pose in the base frame."""
        q = self._q(q)
        out = torch.empty(16, dtype=torch.float64)
        self._lib.tgs_arm_fk(self._h, q.data_ptr(), out.data_ptr())
        return out.view(4, 4).T.contiguous()

    def jacobian(self, q) -> torch.Tensor:
        """The (6, n) geometric Jacobian, [v; w], base frame."""
        q = self._q(q)
        out = torch.empty(6, self.n, dtype=torch.float64)
        self._lib.tgs_arm_jacobian(self._h, q.data_ptr(), out.data_ptr())
        return out

    def gravity(self, q) -> torch.Tensor:
        """Static gravity torques (g = [0, 0, -9.81])."""
        q = self._q(q)
        out = torch.empty(self.n, dtype=torch.float64)
        self._lib.tgs_arm_gravity(self._h, q.data_ptr(), out.data_ptr())
        return out

    def compliance_tau(self, q, dq, target_pose, stiffness,
                       damping) -> torch.Tensor:
        """tau = J^T (K [dp; drot] - D J dq) + gravity(q), K and D the
        diagonal 6-vectors ``stiffness`` and ``damping``."""
        q, dq = self._q(q), self._q(dq)
        t = _columns(target_pose)
        k, d = _f64(stiffness, 6), _f64(damping, 6)
        out = torch.empty(self.n, dtype=torch.float64)
        self._lib.tgs_arm_compliance_tau(
            self._h, q.data_ptr(), dq.data_ptr(), t.data_ptr(), k.data_ptr(),
            d.data_ptr(), out.data_ptr())
        return out

    def close(self):
        # A C++ Sim keeps a raw Arm*: freeing the arm while a sim is alive
        # would leave the sim dangling, so the sims close first.
        for sim in list(getattr(self, "_sims", ())):
            sim.close()
        if self._h:
            self._lib.tgs_arm_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class ArmSim:
    """Fixed-step simulator around a `CompliantArm` (contact plane
    optional)."""

    def __init__(self, arm: CompliantArm, q0, inertia=None,
                 damping: float = 2.0, plane_z: float = -1e9,
                 k_contact: float = 0.0):
        self.arm = arm
        self._lib = arm._lib
        q0 = arm._q(q0)
        inertia = _f64([0.1] * arm.n if inertia is None
                       else inertia, arm.n)
        self._h = self._lib.tgs_sim_create(arm._h, q0.data_ptr(),
                                           inertia.data_ptr(), damping,
                                           plane_z, k_contact)
        if not self._h:
            raise ValueError("tgs_sim_create failed (arm handle invalid?)")
        arm._sims.add(self)

    def state(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(q, dq)."""
        q = torch.empty(self.arm.n, dtype=torch.float64)
        dq = torch.empty(self.arm.n, dtype=torch.float64)
        self._lib.tgs_sim_state(self._h, q.data_ptr(), dq.data_ptr())
        return q, dq

    def contact_force(self) -> torch.Tensor:
        """The contact force on the tool, base frame."""
        f = torch.empty(3, dtype=torch.float64)
        self._lib.tgs_sim_contact_force(self._h, f.data_ptr())
        return f

    def step_compliance(self, target_pose, stiffness, damping, dt=1e-3):
        t = _columns(target_pose)
        k, d = _f64(stiffness, 6), _f64(damping, 6)
        self._lib.tgs_sim_step_compliance(self._h, t.data_ptr(), k.data_ptr(),
                                          d.data_ptr(), dt)

    def step_guarded(self, direction, speed, f_stop, stiffness, damping,
                     dt=1e-3, tol_n=0.5) -> bool:
        """One step of the guarded move along ``direction`` at ``speed``
        until the force along it reaches ``f_stop``, then held; True once
        it is held within ``tol_n``."""
        dr = _f64(direction, 3)
        k, d = _f64(stiffness, 6), _f64(damping, 6)
        return bool(self._lib.tgs_sim_step_guarded(
            self._h, dr.data_ptr(), speed, f_stop, k.data_ptr(), d.data_ptr(),
            dt, tol_n))

    def close(self):
        if self._h:
            self._lib.tgs_sim_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
