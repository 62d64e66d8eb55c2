"""Status and error codes.

API-parity constants with the reference solver's public status header
(reference: include/ipx_status.h:1-56). Numeric values are part of the public
contract (bindings and logs compare them), so they match exactly.

The port's copy of ipx_tpu/status.py.
"""
from __future__ import annotations

import enum


class Status(enum.IntEnum):
    """Overall solver status (reference: include/ipx_status.h:4-10)."""
    NOT_RUN = 0
    SOLVED = 1000
    STOPPED = 1005
    NO_MODEL = 1006
    OUT_OF_MEMORY = 1003
    INTERNAL_ERROR = 1004


class SolveStatus(enum.IntEnum):
    """Per-phase status for IPM and crossover
    (reference: include/ipx_status.h:12-21)."""
    NOT_RUN = 0
    OPTIMAL = 1
    IMPRECISE = 2
    PRIMAL_INFEAS = 3
    DUAL_INFEAS = 4
    TIME_LIMIT = 5
    ITER_LIMIT = 6
    NO_PROGRESS = 7
    FAILED = 8
    DEBUG = 9


class Errflag(enum.IntEnum):
    """Error flags (reference: include/ipx_status.h:23-47)."""
    OK = 0
    # invalid input
    ARGUMENT_NULL = 102
    INVALID_DIMENSION = 103
    INVALID_MATRIX = 104
    INVALID_VECTOR = 105
    INVALID_BASIS = 107
    INVALID_CHECKPOINT = 108   # no reference counterpart (checkpointing is
                               # a capability this build adds, SURVEY §5.4)
    # CR method
    CR_ITER_LIMIT = 201
    CR_MATRIX_NOT_POSDEF = 202
    CR_PRECOND_NOT_POSDEF = 203
    CR_NO_PROGRESS = 204
    CR_INF_OR_NAN = 205
    # basis factorization
    BASIS_SINGULAR = 301
    BASIS_ALMOST_SINGULAR = 302
    BASIS_UPDATE_SINGULAR = 303
    BASIS_REPAIR_OVERFLOW = 304
    BASIS_REPAIR_SEARCH = 305
    BASIS_TOO_ILL_CONDITIONED = 306
    # misc
    LAPACK_CHOL = 401
    NOT_IMPLEMENTED = 901
    INTERRUPT_TIME = 999


class InterruptError(Exception):
    """Raised when the time limit expires; carries an Errflag."""

    def __init__(self, errflag: Errflag):
        super().__init__(f"interrupted: {errflag!r}")
        self.errflag = errflag


# Basic-solution status values for vbasis/cbasis arrays
# (reference: include/ipx_status.h:49-53).
IPX_BASIC = 0
IPX_NONBASIC = -1
IPX_NONBASIC_LB = -1
IPX_NONBASIC_UB = -2
IPX_SUPERBASIC = -3

# Convenience aliases mirroring the C macro names so bindings/tests can use
# familiar spellings.
IPX_STATUS_not_run = int(Status.NOT_RUN)
IPX_STATUS_solved = int(Status.SOLVED)
IPX_STATUS_stopped = int(Status.STOPPED)
IPX_STATUS_no_model = int(Status.NO_MODEL)
IPX_STATUS_out_of_memory = int(Status.OUT_OF_MEMORY)
IPX_STATUS_internal_error = int(Status.INTERNAL_ERROR)

IPX_STATUS_optimal = int(SolveStatus.OPTIMAL)
IPX_STATUS_imprecise = int(SolveStatus.IMPRECISE)
IPX_STATUS_primal_infeas = int(SolveStatus.PRIMAL_INFEAS)
IPX_STATUS_dual_infeas = int(SolveStatus.DUAL_INFEAS)
IPX_STATUS_time_limit = int(SolveStatus.TIME_LIMIT)
IPX_STATUS_iter_limit = int(SolveStatus.ITER_LIMIT)
IPX_STATUS_no_progress = int(SolveStatus.NO_PROGRESS)
IPX_STATUS_failed = int(SolveStatus.FAILED)
IPX_STATUS_debug = int(SolveStatus.DEBUG)

IPX_ERROR_argument_null = int(Errflag.ARGUMENT_NULL)
IPX_ERROR_invalid_dimension = int(Errflag.INVALID_DIMENSION)
IPX_ERROR_invalid_matrix = int(Errflag.INVALID_MATRIX)
IPX_ERROR_invalid_vector = int(Errflag.INVALID_VECTOR)
IPX_ERROR_invalid_basis = int(Errflag.INVALID_BASIS)
IPX_ERROR_invalid_checkpoint = int(Errflag.INVALID_CHECKPOINT)
IPX_ERROR_cr_iter_limit = int(Errflag.CR_ITER_LIMIT)
IPX_ERROR_cr_matrix_not_posdef = int(Errflag.CR_MATRIX_NOT_POSDEF)
IPX_ERROR_cr_precond_not_posdef = int(Errflag.CR_PRECOND_NOT_POSDEF)
IPX_ERROR_cr_no_progress = int(Errflag.CR_NO_PROGRESS)
IPX_ERROR_cr_inf_or_nan = int(Errflag.CR_INF_OR_NAN)
IPX_ERROR_basis_singular = int(Errflag.BASIS_SINGULAR)
IPX_ERROR_basis_almost_singular = int(Errflag.BASIS_ALMOST_SINGULAR)
IPX_ERROR_basis_update_singular = int(Errflag.BASIS_UPDATE_SINGULAR)
IPX_ERROR_basis_repair_overflow = int(Errflag.BASIS_REPAIR_OVERFLOW)
IPX_ERROR_basis_repair_search = int(Errflag.BASIS_REPAIR_SEARCH)
IPX_ERROR_basis_too_ill_conditioned = int(Errflag.BASIS_TOO_ILL_CONDITIONED)
IPX_ERROR_lapack_chol = int(Errflag.LAPACK_CHOL)
IPX_ERROR_not_implemented = int(Errflag.NOT_IMPLEMENTED)
IPX_ERROR_interrupt_time = int(Errflag.INTERRUPT_TIME)
