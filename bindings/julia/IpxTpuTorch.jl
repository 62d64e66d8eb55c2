# IpxTpuTorch.jl — Julia binding for ipx_tpu_torch, the PyTorch/CUDA solver.
#
# The counterpart of IpxTpu.jl (and of the reference Julia binding,
# Julia/ipx.jl) over the port's C-API layer, ipx_tpu_torch.capi, through
# PyCall: the same calls, parameters and solution fields.
#
# The solver's `device` parameter defaults to "cuda", the NVIDIA card. On a
# machine without one, a solve on "cuda" ends at status 1004
# (IPX_STATUS_internal_error) before any work and nothing falls back to the
# host, so pass `device="cpu"` (the host path) or `device="torch_cpu"` (the
# device path on the CPU) there.
#
# Usage:
#   using PyCall
#   include("IpxTpuTorch.jl"); using .IpxTpuTorch
#   model = IpxTpuTorch.Model(obj, lb, ub, A, rhs, constr_type)
#   status, info, interior, basic = IpxTpuTorch.solve(model)    # the card
#   status, info, interior, basic = IpxTpuTorch.solve(model; device="cpu")

module IpxTpuTorch

using PyCall
using SparseArrays

const capi = PyNULL()

function __init__()
    copy!(capi, pyimport("ipx_tpu_torch.capi"))
end

struct Model
    obj::Vector{Float64}
    lb::Vector{Float64}
    ub::Vector{Float64}
    A::SparseMatrixCSC{Float64,Int}
    rhs::Vector{Float64}
    constr_type::String
end

"""
    solve(model; kwargs...)

Solves the LP. Keyword arguments set solver parameters by name (same names
and defaults as the reference, e.g. `crossover=0`, `ipm_maxiter=500`), and
`device` ("cuda" by default; `device="cpu"` without a card). Returns
`(status, info, interior, basic)` where `interior`/`basic` are `PyObject`s
exposing x, xl, xu, slack, y, zl, zu / x, slack, y, z, vbasis, cbasis as
arrays.
"""
function solve(model::Model; resume_from::AbstractString="",
               checkpoint_to::AbstractString="", kwargs...)
    h = capi.ipx_new()
    try
        p = capi.ipx_get_parameters(h)
        for (k, v) in kwargs
            setproperty!(p, Symbol(k), v)
        end
        capi.ipx_set_parameters(h, p)

        n = length(model.obj)
        m = length(model.rhs)
        # 0-based CSC
        Ap = model.A.colptr .- 1
        Ai = model.A.rowval .- 1
        Ax = model.A.nzval
        errflag = capi.ipx_load_model(h, n, model.obj, model.lb, model.ub,
                                      m, Ap, Ai, Ax, model.rhs,
                                      model.constr_type)
        errflag == 0 || error("ipx_load_model failed: $errflag")
        if !isempty(resume_from)
            errflag = capi.ipx_load_checkpoint(h, resume_from)
            errflag == 0 || error("ipx_load_checkpoint failed: $errflag")
        end
        status = capi.ipx_solve(h)
        if !isempty(checkpoint_to)
            capi.ipx_save_checkpoint(h, checkpoint_to)
        end
        info = capi.ipx_get_info(h)
        interior = capi.ipx_get_interior_solution(h)
        basic = capi.ipx_get_basic_solution(h)
        return status, info, interior, basic
    finally
        capi.ipx_free(h)
    end
end

end # module
