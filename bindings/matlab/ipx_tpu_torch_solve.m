function [x, info, basis] = ipx_tpu_torch_solve(model, params)
%IPX_TPU_TORCH_SOLVE Solve an LP with ipx_tpu_torch, the PyTorch/CUDA solver.
%
% The counterpart of ipx_tpu_solve.m (and of the reference MEX interface,
% Matlab/ipx_solve.m) over the port's C-API layer, ipx_tpu_torch.capi,
% through MATLAB's Python bridge (py.*): the same calls, parameters and
% solution fields.
%
% model: struct with fields
%   obj (n x 1), lb (n x 1), ub (n x 1), A (m x n sparse),
%   rhs (m x 1), constr_type (1 x m char: '=', '<', '>')
% params: optional struct; field names mirror the reference parameters
%   (e.g. params.crossover = 0, params.ipm_maxiter = 500). params.device
%   defaults to 'cuda', the NVIDIA card: on a machine without one a solve
%   on 'cuda' ends at status 1004 before any work and nothing falls back
%   to the host, so set params.device = 'cpu' (the host path) or
%   'torch_cpu' (the device path on the CPU) there. Two extra fields drive
%   checkpoint/resume: params.resume_from (path of an .npz checkpoint to
%   continue from) and params.checkpoint_to (path to write the final
%   pre-postsolve state to).
%
% Returns:
%   x      primal solution of the basic (vertex) solution if crossover ran,
%          otherwise of the interior solution
%   info   py object with the ~60 reference-parity statistics fields
%   basis  struct with vbasis/cbasis (empty if crossover did not run)

capi = py.importlib.import_module('ipx_tpu_torch.capi');
h = capi.ipx_new();
cleanup = onCleanup(@() capi.ipx_free(h));

resume_from = '';
checkpoint_to = '';
if nargin > 1 && ~isempty(params)
    if isfield(params, 'resume_from')
        resume_from = params.resume_from;
        params = rmfield(params, 'resume_from');
    end
    if isfield(params, 'checkpoint_to')
        checkpoint_to = params.checkpoint_to;
        params = rmfield(params, 'checkpoint_to');
    end
    p = capi.ipx_get_parameters(h);
    fn = fieldnames(params);
    for k = 1:numel(fn)
        setattr(p, fn{k}, params.(fn{k}));
    end
    capi.ipx_set_parameters(h, p);
end

[mrows, ncols] = size(model.A);
[Ai, Aj, Ax] = find(model.A);
% build 0-based CSC arrays
[Aj, order] = sort(Aj);
Ai = Ai(order) - 1;
Ax = Ax(order);
Ap = zeros(ncols + 1, 1);
for j = 1:ncols
    Ap(j + 1) = Ap(j) + nnz(Aj == j);
end

errflag = capi.ipx_load_model(h, int64(ncols), model.obj, model.lb, ...
    model.ub, int64(mrows), int64(Ap), int64(Ai), Ax, model.rhs, ...
    model.constr_type);
assert(double(errflag) == 0, 'ipx_load_model failed: %d', double(errflag));

if ~isempty(resume_from)
    errflag = capi.ipx_load_checkpoint(h, resume_from);
    assert(double(errflag) == 0, 'ipx_load_checkpoint failed: %d', ...
        double(errflag));
end
capi.ipx_solve(h);
if ~isempty(checkpoint_to)
    capi.ipx_save_checkpoint(h, checkpoint_to);
end
info = capi.ipx_get_info(h);

basic = capi.ipx_get_basic_solution(h);
if ~isequal(basic, py.None)
    x = double(basic.x);
    basis = struct('vbasis', double(basic.vbasis), ...
                   'cbasis', double(basic.cbasis));
else
    interior = capi.ipx_get_interior_solution(h);
    x = double(interior.x);
    basis = struct();
end
end

function setattr(obj, name, value)
py.setattr(obj, name, value);
end
