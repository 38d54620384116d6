"""The internal agent at the TPU's default matmul precision: the arithmetic
the JAX solvation record (experiments/solvation, trained on a TPU v5e) was
trained with, in the port.

On a TPU an f32 `dot_general` at the default precision rounds both operands
to bf16 (round to nearest even), multiplies them in one pass and
accumulates in f32; every other op stays f32. After AD each transposed
product is such a dot too, and rounds its own operands, the incoming
gradient among them. No file of the JAX package sets a precision, so every
product of the record's agent and loss was one of these. The port computes
in f32 throughout.

    with tpu_default_precision():
        ...   # the port's products round as the TPU's did

While the context is active:
  * a torch function mode catches `F.linear`, `torch.einsum` (two
    operands), `torch.matmul`, `@`, `mm` and `bmm`. Each rounds its f32
    operands to bf16 and computes the product of the rounded values in f32
    (`_RoundedProduct`; a bf16 x bf16 product is exact in f32, so only the
    summation order differs from the TPU's). Its backward rounds the
    incoming gradient and computes the transposed products from the rounded
    operands. `F.linear` adds its bias after the product, in f32, as Flax's
    Dense does. The other products torch has (`addmm`, `tensordot`, `dot`,
    `outer`, the convolutions, ...) raise NotImplementedError there: the
    port's solvation path calls none, and a product left in f32 must not
    pass silently;
  * `agents/internal.py`'s `focus_select_hook` rounds the focused atom's
    latent row and its gradient (`_RoundedSelect`): the JAX package selects
    it by a one-hot einsum (`internal.py:166`), a product that the port's
    exact `torch.gather` is not;
  * TF32 must be off (`torch.backends.cuda.matmul.allow_tf32` False and
    float32 matmul precision 'highest'), or the card's f32 products would
    round again. `torch.autocast` is not this emulation: it keeps outputs
    and elementwise ops in bf16.

Bias adds, activations, the SchNet filters' RBF and cutoff, the softmaxes
(the fused head, `masked_softmax.cu`, the counterpart of the Pallas kernel
`ops/pallas_softmax.py:29`, which holds no product), the env step, the
device LJ reward with its solvation penalty, GAE and the optimizer stay f32,
as on the TPU: the JAX jaxprs of the env step, the reward and GAE hold no
product (tests/test_torch_tpu_precision.py). The CUDA kernels of the
covariant agent (#1-#6 of PERF.md section 6) are not emulated: on the TPU
their products ran inside Pallas kernels at the kernels' own precision, so
the tool raises for `--model=covariant`, and for more than one process
(`--num_devices`, `--multihost`: the mode is this process's).

The products of the JAX internal agent (`molgym_tpu/agents/`), from
`jax.make_jaxpr` of its sampled act, its `evaluate` and `jax.value_and_grad`
of the PPO loss (`rl/ppo.py::make_loss_fn`) on one minibatch; no
`conv_general_dilated`, every `precision` DEFAULT. Dimensions: B the batch,
N the canvas, G = 25 RBF centres, W the network width, F = W / 2 the atom
features (SchNet's n_atom_basis = n_filters), Lb = W / 4 the bag's latent,
L = F + Lb, Z the elements, I the interactions. Operands as the jaxpr gives
them, with the contracting and batch dimensions (lhs;rhs). The encoder runs
3 times a forward (the canvas, then the kappa surrogate's two placements),
phi_beta twice (the bag, the bag less the element) and phi_kappa twice.
`act` and `evaluate` each hold the forward products (18 I + 18: 72 at the
solvation record's 3 interactions); the loss's value and gradient hold them
and the transposed ones (51 I + 51: 204).

Forward, each with its port counterpart (`F.linear` of the module's
`nn.Linear` unless said):

    product         JAX                       port                             lhs x rhs                contract  batch    count
    filter_in       schnet.py:52 Dense_0      schnet.py:86 filter_in           B,N,N,G x G,F            3;0       -        3I
    filter_out      schnet.py:54 Dense_1      schnet.py:86 filter_out          B,N,N,F x F,F            3;0       -        3I
    in2f            schnet.py:57 Dense_2      schnet.py:88 in2f                B,N,F x F,F              2;0       -        3I
    cfconv          schnet.py:59 einsum       schnet.py:90 torch.einsum        B,N,F x B,N,N,F          1;2       0,2;0,3  3I
    f2out           schnet.py:60 Dense_3      schnet.py:91 f2out               B,N,F x F,F              2;0       -        3I
    out             schnet.py:62 Dense_4      schnet.py:91 out                 B,N,F x F,F              2;0       -        3I
    phi_beta.0      internal.py:145,197       internal.py:151,182 phi_beta[0]  B,Z x Z,W                1;0       -        2
    phi_beta.1      internal.py:145,197       internal.py:151,182 phi_beta[1]  B,W x W,Lb               1;0       -        2
    phi_focus.0     internal.py:157           internal.py:156 phi_focus[0]     B,N,L x L,W              2;0       -        1
    phi_focus.1     internal.py:157           internal.py:156 phi_focus[1]     B,N,W x W,1              2;0       -        1
    focus           internal.py:166 einsum    internal.py:161 focus_select_hook  B,N x B,N,L            1;1       0;0      1
    phi_element.0   internal.py:170           internal.py:164 phi_element[0]   B,L x L,W                1;0       -        1
    phi_element.1   internal.py:170           internal.py:164 phi_element[1]   B,W x W,Z                1;0       -        1
    phi_continuous.0  internal.py:182         internal.py:168 phi_continuous[0]  B,L+Z x L+Z,W          1;0       -        1
    phi_continuous.1  internal.py:182         internal.py:168 phi_continuous[1]  B,W x W,3              1;0       -        1
    phi_kappa.0     internal.py:131,132       internal.py:124 phi_kappa[0]     B,L x L,W                1;0       -        2
    phi_kappa.1     internal.py:131,132       internal.py:124 phi_kappa[1]     B,W x W,1                1;0       -        2
    critic.0        internal.py:227           internal.py:198 critic[0]        B,L x L,W                1;0       -        1
    critic.1        internal.py:227           internal.py:198 critic[1]        B,W x W,W                1;0       -        1
    critic.2        internal.py:227           internal.py:198 critic[2]        B,W x W,1                1;0       -        1

After AD (the loss's gradient), each the rounded backward of its forward's
counterpart (`_RoundedProduct.backward`; the focus row's
`_RoundedSelect.backward`): a Dense's kernel gradient, the incoming
gradient against the layer's input summed over every leading dimension,
for every Dense above (`d<product>.kernel`, lhs the gradient, rhs the
input, the forward's count); its input gradient, the incoming gradient
against the kernel (`d<product>.input`, contracting the gradient's last
dimension, the output features, with the kernel's second; the forward's
count), for every Dense but filter_in and
phi_beta.0, whose inputs (the RBF, the bag) hold no parameter; and

    product         JAX                       port                             lhs x rhs                contract  batch    count
    dcfconv.filter  schnet.py:59 einsum       schnet.py:90 torch.einsum        B,F,N x B,N,F            -         0,1;0,2  3I
    dcfconv.input   schnet.py:59 einsum       schnet.py:90 torch.einsum        B,F,N x B,N,N,F          2;1       0,1;0,3  3I
    dfocus          internal.py:166 einsum    internal.py:161 focus_select_hook  B,L x B,N              -         0;0      1

Two of these have no contracting dimension (dcfconv.filter, dfocus): the
emulation rounds them as every DEFAULT dot of the jaxpr, whether or not the
TPU's compiler rewrote them as f32 multiplies (not visible without a TPU).

    python3 -m molgym_tpu_torch.tools.tpu_precision <record> --seed=N \\
        [flags] [--dry_run]

trains the record's command (tools/recorded_run.py's, flags after it win)
in this process under the context, on the card unless `--device=cpu`; the
run's name gets TAG_SUFFIX, so its records and models (`solv_tpudefault_
run-19_*`) cannot be taken for an f32 run's.

    python3 -m molgym_tpu_torch.tools.tpu_precision --diagnose <model path> \\
        [tools/diagnose_greedy.py's flags]

runs tools/diagnose_greedy.py under the context (a JAX archive's sampled
policy read at the precision it was trained at).
"""
from __future__ import annotations

import collections
import contextlib
import importlib
import re
import sys
from typing import Counter, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.nn import functional as F
from torch.overrides import TorchFunctionMode

TAG_SUFFIX = '_tpudefault'


class Product(NamedTuple):
    """One row of the module docstring's tables."""
    name: str
    jax: str
    port: str
    lhs: str
    rhs: str
    contract: str
    batch: str
    count: str


def _rows(table: str) -> Tuple[Product, ...]:
    """The Products of one of the docstring's tables (the rows after its
    header)."""
    out = []
    for line in table.strip().splitlines()[1:]:
        name, rest = line.split(None, 1)
        jax, port, shapes, contract, batch, count = re.split(
            r'\s{2,}', rest.strip())
        lhs, rhs = shapes.split(' x ')
        out.append(Product(name, jax, port, lhs, rhs, contract, batch, count))
    return tuple(out)


_TABLES = re.findall(r'\n( {4}product .*?)\n\n', __doc__, re.S)
# the forward products, the transposed cfconv and focus products
FORWARD, TRANSPOSED_EINSUMS = (_rows(t) for t in _TABLES)
# the Dense layers whose input holds no parameter: no input gradient
NO_INPUT_GRADIENT = ('filter_in', 'phi_beta.0')


def transposed() -> Tuple[Product, ...]:
    """The products after AD: every Dense's kernel and input gradients (the
    docstring's rule) and TRANSPOSED_EINSUMS."""
    out = []
    for p in FORWARD:
        if p.jax.endswith('einsum'):
            continue
        lead = p.lhs.split(',')[:-1]
        out_dims = p.rhs.split(',')[-1]
        grad = ','.join(lead + [out_dims])
        everything = ','.join(str(i) for i in range(len(lead)))
        out.append(p._replace(name=f'd{p.name}.kernel', lhs=grad, rhs=p.lhs,
                              contract=f'{everything};{everything}'))
        if p.name not in NO_INPUT_GRADIENT:
            out.append(p._replace(name=f'd{p.name}.input', lhs=grad,
                                  rhs=p.rhs, contract=f'{len(lead)};1'))
    return tuple(out) + TRANSPOSED_EINSUMS


def dims_of(width: int, canvas: int, num_zs: int, batch: int,
            interactions: int) -> Dict[str, int]:
    """The docstring's dimensions of the internal agent."""
    f, lb = width // 2, width // 4
    return dict(B=batch, N=canvas, G=25, W=width, F=f, Lb=lb, L=f + lb,
                Z=num_zs, I=interactions)


def _shape(expr: str, dims: Dict[str, int]) -> Tuple[int, ...]:
    return tuple(sum(dims[t] if t in dims else int(t) for t in d.split('+'))
                 for d in expr.split(','))


def _axes(expr: str) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    if expr == '-':
        return (), ()
    lhs, rhs = expr.split(';')
    return tuple(map(int, lhs.split(','))), tuple(map(int, rhs.split(',')))


def _count(expr: str, dims: Dict[str, int]) -> int:
    """'3I' -> 3 times the interactions, '2' -> 2."""
    factor, per_interaction = re.fullmatch(r'(\d*)(I?)', expr).groups()
    return int(factor or 1) * (dims['I'] if per_interaction else 1)


def expected(products: Sequence[Product], dims: Dict[str, int]) -> Counter:
    """(lhs shape, rhs shape, contracting, batch) -> count, at `dims`."""
    out: Counter = collections.Counter()
    for p in products:
        out[(_shape(p.lhs, dims), _shape(p.rhs, dims), _axes(p.contract),
             _axes(p.batch))] += _count(p.count, dims)
    return out


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """An f32 tensor rounded to bf16 (to nearest even) and back; any other
    dtype as it is."""
    if x.dtype != torch.float32:
        return x
    return x.to(torch.bfloat16).to(torch.float32)


# rounded products by op while a context was active (chip_smoke.py phase
# 19 reads them: the run went through the emulation)
product_counts: Counter = collections.Counter()


class _RoundedProduct(torch.autograd.Function):
    """`product(*operands)` of the operands rounded to bf16, in f32; the
    backward rounds the incoming gradient and takes the product's own
    backward at the rounded operands."""

    @staticmethod
    def forward(ctx, product, *operands):
        rounded = tuple(round_bf16(t) for t in operands)
        ctx.product = product
        ctx.save_for_backward(*rounded)
        with torch._C.DisableTorchFunction():
            return product(*rounded)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[1:]
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad(), torch._C.DisableTorchFunction():
            out = ctx.product(*leaves)
            grads = iter(torch.autograd.grad(
                out, [t for t in leaves if t.requires_grad],
                round_bf16(grad)))
        return (None, ) + tuple(next(grads) if need else None
                                for need in needs)


class _RoundedSelect(torch.autograd.Function):
    """The focused row rounded to bf16, and its gradient: the one-hot
    einsum's product and its transpose (the row times one, exact in f32)."""

    @staticmethod
    def forward(ctx, row):
        return round_bf16(row)

    @staticmethod
    def backward(ctx, grad):
        return round_bf16(grad)


def _select(row: torch.Tensor) -> torch.Tensor:
    product_counts['focus'] += 1
    return _RoundedSelect.apply(row)


def _product(name, fn, *operands):
    product_counts[name] += 1
    return _RoundedProduct.apply(fn, *operands)


def _linear(input, weight, bias=None):
    out = _product('linear', F.linear, input, weight)
    return out if bias is None else out + bias


def _einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    if len(operands) != 2:
        raise NotImplementedError(
            f'torch.einsum of {len(operands)} operands under '
            'tpu_default_precision: the emulation rounds two-operand '
            'products only')
    return _product('einsum', lambda a, b: torch.einsum(equation, a, b),
                    *operands)


def _binary(name, fn):
    def handler(a, b, **kwargs):
        if kwargs:
            raise NotImplementedError(f'{name} with {sorted(kwargs)} under '
                                      'tpu_default_precision')
        return _product(name, fn, a, b)
    return handler


_HANDLERS = {
    F.linear: _linear,
    torch.einsum: _einsum,
    torch.matmul: _binary('matmul', torch.matmul),
    torch.Tensor.matmul: _binary('matmul', torch.matmul),
    torch.Tensor.__matmul__: _binary('matmul', torch.matmul),
    torch.mm: _binary('mm', torch.mm),
    torch.Tensor.mm: _binary('mm', torch.mm),
    torch.bmm: _binary('bmm', torch.bmm),
    torch.Tensor.bmm: _binary('bmm', torch.bmm),
}
# products torch offers that the emulation does not round
_REFUSED = frozenset({
    torch.addmm, torch.Tensor.addmm, torch.baddbmm, torch.Tensor.baddbmm,
    torch.addbmm, torch.addmv, torch.addr, torch.mv, torch.Tensor.mv,
    torch.dot, torch.Tensor.dot, torch.vdot, torch.inner, torch.outer,
    torch.ger, torch.tensordot, torch.chain_matmul, torch.linalg.multi_dot,
    torch.linalg.matmul, torch.linalg.vecdot, torch.Tensor.__rmatmul__,
    F.bilinear, F.conv1d, F.conv2d, F.conv3d, F.conv_transpose1d,
    F.conv_transpose2d, F.conv_transpose3d,
    F.scaled_dot_product_attention})


class _PrecisionMode(TorchFunctionMode):

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        handler = _HANDLERS.get(func)
        if handler is not None:
            return handler(*args, **kwargs)
        if func in _REFUSED:
            raise NotImplementedError(
                f'{getattr(func, "__name__", func)} under '
                'tpu_default_precision: a product the emulation does not '
                'round')
        return func(*args, **kwargs)


def _tf32() -> bool:
    return (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != 'highest')


@contextlib.contextmanager
def tpu_default_precision():
    """The port's products at the TPU's default matmul precision for the
    length of the block (see the module docstring). Raises if TF32 is on
    when the block starts or ends."""
    from molgym_tpu_torch.agents import internal
    if _tf32():
        raise RuntimeError('tpu_default_precision needs TF32 off: f32 '
                           'products would round again')
    if internal.focus_select_hook is not None:
        raise RuntimeError('tpu_default_precision is active already')
    internal.focus_select_hook = _select
    try:
        with _PrecisionMode():
            yield
    finally:
        internal.focus_select_hook = None
    if _tf32():
        raise RuntimeError('TF32 was turned on under tpu_default_precision')


def emulated_argv(record: str, flags: Sequence[str] = ()
                  ) -> Tuple[str, List[str]]:
    """(driver module, its flags) of `record`'s command (recorded_run) with
    `flags` after it and the name marked with TAG_SUFFIX. Raises for a
    covariant model or more than one process."""
    from molgym_tpu_torch.tools import recorded_run
    module, argv = recorded_run.recorded_argv(record)
    argv = argv + list(flags)
    config = vars(recorded_run.parser_of(module).parse_args(argv))
    check_config(config)
    if not config['name'].endswith(TAG_SUFFIX):
        argv.append(f'--name={config["name"]}{TAG_SUFFIX}')
    return module, argv


def check_config(config: dict) -> None:
    """Raises where the emulation would be partial (see the module
    docstring)."""
    if config.get('model') == 'covariant':
        raise NotImplementedError(
            'tpu_default_precision: the covariant agent\'s products run in '
            'the CUDA kernels, whose TPU counterparts (Pallas) are not '
            'emulated')
    if (config.get('num_devices') or 0) > 1 or config.get('multihost'):
        raise NotImplementedError('tpu_default_precision holds in this '
                                  'process only: one process, please')


def run(module: str, argv: Sequence[str]):
    """`module`'s main(argv) under tpu_default_precision."""
    main_of = importlib.import_module(module).main
    with tpu_default_precision():
        return main_of(list(argv))


def main(argv: Optional[Sequence[str]] = None):
    """Runs (or with --dry_run prints) the emulated command; returns the
    driver's result, or the command."""
    argv = list(sys.argv[1:] if argv is None else argv)
    dry_run = '--dry_run' in argv
    argv = [a for a in argv if a != '--dry_run']
    if argv[:1] == ['--diagnose']:
        from molgym_tpu_torch.tools import diagnose_greedy
        if len(argv) < 2:
            raise SystemExit(__doc__)
        check_config(diagnose_greedy.run_config(argv[1]))
        module, flags = 'molgym_tpu_torch.tools.diagnose_greedy', argv[1:]
    else:
        if not argv or argv[0].startswith('-'):
            raise SystemExit(__doc__)
        module, flags = emulated_argv(argv[0], argv[1:])
    command = ' '.join(['python3', '-m', module] + flags)
    print(f'under tpu_default_precision: {command}', file=sys.stderr)
    if dry_run:
        return command
    return run(module, flags)


if __name__ == '__main__':
    main()
