"""The JAX package's public surface, name for name, in ddsp_torch.

The JAX package is read with `ast` (nothing of JAX is imported), the port
is imported. For each subpackage of ddsp_tpu:
  - every name that an `__init__.py` exports (`from X import Y`, `import
    *`, `from ddsp_tpu import ops`) resolves under the same dotted path in
    ddsp_torch;
  - every public top-level function and class of every module has a
    counterpart of the same name in the port's module of the same path,
    which takes each JAX parameter or dataclass field (a flax module's
    fields, its bases' included) under the same name, with an equal default
    wherever JAX's default is a literal (or a module constant holding one);
  - each such class's public methods and properties exist on the port's
    class.
DEPARTURES is the one list of deliberate differences, each with its reason;
`test_departures_are_live` keeps it from going stale.
"""

import ast
import fnmatch
import importlib
import inspect
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / 'ddsp_tpu'

_PALLAS = ('the port\'s kernels live in ddsp_torch/kernels/ (their CUDA '
           'sources in csrc/)')
_COLLECTIVE = ('a JAX collective\'s name inside shard_map; the port takes a '
               'Mesh (parallel/mesh.py) and torch.distributed ranks')

# Keys: 'module:<path>' (a JAX module without a counterpart, fnmatch glob),
# 'arg:<name>' (a parameter or field skipped everywhere; a glob),
# 'arg:<path>:<name>' (skipped in one module), 'member:<name>' (a method
# skipped everywhere), 'name:<path>:<name>' (a public name without a
# counterpart), 'rename:<path>:<name>' (the value is (port name, reason)),
# 'extra:<path>:<name>' (the port's counterpart takes more than the JAX
# one; the test checks the JAX parameters come first).
DEPARTURES = {
    # JAX idioms that torch has no use for.
    'arg:axis_name': _COLLECTIVE,
    'arg:collective_id': 'numbers a Pallas remote copy; K3 keys its slots '
                         'by the mesh (kernels/halo.py)',
    'arg:interpret': 'runs a Pallas kernel in interpret mode off the TPU; '
                     'a port kernel takes its plain version on a CPU '
                     'tensor',
    'arg:use_pallas': 'picks the Pallas kernel; the port picks its kernel '
                      'by the tensor\'s device',
    'arg:unroll': 'lax.scan\'s unroll factor; the port\'s loops are kernels '
                  'or Python',
    'arg:use_matmul': 'routes FFTs as TPU matmuls (ops/fft_matmul.py); '
                      'the port calls torch.fft',
    'arg:sharding': 'a jax.sharding placement; the port places tensors '
                    'with device= and a Mesh',
    'arg:ops/spectral.py:compute_dtype': (
        'the dtype of the TPU\'s DFT-as-matmul route only (ddsp_tpu/ops/'
        'spectral.py stft); the port\'s torch.fft runs in float32'),
    'arg:parallel/time_shard.py:*_local': 'the shard-local sizes of a '
                                          'shard_map body; the port\'s '
                                          'wrappers take a Mesh',
    'arg:parallel/time_shard.py:*_axis_name': _COLLECTIVE,
    'member:setup': 'flax builds submodules in setup (and runs __call__); '
                    'the port builds them in __init__ (and runs forward)',
    'module:ops/fft_matmul.py': 'FFTs as TPU matmuls; off the TPU the JAX '
                                'package takes the jnp.fft branch that the '
                                'port mirrors',
    'module:ops/pallas_kernels/*': _PALLAS,
    'module:parallel/pallas_halo.py': 'K3 is kernels/halo.py (its CUDA '
                                      'source csrc/halo.cu)',
    'name:parallel/mesh.py:audio_sharding': 'a NamedSharding; the port '
                                            'splits tensors with '
                                            'parallel/mesh.py shard_batch',
    'name:parallel/mesh.py:batch_sharding': 'a NamedSharding; see '
                                            'shard_batch',
    'name:parallel/mesh.py:replicated_sharding': 'a NamedSharding; see '
                                                 'replicate',
    'name:parallel/pallas_halo.py:reset_collective_id_counter':
        'numbers Pallas collectives; the port has none',
    'rename:ops/core.py:jnp_float32': ('torch_float32',
                                       'the dtype is torch\'s'),
    'extra:nn/resnet.py:get_norm': 'the port\'s ConditionalNorm and '
                                   'Normalize take their channel counts '
                                   '(flax infers them), so get_norm takes '
                                   'them after JAX\'s three arguments',
}


def _departed(kind, path, name):
  for key in DEPARTURES:
    parts = key.split(':')
    if parts[0] != kind:
      continue
    subject = name if kind in ('arg', 'member') else path
    if len(parts) == 2 and fnmatch.fnmatch(subject, parts[1]):
      return key
    if len(parts) == 3 and fnmatch.fnmatch(path, parts[1]) and (
        fnmatch.fnmatch(name, parts[2])):
      return key
  return None


# --- Reading the JAX package ---------------------------------------------


class JaxModule:
  """One ddsp_tpu module read with ast: imports, constants, defs."""

  def __init__(self, path):
    self.path = path
    self.rel = path.relative_to(JAX_ROOT).as_posix()
    parts = path.relative_to(REPO).with_suffix('').parts
    if parts[-1] == '__init__':
      parts = parts[:-1]
    self.dotted = '.'.join(parts)
    self.tree = ast.parse(path.read_text())
    self.imports = {}     # local name -> (module, attribute or None)
    self.star = []        # modules imported with *
    self.constants = {}
    self.defs = {}
    package = self.dotted if path.name == '__init__.py' else (
        self.dotted.rsplit('.', 1)[0])
    for node in self.tree.body:
      if isinstance(node, ast.ImportFrom):
        module = node.module or ''
        if node.level:
          base = package.split('.')
          base = base[:len(base) - node.level + 1]
          module = '.'.join(base + ([module] if module else []))
        for alias in node.names:
          if alias.name == '*':
            self.star.append(module)
          else:
            self.imports[alias.asname or alias.name] = (module, alias.name)
      elif isinstance(node, ast.Import):
        for alias in node.names:
          self.imports[alias.asname or alias.name.split('.')[0]] = (
              alias.name, None)
      elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
        self.defs[node.name] = node
      elif isinstance(node, (ast.Assign, ast.AnnAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [
            node.target]
        for t in targets:
          if isinstance(t, ast.Name) and node.value is not None:
            try:
              self.constants[t.id] = ast.literal_eval(node.value)
            except ValueError:
              pass

  def public_names(self):
    """What `from <this module> import *` binds: __all__, else the public
    defs and assignments (imported names are not the surface)."""
    names = set(self.defs)
    for node in self.tree.body:
      if isinstance(node, ast.Assign):
        targets = {t.id for t in node.targets if isinstance(t, ast.Name)}
        if '__all__' in targets:
          return set(ast.literal_eval(node.value))
        names |= targets
    return {n for n in names if not n.startswith('_')}


_MODULES = {}


def jax_module(dotted):
  if dotted not in _MODULES:
    rel = JAX_ROOT.joinpath(*dotted.split('.')[1:])
    path = rel.with_suffix('.py') if rel != JAX_ROOT else None
    if path is None or not path.exists():
      path = rel / '__init__.py'
    _MODULES[dotted] = JaxModule(path) if path.exists() else None
  return _MODULES[dotted]


# A default that is no literal (not checked), and a parameter without one.
NO, REQUIRED = object(), object()


def _literal(node, module):
  """A default's value (a literal, or a module constant holding one), else
  NO."""
  try:
    return ast.literal_eval(node)
  except ValueError:
    pass
  if isinstance(node, ast.Name) and node.id in module.constants:
    return module.constants[node.id]
  return NO


def _function_params(fn, module, skip_first=False):
  """[(name, default or NO or REQUIRED)] of a def, self dropped."""
  args = fn.args
  positional = args.posonlyargs + args.args
  defaults = [REQUIRED] * (len(positional) - len(args.defaults)) + [
      _literal(d, module) for d in args.defaults]
  out = list(zip([a.arg for a in positional], defaults))
  if skip_first:
    out = out[1:]
  for a, d in zip(args.kwonlyargs, args.kw_defaults):
    out.append((a.arg, REQUIRED if d is None else _literal(d, module)))
  return out


def _resolve_class(name, module):
  """The JAX ClassDef a base name refers to, with its module, or None."""
  if name in module.defs and isinstance(module.defs[name], ast.ClassDef):
    return module.defs[name], module
  if name in module.imports:
    source, attr = module.imports[name]
    if attr and source.startswith('ddsp_tpu'):
      other = jax_module(source)
      if other is not None:
        return _resolve_class(attr, other)
  return None


def _base_name(node):
  if isinstance(node, ast.Name):
    return node.id
  if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
    return node.value.id + '.' + node.attr
  return None


def _class_chain(cls, module):
  """The class and its bases inside ddsp_tpu, most derived first."""
  chain, todo = [], [(cls, module)]
  while todo:
    c, m = todo.pop(0)
    if any(c is x for x, _ in chain):
      continue
    chain.append((c, m))
    for b in c.bases:
      name = _base_name(b)
      found = None
      if name and '.' not in name:
        found = _resolve_class(name, m)
      elif name:
        head, attr = name.split('.', 1)
        if head in m.imports and m.imports[head][1] is None:
          other = jax_module(m.imports[head][0])
          if other is not None:
            found = _resolve_class(attr, other)
      if found:
        todo.append(found)
  return chain


def _class_params(cls, module):
  """A class's constructor parameters: __init__'s, else its fields."""
  chain = _class_chain(cls, module)
  for c, m in chain:
    for node in c.body:
      if isinstance(node, ast.FunctionDef) and node.name == '__init__':
        return _function_params(node, m, skip_first=True)
  fields = {}
  for c, m in reversed(chain):
    for node in c.body:
      if isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                        ast.Name):
        if node.value is None:
          default = REQUIRED
        elif isinstance(node.value, ast.Call) and ast.unparse(
            node.value.func).endswith('field'):
          kw = {k.arg: k.value for k in node.value.keywords}
          default = _literal(kw['default'], m) if 'default' in kw else NO
        else:
          default = _literal(node.value, m)
        fields[node.target.id] = default
  return list(fields.items())


def _class_members(cls, module):
  """Public methods and properties, the class's and its JAX bases'."""
  members = set()
  for c, _ in _class_chain(cls, module):
    for node in c.body:
      if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
          not node.name.startswith('_')):
        members.add(node.name)
  return members


# --- The checks ------------------------------------------------------------


def _port_module(dotted):
  return importlib.import_module('ddsp_torch' + dotted[len('ddsp_tpu'):])


def _port_params(obj):
  """The port's parameters by name; a class whose __init__ takes **kwargs
  also takes its bases' parameters (the kwargs are passed up)."""
  try:
    params = dict(inspect.signature(obj).parameters)
  except (TypeError, ValueError):
    return None
  kinds = {p.kind for p in params.values()}
  if inspect.isclass(obj) and inspect.Parameter.VAR_KEYWORD in kinds:
    for base in obj.__mro__[1:]:
      if '__init__' in vars(base) and base.__module__.startswith(
          'ddsp_torch'):
        for name, p in inspect.signature(base).parameters.items():
          params.setdefault(name, p)
  return params


def _check_params(where, jax_params, port_obj, rel, problems):
  port = _port_params(port_obj)
  if port is None:
    problems.append(f'{where}: the port\'s counterpart has no signature')
    return
  for name, default in jax_params:
    if _departed('arg', rel, name):
      continue
    if name not in port:
      problems.append(f'{where}: no parameter {name!r}')
      continue
    if default is NO or default is REQUIRED:
      continue
    theirs = port[name].default
    if theirs is inspect.Parameter.empty:
      problems.append(f'{where}({name}): JAX defaults it to {default!r}, '
                      'the port requires it')
    elif not (type(theirs) is type(default) or {type(theirs), type(
        default)} <= {int, float}) or theirs != default:
      problems.append(f'{where}({name}): default {theirs!r} in the port, '
                      f'{default!r} in JAX')


def _exports(module):
  """{name: (JAX module path, name there)} of what a JAX __init__ exports."""
  names = {}
  for local, (source, attr) in module.imports.items():
    if source.startswith('ddsp_tpu') and not local.startswith('_'):
      origin = jax_module(source + '.' + attr) if attr else None
      if origin is not None:           # a submodule
        names[local] = (origin.rel, None)
      else:
        names[local] = (jax_module(source).rel if attr else '', attr)
  for source in module.star:
    other = jax_module(source)
    for name in other.public_names():
      names[name] = (other.rel, name)
  return names


def _bound_names(port_module):
  """The names a port __init__ binds by its own imports."""
  names = set()
  for node in ast.parse(pathlib.Path(port_module.__file__).read_text()).body:
    if isinstance(node, (ast.ImportFrom, ast.Import)):
      names |= {(a.asname or a.name).split('.')[0] for a in node.names}
  return names


def surface_problems(package):
  """Every difference between JAX's `package` and the port's."""
  problems = []
  root = JAX_ROOT / package if package else JAX_ROOT
  paths = sorted(root.rglob('*.py')) if package else sorted(
      root.glob('*.py'))
  for path in paths:
    rel = path.relative_to(JAX_ROOT).as_posix()
    if _departed('module', rel, ''):
      continue
    module = jax_module(JaxModule(path).dotted)
    try:
      port = _port_module(module.dotted)
    except ImportError as e:
      problems.append(f'{rel}: no port module ({e})')
      continue
    if path.name == '__init__.py':
      for name, (origin, attr) in sorted(_exports(module).items()):
        if _departed('module', origin, '') or (
            attr and _departed('name', origin, attr)):
          continue
        renamed = DEPARTURES.get(f'rename:{origin}:{attr}')
        value = getattr(port, renamed[0] if renamed else name, None)
        if value is None:
          problems.append(f'{rel}: {module.dotted}.{name} is not exported')
        elif attr is None and name not in _bound_names(port):
          # A submodule is an attribute once anything imported it; the
          # port's __init__ must import it itself.
          problems.append(f'{rel}: {module.dotted}.{name} is not imported '
                          'by the port\'s __init__')
        elif attr is not None and inspect.ismodule(value):
          problems.append(f'{rel}: {module.dotted}.{name} is a module in the '
                          'port, a function or class in JAX')
      continue
    for name, node in module.defs.items():
      if name.startswith('_') or _departed('name', rel, name):
        continue
      where = f'{rel}:{name}'
      renamed = DEPARTURES.get(f'rename:{rel}:{name}')
      target = getattr(port, renamed[0] if renamed else name, None)
      if target is None:
        problems.append(f'{where}: missing')
        continue
      if isinstance(node, ast.FunctionDef):
        params = _function_params(node, module)
        _check_params(where, params, target, rel, problems)
        if _departed('extra', rel, name):
          port_names = list(_port_params(target))
          ours = [p for p, _ in params]
          if port_names[:len(ours)] != ours:
            problems.append(f'{where}: JAX\'s parameters {ours} do not come '
                            f'first in the port\'s {port_names}')
        continue
      _check_params(where, _class_params(node, module), target, rel,
                    problems)
      for member in sorted(_class_members(node, module)):
        if not _departed('member', rel, member) and not hasattr(target,
                                                                member):
          problems.append(f'{where}.{member}: missing')
  return problems


PACKAGES = sorted(p.name for p in JAX_ROOT.iterdir()
                  if (p / '__init__.py').exists()) + ['']


@pytest.mark.parametrize('package', PACKAGES, ids=lambda p: p or 'root')
def test_surface_matches_jax(package):
  problems = surface_problems(package)
  assert not problems, '\n'.join(problems)


def test_departures_are_live():
  """Each departure names something the JAX package has."""
  stale = []
  for key in DEPARTURES:
    kind, rest = key.split(':', 1)
    if kind == 'module':
      if not any(fnmatch.fnmatch(p.relative_to(JAX_ROOT).as_posix(), rest)
                 for p in JAX_ROOT.rglob('*.py')):
        stale.append(key)
    elif kind == 'member':
      if not any(isinstance(n, ast.FunctionDef) and n.name == rest
                 for p in JAX_ROOT.rglob('*.py')
                 for n in ast.walk(ast.parse(p.read_text()))):
        stale.append(key)
    elif kind in ('name', 'rename', 'extra'):
      rel, name = rest.split(':')
      module = JaxModule(JAX_ROOT / rel)
      if name not in module.defs:
        stale.append(key)
    elif kind == 'arg':
      found = False
      pattern = rest.split(':')
      for path in JAX_ROOT.rglob('*.py'):
        rel = path.relative_to(JAX_ROOT).as_posix()
        if len(pattern) == 2 and not fnmatch.fnmatch(rel, pattern[0]):
          continue
        text = ast.parse(path.read_text())
        for node in ast.walk(text):
          names = []
          if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
          elif isinstance(node, ast.AnnAssign) and isinstance(
              node.target, ast.Name):
            names = [node.target.id]
          if any(fnmatch.fnmatch(n, pattern[-1]) for n in names):
            found = True
            break
        if found:
          break
      if not found:
        stale.append(key)
    else:
      stale.append(key)
  assert not stale, stale
  assert all(DEPARTURES.values()), 'every departure gives its reason'


def test_flat_names_import_without_building_a_kernel():
  """`from ddsp_torch import ops` and the other flat names in a fresh
  process without CUDA: ops.resample is the function (its module stays
  importable), and no kernel library is built or loaded."""
  code = '\n'.join([
      'import importlib, inspect',
      'import ddsp_torch',
      'from ddsp_torch import configs, nn, ops, proc',
      'from ddsp_torch.kernels import _build',
      'from ddsp_torch.ops.resample import resample',
      'assert ddsp_torch.ops is ops and inspect.isfunction(ops.resample)',
      'assert resample is ops.resample',
      'module = importlib.import_module("ddsp_torch.ops.resample")',
      'assert inspect.ismodule(module) and module.resample is resample',
      'assert callable(ops.frame) and callable(ops.compute_f0)',
      'assert nn.OutputSplitsModule and nn.get_norm and configs.tiny',
      'assert proc.is_processor and proc.default_module_name',
      'assert not _build._LIBS, _build._LIBS',
      'print("ok")'])
  env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
  out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
  assert out.returncode == 0 and out.stdout.strip() == 'ok', out.stderr
