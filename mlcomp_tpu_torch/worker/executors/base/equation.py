"""Equation mini-language — port of
``mlcomp_tpu/worker/executors/base/equation.py``.

A restricted expression evaluator over strings in executor configs: the
ensembling and serving layer. ``y: (load('a') + load('b')) / 2``
averages two models' saved predictions; ``y: infer(file='m')`` runs a
model export on the card through the port's ``make_predictor``.
Evaluation is chunked: ``solve(name, parts)`` yields one result per
``[start, end)`` part, so a large prediction set never materialises at
once.

Grammar (the JAX package's, with its messages): numbers, strings, names
(executor attributes; string values evaluate recursively; an unknown
name is its own string), lists/tuples, + - * / ** and unary -, and calls
to the whitelisted methods load/infer/mean. The tree is walked with
``ast``; nothing else evaluates, so a config cannot run arbitrary code.

The port adds a ``device`` key (default ``'cuda'``), handed to
``make_predictor``: ``work`` raises without CUDA unless the config asks
for ``device: cpu``. The model is ``model_name``, else the registry
name of ``model_id`` (read through the DB session, when there is one),
else ``name``.
"""

import ast
import operator
import os

import numpy as np

from mlcomp_tpu_torch.utils.device import resolve_device
from mlcomp_tpu_torch.worker.executors.base.executor import Executor

_BIN_OPS = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.Pow: operator.pow,
}

_UNARY_OPS = {
    ast.USub: operator.neg,
    ast.UAdd: operator.pos,
}

#: methods an equation string may call
_CALL_WHITELIST = ('load', 'infer', 'mean')

PRED_FOLDER = os.path.join('data', 'pred')


@Executor.register
class Equation(Executor):
    def __init__(self, model_id: int = None, name: str = None,
                 suffix: str = '', max_count: int = None,
                 part_size: int = None, cache_names=(), device='cuda',
                 **kwargs):
        # extra config keys become attributes, so equations can reference
        # them by name
        self.__dict__.update(kwargs)
        self.model_id = model_id
        self.model_name = kwargs.get('model_name')
        self.suffix = suffix
        self.max_count = max_count
        self.part_size = part_size
        self.cache_names = tuple(cache_names)
        self.device = device
        self.cache = {}
        self._predictors = {}
        self.part = (0, None)
        self.name = name or self.model_name

    def _resolve_model_name(self):
        """``model_id`` -> the registry name, read once through the
        session (``model_name`` when it is set)."""
        if not self.model_name and self.model_id and self.session:
            from mlcomp_tpu_torch.db.providers import ModelProvider
            row = ModelProvider(self.session).by_id(self.model_id)
            if row is not None:
                self.model_name = row.name
                if not self.name:
                    self.name = row.name
        return self.model_name

    def _check_device(self):
        """Raise unless ``device`` is the CPU or CUDA is available."""
        resolve_device(self.device)

    # ------------------------------------------------------------- parts
    def generate_parts(self, count: int):
        if self.max_count is not None:
            count = min(count, int(self.max_count))
        size = self.part_size or count
        return [(i, min(count, i + size))
                for i in range(0, max(count, 1), max(size, 1))]

    def adjust_part(self, part):
        """Hook: concrete executors re-slice their datasets here."""

    def solve(self, name: str, parts):
        """Evaluate the equation held in attribute ``name`` once per
        part, yielding each part's result."""
        equation = getattr(self, name)
        for part in parts:
            self.cache = {}
            self.part = part
            self.adjust_part(part)
            res = self._solve(equation)
            if name in self.cache_names:
                self.cache[name] = res
            yield res

    # --------------------------------------------------------- functions
    def load(self, file: str = None) -> np.ndarray:
        """Predictions saved by an Infer executor, sliced to the current
        part. ``load('a')`` -> data/pred/a.npy (or .npz key 'y')."""
        base = file or self._resolve_model_name() or self.name
        if self.suffix:
            base = f'{base}_{self.suffix}'
        for candidate in (base, base + '.npy', base + '.npz'):
            path = os.path.join(PRED_FOLDER, candidate)
            if os.path.exists(path):
                data = np.load(path)
                if hasattr(data, 'files'):  # npz
                    data = data['y']
                lo, hi = self.part
                return data[lo:hi] if hi is not None else data[lo:]
        raise FileNotFoundError(
            f'no predictions for {base!r} under {PRED_FOLDER}')

    def infer(self, file: str = None, batch_size: int = 512,
              activation: str = 'softmax', tta=(),
              quantize: str = None) -> np.ndarray:
        """Run a model export over this part's input batch on
        ``device``. The input is ``self.x`` (set by the concrete
        executor's ``create_base``), sliced to the current part. The
        predictor is built once per (export, batch size, activation,
        quantize) and kept, so the parts and TTA views reuse one loaded
        model. ``quantize='int8'`` serves through the weight-only int8
        kernel (``train/export.py``)."""
        from mlcomp_tpu_torch.train.export import make_predictor
        name = file or self._resolve_model_name() or self.name
        path = os.path.join('models', str(name))
        key = (path, batch_size, activation, quantize)
        predict = self._predictors.get(key)
        if predict is None:
            predict = make_predictor(file=path, batch_size=batch_size,
                                     activation=activation,
                                     quantize=quantize, device=self.device)
            self._predictors[key] = predict
        x = self._part_input()
        if tta:
            from mlcomp_tpu_torch.contrib.transform import (
                parse_tta, tta_predict,
            )
            return tta_predict(predict, x, parse_tta(list(tta)))
        return predict(x)

    def mean(self, *arrays) -> np.ndarray:
        stack = [np.asarray(a) for a in
                 (arrays[0] if len(arrays) == 1 and
                  isinstance(arrays[0], (list, tuple)) else arrays)]
        return np.mean(stack, axis=0)

    def _part_input(self) -> np.ndarray:
        x = getattr(self, 'x', None)
        if x is None:
            raise ValueError(
                'infer() needs self.x — create_base must load the input')
        lo, hi = self.part
        return x[lo:hi] if hi is not None else x[lo:]

    # --------------------------------------------------------- evaluator
    def _solve(self, equation):
        if equation is None:
            return None
        equation = str(equation)
        if equation in self.cache:
            return self.cache[equation]
        tree = ast.parse(equation, mode='eval')
        res = self._eval(tree.body)
        if equation in self.cache_names:
            self.cache[equation] = res
        return res

    def _eval(self, node):
        if isinstance(node, ast.BinOp):
            op = _BIN_OPS.get(type(node.op))
            if op is None:
                raise ValueError(
                    f'operator {type(node.op).__name__} not allowed')
            return op(self._eval(node.left), self._eval(node.right))
        if isinstance(node, ast.UnaryOp):
            op = _UNARY_OPS.get(type(node.op))
            if op is None:
                raise ValueError(
                    f'operator {type(node.op).__name__} not allowed')
            return op(self._eval(node.operand))
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, (ast.List, ast.Tuple)):
            return [self._eval(e) for e in node.elts]
        if isinstance(node, ast.Name):
            if node.id in self.cache:
                return self.cache[node.id]
            attr = getattr(self, node.id, None)
            if attr is not None:
                if isinstance(attr, str):
                    res = self._solve(attr)
                    if node.id in self.cache_names:
                        self.cache[node.id] = res
                    return res
                return attr
            return node.id  # bare name = string literal (reference quirk)
        if isinstance(node, ast.Call):
            if not isinstance(node.func, ast.Name) \
                    or node.func.id not in _CALL_WHITELIST:
                name = getattr(node.func, 'id', '?')
                raise ValueError(f'function {name!r} not allowed; '
                                 f'whitelist: {_CALL_WHITELIST}')
            fn = getattr(self, node.func.id)
            args = [self._eval(a) for a in node.args]
            kwargs = {k.arg: self._eval(k.value) for k in node.keywords}
            return fn(*args, **kwargs)
        raise ValueError(
            f'syntax {type(node).__name__} not allowed in equations')

    def work(self):
        """Standalone use: evaluate ``self.y`` over all parts and return
        the concatenated result's shape (concrete subclasses override)."""
        self._check_device()
        self.create_base()
        parts = self.generate_parts(self.count())
        chunks = [np.asarray(c) for c in self.solve('y', parts)]
        out = np.concatenate(chunks) if chunks else np.empty(0)
        return {'shape': list(out.shape)}

    # hooks for subclasses
    def create_base(self):
        pass

    def count(self) -> int:
        x = getattr(self, 'x', None)
        return len(x) if x is not None else 0


__all__ = ['Equation', 'PRED_FOLDER']
