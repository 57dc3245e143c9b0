"""Point masks: expression masks over gridded static fields.

Re-derivation of example2's querydata expression masks
(examples/example2/src/roadrunner.cpp:272-323 ``read_querydata_mask`` +
QueryDataSymbols.cpp): the config gives a grid file and a boolean formula;
the formula is evaluated per simulation point with each variable name bound
to the grid field bilinearly interpolated at the point's latlon
(QueryDataSymbols.cpp:26-45).  Supported symbols match the reference's stx
evaluator surface: arithmetic (+ - * / %), comparisons, and/or/not, the
constant ``PI``, and the function ``missing(x)``
(QueryDataSymbols.cpp:53-62; the reference tests against newbase's
kFloatMissing=32700 -- here missing is NaN or <= -9000, this package's
convention).

The evaluator is a whitelisted Python-AST walk over numpy vectors -- no
``eval``; unknown names/calls/nodes are errors, as in the reference.

The counterpart of ``roadsurf_tpu/io/masks.py``: the same host numpy, so the
same values bit for bit.
"""
from __future__ import annotations

import ast
import operator
from typing import Dict

import numpy as np

from .gridsource import bilinear_at_points

_BIN_OPS = {
    ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
    ast.Div: operator.truediv, ast.Mod: operator.mod,
}
_CMP_OPS = {
    ast.Lt: operator.lt, ast.LtE: operator.le, ast.Gt: operator.gt,
    ast.GtE: operator.ge, ast.Eq: operator.eq, ast.NotEq: operator.ne,
}


def _is_missing(x):
    return np.isnan(x) | (x <= -9000.0)


class _Evaluator(ast.NodeVisitor):
    def __init__(self, variables: Dict[str, np.ndarray]):
        self.vars = variables

    def visit_Expression(self, node):
        return self.visit(node.body)

    def visit_Name(self, node):
        if node.id == "PI":
            return np.pi
        if node.id in self.vars:
            return self.vars[node.id]
        raise ValueError(f"Unrecognized variable name: {node.id}")

    def visit_Constant(self, node):
        if isinstance(node.value, bool) or not isinstance(
                node.value, (int, float)):
            raise ValueError(f"Unsupported constant: {node.value!r}")
        return float(node.value)

    def visit_BinOp(self, node):
        op = _BIN_OPS.get(type(node.op))
        if op is None:
            raise ValueError(f"Unsupported operator: {ast.dump(node.op)}")
        return op(self.visit(node.left), self.visit(node.right))

    def visit_UnaryOp(self, node):
        v = self.visit(node.operand)
        if isinstance(node.op, ast.USub):
            return -v
        if isinstance(node.op, ast.Not):
            return ~np.asarray(v, bool)
        raise ValueError(f"Unsupported unary op: {ast.dump(node.op)}")

    def visit_BoolOp(self, node):
        vals = [np.asarray(self.visit(v), bool) for v in node.values]
        out = vals[0]
        for v in vals[1:]:
            out = (out & v) if isinstance(node.op, ast.And) else (out | v)
        return out

    def visit_Compare(self, node):
        left = self.visit(node.left)
        out = None
        for op, cmp_node in zip(node.ops, node.comparators):
            fn = _CMP_OPS.get(type(op))
            if fn is None:
                raise ValueError(f"Unsupported comparison: {ast.dump(op)}")
            right = self.visit(cmp_node)
            piece = fn(left, right)
            out = piece if out is None else (out & piece)
            left = right
        return out

    def visit_Call(self, node):
        if not isinstance(node.func, ast.Name):
            raise ValueError("Only simple function calls are supported")
        name = node.func.id
        args = [self.visit(a) for a in node.args]
        if name == "missing":
            if len(args) != 1:
                raise ValueError("missing function takes exactly one argument")
            return _is_missing(np.asarray(args[0], np.float64))
        raise ValueError(f"Unrecognized function: {name}")

    def generic_visit(self, node):
        raise ValueError(f"Unsupported expression element: "
                         f"{type(node).__name__}")


def eval_mask_expression(formula: str, variables: Dict[str, np.ndarray]
                         ) -> np.ndarray:
    """Evaluate a boolean mask formula over per-point variable vectors."""
    # normalize stx-style operators to Python syntax
    formula = (formula.replace("&&", " and ").replace("||", " or ")
               .replace("!=", "\x00ne\x00").replace("!", " not ")
               .replace("\x00ne\x00", "!="))
    tree = ast.parse(formula, mode="eval")
    out = _Evaluator(variables).visit(tree)
    out = np.asarray(out)
    if out.dtype != bool:
        raise ValueError(f"Expression {formula!r} value must be boolean")
    return out


def expression_mask(formula: str, grid_path: str, plat: np.ndarray,
                    plon: np.ndarray, verbose: bool = False) -> np.ndarray:
    """Evaluate a mask formula against a static grid file at points [P].

    The grid file is npz with ``lats`` [ny], ``lons`` [nx] and any number of
    [ny, nx] (or [1, ny, nx]) float fields; each field name becomes an
    expression variable, interpolated bilinearly to the points.
    """
    z = np.load(grid_path)
    lats = np.asarray(z["lats"], np.float64)
    lons = np.asarray(z["lons"], np.float64)
    variables = {}
    for k in z.files:
        if k in ("lats", "lons", "times"):
            continue
        f = np.asarray(z[k], np.float64)
        if f.ndim == 3:
            f = f[0]
        variables[k] = bilinear_at_points(f, lats, lons, plat, plon)
    keep = eval_mask_expression(formula, variables)
    if verbose:
        print(f"Using grid mask {grid_path}\n"
              f"\tenabled  {int(keep.sum())} points\n"
              f"\tdisabled {int((~keep).sum())} points")
    return keep
