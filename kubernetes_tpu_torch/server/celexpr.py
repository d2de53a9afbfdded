"""Restricted CEL-style expression evaluator for admission policies.

The reference evaluates ValidatingAdmissionPolicy expressions with CEL
(apiserver/pkg/admission/plugin/policy/validating/plugin.go + cel-go). This
is a deliberately small, safe replacement covering the subset admission
policies actually use:

  - variables: `object`, `oldObject`, `request` (wire-form dicts; attribute
    access works on dict keys: `object.spec.replicas`)
  - operators: && || !  == != < <= > >=  + - * %  in
  - functions: has(x), size(x), string(x), int(x), double(x),
    x.startsWith(s), x.endsWith(s), x.contains(s), x.matches(re)
  - literals: numbers, strings, lists, true/false/null

Safety: the expression is parsed with `ast` and *interpreted* by an explicit
whitelist walker — no eval(), no attribute access on real Python objects
(dict keys only), no calls except the builtins above. Anything outside the
whitelist raises ExpressionError at compile time.

CEL-vs-Python surface syntax is bridged by token translation (&& -> and,
|| -> or, prefix ! -> not, true/false/null literals); `has()` follows CEL:
missing fields are absent, not errors, and comparisons against an absent
field evaluate false.

The counterpart of `kubernetes_tpu/server/celexpr.py`: the same behaviour,
names and responses, held equal to it by the port's tests.
"""

from __future__ import annotations

import ast
import re as _re
from typing import Any, Callable, Dict


class ExpressionError(Exception):
    """Compile- or eval-time failure of a policy expression."""


class _Missing:
    """CEL absent-field semantics: propagates through navigation, fails
    every comparison, is falsy."""

    def __repr__(self):
        return "<absent>"

    def __bool__(self):
        return False


MISSING = _Missing()

_ALLOWED_METHODS = {"startsWith", "endsWith", "contains", "matches"}
_ALLOWED_FUNCS = {"has", "size", "string", "int", "double"}


_KEYWORDS = {"true": "True", "false": "False", "null": "None"}


def _translate(src: str) -> str:
    """CEL surface syntax -> Python-parsable: && || ! and true/false/null —
    all rewritten ONLY outside string literals (a policy comparing against
    the strings 'true'/'false'/'null' must see them verbatim)."""
    out = []
    i, n = 0, len(src)
    in_str: str = ""
    while i < n:
        c = src[i]
        if in_str:
            out.append(c)
            if c == in_str and src[i - 1] != "\\":
                in_str = ""
            i += 1
            continue
        if c in ("'", '"'):
            in_str = c
            out.append(c)
            i += 1
            continue
        if src.startswith("&&", i):
            out.append(" and ")
            i += 2
            continue
        if src.startswith("||", i):
            out.append(" or ")
            i += 2
            continue
        if c == "!" and not src.startswith("!=", i):
            out.append(" not ")
            i += 1
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            word = src[i:j]
            # keyword literals only as standalone identifiers, never after
            # a "." (field names like object.spec.true stay untouched)
            prev = out[-1] if out else ""
            if word in _KEYWORDS and prev != ".":
                out.append(_KEYWORDS[word])
            else:
                out.append(word)
            i = j
            continue
        i += 1
        out.append(c)
    return "".join(out).strip()  # leading "!"-space breaks ast.parse


class _Evaluator:
    def __init__(self, variables: Dict[str, Any]):
        self.vars = variables

    def eval(self, node: ast.AST) -> Any:
        m = getattr(self, f"_eval_{type(node).__name__}", None)
        if m is None:
            raise ExpressionError(
                f"disallowed syntax: {type(node).__name__}")
        return m(node)

    def _eval_Expression(self, n):
        return self.eval(n.body)

    def _eval_Constant(self, n):
        if isinstance(n.value, (bool, int, float, str, type(None))):
            return n.value
        raise ExpressionError(f"disallowed literal {n.value!r}")

    def _eval_List(self, n):
        return [self.eval(e) for e in n.elts]

    def _eval_Name(self, n):
        if n.id in self.vars:
            return self.vars[n.id]
        raise ExpressionError(f"unknown variable {n.id!r}")

    def _eval_Attribute(self, n):
        base = self.eval(n.value)
        if base is MISSING:
            return MISSING
        if isinstance(base, dict):
            return base.get(n.attr, MISSING)
        raise ExpressionError(
            f"cannot navigate .{n.attr} on {type(base).__name__}")

    def _eval_Subscript(self, n):
        base = self.eval(n.value)
        if base is MISSING:
            return MISSING
        idx = self.eval(n.slice)
        if isinstance(base, dict):
            return base.get(idx, MISSING)
        if isinstance(base, list) and isinstance(idx, int):
            return base[idx] if -len(base) <= idx < len(base) else MISSING
        raise ExpressionError("bad subscript")

    def _eval_BoolOp(self, n):
        if isinstance(n.op, ast.And):
            return all(self._truthy(self.eval(v)) for v in n.values)
        return any(self._truthy(self.eval(v)) for v in n.values)

    def _eval_UnaryOp(self, n):
        v = self.eval(n.operand)
        if isinstance(n.op, ast.Not):
            return not self._truthy(v)
        if isinstance(n.op, ast.USub) and isinstance(v, (int, float)):
            return -v
        raise ExpressionError("disallowed unary op")

    def _eval_BinOp(self, n):
        left, right = self.eval(n.left), self.eval(n.right)
        if left is MISSING or right is MISSING:
            return MISSING
        ops = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
               ast.Mult: lambda a, b: a * b, ast.Mod: lambda a, b: a % b,
               ast.Div: lambda a, b: a / b}
        fn = ops.get(type(n.op))
        if fn is None:
            raise ExpressionError("disallowed operator")
        try:
            return fn(left, right)
        except Exception as e:
            raise ExpressionError(f"arithmetic error: {e}")

    def _eval_Compare(self, n):
        left = self.eval(n.left)
        for op, comp in zip(n.ops, n.comparators):
            right = self.eval(comp)
            if left is MISSING or right is MISSING:
                # CEL: comparisons against absent fields don't match
                # (except != which is vacuously true against absence)
                ok = isinstance(op, ast.NotEq)
            else:
                try:
                    if isinstance(op, ast.Eq):
                        ok = left == right
                    elif isinstance(op, ast.NotEq):
                        ok = left != right
                    elif isinstance(op, ast.Lt):
                        ok = left < right
                    elif isinstance(op, ast.LtE):
                        ok = left <= right
                    elif isinstance(op, ast.Gt):
                        ok = left > right
                    elif isinstance(op, ast.GtE):
                        ok = left >= right
                    elif isinstance(op, ast.In):
                        ok = left in right
                    elif isinstance(op, ast.NotIn):
                        ok = left not in right
                    else:
                        raise ExpressionError("disallowed comparison")
                except TypeError:
                    ok = False
            if not ok:
                return False
            left = right
        return True

    def _eval_Call(self, n):
        if isinstance(n.func, ast.Attribute):
            # string methods: x.startsWith(s) etc.
            method = n.func.attr
            if method not in _ALLOWED_METHODS:
                raise ExpressionError(f"disallowed method {method!r}")
            base = self.eval(n.func.value)
            args = [self.eval(a) for a in n.args]
            if base is MISSING or any(a is MISSING for a in args):
                return False
            if not isinstance(base, str) or len(args) != 1 \
                    or not isinstance(args[0], str):
                raise ExpressionError(f"{method} expects string operands")
            if method == "startsWith":
                return base.startswith(args[0])
            if method == "endsWith":
                return base.endswith(args[0])
            if method == "contains":
                return args[0] in base
            try:
                return _re.search(args[0], base) is not None
            except _re.error as e:
                raise ExpressionError(f"bad regex: {e}")
        if not isinstance(n.func, ast.Name) or n.func.id not in _ALLOWED_FUNCS:
            raise ExpressionError("disallowed call")
        name = n.func.id
        if len(n.args) != 1:
            raise ExpressionError(f"{name}() takes one argument")
        if name == "has":
            # has() navigates without erroring: absent -> False
            return self.eval(n.args[0]) is not MISSING
        v = self.eval(n.args[0])
        if v is MISSING:
            return MISSING
        try:
            if name == "size":
                return len(v)
            if name == "string":
                return str(v)
            if name == "int":
                return int(v)
            return float(v)
        except (TypeError, ValueError) as e:
            raise ExpressionError(f"{name}(): {e}")

    @staticmethod
    def _truthy(v) -> bool:
        if v is MISSING:
            return False
        if not isinstance(v, bool):
            raise ExpressionError(f"non-boolean in boolean context: {v!r}")
        return v


def compile_expression(src: str) -> Callable[[Dict[str, Any]], bool]:
    """Parse once; returns evaluate(variables) -> bool. Raises
    ExpressionError on disallowed syntax (checked eagerly with dummy
    variables where possible — full checking happens per evaluation)."""
    try:
        tree = ast.parse(_translate(src), mode="eval")
    except SyntaxError as e:
        raise ExpressionError(f"cannot parse {src!r}: {e}")

    for node in ast.walk(tree):
        if isinstance(node, (ast.Lambda, ast.Await, ast.Yield, ast.YieldFrom,
                             ast.NamedExpr, ast.Starred, ast.FormattedValue,
                             ast.JoinedStr, ast.GeneratorExp, ast.ListComp,
                             ast.SetComp, ast.DictComp)):
            raise ExpressionError(
                f"disallowed syntax: {type(node).__name__}")
        if isinstance(node, ast.Attribute) and node.attr.startswith("__"):
            # navigation is dict-keyed so dunders are inert, but reject
            # them eagerly anyway — no policy legitimately uses them
            raise ExpressionError(f"disallowed attribute {node.attr!r}")
        if isinstance(node, ast.Name) and node.id.startswith("__"):
            raise ExpressionError(f"disallowed name {node.id!r}")

    def evaluate(variables: Dict[str, Any]) -> bool:
        result = _Evaluator(variables).eval(tree)
        if result is MISSING:
            return False
        if not isinstance(result, bool):
            raise ExpressionError(
                f"expression must evaluate to bool, got {type(result).__name__}")
        return result

    return evaluate
