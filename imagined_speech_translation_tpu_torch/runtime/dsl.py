"""The LLM function-call DSL: parser + executor.

Reference: ``dart_wss/lib/parser.dart:3-226`` — the language an LLM emits to
drive device/service actions:

* calls separated by ``¬``: ``speak(|hi|)¬send_email(|to|,|body|)``;
* arguments in ``(...)``, comma-separated;
* string literals delimited by ``|...|``;
* concatenation with ``^``: ``|hello |^get_display_name()``;
* nested calls as arguments, evaluated depth-first;
* execution dispatches against a name→callable registry
  (``dart_wss/lib/dart_wss.dart:65-100``), sync or async.

A copy of ``imagined_speech_translation_tpu.runtime.dsl`` (the port
imports nothing of the JAX package); ``tests/test_torch_runtime.py``
holds the copy to the original.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Any, Callable, Mapping

CALL_SEP = "¬"


class DslError(ValueError):
    pass


@dataclass(frozen=True)
class StringLit:
    value: str


@dataclass(frozen=True)
class Concat:
    parts: tuple


@dataclass(frozen=True)
class FunctionCall:
    name: str
    args: tuple = ()


class _Scanner:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def next(self) -> str:
        ch = self.peek()
        self.pos += 1
        return ch

    def skip_ws(self):
        while self.peek() in (" ", "\t", "\n", "\r"):
            self.pos += 1

    def expect(self, ch: str):
        if self.peek() != ch:
            raise DslError(
                f"expected {ch!r} at {self.pos} in {self.text[self.pos:self.pos+20]!r}"
            )
        self.pos += 1


class Parser:
    """Parse and execute DSL programs against a function registry."""

    def __init__(self, registry: Mapping[str, Callable] | None = None):
        self.registry = dict(registry or {})

    # -- parsing -----------------------------------------------------------
    def parse(self, program: str) -> list[FunctionCall]:
        calls = []
        for chunk in self._split_top_level(program):
            chunk = chunk.strip()
            if not chunk:
                continue
            sc = _Scanner(chunk)
            call = self._parse_call(sc)
            sc.skip_ws()
            if sc.pos != len(chunk):
                raise DslError(f"trailing input at {sc.pos} in {chunk!r}")
            calls.append(call)
        return calls

    @staticmethod
    def _split_top_level(program: str) -> list[str]:
        # split on ¬ outside string literals
        out, cur, in_str = [], [], False
        for ch in program:
            if ch == "|":
                in_str = not in_str
                cur.append(ch)
            elif ch == CALL_SEP and not in_str:
                out.append("".join(cur))
                cur = []
            else:
                cur.append(ch)
        out.append("".join(cur))
        return out

    def _parse_call(self, sc: _Scanner) -> FunctionCall:
        sc.skip_ws()
        name = []
        while sc.peek() and (sc.peek().isalnum() or sc.peek() == "_"):
            name.append(sc.next())
        if not name:
            raise DslError(f"expected function name at {sc.pos}")
        sc.skip_ws()
        sc.expect("(")
        args = []
        sc.skip_ws()
        if sc.peek() == ")":
            sc.next()
            return FunctionCall("".join(name), ())
        while True:
            args.append(self._parse_expr(sc))
            sc.skip_ws()
            ch = sc.next()
            if ch == ")":
                break
            if ch != ",":
                raise DslError(f"expected ',' or ')' at {sc.pos - 1}")
        return FunctionCall("".join(name), tuple(args))

    def _parse_expr(self, sc: _Scanner):
        parts = [self._parse_term(sc)]
        sc.skip_ws()
        while sc.peek() == "^":
            sc.next()
            parts.append(self._parse_term(sc))
            sc.skip_ws()
        if len(parts) == 1:
            return parts[0]
        return Concat(tuple(parts))

    def _parse_term(self, sc: _Scanner):
        sc.skip_ws()
        ch = sc.peek()
        if ch == "|":
            sc.next()
            chars = []
            while sc.peek() and sc.peek() != "|":
                chars.append(sc.next())
            sc.expect("|")
            return StringLit("".join(chars))
        if ch.isalnum() or ch == "_":
            return self._parse_call(sc)
        raise DslError(f"unexpected char {ch!r} at {sc.pos}")

    # -- execution ---------------------------------------------------------
    async def execute(self, program: str) -> list[Any]:
        """Parse and run every top-level call in order; returns their results."""
        results = []
        for call in self.parse(program):
            results.append(await self._eval(call))
        return results

    async def _eval(self, node) -> Any:
        if isinstance(node, StringLit):
            return node.value
        if isinstance(node, Concat):
            vals = [await self._eval(p) for p in node.parts]
            return "".join(str(v) for v in vals)
        if isinstance(node, FunctionCall):
            fn = self.registry.get(node.name)
            if fn is None:
                raise DslError(f"unknown function {node.name!r}")
            args = [await self._eval(a) for a in node.args]
            result = fn(*args)
            if inspect.isawaitable(result):
                result = await result
            return result
        raise DslError(f"bad node {node!r}")

    def execute_sync(self, program: str) -> list[Any]:
        """Convenience wrapper for synchronous registries."""
        import asyncio

        return asyncio.run(self.execute(program))
