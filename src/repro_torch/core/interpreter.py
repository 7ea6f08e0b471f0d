# Copy of src/repro/core/interpreter.py (commit aa57dc1); imports may differ.
"""Reference netlist interpreter — the oracle for everything downstream.

Full-cycle, cycle-accurate semantics (paper §2.1): each ``step`` evaluates the
combinational DAG from current state, then commits registers and memory
writes atomically. Exceptions (EXPECT) are collected per cycle and surfaced to
the caller, mirroring Manticore's host-serviced exceptions (paper §A.3.2).

This interpreter is intentionally simple Python (exact 64-bit integer
semantics); it is the ground truth against which the compiler, the jnp
lockstep engine, and the Pallas kernel are validated.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .netlist import Circuit, NOp, Node


@dataclass
class CycleResult:
    exceptions: List[int] = field(default_factory=list)
    outputs: Dict[str, int] = field(default_factory=dict)


class NetlistSim:
    """Executable model of a :class:`Circuit`."""

    def __init__(self, circuit: Circuit):
        circuit.validate()
        self.c = circuit
        self.order = self._topo_order()
        self.regs: Dict[int, int] = dict(circuit.reg_init)
        self.mems: Dict[str, List[int]] = {
            name: list(m.init) for name, m in circuit.mems.items()}
        self.cycle = 0

    # ------------------------------------------------------------------
    def _topo_order(self) -> List[Node]:
        """Topological order of combinational nodes (REG/INPUT/CONST are
        leaves; MEMRD reads *current* memory state so it is a leaf too,
        except for its address operand)."""
        nodes = self.c.nodes
        order: List[Node] = []
        state = [0] * len(nodes)  # 0=unvisited 1=visiting 2=done
        stack: List[Tuple[int, int]] = []
        for root in range(len(nodes)):
            if state[root]:
                continue
            stack.append((root, 0))
            while stack:
                nid, ai = stack.pop()
                node = nodes[nid]
                if ai == 0:
                    if state[nid] == 2:
                        continue
                    if state[nid] == 1:
                        raise ValueError("combinational loop in netlist")
                    state[nid] = 1
                if ai < len(node.args):
                    stack.append((nid, ai + 1))
                    arg = node.args[ai]
                    if state[arg] == 0:
                        stack.append((arg, 0))
                    elif state[arg] == 1:
                        raise ValueError("combinational loop in netlist")
                else:
                    state[nid] = 2
                    order.append(node)
        return order

    # ------------------------------------------------------------------
    def step(self) -> CycleResult:
        c = self.c
        val: List[int] = [0] * len(c.nodes)
        res = CycleResult()
        mem_writes: List[Tuple[str, int, int]] = []

        for n in self.order:
            a = n.args
            op = n.op
            mask = (1 << n.width) - 1
            if op == NOp.CONST:
                val[n.nid] = n.params["value"]
            elif op == NOp.INPUT:
                val[n.nid] = c.input_values[n.nid]
            elif op == NOp.REG:
                val[n.nid] = self.regs[n.nid]
            elif op == NOp.AND:
                val[n.nid] = val[a[0]] & val[a[1]]
            elif op == NOp.OR:
                val[n.nid] = val[a[0]] | val[a[1]]
            elif op == NOp.XOR:
                val[n.nid] = val[a[0]] ^ val[a[1]]
            elif op == NOp.NOT:
                val[n.nid] = (~val[a[0]]) & mask
            elif op == NOp.ADD:
                val[n.nid] = (val[a[0]] + val[a[1]]) & mask
            elif op == NOp.SUB:
                val[n.nid] = (val[a[0]] - val[a[1]]) & mask
            elif op == NOp.MUL:
                val[n.nid] = (val[a[0]] * val[a[1]]) & mask
            elif op == NOp.EQ:
                val[n.nid] = int(val[a[0]] == val[a[1]])
            elif op == NOp.NE:
                val[n.nid] = int(val[a[0]] != val[a[1]])
            elif op == NOp.LTU:
                val[n.nid] = int(val[a[0]] < val[a[1]])
            elif op == NOp.SHL:
                val[n.nid] = (val[a[0]] << n.params["amount"]) & mask
            elif op == NOp.SHR:
                val[n.nid] = val[a[0]] >> n.params["amount"]
            elif op == NOp.SRA:
                src = c.nodes[a[0]]
                v = val[a[0]]
                sign = v >> (src.width - 1)
                k = min(n.params["amount"], src.width)
                v >>= k
                if sign:
                    v |= mask & ~((1 << max(src.width - k, 0)) - 1)
                val[n.nid] = v & mask
            elif op == NOp.MUX:
                val[n.nid] = val[a[1]] if val[a[0]] else val[a[2]]
            elif op == NOp.SLICE:
                val[n.nid] = (val[a[0]] >> n.params["off"]) & mask
            elif op == NOp.CAT:
                lo = c.nodes[a[1]]
                val[n.nid] = (val[a[0]] << lo.width) | val[a[1]]
            elif op == NOp.MEMRD:
                m = self.mems[n.params["mem"]]
                val[n.nid] = m[val[a[0]] % len(m)]
            elif op == NOp.MEMWR:
                if val[a[2]]:
                    mem_writes.append((n.params["mem"], val[a[0]], val[a[1]]))
            elif op == NOp.EXPECT:
                if val[a[0]] != val[a[1]]:
                    res.exceptions.append(n.params["eid"])
            elif op == NOp.OUTPUT:
                res.outputs[n.params["name"]] = val[a[0]]
            else:  # pragma: no cover
                raise NotImplementedError(op)

        # ---- commit phase (end of Vcycle) ----
        for rid, nxt in c.reg_next.items():
            self.regs[rid] = val[nxt]
        for name, addr, data in mem_writes:
            m = self.mems[name]
            m[addr % len(m)] = data
        self.cycle += 1
        return res

    def run(self, max_cycles: int,
            stop_on_exception: bool = True) -> Tuple[int, List[CycleResult]]:
        """Run until an exception fires or max_cycles elapse. Returns
        (cycles_run, per-cycle results that had exceptions/outputs)."""
        log: List[CycleResult] = []
        for i in range(max_cycles):
            r = self.step()
            if r.exceptions or r.outputs:
                log.append(r)
            if r.exceptions and stop_on_exception:
                return i + 1, log
        return max_cycles, log

    def reg_value(self, name: str) -> int:
        for rid, nm in self.c.reg_names.items():
            if nm == name:
                return self.regs[rid]
        raise KeyError(name)
