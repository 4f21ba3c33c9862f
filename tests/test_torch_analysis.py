"""The port's static-analysis gate (``src/repro_torch/analysis``).

Parity with the reference's checkers where the bug class is the same
(units lint on the four suffix-convention modules, the id-keyed caches),
one true-positive and one clean-negative fixture for every port code,
the ``.cu`` launch and MMA sites of the committed kernels, the self-lint
of the committed tree with its baseline, the CLI, and phase 15 of
``chip_smoke.py`` rehearsed on the CPU (the SASS check on canned
listings, the guard bands on CPU tensors).  The reference is imported
here only, never by the port.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import chip_smoke
from repro.analysis.base import SourceFile as RefSourceFile
from repro.analysis.jit_hygiene import JitHygieneChecker as RefHygiene
from repro.analysis.units import UnitsChecker as RefUnits
from repro_torch.analysis import cuda_checks, lint
from repro_torch.analysis.base import CODES, SourceFile
from repro_torch.analysis.hygiene import HygieneChecker
from repro_torch.analysis.units import UnitsChecker
from repro_torch.kernels import int8_quant as iq

ROOT = Path(__file__).resolve().parents[1]
PORT_PY = "src/repro_torch/fixture.py"
CU = "src/repro_torch/kernels/csrc/fixture.cu"


def found(text: str, path: str = PORT_PY):
    """``[(code, line)]`` of the active findings of ``text`` at ``path``."""
    active, _ = lint.lint_file(SourceFile(path, textwrap.dedent(text)))
    return [(f.code, f.line) for f in active]


def codes(text: str, path: str = PORT_PY):
    return sorted({c for c, _ in found(text, path)})


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------

def _keyed(findings):
    return sorted((f.code, f.line, f.col, f.message) for f in findings)


@pytest.mark.parametrize("rel", lint.UNITS_SCOPE)
def test_units_match_the_reference_on_the_port_modules(rel):
    text = (ROOT / rel).read_text()
    port = UnitsChecker().check(SourceFile(rel, text))
    ref = RefUnits().check(RefSourceFile(rel, text))
    assert _keyed(port) == _keyed(ref)
    if rel.endswith("wire.py"):
        # the int8 codec's one byte per element, disabled in both gates
        assert [(f.code, f.line) for f in port] == [("RA302", 85),
                                                     ("RA301", 85)]
        active, disabled = lint.lint_file(SourceFile(rel, text))
        assert not active and len(disabled) == 2
    else:
        assert port == []


UNITS_FIXTURES = {
    "mix": "def f(act_bytes, act_elems):\n    return act_bytes + act_elems\n",
    "keyword": "def g(x_bytes):\n    return h(act_elems=x_bytes)\n",
    "return": "def wire_bytes(n_elems):\n    return n_elems * 2\n",
    "clean": "def f(x_mb, bw_mbps):\n    return x_mb / bw_mbps\n",
}


@pytest.mark.parametrize("name", sorted(UNITS_FIXTURES))
def test_units_match_the_reference_on_fixtures(name):
    text = UNITS_FIXTURES[name]
    port = UnitsChecker().check(SourceFile(lint.UNITS_SCOPE[1], text))
    ref = RefUnits().check(RefSourceFile(lint.UNITS_SCOPE[1], text))
    assert _keyed(port) == _keyed(ref)
    assert bool(port) == (name != "clean")


ID_FIXTURES = {
    "plain_dict": "_C = {}\ndef f(m):\n    _C[id(m)] = m\n",
    "dict_call": "_C = dict()\ndef f(m, k):\n    _C[(k, id(m))] = m\n",
    "bounded": ("class L:\n    def put(self, k, v): pass\n_C = L()\n"
                "def f(m):\n    _C.put(id(m), m)\n"),
    "not_id": "_C = {}\ndef f(m):\n    _C[m.name] = m\n",
}


@pytest.mark.parametrize("name", sorted(ID_FIXTURES))
def test_id_caches_match_the_reference(name):
    text = ID_FIXTURES[name]
    port = [f for f in HygieneChecker().check(SourceFile(PORT_PY, text))
            if f.code == "RA103"]
    ref = [f for f in RefHygiene().check(RefSourceFile(PORT_PY, text))
           if f.code == "RA103"]
    assert [(f.line, f.col) for f in port] == [(f.line, f.col) for f in ref]
    assert bool(port) == (name in ("plain_dict", "dict_call"))


# ---------------------------------------------------------------------------
# Python fixtures: one true positive and one clean negative per code
# ---------------------------------------------------------------------------

PY_CASES = {
    # RA000 / RA001
    "ra000": ("def f(:\n    pass\n", ["RA000"]),
    "ra000_clean": ("def f():\n    pass\n", []),
    "ra001_no_reason": ("x = 1  # repro-lint: disable=RA101\n", ["RA001"]),
    "ra001_unknown": ("x = 1  # repro-lint: disable=RA999 because\n",
                      ["RA001"]),
    "ra001_clean": ("x = 1  # repro-lint: disable=RA101 a reason\n", []),
    # RA101
    "ra101_compile": ("import torch\nfor m in ms:\n    f = torch.compile(m)\n",
                      ["RA101"]),
    "ra101_graph": ("import torch\nwhile go():\n"
                    "    g = torch.cuda.CUDAGraph()\n", ["RA101"]),
    "ra101_cdll": ("import ctypes\nfor p in ps:\n    ctypes.CDLL(p)\n",
                   ["RA101"]),
    "ra101_library": ("from repro_torch.kernels import _build\n"
                      "def f(ns):\n    for n in ns:\n"
                      "        _build.library(n)\n", ["RA101"]),
    "ra101_hoisted": ("import torch\nf = torch.compile(m)\nfor x in xs:\n"
                      "    f(x)\n", []),
    "ra101_defined_in_loop": ("import torch\nfor m in ms:\n    def f():\n"
                              "        return torch.compile(m)\n", []),
    # RA102
    "ra102": ("import torch\ndef step(m, x):\n"
              "    return torch.compile(m)(x)\n", ["RA102"]),
    "ra102_script": ("import torch\ndef step(m, x):\n"
                     "    return torch.jit.script(m)(x)\n", ["RA102"]),
    "ra102_module_level": ("import torch\ny = torch.compile(m)(x)\n", []),
    # RA103
    "ra103": (ID_FIXTURES["plain_dict"], ["RA103"]),
    "ra103_clean": (ID_FIXTURES["bounded"], []),
    # RA104
    "ra104_randn": ("import torch\nx = torch.randn(3)\n", ["RA104"]),
    "ra104_none": ("import torch\nx = torch.rand(3, generator=None)\n",
                   ["RA104"]),
    "ra104_inplace": ("import torch\nx = torch.empty(3).normal_()\n",
                      ["RA104"]),
    "ra104_dropout": ("import torch.nn.functional as F\n"
                      "y = F.dropout(x, 0.1)\n", ["RA104"]),
    "ra104_random": ("import random\nrandom.shuffle(xs)\n", ["RA104"]),
    "ra104_numpy": ("import numpy as np\nx = np.random.rand(3)\n", ["RA104"]),
    "ra104_seed": ("import numpy as np\nnp.random.seed(0)\n", ["RA104"]),
    "ra104_next_line": ("import torch\nx = torch.randn((2, 3),\n"
                        "                generator=g)\n", []),
    "ra104_seeded": ("import random\nimport numpy as np\n"
                     "r = np.random.default_rng(0)\ns = random.Random(0)\n"
                     "t = np.random.Generator(np.random.Philox(key=0))\n", []),
    # RA105
    "ra105": ("import functools\n@functools.cache\ndef lib(names):\n"
              "    return names\nlib(['a', 'b'])\n", ["RA105"]),
    "ra105_lru": ("from functools import lru_cache\n@lru_cache(maxsize=4)\n"
                  "def lib(n, opts=()):\n    return n\n"
                  "lib(1, opts={'a': 1})\n", ["RA105"]),
    "ra105_tuple": ("import functools\n@functools.cache\ndef lib(names):\n"
                    "    return names\nlib(('a', 'b'))\n", []),
    "ra105_uncached": ("def lib(names):\n    return names\nlib(['a'])\n", []),
    # RA401
    "ra401_jax": ("import jax.numpy as jnp\n", ["RA401"]),
    "ra401_repro": ("from repro.core import wire\n", ["RA401"]),
    "ra401_dynamic": ("import importlib\nm = importlib.import_module('jax')\n",
                      ["RA401"]),
    "ra401_ml_dtypes": ("import ml_dtypes\n", ["RA401"]),
    "ra401_clean": ("import repro_torch.api\nfrom repro_torch import api\n"
                    "import jaxtyping\nimport reprox\n", []),
}


@pytest.mark.parametrize("name", sorted(PY_CASES))
def test_python_fixture(name):
    text, want = PY_CASES[name]
    assert codes(text) == want


def test_global_generator_check_is_scoped_to_the_package():
    text = "import torch\nx = torch.randn(3)\n"
    assert codes(text, "src/repro_torch/models/x.py") == ["RA104"]
    assert codes(text, "chip_smoke.py") == []
    assert codes(text, "examples/x_torch.py") == []


def test_units_lint_is_scoped_to_its_four_modules():
    text = UNITS_FIXTURES["mix"]
    assert codes(text, lint.UNITS_SCOPE[0]) == ["RA301"]
    assert codes(text, PORT_PY) == []


def test_disable_next_and_string_literals():
    assert found("import torch\nfor m in ms:\n"
                 "    # repro-lint: disable-next=RA101 one graph per model\n"
                 "    f = torch.compile(m)\n") == []
    # only real comments disable
    assert codes("import torch\nfor m in ms:\n"
                 "    f = torch.compile(m); "
                 "s = '# repro-lint: disable=RA101 x'\n") == ["RA101"]


# ---------------------------------------------------------------------------
# CUDA fixtures
# ---------------------------------------------------------------------------

KERNEL_X = """
__global__ void kx(float* o, int n) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i < n) o[i] = 1.0f;
}
"""
KERNEL_XY = """
__global__ void kxy(float* o, int n) {
  o[blockIdx.y * n + blockIdx.x] = 1.0f;
}
"""
KERNEL_HELPER = """
__device__ int row() { return blockIdx.y; }
__global__ void kh(float* o, int n) { o[row() * n + blockIdx.x] = 1.0f; }
"""
KERNEL_WALK = """
__global__ void kw(float* o, int n) {
  for (int i = blockIdx.x; i < n; i += gridDim.x) o[i] = 1.0f;
}
"""


def launch(kernel: str, body: str) -> str:
    return kernel + "void run(float* o, int n, int b, int h, " \
        "cudaStream_t st) {\n" + body + "\n}\n"


CU_CASES = {
    # RA000 / RA001
    "ra000_comment": ("/* never closed\nint x;\n", ["RA000"]),
    "ra000_brace": ("void f() {\n", ["RA000"]),
    "ra000_clean": ("// fine\nint x = 1;\n", []),
    "ra001_no_reason": (launch(KERNEL_X,
                               "  kx<<<n / 256, 256, 0, st>>>(o, n);  "
                               "// repro-lint: disable=RA502"),
                        ["RA001"]),
    "ra001_unknown": ("/* repro-lint: disable=RA777 because */\n", ["RA001"]),
    "ra001_clean": (launch(KERNEL_X,
                           "  // repro-lint: disable-next=RA502 n is a "
                           "multiple of 256 here\n"
                           "  kx<<<n / 256, 256, 0, st>>>(o, n);"), []),
    # RA501
    "ra501_1d_reads_y": (launch(KERNEL_XY, "  kxy<<<(n + 255) / 256, 256, "
                                           "0, st>>>(o, n);"), ["RA501"]),
    "ra501_extra_axis": (launch(KERNEL_X, "  kx<<<dim3((n + 255) / 256, h), "
                                          "256>>>(o, n);"), ["RA501"]),
    "ra501_helper": (launch(KERNEL_HELPER,
                            "  const dim3 grid((n + 255) / 256);\n"
                            "  kh<<<grid, 256, 0, st>>>(o, n);"), ["RA501"]),
    "ra501_clean": (launch(KERNEL_XY,
                           "  dim3 grid((n + 255) / 256, h, 1);\n"
                           "  kxy<<<grid, 256, 0, st>>>(o, n);"), []),
    "ra501_template_parameter": (
        KERNEL_XY + "template <typename K> void run(K kernel, int n) {\n"
        "  kernel<<<n, 256>>>(nullptr, n);\n}\n", []),
    # RA502
    "ra502_floor": (launch(KERNEL_X, "  kx<<<n / 256, 256, 0, st>>>(o, n);"),
                    ["RA502"]),
    "ra502_floor_local": (launch(KERNEL_X,
                                 "  const int blocks = h * (n / b);\n"
                                 "  kx<<<static_cast<unsigned>(blocks), 256>>>"
                                 "(o, n);"), ["RA502"]),
    "ra502_cap": (launch(KERNEL_X, "  kx<<<min(n, 132), 256>>>(o, n);"),
                  ["RA502"]),
    "ra502_ceil": (launch(KERNEL_X,
                          "  const int tiles = (n + b - 1) / b;\n"
                          "  const long long blocks = "
                          "static_cast<long long>(h) * tiles;\n"
                          "  kx<<<static_cast<unsigned>(blocks), 256>>>"
                          "(o, n);"), []),
    "ra502_ceil_literal": (launch(KERNEL_X, "  kx<<<(n + 255) / 256, "
                                            "256>>>(o, n);"), []),
    "ra502_persistent": (launch(KERNEL_WALK,
                                "  kw<<<min(n / 256, 132), 256>>>(o, n);"),
                         []),
    "ra502_parameters": (launch(KERNEL_X, "  kx<<<h * b, 256>>>(o, n);"), []),
    # RA503
    "ra503_wgmma_f16": (
        'void f() { asm volatile("{\\n.reg .pred p;\\n"\n'
        '  "wgmma.mma_async.sync.aligned.m64n64k16.f16.bf16.bf16 "\n'
        '  "{%0}, %1, %2, p, 1, 1, 0, 0;\\n}\\n"); }\n', ["RA503"]),
    "ra503_mma_c_f16": (
        'void f() { asm volatile('
        '"mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f16 {%0};"); }\n',
        ["RA503"]),
    "ra503_wmma_half": (
        "void f() {\n"
        "  wmma::fragment<wmma::accumulator, 16, 16, 16, half> c; }\n",
        ["RA503"]),
    "ra503_clean": (
        'void f() { asm volatile("setp.ne.b32 p, %34, 0;\\n"\n'
        '  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0};");\n'
        '  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 '
        '{%0};");\n'
        "  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c; }\n", []),
}


@pytest.mark.parametrize("name", sorted(CU_CASES))
def test_cuda_fixture(name):
    text, want = CU_CASES[name]
    assert codes(text, CU) == want


def test_cuda_fixture_lines_and_messages():
    text = launch(KERNEL_X, "  kx<<<n / 256, 256, 0, st>>>(o, n);")
    active, _ = lint.lint_file(SourceFile(CU, text))
    (f,) = active
    assert (f.code, f.line) == ("RA502", 7)
    assert "`n / 256` is a floor division" in f.message
    # the message is the baseline key: no line or column in it
    assert not re.search(r"\b7\b", f.message)


# Launch sites of the committed kernels: (line, kernel or None, kinds).
LAUNCHES = {
    "flash_attention": [(1018, None, None),
                        (1094, "flash_fwd_bf16", ["ceil"])],
    "gla_scan": [(2012, "gla_fwd", ["ceil"]),
                 (2092, "gla_fwd_bf16", ["persistent"]),
                 (2115, "gla_fwd_wide_bf16", ["ceil"])],
    "int8_quant": [(386, "quant_rows_absmax", ["unknown"]),
                   (391, "quant_rows_apply", ["unknown"]),
                   (394, "quant_rows_apply", ["unknown"]),
                   (451, "check_quotient_kernel", ["persistent", "unknown"])],
}
MMA_LINES = {
    "flash_attention": [322, 345, 381, 406, 440, 477],
    "gla_scan": [581, 707, 797, 820, 856, 880, 1525],
    "int8_quant": [],
}


def repo_cu(name: str) -> SourceFile:
    rel = f"src/repro_torch/kernels/csrc/{name}.cu"
    return SourceFile(rel, (ROOT / rel).read_text())


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_repo_launch_and_mma_sites(name):
    src = repo_cu(name)
    assert src.parse_error is None
    got = [(ln.line, ln.kernel, ln.kinds)
           for ln in cuda_checks.launches(src.lexed)]
    assert got == LAUNCHES[name]
    sites = cuda_checks.mma_sites(src.lexed)
    assert [s.line for s in sites] == MMA_LINES[name]
    assert all(s.acc and set(s.acc) == {"f32"} for s in sites)
    if name == "gla_scan":
        assert (sites[0].op, sites[0].shape, sites[0].atype) == \
            ("mma.sync", "m16n8k8", "tf32")
        assert (sites[-1].shape, sites[-1].atype) == ("m64n64k8", "tf32")


def test_check_quotient_kernel_reads_y_and_walks_x():
    (*_, ln) = cuda_checks.launches(repo_cu("int8_quant").lexed)
    assert ln.grid == ["64", "n"]
    assert ln.reads == {"blockIdx.x", "blockIdx.y", "gridDim.x"}


# ---------------------------------------------------------------------------
# Self-lint, baseline, scope, CLI
# ---------------------------------------------------------------------------

def test_port_tree_is_clean_under_its_baseline():
    report = lint.run(str(ROOT), baseline_path=lint.DEFAULT_BASELINE,
                      check_baseline=True)
    assert report["ok"], json.dumps(report["new"] + report["stale_baseline"],
                                    indent=2)
    s = report["summary"]
    assert s["new"] == 0 and s["stale_baseline"] == 0
    assert s["disabled"] >= 1
    paths = {f["path"] for f in report["disabled"]}
    assert "src/repro_torch/core/wire.py" in paths
    assert s["files"] > 80


@pytest.mark.parametrize("rel", ["src/repro_torch/core/wire.py",
                                 "src/repro_torch/kernels/_build.py"])
def test_stripping_a_committed_disable_turns_red(rel):
    text = (ROOT / rel).read_text()
    assert "repro-lint: disable" in text, f"{rel} lost its disables"
    stripped = "\n".join(line.split("# repro-lint:")[0].rstrip()
                         for line in text.splitlines())
    active, _ = lint.lint_file(SourceFile(rel, stripped))
    assert active, f"{rel}: stripping disables found nothing"


def test_baseline_ratchet(tmp_path):
    rel = "src/repro_torch/kernels/_build.py"
    entry = {"code": "RA101", "path": rel, "message": "gone", "reason": "r"}
    path = tmp_path / "b.json"
    path.write_text(json.dumps({"entries": [entry]}))
    report = lint.run(str(ROOT), [str(ROOT / rel)], str(path),
                      check_baseline=True)
    assert not report["ok"] and report["summary"]["stale_baseline"] == 1
    path.write_text(json.dumps({"entries": [dict(entry, reason=" ")]}))
    with pytest.raises(lint.BaselineError):
        lint.run(str(ROOT), [str(ROOT / rel)], str(path))
    assert json.loads((ROOT / lint.DEFAULT_BASELINE).read_text())[
        "entries"] == []


def test_default_scope_and_its_fallback(monkeypatch):
    files = lint.discover_files(str(ROOT))
    for rel in ("chip_smoke.py", "examples/serve_lm_torch.py",
                "src/repro_torch/api.py", "src/repro_torch/analysis/lint.py",
                *(f"src/repro_torch/kernels/csrc/{n}.cu" for n in LAUNCHES)):
        assert rel in files
    assert not any(f.startswith(("src/repro/", "tests/", "benchmarks/"))
                   for f in files)

    def no_git(*a, **k):
        raise OSError("no git")
    monkeypatch.setattr(lint.subprocess, "run", no_git)
    assert lint.discover_files(str(ROOT)) == files


def test_cli_lists_every_code_and_rejects_bad_flags():
    code = textwrap.dedent("""\
        import sys
        from repro_torch.analysis.lint import main
        rc = main(["--list-checks"])
        try:
            main(["--no-such-flag"])
            bad = 0
        except SystemExit as e:
            bad = e.code
        mods = sorted(m for m in sys.modules if m.split(".")[0] in
                      ("jax", "jaxlib", "repro", "ml_dtypes"))
        print("RESULT", rc, bad, mods)
        """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=60)
    assert "RESULT 0 2 []" in out.stdout, out.stdout + out.stderr
    listed = dict(re.findall(r"^(RA\d{3})  (.*)$", out.stdout, re.M))
    want = {"RA000", "RA001", "RA101", "RA102", "RA103", "RA104", "RA105",
            "RA201", "RA301", "RA302", "RA401", "RA501", "RA502", "RA503"}
    assert set(listed) == want == set(CODES)
    assert listed["RA201"].startswith("no counterpart")


# ---------------------------------------------------------------------------
# chip_smoke.py phase 15, rehearsed on the CPU
# ---------------------------------------------------------------------------

# Lines of the card's cuobjdump -sass listing of csrc/gla_scan.cu (H100,
# sm_90a): the narrow kernel's HGMMA, the wide one's TF32 products.
SASS = """\
\t\tFunction : _ZN44_GLOBAL__N__f25d059a_11_gla_scan_cu_66a1913012gla_fwd_bf16ILi128ELi128EEEv14CUtensorMap_stS1_S1_PKfP13__nv_bfloat16PfS6_iiiiii
        /*2930*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR40].tnspB, RZ, !UPT ;          /* 0x41e00000281879f0 */
        /*2980*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR12].tnspB, R24 ;               /* 0x41e000000c1879f0 */
\t\tFunction : _ZN44_GLOBAL__N__f25d059a_11_gla_scan_cu_66a1913017gla_fwd_wide_bf16ILi64EEEvPK13__nv_bfloat16
        /*a070*/                   HGMMA.64x64x8.F32.TF32 R24, R120, gdesc[UR16], R24 ;                 /* 0x04e0001078187df0 */
        /*a100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
"""


def test_sass_check_against_the_static_sites():
    sites = cuda_checks.mma_sites(repo_cu("gla_scan").lexed)
    n, problems = cuda_checks.check_sass(sites, SASS)
    assert (n, problems) == (4, [])
    n, problems = cuda_checks.check_sass(
        sites, SASS.replace("HMMA.1688.F32", "HMMA.1688.F16"))
    assert problems == [problems[0]] and "accumulates in F16" in problems[0]
    n, problems = cuda_checks.check_sass(
        sites, SASS.replace("HGMMA.64x64x8.F32.TF32", "FFMA"))
    assert len(problems) == 1 and "m64n64k8.tf32" in problems[0]
    # ptxas may split an mma.sync's K: m16n8k8 as HMMA.1684 is emitted
    _, problems = cuda_checks.check_sass(sites, SASS.replace("1688", "1684"))
    assert problems == []


def test_chip_smoke_sass_phase(capsys):
    sass = {"flash_attention": SASS.replace("gla_fwd", "flash_fwd").replace(
        "HGMMA.64x64x8.F32.TF32", "HGMMA.64x112x16.F32.BF16") +
        "  HGMMA.64x256x16.F32.BF16 R1 ;\n",
        "gla_scan": SASS, "int8_quant": "\t\tFunction : q\n  FFMA R1 ;\n"}
    rows = chip_smoke.check_sass_accumulators(ROOT, sass)
    assert rows["gla_scan"] == {"sites": 7, "instructions": 4,
                                "problems": []}
    assert rows["int8_quant"]["sites"] == rows["int8_quant"][
        "instructions"] == 0
    with pytest.raises(SystemExit):
        chip_smoke.check_sass_accumulators(
            ROOT, dict(sass, gla_scan=SASS.replace(".F32.BF16", ".F16.BF16")))


def test_chip_smoke_guard_bands():
    assert chip_smoke.GUARD_BYTES % 128 == 0
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        buf, view = chip_smoke.guarded(torch, (3, 5), dtype, "cpu")
        offset = (view.data_ptr() - buf.data_ptr())
        assert offset == chip_smoke.GUARD_BYTES and view.is_contiguous()
        view.copy_(torch.ones(3, 5))
        assert chip_smoke.check_guarded(torch, "ok", {"v": (buf, view)}) == \
            {"v": {"unwritten": 0, "guard_touched": 0}}
        hole = buf.clone()
        hole[offset // buf.element_size() + 7] = -128 if dtype == torch.int8 \
            else float("nan")
        g = (buf.numel() - view.numel()) // 2
        with pytest.raises(SystemExit):
            chip_smoke.check_guarded(torch, "hole", {
                "v": (hole, hole[g:g + 15].view(3, 5))})
        spill = buf.clone()
        spill[g + 15] = 0
        with pytest.raises(SystemExit):
            chip_smoke.check_guarded(torch, "spill", {
                "v": (spill, spill[g:g + 15].view(3, 5))})
    # another NaN in a guard is a write too
    buf, view = chip_smoke.guarded(torch, (4,), torch.float32, "cpu")
    view.zero_()
    buf.view(torch.int32)[0] = 0x7FC00001
    with pytest.raises(SystemExit):
        chip_smoke.check_guarded(torch, "payload", {"v": (buf, view)})


def test_chip_smoke_gate_phase(monkeypatch):
    class Done:
        returncode, stderr = 0, ""
        stdout = json.dumps({"summary": {"new": 0, "files": 90}})

    calls = []
    monkeypatch.setattr(chip_smoke.subprocess, "run",
                        lambda cmd, **kw: calls.append((cmd, kw)) or Done())
    assert chip_smoke.run_gate(ROOT) == {"new": 0, "files": 90}
    (cmd, kw), = calls
    assert cmd[1:] == ["-m", "repro_torch.analysis", "--check-baseline",
                       "--json", "-"]
    assert kw["cwd"] == str(ROOT)
    Done.returncode = 1
    with pytest.raises(SystemExit):
        chip_smoke.run_gate(ROOT)


def test_chip_smoke_ragged_extents_are_ragged():
    for dt, m, n in chip_smoke.RAGGED_QUANT:
        elem = 2 if dt == "bf16" else 4
        S, slice_elems = iq.plan_slices(m, n, elem)
        assert m % 2 == 1 and n % slice_elems and S > 1
    assert {(dt, hd) for dt, _, _, T, hd, _ in chip_smoke.RAGGED_FLASH
            if T == 1000} == {("bf16", 64), ("bf16", 128), ("f32", 64)}
    routes = set()
    for _, dt, _, T, dk, dv, W, _, _ in chip_smoke.RAGGED_GLA:
        assert T % W
        routes.add(chip_smoke.gla_kernel(dt == "bf16", dk, dv))
    assert routes == {"gla_fwd_bf16", "gla_fwd_wide_bf16", "gla_fwd"}
