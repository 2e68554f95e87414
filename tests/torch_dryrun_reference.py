"""The port's dry run beside the reference's on the same cells, the helper
of ``tests/test_torch_dryrun_reference.py`` and a script of its own: for
each mesh, the port's ``repro_torch.launch.dryrun`` cell (``meta``
tensors, and with ``--fake`` fake ones too) and the reference's
``repro.launch.dryrun`` cell (XLA:CPU, ``.lower().compile()``), both on
the configuration cut to ``--layers`` layers at its production widths
and shapes, and one JSON line a mesh with the two packages' argument,
temporary and peak bytes a device, their FLOPs and collective bytes a
device (the reference's scaled by its ``trip_mult``) and the ratio of
the peaks::

    python tests/torch_dryrun_reference.py [--arch qwen3-8b]
        [--shape train_4k] [--layers 4] [--meshes 16x16 2x16x16]
        [--fake] [--breakdown N] [--out FILE]

With ``--breakdown N`` each line also holds the ``N`` largest parts of
both peaks: the port's live storages at its peak, by the operator that
made them and their shape, and the regions of the reference's temporary
allocation, each by its largest buffer (from XLA's buffer assignment).

The reference runs in an interpreter of its own (it sets ``XLA_FLAGS``
when imported), on a mesh of ``Auto`` axes: JAX 0.9's ``make_mesh``
defaults to ``Explicit`` ones, on which the reference's
``with_sharding_constraint`` raises.  Its numbers are counts of an XLA:CPU
program (``memory_analysis``, ``cost_analysis``, the HLO's collectives),
not times.  It needs ``jax``; CPU only.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
sys.path.insert(0, SRC)

#: the reference's cell, in its own interpreter: argv arch, shape,
#: multi_pod (0/1), layers; prints the report as one JSON line
_REFERENCE = "\n".join((
    "import json, sys",
    "import jax",
    "from jax.sharding import AxisType",
    "from repro.launch import dryrun as D",
    "import os",
    "if os.environ.get('REF_DUMP'):",
    "    os.environ['XLA_FLAGS'] += ' --xla_dump_to=' + "
    "os.environ['REF_DUMP']",
    "def mesh(*, multi_pod=False):",
    "    shape = (2, 16, 16) if multi_pod else (16, 16)",
    "    axes = ('pod', 'data', 'model') if multi_pod else ('data', 'model')",
    "    return jax.make_mesh(shape, axes,",
    "                         axis_types=(AxisType.Auto,) * len(shape))",
    "D.make_production_mesh = mesh",
    "arch, shape, mp, layers = sys.argv[1], sys.argv[2], sys.argv[3], "
    "int(sys.argv[4])",
    "if layers:",
    "    D.CONFIGS[arch] = D.CONFIGS[arch].scaled(n_layers=layers)",
    "print(json.dumps(D.run_cell(arch, shape, mp == '1', verbose=False)))",
))


def reference_cell(arch, shape, multi_pod, layers, dump=None):
    """The reference's report of the cell (a subprocess on XLA:CPU); with
    ``dump`` a directory, XLA dumps the compiled program there."""
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, arch, shape,
         "1" if multi_pod else "0", str(layers or 0)],
        capture_output=True, text=True, timeout=1800,
        env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                 **({"REF_DUMP": dump} if dump else {})))
    if out.returncode != 0:
        raise RuntimeError(f"reference dry run failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def port_cell(arch, shape, multi_pod, layers, tensors, parts=0):
    """The port's report of the cell (its own fake process group); with
    ``parts``, under ``"peak_parts"`` its ``parts`` largest groups of the
    storages live at the peak, ``[bytes, operator, shape, dtype]``."""
    from repro_torch.launch import dryrun as DR
    if not parts:
        return DR.run_cell(arch, shape, multi_pod, verbose=False,
                           tensors=tensors, n_layers=layers)
    made, at_peak = {}, []
    counter = DR._counter

    def watched():
        c = counter()
        base = type(c)

        class Watched(base):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                self.func = func
                return base.__torch_dispatch__(self, func, types, args,
                                               kwargs)

            def _track(self, out):
                peak = self.peak
                for t in out if isinstance(out, (tuple, list)) else (out,):
                    if type(t).__name__ == "Tensor":
                        st = t.untyped_storage()
                        # a freed storage's key may come back: label the
                        # storage that holds it now
                        if st._cdata not in self.storages:
                            made[st._cdata] = (
                                st.nbytes(), str(self.func), tuple(t.shape),
                                str(t.dtype))
                base._track(self, out)
                if self.peak > peak:
                    at_peak[:] = [made[k] for k in self.storages
                                  if k in made]
        c.__class__ = Watched
        return c
    DR._counter = watched
    try:
        rep = DR.run_cell(arch, shape, multi_pod, verbose=False,
                          tensors=tensors, n_layers=layers)
    finally:
        DR._counter = counter
    groups = {}
    for nbytes, *what in at_peak:
        groups[tuple(what)] = groups.get(tuple(what), 0) + nbytes
    rep["peak_parts"] = sorted(([b, f, list(sh), dt] for (f, sh, dt), b
                                in groups.items()), reverse=True)[:parts]
    return rep


def reference_parts(dump, parts):
    """The ``parts`` largest regions of the reference's temporary
    allocation (XLA's buffer assignment in ``dump``), each by the largest
    buffer that starts it: ``[bytes, offset, buffer, shape]``."""
    import glob
    import re
    path, = glob.glob(os.path.join(
        dump, "*after_optimizations-buffer-assignment.txt"))
    values, temp = [], False
    with open(path) as f:
        for line in f:
            if line.startswith("allocation "):
                temp = "preallocated-temp" in line
                continue
            m = temp and re.search(r"value: <\d+ (\S+) @\d+> \(size=(\d+),"
                                   r"offset=(\d+)\): (\S+)", line)
            if m:
                values.append((int(m[3]), int(m[2]), m[1], m[4]))
    regions, end = [], -1
    for off, size, name, shape in sorted(values, key=lambda v: (v[0],
                                                                -v[1])):
        if off >= end:
            regions.append([off, size, name, shape])
        elif off + size > end:
            regions[-1][1] = off + size - regions[-1][0]
        end = max(end, off + size)
    return sorted(([size, off, name, shape] for off, size, name, shape
                   in regions), reverse=True)[:parts]


def row(port, ref, fake=None):
    """One mesh's line: both packages' bytes, FLOPs and collectives."""
    out = {"arch": port["arch"], "shape": port["shape"],
           "mesh": port["mesh"], "port": {
               "per_device": port["per_device"],
               "flops_per_device": port["hlo_flops_per_device"],
               "collective_bytes_per_device":
               port["collective_bytes_per_device"],
               "compile_s": port["compile_s"]}}
    if fake is not None:
        out["port_fake"] = {"per_device": fake["per_device"],
                            "flops_per_device":
                            fake["hlo_flops_per_device"],
                            "collective_bytes_per_device":
                            fake["collective_bytes_per_device"]}
    mult = ref["trip_mult"]
    out["reference"] = {
        "per_device": ref["per_device"],
        "flops_per_device": ref["hlo_flops_per_device"],
        "collective_bytes_per_device": {
            k: v * mult
            for k, v in ref["collective_bytes_per_device"].items()},
        "trip_mult": mult}
    out["peak_ratio"] = (port["per_device"]["peak_bytes"] /
                         ref["per_device"]["peak_bytes"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--layers", type=int, default=4,
                    help="layers of the cut configuration (0: all)")
    ap.add_argument("--meshes", nargs="+", default=["16x16", "2x16x16"],
                    choices=["16x16", "2x16x16"])
    ap.add_argument("--fake", action="store_true",
                    help="also run the port's cell on fake tensors")
    ap.add_argument("--breakdown", type=int, default=0, metavar="N",
                    help="the N largest parts of both peaks")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = []
    for mesh in args.meshes:
        mp = mesh == "2x16x16"
        port = port_cell(args.arch, args.shape, mp, args.layers, "meta",
                         args.breakdown)
        fake = port_cell(args.arch, args.shape, mp, args.layers,
                         "fake") if args.fake else None
        with tempfile.TemporaryDirectory() as dump:
            ref = reference_cell(args.arch, args.shape, mp, args.layers,
                                 dump if args.breakdown else None)
            rows.append(row(port, ref, fake))
            if args.breakdown:
                rows[-1]["port"]["peak_parts"] = port["peak_parts"]
                rows[-1]["reference"]["temp_parts"] = reference_parts(
                    dump, args.breakdown)
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
