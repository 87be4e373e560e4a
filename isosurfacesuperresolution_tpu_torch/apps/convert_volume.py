"""Volume conversion utility.

Counterpart of the JAX package's `apps/convert_volume.py`, the
reference's converter tooling (`-m convert` of `CPURenderer.cpp:357-407`,
.dat -> .vdb; `GPURenderer.cpp:406-448` and
`DataGenerator/ConvertVDBtoVBX.py`, .vdb -> .vbx).  The brick format here
is ``.cvol.npz`` (`volume/importers.py`).  Conversion reads .dat/RAW (the
native reader), dense .npy, or .vdb (the native from-spec decoder), and
writes .cvol.npz (optionally with the baked SH occlusion field, baked on
``--device``, the card by default) or .vdb (`volume/vdb_write.py`).

Usage:
  python -m isosurfacesuperresolution_tpu_torch.apps.convert_volume \\
      input.dat output.cvol.npz --downsample 2 --threshold 0.001
  python -m isosurfacesuperresolution_tpu_torch.apps.convert_volume \\
      input.dat output.vdb
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("input", help=".dat descriptor, .npy dense volume, "
                   "or .vdb")
    p.add_argument("output", help="output .cvol.npz or .vdb path")
    p.add_argument("--downsample", type=int, default=1)
    p.add_argument("--threshold", type=float, default=0.001,
                   help="zero values below this (sparsification)")
    p.add_argument("--brickSize", type=int, default=8)
    p.add_argument("--bakeAO", action="store_true",
                   help="also bake the SH occlusion field")
    p.add_argument("--isovalue", type=float, default=0.36)
    p.add_argument("--aoRadius", type=float, default=0.1)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from isosurfacesuperresolution_tpu_torch.device import resolve_device
    from isosurfacesuperresolution_tpu_torch.volume.importers import (
        import_npy, import_raw, save_cvol)

    dev = resolve_device(args.device)
    if args.input.endswith(".dat"):
        grid = import_raw(args.input, downsampling=args.downsample,
                          lower_threshold=args.threshold,
                          brick_size=args.brickSize, device=dev)
    elif args.input.endswith(".vdb"):
        from isosurfacesuperresolution_tpu_torch.volume.vdb import load_vdb
        grid, name = load_vdb(args.input, brick_size=args.brickSize,
                              device=dev)
        print(f"read grid {name!r} from {args.input}")
        if args.downsample > 1:
            raise SystemExit("--downsample only supported for .dat input")
    else:
        grid = import_npy(args.input, brick_size=args.brickSize,
                          lower_threshold=args.threshold, device=dev)
        if args.downsample > 1:
            raise SystemExit("--downsample only supported for .dat input")

    if args.output.endswith(".vdb"):
        from isosurfacesuperresolution_tpu_torch.volume.vdb_write import (
            write_vdb)
        dense = grid.dequant(grid.values).cpu().numpy()
        write_vdb(args.output, dense, grid_name="density")
        print(f"wrote {args.output}: resolution {grid.resolution}")
        return

    if args.bakeAO:
        from isosurfacesuperresolution_tpu_torch.render.ao_sweep import (
            attach_baked_ao)
        grid = attach_baked_ao(grid, args.isovalue, args.aoRadius)

    save_cvol(args.output, grid)
    print(f"wrote {args.output}: resolution {grid.resolution}, "
          f"brick {grid.brick_size}^3"
          + (", with baked AO" if args.bakeAO else ""))


if __name__ == "__main__":
    main()
