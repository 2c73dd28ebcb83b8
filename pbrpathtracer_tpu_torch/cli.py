"""Command-line interface, as ``pbrpathtracer_tpu.cli``: the headless
replacement for the reference's app shell (a .pts argument, render control,
PNG export).

    python -m pbrpathtracer_tpu_torch render scene.pts -o out.png --spp 64
    python -m pbrpathtracer_tpu_torch render --builtin cornell --spp 32
    python -m pbrpathtracer_tpu_torch info scene.pts
    python -m pbrpathtracer_tpu_torch fit --builtin cornell --steps 50
    python -m pbrpathtracer_tpu_torch bench

``render`` and ``fit`` run on ``--device`` (default ``cuda``, with torch's
own error where there is no card; ``--device cpu`` asks for the CPU). On
the card ``render`` replays its samples from CUDA graphs captured at the
second one (``api.render``; the time printed includes that capture).
``bench`` measures the card and has no CPU mode (``bench.py``).
"""

from __future__ import annotations

import argparse
import json
import time

EPILOG = ("The JAX package's --intersector is gone with its config field: "
          "the port picks the dense kernel for scenes of at most 2048 "
          "triangles and the BVH kernel beyond.")


def _add_render_args(p):
    p.add_argument("scene", nargs="?", help=".pts or .obj path")
    p.add_argument("--builtin", choices=["cornell", "cornell-spheres",
                                         "translucent"],
                   help="procedural test scene instead of a file")
    p.add_argument("-o", "--out", default=".",
                   help="output PNG path or directory (auto-name)")
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to build the scene and render on "
                        "(default: cuda)")
    p.add_argument("--aspect", type=float, default=None,
                   help="viewport aspect ratio for .pts scenes with autoRes "
                        "(keeps the stored pixel budget, matches this "
                        "aspect)")
    p.add_argument("--auto-segments", action="store_true",
                   help="size the wavefront segment cap from the scene's "
                        "Russian-roulette survival statistics (bounds the "
                        "bias of cut specular chains below 1e-3; see "
                        "engine.config.suggest_max_segments)")


def _builtin_scene(name, device):
    from .scene import builders
    from .scene.scene import Camera
    scene = {"cornell": builders.cornell_box,
             "cornell-spheres": builders.cornell_spheres_scene,
             "translucent": builders.translucent_scene}[name](device=device)
    camera = Camera.make(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1),
                         up=(0, 1, 0), fovy=61).to(device)
    return scene, camera


def _load_any(args):
    from .engine.config import RenderConfig

    def config(width, height, depth):
        return RenderConfig(width=args.width or width,
                            height=args.height or height,
                            max_depth=args.depth or depth,
                            spp=args.spp, seed=args.seed)
    if args.builtin:
        return (*_builtin_scene(args.builtin, args.device),
                config(512, 512, 3))
    if not args.scene:
        raise SystemExit("error: give a scene file or --builtin")
    if args.scene.endswith(".pts"):
        from .scene.pts import load_pts
        editor, settings = load_pts(args.scene)
        if settings["missing_objects"]:
            raise SystemExit(
                f"error: missing OBJ assets: {settings['missing_objects']}")
        width, height = settings["width"], settings["height"]
        # autoRes: the resolution follows the viewport. Headless: keep the
        # stored pixel budget, match --aspect.
        if settings["auto_res"] and args.aspect \
                and not (args.width or args.height):
            from .utils.observability import auto_resolution
            width, height = auto_resolution(width, height, args.aspect)
        cfg = config(width, height, settings["trace_depth"])
    else:
        # bare OBJ: default material, the editor's default camera
        from .scene.editor import EditorScene
        editor = EditorScene()
        if not editor.load_object(args.scene):
            raise SystemExit(f"error: cannot load {args.scene}")
        cfg = config(512, 512, 3)
    return (editor.build_scene(device=args.device),
            editor.tracer_camera(device=args.device), cfg)


def cmd_render(args):
    from .api import export_png, render
    scene, camera, cfg = _load_any(args)
    if args.auto_segments:
        cfg = cfg.with_auto_segments(scene)
    if scene.device.type == "cuda":     # the scene's upload is not the render
        import torch
        torch.cuda.synchronize(scene.device)
    t0 = time.time()
    img = render(scene, camera, cfg).cpu().numpy()
    dt = time.time() - t0
    path = export_png(args.out, img)
    n_paths = cfg.width * cfg.height * cfg.spp
    print(f"rendered {cfg.width}x{cfg.height}@{cfg.spp}spp depth "
          f"{cfg.max_depth} on {scene.device} in {dt:.2f}s "
          f"({n_paths/dt/1e6:.2f}M paths/s) -> {path}")


def cmd_info(args):
    from .scene.pts import load_pts
    editor, settings = load_pts(args.scene, load_objects=not args.no_assets)
    info = {
        "trace_depth": settings["trace_depth"],
        "resolution": [settings["width"], settings["height"]],
        "auto_res": settings["auto_res"],
        "missing_objects": settings["missing_objects"],
        "camera": {
            "position": [float(x) for x in editor.cam_pos],
            "rotation": [float(x) for x in editor.cam_rot],
            "focal_dist": editor.cam_focal_dist,
            "f_number": editor.cam_f,
        },
        "objects": [{
            "name": o.name, "file": o.filename,
            "location": list(o.location), "rotation": list(o.rotation),
            "scale": list(o.scale),
            "elements": [{
                "name": e.name,
                "type": ["OPAQUE", "TRANSLUCENT"][e.material.mat_type],
                "textures": {k: p for k, p in zip(
                    ("diffuse", "normal", "emissive", "roughness",
                     "metallic", "opacity"), e.texture_paths) if p},
            } for e in o.elements],
        } for o in editor.objects],
    }
    if not args.no_assets:
        info["triangles"] = editor.triangle_count()
    print(json.dumps(info, indent=2))


def cmd_fit(args):
    import numpy as np
    import torch
    from .api import fit, render
    scene, camera, cfg = _load_any(args)
    if args.target:
        from .scene.texture_io import read_image_rgba
        target = torch.from_numpy(
            read_image_rgba(args.target)[..., :3].astype(np.float32) / 255.0)
    else:
        print("no --target: self-calibration demo (fit to own render)")
        target = render(scene, camera, cfg)
    res = fit(scene, camera, cfg, target, steps=args.steps, lr=args.lr,
              materials=True, camera_lens=args.fit_camera,
              callback=lambda s, l, p: print(f"step {s}: loss {l:.6f}")
              if s % 10 == 0 else None)
    print(f"final loss: {res.losses[-1]:.6f}")
    if args.save_params:
        np.savez(args.save_params,
                 **{k: v.cpu().numpy() for k, v in res.params.items()})
        print(f"saved fitted params -> {args.save_params}")


def cmd_bench(args):
    from .bench import main as bench_main
    bench_main()


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="pbrpathtracer_tpu_torch",
        description="Differentiable PBR path tracer, PyTorch + CUDA",
        epilog=EPILOG)
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render a scene to PNG", epilog=EPILOG)
    _add_render_args(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("info", help="inspect a .pts scene file")
    p.add_argument("scene")
    p.add_argument("--no-assets", action="store_true",
                   help="don't load the OBJ files")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("fit", help="inverse-rendering fit", epilog=EPILOG)
    _add_render_args(p)
    p.add_argument("--target", help="target image (default: self-render)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=2e-2)
    p.add_argument("--fit-camera", action="store_true")
    p.add_argument("--save-params")
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("bench", help="measure rays/s fwd+bwd on the card "
                                     "(one JSON line)")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
