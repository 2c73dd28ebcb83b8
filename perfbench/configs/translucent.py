"""Scene arrays of the ``translucent`` configuration: BASELINE config 4,
the program's ``scene.builders.translucent_scene()`` (the Cornell box's
walls and area light, without its two boxes, around a glass box: 24
triangles, the glass ``mat_type`` 1 with ior 1.5 and translucency 1),
frozen here in numpy so that the benchmark hands the same numbers to the
program and to its reference. The walls, the light and the helpers are
``cornell.py``'s. ``build(spec, seed)`` returns ``tris``, ``materials``
and ``textures`` (none)."""

from perfbench.configs.cornell import assemble, box, material, quad

TRANSLUCENT = 1


def build(spec, seed):
    """The glass box in the box; ``seed`` changes nothing in it."""
    white = (0.75, 0.75, 0.75)
    # cornell_box's six materials (its boxes' two unused here), then glass
    mats = [
        material(diffuse=white, specular=(0, 0, 0)),
        material(diffuse=(0.75, 0.25, 0.25), specular=(0, 0, 0)),
        material(diffuse=(0.25, 0.25, 0.75), specular=(0, 0, 0)),
        material(diffuse=(0.78, 0.78, 0.78), emissive=(1.0, 0.85, 0.6),
                 emissive_intensity=1.5, specular=(0, 0, 0)),
        material(diffuse=white, specular=(0, 0, 0)),
        material(diffuse=white, specular=(0, 0, 0)),
        material(mat_type=TRANSLUCENT, diffuse=(0.95, 0.95, 0.99),
                 specular=(1, 1, 1), roughness=0.0, reflectiveness=0.0,
                 translucency=1.0, ior=1.5),
    ]
    e = 0.995
    groups = [
        (quad((-1, -1, 0), (-1, -1, 4), (1, -1, 4), (1, -1, 0)), 0),
        (quad((-1, 1, 0), (1, 1, 0), (1, 1, 4), (-1, 1, 4)), 0),
        (quad((-1, -1, 4), (-1, 1, 4), (1, 1, 4), (1, -1, 4)), 0),
        (quad((-1, -1, 0), (-1, 1, 0), (-1, 1, 4), (-1, -1, 4)), 1),
        (quad((1, -1, 0), (1, -1, 4), (1, 1, 4), (1, 1, 0)), 2),
        (quad((-0.4, e, 1.8), (0.4, e, 1.8), (0.4, e, 2.6), (-0.4, e, 2.6)),
         3),
        (box((0.0, -0.45, 2.2), (0.8, 1.1, 0.5), rot_y=0.4), 6),
    ]
    return {"tris": assemble(groups), "materials": mats, "textures": []}
