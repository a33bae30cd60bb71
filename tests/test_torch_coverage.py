"""The port is complete: every public top-level function and class of the
JAX package (``c2matching_tpu/``) is defined at the top level of some
module of the port (``c2matching_tpu_torch/``), as a function, a class
or an assigned name, unless it stands in ``JAX_ONLY`` with the reason the
port has no counterpart of that name. Both packages are read with
``ast``; neither is imported.
"""
import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

# JAX-only names: what takes their place in the port
JAX_ONLY = {
    'use_group_scan': "an XLA lowering switch; the port's plain versions "
                      'and kernels have none',
    'modulated_deform_conv_reference': "the port's plain versions "
                                       '(deform_im2col_plain, '
                                       'deform_conv_backward_plain)',
    'window_contract_pallas': "the Pallas kernel; the port's window_contract "
                              '/ window_conv launch kernel B2',
    'get_mesh': 'a jax.sharding mesh; the port runs one process a card in '
                'a torch.distributed process group (parallel/mesh.py)',
    'batch_sharding': 'a jax.sharding spec; each rank feeds its slice of '
                      'the batch',
    'replicated_sharding': 'a jax.sharding spec; parameters are broadcast '
                           'from rank 0 (broadcast_parameters)',
    'replicate': 'device_put over the mesh; broadcast_parameters',
    'enable_persistent_cache': "XLA's compilation cache",
    'torchvision_vgg_to_flax': 'pth_import: torch.load, and utils/weights.py '
                               'for the other direction',
    'import_torchvision_vgg': 'pth_import: torch.load',
    'import_contras_extractor': 'pth_import: torch.load',
    'import_corres_generation': 'pth_import: torch.load',
    'import_restoration_net': 'pth_import: torch.load',
    'import_discriminator': 'pth_import: torch.load',
    'Registry': 'the MODELS / ARCHS / DATASETS dicts',
    'define_net_g': 'define_network(opt["network_g"])',
    'define_net_d': 'define_network(opt["network_d"])',
    'define_net_map': 'define_network(opt["network_map"])',
    'define_net_extractor': 'define_network(opt["network_extractor"])',
    'define_net_student': 'define_network(opt["network_student"])',
    'define_net_teacher': 'define_network(opt["network_teacher"])',
    'cv2_bicubic_resize': "data/warp.py's resize_cubic",
    'shift_schedule_count': "ScheduleCounts.shift (the optax state's "
                            'count, a plain counter in the port)',
    **dict.fromkeys(('valid_mask', 'halve_valid', 'scale_valid'),
                    'the port runs each request at its exact shape; the '
                    "bucket bounded XLA's compiles"),
}


def _public_defs(root):
    """{name: [file:line, ...]} of the public top-level functions and
    classes of the package at ``root``."""
    out = {}
    for path in sorted((REPO / root).rglob('*.py')):
        for node in ast.parse(path.read_text()).body:
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef))
                    and not node.name.startswith('_')):
                out.setdefault(node.name, []).append(
                    f'{path.relative_to(REPO)}:{node.lineno}')
    return out


def _defined(root):
    """Every name a module of ``root`` binds at its top level."""
    names = set()
    for path in (REPO / root).rglob('*.py'):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names.update(t.id for t in node.targets
                             if isinstance(t, ast.Name))
    return names


@pytest.fixture(scope='module')
def packages():
    return _public_defs('c2matching_tpu'), _defined('c2matching_tpu_torch')


def test_every_public_name_is_ported(packages):
    jax_defs, port = packages
    missing = sorted(f'{where[0]}: {name}' for name, where in jax_defs.items()
                     if name not in port and name not in JAX_ONLY)
    assert not missing, 'not in the port: ' + ', '.join(missing)


def test_jax_only_names_are_current(packages):
    """Each JAX-only name still exists in the JAX package, and the port
    does not define it after all."""
    jax_defs, port = packages
    assert sorted(n for n in JAX_ONLY if n not in jax_defs) == []
    assert sorted(n for n in JAX_ONLY if n in port) == []
