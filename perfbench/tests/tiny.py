"""A tiny copy of each cell for runs on the CPU: the same code paths at
a width and size a test can hold (ngf 16, 2 blocks a scale, ndf 4, HR
requests of 64 x 48 in batches of 2, training batches of 3 at gt 64)."""
import copy

from perfbench.harness import bench

TINY_NET = {'ngf': 16, 'n_blocks': 2}


def tiny_cell(workload, root=bench.CHECKOUT):
    cell = copy.deepcopy(bench.load_cell(workload, root=root))
    cfg, tr = cell['config'], cell['traffic']
    cfg['network_g'].update(TINY_NET)
    if 'network_d' in cfg:
        cfg['network_d']['ndf'] = 4
    if tr['driver'] == 'serve':
        tr.update(sizes=[[64, 48]], pool=2, batch=2,
                  sample={'batches': 1, 'images': 2})
    else:
        tr.update(batch=3, gt_size=64, pool=3)
    return cell
