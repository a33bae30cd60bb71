"""YAML option parsing with the reference's schema and semantics.

Counterpart of ``c2matching_tpu/utils/options.py`` (``parse``,
``dict2str``, ``NoneDict``, ``dict_to_nonedict``), with its own reader for
the YAML subset the option files use, since the card's machine has no
yaml package: block mappings nested by indentation, flow sequences of
scalars (``[0.9, 0.999]``, ``['relu1_1', ...]``), plain, single- and
double-quoted scalars, ``~``, the ``!!float`` tag and ``#`` comments.
Plain scalars resolve by PyYAML's YAML 1.1 rules, so ``1e-3`` without a
dot or the tag is a string. Anything else (block sequences, flow
mappings, anchors, other tags, block and multi-line scalars, document
markers) raises ``ValueError`` naming the line.
"""
import os
import os.path as osp
import re

_NULL = re.compile(r'^(?:~|null|Null|NULL|)$')
_BOOL = {v: True for v in ('yes', 'Yes', 'YES', 'true', 'True', 'TRUE',
                           'on', 'On', 'ON')}
_BOOL.update({v: False for v in ('no', 'No', 'NO', 'false', 'False',
                                 'FALSE', 'off', 'Off', 'OFF')})
_INT = re.compile(r'''^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$''', re.X)
_FLOAT = re.compile(r'''^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9_]+(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$''', re.X)
# what PyYAML would make a date or a merge key: refused, not guessed
_REFUSED_PLAIN = re.compile(r'^(?:[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=)$')
_ESCAPES = {'\\': '\\', '"': '"', '/': '/', 'n': '\n', 't': '\t',
            'r': '\r', '0': '\0', ' ': ' '}


class YAMLSubsetError(ValueError):
    """Input outside the YAML subset this reader accepts."""


def _sexagesimal(text, cast):
    value = 0
    for part in text.split(':'):
        value = value * 60 + cast(part)
    return value


def _to_int(text):
    text = text.replace('_', '')
    sign = -1 if text[0] == '-' else 1
    text = text.lstrip('+-')
    if text == '0':
        return 0
    if text.startswith('0b'):
        return sign * int(text[2:], 2)
    if text.startswith('0x'):
        return sign * int(text[2:], 16)
    if ':' in text:
        return sign * _sexagesimal(text, int)
    if text.startswith('0'):
        return sign * int(text, 8)
    return sign * int(text)


def _to_float(text):
    text = text.replace('_', '').lower()
    sign = -1.0 if text[0] == '-' else 1.0
    text = text.lstrip('+-')
    if text == '.inf':
        return sign * float('inf')
    if text == '.nan':
        return float('nan')
    if ':' in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def _plain(text, where):
    """Resolve a plain scalar as PyYAML's YAML 1.1 resolver does."""
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return _to_int(text)
    if _FLOAT.match(text):
        return _to_float(text)
    if _REFUSED_PLAIN.match(text):
        raise YAMLSubsetError(f'{where}: {text!r} would be a timestamp or a '
                              'merge key; quote it')
    return text


def _quoted(text, where):
    """(value, rest) of a quoted scalar at the start of ``text``."""
    quote = text[0]
    out = []
    i = 1
    while i < len(text):
        ch = text[i]
        if quote == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return ''.join(out), text[i + 1:]
        if quote == '"' and ch == '"':
            return ''.join(out), text[i + 1:]
        if quote == '"' and ch == '\\':
            esc = text[i + 1:i + 2]
            if esc not in _ESCAPES:
                raise YAMLSubsetError(f'{where}: escape \\{esc} is outside '
                                      'the supported subset')
            out.append(_ESCAPES[esc])
            i += 2
            continue
        out.append(ch)
        i += 1
    raise YAMLSubsetError(f'{where}: unterminated quoted scalar')


def _strip_comment(line):
    """The line without a trailing comment: '#' at the start or after
    whitespace, outside quotes."""
    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote:
            if ch == '\\' and quote == '"':
                i += 1
            elif ch == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif ch in '\'"' and (i == 0 or line[i - 1] in ' \t[,:'):
            quote = ch
        elif ch == '#' and (i == 0 or line[i - 1] in ' \t'):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _scalar(text, where, flow=False):
    """A scalar: quoted, tagged !!float, or plain."""
    text = text.strip()
    if text[:1] in ('"', "'"):
        value, rest = _quoted(text, where)
        if rest.strip():
            raise YAMLSubsetError(f'{where}: text after a quoted scalar: '
                                  f'{rest.strip()!r}')
        return value
    if text.startswith('!!float'):
        body = text[len('!!float'):]
        if body[:1] not in (' ', '\t') or not body.strip():
            raise YAMLSubsetError(f'{where}: !!float needs a value')
        body = body.strip()
        if body[:1] in ('"', "'"):
            body = _scalar(body, where)
        try:
            return _to_float(body)
        except ValueError:
            raise YAMLSubsetError(f'{where}: !!float {body!r} is not a '
                                  'number') from None
    if text[:1] in ('!', '&', '*', '|', '>', '{', '[', ']', '}', '@', '`',
                    '%') or (text.startswith('- ') or text == '-'):
        raise YAMLSubsetError(f'{where}: {text!r} is outside the supported '
                              'YAML subset')
    if ': ' in text or text.endswith(':') or (
            flow and any(c in text for c in ',[]{}')):
        raise YAMLSubsetError(f'{where}: plain scalar {text!r} is outside '
                              'the supported subset')
    return _plain(text, where)


def _flow_sequence(text, where):
    """A one-line flow sequence of scalars, '[a, b, ...]'."""
    if not text.endswith(']'):
        raise YAMLSubsetError(f'{where}: a flow sequence must close on its '
                              'line')
    body = text[1:-1]
    items = []
    while body.strip():
        body = body.lstrip()
        if body[0] in ('"', "'"):
            value, body = _quoted(body, where)
            items.append(value)
            body = body.lstrip()
        else:
            end = body.find(',')
            end = len(body) if end < 0 else end
            if body[0] == '[':
                raise YAMLSubsetError(f'{where}: nested flow sequences are '
                                      'outside the supported subset')
            items.append(_scalar(body[:end], where, flow=True))
            body = body[end:]
        if body and body[0] != ',':
            raise YAMLSubsetError(f'{where}: expected "," in flow sequence')
        body = body[1:]
    return items


def _value(text, where):
    text = text.strip()
    if text.startswith('['):
        return _flow_sequence(text, where)
    return _scalar(text, where)


def _split_key(text, where):
    """(key, rest after ':') of 'key: value' or 'key:'."""
    if text[:1] in ('"', "'"):
        key, rest = _quoted(text, where)
    else:
        m = re.match(r'^([^\s:#\[\]{},][^:]*?)\s*(:(?:\s|$).*)$', text)
        if m is None:
            raise YAMLSubsetError(f'{where}: expected "key: value", got '
                                  f'{text!r}')
        key, rest = _scalar(m.group(1), where), m.group(2)
    rest = rest.lstrip(' ')
    if not rest.startswith(':') or rest[1:2] not in ('', ' ', '\t'):
        raise YAMLSubsetError(f'{where}: expected ":" after the key')
    return key, rest[1:].strip()


def safe_load(text, name='<string>'):
    """Parse YAML text of the supported subset into dicts, lists and
    scalars, equal to ``yaml.safe_load`` on it. An empty document is
    None."""
    lines = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        where = f'{name}:{lineno}'
        line = _strip_comment(raw)
        if not line.strip():
            continue
        body = line.lstrip(' ')
        if body[0] == '\t' or '\t' in line[:len(line) - len(body)]:
            raise YAMLSubsetError(f'{where}: tab in indentation')
        if body.startswith(('---', '...', '%')):
            raise YAMLSubsetError(f'{where}: document markers and '
                                  'directives are outside the subset')
        lines.append((len(line) - len(body), body, where))
    if not lines:
        return None
    if lines[0][0] != 0:
        raise YAMLSubsetError(f'{lines[0][2]}: the document must start at '
                              'column 0')
    mapping, pos = _mapping(lines, 0, 0)
    if pos != len(lines):
        raise YAMLSubsetError(f'{lines[pos][2]}: unexpected indentation')
    return mapping


def _mapping(lines, pos, indent):
    """The block mapping whose keys sit at ``indent``, from lines[pos];
    returns (dict, index of the first line after it)."""
    out = {}
    while pos < len(lines):
        col, body, where = lines[pos]
        if col < indent:
            break
        if col > indent:
            raise YAMLSubsetError(f'{where}: unexpected indentation (a '
                                  'multi-line scalar or a misplaced key)')
        key, rest = _split_key(body, where)
        pos += 1
        if rest:
            out[key] = _value(rest, where)
        elif pos < len(lines) and lines[pos][0] > indent:
            out[key], pos = _mapping(lines, pos, lines[pos][0])
        else:
            out[key] = None
    return out, pos


def load(path):
    """``safe_load`` of a file."""
    with open(path, 'r') as f:
        return safe_load(f.read(), path)


def _repo_root():
    # <repo>/c2matching_tpu_torch/utils/options.py -> <repo>
    return osp.abspath(osp.join(osp.dirname(__file__), osp.pardir, osp.pardir))


def parse(opt_path, is_train=True):
    """Parse an option file into a plain dict (insertion-ordered).

    Injects ``is_train``, defaults ``crop_border`` to ``scale``, stamps each
    dataset block with ``phase``/``scale`` (phase = key prefix before '_', so
    ``test_1`` -> ``test``), expands '~' in paths, and derives the experiment
    / results output tree from the repo root (or ``$C2MATCHING_ROOT``) and
    the experiment ``name``.
    """
    opt = load(opt_path)

    opt['is_train'] = is_train
    scale = opt.get('scale', 4)
    if opt.get('crop_border', None) is None:
        opt['crop_border'] = scale

    for phase_key, dataset in (opt.get('datasets') or {}).items():
        phase = phase_key.split('_')[0]
        dataset['phase'] = phase
        dataset['scale'] = scale
        for root_key in ('dataroot_gt', 'dataroot_lq', 'dataroot_in',
                         'dataroot_ref'):
            if dataset.get(root_key, None) is not None:
                dataset[root_key] = osp.expanduser(dataset[root_key])

    opt.setdefault('path', {})
    for key, path in list(opt['path'].items()):
        if path and key != 'strict_load' and isinstance(path, str):
            opt['path'][key] = osp.expanduser(path)
    # C2MATCHING_ROOT redirects the experiments/results output tree
    opt['path']['root'] = os.environ.get('C2MATCHING_ROOT') or _repo_root()

    if is_train:
        experiments_root = osp.join(opt['path']['root'], 'experiments',
                                    opt['name'])
        opt['path']['experiments_root'] = experiments_root
        opt['path']['models'] = osp.join(experiments_root, 'models')
        opt['path']['training_state'] = osp.join(experiments_root,
                                                 'training_state')
        opt['path']['log'] = experiments_root
        opt['path']['visualization'] = osp.join(experiments_root,
                                                'visualization')
        if 'debug' in opt['name']:
            opt.setdefault('val', {})['val_freq'] = 8
            opt.setdefault('logger', {})['print_freq'] = 1
            opt['logger']['save_checkpoint_freq'] = 8
    else:
        results_root = osp.join(opt['path']['root'], 'results', opt['name'])
        opt['path']['results_root'] = results_root
        opt['path']['log'] = results_root
        opt['path']['visualization'] = osp.join(results_root, 'visualization')

    return opt


def dict2str(opt, indent_level=1):
    """Pretty-print an option dict (reference log format)."""
    msg = ''
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += ' ' * (indent_level * 2) + k + ':[\n'
            msg += dict2str(v, indent_level + 1)
            msg += ' ' * (indent_level * 2) + ']\n'
        else:
            msg += ' ' * (indent_level * 2) + k + ': ' + str(v) + '\n'
    return msg


class NoneDict(dict):
    """dict returning None for missing keys (option default-by-omission)."""

    def __missing__(self, key):
        return None


def dict_to_nonedict(opt):
    """Recursively convert dicts to NoneDict (lists traversed too)."""
    if isinstance(opt, dict):
        return NoneDict(
            **{key: dict_to_nonedict(sub) for key, sub in opt.items()})
    elif isinstance(opt, list):
        return [dict_to_nonedict(sub) for sub in opt]
    return opt
