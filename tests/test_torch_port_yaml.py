"""The port's YAML (``mlcomp_tpu_torch/utils/io.py``, written without
PyYAML, which the card's machine lacks) against ``yaml.safe_load`` and
the JAX package's ``yaml_dump``: every config of the repository, the
report layouts the migration seeds, a round trip over generated config
dicts, YAML 1.1's scalar typing, and a refusal for each construct
outside the subset."""

import glob
import math
import os

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from mlcomp_tpu.db.migration import DEFAULT_LAYOUTS as JAX_LAYOUTS
from mlcomp_tpu.utils.io import yaml_dump as jax_yaml_dump
from mlcomp_tpu_torch.db.migration import DEFAULT_LAYOUTS
from mlcomp_tpu_torch.utils.io import YamlError, yaml_dump, yaml_load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(
    glob.glob(os.path.join(REPO, 'examples', '*', '*.yml'))
    + glob.glob(os.path.join(REPO, 'tests', 'configs', 'broken', '*.yml')))
IDS = [os.path.relpath(p, REPO) for p in CONFIGS]


def _same(a, b) -> bool:
    """Equal values of equal types, key order included, NaN equal to
    NaN."""
    if isinstance(a, float) and isinstance(b, float) and a != a:
        return b != b
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def _read(path):
    with open(path) as fh:
        return fh.read()


def test_the_corpus_is_there():
    assert len(CONFIGS) >= 20


@pytest.mark.parametrize('path', CONFIGS, ids=IDS)
def test_config_reads_as_pyyaml_reads_it(path):
    text = _read(path)
    assert _same(yaml_load(text), yaml.safe_load(text))


@pytest.mark.parametrize('path', CONFIGS, ids=IDS)
def test_dump_reads_back_by_both_readers(path):
    value = yaml.safe_load(_read(path))
    text = yaml_dump(value)
    assert _same(yaml.safe_load(text), value)
    assert _same(yaml_load(text), value)


@pytest.mark.parametrize('path', CONFIGS, ids=IDS)
def test_jax_dump_reads_back_by_the_port(path):
    value = yaml.safe_load(_read(path))
    assert _same(yaml_load(jax_yaml_dump(value)), value)


@pytest.mark.parametrize('name', sorted(DEFAULT_LAYOUTS))
def test_seeded_layouts(name):
    assert DEFAULT_LAYOUTS[name] == JAX_LAYOUTS[name]
    assert _same(yaml_load(DEFAULT_LAYOUTS[name]),
                 yaml.safe_load(JAX_LAYOUTS[name]))


def test_empty_and_comment_only_texts_read_as_empty_dicts():
    assert yaml_load('') == {} and yaml_load('# only\n\n') == {}
    assert yaml_load(None) == {}


# ---------------------------------------------------------- scalar typing
SCALARS = ['1e-3', '1.0e-3', '1e+3', '3.', '.5', '+5', '-0', '0', '017',
           '0o17', '0x1F', '0b101', '1_000', '1:30', '1:30.5', '.inf',
           '-.Inf', '.NaN', 'yes', 'No', 'ON', 'off', 'y', 'n', 'True',
           'false', '~', 'null', 'NULL', 'Null', 'nul', '-x', 'a:b',
           'http://host:8080/x', 'a#b', "it's", '09', '1.2.3', '0.1_0']


@pytest.mark.parametrize('text', SCALARS)
def test_plain_scalar_typing(text):
    doc = f'v: {text}\nl: [{text}]\n'
    assert _same(yaml_load(doc), yaml.safe_load(doc))


@pytest.mark.parametrize('text', [
    "'a: b'", "'it''s'", '"tab\\there"', '"\\u00e9\\x41\\\\"',
    "'a\n  b\n\n  c'", '"a\\\n  b"', '"x\n  \\ y"'])
def test_quoted_scalars(text):
    doc = f'v: {text}\n'
    assert _same(yaml_load(doc), yaml.safe_load(doc))


BLOCKS = [
    'a:\n- 1\n- b: 2\n  c: [3, {d: 4}]\n',
    'a:\n  - x\n  -\n    y: 1\n  - - 1\n    - 2\n',
    'a: {b: [1, 2,\n     3], c: {d: e}}  # trailing\n',
    '- a\n- - b\n  - c\n- {}\n- []\n',
    'a: plain text\n  continued here\n\n  and a new line\nb: 1\n',
    'k: v\n# comment\n\nk2:   # empty value\nk3: ""\n',
    '"quoted key": 1\n\'single\': [a, b]\n',
    'a: [x: 1, y]\n',
    'a: {b, c: }\n',
    '? "\\L"\n: \'\'\n',
    '? "a\\Pb"\n: x: 1\n  y:\n  - 1\n  - 2\n',
    'k:\n  ? "\\L"\n  : null\n  z: 2\n',
    '? "\\L"\n: \'long\n  text\'\nb: [1]\n',
    '- ? a\n  : b\n- ?\n    c\n  :\n    - 1\n',
    '? a\nb: 1\n',
]


@pytest.mark.parametrize('doc', BLOCKS, ids=range(len(BLOCKS)))
def test_block_and_flow_structures(doc):
    assert _same(yaml_load(doc), yaml.safe_load(doc))


# ------------------------------------------------------------ round trip
_text = st.text(st.characters(blacklist_categories=('Cs',),
                              min_codepoint=9, max_codepoint=0x2FFF),
                max_size=40)
_keys = st.text(st.characters(blacklist_categories=('Cs', 'Cc'),
                              max_codepoint=0x2FFF), min_size=1, max_size=30)
_scalars = st.one_of(
    _text, st.integers(-10 ** 12, 10 ** 12), st.booleans(), st.none(),
    st.floats(allow_nan=False), st.sampled_from(SCALARS))
_configs = st.recursive(
    _scalars,
    lambda inner: st.one_of(st.lists(inner, max_size=4),
                            st.dictionaries(_keys, inner, max_size=4)),
    max_leaves=20)


@settings(max_examples=150, deadline=None)
@given(st.dictionaries(_keys, _configs, min_size=1, max_size=5))
def test_round_trip_over_config_dicts(value):
    """The port's dump reads back to the value by both readers, and
    PyYAML's dump (the JAX package's stored text) by the port's."""
    text = yaml_dump(value)
    assert _same(yaml.safe_load(text), value)
    assert _same(yaml_load(text), value)
    pyyaml = yaml.safe_dump(value, default_flow_style=False,
                            sort_keys=False)
    assert _same(yaml_load(pyyaml), value)


def test_floats_dump_as_pyyaml_types_them():
    for v in (1e-5, 1e20, -0.0, math.inf, -math.inf, 0.1, 3.0):
        assert _same(yaml.safe_load(yaml_dump({'v': v})), {'v': v})
    assert math.isnan(yaml.safe_load(yaml_dump({'v': math.nan}))['v'])


def test_dump_refuses_what_yaml_safe_dump_refuses():
    with pytest.raises(TypeError, match='tuple'):
        yaml_dump({'a': (1, 2)})


# ------------------------------------------------------------ refusals
OUTSIDE = {
    'anchor': ('a: &x 1\n', 'anchors'),
    'alias': ('a: 1\nb: *x\n', 'aliases'),
    'tag': ('a: !!str 1\n', 'tags'),
    'block_literal': ('a: |\n  x\n', 'block scalars'),
    'block_folded': ('a: >\n  x\n', 'block scalars'),
    'documents': ('a: 1\n---\nb: 2\n', 'document markers'),
    'document_end': ('a: 1\n...\n', 'document markers'),
    'directive': ('%YAML 1.1\na: 1\n', 'directives'),
    'explicit_key': ('a: {? b: c}\n', 'explicit keys'),
    'merge_key': ('a: {b: 1}\n<<: {c: 2}\n', 'merge keys'),
    'timestamp': ('a: 2020-01-01\n', 'timestamp'),
    'tab_indent': ('a:\n\tb: 1\n', 'tabs'),
    'flow_anchor': ('a: [&x 1]\n', 'anchors'),
    'collection_key': ('{[a]: 1}\n', 'collection keys'),
}


@pytest.mark.parametrize('name', sorted(OUTSIDE))
def test_constructs_outside_the_subset_raise(name):
    text, construct = OUTSIDE[name]
    with pytest.raises(YamlError, match=construct):
        yaml_load(text)


@pytest.mark.parametrize('text', ['a: [1, 2\n', 'a: "open\n',
                                  'a: b: c\n', 'a:\n  b: 1\n c: 2\n'])
def test_malformed_yaml_raises(text):
    with pytest.raises(yaml.YAMLError):
        yaml.safe_load(text)
    with pytest.raises(YamlError):
        yaml_load(text)
