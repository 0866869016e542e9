"""OpenMetrics rendering (port of the render half of
``mlcomp_tpu/telemetry/export.py``): family dicts → the wire text that
``GET /metrics`` on a serving process returns."""

#: the content type Prometheus negotiates for OpenMetrics 1.0
OPENMETRICS_CONTENT_TYPE = \
    'application/openmetrics-text; version=1.0.0; charset=utf-8'


def _escape_label(value) -> str:
    return str(value).replace('\\', r'\\').replace('"', r'\"') \
        .replace('\n', r'\n')


def _format_value(value) -> str:
    if value is None:
        return 'NaN'
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def family(name, mtype, help_text, samples=None):
    """One metric family. ``samples``: ``[(suffix, labels, value)]`` —
    suffix '' for plain gauges, '_total'/'_bucket'/'_count'/'_sum' for
    counter/histogram/summary parts."""
    return {'name': name, 'type': mtype, 'help': help_text,
            'samples': list(samples or [])}


def render_openmetrics(families) -> str:
    out = []
    for fam in families:
        name = fam['name']
        out.append(f'# TYPE {name} {fam["type"]}')
        if fam.get('help'):
            out.append(f'# HELP {name} {fam["help"]}')
        for suffix, labels, value in fam['samples']:
            label_str = ''
            if labels:
                inner = ','.join(
                    f'{k}="{_escape_label(v)}"'
                    for k, v in labels.items())
                label_str = '{' + inner + '}'
            out.append(
                f'{name}{suffix}{label_str} {_format_value(value)}')
    out.append('# EOF')
    return '\n'.join(out) + '\n'


__all__ = ['OPENMETRICS_CONTENT_TYPE', 'family', 'render_openmetrics']
