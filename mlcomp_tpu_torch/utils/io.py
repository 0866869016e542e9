"""YAML without PyYAML (port of ``mlcomp_tpu/utils/io.py``).

The card's machine has no PyYAML, yet every DAG config is YAML and the
DB stores ``dag.config``, ``task.additional_info`` and report layouts as
YAML text. ``yaml_load`` reads the subset that the repo's configs and
MLComp's own stored text use, to the values ``yaml.safe_load`` gives:

- block mappings and sequences (``key:`` followed by ``- item`` at the
  same column or deeper, ``- name: ...`` items holding mappings);
- flow ``{}`` and ``[]``, nested and spanning lines;
- plain, single- and double-quoted scalars, also spanning lines;
- comments and blank lines.

Plain scalars are typed by YAML 1.1's rules as PyYAML's resolver applies
them: ``true/false/yes/no/on/off`` (three casings), ``null``/``~``/empty,
ints (decimal, ``0x``, ``0b``, leading-0 octal, ``_`` separators, base
60) and floats only with a dot or ``.inf``/``.nan`` — ``1e-3`` stays a
string. Anything outside the subset raises ``YamlError`` naming the
construct (anchors, aliases, tags, block scalars ``|``/``>``, explicit
``?`` keys in flow collections, merge keys ``<<``, timestamps,
directives, document markers); it is never read as something else. A
block ``? key`` / ``: value`` pair, which PyYAML writes for a key that
holds a line break, is read.

``yaml_dump`` writes block style with keys in insertion order, the shape
of ``yaml.safe_dump(data, default_flow_style=False, sort_keys=False)``,
quoting every string that would read back as another type; it does not
fold long lines. Its text reads back, by either reader, to the same
value.
"""

import math
import re

_BOOL = re.compile(r'^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False'
                   r'|FALSE|on|On|ON|off|Off|OFF)$')
_FLOAT = re.compile(r'''^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$''', re.X)
_INT = re.compile(r'''^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$''', re.X)
_NULL = re.compile(r'^(?:~|null|Null|NULL|)$')
_TIMESTAMP = re.compile(r'''^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$''',
                        re.X)

#: characters that may not start a plain scalar -> the construct they open
_RESERVED_START = {
    '&': 'anchors (&)', '*': 'aliases (*)', '!': 'tags (!)',
    '|': 'block scalars (|)', '>': 'block scalars (>)',
    '%': 'directives (%)', '@': 'the reserved indicator @',
    '`': 'the reserved indicator `',
}

_ESCAPES = {'0': '\0', 'a': '\a', 'b': '\b', 't': '\t', '\t': '\t',
            'n': '\n', 'v': '\v', 'f': '\f', 'r': '\r', 'e': '\x1b',
            ' ': ' ', '"': '"', '/': '/', '\\': '\\', 'N': '\x85',
            '_': '\xa0', 'L': ' ', 'P': ' '}
_HEX_ESCAPES = {'x': 2, 'u': 4, 'U': 8}


class YamlError(ValueError):
    """Text outside the YAML subset this reader covers, or not YAML."""


def _sexagesimal(text, cast):
    sign = -1 if text.startswith('-') else 1
    if text[:1] in '+-':
        text = text[1:]
    value = 0
    for part in text.split(':'):
        value = value * 60 + cast(part)
    return sign * value


def resolve_plain(text: str):
    """The value of a plain scalar under YAML 1.1's implicit types."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ('yes', 'true', 'on')
    if _INT.match(text):
        v = text.replace('_', '')
        if ':' in v:
            return _sexagesimal(v, int)
        sign = -1 if v.startswith('-') else 1
        if v[:1] in '+-':
            v = v[1:]
        if v == '0':
            return 0
        if v.startswith('0b'):
            return sign * int(v[2:], 2)
        if v.startswith('0x'):
            return sign * int(v[2:], 16)
        if v.startswith('0'):
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace('_', '').lower()
        sign = -1.0 if v.startswith('-') else 1.0
        if v[:1] in '+-':
            v = v[1:]
        if v == '.inf':
            return sign * math.inf
        if v == '.nan':
            return math.nan
        if ':' in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if text == '<<':
        raise YamlError('merge keys (<<) are outside the YAML subset')
    if _TIMESTAMP.match(text):
        raise YamlError(f'timestamp scalars ({text!r}) are outside the '
                        f'YAML subset')
    return text


def _fold(lines, keep_escaped_breaks=False):
    """Join the lines of a multi-line flow scalar: a single line break
    reads as a space, each empty line as a newline; continuation lines
    lose their leading whitespace. In double quotes a break escaped by
    a trailing backslash joins with nothing."""
    if len(lines) == 1:
        return lines[0]
    out = lines[0].rstrip(' \t')
    pending = ''
    for n, raw in enumerate(lines[1:], 2):
        # the last line keeps the spaces before the closing quote
        line = raw.lstrip(' \t') if n == len(lines) \
            else raw.strip(' \t')
        if not line and n < len(lines):
            pending += '\n'
            continue
        trailing = len(out) - len(out.rstrip('\\'))
        if keep_escaped_breaks and trailing % 2:
            out = out[:-1] + pending + line
        else:
            out += (pending or ' ') + line
        pending = ''
    return out


def _unescape_double(body: str, where: str) -> str:
    out = []
    i = 0
    while i < len(body):
        c = body[i]
        if c != '\\':
            out.append(c)
            i += 1
            continue
        nxt = body[i + 1:i + 2]
        if nxt in _ESCAPES:
            out.append(_ESCAPES[nxt])
            i += 2
        elif nxt in _HEX_ESCAPES:
            n = _HEX_ESCAPES[nxt]
            digits = body[i + 2:i + 2 + n]
            if len(digits) != n or not all(
                    d in '0123456789abcdefABCDEF' for d in digits):
                raise YamlError(f'bad escape \\{nxt}{digits} {where}')
            out.append(chr(int(digits, 16)))
            i += 2 + n
        else:
            raise YamlError(f'unknown escape \\{nxt} {where}')
    return ''.join(out)


def _find_quote_end(text: str, start: int, quote: str):
    """Index of the closing quote of the scalar opened at ``start``, or
    None when it is not on this text."""
    i = start + 1
    while i < len(text):
        c = text[i]
        if quote == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                i += 2
                continue
            return i
        if quote == '"':
            if c == '\\':
                i += 2
                continue
            if c == '"':
                return i
        i += 1
    return None


def _quoted_value(raw_lines, quote, where):
    """Value of a quoted scalar given its lines (the first starts after
    the opening quote, the last ends before the closing one)."""
    if quote == "'":
        return _fold(raw_lines).replace("''", "'")
    return _unescape_double(_fold(raw_lines, keep_escaped_breaks=True),
                            where)


def _strip_comment(text: str) -> str:
    """``text`` without its trailing comment (a ``#`` at the start or
    after whitespace, outside quotes)."""
    quote = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote:
            if c == quote:
                if quote == "'" and text[i + 1:i + 2] == "'":
                    i += 2
                    continue
                quote = None
            elif quote == '"' and c == '\\':
                i += 2
                continue
        elif c == '#' and (i == 0 or text[i - 1] in ' \t'):
            return text[:i].rstrip(' \t')
        elif c in '\'"' and (i == 0 or text[i - 1] in ' \t[{,:'):
            quote = c
        i += 1
    return text.rstrip(' \t')


class _Flow:
    """Reader of one flow node (``[...]``, ``{...}`` or a scalar) from a
    text whose line breaks are kept."""

    def __init__(self, text, where):
        self.s = text
        self.p = 0
        self.where = where

    def error(self, message):
        return YamlError(f'{message} {self.where}')

    def skip(self):
        while self.p < len(self.s):
            c = self.s[self.p]
            if c in ' \t\n':
                self.p += 1
            elif c == '#' and (self.p == 0 or self.s[self.p - 1] in ' \t\n'):
                while self.p < len(self.s) and self.s[self.p] != '\n':
                    self.p += 1
            else:
                break

    def peek(self):
        return self.s[self.p] if self.p < len(self.s) else ''

    def node(self):
        self.skip()
        c = self.peek()
        if c == '[':
            return self.seq()
        if c == '{':
            return self.map()
        if c in ('"', "'"):
            return self.quoted()
        if c in _RESERVED_START:
            raise self.error(f'{_RESERVED_START[c]} are outside the YAML '
                             f'subset')
        if c == '?' and self.s[self.p + 1:self.p + 2] in ' \t\n':
            raise self.error('explicit keys (?) are outside the YAML subset')
        return self.plain()

    def quoted(self):
        quote = self.s[self.p]
        end = _find_quote_end(self.s, self.p, quote)
        if end is None:
            raise self.error('unterminated quoted scalar')
        body = self.s[self.p + 1:end]
        self.p = end + 1
        return _quoted_value(body.split('\n'), quote, self.where)

    def plain(self):
        start = self.p
        while self.p < len(self.s):
            c = self.s[self.p]
            nxt = self.s[self.p + 1:self.p + 2]
            if c in ',[]{}':
                break
            if c == ':' and (nxt == '' or nxt in ' \t\n,[]{}'):
                break
            if c == '#' and self.s[self.p - 1] in ' \t\n':
                break
            self.p += 1
        text = self.s[start:self.p]
        lines = text.split('\n')
        folded = _fold([ln.strip(' \t') for ln in lines]).strip(' \t')
        if not folded:
            return None
        return resolve_plain(folded)

    def _key(self, value):
        if isinstance(value, (dict, list)):
            raise self.error('collection keys are outside the YAML subset')
        return value

    def seq(self):
        self.p += 1
        out = []
        while True:
            self.skip()
            c = self.peek()
            if c == ']':
                self.p += 1
                return out
            if not c:
                raise self.error('unterminated flow sequence')
            item = self.node()
            self.skip()
            if self.peek() == ':':
                # a single-pair mapping inside a flow sequence
                self.p += 1
                self.skip()
                value = None if self.peek() in (',', ']') else self.node()
                item = {self._key(item): value}
                self.skip()
            out.append(item)
            c = self.peek()
            if c == ',':
                self.p += 1
            elif c != ']':
                raise self.error(f'expected , or ] in a flow sequence, '
                                 f'got {c!r}')

    def map(self):
        self.p += 1
        out = {}
        while True:
            self.skip()
            c = self.peek()
            if c == '}':
                self.p += 1
                return out
            if not c:
                raise self.error('unterminated flow mapping')
            key = self._key(self.node())
            self.skip()
            value = None
            if self.peek() == ':':
                self.p += 1
                self.skip()
                if self.peek() not in (',', '}'):
                    value = self.node()
                self.skip()
            out[key] = value
            c = self.peek()
            if c == ',':
                self.p += 1
            elif c != '}':
                raise self.error(f'expected , or }} in a flow mapping, '
                                 f'got {c!r}')


class _Block:
    """Reader of the block structure, line by line. ``self.lines`` holds
    ``[indent, text]`` pairs; a ``- `` item or a ``key: value`` pair is
    read by rewriting its line into a virtual one that starts where the
    nested content does."""

    def __init__(self, text):
        self.lines = []
        for n, raw in enumerate(text.replace('\r\n', '\n').split('\n'), 1):
            body = raw.lstrip(' ')
            indent = len(raw) - len(body)
            if body.startswith('\t') and body.strip():
                raise YamlError(f'tabs in indentation (line {n}) are '
                                f'outside the YAML subset')
            if indent == 0 and re.match(r'^(---|\.\.\.)(\s|$)', body):
                raise YamlError(f'document markers ({body[:3]}, line {n}) '
                                f'are outside the YAML subset: one '
                                f'document per text')
            if indent == 0 and body.startswith('%'):
                raise YamlError(f'directives (line {n}) are outside the '
                                f'YAML subset')
            self.lines.append([indent, body, n])
        self.i = 0

    def where(self):
        n = self.lines[min(self.i, len(self.lines) - 1)][2]
        return f'(line {n})'

    def error(self, message):
        return YamlError(f'{message} {self.where()}')

    def skip_blank(self):
        while self.i < len(self.lines) and \
                not _strip_comment(self.lines[self.i][1]):
            self.i += 1

    def document(self):
        value = self.node(-1)
        self.skip_blank()
        if self.i < len(self.lines):
            raise self.error('unexpected content after the document')
        return value

    @staticmethod
    def is_item(text):
        return text == '-' or text.startswith('- ') \
            or text.startswith('-\t')

    @staticmethod
    def is_explicit_key(text):
        """A ``? key`` line, as PyYAML writes a key that holds a line
        break (``\\L``, ``\\P``); its value follows on a ``: `` line."""
        return text[:1] == '?' and text[1:2] in ('', ' ', '\t')

    def split_key(self, text):
        """``(key, rest)`` when ``text`` is a ``key: value`` line, else
        None. ``rest`` keeps its comment."""
        if not text:
            return None
        c = text[0]
        if c in _RESERVED_START:
            raise self.error(f'{_RESERVED_START[c]} are outside the YAML '
                             f'subset')
        if c in '[{' or self.is_explicit_key(text):
            return None
        if c in '\'"':
            end = _find_quote_end(text, 0, c)
            if end is None:
                return None
            after = text[end + 1:]
            stripped = after.lstrip(' \t')
            if not stripped.startswith(':') or \
                    stripped[1:2] not in ('', ' ', '\t'):
                return None
            key = _quoted_value([text[1:end]], c, self.where())
            return key, stripped[1:]
        i = 0
        while i < len(text):
            ch = text[i]
            if ch == '#' and i > 0 and text[i - 1] in ' \t':
                return None
            if ch == ':' and text[i + 1:i + 2] in ('', ' ', '\t'):
                key_text = text[:i].rstrip(' \t')
                return resolve_plain(key_text), text[i + 1:]
            i += 1
        return None

    def node(self, parent):
        """The node whose lines are indented more than ``parent``; None
        (null) when there is none."""
        self.skip_blank()
        if self.i >= len(self.lines) or self.lines[self.i][0] <= parent:
            return None
        indent, text, _ = self.lines[self.i]
        if self.is_item(text):
            return self.seq(indent)
        if self.is_explicit_key(text) or self.split_key(text) is not None:
            return self.map(indent)
        return self.inline(parent)

    def indicated(self, indent):
        """The node after the one-character indicator (``?`` or ``:``)
        that starts the current line, at ``indent``: on the rest of the
        line, read as a line of its own, or on the lines below."""
        text = self.lines[self.i][1]
        rest = text[1:]
        body = rest.lstrip(' \t')
        if not _strip_comment(body):
            self.i += 1
        else:
            self.lines[self.i] = [indent + 1 + len(rest) - len(body), body,
                                  self.lines[self.i][2]]
        return self.node(indent)

    def seq(self, indent):
        out = []
        while True:
            self.skip_blank()
            if self.i >= len(self.lines):
                break
            ind, text, _ = self.lines[self.i]
            if ind < indent or (ind == indent and not self.is_item(text)):
                break
            if ind > indent or not self.is_item(text):
                raise self.error('bad indentation of a sequence item')
            rest = text[1:]
            body = rest.lstrip(' \t')
            if not _strip_comment(body):
                self.i += 1
                out.append(self.node(indent))
            else:
                self.lines[self.i] = [indent + 1 + len(rest) - len(body),
                                      body, self.lines[self.i][2]]
                out.append(self.node(indent))
        return out

    def map(self, indent):
        out = {}
        while True:
            self.skip_blank()
            if self.i >= len(self.lines):
                break
            ind, text, _ = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise self.error('bad indentation of a mapping entry')
            if self.is_item(text):
                break
            if self.is_explicit_key(text):
                key = self.indicated(indent)
                if isinstance(key, (dict, list)):
                    raise self.error('collection keys are outside the '
                                     'YAML subset')
                self.skip_blank()
                value = None
                if self.i < len(self.lines) and \
                        self.lines[self.i][0] == indent and \
                        self.lines[self.i][1][:1] == ':' and \
                        self.lines[self.i][1][1:2] in ('', ' ', '\t'):
                    value = self.indicated(indent)
                out[key] = value
                continue
            pair = self.split_key(text)
            if pair is None:
                raise self.error('expected a "key: value" line')
            key, rest = pair
            if isinstance(key, (dict, list)):
                raise self.error('collection keys are outside the YAML '
                                 'subset')
            body = rest.lstrip(' \t')
            if not _strip_comment(body):
                self.i += 1
                self.skip_blank()
                if self.i < len(self.lines) and \
                        self.lines[self.i][0] == indent and \
                        self.is_item(self.lines[self.i][1]):
                    value = self.seq(indent)    # "key:" then "- item"
                else:
                    value = self.node(indent)
            else:
                col = ind + len(text) - len(body)
                self.lines[self.i] = [col, body, self.lines[self.i][2]]
                if self.is_item(body) or self.is_explicit_key(body) or \
                        self.split_key(body) is not None:
                    raise self.error('a block collection cannot start on '
                                     'the line of its key')
                value = self.inline(indent)
            out[key] = value
        return out

    def inline(self, parent):
        """A scalar or flow collection starting on the current (possibly
        virtual) line; its continuation lines are indented more than
        ``parent``."""
        indent, text, _ = self.lines[self.i]
        where = self.where()
        c = text[0]
        if c in _RESERVED_START:
            raise self.error(f'{_RESERVED_START[c]} are outside the YAML '
                             f'subset')
        if c in '[{':
            return self.flow(parent)
        if c in '\'"':
            return self.quoted(parent, c)
        if c in ']},':
            raise self.error(f'a plain scalar cannot start with {c!r}')
        # plain scalar, possibly over several more-indented lines
        first = _strip_comment(text)
        parts = [first]
        ended = first != text.rstrip(' \t')     # a comment ends it
        self.i += 1
        while not ended and self.i < len(self.lines):
            ind, nxt, _ = self.lines[self.i]
            if not nxt.strip():
                parts.append('')
                self.i += 1
                continue
            if ind <= parent or nxt.startswith('#'):
                break
            body = _strip_comment(nxt)
            ended = body != nxt.rstrip(' \t')
            parts.append(body)
            self.i += 1
        while not parts[-1]:        # trailing blank lines are not part
            parts.pop()             # of the scalar: give them back
            self.i -= 1
        for part in parts:
            if re.search(r':(\s|$)', part):
                raise YamlError(f'mapping values are not allowed inside a '
                                f'plain scalar {where}')
        return resolve_plain(_fold(parts).strip(' \t'))

    def _gather(self, parent, done):
        """Raw lines from the current line on until ``done(text)`` says
        the construct is complete; returns the joined text and the
        rest of the last line."""
        collected = []
        while True:
            if self.i >= len(self.lines):
                raise self.error('unterminated flow collection or quoted '
                                 'scalar')
            ind, text, _ = self.lines[self.i]
            if collected and text.strip() and ind <= parent:
                raise self.error('continuation line not indented')
            collected.append(text)
            self.i += 1
            joined = '\n'.join(collected)
            end = done(joined)
            if end is not None:
                rest = joined[end:]
                if _strip_comment(rest.lstrip(' \t')):
                    raise YamlError(f'unexpected {rest.strip()!r} after a '
                                    f'flow node {self.where()}')
                return joined[:end]

    def flow(self, parent):
        where = self.where()

        def done(text):
            depth, p, quote = 0, 0, None
            while p < len(text):
                c = text[p]
                if quote:
                    if c == '\\' and quote == '"':
                        p += 2
                        continue
                    if c == quote:
                        if quote == "'" and text[p + 1:p + 2] == "'":
                            p += 2
                            continue
                        quote = None
                elif c == '#' and p > 0 and text[p - 1] in ' \t\n':
                    while p < len(text) and text[p] != '\n':
                        p += 1
                    continue
                elif c in '\'"' and text[p - 1:p] in ('', ' ', '\t', '\n',
                                                      '[', '{', ',', ':'):
                    quote = c
                elif c in '[{':
                    depth += 1
                elif c in ']}':
                    depth -= 1
                    if depth == 0:
                        return p + 1
                p += 1
            return None

        text = self._gather(parent, done)
        reader = _Flow(text, where)
        return reader.node()

    def quoted(self, parent, quote):
        where = self.where()
        text = self._gather(
            parent, lambda t: (lambda e: None if e is None else e + 1)(
                _find_quote_end(t, 0, quote)))
        return _quoted_value(text[1:-1].split('\n'), quote, where)


def yaml_load(text=None, file: str = None):
    """``yaml.safe_load`` of the subset; ``{}`` for an empty text."""
    if file is not None:
        with open(file) as fh:
            text = fh.read()
    if text is None:
        return {}
    res = _Block(text).document()
    return res if res is not None else {}


# ----------------------------------------------------------------- dump
_PLAIN_OK = re.compile(r'^[A-Za-z0-9_./(][A-Za-z0-9_./()+=\- ,:\'"]*$')


def _dump_str(s: str) -> str:
    if _PLAIN_OK.fullmatch(s) and s == s.strip(' ') and ': ' not in s \
            and not s.endswith(':') and ' #' not in s:
        try:
            plain = resolve_plain(s)
        except YamlError:
            plain = None
        if plain == s and isinstance(plain, str):
            return s
    if all(' ' <= c <= '~' for c in s):
        return "'" + s.replace("'", "''") + "'"
    out = []
    for c in s:
        if c == '\\':
            out.append('\\\\')
        elif c == '"':
            out.append('\\"')
        elif ' ' <= c <= '~':
            out.append(c)
        elif c in '\n\t\r\0':
            out.append({'\n': '\\n', '\t': '\\t', '\r': '\\r',
                        '\0': '\\0'}[c])
        elif ord(c) <= 0xff:
            out.append(f'\\x{ord(c):02X}')
        elif ord(c) <= 0xffff:
            out.append(f'\\u{ord(c):04X}')
        else:
            out.append(f'\\U{ord(c):08X}')
    return '"' + ''.join(out) + '"'


def _dump_scalar(v) -> str:
    if v is None:
        return 'null'
    if isinstance(v, bool):
        return 'true' if v else 'false'
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return '.nan'
        if v in (math.inf, -math.inf):
            return '.inf' if v > 0 else '-.inf'
        text = repr(v).lower()
        if '.' not in text and 'e' in text:
            text = text.replace('e', '.0e', 1)
        return text
    if isinstance(v, str):
        return _dump_str(v)
    if isinstance(v, dict) and not v:
        return '{}'
    if isinstance(v, list) and not v:
        return '[]'
    raise TypeError(f'yaml_dump: cannot represent {type(v).__name__} '
                    f'{v!r}')


def _dump_map(d: dict, indent: int, out: list):
    pad = ' ' * indent
    for k, v in d.items():
        if isinstance(k, (dict, list)):
            raise TypeError('yaml_dump: collection keys are not supported')
        key = _dump_scalar(k)
        if isinstance(v, dict) and v:
            out.append(f'{pad}{key}:')
            _dump_map(v, indent + 2, out)
        elif isinstance(v, list) and v:
            out.append(f'{pad}{key}:')
            _dump_seq(v, indent, out)
        else:
            out.append(f'{pad}{key}: {_dump_scalar(v)}')


def _dump_seq(items: list, indent: int, out: list):
    pad = ' ' * indent
    for v in items:
        if (isinstance(v, dict) or isinstance(v, list)) and v:
            nested = []
            if isinstance(v, dict):
                _dump_map(v, indent + 2, nested)
            else:
                _dump_seq(v, indent + 2, nested)
            nested[0] = pad + '- ' + nested[0][indent + 2:]
            out.extend(nested)
        else:
            out.append(f'{pad}- {_dump_scalar(v)}')


def yaml_dump(data, file: str = None) -> str:
    out = []
    if isinstance(data, dict) and data:
        _dump_map(data, 0, out)
    elif isinstance(data, list) and data:
        _dump_seq(data, 0, out)
    else:
        out.append(_dump_scalar(data))
    text = '\n'.join(out) + '\n'
    if file is not None:
        with open(file, 'w') as fh:
            fh.write(text)
    return text


__all__ = ['yaml_load', 'yaml_dump', 'resolve_plain', 'YamlError']
