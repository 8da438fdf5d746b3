"""Typed argparse helpers of the port's CLIs, copied from
``sloika_tpu/cmdargs.py`` (paired --foo/--no-foo flags, bounded numbers,
optional values, named-tuple multi-args, file checks, byte strings)."""
import argparse
import os
from collections import namedtuple


class AutoBool(argparse.Action):
    """--foo / --no-foo paired flags (sloika_tpu/cmdargs.py:13)."""

    def __init__(self, option_strings, dest, default=None, required=False,
                 help=None):
        if default is None:
            raise ValueError("AutoBool requires a default")
        opts = []
        for opt in option_strings:
            if not opt.startswith('--'):
                raise ValueError("AutoBool only supports long flags")
            opts += [opt, '--no_' + opt[2:], '--no-' + opt[2:]]
        if help is not None:
            help += ' (default: {})'.format('enabled' if default
                                            else 'disabled')
        super().__init__(opts, dest, nargs=0, const=None, default=default,
                         required=required, help=help)

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest,
                not option_string.startswith(('--no_', '--no-')))


def Maybe(mytype):
    """Value of ``mytype``, or None when given 'None'
    (sloika_tpu/cmdargs.py:33)."""
    def converter(argument):
        if argument == 'None':
            return None
        return mytype(argument)
    converter.__name__ = 'maybe_{}'.format(getattr(mytype, '__name__', 'val'))
    return converter


def Bounded(mytype, lower=None, upper=None):
    """``mytype`` within [lower, upper] (sloika_tpu/cmdargs.py:43)."""
    def converter(argument):
        val = mytype(argument)
        if lower is not None and val < lower:
            raise argparse.ArgumentTypeError(
                '{} must be >= {}'.format(val, lower))
        if upper is not None and val > upper:
            raise argparse.ArgumentTypeError(
                '{} must be <= {}'.format(val, upper))
        return val
    converter.__name__ = 'bounded_{}'.format(
        getattr(mytype, '__name__', 'val'))
    return converter


def NonNegative(mytype):
    return Bounded(mytype, lower=mytype(0))


def Positive(mytype):
    """``mytype`` > 0 (sloika_tpu/cmdargs.py:61)."""
    def converter(argument):
        val = mytype(argument)
        if val <= 0:
            raise argparse.ArgumentTypeError('{} must be positive'.format(val))
        return val
    converter.__name__ = 'positive_{}'.format(
        getattr(mytype, '__name__', 'val'))
    return converter


def proportion(argument):
    """Float in [0, 1]."""
    return Bounded(float, 0.0, 1.0)(argument)


class FileExists(argparse.Action):
    """Refuse a path that does not exist (sloika_tpu/cmdargs.py:76)."""

    def __call__(self, parser, namespace, values, option_string=None):
        if not os.path.exists(values):
            raise RuntimeError("File/path for '{}' does not exist, {}".format(
                self.dest, values))
        setattr(namespace, self.dest, values)


class ParseToNamedTuple(argparse.Action):
    """Parse nargs values into a named tuple with typed fields
    (sloika_tpu/cmdargs.py:92), e.g. ``--adam rate decay1 decay2``."""

    def __init__(self, option_strings, dest, nargs=None, metavar=None,
                 default=None, type=None, required=False, help=None):
        if (nargs is None or metavar is None or type is None
                or not len(metavar) == len(type) == nargs):
            raise ValueError("ParseToNamedTuple needs nargs, metavar and "
                             "type of one length")
        self._types = type
        self.Values = namedtuple('Values', metavar)
        if default is not None:
            default = self.Values(*default)
        super().__init__(option_strings, dest, nargs=nargs, metavar=metavar,
                         default=default, required=required, help=help)

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest,
                self.Values(*[t(v) for t, v in zip(self._types, values)]))


def ByteString(argument):
    return argument.encode('utf-8')


def display_version_and_exit(version):
    """Action printing ``version`` and exiting
    (sloika_tpu/cmdargs.py:136)."""
    class _Action(argparse.Action):
        def __call__(self, parser, namespace, values, option_string=None):
            print(version)
            raise SystemExit(0)
    return _Action
