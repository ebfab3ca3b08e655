"""pilosa-tpu CLI of the PyTorch/CUDA port (ref: cmd/root.go:43-58).

Usage: python -m pilosa_tpu_torch.cli <command> [flags]
Commands: server, import, export.
"""
import sys

from pilosa_tpu_torch.cli import commands


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, args = argv[0], argv[1:]
    fn = {
        "server": commands.cmd_server,
        "import": commands.cmd_import,
        "export": commands.cmd_export,
    }.get(cmd)
    if fn is None:
        print(f"unknown command: {cmd}", file=sys.stderr)
        print(__doc__)
        return 1
    return fn(args)


if __name__ == "__main__":
    sys.exit(main())
