"""Server assembly of one node: holder, executor, handler and the HTTP
listener (ref: server.go:55-234; counterpart of the single-node part of
pilosa_tpu/server/server.py).

``Server(data_dir).open()`` opens the data directory on the GPU and
serves Pilosa's public HTTP API on a thread; ``close()`` stops the
listener, then closes the holder, which releases the directory's lock.
It runs on the CPU only when the caller passes ``device="cpu"``.
``host_bytes`` bounds the host memory of resident fragments (the
holder's governor; None reads ``PILOSA_TPU_HOST_BYTES``, unset is
unbounded).

``ingest`` is the ``[ingest]`` table (ref: pilosa_tpu server.py:470-495):
``enabled`` (default on; ``PILOSA_INGEST_ENABLED``) and
``max-batch-bits`` (default 8,000,000; ``PILOSA_INGEST_MAX_BATCH_BITS``).
Disabled, ``POST /index/{i}/ingest`` answers 501.
"""
import os
import threading

from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.ingest.pipeline import (
    DEFAULT_MAX_BATCH_BITS,
    IngestPipeline,
)
from pilosa_tpu_torch.server.handler import (
    DEFAULT_MAX_BODY_SIZE,
    Handler,
    make_http_server,
)
from pilosa_tpu_torch.storage.holder import Holder


class Server:
    def __init__(self, data_dir, bind="localhost:10101", device="cuda",
                 max_body_size=DEFAULT_MAX_BODY_SIZE, host_bytes=None,
                 ingest=None):
        self.data_dir = data_dir
        self.bind = bind
        self.host = bind  # host:port once open; the bound port for port 0
        self.scheme = "http"
        self.max_body_size = max_body_size
        # Raises without a GPU unless device="cpu".
        self.holder = Holder(data_dir, device=device,
                             host_bytes=host_bytes or None)
        self.ingest = _ingest_pipeline(self.holder, ingest)
        self.executor = None
        self.handler = None
        self._httpd = None
        self._thread = None

    def open(self):
        self.holder.open()
        try:
            self.executor = Executor(self.holder)
            self.handler = Handler(self.holder, self.executor,
                                   ingest=self.ingest)
            self.handler.enable_response_cache()
            self._httpd = make_http_server(self.handler, self.bind,
                                           self.max_body_size)
        except BaseException:
            self.holder.close()
            raise
        port = self._httpd.server_address[1]
        self.host = f"{self.bind.rsplit(':', 1)[0]}:{port}"
        self.handler.local_host = self.host
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="http-serve")
        self._thread.start()
        return self

    def close(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join()
            self._httpd = None
        self.holder.close()


def _ingest_pipeline(holder, cfg):
    """The IngestPipeline the ``[ingest]`` table and its environment
    variables ask for, or None when disabled."""
    cfg = {k.replace("_", "-"): v for k, v in (cfg or {}).items()}
    enabled = cfg.get("enabled")
    if enabled is None:
        env = os.environ.get("PILOSA_INGEST_ENABLED")
        enabled = env.lower() in ("1", "true", "yes") if env else True
    if not enabled:
        return None
    max_bits = cfg.get("max-batch-bits")
    if max_bits is None:
        env = os.environ.get("PILOSA_INGEST_MAX_BATCH_BITS")
        if env:
            try:
                max_bits = int(env)
            except ValueError:
                pass
    return IngestPipeline(holder,
                          max_batch_bits=max_bits or DEFAULT_MAX_BATCH_BITS)
