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
"""
import threading

from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.server.handler import (
    DEFAULT_MAX_BODY_SIZE,
    Handler,
    make_http_server,
)
from pilosa_tpu_torch.storage.holder import Holder


class Server:
    def __init__(self, data_dir, bind="localhost:10101", device="cuda",
                 max_body_size=DEFAULT_MAX_BODY_SIZE, host_bytes=None):
        self.data_dir = data_dir
        self.bind = bind
        self.host = bind  # host:port once open; the bound port for port 0
        self.scheme = "http"
        self.max_body_size = max_body_size
        # Raises without a GPU unless device="cpu".
        self.holder = Holder(data_dir, device=device,
                             host_bytes=host_bytes or None)
        self.executor = None
        self.handler = None
        self._httpd = None
        self._thread = None

    def open(self):
        self.holder.open()
        try:
            self.executor = Executor(self.holder)
            self.handler = Handler(self.holder, self.executor)
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
