"""Minimal nvrpc-style unary echo service + clients
(the port of tpulab's ``examples/01_basic_grpc.py``; reference
examples/01_Basic_GRPC server.cpp / client.cpp / async_client.cc).

    python -m tpulab_torch.examples.ex01_basic_grpc server --port 50051
    python -m tpulab_torch.examples.ex01_basic_grpc client --port 50051
    python -m tpulab_torch.examples.ex01_basic_grpc async-client --port 50051
"""

import argparse

from tpulab_torch.rpc import (AsyncService, ClientExecutor, ClientUnary, Context,
                        Executor, Server)

SERVICE = "tpulab.examples.Echo"


class EchoContext(Context):
    def execute_rpc(self, request: bytes) -> bytes:
        return request  # echo


def run_server(port: int) -> None:
    server = Server(f"0.0.0.0:{port}", Executor(n_threads=2))
    svc = AsyncService(SERVICE)
    svc.register_rpc("Echo", EchoContext)
    server.register_async_service(svc)
    print(f"echo service on :{port}")
    server.run()


def run_client(port: int, n: int, async_mode: bool) -> None:
    with ClientExecutor(f"localhost:{port}") as cx:
        unary = ClientUnary(cx, f"/{SERVICE}/Echo")
        if async_mode:
            futs = [unary.start(f"msg-{i}".encode()) for i in range(n)]
            ok = sum(f.result(timeout=10) == f"msg-{i}".encode()
                     for i, f in enumerate(futs))
        else:
            ok = sum(unary.call(f"msg-{i}".encode(), timeout=10)
                     == f"msg-{i}".encode() for i in range(n))
        print(f"{ok}/{n} echoes verified")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["server", "client", "async-client"])
    ap.add_argument("--port", type=int, default=50051)
    ap.add_argument("-n", type=int, default=100)
    args = ap.parse_args()
    if args.mode == "server":
        run_server(args.port)
    else:
        run_client(args.port, args.n, args.mode == "async-client")
