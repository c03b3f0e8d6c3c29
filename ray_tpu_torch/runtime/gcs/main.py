"""GCS server process entrypoint (gcs_server_main.cc analog)."""

import argparse
import asyncio
import logging
import os


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--ready-file", default=None)
    parser.add_argument("--storage", default=None,
                        help="sqlite file for durable GCS state (FT mode)")
    args = parser.parse_args()

    from ray_tpu_torch.utils.debug import register_stack_dump_signal

    register_stack_dump_signal()
    logging.basicConfig(
        level=os.environ.get("RAY_TPU_TORCH_LOG_LEVEL", "INFO"),
        format="[gcs %(asctime)s %(levelname)s %(name)s] %(message)s")

    from ray_tpu_torch.runtime.gcs.server import GcsServer

    async def run():
        gcs = GcsServer(args.host, args.port, storage_path=args.storage)
        await gcs.start()
        if args.ready_file:
            tmp = args.ready_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{gcs.server.host}:{gcs.server.port}")
            os.replace(tmp, args.ready_file)
        await gcs.wait_for_shutdown()

    asyncio.run(run())


if __name__ == "__main__":
    main()
