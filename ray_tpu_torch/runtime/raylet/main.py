"""Raylet process entrypoint (src/ray/raylet/main.cc analog)."""

import argparse
import asyncio
import json
import logging
import os


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--resources", default="{}")
    parser.add_argument("--labels", default="{}")
    parser.add_argument("--object-store-memory", type=int,
                        default=2 << 30)
    parser.add_argument("--is-head", action="store_true")
    parser.add_argument("--ready-file", default=None)
    parser.add_argument("--worker-env", default="{}")
    args = parser.parse_args()

    from ray_tpu_torch.utils.debug import register_stack_dump_signal

    register_stack_dump_signal()
    logging.basicConfig(
        level=os.environ.get("RAY_TPU_TORCH_LOG_LEVEL", "INFO"),
        format="[raylet %(asctime)s %(levelname)s %(name)s] %(message)s")

    from ray_tpu_torch.runtime.raylet.raylet import Raylet

    host, port = args.gcs_address.rsplit(":", 1)

    async def run():
        import signal

        raylet = Raylet(
            gcs_address=(host, int(port)),
            session_dir=args.session_dir,
            resources=json.loads(args.resources),
            labels=json.loads(args.labels),
            object_store_memory=args.object_store_memory,
            is_head=args.is_head,
            worker_env=json.loads(args.worker_env),
        )
        await raylet.start()
        loop = asyncio.get_event_loop()
        loop.add_signal_handler(signal.SIGTERM, raylet._shutdown.set)
        loop.add_signal_handler(signal.SIGINT, raylet._shutdown.set)
        if args.ready_file:
            tmp = args.ready_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(json.dumps({
                    "node_id": raylet.node_id.hex(),
                    "address": list(raylet.server.address),
                    "store_path": raylet.store_path,
                }))
            os.replace(tmp, args.ready_file)
        await raylet.run_forever()

    asyncio.run(run())


if __name__ == "__main__":
    main()
