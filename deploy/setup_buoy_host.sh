#!/usr/bin/env bash
# Provision a dongle host (Pi-class edge box) for radio-mapper-tpu.
#
# This deployment splits the reference's buoy differently
# (`/root/reference/setup_pi.sh:120-136` installs the whole Python stack on
# the Pi): here the edge host stays DUMB — it owns the RTL-SDR dongle and
# runs the stock `rtl_tcp` server plus an autossh reverse tunnel to the
# compute host (the reference's tunnel pattern,
# `/root/reference/infra/radio-mapper-tunnel.service:8-16`); all DSP
# (detection, GCC, solve) runs on the compute host's buoy runtime pointed at
# the tunneled stream:
#
#   python -m radio_mapper_tpu buoy --source rtl_tcp \
#       --rtl-tcp 127.0.0.1:<remote_port> --central ws://central:8081
#
# Usage (on the edge host, as a sudoer):
#   ./setup_buoy_host.sh <buoy-id> <compute-host> <remote-port> [sample-rate]
set -euo pipefail

BUOY_ID=${1:?usage: setup_buoy_host.sh <buoy-id> <compute-host> <remote-port> [sample-rate]}
COMPUTE_HOST=${2:?compute host required}
REMOTE_PORT=${3:?remote port required}
SAMPLE_RATE=${4:-2048000}
RTL_PORT=1234

echo "==> provisioning buoy host '${BUOY_ID}' -> ${COMPUTE_HOST}:${REMOTE_PORT}"

# 1. stock rtl-sdr tools (provides rtl_tcp, rtl_test) + autossh
if command -v apt-get >/dev/null; then
  sudo apt-get update -qq
  sudo apt-get install -y -qq rtl-sdr autossh
fi

# 2. udev: non-root dongle access (reference setup_pi.sh blacklists DVB)
sudo tee /etc/modprobe.d/blacklist-rtl.conf >/dev/null <<'EOF'
blacklist dvb_usb_rtl28xxu
blacklist rtl2832
blacklist rtl2830
EOF

# 3. rtl_tcp as a service, bound to loopback (the tunnel is the transport)
sudo tee /etc/systemd/system/radio-mapper-rtltcp.service >/dev/null <<EOF
[Unit]
Description=radio-mapper edge rtl_tcp (${BUOY_ID})
After=network.target

[Service]
ExecStart=/usr/bin/rtl_tcp -a 127.0.0.1 -p ${RTL_PORT} -s ${SAMPLE_RATE}
Restart=always
RestartSec=5

[Install]
WantedBy=multi-user.target
EOF

# 4. reverse tunnel: expose this host's rtl_tcp on the compute host
#    (compute host reaches the dongle at 127.0.0.1:${REMOTE_PORT})
sudo tee /etc/systemd/system/radio-mapper-tunnel.service >/dev/null <<EOF
[Unit]
Description=radio-mapper reverse tunnel (${BUOY_ID})
After=network-online.target radio-mapper-rtltcp.service

[Service]
Environment=AUTOSSH_GATETIME=0
ExecStart=/usr/bin/autossh -M 0 -N \\
  -o ServerAliveInterval=30 -o ServerAliveCountMax=3 \\
  -o ExitOnForwardFailure=yes \\
  -R ${REMOTE_PORT}:127.0.0.1:${RTL_PORT} ${COMPUTE_HOST}
Restart=always
RestartSec=10

[Install]
WantedBy=multi-user.target
EOF

sudo systemctl daemon-reload
sudo systemctl enable --now radio-mapper-rtltcp.service radio-mapper-tunnel.service

echo "✅ edge host ready."
echo "On the compute host, start the buoy runtime against the tunnel:"
echo "  python -m radio_mapper_tpu buoy --id ${BUOY_ID} --source rtl_tcp \\"
echo "      --rtl-tcp 127.0.0.1:${REMOTE_PORT} --central ws://<central>:8081"
