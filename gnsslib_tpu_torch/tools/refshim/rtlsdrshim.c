/* librtlsdr + convenience stubs for the reference parity build.
 *
 * The parity harness compiles the reference with -DRTLSDR so its
 * FILE-REPLAY twin FEND_FRTLSDR (src/sdrrcv.c:174-191, 382-385) is
 * available — that is the only front end whose PPMERR/foffset clock-error
 * path the reference wires (src/sdrinit.c:616-617), which the "ppm"
 * stress scenario exercises.  File replay never touches the live USB
 * entry points, but src/rcv/rtlsdr/rtlsdr.c references them; these
 * no-op stubs satisfy the linker (a live run would fail fast with -1,
 * matching "no device" behavior).
 */
#include <stdint.h>
#include <stddef.h>

typedef struct rtlsdr_dev rtlsdr_dev_t;
typedef void (*rtlsdr_read_async_cb_t)(unsigned char *buf, uint32_t len,
                                       void *ctx);

int rtlsdr_open(rtlsdr_dev_t **dev, uint32_t index)
{
    (void)index;
    *dev = NULL;
    return -1;
}

int rtlsdr_close(rtlsdr_dev_t *dev) { (void)dev; return 0; }

int rtlsdr_cancel_async(rtlsdr_dev_t *dev) { (void)dev; return -1; }

int rtlsdr_read_async(rtlsdr_dev_t *dev, rtlsdr_read_async_cb_t cb,
                      void *ctx, uint32_t buf_num, uint32_t buf_len)
{
    (void)dev; (void)cb; (void)ctx; (void)buf_num; (void)buf_len;
    return -1;
}

int verbose_device_search(char *s) { (void)s; return -1; }
int verbose_set_frequency(rtlsdr_dev_t *dev, uint32_t frequency)
{
    (void)dev; (void)frequency; return -1;
}
int verbose_set_sample_rate(rtlsdr_dev_t *dev, uint32_t samp_rate)
{
    (void)dev; (void)samp_rate; return -1;
}
int verbose_auto_gain(rtlsdr_dev_t *dev) { (void)dev; return -1; }
int verbose_ppm_set(rtlsdr_dev_t *dev, int ppm_error)
{
    (void)dev; (void)ppm_error; return -1;
}
int verbose_reset_buffer(rtlsdr_dev_t *dev) { (void)dev; return -1; }
